"""von Mises-Fisher mixture math for the guiding field (counterpart of
``models/guiding/vmf.py``).

Mixtures are (..., K) weights/kappas and (..., K, 3) directions. The pdf
uses exp(kappa (mu.w - 1)) with normalizer kappa / (2 pi (1 - e^-2kappa));
kappa <-> mean resultant length uses the Banerjee et al. approximation.
"""

from __future__ import annotations

import torch

from ...utils.math import INV_4PI, PI, index_sum
from ...utils.vecmath import coordinate_system, dot

MAX_KAPPA = 2e3
MIN_KAPPA = 1e-2
# vMF approximation of the clamped-cosine lobe (OpenPGL's cosine product)
COSINE_KAPPA = 2.18853


def vmf_pdf(w, mu, kappa):
    """vMF density at w: (...,3),(...,3),(...) -> (...). kappa ~ 0 =>
    uniform."""
    c = kappa / (2.0 * PI * (1.0 - torch.exp(-2.0 * kappa)))
    val = c * torch.exp(kappa * (dot(w, mu) - 1.0))
    return torch.where(kappa < MIN_KAPPA, INV_4PI, val)


def vmf_sample(mu, kappa, u2):
    """Sample w ~ vMF(mu, kappa) by Jakob's (2012) stable inversion."""
    u0, u1 = u2[..., 0], u2[..., 1]
    safe_kappa = torch.clamp(kappa, min=MIN_KAPPA)
    cos_theta = 1.0 + torch.log1p(-(1.0 - torch.exp(-2.0 * safe_kappa))
                                  * (1.0 - u0)) / safe_kappa
    cos_theta = torch.where(kappa < MIN_KAPPA, 1.0 - 2.0 * u0, cos_theta)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * PI * u1
    t1, t2 = coordinate_system(mu)
    return ((sin_theta * torch.cos(phi))[..., None] * t1
            + (sin_theta * torch.sin(phi))[..., None] * t2
            + cos_theta[..., None] * mu)


def kappa_to_rho(kappa):
    """Mean resultant length rho = coth(kappa) - 1/kappa."""
    k = torch.clamp(kappa, min=MIN_KAPPA)
    return torch.where(kappa < MIN_KAPPA, kappa / 3.0,
                       1.0 / torch.tanh(k) - 1.0 / k)


def rho_to_kappa(rho):
    """Banerjee et al. inversion, clamped."""
    rho = torch.clamp(rho, 0.0, 0.9999)
    k = rho * (3.0 - rho * rho) / torch.clamp(1.0 - rho * rho, min=1e-6)
    return torch.clamp(k, 0.0, MAX_KAPPA)


def _log_c(kappa):
    """log(kappa / (2 pi (1 - e^{-2 kappa}))): pdf = C exp(kappa (mu.w-1))."""
    k = torch.clamp(kappa, min=MIN_KAPPA)
    return (torch.log(k) - torch.log(torch.tensor(2.0 * PI))
            - torch.log1p(-torch.exp(-2.0 * k)))


def mixture_pdf(w, weights, mu, kappa):
    """(...,3), (...,K), (...,K,3), (...,K) -> (...)."""
    return torch.sum(weights * vmf_pdf(w[..., None, :], mu, kappa), dim=-1)


def mixture_sample(weights, mu, kappa, u_sel, u2):
    """Pick a lobe by its weight, then sample it. Returns (w, pdf)."""
    cdf = torch.cumsum(weights, dim=-1)
    cdf = cdf / torch.clamp(cdf[..., -1:], min=1e-12)
    k_idx = torch.sum((u_sel[..., None] >= cdf).to(torch.int64), dim=-1)
    k_idx = torch.clamp(k_idx, 0, weights.shape[-1] - 1)
    mu_k = torch.gather(mu, -2, k_idx[..., None, None].expand(
        k_idx.shape + (1, 3)))[..., 0, :]
    kap_k = torch.gather(kappa, -1, k_idx[..., None])[..., 0]
    w = vmf_sample(mu_k, kap_k, u2)
    return w, mixture_pdf(w, weights, mu, kappa)


def product_with_vmf(weights, mu, kappa, mu_b, kappa_b):
    """Multiply every lobe by one vMF lobe (analytic product):
    vMF(mu1,k1) vMF(mu2,k2) = s vMF(mu',k') with k'mu' = k1 mu1 + k2 mu2.
    Returns (weights, mu, kappa), weights renormalized to the prior
    total."""
    kmu = kappa[..., None] * mu + kappa_b[..., None, None] * mu_b[..., None, :]
    k_new = torch.sqrt(torch.clamp(torch.sum(kmu * kmu, dim=-1), min=1e-12))
    mu_new = kmu / torch.clamp(k_new, min=1e-8)[..., None]
    log_s = (_log_c(kappa) + _log_c(kappa_b)[..., None] - _log_c(k_new)
             + (k_new - kappa - kappa_b[..., None]))
    w_new = weights * torch.exp(torch.clamp(log_s, -60.0, 60.0))
    total_old = torch.sum(weights, dim=-1, keepdim=True)
    total_new = torch.sum(w_new, dim=-1, keepdim=True)
    w_new = w_new * total_old / torch.clamp(total_new, min=1e-20)
    return w_new, mu_new, torch.clamp(k_new, 0.0, MAX_KAPPA)


def hg_lobe(wo, g):
    """vMF approximation of the HG lobe about the propagation direction:
    resultant length |g| about -wo (pbrt convention)."""
    mu = -wo * torch.sign(g)[..., None]
    mu = torch.where(torch.abs(g)[..., None] < 1e-5, -wo, mu)
    return mu, rho_to_kappa(torch.abs(g))


def em_update(stats_w, stats_s, weights, mu, kappa, cell_id, n_cells,
              sample_dir, sample_w, decay=1.0, prior_w=0.1):
    """One incremental weighted-EM step over a batch of directional samples.

    stats_w (C,K) and stats_s (C,K,3) are the sufficient statistics,
    cell_id (N,) the spatial cell per sample, sample_dir (N,3), sample_w
    (N,). Returns (stats_w, stats_s, weights, mu, kappa): E-step
    responsibilities against the current mixtures, M-step by scatter-add
    into per-cell statistics."""
    K = weights.shape[-1]
    # robust weight clamp: one 1/r^2 outlier must not collapse a cell
    w_cap = 10.0 * torch.quantile(
        torch.where(sample_w > 0, sample_w, 0.0), 0.99,
        interpolation="linear") + 1e-6
    sample_w = torch.minimum(sample_w, w_cap)

    # E-step with a uniform floor so degenerate mixtures still accept data
    p = vmf_pdf(sample_dir[..., None, :], mu[cell_id], kappa[cell_id])
    resp = weights[cell_id] * p + 1e-4 * INV_4PI
    resp = resp / torch.clamp(torch.sum(resp, -1, keepdim=True), min=1e-20)
    wr = resp * sample_w[..., None]

    # M-step: scatter-add into the per-cell statistics
    batch_w = index_sum(torch.zeros_like(stats_w), cell_id, wr)
    batch_s = index_sum(torch.zeros_like(stats_s), cell_id,
                        wr[..., None] * sample_dir[..., None, :])
    stats_w = stats_w * decay + batch_w
    stats_s = stats_s * decay + batch_s

    # parameters from the statistics, with a weak uniform prior
    tot = torch.sum(stats_w, -1, keepdim=True)
    new_weights = (stats_w + prior_w) / (tot + K * prior_w)
    s_norm = torch.sqrt(torch.clamp(torch.sum(stats_s * stats_s, -1),
                                    min=1e-20))
    new_mu = stats_s / s_norm[..., None]
    new_kappa = rho_to_kappa(s_norm / torch.clamp(stats_w, min=1e-12))
    # cells/lobes with no data keep their parameters
    has_data = stats_w > 1e-8
    weights = torch.where(has_data, new_weights, weights)
    mu = torch.where(has_data[..., None], new_mu, mu)
    kappa = torch.where(has_data, new_kappa, kappa)
    weights = weights / torch.clamp(torch.sum(weights, -1, keepdim=True),
                                    min=1e-12)
    return stats_w, stats_s, weights, mu, kappa
