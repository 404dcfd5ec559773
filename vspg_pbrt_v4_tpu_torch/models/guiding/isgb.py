"""Image-space guiding buffer (counterpart of ``models/guiding/isgb.py``).

Per-pixel accumulators feeding two denoised estimates: the pixel
contribution (guided Russian roulette) and the primary-ray volume scatter
probability, by the contribution criterion Cv/(Cv+Cs) or the variance
criterion (Cv^2+Vv)/(Cv^2+Vv+Cs^2+Vs). Two denoisers
(``ISGB.make(denoiser=...)``):

- "atrous": the edge-aware à-trous filter guided by albedo and normal;
- "unet": the kernel-predicting U-Net of ``guiding/denoiser.py``, trained
  per scene on the buffer's even/odd-wave split halves. Its state, the net
  and Adam's moments, lives in the buffer (``net``) and keeps training
  across updates.

``save_isgb``/``load_isgb`` read and write the JAX package's file layout.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ...utils.device import OnDevice
from ...utils.math import index_sum
from . import denoiser as dn

# the array fields in the JAX package's leaf order
_ARRAYS = ("contrib_sum", "albedo_sum", "normal_sum", "n", "c_vol", "c_vol2",
           "c_surf", "c_surf2", "contrib_a", "n_a", "contrib_est", "vsp_est")


@dataclass(frozen=True)
class ISGB(OnDevice):
    contrib_sum: torch.Tensor  # (P,3)
    albedo_sum: torch.Tensor  # (P,3)
    normal_sum: torch.Tensor  # (P,3)
    n: torch.Tensor  # (P,)
    c_vol: torch.Tensor  # (P,) first-event-volume contribution sums
    c_vol2: torch.Tensor  # (P,)
    c_surf: torch.Tensor  # (P,)
    c_surf2: torch.Tensor  # (P,)
    contrib_a: torch.Tensor  # (P,3) even-wave split half
    n_a: torch.Tensor  # (P,)
    contrib_est: torch.Tensor  # (P,3) denoised estimates, valid once ready
    vsp_est: torch.Tensor  # (P,)
    ready: bool
    resolution: tuple  # (nx, ny)
    vsp_criterion: str  # "variance" | "contribution"
    denoiser: str = "atrous"
    # "unet": (UNet, (m, v)), Adam's moments by parameter name; else None
    net: object = None

    @staticmethod
    def make(resolution, vsp_criterion="variance", denoiser="atrous", *,
             device="cuda"):
        P = int(resolution[0] * resolution[1])

        def z(*shape):
            return torch.zeros(shape, device=device)

        net = None
        if denoiser == "unet":
            unet = dn.UNet().to(device)
            net = (unet, (dn.zeros_state(unet), dn.zeros_state(unet)))
        return ISGB(z(P, 3), z(P, 3), z(P, 3), z(P), z(P), z(P), z(P), z(P),
                    z(P, 3), z(P), z(P, 3),
                    torch.full((P,), -1.0, device=device), False,
                    tuple(int(r) for r in resolution), vsp_criterion,
                    denoiser, net)


def isgb_add_samples(buf: ISGB, pixel_id, L, albedo, normal,
                     first_event_volume, valid, half=0):
    """Accumulate one wave of per-pixel samples; half 0 also feeds the A
    split half."""
    w = torch.where(valid, 1.0, 0.0)
    wa = w * (1.0 if int(half) == 0 else 0.0)
    lum = torch.mean(L, -1)
    lv = torch.where(first_event_volume, lum, 0.0)
    ls = torch.where(first_event_volume, 0.0, lum)

    def add(acc, v):
        return index_sum(acc.clone(), pixel_id, v)

    return replace(
        buf,
        contrib_sum=add(buf.contrib_sum, w[..., None] * L),
        albedo_sum=add(buf.albedo_sum, w[..., None] * albedo),
        normal_sum=add(buf.normal_sum, w[..., None] * normal),
        n=add(buf.n, w),
        c_vol=add(buf.c_vol, w * lv),
        c_vol2=add(buf.c_vol2, w * lv * lv),
        c_surf=add(buf.c_surf, w * ls),
        c_surf2=add(buf.c_surf2, w * ls * ls),
        contrib_a=add(buf.contrib_a, wa[..., None] * L),
        n_a=add(buf.n_a, wa))


def _shift_clamp(a, sy, sx):
    """out[y, x] = a[clip(y - sy), clip(x - sx)] (clamp-to-edge shift)."""
    ny, nx = a.shape[:2]
    iy = torch.clamp(torch.arange(ny, device=a.device) - sy, 0, ny - 1)
    ix = torch.clamp(torch.arange(nx, device=a.device) - sx, 0, nx - 1)
    return a[iy][:, ix]


def _atrous(img, albedo, normal, steps=3):
    """Edge-aware à-trous wavelet filter (Dammertz et al. 2010 style) of
    img (ny,nx,C) guided by albedo and normal (ny,nx,3)."""
    ny, nx, _ = img.shape
    kernel = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    offsets = [-2, -1, 0, 1, 2]
    out = img
    for step in range(steps):
        stride = 1 << step
        acc = torch.zeros_like(out)
        wacc = torch.zeros((ny, nx, 1), device=img.device)
        for i, dy in enumerate(offsets):
            for j, dx in enumerate(offsets):
                w_k = kernel[i] * kernel[j]
                sy, sx = dy * stride, dx * stride
                sh = _shift_clamp(out, sy, sx)
                sh_alb = _shift_clamp(albedo, sy, sx)
                sh_nrm = _shift_clamp(normal, sy, sx)
                w_alb = torch.exp(-torch.sum((albedo - sh_alb) ** 2, -1,
                                             keepdim=True) / 0.05)
                w_nrm = torch.exp(-torch.sum((normal - sh_nrm) ** 2, -1,
                                             keepdim=True) / 0.2)
                w = w_k.to(img.device) * w_alb * w_nrm
                acc = acc + sh * w
                wacc = wacc + w
        out = acc / torch.clamp(wacc, min=1e-8)
    return out


def isgb_update(buf: ISGB) -> ISGB:
    """Denoise the accumulators into the estimates."""
    nx, ny = buf.resolution
    n = torch.clamp(buf.n, min=1.0)[..., None]
    contrib = (buf.contrib_sum / n).reshape(ny, nx, 3)
    albedo = (buf.albedo_sum / n).reshape(ny, nx, 3)
    normal = (buf.normal_sum / n).reshape(ny, nx, 3)

    nn = torch.clamp(buf.n, min=1.0)
    cv = buf.c_vol / nn
    cs = buf.c_surf / nn
    if buf.vsp_criterion == "variance":
        vv = torch.clamp(buf.c_vol2 / nn - cv * cv, min=0.0)
        vs = torch.clamp(buf.c_surf2 / nn - cs * cs, min=0.0)
        num = cv * cv + vv
        den = num + cs * cs + vs
    else:
        num = cv
        den = cv + cs
    vsp_raw = torch.where(den > 0, num / torch.clamp(den, min=1e-20), -1.0)
    vsp_raw = torch.where(vsp_raw >= 0, torch.clamp(vsp_raw, 0.0, 1.0), -1.0)

    if buf.denoiser == "unet":
        # train on the A half against B = total - A and back, then filter
        # the full buffer and the VSP map with the predicted kernels
        na = buf.n_a.reshape(ny, nx)
        nb = (buf.n - buf.n_a).reshape(ny, nx)
        ca = (buf.contrib_a / torch.clamp(buf.n_a, min=1.0)[..., None]
              ).reshape(ny, nx, 3)
        cb = ((buf.contrib_sum - buf.contrib_a)
              / torch.clamp(buf.n - buf.n_a, min=1.0)[..., None]
              ).reshape(ny, nx, 3)
        unet, opt_state = buf.net
        unet, opt_state, contrib_d, vsp_d = dn.train_and_denoise(
            unet, opt_state, ca, na, cb, nb, contrib, buf.n.reshape(ny, nx),
            albedo, normal, vsp_raw.reshape(ny, nx))
        return replace(buf, contrib_est=contrib_d.reshape(-1, 3),
                       vsp_est=torch.where(buf.n > 0, vsp_d.reshape(-1),
                                           -1.0),
                       ready=True, net=(unet, opt_state))

    contrib_d = _atrous(contrib, albedo, normal)
    vsp_img = torch.clamp(vsp_raw, 0.0, 1.0).reshape(ny, nx, 1)
    vsp_d = _atrous(vsp_img, albedo, normal).reshape(-1)
    return replace(buf, contrib_est=contrib_d.reshape(-1, 3),
                   vsp_est=torch.where(buf.n > 0, vsp_d, -1.0), ready=True)


def isgb_primary_vsp(buf: ISGB, pixel_id):
    """Primary-ray VSP estimate; -1 while the buffer is not ready."""
    v = buf.vsp_est[pixel_id]
    return v if buf.ready else torch.full_like(v, -1.0)


def isgb_contribution(buf: ISGB, pixel_id):
    """Pixel contribution estimate for guided Russian roulette."""
    c = buf.contrib_est[pixel_id]
    return c if buf.ready else torch.zeros_like(c)


def _net_leaves(net):
    """The U-Net state as the JAX package flattens it: params, then m, then
    v, each by sorted layer name, bias before weight, weights HWIO."""
    unet, (m, v) = net
    out = []
    for named in (dict(unet.named_parameters()), m, v):
        tree = dn.named_to_jax(named)
        for name in sorted(tree):
            out += [tree[name]["b"], tree[name]["w"]]
    return out


def _net_from_leaves(leaves, device):
    n = 2 * len(dn._NAMES)
    params, m, v = ({name: {"b": leaves[k * n + 2 * i],
                            "w": leaves[k * n + 2 * i + 1]}
                     for i, name in enumerate(sorted(dn._NAMES))}
                    for k in range(3))
    return dn.state_from_jax(params, m, v, device)


def save_isgb(buf: ISGB, path):
    """Write the buffer in the JAX package's ``save_isgb`` layout: its
    leaves as arr_0, arr_1, ... and the resolution, criterion and
    denoiser."""
    leaves = [getattr(buf, f).detach().cpu().numpy() for f in _ARRAYS]
    leaves.append(np.asarray(bool(buf.ready)))
    if buf.net is not None:
        leaves += _net_leaves(buf.net)
    np.savez(path, *leaves, res=buf.resolution, crit=buf.vsp_criterion,
             dn=buf.denoiser)


def load_isgb(path, device="cuda") -> ISGB:
    """Read a buffer written by either package's ``save_isgb``."""
    data = np.load(path, allow_pickle=True)
    meta = {"res", "crit", "dn"} & set(data.files)
    leaves = [data[f"arr_{i}"] for i in range(len(data.files) - len(meta))]
    denoiser = str(data["dn"]) if "dn" in data.files else "atrous"
    arrays = {f: torch.as_tensor(np.asarray(a, np.float32), device=device)
              for f, a in zip(_ARRAYS, leaves)}
    net = (_net_from_leaves(leaves[len(_ARRAYS) + 1:], device)
           if denoiser == "unet" else None)
    return ISGB(**arrays, ready=bool(leaves[len(_ARRAYS)]),
                resolution=tuple(int(r) for r in data["res"]),
                vsp_criterion=str(data["crit"]), denoiser=denoiser, net=net)
