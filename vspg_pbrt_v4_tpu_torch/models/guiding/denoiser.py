"""Learned ISGB denoiser: a kernel-predicting U-Net trained per scene
(counterpart of ``models/guiding/denoiser.py``).

The net takes the image-space guiding buffer's features (log-tonemapped
color, albedo, normal, log sample count) and predicts a per-pixel 5x5
softmax kernel that filters the full buffer's color and, jointly, its VSP
map. It trains self-supervised (noise2noise) on the buffer's split halves:
denoise(A) should predict B and denoise(B) should predict A, a few Adam
steps at every ISGB update, the parameters and Adam's moments carried
across updates. Its head starts at zero weights with Gaussian-log biases,
so the untrained net is exactly a 5x5 Gaussian blur.

Layout: the JAX package holds HWIO weights on NHWC tensors; here
``UNet`` holds torch's OIHW convolutions, named as the JAX parameters
(``enc0a`` ... ``dec0b``, ``head``), and runs NCHW inside. The functions
take and return NHWC tensors as the JAX ones do;
``denoiser_params_from_jax`` loads JAX's weights. The initial weights come from a ``torch.Generator``
seeded with 7 (not JAX's ``PRNGKey(7)`` draws).

Precision: float32 throughout. On the card every convolution of this
module (forward and backward) runs with TF32 off and cuDNN's deterministic
algorithms (``_conv_mode``, set for these calls only), so the card's
update follows the CPU's to float32 rounding and two runs on the card give
the same bits. The net is small (about 60k parameters at width 12); TF32
would buy little here. Adam is written out as the JAX package writes it:
its bias correction counts t = 1, 2, ... from each update's first step,
while the moments carry over (``torch.optim.Adam`` keeps one step count).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

KSIZE = 5  # predicted-kernel width
_NK = KSIZE * KSIZE
_NFEAT = 10  # log1p color (3) + albedo (3) + normal (3) + log count (1)

# (name, input channels, output channels) as multiples of the width w; the
# decoders take the upsampled features concatenated with the skip's
_LAYERS = (("enc0a", None, 1), ("enc0b", 1, 1), ("enc1a", 1, 2),
           ("enc1b", 2, 2), ("bota", 2, 4), ("botb", 4, 4),
           ("dec1a", 6, 2), ("dec1b", 2, 2), ("dec0a", 3, 1),
           ("dec0b", 1, 1))
_NAMES = tuple(n for n, _, _ in _LAYERS) + ("head",)


def _conv_mode():
    """float32 convolutions with deterministic cuDNN algorithms, for the
    calls inside this context only."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def _gaussian_log_bias():
    ax = np.arange(KSIZE) - KSIZE // 2
    g = np.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / (2.0 * 1.2 ** 2))
    g /= g.sum()
    return np.log(g.reshape(-1) + 1e-12).astype(np.float32)


class UNet(nn.Module):
    """3-level U-Net trunk and a kernel-predicting head."""

    def __init__(self, width=12, seed=7):
        super().__init__()
        w = int(width)
        gen = torch.Generator().manual_seed(int(seed))
        for name, cin, cout in _LAYERS:
            cin = _NFEAT if cin is None else cin * w
            conv = nn.Conv2d(cin, cout * w, 3, padding=1)
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape,
                                              generator=gen)
                                  * float(np.sqrt(2.0 / (9 * cin))))
                conv.bias.zero_()
            setattr(self, name, conv)
        self.head = nn.Conv2d(w, _NK, 3, padding=1)
        with torch.no_grad():
            self.head.weight.zero_()
            self.head.bias.copy_(torch.as_tensor(_gaussian_log_bias()))

    def forward(self, x):
        """NCHW features -> NCHW softmax kernels."""
        ny, nx = x.shape[2], x.shape[3]

        def block(a, b, h):
            return F.silu(b(F.silu(a(h))))

        e0 = block(self.enc0a, self.enc0b, x)
        e1 = block(self.enc1a, self.enc1b, _down(e0))
        h = block(self.bota, self.botb, _down(e1))
        h = torch.cat([_up(h, e1.shape[2], e1.shape[3]), e1], 1)
        h = block(self.dec1a, self.dec1b, h)
        h = torch.cat([_up(h, ny, nx), e0], 1)
        h = block(self.dec0a, self.dec0b, h)
        return torch.softmax(self.head(h), dim=1)


def _down(x):
    """2x2 mean after cropping an odd last row and column (NCHW)."""
    n, c, ny, nx = x.shape
    x = x[:, :, :ny - ny % 2, :nx - nx % 2]
    return x.reshape(n, c, ny // 2, 2, nx // 2, 2).mean((3, 5))


def _up(x, ny, nx):
    """Each pixel repeated 2x2, cropped to (ny, nx) (NCHW)."""
    y = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return y[:, :, :ny, :nx]


def denoiser_params_from_jax(params, device="cpu"):
    """A UNet holding the JAX package's parameters: a dict of
    {"w": (3,3,cin,cout) HWIO, "b": (cout,)} per layer name (numpy or JAX
    arrays)."""
    net = UNet(width=int(np.asarray(params["enc0a"]["w"]).shape[-1]))
    net.load_state_dict(named_from_jax(params))
    return net.to(device)


def state_from_jax(params, m, v, device="cpu"):
    """The ISGB's U-Net state (UNet, (m, v)) from the JAX package's
    (params, (m, v)), Adam's moments in the parameters' layout."""
    def moments(tree):
        return {k: t.to(device) for k, t in named_from_jax(tree).items()}

    return (denoiser_params_from_jax(params, device),
            (moments(m), moments(v)))


def named_from_jax(tree):
    """{"enc0a": {"w", "b"}, ...} -> {"enc0a.weight": OIHW, ...}."""
    out = {}
    for name in _NAMES:
        w = np.asarray(tree[name]["w"], np.float32)
        out[f"{name}.weight"] = torch.as_tensor(
            w.transpose(3, 2, 0, 1).copy())
        out[f"{name}.bias"] = torch.as_tensor(
            np.asarray(tree[name]["b"], np.float32).copy())
    return out


def named_to_jax(named):
    """The inverse of ``named_from_jax``, as numpy arrays."""
    return {name: {"w": named[f"{name}.weight"].detach().cpu().numpy()
                   .transpose(2, 3, 1, 0),
                   "b": named[f"{name}.bias"].detach().cpu().numpy()}
            for name in _NAMES}


def zeros_state(net):
    """Zero Adam moments, one per named parameter of `net`."""
    return {k: torch.zeros_like(p) for k, p in net.named_parameters()}


def predict_kernels(net, feats):
    """feats (1,ny,nx,_NFEAT) -> per-pixel softmax kernels (1,ny,nx,_NK)."""
    with _conv_mode():
        k = net(feats.permute(0, 3, 1, 2))
    return k.permute(0, 2, 3, 1)


def _patches(img):
    """(1,ny,nx,C) -> (1,ny,nx,_NK,C) edge-clamped KSIZExKSIZE windows."""
    r = KSIZE // 2
    ny, nx = img.shape[1], img.shape[2]
    dev = img.device
    rows = []
    for dy in range(KSIZE):
        iy = torch.clamp(torch.arange(ny, device=dev) + dy - r, 0, ny - 1)
        for dx in range(KSIZE):
            ix = torch.clamp(torch.arange(nx, device=dev) + dx - r, 0, nx - 1)
            rows.append(img[:, iy][:, :, ix])
    return torch.stack(rows, -2)


def apply_kernels(kern, img):
    """Apply per-pixel kernels (1,ny,nx,_NK) to img (1,ny,nx,C)."""
    return torch.sum(_patches(img) * kern[..., None], dim=-2)


def make_features(color, albedo, normal, count):
    """color/albedo/normal (ny,nx,3), count (ny,nx) -> (1,ny,nx,_NFEAT)."""
    f = torch.cat([torch.log1p(torch.clamp(color, min=0.0)), albedo, normal,
                   (torch.log1p(count) * 0.25)[..., None]], -1)
    return f[None]


def _smape(x, y, w):
    """Symmetric relative L1, robust for HDR radiance."""
    d = torch.abs(x - y) / (torch.abs(x) + torch.abs(y) + 1e-2)
    return (torch.sum(d * w) / torch.clamp(torch.sum(w), min=1e-6)
            / x.shape[-1])


def _loss(net, fa, fb, ca, cb, wa, wb):
    """Cross-prediction loss: denoise(A) ~ B and denoise(B) ~ A."""
    ka = predict_kernels(net, fa)
    kb = predict_kernels(net, fb)
    la = _smape(apply_kernels(ka, ca)[0], cb[0], wb * wa)
    lb = _smape(apply_kernels(kb, cb)[0], ca[0], wa * wb)
    return la + lb


def adam_step(net, m, v, grads, t, lr=2e-3):
    """One Adam update of `net` in place, with bias correction at step t;
    returns the new moments (dicts by parameter name)."""
    t32 = torch.tensor(float(t), dtype=torch.float32)
    c1 = 1.0 - torch.tensor(0.9, dtype=torch.float32) ** t32
    c2 = 1.0 - torch.tensor(0.999, dtype=torch.float32) ** t32
    m2, v2 = {}, {}
    with torch.no_grad():
        for (k, p), g in zip(net.named_parameters(), grads):
            m2[k] = 0.9 * m[k] + 0.1 * g
            v2[k] = 0.999 * v[k] + 0.001 * g * g
            mh = m2[k] / c1
            vh = v2[k] / c2
            p.copy_(p - lr * mh / (torch.sqrt(vh) + 1e-8))
    return m2, v2


def train_and_denoise(net, opt_state, color_a, n_a, color_b, n_b, color_full,
                      n_full, albedo, normal, vsp_raw, steps=48, lr=2e-3):
    """One ISGB update: train a copy of `net` on the halves, then denoise
    the full buffer with it.

    Images are (ny,nx,C) or (ny,nx). Returns (net, opt_state,
    denoised color (ny,nx,3), denoised VSP (ny,nx)). Training is skipped,
    and `net` and `opt_state` come back unchanged, when either half is
    empty (the first wave)."""
    wa = (n_a > 0).float()[..., None]
    wb = (n_b > 0).float()[..., None]
    if opt_state is None:
        opt_state = (zeros_state(net), zeros_state(net))
    m, v = opt_state
    if bool(wa.sum() > 0) and bool(wb.sum() > 0):
        fa = make_features(color_a, albedo, normal, n_a)
        fb = make_features(color_b, albedo, normal, n_b)
        ca, cb = color_a[None], color_b[None]
        net = copy.deepcopy(net)
        params = list(net.parameters())
        for i in range(int(steps)):
            loss = _loss(net, fa, fb, ca, cb, wa, wb)
            with _conv_mode():
                grads = torch.autograd.grad(loss, params)
            m, v = adam_step(net, m, v, grads, i + 1, lr)
    with torch.no_grad():
        kern = predict_kernels(net, make_features(color_full, albedo, normal,
                                                  n_full))
        out_c = apply_kernels(kern, color_full[None])[0]
        # the VSP map filtered with the same kernels; invalid (-1) pixels
        # carry zero weight
        vmask = (vsp_raw >= 0.0).float()
        vnum = apply_kernels(kern, (vsp_raw * vmask)[None, ..., None])
        vden = apply_kernels(kern, vmask[None, ..., None])
        vnum, vden = vnum[0, ..., 0], vden[0, ..., 0]
        out_v = torch.where(vden > 1e-4, vnum / torch.clamp(vden, min=1e-4),
                            -1.0)
    return net, (m, v), out_c, out_v
