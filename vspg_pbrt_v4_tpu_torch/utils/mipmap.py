"""Image pyramid with trilinear lookups (counterpart of
``utils/mipmap.py``; pbrt's util/mipmap.h MIPMap).

The pyramid is one (L, H, W, C) tensor: level l is the image box-filtered
2^l times and repeated back up to the base grid, so that every level is
gathered with the same indexes. Lookups are bilinear within a level and
linear across the two nearest levels; ``width_to_lod`` maps a filter
footprint in uv to a level.
"""

from __future__ import annotations

import numpy as np
import torch

from .math import py_mod


def build_pyramid(image, *, device):
    """(H, W, C) -> (L, H, W, C) float32 tensor on `device`."""
    img = np.asarray(image, np.float32)
    H, W = img.shape[:2]
    levels = [img]
    cur = img
    while min(cur.shape[0], cur.shape[1]) > 1:
        h2 = max(cur.shape[0] // 2, 1)
        w2 = max(cur.shape[1] // 2, 1)
        cur = cur[: h2 * 2, : w2 * 2]
        cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                      + cur[0::2, 1::2] + cur[1::2, 1::2])
        up = np.repeat(np.repeat(cur, H // cur.shape[0], 0),
                       W // cur.shape[1], 1)[:H, :W]
        if up.shape[:2] != (H, W):  # a size that is not a power of two
            pad = np.zeros_like(img)
            pad[: up.shape[0], : up.shape[1]] = up
            up = pad
        levels.append(up)
    return torch.as_tensor(np.stack(levels), device=device)


def n_levels(pyramid):
    return pyramid.shape[0]


def width_to_lod(width, base_res):
    """Filter width in uv units -> fractional level (MIPMap::Lookup)."""
    return torch.clamp(torch.log2(torch.clamp(width * base_res, min=1e-8)),
                       0.0, 1e6)


def lookup_trilinear(pyramid, uv, lod):
    """uv (...,2) wrapped, lod (...,) fractional level -> (..., C)."""
    L, H, W = pyramid.shape[0], pyramid.shape[1], pyramid.shape[2]
    lod = torch.clamp(lod, 0.0, L - 1.0)
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.clamp(l0 + 1, max=L - 1)
    fl = (lod - l0)[..., None]
    one = torch.tensor(1.0, device=uv.device)

    def bilerp(level):
        u = py_mod(uv[..., 0], one) * (W - 1)
        v = (1.0 - py_mod(uv[..., 1], one)) * (H - 1)
        x0 = torch.clamp(torch.floor(u).to(torch.int32), 0, W - 1)
        y0 = torch.clamp(torch.floor(v).to(torch.int32), 0, H - 1)
        x1 = torch.clamp(x0 + 1, max=W - 1)
        y1 = torch.clamp(y0 + 1, max=H - 1)
        fu = (u - x0)[..., None]
        fv = (v - y0)[..., None]
        lv, x0, y0, x1, y1 = (t.long() for t in (level, x0, y0, x1, y1))
        a = pyramid[lv, y0, x0]
        b = pyramid[lv, y0, x1]
        c = pyramid[lv, y1, x0]
        d = pyramid[lv, y1, x1]
        return (a * (1 - fu) + b * fu) * (1 - fv) \
            + (c * (1 - fu) + d * fu) * fv

    return bilerp(l0) * (1 - fl) + bilerp(l1) * fl
