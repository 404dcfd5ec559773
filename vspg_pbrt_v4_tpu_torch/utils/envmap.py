"""Environment-map reparameterization (counterpart of ``utils/envmap.py``,
pbrt's ``imgtool makeequiarea``).

The image environment light reads *equal-area square* maps
(vecmath.h EqualAreaSquareToSphere); common assets are lat-long. This
host resampler converts lat-long to equal-area with bilinear taps.
"""

from __future__ import annotations

import numpy as np


def latlong_to_equal_area(img):
    """A lat-long image (H, W, C) resampled to an equal-area square of side
    H."""
    img = np.asarray(img, np.float32)
    H, W = img.shape[:2]
    S = max(H, 1)
    ys, xs = np.meshgrid((np.arange(S) + 0.5) / S, (np.arange(S) + 0.5) / S,
                         indexing="ij")
    # equal-area square -> direction (utils/vecmath.py in numpy)
    u = 2 * xs - 1
    v = 2 * ys - 1
    up, vp = np.abs(u), np.abs(v)
    sd = 1 - (up + vp)
    d = np.abs(sd)
    r = 1 - d
    phi = np.where(r == 0, 1.0,
                   (vp - up) / np.where(r == 0, 1.0, r) + 1.0) * np.pi / 4
    z = (1 - r * r) * np.sign(sd)
    cosp = np.cos(phi) * np.sign(u)
    sinp = np.sin(phi) * np.sign(v)
    scale = r * np.sqrt(np.maximum(2 - r * r, 0))
    dirs = np.stack([cosp * scale, sinp * scale, z], -1)
    # direction -> lat-long uv (theta from +z, as pbrt's equirect: v = theta/pi)
    theta = np.arccos(np.clip(dirs[..., 2], -1, 1))
    phi_ll = np.arctan2(dirs[..., 1], dirs[..., 0]) % (2 * np.pi)
    fu = phi_ll / (2 * np.pi) * (W - 1)
    fv = theta / np.pi * (H - 1)
    x0 = np.clip(fu.astype(int), 0, W - 1)
    y0 = np.clip(fv.astype(int), 0, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    ax = (fu - x0)[..., None]
    ay = (fv - y0)[..., None]
    out = (img[y0, x0] * (1 - ax) * (1 - ay) + img[y0, x1] * ax * (1 - ay)
           + img[y1, x0] * (1 - ax) * ay + img[y1, x1] * ax * ay)
    return out.astype(np.float32)
