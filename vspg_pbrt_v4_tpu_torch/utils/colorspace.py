"""Color: CIE XYZ, sRGB conversion, gamma and RGB color spaces
(counterpart of ``utils/colorspace.py``), on the host in numpy.

The CIE 1931 matching functions are the Wyman-Sloan-Shirley (JCGT 2013)
multi-lobe Gaussian fits, accurate to well under 1% for the
spectrum-to-RGB reduction that RGB rendering runs when it builds a scene.
"""

from __future__ import annotations

import numpy as np


def _g(x, alpha, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return alpha * np.exp(-0.5 * ((x - mu) / s) ** 2)


def cie_x(lam):
    return (_g(lam, 1.056, 599.8, 37.9, 31.0) + _g(lam, 0.362, 442.0, 16.0,
                                                    26.7)
            + _g(lam, -0.065, 501.1, 20.4, 26.2))


def cie_y(lam):
    return _g(lam, 0.821, 568.8, 46.9, 40.5) + _g(lam, 0.286, 530.9, 16.3,
                                                   31.1)


def cie_z(lam):
    return _g(lam, 1.217, 437.0, 11.8, 36.0) + _g(lam, 0.681, 459.0, 26.0,
                                                   13.8)


# XYZ -> linear sRGB (D65)
XYZ_TO_SRGB = np.array([[3.2406, -1.5372, -0.4986],
                        [-0.9689, 1.8758, 0.0415],
                        [0.0557, -0.2040, 1.0570]])
SRGB_TO_XYZ = np.linalg.inv(XYZ_TO_SRGB)


def spectrum_samples_to_rgb(lams, vals):
    """Integrate (lams [nm], vals) against the CIE fits; linear sRGB."""
    lams = np.asarray(lams, np.float64)
    vals = np.asarray(vals, np.float64)
    x = np.trapezoid(vals * cie_x(lams), lams)
    y = np.trapezoid(vals * cie_y(lams), lams)
    z = np.trapezoid(vals * cie_z(lams), lams)
    norm = np.trapezoid(cie_y(lams), lams)
    return XYZ_TO_SRGB @ (np.array([x, y, z]) / norm)


def srgb_encode(linear):
    """Linear -> sRGB gamma."""
    linear = np.clip(linear, 0.0, 1.0)
    return np.where(linear <= 0.0031308, 12.92 * linear,
                    1.055 * np.power(np.maximum(linear, 1e-8), 1.0 / 2.4)
                    - 0.055)


def srgb_decode(encoded):
    encoded = np.asarray(encoded)
    return np.where(encoded <= 0.04045, encoded / 12.92,
                    np.power((np.maximum(encoded, 0.04045) + 0.055) / 1.055,
                             2.4))


def _xy_to_xyz(x, y):
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


def rgb_matrices(primaries, white_xy):
    """(r_xy, g_xy, b_xy), white_xy -> (RGB_TO_XYZ, XYZ_TO_RGB)
    (colorspace.h: the primary-matrix solve)."""
    M = np.stack([_xy_to_xyz(*p) for p in primaries], 1)  # columns r, g, b
    S = np.linalg.solve(M, _xy_to_xyz(*white_xy))
    rgb_to_xyz = M * S
    return rgb_to_xyz, np.linalg.inv(rgb_to_xyz)


_D65 = (0.3127, 0.3290)
COLOR_SPACES = {
    "srgb": rgb_matrices(((0.64, 0.33), (0.30, 0.60), (0.15, 0.06)), _D65),
    "rec2020": rgb_matrices(((0.708, 0.292), (0.170, 0.797),
                             (0.131, 0.046)), _D65),
    # ACES2065-1 (AP0 primaries, ~D60 white)
    "aces2065-1": rgb_matrices(((0.7347, 0.2653), (0.0, 1.0),
                                (0.0001, -0.077)), (0.32168, 0.33767)),
    # DCI-P3 with the DCI white point
    "dci-p3": rgb_matrices(((0.680, 0.320), (0.265, 0.690),
                            (0.150, 0.060)), (0.314, 0.351)),
}


def convert_rgb(rgb, src="srgb", dst="aces2065-1"):
    """Linear RGB -> linear RGB across color spaces through XYZ, in
    float32 (no chromatic adaptation: the reference's direct matrices)."""
    to_xyz = np.asarray(COLOR_SPACES[src][0], np.float32)
    from_xyz = np.asarray(COLOR_SPACES[dst][1], np.float32)
    return np.asarray(rgb, np.float32) @ to_xyz.T @ from_xyz.T
