"""Perlin gradient noise, fBm and turbulence (counterpart of
``utils/noise.py``).

The lattice hash is arithmetic (pcg-style integer mixing), not pbrt's
permutation table, bit for bit with the JAX package. CPU torch has no
uint32 multiply or shift, so every word is an int64 holding a value in
[0, 2^32), masked with ``& 0xFFFFFFFF`` after each multiply and xor (as in
``utils/rng.py``). A negative lattice coordinate masks to its two's
complement, the value JAX's cast to uint32 gives; a product that wraps
int64 keeps its low 32 bits, all that the mask keeps.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def _hash3(ix, iy, iz):
    """uint32 hash (int64 carrier) of three int64 lattice coordinates."""
    h = (((ix & _MASK) * 0x9E3779B1) & _MASK
         ^ ((iy & _MASK) * 0x85EBCA77) & _MASK
         ^ ((iz & _MASK) * 0xC2B2AE3D) & _MASK)
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _MASK
    h = h ^ (h >> 12)
    h = (h * 0x297A2D39) & _MASK
    return h ^ (h >> 15)


def _grad(h, x, y, z):
    """Perlin's 12-edge gradient set selected by the low hash bits."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return (torch.where((h & 1) == 0, u, -u)
            + torch.where((h & 2) == 0, v, -v))


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin(p):
    """Gradient noise in [-1, 1] for float32 points p: (..., 3)."""
    pf = torch.floor(p)
    ix, iy, iz = (pf[..., k].to(torch.int64) for k in range(3))
    x = p[..., 0] - pf[..., 0]
    y = p[..., 1] - pf[..., 1]
    z = p[..., 2] - pf[..., 2]
    u, v, w = _fade(x), _fade(y), _fade(z)

    def corner(dx, dy, dz):
        h = _hash3(ix + dx, iy + dy, iz + dz)
        return _grad(h, x - dx, y - dy, z - dz)

    c000 = corner(0, 0, 0)
    c100 = corner(1, 0, 0)
    c010 = corner(0, 1, 0)
    c110 = corner(1, 1, 0)
    c001 = corner(0, 0, 1)
    c101 = corner(1, 0, 1)
    c011 = corner(0, 1, 1)
    c111 = corner(1, 1, 1)
    x00 = c000 + u * (c100 - c000)
    x10 = c010 + u * (c110 - c010)
    x01 = c001 + u * (c101 - c001)
    x11 = c011 + u * (c111 - c011)
    y0 = x00 + v * (x10 - x00)
    y1 = x01 + v * (x11 - x01)
    return y0 + w * (y1 - y0)


def octave_points(p, octaves):
    """(octaves, ..., 3): p scaled by each octave's frequency 1.99^i, the
    frequency rounded to float32 as a Python number multiplying a float32
    tensor is; one perlin call over all of them evaluates every octave in
    one set of launches, each element as alone."""
    lam, lams = 1.0, []
    for _ in range(int(octaves)):
        lams.append(lam)
        lam *= 1.99
    lam_t = torch.tensor(lams, dtype=torch.float32, device=p.device)
    return p[None] * lam_t.reshape((-1,) + (1,) * p.dim())


def _octave_sum(noise, omega):
    """sum_i omega^i noise[i], accumulated in octave order."""
    total = torch.zeros(noise.shape[1:], device=noise.device)
    o = 1.0
    for i in range(noise.shape[0]):
        total = total + o * noise[i]
        o *= omega
    return total


def fbm(p, omega=0.5, octaves=6):
    """Fractional Brownian motion (pbrt FBm with a fixed octave count)."""
    return _octave_sum(perlin(octave_points(p, octaves)), omega)


def turbulence(p, omega=0.5, octaves=6):
    """Sum of |noise| octaves (pbrt Turbulence with a fixed octave
    count)."""
    return _octave_sum(torch.abs(perlin(octave_points(p, octaves))), omega)
