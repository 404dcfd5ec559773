"""Stateless counter-based RNG (counterpart of ``utils/rng.py``).

The pcg4d hash (Jarzynski & Olano, JCGT 2020) keyed by (seed, pixel,
sample, dimension), bit-exact with the JAX package and with the CUDA
kernels' copy in ``csrc/common.cuh``.

CPU torch implements no uint32 addition, so every word is carried as an
int64 holding a value in [0, 2^32) and masked with ``& 0xFFFFFFFF`` after
each add, multiply, xor and shift. A product of two such words can wrap
int64; the wrap is two's complement, so its low 32 bits, which are all the
mask keeps, are still right.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_MULT = 1664525
_INC = 1013904223
_INV_2_24 = 1.0 / (1 << 24)  # top 24 bits -> exact f32 in [0, 1)


def _device_of(words):
    for w in words:
        if isinstance(w, torch.Tensor):
            return w.device
    return torch.device("cpu")


def _u32(x, device):
    """Any integer tensor (or Python int) -> int64 word in [0, 2^32)."""
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK


def _pcg4d(a, b, c, d):
    """pcg4d mix of four uint32 words (int64 carriers) -> four words."""
    dev = _device_of((a, b, c, d))
    a, b, c, d = torch.broadcast_tensors(_u32(a, dev), _u32(b, dev),
                                         _u32(c, dev), _u32(d, dev))
    a = (a * _MULT + _INC) & _MASK
    b = (b * _MULT + _INC) & _MASK
    c = (c * _MULT + _INC) & _MASK
    d = (d * _MULT + _INC) & _MASK
    a = (a + b * d) & _MASK
    b = (b + c * a) & _MASK
    c = (c + a * b) & _MASK
    d = (d + b * c) & _MASK
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + b * d) & _MASK
    b = (b + c * a) & _MASK
    c = (c + a * b) & _MASK
    d = (d + b * c) & _MASK
    return a, b, c, d


def hash_u32(*words):
    """Mix integer words into one uint32 word (pbrt Hash() analog)."""
    dev = _device_of(words)
    ws = [_u32(w, dev) for w in words]
    while len(ws) < 4:
        ws.append(torch.zeros_like(ws[0]))
    a, b, c, d = ws[0], ws[1], ws[2], ws[3]
    for w in ws[4:]:
        a, b, c, d = _pcg4d(a ^ w, b, c, d)
    a, b, c, d = _pcg4d(a, b, c, d)
    return d


def _to_unit_float(u):
    return (u >> 8).to(torch.float32) * _INV_2_24


def uniform4(seed, pixel_id, sample_index, dim):
    """Four independent U[0,1) float32 tensors for each counter tuple."""
    a, b, c, d = _pcg4d(pixel_id, sample_index, dim, seed)
    return (_to_unit_float(a), _to_unit_float(b), _to_unit_float(c),
            _to_unit_float(d))


def uniform3(seed, pixel_id, sample_index, dim):
    """Three U[0,1) floats stacked on a trailing axis."""
    a, b, c, _ = uniform4(seed, pixel_id, sample_index, dim)
    return torch.stack([a, b, c], dim=-1)
