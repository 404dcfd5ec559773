"""Low-discrepancy sequences (counterpart of ``utils/lowdiscrepancy.py``).

The samplers built on these draw the first two Sobol' dimensions with
per-dimension random padding (the PaddedSobol and ZSobol strategies),
Owen-scrambled by the Laine-Karras style hash, a full-dimensional Sobol'
over generated direction numbers, scrambled Halton, and PMJ02 sets from
Owen-scrambled (0,2) sequences; every formula and constant is the JAX
package's, so each draw is its bits.

CPU torch implements no uint32 addition or shift, so every word is an int64
holding a value in [0, 2^32), masked with ``& 0xFFFFFFFF`` after each add,
multiply and left shift. A product of two words can wrap int64; the wrap
is two's complement, so the low 32 bits the mask keeps are still right.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from . import rng

_M = 0xFFFFFFFF
_INV_2_32 = 2.3283064365386963e-10
_ONE_MINUS = 0.99999994


def _u32(v):
    return v.to(torch.int64) & _M


def reverse_bits32(v):
    v = _u32(v)
    v = ((v << 16) | (v >> 16)) & _M
    v = ((v & 0x00FF00FF) << 8) | ((v & 0xFF00FF00) >> 8)
    v = ((v & 0x0F0F0F0F) << 4) | ((v & 0xF0F0F0F0) >> 4)
    v = ((v & 0x33333333) << 2) | ((v & 0xCCCCCCCC) >> 2)
    return ((v & 0x55555555) << 1) | ((v & 0xAAAAAAAA) >> 1)


def sobol_dim0(index):
    """First Sobol dimension = radical inverse base 2 (identity matrix)."""
    return reverse_bits32(index)


def sobol_dim1(index):
    """Second Sobol dimension (Pascal-matrix recurrence): v_0 =
    0x80000000, v_{k+1} = v_k ^ (v_k >> 1); XOR v_k where bit k of the
    index is set."""
    index = _u32(index)
    result = torch.zeros_like(index)
    v = torch.full_like(index, 1 << 31)
    for k in range(32):
        bit = (index >> k) & 1
        result = result ^ (v * bit)
        v = v ^ (v >> 1)
    return result


def fast_owen_scramble(v, seed):
    """Hash-based Owen scrambling on reversed bits (FastOwenScrambler)."""
    v = reverse_bits32(v)
    seed = _u32(torch.as_tensor(seed, device=v.device))
    v = v ^ ((v * 0x3D20ADEA) & _M)
    v = (v + seed) & _M
    v = (v * ((seed >> 16) | 1)) & _M
    v = v ^ ((v * 0x05526C56) & _M)
    v = v ^ ((v * 0x53A22864) & _M)
    return reverse_bits32(v)


def u32_to_unit_float(v):
    """uint32 -> [0,1) float32 (strictly below 1)."""
    return torch.clamp(v.to(torch.float32) * _INV_2_32, max=_ONE_MINUS)


def permutation_element(i, n, seed):
    """Kensler-style stateless random permutation of [0, n) (pbrt
    PermutationElement): the position of element i under a random
    permutation keyed by seed."""
    i = _u32(i)
    n = _u32(torch.as_tensor(n, device=i.device))
    seed = _u32(torch.as_tensor(seed, device=i.device))
    w = (n - 1) & _M
    for s in (1, 2, 4, 8, 16):
        w = w | (w >> s)

    def rounds(i):
        i = i ^ seed
        i = (i * 0xE170893D) & _M
        i = i ^ (seed >> 16)
        i = i ^ ((i & w) >> 4)
        i = i ^ (seed >> 8)
        i = (i * 0x0929EB3F) & _M
        i = i ^ (seed >> 23)
        i = i ^ ((i & w) >> 1)
        i = (i * (1 | (seed >> 27))) & _M
        i = (i * 0x6935FA69) & _M
        i = i ^ ((i & w) >> 11)
        i = (i * 0x74DCB303) & _M
        i = i ^ ((i & w) >> 2)
        i = (i * 0x9E501CC3) & _M
        i = i ^ ((i & w) >> 2)
        i = (i * 0xC860A3DF) & _M
        i = i & w
        return i ^ (i >> 5)

    # cycle-walk until inside [0, n); bounded tries suffice since w < 2n
    out = rounds(i)
    for _ in range(12):
        out = torch.where(out >= n, rounds(out), out)
    out = torch.where(out >= n, i, out)  # ~2^-13 fallback keeps validity
    return ((out + seed) & _M) % n


# ---------------------------------------------------------------------------
# Full-dimensional Sobol' generator matrices, generated as the JAX package
# generates them: primitive polynomials over GF(2) by exhaustive order
# search, the direction-number recurrence seeded with deterministic
# pseudorandom odd initial values (Bratley-Fox construction)
# ---------------------------------------------------------------------------

N_SOBOL_DIMS = 1024


def _gf2_mulmod(a, b, poly, s):
    """(a*b) mod poly over GF(2), poly of degree s (as int bitmasks)."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a >> s & 1:
            a ^= poly
    return r


def _is_primitive(poly, s):
    """poly (degree s, bitmask incl. x^s term) primitive over GF(2)?"""
    n = (1 << s) - 1
    factors = []
    m = n
    d = 2
    while d * d <= m:
        if m % d == 0:
            factors.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        factors.append(m)

    def powx(e):
        r, base = 1, 2  # x
        while e:
            if e & 1:
                r = _gf2_mulmod(r, base, poly, s)
            base = _gf2_mulmod(base, base, poly, s)
            e >>= 1
        return r

    if powx(n) != 1:
        return False
    return all(powx(n // q) != 1 for q in factors)


def _primitive_polynomials(count):
    """First `count` primitive polynomials in degree order (bitmask incl.
    leading term), degree-1 'x+1' first."""
    out = []
    s = 1
    while len(out) < count:
        for p in range(1 << s, 1 << (s + 1)):
            if not (p & 1):  # constant term required
                continue
            if _is_primitive(p, s):
                out.append((p, s))
                if len(out) == count:
                    break
        s += 1
    return out


def _generate_sobol_matrices(n_dims=N_SOBOL_DIMS, bits=32):
    """(n_dims, bits) uint32 direction numbers v_k, MSB-aligned."""
    mats = np.zeros((n_dims, bits), np.uint64)
    mats[0] = [1 << (31 - k) for k in range(bits)]  # identity (van der Corput)
    polys = _primitive_polynomials(n_dims - 1)
    gen = np.random.default_rng(0x5B0B01)
    for j, (poly, s) in enumerate(polys, start=1):
        a = [(poly >> (s - 1 - i)) & 1 for i in range(1, s)]
        m = [0] * (bits + 1)
        for i in range(1, min(s, bits) + 1):
            # odd initial value < 2^i; m_1 = 1 keeps the first column dense
            m[i] = 1 if i == 1 else (int(gen.integers(0, 1 << (i - 1))) * 2
                                     + 1)
        for k in range(s + 1, bits + 1):
            v = m[k - s] ^ (m[k - s] << s)
            for i in range(1, s):
                if a[i - 1]:
                    v ^= m[k - i] << i
            m[k] = v
        for k in range(1, bits + 1):
            mats[j, k - 1] = m[k] << (32 - k)
    return (mats & 0xFFFFFFFF).astype(np.uint32)


# the direction-number table by device, generated at its first use
_SOBOL_MATRICES = {}


def sobol_matrices(device="cpu"):
    """The (N_SOBOL_DIMS, 32) direction-number table as int64 words on
    `device` (generated once, then cached per device)."""
    key = str(torch.device(device))
    if key not in _SOBOL_MATRICES:
        if "cpu" not in _SOBOL_MATRICES:
            _SOBOL_MATRICES["cpu"] = torch.as_tensor(
                _generate_sobol_matrices().astype(np.int64))
        _SOBOL_MATRICES[key] = _SOBOL_MATRICES["cpu"].to(device)
    return _SOBOL_MATRICES[key]


def sobol_u32(index, dim_idx):
    """Sobol' component for per-lane dimension indices: each lane's 32
    direction numbers XOR-folded over the set bits of its index (a
    log-depth fold, as the JAX package's)."""
    mats = sobol_matrices(index.device)
    dim_idx = torch.clamp(dim_idx.to(torch.int64), 0, N_SOBOL_DIMS - 1)
    cols = mats[dim_idx]  # (R, 32)
    index = _u32(index)
    bits = (index[..., None] >> torch.arange(32, device=index.device)) & 1
    v = cols * bits
    for shift in (16, 8, 4, 2, 1):
        v = v[..., :shift] ^ v[..., shift:2 * shift]
    return v[..., 0]


# ---------------------------------------------------------------------------
# Halton: radical inverse in prime bases with affine digit scrambling
# ---------------------------------------------------------------------------

PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
# digits of a uint32 in each base (ceil(32 / log2(base)))
_N_DIGITS = {2: 32, 3: 21, 5: 14, 7: 12, 11: 10, 13: 9, 17: 8, 19: 8,
             23: 8, 29: 7, 31: 7, 37: 6}


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


def radical_inverse(prime_index, index):
    """Van der Corput inverse of `index` in base PRIMES[prime_index]."""
    base = PRIMES[prime_index % len(PRIMES)]
    if base == 2:
        return u32_to_unit_float(reverse_bits32(index))
    index = _u32(index)
    inv_base = _f32(1.0 / base, index.device)
    rev = torch.zeros(index.shape, dtype=torch.float32, device=index.device)
    scale = _f32(1.0, index.device)
    for _ in range(_N_DIGITS[base]):
        digit = (index % base).to(torch.float32)
        index = index // base
        scale = scale * inv_base
        rev = rev + digit * scale
    return torch.clamp(rev, max=_ONE_MINUS)


def scrambled_radical_inverse(prime_index, index, seed):
    """Radical inverse with per-digit-position affine permutations (d ->
    (a d + b) mod base, a coprime to the prime base), keyed by seed and the
    more significant digits still in the running index."""
    base = PRIMES[prime_index % len(PRIMES)]
    index = _u32(index)
    seed = _u32(torch.as_tensor(seed, device=index.device))
    inv_base = _f32(1.0 / base, index.device)
    rev = torch.zeros(index.shape, dtype=torch.float32, device=index.device)
    scale = _f32(1.0, index.device)
    for k in range(_N_DIGITS[base]):
        digit = index % base
        index = index // base
        h = rng.hash_u32(seed, k, index, base)
        a = h % (base - 1) + 1  # in [1, base)
        b = (h >> 8) % base
        digit = (a * digit + b) % base
        scale = scale * inv_base
        rev = rev + digit.to(torch.float32) * scale
    return torch.clamp(rev, max=_ONE_MINUS)


# ---------------------------------------------------------------------------
# ZSobol: Morton-shuffled Sobol (samplers.h ZSobolSampler semantics)
# ---------------------------------------------------------------------------


def encode_morton2(x, y):
    """Interleave 16-bit x (even bits) and y (odd bits)."""
    def part1by1(v):
        v = _u32(v) & 0x0000FFFF
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        return (v | (v << 1)) & 0x55555555

    return part1by1(x) | (part1by1(y) << 1)


# the 24 permutations of {0,1,2,3} (samplers.cpp ZSobol permutations table)
_PERM4 = np.asarray(list(itertools.permutations(range(4))), np.int64)


def zsobol_shuffled_index(morton, n_base4_digits, seed):
    """Hierarchically permute the base-4 digits of the Morton index, the
    permutation of each digit keyed by the hash of its more significant
    digits (ZSobolSampler::GetSampleIndex top-down walk)."""
    morton = _u32(morton)
    seed = _u32(torch.as_tensor(seed, device=morton.device))
    perm = torch.as_tensor(_PERM4, device=morton.device)
    out = torch.zeros_like(morton)
    n = int(n_base4_digits)
    for i in range(n):
        shift = 2 * (n - 1 - i)
        digit = (morton >> shift) & 3
        higher = morton >> (shift + 2)
        p = rng.hash_u32(higher, seed, i, 0x55) % 24
        out = out | (perm[p, digit] << shift)
    return out & _M


# ---------------------------------------------------------------------------
# PMJ02 point sets (samplers.h PMJ02BNSampler role): every prefix of an
# Owen-scrambled (0,2) sequence is a pmj02 set
# ---------------------------------------------------------------------------


def generate_pmj02_table(n, seed=0, device="cpu"):
    """One pmj02 point set of n samples, (n, 2) float32 (progressive:
    every power-of-two prefix is stratified on all elementary (0,2)
    intervals)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    sx = (seed * 0x9E3779B9 + 0x1234567) & _M
    sy = (seed * 0x85EBCA6B + 0x89ABCD) & _M
    x = fast_owen_scramble(sobol_dim0(idx), torch.full_like(idx, sx))
    y = fast_owen_scramble(sobol_dim1(idx), torch.full_like(idx, sy))
    return torch.stack([u32_to_unit_float(x), u32_to_unit_float(y)], -1)
