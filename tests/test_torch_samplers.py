"""The port's samplers (``models/samplers.py``, every kind) and
``utils/lowdiscrepancy.py`` against the JAX package's, draw for draw on
numpy-seeded pixel ids, sample indices and scramble seeds: every uint32
word bit for bit, every float draw equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.samplers import LaneSampler as JSampler
from vspg_pbrt_v4_tpu.utils import lowdiscrepancy as jld
from vspg_pbrt_v4_tpu_torch.models.samplers import LaneSampler
from vspg_pbrt_v4_tpu_torch.utils import lowdiscrepancy as tld

N = 512
KINDS = ("independent", "stratified", "halton", "zsobol", "pmj02bn",
         "pmj02", "sobol", "paddedsobol")


def _u32(rng, n=N):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _j(a):
    return jnp.asarray(np.asarray(a, np.uint32))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                  np.asarray(j).astype(np.int64))


def test_word_functions_match_jax():
    """reverse_bits32, sobol_dim0/1, fast_owen_scramble, encode_morton2,
    sobol_u32 over many dimensions, permutation_element and
    zsobol_shuffled_index: the same uint32 words."""
    rng = np.random.default_rng(0)
    v, s = _u32(rng), _u32(rng)
    for fn in ("reverse_bits32", "sobol_dim0", "sobol_dim1"):
        _eq(getattr(tld, fn)(_t(v)), getattr(jld, fn)(_j(v)))
    _eq(tld.fast_owen_scramble(_t(v), _t(s)),
        jld.fast_owen_scramble(_j(v), _j(s)))
    x, y = rng.integers(0, 1 << 16, (2, N))
    _eq(tld.encode_morton2(_t(x), _t(y)), jld.encode_morton2(_j(x), _j(y)))
    dims = rng.integers(0, 1100, N)  # past the table: clipped to its end
    _eq(tld.sobol_u32(_t(v), torch.as_tensor(dims)),
        jld.sobol_u32(_j(v), jnp.asarray(dims, jnp.int32)))
    for n in (1, 7, 64, 100, 4096):
        i = rng.integers(0, n, N)
        _eq(tld.permutation_element(_t(i), n, _t(s)),
            jld.permutation_element(_j(i), jnp.uint32(n), _j(s)))
    for digits in (3, 9, 14):
        m = _u32(rng) >> np.uint32(32 - 2 * digits)
        _eq(tld.zsobol_shuffled_index(_t(m), digits, _t(s)),
            jld.zsobol_shuffled_index(_j(m), digits, _j(s)))


def test_float_functions_match_jax():
    """u32_to_unit_float, the (scrambled) radical inverse in every prime
    base of the table, and a pmj02 table: equal floats."""
    rng = np.random.default_rng(1)
    v, s = _u32(rng), _u32(rng)
    np.testing.assert_array_equal(tld.u32_to_unit_float(_t(v)).numpy(),
                                  np.asarray(jld.u32_to_unit_float(_j(v))))
    for k in range(len(jld.PRIMES)):
        np.testing.assert_array_equal(
            tld.radical_inverse(k, _t(v)).numpy(),
            np.asarray(jld.radical_inverse(k, _j(v))), err_msg=str(k))
        np.testing.assert_array_equal(
            tld.scrambled_radical_inverse(k, _t(v), _t(s)).numpy(),
            np.asarray(jld.scrambled_radical_inverse(k, _j(v), _j(s))),
            err_msg=str(k))
    for seed in (0, 5):
        np.testing.assert_array_equal(
            tld.generate_pmj02_table(256, seed).numpy(),
            np.asarray(jld.generate_pmj02_table(256, seed)))


def test_sobol_matrices_match_jax():
    """The generated direction-number table, word for word."""
    np.testing.assert_array_equal(
        tld.sobol_matrices().numpy(),
        np.asarray(jld.sobol_matrices()).astype(np.int64))


@pytest.mark.parametrize("kind", KINDS)
def test_lane_sampler_matches_jax(kind):
    """Twelve draws of each width (1d, 2d, 3d, 4d in turn) from lanes of
    numpy-seeded pixels (of a 40-pixel-wide film, for zsobol's Morton
    index) and sample indices at 16 spp: every draw equal, and every draw
    in [0, 1)."""
    rng = np.random.default_rng(2)
    pid = rng.integers(0, 40 * 30, N)
    sidx = rng.integers(0, 16, N)
    js = JSampler.start(7, jnp.asarray(pid, jnp.uint32),
                        jnp.asarray(sidx, jnp.uint32), kind=kind, spp=16,
                        nx=40)
    ts = LaneSampler.start(7, torch.as_tensor(pid), torch.as_tensor(sidx),
                           kind=kind, spp=16, nx=40)
    for step in range(12):
        get = ("get_1d", "get_2d", "get_3d", "get_4d")[step % 4]
        js, uj = getattr(js, get)()
        ts, ut = getattr(ts, get)()
        if get == "get_4d":
            uj, ut = jnp.stack(uj, -1), torch.stack(ut, -1)
        ut = ut.numpy()
        np.testing.assert_array_equal(ut, np.asarray(uj),
                                      err_msg=f"{kind} {get} {step}")
        assert ut.min() >= 0.0 and ut.max() < 1.0
    assert torch.equal(ts.dim, torch.full((N,), 12, dtype=torch.int64))


def test_unknown_kind_raises():
    s = LaneSampler.start(0, torch.arange(4), 0, kind="lowdiscrepancy")
    with pytest.raises(ValueError, match="unknown sampler kind"):
        s.get_1d()


def test_stratified_kinds_stratify():
    """At 64 spp each pixel's draws of a stratified, padded Sobol' or
    pmj02 dimension cover the 64 strata of [0, 1) (the property the JAX
    package's tests/test_samplers.py checks, on the port's draws)."""
    spp, npix = 64, 8
    for kind in ("stratified", "paddedsobol", "pmj02bn", "sobol"):
        u = np.stack([LaneSampler.start(3, torch.arange(npix), s, kind=kind,
                                        spp=spp).get_2d()[1].numpy()
                      for s in range(spp)], 1)  # (npix, spp, 2)
        for p in range(npix):
            counts = np.histogram(u[p, :, 0], bins=spp, range=(0, 1))[0]
            assert (counts > 0).mean() > 0.75 and counts.max() <= 2, kind
