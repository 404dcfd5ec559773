"""The port's guiding modules against the JAX package's on the same numpy
inputs: vMF math, the field's EM update and training step, radiance
propagation, the ISGB, the VSPG kernel's host tables and its constant
layout.

Tolerance: 1e-5 relative (1e-6 absolute) unless a test states otherwise.
Both sides run the same float32 formulas in the same order; what differs
is the last bit of a transcendental and the order of scatter-add sums."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.guiding import field as jfield
from vspg_pbrt_v4_tpu.models.guiding import isgb as jisgb
from vspg_pbrt_v4_tpu.models.guiding import recording as jrec
from vspg_pbrt_v4_tpu.models.guiding import vmf as jvmf
from vspg_pbrt_v4_tpu.models.integrators import guided_volpath as jgv
from vspg_pbrt_v4_tpu.ops import pallas_vspg as jpk
from vspg_pbrt_v4_tpu_torch.convert import field_from_jax, isgb_from_jax
from vspg_pbrt_v4_tpu_torch.models.guiding import field as tfield
from vspg_pbrt_v4_tpu_torch.models.guiding import isgb as tisgb
from vspg_pbrt_v4_tpu_torch.models.guiding import recording as trec
from vspg_pbrt_v4_tpu_torch.models.guiding import vmf as tvmf
from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath as tgv
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, rtol=RTOL, atol=ATOL):
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(a, np.asarray(j), rtol=rtol, atol=atol)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _dirs(rng, *shape):
    v = rng.standard_normal(shape + (3,)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _mixture(rng, n=64, k=4):
    w = rng.uniform(0.05, 1.0, (n, k)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    kap = rng.uniform(0.0, 40.0, (n, k)).astype(np.float32)
    kap[:, 0] = 0.004  # below MIN_KAPPA: the uniform branch
    return w, _dirs(rng, n, k), kap


def _vmf_case(name, rng):
    """(torch result, JAX result) of one vmf function on random inputs."""
    n = 64
    w, mu, kap = _mixture(rng, n)
    x = _dirs(rng, n)
    u = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    us = rng.uniform(0, 1, n).astype(np.float32)
    k1 = kap[:, 1]
    if name == "vmf_pdf":
        return (tvmf.vmf_pdf(_t(x), _t(mu[:, 1]), _t(k1)),
                jvmf.vmf_pdf(x, mu[:, 1], k1))
    if name == "vmf_sample":
        return (tvmf.vmf_sample(_t(mu[:, 1]), _t(k1), _t(u)),
                jvmf.vmf_sample(mu[:, 1], k1, u))
    if name == "kappa_rho":
        rho = rng.uniform(0, 1, n).astype(np.float32)
        return (torch.stack([tvmf.kappa_to_rho(_t(k1)),
                             tvmf.rho_to_kappa(_t(rho))]),
                jnp.stack([jvmf.kappa_to_rho(k1), jvmf.rho_to_kappa(rho)]))
    if name == "log_c":
        return tvmf._log_c(_t(kap)), jvmf._log_c(kap)
    if name == "mixture_pdf":
        return (tvmf.mixture_pdf(_t(x), _t(w), _t(mu), _t(kap)),
                jvmf.mixture_pdf(x, w, mu, kap))
    if name == "mixture_sample":
        tw, tp = tvmf.mixture_sample(_t(w), _t(mu), _t(kap), _t(us), _t(u))
        jw, jp = jvmf.mixture_sample(w, mu, kap, us, u)
        return torch.cat([tw, tp[:, None]], -1), jnp.concatenate(
            [jw, jp[:, None]], -1)
    if name == "product_with_vmf":
        kb = rng.uniform(0.5, 20.0, n).astype(np.float32)
        out_t = tvmf.product_with_vmf(_t(w), _t(mu), _t(kap), _t(x), _t(kb))
        out_j = jvmf.product_with_vmf(w, mu, kap, x, kb)
        return (torch.cat([o.reshape(n, -1) for o in out_t], -1),
                jnp.concatenate([o.reshape(n, -1) for o in out_j], -1))
    if name == "hg_lobe":
        g = rng.uniform(-0.9, 0.9, n).astype(np.float32)
        g[:4] = 0.0
        mt, kt = tvmf.hg_lobe(_t(x), _t(g))
        mj, kj = jvmf.hg_lobe(x, g)
        return torch.cat([mt, kt[:, None]], -1), jnp.concatenate(
            [mj, kj[:, None]], -1)
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["vmf_pdf", "vmf_sample", "kappa_rho",
                                  "log_c", "mixture_pdf", "mixture_sample",
                                  "product_with_vmf", "hg_lobe"])
def test_vmf_matches_jax(name):
    t, j = _vmf_case(name, np.random.default_rng(3))
    # products with kappa up to ~60 amplify one ulp of exp/log: 2e-5
    rtol = 2e-5 if name == "product_with_vmf" else RTOL
    _close(t, j, rtol=rtol, atol=1e-5)


def _batch(rng, n=400, lo=-1.1, hi=1.1):
    """A random TrainBatch as numpy arrays (positions inside the field)."""
    pos = rng.uniform(lo * 0.99, hi * 0.99, (n, 3)).astype(np.float32)
    weight = rng.exponential(1.0, n).astype(np.float32)
    weight[::17] *= 50.0  # outliers for the quantile clamp
    return dict(
        pos=pos, wi=_dirs(rng, n),
        weight=weight,
        radiance=rng.uniform(0, 2, (n, 3)).astype(np.float32),
        distance=rng.uniform(0.01, 3.0, n).astype(np.float32),
        is_volume=rng.uniform(0, 1, n) < 0.7,
        c_vol=rng.uniform(0, 1, n).astype(np.float32),
        c_surf=rng.uniform(0, 1, n).astype(np.float32),
        valid=rng.uniform(0, 1, n) < 0.9)


# Per-array tolerances of the EM update, (rtol, atol) with their reasons:
# the statistics are scatter-add sums of float32 samples (their order and a
# last-bit exp differ: ~1e-7 relative, 5e-5 allows for 50-term cells);
# signed direction sums cancel, so mu and stats_s are held in absolute
# terms; kappa = rho (3 - rho^2) / (1 - rho^2) grows that noise by
# 1 / (1 - rho^2) for concentrated lobes; the responsibility-weighted
# statistics pass through exp(kappa (mu.w - 1)) with kappa up to 2e3,
# which turns 1e-7 into ~3e-4.
_EM_TOL = {"mu": (0.0, 1e-5), "stats_s": (0.0, 1e-5), "kappa": (2e-4, 1e-5),
           "stats_dist": (2e-3, 1e-5), "vsp_lobe_vol": (2e-3, 1e-5),
           "vsp_lobe_surf": (2e-3, 1e-5)}


def _fields_close(tf, jf):
    assert tf.iteration == int(jf.iteration)
    for half in ("surface", "volume"):
        th, jh = getattr(tf, half), getattr(jf, half)
        for name in tfield.FieldHalf.__dataclass_fields__:
            rtol, atol = _EM_TOL.get(name, (5e-5, 1e-6))
            if tf.iteration > 1:
                # each later E-step weighs its samples by the previous
                # step's kappa-sensitive responsibilities: the first
                # step's noise compounds into every array
                rtol, atol = max(rtol, 2e-3), max(atol, 5e-4)
            _close(getattr(th, name), getattr(jh, name), rtol=rtol,
                   atol=atol)


def _jax_trained_field(steps=2, seed=5):
    rng = np.random.default_rng(seed)
    jf = jfield.GuidingField.make((-1.1,) * 3, (1.1,) * 3, res=4, n_lobes=8)
    for _ in range(steps):
        b = _batch(rng)
        jf = jgv.train_step(jf, jfield.TrainBatch(**{
            k: jnp.asarray(v) for k, v in b.items()}))
    return jf


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_jax(steps):
    """em_update, field_update and train_step over every field array."""
    rng = np.random.default_rng(7)
    jf = jfield.GuidingField.make((-1.1,) * 3, (1.1,) * 3, res=4, n_lobes=8)
    tf = field_from_jax(jf, "cpu")
    for _ in range(steps):
        b = _batch(rng)
        jf = jgv.train_step(jf, jfield.TrainBatch(**{
            k: jnp.asarray(v) for k, v in b.items()}))
        tf = tgv.train_step(tf, tfield.TrainBatch(**{
            k: _t(v) for k, v in b.items()}))
    _fields_close(tf, jf)


def _query_case(name, rng):
    """(torch result, JAX result) of one field query at random points of a
    JAX-trained field and its port copy."""
    jf = _jax_trained_field()
    tf = field_from_jax(jf, "cpu")
    n = 96
    p = rng.uniform(-1.09, 1.09, (n, 3)).astype(np.float32)
    wi = _dirs(rng, n)
    g = rng.uniform(-0.9, 0.9, n).astype(np.float32)
    g[:8] = 0.0  # isotropic lanes skip the HG product

    def flat(d):
        return [x.reshape(n, -1).float() if isinstance(x, torch.Tensor)
                else jnp.asarray(x).reshape(n, -1).astype(jnp.float32)
                for x in d]

    if name in ("gather_variance", "gather_contribution"):
        var = name == "gather_variance"
        return (torch.cat(flat(tfield._gather_half(tf, tf.volume, _t(p),
                                                   var)), -1),
                jnp.concatenate(flat(jfield._gather_half(jf, jf.volume, p,
                                                         var)), -1))
    td = tfield.volume_distribution(tf, _t(p), _t(wi), _t(g))
    jd = jfield.volume_distribution(jf, p, wi, g)
    if name == "volume_distribution":
        return torch.cat(flat(td), -1), jnp.concatenate(flat(jd), -1)
    if name == "dist_pdf":
        return tfield.dist_pdf(td, _t(wi)), jfield.dist_pdf(jd, wi)
    if name == "dist_vsp_directional":
        return (tfield.dist_vsp_directional(td, _t(wi)),
                jfield.dist_vsp_directional(jd, wi))
    if name == "dist_sample":
        us = rng.uniform(0, 1, n).astype(np.float32)
        u2 = rng.uniform(0, 1, (n, 2)).astype(np.float32)
        tw, tp = tfield.dist_sample(td, _t(us), _t(u2))
        jw, jp = jfield.dist_sample(jd, us, u2)
        return torch.cat([tw, tp[:, None]], -1), jnp.concatenate(
            [jw, jp[:, None]], -1)
    raise AssertionError(name)


@pytest.mark.parametrize("name", ["gather_variance", "gather_contribution",
                                  "volume_distribution", "dist_pdf",
                                  "dist_vsp_directional", "dist_sample"])
def test_field_queries_match_jax(name):
    t, j = _query_case(name, np.random.default_rng(17))
    # the HG product's exp(kappa ...) with kappa up to ~2e3: 2e-5, as for
    # product_with_vmf
    _close(t, j, rtol=2e-5, atol=1e-5)


def test_segment_record_make_matches_jax():
    t = trec.SegmentRecord.make(5, 3, device="cpu")
    j = jrec.SegmentRecord.make(5, 3, jnp.zeros(5))
    for a, b in zip(t, j):
        assert tuple(a.shape) == tuple(b.shape)
        assert (a.dtype == torch.bool) == (b.dtype == jnp.bool_)
        _close(a.float(), jnp.asarray(b, jnp.float32))


def test_propagate_matches_jax():
    rng = np.random.default_rng(11)
    R, D = 64, 6
    arrs = dict(
        pos=rng.uniform(-1, 1, (R, D, 3)), wi=_dirs(rng, R, D),
        scatter_w=rng.uniform(0, 1.5, (R, D, 3)),
        direct=rng.uniform(0, 1, (R, D, 3)),
        emission=rng.uniform(0, 1, (R, D, 3)) * (rng.uniform(0, 1, (R, D, 1))
                                                 < 0.3),
        pdf=rng.uniform(0, 2, (R, D)),
        distance=rng.uniform(0, 2, (R, D)) * (rng.uniform(0, 1, (R, D))
                                              < 0.8))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    count = rng.integers(0, D + 1, R)
    valid = np.arange(D)[None] < count[:, None]
    is_vol = (rng.uniform(0, 1, (R, D)) < 0.6) & valid
    jb = jrec.propagate(jrec.SegmentRecord(
        **{k: jnp.asarray(v) for k, v in arrs.items()},
        is_volume=jnp.asarray(is_vol), valid=jnp.asarray(valid),
        count=jnp.asarray(count, jnp.int32)))
    tb = trec.propagate(trec.SegmentRecord(
        **{k: _t(v) for k, v in arrs.items()}, is_volume=_t(is_vol),
        valid=_t(valid), count=_t(count.astype(np.int32))))
    for name in tfield.TrainBatch._fields:
        _close(getattr(tb, name), getattr(jb, name))


def _isgb_pair(criterion, waves=3, res=16):
    rng = np.random.default_rng(13)
    jb = jisgb.ISGB.make((res, res), criterion, "atrous")
    tb = isgb_from_jax(jb, "cpu")
    npix = res * res
    for w in range(waves):
        L = rng.exponential(0.5, (npix, 3)).astype(np.float32)
        alb = rng.uniform(0, 1, (npix, 3)).astype(np.float32)
        nrm = _dirs(rng, npix)
        fv = rng.uniform(0, 1, npix) < 0.5
        ok = rng.uniform(0, 1, npix) < 0.95
        pid = np.arange(npix, dtype=np.int32)
        jb = jisgb.isgb_add_samples(jb, jnp.asarray(pid), L, alb, nrm, fv, ok,
                                    half=w % 2)
        tb = tisgb.isgb_add_samples(tb, _t(pid).long(), _t(L), _t(alb),
                                    _t(nrm), _t(fv), _t(ok), half=w % 2)
    return tb, jb


@pytest.mark.parametrize("criterion", ["variance", "contribution"])
def test_isgb_matches_jax(criterion):
    tb, jb = _isgb_pair(criterion)
    tb, jb = tisgb.isgb_update(tb), jisgb.isgb_update(jb)
    assert tb.ready and bool(jb.ready)
    for name in ("contrib_sum", "albedo_sum", "normal_sum", "n", "c_vol",
                 "c_vol2", "c_surf", "c_surf2", "contrib_a", "n_a",
                 "contrib_est", "vsp_est"):
        _close(getattr(tb, name), getattr(jb, name))
    npix = 256
    _close(sk.pack_isgb_table(tb, npix), jpk.pack_isgb_table(jb, npix))


@pytest.mark.parametrize("which,criterion", [("fresh", "variance"),
                                             ("trained", "variance"),
                                             ("trained", "contribution")])
def test_pack_field_table_matches_jax(which, criterion):
    """The port's unpacked float32 table against the JAX table before its
    bf16 rounding. A fresh field's equal lobe weights make the top-4 pick
    a matter of argsort tie order, which both sides share."""
    jf = (jfield.GuidingField.make((-1.1,) * 3, (1.1,) * 3, res=4,
                                   n_lobes=8) if which == "fresh"
          else _jax_trained_field())
    t = sk.pack_field_table(field_from_jax(jf, "cpu"), criterion)
    j = jpk.pack_field_table(jf, criterion, k_top=sk.K_PACK)
    assert t.shape == j.shape == (8 * sk.K_PACK + 8, 64)
    # the table is numpy on both sides, from the same float32 arrays
    np.testing.assert_array_equal(t, j)


def test_guiding_constants_match_jax():
    """The configuration dict keeps the JAX package's keys and values."""
    from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
    from vspg_pbrt_v4_tpu_torch.convert import options_from_jax

    jf = _jax_trained_field(1)
    jg, jv = jgv.GuidingOptions(field_res=4), jvspg.VSPGOptions()
    tg, tv = options_from_jax(jg, jv)
    j = jpk.guiding_constants(jf, jg, jv)
    t = sk.guiding_constants(field_from_jax(jf, "cpu"), tg, tv)
    j.pop("field_mxu")  # the TPU's one-hot fetch switch
    assert t == j


def test_constant_layout_matches_header():
    """csrc/vspg.cuh declares the same guiding-table layout."""
    src = (Path(sk.__file__).parent.parent / "csrc" / "vspg.cuh").read_text()
    decl = {m[0]: int(m[1]) for m in re.findall(
        r"\b(GI?_\w+|N_GI?CONST)\s*=\s*(\d+)", src)}
    names = [n for n in dir(sk) if re.fullmatch(r"GI?_\w+|N_GI?CONST", n)]
    assert len(names) == len(decl) == 22 + 1 + 16 + 1
    for n in names:
        assert decl[n] == getattr(sk, n), n
