"""The distance samplers of the torch VSPG wave against the JAX package's
(``sample_distance_vspg`` and its routes, ``lookup_vsp``, the guided RR
survivals) on the same lanes and the same sampler stream: numpy-seeded
origins inside the box, directions, target VSPs and path weights. Both
sides walk the same majorant segments with the same draws, so they agree
lane for lane; a lane may leave where a float32 comparison falls the other
way after a last-bit difference of a transcendental (the reason for the
0.99 fractions)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.guiding import field as jfield
from vspg_pbrt_v4_tpu.models.guiding import isgb as jisgb
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu.models.samplers import LaneSampler as JSampler
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg
from vspg_pbrt_v4_tpu_torch.models.samplers import LaneSampler

from test_torch_vspg_kernel import GOPT, jax_setup, lanes_close

R = 512
CFG = jv.VolPathConfig(max_depth=8)


def _lanes(seed=0):
    """Lanes inside the [-1, 1]^3 box: origin, unit direction, distance to
    the wall, hero channel, target VSP, path weights."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.95, 0.95, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    with np.errstate(divide="ignore"):
        t_hi = np.maximum((1.0 - o) / d, (-1.0 - o) / d)
    seg_end = t_hi.min(-1).astype(np.float32)
    hero_idx = rng.integers(0, 3, R)
    vsp = rng.uniform(0.05, 0.95, R).astype(np.float32)
    beta = rng.uniform(0.5, 1.0, (R, 3)).astype(np.float32)
    return dict(o=o, d=d, seg_end=seg_end, hero=hero_idx, vsp=vsp,
                beta=beta, r_u=np.ones((R, 3), np.float32),
                r_l=rng.uniform(0.5, 2.0, (R, 3)).astype(np.float32),
                guide=rng.uniform(size=R) < 0.75,
                depth=rng.integers(0, 2, R))


def _run(scene, vopt, lanes, tr_prev=None):
    """sample_distance_vspg of both packages on the same lanes; returns
    (port result, JAX result) as numpy rows per lane."""
    _, cam, film = jax_setup()
    ts = convert.from_jax(scene, cam, film, CFG, "cpu")[0]
    tv = convert.options_from_jax(GOPT, vopt)[1]
    pid = np.arange(R)
    L = np.zeros((R, 3), np.float32)
    act = np.ones(R, bool)
    med = np.zeros(R, np.int32)
    tr = None if tr_prev is None else np.full((R, 3), tr_prev, np.float32)
    j = jvspg.sample_distance_vspg(
        scene, CFG, vopt, jnp.asarray(lanes["o"]), jnp.asarray(lanes["d"]),
        jnp.asarray(lanes["seg_end"]), jnp.asarray(med),
        jnp.asarray(lanes["hero"]), JSampler.start(5, jnp.asarray(
            pid, jnp.uint32), 3), jnp.asarray(lanes["beta"]),
        jnp.asarray(lanes["r_u"]), jnp.asarray(lanes["r_l"]), jnp.asarray(L),
        jnp.asarray(lanes["guide"]), jnp.asarray(lanes["vsp"]),
        jnp.asarray(act), tr_prev=None if tr is None else jnp.asarray(tr),
        depth=jnp.asarray(lanes["depth"], jnp.int32))
    t = tvspg.sample_distance_vspg(
        ts, CFG, tv, torch.as_tensor(lanes["o"]), torch.as_tensor(lanes["d"]),
        torch.as_tensor(lanes["seg_end"]), torch.as_tensor(med),
        torch.as_tensor(lanes["hero"]), LaneSampler.start(
            5, torch.as_tensor(pid), 3), torch.as_tensor(lanes["beta"]),
        torch.as_tensor(lanes["r_u"]), torch.as_tensor(lanes["r_l"]),
        torch.as_tensor(L), torch.as_tensor(lanes["guide"]),
        torch.as_tensor(lanes["vsp"]), torch.as_tensor(act),
        tr_prev=None if tr is None else torch.as_tensor(tr),
        depth=torch.as_tensor(lanes["depth"], dtype=torch.int32))
    return _rows(t, t.sampler.dim), _rows(j, j.sampler.dim)


def _rows(res, dim):
    parts = [res.beta, res.r_u, res.r_l, res.scattered, res.terminated,
             res.t_scatter, res.g_scatter, res.albedo_scatter, res.tr_est,
             dim]
    return np.concatenate([np.asarray(p, np.float32).reshape(R, -1)
                           for p in parts], -1)


def _check(t, j, label):
    frac = lanes_close(t, j)
    print(f"{label}: {frac:.4f} of lanes equal within 1e-4")
    assert frac >= 0.99, (label, frac)


@pytest.fixture(scope="module")
def cloud():
    return jax_setup()[0]


def test_homogeneous_guided_and_unguided():
    """The closed form, VSP-warped on guided lanes and plain on the rest,
    in the fog box."""
    scene = jv.make_fog_box_scene([0.2, 0.25, 0.3], [1.0, 1.2, 1.4], g=0.3,
                                  env_L=[0.5] * 3)
    lanes = _lanes(1)
    t, j = _run(scene, jvspg.VSPGOptions(), lanes)
    _check(t, j, "homogeneous")
    assert 0 < t[:, 9].mean() < 1  # lanes passed and scattered both


@pytest.mark.parametrize("method,guided", [("resampling", False),
                                           ("resampling", True),
                                           ("nds", True), ("nds+", True)])
def test_heterogeneous_routes(cloud, method, guided):
    """Delta tracking (no lane guided), resampling, NDS and NDS+ (TrBuffer
    at 0.6) on the grid cloud."""
    lanes = _lanes(2)
    if not guided:
        lanes["guide"][:] = False
    t, j = _run(cloud, jvspg.VSPGOptions(sampling_method=method), lanes,
                tr_prev=0.6 if method == "nds+" else None)
    _check(t, j, f"{method} guided={guided}")
    assert 0 < t[:, 9].mean() < 1


def synthetic_guiding(seed, res=4, film_res=(8, 8)):
    """A JAX field trained on one synthetic batch of numpy-seeded samples
    and a ready JAX ISGB fed two waves of synthetic pixel samples, and the
    port's copies of both."""
    rng = np.random.default_rng(seed)
    jf = jfield.GuidingField.make((-1.1,) * 3, (1.1,) * 3, res=res,
                                  n_lobes=8)
    n = 512 * res ** 3 // 8
    batch = jfield.TrainBatch(
        pos=jnp.asarray(rng.uniform(-1, 1, (n, 3)), jnp.float32),
        wi=jnp.asarray(_unit(rng, n)), weight=jnp.asarray(
            rng.uniform(0.1, 2.0, n), jnp.float32),
        radiance=jnp.asarray(rng.uniform(0, 1, (n, 3)), jnp.float32),
        distance=jnp.asarray(rng.uniform(0.1, 2, n), jnp.float32),
        is_volume=jnp.asarray(rng.uniform(size=n) < 0.5),
        c_vol=jnp.asarray(rng.uniform(0, 1, n), jnp.float32),
        c_surf=jnp.asarray(rng.uniform(0, 1, n), jnp.float32),
        valid=jnp.ones(n, bool))
    jf = jfield.field_update(jf, batch)
    ji = jisgb.ISGB.make(film_res, "variance", "atrous")
    P = film_res[0] * film_res[1]
    pid = jnp.arange(P, dtype=jnp.int32)
    for w in range(2):
        ji = jisgb.isgb_add_samples(
            ji, pid, jnp.asarray(rng.uniform(0, 1, (P, 3)), jnp.float32),
            jnp.full((P, 3), 0.5), jnp.asarray(_unit(rng, P)),
            jnp.asarray(rng.uniform(size=P) < 0.6), pid >= 0, half=w)
    ji = jisgb.isgb_update(ji)
    return jf, ji, convert.field_from_jax(jf, "cpu"), \
        convert.isgb_from_jax(ji, "cpu")


def test_lookup_vsp_and_rr_survival():
    """lookup_vsp on a trained field and a ready ISGB (primary and
    secondary lanes, volume and surface halves), and both RR survivals."""
    jf, ji, tf, ti = synthetic_guiding(3)
    rng = np.random.default_rng(4)
    P = 64
    o = rng.uniform(-1, 1, (R, 3)).astype(np.float32)
    d = _unit(rng, R)
    depth = rng.integers(0, 3, R).astype(np.int32)
    pix = rng.integers(0, P, R).astype(np.int32)
    last_vol = rng.uniform(size=R) < 0.5
    for crit in ("variance", "contribution"):
        vopt = jvspg.VSPGOptions(vsp_criterion=crit)
        tv = convert.options_from_jax(GOPT, vopt)[1]
        jg, jvsp = jvspg.lookup_vsp(
            vopt, jf, ji, SimpleNamespace(o=jnp.asarray(o), d=jnp.asarray(d),
                                          depth=jnp.asarray(depth)),
            jnp.asarray(pix), jnp.asarray(last_vol))
        tg, tvsp = tvspg.lookup_vsp(
            tv, tf, ti, SimpleNamespace(o=torch.as_tensor(o),
                                        d=torch.as_tensor(d),
                                        depth=torch.as_tensor(depth)),
            torch.as_tensor(pix).long(), torch.as_tensor(last_vol))
        assert np.asarray(jg).mean() > 0.5
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        assert lanes_close(tvsp.numpy()[:, None],
                           np.asarray(jvsp)[:, None]) >= 0.99
    b = rng.uniform(0, 2, (R, 3)).astype(np.float32)
    adj = rng.uniform(0, 2, (R, 3)).astype(np.float32)
    pe = rng.uniform(0, 1, (R, 3)).astype(np.float32)
    ru = rng.uniform(0.5, 2, (R, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tvspg.guided_rr_survival(*map(torch.as_tensor, (b, adj, pe))).numpy(),
        np.asarray(jvspg.guided_rr_survival(*map(jnp.asarray,
                                                  (b, adj, pe)))),
        rtol=1e-6)
    np.testing.assert_allclose(
        tvspg.throughput_rr_survival(torch.as_tensor(b),
                                     torch.as_tensor(ru)).numpy(),
        np.asarray(jvspg.throughput_rr_survival(jnp.asarray(b),
                                                jnp.asarray(ru))),
        rtol=1e-6)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)
