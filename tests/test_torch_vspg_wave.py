"""The torch VSPG wave against the JAX package's XLA wave (``vspg_wave``)
on the same scene, seed, field and ISGB (two JAX wave compiles: the
resampling and the NDS+ training wave), and the segment recorders. Both
sides run the same lockstep wavefront on the same random stream, so lanes
agree until a float32 comparison falls the other way after a last-bit
difference (the 0.95 fractions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.guiding import recording as jrec
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.guiding import recording as trec
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg

from test_torch_vspg_distance import synthetic_guiding
from test_torch_vspg_kernel import GOPT, RES, jax_setup, lanes_close

CFG = jv.VolPathConfig(max_depth=8)
GOPT2 = GOPT._replace(train_waves=2)
SPP_PER_PASS = 2


def _tr_buffer():
    """A TrBuffer that varies per pixel in [0.3, 1]."""
    rng = np.random.default_rng(11)
    return rng.uniform(0.3, 1.0, (RES * RES, 3)).astype(np.float32)


def _isgb_rows(isgb):
    return np.concatenate([np.asarray(getattr(isgb, f), np.float32).reshape(
        RES * RES, -1) for f in ("contrib_sum", "albedo_sum", "normal_sum",
                                 "n", "c_vol", "c_vol2", "c_surf",
                                 "c_surf2")], -1)


def _batch_rows(b):
    return np.concatenate([np.asarray(getattr(b, f), np.float32).reshape(
        len(np.asarray(b.weight)), -1) for f in b._fields], -1)


@pytest.mark.parametrize("method", ["resampling", "nds+"])
def test_wave_matches_jax(method):
    """One training wave of 2 spp per pixel on a trained field and a ready
    ISGB: the film image, the ISGB sums, the propagated training batch and
    the primary transmittance estimates."""
    scene, cam, film = jax_setup()
    jf, ji, tf, ti = synthetic_guiding(5, res=GOPT.field_res,
                                       film_res=(RES, RES))
    vopt = jvspg.VSPGOptions(sampling_method=method)
    tr = _tr_buffer() if method == "nds+" else None
    fs_j, ji2, batch_j, tr_j = jvspg.vspg_wave(
        scene, cam, film, film.init_state(), jf, ji, CFG, GOPT2, vopt,
        jnp.uint32(3), jnp.int32(1), -1, True, SPP_PER_PASS,
        None if tr is None else jnp.asarray(tr))
    ts, tc, tfilm, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    tg, tv = convert.options_from_jax(GOPT2, vopt)
    fs_t, ti2, batch_t, tr_t = tvspg.vspg_wave(
        ts, tc, tfilm, tfilm.init_state(), tf, ti, tcfg, tg, tv, 3, 1, -1,
        True, SPP_PER_PASS, None if tr is None else torch.as_tensor(tr))
    img_j = np.asarray(film.image(fs_j)).reshape(RES * RES, 3)
    img_t = tfilm.image(fs_t).numpy().reshape(RES * RES, 3)
    assert img_t.mean() > 0
    checks = {"image": (img_t, img_j),
              "isgb": (_isgb_rows(ti2), _isgb_rows(ji2)),
              "batch": (_batch_rows(batch_t), _batch_rows(batch_j)),
              "tr": (tr_t.numpy(), np.asarray(tr_j))}
    assert bool(batch_t.valid.any())
    for name, (t, j) in checks.items():
        frac = lanes_close(t, j)
        print(f"{method} wave {name}: {frac:.4f} of lanes within 1e-4")
        assert frac >= 0.95, (name, frac)
    # the primary transmittance estimates are real, not the initial ones
    assert (tr_t.numpy() < 1.0).any()


def test_record_helpers_match_jax():
    """record_vertex, record_direct, record_emission and
    record_edge_distance on numpy-seeded lanes, slots filling past the
    record depth."""
    rng = np.random.default_rng(2)
    R, D = 64, 3
    jr = jrec.SegmentRecord.make(R, D, jnp.zeros(R))
    tr = trec.SegmentRecord.make(R, D, device="cpu")

    def both(fn_j, fn_t, *args):
        return (fn_j(jr, *(jnp.asarray(a) for a in args)),
                fn_t(tr, *(torch.as_tensor(a) for a in args)))

    for step in range(5):
        m = rng.uniform(size=R) < 0.7
        pos = rng.uniform(-1, 1, (R, 3)).astype(np.float32)
        wi = rng.uniform(-1, 1, (R, 3)).astype(np.float32)
        sw = rng.uniform(0, 2, (R, 3)).astype(np.float32)
        pdf = rng.uniform(0.1, 1, R).astype(np.float32)
        vol = rng.uniform(size=R) < 0.5
        jr, tr = both(jrec.record_vertex, trec.record_vertex, m, pos, wi, sw,
                      pdf, vol)
        c = rng.uniform(0, 1, (R, 3)).astype(np.float32)
        jr, tr = both(jrec.record_direct, trec.record_direct,
                      rng.uniform(size=R) < 0.5, c)
        dist = rng.uniform(0, 3, R).astype(np.float32)
        jr, tr = both(jrec.record_emission, trec.record_emission,
                      rng.uniform(size=R) < 0.5, c, dist)
        if step == 2:
            jr, tr = both(jrec.record_edge_distance,
                          trec.record_edge_distance,
                          rng.uniform(size=R) < 0.5, dist)
    assert int(tr.count.max()) == D
    for f in jr._fields:
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
