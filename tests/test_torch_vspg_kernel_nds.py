"""B3b/B4b, the NDS and NDS+ routes of the VSPG kernel module: the plain
versions against the Pallas kernel run in interpret mode on the bf16-exact
16^3 cloud of tests/test_torch_vspg_kernel.py, the field trained by one
JAX record wave under NDS and read through its bf16 table, NDS+ with a
TrBuffer of 0.6. The thresholds are that file's: a lane can leave the
shared random stream when a float32 comparison falls the other way after
a last-bit difference of a transcendental."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.guiding import field as jfield
from vspg_pbrt_v4_tpu.models.guiding import isgb as jisgb
from vspg_pbrt_v4_tpu.models.guiding import recording as jrec
from vspg_pbrt_v4_tpu.models.integrators import guided_volpath as jgv
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.ops import pallas_vspg as jpk
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.guiding import isgb as tisgb
from vspg_pbrt_v4_tpu_torch.models.guiding import recording as trec
from vspg_pbrt_v4_tpu_torch.models.guiding.field import GuidingField
from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath as tgv
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

from test_torch_vspg_kernel import (CFG, GOPT, QUADRANTS, RES, VOPT,
                                    bf16_table, check_record_wave, jax_setup,
                                    port_inputs)

NDS = VOPT._replace(sampling_method="nds")
NDS_PLUS = VOPT._replace(sampling_method="nds+")
TR = 0.6  # the NDS+ TrBuffer: a nontrivial bias exponent 1/1.6


@pytest.fixture(scope="module")
def trained():
    """One JAX NDS record wave (interpret mode) on a fresh field, which
    then trains the field and fills the ISGB."""
    scene, cam, film = jax_setup()
    field = jfield.GuidingField.make((-1.1,) * 3, (1.1,) * 3, res=8,
                                     n_lobes=8)
    isgb = jisgb.ISGB.make((RES, RES), "variance", "atrous")
    out = jpk.train_wave_pallas(scene, cam, film, CFG, GOPT, NDS, field,
                                isgb, seed=jnp.uint32(1), interpret=True)
    _, seg, fa, fn, fv, L, _ = out
    pid = jnp.arange(RES * RES, dtype=jnp.int32)
    isgb2 = jisgb.isgb_update(jisgb.isgb_add_samples(
        isgb, pid, L, fa, fn, fv, pid >= 0, half=0))
    field2 = jgv.train_step(field, jrec.propagate(seg))
    assert int(field2.iteration) == 1 and bool(isgb2.ready)
    return scene, cam, film, (field, isgb, out), (field2, isgb2)


def test_record_wave_nds_matches_pallas(trained):
    """train_wave_plain under NDS against train_wave_pallas: the image and
    every record row of each lane."""
    scene, cam, film, (field, isgb, out), _ = trained
    inputs = port_inputs(scene, cam, film, field, isgb, vopt=NDS)
    assert inputs[1].method == sk.METHODS.index("nds")
    check_record_wave(out, inputs, 1, GOPT.record_depth)


def test_record_wave_nds_plus_matches_pallas(trained):
    """Under NDS+ the record variant reads a TrBuffer of ones, on both
    sides: on the trained field, where primary lanes take the ODS walk."""
    scene, cam, film, _, (field, isgb) = trained
    out = jpk.train_wave_pallas(scene, cam, film, CFG, GOPT, NDS_PLUS, field,
                                isgb, seed=jnp.uint32(4), interpret=True)
    c, g, ftab, itab = port_inputs(scene, cam, film, field, isgb,
                                   vopt=NDS_PLUS)
    assert tuple(itab.shape) == (6, RES * RES)
    assert bool((itab[3:] == 1.0).all())
    check_record_wave(out, (c, g, bf16_table(ftab), itab), 4,
                      GOPT.record_depth)


@pytest.mark.parametrize("vopt", [NDS, NDS_PLUS], ids=["nds", "nds+"])
def test_render_matches_pallas(trained, vopt):
    """render_vspg_plain against render_vspg_pallas(interpret=True) at 2
    spp on the trained field (the port fed the bf16-rounded table), NDS+
    with the TrBuffer at 0.6."""
    scene, cam, film, _, (field, isgb) = trained
    plus = vopt.sampling_method == "nds+"
    tr = jnp.full((RES * RES, 3), TR) if plus else None
    ref = np.asarray(jpk.render_vspg_pallas(scene, cam, film, 2, CFG, GOPT,
                                            vopt, field, isgb, seed=9,
                                            interpret=True, tr_buffer=tr))
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    tg, tv = convert.options_from_jax(GOPT, vopt)
    c, g, ftab, itab = sk.kernel_inputs(
        ts, tc, tf, tcfg, tg, tv, convert.field_from_jax(field, "cpu"),
        convert.isgb_from_jax(isgb, "cpu"),
        torch.full((RES * RES, 3), TR) if plus else None)
    assert tuple(itab.shape) == ((6 if plus else 3), RES * RES)
    counts = {}
    img = sk.render_vspg_plain(c, g, bf16_table(ftab), itab, 2, 9,
                               counts).numpy()
    # the guided walks ran the prepass and drew ODS candidates
    assert counts["pre_steps"] > 0 and counts["draws"] > 0, counts
    d = np.abs(img - ref)
    frac = ((d <= 1e-3 * np.abs(ref)) | (d <= 1e-5)).all(-1).mean()
    print(f"render ({vopt.sampling_method}): {frac:.4f} of pixels within "
          "1e-3")
    assert frac >= 0.95, frac
    for sl in QUADRANTS:
        a, b = ref[sl].mean(), img[sl].mean()
        assert abs(a - b) < 0.08 * max(a, 0.05), (a, b)


def test_itab_rows_checked(trained):
    """The plain versions take exactly the ISGB rows of their route."""
    scene, cam, film, _, (field, isgb) = trained
    c, g, ftab, itab = port_inputs(scene, cam, film, field, isgb,
                                   vopt=NDS_PLUS)
    with pytest.raises(ValueError):
        sk.render_vspg_plain(c, g, ftab, itab[:3].contiguous(), 1, 0)


def test_nds_furnace_trained_plain():
    """Scattering furnace (albedo 1, env 0.7) under NDS with a field
    trained by the port's own NDS record waves: the truncated-exponential
    bookkeeping, the one-sample MIS factor and the defensive lanes must
    integrate back to the environment, within 5% at 16^2 x 8 spp."""
    scene, cam, film = jax_setup(sa=(0.0,) * 3, ss=(2.0,) * 3, g=0.3,
                                 env=(0.7,) * 3, point=None)
    cfg = jv.VolPathConfig(max_depth=64, max_events=256)
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, cfg, "cpu")
    tg, tv = convert.options_from_jax(GOPT, NDS)
    field = GuidingField.make((-1.1,) * 3, (1.1,) * 3, res=8, device="cpu")
    isgb = tisgb.ISGB.make((RES, RES), "variance", device="cpu")
    pid = torch.arange(RES * RES)
    for w in range(2):
        img, seg, fa, fn, fv, L = sk.train_wave(ts, tc, tf, tcfg, tg, tv,
                                                field, isgb, seed=w + 1)
        isgb = tisgb.isgb_update(tisgb.isgb_add_samples(
            isgb, pid, L, fa, fn, fv, pid >= 0, half=w % 2))
        field = tgv.train_step(field, trec.propagate(seg))
    counts = {}
    img = sk.render_vspg_plain(*sk.kernel_inputs(
        ts, tc, tf, tcfg, tg, tv, field, isgb), 8, 5, counts).numpy()
    assert counts["pre_steps"] > 0, counts
    assert np.isfinite(img).all()
    assert abs(img.mean() - 0.7) < 0.05 * 0.7, img.mean()


@pytest.mark.parametrize("method", ["resampling", "nds", "nds+"])
def test_guiding_constants_carry_method(method):
    """GI_METHOD holds the route; NDS+ alone takes six ISGB rows."""
    scene, cam, film = jax_setup()
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    tg, tv = convert.options_from_jax(GOPT,
                                      VOPT._replace(sampling_method=method))
    field = GuidingField.make((-1.1,) * 3, (1.1,) * 3, res=8, device="cpu")
    isgb = tisgb.ISGB.make((RES, RES), "variance", device="cpu")
    assert sk.supports(ts, tc, tf, tcfg, tg, tv, field)
    c, g, ftab, itab = sk.kernel_inputs(ts, tc, tf, tcfg, tg, tv, field, isgb)
    assert int(g.iconst[sk.GI_METHOD]) == g.method == sk.METHODS.index(method)
    assert itab.shape[0] == g.isgb_rows == (6 if method == "nds+" else 3)
