"""The port's ``render_vspg`` (kernel route: record-variant training
waves, then the frozen render) against the JAX package's
``render_vspg(..., interpret_pallas=True)`` on the same scene and seed, and
the cases it refuses instead of taking another route."""

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.guiding.field import GuidingField
from vspg_pbrt_v4_tpu_torch.models.guiding.isgb import ISGB
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg
from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk

from test_torch_vspg_kernel import CFG, GOPT, QUADRANTS, VOPT, jax_setup

SPP, WAVES = 3, 2
# short paths keep the interpret-mode JAX run inside the file's minute
SHORT = jv.VolPathConfig(max_depth=8)


def test_render_vspg_matches_jax():
    """Same scene, seed and wave loop. The JAX kernel reads the trained
    field through a bf16 table and the port through a float32 one, so
    pixels whose paths meet a guided decision take other samples after
    training: most pixels agree exactly, the rest within Monte Carlo
    error."""
    scene, cam, film = jax_setup()
    gopt = GOPT._replace(train_waves=WAVES)
    ref, jfield, jisgb = jvspg.render_vspg(
        scene, cam, film, spp=SPP, cfg=SHORT, gopt=gopt, vopt=VOPT, seed=3,
        spp_per_pass=1, interpret_pallas=True)
    ref = np.asarray(ref)
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, SHORT, "cpu")
    tg, tv = convert.options_from_jax(gopt, VOPT)
    img, field, isgb = tvspg.render_vspg(ts, tc, tf, SPP, tcfg, tg, tv,
                                         seed=3, spp_per_pass=1,
                                         device="cpu")
    img = img.numpy()
    assert field.iteration == int(jfield.iteration) == WAVES
    assert isgb.ready and bool(jisgb.ready)
    assert np.isfinite(img).all()
    d = np.abs(img - ref)
    frac = ((d <= 1e-3 * np.abs(ref)) | (d <= 1e-5)).all(-1).mean()
    print(f"render_vspg: {frac:.4f} of pixels within 1e-3 of JAX")
    assert frac >= 0.8, frac
    # per quadrant, the mean pixel difference within four standard errors
    # of the pixel differences (the Monte Carlo error of two estimates)
    for sl in QUADRANTS:
        diff = (img[sl] - ref[sl]).mean(-1).reshape(-1)
        err = diff.std(ddof=1) / np.sqrt(diff.size)
        assert abs(diff.mean()) <= 4.0 * err + 1e-6, (diff.mean(), err)


def _refusal(case):
    """A call that only the XLA-style wave (not ported) could serve."""
    scene, cam, film = jax_setup()
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    tg, tv = convert.options_from_jax(GOPT, VOPT)
    kw = dict(spp=2, cfg=tcfg, gopt=tg, vopt=tv, device="cpu")
    if case == "nds":
        kw["vopt"] = tv._replace(sampling_method="nds")
    elif case == "nds+":
        kw["vopt"] = tv._replace(sampling_method="nds+")
    elif case == "spp_per_pass":
        kw["spp_per_pass"] = 2
    elif case == "fog box":
        ts = vk.make_fog_box_scene(device="cpu")
    elif case == "triangles":
        g = ts.geometry
        ts = type(ts)(Geometry(g.box_min, g.box_max, g.box_mat, g.box_light,
                               g.box_med_in, g.box_med_out, n_tri=12),
                      ts.materials, ts.media, ts.lights)
    elif case == "adaptive field":
        return lambda: GuidingField.make((-1,) * 3, (1,) * 3, res=4,
                                         n_extra=64, device="cpu")
    elif case == "unet":
        return lambda: ISGB.make((4, 4), "variance", "unet", device="cpu")
    return lambda: tvspg.render_vspg(ts, tc, tf, **kw)


@pytest.mark.parametrize("case", ["nds", "nds+", "spp_per_pass", "fog box",
                                  "triangles", "adaptive field", "unet"])
def test_unported_routes_raise(case):
    with pytest.raises(NotImplementedError):
        _refusal(case)()


def test_frozen_only_takes_the_render_kernel():
    """train=False renders every sample frozen: spp_per_pass > 1 is then no
    training wave and does not raise; the field stays untrained."""
    scene, cam, film = jax_setup()
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    tg, tv = convert.options_from_jax(GOPT, VOPT)
    img, field, isgb = tvspg.render_vspg(ts, tc, tf, 2, tcfg, tg, tv,
                                         spp_per_pass=2, train=False,
                                         device="cpu")
    assert field.iteration == 0 and not isgb.ready
    assert tuple(img.shape) == (16, 16, 3)
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
