"""The port's ``render_vspg`` (kernel route: record-variant training
waves, then the frozen render) against the JAX package's
``render_vspg(..., interpret_pallas=True)`` on the same scene and seed, the
routes it takes, and the cases outside the port's scope that it
refuses."""

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg
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


def _mesh_tris():
    """65 triangles in the cloud: one more than brute force serves."""
    return [dict(p0=(0.1 * i - 0.5, 0, 0), p1=(0.1 * i - 0.4, 0, 0),
                 p2=(0.1 * i - 0.5, 0.1, 0), mat=0) for i in range(65)]


def _box(ts):
    g = ts.geometry
    return dict(bmin=g.box_min[0].tolist(), bmax=g.box_max[0].tolist(),
                mat=-1, light=-1, med_in=0, med_out=-1)


def _refusal(case):
    """A call outside the port's scope."""
    scene, cam, film = jax_setup()
    ts = convert.from_jax(scene, cam, film, CFG, "cpu")[0]
    if case == "kd-tree":
        # the mesh class under a kd-tree (Accelerator "kdtree"): only the
        # BVH is ported
        from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry

        jg = JGeometry.build(triangles=_mesh_tris(), boxes=[_box(ts)],
                             accelerator="kdtree")
        return lambda: convert.from_jax(scene._replace(geometry=jg), cam,
                                        film, CFG, "cpu")
    # the U-Net ISGB denoiser is ported; spectral mode, with it, is not
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    tg, tv = convert.options_from_jax(GOPT, VOPT._replace(denoiser="unet"))
    return lambda: tvspg.render_vspg(ts, tc, tf, spp=1,
                                     cfg=tcfg._replace(spectral=True),
                                     gopt=tg, vopt=tv, device="cpu")


@pytest.mark.parametrize("case", ["kd-tree", "unet"])
def test_unported_routes_raise(case):
    with pytest.raises(NotImplementedError):
        _refusal(case)()


# case: (sampling method, spp_per_pass, scene) and the route the JAX
# package takes: (record-kernel waves, torch waves, frozen-kernel renders);
# "adaptive" is the cloud with an adaptive field (res 4, 128 extra leaves)
WAVE_ROUTES = {
    "nds": (("nds", 1, "cloud"), (1, 0, 1)),
    "adaptive": (("resampling", 1, "adaptive"), (1, 0, 1)),
    "nds+": (("nds+", 1, "cloud"), (0, 1, 1)),
    "spp_per_pass": (("resampling", 2, "cloud"), (0, 1, 1)),
    "fog box": (("resampling", 1, "fog"), (0, 4, 0)),
}


@pytest.mark.parametrize("case", list(WAVE_ROUTES))
def test_wave_routes_render(case, monkeypatch):
    """Calls that once raised now render, each by the JAX package's route:
    NDS and the adaptive field train through the record kernel; NDS+ and
    spp_per_pass > 1 train through the torch wave; all freeze into the
    render kernel (NDS+ with its TrBuffer); the fog box, outside the
    kernel's class, takes the torch wave for every sample."""
    (method, per_pass, which), want = WAVE_ROUTES[case]
    calls = {"train_wave": 0, "vspg_wave": 0, "render_frozen": []}

    def spy(name, fn):
        def wrapped(*a, **kw):
            if name == "render_frozen":
                calls[name].append(kw.get("tr_buffer"))
            else:
                calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tvspg.vk, "train_wave",
                        spy("train_wave", tvspg.vk.train_wave))
    monkeypatch.setattr(tvspg.vk, "render_frozen",
                        spy("render_frozen", tvspg.vk.render_frozen))
    monkeypatch.setattr(tvspg, "vspg_wave",
                        spy("vspg_wave", tvspg.vspg_wave))
    scene, cam, film = jax_setup()
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, SHORT, "cpu")
    if which == "fog":
        ts = vk.make_fog_box_scene(device="cpu")
    gopt = GOPT._replace(train_waves=1)
    if which == "adaptive":
        gopt = gopt._replace(field_res=4, adaptive_extra=128,
                             refine_threshold=16.0)
    tg, tv = convert.options_from_jax(gopt,
                                      VOPT._replace(sampling_method=method))
    img, field, isgb = tvspg.render_vspg(ts, tc, tf, 2 * per_pass + 2, tcfg,
                                         tg, tv, seed=4,
                                         spp_per_pass=per_pass, device="cpu")
    assert tuple(img.shape) == (16, 16, 3)
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
    assert field.iteration == 1 and isgb.ready
    assert field.n_extra == (128 if which == "adaptive" else 0)
    got = (calls["train_wave"], calls["vspg_wave"],
           len(calls["render_frozen"]))
    assert got == want, (case, got)
    for tr in calls["render_frozen"]:
        # NDS+ hands the frozen kernel the waves' TrBuffer (all ones here:
        # the one training wave ran before the ISGB guided a primary ray)
        assert (tr is not None) == (method == "nds+")
        if tr is not None:
            assert tuple(tr.shape) == (256, 3)
            assert bool(((tr >= 0) & (tr <= 1)).all())


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
