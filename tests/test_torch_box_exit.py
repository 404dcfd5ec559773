"""Walks that start within 1e-4 of the medium box's exit (ROADMAP.md
section C 4). ``box_hit`` (``csrc/common.cuh``; the Pallas kernels'
``_box_hit``) reports no face nearer than 1e-4, while the XLA path clips
every walk to the grid's bounds with no epsilon (``media.seg_init``'s t1),
so there such a walk ends at once. The VSPG kernel and its plain versions
end it at the exit (``box_exit``; ``volpath_kernels._box_exit``).

The thin slab is a grid medium 1.5e-4 deep along the camera axis: the
entry nudge of 1e-4 leaves every crossing lane in the box, 0.5e-4 from the
exit. Under an environment light its pixels are about env x Tr. With a
limit of BIG the walks stepped through the clamped majorant cells beyond
the box to the pixel's iteration cap, leaving every crossing lane capped
and its pixel black. Tolerance of the image checks: the mean of the
per-pixel differences from the JAX XLA render (another random stream)
within 4 of their standard errors, plus 1e-4 for pixels whose samples
hardly vary."""

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm as JFilm
from vspg_pbrt_v4_tpu.models.integrators import guided_volpath as jgv
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.models.materials import Materials as JMaterials
from vspg_pbrt_v4_tpu.models.media import GridMedium as JGrid
from vspg_pbrt_v4_tpu.models.media import Media as JMedia
from vspg_pbrt_v4_tpu.models.media import seg_init
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.guiding.isgb import ISGB
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

RES = 8
H = 0.75e-4  # half the slab's depth
ENV = (0.5, 0.6, 0.7)
CFG = jv.VolPathConfig(max_depth=8, max_events=4)
GOPT = jgv.GuidingOptions(field_res=4, record_depth=4, min_train_weight=16.0)
VOPT = jvspg.VSPGOptions(vsp_criterion="variance")


def _slab_medium():
    rng = np.random.default_rng(11)
    dens = rng.uniform(0.5, 1.5, (4, 4, 2)).astype(np.float32)
    return JGrid.make(dens, [40.0] * 3, [60.0] * 3, (-1, -1, -H), (1, 1, H),
                      g=0.0, maj_res=2)


@pytest.fixture(scope="module")
def slab():
    """The thin slab under a constant environment, and its JAX XLA render
    (volpath: with an untrained field and ISGB the VSPG estimator is delta
    tracking's, so both render the same expectation)."""
    geom = JGeometry.build(boxes=[dict(bmin=(-1, -1, -H), bmax=(1, 1, H),
                                       mat=-1, light=-1, med_in=0,
                                       med_out=-1)])
    scene = jv.Scene(geom, JMaterials.build([]),
                     JMedia.make(grids=(_slab_medium(),)),
                     JLights.make(env_L=list(ENV), world_radius=100.0))
    cam = PerspectiveCamera.make(jtr.look_at((0, 0, -4), (0, 0, 0),
                                             (0, 1, 0)), 20.0, (RES, RES))
    film = JFilm.make((RES, RES))
    ref = np.asarray(jv.render(scene, cam, film, spp=64, cfg=CFG, seed=3))
    return scene, cam, film, ref


def _inputs(slab, method):
    """The VSPG kernel's inputs on the slab: a fresh field and ISGB, with
    every primary ray guided (ISGB VSP 0.5), so that the guided walk of the
    `method` route starts at the exit."""
    scene, cam, film, _ = slab
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    tg, tv = convert.options_from_jax(GOPT, VOPT._replace(
        sampling_method=method))
    field = tvspg._scene_field(ts, tg, "cpu")
    isgb = ISGB.make(tf.resolution, tv.vsp_criterion, tv.denoiser,
                     device="cpu")
    c, g, ftab, itab = sk.kernel_inputs(ts, tc, tf, tcfg, tg, tv, field,
                                        isgb)
    itab[0] = 0.5
    return c, g, ftab, itab


def _assert_agrees(img, ref):
    diff = (np.asarray(img) - ref).mean(-1).reshape(-1)
    err = diff.std(ddof=1) / np.sqrt(diff.size)
    assert abs(diff.mean()) <= 4.0 * err + 1e-4, (diff.mean(), err)


@pytest.mark.parametrize("delta", [0.0, 0.5e-4, 1e-4, 2e-4])
def test_box_exit_matches_seg_init(delta):
    """The exit helper's plain twin against JAX seg_init's t1 (the walk's
    end) and miss for starts `delta` before the far face, on rays through
    the slab's z faces and through a unit box's side: the exit clamped at
    0, a miss exactly where it is 0. _box_hit reports no face below 1e-4."""
    dirs = np.array([[0.1, 0.2, 1.0], [-0.3, 0.1, 0.9], [0.05, -0.02, -1.0],
                     [1.0, 0.3, -0.2]], np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    faces = np.array([[0.2, -0.3, H], [0.4, 0.1, H], [-0.1, 0.5, -H],
                      [1.0, 0.2, 0.3]], np.float32)
    o = (faces - np.float32(delta) * dirs).astype(np.float32)
    unit = np.array([False, False, False, True])
    bmin = np.where(unit[:, None], -1.0, [-1.0, -1.0, -H]).astype(np.float32)
    bmax = np.where(unit[:, None], 1.0, [1.0, 1.0, H]).astype(np.float32)
    t1, miss, exit_t, hit = [], [], [], []
    for i in range(len(o)):
        gm = JGrid.make(np.ones((2, 2, 2), np.float32), [1.0] * 3,
                        [1.0] * 3, tuple(bmin[i]), tuple(bmax[i]), maj_res=2)
        it = seg_init(JMedia.make(grids=(gm,)), np.zeros(1, np.int32),
                      o[i:i + 1], dirs[i:i + 1], np.full(1, 1e3, np.float32),
                      np.ones(1, bool))
        t1.append(float(it.t_exit[0]))
        miss.append(bool(it.done[0]))
        ot, dt = torch.as_tensor(o[i:i + 1]), torch.as_tensor(dirs[i:i + 1])
        lo, hi = tuple(map(float, bmin[i])), tuple(map(float, bmax[i]))
        exit_t.append(float(vk._box_exit(ot, dt, lo, hi)[0]))
        hit.append(bool(vk._box_hit(ot, dt, lo, hi)[0][0]))
    t1, exit_t = np.array(t1, np.float32), np.array(exit_t, np.float32)
    np.testing.assert_allclose(exit_t, np.maximum(t1, 0.0), rtol=1e-5,
                               atol=1e-9)
    assert np.array_equal(np.array(miss), exit_t == 0.0), (miss, exit_t)
    assert all(miss) if delta == 0.0 else not any(miss)
    np.testing.assert_allclose(exit_t, delta, rtol=1e-2, atol=1e-7)
    if delta < 1e-4:
        assert not any(hit)
    if delta > 1e-4:
        assert all(hit)


@pytest.mark.parametrize("method", ["resampling", "nds"])
def test_thin_slab_render_plain(slab, method):
    """render_vspg_plain on the slab: every crossing lane starts its guided
    walk at the exit, none reaches the cap, no pixel is black, and the
    image agrees with the JAX XLA path's."""
    c, g, ftab, itab = _inputs(slab, method)
    counts = {}
    img = sk.render_vspg_plain(c, g, ftab, itab, 16, 5, counts).numpy()
    assert counts["capped"] == 0, counts
    assert np.isfinite(img).all() and (img.sum(-1) > 0).all()
    _assert_agrees(img, slab[3])
    assert counts["exit_walks"] >= RES * RES * 16, counts


def test_thin_slab_record_plain(slab):
    """train_wave_plain (the record variant's plain version) on the slab:
    no lane at the cap, every pixel lit, finite rows, and its image agrees
    with the JAX XLA path's; its CPU wrapper reports the same count."""
    c, g, ftab, itab = _inputs(slab, "resampling")
    counts = {}
    img, rec = sk.train_wave_plain(c, g, ftab, itab, 9, 4, counts)
    assert counts["capped"] == 0, counts
    assert bool(torch.isfinite(rec).all())
    assert bool((img.sum(-1) > 0).all())
    _assert_agrees(img.numpy(), slab[3])
    assert counts["exit_walks"] >= RES * RES, counts
    img_w, rec_w, cap = sk.train_wave_items(c, g, ftab, itab, 9, 4)
    assert torch.equal(img_w, img) and torch.equal(rec_w, rec)
    assert cap.tolist() == [0]


def test_thin_slab_grid_plain(slab):
    """B2a's plain version on the slab: its flights and shadow walks start
    at the exit too (counted), and its DDA clips them to the grid's bounds
    as the XLA path does, so it needed no fix: the image agrees with the
    JAX XLA path's."""
    scene, cam, film, ref = slab
    c = vk.extract_constants(*convert.from_jax(scene, cam, film, CFG, "cpu"))
    assert c.kind == "grid"
    counts = {}
    img = vk.render_grid_plain(c, 16, 5, counts).numpy()
    assert (img.sum(-1) > 0).all()
    _assert_agrees(img, ref)
    assert counts["exit_walks"] >= RES * RES * 16, counts
