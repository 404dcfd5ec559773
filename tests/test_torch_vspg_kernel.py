"""B3a/B4a, the VSPG kernel module: its plain versions against the Pallas
kernel run in interpret mode, as tests/test_pallas_vspg.py runs it, on a
16^3 cloud whose density (and so its max-pooled majorant) is bf16-exact,
so that the Pallas kernel's bf16 tables hold the same medium. Both run the
same per-lane machine on the same random stream, so they agree lane by
lane; a lane can still leave when a float32 comparison falls the other way
after a last-bit difference of a transcendental (the stated reason for
the fractions below)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm as JFilm
from vspg_pbrt_v4_tpu.models.guiding import field as jfield
from vspg_pbrt_v4_tpu.models.guiding import isgb as jisgb
from vspg_pbrt_v4_tpu.models.guiding import recording as jrec
from vspg_pbrt_v4_tpu.models.integrators import guided_volpath as jgv
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.models.materials import Materials as JMaterials
from vspg_pbrt_v4_tpu.models.media import GridMedium as JGrid
from vspg_pbrt_v4_tpu.models.media import Media as JMedia
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.ops import pallas_vspg as jpk
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.guiding import isgb as tisgb
from vspg_pbrt_v4_tpu_torch.models.guiding import recording as trec
from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath as tgv
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

RES = 16
CFG = jv.VolPathConfig(max_depth=24)
GOPT = jgv.GuidingOptions(field_res=8, record_depth=6, min_train_weight=16.0)
VOPT = jvspg.VSPGOptions(vsp_criterion="variance")
QUADRANTS = (np.s_[:8, :8], np.s_[8:, 8:], np.s_[:8, 8:], np.s_[8:, :8])


def bf16_cloud(n=16, scale=3.0):
    """The cloud of tests/test_pallas_vspg.py, rounded to bf16."""
    x = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    d = np.clip(1.0 - np.sqrt(X**2 + Y**2 + Z**2), 0, 1)
    d *= 0.75 + 0.25 * np.sin(5.1 * X) * np.sin(4.3 * Y + 1.0)
    d = np.clip(d, 0, None).astype(np.float32) * scale
    return (d.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def jax_setup(sa=(0.2, 0.25, 0.3), ss=(2.8, 2.5, 2.2), g=0.5,
              env=(0.1, 0.12, 0.14), point=((0.0, 0.3, 2.5), (40.0,) * 3)):
    """JAX scene, camera and film: the lit cloud (per-channel sigma, so
    the hero-channel tail ratios are exercised)."""
    gm = JGrid.make(bf16_cloud(), list(sa), list(ss), (-1, -1, -1),
                    (1, 1, 1), g=g, maj_res=8)
    lights = JLights.make(point_p=None if point is None else [point[0]],
                          point_I=None if point is None else [point[1]],
                          env_L=list(env), world_radius=100.0)
    geom = JGeometry.build(boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1),
                                       mat=-1, light=-1, med_in=0,
                                       med_out=-1)])
    scene = jv.Scene(geom, JMaterials.build([]), JMedia.make(grids=(gm,)),
                     lights)
    cam = PerspectiveCamera.make(jtr.look_at((0, 0, -4), (0, 0, 0),
                                             (0, 1, 0)), 30.0, (RES, RES))
    return scene, cam, JFilm.make((RES, RES))


def port_inputs(scene, cam, film, field, isgb, cfg=CFG, gopt=GOPT,
                vopt=VOPT):
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, cfg, "cpu")
    tg, tv = convert.options_from_jax(gopt, vopt)
    return sk.kernel_inputs(ts, tc, tf, tcfg, tg, tv,
                            convert.field_from_jax(field, "cpu"),
                            convert.isgb_from_jax(isgb, "cpu"))


def lanes_close(t, j, rtol=1e-4, atol=1e-6):
    """Fraction of lanes (rows) whose every entry agrees."""
    t = np.asarray(t).reshape(len(t), -1)
    j = np.asarray(j).reshape(t.shape)
    d = np.abs(t - j)
    return ((d <= rtol * np.abs(j)) | (d <= atol)).all(-1).mean()


def bf16_table(ftab):
    """The field table rounded as pallas_vspg.pack_kernel_inputs rounds it
    (add 0x8000, keep the high 16 bits), so that the port reads the
    parameters the Pallas kernel reads."""
    u = ftab.numpy().view(np.uint32).astype(np.uint64)
    r = ((np.minimum(u + 0x8000, 0xFFFFFFFF) >> 16) << 16).astype(np.uint32)
    return torch.as_tensor(r.view(np.float32))


def wave_rows(img, seg, first_alb, first_nrm, first_vol):
    """One float32 row per lane: a training wave's image and every record
    row (port tensors or JAX arrays alike)."""
    npix = RES * RES
    parts = ([img, first_alb, first_nrm, np.asarray(first_vol)[:, None]]
             + [getattr(seg, f) for f in ("pos", "wi", "scatter_w", "direct",
                                           "emission", "pdf", "distance",
                                           "is_volume", "valid")])
    return np.concatenate([np.asarray(p).reshape(npix, -1).astype(np.float32)
                           for p in parts], -1)


def exit_lanes(counts):
    """The walks and shadow walks of a plain run that start within 1e-4 of
    the box's exit: the port ends them there and the Pallas kernel steps
    on (ROADMAP.md section C 4, kept on purpose). The lane-for-lane checks
    below meet none, so their bars cover no such lane."""
    return counts.get("exit_walks", 0) + counts.get("exit_shadows", 0)


def check_record_wave(wave_j, inputs, seed, depth):
    """train_wave_plain against a train_wave_pallas(interpret=True) result
    `wave_j` on the same inputs: the image and every record row of each
    lane, and the raw radiance; no lane starts at the box's exit."""
    img_j, seg_j, fa_j, fn_j, fv_j, L_j, _ = wave_j
    c, g, ftab, itab = inputs
    counts = {}
    img, rec = sk.train_wave_plain(c, g, ftab, itab, seed, depth, counts)
    assert exit_lanes(counts) == 0, counts
    seg, fa, fn, fv = sk.records_to_segments(rec)
    assert bool(seg.valid.any())
    frac = lanes_close(wave_rows(img, seg, fa, fn, fv),
                       wave_rows(img_j, seg_j, fa_j, fn_j, fv_j))
    print(f"record wave: {frac:.4f} of lanes equal within 1e-4")
    assert frac >= 0.95, frac
    np.testing.assert_allclose(
        (img.reshape(-1, 3) / c.imaging_ratio).numpy(), np.asarray(L_j),
        rtol=1e-4, atol=1e-6)


def check_render(trained, gopt):
    """render_vspg_plain against render_vspg_pallas(interpret=True) at 2
    spp on the JAX-trained field, the port fed the bf16-rounded table; no
    lane starts at the box's exit."""
    scene, cam, film, field, isgb = trained
    ref = np.asarray(jpk.render_vspg_pallas(scene, cam, film, 2, CFG, gopt,
                                            VOPT, field, isgb, seed=9,
                                            interpret=True))
    c, g, ftab, itab = port_inputs(scene, cam, film, field, isgb, gopt=gopt)
    assert g.ris == (gopt.mode == "ris")
    counts = {}
    img = sk.render_vspg_plain(c, g, bf16_table(ftab), itab, 2, 9,
                               counts).numpy()
    assert exit_lanes(counts) == 0, counts
    d = np.abs(img - ref)
    frac = ((d <= 1e-3 * np.abs(ref)) | (d <= 1e-5)).all(-1).mean()
    print(f"render ({gopt.mode}): {frac:.4f} of pixels within 1e-3")
    assert frac >= 0.95, frac
    # Monte Carlo bound of tests/test_pallas_vspg.py for the quadrants
    for sl in QUADRANTS:
        a, b = ref[sl].mean(), img[sl].mean()
        assert abs(a - b) < 0.08 * max(a, 0.05), (a, b)


@pytest.fixture(scope="module")
def wave():
    """One JAX training wave (interpret mode) on a fresh field."""
    scene, cam, film = jax_setup()
    field = jfield.GuidingField.make((-1.1,) * 3, (1.1,) * 3, res=8,
                                     n_lobes=8)
    isgb = jisgb.ISGB.make((RES, RES), "variance", "atrous")
    out = jpk.train_wave_pallas(scene, cam, film, CFG, GOPT, VOPT, field,
                                isgb, seed=jnp.uint32(1), interpret=True)
    return scene, cam, film, field, isgb, out


def test_record_wave_matches_pallas(wave):
    """train_wave_plain against train_wave_pallas(interpret=True): the
    image and every record row of each lane."""
    scene, cam, film, field, isgb, out = wave
    check_record_wave(out, port_inputs(scene, cam, film, field, isgb), 1,
                      GOPT.record_depth)


@pytest.fixture(scope="module")
def trained(wave):
    """The wave's records train the JAX field and fill its ISGB."""
    scene, cam, film, field, isgb, (_, seg, fa, fn, fv, L, _) = wave
    pid = jnp.arange(RES * RES, dtype=jnp.int32)
    isgb = jisgb.isgb_update(jisgb.isgb_add_samples(isgb, pid, L, fa, fn, fv,
                                                    pid >= 0, half=0))
    field = jgv.train_step(field, jrec.propagate(seg))
    assert int(field.iteration) == 1 and bool(isgb.ready)
    assert (np.asarray(field.volume.stats_w).sum(-1) > 8.0).any()
    return scene, cam, film, field, isgb


def test_render_matches_pallas(trained):
    """render_vspg_plain against render_vspg_pallas(interpret=True) on the
    JAX-trained field. The port is fed the field table rounded to bf16 as
    pallas_vspg.pack_kernel_inputs rounds it, so both read the same
    parameters."""
    check_render(trained, GOPT)


def test_furnace_trained_plain():
    """Scattering furnace (albedo 1, env 0.7) with a field trained by the
    port's own record waves: the guided routes (VSP resampling, RIS, guided
    RR) must integrate back to the environment, here within 5% at 16^2 x 8
    spp. The wrapper serves CPU tensors with the plain version and
    launches nothing."""
    scene, cam, film = jax_setup(sa=(0.0,) * 3, ss=(2.0,) * 3, g=0.3,
                                 env=(0.7,) * 3, point=None)
    cfg = jv.VolPathConfig(max_depth=64, max_events=256)
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, cfg, "cpu")
    tg, tv = convert.options_from_jax(GOPT, VOPT)
    from vspg_pbrt_v4_tpu_torch.models.guiding.field import GuidingField

    field = GuidingField.make((-1.1,) * 3, (1.1,) * 3, res=8, device="cpu")
    isgb = tisgb.ISGB.make((RES, RES), "variance", device="cpu")
    pid = torch.arange(RES * RES)
    before = dict(sk.LAUNCHES)
    for w in range(2):
        img, seg, fa, fn, fv, L = sk.train_wave(ts, tc, tf, tcfg, tg, tv,
                                                field, isgb, seed=w + 1)
        isgb = tisgb.isgb_update(tisgb.isgb_add_samples(
            isgb, pid, L, fa, fn, fv, pid >= 0, half=w % 2))
        field = tgv.train_step(field, trec.propagate(seg))
    img = sk.render_vspg_kernel(*sk.kernel_inputs(
        ts, tc, tf, tcfg, tg, tv, field, isgb), 8, 5).numpy()
    assert sk.LAUNCHES == before
    assert np.isfinite(img).all()
    assert abs(img.mean() - 0.7) < 0.05 * 0.7, img.mean()
