"""The RGB grid and the earth medium: the port's ``RGBGridMedium`` and
``EarthMedium`` against the JAX package's (majorants bit for bit;
``sample_point``, ``seg_init`` and ``seg_next`` on seeded rays; the earth's
density profile and cloud shell), ``volpath.render`` of each in a box
pixel for pixel with JAX's XLA render at 32^2 (the earth's in
``test_torch_media_ext_render.py``), an earth furnace, and both packages'
kernel predicates refusing each. One torch VSPG wave on the RGB grid
against JAX's ``vspg_wave`` is in ``test_torch_media_ext_wave.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import media as jm
from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm as JFilm
from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.models.materials import Materials as JMaterials
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.ops import pallas_volpath as jpv
from vspg_pbrt_v4_tpu.ops import pallas_vspg as jpg
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models import media as tm
from vspg_pbrt_v4_tpu_torch.models.guiding.field import GuidingField
from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath as tgv
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as gk

from test_torch_vspg_kernel import bf16_cloud

RES = 32


def _rgb_args(n=16, emissive=True):
    """Per-channel sigma grids from the bf16 test cloud and, with
    `emissive`, an emission grid that varies per channel."""
    d = bf16_cloud(n)[..., None]
    sa = d * np.float32([0.2, 0.3, 0.5])
    ss = d * np.float32([2.5, 2.0, 1.5])
    le = None
    if emissive:
        x = np.linspace(0, 1, n, dtype=np.float32)
        le = np.stack(np.meshgrid(x, x[::-1], x * x, indexing="ij"), -1)
    return (sa, ss, (-1, -1, -1), (1, 1, 1)), dict(Le=le, Le_scale=1.5,
                                                  g=0.3, maj_res=4)


def _heightmap(h=16, w=32, seed=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (h, w)).astype(np.float32)


EARTH = dict(sigma_a_atm=(0.05, 0.1, 0.2), sigma_s_atm=(1.0, 1.5, 2.0),
             sigma_a_cloud=(0.1, 0.1, 0.1), sigma_s_cloud=(3.0, 3.0, 3.0),
             g=0.2, p0=(-1, -1, -1), p1=(1, 1, 1), center=(0.05, 0, 0),
             inner_r_atm=0.4, inner_r_cloud=0.5, outer_r_atm=0.95,
             outer_r_cloud=0.8, decay=0.2, density_offset=0.02,
             majorant_scale=1.1, rotation_y=30.0, scale_atm=0.8,
             scale_cloud=1.2)


def _earths():
    hm = _heightmap()
    return (jm.EarthMedium.make(**EARTH, heightmap=hm),
            tm.EarthMedium.make(**EARTH, heightmap=hm, device="cpu"))


@pytest.mark.parametrize("maj_res,scale", [(4, 1.0), (16, 1.5),
                                           ((3, 2, 5), 1.25)])
def test_rgb_grid_make_matches_jax(maj_res, scale):
    """RGBGridMedium.make: the per-channel majorant with its one-voxel
    halo, an uneven partition and majorant_scale, bit for bit; the
    emission grid, or (1,1,1,3) zeros without one."""
    args, kw = _rgb_args(12)
    kw.update(maj_res=maj_res, majorant_scale=scale)
    j = jm.RGBGridMedium.make(*args, **kw)
    t = tm.RGBGridMedium.make(*args, **kw, device="cpu")
    assert t.res == tuple(j.res) and t.maj_res == tuple(j.maj_res)
    for f in ("sigma_a_grid", "sigma_s_grid", "Le_grid", "Le_scale", "g",
              "b_min", "b_max", "majorant"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    kw["Le"] = None
    t0 = tm.RGBGridMedium.make(*args, **kw, device="cpu")
    assert t0.Le_grid.shape == (1, 1, 1, 3) and not t0.Le_grid.any()
    p = torch.as_tensor(np.random.default_rng(0).uniform(
        -1, 1, (64, 3)).astype(np.float32))
    assert not t0.le_at(p).any()


def _media():
    """JAX Media: a homogeneous medium, a density grid, the RGB grid, then
    the earth medium (ids 0, 1, 2, 3), and the port's copy."""
    args, kw = _rgb_args()
    dens = bf16_cloud(16)
    grid = jm.GridMedium.make(dens, [0.1] * 3, [1.0] * 3, (-1, -1, -1),
                              (1, 1, 1), maj_res=8)
    jmed = jm.Media.make([dict(sigma_a=(0.2,) * 3, sigma_s=(0.3,) * 3)],
                         grids=(grid, jm.RGBGridMedium.make(*args, **kw)),
                         procedurals=(_earths()[0],))
    tmed = convert._media(jmed, "cpu")
    assert isinstance(tmed.grids[1], tm.RGBGridMedium)
    assert isinstance(tmed.procedurals[0], tm.EarthMedium)
    return jmed, tmed


def _close(t, j, what):
    np.testing.assert_allclose(np.asarray(t, np.float64),
                               np.asarray(j, np.float64), rtol=1e-6,
                               atol=1e-7, err_msg=what)


@pytest.mark.parametrize("kind", ["rgb grid", "earth"])
def test_points_and_segments_match_jax(kind):
    """sample_point, seg_init and three seg_next steps on 4096 seeded rays,
    most lanes in the `kind` medium (the others vacuum, homogeneous, the
    density grid or an unknown id), within 1e-6 relative of JAX's."""
    jmed, tmed = _media()
    rng = np.random.default_rng(7)
    R = 4096
    main_id = 2 if kind == "rgb grid" else 3
    mid = np.where(rng.uniform(size=R) < 0.75, main_id,
                   rng.integers(-1, 5, R)).astype(np.int32)
    o = rng.uniform(-1.6, 1.6, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d[:16, 1] = 0.0  # axis-parallel rays: NaN slab distances
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(0.5, 4, R).astype(np.float32)
    act = rng.uniform(size=R) < 0.9
    p = rng.uniform(-1.1, 1.1, (R, 3)).astype(np.float32)

    mp_j = jmed.sample_point(jnp.asarray(mid), jnp.asarray(p))
    mp_t = tmed.sample_point(torch.as_tensor(mid), torch.as_tensor(p))
    for f, a, b in zip(mp_j._fields, mp_j, mp_t):
        _close(b.numpy(), a, f)
    sel = mid == main_id
    assert np.asarray(mp_j.sigma_s)[sel].max() > 0
    if kind == "rgb grid":
        assert np.asarray(mp_j.Le)[sel].max() > 0

    args_j = [jnp.asarray(a) for a in (mid, o, d, t_max, act)]
    args_t = [torch.as_tensor(a) for a in (mid, o, d, t_max, act)]
    it_j = jm.seg_init(jmed, *args_j)
    it_t = tm.seg_init(tmed, *args_t)
    live = sel & act & ~np.asarray(it_j.done)
    assert live.mean() > 0.2
    want_j, want_t = args_j[4], args_t[4]
    for step in range(4):
        done = np.asarray(it_j.done)
        np.testing.assert_array_equal(it_t.done.numpy(), done)
        for f in it_j._fields:
            a, b = np.asarray(getattr(it_j, f)), getattr(it_t, f).numpy()
            if f in ("voxel", "t_next", "t_delta", "step"):
                # the DDA cursor of a lane that missed its medium (an
                # infinite entry point cast to int) is undefined
                a, b = a[~done], b[~done]
            if a.dtype.kind == "f":
                fin = np.isfinite(a)
                np.testing.assert_array_equal(np.isfinite(b), fin,
                                              err_msg=f)
                _close(b[fin], a[fin], f"{f} after {step} steps")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f)
        it_j = jm.seg_next(jmed, args_j[0], it_j, want_j)
        it_t = tm.seg_next(tmed, args_t[0], it_t, want_t)
    if kind == "rgb grid":
        # the DDA walked several supervoxels with per-channel majorants
        assert (~np.asarray(it_j.done) & sel).any()


def test_earth_density_profile_and_shell():
    """The JAX package's earth checks on the port: exponential falloff from
    the surface, the density offset, and the heightmap shell's radius; the
    same values as JAX's."""
    kw = dict(sigma_a_atm=(1, 1, 1), sigma_s_atm=(0, 0, 0), p0=(-3,) * 3,
              p1=(3,) * 3, inner_r_atm=1.0, outer_r_atm=2.0, decay=0.5)
    em = tm.EarthMedium.make(**kw, device="cpu")
    jem = jm.EarthMedium.make(**kw)
    pts = np.asarray([[1.0, 0, 0], [2.0, 0, 0], [0, 1.5, 0]], np.float32)
    got = em._exp_density(torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, [1.0, np.exp(-2.0), np.exp(-1.0)],
                               atol=1e-5)
    _close(got, jem._exp_density(jnp.asarray(pts)), "exp density")
    em2 = tm.EarthMedium.make(p0=(-3,) * 3, p1=(3,) * 3, inner_r_atm=1.0,
                              outer_r_atm=2.0, decay=0.5,
                              density_offset=0.25, device="cpu")
    d2 = float(em2._exp_density(torch.as_tensor([2.0, 0.0, 0.0])))
    assert abs(d2 - (np.exp(-2.0) + 0.25)) < 1e-5

    shell = dict(sigma_a_cloud=(1, 1, 1), sigma_s_cloud=(0, 0, 0),
                 sigma_a_atm=(0, 0, 0), sigma_s_atm=(0, 0, 0),
                 p0=(-3,) * 3, p1=(3,) * 3, inner_r_cloud=1.0,
                 outer_r_cloud=2.0, heightmap=np.full((8, 8), 0.5,
                                                      np.float32))
    em3 = tm.EarthMedium.make(**shell, device="cpu")
    # the shell's outer radius is 1 + 0.5 * (2 - 1) = 1.5
    sa, _ = em3.sigma_at(torch.as_tensor([[1.2, 0, 0], [1.8, 0, 0],
                                          [0, 0, -1.4], [3.5, 0, 0]]))
    assert sa[:, 0].tolist() == [1.0, 0.0, 1.0, 0.0]
    # a heightmap that varies: the port's shell test equals JAX's
    jem, tem = _earths()
    p = np.random.default_rng(3).uniform(-1, 1, (4096, 3)).astype(np.float32)
    h_j = np.asarray(jem._cloud_height(jnp.asarray(p)))
    h_t = tem._cloud_height(torch.as_tensor(p)).numpy()
    _close(h_t, h_j, "cloud height")
    # JAX's lookup reaches a band of the map (u / pi, (v + rotation) / 2pi
    # of the [0, 1] square), and many of its cells
    assert len(np.unique(h_t)) > 16


def _box_scene(media, env=(0.1, 0.12, 0.15), point=True):
    lights = JLights.make(point_p=[(0.0, 1.8, 0.0)] if point else None,
                          point_I=[(6.0,) * 3] if point else None,
                          env_L=list(env), world_radius=100.0)
    geom = JGeometry.build(boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1),
                                       mat=-1, light=-1, med_in=0,
                                       med_out=-1)])
    return jv.Scene(geom, JMaterials.build([]), media, lights)


def _camera_film(res=RES):
    cam = PerspectiveCamera.make(jtr.look_at((0, 0, -4), (0, 0, 0),
                                             (0, 1, 0)), 30.0, (res, res))
    return cam, JFilm.make((res, res))


def _rgb_media():
    args, kw = _rgb_args()
    return jm.Media.make(grids=(jm.RGBGridMedium.make(*args, **kw),))


def check_render(kind):
    """volpath.render at 32x32x2 pixel for pixel with JAX's XLA render (the
    RGB grid emits), at test_torch_volpath_render.py's bar."""
    media = (_rgb_media() if kind == "rgb grid"
             else jm.Media.make(procedurals=(_earths()[0],)))
    scene = _box_scene(media)
    cam, film = _camera_film()
    cfg = jv.VolPathConfig(max_depth=8, max_events=32)
    ref = np.asarray(jv.render(scene, cam, film, spp=2, cfg=cfg, seed=5,
                               spp_per_pass=2))
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, cfg, "cpu")
    img = tv.render(ts, tc, tf, spp=2, cfg=tcfg, seed=5, spp_per_pass=2,
                    device="cpu").numpy()
    diff = np.abs(img - ref)
    ok = ((diff <= 1e-3 * np.abs(ref)) | (diff <= 1e-6)).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert ref.mean() > 0


def test_render_rgb_grid_matches_jax():
    """The emissive RGB grid in a box (the earth medium's render is in
    test_torch_media_ext_render.py: one JAX render compile a file)."""
    check_render("rgb grid")


def test_earth_furnace():
    """A scattering-only earth atmosphere in a box under a uniform
    environment of 1, no other light: the image's mean is 1 within 3
    standard errors of the per-pixel values (paths cut at depth 256)."""
    em = tm.EarthMedium.make(sigma_a_atm=(0, 0, 0), sigma_s_atm=(3, 3, 3),
                             p0=(-1, -1, -1), p1=(1, 1, 1),
                             center=(0, 0, 0), inner_r_atm=0.2,
                             outer_r_atm=2.0, decay=0.6, device="cpu")
    scene = _box_scene(jm.Media.make(), env=(1, 1, 1), point=False)
    cam, film = _camera_film()
    cfg = jv.VolPathConfig(max_depth=256, max_events=512)
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, cfg, "cpu")
    ts = dataclasses.replace(ts, media=tm.Media.make(procedurals=(em,),
                                                     device="cpu"))
    img = tv.render(ts, tc, tf, spp=16, cfg=tcfg, seed=3, spp_per_pass=16,
                    device="cpu").numpy()
    lum = img.mean(-1).reshape(-1)
    err = lum.std() / np.sqrt(lum.size)
    assert abs(lum.mean() - 1.0) <= 3 * err + 1e-6, (lum.mean(), err)
    assert np.isfinite(img).all()


@pytest.mark.parametrize("kind", ["rgb grid", "earth"])
def test_kernel_predicates_refuse(kind):
    """A box holding the RGB grid, or the earth medium beside the density
    grid: JAX's extract_constants and pallas_vspg.supports and the port's
    extract_constants and vspg_kernels.supports refuse it (the RGB grid by
    type before any field is read), while they take the same box with the
    density grid alone."""
    dens = bf16_cloud(16)
    grid = jm.GridMedium.make(dens, [0.1] * 3, [1.0] * 3, (-1, -1, -1),
                              (1, 1, 1), maj_res=8)
    plain = _box_scene(jm.Media.make(grids=(grid,)))
    scene = (_box_scene(_rgb_media()) if kind == "rgb grid" else
             _box_scene(jm.Media.make(grids=(grid,),
                                      procedurals=(_earths()[0],))))
    cam, film = _camera_film(16)
    cfg = jv.VolPathConfig()
    from vspg_pbrt_v4_tpu.models.guiding import field as jfield
    from vspg_pbrt_v4_tpu.models.integrators import guided_volpath as jgv

    jgopt, jvopt = jgv.GuidingOptions(field_res=4), jvspg.VSPGOptions()
    jfld = jfield.GuidingField.make((-1,) * 3, (1,) * 3, res=4)
    tgopt, tvopt = tgv.GuidingOptions(field_res=4), tvspg.VSPGOptions()
    tfld = GuidingField.make((-1,) * 3, (1,) * 3, res=4, device="cpu")
    for s, want in ((plain, True), (scene, False)):
        assert (jpv.extract_constants(s, cam, film, cfg) is not None) == want
        ts, tc, tf, tcfg = convert.from_jax(s, cam, film, cfg, "cpu")
        assert (vk.extract_constants(ts, tc, tf, tcfg) is not None) == want
        assert gk.supports(ts, tc, tf, tcfg, tgopt, tvopt, tfld) == want
        if not want:
            assert not jpg.supports(s, cam, film, cfg, jgopt, jvopt, jfld)
