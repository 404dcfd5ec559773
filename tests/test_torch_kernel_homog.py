"""B1, the homogeneous-fog kernel module: ``render_homog_plain`` against
the Pallas kernel ``pallas_volpath.render_homog_pallas`` run in interpret
mode as the JAX package's own tests run it, a furnace, the support
predicate and the CPU dispatch of the wrapper."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm as JFilm
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.ops import pallas_volpath as pv
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch.convert import from_jax
from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.models.lights import Lights
from vspg_pbrt_v4_tpu_torch.models.materials import Materials
from vspg_pbrt_v4_tpu_torch.models.media import HomogeneousMedia
from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk

RES = 16
CFG = jv.VolPathConfig(max_depth=32, max_events=128)


def _jax_setup(env, point):
    scene = jv.make_fog_box_scene([0.05] * 3, [0.5, 0.6, 0.7], g=0.3,
                                  env_L=env, point=point)
    cam = PerspectiveCamera.make(jtr.look_at((0, 0, -4), (0, 0, 0),
                                             (0, 1, 0)), 30.0, (RES, RES))
    return scene, cam, JFilm.make((RES, RES))


@pytest.mark.parametrize("env,point", [
    ([0.1, 0.12, 0.15], ((0.0, 0.8, 0.0), (5.0, 5.0, 5.0))),  # bench fog
    (None, ((0.0, 1.8, 0.0), (8.0, 8.0, 8.0))),
    ([0.7, 0.6, 0.5], None),
])
def test_homog_plain_matches_pallas_interpret(env, point):
    """Same per-sample random stream as the Pallas kernel: per pixel."""
    scene, cam, film = _jax_setup(env, point)
    ref = np.asarray(pv.render_homog_pallas(scene, cam, film, 4, CFG,
                                            seed=7, interpret=True))
    c = vk.extract_constants(*from_jax(scene, cam, film, CFG, "cpu"))
    assert c.kind == "homog"
    img = vk.render_homog_plain(c, 4, 7).numpy()
    diff = np.abs(img - ref)
    # 1e-4 relative: float32 sums of a few samples of the same stream; a
    # rare branch flip from a last-ulp exp/log1p difference moves a pixel
    ok = ((diff <= 1e-4 * np.abs(ref)) | (diff <= 1e-7)).all(-1)
    assert ok.mean() >= 0.98, ok.mean()
    assert ref.mean() > 0


def test_homog_furnace():
    """Pure scattering in a uniform environment: the image is the
    environment (0.7) in expectation; 1% holds at 16x16x64 (measured
    spread 0.4%)."""
    scene = tv.make_fog_box_scene([0.0] * 3, [1.0] * 3, g=0.0,
                                  env_L=[0.7] * 3, device="cpu")
    c = vk.extract_constants(scene, vk.bench_camera(RES, device="cpu"),
                             RGBFilm.make((RES, RES), device="cpu"),
                             tv.VolPathConfig(max_depth=32, max_events=128))
    img = vk.render_homog(c, 64, 1)
    assert torch.isfinite(img).all()
    assert abs(img.mean().item() - 0.7) / 0.7 < 0.01, img.mean().item()


def test_wrapper_and_auto_dispatch_use_plain_on_cpu():
    scene = vk.make_fog_box_scene(device="cpu")
    cam = vk.bench_camera(RES, device="cpu")
    film = RGBFilm.make((RES, RES), device="cpu")
    c = vk.extract_constants(scene, cam, film, CFG)
    before = dict(vk.LAUNCHES)
    plain = vk.render_homog_plain(c, 2, 3)
    assert torch.equal(vk.render_homog(c, 2, 3), plain)
    auto = tv.render_persistent(scene, cam, film, spp=2, cfg=CFG, seed=3,
                                device="cpu")
    assert torch.equal(auto, plain)
    assert vk.LAUNCHES == before  # no kernel launch on the CPU
    with pytest.raises(ValueError):
        vk.render_grid(c, 2, 3)


def test_constant_layout_matches_header():
    """csrc/common.cuh declares the same constant-table layout."""
    src = (Path(vk.__file__).parent.parent / "csrc" / "common.cuh").read_text()
    decl = {m[0]: int(m[1]) for m in re.findall(r"\b([FI]_\w+|N_[FI]CONST)"
                                                r"\s*=\s*(\d+)", src)}
    names = [n for n in dir(vk) if re.fullmatch(r"[FI]_\w+|N_[FI]CONST", n)]
    assert len(names) == len(decl) == 15 + 1 + 18 + 1
    for n in names:
        assert decl[n] == getattr(vk, n), n


def _variants():
    """Scenes, one change each, that leave the kernels' class."""
    dev = "cpu"
    base = vk.make_fog_box_scene(device=dev)

    def media(**kw):
        args = dict(sigma_a=[[0.05] * 3], sigma_s=[[0.5] * 3], g=[0.3])
        args.update(kw)
        return HomogeneousMedia.make(device=dev, **args)

    box = dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1,
               med_in=0, med_out=-1)
    return {
        "two boxes": base.__class__(
            Geometry.build([box, dict(box, bmin=(2, 2, 2), bmax=(3, 3, 3))],
                           device=dev), base.materials, base.media,
            base.lights),
        "surface material": base.__class__(
            Geometry.build([dict(box, mat=0)], device=dev), base.materials,
            base.media, base.lights),
        "camera inside": base.__class__(
            Geometry.build([dict(box, med_in=-1, med_out=0)], device=dev),
            base.materials, base.media, base.lights),
        "two media": base.__class__(
            base.geometry, base.materials,
            media(sigma_a=[[0.05] * 3] * 2, sigma_s=[[0.5] * 3] * 2,
                  g=[0.3, 0.3]), base.lights),
        "emissive medium": base.__class__(
            base.geometry, base.materials, media(Le=[[1.0] * 3]),
            base.lights),
        "two point lights": base.__class__(
            base.geometry, base.materials, base.media,
            Lights.make(point_p=[(0, 0, 0), (0, 1, 0)],
                        point_I=[(1, 1, 1)] * 2, device=dev)),
        "no light": base.__class__(
            base.geometry, base.materials, base.media,
            Lights.make(device=dev)),
        # B1 shades no emission: an area light must not render dark
        "area light": base.__class__(
            base.geometry, base.materials, base.media,
            Lights.make(env_L=[0.2] * 3, area_tris=[dict(
                p0=(0, 0, 0), p1=(1, 0, 0), p2=(0, 1, 0), L=(1, 1, 1))],
                device=dev)),
    }


@pytest.mark.parametrize("name", sorted(_variants()))
def test_extract_constants_rejects(name):
    scene = _variants()[name]
    cam = vk.bench_camera(RES, device="cpu")
    film = RGBFilm.make((RES, RES), device="cpu")
    assert vk.extract_constants(scene, cam, film, CFG) is None


def test_extract_constants_rejects_config_film_and_triangles():
    scene = vk.make_fog_box_scene(device="cpu")
    cam = vk.bench_camera(RES, device="cpu")
    film = RGBFilm.make((RES, RES), device="cpu")
    assert vk.extract_constants(scene, cam, film, CFG) is not None
    assert vk.extract_constants(scene, cam, film,
                                CFG._replace(spectral=True)) is None
    for f in (RGBFilm.make((RES, RES), max_component=10.0, device="cpu"),
              RGBFilm.make((RES, RES), sensor_matrix=np.diag([1, 2, 1]),
                           device="cpu")):
        assert vk.extract_constants(scene, cam, f, CFG) is None
    # a triangle in the fog box: fused surfaces live only in the grid
    # kernel, so the scene renders through the torch wavefront
    js, jc, jf = _jax_setup([0.1] * 3, None)
    tri = JGeometry.build(
        triangles=[dict(p0=(0, 0, 0), p1=(1, 0, 0), p2=(0, 1, 0), mat=0)],
        boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1,
                    med_in=0, med_out=-1)])
    ts, tc, tf, tcfg = from_jax(js._replace(geometry=tri), jc, jf, CFG, "cpu")
    assert ts.geometry.n_tri == 1
    assert vk.extract_constants(ts, tc, tf, tcfg) is None
    img = tv.render_persistent(ts, tc, tf, spp=1, cfg=tcfg, device="cpu")
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
    # the mesh class in the grid cloud (more than 64 triangles) takes B2c's
    # constants (the triangle table in the BVH's leaf order and its node
    # table) and renders through the torch path, which walks the BVH
    cloud = vk.make_cloud64_scene(device="cpu")
    tris = [dict(p0=(0.02 * i - 0.5, 0, 0), p1=(0.02 * i - 0.48, 0, 0),
                 p2=(0.02 * i - 0.5, 0.1, 0), mat=0, med_in=-1, med_out=0)
            for i in range(65)]
    mesh = type(cloud)(Geometry.build(
        [dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1, med_in=0,
              med_out=-1)], tris, device="cpu"),
        Materials.build([dict(type=0, albedo=(0.7, 0.7, 0.7))],
                        device="cpu"), cloud.media, cloud.lights)
    c = vk.extract_constants(mesh, cam, film, CFG)
    bvh = mesh.geometry.tri_bvh
    assert c.kind == "grid" and c.n_tri == 65
    assert c.nodes.shape == (bvh.n_nodes, vk.NODE_COLS)
    assert torch.equal(c.tris, torch.as_tensor(
        vk.pack_tri_table(mesh.geometry))[bvh.prim_ids.long()])
    img = tv.render_persistent(mesh, cam, film, spp=1, cfg=CFG,
                               backend="torch", device="cpu")
    assert bool(torch.isfinite(img).all()) and img.mean().item() > 0
