"""The teaser scene class in the volpath arm: flat triangles of diffuse,
smooth dielectric and smooth conductor materials inside a grid cloud (the
36-triangle scene of tests/test_teaser_kernel.py, at 16^2).

- ``render_persistent(backend="torch")`` against the JAX package's XLA
  ``render_persistent``: the same lockstep wavefront on the same random
  stream, so pixel for pixel.
- B2b's plain version (``render_grid_plain`` with triangles, its own random
  stream) against the Pallas grid kernel run in interpret mode, with the
  smooth, the glossy and the checker materials: Monte Carlo agreement (the
  bands of tests/test_torch_kernel_grid.py).
- The medium-relabel regression: a mirror quad in the cloud whose normal
  points away from the camera, with vacuum labelled on the camera's side.
  A ray reflected off its back stays in the cloud; re-deriving the medium
  from the face's label side would drop it into vacuum, to cross an
  absorbing slab unattenuated (``volpath.volpath_bounce``'s
  reflection-keeps-its-medium rule). The JAX XLA path, the torch path and
  B2b's plain version agree in the mean.
"""

import numpy as np
import pytest

from vspg_pbrt_v4_tpu.models import materials as M
from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.lights import Lights
from vspg_pbrt_v4_tpu.models.media import GridMedium, Media
from vspg_pbrt_v4_tpu.models.shapes import Geometry
from vspg_pbrt_v4_tpu.ops import pallas_volpath as pv
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch.convert import from_jax
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk

from test_torch_kernel_grid import assert_mc_agree

RES = 16
CFG = jv.VolPathConfig(max_depth=12, max_events=64)
BOX = dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1, med_in=0,
           med_out=-1)
FACES = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
         (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]


def cube_tris(c, h, mat):
    """The 12 triangles of a cube, vacuum inside and the cloud outside."""
    v = [(c[0] + (h if i & 1 else -h), c[1] + (h if i & 2 else -h),
          c[2] + (h if i & 4 else -h)) for i in range(8)]
    return [dict(p0=v[a], p1=v[b], p2=v[cc], mat=mat, light=-1, med_in=-1,
                 med_out=0) for (a, b, cc) in FACES]


def teaser(tris, mats, sigma_a=0.05):
    """The cloud of tests/test_teaser_kernel.py (bf16-exact density, so
    the Pallas kernel's tables hold the same medium) with `tris`."""
    x = np.linspace(-1, 1, 16)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    dens = np.clip(1.0 - np.sqrt(X**2 + Y**2 + Z**2), 0, 1).astype(
        np.float32) * 2.0
    dens = (dens.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    gm = GridMedium.make(dens, [sigma_a] * 3, [1.0] * 3, (-1, -1, -1),
                         (1, 1, 1), g=0.3, maj_res=8)
    lights = Lights.make(point_p=[(0.0, 1.8, 0.0)], point_I=[(6.0,) * 3],
                         env_L=[0.3, 0.35, 0.4], world_radius=100.0)
    scene = jv.Scene(Geometry.build(triangles=tris, boxes=[BOX]),
                     M.Materials.build(mats), Media.make(grids=(gm,)), lights)
    cam = PerspectiveCamera.make(jtr.look_at((0, 0, -4), (0, 0, 0),
                                             (0, 1, 0)), 30.0, (RES, RES))
    return scene, cam, RGBFilm.make((RES, RES))


MATS = [dict(type=M.DIFFUSE, albedo=(0.7, 0.4, 0.2)),
        dict(type=M.DIELECTRIC, eta=1.5, roughness=0.0),
        dict(type=M.CONDUCTOR, albedo=(0.9, 0.7, 0.4), roughness=0.0)]
TRIS = (cube_tris((0.25, -0.1, 0.0), 0.28, 1)
        + cube_tris((-0.45, 0.1, 0.2), 0.2, 0)
        + cube_tris((0.0, 0.55, -0.3), 0.15, 2))


def test_render_persistent_matches_jax_teaser():
    """Glass, metal and diffuse cubes in the cloud: the torch wavefront
    against the JAX XLA wavefront, 4 spp, pixel for pixel (1e-3 relative;
    a rare last-ulp branch flip may move a pixel further)."""
    scene, cam, film = teaser(TRIS, MATS)
    ref = np.asarray(jv.render_persistent(scene, cam, film, spp=4, cfg=CFG,
                                          seed=5, backend="jnp"))
    ts, tc, tf, tcfg = from_jax(scene, cam, film, CFG, "cpu")
    assert vk.extract_constants(ts, tc, tf, tcfg).n_tri == 36
    img = tv.render_persistent(ts, tc, tf, spp=4, cfg=tcfg, seed=5,
                               backend="torch", device="cpu").numpy()
    d = np.abs(img - ref)
    frac = ((d <= 1e-3 * np.abs(ref)) | (d <= 1e-6)).all(-1).mean()
    print(f"teaser render_persistent: {frac:.4f} of pixels within 1e-3")
    assert frac >= 0.99, frac
    assert ref.mean() > 0


VARIANTS = {
    "smooth": MATS,
    # Trowbridge-Reitz rough conductor and CookTorrance
    "rough": [dict(type=M.COOK_TORRANCE, albedo=(0.7, 0.4, 0.2), eta=1.5,
                   roughness=0.3),
              MATS[1],
              dict(type=M.CONDUCTOR, albedo=(0.9, 0.7, 0.4),
                   roughness=0.25)],
    # a checker albedo on the diffuse cube
    "checker": [dict(MATS[0], albedo_tex=0)] + MATS[1:],
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_grid_tris_plain_matches_pallas_interpret(variant):
    """B2b's plain version (96 spp) against the Pallas grid kernel with its
    triangle blocks, run in interpret mode (48 spp): the same estimator on
    other random streams, for the smooth materials, the glossy ones and a
    checker albedo."""
    from vspg_pbrt_v4_tpu.models import textures as jtex

    scene, cam, film = teaser(TRIS, VARIANTS[variant])
    if variant == "checker":
        scene = scene._replace(textures=jtex.Textures.build([dict(
            kind=jtex.CHECKER, c0=(0.9, 0.9, 0.9), c1=(0.1, 0.2, 0.8),
            uvscale=(4.0, 4.0))]))
    ref = np.asarray(pv.render_homog_pallas(scene, cam, film, 48, CFG,
                                            seed=9, interpret=True))
    c = vk.extract_constants(*from_jax(scene, cam, film, CFG, "cpu"))
    assert c.kind == "grid" and c.n_tri == 36
    counts = {}
    img = vk.render_grid_plain(c, 96, 7, counts).numpy()
    assert counts["surface_events"] > 0 and counts["tri_tests"] > 0
    assert_mc_agree(img, ref)


def relabel_scene():
    """A mirror quad at 45 degrees in the cloud, wound inward: its normal
    (-1, 0, 1)/sqrt(2) points away from the camera, whose rays meet its
    back, labelled vacuum (med_in -1). They reach it through empty cells
    and reflect toward +x into an absorbing slab (x > 0.2)."""
    mirror = [dict(type=M.CONDUCTOR, albedo=(0.95, 0.95, 0.95),
                   roughness=0.0)]
    c, u, v = np.array([-0.2, 0, 0]), np.array([0.3, 0, 0.3]), np.array(
        [0, 0.4, 0])
    p = [c - u - v, c + u - v, c + u + v, c - u + v]
    quad = [dict(p0=tuple(p[a]), p1=tuple(p[b]), p2=tuple(p[cc]), mat=0,
                 light=-1, med_in=-1, med_out=0)
            for (a, b, cc) in ((0, 1, 2), (0, 2, 3))]
    scene, cam, film = teaser(quad, mirror)
    x = np.linspace(-1, 1, 16)
    X = np.meshgrid(x, x, x, indexing="ij")[0]
    slab = GridMedium.make(np.where(X > 0.2, 4.0, 0.0).astype(np.float32),
                           [1.0] * 3, [1.0] * 3, (-1, -1, -1), (1, 1, 1),
                           g=0.3, maj_res=8)
    return scene._replace(media=Media.make(grids=(slab,))), cam, film


def test_medium_relabel_on_reflection():
    """The JAX XLA path, the torch path and B2b's plain version agree in
    the mean within 3% on relabel_scene. A reflection that took the label
    of the face's side would leave the slab unattenuated: with that rule
    in the torch path and the plain version, both read 17% bright."""
    scene, cam, film = relabel_scene()
    n = np.asarray(scene.geometry.tri_n0)
    assert np.allclose(n, [-np.sqrt(0.5), 0, np.sqrt(0.5)], atol=1e-6)
    ref = np.asarray(jv.render(scene, cam, film, spp=48, cfg=CFG, seed=3,
                               spp_per_pass=16))
    ts, tc, tf, tcfg = from_jax(scene, cam, film, CFG, "cpu")
    torch_img = tv.render_persistent(ts, tc, tf, spp=48, cfg=tcfg, seed=6,
                                     backend="torch", device="cpu").numpy()
    c = vk.extract_constants(ts, tc, tf, tcfg)
    assert c.n_tri == 2
    counts = {}
    plain = vk.render_grid_plain(c, 96, 7, counts).numpy()
    assert counts["surface_events"] > 1000
    for img in (torch_img, plain):
        assert abs(img.mean() - ref.mean()) / ref.mean() < 0.03, (
            img.mean(), ref.mean())
