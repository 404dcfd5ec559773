"""The work items of the grid kernel (B2a-c, ``csrc/volpath_grid.cuh``):
every (pixel, sample) is an item of its own, and an ordered per-pixel sum
makes the image. The port against itself, at 12x12 and 1-3 spp, for each
geometry mode: no triangles (the 64^3 bench cloud), the 48-triangle sweep
(the teaser machines) and the BVH (96 triangles, the machines and a
half-size copy). ``render_grid_plain`` is held against the JAX package in
test_torch_kernel_grid.py, test_torch_volpath_teaser.py and
test_torch_volpath_mesh.py.

- Sample 0 of ``render_grid_items_plain``, times the image scale, is
  ``render_grid_plain`` at 1 spp, bit for bit.
- ``reduce_samples_plain`` of the items (acc = acc + L[s] in sample order
  from zero, then the scale) is ``render_grid_plain``'s image within 1e-6
  relative: the lockstep plain version adds its lanes in order of death.
- The sum in chunks of samples, carried from chunk to chunk, is the sum in
  one chunk, bit for bit.
- No carry crosses samples: an item rendered with its pixel alone, or in a
  render with fewer samples, equals the same item in the full render.
"""

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

RES, SPP, SEED = 12, 3, 7
CFG = tv.VolPathConfig(max_depth=24, max_events=128)


def _mesh96():
    """The machines and a copy at half size nearer the camera: 96
    triangles, so the mesh class's BVH."""
    base = vk.make_machines_scene(device="cpu")

    def moved(p):
        return tuple(0.5 * np.asarray(p, np.float32) + (0.0, 0.0, -0.55))

    tris = vk.machine_tris()
    tris += [dict(t, p0=moved(t["p0"]), p1=moved(t["p1"]),
                  p2=moved(t["p2"])) for t in vk.machine_tris()]
    geom = Geometry.build(
        boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1,
                    med_in=0, med_out=-1)], triangles=tris, device="cpu")
    return tv.Scene(geom, base.materials, base.media, base.lights,
                    base.textures)


SCENES = {"none": lambda: vk.make_cloud64_scene(device="cpu"),
          "sweep": lambda: vk.make_machines_scene(device="cpu"),
          "bvh": _mesh96}


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    """The constants of one geometry mode, its items at SPP and its
    image."""
    c = vk.extract_constants(SCENES[request.param](),
                             vk.bench_camera(RES, device="cpu"),
                             RGBFilm.make((RES, RES), device="cpu"), CFG)
    assert c is not None and c.kind == "grid"
    mode = "none" if c.tris is None else (
        "sweep" if c.nodes is None else "bvh")
    assert mode == request.param and c.n_tri <= 144
    items = vk.render_grid_items_plain(c, SPP, SEED)
    return c, items, vk.render_grid_plain(c, SPP, SEED)


def test_sample0_is_the_one_spp_image(case):
    c, _, _ = case
    items = vk.render_grid_items_plain(c, 1, SEED)
    assert tuple(items.shape) == (1, RES * RES, 3)
    img = vk.render_grid_plain(c, 1, SEED)
    assert torch.equal((items[0] * (c.imaging_ratio / 1)).reshape(img.shape),
                       img)


def test_ordered_reduce_is_the_image(case):
    c, items, img = case
    assert tuple(items.shape) == (SPP, RES * RES, 3)
    assert bool(torch.isfinite(items).all()) and items.abs().sum() > 0
    red = sk.reduce_samples_plain(items, None, 0, c.imaging_ratio / SPP)
    torch.testing.assert_close(red.reshape(img.shape), img, rtol=1e-6,
                               atol=0.0)
    # the CPU route of the kernel's reduce wrapper is the same sum
    assert torch.equal(sk.reduce_samples(items, None, 0,
                                         c.imaging_ratio / SPP), red)


def test_chunked_reduce_is_one_chunk(case):
    c, items, _ = case
    scale = c.imaging_ratio / SPP
    whole = sk.reduce_samples_plain(items, None, 0, scale)
    first = sk.reduce_samples_plain(items[:1], None, 0, 1.0)
    chunked = sk.reduce_samples_plain(items[1:], None, 0, scale, acc=first)
    assert torch.equal(chunked, whole)
    with pytest.raises(ValueError):
        sk.reduce_samples_plain(items, torch.ones(items.shape[:2],
                                                  dtype=torch.int32), 8,
                                scale, acc=first)


def test_no_carry_across_samples(case):
    c, items, _ = case
    pix = [0, RES * RES // 2 + 5, RES * RES - 1]
    alone = vk.render_grid_items_plain(c, SPP, SEED, pixels=pix)
    assert torch.equal(alone, items[:, pix])
    fewer = vk.render_grid_items_plain(c, SPP - 1, SEED)
    assert torch.equal(fewer, items[:SPP - 1])
