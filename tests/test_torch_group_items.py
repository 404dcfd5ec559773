"""The work items of B1 (the fog-box kernel, ``csrc/volpath_homog.cu``) and
B5 (the Cornell surface kernel, ``csrc/path_surface.cu``): each item is one
pixel and a group of consecutive samples (B5's kernel: one sample), whose
sum the kernel writes, and an ordered per-pixel sum of the groups makes
the image. The port against
itself, at 12x12 and 1-3 spp: B1 on the bench fog (point light and
environment), with the environment alone and with the point light alone;
B5 on the Cornell box, the box with every light type of its class and the
floor. ``render_homog_plain`` and ``render_surface_plain`` are held
against the JAX package's interpret-mode Pallas kernels in
test_torch_kernel_homog.py and test_torch_surface_kernel.py.

- Sample 0 of the per-sample plain version, times the image scale, is the
  per-pixel plain version at 1 spp, bit for bit.
- The group sums (``group_sums_plain``, each from zero in sample order),
  reduced in group order by ``reduce_samples_plain``, are the per-pixel
  image within 1e-6 relative (B1's per-pixel version adds in the order
  the paths end), and with one group of all samples they are the ordered
  per-sample sum bit for bit (and B5's per-pixel image, which sums in
  sample order).
- The sum in chunks of groups, carried from chunk to chunk, is the sum in
  one chunk, bit for bit.
- No carry crosses samples: an item rendered with its pixel alone, or in a
  render with fewer samples, equals the same item in the full render.
- B1's group rule and the chunks of the wrappers on a card.
"""

import pytest
import torch

from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.ops import surface_kernels as pk
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

RES, SPP, SEED = 12, 3, 7
FOG = dict(sigma_a=[0.05] * 3, sigma_s=[0.5, 0.6, 0.7], g=0.3)
POINT = ((0.0, 0.8, 0.0), (5.0, 5.0, 5.0))
ENV = [0.1, 0.12, 0.15]


def _homog(**lights):
    def make():
        scene = tv.make_fog_box_scene(device="cpu", **FOG, **lights)
        c = vk.extract_constants(scene, vk.bench_camera(RES, device="cpu"),
                                 RGBFilm.make((RES, RES), device="cpu"),
                                 tv.VolPathConfig(max_depth=32,
                                                  max_events=128))
        assert c is not None and c.kind == "homog"
        return c, vk.render_homog_plain, vk.render_homog_items_plain
    return make


def _surface(make_scene, eye, at):
    def make():
        c = pk.extract_constants(make_scene(device="cpu"),
                                 *pk.cornell_view(RES, RES, eye, at,
                                                  device="cpu"),
                                 tv.VolPathConfig(max_depth=8, max_events=24))
        assert c is not None
        return c, pk.render_surface_plain, pk.render_surface_items_plain
    return make


CASES = {
    "fog": _homog(env_L=ENV, point=POINT),
    "fog env": _homog(env_L=ENV),
    "fog point": _homog(point=POINT),
    "cornell": _surface(tv.make_cornell_box_scene, pk.CORNELL_EYE,
                        pk.CORNELL_AT),
    "cornell lit": _surface(pk.make_cornell_lit_scene, pk.CORNELL_EYE,
                            pk.CORNELL_AT),
    "floor": _surface(pk.make_floor_scene, pk.FLOOR_EYE, pk.FLOOR_AT),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(name, constants, per-pixel plain version, per-sample plain version,
    the per-sample radiances at SPP, the per-pixel image at SPP)."""
    c, pixel_fn, items_fn = CASES[request.param]()
    items = items_fn(c, SPP, SEED)
    assert tuple(items.shape) == (SPP, RES * RES, 3)
    assert bool(torch.isfinite(items).all()) and items.abs().sum() > 0
    return request.param, c, pixel_fn, items_fn, items, pixel_fn(c, SPP, SEED)


def test_sample0_is_the_one_spp_image(case):
    _, c, pixel_fn, items_fn, _, _ = case
    items = items_fn(c, 1, SEED)
    assert tuple(items.shape) == (1, RES * RES, 3)
    img = pixel_fn(c, 1, SEED)
    assert torch.equal((items[0] * (c.imaging_ratio / 1)).reshape(img.shape),
                       img)


@pytest.mark.parametrize("group", [1, 2, SPP])
def test_group_sums_reduce_to_the_image(case, group):
    name, c, _, _, items, img = case
    scale = c.imaging_ratio / SPP
    sums = vk.group_sums_plain(items, group)
    assert tuple(sums.shape) == (-(-SPP // group), RES * RES, 3)
    red = sk.reduce_samples_plain(sums, None, 0, scale)
    torch.testing.assert_close(red.reshape(img.shape), img, rtol=1e-6,
                               atol=0.0)
    ordered = sk.reduce_samples_plain(items, None, 0, scale)
    if group == 1:
        assert torch.equal(sums, items)
    if group == SPP:
        # one group: the per-sample loop's sum in sample order
        assert torch.equal(red, ordered)
        if not name.startswith("fog"):
            assert torch.equal(red.reshape(img.shape), img)
    # the last group is the shorter one
    assert torch.equal(sums[-1], vk.group_sums_plain(
        items[(len(sums) - 1) * group:], SPP)[0])


def test_chunked_reduce_is_one_chunk(case):
    _, c, _, _, items, _ = case
    scale = c.imaging_ratio / SPP
    sums = vk.group_sums_plain(items, 2)
    whole = sk.reduce_samples_plain(sums, None, 0, scale)
    first = sk.reduce_samples_plain(sums[:1], None, 0, 1.0)
    chunked = sk.reduce_samples_plain(sums[1:], None, 0, scale, acc=first)
    assert torch.equal(chunked, whole)


def test_no_carry_across_samples(case):
    _, c, _, items_fn, items, _ = case
    pix = [0, RES * RES // 2 + 5, RES * RES - 1]
    alone = items_fn(c, SPP, SEED, pixels=pix)
    assert torch.equal(alone, items[:, pix])
    fewer = items_fn(c, SPP - 1, SEED)
    assert torch.equal(fewer, items[:SPP - 1])


@pytest.mark.parametrize("npix,spp,threads,group", [
    (256 * 256, 64, 132 * 8 * 128, 3),  # the bench shape, 8 blocks an SM
    (256 * 256, 64, 132 * 4 * 128, 7),
    (1920 * 1088, 16, 132 * 4 * 128, 16),  # 1080p: one group of 16
    (64 * 64, 4, 132 * 4 * 128, 1),  # fewer items than threads
    (12 * 12, 3, 1, 3),  # at most spp
])
def test_group_size_rule(npix, spp, threads, group):
    assert vk.group_size(npix, spp, threads) == group
    n_items = npix * -(-spp // group)
    if group > 1:
        assert n_items >= vk.ITEMS_PER_THREAD * threads


@pytest.mark.parametrize("group", [1, 3, 16])
def test_chunks_hold_whole_groups(group, monkeypatch):
    npix, spp = 1920 * 1088, 40
    chunk = vk.chunk_samples(npix, spp, group)
    assert chunk % group == 0 and chunk >= group
    assert chunk // group * 12 * npix <= max(sk.SCRATCH_BYTES, 12 * npix)
    # one group a chunk where the scratch holds less than one
    monkeypatch.setattr(sk, "SCRATCH_BYTES", 12 * npix - 1)
    assert vk.chunk_samples(npix, spp, group) == group
    monkeypatch.setattr(sk, "SCRATCH_BYTES", 1 << 40)
    assert vk.chunk_samples(npix, spp, group) == group * -(-spp // group)
