"""The CUDA kernels against their plain versions on the card. Marked
``cuda``; they skip where no NVIDIA GPU is present. On a GPU machine
without JAX, skip tests/conftest.py (it configures JAX):
``python -m pytest --noconftest tests/test_torch_cuda.py -q``."""

import dataclasses

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk

pytestmark = pytest.mark.cuda

CFG = tv.VolPathConfig(max_depth=32, max_events=128, max_collisions=2048)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


def _consts(make, res, dev):
    return vk.extract_constants(make(device=dev),
                                vk.bench_camera(res, device=dev),
                                RGBFilm.make((res, res), device=dev), CFG)


@pytest.mark.parametrize("make,spp,min_frac", [
    (vk.make_fog_box_scene, 8, 0.99),
    (vk.make_cloud64_scene, 4, 0.98),
])
def test_kernel_matches_plain(dev, make, spp, min_frac):
    c = _consts(make, 48, dev)
    before = vk.LAUNCHES[c.kind]
    k = vk.render(c, spp, 3)
    p = (vk.render_homog_plain if c.kind == "homog"
         else vk.render_grid_plain)(c, spp, 3)
    torch.cuda.synchronize()
    assert vk.LAUNCHES[c.kind] == before + 1
    diff = (k - p).abs()
    # same random stream; FMA contraction and rare last-ulp branch flips
    ok = ((diff <= 1e-3 * p.abs()) | (diff <= 1e-5)).all(-1)
    assert ok.float().mean().item() >= min_frac


@pytest.mark.parametrize("materials", ["smooth", "rough", "checker"])
def test_grid_tris_kernel_matches_plain(dev, materials):
    """B2b: the machines in the pyroclastic cloud, with each material
    variant, against the plain version on the same random stream (2e-3,
    the bar of PERF.md §2)."""
    c = vk.extract_constants(vk.make_machines_scene(materials=materials,
                                                    device=dev),
                             vk.bench_camera(48, device=dev),
                             RGBFilm.make((48, 48), device=dev), CFG)
    assert c.n_tri == 48
    before = vk.LAUNCHES["grid_tris"]
    k = vk.render(c, 4, 3)
    p = vk.render_grid_plain(c, 4, 3)
    torch.cuda.synchronize()
    assert vk.LAUNCHES["grid_tris"] == before + 1
    diff = (k - p).abs()
    ok = ((diff <= 2e-3 * p.abs()) | (diff <= 1e-5)).all(-1)
    assert ok.float().mean().item() >= 0.98


@pytest.mark.parametrize("materials", ["smooth", "rough"])
def test_grid_mesh_kernel_matches_plain(dev, materials):
    """B2c: the 3072-triangle PLY machines in the pyroclastic cloud,
    walked through their BVH, against the plain version's brute-force
    sweep on the same random stream (2e-3, the bar of PERF.md §2), at 4
    spp: B2b's -O3 build lost a warp's samples from the third on; the main
    path's entry point takes the kernel."""
    scene = vk.make_machines_scene(mesh=True, materials=materials,
                                   device=dev)
    cam = vk.bench_camera(48, device=dev)
    film = RGBFilm.make((48, 48), device=dev)
    c = vk.extract_constants(scene, cam, film, CFG)
    assert c.n_tri == 3072 and c.nodes is not None
    before = vk.LAUNCHES["grid_mesh"]
    k = vk.render(c, 4, 3)
    p = vk.render_grid_plain(c, 4, 3)
    torch.cuda.synchronize()
    assert vk.LAUNCHES["grid_mesh"] == before + 1
    diff = (k - p).abs()
    ok = ((diff <= 2e-3 * p.abs()) | (diff <= 1e-5)).all(-1)
    assert ok.float().mean().item() >= 0.98
    img = tv.render_persistent(scene, cam, film, spp=4, cfg=CFG, seed=3,
                               device=dev)
    assert vk.LAUNCHES["grid_mesh"] == before + 2
    assert torch.equal(img, k)
    # the kernel reads the tables as float4s: a view one float in raises
    shifted = torch.empty(c.tris.numel() + 1, device=dev)[1:].view_as(c.tris)
    shifted.copy_(c.tris)
    with pytest.raises(ValueError):
        vk.render_grid(dataclasses.replace(c, tris=shifted), 1, 3)


def test_grid_tris_kernel_relabel_quad(dev):
    """The medium-relabel regression on the card: a mirror quad at 45
    degrees wound inward (its normal away from the camera, vacuum labelled
    on the camera's side), reflecting into an absorbing slab; B2b against
    its plain version (the scene and the torch half are
    tests/test_torch_volpath_teaser.py's relabel_scene)."""
    from vspg_pbrt_v4_tpu_torch.models.materials import Materials
    from vspg_pbrt_v4_tpu_torch.models.media import GridMedium, Media
    from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry

    c, u, v = np.array([-0.2, 0, 0]), np.array([0.3, 0, 0.3]), np.array(
        [0, 0.4, 0])
    p = [c - u - v, c + u - v, c + u + v, c - u + v]
    quad = [dict(p0=tuple(p[a]), p1=tuple(p[b]), p2=tuple(p[cc]), mat=0,
                 med_in=-1, med_out=0)
            for (a, b, cc) in ((0, 1, 2), (0, 2, 3))]
    box = dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1,
               med_in=0, med_out=-1)
    x = np.linspace(-1, 1, 16)
    X = np.meshgrid(x, x, x, indexing="ij")[0]
    slab = GridMedium.make(np.where(X > 0.2, 4.0, 0.0).astype(np.float32),
                           [1.0] * 3, [1.0] * 3, (-1, -1, -1), (1, 1, 1),
                           g=0.3, maj_res=8, device=dev)
    scene = tv.Scene(Geometry.build([box], quad, device=dev),
                     Materials.build([dict(type=1, albedo=(0.95,) * 3)],
                                     device=dev),
                     Media.make(grids=(slab,), device=dev),
                     vk.make_cloud64_scene(device=dev).lights)
    c = vk.extract_constants(scene, vk.bench_camera(48, device=dev),
                             RGBFilm.make((48, 48), device=dev), CFG)
    counts = {}
    k = vk.render(c, 8, 5)
    p = vk.render_grid_plain(c, 8, 5, counts)
    assert counts["surface_events"] > 0
    diff = (k - p).abs()
    ok = ((diff <= 2e-3 * p.abs()) | (diff <= 1e-5)).all(-1)
    assert ok.float().mean().item() >= 0.98


def test_wrapper_checks_inputs(dev):
    c = _consts(vk.make_cloud64_scene, 16, dev)
    bad = vk.KernelConstants(c.kind, c.nx, c.ny, c.imaging_ratio, c.fconst,
                             c.iconst, c.density.double(), c.majorant)
    with pytest.raises(ValueError):
        vk.render_grid(bad, 1, 0)
    with pytest.raises(ValueError):
        vk.render_grid(c, 0, 0)


GRID_SCENES = {
    "none": lambda dev: vk.make_cloud64_scene(device=dev),
    "sweep": lambda dev: vk.make_machines_scene(device=dev),
    "bvh": lambda dev: vk.make_machines_scene(mesh=True, device=dev)}


def _grid_consts(dev, geom, res):
    c = vk.extract_constants(GRID_SCENES[geom](dev),
                             vk.bench_camera(res, device=dev),
                             RGBFilm.make((res, res), device=dev), CFG)
    assert (c.tris is None) == (geom == "none")
    assert (c.nodes is not None) == (geom == "bvh")
    return c


@pytest.mark.parametrize("geom", list(GRID_SCENES))
def test_grid_items_match_plain(dev, geom):
    """B2a-c per item: the item kernel's (sample, pixel) radiances on a grid
    cut to 4 items a thread, at 4 spp (the per-pixel -O3 builds lost warps'
    samples from the third on, ROADMAP.md section C 1), against the plain
    per-item version on the same random stream: 0.9999 of items within
    1e-3 relative or 1e-5 absolute, and no item that the kernel reads as 0
    where the plain version does not."""
    c = _grid_consts(dev, geom, 64)
    spp = 4
    blocks = c.nx * c.ny * spp // (128 * 4)
    k = vk.grid_items(c, 11, 0, spp, blocks=blocks)
    p = vk.render_grid_items_plain(c, spp, 11)
    torch.cuda.synchronize()
    diff = (k - p).abs()
    ok = ((diff <= 1e-3 * p.abs()) | (diff <= 1e-5)).all(-1)
    assert ok.float().mean().item() >= 0.9999
    assert int(((k == 0).all(-1) & (p != 0).any(-1)).sum()) == 0


@pytest.mark.parametrize("geom", list(GRID_SCENES))
def test_grid_chunks_blocks_runs_agree(dev, geom, monkeypatch):
    """B2a-c's image: one chunk of samples against three (the sum carried
    across chunks), one persistent block against the full grid, and two
    runs, each bit for bit; one item launch a chunk."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    c = _grid_consts(dev, geom, 32)
    name = {"none": "grid", "sweep": "grid_tris", "bvh": "grid_mesh"}[geom]
    before = vk.LAUNCHES[name]
    one = vk.render_grid(c, 3, 9)
    assert vk.LAUNCHES[name] == before + 1
    assert torch.equal(vk.render_grid(c, 3, 9), one)
    assert torch.equal(vk.render_grid(c, 3, 9, blocks=1), one)
    monkeypatch.setattr(sk, "SCRATCH_BYTES", 12 * c.nx * c.ny)
    before = vk.LAUNCHES[name]
    assert torch.equal(vk.render_grid(c, 3, 9), one)
    assert vk.LAUNCHES[name] == before + 3
    assert bool(torch.isfinite(one).all()) and one.mean().item() > 0


def _vspg_inputs(dev, res=48, waves=2, mode="ris", method="resampling",
                 scene="cloud", adaptive=False):
    """VSPG kernel inputs on the bench's pyro cloud (or the teaser
    machines in it), the field and ISGB trained by `waves` record waves,
    for direction mode `mode` and distance route `method` (NDS+ with a
    TrBuffer varying per pixel); `adaptive`: an adaptive field (1024 extra
    leaves, refined after each wave at threshold 16)."""
    from vspg_pbrt_v4_tpu_torch.models.integrators import vspg
    from vspg_pbrt_v4_tpu_torch.models.integrators.guided_volpath import (
        GuidingOptions)
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    cfg = tv.VolPathConfig(max_depth=64, max_events=256, max_collisions=4096)
    gopt = GuidingOptions(field_res=8, record_depth=6, min_train_weight=16.0,
                          train_waves=waves,
                          adaptive_extra=1024 if adaptive else 0,
                          refine_threshold=16.0)
    vopt = vspg.VSPGOptions(vsp_criterion="contribution")
    scene = (sk.make_pyro64_scene(device=dev) if scene == "cloud"
             else vk.make_machines_scene(device=dev))
    cam = vk.bench_camera(res, device=dev)
    film = RGBFilm.make((res, res), device=dev)
    _, field, isgb = vspg.render_vspg(scene, cam, film, spp=waves, cfg=cfg,
                                      gopt=gopt, vopt=vopt, seed=2,
                                      device=dev)
    tr = None
    if method == "nds+":
        rng = np.random.default_rng(8)
        tr = torch.as_tensor(rng.uniform(0.3, 1.0, (res * res, 3)).astype(
            np.float32), device=dev)
    return sk.kernel_inputs(scene, cam, film, cfg, gopt._replace(mode=mode),
                            vopt._replace(sampling_method=method), field,
                            isgb, tr)


def _render_items_against_plain(c, g, ftab, itab, spp=4, seed=7):
    """The render kernel on a grid cut to at least 4 items a thread (the
    per-lane item loop's check: ptxas lost warps' later samples in such a
    loop, ROADMAP.md section C 1), and its per-pixel plain version, at 4
    spp so that the items of one pixel start at several samples and the
    reduce adds several terms; no item and no pixel reaches the cap.
    Returns both images."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    blocks = max(1, c.nx * c.ny * spp // (128 * 4))
    k, at_cap = sk.render_vspg_items(c, g, ftab, itab, spp, seed,
                                     blocks=blocks)
    counts = {}
    p = sk.render_vspg_plain(c, g, ftab, itab, spp, seed, counts)
    assert at_cap.tolist() == [0] and counts["capped"] == 0
    return k, p


@pytest.mark.parametrize("scene", ["cloud", "machines"])
@pytest.mark.parametrize("method", ["resampling", "nds", "nds+"])
@pytest.mark.parametrize("mode", ["ris", "mis"])
@pytest.mark.parametrize("variant", ["render", "record"])
def test_vspg_kernel_matches_plain(dev, variant, mode, method, scene):
    """B3a/B4a (resampling) and B3b/B4b (NDS, NDS+ with its TrBuffer as
    ISGB rows 3-5) against their plain versions on a trained field, in
    both direction modes: built without FMA contraction, the kernel rounds
    as the plain version's separate ops do; 0.98 leaves room for a last-bit
    difference of a transcendental flipping a branch."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    c, g, ftab, itab = _vspg_inputs(dev, mode=mode, method=method,
                                    scene=scene)
    assert g.ris == (mode == "ris")
    assert itab.shape[0] == (6 if method == "nds+" else 3)
    # B3c/B4c, the TRIS instantiations, count apart
    name = "vspg_" + variant + ("_tris" if scene == "machines" else "")
    before = sk.LAUNCHES[name]
    if variant == "render":
        k, p = _render_items_against_plain(c, g, ftab, itab)
    else:
        k, rk = sk.train_wave_kernel(c, g, ftab, itab, 7, 6)
        p, rp = sk.train_wave_plain(c, g, ftab, itab, 7, 6)
        d = (rk - rp).abs()
        ok = ((d <= 1e-3 * rp.abs()) | (d <= 1e-5)).all(0).all(0)
        assert ok.float().mean().item() >= 0.98
    torch.cuda.synchronize()
    assert sk.LAUNCHES[name] == before + 1
    diff = (k - p).abs()
    ok = ((diff <= 1e-3 * p.abs()) | (diff <= 1e-5)).all(-1)
    assert ok.float().mean().item() >= 0.98


@pytest.mark.parametrize("scene", ["cloud", "machines"])
@pytest.mark.parametrize("method", ["resampling", "nds"])
@pytest.mark.parametrize("variant", ["render", "record"])
def test_vspg_kernel_adaptive_matches_plain(dev, variant, method, scene):
    """B3d/B4d: the kernel on a refined adaptive field against its plain
    version (RIS), with the bar of the uniform field's test; some queries
    resolve through a child leaf."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    c, g, ftab, itab = _vspg_inputs(dev, waves=4, method=method,
                                    scene=scene, adaptive=True)
    assert g.cells is not None and ftab.shape[1] == 512 + 1024
    assert bool(g.cells[2].any()), "no cell was refined"
    name = ("vspg_" + variant + ("_tris" if scene == "machines" else "")
            + "_adaptive")
    before = sk.LAUNCHES[name]
    if variant == "render":
        k, p = _render_items_against_plain(c, g, ftab, itab)
    else:
        k, rk = sk.train_wave_kernel(c, g, ftab, itab, 7, 6)
        p, rp = sk.train_wave_plain(c, g, ftab, itab, 7, 6)
        d = (rk - rp).abs()
        ok = ((d <= 1e-3 * rp.abs()) | (d <= 1e-5)).all(0).all(0)
        assert ok.float().mean().item() >= 0.98
    torch.cuda.synchronize()
    assert sk.LAUNCHES[name] == before + 1
    diff = (k - p).abs()
    ok = ((diff <= 1e-3 * p.abs()) | (diff <= 1e-5)).all(-1)
    assert ok.float().mean().item() >= 0.98


@pytest.mark.parametrize("scene", ["cloud", "machines"])
def test_vspg_record_persistent_blocks(dev, scene):
    """B4a/B4c: the record variant's pixels run on persistent blocks, the
    lanes of a warp taking them from a counter; at 1 and 3 blocks (18 and
    6 pixels a thread) and at the full grid, the image and every record
    row are train_wave_plain's bit for bit (each pixel's path, its random
    stream and its rows are its own, whichever lane runs it), and the
    pixels at the cap are the plain version's (none here)."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    c, g, ftab, itab = _vspg_inputs(dev, scene=scene)
    counts = {}
    p, rp = sk.train_wave_plain(c, g, ftab, itab, 7, 6, counts)
    name = "vspg_record" + ("_tris" if scene == "machines" else "")
    for blocks in (1, 3, None):
        before = sk.LAUNCHES[name]
        k, rk, cap = sk.train_wave_items(c, g, ftab, itab, 7, 6,
                                         blocks=blocks)
        torch.cuda.synchronize()
        assert sk.LAUNCHES[name] == before + 1
        assert torch.equal(k, p) and torch.equal(rk, rp), blocks
        assert cap.tolist() == [counts["capped"]] == [0]
    grid = sk.render_grid(c, g, variant="record")
    assert grid["blocks"] == grid["per_sm"] * grid["sms"] > 0


def _thin_slab_inputs(dev, method="resampling"):
    """VSPG kernel inputs on a grid slab 1.5e-4 deep along the camera axis
    under a constant environment (tests/test_torch_box_exit.py's scene,
    built without JAX): the entry nudge of 1e-4 leaves every crossing lane
    0.5e-4 from the exit. A fresh field and ISGB, with every primary ray
    guided (ISGB VSP 0.5)."""
    from vspg_pbrt_v4_tpu_torch.models.cameras import PerspectiveCamera
    from vspg_pbrt_v4_tpu_torch.models.guiding.isgb import ISGB
    from vspg_pbrt_v4_tpu_torch.models.integrators import vspg
    from vspg_pbrt_v4_tpu_torch.models.integrators.guided_volpath import (
        GuidingOptions)
    from vspg_pbrt_v4_tpu_torch.models.lights import Lights
    from vspg_pbrt_v4_tpu_torch.models.materials import Materials
    from vspg_pbrt_v4_tpu_torch.models.media import GridMedium, Media
    from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
    from vspg_pbrt_v4_tpu_torch.utils import transform as ttr

    h, res = 0.75e-4, 32
    dens = np.random.default_rng(11).uniform(0.5, 1.5, (4, 4, 2))
    gm = GridMedium.make(dens.astype(np.float32), [40.0] * 3, [60.0] * 3,
                         (-1, -1, -h), (1, 1, h), g=0.0, maj_res=2,
                         device=dev)
    box = dict(bmin=(-1, -1, -h), bmax=(1, 1, h), mat=-1, light=-1,
               med_in=0, med_out=-1)
    scene = tv.Scene(Geometry.build(boxes=[box], device=dev),
                     Materials.build([], device=dev),
                     Media.make(grids=(gm,), device=dev),
                     Lights.make(env_L=[0.5, 0.6, 0.7], world_radius=100.0,
                                 device=dev))
    cam = PerspectiveCamera.make(
        ttr.look_at((0, 0, -4), (0, 0, 0), (0, 1, 0), device=dev), 20.0,
        (res, res), device=dev)
    film = RGBFilm.make((res, res), device=dev)
    cfg = tv.VolPathConfig(max_depth=8, max_events=4)
    gopt = GuidingOptions(field_res=4, record_depth=4, min_train_weight=16.0)
    vopt = vspg.VSPGOptions(vsp_criterion="variance",
                            sampling_method=method)
    field = vspg._scene_field(scene, gopt, dev)
    isgb = ISGB.make(film.resolution, vopt.vsp_criterion, vopt.denoiser,
                     device=dev)
    c, g, ftab, itab = sk.kernel_inputs(scene, cam, film, cfg, gopt, vopt,
                                        field, isgb)
    itab[0] = 0.5
    return c, g, ftab, itab


@pytest.mark.parametrize("method", ["resampling", "nds"])
def test_vspg_thin_slab_nothing_at_cap(dev, method):
    """ROADMAP.md section C 4 on the card: on the thin slab every crossing
    lane's guided walk starts 0.5e-4 from the exit and ends there; no
    record pixel and no render item reaches the iteration cap, no pixel is
    black, and both variants match their plain versions bit for bit."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    c, g, ftab, itab = _thin_slab_inputs(dev, method)
    k, rk, cap = sk.train_wave_items(c, g, ftab, itab, 9, 4, blocks=2)
    counts = {}
    p, rp = sk.train_wave_plain(c, g, ftab, itab, 9, 4, counts)
    torch.cuda.synchronize()
    assert cap.tolist() == [0] and counts["capped"] == 0
    assert counts["exit_walks"] >= c.nx * c.ny, counts
    assert torch.equal(k, p) and torch.equal(rk, rp)
    assert bool((k.sum(-1) > 0).all())
    img, cap_r = sk.render_vspg_items(c, g, ftab, itab, 4, 5, blocks=8)
    ref = sk.render_vspg_plain(c, g, ftab, itab, 4, 5)
    torch.cuda.synchronize()
    assert cap_r.tolist() == [0]
    assert torch.equal(img, ref) and bool((img.sum(-1) > 0).all())


@pytest.mark.parametrize("C", [32, 256])
@pytest.mark.parametrize("variant", ["global", "shared"])
def test_gather_kernel_matches_plain(dev, variant, C):
    """M: both table placements bit for bit with the plain version, for
    every block of a full card."""
    from vspg_pbrt_v4_tpu_torch.benchmarks import gather_microbench as gm

    table = torch.as_tensor(gm.make_table(C), device=dev)
    before = gm.LAUNCHES["gather_" + variant]
    k = gm.gather(table, 9, C, 64, 132 * 8, variant)
    p = gm.gather_plain(table, 9, C, 64, 132 * 8)
    torch.cuda.synchronize()
    assert gm.LAUNCHES["gather_" + variant] == before + 1
    assert torch.equal(k, p)


def test_vspg_launch_events(dev):
    """While LAUNCH_EVENTS is a list, each launch adds its timed events;
    with it None (the default) nothing is recorded."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    c, g, ftab, itab = _vspg_inputs(dev, res=16, waves=1)
    sk.LAUNCH_EVENTS = []
    try:
        sk.render_vspg_kernel(c, g, ftab, itab, 1, 0)
        sk.train_wave_kernel(c, g, ftab, itab, 0, 2)
        torch.cuda.synchronize()
        events = sk.LAUNCH_EVENTS
    finally:
        sk.LAUNCH_EVENTS = None
    assert [e[0] for e in events] == ["vspg_render", "vspg_record"]
    assert all(start.elapsed_time(end) > 0 for _, start, end in events)
    sk.render_vspg_kernel(c, g, ftab, itab, 1, 0)
    assert sk.LAUNCH_EVENTS is None


def test_vspg_render_chunks_and_grids_agree(dev):
    """The render's image is the same float for float whatever the persistent
    grid and however the samples are cut into chunks of the scratch (each
    chunk's reduce adds onto the running sum in sample order)."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    c, g, ftab, itab = _vspg_inputs(dev, res=32, waves=1)
    whole, cap = sk.render_vspg_items(c, g, ftab, itab, 8, 3)
    small, _ = sk.render_vspg_items(c, g, ftab, itab, 8, 3, blocks=3)
    before = dict(sk.LAUNCHES)
    scratch = sk.SCRATCH_BYTES
    sk.SCRATCH_BYTES = 3 * 32 * 32 * 16  # 3 samples a chunk: 3 + 3 + 2
    try:
        chunked, cap_c = sk.render_vspg_items(c, g, ftab, itab, 8, 3)
    finally:
        sk.SCRATCH_BYTES = scratch
    torch.cuda.synchronize()
    assert sk.LAUNCHES["vspg_render"] == before["vspg_render"] + 3
    assert sk.LAUNCHES["vspg_reduce"] == before["vspg_reduce"] + 3
    assert torch.equal(whole, small) and torch.equal(whole, chunked)
    assert int(cap) == int(cap_c) == 0


@pytest.mark.parametrize("scene,method", [("cloud", "resampling"),
                                          ("cloud", "nds"),
                                          ("machines", "resampling")])
def test_vspg_render_row_blocks_stitch(dev, scene, method):
    """B3 with a pixel base: the image's rows rendered as four blocks
    (``parallel/mesh.render_block``, bases 0, npix/4, ...) stitch into the
    whole render float for float, one launch and one reduce a block; a
    block against its plain version with the same base, bit for bit."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
    from vspg_pbrt_v4_tpu_torch.parallel import mesh

    c, g, ftab, itab = _vspg_inputs(dev, res=32, waves=1, method=method,
                                    scene=scene)
    whole = sk.render_vspg_kernel(c, g, ftab, itab, 4, 3)
    name = "vspg_render" + ("_tris" if scene == "machines" else "")
    before = dict(sk.LAUNCHES)
    parts = []
    for r in range(4):
        parts.append(mesh.render_block(c, g, ftab, itab, r, 4, 4, 3)[0])
        if r == 2:
            cb, it, base = mesh.row_block(c, itab, r, 4)
            p = sk.render_vspg_plain(cb, g, ftab, it, 4, 3, pix_base=base)
            assert torch.equal(parts[-1], p)
    torch.cuda.synchronize()
    assert sk.LAUNCHES[name] == before[name] + 4
    assert sk.LAUNCHES["vspg_reduce"] == before["vspg_reduce"] + 4
    assert torch.equal(torch.cat(parts, 0), whole)


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("scene,method,max_events", [
    ("cloud", "resampling", 1), ("machines", "nds", 2)])
def test_vspg_render_cap_matches_plain(dev, scene, method, max_events,
                                       chunks, monkeypatch):
    """With max_events cut to 1 or 2 the pixel's iteration cap (8 spp x
    max_events x 12) cuts samples in many pixels; the per-pixel loop loses
    the sample the cap cuts and every later one, and the reduce drops the
    same samples from the items' iteration counts, in one chunk of the
    scratch or carried across three. So the kernel's image is the per-pixel
    plain version's bit for bit, at 4 items a thread, with items stopped at
    the cap."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    res, spp = 32, 8
    c, g, ftab, itab = _vspg_inputs(dev, res=res, waves=1, method=method,
                                    scene=scene)
    ic = c.iconst.clone()
    ic[vk.I_MAX_EVENTS] = max_events
    c = dataclasses.replace(c, iconst=ic)
    if chunks > 1:
        monkeypatch.setattr(sk, "SCRATCH_BYTES", 3 * res * res * 16)
    before = sk.LAUNCHES["vspg_reduce"]
    k, at_cap = sk.render_vspg_items(c, g, ftab, itab, spp, 5,
                                     blocks=res * res * spp // (128 * 4))
    counts = {}
    p = sk.render_vspg_plain(c, g, ftab, itab, spp, 5, counts)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["vspg_reduce"] == before + chunks
    assert int(at_cap) > 0 and 0 < counts["capped"] < res * res
    assert torch.equal(k, p)


def test_vspg_render_raises_without_fallback(dev, monkeypatch):
    """A launch the card refuses (a majorant grid too large for shared
    memory, past the wrapper's own limit) and a scratch that cannot be
    allocated raise; nothing falls back to the plain version."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    c, g, ftab, itab = _vspg_inputs(dev, res=16, waves=1)
    monkeypatch.setattr(sk, "render_vspg_plain", None)
    n = 128
    ic = c.iconst.clone()
    ic[vk.I_MX:vk.I_MX + 3] = n
    big = dataclasses.replace(
        c, iconst=ic, majorant=torch.ones((n, n, n), device=dev))
    monkeypatch.setattr(vk, "MAX_MAJ_VOX", n ** 3)
    with pytest.raises(RuntimeError, match="launch failed"):
        sk.render_vspg_items(big, g, ftab, itab, 1, 0)
    # 2^27 spp at one event a sample: an iteration cap within int32, and
    # a scratch of 2^27 x 256 items
    ic = c.iconst.clone()
    ic[vk.I_MAX_EVENTS] = 1
    one = dataclasses.replace(c, iconst=ic)
    monkeypatch.setattr(sk, "SCRATCH_BYTES", 1 << 62)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        sk.render_vspg_items(one, g, ftab, itab, 1 << 27, 0)
    with pytest.raises(ValueError, match="exceeds int32"):
        sk.render_vspg_items(c, g, ftab, itab, 1 << 40, 0)


def test_vspg_wrapper_checks_inputs(dev):
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    c, g, ftab, itab = _vspg_inputs(dev, res=16, waves=1)
    with pytest.raises(ValueError):
        sk.render_vspg_kernel(c, g, ftab.double(), itab, 1, 0)
    with pytest.raises(ValueError):
        sk.render_vspg_kernel(c, g, ftab[:, :-1].contiguous(), itab, 1, 0)
    with pytest.raises(ValueError):
        sk.render_vspg_kernel(c, g, ftab, itab, 0, 0)
    with pytest.raises(ValueError):
        sk.train_wave_kernel(c, g, ftab, itab, 0, 0)


@pytest.mark.parametrize("scene", ["cornell", "cornell lit", "floor"])
def test_surface_kernel_matches_plain(dev, scene):
    """B5: the Cornell class at 64^2 x 4 against its plain version on the
    same random stream (1e-3 relative on 99% of pixels, B1's bar; at 4 spp,
    since the grid header's -O3 builds lost warps from the third sample
    on); the main path's entry point takes the kernel."""
    from vspg_pbrt_v4_tpu_torch.ops import surface_kernels as pk

    make, eye, at = {
        "cornell": (tv.make_cornell_box_scene, pk.CORNELL_EYE,
                    pk.CORNELL_AT),
        "cornell lit": (pk.make_cornell_lit_scene, pk.CORNELL_EYE,
                        pk.CORNELL_AT),
        "floor": (pk.make_floor_scene, pk.FLOOR_EYE, pk.FLOOR_AT),
    }[scene]
    s = make(device=dev)
    cam, film = pk.cornell_view(64, 64, eye, at, device=dev)
    cfg = tv.VolPathConfig(max_depth=8, max_events=24)
    c = pk.extract_constants(s, cam, film, cfg)
    before = pk.LAUNCHES["surface"]
    k = tv.render_persistent(s, cam, film, spp=4, cfg=cfg, seed=3,
                             lanes_per_pixel=1, device=dev)
    p = pk.render_surface_plain(c, 4, 3)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["surface"] == before + 1
    diff = (k - p).abs()
    ok = ((diff <= 1e-3 * p.abs()) | (diff <= 1e-5)).all(-1)
    assert ok.float().mean().item() >= 0.99
    assert abs(k.mean().item() - p.mean().item()) <= 1e-3 * p.mean().item()
    with pytest.raises(ValueError):
        pk.render_surface(c, 0, 3)
    with pytest.raises(ValueError):
        pk.render_surface(dataclasses.replace(c, tris=c.tris.double()), 1, 3)


def _group_case(dev, scene, res=64):
    """(constants, item launcher (seed, samp0, n_samp, group, blocks), render,
    per-pixel plain version, per-sample plain version, LAUNCHES dict and
    key) of B1 (`scene` "fog") or B5, whose items are groups of one
    sample."""
    from vspg_pbrt_v4_tpu_torch.ops import surface_kernels as pk

    if scene == "fog":
        c = _consts(vk.make_fog_box_scene, res, dev)
        return (c, lambda *a, **k: vk.homog_items(c, *a, **k),
                vk.render_homog, vk.render_homog_plain,
                vk.render_homog_items_plain, vk.LAUNCHES, "homog")
    make, eye, at = {
        "cornell": (tv.make_cornell_box_scene, pk.CORNELL_EYE,
                    pk.CORNELL_AT),
        "cornell lit": (pk.make_cornell_lit_scene, pk.CORNELL_EYE,
                        pk.CORNELL_AT),
        "floor": (pk.make_floor_scene, pk.FLOOR_EYE, pk.FLOOR_AT),
    }[scene]
    c = pk.extract_constants(make(device=dev),
                             *pk.cornell_view(res, res, eye, at, device=dev),
                             tv.VolPathConfig(max_depth=8, max_events=24))

    def items(seed, samp0, n_samp, group, **kw):
        assert group == 1
        return pk.surface_items(c, seed, samp0, n_samp, **kw)

    return (c, items, pk.render_surface, pk.render_surface_plain,
            pk.render_surface_items_plain, pk.LAUNCHES, "surface")


def _bar(k, p):
    """B1's and B5's bar: 0.99 of pixels (or items) within 1e-3 relative or
    1e-5 absolute, means within 1e-3."""
    diff = (k - p).abs()
    ok = ((diff <= 1e-3 * p.abs()) | (diff <= 1e-5)).all(-1)
    assert ok.float().mean().item() >= 0.99
    assert abs(k.mean().item() - p.mean().item()) <= 1e-3 * p.mean().item()


@pytest.mark.parametrize("scene,group", [
    ("fog", 1), ("fog", 3), ("cornell", 1), ("cornell lit", 1),
    ("floor", 1)])
def test_group_kernels_match_plain(dev, scene, group):
    """B1 and B5 at 64^2 x 4 on the same random stream: the image against
    the per-pixel plain version, and each (group, pixel) item's sum, on a
    grid cut to 4 items a thread, against the per-sample plain version's
    group sums (B1's groups of 3: one of 3 samples and one of 1)."""
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    c, items, render, pixel_plain, items_plain, launches, key = _group_case(
        dev, scene)
    spp, npix = 4, c.nx * c.ny
    n_items = npix * -(-spp // group)
    k = items(3, 0, spp, group, blocks=max(1, n_items // (128 * 4)))
    p = vk.group_sums_plain(items_plain(c, spp, 3), group)
    before = launches[key]
    img = (render(c, spp, 3, group=group) if key == "homog"
           else render(c, spp, 3))
    torch.cuda.synchronize()
    assert launches[key] == before + 1
    _bar(k, p)
    _bar(img, pixel_plain(c, spp, 3))
    # the kernel's own sums, reduced in order, are its image
    red = sk.reduce_samples(k, None, 0, c.imaging_ratio / spp)
    assert torch.equal(red.reshape(img.shape), img)


@pytest.mark.parametrize("scene", ["fog", "cornell lit"])
def test_group_chunks_blocks_runs_agree(dev, scene, monkeypatch):
    """B1's and B5's image at 32^2 x 5 (B1 in groups of 2: 2 + 2 + 1): one
    chunk against three (the sum carried across chunks), one and three
    persistent blocks against the full grid, and two runs, each bit for
    bit; one item launch and one reduce a chunk; nothing falls back to a
    plain version on a card."""
    from vspg_pbrt_v4_tpu_torch.ops import surface_kernels as pk
    from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk

    c, _, render, _, _, launches, key = _group_case(dev, scene, res=32)
    kw = dict(group=2) if key == "homog" else {}
    monkeypatch.setattr(vk, "render_homog_plain", None)
    monkeypatch.setattr(pk, "render_surface_plain", None)
    before, red0 = launches[key], sk.LAUNCHES["vspg_reduce"]
    one = render(c, 5, 9, **kw)
    assert launches[key] == before + 1
    assert sk.LAUNCHES["vspg_reduce"] == red0 + 1
    assert torch.equal(render(c, 5, 9, **kw), one)
    assert torch.equal(render(c, 5, 9, blocks=1, **kw), one)
    assert torch.equal(render(c, 5, 9, blocks=3, **kw), one)
    # a scratch of two samples: chunks of one group of 2 (B1) or of two
    # samples (B5), three chunks either way
    monkeypatch.setattr(sk, "SCRATCH_BYTES", 2 * 12 * c.nx * c.ny
                        // (2 if key == "homog" else 1))
    before, red0 = launches[key], sk.LAUNCHES["vspg_reduce"]
    assert torch.equal(render(c, 5, 9, **kw), one)
    assert launches[key] == before + 3
    assert sk.LAUNCHES["vspg_reduce"] == red0 + 3
    assert bool(torch.isfinite(one).all()) and one.mean().item() > 0
    if key == "homog":
        # one group of all samples: the per-pixel loop's sum
        whole = render(c, 5, 9, group=5)
        diff = (whole - one).abs()
        assert bool((diff <= 1e-6 * one.abs() + 1e-12).all())


@pytest.mark.parametrize("scene", ["fog", "cornell"])
def test_group_wrappers_check_inputs(dev, scene):
    c, items, render, _, _, _, _ = _group_case(dev, scene, res=16)
    with pytest.raises(ValueError):
        render(c, 0, 0)
    with pytest.raises(ValueError):
        items(0, -1, 2, 1)
    with pytest.raises(ValueError):
        items(0, 0, 2, 1, blocks=0)
    with pytest.raises(ValueError):
        render(c, 2, 0, blocks=0)
    with pytest.raises(ValueError):
        items(0, 0, 2, 1, out=torch.empty((1, c.nx * c.ny, 3), device=dev))
    with pytest.raises(ValueError):
        render(dataclasses.replace(c, fconst=c.fconst.double()), 1, 0)
    if scene == "fog":
        with pytest.raises(ValueError):
            items(0, 0, 2, 0)
