"""Rendering on several devices over ``torch.distributed`` (counterpart of
``parallel/mesh.py``, whose ``jax.sharding.Mesh`` axis becomes the ranks of
the default process group).

- Rows (``render_sharded``): rank r traces the contiguous pixel block
  [r npix / W, (r + 1) npix / W) for every sample, then the blocks are
  gathered in rank order; no collective until then.
- Samples (``render_spp_psum``): every rank renders the whole frame at its
  own sample indices, and the sums are all-reduced.
- The VSPG training render (``render_vspg_sharded``): film, ISGB and
  TrBuffer rows sharded by rank, each wave's training batch gathered so
  that every rank trains the same field on the whole wave, the ISGB
  gathered for each of its updates.
- The frozen-field VSPG render through the render kernel B3
  (``render_vspg_pallas_sharded``): each rank renders its block of rows
  with a pixel base (``render_block``).

The caller initialises the process group (NCCL with one rank a card, or
gloo on the CPU: ``parallel/dryrun.py`` does both); every entry point runs
on the card of its rank unless it is asked for the CPU. Every rank returns
the whole image. A lane's random stream depends on the draws its batch
made, so a rank's block holds exactly the pixels of the JAX package's
shard: the volpath entry points' images match its sharded renders pixel for
pixel, the VSPG training render's as the unsharded ``render_vspg``'s do.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models.film import FilmState
from ..models.guiding import isgb as gisgb
from ..models.integrators import volpath


def default_group(device="cuda"):
    """(rank, world size, this rank's device) of the initialised default
    process group: ``cuda:{rank % device_count}`` under NCCL (made the
    current device), the CPU under gloo when `device` is "cpu". Raises
    without a process group: there is no silent world of one."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group: call "
                           "torch.distributed.init_process_group first "
                           "(parallel/dryrun.py shows how)")
    rank, world = dist.get_rank(), dist.get_world_size()
    backend = dist.get_backend()
    if torch.device(device).type == "cpu":
        if backend != "gloo":
            raise ValueError(f"a CPU render takes the gloo backend, not "
                             f"{backend}")
        return rank, world, torch.device("cpu")
    if backend != "nccl":
        raise ValueError(f"a render on the card takes the nccl backend, not "
                         f"{backend}")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device")
    dev = torch.device(f"cuda:{rank % n}")
    torch.cuda.set_device(dev)
    return rank, world, dev


def gather_rows(t):
    """Every rank's `t` (the same shape on each) concatenated along the
    first axis in rank order, on every rank."""
    world = dist.get_world_size()
    x = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    out = torch.cat(parts, 0)
    return out.bool() if t.dtype == torch.bool else out


def _block(npix, rank, world):
    if npix % world:
        raise ValueError(f"the pixel count {npix} must divide among the "
                         f"{world} ranks")
    n = npix // world
    return rank * n, n


def render_sharded(scene, camera, film, spp, cfg, seed, *, device="cuda"):
    """Render with the pixels sharded over the ranks: each rank traces its
    contiguous block for all `spp` waves (the torch wavefront, one sample a
    pixel a wave) and keeps its own sums; the blocks are gathered at the
    end. Returns the (ny, nx, 3) image on every rank."""
    rank, world, dev = default_group(device)
    lo, n = _block(film.npix, rank, world)
    scene, camera, film = scene.to(dev), camera.to(dev), film.to(dev)
    pixel_id = torch.arange(lo, lo + n, device=dev)
    acc = torch.zeros((n, 3), device=dev)
    wacc = torch.zeros(n, device=dev)
    for i in range(int(spp)):
        s, fw = volpath.start_camera_paths(camera, film,
                                           int(seed) & 0xFFFFFFFF, i,
                                           pixel_id, -1)
        s = volpath.trace_paths(scene, cfg, s)
        acc = acc + s.L * fw[:, None]
        wacc = wacc + fw
    rgb = gather_rows(acc / torch.clamp(wacc, min=1e-12)[:, None])
    nx, ny = film.resolution
    return (rgb * film.imaging_ratio).reshape(ny, nx, 3)


def render_spp_psum(scene, camera, film, spp_per_device, cfg, seed, *,
                    device="cuda"):
    """Render with the samples sharded over the ranks: rank r renders the
    whole frame at sample indices r * spp_per_device + i, the sums are
    all-reduced and divided by the samples of all ranks. Returns the (ny,
    nx, 3) image on every rank."""
    rank, world, dev = default_group(device)
    scene, camera, film = scene.to(dev), camera.to(dev), film.to(dev)
    pixel_id = torch.arange(film.npix, device=dev)
    acc = torch.zeros((film.npix, 3), device=dev)
    for i in range(int(spp_per_device)):
        s, fw = volpath.start_camera_paths(
            camera, film, int(seed) & 0xFFFFFFFF,
            rank * int(spp_per_device) + i, pixel_id, -1)
        s = volpath.trace_paths(scene, cfg, s)
        acc = acc + s.L * fw[:, None]
    dist.all_reduce(acc)
    rgb = acc / (int(spp_per_device) * world)
    nx, ny = film.resolution
    return (rgb * film.imaging_ratio).reshape(ny, nx, 3)


def isgb_rows(buf, lo, n):
    """The ISGB's rows [lo, lo + n) (its resolution stays the image's)."""
    return dataclasses.replace(buf, **{k: getattr(buf, k)[lo:lo + n]
                                       for k in gisgb._ARRAYS})


def gather_isgb(buf):
    """The whole ISGB from every rank's rows, on every rank."""
    return dataclasses.replace(buf, **{k: gather_rows(getattr(buf, k))
                                       for k in gisgb._ARRAYS})


def render_vspg_sharded(scene, camera, film, spp, cfg=None, gopt=None,
                        vopt=None, seed=0, spp_per_pass=1, train=True, *,
                        device="cuda"):
    """VSPG on several devices through the torch wave (the JAX package's
    XLA wave; no kernel serves it in either package). Lanes, film, ISGB
    and TrBuffer rows are sharded by rank, pixel-major. Each wave's
    training batch is gathered in rank order, so that its rows come in the
    whole wave's order, and every rank runs the same EM step on it (its
    weight clamp is a quantile of the whole wave, which per-rank sums
    cannot give); so every rank holds the same field. Before each ISGB
    update every rank gathers the ISGB rows (the à-trous passes cross the
    blocks, the U-Net trains on the whole image), updates, and keeps its
    own. The field covers the scene's bounds, uniform, as the JAX
    package's. Returns (image, field, isgb), all whole, on every rank."""
    from ..models.guiding.isgb import ISGB
    from ..models.integrators import guided_volpath as gvp
    from ..models.integrators import vspg as vs

    cfg = cfg or volpath.VolPathConfig()
    gopt = gopt or gvp.GuidingOptions()
    vopt = vopt or vs.VSPGOptions()
    rank, world, dev = default_group(device)
    npix = film.npix
    lo, n = _block(npix, rank, world)
    scene, camera, film = scene.to(dev), camera.to(dev), film.to(dev)
    field = gvp._scene_field(scene, gopt._replace(adaptive_extra=0), dev)
    isgb = isgb_rows(ISGB.make(film.resolution, vopt.vsp_criterion,
                               vopt.denoiser, device=dev), lo, n)
    film_state = FilmState(torch.zeros((n, 3), device=dev),
                           torch.zeros(n, device=dev))
    tr_buffer = (torch.ones((n, 3), device=dev)
                 if vopt.sampling_method == "nds+" else None)
    spp_per_pass = int(spp_per_pass)
    lane = torch.arange(n * spp_per_pass, device=dev)
    pixel_id = lo + lane // spp_per_pass  # pixel-major: contiguous blocks
    for wave in range(int(spp) // spp_per_pass):
        do_train = train and field.iteration < gopt.train_waves
        film_state, isgb, batch, tr = vs.vspg_wave(
            scene, camera, film, film_state, field, isgb, cfg, gopt, vopt,
            seed, wave, -1, bool(train), spp_per_pass, tr_buffer, pixel_id,
            lo)
        if tr_buffer is not None:
            tr_pix = tr.reshape(n, spp_per_pass, 3).mean(1)
            tr_buffer = (tr_pix if wave == 0
                         else (tr_buffer * wave + tr_pix) / (wave + 1))
        if do_train:
            batch = type(batch)(*(gather_rows(x) for x in batch))
            total_w = float(torch.sum(torch.where(batch.valid, batch.weight,
                                                  0.0)))
            if total_w > gopt.min_train_weight:
                field = gvp.train_step(field, batch)
        if (wave + 1) in vopt.isgb_update_waves:
            isgb = isgb_rows(gisgb.isgb_update(gather_isgb(isgb)), lo, n)
    state = FilmState(*(gather_rows(x) for x in film_state))
    return film.image(state), field, gather_isgb(isgb)


def render_vspg_pallas_sharded(scene, camera, film, spp, cfg, gopt, vopt,
                               field, isgb, seed=0, tr_buffer=None, *,
                               device="cuda"):
    """The frozen-field VSPG render on several devices through the render
    kernel (B3a/b/d): each rank renders its block of whole rows with the
    block's first pixel as its pixel base, so that its pixels keep the
    random streams and camera rays of the unsharded render; the tables are
    the same on every rank, the ISGB table holds the rank's rows. The
    blocks stitched in rank order are the image of
    ``vspg_kernels.render_frozen`` with the same seed, float for float. On
    CPU tensors the kernel's plain version renders the blocks. Guards as
    the JAX package's: a grid scene with no triangles. Returns the (ny,
    nx, 3) mean image on every rank."""
    from ..ops import vspg_kernels as sk
    from ..ops.volpath_kernels import extract_constants

    rank, world, dev = default_group(device)
    scene, camera, film = scene.to(dev), camera.to(dev), film.to(dev)
    field, isgb = field.to(dev), isgb.to(dev)
    c = extract_constants(scene, camera, film, cfg)
    if c is None or c.kind != "grid" or c.n_tri:
        raise ValueError("scene not supported by the sharded VSPG kernel "
                         "route (a grid cloud with no triangles)")
    if c.ny % world:
        raise ValueError(f"film rows must shard into whole rows: {c.ny} "
                         f"rows over {world} ranks (whole rows only: the "
                         "JAX package's further 128-pixel multiple is its "
                         "TPU lane tiling, which this kernel does not have)")
    c, g, ftab, itab = sk.kernel_inputs(scene, camera, film, cfg, gopt, vopt,
                                        field, isgb, tr_buffer)
    return gather_rows(render_block(c, g, ftab, itab, rank, world, spp,
                                    seed)[0])


def row_block(c, itab, rank, world):
    """Rank `rank`'s block of `world` equal blocks of whole rows of the
    image of kernel constants `c`: (the block's constants, its columns of
    the ISGB table `itab`, its first image pixel)."""
    from ..ops import vspg_kernels as sk

    cb, base = sk.block_constants(c, rank, world)
    n = cb.nx * cb.ny
    return cb, itab[:, base:base + n].contiguous(), base


def render_block(c, g, ftab, itab, rank, world, spp, seed, blocks=None):
    """B3 on rank `rank`'s block of rows (``row_block``) with the block's
    first pixel as its pixel base: (the block's (ny / world, nx, 3) image,
    its items at the cap), as ``vspg_kernels.render_vspg_items`` gives them
    (the kernel on a card, its plain version on the CPU). The blocks of
    all ranks stitched in rank order are the whole render float for
    float. Needs no process group."""
    from ..ops import vspg_kernels as sk

    cb, it, base = row_block(c, itab, rank, world)
    return sk.render_vspg_items(cb, g, ftab, it, spp, seed, blocks=blocks,
                                pix_base=base)
