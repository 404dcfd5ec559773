"""The sharded kernel route (``parallel/mesh.render_vspg_pallas_sharded``:
each rank renders its block of rows through the render kernel B3 with a
pixel base) on the CPU, where the render wrapper takes its plain version:
two row blocks with pixel bases 0 and npix / 2, stitched, are the
unsharded plain render bit for bit and meet JAX's interpret-mode sharded
kernel on two devices at the bar of tests/test_torch_vspg_kernel.py; on two
gloo ranks the route is ``render_frozen``'s image float for float."""

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm as JFilm
from vspg_pbrt_v4_tpu.parallel import mesh as jmesh
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as sk
from vspg_pbrt_v4_tpu_torch.parallel import dryrun, mesh

from test_torch_parallel import MESH, W, _close, _devices
from test_torch_vspg_kernel import (CFG, GOPT, QUADRANTS, RES, VOPT,
                                    bf16_table, port_inputs, trained, wave)

assert trained and wave  # module fixtures: a JAX training wave, its field


def test_kernel_route_blocks_match_jax_sharded_kernel(trained):
    """The sharded kernel route's plain version: the render kernel's plain
    version on two row blocks of the JAX-trained inputs, pixel bases 0 and
    npix / 2, stitched, is the unsharded plain render bit for bit, and
    meets JAX's render_vspg_pallas_sharded(interpret=True) on two devices
    at tests/test_torch_vspg_kernel.py's bar (0.95 of pixels within 1e-3,
    the quadrant means), fed the bf16-rounded field table as there."""
    scene, cam, film, field, isgb = trained
    ref = np.asarray(jmesh.render_vspg_pallas_sharded(
        scene, cam, film, 2, CFG, GOPT, VOPT, field, isgb, seed=9,
        mesh=_devices("rays"), interpret=True))
    c, g, ftab, itab = port_inputs(scene, cam, film, field, isgb)
    ftab = bf16_table(ftab)
    blocks = []
    for r in range(W):
        assert mesh.row_block(c, itab, r, W)[2] == r * RES * RES // W
        img, cap = mesh.render_block(c, g, ftab, itab, r, W, 2, 9)
        assert int(cap) == 0
        blocks.append(img)
    img = torch.cat(blocks, 0)
    assert torch.equal(img, sk.render_vspg_plain(c, g, ftab, itab, 2, 9))
    img = img.numpy()
    frac = _close(img, ref, atol=1e-5)
    print(f"sharded kernel route: {frac:.4f} of pixels within 1e-3")
    assert frac >= 0.95, frac
    for sl in QUADRANTS:
        a, b = ref[sl].mean(), img[sl].mean()
        assert abs(a - b) < 0.08 * max(a, 0.05), (a, b)


def test_kernel_route_ranks_equal_unsharded(trained):
    """render_vspg_pallas_sharded on two gloo ranks (each its block through
    the render wrapper's plain version) is ``render_frozen``'s image with
    the same seed float for float, on every rank's copy of the field."""
    scene, cam, film, field, isgb = trained
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    tg, tv = convert.options_from_jax(GOPT, VOPT)
    tfield = convert.field_from_jax(field, "cpu")
    tisgb = convert.isgb_from_jax(isgb, "cpu")
    img = dryrun.spawn(W, MESH + "render_vspg_pallas_sharded",
                       (ts, tc, tf, 2, tcfg, tg, tv, tfield, tisgb),
                       dict(seed=9))
    whole = sk.render_frozen(ts, tc, tf, 2, tcfg, tg, tv, tfield, tisgb,
                             seed=9)
    assert torch.equal(img, whole)


def test_kernel_route_refuses_split_rows(trained):
    """Every rank renders whole rows: 15 rows over two ranks raise (the
    JAX package's extra 128-pixel rule, its TPU lane tiling, is not
    asked)."""
    scene, cam, film, field, isgb = trained
    cam = PerspectiveCamera.make(jtr.look_at((0, 0, -4), (0, 0, 0),
                                             (0, 1, 0)), 30.0, (RES, 15))
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, JFilm.make((RES, 15)),
                                        CFG, "cpu")
    tg, tv = convert.options_from_jax(GOPT, VOPT)
    with pytest.raises(RuntimeError, match="whole rows"):
        dryrun.spawn(W, MESH + "render_vspg_pallas_sharded",
                     (ts, tc, tf, 1, tcfg, tg, tv,
                      convert.field_from_jax(field, "cpu"),
                      convert.isgb_from_jax(isgb, "cpu")))
