"""The mesh class in the volpath arm: 576 loop-subdivided machine triangles
in a grid cloud (tests/test_teaser_kernel.py's ``_mesh_scene(2)``, whose
BVH both packages build natively), at 16^2.

- ``render_persistent(backend="torch")`` against the JAX package's XLA
  ``render_persistent(backend="jnp")``: the same lockstep wavefront
  walking the same tree on the same random stream, so pixel for pixel.
- B2c's plain version (``render_grid_plain`` on the mesh class's tables:
  its own random stream, a brute-force closest hit) against the torch
  path: Monte Carlo agreement in the bands of
  tests/test_torch_kernel_grid.py.
- ``render_grid_plain(pixels=)``: a crop renders as the whole image does.
- The kernel's gate: the mesh class up to MAX_TRIS_MESH triangles, no
  textured albedo on a mesh.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu_torch.convert import from_jax
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.models.materials import Materials
from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
from vspg_pbrt_v4_tpu_torch.models.textures import Textures
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk

from test_teaser_kernel import _mesh_scene
from test_torch_kernel_grid import assert_mc_agree


@pytest.fixture(scope="module")
def mesh():
    """The JAX XLA render at 16^2 x 2 spp (about 30 s on a CPU) and the
    port's scene, camera, film and config."""
    scene, cam, film, cfg, n_tri = _mesh_scene(2)
    assert n_tri == 576
    ref = np.asarray(jv.render_persistent(scene, cam, film, spp=2, cfg=cfg,
                                          seed=5, backend="jnp"))
    return ref, from_jax(scene, cam, film, cfg, "cpu")


def test_render_persistent_matches_jax_mesh(mesh):
    """Pixel for pixel (1e-3 relative; a rare last-ulp branch flip may move
    a pixel further), as for the teaser class."""
    ref, (ts, tc, tf, tcfg) = mesh
    assert ts.geometry.tri_bvh is not None
    img = tv.render_persistent(ts, tc, tf, spp=2, cfg=tcfg, seed=5,
                               backend="torch", device="cpu").numpy()
    d = np.abs(img - ref)
    frac = ((d <= 1e-3 * np.abs(ref)) | (d <= 1e-6)).all(-1).mean()
    print(f"mesh render_persistent: {frac:.4f} of pixels within 1e-3")
    assert frac >= 0.99, frac
    assert ref.mean() > 0


def test_grid_mesh_plain_matches_torch_path(mesh):
    """B2c's plain version at 256 spp against the torch path at 32 spp
    (another estimator of the same image on other random streams)."""
    _, (ts, tc, tf, tcfg) = mesh
    c = vk.extract_constants(ts, tc, tf, tcfg)
    assert c.kind == "grid" and c.n_tri == 576 and c.nodes is not None
    counts = {}
    img = vk.render_grid_plain(c, 256, 7, counts).numpy()
    assert counts["surface_events"] > 0 and counts["tri_queries"] > 0
    ref = tv.render_persistent(ts, tc, tf, spp=32, cfg=tcfg, seed=6,
                               lanes_per_pixel=32, backend="torch",
                               device="cpu").numpy()
    assert_mc_agree(img, ref)


def test_grid_plain_renders_a_crop(mesh):
    """render_grid_plain(pixels=) renders the chosen pixels as the whole
    render does (same lanes, same random stream) and leaves the rest 0:
    the crop chip_smoke holds B2c to at the main path's 8 spp."""
    _, (ts, tc, tf, tcfg) = mesh
    c = vk.extract_constants(ts, tc, tf, tcfg)
    full = vk.render_grid_plain(c, 2, 3).numpy().reshape(-1, 3)
    pix = (np.arange(4, 12)[:, None] * 16 + np.arange(2, 10)).ravel()
    part = vk.render_grid_plain(c, 2, 3, pixels=torch.from_numpy(
        pix)).numpy().reshape(-1, 3)
    np.testing.assert_allclose(part[pix], full[pix], rtol=1e-6, atol=1e-7)
    rest = np.setdiff1d(np.arange(256), pix)
    assert (part[rest] == 0).all() and (full[pix] > 0).any()


def _with(ts, tris, materials=None, textures=None):
    """The port's scene `ts` with the triangles `tris` (and materials)."""
    g = ts.geometry
    box = dict(bmin=g.box_min[0].tolist(), bmax=g.box_max[0].tolist(),
               mat=-1, light=-1, med_in=0, med_out=-1)
    return dataclasses.replace(
        ts, geometry=Geometry.build([box], tris, device="cpu"),
        materials=materials or ts.materials, textures=textures)


def test_mesh_gate(mesh):
    """576 triangles take B2c's tables: the triangle rows in the tree's
    leaf order and one node row a node. A checker albedo keeps a mesh off
    the kernel (pallas_volpath's gate), and so do 16385 triangles."""
    _, (ts, tc, tf, tcfg) = mesh
    g = ts.geometry
    c = vk.extract_constants(ts, tc, tf, tcfg)
    order = g.tri_bvh.prim_ids.long()
    assert c.tris.shape == (576, vk.TRI_COLS)
    assert np.array_equal(c.tris[:, vk.T_P0:vk.T_P0 + 3].numpy(),
                          g.tri_p0[order].numpy())
    assert c.nodes.shape == (g.tri_bvh.n_nodes, vk.NODE_COLS)
    leaf = g.tri_bvh.count > 0
    assert np.array_equal(c.nodes[:, vk.N_INDEX].numpy(),
                          np.where(leaf, g.tri_bvh.start,
                                   g.tri_bvh.right).astype(np.float32))
    tris = [dict(p0=g.tri_p0[i].tolist(), p1=g.tri_p1[i].tolist(),
                 p2=g.tri_p2[i].tolist(), mat=int(g.tri_mat[i]),
                 med_in=-1, med_out=0) for i in range(576)]
    # a checker albedo on the diffuse material (id 0)
    tex = Textures.build([dict(kind=1, c0=(0.9,) * 3, c1=(0.1,) * 3,
                               uvscale=(4.0, 4.0))], device="cpu")
    mats = Materials.build([dict(type=0, albedo=(0.7, 0.4, 0.2),
                                 albedo_tex=0), dict(type=2, eta=1.5),
                            dict(type=1, albedo=(0.9, 0.7, 0.4))],
                           device="cpu")
    assert vk.extract_constants(_with(ts, tris), tc, tf, tcfg) is not None
    assert vk.extract_constants(_with(ts, tris, mats, tex), tc, tf,
                                tcfg) is None
    big = tris * 28 + tris[:257]
    assert len(big) == vk.MAX_TRIS_MESH + 1
    assert vk.extract_constants(_with(ts, big), tc, tf, tcfg) is None
    assert vk.extract_constants(_with(ts, big[:-1]), tc, tf,
                                tcfg).n_tri == vk.MAX_TRIS_MESH


def test_node_layout_matches_header():
    """csrc/bvh.cuh declares the node table's layout, the traversal stack
    and the triangle cap of ops/volpath_kernels.py and ops/bvh.py."""
    import re
    from pathlib import Path

    from vspg_pbrt_v4_tpu_torch.ops import bvh

    src = (Path(vk.__file__).parent.parent / "csrc" / "bvh.cuh").read_text()
    decl = {m[0]: int(m[1]) for m in re.findall(
        r"\b(N_[A-Z]+|NODE_COLS|BVH_STACK|MAX_TRIS_MESH)\s*=\s*(\d+)", src)}
    assert decl == dict(N_BMIN=vk.N_BMIN, N_BMAX=vk.N_BMAX,
                        N_INDEX=vk.N_INDEX, N_COUNT=vk.N_COUNT,
                        NODE_COLS=vk.NODE_COLS, BVH_STACK=bvh.MAX_STACK,
                        MAX_TRIS_MESH=vk.MAX_TRIS_MESH)
