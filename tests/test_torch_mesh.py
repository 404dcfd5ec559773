"""The mesh loaders of the port against the JAX package: its own copy of
Loop subdivision (``utils/loopsubdiv.py``), the PLY writer and readers
(``tools/plytool.py``) and the bench's 3072-triangle
machines (``ops/volpath_kernels.machine_mesh_tris`` against
``bench._machine_mesh_tris``). Everything is compared exactly: both sides
run the same numpy arithmetic, and PLY stores float32 as it is."""

import numpy as np
import pytest

from vspg_pbrt_v4_tpu.tools import plytool as jply
from vspg_pbrt_v4_tpu.utils import loopsubdiv as jsub
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
from vspg_pbrt_v4_tpu_torch.tools import plytool as tply
from vspg_pbrt_v4_tpu_torch.utils import loopsubdiv as tsub

CUBE_V = np.array([[(1 if i & 1 else -1), (1 if i & 2 else -1),
                    (1 if i & 4 else -1)] for i in range(8)],
                  np.float32) * 0.3
CUBE_F = np.array(vk.CUBE_FACES, np.int32)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_subdivide_matches_jax(levels):
    for limit in (False, True):
        for a, b in zip(jsub.subdivide(CUBE_V, CUBE_F, levels, limit),
                        tsub.subdivide(CUBE_V, CUBE_F, levels, limit)):
            np.testing.assert_array_equal(b, a)


def test_ply_round_trip(tmp_path):
    """What write_ply writes, read_ply reads back exactly, with and without normals and uvs; the file is byte for byte
    the JAX package's."""
    rng = np.random.default_rng(3)
    P, F, N = tsub.subdivide(CUBE_V, CUBE_F, 2)
    uv = rng.uniform(0, 1, (P.shape[0], 2)).astype(np.float32)
    for extra in ({}, {"N": N, "uv": uv}):
        path, jpath = tmp_path / "t.ply", tmp_path / "j.ply"
        tply.write_ply(path, P, F, **extra)
        jply.write_ply(str(jpath), P, F, **extra)
        assert path.read_bytes() == jpath.read_bytes()
        m = tply.read_ply(path)
        assert sorted(m) == sorted(["P", "indices", *extra])
        np.testing.assert_array_equal(m["P"], P)
        np.testing.assert_array_equal(m["indices"], F)
        for k, v in extra.items():
            np.testing.assert_array_equal(m[k], v)


def test_machine_mesh_tris_match_bench():
    import bench

    ours, theirs = vk.machine_mesh_tris(), bench._machine_mesh_tris()
    assert len(ours) == len(theirs) == 3072
    for a, b in zip(ours, theirs):
        for k in ("p0", "p1", "p2"):
            np.testing.assert_array_equal(np.asarray(a[k], np.float32),
                                          np.asarray(b[k], np.float32))
        for k in ("mat", "light", "med_in", "med_out"):
            assert a[k] == b[k]


def test_mesh_machines_scene():
    """make_machines_scene(mesh=True): the 3072 triangles with their BVH
    in the pyro cloud, of the kernel's mesh class; the 48-triangle proxy
    stays brute force."""
    scene = vk.make_machines_scene(mesh=True, device="cpu")
    g = scene.geometry
    assert g.n_tri == 3072 and g.tri_bvh is not None
    assert int(g.tri_bvh.count.sum()) == 3072
    assert sorted(g.tri_bvh.prim_ids.tolist()) == list(range(3072))
    assert vk.make_machines_scene(device="cpu").geometry.tri_bvh is None
