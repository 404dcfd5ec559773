"""The port's BVH (``ops/bvh.py``, ``native.py``) and the BVH half of
``models/shapes.Geometry`` against the JAX package on the mesh-class scenes
of tests/test_teaser_kernel.py (``_mesh_scene``: n_sub 1 gives 144
triangles, which both packages build with numpy; n_sub 2 gives 576, which
both build natively).

Tolerances: the trees array for array, exactly; the BVH's hit record
exactly equal to the port's brute force; against the JAX package the hit
flags exactly, t within 1e-6 relative on at least 0.999 of the rays that
meet a triangle and within 1e-5 on all (the same float32 formulas, some
contracted into FMAs by XLA: 3 grazing rays of 3197 differ by up to 8e-6),
and the primitive id on at least 0.999 of the rays (a ray meeting two
triangles at one distance may take either: 3 of 4096 here); occlusion
exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu import native as jnative
from vspg_pbrt_v4_tpu.ops import bvh as jbvh
from vspg_pbrt_v4_tpu_torch import native as tnative
from vspg_pbrt_v4_tpu_torch.convert import from_jax
from vspg_pbrt_v4_tpu_torch.models import shapes as tshapes
from vspg_pbrt_v4_tpu_torch.ops import bvh as tbvh

from test_teaser_kernel import _mesh_scene

N_RAYS = 4096


def _prim_bounds(g):
    """The padded triangle bounds both packages build their trees over."""
    p = [np.asarray(x) for x in (g.tri_p0, g.tri_p1, g.tri_p2)]
    return (np.minimum(np.minimum(p[0], p[1]), p[2]) - 1e-5,
            np.maximum(np.maximum(p[0], p[1]), p[2]) + 1e-5)


@pytest.fixture(scope="module", params=[1, 2], ids=["144tris", "576tris"])
def mesh(request):
    """(JAX scene, port scene) of the mesh scene."""
    scene, cam, film, cfg, n_tri = _mesh_scene(request.param)
    assert n_tri == 144 * 4 ** (request.param - 1)
    ts = from_jax(scene, cam, film, cfg, "cpu")[0]
    return scene, ts


def _rays(g, seed=4):
    """Seeded rays from inside the cloud's box, three in four aimed near a
    random triangle's centroid."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.95, 0.95, (N_RAYS, 3)).astype(np.float32)
    c = (np.asarray(g.tri_p0) + np.asarray(g.tri_p1)
         + np.asarray(g.tri_p2)) / 3
    tgt = rng.uniform(-0.9, 0.9, (N_RAYS, 3)).astype(np.float32)
    aim = rng.uniform(0, 1, N_RAYS) < 0.75
    tgt[aim] = c[rng.integers(0, len(c), aim.sum())] + rng.uniform(
        -0.02, 0.02, (aim.sum(), 3))
    d = tgt - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def test_build_bvh_matches_jax(mesh):
    lo, hi = _prim_bounds(mesh[0].geometry)
    for a, b in zip(jbvh.build_bvh(lo, hi), tbvh.build_bvh(lo, hi,
                                                           device="cpu")):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_native_bvh_matches_jax(mesh):
    lo, hi = _prim_bounds(mesh[0].geometry)
    assert tnative.available()
    for a, b in zip(jnative.build_bvh_native(lo, hi),
                    tnative.build_bvh_native(lo, hi)):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_from_jax_carries_the_tree(mesh):
    """The JAX geometry's own tree, and the one the port builds from the
    same triangles with the same builder."""
    jg, tg = mesh[0].geometry, mesh[1].geometry
    assert isinstance(tg.tri_bvh, tbvh.BVH)
    built, builder = tshapes.build_tri_bvh(
        *(t.numpy() for t in (tg.tri_p0, tg.tri_p1, tg.tri_p2)),
        device="cpu")
    assert builder == ("native" if tg.n_tri > 512 else "numpy")
    for a, b, c in zip(jg.tri_bvh, tg.tri_bvh, built):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert torch.equal(b, c)


def test_bvh_intersect_matches_brute_force_and_jax(mesh, monkeypatch):
    scene, ts = mesh
    jg, tg = scene.geometry, ts.geometry
    o, d = _rays(jg)
    counts = {}
    th = tg.intersect(torch.as_tensor(o), torch.as_tensor(d), counts=counts)
    jh = jg.intersect(jnp.asarray(o), jnp.asarray(d),
                      jnp.full(N_RAYS, jnp.inf))
    # the port's brute force, past its limit, as the oracle
    monkeypatch.setattr(tshapes, "MAX_BRUTE_TRIS", 10 ** 6)
    bh = dataclasses.replace(tg, tri_bvh=None).intersect(
        torch.as_tensor(o), torch.as_tensor(d))
    tri = th.prim_id.numpy() < tg.n_tri
    assert tri.sum() > N_RAYS // 2
    assert counts["node_visits"] > N_RAYS and counts["leaf_tests"] > 0
    for f in ("hit", "prim_id", "mat_id", "med_in", "med_out"):
        assert torch.equal(getattr(th, f), getattr(bh, f))
    assert torch.equal(th.t, bh.t)
    np.testing.assert_array_equal(th.hit.numpy(), np.asarray(jh.hit))
    t_rel = np.abs(th.t.numpy()[tri] / np.asarray(jh.t)[tri] - 1.0)
    assert (t_rel <= 1e-6).mean() >= 0.999 and t_rel.max() <= 1e-5
    # where a ray meets two triangles at one distance to the last ulp
    # (a shared edge), XLA's contracted FMAs may round the other one nearer
    same = th.prim_id.numpy() == np.asarray(jh.prim_id)
    assert same.mean() >= 0.999, same.mean()
    for f in ("mat_id", "med_in", "med_out"):
        np.testing.assert_array_equal(getattr(th, f).numpy()[same],
                                      np.asarray(getattr(jh, f))[same])
    t_max = np.random.default_rng(5).uniform(0.05, 2.0, N_RAYS).astype(
        np.float32)
    occ = tg.intersect_p(torch.as_tensor(o), torch.as_tensor(d),
                         torch.as_tensor(t_max))
    assert 0 < int(occ.sum()) < N_RAYS
    np.testing.assert_array_equal(occ.numpy(),
                                  np.asarray(jg.intersect_p(o, d, t_max)))
    assert torch.equal(occ, dataclasses.replace(tg, tri_bvh=None).intersect_p(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max)))


def test_from_jax_refuses_other_aggregates():
    """A kd-tree (Accelerator "kdtree") is not ported: from_jax raises."""
    from vspg_pbrt_v4_tpu.ops.kdtree import build_kdtree

    scene, cam, film, cfg, _ = _mesh_scene(1)
    g = scene.geometry
    kd = build_kdtree(*_prim_bounds(g))
    with pytest.raises(NotImplementedError):
        from_jax(scene._replace(geometry=g._replace(tri_bvh=kd)), cam, film,
                 cfg, "cpu")


def test_native_builds_its_own_copy(mesh, monkeypatch, tmp_path):
    """Where the committed library does not load, the port compiles the
    two sources with g++ into a library of its own (here under tmp_path,
    not the package's build directory), whose trees are the same."""
    import shutil

    src = tmp_path / "native"
    src.mkdir()
    for name in tnative._SOURCES:
        shutil.copy(tnative._NATIVE_DIR / name, src / name)
    monkeypatch.setattr(tnative, "_NATIVE_DIR", src)
    monkeypatch.setattr(tnative, "_OWN_SO", tmp_path / "own.so")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    lo, hi = _prim_bounds(mesh[0].geometry)
    ours = tnative.build_bvh_native(lo, hi)
    assert (tmp_path / "own.so").exists()
    for a, b in zip(jnative.build_bvh_native(lo, hi), ours):
        np.testing.assert_array_equal(b, np.asarray(a))
