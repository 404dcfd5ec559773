"""The torch port's RNG, warps, transforms, camera and grid-medium helpers
against the JAX package, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import cameras as jcam
from vspg_pbrt_v4_tpu.models import media as jmed
from vspg_pbrt_v4_tpu.utils import rng as jrng
from vspg_pbrt_v4_tpu.utils import sampling as jsamp
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu.utils import vecmath as jvec
from vspg_pbrt_v4_tpu_torch.models import cameras as tcam
from vspg_pbrt_v4_tpu_torch.models import media as tmed
from vspg_pbrt_v4_tpu_torch.utils import rng as trng
from vspg_pbrt_v4_tpu_torch.utils import sampling as tsamp
from vspg_pbrt_v4_tpu_torch.utils import transform as ttr
from vspg_pbrt_v4_tpu_torch.utils import vecmath as tvec

# float32 transcendental and rounding differences between XLA and torch on
# the CPU stay within a few ulp of values of order one
TOL = 1e-6


def _words(n=100_000, seed=0):
    """numpy uint32 4-tuples, a quarter of them within 2^12 of 2^32."""
    r = np.random.default_rng(seed)
    w = r.integers(0, 2 ** 32, size=(4, n), dtype=np.uint64)
    top = r.integers(2 ** 32 - 4096, 2 ** 32, size=(4, n // 4),
                     dtype=np.uint64)
    w[:, : n // 4] = top
    return w.astype(np.uint32)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int64))


def test_pcg4d_bit_exact():
    w = _words()
    ref = jrng._pcg4d(*(jnp.asarray(x) for x in w))
    got = trng._pcg4d(*(_t(x) for x in w))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r).astype(np.int64),
                                      g.numpy())


def test_uniform4_bit_exact():
    w = _words(seed=1)
    ref = jrng.uniform4(*(jnp.asarray(x) for x in w))
    got = trng.uniform4(*(_t(x) for x in w))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())
        assert g.dtype == torch.float32


def test_hash_u32_bit_exact():
    w = _words(n=4096, seed=2)
    ref = jrng.hash_u32(*(jnp.asarray(x) for x in w), jnp.asarray(w[0]))
    got = trng.hash_u32(*(_t(x) for x in w), _t(w[0]))
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  got.numpy())


def _u(n, k, seed):
    return np.random.default_rng(seed).random((n, k), dtype=np.float32)


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_sample_exponential():
    u = _u(4096, 2, 3)
    a = u[:, 1] * 5 + 0.1
    np.testing.assert_allclose(
        tsamp.sample_exponential(torch.tensor(u[:, 0]), torch.tensor(a)),
        jsamp.sample_exponential(jnp.asarray(u[:, 0]), jnp.asarray(a)),
        rtol=TOL, atol=TOL)


def test_uniform_sphere():
    u = _u(4096, 2, 4)
    np.testing.assert_allclose(tsamp.sample_uniform_sphere(torch.tensor(u)),
                               jsamp.sample_uniform_sphere(jnp.asarray(u)),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("g", [0.0, 0.3, -0.7, 0.95])
def test_henyey_greenstein(g):
    u = _u(4096, 2, 5)
    wo = _unit(4096, 6)
    gg = np.full(4096, g, np.float32)
    cos = (u[:, 0] * 2 - 1).astype(np.float32)
    np.testing.assert_allclose(
        tsamp.henyey_greenstein(torch.tensor(cos), torch.tensor(gg)),
        jsamp.henyey_greenstein(jnp.asarray(cos), jnp.asarray(gg)),
        rtol=TOL, atol=TOL)
    wi_t, pdf_t = tsamp.sample_henyey_greenstein(torch.tensor(wo),
                                                 torch.tensor(gg),
                                                 torch.tensor(u))
    wi_j, pdf_j = jsamp.sample_henyey_greenstein(jnp.asarray(wo),
                                                 jnp.asarray(gg),
                                                 jnp.asarray(u))
    # strongly forward g amplifies the ulp of 1 +- g - 2gu into the cosine
    tol = TOL if abs(g) < 0.9 else 2e-5
    np.testing.assert_allclose(wi_t, wi_j, rtol=tol, atol=tol)
    np.testing.assert_allclose(pdf_t, pdf_j, rtol=tol, atol=tol)


def test_coordinate_system():
    v = _unit(4096, 7)
    for a, b in zip(tvec.coordinate_system(torch.tensor(v)),
                    jvec.coordinate_system(jnp.asarray(v))):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_look_at_perspective_exact():
    """The builders compute in numpy exactly as the JAX package does."""
    for t, j in ((ttr.look_at((0.3, 1, -4), (0, 0.2, 0), (0, 1, 0),
                              device="cpu"),
                  jtr.look_at((0.3, 1, -4), (0, 0.2, 0), (0, 1, 0))),
                 (ttr.perspective(37.0, device="cpu"), jtr.perspective(37.0))):
        np.testing.assert_array_equal(t.m.numpy(), np.asarray(j.m))
        np.testing.assert_array_equal(t.m_inv.numpy(), np.asarray(j.m_inv))


@pytest.mark.parametrize("res", [(16, 16), (24, 16), (16, 40)])
def test_camera_rays(res):
    c2w_t = ttr.look_at((0.5, 0.2, -4), (0, 0, 0), (0, 1, 0), device="cpu")
    c2w_j = jtr.look_at((0.5, 0.2, -4), (0, 0, 0), (0, 1, 0))
    cam_t = tcam.PerspectiveCamera.make(c2w_t, 30.0, res, device="cpu")
    cam_j = jcam.PerspectiveCamera.make(c2w_j, 30.0, res)
    np.testing.assert_array_equal(cam_t.raster_to_camera.m.numpy(),
                                  np.asarray(cam_j.raster_to_camera.m))
    p = _u(2048, 2, 8) * np.asarray(res, np.float32)
    o_t, d_t = cam_t.generate_rays(torch.tensor(p))
    o_j, d_j = cam_j.generate_rays(jnp.asarray(p), jnp.zeros_like(p))
    np.testing.assert_allclose(o_t, o_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(d_t, d_j, rtol=TOL, atol=TOL)


def _density(n=16, seed=9):
    r = np.random.default_rng(seed)
    return (r.random((n, n, n), dtype=np.float32) ** 3) * 4.0


@pytest.mark.parametrize("maj_res", [4, 8, (4, 8, 2)])
def test_grid_majorant_exact(maj_res):
    d = _density()
    gt = tmed.GridMedium.make(d, [0.1] * 3, [1.0] * 3, (-1, -1, -1),
                              (1, 1, 1), maj_res=maj_res, device="cpu")
    gj = jmed.GridMedium.make(d, [0.1] * 3, [1.0] * 3, (-1, -1, -1),
                              (1, 1, 1), maj_res=maj_res)
    assert gt.maj_res == gj.maj_res
    np.testing.assert_array_equal(gt.majorant.numpy(),
                                  np.asarray(gj.majorant))


def test_trilerp():
    d = _density()
    p = (_u(8192, 3, 10) * 2.4 - 1.2).astype(np.float32)  # some outside
    lo, hi = np.float32([-1, -1, -1]), np.float32([1, 1, 1])
    got = tmed._trilerp(torch.tensor(d), torch.tensor(lo), torch.tensor(hi),
                        d.shape, torch.tensor(p))
    ref = jmed._trilerp(jnp.asarray(d), jnp.asarray(lo), jnp.asarray(hi),
                        d.shape, jnp.asarray(p))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def test_seg_init_next():
    """Majorant DDA segments of random rays through a grid, step by step
    (1e-5: crossing times accumulate a few ulp per step)."""
    d = _density()
    n = 2048
    gt = tmed.GridMedium.make(d, [0.1] * 3, [1.0, 1.5, 2.0], (-1, -1, -1),
                              (1, 1, 1), maj_res=4, device="cpu")
    gj = jmed.GridMedium.make(d, [0.1] * 3, [1.0, 1.5, 2.0], (-1, -1, -1),
                              (1, 1, 1), maj_res=4)
    mt = tmed.Media.make(grids=(gt,), device="cpu")
    mj = jmed.Media.make(grids=(gj,))
    o = (_u(n, 3, 11) * 6 - 3).astype(np.float32)
    tgt = (_u(n, 3, 12) * 1.6 - 0.8).astype(np.float32)
    dirs = tgt - o
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    t_max = np.full(n, 10.0, np.float32)
    mid = np.zeros(n, np.int32)
    act = np.ones(n, bool)
    it_t = tmed.seg_init(mt, torch.tensor(mid), torch.tensor(o),
                         torch.tensor(dirs), torch.tensor(t_max),
                         torch.tensor(act))
    it_j = jmed.seg_init(mj, jnp.asarray(mid), jnp.asarray(o),
                         jnp.asarray(dirs), jnp.asarray(t_max),
                         jnp.asarray(act))
    for _ in range(12):
        np.testing.assert_array_equal(it_t.done.numpy(), np.asarray(it_j.done))
        live = ~it_t.done.numpy()
        for f in ("t_seg_start", "t_seg_end", "sigma_maj"):
            np.testing.assert_allclose(getattr(it_t, f).numpy()[live],
                                       np.asarray(getattr(it_j, f))[live],
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(it_t.voxel.numpy()[live],
                                      np.asarray(it_j.voxel)[live])
        want = np.ones(n, bool)
        it_t = tmed.seg_next(mt, torch.tensor(mid), it_t, torch.tensor(want))
        it_j = jmed.seg_next(mj, jnp.asarray(mid), it_j, jnp.asarray(want))


def test_box_helpers():
    from vspg_pbrt_v4_tpu.ops import intersect as jis
    from vspg_pbrt_v4_tpu_torch.ops import intersect as tis

    o = (_u(4096, 3, 13) * 6 - 3).astype(np.float32)
    d = _unit(4096, 14)
    lo, hi = np.float32([-1, -0.5, -1]), np.float32([1, 0.5, 2])
    t_max = np.full(4096, 5.0, np.float32)
    for a, b in zip(tis.ray_aabb(*map(torch.tensor, (o, d, t_max, lo, hi))),
                    jis.ray_aabb(*map(jnp.asarray, (o, d, t_max, lo, hi)))):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    p = np.clip(o, lo, hi)
    np.testing.assert_array_equal(
        tis.aabb_normal(*map(torch.tensor, (p, lo, hi))),
        jis.aabb_normal(*map(jnp.asarray, (p, lo, hi))))
    np.testing.assert_allclose(
        tis.offset_ray_origin(*map(torch.tensor, (o, d, -o))),
        jis.offset_ray_origin(*map(jnp.asarray, (o, d, -o))),
        rtol=TOL, atol=TOL)
    n, v = _unit(4096, 15), _unit(4096, 16)
    np.testing.assert_array_equal(
        tvec.face_forward(torch.tensor(n), torch.tensor(v)),
        jvec.face_forward(jnp.asarray(n), jnp.asarray(v)))


def test_geometry_intersect():
    from vspg_pbrt_v4_tpu.models.shapes import Geometry as JG
    from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry as TG

    boxes = [dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1,
                  med_in=0, med_out=-1),
             dict(bmin=(1.5, -0.5, -0.5), bmax=(2.5, 0.5, 0.5), mat=2,
                  light=-1, med_in=-1, med_out=-1)]
    o = (_u(4096, 3, 17) * 8 - 4).astype(np.float32)
    d = _unit(4096, 18)
    ht = TG.build(boxes, device="cpu").intersect(torch.tensor(o),
                                                 torch.tensor(d))
    hj = JG.build(boxes=boxes).intersect(jnp.asarray(o), jnp.asarray(d),
                                         jnp.full(4096, jnp.inf))
    np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
    m = ht.hit.numpy()
    for f in ("t", "p", "n"):
        np.testing.assert_allclose(getattr(ht, f).numpy()[m],
                                   np.asarray(getattr(hj, f))[m],
                                   rtol=TOL, atol=TOL)
    for f in ("mat_id", "med_in", "med_out", "prim_id"):
        np.testing.assert_array_equal(getattr(ht, f).numpy(),
                                      np.asarray(getattr(hj, f)))


@pytest.mark.parametrize("point,env", [(True, True), (True, False),
                                       (False, True)])
def test_lights_sample(point, env):
    from vspg_pbrt_v4_tpu.models.lights import Lights as JL
    from vspg_pbrt_v4_tpu_torch.models.lights import Lights as TL

    kw = dict(point_p=[(0.2, 1.8, 0.0)] if point else None,
              point_I=[(6.0, 5.0, 4.0)] if point else None,
              env_L=[0.3, 0.35, 0.4] if env else None, world_radius=100.0)
    lt, lj = TL.make(device="cpu", **kw), JL.make(**kw)
    p = (_u(4096, 3, 19) * 2 - 1).astype(np.float32)
    u = _u(4096, 3, 20)
    st = lt.sample(torch.tensor(p), torch.tensor(u[:, 0]),
                   torch.tensor(u[:, 1:]))
    sj = lj.sample(jnp.asarray(p), jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1:]))
    for f in ("wi", "L", "pdf_dir", "select_pmf", "t_shadow"):
        np.testing.assert_allclose(getattr(st, f), getattr(sj, f),
                                   rtol=TOL, atol=TOL, err_msg=f)
    for f in ("is_delta", "valid"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f))
    d = _unit(64, 21)
    np.testing.assert_array_equal(lt.le_escaped(torch.tensor(d)),
                                  lj.le_escaped(jnp.asarray(d)))
    np.testing.assert_allclose(lt.pdf_li_escaped(torch.tensor(d)),
                               lj.pdf_li_escaped(jnp.asarray(d)), rtol=TOL)


def test_film_accumulates_like_jax():
    from vspg_pbrt_v4_tpu.models.film import RGBFilm as JF
    from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm as TF

    ft, fj = TF.make((8, 4), imaging_ratio=2.0, device="cpu"), \
        JF.make((8, 4), imaging_ratio=2.0)
    r = np.random.default_rng(22)
    pid = r.integers(0, 32, 256).astype(np.int64)
    L = r.random((256, 3), dtype=np.float32)
    L[5, 1] = np.nan  # scrubbed to zero at commit
    w = r.random(256, dtype=np.float32)
    img_t = ft.image(ft.add_samples(ft.init_state(), torch.tensor(pid),
                                    torch.tensor(L), torch.tensor(w)))
    img_j = fj.image(fj.add_samples(fj.init_state(), jnp.asarray(pid),
                                    jnp.asarray(L), jnp.asarray(w)))
    # float32 sums in another order
    np.testing.assert_allclose(img_t, img_j, rtol=1e-5, atol=1e-6)
