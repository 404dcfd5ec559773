"""The port's textures against the JAX package's on the same numpy-seeded
inputs: every kind through ``eval_texture`` with world positions (the
image atlas built from images of three sizes, SCALE and MIX nesting noise
and image kinds), the noise kinds without a position, turbulence, the
mipmap pyramid and its trilinear lookup, the bilerp corners, and the
per-face atlas (build, the .npz container across packages, no bleeding
between faces).

Tolerances: the atlas, the pyramid and the face atlas bit for bit; the
texture values within 1e-5 relative or 1e-6 absolute on at least 0.999 of
lanes and finite everywhere: the noise kinds sum up to eight Perlin
octaves (same lattice hash bit for bit, float32 fades that XLA may
contract into FMAs), and a lane within an ulp of a dot's rim, a marble
spline knot or a wrapped uv's texel edge may fall on the other side in
one package; the mipmap lookups within 1e-6 absolute."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import textures as jtex
from vspg_pbrt_v4_tpu.utils import mipmap as jmip
from vspg_pbrt_v4_tpu.utils import noise as jnoise
from vspg_pbrt_v4_tpu_torch.models import textures as ttex
from vspg_pbrt_v4_tpu_torch.utils import mipmap as tmip
from vspg_pbrt_v4_tpu_torch.utils import noise as tnoise

from test_torch_materials_ext import _frac_close

N = 4096


def _t(x):
    return torch.as_tensor(np.array(x))


def _images(rng):
    return [rng.uniform(0, 1, s + (3,)).astype(np.float32)
            for s in ((7, 5), (16, 12), (3, 9))]


# every kind; rows 12.. nest SCALE and MIX over noise and image rows
TEXTURES = [
    dict(kind=0, c0=(0.3, 0.4, 0.5)),
    dict(kind=1, c0=(0.9, 0.1, 0.1), c1=(0.1, 0.8, 0.2), uvscale=(6.0, 4.0)),
    dict(kind=2, image_id=0, uvscale=(2.0, 3.0)),
    dict(kind=2, image_id=2, uvscale=(-1.5, 1.0)),
    dict(kind=5, octaves=8, omega=0.5, scale=3.0),
    dict(kind=6, octaves=5, omega=0.6, scale=4.0),
    dict(kind=7, octaves=6, omega=0.5, scale=2.0, variation=0.5),
    dict(kind=8, c0=(0.2, 0.6, 0.3), c1=(0.9, 0.1, 0.1), uvscale=(6.0, 6.0)),
    dict(kind=9),
    dict(kind=10),
    dict(kind=11, c0=(1, 0, 0), c1=(0, 1, 0), c2=(0, 0, 1), c3=(1, 1, 0),
         uvscale=(2.0, 1.0)),
    dict(kind=2, image_id=1),
    dict(kind=3, c0=(0.6, 0.5, 0.4), inner=6),
    dict(kind=4, c0=(0.4,) * 3, inner=2, inner2=4),
    dict(kind=4, c0=(0.7,) * 3, inner=7, inner2=1),
    dict(kind=3, c0=(2.0, 1.0, 0.5), inner=11),
]


def _banks():
    imgs = _images(np.random.default_rng(0))
    return (ttex.Textures.build(TEXTURES, imgs, device="cpu"),
            jtex.Textures.build(TEXTURES, imgs))


def test_atlas_matches_jax():
    """The nearest-resized atlas (integer-division rows and columns) and
    every row of the table, field for field."""
    tb, jb = _banks()
    np.testing.assert_array_equal(tb.atlas.numpy(), np.asarray(jb.atlas))
    assert tb.atlas.shape == (3, 16, 12, 3) and tb.has_images
    for f in ("kind", "c0", "c1", "c2", "c3", "uvscale", "image_id",
              "inner", "inner2", "params"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), f)


@pytest.mark.parametrize("with_p", [True, False])
def test_every_kind_matches_jax(with_p):
    rng = np.random.default_rng(1 + with_p)
    tb, jb = _banks()
    tid = rng.integers(-1, len(TEXTURES), N).astype(np.int32)
    uv = rng.uniform(-2, 2, (N, 2)).astype(np.float32)
    p = rng.uniform(-3, 3, (N, 3)).astype(np.float32) if with_p else None
    t = ttex.eval_texture(tb, _t(tid), _t(uv),
                          None if p is None else _t(p)).numpy()
    j = np.asarray(jtex.eval_texture(jb, jnp.asarray(tid), jnp.asarray(uv),
                                     None if p is None else jnp.asarray(p)))
    assert np.isfinite(t).all()
    for k in range(len(TEXTURES)):
        sel = tid == k
        assert sel.sum() > 100
        frac = _frac_close(t[sel], j[sel], 1e-5, 1e-6)
        assert frac >= 0.999, (k, TEXTURES[k]["kind"], frac)
    np.testing.assert_array_equal(t[tid < 0], 1.0)
    if not with_p:  # the noise kinds keep their constant c0
        np.testing.assert_array_equal(t[tid == 4], 1.0)


def test_turbulence_matches_jax():
    p = np.random.default_rng(3).uniform(-50, 50, (N, 3)).astype(np.float32)
    np.testing.assert_allclose(tnoise.turbulence(_t(p), 0.6, 5).numpy(),
                               np.asarray(jnoise.turbulence(p, 0.6, 5)),
                               rtol=1e-5, atol=1e-6)


def test_mipmap_matches_jax():
    """The pyramid level for level (a power-of-two and an odd size), the
    trilinear lookups, width_to_lod; and the JAX test's invariants: a
    constant image stays constant, a checker averages to grey."""
    rng = np.random.default_rng(4)
    for shape in ((32, 32, 3), (12, 20, 3)):
        img = rng.uniform(0, 1, shape).astype(np.float32)
        tp = tmip.build_pyramid(img, device="cpu")
        jp = jmip.build_pyramid(img)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert tmip.n_levels(tp) == jmip.n_levels(jp)
        uv = rng.uniform(-2, 2, (N, 2)).astype(np.float32)
        lod = rng.uniform(-1, 7, N).astype(np.float32)
        np.testing.assert_allclose(
            tmip.lookup_trilinear(tp, _t(uv), _t(lod)).numpy(),
            np.asarray(jmip.lookup_trilinear(jp, uv, lod)), atol=1e-6)
    w = rng.uniform(1e-4, 2, N).astype(np.float32)
    np.testing.assert_allclose(tmip.width_to_lod(_t(w), 32).numpy(),
                               np.asarray(jmip.width_to_lod(w, 32)),
                               rtol=1e-6, atol=1e-6)
    x = np.indices((32, 32)).sum(0) % 2
    p = tmip.build_pyramid(np.repeat(x[..., None], 3, -1).astype(np.float32),
                           device="cpu")
    assert tmip.n_levels(p) == 6
    np.testing.assert_allclose(p.numpy().mean((1, 2, 3)), 0.5, atol=1e-6)
    uv = _t(rng.random((64, 2), np.float32))
    assert tmip.lookup_trilinear(p, uv, torch.zeros(64)).std() > 0.1
    np.testing.assert_allclose(
        tmip.lookup_trilinear(p, uv, torch.full((64,), 5.0)).numpy(), 0.5,
        atol=1e-3)
    assert float(tmip.width_to_lod(torch.tensor(1.0), 32)) == 5.0


def test_bilerp_texture_corners():
    """BilerpTexture: the corner values and the midpoint blend."""
    bank = ttex.Textures.build([dict(kind=ttex.BILERP, c0=(1, 0, 0),
                                     c1=(0, 1, 0), c2=(0, 0, 1),
                                     c3=(1, 1, 1))], device="cpu")
    uv = torch.tensor([[0.001, 0.001], [0.001, 0.999], [0.999, 0.001],
                       [0.5, 0.5]])
    out = ttex.eval_texture(bank, torch.zeros(4, dtype=torch.int32),
                            uv).numpy()
    np.testing.assert_allclose(out[:3], np.eye(3)[[0, 1, 2]], atol=5e-3)
    np.testing.assert_allclose(out[3], 0.5, atol=1e-5)


def test_face_atlas_matches_jax(tmp_path):
    """build_face_atlas bit for bit (faces of three sizes), the .npz face
    container written by one package and read by the other, and a lookup
    anywhere in a face's rect returns that face's colour (texel-centre
    rects, no bleeding)."""
    rng = np.random.default_rng(5)
    faces = [rng.uniform(0, 1, s + (3,)).astype(np.float32)
             for s in ((4, 4), (8, 4), (2, 8), (4, 4))]
    ta, tr = ttex.build_face_atlas(faces)
    ja, jr = jtex.build_face_atlas(faces)
    np.testing.assert_array_equal(ta, ja)
    assert tr == jr
    for save, load in ((ttex.save_face_textures, jtex.load_face_textures),
                       (jtex.save_face_textures, ttex.load_face_textures)):
        path = str(tmp_path / "faces.npz")
        save(path, faces)
        for a, b in zip(load(path), faces):
            np.testing.assert_array_equal(a, b)
    const = [np.full((4, 4, 3), c, np.float32)
             for c in ((1.0, 0.1, 0.1), (0.1, 1.0, 0.1), (0.1, 0.1, 1.0))]
    atlas, rects = ttex.build_face_atlas(const)
    bank = ttex.Textures.build([dict(kind=ttex.IMAGE, image_id=0)], [atlas],
                               device="cpu")
    for fi, (u0, v0, u1, v1) in enumerate(rects):
        # (a rect's top edge of a face in the atlas' first row is v = 1,
        # which the lookup wraps to 0, in both packages)
        f = torch.tensor([[0.0, 0.0], [0.999, 0.999], [0.37, 0.81]])
        uv = torch.stack([u0 + f[:, 0] * (u1 - u0), v0 + f[:, 1] * (v1 - v0)],
                         -1)
        val = ttex.eval_texture(bank, torch.zeros(3, dtype=torch.int32), uv)
        np.testing.assert_allclose(val.numpy(), np.broadcast_to(
            const[fi][0, 0], (3, 3)), atol=1e-6)
