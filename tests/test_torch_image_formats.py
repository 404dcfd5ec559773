"""The port's image readers and writers against the JAX package's: PIZ EXR
(the OpenEXR-written files of ``tests/data``), PFM and QOI written by one
package and read by the other bit for bit, and the extension dispatch of
``read_image`` and ``write_image``."""

import os
import struct

import numpy as np
import pytest

from vspg_pbrt_v4_tpu.utils import image as ji
from vspg_pbrt_v4_tpu_torch.utils import image as ti

DATA = os.path.join(os.path.dirname(__file__), "data")


def _hdr(ny=7, nx=11, seed=3):
    rng = np.random.default_rng(seed)
    img = rng.random((ny, nx, 3), np.float32) * 4.0
    img[0, 0] = [0, 0, 0]
    img[1, 1] = [3.7, 0.001, 1.0]
    return img


@pytest.mark.parametrize("name", ["piz_8x8", "piz_17x9", "piz_64x40"])
def test_piz_exr_matches_jax(name):
    """The three PIZ files (one and two 32-line blocks, odd sizes) read by
    the port and by JAX bit for bit, as EXR and through read_image."""
    path = os.path.join(DATA, name + ".exr")
    img_t, names_t = ti.read_exr(path)
    img_j, names_j = ji.read_exr(path)
    assert names_t == names_j == ["A", "B", "G", "R"]
    np.testing.assert_array_equal(img_t, img_j)
    rgb_t, rgb_j = ti.read_image(path), ji.read_image(path)
    assert rgb_t.shape[-1] == 3
    np.testing.assert_array_equal(rgb_t, rgb_j)
    # the file's diagonal holds 37.25 in B (tests/test_piz.py's pattern)
    assert (rgb_t[..., 2] == 37.25).sum() == min(rgb_t.shape[:2])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pfm_across_packages(tmp_path, writer):
    """A colour PFM written by one package: the same bytes from the other's
    writer, and both readers give the image back bit for bit."""
    img = _hdr()
    a, b = (ti, ji) if writer == "port" else (ji, ti)
    a.write_pfm(tmp_path / "a.pfm", img)
    b.write_pfm(tmp_path / "b.pfm", img)
    assert (tmp_path / "a.pfm").read_bytes() == (tmp_path / "b.pfm").read_bytes()
    for mod in (ti, ji):
        np.testing.assert_array_equal(mod.read_pfm(tmp_path / "a.pfm"), img)


def test_pfm_greyscale_big_endian():
    """A greyscale 'Pf' with a positive (big-endian) scale of 2, read alike
    by both packages."""
    import tempfile

    ny, nx = 3, 5
    data = np.arange(ny * nx, dtype=">f4").reshape(ny, nx)
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "g.pfm")
        with open(p, "wb") as f:
            f.write(b"Pf\n%d %d\n2.0\n" % (nx, ny))
            f.write(data[::-1].tobytes())
        got = ti.read_pfm(p)
        np.testing.assert_array_equal(got, ji.read_pfm(p))
    assert got.shape == (ny, nx, 3)
    np.testing.assert_array_equal(got[..., 0], data.astype(np.float32) * 2)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_qoi_across_packages(tmp_path, writer):
    """QOI (8-bit sRGB) with long runs, index hits, small diffs and luma
    steps, written by one package: the other's writer gives the same
    bytes, and both readers the same linear image bit for bit."""
    img = np.zeros((6, 80, 3), np.float32)
    img[1] = 0.5
    img[2, ::2] = [0.1, 0.7, 0.2]
    img[3, 1::3] = [0.9, 0.05, 0.3]
    img[4] = np.linspace(0, 1, 80)[:, None]
    img[5] = _hdr(2, 80, seed=5)[1] / 4.0
    a, b = (ti, ji) if writer == "port" else (ji, ti)
    a.write_qoi(tmp_path / "a.qoi", img)
    b.write_qoi(tmp_path / "b.qoi", img)
    assert (tmp_path / "a.qoi").read_bytes() == (tmp_path / "b.qoi").read_bytes()
    back = ti.read_qoi(tmp_path / "a.qoi")
    np.testing.assert_array_equal(back, ji.read_qoi(tmp_path / "a.qoi"))
    assert back.shape == img.shape
    assert np.abs(back - img).max() < 5e-3  # the 8-bit sRGB quantum


@pytest.mark.parametrize("ext", ["exr", "pfm", "qoi", "png", ""])
def test_image_dispatch_by_extension(tmp_path, ext):
    """write_image and read_image pick the format by extension (no
    extension writes EXR): the port's file reads back in both packages
    alike, bit for bit, near the image."""
    img = _hdr(4, 6) / 4.0
    p = tmp_path / (("d." + ext) if ext else "d")
    ti.write_image(p, img)
    if not ext:
        assert p.read_bytes()[:4] == struct.pack("<i", 20000630)
        return
    back = ti.read_image(p)
    assert back.shape == (4, 6, 3)
    np.testing.assert_array_equal(back, ji.read_image(p).astype(np.float32))
    tol = 1e-3 if ext in ("exr", "pfm") else 1e-2
    assert np.abs(back - img).max() <= tol


def test_image_refusals(tmp_path):
    """An unknown extension raises in both writers; an EXR compression
    neither package reads (PXR24) raises with JAX's message; an unknown
    image type raises in the port's reader."""
    img = _hdr(2, 2)
    for mod in (ti, ji):
        with pytest.raises(ValueError, match="unsupported image extension"):
            mod.write_image(tmp_path / "x.jpg", img)
    ti.write_exr(tmp_path / "z.exr", img, compression="none")
    raw = bytearray((tmp_path / "z.exr").read_bytes())
    i = raw.index(b"compression\0compression\0") + 24 + 4
    assert raw[i] == 0
    raw[i] = 5  # PXR24
    (tmp_path / "p.exr").write_bytes(bytes(raw))
    with pytest.raises(NotImplementedError) as e:
        ti.read_exr(tmp_path / "p.exr")
    with pytest.raises(AssertionError) as ej:
        ji.read_exr(tmp_path / "p.exr")
    assert str(e.value) == str(ej.value) == \
        "unsupported EXR compression 5 (NONE/ZIPS/ZIP/PIZ only)"
    with pytest.raises(NotImplementedError, match="only EXR, PFM, QOI"):
        ti.read_image(tmp_path / "x.tga")
