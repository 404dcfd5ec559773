"""NanoVDB grid files in the port: its copies of ``tools/nvdb.py`` and
``tools/nanovdb2grid.py`` against the JAX package's, file for file and
array for array, and a scene text with a ``nanovdb`` medium built by both
builders into the same ``GridMedium`` bit for bit."""

import numpy as np
import pytest

from vspg_pbrt_v4_tpu.scene import build_render_setup as jbuild
from vspg_pbrt_v4_tpu.scene import parse_pbrt_string as jparse
from vspg_pbrt_v4_tpu.tools import nanovdb2grid as jconv
from vspg_pbrt_v4_tpu.tools import nvdb as jnvdb
from vspg_pbrt_v4_tpu_torch.scene import build_render_setup as tbuild
from vspg_pbrt_v4_tpu_torch.scene import parse_pbrt_string as tparse
from vspg_pbrt_v4_tpu_torch.tools import nanovdb2grid as tconv
from vspg_pbrt_v4_tpu_torch.tools import nvdb as tnvdb

ORIGIN = (-16, 0, 4088)
VOXEL = 0.25


def _density(shape=(20, 12, 9), seed=3):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * (rng.random(shape) > 0.3)).astype(np.float32)


def _same_read(a, b):
    dens_a, org_a, vs_a, wbb_a = a
    dens_b, org_b, vs_b, wbb_b = b
    np.testing.assert_array_equal(dens_a, dens_b)
    assert dens_a.dtype == dens_b.dtype
    np.testing.assert_array_equal(org_a, org_b)
    assert vs_a == vs_b
    np.testing.assert_array_equal(wbb_a, wbb_b)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_nvdb_round_trips_across_packages(tmp_path, writer):
    """A 20x12x9 grid at a negative, unaligned index origin, written by one
    package and read by both: the same densities, origin, voxel size and
    world bbox, and the writers' files byte for byte."""
    d = _density()
    path = str(tmp_path / "grid.nvdb")
    (tnvdb if writer == "port" else jnvdb).write_nvdb(
        path, d, index_origin=ORIGIN, voxel_size=VOXEL)
    got = tnvdb.read_nvdb(path)
    _same_read(got, jnvdb.read_nvdb(path))
    np.testing.assert_array_equal(got[0][:20, :12, :9], d)
    np.testing.assert_array_equal(got[1], ORIGIN)
    assert got[2] == VOXEL
    other = str(tmp_path / "other.nvdb")
    (jnvdb if writer == "port" else tnvdb).write_nvdb(
        other, d, index_origin=ORIGIN, voxel_size=VOXEL)
    with open(path, "rb") as f, open(other, "rb") as g:
        assert f.read() == g.read()


def test_load_volume_and_convert_match_jax(tmp_path):
    """load_volume of an .nvdb (world bounds from its index box and voxel
    size) and an .npz, and convert with downsample=2, equal to JAX's."""
    d = _density((16, 12, 8), seed=4)
    nv = str(tmp_path / "g.nvdb")
    tnvdb.write_nvdb(nv, d, index_origin=ORIGIN, voxel_size=VOXEL)
    for a, b in zip(tconv.load_volume(nv), jconv.load_volume(nv)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tconv.load_volume(nv)[1],
                               np.asarray(ORIGIN) * VOXEL)
    npz = str(tmp_path / "g.npz")
    np.savez(npz, density=d, bmin=(-1, -1, -1), bmax=(1, 1, 1))
    for a, b in zip(tconv.load_volume(npz), jconv.load_volume(npz)):
        np.testing.assert_array_equal(a, b)
    for src in (nv, npz):
        out_t, out_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
        rt = tconv.convert(src, out_t, downsample=2)
        rj = jconv.convert(src, out_j, downsample=2)
        assert rt[0] == rj[0]
        np.testing.assert_array_equal(rt[1], rj[1])
        np.testing.assert_array_equal(rt[2], rj[2])
        zt, zj = np.load(out_t), np.load(out_j)
        for k in ("density", "bmin", "bmax"):
            np.testing.assert_array_equal(zt[k], zj[k])


def test_nanovdb2grid_main_and_refusals(tmp_path, capsys):
    """The converter's command line, its clear error on a file that is not
    NanoVDB (64 zero bytes), and a .vdb without pyopenvdb, in both
    packages."""
    np.save(tmp_path / "d.npy", _density((8, 8, 8)))
    assert tconv.main([str(tmp_path / "d.npy"), str(tmp_path / "o.npz"),
                       "--downsample", "2"]) == 0
    assert "(4, 4, 4) voxels" in capsys.readouterr().out
    (tmp_path / "x.nvdb").write_bytes(b"\x00" * 64)
    (tmp_path / "x.vdb").write_bytes(b"\x00" * 64)
    for mod in (tconv, jconv):
        with pytest.raises(ValueError, match="NanoVDB"):
            mod.load_volume(str(tmp_path / "x.nvdb"))
        with pytest.raises(ValueError, match="pyopenvdb"):
            mod.load_volume(str(tmp_path / "x.vdb"))
    assert tconv.main([str(tmp_path / "x.nvdb"),
                       str(tmp_path / "o.npz")]) == 1
    assert "NanoVDB" in capsys.readouterr().err


SCENE = """
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
MakeNamedMedium "vol" {medium}
    "rgb sigma_s" [1 1.5 2] "rgb sigma_a" [0.1 0.2 0.3] "float scale" [2]
    "float densityoffset" [0.125] "float majorantscale" [1.5]
    "float g" [0.4]
AttributeBegin
  Translate 0.5 0 0
  MediumInterface "vol" ""
  Material ""
  Shape "sphere" "float radius" [1]
AttributeEnd
LightSource "infinite" "rgb L" [1 1 1]
"""


@pytest.mark.parametrize("kind", ["nanovdb", "nvdb gridfile", "nanovdb npz"])
def test_nanovdb_scene_builds_like_jax(tmp_path, kind):
    """A scene text with a NanoVDB medium (type "nanovdb", a uniformgrid
    whose gridfile ends in .nvdb, and type "nanovdb" on an npz without
    bounds: the unit cube): the port's GridMedium (density with the
    offset, bounds, majorant at 64^3 cut to the grid, maj_res) equal to
    the JAX builder's bit for bit."""
    d = _density((24, 16, 16), seed=5)
    if kind == "nanovdb npz":
        grid = str(tmp_path / "g.npz")
        np.savez(grid, density=d)
    else:
        grid = str(tmp_path / "g.nvdb")
        tnvdb.write_nvdb(grid, d, index_origin=(-16, -8, -8),
                         voxel_size=0.0625)
    mtype = "uniformgrid" if kind == "nvdb gridfile" else "nanovdb"
    text = SCENE.format(medium=f'"string type" "{mtype}" '
                        f'"string filename" "{grid}"')
    tg = tbuild(tparse(text), device="cpu").scene.media.grids[0]
    jg = jbuild(jparse(text)).scene.media.grids[0]
    assert tg.res == tuple(jg.res) == d.shape
    assert tg.maj_res == tuple(jg.maj_res)
    for f in ("density", "majorant", "sigma_a", "sigma_s", "Le", "g",
              "b_min", "b_max"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    np.testing.assert_array_equal(tg.density.numpy(), d + np.float32(0.125))
    if kind == "nanovdb npz":
        np.testing.assert_array_equal(tg.b_min.numpy(), [0, 0, 0])
        np.testing.assert_array_equal(tg.b_max.numpy(), [1, 1, 1])
