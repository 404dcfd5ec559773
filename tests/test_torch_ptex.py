"""The port's Ptex reader and writer (``tools/ptex.py``) against the JAX
package's: files written by one package and read by the other, both ways,
for every data type and encoding (zipped, difference-zipped, constant
faces, tiled, one channel, adjacency, the triangle mesh type), the two
writers' bytes identical; the refusals; and a ptex-textured mesh through
the port's builder, face by face against the JAX builder's.

Tolerances: the faces bit for bit across packages; against the written
float faces the data type's own step (half 2e-3, uint16 1e-4, uint8 3e-3)
as in tests/test_ptex.py; the texture values at the hits within 1e-6."""

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.tools import ptex as jptex
from vspg_pbrt_v4_tpu_torch.tools import ptex as tptex

STEP = {"float": 1e-6, "half": 2e-3, "uint16": 1e-4, "uint8": 3e-3}
CASES = {
    "plain": dict(shapes=[(8, 8), (4, 16), (32, 2), (1, 1)], kw={}),
    "zipped": dict(shapes=[(16, 16), (8, 4)], kw=dict(diff=False)),
    "constant": dict(shapes=[(8, 8), (4, 4)], kw={}, const=0),
    "tiled": dict(shapes=[(32, 64), (8, 8)], kw=dict(tile_size=16),
                  const_rows=16),
    "one channel": dict(shapes=[(4, 8)], kw={}, chans=1),
    "adjacency": dict(shapes=[(4, 4)] * 3, kw=dict(
        meshtype=jptex.MESH_TRIANGLE, alphachan=2,
        adjfaces=[(1, 2, -1, -1), (0, 2, -1, -1), (0, 1, -1, -1)],
        adjedges=[(0, 1, 2, 3), (3, 2, 1, 0), (1, 1, 1, 1)])),
}


def _faces(case):
    c = CASES[case]
    rng = np.random.default_rng(len(case))
    faces = [rng.random((h, w, c.get("chans", 3))).astype(np.float32)
             for h, w in c["shapes"]]
    if "const" in c:
        faces[c["const"]][:] = 0.25
    if "const_rows" in c:
        faces[0][c["const_rows"]:] = 0.5  # constant tiles
    return faces


@pytest.mark.parametrize("datatype", sorted(STEP))
@pytest.mark.parametrize("case", sorted(CASES))
def test_files_cross_packages(tmp_path, case, datatype):
    faces = _faces(case)
    kw = CASES[case]["kw"]
    pt, pj = str(tmp_path / "t.ptx"), str(tmp_path / "j.ptx")
    tptex.write_ptx(pt, faces, datatype=datatype, **kw)
    jptex.write_ptx(pj, faces, datatype=datatype, **kw)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    for wrote, read_by in ((pt, jptex), (pj, tptex), (pt, tptex)):
        back = read_by.read_ptx(wrote)
        ref = jptex.read_ptx(pj)
        assert back.datatype == jptex._DT_NAMES[datatype]
        assert (back.meshtype, back.alphachan) == (ref.meshtype,
                                                   ref.alphachan)
        assert back.faceinfo == ref.faceinfo
        assert len(back.faces) == len(faces)
        for a, b, f in zip(back.faces, ref.faces, faces):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, f, atol=STEP[datatype])
    if case == "constant":
        info = tptex.read_ptx(pt).faceinfo
        assert info[0]["flags"] & tptex.FLAG_CONSTANT
        assert not info[1]["flags"] & tptex.FLAG_CONSTANT


def test_rejects_bad_inputs(tmp_path):
    p = tmp_path / "bad.ptx"
    with pytest.raises(ValueError, match="power-of-2"):
        tptex.write_ptx(p, [np.zeros((3, 4, 3))])
    p.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="magic"):
        tptex.read_ptx(p)


def test_builder_loads_raw_ptx(tmp_path):
    """Texture "ptex" with a raw .ptx file on a two-triangle quad: the
    port's builder bakes the same atlas and rewrites the same corner uvs
    as the JAX builder, and each triangle's hit carries its face's
    colour."""
    from vspg_pbrt_v4_tpu.scene import build_render_setup as jbuild
    from vspg_pbrt_v4_tpu.scene import parse_pbrt_string as jparse
    from vspg_pbrt_v4_tpu_torch.models.textures import eval_texture
    from vspg_pbrt_v4_tpu_torch.scene import build_render_setup as tbuild
    from vspg_pbrt_v4_tpu_torch.scene import parse_pbrt_string as tparse

    ptx = str(tmp_path / "faces.ptx")
    cols = [(0.9, 0.2, 0.1), (0.1, 0.8, 0.3)]
    tptex.write_ptx(ptx, [np.full((4, 4, 3), c, np.float32) for c in cols],
                    datatype="uint16")
    text = f"""
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
Camera "perspective" "float fov" [45]
WorldBegin
Texture "skin" "spectrum" "ptex" "string filename" ["{ptx}"]
Material "diffuse" "texture reflectance" ["skin"]
Shape "trianglemesh"
  "point3 P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]
  "integer indices" [0 1 2  0 2 3]
"""
    ts = tbuild(tparse(text), device="cpu")
    js = jbuild(jparse(text))
    g = ts.scene.geometry
    for f in ("tri_uv0", "tri_uv1", "tri_uv2"):
        np.testing.assert_array_equal(getattr(g, f).numpy(),
                                      np.asarray(getattr(js.scene.geometry,
                                                         f)), f)
    np.testing.assert_array_equal(ts.scene.textures.atlas.numpy(),
                                  np.asarray(js.scene.textures.atlas))
    o = torch.tensor([[0.5, -0.5, -3.0], [-0.5, 0.5, -3.0]])
    h = g.intersect(o, torch.tensor([[0.0, 0.0, 1.0]]).expand(2, 3))
    assert bool(h.hit.all())
    tex_id = int(ts.scene.materials.albedo_tex[h.mat_id[0]])
    got = eval_texture(ts.scene.textures,
                       torch.full((2,), tex_id, dtype=torch.int32), h.uv)
    np.testing.assert_allclose(got.numpy(), np.asarray(cols), atol=2e-5)
