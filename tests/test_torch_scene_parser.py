"""The port's copy of the scene parser (``vspg_pbrt_v4_tpu_torch/scene/
parser.py``) against the JAX package's: the same directives (name, args,
parameters, file:line) from the three shipped scene files and from the
strings of tests/test_parser_cli.py, Include relative to the including
file, the same PbrtError text for a missing include, and the same
typed parameter lookups."""

import os

import numpy as np
import pytest

from vspg_pbrt_v4_tpu.scene import parser as jp
from vspg_pbrt_v4_tpu_torch.scene import parser as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("fogbox.pbrt", "cornell.pbrt", "cloud_vspg.pbrt")
STRINGS = {
    "tokenizer": '''
# comment
Integrator "volpath" "integer maxdepth" [ 7 ]
LookAt 0 1 2  3 4 5  0 1 0
WorldBegin
Material "diffuse" "rgb reflectance" [.1 .2 .3]
Shape "sphere" "float radius" 2.5
''',
    "checker": '''
Film "rgb" "integer xresolution" [32] "integer yresolution" [32]
LookAt 0 3 0  0 0 0  0 0 1
Camera "perspective" "float fov" [40]
WorldBegin
Texture "checks" "spectrum" "checkerboard"
  "float uscale" [4] "float vscale" [4]
  "rgb tex1" [1 0 0] "rgb tex2" [0 0 1]
Material "diffuse" "texture reflectance" "checks"
Shape "sphere" "float radius" [1]
''',
    "instancing": '''
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 0 -6  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "infinite" "rgb L" [0.5 0.5 0.5]
ObjectBegin "pair"
  Material "diffuse" "rgb reflectance" [0.8 0.2 0.2]
  Shape "sphere" "float radius" [0.5]
  Translate 1.2 0 0
  Shape "sphere" "float radius" [0.3]
ObjectEnd
ObjectInstance "pair"
AttributeBegin
  Translate -1.5 0 0
  ObjectInstance "pair"
AttributeEnd
''',
    "rgbgrid": '''
Camera "perspective"
WorldBegin
MakeNamedMedium "m" "string type" "rgbgrid"
  "integer nx" [2] "integer ny" [2] "integer nz" [2]
  "rgb sigma_a" [''' + " ".join(["0.5 1.0 1.5"] * 8) + ''']
AttributeBegin
MediumInterface "m" ""
Material "none"
Shape "sphere" "float radius" [1]
AttributeEnd
ActiveTransform StartTime
TransformTimes 0 1
Rotate 30 0 1 0
ConcatTransform 1 0 0 0 0 1 0 0 0 0 1 0 0.5 0 0 1
LightSource "infinite" "rgb L" [1 1 1] "bool flag" true
''',
}


def _same(a, b):
    assert [tuple(d) for d in a] == [tuple(d) for d in b]
    assert all(type(x).__name__ == type(y).__name__ == "Directive"
               for x, y in zip(a, b))


@pytest.mark.parametrize("name", SCENES)
def test_scene_files_parse_alike(name):
    path = os.path.join(REPO, "scenes", name)
    ds = tp.parse_pbrt_file(path)
    assert len(ds) > 5
    _same(ds, jp.parse_pbrt_file(path))


@pytest.mark.parametrize("name", list(STRINGS))
def test_strings_parse_alike(name):
    _same(tp.parse_pbrt_string(STRINGS[name]),
          jp.parse_pbrt_string(STRINGS[name]))


def test_include_and_error_text(tmp_path):
    """Include resolves relative to the including file; a missing include
    raises the same PbrtError, file:line included."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "part.pbrt").write_text(
        'Shape "sphere" "float radius" [2]\n')
    main = tmp_path / "main.pbrt"
    main.write_text('WorldBegin\nInclude "sub/part.pbrt"\n'
                    'Import "sub/part.pbrt"\n')
    ds = tp.parse_pbrt_file(str(main))
    _same(ds, jp.parse_pbrt_file(str(main)))
    assert [d.loc for d in ds[1:]] == ["sub/part.pbrt:1"] * 2
    bad = tmp_path / "bad.pbrt"
    bad.write_text('WorldBegin\n\nInclude "missing.pbrt"\n')
    with pytest.raises(tp.PbrtError) as et:
        tp.parse_pbrt_file(str(bad))
    with pytest.raises(jp.PbrtError) as ej:
        jp.parse_pbrt_file(str(bad))
    assert str(et.value) == str(ej.value)
    assert et.value.loc == "bad.pbrt:3"


def test_parameter_dictionary():
    ds = tp.parse_pbrt_string(STRINGS["rgbgrid"] + STRINGS["checker"])
    jds = jp.parse_pbrt_string(STRINGS["rgbgrid"] + STRINGS["checker"])
    for d, jd in zip(ds, jds):
        p, q = tp.ParameterDictionary(d.params), jp.ParameterDictionary(
            jd.params)
        for k, (ptype, _) in d.params.items():
            if ptype in ("rgb", "point3"):
                np.testing.assert_array_equal(p.get_rgb(k), q.get_rgb(k))
                np.testing.assert_array_equal(p.get_point3(k),
                                              q.get_point3(k))
            elif ptype in ("integer", "float"):
                np.testing.assert_array_equal(p.get_floats(k),
                                              q.get_floats(k))
                assert p.get_float(k) == q.get_float(k)
            elif ptype == "bool":
                assert p.get_bool(k) is q.get_bool(k)
            else:
                assert p.get_string(k) == q.get_string(k)
        assert p.get_float("absent", 3.0) == 3.0
        assert p.unused() == q.unused()
