"""The port's scene-file entry point: its ``volpath.render`` against the
JAX package's on the parsed fog box, and the CLI
(``python -m vspg_pbrt_v4_tpu_torch``) on the CPU against the API bit for
bit, with --time, a --checkpoint resume, --mse-reference-image (a PIZ
EXR too), PFM and QOI outfiles, the probes and the guiding caches of
both packages; scene texts with NanoVDB, RGB-grid and earth media; the guided integrators
(``guidedvolpath``, ``guidedpath``) against ``render_guided``, the VSPG
scene file with its cloud and U-Net against ``render_vspg``, and
--guiding-gbuffer against the JAX package's. Without --cpu and without a
card the CLI exits non-zero; the CLI and the scene package import with JAX
blocked."""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.guiding import field as jfield
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.scene import build_render_setup as jbuild
from vspg_pbrt_v4_tpu.scene import parse_pbrt_file as jparse_file
from vspg_pbrt_v4_tpu_torch import cli, convert
from vspg_pbrt_v4_tpu_torch.models.guiding import field as tfield
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.scene import build_render_setup as tbuild
from vspg_pbrt_v4_tpu_torch.scene import parse_pbrt_file as tparse_file
from vspg_pbrt_v4_tpu_torch.utils.image import read_image, write_exr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOGBOX = os.path.join(REPO, "scenes", "fogbox.pbrt")
RES = (8, 8)


def _api(spp, spp_per_pass, seed=3, res=RES):
    s = tbuild(tparse_file(FOGBOX), spp, res, device="cpu")
    return tv.render(s.scene, s.camera, s.film, spp=spp,
                     cfg=tv.VolPathConfig(max_depth=32), seed=seed,
                     spp_per_pass=spp_per_pass, device="cpu").numpy()


def _cli(tmp_path, name, *extra, spp=4, per_pass=2):
    out = str(tmp_path / name)
    rc = cli.main([FOGBOX, "--cpu", "--quiet", "--spp", str(spp),
                   "--spp-per-pass", str(per_pass), "--resolution",
                   f"{RES[0]}x{RES[1]}", "--seed", "3", "--outfile", out,
                   *extra])
    assert rc == 0
    return read_image(out)


def test_render_matches_jax_on_the_parsed_fogbox():
    """The port's render against JAX's on the parsed scene at 8x8, 4 spp,
    2 a pass, pixel for pixel (test_torch_volpath_render.py's bar)."""
    js = jbuild(jparse_file(FOGBOX), 4, RES)
    ref = np.asarray(jv.render(js.scene, js.camera, js.film, spp=4,
                               cfg=jv.VolPathConfig(max_depth=32), seed=3,
                               spp_per_pass=2))
    img = _api(4, 2)
    diff = np.abs(img - ref)
    ok = ((diff <= 1e-3 * np.abs(ref)) | (diff <= 1e-6)).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert ref.mean() > 0


def test_cli_equals_the_api(tmp_path):
    img = _cli(tmp_path, "a.exr")
    np.testing.assert_array_equal(img, _api(4, 2))
    # render_wave is render_pass at one sample a pixel
    s = tbuild(tparse_file(FOGBOX), 1, RES, device="cpu")
    cfg = tv.VolPathConfig(max_depth=32)
    wave = tv.render_wave(s.scene, s.camera, s.film, s.film.init_state(),
                          cfg, 3, 0)
    np.testing.assert_array_equal(s.film.image(wave).numpy(), _api(1, 1))
    png = _cli(tmp_path, "a.png")
    assert png.shape == (RES[1], RES[0], 3) and np.isfinite(png).all()


def test_cli_time_checkpoint_and_mse(tmp_path, capsys):
    """--time stops after the pass that runs out of time; a checkpoint
    resumes to the image of one uninterrupted run; --mse-reference-image
    prints the MSE against a reference."""
    full = _api(4, 2)
    img = _cli(tmp_path, "t.exr", "--time", "0")
    np.testing.assert_array_equal(img, _api(2, 2))
    ck = str(tmp_path / "ck.npz")
    _cli(tmp_path, "c1.exr", "--checkpoint", ck, spp=2)
    resumed = _cli(tmp_path, "c2.exr", "--checkpoint", ck, spp=4)
    np.testing.assert_array_equal(resumed, full)
    ref = str(tmp_path / "ref.exr")
    write_exr(ref, full)
    capsys.readouterr()
    _cli(tmp_path, "m.exr", "--mse-reference-image", ref)
    assert capsys.readouterr().out.strip().splitlines()[-1] == "MSE,4,0"


# scene headers with the samplers, filters and cameras the port once
# refused, swapped into the fog box
LIFTED = {
    "zsobol, gaussian, thin lens": (
        'Sampler "zsobol" "integer pixelsamples" [4]',
        'PixelFilter "gaussian"\nCamera "perspective" "float fov" [30] '
        '"float lensradius" [0.1] "float focaldistance" [4]'),
    "halton, mitchell, orthographic": (
        'Sampler "halton" "integer pixelsamples" [4]',
        'PixelFilter "mitchell"\nScale 0.8 0.8 1\nCamera "orthographic"'),
    "pmj02bn, triangle, realistic": (
        'Sampler "pmj02bn" "integer pixelsamples" [4]',
        'PixelFilter "triangle"\nCamera "realistic" '
        '"float aperturediameter" [4] "float focusdistance" [4]'),
    "sobol, spherical": ('Sampler "sobol" "integer pixelsamples" [4]',
                         'Camera "spherical"'),
}

# each camera's --pixelmaterial probe on the file's 64x64 film: pixel ->
# the distances at which the pixel's centre ray crosses the fog cube's
# faces (its origin to the first, then on to the second), or None where
# it meets nothing. Down the axis from z = -4 the centre pixel's ray
# enters at z = -1 and leaves at z = 1 (half a pixel off the axis: within
# 1e-3). The realistic camera's ray starts on its front element, under
# 0.1 nearer. The spherical camera is equirectangular: its centre pixel
# looks along the camera's -x axis, and pixel (4, 4), at theta = pi 4.5 /
# 64 from the +z axis and phi = 2 pi 4.5 / 64, enters at z = -1 and
# leaves by the side x = +-1.
_TH, _PH = np.pi * 4.5 / 64, 2 * np.pi * 4.5 / 64
PROBES = {
    "zsobol, gaussian, thin lens": {"32,32": (3.0, 2.0)},
    "halton, mitchell, orthographic": {"32,32": (3.0, 2.0)},
    "pmj02bn, triangle, realistic": {"32,32": (2.95, 2.0)},
    "sobol, spherical": {
        "32,32": None,
        "4,4": (3 / np.cos(_TH),
                1 / (np.sin(_TH) * np.cos(_PH)) - 3 / np.cos(_TH))},
}


@pytest.mark.parametrize("case", list(LIFTED))
def test_cli_renders_lifted_header_directives(tmp_path, capsys, case):
    """The fog box with each once-refused sampler, filter and camera
    renders through the CLI on the CPU, bit for bit the API's render of
    the same setup; --pixelmaterial traces the camera's ray through a
    pixel's centre into the cube's faces where PROBES says (the realistic
    camera's faces within 0.05), or exits 1 seeing nothing."""
    sampler, camera = LIFTED[case]
    with open(FOGBOX) as f:
        text = f.read()
    text = text.replace(
        'Sampler "independent" "integer pixelsamples" [16]', sampler)
    text = text.replace('Camera "perspective" "float fov" [30]', camera)
    scene = tmp_path / "lifted.pbrt"
    scene.write_text(text)
    out = str(tmp_path / "lifted.exr")
    assert cli.main([str(scene), "--cpu", "--quiet", "--resolution",
                     f"{RES[0]}x{RES[1]}", "--seed", "3", "--outfile",
                     out]) == 0
    s = tbuild(tparse_file(str(scene)), None, RES, device="cpu")
    assert s.sampler == sampler.split('"')[1] and s.spp == 4
    img = tv.render(s.scene, s.camera, s.film, spp=s.spp,
                    cfg=tv.VolPathConfig(max_depth=32), seed=3,
                    sampler=s.sampler, device="cpu").numpy()
    np.testing.assert_array_equal(read_image(out), img)
    assert np.isfinite(img).all() and img.mean() > 0
    for pixel, faces in PROBES[case].items():
        capsys.readouterr()
        rc = cli.main([str(scene), "--cpu", "--quiet", "--pixelmaterial",
                       pixel])
        out, err = capsys.readouterr()
        if faces is None:
            assert rc == 1 and "no geometry visible" in err, (pixel, err)
            continue
        assert rc == 0, (pixel, err)
        t = [float(v) for v in re.findall(r"interface hit at t=([^,]+),",
                                          out)]
        atol = 0.05 if "realistic" in case else 1e-3
        np.testing.assert_allclose(t, faces, atol=atol, err_msg=pixel)


def test_cli_probes(tmp_path, capsys):
    """--pixelmaterial prints the center ray's hits (the JAX CLI test's
    scene); --debugstart replays one sample."""
    scene = tmp_path / "probe.pbrt"
    scene.write_text('''
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
Material "diffuse" "rgb reflectance" [.6 .3 .2]
Shape "sphere" "float radius" [1]
''')
    assert cli.main([str(scene), "--cpu", "--pixelmaterial", "8,8",
                     "--quiet"]) == 0
    out = capsys.readouterr().out
    assert "Intersection depth 1" in out and "Intersection depth 2" in out
    assert "diffuse" in out and "albedo=(0.6" in out
    assert "Distance from camera: 3" in out  # the sphere's front, z = -1
    assert cli.main([str(scene), "--cpu", "--pixelmaterial", "0,0",
                     "--quiet"]) == 1
    assert cli.main([FOGBOX, "--cpu", "--debugstart", "32,32,0"]) == 0
    assert "[debugstart] pixel (32,32) sample 0: L = (" in \
        capsys.readouterr().out


def test_cli_refusals(tmp_path, capsys, monkeypatch):
    """No silent fallback to the CPU; integrators and options the port
    does not serve, and unported scene content, exit with code 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([FOGBOX, "--quiet"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.main([FOGBOX, "--cpu", "--interactive"]) == 1
    assert "--interactive is not ported" in capsys.readouterr().err
    bdpt = tmp_path / "bdpt.pbrt"
    bdpt.write_text('Integrator "bdpt"\nWorldBegin\n')
    assert cli.main([str(bdpt), "--cpu", "--quiet"]) == 1
    assert "ROADMAP.md §A" in capsys.readouterr().err
    # every medium, light, material and texture is ported; a disk and a
    # curve in the VSPG scene file are not
    with open(os.path.join(REPO, "scenes", "cloud_vspg.pbrt")) as f:
        cloud_text = f.read()
    for kind, line in (("disk", 'Shape "disk" "float radius" [1]'),
                       ("curve", 'Shape "curve" "point3 P" '
                                 '[0 0 0 1 0 0 1 1 0 0 1 0]')):
        path = tmp_path / f"{kind}.pbrt"
        path.write_text(cloud_text + "\n" + line + "\n")
        assert cli.main([str(path), "--cpu", "--quiet"]) == 1
        assert f'"{kind}" is not ported' in capsys.readouterr().err
    # an output image type the writers do not know
    assert cli.main([FOGBOX, "--cpu", "--quiet", "--resolution", "4x4",
                     "--spp", "1", "--outfile",
                     str(tmp_path / "x.jpg")]) == 1
    assert "unsupported image extension" in capsys.readouterr().err


def test_cli_renders_plastic(tmp_path):
    """A plastic sphere in the fog box (the coated diffuse family, which
    the CLI refused before the other materials were ported) renders
    through the CLI on the CPU, bit for bit with the API's render of the
    same setup, and differs from the box without it where the sphere
    is."""
    with open(FOGBOX) as f:
        text = f.read()
    scene = tmp_path / "plastic.pbrt"
    scene.write_text(text + '\nAttributeBegin\n  Material "plastic" '
                     '"rgb reflectance" [0.8 0.2 0.1] "float roughness" '
                     '[0.05]\n  Shape "sphere" "float radius" [0.5]\n'
                     'AttributeEnd\n')
    out = str(tmp_path / "plastic.exr")
    assert cli.main([str(scene), "--cpu", "--quiet", "--spp", "4",
                     "--spp-per-pass", "4", "--resolution", "8x8",
                     "--seed", "3", "--outfile", out]) == 0
    s = tbuild(tparse_file(str(scene)), 4, RES, device="cpu")
    assert s.scene.materials.mat_type.tolist() == [0, 5]
    img = tv.render(s.scene, s.camera, s.film, spp=4,
                    cfg=tv.VolPathConfig(max_depth=32), seed=3,
                    spp_per_pass=4, device="cpu").numpy()
    np.testing.assert_array_equal(read_image(out), img)
    assert np.isfinite(img).all()
    assert np.abs(img[3:5, 3:5] - _api(4, 4)[3:5, 3:5]).max() > 1e-3


@pytest.mark.parametrize("case,ext", [("nanovdb", "exr"),
                                      ("rgbgrid", "pfm"), ("earth", "qoi")])
def test_cli_renders_the_other_media(tmp_path, capsys, monkeypatch, case,
                                     ext):
    """A scene text with a NanoVDB grid, an emissive RGB grid or the earth
    medium with its heightmap renders through the CLI on the CPU (--cpu),
    its image the API's render of the same setup (bit for bit where the
    output is float: EXR and PFM; QOI to its 8-bit sRGB step); without
    --cpu and without a card the CLI exits non-zero."""
    from test_torch_scene_builder import MEDIA_BODY, _media_text

    scene = tmp_path / f"{case}.pbrt"
    scene.write_text(MEDIA_BODY.format(medium=_media_text(case, tmp_path)))
    out = str(tmp_path / f"{case}.{ext}")
    assert cli.main([str(scene), "--cpu", "--quiet", "--spp", "4",
                     "--seed", "3", "--outfile", out]) == 0
    s = tbuild(tparse_file(str(scene)), 4, None, device="cpu")
    img = tv.render(s.scene, s.camera, s.film, spp=4,
                    cfg=tv.VolPathConfig(max_depth=32), seed=3,
                    spp_per_pass=4, device="cpu").numpy()
    assert np.isfinite(img).all() and img.mean() > 0
    got = read_image(out)
    if ext == "qoi":
        np.testing.assert_allclose(got, np.clip(img, 0, 1), atol=1e-2)
    else:
        np.testing.assert_array_equal(got, img)
    if case == "earth":
        # --volMajScale scales the earth's majorant_scale, as in JAX's CLI
        # (a majorant is any bound: the estimate stays unbiased)
        assert cli.main([str(scene), "--cpu", "--quiet", "--spp", "4",
                         "--volMajScale", "2", "--outfile", out]) == 0
        assert np.isfinite(read_image(out)).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    capsys.readouterr()
    assert cli.main([str(scene), "--quiet"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_pfm_outfile_and_piz_reference(tmp_path, capsys):
    """--outfile x.pfm writes the image losslessly, and
    --mse-reference-image reads a PIZ EXR (tests/data/piz_64x40.exr, its
    R, G and B) for the MSE of a 64x40 render."""
    from vspg_pbrt_v4_tpu_torch.utils.image import mse, read_pfm

    ref = os.path.join(REPO, "tests", "data", "piz_64x40.exr")
    out = str(tmp_path / "m.pfm")
    capsys.readouterr()
    assert cli.main([FOGBOX, "--cpu", "--quiet", "--spp", "2",
                     "--spp-per-pass", "2", "--resolution", "64x40",
                     "--seed", "3", "--outfile", out,
                     "--mse-reference-image", ref]) == 0
    img = _api(2, 2, res=(64, 40))
    np.testing.assert_array_equal(read_pfm(out), img)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    want = mse(img, read_image(ref))
    assert line.startswith("MSE,2,") and want > 0
    assert float(line.split(",")[2]) == pytest.approx(want, rel=1e-5)


def test_field_caches_load_across_packages(tmp_path):
    """A field stored by JAX's save_field loads in the port equal to
    convert.field_from_jax, and one stored by the port loads in JAX with
    the same leaves (an adaptive field, so every array is there)."""
    jf = jfield.GuidingField.make((-1,) * 3, (1,) * 3, res=4, n_lobes=8,
                                  n_extra=16)
    jf = jf.replace(surface=jf.surface.replace(
        weights=jf.surface.weights * 0.5), iteration=jf.iteration + 3)
    jfield.save_field(jf, str(tmp_path / "j.npz"))
    tf = tfield.load_field(str(tmp_path / "j.npz"), device="cpu")
    want = convert.field_from_jax(jf, "cpu")
    assert tf.iteration == 3
    for name in ("b_min", "b_max", "leaf_of", "refined", "child_base",
                 "leaf_center"):
        a, b = getattr(tf, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for half in ("surface", "volume"):
        for name, a in vars(getattr(tf, half)).items():
            assert torch.equal(a, getattr(getattr(want, half), name)), name
    assert (tf.res, tf.n_lobes, tf.n_extra, tf.n_leaves) == (
        want.res, want.n_lobes, want.n_extra, want.n_leaves)
    tfield.save_field(tf, str(tmp_path / "t.npz"))
    back = jfield.load_field(str(tmp_path / "t.npz"))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jf)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_checkpoints_load_across_packages(tmp_path):
    """A film state checkpointed by either package loads in the other."""
    import jax.numpy as jnp

    from vspg_pbrt_v4_tpu.models.film import FilmState as JFilmState
    from vspg_pbrt_v4_tpu.utils import checkpoint as jck
    from vspg_pbrt_v4_tpu_torch.models.film import FilmState
    from vspg_pbrt_v4_tpu_torch.utils import checkpoint as tck

    rng = np.random.default_rng(4)
    rgb = rng.uniform(0, 2, (12, 3)).astype(np.float32)
    w = rng.uniform(0, 4, 12).astype(np.float32)
    jck.save_render_state(str(tmp_path / "j.npz"), JFilmState(
        jnp.asarray(rgb), jnp.asarray(w), jnp.zeros((12, 3))), 8, 3)
    st, spp, seed = tck.load_render_state(str(tmp_path / "j.npz"),
                                          device="cpu")
    assert (spp, seed) == (8, 3)
    np.testing.assert_array_equal(st.rgb_sum.numpy(), rgb)
    np.testing.assert_array_equal(st.weight_sum.numpy(), w)
    tck.save_render_state(str(tmp_path / "t.npz"), FilmState(
        torch.as_tensor(rgb), torch.as_tensor(w)), 4, 5)
    jst, spp, seed = jck.load_render_state(str(tmp_path / "t.npz"))
    assert (spp, seed) == (4, 5)
    for a, b in zip(jst, (rgb, w, np.zeros((12, 3), np.float32))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_port_entry_points_import_without_jax():
    """With JAX blocked in a fresh interpreter, every module of the port
    and chip_smoke.py import, and none imports the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "sys.modules['jax'] = None\n"
            "import vspg_pbrt_v4_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "assert 'vspg_pbrt_v4_tpu' not in sys.modules\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, timeout=120,
                       env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


@pytest.mark.parametrize("scene", ["cornell.pbrt"])
def test_cli_renders_a_scene_with_spheres(tmp_path, scene):
    """The Cornell box (two spheres, an area light) through the CLI: the
    red wall on the image's right, the green on its left (pbrt's LookAt
    puts world -x on screen-right), as tests/test_parser_cli.py checks for
    the JAX package."""
    out = str(tmp_path / "c.exr")
    assert cli.main([os.path.join(REPO, "scenes", scene), "--cpu",
                     "--quiet", "--spp", "8", "--resolution", "32x32",
                     "--outfile", out]) == 0
    img = read_image(out)
    assert np.isfinite(img).all()
    left = img[8:24, 2:10].mean((0, 1))
    right = img[8:24, 22:30].mean((0, 1))
    assert right[0] > right[1], right
    assert left[1] > left[0], left


@pytest.mark.parametrize("name,scene,mode", [
    ("guidedvolpath", "fogbox.pbrt", "mis"),
    ("guidedvolpath", "fogbox.pbrt", "ris"),
    ("guidedpath", "cornell.pbrt", "ris")])
def test_cli_guided_equals_render_guided(tmp_path, name, scene, mode):
    """guidedvolpath and guidedpath through the CLI equal render_guided on
    the same file, seed and options, bit for bit."""
    from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath

    import re

    with open(os.path.join(REPO, "scenes", scene)) as f:
        text, n = re.subn(
            r'^Integrator "volpath" "integer maxdepth" \[(\d+)\]',
            rf'Integrator "{name}" "integer maxdepth" [\1] '
            f'"string guidingtype" "{mode}"', f.read(), flags=re.M)
    assert n == 1
    path = str(tmp_path / "g.pbrt")
    with open(path, "w") as f:
        f.write(text)
    out = str(tmp_path / "g.exr")
    assert cli.main([path, "--cpu", "--quiet", "--spp", "4",
                     "--spp-per-pass", "2", "--resolution", "8x8", "--seed",
                     "3", "--outfile", out]) == 0
    s = tbuild(tparse_file(path), 4, RES, device="cpu")
    assert s.integrator == name
    depth = s.integrator_params["maxdepth"][1][0]
    img, _ = guided_volpath.render_guided(
        s.scene, s.camera, s.film, spp=4,
        cfg=tv.VolPathConfig(max_depth=depth),
        gopt=guided_volpath.GuidingOptions(mode=mode), seed=3,
        spp_per_pass=2, device="cpu")
    np.testing.assert_array_equal(read_image(out), img.numpy())
    assert img.numpy().mean() > 0


def _outward_cloud(tmp_path):
    import re

    with open(os.path.join(REPO, "scenes", "cloud_vspg.pbrt")) as f:
        text = f.read()

    def flip(m):
        v = m.group(2).split()
        return m.group(1) + "  ".join(
            f"{v[i]} {v[i + 2]} {v[i + 1]}" for i in range(0, len(v), 3)) + "]"

    path = tmp_path / "cloud_out.pbrt"
    path.write_text(re.sub(r'("integer indices"\s*\[)([^\]]*)\]', flip,
                           text))
    return str(path)


def test_cli_cloud_vspg_unet_equals_the_api(tmp_path):
    """The shipped VSPG scene file (its procedural cloud, the U-Net ISGB
    denoiser) wound outward, at 16x16x2 through the CLI, equals
    render_vspg with the file's options; the guiding gbuffer comes out
    beside the image."""
    from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath
    from vspg_pbrt_v4_tpu_torch.models.integrators import vspg

    path = _outward_cloud(tmp_path)
    out = str(tmp_path / "c.exr")
    assert cli.main([path, "--cpu", "--quiet", "--spp", "2",
                     "--resolution", "16x16", "--seed", "1", "--outfile",
                     out, "--guiding-gbuffer"]) == 0
    s = tbuild(tparse_file(path), 2, (16, 16), device="cpu")
    assert len(s.scene.media.procedurals) == 1
    img, _, isgb = vspg.render_vspg(
        s.scene, s.camera, s.film, spp=2, cfg=tv.VolPathConfig(max_depth=32),
        gopt=guided_volpath.GuidingOptions(),
        vopt=vspg.VSPGOptions(denoiser="unet"), seed=1, spp_per_pass=2,
        device="cpu")
    assert isgb.denoiser == "unet" and isgb.ready
    np.testing.assert_array_equal(read_image(out), img.numpy())
    assert img.numpy().mean() > 0
    assert os.path.exists(str(tmp_path / "c_guiding_ids.exr"))


def test_cli_guiding_gbuffer_matches_jax(tmp_path):
    """--guiding-gbuffer after a guidedvolpathvspg render with a loaded
    guiding cache: the ids and colors equal the JAX package's
    render_guiding_gbuffer on the same field, exactly."""
    from vspg_pbrt_v4_tpu.models.integrators import extras as jextras
    from vspg_pbrt_v4_tpu_torch.models.integrators import extras

    path = _outward_cloud(tmp_path)
    js = jbuild(jparse_file(path), 1, (16, 16))
    jf = jfield.GuidingField.make((-1.001,) * 3, (1.001,) * 3, res=4,
                                  n_lobes=8)
    cache = str(tmp_path / "f.npz")
    jfield.save_field(jf, cache)
    out = str(tmp_path / "g.exr")
    assert cli.main([path, "--cpu", "--quiet", "--spp", "1",
                     "--resolution", "16x16", "--outfile", out,
                     "--load-guiding-cache", cache,
                     "--guiding-gbuffer"]) == 0
    rgb_j, cid_j = (np.asarray(a) for a in jextras.render_guiding_gbuffer(
        js.scene, js.camera, js.film, jf))
    s = tbuild(tparse_file(path), 1, (16, 16), device="cpu")
    rgb_t, cid_t = extras.render_guiding_gbuffer(
        s.scene, s.camera, s.film, tfield.load_field(cache, device="cpu"))
    # the cube fills the view: every camera ray hits
    assert rgb_j.any(-1).all() and len(np.unique(cid_j)) > 1
    np.testing.assert_array_equal(rgb_t.numpy(), rgb_j)
    np.testing.assert_array_equal(cid_t.numpy(), cid_j)
    write_exr(str(tmp_path / "want.exr"), rgb_j)
    np.testing.assert_array_equal(read_image(str(tmp_path /
                                                 "g_guiding_ids.exr")),
                                  read_image(str(tmp_path / "want.exr")))
