"""``convert.from_jax`` reproduces every tensor of the JAX objects, refuses
what is not ported, and the port imports no JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest

from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu_torch.convert import from_jax

from test_torch_kernel_grid import cloud_setup
from test_torch_volpath import camera_film, fog_scene


def _same(t, j):
    np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(j))


@pytest.mark.parametrize("which", ["fog", "cloud"])
def test_from_jax_reproduces_every_tensor(which):
    if which == "fog":
        scene = fog_scene()
        cam, film = camera_film()
    else:
        scene, cam, film = cloud_setup()
    cfg = jv.VolPathConfig(max_depth=7, max_events=33, max_collisions=99)
    ts, tc, tf, tcfg = from_jax(scene, cam, film, cfg, "cpu")
    g, tg = scene.geometry, ts.geometry
    for f in ("box_min", "box_max", "box_mat", "box_light", "box_med_in",
              "box_med_out"):
        _same(getattr(tg, f), getattr(g, f))
    assert tg.n_tri == 0
    _same(ts.materials.mat_type, scene.materials.mat_type)
    m, tm = scene.media, ts.media
    for f in ("h_sigma_a", "h_sigma_s", "h_Le", "h_g"):
        _same(getattr(tm, f), getattr(m, f))
    assert len(tm.grids) == len(m.grids)
    for a, b in zip(tm.grids, m.grids):
        for f in ("density", "sigma_a", "sigma_s", "Le", "g", "b_min",
                  "b_max", "majorant"):
            _same(getattr(a, f), getattr(b, f))
        assert a.res == b.res and a.maj_res == b.maj_res
    li, tl = scene.lights, ts.lights
    for f in ("point_p", "point_I", "env_L", "select_pmf_table",
              "select_cdf"):
        _same(getattr(tl, f), getattr(li, f))
    assert tl.has_env == li.has_env and tl.world_radius == li.world_radius
    for f in ("camera_to_world", "raster_to_camera"):
        _same(getattr(tc, f).m, getattr(cam, f).m)
        _same(getattr(tc, f).m_inv, getattr(cam, f).m_inv)
    assert tc.resolution == cam.resolution
    assert tc.lens_radius == cam.lens_radius
    _same(tf.sensor_matrix, film.sensor_matrix)
    assert (tf.resolution, tf.imaging_ratio, tf.max_component) == (
        film.resolution, film.imaging_ratio, film.max_component)
    assert (tf.filter.kind, tf.filter.radius) == (film.filter.kind,
                                                  film.filter.radius)
    assert tuple(tcfg) == tuple(cfg)


def test_from_jax_refuses_unported_objects():
    scene = fog_scene()
    cam, film = camera_film()
    cfg = jv.VolPathConfig()
    # spheres convert; disks are not ported
    disk = JGeometry.build(disks=[dict(c=(0, 0, 0), n=(0, 0, 1), r=1.0,
                                       mat=-1)])
    with pytest.raises(NotImplementedError):
        from_jax(scene._replace(geometry=disk), cam, film, cfg, "cpu")
    # every light kind converts (distant lights since the port has them);
    # a motion-blurred camera is not ported
    distant = JLights.make(distant_dir=[(0, -1, 0)], distant_L=[(1, 1, 1)])
    lights = from_jax(scene._replace(lights=distant), cam, film, cfg,
                      "cpu")[0].lights
    assert lights.n_distant == 1 and lights.base_area == 1
    blur = PerspectiveCamera.make(cam.camera_to_world, 30.0, (8, 8),
                                  shutter_open=0.0, shutter_close=1.0)
    with pytest.raises(NotImplementedError):
        from_jax(scene, blur, film, cfg, "cpu")


def test_port_imports_no_jax():
    """In a fresh interpreter (tests/conftest.py imports JAX here): import
    every module of the port and check that JAX never loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vspg_pbrt_v4_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'vspg_pbrt_v4_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_from_jax_carries_every_material_field(tmp_path):
    """The JAX scene with every material and texture
    (tests/test_torch_materials_render.py's text): every new material
    field, the measured bank and the image atlas convert, and the
    converted scene renders bit for bit as the port's own build of the
    text (8x8, 2 spp, the subsurface branch on)."""
    import torch

    from vspg_pbrt_v4_tpu.scene import build_render_setup as jbuild
    from vspg_pbrt_v4_tpu.scene import parse_pbrt_string as jparse
    from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
    from vspg_pbrt_v4_tpu_torch.scene import build_render_setup as tbuild
    from vspg_pbrt_v4_tpu_torch.scene import parse_pbrt_string as tparse

    from test_torch_materials_render import materials_text

    text = materials_text(str(tmp_path), res=8, spp=2)
    js = jbuild(jparse(text))
    cfg = jv.VolPathConfig(max_depth=4, sss=True)
    cs, cc, cf, ccfg = from_jax(js.scene, js.camera, js.film, cfg, "cpu")
    jm, m = js.scene.materials, cs.materials
    for f in ("albedo2", "roughness2", "mix_m1", "mix_m2", "mix_amount",
              "meas_id", "meas_bank"):
        _same(getattr(m, f), getattr(jm, f))
    jt, t = js.scene.textures, cs.textures
    for f in ("image_id", "inner", "inner2", "params", "atlas", "c2", "c3"):
        _same(getattr(t, f), getattr(jt, f))
    assert t.has_images and m.meas_bank.shape[0] == 1
    ts = tbuild(tparse(text), device="cpu")
    imgs = [tv.render(s, c, f, spp=2, cfg=ccfg, seed=4, spp_per_pass=2,
                      device="cpu")
            for s, c, f in ((cs, cc, cf), (ts.scene, ts.camera, ts.film))]
    assert torch.equal(*imgs) and float(imgs[0].mean()) > 0
