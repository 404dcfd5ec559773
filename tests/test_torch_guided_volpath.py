"""The port's guided wave (``guided_volpath.guided_wave``) against the JAX
package's XLA wave, lane for lane, on a fog box holding a diffuse floor
and a triangle area light (volume and surface vertices, the light's
emission with MIS), untrained and on a field trained by JAX;
``render_guided`` against JAX's within standard errors (RIS in
test_torch_guided_volpath_ris.py, so that each file compiles one JAX
wave). The furnaces of ``tests/test_guided_volpath.py`` are in
test_torch_guided_furnace.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm as JFilm
from vspg_pbrt_v4_tpu.models.guiding.field import GuidingField as JField
from vspg_pbrt_v4_tpu.models.integrators import guided_volpath as jgv
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.models.materials import DIFFUSE
from vspg_pbrt_v4_tpu.models.materials import Materials as JMaterials
from vspg_pbrt_v4_tpu.models.media import Media as JMedia
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath as tgv

from test_torch_vspg_kernel import lanes_close
from test_torch_vspg_wave import _batch_rows

RES = 16
CFG = jv.VolPathConfig(max_depth=8, max_events=32)
FLOOR = [(-1, -0.9, -1), (1, -0.9, -1), (1, -0.9, 1), (-1, -0.9, 1)]
# a one-sided emitter near the top, wound to face down
LAMP = [(-0.4, 0.9, -0.4), (0.4, 0.9, 0.4), (0.4, 0.9, -0.4)]


def lit_fog_box():
    """JAX scene, camera and film: homogeneous fog in a box with a diffuse
    floor quad and a triangle area light in it, a dim environment."""
    quad = [dict(p0=FLOOR[0], p1=FLOOR[2], p2=FLOOR[1]),
            dict(p0=FLOOR[0], p1=FLOOR[3], p2=FLOOR[2])]
    tris = ([dict(t, mat=0, light=-1, med_in=0, med_out=0) for t in quad]
            + [dict(p0=LAMP[0], p1=LAMP[1], p2=LAMP[2], mat=0, light=0,
                    med_in=0, med_out=0)])
    geom = JGeometry.build(triangles=tris, boxes=[dict(
        bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1, med_in=0,
        med_out=-1)])
    lights = JLights.make(env_L=[0.05, 0.06, 0.07], world_radius=100.0,
                          area_tris=[dict(p0=LAMP[0], p1=LAMP[1], p2=LAMP[2],
                                          L=(6.0, 5.0, 4.0))])
    media = JMedia.make([dict(sigma_a=(0.05, 0.05, 0.05),
                              sigma_s=(0.6, 0.7, 0.8), g=0.3)])
    scene = jv.Scene(geom, JMaterials.build(
        [dict(type=DIFFUSE, albedo=(0.6, 0.5, 0.4))]), media, lights)
    cam = PerspectiveCamera.make(jtr.look_at((0, 0, -4), (0, 0, 0),
                                             (0, 1, 0)), 35.0, (RES, RES))
    return scene, cam, JFilm.make((RES, RES))


def _gopt(mode):
    return jgv.GuidingOptions(mode=mode, field_res=4, record_depth=4,
                              min_train_weight=8.0)


def trained_field(mode):
    """A field trained by JAX's render_guided (4 waves); the wave's compile
    is the one the parity checks of `mode` reuse."""
    scene, cam, film = lit_fog_box()
    _, field = jgv.render_guided(scene, cam, film, spp=4, cfg=CFG,
                                 gopt=_gopt(mode), seed=7)
    assert int(field.iteration) > 0
    return field


@pytest.fixture(scope="module")
def trained():
    return trained_field("mis")


def _port(gopt):
    return tgv.GuidingOptions(**gopt._asdict())


def _port_wave(field_j, gopt):
    scene, cam, film = lit_fog_box()
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    return tgv.guided_wave(ts, tc, tf, tf.init_state(),
                           convert.field_from_jax(field_j, "cpu"), tcfg,
                           gopt, 3, 1, -1, True, 1)


def check_wave(mode, which, trained_j):
    """One training wave against JAX's: the film's sums and every
    TrainBatch column within 1e-4 on at least 0.95 of lanes
    (test_torch_vspg_wave.py's bar). On the trained field, guided draws
    occur: the same wave with guiding off takes other paths."""
    field_j = trained_j if which == "trained" else JField.make(
        (-1.001,) * 3, (1.001,) * 3, res=4, n_lobes=8)
    scene, cam, film = lit_fog_box()
    fs_j, batch_j = jgv.guided_wave(scene, cam, film, film.init_state(),
                                    field_j, CFG, _gopt(mode),
                                    jnp.uint32(3), jnp.int32(1), -1, True, 1)
    fs_t, batch_t = _port_wave(field_j, _port(_gopt(mode)))
    film_j = np.concatenate([np.asarray(fs_j.rgb_sum),
                             np.asarray(fs_j.weight_sum)[:, None]], -1)
    film_t = torch.cat([fs_t.rgb_sum, fs_t.weight_sum[:, None]], -1).numpy()
    assert film_t[:, :3].mean() > 0 and bool(batch_t.valid.any())
    for name, (t, j) in {"film": (film_t, film_j),
                         "batch": (_batch_rows(batch_t),
                                   _batch_rows(batch_j))}.items():
        frac = lanes_close(t, j)
        print(f"{mode} {which} {name}: {frac:.4f} of lanes within 1e-4")
        assert frac >= 0.95, (name, frac)
    if which == "trained":
        off = _port(_gopt(mode))._replace(volume_guiding=False,
                                          surface_guiding=False)
        fs_off, _ = _port_wave(field_j, off)
        same = lanes_close(fs_off.rgb_sum.numpy(), film_t[:, :3])
        print(f"{mode}: {1 - same:.4f} of pixels change with guiding off")
        assert same < 0.9, same


def check_render_guided(mode):
    """render_guided over 4 waves against JAX's: the image means within 4
    standard errors of the per-pixel differences, the same number of
    training updates."""
    scene, cam, film = lit_fog_box()
    gopt = _gopt(mode)
    img_j, field_j = jgv.render_guided(scene, cam, film, spp=4, cfg=CFG,
                                       gopt=gopt, seed=5)
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    img_t, field_t = tgv.render_guided(ts, tc, tf, spp=4, cfg=tcfg,
                                       gopt=_port(gopt), seed=5,
                                       device="cpu")
    img_t, img_j = img_t.numpy(), np.asarray(img_j)
    assert np.isfinite(img_t).all() and img_t.mean() > 0
    diff = (img_t.astype(np.float64) - img_j).mean(-1)
    err = max(diff.std() / np.sqrt(diff.size), 1e-12)
    print(f"{mode} render_guided: difference {diff.mean():+.3e}, "
          f"{diff.mean() / err:+.2f} standard errors")
    assert abs(diff.mean()) <= 4 * err, (diff.mean(), err)
    assert field_t.iteration == int(field_j.iteration) > 0


@pytest.mark.parametrize("which", ["untrained", "trained"])
def test_guided_wave_matches_jax(which, trained):
    check_wave("mis", which, trained)


def test_render_guided_matches_jax():
    check_render_guided("mis")
