"""The guided integrator under an environment seen through a portal: a fog
box with a diffuse floor lit by a sky through a skylight above it. One
training ``guided_wave`` (the wave ``render_guided`` runs) of the port
against the JAX package's XLA wave lane for lane (the escaped rays'
radiance tested against the window from the ray origins, their MIS pdf
from the previous vertex), and the port's ``render_guided`` against its
unguided ``volpath.render`` of the same scene (the regression
``tests/test_portal_light.py::test_portal_guided_matches_unguided``
guards: a portal's pdf depends on the reference point). JAX compiles the
portal's 40 bisection steps into each light sample of its wave (about 80
s of CPU time with a cold compile cache), so JAX's own ``render_guided``,
a second compile, is left out.

Tolerance: the wave's film sums and every training-batch column within
1e-4 relative (1e-6 absolute) on at least 0.95 of the lanes
(``test_torch_guided_volpath.py``'s bar; a portal sample may move its
direction by up to 1e-4, ``test_torch_portal_light.py``); the renders'
means within 4 standard errors of the per-pixel differences, the field
trained."""

import jax.numpy as jnp
import numpy as np

from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm as JFilm
from vspg_pbrt_v4_tpu.models.guiding.field import GuidingField as JField
from vspg_pbrt_v4_tpu.models.integrators import guided_volpath as jgv
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.models.materials import DIFFUSE
from vspg_pbrt_v4_tpu.models.materials import Materials as JMaterials
from vspg_pbrt_v4_tpu.models.media import Media as JMedia
from vspg_pbrt_v4_tpu.models.portal_light import PortalLight as JPortal
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath as tgv
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv

from test_torch_vspg_kernel import lanes_close
from test_torch_vspg_wave import _batch_rows

RES = 16
CFG = jv.VolPathConfig(max_depth=8, max_events=32)
FLOOR = [(-1, -0.9, -1), (1, -0.9, -1), (1, -0.9, 1), (-1, -0.9, 1)]
# the skylight above the box, its frame's z up toward the sky
SKYLIGHT = [(-0.6, 1.5, -0.6), (-0.6, 1.5, 0.6), (0.6, 1.5, 0.6),
            (0.6, 1.5, -0.6)]
GOPT = jgv.GuidingOptions(mode="mis", field_res=4, record_depth=4,
                          min_train_weight=8.0)


def sky(d):
    """Brighter toward the zenith and toward +x."""
    d = np.asarray(d, np.float64)
    return np.stack([1.0 + d[:, 1] + 0.5 * d[:, 0], 0.9 + d[:, 1],
                     0.8 + 0.7 * d[:, 1]], -1).clip(0).astype(np.float32)


def skylit_fog_box():
    quad = [dict(p0=FLOOR[0], p1=FLOOR[2], p2=FLOOR[1]),
            dict(p0=FLOOR[0], p1=FLOOR[3], p2=FLOOR[2])]
    geom = JGeometry.build(
        triangles=[dict(t, mat=0, light=-1, med_in=0, med_out=0)
                   for t in quad],
        boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1), mat=-1, light=-1,
                    med_in=0, med_out=-1)])
    lights = JLights.make(env_L=[1.0, 1.0, 1.0], world_radius=50.0,
                          point_p=[(0.5, 0.5, -0.5)], point_I=[(0.5,) * 3])
    lights = lights.replace(portal=JPortal.make(sky, SKYLIGHT, res=32))
    media = JMedia.make([dict(sigma_a=(0.05, 0.05, 0.05),
                              sigma_s=(0.4, 0.5, 0.6), g=0.3)])
    scene = jv.Scene(geom, JMaterials.build(
        [dict(type=DIFFUSE, albedo=(0.6, 0.5, 0.4))]), media, lights)
    cam = PerspectiveCamera.make(jtr.look_at((0, 0.3, -4), (0, -0.2, 0),
                                             (0, 1, 0)), 35.0, (RES, RES))
    return scene, cam, JFilm.make((RES, RES))


def _z(a, b):
    diff = (np.asarray(a, np.float64) - np.asarray(b, np.float64)).mean(-1)
    err = max(diff.std() / np.sqrt(diff.size), 1e-12)
    return diff.mean() / err


def test_portal_guided_matches_jax():
    scene, cam, film = skylit_fog_box()
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    assert ts.lights.portal is not None and ts.lights.beyond_kernels
    tg = tgv.GuidingOptions(**GOPT._asdict())
    # one training wave on an empty field, lane for lane
    field_j = JField.make((-1.001,) * 3, (1.001,) * 3, res=4, n_lobes=8)
    fs_j, batch_j = jgv.guided_wave(scene, cam, film, film.init_state(),
                                    field_j, CFG, GOPT, jnp.uint32(3),
                                    jnp.int32(1), -1, True, 1)
    fs_t, batch_t = tgv.guided_wave(ts, tc, tf, tf.init_state(),
                                    convert.field_from_jax(field_j, "cpu"),
                                    tcfg, tg, 3, 1, -1, True, 1)
    film_j = np.concatenate([np.asarray(fs_j.rgb_sum),
                             np.asarray(fs_j.weight_sum)[:, None]], -1)
    film_t = np.concatenate([fs_t.rgb_sum.numpy(),
                             fs_t.weight_sum[:, None].numpy()], -1)
    assert film_t[:, :3].mean() > 0.05 and bool(batch_t.valid.any())
    for name, (t, j) in {"film": (film_t, film_j),
                         "batch": (_batch_rows(batch_t),
                                   _batch_rows(batch_j))}.items():
        frac = lanes_close(t, j)
        print(f"portal wave {name}: {frac:.4f} of lanes within 1e-4")
        assert frac >= 0.95, (name, frac)
    # render_guided against the unguided volpath render
    ref = tv.render(ts, tc, tf, spp=16, cfg=tcfg, seed=9, spp_per_pass=16,
                    device="cpu").numpy()
    img, field = tgv.render_guided(ts, tc, tf, spp=16, cfg=tcfg, gopt=tg,
                                   seed=6, device="cpu")
    z = _z(img.numpy(), ref)
    print(f"render_guided against volpath: {z:+.2f} standard errors")
    assert abs(z) <= 4.0 and field.iteration > 0
    assert np.isfinite(ref).all() and ref.mean() > 0.05
