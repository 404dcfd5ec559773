"""The torch port's ``volpath_bounce`` against the JAX package's, lane for
lane, on the same 256-lane batch of the same scene (fog box and a 16^3 grid
cloud), three path events deep."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu.models.film import RGBFilm
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.lights import Lights
from vspg_pbrt_v4_tpu.models.materials import Materials
from vspg_pbrt_v4_tpu.models.media import GridMedium, Media
from vspg_pbrt_v4_tpu.models.shapes import Geometry
from vspg_pbrt_v4_tpu.utils import transform as jtr
from vspg_pbrt_v4_tpu_torch.convert import from_jax
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv

# One torch thread a test process. pytest-xdist imports every test module
# in every worker, so this line sets the count of each worker: six workers
# of one thread per core each oversubscribe the host, and the port's
# lockstep plain versions (many small ops a path event) then wait on their
# threads far longer than they compute.
torch.set_num_threads(1)

RES = 16


def fog_scene():
    return jv.make_fog_box_scene([0.05] * 3, [0.5, 0.6, 0.7], g=0.3,
                                 env_L=[0.1, 0.12, 0.15],
                                 point=((0.0, 0.8, 0.0), (5.0, 5.0, 5.0)))


def cloud_scene(n=16):
    x = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    dens = np.clip(1.0 - np.sqrt(X**2 + Y**2 + Z**2), 0, 1).astype(
        np.float32) * 3.0
    gm = GridMedium.make(dens, [0.1] * 3, [1.5, 1.8, 2.1], (-1, -1, -1),
                         (1, 1, 1), g=0.3, maj_res=8)
    lights = Lights.make(point_p=[(0.0, 1.8, 0.0)], point_I=[(6.0,) * 3],
                         env_L=[0.3, 0.35, 0.4], world_radius=100.0)
    geom = Geometry.build(boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1),
                                      mat=-1, light=-1, med_in=0,
                                      med_out=-1)])
    return jv.Scene(geom, Materials.build([]), Media.make(grids=(gm,)),
                    lights)


def camera_film():
    cam = PerspectiveCamera.make(jtr.look_at((0, 0, -4), (0, 0, 0),
                                             (0, 1, 0)), 30.0, (RES, RES))
    return cam, RGBFilm.make((RES, RES))


FLOATS = ("o", "d", "beta", "r_u", "r_l", "L", "eta_scale", "prev_p")
DISCRETE = ("depth", "alive", "specular", "medium_id", "hero_idx")


@pytest.mark.parametrize("make", [fog_scene, cloud_scene])
def test_volpath_bounce_matches_jax(make):
    scene = make()
    cam, film = camera_film()
    cfg = jv.VolPathConfig(max_depth=16, max_events=64)
    ts, tc, tf, tcfg = from_jax(scene, cam, film, cfg, "cpu")
    pid = np.arange(RES * RES, dtype=np.int32)
    js, _ = jv.start_camera_paths(cam, film, jnp.uint32(9),
                                  jnp.zeros(RES * RES, jnp.uint32),
                                  jnp.asarray(pid), -1)
    tsd, _ = tv.start_camera_paths(tc, tf, 9, torch.zeros(RES * RES,
                                                          dtype=torch.int64),
                                   torch.as_tensor(pid, dtype=torch.int64),
                                   -1)
    bounce = jax.jit(jv.volpath_bounce, static_argnums=(1,))
    for _ in range(3):
        js = bounce(scene, cfg, js)
        tsd = tv.volpath_bounce(ts, tcfg, tsd)
        same = np.ones(RES * RES, bool)
        for f in DISCRETE:
            same &= (np.asarray(getattr(js, f)).astype(np.int64)
                     == getattr(tsd, f).numpy().astype(np.int64))
        same &= (np.asarray(js.sampler.dim).astype(np.int64)
                 == tsd.sampler.dim.numpy())
        # a last-ulp difference of exp/log1p may flip a rare branch
        assert same.mean() >= 0.995, same.mean()
        for f in FLOATS:
            # rtol 1e-4: float32 state after a few events of transcendental
            # math; atol covers components that cancel to about zero
            np.testing.assert_allclose(getattr(tsd, f).numpy()[same],
                                       np.asarray(getattr(js, f))[same],
                                       rtol=1e-4, atol=1e-6, err_msg=f)
    assert tsd.depth.max() > 0  # the batch really scattered
