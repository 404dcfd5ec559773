"""``render_persistent(backend="torch")`` against the JAX package's
``render_persistent(backend="jnp")`` on the fog box: the same lockstep lane
pool and regeneration order give the same image pixel for pixel. (The grid
cloud has its own file, to keep each file's JAX compile on one worker.)"""

import numpy as np

from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu_torch.convert import from_jax
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv

from test_torch_volpath import camera_film, fog_scene


def check_render_persistent(scene):
    cam, film = camera_film()
    cfg = jv.VolPathConfig(max_depth=16, max_events=64)
    ref = np.asarray(jv.render_persistent(scene, cam, film, spp=4, cfg=cfg,
                                          seed=5, backend="jnp"))
    ts, tc, tf, tcfg = from_jax(scene, cam, film, cfg, "cpu")
    img = tv.render_persistent(ts, tc, tf, spp=4, cfg=tcfg, seed=5,
                               backend="torch", device="cpu").numpy()
    diff = np.abs(img - ref)
    # 1e-3 relative: float32 accumulation of a few samples; a rare branch
    # flip from a last-ulp exp/log1p difference may move a pixel further
    ok = ((diff <= 1e-3 * np.abs(ref)) | (diff <= 1e-6)).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert ref.mean() > 0


def test_render_persistent_matches_jax_fog():
    check_render_persistent(fog_scene())
