"""One torch VSPG training wave on the RGB grid against the JAX package's
``vspg_wave`` (a file of its own: one JAX wave compile)."""

import jax.numpy as jnp
import numpy as np

from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg

from test_torch_media_ext import _box_scene, _camera_film, _rgb_media
from test_torch_vspg_distance import synthetic_guiding
from test_torch_vspg_kernel import GOPT, lanes_close


def test_vspg_wave_on_rgb_grid_matches_jax():
    """One resampling training wave of 2 spp per pixel on the RGB grid, on
    a trained field and a ready ISGB: the image, the ISGB sums and the
    propagated batch at test_torch_vspg_wave.py's bar (0.95 of lanes
    within 1e-4). The guided waves add no medium emission in either
    package."""
    res = 16
    scene = _box_scene(_rgb_media(), point=True)
    cam, film = _camera_film(res)
    cfg = jv.VolPathConfig(max_depth=8)
    gopt = GOPT._replace(train_waves=2)
    jf, ji, tf, ti = synthetic_guiding(5, res=gopt.field_res,
                                       film_res=(res, res))
    vopt = jvspg.VSPGOptions(sampling_method="resampling")
    fs_j, ji2, batch_j, _ = jvspg.vspg_wave(
        scene, cam, film, film.init_state(), jf, ji, cfg, gopt, vopt,
        jnp.uint32(3), jnp.int32(1), -1, True, 2, None)
    ts, tc, tfilm, tcfg = convert.from_jax(scene, cam, film, cfg, "cpu")
    tg, tvo = convert.options_from_jax(gopt, vopt)
    fs_t, ti2, batch_t, _ = tvspg.vspg_wave(
        ts, tc, tfilm, tfilm.init_state(), tf, ti, tcfg, tg, tvo, 3, 1, -1,
        True, 2, None)
    npix = res * res
    img_j = np.asarray(film.image(fs_j)).reshape(npix, 3)
    img_t = tfilm.image(fs_t).numpy().reshape(npix, 3)
    assert img_t.mean() > 0

    def isgb_rows(isgb):
        return np.concatenate([np.asarray(getattr(isgb, f), np.float32)
                               .reshape(npix, -1) for f in (
                                   "contrib_sum", "albedo_sum", "n",
                                   "c_vol", "c_vol2")], -1)

    def batch_rows(b):
        return np.concatenate([np.asarray(getattr(b, f), np.float32).reshape(
            len(np.asarray(b.weight)), -1) for f in b._fields], -1)

    assert bool(batch_t.valid.any())
    for name, t, j in (("image", img_t, img_j),
                       ("isgb", isgb_rows(ti2), isgb_rows(ji2)),
                       ("batch", batch_rows(batch_t), batch_rows(batch_j))):
        frac = lanes_close(t, j)
        assert frac >= 0.95, (name, frac)
