"""One torch VSPG training wave on the scene with every material and
texture (``test_torch_materials_render.materials_text``) against the JAX
package's ``vspg_wave`` (a file of its own: one JAX wave compile, about
50 s on the CPU).

Tolerance: as tests/test_torch_vspg_wave.py, 0.95 of the pixels within
1e-4 relative (1e-6 absolute) over the pixels whose camera ray does not
hit the mix sphere (a MIX hit's constituent is a hash of its position's
bits, which XLA computes with FMAs: tests/test_torch_materials_render.py),
and the image means within 1e-2 relative."""

import jax.numpy as jnp
import numpy as np

from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu.scene import build_render_setup as jbuild
from vspg_pbrt_v4_tpu.scene import parse_pbrt_string as jparse
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg

from test_torch_materials_render import _off_mix, materials_text
from test_torch_vspg_distance import synthetic_guiding
from test_torch_vspg_kernel import GOPT, lanes_close


def test_vspg_wave_matches_jax(tmp_path):
    """One resampling training wave of 2 spp a pixel on a trained field
    and a ready ISGB (tests/test_torch_media_ext_wave.py's setup), with
    the surfaces sampled by their BSDFs: with surface guiding on, the
    guided pick among the resampling candidates flips between the
    packages on some 10% of the pixels of a large diffuse floor, before
    this slice too (tests/test_torch_vspg_teaser_wave.py and
    test_torch_vspg_area_mesh.py hold that route)."""
    res = 16
    text = materials_text(str(tmp_path), res=res)
    js = jbuild(jparse(text))
    cfg = jv.VolPathConfig(max_depth=5)
    gopt = GOPT._replace(train_waves=2, surface_guiding=False)
    jf, ji, tf, ti = synthetic_guiding(5, res=gopt.field_res,
                                       film_res=(res, res))
    vopt = jvspg.VSPGOptions(sampling_method="resampling")
    fs_j, ji2, batch_j, _ = jvspg.vspg_wave(
        js.scene, js.camera, js.film, js.film.init_state(), jf, ji, cfg,
        gopt, vopt, jnp.uint32(3), jnp.int32(1), -1, True, 2, None)
    ts, tc, tfilm, tcfg = convert.from_jax(js.scene, js.camera, js.film,
                                           cfg, "cpu")
    tg, tvo = convert.options_from_jax(gopt, vopt)
    fs_t, ti2, batch_t, _ = tvspg.vspg_wave(
        ts, tc, tfilm, tfilm.init_state(), tf, ti, tcfg, tg, tvo, 3, 1, -1,
        True, 2, None)
    img_t = tfilm.image(fs_t).numpy()
    img_j = np.asarray(js.film.image(fs_j))
    assert img_t.mean() > 0
    keep = _off_mix(ts, tc, tfilm)
    frac = lanes_close(img_t[keep], img_j[keep])
    print(f"wave: {frac:.4f} of {keep.sum()} pixels; means "
          f"{img_t.mean():.6f} and {img_j.mean():.6f}")
    assert frac >= 0.95, frac
    assert abs(img_t.mean() - img_j.mean()) <= 1e-2 * img_j.mean()
