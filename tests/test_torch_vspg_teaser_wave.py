"""The surface half of the torch VSPG wave on the teaser machines (the
scene of tests/test_torch_vspg_teaser.py): one training ``vspg_wave``
against the JAX package's XLA wave on a field whose both halves are
trained (NEE with the BSDF, the guided BSDF draw, guided surface RR,
surface record vertices). Both run the same lockstep wavefront on the same
random stream. ``render_vspg(backend="torch")`` on the teaser has its own
file, tests/test_torch_vspg_teaser_render.py."""

import jax.numpy as jnp
import numpy as np

from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg

from test_torch_vspg_distance import synthetic_guiding
from test_torch_vspg_kernel import GOPT, RES, lanes_close
from test_torch_vspg_teaser import machines_setup
from test_torch_vspg_wave import CFG, GOPT2, SPP_PER_PASS, _batch_rows, \
    _isgb_rows

VOPT = jvspg.VSPGOptions()


def test_teaser_wave_matches_jax():
    """One training wave of 2 spp per pixel: the film image, the ISGB sums
    and the propagated training batch, lane by lane (0.95, as for the
    cloud in tests/test_torch_vspg_wave.py)."""
    scene, cam, film = machines_setup()
    jf, ji, tf, ti = synthetic_guiding(5, res=GOPT.field_res,
                                       film_res=(RES, RES))
    fs_j, ji2, batch_j, _ = jvspg.vspg_wave(
        scene, cam, film, film.init_state(), jf, ji, CFG, GOPT2, VOPT,
        jnp.uint32(3), jnp.int32(1), -1, True, SPP_PER_PASS, None)
    ts, tc, tfilm, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    tg, tv = convert.options_from_jax(GOPT2, VOPT)
    assert tg.surface_guiding
    fs_t, ti2, batch_t, _ = tvspg.vspg_wave(
        ts, tc, tfilm, tfilm.init_state(), tf, ti, tcfg, tg, tv, 3, 1, -1,
        True, SPP_PER_PASS, None)
    img_j = np.asarray(film.image(fs_j)).reshape(RES * RES, 3)
    img_t = tfilm.image(fs_t).numpy().reshape(RES * RES, 3)
    assert img_t.mean() > 0
    # surface vertices train the surface half
    assert bool((batch_t.valid & ~batch_t.is_volume).any())
    for name, (t, j) in {"image": (img_t, img_j),
                         "isgb": (_isgb_rows(ti2), _isgb_rows(ji2)),
                         "batch": (_batch_rows(batch_t),
                                   _batch_rows(batch_j))}.items():
        frac = lanes_close(t, j)
        print(f"teaser wave {name}: {frac:.4f} of lanes within 1e-4")
        assert frac >= 0.95, (name, frac)
