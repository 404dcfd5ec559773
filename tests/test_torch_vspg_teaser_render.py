"""``render_vspg(backend="torch")`` on the teaser machines (the scene of
tests/test_torch_vspg_teaser.py) against the JAX package's
``render_vspg(use_pallas=False)``: the same wavefront with its surface
half on the same stream, through two training waves."""

import numpy as np

from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg

from test_torch_vspg_kernel import QUADRANTS
from test_torch_vspg_teaser import machines_setup
from test_torch_vspg_wave import CFG, GOPT2, SPP_PER_PASS

VOPT = jvspg.VSPGOptions()


def test_teaser_render_vspg_torch_matches_jax():
    """render_vspg(backend="torch") with two training waves of 2 spp
    against render_vspg(use_pallas=False): most pixels agree, the quadrant
    means within four standard errors of the pixel differences."""
    scene, cam, film = machines_setup()
    ref, jf, ji = jvspg.render_vspg(
        scene, cam, film, spp=4, cfg=CFG, gopt=GOPT2, vopt=VOPT, seed=3,
        spp_per_pass=SPP_PER_PASS, use_pallas=False)
    ref = np.asarray(ref)
    ts, tc, tfilm, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    tg, tv = convert.options_from_jax(GOPT2, VOPT)
    img, field, isgb = tvspg.render_vspg(ts, tc, tfilm, 4, tcfg, tg, tv,
                                         seed=3, spp_per_pass=SPP_PER_PASS,
                                         backend="torch", device="cpu")
    img = img.numpy()
    assert field.iteration == int(jf.iteration) and isgb.ready
    assert np.isfinite(img).all()
    d = np.abs(img - ref)
    frac = ((d <= 1e-3 * np.abs(ref)) | (d <= 1e-5)).all(-1).mean()
    print(f"teaser render_vspg (torch): {frac:.4f} of pixels within 1e-3")
    assert frac >= 0.8, frac
    for sl in QUADRANTS:
        diff = (img[sl] - ref[sl]).mean(-1).reshape(-1)
        err = diff.std(ddof=1) / np.sqrt(diff.size)
        assert abs(diff.mean()) <= 4.0 * err + 1e-6, (diff.mean(), err)
