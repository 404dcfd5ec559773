"""``render_vspg(backend="torch")`` under NDS+ against the JAX package's
``render_vspg(use_pallas=False)`` on the same scene and seed: two training
waves of 2 spp, the TrBuffer of the first steering the second (two JAX
wave compiles: the fresh field's and the trained one's). Both run the same
wavefront on the same stream; after a training step the fields differ in
their last bits, so most pixels agree exactly and the rest within Monte
Carlo error."""

import numpy as np

from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg

from test_torch_vspg_kernel import QUADRANTS, jax_setup
from test_torch_vspg_wave import CFG, GOPT2, SPP_PER_PASS


def test_render_vspg_torch_nds_plus_matches_jax():
    """render_vspg(backend="torch") under NDS+ with two training waves of
    2 spp against the JAX package's render_vspg(use_pallas=False): the
    TrBuffer of the first wave steers the second; most pixels agree, the
    quadrant means within four standard errors of the pixel
    differences."""
    scene, cam, film = jax_setup()
    vopt = jvspg.VSPGOptions(sampling_method="nds+")
    ref, jfield_, jisgb_ = jvspg.render_vspg(
        scene, cam, film, spp=4, cfg=CFG, gopt=GOPT2, vopt=vopt, seed=3,
        spp_per_pass=SPP_PER_PASS, use_pallas=False)
    ref = np.asarray(ref)
    ts, tc, tfilm, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    tg, tv = convert.options_from_jax(GOPT2, vopt)
    img, field, isgb = tvspg.render_vspg(ts, tc, tfilm, 4, tcfg, tg, tv,
                                         seed=3, spp_per_pass=SPP_PER_PASS,
                                         backend="torch", device="cpu")
    img = img.numpy()
    assert field.iteration == int(jfield_.iteration)
    assert isgb.ready and bool(jisgb_.ready)
    assert np.isfinite(img).all()
    d = np.abs(img - ref)
    frac = ((d <= 1e-3 * np.abs(ref)) | (d <= 1e-5)).all(-1).mean()
    print(f"render_vspg nds+ (torch): {frac:.4f} of pixels within 1e-3")
    assert frac >= 0.8, frac
    for sl in QUADRANTS:
        diff = (img[sl] - ref[sl]).mean(-1).reshape(-1)
        err = diff.std(ddof=1) / np.sqrt(diff.size)
        assert abs(diff.mean()) <= 4.0 * err + 1e-6, (diff.mean(), err)
