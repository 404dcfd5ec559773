"""``render_vspg(backend="torch")`` with the adaptive guiding field against
the JAX package's ``render_vspg(use_pallas=False)`` on the same scene and
seed: two training waves of 2 spp on a res-4 field with 128 extra leaves
and a refinement threshold of 16, so that each training step is followed
by ``refine_field``. Both pick the same cells to split (the same
numpy pick on fields equal to their last bits), so the refined fields
carry the same addressing; the images agree on most pixels and within
Monte Carlo error on the rest, as tests/test_torch_vspg_render_nds.py
holds NDS+."""

import numpy as np

from vspg_pbrt_v4_tpu.models.integrators import vspg as jvspg
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg

from test_torch_vspg_kernel import QUADRANTS, jax_setup
from test_torch_vspg_wave import CFG, GOPT2, SPP_PER_PASS

AGOPT = GOPT2._replace(field_res=4, adaptive_extra=128,
                       refine_threshold=16.0)


def test_render_vspg_torch_adaptive_matches_jax():
    """The refined fields' addressing is equal after training; 0.8 of
    pixels agree within 1e-3 and the quadrant means lie within four
    standard errors of the pixel differences."""
    scene, cam, film = jax_setup()
    vopt = jvspg.VSPGOptions()
    ref, jf, ji = jvspg.render_vspg(
        scene, cam, film, spp=4, cfg=CFG, gopt=AGOPT, vopt=vopt, seed=3,
        spp_per_pass=SPP_PER_PASS, use_pallas=False)
    ref = np.asarray(ref)
    ts, tc, tfilm, tcfg = convert.from_jax(scene, cam, film, CFG, "cpu")
    tg, tv = convert.options_from_jax(AGOPT, vopt)
    assert (tg.adaptive_extra, tg.refine_threshold) == (128, 16.0)
    img, field, isgb = tvspg.render_vspg(ts, tc, tfilm, 4, tcfg, tg, tv,
                                         seed=3, spp_per_pass=SPP_PER_PASS,
                                         backend="torch", device="cpu")
    img = img.numpy()
    assert field.iteration == int(jf.iteration) == 2
    assert field.n_leaves == int(jf.n_leaves) > 64, field.n_leaves
    for name in ("leaf_of", "refined", "child_base", "leaf_center"):
        np.testing.assert_array_equal(getattr(field, name).numpy(),
                                      np.asarray(getattr(jf, name)))
    assert isgb.ready and bool(ji.ready)
    assert np.isfinite(img).all()
    d = np.abs(img - ref)
    frac = ((d <= 1e-3 * np.abs(ref)) | (d <= 1e-5)).all(-1).mean()
    print(f"render_vspg adaptive (torch): {frac:.4f} of pixels within 1e-3, "
          f"{field.n_leaves} leaves")
    assert frac >= 0.8, frac
    for sl in QUADRANTS:
        diff = (img[sl] - ref[sl]).mean(-1).reshape(-1)
        err = diff.std(ddof=1) / np.sqrt(diff.size)
        assert abs(diff.mean()) <= 4.0 * err + 1e-6, (diff.mean(), err)
