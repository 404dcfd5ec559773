"""B2a against the Pallas grid kernel run in interpret mode, as the JAX
package's own tests run it, on the bf16-exact 16^3 cloud (same estimator,
different random streams: Monte Carlo agreement)."""

import numpy as np

from vspg_pbrt_v4_tpu.ops import pallas_volpath as pv

from test_torch_kernel_grid import CFG, assert_mc_agree, cloud_setup, \
    plain_render


def test_grid_plain_matches_pallas_interpret():
    scene, cam, film = cloud_setup()
    ref = np.asarray(pv.render_homog_pallas(scene, cam, film, 64, CFG,
                                            seed=9, interpret=True))
    assert_mc_agree(plain_render(scene, cam, film, 256, 7), ref)
