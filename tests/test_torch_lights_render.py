"""``volpath.render`` of a scene with every light kind under the bvh
light sampler: the port's build of the scene text against the JAX
package's build and XLA render, pixel for pixel (the torch wavefront is
the XLA path's twin lane for lane).

The scene (``test_torch_scene_builder.LIGHTS_BODY``, case "all"): a
diffuse floor and wall, a point light with blackbody I, a spot, a
goniometric and a projection light reading PFMs, a distant light, an
image environment from a 2:1 lat-long PFM and a blackbody area light, at
16x16x8, maxdepth 5.

Tolerance: at least 0.99 of the pixels within 1e-3 relative (or 1e-6
absolute) and the image means within 1e-4 relative. A light pick whose
uniform sits within an ulp of a branch edge of the light BVH, or a texel
lookup at a texel edge, may take the neighbouring branch or texel in one
package (``test_torch_lightsamplers.py``, ``test_torch_lights.py``); such a
lane moves its pixel by one sample's share.
"""

import numpy as np

from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.scene import build_render_setup as jbuild
from vspg_pbrt_v4_tpu.scene import parse_pbrt_string as jparse
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.scene import build_render_setup as tbuild
from vspg_pbrt_v4_tpu_torch.scene import parse_pbrt_string as tparse

from test_torch_scene_builder import LIGHTS_BODY, light_lines

SPP = 8


def test_all_lights_render_matches_jax(tmp_path):
    text = LIGHTS_BODY.format(sampler="bvh",
                              lights=light_lines("all", str(tmp_path)))
    js, ts = jbuild(jparse(text)), tbuild(tparse(text), device="cpu")
    assert ts.scene.lights.bvh is not None and ts.scene.lights.has_env_img
    cfg = jv.VolPathConfig(max_depth=5)
    ref = np.asarray(jv.render(js.scene, js.camera, js.film, spp=SPP,
                               cfg=cfg, seed=18, spp_per_pass=SPP))
    img = tv.render(ts.scene, ts.camera, ts.film, spp=SPP,
                    cfg=tv.VolPathConfig(max_depth=5), seed=18,
                    spp_per_pass=SPP, device="cpu").numpy()
    assert img.shape == ref.shape == (16, 16, 3) and np.isfinite(img).all()
    diff = np.abs(img - ref)
    ok = ((diff <= 1e-3 * np.abs(ref)) | (diff <= 1e-6)).all(-1)
    print(f"{ok.mean():.4f} of pixels within 1e-3, means {img.mean():.6f} "
          f"and {ref.mean():.6f}")
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(img.mean() - ref.mean()) <= 1e-4 * ref.mean()
    assert ref.mean() > 0.05
