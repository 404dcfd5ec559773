"""The furnaces of ``tests/test_guided_volpath.py`` on the port's
``render_guided``, at their sizes there: unbiased guided estimators keep a
furnace's energy with training running."""

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu_torch.models.cameras import PerspectiveCamera
from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath as tgv
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.models.lights import Lights
from vspg_pbrt_v4_tpu_torch.models.materials import DIFFUSE, Materials
from vspg_pbrt_v4_tpu_torch.models.media import Media
from vspg_pbrt_v4_tpu_torch.models.shapes import Geometry
from vspg_pbrt_v4_tpu_torch.utils import transform as tr

# one torch thread a process (see test_torch_volpath.py)
torch.set_num_threads(1)


def _camera(res):
    return PerspectiveCamera.make(
        tr.look_at((0, 0, -4), (0, 0, 0), (0, 1, 0), device="cpu"), 30.0,
        (res, res), device="cpu")


@pytest.mark.parametrize("mode", ["mis", "ris"])
def test_guided_volume_furnace(mode):
    """Scattering fog in a uniform environment stays a furnace with
    guiding on and training running (test_guided_volpath.py)."""
    L0 = 0.6
    scene = tv.make_fog_box_scene([0, 0, 0], [1.2] * 3, g=0.5,
                                  env_L=[L0] * 3, device="cpu")
    img, field = tgv.render_guided(
        scene, _camera(24), RGBFilm.make((24, 24), device="cpu"), spp=48,
        cfg=tv.VolPathConfig(max_depth=24),
        gopt=tgv.GuidingOptions(mode=mode, field_res=8, record_depth=6,
                                min_train_weight=16.0),
        seed=3, spp_per_pass=4, device="cpu")
    img = img.numpy()
    assert np.isfinite(img).all()
    assert field.iteration > 0, "training never ran"
    assert abs(img.mean() - L0) < 0.035 * L0, img.mean()


@pytest.mark.parametrize("mode", ["mis", "ris"])
def test_guided_surface_furnace(mode):
    """A diffuse sphere in a uniform environment with surface guiding
    reads rho * L0 (test_guided_volpath.py)."""
    rho, L0 = 0.7, 1.0
    scene = tv.Scene(
        Geometry.build(spheres=[dict(c=(0, 0, 0), r=1.0, mat=0, light=-1,
                                     med_in=-1, med_out=-1)], device="cpu"),
        Materials.build([dict(type=DIFFUSE, albedo=(rho,) * 3)],
                        device="cpu"),
        Media.make(device="cpu"),
        Lights.make(env_L=[L0] * 3, world_radius=100.0, device="cpu"))
    img, field = tgv.render_guided(
        scene, _camera(32), RGBFilm.make((32, 32), device="cpu"), spp=48,
        gopt=tgv.GuidingOptions(mode=mode, field_res=8, record_depth=4,
                                min_train_weight=16.0),
        seed=5, spp_per_pass=4, device="cpu")
    center = img.numpy()[13:19, 13:19].mean((0, 1))
    assert field.iteration > 0
    assert np.allclose(center, rho * L0, rtol=0.05), center
