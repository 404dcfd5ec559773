"""The CUDA kernels against their plain versions on the card. Marked
``cuda``; they skip where no NVIDIA GPU is present. On a GPU machine
without JAX, skip tests/conftest.py (it configures JAX):
``python -m pytest --noconftest tests/test_torch_cuda.py -q``."""

import pytest
import torch

from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk

pytestmark = pytest.mark.cuda

CFG = tv.VolPathConfig(max_depth=32, max_events=128, max_collisions=2048)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


def _consts(make, res, dev):
    return vk.extract_constants(make(device=dev),
                                vk.bench_camera(res, device=dev),
                                RGBFilm.make((res, res), device=dev), CFG)


@pytest.mark.parametrize("make,spp,min_frac", [
    (vk.make_fog_box_scene, 8, 0.99),
    (vk.make_cloud64_scene, 4, 0.98),
])
def test_kernel_matches_plain(dev, make, spp, min_frac):
    c = _consts(make, 48, dev)
    before = vk.LAUNCHES[c.kind]
    k = vk.render(c, spp, 3)
    p = (vk.render_homog_plain if c.kind == "homog"
         else vk.render_grid_plain)(c, spp, 3)
    torch.cuda.synchronize()
    assert vk.LAUNCHES[c.kind] == before + 1
    diff = (k - p).abs()
    # same random stream; FMA contraction and rare last-ulp branch flips
    ok = ((diff <= 1e-3 * p.abs()) | (diff <= 1e-5)).all(-1)
    assert ok.float().mean().item() >= min_frac


def test_wrapper_checks_inputs(dev):
    c = _consts(vk.make_cloud64_scene, 16, dev)
    bad = vk.KernelConstants(c.kind, c.nx, c.ny, c.imaging_ratio, c.fconst,
                             c.iconst, c.density.double(), c.majorant)
    with pytest.raises(ValueError):
        vk.render_grid(bad, 1, 0)
    with pytest.raises(ValueError):
        vk.render_grid(c, 0, 0)
