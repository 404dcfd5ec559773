"""The Cornell surface class through the torch wavefront: area-light
emission with MIS at surface hits and area-light NEE in
``volpath.volpath_bounce``, against the JAX package's XLA
``render_persistent`` on the same lockstep wavefront and random stream
(the box with every light type of the class: two one-sided ceiling
emitters, a two-sided emitter triangle, a point light and an env), pixel
for pixel; and the port's scene makers against ``convert.from_jax`` of the
JAX ones, field for field."""

import dataclasses

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu_torch.convert import from_jax
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.ops import surface_kernels as sk

from test_torch_surface_kernel import CFG, jax_cornell_lit, view


def test_render_persistent_matches_jax_cornell_lit():
    """4 spp at 16^2, pixel for pixel (1e-3 relative on at least 99% of
    pixels, the teaser test's bar: a rare last-ulp branch flip may move a
    pixel further)."""
    scene = jax_cornell_lit()
    cam, film = view()
    ref = np.asarray(jv.render_persistent(scene, cam, film, spp=4, cfg=CFG,
                                          seed=5, backend="jnp"))
    ts, tc, tf, tcfg = from_jax(scene, cam, film, CFG, "cpu")
    assert ts.lights.n_area == 3 and ts.lights.n_point == 1
    img = tv.render_persistent(ts, tc, tf, spp=4, cfg=tcfg, seed=5,
                               backend="torch", device="cpu").numpy()
    d = np.abs(img - ref)
    frac = ((d <= 1e-3 * np.abs(ref)) | (d <= 1e-6)).all(-1).mean()
    print(f"cornell lit render_persistent: {frac:.4f} of pixels within 1e-3")
    assert frac >= 0.99, frac
    assert ref.mean() > 0


def _same(port, ref, path=""):
    """Every tensor field of two port scene objects equal (recursively)."""
    if isinstance(port, torch.Tensor):
        assert port.dtype == ref.dtype, path
        assert torch.equal(port, ref), path
    elif dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            _same(getattr(port, f.name), getattr(ref, f.name),
                  f"{path}.{f.name}")
    elif isinstance(port, tuple):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _same(a, b, f"{path}[{i}]")
    else:
        assert port == ref, path


@pytest.mark.parametrize("name", ["cornell", "cornell lit"])
def test_scene_makers_match_from_jax(name):
    make_j, make_t = {
        "cornell": (jv.make_cornell_box_scene, tv.make_cornell_box_scene),
        "cornell lit": (jax_cornell_lit, sk.make_cornell_lit_scene),
    }[name]
    cam, film = view()
    ref = from_jax(make_j(), cam, film, CFG, "cpu")[0]
    _same(make_t(device="cpu"), ref, name)
