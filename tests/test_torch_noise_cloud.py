"""The procedural cloud medium: the port's Perlin noise, ``CloudMedium`` and
its segment iterator against the JAX package's on seeded points and rays;
``volpath.render`` of a cloud in a box pixel for pixel with JAX's XLA
render; the parse and build of the shipped VSPG scene file wound outward
against JAX's builder; and both kernel predicates refusing a scene that
holds a cloud."""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models import media as jm
from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.models.lights import Lights as JLights
from vspg_pbrt_v4_tpu.models.materials import Materials as JMaterials
from vspg_pbrt_v4_tpu.models.shapes import Geometry as JGeometry
from vspg_pbrt_v4_tpu.scene import build_render_setup as jbuild
from vspg_pbrt_v4_tpu.scene import parse_pbrt_string as jparse
from vspg_pbrt_v4_tpu.utils import noise as jnoise
from vspg_pbrt_v4_tpu_torch import convert
from vspg_pbrt_v4_tpu_torch.models import media as tm
from vspg_pbrt_v4_tpu_torch.models.film import RGBFilm
from vspg_pbrt_v4_tpu_torch.models.guiding.field import GuidingField
from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath as tgv
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg
from vspg_pbrt_v4_tpu_torch.ops import volpath_kernels as vk
from vspg_pbrt_v4_tpu_torch.ops import vspg_kernels as gk
from vspg_pbrt_v4_tpu_torch.scene import build_render_setup as tbuild
from vspg_pbrt_v4_tpu_torch.scene import parse_pbrt_string as tparse
from vspg_pbrt_v4_tpu_torch.utils import noise as tnoise

from test_torch_scene_builder import _check_alike
from test_torch_volpath import camera_film

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOUD_ARGS = dict(sigma_a=(0.1, 0.1, 0.1), sigma_s=(2.0, 2.2, 2.4), g=0.3,
                  p0=(-1, -1, -1), p1=(1, 1, 1), density=4.0)


def outward(text):
    """`text` with every triangle's corners in the other order: the shipped
    file winds its cube inward, which puts the cloud outside it."""
    def flip(m):
        v = m.group(2).split()
        return m.group(1) + "  ".join(
            f"{v[i]} {v[i + 2]} {v[i + 1]}" for i in range(0, len(v), 3)) + "]"

    return re.sub(r'("integer indices"\s*\[)([^\]]*)\]', flip, text)


def test_perlin_matches_jax():
    """4096 seeded points over [-7, 7)^3 (negative lattice coordinates
    wrap to uint32 as JAX's cast does), and the fBm over them."""
    p = np.random.default_rng(0).uniform(-7, 7, (4096, 3)).astype(np.float32)
    assert (np.floor(p) < 0).any()
    for fj, ft in ((jnoise.perlin, tnoise.perlin), (jnoise.fbm, tnoise.fbm)):
        want = np.asarray(fj(jnp.asarray(p)))
        got = ft(torch.as_tensor(p)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(want).max() > 0.5


def _clouds():
    return (jm.CloudMedium.make(**CLOUD_ARGS),
            tm.CloudMedium.make(**CLOUD_ARGS, device="cpu"))


def test_cloud_density_and_segments_match_jax():
    """density_at and sigma_at on 4096 points in and around the bounds, and
    seg_init/seg_next on procedural lanes (a homogeneous medium first, so
    the cloud's id is past the block) within 1e-5."""
    rng = np.random.default_rng(1)
    jc, tc = _clouds()
    p = rng.uniform(-1.3, 1.3, (4096, 3)).astype(np.float32)
    d_j = np.asarray(jc.density_at(jnp.asarray(p)))
    d_t = tc.density_at(torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-5)
    assert 0 < d_j.mean() < 1 and (d_j == 0).any()
    for a, b in zip(jc.sigma_at(jnp.asarray(p)),
                    tc.sigma_at(torch.as_tensor(p))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)

    homog = [dict(sigma_a=(0.2,) * 3, sigma_s=(0.3,) * 3)]
    jmed = jm.Media.make(homog, procedurals=(jc,))
    tmed = convert.from_jax(jv.Scene(JGeometry.build(), JMaterials.build([]),
                                     jmed, JLights.make()),
                            *camera_film(), jv.VolPathConfig(), "cpu")[0].media
    assert tmed.base_procedural == 1 and len(tmed.procedurals) == 1
    R = 512
    o = rng.uniform(-2.5, 2.5, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:8, 0] = 0.0  # axis-parallel rays: NaN slab distances
    d[:8] /= np.linalg.norm(d[:8], axis=-1, keepdims=True)
    t_max = rng.uniform(0.5, 6, R).astype(np.float32)
    mid = rng.integers(-1, 3, R).astype(np.int32)  # 2: an unknown id
    act = rng.uniform(size=R) < 0.9
    args_j = [jnp.asarray(a) for a in (mid, o, d, t_max, act)]
    args_t = [torch.as_tensor(a) for a in (mid, o, d, t_max, act)]
    it_j = jm.seg_init(jmed, *args_j)
    it_t = tm.seg_init(tmed, *args_t)
    # a procedural lane has one segment: seg_next exhausts it
    for a_j, a_t in ((it_j, it_t),
                     (jm.seg_next(jmed, args_j[0], it_j, args_j[4]),
                      tm.seg_next(tmed, args_t[0], it_t, args_t[4]))):
        for f in ("t_seg_start", "t_seg_end", "sigma_maj", "t_exit", "done"):
            a, b = np.asarray(getattr(a_j, f)), getattr(a_t, f).numpy()
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=f)
    assert (~np.asarray(it_j.done) & act & (mid == 1)).any()
    mp_j = jmed.sample_point(jnp.asarray(mid), jnp.asarray(o))
    mp_t = tmed.sample_point(torch.as_tensor(mid), torch.as_tensor(o))
    for a, b in zip(mp_j, mp_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def jax_cloud_box():
    jc, _ = _clouds()
    lights = JLights.make(point_p=[(0.0, 1.8, 0.0)], point_I=[(8.0,) * 3],
                          env_L=[0.1, 0.12, 0.15], world_radius=100.0)
    geom = JGeometry.build(boxes=[dict(bmin=(-1, -1, -1), bmax=(1, 1, 1),
                                       mat=-1, light=-1, med_in=0,
                                       med_out=-1)])
    return jv.Scene(geom, JMaterials.build([]),
                    jm.Media.make(procedurals=(jc,)), lights)


def test_render_cloud_box_matches_jax():
    """volpath.render at 16x16x2 (2 a pass) pixel for pixel with JAX's XLA
    render, at test_torch_volpath_render.py's bar."""
    scene = jax_cloud_box()
    cam, film = camera_film()
    cfg = jv.VolPathConfig(max_depth=8, max_events=32)
    ref = np.asarray(jv.render(scene, cam, film, spp=2, cfg=cfg, seed=5,
                               spp_per_pass=2))
    ts, tc, tf, tcfg = convert.from_jax(scene, cam, film, cfg, "cpu")
    img = tv.render(ts, tc, tf, spp=2, cfg=tcfg, seed=5, spp_per_pass=2,
                    device="cpu").numpy()
    diff = np.abs(img - ref)
    ok = ((diff <= 1e-3 * np.abs(ref)) | (diff <= 1e-6)).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert ref.mean() > 0


def _cloud_file(variant):
    with open(os.path.join(REPO, "scenes", "cloud_vspg.pbrt")) as f:
        text = outward(f.read())
    if variant == "fog outside":
        # a homogeneous medium ahead of the cloud moves the cloud's id past
        # the homogeneous block
        text = text.replace(
            'MakeNamedMedium "cloud"',
            'MakeNamedMedium "fog" "string type" "homogeneous"\n'
            '    "rgb sigma_a" [0.01 0.01 0.01] "rgb sigma_s" [0.02 0.02 0.02]'
            '\nMakeNamedMedium "cloud"').replace(
            'MediumInterface "cloud" ""', 'MediumInterface "cloud" "fog"')
    return text


@pytest.mark.parametrize("variant", ["outward", "fog outside"])
def test_cloud_file_builds_alike(variant):
    """The shipped VSPG scene file wound outward: the port's parse and build
    equal JAX's builder plus convert.from_jax (floats within 1e-6)."""
    text = _cloud_file(variant)
    ts = tbuild(tparse(text), device="cpu")
    _check_alike(ts, jbuild(jparse(text)))
    media = ts.scene.media
    assert len(media.procedurals) == 1
    cloud = media.base_procedural
    assert cloud == (1 if variant == "fog outside" else 0)
    assert set(ts.scene.geometry.tri_med_in.tolist()) == {cloud}


def test_kernel_predicates_refuse_a_cloud():
    """A box with one homogeneous medium, and the grid cloud, each with a
    procedural cloud beside it: B1/B2 (extract_constants) and B3/B4
    (vspg_kernels.supports) take the scene without it and refuse it with
    it. Without the refusal the cloud would render as empty space."""
    cfg = tv.VolPathConfig()
    cam = vk.bench_camera(16, device="cpu")
    film = RGBFilm.make((16, 16), device="cpu")
    _, tc = _clouds()

    def with_cloud(scene):
        return dataclasses.replace(scene, media=dataclasses.replace(
            scene.media, procedurals=(tc,)))

    fog = vk.make_fog_box_scene(device="cpu")
    assert vk.extract_constants(fog, cam, film, cfg) is not None
    assert vk.extract_constants(with_cloud(fog), cam, film, cfg) is None
    grid = vk.make_cloud64_scene(device="cpu")
    assert vk.extract_constants(grid, cam, film, cfg) is not None
    assert vk.extract_constants(with_cloud(grid), cam, film, cfg) is None
    gopt, vopt = tgv.GuidingOptions(field_res=4), tvspg.VSPGOptions()
    field = GuidingField.make((-1,) * 3, (1,) * 3, res=4, device="cpu")
    assert gk.supports(grid, cam, film, cfg, gopt, vopt, field)
    assert not gk.supports(with_cloud(grid), cam, film, cfg, gopt, vopt,
                           field)
