"""One scene text with every material and texture of the JAX builder
(``materials_text``: thindielectric, diffusetransmission, plastic,
coatedconductor, subsurface, hair, mix, measured, a rough dielectric and
cooktorrance; imagemap, checkerboard, mix, scale, fbm, wrinkled, windy,
marble, dots, bilerp, uv and ptex), parsed and built by both packages
(every field equal), rendered through ``volpath.render`` with the
subsurface branch on (as the CLI sets it for such a scene) pixel for
pixel with the JAX XLA render (one torch VSPG training wave on it:
tests/test_torch_materials_wave.py); and every integrator's call site
passing the hit position to the textures and the mix hash.

Tolerances: the build as tests/test_torch_scene_builder.py (ints exact,
floats 1e-6 relative); the render as tests/test_torch_lights_render.py
(0.99 of the pixels within 1e-3 relative or 1e-6 absolute, the means
within 1e-3 relative: a path that bounces off the mix sphere moves its
pixel) over the pixels whose camera ray does not hit the mix sphere, and
the means within 1e-2 relative over all pixels. A
MIX hit picks its constituent by a hash of its position's bits (|p| *
65536 truncated): XLA computes the hit point with FMAs, PyTorch without,
and a lane whose scaled coordinate lies within an ulp of an integer takes
the other constituent in one package (lane for lane on equal positions in
tests/test_torch_materials_ext.py)."""

import os

import numpy as np
import pytest
import torch

from vspg_pbrt_v4_tpu.models.integrators import volpath as jv
from vspg_pbrt_v4_tpu.scene import build_render_setup as jbuild
from vspg_pbrt_v4_tpu.scene import parse_pbrt_string as jparse
from vspg_pbrt_v4_tpu_torch.models import materials as tm
from vspg_pbrt_v4_tpu_torch.models.integrators import volpath as tv
from vspg_pbrt_v4_tpu_torch.models.integrators import vspg as tvspg
from vspg_pbrt_v4_tpu_torch.scene import build_render_setup as tbuild
from vspg_pbrt_v4_tpu_torch.scene import parse_pbrt_string as tparse

from test_torch_scene_builder import _check_alike

# the spheres' Material lines, in order (a textured reflectance only on
# diffuse: the JAX builder reads every other material's reflectance as an
# RGB and fails on a texture)
SPHERES = [
    'Material "thindielectric" "float eta" [1.5]',
    'Material "diffusetransmission" "rgb reflectance" [0.3 0.5 0.2] '
    '"rgb transmittance" [0.4 0.3 0.2]',
    'Material "plastic" "rgb reflectance" [0.6 0.3 0.2] "float roughness" '
    '[0.1]',
    'Material "coatedconductor" "float interface.roughness" [0.05] '
    '"float conductor.roughness" [0.2]',
    'Material "subsurface" "rgb sigma_s" [2 2 2] "rgb sigma_a" '
    '[0.02 0.1 0.4]',
    'Material "hair" "rgb reflectance" [0.6 0.4 0.2]',
    'Material "mix" "string materials" ["gold" "dotted"] "float amount" '
    '[0.5]',
    'Material "measured" "string filename" "{tmp}/merl.binary"',
    'Material "dielectric" "float roughness" [0.2] "float eta" [1.4]',
    'Material "cooktorrance" "rgb reflectance" [0.5 0.4 0.3] '
    '"float roughness" [0.3]',
    'Material "diffuse" "texture reflectance" "wrinkled"',
    'Material "diffuse" "texture reflectance" "scaled"',
    'Material "diffuse" "texture reflectance" "windy"',
    'Material "diffuse" "texture reflectance" "bilerp"',
    'Material "diffuse" "texture reflectance" "uvt"',
    'Material "diffuse" "texture reflectance" "fbm"',
]

HEAD = '''Integrator "volpath" "integer maxdepth" [5]
Sampler "independent" "integer pixelsamples" [{spp}]
Film "rgb" "integer xresolution" [{res}] "integer yresolution" [{res}]
LookAt 0 3.4 -2.2  0 0 0.5  0 1 0
Camera "perspective" "float fov" [58]
WorldBegin
LightSource "infinite" "rgb L" [0.4 0.45 0.5]
LightSource "point" "rgb I" [6 6 6] "point3 from" [0 3 -1]
Texture "img" "spectrum" "imagemap" "string filename" "{tmp}/img.pfm"
  "float uscale" [2]
Texture "checks" "spectrum" "checkerboard" "float uscale" [8]
  "float vscale" [8] "rgb tex1" [0.8 0.8 0.8] "rgb tex2" [0.2 0.3 0.4]
Texture "mixed" "spectrum" "mix" "string tex1" "img" "string tex2" "checks"
  "float amount" [0.4]
Texture "fbm" "spectrum" "fbm" "float scale" [3]
Texture "wrinkled" "spectrum" "wrinkled" "float scale" [4]
  "integer octaves" [5]
Texture "windy" "spectrum" "windy"
Texture "marble" "spectrum" "marble" "float scale" [2] "float variation" [0.5]
Texture "scaled" "spectrum" "scale" "string tex" "marble"
  "rgb scale" [0.6 0.5 0.4]
Texture "dots" "spectrum" "dots" "float uscale" [6] "float vscale" [6]
  "rgb inside" [0.9 0.1 0.1] "rgb outside" [0.2 0.6 0.3]
Texture "bilerp" "spectrum" "bilerp" "rgb v00" [1 0 0] "rgb v01" [0 1 0]
  "rgb v10" [0 0 1] "rgb v11" [1 1 0]
Texture "uvt" "spectrum" "uv"
Texture "faces" "spectrum" "ptex" "string filename" "{tmp}/faces.ptx"
MakeNamedMaterial "gold" "string type" "conductor"
  "rgb reflectance" [0.9 0.7 0.3] "float roughness" [0.1]
MakeNamedMaterial "dotted" "string type" "diffuse"
  "texture reflectance" "dots"
AttributeBegin
  Material "diffuse" "texture reflectance" "mixed"
  Shape "trianglemesh" "point3 P" [-3 0 -3  3 0 -3  3 0 3  -3 0 3]
    "integer indices" [0 1 2  0 2 3] "point2 uv" [0 0  1 0  1 1  0 1]
AttributeEnd
AttributeBegin
  Material "diffuse" "texture reflectance" "faces"
  Shape "trianglemesh" "point3 P" [-2 0 2  2 0 2  2 2 2  -2 2 2]
    "integer indices" [0 1 2  0 2 3]
AttributeEnd
'''


def write_assets(tmp, img_res=(12, 20), merl_dims=(9, 9, 18),
                 ptex_faces=2, ptex_res=4):
    """The files the scene reads, made here from a seed: an RGB image
    (PFM), a MERL .binary of a smooth, mildly glossy BRDF and a Ptex
    file of constant-coloured faces written by the port's write_ptx."""
    from vspg_pbrt_v4_tpu_torch.tools.ptex import write_ptx
    from vspg_pbrt_v4_tpu_torch.utils.image import write_pfm

    rng = np.random.default_rng(19)
    write_pfm(os.path.join(tmp, "img.pfm"),
              rng.uniform(0.05, 0.95, img_res + (3,)).astype(np.float32))
    th, td, pd = merl_dims
    theta_h = (np.arange(th) + 0.5) / th * (np.pi / 2)
    lobe = 0.2 + 2.0 * np.exp(-(theta_h / 0.3) ** 2)
    vals = np.empty((3,) + merl_dims, np.float64)
    scale = (1 / 1500, 1.15 / 1500, 1.66 / 1500)
    for c, tint in enumerate((0.9, 0.6, 0.4)):
        vals[c] = (tint * lobe / np.pi)[:, None, None] / scale[c]
    with open(os.path.join(tmp, "merl.binary"), "wb") as f:
        f.write(np.asarray(merl_dims, np.int32).tobytes())
        f.write(vals.tobytes())
    cols = rng.uniform(0.1, 0.9, (ptex_faces, 3)).astype(np.float32)
    write_ptx(os.path.join(tmp, "faces.ptx"),
              [np.broadcast_to(c, (ptex_res, ptex_res, 3)) for c in cols],
              datatype="half")


def materials_text(tmp, res=24, spp=4):
    """The scene text (its assets written into `tmp`): a textured floor,
    a ptex wall, and one sphere of radius 0.3 a material on a 4 x 4
    grid."""
    write_assets(tmp)
    text = HEAD.format(tmp=tmp, res=res, spp=spp)
    for i, line in enumerate(SPHERES):
        x, z = -1.2 + 0.8 * (i % 4), -0.6 + 0.8 * (i // 4)
        text += (f"AttributeBegin\n  Translate {x} 0.3 {z}\n  "
                 f"{line.format(tmp=tmp)}\n  Shape \"sphere\" "
                 f"\"float radius\" [0.3]\nAttributeEnd\n")
    return text


def _close_pixels(img, ref, keep):
    """(fraction of the kept pixels within 1e-3 relative or 1e-6
    absolute, printed)."""
    diff = np.abs(img - ref)
    ok = ((diff <= 1e-3 * np.abs(ref)) | (diff <= 1e-6)).all(-1)
    print(f"{ok[keep].mean():.4f} of {keep.sum()} pixels within 1e-3, "
          f"all {ok.mean():.4f}; means {img.mean():.6f} and {ref.mean():.6f}")
    return ok[keep].mean()


def _off_mix(scene, camera, film):
    """(ny, nx) mask of the pixels whose centre ray misses the MIX
    sphere."""
    nx, ny = film.resolution
    ys, xs = np.mgrid[0:ny, 0:nx]
    raster = torch.tensor(np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5], -1),
                          dtype=torch.float32)
    o, d = camera.generate_rays(raster,
                                      torch.full((nx * ny, 2), 0.5))[:2]
    mid = scene.geometry.intersect(o, d).mat_id
    kind = scene.materials.mat_type[torch.clamp(mid, min=0).long()]
    keep = ~((mid >= 0) & (kind == tm.MIX))
    assert not bool(keep.all())
    return keep.numpy().reshape(ny, nx)


def test_builds_alike(tmp_path):
    text = materials_text(str(tmp_path))
    ts, js = tbuild(tparse(text), device="cpu"), jbuild(jparse(text))
    _check_alike(ts, js)
    kinds = ts.scene.materials.kinds
    assert set(range(12)) <= kinds and tm.ROUGH_DIELECTRIC in kinds
    assert ts.scene.textures.kinds == set(range(1, 12))


def test_render_matches_jax(tmp_path):
    text = materials_text(str(tmp_path))
    ts, js = tbuild(tparse(text), device="cpu"), jbuild(jparse(text))
    cfg = jv.VolPathConfig(max_depth=5, sss=True)
    ref = np.asarray(jv.render(js.scene, js.camera, js.film, spp=4, cfg=cfg,
                               seed=19, spp_per_pass=4))
    img = tv.render(ts.scene, ts.camera, ts.film, spp=4,
                    cfg=tv.VolPathConfig(max_depth=5, sss=True), seed=19,
                    spp_per_pass=4, device="cpu").numpy()
    assert np.isfinite(img).all()
    keep = _off_mix(ts.scene, ts.camera, ts.film)
    assert _close_pixels(img, ref, keep) >= 0.99
    assert abs(img[keep].mean() - ref[keep].mean()) <= 1e-3 * ref.mean()
    assert abs(img.mean() - ref.mean()) <= 1e-2 * ref.mean()


@pytest.mark.parametrize("route", ["volpath", "persistent", "guided",
                                   "vspg"])
def test_every_call_site_passes_the_position(route, monkeypatch,
                                            tmp_path):
    """Each integrator's surface shading hands the hit position to
    gather_textured: without it the noise textures read their constant
    and a mix resolves to nothing, and nothing fails."""
    from vspg_pbrt_v4_tpu_torch.models.integrators import guided_volpath as tgv

    seen = []
    orig = tm.Materials.gather_textured

    def spy(self, textures, mat_id, uv, p=None):
        seen.append(p is not None)
        return orig(self, textures, mat_id, uv, p)

    monkeypatch.setattr(tm.Materials, "gather_textured", spy)
    s = tbuild(tparse(materials_text(str(tmp_path), res=8, spp=2)),
               device="cpu")
    cfg = tv.VolPathConfig(max_depth=3)
    args = (s.scene, s.camera, s.film)
    gopt = tgv.GuidingOptions(field_res=4)
    if route == "volpath":
        tv.render(*args, spp=2, cfg=cfg, device="cpu")
    elif route == "persistent":
        tv.render_persistent(*args, spp=2, cfg=cfg, backend="torch",
                             device="cpu")
    elif route == "guided":
        tgv.render_guided(*args, spp=2, cfg=cfg, gopt=gopt, device="cpu")
    else:
        tvspg.render_vspg(*args, 2, cfg, gopt, tvspg.VSPGOptions(),
                          backend="torch", device="cpu")
    assert seen and all(seen), seen
