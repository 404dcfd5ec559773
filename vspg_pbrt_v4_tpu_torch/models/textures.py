"""Albedo textures (counterpart of ``models/textures.py``): one row of a
parameter table a texture plus an image atlas, evaluated per lane with
masks. Kinds, those of the JAX package:

  0 CONSTANT  value rgb
  1 CHECKER   two colours alternating over the scaled uv lattice
  2 IMAGE     bilinear lookup in the image atlas (uv wrapped)
  3 SCALE     rgb scale times another texture (one nesting level)
  4 MIX       lerp(amount, tex1, tex2) (textures.h MixTexture)
  5 FBM       Perlin fractional Brownian motion (world space, grey)
  6 WRINKLED  Perlin turbulence (textures.h WrinkledTexture)
  7 MARBLE    spline-shaded perturbed sine (textures.h MarbleTexture)
  8 DOTS      procedural polka dots (textures.h DotsTexture)
  9 UV        the uv as a colour (textures.h UVTexture)
 10 WINDY     two-scale fBm waves (textures.h WindyTexture)
 11 BILERP    bilinear blend of four corner values over the wrapped,
              scaled uv (c0 = v00, c1 = v01, c2 = v10, c3 = v11)

The noise kinds read the world-space hit position scaled by params[2]; a
call without a position leaves them at their constant c0, as in the JAX
package. Ptex files bake into the atlas at build time (the face atlas,
below): after that a Ptex lookup is an IMAGE lookup at the uv the builder
gave the face's corners. Every formula keeps the JAX package's operation
order.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.device import OnDevice
from ..utils.math import py_mod

CONSTANT = 0
CHECKER = 1
IMAGE = 2
SCALE = 3
MIX = 4
FBM = 5
WRINKLED = 6
MARBLE = 7
DOTS = 8
UV = 9
WINDY = 10
BILERP = 11

# pbrt's marble colour spline (textures.cpp MarbleTexture)
_MARBLE_C = np.asarray([
    [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6],
    [0.5, 0.5, 0.5], [0.6, 0.59, 0.58], [0.58, 0.58, 0.6],
    [0.58, 0.58, 0.6], [0.2, 0.2, 0.33], [0.58, 0.58, 0.6],
], np.float32)


@dataclass(frozen=True)
class Textures(OnDevice):
    kind: torch.Tensor  # (T,) int32
    c0: torch.Tensor  # (T,3) value / checker even cells / scale / amount
    c1: torch.Tensor  # (T,3) checker odd cells / dots inside colour
    uvscale: torch.Tensor  # (T,2)
    image_id: torch.Tensor  # (T,) int32 index into the atlas, -1 none
    inner: torch.Tensor  # (T,) int32 nested texture (SCALE, MIX tex1)
    inner2: torch.Tensor  # (T,) int32 MIX tex2
    params: torch.Tensor  # (T,4) octaves, omega, scale, variation
    atlas: torch.Tensor  # (I,H,W,3) the images, resized to one size
    c2: torch.Tensor  # (T,3) bilerp v10
    c3: torch.Tensor  # (T,3) bilerp v11
    has_images: bool = False
    # computed from the rows: the table's kinds, and the kinds a SCALE or
    # MIX row's tex1 / a MIX row's tex2 may have (the nested level
    # evaluates only these)
    kinds: frozenset = field(init=False, repr=False, compare=False)
    inner_kinds: frozenset = field(init=False, repr=False, compare=False)
    inner2_kinds: frozenset = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        kind = self.kind.tolist()

        def nested(ids, of):
            # an id below 0 gathers row 0, as eval_texture clamps it
            return frozenset(kind[max(i, 0)] for k, i in zip(kind, ids)
                             if k in of)

        object.__setattr__(self, "kinds", frozenset(kind))
        object.__setattr__(self, "inner_kinds",
                           nested(self.inner.tolist(), (SCALE, MIX)))
        object.__setattr__(self, "inner2_kinds",
                           nested(self.inner2.tolist(), (MIX,)))

    @staticmethod
    def build(textures=(), images=(), *, device):
        """textures: list of dicts {kind, c0, c1, c2, c3, uvscale,
        image_id, inner, inner2, octaves, omega, scale, variation}; an
        empty list gives one constant white row, as in the JAX package.
        images: list of (H,W,3) arrays, nearest-resized to the largest
        height and width."""
        textures = list(textures) or [dict(kind=CONSTANT, c0=(1.0, 1.0, 1.0))]

        def rows(key, default, dtype=np.float32):
            return torch.as_tensor(np.asarray(
                [t.get(key, default) for t in textures], dtype),
                device=device)

        i32 = np.int32
        params = torch.as_tensor(np.asarray(
            [(t.get("octaves", 6), t.get("omega", 0.5), t.get("scale", 1.0),
              t.get("variation", 0.2)) for t in textures], np.float32),
            device=device)
        return Textures(rows("kind", CONSTANT, i32), rows("c0", (1, 1, 1)),
                        rows("c1", (0, 0, 0)), rows("uvscale", (1, 1)),
                        rows("image_id", -1, i32), rows("inner", -1, i32),
                        rows("inner2", -1, i32), params,
                        torch.as_tensor(build_atlas(images), device=device),
                        rows("c2", (0, 0, 0)), rows("c3", (0, 0, 0)),
                        bool(len(images)))


def build_atlas(images):
    """(I,H,W,3) float32: each image nearest-resized to the largest height
    and width (row ys = arange(H) * h // H, as the JAX package); no image
    gives one black texel."""
    if not len(images):
        return np.zeros((1, 1, 1, 3), np.float32)
    hmax = max(im.shape[0] for im in images)
    wmax = max(im.shape[1] for im in images)
    atlas = np.zeros((len(images), hmax, wmax, 3), np.float32)
    for i, im in enumerate(images):
        ys = np.arange(hmax) * im.shape[0] // hmax
        xs = np.arange(wmax) * im.shape[1] // wmax
        atlas[i] = np.asarray(im, np.float32)[ys][:, xs]
    return atlas


def _grey(v):
    return v[..., None] * torch.ones(3, device=v.device)


def _eval_level(bank: Textures, tid, uv, p, kinds):
    """One level of the texture tree: the kinds `kinds` but SCALE and MIX
    at the rows tid; a lane of another kind keeps its c0. Returns (rgb,
    kind, c0)."""
    from ..utils.noise import fbm, octave_points, perlin

    k = bank.kind[tid]
    c0 = bank.c0[tid]
    c1 = bank.c1[tid]
    su = uv * bank.uvscale[tid]
    one = torch.tensor(1.0, device=uv.device)
    out = c0  # CONSTANT
    if CHECKER in kinds:
        par = (torch.floor(su[..., 0]) + torch.floor(su[..., 1])).to(
            torch.int32) % 2
        out = torch.where((k == CHECKER)[..., None],
                          torch.where((par == 0)[..., None], c0, c1), out)
    if bank.has_images and IMAGE in kinds:
        img_id = torch.clamp(bank.image_id[tid], min=0).long()
        H, W = bank.atlas.shape[1], bank.atlas.shape[2]
        u = py_mod(su[..., 0], one) * (W - 1)
        v = (1.0 - py_mod(su[..., 1], one)) * (H - 1)
        x0 = torch.clamp(torch.floor(u).to(torch.int32), 0, W - 1)
        y0 = torch.clamp(torch.floor(v).to(torch.int32), 0, H - 1)
        x1 = torch.clamp(x0 + 1, max=W - 1)
        y1 = torch.clamp(y0 + 1, max=H - 1)
        fu = (u - x0)[..., None]
        fv = (v - y0)[..., None]
        x0, y0, x1, y1 = x0.long(), y0.long(), x1.long(), y1.long()
        a = bank.atlas[img_id, y0, x0]
        b = bank.atlas[img_id, y0, x1]
        c = bank.atlas[img_id, y1, x0]
        d = bank.atlas[img_id, y1, x1]
        bil = (a * (1 - fu) + b * fu) * (1 - fv) + (c * (1 - fu) + d * fu) * fv
        out = torch.where((k == IMAGE)[..., None], bil, out)
    if BILERP in kinds:
        bu = py_mod(su[..., 0], one)
        bv = py_mod(su[..., 1], one)
        blp = (((1 - bu) * (1 - bv))[..., None] * c0
               + ((1 - bu) * bv)[..., None] * c1
               + (bu * (1 - bv))[..., None] * bank.c2[tid]
               + (bu * bv)[..., None] * bank.c3[tid])
        out = torch.where((k == BILERP)[..., None], blp, out)
    if UV in kinds:
        out = torch.where((k == UV)[..., None], torch.stack(
            [py_mod(uv[..., 0], one), py_mod(uv[..., 1], one),
             torch.zeros_like(uv[..., 0])], -1), out)
    if DOTS in kinds:
        # one jittered dot a cell, where the cell's noise is positive
        cell = torch.floor(su + 0.5)
        cell3 = torch.cat([cell, torch.zeros_like(cell[..., :1])], -1)
        has_dot = perlin(cell3 + 0.5) > 0.0
        cx = cell[..., 0] + 0.35 * perlin(cell3 + torch.tensor(
            [1.5, 2.5, 0.0], device=uv.device))
        cy = cell[..., 1] + 0.35 * perlin(cell3 + torch.tensor(
            [4.5, 9.5, 0.0], device=uv.device))
        in_dot = has_dot & ((su[..., 0] - cx) ** 2 + (su[..., 1] - cy) ** 2
                            < 0.35 * 0.35)
        out = torch.where((k == DOTS)[..., None],
                          torch.where(in_dot[..., None], c1, c0), out)
    if p is not None and WINDY in kinds:
        windy = torch.abs(fbm(0.1 * p, 0.5, 3)) * fbm(p, 0.5, 6)
        out = torch.where((k == WINDY)[..., None], _grey(windy), out)
    if p is not None and kinds & {FBM, WRINKLED, MARBLE}:
        prm = bank.params[tid]
        octaves = torch.clamp(prm[..., 0], 1, 8)
        omega = prm[..., 1]
        ps = p * prm[..., 2:3]

        noise = perlin(octave_points(ps, 8))

        def ladder(values):
            """Eight octaves, each masked by the lane's octave count."""
            total = torch.zeros_like(omega)
            o = torch.ones_like(omega)
            for i in range(8):
                total = total + torch.where(i < octaves, o * values[i], 0.0)
                o = o * omega
            return total

        fbm_v = None
        if kinds & {FBM, MARBLE}:
            fbm_v = ladder(noise)
        if FBM in kinds:
            out = torch.where((k == FBM)[..., None], _grey(fbm_v), out)
        if WRINKLED in kinds:
            turb_v = ladder(torch.abs(noise))
            out = torch.where((k == WRINKLED)[..., None], _grey(turb_v), out)
        if MARBLE in kinds:
            # spline(c, 0.5 + 0.5 sin(scale * y + variation * fbm))
            t = 0.5 + 0.5 * torch.sin(ps[..., 1] + prm[..., 3] * fbm_v)
            nseg = _MARBLE_C.shape[0] - 3
            first = torch.clamp((t * nseg).to(torch.int32), 0, nseg - 1)
            tt = (t * nseg - first)[..., None]
            cm = torch.as_tensor(_MARBLE_C, device=uv.device)
            first = first.long()
            c_0, c_1 = cm[first], cm[first + 1]
            c_2, c_3 = cm[first + 2], cm[first + 3]
            s0 = (1 - tt) * c_0 + tt * c_1
            s1 = (1 - tt) * c_1 + tt * c_2
            s2 = (1 - tt) * c_2 + tt * c_3
            s0 = (1 - tt) * s0 + tt * s1
            s1 = (1 - tt) * s1 + tt * s2
            mar = 1.5 * ((1 - tt) * s0 + tt * s1)
            out = torch.where((k == MARBLE)[..., None], mar, out)
    return out, k, c0


def eval_texture(bank: Textures, tex_id, uv, p=None):
    """(R,) texture ids, (R,2) uv and optionally (R,3) world positions ->
    (R,3) rgb; tex_id < 0 gives ones. SCALE and MIX read one nested
    level."""
    tid = torch.clamp(tex_id, min=0).long()
    out, k, c0 = _eval_level(bank, tid, uv, p, bank.kinds)
    if bank.kinds & {SCALE, MIX}:
        inner_val, _, _ = _eval_level(
            bank, torch.clamp(bank.inner[tid], min=0).long(), uv, p,
            bank.inner_kinds)
        out = torch.where((k == SCALE)[..., None], c0 * inner_val, out)
        if MIX in bank.kinds:
            inner2_val, _, _ = _eval_level(
                bank, torch.clamp(bank.inner2[tid], min=0).long(), uv, p,
                bank.inner2_kinds)
            amt = c0[..., 0:1]
            out = torch.where((k == MIX)[..., None],
                              (1.0 - amt) * inner_val + amt * inner2_val, out)
    return torch.where((tex_id >= 0)[..., None], out, torch.ones_like(out))


# ---------------------------------------------------------------------------
# Per-face textures (pbrt's PtexTexture): the faces' texel grids are packed
# into one atlas image at build time, and the mesh's corner uvs rewritten
# to each face's rect, so that a lookup is a plain bilinear IMAGE lookup.
# Rects map face-local uv to texel centres, so that bilinear taps never
# cross into a neighbouring face. Containers: a raw .ptx file
# (tools/ptex.py) or an .npz of arrays face_0 .. face_{F-1}, each (h,w,3).
# ---------------------------------------------------------------------------


def save_face_textures(path, faces):
    """Write the .npz face container (one (h,w,3) array a face)."""
    np.savez(path, **{f"face_{i}": np.asarray(f, np.float32)
                      for i, f in enumerate(faces)})


def load_face_textures(path):
    """The faces' texel grids from a .ptx file or the .npz container."""
    if str(path).endswith(".ptx"):
        from ..tools.ptex import read_ptx

        return read_ptx(path).faces
    data = np.load(path)
    n = len([k for k in data.files if k.startswith("face_")])
    return [np.asarray(data[f"face_{i}"], np.float32) for i in range(n)]


def build_face_atlas(faces):
    """Shelf-pack the faces' texel grids into one atlas. Returns (atlas
    (H,W,3) float32, rects), rects[i] = (u0, v0, u1, v1) mapping face i's
    uv onto texel centres under the IMAGE lookup (x = u (W-1), y = (1-v)
    (H-1))."""
    faces = [np.atleast_3d(np.asarray(f, np.float32)) for f in faces]
    area = sum(f.shape[0] * f.shape[1] for f in faces)
    W = 1
    while W * W < 2 * area:
        W *= 2
    order = sorted(range(len(faces)), key=lambda i: -faces[i].shape[0])
    pos = [None] * len(faces)
    x = y = shelf_h = 0
    for i in order:
        h, w = faces[i].shape[:2]
        if x + w > W:
            x, y = 0, y + shelf_h
            shelf_h = 0
        pos[i] = (y, x)
        x += w
        shelf_h = max(shelf_h, h)
    H = y + shelf_h + 1  # one more row and column: u, v stay below 1
    atlas = np.zeros((H, W + 1, 3), np.float32)
    rects = []
    for i, f in enumerate(faces):
        h, w = f.shape[:2]
        r0, c0 = pos[i]
        atlas[r0:r0 + h, c0:c0 + w] = f[..., :3]
        rects.append((c0 / W, 1.0 - (r0 + h - 1) / (H - 1),
                      (c0 + w - 1) / W, 1.0 - r0 / (H - 1)))
    return atlas, rects
