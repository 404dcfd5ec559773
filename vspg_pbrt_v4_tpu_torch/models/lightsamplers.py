"""BVH light sampler: many-light selection adapted to the shading point
(counterpart of ``models/lightsamplers.py``; the reference's
``BVHLightSampler``, lightsamplers.h:260-464, lightsamplers.cpp:73-318).

The finite lights (point, spot, goniometric, projection, area) are held
in a bounding-volume hierarchy built on the host; each node carries a
light cone (axis, emission spread theta_o, falloff spread theta_e) and
its total power phi. Selection walks the tree from the root, choosing a
child in proportion to a conservative importance seen from the shading
point and remapping the uniform at each level.

As in the JAX package, by design:
- The nodes are flat arrays and the walk is a fixed number of steps
  (``max_depth + 1``) over every lane at once, with no stack.
- A pmf query (MIS at an emissive hit) replays the root-to-leaf path from
  each light's bit trail (``lightToBitTrail``, lightsamplers.h:341-366).
  The trails are int64: torch has no right shift of uint32 on the CPU.
- The importance drops the shading-normal factor (lightsamplers.h:190-196)
  so that sampling and the pmf agree at every path vertex, volume
  vertices included.
- The build splits at the median of the largest centroid axis in place
  of the cone-measure SAH (lightsamplers.cpp:147-236): any topology is
  unbiased, only the variance differs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import OnDevice


@dataclass(frozen=True)
class LightBVH(OnDevice):
    """Flat light-BVH arrays: N nodes (2L - 1 for L lights, preorder)."""

    bmin: torch.Tensor  # (N,3)
    bmax: torch.Tensor  # (N,3)
    axis: torch.Tensor  # (N,3) cone axis
    phi: torch.Tensor  # (N,) power
    cos_o: torch.Tensor  # (N,) emission-spread cosine
    cos_e: torch.Tensor  # (N,) falloff-spread cosine
    two_sided: torch.Tensor  # (N,) bool
    child1: torch.Tensor  # (N,) right child (the left is i+1); -1 at leaves
    leaf_light: torch.Tensor  # (N,) global light index; -1 inside
    trail: torch.Tensor  # (n_lights,) int64 root-to-leaf bits, LSB first
    trail_node: torch.Tensor  # (n_lights,) leaf node of each light (-1)
    max_depth: int


class _BuildLight(NamedTuple):
    bmin: np.ndarray
    bmax: np.ndarray
    axis: np.ndarray
    phi: float
    cos_o: float
    cos_e: float
    two_sided: bool
    global_idx: int


def _cone_union(a_axis, a_cos, b_axis, b_cos):
    """Union of two direction cones (DirectionCone::Union,
    util/vecmath.h), conservative: (axis, cos_spread)."""
    ta = math.acos(max(-1.0, min(1.0, a_cos)))
    tb = math.acos(max(-1.0, min(1.0, b_cos)))
    d = float(np.dot(a_axis, b_axis))
    td = math.acos(max(-1.0, min(1.0, d)))
    if min(td + tb, math.pi) <= ta:
        return a_axis, a_cos
    if min(td + ta, math.pi) <= tb:
        return b_axis, b_cos
    to = (ta + td + tb) / 2
    if to >= math.pi:
        return a_axis, -1.0
    # rotate a_axis toward b_axis by (to - ta)
    rot = to - ta
    axis = np.cross(a_axis, b_axis)
    n = np.linalg.norm(axis)
    if n < 1e-9:
        return a_axis, -1.0
    axis = axis / n
    c, s = math.cos(rot), math.sin(rot)
    w = (a_axis * c + np.cross(axis, a_axis) * s
         + axis * np.dot(axis, a_axis) * (1 - c))
    return w / max(np.linalg.norm(w), 1e-12), math.cos(to)


def _np(x):
    return x.detach().cpu().numpy()


def _build_lights(lights):
    """The finite lights of `lights` as _BuildLight records, in the global
    index order."""
    bl = []
    pp, pI = _np(lights.point_p), _np(lights.point_I)
    for i in range(lights.n_point):
        # PointLight::Bounds: isotropic, theta_o = pi, theta_e = pi/2
        bl.append(_BuildLight(pp[i], pp[i], np.array([0.0, 0.0, 1.0]),
                              4 * np.pi * float(pI[i].mean()), -1.0, 0.0,
                              False, i))
    sp, sI, sd = _np(lights.spot_p), _np(lights.spot_I), _np(lights.spot_dir)
    sct, scs = _np(lights.spot_cos_total), _np(lights.spot_cos_start)
    for i in range(lights.n_spot):
        phi = (2 * np.pi * float(sI[i].mean())
               * ((1 - scs[i]) + (scs[i] - sct[i]) / 2))
        bl.append(_BuildLight(sp[i], sp[i], sd[i], max(phi, 1e-9),
                              float(sct[i]), 0.0, False, lights.n_point + i))
    # goniometric and projection lights: conservative isotropic cones
    for p_, I_, img, n_, base in (
            (lights.gonio_p, lights.gonio_I, lights.gonio_img,
             lights.n_gonio, lights.base_gonio),
            (lights.proj_p, lights.proj_I, lights.proj_img, lights.n_proj,
             lights.base_proj)):
        p_, I_ = _np(p_), _np(I_)
        mean = _np(img).mean(axis=(1, 2, 3)) if n_ else np.zeros(0)
        for i in range(n_):
            bl.append(_BuildLight(p_[i], p_[i], np.array([0.0, 0.0, 1.0]),
                                  max(4 * np.pi * float(I_[i].mean())
                                      * float(mean[i]), 1e-9),
                                  -1.0, 0.0, False, base + i))
    p0, p1, p2 = _np(lights.area_p0), _np(lights.area_p1), _np(lights.area_p2)
    aL, two = _np(lights.area_L), _np(lights.area_twosided)
    for i in range(p0.shape[0]):
        nrm = np.cross(p1[i] - p0[i], p2[i] - p0[i])
        area = 0.5 * np.linalg.norm(nrm)
        axis = nrm / max(np.linalg.norm(nrm), 1e-12)
        phi = float(aL[i].mean()) * area * np.pi * (2.0 if two[i] else 1.0)
        bmin = np.minimum(np.minimum(p0[i], p1[i]), p2[i])
        bmax = np.maximum(np.maximum(p0[i], p1[i]), p2[i])
        bl.append(_BuildLight(bmin, bmax, axis, max(phi, 1e-9), 1.0, 0.0,
                              bool(two[i]), lights.base_area + i))
    return bl


def build_light_bvh(lights) -> LightBVH | None:
    """The BVH over the finite lights of `lights`, built on the host in
    numpy and placed on the lights' device; None when there is no finite
    light."""
    bl = _build_lights(lights)
    L = len(bl)
    if L == 0:
        return None
    N = 2 * L - 1
    bmin = np.zeros((N, 3), np.float32)
    bmax = np.zeros((N, 3), np.float32)
    axis = np.zeros((N, 3), np.float32)
    phi = np.zeros(N, np.float32)
    cos_o = np.zeros(N, np.float32)
    cos_e = np.zeros(N, np.float32)
    two_s = np.zeros(N, bool)
    child1 = np.full(N, -1, np.int32)
    leaf_light = np.full(N, -1, np.int32)
    n_global = int(lights.n_lights)
    trail_node = np.full(n_global, -1, np.int32)
    trail_by_node = {}
    cursor = [0]
    max_depth = [0]

    def emit(items, bits, depth):
        me = cursor[0]
        cursor[0] += 1
        max_depth[0] = max(max_depth[0], depth)
        if len(items) == 1:
            it = items[0]
            bmin[me], bmax[me] = it.bmin, it.bmax
            axis[me], phi[me] = it.axis, it.phi
            cos_o[me], cos_e[me] = it.cos_o, it.cos_e
            two_s[me] = it.two_sided
            leaf_light[me] = it.global_idx
            trail_node[it.global_idx] = me
            trail_by_node[me] = bits
            return me
        cents = np.stack([(i.bmin + i.bmax) * 0.5 for i in items])
        dim = int(np.argmax(cents.max(0) - cents.min(0)))
        order = np.argsort(cents[:, dim], kind="stable")
        items = [items[k] for k in order]
        half = len(items) // 2
        emit(items[:half], bits, depth + 1)  # left child = me + 1
        child1[me] = emit(items[half:], bits | (1 << depth), depth + 1)
        bmin[me] = np.minimum.reduce([i.bmin for i in items]).astype(
            np.float32)
        bmax[me] = np.maximum.reduce([i.bmax for i in items]).astype(
            np.float32)
        phi[me] = sum(i.phi for i in items)
        ax, co = items[0].axis, items[0].cos_o
        for it in items[1:]:
            ax, co = _cone_union(ax, co, it.axis, it.cos_o)
        axis[me], cos_o[me] = ax, co
        cos_e[me] = min(i.cos_e for i in items)
        two_s[me] = any(i.two_sided for i in items)
        return me

    emit(bl, 0, 0)
    # the trail of each GLOBAL light, read LSB first during the descent
    trail = np.zeros(n_global, np.int64)
    for node, bits in trail_by_node.items():
        trail[leaf_light[node]] = bits
    def t(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=lights.point_p.device)

    return LightBVH(t(bmin), t(bmax), t(axis), t(phi), t(cos_o), t(cos_e),
                    t(two_s), t(child1, torch.int64),
                    t(leaf_light, torch.int64), t(trail),
                    t(trail_node, torch.int64), max(max_depth[0], 1))


def _importance(bvh: LightBVH, node, p):
    """Conservative importance of `node` seen from points p: (R,)
    (CompactLightBounds::Importance, lightsamplers.h:140-201, without the
    shading-normal factor)."""
    bmin = bvh.bmin[node]
    bmax = bvh.bmax[node]
    pc = 0.5 * (bmin + bmax)
    diag = bmax - bmin
    r2 = 0.25 * torch.sum(diag * diag, -1)
    d2 = torch.sum((p - pc) ** 2, -1)
    d2c = torch.maximum(d2, r2)
    wi = (p - pc) / torch.sqrt(torch.clamp(d2, min=1e-20))[..., None]
    cos_w = torch.sum(bvh.axis[node] * wi, -1)
    cos_w = torch.where(bvh.two_sided[node], torch.abs(cos_w), cos_w)
    th_w = torch.arccos(torch.clamp(cos_w, -1.0, 1.0))
    th_o = torch.arccos(torch.clamp(bvh.cos_o[node], -1.0, 1.0))
    th_e = torch.arccos(torch.clamp(bvh.cos_e[node], -1.0, 1.0))
    sin_u = torch.sqrt(torch.clamp(r2 / torch.clamp(d2, min=1e-20), 0.0,
                                   1.0))
    th_u = torch.arcsin(sin_u)
    th_p = torch.clamp(th_w - th_o - th_u, min=0.0)
    imp = bvh.phi[node] * torch.cos(th_p) / torch.clamp(d2c, min=1e-20)
    return torch.where(th_p < th_e, torch.clamp(imp, min=0.0), 0.0)


def _children(bvh, node, p):
    """(is_leaf, left, right, importance left, importance right)."""
    is_leaf = bvh.leaf_light[node] >= 0
    c0 = node + 1
    c1 = bvh.child1[node]
    i0 = _importance(bvh, torch.where(is_leaf, node, c0), p)
    i1 = _importance(bvh, torch.where(is_leaf, node, c1), p)
    return is_leaf, c0, c1, i0, i1


def bvh_select(bvh: LightBVH, p, u):
    """Descend the light BVH from points p with uniforms u.

    Returns (global light index (R,) int64, pmf (R,), u remaining (R,));
    lanes that meet a subtree of zero importance get pmf 0 and index -1."""
    R = tuple(p.shape[:-1])
    node = torch.zeros(R, dtype=torch.int64, device=p.device)
    pmf = torch.ones(R, device=p.device)
    dead = torch.zeros(R, dtype=torch.bool, device=p.device)
    for _ in range(bvh.max_depth + 1):
        is_leaf, c0, c1, i0, i1 = _children(bvh, node, p)
        tot = i0 + i1
        live = ~is_leaf & ~dead
        dead = dead | (live & (tot <= 0))
        p0 = torch.where(tot > 0, i0 / torch.clamp(tot, min=1e-30), 0.5)
        go0 = u < p0
        u_new = torch.where(go0, u / torch.clamp(p0, min=1e-12),
                            (u - p0) / torch.clamp(1 - p0, min=1e-12))
        u_new = torch.clamp(u_new, 0.0, 0.9999999)
        upd = live & ~dead
        u = torch.where(upd, u_new, u)
        pmf = torch.where(upd, pmf * torch.where(go0, p0, 1 - p0), pmf)
        node = torch.where(upd, torch.where(go0, c0, c1), node)
    light = torch.where(dead, -1, bvh.leaf_light[node])
    return light, torch.where(dead, 0.0, pmf), u


def bvh_pmf(bvh: LightBVH, p, global_light):
    """PMF of ``bvh_select(p)`` returning `global_light`, replaying its bit
    trail (lightsamplers.h:341-366)."""
    R = tuple(p.shape[:-1])
    gl = torch.clamp(global_light.long(), 0, bvh.trail_node.shape[0] - 1)
    trail = bvh.trail[gl]
    node = torch.zeros(R, dtype=torch.int64, device=p.device)
    pmf = torch.ones(R, device=p.device)
    bad = bvh.trail_node[gl] < 0
    for d in range(bvh.max_depth + 1):
        is_leaf, c0, c1, i0, i1 = _children(bvh, node, p)
        tot = i0 + i1
        bit = (trail >> d) & 1
        pr = torch.where(bit == 0, i0, i1) / torch.clamp(tot, min=1e-30)
        upd = ~is_leaf
        pmf = torch.where(upd, pmf * torch.where(tot > 0, pr, 0.0), pmf)
        node = torch.where(upd, torch.where(bit == 0, c0, c1), node)
    return torch.where(bad | (global_light < 0), 0.0, pmf)
