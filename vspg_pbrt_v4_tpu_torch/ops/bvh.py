"""BVH over triangles (counterpart of ``ops/bvh.py``): the host-side
binned-SAH build and the lockstep torch traversal.

The build is a copy of the JAX package's numpy build (the native builder of
``native.py`` produces the same layout faster); the traversal is its
``bvh_traverse``: every lane walks its own path with a fixed-depth stack,
pushing the second child and descending into the first, so that a lane
visits the same nodes in the same order as in the JAX package. The CUDA
grid kernel walks the same tree per thread (``csrc/bvh.cuh``). Brute force
(``models/shapes.Geometry``) stays the correctness oracle.

Flattened layout: bmin/bmax (N, 3); for an interior node ``right`` is the
second child and ``count`` 0 (the first child is node + 1); for a leaf
``start`` and ``count`` index the permuted primitive-id array ``prim_ids``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.math import nanmax, nanmin

MAX_STACK = 48
N_BINS = 16


class BVH(NamedTuple):
    bmin: torch.Tensor  # (N, 3) float32
    bmax: torch.Tensor  # (N, 3) float32
    right: torch.Tensor  # (N,) int32 second child (interior)
    start: torch.Tensor  # (N,) int32 first primitive (leaf)
    count: torch.Tensor  # (N,) int32 primitive count (0 = interior)
    prim_ids: torch.Tensor  # (P,) int32 permuted primitive indices

    @property
    def n_nodes(self):
        return self.bmin.shape[0]


def bvh_from_arrays(arrays, *, device):
    """A BVH of tensors on `device` from the six arrays of the layout
    (numpy, or anything ``np.asarray`` reads)."""
    bmin, bmax, right, start, count, prim_ids = (np.asarray(a) for a in arrays)
    f = [torch.as_tensor(np.array(a, np.float32), device=device)
         for a in (bmin, bmax)]
    i = [torch.as_tensor(np.array(a, np.int32), device=device)
         for a in (right, start, count, prim_ids)]
    return BVH(*f, *i)


def build_bvh_arrays(prim_bmin, prim_bmax, max_leaf=4):
    """Binned SAH build over primitive bounds (numpy, host-side): the six
    numpy arrays of the layout."""
    prim_bmin = np.asarray(prim_bmin, np.float32)
    prim_bmax = np.asarray(prim_bmax, np.float32)
    P = prim_bmin.shape[0]
    centroids = 0.5 * (prim_bmin + prim_bmax)
    prim_ids = np.arange(P, dtype=np.int32)

    bmins, bmaxs, rights, starts, counts = [], [], [], [], []
    order = []

    def new_node():
        bmins.append(np.zeros(3, np.float32))
        bmaxs.append(np.zeros(3, np.float32))
        rights.append(0)
        starts.append(0)
        counts.append(0)
        return len(bmins) - 1

    def build(ids):
        ni = new_node()
        bb0 = prim_bmin[ids].min(0)
        bb1 = prim_bmax[ids].max(0)
        bmins[ni], bmaxs[ni] = bb0, bb1
        if len(ids) <= max_leaf:
            starts[ni] = len(order)
            counts[ni] = len(ids)
            order.extend(ids.tolist())
            return ni
        # binned SAH over the largest centroid axis
        c = centroids[ids]
        c0, c1 = c.min(0), c.max(0)
        ext = c1 - c0
        axis = int(np.argmax(ext))
        if ext[axis] < 1e-12:
            starts[ni] = len(order)
            counts[ni] = len(ids)
            order.extend(ids.tolist())
            return ni
        bins = np.minimum(
            ((c[:, axis] - c0[axis]) / ext[axis] * N_BINS).astype(int),
            N_BINS - 1)
        bin_n = np.zeros(N_BINS, int)
        bin_lo = np.full((N_BINS, 3), np.inf, np.float32)
        bin_hi = np.full((N_BINS, 3), -np.inf, np.float32)
        for b in range(N_BINS):
            m = bins == b
            bin_n[b] = m.sum()
            if bin_n[b]:
                bin_lo[b] = prim_bmin[ids[m]].min(0)
                bin_hi[b] = prim_bmax[ids[m]].max(0)

        def area(lo, hi):
            dxyz = np.maximum(hi - lo, 0)
            return 2 * (dxyz[..., 0] * dxyz[..., 1]
                        + dxyz[..., 1] * dxyz[..., 2]
                        + dxyz[..., 2] * dxyz[..., 0])

        # prefix/suffix sweeps
        lo_l = np.minimum.accumulate(bin_lo, 0)
        hi_l = np.maximum.accumulate(bin_hi, 0)
        n_l = np.cumsum(bin_n)
        lo_r = np.minimum.accumulate(bin_lo[::-1], 0)[::-1]
        hi_r = np.maximum.accumulate(bin_hi[::-1], 0)[::-1]
        n_r = np.cumsum(bin_n[::-1])[::-1]
        cost = np.full(N_BINS - 1, np.inf)
        for s in range(N_BINS - 1):
            if n_l[s] and n_r[s + 1]:
                cost[s] = (n_l[s] * area(lo_l[s], hi_l[s])
                           + n_r[s + 1] * area(lo_r[s + 1], hi_r[s + 1]))
        s_best = int(np.argmin(cost))
        if not np.isfinite(cost[s_best]):
            half = len(ids) // 2
            ord_ax = np.argsort(c[:, axis])
            left_ids, right_ids = ids[ord_ax[:half]], ids[ord_ax[half:]]
        else:
            m = bins <= s_best
            left_ids, right_ids = ids[m], ids[~m]
        build(left_ids)
        rights[ni] = build(right_ids)
        return ni

    if P > 0:
        build(prim_ids)
    else:
        new_node()
    return (np.stack(bmins), np.stack(bmaxs), np.asarray(rights, np.int32),
            np.asarray(starts, np.int32), np.asarray(counts, np.int32),
            np.asarray(order if order else [0], np.int32))


def build_bvh(prim_bmin, prim_bmax, max_leaf=4, *, device):
    """Binned SAH build (numpy) into a BVH of tensors on `device`."""
    return bvh_from_arrays(build_bvh_arrays(prim_bmin, prim_bmax, max_leaf),
                           device=device)


def _count(counts, key, n):
    if counts is not None:
        counts[key] = counts.get(key, 0) + int(n)


def bvh_traverse(bvh: BVH, o, d, t_max, leaf_fn, payload0, max_leaf=4,
                 counts=None):
    """Closest-hit traversal: each lane walks the tree and calls
    ``leaf_fn(prim_id (R,), mask (R,), t_best, payload) -> (t_best,
    payload)`` for up to max_leaf primitives of each leaf whose box it
    meets nearer than t_best. Returns (t_best, payload).

    `counts` (a dict), when given, gathers the node visits (a live lane's
    step: one node fetched and slab-tested) and the leaf primitive tests
    (keys "node_visits", "leaf_tests")."""
    R = o.shape[0]
    dev = o.device
    inv_d = 1.0 / d
    lanes = torch.arange(R, device=dev)
    n_prim = bvh.prim_ids.shape[0]
    stack = torch.zeros((R, MAX_STACK), dtype=torch.int32, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    node = torch.zeros(R, dtype=torch.int64, device=dev)
    active = t_max > 0
    t_best, payload = t_max, payload0
    while bool(active.any()):
        _count(counts, "node_visits", active.sum())
        t_lo = (bvh.bmin[node] - o) * inv_d
        t_hi = (bvh.bmax[node] - o) * inv_d
        t_near = nanmax(torch.minimum(t_lo, t_hi))
        t_far = nanmin(torch.maximum(t_lo, t_hi)) * 1.0000007
        hit_box = (t_near <= t_far) & (t_far > 0) & (t_near < t_best) & active
        cnt = bvh.count[node]
        is_leaf = cnt > 0

        # leaf: test up to max_leaf primitives
        start = bvh.start[node].long()
        for j in range(max_leaf):
            pid = bvh.prim_ids[torch.clamp(start + j, 0, n_prim - 1)].long()
            m = hit_box & is_leaf & (j < cnt)
            _count(counts, "leaf_tests", m.sum())
            t_best, payload = leaf_fn(pid, m, t_best, payload)

        # interior and met: push the second child, descend to the first
        push = hit_box & ~is_leaf & (sp < MAX_STACK)
        top = torch.clamp(sp, max=MAX_STACK - 1)
        stack[lanes, top] = torch.where(push, bvh.right[node],
                                        stack[lanes, top])
        sp = torch.where(push, sp + 1, sp)
        node = torch.where(push, node + 1, node)

        # otherwise pop (leaf done or box missed); an empty stack ends
        need_pop = active & ~push
        can_pop = need_pop & (sp > 0)
        sp = torch.where(can_pop, sp - 1, sp)
        top = torch.clamp(sp, max=MAX_STACK - 1)
        node = torch.where(can_pop, stack[lanes, top].long(), node)
        active = active & ~(need_pop & ~can_pop)
    return t_best, payload
