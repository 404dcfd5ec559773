"""Loop subdivision surfaces (analog of ``util/loopsubdiv.cpp``).

This package's own copy of ``vspg_pbrt_v4_tpu/utils/loopsubdiv.py``
(numpy only), so that the port builds the bench's subdivided machines
without importing the JAX package. The reference converts
``Shape "loopsubdiv"`` meshes into triangles at scene-build time
(LoopSubdivide, loopsubdiv.cpp:160); here that is vectorized numpy.

Supports closed and open (boundary) manifold triangle meshes:
- interior even vertices: Loop beta weights (beta = 1/16 valence 3,
  3/(8n) otherwise — the reference's LoopSubdivide beta choice)
- boundary even vertices: 1/8, 3/4, 1/8 crease rule
- interior odd vertices: 3/8 endpoints + 1/8 opposite corners
- boundary odd vertices: edge midpoint
After `levels` rounds, vertices are pushed to the limit surface with the
reference's limit-rule weights (loopsubdiv.cpp:375-395).
"""

from __future__ import annotations

import numpy as np


def _beta(n):
    return np.where(n == 3, 3.0 / 16.0, 3.0 / (8.0 * n))


def _limit_gamma(n):
    # loopsubdiv.cpp gamma: 1/(n + 3/(8 beta))
    return 1.0 / (n + 3.0 / (8.0 * _beta(n)))


def subdivide(P, indices, levels=3, compute_limit=True):
    """P: (V,3) float; indices: (F,3) int. Returns (P', indices', N')
    with per-vertex limit normals (approximated by area-weighted face
    normals after the final level)."""
    P = np.asarray(P, np.float64)
    F = np.asarray(indices, np.int64).reshape(-1, 3)
    for _ in range(int(levels)):
        P, F = _subdivide_once(P, F)
    if compute_limit and len(P):
        P = _push_to_limit(P, F)
    N = _vertex_normals(P, F)
    return P.astype(np.float32), F.astype(np.int32), N.astype(np.float32)


def _edges_of(F):
    """Unique undirected edges + per-face edge ids.

    Returns (edges (E,2) sorted pairs, face_edge (F,3) ids where slot k is
    the edge opposite... here: edge k = (v_k, v_{k+1}))."""
    e = np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]], 0)
    e_sorted = np.sort(e, axis=1)
    edges, inv = np.unique(e_sorted, axis=0, return_inverse=True)
    face_edge = inv.reshape(3, -1).T if False else inv.reshape(-1).reshape(3, len(F)).T
    # np.concatenate stacked groups: first F rows are edge(0,1), etc.
    face_edge = np.stack([inv[:len(F)], inv[len(F):2 * len(F)],
                          inv[2 * len(F):]], axis=1)
    return edges, face_edge


def _subdivide_once(P, F):
    V = len(P)
    edges, face_edge = _edges_of(F)
    E = len(edges)
    # edge -> adjacent faces and opposite vertices
    counts = np.zeros(E, np.int64)
    opp = np.full((E, 2), -1, np.int64)
    for k in range(3):
        eid = face_edge[:, k]
        ov = F[:, (k + 2) % 3]  # vertex opposite edge (v_k, v_{k+1})
        slot = counts[eid]
        # two passes to scatter without collisions
        for s in (0, 1):
            m = slot == s
            opp[eid[m], s] = ov[m]
        counts[eid] += 1
    boundary_edge = counts == 1

    # odd (new edge) vertices
    mid = 0.5 * (P[edges[:, 0]] + P[edges[:, 1]])
    interior = ~boundary_edge
    o0 = np.where(opp[:, 0] >= 0, opp[:, 0], 0)
    o1 = np.where(opp[:, 1] >= 0, opp[:, 1], 0)
    interior_pos = (3.0 / 8.0) * (P[edges[:, 0]] + P[edges[:, 1]]) \
        + (1.0 / 8.0) * (P[o0] + P[o1])
    new_edge_P = np.where(interior[:, None], interior_pos, mid)

    # even (old) vertices
    # vertex valence + neighbor sums from edges
    valence = np.zeros(V, np.int64)
    nbr_sum = np.zeros((V, 3), np.float64)
    np.add.at(valence, edges[:, 0], 1)
    np.add.at(valence, edges[:, 1], 1)
    np.add.at(nbr_sum, edges[:, 0], P[edges[:, 1]])
    np.add.at(nbr_sum, edges[:, 1], P[edges[:, 0]])
    # boundary vertices: only boundary-edge neighbors count
    on_boundary = np.zeros(V, bool)
    b_sum = np.zeros((V, 3), np.float64)
    b_cnt = np.zeros(V, np.int64)
    be = edges[boundary_edge]
    if len(be):
        on_boundary[be[:, 0]] = True
        on_boundary[be[:, 1]] = True
        np.add.at(b_sum, be[:, 0], P[be[:, 1]])
        np.add.at(b_sum, be[:, 1], P[be[:, 0]])
        np.add.at(b_cnt, be[:, 0], 1)
        np.add.at(b_cnt, be[:, 1], 1)
    n = np.maximum(valence, 1)
    beta = _beta(n)
    even_interior = (1.0 - n * beta)[:, None] * P + beta[:, None] * nbr_sum
    even_boundary = 0.75 * P + 0.125 * b_sum  # 1/8,3/4,1/8 crease rule
    new_even_P = np.where(on_boundary[:, None], even_boundary, even_interior)

    newP = np.concatenate([new_even_P, new_edge_P], 0)
    e0 = V + face_edge[:, 0]  # midpoint of (v0,v1)
    e1 = V + face_edge[:, 1]  # (v1,v2)
    e2 = V + face_edge[:, 2]  # (v2,v0)
    v0, v1, v2 = F[:, 0], F[:, 1], F[:, 2]
    newF = np.concatenate([
        np.stack([v0, e0, e2], 1),
        np.stack([v1, e1, e0], 1),
        np.stack([v2, e2, e1], 1),
        np.stack([e0, e1, e2], 1),
    ], 0)
    return newP, newF


def _push_to_limit(P, F):
    """Limit-surface projection (loopsubdiv.cpp:375: weights gamma for
    interior, 1/5-3/5-1/5 for boundaries)."""
    V = len(P)
    edges, _ = _edges_of(F)
    counts = np.zeros(len(edges), np.int64)
    e_all = np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]], 0)
    es = np.sort(e_all, 1)
    _, inv = np.unique(es, axis=0, return_inverse=True)
    np.add.at(counts, inv, 1)
    boundary_edge = counts == 1
    valence = np.zeros(V, np.int64)
    nbr = np.zeros((V, 3), np.float64)
    np.add.at(valence, edges[:, 0], 1)
    np.add.at(valence, edges[:, 1], 1)
    np.add.at(nbr, edges[:, 0], P[edges[:, 1]])
    np.add.at(nbr, edges[:, 1], P[edges[:, 0]])
    on_boundary = np.zeros(V, bool)
    b_sum = np.zeros((V, 3), np.float64)
    be = edges[boundary_edge]
    if len(be):
        on_boundary[be[:, 0]] = True
        on_boundary[be[:, 1]] = True
        np.add.at(b_sum, be[:, 0], P[be[:, 1]])
        np.add.at(b_sum, be[:, 1], P[be[:, 0]])
    n = np.maximum(valence, 1)
    gamma = _limit_gamma(n)
    lim_interior = (1.0 - n * gamma)[:, None] * P + gamma[:, None] * nbr
    lim_boundary = 0.6 * P + 0.2 * b_sum  # 1/5, 3/5, 1/5
    return np.where(on_boundary[:, None], lim_boundary, lim_interior)


def _vertex_normals(P, F):
    N = np.zeros_like(P)
    fn = np.cross(P[F[:, 1]] - P[F[:, 0]], P[F[:, 2]] - P[F[:, 0]])
    for k in range(3):
        np.add.at(N, F[:, k], fn)
    ln = np.linalg.norm(N, axis=-1, keepdims=True)
    return N / np.maximum(ln, 1e-20)
