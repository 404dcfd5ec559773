// BVH traversal of the mesh class (B2c), one thread per ray.
//
// The tree is the scene's binned-SAH BVH (ops/bvh.py; the JAX package
// builds the same one), flattened into a node table of NODE_COLS floats a
// row (ops/volpath_kernels.py pack_node_table) beside the triangle table,
// whose rows are ordered by the tree's primitive ids so that a leaf's
// triangles are contiguous. Both tables live in global memory (3072
// triangles are 295 KB and 16384 are 1.6 MB: more than one SM's shared
// memory, far less than the 50 MB L2) and are read through the read-only
// cache as float4s. Each thread walks the tree with its own stack of
// BVH_STACK entries in local memory, in the order of ops/bvh.py
// bvh_traverse: the slab test with its 1.0000007 widening, then at an
// interior node push the second child and descend to the first, at a leaf
// test its triangles, else pop. The closest-hit query keeps the nearest
// hit; the shadow query stops at the first.
#pragma once

#include "common.cuh"

namespace vp {

// node table (ops/volpath_kernels.py N_*)
enum NodeCol {
  N_BMIN = 0,   // box (3)
  N_BMAX = 3,   // (3)
  N_INDEX = 6,  // interior: second child; leaf: first triangle row
  N_COUNT = 7,  // triangles of a leaf, 0 for an interior node
  NODE_COLS = 8
};
constexpr int BVH_STACK = 48;  // ops/bvh.py MAX_STACK
constexpr int MAX_TRIS_MESH = 16384;

// NaN-propagating min/max (torch.minimum/maximum); fminf/fmaxf then skip
// NaNs as the NaN-ignoring reductions of bvh_traverse do
static __device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}
static __device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}

// Nearest triangle along (o, d) nearer than t_max through the BVH
// (ANY=false), or the first one met (ANY=true, shadow rays). Returns its
// row in the triangle table, -1 on a miss.
template <bool ANY>
static __device__ TriHit bvh_hit(const float* __restrict__ nodes,
                                 const float* __restrict__ tris, V3 o, V3 d,
                                 float t_max) {
  TriHit h = {-1, t_max, 0.f, 0.f};
  if (!(t_max > 0.0f)) return h;
  const V3 inv = v3(1.0f / d.x, 1.0f / d.y, 1.0f / d.z);
  const float4* nd = reinterpret_cast<const float4*>(nodes);
  int stack[BVH_STACK];
  int sp = 0, node = 0;
  while (true) {
    const float4 a = __ldg(nd + 2 * node);      // bmin, bmax.x
    const float4 b = __ldg(nd + 2 * node + 1);  // bmax.yz, index, count
    float lx = (a.x - o.x) * inv.x, hx = (a.w - o.x) * inv.x;
    float ly = (a.y - o.y) * inv.y, hy = (b.x - o.y) * inv.y;
    float lz = (a.z - o.z) * inv.z, hz = (b.y - o.z) * inv.z;
    float t_near =
        fmaxf(fmaxf(nan_min(lx, hx), nan_min(ly, hy)), nan_min(lz, hz));
    float t_far =
        fminf(fminf(nan_max(lx, hx), nan_max(ly, hy)), nan_max(lz, hz)) *
        1.0000007f;
    bool met = t_near <= t_far && t_far > 0.0f && t_near < h.t;
    const int idx = (int)b.z, cnt = (int)b.w;
    if (met && cnt > 0) {
      for (int j = idx; j < idx + cnt; ++j) {
        const float4* r = reinterpret_cast<const float4*>(tris + j * TRI_COLS);
        const float4 r0 = __ldg(r), r1 = __ldg(r + 1), r2 = __ldg(r + 2);
        float tt, b1, b2;
        if (tri_test(v3(r0.x, r0.y, r0.z), v3(r0.w, r1.x, r1.y),
                     v3(r1.z, r1.w, r2.x), o, d, h.t, &tt, &b1, &b2)) {
          h.k = j;
          h.t = tt;
          h.b1 = b1;
          h.b2 = b2;
          if (ANY) return h;
        }
      }
    } else if (met && sp < BVH_STACK) {
      stack[sp++] = idx;
      ++node;
      continue;
    }
    if (sp == 0) break;
    node = stack[--sp];
  }
  return h;
}

}  // namespace vp
