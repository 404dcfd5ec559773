// Shared device code of the volpath kernels: the constant-table layout,
// the pcg4d counter RNG, the Henyey-Greenstein phase function, the box
// slab test and the pinhole camera ray. Each helper follows the formula
// and operation order of its counterpart in ops/volpath_kernels.py (and
// through it, of ops/pallas_volpath.py in the JAX package), so kernel and
// plain version draw the same numbers and take the same branches.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vp {

// float32 constant table (ops/volpath_kernels.py F_*)
enum FConst {
  F_RC = 0,        // raster -> camera, 4x4 row-major
  F_CW = 16,       // camera -> world, 4x4 row-major
  F_SA = 32,       // sigma_a (3)
  F_SS = 35,       // sigma_s (3)
  F_ST = 38,       // sigma_a + sigma_s (3)
  F_BMIN = 41,     // medium box (3)
  F_BMAX = 44,     // (3)
  F_LP = 47,       // point light position (3)
  F_LI = 50,       // point light intensity (3)
  F_ENV = 53,      // constant environment radiance (3)
  F_PMF = 56,      // light-selection pmf
  F_PENV = 57,     // pmf / (4 pi)
  F_HG_C1 = 58,    // 1 + g^2
  F_HG_C2 = 59,    // 2 g
  F_HG_C3 = 60,    // (1 - g^2) / (4 pi)
  F_HG_1MG2 = 61,  // 1 - g^2
  F_HG_1PG = 62,   // 1 + g
  F_TWO_PI = 63,   // 2 pi
  N_FCONST = 64
};

// int32 constant table (ops/volpath_kernels.py I_*)
enum IConst {
  I_NX = 0,
  I_NY = 1,
  I_HAS_POINT = 2,
  I_HAS_ENV = 3,
  I_MAX_DEPTH = 4,
  I_MAX_EVENTS = 5,
  I_MAX_COLL = 6,
  I_RR_START = 7,
  I_HG_ISO = 8,
  I_GX = 9,
  I_GY = 10,
  I_GZ = 11,
  I_MX = 12,
  I_MY = 13,
  I_MZ = 14,
  N_ICONST = 15
};

constexpr float BIG = 3e37f;

// triangle table, one row of TRI_COLS floats per triangle
// (ops/volpath_kernels.py T_*; pallas_volpath.pack_tri_table's layout)
enum TriCol {
  T_P0 = 0,       // first corner (3)
  T_E1 = 3,       // p1 - p0 (3)
  T_E2 = 6,       // p2 - p0 (3)
  T_NG = 9,       // unit normal (3)
  T_MAT = 12,     // material id
  T_MED_IN = 13,  // medium behind the normal
  T_MED_OUT = 14, // medium on the normal side
  T_UV0 = 16,     // corner uvs (2 each)
  T_UV1 = 18,
  T_UV2 = 20,
  TRI_COLS = 24
};
constexpr int MAX_TRIS = 64;

struct V3 {
  float x, y, z;
};

static __device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r = {x, y, z};
  return r;
}
static __device__ __forceinline__ V3 v3(const float* p) {
  return v3(p[0], p[1], p[2]);
}
static __device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
static __device__ __forceinline__ float avg3(V3 v) {
  return (v.x + v.y + v.z) * (1.0f / 3.0f);
}
static __device__ __forceinline__ float max3(V3 v) {
  return fmaxf(fmaxf(v.x, v.y), v.z);
}
static __device__ __forceinline__ float sel(V3 v, int h) {
  return h == 0 ? v.x : (h == 1 ? v.y : v.z);
}
static __device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return v3(a.x * b.x, a.y * b.y, a.z * b.z);
}
static __device__ __forceinline__ V3 scale(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
static __device__ __forceinline__ V3 add(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
static __device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
// the point o + t d
static __device__ __forceinline__ V3 along(V3 o, float t, V3 d) {
  return v3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);
}
static __device__ __forceinline__ V3 normalize(V3 v) {
  float inv = rsqrtf(fmaxf(dot(v, v), 1e-30f));
  return scale(v, inv);
}
// exp(-coef_k * t) per channel
static __device__ __forceinline__ V3 exp_neg(V3 coef, float t) {
  return v3(expf(-coef.x * t), expf(-coef.y * t), expf(-coef.z * t));
}

// ---- pcg4d counter RNG (utils/rng.py) ---------------------------------------

static __device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b,
                                             uint32_t& c, uint32_t& d) {
  a = a * 1664525u + 1013904223u;
  b = b * 1664525u + 1013904223u;
  c = c * 1664525u + 1013904223u;
  d = d * 1664525u + 1013904223u;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  a ^= a >> 16;
  b ^= b >> 16;
  c ^= c >> 16;
  d ^= d >> 16;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
}

static __device__ __forceinline__ float to_unit(uint32_t u) {
  return (float)(u >> 8) * (1.0f / 16777216.0f);
}

// four U[0,1) floats keyed by (seed, pixel, sample, dimension)
static __device__ __forceinline__ float4 uniform4(uint32_t seed, uint32_t pix,
                                                  uint32_t samp,
                                                  uint32_t dim) {
  uint32_t a = pix, b = samp, c = dim, d = seed;
  pcg4d(a, b, c, d);
  return make_float4(to_unit(a), to_unit(b), to_unit(c), to_unit(d));
}

// ---- Henyey-Greenstein --------------------------------------------------------

static __device__ __forceinline__ float hg_value(const float* fc,
                                                 float cos_t) {
  float denom = fmaxf(fc[F_HG_C1] + fc[F_HG_C2] * cos_t, 1e-12f);
  return fc[F_HG_C3] / (denom * sqrtf(denom));
}

// direction around -wo (pbrt convention: cos measured in the +wo frame)
static __device__ __forceinline__ V3 sample_hg(const float* fc, bool iso,
                                               V3 wo, float u0, float u1,
                                               float* pdf) {
  float cos_t;
  if (iso) {
    cos_t = 1.0f - 2.0f * u0;
  } else {
    float sq = fc[F_HG_1MG2] / (fc[F_HG_1PG] - fc[F_HG_C2] * u0);
    cos_t = -(fc[F_HG_C1] - sq * sq) / fc[F_HG_C2];
  }
  float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  float phi = fc[F_TWO_PI] * u1;
  float lx = sin_t * cosf(phi);
  float ly = sin_t * sinf(phi);
  float sign = wo.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + wo.z);
  float b = wo.x * wo.y * a;
  V3 t1 = v3(1.0f + sign * wo.x * wo.x * a, sign * b, -sign * wo.x);
  V3 t2 = v3(b, sign + wo.y * wo.y * a, -wo.y);
  *pdf = hg_value(fc, cos_t);
  return v3(lx * t1.x + ly * t2.x + cos_t * wo.x,
            lx * t1.y + ly * t2.y + cos_t * wo.y,
            lx * t1.z + ly * t2.z + cos_t * wo.z);
}

// ---- geometry -----------------------------------------------------------------

// Slab test against the medium box. Returns whether the ray meets a face
// ahead; *t_hit is that face (BIG on a miss) and *entering says the near
// face is ahead (origin outside the box).
static __device__ __forceinline__ bool box_hit(const float* fc, V3 o, V3 d,
                                               float* t_hit, bool* entering) {
  float t_n = -BIG, t_f = BIG;
  const float oc[3] = {o.x, o.y, o.z};
  const float dc[3] = {d.x, d.y, d.z};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float dk = dc[k];
    float den = fabsf(dk) < 1e-12f ? (dk >= 0.0f ? 1e-12f : -1e-12f) : dk;
    float inv = 1.0f / den;
    float t0 = (fc[F_BMIN + k] - oc[k]) * inv;
    float t1 = (fc[F_BMAX + k] - oc[k]) * inv;
    t_n = fmaxf(t_n, fminf(t0, t1));
    t_f = fminf(t_f, fmaxf(t0, t1));
  }
  bool ok = (t_n <= t_f) && (t_f > 1e-4f);
  *entering = t_n > 1e-4f;
  *t_hit = ok ? (*entering ? t_n : t_f) : BIG;
  return ok;
}

// The exit of a ray whose origin lies in the box: the far face, clamped at
// 0, with box_hit's arithmetic (so it is box_hit's t_hit wherever that
// reports one). A walk in the medium ends there, as the XLA path clips
// every walk to the grid's bounds with no epsilon (models/media.py
// seg_init's t1). box_hit reports no face nearer than 1e-4, so a walk that
// started that close to the exit took BIG as its limit and stepped on
// through the clamped majorant cells beyond the box.
static __device__ __forceinline__ float box_exit(const float* fc, V3 o,
                                                 V3 d) {
  float t_f = BIG;
  const float oc[3] = {o.x, o.y, o.z};
  const float dc[3] = {d.x, d.y, d.z};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float dk = dc[k];
    float den = fabsf(dk) < 1e-12f ? (dk >= 0.0f ? 1e-12f : -1e-12f) : dk;
    float inv = 1.0f / den;
    float t0 = (fc[F_BMIN + k] - oc[k]) * inv;
    float t1 = (fc[F_BMAX + k] - oc[k]) * inv;
    t_f = fminf(t_f, fmaxf(t0, t1));
  }
  return fmaxf(t_f, 0.0f);
}

static __device__ __forceinline__ bool outside_box(const float* fc, V3 o) {
  return o.x < fc[F_BMIN] || o.x > fc[F_BMAX] || o.y < fc[F_BMIN + 1] ||
         o.y > fc[F_BMAX + 1] || o.z < fc[F_BMIN + 2] ||
         o.z > fc[F_BMAX + 2];
}

// Moller-Trumbore test of the ray (o, d) against the triangle with corner
// p0 and edges e1 = p1 - p0, e2 = p2 - p0: true when it meets it at tt >
// 1e-4 nearer than t_best (pallas_vspg closest_hit's formula), with the
// barycentrics (b1, b2) of p1 and p2.
static __device__ __forceinline__ bool tri_test(V3 p0, V3 e1, V3 e2, V3 o,
                                                V3 d, float t_best, float* tt,
                                                float* b1, float* b2) {
  float pvx = d.y * e2.z - d.z * e2.y;
  float pvy = d.z * e2.x - d.x * e2.z;
  float pvz = d.x * e2.y - d.y * e2.x;
  float det = e1.x * pvx + e1.y * pvy + e1.z * pvz;
  bool big = fabsf(det) > 1e-12f;
  float inv_det = big ? 1.0f / det : 0.0f;
  float tvx = o.x - p0.x, tvy = o.y - p0.y, tvz = o.z - p0.z;
  *b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  float qvx = tvy * e1.z - tvz * e1.y;
  float qvy = tvz * e1.x - tvx * e1.z;
  float qvz = tvx * e1.y - tvy * e1.x;
  *b2 = (d.x * qvx + d.y * qvy + d.z * qvz) * inv_det;
  *tt = (e2.x * qvx + e2.y * qvy + e2.z * qvz) * inv_det;
  return big && *b1 >= 0.0f && *b2 >= 0.0f && *b1 + *b2 <= 1.0f &&
         *tt > 1e-4f && *tt < t_best;
}

// Closest triangle of the shared-memory table along (o, d) nearer than
// t_max: a Moller-Trumbore sweep in table order, keeping the first of equal
// distances (pallas_vspg closest_hit). Returns the index, -1 on a miss.
struct TriHit {
  int k;
  float t, b1, b2;
};
static __device__ __forceinline__ TriHit closest_tri(const float* tris,
                                                     int n_tri, V3 o, V3 d,
                                                     float t_max) {
  TriHit h = {-1, t_max, 0.f, 0.f};
  for (int i = 0; i < n_tri; ++i) {
    const float* r = tris + i * TRI_COLS;
    float tt, b1, b2;
    if (tri_test(v3(r + T_P0), v3(r + T_E1), v3(r + T_E2), o, d, h.t, &tt,
                 &b1, &b2)) {
      h.k = i;
      h.t = tt;
      h.b1 = b1;
      h.b2 = b2;
    }
  }
  return h;
}

// continuous raster coordinates -> normalized world direction
static __device__ __forceinline__ V3 camera_ray(const float* fc, float px,
                                                float py) {
  const float* rc = fc + F_RC;
  const float* cw = fc + F_CW;
  float xc = rc[0] * px + rc[1] * py + rc[3];
  float yc = rc[4] * px + rc[5] * py + rc[7];
  float zc = rc[8] * px + rc[9] * py + rc[11];
  float wc = rc[12] * px + rc[13] * py + rc[15];
  float inv_w = fabsf(wc - 1.0f) < 1e-9f ? 1.0f : 1.0f / wc;
  V3 dc = normalize(v3(xc * inv_w, yc * inv_w, zc * inv_w));
  return normalize(v3(cw[0] * dc.x + cw[1] * dc.y + cw[2] * dc.z,
                      cw[4] * dc.x + cw[5] * dc.y + cw[6] * dc.z,
                      cw[8] * dc.x + cw[9] * dc.y + cw[10] * dc.z));
}

// Fresh camera path of sample `samp`: dimension 0 jitters the pixel (u0,
// u1) and picks the hero channel (u2).
static __device__ __forceinline__ void start_path(const float* fc, int nx,
                                                  uint32_t seed, uint32_t pix,
                                                  uint32_t samp, V3* o, V3* d,
                                                  int* hero) {
  float4 u = uniform4(seed, pix, samp, 0u);
  float px = (float)(pix % (uint32_t)nx) + 0.5f + (u.x - 0.5f);
  float py = (float)(pix / (uint32_t)nx) + 0.5f + (u.y - 0.5f);
  *d = camera_ray(fc, px, py);
  *o = v3(fc[F_CW + 3], fc[F_CW + 7], fc[F_CW + 11]);
  *hero = min((int)floorf(u.z * 3.0f), 2);
}

// load the constant tables into shared memory (call from every thread)
static __device__ __forceinline__ void load_consts(const float* fc_g,
                                                   const int* ic_g, float* fc,
                                                   int* ic) {
  for (int i = threadIdx.x; i < N_FCONST; i += blockDim.x) fc[i] = fc_g[i];
  for (int i = threadIdx.x; i < N_ICONST; i += blockDim.x) ic[i] = ic_g[i];
}

// The next work item of a persistent lane: the lanes of a warp that ask
// together take consecutive items with one atomicAdd on the counter
// *next_item, zeroed by the caller (all 32 at a launch's start, so a
// warp's first items are neighbours).
static __device__ __forceinline__ long long take_items(
    unsigned long long* next_item) {
  const unsigned mask = __activemask();
  const int lane = threadIdx.x & 31, leader = __ffs(mask) - 1;
  unsigned long long base = 0;
  if (lane == leader)
    base = atomicAdd(next_item, (unsigned long long)__popc(mask));
  base = __shfl_sync(mask, base, leader);
  return (long long)(base + __popc(mask & ((1u << lane) - 1u)));
}

// A persistent kernel's grid on the current card: out4 = [resident blocks
// an SM of `threads` threads at `smem` dynamic shared bytes (from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; cached in `cache` with
// the registers and local bytes, which the build fixes), SMs, registers a
// thread, local memory bytes a thread].
static inline cudaError_t persistent_grid(const void* kernel, int threads,
                                          size_t smem, int cache[3],
                                          int* out4) {
  if (cache[0] == 0) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    int nb = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, threads,
                                                      smem);
    if (e != cudaSuccess) return e;
    if (nb < 1) return cudaErrorInvalidConfiguration;
    cache[1] = fa.numRegs;
    cache[2] = (int)fa.localSizeBytes;
    cache[0] = nb;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  out4[0] = cache[0];
  out4[1] = sms;
  out4[2] = cache[1];
  out4[3] = cache[2];
  return cudaSuccess;
}

}  // namespace vp
