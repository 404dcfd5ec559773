// B5: surface path tracing of the Cornell class, in vacuum, in (pixel,
// sample) work items on persistent blocks.
//
// Replaces pallas_surface._make_kernel (vspg_pbrt_v4_tpu/ops/
// pallas_surface.py), the TPU megakernel behind render_surface_pallas.
// Scene: at most 128 flat diffuse triangles, at most 8 diffuse triangle
// area lights, an optional point light and constant environment, uniform
// light selection. Per path iteration: a Moller-Trumbore sweep for the
// closest hit; escape into the environment or emission at an area light,
// each with MIS against NEE; NEE (light pick, uniform-area triangle
// sample, an any-hit shadow sweep); a cosine-sampled bounce; Russian
// roulette. The random stream is the Pallas kernel's: dimension 0 jitters
// the camera, then every iteration draws two uniform4 (NEE, then bounce
// and roulette) at dimensions that restart at 1 with each sample, so a
// pixel's samples match the plain versions ops/surface_kernels.
// render_surface_plain (per pixel) and render_surface_items_plain (per
// sample) and the Pallas kernel. The Pallas kernel caps a block's
// iterations at spp * (max_depth + 2); here each path runs at most
// max_depth + 2, which it never reaches: an iteration that does not end
// the path shades once, and a hit at depth max_depth ends it, so a path
// ends within max_depth + 1 iterations.
//
// What bounds it on the H100: chains of dependent latency. A closest-hit
// step is a Moller-Trumbore test per triangle (one reciprocal) on a row
// read from shared memory; a path runs about 2.6 iterations of 12 tests
// and a shadow sweep at the bench box. The first design ran one thread a
// pixel over all its samples: 65,536 threads at 256^2, about 496 an SM at
// 94-117 registers, four warps a scheduler, too few to hide that latency.
//
// Work layout: a work item is one (pixel, sample) path of a chunk of
// samples, item = (sample - samp0) * npix + pixel (B2's items, groups of
// K = 1 sample). A lane writes its path's radiance to an (n_samp, npix, 3)
// scratch, which vspg_kernels.reduce_samples (vspg_reduce_kernel,
// csrc/vspg.cu) adds per pixel in sample order and scales, so the image
// is deterministic. A lane runs one flat loop of path iterations, as the
// one-thread-a-pixel design did: when its path ends it takes its next item
// in the same step, so no lane of a warp idles while another finishes a
// longer path (a loop a path inside a loop over samples ran slower than
// the one-thread-a-pixel design, PERF.md section 6). Each block copies the
// triangle table (at most 128 rows of 16 floats, 8 KB) and the constant
// table into shared memory once; the lanes of a warp read the same
// triangle row in the same sweep step, so those reads are broadcasts, of
// three float4 a row. SMs x B persistent blocks of 128 threads, B from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor under
// __launch_bounds__(128, PATH_SURFACE_MIN_BLOCKS); the lanes of a warp
// that ask together take consecutive items with one atomicAdd on a
// zeroed counter (take_items, common.cuh). Templated on the structural
// switches only (a point light, an environment); materials, lights and
// camera come from the table.
//
// Shipped: PATH_SURFACE_MIN_BLOCKS 4, which leaves ptxas at 69-76
// registers with no spills, so the card holds 7 blocks an SM; chosen by
// `python -m vspg_pbrt_v4_tpu_torch.benchmarks.group_items --sweep` on an
// NVIDIA H100 80GB HBM3 at 700 W: 0.933 ms at 256^2 x 64 against 0.938 at
// 6 (the same registers) and 0.941 at 8 (64 registers, 20-40 bytes of
// spill stores); one thread a pixel took 1.368-1.374 ms in the same call
// (`--turns`; PERF.md section 6). Groups of 2-16 samples, a static stride
// instead of the counter and nine scalar reads a row instead of three
// float4 ran no faster on that card and are not kept.
#ifndef PATH_SURFACE_MIN_BLOCKS
#define PATH_SURFACE_MIN_BLOCKS 4
#endif
#include "common.cuh"
#include "surface.cuh"

using namespace vp;

namespace {

// float32 constant table (ops/surface_kernels.py S_*)
enum SConst {
  S_RC = 0,          // raster -> camera, 4x4 row-major
  S_CW = 16,         // camera -> world, 4x4 row-major
  S_ALB = 32,        // material albedos (MAX_SURF_MATS, 3)
  S_AP0 = 56,        // area lights: first corner (MAX_AREA_LIGHTS, 3)
  S_AE1 = 80,        // p1 - p0
  S_AE2 = 104,       // p2 - p0
  S_AN = 128,        // unit normal
  S_AL = 152,        // emitted radiance
  S_AAREA = 176,     // area (MAX_AREA_LIGHTS)
  S_ATWO = 184,      // two-sided (1) or not (0)
  S_LP = 192,        // point light position (3)
  S_LI = 195,        // point light intensity (3)
  S_ENV = 198,       // constant environment radiance (3)
  S_NX = 201,
  S_NY = 202,
  S_IMAGING = 203,   // the film's imaging ratio (the host folds it)
  S_MAX_DEPTH = 204,
  S_RR_START = 205,
  S_N_LIGHTS = 206,
  S_N_TRI = 207,
  S_N_AREA = 208,
  S_N_MAT = 209,
  S_PMF = 210,       // 1 / n_lights
  S_PENV = 211,      // pmf / (4 pi)
  N_SCONST = 212
};

// triangle table, one row of ST_COLS floats per triangle
// (ops/surface_kernels.py ST_*; pallas_surface's layout)
enum STriCol {
  ST_P0 = 0,     // first corner (3)
  ST_E1 = 3,     // p1 - p0 (3)
  ST_E2 = 6,     // p2 - p0 (3)
  ST_NG = 9,     // unit normal (3)
  ST_MAT = 12,   // material id
  ST_LIGHT = 13, // area light id, -1 = none
  ST_COLS = 16
};

constexpr int MAX_SURF_TRIS = 128;
constexpr int SURF_THREADS = 128;
constexpr float TWO_PI_F = (float)(2.0 * 3.14159265358979323846);
constexpr float INV_4PI_F = (float)(1.0 / (4.0 * 3.14159265358979323846));

// camera_ray and start_path of common.cuh read the two matrices at the
// volpath table's offsets
static_assert((int)S_RC == (int)F_RC && (int)S_CW == (int)F_CW,
              "camera matrices misplaced");

// corner p0 and edges e1, e2 (columns 0-8) of triangle i of the shared
// table, read as three float4
static __device__ __forceinline__ void tri_row(const float* tris, int i,
                                               V3* p0, V3* e1, V3* e2) {
  static_assert(ST_P0 == 0 && ST_E1 == 3 && ST_E2 == 6 && ST_COLS % 4 == 0,
                "triangle rows misplaced");
  const float4* r = reinterpret_cast<const float4*>(tris + i * ST_COLS);
  const float4 a = r[0], b = r[1], c = r[2];
  *p0 = v3(a.x, a.y, a.z);
  *e1 = v3(a.w, b.x, b.y);
  *e2 = v3(b.z, b.w, c.x);
}

// any triangle of the table hit along (o, d) in (1e-4, t_max); stops at
// the first
static __device__ __forceinline__ bool occluded(const float* tris, int n_tri,
                                                V3 o, V3 d, float t_max) {
  for (int i = 0; i < n_tri; ++i) {
    V3 p0, e1, e2;
    tri_row(tris, i, &p0, &e1, &e2);
    float tt, b1, b2;
    if (tri_test(p0, e1, e2, o, d, t_max, &tt, &b1, &b2)) return true;
  }
  return false;
}

// one path's state
struct SPath {
  V3 o, d, beta, L;
  float rl;  // 1 / pdf of the last bounce (vacuum: r_u == 1)
  uint32_t dim;
  int depth, it;
};

// a fresh camera path of sample `samp` of pixel `pix`
static __device__ __forceinline__ void surface_start(const float* fc,
                                                     uint32_t seed,
                                                     uint32_t pix,
                                                     uint32_t samp,
                                                     SPath& P) {
  int hero;  // unused: vacuum transport has no hero channel
  start_path(fc, (int)fc[S_NX], seed, pix, samp, &P.o, &P.d, &hero);
  P.dim = 1;
  P.beta = v3(1.f, 1.f, 1.f);
  P.L = v3(0.f, 0.f, 0.f);
  P.rl = 1.f;
  P.depth = 0;
  P.it = 0;
}

// One iteration of the path P of sample `samp` of pixel `pix`; returns
// whether the path goes on.
template <bool HAS_POINT, bool HAS_ENV>
static __device__ __forceinline__ bool surface_step(const float* fc,
                                                    const float* tris,
                                                    int n_tri, uint32_t seed,
                                                    uint32_t pix,
                                                    uint32_t samp, SPath& P) {
  const int n_area = (int)fc[S_N_AREA];
  const int n_mat = (int)fc[S_N_MAT];
  const int n_lights = (int)fc[S_N_LIGHTS];
  const int max_depth = (int)fc[S_MAX_DEPTH];
  const int rr_start = (int)fc[S_RR_START];
  const float pmf = fc[S_PMF], penv = fc[S_PENV];
  const V3 envL = v3(fc + S_ENV);
  V3 o = P.o, d = P.d, beta = P.beta, L = P.L;
  float rl = P.rl;
  int depth = P.depth;
  const uint32_t dim = P.dim;
  bool alive = true;
  {
    // ---- closest hit: the first of equal distances in table order ------
    float t_h = BIG;
    int k = -1;
    for (int i = 0; i < n_tri; ++i) {
      V3 p0, e1, e2;
      tri_row(tris, i, &p0, &e1, &e2);
      float tt, b1, b2;
      if (tri_test(p0, e1, e2, o, d, t_h, &tt, &b1, &b2)) {
        t_h = tt;
        k = i;
      }
    }
    const bool first = depth == 0;
    if (k < 0) {
      // ---- escaped: the environment with MIS ----------------------------
      if (HAS_ENV) {
        if (first) {
          L = v3(L.x + beta.x * envL.x, L.y + beta.y * envL.y,
                 L.z + beta.z * envL.z);
        } else {
          float den = fmaxf(1.0f + rl * penv, 1e-30f);
          L = v3(L.x + beta.x * envL.x / den, L.y + beta.y * envL.y / den,
                 L.z + beta.z * envL.z / den);
        }
      }
      alive = false;
    } else {
      const float* row = tris + k * ST_COLS;
      const V3 ng = v3(row + ST_NG);
      const int mat = (int)row[ST_MAT];
      const int li = (int)row[ST_LIGHT];
      // ---- emissive hit: one-sided against the stored normal ------------
      if (n_area > 0 && li >= 0) {
        float cos_o = -dot(ng, d);
        V3 Le = v3(0.f, 0.f, 0.f);
        float area_l = 1.0f;
        if (li < n_area) {
          if (cos_o > 0.0f || fc[S_ATWO + li] != 0.0f)
            Le = v3(fc + S_AL + 3 * li);
          area_l = fc[S_AAREA + li];
        }
        if (first) {
          L = v3(L.x + beta.x * Le.x, L.y + beta.y * Le.y,
                 L.z + beta.z * Le.z);
        } else {
          // pdf_li_area: pmf * dist^2 / (|cos_l| * area)
          float p_l = pmf * t_h * t_h / fmaxf(fabsf(cos_o) * area_l, 1e-30f);
          float den = fmaxf(1.0f + rl * p_l, 1e-30f);
          L = v3(L.x + beta.x * Le.x / den, L.y + beta.y * Le.y / den,
                 L.z + beta.z * Le.z / den);
        }
      }
      if (mat < 0 || depth >= max_depth) {
        alive = false;
      } else {
        // ---- shading -----------------------------------------------------
        depth += 1;
        const V3 h = along(o, t_h, d);
        const V3 ns = scale(ng, dot(ng, d) < 0.0f ? 1.0f : -1.0f);
        const V3 alb = mat < n_mat ? v3(fc + S_ALB + 3 * mat)
                                   : v3(0.f, 0.f, 0.f);
        const float4 un = uniform4(seed, pix, samp, dim);
        const float4 ub = uniform4(seed, pix, samp, dim + 1);

        // NEE: uniform pick over point | area... | env
        const int lsel = min((int)(un.x * (float)n_lights), n_lights - 1);
        V3 wi = v3(0.f, 0.f, 0.f), Lc = wi;
        float t_sh = 0.f, p_dir = 0.f;
        bool delta = false;
        int idx = 0;
        if (HAS_POINT) {
          if (lsel == 0) {
            V3 tl = sub(v3(fc + S_LP), h);
            float d2 = fmaxf(dot(tl, tl), 1e-12f);
            float dist = sqrtf(d2);
            float inv = 1.0f / dist;
            wi = scale(tl, inv);
            t_sh = dist;
            p_dir = 1.0f;
            delta = true;
            float inv_d2 = 1.0f / d2;
            Lc = scale(v3(fc + S_LI), inv_d2);
          }
          idx = 1;
        }
        if (lsel >= idx && lsel < idx + n_area) {
          // SampleUniformTriangle (sqrt-free variant) on p0 + b0 e1 + b1 e2
          const int a = lsel - idx;
          bool flip = un.y < un.z;
          float sb0 = flip ? un.y * 0.5f : un.y - un.z * 0.5f;
          float sb1 = flip ? un.z - sb0 : un.z * 0.5f;
          const float* p0 = fc + S_AP0 + 3 * a;
          const float* e1 = fc + S_AE1 + 3 * a;
          const float* e2 = fc + S_AE2 + 3 * a;
          V3 pl = v3(p0[0] + sb0 * e1[0] + sb1 * e2[0],
                     p0[1] + sb0 * e1[1] + sb1 * e2[1],
                     p0[2] + sb0 * e1[2] + sb1 * e2[2]);
          V3 tl = sub(pl, h);
          float d2 = fmaxf(dot(tl, tl), 1e-12f);
          float dist = sqrtf(d2);
          float inv = 1.0f / dist;
          wi = scale(tl, inv);
          float cos_l = -dot(wi, v3(fc + S_AN + 3 * a));
          bool front = fc[S_ATWO + a] != 0.0f ? fabsf(cos_l) > 1e-7f
                                              : cos_l > 1e-7f;
          t_sh = dist * (float)(1.0 - 1e-3);
          if (front) {
            p_dir = d2 / fmaxf(fabsf(cos_l) * fc[S_AAREA + a], 1e-30f);
            Lc = v3(fc + S_AL + 3 * a);
          }
        }
        idx += n_area;
        if (HAS_ENV && lsel == idx) {
          float ez = 1.0f - 2.0f * un.y;
          float er = sqrtf(fmaxf(1.0f - ez * ez, 0.0f));
          float ephi = TWO_PI_F * un.z;
          wi = v3(er * cosf(ephi), er * sinf(ephi), ez);
          t_sh = BIG;
          p_dir = INV_4PI_F;
          Lc = envL;
        }
        // diffuse BRDF: f = albedo / pi, pdf = cos / pi
        const float f_w = INV_PI_F * fmaxf(dot(wi, ns), 0.0f);
        const V3 so = along(h, 1e-4f, ns);
        if (p_dir > 0.0f && f_w > 0.0f &&
            (Lc.x > 0.0f || Lc.y > 0.0f || Lc.z > 0.0f) &&
            !occluded(tris, n_tri, so, wi, t_sh)) {
          float p_l = pmf * p_dir;
          float den = delta ? p_l : fmaxf(p_l + f_w, 1e-30f);
          float w = f_w / fmaxf(den, 1e-30f);
          L = v3(L.x + beta.x * alb.x * Lc.x * w,
                 L.y + beta.y * alb.y * Lc.y * w,
                 L.z + beta.z * alb.z * Lc.z * w);
        }

        // cosine-sampled bounce: beta *= f cos / pdf = albedo
        float r_s = sqrtf(ub.x);
        float phi = TWO_PI_F * ub.y;
        float lx = r_s * cosf(phi), ly = r_s * sinf(phi);
        float lz = sqrtf(fmaxf(1.0f - ub.x, 0.0f));
        V3 t1, t2;
        coordinate_system(ns, &t1, &t2);
        d = v3(lx * t1.x + ly * t2.x + lz * ns.x,
               lx * t1.y + ly * t2.y + lz * ns.y,
               lx * t1.z + ly * t2.z + lz * ns.z);
        float bpdf = INV_PI_F * fmaxf(lz, 1e-12f);
        beta = mul(beta, alb);
        if (max3(beta) <= 0.0f) alive = false;
        rl = 1.0f / bpdf;
        o = so;

        // Russian roulette (integrators.cpp:1301-1312)
        float rr_max = max3(beta);
        if (rr_max < 1.0f && depth >= rr_start) {
          float q = fmaxf(0.0f, 1.0f - rr_max);
          if (ub.z < q) {
            alive = false;
          } else {
            float inv_keep = 1.0f / fmaxf(1.0f - q, 1e-6f);
            beta = scale(beta, inv_keep);
          }
        }
      }
    }
    // NaN/Inf scrub of the path's radiance, every iteration
    if (!(isfinite(L.x) && isfinite(L.y) && isfinite(L.z)))
      L = v3(0.f, 0.f, 0.f);
  }
  P.o = o;
  P.d = d;
  P.beta = beta;
  P.L = L;
  P.rl = rl;
  P.depth = depth;
  P.dim = dim + 2;
  return alive;
}

// Samples samp0, ..., samp0 + n_samp - 1 of every pixel as n_samp * npix
// items, item = (sample - samp0) * npix + pixel; gbuf[item] = the
// sample's radiance. One flat loop of path iterations a lane: a lane whose
// path ends writes its radiance and takes its next item in the same step,
// so the lanes of a warp stay busy whatever their paths' lengths.
template <bool HAS_POINT, bool HAS_ENV>
__global__ void __launch_bounds__(SURF_THREADS, PATH_SURFACE_MIN_BLOCKS)
    path_surface_kernel(const float* __restrict__ fc_g,
                        const float* __restrict__ tris_g,
                        float* __restrict__ gbuf,
                        unsigned long long* __restrict__ next_item, int npix,
                        int samp0, int n_samp, uint32_t seed) {
  __shared__ float fc[N_SCONST];
  __shared__ __align__(16) float tris[MAX_SURF_TRIS * ST_COLS];
  const int n_tri = min((int)__ldg(fc_g + S_N_TRI), MAX_SURF_TRIS);
  for (int i = threadIdx.x; i < N_SCONST; i += blockDim.x) fc[i] = fc_g[i];
  for (int i = threadIdx.x; i < n_tri * ST_COLS; i += blockDim.x)
    tris[i] = tris_g[i];
  __syncthreads();
  // a path ends within max_depth + 1 iterations, so this cap never binds
  const int cap = (int)fc[S_MAX_DEPTH] + 2;
  const long long n_items = (long long)npix * n_samp;
  long long item = take_items(next_item);
  if (item >= n_items) return;
  // the lane's item: its pixel and sample
  uint32_t pix, samp;
  auto begin_item = [&]() {
    const int s = (int)(item / npix);
    pix = (uint32_t)(item - (long long)s * npix);
    samp = (uint32_t)(samp0 + s);
  };
  SPath P;
  begin_item();
  surface_start(fc, seed, pix, samp, P);
  for (;;) {
    const bool alive = surface_step<HAS_POINT, HAS_ENV>(fc, tris, n_tri, seed,
                                                        pix, samp, P);
    if (alive && ++P.it < cap) continue;
    gbuf[3 * item + 0] = P.L.x;
    gbuf[3 * item + 1] = P.L.y;
    gbuf[3 * item + 2] = P.L.z;
    item = take_items(next_item);
    if (item >= n_items) return;
    begin_item();
    surface_start(fc, seed, pix, samp, P);
  }
}

template <bool P, bool E>
int grid(int* out4) {
  static int cache[3] = {0, 0, 0};
  return (int)persistent_grid((const void*)path_surface_kernel<P, E>,
                              SURF_THREADS, 0, cache, out4);
}

template <bool P, bool E>
int launch(const float* fconst, const float* tris, float* gbuf,
           unsigned long long* next_item, int npix, int samp0, int n_samp,
           uint32_t seed, int blocks, cudaStream_t stream) {
  path_surface_kernel<P, E><<<blocks, SURF_THREADS, 0, stream>>>(
      fconst, tris, gbuf, next_item, npix, samp0, n_samp, seed);
  return (int)cudaGetLastError();
}

}  // namespace

// the persistent grid of the (point light, environment) instantiation:
// out4 = [resident blocks an SM, SMs, registers a thread, local memory
// bytes a thread]
extern "C" int path_surface_info(int has_point, int has_env, int* out4) {
  if (has_point && has_env) return grid<true, true>(out4);
  if (has_point) return grid<true, false>(out4);
  if (has_env) return grid<false, true>(out4);
  return grid<false, false>(out4);
}

// One chunk of samples on `blocks` persistent blocks, its items taken from
// *next_item (zeroed by the caller).
extern "C" int path_surface_launch(const float* fconst, const float* tris,
                                   float* gbuf,
                                   unsigned long long* next_item, int npix,
                                   int samp0, int n_samp, unsigned int seed,
                                   int has_point, int has_env, int blocks,
                                   void* stream) {
  if (npix < 1 || n_samp < 1 || samp0 < 0 || blocks < 1 ||
      next_item == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (has_point && has_env)
    return launch<true, true>(fconst, tris, gbuf, next_item, npix, samp0,
                              n_samp, seed, blocks, s);
  if (has_point)
    return launch<true, false>(fconst, tris, gbuf, next_item, npix, samp0,
                               n_samp, seed, blocks, s);
  if (has_env)
    return launch<false, true>(fconst, tris, gbuf, next_item, npix, samp0,
                               n_samp, seed, blocks, s);
  return launch<false, false>(fconst, tris, gbuf, next_item, npix, samp0,
                              n_samp, seed, blocks, s);
}
