// B5: persistent surface path tracing of the Cornell class, in vacuum.
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
// pixel's samples match the plain version
// ops/surface_kernels.render_surface_plain and the Pallas kernel.
//
// Work layout: one thread per pixel loops over its samples; no lockstep
// and no lane regeneration, which the TPU needed for its vector lanes.
// Each block copies the triangle table (at most 128 rows of 16 floats, 8
// KB) and the constant table into shared memory; every thread of a warp
// reads the same triangle row in the same sweep step, so those reads are
// broadcasts. Templated on the structural switches only (a point light,
// an environment); materials, lights and camera come from the table. The
// Pallas kernel caps a block's iterations at spp * (max_depth + 2); a
// thread runs at most that many, which a path of at most max_depth + 1
// iterations a sample never reaches.
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
constexpr float TWO_PI_F = (float)(2.0 * 3.14159265358979323846);
constexpr float INV_4PI_F = (float)(1.0 / (4.0 * 3.14159265358979323846));

// camera_ray and start_path of common.cuh read the two matrices at the
// volpath table's offsets
static_assert((int)S_RC == (int)F_RC && (int)S_CW == (int)F_CW,
              "camera matrices misplaced");

// any triangle of the table hit along (o, d) in (1e-4, t_max); stops at
// the first
static __device__ __forceinline__ bool occluded(const float* tris, int n_tri,
                                                V3 o, V3 d, float t_max) {
  for (int i = 0; i < n_tri; ++i) {
    const float* r = tris + i * ST_COLS;
    float tt, b1, b2;
    if (tri_test(v3(r + ST_P0), v3(r + ST_E1), v3(r + ST_E2), o, d, t_max,
                 &tt, &b1, &b2))
      return true;
  }
  return false;
}

template <bool HAS_POINT, bool HAS_ENV>
__global__ void __launch_bounds__(128)
    path_surface_kernel(const float* __restrict__ fc_g,
                        const float* __restrict__ tris_g,
                        float* __restrict__ out, int npix, int spp,
                        uint32_t seed, float out_scale) {
  __shared__ float fc[N_SCONST];
  __shared__ float tris[MAX_SURF_TRIS * ST_COLS];
  const int n_tri = min((int)__ldg(fc_g + S_N_TRI), MAX_SURF_TRIS);
  for (int i = threadIdx.x; i < N_SCONST; i += blockDim.x) fc[i] = fc_g[i];
  for (int i = threadIdx.x; i < n_tri * ST_COLS; i += blockDim.x)
    tris[i] = tris_g[i];
  __syncthreads();
  const int pix_i = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix_i >= npix) return;
  const uint32_t pix = (uint32_t)pix_i;
  const int nx = (int)fc[S_NX];
  const int n_area = (int)fc[S_N_AREA];
  const int n_mat = (int)fc[S_N_MAT];
  const int n_lights = (int)fc[S_N_LIGHTS];
  const int max_depth = (int)fc[S_MAX_DEPTH];
  const int rr_start = (int)fc[S_RR_START];
  const float pmf = fc[S_PMF], penv = fc[S_PENV];
  const V3 envL = v3(fc + S_ENV);
  const int max_iters = spp * (max_depth + 2);

  uint32_t samp = 0, dim = 1;
  V3 o, d;
  int hero;  // unused: vacuum transport has no hero channel
  start_path(fc, nx, seed, pix, samp, &o, &d, &hero);
  V3 beta = v3(1.f, 1.f, 1.f), L = v3(0.f, 0.f, 0.f), acc = L;
  float rl = 1.f;  // 1 / pdf of the last bounce (vacuum: r_u == 1)
  int depth = 0;
  bool alive = true;
  for (int it = 0; it < max_iters && alive; ++it) {
    // ---- closest hit: the first of equal distances in table order ------
    float t_h = BIG;
    int k = -1;
    for (int i = 0; i < n_tri; ++i) {
      const float* r = tris + i * ST_COLS;
      float tt, b1, b2;
      if (tri_test(v3(r + ST_P0), v3(r + ST_E1), v3(r + ST_E2), o, d, t_h,
                   &tt, &b1, &b2)) {
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
    dim += 2;
    if (!alive) {
      acc = add(acc, L);
      samp += 1;
      if ((int)samp < spp) {
        start_path(fc, nx, seed, pix, samp, &o, &d, &hero);
        dim = 1;
        beta = v3(1.f, 1.f, 1.f);
        rl = 1.f;
        L = v3(0.f, 0.f, 0.f);
        depth = 0;
        alive = true;
      }
    }
  }
  out[3 * pix_i + 0] = acc.x * out_scale;
  out[3 * pix_i + 1] = acc.y * out_scale;
  out[3 * pix_i + 2] = acc.z * out_scale;
}

template <bool P, bool E>
static void launch(const float* fconst, const float* tris, float* out,
                   int npix, int spp, uint32_t seed, float out_scale,
                   cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (npix + threads - 1) / threads;
  path_surface_kernel<P, E><<<blocks, threads, 0, stream>>>(
      fconst, tris, out, npix, spp, seed, out_scale);
}

}  // namespace

extern "C" int path_surface_launch(const float* fconst, const float* tris,
                                   float* out, int npix, int spp,
                                   unsigned int seed, float out_scale,
                                   int has_point, int has_env, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (has_point && has_env)
    launch<true, true>(fconst, tris, out, npix, spp, seed, out_scale, s);
  else if (has_point)
    launch<true, false>(fconst, tris, out, npix, spp, seed, out_scale, s);
  else if (has_env)
    launch<false, true>(fconst, tris, out, npix, spp, seed, out_scale, s);
  else
    launch<false, false>(fconst, tris, out, npix, spp, seed, out_scale, s);
  return (int)cudaGetLastError();
}
