// B2a/B2b/B2c: persistent volumetric path tracing of one density grid in a
// box, with or without flat triangles inside it.
//
// Replaces pallas_volpath._make_grid_kernel (vspg_pbrt_v4_tpu/ops/
// pallas_volpath.py) in three geometry modes: GEOM_NONE for scenes without
// triangles (B2a, volpath_grid.cu), GEOM_SWEEP for the teaser class (B2b,
// volpath_grid_tris.cu: at most 64 triangles of the materials of
// csrc/surface.cuh, their table and the material table in shared memory)
// and GEOM_BVH for the mesh class (B2c, volpath_grid_mesh.cu: at most
// 16384 triangles, the triangle and BVH node tables in global memory, each
// query a walk of the tree, csrc/bvh.cuh; the material table in shared
// memory). Per sample: pinhole ray; box entry/exit; the closest triangle
// (a Moller-Trumbore sweep of the table, or the BVH walk);
// delta tracking against the majorant DDA up to the nearer of the wall and
// the triangle (media.py seg_init/seg_next,
// volpath.sample_medium_interaction); at a real scatter, point or env NEE
// whose shadow ray is blocked by any triangle and otherwise ratio-tracked
// through the same DDA with its low-transmittance roulette
// (volpath.transmittance_ratio_tracking), HG phase sampling, then Russian
// roulette after NEE as in pallas_volpath.py:1886-1909; at a surface, NEE
// with the BSDF from the offset origin and BSDF sampling, a reflection
// keeping its medium and a transmission adopting the far side's label
// (volpath.volpath_bounce:755-768); escaped-ray env MIS, skipped after a
// delta bounce. A lane whose origin lies outside the box is in vacuum (the
// stuck-lane guard of pallas_volpath.py:1974-1985). Every event sweeps the
// triangles from its own origin, so no lane walks with a stale surface
// distance (the round-4 stall of the Pallas kernel has nothing to guard).
// cfg.max_collisions bounds each flight and each shadow walk.
//
// Random stream (this kernel's own; ops/volpath_kernels.render_grid_plain
// draws the same): dimension 0 for the camera; one uniform4 dimension per
// flight iteration [step, event]; per real scatter one for NEE [light
// select, env u, env v], one per shadow-walk iteration [step, roulette]
// and one for the phase [u0, u1, roulette]; per surface hit one for NEE,
// the shadow walk's, and one for the BSDF [lobe, u0, u1, roulette]. A
// blocked shadow ray draws nothing.
//
// What bounds it on the H100: dependent gathers (eight density loads per
// tentative collision, each after the position it needs) and divergence,
// since threads of a warp take different numbers of collisions and
// cell crossings. The density is a plain float32 grid in global memory
// (1 MB at 64^3, L2-resident) read with the exact 8-corner trilerp; the
// majorant grid sits in shared memory. The TPU's bf16/i8 tables, one-hot
// MXU gathers, stochastic trilerp, multi-cell walk, shadow state machine,
// deferred surface NEE, tiling, spp chunking and empty-space skip are not
// carried over, nor the mesh class's Morton-ordered chunk sweep
// (pallas_volpath pack_tri_chunks / make_mesh_closest_hit), the TPU's
// stand-in for a BVH. In the mesh class each closest-hit and shadow query
// adds a tree walk of dependent node and triangle loads from L2. One
// thread renders all samples of one pixel; a sample runs at most
// max_events path events.
#pragma once

#include "bvh.cuh"
#include "common.cuh"
#include "surface.cuh"

using namespace vp;

// the kernel's geometry modes (template argument GEOM)
enum Geom { GEOM_NONE = 0, GEOM_SWEEP = 1, GEOM_BVH = 2 };

namespace {

enum Outcome { RAN = 0, SCATTERED = 1, TERMINATED = 2 };

struct Grid {
  const float* __restrict__ density;
  const float* maj;  // shared memory
  int gx, gy, gz, mx, my, mz;
};

// NaN-propagating min/max, like torch.minimum/maximum
static __device__ __forceinline__ float pmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}
static __device__ __forceinline__ float pmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fmaxf(a, b);
}
// truncation toward zero, then clamp to [0, n-1] (out-of-range safe)
static __device__ __forceinline__ int clamp_idx(float g, int n) {
  float c = fminf(fmaxf(g, -1.0f), (float)n);
  return min(max((int)c, 0), n - 1);
}

struct DDA {
  float t_min, t_end, t1, maj;
  float t_next[3], t_delta[3];
  int vox[3], step[3];
};

static __device__ __forceinline__ float maj_at(const Grid& G, const int* v) {
  return G.maj[(v[0] * G.my + v[1]) * G.mz + v[2]];
}

// majorant DDA over [0, t_max] of (o, d); false when the ray misses
static __device__ bool dda_init(const float* fc, const Grid& G, V3 o, V3 d,
                                float t_max, DDA& w) {
  const float oc[3] = {o.x, o.y, o.z}, dc[3] = {d.x, d.y, d.z};
  const int m[3] = {G.mx, G.my, G.mz};
  float t_near = -INFINITY, t_far = INFINITY;
  bool any_near = false, any_far = false;
  for (int k = 0; k < 3; ++k) {
    float inv = 1.0f / dc[k];
    float lo = (fc[F_BMIN + k] - oc[k]) * inv;
    float hi = (fc[F_BMAX + k] - oc[k]) * inv;
    float a = pmin(lo, hi), b = pmax(lo, hi);  // NaN-skipping reductions
    if (!isnan(a)) { t_near = any_near ? fmaxf(t_near, a) : a; any_near = true; }
    if (!isnan(b)) { t_far = any_far ? fminf(t_far, b) : b; any_far = true; }
  }
  float t0 = fmaxf(t_near, 0.0f);
  float t1 = fminf(t_far, t_max);
  if (t0 >= t1) return false;
  w.t_min = t0;
  w.t1 = t1;
  float t_end = t1;
  for (int k = 0; k < 3; ++k) {
    float ext = fc[F_BMAX + k] - fc[F_BMIN + k];
    float p0 = oc[k] + (t0 + 1e-6f) * dc[k];
    float gpos = (p0 - fc[F_BMIN + k]) / ext * (float)m[k];
    w.vox[k] = clamp_idx(gpos, m[k]);
    float d_idx = dc[k] / ext * (float)m[k];
    w.step[k] = d_idx >= 0.0f ? 1 : -1;
    bool tiny = fabsf(d_idx) < 1e-20f;
    float den = tiny ? (d_idx >= 0.0f ? 1e-20f : -1e-20f) : d_idx;
    float safe_inv = 1.0f / den;
    float nb = (float)(w.vox[k] + (w.step[k] > 0 ? 1 : 0));
    w.t_next[k] = tiny ? INFINITY : t0 + (nb - gpos) * safe_inv;
    w.t_delta[k] = fabsf(safe_inv);
  }
  w.t_end = fminf(fminf(fminf(w.t_next[0], w.t_next[1]), w.t_next[2]), t_end);
  w.maj = maj_at(G, w.vox);
  return true;
}

// step into the next majorant cell; true when the walk left the grid
static __device__ bool dda_step(const Grid& G, DDA& w) {
  const int m[3] = {G.mx, G.my, G.mz};
  int axis = (w.t_next[0] <= w.t_next[1] && w.t_next[0] <= w.t_next[2])
                 ? 0
                 : (w.t_next[1] <= w.t_next[2] ? 1 : 2);
  w.vox[axis] += w.step[axis];
  w.t_next[axis] += w.t_delta[axis];
  float t_start = w.t_end;
  bool out = t_start >= w.t1 - 1e-7f;
  for (int k = 0; k < 3; ++k) {
    out = out || w.vox[k] < 0 || w.vox[k] >= m[k];
    w.vox[k] = min(max(w.vox[k], 0), m[k] - 1);
  }
  w.t_min = t_start;
  w.t_end = fminf(fminf(fminf(w.t_next[0], w.t_next[1]), w.t_next[2]), w.t1);
  w.maj = maj_at(G, w.vox);
  return out;
}

// exact trilinear density (media._trilerp), zero outside the box
static __device__ float density_at(const float* fc, const Grid& G, V3 p) {
  if (outside_box(fc, p)) return 0.0f;
  const float pc[3] = {p.x, p.y, p.z};
  const int n[3] = {G.gx, G.gy, G.gz};
  int i0[3], i1[3];
  float w[3];
  for (int k = 0; k < 3; ++k) {
    float g = (pc[k] - fc[F_BMIN + k]) / (fc[F_BMAX + k] - fc[F_BMIN + k]) *
                  (float)n[k] -
              0.5f;
    float g0 = floorf(g);
    w[k] = g - g0;
    i0[k] = clamp_idx(g0, n[k]);
    i1[k] = min(i0[k] + 1, n[k] - 1);
  }
  const float* D = G.density;
  auto at = [&](int x, int y, int z) {
    return __ldg(D + ((size_t)x * G.gy + y) * G.gz + z);
  };
  auto lerp = [](float a, float b, float t) { return a * (1 - t) + b * t; };
  float d00 = lerp(at(i0[0], i0[1], i0[2]), at(i1[0], i0[1], i0[2]), w[0]);
  float d10 = lerp(at(i0[0], i1[1], i0[2]), at(i1[0], i1[1], i0[2]), w[0]);
  float d01 = lerp(at(i0[0], i0[1], i1[2]), at(i1[0], i0[1], i1[2]), w[0]);
  float d11 = lerp(at(i0[0], i1[1], i1[2]), at(i1[0], i1[1], i1[2]), w[0]);
  float d0 = lerp(d00, d10, w[1]);
  float d1 = lerp(d01, d11, w[1]);
  return lerp(d0, d1, w[2]);
}

struct Path {
  V3 o, d, beta, ru, rl, L;
  int depth, hero;
  uint32_t dim;
};

// delta tracking along (o, d) over [0, seg]
static __device__ int flight(const float* fc, const int* ic, const Grid& G,
                             uint32_t seed, uint32_t pix, uint32_t samp,
                             float seg, Path& P, float* t_sc) {
  DDA w;
  if (!dda_init(fc, G, P.o, P.d, seg, w)) return RAN;
  const V3 st = v3(fc + F_ST), sa = v3(fc + F_SA), ss = v3(fc + F_SS);
  const float st_h = sel(st, P.hero);
  V3 T_maj = v3(1.f, 1.f, 1.f);
  for (int n = 0; n < ic[I_MAX_COLL]; ++n) {
    float4 u = uniform4(seed, pix, samp, P.dim);
    P.dim += 1;
    V3 sigma_maj = scale(st, w.maj);
    float maj_h = w.maj * st_h;
    float t = maj_h > 0.f ? w.t_min + (-log1pf(-u.x)) / fmaxf(maj_h, 1e-30f)
                          : INFINITY;
    if (t >= w.t_end) {
      float dt = fminf(fmaxf(w.t_end - w.t_min, 0.0f), 3e37f);
      T_maj = mul(T_maj, exp_neg(sigma_maj, dt));
      if (dda_step(G, w)) break;
      continue;
    }
    T_maj = mul(T_maj, exp_neg(sigma_maj, t - w.t_min));
    float dens = density_at(
        fc, G, v3(P.o.x + t * P.d.x, P.o.y + t * P.d.y, P.o.z + t * P.d.z));
    V3 sa_c = scale(sa, dens), ss_c = scale(ss, dens);
    float T_maj_h = sel(T_maj, P.hero);
    float sa_h = sel(sa_c, P.hero), ss_h = sel(ss_c, P.hero);
    float p_absorb = sa_h / fmaxf(maj_h, 1e-30f);
    float p_scatter = ss_h / fmaxf(maj_h, 1e-30f);
    if (u.y < p_absorb) return TERMINATED;
    if (u.y < p_absorb + p_scatter) {
      if (P.depth >= ic[I_MAX_DEPTH]) return TERMINATED;
      P.depth += 1;
      float pdf = fmaxf(T_maj_h * ss_h, 1e-30f);
      V3 sc = v3(T_maj.x * ss_c.x / pdf, T_maj.y * ss_c.y / pdf,
                 T_maj.z * ss_c.z / pdf);
      P.beta = mul(P.beta, sc);
      P.ru = mul(P.ru, sc);
      *t_sc = t;
      return SCATTERED;
    }
    // null collision
    V3 sn = v3(fmaxf(sigma_maj.x - sa_c.x - ss_c.x, 0.0f),
               fmaxf(sigma_maj.y - sa_c.y - ss_c.y, 0.0f),
               fmaxf(sigma_maj.z - sa_c.z - ss_c.z, 0.0f));
    float pdf_n = T_maj_h * sel(sn, P.hero);
    float inv = 1.0f / fmaxf(pdf_n, 1e-30f);
    P.beta = pdf_n == 0.f ? v3(0.f, 0.f, 0.f)
                          : v3(P.beta.x * T_maj.x * sn.x * inv,
                               P.beta.y * T_maj.y * sn.y * inv,
                               P.beta.z * T_maj.z * sn.z * inv);
    P.ru = v3(P.ru.x * T_maj.x * sn.x * inv, P.ru.y * T_maj.y * sn.y * inv,
              P.ru.z * T_maj.z * sn.z * inv);
    P.rl = v3(P.rl.x * T_maj.x * sigma_maj.x * inv,
              P.rl.y * T_maj.y * sigma_maj.y * inv,
              P.rl.z * T_maj.z * sigma_maj.z * inv);
    if (max3(P.beta) == 0.f || max3(P.ru) == 0.f) return TERMINATED;
    T_maj = v3(1.f, 1.f, 1.f);
    w.t_min = t;
  }
  // reached the end of the flight (or max_collisions): hero rescale
  float T_h = fmaxf(sel(T_maj, P.hero), 1e-30f);
  V3 sc = v3(T_maj.x / T_h, T_maj.y / T_h, T_maj.z / T_h);
  P.beta = mul(P.beta, sc);
  P.ru = mul(P.ru, sc);
  P.rl = mul(P.rl, sc);
  return RAN;
}

// ratio-tracked transmittance of the shadow ray (p, wi) over [0, seg]
static __device__ void ratio_track(const float* fc, const int* ic,
                                   const Grid& G, uint32_t seed, uint32_t pix,
                                   uint32_t samp, V3 p, V3 wi, float seg,
                                   int hero, uint32_t* dim, V3* T_ray,
                                   V3* tr_l, V3* tr_u) {
  *T_ray = *tr_l = *tr_u = v3(1.f, 1.f, 1.f);
  DDA w;
  if (!dda_init(fc, G, p, wi, seg, w)) return;
  const V3 st = v3(fc + F_ST), sa = v3(fc + F_SA), ss = v3(fc + F_SS);
  const float st_h = sel(st, hero);
  V3 T_maj = v3(1.f, 1.f, 1.f), Tr = *T_ray, rl = *tr_l, ru = *tr_u;
  for (int n = 0; n < ic[I_MAX_COLL]; ++n) {
    float4 u = uniform4(seed, pix, samp, *dim);
    *dim += 1;
    V3 sigma_maj = scale(st, w.maj);
    float maj_h = w.maj * st_h;
    float t = maj_h > 0.f ? w.t_min + (-log1pf(-u.x)) / fmaxf(maj_h, 1e-30f)
                          : INFINITY;
    if (t >= w.t_end) {
      float dt = fminf(fmaxf(w.t_end - w.t_min, 0.0f), 3e37f);
      T_maj = mul(T_maj, exp_neg(sigma_maj, dt));
      if (dda_step(G, w)) break;
      continue;
    }
    T_maj = mul(T_maj, exp_neg(sigma_maj, t - w.t_min));
    float dens = density_at(
        fc, G, v3(p.x + t * wi.x, p.y + t * wi.y, p.z + t * wi.z));
    V3 sn = v3(fmaxf(sigma_maj.x - dens * sa.x - dens * ss.x, 0.0f),
               fmaxf(sigma_maj.y - dens * sa.y - dens * ss.y, 0.0f),
               fmaxf(sigma_maj.z - dens * sa.z - dens * ss.z, 0.0f));
    float pdf = fmaxf(sel(T_maj, hero) * maj_h, 1e-30f);
    Tr = v3(Tr.x * T_maj.x * sn.x / pdf, Tr.y * T_maj.y * sn.y / pdf,
            Tr.z * T_maj.z * sn.z / pdf);
    rl = v3(rl.x * T_maj.x * sigma_maj.x / pdf,
            rl.y * T_maj.y * sigma_maj.y / pdf,
            rl.z * T_maj.z * sigma_maj.z / pdf);
    ru = v3(ru.x * T_maj.x * sn.x / pdf, ru.y * T_maj.y * sn.y / pdf,
            ru.z * T_maj.z * sn.z / pdf);
    // low-transmittance roulette (integrators.cpp:1404-1412)
    float den = fmaxf(avg3(v3(rl.x + ru.x, rl.y + ru.y, rl.z + ru.z)), 1e-30f);
    if (max3(v3(Tr.x / den, Tr.y / den, Tr.z / den)) < 0.05f)
      Tr = u.y < 0.75f ? v3(0.f, 0.f, 0.f)
                       : v3(Tr.x / 0.25f, Tr.y / 0.25f, Tr.z / 0.25f);
    if (max3(Tr) == 0.f) break;
    T_maj = v3(1.f, 1.f, 1.f);
    w.t_min = t;
  }
  float T_h = fmaxf(sel(T_maj, hero), 1e-30f);
  V3 sc = v3(T_maj.x / T_h, T_maj.y / T_h, T_maj.z / T_h);
  *T_ray = mul(Tr, sc);
  *tr_l = mul(rl, sc);
  *tr_u = mul(ru, sc);
}

// The lights' constants, read once from the constant table into registers.
// Read from shared memory at each NEE instead, the GEOM_NONE build from
// ptxas -O3 (CUDA 12.9) lost whole warps' later samples on an H100; see
// SOURCE_FLAGS in ops/_build.py for the other builds.
struct LightC {
  V3 lp, lI, env;
  float pmf, penv, two_pi;
};

// NEE contribution from p toward wi: f_hat is the BSDF or phase value
// (times the cosine), spdf its sampling pdf for MIS against env hits. Any
// triangle nearer than the light blocks (all are opaque); a lane in the
// medium ratio-tracks the rest of the shadow ray to the box exit.
template <int GEOM>
static __device__ V3 nee(const float* fc, const int* ic, const Grid& G,
                         const LightC& lc, const float* tris,
                         const float* nodes, int n_tri, uint32_t seed,
                         uint32_t pix, uint32_t samp, V3 p, V3 wi,
                         bool use_point, float dist, float dist2, V3 f_hat,
                         float spdf, bool in_med, int hero, uint32_t* dim,
                         V3 beta, V3 ru) {
  float seg = use_point ? dist : BIG;
  if constexpr (GEOM == GEOM_SWEEP) {
    if (closest_tri(tris, n_tri, p, wi, seg).k >= 0) return v3(0.f, 0.f, 0.f);
  } else if constexpr (GEOM == GEOM_BVH) {
    if (bvh_hit<true>(nodes, tris, p, wi, seg).k >= 0)
      return v3(0.f, 0.f, 0.f);
  }
  float t_exit;
  bool ent;
  box_hit(fc, p, wi, &t_exit, &ent);
  V3 T_ray = v3(1.f, 1.f, 1.f), tr_l = T_ray, tr_u = T_ray;
  if (in_med)
    ratio_track(fc, ic, G, seed, pix, samp, p, wi, fminf(seg, t_exit), hero,
                dim, &T_ray, &tr_l, &tr_u);
  V3 Le = use_point ? v3(lc.lI.x / dist2, lc.lI.y / dist2, lc.lI.z / dist2)
                    : lc.env;
  float p_l = use_point ? lc.pmf : lc.penv;
  V3 r_l = v3(tr_l.x * ru.x * p_l, tr_l.y * ru.y * p_l, tr_l.z * ru.z * p_l);
  V3 r_u = v3(tr_u.x * ru.x * spdf, tr_u.y * ru.y * spdf,
              tr_u.z * ru.z * spdf);
  float denom = use_point ? avg3(r_l) : avg3(add(r_l, r_u));
  if (!(denom > 0.f)) return v3(0.f, 0.f, 0.f);
  float dn = fmaxf(denom, 1e-30f);
  return v3(beta.x * f_hat.x * T_ray.x * Le.x / dn,
            beta.y * f_hat.y * T_ray.y * Le.y / dn,
            beta.z * f_hat.z * T_ray.z * Le.z / dn);
}

// NEE light choice at p
static __device__ __forceinline__ V3 light_pick(const LightC& lc,
                                                bool has_point, bool has_env,
                                                V3 p, float4 u,
                                                bool* use_point, float* dist,
                                                float* dist2) {
  *use_point = has_point && (!has_env || u.x < lc.pmf);
  V3 pl = sub(p, lc.lp);
  *dist2 = fmaxf(dot(pl, pl), 1e-12f);
  *dist = sqrtf(*dist2);
  if (*use_point) {
    float inv_dist = 1.0f / *dist;
    return v3(-pl.x * inv_dist, -pl.y * inv_dist, -pl.z * inv_dist);
  }
  float ez = 1.0f - 2.0f * u.y;
  float er = sqrtf(fmaxf(1.0f - ez * ez, 0.0f));
  float phi = lc.two_pi * u.z;
  return v3(er * cosf(phi), er * sinf(phi), ez);
}

// throughput roulette (integrators.cpp:1301-1312); false when it kills
static __device__ __forceinline__ bool roulette(const int* ic, Path& P,
                                                float eta_scale, float u) {
  float ru_avg = fmaxf(avg3(P.ru), 1e-30f);
  float rr_max = max3(v3(P.beta.x * eta_scale / ru_avg,
                         P.beta.y * eta_scale / ru_avg,
                         P.beta.z * eta_scale / ru_avg));
  if (!(P.depth >= ic[I_RR_START] && rr_max < 1.0f)) return true;
  float q = fmaxf(1.0f - rr_max, 0.0f);
  if (u < q) return false;
  float s1q = fmaxf(1.0f - q, 1e-6f);
  P.beta = v3(P.beta.x / s1q, P.beta.y / s1q, P.beta.z / s1q);
  return true;
}

}  // namespace

// nodes_g: the BVH node table (GEOM_BVH only); tris_g is then read in
// place, 16-byte aligned
template <int GEOM>
__global__ void __launch_bounds__(128)
    volpath_grid_kernel(const float* __restrict__ fc_g,
                        const int* __restrict__ ic_g,
                        const float* __restrict__ density,
                        const float* __restrict__ majorant,
                        const float* __restrict__ tris_g,
                        const float* __restrict__ nodes_g,
                        const float* __restrict__ mats_g,
                        float* __restrict__ out, int npix, int spp,
                        uint32_t seed, float out_scale, int nmaj, int n_tri,
                        int n_mat) {
  __shared__ float fc[N_FCONST];
  __shared__ int ic[N_ICONST];
  extern __shared__ float smem[];
  float* smaj = smem;
  float* stris = smem + nmaj;
  float* smats = stris + (GEOM == GEOM_SWEEP ? n_tri * TRI_COLS : 0);
  load_consts(fc_g, ic_g, fc, ic);
  for (int i = threadIdx.x; i < nmaj; i += blockDim.x) smaj[i] = majorant[i];
  if constexpr (GEOM == GEOM_SWEEP) {
    for (int i = threadIdx.x; i < n_tri * TRI_COLS; i += blockDim.x)
      stris[i] = tris_g[i];
  }
  if constexpr (GEOM != GEOM_NONE) {
    for (int i = threadIdx.x; i < n_mat * MAT_COLS; i += blockDim.x)
      smats[i] = mats_g[i];
  }
  // the triangle rows surface hits read
  const float* tab = GEOM == GEOM_BVH ? tris_g : stris;
  __syncthreads();
  int pix_i = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix_i >= npix) return;
  const uint32_t pix = (uint32_t)pix_i;
  const Grid G = {density, smaj, ic[I_GX], ic[I_GY], ic[I_GZ],
                  ic[I_MX], ic[I_MY], ic[I_MZ]};
  const bool has_point = ic[I_HAS_POINT] != 0;
  const bool has_env = ic[I_HAS_ENV] != 0;
  const bool iso = ic[I_HG_ISO] != 0;
  const LightC lc = {v3(fc + F_LP), v3(fc + F_LI), v3(fc + F_ENV),
                     fc[F_PMF],      fc[F_PENV],     fc[F_TWO_PI]};

  V3 acc = v3(0.f, 0.f, 0.f);
  for (int s = 0; s < spp; ++s) {
    const uint32_t samp = (uint32_t)s;
    Path P;
    start_path(fc, ic[I_NX], seed, pix, samp, &P.o, &P.d, &P.hero);
    P.dim = 1;
    P.beta = P.ru = P.rl = v3(1.f, 1.f, 1.f);
    P.L = v3(0.f, 0.f, 0.f);
    P.depth = 0;
    int med = -1;
    bool specular = false;  // the last bounce was a delta lobe
    float eta_scale = 1.0f;
    for (int ev = 0; ev < ic[I_MAX_EVENTS]; ++ev) {
      // stuck-lane guard: an origin outside the box is in vacuum
      if (med == 0 && outside_box(fc, P.o)) med = -1;
      float t_wall;
      bool entering;
      bool hit = box_hit(fc, P.o, P.d, &t_wall, &entering);
      float wall = hit ? t_wall : BIG;
      TriHit th = {-1, wall, 0.f, 0.f};
      if constexpr (GEOM == GEOM_SWEEP)
        th = closest_tri(stris, n_tri, P.o, P.d, wall);
      else if constexpr (GEOM == GEOM_BVH)
        th = bvh_hit<false>(nodes_g, tris_g, P.o, P.d, wall);
      float t_sc = 0.f;
      int outcome = RAN;
      if (med == 0)
        outcome = flight(fc, ic, G, seed, pix, samp, th.t, P, &t_sc);
      bool alive = outcome != TERMINATED;
      if (outcome == SCATTERED) {
        V3 p = v3(P.o.x + t_sc * P.d.x, P.o.y + t_sc * P.d.y,
                  P.o.z + t_sc * P.d.z);
        V3 wo = v3(-P.d.x, -P.d.y, -P.d.z);
        float4 un = uniform4(seed, pix, samp, P.dim);
        P.dim += 1;
        bool use_point;
        float dist, dist2;
        V3 wi = light_pick(lc, has_point, has_env, p, un, &use_point, &dist,
                           &dist2);
        float f = hg_value(fc, dot(wo, wi));
        if (f > 0.f)
          P.L = add(P.L, nee<GEOM>(fc, ic, G, lc, tab, nodes_g, n_tri, seed,
                                   pix, samp, p, wi, use_point, dist, dist2,
                                   v3(f, f, f), f, true, P.hero, &P.dim,
                                   P.beta, P.ru));
        // phase sampling, then volume Russian roulette
        float4 uv = uniform4(seed, pix, samp, P.dim);
        P.dim += 1;
        float ppdf;
        V3 wi_p = sample_hg(fc, iso, wo, uv.x, uv.y, &ppdf);
        bool ok_phase = ppdf > 0.f;
        float pdf_c = fmaxf(ppdf, 1e-30f);
        P.rl = v3(P.ru.x / pdf_c, P.ru.y / pdf_c, P.ru.z / pdf_c);
        alive = ok_phase && roulette(ic, P, eta_scale, uv.z);
        P.o = p;
        P.d = wi_p;
        specular = false;
      } else if (alive && th.k >= 0) {
        // surface hit (with triangles): NEE with the BSDF, then BSDF
        // sampling
        if (P.depth >= ic[I_MAX_DEPTH]) {
          alive = false;
        } else {
          P.depth += 1;
          const float* r = tab + th.k * TRI_COLS;
          V3 p = along(P.o, th.t, P.d);
          V3 ng = v3(r + T_NG);
          Mat m = surface_mat(smats, r, th.b1, th.b2);
          V3 t1, t2;
          coordinate_system(ng, &t1, &t2);
          V3 wo = v3(-P.d.x, -P.d.y, -P.d.z);
          V3 wo_l = v3(dot(wo, t1), dot(wo, t2), dot(wo, ng));
          float4 un = uniform4(seed, pix, samp, P.dim);
          P.dim += 1;
          float scl = fmaxf(fmaxf(fmaxf(fabsf(p.x), fabsf(p.y)), fabsf(p.z)),
                            1.0f);
          float off = (dot(ng, wo) >= 0.0f ? 1.0f : -1.0f) * 1e-4f * scl;
          V3 p_off = v3(p.x + off * ng.x, p.y + off * ng.y, p.z + off * ng.z);
          bool use_point;
          float dist, dist2;
          V3 wi = light_pick(lc, has_point, has_env, p_off, un, &use_point,
                             &dist, &dist2);
          V3 wi_l = v3(dot(wi, t1), dot(wi, t2), dot(wi, ng));
          V3 f_hat = scale(bsdf_f(m, wo_l, wi_l), fabsf(dot(wi, ng)));
          if (!is_specular(m) && max3(f_hat) > 0.f)
            P.L = add(P.L, nee<GEOM>(fc, ic, G, lc, tab, nodes_g, n_tri, seed,
                                     pix, samp, p_off, wi, use_point, dist,
                                     dist2, f_hat, bsdf_pdf(m, wo_l, wi_l),
                                     med == 0, P.hero, &P.dim, P.beta, P.ru));
          float4 ub = uniform4(seed, pix, samp, P.dim);
          P.dim += 1;
          BSample bs = bsdf_sample(m, wo_l, ub.x, ub.y, ub.z);
          if (!(bs.valid && bs.pdf > 0.f)) {
            alive = false;
          } else {
            V3 w = normalize_safe(v3(
                bs.wi.x * t1.x + bs.wi.y * t2.x + bs.wi.z * ng.x,
                bs.wi.x * t1.y + bs.wi.y * t2.y + bs.wi.z * ng.y,
                bs.wi.x * t1.z + bs.wi.y * t2.z + bs.wi.z * ng.z));
            float cw = fabsf(dot(w, ng));
            float pdf_c = fmaxf(bs.pdf, 1e-30f);
            P.beta = v3(P.beta.x * (bs.f.x * cw / pdf_c),
                        P.beta.y * (bs.f.y * cw / pdf_c),
                        P.beta.z * (bs.f.z * cw / pdf_c));
            P.rl = v3(P.ru.x / pdf_c, P.ru.y / pdf_c, P.ru.z / pdf_c);
            specular = bs.specular;
            if (bs.transmission) eta_scale = eta_scale * bs.eta * bs.eta;
            // a reflection keeps its medium; a crossing adopts the far
            // side's label
            bool wi_front = dot(w, ng) > 0.0f;
            if (wi_front != (dot(P.d, ng) < 0.0f))
              med = (int)(wi_front ? r[T_MED_OUT] : r[T_MED_IN]);
            float off_w = (dot(ng, w) >= 0.0f ? 1.0f : -1.0f) * 1e-4f * scl;
            P.o = v3(p.x + off_w * ng.x, p.y + off_w * ng.y,
                     p.z + off_w * ng.z);
            P.d = w;
            alive = max3(P.beta) != 0.f && roulette(ic, P, eta_scale, ub.w);
          }
        }
      } else if (alive) {
        if (!hit) {
          // escaped: environment with MIS against the env NEE
          if (has_env) {
            float den;
            if (P.depth == 0 || specular)
              den = fmaxf(avg3(P.ru), 1e-30f);
            else
              den = fmaxf(avg3(v3(P.ru.x + P.rl.x * lc.penv,
                                  P.ru.y + P.rl.y * lc.penv,
                                  P.ru.z + P.rl.z * lc.penv)),
                          1e-30f);
            P.L = v3(P.L.x + P.beta.x * lc.env.x / den,
                     P.L.y + P.beta.y * lc.env.y / den,
                     P.L.z + P.beta.z * lc.env.z / den);
          }
          alive = false;
        } else {
          med = entering ? 0 : -1;
          float tt = t_wall + 1e-4f;
          P.o = v3(P.o.x + tt * P.d.x, P.o.y + tt * P.d.y, P.o.z + tt * P.d.z);
        }
      }
      if (!(isfinite(P.L.x) && isfinite(P.L.y) && isfinite(P.L.z)))
        P.L = v3(0.f, 0.f, 0.f);
      if (!alive) break;
    }
    acc = v3(acc.x + P.L.x, acc.y + P.L.y, acc.z + P.L.z);
  }
  out[3 * pix_i + 0] = acc.x * out_scale;
  out[3 * pix_i + 1] = acc.y * out_scale;
  out[3 * pix_i + 2] = acc.z * out_scale;
}
