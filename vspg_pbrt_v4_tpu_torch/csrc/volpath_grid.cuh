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
// cfg.max_collisions bounds each flight and each shadow walk, and
// cfg.max_events the events of a sample.
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
// since lanes take different numbers of collisions, cell crossings, tree
// nodes and events. The density is a plain float32 grid in global memory
// (1 MB at 64^3, L2-resident) read with the exact 8-corner trilerp; the
// majorant grid sits in shared memory. The TPU's bf16/i8 tables, one-hot
// MXU gathers, stochastic trilerp, multi-cell walk, deferred surface NEE,
// tiling, spp chunking and empty-space skip are not carried over, nor the
// mesh class's Morton-ordered chunk sweep (pallas_volpath pack_tri_chunks
// / make_mesh_closest_hit), the TPU's stand-in for a BVH.
//
// The design against divergence, B3's (csrc/vspg.cu): a work item is one
// (pixel, sample), sample-major (item % npix, samp0 + item / npix), on SMs
// x B persistent blocks of GRID_THREADS, B the instantiation's resident
// blocks an SM at its register budget (VOLPATH_GRID_MIN_BLOCKS); a 64-bit
// device counter hands out the items. Each lane runs one flat loop whose
// iterations move its path one step down a fixed order of steps (Step
// below): the event's box and closest-hit query, one delta-tracking
// iteration (a majorant-cell crossing or a tentative collision), the
// event's work (scatter with its light pick, surface with its BSDF frame
// and light pick, wall crossing, escape with env MIS), the shadow ray's
// occlusion query, one ratio-tracking iteration, the NEE fold, the phase
// or BSDF bounce, the event's end. A flight or shadow walk advances one
// iteration per loop iteration, so a warp never waits at a walk's exit for
// its slowest lane; a lane whose path ends writes the item's radiance and
// takes its next item in the same iteration. Each item starts from a fresh
// path: nothing is carried across samples. Its radiance goes to a (samples,
// npix, 3) scratch, and vspg_reduce_kernel (csrc/vspg.cu) adds a pixel's
// samples in sample order from zero, the order of the per-pixel loop this
// design replaced, so the image is the same from run to run. The BVH walk
// stays one call per query, its stack in local memory.
#pragma once

#include "bvh.cuh"
#include "common.cuh"
#include "surface.cuh"

using namespace vp;

// the kernel's geometry modes (template argument GEOM)
enum Geom { GEOM_NONE = 0, GEOM_SWEEP = 1, GEOM_BVH = 2 };

// Resident blocks an SM that ptxas budgets the kernel for (65536 registers
// / (GRID_THREADS x blocks): 2 allows 255 registers a thread, 3 168, 4
// 128). Each instantiation's source sets its shipped value, the fastest of
// chip_smoke.py's sweep, which rebuilds it with others
// (-DVOLPATH_GRID_MIN_BLOCKS=...).
#ifndef VOLPATH_GRID_MIN_BLOCKS
#error "define VOLPATH_GRID_MIN_BLOCKS before including volpath_grid.cuh"
#endif
constexpr int GRID_THREADS = 128;
// With VOLPATH_GRID_VOTE 1 the steps between walks (the event's query and
// work, the shadow ray's query, the bounce, the next item) wait for their
// warp: a lane at such a step takes it only when half its warp's active
// lanes are at that step or none walks, so that the warp runs each such
// step for many lanes at once; with 0 a lane takes each step when it gets
// there. Each source sets its shipped value, the faster of the two in
// chip_smoke.py's phase 15 (the triangle builds vote, B2a does not; PERF.md
// section 6). Each lane computes the same path either way.
#ifndef VOLPATH_GRID_VOTE
#error "define VOLPATH_GRID_VOTE before including volpath_grid.cuh"
#endif

namespace {

enum Outcome { RAN = 0, SCATTERED = 1, TERMINATED = 2 };

// a lane's next step; each loop iteration runs the steps in this order, a
// lane taking every one its mode reaches (a walk: one iteration of it)
enum Step {
  S_QUERY = 0,   // stuck-lane guard, box, closest hit, flight set-up
  S_WALK = 1,    // one iteration of the flight or of the shadow walk
  S_EVENT = 2,   // what the flight ended in: scatter, surface, wall, escape
  S_NEE = 3,     // the shadow ray's occlusion query and walk set-up
  S_FOLD = 4,    // the NEE contribution
  S_BOUNCE = 5,  // phase or BSDF sampling, then roulette
  S_END = 6,     // the event's end
  S_DONE = 7     // the path ended: write it, take the next item
};

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

// the hero-relative rescale T / T[hero] at the end of a walk
static __device__ __forceinline__ V3 hero_scale(V3 T, int hero) {
  float T_h = fmaxf(sel(T, hero), 1e-30f);
  return v3(T.x / T_h, T.y / T_h, T.z / T_h);
}

// The lights' constants, read once from the constant table into registers.
// Read from shared memory at each NEE instead, the per-pixel GEOM_NONE
// build from ptxas -O3 (CUDA 12.9) lost whole warps' later samples on an
// H100 (ROADMAP.md section C 1).
struct LightC {
  V3 lp, lI, env;
  float pmf, penv, two_pi;
};

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
static __device__ __forceinline__ bool roulette(int rr_start, Path& P,
                                                float eta_scale, float u) {
  float ru_avg = fmaxf(avg3(P.ru), 1e-30f);
  float rr_max = max3(v3(P.beta.x * eta_scale / ru_avg,
                         P.beta.y * eta_scale / ru_avg,
                         P.beta.z * eta_scale / ru_avg));
  if (!(P.depth >= rr_start && rr_max < 1.0f)) return true;
  float q = fmaxf(1.0f - rr_max, 0.0f);
  if (u < q) return false;
  float s1q = fmaxf(1.0f - q, 1e-6f);
  P.beta = v3(P.beta.x / s1q, P.beta.y / s1q, P.beta.z / s1q);
  return true;
}

// a surface hit: the point, its triangle row, geometric normal and frame,
// the material, wo in the frame and the offset scale. The event step and
// the bounce after the NEE walk both derive it from the event's closest
// hit, so the lane keeps four numbers across the walk instead of these.
struct Hit {
  const float* r;
  V3 p, ng, t1, t2, wo_l;
  Mat m;
  float scl;
};

static __device__ __forceinline__ Hit surface_at(const float* tab,
                                                 const float* smats,
                                                 const TriHit& th,
                                                 const Path& P) {
  Hit h;
  h.r = tab + th.k * TRI_COLS;
  h.p = along(P.o, th.t, P.d);
  h.ng = v3(h.r + T_NG);
  h.m = surface_mat(smats, h.r, th.b1, th.b2);
  coordinate_system(h.ng, &h.t1, &h.t2);
  V3 wo = v3(-P.d.x, -P.d.y, -P.d.z);
  h.wo_l = v3(dot(wo, h.t1), dot(wo, h.t2), dot(wo, h.ng));
  h.scl = fmaxf(fmaxf(fmaxf(fabsf(h.p.x), fabsf(h.p.y)), fabsf(h.p.z)),
                1.0f);
  return h;
}

}  // namespace

// One launch runs the n_items items of one chunk of samples: item i is
// sample samp0 + i / npix of pixel i % npix. Each lane takes items from
// *next_item (zeroed by the caller) until they run out and writes item i's
// radiance to lbuf[i] (3 floats). nodes_g: the BVH node table (GEOM_BVH
// only); tris_g is then read in place, 16-byte aligned.
template <int GEOM>
__global__ void __launch_bounds__(GRID_THREADS, VOLPATH_GRID_MIN_BLOCKS)
    volpath_grid_kernel(const float* __restrict__ fc_g,
                        const int* __restrict__ ic_g,
                        const float* __restrict__ density,
                        const float* __restrict__ majorant,
                        const float* __restrict__ tris_g,
                        const float* __restrict__ nodes_g,
                        const float* __restrict__ mats_g,
                        float* __restrict__ lbuf,
                        unsigned long long* __restrict__ next_item, int npix,
                        int samp0, long long n_items, uint32_t seed, int nmaj,
                        int n_tri, int n_mat) {
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
  long long item;
  const Grid G = {density, smaj, ic[I_GX], ic[I_GY], ic[I_GZ],
                  ic[I_MX], ic[I_MY], ic[I_MZ]};
  const bool has_point = ic[I_HAS_POINT] != 0;
  const bool has_env = ic[I_HAS_ENV] != 0;
  const bool iso = ic[I_HG_ISO] != 0;
  const int max_depth = ic[I_MAX_DEPTH], max_events = ic[I_MAX_EVENTS];
  const int max_coll = ic[I_MAX_COLL], rr_start = ic[I_RR_START];
  const LightC lc = {v3(fc + F_LP), v3(fc + F_LI), v3(fc + F_ENV),
                     fc[F_PMF],      fc[F_PENV],     fc[F_TWO_PI]};
  const V3 st = v3(fc + F_ST), sa = v3(fc + F_SA), ss = v3(fc + F_SS);
  const V3 one3 = v3(1.f, 1.f, 1.f), zero3 = v3(0.f, 0.f, 0.f);

  // lane state: the path, the event's closest hit and flight outcome, the
  // walk (the flight's, or the shadow ray's when `shadow`), the NEE request
  // and its transmittances
  uint32_t pix, samp;
  Path P;
  int med, ev, step, n, outcome;
  bool specular, alive, hit, entering, at_surf, shadow;
  float eta_scale, t_wall, t_sc;
  TriHit th;
  DDA w;
  V3 T_maj;
  V3 q_o, q_wi, f_hat, Tr, trl, tru;
  float q_dist, q_dist2, spdf;
  bool use_point, in_med;
  // a fresh path for `item`
  auto begin = [&]() {
    pix = (uint32_t)(item % npix);
    samp = (uint32_t)samp0 + (uint32_t)(item / npix);
    start_path(fc, ic[I_NX], seed, pix, samp, &P.o, &P.d, &P.hero);
    P.dim = 1;
    P.beta = P.ru = P.rl = one3;
    P.L = zero3;
    P.depth = 0;
    med = -1;
    specular = false;  // the last bounce was a delta lobe
    eta_scale = 1.0f;
    alive = true;
    ev = 0;
    step = max_events > 0 ? S_QUERY : S_DONE;
  };
  // whether this lane, at step `s`, should wait for more lanes of its warp
  // to get there (every lane votes)
  auto gather_wait = [&](int s) {
    if (!VOLPATH_GRID_VOTE) return false;
    const unsigned act = __activemask();
    const int at = __popc(__ballot_sync(act, step == s));
    const bool walk = __ballot_sync(act, step == S_WALK) != 0u;
    return step == s && walk && 2 * at < __popc(act);
  };

  item = (long long)atomicAdd(next_item, 1ull);
  if (item >= n_items) return;
  begin();

  for (;;) {
    const bool wait_query = gather_wait(S_QUERY);
    if (step == S_QUERY && !wait_query) {
      // stuck-lane guard: an origin outside the box is in vacuum
      if (med == 0 && outside_box(fc, P.o)) med = -1;
      hit = box_hit(fc, P.o, P.d, &t_wall, &entering);
      th = {-1, hit ? t_wall : BIG, 0.f, 0.f};
      if constexpr (GEOM == GEOM_SWEEP)
        th = closest_tri(stris, n_tri, P.o, P.d, th.t);
      else if constexpr (GEOM == GEOM_BVH)
        th = bvh_hit<false>(nodes_g, tris_g, P.o, P.d, th.t);
      outcome = RAN;
      step = S_EVENT;
      // delta tracking over [0, th.t] in the medium (a flight of no
      // iterations rescales by one)
      if (med == 0 && max_coll > 0 &&
          dda_init(fc, G, P.o, P.d, th.t, w)) {
        T_maj = one3;
        n = 0;
        shadow = false;
        step = S_WALK;
      }
    }

    if (step == S_WALK) {
      // one iteration of the flight's delta tracking along (P.o, P.d) or
      // of the shadow ray's ratio tracking along (q_o, q_wi): the draw, the
      // majorant cell's end or the tentative collision and its density
      // are common to both
      const V3 o = shadow ? q_o : P.o, d = shadow ? q_wi : P.d;
      float4 u = uniform4(seed, pix, samp, P.dim);
      P.dim += 1;
      const V3 sigma_maj = scale(st, w.maj);
      const float maj_h = w.maj * sel(st, P.hero);
      float t = maj_h > 0.f ? w.t_min + (-log1pf(-u.x)) / fmaxf(maj_h, 1e-30f)
                            : INFINITY;
      bool done = false;  // the walk left the grid, or its Tr reached 0
      if (t >= w.t_end) {
        float dt = fminf(fmaxf(w.t_end - w.t_min, 0.0f), 3e37f);
        T_maj = mul(T_maj, exp_neg(sigma_maj, dt));
        done = dda_step(G, w);
      } else {
        T_maj = mul(T_maj, exp_neg(sigma_maj, t - w.t_min));
        float dens =
            density_at(fc, G, v3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z));
        if (!shadow) {
          V3 sa_c = scale(sa, dens), ss_c = scale(ss, dens);
          float T_maj_h = sel(T_maj, P.hero);
          float sa_h = sel(sa_c, P.hero), ss_h = sel(ss_c, P.hero);
          float p_absorb = sa_h / fmaxf(maj_h, 1e-30f);
          float p_scatter = ss_h / fmaxf(maj_h, 1e-30f);
          if (u.y < p_absorb) {
            outcome = TERMINATED;
          } else if (u.y < p_absorb + p_scatter) {
            if (P.depth >= max_depth) {
              outcome = TERMINATED;
            } else {
              P.depth += 1;
              float pdf = fmaxf(T_maj_h * ss_h, 1e-30f);
              V3 sc = v3(T_maj.x * ss_c.x / pdf, T_maj.y * ss_c.y / pdf,
                         T_maj.z * ss_c.z / pdf);
              P.beta = mul(P.beta, sc);
              P.ru = mul(P.ru, sc);
              t_sc = t;
              outcome = SCATTERED;
            }
          } else {
            // null collision
            V3 sn = v3(fmaxf(sigma_maj.x - sa_c.x - ss_c.x, 0.0f),
                       fmaxf(sigma_maj.y - sa_c.y - ss_c.y, 0.0f),
                       fmaxf(sigma_maj.z - sa_c.z - ss_c.z, 0.0f));
            float pdf_n = T_maj_h * sel(sn, P.hero);
            float inv = 1.0f / fmaxf(pdf_n, 1e-30f);
            P.beta = pdf_n == 0.f ? zero3
                                  : v3(P.beta.x * T_maj.x * sn.x * inv,
                                       P.beta.y * T_maj.y * sn.y * inv,
                                       P.beta.z * T_maj.z * sn.z * inv);
            P.ru = v3(P.ru.x * T_maj.x * sn.x * inv,
                      P.ru.y * T_maj.y * sn.y * inv,
                      P.ru.z * T_maj.z * sn.z * inv);
            P.rl = v3(P.rl.x * T_maj.x * sigma_maj.x * inv,
                      P.rl.y * T_maj.y * sigma_maj.y * inv,
                      P.rl.z * T_maj.z * sigma_maj.z * inv);
            if (max3(P.beta) == 0.f || max3(P.ru) == 0.f) {
              outcome = TERMINATED;
            } else {
              T_maj = one3;
              w.t_min = t;
            }
          }
        } else {
          V3 sn = v3(fmaxf(sigma_maj.x - dens * sa.x - dens * ss.x, 0.0f),
                     fmaxf(sigma_maj.y - dens * sa.y - dens * ss.y, 0.0f),
                     fmaxf(sigma_maj.z - dens * sa.z - dens * ss.z, 0.0f));
          float pdf = fmaxf(sel(T_maj, P.hero) * maj_h, 1e-30f);
          Tr = v3(Tr.x * T_maj.x * sn.x / pdf, Tr.y * T_maj.y * sn.y / pdf,
                  Tr.z * T_maj.z * sn.z / pdf);
          trl = v3(trl.x * T_maj.x * sigma_maj.x / pdf,
                   trl.y * T_maj.y * sigma_maj.y / pdf,
                   trl.z * T_maj.z * sigma_maj.z / pdf);
          tru = v3(tru.x * T_maj.x * sn.x / pdf, tru.y * T_maj.y * sn.y / pdf,
                   tru.z * T_maj.z * sn.z / pdf);
          // low-transmittance roulette (integrators.cpp:1404-1412)
          float den = fmaxf(avg3(v3(trl.x + tru.x, trl.y + tru.y,
                                    trl.z + tru.z)), 1e-30f);
          if (max3(v3(Tr.x / den, Tr.y / den, Tr.z / den)) < 0.05f)
            Tr = u.y < 0.75f ? zero3
                             : v3(Tr.x / 0.25f, Tr.y / 0.25f, Tr.z / 0.25f);
          done = max3(Tr) == 0.f;
          if (!done) {
            T_maj = one3;
            w.t_min = t;
          }
        }
      }
      n += 1;
      // at the walk's end (or max_collisions): the hero rescale
      const bool ended = done || n >= max_coll;
      if (shadow) {
        if (ended) {
          V3 sc = hero_scale(T_maj, P.hero);
          Tr = mul(Tr, sc);
          trl = mul(trl, sc);
          tru = mul(tru, sc);
          step = S_FOLD;
        }
      } else if (outcome != RAN) {
        step = S_EVENT;
      } else if (ended) {
        V3 sc = hero_scale(T_maj, P.hero);
        P.beta = mul(P.beta, sc);
        P.ru = mul(P.ru, sc);
        P.rl = mul(P.rl, sc);
        step = S_EVENT;
      }
    }

    const bool wait_event = gather_wait(S_EVENT);
    if (step == S_EVENT && !wait_event) {
      step = S_END;
      alive = outcome != TERMINATED;
      if (outcome == SCATTERED) {
        // the scatter vertex (kept in q_o for the phase bounce) and its
        // light sample
        q_o = v3(P.o.x + t_sc * P.d.x, P.o.y + t_sc * P.d.y,
                 P.o.z + t_sc * P.d.z);
        V3 wo = v3(-P.d.x, -P.d.y, -P.d.z);
        float4 un = uniform4(seed, pix, samp, P.dim);
        P.dim += 1;
        q_wi = light_pick(lc, has_point, has_env, q_o, un, &use_point, &q_dist,
                          &q_dist2);
        float f = hg_value(fc, dot(wo, q_wi));
        at_surf = false;
        step = S_BOUNCE;
        if (f > 0.f) {
          f_hat = v3(f, f, f);
          spdf = f;
          in_med = true;
          step = S_NEE;
        }
      } else if (alive && th.k >= 0) {
        // surface hit (with triangles): NEE with the BSDF, then BSDF
        // sampling
        if (P.depth >= max_depth) {
          alive = false;
        } else {
          P.depth += 1;
          const Hit h = surface_at(tab, smats, th, P);
          V3 wo = v3(-P.d.x, -P.d.y, -P.d.z);
          float4 un = uniform4(seed, pix, samp, P.dim);
          P.dim += 1;
          float off = (dot(h.ng, wo) >= 0.0f ? 1.0f : -1.0f) * 1e-4f * h.scl;
          q_o = v3(h.p.x + off * h.ng.x, h.p.y + off * h.ng.y,
                   h.p.z + off * h.ng.z);
          q_wi = light_pick(lc, has_point, has_env, q_o, un, &use_point,
                            &q_dist, &q_dist2);
          V3 wi_l = v3(dot(q_wi, h.t1), dot(q_wi, h.t2), dot(q_wi, h.ng));
          f_hat = scale(bsdf_f(h.m, h.wo_l, wi_l), fabsf(dot(q_wi, h.ng)));
          at_surf = true;
          step = S_BOUNCE;
          if (!is_specular(h.m) && max3(f_hat) > 0.f) {
            spdf = bsdf_pdf(h.m, h.wo_l, wi_l);
            in_med = med == 0;
            step = S_NEE;
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
    }

    const bool wait_nee = gather_wait(S_NEE);
    if (step == S_NEE && !wait_nee) {
      // Any triangle nearer than the light blocks (all are opaque); a lane
      // in the medium ratio-tracks the rest of the shadow ray to the box
      // exit
      const float seg = use_point ? q_dist : BIG;
      bool blocked = false;
      if constexpr (GEOM == GEOM_SWEEP)
        blocked = closest_tri(tab, n_tri, q_o, q_wi, seg).k >= 0;
      else if constexpr (GEOM == GEOM_BVH)
        blocked = bvh_hit<true>(nodes_g, tris_g, q_o, q_wi, seg).k >= 0;
      Tr = trl = tru = one3;
      step = S_FOLD;
      if (blocked) {
        P.L = add(P.L, zero3);
        step = S_BOUNCE;
      } else {
        float t_exit;
        bool ent;
        box_hit(fc, q_o, q_wi, &t_exit, &ent);
        if (in_med && max_coll > 0 &&
            dda_init(fc, G, q_o, q_wi, fminf(seg, t_exit), w)) {
          T_maj = one3;
          n = 0;
          shadow = true;
          step = S_WALK;
        }
      }
    }

    if (step == S_FOLD) {
      // the NEE contribution: f_hat is the BSDF or phase value (times the
      // cosine), spdf its sampling pdf for MIS against env hits
      V3 Le = use_point ? v3(lc.lI.x / q_dist2, lc.lI.y / q_dist2,
                             lc.lI.z / q_dist2)
                        : lc.env;
      float p_l = use_point ? lc.pmf : lc.penv;
      V3 r_l = v3(trl.x * P.ru.x * p_l, trl.y * P.ru.y * p_l,
                  trl.z * P.ru.z * p_l);
      V3 r_u = v3(tru.x * P.ru.x * spdf, tru.y * P.ru.y * spdf,
                  tru.z * P.ru.z * spdf);
      float denom = use_point ? avg3(r_l) : avg3(add(r_l, r_u));
      V3 c = zero3;
      if (denom > 0.f) {
        float dn = fmaxf(denom, 1e-30f);
        c = v3(P.beta.x * f_hat.x * Tr.x * Le.x / dn,
               P.beta.y * f_hat.y * Tr.y * Le.y / dn,
               P.beta.z * f_hat.z * Tr.z * Le.z / dn);
      }
      P.L = add(P.L, c);
      step = S_BOUNCE;
    }

    const bool wait_bounce = gather_wait(S_BOUNCE);
    if (step == S_BOUNCE && !wait_bounce) {
      step = S_END;
      if (!at_surf) {
        // phase sampling at the scatter vertex q_o, then volume roulette
        V3 wo = v3(-P.d.x, -P.d.y, -P.d.z);
        float4 uv = uniform4(seed, pix, samp, P.dim);
        P.dim += 1;
        float ppdf;
        V3 wi_p = sample_hg(fc, iso, wo, uv.x, uv.y, &ppdf);
        bool ok_phase = ppdf > 0.f;
        float pdf_c = fmaxf(ppdf, 1e-30f);
        P.rl = v3(P.ru.x / pdf_c, P.ru.y / pdf_c, P.ru.z / pdf_c);
        alive = ok_phase && roulette(rr_start, P, eta_scale, uv.z);
        P.o = q_o;
        P.d = wi_p;
        specular = false;
      } else {
        const Hit h = surface_at(tab, smats, th, P);
        float4 ub = uniform4(seed, pix, samp, P.dim);
        P.dim += 1;
        BSample bs = bsdf_sample(h.m, h.wo_l, ub.x, ub.y, ub.z);
        if (!(bs.valid && bs.pdf > 0.f)) {
          alive = false;
        } else {
          V3 wn = normalize_safe(v3(
              bs.wi.x * h.t1.x + bs.wi.y * h.t2.x + bs.wi.z * h.ng.x,
              bs.wi.x * h.t1.y + bs.wi.y * h.t2.y + bs.wi.z * h.ng.y,
              bs.wi.x * h.t1.z + bs.wi.y * h.t2.z + bs.wi.z * h.ng.z));
          float cw = fabsf(dot(wn, h.ng));
          float pdf_c = fmaxf(bs.pdf, 1e-30f);
          P.beta = v3(P.beta.x * (bs.f.x * cw / pdf_c),
                      P.beta.y * (bs.f.y * cw / pdf_c),
                      P.beta.z * (bs.f.z * cw / pdf_c));
          P.rl = v3(P.ru.x / pdf_c, P.ru.y / pdf_c, P.ru.z / pdf_c);
          specular = bs.specular;
          if (bs.transmission) eta_scale = eta_scale * bs.eta * bs.eta;
          // a reflection keeps its medium; a crossing adopts the far
          // side's label
          bool wi_front = dot(wn, h.ng) > 0.0f;
          if (wi_front != (dot(P.d, h.ng) < 0.0f))
            med = (int)(wi_front ? h.r[T_MED_OUT] : h.r[T_MED_IN]);
          float off_w = (dot(h.ng, wn) >= 0.0f ? 1.0f : -1.0f) * 1e-4f * h.scl;
          P.o = v3(h.p.x + off_w * h.ng.x, h.p.y + off_w * h.ng.y,
                   h.p.z + off_w * h.ng.z);
          P.d = wn;
          alive = max3(P.beta) != 0.f &&
                  roulette(rr_start, P, eta_scale, ub.w);
        }
      }
    }

    if (step == S_END) {
      if (!(isfinite(P.L.x) && isfinite(P.L.y) && isfinite(P.L.z)))
        P.L = zero3;
      ev += 1;
      step = alive && ev < max_events ? S_QUERY : S_DONE;
    }

    const bool wait_done = gather_wait(S_DONE);
    if (step == S_DONE && !wait_done) {
      lbuf[3 * item + 0] = P.L.x;
      lbuf[3 * item + 1] = P.L.y;
      lbuf[3 * item + 2] = P.L.z;
      item = (long long)atomicAdd(next_item, 1ull);
      if (item >= n_items) return;
      begin();
    }
  }
}

namespace {

// dynamic shared memory: the majorant grid, then the triangle table
// (GEOM_SWEEP) and the material table (with triangles)
template <int GEOM>
size_t grid_smem(int nmaj, int n_tri, int n_mat) {
  return (size_t)(nmaj + (GEOM == GEOM_SWEEP ? n_tri * TRI_COLS : 0) +
                  (GEOM != GEOM_NONE ? n_mat * MAT_COLS : 0)) *
         sizeof(float);
}

// the instantiation's grid: out4 = [resident blocks an SM (from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor at the first call's shared
// memory, then cached: registers bind it), SMs, registers a thread, local
// memory bytes a thread]
template <int GEOM>
cudaError_t grid_info(size_t smem, int* out4) {
  static int cache[3] = {0, 0, 0};
  return persistent_grid((const void*)volpath_grid_kernel<GEOM>, GRID_THREADS,
                         smem, cache, out4);
}

// One chunk of samples: the n_samp samples from samp0 of every pixel as
// npix * n_samp items on `blocks` persistent blocks (0: the SMs times the
// instantiation's resident blocks an SM).
template <int GEOM>
int grid_launch(const float* fconst, const int* iconst, const float* density,
                const float* majorant, const float* tris, const float* nodes,
                const float* mats, float* lbuf,
                unsigned long long* next_item, int npix, int samp0,
                int n_samp, unsigned int seed, int nmaj, int n_tri,
                int n_mat, int blocks, void* stream) {
  if (npix < 1 || n_samp < 1 || samp0 < 0 || blocks < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = grid_smem<GEOM>(nmaj, n_tri, n_mat);
  if (blocks == 0) {
    int g[4];
    cudaError_t e = grid_info<GEOM>(smem, g);
    if (e != cudaSuccess) return (int)e;
    blocks = g[0] * g[1];
  }
  volpath_grid_kernel<GEOM><<<blocks, GRID_THREADS, smem,
                              (cudaStream_t)stream>>>(
      fconst, iconst, density, majorant, tris, nodes, mats, lbuf, next_item,
      npix, samp0, (long long)npix * n_samp, seed, nmaj, n_tri, n_mat);
  return (int)cudaGetLastError();
}

}  // namespace
