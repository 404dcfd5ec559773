// B1: volumetric path tracing of one box of homogeneous fog, in work items
// of one pixel and a group of its samples on persistent blocks.
//
// Replaces pallas_volpath._make_kernel (vspg_pbrt_v4_tpu/ops/
// pallas_volpath.py), the TPU megakernel behind render_homog_pallas. Per
// sample: pinhole ray, box entry/exit, closed-form collision, point + env
// NEE with analytic transmittance, HG phase sampling, escaped-ray env MIS
// and the hero-channel rescaled pdfs. The random stream is the Pallas
// kernel's exactly: dimension 0 for the camera, then three uniform4
// dimensions per path event (collision/absorb/light-select/env-z, then
// env-phi/phase-u0, then phase-u1), so a pixel's samples match the plain
// versions ops/volpath_kernels.render_homog_plain (per pixel) and
// render_homog_items_plain (per sample) and the Pallas kernel. The Pallas
// kernel caps the iterations of a whole block at spp * max_events; here
// each sample runs at most max_events events, and a sample cut by the cap
// still commits its radiance.
//
// What bounds it on the H100: dependent transcendental math (exp, log1p,
// sqrt, sin/cos; about 20 per event, 3.9 events a path at the bench fog)
// and the integer hashing of three uniform4 draws an event, with almost no
// memory traffic. The first design ran one thread a pixel over all its
// samples: 65,536 threads at 256^2, about 496 an SM at 116 registers, four
// warps a scheduler, too few to hide that latency.
//
// Work layout: a work item is one pixel and a group of `group` consecutive
// samples of a chunk (the last group shorter), item = group index * npix +
// pixel. A thread runs the group's samples in sample order, each sample's
// events in a loop of their own, and writes their sum, from zero, to a
// (groups, npix, 3) scratch, which vspg_kernels.reduce_samples
// (vspg_reduce_kernel, csrc/vspg.cu) adds per pixel in group order and
// scales; so the image is deterministic, and with group == spp it is the
// per-pixel loop's sum. Every path state lives in registers and the
// constants in shared memory. SMs x B persistent blocks of 128 threads, B
// from cudaOccupancyMaxActiveBlocksPerMultiprocessor under
// __launch_bounds__(128, VOLPATH_HOMOG_MIN_BLOCKS); the lanes of a warp
// that ask together take consecutive items with one atomicAdd on a zeroed
// counter (take_items, common.cuh). The wrapper picks the group by
// ops/volpath_kernels.group_size: as many samples as leave 8 items a
// resident thread, 3 at 256^2 x 64 and 16 at 1920x1088x16.
//
// Shipped: VOLPATH_HOMOG_MIN_BLOCKS 8 (64 registers, 316 bytes of spill
// stores), chosen with the group rule by `python -m
// vspg_pbrt_v4_tpu_torch.benchmarks.group_items --sweep` on an NVIDIA H100
// 80GB HBM3 at 700 W: at 256^2 x 64, 0.814 ms with the rule's groups of 3
// against 0.864 at 4 blocks an SM (128 registers, no spills) and 0.818 at
// 6 (80 registers) with their rules' groups of 7 and 5; the sweep's best,
// 0.813 at 6 with groups of 3, is within the spread between turns. At
// 1920x1088x16, 3.487 ms with groups of 16. One thread a pixel took
// 0.944-0.951 and 3.883-3.916 ms in the same call (`--turns`; PERF.md
// section 6). A static stride instead of the counter, and one flat loop of
// events across samples, ran no faster on that card and are not kept.
#ifndef VOLPATH_HOMOG_MIN_BLOCKS
#define VOLPATH_HOMOG_MIN_BLOCKS 8
#endif
#include "common.cuh"

using namespace vp;

namespace {

constexpr int HOMOG_THREADS = 128;

// one path's state
struct HPath {
  V3 o, d, beta, ru, rl, L;
  uint32_t dim;
  int depth, med, hero;
};

// a fresh camera path of sample `samp` of pixel `pix`
static __device__ __forceinline__ void homog_start(const float* fc,
                                                   const int* ic,
                                                   uint32_t seed, uint32_t pix,
                                                   uint32_t samp, HPath& P) {
  start_path(fc, ic[I_NX], seed, pix, samp, &P.o, &P.d, &P.hero);
  P.dim = 1;
  P.beta = P.ru = P.rl = v3(1.f, 1.f, 1.f);
  P.L = v3(0.f, 0.f, 0.f);
  P.depth = 0;
  P.med = -1;
}

// One event of the path P of sample `samp` of pixel `pix`; returns whether
// the path goes on.
static __device__ __forceinline__ bool homog_event(const float* fc,
                                                   const int* ic,
                                                   uint32_t seed, uint32_t pix,
                                                   uint32_t samp, HPath& P) {
  const bool has_point = ic[I_HAS_POINT] != 0;
  const bool has_env = ic[I_HAS_ENV] != 0;
  const bool iso = ic[I_HG_ISO] != 0;
  const int max_depth = ic[I_MAX_DEPTH];
  const V3 sa = v3(fc + F_SA), ss = v3(fc + F_SS), st = v3(fc + F_ST);
  const V3 lp = v3(fc + F_LP), lI = v3(fc + F_LI), envL = v3(fc + F_ENV);
  const float pmf = fc[F_PMF], penv = fc[F_PENV];
  const float st_h = sel(st, P.hero), sa_h = sel(sa, P.hero),
              ss_h = sel(ss, P.hero);
  V3 o = P.o, d = P.d, beta = P.beta, ru = P.ru, rl = P.rl, L = P.L;
  const uint32_t dim = P.dim;

  float t_wall;
  bool entering;
  bool hit = box_hit(fc, o, d, &t_wall, &entering);
  bool in_med = P.med == 0;
  float seg = hit ? t_wall : BIG;

  float4 u = uniform4(seed, pix, samp, dim);
  float4 un = uniform4(seed, pix, samp, dim + 1);
  float u_ph = uniform4(seed, pix, samp, dim + 2).x;
  P.dim = dim + 3;
  float t_coll = -log1pf(-u.x) / fmaxf(st_h, 1e-30f);
  t_coll = st_h > 0.f ? t_coll : BIG;
  bool coll = in_med && (t_coll < seg);
  if (in_med && !coll) {
    // ran to the wall: spectral rescale exp(-seg (sigma - sigma_h))
    float segc = fminf(seg, BIG);
    V3 Te = exp_neg(st, segc);
    float Te_h = fmaxf(expf(-st_h * segc), 1e-30f);
    V3 se = v3(Te.x / Te_h, Te.y / Te_h, Te.z / Te_h);
    beta = mul(beta, se);
    ru = mul(ru, se);
    rl = mul(rl, se);
  }
  bool alive = true, scat = false;
  if (coll) {
    bool is_absorb = u.y < sa_h / fmaxf(st_h, 1e-30f);
    if (is_absorb || P.depth >= max_depth) {
      alive = false;
    } else {
      scat = true;
      P.depth += 1;
      V3 Tm = exp_neg(st, t_coll);
      float Tm_h = fmaxf(expf(-st_h * t_coll), 1e-30f);
      float pdf_s = fmaxf(Tm_h * ss_h, 1e-30f);
      V3 sc = v3(Tm.x * ss.x / pdf_s, Tm.y * ss.y / pdf_s,
                 Tm.z * ss.z / pdf_s);
      beta = mul(beta, sc);
      ru = mul(ru, sc);
    }
  }
  if (scat) {
    V3 sp = v3(o.x + t_coll * d.x, o.y + t_coll * d.y, o.z + t_coll * d.z);
    V3 wo = v3(-d.x, -d.y, -d.z);
    // NEE from the point light (analytic transmittance to the wall)
    if (has_point && (!has_env || u.z < pmf)) {
      V3 pl = v3(sp.x - lp.x, sp.y - lp.y, sp.z - lp.z);
      float dist2 = fmaxf(dot(pl, pl), 1e-12f);
      float dist = sqrtf(dist2);
      float inv_dist = 1.0f / dist;
      V3 wi = v3(-pl.x * inv_dist, -pl.y * inv_dist, -pl.z * inv_dist);
      float f = hg_value(fc, dot(wo, wi));
      float t_exit;
      bool ent;
      box_hit(fc, sp, wi, &t_exit, &ent);
      V3 Tr = exp_neg(st, fminf(dist, t_exit));
      float denom = fmaxf(avg3(scale(ru, pmf)), 1e-30f);
      if (f > 0.f) {
        float w = f / (dist2 * denom);
        L = v3(L.x + beta.x * Tr.x * lI.x * w, L.y + beta.y * Tr.y * lI.y * w,
               L.z + beta.z * Tr.z * lI.z * w);
      }
    }
    // NEE from the environment (uniform sphere)
    if (has_env && (!has_point || u.z >= pmf)) {
      float ez = 1.0f - 2.0f * u.w;
      float er = sqrtf(fmaxf(1.0f - ez * ez, 0.0f));
      float ephi = fc[F_TWO_PI] * un.x;
      V3 wi = v3(er * cosf(ephi), er * sinf(ephi), ez);
      float f = hg_value(fc, dot(wo, wi));
      float t_exit;
      bool ent;
      box_hit(fc, sp, wi, &t_exit, &ent);
      V3 Tr = exp_neg(st, fminf(t_exit, BIG));
      float denom = fmaxf(avg3(v3(ru.x * penv + ru.x * f,
                                  ru.y * penv + ru.y * f,
                                  ru.z * penv + ru.z * f)),
                          1e-30f);
      if (f > 0.f) {
        float w = f / denom;
        L = v3(L.x + beta.x * Tr.x * envL.x * w,
               L.y + beta.y * Tr.y * envL.y * w,
               L.z + beta.z * Tr.z * envL.z * w);
      }
    }
    float ppdf;
    V3 pw = sample_hg(fc, iso, wo, un.y, u_ph, &ppdf);
    if (ppdf <= 0.f) alive = false;
    float inv_ppdf = 1.0f / fmaxf(ppdf, 1e-30f);
    rl = scale(ru, inv_ppdf);
    o = sp;
    d = pw;
  } else if (alive && !coll) {
    if (!hit) {
      // escaped: environment with MIS against the env NEE
      if (has_env) {
        if (P.depth == 0) {
          float ru_avg = fmaxf(avg3(ru), 1e-30f);
          L = v3(L.x + beta.x * envL.x / ru_avg,
                 L.y + beta.y * envL.y / ru_avg,
                 L.z + beta.z * envL.z / ru_avg);
        } else {
          float den = fmaxf(avg3(v3(ru.x + rl.x * penv,
                                    ru.y + rl.y * penv,
                                    ru.z + rl.z * penv)),
                            1e-30f);
          L = v3(L.x + beta.x * envL.x / den,
                 L.y + beta.y * envL.y / den,
                 L.z + beta.z * envL.z / den);
        }
      }
      alive = false;
    } else {
      // interface: cross the box wall
      P.med = entering ? 0 : -1;
      float tt = t_wall + 1e-4f;
      o = v3(o.x + tt * d.x, o.y + tt * d.y, o.z + tt * d.z);
    }
  }
  // NaN/Inf scrub (RayIntegrator, integrators.cpp:308)
  if (!(isfinite(L.x) && isfinite(L.y) && isfinite(L.z)))
    L = v3(0.f, 0.f, 0.f);
  P.o = o;
  P.d = d;
  P.beta = beta;
  P.ru = ru;
  P.rl = rl;
  P.L = L;
  return alive;
}

// the radiance of sample `samp` of pixel `pix`, unscaled: at most
// max_events events, and a sample cut by the cap commits what it gathered
static __device__ __forceinline__ V3 homog_path(const float* fc,
                                                const int* ic, uint32_t seed,
                                                uint32_t pix, uint32_t samp) {
  HPath P;
  homog_start(fc, ic, seed, pix, samp, P);
  for (int ev = 0; ev < ic[I_MAX_EVENTS]; ++ev)
    if (!homog_event(fc, ic, seed, pix, samp, P)) break;
  return P.L;
}

// Samples samp0, ..., samp0 + n_samp - 1 of every pixel as npix *
// ceil(n_samp / group) items; gbuf[item] = the sum of the item's samples.
__global__ void __launch_bounds__(HOMOG_THREADS, VOLPATH_HOMOG_MIN_BLOCKS)
    volpath_homog_kernel(const float* __restrict__ fc_g,
                         const int* __restrict__ ic_g,
                         float* __restrict__ gbuf,
                         unsigned long long* __restrict__ next_item, int npix,
                         int samp0, int n_samp, int group, uint32_t seed) {
  __shared__ float fc[N_FCONST];
  __shared__ int ic[N_ICONST];
  load_consts(fc_g, ic_g, fc, ic);
  __syncthreads();
  const long long n_items =
      (long long)npix * ((n_samp + group - 1) / group);
  for (long long item = take_items(next_item); item < n_items;
       item = take_items(next_item)) {
    const int g = (int)(item / npix);
    const uint32_t pix = (uint32_t)(item - (long long)g * npix);
    const int s0 = samp0 + g * group;
    const int s1 = min(s0 + group, samp0 + n_samp);
    V3 acc = v3(0.f, 0.f, 0.f);
    for (int s = s0; s < s1; ++s) {
      const V3 L = homog_path(fc, ic, seed, pix, (uint32_t)s);
      acc = v3(acc.x + L.x, acc.y + L.y, acc.z + L.z);
    }
    gbuf[3 * item + 0] = acc.x;
    gbuf[3 * item + 1] = acc.y;
    gbuf[3 * item + 2] = acc.z;
  }
}

int g_cache[3] = {0, 0, 0};

}  // namespace

// the persistent grid: out4 = [resident blocks an SM, SMs, registers a
// thread, local memory bytes a thread]
extern "C" int volpath_homog_info(int* out4) {
  return (int)persistent_grid((const void*)volpath_homog_kernel,
                              HOMOG_THREADS, 0, g_cache, out4);
}

// One chunk of samples in groups of `group` on `blocks` persistent blocks,
// its items taken from *next_item (zeroed by the caller).
extern "C" int volpath_homog_launch(const float* fconst, const int* iconst,
                                    float* gbuf,
                                    unsigned long long* next_item, int npix,
                                    int samp0, int n_samp, int group,
                                    unsigned int seed, int blocks,
                                    void* stream) {
  if (npix < 1 || n_samp < 1 || samp0 < 0 || group < 1 || blocks < 1 ||
      next_item == nullptr)
    return (int)cudaErrorInvalidValue;
  volpath_homog_kernel<<<blocks, HOMOG_THREADS, 0, (cudaStream_t)stream>>>(
      fconst, iconst, gbuf, next_item, npix, samp0, n_samp, group, seed);
  return (int)cudaGetLastError();
}
