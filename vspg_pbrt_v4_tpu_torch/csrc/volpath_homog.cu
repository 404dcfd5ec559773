// B1: persistent volumetric path tracing of one box of homogeneous fog.
//
// Replaces pallas_volpath._make_kernel (vspg_pbrt_v4_tpu/ops/
// pallas_volpath.py), the TPU megakernel behind render_homog_pallas. Per
// sample: pinhole ray, box entry/exit, closed-form collision, point + env
// NEE with analytic transmittance, HG phase sampling, escaped-ray env MIS
// and the hero-channel rescaled pdfs. The random stream is the Pallas
// kernel's exactly: dimension 0 for the camera, then three uniform4
// dimensions per path event (collision/absorb/light-select/env-z, then
// env-phi/phase-u0, then phase-u1), so a pixel's samples match the plain
// version ops/volpath_kernels.render_homog_plain and the Pallas kernel.
//
// What bounds it on the H100: transcendental math (exp, log1p, sqrt,
// sin/cos; about 20 per event) with almost no memory traffic, 12 bytes
// written per pixel. The design keeps all state in registers and the
// scene constants in shared memory; one thread renders all samples of one
// pixel. There is no lockstep and no lane regeneration, which the TPU
// needed for its vector lanes. The Pallas kernel caps the iterations of a
// whole block at spp * max_events; here each sample runs at most
// max_events events, and a sample cut by the cap still commits its
// radiance.
#include "common.cuh"

using namespace vp;

__global__ void __launch_bounds__(128)
    volpath_homog_kernel(const float* __restrict__ fc_g,
                         const int* __restrict__ ic_g, float* __restrict__ out,
                         int npix, int spp, uint32_t seed, float out_scale) {
  __shared__ float fc[N_FCONST];
  __shared__ int ic[N_ICONST];
  load_consts(fc_g, ic_g, fc, ic);
  __syncthreads();
  int pix_i = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix_i >= npix) return;
  const uint32_t pix = (uint32_t)pix_i;
  const bool has_point = ic[I_HAS_POINT] != 0;
  const bool has_env = ic[I_HAS_ENV] != 0;
  const bool iso = ic[I_HG_ISO] != 0;
  const int max_depth = ic[I_MAX_DEPTH];
  const int max_events = ic[I_MAX_EVENTS];
  const V3 sa = v3(fc + F_SA), ss = v3(fc + F_SS), st = v3(fc + F_ST);
  const V3 lp = v3(fc + F_LP), lI = v3(fc + F_LI), envL = v3(fc + F_ENV);
  const float pmf = fc[F_PMF], penv = fc[F_PENV];

  V3 acc = v3(0.f, 0.f, 0.f);
  for (int s = 0; s < spp; ++s) {
    const uint32_t samp = (uint32_t)s;
    V3 o, d;
    int hero;
    start_path(fc, ic[I_NX], seed, pix, samp, &o, &d, &hero);
    uint32_t dim = 1;
    V3 beta = v3(1.f, 1.f, 1.f), ru = beta, rl = beta;
    V3 L = v3(0.f, 0.f, 0.f);
    int depth = 0, med = -1;
    const float st_h = sel(st, hero), sa_h = sel(sa, hero),
                ss_h = sel(ss, hero);
    for (int ev = 0; ev < max_events; ++ev) {
      float t_wall;
      bool entering;
      bool hit = box_hit(fc, o, d, &t_wall, &entering);
      bool in_med = med == 0;
      float seg = hit ? t_wall : BIG;

      float4 u = uniform4(seed, pix, samp, dim);
      float4 un = uniform4(seed, pix, samp, dim + 1);
      float u_ph = uniform4(seed, pix, samp, dim + 2).x;
      dim += 3;
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
        if (is_absorb || depth >= max_depth) {
          alive = false;
        } else {
          scat = true;
          depth += 1;
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
            if (depth == 0) {
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
          med = entering ? 0 : -1;
          float tt = t_wall + 1e-4f;
          o = v3(o.x + tt * d.x, o.y + tt * d.y, o.z + tt * d.z);
        }
      }
      // NaN/Inf scrub (RayIntegrator, integrators.cpp:308)
      if (!(isfinite(L.x) && isfinite(L.y) && isfinite(L.z)))
        L = v3(0.f, 0.f, 0.f);
      if (!alive) break;
    }
    acc = v3(acc.x + L.x, acc.y + L.y, acc.z + L.z);
  }
  out[3 * pix_i + 0] = acc.x * out_scale;
  out[3 * pix_i + 1] = acc.y * out_scale;
  out[3 * pix_i + 2] = acc.z * out_scale;
}

extern "C" int volpath_homog_launch(const float* fconst, const int* iconst,
                                    float* out, int npix, int spp,
                                    unsigned int seed, float out_scale,
                                    void* stream) {
  const int threads = 128;
  const int blocks = (npix + threads - 1) / threads;
  volpath_homog_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      fconst, iconst, out, npix, spp, seed, out_scale);
  return (int)cudaGetLastError();
}
