// B3a-d + B4a-d: the VSPG megakernel, frozen-field render and
// training-wave record variants, for one density grid in a box and the
// three distance routes of guided walks: resampling (B3a/B4a), NDS and
// NDS+ (B3b/B4b); the TRIS instantiations add at most 64 flat triangles of
// the teaser materials inside the cloud (B3c/B4c); every instantiation
// reads a uniform or an adaptive guiding field (B3d/B4d, below).
//
// Replaces pallas_vspg._make_vspg_kernel (vspg_pbrt_v4_tpu/ops/
// pallas_vspg.py) with record=False (B3) and record=True (B4), for
// sampling_method "resampling", "nds" and "nds+". A thread runs the
// Pallas kernel's per-lane state machine on one (pixel, sample) path at a
// time: per iteration one event of its path (mode 0 transport, 2
// reservoir-resampling walk, 3 delta walk, 4/5 ratio-tracked shadow walk
// toward the point light / environment; under NDS 1 the majorant
// optical-depth prepass and 2 the ODS walk), the same eight uniform4 draws in
// the same order, each path from the same fresh state. So it agrees per
// pixel with ops/vspg_kernels.render_vspg_plain / train_wave_plain, which
// agree per pixel with the interpret-mode Pallas kernel where bf16 rounds
// nothing. The block-wide sharing of the Pallas kernel (one field query
// and one majorant step per iteration for disjoint lane sets) becomes
// per-thread branches: a thread queries the field only at a scatter or a
// walk start.
//
// What bounds it on the H100: dependent loads and divergence. Each walk
// step of a thread is one iteration with a majorant read (shared memory)
// and an eight-corner density read (float32 grid, 1 MB at 64^3, read
// through the read-only cache), and a scatter adds a field-table column
// read (40 floats of an 80 KB float32 table) and the vMF mixture math of
// four lobes; the threads of a warp sit in different modes and take
// different numbers of iterations. Registers hold the ~80-value lane state
// and the lobes (204-255 a thread with no minimum of blocks), so few warps
// are resident. The design keeps the whole path in registers (no
// device-memory traffic but the reads above, the radiance and the record
// rows) and leaves the TPU's bf16 tables, one-hot MXU gathers, chunk
// sweeps, stochastic trilerp and tiled lane map out.
//
// The render variant's work: one thread a pixel walking all spp samples in
// turn left B3c (128^2) 128 blocks of 4 warps on 132 SMs and a tail of 64
// serial samples. So a work item is one (pixel, sample), N = npix * spp of
// them, sample-major (a warp's lanes start on 32 neighbouring pixels of
// one sample), on SMs x B persistent blocks, B the instantiation's resident
// blocks an SM at its register budget (VSPG_RENDER_MIN_BLOCKS below); a
// lane whose path ends takes the next item from a 64-bit device counter.
// Each item writes its radiance to a (samples, npix, 3) scratch, and
// vspg_reduce_kernel adds a pixel's samples in sample order, acc = acc +
// L[s] from zero, then scales, the per-pixel loop's order and rounding.
// Every item has the whole pixel's iteration cap (spp * max_events * 12),
// so no sample stops before the per-pixel loop would have stopped it, and
// writes its iteration count beside its radiance; the reduce adds a
// sample only while the pixel's running count stays within the cap, as
// the per-pixel loop, which loses the sample its cap cuts and every later
// one. So the image is the same float for float. An item at the cap counts
// itself. Walks that start within 1e-4 of the box's exit, where box_hit
// reports no face, end at the exit (box_exit, as the XLA path's clip to
// the grid's bounds): with a limit of BIG they stepped on through the
// clamped majorant cells beyond the box, in series to the pixel's cap
// (ROADMAP.md section C 4).
//
// The record variant's work: one thread a pixel on (npix + 127) / 128
// blocks held each SM slot until the block's slowest lane ended, and with
// no register budget few blocks fit an SM. So its items, the pixels (spp
// 1: its RNG stream, record rows and layout are the per-pixel kernel's),
// run on SMs x B persistent blocks at its own budget
// (MinBlocks below), the lanes of a warp that end together
// taking the next pixels with one atomicAdd on a 64-bit counter. A wave
// of one sample a pixel is still as long as its longest path, whose
// iterations run in series (PERF.md): no schedule of the pixels shortens
// that.
//
// NDS and NDS+ are template switches: the ODS walk keeps its state in the
// reservoir's registers, as the Pallas kernel aliases its carries (c_t the
// candidate's remaining optical depth, -1 to draw one, BIG to pass; wT.x /
// wT.y the running t_v / t_n, tau_acc / c_ste their totals; cn the
// per-channel truncation renormalisations; c_wi the defensive-lane flag;
// w_sum the NDS+ bias exponent), so the NDS instantiations hold no more
// live state than the resampling ones. A prepass step reads the majorant
// only. NDS+ reads its TrBuffer entry from ISGB rows 3-5 once per walk.
//
// TRIS is a template switch too (the teaser class). The triangle and
// material tables ride in shared memory. A lane sweeps the triangles when
// its path ray changed or its shadow walk starts (and stalls that
// iteration); walks stop at the nearer of the wall and the next surface.
// At a surface: the diffuse lobe with the guided BSDF of the field's
// surface half (one-sample MIS or RIS over cosine x the cosine-product
// mixture), the Trowbridge-Reitz glossy lobes sampled unguided, the mirror
// and the Fresnel pick of the dielectric (with its medium switch); a
// non-delta surface shares the light sample of the iteration, and its NEE
// folds at the end of the shadow walk as a volume NEE does; guided RR from
// the surface half's flux; record rows at non-delta surface vertices. Two
// faults of the Pallas kernel are not carried (ROADMAP.md §C): a surface
// NEE walk starts from unit transmittance, and a glossy surface's light
// sample is taken at the surface.
//
// The adaptive field (B3d/B4d: pallas_vspg._make_vspg_kernel with
// n_extra > 0) is a runtime switch of the guiding table (GI_NEXTRA), not a
// template parameter: it is uniform across a launch and adds one
// dependent load to a field query. The field table is (P, L) over the L
// leaves; a query reads its coarse cell's refined flag from the (3, C)
// int32 indirection table [leaf_of, child_base, refined], then either
// child_base + the octant of the clamped grid coordinate or leaf_of, and
// reads that leaf's column, whose centre re-aims the lobes. The TPU
// kernel's bf16 hi/lo split of those integers is not carried.
#include "common.cuh"
#include "vspg.cuh"

using namespace vp;

namespace {

constexpr int KMAX = 4;
constexpr float MIN_KAPPA = 1e-2f;
constexpr float MAX_KAPPA = 2e3f;
constexpr float INV_4PI_F = 0.0795774715459476679f;
// float32(1 - 1e-7), the Pallas kernel's clip of truncated-exponential CDFs
constexpr float ONE_M_1E7 = 0.99999988079071044921875f;

struct Lobes {
  float w[KMAX];
  V3 mu[KMAX];
  float kappa[KMAX];
  float vlv[KMAX], vls[KMAX];  // directional VSP moments
};

struct Tables {
  const float* __restrict__ density;
  const float* maj;  // shared memory
  const float* __restrict__ ftab;  // (P, nleaf)
  int gx, gy, gz, mx, my, mz, fres, ncell, K;
  // the adaptive field: (3, ncell) indirection, nullptr on a uniform field
  const int* __restrict__ cells;
  int nleaf;
};

static __device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ---- vMF mixtures (pallas_vspg._make_vspg_kernel, in its op order) -------

static __device__ __forceinline__ float vmf_pdf_e(const float* fc, float cw,
                                                  float kappa) {
  float k = fmaxf(kappa, MIN_KAPPA);
  float cnorm = k / (fc[F_TWO_PI] * (1.0f - expf(-2.0f * k)));
  float val = cnorm * expf(k * (cw - 1.0f));
  return kappa < MIN_KAPPA ? INV_4PI_F : val;
}

static __device__ __forceinline__ float log_c(const float* gc, float kappa) {
  float k = fmaxf(kappa, MIN_KAPPA);
  return logf(k) - gc[G_LOG_2PI] - log1pf(-expf(-2.0f * k));
}

static __device__ float mixture_pdf(const float* fc, const Lobes& lb, int K,
                                    V3 w) {
  float p = 0.0f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    float cw = w.x * lb.mu[k].x + w.y * lb.mu[k].y + w.z * lb.mu[k].z;
    p = p + lb.w[k] * vmf_pdf_e(fc, cw, lb.kappa[k]);
  }
  return p;
}

// every lobe times one vMF about mb with kappa kb (vmf.product_with_vmf)
static __device__ Lobes product_vmf(const float* gc, const Lobes& lb, int K,
                                    V3 mb, float kb, float log_c_b) {
  Lobes out = lb;
  float tot_old = 0.0f, tot_new = 0.0f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    float kap = lb.kappa[k];
    V3 kmu = v3(kap * lb.mu[k].x + kb * mb.x, kap * lb.mu[k].y + kb * mb.y,
                kap * lb.mu[k].z + kb * mb.z);
    float k_new =
        sqrtf(fmaxf(kmu.x * kmu.x + kmu.y * kmu.y + kmu.z * kmu.z, 1e-12f));
    float inv = 1.0f / fmaxf(k_new, 1e-8f);
    float log_s = log_c(gc, kap) + log_c_b - log_c(gc, k_new) +
                  (k_new - kap - kb);
    float w_new = lb.w[k] * expf(clampf(log_s, -60.0f, 60.0f));
    tot_old = tot_old + lb.w[k];
    tot_new = tot_new + w_new;
    out.w[k] = w_new;
    out.mu[k] = scale(kmu, inv);
    out.kappa[k] = clampf(k_new, 0.0f, MAX_KAPPA);
  }
  float sc = tot_old / fmaxf(tot_new, 1e-20f);
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    out.w[k] = out.w[k] * sc;
  }
  return out;
}

// every lobe times the vMF of the HG lobe about d
static __device__ Lobes product_hg(const float* gc, const Lobes& lb, int K,
                                   V3 d) {
  const float sg = gc[G_HG_SIGN];
  return product_vmf(gc, lb, K, v3(d.x * sg, d.y * sg, d.z * sg),
                     gc[G_KAPPA_H], gc[G_LOG_C_H]);
}

// CDF lobe select + vMF sample (vmf.mixture_sample); *pdf = mixture pdf
static __device__ V3 mixture_sample(const float* fc, const Lobes& lb, int K,
                                    float u_sel, float u0, float u1,
                                    float* pdf) {
  float tot = 0.0f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    tot = tot + lb.w[k];
  }
  float inv_tot = 1.0f / fmaxf(tot, 1e-12f);
  float cdf = 0.0f;
  int k_idx = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    cdf = cdf + lb.w[k] * inv_tot;
    k_idx += u_sel >= cdf ? 1 : 0;
  }
  k_idx = min(max(k_idx, 0), K - 1);
  V3 mu = lb.mu[0];
  float kap = lb.kappa[0];
#pragma unroll
  for (int k = 1; k < KMAX; ++k) {
    if (k == k_idx) {
      mu = lb.mu[k];
      kap = lb.kappa[k];
    }
  }
  float sk = fmaxf(kap, MIN_KAPPA);
  float ct = 1.0f + log1pf(-(1.0f - expf(-2.0f * sk)) * (1.0f - u0)) / sk;
  ct = kap < MIN_KAPPA ? 1.0f - 2.0f * u0 : ct;
  ct = clampf(ct, -1.0f, 1.0f);
  float st = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  float phi = fc[F_TWO_PI] * u1;
  float sign = mu.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + mu.z);
  float b = mu.x * mu.y * a;
  V3 t1 = v3(1.0f + sign * mu.x * mu.x * a, sign * b, -sign * mu.x);
  V3 t2 = v3(b, sign + mu.y * mu.y * a, -mu.y);
  float sc = st * cosf(phi), ss = st * sinf(phi);
  V3 w = normalize(v3(sc * t1.x + ss * t2.x + ct * mu.x,
                      sc * t1.y + ss * t2.y + ct * mu.y,
                      sc * t1.z + ss * t2.z + ct * mu.z));
  *pdf = mixture_pdf(fc, lb, K, w);
  return w;
}

// directional VSP: the lobes' VSP moments blended by the posterior at d
static __device__ float vsp_directional(const float* fc, const Lobes& lb,
                                        int K, float vsp_cell, V3 d) {
  float resp_sum = 0.0f, num = 0.0f, den = 0.0f, mass = 0.0f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    float cw = d.x * lb.mu[k].x + d.y * lb.mu[k].y + d.z * lb.mu[k].z;
    float r = lb.w[k] * vmf_pdf_e(fc, cw, lb.kappa[k]);
    resp_sum = resp_sum + r;
    num = num + r * lb.vlv[k];
    den = den + r * (lb.vlv[k] + lb.vls[k]);
    mass = mass + lb.vlv[k] + lb.vls[k];
  }
  float inv = 1.0f / fmaxf(resp_sum, 1e-20f);
  num = num * inv;
  den = den * inv;
  float vdir = den > 1e-12f ? num / fmaxf(den, 1e-20f) : -1.0f;
  return (mass > 8.0f && vdir >= 0.0f) ? vdir : vsp_cell;
}

// the field leaf at p: lobes (mu renormalized, parallax re-aimed), valid,
// leaf VSP and flux, of the half whose rows start at `base`; on an adaptive
// field the coarse cell resolves to its leaf first
static __device__ void field_query(const float* gc, const Tables& T, V3 p,
                                   Lobes* lb, bool* valid, float* vsp_cell,
                                   V3* flux, int base = 0) {
  const int fres = T.fres;
  const float pc[3] = {p.x, p.y, p.z};
  int ix[3];
  float gf[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gf[k] = clampf((pc[k] - gc[G_FB0 + k]) / gc[G_FEXT + k] * (float)fres,
                   0.0f, gc[G_FRES_HI]);
    ix[k] = (int)gf[k];
  }
  int cid = (ix[0] * fres + ix[1]) * fres + ix[2];
  if (T.cells != nullptr) {
    if (__ldg(T.cells + 2 * T.ncell + cid) != 0) {
      const int octant = (gf[0] - (float)ix[0] >= 0.5f ? 4 : 0) +
                         (gf[1] - (float)ix[1] >= 0.5f ? 2 : 0) +
                         (gf[2] - (float)ix[2] >= 0.5f ? 1 : 0);
      cid = __ldg(T.cells + T.ncell + cid) + octant;
    } else {
      cid = __ldg(T.cells + cid);
    }
  }
  const float* col = T.ftab + cid + (size_t)base * T.nleaf;
  const int n = T.nleaf, K = T.K;
  auto row = [&](int r) { return __ldg(col + (size_t)r * n); };
  *valid = row(8 * K) > 0.5f;
  *vsp_cell = row(8 * K + 1);
  *flux = v3(row(8 * K + 2), row(8 * K + 3), row(8 * K + 4));
  V3 cc = v3(row(8 * K + 5), row(8 * K + 6), row(8 * K + 7));
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (k >= K) break;
    lb->w[k] = row(8 * k);
    V3 mu = normalize(v3(row(8 * k + 1), row(8 * k + 2), row(8 * k + 3)));
    lb->kappa[k] = row(8 * k + 4);
    float dist = row(8 * k + 5);
    lb->vlv[k] = row(8 * k + 6);
    lb->vls[k] = row(8 * k + 7);
    V3 tgt = v3(cc.x + mu.x * dist - p.x, cc.y + mu.y * dist - p.y,
                cc.z + mu.z * dist - p.z);
    lb->mu[k] = (dist > 1e-6f && *valid) ? normalize(tgt) : mu;
  }
}

// ---- medium -----------------------------------------------------------------

// exact trilinear density, the eight corners summed in the Pallas kernel's
// order, zero outside the box
static __device__ float density8(const float* fc, const float* gc,
                                 const Tables& T, V3 p) {
  if (outside_box(fc, p)) return 0.0f;
  const float pc[3] = {p.x, p.y, p.z};
  const int n[3] = {T.gx, T.gy, T.gz};
  int i0[3], i1[3];
  float w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float f = (pc[k] - fc[F_BMIN + k]) / gc[G_EXT + k] * (float)n[k] - 0.5f;
    float f0 = floorf(f);
    w[k] = f - f0;
    i0[k] = min(max((int)f0, 0), n[k] - 1);
    i1[k] = min(i0[k] + 1, n[k] - 1);
  }
  float d = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int cx = (c & 4) ? i1[0] : i0[0];
    int cy = (c & 2) ? i1[1] : i0[1];
    int cz = (c & 1) ? i1[2] : i0[2];
    float wx = (c & 4) ? w[0] : 1.0f - w[0];
    float wy = (c & 2) ? w[1] : 1.0f - w[1];
    float wz = (c & 1) ? w[2] : 1.0f - w[2];
    float v = __ldg(T.density + ((size_t)cx * T.gy + cy) * T.gz + cz);
    float term = v * (wx * wy * wz);
    d = c == 0 ? term : d + term;
  }
  return d;
}

static __device__ __forceinline__ float maj_at(const Tables& T, int x, int y,
                                               int z) {
  x = min(max(x, 0), T.mx - 1);
  y = min(max(y, 0), T.my - 1);
  z = min(max(z, 0), T.mz - 1);
  return T.maj[(x * T.my + y) * T.mz + z];
}

// ---- surfaces (TRIS) ---------------------------------------------------------

constexpr float PI_F = 3.14159265358979323846f;
constexpr float INV_PI_F = (float)(1.0 / 3.14159265358979323846);
constexpr float TINY_G = 1e-18f;
// material table columns (ops/volpath_kernels.py M_*)
constexpr int M_KIND = 0, M_ALB = 1, M_ETA = 4, M_ROUGH = 5, MAT_COLS = 16;

static __device__ __forceinline__ void coord_system(V3 v, V3* t1, V3* t2) {
  float sign = v.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + v.z);
  float b = v.x * v.y * a;
  *t1 = v3(1.0f + sign * v.x * v.x * a, sign * b, -sign * v.x);
  *t2 = v3(b, sign + v.y * v.y * a, -v.y);
}

static __device__ __forceinline__ float pow5(float x) {
  return x * x * x * x * x;
}

// Trowbridge-Reitz D of a half vector with squared cosine mz2
static __device__ __forceinline__ float tr_d_z(float alpha, float mz2) {
  float c2 = fmaxf(mz2, 1e-8f);
  float t2 = (1.0f - c2) / c2;
  float a2 = alpha * alpha;
  float e = 1.0f + t2 / a2;
  return 1.0f / (PI_F * a2 * c2 * c2 * e * e);
}

static __device__ __forceinline__ float tr_lam(float alpha, float wz) {
  float c2 = clampf(wz * wz, 1e-8f, 1.0f);
  float t2 = (1.0f - c2) / c2;
  return 0.5f * (sqrtf(1.0f + alpha * alpha * t2) - 1.0f);
}

// dielectric Fresnel reflectance at cosine ci of the outer side
static __device__ __forceinline__ float frd(float ci, float eta) {
  ci = clampf(ci, 0.0f, 1.0f);
  float s2 = (1.0f - ci * ci) / fmaxf(eta * eta, 1e-12f);
  float ct = sqrtf(fmaxf(1.0f - s2, 0.0f));
  float rp = (eta * ci - ct) / fmaxf(eta * ci + ct, 1e-12f);
  float rq = (ci - eta * ct) / fmaxf(ci + eta * ct, 1e-12f);
  return s2 >= 1.0f ? 1.0f : 0.5f * (rp * rp + rq * rq);
}

// a surface lane: its material, frame and glossy terms
struct Surf {
  V3 ns, alb, g1, g2, wo_l;
  float eta, alpha, lam_o, G1o, zo_s;
  bool front, df, co, dl, cr, ct;
};

// per-channel glossy f at local wo_l, wi_l (rough conductor: the Schlick-
// tinted microfacet lobe; CookTorrance: Fresnel-weighted microfacet over a
// Lambertian base) and the specular pdf
static __device__ V3 glossy_f(const Surf& S, V3 wo_l, V3 wi_l,
                              float* pdf_spec) {
  V3 h = normalize(add(wo_l, wi_l));
  float sg = h.z < 0.0f ? -1.0f : 1.0f;
  h = v3(h.x * sg, h.y * sg, h.z * sg);
  float Dm = tr_d_z(S.alpha, h.z * h.z);
  float G2 = 1.0f / (1.0f + S.lam_o + tr_lam(S.alpha, wi_l.z));
  float zi = fmaxf(fabsf(wi_l.z), 1e-6f);
  float c_owm = fabsf(dot(wo_l, h));
  float omc5 = pow5(clampf(1.0f - c_owm, 0.0f, 1.0f));
  float spec = Dm * G2 / (4.0f * S.zo_s * zi);
  float F = frd(c_owm, S.eta);
  *pdf_spec = S.G1o * Dm / (4.0f * S.zo_s);
  if (S.ct)
    return v3(spec * F + S.alb.x * INV_PI_F * (1.0f - F),
              spec * F + S.alb.y * INV_PI_F * (1.0f - F),
              spec * F + S.alb.z * INV_PI_F * (1.0f - F));
  return v3(spec * (S.alb.x + (1.0f - S.alb.x) * omc5),
            spec * (S.alb.y + (1.0f - S.alb.y) * omc5),
            spec * (S.alb.z + (1.0f - S.alb.z) * omc5));
}

static __device__ __forceinline__ V3 to_loc(const Surf& S, V3 v) {
  return v3(dot(v, S.g1), dot(v, S.g2), dot(v, S.ns));
}

}  // namespace

// Resident blocks an SM that ptxas budgets each variant's instantiations
// for (65536 registers / (128 threads x blocks)): 1 and 2 allow 255
// registers a thread, 3 168, 4 128. The render's shipped values are the
// fastest of chip_smoke.py phase 14's sweep, which rebuilds this file with
// others (-DVSPG_RENDER_MIN_BLOCKS=...). The record instantiations take 2:
// a record launch's time is its longest path's iterations in series, and
// budgets of 1 to 4 moved it by no more than the turns' spread, 4 making
// it slower (PERF.md).
#ifndef VSPG_RENDER_MIN_BLOCKS
#define VSPG_RENDER_MIN_BLOCKS 4
#endif
#ifndef VSPG_RENDER_TRIS_MIN_BLOCKS
#define VSPG_RENDER_TRIS_MIN_BLOCKS 4
#endif

constexpr int THREADS = 128;

template <bool RECORD, bool TRIS>
struct MinBlocks {
  static constexpr int value =
      RECORD ? 2
             : (TRIS ? VSPG_RENDER_TRIS_MIN_BLOCKS : VSPG_RENDER_MIN_BLOCKS);
};

// One work item is one (pixel, sample) path, and each lane takes its next
// item from the counter *next_item (zeroed by the caller) when its path
// ends, until the items run out. The record variant's items are the
// pixels (spp 1, item = pixel, taken a warp's worth at a time by
// take_items): it writes out = L * out_scale and the pixel's record rows.
// The render variant runs the n_items items of one chunk of samples, item
// i being sample samp0 + i / npix of pixel i % npix (sample-major, so a
// warp's lanes start on neighbouring pixels of one sample), and writes the
// item's radiance L to out[i] and its iterations to n_iter[i] (the scratch
// that vspg_reduce_kernel sums per pixel in sample order). Every item has
// the whole pixel's iteration cap, spp * max_events * 12, the per-pixel
// loop's; an item that reaches it writes zero radiance (and cap + 1
// iterations) and counts itself in *at_cap. pix_base offsets the pixels of
// the render variant (the record variant's is 0): item i is pixel i % npix
// of a block of npix pixels that starts at pixel pix_base of the image
// (iconst's nx wide), which keys the pixel's random stream and its camera
// ray, while itab, the scratch and the reduce index the block's pixels
// (the row blocks of parallel/mesh.render_vspg_pallas_sharded).
template <bool RECORD, bool RIS, int METHOD, bool TRIS>
__global__ void __launch_bounds__(THREADS, (MinBlocks<RECORD, TRIS>::value))
    vspg_kernel(const float* __restrict__ fc_g, const int* __restrict__ ic_g,
                const float* __restrict__ gc_g, const int* __restrict__ gi_g,
                const float* __restrict__ density,
                const float* __restrict__ majorant,
                const float* __restrict__ ftab,
                const float* __restrict__ itab,
                const int* __restrict__ cells,
                const float* __restrict__ tris_g,
                const float* __restrict__ mats_g, float* __restrict__ out,
                int* __restrict__ n_iter, float* __restrict__ rec,
                unsigned long long* __restrict__ next_item,
                int* __restrict__ at_cap, int npix, int pix_base, int spp,
                int samp0, long long n_items, uint32_t seed, float out_scale,
                int nmaj, int rec_depth, int n_tri, int n_mat) {
  __shared__ float fc[N_FCONST];
  __shared__ int ic[N_ICONST];
  __shared__ float gc[N_GCONST];
  __shared__ int gi[N_GICONST];
  extern __shared__ float smem[];
  float* smaj = smem;
  float* stris = smem + nmaj;
  float* smats = stris + n_tri * TRI_COLS;
  load_consts(fc_g, ic_g, fc, ic);
  for (int i = threadIdx.x; i < N_GCONST; i += blockDim.x) gc[i] = gc_g[i];
  for (int i = threadIdx.x; i < N_GICONST; i += blockDim.x) gi[i] = gi_g[i];
  for (int i = threadIdx.x; i < nmaj; i += blockDim.x) smaj[i] = majorant[i];
  if constexpr (TRIS) {
    for (int i = threadIdx.x; i < n_tri * TRI_COLS; i += blockDim.x)
      stris[i] = tris_g[i];
    for (int i = threadIdx.x; i < n_mat * MAT_COLS; i += blockDim.x)
      smats[i] = mats_g[i];
  }
  __syncthreads();
  long long item;
  if constexpr (RECORD)
    item = take_items(next_item);
  else
    item = (long long)atomicAdd(next_item, 1ull);
  if (item >= n_items) return;
  const Tables T = {density, smaj, ftab, ic[I_GX], ic[I_GY], ic[I_GZ],
                    ic[I_MX], ic[I_MY], ic[I_MZ], gi[GI_FRES], gi[GI_NCELL],
                    gi[GI_K], gi[GI_NEXTRA] > 0 ? cells : nullptr,
                    gi[GI_NLEAF]};
  const int K = T.K;
  const bool has_point = ic[I_HAS_POINT] != 0, has_env = ic[I_HAS_ENV] != 0;
  const bool iso = ic[I_HG_ISO] != 0, gray = gi[GI_SIGMA_GRAY] != 0;
  const bool guide_primary = gi[GI_GUIDE_PRIMARY] != 0;
  const bool guide_secondary = gi[GI_GUIDE_SECONDARY] != 0;
  const bool vol_guiding = gi[GI_VOL_GUIDING] != 0;
  const bool apply_hg = gi[GI_APPLY_HG] != 0;
  const bool guide_rr = gi[GI_GUIDE_RR] != 0;
  const int min_rr_depth = gi[GI_MIN_RR_DEPTH];
  const int max_depth = ic[I_MAX_DEPTH];
  const V3 st = v3(fc + F_ST), ss = v3(fc + F_SS);
  const V3 lp = v3(fc + F_LP), lI = v3(fc + F_LI), envL = v3(fc + F_ENV);
  const float pmf = fc[F_PMF], penv = fc[F_PENV];
  const V3 one3 = v3(1.f, 1.f, 1.f), zero3 = v3(0.f, 0.f, 0.f);
  constexpr bool NDS = METHOD != M_RESAMPLING;
  constexpr bool NDS_PLUS = METHOD == M_NDS_PLUS;
  const bool surf_guide = TRIS && gi[GI_SURF_GUIDE] != 0;
  const bool any_rough = TRIS && gi[GI_ANY_ROUGH] != 0;
  const int P_HALF = 8 * K + 8;

  // the item's pixel (pix_i in the block, pix in the image) and sample,
  // and the pixel's ISGB entries
  int pix_i;
  uint32_t pix, samp;
  float ivsp, ipel, ipem;
  auto rec_put = [&](int row, int slot, float v) {
    if (RECORD && slot >= 0 && slot < rec_depth)
      rec[((size_t)row * rec_depth + slot) * npix + pix_i] = v;
  };
  auto rec_add = [&](int row, int slot, float v) {
    if (RECORD && slot >= 0 && slot < rec_depth) {
      size_t i = ((size_t)row * rec_depth + slot) * npix + pix_i;
      rec[i] = rec[i] + v;
    }
  };

  // lane state (the Pallas kernel's carry)
  uint32_t dim;
  bool alive;
  V3 o, d;
  int hero;
  V3 b, ru, rl, L;
  int depth, med, mode, rslot;
  float t_walk, w_sum, c_t, c_wi, c_ste;
  V3 wf, wu, wl, wT, wr, cn, cd;
  bool has_c;
  float maj_sc, tau_acc, vsp_c;
  V3 sh, sT, sl, su;
  float sh_t, sh_end, sh_pdf, sh_d2, sh_f, sh_fl, rr_srv;
  // the surface machine (TRIS): the pending closest hit, the sweep and
  // occlusion requests, the delta-bounce flag, a surface NEE record's
  // albedo tint and the per-channel glossy NEE folds
  float t_surf, sh_f1, sh_f2;
  V3 hng, ra;
  int hmat, hmi, hmo;
  bool needs_i, sh_occ, spec_last;
  // a fresh path for `item`: every carry at the value the per-pixel kernel
  // gave it at its first sample
  auto begin = [&]() {
    pix_i = (int)(item % npix);
    pix = (uint32_t)(pix_base + pix_i);
    samp = (uint32_t)samp0 + (uint32_t)(item / npix);
    ivsp = itab[pix_i];
    ipel = itab[npix + pix_i];
    ipem = itab[2 * npix + pix_i];
    dim = 1;
    alive = true;
    start_path(fc, ic[I_NX], seed, pix, samp, &o, &d, &hero);
    b = ru = rl = one3;
    L = zero3;
    depth = 0;
    med = -1;
    mode = 0;
    rslot = 0;
    t_walk = w_sum = c_t = c_wi = c_ste = 0.f;
    wf = wu = wl = wT = wr = cn = cd = one3;
    has_c = false;
    maj_sc = 1.f;
    tau_acc = vsp_c = 0.f;
    sh = zero3;
    sT = sl = su = one3;
    sh_t = sh_end = sh_pdf = 0.f;
    sh_d2 = 1.f;
    sh_f = sh_fl = 0.f;
    rr_srv = 1.f;
    t_surf = BIG;
    sh_f1 = sh_f2 = 0.f;
    hng = zero3;
    ra = one3;
    hmat = hmi = hmo = -1;
    needs_i = true;
    sh_occ = spec_last = false;
  };
  begin();

  const long long max_iters = (long long)spp * ic[I_MAX_EVENTS] * 12;
  long long it = 0;
  for (;;) {
    // mode 2: the reservoir walk, or under NDS the ODS walk; mode 1: the
    // NDS majorant-OD prepass
    const bool walk_res = !NDS && mode == 2, walk_nds = NDS && mode == 2;
    const bool walk_pre = NDS && mode == 1, walk_del = mode == 3;
    const float st_h = sel(st, hero);

    // deferred Russian roulette (survival stored at the last scatter)
    float4 u = uniform4(seed, pix, samp, dim);
    dim += 1;
    if (mode == 0 && rr_srv < 1.0f) {
      if (u.x >= rr_srv) {
        alive = false;
      } else {
        b = scale(b, 1.0f / fmaxf(rr_srv, 1e-3f));
      }
    }
    if (alive && mode == 0) rr_srv = 1.0f;

    bool stall = false;
    if constexpr (TRIS) {
      // one triangle sweep serves the lane's pending query: the closest hit
      // of its path ray after a direction change, or the occlusion of its
      // shadow ray at walk start; a swept lane stalls this iteration, and
      // so does a lane whose shadow walk was just blocked
      const bool do_is = alive && mode == 0 && needs_i;
      const bool do_oc = alive && mode >= 4 && sh_occ;
      if (do_is || do_oc) {
        const TriHit th = closest_tri(stris, n_tri, o, do_oc ? sh : d, BIG);
        const float t_h = th.k >= 0 ? th.t : BIG;
        if (do_is) {
          t_surf = t_h;
          if (th.k >= 0) {
            const float* r = stris + th.k * TRI_COLS;
            hng = v3(r + T_NG);
            hmat = (int)r[T_MAT];
            hmi = (int)r[T_MED_IN];
            hmo = (int)r[T_MED_OUT];
          } else {
            hng = zero3;
            hmat = hmi = hmo = -1;
          }
          needs_i = false;
        }
        if (do_oc) {
          // point lights occlude up to the light, the env to infinity
          const float occ_t = mode == 4 ? sqrtf(sh_d2) : BIG;
          if (t_h < occ_t - 1e-4f) mode = 0;
          sh_occ = false;
        }
      }
      stall = do_is || (alive && mode == 0 && needs_i);
    }

    // stuck-lane guard; transport lanes enter the box or escape
    if (med == 0 && mode == 0 && !stall && outside_box(fc, o)) med = -1;
    float t_wall;
    bool entering;
    const bool hit = box_hit(fc, o, d, &t_wall, &entering);
    const bool outside = alive && mode == 0 && med != 0 && !stall;
    const bool no_surf = !TRIS || t_surf >= BIG * 0.5f;
    const bool escaped = outside && !hit && no_surf;
    if (escaped) {
      if (has_env) {
        // a delta bounce has no light-sampling competitor
        const bool first = depth == 0 || (TRIS && spec_last);
        float ru_avg = fmaxf(avg3(ru), 1e-30f);
        float den = fmaxf(avg3(v3(ru.x + rl.x * penv, ru.y + rl.y * penv,
                                  ru.z + rl.z * penv)),
                          1e-30f);
        float dv = first ? ru_avg : den;
        L = v3(L.x + b.x * envL.x / dv, L.y + b.y * envL.y / dv,
               L.z + b.z * envL.z / dv);
        if (RECORD) {
          float w_mis = first ? 1.0f : ru_avg / den;
          rec_put(11, rslot - 1, envL.x * w_mis);
          rec_put(12, rslot - 1, envL.y * w_mis);
          rec_put(13, rslot - 1, envL.z * w_mis);
        }
      }
      alive = false;
    }
    bool enter = false, at_surf_nm = false;
    if constexpr (TRIS) {
      // a surface before the box wall: a flight outside the medium reaches
      // a triangle; otherwise a wall crossing sets the medium by the side
      // entered
      const float wall_o = hit ? t_wall : BIG;
      at_surf_nm = outside && !escaped && !no_surf && t_surf < wall_o;
      if (outside && !escaped && !at_surf_nm && hit) {
        med = entering ? 0 : -1;
        o = along(o, t_wall + 1e-4f, d);
        t_surf = t_surf - (t_wall + 1e-4f);
        enter = entering;
      }
    } else {
      enter = alive && outside && hit && entering;
      if (enter) {
        med = 0;
        o = along(o, t_wall + 1e-4f, d);
      }
      if (alive && outside && hit && !entering) alive = false;
    }
    const bool in_med = alive && mode == 0 && med == 0 && !enter && !stall;
    // a walk in the medium ends at the exit, also one nearer than box_hit's
    // 1e-4 (ROADMAP.md section C 4)
    const float wall = hit ? t_wall : (med == 0 ? box_exit(fc, o, d) : BIG);
    // walks end at the nearer of the wall and the next surface
    const float plim = TRIS ? fminf(wall, t_surf) : wall;

    // ---- one majorant + density event of a walking lane ------------------
    const bool is_sh = alive && mode >= 4;
    const bool stepper = walk_res || walk_del || is_sh || walk_nds || walk_pre;
    const V3 wd = is_sh ? sh : d;
    const V3 ep = is_sh ? along(o, sh_t, sh) : along(o, t_walk, d);
    const float t_lim = is_sh ? sh_end - sh_t : plim - t_walk;
    u = uniform4(seed, pix, samp, dim);
    dim += 1;
    const float ub = u.y;
    if (NDS && walk_nds && c_t < 0.0f) {
      // ODS candidate: an optical depth on the truncated exponential over
      // [0, t_n) (defensive lanes: the plain exponential); cn gathers the
      // truncation renormalisations of every channel
      const float tn_pos = fmaxf(wT.y, 0.0f);
      const float step_tr = -expm1f(-tn_pos);
      const float dist_g = -log1pf(-u.x * clampf(step_tr, 0.0f, ONE_M_1E7));
      const float dist = c_wi > 0.5f ? -log1pf(-u.x) : dist_g;
      const float inv_sth = 1.0f / fmaxf(st_h, 1e-30f);
      cn = v3(cn.x * fmaxf(-expm1f(-tn_pos * st.x * inv_sth), 1e-30f),
              cn.y * fmaxf(-expm1f(-tn_pos * st.y * inv_sth), 1e-30f),
              cn.z * fmaxf(-expm1f(-tn_pos * st.z * inv_sth), 1e-30f));
      const bool pass_n = wT.x - dist < 1e-5f;
      if (pass_n) {
        const float tailf =
            fmaxf(-expm1f(-fmaxf(c_ste - tau_acc, 0.0f)), 1e-30f);
        cn = v3(cn.x / tailf, cn.y / tailf, cn.z / tailf);
      }
      c_t = pass_n ? BIG : dist;
    }
    const float rate = walk_res ? maj_sc : 1.0f;
    float S_raw = 0.f, t_cum = 0.f, m_last = 0.f;
    bool coll = false;
    if (stepper) {
      float tau0 = -log1pf(-u.x);
      if (walk_nds) tau0 = fmaxf(c_t, 0.0f);  // fly to the candidate
      if (walk_pre) tau0 = BIG;  // the prepass never collides
      const float epc[3] = {ep.x, ep.y, ep.z}, wdc[3] = {wd.x, wd.y, wd.z};
      int ix[3];
      float tx[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float u0 = (epc[k] - fc[F_BMIN + k]) * gc[G_KM + k];
        float den = fabsf(wdc[k]) < 1e-12f ? (wdc[k] >= 0.f ? 1e-12f : -1e-12f)
                                           : wdc[k];
        float inv_du = gc[G_CELL + k] / den;
        float eps = wdc[k] >= 0.f ? 3e-4f : -3e-4f;
        ix[k] = (int)u0;
        float cf = floorf(u0 + eps);
        float bnd = wdc[k] >= 0.f ? cf + 1.0f : cf;
        tx[k] = (bnd - u0) * inv_du;
      }
      float m_raw = maj_at(T, ix[0], ix[1], ix[2]);
      float t_exit = fmaxf(fminf(fminf(tx[0], tx[1]), tx[2]), 1e-5f);
      float end_c = fminf(t_exit, t_lim);
      float r_i = m_raw * rate * st_h;
      float dtau = r_i * fmaxf(end_c, 0.0f);
      bool hit_c = tau0 < dtau;
      bool at_lim = !hit_c && t_lim <= t_exit + 1e-6f;
      float t_next = hit_c ? tau0 / fmaxf(r_i, 1e-30f) : end_c;
      S_raw = m_raw * t_next;
      t_cum = (hit_c || at_lim) ? t_next : t_exit + 1e-6f;
      if (hit_c) m_last = m_raw;
      coll = hit_c;
    }
    const float m_d = walk_res ? m_last * maj_sc : m_last;
    const float maj_h = m_d * st_h;
    const float step = t_cum;
    const float S_eff = S_raw * rate;
    const float od_raw = st_h * S_raw;
    const float Tm_h = fmaxf(expf(-st_h * S_eff), 1e-30f);
    const V3 Tm = gray ? v3(Tm_h, Tm_h, Tm_h)
                       : v3(expf(-st.x * S_eff), expf(-st.y * S_eff),
                            expf(-st.z * S_eff));
    const V3 sc_tail = gray ? one3
                            : v3(Tm.x / Tm_h, Tm.y / Tm_h, Tm.z / Tm_h);
    const float un0 = uniform4(seed, pix, samp, dim).x;
    dim += 1;
    const float dloc = stepper && !walk_pre
                           ? density8(fc, gc, T, along(ep, step, wd))
                           : 0.f;
    const float st_loc_h = dloc * st_h;
    const V3 sn = v3(fmaxf((m_d - dloc) * st.x, 0.0f),
                     fmaxf((m_d - dloc) * st.y, 0.0f),
                     fmaxf((m_d - dloc) * st.z, 0.0f));
    const float sn_h = fmaxf(m_d - dloc, 0.0f) * st_h;

    // ---- modes 4/5: one ratio-tracking step of the shadow walk ----------
    if (is_sh) {
      if (!coll) {
        if (!gray) {
          sT = mul(sT, sc_tail);
          sl = mul(sl, sc_tail);
          su = mul(su, sc_tail);
        }
      } else {
        float inv_spdf = 1.0f / fmaxf(Tm_h * maj_h, 1e-30f);
        sT = v3(sT.x * Tm.x * sn.x * inv_spdf, sT.y * Tm.y * sn.y * inv_spdf,
                sT.z * Tm.z * sn.z * inv_spdf);
        sl = v3(sl.x * Tm.x * m_d * st.x * inv_spdf,
                sl.y * Tm.y * m_d * st.y * inv_spdf,
                sl.z * Tm.z * m_d * st.z * inv_spdf);
        su = v3(su.x * Tm.x * sn.x * inv_spdf, su.y * Tm.y * sn.y * inv_spdf,
                su.z * Tm.z * sn.z * inv_spdf);
        // low-transmittance roulette (integrators.cpp:1404)
        float trm = max3(sT) / fmaxf(avg3(add(sl, su)), 1e-30f);
        if (trm < 0.05f)
          sT = un0 < 0.75f ? zero3 : v3(sT.x / 0.25f, sT.y / 0.25f,
                                        sT.z / 0.25f);
      }
      float sh_t_new = sh_t + step + 1e-6f;
      sh_t = sh_t_new;
      if (max3(sT) == 0.0f || sh_t_new >= sh_end) {
        if (mode == 4 && has_point) {
          float denom = fmaxf(avg3(v3(sl.x * ru.x * pmf, sl.y * ru.y * pmf,
                                      sl.z * ru.z * pmf)),
                              1e-30f);
          float w = sh_f / (sh_d2 * denom);
          // a glossy surface's fold is per channel
          float w1 = any_rough ? sh_f1 / (sh_d2 * denom) : w;
          float w2 = any_rough ? sh_f2 / (sh_d2 * denom) : w;
          L = v3(L.x + b.x * sT.x * lI.x * w, L.y + b.y * sT.y * lI.y * w1,
                 L.z + b.z * sT.z * lI.z * w2);
          if (RECORD) {
            float den_lp = fmaxf(avg3(v3(sl.x * pmf, sl.y * pmf, sl.z * pmf)),
                                 1e-30f);
            float wl_ = sh_fl / (sh_d2 * den_lp);
            rec_put(8, rslot - 1, sT.x * lI.x * wl_ * ra.x);
            rec_put(9, rslot - 1, sT.y * lI.y * wl_ * ra.y);
            rec_put(10, rslot - 1, sT.z * lI.z * wl_ * ra.z);
          }
        }
        if (mode == 5 && has_env) {
          float p_l = penv;
          float denom =
              fmaxf(avg3(v3(sl.x * ru.x * p_l + su.x * ru.x * sh_pdf,
                            sl.y * ru.y * p_l + su.y * ru.y * sh_pdf,
                            sl.z * ru.z * p_l + su.z * ru.z * sh_pdf)),
                    1e-30f);
          float w = sh_f / denom;
          float w1 = any_rough ? sh_f1 / denom : w;
          float w2 = any_rough ? sh_f2 / denom : w;
          L = v3(L.x + b.x * sT.x * envL.x * w, L.y + b.y * sT.y * envL.y * w1,
                 L.z + b.z * sT.z * envL.z * w2);
          if (RECORD) {
            float den_le = fmaxf(avg3(v3(sl.x * p_l + su.x * sh_pdf,
                                         sl.y * p_l + su.y * sh_pdf,
                                         sl.z * p_l + su.z * sh_pdf)),
                                 1e-30f);
            float wl_ = sh_fl / den_le;
            rec_add(8, rslot - 1, sT.x * envL.x * wl_ * ra.x);
            rec_add(9, rslot - 1, sT.y * envL.y * wl_ * ra.y);
            rec_add(10, rslot - 1, sT.z * envL.z * wl_ * ra.z);
          }
        }
        mode = 0;
      }
    }

    // ---- mode 3: one delta-tracking step (ODS lanes ride the same algebra
    // on their optical-depth candidates) -----------------------------------
    bool d_real = false, d_died = false, d_passed = false, d_null = false;
    if (walk_del || walk_nds) {
      // NDS+ raises a primary ray's real-collision probability to
      // p^(1/(1+Tr)), w_sum holding 1/(1+Tr)
      const bool prim_l = NDS_PLUS && walk_nds && depth == 0;
      float p_cls = st_loc_h / fmaxf(maj_h, 1e-30f);
      if (prim_l)
        p_cls = powf(clampf(p_cls, 1e-30f, 1.0f), clampf(w_sum, 1e-3f, 1.0f));
      if (!coll) {
        if (!gray) {
          wf = mul(wf, sc_tail);
          wu = mul(wu, sc_tail);
          wl = mul(wl, sc_tail);
        }
      } else if (ub < p_cls) {
        d_real = true;
        float pdf_r = fmaxf(Tm_h * st_loc_h, 1e-30f);
        wf = v3(wf.x * Tm.x * dloc * ss.x / pdf_r,
                wf.y * Tm.y * dloc * ss.y / pdf_r,
                wf.z * Tm.z * dloc * ss.z / pdf_r);
        wu = v3(wu.x * Tm.x * dloc * st.x / pdf_r,
                wu.y * Tm.y * dloc * st.y / pdf_r,
                wu.z * Tm.z * dloc * st.z / pdf_r);
      } else {
        float pdf_dn = Tm_h * sn_h;
        float inv_dn = 1.0f / fmaxf(pdf_dn, 1e-30f);
        wf = v3(wf.x * Tm.x * sn.x * inv_dn, wf.y * Tm.y * sn.y * inv_dn,
                wf.z * Tm.z * sn.z * inv_dn);
        wu = v3(wu.x * Tm.x * sn.x * inv_dn, wu.y * Tm.y * sn.y * inv_dn,
                wu.z * Tm.z * sn.z * inv_dn);
        wl = v3(wl.x * Tm.x * m_d * st.x * inv_dn,
                wl.y * Tm.y * m_d * st.y * inv_dn,
                wl.z * Tm.z * m_d * st.z * inv_dn);
        d_died = pdf_dn <= 0.0f || max3(wf) == 0.0f;
        d_null = true;
      }
      float del_t_new = t_walk + step + 1e-6f;
      d_passed = !coll && del_t_new >= plim;
      t_walk = del_t_new;
      if (NDS && walk_nds) {
        // ODS bookkeeping: the flight consumed od_raw of the running
        // interval; a null collision draws anew next iteration
        wT.x = wT.x - od_raw;
        wT.y = wT.y - od_raw;
        c_t = coll ? -1.0f : c_t - od_raw;
        // one-sample MIS factor against plain delta tracking, on r_u at a
        // real collision and on r_u and r_l at the pass exit
        const V3 ruf = v3(gc[G_MIS] / fmaxf(cn.x, 1e-30f) + gc[G_1MMIS],
                          gc[G_MIS] / fmaxf(cn.y, 1e-30f) + gc[G_1MMIS],
                          gc[G_MIS] / fmaxf(cn.z, 1e-30f) + gc[G_1MMIS]);
        if (d_real || d_passed) wu = mul(wu, ruf);
        if (d_passed) wl = mul(wl, ruf);
        if (NDS_PLUS && prim_l && (d_real || d_null)) {
          // exact r_u compensation of the biased classification
          const float comp =
              d_real ? m_d * p_cls / fmaxf(dloc, 1e-30f)
                     : m_d * (1.0f - p_cls) / fmaxf(m_d - dloc, 1e-30f);
          wu = scale(wu, comp);
        }
      }
    }

    // ---- mode 1: the exact majorant-OD prepass to the chord end; then the
    // ODS walk, or the delta walk where vsp < 1 - e^-t_v ------------------
    if (NDS && walk_pre) {
      tau_acc = tau_acc + od_raw;
      const float pre_t_new = t_walk + step + 1e-6f;
      const bool pre_done = pre_t_new >= plim;
      t_walk = pre_done ? 0.0f : pre_t_new;
      if (pre_done) {
        const float one_m_e = -expm1f(-tau_acc);
        const bool fb = vsp_c < one_m_e || tau_acc <= 1e-7f;
        mode = fb ? 3 : 2;
        if (!fb) {
          const float t_n0 = -log1pf(
              -fminf(one_m_e / fmaxf(vsp_c, 1e-4f), ONE_M_1E7));
          wT.x = tau_acc;
          wT.y = t_n0;
          c_ste = t_n0;
          c_t = -1.0f;
          cn = one3;
          c_wi = u.z > gc[G_MIS] ? 1.0f : 0.0f;  // defensive-MIS pick
          w_sum = 1.0f;
          if (NDS_PLUS && depth == 0) {
            const float tr_h = itab[(size_t)(3 + hero) * npix + pix_i];
            w_sum = 1.0f / (1.0f + clampf(tr_h, 0.0f, 1.0f));
          }
        }
      }
    }

    // ---- mode 2: one reservoir-resampling step ---------------------------
    bool res_done = false;
    if (walk_res) {
      tau_acc = tau_acc + od_raw;
      const V3 wTn = mul(wT, Tm);
      const float T_h = fmaxf(sel(wTn, hero), 1e-30f);
      const float t_c_r = t_walk + step;
      if (coll) {
        float wi_r = st_loc_h / fmaxf(maj_h, 1e-30f) * sel(wr, hero);
        float w_sum_new = w_sum + wi_r;
        if (wi_r > 0.0f && ub < wi_r / fmaxf(w_sum_new, 1e-30f)) {
          float pdf_rr = fmaxf(T_h * st_loc_h, 1e-30f);
          c_t = t_c_r;
          c_wi = wi_r;
          c_ste = wi_r;
          cn = v3(wf.x * wTn.x * dloc * ss.x / pdf_rr,
                  wf.y * wTn.y * dloc * ss.y / pdf_rr,
                  wf.z * wTn.z * dloc * ss.z / pdf_rr);
          cd = v3(wu.x * wTn.x * dloc * st.x / pdf_rr,
                  wu.y * wTn.y * dloc * st.y / pdf_rr,
                  wu.z * wTn.z * dloc * st.z / pdf_rr);
          has_c = true;
        }
        w_sum = w_sum_new;
        float pdf_rn = fmaxf(T_h * sn_h, 1e-30f);
        wf = v3(wf.x * wTn.x * sn.x / pdf_rn, wf.y * wTn.y * sn.y / pdf_rn,
                wf.z * wTn.z * sn.z / pdf_rn);
        wu = v3(wu.x * wTn.x * sn.x / pdf_rn, wu.y * wTn.y * sn.y / pdf_rn,
                wu.z * wTn.z * sn.z / pdf_rn);
        wl = v3(wl.x * wTn.x * m_d * st.x / pdf_rn,
                wl.y * wTn.y * m_d * st.y / pdf_rn,
                wl.z * wTn.z * m_d * st.z / pdf_rn);
        float nsc = fmaxf(m_d - dloc, 0.0f) * (1.0f / fmaxf(m_d, 1e-30f));
        wr = scale(wr, nsc);
        wT = one3;
        t_walk = t_c_r;
      } else {
        wT = wTn;
        t_walk = t_walk + step + 1e-6f;
      }
      res_done = t_walk >= plim;
    }

    // ---- reservoir conclusion: tail fold + candidate selection -----------
    const float u_rc = uniform4(seed, pix, samp, dim).x;
    dim += 1;
    bool r_scat = false, r_dead = false, pick_surf = false;
    V3 rfb = one3, rfu = one3, rfl = one3;
    if (res_done) {
      const float T_hf = fmaxf(sel(wT, hero), 1e-30f);
      const float tr_hf = sel(wr, hero);
      float vratio = fminf(
          vsp_c / fmaxf(1.0f - expf(-maj_sc * tau_acc), 1e-6f), 1.0f);
      float vol_ratio = vratio * gc[G_MIS] + (1.0f - tr_hf) * gc[G_1MMIS];
      bool adj = tr_hf < 1.0f && tr_hf > 0.0f && w_sum > 0.0f;
      float surf_wi = adj ? (1.0f - vol_ratio) / fmaxf(vol_ratio, 1e-6f) * w_sum
                          : tr_hf;
      float w_total = w_sum + surf_wi;
      bool r_dead0 = w_total <= 0.0f;
      pick_surf = !r_dead0 && u_rc < surf_wi / fmaxf(w_total, 1e-30f);
      bool pick_vol = !r_dead0 && !pick_surf && has_c;
      r_dead = r_dead0 || (!pick_surf && !has_c);
      float sel_wi = pick_surf ? surf_wi : c_wi;
      float sel_ste = pick_surf ? tr_hf : c_ste;
      V3 sn_ = pick_surf ? v3(wf.x * wT.x / T_hf, wf.y * wT.y / T_hf,
                              wf.z * wT.z / T_hf)
                         : cn;
      V3 sd_ = pick_surf ? v3(wu.x * wT.x / T_hf, wu.y * wT.y / T_hf,
                              wu.z * wT.z / T_hf)
                         : cd;
      float factor = w_total * sel_ste / fmaxf(sel_wi, 1e-30f);
      if (!r_dead) {
        rfb = scale(sn_, factor);
        rfu = sd_;
      }
      if (pick_surf)
        rfl = v3(wl.x * wT.x / T_hf, wl.y * wT.y / T_hf, wl.z * wT.z / T_hf);
      bool finite = isfinite(rfb.x) && isfinite(rfb.y) && isfinite(rfb.z) &&
                    isfinite(rfu.x) && isfinite(rfu.y) && isfinite(rfu.z) &&
                    isfinite(rfl.x) && isfinite(rfl.y) && isfinite(rfl.z);
      bool r_bad = !r_dead && !finite;
      r_dead = r_dead || r_bad;
      r_scat = pick_vol && !r_bad;
    }

    // ---- walk conclusions -------------------------------------------------
    if (d_real || d_died || d_passed) {
      b = mul(b, wf);
      ru = mul(ru, wu);
      rl = mul(rl, wl);
    } else if (res_done) {
      b = mul(b, rfb);
      ru = mul(ru, rfu);
      rl = mul(rl, rfl);
    }
    const bool scat_w = d_real || r_scat;
    const bool term_w = d_died || r_dead;
    const bool passed = d_passed || pick_surf;
    // under NDS c_t holds the ODS candidate: only a real collision scatters
    const float t_sc = d_real ? t_walk : (NDS ? 0.0f : c_t);
    if (term_w) alive = false;
    if (scat_w && depth >= max_depth) alive = false;
    const bool scat = scat_w && depth < max_depth && alive;
    if (scat) depth += 1;
    // a walk that passes ends at the box wall (the lane leaves the medium)
    // or, with triangles, at the next surface (the medium unchanged)
    const bool at_surf_m = TRIS && passed && t_surf < wall - 1e-6f;
    if (passed && !at_surf_m) {
      med = -1;
      o = along(o, wall + 1e-4f, d);
      if (TRIS) t_surf = t_surf - (wall + 1e-4f);
    }
    if (passed || term_w || scat_w) mode = 0;

    // ---- field query: walk starts (secondary VSP), scatter vertices ------
    const V3 s = along(o, t_sc, d);
    Lobes lob;
    bool valid_q = false;
    float vsp_cell = -1.0f;
    V3 flux_q = zero3;
    if (scat || (in_med && guide_secondary && depth != 0))
      field_query(gc, T, scat ? s : o, &lob, &valid_q, &vsp_cell, &flux_q);
    // surface interactions (the depth cap holds for surfaces too): the
    // surface half of the field at the hit
    bool hit_s = false;
    V3 hpos = zero3;
    Surf S;
    Lobes slob;
    bool svalid = false;
    V3 sflux = zero3;
    if constexpr (TRIS) {
      const bool hit_s0 = (at_surf_m || at_surf_nm) && hmat >= 0;
      if (hit_s0 && depth >= max_depth) alive = false;
      hit_s = hit_s0 && alive;
      if (hit_s) {
        depth += 1;
        hpos = along(o, t_surf, d);
        float svsp;
        field_query(gc, T, hpos, &slob, &svalid, &svsp, &sflux, P_HALF);
        // material, a normal facing the ray, and the glossy frame
        const float* m = smats + hmat * MAT_COLS;
        const int kind = (int)m[M_KIND];
        S.front = dot(hng, d) < 0.0f;
        S.ns = S.front ? hng : v3(-hng.x, -hng.y, -hng.z);
        S.alb = v3(m + M_ALB);
        S.eta = fmaxf(m[M_ETA], 1e-3f);
        S.alpha = fmaxf(m[M_ROUGH], 1e-4f);
        const bool smooth = S.alpha < 1e-3f;
        S.df = kind == 0;
        S.co = kind == 1 && smooth;
        S.dl = kind == 2;
        S.cr = kind == 1 && !smooth;
        S.ct = kind == 11;
        coord_system(S.ns, &S.g1, &S.g2);
        S.wo_l = to_loc(S, v3(-d.x, -d.y, -d.z));
        S.lam_o = tr_lam(S.alpha, S.wo_l.z);
        S.G1o = 1.0f / (1.0f + S.lam_o);
        S.zo_s = fmaxf(fabsf(S.wo_l.z), 1e-6f);
      }
    }
    bool guide = false;
    if (in_med) {
      float vsp = -1.0f;
      if (guide_primary && depth == 0) vsp = ivsp;
      if (guide_secondary && depth != 0)
        vsp = vsp_directional(fc, lob, K, vsp_cell, d);
      guide = vsp >= 0.0f;
      vsp_c = clampf(vsp, 0.001f, 0.999f);
      mode = guide ? (NDS ? 1 : 2) : 3;  // NDS: the prepass first
      t_walk = 0.f;
      w_sum = 0.f;
      tau_acc = 0.f;
    }
    // majorant scale of the guided walk from a one-point estimate of the
    // segment's majorant optical depth
    const float u_m0 = uniform4(seed, pix, samp, dim).x;
    dim += 1;
    if (in_med && NDS) {
      maj_sc = 1.0f;  // optical-depth space: no majorant scaling
    } else if (in_med) {
      V3 pm = along(o, u_m0 * plim, d);
      float m_pt = maj_at(
          T, (int)((pm.x - fc[F_BMIN]) / gc[G_EXT] * (float)T.mx),
          (int)((pm.y - fc[F_BMIN + 1]) / gc[G_EXT + 1] * (float)T.my),
          (int)((pm.z - fc[F_BMIN + 2]) / gc[G_EXT + 2] * (float)T.mz));
      float tau_e = m_pt * st_h * plim;
      float min_total =
          -logf(fmaxf(1.0f - fminf(vsp_c, gc[G_SCALE_CAP]), 1e-6f));
      maj_sc = guide ? clampf(min_total / fmaxf(tau_e, 1e-6f), 1.0f, 16.0f)
                     : 1.0f;
    }
    if (in_med) {
      wf = wu = wl = one3;
      if (guide) {
        wT = wr = cn = cd = one3;
        c_t = c_wi = c_ste = 0.f;
        has_c = false;
      }
    }

    // ---- scatter vertices: guided RR, NEE light pick, direction ----------
    const float4 up = uniform4(seed, pix, samp, dim);
    dim += 1;
    const float4 u_p = uniform4(seed, pix, samp, dim);
    dim += 1;
    const float4 u_c4 = uniform4(seed, pix, samp, dim);
    dim += 1;
    float4 u_s = make_float4(0.f, 0.f, 0.f, 0.f), u_r = u_s;
    if (TRIS) {
      u_s = uniform4(seed, pix, samp, dim);  // the surface bounce
      dim += 1;
      if (any_rough) {
        u_r = uniform4(seed, pix, samp, dim);  // the glossy lobe
        dim += 1;
      }
    }
    const bool sel_pt = has_point && (!has_env || up.x < pmf);
    if (scat) {
      const bool use_guide = valid_q && vol_guiding;
      const Lobes prod = apply_hg ? product_hg(gc, lob, K, d) : lob;
      const V3 wo = v3(-d.x, -d.y, -d.z);
      float survival;
      if (guide_rr) {
        float num_rr = b.x * flux_q.x * 0.2126f + b.y * flux_q.y * 0.7152f +
                       b.z * flux_q.z * 0.0722f;
        survival = (valid_q && ipem > 0.0f)
                       ? clampf(num_rr / fmaxf(ipel, 1e-6f), 0.1f, 1.0f)
                       : 1.0f;
      } else {
        survival = clampf(max3(b) / fmaxf(avg3(ru), 1e-30f), 0.0f, 1.0f);
      }
      if (depth > min_rr_depth) rr_srv = survival;

      // NEE: one light sample; its shadow walk runs in later iterations
      const V3 pl = sub(s, lp);
      const float dist2 = fmaxf(dot(pl, pl), 1e-12f);
      const float dist = sqrtf(dist2);
      V3 wi;
      if (sel_pt) {
        float inv_dist = 1.0f / dist;
        wi = v3(-pl.x * inv_dist, -pl.y * inv_dist, -pl.z * inv_dist);
      } else {
        float ez = 1.0f - 2.0f * up.y;
        float er = sqrtf(fmaxf(1.0f - ez * ez, 0.0f));
        float ephi = fc[F_TWO_PI] * up.z;
        wi = v3(er * cosf(ephi), er * sinf(ephi), ez);
      }
      const float f_hg = hg_value(fc, dot(wo, wi));
      const float spdf_l =
          use_guide ? gc[G_1MPG_NEE] * f_hg +
                          gc[G_PG_NEE] * mixture_pdf(fc, prod, K, wi)
                    : f_hg;
      // a scatter vertex lies in the medium: its shadow walk ends at the exit
      const float t_exit_s = box_exit(fc, s, wi);
      const float t_med = sel_pt ? fminf(dist, t_exit_s) : t_exit_s;

      // direction: one-sample MIS or RIS of the phase function and the
      // guiding mixture
      float hpdf;
      const V3 hw = sample_hg(fc, iso, wo, u_p.x, u_p.y, &hpdf);
      V3 wv;
      float pdf_v, mis_pdf;
      bool valid_v;
      if (!RIS) {
        const float u_c = u_c4.x;
        const bool take_g = use_guide && u_c < gc[G_PG];
        const float u_lobe = clampf(u_c / gc[G_PG_SAFE], 0.0f, 0.999999f);
        float gpdf;
        const V3 gw = mixture_sample(fc, prod, K, u_lobe, u_c4.y, u_c4.z,
                                     &gpdf);
        wv = take_g ? gw : hw;
        const float base_pdf = take_g ? hg_value(fc, dot(wo, gw)) : hpdf;
        const float guide_pdf = take_g ? gpdf : mixture_pdf(fc, prod, K, hw);
        pdf_v = use_guide ? gc[G_1MPG] * base_pdf + gc[G_PG] * guide_pdf
                          : hpdf;
        mis_pdf = pdf_v;
        valid_v = ((take_g && base_pdf > 0.0f) || (!take_g && hpdf > 0.0f)) &&
                  pdf_v > 0.0f;
      } else {
        float gpdf;
        const V3 gw =
            mixture_sample(fc, prod, K, u_c4.y, u_p.w, u_p.z, &gpdf);
        const float bpdf_g = hg_value(fc, dot(wo, gw));
        const float gpdf_b = mixture_pdf(fc, prod, K, hw);
        const float irp_b = valid_q ? mixture_pdf(fc, lob, K, hw) : INV_4PI_F;
        const float irp_g = valid_q ? mixture_pdf(fc, lob, K, gw) : INV_4PI_F;
        const float mis0 = 0.5f * (hpdf + gpdf_b);
        const float mis1 = 0.5f * (bpdf_g + gpdf);
        const float target0 = hpdf * (gc[G_RIS_C0] + gc[G_PG] * irp_b);
        const float target1 = bpdf_g * (gc[G_RIS_C0] + gc[G_PG] * irp_g);
        const float w0 = hpdf > 0.0f ? target0 / fmaxf(mis0, 1e-20f) : 0.0f;
        const float w1 =
            bpdf_g > 0.0f ? target1 / fmaxf(mis1, 1e-20f) : 0.0f;
        const float sum_w = w0 + w1;
        const bool pick1 = u_c4.x * fmaxf(sum_w, 1e-20f) > w0;
        const float mis_sel = pick1 ? mis1 : mis0;
        const float w_sel = pick1 ? w1 : w0;
        const float pdf_ris = w_sel * mis_sel * 2.0f / fmaxf(sum_w, 1e-20f);
        const bool ris_valid = sum_w > 0.0f && pdf_ris > 0.0f;
        wv = use_guide ? (pick1 ? gw : hw) : hw;
        pdf_v = use_guide ? pdf_ris : hpdf;
        mis_pdf = use_guide ? mis_sel : hpdf;
        valid_v = use_guide ? ris_valid : hpdf > 0.0f;
      }
      const float f_v = hg_value(fc, dot(wo, wv));
      if (!valid_v) alive = false;
      const float scale_v = f_v / fmaxf(pdf_v, 1e-30f);
      b = scale(b, scale_v);
      rl = scale(ru, 1.0f / fmaxf(mis_pdf, 1e-30f));
      o = s;
      d = wv;

      if (RECORD) {
        rec_put(0, rslot, s.x);
        rec_put(1, rslot, s.y);
        rec_put(2, rslot, s.z);
        rec_put(3, rslot, wv.x);
        rec_put(4, rslot, wv.y);
        rec_put(5, rslot, wv.z);
        rec_put(6, rslot, scale_v);
        rec_put(22, rslot, scale_v);
        rec_put(23, rslot, scale_v);
        rec_put(7, rslot, pdf_v);
        rec_put(18, rslot, 1.0f);
        if (depth == 1) {  // ISGB first-event data
          rec_put(14, 0, 1.0f);
          rec_put(15, 0, wo.x);
          rec_put(16, 0, wo.y);
          rec_put(17, 0, wo.z);
          rec_put(19, 0, gc[G_ALB]);
          rec_put(20, 0, gc[G_ALB + 1]);
          rec_put(21, 0, gc[G_ALB + 2]);
        }
        rslot += 1;
      }

      // arm the shadow walk of the pending NEE
      if (f_hg > 0.0f && alive) {
        mode = sel_pt ? 4 : 5;
        sh = wi;
        sh_t = 0.0f;
        sh_end = t_med;
        sh_pdf = spdf_l;
        sh_d2 = dist2;
        sh_f = f_hg / fmaxf(scale_v, 1e-30f);
        sh_fl = f_hg;
        sT = sl = su = one3;
        if (TRIS) {
          sh_occ = true;
          sh_f1 = sh_f2 = sh_f;
          if (RECORD) ra = one3;
        }
      }
      if (TRIS) {
        spec_last = false;
        t_surf = BIG;
        needs_i = true;
      }
    }

    if (TRIS && hit_s) {
      // ---- surface: the shared light sample (non-delta lobes) ------------
      const bool glossy = S.cr || S.ct;
      const V3 pl = sub(hpos, lp);
      const float dist2 = fmaxf(dot(pl, pl), 1e-12f);
      const float dist = sqrtf(dist2);
      V3 wi;
      if (sel_pt) {
        float inv_dist = 1.0f / dist;
        wi = v3(-pl.x * inv_dist, -pl.y * inv_dist, -pl.z * inv_dist);
      } else {
        float ez = 1.0f - 2.0f * up.y;
        float er = sqrtf(fmaxf(1.0f - ez * ez, 0.0f));
        float ephi = fc[F_TWO_PI] * up.z;
        wi = v3(er * cosf(ephi), er * sinf(ephi), ez);
      }
      // from a hit inside the box the shadow walk ends at the exit; from
      // one outside, at the face box_hit reports
      float t_exit_s;
      bool ent_s;
      if (outside_box(fc, hpos))
        box_hit(fc, hpos, wi, &t_exit_s, &ent_s);
      else
        t_exit_s = box_exit(fc, hpos, wi);
      const float t_med = sel_pt ? fminf(dist, t_exit_s) : t_exit_s;
      const bool use_gs = surf_guide && S.df && svalid;
      Lobes sprod;
      if (surf_guide)
        sprod = product_vmf(gc, slob, K, S.ns, gc[G_KAPPA_COS],
                            gc[G_LOG_C_COS]);
      const float cosn = dot(wi, S.ns);
      const float bpdf = fmaxf(cosn, 0.0f) * INV_PI_F;
      float spdf_srf = use_gs ? gc[G_1MPG] * bpdf +
                                    gc[G_PG] * mixture_pdf(fc, sprod, K, wi)
                              : bpdf;
      const float f_srf_nee = cosn * INV_PI_F;
      V3 fne = zero3;
      if (glossy && cosn > 0.0f) {
        const V3 wi_l = to_loc(S, wi);
        float pdf_spec;
        fne = glossy_f(S, S.wo_l, wi_l, &pdf_spec);
        const float pr_ct = frd(fabsf(S.wo_l.z), S.eta);
        spdf_srf = S.ct ? pr_ct * pdf_spec +
                              (1.0f - pr_ct) * fmaxf(cosn, 0.0f) * INV_PI_F
                        : pdf_spec;
      }

      // ---- the continuation: guided diffuse, glossy VNDF, mirror,
      // dielectric -------------------------------------------------------
      V3 t1, t2;
      coord_system(S.ns, &t1, &t2);
      const float r_cs = sqrtf(u_s.x);
      const float phi_cs = fc[F_TWO_PI] * u_s.y;
      const float lx = r_cs * cosf(phi_cs), ly = r_cs * sinf(phi_cs);
      const float lz = sqrtf(fmaxf(1.0f - u_s.x, 0.0f));
      const V3 wdf = v3(lx * t1.x + ly * t2.x + lz * S.ns.x,
                        lx * t1.y + ly * t2.y + lz * S.ns.y,
                        lx * t1.z + ly * t2.z + lz * S.ns.z);
      const float pdf_df = fmaxf(lz, 1e-6f) * INV_PI_F;
      V3 ws = wdf;
      float pdf_sv = pdf_df, mis_pdf_s = pdf_df;
      bool valid_sv = pdf_df > 0.0f;
      if (surf_guide) {
        if (!RIS) {
          const float u_c = u_c4.x;
          const bool take = use_gs && u_c < gc[G_PG];
          const float u_lob = clampf(u_c / gc[G_PG_SAFE], 0.0f, 0.999999f);
          float gpdf;
          const V3 gw = mixture_sample(fc, sprod, K, u_lob, u_c4.y, u_c4.z,
                                       &gpdf);
          ws = take ? gw : wdf;
          const float base =
              take ? fmaxf(dot(gw, S.ns), 0.0f) * INV_PI_F : pdf_df;
          const float guide_ = take ? gpdf : mixture_pdf(fc, sprod, K, wdf);
          pdf_sv = use_gs ? gc[G_1MPG] * base + gc[G_PG] * guide_ : pdf_df;
          mis_pdf_s = pdf_sv;
          valid_sv = ((take && base > 0.0f) || (!take && pdf_df > 0.0f)) &&
                     pdf_sv > 0.0f;
        } else {
          float gpdf;
          const V3 gw =
              mixture_sample(fc, sprod, K, u_c4.y, u_p.w, u_p.z, &gpdf);
          const float bpdf_g = fmaxf(dot(gw, S.ns), 0.0f) * INV_PI_F;
          const float gpdf_b = mixture_pdf(fc, sprod, K, wdf);
          const float irp_b =
              svalid ? mixture_pdf(fc, slob, K, wdf) : INV_4PI_F;
          const float irp_g = svalid ? mixture_pdf(fc, slob, K, gw) : INV_4PI_F;
          const float mis0 = 0.5f * (pdf_df + gpdf_b);
          const float mis1 = 0.5f * (bpdf_g + gpdf);
          const float w0 =
              pdf_df > 0.0f ? pdf_df * (gc[G_RIS_C0] + gc[G_PG] * irp_b) /
                                  fmaxf(mis0, 1e-20f)
                            : 0.0f;
          const float w1 =
              bpdf_g > 0.0f ? bpdf_g * (gc[G_RIS_C0] + gc[G_PG] * irp_g) /
                                  fmaxf(mis1, 1e-20f)
                            : 0.0f;
          const float sum_w = w0 + w1;
          const bool pick1 = u_c4.x * fmaxf(sum_w, 1e-20f) > w0;
          const float mis_sel = pick1 ? mis1 : mis0;
          const float pdf_ris =
              (pick1 ? w1 : w0) * mis_sel * 2.0f / fmaxf(sum_w, 1e-20f);
          ws = use_gs ? (pick1 ? gw : wdf) : wdf;
          pdf_sv = use_gs ? pdf_ris : pdf_df;
          mis_pdf_s = use_gs ? mis_sel : pdf_df;
          valid_sv = use_gs ? (sum_w > 0.0f && pdf_ris > 0.0f) : pdf_df > 0.0f;
        }
      }
      const float cos_out = fmaxf(dot(ws, S.ns), 0.0f);
      float s_df = cos_out * INV_PI_F / fmaxf(pdf_sv, 1e-30f);
      // an invalid guided draw keeps the lane with a vanishing weight, so
      // that the pending surface NEE folds the exact product
      if (S.df && !valid_sv) s_df = TINY_G;
      V3 n_d, w_b;
      float inv_mis_s = 1.0f / fmaxf(mis_pdf_s, 1e-30f);
      float pdf_gs = 0.0f;
      if (glossy) {
        // Trowbridge-Reitz visible-normal draw (unguided); CookTorrance
        // picks its glossy or diffuse lobe by Fresnel
        const V3 wo_l = S.wo_l;
        const float a = S.alpha;
        V3 wh = normalize(v3(a * wo_l.x, a * wo_l.y, wo_l.z));
        const float sgh = wh.z < 0.0f ? -1.0f : 1.0f;
        wh = v3(wh.x * sgh, wh.y * sgh, wh.z * sgh);
        const float tlen = sqrtf(fmaxf(wh.x * wh.x + wh.y * wh.y, 1e-18f));
        const bool big_z = wh.z > 0.999999f;
        const float t1hx = big_z ? 1.0f : -wh.y / tlen;
        const float t1hy = big_z ? 0.0f : wh.x / tlen;
        const float t2hx = -wh.z * t1hy, t2hy = wh.z * t1hx;
        const float t2hz = wh.x * t1hy - wh.y * t1hx;
        const float r_d = sqrtf(u_r.x);
        const float ph_d = fc[F_TWO_PI] * u_r.y;
        const float px_d = r_d * cosf(ph_d);
        float py_d = r_d * sinf(ph_d);
        const float h_d = sqrtf(fmaxf(1.0f - px_d * px_d, 0.0f));
        const float mixz = (1.0f + wh.z) * 0.5f;
        py_d = mixz * py_d + (1.0f - mixz) * h_d;
        const float pz_d = sqrtf(fmaxf(1.0f - px_d * px_d - py_d * py_d, 0.0f));
        const float nhx = px_d * t1hx + py_d * t2hx + pz_d * wh.x;
        const float nhy = px_d * t1hy + py_d * t2hy + pz_d * wh.y;
        const float nhz = px_d * 0.0f + py_d * t2hz + pz_d * wh.z;
        const V3 wm = normalize(v3(a * nhx, a * nhy, fmaxf(nhz, 1e-6f)));
        const float owm = dot(wo_l, wm);
        const float pr_s = frd(fabsf(wo_l.z), S.eta);
        const bool take_spec = S.cr || (S.ct && u_r.z < pr_s);
        const V3 wi_gl = take_spec ? v3(2.0f * owm * wm.x - wo_l.x,
                                        2.0f * owm * wm.y - wo_l.y,
                                        2.0f * owm * wm.z - wo_l.z)
                                   : v3(lx, ly, lz);
        const float ziL = wi_gl.z;
        float pdf_spec;
        const V3 fg = glossy_f(S, wo_l, wi_gl, &pdf_spec);
        const float zi_c = fmaxf(fabsf(ziL), 1e-6f);
        pdf_gs = S.ct ? pr_s * pdf_spec + (1.0f - pr_s) * zi_c * INV_PI_F
                      : pdf_spec;
        const bool valid_g = ziL > 1e-6f && pdf_gs > 1e-12f;
        pdf_gs = fmaxf(pdf_gs, 1e-12f);
        const float inv_pgs = 1.0f / pdf_gs;
        w_b = valid_g ? v3(fg.x * ziL * inv_pgs, fg.y * ziL * inv_pgs,
                           fg.z * ziL * inv_pgs)
                      : v3(TINY_G, TINY_G, TINY_G);
        n_d = v3(wi_gl.x * S.g1.x + wi_gl.y * S.g2.x + wi_gl.z * S.ns.x,
                 wi_gl.x * S.g1.y + wi_gl.y * S.g2.y + wi_gl.z * S.ns.y,
                 wi_gl.x * S.g1.z + wi_gl.y * S.g2.z + wi_gl.z * S.ns.z);
        inv_mis_s = inv_pgs;
      } else if (S.df) {
        n_d = ws;
        w_b = v3(S.alb.x * s_df, S.alb.y * s_df, S.alb.z * s_df);
      } else {
        // conductor: mirror about ns, Schlick tint; dielectric: the Fresnel
        // pick of reflection or refraction
        const float dnd = dot(d, S.ns);
        const float cos_o = clampf(-dnd, 0.0f, 1.0f);
        const float eta_rel = S.front ? S.eta : 1.0f / S.eta;
        const float sin2_t = fmaxf(1.0f - cos_o * cos_o, 0.0f) /
                             fmaxf(eta_rel * eta_rel, 1e-12f);
        const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
        const float r_par = (eta_rel * cos_o - cos_t) /
                            fmaxf(eta_rel * cos_o + cos_t, 1e-12f);
        const float r_per = (cos_o - eta_rel * cos_t) /
                            fmaxf(cos_o + eta_rel * cos_t, 1e-12f);
        const float F_dl =
            sin2_t >= 1.0f ? 1.0f : 0.5f * (r_par * r_par + r_per * r_per);
        const bool refl_dl = u_s.z < F_dl;
        const float inv_er = 1.0f / fmaxf(eta_rel, 1e-12f);
        if (S.co || refl_dl) {
          const float c2 = 2.0f * dnd;
          n_d = v3(d.x - c2 * S.ns.x, d.y - c2 * S.ns.y, d.z - c2 * S.ns.z);
        } else {
          const float k = cos_o * inv_er - cos_t;
          n_d = normalize(v3(d.x * inv_er + k * S.ns.x,
                             d.y * inv_er + k * S.ns.y,
                             d.z * inv_er + k * S.ns.z));
        }
        if (S.co) {
          const float omc5 = pow5(1.0f - cos_o);
          w_b = v3(S.alb.x + (1.0f - S.alb.x) * omc5,
                   S.alb.y + (1.0f - S.alb.y) * omc5,
                   S.alb.z + (1.0f - S.alb.z) * omc5);
        } else {
          const float wt = refl_dl ? 1.0f : inv_er * inv_er;
          w_b = v3(wt, wt, wt);
          // a transmission switches to the far side's medium
          if (!refl_dl) med = S.front ? hmi : hmo;
        }
      }
      const bool nondelta = S.df || glossy;
      b = mul(b, w_b);
      rl = nondelta ? scale(ru, inv_mis_s) : ru;
      const float out_sgn = dot(n_d, S.ns) >= 0.0f ? 1.0f : -1.0f;
      o = v3(hpos.x + out_sgn * 1e-4f * S.ns.x,
             hpos.y + out_sgn * 1e-4f * S.ns.y,
             hpos.z + out_sgn * 1e-4f * S.ns.z);
      d = n_d;
      spec_last = !nondelta;
      t_surf = BIG;
      needs_i = true;
      // guided RR from the surface half's flux; delta lanes survive at 0.95
      float surv_s;
      if (guide_rr) {
        float num_rs = b.x * sflux.x * 0.2126f + b.y * sflux.y * 0.7152f +
                       b.z * sflux.z * 0.0722f;
        surv_s = (svalid && ipem > 0.0f)
                     ? clampf(num_rs / fmaxf(ipel, 1e-6f), 0.1f, 1.0f)
                     : 1.0f;
        if (S.co || S.dl) surv_s = 0.95f;
      } else {
        surv_s = clampf(max3(b) / fmaxf(avg3(ru), 1e-30f), 0.0f, 1.0f);
      }
      if (depth > min_rr_depth) rr_srv = surv_s;

      if (RECORD) {
        if (nondelta) {  // delta bounces are not recorded
          const V3 rw = glossy ? n_d : ws;
          rec_put(0, rslot, hpos.x);
          rec_put(1, rslot, hpos.y);
          rec_put(2, rslot, hpos.z);
          rec_put(3, rslot, rw.x);
          rec_put(4, rslot, rw.y);
          rec_put(5, rslot, rw.z);
          rec_put(6, rslot, w_b.x);
          rec_put(22, rslot, w_b.y);
          rec_put(23, rslot, w_b.z);
          rec_put(7, rslot, glossy ? pdf_gs : pdf_sv);
          rec_put(18, rslot, 0.0f);
        }
        if (depth == 1) {  // ISGB first-event data
          rec_put(15, 0, S.ns.x);
          rec_put(16, 0, S.ns.y);
          rec_put(17, 0, S.ns.z);
          rec_put(19, 0, S.alb.x);
          rec_put(20, 0, S.alb.y);
          rec_put(21, 0, S.alb.z);
        }
        if (nondelta) rslot += 1;
      }

      // arm the shadow walk of the surface NEE: it folds with the continued
      // beta, so a diffuse fold is (cos/pi) / s_df and a glossy one f cos /
      // w_b per channel
      const bool nee_gs = S.df && cosn > 0.0f && alive;
      const bool nee_gl = glossy && cosn > 0.0f && alive;
      if (nee_gs || nee_gl) {
        mode = sel_pt ? 4 : 5;
        sh = wi;
        sh_t = 0.0f;
        sh_end = t_med;
        sh_pdf = spdf_srf;
        sh_d2 = dist2;
        sh_occ = true;
        if (nee_gs) {
          sh_f = f_srf_nee / fmaxf(s_df, 1e-30f);
          sh_f1 = sh_f2 = sh_f;
          sh_fl = f_srf_nee;
          if (RECORD) ra = S.alb;
        } else {
          sh_f = fne.x * cosn / fmaxf(w_b.x, 1e-30f);
          sh_f1 = fne.y * cosn / fmaxf(w_b.y, 1e-30f);
          sh_f2 = fne.z * cosn / fmaxf(w_b.z, 1e-30f);
          sh_fl = cosn;
          if (RECORD) ra = fne;
        }
        sT = sl = su = one3;
      }
    }

    // ---- an item ends with its path or at its iteration cap ---------------
    if (!(isfinite(L.x) && isfinite(L.y) && isfinite(L.z))) L = zero3;
    it += 1;
    if (alive && it < max_iters) continue;
    if (alive && at_cap != nullptr) atomicAdd(at_cap, 1);
    const V3 Li = alive ? zero3 : L;
    const long long n_it = alive ? max_iters + 1 : it;
    if constexpr (RECORD) {
      out[3 * pix_i + 0] = (0.0f + Li.x) * out_scale;
      out[3 * pix_i + 1] = (0.0f + Li.y) * out_scale;
      out[3 * pix_i + 2] = (0.0f + Li.z) * out_scale;
      item = take_items(next_item);
    } else {
      out[3 * item + 0] = Li.x;
      out[3 * item + 1] = Li.y;
      out[3 * item + 2] = Li.z;
      n_iter[item] = (int)n_it;  // the wrapper keeps max_iters < 2^31 - 1
      item = (long long)atomicAdd(next_item, 1ull);
    }
    if (item >= n_items) return;
    begin();
    it = 0;
  }
}

// B3's ordered per-sample sum of one chunk of samples: thread i (a pixel
// channel) adds the chunk's n_samp radiances of its channel in sample
// order, acc = acc + L[s], from acc = 0 on the first chunk and from the
// running sum in out on later ones, and multiplies by out_scale after the
// last chunk: the order and rounding of the per-pixel loop's sum. The
// per-pixel loop runs a pixel's samples in turn within one cap of
// max_iters iterations and loses the sample the cap cuts and every later
// one, so a sample counts only while the pixel's running iteration total
// (`used`, carried from chunk to chunk) stays within max_iters. So the
// image is the same float for float. With n_iter null (the grid kernel of
// volpath_grid.cuh, which has no such cap) every sample counts and `used`
// is not read.
__global__ void __launch_bounds__(256)
    vspg_reduce_kernel(const float* __restrict__ lbuf,
                       const int* __restrict__ n_iter, float* __restrict__ out,
                       int* __restrict__ used, int npix, int n_samp,
                       int max_iters, float out_scale, int first, int last) {
  const int n3 = 3 * npix;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n3) return;
  const int p = i / 3;
  float acc = first ? 0.0f : out[i];
  if (n_iter == nullptr) {
    for (int s = 0; s < n_samp; ++s) acc = acc + lbuf[(size_t)s * n3 + i];
  } else {
    long long u = first ? 0 : used[i];
    for (int s = 0; s < n_samp; ++s) {
      u += n_iter[(size_t)s * npix + p];
      if (u > max_iters) break;
      acc = acc + lbuf[(size_t)s * n3 + i];
    }
    used[i] = (int)min(u, (long long)max_iters + 1);
  }
  out[i] = last ? acc * out_scale : acc;
}

namespace {

// the arguments of one launch of vspg_kernel
struct Args {
  const float *fconst;
  const int *iconst;
  const float *gconst;
  const int *giconst;
  const float *density, *majorant, *ftab, *itab;
  const int* cells;
  const float *tris, *mats;
  float* out;
  int* n_iter;
  float* rec;
  unsigned long long* next_item;
  int* at_cap;
  int npix, pix_base, spp, samp0;
  long long n_items;
  unsigned int seed;
  float out_scale;
  int nmaj, rec_depth, n_tri, n_mat;
};

// one instantiation: its launch, and its resident blocks an SM (from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor at the first call's shared
// memory, then cached: registers bound it, the shared memory of 4 blocks is
// at most ~100 KB) with its registers and local memory
template <bool RECORD, bool RIS, int METHOD, bool TRIS>
struct Inst {
  static void launch(int blocks, size_t smem, cudaStream_t st,
                     const Args& a) {
    vspg_kernel<RECORD, RIS, METHOD, TRIS><<<blocks, THREADS, smem, st>>>(
        a.fconst, a.iconst, a.gconst, a.giconst, a.density, a.majorant,
        a.ftab, a.itab, a.cells, a.tris, a.mats, a.out, a.n_iter, a.rec,
        a.next_item,
        a.at_cap, a.npix, a.pix_base, a.spp, a.samp0, a.n_items, a.seed,
        a.out_scale,
        a.nmaj, a.rec_depth, a.n_tri, a.n_mat);
  }
  static cudaError_t info(size_t smem, int* out4) {
    static int cache[3] = {0, 0, 0};
    return persistent_grid(
        (const void*)vspg_kernel<RECORD, RIS, METHOD, TRIS>, THREADS, smem,
        cache, out4);
  }
};

struct InstFns {
  void (*launch)(int, size_t, cudaStream_t, const Args&);
  cudaError_t (*info)(size_t, int*);
};

template <bool RECORD, bool RIS, int METHOD, bool TRIS>
constexpr InstFns fns() {
  return {Inst<RECORD, RIS, METHOD, TRIS>::launch,
          Inst<RECORD, RIS, METHOD, TRIS>::info};
}

// one of the 24 instantiations, by variant, direction mode, distance route
// and whether the scene has triangles
template <bool RECORD, bool RIS, bool TRIS>
InstFns pick_method(int method) {
  return method == M_NDS_PLUS ? fns<RECORD, RIS, M_NDS_PLUS, TRIS>()
         : method == M_NDS    ? fns<RECORD, RIS, M_NDS, TRIS>()
                              : fns<RECORD, RIS, M_RESAMPLING, TRIS>();
}

template <bool RECORD, bool TRIS>
InstFns pick(int ris, int method) {
  return ris ? pick_method<RECORD, true, TRIS>(method)
             : pick_method<RECORD, false, TRIS>(method);
}

template <bool RECORD>
InstFns pick(int ris, int method, int n_tri) {
  return n_tri > 0 ? pick<RECORD, true>(ris, method)
                   : pick<RECORD, false>(ris, method);
}

// the dynamic shared memory: the majorant grid, then the triangle and
// material tables of a TRIS instantiation
size_t smem_bytes(int nmaj, int n_tri, int n_mat) {
  return (size_t)(nmaj + n_tri * TRI_COLS + (n_tri > 0 ? n_mat : 0) *
                                               MAT_COLS) *
         sizeof(float);
}

bool bad_args(int method, int n_tri, int n_mat) {
  return method < M_RESAMPLING || method > M_NDS_PLUS || n_tri < 0 ||
         n_tri > MAX_TRIS || (n_tri > 0 && (n_mat < 1 || n_mat > 16));
}

// the grid of `blocks` persistent blocks, 0 for the SMs times the
// instantiation's resident blocks an SM
cudaError_t persistent_blocks(const InstFns& f, size_t smem, int* blocks) {
  if (*blocks != 0) return cudaSuccess;
  int g[4];
  cudaError_t e = f.info(smem, g);
  if (e == cudaSuccess) *blocks = g[0] * g[1];
  return e;
}

}  // namespace

// B3a-d, one chunk of samples: the n_samp samples from samp0 of every
// pixel as npix * n_samp work items on `blocks` persistent blocks (0: the
// SMs times the instantiation's resident blocks an SM); each item's
// radiance goes to lbuf (n_samp, npix, 3) and its iterations to nbuf
// (n_samp, npix). next_item (zeroed by the caller) hands out the items;
// at_cap counts the items that reached the iteration cap of the whole
// pixel, spp * max_events * 12. The npix pixels are those of the image
// from pix_base on (0: the whole image; a row block's first pixel
// otherwise).
extern "C" int vspg_render_launch(
    const float* fconst, const int* iconst, const float* gconst,
    const int* giconst, const float* density, const float* majorant,
    const float* ftab, const float* itab, const int* cells, const float* tris,
    const float* mats, float* lbuf, int* nbuf, unsigned long long* next_item,
    int* at_cap, int npix, int pix_base, int spp, int samp0, int n_samp,
    unsigned int seed, int nmaj, int ris, int method, int n_tri, int n_mat,
    int blocks, void* stream) {
  if (bad_args(method, n_tri, n_mat) || npix < 1 || n_samp < 1 ||
      blocks < 0 || samp0 < 0 || samp0 + n_samp > spp || pix_base < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(nmaj, n_tri, n_mat);
  const InstFns f = pick<false>(ris, method, n_tri);
  const cudaError_t e = persistent_blocks(f, smem, &blocks);
  if (e != cudaSuccess) return (int)e;
  const Args a = {fconst, iconst, gconst, giconst, density, majorant, ftab,
                  itab, cells, tris, mats, lbuf, nbuf, nullptr, next_item,
                  at_cap, npix, pix_base, spp, samp0, (long long)npix * n_samp,
                  seed, 1.0f, nmaj, 0, n_tri, n_tri > 0 ? n_mat : 0};
  f.launch(blocks, smem, (cudaStream_t)stream, a);
  return (int)cudaGetLastError();
}

// the render instantiation's grid: out4 = [resident blocks an SM, SMs,
// registers a thread, local memory bytes a thread]
extern "C" int vspg_render_info(int ris, int method, int n_tri, int nmaj,
                                int n_mat, int* out4) {
  if (bad_args(method, n_tri, n_mat)) return (int)cudaErrorInvalidValue;
  return (int)pick<false>(ris, method, n_tri)
      .info(smem_bytes(nmaj, n_tri, n_mat), out4);
}

// B3a-d's ordered sum of one chunk: out (npix, 3) = (acc + the n_samp
// radiances of lbuf in sample order while the pixel's iterations, counted
// in nbuf (n_samp, npix) and carried in used (npix, 3), stay within
// max_iters) [* out_scale after the last chunk]; with nbuf null (B2a-c)
// every sample, used and max_iters unread
extern "C" int vspg_reduce_launch(const float* lbuf, const int* nbuf,
                                  float* out, int* used, int npix, int n_samp,
                                  int max_iters, float out_scale, int first,
                                  int last, void* stream) {
  if (npix < 1 || n_samp < 1 ||
      (nbuf != nullptr && (max_iters < 1 || used == nullptr)))
    return (int)cudaErrorInvalidValue;
  vspg_reduce_kernel<<<(3 * npix + 255) / 256, 256, 0,
                       (cudaStream_t)stream>>>(lbuf, nbuf, out, used, npix,
                                               n_samp, max_iters, out_scale,
                                               first, last);
  return (int)cudaGetLastError();
}

#ifndef VSPG_RENDER_ONLY  // builds that time the render variant alone
// B4a-d: one training sample per pixel plus its record rows, the npix
// pixels as work items on `blocks` persistent blocks (0: the SMs times the
// instantiation's resident blocks an SM); next_item (zeroed by the caller)
// hands them out a warp's worth at a time, and at_cap counts the pixels
// that reached the iteration cap, max_events * 12.
extern "C" int vspg_record_launch(
    const float* fconst, const int* iconst, const float* gconst,
    const int* giconst, const float* density, const float* majorant,
    const float* ftab, const float* itab, const int* cells, const float* tris,
    const float* mats, float* out, float* rec, unsigned long long* next_item,
    int* at_cap, int npix, unsigned int seed, float out_scale, int nmaj,
    int rec_depth, int ris, int method, int n_tri, int n_mat, int blocks,
    void* stream) {
  if (bad_args(method, n_tri, n_mat) || npix < 1 || rec_depth < 1 ||
      blocks < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(nmaj, n_tri, n_mat);
  const InstFns f = pick<true>(ris, method, n_tri);
  const cudaError_t e = persistent_blocks(f, smem, &blocks);
  if (e != cudaSuccess) return (int)e;
  const Args a = {fconst, iconst, gconst, giconst, density, majorant, ftab,
                  itab, cells, tris, mats, out, nullptr, rec, next_item,
                  at_cap, npix, 0, 1, 0, npix, seed, out_scale, nmaj,
                  rec_depth, n_tri, n_tri > 0 ? n_mat : 0};
  f.launch(blocks, smem, (cudaStream_t)stream, a);
  return (int)cudaGetLastError();
}

// the record instantiation's grid: out4 as vspg_render_info's
extern "C" int vspg_record_info(int ris, int method, int n_tri, int nmaj,
                                int n_mat, int* out4) {
  if (bad_args(method, n_tri, n_mat)) return (int)cudaErrorInvalidValue;
  return (int)pick<true>(ris, method, n_tri)
      .info(smem_bytes(nmaj, n_tri, n_mat), out4);
}
#endif
