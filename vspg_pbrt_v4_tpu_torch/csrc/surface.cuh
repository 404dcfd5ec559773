// BSDFs of the teaser materials for the volpath grid kernel (B2b), in the
// local shading frame (z = normal; wo and wi point away from the surface):
// diffuse, smooth and Trowbridge-Reitz rough conductor, smooth dielectric
// and CookTorrance. Each function follows its counterpart in
// models/materials.py (the JAX package's formulas in their operation
// order), which the plain version of the kernel calls.
#pragma once

#include "common.cuh"

namespace vp {

// material table, one row of MAT_COLS floats per material
// (ops/volpath_kernels.py M_*)
enum MatCol {
  M_KIND = 0,   // 0 diffuse, 1 conductor, 2 dielectric, 11 CookTorrance
  M_ALB = 1,    // albedo / conductor F0 (3)
  M_ETA = 4,
  M_ROUGH = 5,  // Trowbridge-Reitz alpha
  M_TEX = 6,    // albedo texture: -1 none, 1 checker
  M_C0 = 7,     // checker colours (3 each)
  M_C1 = 10,
  M_UVS = 13,   // checker uv scale (2)
  MAT_COLS = 16
};
constexpr int MAX_MATS = 16;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float INV_PI_F = (float)(1.0 / 3.14159265358979323846);
constexpr float SMOOTH = 1e-3f;

struct Mat {
  int kind;
  V3 alb;
  float eta, rough;
};

// the material of triangle row r hit at barycentrics (b1, b2), its checker
// albedo evaluated at the interpolated uv
static __device__ __forceinline__ Mat surface_mat(const float* mats,
                                                  const float* r, float b1,
                                                  float b2) {
  const float* m = mats + (int)r[T_MAT] * MAT_COLS;
  Mat out;
  out.kind = (int)m[M_KIND];
  out.alb = v3(m + M_ALB);
  out.eta = m[M_ETA];
  out.rough = m[M_ROUGH];
  if (m[M_TEX] == 1.0f) {
    float b0 = 1.0f - b1 - b2;
    float u = b0 * r[T_UV0] + b1 * r[T_UV1] + b2 * r[T_UV2];
    float v = b0 * r[T_UV0 + 1] + b1 * r[T_UV1 + 1] + b2 * r[T_UV2 + 1];
    int par = (int)(floorf(u * m[M_UVS]) + floorf(v * m[M_UVS + 1])) % 2;
    out.alb = par != 0 ? v3(m + M_C1) : v3(m + M_C0);
  }
  return out;
}

static __device__ __forceinline__ bool is_specular(const Mat& m) {
  return m.rough < SMOOTH && (m.kind == 1 || m.kind == 2);
}

static __device__ __forceinline__ float sqrf(float x) { return x * x; }
static __device__ __forceinline__ float safe_sqrtf(float x) {
  return sqrtf(fmaxf(x, 0.0f));
}
static __device__ __forceinline__ float safe_div(float a, float b,
                                                 float fill) {
  return b != 0.0f ? a / b : fill;
}
static __device__ __forceinline__ V3 normalize_safe(V3 v) {
  float n = sqrtf(dot(v, v));
  return scale(v, n != 0.0f ? 1.0f / n : 0.0f);
}
static __device__ __forceinline__ float pow5(float m) {
  float m2 = m * m;
  return m * (m2 * m2);
}

static __device__ __forceinline__ float fresnel_dielectric(float cos_i,
                                                           float eta) {
  cos_i = fminf(fmaxf(cos_i, -1.0f), 1.0f);
  float eta_e = cos_i < 0.0f ? 1.0f / eta : eta;
  float ci = fabsf(cos_i);
  float sin2_t = (1.0f - ci * ci) / (eta_e * eta_e);
  float cos_t = safe_sqrtf(1.0f - sin2_t);
  float r_parl = safe_div(eta_e * ci - cos_t, eta_e * ci + cos_t, 0.0f);
  float r_perp = safe_div(ci - eta_e * cos_t, ci + eta_e * cos_t, 0.0f);
  float F = 0.5f * (r_parl * r_parl + r_perp * r_perp);
  return sin2_t >= 1.0f ? 1.0f : F;
}

static __device__ __forceinline__ V3 fresnel_schlick(float cos_i, V3 f0) {
  float m5 = pow5(fminf(fmaxf(1.0f - fabsf(cos_i), 0.0f), 1.0f));
  return v3(f0.x + (1.0f - f0.x) * m5, f0.y + (1.0f - f0.y) * m5,
            f0.z + (1.0f - f0.z) * m5);
}

static __device__ __forceinline__ float tan2_theta(V3 w) {
  float c2 = w.z * w.z;
  return safe_div(fmaxf(1.0f - c2, 0.0f), c2, INFINITY);
}

static __device__ __forceinline__ float tr_d(V3 wm, float alpha) {
  float t2 = tan2_theta(wm);
  float c4 = sqrf(sqrf(wm.z));
  float e = t2 / (alpha * alpha);
  return isfinite(t2)
             ? safe_div(1.0f, PI_F * (alpha * alpha) * c4 * sqrf(1.0f + e),
                        0.0f)
             : 0.0f;
}

static __device__ __forceinline__ float tr_lambda(V3 w, float alpha) {
  float t2 = tan2_theta(w);
  return isfinite(t2) ? 0.5f * (safe_sqrtf(1.0f + alpha * alpha * t2) - 1.0f)
                      : 0.0f;
}

static __device__ __forceinline__ float tr_g(V3 wo, V3 wi, float alpha) {
  return 1.0f / (1.0f + tr_lambda(wo, alpha) + tr_lambda(wi, alpha));
}

static __device__ __forceinline__ float tr_d_visible(V3 w, V3 wm,
                                                     float alpha) {
  float g1 = 1.0f / (1.0f + tr_lambda(w, alpha));
  return g1 / fmaxf(fabsf(w.z), 1e-8f) * tr_d(wm, alpha) * fabsf(dot(w, wm));
}

static __device__ __forceinline__ V3 tr_sample_wm(V3 w, float alpha, float u0,
                                                  float u1) {
  V3 wh = normalize_safe(v3(alpha * w.x, alpha * w.y, w.z));
  if (wh.z < 0.0f) wh = scale(wh, -1.0f);
  V3 t1 = wh.z < 0.999999f ? normalize_safe(v3(-wh.y, wh.x, 0.0f))
                           : v3(1.0f, 0.0f, 0.0f);
  V3 t2 = v3(wh.y * t1.z - wh.z * t1.y, wh.z * t1.x - wh.x * t1.z,
             wh.x * t1.y - wh.y * t1.x);
  float r = sqrtf(u0);
  float th = 2.0f * PI_F * u1;
  float px = r * cosf(th), py = r * sinf(th);
  float h = safe_sqrtf(1.0f - px * px);
  float half = (1.0f + wh.z) / 2.0f;
  py = half * py + (1.0f - half) * h;
  float pz = safe_sqrtf(1.0f - px * px - py * py);
  V3 nh = v3(px * t1.x + py * t2.x + pz * wh.x,
             px * t1.y + py * t2.y + pz * wh.y,
             px * t1.z + py * t2.z + pz * wh.z);
  return normalize_safe(
      v3(alpha * nh.x, alpha * nh.y, fmaxf(nh.z, 1e-6f)));
}

static __device__ __forceinline__ V3 half_vector(V3 wo, V3 wi) {
  V3 wm = normalize_safe(add(wi, wo));
  return wm.z < 0.0f ? scale(wm, -1.0f) : wm;
}

static __device__ __forceinline__ V3 reflect(V3 wo, V3 wm) {
  float c = 2.0f * dot(wo, wm);
  return v3(-wo.x + c * wm.x, -wo.y + c * wm.y, -wo.z + c * wm.z);
}

// BSDF value, delta lobes excluded
static __device__ V3 bsdf_f(const Mat& m, V3 wo, V3 wi) {
  V3 zero = v3(0.f, 0.f, 0.f);
  if (!(wo.z * wi.z > 0.0f)) return zero;
  if (m.kind == 0) return scale(m.alb, INV_PI_F);
  V3 wm = add(wi, wo);
  if (!(dot(wm, wm) > 1e-18f)) return zero;
  wm = normalize_safe(wm);
  if (wm.z < 0.0f) wm = scale(wm, -1.0f);
  if (m.kind == 1 && m.rough >= SMOOTH) {
    float alpha = fmaxf(m.rough, 1e-4f);
    V3 F = fresnel_schlick(dot(wo, wm), m.alb);
    float denom = 4.0f * fabsf(wo.z) * fabsf(wi.z);
    float D = tr_d(wm, alpha), G = tr_g(wo, wi, alpha);
    float s = safe_div(1.0f, denom, 0.0f);
    return v3(D * F.x * G * s, D * F.y * G * s, D * F.z * G * s);
  }
  if (m.kind == 11) {
    float a = fmaxf(m.rough, 1e-3f);
    float F = fresnel_dielectric(dot(wo, wm), m.eta);
    float spec = tr_d(wm, a) * tr_g(wo, wi, a) * F *
                 safe_div(1.0f, fabsf(4.0f * wo.z * wi.z), 0.0f);
    float kd = INV_PI_F * (1.0f - F);
    return v3(spec + m.alb.x * kd, spec + m.alb.y * kd, spec + m.alb.z * kd);
  }
  return zero;
}

// sampling pdf of wi given wo, delta lobes excluded
static __device__ float bsdf_pdf(const Mat& m, V3 wo, V3 wi) {
  if (!(wo.z * wi.z > 0.0f)) return 0.0f;
  if (m.kind == 0) return fabsf(wi.z) * INV_PI_F;
  V3 wm = half_vector(wo, wi);
  if (m.kind == 1 && m.rough >= SMOOTH) {
    float alpha = fmaxf(m.rough, 1e-4f);
    return safe_div(tr_d_visible(wo, wm, alpha), 4.0f * fabsf(dot(wo, wm)),
                    0.0f);
  }
  if (m.kind == 11) {
    float a = fmaxf(m.rough, 1e-3f);
    float pr = fresnel_dielectric(fabsf(wo.z), m.eta);
    return pr * safe_div(tr_d_visible(wo, wm, a), 4.0f * fabsf(dot(wo, wm)),
                         0.0f) +
           (1.0f - pr) * (fabsf(wi.z) * INV_PI_F);
  }
  return 0.0f;
}

struct BSample {
  V3 wi, f;
  float pdf, eta;
  bool specular, transmission, valid;
};

static __device__ __forceinline__ V3 cosine_hemisphere(float u0, float u1) {
  float ox = 2.0f * u0 - 1.0f, oy = 2.0f * u1 - 1.0f;
  float px = 0.0f, py = 0.0f;
  if (!(ox == 0.0f && oy == 0.0f)) {
    bool use_x = fabsf(ox) > fabsf(oy);
    float r = use_x ? ox : oy;
    float theta = use_x ? (PI_F / 4.0f) * safe_div(oy, ox, 0.0f)
                        : (PI_F / 2.0f) - (PI_F / 4.0f) * safe_div(ox, oy, 0.0f);
    px = r * cosf(theta);
    py = r * sinf(theta);
  }
  return v3(px, py, safe_sqrtf(1.0f - px * px - py * py));
}

// wi ~ BSDF (bsdf_sample): delta lobes return pdf 1 (the Fresnel pick for
// the dielectric) and f = weight / |cos wi|
static __device__ BSample bsdf_sample(const Mat& m, V3 wo, float u_lobe,
                                      float u0, float u1) {
  BSample s;
  s.wi = v3(0.f, 0.f, 0.f);
  s.f = v3(0.f, 0.f, 0.f);
  s.pdf = 0.0f;
  s.eta = 1.0f;
  s.specular = false;
  s.transmission = false;
  s.valid = false;
  bool flip = wo.z < 0.0f;
  V3 wi_d = cosine_hemisphere(u0, u1);
  if (flip) wi_d.z = -wi_d.z;
  V3 wo_up = flip ? scale(wo, -1.0f) : wo;
  if (m.kind == 0) {
    s.wi = wi_d;
    s.f = scale(m.alb, INV_PI_F);
    s.pdf = fabsf(wi_d.z) * INV_PI_F;
    s.valid = s.pdf > 0.0f;
  } else if (m.kind == 1 && m.rough < SMOOTH) {
    s.wi = v3(-wo.x, -wo.y, wo.z);
    s.f = scale(fresnel_schlick(fabsf(wo.z), m.alb),
                safe_div(1.0f, fabsf(s.wi.z), 0.0f));
    s.pdf = 1.0f;
    s.specular = true;
    s.valid = fabsf(wo.z) > 0.0f;
  } else if (m.kind == 1) {
    float alpha = fmaxf(m.rough, 1e-4f);
    V3 wm = tr_sample_wm(wo_up, alpha, u0, u1);
    if (flip) wm = scale(wm, -1.0f);
    V3 wi = reflect(wo, wm);
    V3 wm_up = flip ? scale(wm, -1.0f) : wm;
    s.pdf = safe_div(tr_d_visible(wo_up, wm_up, alpha),
                     4.0f * fabsf(dot(wo, wm)), 0.0f);
    V3 F = fresnel_schlick(dot(wo, wm), m.alb);
    float D = tr_d(wm_up, alpha);
    float G = tr_g(wo_up, flip ? scale(wi, -1.0f) : wi, alpha);
    float sc = safe_div(1.0f, 4.0f * fabsf(wo.z) * fabsf(wi.z), 0.0f);
    s.f = v3(D * F.x * G * sc, D * F.y * G * sc, D * F.z * G * sc);
    s.wi = wi;
    s.valid = wo.z * wi.z > 0.0f && s.pdf > 0.0f;
  } else if (m.kind == 2) {
    float F = fresnel_dielectric(wo.z, m.eta);
    if (u_lobe < F) {
      s.wi = v3(-wo.x, -wo.y, wo.z);
      float w = F * safe_div(1.0f, fabsf(s.wi.z), 0.0f);
      s.f = v3(w, w, w);
      s.pdf = F;
      s.valid = fabsf(wo.z) > 0.0f;
    } else {
      // refract about the local normal (materials.refract)
      bool fl = wo.z < 0.0f;
      float eta_e = fl ? 1.0f / m.eta : m.eta;
      float nz = fl ? -1.0f : 1.0f;
      float ci = fabsf(wo.z);
      float sin2_t = fmaxf(1.0f - ci * ci, 0.0f) / (eta_e * eta_e);
      float cos_t = safe_sqrtf(1.0f - sin2_t);
      float k = ci / eta_e - cos_t;
      V3 wt = v3(-wo.x / eta_e, -wo.y / eta_e, -wo.z / eta_e + k * nz);
      s.wi = normalize_safe(wt);
      float w = (1.0f - F) * safe_div(1.0f, fabsf(s.wi.z), 0.0f) /
                (eta_e * eta_e);
      s.f = v3(w, w, w);
      s.pdf = 1.0f - F;
      s.eta = eta_e;
      s.transmission = true;
      s.valid = !(sin2_t >= 1.0f);
    }
    s.specular = true;
  } else if (m.kind == 11) {
    float a = fmaxf(m.rough, 1e-3f);
    V3 wi = wi_d;
    if (u_lobe < fresnel_dielectric(fabsf(wo.z), m.eta)) {
      V3 wm = tr_sample_wm(wo_up, a, u0, u1);
      if (flip) wm = scale(wm, -1.0f);
      wi = reflect(wo, wm);
    }
    s.wi = wi;
    s.f = bsdf_f(m, wo, wi);
    s.pdf = bsdf_pdf(m, wo, wi);
    s.valid = wo.z * wi.z > 0.0f && s.pdf > 0.0f;
  }
  return s;
}

// orthonormal (t1, t2) about unit v (vecmath.coordinate_system)
static __device__ __forceinline__ void coordinate_system(V3 v, V3* t1,
                                                         V3* t2) {
  float sign = v.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + v.z);
  float b = v.x * v.y * a;
  *t1 = v3(1.0f + sign * v.x * v.x * a, sign * b, -sign * v.x);
  *t2 = v3(b, sign + v.y * v.y * a, -v.y);
}

}  // namespace vp
