// Guiding constant tables of the VSPG kernel (csrc/vspg.cu). The layout is
// declared once here and once in ops/vspg_kernels.py (G_*, GI_*); a CPU
// test compares the two.
#pragma once

namespace vp {

// float32 guiding constant table (ops/vspg_kernels.py G_*)
enum GConst {
  G_FB0 = 0,          // field bounds min (3)
  G_FEXT = 3,         // field extent (3)
  G_EXT = 6,          // medium box extent (3)
  G_KM = 9,           // majorant cells per unit length (3)
  G_CELL = 12,        // majorant cell size (3)
  G_ALB = 15,         // single-scattering albedo (3)
  G_FRES_HI = 18,     // fres - 1e-4
  G_PG = 19,          // guiding probability
  G_1MPG = 20,        // 1 - pg
  G_PG_SAFE = 21,     // max(pg, 1e-6)
  G_PG_NEE = 22,      // NEE MIS blend (pg for MIS, 0.5 for RIS)
  G_1MPG_NEE = 23,    // 1 - pg_nee
  G_RIS_C0 = 24,      // (1 - pg) / (4 pi)
  G_MIS = 25,         // vsp_mis_ratio
  G_1MMIS = 26,       // 1 - vsp_mis_ratio
  G_SCALE_CAP = 27,   // scale_vsp_cap
  G_KAPPA_H = 28,     // kappa of the HG lobe's vMF
  G_LOG_C_H = 29,     // its log normalizer
  G_HG_SIGN = 30,     // sign(g)
  G_LOG_2PI = 31,     // log(2 pi)
  G_KAPPA_COS = 32,   // kappa of the clamped-cosine lobe's vMF
  G_LOG_C_COS = 33,   // its log normalizer
  N_GCONST = 34
};

// int32 guiding constant table (ops/vspg_kernels.py GI_*)
enum GIConst {
  GI_FRES = 0,            // field cells per axis
  GI_K = 1,               // lobes per cell in the table (<= 4)
  GI_NCELL = 2,           // fres^3
  GI_RIS = 3,             // 1: RIS direction sampling, 0: one-sample MIS
  GI_GUIDE_RR = 4,        // guided Russian roulette
  GI_MIN_RR_DEPTH = 5,
  GI_GUIDE_PRIMARY = 6,   // primary-ray VSP from the ISGB
  GI_GUIDE_SECONDARY = 7, // secondary-ray VSP from the field (trained)
  GI_VOL_GUIDING = 8,     // directional guiding at volume vertices
  GI_APPLY_HG = 9,        // |g| > 1e-3: HG-lobe product
  GI_SIGMA_GRAY = 10,     // sigma_t equal in the three channels
  GI_METHOD = 11,         // distance route (Method below)
  GI_SURF_GUIDE = 12,     // guided BSDF draws at diffuse surfaces (trained)
  GI_ANY_ROUGH = 13,      // a material is glossy: the extra lobe draw
  GI_NEXTRA = 14,         // adaptive field: extra leaves (0: uniform grid)
  GI_NLEAF = 15,          // leaves, fres^3 + n_extra: the field table's width
  N_GICONST = 16
};

// distance route of guided walks (ops/vspg_kernels.py METHODS); the kernel
// is instantiated for each, the launcher picks by the table's GI_METHOD
enum Method { M_RESAMPLING = 0, M_NDS = 1, M_NDS_PLUS = 2 };

}  // namespace vp
