// B2b: the grid kernel of volpath_grid.cuh with at most 64 triangles
// (GEOM_SWEEP). Its own translation unit, so that ops/_build.py can build it
// with ptxas optimisation off (see SOURCE_FLAGS there).
#include "volpath_grid.cuh"

extern "C" int volpath_grid_tris_launch(
    const float* fconst, const int* iconst, const float* density,
    const float* majorant, const float* tris, const float* mats, float* out,
    int npix, int spp, unsigned int seed, float out_scale, int nmaj,
    int n_tri, int n_mat, void* stream) {
  if (n_tri < 1 || n_tri > MAX_TRIS || n_mat < 1 || n_mat > MAX_MATS)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (npix + threads - 1) / threads;
  size_t shmem = (nmaj + n_tri * TRI_COLS + n_mat * MAT_COLS) * sizeof(float);
  volpath_grid_kernel<GEOM_SWEEP><<<blocks, threads, shmem,
                                    (cudaStream_t)stream>>>(
      fconst, iconst, density, majorant, tris, nullptr, mats, out, npix, spp,
      seed, out_scale, nmaj, n_tri, n_mat);
  return (int)cudaGetLastError();
}
