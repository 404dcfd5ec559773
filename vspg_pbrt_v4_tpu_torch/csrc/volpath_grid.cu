// B2a: the grid kernel of volpath_grid.cuh without triangles (GEOM_NONE).
#include "volpath_grid.cuh"

extern "C" int volpath_grid_launch(const float* fconst, const int* iconst,
                                   const float* density,
                                   const float* majorant, float* out,
                                   int npix, int spp, unsigned int seed,
                                   float out_scale, int nmaj, void* stream) {
  const int threads = 128;
  const int blocks = (npix + threads - 1) / threads;
  volpath_grid_kernel<GEOM_NONE><<<blocks, threads, nmaj * sizeof(float),
                                   (cudaStream_t)stream>>>(
      fconst, iconst, density, majorant, nullptr, nullptr, nullptr, out, npix,
      spp, seed, out_scale, nmaj, 0, 0);
  return (int)cudaGetLastError();
}
