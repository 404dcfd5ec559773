// B2b: the grid kernel of volpath_grid.cuh with at most 64 triangles
// (GEOM_SWEEP). Its own translation unit, so that ops/_build.py and
// chip_smoke.py's register-budget sweep can build it alone.
#ifndef VOLPATH_GRID_MIN_BLOCKS
#define VOLPATH_GRID_MIN_BLOCKS 4
#endif
#ifndef VOLPATH_GRID_VOTE
#define VOLPATH_GRID_VOTE 1
#endif
#include "volpath_grid.cuh"

// nodes and n_node unused
extern "C" int volpath_grid_tris_launch(
    const float* fconst, const int* iconst, const float* density,
    const float* majorant, const float* tris, const float* nodes,
    const float* mats, float* lbuf, unsigned long long* next_item, int npix,
    int samp0, int n_samp, unsigned int seed, int nmaj, int n_tri,
    int n_node, int n_mat, int blocks, void* stream) {
  if (n_tri < 1 || n_tri > MAX_TRIS || n_mat < 1 || n_mat > MAX_MATS)
    return (int)cudaErrorInvalidValue;
  return grid_launch<GEOM_SWEEP>(fconst, iconst, density, majorant, tris,
                                 nullptr, mats, lbuf, next_item, npix, samp0,
                                 n_samp, seed, nmaj, n_tri, n_mat, blocks,
                                 stream);
}

extern "C" int volpath_grid_tris_info(int nmaj, int n_tri, int n_mat,
                                      int* out4) {
  return (int)grid_info<GEOM_SWEEP>(
      grid_smem<GEOM_SWEEP>(nmaj, n_tri, n_mat), out4);
}
