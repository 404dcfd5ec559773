// B2a: the grid kernel of volpath_grid.cuh without triangles (GEOM_NONE).
#ifndef VOLPATH_GRID_MIN_BLOCKS
#define VOLPATH_GRID_MIN_BLOCKS 4
#endif
#ifndef VOLPATH_GRID_VOTE
#define VOLPATH_GRID_VOTE 0
#endif
#include "volpath_grid.cuh"

// the launch and grid of one chunk of samples (volpath_grid.cuh
// grid_launch, grid_info); tris, nodes, n_tri, n_node and n_mat unused
extern "C" int volpath_grid_launch(
    const float* fconst, const int* iconst, const float* density,
    const float* majorant, const float* tris, const float* nodes,
    const float* mats, float* lbuf, unsigned long long* next_item, int npix,
    int samp0, int n_samp, unsigned int seed, int nmaj, int n_tri,
    int n_node, int n_mat, int blocks, void* stream) {
  return grid_launch<GEOM_NONE>(fconst, iconst, density, majorant, nullptr,
                                nullptr, nullptr, lbuf, next_item, npix,
                                samp0, n_samp, seed, nmaj, 0, 0, blocks,
                                stream);
}

extern "C" int volpath_grid_info(int nmaj, int n_tri, int n_mat, int* out4) {
  return (int)grid_info<GEOM_NONE>(grid_smem<GEOM_NONE>(nmaj, 0, 0), out4);
}
