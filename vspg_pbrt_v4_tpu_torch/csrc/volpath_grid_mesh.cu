// B2c: the grid kernel of volpath_grid.cuh for the mesh class (GEOM_BVH):
// at most MAX_TRIS_MESH triangles, each closest-hit and shadow query a walk
// of the scene's BVH (csrc/bvh.cuh) over the node and triangle tables in
// global memory. Replaces pallas_volpath._make_grid_kernel in its mesh
// mode. Its own translation unit, so that ops/_build.py and chip_smoke.py's
// register-budget sweep can build it alone.
#ifndef VOLPATH_GRID_MIN_BLOCKS
#define VOLPATH_GRID_MIN_BLOCKS 4
#endif
#ifndef VOLPATH_GRID_VOTE
#define VOLPATH_GRID_VOTE 1
#endif
#include "volpath_grid.cuh"

extern "C" int volpath_grid_mesh_launch(
    const float* fconst, const int* iconst, const float* density,
    const float* majorant, const float* tris, const float* nodes,
    const float* mats, float* lbuf, unsigned long long* next_item, int npix,
    int samp0, int n_samp, unsigned int seed, int nmaj, int n_tri,
    int n_node, int n_mat, int blocks, void* stream) {
  if (n_tri < 1 || n_tri > MAX_TRIS_MESH || n_node < 1 ||
      n_node > 2 * MAX_TRIS_MESH || n_mat < 1 || n_mat > MAX_MATS)
    return (int)cudaErrorInvalidValue;
  return grid_launch<GEOM_BVH>(fconst, iconst, density, majorant, tris, nodes,
                               mats, lbuf, next_item, npix, samp0, n_samp,
                               seed, nmaj, n_tri, n_mat, blocks, stream);
}

extern "C" int volpath_grid_mesh_info(int nmaj, int n_tri, int n_mat,
                                      int* out4) {
  return (int)grid_info<GEOM_BVH>(grid_smem<GEOM_BVH>(nmaj, n_tri, n_mat),
                                  out4);
}
