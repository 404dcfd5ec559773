// B2c: the grid kernel of volpath_grid.cuh for the mesh class (GEOM_BVH):
// at most MAX_TRIS_MESH triangles, each closest-hit and shadow query a walk
// of the scene's BVH (csrc/bvh.cuh) over the node and triangle tables in
// global memory. Replaces pallas_volpath._make_grid_kernel in its mesh
// mode. Its own translation unit, so that ops/_build.py can give it its own
// ptxas flags (see SOURCE_FLAGS there).
#include "volpath_grid.cuh"

extern "C" int volpath_grid_mesh_launch(
    const float* fconst, const int* iconst, const float* density,
    const float* majorant, const float* tris, const float* nodes,
    const float* mats, float* out, int npix, int spp, unsigned int seed,
    float out_scale, int nmaj, int n_tri, int n_node, int n_mat,
    void* stream) {
  if (n_tri < 1 || n_tri > MAX_TRIS_MESH || n_node < 1 ||
      n_node > 2 * MAX_TRIS_MESH || n_mat < 1 || n_mat > MAX_MATS)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (npix + threads - 1) / threads;
  size_t shmem = (nmaj + n_mat * MAT_COLS) * sizeof(float);
  volpath_grid_kernel<GEOM_BVH><<<blocks, threads, shmem,
                                  (cudaStream_t)stream>>>(
      fconst, iconst, density, majorant, tris, nodes, mats, out, npix, spp,
      seed, out_scale, nmaj, n_tri, n_mat);
  return (int)cudaGetLastError();
}
