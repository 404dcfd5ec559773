// M: a chain of dependent random gathers from a (C, 128) float32 table,
// the per-lane table-lookup microbenchmark of the guided and grid kernels.
//
// Replaces benchmarks/gather_microbench.py _kernel (the Pallas TPU kernel
// behind make_fn) in the JAX package's repository. Per lane of a block of
// SUB x 128 = 1024 lanes: idx = mix(lane * 131 + sublane * 7919 + seed +
// block), then `events` times v = table[(idx & (C*128-1)) >> 7 & (C-1),
// idx & 127], idx = mix(idx + int(v) + i), acc += v; the block writes its
// (8, 128) accumulators. Block 0 computes what the TPU kernel computes;
// further blocks fill the card. The TPU kernel's two gather strategies
// (a chunk sweep and one-hot MXU products) become two placements of the
// table: GLOBAL reads it through the read-only cache from L2 (1 MB at
// C = 2048), SHARED stages it into shared memory first (C * 512 bytes,
// so at most C = 256 under the 227 KB a block may hold).
//
// What bounds it on the H100: latency. Each lookup's address depends on
// the previous lookup's value, so a lane waits one L2 (or shared-memory)
// round trip per event; the bytes (the table once) and the integer work
// (about a dozen operations a lookup) are far below what the card could
// move or issue. The design keeps one lane per thread and as many blocks
// as the caller asks for, so the card's warps hide each other's waits.
//
// int32 arithmetic wraps as on the TPU: products and sums are taken in
// unsigned and converted back; >> on int is arithmetic, as in JAX.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB = 8;
constexpr int LANES = 128;
constexpr int BLOCK = SUB * LANES;

__device__ __forceinline__ int wrap(unsigned int x) { return (int)x; }

__device__ __forceinline__ int mix(int x) {
  x = wrap((unsigned int)(x ^ (x >> 4)) * 277803737u);
  return x ^ (x >> 11);
}

template <bool SHARED>
__global__ void __launch_bounds__(BLOCK)
    gather_kernel(const float* __restrict__ table, float* __restrict__ out,
                  int C, int events, int seed) {
  extern __shared__ float stab[];
  const float* tab = table;
  if constexpr (SHARED) {
    for (int i = threadIdx.x; i < C * LANES; i += blockDim.x)
      stab[i] = table[i];
    __syncthreads();
    tab = stab;
  }
  const int lane = threadIdx.x % LANES, subl = threadIdx.x / LANES;
  int idx = mix(wrap((unsigned int)lane * 131u + (unsigned int)subl * 7919u +
                     (unsigned int)seed + blockIdx.x));
  const int wmask = C * LANES - 1, cmask = C - 1;
  float acc = 0.0f;
  for (int i = 0; i < events; ++i) {
    const int word = idx & wmask;
    const int c = (word >> 7) & cmask;
    const int l = word & 127;
    float v;
    if constexpr (SHARED)
      v = tab[c * LANES + l];
    else
      v = __ldg(tab + c * LANES + l);
    // the next index depends on the value: nothing can be hoisted
    idx = mix(wrap((unsigned int)idx + (unsigned int)(int)v + (unsigned int)i));
    acc += v;
  }
  out[(size_t)blockIdx.x * BLOCK + threadIdx.x] = acc;
}

}  // namespace

// out: (blocks, 8, 128) float32; shared != 0 stages the table in shared
// memory (C * 512 bytes)
extern "C" int gather_launch(const float* table, float* out, int C,
                             int events, int seed, int blocks, int shared,
                             void* stream) {
  if (C < 1 || (C & (C - 1)) != 0 || events < 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (shared) {
    const size_t smem = (size_t)C * LANES * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        gather_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    gather_kernel<true><<<blocks, BLOCK, smem, st>>>(table, out, C, events,
                                                     seed);
  } else {
    gather_kernel<false><<<blocks, BLOCK, 0, st>>>(table, out, C, events,
                                                   seed);
  }
  return (int)cudaGetLastError();
}
