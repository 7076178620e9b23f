// Block-wide staging of the team kernels (B2, B4), where a team of lanes
// owns one env and E envs share a block, each env's arrays in its own
// region of W floats of dynamic shared memory.
//
// Global arrays are batch-last, row i of env n at g[i * N + n].  Staging
// and storing walk (row, env) pairs with the env fastest, so consecutive
// threads touch consecutive envs: each global access is a coalesced run of
// E floats, and, W being odd (or an odd number of float4s), the
// shared-memory side hits distinct banks.  Staging copies asynchronously
// (cp.async): every stage() of a kernel puts its loads in flight at once,
// and stage_wait() waits for them all.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace team {

// Start copying row i < M of every env of the block to
// smem[e * W + off + i]; envs past N get zeros (they are computed on and
// never stored).  BLOCK is the block's thread count.
template <int E, int W, int BLOCK>
__device__ __forceinline__ void stage(float* smem, int off,
                                      const float* __restrict__ g, int M,
                                      int n0, int N) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < E * M; idx += BLOCK) {
    const int e = idx % E, i = idx / E, n = n0 + e;
    float* dst = smem + e * W + off + i;
    if (n < N)
      __pipeline_memcpy_async(dst, g + static_cast<size_t>(i) * N + n,
                              sizeof(float));
    else
      *dst = 0.0f;
  }
}

// Wait for this thread's staged copies; a __syncthreads() must follow
// before any thread reads what another staged.
__device__ __forceinline__ void stage_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// Row i < M of every env of the block, from smem[e * W + off + at(i)], to
// the batch-last (M, N) array g.
template <int E, int W, int BLOCK, typename At>
__device__ __forceinline__ void store(float* __restrict__ g, int M, int n0,
                                      int N, const float* smem, int off,
                                      const At& at) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < E * M; idx += BLOCK) {
    const int e = idx % E, i = idx / E, n = n0 + e;
    if (n < N) g[static_cast<size_t>(i) * N + n] = smem[e * W + off + at(i)];
  }
}

template <int E, int W, int BLOCK>
__device__ __forceinline__ void store(float* __restrict__ g, int M, int n0,
                                      int N, const float* smem, int off) {
  store<E, W, BLOCK>(g, M, n0, N, smem, off, [](int i) { return i; });
}

// Opt a kernel into `bytes` of dynamic shared memory (needed above 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace team
