// Block-wide staging of the team kernels (B2, B4), where a team of lanes
// owns one env and E envs share a block, each env's arrays in its own
// region of W floats of dynamic shared memory.
//
// Global arrays are batch-last, row i of env n at g[i * N + n].  Staging
// and storing walk (row, env) pairs with the env fastest, so consecutive
// threads touch consecutive envs: each global access is a coalesced run of
// E floats (stored four envs to a thread where rows are 16-byte aligned),
// and, W being odd (or an odd number of float4s), the shared-memory side
// hits distinct banks.  Staging copies asynchronously
// (cp.async): every stage() of a kernel puts its loads in flight at once,
// and stage_wait() waits for them all (or, in batches, stage_commit() and
// stage_wait_prior()).
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace team {

// Start copying row row(i) of every env of the block to
// smem[e * W + off + at(i)], for i < M; envs past N get zeros (they are
// computed on and never stored).  BLOCK is the block's thread count.
template <int E, int W, int BLOCK, typename Row, typename At>
__device__ __forceinline__ void stage(float* smem, int off,
                                      const float* __restrict__ g, int M,
                                      int n0, int N, const Row& row,
                                      const At& at) {
  static_assert(BLOCK % E == 0, "a block holds whole envs");
  // thread t copies env t % E of rows t / E, t / E + BLOCK / E, ...
  const int e = threadIdx.x % E, n = n0 + e;
  float* base = smem + e * W + off;
#pragma unroll 4
  for (int i = threadIdx.x / E; i < M; i += BLOCK / E) {
    if (n < N)
      __pipeline_memcpy_async(
          base + at(i), g + static_cast<size_t>(row(i)) * N + n,
          sizeof(float));
    else
      base[at(i)] = 0.0f;
  }
}

// Rows i < M in order, to smem[e * W + off + i].
template <int E, int W, int BLOCK>
__device__ __forceinline__ void stage(float* smem, int off,
                                      const float* __restrict__ g, int M,
                                      int n0, int N) {
  const auto same = [](int i) { return i; };
  stage<E, W, BLOCK>(smem, off, g, M, n0, N, same, same);
}

// Start copying `words` 4-byte words from g to smem, shared by the block
// (a kernel's scene tables).
template <int BLOCK>
__device__ __forceinline__ void stage_table(void* smem, const void* g,
                                            int words) {
  for (int i = threadIdx.x; i < words; i += BLOCK)
    __pipeline_memcpy_async(static_cast<float*>(smem) + i,
                            static_cast<const float*>(g) + i, sizeof(float));
}

// Wait for this thread's staged copies; a __syncthreads() must follow
// before any thread reads what another staged.
__device__ __forceinline__ void stage_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// Close the batch of copies this thread started since the last batch, so
// that a kernel can wait for its first batches and compute on them while
// the later ones are still in flight.
__device__ __forceinline__ void stage_commit() { __pipeline_commit(); }

// Wait until at most `kLater` of this thread's closed batches are still in
// flight; a __syncthreads() must follow, as after stage_wait().
template <int kLater>
__device__ __forceinline__ void stage_wait_prior() {
  __pipeline_wait_prior(kLater);
}

// Row i < M of every env of the block, from smem[e * W + off + at(i)], to
// the batch-last (M, N) array g.  Where rows are 16-byte aligned (N and E
// multiples of 4), each thread writes four consecutive envs as one float4.
template <int E, int W, int BLOCK, typename At>
__device__ __forceinline__ void store(float* __restrict__ g, int M, int n0,
                                      int N, const float* smem, int off,
                                      const At& at) {
  if constexpr (E % 4 == 0) {
    if (N % 4 == 0) {
      constexpr int Q = E / 4;    // float4s per row of the block
#pragma unroll 4
      for (int idx = threadIdx.x; idx < Q * M; idx += BLOCK) {
        const int e = 4 * (idx % Q), i = idx / Q, n = n0 + e;
        if (n < N) {
          const float* s = smem + e * W + off + at(i);
          *reinterpret_cast<float4*>(g + static_cast<size_t>(i) * N + n) =
              make_float4(s[0], s[W], s[2 * W], s[3 * W]);
        }
      }
      return;
    }
  }
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
