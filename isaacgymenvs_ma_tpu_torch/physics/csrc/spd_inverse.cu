// B5: batched SPD matrix inverse by the Gauss-Jordan sweep, no pivoting.
//
// Replaces the TPU kernel isaacgymenvs_ma_tpu/physics/engine.py:
// _spd_inverse_pallas (body _sweep_inverse_batchlast).  Plain twin:
// isaacgymenvs_ma_tpu_torch/physics/dyn_kernel.py:sweep_inverse_bl.
//
// In: H (B, n, n) f32, batch-first and row-major, as the caller (OSC) holds
// it: the kernel reads it directly, where the TPU wrapper transposed it to
// put the batch on the 128 lanes.  Out: H^-1 (B, n, n).  n is the
// compile-time spd::N of the force-included header
// (isaacgymenvs_ma_tpu_torch/physics/spd_kernel.py:SpdPlan); no pivoting,
// since mass matrices and J M^-1 J^T are SPD.
//
// What bounds it on the H100: bytes.  Each matrix is read once and written
// once (8 n^2 bytes) for ~2 n^3 FLOPs: at (16384, 7, 7) 6.4 MB move in
// 1.9 us at 3.35 TB/s, while the arithmetic takes 0.2 us at 67 TFLOP/s.  One
// thread owns one matrix and runs the sweep on it in registers, fully
// unrolled for the constant n, so every index is static (n^2 + 2n floats;
// from n ~ 14 they spill to local memory).  One thread reading its own rows
// would leave a warp's loads n^2 floats apart, so each block first stages
// its kThreads consecutive matrices through shared memory with coalesced
// loads (neighbouring threads, neighbouring addresses), and writes them back
// the same way.
#include <cuda_runtime.h>

namespace {

constexpr int N = spd::N;
constexpr int kElems = N * N;
// matrices per block: as many as 48 KB of static shared memory hold, at most
// 64 (two warps), whole warps where at least one fits
constexpr int kFit = (48 * 1024 / 4) / kElems;
constexpr int kThreads =
    kFit >= 64 ? 64 : (kFit >= 32 ? 32 : (kFit > 0 ? kFit : 1));
static_assert(kFit > 0, "spd_inverse: one matrix exceeds shared memory");

__global__ void __launch_bounds__(kThreads)
spd_inverse_kernel(const float* __restrict__ H, float* __restrict__ out,
                   int B) {
  __shared__ float tile[kThreads * kElems];
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const int count = static_cast<int>(
      B - first < kThreads ? B - first : kThreads);   // ragged last block
  const long long off = first * kElems;
  const int total = count * kElems;
  for (int i = threadIdx.x; i < total; i += kThreads) tile[i] = H[off + i];
  __syncthreads();

  if (threadIdx.x < count) {
    float* mine = tile + threadIdx.x * kElems;
    float M[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) M[i][j] = mine[i * N + j];
    // the sweep, in the twin's order: pivot row scaled, rank-1 update of
    // every entry with the pivot row of the column zeroed, then the pivot
    // column and the pivot row replaced
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float inv_d = 1.0f / M[k][k];
      float row[N], col[N];
#pragma unroll
      for (int j = 0; j < N; ++j) row[j] = M[k][j] * inv_d;
#pragma unroll
      for (int i = 0; i < N; ++i) col[i] = i == k ? 0.0f : M[i][k];
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) M[i][j] = M[i][j] - col[i] * row[j];
#pragma unroll
      for (int i = 0; i < N; ++i) M[i][k] = i == k ? inv_d : -col[i] * inv_d;
#pragma unroll
      for (int j = 0; j < N; ++j) M[k][j] = j == k ? inv_d : row[j];
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) mine[i * N + j] = M[i][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += kThreads) out[off + i] = tile[i];
}

}  // namespace

extern "C" int spd_inverse_launch(int device, const float* H, float* out,
                                  int B, void* stream) {
  if (B <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (B + kThreads - 1) / kThreads;
  spd_inverse_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(H, out, B);
  return static_cast<int>(cudaGetLastError());
}
