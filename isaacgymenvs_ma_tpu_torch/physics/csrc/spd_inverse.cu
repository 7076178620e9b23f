// B5: batched SPD matrix inverse by the Gauss-Jordan sweep, no pivoting.
//
// Replaces the TPU kernel isaacgymenvs_ma_tpu/physics/engine.py:
// _spd_inverse_pallas (body _sweep_inverse_batchlast).  Plain twin:
// isaacgymenvs_ma_tpu_torch/physics/dyn_kernel.py:sweep_inverse_bl.
//
// In: H (B, n, n) f32, batch-first and row-major, as the caller (OSC) holds
// it: the kernel reads it directly, where the TPU wrapper transposed it to
// put the batch on the 128 lanes.  Out: H^-1 (B, n, n).  n and the launch
// layout come from the force-included header
// (isaacgymenvs_ma_tpu_torch/physics/spd_kernel.py:SpdPlan): spd::N and the
// B5_* constants of KernelLayout.  No pivoting, since mass matrices and
// J M^-1 J^T are SPD.
//
// What bounds it on the H100: bytes.  Each matrix is read once and written
// once (8 n^2 bytes) for ~2 n^3 FLOPs: at (16384, 7, 7) 6.4 MB move in
// 1.9 us at 3.35 TB/s, while the arithmetic takes 0.2 us at 67 TFLOP/s.
// Reaching that needs many loads in flight on every SM, and the loads, the
// sweeps and the stores of different matrices overlapping: at
// (16384, 7, 7) the whole grid is resident at once, a single wave.  One
// thread per matrix (the first port of this kernel) gave 256 two-warp
// blocks there, ~4 resident warps per SM, each thread running a long serial
// sweep between its loads and its stores.  So here:
//   - a team of B5_TEAM lanes (the power of two >= n, 8..32: a team never
//     spans two warps) owns one matrix, lane l its rows r = l (mod TEAM),
//     B5_ROWS rows of n floats in registers; B5_ENVS matrices share a
//     block of 256 threads (512 blocks, ~31 warps per SM at (16384, 7, 7)),
//     the last block ragged and masked;
//   - each warp's 32 / TEAM matrices are contiguous in H, and the warp
//     copies them into shared memory as they lie there, with cp.async,
//     16 bytes a lane where its span is whole float4s and aligned (4 bytes
//     otherwise), consecutive lanes on consecutive addresses; each lane
//     then reads its rows, and the result goes back the same way.  A warp
//     waits only for its own copies, so warps whose data arrive first sweep
//     while the others still load.  (Rows at an odd stride, copied 4 bytes
//     at a time, and rows read straight from device memory both ran
//     slower in the FrankaReachMA step and alone at every size held but
//     n = 48, where the odd stride gained under 3%:
//     scripts/time_spd_variants.py);
//   - the sweep, unrolled over the compile-time n: at pivot k the lane
//     owning row k hands it to its team by warp shuffle (faster than the
//     row's slot in shared memory and a __syncwarp), then every lane
//     updates its rows.
// Every entry sees the twin's float operations in the twin's order:
// row = M[k] * (1 / M[k][k]); M[i][j] - col_i * row_j with col_k = 0, the
// multiply and the subtraction fused (one rounding, as the one-thread kernel
// had them); the pivot column -col_i * inv_d; row k replaced by row,
// M[k][k] by inv_d.  Lanes past n (n = 6: 2 of 8) and matrices past B
// compute on zeros and store nothing.
#include <cstdint>

#include <cuda_runtime.h>

#include "team.cuh"

namespace {

using namespace spd;

constexpr int TEAM = B5_TEAM;
constexpr int MATS = B5_ENVS;          // matrices per block
constexpr int BLOCK = TEAM * MATS;
constexpr int ROWS = B5_ROWS;
constexpr int ELEMS = N * N;
constexpr int MPW = 32 / TEAM;         // matrices per warp
constexpr int WARP_ELEMS = MPW * ELEMS;
constexpr unsigned kFull = 0xffffffffu;
static_assert(B5_FLOATS == ELEMS, "matrices lie in shared memory as in H");
static_assert(ROWS * TEAM >= N && (ROWS - 1) * TEAM < N, "B5_ROWS");
static_assert(BLOCK % 32 == 0, "whole warps: the shuffles name all 32 lanes");

__global__ void __launch_bounds__(BLOCK)
spd_inverse_kernel(const float* __restrict__ H, float* __restrict__ out,
                   int B) {
  extern __shared__ __align__(16) float tile[];
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const long long first =
      static_cast<long long>(blockIdx.x) * MATS + warp * MPW;
  const long long left = B - first;
  const int count = left <= 0 ? 0 : (left < MPW ? static_cast<int>(left)
                                                : MPW);   // ragged tail
  const int total = count * ELEMS;
  const float* src = H + first * ELEMS;
  float* dst = out + first * ELEMS;
  float* wtile = tile + warp * WARP_ELEMS;
  const bool quads =
      WARP_ELEMS % 4 == 0 && count == MPW &&
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0;
  if (quads) {
#pragma unroll
    for (int q = wl; q < WARP_ELEMS / 4; q += 32)
      __pipeline_memcpy_async(wtile + 4 * q, src + 4 * q, 16);
  } else {
    for (int e = wl; e < total; e += 32)
      __pipeline_memcpy_async(wtile + e, src + e, sizeof(float));
  }
  team::stage_wait();
  __syncwarp();

  const int lane = wl % TEAM, mat = wl / TEAM;
  const bool live = mat < count;
  float* mine = wtile + mat * ELEMS;
  float M[ROWS][N];
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    const int r = lane + t * TEAM;
#pragma unroll
    for (int j = 0; j < N; ++j)
      M[t][j] = live && r < N ? mine[r * N + j] : 0.0f;
  }

#pragma unroll
  for (int k = 0; k < N; ++k) {
    // pivot row k, from the lane that owns it to its team
    float row[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      row[j] = __shfl_sync(kFull, M[k / TEAM][j], k % TEAM, TEAM);
    const float inv_d = 1.0f / row[k];
#pragma unroll
    for (int j = 0; j < N; ++j) row[j] = __fmul_rn(row[j], inv_d);
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      const bool pivot = lane + t * TEAM == k;
      const float col = pivot ? 0.0f : M[t][k];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float upd = fmaf(-col, row[j], M[t][j]);
        M[t][j] = j == k ? (pivot ? inv_d : __fmul_rn(-col, inv_d))
                         : (pivot ? row[j] : upd);
      }
    }
  }

  // each lane writes back only the rows it read: no team sync needed
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    const int r = lane + t * TEAM;
    if (live && r < N) {
#pragma unroll
      for (int j = 0; j < N; ++j) mine[r * N + j] = M[t][j];
    }
  }
  __syncwarp();
  if (quads) {
#pragma unroll
    for (int q = wl; q < WARP_ELEMS / 4; q += 32)
      reinterpret_cast<float4*>(dst)[q] =
          reinterpret_cast<const float4*>(wtile)[q];
  } else {
    for (int e = wl; e < total; e += 32) dst[e] = wtile[e];
  }
}

}  // namespace

extern "C" int spd_inverse_launch(int device, const float* H, float* out,
                                  int B, void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = team::allow_smem(spd_inverse_kernel, B5_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + MATS - 1) / MATS;
  spd_inverse_kernel<<<blocks, BLOCK, B5_SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(H, out, B);
  return static_cast<int>(cudaGetLastError());
}
