// B3: cached dynamics chain for the later substeps of a control step.
//
// Replaces the TPU kernel isaacgymenvs_ma_tpu/physics/dyn_kernel.py:
// dyn_cached_pallas (body dyn_cached_bl).  Plain twin:
// isaacgymenvs_ma_tpu_torch/physics/dyn_kernel.py:dyn_cached_bl.
//
// Per env: RNEA bias force C against the I_O cached by B2, with gravity from
// the fresh per-body wrench f_grav (a stale com through the cached I_O would
// torque every translating floating base), then qdd = H^-1 (rhs - C) with
// the cached H^-1 (SimParams.reuse_mass_matrix).
//
// In (batch-last f32): S (NV,6,N), qd/rhs (NV,N), I_O (NB,6,6,N),
// Hinv (NV,NV,N), f_grav (NB,6,N).  Out: qdd (NV,N).
//
// What bounds it on the H100: bytes.  Each env reads NB*36 + NV*NV + NB*6 +
// NV*8 floats (~2.3 KB for Ant) for ~2k FLOPs, so the kernel is a streaming
// read at coalesced addresses; I_O is consumed body by body (36 floats at a
// time) and H^-1 row by row, so the per-thread state stays small (S, qd and
// the RNEA vectors).  At 4096 envs the grid is 128 one-warp blocks for 132
// SMs, too few warps in flight to cover memory latency (later work).
#include "dyn_common.cuh"

namespace {

__global__ void __launch_bounds__(dyn::kThreads)
dyn_cached_kernel(const float* __restrict__ Sg, const float* __restrict__ qdg,
                  const float* __restrict__ rhs, const float* __restrict__ io,
                  const float* __restrict__ hinv,
                  const float* __restrict__ fgrav,
                  float* __restrict__ qdd_out, int N) {
  namespace sc = scene;
  constexpr int NV = sc::NV;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;   // ragged last block

  float S[NV][6], qd[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    qd[v] = qdg[v * N + n];
#pragma unroll
    for (int k = 0; k < 6; ++k) S[v][k] = Sg[(v * 6 + k) * N + n];
  }
  float C[NV];
  dyn::bias_force<false>(
      S, qd, [&](int b, int k) { return io[(b * 36 + k) * N + n]; },
      [&](int b, int k) { return fgrav[(b * 6 + k) * N + n]; }, C);
  float r[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) r[j] = rhs[j * N + n] - C[j];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) acc += hinv[(i * NV + j) * N + n] * r[j];
    qdd_out[i * N + n] = acc;
  }
}

}  // namespace

extern "C" int dyn_cached_launch(int device, const float* S, const float* qd,
                                 const float* rhs, const float* io,
                                 const float* hinv, const float* fgrav,
                                 float* qdd, int N, void* stream) {
  if (N <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (N + dyn::kThreads - 1) / dyn::kThreads;
  dyn_cached_kernel<<<blocks, dyn::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      S, qd, rhs, io, hinv, fgrav, qdd, N);
  return static_cast<int>(cudaGetLastError());
}
