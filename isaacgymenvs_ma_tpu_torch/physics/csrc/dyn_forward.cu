// B2: fused full dynamics chain for the first substep of a control step.
//
// Replaces the TPU kernel isaacgymenvs_ma_tpu/physics/dyn_kernel.py:
// dyn_forward_pallas (body dyn_full_bl).  Plain twin:
// isaacgymenvs_ma_tpu_torch/physics/dyn_kernel.py:dyn_full_bl.
//
// Per env: world spatial inertia about the origin (optional per-env mass and
// shape scales) -> RNEA bias force C -> composite inertias -> CRBA mass
// matrix through the dof_anc pair mask -> H = M + diag -> Gauss-Jordan sweep
// inverse (no pivoting; H is SPD) -> qdd = H^-1 (rhs - C).
//
// In (batch-last f32): body_x (NB,3,N), body_q (NB,4,N), S (NV,6,N),
// qd/rhs/diag (NV,N), mass_scale (NB,N) or null, shape_scale (NB,3,N) or null.
// Out: qdd (NV,N), Hinv (NV,NV,N), I_O (NB,6,6,N) (the cache for B3).
//
// What bounds it on the H100: per-thread working set and latency.  One
// thread holds I_O (NB*36), H (NV*NV), S (NV*6) and the RNEA vectors —
// ~700 floats for Ant (the Pallas kernel's VMEM estimate is ~2,560 per env)
// — far above the 255-register limit, so most of it spills to local memory
// (L1/L2-backed, coalesced across the warp because local memory is
// interleaved per thread).  The sweep is ~NV^3 = 2.7k FMAs per env.  At
// 4096 envs the grid is 128 one-warp blocks for 132 SMs: under-filled, one
// warp per SM with nothing to hide latency.  The design keeps one global
// round trip (inputs read once, outputs written once) and reuses the I_O
// buffer in place for the composite inertias after C is computed.  A warp
// per env with shared-memory tiles is later work.
#include "dyn_common.cuh"

namespace {

__global__ void __launch_bounds__(dyn::kThreads)
dyn_forward_kernel(const float* __restrict__ bx, const float* __restrict__ bq,
                   const float* __restrict__ Sg, const float* __restrict__ qdg,
                   const float* __restrict__ rhs,
                   const float* __restrict__ diag,
                   const float* __restrict__ mass_scale,
                   const float* __restrict__ shape_scale,
                   float* __restrict__ qdd_out, float* __restrict__ hinv_out,
                   float* __restrict__ io_out, int N) {
  namespace sc = scene;
  constexpr int NB = sc::NB, NV = sc::NV;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;   // ragged last block

  float S[NV][6], qd[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    qd[v] = qdg[v * N + n];
#pragma unroll
    for (int k = 0; k < 6; ++k) S[v][k] = Sg[(v * 6 + k) * N + n];
  }

  // ---- world spatial inertia about the origin
  float IO[NB][36];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float x = bq[(b * 4 + 0) * N + n], y = bq[(b * 4 + 1) * N + n];
    const float z = bq[(b * 4 + 2) * N + n], w = bq[(b * 4 + 3) * N + n];
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, xz = x * z, yz = y * z;
    const float wx = w * x, wy = w * y, wz = w * z;
    const float R[3][3] = {
        {1.0f - 2.0f * (yy + zz), 2.0f * (xy - wz), 2.0f * (xz + wy)},
        {2.0f * (xy + wz), 1.0f - 2.0f * (xx + zz), 2.0f * (yz - wx)},
        {2.0f * (xz - wy), 2.0f * (yz + wx), 1.0f - 2.0f * (xx + yy)}};
    float I[3][3], com[3], m = sc::mass(b);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      com[i] = sc::com(b, i);
#pragma unroll
      for (int j = 0; j < 3; ++j) I[i][j] = sc::inertia(b, i * 3 + j);
    }
    if (shape_scale != nullptr) {
      // uniform-density second-moment transform C' = svol * S C S
      float s[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) s[k] = shape_scale[(b * 3 + k) * N + n];
      const float svol = s[0] * s[1] * s[2];
      const float tr = I[0][0] + I[1][1] + I[2][2];
      float Cm[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float c0 = (i == j ? 0.5f * tr : 0.0f) - I[i][j];
          Cm[i][j] = svol * (s[i] * c0 * s[j]);
        }
      const float trc = Cm[0][0] + Cm[1][1] + Cm[2][2];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) I[i][j] = (i == j ? trc : 0.0f) - Cm[i][j];
      m = m * svol;
#pragma unroll
      for (int k = 0; k < 3; ++k) com[k] = com[k] * s[k];
    }
    // Ic = R I R^T, world com c = x + R com
    float RI[3][3], Ic[3][3], c[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        RI[i][j] = R[i][0] * I[0][j] + R[i][1] * I[1][j] + R[i][2] * I[2][j];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Ic[i][j] = RI[i][0] * R[j][0] + RI[i][1] * R[j][1] + RI[i][2] * R[j][2];
      c[i] = bx[(b * 3 + i) * N + n] +
             (R[i][0] * com[0] + R[i][1] * com[1] + R[i][2] * com[2]);
    }
    if (mass_scale != nullptr) {
      const float ms = mass_scale[b * N + n];
      m = m * ms;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) Ic[i][j] = Ic[i][j] * ms;
    }
    const float cx[3][3] = {{0.0f, -c[2], c[1]},
                            {c[2], 0.0f, -c[0]},
                            {-c[1], c[0], 0.0f}};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float cxcx =
            cx[i][0] * cx[0][j] + cx[i][1] * cx[1][j] + cx[i][2] * cx[2][j];
        IO[b][i * 6 + j] = Ic[i][j] - m * cxcx;        // top-left
        IO[b][i * 6 + 3 + j] = m * cx[i][j];           // top-right
        IO[b][(3 + i) * 6 + j] = -(m * cx[i][j]);      // bottom-left
        IO[b][(3 + i) * 6 + 3 + j] = i == j ? m : 0.0f;
      }
#pragma unroll
    for (int k = 0; k < 36; ++k) io_out[(b * 36 + k) * N + n] = IO[b][k];
  }

  // ---- bias force against the fresh I_O (gravity through a0)
  float C[NV];
  dyn::bias_force<true>(
      S, qd, [&](int b, int k) { return IO[b][k]; },
      [](int, int) { return 0.0f; }, C);

  // ---- composite inertias (in place) and the CRBA mass matrix
  dyn::subtree_sum<36>(IO);
  float F[NV][6];
#pragma unroll
  for (int v = 0; v < NV; ++v) dyn::matvec6(IO[sc::dof_body(v)], S[v], F[v]);
  float H[NV][NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float g = 0.0f;
      if (sc::anc(i, j)) {
#pragma unroll
        for (int k = 0; k < 6; ++k) g += S[i][k] * F[j][k];
      } else if (sc::anc(j, i)) {
#pragma unroll
        for (int k = 0; k < 6; ++k) g += F[i][k] * S[j][k];
      }
      H[i][j] = i == j ? g + diag[i * N + n] : g;
    }

  // ---- Gauss-Jordan sweep inverse, in place, no pivoting
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const float inv_d = 1.0f / H[k][k];
    float row[NV], col[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) row[j] = H[k][j] * inv_d;
#pragma unroll
    for (int i = 0; i < NV; ++i) col[i] = i == k ? 0.0f : H[i][k];
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < NV; ++j) H[i][j] = H[i][j] - col[i] * row[j];
#pragma unroll
    for (int i = 0; i < NV; ++i) H[i][k] = i == k ? inv_d : -col[i] * inv_d;
#pragma unroll
    for (int j = 0; j < NV; ++j) H[k][j] = j == k ? inv_d : row[j];
  }

  // ---- qdd = H^-1 (rhs - C)
  float r[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) r[j] = rhs[j * N + n] - C[j];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      hinv_out[(i * NV + j) * N + n] = H[i][j];
      acc += H[i][j] * r[j];
    }
    qdd_out[i * N + n] = acc;
  }
}

}  // namespace

extern "C" int dyn_forward_launch(int device, const float* bx, const float* bq,
                                  const float* S, const float* qd,
                                  const float* rhs, const float* diag,
                                  const float* mass_scale,
                                  const float* shape_scale, float* qdd,
                                  float* hinv, float* io, int N, void* stream) {
  if (N <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (N + dyn::kThreads - 1) / dyn::kThreads;
  dyn_forward_kernel<<<blocks, dyn::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      bx, bq, S, qd, rhs, diag, mass_scale, shape_scale, qdd, hinv, io, N);
  return static_cast<int>(cudaGetLastError());
}
