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
// Out: qdd (NV,N), Hinv (NV,NV,N) dense, zero off H's blocks, I_O (NB,6,6,N)
// (the cache for B3).
//
// What bounds it on the H100: bytes.  The function moves its inputs and
// outputs once (88 MB at FrankaReachMA-8192: I_O and H^-1 are most of it,
// 26 us at 3.35 TB/s) and does ~25k FLOP per env (3 us at 67 TFLOP/s).  A
// thread that owns a whole env cannot hold its working set (Franka: I_O
// 1,260 floats, H 900, S 180, the RNEA vectors) in 255 registers: the
// one-thread kernel spilled ~190 KB per thread, ~1.5 GB of local-memory
// traffic per launch, and ran 128 one-warp blocks at 4096 envs, one warp of
// an SM's 64 to hide latency.  Design:
//   * A team of B2_TEAM lanes (8-32, from the plan: one lane per body or
//     dof) owns one env; B2_ENVS envs share a block.  The env's working set
//     lives in shared memory (B2_FLOATS floats per env, odd so neighbouring
//     envs fall in different banks), not in registers: nothing spills, and
//     an SM holds several blocks.
//   * Inputs are staged by the whole block with cp.async and outputs
//     written back with consecutive threads on consecutive envs, so every
//     global access is a coalesced run of B2_ENVS floats per row; I_O is
//     written once, before its composite sums overwrite it in place.
//   * Spatial inertia, the per-body RNEA forces (rnea.cuh, shared with B3)
//     and the CRBA column forces take one lane per body or dof.  Path sums
//     (velocities, accelerations) go level by level over the tree, and
//     subtree sums (forces and composite inertias, 42 components in one
//     run) over the bodies that have children, one (body, component) per
//     lane, from the compile-time tables lvl_off / gat_off and the lanes'
//     device tables (b2_*).
//   * H is block diagonal: FrankaReachMA's 30 x 30 is two 9-dof arms and
//     two 6-dof cubes.  CRBA fills only the dof_anc pairs (one per lane).
//     The sweep runs every block at once: each lane holds its dof's row of
//     H in registers, in block-local columns, and at step k the lane of
//     each block's k-th dof publishes its row in shared memory for the
//     block's other lanes: MAXBLK steps of MAXBLK multiply-adds per lane,
//     one __syncwarp each, instead of NV steps over NV^2 entries.  Entries
//     off the blocks are written as exact zeros, as the dense sweep leaves
//     them; each entry on a block sees the dense sweep's arithmetic.  qdd
//     sums over the row's block.
// Only the order of float sums differs from the one-thread kernel.
#include "dyn_common.cuh"
#include "rnea.cuh"
#include "team.cuh"

namespace {

namespace sc = scene;
constexpr int NB = sc::NB, NV = sc::NV;
constexpr int T = sc::B2_TEAM, E = sc::B2_ENVS, W = sc::B2_FLOATS;
constexpr int HS = sc::B2_HS;            // row stride of H in shared memory
constexpr int kBlock = T * E;
constexpr int RD = (NV + T - 1) / T;  // dofs per lane
static_assert(32 % T == 0, "a team never spans two warps");
static_assert(sc::B2_FB == sc::B2_IO + 36 * NB,
              "I_O and F form one run of 42 components");

using dyn::tab;

__device__ __forceinline__ void stage(float* smem, int off,
                                      const float* __restrict__ g, int M,
                                      int n0, int N) {
  team::stage<E, W, kBlock>(smem, off, g, M, n0, N);
}

// World spatial inertia of body b about the origin into IO(k, b).
__device__ __forceinline__ void spatial_inertia(const float* env, float* IO,
                                                int b, bool has_ms,
                                                bool has_ss) {
  const float* q = env + sc::B2_BQ + b * 4;
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float R[3][3] = {
      {1.0f - 2.0f * (yy + zz), 2.0f * (xy - wz), 2.0f * (xz + wy)},
      {2.0f * (xy + wz), 1.0f - 2.0f * (xx + zz), 2.0f * (yz - wx)},
      {2.0f * (xz - wy), 2.0f * (yz + wx), 1.0f - 2.0f * (xx + yy)}};
  float I[3][3], com[3], m = tab(sc::b2_mass, b);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    com[i] = tab(sc::b2_com, b * 3 + i);
#pragma unroll
    for (int j = 0; j < 3; ++j) I[i][j] = tab(sc::b2_inertia, b * 9 + i * 3 + j);
  }
  if (has_ss) {
    // uniform-density second-moment transform C' = svol * S C S
    float s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = env[sc::B2_SS + b * 3 + k];
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
    c[i] = env[sc::B2_BX + b * 3 + i] +
           (R[i][0] * com[0] + R[i][1] * com[1] + R[i][2] * com[2]);
  }
  if (has_ms) {
    const float ms = env[sc::B2_MS + b];
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
      IO[(i * 6 + j) * NB + b] = Ic[i][j] - m * cxcx;        // top-left
      IO[(i * 6 + 3 + j) * NB + b] = m * cx[i][j];           // top-right
      IO[((3 + i) * 6 + j) * NB + b] = -(m * cx[i][j]);      // bottom-left
      IO[((3 + i) * 6 + 3 + j) * NB + b] = i == j ? m : 0.0f;
    }
}

__global__ void __launch_bounds__(kBlock, 1)
dyn_forward_kernel(const float* __restrict__ bx, const float* __restrict__ bq,
                   const float* __restrict__ Sg, const float* __restrict__ qdg,
                   const float* __restrict__ rhs,
                   const float* __restrict__ diag,
                   const float* __restrict__ mass_scale,
                   const float* __restrict__ shape_scale,
                   float* __restrict__ qdd_out, float* __restrict__ hinv_out,
                   float* __restrict__ io_out, int N) {
  extern __shared__ float smem[];
  const int n0 = blockIdx.x * E;
  const int lane = threadIdx.x % T;
  float* env = smem + (threadIdx.x / T) * W;
  float* IO = env + sc::B2_IO;     // (36, NB): I_O, then composite inertias
  float* FB = env + sc::B2_FB;     // (6, NB): body forces, then subtree sums
  float* V = env + sc::B2_V;       // (6, NB) body velocities
  float* A = env + sc::B2_A;       // (6, NB) velocity-product accelerations
  float* S = env + sc::B2_S;       // (NV, 6) as in global memory
  float* QD = env + sc::B2_QD;
  float* RHS = env + sc::B2_RHS;   // rhs, then rhs - C
  float* DIAG = env + sc::B2_DIAG;
  float* QDD = env + sc::B2_QDD;
  float* FD = env + sc::B2_FD;     // (NV, 6) CRBA column forces
  float* H = env + sc::B2_H;       // (NV, HS): H, then H^-1

  // ---- stage the block's inputs (body_x/q and the scales share F, V, A)
  stage(smem, sc::B2_BX, bx, 3 * NB, n0, N);
  stage(smem, sc::B2_BQ, bq, 4 * NB, n0, N);
  if (mass_scale != nullptr) stage(smem, sc::B2_MS, mass_scale, NB, n0, N);
  if (shape_scale != nullptr)
    stage(smem, sc::B2_SS, shape_scale, 3 * NB, n0, N);
  stage(smem, sc::B2_S, Sg, 6 * NV, n0, N);
  stage(smem, sc::B2_QD, qdg, NV, n0, N);
  stage(smem, sc::B2_RHS, rhs, NV, n0, N);
  stage(smem, sc::B2_DIAG, diag, NV, n0, N);
  team::stage_wait();
  __syncthreads();

  // ---- world spatial inertia, one lane per body
  for (int b = lane; b < NB; b += T)
    spatial_inertia(env, IO, b, mass_scale != nullptr, shape_scale != nullptr);
  __syncthreads();
  // I_O out: element (b, k) at IO[k * NB + b]
  team::store<E, W, kBlock>(io_out, NB * 36, n0, N, smem, sc::B2_IO,
                    [](int i) { return (i % 36) * NB + i / 36; });

  // ---- RNEA bias force against the fresh I_O (gravity through a0)
  const rnea::GlobalTables tb;
  rnea::own_motion<T>(S, QD, V, tb, lane);
  __syncwarp();
  rnea::path_sum_levels<T>(V, tb, lane);
  rnea::velocity_products<T>(S, QD, V, A, tb, lane);
  __syncwarp();
  rnea::path_sum_levels<T>(A, tb, lane);
  rnea::body_forces<T, true>(IO, V, A, nullptr, FB, tb, lane);
  __syncthreads();   // the I_O store is done reading: sum in place
  rnea::subtree_sum_levels<T, 42>(IO, tb, lane);   // composite I_O and F

  // ---- C, rhs - C, CRBA column forces F_v = Icomp(body v) S_v; zero H
  for (int v = lane; v < NV; v += T) {
    const int b = tab(sc::b2_dof_body, v);
    float c = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) c += S[v * 6 + k] * FB[k * NB + b];
    RHS[v] = RHS[v] - c;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) acc += IO[(i * 6 + j) * NB + b] * S[v * 6 + j];
      FD[v * 6 + i] = acc;
    }
  }
  for (int it = lane; it < NV * HS; it += T) H[it] = 0.0f;
  __syncwarp();
  // H(i, j) = H(j, i) = S_i . F_j for each pair with i an ancestor dof of j
  for (int it = lane; it < sc::NPAIR; it += T) {
    const int pr = tab(sc::b2_pair, it), i = pr & 255, j = pr >> 8;
    float g = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) g += S[i * 6 + k] * FD[j * 6 + k];
    if (i == j) {
      H[i * HS + i] = g + DIAG[i];
    } else {
      H[i * HS + j] = g;
      H[j * HS + i] = g;
    }
  }
  __syncwarp();

  // ---- block sweep (Gauss-Jordan, no pivoting), all blocks at once: each
  // lane keeps its dofs' rows of H in registers, in block-local columns; at
  // step k the lane of each block's k-th dof publishes its row, and every
  // lane of the block updates its own row against it
  constexpr int MB = sc::MAXBLK;
  float h[RD][MB];
  int blk[RD];
#pragma unroll
  for (int q = 0; q < RD; ++q) {
    const int i = min(lane + q * T, NV - 1);    // lanes past NV: unused copy
    blk[q] = tab(sc::b2_dof_block, i);
    const int base = blk[q] & 255, size = (blk[q] >> 8) & 255;
#pragma unroll
    for (int c = 0; c < MB; ++c)
      h[q][c] = c < size ? H[i * HS + tab(sc::b2_block_dofs, base + c)] : 0.0f;
  }
  __syncwarp();              // H's space now holds the pivot rows
#pragma unroll
  for (int k = 0; k < MB; ++k) {
#pragma unroll
    for (int q = 0; q < RD; ++q) {
      const int i = lane + q * T;
      if (i < NV && (blk[q] >> 16) == k) {
#pragma unroll
        for (int c = 0; c < MB; ++c) H[i * HS + c] = h[q][c];
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < RD; ++q) {
      const int i = lane + q * T;
      const int base = blk[q] & 255, size = (blk[q] >> 8) & 255;
      if (i < NV && k < size) {
        const float* prow = H + tab(sc::b2_block_dofs, base + k) * HS;
        const float inv_d = 1.0f / prow[k];
        if ((blk[q] >> 16) == k) {
#pragma unroll
          for (int c = 0; c < MB; ++c)
            h[q][c] = c == k ? inv_d : prow[c] * inv_d;
        } else {
          const float col = h[q][k];
#pragma unroll
          for (int c = 0; c < MB; ++c)
            h[q][c] = c == k ? -col * inv_d : h[q][c] - col * (prow[c] * inv_d);
        }
      }
    }
  }
  __syncwarp();              // the last pivot row is read
#pragma unroll
  for (int q = 0; q < RD; ++q) {
    const int i = lane + q * T;
    if (i < NV) {
      const int base = blk[q] & 255, size = (blk[q] >> 8) & 255;
      for (int j = 0; j < NV; ++j) H[i * HS + j] = 0.0f;
#pragma unroll
      for (int c = 0; c < MB; ++c)
        if (c < size) H[i * HS + tab(sc::b2_block_dofs, base + c)] = h[q][c];
    }
  }
  __syncwarp();

  // ---- qdd = H^-1 (rhs - C) over each dof's block
  for (int v = lane; v < NV; v += T) {
    const int db = tab(sc::b2_dof_block, v);
    const int base = db & 255, size = (db >> 8) & 255;
    float acc = 0.0f;
    for (int q = base; q < base + size; ++q) {
      const int j = tab(sc::b2_block_dofs, q);
      acc += H[v * HS + j] * RHS[j];
    }
    QDD[v] = acc;
  }
  __syncthreads();
  team::store<E, W, kBlock>(qdd_out, NV, n0, N, smem, sc::B2_QDD);
  team::store<E, W, kBlock>(hinv_out, NV * NV, n0, N, smem, sc::B2_H,
                    [](int i) { return (i / NV) * HS + i % NV; });
}

}  // namespace

extern "C" int dyn_forward_launch(int device, const float* bx, const float* bq,
                                  const float* S, const float* qd,
                                  const float* rhs, const float* diag,
                                  const float* mass_scale,
                                  const float* shape_scale, float* qdd,
                                  float* hinv, float* io, int N, void* stream) {
  if (N <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int bytes = sc::B2_SMEM_BYTES;
  err = team::allow_smem(dyn_forward_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + E - 1) / E;
  dyn_forward_kernel<<<blocks, kBlock, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      bx, bq, S, qd, rhs, diag, mass_scale, shape_scale, qdd, hinv, io, N);
  return static_cast<int>(cudaGetLastError());
}
