// B1: fused forward kinematics + world-origin motion subspace.
//
// Replaces the TPU kernel isaacgymenvs_ma_tpu/physics/dyn_kernel.py:
// fk_motion_pallas (body _fk_motion_bl).  Plain twin:
// isaacgymenvs_ma_tpu_torch/physics/dyn_kernel.py:_fk_motion_bl.
//
// In:  q (NQ, N).  Out: body_x (NB, 3, N), body_q (NB, 4, N) xyzw,
// S (NV, 6, N) [ang; lin] about the world origin.  All batch-last f32.
// Handles FREE, HINGE, SCREW, SLIDE and FIXED joints.
//
// What bounds it on the H100: bytes in principle (Franka: 32 floats in and
// 425 out per env, 15 MB at 8192 envs, 4.5 us at 3.35 TB/s; a few hundred
// FLOP per body), latency and instruction issue in practice: a body's pose
// needs its parent's, a chain 11 bodies deep at FrankaReachMA.  The
// one-thread kernel walked all 35 bodies serially per thread in one-warp
// blocks, ~2 warps per SM at 8192 envs.  Design:
//   * A team of B1_TEAM lanes (8 while no tree level is wider than 16
//     bodies) owns one env, so a warp carries several envs; B1_ENVS envs
//     share a block of 256 threads.  The block stages q with cp.async
//     (coalesced) into shared memory, and in the same batch of copies the
//     scene tables (each body's joint constants, the tree levels:
//     scene::b1_itab, b1_ftab), so that a lane's lookups of its body's
//     entries are shared-memory reads, not chains of dependent
//     device-memory reads.
//   * Each lane turns its bodies' joint coordinates into joint-local
//     rotations and translations (one sin/cos per hinge) in shared memory;
//     then the team poses the tree level by level, parents first, one lane
//     per body of the level and one __syncwarp per level (the same float
//     operations in the same order as the twin's walk).  A team per env
//     with one lane per body and each lane composing its own root path
//     (no barrier, 32 lanes for one env) issued 10-20x the instructions of
//     this for the same envs and ran slower than the one-thread kernel at
//     Franka.  Last, each lane writes its bodies' columns of S.
//   * Outputs go through shared memory and out with consecutive threads on
//     consecutive envs, so every global row is a coalesced run of B1_ENVS
//     floats.
#include "dyn_common.cuh"
#include "team.cuh"

namespace {

namespace sc = scene;
constexpr int NB = sc::NB;
constexpr int T = sc::B1_TEAM, E = sc::B1_ENVS, W = sc::B1_FLOATS;
constexpr int kBlock = T * E;
static_assert(32 % T == 0, "a team never spans two warps");

// The block's copy of the scene tables (scene::b1_itab, b1_ftab) in
// shared memory: the joint constants of each body and the tree levels.
struct Tables {
  const int* i;
  const float* f;
  __device__ int type(int b) const { return i[sc::B1T_TYPE + b]; }
  __device__ int qadr(int b) const { return i[sc::B1T_QADR + b]; }
  __device__ int vadr(int b) const { return i[sc::B1T_VADR + b]; }
  __device__ int parent(int b) const { return i[sc::B1T_PARENT + b]; }
  __device__ int lvl_body(int k) const { return i[sc::B1T_LVL_BODY + k]; }
  __device__ float pitch(int b) const { return f[sc::B1T_PITCH + b]; }
  // component k of body b's entry in the float table at `off`, n wide
  __device__ float at(int off, int n, int b, int k) const {
    return f[off + b * n + k];
  }
  template <int n>
  __device__ void vec(int off, int b, float* o) const {
#pragma unroll
    for (int k = 0; k < n; ++k) o[k] = at(off, n, b, k);
  }
};

// Joint-local rotation ql (LOC[0:4]) and translation tl (LOC[4:7]) of body
// b, as _fk_motion_bl; a FREE body's are its world pose, read from q.
__device__ __forceinline__ void joint_local(const Tables& tb, const float* Q,
                                            float* LOC, int b) {
  const int t = tb.type(b), qa = tb.qadr(b);
  float ql[4], tl[3];
  if (t == sc::FREE) {
#pragma unroll
    for (int k = 0; k < 3; ++k) tl[k] = Q[qa + k];
#pragma unroll
    for (int k = 0; k < 4; ++k) ql[k] = Q[qa + 3 + k];
  } else if (t == sc::HINGE || t == sc::SCREW) {
    const float qv = Q[qa];
    const float half = 0.5f * qv;
    const float s = sinf(half), c = cosf(half);
    float bq[4], ax[3], anc[3], r[3];
    tb.vec<4>(sc::B1T_BQ, b, bq);
    tb.vec<3>(sc::B1T_AXIS, b, ax);
    tb.vec<3>(sc::B1T_ANCHOR, b, anc);
    const float qj[4] = {ax[0] * s, ax[1] * s, ax[2] * s, c};
    dyn::qmul(bq, qj, ql);
    dyn::qapply(ql, anc, r);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      tl[k] = tb.at(sc::B1T_TL0, 3, b, k) - r[k];
      if (t == sc::SCREW)
        tl[k] += tb.at(sc::B1T_AWB, 3, b, k) * (tb.pitch(b) * qv);
    }
  } else {
    tb.vec<4>(sc::B1T_BQ, b, ql);
    const float qv = t == sc::SLIDE ? Q[qa] : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      tl[k] = tb.at(sc::B1T_BP, 3, b, k);
      if (t == sc::SLIDE) tl[k] += tb.at(sc::B1T_AWB, 3, b, k) * qv;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) LOC[b * 8 + k] = ql[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) LOC[b * 8 + 4 + k] = tl[k];
}

// World pose of body b from its parent's (x = x_p + q_p tl, q = q_p ql; the
// world origin for a root; a FREE body's own), into BX / BQ.
__device__ __forceinline__ void pose(const Tables& tb, const float* LOC,
                                     float* BX, float* BQ, int b) {
  const float* L = LOC + b * 8;
  float x[3], q[4];
  if (tb.type(b) == sc::FREE) {
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = L[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = L[4 + k];
  } else {
    const int p = tb.parent(b);
    float xp[3] = {0.0f, 0.0f, 0.0f}, qp[4] = {0.0f, 0.0f, 0.0f, 1.0f};
    if (p >= 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) xp[k] = BX[p * 3 + k];
#pragma unroll
      for (int k = 0; k < 4; ++k) qp[k] = BQ[p * 4 + k];
    }
    const float ql[4] = {L[0], L[1], L[2], L[3]};
    const float tl[3] = {L[4], L[5], L[6]};
    float r[3];
    dyn::qapply(qp, tl, r);
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = xp[k] + r[k];
    dyn::qmul(qp, ql, q);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) BX[b * 3 + k] = x[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) BQ[b * 4 + k] = q[k];
}

// Body b's columns of S (rows v * 6 + k of the env's S).
__device__ __forceinline__ void motion_columns(const Tables& tb, float* S,
                                               int b, const float x[3],
                                               const float q[4]) {
  const int t = tb.type(b), va = tb.vadr(b);
  if (t == sc::FREE) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      // linear dof i: [0; e_i]; angular dof i about the body origin:
      // [e_i; x_b x e_i]
      float e[3] = {0.0f, 0.0f, 0.0f}, l[3];
      e[i] = 1.0f;
      dyn::cross(x, e, l);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        S[(va + i) * 6 + k] = 0.0f;
        S[(va + i) * 6 + 3 + k] = e[k];
        S[(va + 3 + i) * 6 + k] = e[k];
        S[(va + 3 + i) * 6 + 3 + k] = l[k];
      }
    }
  } else if (t != sc::FIXED) {
    float ax[3], aw[3], lin[3];
    tb.vec<3>(sc::B1T_AXIS, b, ax);
    dyn::qapply(q, ax, aw);
    if (t == sc::SLIDE) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        S[va * 6 + k] = 0.0f;
        S[va * 6 + 3 + k] = aw[k];
      }
    } else {
      float anc[3], r[3], anch_w[3];
      tb.vec<3>(sc::B1T_ANCHOR, b, anc);
      dyn::qapply(q, anc, r);
#pragma unroll
      for (int k = 0; k < 3; ++k) anch_w[k] = x[k] + r[k];
      dyn::cross(anch_w, aw, lin);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (t == sc::SCREW) lin[k] += tb.pitch(b) * aw[k];
        S[va * 6 + k] = aw[k];
        S[va * 6 + 3 + k] = lin[k];
      }
    }
  }
}

__global__ void __launch_bounds__(kBlock, 1024 / kBlock)
fk_motion_kernel(const float* __restrict__ q, float* __restrict__ bx,
                 float* __restrict__ bq, float* __restrict__ S, int N) {
  extern __shared__ float smem[];
  const Tables tb{reinterpret_cast<const int*>(smem), smem + sc::B1T_NI};
  float* envs = smem + sc::B1_SHARED;
  const int n0 = blockIdx.x * E;
  const int lane = threadIdx.x % T;
  float* env = envs + (threadIdx.x / T) * W;
  float* LOC = env + sc::B1_LOC;   // (NB, 8): ql, tl, pad
  float* BX = env + sc::B1_BX;     // (NB, 3) as in global memory
  float* BQ = env + sc::B1_BQ;     // (NB, 4)
  float* SS = env + sc::B1_S;      // (NV, 6)

  team::stage_table<kBlock>(smem, sc::b1_itab, sc::B1T_NI);
  team::stage_table<kBlock>(smem + sc::B1T_NI, sc::b1_ftab, sc::B1T_NF);
  team::stage<E, W, kBlock>(envs, sc::B1_Q, q, sc::NQ, n0, N);
  team::stage_wait();
  __syncthreads();

  for (int b = lane; b < NB; b += T) joint_local(tb, env + sc::B1_Q, LOC, b);
  __syncwarp();
  // poses level by level, parents first: one lane per body of the level
#pragma unroll
  for (int L = 0; L < sc::NLEV; ++L) {
    const int lo = sc::lvl_off(L), cnt = sc::lvl_off(L + 1) - lo;
    for (int i = lane; i < cnt; i += T)
      pose(tb, LOC, BX, BQ, tb.lvl_body(lo + i));
    __syncwarp();
  }
  for (int b = lane; b < NB; b += T) {
    const float x[3] = {BX[b * 3], BX[b * 3 + 1], BX[b * 3 + 2]};
    const float qb[4] = {BQ[b * 4], BQ[b * 4 + 1], BQ[b * 4 + 2],
                         BQ[b * 4 + 3]};
    motion_columns(tb, SS, b, x, qb);
  }
  __syncthreads();
  team::store<E, W, kBlock>(bx, 3 * NB, n0, N, envs, sc::B1_BX);
  team::store<E, W, kBlock>(bq, 4 * NB, n0, N, envs, sc::B1_BQ);
  team::store<E, W, kBlock>(S, 6 * sc::NV, n0, N, envs, sc::B1_S);
}

}  // namespace

extern "C" int fk_motion_launch(int device, const float* q, float* bx,
                                float* bq, float* S, int N, void* stream) {
  if (N <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int bytes = sc::B1_SMEM_BYTES;
  err = team::allow_smem(fk_motion_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + E - 1) / E;
  fk_motion_kernel<<<blocks, kBlock, bytes,
                     static_cast<cudaStream_t>(stream)>>>(q, bx, bq, S, N);
  return static_cast<int>(cudaGetLastError());
}
