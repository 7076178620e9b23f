// B1: fused forward kinematics + world-origin motion subspace.
//
// Replaces the TPU kernel isaacgymenvs_ma_tpu/physics/dyn_kernel.py:
// fk_motion_pallas (body _fk_motion_bl).  Plain twin:
// isaacgymenvs_ma_tpu_torch/physics/dyn_kernel.py:_fk_motion_bl.
//
// In:  q (NQ, N).  Out: body_x (NB, 3, N), body_q (NB, 4, N) xyzw,
// S (NV, 6, N) [ang; lin] about the world origin.  All batch-last f32.
//
// Design: one thread per env walks the static tree (unrolled at compile time
// from the scene header), keeping each body's pose in registers for its
// children.  Handles FREE, HINGE, SCREW, SLIDE and FIXED joints.
//
// What bounds it on the H100: latency, not bytes or arithmetic — 15 loads
// and 147 stores per env (648 B, 2.7 MB at 4096 envs) and a few hundred
// FLOPs.  Loads and stores are coalesced (neighbouring threads, neighbouring
// envs) and the working set fits in registers (no spills).  At 4096 envs the
// grid is only 128 one-warp blocks for 132 SMs, so the card is under-filled
// and each SM runs one warp with nothing to hide latency; a fused substep
// would amortize it (later work).
#include "dyn_common.cuh"

namespace {

__global__ void __launch_bounds__(dyn::kThreads)
fk_motion_kernel(const float* __restrict__ q, float* __restrict__ bx,
                 float* __restrict__ bq, float* __restrict__ S, int N) {
  namespace sc = scene;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;   // ragged last block
  float xs[sc::NB][3], qs[sc::NB][4];
#pragma unroll
  for (int b = 0; b < sc::NB; ++b) {
    const int t = sc::jtype(b), qa = sc::qadr(b), p = sc::parent(b);
    float xp[3] = {0.0f, 0.0f, 0.0f}, qp[4] = {0.0f, 0.0f, 0.0f, 1.0f};
    if (p >= 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) xp[k] = xs[p][k];
#pragma unroll
      for (int k = 0; k < 4; ++k) qp[k] = qs[p][k];
    }
    float xb[3], qb[4];
    if (t == sc::FREE) {
#pragma unroll
      for (int k = 0; k < 3; ++k) xb[k] = q[(qa + k) * N + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) qb[k] = q[(qa + 3 + k) * N + n];
    } else {
      const float bqc[4] = {sc::body_quat(b, 0), sc::body_quat(b, 1),
                            sc::body_quat(b, 2), sc::body_quat(b, 3)};
      float ql[4], tl[3];
      if (t == sc::HINGE || t == sc::SCREW) {
        const float qv = q[qa * N + n];
        const float half = 0.5f * qv;
        const float s = sinf(half), c = cosf(half);
        const float qj[4] = {sc::axis(b, 0) * s, sc::axis(b, 1) * s,
                             sc::axis(b, 2) * s, c};
        dyn::qmul(bqc, qj, ql);
        const float anc[3] = {sc::anchor(b, 0), sc::anchor(b, 1),
                              sc::anchor(b, 2)};
        float r[3];
        dyn::qapply(ql, anc, r);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          tl[k] = sc::tl0(b, k) - r[k];
          if (t == sc::SCREW) tl[k] += sc::awb(b, k) * (sc::pitch(b) * qv);
        }
      } else if (t == sc::SLIDE) {
        const float qv = q[qa * N + n];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          tl[k] = sc::body_pos(b, k) + sc::awb(b, k) * qv;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) ql[k] = bqc[k];
      } else {  // FIXED
#pragma unroll
        for (int k = 0; k < 3; ++k) tl[k] = sc::body_pos(b, k);
#pragma unroll
        for (int k = 0; k < 4; ++k) ql[k] = bqc[k];
      }
      float r[3];
      dyn::qapply(qp, tl, r);
#pragma unroll
      for (int k = 0; k < 3; ++k) xb[k] = xp[k] + r[k];
      dyn::qmul(qp, ql, qb);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      xs[b][k] = xb[k];
      bx[(b * 3 + k) * N + n] = xb[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      qs[b][k] = qb[k];
      bq[(b * 4 + k) * N + n] = qb[k];
    }
    // motion-subspace columns of this body's dofs
    const int va = sc::vadr(b);
    if (t == sc::FREE) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        // linear dof i: [0; e_i]
#pragma unroll
        for (int k = 0; k < 6; ++k)
          S[((va + i) * 6 + k) * N + n] = (k == 3 + i) ? 1.0f : 0.0f;
        // angular dof i about the body origin: [e_i; x_b x e_i]
        float e[3] = {0.0f, 0.0f, 0.0f}, l[3];
        e[i] = 1.0f;
        dyn::cross(xb, e, l);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          S[((va + 3 + i) * 6 + k) * N + n] = e[k];
          S[((va + 3 + i) * 6 + 3 + k) * N + n] = l[k];
        }
      }
    } else if (t != sc::FIXED) {
      const float ax[3] = {sc::axis(b, 0), sc::axis(b, 1), sc::axis(b, 2)};
      float aw[3];
      dyn::qapply(qb, ax, aw);
      float ang[3], lin[3];
      if (t == sc::SLIDE) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          ang[k] = 0.0f;
          lin[k] = aw[k];
        }
      } else {
        const float anc[3] = {sc::anchor(b, 0), sc::anchor(b, 1),
                              sc::anchor(b, 2)};
        float r[3], anch_w[3];
        dyn::qapply(qb, anc, r);
#pragma unroll
        for (int k = 0; k < 3; ++k) anch_w[k] = xb[k] + r[k];
        dyn::cross(anch_w, aw, lin);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          if (t == sc::SCREW) lin[k] += sc::pitch(b) * aw[k];
          ang[k] = aw[k];
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        S[(va * 6 + k) * N + n] = ang[k];
        S[(va * 6 + 3 + k) * N + n] = lin[k];
      }
    }
  }
}

}  // namespace

extern "C" int fk_motion_launch(int device, const float* q, float* bx,
                                float* bq, float* S, int N, void* stream) {
  if (N <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (N + dyn::kThreads - 1) / dyn::kThreads;
  fk_motion_kernel<<<blocks, dyn::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(q, bx, bq, S, N);
  return static_cast<int>(cudaGetLastError());
}
