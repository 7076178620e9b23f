// Shared device code of the batch-last dynamics kernels B1-B3.
//
// Compiled with the per-scene header (namespace `scene`, generated by
// isaacgymenvs_ma_tpu_torch/physics/dyn_kernel.py:scene_header) force-included
// ahead of this file, so NB/NV/NQ and the tree tables are compile-time
// constants.  Every loop over bodies or dofs has a constant trip count and is
// unrolled, which turns each table lookup into an immediate.
//
// Layout: every global array is batch-last, element (i, n) of an (M, N)
// array at p[i * N + n]; one thread owns env n.
#pragma once

#include <cuda_runtime.h>

namespace dyn {

constexpr int kThreads = 32;   // one warp per block: 4096 envs -> 128 blocks

__device__ __forceinline__ void qmul(const float a[4], const float b[4],
                                     float o[4]) {
  o[0] = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1];
  o[1] = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0];
  o[2] = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3];
  o[3] = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2];
}

// rotate v by unit quaternion q: v + w t + xyz x t with t = 2 xyz x v
__device__ __forceinline__ void qapply(const float q[4], const float v[3],
                                       float o[3]) {
  const float tx = 2.0f * (q[1] * v[2] - q[2] * v[1]);
  const float ty = 2.0f * (q[2] * v[0] - q[0] * v[2]);
  const float tz = 2.0f * (q[0] * v[1] - q[1] * v[0]);
  o[0] = v[0] + q[3] * tx + q[1] * tz - q[2] * ty;
  o[1] = v[1] + q[3] * ty + q[2] * tx - q[0] * tz;
  o[2] = v[2] + q[3] * tz + q[0] * ty - q[1] * tx;
}

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// spatial motion cross product a x b on [ang, lin] 6-vectors
__device__ __forceinline__ void cross_motion(const float a[6], const float b[6],
                                             float o[6]) {
  float t0[3], t1[3], t2[3];
  cross(a, b, t0);
  cross(a, b + 3, t1);
  cross(a + 3, b, t2);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = t0[k];
    o[3 + k] = t1[k] + t2[k];
  }
}

// spatial force cross product v x* f
__device__ __forceinline__ void cross_force(const float v[6], const float f[6],
                                            float o[6]) {
  float t0[3], t1[3], t2[3];
  cross(v, f, t0);
  cross(v + 3, f + 3, t1);
  cross(v, f + 3, t2);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = t0[k] + t1[k];
    o[3 + k] = t2[k];
  }
}

// y = A x for a row-major 6x6 A
__device__ __forceinline__ void matvec6(const float A[36], const float x[6],
                                        float y[6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) acc += A[i * 6 + j] * x[j];
    y[i] = acc;
  }
}

// Top-down root-to-body path sums of per-body 6-vectors, in place.
__device__ __forceinline__ void path_sum6(float (&x)[scene::NB][6]) {
#pragma unroll
  for (int i = 0; i < scene::NB; ++i) {
    const int b = scene::bottom_up(scene::NB - 1 - i);   // parents first
    const int p = scene::parent(b);
    if (p >= 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) x[b][k] += x[p][k];
    }
  }
}

// Bottom-up subtree sums of per-body K-vectors, in place.
template <int K>
__device__ __forceinline__ void subtree_sum(float (&x)[scene::NB][K]) {
#pragma unroll
  for (int i = 0; i < scene::NB; ++i) {
    const int b = scene::bottom_up(i);                    // children first
    const int p = scene::parent(b);
    if (p >= 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) x[p][k] += x[b][k];
    }
  }
}

// RNEA bias force C (qdd = 0) about the world origin.
//   kFreshGravity: gravity rides the a0 = -g trick through io (fresh I_O);
//   otherwise it comes from the fresh per-body wrench fg(b, k) (cached I_O).
// io(b, k) returns element k of body b's row-major 6x6 spatial inertia.
template <bool kFreshGravity, typename IO, typename FG>
__device__ __forceinline__ void bias_force(const float (&S)[scene::NV][6],
                                           const float (&qd)[scene::NV],
                                           const IO& io, const FG& fg,
                                           float (&C)[scene::NV]) {
  constexpr int NB = scene::NB, NV = scene::NV;
  float V[NB][6], A[NB][6], F[NB][6];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int k = 0; k < 6; ++k) V[b][k] = A[b][k] = 0.0f;
  // body velocities: own joint motion, then root-to-body path sums
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int b = scene::dof_body(v);
#pragma unroll
    for (int k = 0; k < 6; ++k) V[b][k] += S[v][k] * qd[v];
  }
  path_sum6(V);
  // velocity-product accelerations xi = V_body x (S qd), path-summed
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int b = scene::dof_body(v);
    float sqd[6], xi[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) sqd[k] = S[v][k] * qd[v];
    cross_motion(V[b], sqd, xi);
#pragma unroll
    for (int k = 0; k < 6; ++k) A[b][k] += xi[k];
  }
  path_sum6(A);
  // per-body force I a + V x* (I V), then subtree sums
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float I[36], a[6], Iv[6], Ia[6], cf[6];
#pragma unroll
    for (int k = 0; k < 36; ++k) I[k] = io(b, k);
#pragma unroll
    for (int k = 0; k < 6; ++k)
      a[k] = kFreshGravity ? scene::a0(b, k) + A[b][k] : A[b][k];
    matvec6(I, V[b], Iv);
    matvec6(I, a, Ia);
    cross_force(V[b], Iv, cf);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      F[b][k] = Ia[k] + cf[k];
      if (!kFreshGravity) F[b][k] += fg(b, k);
    }
  }
  subtree_sum<6>(F);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int b = scene::dof_body(v);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) acc += S[v][k] * F[b][k];
    C[v] = acc;
  }
}

}  // namespace dyn
