// Shared device code of the batch-last dynamics kernels B1-B3: quaternion
// and spatial-vector arithmetic on small arrays in registers.
//
// Compiled with the per-scene header (namespace `scene`, generated by
// isaacgymenvs_ma_tpu_torch/physics/dyn_kernel.py:scene_header) force-included
// ahead of this file.  Every global array is batch-last, element (i, n) of
// an (M, N) array at p[i * N + n].
#pragma once

#include <cuda_runtime.h>

namespace dyn {

// A read of a scene table in device memory (through the read-only cache).
template <typename V>
__device__ __forceinline__ V tab(const V* p, int i) { return __ldg(p + i); }

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

}  // namespace dyn
