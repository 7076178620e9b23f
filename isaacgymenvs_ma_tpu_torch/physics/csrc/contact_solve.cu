// B4: contact/constraint iteration loop (projected Jacobi with relaxation).
//
// Replaces the TPU kernel isaacgymenvs_ma_tpu/physics/contact_kernel.py:221
// solve_pallas (body solve_bl).  Plain twin:
// isaacgymenvs_ma_tpu_torch/physics/contact_kernel.py:solve_bl.
//
// Per env and iteration, in this order: grab rows (bilateral, gated by
// g_act) -> attractor rows (bilateral) -> contact rows (normal impulse
// clamped >= 0, friction box |lam_t| <= mu lam_n, Jacobi inside the group)
// -> joint limits.  Each group ends with qd += H^-1 (J^T dlam).  Outputs
// the final qd, the contact impulses in row coordinates and J^T lam.
//
// In (batch-last f32, element (i, n) at p[i * N + n]): S (NV,6,N),
// Hinv (NV,NV,N), qd (NV,N), pts_c (3,P,N), b_n/mu/active (P,N),
// frames (3c,3l,P,N) or null, w_c (3,P,N), b_lo/b_hi/act_lo/act_hi (NV,N),
// pts_a/b_a/w_a (3,A,N), pts_g/b_g/w_g (3,G,N), g_act (G,N).
// Out: qd (NV,N), lam (3,P,N), imp_dof (NV,N).
//
// The per-plan header (namespace cscene, generated by
// contact_kernel.py:contact_header) is force-included: sizes, iteration
// count, relaxation and the static row masks as constexpr tables.
//
// What bounds it on the H100: bytes, at one pass over its inputs and outputs
// (~11 MB at Ant-4096: H^-1 3.2 MB, S 1.4 MB, the row arrays; 3.3 us at
// 3.35 TB/s).  The function's own arithmetic (J built once, then J qd and
// J^T dlam per iteration: ~1.3e2 MFLOP at Ant-4096) takes less at 67
// TFLOP/s; this kernel does more than that, since it rebuilds J's entries
// every iteration instead of storing them.  The working set is what makes
// it hard: J alone is 3*P*NV floats per env (1,050 for Ant), H^-1 another
// NV*NV, far over 255 registers.  Design:
//   * J is never stored.  A row's velocity is rebuilt from S by linearity,
//     v = sum_v m qd_v S_lin_v + (sum_v m qd_v S_ang_v) x p, and its impulse
//     f enters J^T f as S_lin_v . f + S_ang_v . (p x f).  The row masks are
//     compile-time constants and every row/dof loop is unrolled, so the
//     masked-out dofs cost nothing (about 8 of 14 dofs survive per Ant row).
//   * Only the iteration state lives in registers: qd, the contact impulses
//     (3P) and the two limit impulses (2 NV).  S, H^-1, points, frames and the
//     per-row constants are re-read every iteration through the read-only
//     cache (__ldg); batch-last layout makes each warp load one coalesced
//     128-byte line, and a block's inputs (~100 KB for 32 envs) stay in L1.
//   * H^-1 J^T dlam applies only the dofs a group can touch (used_* tables).
// One thread per env, one-warp blocks: 4096 envs fill 128 of 132 SMs with a
// single warp each, so the loop runs at L1 latency with little to hide it.
// Several threads per env (rows split, partial impulses summed through
// shared memory), or a warp per env with J staged in shared memory, are the
// known ways to a faster loop; this is the simple kernel.
#include <cuda_runtime.h>

namespace {

namespace cs = cscene;
constexpr int kThreads = 32;
constexpr int kContact = 0, kAttractor = 1, kGrab = 2;

// batch-last loads of env n through the read-only cache
struct Env {
  int n, N;
  __device__ __forceinline__ float ld(const float* __restrict__ p,
                                      int i) const {
    return __ldg(p + static_cast<size_t>(i) * N + n);
  }
};

template <int GROUP>
__device__ __forceinline__ float mask(int r, int v) {
  if constexpr (GROUP == kContact) return cs::mask_c(r, v);
  else if constexpr (GROUP == kAttractor) return cs::mask_a(r, v);
  else return cs::mask_g(r, v);
}

template <int GROUP>
__device__ __forceinline__ bool used(int v) {
  if constexpr (GROUP == kContact) return cs::used_c(v);
  else if constexpr (GROUP == kAttractor) return cs::used_a(v);
  else return cs::used_g(v);
}

// world velocity of row r at point p: sum_v m_rv qd_v (S_lin_v + S_ang_v x p)
template <int GROUP>
__device__ __forceinline__ void row_velocity(const Env& e,
                                             const float* __restrict__ S,
                                             const float (&qd)[cs::NV], int r,
                                             const float p[3], float v[3]) {
  float w[3] = {0.0f, 0.0f, 0.0f}, u[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int d = 0; d < cs::NV; ++d) {
    const float m = mask<GROUP>(r, d);
    if (m != 0.0f) {
      const float s = m * qd[d];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        w[k] += s * e.ld(S, d * 6 + k);
        u[k] += s * e.ld(S, d * 6 + 3 + k);
      }
    }
  }
  v[0] = u[0] + (w[1] * p[2] - w[2] * p[1]);
  v[1] = u[1] + (w[2] * p[0] - w[0] * p[2]);
  v[2] = u[2] + (w[0] * p[1] - w[1] * p[0]);
}

// x += J_r^T f for a world impulse f at point p
template <int GROUP>
__device__ __forceinline__ void add_impulse(const Env& e,
                                            const float* __restrict__ S, int r,
                                            const float p[3], const float f[3],
                                            float (&x)[cs::NV]) {
  const float t[3] = {p[1] * f[2] - p[2] * f[1], p[2] * f[0] - p[0] * f[2],
                      p[0] * f[1] - p[1] * f[0]};
#pragma unroll
  for (int d = 0; d < cs::NV; ++d) {
    const float m = mask<GROUP>(r, d);
    if (m != 0.0f) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        acc += e.ld(S, d * 6 + 3 + k) * f[k] + e.ld(S, d * 6 + k) * t[k];
      x[d] += m * acc;
    }
  }
}

// qd += H^-1 x over the dofs x can be nonzero on (all of them for GROUP < 0)
template <int GROUP>
__device__ __forceinline__ void apply_hinv(const Env& e,
                                           const float* __restrict__ Hinv,
                                           const float (&x)[cs::NV],
                                           float (&qd)[cs::NV]) {
#pragma unroll
  for (int i = 0; i < cs::NV; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < cs::NV; ++j) {
      if (GROUP < 0 || used<GROUP>(j)) acc += e.ld(Hinv, i * cs::NV + j) * x[j];
    }
    qd[i] += acc;
  }
}

template <int GROUP>
__device__ __forceinline__ void load_point(const Env& e,
                                           const float* __restrict__ pts,
                                           int rows, int r, float p[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) p[c] = e.ld(pts, c * rows + r);
}

// one bilateral group (attractors, or grabs gated by g_act)
template <int GROUP, int ROWS>
__device__ __forceinline__ void bilateral_group(
    const Env& e, const float* __restrict__ S, const float* __restrict__ Hinv,
    const float* __restrict__ pts, const float* __restrict__ b,
    const float* __restrict__ w, const float* __restrict__ gate,
    float (&qd)[cs::NV]) {
  float x[cs::NV];
#pragma unroll
  for (int d = 0; d < cs::NV; ++d) x[d] = 0.0f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float p[3], v[3], dl[3];
    load_point<GROUP>(e, pts, ROWS, r, p);
    row_velocity<GROUP>(e, S, qd, r, p, v);
    const float g = GROUP == kGrab ? e.ld(gate, r) : 1.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dl[c] = cs::RELAX * (e.ld(b, c * ROWS + r) - v[c]) /
              e.ld(w, c * ROWS + r);
      if (GROUP == kGrab) dl[c] *= g;
    }
    add_impulse<GROUP>(e, S, r, p, dl, x);
  }
  apply_hinv<GROUP>(e, Hinv, x, qd);
}

__global__ void __launch_bounds__(kThreads)
contact_solve_kernel(
    const float* __restrict__ S, const float* __restrict__ Hinv,
    const float* __restrict__ qd_in, const float* __restrict__ pts_c,
    const float* __restrict__ b_n, const float* __restrict__ mu,
    const float* __restrict__ active, const float* __restrict__ frames,
    const float* __restrict__ w_c, const float* __restrict__ b_lo,
    const float* __restrict__ b_hi, const float* __restrict__ act_lo,
    const float* __restrict__ act_hi, const float* __restrict__ pts_a,
    const float* __restrict__ b_a, const float* __restrict__ w_a,
    const float* __restrict__ pts_g, const float* __restrict__ b_g,
    const float* __restrict__ g_act, const float* __restrict__ w_g,
    float* __restrict__ qd_out, float* __restrict__ lam_out,
    float* __restrict__ imp_out, int N) {
  constexpr int NV = cs::NV, P = cs::P;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;   // ragged last block
  const Env e{n, N};

  float qd[NV], lam_lo[NV], lam_hi[NV], lam[3][P];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    qd[v] = e.ld(qd_in, v);
    lam_lo[v] = lam_hi[v] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int r = 0; r < P; ++r) lam[c][r] = 0.0f;

  // F[c][l] of contact row r (identity when the plan has no frames)
  auto frame = [&](int r, float F[3][3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int l = 0; l < 3; ++l)
        F[c][l] = cs::FRAMES ? e.ld(frames, (c * 3 + l) * P + r)
                             : (c == l ? 1.0f : 0.0f);
  };

#pragma unroll 1
  for (int it = 0; it < cs::NITER; ++it) {
    if constexpr (cs::G > 0)
      bilateral_group<kGrab, cs::G>(e, S, Hinv, pts_g, b_g, w_g, g_act, qd);
    if constexpr (cs::A > 0)
      bilateral_group<kAttractor, cs::A>(e, S, Hinv, pts_a, b_a, w_a, nullptr,
                                         qd);
    // ---- contact rows: every row reads the same qd (Jacobi)
    float x[NV];
#pragma unroll
    for (int d = 0; d < NV; ++d) x[d] = 0.0f;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      float p[3], vw[3], vr[3], F[3][3];
      load_point<kContact>(e, pts_c, P, r, p);
      row_velocity<kContact>(e, S, qd, r, p, vw);
      frame(r, F);
#pragma unroll
      for (int l = 0; l < 3; ++l)
        vr[l] = cs::FRAMES ? F[0][l] * vw[0] + F[1][l] * vw[1] + F[2][l] * vw[2]
                           : vw[l];
      const float act = e.ld(active, r);
      const float ln = fmaxf(lam[2][r] + cs::RELAX * (e.ld(b_n, r) - vr[2]) /
                                             e.ld(w_c, 2 * P + r),
                             0.0f) * act;
      const float mf = e.ld(mu, r) * ln;
      const float lt1 = fminf(fmaxf(lam[0][r] + cs::RELAX * (-vr[0]) /
                                                    e.ld(w_c, r),
                                    -mf), mf);
      const float lt2 = fminf(fmaxf(lam[1][r] + cs::RELAX * (-vr[1]) /
                                                    e.ld(w_c, P + r),
                                    -mf), mf);
      const float lnew[3] = {lt1 * act, lt2 * act, ln * act};
      float dl[3], fw[3];
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        dl[l] = lnew[l] - lam[l][r];
        lam[l][r] = lnew[l];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
        fw[c] = cs::FRAMES ? F[c][0] * dl[0] + F[c][1] * dl[1] + F[c][2] * dl[2]
                           : dl[c];
      add_impulse<kContact>(e, S, r, p, fw, x);
    }
    apply_hinv<kContact>(e, Hinv, x, qd);
    // ---- joint limits (J = e_v)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float hd = fmaxf(e.ld(Hinv, v * NV + v), 1e-8f);
      const float lo = e.ld(act_lo, v) *
          fmaxf(lam_lo[v] + cs::RELAX * (e.ld(b_lo, v) - qd[v]) / hd, 0.0f);
      const float hi = e.ld(act_hi, v) *
          fmaxf(lam_hi[v] + cs::RELAX * (e.ld(b_hi, v) + qd[v]) / hd, 0.0f);
      x[v] = (lo - lam_lo[v]) - (hi - lam_hi[v]);
      lam_lo[v] = lo;
      lam_hi[v] = hi;
    }
    apply_hinv<-1>(e, Hinv, x, qd);
  }

  // ---- J^T lam + limit impulses; outputs
  float imp[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) imp[v] = 0.0f;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    float p[3], F[3][3], fw[3];
    load_point<kContact>(e, pts_c, P, r, p);
    frame(r, F);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      fw[c] = cs::FRAMES ? F[c][0] * lam[0][r] + F[c][1] * lam[1][r] +
                               F[c][2] * lam[2][r]
                         : lam[c][r];
      lam_out[static_cast<size_t>(c * P + r) * N + n] = lam[c][r];
    }
    add_impulse<kContact>(e, S, r, p, fw, imp);
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    qd_out[static_cast<size_t>(v) * N + n] = qd[v];
    imp_out[static_cast<size_t>(v) * N + n] = imp[v] + (lam_lo[v] - lam_hi[v]);
  }
}

}  // namespace

extern "C" int contact_solve_launch(
    int device, const float* S, const float* Hinv, const float* qd,
    const float* pts_c, const float* b_n, const float* mu, const float* active,
    const float* frames, const float* w_c, const float* b_lo,
    const float* b_hi, const float* act_lo, const float* act_hi,
    const float* pts_a, const float* b_a, const float* w_a, const float* pts_g,
    const float* b_g, const float* g_act, const float* w_g, float* qd_out,
    float* lam_out, float* imp_out, int N, void* stream) {
  if (N <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (N + kThreads - 1) / kThreads;
  contact_solve_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      S, Hinv, qd, pts_c, b_n, mu, active, frames, w_c, b_lo, b_hi, act_lo,
      act_hi, pts_a, b_a, w_a, pts_g, b_g, g_act, w_g, qd_out, lam_out,
      imp_out, N);
  return static_cast<int>(cudaGetLastError());
}
