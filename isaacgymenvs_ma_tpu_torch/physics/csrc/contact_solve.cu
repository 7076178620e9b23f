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
// count, relaxation, the launch layout (B4_*) and the row masks.
//
// What bounds it on the H100: bytes, at one pass over its inputs and outputs
// (~11 MB at Ant-4096: H^-1 3.2 MB, S 1.4 MB, the row arrays; 3.3 us at
// 3.35 TB/s); the function's arithmetic (~1.3e2 MFLOP at Ant-4096) takes
// less at 67 TFLOP/s.  What held the one-thread kernel at 81-148x that
// bound was latency: each thread re-read S, H^-1, the points, frames and
// row constants every iteration (~1.5k floats per env per iteration at
// BallBalance), rebuilt J from them, spilled 2-10 KB of iteration state,
// and ran as 128 one-warp blocks at 4096 envs, one warp per SM.  A team
// kernel that keeps all of that in shared memory is bound instead by the
// shared-memory load issue rate (~300 scalar loads per lane per iteration,
// one warp-wide load per cycle per SM).  Design:
//   * A team of B4_TEAM lanes (8-32, from the plan: half the widest of the
//     row groups and the dofs) owns one env; B4_ENVS envs share a block of
//     128 threads.  The block stages its envs' inputs into shared memory
//     once with cp.async, consecutive threads on consecutive envs
//     (coalesced), and writes the outputs back the same way.
//   * Each row's Jacobian (masked, and projected into the row's frame for
//     contact rows) is built once per solve into shared memory, one (row,
//     dof) entry per lane.
//   * Lane ownership is fixed for the whole solve: row r of each group on
//     lane r % TEAM, dof d on lane d % TEAM (so a lane may own two of each:
//     half-width teams leave registers for more envs per SM, which is what
//     sets the time here).  A lane keeps in registers what
//     only it reads: its dofs' J columns (every group) and H^-1 rows, its
//     dofs' limit constants and impulses, its rows' targets, Delassus
//     diagonals and (contact rows) impulses.  Shared memory carries only
//     what the team exchanges: qd, J's rows, one group's impulse deltas and
//     the dof impulse x, read as float4 (J's row stride B4_JS is a multiple
//     of four floats and an odd number of float4s, so the lanes' row reads
//     hit distinct banks).  A plan too wide for that (B4_JREG false:
//     FrankaReachMA's 41 contact rows over 30 dofs, 123 column entries a
//     lane) reads its dofs' contact-row columns from J in shared memory
//     instead, in the same order of sums.
//   * Within a group every row reads the same qd (Jacobi), so the rows'
//     velocities J_r qd and impulse deltas run one row per lane; then each
//     dof's lane sums x_d = sum over the group's rows of J_rd dlam_r from
//     its registers, and qd_d += sum_j H^-1_dj x_j over the dofs the group
//     touches (used_*, a compile-time table in an unrolled loop).  Joint
//     limits take one dof per lane.  __syncwarp orders the phases (a team
//     never spans two warps).
// Group order, relaxation, the friction box against the new normal and the
// exact zeros of inactive rows are those of solve_bl; only the order of
// float sums differs.
#include "team.cuh"

namespace {

namespace cs = cscene;
constexpr int NV = cs::NV, P = cs::P, A = cs::A, G = cs::G;
constexpr int T = cs::B4_TEAM, E = cs::B4_ENVS, W = cs::B4_FLOATS;
constexpr int JS = cs::B4_JS;        // row stride of J
constexpr int kBlock = T * E;
constexpr int RD = (NV + T - 1) / T;  // dofs per lane
// the lane keeps its dofs' contact-row J columns in registers, or (wide
// plans) reads them from J in shared memory
constexpr bool JREG = cs::B4_JREG;
constexpr int JCOLS = JREG ? 3 * P : 1;
static_assert(32 % T == 0, "a team never spans two warps");
static_assert(W % 4 == 0 && JS % 4 == 0 && cs::B4_QD % 4 == 0 &&
                  cs::B4_JC % 4 == 0 && cs::B4_JA % 4 == 0 &&
                  cs::B4_JG % 4 == 0 && cs::B4_LAM % 4 == 0 &&
                  cs::B4_DL % 4 == 0 && cs::B4_X % 4 == 0,
              "float4 reads need 16-byte aligned arrays and rows");
constexpr int kContact = 0, kAttractor = 1, kGrab = 2;

__host__ __device__ constexpr int rounds(int rows) { return (rows + T - 1) / T; }
__host__ __device__ constexpr int at_least_1(int n) { return n > 0 ? n : 1; }

template <int GROUP>
__device__ __forceinline__ bool used(int v) {
  if constexpr (GROUP == kContact) return cs::used_c(v);
  else if constexpr (GROUP == kAttractor) return cs::used_a(v);
  else return cs::used_g(v);
}

// sum over d < n of a[d] x[d] in four partial sums (one per float4 lane),
// a and x 16-byte aligned in shared memory and readable up to the next
// multiple of four
template <int n>
__device__ __forceinline__ float dot_row(const float* a, const float* x) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < (n + 3) / 4; ++q) {
    const float4 u = a4[q], w = x4[q];
    acc[0] += u.x * w.x;
    if (4 * q + 1 < n) acc[1] += u.y * w.y;
    if (4 * q + 2 < n) acc[2] += u.z * w.z;
    if (4 * q + 3 < n) acc[3] += u.w * w.w;
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// sum over rc < RC of col[rc] L[rc] in four partial sums; L as dot_row's x
template <int RC>
__device__ __forceinline__ float col_dot(const float (&col)[RC],
                                         const float* L) {
  const float4* l4 = reinterpret_cast<const float4*>(L);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < (RC + 3) / 4; ++q) {
    const float4 l = l4[q];
    const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * q + c < RC) acc[c] += col[4 * q + c] * lv[c];
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// the same sum with col[rc] = Jd[rc * JS], a column of J in shared memory
template <int RC>
__device__ __forceinline__ float col_dot_smem(const float* Jd,
                                              const float* L) {
  const float4* l4 = reinterpret_cast<const float4*>(L);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < (RC + 3) / 4; ++q) {
    const float4 l = l4[q];
    const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * q + c < RC) acc[c] += Jd[(4 * q + c) * JS] * lv[c];
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// sum over rc < RC of J(rc, d) L[rc]: from the lane's registers (CC == RC)
// or from column d of J in shared memory (CC == 1)
template <int RC, int CC>
__device__ __forceinline__ float cols_dot(const float (&col)[CC],
                                          const float* J, int d,
                                          const float* L) {
  if constexpr (CC == RC) return col_dot<RC>(col, L);
  else return col_dot_smem<RC>(J + d, L);
}

// J of a group's ROWS rows into shared memory, one (row, dof) entry per
// lane: J(c * ROWS + r, v) = (S_lin_v + S_ang_v x p_r)_c * mask(r, v),
// projected into the row's frame (l = sum_c J_c F_cl) where FR is given.
template <int ROWS>
__device__ __forceinline__ void build_rows(const float* env, float* J,
                                           const float* pts,
                                           const float* __restrict__ mask,
                                           const float* FR, int lane) {
  const float* S = env + cs::B4_S;
  for (int it = lane; it < ROWS * NV; it += T) {
    const int r = it / NV, v = it % NV;
    const float m = __ldg(mask + it);
    const float* s = S + v * 6;
    const float p[3] = {pts[r], pts[ROWS + r], pts[2 * ROWS + r]};
    const float cr[3] = {s[1] * p[2] - s[2] * p[1], s[2] * p[0] - s[0] * p[2],
                         s[0] * p[1] - s[1] * p[0]};
    float jw[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) jw[c] = (s[3 + c] + cr[c]) * m;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      float j = jw[l];
      if (FR != nullptr)
        j = jw[0] * FR[l * ROWS + r] + jw[1] * FR[(3 + l) * ROWS + r] +
            jw[2] * FR[(6 + l) * ROWS + r];
      J[(l * ROWS + r) * JS + v] = j;
    }
  }
}

// the lane's dofs' J columns of a group of RC row components
template <int RC>
__device__ __forceinline__ void load_columns(const float* J, int lane,
                                             float (&col)[RD][RC]) {
#pragma unroll
  for (int k = 0; k < RD; ++k) {
    const int d = min(lane + k * T, NV - 1);   // lanes past NV: unused copy
#pragma unroll
    for (int rc = 0; rc < RC; ++rc) col[k][rc] = J[rc * JS + d];
  }
}

// qd_i += sum_j H^-1_ij x_j for the lane's dofs i, over the dofs the group
// touches (GROUP < 0: all), x from shared memory
template <int GROUP>
__device__ __forceinline__ void apply_hinv(float* env,
                                           const float (&hi)[RD][NV],
                                           int lane) {
  const float4* x4 = reinterpret_cast<const float4*>(env + cs::B4_X);
  float* QD = env + cs::B4_QD;
  float acc[RD][4];
#pragma unroll
  for (int k = 0; k < RD; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.0f;
#pragma unroll
  for (int q = 0; q < (NV + 3) / 4; ++q) {
    const float4 x = x4[q];
    const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * q + c;
      if (j < NV && (GROUP < 0 || used<GROUP>(j))) {
#pragma unroll
        for (int k = 0; k < RD; ++k) acc[k][c] += hi[k][j] * xv[c];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RD; ++k) {
    const int i = lane + k * T;
    if (i < NV) QD[i] += (acc[k][0] + acc[k][1]) + (acc[k][2] + acc[k][3]);
  }
  __syncwarp();
}

// x = J^T DL from the lane's columns (or J's, see cols_dot), then
// qd += H^-1 x
template <int GROUP, int RC, int CC>
__device__ __forceinline__ void apply(float* env, const float (&col)[RD][CC],
                                      const float* J,
                                      const float (&hi)[RD][NV], int lane) {
  const float* DL = env + cs::B4_DL;
  float* X = env + cs::B4_X;
#pragma unroll
  for (int k = 0; k < RD; ++k) {
    const int d = lane + k * T;
    if (d < NV) X[d] = cols_dot<RC, CC>(col[k], J, d, DL);
  }
  __syncwarp();
  apply_hinv<GROUP>(env, hi, lane);
}

// The lane's share of one bilateral group (attractors, or grabs gated by
// g_act): its rows' targets, Delassus diagonals and gates, and the group's
// J columns of its dofs.
template <int GROUP, int ROWS>
struct Bilateral {
  static constexpr int RR = rounds(ROWS);
  float b[RR][3], w[RR][3], gate[RR];
  float col[RD][3 * ROWS];

  __device__ __forceinline__ void load(const float* env, const float* J,
                                       int off_b, int off_w, int off_gate,
                                       int lane) {
#pragma unroll
    for (int k = 0; k < RR; ++k) {
      const int r = min(lane + k * T, ROWS - 1);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        b[k][c] = env[off_b + c * ROWS + r];
        w[k][c] = env[off_w + c * ROWS + r];
      }
      gate[k] = GROUP == kGrab ? env[off_gate + r] : 1.0f;
    }
    load_columns<3 * ROWS>(J, lane, col);
  }

  __device__ __forceinline__ void solve(float* env, const float* J,
                                        const float (&hi)[RD][NV],
                                        int lane) const {
    const float* QD = env + cs::B4_QD;
    float* DL = env + cs::B4_DL;
#pragma unroll
    for (int k = 0; k < RR; ++k) {
      const int r = lane + k * T;
      if (r < ROWS) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = dot_row<NV>(J + (c * ROWS + r) * JS, QD);
          float dl = cs::RELAX * (b[k][c] - v) / w[k][c];
          if (GROUP == kGrab) dl *= gate[k];
          DL[c * ROWS + r] = dl;
        }
      }
    }
    __syncwarp();
    apply<GROUP, 3 * ROWS>(env, col, J, hi, lane);
  }
};

__global__ void __launch_bounds__(kBlock, 1)
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
  extern __shared__ float smem[];
  const int n0 = blockIdx.x * E;
  const int lane = threadIdx.x % T;
  float* env = smem + (threadIdx.x / T) * W;
  float* QD = env + cs::B4_QD;
  float* LAM = env + cs::B4_LAM;   // contact impulses (3, P), at the end
  float* DL = env + cs::B4_DL;     // one group's impulse deltas
  float* X = env + cs::B4_X;
  float* JC = env + cs::B4_JC;

  // ---- stage the block's inputs
  auto st = [&](int off, const float* g, int M) {
    team::stage<E, W, kBlock>(smem, off, g, M, n0, N);
  };
  st(cs::B4_S, S, 6 * NV);
  st(cs::B4_HI, Hinv, NV * NV);
  st(cs::B4_QD, qd_in, NV);
  st(cs::B4_PC, pts_c, 3 * P);
  st(cs::B4_BN, b_n, P);
  st(cs::B4_MU, mu, P);
  st(cs::B4_ACT, active, P);
  if constexpr (cs::FRAMES) st(cs::B4_FR, frames, 9 * P);
  st(cs::B4_WC, w_c, 3 * P);
  st(cs::B4_BLO, b_lo, NV);
  st(cs::B4_BHI, b_hi, NV);
  st(cs::B4_ALO, act_lo, NV);
  st(cs::B4_AHI, act_hi, NV);
  if constexpr (A > 0) {
    st(cs::B4_PA, pts_a, 3 * A);
    st(cs::B4_BA, b_a, 3 * A);
    st(cs::B4_WA, w_a, 3 * A);
  }
  if constexpr (G > 0) {
    st(cs::B4_PG, pts_g, 3 * G);
    st(cs::B4_BG, b_g, 3 * G);
    st(cs::B4_WG, w_g, 3 * G);
    st(cs::B4_GACT, g_act, G);
  }
  team::stage_wait();
  __syncthreads();

  // ---- row Jacobians, once per solve
  build_rows<P>(env, JC, env + cs::B4_PC, cs::dmask_c,
                cs::FRAMES ? env + cs::B4_FR : nullptr, lane);
  if constexpr (A > 0)
    build_rows<A>(env, env + cs::B4_JA, env + cs::B4_PA, cs::dmask_a,
                  nullptr, lane);
  if constexpr (G > 0)
    build_rows<G>(env, env + cs::B4_JG, env + cs::B4_PG, cs::dmask_g,
                  nullptr, lane);
  __syncwarp();

  // ---- the lane's registers: its dofs' columns, H^-1 rows and limits,
  // its rows' constants and impulses
  float jc[RD][JCOLS], hi[RD][NV];
  float blo[RD], bhi[RD], alo[RD], ahi[RD], hd[RD], llo[RD], lhi[RD];
  if constexpr (JREG) load_columns<JCOLS>(JC, lane, jc);
#pragma unroll
  for (int k = 0; k < RD; ++k) {
    const int d = min(lane + k * T, NV - 1);
#pragma unroll
    for (int j = 0; j < NV; ++j) hi[k][j] = env[cs::B4_HI + d * NV + j];
    hd[k] = fmaxf(env[cs::B4_HI + d * NV + d], 1e-8f);
    blo[k] = env[cs::B4_BLO + d];
    bhi[k] = env[cs::B4_BHI + d];
    alo[k] = env[cs::B4_ALO + d];
    ahi[k] = env[cs::B4_AHI + d];
    llo[k] = lhi[k] = 0.0f;
  }
  constexpr int RC = rounds(P);
  float lam[RC][3], bn[RC], mu_r[RC], act[RC], wc[RC][3];
#pragma unroll
  for (int k = 0; k < RC; ++k) {
    const int r = min(lane + k * T, P - 1);
    bn[k] = env[cs::B4_BN + r];
    mu_r[k] = env[cs::B4_MU + r];
    act[k] = env[cs::B4_ACT + r];
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      wc[k][l] = env[cs::B4_WC + l * P + r];
      lam[k][l] = 0.0f;
    }
  }
  Bilateral<kAttractor, at_least_1(A)> ba;
  Bilateral<kGrab, at_least_1(G)> bg;
  if constexpr (A > 0)
    ba.load(env, env + cs::B4_JA, cs::B4_BA, cs::B4_WA, 0, lane);
  if constexpr (G > 0)
    bg.load(env, env + cs::B4_JG, cs::B4_BG, cs::B4_WG, cs::B4_GACT, lane);

#pragma unroll 1
  for (int it = 0; it < cs::NITER; ++it) {
    if constexpr (G > 0) bg.solve(env, env + cs::B4_JG, hi, lane);
    if constexpr (A > 0) ba.solve(env, env + cs::B4_JA, hi, lane);
    // ---- contact rows: every row reads the same qd (Jacobi)
#pragma unroll
    for (int k = 0; k < RC; ++k) {
      const int r = lane + k * T;
      if (r < P) {
        float v[3];
#pragma unroll
        for (int l = 0; l < 3; ++l)
          v[l] = dot_row<NV>(JC + (l * P + r) * JS, QD);
        const float ln =
            fmaxf(lam[k][2] + cs::RELAX * (bn[k] - v[2]) / wc[k][2], 0.0f) *
            act[k];
        const float mf = mu_r[k] * ln;
        const float lt1 = fminf(
            fmaxf(lam[k][0] + cs::RELAX * (-v[0]) / wc[k][0], -mf), mf);
        const float lt2 = fminf(
            fmaxf(lam[k][1] + cs::RELAX * (-v[1]) / wc[k][1], -mf), mf);
        const float lnew[3] = {lt1 * act[k], lt2 * act[k], ln * act[k]};
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          DL[l * P + r] = lnew[l] - lam[k][l];
          lam[k][l] = lnew[l];
        }
      }
    }
    __syncwarp();
    apply<kContact, 3 * P>(env, jc, JC, hi, lane);
    // ---- joint limits (J = e_v)
#pragma unroll
    for (int k = 0; k < RD; ++k) {
      const int v = lane + k * T;
      if (v < NV) {
        const float q = QD[v];
        const float lo =
            alo[k] * fmaxf(llo[k] + cs::RELAX * (blo[k] - q) / hd[k], 0.0f);
        const float hi_v =
            ahi[k] * fmaxf(lhi[k] + cs::RELAX * (bhi[k] + q) / hd[k], 0.0f);
        X[v] = (lo - llo[k]) - (hi_v - lhi[k]);
        llo[k] = lo;
        lhi[k] = hi_v;
      }
    }
    __syncwarp();
    apply_hinv<-1>(env, hi, lane);
  }

  // ---- imp_dof = J^T lam + limit impulses; outputs
#pragma unroll
  for (int k = 0; k < RC; ++k) {
    const int r = lane + k * T;
    if (r < P) {
#pragma unroll
      for (int l = 0; l < 3; ++l) LAM[l * P + r] = lam[k][l];
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < RD; ++k) {
    const int d = lane + k * T;
    if (d < NV)
      X[d] = cols_dot<3 * P, JCOLS>(jc[k], JC, d, LAM) + (llo[k] - lhi[k]);
  }
  __syncthreads();
  team::store<E, W, kBlock>(qd_out, NV, n0, N, smem, cs::B4_QD);
  team::store<E, W, kBlock>(lam_out, 3 * P, n0, N, smem, cs::B4_LAM);
  team::store<E, W, kBlock>(imp_out, NV, n0, N, smem, cs::B4_X);
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int bytes = cs::B4_SMEM_BYTES;
  err = team::allow_smem(contact_solve_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + E - 1) / E;
  contact_solve_kernel<<<blocks, kBlock, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      S, Hinv, qd, pts_c, b_n, mu, active, frames, w_c, b_lo, b_hi, act_lo,
      act_hi, pts_a, b_a, w_a, pts_g, b_g, g_act, w_g, qd_out, lam_out,
      imp_out, N);
  return static_cast<int>(cudaGetLastError());
}
