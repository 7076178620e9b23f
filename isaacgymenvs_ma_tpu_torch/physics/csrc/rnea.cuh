// The RNEA bias-force pieces of the team kernels B2 (dyn_forward.cu, fresh
// I_O, gravity through a0 = -g) and B3 (dyn_cached.cu, cached I_O, gravity
// from the fresh per-body wrench f_grav), and the tree sums they use.
//
// A team of T lanes owns one env.  Per-body arrays live in shared memory
// component-major, element (k, b) of a (K, NB) array at k * NB + b, so the
// lanes of a team walking bodies touch consecutive addresses; S is (NV, 6)
// as in global memory.  Tree sums come in two forms:
//   * by levels: one pass per tree level, one __syncwarp after each (B2;
//     Franka's tree has 11 levels), summing in place;
//   * by lists: each lane sums one body's six components over its
//     ancestor list (root first, as the twins' path sums add), each
//     ancestor's own term over its dofs, into another array, or one dof's
//     over its body's subtree list, with no barrier.
// The tree tables come through a table reader: GlobalTables reads the
// scene's device arrays (B2), B3 reads its block's copy in shared memory.
// Compiled with the scene header force-included.
#pragma once

#include "dyn_common.cuh"

namespace rnea {

namespace sc = scene;
constexpr int NB = sc::NB, NV = sc::NV;
using dyn::tab;

// The tree tables of the level-by-level sums and the per-body dof ranges,
// read from the scene's device arrays; the per-body pieces take every body
// (nbody, body(i)).
struct GlobalTables {
  static constexpr int nbody = NB;
  __device__ int body(int i) const { return i; }
  __device__ int vadr(int b) const { return tab(sc::b2_vadr, b); }
  __device__ int ndof(int b) const { return tab(sc::b2_ndof, b); }
  __device__ int lvl_body(int i) const { return tab(sc::b2_lvl_body, i); }
  __device__ int parent(int b) const { return tab(sc::b2_parent, b); }
  __device__ int gat_body(int i) const { return tab(sc::b2_gat_body, i); }
  __device__ int child(int c) const { return tab(sc::b2_child, c); }
  __device__ int child_off(int b) const { return tab(sc::b2_child_off, b); }
};

// X(k, b) = sum over body b's dofs d of S(d, k) qd(d): its own joint motion.
// The per-body pieces take the bodies tb.body(i), i < Tab::nbody.
template <int T, typename Tab>
__device__ __forceinline__ void own_motion(const float* S, const float* QD,
                                           float* X, const Tab& tb,
                                           int lane) {
  constexpr int nb = Tab::nbody;
  for (int it = lane; it < 6 * nb; it += T) {
    const int k = it / nb, b = tb.body(it % nb);
    const int v0 = tb.vadr(b), nd = tb.ndof(b);
    float acc = 0.0f;
    for (int d = v0; d < v0 + nd; ++d) acc += S[d * 6 + k] * QD[d];
    X[k * NB + b] = acc;
  }
}

// X(., b) = sum over body b's dofs d of V_b x (S_d qd_d): the velocity-
// product accelerations, one lane per body.
template <int T, typename Tab>
__device__ __forceinline__ void velocity_products(const float* S,
                                                  const float* QD,
                                                  const float* V, float* X,
                                                  const Tab& tb, int lane) {
  for (int i = lane; i < Tab::nbody; i += T) {
    const int b = tb.body(i);
    const int v0 = tb.vadr(b), nd = tb.ndof(b);
    float Vb[6], acc[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      Vb[k] = V[k * NB + b];
      acc[k] = 0.0f;
    }
    for (int d = v0; d < v0 + nd; ++d) {
      float sqd[6], xi[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) sqd[k] = S[d * 6 + k] * QD[d];
      dyn::cross_motion(Vb, sqd, xi);
#pragma unroll
      for (int k = 0; k < 6; ++k) acc[k] += xi[k];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) X[k * NB + b] = acc[k];
  }
}

// F(., b) = I_b a_b + V_b x* (I_b V_b), one lane per body, I_O (36, NB).
// kFreshGravity: a_b = a0_b + A(., b) (B2); otherwise a_b = A(., b) and the
// fresh gravity wrench FG(., b) is added (B3).
template <int T, bool kFreshGravity, typename Tab>
__device__ __forceinline__ void body_forces(const float* IO, const float* V,
                                            const float* A, const float* FG,
                                            float* F, const Tab& tb,
                                            int lane) {
  for (int i = lane; i < Tab::nbody; i += T) {
    const int b = tb.body(i);
    float I[36], Vb[6], a[6], Iv[6], Ia[6], cf[6];
#pragma unroll
    for (int k = 0; k < 36; ++k) I[k] = IO[k * NB + b];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      Vb[k] = V[k * NB + b];
      a[k] = kFreshGravity ? tab(sc::b2_a0, b * 6 + k) + A[k * NB + b]
                           : A[k * NB + b];
    }
    dyn::matvec6(I, Vb, Iv);
    dyn::matvec6(I, a, Ia);
    dyn::cross_force(Vb, Iv, cf);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      float f = Ia[k] + cf[k];
      if (!kFreshGravity) f += FG[k * NB + b];
      F[k * NB + b] = f;
    }
  }
}

// Root-to-body path sums of a (6, NB) array in place, level by level.
template <int T, typename Tab>
__device__ __forceinline__ void path_sum_levels(float* X, const Tab& tb,
                                                int lane) {
#pragma unroll
  for (int L = 1; L < sc::NLEV; ++L) {
    const int lo = sc::lvl_off(L), cnt = sc::lvl_off(L + 1) - lo;
    for (int it = lane; it < 6 * cnt; it += T) {
      const int b = tb.lvl_body(lo + it % cnt), k = it / cnt;
      X[k * NB + b] += X[k * NB + tb.parent(b)];
    }
    __syncwarp();
  }
}

// Subtree sums of a (K, NB) array in place, leaves up: each body of level L
// that has children gathers them (level L + 1).
template <int T, int K, typename Tab>
__device__ __forceinline__ void subtree_sum_levels(float* X, const Tab& tb,
                                                   int lane) {
#pragma unroll
  for (int L = sc::NLEV - 2; L >= 0; --L) {
    const int lo = sc::gat_off(L), cnt = sc::gat_off(L + 1) - lo;
    for (int it = lane; it < K * cnt; it += T) {
      const int b = tb.gat_body(lo + it % cnt), k = it / cnt;
      const int c1 = tb.child_off(b + 1);
      float s = X[k * NB + b];
      for (int c = tb.child_off(b); c < c1; ++c)
        s += X[k * NB + tb.child(c)];
      X[k * NB + b] = s;
    }
    __syncwarp();
  }
}

// Y(., b) = sum over b's path a = root .. b (tb.anc: its active part,
// root first) of a's own term, sum over a's dofs d of X(d): each body's
// own term summed over its dofs first and added to the path so far, as the
// twins' own-then-path sums.  One lane per body, no barrier.
template <int T, typename Tab, typename X>
__device__ __forceinline__ void path_sum_lists(const X& x, float* Y,
                                               const Tab& tb, int lane) {
  for (int i = lane; i < Tab::nbody; i += T) {
    const int b = tb.body(i);
    const int p1 = tb.anc_off(b + 1);
    float s[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int p = tb.anc_off(b); p < p1; ++p) {
      const int a = tb.anc(p), v0 = tb.vadr(a), v1 = v0 + tb.ndof(a);
      float own[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int d = v0; d < v1; ++d) x(d, own);
#pragma unroll
      for (int k = 0; k < 6; ++k) s[k] = own[k] + s[k];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) Y[k * NB + b] = s[k];
  }
}

// XD(k, d) = (V_b x (S_d qd_d))_k, b the body of dof d: one lane per dof.
template <int T, typename Tab>
__device__ __forceinline__ void dof_velocity_products(const float* S,
                                                      const float* QD,
                                                      const float* V,
                                                      float* XD,
                                                      const Tab& tb,
                                                      int lane) {
  for (int d = lane; d < NV; d += T) {
    const int b = tb.dof_body(d);
    float Vb[6], sqd[6], xi[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      Vb[k] = V[k * NB + b];
      sqd[k] = S[d * 6 + k] * QD[d];
    }
    dyn::cross_motion(Vb, sqd, xi);
#pragma unroll
    for (int k = 0; k < 6; ++k) XD[k * NV + d] = xi[k];
  }
}

// The sum of F(., d) over body b's subtree d (b first), no barrier.
template <typename Tab>
__device__ __forceinline__ void subtree_sum_list(const float* F, int b,
                                                 const Tab& tb,
                                                 float (&out)[6]) {
  const int p1 = tb.desc_off(b + 1);
#pragma unroll
  for (int k = 0; k < 6; ++k) out[k] = 0.0f;
  for (int p = tb.desc_off(b); p < p1; ++p) {
    const int d = tb.desc(p);
#pragma unroll
    for (int k = 0; k < 6; ++k) out[k] += F[k * NB + d];
  }
}

}  // namespace rnea
