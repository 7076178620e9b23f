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
// Hinv (NV,NV,N), f_grav (NB,6,N).  Out: qdd (NV,N).  H^-1 must be zero off
// H's diagonal blocks (DynPlan.blocks), as B2 and the twins' sweep leave it:
// only the block entries are read.
//
// What bounds it on the H100: bytes.  Per env it must read I_O (36 NB
// floats), S, qd, rhs, f_grav and H^-1's block entries (Franka: 234 of 900)
// and write qdd: 7.9 KB at Franka, 19 us at 3.35 TB/s for 8192 envs; ~4k
// FLOP per env takes far less.  The one-thread kernel held the RNEA vectors
// of all bodies in one thread (255 registers and 76 B of spill at Ant, 7.6 KB
// of spill at Franka) in one-warp blocks.  Design, after B2:
//   * A team of B3_TEAM lanes (a lane per body or dof, some taking two:
//     16-32) owns one env; B3_ENVS envs share a block of 256 threads.  The
//     block stages its envs' inputs into shared memory with cp.async,
//     consecutive threads on consecutive envs (coalesced): I_O and f_grav
//     component-major (element (k, b) at k * NB + b, so the lanes walking
//     bodies read consecutive words), and of H^-1 only the rows of its
//     block entries (scene::b3_hb_row).  qdd goes back the same way.  The
//     block first copies the scene tables it reads (the dof ranges, the
//     tree lists, H's blocks: scene::b3_itab) into shared memory, so that
//     no lane waits on a chain of dependent device-memory reads of its
//     body's entries.  The copies go in two batches: the tables, S and qd,
//     which the velocity and acceleration sums need, then I_O, f_grav, rhs
//     and H^-1, which stay in flight while those sums run.
//   * The RNEA pieces are B2's (rnea.cuh), over the bodies whose motion or
//     force reaches a dof (32 of FrankaReachMA's 35: its table and the two
//     fixed arm bases move nothing and feed no C_v), one lane each.  Path
//     sums (velocities, accelerations) and the subtree sums of the body
//     forces go over each body's ancestor and subtree lists, one lane per
//     body (velocities, accelerations, forces) or per dof (the velocity
//     products, C), with no barrier between tree levels (four __syncwarp
//     in all) and no lane summing a floating base's six dofs alone.
//   * qdd_v = sum over v's block of H^-1_vj (rhs - C)_j, j in dof order:
//     the dense sum's terms off the block are exact zeros.
// Only the order of float sums differs from the twin.
#include "dyn_common.cuh"
#include "rnea.cuh"
#include "team.cuh"

namespace {

namespace sc = scene;
constexpr int NB = sc::NB, NV = sc::NV;
constexpr int T = sc::B3_TEAM, E = sc::B3_ENVS, W = sc::B3_FLOATS;
constexpr int kBlock = T * E;
constexpr int NHB = sc::B3_QDD - sc::B3_HB;   // H^-1 block entries per env
static_assert(32 % T == 0, "a team never spans two warps");
static_assert(NHB >= NV, "the block entries include the diagonal");

using dyn::tab;

// The block's copy of the scene tables (scene::b3_itab) in shared memory.
// The per-body pieces take the active bodies only (scene::B3_NACT: those
// with a dof on their root path; the others' motion and forces reach no
// dof).
struct SharedTables {
  static constexpr int nbody = sc::B3_NACT;
  const int* t;
  __device__ int body(int i) const { return t[sc::B3T_ACT + i]; }
  __device__ int vadr(int b) const { return t[sc::B3T_VADR + b]; }
  __device__ int ndof(int b) const { return t[sc::B3T_NDOF + b]; }
  __device__ int anc(int p) const { return t[sc::B3T_ANC + p]; }
  __device__ int anc_off(int b) const { return t[sc::B3T_ANC_OFF + b]; }
  __device__ int desc(int p) const { return t[sc::B3T_DESC + p]; }
  __device__ int desc_off(int b) const { return t[sc::B3T_DESC_OFF + b]; }
  __device__ int dof_body(int v) const { return t[sc::B3T_DOF_BODY + v]; }
  __device__ int dof_block(int v) const { return t[sc::B3T_DOF_BLOCK + v]; }
  __device__ int block_dofs(int i) const { return t[sc::B3T_BLOCK_DOFS + i]; }
  __device__ int dof_hb(int v) const { return t[sc::B3T_DOF_HB + v]; }
};

__global__ void __launch_bounds__(kBlock, 1024 / kBlock)
dyn_cached_kernel(const float* __restrict__ Sg, const float* __restrict__ qdg,
                  const float* __restrict__ rhs, const float* __restrict__ io,
                  const float* __restrict__ hinv,
                  const float* __restrict__ fgrav,
                  float* __restrict__ qdd_out, int N) {
  extern __shared__ float smem[];
  const SharedTables tb{reinterpret_cast<const int*>(smem)};
  float* envs = smem + sc::B3_SHARED;
  const int n0 = blockIdx.x * E;
  const int lane = threadIdx.x % T;
  float* env = envs + (threadIdx.x / T) * W;
  float* IO = env + sc::B3_IO;     // (36, NB) cached I_O
  float* FG = env + sc::B3_FG;     // (6, NB) fresh gravity wrench, then F
  float* V = env + sc::B3_V;       // (6, NB) body velocities
  float* A = env + sc::B3_A;       // (6, NB) velocity-product accelerations
  float* XD = env + sc::B3_XD;     // (6, NV) the dofs' velocity products
  float* S = env + sc::B3_S;       // (NV, 6) as in global memory
  float* QD = env + sc::B3_QD;
  float* RHS = env + sc::B3_RHS;   // rhs, then rhs - C
  float* HB = env + sc::B3_HB;     // H^-1's block entries, block-row-major
  float* QDD = env + sc::B3_QDD;

  // ---- stage the scene tables, S and qd, then the rest in a second batch
  team::stage_table<kBlock>(smem, sc::b3_itab, sc::B3T_NI);
  const auto same = [](int i) { return i; };
  team::stage<E, W, kBlock>(envs, sc::B3_S, Sg, 6 * NV, n0, N);
  team::stage<E, W, kBlock>(envs, sc::B3_QD, qdg, NV, n0, N);
  team::stage_commit();
  team::stage<E, W, kBlock>(envs, sc::B3_IO, io, 36 * NB, n0, N, same,
                            [](int i) { return (i % 36) * NB + i / 36; });
  team::stage<E, W, kBlock>(envs, sc::B3_FG, fgrav, 6 * NB, n0, N, same,
                            [](int i) { return (i % 6) * NB + i / 6; });
  team::stage<E, W, kBlock>(envs, sc::B3_RHS, rhs, NV, n0, N);
  team::stage<E, W, kBlock>(envs, sc::B3_HB, hinv, NHB, n0, N,
                            [](int i) { return tab(sc::b3_hb_row, i); },
                            same);
  team::stage_commit();
  team::stage_wait_prior<1>();
  __syncthreads();

  // ---- body velocities, the dofs' velocity products and the body
  // accelerations from them, while I_O and the rest arrive
  rnea::path_sum_lists<T>(
      [&](int d, float (&own)[6]) {
#pragma unroll
        for (int k = 0; k < 6; ++k) own[k] += S[d * 6 + k] * QD[d];
      },
      V, tb, lane);
  __syncwarp();
  rnea::dof_velocity_products<T>(S, QD, V, XD, tb, lane);
  __syncwarp();
  rnea::path_sum_lists<T>(
      [&](int d, float (&own)[6]) {
#pragma unroll
        for (int k = 0; k < 6; ++k) own[k] += XD[k * NV + d];
      },
      A, tb, lane);
  team::stage_wait_prior<0>();
  __syncthreads();

  // ---- RNEA bias force against the cached I_O, gravity from f_grav; each
  // body's force F = I a + V x* (I V) + f_grav overwrites its f_grav
  float* F = FG;
  rnea::body_forces<T, false>(IO, V, A, FG, F, tb, lane);
  __syncwarp();
  // C_v = S_v . (subtree sum of F at v's body); rhs - C
  for (int v = lane; v < NV; v += T) {
    float f[6];
    rnea::subtree_sum_list(F, tb.dof_body(v), tb, f);
    float c = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) c += S[v * 6 + k] * f[k];
    RHS[v] = RHS[v] - c;
  }
  __syncwarp();

  // ---- qdd = H^-1 (rhs - C) over each dof's block
  for (int v = lane; v < NV; v += T) {
    const int db = tb.dof_block(v);
    const int base = db & 255, size = (db >> 8) & 255;
    const float* h = HB + tb.dof_hb(v);
    float acc = 0.0f;
    for (int c = 0; c < size; ++c)
      acc += h[c] * RHS[tb.block_dofs(base + c)];
    QDD[v] = acc;
  }
  __syncthreads();
  team::store<E, W, kBlock>(qdd_out, NV, n0, N, envs, sc::B3_QDD);
}

}  // namespace

extern "C" int dyn_cached_launch(int device, const float* S, const float* qd,
                                 const float* rhs, const float* io,
                                 const float* hinv, const float* fgrav,
                                 float* qdd, int N, void* stream) {
  if (N <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int bytes = sc::B3_SMEM_BYTES;
  err = team::allow_smem(dyn_cached_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (N + E - 1) / E;
  dyn_cached_kernel<<<blocks, kBlock, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      S, qd, rhs, io, hinv, fgrav, qdd, N);
  return static_cast<int>(cudaGetLastError());
}
