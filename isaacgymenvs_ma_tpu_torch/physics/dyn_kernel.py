"""Batch-last dynamics chain: plain PyTorch twins and CUDA kernels B1-B3.

Port of isaacgymenvs_ma_tpu/physics/dyn_kernel.py.  Every array at the
kernel boundary is laid out ``(..., N)`` with the env batch minor, so
neighbouring threads read neighbouring addresses.  All three kernels run a
team of lanes per env (one lane per body or dof) over the env's working set
staged in shared memory; :meth:`DynPlan.layout` sizes each kernel's team,
envs per block and shared memory.  The static kinematic tree is baked into
the kernels: the JAX code unrolls it in Python while tracing, the CUDA
sources read it from a per-scene header of sizes, level offsets and device
tables (tree levels, children, ancestor and subtree lists, H's diagonal
blocks, the joint constants), all generated here from :class:`DynPlan`
(:func:`scene_header`).

Three kernels, each with a plain twin in this module and a dispatching
wrapper that runs the twin for CPU tensors and launches the kernel for CUDA
tensors (there is no fallback from one to the other):

==========  ==============================  ==============================
wrapper     CUDA source (csrc/)             replaces (TPU Pallas kernel)
==========  ==============================  ==============================
fk_motion   fk_motion.cu                    dyn_kernel.py:657 fk_motion_pallas
dyn_forward dyn_forward.cu                  dyn_kernel.py:404 dyn_forward_pallas
dyn_cached  dyn_cached.cu                   dyn_kernel.py:475 dyn_cached_pallas
==========  ==============================  ==============================

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..models import model as md

from . import _build


# ---------------------------------------------------------------------------
# static tree plan


class DynPlan:
    """Static (numpy, build-time) model constants for the batch-last chain.

    Built once per PhysicsEngine; holds everything the kernels bake in, so
    the only runtime inputs are the per-env arrays."""

    kernel_names = ("fk_motion", "dyn_forward", "dyn_cached")

    def __init__(self, engine):
        m = engine.model
        self.nb = int(m.nb)
        self.nv = int(m.nv)
        self.nq = int(m.nq)
        self.parent = np.asarray(m.parent, np.int64)
        # children-before-parents order for subtree (bottom-up) sums, derived
        # from depth exactly as the JAX plan does (same float summation order)
        self.bottom_up = sorted(range(self.nb), key=lambda b: -self._depth(b))
        self.mass = np.asarray(m.mass, np.float32)                 # (nb,)
        self.com = np.asarray(m.com, np.float32)                   # (nb, 3)
        self.inertia = np.asarray(m.inertia, np.float32)           # (nb, 3, 3)
        self.gravity = np.asarray(engine.params.gravity, np.float32)
        self.grav_mask = np.asarray(engine.grav_mask_np, np.float32)
        self.dof_body = np.asarray(m.dof_body, np.int64)           # (nv,)
        self.body_dofs = [
            [int(v) for v in range(self.nv) if self.dof_body[v] == b]
            for b in range(self.nb)
        ]
        # CRBA pair mask (strict-ancestor + same-body upper triangle)
        self.dof_anc = np.asarray(engine.dof_anc_np, bool)
        # H's diagonal blocks: the connected components of dof_anc, i.e. the
        # dofs under each root body, each in dof order
        self.blocks = dof_blocks(self.dof_anc)
        depth = [self._depth(b) for b in range(self.nb)]
        self.levels = [[b for b in range(self.nb) if depth[b] == d]
                       for d in range(max(depth) + 1)]
        self.children = [[c for c in range(self.nb) if self.parent[c] == b]
                         for b in range(self.nb)]
        self.fk = [self._fk_body(engine, b) for b in range(self.nb)]
        self._consts = {}
        self.libs = {}          # kernel name -> loaded ctypes library
        self.build_log = {}     # kernel name -> nvcc/ptxas report

    def header(self) -> str:
        return scene_header(self)

    def layout(self, name: str = "dyn_forward") -> "KernelLayout":
        """Launch layout (team, envs per block, shared memory) of the team
        kernel ``name``: B1 ``fk_motion``, B2 ``dyn_forward`` or B3
        ``dyn_cached``."""
        return _LAYOUTS[name](self)

    def _depth(self, b):
        d = 0
        while self.parent[b] != -1:
            b = int(self.parent[b])
            d += 1
        return d

    @staticmethod
    def _fk_body(engine, b):
        """Per-body FK constants, computed in float32 numpy exactly as
        ``_fk_motion_bl`` of the JAX package does."""
        m = engine.model
        bp = np.asarray(m.body_pos[b], np.float32)
        bq = np.asarray(m.body_quat[b], np.float32)
        axis = np.asarray(m.jnt_axis[b], np.float32)
        nrm = np.linalg.norm(axis)
        axis_n = axis / nrm if nrm > 0 else axis
        anchor = np.asarray(m.jnt_pos[b], np.float32)
        return dict(
            type=int(m.jnt_type[b]), qa=int(m.q_adr[b]), va=int(m.v_adr[b]),
            parent=int(m.parent[b]), bp=bp, bq=bq, axis=axis_n, anchor=anchor,
            tl0=(bp + _np_qapply(bq, anchor)).astype(np.float32),
            awb=_np_qapply(bq, axis_n).astype(np.float32),
            pitch=float(engine.jnt_pitch_np[b]) / (2.0 * np.pi))

    def consts(self, device):
        """Model-constant tensors of the twins, cached per device."""
        key = str(device)
        if key not in self._consts:
            a0 = np.concatenate(
                [np.zeros(3, np.float32), -self.gravity]).astype(np.float32)
            c = {
                "inertia": self.inertia,                              # (nb,3,3)
                "mass": self.mass[:, None],                           # (nb, 1)
                "com": self.com,                                      # (nb, 3)
                "a0": a0[None, :] * self.grav_mask[:, None],          # (nb, 6)
                "anc": self.dof_anc.astype(np.float32),               # (nv,nv)
                "anc_t": self.dof_anc.T.astype(np.float32),
            }
            self._consts[key] = {
                k: torch.as_tensor(np.ascontiguousarray(v, np.float32),
                                   device=device)
                for k, v in c.items()}
        return self._consts[key]


def get_plan(engine) -> DynPlan:
    """Per-engine kernel plan, stored on the engine."""
    plan = getattr(engine, "_dyn_plan", None)
    if plan is None:
        plan = DynPlan(engine)
        engine._dyn_plan = plan
    return plan


def dof_blocks(dof_anc) -> list:
    """Connected components of the dof pairs that ``dof_anc`` couples (H is
    zero between two components), each as its sorted dof list, ordered by
    first dof."""
    nv = len(dof_anc)
    label = list(range(nv))

    def root(i):
        while label[i] != i:
            i = label[i]
        return i

    for i, j in zip(*np.nonzero(np.asarray(dof_anc, bool))):
        label[root(int(i))] = root(int(j))
    groups = {}
    for v in range(nv):
        groups.setdefault(root(v), []).append(v)
    return sorted(groups.values(), key=lambda g: g[0])


# ---------------------------------------------------------------------------
# launch layout of the team kernels (B2, B4)

MAX_SMEM_BYTES = 232448     # shared memory one block may use on an H100


class KernelLayout:
    """How a team kernel lays out one launch: ``team`` lanes per env (a
    power of two up to a warp, so a team never spans two warps),
    ``envs`` envs per block, ``floats`` per env in shared memory (odd, or
    with ``quad`` a multiple of four that is an odd number of float4s: in
    either case consecutive envs start in different banks; with ``pad``
    False exactly as given, envs end to end as in device memory),
    ``offsets`` of the env's arrays (in floats), ``shared`` floats ahead of
    the envs' that the whole block shares (the kernel's scene tables, a
    multiple of four) and the block's ``smem_bytes``."""

    def __init__(self, work: int, offsets: dict, floats: int,
                 quad: bool = False, threads: int = 256, shared: int = 0,
                 pad: bool = True):
        self.team = min(32, max(8, 1 << max(0, int(work) - 1).bit_length()))
        self.offsets = dict(offsets)
        self.floats = (int(floats) if not pad else
                       quad_odd(floats) if quad else int(floats) | 1)
        self.shared = -(-int(shared) // 4) * 4
        env_bytes = 4 * self.floats
        room = MAX_SMEM_BYTES - 4 * self.shared
        envs = max(1, threads // self.team)
        while envs > 1 and envs * env_bytes > room:
            envs //= 2
        if envs * env_bytes > room:
            raise ValueError(f"one env needs {env_bytes} B of shared memory; "
                             f"a block has {MAX_SMEM_BYTES}")
        self.envs = envs
        self.smem_bytes = 4 * self.shared + envs * env_bytes

    def header_lines(self, prefix: str) -> list:
        return [f"constexpr int {prefix}_TEAM = {self.team};",
                f"constexpr int {prefix}_ENVS = {self.envs};",
                f"constexpr int {prefix}_FLOATS = {self.floats};",
                f"constexpr int {prefix}_SHARED = {self.shared};",
                f"constexpr int {prefix}_SMEM_BYTES = {self.smem_bytes};"] + [
                    f"constexpr int {prefix}_{k} = {v};"
                    for k, v in self.offsets.items()]


def packed_offsets(sizes, align: int = 1) -> tuple:
    """(name, floats) pairs laid end to end, each starting and ending on a
    multiple of ``align`` floats -> ({name: offset}, total)."""
    offsets, at = {}, 0
    for name, n in sizes:
        offsets[name] = at
        at += -(-int(n) // align) * align
    return offsets, at


def quad_odd(n: int) -> int:
    """The least multiple of four floats >= n that is an odd number of
    float4s: rows of that stride, read as float4 by the lanes of a team,
    hit distinct banks."""
    q = -(-int(n) // 4)
    return 4 * (q + 1 - q % 2)


def odd(n: int) -> int:
    """The row stride of a shared-memory matrix: n, or n + 1 when even, so
    the lanes of a team walking a column hit distinct banks."""
    return n | 1


def dyn_forward_layout(plan: "DynPlan") -> KernelLayout:
    """B2's layout: one lane per body (or dof), so the team covers
    max(NB, NV).  Per env: I_O then the per-body force F (component-major,
    element (k, b) at k * NB + b, so the 42 components of a subtree sum are
    one run), body velocities and accelerations, S, qd, rhs (then rhs - C),
    the drive diagonal, qdd, the CRBA column forces and H (row stride
    ``odd(NV)``; during the sweep it holds the pivot rows instead).  The
    staged inputs body_x, body_q and the two scales are read only before F,
    V and A exist and share their space."""
    nb, nv = plan.nb, plan.nv
    offsets, total = packed_offsets([
        ("IO", 36 * nb), ("FB", 6 * nb), ("V", 6 * nb), ("A", 6 * nb),
        ("S", 6 * nv), ("QD", nv), ("RHS", nv), ("DIAG", nv), ("QDD", nv),
        ("FD", 6 * nv), ("H", nv * odd(nv))])
    inputs, n_in = packed_offsets([("BX", 3 * nb), ("BQ", 4 * nb),
                                   ("MS", nb), ("SS", 3 * nb)])
    assert n_in <= 18 * nb
    offsets.update({k: offsets["FB"] + v for k, v in inputs.items()})
    offsets["HS"] = odd(nv)
    return KernelLayout(max(nb, nv), offsets, total)


def fk_motion_layout(plan: "DynPlan") -> KernelLayout:
    """B1's layout: a small team per env that poses the tree level by
    level, one lane per body of a level (8 lanes while no level is wider
    than 16 bodies), so that a warp carries several envs and the lanes of
    a level do the same work; blocks of 256 threads.  The block shares its
    scene tables (:func:`kernel_tables`).  Per env: q, each body's
    joint-local rotation and translation (LOC, 8 floats a body), then the
    outputs body_x, body_q and S in their global row order."""
    nb, nv = plan.nb, plan.nv
    offsets, total = packed_offsets([
        ("Q", plan.nq), ("LOC", 8 * nb), ("BX", 3 * nb), ("BQ", 4 * nb),
        ("S", 6 * nv)])
    ints, floats = kernel_tables(plan, "fk_motion")
    widest = max(len(lv) for lv in plan.levels)
    return KernelLayout(-(-widest // 2), offsets, total,
                        shared=_table_size(ints) + _table_size(floats))


def dyn_cached_layout(plan: "DynPlan") -> KernelLayout:
    """B3's layout: a team of the power of two nearest the wider of NB and
    NV (a lane per body or dof, some taking two: 16 at Ant and
    BallBalance, 32 at FrankaReachMA), in blocks of 256 threads; of the
    layouts timed on the H100 (scripts/time_team_layouts.py) these ran
    fastest at all three scenes.  The block shares its scene tables
    (:func:`kernel_tables`).  Per env: I_O and the gravity wrench (then
    the body forces) component-major (element (k, b) at k * NB + b), the
    body velocities and accelerations, the dofs' velocity products, S, qd,
    rhs (then rhs - C), H^-1's block entries only (:func:`tree_lists`) and
    qdd."""
    nb, nv = plan.nb, plan.nv
    n_hb = len(tree_lists(plan)["hb_row"])
    offsets, total = packed_offsets([
        ("IO", 36 * nb), ("FG", 6 * nb), ("V", 6 * nb), ("A", 6 * nb),
        ("XD", 6 * nv), ("S", 6 * nv), ("QD", nv), ("RHS", nv),
        ("HB", n_hb), ("QDD", nv)])
    ints, _ = kernel_tables(plan, "dyn_cached")
    team = 1 << round(math.log2(max(nb, nv)))
    return KernelLayout(team, offsets, total, shared=_table_size(ints))


_LAYOUTS = {"fk_motion": fk_motion_layout, "dyn_forward": dyn_forward_layout,
            "dyn_cached": dyn_cached_layout}


def _np_qapply(q, v):
    """numpy xyzw quat rotate (build-time constants)."""
    q = np.asarray(q, np.float32)
    v = np.asarray(v, np.float32)
    t = 2.0 * np.cross(q[:3], v)
    return v + q[3] * t + np.cross(q[:3], t)


# ---------------------------------------------------------------------------
# batch-last math helpers (arrays are (..., B); components unrolled)


def _cross_bl(a, b):
    """Cross product of (..., 3, B) stacks along axis -2."""
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-2)


def _cross_motion_bl(a, b):
    """Spatial motion cross product on (..., 6, B) [ang, lin] stacks."""
    aw, av = a[..., :3, :], a[..., 3:, :]
    bw, bv = b[..., :3, :], b[..., 3:, :]
    return torch.cat(
        [_cross_bl(aw, bw), _cross_bl(aw, bv) + _cross_bl(av, bw)], dim=-2)


def _cross_force_bl(v, f):
    """Spatial force cross product v x* f on (..., 6, B) stacks."""
    w, vl = v[..., :3, :], v[..., 3:, :]
    n, fl = f[..., :3, :], f[..., 3:, :]
    return torch.cat(
        [_cross_bl(w, n) + _cross_bl(vl, fl), _cross_bl(w, fl)], dim=-2)


def _quat_rotmat_bl(q):
    """(nb, 4, B) xyzw quaternions -> (nb, 3, 3, B) rotation matrices."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one = torch.ones_like(x)
    rows = [
        [one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy)],
    ]
    return torch.stack([torch.stack(r, dim=1) for r in rows], dim=1)


def _mm3_bl(A, B):
    """(..., 3, 3, B) @ (..., 3, 3, B) with a size-3 contraction."""
    return (A[..., :, 0:1, :] * B[..., 0:1, :, :]
            + A[..., :, 1:2, :] * B[..., 1:2, :, :]
            + A[..., :, 2:3, :] * B[..., 2:3, :, :])


def _mm3_nt_bl(A, B):
    """A @ B^T on (..., 3, 3, B) stacks."""
    return torch.sum(A[..., :, None, :, :] * B[..., None, :, :, :], dim=-2)


def _matvec_bl(A, x):
    """(..., m, n, B) @ (..., n, B) -> (..., m, B)."""
    return torch.sum(A * x[..., None, :, :], dim=-2)


def _skew_bl(v):
    """(..., 3, B) -> (..., 3, 3, B) skew matrices."""
    z = torch.zeros_like(v[..., 0, :])
    v0, v1, v2 = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    return torch.stack([
        torch.stack([z, -v2, v1], dim=-2),
        torch.stack([v2, z, -v0], dim=-2),
        torch.stack([-v1, v0, z], dim=-2),
    ], dim=-3)


def _eye_bl(n, like):
    """(n, n, 1) identity."""
    return torch.eye(n, dtype=like.dtype, device=like.device)[..., None]


def _subtree_sum(plan: DynPlan, per_body):
    """Bottom-up subtree sums of a list of per-body arrays."""
    acc = list(per_body)
    for b in plan.bottom_up:
        p = int(plan.parent[b])
        if p >= 0:
            acc[p] = acc[p] + acc[b]
    return acc


def _path_sum(plan: DynPlan, per_body):
    """Top-down root-to-body path sums of a list of per-body arrays."""
    acc = list(per_body)
    for b in reversed(plan.bottom_up):          # parents before children
        p = int(plan.parent[b])
        if p >= 0:
            acc[b] = acc[b] + acc[p]
    return acc


def sweep_inverse_bl(M: torch.Tensor) -> torch.Tensor:
    """Gauss-Jordan sweep inverse on a batch-last stack ``M (n, n, B)``
    (port of engine.py:212-234 ``_sweep_inverse_batchlast``).

    No pivoting: mass matrices are SPD, so diagonal pivots never vanish."""
    n = M.shape[0]
    idx = torch.arange(n, device=M.device)
    i_n1 = idx[:, None]
    i_1n1 = idx[None, :, None]
    i_n11 = idx[:, None, None]
    for k in range(n):
        mk = i_n1 == k
        inv_d = 1.0 / M[k, k]
        row = M[k] * inv_d                              # (n, B)
        col = torch.where(mk, 0.0, M[:, k])             # (n, B), row k zeroed
        M = M - col[:, None, :] * row[None, :, :]
        new_col = torch.where(mk, inv_d, -col * inv_d)
        new_row = torch.where(mk, inv_d, row)
        M = torch.where(i_1n1 == k, new_col[:, None, :], M)
        M = torch.where(i_n11 == k, new_row[None, :, :], M)
    return M


# ---------------------------------------------------------------------------
# chain pieces (twins of the B2/B3 kernel bodies)


def spatial_inertia_bl(plan: DynPlan, consts, body_x, body_q,
                       mass_scale=None, shape_scale=None):
    """World spatial inertia about the origin: (nb, 6, 6, B) batch-last,
    with optional per-env mass (nb, B) and shape (nb, 3, B) scales."""
    B = body_x.shape[-1]
    R = _quat_rotmat_bl(body_q)                                 # (nb, 3, 3, B)
    I_loc = consts["inertia"][..., None].expand(plan.nb, 3, 3, B)
    m = consts["mass"].expand(plan.nb, B)
    com = consts["com"][..., None].expand(plan.nb, 3, B)
    eye3 = _eye_bl(3, body_x)[None]                             # (1, 3, 3, 1)
    if shape_scale is not None:                                 # (nb, 3, B)
        s = shape_scale
        svol = (s[:, 0] * s[:, 1] * s[:, 2])[:, None, None, :]  # (nb,1,1,B)
        tr = (I_loc[:, 0, 0] + I_loc[:, 1, 1] + I_loc[:, 2, 2])[:, None, None, :]
        Cm = 0.5 * tr * eye3 - I_loc
        Cm = svol * (s[:, :, None, :] * Cm * s[:, None, :, :])
        trc = (Cm[:, 0, 0] + Cm[:, 1, 1] + Cm[:, 2, 2])[:, None, None, :]
        I_loc = trc * eye3 - Cm
        m = m * svol[:, 0, 0, :]
        com = com * s
    Ic = _mm3_nt_bl(_mm3_bl(R, I_loc), R)
    c = body_x + _matvec_bl(R, com)                             # world com
    if mass_scale is not None:                                  # (nb, B)
        m = m * mass_scale
        Ic = Ic * mass_scale[:, None, None, :]
    cx = _skew_bl(c)
    m4 = m[:, None, None, :]
    mcx = m4 * cx
    top_left = Ic - m4 * _mm3_bl(cx, cx)
    return torch.cat([
        torch.cat([top_left, mcx], dim=2),
        torch.cat([-mcx, m4 * eye3.expand(cx.shape)], dim=2),
    ], dim=1)                                                   # (nb, 6, 6, B)


def mass_matrix_bl(plan: DynPlan, consts, S, I_O):
    """CRBA on batch-last arrays: S (nv, 6, B), I_O (nb, 6, 6, B) -> (nv,nv,B).

    The composite inertia is the subtree sum at the descendant dof's body;
    the pair mask counts each (ancestor, descendant) pair once."""
    Icomp = _subtree_sum(plan, [I_O[b] for b in range(plan.nb)])
    F = torch.stack(
        [_matvec_bl(Icomp[int(plan.dof_body[v])], S[v])
         for v in range(plan.nv)], dim=0)                       # (nv, 6, B)
    G = sum(S[:, k, :][:, None, :] * F[:, k, :][None, :, :] for k in range(6))
    Gt = sum(F[:, k, :][:, None, :] * S[:, k, :][None, :, :] for k in range(6))
    upper = G * consts["anc"][:, :, None]
    lower = Gt * consts["anc_t"][:, :, None]
    eye = _eye_bl(plan.nv, S)
    diag = torch.sum(upper * eye, dim=1, keepdim=True)          # (nv, 1, B)
    return upper + lower - eye * diag


def body_velocities_bl(plan: DynPlan, S, qd):
    """Per-body spatial velocity (list of (6, B)) via root-to-body path sums."""
    Sqd = S * qd[:, None, :]                                    # (nv, 6, B)
    zero = torch.zeros_like(S[0])
    own = [sum((Sqd[v] for v in plan.body_dofs[b]), zero)
           for b in range(plan.nb)]
    return _path_sum(plan, own), Sqd


def bias_force_bl(plan: DynPlan, consts, S, qd, I_O, fg=None):
    """RNEA bias force C (nv, B).

    ``fg``: fresh per-body gravity wrench (nb, 6, B) — given on the cached
    (mass-matrix reuse) path, where gravity through the stale I_O would
    torque every translating floating base by |g|*h*v per substep."""
    V_body, Sqd = body_velocities_bl(plan, S, qd)
    a0 = consts["a0"][..., None]                                # (nb, 6, 1)
    xi_dof = [_cross_motion_bl(V_body[int(plan.dof_body[v])], Sqd[v])
              for v in range(plan.nv)]
    zero = torch.zeros_like(S[0])
    xi_body = [sum((xi_dof[v] for v in plan.body_dofs[b]), zero)
               for b in range(plan.nb)]
    a_cum = _path_sum(plan, xi_body)
    fb = []
    for b in range(plan.nb):
        a_b = a_cum[b] if fg is not None else a0[b] + a_cum[b]
        Iv = _matvec_bl(I_O[b], V_body[b])
        f_b = _matvec_bl(I_O[b], a_b) + _cross_force_bl(V_body[b], Iv)
        if fg is not None:
            f_b = f_b + fg[b]
        fb.append(f_b)
    f_comp = _subtree_sum(plan, fb)
    return torch.stack(
        [torch.sum(S[v] * f_comp[int(plan.dof_body[v])], dim=0)
         for v in range(plan.nv)], dim=0)                       # (nv, B)


def dyn_full_bl(plan: DynPlan, consts, body_x, body_q, S, qd, rhs, diag,
                mass_scale=None, shape_scale=None):
    """Full chain (twin of B2): returns (qdd, Hinv, I_O) batch-last.

    rhs is the generalized force *without* the bias term; diag is the
    implicit-drive diagonal."""
    I_O = spatial_inertia_bl(plan, consts, body_x, body_q,
                             mass_scale, shape_scale)
    M = mass_matrix_bl(plan, consts, S, I_O)
    H = M + _eye_bl(plan.nv, S) * diag[:, None, :]
    Hinv = sweep_inverse_bl(H)
    C = bias_force_bl(plan, consts, S, qd, I_O)
    qdd = _matvec_bl(Hinv, rhs - C)
    return qdd, Hinv, I_O


def dyn_cached_bl(plan: DynPlan, consts, S, qd, rhs, I_O, Hinv, fg):
    """Cached chain (twin of B3): reuse (I_O, Hinv) from an earlier substep;
    the velocity-dependent bias refreshes and gravity comes through the
    fresh wrench ``fg``."""
    C = bias_force_bl(plan, consts, S, qd, I_O, fg=fg)
    return _matvec_bl(Hinv, rhs - C)


# ---------------------------------------------------------------------------
# FK + motion subspace (twin of B1)


def _qmul_cf(a, b):
    """Hamilton product, xyzw, components-first layout (4, B)."""
    ax, ay, az, aw = a[0], a[1], a[2], a[3]
    bx, by, bz, bw = b[0], b[1], b[2], b[3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz])


def _qapply_cf(q, v):
    """Rotate (3, B) vectors by (4, B) quats."""
    qx, qy, qz, qw = q[0], q[1], q[2], q[3]
    vx, vy, vz = v[0], v[1], v[2]
    tx = 2.0 * (qy * vz - qz * vy)
    ty = 2.0 * (qz * vx - qx * vz)
    tz = 2.0 * (qx * vy - qy * vx)
    return torch.stack([
        vx + qw * tx + qy * tz - qz * ty,
        vy + qw * ty + qz * tx - qx * tz,
        vz + qw * tz + qx * ty - qy * tx])


def _cross_cf(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0]])


def _fk_motion_bl(plan: DynPlan, qv):
    """FK + S on batch-last (nq, B) coords -> ((nb,3,B), (nb,4,B), (nv,6,B))."""
    B = qv.shape[-1]
    cst = lambda v: torch.as_tensor(  # noqa: E731
        np.asarray(v, np.float32), device=qv.device)[:, None].expand(len(v), B)
    zero3 = torch.zeros((3, B), dtype=qv.dtype, device=qv.device)
    xs, qs, cols = [], [], []
    for b in range(plan.nb):
        c = plan.fk[b]
        t, qa = c["type"], c["qa"]
        if c["parent"] == -1:
            xp, qp = zero3, cst([0.0, 0.0, 0.0, 1.0])
        else:
            xp, qp = xs[c["parent"]], qs[c["parent"]]
        if t == md.FREE:
            xb = qv[qa: qa + 3]
            qb = qv[qa + 3: qa + 7]
        elif t in (md.HINGE, md.SCREW):
            half = 0.5 * qv[qa]
            s, co = torch.sin(half), torch.cos(half)
            ax = c["axis"]
            qj = torch.stack([float(ax[0]) * s, float(ax[1]) * s,
                              float(ax[2]) * s, co])
            ql = _qmul_cf(cst(c["bq"]), qj)
            tl = cst(c["tl0"]) - _qapply_cf(ql, cst(c["anchor"]))
            if t == md.SCREW:
                tl = tl + cst(c["awb"]) * (c["pitch"] * qv[qa])[None]
            xb = xp + _qapply_cf(qp, tl)
            qb = _qmul_cf(qp, ql)
        elif t == md.SLIDE:
            tl = cst(c["bp"]) + cst(c["awb"]) * qv[qa][None]
            xb = xp + _qapply_cf(qp, tl)
            qb = _qmul_cf(qp, cst(c["bq"]))
        else:  # FIXED
            xb = xp + _qapply_cf(qp, cst(c["bp"]))
            qb = _qmul_cf(qp, cst(c["bq"]))
        xs.append(xb)
        qs.append(qb)
        # motion-subspace columns (about the world origin, [ang; lin])
        if t == md.FREE:
            e = np.eye(3, dtype=np.float32)
            for i in range(3):
                cols.append(torch.cat([zero3, cst(e[i])]))
            for i in range(3):
                ei = cst(e[i])
                cols.append(torch.cat([ei, _cross_cf(xb, ei)]))
        elif t in (md.HINGE, md.SCREW, md.SLIDE):
            a_w = _qapply_cf(qb, cst(c["axis"]))
            if t == md.SLIDE:
                cols.append(torch.cat([zero3, a_w]))
            else:
                anch_w = xb + _qapply_cf(qb, cst(c["anchor"]))
                lin = _cross_cf(anch_w, a_w)
                if t == md.SCREW:
                    lin = lin + c["pitch"] * a_w
                cols.append(torch.cat([a_w, lin]))
    return torch.stack(xs), torch.stack(qs), torch.stack(cols)


# ---------------------------------------------------------------------------
# per-scene CUDA header


def _c_list(values, fmt):
    return "{" + ", ".join(fmt(v) for v in values) + "}"


def _c_float(x) -> str:
    return "%.9ef" % float(np.float32(x))


def scene_header(plan: DynPlan) -> str:
    """C++ header baking the static tree into the CUDA kernels B1-B3.

    Sizes and the level offsets are ``constexpr`` (the level loops are
    unrolled at compile time, so each lookup folds to an immediate); every
    table that the lanes of a team index at run time, each with its own
    body or dof, is a device array (:func:`_dev_array`)."""
    nb, nv = plan.nb, plan.nv
    a0 = np.concatenate([np.zeros(3, np.float32), -plan.gravity])
    a0 = (a0[None, :] * plan.grav_mask[:, None]).astype(np.float32)
    lines = [
        "// Generated by isaacgymenvs_ma_tpu_torch.physics.dyn_kernel."
        "scene_header: do not edit.",
        "#pragma once",
        "namespace scene {",
        f"constexpr int NB = {nb};",
        f"constexpr int NV = {nv};",
        f"constexpr int NQ = {plan.nq};",
        f"constexpr int FREE = {md.FREE}, HINGE = {md.HINGE}, "
        f"SLIDE = {md.SLIDE}, FIXED = {md.FIXED}, SCREW = {md.SCREW};",
    ]
    lines += _b2_tables(plan, a0)
    lines += _b1_b3_tables(plan)
    lines += ["}  // namespace scene", ""]
    return "\n".join(lines)


def _dev_array(ctype: str, name: str, vals) -> str:
    """A table in device memory, for indices that differ between the lanes
    of a team (a ``constexpr`` table indexed at run time would be copied to
    each thread's stack)."""
    vals = list(vals) or [0]
    fmt = _c_float if ctype == "float" else (lambda v: str(int(v)))
    return (f"__device__ const {ctype} {name}[{len(vals)}] = "
            f"{_c_list(vals, fmt)};")


def b2_tables(plan: DynPlan) -> dict:
    """The per-lane tables of kernel B2, as plain lists.

    ``lvl_body``: bodies ordered by tree depth, level L at
    ``lvl_off[L]:lvl_off[L + 1]``; ``gat_body``: the same for the bodies
    that have children, level L at ``gat_off[L]:gat_off[L + 1]``;
    ``child``: children of body b at ``child_off[b]:child_off[b + 1]``; ``block_dofs``: the blocks' dofs
    end to end, block i at ``block_off[i]`` with ``block_size[i]`` dofs;
    ``dof_block[v]``: base | size << 8 | at << 16 of v's block (its dofs at
    ``block_dofs[base:base + size]``, v at ``base + at``); ``pair``: the
    CRBA pairs (i, j) of ``dof_anc`` as i | j << 8."""
    nb, nv = plan.nb, plan.nv
    if nv > 127:    # three packed fields in one positive int
        raise ValueError("B2's packed tables take at most 127 dofs")
    lvl_off = np.cumsum([0] + [len(lv) for lv in plan.levels]).tolist()
    gat = [[b for b in lv if plan.children[b]] for lv in plan.levels]
    gat_off = np.cumsum([0] + [len(g) for g in gat]).tolist()
    child_off = np.cumsum([0] + [len(c) for c in plan.children]).tolist()
    block_off = np.cumsum([0] + [len(b) for b in plan.blocks]).tolist()[:-1]
    dof_block = [0] * nv
    for blk, base in zip(plan.blocks, block_off):
        for at, v in enumerate(blk):
            dof_block[v] = base | len(blk) << 8 | at << 16
    return dict(
        lvl_body=[b for lv in plan.levels for b in lv], lvl_off=lvl_off,
        gat_body=[b for g in gat for b in g], gat_off=gat_off,
        child=[c for ch in plan.children for c in ch], child_off=child_off,
        vadr=[d[0] if d else 0 for d in plan.body_dofs],
        ndof=[len(d) for d in plan.body_dofs],
        block_dofs=[v for blk in plan.blocks for v in blk],
        block_off=block_off, block_size=[len(b) for b in plan.blocks],
        dof_block=dof_block,
        pair=[int(i) | int(j) << 8
              for i, j in zip(*np.nonzero(plan.dof_anc))])


def tree_lists(plan: DynPlan) -> dict:
    """The per-lane lists of kernel B3, as plain lists.

    ``act``: the bodies whose motion or force reaches a dof, those with a
    dof on their path from the root (a fixed root with no dof below it,
    such as FrankaReachMA's table, or a fixed base above its arm's first
    joint moves nothing and no C_v sums its force); B3 takes only these,
    one lane each (FrankaReachMA: 32 of 35).  ``anc``: body b's path from
    its root down to b itself, only its active bodies, at
    ``anc_off[b]:anc_off[b + 1]``, root first as the twins' path sums add
    (an inactive ancestor only adds exact zeros); ``desc``: b's subtree, b
    first and then its descendants depth first, at
    ``desc_off[b]:desc_off[b + 1]``; ``hb_row``: the rows ``i * NV + j`` of
    H^-1's diagonal-block entries, block after block, each block row-major
    (B3 stages only these: H^-1 is exactly zero off the blocks);
    ``dof_hb[v]``: where dof v's row of its block starts among them."""
    paths = []
    for b in range(plan.nb):
        path = [b]
        while plan.parent[path[-1]] != -1:
            path.append(int(plan.parent[path[-1]]))
        paths.append(path[::-1])
    active = [any(plan.body_dofs[a] for a in paths[b])
              for b in range(plan.nb)]
    anc, anc_off, desc, desc_off = [], [0], [], [0]
    for b in range(plan.nb):
        anc += [a for a in paths[b] if active[a]]
        anc_off.append(len(anc))
        stack = [b]
        while stack:
            c = stack.pop()
            desc.append(c)
            stack += plan.children[c][::-1]
        desc_off.append(len(desc))
    hb_row, dof_hb = [], [0] * plan.nv
    for blk in plan.blocks:
        for i in blk:
            dof_hb[i] = len(hb_row)
            hb_row += [i * plan.nv + j for j in blk]
    return dict(act=[b for b in range(plan.nb) if active[b]], anc=anc,
                anc_off=anc_off, desc=desc, desc_off=desc_off,
                hb_row=hb_row, dof_hb=dof_hb)


def kernel_tables(plan: DynPlan, name: str) -> tuple:
    """The scene tables kernel B1 (``fk_motion``) or B3 (``dyn_cached``)
    copies into shared memory at the start of each block, as ({table: int
    list}, {table: float list}): every lookup of a lane, each lane with its
    own body or dof, is then a shared-memory read and not a dependent
    device-memory read (:func:`tree_lists`, :func:`b2_tables` and the
    joint constants of :meth:`DynPlan._fk_body`)."""
    t, b2 = tree_lists(plan), b2_tables(plan)
    if name == "fk_motion":
        fk = plan.fk
        ints = {"type": [c["type"] for c in fk], "qadr": [c["qa"] for c in fk],
                "vadr": [c["va"] for c in fk], "parent": plan.parent.tolist(),
                "lvl_body": b2["lvl_body"]}
        floats = {"pitch": [c["pitch"] for c in fk]}
        for key in ("bp", "bq", "axis", "anchor", "tl0", "awb"):
            floats[key] = np.stack([c[key] for c in fk]).reshape(-1).tolist()
        return ints, floats
    if name == "dyn_cached":
        ints = {k: b2[k] for k in ("vadr", "ndof", "dof_block", "block_dofs")}
        ints.update(dof_body=plan.dof_body.tolist(),
                    **{k: t[k] for k in ("act", "anc", "anc_off", "desc",
                                         "desc_off", "dof_hb")})
        return ints, {}
    raise ValueError(f"no scene tables for kernel {name!r}")


def _table_size(tables: dict) -> int:
    return sum(len(v) for v in tables.values())


def _packed_tables(prefix: str, tables: dict, ctype: str) -> list:
    """Header lines of one kernel's tables of one C type, end to end in one
    device array ``<prefix>_<c>tab`` (c the type's initial; at least one
    entry), with each table's offset as ``<PREFIX>T_<TABLE>`` and the total
    as ``<PREFIX>T_N<C>``."""
    P = prefix.upper() + "T"
    lines, flat = [], []
    for name, vals in tables.items():
        lines.append(f"constexpr int {P}_{name.upper()} = {len(flat)};")
        flat += list(vals)
    lines.append(f"constexpr int {P}_N{ctype[0].upper()} = {len(flat)};")
    lines.append(_dev_array(ctype, f"{prefix}_{ctype[0]}tab", flat))
    return lines


def _b1_b3_tables(plan: DynPlan) -> list:
    """Header lines of kernels B1 and B3: their launch layouts, their
    packed scene tables (:func:`kernel_tables`; B1's ints then floats, B3's
    ints, at the start of each block's shared memory) and H^-1's
    block-entry rows that B3 stages."""
    b1_ints, b1_floats = kernel_tables(plan, "fk_motion")
    b3_ints, _ = kernel_tables(plan, "dyn_cached")
    return (plan.layout("fk_motion").header_lines("B1")
            + _packed_tables("b1", b1_ints, "int")
            + _packed_tables("b1", b1_floats, "float")
            + plan.layout("dyn_cached").header_lines("B3")
            + _packed_tables("b3", b3_ints, "int")
            + [f"constexpr int B3_NACT = {len(b3_ints['act'])};",
               _dev_array("int", "b3_hb_row", tree_lists(plan)["hb_row"])])


def _b2_tables(plan: DynPlan, a0) -> list:
    """Header lines of kernel B2: its launch layout, the tree levels and
    H's blocks (:func:`b2_tables`), and the body constants again as device
    arrays for the lanes that each take one body."""
    t = b2_tables(plan)
    lines = plan.layout().header_lines("B2") + [
        f"constexpr int NLEV = {len(plan.levels)};",
        f"constexpr int NBLK = {len(plan.blocks)};",
        f"constexpr int MAXBLK = {max(t['block_size'])};",
        f"constexpr int NPAIR = {len(t['pair'])};",
    ] + [f"__device__ __forceinline__ int {name}(int L) {{ "
         f"constexpr int t[{len(t[name])}] = "
         f"{_c_list(t[name], str)}; return t[L]; }}"
         for name in ("lvl_off", "gat_off")]
    for name in ("lvl_body", "gat_body", "child_off", "child", "vadr", "ndof",
                 "block_dofs", "block_off", "block_size", "dof_block",
                 "pair"):
        lines.append(_dev_array("int", f"b2_{name}", t[name]))
    lines += [
        _dev_array("int", "b2_parent", plan.parent.tolist()),
        _dev_array("int", "b2_dof_body", plan.dof_body.tolist()),
        _dev_array("float", "b2_mass", plan.mass),
        _dev_array("float", "b2_com", plan.com.reshape(-1)),
        _dev_array("float", "b2_inertia", plan.inertia.reshape(-1)),
        _dev_array("float", "b2_a0", np.asarray(a0, np.float32).reshape(-1)),
    ]
    return lines


# ---------------------------------------------------------------------------
# dispatching wrappers


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU, False when every one lies on
    a CUDA device; anything else raises (no silent fallback)."""
    types = {t.device.type for t in tensors if t is not None}
    if types == {"cpu"}:
        return True
    if types == {"cuda"}:
        return False
    raise ValueError(f"tensors on unsupported/mixed devices: {sorted(types)}")


def _check_kernel_input(name, t, shape):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _launch(plan, name, device, *args):
    """Launch on ``device``'s current PyTorch stream; raise on a CUDA error."""
    lib = _build.load(plan, name)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    err = getattr(lib, name + "_launch")(ctypes.c_int(device.index), *args,
                                         stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def fk_motion(plan: DynPlan, q_bl: torch.Tensor):
    """B1. q (nq, N) -> body_x (nb, 3, N), body_q (nb, 4, N), S (nv, 6, N),
    all batch-last.  CPU: plain twin; CUDA: ``csrc/fk_motion.cu``."""
    if _on_cpu(q_bl):
        return _fk_motion_bl(plan, q_bl)
    N = q_bl.shape[-1]
    _check_kernel_input("q", q_bl, (plan.nq, N))
    kw = dict(dtype=torch.float32, device=q_bl.device)
    bx = torch.empty((plan.nb, 3, N), **kw)
    bq = torch.empty((plan.nb, 4, N), **kw)
    S = torch.empty((plan.nv, 6, N), **kw)
    _launch(plan, "fk_motion", q_bl.device, _ptr(q_bl), _ptr(bx), _ptr(bq), _ptr(S),
            ctypes.c_int(N))
    fk_motion.launches += 1
    return bx, bq, S


def dyn_forward(plan: DynPlan, body_x, body_q, S, qd, rhs, diag,
                mass_scale=None, shape_scale=None):
    """B2. Batch-last inputs body_x (nb,3,N), body_q (nb,4,N), S (nv,6,N),
    qd/rhs/diag (nv,N), optional mass_scale (nb,N) and shape_scale (nb,3,N)
    -> (qdd (nv,N), Hinv (nv,nv,N), I_O (nb,6,6,N)).
    CPU: plain twin; CUDA: ``csrc/dyn_forward.cu``."""
    if _on_cpu(body_x, body_q, S, qd, rhs, diag, mass_scale, shape_scale):
        return dyn_full_bl(plan, plan.consts(qd.device), body_x, body_q, S,
                           qd, rhs, diag, mass_scale, shape_scale)
    N = qd.shape[-1]
    nb, nv = plan.nb, plan.nv
    for name, t, shape in (("body_x", body_x, (nb, 3, N)),
                           ("body_q", body_q, (nb, 4, N)),
                           ("S", S, (nv, 6, N)), ("qd", qd, (nv, N)),
                           ("rhs", rhs, (nv, N)), ("diag", diag, (nv, N)),
                           ("mass_scale", mass_scale, (nb, N)),
                           ("shape_scale", shape_scale, (nb, 3, N))):
        if t is not None:
            _check_kernel_input(name, t, shape)
    kw = dict(dtype=torch.float32, device=qd.device)
    qdd = torch.empty((nv, N), **kw)
    hinv = torch.empty((nv, nv, N), **kw)
    io = torch.empty((nb, 6, 6, N), **kw)
    _launch(plan, "dyn_forward", qd.device, _ptr(body_x), _ptr(body_q), _ptr(S),
            _ptr(qd), _ptr(rhs), _ptr(diag), _ptr(mass_scale),
            _ptr(shape_scale), _ptr(qdd), _ptr(hinv), _ptr(io),
            ctypes.c_int(N))
    dyn_forward.launches += 1
    return qdd, hinv, io


def dyn_cached(plan: DynPlan, S, qd, rhs, I_O, Hinv, fg):
    """B3. Batch-last S (nv,6,N), qd/rhs (nv,N), cached I_O (nb,6,6,N) and
    Hinv (nv,nv,N), fresh gravity wrench fg (nb,6,N) -> qdd (nv,N).
    CPU: plain twin; CUDA: ``csrc/dyn_cached.cu``."""
    if _on_cpu(S, qd, rhs, I_O, Hinv, fg):
        return dyn_cached_bl(plan, plan.consts(qd.device), S, qd, rhs, I_O,
                             Hinv, fg)
    N = qd.shape[-1]
    nb, nv = plan.nb, plan.nv
    for name, t, shape in (("S", S, (nv, 6, N)), ("qd", qd, (nv, N)),
                           ("rhs", rhs, (nv, N)), ("I_O", I_O, (nb, 6, 6, N)),
                           ("Hinv", Hinv, (nv, nv, N)), ("fg", fg, (nb, 6, N))):
        _check_kernel_input(name, t, shape)
    qdd = torch.empty((nv, N), dtype=torch.float32, device=qd.device)
    _launch(plan, "dyn_cached", qd.device, _ptr(S), _ptr(qd), _ptr(rhs), _ptr(I_O),
            _ptr(Hinv), _ptr(fg), _ptr(qdd), ctypes.c_int(N))
    dyn_cached.launches += 1
    return qdd


fk_motion.launches = 0
dyn_forward.launches = 0
dyn_cached.launches = 0
