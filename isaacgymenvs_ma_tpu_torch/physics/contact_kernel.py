"""Contact/constraint iteration loop: plain PyTorch twin and CUDA kernel B4.

Port of isaacgymenvs_ma_tpu/physics/contact_kernel.py.  The engine builds
the contact rows, the batched ``H^-1 J`` products and the Delassus
diagonals once per solve (``torch.bmm``, as the JAX engine leaves them to
XLA); this module runs the whole projected-Jacobi iteration loop.  Row
Jacobians are rebuilt from the batch-last motion subspace S and the row
points (``J = S_lin + S_ang x p``, masked by static dof masks, optionally
projected into per-row frames), and impulses are applied as
``qd += H^-1 (J^T dlam)``.

Group order per iteration, Jacobi with relaxation inside a group:
grabs -> attractors -> contact rows (normal, then the friction box against
the new normal) -> joint limits.

==========  ==================  =========================================
wrapper     CUDA source         replaces (TPU Pallas kernel)
==========  ==================  =========================================
solve       csrc/contact_solve  contact_kernel.py:221 solve_pallas
==========  ==================  =========================================

``solve`` runs the twin :func:`solve_bl` for CPU tensors and launches the
kernel for CUDA tensors (no fallback either way) and counts its launches in
``solve.launches``.  The static part of the problem (row masks per group,
iteration count, relaxation, whether rows carry frames) is a
:class:`ContactPlan`, baked into the kernel as a per-plan header, with the
kernel's launch layout (:func:`contact_layout`): a team of lanes per env,
the rows of each group split over the team (:meth:`ContactPlan.row_lanes`),
the env's inputs and row Jacobians in shared memory.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .dyn_kernel import (KernelLayout, _c_float, _c_list,
                         _check_kernel_input, _dev_array, _launch, _on_cpu,
                         _ptr, packed_offsets, quad_odd)

GROUPS = ("c", "a", "g")   # contact rows, attractors, grabs


class ContactPlan:
    """Static description of one contact solve, built from plain arrays.

    ``masks``: {"c": (P, nv), "a": (A, nv), "g": (G, nv)} dof masks of the
    contact rows, attractor rows and grab rows (a missing group has no
    rows); ``has_frames``: contact rows are projected into per-row frames.
    """

    kernel_names = ("contact_solve",)

    def __init__(self, masks: dict, nv: int, num_iterations: int,
                 relaxation: float, has_frames: bool):
        self.nv = int(nv)
        unknown = set(masks) - set(GROUPS)
        if unknown:
            raise ValueError(f"unknown mask groups {sorted(unknown)}")
        self.masks = {
            k: np.asarray(masks.get(k, np.zeros((0, self.nv))),
                          np.float32).reshape(-1, self.nv)
            for k in GROUPS}
        self.P, self.A, self.G = (self.masks[k].shape[0] for k in GROUPS)
        if self.P == 0:
            raise ValueError("a contact plan needs at least one contact row")
        self.num_iterations = int(num_iterations)
        self.relaxation = float(relaxation)
        self.has_frames = bool(has_frames)
        self._consts = {}
        self.libs = {}          # kernel name -> loaded ctypes library
        self.build_log = {}     # kernel name -> nvcc/ptxas report

    def mask_tensors(self, device):
        """The row masks as float32 tensors on ``device`` (cached)."""
        key = str(device)
        if key not in self._consts:
            self._consts[key] = {
                k: torch.as_tensor(v, device=device)
                for k, v in self.masks.items()}
        return self._consts[key]

    def header(self) -> str:
        return contact_header(self)

    def layout(self, name: str = "contact_solve") -> KernelLayout:
        """Launch layout of kernel B4 (team, envs per block, shared memory)."""
        if name != "contact_solve":
            raise ValueError(f"a contact plan has no kernel {name!r}")
        return contact_layout(self)

    def row_lanes(self, group: str) -> list:
        """The rows of ``group`` ("c", "a", "g") that each lane of B4's team
        owns: row r goes to lane r % team."""
        team = self.layout().team
        rows = self.masks[group].shape[0]
        return [list(range(lane, rows, team)) for lane in range(team)]

    def cols_in_registers(self) -> bool:
        """Whether each lane of B4 keeps its dofs' contact-row J columns in
        registers (with its H^-1 rows: at most 128 floats), or reads them
        from J in shared memory (wide plans)."""
        rd = -(-self.nv // self.layout().team)
        return rd * (3 * self.P + self.nv) <= 128

    def mask_nonzeros(self) -> dict:
        """Nonzero mask entries per group (the kernel's work per pass)."""
        return {k: int(np.count_nonzero(v)) for k, v in self.masks.items()}


def contact_layout(plan: ContactPlan) -> KernelLayout:
    """B4's layout: the team covers half the widest of the row groups and
    the dofs (one lane per row or dof, up to two of each), in blocks of 128
    threads: each lane keeps its rows' and dofs' data in registers, and on
    the H100 half-width teams in small blocks (more envs resident per SM)
    ran faster than full-width ones at Ant, BallBalance and on the grab
    plan.  Per env, each array on a 16-byte boundary: the staged inputs,
    the groups' row Jacobians J (row c * rows + r, frame-projected for
    contact rows, built once per solve, row stride ``quad_odd(NV)``: read
    as float4), the contact impulses, one group's impulse deltas and the
    dof impulse x."""
    nv, P, A, G = plan.nv, plan.P, plan.A, plan.G
    js = quad_odd(nv)
    offsets, total = packed_offsets([
        ("S", 6 * nv), ("HI", nv * nv), ("QD", nv), ("PC", 3 * P),
        ("BN", P), ("MU", P), ("ACT", P), ("FR", 9 * P if plan.has_frames
                                           else 0),
        ("WC", 3 * P), ("BLO", nv), ("BHI", nv), ("ALO", nv), ("AHI", nv),
        ("PA", 3 * A), ("BA", 3 * A), ("WA", 3 * A), ("PG", 3 * G),
        ("BG", 3 * G), ("WG", 3 * G), ("GACT", G), ("JC", 3 * P * js),
        ("JA", 3 * A * js), ("JG", 3 * G * js), ("LAM", 3 * P),
        ("DL", 3 * max(P, A, G)), ("X", nv)], align=4)
    offsets["JS"] = js
    return KernelLayout(-(-max(nv, P, A, G) // 2), offsets, total,
                        quad=True, threads=128)


def contact_header(plan: ContactPlan) -> str:
    """C++ header baking a contact plan into kernel B4: sizes, iteration
    count, relaxation, the launch layout, the row masks as device arrays
    (``dmask_*``, row r at ``r * NV``: the lanes of a team read different
    rows), and which dofs each group touches (``used_*``, read in unrolled
    dof loops, where each lookup folds to an immediate)."""
    nv = plan.nv
    lines = [
        "// Generated by isaacgymenvs_ma_tpu_torch.physics.contact_kernel."
        "contact_header: do not edit.",
        "#pragma once",
        "namespace cscene {",
        f"constexpr int NV = {nv};",
        f"constexpr int P = {plan.P};",
        f"constexpr int A = {plan.A};",
        f"constexpr int G = {plan.G};",
        f"constexpr bool FRAMES = {'true' if plan.has_frames else 'false'};",
        f"constexpr int NITER = {plan.num_iterations};",
        f"constexpr float RELAX = {_c_float(plan.relaxation)};",
        "constexpr bool B4_JREG = "
        f"{'true' if plan.cols_in_registers() else 'false'};",
    ] + plan.layout().header_lines("B4")
    for k in GROUPS:
        m = plan.masks[k]
        vals = m.reshape(-1) if m.size else np.zeros(1, np.float32)
        lines.append(_dev_array("float", f"dmask_{k}", vals))
        used = (m != 0).any(axis=0) if m.size else np.zeros(nv, bool)
        lines.append(
            f"__device__ __forceinline__ bool used_{k}(int v) {{ "
            f"constexpr bool t[{nv}] = "
            f"{_c_list(used, lambda u: 'true' if u else 'false')}; "
            "return t[v]; }")
    lines += ["}  // namespace cscene", ""]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# plain twin (batch-last, component-leading)


def _row_jacobian(S, pts, mask):
    """J[c][k, v] = (S_lin[v, c] + (S_ang[v] x p[k])_c) * mask[k, v]:
    S (nv, 6, B), pts (3, K, B), mask (K, nv) -> (3, K, nv, B)."""
    a = [S[:, i, :][None] for i in range(3)]                 # (1, nv, B)
    lin = [S[:, 3 + i, :][None] for i in range(3)]
    b = [pts[i][:, None, :] for i in range(3)]               # (K, 1, B)
    cross = [a[1] * b[2] - a[2] * b[1],
             a[2] * b[0] - a[0] * b[2],
             a[0] * b[1] - a[1] * b[0]]                      # (K, nv, B)
    m = mask[:, :, None]
    return torch.stack([(lin[c] + cross[c]) * m for c in range(3)])


def _rows_dot_qd(J, qd):
    """v[c][k] = sum_v J[c][k, v] qd[v] -> (3, K, B)."""
    return torch.sum(J * qd[None, None], dim=2)


def _rows_impulse(J, dlam):
    """imp[v] = sum_{c, k} dlam[c][k] J[c][k, v] -> (nv, B)."""
    return torch.sum(J * dlam[:, :, None, :], dim=(0, 1))


def _hinv_matvec(Hinv, x):
    """(nv, nv, B) @ (nv, B) -> (nv, B)."""
    return torch.sum(Hinv * x[None], dim=1)


def solve_bl(plan: ContactPlan, S, Hinv, qd, pts_c, b_n, mu, active, frames,
             w_c, b_lo, b_hi, act_lo, act_hi, pts_a=None, b_a=None, w_a=None,
             pts_g=None, b_g=None, g_act=None, w_g=None):
    """Twin of kernel B4 (contact_kernel.py:100-172 of the JAX package).

    Batch-last, component-leading inputs: S (nv, 6, B), Hinv (nv, nv, B),
    qd/b_lo/b_hi/act_lo/act_hi (nv, B), pts_*/w_*/b_a/b_g (3, K, B),
    b_n/mu/active (P, B), g_act (G, B), frames (3c, 3l, P, B) or None.
    Returns (qd (nv, B), lam (3, P, B) in row coordinates, imp_dof (nv, B))."""
    relax = plan.relaxation
    masks = plan.mask_tensors(qd.device)
    J = _row_jacobian(S, pts_c, masks["c"])                  # (3, P, nv, B)
    if frames is not None:
        # Jf[l][k, v] = sum_c J[c][k, v] F[c, l][k]
        J = torch.stack([sum(J[c] * frames[c, l][:, None, :] for c in range(3))
                         for l in range(3)])
    if pts_g is not None:
        Jg = _row_jacobian(S, pts_g, masks["g"])
    if pts_a is not None:
        Ja = _row_jacobian(S, pts_a, masks["a"])
    hinv_diag = torch.clamp(torch.diagonal(Hinv, dim1=0, dim2=1).t(),
                            min=1e-8)                        # (nv, B)
    lam = torch.zeros((3,) + tuple(b_n.shape), dtype=qd.dtype,
                      device=qd.device)
    lam_lo = torch.zeros_like(qd)
    lam_hi = torch.zeros_like(qd)
    for _ in range(plan.num_iterations):
        if pts_g is not None:
            dl_g = relax * (b_g - _rows_dot_qd(Jg, qd)) / w_g * g_act[None]
            qd = qd + _hinv_matvec(Hinv, _rows_impulse(Jg, dl_g))
        if pts_a is not None:
            dl_a = relax * (b_a - _rows_dot_qd(Ja, qd)) / w_a
            qd = qd + _hinv_matvec(Hinv, _rows_impulse(Ja, dl_a))
        v_c = _rows_dot_qd(J, qd)                            # (3, P, B)
        dv_n = b_n - v_c[2]
        lam_n = torch.clamp(lam[2] + relax * dv_n / w_c[2], min=0.0) * active
        max_f = mu * lam_n
        lam_t1 = torch.clamp(lam[0] + relax * (-v_c[0]) / w_c[0],
                             -max_f, max_f)
        lam_t2 = torch.clamp(lam[1] + relax * (-v_c[1]) / w_c[1],
                             -max_f, max_f)
        lam_new = torch.stack([lam_t1, lam_t2, lam_n]) * active[None]
        dlam = lam_new - lam
        lam = lam_new
        qd = qd + _hinv_matvec(Hinv, _rows_impulse(J, dlam))
        # joint limits (J = e_v)
        lam_lo_new = act_lo * torch.clamp(
            lam_lo + relax * (b_lo - qd) / hinv_diag, min=0.0)
        lam_hi_new = act_hi * torch.clamp(
            lam_hi + relax * (b_hi + qd) / hinv_diag, min=0.0)
        dlim = (lam_lo_new - lam_lo) - (lam_hi_new - lam_hi)
        lam_lo, lam_hi = lam_lo_new, lam_hi_new
        qd = qd + _hinv_matvec(Hinv, dlim)
    imp_dof = _rows_impulse(J, lam) + (lam_lo - lam_hi)
    return qd, lam, imp_dof


# ---------------------------------------------------------------------------
# dispatching wrapper


def _cl(x):
    """(N, K, 3) -> component-leading batch-last (3, K, N)."""
    return None if x is None else x.permute(2, 1, 0).contiguous()


def _bl(x):
    """(N, ...) -> batch-last (..., N) for 2-D inputs."""
    return None if x is None else x.t().contiguous()


def solve(plan: ContactPlan, S_bl, hinv_bl, qd, pts_c, b_n, mu, active,
          frames, w_c, b_lo, b_hi, act_lo, act_hi, pts_a=None, b_a=None,
          w_a=None, pts_g=None, b_g=None, g_act=None, w_g=None):
    """B4 in the layout of the JAX ``solve_pallas``: standard-layout dynamic
    inputs (N leading) except S_bl (nv, 6, N) and hinv_bl (nv, nv, N), which
    come batch-last from kernels B1-B3.  qd/b_lo/b_hi/act_lo/act_hi (N, nv),
    pts_*/w_*/b_a/b_g (N, K, 3), b_n/mu/active (N, P), g_act (N, G), frames
    (N, P, 3, 3) or None.  Returns (qd (N, nv), lam (N, P, 3) in row
    coordinates, imp_dof (N, nv)).

    CPU tensors: the twin :func:`solve_bl`; CUDA tensors:
    ``csrc/contact_solve.cu``."""
    groups = {"a": pts_a, "g": pts_g}
    for k, pts in groups.items():
        n_rows = 0 if pts is None else pts.shape[1]
        if n_rows != getattr(plan, k.upper()):
            raise ValueError(f"group {k!r} has {n_rows} rows; the plan has "
                             f"{getattr(plan, k.upper())}")
    if (frames is not None) != plan.has_frames:
        raise ValueError(f"frames given: {frames is not None}; the plan "
                         f"has_frames: {plan.has_frames}")
    fr = None if frames is None else frames.permute(2, 3, 1, 0).contiguous()
    args = dict(
        qd=_bl(qd), pts_c=_cl(pts_c), b_n=_bl(b_n), mu=_bl(mu),
        active=_bl(active), frames=fr, w_c=_cl(w_c), b_lo=_bl(b_lo),
        b_hi=_bl(b_hi), act_lo=_bl(act_lo), act_hi=_bl(act_hi),
        pts_a=_cl(pts_a), b_a=_cl(b_a), w_a=_cl(w_a), pts_g=_cl(pts_g),
        b_g=_cl(b_g), g_act=_bl(g_act), w_g=_cl(w_g))
    if _on_cpu(S_bl, hinv_bl, *args.values()):
        qd_o, lam_o, imp_o = solve_bl(plan, S_bl, hinv_bl, **args)
    else:
        qd_o, lam_o, imp_o = solve_kernel(plan, S_bl, hinv_bl, **args)
    return qd_o.t(), lam_o.permute(2, 1, 0), imp_o.t()


def solve_kernel(plan: ContactPlan, S, Hinv, qd, pts_c, b_n, mu, active,
                 frames, w_c, b_lo, b_hi, act_lo, act_hi, pts_a=None,
                 b_a=None, w_a=None, pts_g=None, b_g=None, g_act=None,
                 w_g=None):
    """Launch B4 on batch-last CUDA tensors (the arguments of
    :func:`solve_bl`); counts the launch in ``solve.launches``."""
    N = qd.shape[-1]
    nv, P, A, G = plan.nv, plan.P, plan.A, plan.G
    shapes = {
        "S": (S, (nv, 6, N)), "Hinv": (Hinv, (nv, nv, N)), "qd": (qd, (nv, N)),
        "pts_c": (pts_c, (3, P, N)), "b_n": (b_n, (P, N)), "mu": (mu, (P, N)),
        "active": (active, (P, N)), "frames": (frames, (3, 3, P, N)),
        "w_c": (w_c, (3, P, N)), "b_lo": (b_lo, (nv, N)),
        "b_hi": (b_hi, (nv, N)), "act_lo": (act_lo, (nv, N)),
        "act_hi": (act_hi, (nv, N)), "pts_a": (pts_a, (3, A, N)),
        "b_a": (b_a, (3, A, N)), "w_a": (w_a, (3, A, N)),
        "pts_g": (pts_g, (3, G, N)), "b_g": (b_g, (3, G, N)),
        "g_act": (g_act, (G, N)), "w_g": (w_g, (3, G, N)),
    }
    for name, (t, shape) in shapes.items():
        if t is not None:
            _check_kernel_input(name, t, shape)
    kw = dict(dtype=torch.float32, device=qd.device)
    qd_out = torch.empty((nv, N), **kw)
    lam_out = torch.empty((3, P, N), **kw)
    imp_out = torch.empty((nv, N), **kw)
    _launch(plan, "contact_solve", qd.device,
            *(_ptr(t) for t, _ in shapes.values()),
            _ptr(qd_out), _ptr(lam_out), _ptr(imp_out), ctypes.c_int(N))
    solve.launches += 1
    return qd_out, lam_out, imp_out


solve.launches = 0
