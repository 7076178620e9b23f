"""Batched SPD inverse: CUDA kernel B5 and its dispatching wrapper.

Port of the TPU kernel ``_spd_inverse_pallas`` of
isaacgymenvs_ma_tpu/physics/engine.py (a Gauss-Jordan sweep, no pivoting,
over batch-last lanes).  The CUDA kernel reads the batch-first ``(B, n, n)``
stack directly: a team of lanes per matrix, a lane per row, several
matrices per block staged through shared memory, with ``n`` and the launch
layout compiled in through a per-size header (:class:`SpdPlan`).  Its plain
twin is the one the B2 twin already uses, :func:`.dyn_kernel.sweep_inverse_bl`.

==============  ==========================  ===============================
wrapper         CUDA source (csrc/)         replaces (TPU Pallas kernel)
==============  ==========================  ===============================
sweep_inverse   spd_inverse.cu              engine.py:241 _spd_inverse_pallas
==============  ==========================  ===============================

``sweep_inverse`` runs the twin for CPU tensors and launches the kernel for
CUDA tensors (no fallback either way), and counts its launches in
``sweep_inverse.launches``.  Callers go through
:func:`.engine.spd_inverse`, which also keeps the JAX package's closed forms
for n = 1 and n = 2.
"""
from __future__ import annotations

import ctypes

import torch

from .dyn_kernel import (KernelLayout, _check_kernel_input, _launch, _on_cpu,
                         _ptr, sweep_inverse_bl)


class SpdPlan:
    """The static part of B5: the matrix size ``n`` and its launch layout,
    baked in as ``spd::N`` and the ``B5_*`` constants."""

    kernel_names = ("spd_inverse",)

    def __init__(self, n: int):
        self.n = int(n)
        self.libs = {}          # kernel name -> loaded ctypes library
        self.build_log = {}     # kernel name -> nvcc/ptxas report

    def layout(self) -> KernelLayout:
        """B5's layout: a team of the power of two >= n lanes (8 to 32, so
        a team never spans two warps) per matrix, as many matrices as a
        256-thread block holds, each in shared memory as it lies in H
        (n^2 floats, end to end), so that a warp copies its matrices 16
        bytes at a time."""
        n = self.n
        return KernelLayout(n, {}, n * n, pad=False)

    @property
    def rows(self) -> int:
        """Rows each lane holds in registers: ceil(n / team)."""
        return -(-self.n // self.layout().team)

    def lane_rows(self) -> list:
        """The matrix rows each lane of the team owns: row r goes to lane
        r % team."""
        team = self.layout().team
        return [list(range(lane, self.n, team)) for lane in range(team)]

    def header(self) -> str:
        return "\n".join([
            "// Generated by isaacgymenvs_ma_tpu_torch.physics.spd_kernel."
            "SpdPlan.header: do not edit.",
            "#pragma once",
            "namespace spd {",
            f"constexpr int N = {self.n};",
            f"constexpr int B5_ROWS = {self.rows};",
            *self.layout().header_lines("B5"),
            "}  // namespace spd", ""])


_PLANS = {}


def get_plan(n: int) -> SpdPlan:
    """The plan (and its built library) of one matrix size, made once."""
    plan = _PLANS.get(int(n))
    if plan is None:
        plan = _PLANS[int(n)] = SpdPlan(n)
    return plan


def sweep_inverse(H: torch.Tensor) -> torch.Tensor:
    """B5. H (B, n, n) SPD -> H^-1 (B, n, n).  CPU: the twin
    ``sweep_inverse_bl`` on the batch-last view; CUDA:
    ``csrc/spd_inverse.cu``."""
    if H.dim() != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"expected a (B, n, n) stack, got {tuple(H.shape)}")
    if _on_cpu(H):
        return sweep_inverse_bl(H.permute(1, 2, 0)).permute(2, 0, 1)
    B, n = H.shape[0], H.shape[-1]
    _check_kernel_input("H", H, (B, n, n))
    out = torch.empty_like(H)
    _launch(get_plan(n), "spd_inverse", H.device, _ptr(H), _ptr(out),
            ctypes.c_int(B))
    sweep_inverse.launches += 1
    return out


sweep_inverse.launches = 0
