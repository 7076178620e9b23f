"""Batched SPD inverse: CUDA kernel B5 and its dispatching wrapper.

Port of the TPU kernel ``_spd_inverse_pallas`` of
isaacgymenvs_ma_tpu/physics/engine.py (a Gauss-Jordan sweep, no pivoting,
over batch-last lanes).  The CUDA kernel reads the batch-first ``(B, n, n)``
stack directly, one matrix per thread, with ``n`` compiled in through a
per-size header (:class:`SpdPlan`).  Its plain twin is the one the B2 twin
already uses, :func:`.dyn_kernel.sweep_inverse_bl`.

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

from .dyn_kernel import (_check_kernel_input, _launch, _on_cpu, _ptr,
                         sweep_inverse_bl)


class SpdPlan:
    """The static part of B5: the matrix size, baked in as ``spd::N``."""

    kernel_names = ("spd_inverse",)

    def __init__(self, n: int):
        self.n = int(n)
        self.libs = {}          # kernel name -> loaded ctypes library
        self.build_log = {}     # kernel name -> nvcc/ptxas report

    def header(self) -> str:
        return "\n".join([
            "// Generated by isaacgymenvs_ma_tpu_torch.physics.spd_kernel."
            "SpdPlan.header: do not edit.",
            "#pragma once",
            f"namespace spd {{ constexpr int N = {self.n}; }}", ""])


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
