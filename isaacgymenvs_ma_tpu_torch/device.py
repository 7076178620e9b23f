"""Device and precision policy of the port.

Everything runs in float32.  TF32 is off for matmuls and convolutions and
float32 matmul precision is "highest": the JAX engine documents that a
reduced-mantissa mass-matrix chain loses positive definiteness and Ant
training hits NaNs (isaacgymenvs_ma_tpu/physics/engine.py:42-48).
"""
from __future__ import annotations

import torch

DTYPE = torch.float32


def apply_precision_policy() -> None:
    """Full-fp32 matmuls on the card (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """``torch.device`` from a string/device; a CUDA device that is not
    present raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: use 'cpu' or 'cuda'")
    return dev
