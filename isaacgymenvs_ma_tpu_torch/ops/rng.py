"""Explicit-generator RNG (port of isaacgymenvs_ma_tpu/ops/rng.py).

The JAX package threads ``jax.random`` keys; the port passes explicit
``torch.Generator`` objects.  The two give different numbers for the same
seed, so parity tests inject the reference's draws.
"""
from __future__ import annotations

import math
import time

import torch


def make_seed(seed: int, rank: int = 0, deterministic: bool = False) -> int:
    """Resolve a seed the way the reference does (utils/utils.py:87-103).

    ``seed == -1`` picks a time-based random seed unless ``deterministic``,
    which pins 42.  The rank offset keeps per-host streams decorrelated.
    """
    if deterministic:
        seed = 42
    elif seed == -1:
        seed = int(time.time() * 1e6) % (2**31)
    return seed + rank


def make_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def rand_float(gen: torch.Generator, lower, upper, shape) -> torch.Tensor:
    """U[lower, upper) sample on the generator's device
    (ref torch_jit_utils.py:216-219)."""
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return u * (upper - lower) + lower


def random_dir_2(gen: torch.Generator, shape) -> torch.Tensor:
    """Random planar unit direction (ref torch_jit_utils.py:222-226)."""
    angle = rand_float(gen, -math.pi, math.pi, shape)
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)
