"""Hyperparameter mutation for PBT (a copy of
isaacgymenvs_ma_tpu/pbt/mutation.py; reference pbt/mutation.py).

Same operator family: multiplicative float perturbation by a random factor in
[change_min, change_max] with random direction (:33-39), floors for >=1
params (:41-45), eps-clip and mini-epoch specials (:47-60), discount mutated
in (1 - gamma) space (:62-70); per-param coin toss at ``mutation_rate``
(:81-96).
"""
from __future__ import annotations

import random


def mutate_float(x, change_min=1.1, change_max=1.5):
    x = float(x)  # CLI overrides arrive as strings ("1e-7")
    perturb = random.uniform(change_min, change_max)
    if random.random() < 0.5:
        return x / perturb
    return x * perturb


def mutate_float_min_1(x, **kwargs):
    return max(1.0, mutate_float(x, **kwargs))


def mutate_eps_clip(x, **kwargs):
    return float(min(0.4, max(0.02, mutate_float(x, **kwargs))))


def mutate_mini_epochs(x, **kwargs):
    new = x + (1 if random.random() < 0.5 else -1)
    return int(min(12, max(1, new)))


def mutate_discount(x, **kwargs):
    """Mutate in (1 - gamma) space so changes are meaningful near 1."""
    inv = 1.0 - x
    new_inv = mutate_float(inv, change_min=1.1, change_max=1.2)
    return float(max(0.0, min(0.9999, 1.0 - new_inv)))


_MUTATION_FUNCS = {
    "mutate_float": mutate_float,
    "mutate_float_min_1": mutate_float_min_1,
    "mutate_eps_clip": mutate_eps_clip,
    "mutate_mini_epochs": mutate_mini_epochs,
    "mutate_discount": mutate_discount,
}

# default mutation spec (the reference's cfg/pbt/mutation/* files)
DEFAULT_MUTATIONS = {
    "learning_rate": "mutate_float",
    "entropy_coef": "mutate_float",
    "critic_coef": "mutate_float",
    "kl_threshold": "mutate_float",
    "gamma": "mutate_discount",
    "tau": "mutate_discount",
    "e_clip": "mutate_eps_clip",
    "mini_epochs": "mutate_mini_epochs",
    "reward_scale": "mutate_float",
}


def mutate(params: dict, mutations: dict, mutation_rate: float,
           change_min: float, change_max: float) -> dict:
    out = dict(params)
    for param, value in params.items():
        if random.random() > mutation_rate:
            continue
        func = _MUTATION_FUNCS[mutations.get(param, "mutate_float")]
        out[param] = func(value, change_min=change_min, change_max=change_max)
    return out
