"""Random Network Adversary (port of isaacgymenvs_ma_tpu/utils/rna_util.py;
reference utils/rna_util.py:37-163).

Dextreme's action perturbation: a fixed random MLP whose hidden layers are
gated by dropout masks, with softmax-binned outputs in [-1, 1].  The
weights are drawn once and never trained; the masks live in the task state
and are redrawn on demand (:meth:`RandomNetworkAdversary.refresh`).  Plain
matrix products, which the JAX package computes outside any Pallas kernel
too (flax ``Dense``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..device import DTYPE


class RandomNetworkAdversary(torch.nn.Module):
    """``fc0``, ``fc1``: Linear + ReLU, each times its mask; ``out``: Linear
    to ``num_actions * num_bins``; a softmax over the bins weighted by
    ``linspace(-1, 1, num_bins)``.  The weights come from
    :meth:`init_weights` and a generator, or from a state dict
    (``convert.rna_state_dict_from_jax`` carries the JAX network's)."""

    def __init__(self, num_obs: int, num_actions: int, num_bins: int = 32,
                 units: Sequence[int] = (512, 512), dropout_p: float = 0.5,
                 device="cpu"):
        super().__init__()
        self.num_actions, self.num_bins = num_actions, num_bins
        self.units = tuple(units)
        self.dropout_p = dropout_p
        dims = (num_obs,) + self.units
        self.fc = torch.nn.ModuleList(
            torch.nn.Linear(a, b, device=device)
            for a, b in zip(dims[:-1], dims[1:]))
        self.out = torch.nn.Linear(dims[-1], num_actions * num_bins,
                                   device=device)
        self.register_buffer("bins", torch.linspace(
            -1.0, 1.0, num_bins, dtype=DTYPE, device=device),
            persistent=False)
        for p in self.parameters():
            p.requires_grad_(False)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator):
        """Draw the weights from ``gen`` as flax ``Dense`` initialises
        them: kernels LeCun-normal (a normal truncated to +-2 std, std
        sqrt(1 / fan_in) / 0.8796), biases zero."""
        for layer in (*self.fc, self.out):
            std = (1.0 / layer.in_features) ** 0.5 / 0.87962566103423978
            w = torch.empty_like(layer.weight)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            layer.weight.copy_(w * std)
            layer.bias.zero_()

    def draw(self, gen: torch.Generator):
        """The uniforms :meth:`refresh` takes, one (units,) per layer."""
        return tuple(torch.rand((u,), generator=gen, device=gen.device,
                                dtype=DTYPE) for u in self.units)

    def refresh(self, gen: Optional[torch.Generator] = None, u=None):
        """New dropout masks: 1 / (1 - p) where the uniform exceeds p,
        else 0 (``u`` the uniforms, else drawn from ``gen``)."""
        if u is None:
            u = self.draw(gen)
        return tuple((x > self.dropout_p).to(DTYPE) / (1.0 - self.dropout_p)
                     for x in u)

    def forward(self, obs: torch.Tensor, masks) -> torch.Tensor:
        x = obs
        for layer, m in zip(self.fc, masks):
            x = torch.relu(layer(x)) * m
        logits = self.out(x).reshape(obs.shape[0], self.num_actions,
                                     self.num_bins)
        return torch.sum(F.softmax(logits, dim=-1) * self.bins, dim=-1)
