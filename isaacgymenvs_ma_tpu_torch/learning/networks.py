"""Actor-critic networks (port of isaacgymenvs_ma_tpu/learning/networks.py,
the rl_games ``actor_critic`` continuous network).

A shared MLP trunk (``actor_mlp``) with mu and value heads and a learnable
state-independent ``log_sigma`` when ``fixed_sigma`` (else a ``sigma``
head), configured from the ``params.network`` schema; ``separate`` gives
the critic a trunk of its own (``critic_mlp``).  Everything is float32,
as in the JAX learner: the Ant config's ``mixed_precision`` is ignored and
no autocast is used.

Initialisation copies flax's, not torch's defaults: every kernel is
``lecun_normal`` (a normal of std sqrt(1/fan_in)/0.8796 cut at +-2 of its
std), ``mu``'s with variance scale 0.01; biases are 0 and ``log_sigma`` is
the constant ``sigma_init``.  ``CentralValueNet``, ``AsymActorCritic`` and
``ActorCriticLSTM`` are not ported (no ported task uses them).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

_ACT = {
    "elu": nn.functional.elu,
    "relu": nn.functional.relu,
    "tanh": torch.tanh,
    "selu": nn.functional.selu,
    "swish": nn.functional.silu,
    "sigmoid": torch.sigmoid,
    "None": lambda x: x,
    None: lambda x: x,
}
# std of a standard normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_dense(fan_in: int, fan_out: int, scale: float = 1.0,
                generator: Optional[torch.Generator] = None) -> nn.Linear:
    """``nn.Linear`` initialised as flax's ``Dense`` with
    ``variance_scaling(scale, "fan_in", "truncated_normal")`` and zero
    bias."""
    layer = nn.Linear(fan_in, fan_out)
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        layer.bias.zero_()
    return layer


def _mlp(in_dim: int, units: Sequence[int], generator) -> nn.ModuleList:
    layers, d = [], in_dim
    for u in units:
        layers.append(lecun_dense(d, u, generator=generator))
        d = u
    return nn.ModuleList(layers)


class ActorCritic(nn.Module):
    """Continuous-action actor-critic with optional separate critic trunk."""

    def __init__(self, num_obs: int, num_actions: int,
                 units: Sequence[int] = (256, 128, 64),
                 activation: str = "elu", separate: bool = False,
                 fixed_sigma: bool = True, sigma_init: float = 0.0,
                 value_size: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _ACT[activation]
        self.fixed_sigma = fixed_sigma
        d = units[-1] if units else num_obs
        self.actor_mlp = _mlp(num_obs, units, generator)
        self.mu = lecun_dense(d, num_actions, 0.01, generator)
        self.critic_mlp = _mlp(num_obs, units, generator) if separate else None
        self.value = lecun_dense(d, value_size, generator=generator)
        if fixed_sigma:
            self.log_sigma = nn.Parameter(
                torch.full((num_actions,), float(sigma_init)))
        else:
            self.sigma = lecun_dense(d, num_actions, generator=generator)

    def _trunk(self, layers, x):
        for layer in layers:
            x = self.act(layer(x))
        return x

    def forward(self, obs):
        """(mu, log_sigma, value): (B, A), (B, A), (B,)."""
        trunk = self._trunk(self.actor_mlp, obs)
        mu = self.mu(trunk)
        vtrunk = (trunk if self.critic_mlp is None
                  else self._trunk(self.critic_mlp, obs))
        value = self.value(vtrunk)
        if self.fixed_sigma:
            log_sigma = self.log_sigma.expand(mu.shape)
        else:
            log_sigma = self.sigma(trunk)
        return mu, log_sigma, value.squeeze(-1)


def build_network(net_cfg: dict, num_obs: int, num_actions: int,
                  generator: Optional[torch.Generator] = None) -> ActorCritic:
    """Construct from the rl_games ``params.network`` schema."""
    if net_cfg.get("rnn"):
        raise NotImplementedError(
            "network.rnn (ActorCriticLSTM) is not ported yet: ROADMAP "
            "queue A, item 7 (the hand tasks that train with it)")
    mlp = net_cfg.get("mlp", {})
    space = net_cfg.get("space", {}).get("continuous", {})
    sigma_init = space.get("sigma_init", {}).get("val", 0.0)
    return ActorCritic(
        num_obs, num_actions,
        units=tuple(mlp.get("units", (256, 128, 64))),
        activation=mlp.get("activation", "elu"),
        separate=bool(net_cfg.get("separate", False)),
        fixed_sigma=bool(space.get("fixed_sigma", True)),
        sigma_init=float(sigma_init), generator=generator)


def gaussian_neglogp(mu, log_sigma, actions):
    """Diagonal-gaussian negative log prob (rl_games distr semantics)."""
    var = torch.exp(2.0 * log_sigma)
    return 0.5 * torch.sum(
        torch.square(actions - mu) / var + 2.0 * log_sigma
        + math.log(2.0 * math.pi), dim=-1)


def gaussian_entropy(log_sigma):
    return torch.sum(log_sigma + 0.5 * math.log(2.0 * math.pi * math.e),
                     dim=-1)


def gaussian_kl(mu0, log_s0, mu1, log_s1):
    """KL(p0 || p1) for diagonal gaussians (rl_games dist kl)."""
    v0, v1 = torch.exp(2 * log_s0), torch.exp(2 * log_s1)
    return torch.sum(
        log_s1 - log_s0 + (v0 + torch.square(mu0 - mu1)) / (2.0 * v1) - 0.5,
        dim=-1)
