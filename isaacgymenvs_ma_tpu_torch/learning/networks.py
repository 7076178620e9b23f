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
the constant ``sigma_init``.

The asymmetric networks (``CentralValueNet``, ``AsymActorCritic``: the
actor on the obs, the critic on the privileged states) and the recurrent
one (``ActorCriticLSTM``: MLP trunk, one LSTM cell, heads) follow the JAX
modules, not rl_games: the LSTM config's ``layer_norm`` and
``before_mlp`` are ignored, as the JAX network ignores them.  Its cell is
flax's ``OptimizedLSTMCell``, not ``torch.nn.LSTMCell``: gates in the
order i, f, g, o from a bias-free input kernel (``lstm.ih``,
lecun-normal) and a biased recurrent kernel (``lstm.hh``, each gate's
block orthogonal, zero bias); ``nn.LSTMCell`` would add a second
trainable bias that Adam moves.
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


class _Heads(nn.Module):
    """The mu head, and ``log_sigma`` (fixed) or the sigma head, of an
    ``in_dim`` feature."""

    def _init_heads(self, in_dim, num_actions, fixed_sigma, sigma_init,
                    generator):
        self.fixed_sigma = fixed_sigma
        self.mu = lecun_dense(in_dim, num_actions, 0.01, generator)
        if fixed_sigma:
            self.log_sigma = nn.Parameter(
                torch.full((num_actions,), float(sigma_init)))
        else:
            self.sigma = lecun_dense(in_dim, num_actions, generator=generator)

    def _mu_sigma(self, x):
        mu = self.mu(x)
        if self.fixed_sigma:
            return mu, self.log_sigma.expand(mu.shape)
        return mu, self.sigma(x)


class CentralValueNet(nn.Module):
    """Asymmetric critic on privileged states (rl_games
    central_value_config, cfg/train/ShadowHandPPOAsymm.yaml:73-88)."""

    def __init__(self, num_states: int, units: Sequence[int] = (256, 128),
                 activation: str = "elu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _ACT[activation]
        self.cv_mlp = _mlp(num_states, units, generator)
        self.value = lecun_dense(units[-1] if units else num_states, 1,
                                 generator=generator)

    def forward(self, states):
        x = states
        for layer in self.cv_mlp:
            x = self.act(layer(x))
        return self.value(x).squeeze(-1)


class AsymActorCritic(_Heads):
    """The actor on the obs and a central-value critic (``critic_mlp``)
    on the privileged states; ``forward(obs, states)``."""

    def __init__(self, num_obs: int, num_states: int, num_actions: int,
                 units: Sequence[int] = (256, 128, 64),
                 cv_units: Sequence[int] = (256, 128),
                 activation: str = "elu", fixed_sigma: bool = True,
                 sigma_init: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _ACT[activation]
        self.actor_mlp = _mlp(num_obs, units, generator)
        self._init_heads(units[-1] if units else num_obs, num_actions,
                         fixed_sigma, sigma_init, generator)
        self.critic_mlp = _mlp(num_states, cv_units, generator)
        self.value = lecun_dense(cv_units[-1] if cv_units else num_states, 1,
                                 generator=generator)

    def _trunk(self, layers, x):
        for layer in layers:
            x = self.act(layer(x))
        return x

    def forward(self, obs, states):
        """(mu, log_sigma, value): (B, A), (B, A), (B,)."""
        mu, log_sigma = self._mu_sigma(self._trunk(self.actor_mlp, obs))
        value = self.value(self._trunk(self.critic_mlp, states))
        return mu, log_sigma, value.squeeze(-1)


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: ``ih`` (in -> 4h, no bias,
    lecun-normal) and ``hh`` (h -> 4h, zero bias, each gate's (h, h)
    block orthogonal), gates i, f, g, o."""

    def __init__(self, in_dim: int, hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = hidden
        self.ih = nn.Linear(in_dim, 4 * hidden, bias=False)
        self.hh = nn.Linear(hidden, 4 * hidden)
        std = math.sqrt(1.0 / in_dim) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.ih.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
            for blk in self.hh.weight.view(4, hidden, hidden):
                nn.init.orthogonal_(blk, generator=generator)
            self.hh.bias.zero_()

    def forward(self, x, h, c):
        """(h', c') from the input ``x`` and the carry (h, c)."""
        i, f, g, o = (self.hh(h) + self.ih(x)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class ActorCriticLSTM(_Heads):
    """MLP trunk -> LSTM -> mu and value heads (rl_games ``rnn: {name:
    lstm}`` networks, trained with seq_len truncated BPTT); ``forward(obs,
    (h, c))`` returns (mu, log_sigma, value, (h', c'))."""

    def __init__(self, num_obs: int, num_actions: int,
                 units: Sequence[int] = (256, 128, 64), lstm_units: int = 256,
                 activation: str = "elu", fixed_sigma: bool = True,
                 sigma_init: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = _ACT[activation]
        self.lstm_units = lstm_units
        self.actor_mlp = _mlp(num_obs, units, generator)
        self.lstm = LSTMCell(units[-1] if units else num_obs, lstm_units,
                             generator)
        self._init_heads(lstm_units, num_actions, fixed_sigma, sigma_init,
                         generator)
        self.value = lecun_dense(lstm_units, 1, generator=generator)

    def forward(self, obs, carry):
        x = obs
        for layer in self.actor_mlp:
            x = self.act(layer(x))
        h, c = self.lstm(x, *carry)
        mu, log_sigma = self._mu_sigma(h)
        return mu, log_sigma, self.value(h).squeeze(-1), (h, c)

    def initial_carry(self, batch: int, device=None):
        z = torch.zeros((batch, self.lstm_units), device=device)
        return (z, z.clone())


def build_network(net_cfg: dict, num_obs: int, num_actions: int,
                  generator: Optional[torch.Generator] = None,
                  central_value_config: Optional[dict] = None,
                  num_states: int = 0) -> nn.Module:
    """Construct from the rl_games ``params.network`` schema as the JAX
    ``PPOAgent`` does (ppo.py:140-174): ``AsymActorCritic`` with a
    ``central_value_config`` and privileged states, else
    ``ActorCriticLSTM`` with ``network.rnn``, else ``ActorCritic``.  The
    first two take no ``sigma_init`` from the config, as in JAX."""
    mlp = net_cfg.get("mlp", {})
    space = net_cfg.get("space", {}).get("continuous", {})
    units = tuple(mlp.get("units", (256, 128, 64)))
    activation = mlp.get("activation", "elu")
    fixed_sigma = bool(space.get("fixed_sigma", True))
    if central_value_config and num_states > 0:
        cv_units = tuple(central_value_config.get("network", {})
                         .get("mlp", {}).get("units", [256, 128]))
        return AsymActorCritic(num_obs, num_states, num_actions, units,
                               cv_units, activation, fixed_sigma,
                               generator=generator)
    rnn = net_cfg.get("rnn")
    if rnn:
        return ActorCriticLSTM(num_obs, num_actions, units,
                               int(rnn.get("units", 256)), activation,
                               fixed_sigma, generator=generator)
    sigma_init = space.get("sigma_init", {}).get("val", 0.0)
    return ActorCritic(
        num_obs, num_actions, units=units, activation=activation,
        separate=bool(net_cfg.get("separate", False)),
        fixed_sigma=fixed_sigma, sigma_init=float(sigma_init),
        generator=generator)


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
