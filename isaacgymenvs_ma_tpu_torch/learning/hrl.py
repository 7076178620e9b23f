"""Hierarchical RL layer (port of isaacgymenvs_ma_tpu/learning/hrl.py,
reference learning/hrl_continuous.py:56-159 and hrl_models.py): a
high-level policy emits latent actions; each env step runs ``llc_steps``
steps of a frozen low-level latent-conditioned controller (the ASE-style
AMP policy), averaging the rewards over the sub-steps (ref env_step
:74-98).

The wrapper is itself a task: ``step(state, latents)`` loops over the
``llc_steps`` inner task steps, so the port's ``PPOAgent`` trains on it
unchanged, with ``num_actions`` the latent size (ref _setup_action_space
:111-114).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..device import DTYPE
from ..tasks.base import StepResult
from .networks import _mlp, lecun_dense


class LatentConditionedActor(nn.Module):
    """Low-level controller net: (obs, latent) -> action mean in [-1, 1]
    (hrl_models.ModelHRLContinuous's LLC head): a ReLU MLP on the
    concatenation, a ``mu`` layer, tanh."""

    def __init__(self, num_obs: int, latent_dim: int, num_actions: int,
                 units: Sequence[int] = (1024, 512),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d_in = num_obs + latent_dim
        self.llc_mlp = _mlp(d_in, units, generator)
        self.mu = lecun_dense(units[-1] if units else d_in, num_actions,
                              generator=generator)

    def forward(self, obs, latent):
        x = torch.cat([obs, latent], -1)
        for layer in self.llc_mlp:
            x = F.relu(layer(x))
        return torch.tanh(self.mu(x))


class HRLEnvState(NamedTuple):
    inner: Any                 # the wrapped task's EnvState
    last_obs: torch.Tensor     # (B, num_obs): the LLC's conditioning input


class HRLTaskWrapper:
    """A latent-action task over a wrapped task and a frozen LLC."""

    dict_obs_cls = False

    def __init__(self, task, llc, latent_dim: int, llc_steps: int = 5,
                 extract_llc_obs=None):
        """``llc(llc_obs, latent) -> actions in [-1, 1]`` (a
        :class:`LatentConditionedActor`); ``extract_llc_obs``: the slice of
        the obs the LLC reads (ref _extract_llc_obs :156-158; default the
        whole obs)."""
        self.task = task
        self.llc = llc
        self.latent_dim = int(latent_dim)
        self.llc_steps = int(llc_steps)
        self.extract_llc_obs = extract_llc_obs or (lambda o: o)
        # the task surface the learner reads
        self.device = task.device
        self.generator = task.generator
        self.num_envs = task.num_envs
        self.num_obs = task.num_obs
        self.num_states = task.num_states
        self.num_agents = task.num_agents
        self.num_actions = self.latent_dim
        self.rl_games_batch = task.rl_games_batch
        self.max_episode_length = task.max_episode_length
        self.randomizer = None

    def initial_state(self) -> HRLEnvState:
        return HRLEnvState(inner=self.task.initial_state(),
                           last_obs=torch.zeros(
                               (self.rl_games_batch, self.num_obs),
                               dtype=DTYPE, device=self.device))

    def reset(self, state: HRLEnvState):
        inner, obs = self.task.reset(state.inner)
        return HRLEnvState(inner=inner, last_obs=obs), obs

    def zero_actions(self):
        return torch.zeros((self.rl_games_batch, self.latent_dim),
                           dtype=DTYPE, device=self.device)

    def get_env_info(self) -> dict:
        info = dict(self.task.get_env_info())
        info["action_space"] = (self.latent_dim,)
        return info

    def get_env_state(self, state: HRLEnvState):
        return self.task.get_env_state(state.inner)

    def set_env_state(self, state: HRLEnvState, env_state):
        return state._replace(inner=self.task.set_env_state(state.inner,
                                                            env_state))

    def set_train_info(self, state: HRLEnvState, frames):
        return state._replace(inner=self.task.set_train_info(state.inner,
                                                             frames))

    @torch.no_grad()
    def step(self, state: HRLEnvState, latents, reset_draws=None):
        """ref env_step :74-98: ``llc_steps`` inner steps, the rewards
        averaged, the dones OR-ed, the last sub-step's obs and extras.
        ``reset_draws[i]`` are the task's reset draws of inner step i."""
        inner, obs = state.inner, state.last_obs
        rew = torch.zeros(self.rl_games_batch, dtype=DTYPE,
                          device=self.device)
        done = torch.zeros(self.rl_games_batch, dtype=torch.int32,
                           device=self.device)
        for i in range(self.llc_steps):
            actions = self.llc(self.extract_llc_obs(obs), latents)
            inner, res = self.task.step(
                inner, actions,
                reset_draws=None if reset_draws is None else reset_draws[i])
            rew = rew + res.rew
            done = torch.maximum(done, res.reset)
            obs = res.obs
        return HRLEnvState(inner=inner, last_obs=obs), StepResult(
            obs=obs, states=res.states, rew=rew / self.llc_steps,
            reset=done, extras=res.extras)


def build_llc_from_checkpoint(task, llc_config: dict,
                              checkpoint_path: Optional[str] = None,
                              seed: int = 0):
    """The frozen LLC (ref _build_llc :116-128): the network from the LLC
    config (``latent_dim`` 64, ``units`` [1024, 512] by default), its
    weights from ``checkpoint_path`` (a checkpoint of ``checkpoint.py``
    whose state is a ``LatentConditionedActor``'s ``state_dict``) when
    given, else fresh from ``seed``.  Returns (llc on the task's device,
    with no gradient, latent_dim)."""
    latent_dim = int(llc_config.get("latent_dim", 64))
    units = tuple(llc_config.get("units", [1024, 512]))
    g = torch.Generator().manual_seed(seed)
    net = LatentConditionedActor(task.num_obs, latent_dim, task.num_actions,
                                 units, generator=g)
    if checkpoint_path:
        from .checkpoint import load_checkpoint
        net.load_state_dict(load_checkpoint(checkpoint_path)[0])
    return net.to(task.device).requires_grad_(False), latent_dim
