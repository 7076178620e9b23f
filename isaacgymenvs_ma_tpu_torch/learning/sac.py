"""SAC learner (port of isaacgymenvs_ma_tpu/learning/sac.py, the rl_games
SAC that the reference trains cfg/train/AntSAC.yaml with).

Soft actor-critic with the rl_games config surface: a tanh-squashed
gaussian actor, twin Q critics with Polyak-averaged targets
(``critic_tau``), an automatic entropy temperature toward ``-num_actions``,
a ring replay on the device (``min(replay_buffer_size, 500000)`` rows) and
``num_seed_steps`` warm-up steps of uniform actions.  One ``train_epoch``
is ``num_steps_per_episode`` env steps, each followed by one gradient
update once the step count has passed ``num_seed_steps``: the critic, then
the actor against the updated critic, then the temperature, then the
targets.  As in JAX, the three Adams share the ``actor_lr`` (the config's
``critic_lr`` and ``alpha_lr`` are ignored), and a stored transition's
``done`` drops time-outs.

The JAX epoch is one ``lax.scan`` with a ``lax.cond`` on the step count;
here the step count and the replay fill are host integers, so the branch
and the ring indices cost no wait for the card.  Networks are float32 and
initialised as flax's (lecun-normal kernels, zero biases) from a CPU
generator seeded with ``seed``.

The replay indices and the update's two N(0, 1) draws come from
``shared_generator`` (seeded by ``parallel.mesh.shared_seed``), the
per-env draws (seed-step uniforms, action noise) from ``generator``.

Data parallelism (``dist``, a :class:`..parallel.mesh.DataParallel`), one
program sharded over the envs as in JAX: each env step the ranks' ``(last
obs, action, reward, next obs, done)`` rows are combined into the global
rows in rank (= global env) order on every rank (``dist.rows``), so the
ring, ``obs_rms`` (the global next obs), ``mean_return`` (the finished
episodes' global sum and count), ``buf_n`` and the step count are
replicated and equal to one process's.  The update draws the global
batch's indices and noise alike on every rank, rank ``r`` takes rows
``[r B/W, (r+1) B/W)`` of it, and the critic's, actor's and temperature's
gradients are each averaged over the ranks before their Adam step, so
Polyak runs on equal parameters.  ``batch_size`` is global; ``W`` must
divide it.

Test hooks: ``train_epoch(draws=[{"act": ..., "reset": ..., "idx": ...,
"eps_next": ..., "eps_actor": ...}, ...])``, one dict a step: the action
draw (the uniform (B, A) in [-1, 1) in a seed step, the N(0, 1) action
noise after) and the task's reset draws, both this rank's, and the
update's global replay indices and the two global N(0, 1) draws (next
actions, actor actions).
"""
from __future__ import annotations

import copy
import math
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..device import DTYPE, apply_precision_policy
from ..ops.rng import make_generator, rand_float
from ..parallel.mesh import check_batch, module_state, shared_seed
from .networks import _mlp, lecun_dense
from .ppo import env_state_arrays, env_state_from_arrays
from .running_norm import RunningMeanStd


def _trunk(layers, x):
    for layer in layers:
        x = F.relu(layer(x))
    return x


class TanhGaussianActor(nn.Module):
    """ReLU MLP, then mu and a log-std squashed into ``log_std_bounds``."""

    def __init__(self, num_obs: int, num_actions: int,
                 units: Sequence[int] = (256, 128, 64),
                 log_std_bounds=(-5.0, 2.0),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = units[-1] if units else num_obs
        self.actor_mlp = _mlp(num_obs, units, generator)
        self.mu = lecun_dense(d, num_actions, generator=generator)
        self.log_std = lecun_dense(d, num_actions, generator=generator)
        self.log_std_bounds = tuple(log_std_bounds)

    def forward(self, obs):
        x = _trunk(self.actor_mlp, obs)
        lo, hi = self.log_std_bounds
        log_std = lo + 0.5 * (hi - lo) * (torch.tanh(self.log_std(x)) + 1.0)
        return self.mu(x), log_std


class TwinQ(nn.Module):
    """Two ReLU MLP critics of (obs, action)."""

    def __init__(self, num_obs: int, num_actions: int,
                 units: Sequence[int] = (256, 128, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d_in = num_obs + num_actions
        d = units[-1] if units else d_in
        self.q1 = _mlp(d_in, units, generator)
        self.q1_out = lecun_dense(d, 1, generator=generator)
        self.q2 = _mlp(d_in, units, generator)
        self.q2_out = lecun_dense(d, 1, generator=generator)

    def forward(self, obs, act):
        x = torch.cat([obs, act], -1)
        return (self.q1_out(_trunk(self.q1, x)).squeeze(-1),
                self.q2_out(_trunk(self.q2, x)).squeeze(-1))


def _sample_action(mu, log_std, eps):
    """(tanh(mu + std eps), its log-probability with the tanh
    correction)."""
    pre_tanh = mu + torch.exp(log_std) * eps
    act = torch.tanh(pre_tanh)
    logp = (-0.5 * torch.square(eps) - log_std
            - 0.5 * math.log(2.0 * math.pi)).sum(-1)
    logp = logp - torch.log(torch.clamp(1.0 - torch.square(act),
                                        min=1e-6)).sum(-1)
    return act, logp


class SACConfig(NamedTuple):
    """What the train entry point reads of a learner's config."""

    max_epochs: int = 20000
    save_frequency: int = 1000
    score_to_win: float = float("inf")


class SACAgent:
    def __init__(self, task, train_cfg: dict, seed: int = 42, dist=None):
        params = train_cfg["params"]
        if params["algo"]["name"] != "sac":
            raise ValueError(f"SACAgent does not run algo "
                             f"{params['algo']['name']!r}")
        self.task = task
        self.train_cfg = train_cfg
        self.device = task.device
        c = params["config"]
        self.gamma = float(c.get("gamma", 0.99))
        self.tau = float(c.get("critic_tau", 0.005))
        self.batch_size = int(c.get("batch_size", 4096))
        self.replay_size = min(int(c.get("replay_buffer_size", 1_000_000)),
                               500_000)
        self.init_alpha = float(c.get("init_alpha", 1.0))
        self.lr = float(c.get("actor_lr", c.get("learning_rate", 3e-4)))
        self.num_seed_steps = int(c.get("num_seed_steps", 5))
        self.steps_per_epoch = int(c.get("num_steps_per_episode", 8))
        self.normalize_input = bool(c.get("normalize_input", True))
        self.target_entropy = -float(task.num_actions)
        self.units = tuple(params["network"].get("mlp", {}).get(
            "units", [256, 128, 64]))
        self.cfg = SACConfig(
            max_epochs=int(c.get("max_epochs", 20000)),
            save_frequency=int(c.get("save_frequency", 1000)),
            score_to_win=float(c.get("score_to_win", 1e18)))
        self.batch = task.rl_games_batch
        # data parallelism: the update's batch is global, each rank takes
        # 1 / W of it; the ring holds every rank's rows
        self.dist = dist
        self.world = 1 if dist is None else dist.world
        if self.world > 1:
            check_batch("batch_size", self.batch_size, self.world)
        self.local_batch = self.batch_size // self.world
        self.seed = seed
        self.actor = None

    # ------------------------------------------------------------------
    def init(self) -> None:
        """Fresh networks (flax's initialisation from ``seed``, the target
        a copy of the critic), optimisers, normaliser, replay and env
        state."""
        apply_precision_policy()
        task, dev = self.task, self.device
        no, na = task.num_obs, task.num_actions
        g = torch.Generator().manual_seed(self.seed)
        self.actor = TanhGaussianActor(no, na, self.units,
                                       generator=g).to(dev)
        self.critic = TwinQ(no, na, self.units, generator=g).to(dev)
        self.target = copy.deepcopy(self.critic).requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.tensor(
            np.log(self.init_alpha), dtype=DTYPE, device=dev))
        cap = dev.type == "cuda"
        self.actor_optim = torch.optim.Adam(self.actor.parameters(),
                                            lr=self.lr, capturable=cap)
        self.critic_optim = torch.optim.Adam(self.critic.parameters(),
                                             lr=self.lr, capturable=cap)
        self.alpha_optim = torch.optim.Adam([self.log_alpha], lr=self.lr,
                                            capturable=cap)
        if self.dist is not None:
            self.dist.broadcast_tensors(
                list(self.actor.parameters())
                + list(self.critic.parameters())
                + list(self.target.parameters()) + [self.log_alpha])
        self.generator = make_generator(self.seed, dev)
        self.shared_generator = make_generator(
            shared_seed(self.seed, self.dist), dev)
        self.obs_rms = RunningMeanStd((no,), dev)
        self.env_state, self.last_obs = task.reset(task.initial_state())
        R, f32 = self.replay_size, dict(dtype=DTYPE, device=dev)
        self.buffer = {"obs": torch.zeros((R, no), **f32),
                       "act": torch.zeros((R, na), **f32),
                       "rew": torch.zeros((R,), **f32),
                       "next_obs": torch.zeros((R, no), **f32),
                       "done": torch.zeros((R,), **f32)}
        self.buf_n = 0
        self.step = 0
        self.epoch = 0
        self.mean_return = torch.zeros((), **f32)
        self.ep_return = torch.zeros(self.batch, **f32)

    # ------------------------------------------------------------------
    def _norm(self, obs):
        return self.obs_rms.normalize(obs) if self.normalize_input else obs

    @torch.no_grad()
    def _env_step(self, act_draw=None, reset_draws=None) -> None:
        """One env step: uniform actions in the seed steps, else the
        actor's sample; the transition into the ring, the obs into
        ``obs_rms``."""
        shape = (self.batch, self.task.num_actions)
        if self.step < self.num_seed_steps:
            act = (act_draw if act_draw is not None
                   else rand_float(self.generator, -1.0, 1.0, shape))
        else:
            mu, log_std = self.actor(self._norm(self.last_obs))
            eps = (act_draw if act_draw is not None else torch.randn(
                shape, generator=self.generator, device=self.device))
            act, _ = _sample_action(mu, log_std, eps)
        env_state, res = self.task.step(self.env_state, act,
                                        reset_draws=reset_draws)
        done = (res.reset > 0).to(DTYPE)
        ep_ret = self.ep_return + res.rew
        stored_done = done * (1.0 - res.extras["time_outs"].to(DTYPE))
        no, na = self.task.num_obs, self.task.num_actions
        rows = torch.cat([self.last_obs, act, res.rew[:, None], res.obs,
                          stored_done[:, None], done[:, None],
                          ep_ret[:, None]], -1)
        self.ep_return = torch.where(done > 0, 0.0, ep_ret)
        self.env_state, self.last_obs = env_state, res.obs
        if self.dist is not None:
            # every rank's rows, in global env order
            rows = self.dist.rows(rows)
        obs, act, rew, next_obs, stored_done, done, ep_ret = torch.split(
            rows, [no, na, 1, no, 1, 1, 1], -1)
        rew, stored_done, done, ep_ret = (
            x.squeeze(-1) for x in (rew, stored_done, done, ep_ret))
        finished = done > 0
        self.mean_return = torch.where(
            finished.any(),
            torch.where(finished, ep_ret, 0.0).sum()
            / torch.clamp(done.sum(), min=1.0),
            self.mean_return)
        # ring store
        n = rows.shape[0]
        idx = (self.buf_n + torch.arange(n, device=self.device)
               ) % self.replay_size
        buf = self.buffer
        buf["obs"][idx] = obs
        buf["act"][idx] = act
        buf["rew"][idx] = rew
        buf["next_obs"][idx] = next_obs
        buf["done"][idx] = stored_done
        if self.normalize_input:
            self.obs_rms.update(next_obs)
        self.buf_n += n
        self.step += 1

    def _update(self, idx=None, eps_next=None, eps_actor=None
                ) -> Dict[str, torch.Tensor]:
        """One gradient update on a replay batch: the global batch's
        indices and noise (drawn from ``shared_generator`` unless given),
        this rank's rows of it."""
        dev, B = self.device, self.batch_size
        g = self.shared_generator
        shape = (B, self.task.num_actions)
        if idx is None:
            have = min(max(self.buf_n, 1), self.replay_size)
            idx = torch.randint(0, have, (B,), generator=g, device=dev)
        if eps_next is None:
            eps_next = torch.randn(shape, generator=g, device=dev)
        if eps_actor is None:
            eps_actor = torch.randn(shape, generator=g, device=dev)
        if self.dist is not None:
            lo = self.dist.rank * self.local_batch
            idx, eps_next, eps_actor = (
                x[lo: lo + self.local_batch]
                for x in (idx, eps_next, eps_actor))
        b = {k: v[idx.long()] for k, v in self.buffer.items()}
        o, no_ = self._norm(b["obs"]), self._norm(b["next_obs"])
        alpha = torch.exp(self.log_alpha.detach())

        with torch.no_grad():
            next_act, next_logp = _sample_action(*self.actor(no_), eps_next)
            tq1, tq2 = self.target(no_, next_act)
            target_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target_q = b["rew"] + self.gamma * (1.0 - b["done"]) * target_v

        self.critic_optim.zero_grad(set_to_none=True)
        q1, q2 = self.critic(o, b["act"])
        closs = (torch.square(q1 - target_q).mean()
                 + torch.square(q2 - target_q).mean())
        closs.backward()
        self._reduce_grads(self.critic.parameters())
        self.critic_optim.step()

        # the actor against the updated critic
        self.critic.requires_grad_(False)
        self.actor_optim.zero_grad(set_to_none=True)
        act, logp = _sample_action(*self.actor(o), eps_actor)
        q1, q2 = self.critic(o, act)
        aloss = (alpha * logp - torch.minimum(q1, q2)).mean()
        aloss.backward()
        self._reduce_grads(self.actor.parameters())
        self.actor_optim.step()
        self.critic.requires_grad_(True)

        self.alpha_optim.zero_grad(set_to_none=True)
        alloss = (torch.exp(self.log_alpha)
                  * (-logp.detach() - self.target_entropy)).mean()
        alloss.backward()
        self._reduce_grads([self.log_alpha])
        self.alpha_optim.step()

        with torch.no_grad():
            tp = list(self.target.parameters())
            torch._foreach_mul_(tp, 1.0 - self.tau)
            torch._foreach_add_(tp, torch._foreach_mul(
                list(self.critic.parameters()), self.tau))
        return {"critic_loss": closs.detach(), "actor_loss": aloss.detach(),
                "alpha": torch.exp(self.log_alpha.detach())}

    def _reduce_grads(self, params) -> None:
        """The global batch's gradient: the ranks' averaged."""
        if self.dist is not None:
            self.dist.allreduce_grads(list(params))

    def train_epoch(self, draws=None) -> Dict[str, object]:
        """``num_steps_per_episode`` env steps, each followed by an update
        once ``num_seed_steps`` have passed; the last step's losses."""
        if self.dist is not None:
            self.dist.mark_epoch()
        m = None
        for i in range(self.steps_per_epoch):
            d = draws[i] if draws is not None else {}
            self._env_step(d.get("act"), d.get("reset"))
            if self.step > self.num_seed_steps:
                m = self._update(d.get("idx"), d.get("eps_next"),
                                 d.get("eps_actor"))
            else:
                zero = torch.zeros((), dtype=DTYPE, device=self.device)
                m = {"critic_loss": zero, "actor_loss": zero.clone(),
                     "alpha": torch.exp(self.log_alpha.detach())}
        if self.dist is not None:
            # the losses of the global batch: the mean of the ranks' halves
            m["critic_loss"], m["actor_loss"] = self.dist.mean(
                torch.stack([m["critic_loss"], m["actor_loss"]]))
        self.epoch += 1
        m["mean_return"] = self.mean_return
        m["frames"] = self.step * self.batch * self.world
        return m

    # ------------------------------------------------------------------
    @torch.no_grad()
    def act(self, obs, deterministic: bool = True):
        """Player path: tanh(mu), or a sample."""
        mu, log_std = self.actor(self._norm(obs))
        if deterministic:
            return torch.tanh(mu)
        return _sample_action(mu, log_std, torch.randn(
            mu.shape, generator=self.generator, device=self.device))[0]

    def replicated_state(self):
        """(name, tensor) of what every rank holds alike: the networks,
        the temperature, the three Adams, ``obs_rms`` and the ring's
        filled rows (``mesh.state_digest``)."""
        yield from module_state("actor.", self.actor, self.actor_optim)
        yield from module_state("critic.", self.critic, self.critic_optim)
        yield from module_state("target.", self.target)
        yield "log_alpha", self.log_alpha
        for k, v in sorted(self.alpha_optim.state.get(self.log_alpha,
                                                      {}).items()):
            yield f"log_alpha.{k}", v
        for k, v in self.obs_rms.state_dict().items():
            yield f"obs_rms.{k}", v
        fill = min(self.buf_n, self.replay_size)
        for k, v in self.buffer.items():
            yield f"buffer.{k}", v[:fill]

    def state_dict(self) -> dict:
        """Everything a resumed run needs: networks, optimisers, the
        temperature, ``obs_rms``, the filled part of the replay, counters,
        generators and the env state."""
        fill = min(self.buf_n, self.replay_size)
        optim = lambda o, net: {  # noqa: E731
            name: dict(o.state[p]) for name, p in net.named_parameters()
            if p in o.state}
        return {
            "actor": self.actor.state_dict(),
            "critic": self.critic.state_dict(),
            "target": self.target.state_dict(),
            "log_alpha": self.log_alpha.detach(),
            "actor_optim": optim(self.actor_optim, self.actor),
            "critic_optim": optim(self.critic_optim, self.critic),
            "alpha_optim": dict(self.alpha_optim.state[self.log_alpha])
            if self.log_alpha in self.alpha_optim.state else {},
            "obs_rms": self.obs_rms.state_dict(),
            "buffer": {k: v[:fill] for k, v in self.buffer.items()},
            "buf_n": self.buf_n, "step": self.step, "epoch": self.epoch,
            "mean_return": self.mean_return, "ep_return": self.ep_return,
            "generator": self.generator.get_state(),
            "shared_generator": self.shared_generator.get_state(),
            "task_generator": self.task.generator.get_state(),
            "env_state": env_state_arrays(self.env_state),
            "last_obs": self.last_obs,
        }

    def load_state_dict(self, d: dict) -> None:
        """Load what ``d`` holds of ``state_dict()``'s keys (a checkpoint,
        or ``convert.sac_state_from_jax``'s); ``init()`` first."""
        dev = self.device

        def on(x):
            return (x.detach().clone() if torch.is_tensor(x)
                    else torch.tensor(np.asarray(x))).to(dev)

        def adam(opt, params, states):
            cap = opt.param_groups[0]["capturable"]
            for name, p in params:
                s = states.get(name)
                if s is None:
                    continue
                step = torch.as_tensor(s["step"], dtype=torch.float32)
                opt.state[p] = {"step": step.to(dev if cap else "cpu").clone(),
                                "exp_avg": on(s["exp_avg"]).to(DTYPE),
                                "exp_avg_sq": on(s["exp_avg_sq"]).to(DTYPE)}
        for k in ("actor", "critic", "target"):
            if k in d:
                getattr(self, k).load_state_dict(d[k])
        if "log_alpha" in d:
            with torch.no_grad():
                self.log_alpha.copy_(on(d["log_alpha"]))
        for k, net in (("actor_optim", self.actor),
                       ("critic_optim", self.critic)):
            if k in d:
                adam(getattr(self, k), net.named_parameters(), d[k])
        if d.get("alpha_optim"):
            adam(self.alpha_optim, [("log_alpha", self.log_alpha)],
                 {"log_alpha": d["alpha_optim"]})
        if "obs_rms" in d:
            self.obs_rms.load_state_dict(d["obs_rms"])
        if "buffer" in d:
            for k, v in d["buffer"].items():
                v = on(v).to(DTYPE)
                self.buffer[k][: v.shape[0]] = v
        for k in ("buf_n", "step", "epoch"):
            if k in d:
                setattr(self, k, int(d[k]))
        for k in ("mean_return", "ep_return", "last_obs"):
            if k in d:
                setattr(self, k, on(d[k]).to(DTYPE))
        if "generator" in d:
            self.generator.set_state(d["generator"].cpu())
        if "shared_generator" in d:
            self.shared_generator.set_state(d["shared_generator"].cpu())
        if "task_generator" in d:
            self.task.generator.set_state(d["task_generator"].cpu())
        if "env_state" in d:
            self.env_state = env_state_from_arrays(d["env_state"],
                                                   self.env_state, on)
