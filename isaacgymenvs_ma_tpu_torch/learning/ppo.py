"""PPO learner (port of isaacgymenvs_ma_tpu/learning/ppo.py, the rl_games
``a2c_continuous`` / ``a2c_continuous_MA`` equivalent).

The JAX package jits the whole epoch into one function; here the agent is
a mutable object that owns its network, optimiser, normalisers, device,
``torch.Generator`` and the env state it rolls out from, and an epoch is a
Python loop over the horizon (``_rollout``), a reverse loop for GAE
(``_gae``) and a loop over minibatches (``_update``).  The method names
are the JAX ones so each counterpart is easy to find.  Semantics kept
exactly:

* diagonal-gaussian actor (``actions = mu + sigma * N(0, 1)``), fixed
  learnable log-sigma, shared-trunk MLP (``params.network`` schema);
* running mean/std obs and value normalization: the training obs are
  normalized with the rollout's (old) ``obs_rms``, which is updated after;
  ``value_rms`` is updated with the returns first, and returns and old
  values are normalized with the new stats;
* GAE(lambda) with the ``value_bootstrap`` time-out trick (reward +=
  gamma * V(s) * time_outs);
* clipped surrogate, clipped value loss, entropy, mu bounds loss at +-1.1;
* optimiser: ``clip_by_global_norm(grad_norm)`` when ``truncate_grads``,
  then Adam (eps 1e-8, no weight decay), with the adaptive-KL learning
  rate changed after every minibatch (/1.5 above 2*kl_threshold, floor
  1e-6; *1.5 below kl_threshold/2, cap 1e-2);
* multi-agent batch folding: the task emits ``B = num_envs * num_agents``
  agent-minor rows and the episode stats stride by ``num_agents``
  (``A2CAgent_MA.py:44-47``).

Within an epoch nothing waits for the host: ``lr``, the episode counters
and the KL tests are device tensors (``torch.where``), Adam is
``capturable`` on the card, and the host reads numbers only when it logs.
Everything is float32 with TF32 off (``device.apply_precision_policy``);
the config's ``mixed_precision`` is ignored, as the JAX learner ignores it,
and no autocast is used.  ``central_value_config`` and ``network.rnn``
raise (ROADMAP queue A, item 7).

Test hooks: ``_rollout`` takes the action noise ``(T, B, A)`` and each
step's ``reset_draws`` (handed to ``task.step``), ``_update`` the
permutations ``(mini_epochs, T * B)``; they default to draws from the
agent's and the task's generators.
"""
from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional

import torch

from ..device import DTYPE, apply_precision_policy
from ..ops.rng import make_generator
from ..physics.engine import SimState
from ..tasks.base import EnvState
from .networks import (build_network, gaussian_entropy, gaussian_kl,
                       gaussian_neglogp)
from .running_norm import RunningMeanStd

# rl_games algos this learner runs: the MA one is the same PPO core
PPO_ALGOS = ("a2c_continuous", "a2c_continuous_MA")


class PPOConfig(NamedTuple):
    horizon_length: int = 16
    minibatch_size: int = 8192
    mini_epochs: int = 4
    gamma: float = 0.99
    tau: float = 0.95
    learning_rate: float = 3e-4
    kl_threshold: float = 0.008
    e_clip: float = 0.2
    clip_value: bool = True
    critic_coef: float = 2.0
    entropy_coef: float = 0.0
    bounds_loss_coef: float = 0.0001
    grad_norm: float = 1.0
    truncate_grads: bool = True
    normalize_input: bool = True
    normalize_value: bool = True
    normalize_advantage: bool = True
    value_bootstrap: bool = False
    reward_scale: float = 1.0
    reward_shift: float = 0.0
    max_epochs: int = 500
    save_frequency: int = 50
    score_to_win: float = float("inf")
    lr_schedule: str = "adaptive"  # or "fixed"

    @staticmethod
    def from_train_cfg(cfg: dict) -> "PPOConfig":
        c = cfg["params"]["config"]
        shaper = c.get("reward_shaper", {})
        return PPOConfig(
            horizon_length=int(c.get("horizon_length", 16)),
            minibatch_size=int(c.get("minibatch_size", 8192)),
            mini_epochs=int(c.get("mini_epochs", 4)),
            gamma=float(c.get("gamma", 0.99)),
            tau=float(c.get("tau", 0.95)),
            learning_rate=float(c.get("learning_rate", 3e-4)),
            kl_threshold=float(c.get("kl_threshold", 0.008)),
            e_clip=float(c.get("e_clip", 0.2)),
            clip_value=bool(c.get("clip_value", True)),
            critic_coef=float(c.get("critic_coef", 2.0)),
            entropy_coef=float(c.get("entropy_coef", 0.0)),
            bounds_loss_coef=float(c.get("bounds_loss_coef", 0.0) or 0.0),
            grad_norm=float(c.get("grad_norm", 1.0)),
            truncate_grads=bool(c.get("truncate_grads", True)),
            normalize_input=bool(c.get("normalize_input", True)),
            normalize_value=bool(c.get("normalize_value", True)),
            normalize_advantage=bool(c.get("normalize_advantage", True)),
            value_bootstrap=bool(c.get("value_bootstrap", False)),
            reward_scale=float(shaper.get("scale_value", 1.0)),
            reward_shift=float(shaper.get("shift_value", 0.0)),
            max_epochs=int(c.get("max_epochs", 500)),
            save_frequency=int(c.get("save_frequency", 50)),
            score_to_win=float(c.get("score_to_win", 1e18)),
            lr_schedule=str(c.get("lr_schedule", "adaptive")),
        )


class Rollout(NamedTuple):
    """One epoch's samples, each (T, B, ...)."""

    obs: torch.Tensor
    actions: torch.Tensor
    neglogp: torch.Tensor
    values: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


class PPOAgent:
    """Trains one task; ``init()`` builds the network, optimiser and env
    state, ``train_epoch()`` runs one epoch and returns its metrics."""

    def __init__(self, task, train_cfg: dict, seed: int = 42):
        params = train_cfg["params"]
        algo = params["algo"]["name"]
        if algo not in PPO_ALGOS:
            raise NotImplementedError(
                f"algo {algo!r} is not ported yet: ROADMAP queue A, item 10 "
                "(AMP, HRL and SAC)")
        if params["config"].get("central_value_config"):
            raise NotImplementedError(
                "central_value_config (the asymmetric critic) is not ported "
                "yet: ROADMAP queue A, item 7")
        if params["network"].get("rnn"):
            raise NotImplementedError(
                "network.rnn (ActorCriticLSTM) is not ported yet: ROADMAP "
                "queue A, item 7")
        self.task = task
        self.train_cfg = train_cfg
        self.cfg = PPOConfig.from_train_cfg(train_cfg)
        self.device = task.device
        self.batch = task.rl_games_batch
        self.horizon = self.cfg.horizon_length
        total = self.batch * self.horizon
        assert total % self.cfg.minibatch_size == 0, (
            f"batch {total} not divisible by minibatch {self.cfg.minibatch_size}")
        self.num_minibatches = total // self.cfg.minibatch_size
        self.seed = seed
        self.net = None

    # ------------------------------------------------------------------
    def init(self) -> None:
        """Fresh network (flax's initialisation from ``seed``), optimiser,
        normalisers, counters and env state."""
        apply_precision_policy()
        cfg, task, dev = self.cfg, self.task, self.device
        # the weights come from a CPU generator: the same seed gives the
        # same network on every device
        self.net = build_network(
            self.train_cfg["params"]["network"], task.num_obs,
            task.num_actions,
            generator=torch.Generator().manual_seed(self.seed)).to(dev)
        self.generator = make_generator(self.seed, dev)
        self.lr = torch.tensor(cfg.learning_rate, dtype=DTYPE, device=dev)
        self.optim = torch.optim.Adam(
            self.net.parameters(), lr=self.lr, eps=1e-8,
            capturable=dev.type == "cuda")
        self.obs_rms = RunningMeanStd((task.num_obs,), dev)
        self.value_rms = RunningMeanStd((), dev)
        self.env_state, self.last_obs = task.reset(task.initial_state())
        nt = self.batch // task.num_agents
        self.ep_return = torch.zeros(nt, dtype=DTYPE, device=dev)
        self.ep_length = torch.zeros(nt, dtype=DTYPE, device=dev)
        self.mean_return = torch.zeros((), dtype=DTYPE, device=dev)
        self.mean_length = torch.zeros((), dtype=DTYPE, device=dev)
        self.epoch = 0
        self.frames = 0

    # ------------------------------------------------------------------
    def _policy(self, obs):
        o = self.obs_rms.normalize(obs) if self.cfg.normalize_input else obs
        return self.net(o)

    @staticmethod
    def _scalar_extras(extras) -> Dict[str, torch.Tensor]:
        """Numeric task extras -> scalar means for the observer channel
        (RLGPUAlgoObserver episode aggregation, rlgames_utils.py:149-209).
        One level of nesting is flattened (extras['episode'][term])."""
        out = {}

        def add(k, v):
            if isinstance(v, dict):
                for k2, v2 in v.items():
                    add(f"{k}/{k2}", v2)
            elif (torch.is_tensor(v) and v.dtype != torch.bool
                  and not v.is_complex()):
                out[k] = v.to(DTYPE).mean()

        for k, v in extras.items():
            if k == "time_outs" or k.startswith("_"):
                continue
            add(k, v)
        return out

    @torch.no_grad()
    def _rollout(self, noise: Optional[torch.Tensor] = None,
                 reset_draws=None):
        """``horizon`` steps from the agent's env state; returns (Rollout,
        last obs, stats).  ``noise`` (T, B, A) replaces the N(0, 1) action
        draws, ``reset_draws[t]`` the task's reset draws of step t."""
        cfg, task = self.cfg, self.task
        na = task.num_agents
        env_state, obs = self.env_state, self.last_obs
        ep_ret, ep_len = self.ep_return, self.ep_length
        fin_sum = torch.zeros((), dtype=DTYPE, device=self.device)
        fin_len, fin_cnt = fin_sum.clone(), fin_sum.clone()
        steps, extra_seq = [], {}
        for t in range(self.horizon):
            mu, log_sigma, v_norm = self._policy(obs)
            sigma = torch.exp(log_sigma)
            eps = (noise[t] if noise is not None else torch.randn(
                mu.shape, generator=self.generator, device=self.device))
            actions = mu + sigma * eps
            neglogp = gaussian_neglogp(mu, log_sigma, actions)
            value = (self.value_rms.denormalize(v_norm)
                     if cfg.normalize_value else v_norm)

            env_state, res = task.step(
                env_state, actions,
                reset_draws=None if reset_draws is None else reset_draws[t])
            rew = cfg.reward_scale * (res.rew + cfg.reward_shift)
            if cfg.value_bootstrap:
                rew = rew + cfg.gamma * value * res.extras["time_outs"].to(
                    rew.dtype)
            done = res.reset > 0

            # episode stats stride by num_agents (A2CAgent_MA.py:44-47)
            row_done = done[::na]
            ep_ret = ep_ret + res.rew[::na]
            ep_len = ep_len + 1.0
            fin_sum = fin_sum + torch.where(row_done, ep_ret, 0.0).sum()
            fin_len = fin_len + torch.where(row_done, ep_len, 0.0).sum()
            fin_cnt = fin_cnt + row_done.sum()
            ep_ret = torch.where(row_done, 0.0, ep_ret)
            ep_len = torch.where(row_done, 0.0, ep_len)

            steps.append((obs, actions, neglogp, value, rew, done, mu, sigma))
            for k, v in self._scalar_extras(res.extras).items():
                extra_seq.setdefault(k, []).append(v)
            obs = res.obs

        roll = Rollout(*(torch.stack(x) for x in zip(*steps)))
        has = fin_cnt > 0
        self.mean_return = torch.where(
            has, fin_sum / torch.clamp(fin_cnt, min=1.0), self.mean_return)
        self.mean_length = torch.where(
            has, fin_len / torch.clamp(fin_cnt, min=1.0), self.mean_length)
        self.env_state, self.last_obs = env_state, obs
        self.ep_return, self.ep_length = ep_ret, ep_len
        stats = {"episodes_done": fin_cnt}
        for k, v in extra_seq.items():
            stats[f"episode/{k}"] = torch.stack(v).mean()
        return roll, obs, stats

    @torch.no_grad()
    def _gae(self, roll: Rollout, last_obs: torch.Tensor):
        """(advantages, returns), each (T, B)."""
        cfg = self.cfg
        _, _, v_norm = self._policy(last_obs)
        last_value = (self.value_rms.denormalize(v_norm)
                      if cfg.normalize_value else v_norm)
        next_values = torch.cat([roll.values[1:], last_value[None]], dim=0)
        adv = torch.empty_like(roll.values)
        lastgaelam = torch.zeros_like(last_value)
        for t in reversed(range(self.horizon)):
            nonterminal = 1.0 - roll.dones[t].to(DTYPE)
            delta = (roll.rewards[t] + cfg.gamma * next_values[t] * nonterminal
                     - roll.values[t])
            lastgaelam = delta + cfg.gamma * cfg.tau * nonterminal * lastgaelam
            adv[t] = lastgaelam
        return adv, adv + roll.values

    def _loss(self, mb):
        """(total, (a_loss, c_loss, entropy, kl)) of one minibatch; the
        gradient flows into ``self.net``."""
        cfg = self.cfg
        (obs, actions, old_neglogp, old_values_n, adv, returns_n, old_mu,
         old_sigma) = mb
        mu, log_sigma, v_pred_n = self.net(obs)
        neglogp = gaussian_neglogp(mu, log_sigma, actions)
        ratio = torch.exp(torch.clamp(old_neglogp - neglogp, -20.0, 20.0))
        surr1 = adv * ratio
        surr2 = adv * torch.clamp(ratio, 1.0 - cfg.e_clip, 1.0 + cfg.e_clip)
        a_loss = -torch.minimum(surr1, surr2).mean()

        if cfg.clip_value:
            v_clipped = old_values_n + torch.clamp(
                v_pred_n - old_values_n, -cfg.e_clip, cfg.e_clip)
            c_loss = torch.maximum(torch.square(v_pred_n - returns_n),
                                   torch.square(v_clipped - returns_n)).mean()
        else:
            c_loss = torch.square(v_pred_n - returns_n).mean()

        entropy = gaussian_entropy(log_sigma).mean()
        b_loss = torch.sum(
            torch.square(torch.clamp(mu - 1.1, min=0.0))
            + torch.square(torch.clamp(mu + 1.1, max=0.0)), dim=-1).mean()

        total = (a_loss + 0.5 * cfg.critic_coef * c_loss
                 - cfg.entropy_coef * entropy + cfg.bounds_loss_coef * b_loss)
        kl = gaussian_kl(old_mu, torch.log(old_sigma), mu, log_sigma).mean()
        return total, (a_loss, c_loss, entropy, kl)

    def _clip_grads(self):
        """optax ``clip_by_global_norm``: g * grad_norm / |g| when |g| >=
        grad_norm."""
        grads = [p.grad for p in self.net.parameters() if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        mx = self.cfg.grad_norm
        scale = torch.where(norm < mx, torch.ones_like(norm), mx / norm)
        torch._foreach_mul_(grads, scale)

    def _adaptive_lr(self, lr, kl):
        """The 'adaptive' schedule after one minibatch, on the device."""
        thr = self.cfg.kl_threshold
        lr = torch.where(kl > 2.0 * thr, torch.clamp(lr / 1.5, min=1e-6), lr)
        return torch.where(kl < 0.5 * thr, torch.clamp(lr * 1.5, max=1e-2),
                           lr)

    def _update(self, roll: Rollout, adv: torch.Tensor, returns: torch.Tensor,
                perms: Optional[torch.Tensor] = None):
        """Normalisers, then ``mini_epochs`` passes of minibatch SGD;
        returns the epoch's metrics.  ``perms`` (mini_epochs, T * B)
        replaces the permutations drawn from the agent's generator."""
        cfg = self.cfg

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])
        obs_f = flat(roll.obs)
        if cfg.normalize_input:
            # normalize the training batch with the SAME stats the rollout
            # policy used (old mu/neglogp consistency), then update
            obs_train = self.obs_rms.normalize(obs_f)
            self.obs_rms.update(obs_f)
        else:
            obs_train = obs_f
        if cfg.normalize_value:
            self.value_rms.update(flat(returns))
            returns_n = self.value_rms.normalize(flat(returns), clip=1e8)
            old_values_n = self.value_rms.normalize(flat(roll.values),
                                                    clip=1e8)
        else:
            returns_n, old_values_n = flat(returns), flat(roll.values)
        adv_f = flat(adv)
        if cfg.normalize_advantage:
            adv_f = (adv_f - adv_f.mean()) / (adv_f.std(correction=0) + 1e-8)

        data = (obs_train, flat(roll.actions), flat(roll.neglogp),
                old_values_n, adv_f, returns_n, flat(roll.mu),
                flat(roll.sigma))
        total = obs_f.shape[0]
        mb_size = cfg.minibatch_size
        metrics = []
        for e in range(cfg.mini_epochs):
            perm = (perms[e] if perms is not None else torch.randperm(
                total, generator=self.generator, device=self.device))
            idxs = perm[: self.num_minibatches * mb_size].reshape(
                self.num_minibatches, mb_size)
            for idx in idxs:
                mb = tuple(d[idx] for d in data)
                self.optim.zero_grad(set_to_none=True)
                loss, (a_l, c_l, ent, kl) = self._loss(mb)
                loss.backward()
                if cfg.truncate_grads:
                    self._clip_grads()
                self.optim.step()
                kl = kl.detach()
                if cfg.lr_schedule == "adaptive":
                    self.lr = self._adaptive_lr(self.lr, kl)
                    self.optim.param_groups[0]["lr"] = self.lr
                metrics.append(torch.stack(
                    [loss.detach(), a_l.detach(), c_l.detach(),
                     ent.detach(), kl]))
        loss, a_l, c_l, ent, kl = torch.stack(metrics).mean(dim=0)
        self.epoch += 1
        self.frames += total
        net = self.net
        return {
            "loss": loss, "a_loss": a_l, "c_loss": c_l, "entropy": ent,
            "kl": kl, "lr": self.lr, "mean_return": self.mean_return,
            "mean_length": self.mean_length, "frames": self.frames,
            # exploration health: mean policy stddev
            "sigma": (torch.exp(net.log_sigma.detach()).mean()
                      if net.fixed_sigma else self.lr.new_zeros(())),
        }

    def train_epoch(self, noise=None, perms=None, reset_draws=None
                    ) -> Dict[str, object]:
        """One epoch: rollout, GAE, update (JAX's jitted ``_train_epoch``).
        The metrics are device tensors (``frames`` an int); reading them is
        the only wait for the card."""
        roll, last_obs, stats = self._rollout(noise, reset_draws)
        adv, returns = self._gae(roll, last_obs)
        metrics = self._update(roll, adv, returns, perms)
        metrics["episodes_done"] = stats["episodes_done"]
        # aggregated task extras (Episode/* channel — rlgames_utils.py:149)
        metrics.update({k: v for k, v in stats.items()
                        if k.startswith("episode/")})
        return metrics

    # ------------------------------------------------------------------
    def train(self, max_epochs: Optional[int] = None, log_every: int = 20,
              score_to_win: Optional[float] = None):
        """Host driver loop (the rl_games Runner.run({'train': True}) path)."""
        cfg = self.cfg
        max_epochs = max_epochs or cfg.max_epochs
        score_to_win = score_to_win if score_to_win is not None else cfg.score_to_win
        if self.net is None:
            self.init()
        t0 = time.time()
        for ep in range(max_epochs):
            metrics = self.train_epoch()
            if (ep + 1) % log_every == 0 or ep == max_epochs - 1:
                m = {k: float(v) for k, v in metrics.items()}
                fps = m["frames"] / max(time.time() - t0, 1e-9)
                print(f"epoch {ep+1}/{max_epochs} reward {m['mean_return']:.2f} "
                      f"len {m['mean_length']:.0f} kl {m['kl']:.4f} lr {m['lr']:.2e} "
                      f"fps {fps:,.0f}")
                if m["mean_return"] >= score_to_win:
                    print(f"score_to_win {score_to_win} reached")
                    break

    # ------------------------------------------------------------------
    @torch.no_grad()
    def act(self, obs, deterministic: bool = True):
        """Player path (PpoPlayerContinuous.get_action equivalent)."""
        mu, log_sigma, _ = self._policy(obs)
        if deterministic:
            return mu
        return mu + torch.exp(log_sigma) * torch.randn(
            mu.shape, generator=self.generator, device=self.device)

    # ------------------------------------------------------------------
    def _optim_state(self) -> dict:
        """Adam's moments and step count by parameter name."""
        return {name: dict(self.optim.state[p])
                for name, p in self.net.named_parameters()
                if p in self.optim.state}

    def state_dict(self) -> dict:
        """Everything a resumed run needs (checkpoint ``ppo_state``)."""
        st = self.env_state
        env = {"sim.q": st.sim.q, "sim.qd": st.sim.qd,
               "progress": st.progress, "reset_buf": st.reset_buf}
        if st.task is not None:
            env.update({f"task.{f}": v for f, v in st.task._asdict().items()})
        if st.phys is not None:
            env.update({f"phys.{f}": v for f, v in st.phys._asdict().items()
                        if v is not None})
        return {
            "net": self.net.state_dict(), "optim": self._optim_state(),
            "obs_rms": self.obs_rms.state_dict(),
            "value_rms": self.value_rms.state_dict(), "lr": self.lr,
            "epoch": self.epoch, "frames": self.frames,
            "ep_return": self.ep_return, "ep_length": self.ep_length,
            "mean_return": self.mean_return, "mean_length": self.mean_length,
            "generator": self.generator.get_state(),
            "task_generator": self.task.generator.get_state(),
            "env_state": env, "last_obs": self.last_obs,
        }

    def load_state_dict(self, d: dict) -> None:
        """Load what ``d`` holds of ``state_dict()``'s keys (a checkpoint,
        or ``convert.ppo_state_from_jax``'s learner part); ``init()``
        first."""
        dev = self.device

        def on(x):
            return (x.detach().clone() if torch.is_tensor(x)
                    else torch.tensor(x)).to(dev)
        if "net" in d:
            self.net.load_state_dict(d["net"])
        if "optim" in d:
            capturable = self.optim.param_groups[0]["capturable"]
            for name, p in self.net.named_parameters():
                s = d["optim"].get(name)
                if s is None:
                    continue
                step = torch.as_tensor(s["step"], dtype=torch.float32)
                self.optim.state[p] = {
                    "step": step.to(dev if capturable else "cpu").clone(),
                    "exp_avg": on(s["exp_avg"]),
                    "exp_avg_sq": on(s["exp_avg_sq"])}
        for k in ("obs_rms", "value_rms"):
            if k in d:
                getattr(self, k).load_state_dict(d[k])
        if "lr" in d:
            self.lr = on(d["lr"]).to(DTYPE)
            self.optim.param_groups[0]["lr"] = self.lr
        for k in ("epoch", "frames"):
            if k in d:
                setattr(self, k, int(d[k]))
        for k in ("ep_return", "ep_length", "mean_return", "mean_length",
                  "last_obs"):
            if k in d:
                setattr(self, k, on(d[k]).to(DTYPE))
        if "generator" in d:
            self.generator.set_state(d["generator"].cpu())
        if "task_generator" in d:
            self.task.generator.set_state(d["task_generator"].cpu())
        if "env_state" in d:
            env = d["env_state"]
            task = self.env_state.task
            if task is not None:
                task = type(task)(**{f: on(env[f"task.{f}"])
                                     for f in task._fields})
            phys = self.env_state.phys
            if phys is not None:
                phys = type(phys)(**{f: on(env[f"phys.{f}"])
                                     for f in phys._fields
                                     if f"phys.{f}" in env})
            self.env_state = EnvState(
                sim=SimState(on(env["sim.q"]), on(env["sim.qd"])),
                progress=on(env["progress"]),
                reset_buf=on(env["reset_buf"]), task=task, phys=phys)
