"""AMP learner, adversarial motion priors (port of
isaacgymenvs_ma_tpu/learning/amp.py, reference learning/amp_continuous.py
with amp_network_builder, amp_datasets and replay_buffer).

The PPO learner with a style discriminator:
* demo transitions from the task's motion library
  (``task.fetch_amp_obs_demo``), a ring replay of past agent transitions
  and this epoch's agent transitions feed the discriminator, one Adam step
  an epoch on ``amp_batch_size`` samples of each (amp_continuous.py:171-247);
* the discriminator reward ``-log(max(1 - sigmoid(D), 1e-4))`` times
  ``disc_reward_scale``, combined as ``task_reward_w * r_task +
  disc_reward_w * r_disc`` before GAE (:488-511);
* the discriminator loss: BCE (demo 1, agent 0), the R1 gradient penalty
  on the demo inputs and weight decay on the logit layer (:393-440);
* one running mean/std (``amp_rms``) normalises every discriminator input.

Order within an epoch, as in JAX: the rollout keeps each step's AMP obs
(``_collect_aux``), the rewards are combined with the discriminator and
``amp_rms`` as they stand at the start of the epoch, PPO updates, then
``amp_rms`` takes all of the epoch's agent obs before the discriminator
batch is normalised.  The replay joins the batch (half agent, half replay)
once it holds more than ``amp_batch_size`` transitions, and the ring
stores the agent samples, not the mix.  ``replay_n`` is a host counter,
so none of this waits for the card.  The R1 penalty is the gradient of
the summed demo logits with respect to the demo inputs (each sample's
logit depends on its own input only), kept in the graph
(``create_graph``) and differentiated again through the ReLU layers.

The discriminator phase's draws (the demo pairs' motion ids and times,
the agent and replay indices) come from ``shared_generator`` (seeded by
``parallel.mesh.shared_seed``).

Data parallelism (``dist``), one program sharded over the envs as in JAX:
PPO's half of the epoch is reduced as PPO's is, the style reward stays per
env on each rank, and the discriminator phase is global.  Its draws are
equal on every rank; the agent indices range over the global ``horizon x
N`` rows (global row ``t N + e``, as JAX flattens the rollout's AMP obs)
and ``dist.pick`` assembles the ``(amp_batch_size, 210)`` agent batch on
every rank, so the replay ring (which stores it) stays replicated and
``replay_n`` counts global rows; ``amp_rms`` takes every rank's agent obs
through the global moments.  The discriminator step splits the batch W
ways: rank ``r`` takes rows ``[r B/W, (r+1) B/W)`` of the demo and agent
mix (its demo pairs fetched from its slice of the draws) and the gradient
is averaged over the ranks before the Adam step, as PPO's is.  Means of
equal shares make the BCE, the R1 penalty (a mean over the demo rows) and
their gradients the global batch's; the logit regulariser's gradient is
the same on every rank, so its average is itself.  (Running the whole
batch on every rank would need no all-reduce, but it fetches and
differentiates twice through every demo on every rank; splitting keeps
the work per rank at 1/W, as the rest of the epoch's is.)
``amp_batch_size`` is global; ``W`` must divide it.

Test hook: ``train_epoch(..., amp_draws={"demo": (motion ids, times),
"replay_idx": (amp_batch,), "agent_idx": (amp_batch,)})`` replaces the
discriminator phase's draws (global ones under ``dist``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..device import DTYPE
from ..ops.rng import make_generator
from ..parallel.mesh import check_batch, module_state, shared_seed
from .networks import _mlp
from .ppo import PPOAgent, Rollout
from .running_norm import RunningMeanStd


class Discriminator(nn.Module):
    """ReLU MLP and a logit head (amp_network_builder.py:93-117), with
    flax's initialisation: the MLP lecun-normal with zero biases, the logit
    layer's weight U[0, 1) with a zero bias."""

    def __init__(self, amp_dim: int, units: Sequence[int] = (1024, 512),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.disc_mlp = _mlp(amp_dim, units, generator)
        d = units[-1] if units else amp_dim
        self.disc_logits = nn.Linear(d, 1)
        with torch.no_grad():
            self.disc_logits.weight.copy_(torch.rand((1, d),
                                                     generator=generator))
            self.disc_logits.bias.zero_()

    def forward(self, amp_obs):
        x = amp_obs
        for layer in self.disc_mlp:
            x = F.relu(layer(x))
        return self.disc_logits(x).squeeze(-1)


class AMPAgent(PPOAgent):
    algos = ("amp_continuous",)

    def __init__(self, task, train_cfg: dict, seed: int = 42, dist=None):
        if not hasattr(task, "fetch_amp_obs_demo"):
            raise ValueError(
                f"amp_continuous needs a task with AMP observations "
                f"(HumanoidAMP), not {type(task).__name__}")
        super().__init__(task, train_cfg, seed, dist=dist)
        c = train_cfg["params"]["config"]
        self.task_reward_w = float(c.get("task_reward_w", 0.0))
        self.disc_reward_w = float(c.get("disc_reward_w", 0.5))
        self.disc_reward_scale = float(c.get("amp_disc_reward_scale",
                                             c.get("disc_reward_scale", 2.0)))
        self.disc_grad_penalty = float(c.get("disc_grad_penalty", 5.0))
        self.disc_logit_reg = float(c.get("disc_logit_reg", 0.05))
        self.disc_lr = float(c.get("learning_rate", 5e-5))
        self.amp_batch = int(c.get("amp_batch_size", 512))
        if self.world > 1:
            check_batch("amp_batch_size", self.amp_batch, self.world)
        self.amp_dim = task.num_amp_obs
        self.replay_size = int(c.get("amp_replay_buffer_size", 100_000)) \
            // max(self.amp_dim // 64, 1)
        self.replay_size = max(4096, min(self.replay_size, 65536))
        self.disc_units = tuple(train_cfg["params"]["network"].get(
            "mlp", {}).get("units", [1024, 512]))
        self.disc = None

    # ------------------------------------------------------------------
    def init(self) -> None:
        """PPO's init, then a fresh discriminator (its own CPU generator
        from the seed), its Adam, ``amp_rms`` and an empty replay."""
        super().init()
        dev = self.device
        self.disc = Discriminator(
            self.amp_dim, self.disc_units,
            generator=torch.Generator().manual_seed(self.seed + 1)).to(dev)
        if self.dist is not None:
            self.dist.broadcast_tensors(self.disc.parameters())
        self.shared_generator = make_generator(
            shared_seed(self.seed, self.dist), dev)
        self.disc_optim = torch.optim.Adam(
            self.disc.parameters(), lr=self.disc_lr, eps=1e-8,
            capturable=dev.type == "cuda")
        self.amp_rms = RunningMeanStd((self.amp_dim,), dev)
        self.replay = torch.zeros((self.replay_size, self.amp_dim),
                                  dtype=DTYPE, device=dev)
        self.replay_n = 0
        self._last_amp_obs = None
        self._disc_reward_mean = None

    # PPO hooks -------------------------------------------------------------
    def _collect_aux(self, res):
        return res.extras["amp_obs"]

    def _rollout(self, noise=None, reset_draws=None):
        roll, last_obs, stats = super()._rollout(noise, reset_draws)
        self._last_amp_obs = roll.aux
        return roll, last_obs, stats

    @torch.no_grad()
    def _disc_reward(self, amp_obs):
        """The style reward of AMP obs (_calc_disc_rewards :498-511)."""
        prob = torch.sigmoid(self.disc(self.amp_rms.normalize(amp_obs)))
        return (-torch.log(torch.clamp(1.0 - prob, min=1e-4))
                * self.disc_reward_scale)

    def _transform_rewards(self, roll: Rollout) -> Rollout:
        """Task and discriminator rewards combined (_combine_rewards
        :488-496)."""
        disc_r = self._disc_reward(roll.aux)
        self._disc_reward_mean = disc_r.mean()
        if self.dist is not None:
            self._disc_reward_mean = self.dist.mean(self._disc_reward_mean)
        return roll._replace(rewards=self.task_reward_w * roll.rewards
                             + self.disc_reward_w * disc_r)

    # ------------------------------------------------------------------
    def _disc_loss(self, agent_obs, demo_obs):
        """(loss, (bce, grad penalty, agent accuracy, demo accuracy)) of
        normalised inputs (amp_continuous.py:393-440); the gradient flows
        into ``self.disc``."""
        agent_logits = self.disc(agent_obs)
        demo = demo_obs.detach().requires_grad_(True)
        demo_logits = self.disc(demo)
        bce = 0.5 * (F.softplus(agent_logits).mean()      # BCE against 0
                     + F.softplus(-demo_logits).mean())   # against 1
        # R1 gradient penalty on the demo observations
        grad, = torch.autograd.grad(demo_logits.sum(), demo,
                                    create_graph=True)
        gp = torch.sum(torch.square(grad), dim=-1).mean()
        # logit weight decay
        reg = torch.sum(torch.square(self.disc.disc_logits.weight))
        loss = bce + self.disc_grad_penalty * gp + self.disc_logit_reg * reg
        acc_agent = (agent_logits < 0).to(DTYPE).mean()
        acc_demo = (demo_logits > 0).to(DTYPE).mean()
        return loss, (bce, gp, acc_agent, acc_demo)

    def _disc_phase(self, draws=None) -> Dict[str, torch.Tensor]:
        """One discriminator step on this epoch's agent obs, the replay and
        fresh demos (train_epoch :171-247), then the ring store."""
        draws = draws or {}
        dev, B, R = self.device, self.amp_batch, self.replay_size
        g = self.shared_generator
        aux = self._last_amp_obs
        agent_obs = aux.reshape(-1, self.amp_dim)
        demo = draws.get("demo")
        if demo is None:
            demo = self.task.demo_draws(B, g)
        aidx = draws.get("agent_idx")
        if aidx is None:
            aidx = torch.randint(0, agent_obs.shape[0] * self.world, (B,),
                                 generator=g, device=dev)
        if self.dist is None:
            agent_batch = agent_obs[aidx.long()]
        else:
            # the global rows, assembled on every rank
            agent_batch = self.dist.pick(aux, aidx)
        agent_mix = agent_batch
        if self.replay_n > B:
            # half agent, half replay (amp_continuous.py:225-247)
            ridx = draws.get("replay_idx")
            if ridx is None:
                ridx = torch.randint(0, min(self.replay_n, R), (B,),
                                     generator=g, device=dev)
            agent_mix = torch.cat([agent_batch[: B // 2],
                                   self.replay[ridx.long()][: B // 2]])
        if self.dist is not None:
            # this rank's share of the demo and agent rows
            n = B // self.world
            lo = self.dist.rank * n
            agent_mix = agent_mix[lo: lo + n]
            demo = tuple(x[lo: lo + n] for x in demo)
        demo_obs = self.task.fetch_amp_obs_demo(agent_mix.shape[0], demo)

        red = None if self.dist is None else self.dist.sum
        self.amp_rms.update(agent_obs, red)
        self.disc_optim.zero_grad(set_to_none=True)
        norm = self.amp_rms.normalize
        loss, (bce, gp, acc_a, acc_d) = self._disc_loss(norm(agent_mix),
                                                        norm(demo_obs))
        loss.backward()
        if self.dist is not None:
            self.dist.allreduce_grads(list(self.disc.parameters()))
        self.disc_optim.step()

        # replay store (ring)
        idx = (self.replay_n + torch.arange(B, device=dev)) % R
        self.replay[idx] = agent_batch
        self.replay_n += B
        m = torch.stack([loss.detach(), bce.detach(), gp.detach(), acc_a,
                         acc_d])
        if self.dist is not None:
            m = self.dist.mean(m)
        return dict(zip(("disc_loss", "disc_bce", "disc_grad_penalty",
                         "disc_acc_agent", "disc_acc_demo"), m))

    def train_epoch(self, noise=None, perms=None, reset_draws=None,
                    amp_draws=None) -> Dict[str, object]:
        """PPO's epoch with the combined rewards, then the discriminator
        phase (JAX ``_train_epoch_amp``); ``disc_reward`` is the mean
        style reward of the rollout."""
        metrics = super().train_epoch(noise, perms, reset_draws)
        metrics.update(self._disc_phase(amp_draws))
        metrics["disc_reward"] = self._disc_reward_mean
        return metrics

    # ------------------------------------------------------------------
    def replicated_state(self):
        """PPO's, then the discriminator and its Adam, ``amp_rms`` and the
        replay's filled rows."""
        yield from super().replicated_state()
        yield from module_state("disc.", self.disc, self.disc_optim)
        for k, v in self.amp_rms.state_dict().items():
            yield f"amp_rms.{k}", v
        yield "replay", self.replay[: min(self.replay_n, self.replay_size)]

    def state_dict(self) -> dict:
        d = super().state_dict()
        d.update({
            "shared_generator": self.shared_generator.get_state(),
            "disc": self.disc.state_dict(),
            "disc_optim": {name: dict(self.disc_optim.state[p])
                           for name, p in self.disc.named_parameters()
                           if p in self.disc_optim.state},
            "amp_rms": self.amp_rms.state_dict(),
            "replay": self.replay[: min(self.replay_n, self.replay_size)],
            "replay_n": self.replay_n})
        return d

    def load_state_dict(self, d: dict) -> None:
        """PPO's keys, and the discriminator's, its Adam state, ``amp_rms``
        and the replay's filled rows (``convert.amp_state_from_jax``'s
        keys)."""
        super().load_state_dict(d)
        dev = self.device
        if "disc" in d:
            self.disc.load_state_dict(d["disc"])
        if "disc_optim" in d:
            capturable = self.disc_optim.param_groups[0]["capturable"]
            for name, p in self.disc.named_parameters():
                s = d["disc_optim"].get(name)
                if s is None:
                    continue
                step = torch.as_tensor(s["step"], dtype=torch.float32)
                self.disc_optim.state[p] = {
                    "step": step.to(dev if capturable else "cpu").clone(),
                    "exp_avg": torch.as_tensor(s["exp_avg"]).to(dev).clone(),
                    "exp_avg_sq": torch.as_tensor(
                        s["exp_avg_sq"]).to(dev).clone()}
        if d.get("amp_rms") is not None:
            self.amp_rms.load_state_dict(d["amp_rms"])
        if "replay" in d:
            rows = torch.as_tensor(d["replay"], dtype=DTYPE).to(dev)
            self.replay[: rows.shape[0]] = rows
        if "replay_n" in d:
            self.replay_n = int(d["replay_n"])
        if "shared_generator" in d:
            self.shared_generator.set_state(d["shared_generator"].cpu())
