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

Test hook: ``train_epoch(..., amp_draws={"demo": (motion ids, times),
"replay_idx": (amp_batch,), "agent_idx": (amp_batch,)})`` replaces the
discriminator phase's draws.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..device import DTYPE
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

    def __init__(self, task, train_cfg: dict, seed: int = 42):
        if not hasattr(task, "fetch_amp_obs_demo"):
            raise ValueError(
                f"amp_continuous needs a task with AMP observations "
                f"(HumanoidAMP), not {type(task).__name__}")
        super().__init__(task, train_cfg, seed)
        c = train_cfg["params"]["config"]
        self.task_reward_w = float(c.get("task_reward_w", 0.0))
        self.disc_reward_w = float(c.get("disc_reward_w", 0.5))
        self.disc_reward_scale = float(c.get("amp_disc_reward_scale",
                                             c.get("disc_reward_scale", 2.0)))
        self.disc_grad_penalty = float(c.get("disc_grad_penalty", 5.0))
        self.disc_logit_reg = float(c.get("disc_logit_reg", 0.05))
        self.disc_lr = float(c.get("learning_rate", 5e-5))
        self.amp_batch = int(c.get("amp_batch_size", 512))
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
        agent_obs = self._last_amp_obs.reshape(-1, self.amp_dim)
        demo_obs = self.task.fetch_amp_obs_demo(B, draws.get("demo"))
        aidx = draws.get("agent_idx")
        if aidx is None:
            aidx = torch.randint(0, agent_obs.shape[0], (B,),
                                 generator=self.generator, device=dev)
        agent_batch = agent_obs[aidx.long()]
        agent_mix = agent_batch
        if self.replay_n > B:
            # half agent, half replay (amp_continuous.py:225-247)
            ridx = draws.get("replay_idx")
            if ridx is None:
                ridx = torch.randint(0, min(self.replay_n, R), (B,),
                                     generator=self.generator, device=dev)
            agent_mix = torch.cat([agent_batch[: B // 2],
                                   self.replay[ridx.long()][: B // 2]])

        self.amp_rms.update(agent_obs)
        self.disc_optim.zero_grad(set_to_none=True)
        norm = self.amp_rms.normalize
        loss, (bce, gp, acc_a, acc_d) = self._disc_loss(norm(agent_mix),
                                                        norm(demo_obs))
        loss.backward()
        self.disc_optim.step()

        # replay store (ring)
        idx = (self.replay_n + torch.arange(B, device=dev)) % R
        self.replay[idx] = agent_batch
        self.replay_n += B
        return {"disc_loss": loss.detach(), "disc_bce": bce.detach(),
                "disc_grad_penalty": gp.detach(), "disc_acc_agent": acc_a,
                "disc_acc_demo": acc_d}

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
    def state_dict(self) -> dict:
        d = super().state_dict()
        d.update({
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
