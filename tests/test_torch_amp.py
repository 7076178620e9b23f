"""The port's AMP learner (isaacgymenvs_ma_tpu_torch/learning/amp.py)
against the JAX package's.

* The discriminator's loss, its BCE, R1 penalty and accuracies, and the
  gradients of the loss (differentiated twice through the ReLU layers),
  against JAX ``_disc_loss`` under ``value_and_grad``, on the same
  parameters and seeded inputs.
* ``_transform_rewards`` (the style reward combined with the task's).
* One whole AMP epoch against ``tests/data/torch_port/amp_epoch.npz``
  (``scripts/record_torch_golden.py --amp-epoch``): HumanoidAMP at 8 envs,
  horizon 8, minibatch 64, ``amp_batch_size`` 32, units [64, 32], seed 3,
  the JAX learner's third epoch (so the replay joins the discriminator
  batch), from the state it started from and with every draw of it
  injected.  The JAX epoch compiles in minutes, so no test here jits it.

Tolerances: the loss 1e-6 relative, the gradients 2e-6 of their largest
entry; the epoch's rollout at the ground rule's 2e-3 for the obs, the AMP
obs, the style rewards and the values, advantages and returns (measured
on the CPU: obs 3.1e-4, rewards 1.4e-4, values 5.0e-4 of values up to 48,
advantages 3.6e-4, returns 2.9e-4), actions and mu 1e-4 (1.2e-5),
neglogp 1e-3 (7.6e-6), the metrics 1e-4 relative (the disc loss 1.5e-7),
the parameters after the epoch 1e-6 (3.0e-8; one Adam step of the
learning rate 5e-5 is far above it), the normalisers 1e-5 relative and
2e-5 absolute (the obs means carry the obs' error: 3.3e-6 measured).
"""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.learning import amp as jamp
from isaacgymenvs_ma_tpu.learning.ppo import Rollout as JRollout
from isaacgymenvs_ma_tpu.learning.running_norm import RunningMeanStd as JRMS
from isaacgymenvs_ma_tpu_torch.convert import (amp_state_from_jax,
                                               params_from_jax,
                                               ppo_state_from_jax)
from isaacgymenvs_ma_tpu_torch.learning.amp import AMPAgent, Discriminator
from isaacgymenvs_ma_tpu_torch.learning.configs import train_default_config
from isaacgymenvs_ma_tpu_torch.learning.ppo import Rollout
from isaacgymenvs_ma_tpu_torch.learning.running_norm import RunningMeanStd

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
AMP_DIM, UNITS = 210, (64, 32)


def _disc_pair(seed=0):
    jdisc = jamp.Discriminator(UNITS)
    params = jdisc.init(jax.random.PRNGKey(seed), jnp.zeros((1, AMP_DIM)))
    pdisc = Discriminator(AMP_DIM, UNITS)
    pdisc.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jdisc, params, pdisc


def test_discriminator_init_and_forward():
    """flax's initialisation: the logit weight in [0, 1) and zero biases;
    the converted network gives the JAX logits."""
    jdisc, params, pdisc = _disc_pair()
    g = torch.Generator().manual_seed(1)
    fresh = Discriminator(AMP_DIM, UNITS, generator=g)
    w = fresh.disc_logits.weight
    assert (w >= 0).all() and (w < 1).all() and w.std() > 0.2
    assert all(float(b.detach().abs().max()) == 0
               for n, b in fresh.named_parameters()
               if n.endswith("bias"))
    x = np.random.default_rng(0).normal(size=(64, AMP_DIM)).astype(
        np.float32)
    np.testing.assert_allclose(pdisc(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(jdisc.apply(params, x)),
                               rtol=1e-5, atol=1e-5)


def test_disc_loss_and_gradients_match_jax():
    jdisc, params, pdisc = _disc_pair(3)
    g = np.random.default_rng(4)
    agent = g.normal(size=(32, AMP_DIM)).astype(np.float32)
    demo = (0.5 + g.normal(size=(32, AMP_DIM))).astype(np.float32)
    jself = SimpleNamespace(disc=jdisc, disc_grad_penalty=5.0,
                            disc_logit_reg=0.05)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jamp.AMPAgent._disc_loss(jself, p, agent, demo),
        has_aux=True)(params)
    pself = SimpleNamespace(disc=pdisc, disc_grad_penalty=5.0,
                            disc_logit_reg=0.05)
    loss, aux = AMPAgent._disc_loss(pself, torch.as_tensor(agent),
                                    torch.as_tensor(demo))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for name, got, want in zip(("bce", "grad_penalty", "acc_agent",
                                "acc_demo"), aux, jaux):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=name)
    assert float(jaux[1]) > 1.0          # the R1 term is live
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in pdisc.named_parameters():
        w = want[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=2e-6 * scale, err_msg=name)


def _fake_amp_task(n=16):
    return SimpleNamespace(device=torch.device("cpu"), rl_games_batch=n,
                           num_obs=105, num_actions=28, num_states=0,
                           num_agents=1, num_amp_obs=AMP_DIM,
                           fetch_amp_obs_demo=None)


def test_transform_rewards_matches_jax():
    jdisc, params, pdisc = _disc_pair(5)
    g = np.random.default_rng(6)
    T, B = 4, 16
    aux = g.normal(size=(T, B, AMP_DIM)).astype(np.float32)
    rew = g.normal(size=(T, B)).astype(np.float32)
    mean = g.normal(size=AMP_DIM).astype(np.float32)
    var = g.uniform(0.5, 2.0, AMP_DIM).astype(np.float32)
    cfg = train_default_config("HumanoidAMP")
    cfg["params"]["config"].update(task_reward_w=0.3, disc_reward_w=0.7,
                                   minibatch_size=64)
    jself = SimpleNamespace(
        disc=jdisc, disc_reward_scale=2.0, task_reward_w=0.3,
        disc_reward_w=0.7, _amp_vars=SimpleNamespace(
            disc_params=params,
            amp_rms=JRMS(jnp.asarray(mean), jnp.asarray(var),
                         jnp.asarray(50.0, jnp.float32))))
    z = jnp.zeros((T, B))
    jroll = JRollout(obs=z, states=(), carry=(), actions=z, neglogp=z,
                     values=z, rewards=jnp.asarray(rew), dones=z, mu=z,
                     sigma=z, aux=jnp.asarray(aux))
    want = np.asarray(jamp.AMPAgent._transform_rewards(jself, None,
                                                       jroll).rewards)
    agent = AMPAgent(_fake_amp_task(B), cfg, seed=0)
    agent.disc = pdisc
    agent.amp_rms = RunningMeanStd((AMP_DIM,))
    agent.amp_rms.load_state_dict({"mean": mean, "var": var,
                                   "count": np.float32(50.0)})
    zt = torch.zeros((T, B))
    roll = Rollout(obs=zt, actions=zt, neglogp=zt, values=zt,
                   rewards=torch.as_tensor(rew), dones=zt, mu=zt, sigma=zt,
                   aux=torch.as_tensor(aux))
    got = agent._transform_rewards(roll).rewards.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert float(np.ptp(want)) > 0.1     # the style reward varies


def test_amp_needs_an_amp_task():
    cfg = train_default_config("HumanoidAMP")
    task = _fake_amp_task()
    del task.fetch_amp_obs_demo
    with pytest.raises(ValueError, match="AMP observations"):
        AMPAgent(task, cfg)


# ------------------------------------------------------------ the epoch
EPOCH = os.path.join(DATA, "amp_epoch.npz")
EPOCH_ENVS, EPOCH_SEED = 8, 3
EPOCH_TOL = {"obs": 2e-3, "actions": 1e-4, "mu": 1e-4, "neglogp": 1e-3,
             "values": 2e-3, "rewards": 2e-3, "aux": 2e-3, "adv": 2e-3,
             "returns": 2e-3, "metrics_rtol": 1e-4, "params": 1e-6,
             "rms_rtol": 1e-5, "rms_atol": 2e-5}


def _tree(d, prefix):
    """{a.b.c: array} keys under ``prefix`` back into a nested dict."""
    out = {}
    for k in d.files:
        if not k.startswith(prefix + "."):
            continue
        node = out
        *path, leaf = k[len(prefix) + 1:].split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = d[k]
    return out


def _learner(d, pre):
    """amp_epoch.npz's learner state under ``pre`` as the keys of
    AMPAgent.load_state_dict."""
    sc = lambda k: d[pre + k]  # noqa: E731
    out = ppo_state_from_jax({
        "params": _tree(d, pre + "params"),
        "adam": _tree(d, pre + "adam"),
        "obs_rms": _tree(d, pre + "obs_rms"),
        "value_rms": _tree(d, pre + "value_rms"),
        "lr": sc("lr"), "epoch": sc("epoch"), "frames": sc("frames"),
        "ep_return": sc("ep_return"), "ep_length": sc("ep_length"),
        "mean_return": sc("mean_return"), "mean_length": sc("mean_length"),
        "last_obs": sc("last_obs")})
    out.update(amp_state_from_jax({
        "disc_params": _tree(d, pre + "disc_params"),
        "disc_adam": _tree(d, pre + "disc_adam"),
        "amp_rms": _tree(d, pre + "amp_rms"),
        "replay": sc("replay"), "replay_n": sc("replay_n")}))
    out["env_state"] = {
        "sim.q": sc("env_q"), "sim.qd": sc("env_qd"),
        "progress": sc("env_progress"), "reset_buf": sc("env_reset_buf"),
        "task.amp_obs_hist": sc("env_amp_obs_hist")}
    return out


@pytest.fixture(scope="module")
def amp_epoch():
    from isaacgymenvs_ma_tpu_torch.tasks.humanoid_amp import (HumanoidAMP,
                                                              TASK_CFG)
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    d = np.load(EPOCH)
    task = HumanoidAMP(deep_merge(TASK_CFG, {"env": {"numEnvs": EPOCH_ENVS}}),
                       device="cpu", seed=EPOCH_SEED)
    cfg = train_default_config("HumanoidAMP")
    cfg["params"]["config"].update(minibatch_size=64, horizon_length=8,
                                   amp_batch_size=32)
    cfg["params"]["network"]["mlp"]["units"] = list(UNITS)
    agent = AMPAgent(task, cfg, seed=EPOCH_SEED)
    agent.init()
    agent.load_state_dict(_learner(d, "init_"))
    assert agent.replay_n == 64 > agent.amp_batch   # the replay joins
    seen = {}
    gae = agent._gae

    def spy(roll, last_obs):
        seen["roll"] = roll
        seen["adv"], seen["returns"] = gae(roll, last_obs)
        return seen["adv"], seen["returns"]

    agent._gae = spy
    t = lambda k: torch.as_tensor(d[k])  # noqa: E731
    m = agent.train_epoch(
        noise=t("noise"), perms=t("perms"),
        reset_draws=[(t("motion_ids")[i], t("motion_times")[i])
                     for i in range(d["noise"].shape[0])],
        amp_draws={"demo": (t("demo_ids"), t("demo_times")),
                   "replay_idx": t("replay_idx"),
                   "agent_idx": t("agent_idx")})
    return d, agent, seen, m


def _close(got, want, atol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= atol, f"{what}: max abs error {err:.3g} > {atol:.3g}"


def test_epoch_rollout_and_style_rewards(amp_epoch):
    d, _, seen, _ = amp_epoch
    roll = seen["roll"]
    for f in ("obs", "actions", "mu", "neglogp", "values", "rewards",
              "aux"):
        _close(getattr(roll, f), d[f"roll_{f}"], EPOCH_TOL[f], f)
    np.testing.assert_array_equal(roll.dones.numpy(), d["roll_dones"])
    _close(seen["adv"], d["adv"], EPOCH_TOL["adv"], "advantages")
    _close(seen["returns"], d["returns"], EPOCH_TOL["returns"], "returns")
    # rewards are the style reward alone (task_reward_w 0) and vary
    assert float(np.ptp(d["roll_rewards"])) > 0.01


def test_epoch_metrics(amp_epoch):
    d, _, _, m = amp_epoch
    keys = [k[len("metric_"):] for k in d.files if k.startswith("metric_")]
    for k in ("disc_loss", "disc_bce", "disc_grad_penalty",
              "disc_acc_agent", "disc_acc_demo", "loss", "kl"):
        assert k in keys
    for k in keys:
        if k == "frames":
            assert m[k] == int(d["metric_frames"])
            continue
        np.testing.assert_allclose(float(m[k]), float(d[f"metric_{k}"]),
                                   rtol=EPOCH_TOL["metrics_rtol"], atol=1e-6,
                                   err_msg=k)


def test_epoch_parameters_and_discriminator_after(amp_epoch):
    d, agent, _, _ = amp_epoch
    want = _learner(d, "after_")
    for which, net in (("net", agent.net), ("disc", agent.disc)):
        got = dict(net.state_dict())
        assert got.keys() == want[which].keys()
        for k, v in want[which].items():
            _close(got[k], v.numpy(), EPOCH_TOL["params"], f"{which}.{k}")


def test_epoch_normalisers_and_replay_after(amp_epoch):
    d, agent, _, _ = amp_epoch
    want = _learner(d, "after_")
    for which in ("obs_rms", "value_rms", "amp_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(
                getattr(getattr(agent, which), f).numpy(),
                want[which][f].numpy(), rtol=EPOCH_TOL["rms_rtol"],
                atol=EPOCH_TOL["rms_atol"], err_msg=f"{which}.{f}")
    n = int(d["after_replay_n"])
    assert agent.replay_n == n == 96
    _close(agent.replay[:n], d["after_replay"], EPOCH_TOL["aux"], "replay")
    _close(agent.env_state.sim.q, d["after_env_q"], 2e-4, "q after")


def test_state_dict_round_trip():
    """A checkpoint's ``state_dict`` carries the discriminator, its Adam
    state, ``amp_rms``, the replay's filled rows and the AMP history in
    the env state: the epoch after a restore is bit-equal (HumanoidAMP at
    4 envs, narrow networks)."""
    from isaacgymenvs_ma_tpu_torch.tasks.humanoid_amp import (HumanoidAMP,
                                                              TASK_CFG)
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    cfg = train_default_config("HumanoidAMP")
    cfg["params"]["config"].update(minibatch_size=16, horizon_length=4,
                                   amp_batch_size=8)
    cfg["params"]["network"]["mlp"]["units"] = [16, 8]

    def agent(seed):
        task = HumanoidAMP(deep_merge(TASK_CFG, {"env": {"numEnvs": 4}}),
                           device="cpu", seed=seed)
        a = AMPAgent(task, cfg, seed=seed)
        a.init()
        return a
    a, b = agent(1), agent(2)
    a.train_epoch()
    b.load_state_dict(a.state_dict())
    assert b.replay_n == 8
    ma, mb = a.train_epoch(), b.train_epoch()
    for k in ("disc_loss", "disc_bce", "loss", "mean_return"):
        assert float(ma[k]) == float(mb[k]), k
    for x, y in zip(a.disc.parameters(), b.disc.parameters()):
        assert torch.equal(x, y)
    assert torch.equal(a.replay[:16], b.replay[:16])
