"""One whole PPO epoch of the port against the JAX ``PPOAgent``: Cartpole
at 64 envs (horizon 16, minibatch 512, 8 mini-epochs: 16 updates).  The
Ant epoch (16 envs at the full network width) is in
``test_torch_ppo_epoch_ant.py`` and uses ``run_epoch_pair`` from here.

JAX's random streams cannot be matched in torch, so (ISSUE trap 1):
1. the JAX agent runs its first epoch, which gets past the reset of every
   env on step 1 and leaves Adam and the normalisers at non-trivial values;
2. its state goes to the port (``env_state_from_jax``'s arrays and
   ``ppo_state_from_jax``);
3. both run the second epoch, the port with JAX's draws rebuilt from its
   keys: the action noise (``_rollout``'s split -> normal chain), every
   step's reset draws (``task.step``'s split(rng, 6)[1] chain; Cartpole
   resets some 30 envs in this window) and the minibatch permutations
   (``_train_epoch``'s split -> split(k_perm, mini_epochs) ->
   permutation chain).

Compared: the rollout (obs, actions, mu, neglogp, values, rewards, dones),
advantages and returns, the epoch's metrics, ``lr``, the parameters and
the normalisers after the epoch.  ``lr`` is held at rtol 1e-6, not
exactly: XLA turns ``lr / 1.5`` into ``lr * (1 / 1.5)``, which rounds
otherwise in a third of cases, while a different up/down sequence would
move it by a factor of 1.5.  The parameter bound is far below one Adam
step (``lr``): a gradient entry whose sign differed between the packages
would move a parameter by up to 2 lr and fail it.
"""
import jax
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.learning.configs import train_default_config
from isaacgymenvs_ma_tpu.learning.ppo import PPOAgent as JPPO
from isaacgymenvs_ma_tpu.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.convert import ppo_state_from_jax
from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent

from test_torch_ppo import jax_action_noise, jax_learner_arrays

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

# Measured on the CPU at Cartpole-64, seed 3: obs 2.9e-5, actions and mu
# 4.8e-7, neglogp 9.5e-7, values 2.8e-6, rewards 2.6e-7, advantages 2.5e-6,
# returns 3.1e-6, metrics <= 2.2e-7 apart, parameters 2.4e-7, normalisers
# 1.8e-7.  obs at CARTPOLE_GOLDEN_TOL's 2e-3, rewards at its 2e-4 times
# the reward scale 0.1; the rest 10-40x the measured error.
CARTPOLE_TOL = {"obs": 2e-3, "actions": 1e-5, "mu": 1e-5, "neglogp": 1e-5,
                "values": 1e-4, "rewards": 2e-5, "adv": 1e-4,
                "returns": 1e-4, "metrics_rtol": 1e-4, "params": 5e-6,
                "rms_rtol": 1e-5}
METRICS = ("loss", "a_loss", "c_loss", "entropy", "kl", "mean_return",
           "mean_length", "sigma", "episodes_done")


def cartpole_draws(k1, k2, n):
    u = lambda k: jax.random.uniform(k, (n, 2))  # noqa: E731
    return 0.2 * (u(k1) - 0.5), 0.5 * (u(k2) - 0.5)


def jax_reset_draws(rng, T, n, draw):
    """Every step's reset draws of T JAX ``task.step`` calls from the env
    rng ``rng`` (base.py:229: key, k_reset = split(rng, 6)[:2])."""
    out = []
    for _ in range(T):
        ks = jax.random.split(rng, 6)
        rng = ks[0]
        k1, k2 = jax.random.split(ks[1])
        out.append(tuple(torch.tensor(np.asarray(x))
                         for x in draw(k1, k2, n)))
    return out


def run_epoch_pair(jcls, jcfg, pcls, pcfg, name, n, minibatch, seed, draw):
    """JAX epochs 1-2 and the port's epoch 2 from JAX's state after epoch
    1; returns {"jax": ..., "port": ...} of the second epoch."""
    tcfg = train_default_config(name)
    tcfg["params"]["config"]["minibatch_size"] = minibatch
    jtask = jcls(deep_merge(jcfg, {"env": {"numEnvs": n}}))
    ja = JPPO(jtask, tcfg, seed=seed)
    st, _ = ja.train_epoch(ja.init())

    @jax.jit
    def rollout_gae(state):
        s2, roll, last_obs, stats = ja._rollout(state)
        adv, ret = ja._gae(s2, roll, last_obs)
        return roll, adv, ret
    jroll, jadv, jret = rollout_gae(st)
    st2, jm = ja.train_epoch(st)

    T, B, A = ja.horizon, jtask.rl_games_batch, jtask.num_actions
    noise, key = jax_action_noise(st.key, T, B, A)
    _, k_perm = jax.random.split(key)
    perms = torch.tensor(np.stack([
        np.asarray(jax.random.permutation(k, T * B))
        for k in jax.random.split(k_perm, ja.cfg.mini_epochs)]))
    es = st.env_state
    draws = jax_reset_draws(es.rng, T, n, draw)

    ptask = pcls(deep_merge(pcfg, {"env": {"numEnvs": n}}), device="cpu",
                 seed=seed)
    pa = PPOAgent(ptask, tcfg, seed=seed)
    pa.init()
    d = ppo_state_from_jax(jax_learner_arrays(st))
    d["env_state"] = {"sim.q": np.asarray(es.sim.q),
                      "sim.qd": np.asarray(es.sim.qd),
                      "progress": np.asarray(es.progress),
                      "reset_buf": np.asarray(es.reset_buf)}
    if es.task is not None:
        d["env_state"].update({f"task.{f}": np.asarray(v)
                               for f, v in es.task._asdict().items()})
    pa.load_state_dict(d)
    roll, last_obs, stats = pa._rollout(noise, draws)
    adv, ret = pa._gae(roll, last_obs)
    pm = pa._update(roll, adv, ret, perms)
    pm["episodes_done"] = stats["episodes_done"]
    jnet = ppo_state_from_jax({**jax_learner_arrays(st2)})["net"]
    return {"jax": dict(roll=jroll, adv=jadv, ret=jret, metrics=jm,
                        net=jnet, obs_rms=st2.obs_rms,
                        value_rms=st2.value_rms),
            "port": dict(roll=roll, adv=adv, ret=ret, metrics=pm,
                         net=dict(pa.net.state_dict()), obs_rms=pa.obs_rms,
                         value_rms=pa.value_rms)}


def _close(got, want, atol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= atol, f"{what}: max abs error {err:.3g} > {atol:.3g}"


def check_rollout(r, tol):
    j, p = r["jax"]["roll"], r["port"]["roll"]
    for f in ("obs", "actions", "mu", "neglogp", "values", "rewards"):
        _close(getattr(p, f), getattr(j, f), tol[f], f)
    np.testing.assert_array_equal(p.dones.numpy(), np.asarray(j.dones))
    np.testing.assert_array_equal(p.sigma.numpy(), np.asarray(j.sigma))


def check_gae(r, tol):
    _close(r["port"]["adv"], r["jax"]["adv"], tol["adv"], "advantages")
    _close(r["port"]["ret"], r["jax"]["ret"], tol["returns"], "returns")


def check_metrics(r, tol):
    j, p = r["jax"]["metrics"], r["port"]["metrics"]
    for k in METRICS:
        np.testing.assert_allclose(float(p[k]), float(j[k]),
                                   rtol=tol["metrics_rtol"], atol=1e-6,
                                   err_msg=k)
    assert p["frames"] == int(j["frames"])
    np.testing.assert_allclose(float(p["lr"]), float(j["lr"]), rtol=1e-6)


def check_params(r, tol):
    j, p = r["jax"]["net"], r["port"]["net"]
    assert j.keys() == p.keys()
    for k in j:
        _close(p[k], j[k].numpy(), tol["params"], k)


def check_normalisers(r, tol):
    for which in ("obs_rms", "value_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(
                getattr(r["port"][which], f).numpy(),
                np.asarray(getattr(r["jax"][which], f)),
                rtol=tol["rms_rtol"], atol=1e-6, err_msg=f"{which}.{f}")


@pytest.fixture(scope="module")
def cartpole_epoch():
    from isaacgymenvs_ma_tpu.tasks.cartpole import Cartpole as JCartpole
    from isaacgymenvs_ma_tpu.tasks.cartpole import TASK_CFG as JCFG
    from isaacgymenvs_ma_tpu_torch.tasks.cartpole import Cartpole, TASK_CFG
    return run_epoch_pair(JCartpole, JCFG, Cartpole, TASK_CFG, "Cartpole",
                          n=64, minibatch=512, seed=3, draw=cartpole_draws)


def test_cartpole_rollout(cartpole_epoch):
    check_rollout(cartpole_epoch, CARTPOLE_TOL)
    # the window resets envs through the injected draws
    assert int(cartpole_epoch["port"]["roll"].dones.sum()) > 0


def test_cartpole_advantages_and_returns(cartpole_epoch):
    check_gae(cartpole_epoch, CARTPOLE_TOL)


def test_cartpole_epoch_metrics_and_lr(cartpole_epoch):
    check_metrics(cartpole_epoch, CARTPOLE_TOL)


def test_cartpole_parameters_after_epoch(cartpole_epoch):
    check_params(cartpole_epoch, CARTPOLE_TOL)


def test_cartpole_normalisers_after_epoch(cartpole_epoch):
    check_normalisers(cartpole_epoch, CARTPOLE_TOL)
