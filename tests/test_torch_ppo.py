"""The port's PPO learner and its train entry point against the JAX package.

Each piece of isaacgymenvs_ma_tpu_torch.learning (configs, override
parser, networks and their initialisation, the gaussian helpers,
RunningMeanStd, the loss and its gradients, GAE, the multi-agent episode
striding) is held to its JAX counterpart on the same inputs, made from a
seed with numpy; then the checkpoint round trip, resume, the ``train``
entry point and the unported options.  Whole epochs are in
``test_torch_ppo_epoch.py`` (Cartpole) and ``test_torch_ppo_epoch_ant.py``.

Tolerances, float32 on both sides: network outputs rtol 1e-5 / atol 1e-6;
gaussian helpers and RunningMeanStd rtol 1e-6 / atol 1e-6 (the same
arithmetic in the same order); the loss rtol 1e-5 and each gradient tensor
within 1e-4 of that tensor's largest entry; GAE and the rollout's rewards,
values and advantages atol 1e-5; episode counts exact.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from isaacgymenvs_ma_tpu.learning import configs as jconfigs
from isaacgymenvs_ma_tpu.learning import networks as jnet
from isaacgymenvs_ma_tpu.learning.ppo import PPOAgent as JPPO
from isaacgymenvs_ma_tpu.learning.ppo import Rollout as JRollout
from isaacgymenvs_ma_tpu.learning.running_norm import RunningMeanStd as JRMS
from isaacgymenvs_ma_tpu.tasks import registry as jregistry
from isaacgymenvs_ma_tpu.tasks.base import StepResult as JStepResult
from isaacgymenvs_ma_tpu.utils import config as jconfig
from isaacgymenvs_ma_tpu_torch import train as ptrain
from isaacgymenvs_ma_tpu_torch.convert import (params_from_jax,
                                               ppo_state_from_jax)
from isaacgymenvs_ma_tpu_torch.learning import checkpoint as pckpt
from isaacgymenvs_ma_tpu_torch.learning import configs as pconfigs
from isaacgymenvs_ma_tpu_torch.learning import networks as pnet
from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
from isaacgymenvs_ma_tpu_torch.learning.ppo import Rollout as PRollout
from isaacgymenvs_ma_tpu_torch.learning.running_norm import RunningMeanStd
from isaacgymenvs_ma_tpu_torch.tasks import registry as pregistry
from isaacgymenvs_ma_tpu_torch.tasks.base import StepResult
from isaacgymenvs_ma_tpu_torch.tasks.cartpole import Cartpole, TASK_CFG
from isaacgymenvs_ma_tpu_torch.utils import config as pconfig

torch.set_num_threads(1)   # small CPU ops: one thread a test worker


# ---------------------------------------------------------------- helpers
def jax_learner_arrays(st) -> dict:
    """A JAX PPOState's learner part as ``ppo_state_from_jax`` takes it."""
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    adam = st.opt_state[1]          # (clip or identity, adam, scale)
    return {"params": tree(st.params),
            "adam": {"count": np.asarray(adam.count), "mu": tree(adam.mu),
                     "nu": tree(adam.nu)},
            "obs_rms": tree(st.obs_rms._asdict()),
            "value_rms": tree(st.value_rms._asdict()),
            "lr": np.asarray(st.lr), "epoch": int(st.epoch),
            "frames": int(st.frames), "ep_return": np.asarray(st.ep_return),
            "ep_length": np.asarray(st.ep_length),
            "mean_return": np.asarray(st.mean_return),
            "mean_length": np.asarray(st.mean_length),
            "last_obs": np.asarray(st.last_obs)}


def jax_action_noise(key, T, B, A):
    """The N(0, 1) draws of JAX ``_rollout`` from ``key`` (its
    split -> normal chain), and the key it ends with."""
    out = []
    for _ in range(T):
        key, k_act = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k_act, (B, A))))
    return torch.tensor(np.stack(out)), key


def small_train_cfg(name, **config):
    cfg = jconfigs.train_default_config(name)
    cfg["params"]["config"].update(config)
    return cfg


class _Table:
    """A fake task's per-step outputs from a numpy table: N envs, K agents
    (agent-minor rows), S steps; resets and time-outs per env, expanded to
    a row per agent as ``_to_batch`` does."""

    def __init__(self, N, K, O, A, S, seed):
        g = np.random.default_rng(seed)
        self.N, self.K, self.O, self.A, self.S = N, K, O, A, S
        B = N * K
        self.obs = g.normal(size=(S, B, O)).astype(np.float32)
        self.rew = g.normal(size=(S, B)).astype(np.float32)
        reset = np.zeros((S, N), np.int32)
        timeout = np.zeros((S, N), bool)
        # episodes end in the first half only, so the second keeps its
        # old mean_return; some of them by time-out
        if S >= 8 and N >= 4:
            for t, n in ((1, 0), (2, 2), (3, 1), (4, 0), (5, 2), (6, 3),
                         (6, 0)):
                reset[t, n] = 1
            timeout[4, 0] = timeout[6, 3] = True
        self.reset = np.repeat(reset, K, axis=1)
        self.time_outs = np.repeat(timeout, K, axis=1)
        self.cov = g.uniform(size=(S, N)).astype(np.float32)


class JaxTableTask:
    num_states = 0

    def __init__(self, tab):
        self.tab = tab
        self.num_envs, self.num_agents = tab.N, tab.K
        self.rl_games_batch = tab.N * tab.K
        self.num_obs, self.num_actions = tab.O, tab.A

    def initial_state(self, key):
        return jnp.zeros((), jnp.int32)

    def reset(self, state):
        return state, jnp.zeros((self.rl_games_batch, self.num_obs))

    def step(self, t, actions):
        tb = self.tab
        return t + 1, JStepResult(
            obs=jnp.asarray(tb.obs)[t], states=None,
            rew=jnp.asarray(tb.rew)[t], reset=jnp.asarray(tb.reset)[t],
            extras={"time_outs": jnp.asarray(tb.time_outs)[t],
                    "episode": {"coverage": jnp.asarray(tb.cov)[t]}})


class TorchTableTask:
    device = torch.device("cpu")

    def __init__(self, tab):
        self.tab = tab
        self.num_envs, self.num_agents = tab.N, tab.K
        self.rl_games_batch = tab.N * tab.K
        self.num_obs, self.num_actions = tab.O, tab.A
        self.generator = torch.Generator()

    def initial_state(self):
        return 0

    def reset(self, state):
        return state, torch.zeros((self.rl_games_batch, self.num_obs))

    def step(self, t, actions, reset_draws=None):
        tb, T = self.tab, torch.tensor
        return t + 1, StepResult(
            obs=T(tb.obs[t]), states=None, rew=T(tb.rew[t]),
            reset=T(tb.reset[t]),
            extras={"time_outs": T(tb.time_outs[t]),
                    "episode": {"coverage": T(tb.cov[t])}})


def agent_pair(tab, train_cfg, seed=0):
    """The JAX agent's initial state and a port agent loaded from it."""
    ja = JPPO(JaxTableTask(tab), train_cfg, seed=seed)
    st = ja.init()
    pa = PPOAgent(TorchTableTask(tab), train_cfg, seed=seed)
    pa.init()
    pa.load_state_dict(ppo_state_from_jax(jax_learner_arrays(st)))
    return ja, st, pa


def t2n(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------- configs
JAX_TRAIN_NAMES = sorted(jconfigs._TRAIN)


@pytest.mark.parametrize("name", JAX_TRAIN_NAMES + [
    "AntPPO", "FrankaReachMAPPO", "ShadowHandOpenAI_FFPPO", "Unlisted",
    "UnlistedPPO"])
def test_train_configs_equal_jax(name):
    assert pconfigs.train_default_config(name) == \
        jconfigs.train_default_config(name)


CLI_VALUES = ["42", "-1", "+3", "0", "017", "0x1F", "0b101", "1_000", "3e-4",
              "1.0e-3", "1.0e3", "3.", "0.5", ".5", "-.inf", "true", "False",
              "yes", "off", "null", "None", "~", "", "Ant", "cuda:0",
              "runs/Ant_01/nn/Ant.pth", "[1, 2]", "[a, b]", "[]",
              "[256, [128, 64]]", "'quoted'", '"dq"', "[1.5, true, null]",
              "[a, b", "a b", " 7 ", "08"]


def _yaml_value(s):
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def test_override_parser_equals_yaml():
    for s in CLI_VALUES:
        got, want = pconfig._parse_value(s), _yaml_value(s)
        assert got == want and type(got) is type(want), (s, got, want)
    nan = pconfig._parse_value(".nan")
    assert isinstance(nan, float) and math.isnan(nan)


def test_overrides_and_loaders_equal_jax():
    ov = ["env.numEnvs=64", "env.resetDist=2.5", "+sim.substeps=3",
          "env.newKey=[1, 2]"]
    for name in ("Cartpole", "Ant", "BallBalance", "FrankaReachMA"):
        assert pconfig.load_task_config(name, ov) == \
            jconfig.load_task_config(name, ov)
    tov = ["params.config.minibatch_size=512", "params.config.gamma=0.9",
           "params.network.mlp.units=[8, 8]"]
    assert pconfig.load_train_config("Ant", tov) == \
        jconfig.load_train_config("Ant", tov)
    g = {k: v for k, v in jconfig.GLOBAL_DEFAULTS.items()
         if k not in ("sim_device", "rl_device")}
    assert {k: v for k, v in pconfig.GLOBAL_DEFAULTS.items()
            if k not in ("sim_device", "rl_device")} == g
    assert pconfig.GLOBAL_DEFAULTS["sim_device"] == "cuda:0"
    assert pconfig.resolve_default("x", "") == "x"
    assert pconfig.resolve_default("x", "y") == "y"


def test_registry_ports_four_tasks_and_names_the_rest():
    assert pregistry.task_names() == ["AllegroHand", "AllegroHandADR",
                                      "AllegroHandDextremeADR",
                                      "AllegroHandDextremeManualDR",
                                      "AllegroHandFF", "AllegroHandLSTM",
                                      "AllegroHandLSTM_Big",
                                      "AllegroHandManualDR", "AllegroKuka", "AllegroKukaLSTM",
                                      "AllegroKukaTwoArms",
                                      "AllegroKukaTwoArmsLSTM", "Ant",
                                      "AntSAC", "Anymal", "AnymalTerrain",
                                      "BallBalance", "Cartpole",
                                      "FactoryTaskGears",
                                      "FactoryTaskInsertion",
                                      "FactoryTaskNutBoltPick",
                                      "FactoryTaskNutBoltPlace",
                                      "FactoryTaskNutBoltScrew",
                                      "FrankaCabinet", "FrankaCollectMA",
                                      "FrankaCombineMA", "FrankaCubeStack",
                                      "FrankaCubeStack2", "FrankaPPMA",
                                      "FrankaReach", "FrankaReachMA",
                                      "Humanoid", "HumanoidAMP",
                                      "HumanoidAMPHands", "HumanoidSAC",
                                      "IndustRealTaskGearsInsert",
                                      "IndustRealTaskPegsInsert",
                                      "Ingenuity", "Quadcopter",
                                      "ShadowHand", "ShadowHandOpenAI_FF",
                                      "ShadowHandOpenAI_LSTM",
                                      "ShadowHandTest", "Trifinger"]
    # all 44 names of the JAX registry
    assert pregistry.task_names() == jregistry.task_names()
    for name in sorted(jregistry._CONFIG_ONLY):
        # the config-only groups: their configs resolve, as in JAX, and
        # building one raises KeyError in both packages
        assert pregistry.task_default_config(name) == \
            jregistry.task_default_config(name)
        with pytest.raises(KeyError):
            pregistry.task_class(name)
    for name in jregistry.task_names():
        if name in pregistry.task_names():
            # a class, or the subtask resolver of the AllegroKuka names
            assert pregistry.task_class(name).__name__ == \
                jregistry.task_class(name).__name__
            continue
        with pytest.raises(NotImplementedError, match="ROADMAP queue A"):
            pregistry.task_class(name)
    with pytest.raises(KeyError):
        pregistry.task_class("NoSuchTask")
    task = pregistry.create_task(
        "Cartpole", pconfig.load_task_config("Cartpole", ["env.numEnvs=8"]),
        seed=3, device="cpu")
    assert isinstance(task, Cartpole) and task.num_envs == 8


# ---------------------------------------------------------------- networks
NETS = {  # name -> (num_obs, num_actions, network overrides)
    "cartpole": (4, 1, {"mlp": {"units": [32, 32]}}),
    "ant": (60, 8, {}),
    "franka_reach_ma": (19, 6, {}),
    "ant_separate": (60, 8, {"separate": True}),
    "ant_sigma_head": (60, 8, {"space": {"continuous": {
        "fixed_sigma": False}}}),
}


def _net_cfg(overrides):
    base = jconfigs.train_default_config("Ant")["params"]["network"]
    return jconfig.deep_merge(base, overrides)


@pytest.mark.parametrize("name", sorted(NETS))
def test_network_matches_flax(name):
    O, A, ov = NETS[name]
    net_cfg = _net_cfg(ov)
    jn = jnet.build_network(net_cfg, A)
    params = jn.init(jax.random.PRNGKey(5), jnp.zeros((1, O)))
    # move the heads off their init so every output is non-trivial
    params = jax.tree.map(
        lambda x: x + 0.05 * jnp.asarray(np.random.default_rng(x.size)
                                         .normal(size=x.shape), x.dtype),
        params)
    obs = np.random.default_rng(1).normal(size=(64, O)).astype(np.float32)
    jmu, jls, jv = jn.apply(params, jnp.asarray(obs))
    pn = pnet.build_network(net_cfg, O, A)
    pn.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        mu, ls, v = pn(torch.tensor(obs))
    for got, want in ((mu, jmu), (ls, jls), (v, jv)):
        assert got.shape == want.shape
        np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["ant_separate", "ant_sigma_head"])
def test_initialisation_distributions_match_flax(name):
    """Per Dense layer: a normal of std sqrt(scale / fan_in) cut at +-2 std
    of the un-cut normal (scale 0.01 for mu, 1 elsewhere), zero bias, and
    log_sigma = sigma_init; the port's sample std within 5 standard errors
    of flax's and of the expected value."""
    O, A, ov = NETS[name]
    net_cfg = _net_cfg(ov)
    params = jnet.build_network(net_cfg, A).init(
        jax.random.PRNGKey(11), jnp.zeros((1, O)))["params"]
    flax_w = {k: np.asarray(v) for k, v in
              params_from_jax(jax.tree.map(np.asarray, params)).items()}
    pn = pnet.build_network(net_cfg, O, A,
                            generator=torch.Generator().manual_seed(11))
    for key, p in pn.state_dict().items():
        w, fw = t2n(p), flax_w[key]
        if key == "log_sigma":
            np.testing.assert_array_equal(w, np.zeros(A, np.float32))
            np.testing.assert_array_equal(fw, w)
            continue
        if key.endswith("bias"):
            assert not w.any() and not fw.any(), key
            continue
        fan_in = w.shape[1]
        scale = 0.01 if key.startswith("mu.") else 1.0
        want = math.sqrt(scale / fan_in)
        cut = 2.0 * want / 0.87962566103423978
        se = 5.0 / math.sqrt(2 * w.size)
        for x in (w, fw):
            assert np.abs(x).max() <= cut * (1 + 1e-6), key
            assert abs(x.std() / want - 1) <= se, (key, x.std(), want)
            if x.size >= 4096:          # the tail reaches the cut
                assert np.abs(x).max() >= 0.95 * cut, key
        assert abs(w.std() / fw.std() - 1) <= 2 * se, key


def test_gaussian_helpers_match():
    g = np.random.default_rng(2)
    mu0, mu1, a = (g.normal(size=(32, 6)).astype(np.float32)
                   for _ in range(3))
    ls0, ls1 = (g.uniform(-1, 0.5, (32, 6)).astype(np.float32)
                for _ in range(2))
    T, J = torch.tensor, jnp.asarray
    pairs = ((pnet.gaussian_neglogp(T(mu0), T(ls0), T(a)),
              jnet.gaussian_neglogp(J(mu0), J(ls0), J(a))),
             (pnet.gaussian_entropy(T(ls0)), jnet.gaussian_entropy(J(ls0))),
             (pnet.gaussian_kl(T(mu0), T(ls0), T(mu1), T(ls1)),
              jnet.gaussian_kl(J(mu0), J(ls0), J(mu1), J(ls1))))
    for got, want in pairs:
        np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_running_mean_std_matches():
    g = np.random.default_rng(4)
    pr, jr = RunningMeanStd((5,)), JRMS.create((5,))
    pv, jv = RunningMeanStd(()), JRMS.create(())
    for i, shape in enumerate(((16, 7, 5), (3, 5), (64, 5))):
        x = (g.normal(size=shape) * (i + 1) + i).astype(np.float32)
        pr.update(torch.tensor(x))
        jr = jr.update(jnp.asarray(x))
        y = x[..., 0].reshape(-1)
        pv.update(torch.tensor(y))
        jv = jv.update(jnp.asarray(y))
    for p, j in ((pr, jr), (pv, jv)):
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(t2n(getattr(p, k)),
                                       np.asarray(getattr(j, k)), rtol=1e-6)
    x = g.normal(size=(8, 5)).astype(np.float32) * 4
    np.testing.assert_allclose(t2n(pr.normalize(torch.tensor(x))),
                               np.asarray(jr.normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        t2n(pv.normalize(torch.tensor(x), clip=1e8)),
        np.asarray(jv.normalize(jnp.asarray(x), clip=1e8)), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(t2n(pr.denormalize(torch.tensor(x))),
                               np.asarray(jr.denormalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- loss, GAE
def test_loss_and_gradients_match_jax():
    """One Ant-width minibatch (60 obs -> 256-128-64 -> 8, 256 rows) with
    clipped ratios, clipped values and mu past +-1.1 (bounds loss)."""
    tab = _Table(N=64, K=1, O=60, A=8, S=2, seed=8)
    tcfg = small_train_cfg("Ant", minibatch_size=32)
    ja, st, pa = agent_pair(tab, tcfg)
    p = jax.tree.map(lambda x: x, st.params)
    p["params"]["mu"]["bias"] = jnp.asarray(
        [1.2, -1.2, 1.05, -1.05, 0.0, 0.0, 0.5, -1.3], jnp.float32)
    pa.net.load_state_dict(params_from_jax(jax.tree.map(np.asarray, p)))
    g = np.random.default_rng(9)
    n = 256
    obs = np.clip(g.normal(size=(n, 60)), -5, 5).astype(np.float32)
    mu, ls, v = (np.asarray(x) for x in ja.net.apply(p, jnp.asarray(obs)))
    actions = (mu + np.exp(ls) * g.normal(size=mu.shape)).astype(np.float32)
    neglogp = np.asarray(jnet.gaussian_neglogp(mu, ls, actions))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    mb = [obs, actions, f32(neglogp + g.uniform(-0.5, 0.5, n)),
          f32(v + g.uniform(-0.4, 0.4, n)), f32(g.normal(size=n)),
          f32(v + g.normal(size=n)),
          f32(mu + 0.1 * g.normal(size=mu.shape)),
          f32(np.exp(ls) * g.uniform(0.8, 1.2, mu.shape))]
    jmb = (mb[0], np.zeros((n, 0), np.float32), *mb[1:])
    (jl, jaux), jg = jax.value_and_grad(ja._loss, has_aux=True)(
        p, tuple(jnp.asarray(x) for x in jmb), st.value_rms)
    ratio = np.exp(mb[2] - np.asarray(jnet.gaussian_neglogp(mu, ls, actions)))
    assert ((ratio < 0.8) | (ratio > 1.2)).any()
    assert (np.abs(mb[3] - v) > 0.2).any() and (np.abs(mu) > 1.1).any()

    pa.net.zero_grad()
    loss, aux = pa._loss(tuple(torch.tensor(x) for x in mb))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for got, want in zip(aux, jaux):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, atol=1e-7)
    jgrads = params_from_jax(jax.tree.map(np.asarray, jg))
    for name, prm in pa.net.named_parameters():
        want = t2n(jgrads[name])
        err = np.abs(t2n(prm.grad) - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


def test_gae_matches_jax():
    T, B = 8, 12
    tab = _Table(N=B, K=1, O=5, A=2, S=T, seed=3)
    tcfg = small_train_cfg("Cartpole", horizon_length=T, minibatch_size=B)
    ja, st, pa = agent_pair(tab, tcfg)
    g = np.random.default_rng(6)
    rew = g.normal(size=(T, B)).astype(np.float32)
    done = g.uniform(size=(T, B)) < 0.2
    val = g.normal(size=(T, B)).astype(np.float32)
    last = g.normal(size=(B, 5)).astype(np.float32)
    z = np.zeros((T, B, 2), np.float32)
    jroll = JRollout(obs=None, states=(), carry=(), actions=z, neglogp=val,
                     values=jnp.asarray(val), rewards=jnp.asarray(rew),
                     dones=jnp.asarray(done), mu=z, sigma=z)
    jadv, jret = ja._gae(st, jroll, jnp.asarray(last))
    T_ = torch.tensor
    proll = PRollout(obs=None, actions=T_(z), neglogp=T_(val),
                     values=T_(val), rewards=T_(rew), dones=T_(done),
                     mu=T_(z), sigma=T_(z))
    adv, ret = pa._gae(proll, T_(last))
    np.testing.assert_allclose(t2n(adv), np.asarray(jadv), atol=1e-5)
    np.testing.assert_allclose(t2n(ret), np.asarray(jret), atol=1e-5)


def test_multi_agent_striding_matches_jax():
    """A fake task with 4 envs x 2 agents from a numpy table (rewards per
    agent row, resets and time-outs per env), two rollouts of 8 steps with
    value bootstrap: episode counts, mean return and length (the second
    rollout finishes no episode and keeps them), rewards, values,
    advantages and the ``episode/`` extras as in JAX."""
    T = 8
    tab = _Table(N=4, K=2, O=6, A=3, S=2 * T, seed=12)
    tcfg = small_train_cfg("FrankaReachMA", horizon_length=T,
                           minibatch_size=16, value_bootstrap=True)
    tcfg["params"]["network"]["mlp"]["units"] = [16, 16]
    ja, st, pa = agent_pair(tab, tcfg)
    rollout = jax.jit(ja._rollout)
    key = st.key
    for window in range(2):
        noise, key = jax_action_noise(key, T, 8, 3)
        st, jroll, jlast, jstats = rollout(st)
        jadv, jret = ja._gae(st, jroll, jlast)
        roll, last, stats = pa._rollout(noise)
        adv, ret = pa._gae(roll, last)
        assert float(stats["episodes_done"]) == float(jstats["episodes_done"])
        assert float(stats["episodes_done"]) == (7.0 if window == 0 else 0.0)
        for got, want in ((pa.mean_return, st.mean_return),
                          (pa.mean_length, st.mean_length),
                          (pa.ep_return, st.ep_return),
                          (pa.ep_length, st.ep_length),
                          (roll.rewards, jroll.rewards),
                          (roll.values, jroll.values),
                          (adv, jadv), (ret, jret),
                          (stats["episode/episode/coverage"],
                           jstats["episode/episode/coverage"])):
            np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5)
        np.testing.assert_array_equal(t2n(roll.dones), np.asarray(jroll.dones))
    assert float(pa.mean_length) > 0


def test_adaptive_lr_schedule_on_given_kls():
    """The schedule alone: JAX's rule (ppo.py:552-556) on KL values below,
    between and above the thresholds (and at them), from the floor and the
    cap, against the port's update after a minibatch."""
    thr = 0.008
    kls = np.float32([0.0, 0.001, 0.004, 0.0039, 0.01, 0.016, 0.0161, 0.5])
    lrs = np.float32([3e-4, 1e-6, 1e-2, 8e-3, 1.2e-6])
    tab = _Table(N=4, K=1, O=3, A=1, S=2, seed=1)
    pa = PPOAgent(TorchTableTask(tab), small_train_cfg(
        "Cartpole", horizon_length=2, minibatch_size=8), seed=0)
    pa.init()
    for lr0 in map(jnp.asarray, lrs):
        for kl in map(jnp.asarray, kls):       # float32 compares, as in JAX
            lr = jnp.where(kl > 2.0 * thr, jnp.maximum(lr0 / 1.5, 1e-6), lr0)
            lr = jnp.where(kl < 0.5 * thr, jnp.minimum(lr * 1.5, 1e-2), lr)
            got = pa._adaptive_lr(torch.tensor(np.asarray(lr0)),
                                  torch.tensor(np.asarray(kl)))
            np.testing.assert_allclose(float(got), float(lr), rtol=1e-6)


# ---------------------------------------------------------------- checkpoint
def _cartpole_agent(seed=5):
    cfg = pconfig.deep_merge(TASK_CFG, {"env": {"numEnvs": 64}})
    task = Cartpole(cfg, device="cpu", seed=seed)
    tcfg = pconfigs.train_default_config("Cartpole")
    tcfg["params"]["config"]["minibatch_size"] = 512
    agent = PPOAgent(task, tcfg, seed=seed)
    agent.init()
    return agent


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_checkpoint_round_trip_and_exact_resume(tmp_path):
    straight = _cartpole_agent()
    m_straight = [straight.train_epoch() for _ in range(2)][-1]

    first = _cartpole_agent()
    first.train_epoch()
    path = str(tmp_path / "nn" / "Cartpole.pth")
    pckpt.save_checkpoint(path, first.state_dict(), meta={"epoch": 1})
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    state, extra, meta = pckpt.load_checkpoint(path)
    assert extra is None and meta == {"epoch": 1}
    resumed = _cartpole_agent()
    resumed.load_state_dict(state)
    a, b = _flat(first.state_dict()), _flat(resumed.state_dict())
    assert a.keys() == b.keys()
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    m_resumed = resumed.train_epoch()
    for k, v in m_straight.items():
        assert float(v) == float(m_resumed[k]), k
    for (k, p), q in zip(straight.net.named_parameters(),
                         resumed.net.parameters()):
        assert torch.equal(p, q), k
    assert torch.equal(straight.env_state.sim.q, resumed.env_state.sim.q)


# ---------------------------------------------------------------- entry point
def test_launch_trains_saves_and_plays(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ptrain, "PLAY_STEPS", 200)
    args = ["task=Cartpole", "num_envs=64", "max_iterations=2",
            "train.params.config.minibatch_size=512", "sim_device=cpu",
            "log_interval=1"]
    agent = ptrain.launch(args)
    out = capsys.readouterr().out
    assert "epoch 1/2 reward" in out and "epoch 2/2 reward" in out
    assert " sig " in out and " fps " in out
    ckpts = list((tmp_path / "runs").glob("Cartpole_*/nn/Cartpole.pth"))
    assert len(ckpts) == 1 and agent.epoch == 2
    played = ptrain.launch(args + ["test=True", f"checkpoint={ckpts[0]}",
                                   "sigma=0.5"])
    out = capsys.readouterr().out
    assert "restored checkpoint" in out and "step 200:" in out
    assert torch.allclose(played.net.log_sigma,
                          torch.full((1,), math.log(0.5)))
    for k, v in agent.net.state_dict().items():
        if k != "log_sigma":
            assert torch.equal(v, played.net.state_dict()[k]), k


@pytest.mark.parametrize("flag", ["multi_gpu=True", "pbt.enabled=True",
                                  "capture_video=True", "wandb_activate=True",
                                  "headless=False",
                                  "task=FactoryTaskNutBoltPick",
                                  "task=IndustRealTaskGearsInsert",
                                  "train=HumanoidAMP",
                                  "train=AntSAC"])
def test_unported_flags_and_names_raise(flag, tmp_path, monkeypatch):
    """Flags and names that raised until they were ported.  The flags
    ``multi_gpu``, ``pbt.enabled``, ``capture_video``, ``wandb_activate``
    and ``headless=False`` raised until ROADMAP queue A item 11 was
    ported: now ``multi_gpu`` without torchrun's variables raises naming
    torchrun, and the others train one epoch at 8 envs (PBT writes a
    checkpoint with its json meta, the video its frames, the W&B observer
    warns that wandb is missing).  The Factory and IndustReal names
    raised until ROADMAP queue A item 9 was ported: now the entry point
    trains them (one epoch of 8 steps at 8 envs) and saves a checkpoint.
    The AMP and SAC train configs raised until item 10 was: now the entry
    point runs the AMP learner on HumanoidAMP (one epoch of 4 steps at 4
    envs) and SAC on Cartpole (one epoch of 8 steps, 3 of them updates),
    saves a checkpoint, and refuses the AMP learner on a task without AMP
    observations."""
    monkeypatch.chdir(tmp_path)
    args = ["task=Cartpole", "num_envs=8", "sim_device=cpu", flag]
    if flag.startswith("task=") and flag[5:] in pregistry.task_names():
        ptrain.launch(args + ["max_iterations=1",
                              "train.params.config.horizon_length=8",
                              "train.params.config.minibatch_size=64"])
        name = flag[5:]
        assert list(tmp_path.glob(f"runs/{name}_*/nn/{name}.pth"))
        return
    if flag == "train=HumanoidAMP":
        with pytest.raises(ValueError, match="AMP observations"):
            ptrain.launch(args)
        agent = ptrain.launch([
            "task=HumanoidAMP", "num_envs=4", "sim_device=cpu", flag,
            "max_iterations=1", "train.params.config.horizon_length=4",
            "train.params.config.minibatch_size=16",
            "train.params.config.amp_batch_size=8",
            "train.params.network.mlp.units=[16,8]"])
        assert agent.replay_n == 8
        assert list(tmp_path.glob("runs/HumanoidAMP_*/nn/HumanoidAMP.pth"))
        return
    if flag == "train=AntSAC":
        agent = ptrain.launch(args + [
            "max_iterations=1", "train.params.config.batch_size=16",
            "train.params.config.replay_buffer_size=256",
            "train.params.network.mlp.units=[16,8]"])
        assert agent.step == 8
        assert list(tmp_path.glob("runs/AntSAC_*/nn/AntSAC.pth"))
        return
    if flag == "multi_gpu=True":
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT"):
            monkeypatch.delenv(k, raising=False)
        with pytest.raises(RuntimeError, match="torchrun"):
            ptrain.launch(args)
        return
    extra = {"pbt.enabled=True": [f"pbt.workspace={tmp_path / 'ws'}",
                                  "pbt.interval_steps=1"],
             "capture_video=True": ["capture_video_freq=1",
                                    "capture_video_len=2"]}.get(flag, [])
    agent = ptrain.launch(args + extra + [
        "max_iterations=1", "train.params.config.horizon_length=8",
        "train.params.config.minibatch_size=64"])
    assert agent.epoch == 1
    assert list(tmp_path.glob("runs/Cartpole_*/nn/Cartpole.pth"))
    if flag == "pbt.enabled=True":
        assert list((tmp_path / "ws" / "policy_00").glob("*.ckpt.json"))
    if flag == "capture_video=True":
        assert list(tmp_path.glob("runs/Cartpole_*/videos/*"))


def test_make_and_launch_run_on_the_card_by_default(tmp_path, monkeypatch):
    """``api.make`` builds the task on ``sim_device``; without it, and the
    train entry point without ``sim_device=``, ask for the card and raise
    where there is none."""
    from isaacgymenvs_ma_tpu_torch import api
    task = api.make(seed=1, task="Cartpole", num_envs=8, sim_device="cpu")
    assert isinstance(task, Cartpole) and task.num_envs == 8
    assert task.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.make(seed=1, task="Cartpole", num_envs=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ptrain.launch(["task=Cartpole", "num_envs=8"])
