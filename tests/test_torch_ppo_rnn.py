"""The learner's recurrent and asymmetric paths against the JAX package.

* Networks: ``ActorCriticLSTM`` (flax's ``OptimizedLSTMCell`` semantics:
  gates i, f, g, o, no input bias) and ``AsymActorCritic`` /
  ``CentralValueNet`` give the flax modules' outputs with the parameters
  carried across by ``params_from_jax``; their initialisation follows
  flax's (lecun-normal kernels, orthogonal recurrent blocks, zero
  biases).  The LSTM config's ``layer_norm`` / ``before_mlp`` change
  nothing, as in JAX.
* Losses: the truncated-BPTT loss over sequences and the central-value
  loss, and their gradients, against JAX's ``_loss_rnn`` / ``_loss``.
* One whole epoch each, with JAX's draws injected after its first epoch
  (as ``test_torch_ppo_epoch.py``): Cartpole-64 with a 16-unit LSTM and
  ``seq_len`` 4, and the central value on ``ToyTask`` of
  ``tests/test_ppo_variants.py`` (16 envs, 6 privileged states), whose
  second epoch ends every episode on its last step.

Tolerances, float32 on both sides: network outputs rtol 1e-5 / atol 1e-6;
the losses rtol 1e-5 and each gradient tensor within 1e-4 of that
tensor's largest entry (as ``test_torch_ppo.py``); the epochs at
``test_torch_ppo_epoch.CARTPOLE_TOL`` (measured errors in the constants
below).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.learning import networks as jnet
from isaacgymenvs_ma_tpu.learning.configs import train_default_config
from isaacgymenvs_ma_tpu.learning.ppo import PPOAgent as JPPO
from isaacgymenvs_ma_tpu.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.convert import (params_from_jax,
                                               ppo_state_from_jax)
from isaacgymenvs_ma_tpu_torch.learning import networks as pnet
from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
from isaacgymenvs_ma_tpu_torch.tasks.base import StepResult

from test_ppo_variants import ToyTask
from test_torch_ppo import jax_action_noise, jax_learner_arrays, t2n
from test_torch_ppo_epoch import (CARTPOLE_TOL, cartpole_draws, check_gae,
                                  check_metrics, check_normalisers,
                                  check_params, check_rollout,
                                  jax_reset_draws)

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

LSTM_NET = {"mlp": {"units": [32, 16]},
            "rnn": {"name": "lstm", "units": 16, "layers": 1,
                    "before_mlp": True, "concat_input": True,
                    "layer_norm": True}}
CV_CONFIG = {"network": {"mlp": {"units": [32, 16]}}, "learning_rate": 1e-3}


def _perturbed(params):
    """Parameters moved off their initialisation so every output, gate and
    bias is non-trivial."""
    return jax.tree.map(
        lambda x: x + 0.1 * jnp.asarray(np.random.default_rng(x.size)
                                        .normal(size=x.shape), x.dtype),
        params)


def _net_cfg(overrides):
    return deep_merge(train_default_config("Ant")["params"]["network"],
                      overrides)


def _close(got, want, what, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------- networks
@pytest.mark.parametrize("fixed_sigma", [True, False])
def test_lstm_network_matches_flax(fixed_sigma):
    O, A, H = 9, 3, 16
    cfg = _net_cfg(deep_merge(LSTM_NET, {"space": {"continuous": {
        "fixed_sigma": fixed_sigma}}}))
    jn = jnet.ActorCriticLSTM(num_actions=A, units=(32, 16), lstm_units=H,
                              fixed_sigma=fixed_sigma)
    params = _perturbed(jn.init(jax.random.PRNGKey(3), jnp.zeros((1, O)),
                                jn.initial_carry(1)))
    g = np.random.default_rng(4)
    obs = g.normal(size=(64, O)).astype(np.float32)
    h, c = (g.normal(size=(64, H)).astype(np.float32) for _ in range(2))
    jmu, jls, jv, (jh, jc) = jn.apply(params, jnp.asarray(obs),
                                      (jnp.asarray(h), jnp.asarray(c)))
    pn = pnet.build_network(cfg, O, A)
    assert isinstance(pn, pnet.ActorCriticLSTM) and pn.lstm.ih.bias is None
    pn.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        mu, ls, v, (ph, pc) = pn(torch.tensor(obs),
                                 (torch.tensor(h), torch.tensor(c)))
    for got, want, what in ((mu, jmu, "mu"), (ls, jls, "log_sigma"),
                            (v, jv, "value"), (ph, jh, "h"), (pc, jc, "c")):
        assert got.shape == want.shape, what
        _close(got, want, what)


def test_lstm_carry_over_steps_matches_flax():
    """Eight steps from a zero carry (``initial_carry``), each step's
    outputs and carry."""
    O, A, H = 5, 2, 16
    jn = jnet.ActorCriticLSTM(num_actions=A, units=(32, 16), lstm_units=H)
    params = _perturbed(jn.init(jax.random.PRNGKey(0), jnp.zeros((1, O)),
                                jn.initial_carry(1)))
    pn = pnet.build_network(_net_cfg(LSTM_NET), O, A)
    pn.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    obs = np.random.default_rng(1).normal(size=(8, 12, O)).astype(np.float32)
    jcarry, pcarry = jn.initial_carry(12), pn.initial_carry(12)
    for t in range(8):
        jmu, _, jv, jcarry = jn.apply(params, jnp.asarray(obs[t]), jcarry)
        with torch.no_grad():
            mu, _, v, pcarry = pn(torch.tensor(obs[t]), pcarry)
        _close(mu, jmu, f"mu {t}")
        _close(v, jv, f"value {t}")
        for got, want in zip(pcarry, jcarry):
            _close(got, want, f"carry {t}")


def test_lstm_initialisation_follows_flax():
    """No input bias; the input kernel lecun-normal (std sqrt(1/in) cut at
    2 std); each gate's recurrent block orthogonal, as flax's; biases 0."""
    O, A, H = 40, 4, 64
    pn = pnet.build_network(_net_cfg(deep_merge(LSTM_NET, {
        "rnn": {"units": H}})), O, A,
        generator=torch.Generator().manual_seed(2))
    names = {k for k, _ in pn.named_parameters()}
    assert {"lstm.ih.weight", "lstm.hh.weight", "lstm.hh.bias"} <= names
    assert "lstm.ih.bias" not in names
    jn = jnet.ActorCriticLSTM(num_actions=A, units=(32, 16), lstm_units=H)
    jp = params_from_jax(jax.tree.map(np.asarray, jn.init(
        jax.random.PRNGKey(2), jnp.zeros((1, O)), jn.initial_carry(1))))
    for w in (pn.lstm.hh.weight.detach(), jp["lstm.hh.weight"]):
        for blk in w.view(4, H, H):
            np.testing.assert_allclose(t2n(blk @ blk.T), np.eye(H),
                                       atol=1e-5)
    assert not pn.lstm.hh.bias.any() and not jp["lstm.hh.bias"].any()
    std = np.sqrt(1.0 / 16)
    for w in (t2n(pn.lstm.ih.weight), t2n(jp["lstm.ih.weight"])):
        assert w.shape == (4 * H, 16)
        assert abs(w.std() / std - 1) < 0.05
        assert np.abs(w).max() <= 2 * std / 0.87962566103423978 * (1 + 1e-6)


@pytest.mark.parametrize("fixed_sigma", [True, False])
def test_asymmetric_networks_match_flax(fixed_sigma):
    O, S, A = 7, 11, 3
    jn = jnet.AsymActorCritic(num_actions=A, units=(32, 16),
                              cv_units=(24, 8), fixed_sigma=fixed_sigma)
    params = _perturbed(jn.init(jax.random.PRNGKey(5), jnp.zeros((1, O)),
                                jnp.zeros((1, S))))
    g = np.random.default_rng(6)
    obs = g.normal(size=(32, O)).astype(np.float32)
    st = g.normal(size=(32, S)).astype(np.float32)
    jout = jn.apply(params, jnp.asarray(obs), jnp.asarray(st))
    cfg = _net_cfg({"mlp": {"units": [32, 16]}, "space": {"continuous": {
        "fixed_sigma": fixed_sigma}}})
    pn = pnet.build_network(cfg, O, A, central_value_config={
        "network": {"mlp": {"units": [24, 8]}}}, num_states=S)
    assert isinstance(pn, pnet.AsymActorCritic)
    pn.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        out = pn(torch.tensor(obs), torch.tensor(st))
    for got, want, what in zip(out, jout, ("mu", "log_sigma", "value")):
        _close(got, want, what)
    # the critic reads the states only
    with torch.no_grad():
        v2 = pn(torch.tensor(obs) + 1.0, torch.tensor(st))[2]
    assert torch.equal(v2, out[2])
    # without privileged states the plain network is built
    assert isinstance(pnet.build_network(cfg, O, A, central_value_config={
        "network": {}}, num_states=0), pnet.ActorCritic)

    jcv = jnet.CentralValueNet(units=(24, 8))
    cvp = _perturbed(jcv.init(jax.random.PRNGKey(7), jnp.zeros((1, S))))
    pcv = pnet.CentralValueNet(S, (24, 8))
    pcv.load_state_dict(params_from_jax(jax.tree.map(np.asarray, cvp)))
    with torch.no_grad():
        _close(pcv(torch.tensor(st)), jcv.apply(cvp, jnp.asarray(st)),
               "central value")


# ---------------------------------------------------------------- losses
class _NullTask:
    """Just the sizes an agent is built from."""

    num_envs = rl_games_batch = 16
    num_agents = 1
    device = torch.device("cpu")

    def __init__(self, O, A, S=0):
        self.num_obs, self.num_actions, self.num_states = O, A, S


def _loss_cfg(**net):
    cfg = train_default_config("Cartpole")
    c = cfg["params"]["config"]
    c.update(horizon_length=8, minibatch_size=32, seq_len=4)
    cfg["params"]["network"].update(net)
    return cfg


def _push_mu(params, A):
    """The mu head's bias past +-1.1 in some actions (the bounds loss)."""
    p = jax.tree.map(lambda x: x, params)
    p["params"]["mu"]["bias"] = jnp.asarray([1.3, -1.3, 0.2][:A])
    return p


def _loss_batch(g, mu, ls, v):
    """A minibatch's actions and old policy outputs from the current
    policy's (``mu``, ``log_sigma``, ``value``), moved off it so that
    ratios clip, values clip and mu passes +-1.1 (bounds loss)."""
    mu, ls, v = (np.asarray(x) for x in (mu, ls, v))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    actions = f32(mu + np.exp(ls) * g.normal(size=mu.shape))
    neglogp = np.asarray(jnet.gaussian_neglogp(mu, ls, actions))
    shp = v.shape
    return [actions, f32(neglogp + g.uniform(-0.5, 0.5, shp)),
            f32(v + g.uniform(-0.4, 0.4, shp)), f32(g.normal(size=shp)),
            f32(v + g.normal(size=shp)),
            f32(mu + 0.1 * g.normal(size=mu.shape)),
            f32(np.exp(ls) * g.uniform(0.8, 1.2, mu.shape))]


def _check_loss(pa, jl, jaux, jg, loss, aux):
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for got, want in zip(aux, jaux):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, atol=1e-7)
    jgrads = params_from_jax(jax.tree.map(np.asarray, jg))
    assert jgrads.keys() == dict(pa.net.named_parameters()).keys()
    for name, prm in pa.net.named_parameters():
        want = t2n(jgrads[name])
        err = np.abs(t2n(prm.grad) - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)


def test_bptt_loss_and_gradients_match_jax():
    """8 sequences of 4 steps from stored carries through the 16-unit LSTM:
    the loss, its terms and every gradient."""
    O, A, H, M, L = 6, 3, 16, 8, 4
    cfg = _loss_cfg(**LSTM_NET)
    ja = JPPO(_NullTask(O, A), cfg, seed=0)
    assert ja.is_rnn and ja.seq_len == L
    params = _push_mu(_perturbed(ja.net.init(
        jax.random.PRNGKey(1), jnp.zeros((1, O)), ja.net.initial_carry(1))),
        A)
    g = np.random.default_rng(2)
    obs = g.normal(size=(M, L, O)).astype(np.float32)
    h0, c0 = (g.normal(size=(M, H)).astype(np.float32) for _ in range(2))

    def apply():
        carry, outs = (jnp.asarray(h0), jnp.asarray(c0)), []
        for t in range(L):
            mu, ls, v, carry = ja.net.apply(params, jnp.asarray(obs[:, t]),
                                            carry)
            outs.append((mu, ls, v))
        return [jnp.stack(x, 1) for x in zip(*outs)]  # (M, L, ...)
    out = apply()
    assert (np.abs(np.asarray(out[0])) > 1.1).any()
    rest = _loss_batch(g, *out)
    mb = [obs, h0, c0] + rest
    (jl, jaux), jg = jax.value_and_grad(ja._loss_rnn, has_aux=True)(
        params, tuple(jnp.asarray(x) for x in mb), None)
    pa = PPOAgent(_NullTask(O, A), cfg, seed=0)
    assert pa.is_rnn and pa.mb_seqs == 8 and pa.num_minibatches == 4
    pa.net = pnet.build_network(cfg["params"]["network"], O, A)
    pa.net.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        params)))
    loss, aux = pa._loss_rnn(tuple(torch.tensor(x) for x in mb))
    loss.backward()
    _check_loss(pa, jl, jaux, jg, loss, aux)


def test_central_value_loss_and_gradients_match_jax():
    O, S, A, n = 5, 7, 2, 64
    cfg = _loss_cfg()
    cfg["params"]["config"]["central_value_config"] = CV_CONFIG
    ja = JPPO(_NullTask(O, A, S), cfg, seed=0)
    assert ja.use_central_value
    params = _push_mu(_perturbed(ja.net.init(
        jax.random.PRNGKey(3), jnp.zeros((1, O)), jnp.zeros((1, S)))), A)
    g = np.random.default_rng(4)
    obs = g.normal(size=(n, O)).astype(np.float32)
    states = g.normal(size=(n, S)).astype(np.float32)
    out = ja.net.apply(params, jnp.asarray(obs), jnp.asarray(states))
    assert (np.abs(np.asarray(out[0])) > 1.1).any()
    rest = _loss_batch(g, *out)
    jmb = [obs, states] + rest
    (jl, jaux), jg = jax.value_and_grad(ja._loss, has_aux=True)(
        params, tuple(jnp.asarray(x) for x in jmb), None)
    pa = PPOAgent(_NullTask(O, A, S), cfg, seed=0)
    assert pa.use_central_value and not pa.is_rnn
    pa.net = pnet.build_network(cfg["params"]["network"], O, A,
                                central_value_config=CV_CONFIG, num_states=S)
    pa.net.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        params)))
    loss, aux = pa._loss(tuple(torch.tensor(x) for x in [obs] + rest
                               + [states]))
    loss.backward()
    _check_loss(pa, jl, jaux, jg, loss, aux)


def test_rnn_is_off_with_the_central_value():
    cfg = _loss_cfg(**LSTM_NET)
    cfg["params"]["config"]["central_value_config"] = CV_CONFIG
    for task, cv in ((_NullTask(4, 2, 3), True), (_NullTask(4, 2, 0), False)):
        ja, pa = JPPO(task, cfg), PPOAgent(task, cfg)
        assert (pa.use_central_value, pa.is_rnn) == (ja.use_central_value,
                                                     ja.is_rnn) == (cv, not cv)


# ---------------------------------------------------------------- epochs
# Measured on the CPU: Cartpole-64 with the LSTM obs 5.0e-5, actions
# 6.0e-7, mu 5.1e-7, neglogp 9.5e-7, values 8.7e-7, rewards 5.8e-7,
# advantages 1.5e-6, returns 1.4e-6, parameters 8.9e-7, metrics <= 6.1e-5
# relative (the KL, ~1e-3); ToyTask with the central value obs 1.2e-7,
# actions 2.4e-7, neglogp 9.5e-7, values 4.8e-7, advantages 4.0e-7,
# parameters 4.5e-7, metrics <= 1.2e-5 relative.  Both held at
# CARTPOLE_TOL.
EPOCH_TOL = CARTPOLE_TOL


def _epoch_pair(jtask, ptask, tcfg, seed, draws_of, env_state_of):
    """JAX epochs 1-2 and the port's epoch 2 from JAX's state after epoch
    1, JAX's draws injected (``test_torch_ppo_epoch.run_epoch_pair`` with
    the LSTM carry or the privileged states carried over)."""
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
    total = ja.seqs_total if ja.is_rnn else T * B
    perms = torch.tensor(np.stack([
        np.asarray(jax.random.permutation(k, total))
        for k in jax.random.split(k_perm, ja.cfg.mini_epochs)]))

    pa = PPOAgent(ptask, tcfg, seed=seed)
    pa.init()
    arrays = jax_learner_arrays(st)
    if ja.is_rnn:
        arrays["carry"] = [np.asarray(c) for c in st.carry]
    if ja.use_central_value:
        arrays["states_rms"] = jax.tree.map(np.asarray,
                                            st.states_rms._asdict())
        arrays["last_states"] = np.asarray(st.last_states)
    d = ppo_state_from_jax(arrays)
    env = env_state_of(st.env_state)
    if isinstance(env, dict) and "sim.q" in env:
        d["env_state"] = env
    else:
        pa.env_state = env
    pa.load_state_dict(d)
    roll, last_obs, stats = pa._rollout(noise, draws_of(st.env_state, T))
    adv, ret = pa._gae(roll, last_obs)
    pm = pa._update(roll, adv, ret, perms)
    pm["episodes_done"] = stats["episodes_done"]
    jnet_p = ppo_state_from_jax(jax_learner_arrays(st2))["net"]
    return {"jax": dict(roll=jroll, adv=jadv, ret=jret, metrics=jm,
                        net=jnet_p, obs_rms=st2.obs_rms,
                        value_rms=st2.value_rms, st=st2),
            "port": dict(roll=roll, adv=adv, ret=ret, metrics=pm,
                         net=dict(pa.net.state_dict()), obs_rms=pa.obs_rms,
                         value_rms=pa.value_rms, agent=pa)}


@pytest.fixture(scope="module")
def lstm_epoch():
    from isaacgymenvs_ma_tpu.tasks.cartpole import Cartpole as JCartpole
    from isaacgymenvs_ma_tpu.tasks.cartpole import TASK_CFG as JCFG
    from isaacgymenvs_ma_tpu_torch.tasks.cartpole import Cartpole, TASK_CFG
    n = 64
    tcfg = train_default_config("Cartpole")
    tcfg["params"]["config"].update(minibatch_size=512, seq_len=4)
    tcfg["params"]["network"]["rnn"] = LSTM_NET["rnn"]
    jtask = JCartpole(deep_merge(JCFG, {"env": {"numEnvs": n}}))
    ptask = Cartpole(deep_merge(TASK_CFG, {"env": {"numEnvs": n}}),
                     device="cpu", seed=3)

    def env_state_of(es):
        return {"sim.q": np.asarray(es.sim.q), "sim.qd": np.asarray(es.sim.qd),
                "progress": np.asarray(es.progress),
                "reset_buf": np.asarray(es.reset_buf)}
    return _epoch_pair(jtask, ptask, tcfg, 3,
                       lambda es, T: jax_reset_draws(es.rng, T, n,
                                                     cartpole_draws),
                       env_state_of)


def test_lstm_epoch_rollout_and_carry(lstm_epoch):
    check_rollout(lstm_epoch, EPOCH_TOL)
    j, p = lstm_epoch["jax"]["roll"], lstm_epoch["port"]["roll"]
    assert int(p.dones.sum()) > 0
    for got, want in zip(p.carry, j.carry):
        np.testing.assert_allclose(t2n(got), np.asarray(want), atol=1e-5)
    # the carry restarts where the previous step was done
    done_prev = t2n(p.dones[:-1])
    assert not t2n(p.carry[0][1:])[done_prev].any()
    for got, want in zip(lstm_epoch["port"]["agent"].carry,
                         lstm_epoch["jax"]["st"].carry):
        assert got.shape == want.shape


def test_lstm_epoch_advantages_metrics_and_parameters(lstm_epoch):
    check_gae(lstm_epoch, EPOCH_TOL)
    check_metrics(lstm_epoch, EPOCH_TOL)
    check_params(lstm_epoch, EPOCH_TOL)
    check_normalisers(lstm_epoch, EPOCH_TOL)
    assert lstm_epoch["port"]["agent"].num_minibatches == 2


class TorchToyTask:
    """``test_ppo_variants.ToyTask`` in torch; ``reset_draws`` (16, 2) are
    the new targets' N(0, 1) draws of the step."""

    num_envs = rl_games_batch = 16
    num_obs, num_states, num_actions, num_agents = 4, 6, 2, 1
    max_episode_length = 32
    device = torch.device("cpu")

    def __init__(self):
        self.generator = torch.Generator().manual_seed(0)

    def initial_state(self):
        z = torch.zeros((16, 2))
        return {"pos": z, "vel": z, "t": torch.zeros(16, dtype=torch.int32),
                "tgt": torch.randn((16, 2), generator=self.generator)}

    def reset(self, state):
        return state, torch.zeros((16, self.num_obs))

    def step(self, state, actions, reset_draws=None):
        draw = (torch.randn((16, 2), generator=self.generator)
                if reset_draws is None else reset_draws)
        vel = 0.9 * state["vel"] + 0.1 * torch.clamp(actions, -1, 1)
        pos = state["pos"] + 0.1 * vel
        t = state["t"] + 1
        rew = -torch.linalg.vector_norm(pos - state["tgt"], dim=-1)
        done = (t >= self.max_episode_length).to(torch.int32)
        d = done[:, None] > 0
        obs = torch.cat([pos, state["tgt"]], -1)
        states = torch.cat([pos, vel, state["tgt"]], -1)
        new = {"pos": torch.where(d, 0.0, pos),
               "vel": torch.where(d, 0.0, vel),
               "tgt": torch.where(d, draw, state["tgt"]),
               "t": torch.where(done > 0, 0, t).to(torch.int32)}
        return new, StepResult(obs=obs, states=states, rew=rew, reset=done,
                               extras={"time_outs": done.bool()})


@pytest.fixture(scope="module")
def central_value_epoch():
    tcfg = train_default_config("Cartpole")
    tcfg["params"]["config"].update(horizon_length=16, minibatch_size=64,
                                    mini_epochs=2,
                                    central_value_config=CV_CONFIG)

    def draws_of(es, T):
        key, out = es["key"], []
        for _ in range(T):
            key, k2 = jax.random.split(key)
            out.append(torch.tensor(np.asarray(jax.random.normal(k2,
                                                                 (16, 2)))))
        return out

    def env_state_of(es):
        return {k: torch.tensor(np.asarray(es[k]))
                for k in ("pos", "vel", "tgt", "t")}
    return _epoch_pair(ToyTask(), TorchToyTask(), tcfg, 0, draws_of,
                       env_state_of)


def test_central_value_epoch_rollout(central_value_epoch):
    check_rollout(central_value_epoch, EPOCH_TOL)
    j, p = central_value_epoch["jax"]["roll"], central_value_epoch["port"][
        "roll"]
    np.testing.assert_allclose(t2n(p.states), np.asarray(j.states),
                               atol=1e-6)
    assert p.dones[-1].all() and not p.dones[:-1].any()


def test_central_value_epoch_advantages_metrics_and_parameters(
        central_value_epoch):
    r = central_value_epoch
    check_gae(r, EPOCH_TOL)
    check_metrics(r, EPOCH_TOL)
    check_params(r, EPOCH_TOL)
    check_normalisers(r, EPOCH_TOL)
    pa, st = r["port"]["agent"], r["jax"]["st"]
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(t2n(getattr(pa.states_rms, f)),
                                   np.asarray(getattr(st.states_rms, f)),
                                   rtol=EPOCH_TOL["rms_rtol"], atol=1e-6)
