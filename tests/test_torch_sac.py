"""The port's SAC learner (isaacgymenvs_ma_tpu_torch/learning/sac.py)
against the JAX package's, on a toy point-mass task (16 envs, obs 4, act
2, episodes of 3-6 steps, every other env's end a time-out; the JAX one
defined here, the port's in tests/test_torch_dist_worker.py), so the
learner's paths compile in seconds.

* ``_sample_action`` and the two networks on converted parameters;
* one ``_update`` from a JAX state with a seeded replay, on the JAX key's
  replay indices and N(0, 1) draws: the losses, the temperature, the
  parameters and Adam moments of all three optimisers and the Polyak
  targets;
* one whole epoch from a fresh JAX state across the 5 seed steps (8 env
  steps, updates at steps 6-8): everything the epoch changes.

From the seed steps on, the actor's log-std reaches its upper bound 2
(std 7.4) at the fresh network, tanh saturates and the tanh correction
log(max(1 - a^2, 1e-6)) turns one rounding of a into up to ~2 of a
log-probability: the JAX epoch itself moves its critic loss by 7e-4
(relative) between jit and eager evaluation.  So the epoch is held, element
by element, within its base bound plus four times the reference's own
one-ulp spread (the largest move of the JAX epoch over eight runs with
every tanh output of its action sampler moved one ulp up or down), as
``utils/parity.py`` holds captures against it.

Tolerances (measured on the CPU): actions and log-probabilities 1e-5,
losses 1e-5 relative, parameters and targets 1e-6 (one Adam step of the
learning rate 5e-4 would move a weight by up to 5e-4), Adam moments 1e-5
relative to their largest entry (measured 1.3e-6), the normaliser 1e-6
relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.learning import sac as jsac
from isaacgymenvs_ma_tpu.learning.configs import train_default_config
from isaacgymenvs_ma_tpu.tasks.base import StepResult as JStepResult
from isaacgymenvs_ma_tpu_torch.convert import (params_from_jax,
                                               sac_state_from_jax)
from isaacgymenvs_ma_tpu_torch.learning import sac as psac

from test_torch_dist_worker import ToyTask as PToy
from test_torch_dist_worker import (TOY_ACT, TOY_ENVS, TOY_EP_LEN, TOY_OBS,
                                    TOY_TARGETS, TOY_TIMEOUT)

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

# the toy task's sizes and tables (the port's ToyTask holds the same)
B, OBS, ACT = TOY_ENVS, TOY_OBS, TOY_ACT
TARGETS, EP_LEN, TIMEOUT = TOY_TARGETS, TOY_EP_LEN, TOY_TIMEOUT  # 3-6 steps


class _Surface:
    num_envs = B
    num_obs, num_actions, num_states, num_agents = OBS, ACT, 0, 1
    rl_games_batch = B
    max_episode_length = 6
    dict_obs_cls = False
    randomizer = None


class JToy(_Surface):
    """Point mass toward a target: pos += 0.1 act, reward -|target - pos|;
    obs (pos, target - pos); reset at each env's episode length."""

    def initial_state(self, key):
        return (jnp.zeros((B, 2)), jnp.zeros(B, jnp.int32))

    def reset(self, st):
        return st, jnp.zeros((B, OBS))

    def step(self, st, act):
        pos, t = st
        pos, t = pos + 0.1 * act, t + 1
        tgt = jnp.asarray(TARGETS)
        obs = jnp.concatenate([pos, tgt - pos], -1)
        rew = -jnp.linalg.norm(tgt - pos, axis=-1)
        done = t >= jnp.asarray(EP_LEN)
        st = (jnp.where(done[:, None], 0.0, pos), jnp.where(done, 0, t))
        return st, JStepResult(obs=obs, states=None, rew=rew,
                               reset=done.astype(jnp.int32),
                               extras={"time_outs": done & TIMEOUT})


def _cfg():
    cfg = train_default_config("AntSAC")
    c = cfg["params"]["config"]
    c.update(batch_size=64, num_steps_per_episode=8, replay_buffer_size=1000)
    cfg["params"]["network"]["mlp"]["units"] = [32, 32]
    return cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_arrays(st):
    """A JAX SACState's learner part as sac_state_from_jax takes it."""
    adam = lambda o: {"count": np.asarray(o[0].count),  # noqa: E731
                      "mu": _np(o[0].mu), "nu": _np(o[0].nu)}
    return {"actor_params": _np(st.actor_params),
            "critic_params": _np(st.critic_params),
            "target_params": _np(st.target_params),
            "log_alpha": np.asarray(st.log_alpha),
            "actor_adam": adam(st.actor_opt),
            "critic_adam": adam(st.critic_opt),
            "alpha_adam": adam(st.alpha_opt),
            "obs_rms": _np(st.obs_rms._asdict()),
            "buffer": _np(st.buffer), "buf_n": int(st.buf_n),
            "step": int(st.step), "mean_return": np.asarray(st.mean_return),
            "ep_return": np.asarray(st.ep_return),
            "last_obs": np.asarray(st.last_obs)}


def _pair(st):
    """The port's agent loaded with the JAX state ``st``."""
    pa = psac.SACAgent(PToy(), _cfg(), seed=0)
    pa.init()
    pa.load_state_dict(sac_state_from_jax(_jax_arrays(st)))
    pa.env_state = tuple(torch.as_tensor(np.array(x))
                         for x in st.env_state)
    return pa


def _held(got, want, atol, what, widen=None):
    """|got - want| <= atol, plus ``widen`` (per element) where given."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    bound = atol + (0.0 if widen is None else np.asarray(widen))
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= bound).all(), f"{what}: {float((err - bound).max()):.3g}"


def _check_learner(pa, st, moment_tol=1e-5, spread=()):
    """The port's learner against the JAX state ``st``; with ``spread``
    (JAX states of the same computation from one-ulp nudged inputs) each
    element's bound is widened by four times the reference's largest move
    there."""
    want = sac_state_from_jax(_jax_arrays(st))
    others = [sac_state_from_jax(_jax_arrays(o)) for o in spread]
    widen = lambda *k: None if not others else 4 * np.max(  # noqa: E731
        [np.abs(_get(want, k).numpy() - _get(o, k).numpy())
         for o in others], axis=0)
    for which in ("actor", "critic", "target"):
        got = getattr(pa, which).state_dict()
        assert got.keys() == want[which].keys()
        for k, v in want[which].items():
            _held(got[k], v, 1e-6, f"{which}.{k}", widen(which, k))
    _held(pa.log_alpha, want["log_alpha"], 1e-6, "log_alpha",
          widen("log_alpha"))
    for which, net in (("actor_optim", pa.actor), ("critic_optim",
                                                   pa.critic)):
        opt = getattr(pa, which)
        for name, p in net.named_parameters():
            w = want[which][name]
            assert float(opt.state[p]["step"]) == float(w["step"])
            for f in ("exp_avg", "exp_avg_sq"):
                scale = float(w[f].abs().max()) or 1.0
                _held(opt.state[p][f], w[f], moment_tol * scale,
                      f"{which}.{name}.{f}", widen(which, name, f))
    s = pa.alpha_optim.state[pa.log_alpha]
    for f in ("exp_avg", "exp_avg_sq"):
        w = want["alpha_optim"][f]
        _held(s[f], w, 1e-5 * float(w.abs()) + 1e-9, f"alpha.{f}",
              widen("alpha_optim", f))


def _get(d, keys):
    for k in keys:
        d = d[k]
    return d


def test_sample_action_matches_jax():
    g = np.random.default_rng(1)
    mu = g.normal(size=(256, 6)).astype(np.float32)
    # half the samples narrow (std <= 0.22), half over the actor's whole
    # log-std range (-5, 2), where tanh saturates
    log_std = np.concatenate([g.uniform(-5, -1.5, (128, 6)),
                              g.uniform(-5, 2, (128, 6))]).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ja, jl = jsac._sample_action(key, jnp.asarray(mu), jnp.asarray(log_std))
    eps = np.asarray(jax.random.normal(key, mu.shape))
    pa, pl = psac._sample_action(torch.as_tensor(mu),
                                 torch.as_tensor(log_std),
                                 torch.as_tensor(np.array(eps)))
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-6)
    # the tanh correction log(1 - a^2) turns the two tanh's rounding of a
    # (a few 6e-8) into 2 |a| da / (1 - a^2) near |a| = 1: each sample's
    # log-probability is held at 1e-5 plus four times that for da = 2.4e-7
    a = np.abs(np.asarray(ja, np.float64))
    amp = np.sum(2 * a * 2.4e-7 / np.maximum(1 - a * a, 1e-6), -1)
    err = np.abs(pl.numpy().astype(np.float64) - np.asarray(jl))
    assert (err <= 1e-5 * np.abs(np.asarray(jl)) + 1e-5 + 4 * amp).all(), \
        float((err - 4 * amp).max())
    # the narrow half, away from saturation, within 2e-5 outright
    np.testing.assert_allclose(pl.numpy()[:128], np.asarray(jl)[:128],
                               rtol=1e-5, atol=2e-5)


def test_networks_match_jax():
    units = (32, 16)
    ja = jsac.TanhGaussianActor(ACT, units)
    jq = jsac.TwinQ(units)
    pa_params = ja.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    q_params = jq.init(jax.random.PRNGKey(1), jnp.zeros((1, OBS)),
                       jnp.zeros((1, ACT)))
    actor = psac.TanhGaussianActor(OBS, ACT, units)
    actor.load_state_dict(params_from_jax(_np(pa_params)))
    critic = psac.TwinQ(OBS, ACT, units)
    critic.load_state_dict(params_from_jax(_np(q_params)))
    g = np.random.default_rng(2)
    o = g.normal(size=(64, OBS)).astype(np.float32)
    a = g.uniform(-1, 1, (64, ACT)).astype(np.float32)
    for got, want in zip(actor(torch.as_tensor(o)), ja.apply(pa_params, o)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    for got, want in zip(critic(torch.as_tensor(o), torch.as_tensor(a)),
                         jq.apply(q_params, o, a)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jagent():
    return jsac.SACAgent(JToy(), _cfg(), seed=0)


def test_update_matches_jax(jagent):
    """One update from a state whose replay holds 300 seeded transitions
    (dones and time-outs among them) and whose obs_rms has moved."""
    st = jagent.init(jax.random.PRNGKey(0))
    g = np.random.default_rng(3)
    R, n = jagent.replay_size, 300
    buf = {k: np.array(v) for k, v in _np(st.buffer).items()}
    buf["obs"][:n] = g.normal(size=(n, OBS))
    buf["next_obs"][:n] = g.normal(size=(n, OBS))
    buf["act"][:n] = g.uniform(-1, 1, (n, ACT))
    buf["rew"][:n] = g.normal(size=n)
    buf["done"][:n] = (g.uniform(size=n) < 0.2)
    rms = st.obs_rms.update(jnp.asarray(buf["obs"][:n]))
    st = st._replace(buffer={k: jnp.asarray(v) for k, v in buf.items()},
                     buf_n=jnp.asarray(n, jnp.int32), obs_rms=rms,
                     log_alpha=jnp.asarray(-0.3, jnp.float32))
    key = jax.random.PRNGKey(4)
    st2, jm = jax.jit(jagent._update)(st, key)
    pa = _pair(st)
    k_s, k_a1, k_a2 = jax.random.split(key, 3)
    idx = np.asarray(jax.random.randint(k_s, (64,), 0, min(n, R)))
    shape = (64, ACT)
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    pm = pa._update(t(idx), t(jax.random.normal(k_a1, shape)),
                    t(jax.random.normal(k_a2, shape)))
    for k in ("critic_loss", "actor_loss", "alpha"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(jm["critic_loss"]) > 0.1
    _check_learner(pa, st2)


def _epoch_draws(st, agent):
    """Every draw of one JAX SAC epoch from ``st``: per step the action
    draw, then (past the seed steps) the update's replay indices and its
    two N(0, 1) draws."""
    key, step, buf_n, out = st.key, int(st.step), int(st.buf_n), []
    shape = (B, ACT)
    for _ in range(agent.steps_per_epoch):
        key, k_act = jax.random.split(key)
        d = {"act": np.asarray(
            jax.random.uniform(k_act, shape, minval=-1.0, maxval=1.0)
            if step < agent.num_seed_steps
            else jax.random.normal(k_act, shape))}
        step, buf_n = step + 1, buf_n + B
        key, k_upd = jax.random.split(key)
        if step > agent.num_seed_steps:
            k_s, k_a1, k_a2 = jax.random.split(k_upd, 3)
            have = min(max(buf_n, 1), agent.replay_size)
            ub = (agent.batch_size, ACT)
            d.update(idx=np.asarray(jax.random.randint(
                k_s, (agent.batch_size,), 0, have)),
                eps_next=np.asarray(jax.random.normal(k_a1, ub)),
                eps_actor=np.asarray(jax.random.normal(k_a2, ub)))
        out.append({k: torch.as_tensor(np.array(v)) for k, v in d.items()})
    return out


def _ulp_runs(jagent, st, monkeypatch, runs=8):
    """The JAX epoch from ``st`` ``runs`` times with every tanh output of
    ``_sample_action`` moved by one float32 ulp, up or down by a coin of
    the run: the reference's one-ulp spread where the port's own rounding
    of tanh lands."""
    sample = jsac._sample_action
    nudge = {}

    def nudged(key, mu, log_std):
        eps = jax.random.normal(key, mu.shape)
        act = jnp.tanh(mu + jnp.exp(log_std) * eps)
        up = jax.random.bernoulli(jax.random.fold_in(key, nudge["run"]),
                                  0.5, act.shape)
        a0 = jax.lax.stop_gradient(act)
        act = act + (jnp.nextafter(a0, jnp.where(up, 2.0, -2.0)) - a0)
        logp = (-0.5 * jnp.square(eps) - log_std
                - 0.5 * jnp.log(2.0 * jnp.pi)).sum(-1)
        logp -= jnp.log(jnp.maximum(1.0 - jnp.square(act), 1e-6)).sum(-1)
        return act, logp

    @jax.jit
    def epoch(state, run):
        nudge["run"] = run
        return jagent._train_epoch(state)

    monkeypatch.setattr(jsac, "_sample_action", nudged)
    try:
        return [epoch(st, jnp.asarray(r, jnp.uint32)) for r in range(runs)]
    finally:
        monkeypatch.setattr(jsac, "_sample_action", sample)


def test_epoch_across_the_seed_steps_matches_jax(jagent, monkeypatch):
    st = jagent.init(jax.random.PRNGKey(5))
    pa = _pair(st)
    draws = _epoch_draws(st, jagent)
    assert sum("idx" in d for d in draws) == 3      # updates at steps 6-8
    st2, jm = jagent.train_epoch(st)
    runs = _ulp_runs(jagent, st, monkeypatch)
    pm = pa.train_epoch(draws)
    assert pa.step == int(st2.step) == 8
    assert pm["frames"] == int(jm["frames"])
    for k in ("critic_loss", "actor_loss", "alpha", "mean_return"):
        want = float(jm[k])
        _held(np.asarray(float(pm[k])), want, 1e-5 * abs(want) + 1e-6, k,
              4 * max(abs(want - float(m[k])) for _, m in runs))
    _check_learner(pa, st2, spread=[s for s, _ in runs])
    buf = _np(st2.buffer)
    for k, v in buf.items():
        np.testing.assert_allclose(pa.buffer[k].numpy(), v, rtol=0,
                                   atol=1e-5, err_msg=k)
    # episodes ended (and some by time-out, whose stored done is 0)
    assert float(buf["done"][:128].sum()) > 0
    assert float(np.asarray(st2.mean_return)) < 0
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(pa.obs_rms, f).numpy(),
                                   np.asarray(getattr(st2.obs_rms, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(pa.ep_return.numpy(),
                               np.asarray(st2.ep_return), atol=1e-5)


def test_sac_refuses_other_algos():
    cfg = train_default_config("Ant")
    with pytest.raises(ValueError, match="algo"):
        psac.SACAgent(PToy(), cfg)


def test_state_dict_round_trip():
    """A checkpoint's ``state_dict`` restores everything the next epoch
    reads: networks, optimisers, temperature, replay rows, counters,
    generators and env state (AntSAC at 4 envs; the epoch after it is
    bit-equal)."""
    from isaacgymenvs_ma_tpu_torch.tasks import registry
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

    def agent(seed):
        task = registry.create_task("AntSAC", deep_merge(
            registry.task_default_config("AntSAC"),
            {"env": {"numEnvs": 4}}), seed=seed, device="cpu")
        a = psac.SACAgent(task, _cfg(), seed=seed)
        a.init()
        return a
    a, b = agent(0), agent(5)
    a.train_epoch()
    b.load_state_dict(a.state_dict())
    ma, mb = a.train_epoch(), b.train_epoch()
    for k in ma:
        assert float(ma[k]) == float(mb[k]), k
    for x, y in zip(a.state_dict()["actor"].values(),
                    b.state_dict()["actor"].values()):
        assert torch.equal(x, y)
    assert torch.equal(a.env_state.sim.q, b.env_state.sim.q)
    assert a.buf_n == b.buf_n == 64
