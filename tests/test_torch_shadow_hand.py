"""Port parity of ShadowHand and its config variants
(isaacgymenvs_ma_tpu_torch/tasks/shadow_hand.py) against the JAX package.

* The composed scene (the copied spec, drives, fingertip sensors, the
  palm-up placement, the cube), the engine's candidate rows, pair list and
  mass-splitting row attribution, and the task's tables (hand dofs,
  tendon-coupled distals, the static per-env force probability and moving
  average from ``np.random.RandomState(4273)``), against the JAX task.
* ``reset_idx``, ``pre_physics`` (the random object force's draws from
  the JAX keys injected) and ``post_physics`` for each of the four
  observation types with the asymmetric critic states, from a committed
  capture's warmed-up state, against the JAX methods run eagerly.
* The registry's variant deltas against the JAX registry.
* The ShadowHand and ShadowHandOpenAI_FF captures
  (``scripts/record_torch_golden.py --task ShadowHand`` /
  ``ShadowHandOpenAI_FF``: 32 envs, 6 steps, successes in the first step,
  the reset, force and goal draws injected) replayed on the CPU twins one
  step at a time against the reference's own one-ulp spread
  (``parity.replay``), at ``parity.TOLERANCES``.
* One CPU epoch of ShadowHandOpenAI_FF's asymmetric PPO at 16 envs; the
  entry point asking for the card and raising without one.

Tolerances: obs, states, reward and everything computed from body poses
at the ground rule (``parity.GROUND_RULE_TOL``); the reset's and the
controls' values, computed in the same float32 arithmetic from the same
draws, at rtol = atol = 1e-6; resets, success flags and the episode-clock
mask exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.physics.engine import SimState as JSimState
from isaacgymenvs_ma_tpu.tasks import registry as jregistry
from isaacgymenvs_ma_tpu.tasks.base import EnvState as JEnvState
from isaacgymenvs_ma_tpu.tasks.shadow_hand import HandTaskState as JHandState
from isaacgymenvs_ma_tpu.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax
from isaacgymenvs_ma_tpu_torch.tasks import registry as pregistry
from isaacgymenvs_ma_tpu_torch.tasks.shadow_hand import HandTaskState
from isaacgymenvs_ma_tpu_torch.utils.parity import (
    GROUND_RULE_TOL, ONE_STEP_RESET_MISMATCHES, PRE_DRAWS, RESET_DRAWS,
    STEP_DRAWS, TOLERANCES, replay)
from test_torch_ball_balance import _assert_models_equal

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
N = 32
TOL = GROUND_RULE_TOL
# the hands' captures: registry name -> file
GOLDEN = {"ShadowHand": "shadow_hand_golden.npz",
          "AllegroHand": "allegro_hand_golden.npz",
          "ShadowHandOpenAI_FF": "shadow_hand_openai_ff_golden.npz",
          "AllegroHandLSTM": "allegro_hand_lstm_golden.npz"}
# registry name -> (nb, nv, ground rows, pair rows, obs, act, states)
SIZES = {"ShadowHand": (27, 30, 8, 52, 211, 20, 0),
         "ShadowHandOpenAI_FF": (27, 30, 8, 52, 42, 20, 211),
         "AllegroHand": (23, 22, 8, 36, 88, 16, 0),
         "AllegroHandLSTM": (23, 22, 8, 36, 50, 16, 88)}


# ------------------------------------------------ helpers (both hand files)
def _pair(name, n=N, **env):
    """The JAX task and the port's (CPU) of registry ``name`` at ``n``
    envs, ``env`` keys merged over the registry's config."""
    over = {"env": {"numEnvs": n, **env}}
    jt = jregistry.task_class(name)(deep_merge(
        jregistry.task_default_config(name), over))
    pt = pregistry.create_task(name, deep_merge(
        pregistry.task_default_config(name), over), seed=3, device="cpu")
    return jt, pt


def _close(got, want, atol, what, rtol=0.0):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _states(jt, pt, capture):
    """The JAX and the port env states at ``capture``'s warmed-up start."""
    d = np.load(os.path.join(DATA, GOLDEN[capture]))
    fields = JHandState._fields
    jstate = JEnvState(
        sim=JSimState(jnp.asarray(d["init_q"]), jnp.asarray(d["init_qd"])),
        progress=jnp.asarray(d["init_progress"]),
        reset_buf=jnp.asarray(d["init_reset_buf"]),
        rng=jax.random.PRNGKey(11),
        task=JHandState(*(jnp.asarray(d[f"init_{f}"]) for f in fields)),
        phys=None)
    arrays = {"sim.q": d["init_q"], "sim.qd": d["init_qd"],
              "progress": d["init_progress"],
              "reset_buf": d["init_reset_buf"]}
    arrays.update({f"task.{f}": d[f"init_{f}"] for f in fields})
    return jstate, env_state_from_jax(arrays, "cpu")


def _angles(key, n):
    k1, k2 = jax.random.split(key)
    return jnp.stack([jax.random.uniform(k1, (n,), minval=-np.pi,
                                         maxval=np.pi),
                      jax.random.uniform(k2, (n,), minval=-np.pi,
                                         maxval=np.pi)], -1)


def _t(*xs):
    return tuple(torch.tensor(np.asarray(x)) for x in xs)


def _jax_reset_draws(key, task):
    """ShadowHand.reset_idx's draws from ``key`` as the port takes them
    (scripts/record_torch_golden.py ``hand_draws``)."""
    n = task.num_envs
    ks = jax.random.split(key, 5)
    return _t(jax.random.normal(ks[0], (n, 3)), _angles(ks[1], n),
              jax.random.uniform(ks[2], (n, task.num_hand_dofs)),
              _angles(ks[3], n))


def _jax_pre_draws(rng, n):
    k_fire, k_mag = jax.random.split(jax.random.fold_in(rng, 77))
    return _t(jax.random.uniform(k_fire, (n,)),
              jax.random.normal(k_mag, (n, 3)))


def _jax_goal_draws(rng, n):
    return _t(_angles(jax.random.fold_in(rng, 41), n))


def _check_task(ptask, jtask, atol, what):
    assert isinstance(ptask, HandTaskState)
    for f in JHandState._fields:
        _close(getattr(ptask, f), np.asarray(getattr(jtask, f)), atol,
               f"{what}: {f}", rtol=1e-6)


def check_scene(name):
    jt, pt = _pair(name, n=8)
    _assert_models_equal(pt.model, jt.model)
    je, te = jt.engine, pt.engine
    nb, nv, ng, npr, obs, act, states = SIZES[name]
    assert (te.nb, te.nv, te.n_ground, te.n_pair_rows) == (nb, nv, ng, npr)
    assert (je.nb, je.nv, je.n_ground, je.n_pair_rows) == (nb, nv, ng, npr)
    assert (pt.num_obs, pt.num_actions, pt.num_states) == (obs, act, states)
    assert (jt.num_obs, jt.num_actions, jt.num_states) == (obs, act, states)
    for k in ("max_episode_length", "control_freq_inv", "obj_qa", "obj_va",
              "object_body", "obj_mass", "force_scale",
              "max_consecutive_successes", "success_tolerance"):
        assert getattr(pt, k) == getattr(jt, k), k
    np.testing.assert_array_equal(te.row_masks_np,
                                  np.asarray(je._row_masks_np()))
    np.testing.assert_array_equal(te.row_body_a, je.row_body_a)
    np.testing.assert_array_equal(te.row_body_b, je.row_body_b)
    np.testing.assert_array_equal(te.row_body_oh.numpy(),
                                  np.asarray(je._row_body_oh))
    np.testing.assert_array_equal(te.dof_friction.numpy(),
                                  np.asarray(je.dof_friction))
    assert len(te.pairs) == len(je.pairs)
    for tp, jp in zip(te.pairs, je.pairs):
        np.testing.assert_array_equal(tp["pt_idx"], np.asarray(jp["pt_idx"]))
        assert (tp["tgt_body"], tp["tgt_type"]) == (int(jp["tgt_body"]),
                                                    int(jp["tgt_type"]))
    for k in ("fingertip_bodies", "hand_dofs", "coupled_distal", "actuated",
              "obj_start", "goal_pos"):
        np.testing.assert_array_equal(getattr(pt, k), getattr(jt, k),
                                      err_msg=k)
    for k in ("dof_lower", "dof_upper", "random_force_prob"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    ama = jt.act_moving_average
    if isinstance(ama, float):
        assert pt.act_moving_average == ama
    else:
        np.testing.assert_array_equal(pt.act_moving_average.numpy(),
                                      np.asarray(ama))
    np.testing.assert_array_equal(np.asarray(pt.model.sensor_body),
                                  pt.fingertip_bodies)
    return jt, pt


def check_reset_idx(name):
    """A quarter of the envs reset: the cube back at its start with noise
    and a random orientation at rest, the hand dofs at their noise, a new
    goal, successes and the force zeroed."""
    jt, pt = _pair(name)
    jst, pst = _states(jt, pt, name)
    mask = np.arange(N) % 4 == 0
    succ = np.random.default_rng(5).integers(0, 5, N).astype(np.float32)
    jtask = jst.task._replace(successes=jnp.asarray(succ))
    ptask = pst.task._replace(successes=torch.tensor(succ))
    key = jax.random.PRNGKey(7)
    jsim, jtask2 = jt.reset_idx(jst.sim, jtask, jnp.asarray(mask), key)
    psim, ptask2 = pt.reset_idx(pst.sim, ptask, torch.tensor(mask),
                                _jax_reset_draws(key, jt))
    _close(psim.q, jsim.q, 1e-6, "q", rtol=1e-6)
    _close(psim.qd, jsim.qd, 1e-6, "qd", rtol=1e-6)
    _check_task(ptask2, jtask2, 1e-6, name)
    moved = np.abs(psim.q.numpy() - np.asarray(jst.sim.q)).max(1) > 0
    np.testing.assert_array_equal(moved, mask)


def check_pre_physics(name):
    """Targets (moving average, tendon-coupled distals) and the object's
    force with the JAX draws; the force on at scale 1 where the config
    has none and fired at probability 0.5, so that about half the envs
    re-roll it."""
    jt, pt = _pair(name)
    jst, pst = _states(jt, pt, name)
    for t in (jt, pt):
        t.force_scale = t.force_scale or 1.0
    jt.random_force_prob = jnp.full((N,), 0.5)
    pt.random_force_prob = torch.full((N,), 0.5)
    rb = np.random.default_rng(1).normal(size=(N, 3)).astype(np.float32)
    jst = jst._replace(task=jst.task._replace(rb_force=jnp.asarray(rb)))
    pst = pst._replace(task=pst.task._replace(rb_force=torch.tensor(rb)))
    acts = np.random.default_rng(2).uniform(
        -1, 1, (N, pt.num_actions)).astype(np.float32)
    jc = jt.pre_physics(jst, jnp.asarray(acts))
    draws = _jax_pre_draws(jst.rng, N)
    assert 0 < int((draws[0] < 0.5).sum()) < N
    pc, (targets, force) = pt.pre_physics(pst, torch.tensor(acts),
                                          draws=draws)
    _close(pc.pos_target, jc.pos_target, 1e-6, "pos_target", rtol=1e-6)
    _close(pc.f_ext, jc.f_ext, 1e-6, "f_ext", rtol=1e-6)
    _close(targets, jt._new_targets, 1e-6, "targets", rtol=1e-6)
    _close(force, jt._rb_force, 1e-6, "force", rtol=1e-6)
    assert not (pc.tau.any() or pc.vel_target.any())
    assert np.abs(np.asarray(jc.f_ext)).max() > 0


def check_post_physics(name, obs_type, max_successes):
    """From the capture's state with the asymmetric states on: a third of
    the envs with their goal on the cube's orientation (success: bonus,
    the goal resampled, the episode clock restarted with
    ``maxConsecutiveSuccesses``), every fifth at its episode's end, a few
    one success short of the maximum."""
    jt, pt = _pair(name, observationType=obs_type,
                   asymmetric_observations=True,
                   maxConsecutiveSuccesses=max_successes)
    jst, pst = _states(jt, pt, name)
    q = np.asarray(jst.sim.q)
    qa = jt.obj_qa
    near = np.arange(N) % 3 == 0
    goal = np.where(near[:, None], q[:, qa + 3: qa + 7],
                    np.asarray(jst.task.goal_rot)).astype(np.float32)
    succ = np.where(np.arange(N) % 7 == 0, 49.0, 2.0).astype(np.float32)
    progress = np.where(np.arange(N) % 5 == 0, jt.max_episode_length - 1,
                        np.arange(N)).astype(np.int32)
    jst = jst._replace(progress=jnp.asarray(progress), task=jst.task._replace(
        goal_rot=jnp.asarray(goal), successes=jnp.asarray(succ)))
    pst = pst._replace(progress=torch.tensor(progress),
                       task=pst.task._replace(goal_rot=torch.tensor(goal),
                                              successes=torch.tensor(succ)))
    acts = np.random.default_rng(9).uniform(
        -1, 1, (N, pt.num_actions)).astype(np.float32)
    jt.pre_physics(jst, jnp.asarray(acts))
    _, carry = pt.pre_physics(pst, torch.tensor(acts),
                              draws=_jax_pre_draws(jst.rng, N))
    jout = jt.engine.forward(jst.sim)
    pout = pt.engine.forward(pst.sim)
    jo, js, jr, jreset, jtask, jx = jt.post_physics(jst, jout,
                                                    jnp.asarray(acts))
    po, ps, pr, preset, ptask, px = pt.post_physics(
        pst, pout, torch.tensor(acts), carry=carry,
        draws=_jax_goal_draws(jst.rng, N))
    assert po.shape == (N, pt.num_obs) and ps.shape == (N, 211 if
                                                        pt.num_hand_dofs
                                                        == 24 else 88)
    _close(po, jo, TOL["obs"], "obs")
    _close(ps, js, TOL["obs"], "states")
    _close(pr, jr, TOL["rew"], "reward", rtol=1e-6)
    np.testing.assert_array_equal(preset.numpy(), np.asarray(jreset))
    success = np.asarray(jx["episode"]["success_rate_step"]) > 0
    assert success[near].all() and np.asarray(jreset).any()
    if max_successes:
        np.testing.assert_array_equal(px["_reset_progress_mask"].numpy(),
                                      np.asarray(jx["_reset_progress_mask"]))
    else:
        assert "_reset_progress_mask" not in px and \
            "_reset_progress_mask" not in jx
    for k in ("consecutive_successes", "true_objective"):
        _close(px[k], jx[k], 1e-6, k, rtol=1e-6)
    for k, v in jx["episode"].items():
        _close(px["episode"][k], v, TOL["obs"], k, rtol=1e-6)
    _check_task(ptask, jtask, TOL["obs"], f"{name} {obs_type}")
    # the resampled goals moved, the others did not
    moved = np.abs(ptask.goal_rot.numpy() - goal).max(1) > 0
    np.testing.assert_array_equal(moved, success)


def check_capture(name, n_obs, n_act):
    d = np.load(os.path.join(DATA, GOLDEN[name]))
    T, n = d["actions"].shape[:2]
    assert (T, n) == (6, N) and str(d["task"]) == name
    assert d["actions"].shape[2] == n_act and d["obs"].shape == (T, n, n_obs)
    for k in RESET_DRAWS[name] + PRE_DRAWS[name] + STEP_DRAWS[name]:
        assert d[k].shape[:2] == (T, n), k
    assert d["spread_qd"].shape == (T, n) and d["start_q"].shape == (
        T, n, d["init_q"].shape[1])
    assert d["init_consecutive"].shape == ()
    # resets (the quarter flagged) and successes happen in the first step
    assert d["init_reset_buf"][: N // 4].all()
    assert (d["rew"][0] > 200).any()
    assert TOLERANCES[name] is GROUND_RULE_TOL
    return d


def check_replay(name):
    e = replay(os.path.join(DATA, GOLDEN[name]), "cpu")
    assert e.finite
    for k, tol in TOLERANCES[name].items():
        errs = getattr(e, k)
        assert (errs <= tol).all(), f"{k} per-step errors {errs} > {tol}"
        # every held env within the bound, not only the median
        assert (e.raw[k] <= tol).all(), f"{k} raw errors {e.raw[k]}"
    assert (e.reset_mismatches <= ONE_STEP_RESET_MISMATCHES).all()
    assert (e.wild_envs <= 4).all(), e.wild_envs


def check_variant(name, base):
    assert pregistry.task_default_config(name) == \
        jregistry.task_default_config(name)
    assert pregistry.task_class(name).__name__ == base == \
        jregistry.task_class(name).__name__


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", ["ShadowHand", "ShadowHandOpenAI_FF"])
def test_scene_matches_jax(name):
    jt, pt = check_scene(name)
    # every hand dof position-driven with the MJCF gains; the four
    # tendon-coupled distals not actuated
    assert len(pt.coupled_distal) == 4 and len(pt.actuated) == 20
    assert pt.model.dof_stiffness[:24].max() == 5.0


@pytest.mark.parametrize("name", ["ShadowHand", "ShadowHandOpenAI_FF"])
def test_reset_idx_matches_jax(name):
    check_reset_idx(name)


@pytest.mark.parametrize("name", ["ShadowHand", "ShadowHandOpenAI_FF"])
def test_pre_physics_matches_jax(name):
    check_pre_physics(name)


@pytest.mark.parametrize("obs_type,max_successes", [
    ("openai", 50), ("full_no_vel", 0), ("full", 50), ("full_state", 0)])
def test_post_physics_matches_jax(obs_type, max_successes):
    check_post_physics("ShadowHand", obs_type, max_successes)


@pytest.mark.parametrize("name", ["ShadowHand", "ShadowHandOpenAI_FF"])
def test_capture_format(name):
    d = check_capture(name, *SIZES[name][4:6])
    if name == "ShadowHandOpenAI_FF":
        # the random force is live: some env carries one into the capture
        assert np.abs(d["init_rb_force"]).max() > 0


@pytest.mark.parametrize("name", ["ShadowHand", "ShadowHandOpenAI_FF"])
def test_golden_replay_on_cpu_twins(name):
    check_replay(name)


@pytest.mark.parametrize("name", ["ShadowHandOpenAI_FF",
                                  "ShadowHandOpenAI_LSTM", "ShadowHandTest"])
def test_registry_variants_match_jax(name):
    check_variant(name, "ShadowHand")
    assert pregistry.task_default_config("ShadowHand") == \
        jregistry.task_default_config("ShadowHand")


def test_openai_ff_config_sizes():
    """OpenAI_FF: resetTime 8 s over 3 x 1/60 s steps sets 160 steps, the
    moving average 0.3, the randomizer on with empty parameters (no
    scales, no noise), the critic's 211 states."""
    jt, pt = _pair("ShadowHandOpenAI_FF", n=8)
    assert pt.max_episode_length == jt.max_episode_length == 160
    assert pt.act_moving_average == 0.3 and pt.control_freq_inv == 3
    assert pt.randomizer is not None and pt.initial_state().phys is None


def test_one_cpu_epoch_of_openai_ff():
    """One PPO epoch of ShadowHandOpenAI_FF with its asymmetric config at
    16 envs (the minibatches cut to the rollout): finite losses, the
    central-value critic on the 211 states, parameters moved."""
    from isaacgymenvs_ma_tpu_torch.learning import networks
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config)
    from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
    _, pt = _pair("ShadowHandOpenAI_FF", n=16)
    tcfg = train_default_config("ShadowHandOpenAI_FF")
    c = tcfg["params"]["config"]
    c["minibatch_size"] = c["central_value_config"]["minibatch_size"] = 64
    agent = PPOAgent(pt, tcfg, seed=1)
    agent.init()
    assert isinstance(agent.net, networks.AsymActorCritic)
    before = [p.detach().clone() for p in agent.net.parameters()]
    m = agent.train_epoch()
    assert all(np.isfinite(float(v)) for v in m.values())
    assert any(not torch.equal(a, b)
               for a, b in zip(before, agent.net.parameters()))


@pytest.mark.parametrize("name", ["ShadowHand", "ShadowHandOpenAI_FF"])
def test_entry_point_asks_for_the_card(name):
    cfg = deep_merge(pregistry.task_default_config(name),
                     {"env": {"numEnvs": 8}})
    if torch.cuda.is_available():
        assert pregistry.create_task(name, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pregistry.create_task(name, cfg)
