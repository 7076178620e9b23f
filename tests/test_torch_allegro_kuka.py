"""Port parity of the AllegroKuka family
(isaacgymenvs_ma_tpu_torch/tasks/allegro_kuka.py) against the JAX package.

* The resolvers, the obs and action sizes of all five subtasks, the
  registry names; the copied spec; the composed scenes and pair lists; the
  cuboid catalog and the per-env object scales (bit-equal).
* ``pre_physics`` (the hand's and arm's targets, the random object force
  and the privileged torque with JAX's draws injected), ``reset_idx``
  (full and goal-only resets, Regrasping and Throw putting the object
  back) and ``post_physics`` (obs, reward, resets, the success counting,
  the tolerance curriculum and ``true_objective``) against the JAX
  methods, run eagerly from a committed capture's warmed-up state; the
  episode-clock hook of the base step; the curriculum through a
  checkpoint.
* Golden captures (``scripts/record_torch_golden.py --task AllegroKuka``
  and ``--task AllegroKukaTwoArms``, 32 envs, 6 steps, the reset draws
  and the force draws of every step injected) replayed on the default
  loop, and AllegroKuka's 128-env kernel-route capture
  (``--kernel-route``) replayed through the port's B4 twin; one step at a
  time, each env's error taken beyond four times the reference's own
  one-ulp spread there (parity.replay's one-step mode: the fingers
  amplify float32 rounding).  The JAX
  engine has no kernel route at TwoArms (its dynamics kernels do not take
  the plan, and B4 needs their H^-1; ROADMAP C10): there the B4 twin is
  held against the JAX kernel body ``contact_kernel.solve_bl`` on the
  inputs the port's B4 route builds in a step from the capture's state
  (both scenes), at ``tests/test_torch_contact_kernel.py``'s rtol = atol =
  1e-4.

Tolerances: the ROADMAP ground rules (parity.GROUND_RULE_TOL: obs and qd
2e-3, q 2e-4, reward 1e-3) for everything computed from body poses; the
draws' maps, targets and forces rtol 1e-6 / atol 1e-6 (the same float32
arithmetic); flags, counters and resets exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.physics.engine import SimState as JSimState
from isaacgymenvs_ma_tpu.tasks import allegro_kuka as jak
from isaacgymenvs_ma_tpu.tasks import registry as jregistry
from isaacgymenvs_ma_tpu.tasks.base import EnvState as JEnvState
from isaacgymenvs_ma_tpu.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax
from isaacgymenvs_ma_tpu_torch.learning import checkpoint as pckpt
from isaacgymenvs_ma_tpu_torch.tasks import allegro_kuka as tak
from isaacgymenvs_ma_tpu_torch.tasks import registry as pregistry
from isaacgymenvs_ma_tpu_torch.utils.parity import (
    GROUND_RULE_TOL, KUKA_RESET_DRAWS, ONE_STEP_RESET_MISMATCHES, PRE_DRAWS,
    TOLERANCES, replay)
from test_torch_ball_balance import _assert_models_equal

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
GOLDEN = {"AllegroKuka": os.path.join(DATA, "allegro_kuka_golden.npz"),
          "AllegroKukaTwoArms": os.path.join(
              DATA, "allegro_kuka_two_arms_golden.npz")}
B4_GOLDEN = os.path.join(DATA, "allegro_kuka_b4_golden.npz")
SUBTASKS = {  # name -> (JAX class, port class, capture of its scene)
    "reorientation": (jak.AllegroKukaReorientation,
                      tak.AllegroKukaReorientation, "AllegroKuka"),
    "regrasping": (jak.AllegroKukaRegrasping, tak.AllegroKukaRegrasping,
                   "AllegroKuka"),
    "throw": (jak.AllegroKukaThrow, tak.AllegroKukaThrow, "AllegroKuka"),
    "two_arms_reorientation": (jak.AllegroKukaTwoArmsReorientation,
                               tak.AllegroKukaTwoArmsReorientation,
                               "AllegroKukaTwoArms"),
    "two_arms_regrasping": (jak.AllegroKukaTwoArmsRegrasping,
                            tak.AllegroKukaTwoArmsRegrasping,
                            "AllegroKukaTwoArms"),
}
N = 32
TOL = GROUND_RULE_TOL


def _cfg(n, **env):
    return deep_merge(jak.TASK_CFG, {"env": {"numEnvs": n, **env}})


def _pair(which, n=N, **env):
    jcls, pcls, _ = SUBTASKS[which]
    return jcls(_cfg(n, **env)), pcls(_cfg(n, **env), device="cpu", seed=3)


def _close(got, want, atol, what, rtol=0.0):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _states(jt, pt, scene):
    """The JAX and the port env states of ``scene``'s capture at the
    warmed-up start (its physics scales from the JAX task)."""
    d = np.load(GOLDEN[scene])
    fields = jak.KukaTaskState._fields
    jstate = JEnvState(
        sim=JSimState(jnp.asarray(d["init_q"]), jnp.asarray(d["init_qd"])),
        progress=jnp.asarray(d["init_progress"]),
        reset_buf=jnp.asarray(d["init_reset_buf"]),
        rng=jax.random.PRNGKey(11),
        task=jak.KukaTaskState(*(jnp.asarray(d[f"init_{f}"])
                                 for f in fields)),
        phys=jt.initial_phys(jax.random.PRNGKey(0)))
    arrays = {"sim.q": d["init_q"], "sim.qd": d["init_qd"],
              "progress": d["init_progress"],
              "reset_buf": d["init_reset_buf"]}
    arrays.update({f"task.{f}": d[f"init_{f}"] for f in fields})
    pstate = env_state_from_jax(arrays, "cpu")._replace(
        phys=pt.initial_phys())
    return jstate, pstate


def _jax_reset_draws(key, task):
    """AllegroKukaBase.reset_idx's draws from ``key`` as the port takes
    them (scripts/record_torch_golden.py ``kuka_draws``)."""
    n, nd = task.num_envs, task.nd
    u = jax.random.uniform
    ks = jax.random.split(key, 8)
    if isinstance(task, jak.AllegroKukaThrow):
        kg = jax.random.split(ks[0], 4)
        goal = (jnp.concatenate([
            u(kg[0], (n, 1), minval=-1.0, maxval=1.0),
            u(kg[1], (n, 1), minval=0.0, maxval=0.4),
            u(kg[2], (n, 1), minval=-1.0, maxval=0.7),
            u(kg[3], (n, 1), minval=0.0, maxval=1.0)], -1),
            jnp.zeros((n, 3)))
    else:
        k1, k2 = jax.random.split(ks[0])
        goal = (u(k1, (n, 3)), u(k2, (n, 3)))
    draws = goal + (u(ks[1], (n, nd)),
                    u(ks[2], (n, nd), minval=-1.0, maxval=1.0),
                    u(ks[3], (n, 3), minval=-1.0, maxval=1.0),
                    u(ks[4], (n, 3)), u(ks[5], (n,)))
    return tuple(torch.tensor(np.asarray(x)) for x in draws)


def _jax_pre_draws(rng, n):
    k1, k2 = jax.random.split(jax.random.fold_in(rng, 23))
    return (torch.tensor(np.asarray(jax.random.uniform(k1, (n,)))),
            torch.tensor(np.asarray(jax.random.normal(k2, (n, 3)))))


def _check_task(ptask, jtask, atol, what):
    for f in jak.KukaTaskState._fields:
        got, want = getattr(ptask, f), np.asarray(getattr(jtask, f))
        if want.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{what}: {f}")
        else:
            _close(got, want, atol, f"{what}: {f}", rtol=1e-6)


# ---------------------------------------------------------------- the scene
@pytest.mark.parametrize("which", sorted(SUBTASKS))
def test_subtask_sizes_match_jax(which):
    jt, pt = _pair(which, n=4)
    assert type(pt).__name__ == type(jt).__name__
    for k in ("num_obs", "num_actions", "num_states", "nd", "num_keypoints",
              "full_state_size", "reset_object_on_goal_reset", "num_arms"):
        assert getattr(pt, k) == getattr(jt, k), k
    np.testing.assert_array_equal(pt.keypoint_offsets, jt.keypoint_offsets)
    assert (pt.num_obs, pt.num_actions) == {
        "reorientation": (117, 23), "regrasping": (99, 23),
        "throw": (99, 23), "two_arms_reorientation": (204, 46),
        "two_arms_regrasping": (177, 46)}[which]
    jp, pp = _pair(which, n=4, privilegedActions=True)
    assert pp.num_actions == jp.num_actions == pt.num_actions + 3


@pytest.mark.parametrize("name,subtask", [
    ("AllegroKuka", "reorientation"), ("AllegroKuka", "regrasping"),
    ("AllegroKuka", "throw"), ("AllegroKukaLSTM", "reorientation"),
    ("AllegroKukaTwoArms", "reorientation"),
    ("AllegroKukaTwoArmsLSTM", "regrasping")])
def test_registry_resolves_subtasks(name, subtask):
    """``env.subtask`` picks the class through the resolvers, as in the
    JAX registry; the default config is the JAX TASK_CFG."""
    assert pregistry.task_default_config(name) == \
        jregistry.task_default_config(name)
    cfg = deep_merge(pregistry.task_default_config(name),
                     {"env": {"numEnvs": 4, "subtask": subtask}})
    pt = pregistry.create_task(name, cfg, seed=1, device="cpu")
    jt = jregistry.create_task(name, deep_merge(
        jregistry.task_default_config(name),
        {"env": {"numEnvs": 4, "subtask": subtask}}))
    assert type(pt).__name__ == type(jt).__name__
    assert pt.num_envs == 4 and pt.device.type == "cpu"


def test_cuboid_catalog_and_scales_bit_equal():
    for kw in ({}, {"small": False}, {"big": False, "sticks": False},
               {"sticks": False}):
        assert tak.cuboid_scale_catalog(**kw) == \
            jak.AllegroKukaBase._cuboid_scale_catalog(**kw)
    n = 300
    jt, pt = _pair("reorientation", n=n)
    np.testing.assert_array_equal(pt.object_scales_np, jt.object_scales_np)
    assert len(np.unique(pt.object_scales_np, axis=0)) > 50
    jph, pph = jt.initial_phys(jax.random.PRNGKey(0)), pt.initial_phys()
    np.testing.assert_array_equal(pph.shape.numpy(), np.asarray(jph.shape))
    for f in ("mass", "damping", "stiffness", "friction"):
        np.testing.assert_array_equal(getattr(pph, f).numpy(),
                                      np.asarray(getattr(jph, f)))
    off = _pair("reorientation", n=4, randomizeObjectDimensions=False)
    assert off[1].initial_phys() is None and \
        off[0].initial_phys(jax.random.PRNGKey(0)) is None


@pytest.mark.parametrize("scene", ["reorientation", "two_arms_reorientation"])
def test_scene_and_pairs_match_jax(scene):
    from isaacgymenvs_ma_tpu.models.specs.kuka_allegro import SPEC as JSPEC
    from isaacgymenvs_ma_tpu_torch.models.specs.kuka_allegro import SPEC
    assert SPEC == JSPEC
    jt, pt = _pair(scene, n=4)
    _assert_models_equal(pt.model, jt.model)
    je, te = jt.engine, pt.engine
    want = (26, 29, 21, 13) if pt.num_arms == 1 else (50, 52, 26, 18)
    assert (te.nb, te.nv, te.n_ground, te.n_pair_rows) == want
    assert (je.nb, je.nv, je.n_ground, je.n_pair_rows) == want
    np.testing.assert_array_equal(te.row_masks_np,
                                  np.asarray(je._row_masks_np()))
    np.testing.assert_array_equal(te.row_body_a, je.row_body_a)
    np.testing.assert_array_equal(te.row_body_b, je.row_body_b)
    # every fingertip and palm sphere against the cube, the cube against
    # the table: the same candidate points and targets
    assert len(te.pairs) == len(je.pairs) == 5 * pt.num_arms + 1
    for tp, jp in zip(te.pairs, je.pairs):
        np.testing.assert_array_equal(tp["pt_idx"], np.asarray(jp["pt_idx"]))
        assert (tp["tgt_body"], tp["tgt_type"]) == (int(jp["tgt_body"]),
                                                    int(jp["tgt_type"]))
    for k in ("palm_bodies", "fingertip_bodies", "ctl_dofs"):
        np.testing.assert_array_equal(getattr(pt, k), getattr(jt, k))
    for k in ("dof_lower", "dof_upper", "default_dof"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(jt, k)))
    assert pt.obj_mass == float(np.asarray(jt.model.mass)[jt.object_body])


# ---------------------------------------------------------------- the hooks
@pytest.mark.parametrize("which,privileged", [
    ("reorientation", False), ("reorientation", True),
    ("two_arms_reorientation", False)])
def test_pre_physics_matches_jax(which, privileged):
    """Targets and the object's force (and torque) with the JAX draws;
    the force trigger at 0.5 so that about half the envs fire."""
    jt, pt = _pair(which, privilegedActions=privileged)
    jst, pst = _states(jt, pt, SUBTASKS[which][2])
    jst = jst._replace(task=jst.task._replace(
        force_prob=jnp.full((N,), 0.5),
        rb_force=jnp.asarray(np.random.default_rng(1).normal(
            size=(N, 3)), jnp.float32)))
    pst = pst._replace(task=pst.task._replace(
        force_prob=torch.full((N,), 0.5),
        rb_force=torch.tensor(np.asarray(jst.task.rb_force))))
    acts = np.random.default_rng(2).uniform(
        -1.2, 1.2, (N, pt.num_actions)).astype(np.float32)
    jc = jt.pre_physics(jst, jnp.asarray(acts))
    draws = _jax_pre_draws(jst.rng, N)
    assert 0 < int((draws[0] < 0.5).sum()) < N
    pc = pt.pre_physics(pst, torch.tensor(acts), draws=draws)
    _close(pc.pos_target, jc.pos_target, 1e-6, "pos_target", rtol=1e-6)
    _close(pc.f_ext, jc.f_ext, 1e-6, "f_ext", rtol=1e-6)
    _close(pt._new_targets, jt._new_targets, 1e-6, "targets", rtol=1e-6)
    _close(pt._task_force, jt._task_force, 1e-6, "force", rtol=1e-6)
    assert not (pc.tau.any() or pc.vel_target.any())
    if privileged:
        assert np.abs(np.asarray(jc.f_ext)[:, jt.object_body, :3]).max() > 0


@pytest.mark.parametrize("which", sorted(SUBTASKS))
def test_reset_idx_matches_jax(which):
    """A quarter of the envs reset in full and another quarter only
    resample their goal (deferred ``goal_reset``); Regrasping and Throw
    put those envs' objects back too."""
    jt, pt = _pair(which)
    jst, pst = _states(jt, pt, SUBTASKS[which][2])
    mask = np.arange(N) % 4 == 0
    goal_reset = (np.arange(N) % 4 == 1).astype(np.int32)
    g = np.random.default_rng(5)
    lifted = g.uniform(size=N) < 0.5
    succ = g.integers(0, 5, N).astype(np.float32)
    jtask = jst.task._replace(goal_reset=jnp.asarray(goal_reset),
                              lifted_object=jnp.asarray(lifted),
                              successes=jnp.asarray(succ))
    ptask = pst.task._replace(goal_reset=torch.tensor(goal_reset),
                              lifted_object=torch.tensor(lifted),
                              successes=torch.tensor(succ))
    key = jax.random.PRNGKey(7)
    jsim, jtask2 = jt.reset_idx(jst.sim, jtask, jnp.asarray(mask), key)
    psim, ptask2 = pt.reset_idx(pst.sim, ptask, torch.tensor(mask),
                                _jax_reset_draws(key, jt))
    _close(psim.q, jsim.q, 1e-6, "q", rtol=1e-6)
    _close(psim.qd, jsim.qd, 1e-6, "qd", rtol=1e-6)
    _check_task(ptask2, jtask2, 1e-6, which)
    # the object moved in the full resets, and in the goal-only ones
    # exactly where the subtask puts it back
    qa = pt.obj_qa
    moved = np.abs(psim.q[:, qa: qa + 7].numpy()
                   - np.asarray(jst.sim.q)[:, qa: qa + 7]).max(1) > 0
    np.testing.assert_array_equal(
        moved, mask | (goal_reset.astype(bool)
                       & pt.reset_object_on_goal_reset))


@pytest.mark.parametrize("which", sorted(SUBTASKS))
def test_post_physics_matches_jax(which):
    """From the capture's state: a third of the envs with their goal on
    the object (near the goal: success, bonus, goal_reset next step), some
    already lifted or at the episode's end, the curriculum due with mean
    successes above 3 (the tolerance steps down), unset closest
    distances in half."""
    jt, pt = _pair(which)
    jst, pst = _states(jt, pt, SUBTASKS[which][2])
    q = np.asarray(jst.sim.q)
    qa = jt.obj_qa
    near = np.arange(N) % 3 == 0
    goal = np.where(near[:, None], q[:, qa: qa + 7],
                    np.asarray(jst.task.goal_pose))
    if which in ("regrasping", "throw", "two_arms_regrasping"):
        goal[near, 3:] = [0, 0, 0, 1.0]
    g = np.random.default_rng(8)
    upd = dict(goal_pose=goal.astype(np.float32),
               lifted_object=g.uniform(size=N) < 0.3,
               prev_episode_successes=np.full(N, 4.0, np.float32),
               frames=np.float32(jt.tol_interval - 1),
               closest_keypoint_max_dist=np.where(
                   np.arange(N) % 2 == 0, -1.0,
                   g.uniform(0.05, 0.5, N)).astype(np.float32))
    progress = np.where(np.arange(N) % 5 == 0, jt.max_episode_length - 1,
                        g.integers(0, 100, N)).astype(np.int32)
    jst = jst._replace(progress=jnp.asarray(progress), task=jst.task._replace(
        **{k: jnp.asarray(v) for k, v in upd.items()}))
    pst = pst._replace(progress=torch.tensor(progress),
                       task=pst.task._replace(
                           **{k: torch.tensor(v) for k, v in upd.items()}))
    acts = np.random.default_rng(9).uniform(
        -1, 1, (N, pt.num_actions)).astype(np.float32)
    jt.pre_physics(jst, jnp.asarray(acts))
    pt.pre_physics(pst, torch.tensor(acts),
                   draws=_jax_pre_draws(jst.rng, N))
    jout = jt.engine.forward(jst.sim)
    pout = pt.engine.forward(pst.sim)
    jo, _, jr, jreset, jtask, jx = jt.post_physics(jst, jout,
                                                   jnp.asarray(acts))
    po, ps, pr, preset, ptask, px = pt.post_physics(pst, pout,
                                                    torch.tensor(acts))
    assert ps is None and po.shape == (N, pt.num_obs)
    _close(po, jo, TOL["obs"], "obs")
    _close(pr, jr, TOL["rew"], "reward", rtol=1e-6)
    np.testing.assert_array_equal(preset.numpy(), np.asarray(jreset))
    succ = np.asarray(jx["_reset_progress_mask"])
    assert succ[near].all() and np.asarray(jreset).any()
    np.testing.assert_array_equal(px["_reset_progress_mask"].numpy(), succ)
    for k in ("successes", "true_objective", "true_objective_mean",
              "consecutive_successes"):
        _close(px[k], jx[k], 1e-6, k, rtol=1e-6)
    _check_task(ptask, jtask, TOL["obs"], which)
    # the curriculum stepped the tolerance down
    assert float(ptask.success_tolerance) < jt.initial_tolerance
    assert float(ptask.last_curriculum_update) == jt.tol_interval


def test_episode_clock_restarts_on_success():
    """The base step zeroes ``progress`` where ``post_physics`` reports a
    success, after the time-outs were read from the old clock, and drops
    the mask from the extras."""
    _, pt = _pair("reorientation", n=8)
    st = pt.initial_state()
    st, _ = pt.step(st, torch.zeros(8, pt.num_actions))      # every env reset
    q = st.sim.q
    qa = pt.obj_qa
    near = torch.arange(8) % 2 == 0
    goal = torch.where(near[:, None], q[:, qa: qa + 7], st.task.goal_pose)
    progress = torch.full((8,), 40, dtype=torch.int32)
    st = st._replace(progress=progress, reset_buf=torch.zeros_like(progress),
                     task=st.task._replace(goal_pose=goal))
    st2, res = pt.step(st, torch.zeros(8, pt.num_actions))
    succ = st2.task.goal_reset > 0
    assert succ[near].all() and not succ[~near].any()
    np.testing.assert_array_equal(
        st2.progress.numpy(), np.where(succ.numpy(), 0, 41))
    assert "_reset_progress_mask" not in res.extras
    assert not res.extras["time_outs"].any()
    # the next step resamples those envs' goals (deferred goal reset)
    st3, _ = pt.step(st2, torch.zeros(8, pt.num_actions))
    assert not torch.equal(st3.task.goal_pose[near], goal[near])
    assert torch.equal(st3.task.goal_pose[~near], goal[~near])


def test_curriculum_through_a_checkpoint(tmp_path):
    """``get_env_state`` / ``set_env_state`` carry the success tolerance,
    as the JAX task's do, and through a learner checkpoint."""
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config)
    from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
    jt, pt = _pair("reorientation", n=4)
    jst = jt.set_env_state(jt.initial_state(jax.random.PRNGKey(0)),
                           {"success_tolerance": 0.03})
    pst = pt.set_env_state(pt.initial_state(), {"success_tolerance": 0.03})
    assert float(pt.get_env_state(pst)["success_tolerance"]) == \
        float(jt.get_env_state(jst)["success_tolerance"])
    assert pt.set_env_state(pst, None) is pst
    tcfg = train_default_config("AllegroKukaLSTM")
    tcfg["params"]["config"]["minibatch_size"] = 16
    tcfg["params"]["network"]["mlp"]["units"] = [32]
    tcfg["params"]["network"]["rnn"]["units"] = 16
    agent = PPOAgent(pt, tcfg, seed=1)
    agent.init()
    agent.env_state = pt.set_env_state(agent.env_state,
                                       {"success_tolerance": 0.02})
    path = str(tmp_path / "k.pth")
    pckpt.save_checkpoint(path, agent.state_dict(),
                          env_state_extra=pt.get_env_state(agent.env_state))
    state, extra, _ = pckpt.load_checkpoint(path)
    other = PPOAgent(pt, tcfg, seed=2)
    other.init()
    assert float(other.env_state.task.success_tolerance) == \
        pytest.approx(0.075)
    other.load_state_dict(state)
    other.env_state = pt.set_env_state(other.env_state, extra)
    assert float(other.env_state.task.success_tolerance) == \
        pytest.approx(0.02)
    assert other.env_state.task.lifted_object.dtype == torch.bool
    assert other.env_state.task.near_goal_steps.dtype == torch.int32
    assert all(torch.equal(a, b) for a, b in zip(agent.carry, other.carry))


def test_train_entry_point_runs_allegro_kuka_lstm(tmp_path, monkeypatch):
    """``train.py task=AllegroKukaLSTM`` (a narrow LSTM here) trains an
    epoch through the recurrent path, saves the curriculum beside the
    learner state and restores it; playing an LSTM policy raises, as the
    JAX player has no carry either."""
    from isaacgymenvs_ma_tpu_torch import train as ptrain
    from isaacgymenvs_ma_tpu_torch.learning.networks import ActorCriticLSTM
    monkeypatch.chdir(tmp_path)
    args = ["task=AllegroKukaLSTM", "num_envs=4", "max_iterations=1",
            "sim_device=cpu", "train.params.config.horizon_length=8",
            "train.params.config.seq_len=4",
            "train.params.config.minibatch_size=16",
            "train.params.config.mini_epochs=1",
            "train.params.network.mlp.units=[32, 32]",
            "train.params.network.rnn.units=16"]
    agent = ptrain.launch(args)
    assert isinstance(agent.net, ActorCriticLSTM) and agent.is_rnn
    assert agent.carry[0].shape == (4, 16)
    ckpt = next((tmp_path / "runs").glob("AllegroKuka_*/nn/AllegroKuka.pth"))
    _, extra, _ = pckpt.load_checkpoint(str(ckpt))
    assert float(extra["success_tolerance"]) == pytest.approx(0.075)
    with pytest.raises(NotImplementedError, match="recurrent"):
        ptrain.launch(args + ["test=True", f"checkpoint={ckpt}"])


# ---------------------------------------------------------------- captures
@pytest.mark.parametrize("scene", sorted(GOLDEN))
def test_capture_format(scene):
    d = np.load(GOLDEN[scene])
    T, n = d["actions"].shape[:2]
    assert (T, n) == (6, N) and str(d["task"]) == scene
    A, O = (23, 117) if scene == "AllegroKuka" else (46, 204)
    assert d["actions"].shape[2] == A and d["obs"].shape == (T, n, O)
    for k in KUKA_RESET_DRAWS + PRE_DRAWS[scene]:
        assert d[k].shape[:2] == (T, n), k
    assert d["init_phys_shape"].shape[1:] == ((26, 3) if A == 23
                                              else (50, 3))
    assert d["spread_qd"].shape == (T, n) and d["start_q"].shape == (
        T, n, d["init_q"].shape[1])
    assert TOLERANCES[scene] is GROUND_RULE_TOL


@pytest.mark.parametrize("scene,kernel_route,n", [
    ("AllegroKuka", False, 32), ("AllegroKuka", True, 128),
    ("AllegroKukaTwoArms", False, 32)], ids=["loop", "b4", "two_arms_loop"])
def test_golden_replay_on_cpu_twins(scene, kernel_route, n):
    path = B4_GOLDEN if kernel_route else GOLDEN[scene]
    assert np.load(path)["actions"].shape[1] == n
    e = replay(path, "cpu", use_contact_kernel=kernel_route)
    assert e.finite
    for k, tol in TOLERANCES[scene].items():
        errs = getattr(e, k)
        assert (errs <= tol).all(), f"{k} per-step errors {errs} > {tol}"
    assert (e.reset_mismatches <= ONE_STEP_RESET_MISMATCHES).all()
    assert (e.wild_envs <= 4).all(), e.wild_envs


@pytest.mark.parametrize("scene", sorted(GOLDEN))
def test_b4_twin_matches_jax_solve_bl(scene, monkeypatch):
    """The B4 twin on the inputs the port's B4 route hands it in one step
    from the capture's state (34 / 44 candidate rows with frames, the
    cube's pair rows shape-scaled) against the JAX kernel body; the rows
    are live (contacts with the table and between fingers and cube)."""
    import inspect
    from types import SimpleNamespace
    from isaacgymenvs_ma_tpu.physics import contact_kernel as jck
    from isaacgymenvs_ma_tpu_torch.physics import contact_kernel as ck
    from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
    d = np.load(GOLDEN[scene])
    jcls, pcls, _ = SUBTASKS["reorientation" if scene == "AllegroKuka"
                             else "two_arms_reorientation"]
    cfg = _cfg(N)
    pt = pcls(cfg, device="cpu", seed=3, sim_params=parse_sim_params(
        cfg["sim"])._replace(use_contact_kernel=True))
    _, st = _states(jcls(_cfg(N)), pt, scene)
    calls = []
    twin = ck.solve_bl

    def spy(plan, *a, **k):
        calls.append((plan, a, k))
        return twin(plan, *a, **k)

    monkeypatch.setattr(ck, "solve_bl", spy)
    pt.step(st, torch.as_tensor(d["actions"][0]),
            reset_draws=tuple(torch.as_tensor(d[k][0])
                              for k in KUKA_RESET_DRAWS),
            pre_draws=tuple(torch.as_tensor(d[k][0])
                            for k in PRE_DRAWS[scene]))
    assert len(calls) == pt.sim_params.substeps
    for plan, a, k in calls:
        assert plan.P == (34 if scene == "AllegroKuka" else 44)
        got = twin(plan, *a, **k)
        args = inspect.signature(twin).bind(plan, *a, **k).arguments
        ref = jck.solve_bl(
            SimpleNamespace(relaxation=plan.relaxation,
                            num_iterations=plan.num_iterations),
            masks={"c": jnp.asarray(plan.masks["c"])},
            **{n: None if x is None else jnp.asarray(x.numpy())
               for n, x in args.items() if n != "plan"})
        for name, x, y in zip(("qd", "lam", "imp_dof"), got, ref):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
        assert float(np.abs(np.asarray(ref[1])).max()) > 0.01
