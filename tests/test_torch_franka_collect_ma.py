"""Port parity of FrankaCollectMA (isaacgymenvs_ma_tpu_torch/tasks/
franka_collect_ma.py) against the JAX package, on the CPU.

Nothing here jits the JAX FrankaCollectMA step (minutes to compile): the
state is the warmed-up initial state of the committed JAX capture
(tests/data/torch_port/franka_collect_ma_golden.npz, 16 envs x 2 arms, with
each agent's cube on its grip site and its gripper closing in envs 4-11:
live grabs; replayed whole in tests/test_torch_golden.py), and the JAX
methods run eagerly on it.  Tolerances, each with its reason:

* The scene, the FSM tables, the resets with injected draws, the gripper
  targets and the grab activation: exact.
* OSC torques (``pre_physics``' tau): rtol = atol = 2e-3, the JAX
  package's own bound for the sweep-based OSC against the LU form
  (tests/test_contact_opt.py:83-110), as in
  tests/test_torch_franka_reach_ma.py.
* ``post_physics`` on the same readouts (obs, reward, extras): rtol 1e-5 /
  atol 1e-6: the same float32 expressions (exp and norms may round one
  ulp apart); on the engines' own readouts (B1's twin against the JAX
  ``fk``, 1e-6 apart in position) atol 1e-5.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.physics.engine import (
    SimOutput as JSimOutput, SimState as JSimState)
from isaacgymenvs_ma_tpu.tasks import franka_collect_ma as jfc
from isaacgymenvs_ma_tpu.tasks.base import EnvState as JEnvState
from isaacgymenvs_ma_tpu.utils.config import deep_merge as jdeep_merge
from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax
from isaacgymenvs_ma_tpu_torch.models.model import DRIVE_POS
from isaacgymenvs_ma_tpu_torch.physics.engine import SimOutput, SimState
from isaacgymenvs_ma_tpu_torch.tasks import franka_collect_ma as fc
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
from test_torch_franka_reach_ma import _assert_models_equal

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
N = 16


def load_pair(jmod, tcls, fname, n=N):
    """The JAX and the port task at ``n`` envs and the capture's initial
    state in both packages' types."""
    d = np.load(os.path.join(DATA, fname))
    jt = getattr(jmod, tcls.__name__)(
        jdeep_merge(jmod.TASK_CFG, {"env": {"numEnvs": n}}))
    tt = tcls(deep_merge(jmod.TASK_CFG, {"env": {"numEnvs": n}}),
              device="cpu")
    jst = JEnvState(
        sim=JSimState(jnp.asarray(d["init_q"]), jnp.asarray(d["init_qd"])),
        progress=jnp.asarray(d["init_progress"]),
        reset_buf=jnp.asarray(d["init_reset_buf"]),
        rng=jax.random.PRNGKey(7),
        task=jfc.CollectTaskState(actions=jnp.asarray(d["init_actions"]),
                                  fsm=jnp.asarray(d["init_fsm"])))
    tst = env_state_from_jax(
        {"sim.q": d["init_q"], "sim.qd": d["init_qd"],
         "progress": d["init_progress"], "reset_buf": d["init_reset_buf"],
         "task.actions": d["init_actions"], "task.fsm": d["init_fsm"]},
        "cpu")
    return dict(jt=jt, tt=tt, jst=jst, tst=tst, d=d)


@pytest.fixture(scope="module")
def fc_pair():
    return load_pair(jfc, fc.FrankaCollectMA, "franka_collect_ma_golden.npz")


def assert_scene_matches(jt, tt):
    """The composed scene, the engine's rows, pairs and grabs, and the
    task's index sets equal the JAX package's."""
    _assert_models_equal(tt.model, jt.model)
    je, e = jt.engine, tt.engine
    assert (e.n_ground, e.n_pair_rows) == (je.n_ground, je.n_pair_rows)
    np.testing.assert_array_equal(e.row_masks_np, je._row_masks_np())
    np.testing.assert_array_equal(e.row_body_a, je.row_body_a)
    np.testing.assert_array_equal(e.row_body_b, je.row_body_b)
    assert len(e.pairs) == len(je.pairs)
    for p, jp in zip(e.pairs, je.pairs):
        np.testing.assert_array_equal(p["pt_idx"], jp["pt_idx"])
        assert p["tgt_body"] == jp["tgt_body"] and p["mu"] == jp["mu"]
    assert [(g["body_a"], g["body_b"]) for g in e.grabs] == [
        (g["body_a"], g["body_b"]) for g in je.grabs]
    for g, jg in zip(e.grabs, je.grabs):
        np.testing.assert_array_equal(g["mask"], np.asarray(jg["mask"]))
        np.testing.assert_array_equal(g["off_a"].numpy(),
                                      np.asarray(jg["off_a"]))
        np.testing.assert_array_equal(g["off_b"].numpy(),
                                      np.asarray(jg["off_b"]))
    for name in ("arm_dofs", "gripper_dofs", "hand_bodies", "grip_bodies",
                 "cube_q_adr", "cube_v_adr"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name),
                                      err_msg=name)
    np.testing.assert_array_equal(tt.cube_bodies, jt._cube_bodies)
    # the gripper drives set on reach's model survive composing the scene
    m = tt.model
    for d in tt.gripper_dofs.reshape(-1):
        assert (m.dof_drive_mode[d], m.dof_stiffness[d],
                m.dof_drive_damping[d]) == (DRIVE_POS, 800.0, 40.0)
    np.testing.assert_array_equal(tt.base_pos.numpy(), np.asarray(jt.base_pos))
    np.testing.assert_array_equal(tt.base_quat.numpy(),
                                  np.asarray(jt.base_quat))


def test_collect_scene_matches_jax(fc_pair):
    """36 bodies (reach's 35 and the wall), 32 ground rows (the wall's 8
    corners ~1 m up among them), 33 pair rows (16 cube corners against the
    table, 16 against the wall, the hand spheres), 4 grabs (grip site 0
    with cubes 0 and 1, then grip site 1)."""
    jt, tt = fc_pair["jt"], fc_pair["tt"]
    e = tt.engine
    assert (e.nb, e.nq, e.nv) == (36, 32, 30)
    assert (e.n_ground, e.n_pair_rows, len(e.grabs)) == (32, 33, 4)
    assert [(g["body_a"], g["body_b"]) for g in e.grabs] == [
        (gb, cb) for gb in tt.grip_bodies for cb in tt.cube_bodies]
    assert_scene_matches(jt, tt)
    assert (tt.num_obs, tt.num_actions, tt.rl_games_batch) == (28, 7, 2 * N)
    assert tt.max_episode_length == 300


class _JShim:
    _fsm = jfc.FrankaCollectMA._fsm
    _global_fsm = jfc.FrankaCollectMA._global_fsm


def seeded_fsm_inputs(seed, n=256):
    """md around the 2.25 cm grab distance, grippers open or closed, and
    nearest-cube positions around the wall, the area behind it and the
    heights of the FSM's thresholds."""
    g = np.random.default_rng(seed)
    md = g.choice([0.0, 0.01, 0.0225, 0.02250001, 0.03, 1.0], (n, 2))
    closed = g.uniform(size=(n, 2)) < 0.5
    pos = np.stack([
        g.choice([0.0, 0.3, 0.59, 0.61, -0.7], (n, 2)),
        g.choice([0.0, 0.3, 0.35, 0.36, 0.5], (n, 2)),
        g.choice([1.06, 1.1, 1.2, 1.4, 1.05 + fc.WALL_HEIGHT / 4,
                  1.05 + fc.WALL_HEIGHT + fc.CUBE_SIZE], (n, 2))], -1)
    return (md.astype(np.float32), closed, pos.astype(np.float32))


def test_fsm_tables_match_jax():
    """``_fsm`` and ``_global_fsm`` on seeded tables, and
    tests/test_fsm_ma.py's cases, exactly."""
    md, closed, pos = seeded_fsm_inputs(0)
    tt = fc.FrankaCollectMA.__new__(fc.FrankaCollectMA)
    ref = np.asarray(_JShim()._fsm(jnp.asarray(md), jnp.asarray(closed),
                                   jnp.asarray(pos)))
    got = tt._fsm(torch.as_tensor(md), torch.as_tensor(closed),
                  torch.as_tensor(pos))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(np.unique(ref)) >= {0, 1, 2, 3, 4, 5}
    fsm = np.random.default_rng(1).integers(0, 7, (256, 2)).astype(np.int32)
    fsm = np.concatenate([fsm, [[0, 0], [2, 0], [2, 2], [6, 6]]])
    ref = np.asarray(_JShim()._global_fsm(jnp.asarray(fsm)))
    got = fc.FrankaCollectMA._global_fsm(torch.as_tensor(fsm)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[-4:], [0, 1, 3, 7])


def fabricated_readout(jt, tt, d, seed):
    """A state and readout for the reward on seeded tables: the capture's
    initial q with the cubes moved about the wall and the area behind it,
    each agent's grip site at its cube or further off, and seeded gripper
    actions; as JAX and port (state, out, actions)."""
    g = np.random.default_rng(seed)
    n, K = N, jt.num_agents
    q = d["init_q"].copy()
    for t, qa in enumerate(jt.cube_q_adr):
        q[:, qa: qa + 3] = np.stack([
            g.choice([0.0, 0.3, 0.61], n), g.choice([0.0, 0.36, 0.5], n),
            g.choice([1.06, 1.12, 1.2, 1.4], n)], -1)
    nb = jt.engine.nb
    body_pos = g.uniform(-1, 1, (n, nb, 3)).astype(np.float32)
    body_quat = g.normal(size=(n, nb, 4))
    body_quat = (body_quat / np.linalg.norm(body_quat, axis=-1,
                                            keepdims=True)).astype(np.float32)
    for k, gb in enumerate(jt.grip_bodies):
        off = g.choice([0.0, 0.01, 0.05], (n, 1)) * g.normal(size=(n, 3))
        qa = jt.cube_q_adr[k]
        body_pos[:, gb] = q[:, qa: qa + 3] + off
    actions = g.uniform(-1, 1, (n * K, 7)).astype(np.float32)
    z = np.zeros
    jout = JSimOutput(jnp.asarray(body_pos), jnp.asarray(body_quat),
                      *(jnp.asarray(z(s, np.float32)) for s in (
                          (n, nb, 6), (n, 1, 13), (n, nb, 3), (n, 0, 6),
                          (n, 30), (n, 30))))
    tout = SimOutput(torch.as_tensor(body_pos), torch.as_tensor(body_quat),
                     *(torch.zeros(s) for s in (
                         (n, nb, 6), (n, 1, 13), (n, nb, 3), (n, 0, 6),
                         (n, 30), (n, 30))))
    prog = np.where(np.arange(n) % 3 == 0, 299, 5).astype(np.int32)
    return q, prog, jout, tout, actions


def compare_post_physics(jt, tt, jst, tst, jout, tout, actions, atol):
    """Both packages' ``post_physics``; returns the JAX task state."""
    ref = jt.post_physics(jst, jout, jnp.asarray(actions))
    got = tt.post_physics(tst, tout, torch.as_tensor(actions))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=atol, err_msg="obs")
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-5, atol=atol, err_msg="rew")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(got[4].actions.numpy(),
                                  np.asarray(ref[4].actions))
    assert got[4].fsm.dtype == torch.int32
    np.testing.assert_array_equal(got[4].fsm.numpy(), np.asarray(ref[4].fsm))
    flat = lambda e: {f"{k}/{k2}" if isinstance(v, dict) else k:  # noqa: E731
                      v2 for k, v in e.items()
                      for k2, v2 in (v.items() if isinstance(v, dict)
                                     else [(None, v)])}
    rx, gx = flat(ref[5]), flat(got[5])
    assert sorted(rx) == sorted(gx)
    for k in rx:
        np.testing.assert_allclose(gx[k].numpy(), np.asarray(rx[k]),
                                   rtol=1e-5, atol=atol, err_msg=k)
    return ref


def test_reward_on_seeded_tables_matches_jax(fc_pair):
    """``post_physics`` on fabricated readouts that put the agents in every
    FSM stage but the last (the JAX FSM never reaches 6 while holding):
    obs, the staged reward with BSR, time-outs, FSM and extras."""
    jt, tt, d = fc_pair["jt"], fc_pair["tt"], fc_pair["d"]
    q, prog, jout, tout, actions = fabricated_readout(jt, tt, d, 2)
    jst = fc_pair["jst"]._replace(
        sim=JSimState(jnp.asarray(q), jnp.asarray(d["init_qd"])),
        progress=jnp.asarray(prog))
    tst = fc_pair["tst"]._replace(
        sim=SimState(torch.as_tensor(q), torch.as_tensor(d["init_qd"])),
        progress=torch.as_tensor(prog))
    ref = compare_post_physics(jt, tt, jst, tst, jout, tout, actions, 1e-6)
    assert set(np.unique(np.asarray(ref[4].fsm))) >= {0, 1, 2, 3, 4}
    assert np.asarray(ref[3]).any() and not np.asarray(ref[3]).all()


def test_pre_physics_matches_jax(fc_pair):
    """OSC torques, the gripper targets and the grab activation from the
    capture's state and its first actions: the agents of envs 4-11 hold
    their cubes (grabs 0 and 3 live there, nothing elsewhere)."""
    jt, tt, d = fc_pair["jt"], fc_pair["tt"], fc_pair["d"]
    acts = d["actions"][0]
    ref = jt.pre_physics(fc_pair["jst"], jnp.asarray(acts))
    got = tt.pre_physics(fc_pair["tst"], torch.as_tensor(acts))
    np.testing.assert_allclose(got.tau.numpy(), np.asarray(ref.tau),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(got.pos_target.numpy(),
                                  np.asarray(ref.pos_target))
    np.testing.assert_array_equal(got.grab_active.numpy(),
                                  np.asarray(ref.grab_active))
    live = got.grab_active.numpy()
    assert live.sum() > 0
    expect = np.zeros((N, 4), np.float32)
    expect[d["grab_envs"][:, None], [0, 3]] = 1.0
    np.testing.assert_array_equal(live, expect)
    np.testing.assert_array_equal(
        np.unique(got.pos_target.numpy()[:, tt.gripper_dofs]),
        np.float32([0.0, 0.035]))


def test_post_physics_matches_jax(fc_pair):
    """``post_physics`` on each engine's own kinematic readout of the
    capture's state (``forward``) with its first actions: the holding
    agents are in FSM stage 2."""
    jt, tt, d = fc_pair["jt"], fc_pair["tt"], fc_pair["d"]
    jout = jt.engine.forward(fc_pair["jst"].sim)
    tout = tt.engine.forward(fc_pair["tst"].sim)
    ref = compare_post_physics(jt, tt, fc_pair["jst"], fc_pair["tst"], jout,
                               tout, d["actions"][0], 1e-5)
    fsm = np.asarray(ref[4].fsm)
    assert (fsm[d["grab_envs"]] == 2).all()


def test_reset_idx_matches_jax(fc_pair):
    """Half the envs reset with the JAX draws injected: arm dofs, cube
    poses, zeroed velocities and cached actions exactly; the FSM state
    carries over unchanged, as in JAX."""
    jt, tt = fc_pair["jt"], fc_pair["tt"]
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    K, T = jt.num_agents, jt.num_targets
    draws = (jax.random.uniform(k1, (N, K, 9)),
             jax.random.uniform(k2, (N, T, 2)), jax.random.uniform(k3, (N, T)))
    mask = np.arange(N) % 2 == 0
    jst, tst = fc_pair["jst"], fc_pair["tst"]
    jst = jst._replace(task=jst.task._replace(fsm=jnp.ones((N, K), jnp.int32)))
    tst = tst._replace(task=tst.task._replace(
        fsm=torch.ones((N, K), dtype=torch.int32)))
    jsim, jtask = jt.reset_idx(jst.sim, jst.task, jnp.asarray(mask), key)
    tsim, ttask = tt.reset_idx(
        tst.sim, tst.task, torch.as_tensor(mask),
        tuple(torch.tensor(np.asarray(x)) for x in draws))
    np.testing.assert_array_equal(tsim.q.numpy(), np.asarray(jsim.q))
    np.testing.assert_array_equal(tsim.qd.numpy(), np.asarray(jsim.qd))
    np.testing.assert_array_equal(ttask.actions.numpy(),
                                  np.asarray(jtask.actions))
    np.testing.assert_array_equal(ttask.fsm.numpy(), np.asarray(jtask.fsm))
    assert ttask.fsm.dtype == torch.int32 and int(ttask.fsm.sum()) == N * K
