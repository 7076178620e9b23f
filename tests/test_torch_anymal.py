"""Port parity of Anymal and AnymalTerrain
(isaacgymenvs_ma_tpu_torch/tasks/anymal.py, anymal_terrain.py) against
the JAX package, on the CPU (the terrain itself and the engine's terrain
rows: tests/test_torch_terrain.py).

Nothing here jits a JAX step: the states are the warmed-up initial states
of the committed JAX captures (tests/data/torch_port/anymal_golden.npz and
anymal_terrain_golden.npz, 32 envs; replayed whole in
tests/test_torch_golden.py) and the JAX pieces run eagerly on them.
Tolerances, each with its reason:

* The scenes: bit-equal.  ``pre_physics`` and the resets with injected
  draws (the curriculum's promotions and demotions included): exact.
* ``post_physics`` on the same readouts: rtol 1e-5 / atol 1e-5 (the same
  float32 expressions; exp, atan2 and norms may round one ulp apart).
* One Anymal engine step (compaction to 16 of 68 rows; the B4 route
  solves all 68): the ROADMAP's q rtol 2e-4 / atol 2e-5, qd 2e-3.
* B4's twin against the JAX ``solve_bl``: rtol = atol = 1e-4.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.physics.engine import SimState as JSimState
from isaacgymenvs_ma_tpu.tasks import anymal as jany
from isaacgymenvs_ma_tpu.tasks import anymal_terrain as jat
from isaacgymenvs_ma_tpu_torch.physics.engine import SimState
from isaacgymenvs_ma_tpu_torch.tasks import anymal as tany
from isaacgymenvs_ma_tpu_torch.tasks import anymal_terrain as tat
from test_torch_humanoid import (
    N, assert_engine_scene_matches, capture_b4_inputs, compare_b4_twin,
    compare_engine_step, load_pair, port_out, to_torch)

torch.set_num_threads(1)   # small CPU ops: one thread a test worker


@pytest.fixture(scope="module")
def ap():
    return load_pair(jany, tany.Anymal, "anymal_golden.npz")


@pytest.fixture(scope="module")
def atp():
    return load_pair(jat, tat.AnymalTerrain, "anymal_terrain_golden.npz")


def compare_post(jout, pair, jst, tst, actions, draws=None, tdraws=None):
    """Both packages' ``post_physics`` on the same readout; returns the JAX
    result and the port's."""
    jt, tt = pair["jt"], pair["tt"]
    ref = jt.post_physics(jst, jout, jnp.asarray(actions))
    kw = {} if tdraws is None else {"draws": tdraws}
    got = tt.post_physics(tst, port_out(jout), torch.as_tensor(actions), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-5, err_msg="obs")
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-5,
                               atol=1e-5, err_msg="rew")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for f in ref[4]._fields:
        np.testing.assert_allclose(getattr(got[4], f).numpy(),
                                   np.asarray(getattr(ref[4], f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    return ref, got


# ---------------------------------------------------------------- Anymal
def test_anymal_scene_matches_jax(ap):
    """13 bodies, nv 18 (12 PD-driven joints, kp 85 / kd 2), 68 ground
    candidate rows; the default joint angles in tree order, the knees
    (THIGH bodies); H is one 18-dof block."""
    jt, tt = ap["jt"], ap["tt"]
    e = tt.engine
    assert (e.nb, e.nv, e.n_ground) == (13, 18, 68)
    assert_engine_scene_matches(jt, tt)
    np.testing.assert_array_equal(tt.default_dof_pos.numpy(),
                                  np.asarray(jt.default_dof_pos))
    np.testing.assert_array_equal(tt.knee_indices.numpy(), jt.knee_indices)
    assert tt.rew_scales == jt.rew_scales
    assert tt.max_episode_length == jt.max_episode_length == 2500
    assert e.plan.blocks == [list(range(18))]
    cp = ap["tb4"].engine.cplan
    assert (cp.P, cp.nv, cp.has_frames) == (68, 18, False)


def test_anymal_pre_physics_and_reset_match_jax(ap):
    """PD targets exactly; half the envs reset with the JAX draws injected:
    dof positions, velocities, base pose and commands exactly."""
    jt, tt, d = ap["jt"], ap["tt"], ap["d"]
    a = d["actions"][0]
    ref = jt.pre_physics(ap["jst"], jnp.asarray(a))
    got = tt.pre_physics(ap["tst"], torch.as_tensor(a))
    for f in ("tau", "pos_target", "vel_target"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    key = jax.random.PRNGKey(5)
    ks = jax.random.split(key, 5)
    u = jax.random.uniform
    draws = (u(ks[0], (N, 12), minval=0.5, maxval=1.5),
             u(ks[1], (N, 12), minval=-0.1, maxval=0.1),
             u(ks[2], (N,), minval=-2.0, maxval=2.0),
             u(ks[3], (N,), minval=-1.0, maxval=1.0),
             u(ks[4], (N,), minval=-1.0, maxval=1.0))
    mask = np.arange(N) % 2 == 1
    jsim, jtask = jt.reset_idx(ap["jst"].sim, ap["jst"].task,
                               jnp.asarray(mask), key)
    tsim, ttask = tt.reset_idx(ap["tst"].sim, ap["tst"].task,
                               torch.as_tensor(mask),
                               tuple(to_torch(x) for x in draws))
    np.testing.assert_array_equal(tsim.q.numpy(), np.asarray(jsim.q))
    np.testing.assert_array_equal(tsim.qd.numpy(), np.asarray(jsim.qd))
    for f in jtask._fields:
        np.testing.assert_array_equal(getattr(ttask, f).numpy(),
                                      np.asarray(getattr(jtask, f)))


def test_anymal_post_physics_matches_jax(ap):
    """On one JAX engine step's readout, with knees and a base pushed into
    the ground in some envs (their contact forces read from compacted
    impulses): obs, reward, the contact terminations."""
    jt, d = ap["jt"], ap["d"]
    q = d["init_q"].copy()
    q[::4, 2] -= 0.45          # bases low enough for knee and base contact
    jsim = JSimState(jnp.asarray(q), jnp.asarray(d["init_qd"]))
    a = d["actions"][0]
    jctrl = jt.pre_physics(ap["jst"], jnp.asarray(a))
    _, jout = jt.engine.step(jsim, jctrl)
    jst = ap["jst"]._replace(sim=jsim)
    tst = ap["tst"]._replace(sim=SimState(torch.as_tensor(q),
                                          torch.as_tensor(d["init_qd"])))
    ref, _ = compare_post(jout, ap, jst, tst, a)
    reset = np.asarray(ref[3])
    assert reset[::4].all() and not reset[1::4].any()


@pytest.mark.parametrize("kernel_route", [False, True],
                         ids=["default_loop", "contact_kernel"])
def test_anymal_engine_step_matches_jax(ap, kernel_route):
    """One step with PD targets from the capture's state: the JAX default
    path (16 of 68 rows) against the port's default loop and B4 route."""
    a = ap["d"]["actions"][0]
    jctrl = ap["jt"].pre_physics(ap["jst"], jnp.asarray(a))
    tctrl = ap["tt"].pre_physics(ap["tst"], torch.as_tensor(a))
    _, jo = compare_engine_step(ap, jctrl, tctrl, kernel_route=kernel_route)
    assert float(np.abs(np.asarray(jo.contact_force)).max()) > 10.0


def test_b4_twin_matches_jax_on_anymal_plan(ap):
    a = torch.as_tensor(ap["d"]["actions"][0])
    plan = compare_b4_twin(capture_b4_inputs(
        ap["tb4"], ap["tst"].sim, ap["tb4"].pre_physics(ap["tst"], a)))
    assert (plan.P, plan.nv) == (68, 18)


# ---------------------------------------------------------------- AnymalTerrain
def test_anymal_terrain_config_matches_jax(atp):
    """The decimation fold (4 substeps of 5 ms, no mass-matrix reuse), the
    episode and push intervals, the reward scales, the noise vector, the
    140 height points, the terrain kinds per type column and the index
    sets."""
    jt, tt = atp["jt"], atp["tt"]
    p = tt.sim_params
    assert (p.substeps, p.dt, p.reuse_mass_matrix, p.contact_capacity) == (
        4, 0.02, False, 16)
    assert (tt.max_episode_length, tt.push_interval) == (1000, 750)
    assert tt.rew_scales == jt.rew_scales
    np.testing.assert_array_equal(tt.noise_scale_vec.numpy(),
                                  np.asarray(jt.noise_scale_vec))
    np.testing.assert_array_equal(tt.height_points[:, :2].numpy(),
                                  np.asarray(jt.height_points))
    np.testing.assert_array_equal(tt._type_kind.numpy(),
                                  np.asarray(jt._type_kind))
    np.testing.assert_array_equal(tt.default_dof_pos.numpy(),
                                  np.asarray(jt.default_dof_pos))
    for name in ("knee_indices", "feet_indices", "hip_dofs"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      getattr(jt, name), err_msg=name)
    assert_engine_scene_matches(jt, tt)
    # a sim_params given (parsed from the unfolded section) is folded too
    assert atp["tb4"].sim_params.substeps == 4
    assert atp["tb4"].sim_params.use_contact_kernel


def test_anymal_terrain_reset_idx_matches_jax(atp):
    """The curriculum on reset with the JAX draws injected: envs far from
    their origins promoted (level 9 wraps to 0), envs near theirs with
    commands demoted (level 0 stays), then placed at their new origins;
    dof and base state, commands and the cleared buffers exactly."""
    jt, tt = atp["jt"], atp["tt"]
    key = jax.random.PRNGKey(11)
    ks = jax.random.split(key, 7)
    u = jax.random.uniform
    draws = (u(ks[0], (N, 12), minval=0.5, maxval=1.5),
             u(ks[1], (N, 12), minval=-0.1, maxval=0.1),
             u(ks[2], (N, 2), minval=-0.5, maxval=0.5),
             u(ks[3], (N,), minval=-1.0, maxval=1.0),
             u(ks[4], (N,), minval=-1.0, maxval=1.0),
             u(ks[5], (N,), minval=-3.14, maxval=3.14))
    levels = (np.arange(N) % 10).astype(np.int32)
    q = atp["d"]["init_q"].copy()
    q[::3, 0] += 6.0                                  # far: promote
    cmds = np.zeros((N, 4), np.float32)
    cmds[1::3, 0] = 0.9                               # near with a command
    mask = np.arange(N) % 4 != 3
    jst = atp["jst"]._replace(sim=JSimState(jnp.asarray(q),
                                            atp["jst"].sim.qd),
                              task=atp["jst"].task._replace(
                                  terrain_levels=jnp.asarray(levels),
                                  commands=jnp.asarray(cmds)))
    tst = atp["tst"]._replace(sim=SimState(torch.as_tensor(q),
                                           atp["tst"].sim.qd),
                              task=atp["tst"].task._replace(
                                  terrain_levels=torch.as_tensor(levels),
                                  commands=torch.as_tensor(cmds)))
    jsim, jtask = jt.reset_idx(jst.sim, jst.task, jnp.asarray(mask), key)
    tsim, ttask = tt.reset_idx(tst.sim, tst.task, torch.as_tensor(mask),
                               tuple(to_torch(x) for x in draws))
    np.testing.assert_array_equal(tsim.q.numpy(), np.asarray(jsim.q))
    np.testing.assert_array_equal(tsim.qd.numpy(), np.asarray(jsim.qd))
    for f in jtask._fields:
        np.testing.assert_array_equal(getattr(ttask, f).numpy(),
                                      np.asarray(getattr(jtask, f)),
                                      err_msg=f)
    assert ttask.terrain_levels.dtype == torch.int32
    new = ttask.terrain_levels.numpy()
    assert (new != levels).any() and (new[~mask] == levels[~mask]).all()


@pytest.mark.parametrize("push", [False, True], ids=["plain", "push"])
def test_anymal_terrain_post_physics_matches_jax(atp, push):
    """``post_physics`` on one JAX engine step's readout (on its
    LocalTerrain windows) with the pushes and the observation noise
    injected: obs (the 140 height samples among them), the 13-term reward,
    the resets, the episode extras, the task state and, on the push step,
    the pushed base velocities the next step starts from."""
    jt, tt, d = atp["jt"], atp["tt"], atp["d"]
    jst, tst = atp["jst"], atp["tst"]
    step = tt.push_interval - 1 if push else 10
    jst = jst._replace(task=jst.task._replace(
        common_step=jnp.asarray(step, jnp.int32)), rng=jax.random.PRNGKey(9))
    tst = tst._replace(task=tst.task._replace(
        common_step=torch.tensor(step, dtype=torch.int32)))
    a = d["actions"][0]
    _, jout = jt.engine.step(jst.sim, jt.pre_physics(jst, jnp.asarray(a)),
                             terrain=jt.step_terrain(jst.sim))
    k_push = jax.random.fold_in(jst.rng, 17)
    k_noise = jax.random.fold_in(jst.rng, 23)
    draws = (jax.random.uniform(k_push, (N, 2), minval=-1.0, maxval=1.0),
             jax.random.uniform(k_noise, (N, 188)))
    ref, got = compare_post(jout, atp, jst, tst, a,
                            tdraws=tuple(to_torch(x) for x in draws))
    pushed = jt._pushed_sim
    np.testing.assert_array_equal(got[6].qd.numpy(), np.asarray(pushed.qd))
    np.testing.assert_array_equal(got[6].q.numpy(), np.asarray(pushed.q))
    moved = np.abs(np.asarray(pushed.qd) - np.asarray(jst.sim.qd)).max()
    assert (moved > 0) == push
    rx, gx = ref[5]["episode"], got[5]["episode"]
    assert sorted(rx) == sorted(gx)
    for k in rx:
        np.testing.assert_allclose(gx[k].numpy(), np.asarray(rx[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_anymal_terrain_steps_through_its_entry_points():
    """``registry.create_task`` builds AnymalTerrain on the CPU when asked
    (a smaller map: 2 levels x 5 types); three steps stay finite, the
    first resets every env onto its terrain origin."""
    from isaacgymenvs_ma_tpu_torch.tasks import registry
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    cfg = deep_merge(tat.TASK_CFG, {"env": {"numEnvs": 8, "terrain": {
        "numLevels": 2, "numTerrains": 5}}})
    task = registry.create_task("AnymalTerrain", cfg, device="cpu")
    assert tuple(task.terrain.heights.shape) == (560, 800)
    st = task.initial_state()
    for _ in range(3):
        st, res = task.step(st, torch.tanh(torch.randn(8, 12)))
    assert res.obs.shape == (8, 188) and torch.isfinite(res.obs).all()
    assert set(res.extras["episode"]) >= {"rew_lin_vel_xy", "terrain_level"}
    assert float(st.sim.q[:, 0].min()) > 20.0        # past the 20 m border
