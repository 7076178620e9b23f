"""Port parity of FrankaReachMA's path (isaacgymenvs_ma_tpu_torch/tasks/
franka_reach_ma.py) against the JAX package, on the CPU.

Nothing here jits the JAX FrankaReachMA step (75 s at 8 envs): the Franka
state is the warmed-up initial state of the committed JAX capture
(tests/data/torch_port/franka_reach_ma_golden.npz, 16 envs x 2 arms,
replayed whole in tests/test_torch_golden.py), and the JAX pieces run
eagerly on it.  Tolerances, each with its reason:

* OSC torques (``osc_torques``, and ``pre_physics``' tau): rtol = atol =
  2e-3, the JAX package's own bound for the sweep-based OSC against the LU
  form (tests/test_contact_opt.py:83-110); the JAX side inverts by the
  Schur form on the CPU, the port by the sweep.
* The controller readouts (``dynamics_readout``, ``point_jacobian``):
  rtol 1e-4 / atol 1e-5: the two FK paths (kernel-B1 twin against the JAX
  reference-layout ``fk``) round differently in float32, and the mass
  matrix sums 35 bodies' inertias.
* Resets with injected draws, the copied model and the scene: exact.
* One engine step with active-set compaction and contact-row reuse, on
  Ant (its committed capture's warmed-up state, 64 envs, 0-4 active rows
  per env): q rtol 2e-4 / atol 2e-5, qd 2e-3, readouts 2e-3 relative to
  their largest value, the bounds of tests/test_torch_ant_step.py.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.physics import controllers as jctrl
from isaacgymenvs_ma_tpu.physics.engine import (
    Control as JControl, SimState as JSimState)
from isaacgymenvs_ma_tpu.tasks import franka_reach_ma as jfr
from isaacgymenvs_ma_tpu.tasks.ant import Ant as JAnt, TASK_CFG as JANT_CFG
from isaacgymenvs_ma_tpu.tasks.base import EnvState as JEnvState
from isaacgymenvs_ma_tpu.utils.config import deep_merge as jdeep_merge
from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax
from isaacgymenvs_ma_tpu_torch.physics import engine as te
from isaacgymenvs_ma_tpu_torch.physics.controllers import osc_torques
from isaacgymenvs_ma_tpu_torch.physics.engine import (
    Control, PhysicsEngine, SimState)
from isaacgymenvs_ma_tpu_torch.tasks.ant import Ant, TASK_CFG as ANT_CFG
from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
from isaacgymenvs_ma_tpu_torch.tasks.franka_reach_ma import (
    FrankaReachMA, TASK_CFG)
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
N = 16


@pytest.fixture(scope="module")
def fr():
    """The JAX and the port FrankaReachMA at 16 envs, and the capture's
    warmed-up state (cubes on the table) in both packages' types."""
    d = np.load(os.path.join(DATA, "franka_reach_ma_golden.npz"))
    jt = jfr.FrankaReachMA(jdeep_merge(jfr.TASK_CFG, {"env": {"numEnvs": N}}))
    tt = FrankaReachMA(deep_merge(TASK_CFG, {"env": {"numEnvs": N}}),
                       device="cpu")
    jst = JEnvState(
        sim=JSimState(jnp.asarray(d["init_q"]), jnp.asarray(d["init_qd"])),
        progress=jnp.asarray(d["init_progress"]),
        reset_buf=jnp.asarray(d["init_reset_buf"]),
        rng=jax.random.PRNGKey(7),
        task=jfr.FrankaMATaskState(actions=jnp.asarray(d["init_actions"])))
    tst = env_state_from_jax(
        {"sim.q": d["init_q"], "sim.qd": d["init_qd"],
         "progress": d["init_progress"], "reset_buf": d["init_reset_buf"],
         "task.actions": d["init_actions"]}, "cpu")
    return dict(jt=jt, tt=tt, jst=jst, tst=tst, d=d)


def test_osc_torques_matches_jax():
    """On the inputs of tests/test_contact_opt.py:83-110."""
    rng = np.random.default_rng(0)
    B = 32
    A = rng.normal(size=(B, 7, 7)).astype(np.float32)
    mm = A @ np.swapaxes(A, 1, 2) + 3.0 * np.eye(7, dtype=np.float32)
    rest = [rng.normal(size=s).astype(np.float32)
            for s in ((B, 6, 7), (B, 6), (B, 7), (B, 7), (B, 6), (7,))]
    ref = jctrl.osc_torques(jnp.asarray(mm), *map(jnp.asarray, rest))
    got = osc_torques(torch.as_tensor(mm), *map(torch.as_tensor, rest))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-3,
                               atol=2e-3)
    lim = np.array([87.0] * 4 + [12.0] * 3, np.float32)
    ref = jctrl.osc_torques(jnp.asarray(mm), *map(jnp.asarray, rest),
                            effort_limit=jnp.asarray(lim))
    got = osc_torques(torch.as_tensor(mm), *map(torch.as_tensor, rest),
                      effort_limit=torch.as_tensor(lim))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-3,
                               atol=2e-3)


def test_dynamics_readout_matches_jax(fr):
    je, te_ = fr["jt"].engine, fr["tt"].engine
    ref = je.dynamics_readout(fr["jst"].sim)
    got = te_.dynamics_readout(fr["tst"].sim)
    for name, a, b in zip(("M", "body_x", "body_q", "S", "V"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    M = got[0].numpy()
    np.testing.assert_allclose(M, np.swapaxes(M, 1, 2), atol=1e-6)
    np.testing.assert_array_equal(te_.dof_qid, je.dof_qid)


def test_point_jacobian_matches_jax(fr):
    je, te_ = fr["jt"].engine, fr["tt"].engine
    _, jbx, _, jS, _ = je.dynamics_readout(fr["jst"].sim)
    _, bx, _, S, _ = te_.dynamics_readout(fr["tst"].sim)
    pt = np.random.default_rng(4).uniform(0.5, 1.5, (N, 3)).astype(np.float32)
    for body in (*fr["tt"].grip_bodies, *fr["tt"].hand_bodies):
        for point in (None, pt):
            ref = je.point_jacobian(
                jS, jbx, int(body),
                None if point is None else jnp.asarray(point))
            got = te_.point_jacobian(
                S, bx, int(body),
                None if point is None else torch.as_tensor(point))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-5)
    # the other arm's and the cubes' dofs do not move arm 0's grip site
    J0 = te_.point_jacobian(S, bx, int(fr["tt"].grip_bodies[0])).numpy()
    assert not J0[:, 9:].any() and np.abs(J0[:, :7]).max() > 0.1


def test_pre_physics_torques_match_jax(fr):
    """OSC torques and the gripper targets from the same converted state
    and the same actions."""
    acts = np.random.default_rng(5).uniform(-1, 1, (2 * N, 6)).astype(
        np.float32)
    ref = fr["jt"].pre_physics(fr["jst"], jnp.asarray(acts))
    got = fr["tt"].pre_physics(fr["tst"], torch.as_tensor(acts))
    np.testing.assert_allclose(got.tau.numpy(), np.asarray(ref.tau),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(got.pos_target.numpy(),
                                  np.asarray(ref.pos_target))
    np.testing.assert_array_equal(got.vel_target.numpy(),
                                  np.asarray(ref.vel_target))
    assert float(np.abs(np.asarray(ref.tau)).max()) > 1.0


def test_reset_idx_matches_jax(fr):
    """Half the envs reset with the JAX draws injected: arm dofs, cube
    poses, zeroed velocities and cached actions exactly."""
    jt, tt = fr["jt"], fr["tt"]
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    K, T = jt.num_agents, jt.num_targets
    draws = (jax.random.uniform(k1, (N, K, 9)),
             jax.random.uniform(k2, (N, T, 2)), jax.random.uniform(k3, (N, T)))
    mask = np.arange(N) % 2 == 0
    jsim, jtask = jt.reset_idx(fr["jst"].sim, fr["jst"].task,
                               jnp.asarray(mask), key)
    tsim, ttask = tt.reset_idx(
        fr["tst"].sim, fr["tst"].task, torch.as_tensor(mask),
        tuple(torch.tensor(np.asarray(x)) for x in draws))
    np.testing.assert_array_equal(tsim.q.numpy(), np.asarray(jsim.q))
    np.testing.assert_array_equal(tsim.qd.numpy(), np.asarray(jsim.qd))
    np.testing.assert_array_equal(ttask.actions.numpy(),
                                  np.asarray(jtask.actions))
    assert not np.array_equal(tsim.q.numpy(), fr["d"]["init_q"])


def _assert_models_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "geoms":
            assert len(x) == len(y)
            for ga, gb in zip(x, y):
                for gf in dataclasses.fields(ga):
                    u, v = getattr(ga, gf.name), getattr(gb, gf.name)
                    if u is None or v is None:
                        assert u is None and v is None, gf.name
                    else:
                        np.testing.assert_array_equal(u, v, err_msg=gf.name)
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f.name)


def test_copied_franka_model_matches_jax(fr):
    """The port's copies of specs/franka_panda, build_franka and the
    composed FrankaReachMA scene give the JAX package's, field by field."""
    from isaacgymenvs_ma_tpu.models import franka as jfranka
    from isaacgymenvs_ma_tpu.models.specs import franka_panda as jspec
    from isaacgymenvs_ma_tpu_torch.models import franka as tfranka
    from isaacgymenvs_ma_tpu_torch.models.specs import franka_panda as tspec
    assert tspec.SPEC == jspec.SPEC
    np.testing.assert_array_equal(tfranka.FRANKA_DEFAULT_DOF_POS,
                                  jfranka.FRANKA_DEFAULT_DOF_POS)
    _assert_models_equal(tfranka.build_franka(), jfranka.build_franka())
    _assert_models_equal(fr["tt"].model, fr["jt"].model)


def test_franka_engine_scene(fr):
    """41 candidate rows (8 table and 16 cube corners against the ground,
    16 cube corners against the table, one hand-sphere pair), compacted to
    24, reused across the two substeps; the static rows and attribution the
    JAX engine builds."""
    jt, tt = fr["jt"], fr["tt"]
    je, e = jt.engine, tt.engine
    assert (e.nb, e.nq, e.nv) == (35, 32, 30)
    assert (e.n_ground, e.n_pair_rows) == (24, 17)
    p = e.params
    assert (p.contact_capacity, p.reuse_contact_rows, p.contact_continuation,
            p.num_iterations, p.contact_margin) == (24, True, True, 18, 0.005)
    np.testing.assert_array_equal(e.row_masks_np, je._row_masks_np())
    np.testing.assert_array_equal(e.row_body_a, je.row_body_a)
    np.testing.assert_array_equal(e.row_body_b, je.row_body_b)
    for name in ("arm_dofs", "gripper_dofs", "hand_bodies", "grip_bodies",
                 "cube_q_adr", "cube_v_adr"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name),
                                      err_msg=name)
    assert (tt.num_obs, tt.num_actions, tt.rl_games_batch) == (19, 6, 2 * N)


def test_solver_row_rule_counts_compacted_rows(fr):
    """The bf16 auto rule counts the rows left after compaction, as JAX
    (engine.py:1798-1803): 41 rows x nv 30 is 1230 >= 1024 (bf16), but 24
    compacted rows x 30 is 720 (float32), so the engine builds."""
    m, p = fr["tt"].model, fr["tt"].sim_params
    assert te.solver_rows_bf16(m, p, 41) is False
    assert te.solver_rows_bf16(m, p._replace(contact_capacity=None), 41)
    assert not te.solver_rows_bf16(
        m, p._replace(contact_capacity=None, use_contact_kernel=True), 41)
    assert te.solver_rows_bf16(m, p._replace(solver_rows_bf16=True), 41)
    # geoms: 0 table top, 1-2 hand spheres, 3-4 cubes
    with pytest.raises(NotImplementedError, match="bfloat16"):
        PhysicsEngine(m, p._replace(contact_capacity=None), device="cpu",
                      pair_specs=[(3, 0), (4, 0), (1, 2)])


def test_multi_agent_batch_folding(fr):
    """Agent rows are env-major: obs, rewards, resets and time-outs have
    N * K rows, the physics state N."""
    tt = fr["tt"]
    B = tt.rl_games_batch
    _, obs0 = tt.reset(fr["tst"])
    assert obs0.shape == (B, 19) and tt.zero_actions().shape == (B, 6)
    per_env = torch.arange(N)
    np.testing.assert_array_equal(tt._to_batch(per_env).numpy(),
                                  np.repeat(np.arange(N), 2))
    assert tt._to_batch(torch.arange(B)).shape == (B,)
    st, res = tt.step(fr["tst"], tt.zero_actions())
    assert st.sim.q.shape == (N, 32) and st.progress.shape == (N,)
    assert res.obs.shape == (B, 19) and res.rew.shape == (B,)
    assert res.reset.shape == res.extras["time_outs"].shape == (B,)
    assert torch.isfinite(res.obs).all() and torch.isfinite(res.rew).all()
    # obs: targets (6), own eef quat (4) and pos (3), nearest-target
    # vector (3), the other agent's eef pos (3): agents 0 and 1 of an env
    # see each other's position
    np.testing.assert_array_equal(res.obs[0::2, 10:13].numpy(),
                                  res.obs[1::2, 16:19].numpy())
    np.testing.assert_array_equal(res.obs[1::2, 10:13].numpy(),
                                  res.obs[0::2, 16:19].numpy())


# ---- compaction and row reuse in the engine, on Ant

_CASES = {"cap2": (2, False), "cap4": (4, False), "reuse": (None, True),
          "cap2_reuse": (2, True)}


@pytest.fixture(scope="module")
def ant_state():
    d = np.load(os.path.join(DATA, "ant_golden.npz"))
    n = d["init_q"].shape[0]
    tau = np.zeros((n, 14), np.float32)
    tau[:, 6:] = d["actions"][0] * 15.0
    return n, d["init_q"], d["init_qd"], tau


@pytest.mark.parametrize("case", list(_CASES))
def test_engine_step_with_compaction_and_reuse_matches_jax(ant_state, case):
    """One Ant engine step with ``contact_capacity`` 2 (below the 3-4 rows
    active in some envs: deepest-2 capping) or 4 (at or above every env's
    active count: exact), and/or ``reuse_contact_rows`` (the row set of
    substep 1 reused by substep 2 with impulse continuation), against the
    JAX engine with the same overrides."""
    cap, reuse = _CASES[case]
    n, q, qd, tau = ant_state
    jt = JAnt(jdeep_merge(JANT_CFG, {"env": {"numEnvs": n}}))
    jt.engine.params = jt.engine.params._replace(contact_capacity=cap,
                                                 reuse_contact_rows=reuse)
    jsim, jout = jt.engine.step(JSimState(jnp.asarray(q), jnp.asarray(qd)),
                                JControl(tau=jnp.asarray(tau)))
    cfg = deep_merge(ANT_CFG, {"env": {"numEnvs": n}})
    tt = Ant(cfg, device="cpu", sim_params=parse_sim_params(cfg["sim"])
             ._replace(contact_capacity=cap, reuse_contact_rows=reuse))
    tsim, tout = tt.engine.step(
        SimState(torch.as_tensor(q), torch.as_tensor(qd)),
        Control(tau=torch.as_tensor(tau)))
    np.testing.assert_allclose(tsim.q.numpy(), np.asarray(jsim.q),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tsim.qd.numpy(), np.asarray(jsim.qd),
                               rtol=2e-3, atol=2e-3)
    for name in ("contact_force", "sensor_forces", "dof_force", "qdd"):
        ref = np.asarray(getattr(jout, name))
        np.testing.assert_allclose(
            getattr(tout, name).numpy(), ref, rtol=2e-3,
            atol=2e-3 * max(1.0, float(np.abs(ref).max())), err_msg=name)
    if cap == 2 and not reuse:
        # capping really dropped active rows somewhere: the step differs
        # from the uncompacted one
        full, _ = Ant(cfg, device="cpu").engine.step(
            SimState(torch.as_tensor(q), torch.as_tensor(qd)),
            Control(tau=torch.as_tensor(tau)))
        assert float((full.qd - tsim.qd).abs().max()) > 1e-3
