"""Port parity of the Factory family (isaacgymenvs_ma_tpu_torch/tasks/
factory.py and ops/controllers.py) against the JAX package.

* The composed scenes (the gravity-free Franka without passive damping or
  a wrist limit, with body damping 1.0 / 5.0 and pad clouds; the table;
  the nut and bolt's baked grids; Screw's nut on its SCREW joint), the
  engines' rows, pairs and route, and the tasks' constants.
* The controller library's seven modes and its IK methods on seeded
  inputs, against ``ops/controllers.py``.
* ``reset_idx`` (the IK reset and the objects' draws from the JAX keys),
  ``pre_physics`` and ``post_physics`` against the JAX methods from a
  capture's state (Pick's post_physics without its epilogue, which the
  capture replay runs).
* ``_restore_lam``'s zeroing and the one host read a step of the two
  data-dependent branches.
* The five captures (``scripts/record_torch_golden.py --task <name>``: 8
  envs, 6 steps after 20, a 23-step episode so that Pick's close-and-lift
  epilogue runs in the third recorded step) replayed on the CPU twins one
  step at a time, the median over the envs of each env's error beyond
  four times the reference's one-ulp spread held at the ground rule
  (``parity.replay``); Pick, Gears and Insertion also with every env's
  error itself at the ground rule (the squeezed nut amplifies rounding at
  Place and Screw; see GROUND_RULE_CAPTURES).

No JAX step runs here: the JAX methods run eagerly on the captures'
states.  Tolerances: the ground rule (``parity.GROUND_RULE_TOL``) for
anything through the engine's readouts; the controllers at rtol 1e-4 /
atol 1e-4 (a 6 x 6 inverse and an SVD in other orders); the resets' poses
at 1e-5 (12 IK iterations through that inverse).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.ops import controllers as jfc
from isaacgymenvs_ma_tpu.physics.engine import SimState as JSimState
from isaacgymenvs_ma_tpu.tasks import registry as jregistry
from isaacgymenvs_ma_tpu.tasks.base import EnvState as JEnvState
from isaacgymenvs_ma_tpu.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax
from isaacgymenvs_ma_tpu_torch.ops import controllers as fc
from isaacgymenvs_ma_tpu_torch.physics.engine import SimState
from isaacgymenvs_ma_tpu_torch.tasks import factory
from isaacgymenvs_ma_tpu_torch.tasks import registry as pregistry
from isaacgymenvs_ma_tpu_torch.tasks.base import VecTaskBase
from isaacgymenvs_ma_tpu_torch.utils.parity import (
    GROUND_RULE_TOL, ONE_STEP_RESET_MISMATCHES, RESET_DRAWS, TOLERANCES,
    replay)
from test_torch_ball_balance import _assert_models_equal

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
N = 8
TOL = GROUND_RULE_TOL
FACTORY = ("FactoryTaskNutBoltPick", "FactoryTaskNutBoltPlace",
           "FactoryTaskNutBoltScrew", "FactoryTaskGears",
           "FactoryTaskInsertion")
# registry name -> (nb, nv, ground rows, pair rows, obs, act, bf16 rows)
SIZES = {"FactoryTaskNutBoltPick": (19, 15, 56, 96, 20, 12, True),
         "FactoryTaskNutBoltPlace": (19, 15, 56, 96, 27, 12, True),
         "FactoryTaskNutBoltScrew": (19, 10, 68, 96, 32, 12, True),
         "FactoryTaskGears": (19, 15, 28, 32, 32, 12, False),
         "FactoryTaskInsertion": (19, 15, 28, 32, 32, 12, False)}
# the captures held with every env's error itself at the ground rule too
# (at Place and Screw the nut, squeezed in the gripper, moves the
# reference by more than the ground rule under one-ulp noise: there the
# per-env widening holds)
GROUND_RULE_CAPTURES = ("FactoryTaskNutBoltPick", "FactoryTaskGears",
                        "FactoryTaskInsertion")


def golden(name):
    """A task's capture file (scripts/record_torch_golden.py's name)."""
    return os.path.join(DATA, "".join(
        "_" + c.lower() if c.isupper() else c for c in name)[1:]
        + "_golden.npz")


def pair(name, n=N, **over):
    """The JAX task and the port's (CPU) of registry ``name`` at ``n`` envs
    with the capture's 23-step episode; ``over`` merged over both
    configs."""
    delta = deep_merge({"env": {"numEnvs": n},
                        "rl": {"max_episode_length": 23}}, over)
    jt = jregistry.task_class(name)(deep_merge(
        jregistry.task_default_config(name), delta))
    pt = pregistry.create_task(name, deep_merge(
        pregistry.task_default_config(name), delta), seed=3, device="cpu")
    return jt, pt


def states(jt, name, state_cls):
    """The JAX and the port env states at ``name``'s capture start, with
    the warm-start impulses."""
    d = np.load(golden(name))
    fields = state_cls._fields
    lam = tuple(jnp.asarray(d[f"init_lam_{i}"]) for i in range(3))
    jstate = JEnvState(
        sim=JSimState(jnp.asarray(d["init_q"]), jnp.asarray(d["init_qd"]),
                      lam),
        progress=jnp.asarray(d["init_progress"]),
        reset_buf=jnp.asarray(d["init_reset_buf"]),
        rng=jax.random.PRNGKey(11),
        task=type(jt.initial_task_state())(
            *(jnp.asarray(d[f"init_{f}"]) for f in fields)),
        phys=None)
    arrays = {"sim.q": d["init_q"], "sim.qd": d["init_qd"],
              "progress": d["init_progress"],
              "reset_buf": d["init_reset_buf"],
              **{f"sim.lam.{i}": d[f"init_lam_{i}"] for i in range(3)},
              **{f"task.{f}": d[f"init_{f}"] for f in fields}}
    return jstate, env_state_from_jax(arrays, "cpu", state_cls)


def close(got, want, atol, what, rtol=0.0):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def jax_reset_draws(key, jt):
    """The port's reset draws from a JAX reset key, as the JAX reset_idx
    splits it (scripts/record_torch_golden.py ``factory_draws``)."""
    n = jt.num_envs
    name = type(jt).__name__
    u = lambda k, s: jax.random.uniform(k, s, minval=-1.0,  # noqa: E731
                                        maxval=1.0)
    ks = jax.random.split(key, 4)
    k1, k2 = jax.random.split(ks[0])
    d = [u(k1, (n, 3)), u(k2, (n, 3))]
    if name == "FactoryTaskNutBoltPick":
        k1, k2 = jax.random.split(ks[1])
        d += [u(k1, (n, 2)), jax.random.uniform(k2, (n,), minval=-np.pi,
                                                 maxval=np.pi)]
    elif name in ("FactoryTaskGears", "FactoryTaskInsertion"):
        d += [u(ks[1], (n, 2))]
    elif name.startswith("IndustReal"):
        k3 = jax.random.split(ks[1], 3)
        d += [u(k3[0], (n, 2)), jax.random.uniform(k3[1], (n,))]
    elif name == "FactoryTaskNutBoltScrew":
        d = []
    return tuple(torch.tensor(np.asarray(x)) for x in d)


def check_scene(name, sizes):
    jt, pt = pair(name)
    _assert_models_equal(pt.model, jt.model)
    je, te = jt.engine, pt.engine
    nb, nv, ng, npr, obs, act, bf16 = sizes
    assert (te.nb, te.nv, te.n_ground, te.n_pair_rows) == (nb, nv, ng, npr)
    assert (je.nb, je.nv, je.n_ground, je.n_pair_rows) == (nb, nv, ng, npr)
    assert (pt.num_obs, pt.num_actions) == (obs, act) == (jt.num_obs,
                                                          jt.num_actions)
    np.testing.assert_array_equal(te.row_masks_np,
                                  np.asarray(je._row_masks_np()))
    np.testing.assert_array_equal(te.row_body_a, je.row_body_a)
    np.testing.assert_array_equal(te.row_body_b, je.row_body_b)
    np.testing.assert_array_equal(te.row_body_oh.numpy(),
                                  np.asarray(je._row_body_oh))
    assert len(te.pairs) == len(je.pairs)
    for tp, jp in zip(te.pairs, je.pairs):
        np.testing.assert_array_equal(tp["pt_idx"], np.asarray(jp["pt_idx"]))
        assert (tp["tgt_body"], tp["tgt_type"]) == (int(jp["tgt_body"]),
                                                    int(jp["tgt_type"]))
        assert (tp["grid"] is None) == ("grid" not in jp)
        if tp["grid"] is not None:
            np.testing.assert_array_equal(tp["grid"].values.numpy(),
                                          np.asarray(jp["grid"].values))
            np.testing.assert_array_equal(tp["grid"].origin.numpy(),
                                          np.asarray(jp["grid"].origin))
    for k in ("body_damp_lin", "body_damp_ang"):
        np.testing.assert_array_equal(getattr(te, k).numpy(),
                                      np.asarray(getattr(je, k)))
    assert te.has_body_damping and je.has_body_damping
    # warm start and mass splitting keep the contact kernel off, and the
    # bf16 rule reads the scene as JAX's (rows x nv >= 1024)
    assert te.contact_route == "loop" and te.cplan is None
    assert te.rows_bf16 == bf16 == ((ng + npr) * nv >= 1024)
    assert te.params.warm_start == 0.9 and te.params.mass_splitting
    lam = te.zero_warm(N)
    assert [tuple(x.shape) for x in lam] == [(N, ng + npr, 3), (N, nv),
                                            (N, nv)]
    np.testing.assert_array_equal(pt.franka_dofs, jt.franka_dofs)
    for k in ("hand_body", "grip_site", "lf_body", "rf_body", "nut_body",
              "max_episode_length", "ctrl_type"):
        assert getattr(pt, k) == getattr(jt, k), k
    for k in ("default_dof", "dof_lower", "dof_upper", "keypoint_offsets"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    for k, v in jt.cfg_ctrl.items():
        got = pt.cfg_ctrl[k]
        if torch.is_tensor(got):
            np.testing.assert_array_equal(got.numpy(), np.asarray(v),
                                          err_msg=k)
        else:
            assert got == v, k
    return jt, pt


# the tasks whose whole reset_idx is held against JAX's (Pick: the IK
# reset, which every task but Screw shares, and the nut's draws; Screw: the
# fixed grasp pose); the others' object resets are held alone (the JAX
# reset's cond would compile the IK again for each), and the captures
# replay every task's resets
WHOLE_RESET = ("FactoryTaskNutBoltPick", "FactoryTaskNutBoltScrew")


def check_reset_idx(name, state_cls):
    """Half the envs reset (the IK to a random fingertip pose and the
    objects' draws from a JAX key; Screw's fixed pose): poses against the
    JAX method; the reset drops the impulses (both JAX branches do).
    Elsewhere the objects' reset alone (``_reset_objects``)."""
    jt, pt = pair(name)
    jst, pst = states(jt, name, state_cls)
    mask = np.arange(N) % 2 == 0
    key = jax.random.PRNGKey(7)
    draws = jax_reset_draws(key, jt)
    if name in WHOLE_RESET:
        jsim, jtask = jt.reset_idx(jst.sim, jst.task, jnp.asarray(mask), key)
        psim, ptask = pt.reset_idx(pst.sim, pst.task, torch.tensor(mask),
                                   draws)
        for f in state_cls._fields:
            close(getattr(ptask, f), getattr(jtask, f), 1e-6, f)
        assert psim.lam is None and jsim.lam is None
    else:
        # JAX _reset_objects takes reset_idx's second key; IndustReal's the
        # task state stashed by reset_idx
        jt._task_for_reset, pt._reset_task = jst.task, pst.task
        jsim = jt._reset_objects(jst.sim, jnp.asarray(mask),
                                 jax.random.split(key, 4)[1])
        psim = pt._reset_objects(pst.sim, torch.tensor(mask), draws[2:])
    close(psim.q, jsim.q, 1e-5, "q", rtol=1e-5)
    close(psim.qd, jsim.qd, 1e-6, "qd")
    moved = np.abs(psim.q.numpy() - np.asarray(jst.sim.q)).max(1) > 0
    np.testing.assert_array_equal(moved, mask)
    return jt, pt, jst, pst


def check_pre_physics(name, state_cls):
    jt, pt = pair(name)
    jst, pst = states(jt, name, state_cls)
    acts = np.random.default_rng(2).uniform(
        -1, 1, (N, pt.num_actions)).astype(np.float32)
    jc = jt.pre_physics(jst, jnp.asarray(acts))
    pc = pt.pre_physics(pst, torch.tensor(acts))
    # the controller's torques, through the readouts' Jacobian and mass
    # matrix and a 6 x 6 inverse (+-100 N m clamp)
    close(pc.tau, jc.tau, 2e-3, "tau", rtol=1e-3)
    assert not (pc.pos_target.any() or pc.vel_target.any())
    if jc.grab_active is not None:
        close(pc.grab_active, jc.grab_active, 0, "grab_active")
    return jt, pt


def check_replay(name):
    e = replay(golden(name), "cpu")
    assert e.finite
    for k, tol in TOLERANCES[name].items():
        errs = getattr(e, k)
        assert (errs <= tol).all(), f"{k} per-step errors {errs} > {tol}"
        if name in GROUND_RULE_CAPTURES:
            assert (e.raw[k] <= tol).all(), f"{k} raw errors {e.raw[k]}"
    assert (e.reset_mismatches <= ONE_STEP_RESET_MISMATCHES).all()
    assert (e.wild_envs <= 2).all(), e.wild_envs
    return e


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", FACTORY)
def test_scene_matches_jax(name):
    jt, pt = check_scene(name, SIZES[name])
    if name == "FactoryTaskNutBoltScrew":
        b = pt.nut_body
        assert int(pt.model.jnt_type[b]) == factory.SCREW
        assert not pt.nut_free and len(pt.engine.pairs) == 2
        # inverted grip pairs: the nut's points against the pad boxes
        assert {p["tgt_type"] for p in pt.engine.pairs} == {factory.GEOM_BOX}
    elif name.startswith("FactoryTaskNutBolt"):
        grids = [p for p in pt.engine.pairs if p["grid"] is not None]
        assert len(grids) == 3            # two pads on the nut, nut on bolt
    m = pt.model
    franka = [i for i, nm in enumerate(m.body_names)
              if nm.startswith("panda_")]
    assert not np.asarray(m.body_gravity)[franka].any()
    assert not np.asarray(m.dof_damping)[:9].any()
    assert not bool(np.asarray(m.dof_has_limit)[6])


@pytest.mark.parametrize("ctrl_type", ["gym_default", "joint_space_ik",
                                       "joint_space_id",
                                       "task_space_impedance",
                                       "operational_space_motion",
                                       "open_loop_force",
                                       "closed_loop_force",
                                       "hybrid_force_motion"])
def test_controller_modes_match_jax(ctrl_type):
    """``compute_dof_torque`` of every ``ctrl_type`` (the Pick config's
    ``all`` gains merged under the mode's) on seeded readouts: an arm
    Jacobian with orthogonal rows, an SPD arm mass matrix, poses and
    velocities, targets, a contact wrench and finger forces."""
    rng = np.random.default_rng(11)
    n = 16
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    quat = lambda: (lambda q: q / np.linalg.norm(q, axis=-1,  # noqa: E731
                                                 keepdims=True))(f(n, 4))
    A = f(n, 7, 7)
    # a Jacobian of orthogonal rows (an arm away from its singularities),
    # so that OSC's J M^-1 J^T is well conditioned
    J = 0.5 * np.linalg.qr(f(n, 7, 7))[0][:, :6].astype(np.float32)
    inputs = dict(dof_pos=f(n, 9), dof_vel=f(n, 9), fingertip_pos=f(n, 3),
                  fingertip_quat=quat(), fingertip_linvel=f(n, 3),
                  fingertip_angvel=f(n, 3), jacobian=J,
                  arm_mass_matrix=A @ A.transpose(0, 2, 1) / 7
                  + np.eye(7, dtype=np.float32),
                  target_gripper_dof_pos=f(n, 2), target_pos=f(n, 3),
                  target_quat=quat(), target_contact_wrench=f(n, 6),
                  left_finger_force=f(n, 3), right_finger_force=f(n, 3))
    ctrl = factory.TASK_CFG_PICK["ctrl"]
    jcfg = jfc.parse_ctrl_cfg(ctrl, ctrl_type, n)
    pcfg = fc.parse_ctrl_cfg(ctrl, ctrl_type, n, "cpu")
    want = jfc.compute_dof_torque(jcfg, **{k: jnp.asarray(v)
                                           for k, v in inputs.items()})
    got = fc.compute_dof_torque(pcfg, **{k: torch.tensor(v)
                                         for k, v in inputs.items()})
    close(got, want, 1e-4, ctrl_type, rtol=1e-4)
    assert 0 < float(got.abs().max()) <= 100.0


@pytest.mark.parametrize("ik_method", ["pinv", "trans", "dls", "svd"])
def test_ik_and_pose_error_match_jax(ik_method):
    rng = np.random.default_rng(12)
    J = rng.normal(size=(16, 6, 7)).astype(np.float32)
    delta = rng.normal(size=(16, 6)).astype(np.float32)
    close(fc.get_delta_dof_pos(torch.tensor(delta), ik_method,
                               torch.tensor(J)),
          jfc.get_delta_dof_pos(jnp.asarray(delta), ik_method,
                                jnp.asarray(J)), 1e-4, ik_method, rtol=1e-4)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = q.copy()
    t[:4] = q[:4] * (1 + 1e-8)                       # the small-angle branch
    t[4:] = rng.normal(size=(12, 4))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    p = rng.normal(size=(16, 3)).astype(np.float32)
    for kind in ("axis_angle", "quat"):
        got = fc.get_pose_error(torch.tensor(p), torch.tensor(q),
                                torch.tensor(p[::-1].copy()), torch.tensor(t),
                                kind)
        want = jfc.get_pose_error(jnp.asarray(p), jnp.asarray(q),
                                  jnp.asarray(p[::-1].copy()),
                                  jnp.asarray(t), kind)
        for a, b in zip(got, want):
            close(a, b, 1e-5, kind, rtol=1e-5)


@pytest.mark.parametrize("name", FACTORY)
def test_reset_idx_matches_jax(name):
    check_reset_idx(name, factory.FactoryTaskState)


@pytest.mark.parametrize("name", FACTORY)
def test_pre_physics_matches_jax(name):
    check_pre_physics(name, factory.FactoryTaskState)


@pytest.mark.parametrize("name", FACTORY)
def test_post_physics_matches_jax(name):
    """Obs, reward, resets and the task state from the capture's state
    with a third of the envs at their episode's last step (Pick without its
    epilogue: ``close_and_lift`` off on both sides)."""
    over = ({"env": {"close_and_lift": False}}
            if name == "FactoryTaskNutBoltPick" else {})
    jt, pt = pair(name, **over)
    jst, pst = states(jt, name, factory.FactoryTaskState)
    progress = np.where(np.arange(N) % 3 == 0, jt.max_episode_length - 1,
                        np.arange(N)).astype(np.int32)
    jst = jst._replace(progress=jnp.asarray(progress))
    pst = pst._replace(progress=torch.tensor(progress))
    acts = np.random.default_rng(9).uniform(
        -1, 1, (N, pt.num_actions)).astype(np.float32)
    jo, _, jr, jreset, jtask, jx = jt.post_physics(
        jst, jt.engine.forward(jst.sim), jnp.asarray(acts))
    po, _, pr, preset, ptask, px = pt.post_physics(
        pst, pt.engine.forward(pst.sim), torch.tensor(acts))
    close(po, jo, TOL["obs"], "obs")
    close(pr, jr, TOL["rew"], "reward", rtol=1e-6)
    np.testing.assert_array_equal(preset.numpy(), np.asarray(jreset))
    for f in factory.FactoryTaskState._fields:
        close(getattr(ptask, f), getattr(jtask, f), 1e-6, f)
    for k, v in jx.items():
        close(px[k], v, 1e-6, k)


def test_restore_lam_zeroes_reset_and_unhealthy_envs():
    """``VecTaskBase._restore_lam`` (JAX base.py:343-356): impulses a
    ``reset_idx`` dropped come back, zeroed in the masked envs; impulses
    it kept are the ones zeroed; no impulses, nothing attached."""
    rng = np.random.default_rng(4)
    lam = tuple(torch.tensor(rng.normal(size=s).astype(np.float32))
                for s in ((N, 5, 3), (N, 4), (N, 4)))
    mask = torch.tensor(np.arange(N) % 3 == 1)
    q, qd = torch.zeros(N, 7), torch.zeros(N, 4)
    out = VecTaskBase._restore_lam(SimState(q, qd), lam, mask)
    for a, b in zip(out.lam, lam):
        assert not a[mask].any()
        assert torch.equal(a[~mask], b[~mask])
    kept = tuple(2 * x for x in lam)
    out = VecTaskBase._restore_lam(SimState(q, qd, kept), lam, mask)
    assert torch.equal(out.lam[0][~mask], kept[0][~mask])
    assert VecTaskBase._restore_lam(SimState(q, qd), None, mask).lam is None


def test_step_branches_and_lam():
    """One host read a step serves both data-dependent branches; a step
    that resets no env keeps every pose and carries the impulses; the
    envs a step resets start with zero impulses."""
    _, pt = pair("FactoryTaskNutBoltPick", n=4)
    st = pt.initial_state()
    acts = torch.zeros(4, 12)
    st, _ = pt.step(st, acts)           # every env resets on the first step
    reads = pt.branch_reads
    st, _ = pt.step(st, acts)
    assert pt.branch_reads == reads + 1
    assert st.sim.lam is not None and st.sim.lam[0].abs().sum() > 0
    q = st.sim.q.clone()
    sim, _ = pt.reset_idx(st.sim, st.task, torch.zeros(4, dtype=torch.bool))
    assert torch.equal(sim.q, q) and sim.lam is None
    flagged = torch.tensor([1, 0, 0, 1], dtype=torch.int32)
    st2, _ = pt.step(st._replace(reset_buf=flagged), acts)
    for x in st2.sim.lam:
        assert not x[flagged.bool()].any()
    assert st2.sim.lam[0][~flagged.bool()].abs().sum() > 0


@pytest.mark.parametrize("name", FACTORY)
def test_golden_replay_on_cpu_twins(name):
    e = check_replay(name)
    d = np.load(golden(name))
    assert str(d["task"]) == name and d["actions"].shape[:2] == (6, N)
    assert int(d["rl_max_episode_length"]) == 23
    for k in RESET_DRAWS[name]:
        assert d[k].shape[:2] == (6, N), k
    assert d["start_lam_0"].shape[:2] == (6, N)
    # the envs not flagged to reset reach their last step in the third
    # recorded step, and reset in the fourth
    assert d["reset"][2, N // 4:].all() and not d["reset"][1].any()
    if name == "FactoryTaskNutBoltPick":
        # the epilogue ran there: lift success is scored for the last
        # step's envs only
        assert (d["start_progress"][2, N // 4:] == 21).all()
    assert e.raw is not None


def test_registry_names_and_aliases():
    """The five task names and the Factory aliases resolve as in the JAX
    registry: a task class each, the config-only groups to their
    configs."""
    for name in FACTORY:
        assert pregistry.task_class(name).__name__ == name
        assert pregistry.task_default_config(name) == \
            jregistry.task_default_config(name)
    for alias in ("FactoryBase", "FactoryEnvNutBolt", "FactoryEnvGears",
                  "FactoryEnvInsertion"):
        assert pregistry.task_default_config(alias) == \
            jregistry.task_default_config(alias)
        with pytest.raises(KeyError):
            pregistry.task_class(alias)
    # every JAX registry name is registered in the port
    assert set(jregistry.task_names()) <= set(pregistry.task_names())


def test_entry_point_asks_for_the_card():
    cfg = deep_merge(pregistry.task_default_config("FactoryTaskNutBoltPick"),
                     {"env": {"numEnvs": 4}})
    if torch.cuda.is_available():
        assert pregistry.create_task("FactoryTaskNutBoltPick",
                                     cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pregistry.create_task("FactoryTaskNutBoltPick", cfg)


def test_checkpoint_carries_lam():
    """The learner's checkpoint keeps the engine's warm-start impulses
    (``env_state`` ``sim.lam.0..2``) and a fresh agent loads them back."""
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config)
    from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
    _, pt = pair("FactoryTaskNutBoltPick", n=4)
    tcfg = train_default_config("FactoryTaskNutBoltPick")
    tcfg["params"]["config"].update(horizon_length=4, minibatch_size=16)
    agent = PPOAgent(pt, tcfg, seed=1)
    agent.init()
    agent.train_epoch()
    lam = agent.env_state.sim.lam
    assert lam is not None and float(lam[0].abs().sum()) > 0
    d = agent.state_dict()
    assert all(torch.equal(d["env_state"][f"sim.lam.{i}"], lam[i])
               for i in range(3))
    other = PPOAgent(pt, tcfg, seed=2)
    other.init()
    other.load_state_dict(d)
    for a, b in zip(other.env_state.sim.lam, lam):
        assert torch.equal(a, b)
