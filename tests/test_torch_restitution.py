"""Restitution and joint-limit shifts in the port's engine
(isaacgymenvs_ma_tpu_torch/physics/engine.py) against the JAX engine on
the CPU at float32, on the same states, controls and physics scales.

* The JAX package's own scenes (tests/test_dof_properties.py:82-120): a
  limited pendulum driven at 0.9 rad with ``dof_upper_shift = -0.7``
  (the joint-limit solve of a scene without contact rows) and a sphere
  dropped on the plane with restitution 0 and 0.8 ((N, 1)) and with a
  per-body restitution combined with ``plane_restitution``: each step of
  the trajectory and the rebound peak.
* The AllegroHand scene at 8 envs, 3 control steps from a capture's state
  with the cube thrown onto the palm: seeded per-body restitution,
  ``plane_restitution``, limit shifts, row reuse and compaction on (the
  configuration's), mass splitting.  The bounce target binds in some
  active row, and the same steps without restitution miss the JAX steps
  by more than the bounds (the check is not vacuous).
* Ant at 8 envs with ``use_contact_kernel``: a call with restitution takes
  the loop (``route_for``), with the loop's capacity and reuse, and
  matches the JAX engine, which takes its loop there too
  (engine.py:1291-1292).
* Ant at 128 envs on the B4 route with limit shifts: the joint-limit
  inputs the port hands B4's twin (targets and active masks of the
  shifted gaps) against the ones the JAX engine hands ``solve_pallas``.

Bounds: the ground rule (q rtol 2e-4 / atol 2e-5, qd 2e-3; 3e-3 for the
pair scene, tests/test_dyn_kernel.py:139-159); B4's limit inputs at
rtol = atol = 1e-6 and the masks exactly.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.models.model import (DRIVE_POS, FREE, GEOM_SPHERE,
                                              HINGE, ModelBuilder)
from isaacgymenvs_ma_tpu.physics import contact_kernel as jck
from isaacgymenvs_ma_tpu.physics import dyn_kernel as jdk
from isaacgymenvs_ma_tpu.physics.engine import (
    Control as JControl, PhysicsEngine as JEngine, SimParams as JParams,
    SimState as JSimState)
from isaacgymenvs_ma_tpu.tasks import registry as jregistry
from isaacgymenvs_ma_tpu.utils.config import deep_merge as jdeep_merge
from isaacgymenvs_ma_tpu.utils.domain_rand import PhysScales as JPhys
from isaacgymenvs_ma_tpu_torch.physics import engine as tengine
from isaacgymenvs_ma_tpu_torch.physics.engine import (
    Control, PhysicsEngine, SimParams, SimState)
from isaacgymenvs_ma_tpu_torch.tasks import registry as pregistry
from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.utils.domain_rand import PhysScales

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
Q_TOL = dict(rtol=2e-4, atol=2e-5)


def _phys_pair(n, **leaves):
    """The same physics scales for both engines: unit mass, damping,
    stiffness and friction, and ``leaves`` (numpy) on top."""
    one = np.ones((n, 1), np.float32)
    base = dict(mass=one, damping=one, stiffness=one, friction=one)
    base.update({k: np.asarray(v, np.float32) for k, v in leaves.items()})
    return (JPhys(**{k: jnp.asarray(v) for k, v in base.items()}),
            PhysScales(**{k: torch.as_tensor(v) for k, v in base.items()}))


def _run_pair(je, te, q, qd, jctrl, tctrl, jphys, tphys, steps):
    """``steps`` engine steps of both packages from (q, qd): the JAX
    trajectory and the port's, (steps, N, nq) and (steps, N, nv) each."""
    jstep = jax.jit(lambda s: je.step(s, jctrl, phys=jphys)[0])
    js = JSimState(jnp.asarray(q), jnp.asarray(qd))
    ts = SimState(torch.as_tensor(q), torch.as_tensor(qd))
    out = {"jq": [], "jqd": [], "tq": [], "tqd": []}
    for _ in range(steps):
        js = jstep(js)
        ts, _ = te.step(ts, tctrl, phys=tphys)
        out["jq"].append(np.asarray(js.q))
        out["jqd"].append(np.asarray(js.qd))
        out["tq"].append(ts.q.numpy())
        out["tqd"].append(ts.qd.numpy())
    return {k: np.stack(v) for k, v in out.items()}


# ------------------------------------------------ the JAX package's scenes
def test_pendulum_limit_shift_matches_jax():
    """A kp 50 drive toward 0.9 rad against an upper limit shifted by
    -0.7: both packages stop it at ~0.3 rad, step for step."""
    b = ModelBuilder()
    b.begin_actor()
    b.add_body("pend", -1, HINGE, jnt_axis=(0, 1, 0), mass=1.0,
               com=(0.2, 0, 0), inertia=np.eye(3) * 0.02,
               body_pos=(0, 0, 1.0), effort_limit=2.0, limit_lower=-1.0,
               limit_upper=1.0)
    m = b.finalize()
    m.dof_drive_mode[:] = DRIVE_POS
    m.dof_stiffness[:] = 50.0
    m.dof_drive_damping[:] = 1.0
    je = JEngine(m, JParams(substeps=2), ground=False)
    te = PhysicsEngine(m, SimParams(substeps=2), ground=False, device="cpu")
    assert te.route_for(None) == "limit_solve"
    jphys, tphys = _phys_pair(1, dof_upper_shift=[[-0.7]])
    tgt = np.full((1, 1), 0.9, np.float32)
    zero = np.zeros((1, 1), np.float32)
    tr = _run_pair(je, te, np.zeros((1, 1), np.float32), zero,
                   JControl(tau=jnp.asarray(zero), pos_target=jnp.asarray(tgt)),
                   Control(tau=torch.as_tensor(zero),
                           pos_target=torch.as_tensor(tgt)),
                   jphys, tphys, 120)
    np.testing.assert_allclose(tr["tq"], tr["jq"], **Q_TOL)
    np.testing.assert_allclose(tr["tqd"], tr["jqd"], rtol=2e-3, atol=2e-3)
    assert abs(float(tr["tq"][-1, 0, 0]) - 0.3) < 0.02


def _sphere():
    b = ModelBuilder()
    b.begin_actor()
    ball = b.add_body("ball", -1, FREE, mass=1.0, inertia=np.eye(3) * 0.01)
    b.add_geom(ball, GEOM_SPHERE, np.array([0.1, 0, 0]), density=0.0,
               friction=0.5, name="g")
    return b.finalize()


@pytest.mark.parametrize("case", ["e0", "e08", "per_body_plane"])
def test_dropped_sphere_bounce_matches_jax(case):
    """A sphere dropped from 0.8 m: each step and the rebound peak against
    JAX's.  ``e0`` / ``e08``: restitution 0 / 0.8 for every row (N, 1);
    ``per_body_plane``: the ball's own 0.6 (N, nb) averaged with
    ``plane_restitution`` 1.0, so 0.8 too."""
    m = _sphere()
    plane = 1.0 if case == "per_body_plane" else 0.0
    je = JEngine(m, JParams(substeps=2, plane_restitution=plane),
                 ground=True)
    te = PhysicsEngine(m, SimParams(substeps=2, plane_restitution=plane),
                       ground=True, device="cpu")
    e = {"e0": np.zeros((1, 1)), "e08": np.full((1, 1), 0.8),
         "per_body_plane": np.full((1, m.nb), 0.6)}[case]
    jphys, tphys = _phys_pair(1, restitution=e)
    q = np.asarray(je.default_state(1).q).copy()
    q[:, 2] = 0.8
    zero = np.zeros((1, m.nv), np.float32)
    tr = _run_pair(je, te, q, zero, JControl(tau=jnp.asarray(zero)),
                   Control(tau=torch.as_tensor(zero)), jphys, tphys, 120)
    np.testing.assert_allclose(tr["tq"], tr["jq"], **Q_TOL)
    np.testing.assert_allclose(tr["tqd"], tr["jqd"], rtol=2e-3, atol=2e-3)

    def peak(z):
        hit = np.cumsum(z < 0.12) > 0
        return float(np.max(np.where(hit, z, 0.0)))
    jz, tz = tr["jq"][:, 0, 2], tr["tq"][:, 0, 2]
    assert abs(peak(tz) - peak(jz)) < 2e-4
    if case == "e0":
        assert peak(tz) < 0.105             # dead: rests at its radius
    else:
        assert peak(tz) > 0.15              # a visible rebound


# ------------------------------------------------------ the hand scene
def _bounce_probe(engine):
    """Wrap ``engine``'s normal-target and bounce steps to count, over
    every solve, the active rows and those whose bounce target binds."""
    seen = {"active": 0, "binds": 0}
    normal, bounce = engine._normal_targets, engine._bounce_targets
    last = {}

    def normal_targets(phi):
        active, b_n = normal(phi)
        last["active"] = active
        return active, b_n

    def bounce_targets(b_n, e_rows, J_flat, qd, R):
        lifted = bounce(b_n, e_rows, J_flat, qd, R)
        act = last["active"]
        seen["active"] += int(act.sum())
        seen["binds"] += int(((lifted > b_n) & act).sum())
        return lifted

    engine._normal_targets = normal_targets
    engine._bounce_targets = bounce_targets
    return seen


@pytest.fixture(scope="module")
def hand_scene():
    """AllegroHand at 8 envs in both packages (plane_restitution 0.5), the
    allegro_hand_golden.npz start state with every cube thrown down onto
    the palm at 1 m/s, drive targets at the current dof positions, seeded
    restitution U(0.3, 0.9) per body and limit shifts U(-0.1, 0.1) on the
    hand dofs; three JAX engine steps."""
    n = 8
    over = {"env": {"numEnvs": n},
            "sim": {"physx": {"plane_restitution": 0.5}}}
    jt = jregistry.task_class("AllegroHand")(jdeep_merge(
        jregistry.task_default_config("AllegroHand"), over))
    cfg = deep_merge(pregistry.task_default_config("AllegroHand"), over)
    params = parse_sim_params(cfg["sim"])._replace(plane_restitution=0.5)
    tt = pregistry.task_class("AllegroHand")(cfg, device="cpu",
                                             sim_params=params)
    jt.sim_params = jt.sim_params._replace(plane_restitution=0.5)
    je = jt.build_engine(jt.model, True)
    d = np.load(os.path.join(DATA, "allegro_hand_golden.npz"))
    q = d["init_q"][:n].copy()
    qd = d["init_qd"][:n].copy()
    va = tt.obj_va
    qd[:, va + 2] = -1.0
    g = np.random.default_rng(14)
    nb, nv = tt.engine.nb, tt.engine.nv
    shift = np.zeros((n, nv), np.float32)
    shift[:, tt.hand_dofs] = g.uniform(-0.1, 0.1, (n, len(tt.hand_dofs)))
    leaves = dict(restitution=g.uniform(0.3, 0.9, (n, nb)),
                  dof_lower_shift=shift, dof_upper_shift=-shift)
    jphys, tphys = _phys_pair(n, **leaves)
    tgt = np.zeros((n, nv), np.float32)
    tgt[:, tt.hand_dofs] = np.asarray(
        tt.engine.dof_pos(SimState(torch.as_tensor(q),
                                   torch.as_tensor(qd))))[:, :16]
    zero = np.zeros((n, nv), np.float32)
    jctrl = JControl(tau=jnp.asarray(zero), pos_target=jnp.asarray(tgt),
                     vel_target=jnp.asarray(zero))
    tctrl = Control(tau=torch.as_tensor(zero), pos_target=torch.as_tensor(tgt),
                    vel_target=torch.as_tensor(zero))
    seen = _bounce_probe(tt.engine)
    tr = _run_pair(je, tt.engine, q, qd, jctrl, tctrl, jphys, tphys, 3)
    return dict(tt=tt, q=q, qd=qd, tctrl=tctrl, tphys=tphys, tr=tr,
                seen=seen)


def test_hand_scene_restitution_matches_jax(hand_scene):
    s = hand_scene
    te, tr = s["tt"].engine, s["tr"]
    assert te.params.mass_splitting and te.params.reuse_contact_rows
    assert te.params.contact_capacity == 32 and te.params.plane_restitution
    assert te.route_for(s["tphys"]) == "loop"
    np.testing.assert_allclose(tr["tq"], tr["jq"], **Q_TOL)
    np.testing.assert_allclose(tr["tqd"], tr["jqd"], rtol=3e-3, atol=3e-3)
    # the bounce binds in some active row
    assert s["seen"]["active"] > 0 and s["seen"]["binds"] > 0


def test_hand_scene_without_restitution_misses_jax(hand_scene):
    """The port's steps with the same shifts and no restitution are off
    JAX's (with it) by more than the bound: the restitution matters."""
    s = hand_scene
    ts = SimState(torch.as_tensor(s["q"]), torch.as_tensor(s["qd"]))
    phys = s["tphys"]._replace(restitution=None)
    worst = 0.0
    for t in range(3):
        ts, _ = s["tt"].engine.step(ts, s["tctrl"], phys=phys)
        worst = max(worst, float(np.abs(ts.qd.numpy()
                                        - s["tr"]["jqd"][t]).max()))
    assert worst > 3e-3


# ------------------------------------------------------------- the route
def test_ant_restitution_takes_the_loop_and_matches_jax():
    """Ant with ``use_contact_kernel`` (planned for B4), capacity 8 and row
    reuse: a call with restitution takes the loop, compacting and reusing
    rows, and matches the JAX engine; without restitution the route is
    B4."""
    from isaacgymenvs_ma_tpu.tasks.ant import Ant as JAnt, TASK_CFG as JCFG
    from isaacgymenvs_ma_tpu_torch.tasks.ant import Ant, TASK_CFG
    n = 8
    jt = JAnt(jdeep_merge(JCFG, {"env": {"numEnvs": n}}))
    over = dict(use_contact_kernel=True, contact_capacity=8,
                reuse_contact_rows=True)
    cfg = deep_merge(TASK_CFG, {"env": {"numEnvs": n}})
    tt = Ant(cfg, device="cpu",
             sim_params=parse_sim_params(cfg["sim"])._replace(**over))
    je = JEngine(jt.model, jt.engine.params._replace(**over), ground=True)
    g = np.random.default_rng(3)
    jphys, tphys = _phys_pair(n, restitution=g.uniform(0.2, 0.8, (n, 1)))
    assert tt.engine.route_for(None) == "b4"
    assert tt.engine.route_for(tphys) == "loop"
    q = np.asarray(je.default_state(n).q).copy()
    q[:, 2] = 0.3
    qd = g.normal(0, 0.5, (n, je.nv)).astype(np.float32)
    qd[:, 2] = -2.0
    tau = (g.uniform(-1, 1, (n, je.nv)) * 5).astype(np.float32)
    tau[:, :6] = 0.0
    tr = _run_pair(je, tt.engine, q, qd, JControl(tau=jnp.asarray(tau)),
                   Control(tau=torch.as_tensor(tau)), jphys, tphys, 3)
    np.testing.assert_allclose(tr["tq"], tr["jq"], **Q_TOL)
    np.testing.assert_allclose(tr["tqd"], tr["jqd"], rtol=2e-3, atol=2e-3)


def test_b4_limit_inputs_take_the_shifts():
    """Ant at 128 envs on the B4 route with seeded limit shifts: the
    joint-limit targets and active masks the port hands B4's twin are the
    ones the JAX engine hands ``solve_pallas`` (its dynamics kernels in
    interpret mode; both solves stopped at their call), and they differ
    from the unshifted ones."""
    from isaacgymenvs_ma_tpu.models.robots import build_ant
    n = 128
    m = build_ant()
    params = dict(use_contact_kernel=True, contact_margin=0.02)
    je = JEngine(m, JParams(**params), ground=True)
    te = PhysicsEngine(m, SimParams(**params), ground=True, device="cpu")
    assert te.cplan is not None
    g = np.random.default_rng(5)
    q = np.asarray(je.default_state(n).q).copy()
    lo, hi = np.asarray(m.dof_lower), np.asarray(m.dof_upper)
    sd = te.scalar_dofs
    q[:, te.scalar_qids] = g.uniform(lo[sd] - 0.05, hi[sd] + 0.05,
                                     (n, len(sd)))
    qd = g.normal(0, 0.5, (n, m.nv)).astype(np.float32)
    shift = np.zeros((n, m.nv), np.float32)
    shift[:, sd] = g.uniform(-0.1, 0.1, (n, len(sd)))
    tau = np.zeros((n, m.nv), np.float32)

    class Stop(Exception):
        pass

    got = {}

    def jrecord(engine, S_bl, hinv_bl, qd, masks, p, b_n, mu, active, frames,
                w_diag, b_lo, b_hi, act_lo, act_hi, **kw):
        got["jax"] = [np.asarray(x) for x in (b_lo, b_hi, act_lo, act_hi)]
        raise Stop

    def trecord(plan, S_bl, hinv_bl, qd, p, b_n, mu, active, frames, w_diag,
                b_lo, b_hi, act_lo, act_hi, **kw):
        got.setdefault("port", []).append(
            [x.numpy() for x in (b_lo, b_hi, act_lo, act_hi)])
        raise Stop

    real_j, real_t = jck.solve_pallas, tengine.ck.solve
    jck.solve_pallas, tengine.ck.solve = jrecord, trecord
    jdk._FORCE_INTERPRET = True
    try:
        jphys, tphys = _phys_pair(n, dof_lower_shift=shift,
                                  dof_upper_shift=shift)
        with pytest.raises(Stop):
            je.step(JSimState(jnp.asarray(q), jnp.asarray(qd)),
                    JControl(tau=jnp.asarray(tau)), phys=jphys)
        for ph in (tphys, None):
            with pytest.raises(Stop):
                te.step(SimState(torch.as_tensor(q), torch.as_tensor(qd)),
                        Control(tau=torch.as_tensor(tau)), phys=ph)
    finally:
        jck.solve_pallas, tengine.ck.solve = real_j, real_t
        jdk._FORCE_INTERPRET = False
    shifted, plain = got["port"]
    for name, a, b in zip(("b_lo", "b_hi", "act_lo", "act_hi"), shifted,
                          got["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)
    assert any(not np.array_equal(a, b) for a, b in zip(shifted[2:],
                                                        plain[2:]))
