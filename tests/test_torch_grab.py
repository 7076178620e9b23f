"""Port parity of the engine's grab constraints
(isaacgymenvs_ma_tpu_torch/physics/engine.py: ``_build_grabs``,
``_grab_rows`` and the grab group of ``_contact_solve``) against the JAX
engine (isaacgymenvs_ma_tpu/physics/engine.py:526-535, :1652-1682,
:1708-1716, :1858-1863), on the CPU.

A grab pins a point on body a to a point on body b while its env's
``Control.grab_active`` entry is 1.  Each test here makes its grabs live
and checks that they moved something.  Tolerances, each with its reason:

* The grab rows alone (J, H^-1 J, W, b and the midpoint): rtol 1e-5 /
  atol 1e-6: the same float32 expressions, summed in other orders.
* One engine step of a small scene (two free boxes pinned by one grab,
  one resting on the ground) and of a grab-only scene: q rtol 2e-4 /
  atol 2e-5, qd rtol = atol = 3e-3, the JAX package's own bounds for
  scenes with pair and attractor rows (tests/test_dyn_kernel.py:139-159).
* Kernel B4's twin with its grab group against the JAX ``solve_pallas``
  in interpret mode on FrankaCollectMA's plan (nv 30, 65 contact rows
  with frames, 4 grab rows) and the inputs its B4 route builds at 64 envs
  with live grabs: rtol = atol = 1e-4, the bound of
  tests/test_torch_contact_kernel.py (the same arithmetic, other sum
  orders).
"""
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.models.model import (FREE, GEOM_BOX, ModelBuilder,
                                              compose_scene)
from isaacgymenvs_ma_tpu.ops import maths as jmaths
from isaacgymenvs_ma_tpu.physics import contact_kernel as jck
from isaacgymenvs_ma_tpu.physics import dyn_kernel as jdk
from isaacgymenvs_ma_tpu.physics.engine import (
    Control as JControl, PhysicsEngine as JEngine, SimParams as JSimParams,
    SimState as JSimState)
from isaacgymenvs_ma_tpu_torch.physics import contact_kernel as ck
from isaacgymenvs_ma_tpu_torch.physics.engine import (
    Control, PhysicsEngine, SimParams, SimState)
from isaacgymenvs_ma_tpu_torch.tasks.franka_collect_ma import (
    FrankaCollectMA, TASK_CFG as COLLECT_CFG)
from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.utils.parity import live_grabs

HALF = 0.05
N = 4


def two_boxes():
    """Box B resting on the ground, box A 0.3 m above it; the grab pins a
    point 4 cm under A's centre to a point 25 cm over B's (~1 cm apart)."""
    cb = ModelBuilder()
    cb.begin_actor()
    body = cb.add_body("box", -1, FREE, body_pos=(0, 0, 0))
    cb.add_geom(body, GEOM_BOX, np.full(3, HALF), density=500.0,
                name="box_geom")
    box = cb.finalize()
    m = compose_scene([(box, (0.0, 0.0, 0.35), (0, 0, 0, 1)),
                       (box, (0.0, 0.0, HALF - 0.002), (0, 0, 0, 1))])
    grabs = [(0, (0.0, 0.0, -0.04), 1, (0.0, 0.0, 0.25))]
    return m, grabs


def seeded_state(m, seed):
    """The boxes' default poses, turned and moved a little per env, with
    small seeded velocities, the lower box moving down into the ground."""
    g = np.random.default_rng(seed)
    q = np.tile(np.asarray(m.init_qpos, np.float32), (N, 1))
    for b in range(2):
        qa = int(m.q_adr[b])
        q[:, qa: qa + 2] += g.uniform(-0.02, 0.02, (N, 2))
        quat = np.array([0, 0, 0, 1.0]) + 0.05 * g.normal(size=(N, 4))
        q[:, qa + 3: qa + 7] = quat / np.linalg.norm(quat, axis=-1,
                                                    keepdims=True)
    qd = g.normal(0.0, 0.1, (N, m.nv)).astype(np.float32)
    qd[:, int(m.v_adr[1]) + 2] = -0.3
    return q.astype(np.float32), qd


def jax_grab_rows(je, body_x, body_q, S, Hinv, h):
    """The JAX engine's grab block (engine.py:1652-1673), as written there."""
    g_J, g_b, g_pts = [], [], []
    for g in je.grabs:
        pa = (body_x[:, g["body_a"]] + jmaths.quat_apply(
            body_q[:, g["body_a"]], g["off_a"]))[:, None]
        pb = (body_x[:, g["body_b"]] + jmaths.quat_apply(
            body_q[:, g["body_b"]], g["off_b"]))[:, None]
        pm = 0.5 * (pa + pb)
        Jg = (S[:, None, :, 3:6] + jnp.cross(S[:, None, :, 0:3],
                                             pm[:, :, None, :])) \
            * g["mask"][None, None, :, None]
        g_J.append(Jg)
        g_pts.append(pm)
        g_b.append(-je.params.baumgarte / h * (pa - pb))
    g_J = jnp.concatenate(g_J, 1)                          # (N, G, nv, 3)
    n, G = g_J.shape[:2]
    rows = jnp.swapaxes(g_J, 2, 3).reshape(n, G * 3, je.nv)
    hj = jnp.einsum("nrv,nvw->nrw", rows, Hinv)
    g_HJ = jnp.swapaxes(hj.reshape(n, G, 3, je.nv), 2, 3)
    g_W = jnp.maximum(jnp.sum(g_J * g_HJ, axis=2), 1e-8)
    return (jnp.concatenate(g_pts, 1), rows, hj, g_W,
            jnp.concatenate(g_b, 1))


def test_grab_rows_match_jax():
    """J at the two points' midpoint, H^-1 J, W and b on seeded S, poses
    and H^-1, for the two-box grab and the four grabs of FrankaCollectMA
    (every grip site with every cube)."""
    m, grabs = two_boxes()
    task = FrankaCollectMA(deep_merge(COLLECT_CFG, {"env": {"numEnvs": 2}}),
                           device="cpu")
    for model, gspec, seed in ((m, grabs, 0),
                               (task.model, task._grab_specs(), 1)):
        params = SimParams(dt=1 / 60, substeps=2)
        te = PhysicsEngine(model, params, ground=False, grabs=gspec,
                           device="cpu")
        je = JEngine(model, JSimParams(dt=1 / 60, substeps=2), ground=False,
                     grabs=gspec)
        g = np.random.default_rng(seed)
        nb, nv, n = te.nb, te.nv, 8
        body_x = g.uniform(-1, 1, (n, nb, 3)).astype(np.float32)
        quat = g.normal(size=(n, nb, 4))
        body_q = (quat / np.linalg.norm(quat, axis=-1,
                                        keepdims=True)).astype(np.float32)
        S = g.normal(size=(n, nv, 6)).astype(np.float32)
        M = g.normal(size=(n, nv, nv)) / np.sqrt(nv)
        Hinv = (M @ np.swapaxes(M, 1, 2) + 0.5 * np.eye(nv)).astype(
            np.float32)
        act = (g.uniform(size=(n, len(gspec))) < 0.5).astype(np.float32)
        pm, J, HJ, W, b, g_act = te._grab_rows(
            *map(torch.as_tensor, (body_x, body_q, S, Hinv)),
            torch.as_tensor(act))
        ref = jax_grab_rows(je, *map(jnp.asarray, (body_x, body_q, S, Hinv)),
                            je.h)
        for name, a, r in zip(("pm", "J", "HJ", "W", "b"), (pm, J, HJ, W, b),
                              ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(g_act.numpy(), act)
        np.testing.assert_array_equal(
            te.grab_mask.numpy(), np.stack([np.asarray(x["mask"])
                                            for x in je.grabs]))
        assert float(np.abs(np.asarray(ref[4])).max()) > 0.1
        # no grab_active: every grab off (engine.py:1676-1677)
        assert not te._grab_rows(
            *map(torch.as_tensor, (body_x, body_q, S, Hinv)), None)[5].any()


@pytest.mark.parametrize("route", ["loop", "b4"])
@pytest.mark.parametrize("grab", ["on", "off", "none"])
def test_engine_step_with_grab_matches_jax(route, grab):
    """One step of the two-box scene (16 ground rows, one grab) against the
    JAX engine's default loop, the grab on in every env, off (zeros) or
    not given.  On the B4 route (the twin on the CPU) the same loop runs
    through kernel B4's grab group: every row from zero impulses, as the
    JAX loop does here (no capacity, no row reuse)."""
    m, grabs = two_boxes()
    q, qd = seeded_state(m, 3)
    act = {"on": np.ones((N, 1), np.float32),
           "off": np.zeros((N, 1), np.float32), "none": None}[grab]
    tau = np.zeros((N, m.nv), np.float32)
    je = JEngine(m, JSimParams(dt=1 / 60, substeps=2), grabs=grabs)
    jsim, jout = jax.jit(je.step)(
        JSimState(jnp.asarray(q), jnp.asarray(qd)),
        JControl(tau=jnp.asarray(tau),
                 grab_active=None if act is None else jnp.asarray(act)))
    te = PhysicsEngine(m, SimParams(dt=1 / 60, substeps=2,
                                    use_contact_kernel=route == "b4"),
                       grabs=grabs, device="cpu")
    assert te.has_contact_rows and (te.cplan is not None) == (route == "b4")
    if route == "b4":
        assert te.cplan.G == 1 and te.cplan.P == te.n_ground == 16
    tsim, tout = te.step(
        SimState(torch.as_tensor(q), torch.as_tensor(qd)),
        Control(tau=torch.as_tensor(tau),
                grab_active=None if act is None else torch.as_tensor(act)))
    np.testing.assert_allclose(tsim.q.numpy(), np.asarray(jsim.q),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tsim.qd.numpy(), np.asarray(jsim.qd),
                               rtol=3e-3, atol=3e-3)
    for name in ("contact_force", "dof_force"):
        ref = np.asarray(getattr(jout, name))
        np.testing.assert_allclose(
            getattr(tout, name).numpy(), ref, rtol=3e-3,
            atol=3e-3 * max(1.0, float(np.abs(ref).max())), err_msg=name)
    # the box on the ground is in contact; the grab moved the boxes
    assert float(np.abs(np.asarray(jout.contact_force)).max()) > 0.1
    free, _ = te.step(SimState(torch.as_tensor(q), torch.as_tensor(qd)),
                      Control(tau=torch.as_tensor(tau)))
    moved = float((free.qd - tsim.qd).abs().max())
    if grab == "on":
        assert act.sum() > 0 and moved > 0.1
    else:
        assert moved == 0.0


def test_grab_only_scene_takes_the_loop_in_both_packages():
    """No ground, no pairs, one grab: the JAX engine enters its contact
    solve with an empty row set (engine.py:966, :1392-1398) and has no
    kernel route there (:1297); the port runs its batched loop whatever
    use_contact_kernel says (B4 needs a contact row), and the step matches
    with the grab live in half the envs."""
    m, grabs = two_boxes()
    q, qd = seeded_state(m, 4)
    act = np.array([[1.0], [0.0], [1.0], [0.0]], np.float32)
    tau = np.zeros((N, m.nv), np.float32)
    je = JEngine(m, JSimParams(dt=1 / 60, substeps=2), ground=False,
                 grabs=grabs)
    jsim, _ = jax.jit(je.step)(JSimState(jnp.asarray(q), jnp.asarray(qd)),
                               JControl(tau=jnp.asarray(tau),
                                        grab_active=jnp.asarray(act)))
    for kernel_route in (False, True):
        te = PhysicsEngine(m, SimParams(dt=1 / 60, substeps=2,
                                        use_contact_kernel=kernel_route),
                           ground=False, grabs=grabs, device="cpu")
        assert te.has_contact_rows and te.cplan is None
        assert te.n_ground == te.n_pair_rows == 0
        tsim, tout = te.step(SimState(torch.as_tensor(q),
                                      torch.as_tensor(qd)),
                             Control(tau=torch.as_tensor(tau),
                                     grab_active=torch.as_tensor(act)))
        np.testing.assert_allclose(tsim.q.numpy(), np.asarray(jsim.q),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(tsim.qd.numpy(), np.asarray(jsim.qd),
                                   rtol=3e-3, atol=3e-3)
        assert tout.contact_force.shape == (N, 2, 3)
        assert not tout.contact_force.any()
    # the envs without a live grab fall as with every grab off; the live
    # grab pulls the boxes together
    jfree, _ = jax.jit(je.step)(JSimState(jnp.asarray(q), jnp.asarray(qd)),
                                JControl(tau=jnp.asarray(tau)))
    dev = np.abs(np.asarray(jsim.qd) - np.asarray(jfree.qd)).max(axis=-1)
    assert (dev[[1, 3]] == 0.0).all() and (dev[[0, 2]] > 0.1).all()


def capture_b4_call(n, iterations):
    """Kernel B4's arguments in one step of FrankaCollectMA at ``n`` envs on
    the B4 route, with live grabs in every other env (cubes on the grip
    sites, grippers closing), from the state after the first step's
    reset; and the plan's masks in a plan of ``iterations`` iterations."""
    cfg = deep_merge(COLLECT_CFG, {"env": {"numEnvs": n}})
    task = FrankaCollectMA(cfg, device="cpu", sim_params=parse_sim_params(
        cfg["sim"])._replace(use_contact_kernel=True))
    g = torch.Generator().manual_seed(5)
    act = lambda: torch.rand((2 * n, 7), generator=g) * 2 - 1  # noqa: E731
    st, _ = task.step(task.initial_state(), act())
    actions = act()
    st = live_grabs(task, st, actions, torch.arange(0, n, 2))
    box = []
    solve = ck.solve

    def spy(plan, *a, **k):
        box.append((a, k))
        return solve(plan, *a, **k)

    ck.solve = spy
    try:
        task.step(st, actions)
    finally:
        ck.solve = solve
    cp = task.engine.cplan
    return ck.ContactPlan(cp.masks, cp.nv, iterations, cp.relaxation,
                          cp.has_frames), box[0]


def test_b4_twin_with_grab_group_matches_jax_interpret():
    """B4's wrapper (the twin on the CPU) on FrankaCollectMA's plan (nv 30,
    65 candidate rows with frames, 4 grab rows) and the inputs the B4
    route hands it at 64 envs with live grabs, against ``solve_pallas`` in
    interpret mode (64 is the smallest batch its block picker takes).  The
    plan runs 6 iterations, not the task's 18: each iteration is the same
    arithmetic, and interpret mode's time grows with their number (18 take
    ~80 s on the CPU)."""
    plan, (a, k) = capture_b4_call(64, 6)
    assert (plan.nv, plan.P, plan.G) == (30, 65, 4)
    assert not plan.cols_in_registers()
    assert float(k["g_act"].sum()) >= 64     # two live grabs an even env
    S_bl, hinv_bl, qd, pts_c, b_n, mu, active, frames, w_c = a[:9]
    rest = a[9:]                            # b_lo, b_hi, act_lo, act_hi
    jx = lambda t: jnp.asarray(t.numpy())   # noqa: E731
    jdk._FORCE_INTERPRET = True
    try:
        ref = jck.solve_pallas(
            SimpleNamespace(params=SimpleNamespace(
                relaxation=plan.relaxation,
                num_iterations=plan.num_iterations)),
            jx(S_bl), jx(hinv_bl), jx(qd), {
                key: jnp.asarray(v) for key, v in plan.masks.items()
                if v.shape[0]},
            *(jx(t) for t in (pts_c, b_n, mu, active, frames, w_c, *rest)),
            **{key: jx(v) for key, v in k.items()})
    finally:
        jdk._FORCE_INTERPRET = False
    got = ck.solve(plan, *a, **k)
    for name, x, y in zip(("qd", "lam", "imp_dof"), got, ref):
        assert tuple(x.shape) == tuple(y.shape), name
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # the live grabs moved qd: the same solve with every grab off differs
    off = ck.solve(plan, *a, **dict(k, g_act=torch.zeros_like(k["g_act"])))
    assert float((off[0] - got[0]).abs().max()) > 0.01
