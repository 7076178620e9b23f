"""Port parity of external wrenches (``Control.f_ext``) and of the aerial
tasks Ingenuity and Quadcopter (isaacgymenvs_ma_tpu_torch/tasks/
ingenuity.py, quadcopter.py) against the JAX package, on the CPU.

Nothing here jits a JAX step: the states are seeded, or the warmed-up
initial states of the committed JAX captures (tests/data/torch_port/
ingenuity_golden.npz and quadcopter_golden.npz, 32 envs; replayed whole in
tests/test_torch_golden.py), and the JAX pieces run eagerly.  Tolerances,
each with its reason:

* The scenes, the resets with injected draws and the PD targets: exact.
* The rotor wrenches of ``pre_physics``: rtol = atol = 1e-6 (Quadcopter's
  rotor frames come from each package's FK, which round apart by ~1e-7).
* ``post_physics`` on the same readouts: rtol 1e-5 / atol 1e-5.
* One engine step with wrenches: the ROADMAP's q rtol 2e-4 / atol 2e-5,
  qd 2e-3.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.models.robots import build_ant as jbuild_ant
from isaacgymenvs_ma_tpu.physics.engine import (
    Control as JControl, PhysicsEngine as JEngine, SimParams as JSimParams,
    SimState as JSimState)
from isaacgymenvs_ma_tpu.tasks import ingenuity as jing
from isaacgymenvs_ma_tpu.tasks import quadcopter as jquad
from isaacgymenvs_ma_tpu_torch.models.robots import build_ant
from isaacgymenvs_ma_tpu_torch.physics.engine import (
    Control, PhysicsEngine, SimParams, SimState)
from isaacgymenvs_ma_tpu_torch.tasks import ingenuity as ing
from isaacgymenvs_ma_tpu_torch.tasks import quadcopter as quad
from test_torch_humanoid import (
    N, Q_TOL, QD_TOL, assert_engine_scene_matches, compare_engine_step,
    load_pair, port_out, to_torch)


def random_wrench_step(jm, tm, n, seed, zero=False, root_z=None):
    """One engine step of both packages on a seeded mid-motion state of
    model ``jm`` / ``tm`` with seeded efforts and seeded wrenches on every
    body (zero wrenches with ``zero``; the root body's height ``root_z``
    if given)."""
    g = np.random.default_rng(seed)
    je = JEngine(jm, JSimParams())
    te = PhysicsEngine(tm, SimParams(), device="cpu")
    q = np.array(je.default_state(n).q)
    q[:, 0:2] += g.uniform(-1, 1, (n, 2))
    q[:, 2] += 0.3
    if root_z is not None:
        q[:, 2] = root_z
    qd = g.normal(0, 0.5, (n, je.nv)).astype(np.float32)
    tau = g.normal(0, 1, (n, je.nv)).astype(np.float32)
    f_ext = g.normal(0, 5, (n, je.nb, 6)).astype(np.float32)
    if zero:
        f_ext[:] = 0.0
    js, _ = je.step(JSimState(jnp.asarray(q), jnp.asarray(qd)),
                    JControl(tau=jnp.asarray(tau), f_ext=jnp.asarray(f_ext)))
    ts, _ = te.step(SimState(torch.as_tensor(q), torch.as_tensor(qd)),
                    Control(tau=torch.as_tensor(tau),
                            f_ext=torch.as_tensor(f_ext)))
    free, _ = te.step(SimState(torch.as_tensor(q), torch.as_tensor(qd)),
                      Control(tau=torch.as_tensor(tau)))
    return js, ts, free


@pytest.mark.parametrize("scene", ["ant", "ingenuity", "ingenuity_landed"])
def test_f_ext_step_matches_jax(scene):
    """A step with a seeded wrench on every body (each about its own
    origin, moved to the world origin onto the dofs that move the body) on
    Ant (hinged legs on a free torso, ground contact) and Ingenuity (a free
    chassis with two fixed rotors; in the air, and landed with its box's
    corners 2 mm into the ground): the JAX engine's step, and far from the
    step without them."""
    if scene == "ant":
        jm, tm = jbuild_ant(), build_ant()
    else:
        jm, tm = jing.build_ingenuity()[0], ing.build_ingenuity()[0]
    root_z = 0.058 if scene == "ingenuity_landed" else None
    js, ts, free = random_wrench_step(jm, tm, 8, seed=3, root_z=root_z)
    np.testing.assert_allclose(ts.q.numpy(), np.asarray(js.q), **Q_TOL)
    np.testing.assert_allclose(ts.qd.numpy(), np.asarray(js.qd), **QD_TOL)
    assert float((free.qd - ts.qd).abs().max()) > 0.1


def test_zero_f_ext_leaves_the_step_unchanged():
    """A zero wrench on every body gives the step without one, bit for
    bit (the term adds exact zeros to the generalized force)."""
    _, ts, free = random_wrench_step(jbuild_ant(), build_ant(), 4, seed=5,
                                     zero=True)
    assert torch.equal(ts.q, free.q) and torch.equal(ts.qd, free.qd)


# ---------------------------------------------------------------- Ingenuity
@pytest.fixture(scope="module")
def ip():
    return load_pair(jing, ing.Ingenuity, "ingenuity_golden.npz")


def test_ingenuity_scene_matches_jax(ip):
    """A free chassis box and two fixed rotor cylinders (nb 3, nv 6): the
    box's 8 corners are the ground rows; Mars gravity."""
    jt, tt = ip["jt"], ip["tt"]
    e = tt.engine
    assert (e.nb, e.nv, e.n_ground) == (3, 6, 8)
    assert_engine_scene_matches(jt, tt)
    np.testing.assert_array_equal(tt.rotor_bodies, jt.rotor_bodies)
    assert tt.sim_params.gravity == (0.0, 0.0, -3.721)
    cp = ip["tb4"].engine.cplan
    assert (cp.P, cp.nv) == (8, 6)


def test_ingenuity_pre_physics_matches_jax(ip):
    """The rotor thrusts in the chassis frame, rotated into world wrenches
    at the rotors; none in the envs flagged to reset."""
    a = ip["d"]["actions"][0]
    ref = ip["jt"].pre_physics(ip["jst"], jnp.asarray(a))
    got = ip["tt"].pre_physics(ip["tst"], torch.as_tensor(a))
    np.testing.assert_allclose(got.f_ext.numpy(), np.asarray(ref.f_ext),
                               rtol=1e-6, atol=1e-6)
    flagged = ip["d"]["init_reset_buf"] > 0
    assert flagged.any() and not got.f_ext.numpy()[flagged].any()
    assert np.abs(got.f_ext.numpy()[~flagged]).max() > 1.0


def test_ingenuity_reset_and_post_physics_match_jax(ip):
    """Half the envs reset with the JAX draws injected (chassis pose and
    new targets exactly); then ``post_physics`` on one JAX step's readout
    with the new targets' draws injected, some envs at a multiple of 500
    steps (their targets drawn again)."""
    jt, tt, d = ip["jt"], ip["tt"], ip["d"]
    key = jax.random.PRNGKey(4)
    k1, k2, k3 = jax.random.split(key, 3)
    k31, k32 = jax.random.split(k3)
    u = jax.random.uniform
    draws = (u(k1, (N, 2), minval=-1.5, maxval=1.5),
             u(k2, (N, 1), minval=-0.2, maxval=1.5), u(k31, (N, 2)),
             u(k32, (N, 1)))
    mask = np.arange(N) % 2 == 0
    jsim, jtask = jt.reset_idx(ip["jst"].sim, ip["jst"].task,
                               jnp.asarray(mask), key)
    tsim, ttask = tt.reset_idx(ip["tst"].sim, ip["tst"].task,
                               torch.as_tensor(mask),
                               tuple(to_torch(x) for x in draws))
    np.testing.assert_array_equal(tsim.q.numpy(), np.asarray(jsim.q))
    np.testing.assert_array_equal(tsim.qd.numpy(), np.asarray(jsim.qd))
    np.testing.assert_array_equal(ttask.target.numpy(),
                                  np.asarray(jtask.target))

    a = d["actions"][0]
    _, jout = jt.engine.step(ip["jst"].sim,
                             jt.pre_physics(ip["jst"], jnp.asarray(a)))
    prog = np.where(np.arange(N) % 4 == 0, 500, 3).astype(np.int32)
    rng = jax.random.PRNGKey(6)
    jst = ip["jst"]._replace(progress=jnp.asarray(prog), rng=rng)
    tst = ip["tst"]._replace(progress=torch.as_tensor(prog))
    t1, t2 = jax.random.split(jax.random.fold_in(rng, 31))
    sdraws = tuple(to_torch(x) for x in (u(t1, (N, 2)), u(t2, (N, 1))))
    ref = jt.post_physics(jst, jout, jnp.asarray(a))
    got = tt.post_physics(tst, port_out(jout), torch.as_tensor(a),
                          draws=sdraws)
    for i, name in ((0, "obs"), (2, "rew")):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(got[4].target.numpy(),
                                  np.asarray(ref[4].target))
    moved = (got[4].target != ip["tst"].task.target).any(-1).numpy()
    np.testing.assert_array_equal(moved, prog % 500 == 0)


@pytest.mark.parametrize("kernel_route", [False, True],
                         ids=["default_loop", "contact_kernel"])
def test_ingenuity_engine_step_matches_jax(ip, kernel_route):
    """One step with the rotor wrenches of the capture's first actions."""
    a = ip["d"]["actions"][0]
    compare_engine_step(ip, ip["jt"].pre_physics(ip["jst"], jnp.asarray(a)),
                        ip["tt"].pre_physics(ip["tst"], torch.as_tensor(a)),
                        kernel_route=kernel_route)


# ---------------------------------------------------------------- Quadcopter
@pytest.fixture(scope="module")
def qp():
    return load_pair(jquad, quad.Quadcopter, "quadcopter_golden.npz")


def test_quadcopter_scene_matches_jax(qp):
    """A free cylinder chassis and four arms with two hinges each (nb 9,
    nv 14, kp 1000 drives): the cylinder gives no ground candidate, so the
    scene has no contact rows and steps through the joint-limit solve, on
    either route."""
    jt, tt = qp["jt"], qp["tt"]
    e = tt.engine
    assert (e.nb, e.nv, e.n_ground) == (9, 14, 0)
    assert_engine_scene_matches(jt, tt)
    assert list(tt.rotor_bodies) == list(jt.rotor_bodies)
    assert not e.has_contact_rows and qp["tb4"].engine.cplan is None
    for name in ("dof_lower", "dof_upper"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)))


def test_quadcopter_pre_physics_matches_jax(qp):
    """The integrated arm targets and thrusts (held in the envs flagged to
    reset), the thrust along each rotor's z axis from the plain FK."""
    a = qp["d"]["actions"][0]
    ref = qp["jt"].pre_physics(qp["jst"], jnp.asarray(a))
    got = qp["tt"].pre_physics(qp["tst"], torch.as_tensor(a))
    np.testing.assert_array_equal(got.pos_target.numpy(),
                                  np.asarray(ref.pos_target))
    np.testing.assert_allclose(got.f_ext.numpy(), np.asarray(ref.f_ext),
                               rtol=1e-6, atol=1e-6)
    for f in ("dof_targets", "thrusts"):
        np.testing.assert_array_equal(
            getattr(qp["tt"]._new_task, f).numpy(),
            np.asarray(getattr(qp["jt"]._new_task, f)), err_msg=f)
    assert float(got.f_ext.abs().max()) > 0.1


def test_quadcopter_reset_and_post_physics_match_jax(qp):
    """Half the envs reset with the JAX draws injected (root pose, dof
    positions and velocities exactly); ``post_physics`` on one JAX step's
    readout returns the task state ``pre_physics`` left."""
    jt, tt, d = qp["jt"], qp["tt"], qp["d"]
    key = jax.random.PRNGKey(8)
    k1, k2, k3 = jax.random.split(key, 3)
    u = jax.random.uniform
    draws = (u(k1, (N, 2), minval=-1.5, maxval=1.5),
             u(k2, (N, 1), minval=-0.2, maxval=1.5),
             u(k3, (N, 8), minval=-0.2, maxval=0.2))
    mask = np.arange(N) % 2 == 1
    jsim, _ = jt.reset_idx(qp["jst"].sim, qp["jst"].task, jnp.asarray(mask),
                           key)
    tsim, _ = tt.reset_idx(qp["tst"].sim, qp["tst"].task,
                           torch.as_tensor(mask),
                           tuple(to_torch(x) for x in draws))
    np.testing.assert_array_equal(tsim.q.numpy(), np.asarray(jsim.q))
    np.testing.assert_array_equal(tsim.qd.numpy(), np.asarray(jsim.qd))

    a = d["actions"][0]
    jctrl = jt.pre_physics(qp["jst"], jnp.asarray(a))
    tt.pre_physics(qp["tst"], torch.as_tensor(a))
    _, jout = jt.engine.step(qp["jst"].sim, jctrl)
    ref = jt.post_physics(qp["jst"], jout, jnp.asarray(a))
    got = tt.post_physics(qp["tst"], port_out(jout), torch.as_tensor(a))
    for i, name in ((0, "obs"), (2, "rew")):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert got[4] is tt._new_task


def test_quadcopter_engine_step_matches_jax(qp):
    """One step with the PD targets and rotor wrenches of the capture's
    first actions, through the joint-limit solve."""
    a = qp["d"]["actions"][0]
    compare_engine_step(qp, qp["jt"].pre_physics(qp["jst"], jnp.asarray(a)),
                        qp["tt"].pre_physics(qp["tst"], torch.as_tensor(a)))


@pytest.mark.parametrize("name", ["Ingenuity", "Quadcopter"])
def test_aerial_tasks_step_through_their_entry_points(name):
    """``api.make`` builds each on the CPU when asked; three steps of
    random actions stay finite."""
    from isaacgymenvs_ma_tpu_torch import api
    task = api.make(seed=2, task=name, num_envs=8, sim_device="cpu")
    assert type(task).__name__ == name and task.device.type == "cpu"
    st = task.initial_state()
    for _ in range(3):
        st, res = task.step(st, torch.tanh(torch.randn(8, task.num_actions)))
    assert res.obs.shape == (8, task.num_obs)
    assert torch.isfinite(res.obs).all()
