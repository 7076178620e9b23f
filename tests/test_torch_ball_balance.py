"""Port parity of BallBalance (isaacgymenvs_ma_tpu_torch/tasks/ball_balance.py)
and of the contact-kernel route (``SimParams.use_contact_kernel``, kernel
B4's twin on the CPU) against the JAX package, on the same state, the same
actions and the same reset draws.

BallBalance exercises what the Ant step does not: PD position targets, one
ball-vs-tray pair row with a tangent frame, three attractor rows, force
sensors read from a pair row's body-b end, resets before physics.

Tolerances: q rtol 2e-4 / atol 2e-5 and, for the pair/attractor scene, qd,
obs and reward rtol = atol = 3e-3 — the JAX package's own bounds for its
kernel route on this scene (tests/test_dyn_kernel.py:139-159).  Resets
exact.  (Ant on the kernel route: tests/test_torch_ant_step.py.)  The
primitives ``_sdf_local``/``_tangent_frame`` are float32 elementwise
formulas and are held at 1e-6; the copied model builders exactly.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.ops import rng as jrng
from isaacgymenvs_ma_tpu.physics.engine import PhysicsEngine as JEngine
from isaacgymenvs_ma_tpu.tasks.ball_balance import (
    BallBalance as JBB, TASK_CFG as JCFG)
from isaacgymenvs_ma_tpu.utils.config import deep_merge as jdeep_merge
from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax
from isaacgymenvs_ma_tpu_torch.physics.engine import (
    Control, PhysicsEngine, SimState)
from isaacgymenvs_ma_tpu_torch.tasks.ant import Ant, TASK_CFG as ACFG
from isaacgymenvs_ma_tpu_torch.tasks.ball_balance import (
    BallBalance, TASK_CFG)
from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

ROUTE_STEP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                          "torch_port", "ball_balance_route_step.npz")
# 128: the smallest batch on which the JAX package runs its kernel route
# (its dynamics kernels, whose H^-1 routes the contact solve to B4, need
# N % 128 == 0)
N = 128


def port_task(cls, cfg, n, kernel_route):
    cfg = deep_merge(cfg, {"env": {"numEnvs": n}})
    params = parse_sim_params(cfg["sim"])._replace(
        use_contact_kernel=kernel_route)
    return cls(cfg, device="cpu", sim_params=params)


def jax_state_arrays(st) -> dict:
    arrays = {"sim.q": np.array(st.sim.q), "sim.qd": np.array(st.sim.qd),
              "progress": np.array(st.progress),
              "reset_buf": np.array(st.reset_buf)}
    arrays.update({f"task.{f}": np.array(getattr(st.task, f))
                   for f in st.task._fields})
    return arrays


def bb_reset_draws(st, n):
    """The draws the JAX BallBalance.step makes from ``st.rng`` for its
    resets (base.py:229, ball_balance.py:207-226)."""
    k1, k2, k3, k4 = jax.random.split(jax.random.split(st.rng, 6)[1], 4)
    return tuple(torch.as_tensor(np.array(x)) for x in (
        jrng.rand_float(k1, 0.001, 0.5, (n, 1)),
        jrng.random_dir_2(k2, (n, 1))[:, 0, :],
        jrng.rand_float(k3, 0.0, 5.0, (n, 1)),
        jrng.rand_float(k4, 1.0, 2.0, (n,))))


@pytest.fixture(scope="module")
def bb():
    """JAX BallBalance at 128 envs: the initial state and a state 10 steps
    on, with the balls landed on the trays; port tasks on both routes."""
    jt = JBB(jdeep_merge(JCFG, {"env": {"numEnvs": N}}))
    step = jax.jit(jt.step)
    st0 = jt.initial_state(jax.random.PRNGKey(11))
    rng = np.random.default_rng(N)
    st = st0
    for _ in range(10):
        st, _ = step(st, jnp.asarray(rng.uniform(-1, 1, (N, 3)), jnp.float32))
    acts = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    return dict(jt=jt, step=step, st0=st0, st=st, acts=acts,
                default=port_task(BallBalance, TASK_CFG, N, False),
                kernel=port_task(BallBalance, TASK_CFG, N, True))


def _compare_step(jstep, tt, st, acts, draws, tol):
    st2, res = jstep(st, jnp.asarray(acts))
    ts = env_state_from_jax(jax_state_arrays(st), "cpu")
    ts2, tres = tt.step(ts, torch.as_tensor(acts), reset_draws=draws)
    np.testing.assert_allclose(ts2.sim.q.numpy(), np.asarray(st2.sim.q),
                               rtol=2e-4, atol=2e-5)
    for name, a, b in (("qd", ts2.sim.qd, st2.sim.qd),
                       ("obs", tres.obs, res.obs), ("rew", tres.rew, res.rew)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol, err_msg=name)
    np.testing.assert_array_equal(tres.reset.numpy(), np.asarray(res.reset))
    np.testing.assert_array_equal(ts2.progress.numpy(),
                                  np.asarray(st2.progress))
    for f in st2.task._fields:
        np.testing.assert_allclose(getattr(ts2.task, f).numpy(),
                                   np.asarray(getattr(st2.task, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    return res


def test_first_step_resets_every_env(bb):
    """reset_buf starts at 1: BallBalance resets every env before physics,
    with the JAX draws injected, and zeroes the fresh targets."""
    st0 = bb["st0"]
    assert int(np.asarray(st0.reset_buf).min()) == 1
    _compare_step(bb["step"], bb["default"], st0, bb["acts"],
                  bb_reset_draws(st0, N), 3e-3)


def test_step_without_resets(bb):
    st = bb["st"]._replace(reset_buf=jnp.zeros_like(bb["st"].reset_buf))
    res = _compare_step(bb["step"], bb["default"], st, bb["acts"], None, 3e-3)
    # the balls rest on the trays: the tray force sensors read the pair row
    assert float(np.abs(np.asarray(res.obs)[:, 12:]).max()) > 0.1


def test_step_with_partial_resets(bb):
    st = bb["st"]._replace(
        reset_buf=jnp.asarray((np.arange(N) % 2).astype(np.int32)))
    _compare_step(bb["step"], bb["default"], st, bb["acts"],
                  bb_reset_draws(st, N), 3e-3)


def test_kernel_route_matches_jax_interpret(bb):
    """use_contact_kernel (B4's twin on the CPU) against the JAX kernel
    route in interpret mode (pair rows with frames, attractor rows), a
    quarter of the envs reset.  The interpreted JAX step (~50-180 s on the
    CPU) was recorded from this fixture's state, actions and reset draws by
    ``scripts/record_torch_golden.py --route-step BallBalance`` into
    tests/data/torch_port/ball_balance_route_step.npz; the capture's start
    is checked against the fixture's live JAX state here, and the port's
    step is held against the recorded one at the bounds of
    :func:`_compare_step`."""
    d = np.load(ROUTE_STEP)
    st = bb["st"]._replace(
        reset_buf=jnp.asarray((np.arange(N) % 4 == 0).astype(np.int32)))
    start = jax_state_arrays(st)
    for k, v in start.items():     # where the capture came from
        np.testing.assert_allclose(d["init_" + k.split(".")[-1]], v,
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(d["actions"], bb["acts"])
    draws = bb_reset_draws(st, N)
    for i, x in enumerate(draws):
        np.testing.assert_array_equal(d[f"draw_{i}"], x.numpy())
    ts = env_state_from_jax({k: d["init_" + k.split(".")[-1]]
                             for k in start}, "cpu")
    ts2, tres = bb["kernel"].step(ts, torch.as_tensor(d["actions"]),
                                  reset_draws=draws)
    np.testing.assert_allclose(ts2.sim.q.numpy(), d["q"],
                               rtol=2e-4, atol=2e-5)
    for name, a, b in (("qd", ts2.sim.qd, d["qd"]),
                       ("obs", tres.obs, d["obs"]), ("rew", tres.rew, d["rew"])):
        np.testing.assert_allclose(a.numpy(), b, rtol=3e-3, atol=3e-3,
                                   err_msg=name)
    np.testing.assert_array_equal(tres.reset.numpy(), d["reset"])
    np.testing.assert_array_equal(ts2.progress.numpy(), d["progress"])
    for f in ts2.task._fields:
        np.testing.assert_allclose(getattr(ts2.task, f).numpy(),
                                   d[f"task_{f}"], rtol=1e-6, atol=1e-6,
                                   err_msg=f)
    assert float(np.abs(d["obs"][:, 12:]).max()) > 0.1


def test_engine_step_matches_jax(bb):
    """PhysicsEngine.step alone, both routes: state and every readout,
    including the tray sensors and the net contact forces (+f on the ball,
    -f on the tray)."""
    from isaacgymenvs_ma_tpu.physics.engine import (
        Control as JControl, SimState as JSimState)
    jt, st = bb["jt"], bb["st"]
    g = np.random.default_rng(3)
    pos_t = np.zeros((N, 18), np.float32)
    pos_t[:, jt.engine.scalar_dofs] = g.uniform(-0.3, 0.3, (N, 6))
    zeros = np.zeros((N, 18), np.float32)
    jsim, jout = jax.jit(jt.engine.step)(
        JSimState(st.sim.q, st.sim.qd),
        JControl(tau=jnp.asarray(zeros), pos_target=jnp.asarray(pos_t),
                 vel_target=jnp.asarray(zeros)))
    for tt in (bb["default"], bb["kernel"]):
        tsim, tout = tt.engine.step(
            SimState(torch.as_tensor(np.array(st.sim.q)),
                     torch.as_tensor(np.array(st.sim.qd))),
            Control(tau=torch.as_tensor(zeros),
                    pos_target=torch.as_tensor(pos_t),
                    vel_target=torch.as_tensor(zeros)))
        np.testing.assert_allclose(tsim.q.numpy(), np.asarray(jsim.q),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(tsim.qd.numpy(), np.asarray(jsim.qd),
                                   rtol=3e-3, atol=3e-3)
        for name in ("body_pos", "body_quat", "body_vel", "root_states"):
            np.testing.assert_allclose(getattr(tout, name).numpy(),
                                       np.asarray(getattr(jout, name)),
                                       rtol=3e-3, atol=3e-3, err_msg=name)
        for name in ("contact_force", "sensor_forces", "dof_force", "qdd"):
            ref = np.asarray(getattr(jout, name))
            np.testing.assert_allclose(
                getattr(tout, name).numpy(), ref, rtol=3e-3,
                atol=3e-3 * max(1.0, float(np.abs(ref).max())), err_msg=name)
    # the ball's contact force is the tray's, negated
    cf = np.asarray(jout.contact_force)
    assert float(np.abs(cf[:, 7]).max()) > 1.0


def _sdf_points(gtype):
    """Seeded local points inside, outside and on the axes of a primitive,
    and its size."""
    g = np.random.default_rng(gtype)
    size = {0: [0.1, 0, 0], 1: [0.05, 0.2, 0], 4: [0.5, 0.01, 0],
            2: [0.3, 0.2, 0.1]}[gtype]
    p = g.uniform(-0.7, 0.7, (256, 3))
    p[:8] = 0.0
    p[8:16, :2] = 0.0
    return np.asarray(size, np.float32), p.astype(np.float32)


@pytest.mark.parametrize("gtype", [0, 1, 4, 2],
                         ids=["sphere", "capsule", "cylinder", "box"])
def test_sdf_local_matches_jax(gtype):
    size, p = _sdf_points(gtype)
    d_ref, n_ref = JEngine._sdf_local(gtype, jnp.asarray(size),
                                      jnp.asarray(p))
    d, n = PhysicsEngine._sdf_local(gtype, torch.as_tensor(size),
                                    torch.as_tensor(p))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(n.numpy(), np.asarray(n_ref), rtol=1e-6,
                               atol=1e-6)


def test_tangent_frame_matches_jax():
    g = np.random.default_rng(9)
    n = g.normal(size=(256, 3))
    n[:16] = [0.0, 0.0, 1.0]           # the ez/ex reference switch
    n[16:32] = [0.1, 0.0, -0.99]
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    ref = np.asarray(JEngine._tangent_frame(jnp.asarray(n)))
    got = PhysicsEngine._tangent_frame(torch.as_tensor(n)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.einsum("nij,nik->njk", got, got),
                               np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-5)


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


@pytest.mark.parametrize("which", ["ant", "balance_bot", "humanoid", "anymal",
                                   "ingenuity", "quadcopter", "kuka_allegro",
                                   "shadow_hand", "allegro_hand"])
def test_copied_model_builders_match_jax(which):
    """The port's copies of build_ant / build_balance_bot, of the humanoid,
    anymal, kuka_allegro, shadow_hand and allegro_hand specs and of
    build_ingenuity / build_quadcopter give the JAX package's models (and
    rotor bodies) field by field."""
    if which in ("humanoid", "anymal", "kuka_allegro", "shadow_hand",
                 "allegro_hand"):
        import importlib
        from isaacgymenvs_ma_tpu.models.model import model_from_spec as jmfs
        from isaacgymenvs_ma_tpu_torch.models.model import model_from_spec
        jspec = importlib.import_module(
            f"isaacgymenvs_ma_tpu.models.specs.{which}").SPEC
        tspec = importlib.import_module(
            f"isaacgymenvs_ma_tpu_torch.models.specs.{which}").SPEC
        assert tspec == jspec
        _assert_models_equal(model_from_spec(tspec), jmfs(jspec))
    elif which in ("ingenuity", "quadcopter"):
        import importlib
        jb = getattr(importlib.import_module(
            f"isaacgymenvs_ma_tpu.tasks.{which}"), f"build_{which}")
        tb = getattr(importlib.import_module(
            f"isaacgymenvs_ma_tpu_torch.tasks.{which}"), f"build_{which}")
        (tm, trot), (jm, jrot) = tb(), jb()
        _assert_models_equal(tm, jm)
        assert list(trot) == list(jrot)
    elif which == "ant":
        from isaacgymenvs_ma_tpu.models.robots import build_ant as jbuild
        from isaacgymenvs_ma_tpu_torch.models.robots import build_ant as tbuild
        _assert_models_equal(tbuild(), jbuild())
    else:
        from isaacgymenvs_ma_tpu.tasks.ball_balance import (
            build_balance_bot as jbuild)
        from isaacgymenvs_ma_tpu_torch.tasks.ball_balance import (
            build_balance_bot as tbuild)
        (tm, tpair, tatt), (jm, jpair, jatt) = tbuild(), jbuild()
        _assert_models_equal(tm, jm)
        assert tpair == jpair
        for (tb, to, tg), (jb, jo, jg) in zip(tatt, jatt):
            assert tb == jb
            np.testing.assert_array_equal(to, jo)
            np.testing.assert_array_equal(tg, jg)


def test_ball_balance_engine_scene(bb):
    """The contact set the JAX engine builds: 13 ground rows and one pair
    row (the ball against the tray), three attractors, the static row masks
    and the row attribution."""
    je, te = bb["jt"].engine, bb["default"].engine
    assert (te.n_ground, te.n_pair_rows, len(te.attractors)) == (13, 1, 3)
    np.testing.assert_array_equal(te.row_masks_np, je._row_masks_np())
    np.testing.assert_array_equal(te.row_body_a, je.row_body_a)
    np.testing.assert_array_equal(te.row_body_b, je.row_body_b)
    assert te.cplan is None
    cp = bb["kernel"].engine.cplan
    assert (cp.P, cp.A, cp.G, cp.has_frames, cp.num_iterations) == (
        14, 3, 0, True, 16)


def test_ball_balance_state_roundtrip(bb):
    arrays = jax_state_arrays(bb["st"])
    ts = env_state_from_jax(arrays, "cpu")
    assert type(ts.task).__name__ == "BBTaskState"
    np.testing.assert_array_equal(ts.task.dof_position_targets.numpy(),
                                  arrays["task.dof_position_targets"])


def test_entry_points_default_to_cuda():
    """Without device="cpu" the port's entry points ask for the card and
    raise where there is none; they never run on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from isaacgymenvs_ma_tpu_torch.models.robots import build_ant
    from isaacgymenvs_ma_tpu_torch.physics.engine import SimParams
    from isaacgymenvs_ma_tpu_torch.tasks.franka_reach_ma import (
        FrankaReachMA, TASK_CFG as FCFG)
    for make in (lambda: BallBalance(deep_merge(TASK_CFG,
                                                {"env": {"numEnvs": 4}})),
                 lambda: Ant(deep_merge(ACFG, {"env": {"numEnvs": 4}})),
                 lambda: FrankaReachMA(deep_merge(FCFG,
                                                  {"env": {"numEnvs": 4}})),
                 lambda: PhysicsEngine(build_ant(), SimParams())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
