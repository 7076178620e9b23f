"""Port parity of Humanoid (isaacgymenvs_ma_tpu_torch/tasks/humanoid.py)
against the JAX package, on the CPU.

Nothing here jits a JAX step: the state is the warmed-up initial state of
the committed JAX capture (tests/data/torch_port/humanoid_golden.npz, 32
envs, its feet on the ground; replayed whole in tests/test_torch_golden.py)
and the JAX pieces run eagerly on it.  Tolerances, each with its reason:

* The scene, the gear-by-dof efforts, ``pre_physics`` and the resets with
  injected draws: exact.
* ``post_physics`` on the same readouts: rtol 1e-5 / atol 1e-5 (the same
  float32 expressions; atan2 and norms may round one ulp apart), the
  reward at atol 1e-2: its progress term is a difference of two ~6e4
  potentials, which differ by a float32 ulp (3.9e-3) when the torso
  position rounds otherwise (ROADMAP C4).
* One engine step (compaction to 16 of 35 rows; the B4 route solves all
  35): the ROADMAP's q rtol 2e-4 / atol 2e-5, qd 2e-3.
* The kernel twins against the JAX kernel bodies on Humanoid's scene (one
  27-dof block of H): the JAX package's own kernel-parity bounds
  (tests/test_dyn_kernel.py), and B4's twin against ``solve_bl`` at
  rtol = atol = 1e-4 (tests/test_torch_contact_kernel.py).
"""
import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.physics import contact_kernel as jck
from isaacgymenvs_ma_tpu.physics import dyn_kernel as jdk
from isaacgymenvs_ma_tpu.physics.engine import SimState as JSimState
from isaacgymenvs_ma_tpu.tasks import humanoid as jhum
from isaacgymenvs_ma_tpu.tasks.base import EnvState as JEnvState
from isaacgymenvs_ma_tpu.utils.config import deep_merge as jdeep_merge
from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax
from isaacgymenvs_ma_tpu_torch.physics import contact_kernel as ck
from isaacgymenvs_ma_tpu_torch.physics import dyn_kernel as tdk
from isaacgymenvs_ma_tpu_torch.physics.engine import SimOutput
from isaacgymenvs_ma_tpu_torch.tasks import humanoid as hum
from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
from test_torch_franka_reach_ma import _assert_models_equal

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
N = 32
Q_TOL = dict(rtol=2e-4, atol=2e-5)
QD_TOL = dict(rtol=2e-3, atol=2e-3)


def load_pair(jmod, tcls, fname, n=N):
    """The JAX and the port task at ``n`` envs, the port task again on the
    B4 route, and the capture's initial state in both packages' types."""
    d = np.load(os.path.join(DATA, fname))
    cfg = {"env": {"numEnvs": n}}
    jt = getattr(jmod, tcls.__name__)(jdeep_merge(jmod.TASK_CFG, cfg))
    tt = tcls(deep_merge(jmod.TASK_CFG, cfg), device="cpu")
    params = parse_sim_params(jmod.TASK_CFG["sim"])._replace(
        use_contact_kernel=True)
    tb4 = tcls(deep_merge(jmod.TASK_CFG, cfg), device="cpu",
               sim_params=params)
    state_cls = type(tt.initial_task_state())
    fields = state_cls._fields
    jtask = type(jt.initial_task_state())(
        *(jnp.asarray(d[f"init_{f}"]) for f in fields))
    jst = JEnvState(
        sim=JSimState(jnp.asarray(d["init_q"]), jnp.asarray(d["init_qd"])),
        progress=jnp.asarray(d["init_progress"]),
        reset_buf=jnp.asarray(d["init_reset_buf"]),
        rng=jax.random.PRNGKey(7), task=jtask)
    arrays = {"sim.q": d["init_q"], "sim.qd": d["init_qd"],
              "progress": d["init_progress"],
              "reset_buf": d["init_reset_buf"]}
    arrays.update({f"task.{f}": d[f"init_{f}"] for f in fields})
    tst = env_state_from_jax(arrays, "cpu", state_cls)
    return dict(jt=jt, tt=tt, tb4=tb4, jst=jst, tst=tst, d=d)


def to_torch(x):
    """A JAX pytree leaf (or a NamedTuple of them) as CPU tensors."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_torch(v) for v in x))
    return None if x is None else torch.as_tensor(np.array(x))


def port_out(jout):
    """A JAX ``SimOutput`` as the port's."""
    return SimOutput(*(to_torch(v) for v in jout))


def assert_engine_scene_matches(jt, tt):
    """The model field by field and the engine's candidate rows, masks,
    attribution and sensors equal the JAX package's."""
    _assert_models_equal(tt.model, jt.model)
    je, e = jt.engine, tt.engine
    assert (e.n_ground, e.n_pair_rows) == (je.n_ground, je.n_pair_rows)
    if e.n_ground or e.pairs:
        np.testing.assert_array_equal(e.gnd_body, je.gnd_body)
        np.testing.assert_array_equal(e.row_masks_np, je._row_masks_np())
        np.testing.assert_array_equal(e.row_body_a, je.row_body_a)
    np.testing.assert_array_equal(e.sensor_body, np.asarray(je.sensor_body))
    np.testing.assert_array_equal(e.scalar_dofs, je.scalar_dofs)


def compare_engine_step(pair, jctrl, tctrl, terrain=(None, None),
                        kernel_route=False):
    """One engine step of both packages from the capture's state (the port
    on its default loop or its B4 route), held at the ROADMAP bounds;
    returns the JAX (state, out)."""
    jt = pair["jt"]
    tt = pair["tb4"] if kernel_route else pair["tt"]
    js, jo = jt.engine.step(pair["jst"].sim, jctrl, terrain=terrain[0])
    ts, to = tt.engine.step(pair["tst"].sim, tctrl, terrain=terrain[1])
    np.testing.assert_allclose(ts.q.numpy(), np.asarray(js.q), **Q_TOL)
    np.testing.assert_allclose(ts.qd.numpy(), np.asarray(js.qd), **QD_TOL)
    np.testing.assert_allclose(to.contact_force.numpy(),
                               np.asarray(jo.contact_force), rtol=2e-3,
                               atol=2e-3 * float(np.abs(np.asarray(
                                   jo.contact_force)).max()))
    return js, jo


def capture_b4_inputs(tt, sim, ctrl, terrain=None):
    """The batch-last arguments the port's B4 route hands ``solve_bl`` in
    the first substep of one engine step from ``sim``."""
    box = []
    twin = ck.solve_bl

    def spy(plan, *a, **k):
        box.append((plan, a, k))
        return twin(plan, *a, **k)

    ck.solve_bl = spy
    try:
        tt.engine.step(sim, ctrl, terrain=terrain)
    finally:
        ck.solve_bl = twin
    return box[0]


def compare_b4_twin(call):
    """B4's twin against the JAX kernel body ``solve_bl`` on the inputs the
    port's B4 route hands it; the contact rows must carry impulses."""
    plan, (S, Hinv), k = call
    order = ("qd", "pts_c", "b_n", "mu", "active", "frames", "w_c", "b_lo",
             "b_hi", "act_lo", "act_hi", "pts_a", "b_a", "w_a", "pts_g",
             "b_g", "g_act", "w_g")
    jx = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa: E731
    ref = jck.solve_bl(
        SimpleNamespace(relaxation=plan.relaxation,
                        num_iterations=plan.num_iterations),
        jx(S), jx(Hinv), jx(k["qd"]),
        {g: jnp.asarray(m) for g, m in plan.masks.items()},
        *(jx(k.get(n)) for n in order[1:]))
    got = ck.solve_bl(plan, S, Hinv, **k)
    for name, a, b in zip(("qd", "lam", "imp_dof"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert float(np.abs(np.asarray(ref[1])).max()) > 0.01   # rows are live
    return plan


@pytest.fixture(scope="module")
def hp():
    return load_pair(jhum, hum.Humanoid, "humanoid_golden.npz")


def test_humanoid_scene_matches_jax(hp):
    """25 bodies (3 of them FIXED), nq 28 / nv 27, 35 ground candidate
    rows, two foot force sensors; the per-dof motor efforts, limits and
    initial dof positions; H is one 27-dof block."""
    jt, tt = hp["jt"], hp["tt"]
    e = tt.engine
    assert (e.nb, e.nq, e.nv, e.n_ground) == (25, 28, 27, 35)
    assert_engine_scene_matches(jt, tt)
    assert [tt.model.body_names[b] for b in e.sensor_body] == [
        "right_foot", "left_foot"]
    np.testing.assert_array_equal(tt.motor_efforts.numpy(),
                                  np.asarray(jt.motor_efforts))
    np.testing.assert_array_equal(tt.motor_effort_ratio.numpy(),
                                  np.asarray(jt.motor_effort_ratio))
    for name in ("dof_lower", "dof_upper", "initial_dof_pos"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    assert e.plan.blocks == [list(range(27))]
    assert tt.sim_params.contact_capacity == 16 and e.cplan is None
    cp = hp["tb4"].engine.cplan
    assert (cp.P, cp.A, cp.G, cp.nv, cp.has_frames) == (35, 0, 0, 27, False)
    assert (tt.num_obs, tt.num_actions) == (108, 21)


def test_pre_physics_matches_jax(hp):
    a = hp["d"]["actions"][0]
    ref = hp["jt"].pre_physics(hp["jst"], jnp.asarray(a))
    got = hp["tt"].pre_physics(hp["tst"], torch.as_tensor(a))
    np.testing.assert_array_equal(got.tau.numpy(), np.asarray(ref.tau))
    assert got.f_ext is None and got.pos_target is None


def test_reset_idx_matches_jax(hp):
    """Half the envs reset with the JAX draws injected: dof positions
    clipped into their limits, velocities, the root pose and the
    potentials exactly."""
    jt, tt = hp["jt"], hp["tt"]
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    draws = (jax.random.uniform(k1, (N, 21), minval=-0.2, maxval=0.2),
             jax.random.uniform(k2, (N, 21), minval=-0.1, maxval=0.1))
    mask = np.arange(N) % 2 == 0
    jsim, jtask = jt.reset_idx(hp["jst"].sim, hp["jst"].task,
                               jnp.asarray(mask), key)
    tsim, ttask = tt.reset_idx(hp["tst"].sim, hp["tst"].task,
                               torch.as_tensor(mask),
                               tuple(to_torch(x) for x in draws))
    np.testing.assert_array_equal(tsim.q.numpy(), np.asarray(jsim.q))
    np.testing.assert_array_equal(tsim.qd.numpy(), np.asarray(jsim.qd))
    for f in jtask._fields:
        np.testing.assert_array_equal(getattr(ttask, f).numpy(),
                                      np.asarray(getattr(jtask, f)),
                                      err_msg=f)


def test_post_physics_matches_jax(hp):
    """``post_physics`` on the readout of one JAX engine step (contact
    forces on the feet sensors, dof forces), some envs at the episode's
    last step: obs, reward, resets and the task state."""
    jt, tt, d = hp["jt"], hp["tt"], hp["d"]
    a = jnp.asarray(d["actions"][0])
    _, jout = jt.engine.step(hp["jst"].sim, jt.pre_physics(hp["jst"], a))
    prog = np.where(np.arange(N) % 5 == 0, 999, 7).astype(np.int32)
    jst = hp["jst"]._replace(progress=jnp.asarray(prog))
    tst = hp["tst"]._replace(progress=torch.as_tensor(prog))
    ref = jt.post_physics(jst, jout, a)
    got = tt.post_physics(tst, port_out(jout), torch.as_tensor(d["actions"][0]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5,
                               atol=1e-5, err_msg="obs")
    assert float(np.abs(np.asarray(ref[0])[:, 54:66]).max()) > 0.1  # feet
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-5,
                               atol=1e-2, err_msg="rew")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert np.asarray(ref[3]).any()
    for f in ref[4]._fields:
        np.testing.assert_allclose(getattr(got[4], f).numpy(),
                                   np.asarray(getattr(ref[4], f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(got[5]["true_objective"].numpy(),
                               np.asarray(ref[5]["true_objective"]))


@pytest.mark.parametrize("kernel_route", [False, True],
                         ids=["default_loop", "contact_kernel"])
def test_engine_step_matches_jax(hp, kernel_route):
    """One step from the capture's state with its first actions: the JAX
    default path (16 of 35 rows per env) against the port's default loop
    (the same compaction) and its B4 route (all 35 rows through B4's
    twin)."""
    a = hp["d"]["actions"][0]
    jctrl = hp["jt"].pre_physics(hp["jst"], jnp.asarray(a))
    tctrl = hp["tt"].pre_physics(hp["tst"], torch.as_tensor(a))
    _, jo = compare_engine_step(hp, jctrl, tctrl, kernel_route=kernel_route)
    assert float(np.abs(np.asarray(jo.contact_force)).max()) > 10.0


def test_b4_twin_matches_jax_on_humanoid_plan(hp):
    """B4's twin on the inputs the B4 route hands it at Humanoid (P 35,
    nv 27, no frames) against the JAX ``solve_bl``."""
    a = torch.as_tensor(hp["d"]["actions"][0])
    call = capture_b4_inputs(hp["tb4"], hp["tst"].sim,
                             hp["tb4"].pre_physics(hp["tst"], a))
    plan = compare_b4_twin(call)
    assert (plan.P, plan.nv) == (35, 27)


def _bl(x):
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), 0, -1))


@pytest.mark.parametrize("chain", ["fk_motion", "dyn_forward", "dyn_cached"])
def test_kernel_twins_match_jax_on_humanoid(hp, chain):
    """B1-B3's twins at Humanoid's shapes (25 bodies, one 27-dof block of
    H swept whole) on the capture's state with seeded qd and rhs, against
    the JAX kernel bodies."""
    jt, tt, d = hp["jt"], hp["tt"], hp["d"]
    g = np.random.default_rng(4)
    q = d["init_q"]
    qd = (d["init_qd"] + g.normal(0, 0.5, d["init_qd"].shape)).astype(
        np.float32)
    rhs = g.normal(0, 20, qd.shape).astype(np.float32)
    diag = np.broadcast_to(np.asarray(jt.engine.dof_armature) + 0.1,
                           qd.shape).astype(np.float32)
    plan_j = jdk.get_plan(jt.engine)
    consts = {k: jnp.asarray(v) for k, v in plan_j.consts().items()}
    jfk = jdk._fk_motion_bl(jt.engine, plan_j, jnp.asarray(_bl(q)))
    tfk = tdk._fk_motion_bl(tt.engine.plan, torch.as_tensor(_bl(q)))
    if chain == "fk_motion":
        for r, t in zip(jfk, tfk, strict=True):
            np.testing.assert_allclose(t.numpy(), np.asarray(r), atol=1e-5,
                                       rtol=1e-5)
        return
    args = (*jfk, jnp.asarray(_bl(qd)), jnp.asarray(_bl(rhs)),
            jnp.asarray(_bl(diag)))
    targs = tuple(torch.as_tensor(np.array(x)) for x in args)
    ref = jdk.dyn_full_bl(plan_j, consts, *args)
    if chain == "dyn_forward":
        got = tdk.dyn_forward(tt.engine.plan, *targs)
        for name, r, t, tol in zip(("qdd", "Hinv", "I_O"), ref, got,
                                   ((2e-4, 2e-4), (2e-4, 1e-5),
                                    (1e-5, 1e-5))):
            np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=tol[0],
                                       atol=tol[1], err_msg=name)
        return
    fg = jt.engine.gravity_wrench(*(jnp.moveaxis(x, -1, 0) for x in jfk[:2]))
    fg = jnp.moveaxis(fg, 0, -1)
    ref_c = jdk.dyn_cached_bl(plan_j, consts, args[2], args[3], args[4],
                              ref[2], ref[1], fg)
    got_c = tdk.dyn_cached(tt.engine.plan, targs[2], targs[3], targs[4],
                           to_torch(ref[2]), to_torch(ref[1]), to_torch(fg))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=2e-4,
                               atol=2e-4)


def test_humanoid_steps_on_its_entry_points():
    """``registry.create_task`` and ``api.make`` build Humanoid on the CPU
    when asked; two steps of random actions stay finite."""
    from isaacgymenvs_ma_tpu_torch import api
    task = api.make(seed=1, task="Humanoid", num_envs=8, sim_device="cpu")
    assert isinstance(task, hum.Humanoid) and task.device.type == "cpu"
    st = task.initial_state()
    for _ in range(2):
        st, res = task.step(st, torch.tanh(torch.randn(8, 21)))
    assert res.obs.shape == (8, 108) and torch.isfinite(res.obs).all()
