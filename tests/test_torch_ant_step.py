"""Port parity of the whole Ant step: isaacgymenvs_ma_tpu_torch's
``PhysicsEngine.step`` and ``Ant.step`` (CPU twins) against the JAX
``task.step`` on the same state, the same actions and the same reset draws.

The state is carried across with ``convert.env_state_from_jax``.  The JAX
reset draws are recomputed from its key chain (base.py:229, ant.py:138-141)
and injected into the port.

Tolerances (the JAX package's kernel-path parity bounds,
tests/test_dyn_kernel.py:128-136): q rtol 2e-4 / atol 2e-5, qd and obs 2e-3,
reset exact.  Reward at 2e-3 plus two float32 ulps of the potential: the
progress term is a difference of two potentials of ~6e4 (one ulp there is
3.9e-3), so a one-ulp difference in a potential shows in the reward.  The
contact-kernel route (``use_contact_kernel``: kernel B4's twin on the CPU)
is held against the JAX kernel route in interpret mode (a step recorded by
``scripts/record_torch_golden.py --route-step Ant``) at the same q, qd
and obs bounds (the JAX package's, tests/test_dyn_kernel.py:112-136), also
with ``contact_capacity`` or ``reuse_contact_rows`` set, which that route
ignores.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.tasks.ant import Ant as JAnt, TASK_CFG as JCFG
from isaacgymenvs_ma_tpu.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax
from isaacgymenvs_ma_tpu_torch.physics.engine import (
    Control, PhysicsEngine, SimParams, SimState)
from isaacgymenvs_ma_tpu_torch.tasks.ant import Ant, TASK_CFG
from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

ROUTE_STEP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                          "torch_port", "ant_route_step.npz")


def jax_state_arrays(st) -> dict:
    """A JAX Ant EnvState as the numpy dict convert.env_state_from_jax takes."""
    return {"sim.q": np.array(st.sim.q), "sim.qd": np.array(st.sim.qd),
            "progress": np.array(st.progress),
            "reset_buf": np.array(st.reset_buf),
            "task.potentials": np.array(st.task.potentials),
            "task.prev_potentials": np.array(st.task.prev_potentials),
            "task.actions": np.array(st.task.actions)}


def jax_reset_draws(st, n):
    """The draws the JAX Ant.step makes from ``st.rng`` for its resets."""
    k_reset = jax.random.split(st.rng, 6)[1]
    k1, k2 = jax.random.split(k_reset)
    return (np.array(jax.random.uniform(k1, (n, 8), minval=-0.2, maxval=0.2)),
            np.array(jax.random.uniform(k2, (n, 8), minval=-0.1, maxval=0.1)))


def _rew_atol(dt):
    return 2e-3 + 2 * float(np.spacing(np.float32(1000.0 / dt)))


@pytest.fixture(scope="module", params=[8, 128])
def ant_pair(request):
    n = request.param
    jt = JAnt(deep_merge(JCFG, {"env": {"numEnvs": n}}))
    tt = Ant(deep_merge(TASK_CFG, {"env": {"numEnvs": n}}), device="cpu")
    step = jax.jit(jt.step)
    st0 = jt.initial_state(jax.random.PRNGKey(11))
    rng = np.random.default_rng(n)
    acts = [rng.uniform(-1, 1, (n, 8)).astype(np.float32) for _ in range(6)]
    st = st0
    for a in acts[:5]:                    # generic state: legs on the ground
        st, _ = step(st, jnp.asarray(a))
    return jt, tt, step, st0, st, acts[5]


def _compare_step(jt, tt, step, st, acts, draws):
    st2, res = step(st, jnp.asarray(acts))
    ts = env_state_from_jax(jax_state_arrays(st), "cpu")
    ts2, tres = tt.step(ts, torch.as_tensor(acts), reset_draws=draws)
    np.testing.assert_allclose(ts2.sim.q.numpy(), np.asarray(st2.sim.q),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ts2.sim.qd.numpy(), np.asarray(st2.sim.qd),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tres.obs.numpy(), np.asarray(res.obs),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tres.rew.numpy(), np.asarray(res.rew),
                               rtol=2e-3, atol=_rew_atol(tt.dt))
    np.testing.assert_array_equal(tres.reset.numpy(), np.asarray(res.reset))
    np.testing.assert_array_equal(ts2.progress.numpy(),
                                  np.asarray(st2.progress))
    np.testing.assert_array_equal(tres.extras["time_outs"].numpy(),
                                  np.asarray(res.extras["time_outs"]))
    np.testing.assert_allclose(ts2.task.potentials.numpy(),
                               np.asarray(st2.task.potentials), rtol=1e-6)
    return res


def test_first_step_resets_every_env(ant_pair):
    """reset_buf starts at 1: step 1 resets every env after physics, with
    the JAX reset draws injected."""
    jt, tt, step, st0, _, acts = ant_pair
    n = tt.num_envs
    assert int(np.asarray(st0.reset_buf).min()) == 1
    draws = tuple(torch.as_tensor(d) for d in jax_reset_draws(st0, n))
    _compare_step(jt, tt, step, st0, acts, draws)


def test_step_without_resets(ant_pair):
    """A generic mid-episode state with reset_buf == 0: no draws needed."""
    jt, tt, step, _, st, acts = ant_pair
    st = st._replace(reset_buf=jnp.zeros_like(st.reset_buf))
    res = _compare_step(jt, tt, step, st, acts, None)
    # the feet are on the ground: the sensor readout is exercised
    assert float(np.abs(np.asarray(res.obs)[:, 28:52]).max()) > 0.1


def test_step_with_partial_resets(ant_pair):
    """Half the envs flagged for reset on a generic state."""
    jt, tt, step, _, st, acts = ant_pair
    n = tt.num_envs
    flags = (np.arange(n) % 2).astype(np.int32)
    st = st._replace(reset_buf=jnp.asarray(flags))
    draws = tuple(torch.as_tensor(d) for d in jax_reset_draws(st, n))
    _compare_step(jt, tt, step, st, acts, draws)


def test_engine_step_matches_jax(ant_pair):
    """PhysicsEngine.step alone: state and every SimOutput readout."""
    from isaacgymenvs_ma_tpu.physics.engine import (
        Control as JControl, SimState as JSimState)
    jt, tt, _, _, st, acts = ant_pair
    n = tt.num_envs
    tau = np.zeros((n, 14), np.float32)
    tau[:, 6:] = acts * 15.0
    jsim, jout = jax.jit(jt.engine.step)(
        JSimState(st.sim.q, st.sim.qd), JControl(tau=jnp.asarray(tau)))
    tsim, tout = tt.engine.step(
        SimState(torch.as_tensor(np.array(st.sim.q)),
                 torch.as_tensor(np.array(st.sim.qd))),
        Control(tau=torch.as_tensor(tau)))
    np.testing.assert_allclose(tsim.q.numpy(), np.asarray(jsim.q),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tsim.qd.numpy(), np.asarray(jsim.qd),
                               rtol=2e-3, atol=2e-3)
    for name in ("body_pos", "body_quat", "body_vel", "root_states"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=2e-3, atol=2e-3, err_msg=name)
    # forces are O(100 N): compare at the same relative bound
    for name in ("contact_force", "sensor_forces", "dof_force", "qdd"):
        ref = np.asarray(getattr(jout, name))
        np.testing.assert_allclose(
            getattr(tout, name).numpy(), ref, rtol=2e-3,
            atol=2e-3 * max(1.0, float(np.abs(ref).max())), err_msg=name)


@pytest.fixture(scope="module")
def ant_kernel_route():
    """The JAX kernel route in interpret mode, from the setup of the JAX
    package's test_full_step_parity_interpret (128 envs, PRNGKey(5) state,
    PRNGKey(6) actions) advanced 5 steps so that the feet are on the
    ground, with a quarter of the envs flagged to reset: the state, the
    actions, the reset draws and the JAX step's result, as
    ``scripts/record_torch_golden.py --route-step Ant`` recorded them into
    tests/data/torch_port/ant_route_step.npz (the interpreted step takes
    ~40-170 s on the CPU; the capture is read instead).  The reset draws
    recorded are the ones :func:`jax_reset_draws` makes from the state's
    key."""
    d = np.load(ROUTE_STEP)
    n = d["init_q"].shape[0]
    state = {"sim.q": d["init_q"], "sim.qd": d["init_qd"],
             "progress": d["init_progress"],
             "reset_buf": d["init_reset_buf"],
             **{f"task.{f}": d[f"init_{f}"]
                for f in ("potentials", "prev_potentials", "actions")}}
    draws = (torch.as_tensor(d["draw_0"]), torch.as_tensor(d["draw_1"]))
    return dict(n=n, state=state, acts=d["actions"], draws=draws,
                q=d["q"], qd=d["qd"], obs=d["obs"], reset=d["reset"])


def _port_kernel_route_step(ant_kernel_route, **overrides):
    r = ant_kernel_route
    cfg = deep_merge(TASK_CFG, {"env": {"numEnvs": r["n"]}})
    tt = Ant(cfg, device="cpu", sim_params=parse_sim_params(cfg["sim"])
             ._replace(use_contact_kernel=True, **overrides))
    return tt.step(env_state_from_jax(r["state"], "cpu"),
                   torch.as_tensor(r["acts"]), reset_draws=r["draws"])


def _assert_matches_jax_kernel_route(ant_kernel_route, ts2, tres):
    r = ant_kernel_route
    np.testing.assert_allclose(ts2.sim.q.numpy(), r["q"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ts2.sim.qd.numpy(), r["qd"],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tres.obs.numpy(), r["obs"],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(tres.reset.numpy(), r["reset"])


def test_ant_kernel_route_matches_jax_interpret(ant_kernel_route):
    """Ant with use_contact_kernel against the JAX kernel route in
    interpret mode (the ``ant_kernel_route`` setup), a quarter of the envs
    reset with the recorded draws."""
    r = ant_kernel_route
    assert r["n"] == 128
    assert (r["state"]["reset_buf"] == (np.arange(128) % 4 == 0)).all()
    ts2, tres = _port_kernel_route_step(ant_kernel_route)
    _assert_matches_jax_kernel_route(ant_kernel_route, ts2, tres)
    assert float(np.abs(r["obs"][:, 28:52]).max()) > 0.1


def test_route_step_capture_draws_match_jax_keys():
    """The capture's reset draws are the ones :func:`jax_reset_draws`
    makes from the key of the state the capture starts from (the
    ``PRNGKey(5)`` state advanced 5 steps; no step is run here)."""
    d = np.load(ROUTE_STEP)
    jt = JAnt(deep_merge(JCFG, {"env": {"numEnvs": 128}}))
    st = jt.initial_state(jax.random.PRNGKey(5))
    # the key chain: initial_state keeps its key; each step splits it
    key = st.rng
    for _ in range(5):
        key = jax.random.split(key, 6)[0]
    draws = jax_reset_draws(st._replace(rng=key), 128)
    np.testing.assert_array_equal(draws[0], d["draw_0"])
    np.testing.assert_array_equal(draws[1], d["draw_1"])


_KERNEL_ROUTE_OPTIONS = {"capacity": {"contact_capacity": 8},
                         "reuse": {"reuse_contact_rows": True},
                         "capacity_reuse": {"contact_capacity": 8,
                                            "reuse_contact_rows": True}}


@pytest.mark.parametrize("case", list(_KERNEL_ROUTE_OPTIONS))
def test_kernel_route_ignores_compaction_and_reuse(ant_kernel_route, case):
    """On the B4 route the JAX engine neither compacts nor reuses contact
    rows (engine.py:1304-1305, :1524, :1558): with ``contact_capacity``
    and/or ``reuse_contact_rows`` set, the port's step is the step without
    them, bit for bit, and matches the JAX kernel route in interpret mode
    at the bounds above.  Capacity 8 is below the 25 candidate rows, so on
    the batched-product loop it would compact."""
    ts2, tres = _port_kernel_route_step(ant_kernel_route,
                                        **_KERNEL_ROUTE_OPTIONS[case])
    ref, ref_res = _port_kernel_route_step(ant_kernel_route)
    assert torch.equal(ts2.sim.q, ref.sim.q)
    assert torch.equal(ts2.sim.qd, ref.sim.qd)
    assert torch.equal(tres.obs, ref_res.obs)
    _assert_matches_jax_kernel_route(ant_kernel_route, ts2, tres)


def test_env_state_from_jax_roundtrip(ant_pair):
    _, tt, _, _, st, _ = ant_pair
    arrays = jax_state_arrays(st)
    ts = env_state_from_jax(arrays, "cpu")
    assert ts.sim.q.dtype == torch.float32 and ts.progress.dtype == torch.int32
    np.testing.assert_array_equal(ts.sim.q.numpy(), arrays["sim.q"])
    np.testing.assert_array_equal(ts.task.actions.numpy(),
                                  arrays["task.actions"])
    with pytest.raises(KeyError):
        env_state_from_jax({**arrays, "task.other": arrays["progress"]}, "cpu")


def test_generator_reset_draws_are_seeded():
    """Without injected draws the reset draws come from the task's seeded
    generator: the same seed gives the same first step."""
    out = []
    for _ in range(2):
        t = Ant(deep_merge(TASK_CFG, {"env": {"numEnvs": 4}}), device="cpu",
                seed=5)
        st, _ = t.step(t.initial_state(), t.zero_actions())
        out.append(st.sim.q)
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
    assert torch.isfinite(out[0]).all()


_UNPORTED = [
    {"warm_start": 0.5}, {"solver_rows_bf16": True},
    {"terrain_normal_frames": True},
]


@pytest.mark.parametrize("override", _UNPORTED,
                         ids=[next(iter(o)) for o in _UNPORTED])
def test_unported_options_raise(override):
    """Options that raised until they were ported.  ``plane_restitution``
    raised until restitution was ported (test_plane_restitution_builds);
    contact warm start and bfloat16 solver rows until they were ported:
    now each builds, takes the loop, and steps on a terrain with finite
    results (their parity with the JAX engine is
    tests/test_torch_factory_engine.py's).  Terrain surface normals
    raised on the first step on a terrain until they were ported: now
    the engine steps on a terrain with them, on the loop (their parity is
    tests/test_torch_terrain.py's), and on a flat grid the normals are
    straight up, so the step equals the one without them."""
    from isaacgymenvs_ma_tpu.models.robots import build_ant
    from isaacgymenvs_ma_tpu_torch.physics.terrain import TerrainGrid
    params = SimParams(contact_margin=0.02)._replace(**override)
    flat = TerrainGrid(torch.zeros(4, 4), 1.0, (-2.0, -2.0))
    if "terrain_normal_frames" in override:
        eng = PhysicsEngine(build_ant(), params, device="cpu")
        plain = PhysicsEngine(build_ant(), SimParams(contact_margin=0.02),
                              device="cpu")
        assert eng.route_for(None, terrain=flat) == "loop"
        st, _ = eng.step(eng.default_state(2),
                         Control(tau=torch.zeros(2, 14)), terrain=flat)
        ref, _ = plain.step(plain.default_state(2),
                            Control(tau=torch.zeros(2, 14)), terrain=flat)
        assert torch.isfinite(st.q).all() and torch.isfinite(st.qd).all()
        torch.testing.assert_close(st.q, ref.q, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(st.qd, ref.qd, rtol=1e-5, atol=1e-5)
        return
    eng = PhysicsEngine(build_ant(), params, device="cpu")
    assert eng.contact_route == "loop"
    assert eng.rows_bf16 == ("solver_rows_bf16" in override)
    st, _ = eng.step(eng.default_state(2), Control(tau=torch.zeros(2, 14)),
                     terrain=flat)
    assert torch.isfinite(st.q).all() and torch.isfinite(st.qd).all()
    assert (st.lam is not None) == ("warm_start" in override)


def test_plane_restitution_builds():
    """``plane_restitution`` is ported: as in the JAX engine it enters only
    a ground row's coefficient when the call's physics scales carry a
    per-body restitution (engine.py:1411-1419), so alone it leaves the
    step unchanged, and with a per-body restitution it changes it."""
    from isaacgymenvs_ma_tpu.models.robots import build_ant
    from isaacgymenvs_ma_tpu_torch.utils.domain_rand import PhysScales
    params = SimParams(contact_margin=0.02)
    m = build_ant()
    plain = PhysicsEngine(m, params, device="cpu")
    bouncy = PhysicsEngine(m, params._replace(plane_restitution=0.5),
                           device="cpu")
    # the Ant's lowest point 1 mm over the plane, falling at 3 m/s
    q = plain.default_state(2).q.clone()
    bx, bq, _, _ = plain.kinematics(q)
    q[:, 2] -= float(plain._contact_rows(bx, bq, 2)[1].min()) - 1e-3
    st = SimState(q, torch.zeros(2, 14).index_fill(
        1, torch.tensor([2]), -3.0))
    ctrl = Control(tau=torch.zeros(2, 14))
    a, _ = plain.step(st, ctrl)
    b, _ = bouncy.step(st, ctrl)
    assert torch.equal(a.q, b.q) and torch.equal(a.qd, b.qd)
    phys = PhysScales.ones(2)._replace(restitution=torch.zeros(2, m.nb))
    a, _ = plain.step(st, ctrl, phys=phys)
    b, _ = bouncy.step(st, ctrl, phys=phys)
    assert float((b.qd - a.qd).abs().max()) > 1e-3


@pytest.mark.parametrize("kwargs", [{"ground": False},
                                    {"pair_specs": [(0, 1)], "sdf": True},
                                    {"ground": False,
                                     "attractors": [(0, (0, 0, 0), (0, 0, 1))]},
                                    {"grabs": [(0, (0, 0, 0), 1, (0, 0, 0))]}],
                         ids=["no_ground", "pairs", "attractors", "grabs"])
def test_unported_scene_features_raise(kwargs):
    """A scene with no contact rows at all (no ground, or only attractors,
    which the JAX engine then ignores) raised until the joint-limit solve
    was ported, grab constraints until they were, and SDF-grid pair
    targets until they were: now each builds (without B4's plan), and one
    step of the falling Ant with a hip pushed past its upper limit (and,
    with the grab, the torso's origin pinned to body 1's, live in every
    env; with the pair, geom 0's points against geom 1 made a baked box
    grid) matches the JAX engine's (q rtol 2e-4 / atol 2e-5, qd 2e-3)."""
    import dataclasses
    from isaacgymenvs_ma_tpu.models.model import GEOM_SDF
    from isaacgymenvs_ma_tpu.models.robots import build_ant
    from isaacgymenvs_ma_tpu.physics.engine import (
        Control as JControl, PhysicsEngine as JEngine,
        SimParams as JSimParams, SimState as JSimState)
    from isaacgymenvs_ma_tpu_torch.models import meshes
    from isaacgymenvs_ma_tpu_torch.native import voxelize_mesh
    m = build_ant()
    if kwargs.pop("sdf", False):
        v, t = meshes.box_mesh((0.1, 0.1, 0.1))
        lo, h = np.full(3, -0.15, np.float32), 0.02
        vals = voxelize_mesh(v, t, lo, np.full(3, h, np.float32),
                             np.array([16, 16, 16], np.int32))
        m.geoms[1] = dataclasses.replace(
            m.geoms[1], gtype=GEOM_SDF, sdf_values=vals,
            sdf_origin=lo.astype(np.float64), sdf_spacing=np.full(3, h))
    te = PhysicsEngine(m, SimParams(), device="cpu", **kwargs)
    grab = "grabs" in kwargs
    pairs = "pair_specs" in kwargs
    assert te.has_contact_rows == (grab or pairs) and te.cplan is None
    if pairs:
        assert te.pairs[0]["grid"] is not None
    je = JEngine(m, JSimParams(), **kwargs)
    n = 4
    q = np.array(je.default_state(n).q)
    q[:, 7] = float(m.dof_upper[6]) + 0.05
    qd = np.random.default_rng(1).normal(0, 1, (n, m.nv)).astype(np.float32)
    qd[:, 6] = 1.0                              # moving further out
    tau = np.zeros((n, m.nv), np.float32)
    act = np.ones((n, 1), np.float32) if grab else None
    js, _ = je.step(JSimState(jnp.asarray(q), jnp.asarray(qd)),
                    JControl(tau=jnp.asarray(tau),
                             grab_active=None if act is None
                             else jnp.asarray(act)))
    ts, _ = te.step(SimState(torch.as_tensor(q), torch.as_tensor(qd)),
                    Control(tau=torch.as_tensor(tau),
                            grab_active=None if act is None
                            else torch.as_tensor(act)))
    np.testing.assert_allclose(ts.q.numpy(), np.asarray(js.q), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(ts.qd.numpy(), np.asarray(js.qd), rtol=2e-3,
                               atol=2e-3)
    if not grab:
        assert (ts.qd.numpy()[:, 6] < 1.0).all()  # the limit row pushed back
        return
    # the live grab moved the Ant: the step differs from the one without
    free, _ = te.step(SimState(torch.as_tensor(q), torch.as_tensor(qd)),
                      Control(tau=torch.as_tensor(tau)))
    assert float((free.qd - ts.qd).abs().max()) > 0.1


def test_terrain_and_phys_raise():
    """Terrain surface normals (``terrain_normal_frames``) raised until
    they were ported: now the step on a flat grid with them runs.  Terrain
    heightfields, external wrenches and the mass, shape, friction, stiffness, damping, armature, effort,
    joint-friction and limit-shift scales raised until they were ported:
    now a zero wrench, unit scales and zero limit shifts leave the step
    unchanged (the wrench parity is tests/test_torch_aerial.py's, the
    terrain's tests/test_torch_terrain.py's, the scales'
    tests/test_torch_domain_rand.py's and tests/test_torch_mass_splitting.py's,
    the shifts' and restitution's tests/test_torch_restitution.py's)."""
    from isaacgymenvs_ma_tpu_torch.utils.domain_rand import PhysScales
    from isaacgymenvs_ma_tpu_torch.physics.engine import PhysicsEngine
    from isaacgymenvs_ma_tpu_torch.physics.terrain import TerrainGrid
    t = Ant(deep_merge(TASK_CFG, {"env": {"numEnvs": 4}}), device="cpu")
    st = t.initial_state()
    ctrl = t.pre_physics(st, t.zero_actions())
    flat = TerrainGrid(torch.zeros(4, 4), 1.0, (-2.0, -2.0))
    normals = PhysicsEngine(t.model, t.sim_params._replace(
        terrain_normal_frames=True), device="cpu")
    got, _ = normals.step(st.sim, ctrl, terrain=flat)
    assert torch.isfinite(got.q).all() and torch.isfinite(got.qd).all()
    ref, _ = t.engine.step(st.sim, ctrl)
    got, _ = t.engine.step(st.sim, ctrl, phys=PhysScales.ones(4))
    assert torch.equal(got.q, ref.q) and torch.equal(got.qd, ref.qd)
    zero = torch.zeros(4, 14)
    got, _ = t.engine.step(st.sim, ctrl, phys=PhysScales.ones(4)._replace(
        dof_lower_shift=zero, dof_upper_shift=zero))
    assert torch.equal(got.q, ref.q) and torch.equal(got.qd, ref.qd)
    one = torch.ones(4, 1)
    got, _ = t.engine.step(st.sim, ctrl, phys=PhysScales.ones(4)._replace(
        armature=one, effort=one))
    assert torch.equal(got.q, ref.q) and torch.equal(got.qd, ref.qd)
    got, _ = t.engine.step(st.sim, ctrl._replace(f_ext=torch.zeros(4, 9, 6)))
    assert torch.equal(got.q, ref.q) and torch.equal(got.qd, ref.qd)
    # grab activation is ported: a scene without grabs ignores it, as the
    # JAX engine does
    got, _ = t.engine.step(st.sim, ctrl._replace(grab_active=torch.ones(4, 1)))
    assert torch.equal(got.q, ref.q) and torch.equal(got.qd, ref.qd)


def test_domain_randomization_raises():
    """``task.randomize`` is ported (utils/domain_rand.py): Ant with a
    mass and friction spec steps with per-env scales, and an empty
    ``randomization_params`` leaves it unrandomized, as in the JAX
    package.  A restitution leaf of the scales raised until it was ported:
    now the step with it takes the loop and is finite (its parity with the
    JAX engine is tests/test_torch_restitution.py's)."""
    from isaacgymenvs_ma_tpu_torch.physics.engine import Control
    cfg = deep_merge(TASK_CFG, {"env": {"numEnvs": 4},
                                "task": {"randomize": True}})
    assert Ant(cfg, device="cpu").initial_state().phys is None
    params = {"actor_params": {"torso": {
        "rigid_body_properties": {"mass": {
            "range": [0.5, 1.5], "operation": "scaling",
            "distribution": "uniform", "setup_only": True}},
        "rigid_shape_properties": {"friction": {
            "range": [0.5, 1.5], "operation": "scaling",
            "distribution": "uniform"}}}}}
    cfg = deep_merge(TASK_CFG, {"env": {"numEnvs": 4}, "task": {
        "randomize": True, "randomization_params": params}})
    t = Ant(cfg, device="cpu")
    st = t.initial_state()
    assert st.phys.mass.shape == (4, 9) and (st.phys.mass != 1).all()
    st, res = t.step(st, torch.zeros(4, 8))
    assert torch.isfinite(res.obs).all() and (st.phys.friction != 1).all()
    phys = st.phys._replace(restitution=torch.ones(4, 1))
    assert t.engine.route_for(phys) == "loop"
    sim, _ = t.engine.step(st.sim, Control(tau=torch.zeros(4, 14)),
                           phys=phys)
    assert torch.isfinite(sim.q).all() and torch.isfinite(sim.qd).all()


@pytest.mark.parametrize("spec", ["shadow_hand", "franka_panda", "anymal"])
def test_ground_reachability_matches_jax(spec):
    """The numpy ground-candidate pruning against the JAX engine's, on a
    fixed-base hand (all 72 candidates pruned), a fixed-base arm and a
    floating base."""
    import importlib
    from isaacgymenvs_ma_tpu.models.model import model_from_spec
    from isaacgymenvs_ma_tpu.physics.engine import (
        PhysicsEngine as JEngine, SimParams as JParams)
    from isaacgymenvs_ma_tpu_torch.physics.engine import _ground_reachable
    m = model_from_spec(importlib.import_module(
        f"isaacgymenvs_ma_tpu.models.specs.{spec}").SPEC)
    je = JEngine(m, JParams())
    got = _ground_reachable(m, je.pts_body, np.asarray(je.pts_off),
                            np.asarray(je.pts_rad))
    np.testing.assert_array_equal(got, je._ground_reachable(m))
    np.testing.assert_array_equal(np.nonzero(got)[0], je.gnd_idx)
