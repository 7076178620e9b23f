"""Port parity of Cartpole and the contact-free engine path on the CPU.

isaacgymenvs_ma_tpu_torch's ``Cartpole`` and ``PhysicsEngine._limit_solve``
(plain twins of kernels B1-B3) against the JAX package on the same states,
actions and reset draws:

* the task step from seeded states (inside the limits, and with the cart
  past its +-4 m limit moving outward, so the limit rows are active), with
  no resets, with half the envs reset, and the first step that resets all:
  q rtol 2e-4 / atol 2e-5, qd, obs and reward 2e-3, resets exact (the
  tolerances of tests/test_dyn_kernel.py:128-136).  At 64 envs the JAX
  step runs its XLA path, where H^-1 is the closed-form 2x2 inverse and the
  port's twin sweeps, so the two round differently;
* the same step at 128 envs against the JAX kernel route in Pallas
  interpret mode, the only N at which the JAX engine takes its dynamics
  kernels on the CPU (dyn_kernel.py:375-383, ``_FORCE_INTERPRET`` read
  while tracing), at the same bounds;
* ``_limit_solve`` itself on the same qd, H^-1 and dof positions, with
  active lower and upper rows (rtol 1e-5, atol 1e-6: the same float32
  operations, the sum of H^-1 times the impulse change in another order);
  a scene without limits returns qd unchanged;
* the engine step of the contact-free scene with and without limits:
  contact forces and sensors zero, ``dof_force`` the applied effort;
* reward and reset of ``post_physics`` on states at and past each reset
  condition (exact up to one float32 rounding);
* the copied URDF parser (``models/urdf.py``) and model builder against
  the originals, field by field, on URDFs written here.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.models.urdf import load_urdf as jload_urdf
from isaacgymenvs_ma_tpu.physics import dyn_kernel as jdk
from isaacgymenvs_ma_tpu.physics.engine import (
    Control as JControl, PhysicsEngine as JEngine, SimParams as JSimParams,
    SimState as JSimState)
from isaacgymenvs_ma_tpu.tasks import cartpole as jcp
from isaacgymenvs_ma_tpu.utils.config import deep_merge as jdeep_merge
from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax
from isaacgymenvs_ma_tpu_torch.models.urdf import load_urdf
from isaacgymenvs_ma_tpu_torch.physics import dyn_kernel as dk
from isaacgymenvs_ma_tpu_torch.physics.engine import (
    Control, PhysicsEngine, SimParams, SimState)
from isaacgymenvs_ma_tpu_torch.tasks.cartpole import (
    Cartpole, TASK_CFG, build_cartpole_model)
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

torch.set_num_threads(1)   # small CPU ops: one thread a test worker


def _tasks(n):
    jt = jcp.Cartpole(jdeep_merge(jcp.TASK_CFG, {"env": {"numEnvs": n}}))
    tt = Cartpole(deep_merge(TASK_CFG, {"env": {"numEnvs": n}}),
                  device="cpu")
    return jt, tt


def seeded_state(n, seed, beyond_limits=False):
    """(q, qd) (n, 2): the cart anywhere inside +-3 m, the pole within
    +-1.2 rad, velocities N(0, 1.5); with ``beyond_limits`` every cart is
    0.05-0.5 m past the +-4 m limit of its side and moving outward."""
    g = np.random.default_rng(seed)
    q = np.stack([g.uniform(-3.0, 3.0, n), g.uniform(-1.2, 1.2, n)], -1)
    qd = g.normal(0.0, 1.5, (n, 2))
    if beyond_limits:
        side = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
        q[:, 0] = side * g.uniform(4.05, 4.5, n)
        qd[:, 0] = side * g.uniform(0.5, 3.0, n)
    return q.astype(np.float32), qd.astype(np.float32)


def jax_state(jt, q, qd, reset_buf, seed):
    n = q.shape[0]
    st = jt.initial_state(jax.random.PRNGKey(seed))
    return st._replace(
        sim=JSimState(jnp.asarray(q), jnp.asarray(qd)),
        reset_buf=jnp.asarray(reset_buf, jnp.int32),
        progress=jnp.asarray(np.arange(n) % 7, jnp.int32))


def port_state(st):
    return env_state_from_jax({"sim.q": np.array(st.sim.q),
                               "sim.qd": np.array(st.sim.qd),
                               "progress": np.array(st.progress),
                               "reset_buf": np.array(st.reset_buf)}, "cpu")


def jax_reset_draws(st, n):
    """The draws the JAX Cartpole.step makes from ``st.rng`` for its
    resets (base.py:229, cartpole.py:124-129)."""
    k_reset = jax.random.split(st.rng, 6)[1]
    k1, k2 = jax.random.split(k_reset)
    return (torch.as_tensor(np.array(
                0.2 * (jax.random.uniform(k1, (n, 2)) - 0.5))),
            torch.as_tensor(np.array(
                0.5 * (jax.random.uniform(k2, (n, 2)) - 0.5))))


def _assert_step_matches(st2, res, ts2, tres):
    np.testing.assert_allclose(ts2.sim.q.numpy(), np.asarray(st2.sim.q),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ts2.sim.qd.numpy(), np.asarray(st2.sim.qd),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tres.obs.numpy(), np.asarray(res.obs),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tres.rew.numpy(), np.asarray(res.rew),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(tres.reset.numpy(), np.asarray(res.reset))
    np.testing.assert_array_equal(ts2.progress.numpy(),
                                  np.asarray(st2.progress))
    np.testing.assert_array_equal(tres.extras["time_outs"].numpy(),
                                  np.asarray(res.extras["time_outs"]))


@pytest.fixture(scope="module")
def pair64():
    jt, tt = _tasks(64)
    return jt, tt, jax.jit(jt.step)


STEP_CASES = {"inside_no_resets": (False, "none"),
              "inside_half_reset": (False, "half"),
              "inside_first_step": (False, "all"),
              "beyond_limits_no_resets": (True, "none"),
              "beyond_limits_half_reset": (True, "half")}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_matches_jax(pair64, case):
    """One task step from a seeded state, the JAX reset draws injected."""
    jt, tt, step = pair64
    beyond, resets = STEP_CASES[case]
    n = tt.num_envs
    q, qd = seeded_state(n, 3 + len(case), beyond)
    flags = {"none": np.zeros(n), "half": np.arange(n) % 2,
             "all": np.ones(n)}[resets]
    st = jax_state(jt, q, qd, flags, seed=len(case))
    acts = np.random.default_rng(len(case)).uniform(
        -1, 1, (n, 1)).astype(np.float32)
    st2, res = step(st, jnp.asarray(acts))
    draws = jax_reset_draws(st, n) if flags.any() else None
    ts2, tres = tt.step(port_state(st), torch.as_tensor(acts),
                        reset_draws=draws)
    _assert_step_matches(st2, res, ts2, tres)
    if beyond:
        # the limit rows pushed the carts back: none moves further out
        moved = np.sign(q[:, 0]) * (np.asarray(st2.sim.q)[:, 0] - q[:, 0])
        assert (moved[flags == 0] < 0.05).all()


def test_kernel_route_step_matches_jax_interpret():
    """At 128 envs the JAX engine takes its dynamics kernels B1-B3 (Pallas
    interpret mode), with ``_limit_solve`` on the kernels' H^-1; the port's
    step (the same twins as at any N) matches it at the bounds above, from
    a state with active limit rows and a quarter of the envs reset."""
    n = 128
    jt, tt = _tasks(n)
    jdk._FORCE_INTERPRET = True
    try:
        assert jdk.supports(jt.engine, n, jnp.float32)
        assert jdk.fk_supports(jt.engine, n, jnp.float32)
        q, qd = seeded_state(n, 21, beyond_limits=True)
        q[: n // 2], qd[: n // 2] = seeded_state(n // 2, 22)
        st = jax_state(jt, q, qd, np.arange(n) % 4 == 0, seed=23)
        acts = np.random.default_rng(24).uniform(
            -1, 1, (n, 1)).astype(np.float32)
        st2, res = jt.step(st, jnp.asarray(acts))       # eager: interpret
    finally:
        jdk._FORCE_INTERPRET = False
    ts2, tres = tt.step(port_state(st), torch.as_tensor(acts),
                        reset_draws=jax_reset_draws(st, n))
    _assert_step_matches(st2, res, ts2, tres)


def _hinv(engine, q):
    """H^-1 (N, nv, nv) at positions q through the twins of B1 and B2, with
    the drive diagonal of one substep."""
    plan = engine.plan
    q_bl = torch.as_tensor(q).t().contiguous()
    bx, bq, S = dk._fk_motion_bl(plan, q_bl)
    zeros = torch.zeros((plan.nv, q.shape[0]))
    diag = (engine.dof_armature[:, None] + 0.0 * zeros).contiguous()
    _, hinv, _ = dk.dyn_full_bl(plan, plan.consts("cpu"), bx, bq, S, zeros,
                                zeros, diag)
    return hinv.permute(2, 0, 1).contiguous()


def _limited_engines(pole_limit):
    """The JAX and port engines of the Cartpole model, with the pole's
    hinge limited to +-``pole_limit`` rad where given."""
    models = [jcp.build_cartpole_model(), build_cartpole_model()]
    for m in models:
        if pole_limit is not None:
            m.dof_has_limit[1] = True
            m.dof_lower[1], m.dof_upper[1] = -pole_limit, pole_limit
    params = dict(dt=0.0166, substeps=2)
    return (JEngine(models[0], JSimParams(**params), ground=False),
            PhysicsEngine(models[1], SimParams(**params), ground=False,
                          device="cpu"))


@pytest.mark.parametrize("pole_limit", [None, 0.5],
                         ids=["cart_limited", "cart_and_pole_limited"])
def test_limit_solve_matches_jax_with_active_rows(pole_limit):
    """Carts past the upper and the lower limit, moving outward (and, with
    the pole limited as well, poles past +-0.5 rad: two coupled rows an
    env, so that every one of the four Jacobi sweeps counts): the port's
    sweeps give JAX's qd on the same qd, H^-1 and dof positions."""
    n = 32
    je, te = _limited_engines(pole_limit)
    q, qd = seeded_state(n, 5, beyond_limits=True)
    if pole_limit is not None:
        q[:, 1] = np.where(np.arange(n) % 3 == 0, -1.0, 1.0) * np.abs(q[:, 1])
        q[:, 1] = np.sign(q[:, 1]) * np.maximum(np.abs(q[:, 1]), 0.6)
    hinv = _hinv(te, q)
    qpos = torch.as_tensor(q) @ te.q_to_dof.T
    got = te._limit_solve(torch.as_tensor(qd), hinv, qpos)
    ref = je._limit_solve(jnp.asarray(qd), jnp.asarray(hinv.numpy()),
                          jnp.asarray(qpos.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    lo = q[:, 0] < -4.0
    assert lo.any() and (~lo).any()
    # every cart's outward velocity was cut by the limit rows
    outward = np.sign(q[:, 0]) * got.numpy()[:, 0]
    assert (outward < np.sign(q[:, 0]) * qd[:, 0]).all()


def test_limit_solve_without_limits_returns_qd():
    """A scene with no joint limit: ``_limit_solve`` returns qd itself, as
    the JAX engine does."""
    model = build_cartpole_model()
    model.dof_has_limit[:] = False
    eng = PhysicsEngine(model, SimParams(), ground=False, device="cpu")
    q, qd = seeded_state(8, 6, beyond_limits=True)
    qd_t = torch.as_tensor(qd)
    hinv = _hinv(eng, q)
    assert eng._limit_solve(qd_t, hinv, torch.as_tensor(q)) is qd_t


@pytest.mark.parametrize("limits", [True, False], ids=["limits", "no_limits"])
def test_engine_step_without_contact_rows_matches_jax(limits):
    """The contact-free engine step (both substeps: B2's twin, then B3's
    on the cached I_O and H^-1) and its readouts against the JAX engine:
    zero contact forces and sensors, ``dof_force`` the applied effort."""
    n = 16
    jm, tm = jcp.build_cartpole_model(), build_cartpole_model()
    if not limits:
        jm.dof_has_limit[:] = False
        tm.dof_has_limit[:] = False
    params = dict(dt=0.0166, substeps=2)
    je = JEngine(jm, JSimParams(**params), ground=False)
    te = PhysicsEngine(tm, SimParams(**params), ground=False, device="cpu")
    assert not te.has_contact_rows and te.cplan is None
    q, qd = seeded_state(n, 7, beyond_limits=True)
    tau = np.random.default_rng(8).normal(0, 50, (n, 2)).astype(np.float32)
    js, jout = je.step(JSimState(jnp.asarray(q), jnp.asarray(qd)),
                       JControl(tau=jnp.asarray(tau)))
    ts, tout = te.step(SimState(torch.as_tensor(q), torch.as_tensor(qd)),
                       Control(tau=torch.as_tensor(tau)))
    np.testing.assert_allclose(ts.q.numpy(), np.asarray(js.q), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(ts.qd.numpy(), np.asarray(js.qd), rtol=2e-3,
                               atol=2e-3)
    for name in ("body_pos", "body_quat", "body_vel", "root_states", "qdd"):
        np.testing.assert_allclose(getattr(tout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=2e-3, atol=2e-3, err_msg=name)
    assert not tout.contact_force.any()
    assert tout.contact_force.shape == (n, 3, 3)
    assert tout.sensor_forces.shape == (n, 0, 6)
    np.testing.assert_array_equal(tout.dof_force.numpy(),
                                  np.asarray(jout.dof_force))
    np.testing.assert_array_equal(tout.dof_force.numpy(), tau)


def test_reward_and_reset_match_jax():
    """``post_physics`` on states at and past each reset condition: the
    cart past resetDist, the pole past pi/2, the episode's last step."""
    n = 12
    jt, tt = _tasks(n)
    q = np.array([[0.0, 0.0], [3.0, 0.1], [3.01, 0.1], [-3.2, -0.3],
                  [0.5, np.pi / 2], [0.5, 1.5708], [-1.0, -1.6],
                  [2.0, 1.0], [0.1, -0.2], [0.0, 0.3], [-2.9, 1.5],
                  [1.0, -1.0]], np.float32)
    qd = np.random.default_rng(9).normal(0, 2, (n, 2)).astype(np.float32)
    st = jax_state(jt, q, qd, np.zeros(n), seed=10)
    st = st._replace(progress=jnp.asarray(
        [0, 498, 499, 3, 499, 0, 7, 499, 498, 500, 1, 2], jnp.int32))
    acts = jnp.zeros((n, 1))
    obs, _, rew, reset, _, _ = jt.post_physics(st, None, acts)
    tobs, _, trew, treset, _, _ = tt.post_physics(port_state(st), None,
                                                  torch.zeros((n, 1)))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(obs))
    np.testing.assert_allclose(trew.numpy(), np.asarray(rew), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(treset.numpy(), np.asarray(reset))
    assert 0 < int(np.asarray(reset).sum()) < n


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


CARTPOLE_URDF = """<?xml version="1.0"?>
<robot name="cartpole">
  <link name="slider">
    <visual><geometry><box size="0.03 8 0.03"/></geometry></visual>
  </link>
  <joint name="slider_to_cart" type="prismatic">
    <axis xyz="0 1 0"/>
    <origin xyz="0 0 0"/>
    <parent link="slider"/>
    <child link="cart"/>
    <limit effort="1000.0" lower="-4" upper="4" velocity="100"/>
  </joint>
  <link name="cart">
    <collision><geometry><box size="0.2 0.25 0.2"/></geometry></collision>
    <inertial><mass value="1"/></inertial>
  </link>
  <joint name="cart_to_pole" type="continuous">
    <axis xyz="1 0 0"/>
    <origin xyz="0.12 0 0"/>
    <parent link="cart"/>
    <child link="pole"/>
    <limit effort="1000.0" velocity="8"/>
  </joint>
  <link name="pole">
    <collision>
      <origin xyz="0 0 0.47"/>
      <geometry><box size="0.04 0.06 1.0"/></geometry>
    </collision>
    <inertial><origin xyz="0 0 0.47"/><mass value="1"/></inertial>
  </link>
</robot>
"""

# every element the parser reads: a floating base, revolute / continuous /
# prismatic / fixed joints with rpy origins, limits and damping, boxes,
# spheres, cylinders and a mesh, explicit and derived inertia
RICH_URDF = """<?xml version="1.0"?>
<robot name="rich">
  <link name="base">
    <collision><geometry><box size="0.4 0.3 0.1"/></geometry></collision>
    <inertial>
      <origin xyz="0.01 0 0" rpy="0 0 0.3"/>
      <mass value="3.0"/>
      <inertia ixx="0.05" iyy="0.06" izz="0.07" ixy="0.001" ixz="0" iyz="0.002"/>
    </inertial>
  </link>
  <joint name="hip" type="revolute">
    <origin xyz="0.2 0 0" rpy="0.1 0.2 0.3"/>
    <axis xyz="0 2 0"/>
    <parent link="base"/><child link="thigh"/>
    <limit effort="80" lower="-1.0" upper="0.5" velocity="12"/>
    <dynamics damping="0.4"/>
  </joint>
  <link name="thigh">
    <collision>
      <origin xyz="0 0 -0.15" rpy="0 0.5 0"/>
      <geometry><cylinder radius="0.03" length="0.3"/></geometry>
    </collision>
    <inertial><mass value="0.8"/></inertial>
  </link>
  <joint name="knee_mount" type="fixed">
    <origin xyz="0 0 -0.3" rpy="0 0 1.0"/>
    <parent link="thigh"/><child link="mount"/>
  </joint>
  <link name="mount">
    <collision><geometry><sphere radius="0.04"/></geometry></collision>
    <collision><geometry><mesh filename="knee.stl"/></geometry></collision>
    <inertial><mass value="0.2"/></inertial>
  </link>
  <joint name="knee" type="continuous">
    <axis xyz="1 0 0"/>
    <parent link="mount"/><child link="shin"/>
  </joint>
  <link name="shin">
    <collision><geometry><box size="0.05 0.05 0.3"/></geometry></collision>
    <inertial><mass value="0.5"/></inertial>
  </link>
  <joint name="slide" type="prismatic">
    <origin xyz="0 0.1 0"/>
    <axis xyz="0 0 1"/>
    <parent link="base"/><child link="rail"/>
    <limit effort="30" lower="-0.1" upper="0.2" velocity="1"/>
  </joint>
  <link name="rail">
    <inertial><mass value="0.1"/></inertial>
  </link>
</robot>
"""


@pytest.mark.parametrize("case", ["cartpole_asset", "rich", "rich_collapsed"])
def test_copied_urdf_matches_jax(tmp_path, case):
    """The port's copy of ``models/urdf.py`` builds the JAX package's
    SceneModel field by field, from a file and from text; the Cartpole
    task with ``env.asset.assetFileName`` builds the same model in both
    packages."""
    if case == "cartpole_asset":
        (tmp_path / "cartpole.urdf").write_text(CARTPOLE_URDF)
        asset = {"asset": {"assetRoot": str(tmp_path),
                           "assetFileName": "cartpole.urdf"}}
        jt = jcp.Cartpole(jdeep_merge(jcp.TASK_CFG, {"env": {
            "numEnvs": 4, **asset}}))
        tt = Cartpole(deep_merge(TASK_CFG, {"env": {"numEnvs": 4, **asset}}),
                      device="cpu")
        _assert_models_equal(tt.model, jt.model)
        assert tt.engine.nv == 2 and not tt.engine.has_contact_rows
        return
    path = tmp_path / "rich.urdf"
    path.write_text(RICH_URDF)
    kw = (dict(collapse_fixed=True, cylinders_as_capsules=True,
               base_pos=(0.0, 0.0, 0.6), base_quat=(0.0, 0.0, 0.6, 0.8))
          if case == "rich_collapsed" else {})
    _assert_models_equal(load_urdf(str(path), **kw),
                         jload_urdf(str(path), **kw))
    _assert_models_equal(load_urdf(RICH_URDF, **kw), jload_urdf(RICH_URDF, **kw))


def test_copied_cartpole_builder_matches_jax():
    _assert_models_equal(build_cartpole_model(), jcp.build_cartpole_model())
