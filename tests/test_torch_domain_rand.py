"""Port parity of the domain randomization
(isaacgymenvs_ma_tpu_torch/utils/domain_rand.py and the per-env physics
scales through the engine) against the JAX package.

* ``convert.phys_from_jax`` carries the JAX ``PhysScales`` leaves over.
* ``PhysicsEngine.step(..., phys=)`` at Ant's and Trifinger's scenes (128
  envs, 6 steps into a seeded run; the first 32 envs are stepped here)
  with seeded scales (mass 0.6-1.5 and
  shape 0.7-1.4 per body as tests/test_dyn_kernel.py:86, damping and
  stiffness 0.5-1.5 per env, friction 0.5-1.5 per body), without and with
  the shape scales: on the batched-product loop against the JAX engine
  stepped here, on the B4 route against the JAX kernel route recorded in
  Pallas interpret mode (tests/data/torch_port/phys_step_b4.npz, from
  ``scripts/record_torch_golden.py --phys-step``).  Ground-rule bounds: q
  rtol 2e-4 / atol 2e-5, qd 2e-3.
* Kernel B2's twin with mass and shape scales, and B3's with the scaled
  gravity wrench, against the JAX kernel bodies at the new scenes.
* The sampler: white noise and scale samples cannot match ``jax.random``
  bit for bit, so their distributions (mean, std and range of each spec,
  with schedules) are held against the JAX sampler's with seeded
  statistical bounds (five standard errors); everything downstream of the
  draws (correlated terms, noise application, the masked resample) is held
  exactly on the same draws.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.physics import dyn_kernel as jdk
from isaacgymenvs_ma_tpu.physics.engine import (Control as JControl,
                                                SimState as JSimState)
from isaacgymenvs_ma_tpu.utils import domain_rand as jdr
from isaacgymenvs_ma_tpu.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax, phys_from_jax
from isaacgymenvs_ma_tpu_torch.physics import dyn_kernel as tdk
from isaacgymenvs_ma_tpu_torch.physics.engine import Control, SimState
from isaacgymenvs_ma_tpu_torch.tasks import registry
from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
from isaacgymenvs_ma_tpu_torch.utils import domain_rand as tdr

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
PHYS_STEP = os.path.join(DATA, "phys_step_b4.npz")
# the first envs of the 128-env capture the engine tests step: each env's
# step is independent of the others, and the JAX kernel route needed
# N % 128 == 0 only to run
N_STEP = 32
TRIFINGER_DR = registry.task_default_config("Trifinger")["task"][
    "randomization_params"]


def _jax_task(name, n):
    import importlib
    mod = {"Ant": "ant", "Trifinger": "trifinger", "FrankaReach":
           "franka_reach", "FrankaCabinet": "franka_cabinet",
           "FrankaCubeStack": "franka_cube_stack"}[name]
    m = importlib.import_module(f"isaacgymenvs_ma_tpu.tasks.{mod}")
    return getattr(m, name)(deep_merge(m.TASK_CFG, {"env": {"numEnvs": n}}))


def _port_task(name, n, kernel_route=False):
    cfg = deep_merge(registry.task_default_config(name),
                     {"env": {"numEnvs": n}})
    params = parse_sim_params(cfg["sim"])._replace(
        use_contact_kernel=kernel_route)
    return registry.task_class(name)(cfg, device="cpu", sim_params=params)


def _leaves(d, name, case):
    return {k[len(f"{name}_phys_"):]: d[k] for k in d
            if k.startswith(f"{name}_phys_")
            and (case == "shape" or not k.endswith("_shape"))}


# ---------------------------------------------------------------- convert
def test_phys_from_jax_carries_every_leaf():
    g = np.random.default_rng(0)
    leaves = {"mass": g.uniform(0.5, 1.5, (4, 11)),
              "damping": np.ones((4, 1)), "stiffness": np.ones((4, 1)),
              "friction": g.uniform(0.5, 1.5, (4, 1)),
              "shape": g.uniform(0.9, 1.1, (4, 11, 3)),
              "act_corr": g.normal(size=(4, 9))}
    jp = jdr.PhysScales(**{k: jnp.asarray(v, jnp.float32)
                           for k, v in leaves.items()})
    tp = phys_from_jax({k: np.asarray(v) for k, v in jp._asdict().items()
                        if v is not None}, "cpu")
    for k, v in jp._asdict().items():
        got = getattr(tp, k)
        if v is None:
            assert got is None, k
        else:
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(v))
    with pytest.raises(KeyError):
        phys_from_jax({"massx": np.ones((4, 1))}, "cpu")
    st = env_state_from_jax({"sim.q": np.zeros((4, 3)),
                             "sim.qd": np.zeros((4, 2)),
                             "progress": np.zeros(4, np.int32),
                             "reset_buf": np.zeros(4, np.int32),
                             **{f"phys.{k}": v for k, v in leaves.items()}},
                            "cpu")
    np.testing.assert_array_equal(st.phys.shape.numpy(),
                                  leaves["shape"].astype(np.float32))
    assert st.phys.obs_corr is None


# ------------------------------------------------------- the engine step
@pytest.fixture(scope="module")
def phys_step():
    """The capture's arrays, each cut to its first N_STEP envs."""
    d = np.load(PHYS_STEP)
    assert d["Ant_q"].shape[0] == 128
    return {k: d[k][:N_STEP] for k in d.files}


@pytest.fixture(scope="module")
def jax_loop_steps(phys_step):
    """The JAX engine's batched-loop step with the scales, per scene and
    case, run here (one JAX scene per task)."""
    d, out = phys_step, {}
    for name in ("Ant", "Trifinger"):
        jt = _jax_task(name, N_STEP)
        step = jt.engine.step            # eager: cheaper here than a jit
        for case in ("noshape", "shape"):
            phys = jdr.PhysScales(**{k: jnp.asarray(v) for k, v in
                                     _leaves(d, name, case).items()})
            sim, _ = step(JSimState(jnp.asarray(d[f"{name}_q"]),
                                    jnp.asarray(d[f"{name}_qd"])),
                          JControl(tau=jnp.asarray(d[f"{name}_tau"])),
                          phys=phys)
            out[name, case] = (np.asarray(sim.q), np.asarray(sim.qd))
    return out


@pytest.mark.parametrize("route", ["loop", "b4"])
@pytest.mark.parametrize("case", ["noshape", "shape"])
@pytest.mark.parametrize("name", ["Ant", "Trifinger"])
def test_engine_step_with_scales_matches_jax(phys_step, jax_loop_steps,
                                             name, case, route):
    """The port's engine step with injected JAX PhysScales against the
    JAX engine's, on the batched-product loop and (against the recorded
    JAX kernel route) on B4, at the ground-rule bounds; the scales move
    the step well beyond those bounds, so they are applied."""
    d = phys_step
    tt = _port_task(name, N_STEP, kernel_route=route == "b4")
    sim0 = SimState(torch.as_tensor(d[f"{name}_q"]),
                    torch.as_tensor(d[f"{name}_qd"]))
    ctrl = Control(tau=torch.as_tensor(d[f"{name}_tau"]))
    got, _ = tt.engine.step(sim0, ctrl,
                            phys=phys_from_jax(_leaves(d, name, case), "cpu"))
    if route == "b4":
        ref_q, ref_qd = d[f"{name}_{case}_q"], d[f"{name}_{case}_qd"]
    else:
        ref_q, ref_qd = jax_loop_steps[name, case]
    np.testing.assert_allclose(got.q.numpy(), ref_q, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.qd.numpy(), ref_qd, rtol=2e-3, atol=2e-3)
    nominal, _ = tt.engine.step(sim0, ctrl)
    assert float((nominal.qd - got.qd).abs().max()) > 0.05


def test_unit_scales_leave_the_step_unchanged(phys_step):
    """PhysScales.ones gives the nominal step bit for bit, on both
    routes."""
    d = phys_step
    for route in (False, True):
        tt = _port_task("Trifinger", 16, kernel_route=route)
        sim0 = SimState(torch.as_tensor(d["Trifinger_q"][:16]),
                        torch.as_tensor(d["Trifinger_qd"][:16]))
        ctrl = Control(tau=torch.as_tensor(d["Trifinger_tau"][:16]))
        ref, _ = tt.engine.step(sim0, ctrl)
        got, _ = tt.engine.step(sim0, ctrl, phys=tdr.PhysScales.ones(16))
        assert torch.equal(got.q, ref.q) and torch.equal(got.qd, ref.qd)


@pytest.mark.parametrize("leaf", ["dof_lower_shift", "dof_upper_shift",
                                  "restitution"])
def test_unported_scale_leaves_raise(leaf):
    """The limit-shift and restitution leaves raised until ROADMAP queue A
    item 7c ported them: now an Ant engine step from the warmed-up state
    of ant_golden.npz (feet on the ground) with the leaf set (a shift of
    0.3 rad on every dof, the lower limit raised or the upper lowered, or
    restitution 0.5) is finite and differs from the step without it.  Its
    parity with the JAX engine is tests/test_torch_restitution.py's."""
    n = 4
    tt = _port_task("Ant", n)
    d = np.load(os.path.join(DATA, "ant_golden.npz"))
    sim0 = SimState(torch.as_tensor(d["init_q"][:n]),
                    torch.as_tensor(d["init_qd"][:n]))
    value = {"dof_lower_shift": 0.3, "dof_upper_shift": -0.3,
             "restitution": 0.5}[leaf]
    width = 1 if leaf == "restitution" else tt.engine.nv
    phys = tdr.PhysScales.ones(n)._replace(
        **{leaf: torch.full((n, width), value)})
    g = np.random.default_rng(0)
    ctrl = Control(tau=torch.as_tensor(
        (0.3 * g.normal(size=(n, tt.engine.nv))).astype(np.float32)))
    got, _ = tt.engine.step(sim0, ctrl, phys=phys)
    plain, _ = tt.engine.step(sim0, ctrl)
    assert torch.isfinite(got.q).all() and torch.isfinite(got.qd).all()
    assert float((plain.qd - got.qd).abs().max()) > 1e-3


# --------------------------------------------- kernel twins with scales
@pytest.fixture(scope="module", params=["Trifinger", "FrankaCubeStack",
                                        "FrankaCabinet", "FrankaReach"])
def scaled_scene(request):
    """A new scene at 16 envs on a state from its golden capture, nudged,
    with seeded scales, handed to both packages as numpy."""
    name = request.param
    cap = {"Trifinger": "trifinger", "FrankaCubeStack": "franka_cube_stack",
           "FrankaCabinet": "franka_cabinet",
           "FrankaReach": "franka_reach"}[name]
    d = np.load(os.path.join(DATA, f"{cap}_golden.npz"))
    n = 16
    jt, tt = _jax_task(name, n), _port_task(name, n)
    g = np.random.default_rng(5)
    nb, nv = tt.engine.nb, tt.engine.nv
    q = d["q"][0][:n]
    qd = (d["qd"][0][:n] + 0.3 * g.normal(size=(n, nv))).astype(np.float32)
    bx, bq = jt.engine.fk(jnp.asarray(q))
    data = {"q": q, "qd": qd, "body_x": np.array(bx), "body_q": np.array(bq),
            "S": np.array(jt.engine.dof_motion(bx, bq)),
            "rhs": g.normal(size=(n, nv)).astype(np.float32),
            "diag": np.broadcast_to(np.asarray(jt.engine.dof_armature) + 0.1,
                                    (n, nv)).astype(np.float32),
            "mass_scale": g.uniform(0.6, 1.5, (n, nb)).astype(np.float32),
            "shape_scale": g.uniform(0.7, 1.4, (n, nb, 3)).astype(np.float32)}
    return jt, tt, data


def _bl(x):
    return np.ascontiguousarray(np.moveaxis(x, 0, -1))


def test_b2_b3_twins_with_scales_match_jax(scaled_scene):
    """B2's twin with mass and shape scales against the JAX kernel body
    (tests/test_dyn_kernel.py:86's bounds), then B3's twin fed the gravity
    wrench with the same scales (each package's own) against the JAX
    body."""
    jt, tt, d = scaled_scene
    jplan = jdk.get_plan(jt.engine)
    jc = {k: jnp.asarray(v) for k, v in jplan.consts().items()}
    args = [d[k] for k in ("body_x", "body_q", "S", "qd", "rhs", "diag")]
    args += [d["mass_scale"], d["shape_scale"]]
    ref = jdk.dyn_full_bl(jplan, jc, *(jnp.asarray(_bl(a)) for a in args))
    got = tdk.dyn_forward(tt.engine.plan, *(torch.as_tensor(_bl(a))
                                            for a in args))
    qdd, hinv, io = (g.numpy() for g in got)
    np.testing.assert_allclose(io, np.asarray(ref[2]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hinv, np.asarray(ref[1]), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(qdd, np.asarray(ref[0]), rtol=2e-4, atol=2e-4)
    nominal = tdk.dyn_forward(tt.engine.plan, *(torch.as_tensor(_bl(a))
                                                for a in args[:6]))
    assert float(np.abs(nominal[2].numpy() - io).max()) > 1e-3

    ms, ss = d["mass_scale"], d["shape_scale"]
    jfg = jt.engine.gravity_wrench(jnp.asarray(d["body_x"]),
                                   jnp.asarray(d["body_q"]),
                                   jnp.asarray(ms), jnp.asarray(ss))
    tfg = tt.engine.gravity_wrench(torch.as_tensor(d["body_x"]),
                                   torch.as_tensor(d["body_q"]),
                                   torch.as_tensor(ms), torch.as_tensor(ss))
    np.testing.assert_allclose(tfg.numpy(), np.asarray(jfg), rtol=1e-5,
                               atol=1e-5)
    cargs = [_bl(d["S"]), _bl(d["qd"]), _bl(d["rhs"]), np.asarray(ref[2]),
             np.asarray(ref[1])]
    jq = jdk.dyn_cached_bl(jplan, jc, *(jnp.asarray(a) for a in cargs),
                           jnp.asarray(_bl(np.asarray(jfg))))
    tq = tdk.dyn_cached(tt.engine.plan, *(torch.tensor(a) for a in cargs),
                        torch.as_tensor(_bl(tfg.numpy())))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=2e-4,
                               atol=2e-4)


# -------------------------------------------------------------- sampler
SPECS = {
    "gauss_add": {"range": [0.1, 0.02], "operation": "additive",
                  "distribution": "gaussian"},
    "gauss_scale_linear": {"range": [1.2, 0.1], "operation": "scaling",
                           "distribution": "gaussian", "schedule": "linear",
                           "schedule_steps": 1000},
    "uniform_scale": {"range": [0.7, 1.3], "operation": "scaling",
                      "distribution": "uniform"},
    "uniform_add_constant": {"range": [-0.5, 0.5], "operation": "additive",
                             "distribution": "uniform",
                             "schedule": "constant", "schedule_steps": 500},
    "loguniform": {"range": [0.5, 2.0], "operation": "scaling",
                   "distribution": "loguniform"},
}


@pytest.mark.parametrize("frames", [300, 2000])
@pytest.mark.parametrize("spec", list(SPECS))
def test_sampler_distribution_matches_jax(spec, frames):
    """200,000 samples of each spec from both samplers: means within five
    standard errors of each other, stds within 2%, and the same range
    (each side's extremes inside the other's by 1% of the width)."""
    n = 200_000
    s = SPECS[spec]
    ref = np.asarray(jdr._sample(jax.random.PRNGKey(1), s, (n,),
                                 jnp.float32(frames)), np.float64)
    gen = torch.Generator().manual_seed(1)
    got = tdr._sample(gen, s, (n,), float(frames)).double().numpy()
    se = np.sqrt(ref.var() / n + got.var() / n)
    assert abs(got.mean() - ref.mean()) <= 5 * se + 1e-9, spec
    assert abs(got.std() - ref.std()) <= 0.02 * ref.std() + 1e-9, spec
    width = max(ref.max() - ref.min(), 1e-9)
    if s["distribution"] != "gaussian":
        assert abs(got.min() - ref.min()) <= 0.01 * width, spec
        assert abs(got.max() - ref.max()) <= 0.01 * width, spec
    # the schedule's factor, exactly
    assert tdr._schedule_factor(s, frames) == pytest.approx(
        float(jdr._schedule_factor(s, jnp.float32(frames))), rel=1e-6)


@pytest.mark.parametrize("spec", list(SPECS))
def test_corr_term_matches_jax(spec):
    """The correlated part from a cached N(0, 1) base, the same base on
    both sides (with a range_correlated), exactly."""
    s = dict(SPECS[spec], range_correlated=[0.05, 0.2])
    base = np.random.default_rng(3).normal(size=(64, 9)).astype(np.float32)
    for frames in (300.0, 2000.0):
        ref = jdr._corr_term(s, jnp.asarray(base), jnp.float32(frames))
        got = tdr._corr_term(s, torch.as_tensor(base), frames)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


def _bound_randomizers(n, model):
    jr = jdr.DomainRandomizer(TRIFINGER_DR, n, num_obs=41, num_actions=9)
    tr = tdr.DomainRandomizer(TRIFINGER_DR, n, num_obs=41, num_actions=9)
    jr.bind_model(model)
    tr.bind_model(model)
    return jr, tr


def test_noise_and_resample_match_jax_on_the_same_draws():
    """Trifinger's shipped spec: actions and observations with the JAX
    white samples and correlated bases injected equal the JAX
    randomize_*; the masked resample with the JAX fresh scales (its
    resample with every env masked) equals the JAX resample with the
    mask."""
    n = 64
    tt = _port_task("Trifinger", 8)
    jr, tr = _bound_randomizers(n, tt.model)
    assert tr.act_corr_on and not tr.obs_corr_on
    phys = jr.initial_phys(jax.random.PRNGKey(2), tt.model.nb)
    key_a, key_o, key_p = jax.random.split(jax.random.PRNGKey(4), 3)
    acts = np.random.default_rng(0).uniform(-1, 1, (n, 9)).astype(np.float32)
    obs = np.random.default_rng(1).normal(size=(n, 41)).astype(np.float32)
    ref = jr.randomize_actions(key_a, jnp.asarray(acts), corr=phys.act_corr)
    noise = jdr._sample(key_a, jr.act_spec, (n, 9), 1e9)
    got = tr.randomize_actions(torch.as_tensor(acts),
                               torch.tensor(np.asarray(noise)),
                               corr=torch.tensor(np.asarray(phys.act_corr)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    ref = jr.randomize_observations(key_o, jnp.asarray(obs))
    noise = jdr._sample(key_o, jr.obs_spec, (n, 41), 1e9)
    got = tr.randomize_observations(torch.as_tensor(obs),
                                    torch.tensor(np.asarray(noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)

    tphys = phys_from_jax({k: np.asarray(v) for k, v in
                           phys._asdict().items() if v is not None}, "cpu")
    mask = np.arange(n) % 3 == 0
    ref = jr.resample_phys(key_p, jnp.asarray(mask), phys)
    fresh = jr.resample_phys(key_p, jnp.ones(n, bool), phys)
    got = tr.resample_phys(torch.as_tensor(mask), tphys, phys_from_jax(
        {k: np.asarray(v) for k, v in fresh._asdict().items()
         if v is not None}, "cpu"))
    for k, v in ref._asdict().items():
        if v is None:
            assert getattr(got, k) is None, k
        else:
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(v), err_msg=k)
    # friction moved in the masked envs only
    moved = np.asarray(ref.friction)[:, 0] != np.asarray(phys.friction)[:, 0]
    assert moved[mask].all() and not moved[~mask].any()


def test_initial_and_resampled_scales_distribution_match_jax():
    """Trifinger's setup_only object mass and scale and its friction
    resample: bound to the object's body only, in range, with means and
    stds within five standard errors / 5% of the JAX randomizer's, over
    4,096 envs."""
    n = 4096
    tt = _port_task("Trifinger", 8)
    obj = tt.object_body
    jr, tr = _bound_randomizers(n, tt.model)
    jp = jr.initial_phys(jax.random.PRNGKey(0), tt.model.nb)
    tp = tr.initial_phys(torch.Generator().manual_seed(0), tt.model.nb, "cpu")
    jfresh = jr.resample_phys(jax.random.PRNGKey(1), jnp.ones(n, bool), jp)
    tfresh = tr.draw_resample(torch.Generator().manual_seed(1), tp)
    others = [b for b in range(tt.model.nb) if b != obj]
    for leaf, ref, got, lo, hi in (
            ("mass", np.asarray(jp.mass)[:, obj], tp.mass[:, obj], 0.7, 1.3),
            ("shape", np.asarray(jp.shape)[:, obj],
             tp.shape[:, obj], 0.97, 1.03),
            ("friction", np.asarray(jfresh.friction)[:, 0],
             tfresh.friction[:, 0], 0.7, 1.3),
            ("act_corr", np.asarray(jp.act_corr).ravel(),
             tp.act_corr.reshape(-1), -np.inf, np.inf)):
        got = got.double().numpy()
        ref = np.asarray(ref, np.float64)
        assert got.shape == ref.shape, leaf
        assert lo <= got.min() and got.max() <= hi, leaf
        se = np.sqrt(ref.var() / ref.size + got.var() / got.size)
        assert abs(got.mean() - ref.mean()) <= 5 * se, leaf
        assert abs(got.std() - ref.std()) <= 0.05 * ref.std(), leaf
    # the other bodies keep 1, the scene-global leaves too
    assert (tp.mass[:, others] == 1).all() and (tp.shape[:, others] == 1).all()
    assert tp.mass.shape == np.asarray(jp.mass).shape
    assert tp.friction.shape == (n, 1) and (tp.friction == 1).all()
    assert (tfresh.mass == tp.mass).all() and (tfresh.shape == tp.shape).all()
