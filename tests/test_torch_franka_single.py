"""Port parity of the single-arm Franka tasks (FrankaReach, FrankaCabinet,
FrankaCubeStack, FrankaCubeStack2) against the JAX package.

Captures (``scripts/record_torch_golden.py --task <name>``, 32 envs from a
warmed-up state, a quarter reset on the first recorded step with the JAX
reset draws): FrankaReach 6 steps; FrankaCabinet 10 steps with the handle
grabbed in half the envs (the arm solved onto the handle, both fingers
closing); FrankaCubeStack and FrankaCubeStack2 10 steps with cube A held
in half the envs, and the reference's own spread over the trajectory;
``--task FrankaCabinet --kernel-route`` 6 steps at 128 envs on the JAX
kernel route (Pallas interpret mode: the JAX engine takes it only at
N % 128 == 0), replayed on the port's B4 route.  No test steps a JAX
Franka task: the replays start from the captures, and the controls are
compared eagerly on a capture's state.

Tolerances: parity.TOLERANCES (FrankaReach FRANKA_GOLDEN_TOL, FrankaCabinet
the ground-rule bounds, the cube-stack captures FRANKA_GOLDEN_TOL beyond
four times their recorded spread, ROADMAP C9); see the comments there.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.physics.engine import SimState as JSimState
from isaacgymenvs_ma_tpu.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax
from isaacgymenvs_ma_tpu_torch.tasks import registry
from isaacgymenvs_ma_tpu_torch.utils.parity import (
    TASKS, TOLERANCES, live_cabinet_grabs, live_grabs, replay)
from test_torch_ball_balance import _assert_models_equal

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
# name -> (capture, envs, steps, obs width, grab envs)
CAPTURES = {
    "FrankaReach": ("franka_reach_golden.npz", 32, 6, 13, 0),
    "FrankaCabinet": ("franka_cabinet_golden.npz", 32, 10, 23, 16),
    "FrankaCubeStack": ("franka_cube_stack_golden.npz", 32, 10, 19, 16),
    "FrankaCubeStack2": ("franka_cube_stack2_golden.npz", 32, 10, 21, 16),
}
CABINET_B4 = os.path.join(DATA, "franka_cabinet_b4_golden.npz")
NAMES = list(CAPTURES)
JAX_MODULES = {"FrankaReach": "franka_reach", "FrankaCabinet":
               "franka_cabinet", "FrankaCubeStack": "franka_cube_stack",
               "FrankaCubeStack2": "franka_cube_stack2"}


def _jax_task(name, n):
    import importlib
    m = importlib.import_module(
        f"isaacgymenvs_ma_tpu.tasks.{JAX_MODULES[name]}")
    return getattr(m, name)(deep_merge(m.TASK_CFG, {"env": {"numEnvs": n}}))


def _port_task(name, n, kernel_route=False):
    from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
    cfg = deep_merge(registry.task_default_config(name),
                     {"env": {"numEnvs": n}})
    params = parse_sim_params(cfg["sim"])._replace(
        use_contact_kernel=kernel_route)
    return registry.task_class(name)(cfg, device="cpu", sim_params=params)


def _check_replay(e, name, steps, grab_envs):
    assert e.finite
    for k, tol in TOLERANCES[name].items():
        errs = getattr(e, k)
        assert errs.shape == (steps,)
        assert (errs <= tol).all(), f"{name} {k} per-step errors {errs}"
    assert (e.reset_mismatches == 0).all(), e.reset_mismatches
    if grab_envs:
        # one grab an env, live in every held env in every step
        assert (e.grabs_live == grab_envs).all(), e.grabs_live


@pytest.mark.parametrize("name", NAMES)
def test_capture_format(name):
    fname, n, steps, n_obs, grab_envs = CAPTURES[name]
    d = np.load(os.path.join(DATA, fname))
    assert str(d["task"]) == name
    assert d["actions"].shape[:2] == (steps, n)
    assert d["obs"].shape == (steps, n, n_obs)
    assert int(d["init_reset_buf"].sum()) >= n // 4
    from isaacgymenvs_ma_tpu_torch.utils.parity import RESET_DRAWS
    for k in RESET_DRAWS[name]:
        assert d[k].shape[:2] == (steps, n), k
    if grab_envs:
        assert len(d["grab_envs"]) == grab_envs
    if name.startswith("FrankaCubeStack"):
        for k in ("q", "qd", "obs", "rew"):
            sp = d[f"traj_spread_{k}"]
            assert sp.shape == (steps,) and (sp >= 0).all()
        assert d["traj_spread_q"][-1] > 0


@pytest.mark.parametrize("name", NAMES)
def test_golden_replay_on_cpu_twins(name):
    fname, _, steps, _, grab_envs = CAPTURES[name]
    e = replay(os.path.join(DATA, fname), "cpu")
    _check_replay(e, name, steps, grab_envs)
    if name.startswith("FrankaCubeStack"):
        # held beyond the reference's own spread, which it tracks
        assert e.traj_widening["q"][-1] > 0
        assert (e.traj_raw["q"] <= TOLERANCES[name]["q"]
                + e.traj_widening["q"]).all()


def test_cabinet_b4_golden_replay_on_cpu_twins():
    """FrankaCabinet's kernel-route capture (128 envs, 6 steps, the
    handle grab live in 64 envs) on the port's B4 route (its twin)."""
    d = np.load(CABINET_B4)
    assert d["actions"].shape[:2] == (6, 128)
    assert len(d["grab_envs"]) == 64
    e = replay(CABINET_B4, "cpu", use_contact_kernel=True)
    _check_replay(e, "FrankaCabinet", 6, 64)


@pytest.mark.parametrize("name", NAMES)
def test_scene_matches_jax(name):
    """The composed scene, the contact candidates, the row masks and the
    grabs of the port's task equal the JAX task's."""
    jt, tt = _jax_task(name, 4), _port_task(name, 4)
    _assert_models_equal(tt.model, jt.model)
    je, te = jt.engine, tt.engine
    assert (te.nb, te.nv, te.n_ground, te.n_pair_rows) == (
        je.nb, je.nv, je.n_ground, je.n_pair_rows)
    np.testing.assert_array_equal(te.row_masks_np,
                                  np.asarray(je._row_masks_np()))
    assert [(g["body_a"], g["body_b"]) for g in te.grabs] == [
        (g["body_a"], g["body_b"]) for g in je.grabs]
    for tg, jg in zip(te.grabs, je.grabs):
        np.testing.assert_allclose(tg["off_b"].numpy(), np.asarray(jg["off_b"]))
    # the bf16 rule stays off (C3): rows after compaction x nv < 1024
    assert tt.num_obs == CAPTURES[name][3]


def test_build_cabinet_matches_jax():
    from isaacgymenvs_ma_tpu.tasks.franka_cabinet import (
        build_cabinet as jbuild)
    from isaacgymenvs_ma_tpu_torch.tasks.franka_cabinet import (
        build_cabinet as tbuild)
    (tm, tdrawer), (jm, jdrawer) = tbuild(), jbuild()
    _assert_models_equal(tm, jm)
    assert tdrawer == jdrawer


@pytest.mark.parametrize("name", NAMES)
def test_pre_physics_matches_jax(name):
    """The control of one step (OSC torques through the port's SPD
    inverse, the finger targets and the grab gate) on a capture's first
    state against the JAX task's pre_physics, run eagerly."""
    fname, n = CAPTURES[name][:2]
    d = np.load(os.path.join(DATA, fname))
    jt, tt = _jax_task(name, n), _port_task(name, n)
    st = jt.initial_state(jax.random.PRNGKey(0))
    st = st._replace(sim=JSimState(jnp.asarray(d["init_q"]),
                                   jnp.asarray(d["init_qd"])))
    acts = d["actions"][0]
    ref = jt.pre_physics(st, jnp.asarray(acts))
    state_cls = TASKS[name][2]
    tst = env_state_from_jax({
        "sim.q": d["init_q"], "sim.qd": d["init_qd"],
        "progress": d["init_progress"], "reset_buf": d["init_reset_buf"],
        **{f"task.{f}": d[f"init_{f}"] for f in state_cls._fields}},
        "cpu", state_cls)
    got = tt.pre_physics(tst, torch.as_tensor(acts))
    tau_ref = np.asarray(ref.tau)
    np.testing.assert_allclose(got.tau.numpy(), tau_ref, rtol=1e-4,
                               atol=1e-4 * max(1.0, np.abs(tau_ref).max()))
    np.testing.assert_array_equal(got.pos_target.numpy(),
                                  np.asarray(ref.pos_target))
    if ref.grab_active is None:
        assert got.grab_active is None
    else:
        np.testing.assert_array_equal(got.grab_active.numpy(),
                                      np.asarray(ref.grab_active))
        assert float(got.grab_active.sum()) == CAPTURES[name][4]


def test_live_grab_helpers_turn_the_gates_on():
    """parity.live_grabs (cube A on the grip site) and
    parity.live_cabinet_grabs (the arm solved onto the handle) switch the
    grab on in the chosen envs only; the held cube rises with the grip
    site's pull and the held drawer follows the grip."""
    for name, make in (("FrankaCubeStack", live_grabs),
                       ("FrankaCabinet", live_cabinet_grabs)):
        tt = _port_task(name, 8)
        st = tt.initial_state()
        for _ in range(2):
            st, _ = tt.step(st, tt.zero_actions())
        acts = torch.tanh(torch.randn(8, tt.num_actions,
                                      generator=torch.Generator()
                                      .manual_seed(3)))
        st = make(tt, st, acts, [1, 4, 6])
        on = tt.pre_physics(st, acts).grab_active[:, 0]
        assert on.tolist() == [0, 1, 0, 0, 1, 0, 1, 0]
        st2, res = tt.step(st, acts)
        assert torch.isfinite(res.obs).all()


@pytest.mark.parametrize("name", NAMES)
def test_registered_and_steps_on_both_routes(name):
    for kernel_route in (False, True):
        tt = _port_task(name, 4, kernel_route)
        assert (tt.engine.cplan is not None) == kernel_route
        st = tt.initial_state()
        for _ in range(2):
            st, res = tt.step(st, torch.tanh(torch.randn(
                4, tt.num_actions, generator=torch.Generator()
                .manual_seed(1))))
        assert res.obs.shape == (4, CAPTURES[name][3])
        assert torch.isfinite(res.obs).all() and torch.isfinite(res.rew).all()
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            registry.task_class(name)(deep_merge(
                registry.task_default_config(name), {"env": {"numEnvs": 4}}))
