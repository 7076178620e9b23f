"""Port parity of Trifinger (isaacgymenvs_ma_tpu_torch/tasks/trifinger.py)
with its shipped domain randomization against the JAX package.

* The copied spec (models/specs/trifinger.py) and the composed scene (the
  finger robot, the fingertip spheres and sensors, the cube) equal the
  JAX package's.
* trifinger_golden.npz (``scripts/record_torch_golden.py --task
  Trifinger``): 32 envs, 6 steps from a warmed-up state, a quarter reset
  on the first recorded step, with the JAX reset draws, the recorded
  physics scales (object mass and scale per env, friction resampled at
  reset, correlated action-noise bases) and every step's white action and
  observation noise and fresh scales injected; held at the ground-rule
  bounds (parity.GROUND_RULE_TOL).  trifinger_b4_golden.npz
  (``--kernel-route``): the same at 128 envs on the JAX kernel route
  (Pallas interpret mode), replayed on the port's B4 route.
* ``reset_idx`` with the JAX draws equals the JAX ``reset_idx`` (object
  and goal samplers, fingertip bookkeeping).
* With the randomization live (generator draws): the setup-only scales sit
  on the cube only and in range, friction is resampled for the envs that
  reset, the noise moves actions and observations at the configured std.
* ``train.py task=Trifinger`` trains with the config's central-value
  critic and plays from its checkpoint.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.tasks import trifinger as jtri
from isaacgymenvs_ma_tpu.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.learning.configs import train_default_config
from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
from isaacgymenvs_ma_tpu_torch.physics.engine import SimState
from isaacgymenvs_ma_tpu_torch.tasks import trifinger as ttri
from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
from isaacgymenvs_ma_tpu_torch.utils.parity import (
    GROUND_RULE_TOL, RESET_DRAWS, TOLERANCES, replay)
from test_torch_ball_balance import _assert_models_equal

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
GOLDEN = os.path.join(DATA, "trifinger_golden.npz")
B4_GOLDEN = os.path.join(DATA, "trifinger_b4_golden.npz")


def _port(n, kernel_route=False, **env):
    cfg = deep_merge(ttri.TASK_CFG, {"env": {"numEnvs": n, **env}})
    params = parse_sim_params(cfg["sim"])._replace(
        use_contact_kernel=kernel_route)
    return ttri.Trifinger(cfg, device="cpu", seed=3, sim_params=params)


def test_copied_spec_and_scene_match_jax():
    from isaacgymenvs_ma_tpu.models.model import model_from_spec as jmfs
    from isaacgymenvs_ma_tpu.models.specs.trifinger import SPEC as JSPEC
    from isaacgymenvs_ma_tpu_torch.models.model import model_from_spec
    from isaacgymenvs_ma_tpu_torch.models.specs.trifinger import SPEC
    assert SPEC == JSPEC
    _assert_models_equal(model_from_spec(SPEC), jmfs(JSPEC))
    jt = jtri.Trifinger(deep_merge(jtri.TASK_CFG, {"env": {"numEnvs": 4}}))
    tt = _port(4)
    _assert_models_equal(tt.model, jt.model)
    je, te = jt.engine, tt.engine
    assert (te.nb, te.nv, te.n_ground, te.n_pair_rows) == (11, 15, 11, 3)
    assert (je.nb, je.nv, je.n_ground, je.n_pair_rows) == (11, 15, 11, 3)
    np.testing.assert_array_equal(te.row_masks_np,
                                  np.asarray(je._row_masks_np()))
    np.testing.assert_array_equal(te.sensor_body, np.asarray(je.sensor_body))
    assert TOLERANCES["Trifinger"] is GROUND_RULE_TOL
    assert tt.randomizer is not None and tt.randomizer.enabled


def test_capture_format():
    d = np.load(GOLDEN)
    T, N = d["actions"].shape[:2]
    assert (T, N) == (6, 32) and str(d["task"]) == "Trifinger"
    assert d["obs"].shape == (T, N, 41)
    for k in RESET_DRAWS["Trifinger"]:
        assert d[k].shape[:2] == (T, N), k
    assert d["dr_actions"].shape == (T, N, 9)
    assert d["dr_observations"].shape == (T, N, 41)
    obj = 10
    m = d["init_phys_mass"]
    assert m.shape == (N, 11) and (m[:, :obj] == 1).all()
    assert (0.7 <= m[:, obj]).all() and (m[:, obj] <= 1.3).all()
    s = d["init_phys_shape"]
    assert (0.97 <= s[:, obj]).all() and (s[:, obj] <= 1.03).all()
    assert d["init_phys_act_corr"].shape == (N, 9)
    f = d["dr_phys_friction"]
    assert f.shape == (T, N, 1) and (0.7 <= f).all() and (f <= 1.3).all()


@pytest.mark.parametrize("path,kernel_route,n",
                         [(GOLDEN, False, 32), (B4_GOLDEN, True, 128)],
                         ids=["loop", "b4"])
def test_golden_replay_on_cpu_twins(path, kernel_route, n):
    d = np.load(path)
    assert d["actions"].shape[1] == n
    e = replay(path, "cpu", use_contact_kernel=kernel_route)
    assert e.finite
    for k, tol in GROUND_RULE_TOL.items():
        errs = getattr(e, k)
        assert (errs <= tol).all(), f"{k} per-step errors {errs} > {tol}"
    assert (e.reset_mismatches == 0).all()


def _jax_reset_draws(key, n):
    """The JAX Trifinger.reset_idx's draws from ``key`` (trifinger.py:
    342-386) as the port takes them (scripts/record_torch_golden.py's
    ``trifinger_draws`` at difficulty 4)."""
    u = jax.random.uniform
    ks = jax.random.split(key, 6)
    ko1, ko2 = jax.random.split(ks[2])
    kg = jax.random.split(ks[4], 3)
    kg1, kg2 = jax.random.split(kg[0])
    return {"dof_pos_n": jax.random.normal(ks[0], (n, 9)),
            "dof_vel_n": jax.random.normal(ks[1], (n, 9)),
            "obj_r_u": u(ko1, (n,)),
            "obj_th": u(ko2, (n,), minval=0.0, maxval=2 * np.pi),
            "obj_yaw": u(ks[3], (n,), minval=-np.pi, maxval=np.pi),
            "goal_r_u": u(kg1, (n,)),
            "goal_th": u(kg2, (n,), minval=0.0, maxval=2 * np.pi),
            "goal_z": u(kg[1], (n,), minval=jtri.CUBE_RADIUS_3D,
                        maxval=jtri.MAX_HEIGHT),
            "goal_yaw": u(kg[1], (n,), minval=-np.pi, maxval=np.pi),
            "goal_quat_u": u(kg[2], (n, 3))}


def test_reset_idx_matches_jax():
    """Every env reset with the JAX draws: robot dofs, the object's random
    pose in the arena, the difficulty-4 goal pose and the fingertip
    bookkeeping equal the JAX reset_idx's."""
    n = 16
    jt = jtri.Trifinger(deep_merge(jtri.TASK_CFG, {"env": {"numEnvs": n}}))
    tt = _port(n)
    st = jt.initial_state(jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(9)
    mask = np.arange(n) % 2 == 0
    jsim, jtask = jt.reset_idx(st.sim, st.task, jnp.asarray(mask), key)
    draws = _jax_reset_draws(key, n)
    tst = tt.initial_state()
    tsim, ttask = tt.reset_idx(
        SimState(torch.as_tensor(np.array(st.sim.q)),
                 torch.as_tensor(np.array(st.sim.qd))), tst.task,
        torch.as_tensor(mask),
        tuple(torch.as_tensor(np.array(draws[k]))
              for k in RESET_DRAWS["Trifinger"]))
    np.testing.assert_allclose(tsim.q.numpy(), np.asarray(jsim.q),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tsim.qd.numpy(), np.asarray(jsim.qd))
    for f in ("goal_pose", "last_ft_pos", "last_obj_pos", "successes"):
        np.testing.assert_allclose(getattr(ttask, f).numpy(),
                                   np.asarray(getattr(jtask, f)),
                                   rtol=1e-6, atol=2e-6, err_msg=f)
    goal = ttask.goal_pose.numpy()[mask]
    assert (np.linalg.norm(goal[:, :2], axis=-1) <= ttri.MAX_COM_DIST).all()
    np.testing.assert_allclose(np.linalg.norm(goal[:, 3:], axis=-1), 1.0,
                               atol=1e-6)


def test_randomization_live_on_the_generator():
    """Trifinger with its shipped randomization, every draw from the
    task's generator: the setup-only scales on the cube only, friction
    resampled for every env on the first step (all reset), the action
    noise at its configured std (0.02 white, 0.01 correlated), states of
    width 113."""
    n = 256
    tt = _port(n)
    st = tt.initial_state()
    obj = tt.object_body
    ph = st.phys
    assert ph.mass.shape == (n, 11) and ph.shape.shape == (n, 11, 3)
    assert (ph.mass[:, :obj] == 1).all() and (ph.shape[:, :obj] == 1).all()
    assert float(ph.mass[:, obj].std()) > 0.1
    assert (ph.friction == 1).all() and ph.obs_corr is None
    dr = tt.randomizer
    noise = dr.action_noise(tt.generator, (200_000,))
    assert abs(float(noise.std()) - 0.02) < 1e-3
    acts = torch.zeros(n, 9)
    st2, res = tt.step(st, acts)
    assert res.states.shape == (n, 113) and torch.isfinite(res.states).all()
    f = st2.phys.friction
    assert (f != 1).all() and (0.7 <= f).all() and (f <= 1.3).all()
    assert torch.equal(st2.phys.mass, ph.mass)          # setup_only
    assert not torch.equal(st2.phys.act_corr, ph.act_corr)  # refreshed
    # no env flagged: the scales stay
    st3, _ = tt.step(st2._replace(reset_buf=torch.zeros_like(st2.reset_buf)),
                     acts)
    assert torch.equal(st3.phys.friction, f)


def test_train_entry_point_trains_with_the_central_value(tmp_path,
                                                         monkeypatch):
    """``train.py task=Trifinger``: its config's asymmetric critic
    (central_value_config, 113 privileged states) trains an epoch, and the
    checkpoint carries the states' normaliser into the player."""
    from isaacgymenvs_ma_tpu_torch import train as ptrain
    from isaacgymenvs_ma_tpu_torch.learning.networks import AsymActorCritic
    tcfg = train_default_config("Trifinger")
    assert tcfg["params"]["config"].get("central_value_config")
    tcfg["params"]["config"]["minibatch_size"] = 32
    agent = PPOAgent(_port(8), tcfg)
    assert agent.use_central_value and not agent.is_rnn
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ptrain, "PLAY_STEPS", 4)
    args = ["task=Trifinger", "num_envs=8", "max_iterations=1",
            "train.params.config.minibatch_size=32",
            "train.params.config.mini_epochs=1", "sim_device=cpu"]
    agent = ptrain.launch(args)
    assert isinstance(agent.net, AsymActorCritic)
    assert float(agent.states_rms.count) > 1.0
    assert agent.last_states.shape == (8, 113)
    ckpt = next((tmp_path / "runs").glob("Trifinger_*/nn/Trifinger.pth"))
    played = ptrain.launch(args + ["test=True", f"checkpoint={ckpt}"])
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(played.states_rms, f),
                           getattr(agent.states_rms, f))
