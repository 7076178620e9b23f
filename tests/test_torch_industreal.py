"""Port parity of IndustReal (isaacgymenvs_ma_tpu_torch/tasks/industreal.py)
against the JAX package, with the checks of tests/test_torch_factory.py.

* The scenes (the Factory Franka holding the plug by a grab constraint,
  the socket's baked grid or the shaft, the finger-table pairs), the
  engines' rows and route.
* SAPU's interpenetration (the socket-material grid; at GearsInsert the
  shaft's, the bore rim left out), the SDF dense reward (the goal grid)
  and the analytic SDFs of ``use_mesh_sdf`` False on seeded plug poses.
* ``post_physics`` from a capture's state in the three SBC regimes
  (insertion success above, between and below the curriculum's
  thresholds, every env on its last step), with the goal noise drawn from
  the JAX key injected; SAPU's keep-previous rule; the objects' reset with
  the SBC displacement; ``pre_physics`` (the grab always on);
  ``get_env_state`` / ``set_env_state``.
* The two captures replayed on the CPU twins one step at a time (the
  median over the envs of each env's error beyond four times the
  reference's one-ulp spread, at the ground rule: the held plug makes the
  reference's own spread reach 1e-2 in q).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.tasks import industreal as jind
from isaacgymenvs_ma_tpu.tasks import registry as jregistry
from isaacgymenvs_ma_tpu_torch.tasks import industreal
from isaacgymenvs_ma_tpu_torch.tasks import registry as pregistry
from test_torch_factory import (N, TOL, check_pre_physics, check_replay,
                                check_reset_idx, check_scene, close, pair,
                                states)

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

INDUSTREAL = ("IndustRealTaskPegsInsert", "IndustRealTaskGearsInsert")
# registry name -> (nb, nv, ground rows, pair rows, obs, act, bf16 rows)
SIZES = {"IndustRealTaskPegsInsert": (19, 15, 46, 76, 24, 6, True),
         "IndustRealTaskGearsInsert": (19, 15, 52, 216, 24, 6, True)}
STATE = industreal.IndustRealTaskState


def _plug_poses(jt, rng, n):
    """Plug poses around the goal: up to 6 mm off in x / y, -2 to +30 mm
    in z, tilted up to 0.15 rad."""
    goal = np.asarray(jt._goal_pos())
    pos = goal + np.stack([rng.uniform(-6e-3, 6e-3, n),
                           rng.uniform(-6e-3, 6e-3, n),
                           rng.uniform(-2e-3, 3e-2, n)], -1)
    ax = rng.normal(size=(n, 3))
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    ang = rng.uniform(0.0, 0.15, n)[:, None]
    quat = np.concatenate([ax * np.sin(ang / 2), np.cos(ang / 2)], -1)
    return pos.astype(np.float32), quat.astype(np.float32)


@pytest.mark.parametrize("name", INDUSTREAL)
def test_scene_matches_jax(name):
    jt, pt = check_scene(name, SIZES[name])
    assert len(pt.engine.grabs) == 1 == len(jt.engine.grabs)
    names = [g.name for g in pt.model.geoms]
    pad_rows = {int(p["tgt_body"]) for p in pt.engine.pairs
                if p["tgt_type"] == industreal.GEOM_BOX}
    # the finger-table pairs (they close SAPU's reward-freeze exploit)
    assert pt.model.geoms[names.index("table_top")].body in pad_rows
    for g in (pt._socket_grid, pt._goal_grid):
        assert g.pack.shape[1] == 8
    np.testing.assert_array_equal(pt._socket_grid.values.numpy(),
                                  np.asarray(jt._socket_grid.values))
    np.testing.assert_array_equal(pt._goal_grid.values.numpy(),
                                  np.asarray(jt._goal_grid.values))
    np.testing.assert_array_equal(pt._samples.numpy(),
                                  np.asarray(jt._samples))


@pytest.mark.parametrize("name", INDUSTREAL)
def test_sapu_and_sdf_reward_match_jax(name):
    jt, pt = pair(name)
    rng = np.random.default_rng(21)
    pos, quat = _plug_poses(jt, rng, 64)
    close(pt._sapu_interpen(torch.tensor(pos), torch.tensor(quat)),
          jt._sapu_interpen(jnp.asarray(pos), jnp.asarray(quat)), 1e-6,
          "interpenetration")
    close(pt._sdf_reward(torch.tensor(pos), torch.tensor(quat)),
          jt._sdf_reward(jnp.asarray(pos), jnp.asarray(quat)), 1e-5,
          "sdf reward", rtol=1e-5)
    pen = pt._sapu_interpen(torch.tensor(pos), torch.tensor(quat))
    # some peg poses interpenetrate the socket beyond SAPU's threshold,
    # some do not; the gear's points inside the shaft's radius are its
    # bore's, which SAPU leaves out
    assert (pen <= 1e-4).any()
    if name == "IndustRealTaskPegsInsert":
        assert (pen > pt.interpen_thresh).any()
    else:
        assert not pen.any()


def test_analytic_sdfs_match_jax():
    rng = np.random.default_rng(22)
    p = rng.uniform(-0.03, 0.03, (256, 3)).astype(np.float32)
    close(industreal.sdf_socket_material(torch.tensor(p)),
          jind.sdf_socket_material(jnp.asarray(p)), 1e-7, "socket")
    close(industreal.sdf_cylinder(torch.tensor(p), 0.004, 0.025),
          jind.sdf_cylinder(jnp.asarray(p), 0.004, 0.025), 1e-7, "cylinder")
    close(industreal.sdf_box(torch.tensor(p), (0.01, 0.02, 0.005)),
          jind.sdf_box(jnp.asarray(p), (0.01, 0.02, 0.005)), 1e-7, "box")


@pytest.mark.parametrize("regime", ["inserted", "half", "out"])
@pytest.mark.parametrize("name", INDUSTREAL)
def test_post_physics_and_sbc_match_jax(name, regime):
    """Every env on its last step with the plug at the goal (success rate
    7 / 8: the curriculum steps down), at the goal in half the envs (0.5:
    kept) or 3 cm above it (0: steps up); env 1 pushed 6 mm sideways at
    the goal's height (through the socket's wall at PegsInsert: SAPU keeps
    its previous reward, and it counts as no success)."""
    jt, pt = pair(name)
    jst, pst = states(jt, name, STATE)
    q = np.asarray(jst.sim.q).copy()
    qa = int(pt.model.q_adr[pt.plug_body])
    goal = np.asarray(jt._goal_pos())
    inserted = {"inserted": np.ones(N, bool), "out": np.zeros(N, bool),
                "half": np.arange(N) % 2 == 0}[regime]
    q[:, qa: qa + 3] = goal + np.where(inserted[:, None], 0.0,
                                       [0.0, 0.0, 0.03])
    q[:, qa + 3: qa + 7] = [0.0, 0.0, 0.0, 1.0]
    q[1, qa: qa + 3] = goal + [0.006, 0.0, 0.0]    # through the socket
    prev = np.random.default_rng(3).normal(size=N).astype(np.float32)
    progress = np.full(N, jt.max_episode_length - 1, np.int32)
    jst = jst._replace(sim=jst.sim._replace(q=jnp.asarray(q)),
                       progress=jnp.asarray(progress),
                       task=jst.task._replace(prev_rew=jnp.asarray(prev)))
    pst = pst._replace(sim=pst.sim._replace(q=torch.tensor(q)),
                       progress=torch.tensor(progress),
                       task=pst.task._replace(prev_rew=torch.tensor(prev)))
    acts = np.random.default_rng(9).uniform(-1, 1, (N, 6)).astype(np.float32)
    jo, _, jr, jreset, jtask, jx = jt.post_physics(
        jst, jt.engine.forward(jst.sim), jnp.asarray(acts))
    noise = jax.random.normal(jax.random.fold_in(jst.rng, 29), (N, 3))
    po, _, pr, preset, ptask, px = pt.post_physics(
        pst, pt.engine.forward(pst.sim), torch.tensor(acts),
        draws=(torch.tensor(np.asarray(noise)),))
    close(po, jo, TOL["obs"], "obs")
    close(pr, jr, TOL["rew"], "reward", rtol=1e-5)
    np.testing.assert_array_equal(preset.numpy(), np.asarray(jreset))
    for f in STATE._fields:
        close(getattr(ptask, f), getattr(jtask, f), 1e-6, f, rtol=1e-6)
    for k, v in jx.items():
        close(px[k], v, 1e-5, k, rtol=1e-5)
    disp0 = float(jst.task.curr_max_disp)
    step = {"inserted": pt.h_step[0], "half": 0.0, "out": pt.h_step[1]}
    want = float(np.clip(disp0 + step[regime], *pt.h_bound))
    assert float(ptask.curr_max_disp) == pytest.approx(want, abs=1e-7)
    # SAPU: the peg pushed through the socket's wall takes the keep-previous
    # branch (before the last step's bonus and stage scale); the gear's bore
    # rides the shaft: no interpenetration
    pen = pt._sapu_interpen(po.new_tensor(q[:, qa: qa + 3]),
                            po.new_tensor(q[:, qa + 3: qa + 7]))
    if name == "IndustRealTaskPegsInsert":
        assert float(pen[1]) > pt.interpen_thresh
        assert (pen[::2] <= pt.interpen_thresh).all()


@pytest.mark.parametrize("name", INDUSTREAL)
def test_reset_idx_matches_jax(name):
    """The plug's reset: xy noise and the SBC displacement U(0, 1) times
    the curriculum's current maximum."""
    jt, pt, jst, pst = check_reset_idx(name, STATE)
    assert float(pst.task.curr_max_disp) == pytest.approx(0.01)


@pytest.mark.parametrize("name", INDUSTREAL)
def test_pre_physics_matches_jax(name):
    jt, pt = check_pre_physics(name, STATE)


def test_env_state_round_trip():
    _, pt = pair("IndustRealTaskPegsInsert", n=4)
    st = pt.initial_state()
    st2 = pt.set_env_state(st, {"curr_max_disp": 0.004})
    assert float(pt.get_env_state(st2)["curr_max_disp"]) == \
        pytest.approx(0.004)
    assert pt.set_env_state(st, None) is st


@pytest.mark.parametrize("name", INDUSTREAL)
def test_golden_replay_on_cpu_twins(name):
    e = check_replay(name)
    assert e.grabs_live.min() == N          # the grab on in every env


def test_registry_names_and_aliases():
    for name in INDUSTREAL:
        assert pregistry.task_class(name).__name__ == name
        assert pregistry.task_default_config(name) == \
            jregistry.task_default_config(name)
    for alias in ("IndustRealBase", "IndustRealEnvPegs",
                  "IndustRealEnvGears"):
        assert pregistry.task_default_config(alias) == \
            jregistry.task_default_config(alias)
        with pytest.raises(KeyError):
            pregistry.task_class(alias)
