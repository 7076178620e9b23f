"""Port parity of FrankaPPMA and FrankaCombineMA (isaacgymenvs_ma_tpu_torch/
tasks/franka_ppma.py, franka_combine_ma.py) against the JAX package, on
the CPU.

As in tests/test_torch_franka_collect_ma.py: no JAX step is jitted; the
state is the warmed-up initial state of the committed PPMA capture
(tests/data/torch_port/franka_ppma_golden.npz, 16 envs x 2 arms, live
grabs in envs 4-11), and the JAX methods run eagerly on it.  FrankaCombineMA
differs from FrankaPPMA only in where its pads sit (both at the stack
base; no body of theirs moves) and in ``post_physics``, so it is held on
the same state.  Tolerances and their reasons are that file's: the scene,
the FSM tables, the proximity FSM, the gripper targets, the grab
activation and the resets exactly; OSC torques rtol = atol = 2e-3;
``post_physics`` rtol 1e-5 / atol 1e-6 on the same readouts, atol 1e-5 on
each engine's own.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.physics.engine import SimState as JSimState
from isaacgymenvs_ma_tpu.tasks import franka_combine_ma as jcm
from isaacgymenvs_ma_tpu.tasks import franka_ppma as jpp
from isaacgymenvs_ma_tpu_torch.physics.engine import SimState
from isaacgymenvs_ma_tpu_torch.tasks import franka_combine_ma as cm
from isaacgymenvs_ma_tpu_torch.tasks import franka_ppma as pp
from test_torch_franka_collect_ma import (N, assert_scene_matches,
                                          compare_post_physics,
                                          fabricated_readout, load_pair)

CAPTURE = "franka_ppma_golden.npz"


@pytest.fixture(scope="module")
def pp_pair():
    return load_pair(jpp, pp.FrankaPPMA, CAPTURE)


@pytest.fixture(scope="module")
def cm_pair():
    return load_pair(jcm, cm.FrankaCombineMA, CAPTURE)


def test_ppma_and_combine_scenes_match_jax(pp_pair, cm_pair):
    """37 bodies (reach's 35 and two pads), 24 ground rows (the table's and
    the cubes' corners; the pads', fixed 1 m up, are pruned), 49 pair rows
    (16 cube corners against the table, 32 against the two pads, the hand
    spheres), 4 grabs; Combine's two pads coincide at the stack base."""
    for pair in (pp_pair, cm_pair):
        jt, tt = pair["jt"], pair["tt"]
        e = tt.engine
        assert (e.nb, e.nq, e.nv) == (37, 32, 30)
        assert (e.n_ground, e.n_pair_rows, len(e.grabs)) == (24, 49, 4)
        assert_scene_matches(jt, tt)
        np.testing.assert_array_equal(tt.dest_pos.numpy(),
                                      np.asarray(jt.dest_pos))
        assert tt.max_episode_length == 300 and tt.num_actions == 7
    assert pp_pair["tt"].num_obs == 50 and cm_pair["tt"].num_obs == 48
    pads = cm_pair["tt"].dest_pos.numpy()
    np.testing.assert_array_equal(pads[0], pads[1])
    np.testing.assert_array_equal(pads[0], np.float32(cm.STACK_BASE))
    assert not np.array_equal(*pp_pair["tt"].dest_pos.numpy())


def test_fsm_pp_and_proximity_match_jax(pp_pair):
    """``_fsm_pp`` on seeded tables around its thresholds (the 2.25 cm
    grab distance, lifted / aligned / stackable), and ``_gfsm_proximity``
    on seeded grip sites and cubes around 0.18 m, exactly."""
    jt, tt = pp_pair["jt"], pp_pair["tt"]
    g = np.random.default_rng(0)
    n = 256
    md = g.choice([0.0, 0.02, 0.0225, 0.023, 1.0], (n, 2)).astype(np.float32)
    closed = g.uniform(size=(n, 2)) < 0.5
    dest_rel = np.stack([
        g.choice([0.0, 0.01, 0.02, 0.3], (n, 2)),
        g.choice([0.0, 0.01, 0.02, 0.3], (n, 2)),
        g.choice([0.0, 0.04, 0.05, 0.06, 0.2], (n, 2))
        * g.choice([-1.0, 1.0], (n, 2))], -1).astype(np.float32)
    ref = np.asarray(jt._fsm_pp(jnp.asarray(md), jnp.asarray(closed),
                                jnp.asarray(dest_rel)))
    got = tt._fsm_pp(torch.as_tensor(md), torch.as_tensor(closed),
                     torch.as_tensor(dest_rel))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert set(np.unique(ref)) >= {0, 1, 2, 3, 4, 5, 6}
    eef = g.uniform(-0.2, 0.2, (n, 2, 3)).astype(np.float32)
    cube = g.uniform(-0.2, 0.2, (n, 2, 3)).astype(np.float32)
    ref = np.asarray(jt._gfsm_proximity(jnp.asarray(eef), jnp.asarray(cube)))
    got = tt._gfsm_proximity(torch.as_tensor(eef), torch.as_tensor(cube))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.shape == (2 * n,) and set(np.unique(ref)) == {-1, 0}


def test_pre_physics_matches_jax(pp_pair):
    """OSC torques, the gripper targets and agent k's grab of its own cube
    k (grabs 0 and 3) from the capture's state and first actions; Combine
    runs PPMA's ``pre_physics`` in both packages."""
    jt, tt, d = pp_pair["jt"], pp_pair["tt"], pp_pair["d"]
    assert cm.FrankaCombineMA.pre_physics is pp.FrankaPPMA.pre_physics
    assert jcm.FrankaCombineMA.pre_physics is jpp.FrankaPPMA.pre_physics
    acts = d["actions"][0]
    ref = jt.pre_physics(pp_pair["jst"], jnp.asarray(acts))
    got = tt.pre_physics(pp_pair["tst"], torch.as_tensor(acts))
    np.testing.assert_allclose(got.tau.numpy(), np.asarray(ref.tau),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(got.pos_target.numpy(),
                                  np.asarray(ref.pos_target))
    np.testing.assert_array_equal(got.grab_active.numpy(),
                                  np.asarray(ref.grab_active))
    expect = np.zeros((N, 4), np.float32)
    expect[d["grab_envs"][:, None], [0, 3]] = 1.0
    np.testing.assert_array_equal(got.grab_active.numpy(), expect)


@pytest.mark.parametrize("task", ["ppma", "combine"])
def test_post_physics_matches_jax(pp_pair, cm_pair, task):
    """``post_physics`` on each engine's own readout of the capture's state
    with its first actions (the holding agents in FSM stage 2 or 3), and on
    fabricated readouts with cubes near, over and off the pads: obs (the
    proximity FSM and, at Combine, the agent-index column), reward,
    time-outs and FSM."""
    pair = pp_pair if task == "ppma" else cm_pair
    jt, tt, d = pair["jt"], pair["tt"], pair["d"]
    jout = jt.engine.forward(pair["jst"].sim)
    tout = tt.engine.forward(pair["tst"].sim)
    ref = compare_post_physics(jt, tt, pair["jst"], pair["tst"], jout, tout,
                               d["actions"][0], 1e-5)
    assert (np.asarray(ref[4].fsm)[d["grab_envs"]] >= 2).all()
    if task == "combine":
        np.testing.assert_array_equal(np.asarray(ref[0])[:, -1],
                                      np.tile([0.0, 1.0], N))
    q, prog, jout, tout, actions = fabricated_readout(jt, tt, d, 3)
    # half the cubes over their pads
    for k, qa in enumerate(jt.cube_q_adr):
        q[::2, qa: qa + 3] = np.asarray(jt.dest_pos)[k] + np.float32(
            [0.01, 0.0, 0.03])
    jst = pair["jst"]._replace(
        sim=JSimState(jnp.asarray(q), jnp.asarray(d["init_qd"])),
        progress=jnp.asarray(prog))
    tst = pair["tst"]._replace(
        sim=SimState(torch.as_tensor(q), torch.as_tensor(d["init_qd"])),
        progress=torch.as_tensor(prog))
    ref = compare_post_physics(jt, tt, jst, tst, jout, tout, actions, 1e-6)
    assert len(np.unique(np.asarray(ref[4].fsm))) >= 3
    assert (np.asarray(ref[0])[:, -1 if task == "ppma" else -2] == -1).any()
