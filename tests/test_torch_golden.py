"""Replay of the committed JAX golden captures on the port's CPU twins.

tests/data/torch_port/ant_golden.npz, ball_balance_golden.npz and
franka_reach_ma_golden.npz (scripts/record_torch_golden.py): the task at 64
envs (FrankaReachMA: 16 envs x 2 arms), 6 steps of fixed actions from a
warmed-up state (Ant's feet on the ground, BallBalance's balls on the
trays, FrankaReachMA's cubes on the table), a quarter of the envs reset on
step 1 with the recorded JAX reset draws; franka_reach_ma_b4_golden.npz
(``--kernel-route``) the same for FrankaReachMA at 128 envs x 2 arms on
the JAX contact-kernel route (Pallas interpret mode: all 41 candidate rows,
no compaction or row reuse), replayed on the port's B4 route.
chip_smoke.py replays the same files through the CUDA kernels.

The per-step tolerances and their reasons are parity.GOLDEN_TOL's (Ant),
parity.BB_GOLDEN_TOL's (BallBalance) and parity.FRANKA_GOLDEN_TOL's
(FrankaReachMA).
"""
import os

import numpy as np

import pytest

from isaacgymenvs_ma_tpu_torch.utils.parity import (
    BB_GOLDEN_TOL, FRANKA_GOLDEN_TOL, GOLDEN_TOL, replay)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
GOLDEN = os.path.join(DATA, "ant_golden.npz")
BB_GOLDEN = os.path.join(DATA, "ball_balance_golden.npz")
FRANKA_GOLDEN = os.path.join(DATA, "franka_reach_ma_golden.npz")
FRANKA_B4_GOLDEN = os.path.join(DATA, "franka_reach_ma_b4_golden.npz")


def test_golden_capture_format():
    d = np.load(GOLDEN)
    T, N = d["actions"].shape[:2]
    assert (T, N) == (6, 64) and str(d["task"]) == "Ant"
    assert d["obs"].shape == (T, N, 60) and d["q"].shape == (T, N, 15)
    assert d["reset_pos"].shape == d["reset_vel"].shape == (T, N, 8)
    assert int(d["init_reset_buf"].sum()) == N // 4
    # the feet are on the ground: the force-sensor observations are live
    assert float(np.abs(d["obs"][:, :, 28:52]).max()) > 1.0


def test_golden_replay_on_cpu_twins():
    e = replay(GOLDEN, "cpu")
    assert e.finite
    for k, tol in GOLDEN_TOL.items():
        errs = getattr(e, k)
        assert (errs <= tol).all(), f"{k} per-step errors {errs} > {tol}"
    assert int(e.reset_mismatches.sum()) == 0


def test_ball_balance_golden_capture_format():
    d = np.load(BB_GOLDEN)
    T, N = d["actions"].shape[:2]
    assert (T, N) == (6, 64) and str(d["task"]) == "BallBalance"
    assert d["obs"].shape == (T, N, 24) and d["q"].shape == (T, N, 20)
    assert d["init_dof_position_targets"].shape == (N, 6)
    assert d["reset_dirs"].shape == (T, N, 2)
    assert d["reset_height"].shape == (T, N)
    assert int(d["init_reset_buf"].sum()) == N // 4
    # the balls rest on the trays: the tray force sensors read the pair row
    assert float(np.abs(d["obs"][:, :, 12:]).max()) > 1.0
    assert os.path.getsize(BB_GOLDEN) < 200_000


@pytest.mark.parametrize("kernel_route", [False, True],
                         ids=["default_loop", "contact_kernel"])
def test_ball_balance_golden_replay_on_cpu_twins(kernel_route):
    e = replay(BB_GOLDEN, "cpu", use_contact_kernel=kernel_route)
    assert e.finite
    for k, tol in BB_GOLDEN_TOL.items():
        errs = getattr(e, k)
        assert (errs <= tol).all(), f"{k} per-step errors {errs} > {tol}"
    assert int(e.reset_mismatches.sum()) == 0


def test_franka_reach_ma_golden_capture_format():
    d = np.load(FRANKA_GOLDEN)
    T, B = d["actions"].shape[:2]
    N = d["init_q"].shape[0]
    assert (T, N, B) == (6, 16, 32) and str(d["task"]) == "FrankaReachMA"
    assert d["obs"].shape == (T, B, 19) and d["q"].shape == (T, N, 32)
    assert d["init_actions"].shape == (B, 6)
    assert d["dof_noise"].shape == (T, N, 2, 9)
    assert d["cube_xy_u"].shape == (T, N, 2, 2)
    assert d["cube_z_u"].shape == (T, N, 2)
    assert int(d["init_reset_buf"].sum()) == N // 4
    # most cubes of the envs not reset rest on the table (centre at the
    # surface plus half the 5 cm cube; q index 2 of each cube's free joint)
    z = d["init_q"][N // 4:, [20, 27]]
    assert (np.abs(z - (1.025 + 0.025)) < 1e-2).mean() > 0.75
    assert os.path.getsize(FRANKA_GOLDEN) < 100_000


def test_franka_reach_ma_golden_replay_on_cpu_twins():
    e = replay(FRANKA_GOLDEN, "cpu")
    assert e.finite
    for k, tol in FRANKA_GOLDEN_TOL.items():
        errs = getattr(e, k)
        assert (errs <= tol).all(), f"{k} per-step errors {errs} > {tol}"
    assert int(e.reset_mismatches.sum()) == 0


def test_franka_reach_ma_b4_golden_capture_format():
    d = np.load(FRANKA_B4_GOLDEN)
    T, B = d["actions"].shape[:2]
    N = d["init_q"].shape[0]
    assert (T, N, B) == (6, 128, 256) and str(d["task"]) == "FrankaReachMA"
    assert d["obs"].shape == (T, B, 19) and d["q"].shape == (T, N, 32)
    assert d["dof_noise"].shape == (T, N, 2, 9)
    assert int(d["init_reset_buf"].sum()) == N // 4
    assert os.path.getsize(FRANKA_B4_GOLDEN) < 500_000


def test_franka_reach_ma_b4_golden_replay_on_cpu_twins():
    """On the B4 route (its twin on the CPU), at FRANKA_GOLDEN_TOL."""
    e = replay(FRANKA_B4_GOLDEN, "cpu", use_contact_kernel=True)
    assert e.finite
    for k, tol in FRANKA_GOLDEN_TOL.items():
        errs = getattr(e, k)
        assert (errs <= tol).all(), f"{k} per-step errors {errs} > {tol}"
    assert int(e.reset_mismatches.sum()) == 0
