"""Replay of the committed JAX Ant golden capture on the port's CPU twins.

tests/data/torch_port/ant_golden.npz (scripts/record_torch_golden.py): Ant
at 64 envs, 6 steps of fixed actions from a warmed-up state with the feet
on the ground, a quarter of the envs reset on step 1 with the recorded JAX
reset draws.  chip_smoke.py replays the same file through the CUDA kernels.

The per-step tolerances and their reasons are parity.GOLDEN_TOL's.
"""
import os

import numpy as np

from isaacgymenvs_ma_tpu_torch.utils.parity import GOLDEN_TOL, replay

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_port", "ant_golden.npz")


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
