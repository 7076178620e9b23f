"""Replay of recorded JAX trajectories on the port (counterpart of
isaacgymenvs_ma_tpu/utils/parity.py).

Capture format: the JAX package's ``.npz`` fields (``task``, ``actions``
(T, N, A), ``obs`` (T, N, O), ``rew`` (T, N), ``reset`` (T, N), ``init_q``,
``init_qd``, ``atol``) plus what the port needs to replay a trajectory
across resets, whose RNG streams differ between the two packages:

    init_progress, init_reset_buf           (N,) int32
    init_potentials, init_prev_potentials   (N,) f32   Ant task state
    init_actions                            (N, A) f32
    reset_pos, reset_vel                    (T, N, 8) f32  the reset draws
    q, qd                                   (T, N, nq|nv) f32  per-step state

``scripts/record_torch_golden.py`` writes such a file from the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from isaacgymenvs_ma_tpu.utils.config import deep_merge

from ..convert import env_state_from_jax
from ..tasks.ant import TASK_CFG, Ant


# Per-step max abs error bounds of the Ant golden replay
# (tests/data/torch_port/ant_golden.npz).  Measured on the CPU twins over
# its 6 steps: q 7e-7 -> 8e-5, qd 4e-5 -> 2.6e-3, obs 2e-5 -> 5e-4 (contact
# rows amplify float32 rounding roughly tenfold every two steps); reward
# differs by one float32 ulp of the ~6e4 potential (3.9e-3).  Resets exact.
GOLDEN_TOL = {"q": 2e-4, "qd": 1e-2, "obs": 2e-3, "rew": 1e-2}


class StepErrors(NamedTuple):
    """Per-step max abs errors of the replay against the capture."""

    q: np.ndarray          # (T,)
    qd: np.ndarray
    obs: np.ndarray
    rew: np.ndarray
    reset_mismatches: np.ndarray   # (T,) int
    finite: bool


def replay(npz_path: str, device) -> StepErrors:
    """Replay an Ant capture on ``device`` with the recorded reset draws."""
    d = np.load(npz_path, allow_pickle=False)
    if str(d["task"]) != "Ant":
        raise ValueError(f"only Ant captures can be replayed, got {d['task']}")
    T, N = d["actions"].shape[:2]
    task = Ant(deep_merge(TASK_CFG, {"env": {"numEnvs": int(N)}}),
               device=device)
    state = env_state_from_jax({
        "sim.q": d["init_q"], "sim.qd": d["init_qd"],
        "progress": d["init_progress"], "reset_buf": d["init_reset_buf"],
        "task.potentials": d["init_potentials"],
        "task.prev_potentials": d["init_prev_potentials"],
        "task.actions": d["init_actions"]}, device)
    t_ = lambda x: torch.as_tensor(np.asarray(x), device=device)  # noqa: E731
    errs = {k: np.zeros(T) for k in ("q", "qd", "obs", "rew")}
    mism = np.zeros(T, np.int64)
    finite = True
    for t in range(T):
        state, res = task.step(state, t_(d["actions"][t]),
                               reset_draws=(t_(d["reset_pos"][t]),
                                            t_(d["reset_vel"][t])))
        got = {"q": state.sim.q, "qd": state.sim.qd, "obs": res.obs,
               "rew": res.rew}
        for k, v in got.items():
            v = v.detach().cpu().numpy()
            finite &= bool(np.isfinite(v).all())
            errs[k][t] = float(np.abs(v - d[k][t]).max())
        mism[t] = int((res.reset.cpu().numpy() != d["reset"][t]).sum())
    return StepErrors(q=errs["q"], qd=errs["qd"], obs=errs["obs"],
                      rew=errs["rew"], reset_mismatches=mism, finite=finite)
