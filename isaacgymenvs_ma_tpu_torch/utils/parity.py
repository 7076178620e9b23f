"""Replay of recorded JAX trajectories on the port (counterpart of
isaacgymenvs_ma_tpu/utils/parity.py).

Capture format: the JAX package's ``.npz`` fields (``task``, ``actions``
(T, B, A), ``obs`` (T, B, O), ``rew`` (T, B), ``reset`` (T, B), ``init_q``,
``init_qd``, ``atol``; B = N envs times the task's agents) plus what the
port needs to replay a trajectory across resets, whose RNG streams differ
between the two packages:

    init_progress, init_reset_buf       (N,) int32
    init_<field>                        each field of the task state, e.g.
                                        Ant's init_potentials (N,), or
                                        BallBalance's
                                        init_dof_position_targets (N, 6)
                                        (none for Cartpole, which has no
                                        task state)
    <draw>                              (T, N, ...) the reset draws of every
                                        step, named in RESET_DRAWS
    q, qd                               (T, N, nq|nv) f32  per-step state

``scripts/record_torch_golden.py`` writes such files from the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import deep_merge

from ..convert import env_state_from_jax
from ..tasks import ant, ball_balance, cartpole, franka_reach_ma

# name -> (task class, configuration, task-state class or None)
TASKS = {"Ant": (ant.Ant, ant.TASK_CFG, ant.AntTaskState),
         "BallBalance": (ball_balance.BallBalance, ball_balance.TASK_CFG,
                         ball_balance.BBTaskState),
         "FrankaReachMA": (franka_reach_ma.FrankaReachMA,
                           franka_reach_ma.TASK_CFG,
                           franka_reach_ma.FrankaMATaskState),
         "Cartpole": (cartpole.Cartpole, cartpole.TASK_CFG, None)}
# capture keys of each task's reset draws, in reset_idx's order
RESET_DRAWS = {"Ant": ("reset_pos", "reset_vel"),
               "BallBalance": ("reset_dists", "reset_dirs", "reset_hspeeds",
                               "reset_height"),
               "FrankaReachMA": ("dof_noise", "cube_xy_u", "cube_z_u"),
               "Cartpole": ("reset_pos", "reset_vel")}

# Per-step max abs error bounds of the Ant golden replay
# (tests/data/torch_port/ant_golden.npz).  Measured on the CPU twins over
# its 6 steps: q 7e-7 -> 8e-5, qd 4e-5 -> 2.6e-3, obs 2e-5 -> 5e-4 (contact
# rows amplify float32 rounding roughly tenfold every two steps); reward
# differs by one float32 ulp of the ~6e4 potential (3.9e-3).  Resets exact.
GOLDEN_TOL = {"q": 2e-4, "qd": 1e-2, "obs": 2e-3, "rew": 1e-2}
# Per-step bounds of the BallBalance replay
# (tests/data/torch_port/ball_balance_golden.npz), on the default loop and
# on kernel B4.  Measured on the CPU twins over its 6 steps: q 2.8e-6 ->
# 1.5e-5 (the B4 route; 6.9e-6 on the default loop), qd <= 6.4e-4, obs <=
# 9.8e-5, reward <= 1.1e-5; resets exact.  q, qd and obs are held at Ant's
# bounds (the same float32 amplification through the contact rows, and the
# card sums in other orders); the reward has no large potential in it and
# is held at 2e-4, twenty times the measured error.
BB_GOLDEN_TOL = {"q": 2e-4, "qd": 1e-2, "obs": 2e-3, "rew": 2e-4}
# Per-step bounds of the FrankaReachMA replay
# (tests/data/torch_port/franka_reach_ma_golden.npz, 16 envs x 2 arms, on
# the default loop with compaction and row reuse).  Measured over its 6
# steps on the CPU twins and through the kernels on an H100 (chip_smoke.py):
# q <= 1.7e-6, qd <= 8.1e-5, obs <= 7.9e-7, reward <= 9.5e-7; resets exact.
# The arms' joints are damped and most cubes rest, so float32 differences
# do not grow step by step as at Ant; each bound is about ten times the
# largest error seen, for the card's other summation orders.  The same
# bounds hold the kernel-route capture (franka_reach_ma_b4_golden.npz, 128
# envs x 2 arms, all 41 rows through B4): on the CPU twins q <= 5.5e-6,
# qd <= 2.8e-4, obs <= 3.8e-6, reward <= 2.9e-6; through the kernels on an
# H100 q <= 2.1e-6, qd <= 3.4e-4, obs <= 1.5e-6, reward <= 1.2e-6.
FRANKA_GOLDEN_TOL = {"q": 2e-5, "qd": 1e-3, "obs": 1e-5, "rew": 1e-5}
# Per-step bounds of the Cartpole replay (tests/data/torch_port/
# cartpole_golden.npz: tests/test_golden_cartpole.py's rollout, 64 envs,
# 101 steps, every env reset on step 1, ~400 resets in all).  Measured on
# the CPU twins: q <= 8.3e-6, qd <= 1.4e-4, obs <= 1.4e-4 (the largest at
# step 50, where the poles swing fastest), reward <= 1.6e-5; resets exact.
# The port rounds otherwise than the JAX XLA path that recorded it (a
# sweep where JAX takes the closed-form 2x2 inverse) and Cartpole is
# unstable about its upright pose, so the gap grows and shrinks with the
# motion; each bound is 10-15 times the largest error seen, for the card's
# other summation orders.
CARTPOLE_GOLDEN_TOL = {"q": 1e-4, "qd": 2e-3, "obs": 2e-3, "rew": 2e-4}
TOLERANCES = {"Ant": GOLDEN_TOL, "BallBalance": BB_GOLDEN_TOL,
              "FrankaReachMA": FRANKA_GOLDEN_TOL,
              "Cartpole": CARTPOLE_GOLDEN_TOL}


class StepErrors(NamedTuple):
    """Per-step max abs errors of the replay against the capture."""

    q: np.ndarray          # (T,)
    qd: np.ndarray
    obs: np.ndarray
    rew: np.ndarray
    reset_mismatches: np.ndarray   # (T,) int
    finite: bool


def replay(npz_path: str, device, use_contact_kernel: bool = False
           ) -> StepErrors:
    """Replay a capture on ``device`` with the recorded reset draws; with
    ``use_contact_kernel`` the contact loop runs through kernel B4."""
    d = np.load(npz_path, allow_pickle=False)
    name = str(d["task"])
    if name not in TASKS:
        raise ValueError(f"no replay for task {name!r}")
    cls, task_cfg, state_cls = TASKS[name]
    T, N = d["actions"].shape[0], d["init_q"].shape[0]
    cfg = deep_merge(task_cfg, {"env": {"numEnvs": int(N)}})
    params = None
    if use_contact_kernel:
        from ..tasks.base import parse_sim_params
        params = parse_sim_params(cfg["sim"])._replace(use_contact_kernel=True)
    task = cls(cfg, device=device, sim_params=params)
    arrays = {"sim.q": d["init_q"], "sim.qd": d["init_qd"],
              "progress": d["init_progress"],
              "reset_buf": d["init_reset_buf"]}
    if state_cls is not None:
        arrays.update({f"task.{f}": d[f"init_{f}"]
                       for f in state_cls._fields})
    state = env_state_from_jax(arrays, device)
    t_ = lambda x: torch.as_tensor(np.asarray(x), device=device)  # noqa: E731
    errs = {k: np.zeros(T) for k in ("q", "qd", "obs", "rew")}
    mism = np.zeros(T, np.int64)
    finite = True
    for t in range(T):
        draws = tuple(t_(d[k][t]) for k in RESET_DRAWS[name])
        state, res = task.step(state, t_(d["actions"][t]), reset_draws=draws)
        got = {"q": state.sim.q, "qd": state.sim.qd, "obs": res.obs,
               "rew": res.rew}
        for k, v in got.items():
            v = v.detach().cpu().numpy()
            finite &= bool(np.isfinite(v).all())
            errs[k][t] = float(np.abs(v - d[k][t]).max())
        mism[t] = int((res.reset.cpu().numpy() != d["reset"][t]).sum())
    return StepErrors(q=errs["q"], qd=errs["qd"], obs=errs["obs"],
                      rew=errs["rew"], reset_mismatches=mism, finite=finite)
