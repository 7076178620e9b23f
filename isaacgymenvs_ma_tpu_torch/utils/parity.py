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
from ..tasks import (ant, ball_balance, cartpole, franka_collect_ma,
                     franka_combine_ma, franka_ppma, franka_reach_ma)

# name -> (task class, configuration, task-state class or None)
TASKS = {"Ant": (ant.Ant, ant.TASK_CFG, ant.AntTaskState),
         "BallBalance": (ball_balance.BallBalance, ball_balance.TASK_CFG,
                         ball_balance.BBTaskState),
         "FrankaReachMA": (franka_reach_ma.FrankaReachMA,
                           franka_reach_ma.TASK_CFG,
                           franka_reach_ma.FrankaMATaskState),
         "FrankaCollectMA": (franka_collect_ma.FrankaCollectMA,
                             franka_collect_ma.TASK_CFG,
                             franka_collect_ma.CollectTaskState),
         "FrankaPPMA": (franka_ppma.FrankaPPMA, franka_ppma.TASK_CFG,
                        franka_collect_ma.CollectTaskState),
         "FrankaCombineMA": (franka_combine_ma.FrankaCombineMA,
                             franka_combine_ma.TASK_CFG,
                             franka_collect_ma.CollectTaskState),
         "Cartpole": (cartpole.Cartpole, cartpole.TASK_CFG, None)}
# capture keys of each task's reset draws, in reset_idx's order
RESET_DRAWS = {"Ant": ("reset_pos", "reset_vel"),
               "BallBalance": ("reset_dists", "reset_dirs", "reset_hspeeds",
                               "reset_height"),
               "FrankaReachMA": ("dof_noise", "cube_xy_u", "cube_z_u"),
               "FrankaCollectMA": ("dof_noise", "cube_xy_u", "cube_z_u"),
               "FrankaPPMA": ("dof_noise", "cube_xy_u", "cube_z_u"),
               "FrankaCombineMA": ("dof_noise", "cube_xy_u", "cube_z_u"),
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
# Per-step bounds of the replays of the MA captures with live grabs
# (franka_collect_ma_golden.npz and franka_ppma_golden.npz, 16 envs x 2
# arms, 10 steps on the default loop; franka_collect_ma_b4_golden.npz, 128
# envs x 2 arms, 6 steps on the B4 route; each agent of envs N/4 .. 3N/4
# holding its cube).  FRANKA_GOLDEN_TOL does not hold them: on the CPU
# twins q reaches 2.0e-5, qd 1.8e-3 on the loop and 4.6e-3 on B4, obs
# 2.0e-5 (PPMA's obs carry the cubes' quaternions) and reward 2.6e-6,
# every largest error on a held cube's rotation.  A grab pins the cube's
# centre to the grip site, so its row Jacobian on the cube's angular dofs
# is S_lin + S_ang x p_m = e x (p_m - p_cube): two cross products of ~1 m
# points that cancel to ~1e-8.  The two packages' FK round p_cube ~1e-7
# apart, and the cube's rotational H^-1 (~1e4) turns that into ~1e-3 of
# angular velocity each step, which the unconstrained rotation carries
# on.  The q and obs bounds are ten times the largest error seen, qd's
# six and the reward's eight, for the card's other summation orders.
FRANKA_GRAB_GOLDEN_TOL = {"q": 2e-4, "qd": 3e-2, "obs": 2e-4, "rew": 2e-5}
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
              "FrankaCollectMA": FRANKA_GRAB_GOLDEN_TOL,
              "FrankaPPMA": FRANKA_GRAB_GOLDEN_TOL,
              "FrankaCombineMA": FRANKA_GRAB_GOLDEN_TOL,
              "Cartpole": CARTPOLE_GOLDEN_TOL}


def live_grabs(task, state, actions, envs):
    """Make the grab constraints of an MA task live in ``envs`` (the
    counterpart of scripts/record_torch_golden.py's ``live_grabs``): agent
    k's cube k moved onto agent k's grip site and at rest, and those
    agents' gripper actions (column 6 of ``actions`` (..., B, 7), changed
    in place) negative.  A tanh or random policy almost never closes a
    gripper within 2.25 cm of a cube, so grab rows would otherwise do no
    work.  Returns the new state."""
    K = task.num_agents
    envs = torch.as_tensor(envs, device=state.sim.q.device)
    grip = task.engine.kinematics(state.sim.q)[0][:, task._grip_bodies_t]
    q, qd = state.sim.q.clone(), state.sim.qd.clone()
    for k in range(K):
        qa, va = int(task.cube_q_adr[k]), int(task.cube_v_adr[k])
        q[envs, qa: qa + 3] = grip[envs, k]
        qd[envs, va: va + 6] = 0.0
    rows = (envs[:, None] * K + torch.arange(K, device=envs.device)
            ).reshape(-1)
    actions[..., rows, 6] = -actions[..., rows, 6].abs()
    return state._replace(sim=state.sim._replace(q=q, qd=qd))


class StepErrors(NamedTuple):
    """Per-step max abs errors of the replay against the capture."""

    q: np.ndarray          # (T,)
    qd: np.ndarray
    obs: np.ndarray
    rew: np.ndarray
    reset_mismatches: np.ndarray   # (T,) int
    finite: bool
    grabs_live: np.ndarray         # (T,) grab constraints on in each step


def replay(npz_path: str, device, use_contact_kernel: bool = False
           ) -> StepErrors:
    """Replay a capture on ``device`` with the recorded reset draws; with
    ``use_contact_kernel`` the contact loop runs through kernel B4.  For a
    task with grab constraints it also counts the grabs its control turns
    on in each step."""
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
    grabs = torch.zeros(T, device=device)
    finite = True
    if task.engine.grabs:
        pre = task.pre_physics

        def counted(state, actions):
            ctrl = pre(state, actions)
            grabs[t] = ctrl.grab_active.sum()
            return ctrl

        task.pre_physics = counted
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
                      rew=errs["rew"], reset_mismatches=mism, finite=finite,
                      grabs_live=grabs.cpu().numpy())
