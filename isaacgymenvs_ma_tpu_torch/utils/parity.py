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
                                        step, named in RESET_DRAWS, and of
                                        the tasks that draw in
                                        post_physics those draws, named in
                                        STEP_DRAWS, and in pre_physics
                                        (the object forces of
                                        AllegroKuka and the hands), named
                                        in PRE_DRAWS
    q, qd                               (T, N, nq|nv) f32  per-step state

and, for a task with per-env physics scales (Trifinger's domain
randomization, AllegroKuka's cuboid sizes), ``init_phys_<leaf>`` (the JAX
``PhysScales`` leaves the run starts from); for one with domain
randomization also, per step
``dr_actions`` (T, B, A) and ``dr_observations`` (T, B, O) (the white
noise samples) and ``dr_phys_<leaf>`` (every env's fresh scales);
``traj_spread_<k>`` (T,) where a capture carries the reference's own
spread over its trajectory (FrankaCubeStack, FrankaCubeStack2).

``scripts/record_torch_golden.py`` writes such files from the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import deep_merge

from ..convert import env_state_from_jax, phys_from_jax
from ..tasks import (allegro_kuka, anymal, anymal_terrain, ant,
                     ball_balance, cartpole,
                     franka_cabinet, franka_collect_ma, franka_combine_ma,
                     franka_cube_stack, franka_cube_stack2, franka_ppma,
                     franka_reach, franka_reach_ma, humanoid, ingenuity,
                     quadcopter, registry, shadow_hand, trifinger)

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
         "Cartpole": (cartpole.Cartpole, cartpole.TASK_CFG, None),
         "Humanoid": (humanoid.Humanoid, humanoid.TASK_CFG,
                      humanoid.HumanoidTaskState),
         "Anymal": (anymal.Anymal, anymal.TASK_CFG, anymal.AnymalTaskState),
         "AnymalTerrain": (anymal_terrain.AnymalTerrain,
                           anymal_terrain.TASK_CFG,
                           anymal_terrain.ATTaskState),
         "Ingenuity": (ingenuity.Ingenuity, ingenuity.TASK_CFG,
                       ingenuity.IngenuityTaskState),
         "Quadcopter": (quadcopter.Quadcopter, quadcopter.TASK_CFG,
                        quadcopter.QuadTaskState),
         "FrankaReach": (franka_reach.FrankaReach, franka_reach.TASK_CFG,
                         franka_reach_ma.FrankaMATaskState),
         "FrankaCabinet": (franka_cabinet.FrankaCabinet,
                           franka_cabinet.TASK_CFG,
                           franka_cabinet.CabinetTaskState),
         "FrankaCubeStack": (franka_cube_stack.FrankaCubeStack,
                             franka_cube_stack.TASK_CFG,
                             franka_cube_stack.CubeStackTaskState),
         "FrankaCubeStack2": (franka_cube_stack2.FrankaCubeStack2,
                              franka_cube_stack2.TASK_CFG,
                              franka_cube_stack.CubeStackTaskState),
         "Trifinger": (trifinger.Trifinger, trifinger.TASK_CFG,
                       trifinger.TrifingerTaskState),
         "AllegroKuka": (allegro_kuka.AllegroKukaReorientation,
                         allegro_kuka.TASK_CFG, allegro_kuka.KukaTaskState),
         "AllegroKukaTwoArms": (
             allegro_kuka.AllegroKukaTwoArmsReorientation,
             allegro_kuka.TASK_CFG, allegro_kuka.KukaTaskState)}
# the hands, their configuration variants by registry name
HANDS = ("ShadowHand", "AllegroHand", "ShadowHandOpenAI_FF",
         "AllegroHandLSTM")
TASKS.update({h: (registry.task_class(h), registry.task_default_config(h),
                  shadow_hand.HandTaskState) for h in HANDS})
KUKA_RESET_DRAWS = ("goal_pos_u", "goal_quat_u", "dof_u", "dof_vel_u",
                    "obj_pos_u", "obj_quat_u", "force_prob_u")
# capture keys of each task's reset draws, in reset_idx's order
RESET_DRAWS = {"Ant": ("reset_pos", "reset_vel"),
               "BallBalance": ("reset_dists", "reset_dirs", "reset_hspeeds",
                               "reset_height"),
               "FrankaReachMA": ("dof_noise", "cube_xy_u", "cube_z_u"),
               "FrankaCollectMA": ("dof_noise", "cube_xy_u", "cube_z_u"),
               "FrankaPPMA": ("dof_noise", "cube_xy_u", "cube_z_u"),
               "FrankaCombineMA": ("dof_noise", "cube_xy_u", "cube_z_u"),
               "Cartpole": ("reset_pos", "reset_vel"),
               "Humanoid": ("reset_pos", "reset_vel"),
               "Anymal": ("reset_pos_u", "reset_vel", "cmd_x", "cmd_y",
                          "cmd_yaw"),
               "AnymalTerrain": ("reset_pos_u", "reset_vel", "xy_noise",
                                 "cmd_x", "cmd_y", "cmd_yaw"),
               "Ingenuity": ("off_xy", "off_z", "target_xy_u", "target_z_u"),
               "Quadcopter": ("off_xy", "off_z", "reset_dof"),
               "FrankaReach": ("dof_noise", "cube_xy_u", "cube_z_u"),
               "FrankaCabinet": ("dof_u",),
               "FrankaCubeStack": ("dof_noise", "cube_xy_u", "cube_z_u"),
               "FrankaCubeStack2": ("dof_noise", "cube_xy_u", "cube_z_u",
                                    "cube_a_dz_u"),
               "Trifinger": ("dof_pos_n", "dof_vel_n", "obj_r_u", "obj_th",
                             "obj_yaw", "goal_r_u", "goal_th", "goal_z",
                             "goal_yaw", "goal_quat_u"),
               "AllegroKuka": KUKA_RESET_DRAWS,
               "AllegroKukaTwoArms": KUKA_RESET_DRAWS,
               **{h: ("obj_pos_n", "obj_rot_ang", "dof_u", "goal_rot_ang")
                  for h in HANDS}}
# capture keys of the draws post_physics makes, in its order
STEP_DRAWS = {"AnymalTerrain": ("push_vel", "noise_u"),
              "Ingenuity": ("retarget_xy_u", "retarget_z_u"),
              **{h: ("new_goal_ang",) for h in HANDS}}
# capture keys of the draws pre_physics makes, in its order
PRE_DRAWS = {"AllegroKuka": ("force_fire_u", "force_n"),
             "AllegroKukaTwoArms": ("force_fire_u", "force_n"),
             **{h: ("force_fire_u", "force_n") for h in HANDS}}

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
# Humanoid (humanoid_golden.npz, 32 envs, 6 steps, compaction to 16 of 35
# rows) is held at GOLDEN_TOL: on the CPU twins q <= 1.5e-5, qd <= 7.1e-4,
# obs <= 1.7e-4 (default loop and B4), and the reward differs by one or two
# float32 ulps of its ~6e4 potential (<= 5.4e-3), as Ant's (ROADMAP C4).
# Per-step bounds of the Anymal replay (anymal_golden.npz, 32 envs, 6
# steps, compaction to 16 of 68 rows; B4 solves all 68).  Measured on the
# CPU twins: q <= 1.2e-6, qd <= 1.1e-4, obs <= 9.3e-6, reward <= 1.8e-8;
# resets exact.  Each bound is ten to twenty times the largest error seen.
ANYMAL_GOLDEN_TOL = {"q": 2e-5, "qd": 2e-3, "obs": 1e-4, "rew": 1e-6}
# Per-step bounds of the aerial replays (ingenuity_golden.npz and
# quadcopter_golden.npz, 32 envs, 6 steps, the rotors' thrust through
# f_ext).  Measured on the CPU twins: Ingenuity q <= 6.0e-7, qd <= 2.7e-5,
# obs <= 8.7e-6, reward <= 4.8e-7; Quadcopter (kp 1000 drives on 0.01 kg
# rotor arms) q <= 1.6e-5, qd <= 6.0e-4, obs <= 1.9e-4, reward <= 2.9e-5;
# resets exact.  Both are held at about ten times Quadcopter's errors.
AERIAL_GOLDEN_TOL = {"q": 2e-4, "qd": 1e-2, "obs": 2e-3, "rew": 3e-4}
# AnymalTerrain (anymal_terrain_golden.npz, 32 envs, 6 steps, a push of
# every base in step 3) is held one step at a time with each env's error
# taken beyond four times the reference's own spread under one-ulp noise
# on q and qd, and the median over the envs held at these bounds (Ant's).
# The published map puts the robots 30-180 m from the world origin, where
# the engine's world-origin dynamics cancel: one ulp on q moves the JAX
# step's q by ~1e-3 in the median env and by up to 1e-1 (or flips a
# reset) in a few (ROADMAP C8).  On the CPU twins the port's error is about
# that spread (err / spread: median 0.8-1.5, largest 3.5-8.6 over the
# envs) and the median excess is 0; resets differ in at most one held env
# a step.  Tight parity on terrain is held near the world origin instead
# (tests/test_torch_anymal.py).
ANYMAL_TERRAIN_GOLDEN_TOL = GOLDEN_TOL
# FrankaReach (franka_reach_golden.npz, 32 envs, 6 steps) is held at
# FRANKA_GOLDEN_TOL: on the CPU twins q <= 2.1e-6, qd <= 5.6e-5, obs <=
# 1.8e-6, reward <= 1.9e-6 (on the B4 route, which solves all 24 rows
# without reuse: q <= 2.1e-6, qd <= 5.6e-5, obs <= 1.8e-6).
# FrankaCubeStack and FrankaCubeStack2 (32 envs, 10 steps, cube A held in
# half the envs) carry the reference's own spread over the trajectory
# (``traj_spread_*``, ROADMAP C9) and are held at FRANKA_GOLDEN_TOL beyond
# four times it (replay's ``traj_widening``): the port's errors track that
# spread (CubeStack2's q error 1.86e-4 at step 10 against a spread of
# 1.91e-4), which FRANKA_GOLDEN_TOL alone would not hold.
# The ground-rule bounds (ROADMAP: q rtol 2e-4 / atol 2e-5 with |q| <= 1,
# qd and obs 2e-3; the reward at 1e-3) hold FrankaCabinet's replays
# (franka_cabinet_golden.npz, 32 envs, 10 steps, the handle grabbed in
# half the envs; franka_cabinet_b4_golden.npz, 128 envs, 6 steps on the
# JAX kernel route) and Trifinger's (trifinger_golden.npz, 32 envs, 6
# steps with the shipped domain randomization: the recorded scales, noise
# and resampled friction injected).  On the CPU twins: FrankaCabinet q <=
# 3.3e-5, qd <= 7.3e-4, obs <= 7.3e-5, reward <= 1.1e-6; Trifinger q <=
# 2.4e-6, qd <= 6.7e-4, obs <= 3.6e-5, reward <= 8.6e-5.
GROUND_RULE_TOL = {"q": 2e-4, "qd": 2e-3, "obs": 2e-3, "rew": 1e-3}
# The AllegroKuka captures (allegro_kuka_golden.npz and
# allegro_kuka_two_arms_golden.npz, 32 envs; allegro_kuka_b4_golden.npz,
# 128 envs on the kernel route; 6 steps each) are held one step at a time,
# each env's error beyond four times the reference's own one-ulp spread
# there, the median over the envs at GROUND_RULE_TOL, as AnymalTerrain's:
# where a finger strikes, its 40 / 5 position drives on 0.005-0.13 kg
# links turn one ulp of q and qd into up to ~5e-2 of qd at one arm and ~1 at
# two.  Held over the whole 6 steps against the reference's trajectory
# spread instead, the card's replay of allegro_kuka_golden.npz passed it
# by 2.9e-3 in obs at the last step; at the first step the port's own
# one-ulp spread in each env is of the size of its error against JAX
# there (scripts/record_torch_golden.py ONE_STEP).
TOLERANCES = {"Ant": GOLDEN_TOL, "BallBalance": BB_GOLDEN_TOL,
              "FrankaReachMA": FRANKA_GOLDEN_TOL,
              "FrankaCollectMA": FRANKA_GRAB_GOLDEN_TOL,
              "FrankaPPMA": FRANKA_GRAB_GOLDEN_TOL,
              "FrankaCombineMA": FRANKA_GRAB_GOLDEN_TOL,
              "Cartpole": CARTPOLE_GOLDEN_TOL, "Humanoid": GOLDEN_TOL,
              "Anymal": ANYMAL_GOLDEN_TOL,
              "AnymalTerrain": ANYMAL_TERRAIN_GOLDEN_TOL,
              "Ingenuity": AERIAL_GOLDEN_TOL,
              "Quadcopter": AERIAL_GOLDEN_TOL,
              "FrankaReach": FRANKA_GOLDEN_TOL,
              "FrankaCabinet": GROUND_RULE_TOL,
              "FrankaCubeStack": FRANKA_GOLDEN_TOL,
              "FrankaCubeStack2": FRANKA_GOLDEN_TOL,
              "Trifinger": GROUND_RULE_TOL,
              "AllegroKuka": GROUND_RULE_TOL,
              "AllegroKukaTwoArms": GROUND_RULE_TOL,
              **{h: GROUND_RULE_TOL for h in HANDS}}
# The hands' captures (shadow_hand_golden.npz, allegro_hand_golden.npz,
# shadow_hand_openai_ff_golden.npz, allegro_hand_lstm_golden.npz; 32
# envs, 6 steps on the mass-splitting loop) are held one step at a time as
# the AllegroKuka ones, at GROUND_RULE_TOL.  On the CPU twins every held
# env's error is within it even before the widening: ShadowHand q <=
# 1.7e-6, qd <= 3.3e-4, obs <= 1.5e-4, reward <= 3.1e-5; AllegroHand q <=
# 2.3e-6, qd <= 2.5e-4, obs <= 5.1e-5, reward <= 2.1e-5; OpenAI_FF (3
# engine steps a step) q <= 1.8e-5, qd <= 1.3e-3, obs <= 1.7e-5, reward <=
# 2.3e-6; AllegroHandLSTM q <= 9.7e-7, qd <= 1.8e-4, obs <= 1.1e-6,
# reward <= 1.8e-6; resets exact.
# one-step captures: the most held envs per step whose reset may differ
# (a base contact force at the 1 N threshold, where the reference's noise
# reaches)
ONE_STEP_RESET_MISMATCHES = 2


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


def live_cabinet_grabs(task, state, actions, envs, iterations=30):
    """Make FrankaCabinet's handle grab live in ``envs`` (the counterpart
    of scripts/record_torch_golden.py's ``cabinet_live_grabs``): the arm's
    7 joints, from the default pose and within their limits, moved by
    damped least squares on the grip site's point Jacobian (steps of at
    most 0.2 rad) until the grip site sits on the handle, the arm at rest,
    and
    both finger actions (columns 7 and 8 of ``actions`` (..., N, 9),
    changed in place) negative: the grab's gate then holds.  Returns the
    new state."""
    eng = task.engine
    envs = torch.as_tensor(envs, device=state.sim.q.device)
    arm = task._franka_dofs_t[:7]
    qids = task._franka_qids_t[:7]
    q = state.sim.q.clone()
    q[envs[:, None], qids[None]] = task.default_dof[:7]
    lo, hi = task.dof_lower[:7], task.dof_upper[:7]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    for _ in range(iterations):
        body_x, body_q, S, _ = eng.kinematics(q)
        err = (task._handle(body_x, body_q) - body_x[:, task.grip_body])[envs]
        J = eng.point_jacobian(S, body_x, task.grip_body)[envs][:, arm, :3]
        JJt = J.transpose(1, 2) @ J + 1e-4 * eye                 # (E, 3, 3)
        dq = (J @ torch.linalg.solve(JJt, err[..., None]))[..., 0]
        q[envs[:, None], qids[None]] = torch.clamp(
            q[envs[:, None], qids[None]] + torch.clamp(dq, -0.2, 0.2), lo, hi)
    qd = state.sim.qd.clone()
    qd[envs[:, None], task._franka_dofs_t[None]] = 0.0
    actions[..., envs, 7:9] = -actions[..., envs, 7:9].abs()
    return state._replace(sim=state.sim._replace(q=q, qd=qd))


# a one-step capture's start_<key> -> env_state_from_jax's key prefix
_STATE_PREFIX = {"q": "sim.", "qd": "sim.", "progress": "", "reset_buf": ""}


class StepErrors(NamedTuple):
    """Per-step max abs errors of the replay against the capture; of a
    one-step capture (``spread_*`` keys), per step the median over the
    held envs of each env's error beyond four times the reference's own
    one-ulp spread there (``raw``: the largest errors themselves)."""

    q: np.ndarray          # (T,)
    qd: np.ndarray
    obs: np.ndarray
    rew: np.ndarray
    reset_mismatches: np.ndarray   # (T,) int
    finite: bool
    grabs_live: np.ndarray         # (T,) grab constraints on in each step
    raw: dict = None               # one-step captures: k -> (T,) max error
    wild_envs: np.ndarray = None   # (T,) envs the reference's noise makes
                                   # non-finite or flips the reset of
    # captures with the reference's trajectory spread (``traj_spread_*``):
    # k -> (T,) the largest errors themselves, and four times the spread,
    # by which each step's bound is widened (the errors above are beyond it)
    traj_raw: dict = None
    traj_widening: dict = None


def replay(npz_path: str, device, use_contact_kernel: bool = False
           ) -> StepErrors:
    """Replay a capture on ``device`` with the recorded reset draws (and
    ``pre_physics`` and ``post_physics`` draws); with ``use_contact_kernel`` the contact loop
    runs through kernel B4.  For a task with grab constraints it also
    counts the grabs its control turns on in each step.

    A capture with ``spread_*`` keys (AnymalTerrain's, see
    scripts/record_torch_golden.py ``ONE_STEP``) is replayed one step at a
    time, each step from the recorded state it started from; each env's
    error is taken beyond four times the reference's own move under
    one-ulp noise on q and qd there (the widening of chip_smoke.py's
    ``hold``), and the median of that over the envs is reported, since
    the reference's noise there is heavy-tailed (see
    ANYMAL_TERRAIN_GOLDEN_TOL).  Envs whose reference goes non-finite or
    flips its reset under that noise are not held (``wild_envs`` counts
    them).

    A capture with ``traj_spread_*`` keys is replayed whole, and each
    step's error is taken beyond four times the reference's own spread
    over the trajectory there (``traj_raw`` keeps the errors themselves).
    A capture of a task with domain randomization starts from its
    recorded scales and takes the recorded noise and resampled scales."""
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
    arrays.update({"phys." + k[len("init_phys_"):]: d[k] for k in d.files
                   if k.startswith("init_phys_")})
    state = env_state_from_jax(arrays, device, state_cls)
    one_step = "spread_q" in d
    widen = ({k: 4.0 * d[f"traj_spread_{k}"] for k in ("q", "qd", "obs",
                                                       "rew")}
             if "traj_spread_q" in d else None)
    dr_leaves = [k[len("dr_phys_"):] for k in d.files
                 if k.startswith("dr_phys_")]
    t_ = lambda x: torch.as_tensor(np.asarray(x), device=device)  # noqa: E731
    errs = {k: np.zeros(T) for k in ("q", "qd", "obs", "rew")}
    raw = {k: np.zeros(T) for k in errs}
    wild = np.zeros(T, np.int64)
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
        if one_step:
            start = {k[len("start_"):]: d[k][t] for k in d.files
                     if k.startswith("start_")}
            # the physics scales carry on (AllegroKuka's cuboid sizes)
            state = env_state_from_jax(
                {(_STATE_PREFIX.get(k, "task.") + k): v
                 for k, v in start.items()}, device, state_cls)._replace(
                    phys=state.phys)
        draws = tuple(t_(d[k][t]) for k in RESET_DRAWS[name])
        step_draws = (tuple(t_(d[k][t]) for k in STEP_DRAWS[name])
                      if name in STEP_DRAWS else None)
        pre_draws = (tuple(t_(d[k][t]) for k in PRE_DRAWS[name])
                     if name in PRE_DRAWS else None)
        dr = None
        if "dr_actions" in d:
            dr = {"actions": t_(d["dr_actions"][t]),
                  "observations": t_(d["dr_observations"][t]),
                  "phys": phys_from_jax({k: d[f"dr_phys_{k}"][t]
                                         for k in dr_leaves}, device)}
        state, res = task.step(state, t_(d["actions"][t]), reset_draws=draws,
                               step_draws=step_draws, dr_draws=dr,
                               pre_draws=pre_draws)
        got = {"q": state.sim.q, "qd": state.sim.qd, "obs": res.obs,
               "rew": res.rew}
        held = np.ones(N, bool)
        if one_step:
            held = ~d["spread_reset"][t] & np.all(
                [np.isfinite(d[f"spread_{k}"][t]) for k in errs], axis=0)
            wild[t] = int((~held).sum())
        for k, v in got.items():
            v = v.detach().cpu().numpy().reshape(N, -1)
            finite &= bool(np.isfinite(v[held]).all())
            e = np.abs(v - d[k][t].reshape(N, -1)).max(1)[held]
            raw[k][t] = float(e.max(initial=0.0))
            errs[k][t] = (float(np.median(np.maximum(
                e - 4.0 * d[f"spread_{k}"][t][held], 0.0))) if one_step
                else raw[k][t] if widen is None
                else max(raw[k][t] - float(widen[k][t]), 0.0))
        mism[t] = int((res.reset.cpu().numpy() != d["reset"][t]).reshape(
            N, -1)[held].sum())
    return StepErrors(q=errs["q"], qd=errs["qd"], obs=errs["obs"],
                      rew=errs["rew"], reset_mismatches=mism, finite=finite,
                      grabs_live=grabs.cpu().numpy(),
                      raw=raw if one_step else None,
                      wild_envs=wild if one_step else None,
                      traj_raw=None if widen is None else raw,
                      traj_widening=widen)
