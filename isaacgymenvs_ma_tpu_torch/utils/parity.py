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
from ..tasks import (allegro_hand_dextreme, allegro_kuka, anymal, anymal_terrain, ant,
                     ball_balance, cartpole, factory,
                     franka_cabinet, franka_collect_ma, franka_combine_ma,
                     franka_cube_stack, franka_cube_stack2, franka_ppma,
                     franka_reach, franka_reach_ma, humanoid, humanoid_amp,
                     industreal, ingenuity, quadcopter, registry,
                     shadow_hand, trifinger)

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
# Dextreme, by registry name; its draws are packed into the task's
# PreDraws / StepDraws (``_pack_draws``)
DEXTREME = ("AllegroHandDextremeManualDR", "AllegroHandDextremeADR")
TASKS.update({d: (registry.task_class(d), registry.task_default_config(d),
                  allegro_hand_dextreme.DextremeTaskState)
              for d in DEXTREME})
# the Factory family and IndustReal, by registry name
FACTORY = ("FactoryTaskNutBoltPick", "FactoryTaskNutBoltPlace",
           "FactoryTaskNutBoltScrew", "FactoryTaskGears",
           "FactoryTaskInsertion")
INDUSTREAL = ("IndustRealTaskPegsInsert", "IndustRealTaskGearsInsert")
TASKS.update({f: (registry.task_class(f), registry.task_default_config(f),
                  factory.FactoryTaskState) for f in FACTORY})
TASKS.update({f: (registry.task_class(f), registry.task_default_config(f),
                  industreal.IndustRealTaskState) for f in INDUSTREAL})
# HumanoidAMP and its hands variant, by registry name
AMP = ("HumanoidAMP", "HumanoidAMPHands")
TASKS.update({a: (registry.task_class(a), registry.task_default_config(a),
                  humanoid_amp.AMPTaskState) for a in AMP})
FACTORY_IK_DRAWS = ("ft_pos_u", "ft_rot_u")
HAND_RESET_DRAWS = ("obj_pos_n", "obj_rot_ang", "dof_u", "goal_rot_ang")
DEXTREME_RESET_DRAWS = HAND_RESET_DRAWS + (
    "act_bias_n", "pos_bias_n", "dof_bias_n", "act_scale_n", "pos_scale_n",
    "dof_scale_n")
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
               **{h: HAND_RESET_DRAWS for h in HANDS},
               "AllegroHandDextremeManualDR": DEXTREME_RESET_DRAWS,
               "AllegroHandDextremeADR": ("adr_u",) + DEXTREME_RESET_DRAWS,
               "FactoryTaskNutBoltPick": FACTORY_IK_DRAWS + ("nut_xy_u",
                                                             "nut_yaw"),
               "FactoryTaskNutBoltPlace": FACTORY_IK_DRAWS,
               "FactoryTaskNutBoltScrew": (),
               "FactoryTaskGears": FACTORY_IK_DRAWS + ("obj_xy_u",),
               "FactoryTaskInsertion": FACTORY_IK_DRAWS + ("obj_xy_u",),
               **{f: FACTORY_IK_DRAWS + ("plug_xy_u", "disp_u")
                  for f in INDUSTREAL},
               **{a: ("motion_ids", "motion_times") for a in AMP}}
# capture keys of the draws post_physics makes, in its order
STEP_DRAWS = {"AnymalTerrain": ("push_vel", "noise_u"),
              "Ingenuity": ("retarget_xy_u", "retarget_z_u"),
              **{h: ("new_goal_ang",) for h in HANDS},
              **{d: ("new_goal_ang", "unreliable_u", "cam_pos_n",
                     "cam_axis_n", "cam_ang_n", "hold_u", "dof_obs_n")
                 for d in DEXTREME},
              **{f: ("goal_noise_n",) for f in INDUSTREAL}}
# capture keys of the draws pre_physics makes, in its order
PRE_DRAWS = {"AllegroKuka": ("force_fire_u", "force_n"),
             "AllegroKukaTwoArms": ("force_fire_u", "force_n"),
             **{h: ("force_fire_u", "force_n") for h in HANDS},
             **{d: ("act_noise_n", "rna_u", "delay_u", "mask_u_0",
                    "mask_u_1", "force_fire_u", "force_n")
                for d in DEXTREME}}

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
              **{h: GROUND_RULE_TOL for h in HANDS},
              **{d: GROUND_RULE_TOL for d in DEXTREME},
              **{f: GROUND_RULE_TOL for f in FACTORY + INDUSTREAL},
              **{a: GROUND_RULE_TOL for a in AMP}}
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
# The Dextreme captures (allegro_hand_dextreme_manual_dr_golden.npz and
# allegro_hand_dextreme_adr_golden.npz, 32 envs, 6 steps on the
# mass-splitting loop; the ADR one from widened ranges, with restitution
# and limit shifts in the engine) are held one step at a time as the
# hands', at GROUND_RULE_TOL.
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
_STATE_PREFIX = {"q": "sim.", "qd": "sim.", "progress": "", "reset_buf": "",
                 "lam_0": "sim.", "lam_1": "sim.", "lam_2": "sim."}


def _state_key(k: str) -> str:
    """env_state_from_jax's key of a capture's ``start_<k>`` /
    ``init_<k>`` state field (``lam_<i>``: the warm-start impulses)."""
    if k.startswith("lam_"):
        return "sim.lam." + k[len("lam_"):]
    return _STATE_PREFIX.get(k, "task.") + k


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
    # one-step captures: k -> (T,) the largest over the held envs of each
    # env's error beyond four times the reference's spread there
    excess_max: dict = None


def _pack_draws(name: str, kind: str, flat: tuple):
    """A hook's recorded draws as the task takes them: Dextreme's
    pre_physics / post_physics draws as its PreDraws / StepDraws, the
    other tasks' as the flat tuple."""
    if name not in DEXTREME or kind == "reset":
        return flat
    if kind == "pre":
        return allegro_hand_dextreme.PreDraws(
            noise=flat[0], rna_u=flat[1], delay_u=flat[2],
            mask_u=tuple(flat[3:5]), hand=tuple(flat[5:7]))
    return allegro_hand_dextreme.StepDraws(*flat)


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
    if "rl_max_episode_length" in d:
        # a capture recorded with a shortened episode (the Factory family:
        # Pick's epilogue on a recorded step)
        cfg = deep_merge(cfg, {"rl": {"max_episode_length": int(
            d["rl_max_episode_length"])}})
    task = cls(cfg, device=device, sim_params=params)
    arrays = {"sim.q": d["init_q"], "sim.qd": d["init_qd"],
              "progress": d["init_progress"],
              "reset_buf": d["init_reset_buf"]}
    arrays.update({_state_key(k[len("init_"):]): d[k] for k in d.files
                   if k.startswith("init_lam_")})
    if name in DEXTREME:
        # the nested state's keys (convert.dextreme_state_from_jax) and
        # the RNA's weights
        arrays.update({"task." + k[len("init_"):]: d[k] for k in d.files
                       if k.startswith("init_") and k[len("init_"):]
                       not in ("q", "qd", "progress", "reset_buf")})
        from ..convert import rna_state_dict_from_jax
        tree = {}
        for k in d.files:
            if k.startswith("rna_params."):
                _, layer, leaf = k.split(".")
                tree.setdefault(layer, {})[leaf] = d[k]
        task.rna.load_state_dict(
            {k: v.to(task.device)
             for k, v in rna_state_dict_from_jax(tree).items()})
    elif state_cls is not None:
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
    excess = {k: np.zeros(T) for k in errs}
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
                {_state_key(k): v for k, v in start.items()}, device,
                state_cls)._replace(
                    phys=state.phys)
        draws = tuple(t_(d[k][t]) for k in RESET_DRAWS[name])
        step_draws = (_pack_draws(name, "step", tuple(
            t_(d[k][t]) for k in STEP_DRAWS[name]))
            if name in STEP_DRAWS else None)
        pre_draws = (_pack_draws(name, "pre", tuple(
            t_(d[k][t]) for k in PRE_DRAWS[name]))
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
            if one_step:
                beyond = np.maximum(e - 4.0 * d[f"spread_{k}"][t][held], 0.0)
                excess[k][t] = float(beyond.max(initial=0.0))
            errs[k][t] = (float(np.median(beyond)) if one_step
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
                      traj_widening=widen,
                      excess_max=excess if one_step else None)


# ---------------------------------------------------------------------------
# The engine features of the Factory slice on a small scene of their own
# (tests/test_torch_factory_engine.py, scripts/record_torch_golden.py
# --factory-engine): two free blocks, each with a 4 x 4 point cloud on its
# bottom face and its top face, one resting on a plate whose collision
# field is a baked SDF grid, one on the ground; and a hinged rod pressed
# against its joint limit.  Both blocks' clouds give 64 ground rows, block
# A's 32 pair rows against the plate's grid: 96 rows x nv 13 = 1,248 reach
# the bfloat16 auto rule.  The blocks damp with 1.0 / 5.0, as the Factory
# Franka's links.
FACTORY_ENGINE_ENVS = 4
FACTORY_ENGINE_STEPS = 4
# case -> SimParams fields over FACTORY_ENGINE_PARAMS, and the body damping
FACTORY_ENGINE_CASES = {
    "warm_start": (dict(warm_start=0.9, solver_rows_bf16=False), False),
    "damping": (dict(warm_start=0.0, solver_rows_bf16=False), True),
    "bf16_auto": (dict(warm_start=0.0, solver_rows_bf16=None), False),
    "bf16_off": (dict(warm_start=0.0, solver_rows_bf16=False), False),
    # every feature at once, with active-set compaction to 40 rows (the
    # warm-start seeds gathered and scattered through its selection; the
    # rows forced to bfloat16: 40 x 13 is below the auto rule)
    "all_compacted": (dict(warm_start=0.9, solver_rows_bf16=True,
                           contact_capacity=40), True),
    # one substep of one iteration, with and without the rounding: over 32
    # iterations a bf16 rounding that float32 summation order flips grows
    # to the size of the rounding's own effect, so it is told apart here,
    # after a single product of each kind
    "bf16_one_iteration": (dict(warm_start=0.9, solver_rows_bf16=True,
                                substeps=1, num_iterations=1), False),
    "f32_one_iteration": (dict(warm_start=0.9, solver_rows_bf16=False,
                               substeps=1, num_iterations=1), False),
}
FACTORY_ENGINE_PARAMS = dict(dt=1.0 / 60.0, contact_margin=0.005,
                             mass_splitting=True,
                             max_depenetration_velocity=5.0)
FACTORY_ENGINE_SOLVE = dict(substeps=2, num_iterations=16)


def factory_engine_params(fields: dict) -> dict:
    """A case's SimParams fields."""
    return {**FACTORY_ENGINE_PARAMS, **FACTORY_ENGINE_SOLVE, **fields}


def factory_engine_scene(md, damping: bool):
    """The scene (model, pair_specs) built with the model module ``md``
    (the port's ``models.model`` or the JAX package's, whose builders are
    the same code) and its own voxelizer."""
    mesh_mod = __import__(md.__name__.rsplit(".", 1)[0] + ".meshes",
                          fromlist=["box_mesh"])
    b = md.ModelBuilder()
    b.begin_actor()
    plate = b.add_body("plate", -1, md.FIXED, body_pos=(0.0, 0.0, 0.05))
    pv, pt = mesh_mod.box_mesh((0.1, 0.1, 0.02))
    b.add_sdf_geom(plate, pv, pt, friction=0.6, resolution=24,
                   name="plate_sdf")
    half = np.array([0.03, 0.03, 0.02])
    g = np.linspace(-1.0, 1.0, 4)
    cloud = np.array([[x * half[0], y * half[1], z * half[2]]
                      for z in (-1.0, 1.0) for x in g for y in g],
                     np.float32)
    for name, pos in (("block_a", (0.0, 0.0, 0.09)),
                      ("block_b", (0.3, 0.0, 0.02))):
        b.begin_actor()
        body = b.add_body(name, -1, md.FREE, body_pos=pos)
        b.add_geom(body, md.GEOM_BOX, half, density=500.0, friction=0.8,
                   contact=False, name=f"{name}_box")
        b.add_contact_points(body, cloud, friction=0.8, name=f"{name}_pts")
    b.begin_actor()
    base = b.add_body("rod_base", -1, md.FIXED, body_pos=(-0.3, 0.0, 0.3))
    rod = b.add_body("rod", base, md.HINGE, jnt_axis=(0.0, 1.0, 0.0),
                     limit_lower=[-0.3], limit_upper=[0.3], damping=0.1)
    b.add_geom(rod, md.GEOM_CAPSULE, np.array([0.01, 0.05, 0.0]),
               pos=np.array([0.0, 0.0, -0.05]), density=800.0,
               contact=False, name="rod_geom")
    model = b.finalize()
    if damping:
        model.body_lin_damping = np.where(
            np.asarray(model.jnt_type) == md.FREE, 1.0, 0.0)
        model.body_ang_damping = np.where(
            np.asarray(model.jnt_type) == md.FREE, 5.0, 0.0)
    names = [gg.name for gg in model.geoms]
    pairs = [(names.index("block_a_pts"), names.index("plate_sdf"))]
    return model, pairs


def factory_engine_start(model, n: int, seed: int = 0):
    """The capture's start: q and qd (n, nq / nv) with each block lifted
    0-2 mm and turned a little and the rod at its upper limit, and each
    step's torques (FACTORY_ENGINE_STEPS, n, nv): the blocks pushed
    sideways and twisted, the rod into its limit."""
    from ..models.model import default_qpos
    rng = np.random.default_rng(seed)
    q0 = np.asarray(default_qpos(model), np.float32)
    q = np.tile(q0, (n, 1))
    qd = np.zeros((n, int(model.nv)), np.float32)
    for b in range(int(model.nb)):
        if int(model.jnt_type[b]) != 0:    # FREE
            continue
        qa = int(model.q_adr[b])
        q[:, qa: qa + 3] = np.asarray(model.body_pos[b], np.float32)
        q[:, qa + 2] += rng.uniform(0.0, 0.002, n)
        ang = rng.uniform(-0.05, 0.05, (n, 3))
        q[:, qa + 3: qa + 6] = 0.5 * ang
        q[:, qa + 6] = 1.0
        nrm = np.linalg.norm(q[:, qa + 3: qa + 7], axis=1, keepdims=True)
        q[:, qa + 3: qa + 7] /= nrm
    rod = list(model.body_names).index("rod")
    q[:, int(model.q_adr[rod])] = 0.31
    tau = rng.normal(0.0, 1.0, (FACTORY_ENGINE_STEPS, n, int(model.nv)))
    for va in (0, 6):      # each block: forces ~0.1 N, torques ~2 mN m
        tau[..., va: va + 3] *= 0.1
        tau[..., va + 3: va + 6] *= 0.002
    tau[..., int(model.v_adr[rod])] = 0.5 + np.abs(
        tau[..., int(model.v_adr[rod])])
    return q.astype(np.float32), qd, tau.astype(np.float32)

