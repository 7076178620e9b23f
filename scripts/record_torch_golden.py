"""Record the JAX golden trajectories that the PyTorch port replays.

Writes one capture under tests/data/torch_port/ in the format of
isaacgymenvs_ma_tpu_torch/utils/parity.py, from the task's JAX default
path: ``--task Ant`` (the default) -> ant_golden.npz and ``--task
BallBalance`` -> ball_balance_golden.npz at 64 envs, ``--task
FrankaReachMA`` -> franka_reach_ma_golden.npz at 16 envs x 2 arms.  The
task is warmed up for 20 steps (Ant: the feet on the ground; BallBalance:
the balls landed on the trays; FrankaReachMA: the cubes landed on the
table), then 6 steps are recorded under fixed seeded actions, with a
quarter of the envs flagged to reset on the first recorded step and the
JAX reset draws stored for every step.  Multi-agent tasks record actions,
obs, rewards and resets per agent row (num_envs * num_agents rows).
``--task Cartpole`` -> cartpole_golden.npz records instead the rollout of
tests/test_golden_cartpole.py: 64 envs from ``initial_state(PRNGKey(1234))``
(every env reset on step 1), 101 steps of the action sin(0.1 t), no
warm-up, each step jitted on its own.

``--kernel-route`` records the JAX contact-kernel route instead: the
warm-up stays on the default path (jitted), then the 6 steps run with the
Pallas kernels in interpret mode (jitted with the flag set) (``dyn_kernel._FORCE_INTERPRET``,
read at trace time), at 128 envs, the fewest at which the JAX engine takes
its dynamics kernels and with them kernel B4 (its lane blocks divide N by
128): ``--task FrankaReachMA --kernel-route`` ->
franka_reach_ma_b4_golden.npz.  That route solves every candidate row
without compaction or row reuse (engine.py:1304-1305, :1524).

``--task Humanoid``, ``Anymal``, ``AnymalTerrain``, ``Ingenuity`` and
``Quadcopter`` -> humanoid_golden.npz, anymal_golden.npz,
anymal_terrain_golden.npz, ingenuity_golden.npz and quadcopter_golden.npz
at 32 envs, warmed up and recorded as Ant is; AnymalTerrain's and
Ingenuity's captures also store each step's ``post_physics`` draws (the
pushes and observation noise; the new targets), and AnymalTerrain's push
counter is set so that every base is pushed in the third recorded step.
AnymalTerrain's capture also stores the state each step starts from
(``start_*``) and, per env, how far the JAX step moves under one-ulp noise
on q and qd (``spread_*``, eight runs): ``parity.replay`` holds it one
step at a time (see ``ONE_STEP``).

``--task FrankaCollectMA`` -> franka_collect_ma_golden.npz and ``--task
FrankaPPMA`` -> franka_ppma_golden.npz (16 envs x 2 arms) record 10 steps
from the warmed-up state with live grabs in half of the envs (after the
quarter flagged to reset): each agent's cube moved onto its grip site
(the JAX ``engine.fk``) at rest, and those agents' gripper actions
negative in every step; ``--task FrankaCollectMA --kernel-route`` ->
franka_collect_ma_b4_golden.npz records 6 steps so at 128 envs.  JAX
compile times on an 8-core CPU, three recordings side by side: the
FrankaCollectMA / FrankaPPMA step's jit and 20 warm-up steps ~220 s each
(FrankaReachMA alone: ~100 s); on the kernel route each interpret-mode
step took ~4 min run eagerly (the kernel-route capture ~25 min in all);
the steps are now jitted with the flag set, which compiles for minutes
and then steps several times faster.

``--task FrankaReach``, ``FrankaCabinet``, ``FrankaCubeStack``,
``FrankaCubeStack2`` and ``Trifinger`` -> franka_reach_golden.npz,
franka_cabinet_golden.npz, franka_cube_stack_golden.npz,
franka_cube_stack2_golden.npz and trifinger_golden.npz at 32 envs (6
steps; 10 for the grab tasks, with the grab live in half of the envs:
cube A on the grip site, or the cabinet's arm solved onto its handle by
damped least squares from the default pose, both fingers closing).  The
cube-stack captures also store the JAX trajectory's own spread
(``traj_spread_*``, see ``TRAJ_SPREAD``); Trifinger's the domain
randomization: the scales it starts from (``init_phys_*``) and every
step's white action and observation noise and fresh scales (``dr_*``).
``--task FrankaCabinet --kernel-route`` and ``--task Trifinger
--kernel-route`` record at 128 envs on the kernel route (~3 min an
interpreted step on an 8-core CPU).  ``--phys-step`` records
phys_step_b4.npz: one engine step of Ant's and Trifinger's scenes at 128
envs on the kernel route with seeded per-env physics scales, without and
with shape scales (~35 s / ~200 s an interpreted step).  The single-arm
Franka recordings jit in ~110-140 s, Trifinger's in ~25 s.

``--task AllegroKuka`` and ``--task AllegroKukaTwoArms`` ->
allegro_kuka_golden.npz and allegro_kuka_two_arms_golden.npz record the
Reorientation subtask at 32 envs (6 steps), with each step's
``pre_physics`` draws (the random object force's trigger and direction,
``PRE_DRAWS``), the cuboid sizes as ``init_phys_shape`` and, per step,
the state it starts from and each env's one-ulp spread (``ONE_STEP``);
``--task AllegroKuka --kernel-route`` records it at 128 envs with every
JAX kernel interpreted, its spread too (~40 min).  AllegroKukaTwoArms has no kernel route in
the JAX engine: its plan exceeds the JAX dynamics kernels' VMEM budget at
every block, and B4 takes their H^-1, so the engine runs its compacting
XLA loop there (the assertion below refuses it).  The warm-up jits in
~2.5 min (TwoArms ~6 min).

``--task ShadowHand``, ``AllegroHand``, ``ShadowHandOpenAI_FF`` and
``AllegroHandLSTM`` -> shadow_hand_golden.npz, allegro_hand_golden.npz,
shadow_hand_openai_ff_golden.npz and allegro_hand_lstm_golden.npz at 32
envs (6 steps, each held one step at a time against the reference's own
one-ulp spread, ``ONE_STEP``): the variants' configs from the JAX
registry (OpenAI_FF: openai obs plus the 211 critic states, 3 engine
steps a step, the random object force; AllegroHandLSTM: full_no_vel obs
plus states, the per-env moving average, the force), with each step's
reset draws, ``pre_physics``'s force draws (``fold_in(rng, 77)``) and
``post_physics``'s goal draws (``fold_in(rng, 41)``).  Eight envs after the
quarter flagged to reset start with their goal set to their cube's
orientation, so the first step has successes (a bonus, a resampled goal
and, with ``maxConsecutiveSuccesses``, a restarted episode clock).

``--task FactoryTaskNutBoltPick``, ``FactoryTaskNutBoltPlace``,
``FactoryTaskNutBoltScrew``, ``FactoryTaskGears``, ``FactoryTaskInsertion``,
``IndustRealTaskPegsInsert`` and ``IndustRealTaskGearsInsert`` ->
factory_task_nut_bolt_pick_golden.npz ... indust_real_task_gears_insert_golden.npz
at 8 envs, with the episode shortened to FACTORY_EPISODE = 23 steps
(``rl_max_episode_length`` in the capture) so that the envs not flagged to
reset reach their last step in the third recorded step: Pick runs its
close-and-lift epilogue there and IndustReal updates its curriculum.  Each
step is held one step at a time (``ONE_STEP``), its start carrying the
warm-start impulses (``start_lam_0..2``); the reset draws come from the
JAX reset key as ``reset_idx`` splits it (``factory_draws``), IndustReal's
goal noise from ``fold_in(k_step, 29)``.  One Factory step compiles the
12-iteration IK reset and (Pick) the 50-step epilogue: 2-7 min a task on
an 8-core CPU, seven side by side.  ``--factory-engine`` records
factory_engine.npz: the JAX engine's steps on the synthetic scene of
``isaacgymenvs_ma_tpu_torch.utils.parity.factory_engine_scene`` (warm
start, body damping, bf16 rows, an SDF-grid target, compaction; ~20 s).

``--task HumanoidAMP`` and ``--task HumanoidAMPHands`` ->
humanoid_amp_golden.npz and humanoid_amp_hands_golden.npz record 3 steps
at 8 envs (``AMP_STEPS``) after the warm-up, a quarter of the envs reset
on the first by Reference State Init; each step's reset draws are the
motion ids and times of the JAX motion library's draws (``amp_draws``).
``--amp-epoch`` records amp_epoch.npz: one whole epoch of the JAX AMP
learner (HumanoidAMP at 8 envs, horizon 8, minibatch 64, ``amp_batch_size``
32, network and discriminator units [64, 32], seed 3), its third, so the
replay joins the discriminator batch: the state it starts from (env,
learner, discriminator, the replay's filled rows), every draw of the
epoch (action noise, reset draws, minibatch permutations, the
discriminator phase's demo draws and replay and agent indices), the
rollout with the combined rewards, GAE, the metrics and the state after
(~2 min: two jits).

``--factory-lift-eval`` records factory_lift_eval.npz: the JAX Factory
lift evaluation (scripts/eval_factory_lift.py, its ``main`` as it stands)
scoring an untrained policy (``random``, seed LIFT_EVAL_SEED) at 8 envs
with the episode shortened to LIFT_EVAL_EPISODE steps: the policy's
parameters and normalisers, the env state the episode starts from, each
step's reset draws and reset flags, per env the final progress,
coordinates, nut height and epilogue outcome, and the five numbers the
script prints (~5 min: one Factory step and the epilogue compiled).

    JAX_PLATFORMS=cpu python scripts/record_torch_golden.py [--task NAME]
        [--kernel-route] [--phys-step] [--factory-engine] [--amp-epoch]
        [--factory-lift-eval]
"""
import argparse
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from isaacgymenvs_ma_tpu.ops import rng as rng_ops
from isaacgymenvs_ma_tpu.physics import contact_kernel as jck
from isaacgymenvs_ma_tpu.physics import dyn_kernel as jdk
from isaacgymenvs_ma_tpu.ops import maths as jmaths
from isaacgymenvs_ma_tpu.tasks import registry as jregistry
from isaacgymenvs_ma_tpu.tasks import (allegro_kuka, anymal,
                                       anymal_terrain, ant,
                                       ball_balance, cartpole,
                                       franka_cabinet, franka_collect_ma,
                                       franka_cube_stack, franka_cube_stack2,
                                       franka_ppma, franka_reach,
                                       franka_reach_ma, humanoid,
                                       humanoid_amp, ingenuity, quadcopter,
                                       trifinger)
from isaacgymenvs_ma_tpu.utils import domain_rand as jdr
from isaacgymenvs_ma_tpu.utils.config import deep_merge

WARMUP, T = 20, 6
KERNEL_ROUTE_ENVS = 128
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tests", "data", "torch_port")


def ant_draws(k_reset, task):
    """Ant.reset_idx's draws (ant.py:138-141)."""
    n = task.num_envs
    k1, k2 = jax.random.split(k_reset)
    return {"reset_pos": jax.random.uniform(k1, (n, 8), minval=-0.2,
                                            maxval=0.2),
            "reset_vel": jax.random.uniform(k2, (n, 8), minval=-0.1,
                                            maxval=0.1)}


def ball_balance_draws(k_reset, task):
    """BallBalance.reset_idx's draws (ball_balance.py:207-226)."""
    n = task.num_envs
    k1, k2, k3, k4 = jax.random.split(k_reset, 4)
    return {"reset_dists": rng_ops.rand_float(k1, 0.001, 0.5, (n, 1)),
            "reset_dirs": rng_ops.random_dir_2(k2, (n, 1))[:, 0, :],
            "reset_hspeeds": rng_ops.rand_float(k3, 0.0, 5.0, (n, 1)),
            "reset_height": rng_ops.rand_float(k4, 1.0, 2.0, (n,))}


def franka_reach_ma_draws(k_reset, task):
    """FrankaReachMA.reset_idx's uniform draws (franka_reach_ma.py:279-298):
    arm dof noise (N, K, 9), cube xy (N, T, 2) and cube height (N, T)."""
    n, k, t = task.num_envs, task.num_agents, task.num_targets
    k1, k2, k3 = jax.random.split(k_reset, 3)
    return {"dof_noise": jax.random.uniform(k1, (n, k, 9)),
            "cube_xy_u": jax.random.uniform(k2, (n, t, 2)),
            "cube_z_u": jax.random.uniform(k3, (n, t))}


def cube_stack2_draws(k_reset, task):
    """FrankaCubeStack2.reset_idx's draws: FrankaReachMA's, then cube A's
    spawn lift U[0, 1) (fold_in 77, franka_cube_stack2.py:67-73)."""
    d = franka_reach_ma_draws(k_reset, task)
    d["cube_a_dz_u"] = jax.random.uniform(jax.random.fold_in(k_reset, 77),
                                          (task.num_envs,))
    return d


def cabinet_draws(k_reset, task):
    """FrankaCabinet.reset_idx's draw (franka_cabinet.py:178-181): U[0, 1)
    (N, 9), the arm's dof noise before its scale and shift."""
    k1, = jax.random.split(k_reset, 1)
    return {"dof_u": jax.random.uniform(k1, (task.num_envs, 9))}


def trifinger_draws(k_reset, task):
    """Trifinger.reset_idx's draws in its key order (trifinger.py:342-386),
    each as the JAX samplers produce it: robot dof position and velocity
    normals, the object's radius uniform, angle and yaw, and the goal's
    radius uniform, angle, height (difficulty 3 or 4), yaw (difficulty -1)
    and quaternion uniforms, whether the distributions use them or not."""
    n = task.num_envs
    u = jax.random.uniform
    ks = jax.random.split(k_reset, 6)
    ko1, ko2 = jax.random.split(ks[2])
    kg = jax.random.split(ks[4], 3)
    kg1, kg2 = jax.random.split(kg[0])
    z_lo = (trifinger.MIN_HEIGHT if task.difficulty == 3
            else trifinger.CUBE_RADIUS_3D)
    return {"dof_pos_n": jax.random.normal(ks[0], (n, 9)),
            "dof_vel_n": jax.random.normal(ks[1], (n, 9)),
            "obj_r_u": u(ko1, (n,)),
            "obj_th": u(ko2, (n,), minval=0.0, maxval=2 * np.pi),
            "obj_yaw": u(ks[3], (n,), minval=-np.pi, maxval=np.pi),
            "goal_r_u": u(kg1, (n,)),
            "goal_th": u(kg2, (n,), minval=0.0, maxval=2 * np.pi),
            "goal_z": u(kg[1], (n,), minval=z_lo,
                        maxval=trifinger.MAX_HEIGHT),
            "goal_yaw": u(kg[1], (n,), minval=-np.pi, maxval=np.pi),
            "goal_quat_u": u(kg[2], (n, 3))}


def dr_draws(k_anoise, k_onoise, k_phys, st, task, action_shape):
    """The domain randomizer's draws of one step (base.py:228-307): the
    white action and observation noise samples, and every env's fresh
    physics scales (the JAX resample with every env masked)."""
    dr = task.randomizer
    out = {"dr_actions": jdr._sample(k_anoise, dr.act_spec, action_shape,
                                     1e9),
           "dr_observations": jdr._sample(
               k_onoise, dr.obs_spec, (task.rl_games_batch, task.num_obs),
               1e9)}
    fresh = dr.resample_phys(k_phys, jnp.ones(task.num_envs, bool), st.phys)
    for leaf, v in fresh._asdict().items():
        if v is not None:
            out[f"dr_phys_{leaf}"] = v
    return out


def cartpole_draws(k_reset, task):
    """Cartpole.reset_idx's draws (cartpole.py:124-129): dof positions and
    velocities, each (N, 2)."""
    n = task.num_envs
    k1, k2 = jax.random.split(k_reset)
    return {"reset_pos": 0.2 * (jax.random.uniform(k1, (n, 2)) - 0.5),
            "reset_vel": 0.5 * (jax.random.uniform(k2, (n, 2)) - 0.5)}


def kuka_goal_draws(key, task):
    """An AllegroKuka subtask's goal draws (allegro_kuka.py:408-414,
    :724-750) in their sampler ranges: Reorientation the position's U[0, 1)
    (N, 3) and the quaternion's U[0, 1) (N, 3); Regrasping the same
    (the quaternion's unused); Throw the side U[-1, 1), the offset
    U[0, 0.4), y U[-1, 0.7) and z U[0, 1) as ``goal_pos_u`` (N, 4)."""
    n = task.num_envs
    u = jax.random.uniform
    if isinstance(task, allegro_kuka.AllegroKukaThrow):
        ks = jax.random.split(key, 4)
        return {"goal_pos_u": jnp.concatenate([
                    u(ks[0], (n, 1), minval=-1.0, maxval=1.0),
                    u(ks[1], (n, 1), minval=0.0, maxval=0.4),
                    u(ks[2], (n, 1), minval=-1.0, maxval=0.7),
                    u(ks[3], (n, 1), minval=0.0, maxval=1.0)], -1),
                "goal_quat_u": jnp.zeros((n, 3), jnp.float32)}
    k1, k2 = jax.random.split(key)
    return {"goal_pos_u": u(k1, (n, 3)), "goal_quat_u": u(k2, (n, 3))}


def kuka_draws(k_reset, task):
    """AllegroKukaBase.reset_idx's draws (allegro_kuka.py:419-487): the
    goal's, the dof positions' U[0, 1) and velocities' U[-1, 1) (N, nd),
    the object's position noise U[-1, 1) (N, 3) and quaternion U[0, 1)
    (N, 3), and the force probability's U[0, 1) (N,)."""
    n, nd = task.num_envs, task.nd
    u = jax.random.uniform
    ks = jax.random.split(k_reset, 8)
    d = kuka_goal_draws(ks[0], task)
    d.update({"dof_u": u(ks[1], (n, nd)),
              "dof_vel_u": u(ks[2], (n, nd), minval=-1.0, maxval=1.0),
              "obj_pos_u": u(ks[3], (n, 3), minval=-1.0, maxval=1.0),
              "obj_quat_u": u(ks[4], (n, 3)),
              "force_prob_u": u(ks[5], (n,))})
    return d


def kuka_pre_draws(rng, task):
    """AllegroKukaBase.pre_physics's draws (fold_in 23 of the state's key,
    allegro_kuka.py:516-523): the force trigger's U[0, 1) (N,) and the new
    force's N(0, 1) (N, 3)."""
    k1, k2 = jax.random.split(jax.random.fold_in(rng, 23))
    n = task.num_envs
    return {"force_fire_u": jax.random.uniform(k1, (n,)),
            "force_n": jax.random.normal(k2, (n, 3))}


def _hand_angles(key, n):
    """ShadowHand._random_quat's draws: the angles about z and y, each
    U[-pi, pi) (N,), as (N, 2)."""
    k1, k2 = jax.random.split(key)
    return jnp.stack([
        jax.random.uniform(k1, (n,), minval=-np.pi, maxval=np.pi),
        jax.random.uniform(k2, (n,), minval=-np.pi, maxval=np.pi)], -1)


def hand_draws(k_reset, task):
    """ShadowHand.reset_idx's draws (shadow_hand.py:436-468): the cube's
    position noise N(0, 1) (N, 3), its orientation's angles (N, 2), the
    dof noise U[0, 1) (N, num_hand_dofs) and the goal's angles (N, 2)."""
    n = task.num_envs
    ks = jax.random.split(k_reset, 5)
    return {"obj_pos_n": jax.random.normal(ks[0], (n, 3)),
            "obj_rot_ang": _hand_angles(ks[1], n),
            "dof_u": jax.random.uniform(ks[2], (n, task.num_hand_dofs)),
            "goal_rot_ang": _hand_angles(ks[3], n)}


def hand_pre_draws(rng, task):
    """ShadowHand.pre_physics's force draws (fold_in 77 of the state's
    key, shadow_hand.py:416-421): the trigger's U[0, 1) (N,) and the new
    force's N(0, 1) (N, 3)."""
    k_fire, k_mag = jax.random.split(jax.random.fold_in(rng, 77))
    n = task.num_envs
    return {"force_fire_u": jax.random.uniform(k_fire, (n,)),
            "force_n": jax.random.normal(k_mag, (n, 3))}


def hand_step_draws(k_step, task):
    """ShadowHand.post_physics's goal draws (fold_in 41 of the step's key,
    shadow_hand.py:547-548): the resampled goals' angles (N, 2)."""
    return {"new_goal_ang": _hand_angles(jax.random.fold_in(k_step, 41),
                                         task.num_envs)}


HANDS = {"ShadowHand": "shadow_hand_golden.npz",
         "AllegroHand": "allegro_hand_golden.npz",
         "ShadowHandOpenAI_FF": "shadow_hand_openai_ff_golden.npz",
         "AllegroHandLSTM": "allegro_hand_lstm_golden.npz"}


def humanoid_draws(k_reset, task):
    """Humanoid.reset_idx's draws (humanoid.py:144-146)."""
    n = task.num_envs
    k1, k2 = jax.random.split(k_reset)
    return {"reset_pos": jax.random.uniform(k1, (n, 21), minval=-0.2,
                                            maxval=0.2),
            "reset_vel": jax.random.uniform(k2, (n, 21), minval=-0.1,
                                            maxval=0.1)}


def amp_draws(k_reset, task):
    """HumanoidAMP.reset_idx's draws (humanoid_amp.py:206-214): motion ids
    by the clips' weights, then uniform times within them."""
    k1, k2 = jax.random.split(k_reset)
    ids = task.motion_lib.sample_motions(k1, task.num_envs)
    return {"motion_ids": ids,
            "motion_times": task.motion_lib.sample_time(k2, ids)}


def anymal_draws(k_reset, task):
    """Anymal.reset_idx's draws (anymal.py:178-205): dof position factors,
    dof velocities and the three commands."""
    n = task.num_envs
    k1, k2, k3, k4, k5 = jax.random.split(k_reset, 5)
    u = jax.random.uniform
    return {"reset_pos_u": u(k1, (n, 12), minval=0.5, maxval=1.5),
            "reset_vel": u(k2, (n, 12), minval=-0.1, maxval=0.1),
            "cmd_x": u(k3, (n,), minval=task.command_x_range[0],
                       maxval=task.command_x_range[1]),
            "cmd_y": u(k4, (n,), minval=task.command_y_range[0],
                       maxval=task.command_y_range[1]),
            "cmd_yaw": u(k5, (n,), minval=task.command_yaw_range[0],
                         maxval=task.command_yaw_range[1])}


def anymal_terrain_draws(k_reset, task):
    """AnymalTerrain.reset_idx's draws (anymal_terrain.py:307-356)."""
    n, cr = task.num_envs, task.command_ranges
    ks = jax.random.split(k_reset, 7)
    u = jax.random.uniform
    return {"reset_pos_u": u(ks[0], (n, 12), minval=0.5, maxval=1.5),
            "reset_vel": u(ks[1], (n, 12), minval=-0.1, maxval=0.1),
            "xy_noise": u(ks[2], (n, 2), minval=-0.5, maxval=0.5),
            "cmd_x": u(ks[3], (n,), minval=cr["linear_x"][0],
                       maxval=cr["linear_x"][1]),
            "cmd_y": u(ks[4], (n,), minval=cr["linear_y"][0],
                       maxval=cr["linear_y"][1]),
            "cmd_yaw": u(ks[5], (n,), minval=cr["yaw"][0],
                         maxval=cr["yaw"][1])}


def anymal_terrain_step_draws(k_step, task):
    """AnymalTerrain.post_physics's draws: the pushes (fold_in 17) and the
    observation noise (fold_in 23), anymal_terrain.py:372-377, :423."""
    n = task.num_envs
    return {"push_vel": jax.random.uniform(jax.random.fold_in(k_step, 17),
                                           (n, 2), minval=-1.0, maxval=1.0),
            "noise_u": jax.random.uniform(jax.random.fold_in(k_step, 23),
                                          (n, 188))}


def _ingenuity_targets(key, n):
    k1, k2 = jax.random.split(key)
    return jax.random.uniform(k1, (n, 2)), jax.random.uniform(k2, (n, 1))


def ingenuity_draws(k_reset, task):
    """Ingenuity.reset_idx's draws (ingenuity.py:126-154): the chassis
    offsets, then the new targets' uniforms."""
    n = task.num_envs
    k1, k2, k3 = jax.random.split(k_reset, 3)
    t_xy, t_z = _ingenuity_targets(k3, n)
    return {"off_xy": jax.random.uniform(k1, (n, 2), minval=-1.5,
                                         maxval=1.5),
            "off_z": jax.random.uniform(k2, (n, 1), minval=-0.2, maxval=1.5),
            "target_xy_u": t_xy, "target_z_u": t_z}


def ingenuity_step_draws(k_step, task):
    """Ingenuity.post_physics's new targets (fold_in 31, ingenuity.py:
    157-160)."""
    t_xy, t_z = _ingenuity_targets(jax.random.fold_in(k_step, 31),
                                   task.num_envs)
    return {"retarget_xy_u": t_xy, "retarget_z_u": t_z}


def quadcopter_draws(k_reset, task):
    """Quadcopter.reset_idx's draws (quadcopter.py:146-163)."""
    n = task.num_envs
    k1, k2, k3 = jax.random.split(k_reset, 3)
    u = jax.random.uniform
    return {"off_xy": u(k1, (n, 2), minval=-1.5, maxval=1.5),
            "off_z": u(k2, (n, 1), minval=-0.2, maxval=1.5),
            "reset_dof": u(k3, (n, 8), minval=-0.2, maxval=0.2)}


# post_physics draws of the tasks that draw there: name -> draws(k_step)
FACTORY = ("FactoryTaskNutBoltPick", "FactoryTaskNutBoltPlace",
           "FactoryTaskNutBoltScrew", "FactoryTaskGears",
           "FactoryTaskInsertion", "IndustRealTaskPegsInsert",
           "IndustRealTaskGearsInsert")
# the Factory captures' shortened episodes: after the 20 warm-up steps the
# envs not flagged to reset reach their last step (progress 22) at the
# third recorded step, where Pick runs its close-and-lift epilogue and
# IndustReal updates its curriculum
FACTORY_EPISODE = 23


def factory_draws(k_reset, task):
    """The Factory resets' draws from VecTaskBase.step's reset key, as
    reset_idx splits it (factory.py:431-454): the fingertip target's
    position and Euler noise (not at Screw, whose reset draws nothing),
    then the objects' (Pick :559-577, Gears :982-996, IndustReal
    industreal.py:322-347; Place none)."""
    n = task.num_envs
    name = type(task).__name__
    if name == "FactoryTaskNutBoltScrew":
        return {}
    ks = jax.random.split(k_reset, 4)
    k1, k2 = jax.random.split(ks[0])
    u = lambda k, s: jax.random.uniform(k, s, minval=-1.0,  # noqa: E731
                                        maxval=1.0)
    d = {"ft_pos_u": u(k1, (n, 3)), "ft_rot_u": u(k2, (n, 3))}
    if name == "FactoryTaskNutBoltPick":
        k1, k2 = jax.random.split(ks[1])
        d["nut_xy_u"] = u(k1, (n, 2))
        d["nut_yaw"] = jax.random.uniform(k2, (n,), minval=-np.pi,
                                          maxval=np.pi)
    elif name in ("FactoryTaskGears", "FactoryTaskInsertion"):
        d["obj_xy_u"] = u(ks[1], (n, 2))
    elif name.startswith("IndustReal"):
        k3 = jax.random.split(ks[1], 3)
        d["plug_xy_u"] = u(k3[0], (n, 2))
        d["disp_u"] = jax.random.uniform(k3[1], (n,))
    return d


def industreal_step_draws(k_step, task):
    """The goal's observation noise of post_physics (industreal.py:422)."""
    return {"goal_noise_n": jax.random.normal(
        jax.random.fold_in(k_step, 29), (task.num_envs, 3))}


STEP_DRAWS = {"AnymalTerrain": anymal_terrain_step_draws,
              "Ingenuity": ingenuity_step_draws,
              **{h: hand_step_draws for h in HANDS},
              **{f: industreal_step_draws for f in FACTORY
                 if f.startswith("IndustReal")}}
# pre_physics draws of the tasks that draw there: name -> draws(state key)
PRE_DRAWS = {"AllegroKuka": kuka_pre_draws,
             "AllegroKukaTwoArms": kuka_pre_draws,
             **{h: hand_pre_draws for h in HANDS}}
# AnymalTerrain: the push counter set so that the third recorded step
# pushes every base (its pushInterval_s is 750 steps)
PUSH_AT = 2
# tasks whose steps are held one at a time (each from the recorded state
# it started from) with each env's bound widened by the reference's own
# spread under one-ulp input noise: on AnymalTerrain's stairs, obstacles
# and stepping stones one ulp of q and qd moves the JAX step's q by up to
# 1e-1 (a foot on a stone's edge reads a 10 m bilinear cliff), so neither
# package can follow the other over several steps.  The AllegroKuka hands
# amplify rounding as much in the envs where their fingers strike (one ulp
# moves the JAX step's qd by up to ~5e-2 at one arm, ~1 at two): held
# step by step, each env against its own spread
ONE_STEP = ("AnymalTerrain", "AllegroKuka", "AllegroKukaTwoArms", *HANDS,
            *FACTORY)
SPREAD_RUNS = 8


def state_arrays(st):
    """The env state a step starts from, as flat numpy arrays (with the
    warm-start impulses as lam_0..2 where the engine carries them)."""
    out = {"q": st.sim.q, "qd": st.sim.qd, "progress": st.progress,
           "reset_buf": st.reset_buf}
    for i, x in enumerate(st.sim.lam if st.sim.lam is not None else ()):
        out[f"lam_{i}"] = x
    for f in st.task._fields if st.task is not None else ():
        out[f] = getattr(st.task, f)
    return {k: np.asarray(v) for k, v in out.items()}


def one_ulp_spread(step, st, action, res, new, rng):
    """Per env, the largest move of the step's q, qd, obs and reward over
    SPREAD_RUNS runs from q and qd each moved by one rounding step
    (x (1 +- 2^-23), signs from ``rng``), and whether any run flips the
    env's reset; a non-finite run counts as an infinite move."""
    n = st.sim.q.shape[0]
    spread = {k: np.zeros(n, np.float32) for k in ("q", "qd", "obs", "rew")}
    flips = np.zeros(n, bool)
    ref = {"q": np.asarray(new.sim.q), "qd": np.asarray(new.sim.qd),
           "obs": np.asarray(res.obs), "rew": np.asarray(res.rew)}
    for _ in range(SPREAD_RUNS):
        nudge = lambda x: jnp.asarray(np.asarray(x) * (  # noqa: E731
            1 + rng.choice([-1.0, 1.0], x.shape) * 2.0 ** -23), jnp.float32)
        s2 = st._replace(sim=st.sim._replace(q=nudge(st.sim.q),
                                             qd=nudge(st.sim.qd)))
        s2, r2 = step(s2, action)
        got = {"q": np.asarray(s2.sim.q), "qd": np.asarray(s2.sim.qd),
               "obs": np.asarray(r2.obs), "rew": np.asarray(r2.rew)}
        for k, v in got.items():
            dv = np.abs(v - ref[k]).reshape(n, -1).max(1)
            spread[k] = np.maximum(spread[k], np.where(np.isfinite(dv), dv,
                                                       np.inf))
        flips |= np.asarray(r2.reset) != np.asarray(res.reset)
    return spread, flips

def trajectory_spread(step, st0, actions, fields, rng):
    """Per recorded step, the largest move of q, qd, obs and reward over
    SPREAD_RUNS reruns of the recording (the same actions and key stream)
    from q and qd each moved by one rounding step (x (1 +- 2^-23), signs
    from ``rng``): the reference's own spread over the trajectory."""
    T = len(actions)
    spread = {k: np.zeros(T, np.float32) for k in ("q", "qd", "obs", "rew")}
    for _ in range(SPREAD_RUNS):
        nudge = lambda x: jnp.asarray(np.asarray(x) * (  # noqa: E731
            1 + rng.choice([-1.0, 1.0], x.shape) * 2.0 ** -23), jnp.float32)
        st = st0._replace(sim=st0.sim._replace(q=nudge(st0.sim.q),
                                               qd=nudge(st0.sim.qd)))
        for t in range(T):
            st, res = step(st, jnp.asarray(actions[t]))
            got = {"q": st.sim.q, "qd": st.sim.qd, "obs": res.obs,
                   "rew": res.rew}
            for k, v in got.items():
                dv = float(np.abs(np.asarray(v) - fields[k][t]).max())
                spread[k][t] = max(spread[k][t], dv)
    return {f"traj_spread_{k}": v for k, v in spread.items()}


# tasks recorded from a golden rollout of the JAX tests instead of a
# warmed-up state: name -> (PRNG seed, steps)
ROLLOUTS = {"Cartpole": (1234, 101)}

def cabinet_live_grabs(st, task, actions, envs):
    """Make FrankaCabinet's handle grab live in ``envs``: the arm's joints
    solved (damped least squares over a finite-difference Jacobian of the
    JAX ``engine.fk``) so that the grip site sits on the handle, at rest,
    and both finger actions (columns 7 and 8) negative in every recorded
    step: the grab's gate (grip site within 5 cm of the handle, both
    fingers closing) then holds."""
    q = np.array(st.sim.q, np.float64)
    qids = np.asarray(task.franka_qids[:7])
    # from the default arm pose, a well-conditioned start
    q[envs[:, None], qids[None]] = np.asarray(task.default_dof)[:7]
    lo = np.asarray(task.dof_lower)[:7]
    hi = np.asarray(task.dof_upper)[:7]
    for _ in range(30):
        def err(qq):
            bx, bq = task.engine.fk(jnp.asarray(qq, jnp.float32))
            handle = bx[:, task.drawer_body] + jmaths.quat_apply(
                bq[:, task.drawer_body],
                jnp.asarray(franka_cabinet.HANDLE_LOCAL, jnp.float32))
            return np.asarray(handle - bx[:, task.grip_body], np.float64)
        e = err(q)
        J = np.zeros(e.shape + (7,))
        for j, qi in enumerate(qids):
            qp = q.copy()
            qp[:, qi] += 1e-3
            J[..., j] = (e - err(qp)) / 1e-3
        JJt = J @ np.swapaxes(J, 1, 2) + 1e-4 * np.eye(3)
        dq = (np.swapaxes(J, 1, 2) @ np.linalg.solve(JJt, e[..., None]))[..., 0]
        q[envs[:, None], qids[None]] = np.clip(
            q[envs[:, None], qids[None]] + np.clip(dq[envs], -0.2, 0.2),
            lo, hi)
    print(f"cabinet grabs: grip-handle distance "
          f"{np.linalg.norm(err(q)[envs], axis=-1).max():.2e} m", flush=True)
    qd = np.array(st.sim.qd)
    qd[envs[:, None], np.asarray(task.franka_dofs)[None]] = 0.0
    actions[:, envs, 7:9] = -np.abs(actions[:, envs, 7:9])
    return st._replace(sim=st.sim._replace(
        q=jnp.asarray(q, jnp.float32), qd=jnp.asarray(qd)))


def live_grabs(st, task, actions, envs):
    """Make the grab constraints of the MA tasks live in ``envs``: each
    agent k's cube k moved onto agent k's grip site (world position from
    the JAX ``engine.fk``) and at rest, and those agents' gripper actions
    (column 6) negative in every recorded step.  A random policy almost
    never closes a gripper within 2.25 cm of a cube, so without this the
    grab rows would do no work in the capture."""
    K = task.num_agents
    bx, _ = task.engine.fk(st.sim.q)
    grip = np.asarray(bx)[:, task.grip_bodies]                 # (N, K, 3)
    q, qd = np.array(st.sim.q), np.array(st.sim.qd)
    for k in range(K):
        qa, va = int(task.cube_q_adr[k]), int(task.cube_v_adr[k])
        q[envs, qa: qa + 3] = grip[envs, k]
        qd[envs, va: va + 6] = 0.0
    rows = (np.asarray(envs)[:, None] * K + np.arange(K)).reshape(-1)
    actions[:, rows, 6] = -np.abs(actions[:, rows, 6])
    return st._replace(sim=st.sim._replace(q=jnp.asarray(q),
                                           qd=jnp.asarray(qd)))


TASKS = {  # name -> (class, config, draws, envs, file)
    "Ant": (ant.Ant, ant.TASK_CFG, ant_draws, 64, "ant_golden.npz"),
    "BallBalance": (ball_balance.BallBalance, ball_balance.TASK_CFG,
                    ball_balance_draws, 64, "ball_balance_golden.npz"),
    "FrankaReachMA": (franka_reach_ma.FrankaReachMA,
                      franka_reach_ma.TASK_CFG, franka_reach_ma_draws, 16,
                      "franka_reach_ma_golden.npz"),
    "FrankaCollectMA": (franka_collect_ma.FrankaCollectMA,
                        franka_collect_ma.TASK_CFG, franka_reach_ma_draws, 16,
                        "franka_collect_ma_golden.npz"),
    "FrankaPPMA": (franka_ppma.FrankaPPMA, franka_ppma.TASK_CFG,
                   franka_reach_ma_draws, 16, "franka_ppma_golden.npz"),
    "Cartpole": (cartpole.Cartpole, cartpole.TASK_CFG, cartpole_draws, 64,
                 "cartpole_golden.npz"),
    "Humanoid": (humanoid.Humanoid, humanoid.TASK_CFG, humanoid_draws, 32,
                 "humanoid_golden.npz"),
    "Anymal": (anymal.Anymal, anymal.TASK_CFG, anymal_draws, 32,
               "anymal_golden.npz"),
    "AnymalTerrain": (anymal_terrain.AnymalTerrain, anymal_terrain.TASK_CFG,
                      anymal_terrain_draws, 32,
                      "anymal_terrain_golden.npz"),
    "Ingenuity": (ingenuity.Ingenuity, ingenuity.TASK_CFG, ingenuity_draws,
                  32, "ingenuity_golden.npz"),
    "Quadcopter": (quadcopter.Quadcopter, quadcopter.TASK_CFG,
                   quadcopter_draws, 32, "quadcopter_golden.npz"),
    "FrankaReach": (franka_reach.FrankaReach, franka_reach.TASK_CFG,
                    franka_reach_ma_draws, 32, "franka_reach_golden.npz"),
    "FrankaCabinet": (franka_cabinet.FrankaCabinet, franka_cabinet.TASK_CFG,
                      cabinet_draws, 32, "franka_cabinet_golden.npz"),
    "FrankaCubeStack": (franka_cube_stack.FrankaCubeStack,
                        franka_cube_stack.TASK_CFG, franka_reach_ma_draws,
                        32, "franka_cube_stack_golden.npz"),
    "FrankaCubeStack2": (franka_cube_stack2.FrankaCubeStack2,
                         franka_cube_stack2.TASK_CFG, cube_stack2_draws, 32,
                         "franka_cube_stack2_golden.npz"),
    "Trifinger": (trifinger.Trifinger, trifinger.TASK_CFG, trifinger_draws,
                  32, "trifinger_golden.npz"),
    "AllegroKuka": (allegro_kuka.AllegroKukaReorientation,
                    allegro_kuka.TASK_CFG, kuka_draws, 32,
                    "allegro_kuka_golden.npz"),
    "AllegroKukaTwoArms": (allegro_kuka.AllegroKukaTwoArmsReorientation,
                           allegro_kuka.TASK_CFG, kuka_draws, 32,
                           "allegro_kuka_two_arms_golden.npz"),
    **{h: (jregistry.task_class(h), jregistry.task_default_config(h),
           hand_draws, 32, f) for h, f in HANDS.items()},
    "HumanoidAMP": (humanoid_amp.HumanoidAMP, humanoid_amp.TASK_CFG,
                    amp_draws, 8, "humanoid_amp_golden.npz"),
    "HumanoidAMPHands": (jregistry.task_class("HumanoidAMPHands"),
                         jregistry.task_default_config("HumanoidAMPHands"),
                         amp_draws, 8, "humanoid_amp_hands_golden.npz"),
    # the Factory family and IndustReal at 8 envs, FACTORY_EPISODE steps
    # an episode
    **{f: (jregistry.task_class(f), deep_merge(
        jregistry.task_default_config(f),
        {"rl": {"max_episode_length": FACTORY_EPISODE}}), factory_draws, 8,
        "".join("_" + c.lower() if c.isupper() else c for c in f)[1:]
        + "_golden.npz") for f in FACTORY},
}
# the hands' first step has successes in these envs (after the quarter
# flagged to reset): their goals set to their cubes' orientations
HAND_SUCCESS_ENVS = 8
# tasks with grab constraints: recorded with live grabs in half of the
# envs (those after the first quarter, which resets), for GRAB_STEPS steps
# on the default loop; on the kernel route (128 envs) for T steps, which
# keeps the capture under 400 KB.  FrankaCabinet's grab is its handle's
# (cabinet_live_grabs), the others' each agent's cube (live_grabs)
GRAB_TASKS = ("FrankaCollectMA", "FrankaPPMA", "FrankaCubeStack",
              "FrankaCubeStack2", "FrankaCabinet")
GRAB_STEPS = 10
# tasks whose captures also store the JAX trajectory's own spread: each
# step's largest move of q, qd, obs and reward over SPREAD_RUNS reruns of
# the whole recording from q and qd moved by one rounding step
# (``traj_spread_*``, ROADMAP C9: the cube-stack scene amplifies float32
# rounding); parity.replay widens their bounds by it
TRAJ_SPREAD = ("FrankaCubeStack", "FrankaCubeStack2")
# the AMP tasks record AMP_STEPS steps
AMP_TASKS = ("HumanoidAMP", "HumanoidAMPHands")
AMP_STEPS = 3


# --phys-step: the scenes whose engine step is recorded with per-env
# physics scales on the JAX kernel route
PHYS_STEP_TASKS = ("Ant", "Trifinger")


def record_phys_step():
    """One engine step (``PhysicsEngine.step``) of Ant's and Trifinger's
    scenes at 128 envs on the JAX kernel route (Pallas interpret mode),
    from a state 6 steps into a run of seeded actions, with seeded torques
    and per-env physics scales from a seed (mass 0.6-1.5 and shape
    0.7-1.4 per body, tests/test_dyn_kernel.py:86; damping, stiffness 0.5-1.5
    per env; friction 0.5-1.5 per body), once without and once with the
    shape scales -> phys_step_b4.npz: keys ``<task>_q``, ``_qd``, ``_tau``,
    ``_phys_<leaf>`` and, per case (``noshape``, ``shape``), the JAX
    step's ``_<case>_q`` and ``_<case>_qd``."""
    from isaacgymenvs_ma_tpu.physics.engine import Control, SimState
    from isaacgymenvs_ma_tpu.utils.domain_rand import PhysScales
    n = KERNEL_ROUTE_ENVS
    rec = {}
    for name in PHYS_STEP_TASKS:
        cls, task_cfg = TASKS[name][:2]
        task = cls(deep_merge(task_cfg, {"env": {"numEnvs": n}}))
        st = task.initial_state(jax.random.PRNGKey(3))
        step = jax.jit(task.step)
        rng = np.random.default_rng(0)
        for _ in range(6):
            st, _ = step(st, jnp.asarray(rng.uniform(
                -1, 1, (n, task.num_actions)), jnp.float32))
        g = np.random.default_rng(1)
        nb, nv = task.model.nb, task.engine.nv
        leaves = {
            "mass": g.uniform(0.6, 1.5, (n, nb)),
            "damping": g.uniform(0.5, 1.5, (n, 1)),
            "stiffness": g.uniform(0.5, 1.5, (n, 1)),
            "friction": g.uniform(0.5, 1.5, (n, nb)),
            "shape": g.uniform(0.7, 1.4, (n, nb, 3))}
        leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
        tau = (0.3 * rng.normal(size=(n, nv))).astype(np.float32)
        rec.update({f"{name}_q": np.asarray(st.sim.q),
                    f"{name}_qd": np.asarray(st.sim.qd),
                    f"{name}_tau": tau})
        rec.update({f"{name}_phys_{k}": v for k, v in leaves.items()})
        for case in ("noshape", "shape"):
            lv = {k: jnp.asarray(v) for k, v in leaves.items()
                  if case == "shape" or k != "shape"}
            t0 = time.perf_counter()
            jdk._FORCE_INTERPRET = True
            try:
                sim, _ = task.engine.step(SimState(st.sim.q, st.sim.qd),
                                          Control(tau=jnp.asarray(tau)),
                                          phys=PhysScales(**lv))
            finally:
                jdk._FORCE_INTERPRET = False
            print(f"{name} {case}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
            rec[f"{name}_{case}_q"] = np.asarray(sim.q)
            rec[f"{name}_{case}_qd"] = np.asarray(sim.qd)
    out = os.path.join(DATA, "phys_step_b4.npz")
    np.savez_compressed(out, **rec)
    print(out, os.path.getsize(out), "bytes")


# --route-step: one task step on the JAX kernel route (every Pallas kernel
# in interpret mode, run eagerly) from a seeded state with a quarter of the
# envs flagged to reset, at 128 envs: the parity tests read it instead of
# stepping JAX themselves.  name -> file
ROUTE_STEPS = {"Ant": "ant_route_step.npz",
               "BallBalance": "ball_balance_route_step.npz",
               "FrankaReachMA": "franka_reach_ma_route_step.npz"}


def _route_step_start(name, task, n):
    """The state and actions each route-step test starts from:
    Ant from PRNGKey(5) with PRNGKey(6) actions, 5 steps on;
    BallBalance from PRNGKey(11), 10 steps of actions seeded with
    default_rng(128); FrankaReachMA from the B4-route capture's warmed-up
    state (franka_reach_ma_b4_golden.npz) and its first actions."""
    if name == "Ant":
        st = task.initial_state(jax.random.PRNGKey(5))
        acts = np.array(jax.random.uniform(
            jax.random.PRNGKey(6), (n, 8), minval=-1, maxval=1))
        step = jax.jit(task.step)
        for _ in range(5):
            st, _ = step(st, jnp.asarray(acts))
        return st, acts
    if name == "BallBalance":
        st = task.initial_state(jax.random.PRNGKey(11))
        step = jax.jit(task.step)
        rng = np.random.default_rng(n)
        for _ in range(10):
            st, _ = step(st, jnp.asarray(rng.uniform(-1, 1, (n, 3)),
                                         jnp.float32))
        return st, rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    from isaacgymenvs_ma_tpu.physics.engine import SimState
    from isaacgymenvs_ma_tpu.tasks.base import EnvState
    d = np.load(os.path.join(DATA, "franka_reach_ma_b4_golden.npz"))
    st = EnvState(
        sim=SimState(jnp.asarray(d["init_q"]), jnp.asarray(d["init_qd"])),
        progress=jnp.asarray(d["init_progress"]),
        reset_buf=jnp.asarray(d["init_reset_buf"]),
        rng=jax.random.PRNGKey(7),
        task=franka_reach_ma.FrankaMATaskState(
            actions=jnp.asarray(d["init_actions"])))
    return st, d["actions"][0]


def record_route_step(name):
    """``--route-step NAME`` -> ROUTE_STEPS[name]: the start state
    (``init_*``, as ``state_arrays``), the actions, the reset draws
    (``draw_<i>``) and the JAX kernel route's step: ``q``, ``qd``,
    ``progress``, ``task_*``, ``obs``, ``rew`` and ``reset``."""
    cls, task_cfg, draws_of = TASKS[name][:3]
    n = KERNEL_ROUTE_ENVS
    task = cls(deep_merge(task_cfg, {"env": {"numEnvs": n}}))
    st, acts = _route_step_start(name, task, n)
    if name != "FrankaReachMA":     # its capture's state keeps its flags
        st = st._replace(reset_buf=jnp.asarray(
            (np.arange(n) % 4 == 0).astype(np.int32)))
    draws = draws_of(jax.random.split(st.rng, 6)[1], task)
    t0 = time.perf_counter()
    jdk._FORCE_INTERPRET = True
    try:
        st2, res = task.step(st, jnp.asarray(acts))
    finally:
        jdk._FORCE_INTERPRET = False
    print(f"{name} interpreted step {time.perf_counter() - t0:.1f} s",
          flush=True)
    rec = {f"init_{k}": v for k, v in state_arrays(st).items()}
    rec["actions"] = np.asarray(acts, np.float32)
    rec.update({f"draw_{i}": np.asarray(v)
                for i, v in enumerate(draws.values())})
    rec.update({"q": np.asarray(st2.sim.q), "qd": np.asarray(st2.sim.qd),
                "progress": np.asarray(st2.progress),
                "obs": np.asarray(res.obs), "rew": np.asarray(res.rew),
                "reset": np.asarray(res.reset)})
    for f in st2.task._fields if st2.task is not None else ():
        rec[f"task_{f}"] = np.asarray(getattr(st2.task, f))
    out = os.path.join(DATA, ROUTE_STEPS[name])
    np.savez_compressed(out, **rec)
    print(out, os.path.getsize(out), "bytes")


# --dextreme NAME: the Dextreme captures, recorded as the hands' (32 envs,
# 6 steps, one step at a time with the reference's one-ulp spread)
DEXTREME = {"AllegroHandDextremeManualDR":
            "allegro_hand_dextreme_manual_dr_golden.npz",
            "AllegroHandDextremeADR": "allegro_hand_dextreme_adr_golden.npz"}
# the RNA refresh clock at the first recorded step: its masks are redrawn
# in the third (step_count % rnaRefreshInterval == 0)
DEXTREME_STEP_COUNT = 1198


def dextreme_reset_draws(k_reset, task):
    """Dextreme's reset_idx draws: the ADR rows' uniforms (N, P)
    (``fold_in(key, 11)``, ADR only), the hand's four (``hand_draws``),
    then the six per-episode normals of ``fold_in(key, 23)``."""
    n, A, nh = task.num_envs, task.num_actions, task.num_hand_dofs
    out = {}
    if task.use_adr:
        out["adr_u"] = jax.random.uniform(jax.random.fold_in(k_reset, 11),
                                          (n, task.adr.P))
    out.update(hand_draws(k_reset, task))
    ks = jax.random.split(jax.random.fold_in(k_reset, 23), 6)
    for k, name, w in zip(ks, ("act_bias_n", "pos_bias_n", "dof_bias_n",
                               "act_scale_n", "pos_scale_n", "dof_scale_n"),
                          (A, 3, nh, A, 3, nh)):
        out[name] = jax.random.normal(k, (n, w))
    return out


def dextreme_pre_draws(rng, rna_key, task):
    """Dextreme's pre_physics draws: ``fold_in(rng, 7)`` split 4 ways
    (the white action noise N(0, 1) (N, A), the RNA blend's U[0, 1) (N,),
    unused, the extra latency's U[0, 1) (N,)), the RNA refresh's mask
    uniforms from its own key (units,) per layer, then the hand's force
    draws (``hand_pre_draws``)."""
    n = task.num_envs
    k_n, k_p, _, k_d = jax.random.split(jax.random.fold_in(rng, 7), 4)
    _, *km = jax.random.split(rna_key, len(task.rna.units) + 1)
    out = {"act_noise_n": jax.random.normal(k_n, (n, task.num_actions)),
           "rna_u": jax.random.uniform(k_p, (n,)),
           "delay_u": jax.random.uniform(k_d, (n,))}
    out.update({f"mask_u_{i}": jax.random.uniform(k, (u,))
                for i, (k, u) in enumerate(zip(km, task.rna.units))})
    out.update(hand_pre_draws(rng, task))
    return out


def dextreme_step_draws(k_step, task):
    """Dextreme's post_physics draws: the hand's goals
    (``hand_step_draws``), ``fold_in(k_step, 13)`` split 5 ways (the
    unreliable flag's U[0, 1) (N,), position noise N(0, 1) (N, 3), axis
    (N, 3), angle (N,), the extra hold's U[0, 1) (N,)) and the dof noise
    N(0, 1) (N, nh) of ``fold_in(k_step, 17)``."""
    n = task.num_envs
    out = dict(hand_step_draws(k_step, task))
    ks = jax.random.split(jax.random.fold_in(k_step, 13), 5)
    out.update(unreliable_u=jax.random.uniform(ks[0], (n,)),
               cam_pos_n=jax.random.normal(ks[1], (n, 3)),
               cam_axis_n=jax.random.normal(ks[2], (n, 3)),
               cam_ang_n=jax.random.normal(ks[3], (n,)),
               hold_u=jax.random.uniform(ks[4], (n,)),
               dof_obs_n=jax.random.normal(jax.random.fold_in(k_step, 17),
                                           (n, task.num_hand_dofs)))
    return out


def dextreme_state_arrays(st):
    """A Dextreme EnvState as flat numpy arrays: the hand's fields as
    ``hand.<f>``, the RNA masks as ``rna.<i>``, the ADR state's as
    ``adr.<f>`` (ADR only) and the other task fields by name."""
    out = {"q": st.sim.q, "qd": st.sim.qd, "progress": st.progress,
           "reset_buf": st.reset_buf}
    t = st.task
    for f in t._fields:
        v = getattr(t, f)
        if f == "hand":
            out.update({f"hand.{g}": getattr(v, g) for g in v._fields})
        elif f == "rna":
            out.update({f"rna.{i}": m for i, m in enumerate(v.masks)})
        elif f == "adr":
            if v is not None:
                out.update({f"adr.{g}": getattr(v, g) for g in v._fields})
        elif v is not None:
            out[f] = v
    return {k: np.asarray(v) for k, v in out.items()}


def widened_adr_ranges(task, ranges):
    """Every ADR range widened inside its limits by max(20 delta, 0.05) on
    each side: live limit shifts, latency, refresh rate, affine scaling
    and restitution, as a loaded checkpoint can hold them."""
    c = task.adr.cfg
    w = np.maximum(20.0 * np.asarray(c.delta), 0.05)
    r = np.asarray(ranges)
    return jnp.asarray(np.stack([np.maximum(r[:, 0] - w, c.limit_lo),
                                 np.minimum(r[:, 1] + w, c.limit_hi)], -1),
                       jnp.float32)


def record_dextreme(name):
    """``--dextreme NAME`` -> DEXTREME[name] at 32 envs: warmed up 20
    steps (ADR: from ranges widened by ``widened_adr_ranges`` and loaded
    through ``set_env_state``), a quarter of the envs flagged to reset,
    HAND_SUCCESS_ENVS envs after them with their goals on their cubes'
    orientations, the RNA clock at DEXTREME_STEP_COUNT; then T steps, each
    with its draws, start state and one-ulp spread (as ONE_STEP).  Also
    the RNA's flax parameters as ``rna_params.<layer>.<kernel|bias>``."""
    from isaacgymenvs_ma_tpu.tasks import allegro_hand_dextreme as jdx
    n = 32
    task = jregistry.task_class(name)(deep_merge(
        jregistry.task_default_config(name), {"env": {"numEnvs": n}}))
    A = task.num_actions
    step = jax.jit(task.step)
    rng = np.random.default_rng(2024)
    st = task.initial_state(jax.random.PRNGKey(2024))
    if task.use_adr:
        adr = st.task.adr._replace(ranges=widened_adr_ranges(
            task, st.task.adr.ranges))
        st = task.set_env_state(st, {"adr": adr})
    t_w = time.perf_counter()
    for _ in range(WARMUP):
        st, _ = step(st, jnp.asarray(rng.uniform(-1, 1, (n, A)),
                                     jnp.float32))
    print(f"warm-up (jit + {WARMUP} steps) "
          f"{time.perf_counter() - t_w:.1f} s", flush=True)
    flags = np.asarray(st.reset_buf).copy()
    flags[: n // 4] = 1
    e0, qa = n // 4, task.obj_qa
    hand = st.task.hand
    goal = hand.goal_rot.at[e0: e0 + HAND_SUCCESS_ENVS].set(
        st.sim.q[e0: e0 + HAND_SUCCESS_ENVS, qa + 3: qa + 7])
    st = st._replace(reset_buf=jnp.asarray(flags, jnp.int32),
                     task=st.task._replace(
                         hand=hand._replace(goal_rot=goal),
                         step_count=jnp.asarray(DEXTREME_STEP_COUNT,
                                                jnp.int32)))
    actions = rng.uniform(-1, 1, (T, n, A)).astype(np.float32)
    rec = {"task": np.asarray(name), "atol": np.float32(2e-3)}
    rec.update({f"init_{k}": v for k, v in dextreme_state_arrays(st).items()})
    params = st.task.rna.params.get("params", st.task.rna.params)
    for layer, d in params.items():
        for k, v in d.items():
            rec[f"rna_params.{layer}.{k}"] = np.asarray(v)
    fields = {}
    blends = 0
    for t in range(T):
        _, k_reset, k_step, _, _, _ = jax.random.split(st.rng, 6)
        draws = dextreme_reset_draws(k_reset, task)
        draws.update(dextreme_pre_draws(st.rng, st.task.rna.key, task))
        draws.update(dextreme_step_draws(k_step, task))
        blends += int((np.asarray(draws["rna_u"]) < task.rna_prob).sum())
        for k, v in draws.items():
            fields.setdefault(k, []).append(np.asarray(v))
        start = st
        st, res = step(st, jnp.asarray(actions[t]))
        for k, v in dextreme_state_arrays(start).items():
            fields.setdefault(f"start_{k}", []).append(v)
        spread, flips = one_ulp_spread(step, start, jnp.asarray(actions[t]),
                                       res, st, rng)
        for k, v in spread.items():
            fields.setdefault(f"spread_{k}", []).append(v)
        fields.setdefault("spread_reset", []).append(flips)
        for k, v in (("obs", res.obs), ("rew", res.rew), ("reset", res.reset),
                     ("states", res.states), ("q", st.sim.q),
                     ("qd", st.sim.qd)):
            fields.setdefault(k, []).append(np.asarray(v))
        print(f"step {t}: resets {int(np.asarray(res.reset).sum())}, "
              f"successes {float(np.asarray(st.task.hand.successes).sum())}",
              flush=True)
    print("RNA blends in the recorded steps:", blends)
    rec["actions"] = actions
    for k, v in fields.items():
        rec[k] = np.stack(v)
    assert jdx.MAX_ACTION_LATENCY == rec["init_act_hist"].shape[1]
    out = os.path.join(DATA, DEXTREME[name])
    np.savez_compressed(out, **rec)
    print(out, os.path.getsize(out), "bytes")


def record_factory_engine():
    """factory_engine.npz: the JAX engine's steps of the Factory slice's
    features on the port's synthetic scene (parity.factory_engine_scene),
    FACTORY_ENGINE_STEPS steps at FACTORY_ENGINE_ENVS envs per case of
    parity.FACTORY_ENGINE_CASES, from the same start and torques; per case
    ``<case>_q``, ``_qd``, ``_lam_0..2`` (T, N, ...) after each step."""
    from isaacgymenvs_ma_tpu.models import model as jmd
    from isaacgymenvs_ma_tpu.physics import engine as jeng
    from isaacgymenvs_ma_tpu_torch.utils import parity as tparity
    n = tparity.FACTORY_ENGINE_ENVS
    rec = {}
    for case, (fields, damping) in tparity.FACTORY_ENGINE_CASES.items():
        model, pairs = tparity.factory_engine_scene(jmd, damping)
        q0, qd0, tau = tparity.factory_engine_start(model, n)
        params = jeng.SimParams(**tparity.factory_engine_params(fields))
        eng = jeng.PhysicsEngine(model, params, ground=True,
                                 pair_specs=pairs)
        step = jax.jit(eng.step)
        st = jeng.SimState(jnp.asarray(q0), jnp.asarray(qd0),
                           eng.zero_warm(n))
        out = {k: [] for k in ("q", "qd", "lam_0", "lam_1", "lam_2")}
        for t in range(len(tau)):
            st, _ = step(st, jeng.Control(tau=jnp.asarray(tau[t])))
            out["q"].append(np.asarray(st.q))
            out["qd"].append(np.asarray(st.qd))
            for i in range(3):
                out[f"lam_{i}"].append(
                    np.asarray(st.lam[i]) if st.lam is not None
                    else np.zeros((n, 1), np.float32))
        for k, v in out.items():
            rec[f"{case}_{k}"] = np.stack(v)
        print(case, "active rows at the end:",
              int((np.abs(rec[f"{case}_lam_0"][-1]) > 0).any(-1).sum()),
              flush=True)
    out_path = os.path.join(DATA, "factory_engine.npz")
    np.savez_compressed(out_path, **rec)
    print(out_path, os.path.getsize(out_path), "bytes")


# --amp-epoch: the JAX AMP learner's epoch on HumanoidAMP, cut to size
AMP_EPOCH_ENVS, AMP_EPOCH_SEED, AMP_EPOCH_UNITS = 8, 3, [64, 32]
AMP_EPOCH_CONFIG = dict(minibatch_size=64, horizon_length=8,
                        amp_batch_size=32)


def amp_epoch_train_config(configs):
    """The HumanoidAMP train config of amp_epoch.npz, from ``configs`` (the
    JAX package's or the port's copy)."""
    tcfg = configs.train_default_config("HumanoidAMP")
    tcfg["params"]["config"].update(AMP_EPOCH_CONFIG)
    tcfg["params"]["network"]["mlp"]["units"] = list(AMP_EPOCH_UNITS)
    return tcfg


def tree_arrays(prefix, tree):
    """A pytree's leaves as {prefix.key.key...: numpy array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        # DictKey, GetAttrKey (a NamedTuple's field) or SequenceKey
        keys = "".join(
            f".{getattr(k, 'key', getattr(k, 'name', getattr(k, 'idx', k)))}"
            for k in path)
        out[prefix + keys] = np.asarray(leaf)
    return out


def amp_learner_arrays(st, prefix):
    """A JAX AMPState's learner part as amp_epoch.npz keys."""
    ppo, amp = st.ppo, st.amp
    rec = {**tree_arrays(f"{prefix}params", ppo.params),
           **tree_arrays(f"{prefix}adam", ppo.opt_state[1]),
           **tree_arrays(f"{prefix}obs_rms", ppo.obs_rms._asdict()),
           **tree_arrays(f"{prefix}value_rms", ppo.value_rms._asdict()),
           **tree_arrays(f"{prefix}disc_params", amp.disc_params),
           **tree_arrays(f"{prefix}disc_adam", amp.disc_opt[0]),
           **tree_arrays(f"{prefix}amp_rms", amp.amp_rms._asdict())}
    n = int(amp.replay_n)
    rec[f"{prefix}replay"] = np.asarray(amp.replay[:n])
    rec[f"{prefix}replay_n"] = np.int32(n)
    for k in ("lr", "epoch", "frames", "ep_return", "ep_length",
              "mean_return", "mean_length", "last_obs"):
        rec[f"{prefix}{k}"] = np.asarray(getattr(ppo, k))
    es = ppo.env_state
    for k, v in (("q", es.sim.q), ("qd", es.sim.qd),
                 ("progress", es.progress), ("reset_buf", es.reset_buf),
                 ("amp_obs_hist", es.task.amp_obs_hist)):
        rec[f"{prefix}env_{k}"] = np.asarray(v)
    return rec


def record_amp_epoch():
    """amp_epoch.npz (module docstring)."""
    from isaacgymenvs_ma_tpu.learning import configs as jconfigs
    from isaacgymenvs_ma_tpu.learning.amp import AMPAgent
    task = humanoid_amp.HumanoidAMP(deep_merge(
        humanoid_amp.TASK_CFG, {"env": {"numEnvs": AMP_EPOCH_ENVS}}))
    agent = AMPAgent(task, amp_epoch_train_config(jconfigs),
                     seed=AMP_EPOCH_SEED)
    st = agent.init()
    t0 = time.perf_counter()
    for _ in range(2):
        st, _ = agent.train_epoch(st)
    print(f"two epochs (jit) {time.perf_counter() - t0:.1f} s", flush=True)

    @jax.jit
    def rollout(state):
        agent._amp_vars = state.amp
        ppo, roll, last_obs, _ = agent._rollout(state.ppo)
        roll = agent._transform_rewards(ppo, roll)
        adv, ret = agent._gae(ppo, roll, last_obs)
        return roll, adv, ret

    roll, adv, ret = rollout(st)
    rec = amp_learner_arrays(st, "init_")
    # the epoch's draws, from the keys as the JAX epoch splits them
    T, B, A = agent.horizon, task.rl_games_batch, task.num_actions
    key, noise = st.ppo.key, []
    for _ in range(T):
        key, k_act = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k_act, (B, A))))
    _, k_perm = jax.random.split(key)
    rec["perms"] = np.stack([
        np.asarray(jax.random.permutation(k, T * B))
        for k in jax.random.split(k_perm, agent.cfg.mini_epochs)])
    rec["noise"] = np.stack(noise)
    rng, ids, times = st.ppo.env_state.rng, [], []
    for _ in range(T):
        ks = jax.random.split(rng, 6)
        rng = ks[0]
        d = amp_draws(ks[1], task)
        ids.append(np.asarray(d["motion_ids"]))
        times.append(np.asarray(d["motion_times"]))
    rec["motion_ids"], rec["motion_times"] = np.stack(ids), np.stack(times)
    amp = st.amp
    _, k_demo, k_replay, k_mb = jax.random.split(amp.key, 4)
    k1, k2 = jax.random.split(k_demo)
    ml = task.motion_lib
    demo_ids = ml.sample_motions(k1, agent.amp_batch)
    rec["demo_ids"] = np.asarray(demo_ids)
    rec["demo_times"] = np.asarray(ml.sample_time(k2, demo_ids,
                                                  truncate_t=task.policy_dt))
    have = min(max(int(amp.replay_n), 1), agent.replay_size)
    rec["replay_idx"] = np.asarray(jax.random.randint(
        k_replay, (agent.amp_batch,), 0, have))
    rec["agent_idx"] = np.asarray(jax.random.randint(
        k_mb, (agent.amp_batch,), 0, T * B))
    st2, m = agent.train_epoch(st)
    for f in ("obs", "actions", "neglogp", "values", "rewards", "dones",
              "mu", "sigma", "aux"):
        rec[f"roll_{f}"] = np.asarray(getattr(roll, f))
    rec["adv"], rec["returns"] = np.asarray(adv), np.asarray(ret)
    rec.update({f"metric_{k}": np.asarray(v) for k, v in m.items()})
    rec.update(amp_learner_arrays(st2, "after_"))
    out = os.path.join(DATA, "amp_epoch.npz")
    np.savez_compressed(out, **rec)
    print(out, os.path.getsize(out), "bytes")


# factory_lift_eval.npz: the untrained policy's seed and the episode
LIFT_EVAL_SEED, LIFT_EVAL_EPISODE = 5, 12


def record_factory_lift_eval():
    """factory_lift_eval.npz (see the module docstring): the JAX script's
    main with its task made at 8 envs and a LIFT_EVAL_EPISODE-step
    episode, and its task's reset, step and epilogue wrapped to record
    what they take and give."""
    import contextlib
    import importlib.util
    import io
    import re
    from isaacgymenvs_ma_tpu.learning.ppo import PPOAgent
    spec = importlib.util.spec_from_file_location(
        "eval_factory_lift", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "eval_factory_lift.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    rec, steps = {}, {"reset": []}
    create_task = script.registry.create_task

    def make_task(name, cfg, seed=None):
        task = create_task(name, deep_merge(cfg, {
            "env": {"numEnvs": 8},
            "rl": {"max_episode_length": LIFT_EVAL_EPISODE}}), seed=seed)
        assert task.randomizer is None
        reset, step, lift = task.reset, task.step, task.evaluate_lift

        def recorded_reset(st):
            rec.update({f"init_{k}": v for k, v in state_arrays(st).items()})
            return reset(st)

        def recorded_step(st, actions):
            draws = factory_draws(jax.random.split(st.rng, 6)[1], task)
            st, res = step(st, actions)
            jax.debug.callback(lambda d, r: [
                steps.setdefault(k, []).append(np.asarray(v))
                for k, v in {**d, "reset": r}.items()], draws, res.reset,
                ordered=True)
            return st, res

        def recorded_lift(st):
            lifted = lift(st)
            nut_z = task.engine.forward(st.sim).root_states[:, 2, 2]
            jax.debug.callback(lambda *a: rec.update(zip(
                ("progress", "q", "nut_z", "lifted"), map(np.asarray, a))),
                st.progress, st.sim.q, nut_z, lifted, ordered=True)
            return lifted
        task.reset, task.step = recorded_reset, recorded_step
        task.evaluate_lift = recorded_lift
        return task

    class RecordedAgent(PPOAgent):
        def init(self, *args):
            st = super().init(*args)
            rec.update({**tree_arrays("params", st.params),
                        **tree_arrays("adam", st.opt_state[1]),
                        **tree_arrays("obs_rms", st.obs_rms._asdict()),
                        **tree_arrays("value_rms", st.value_rms._asdict()),
                        "lr": np.asarray(st.lr)})
            return st

    def train_config(name, overrides):
        # no update runs: one minibatch of the 8 envs' rollout
        cfg = load_train_config(name, overrides)
        c = cfg["params"]["config"]
        c["minibatch_size"] = 8 * int(c["horizon_length"])
        return cfg
    load_train_config = script.load_train_config
    script.registry.create_task = make_task
    script.PPOAgent = RecordedAgent
    script.load_train_config = train_config
    out = io.StringIO()
    argv = sys.argv
    sys.argv = ["eval_factory_lift.py", "random", str(LIFT_EVAL_SEED)]
    try:
        with contextlib.redirect_stdout(out):
            script.main()
    finally:
        sys.argv = argv
        script.registry.create_task = create_task
    text = out.getvalue()
    print(text)

    def num(label):
        return re.search(re.escape(label) + r"[^:]*: (\S+)", text).group(1)
    rec.update({k: np.stack(v) for k, v in steps.items()})
    rec.update(task=np.asarray("FactoryTaskNutBoltPick"),
               rl_max_episode_length=np.int32(LIFT_EVAL_EPISODE),
               seed=np.int32(LIFT_EVAL_SEED),
               full_episode=np.int32(num("full-episode")),
               early_resets=np.int32(num("early resets total")),
               raw=np.asarray(num("raw lift success")),
               lift=np.asarray(num("close-and-lift epilogue success")),
               lift_all=np.asarray(num("epilogue success over ALL envs")))
    path = os.path.join(DATA, "factory_lift_eval.npz")
    np.savez_compressed(path, **rec)
    print(path, os.path.getsize(path), "bytes")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="Ant", choices=sorted(TASKS))
    ap.add_argument("--kernel-route", action="store_true",
                    help="record the steps on the JAX contact-kernel route")
    ap.add_argument("--phys-step", action="store_true",
                    help="record phys_step_b4.npz (PHYS_STEP_TASKS)")
    ap.add_argument("--route-step", choices=sorted(ROUTE_STEPS),
                    help="record one interpreted kernel-route step "
                         "(ROUTE_STEPS)")
    ap.add_argument("--dextreme", choices=sorted(DEXTREME),
                    help="record a Dextreme capture (DEXTREME)")
    ap.add_argument("--factory-engine", action="store_true",
                    help="record factory_engine.npz")
    ap.add_argument("--amp-epoch", action="store_true",
                    help="record amp_epoch.npz")
    ap.add_argument("--factory-lift-eval", action="store_true",
                    help="record factory_lift_eval.npz")
    args = ap.parse_args()
    if args.factory_lift_eval:
        return record_factory_lift_eval()
    if args.amp_epoch:
        return record_amp_epoch()
    if args.factory_engine:
        return record_factory_engine()
    if args.dextreme:
        return record_dextreme(args.dextreme)
    if args.route_step:
        return record_route_step(args.route_step)
    if args.phys_step:
        return record_phys_step()
    cls, task_cfg, draws_of, n, fname = TASKS[args.task]
    if args.kernel_route:
        n = KERNEL_ROUTE_ENVS
        fname = fname.replace("_golden", "_b4_golden")
    task = cls(deep_merge(task_cfg, {"env": {"numEnvs": n}}))
    A, B = task.num_actions, task.rl_games_batch
    step = jax.jit(task.step)
    rng = np.random.default_rng(2024)
    if args.task in ROLLOUTS:
        seed, steps = ROLLOUTS[args.task]
        st = task.initial_state(jax.random.PRNGKey(seed))
        a = jnp.sin(0.1 * jnp.arange(steps, dtype=jnp.float32))
        actions = np.repeat(np.asarray(a)[:, None, None], B, axis=1)
    else:
        st = task.initial_state(jax.random.PRNGKey(2024))
        t_w = time.perf_counter()
        for _ in range(WARMUP):
            st, _ = step(st, jnp.asarray(rng.uniform(-1, 1, (B, A)),
                                         jnp.float32))
        print(f"warm-up (jit + {WARMUP} steps) "
              f"{time.perf_counter() - t_w:.1f} s", flush=True)
        flags = np.asarray(st.reset_buf).copy()
        flags[: n // 4] = 1
        st = st._replace(reset_buf=jnp.asarray(flags, jnp.int32))
        steps = (GRAB_STEPS if args.task in GRAB_TASKS
                 and not args.kernel_route
                 else AMP_STEPS if args.task in AMP_TASKS else T)
        actions = rng.uniform(-1, 1, (steps, B, A)).astype(np.float32)
        if args.task in GRAB_TASKS:
            grab_envs = np.arange(n // 4, n // 4 + n // 2)
            make_live = (cabinet_live_grabs if args.task == "FrankaCabinet"
                         else live_grabs)
            st = make_live(st, task, actions, grab_envs)
        if args.task in HANDS:
            e0 = n // 4
            qa = task.obj_qa
            goal = st.task.goal_rot.at[e0: e0 + HAND_SUCCESS_ENVS].set(
                st.sim.q[e0: e0 + HAND_SUCCESS_ENVS, qa + 3: qa + 7])
            st = st._replace(task=st.task._replace(goal_rot=goal))
            print("envs with a nonzero object force:",
                  int((jnp.abs(st.task.rb_force).sum(-1) > 0).sum()),
                  flush=True)
        if args.task == "AnymalTerrain":
            st = st._replace(task=st.task._replace(common_step=jnp.asarray(
                task.push_interval - 1 - PUSH_AT, jnp.int32)))
    rec = {
        "task": np.asarray(args.task), "atol": np.float32(2e-3),
        "init_q": np.asarray(st.sim.q), "init_qd": np.asarray(st.sim.qd),
        "init_progress": np.asarray(st.progress),
        "init_reset_buf": np.asarray(st.reset_buf),
    }
    for f in st.task._fields if st.task is not None else ():
        rec[f"init_{f}"] = np.asarray(getattr(st.task, f))
    for i, x in enumerate(st.sim.lam if st.sim.lam is not None else ()):
        rec[f"init_lam_{i}"] = np.asarray(x)
    if args.task in FACTORY:
        rec["rl_max_episode_length"] = np.int32(FACTORY_EPISODE)
    for f, v in (st.phys._asdict().items() if st.phys is not None else ()):
        if v is not None:
            rec[f"init_phys_{f}"] = np.asarray(v)
    if args.task in GRAB_TASKS:
        rec["grab_envs"] = grab_envs
    fields = {k: [] for k in ("obs", "rew", "reset", "q", "qd")}
    if args.kernel_route:
        jdk._FORCE_INTERPRET = True
        eng = task.engine
        P = eng.n_ground + eng.n_pair_rows
        # B4 takes H^-1 from the dynamics kernels: without them the JAX
        # engine runs its compacting XLA loop.  AllegroKukaTwoArms' plan
        # exceeds their VMEM budget at every block, so it has no kernel
        # route to record (on the TPU either)
        assert jdk.supports(eng, n, jnp.float32) and jck.supports(
            eng, n, jnp.float32, P, len(eng.attractors), len(eng.grabs),
            bool(eng.pairs)), "the JAX engine would not take its kernels"
        # traced with the flag set (it is read while tracing): the
        # interpreted kernels compiled once (~3.5 min at AllegroKuka), then
        # ~40 s a step against ~3 min eager.  A fresh function, so no
        # trace of task.step without the flag is reused
        step = jax.jit(lambda s, a: task.step(s, a))
    st0 = st
    t0 = time.perf_counter()
    for t in range(len(actions)):
        if t == 1:
            print(f"first step (jit or interpret) "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        # VecTaskBase.step's keys: reset_idx's, post_physics's rng and the
        # domain randomizer's
        _, k_reset, k_step, k_an, k_on, k_ph = jax.random.split(st.rng, 6)
        draws = draws_of(k_reset, task)
        if args.task in STEP_DRAWS:
            draws.update(STEP_DRAWS[args.task](k_step, task))
        if args.task in PRE_DRAWS:
            draws.update(PRE_DRAWS[args.task](st.rng, task))
        if task.randomizer is not None and st.phys is not None:
            draws.update(dr_draws(k_an, k_on, k_ph, st, task, (B, A)))
        for k, v in draws.items():
            fields.setdefault(k, []).append(np.asarray(v))
        start = st
        st, res = step(st, jnp.asarray(actions[t]))
        if args.task in ONE_STEP:
            for k, v in state_arrays(start).items():
                fields.setdefault(f"start_{k}", []).append(v)
            spread, flips = one_ulp_spread(step, start,
                                           jnp.asarray(actions[t]), res, st,
                                           rng)
            for k, v in spread.items():
                fields.setdefault(f"spread_{k}", []).append(v)
            fields.setdefault("spread_reset", []).append(flips)
        fields["obs"].append(np.asarray(res.obs))
        fields["rew"].append(np.asarray(res.rew))
        fields["reset"].append(np.asarray(res.reset))
        fields["q"].append(np.asarray(st.sim.q))
        fields["qd"].append(np.asarray(st.sim.qd))
    if args.task in TRAJ_SPREAD:
        rec.update(trajectory_spread(step, st0, actions, fields, rng))
    jdk._FORCE_INTERPRET = False
    rec["actions"] = actions
    for k, v in fields.items():
        rec[k] = np.stack(v)
    out = os.path.join(DATA, fname)
    os.makedirs(DATA, exist_ok=True)
    np.savez_compressed(out, **rec)
    print(out, os.path.getsize(out), "bytes")


if __name__ == "__main__":
    main()
