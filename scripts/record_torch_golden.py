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

    JAX_PLATFORMS=cpu python scripts/record_torch_golden.py [--task NAME]
        [--kernel-route] [--phys-step]
"""
import argparse
import os
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
                                       franka_reach_ma, humanoid, ingenuity,
                                       quadcopter, trifinger)
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
STEP_DRAWS = {"AnymalTerrain": anymal_terrain_step_draws,
              "Ingenuity": ingenuity_step_draws,
              **{h: hand_step_draws for h in HANDS}}
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
ONE_STEP = ("AnymalTerrain", "AllegroKuka", "AllegroKukaTwoArms", *HANDS)
SPREAD_RUNS = 8


def state_arrays(st):
    """The env state a step starts from, as flat numpy arrays."""
    out = {"q": st.sim.q, "qd": st.sim.qd, "progress": st.progress,
           "reset_buf": st.reset_buf}
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="Ant", choices=sorted(TASKS))
    ap.add_argument("--kernel-route", action="store_true",
                    help="record the steps on the JAX contact-kernel route")
    ap.add_argument("--phys-step", action="store_true",
                    help="record phys_step_b4.npz (PHYS_STEP_TASKS)")
    args = ap.parse_args()
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
                 and not args.kernel_route else T)
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
