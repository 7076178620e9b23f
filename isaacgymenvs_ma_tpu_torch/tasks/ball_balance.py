"""BallBalance (port of isaacgymenvs_ma_tpu/tasks/ball_balance.py) —
obs 24 / act 3.

A free-floating tripod "balance bot" (tray + 3 two-segment legs, built
procedurally with the reference generator's parameters) balances a ball
dropped onto the tray.  What the step exercises in the engine:

* position-PD drives on the lower-leg dofs (kp 4000 / kd 100) with
  rate-integrated position targets (``targets += dt * speed_scale * a``),
* three rigid-body attractors pinning the feet to the ground, solved as
  bilateral rows,
* one ball-vs-tray body-pair contact row (sphere against the cylinder's SDF)
  with a tangent frame,
* three offset force sensors on the tray, which read the pair row from its
  body-b end,
* resets happen before physics (``reset_in_pre_physics``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..models.model import (DRIVE_POS, FREE, GEOM_CAPSULE, GEOM_CYLINDER,
                            GEOM_SPHERE, HINGE, ModelBuilder)
from ..ops.rng import rand_float, random_dir_2
from ..physics.engine import Control, PhysicsEngine, SimState
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "BallBalance",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 4096,
        "envSpacing": 2.0,
        "maxEpisodeLength": 500,
        "actionSpeedScale": 20,
        "enableDebugVis": False,
        "clipObservations": 5.0,
        "clipActions": 1.0,
    },
    "sim": {
        "dt": 0.01,
        "substeps": 2,
        "up_axis": "z",
        "use_gpu_pipeline": True,
        "gravity": [0.0, 0.0, -9.81],
        "physx": {
            "num_threads": 4, "solver_type": 1, "use_gpu": True,
            "num_position_iterations": 8, "num_velocity_iterations": 0,
            "contact_offset": 0.02, "rest_offset": 0.001,
            "bounce_threshold_velocity": 0.2, "max_depenetration_velocity": 1000.0,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 1048576, "contact_collection": 0,
        },
    },
    "task": {"randomize": False},
}

# generator parameters (ref :139-146)
TRAY_RADIUS = 0.5
TRAY_THICKNESS = 0.02
LEG_RADIUS = 0.02
LEG_OUTER_OFFSET = TRAY_RADIUS - 0.1
LEG_LENGTH = LEG_OUTER_OFFSET - 2 * LEG_RADIUS
LEG_INNER_OFFSET = LEG_OUTER_OFFSET - LEG_LENGTH / math.sqrt(2)
TRAY_HEIGHT = LEG_LENGTH * math.sqrt(2) + 2 * LEG_RADIUS + 0.5 * TRAY_THICKNESS
BALL_RADIUS = 0.1
LEG_ANGLES = [0.0, 2.0 / 3.0 * math.pi, 4.0 / 3.0 * math.pi]


def _euler_zyx_quat(roll, pitch, yaw):
    """gymapi.Quat.from_euler_zyx(r, p, y): R = Rz(y) @ Ry(p) @ Rx(r)."""
    cr, sr = math.cos(roll / 2), math.sin(roll / 2)
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    return np.array([
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
        cy * cp * cr + sy * sp * sr,
    ])


def build_balance_bot():
    """Tripod + ball scene with the reference generator's parameters
    (copy of the JAX package's ``build_balance_bot``).  Returns the model,
    the (ball geom, tray geom) contact pair and the attractor specs."""
    b = ModelBuilder()
    b.begin_actor()
    tray = b.add_body("tray", -1, FREE, body_pos=(0, 0, TRAY_HEIGHT))
    tray_geom = b.add_geom(tray, GEOM_CYLINDER,
                           (TRAY_RADIUS, 0.5 * TRAY_THICKNESS, 0.0),
                           density=100.0)
    attractor_specs = []
    lower_legs = []
    for i, angle in enumerate(LEG_ANGLES):
        ca, sa = math.cos(angle), math.sin(angle)
        up_from = np.array([LEG_OUTER_OFFSET * ca, LEG_OUTER_OFFSET * sa,
                            -LEG_RADIUS - 0.5 * TRAY_THICKNESS])
        up_to = np.array([LEG_INNER_OFFSET * ca, LEG_INNER_OFFSET * sa,
                          up_from[2] - LEG_LENGTH / math.sqrt(2)])
        up_pos = 0.5 * (up_from + up_to)
        up_quat = _euler_zyx_quat(0.0, -0.75 * math.pi, angle)
        upper = b.add_body(
            f"upper_leg{i}", tray, HINGE, jnt_axis=(0, 1, 0),
            jnt_pos=(0, 0, -0.5 * LEG_LENGTH),
            body_pos=up_pos, body_quat=up_quat,
            limit_lower=-math.pi / 4, limit_upper=math.pi / 4,
        )
        b.add_geom(upper, GEOM_CAPSULE, (LEG_RADIUS, 0.5 * LEG_LENGTH, 0.0),
                   density=1000.0)
        lower = b.add_body(
            f"lower_leg{i}", upper, HINGE, jnt_axis=(0, 1, 0),
            jnt_pos=(0, 0, -0.5 * LEG_LENGTH),
            body_pos=(-0.5 * LEG_LENGTH, 0, 0.5 * LEG_LENGTH),
            body_quat=_euler_zyx_quat(0.0, -0.5 * math.pi, 0.0),
            limit_lower=np.deg2rad(-70), limit_upper=np.deg2rad(90),
        )
        b.add_geom(lower, GEOM_CAPSULE, (LEG_RADIUS, 0.5 * LEG_LENGTH, 0.0),
                   density=1000.0)
        lower_legs.append(lower)
        # the attractor pins the foot (far end of the lower leg) to the
        # ground at the leg's mount radius (ref :306-320)
        attractor_specs.append((
            lower, np.array([0.0, 0.0, 0.5 * LEG_LENGTH]),
            np.array([LEG_OUTER_OFFSET * ca, LEG_OUTER_OFFSET * sa, LEG_RADIUS]),
        ))
        # tray force sensor at the leg mount (ref :265-271)
        b.add_force_sensor(tray, (LEG_OUTER_OFFSET * ca, LEG_OUTER_OFFSET * sa, 0.0))

    # ball actor (ref :273-277, start pose x=0.2 z=2.0)
    b.begin_actor()
    ball = b.add_body("ball", -1, FREE, body_pos=(0.2, 0, 2.0))
    ball_geom = b.add_geom(ball, GEOM_SPHERE, (BALL_RADIUS, 0, 0), density=200.0)

    m = b.finalize()
    # drive modes: lower-leg dofs position-PD kp 4000 / kd 100 (ref :289-299)
    for lower in lower_legs:
        va = int(m.v_adr[lower])
        m.dof_drive_mode[va] = DRIVE_POS
        m.dof_stiffness[va] = 4000.0
        m.dof_drive_damping[va] = 100.0
    return m, (ball_geom, tray_geom), attractor_specs


class BBTaskState(NamedTuple):
    dof_position_targets: torch.Tensor   # (N, 6)


class BallBalance(VecTaskBase):
    reset_in_pre_physics = True

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        cfg["env"]["numObservations"] = 24
        cfg["env"]["numActions"] = 3
        cfg["env"]["episodeLength"] = int(cfg["env"].get("maxEpisodeLength", 500))
        self.action_speed_scale = float(cfg["env"]["actionSpeedScale"])
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)
        m = self.model
        sd = self.engine.scalar_dofs
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=self.device)
        # the bbot dofs are the 6 hinge dofs; actuated: the lower legs
        self.bbot_dof_lower = f32(np.asarray(m.dof_lower)[sd])
        self.bbot_dof_upper = f32(np.asarray(m.dof_upper)[sd])
        self.actuated = [1, 3, 5]
        self.ball_body = m.body_names.index("ball")
        self.ball_qa = int(m.q_adr[self.ball_body])
        self.ball_va = int(m.v_adr[self.ball_body])
        self.tray0 = f32([0.0, 0.0, TRAY_HEIGHT, 0.0, 0.0, 0.0, 1.0])

    def create_model(self):
        model, pair, attractors = build_balance_bot()
        self._pair = pair
        self._attractors = attractors
        return model, True

    def build_engine(self, model, ground):
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=[self._pair],
                             attractors=self._attractors, device=self.device)

    # ------------------------------------------------------------------
    def initial_task_state(self):
        return BBTaskState(dof_position_targets=torch.zeros(
            (self.num_envs, 6), dtype=DTYPE, device=self.device))

    def pre_physics(self, state: EnvState, actions) -> Control:
        n, nv = self.num_envs, self.engine.nv
        targets = state.task.dof_position_targets.clone()
        targets[:, self.actuated] += self.dt * self.action_speed_scale * actions
        targets = torch.clamp(targets, self.bbot_dof_lower, self.bbot_dof_upper)
        # the reference zeroes the targets of envs reset this very step
        # after the increment (ref :416-421)
        targets = torch.where((state.reset_buf > 0)[:, None], 0.0, targets)
        self._new_targets = targets   # the task state post_physics returns
        pos_target = torch.zeros((n, nv), dtype=DTYPE, device=self.device)
        pos_target[:, self.engine.scalar_dofs] = targets
        zeros = torch.zeros((n, nv), dtype=DTYPE, device=self.device)
        return Control(tau=zeros, pos_target=pos_target, vel_target=zeros)

    def draw_reset(self):
        """Reset draws from the task generator (ref :369-393): ball drop
        distance (N, 1), planar direction (N, 2), horizontal speed (N, 1)
        and height (N,)."""
        n, g = self.num_envs, self.generator
        return (rand_float(g, 0.001, 0.5, (n, 1)),
                random_dir_2(g, (n, 1))[:, 0, :],
                rand_float(g, 0.0, 5.0, (n, 1)),
                rand_float(g, 1.0, 2.0, (n,)))

    def reset_idx(self, sim: SimState, task: BBTaskState, mask, draws=None):
        dists, dirs, hspeeds, height = (self.draw_reset() if draws is None
                                        else draws)
        n = self.num_envs
        zeros6 = torch.zeros((n, 6), dtype=DTYPE, device=self.device)
        # bbot: zero dofs, tray back to its construction pose
        sim = self.engine.set_dof_pos(
            sim, masked_update(mask, zeros6, self.engine.dof_pos(sim)))
        sim = self.engine.set_dof_vel(
            sim, masked_update(mask, zeros6, self.engine.dof_vel(sim)))
        q, qd = sim.q.clone(), sim.qd.clone()
        q[:, 0:7] = masked_update(mask, self.tray0.expand(n, 7), q[:, 0:7])
        qd[:, 0:6] = masked_update(mask, zeros6, qd[:, 0:6])
        # ball: random drop toward the tray centre
        hpos = dists * dirs
        speedscales = (dists - 0.001) / (0.5 - 0.001)
        hvels = -speedscales * hspeeds * dirs
        ball_q = torch.cat([hpos, height[:, None],
                            torch.zeros((n, 3), dtype=DTYPE, device=self.device),
                            torch.ones((n, 1), dtype=DTYPE, device=self.device)],
                           dim=-1)
        ball_qd = torch.cat([hvels, torch.full((n, 1), -5.0, dtype=DTYPE,
                                               device=self.device),
                             torch.zeros((n, 3), dtype=DTYPE,
                                         device=self.device)], dim=-1)
        qa, va = self.ball_qa, self.ball_va
        q[:, qa: qa + 7] = masked_update(mask, ball_q, q[:, qa: qa + 7])
        qd[:, va: va + 6] = masked_update(mask, ball_qd, qd[:, va: va + 6])
        task = BBTaskState(dof_position_targets=masked_update(
            mask, zeros6, task.dof_position_targets))
        return SimState(q, qd), task

    def post_physics(self, state: EnvState, out, actions):
        dof_pos = self.engine.dof_pos(state.sim)
        dof_vel = self.engine.dof_vel(state.sim)
        ball = out.root_states[:, 1]
        ball_pos = ball[:, 0:3]
        ball_vel = ball[:, 7:10]
        sf = out.sensor_forces   # (N, 3, 6) [force, torque] in the tray frame
        obs = torch.cat([
            dof_pos[:, self.actuated], dof_vel[:, self.actuated],
            ball_pos, ball_vel,
            sf[:, :, 0] / 20.0,        # sensor force x (ref :344)
            sf[:, :, 3] / 20.0,        # sensor torque x
            sf[:, :, 4] / 20.0,        # sensor torque y
            sf[:, :, 5] / 20.0,        # sensor torque z
        ], dim=-1)
        # reward (ref :459-474)
        ball_dist = torch.sqrt(ball_pos[:, 0] ** 2
                               + (ball_pos[:, 2] - 0.7) ** 2
                               + ball_pos[:, 1] ** 2)
        ball_speed = torch.linalg.vector_norm(ball_vel, dim=-1)
        reward = 1.0 / (1.0 + ball_dist) / (1.0 + ball_speed)
        reset = ((state.progress >= self.max_episode_length - 1)
                 | (ball_pos[:, 2] < BALL_RADIUS * 1.5)).to(torch.int32)
        task = BBTaskState(dof_position_targets=self._new_targets)
        return obs, None, reward, reset, task, {}
