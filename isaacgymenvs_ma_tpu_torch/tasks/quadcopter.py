"""Quadcopter (port of isaacgymenvs_ma_tpu/tasks/quadcopter.py): obs 21 /
act 12.

A free cylinder chassis and 4 gimbaled rotor arms (nb 9, nv 14): per arm
a pitch and a roll hinge (+-30 deg, position PD kp 1000) whose targets
integrate at 8 pi rad/s, and 4 rotor thrusts integrating at 200 N/s,
clamped to [0, 2] N and applied along each rotor's z axis as external
wrenches (``Control.f_ext``), the rotor frames from the plain
``PhysicsEngine.fk`` as the JAX task takes them from its XLA FK.  Hover
target (0, 0, 1); obs = [(target - pos) / 3, quat, linvel / 2,
angvel / pi, dof_pos (8)]; die at a distance above 3 or below z = 0.3.
The cylinder chassis gives no ground candidate, so the scene has no
contact rows and steps through the joint-limit solve
(``PhysicsEngine._limit_solve``) on the rotor limits.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..models.model import (DRIVE_POS, FREE, GEOM_CYLINDER, GEOM_SPHERE,
                            HINGE, ModelBuilder)
from ..ops import maths
from ..ops.rng import rand_float
from ..physics.engine import Control, SimState
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "Quadcopter",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 4096,
        "envSpacing": 1.25,
        "episodeLength": 500,
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
            "num_position_iterations": 4, "num_velocity_iterations": 0,
            "contact_offset": 0.02, "rest_offset": 0.001,
            "bounce_threshold_velocity": 0.2,
            "max_depenetration_velocity": 1000.0,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 1048576, "contact_collection": 0,
        },
    },
    "task": {"randomize": False},
}

CHASSIS_RADIUS = 0.1
ROTOR_ARM_RADIUS = 0.01
ROTOR_RADIUS = 0.04


def build_quadcopter():
    b = ModelBuilder()
    b.begin_actor()
    chassis = b.add_body("chassis", -1, FREE, body_pos=(0, 0, 1.0))
    b.add_geom(chassis, GEOM_CYLINDER, (CHASSIS_RADIUS, 0.015, 0.0),
               density=50.0)
    rotors = []
    angles = [0.25 * math.pi, 0.75 * math.pi, 1.25 * math.pi, 1.75 * math.pi]
    arm_off = CHASSIS_RADIUS + 0.25 * ROTOR_ARM_RADIUS
    rotor_off = ROTOR_RADIUS + 0.25 * ROTOR_ARM_RADIUS
    for i, a in enumerate(angles):
        qz = np.array([0.0, 0.0, math.sin(a / 2), math.cos(a / 2)])
        pos = np.array([arm_off * math.cos(a), arm_off * math.sin(a), 0.0])
        arm = b.add_body(f"rotor_arm_{i}", chassis, HINGE, jnt_axis=(0, 1, 0),
                         body_pos=pos, body_quat=qz,
                         limit_lower=-math.pi / 6, limit_upper=math.pi / 6)
        b.add_geom(arm, GEOM_SPHERE, (ROTOR_ARM_RADIUS, 0, 0), density=200.0,
                   contact=False)
        rotor = b.add_body(f"rotor_{i}", arm, HINGE, jnt_axis=(1, 0, 0),
                           body_pos=(rotor_off, 0, 0),
                           limit_lower=-math.pi / 6, limit_upper=math.pi / 6)
        b.add_geom(rotor, GEOM_CYLINDER, (ROTOR_RADIUS, 0.005, 0.0),
                   density=1000.0, contact=False)
        rotors.append(rotor)
    m = b.finalize()
    for d in range(6, m.nv):
        m.dof_drive_mode[d] = DRIVE_POS
        m.dof_stiffness[d] = 1000.0
        m.dof_drive_damping[d] = 0.0
    return m, rotors


class QuadTaskState(NamedTuple):
    dof_targets: torch.Tensor  # (N, 8)
    thrusts: torch.Tensor      # (N, 4)


class Quadcopter(VecTaskBase):
    # the envs flagged on the previous step reset before physics
    reset_in_pre_physics = True

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        cfg["env"]["numObservations"] = 21
        cfg["env"]["numActions"] = 12
        super().__init__(cfg, device=device, seed=seed,
                         sim_params=sim_params)
        self.max_thrust = 2.0
        m = self.model
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=self.device)
        sd = self.engine.scalar_dofs
        self.dof_lower = f32(np.asarray(m.dof_lower)[sd])
        self.dof_upper = f32(np.asarray(m.dof_upper)[sd])
        self.target = f32([0.0, 0.0, 1.0])
        self.root0 = f32([0.0, 0.0, 1.0])
        self.quat0 = f32([0.0, 0.0, 0.0, 1.0])
        self._new_task = None

    def create_model(self):
        model, rotors = build_quadcopter()
        self.rotor_bodies = list(rotors)
        return model, True

    def initial_task_state(self):
        n = self.num_envs
        return QuadTaskState(
            dof_targets=torch.zeros((n, 8), dtype=DTYPE, device=self.device),
            thrusts=torch.zeros((n, 4), dtype=DTYPE, device=self.device))

    # ------------------------------------------------------------------
    def pre_physics(self, state: EnvState, actions) -> Control:
        """The arm targets and rotor thrusts integrated from the actions
        (quadcopter.py:119-144); the new task state waits in
        ``_new_task`` for ``post_physics``, as in the JAX task."""
        n, nb, nv = self.num_envs, self.engine.nb, self.engine.nv
        task: QuadTaskState = state.task
        rmask = (state.reset_buf > 0)[:, None]
        targets = torch.clamp(
            task.dof_targets + self.dt * 8.0 * math.pi * actions[:, 0:8],
            self.dof_lower, self.dof_upper)
        thrusts = torch.clamp(task.thrusts + self.dt * 200.0
                              * actions[:, 8:12], 0.0, self.max_thrust)
        # reset envs: zero thrust, hold the current dof positions
        targets = torch.where(rmask, self.engine.dof_pos(state.sim), targets)
        thrusts = torch.where(rmask, 0.0, thrusts)
        self._new_task = QuadTaskState(dof_targets=targets, thrusts=thrusts)

        # thrust along each rotor body's z axis, in world axes
        _, bq = self.engine.fk(state.sim.q)
        f_ext = torch.zeros((n, nb, 6), dtype=DTYPE, device=self.device)
        for i, rb in enumerate(self.rotor_bodies):
            f_ext[:, rb, 3:6] = thrusts[:, i: i + 1] * maths.quat_axis(
                bq[:, rb], 2)
        pos_target = torch.zeros((n, nv), dtype=DTYPE, device=self.device)
        pos_target[:, self.engine.scalar_dofs_t] = targets
        zeros = torch.zeros((n, nv), dtype=DTYPE, device=self.device)
        return Control(tau=zeros, pos_target=pos_target, vel_target=zeros,
                       f_ext=f_ext)

    def draw_reset(self):
        """Reset draws from the task generator: the chassis offsets xy
        U(-1.5, 1.5) (N, 2) and z U(-0.2, 1.5) (N, 1), and the dof
        positions U(-0.2, 0.2) (N, 8) (quadcopter.py:146-163)."""
        n, g = self.num_envs, self.generator
        return (rand_float(g, -1.5, 1.5, (n, 2)),
                rand_float(g, -0.2, 1.5, (n, 1)),
                rand_float(g, -0.2, 0.2, (n, 8)))

    def reset_idx(self, sim: SimState, task: QuadTaskState, mask,
                  draws=None):
        off_xy, off_z, dof = self.draw_reset() if draws is None else draws
        n = self.num_envs
        q, qd = sim.q.clone(), sim.qd.clone()
        root = torch.cat([self.root0 + torch.cat([off_xy, off_z], -1),
                          self.quat0.expand(n, 4)], -1)
        q[:, 0:7] = masked_update(mask, root, q[:, 0:7])
        qd[:, 0:6] = masked_update(mask, torch.zeros_like(qd[:, 0:6]),
                                   qd[:, 0:6])
        sim = SimState(q, qd)
        sim = self.engine.set_dof_pos(
            sim, masked_update(mask, dof, self.engine.dof_pos(sim)))
        sim = self.engine.set_dof_vel(sim, masked_update(
            mask, torch.zeros_like(dof), self.engine.dof_vel(sim)))
        return sim, task

    def post_physics(self, state: EnvState, out, actions):
        root = out.root_states[:, 0]
        root_pos, root_quat = root[:, 0:3], root[:, 3:7]
        linvel, angvel = root[:, 7:10], root[:, 10:13]
        dof_pos = self.engine.dof_pos(state.sim)
        obs = torch.cat([(self.target - root_pos) / 3.0, root_quat,
                         linvel / 2.0, angvel / math.pi, dof_pos], -1)

        target_dist = torch.linalg.vector_norm(root_pos - self.target, dim=-1)
        pos_reward = 1.0 / (1.0 + target_dist * target_dist)
        ups = maths.quat_axis(root_quat, 2)
        tiltage = torch.abs(1.0 - ups[:, 2])
        up_reward = 1.0 / (1.0 + tiltage * tiltage)
        spinnage = torch.abs(angvel[:, 2])
        spin_reward = 1.0 / (1.0 + spinnage * spinnage)
        rew = pos_reward + pos_reward * (up_reward + spin_reward)

        die = (target_dist > 3.0) | (root_pos[:, 2] < 0.3)
        reset = torch.where(state.progress >= self.max_episode_length - 1, 1,
                            die.to(torch.int32)).to(torch.int32)
        return obs, None, rew, reset, self._new_task, {}
