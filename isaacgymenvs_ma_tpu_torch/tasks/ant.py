"""Ant locomotion (port of isaacgymenvs_ma_tpu/tasks/ant.py).

obs 60 / act 8; potential-based progress reward toward (1000, 0, 0) plus
alive/up/heading bonuses and action/electricity/limit costs; 4 foot force
sensors (obs[28:52]); direct effort actuation ``force = action * gear *
power``.  The model is the port's copy of the JAX package's ``build_ant``.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..models.mjcf import load_mjcf
from ..models.robots import build_ant

from ..device import DTYPE
from ..ops import maths
from ..ops.rng import rand_float
from ..physics.engine import Control, SimState
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "Ant",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 4096,
        "envSpacing": 5,
        "episodeLength": 1000,
        "enableDebugVis": False,
        "clipActions": 1.0,
        "powerScale": 1.0,
        "controlFrequencyInv": 1,
        "headingWeight": 0.5,
        "upWeight": 0.1,
        "actionsCost": 0.005,
        "energyCost": 0.05,
        "jointsAtLimitCost": 0.1,
        "deathCost": -2.0,
        "terminationHeight": 0.31,
        "plane": {"staticFriction": 1.0, "dynamicFriction": 1.0,
                  "restitution": 0.0},
        "asset": {},
        "enableCameraSensors": False,
        "dofVelocityScale": 0.2,
        "contactForceScale": 0.1,
        "clipObservations": 5.0,
    },
    "sim": {
        "dt": 0.0166,
        "substeps": 2,
        "up_axis": "z",
        "use_gpu_pipeline": True,
        "gravity": [0.0, 0.0, -9.81],
        "physx": {
            "num_threads": 4,
            "solver_type": 1,
            "use_gpu": True,
            "num_position_iterations": 4,
            "num_velocity_iterations": 0,
            "contact_offset": 0.02,
            "rest_offset": 0.0,
            "bounce_threshold_velocity": 0.2,
            "max_depenetration_velocity": 10.0,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 8388608,
            "contact_collection": 0,
        },
    },
    "task": {"randomize": False, "randomization_params": {}},
}


class AntTaskState(NamedTuple):
    potentials: torch.Tensor        # (N,)
    prev_potentials: torch.Tensor   # (N,)
    actions: torch.Tensor           # (N, 8) previous actions (obs [52:60])


class Ant(VecTaskBase):
    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        cfg["env"]["numObservations"] = 60
        cfg["env"]["numActions"] = 8
        e = cfg["env"]
        self.power_scale = float(e["powerScale"])
        self.heading_weight = float(e["headingWeight"])
        self.up_weight = float(e["upWeight"])
        self.actions_cost_scale = float(e["actionsCost"])
        self.energy_cost_scale = float(e["energyCost"])
        self.joints_at_limit_cost_scale = float(e["jointsAtLimitCost"])
        self.death_cost = float(e["deathCost"])
        self.termination_height = float(e["terminationHeight"])
        self.dof_vel_scale = float(e["dofVelocityScale"])
        self.contact_force_scale = float(e["contactForceScale"])
        super().__init__(cfg, device=device, seed=seed,
                         sim_params=sim_params)

        m = self.model
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=self.device)
        self.joint_gears = f32(m.actuator_gear)
        # actuators are registered in dof order for the procedural ant
        self.dof_lower = f32(m.dof_lower[6:])
        self.dof_upper = f32(m.dof_upper[6:])
        # initial dof pos: clamp 0 into limits (ref :96-99)
        lo, hi = np.asarray(m.dof_lower[6:]), np.asarray(m.dof_upper[6:])
        init = np.where(lo > 0, lo, np.where(hi < 0, hi, np.zeros(8)))
        self.initial_dof_pos = f32(init)
        self.start_z = 0.44
        self.targets = f32([1000.0, 0.0, 0.0])
        self.basis_vec0 = f32([1.0, 0.0, 0.0])
        self.basis_vec1 = f32([0.0, 0.0, 1.0])
        self.inv_start_rot = f32([0.0, 0.0, 0.0, 1.0])  # conj of identity
        self.root0 = f32([0.0, 0.0, self.start_z, 0.0, 0.0, 0.0, 1.0])

    def create_model(self):
        asset = self.cfg["env"].get("asset", {})
        if asset.get("assetFileName"):
            root = asset.get("assetRoot", ".")
            return load_mjcf(os.path.join(root, asset["assetFileName"])), True
        return build_ant(), True

    def initial_task_state(self):
        n = self.num_envs
        pot = torch.full((n,), -1000.0 / self.dt, dtype=DTYPE,
                         device=self.device)
        return AntTaskState(potentials=pot, prev_potentials=pot.clone(),
                            actions=torch.zeros((n, 8), dtype=DTYPE,
                                                device=self.device))

    # ------------------------------------------------------------------
    def pre_physics(self, state: EnvState, actions) -> Control:
        tau = torch.zeros((self.num_envs, self.engine.nv), dtype=DTYPE,
                          device=self.device)
        tau[:, 6:] = actions * self.joint_gears * self.power_scale
        return Control(tau=tau)

    def draw_reset(self):
        """Reset draws from the task generator: dof position offsets and
        dof velocities, each (N, 8) (ref ant.py:138-141)."""
        n = self.num_envs
        return (rand_float(self.generator, -0.2, 0.2, (n, 8)),
                rand_float(self.generator, -0.1, 0.1, (n, 8)))

    def reset_idx(self, sim: SimState, task: AntTaskState, mask, draws=None):
        positions, velocities = self.draw_reset() if draws is None else draws
        n = self.num_envs
        new_pos = torch.clamp(self.initial_dof_pos + positions,
                              self.dof_lower, self.dof_upper)
        dof_pos = masked_update(mask, new_pos, self.engine.dof_pos(sim))
        dof_vel = masked_update(mask, velocities, self.engine.dof_vel(sim))
        sim = self.engine.set_dof_pos(sim, dof_pos)
        sim = self.engine.set_dof_vel(sim, dof_vel)
        # root -> (0, 0, 0.44), identity quat, zero velocity
        q = sim.q.clone()
        qd = sim.qd.clone()
        q[:, 0:7] = masked_update(mask, self.root0.expand(n, 7), q[:, 0:7])
        qd[:, 0:6] = masked_update(mask, torch.zeros_like(qd[:, 0:6]),
                                   qd[:, 0:6])
        sim = SimState(q, qd)

        to_target = self.targets - torch.tensor(
            [0.0, 0.0, self.start_z], dtype=DTYPE, device=self.device)
        to_target = torch.cat([to_target[:2], to_target.new_zeros(1)])
        pot0 = -torch.linalg.vector_norm(to_target) / self.dt
        task = AntTaskState(
            potentials=torch.where(mask, pot0, task.potentials),
            prev_potentials=torch.where(mask, pot0, task.prev_potentials),
            actions=masked_update(mask, torch.zeros_like(task.actions),
                                  task.actions))
        return sim, task

    def post_physics(self, state: EnvState, out, actions):
        task: AntTaskState = state.task
        root = out.root_states[:, 0]
        torso_position = root[:, 0:3]
        torso_rotation = root[:, 3:7]
        velocity = root[:, 7:10]
        ang_velocity = root[:, 10:13]

        to_target = self.targets - torso_position
        to_target = torch.cat([to_target[:, :2],
                               torch.zeros_like(to_target[:, 2:])], dim=-1)
        prev_potentials = task.potentials
        potentials = -torch.linalg.vector_norm(to_target, dim=-1) / self.dt

        torso_quat, up_proj, heading_proj, _, _ = maths.compute_heading_and_up(
            torso_rotation, self.inv_start_rot.expand(torso_rotation.shape),
            to_target, self.basis_vec0, self.basis_vec1, 2)
        vel_loc, angvel_loc, roll, pitch, yaw, angle_to_target = \
            maths.compute_rot(torso_quat, velocity, ang_velocity,
                              self.targets.expand(torso_position.shape),
                              torso_position)

        dof_pos = self.engine.dof_pos(state.sim)
        dof_vel = self.engine.dof_vel(state.sim)
        dof_pos_scaled = maths.unscale(dof_pos, self.dof_lower, self.dof_upper)
        sensors = out.sensor_forces.reshape(self.num_envs, -1)  # (N, 24)

        obs = torch.cat([
            torso_position[:, 2:3], vel_loc, angvel_loc,
            yaw[:, None], roll[:, None], angle_to_target[:, None],
            up_proj[:, None], heading_proj[:, None],
            dof_pos_scaled, dof_vel * self.dof_vel_scale,
            sensors * self.contact_force_scale, actions,
        ], dim=-1)

        rew, reset = self._compute_reward(obs, actions, state.progress,
                                          potentials, prev_potentials)
        task = AntTaskState(potentials=potentials,
                            prev_potentials=prev_potentials, actions=actions)
        extras = {"true_objective": velocity[:, 0]}
        return obs, None, rew, reset, task, extras

    def _compute_reward(self, obs, actions, progress, potentials,
                        prev_potentials):
        """compute_ant_reward (ref ant.py:326-373)."""
        heading_reward = torch.where(
            obs[:, 11] > 0.8, self.heading_weight,
            self.heading_weight * obs[:, 11] / 0.8)
        up_reward = torch.where(obs[:, 10] > 0.93, self.up_weight, 0.0)
        actions_cost = torch.sum(actions * actions, dim=-1)
        electricity_cost = torch.sum(torch.abs(actions * obs[:, 20:28]), dim=-1)
        dof_at_limit_cost = torch.sum((obs[:, 12:20] > 0.99).to(DTYPE), dim=-1)
        alive_reward = 0.5
        progress_reward = potentials - prev_potentials

        total = (progress_reward + alive_reward + up_reward + heading_reward
                 - self.actions_cost_scale * actions_cost
                 - self.energy_cost_scale * electricity_cost
                 - dof_at_limit_cost * self.joints_at_limit_cost_scale)
        fallen = obs[:, 0] < self.termination_height
        total = torch.where(fallen, self.death_cost, total)
        reset = fallen | (progress >= self.max_episode_length - 1)
        return total, reset.to(torch.int32)
