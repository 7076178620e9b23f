"""Humanoid locomotion (port of isaacgymenvs_ma_tpu/tasks/humanoid.py).

obs 108 / act 21.  Ant's potential-based locomotion family with the
humanoid's terms: normalized euler-angle obs, angular-velocity scaling,
dof-force obs, motor-effort-weighted electricity and joints-at-limit
costs, alive bonus 2.0, start pose z = 1.34, two foot force sensors.  The
model is the port's copy of the JAX package's humanoid spec; 35 ground
candidate rows compacted to 16 per env (``contact_capacity``).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..models.mjcf import load_mjcf
from ..models.model import model_from_spec
from ..ops import maths
from ..ops.rng import rand_float
from ..physics.engine import Control, SimState
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "Humanoid",
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
        "actionsCost": 0.01,
        "energyCost": 0.05,
        "dofVelocityScale": 0.1,
        "angularVelocityScale": 0.25,
        "contactForceScale": 0.01,
        "jointsAtLimitCost": 0.25,
        "deathCost": -1.0,
        "terminationHeight": 0.8,
        "plane": {"staticFriction": 1.0, "dynamicFriction": 1.0,
                  "restitution": 0.0},
        "asset": {},
        "enableCameraSensors": False,
        "clipObservations": 5.0,
    },
    "sim": {
        "dt": 0.0166,
        "substeps": 2,
        "up_axis": "z",
        "use_gpu_pipeline": True,
        "gravity": [0.0, 0.0, -9.81],
        "physx": {
            "num_threads": 4, "solver_type": 1, "use_gpu": True,
            "num_position_iterations": 4, "num_velocity_iterations": 0,
            # active-set compaction: 35 candidate rows, ~8 active walking
            "contact_capacity": 16,
            "contact_offset": 0.02, "rest_offset": 0.0,
            "bounce_threshold_velocity": 0.2,
            "max_depenetration_velocity": 10.0,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 8388608, "contact_collection": 0,
        },
    },
    "task": {"randomize": False, "randomization_params": {}},
}


class HumanoidTaskState(NamedTuple):
    potentials: torch.Tensor        # (N,)
    prev_potentials: torch.Tensor   # (N,)
    actions: torch.Tensor           # (N, 21)


class Humanoid(VecTaskBase):
    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        cfg["env"]["numObservations"] = 108
        cfg["env"]["numActions"] = 21
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
        self.angular_velocity_scale = float(e.get("angularVelocityScale",
                                                  0.25))
        self.contact_force_scale = float(e["contactForceScale"])
        super().__init__(cfg, device=device, seed=seed,
                         sim_params=sim_params)

        m = self.model
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=self.device)
        sd = np.asarray(self.engine.scalar_dofs)
        self.num_dof = len(sd)
        assert self.num_dof == 21, self.num_dof
        # per-dof motor efforts: the reference applies action k to dof k
        # (humanoid.py:96-104); actuator gears mapped onto dof order
        gear_by_dof = np.zeros(self.num_dof)
        sd_index = {int(v): i for i, v in enumerate(sd)}
        for dof, gear in zip(np.asarray(m.actuator_dof),
                             np.asarray(m.actuator_gear)):
            gear_by_dof[sd_index[int(dof)]] = gear
        self.motor_efforts = f32(gear_by_dof)
        self.motor_effort_ratio = f32(gear_by_dof / np.max(gear_by_dof))
        lo, hi = np.asarray(m.dof_lower)[sd], np.asarray(m.dof_upper)[sd]
        self.dof_lower = f32(lo)
        self.dof_upper = f32(hi)
        self.initial_dof_pos = f32(np.where(lo > 0, lo, np.where(
            hi < 0, hi, np.zeros(self.num_dof))))
        self.start_z = 1.34
        self.targets = f32([1000.0, 0.0, 0.0])
        self.basis_vec0 = f32([1.0, 0.0, 0.0])
        self.basis_vec1 = f32([0.0, 0.0, 1.0])
        self.inv_start_rot = f32([0.0, 0.0, 0.0, 1.0])
        self.root0 = f32([0.0, 0.0, self.start_z, 0.0, 0.0, 0.0, 1.0])
        # the potential at the start pose: the target's planar distance
        self.pot0 = -torch.linalg.vector_norm(self.targets) / self.dt

    def create_model(self):
        asset = self.cfg["env"].get("asset", {})
        if asset.get("assetFileName"):
            root = asset.get("assetRoot", ".")
            model = load_mjcf(os.path.join(root, asset["assetFileName"]))
        else:
            from ..models.specs.humanoid import SPEC
            model = model_from_spec(SPEC)
        # force sensors on the feet (humanoid.py:129-133)
        if len(model.sensor_body) == 0:
            feet = [i for i, n in enumerate(model.body_names)
                    if n.endswith("foot")]
            model.sensor_body = np.asarray(feet[:2], np.int32)
        return model, True

    def initial_task_state(self):
        n = self.num_envs
        pot = torch.full((n,), -1000.0 / self.dt, dtype=DTYPE,
                         device=self.device)
        return HumanoidTaskState(potentials=pot, prev_potentials=pot.clone(),
                                 actions=torch.zeros((n, 21), dtype=DTYPE,
                                                     device=self.device))

    # ------------------------------------------------------------------
    def pre_physics(self, state: EnvState, actions) -> Control:
        tau = torch.zeros((self.num_envs, self.engine.nv), dtype=DTYPE,
                          device=self.device)
        tau[:, self.engine.scalar_dofs_t] = (actions * self.motor_efforts
                                             * self.power_scale)
        return Control(tau=tau)

    def draw_reset(self):
        """Reset draws from the task generator: dof position offsets and
        dof velocities, each (N, 21) (humanoid.py:144-146)."""
        n, nd = self.num_envs, self.num_dof
        return (rand_float(self.generator, -0.2, 0.2, (n, nd)),
                rand_float(self.generator, -0.1, 0.1, (n, nd)))

    def reset_idx(self, sim: SimState, task: HumanoidTaskState, mask,
                  draws=None):
        positions, velocities = self.draw_reset() if draws is None else draws
        n = self.num_envs
        new_pos = torch.clamp(self.initial_dof_pos + positions,
                              self.dof_lower, self.dof_upper)
        sim = self.engine.set_dof_pos(
            sim, masked_update(mask, new_pos, self.engine.dof_pos(sim)))
        sim = self.engine.set_dof_vel(
            sim, masked_update(mask, velocities, self.engine.dof_vel(sim)))
        q, qd = sim.q.clone(), sim.qd.clone()
        q[:, 0:7] = masked_update(mask, self.root0.expand(n, 7), q[:, 0:7])
        qd[:, 0:6] = masked_update(mask, torch.zeros_like(qd[:, 0:6]),
                                   qd[:, 0:6])
        task = HumanoidTaskState(
            potentials=torch.where(mask, self.pot0, task.potentials),
            prev_potentials=torch.where(mask, self.pot0,
                                        task.prev_potentials),
            actions=masked_update(mask, torch.zeros_like(task.actions),
                                  task.actions))
        return SimState(q, qd), task

    def post_physics(self, state: EnvState, out, actions):
        task: HumanoidTaskState = state.task
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
        roll = maths.normalize_angle(roll)[:, None]
        yaw = maths.normalize_angle(yaw)[:, None]
        angle_to_target = maths.normalize_angle(angle_to_target)[:, None]

        dof_pos = self.engine.dof_pos(state.sim)
        dof_vel = self.engine.dof_vel(state.sim)
        dof_pos_scaled = maths.unscale(dof_pos, self.dof_lower, self.dof_upper)
        dof_force = out.dof_force[:, self.engine.scalar_dofs_t]
        sensors = out.sensor_forces.reshape(self.num_envs, -1)  # (N, 12)

        obs = torch.cat([
            torso_position[:, 2:3], vel_loc,
            angvel_loc * self.angular_velocity_scale,
            yaw, roll, angle_to_target, up_proj[:, None],
            heading_proj[:, None],
            dof_pos_scaled, dof_vel * self.dof_vel_scale,
            dof_force * self.contact_force_scale,
            sensors * self.contact_force_scale, actions,
        ], dim=-1)

        rew, reset = self._compute_reward(obs, actions, state.progress,
                                          potentials, prev_potentials)
        task = HumanoidTaskState(potentials=potentials,
                                 prev_potentials=prev_potentials,
                                 actions=actions)
        extras = {"true_objective": velocity[:, 0]}
        return obs, None, rew, reset, task, extras

    def _compute_reward(self, obs, actions, progress, potentials,
                        prev_potentials):
        """compute_humanoid_reward (ref humanoid.py:330-373)."""
        heading_reward = torch.where(
            obs[:, 11] > 0.8, self.heading_weight,
            self.heading_weight * obs[:, 11] / 0.8)
        up_reward = torch.where(obs[:, 10] > 0.93, self.up_weight, 0.0)
        actions_cost = torch.sum(actions * actions, dim=-1)
        mer = self.motor_effort_ratio[None, :]
        scaled_cost = self.joints_at_limit_cost_scale * (
            torch.abs(obs[:, 12:33]) - 0.98) / 0.02
        dof_at_limit_cost = torch.sum(
            (torch.abs(obs[:, 12:33]) > 0.98).to(DTYPE) * scaled_cost * mer,
            dim=-1)
        electricity_cost = torch.sum(
            torch.abs(actions * obs[:, 33:54]) * mer, dim=-1)
        alive_reward = 2.0
        progress_reward = potentials - prev_potentials
        total = (progress_reward + alive_reward + up_reward + heading_reward
                 - self.actions_cost_scale * actions_cost
                 - self.energy_cost_scale * electricity_cost
                 - dof_at_limit_cost)
        fallen = obs[:, 0] < self.termination_height
        total = torch.where(fallen, self.death_cost, total)
        reset = fallen | (progress >= self.max_episode_length - 1)
        return total, reset.to(torch.int32)
