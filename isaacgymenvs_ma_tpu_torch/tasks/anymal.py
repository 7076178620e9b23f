"""Anymal flat-ground velocity tracking (port of
isaacgymenvs_ma_tpu/tasks/anymal.py): obs 48 / act 12.

The quadruped tracks random (vx, vy, yaw-rate) commands with PD position
drives (kp 85 / kd 2) on its 12 joints, targets = actionScale * a + the
default joint angles; exp-tracking reward and a torque penalty; reset on
base or knee contact.  The model is the port's copy of the JAX package's
anymal spec; 68 ground candidate rows compacted to 16 per env
(``contact_capacity``).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..models.model import DRIVE_POS, model_from_spec
from ..models.urdf import load_urdf
from ..ops import maths
from ..ops.rng import rand_float
from ..physics.engine import Control, SimState
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "Anymal",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 4096,
        "envSpacing": 4.0,
        "clipObservations": 5.0,
        "clipActions": 1.0,
        "plane": {"staticFriction": 1.0, "dynamicFriction": 1.0,
                  "restitution": 0.0},
        "baseInitState": {
            "pos": [0.0, 0.0, 0.62],
            "rot": [0.0, 0.0, 0.0, 1.0],
            "vLinear": [0.0, 0.0, 0.0],
            "vAngular": [0.0, 0.0, 0.0],
        },
        "randomCommandVelocityRanges": {
            "linear_x": [-2.0, 2.0], "linear_y": [-1.0, 1.0],
            "yaw": [-1.0, 1.0]},
        "control": {"stiffness": 85.0, "damping": 2.0, "actionScale": 0.5,
                    "controlFrequencyInv": 1},
        "defaultJointAngles": {
            "LF_HAA": 0.03, "LH_HAA": 0.03, "RF_HAA": -0.03, "RH_HAA": -0.03,
            "LF_HFE": 0.4, "LH_HFE": -0.4, "RF_HFE": 0.4, "RH_HFE": -0.4,
            "LF_KFE": -0.8, "LH_KFE": 0.8, "RF_KFE": -0.8, "RH_KFE": 0.8,
        },
        "urdfAsset": {"collapseFixedJoints": True, "fixBaseLink": False,
                      "defaultDofDriveMode": 4},
        "learn": {
            "linearVelocityXYRewardScale": 1.0,
            "angularVelocityZRewardScale": 0.5,
            "torqueRewardScale": -0.000025,
            "linearVelocityScale": 2.0,
            "angularVelocityScale": 0.25,
            "dofPositionScale": 1.0,
            "dofVelocityScale": 0.05,
            "episodeLength_s": 50,
        },
        "enableCameraSensors": False,
    },
    "sim": {
        "dt": 0.02,
        "substeps": 2,
        "up_axis": "z",
        "use_gpu_pipeline": True,
        "gravity": [0.0, 0.0, -9.81],
        "physx": {
            "num_threads": 4, "solver_type": 1, "use_gpu": True,
            "num_position_iterations": 4, "num_velocity_iterations": 1,
            # 68 candidate rows, 4 feet active
            "contact_capacity": 16,
            "contact_offset": 0.02, "rest_offset": 0.0,
            "bounce_threshold_velocity": 0.2,
            "max_depenetration_velocity": 100.0,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 8388608, "contact_collection": 1,
        },
    },
    "task": {"randomize": False, "randomization_params": {}},
}

def set_pd_drives(model, stiffness: float, damping: float = 2.0):
    """PD position drives on every dof after the free base (anymal.py:
    148-153)."""
    for d in range(model.nv - 6):
        model.dof_drive_mode[6 + d] = DRIVE_POS
        model.dof_stiffness[6 + d] = stiffness
        model.dof_drive_damping[6 + d] = damping
    return model


def joint_order(task):
    """The joint names of the scalar dofs in tree order (anymal.py:
    123-130): the body names with HIP, THIGH, SHANK read as HAA, HFE,
    KFE."""
    m = task.model
    names = [m.body_names[int(b)] for b in
             np.asarray(m.dof_body)[task.engine.scalar_dofs]]
    return [n.replace("_HIP", "_HAA").replace("_THIGH", "_HFE")
            .replace("_SHANK", "_KFE") for n in names]


def body_indices(model, part: str) -> np.ndarray:
    """Indices of the bodies whose name holds ``part`` (the knees are the
    THIGH bodies, the feet the SHANK bodies, as in the JAX package)."""
    return np.asarray([i for i, n in enumerate(model.body_names)
                       if part in n], np.int64)


def pd_control(task, actions) -> Control:
    """PD targets actionScale * a + the default angles on the scalar dofs,
    zero target velocities (anymal.py:168-176; anymal_terrain.py:285-292)."""
    n, nv = task.num_envs, task.engine.nv
    pos_target = torch.zeros((n, nv), dtype=DTYPE, device=task.device)
    pos_target[:, task.engine.scalar_dofs_t] = (task.action_scale * actions
                                                + task.default_dof_pos)
    zeros = torch.zeros((n, nv), dtype=DTYPE, device=task.device)
    return Control(tau=zeros, pos_target=pos_target, vel_target=zeros)


class AnymalTaskState(NamedTuple):
    commands: torch.Tensor   # (N, 3) vx, vy, yaw-rate
    actions: torch.Tensor    # (N, 12)


class Anymal(VecTaskBase):
    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        cfg["env"]["numObservations"] = 48
        cfg["env"]["numActions"] = 12
        e = cfg["env"]
        learn = e["learn"]
        self.lin_vel_scale = float(learn["linearVelocityScale"])
        self.ang_vel_scale = float(learn["angularVelocityScale"])
        self.dof_pos_scale = float(learn["dofPositionScale"])
        self.dof_vel_scale = float(learn["dofVelocityScale"])
        self.action_scale = float(e["control"]["actionScale"])
        self.Kp = float(e["control"]["stiffness"])
        self.Kd = float(e["control"]["damping"])
        rew_scales = {
            "lin_vel_xy": float(learn["linearVelocityXYRewardScale"]),
            "ang_vel_z": float(learn["angularVelocityZRewardScale"]),
            "torque": float(learn["torqueRewardScale"]),
        }
        self.command_x_range = e["randomCommandVelocityRanges"]["linear_x"]
        self.command_y_range = e["randomCommandVelocityRanges"]["linear_y"]
        self.command_yaw_range = e["randomCommandVelocityRanges"]["yaw"]
        dt = cfg["sim"]["dt"]
        e["episodeLength"] = int(learn["episodeLength_s"] / dt + 0.5)
        e["controlFrequencyInv"] = int(
            e["control"].get("controlFrequencyInv", 1))
        b = e["baseInitState"]
        base_init = np.array(b["pos"] + b["rot"] + b["vLinear"]
                             + b["vAngular"])
        super().__init__(cfg, device=device, seed=seed,
                         sim_params=sim_params)
        # reward scales premultiplied by dt (reference anymal.py:76-80)
        self.rew_scales = {k: v * self.dt for k, v in rew_scales.items()}
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=self.device)
        self.default_dof_pos = f32([e["defaultJointAngles"][n]
                                    for n in joint_order(self)])
        self.base_index = 0
        self.knee_indices = torch.as_tensor(
            body_indices(self.model, "THIGH"), device=self.device)
        self.gravity_vec = f32([0.0, 0.0, -1.0])
        self.base_init = f32(base_init)
        self.cmd_scale = f32([self.lin_vel_scale, self.lin_vel_scale,
                              self.ang_vel_scale])

    def create_model(self):
        asset = self.cfg["env"].get("asset", {})
        if asset.get("assetFileName"):
            model = load_urdf(
                os.path.join(asset.get("assetRoot", "."),
                             asset["assetFileName"]),
                collapse_fixed=self.cfg["env"]["urdfAsset"][
                    "collapseFixedJoints"])
        else:
            from ..models.specs.anymal import SPEC
            model = model_from_spec(SPEC)
        return set_pd_drives(model, 85.0), True

    def initial_task_state(self):
        n = self.num_envs
        z = lambda k: torch.zeros((n, k), dtype=DTYPE,  # noqa: E731
                                  device=self.device)
        return AnymalTaskState(commands=z(3), actions=z(12))

    # ------------------------------------------------------------------
    def pre_physics(self, state: EnvState, actions) -> Control:
        return pd_control(self, actions)

    def draw_reset(self):
        """Reset draws from the task generator (anymal.py:178-205): the
        dof position factors U(0.5, 1.5) and velocities U(-0.1, 0.1), each
        (N, 12), and the commands vx, vy, yaw-rate, each (N,)."""
        g, n = self.generator, self.num_envs
        return (rand_float(g, 0.5, 1.5, (n, 12)),
                rand_float(g, -0.1, 0.1, (n, 12)),
                rand_float(g, *self.command_x_range, (n,)),
                rand_float(g, *self.command_y_range, (n,)),
                rand_float(g, *self.command_yaw_range, (n,)))

    def reset_idx(self, sim: SimState, task: AnymalTaskState, mask,
                  draws=None):
        pos_u, vel, cx, cy, cyaw = self.draw_reset() if draws is None \
            else draws
        n = self.num_envs
        sim = self.engine.set_dof_pos(sim, masked_update(
            mask, self.default_dof_pos * pos_u, self.engine.dof_pos(sim)))
        sim = self.engine.set_dof_vel(
            sim, masked_update(mask, vel, self.engine.dof_vel(sim)))
        q, qd = sim.q.clone(), sim.qd.clone()
        q[:, 0:7] = masked_update(mask, self.base_init[:7].expand(n, 7),
                                  q[:, 0:7])
        qd[:, 0:6] = masked_update(mask, self.base_init[7:13].expand(n, 6),
                                   qd[:, 0:6])
        cmd = torch.stack([cx, cy, cyaw], dim=-1)
        task = AnymalTaskState(
            commands=masked_update(mask, cmd, task.commands),
            actions=masked_update(mask, torch.zeros_like(task.actions),
                                  task.actions))
        return SimState(q, qd), task

    def post_physics(self, state: EnvState, out, actions):
        task: AnymalTaskState = state.task
        root = out.root_states[:, 0]
        base_quat = root[:, 3:7]
        base_lin_vel = maths.quat_rotate_inverse(base_quat, root[:, 7:10])
        base_ang_vel = maths.quat_rotate_inverse(base_quat, root[:, 10:13])
        projected_gravity = maths.quat_apply(base_quat, self.gravity_vec)
        dof_pos = self.engine.dof_pos(state.sim)
        dof_vel = self.engine.dof_vel(state.sim)

        # applied PD torques for the penalty (dof_force readout equivalent)
        targets = self.action_scale * actions + self.default_dof_pos
        torques = self.Kp * (targets - dof_pos) - self.Kd * dof_vel

        obs = torch.cat([
            base_lin_vel * self.lin_vel_scale,
            base_ang_vel * self.ang_vel_scale,
            projected_gravity,
            task.commands * self.cmd_scale,
            (dof_pos - self.default_dof_pos) * self.dof_pos_scale,
            dof_vel * self.dof_vel_scale,
            actions,
        ], dim=-1)

        # reward kernel (ref anymal.py:313-356)
        lin_vel_error = torch.sum(
            torch.square(task.commands[:, :2] - base_lin_vel[:, :2]), dim=1)
        ang_vel_error = torch.square(task.commands[:, 2] - base_ang_vel[:, 2])
        rs = self.rew_scales
        rew = (torch.exp(-lin_vel_error / 0.25) * rs["lin_vel_xy"]
               + torch.exp(-ang_vel_error / 0.25) * rs["ang_vel_z"]
               + torch.sum(torch.square(torques), dim=1) * rs["torque"])
        rew = torch.clamp(rew, min=0.0)

        cf = out.contact_force
        base_contact = torch.linalg.vector_norm(cf[:, self.base_index],
                                                dim=-1) > 1.0
        knee_contact = torch.any(torch.linalg.vector_norm(
            cf[:, self.knee_indices], dim=-1) > 1.0, dim=1)
        reset = (base_contact | knee_contact
                 | (state.progress >= self.max_episode_length - 1))
        task = AnymalTaskState(commands=task.commands, actions=actions)
        return obs, None, rew, reset.to(torch.int32), task, {}
