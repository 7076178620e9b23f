"""HumanoidAMP, motion-imitation humanoid (port of
isaacgymenvs_ma_tpu/tasks/humanoid_amp.py, reference tasks/humanoid_amp.py
and tasks/amp/humanoid_amp_base.py): obs 105, act 28.

The AMP humanoid (15 bodies, 28 dofs: eight 3-hinge exp-map clusters
through dummy bodies and four 1-dof knees and elbows) with:
* task obs = AMP obs (105 = 13 + 52 + 28 + 12: root height, the root
  rotation as 6d tan-norm, heading-local root velocities, exp-map dof obs,
  dof velocities, heading-local key-body positions;
  ``build_amp_observations``);
* Reference State Init: a reset draws (root, dof) states from the motion
  library (motion ids, then uniform times; ``reset_draws=(ids, times)``
  injects them);
* the 2-step AMP observation history in ``extras["amp_obs"]`` (N, 210) for
  the discriminator, and the demo pairs of ``fetch_amp_obs_demo``;
* PD drives on every dof, stiffness the actuator gear and damping gear /
  10, targets offset and scaled from the dof limits; early termination on
  a non-foot body in contact below 0.5 m; the reward is 1 (the learner's
  discriminator gives the style reward).

The clips ship with the port (``data/motions``); a missing one raises.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..learning.motion_lib import (DOF_OFFSETS, KEY_BODY_NAMES, MotionLib,
                                   NUM_DOF)
from ..models.model import DRIVE_POS, model_from_spec
from ..ops import maths
from ..physics.engine import Control, SimState
from .base import EnvState, VecTaskBase, masked_update

NUM_AMP_OBS_PER_STEP = 13 + 52 + 28 + 12  # humanoid_amp.py:46

TASK_CFG = {
    "name": "HumanoidAMP",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 4096,
        "envSpacing": 5,
        "episodeLength": 300,
        "cameraFollow": True,
        "enableDebugVis": False,
        "pdControl": True,
        "powerScale": 1.0,
        "controlFrequencyInv": 2,  # 30 Hz control (cfg/task/HumanoidAMP.yaml)
        "stateInit": "Random",
        "hybridInitProb": 0.5,
        "numAMPObsSteps": 2,
        "localRootObs": False,
        "contactBodies": ["right_foot", "left_foot"],
        "terminationHeight": 0.5,
        "enableEarlyTermination": True,
        "motion_file": "amp_humanoid_walk.npy",
        "asset": {},
        "clipObservations": 5.0,
        "clipActions": 1.0,
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
            "contact_capacity": 16,  # 42 candidate rows
            "contact_offset": 0.02, "rest_offset": 0.0,
            "bounce_threshold_velocity": 0.2, "max_depenetration_velocity": 10.0,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 8388608, "contact_collection": 2,
        },
    },
    "task": {"randomize": False},
}

# the clips, package data of the port
MOTIONS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "motions")


def dof_to_obs(pose: torch.Tensor) -> torch.Tensor:
    """28 dof -> 52-dim obs: exp-map triplets as tan-norm 6d, hinges raw
    (humanoid_amp_base.py:463-492)."""
    pieces = []
    for j in range(len(DOF_OFFSETS) - 1):
        off = DOF_OFFSETS[j]
        size = DOF_OFFSETS[j + 1] - off
        jp = pose[:, off: off + size]
        if size == 3:
            pieces.append(maths.quat_to_tan_norm(maths.exp_map_to_quat(jp)))
        else:
            pieces.append(jp)
    return torch.cat(pieces, dim=-1)


def build_amp_observations(root_states, dof_pos, dof_vel, key_body_pos,
                           local_root_obs: bool) -> torch.Tensor:
    """(humanoid_amp.py:300-334)."""
    root_pos = root_states[:, 0:3]
    root_rot = root_states[:, 3:7]
    root_vel = root_states[:, 7:10]
    root_ang_vel = root_states[:, 10:13]
    root_h = root_pos[:, 2:3]
    heading_rot = maths.calc_heading_quat_inv(root_rot)
    root_rot_obs = (maths.quat_mul(heading_rot, root_rot) if local_root_obs
                    else root_rot)
    root_rot_obs = maths.quat_to_tan_norm(root_rot_obs)
    local_root_vel = maths.quat_apply(heading_rot, root_vel)
    local_root_ang_vel = maths.quat_apply(heading_rot, root_ang_vel)
    local_key = key_body_pos - root_pos[:, None, :]
    local_key = maths.quat_apply(heading_rot[:, None, :].expand(
        local_key.shape[:-1] + (4,)), local_key)
    flat_key = local_key.reshape(local_key.shape[0], -1)
    return torch.cat([root_h, root_rot_obs, local_root_vel,
                      local_root_ang_vel, dof_to_obs(dof_pos), dof_vel,
                      flat_key], dim=-1)


class AMPTaskState(NamedTuple):
    amp_obs_hist: torch.Tensor  # (N, num_steps, 105)


class HumanoidAMP(VecTaskBase):
    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        e = cfg["env"]
        e["numObservations"] = NUM_AMP_OBS_PER_STEP
        e["numActions"] = NUM_DOF
        self.pd_control = bool(e.get("pdControl", True))
        self.num_amp_obs_steps = int(e.get("numAMPObsSteps", 2))
        self.local_root_obs = bool(e.get("localRootObs", False))
        self.termination_height = float(e.get("terminationHeight", 0.5))
        self.enable_early_termination = bool(
            e.get("enableEarlyTermination", True))
        super().__init__(cfg, device=device, seed=seed,
                         sim_params=sim_params)
        self.num_amp_obs = self.num_amp_obs_steps * NUM_AMP_OBS_PER_STEP

        m, dev = self.model, self.device
        names = m.body_names
        # real (non-dummy) bodies carry the key and contact names
        self.key_body_ids = torch.as_tensor(
            [names.index(n) for n in KEY_BODY_NAMES], device=dev)
        contact_names = e.get("contactBodies", ["right_foot", "left_foot"])
        contact_ids = [names.index(n) for n in contact_names]
        self.contact_body_ids = torch.as_tensor(contact_ids, device=dev)
        self.nonfoot_bodies = torch.as_tensor(
            [i for i in range(m.nb) if i not in contact_ids], device=dev)

        # PD action offset/scale from dof limits (humanoid_amp_base:260-290)
        sd = np.asarray(self.engine.scalar_dofs)
        lo = np.asarray(m.dof_lower)[sd]
        hi = np.asarray(m.dof_upper)[sd]
        lo = np.where(lo < -np.pi, -np.pi, lo)
        hi = np.where(hi > np.pi, np.pi, hi)
        self.pd_offset = torch.as_tensor(
            np.asarray(0.5 * (hi + lo), np.float32), device=dev)
        self.pd_scale = torch.as_tensor(
            np.asarray(0.5 * (hi - lo) * 0.7, np.float32), device=dev)

        motion_file = e.get("motion_file", "amp_humanoid_walk.npy")
        if not os.path.isabs(motion_file):
            motion_file = os.path.join(MOTIONS_DIR, motion_file)
        self.policy_dt = self.dt * self.control_freq_inv
        self.motion_lib = MotionLib(motion_file, dt=self.policy_dt,
                                    device=dev)

    def create_model(self):
        from ..models.specs.amp_humanoid import SPEC
        model = model_from_spec(SPEC)
        # PD drives on all 28 dofs; gains from actuator gears
        gear_by_dof = {}
        for dof, gear in zip(np.asarray(model.actuator_dof),
                             np.asarray(model.actuator_gear)):
            gear_by_dof[int(dof)] = float(gear)
        for d in range(6, model.nv):
            model.dof_drive_mode[d] = DRIVE_POS
            g = gear_by_dof.get(d, 100.0)
            model.dof_stiffness[d] = g
            model.dof_drive_damping[d] = g / 10.0
        return model, True

    def initial_task_state(self):
        return AMPTaskState(amp_obs_hist=torch.zeros(
            (self.num_envs, self.num_amp_obs_steps, NUM_AMP_OBS_PER_STEP),
            dtype=DTYPE, device=self.device))

    # ------------------------------------------------------------------
    def pre_physics(self, state: EnvState, actions) -> Control:
        n, nv = self.num_envs, self.engine.nv
        zeros = torch.zeros((n, nv), dtype=DTYPE, device=self.device)
        if self.pd_control:
            pos_target = zeros.clone()
            pos_target[:, self.engine.scalar_dofs_t] = (
                self.pd_offset + self.pd_scale * actions)
            return Control(tau=zeros, pos_target=pos_target,
                           vel_target=zeros.clone())
        tau = zeros
        tau[:, 6:] = actions * 100.0
        return Control(tau=tau)

    def draw_reset(self):
        """Reference State Init draws from the task generator: motion ids
        (N,), then uniform times (N,) within them."""
        ml = self.motion_lib
        ids = ml.sample_motions(self.num_envs, self.generator)
        return ids, ml.sample_time(ids, self.generator)

    def reset_idx(self, sim: SimState, task: AMPTaskState, mask, draws=None):
        """Reference State Init from the motion library (:182-224)."""
        ids, times = self.draw_reset() if draws is None else draws
        s = self.motion_lib.get_motion_state(ids, times)
        root = torch.cat([s["root_pos"], s["root_rot"]], -1)
        root_vel = torch.cat([s["root_vel"], s["root_ang_vel"]], -1)
        sim = self.engine.set_dof_pos(
            sim, masked_update(mask, s["dof_pos"], self.engine.dof_pos(sim)))
        sim = self.engine.set_dof_vel(
            sim, masked_update(mask, s["dof_vel"], self.engine.dof_vel(sim)))
        q, qd = sim.q.clone(), sim.qd.clone()
        q[:, 0:7] = masked_update(mask, root, q[:, 0:7])
        qd[:, 0:6] = masked_update(mask, root_vel, qd[:, 0:6])
        task = AMPTaskState(amp_obs_hist=masked_update(
            mask, torch.zeros_like(task.amp_obs_hist), task.amp_obs_hist))
        return SimState(q, qd), task

    def post_physics(self, state: EnvState, out, actions):
        task: AMPTaskState = state.task
        root = out.root_states[:, 0]
        dof_pos = self.engine.dof_pos(state.sim)
        dof_vel = self.engine.dof_vel(state.sim)
        key_pos = out.body_pos[:, self.key_body_ids]
        obs = build_amp_observations(root, dof_pos, dof_vel, key_pos,
                                     self.local_root_obs)
        # amp history: shift in the current frame (humanoid_amp.py:271-297)
        hist = torch.cat([obs[:, None], task.amp_obs_hist[:, :-1]], 1)

        rew = torch.ones(self.num_envs, dtype=DTYPE, device=self.device)
        fallen = torch.zeros(self.num_envs, dtype=torch.bool,
                             device=self.device)
        if self.enable_early_termination:
            nf = self.nonfoot_bodies
            contact = torch.linalg.vector_norm(out.contact_force[:, nf],
                                               dim=-1) > 1.0
            low = out.body_pos[:, nf, 2] < self.termination_height
            fallen = torch.any(contact & low, dim=-1)
        reset = (fallen | (state.progress >= self.max_episode_length - 1)
                 ).to(torch.int32)
        extras = {"amp_obs": hist.reshape(self.num_envs, -1)}
        return obs, None, rew, reset, AMPTaskState(amp_obs_hist=hist), extras

    # -- demo fetch (humanoid_amp.py:105-134) ---------------------------
    def demo_draws(self, num_samples: int, generator: torch.Generator):
        """(motion ids, times) of ``num_samples`` demo pairs from
        ``generator``, as ``fetch_amp_obs_demo(..., draws=)`` takes
        them."""
        ml = self.motion_lib
        ids = ml.sample_motions(num_samples, generator)
        return ids, ml.sample_time(ids, generator, truncate_t=self.policy_dt)

    def fetch_amp_obs_demo(self, num_samples: int, draws=None):
        """(num_samples, 210) demo observations, (s1, s0) concatenated;
        ``draws`` (ids, times) as ``MotionLib.sample_state_pairs`` takes
        them, else drawn from the task generator."""
        s0, s1 = self.motion_lib.sample_state_pairs(
            num_samples, self.policy_dt, self.generator, draws)
        obs = []
        for s in (s1, s0):
            root = torch.cat([s["root_pos"], s["root_rot"], s["root_vel"],
                              s["root_ang_vel"]], -1)
            obs.append(build_amp_observations(
                root, s["dof_pos"], s["dof_vel"], s["key_pos"],
                self.local_root_obs))
        return torch.cat(obs, dim=-1)
