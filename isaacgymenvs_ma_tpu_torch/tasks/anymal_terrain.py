"""AnymalTerrain: heightfield-terrain locomotion with a curriculum (port of
isaacgymenvs_ma_tpu/tasks/anymal_terrain.py): obs 188 / act 12.

* the curriculum terrain of 10 levels x 20 types (:mod:`..physics.terrain`),
  promotion and demotion on reset, per-env origins;
* the reference's decimation-4 control loop folded into 4 engine substeps
  of 5 ms with the implicit PD drive (``reuse_mass_matrix`` off, so kernel
  B2 runs on every substep and B3 never); the clipped explicit torque
  feeds the torque reward;
* 140 height samples in the yaw frame by the min-of-two lookup;
* a 13-term reward with per-term episode sums (``extras['episode']``),
  termination on base contact;
* random pushes every ``pushInterval_s`` and additive uniform observation
  noise, drawn in ``post_physics``.

The JAX package draws the pushes and the noise from ``fold_in(rng, 17)``
and ``fold_in(rng, 23)``; here they come from the task's generator, or
from ``step(..., step_draws=(push_vel, noise_u))``.  The pushed velocity
is what the next step starts from: ``post_physics`` returns the pushed
``SimState`` (the JAX task passes it through a ``_pushed_sim`` attribute).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..models.model import model_from_spec
from ..ops import maths
from ..ops.rng import rand_float
from ..physics.engine import SimState
from ..physics.terrain import CurriculumTerrain
from .anymal import body_indices, joint_order, pd_control, set_pd_drives
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "AnymalTerrain",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 4096,
        "numObservations": 188,
        "numActions": 12,
        "envSpacing": 3.0,
        "enableDebugVis": False,
        "clipObservations": 100.0,
        "clipActions": 100.0,
        "terrain": {
            "terrainType": "trimesh",
            "staticFriction": 1.0,
            "dynamicFriction": 1.0,
            "restitution": 0.0,
            "curriculum": True,
            "maxInitMapLevel": 0,
            "mapLength": 8.0,
            "mapWidth": 8.0,
            "numLevels": 10,
            "numTerrains": 20,
            "terrainProportions": [0.1, 0.1, 0.35, 0.25, 0.2],
            "slopeTreshold": 0.5,
        },
        "baseInitState": {
            "pos": [0.0, 0.0, 0.62],
            "rot": [0.0, 0.0, 0.0, 1.0],
            "vLinear": [0.0, 0.0, 0.0],
            "vAngular": [0.0, 0.0, 0.0],
        },
        "randomCommandVelocityRanges": {
            "linear_x": [-1.0, 1.0], "linear_y": [-1.0, 1.0],
            "yaw": [-3.14, 3.14]},
        "control": {"stiffness": 80.0, "damping": 2.0, "actionScale": 0.5,
                    "decimation": 4},
        "defaultJointAngles": {
            "LF_HAA": 0.03, "LH_HAA": 0.03, "RF_HAA": -0.03, "RH_HAA": -0.03,
            "LF_HFE": 0.4, "LH_HFE": -0.4, "RF_HFE": 0.4, "RH_HFE": -0.4,
            "LF_KFE": -0.8, "LH_KFE": 0.8, "RF_KFE": -0.8, "RH_KFE": 0.8,
        },
        "learn": {
            "allowKneeContacts": True,
            "terminalReward": 0.0,
            "linearVelocityXYRewardScale": 1.0,
            "linearVelocityZRewardScale": -4.0,
            "angularVelocityXYRewardScale": -0.05,
            "angularVelocityZRewardScale": 0.5,
            "orientationRewardScale": -0.0,
            "torqueRewardScale": -0.00002,
            "jointAccRewardScale": -0.0005,
            "baseHeightRewardScale": -0.0,
            "feetAirTimeRewardScale": 1.0,
            "kneeCollisionRewardScale": -0.25,
            "feetStumbleRewardScale": -0.0,
            "actionRateRewardScale": -0.01,
            "hipRewardScale": -0.0,
            "linearVelocityScale": 2.0,
            "angularVelocityScale": 0.25,
            "dofPositionScale": 1.0,
            "dofVelocityScale": 0.05,
            "heightMeasurementScale": 5.0,
            "addNoise": True,
            "noiseLevel": 1.0,
            "dofPositionNoise": 0.01,
            "dofVelocityNoise": 1.5,
            "linearVelocityNoise": 0.1,
            "angularVelocityNoise": 0.2,
            "gravityNoise": 0.05,
            "heightMeasurementNoise": 0.06,
            "randomizeFriction": True,
            "frictionRange": [0.5, 1.25],
            "pushRobots": True,
            "pushInterval_s": 15,
            "episodeLength_s": 20,
        },
        "enableCameraSensors": False,
    },
    "sim": {
        "dt": 0.005,
        "substeps": 1,
        "up_axis": "z",
        "use_gpu_pipeline": True,
        "gravity": [0.0, 0.0, -9.81],
        "physx": {
            "num_threads": 4, "solver_type": 1, "use_gpu": True,
            "num_position_iterations": 4, "num_velocity_iterations": 1,
            "contact_capacity": 16,  # as Anymal
            # the decimation fold widens the substep window to 20 ms; a
            # mass matrix reused that long is stale at trot rates: a fresh
            # articulation-inertia evaluation every 5 ms tick
            "reuse_mass_matrix": False,
            "contact_offset": 0.02, "rest_offset": 0.0,
            "bounce_threshold_velocity": 0.2,
            "max_depenetration_velocity": 100.0,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 8388608, "contact_collection": 1,
        },
    },
    "task": {"randomize": False, "randomization_params": {}},
}

EP_TERMS = ["lin_vel_xy", "ang_vel_z", "lin_vel_z", "ang_vel_xy", "orient",
            "torques", "joint_acc", "collision", "stumble", "action_rate",
            "air_time", "base_height", "hip"]
KINDS = ("slope", "rough", "stairs", "discrete", "stones")


class ATTaskState(NamedTuple):
    commands: torch.Tensor         # (N, 4): vx, vy, yaw (computed), heading
    actions: torch.Tensor          # (N, 12)
    last_actions: torch.Tensor
    last_dof_vel: torch.Tensor
    feet_air_time: torch.Tensor    # (N, 4)
    terrain_levels: torch.Tensor   # (N,) int32
    terrain_types: torch.Tensor    # (N,) int32
    common_step: torch.Tensor      # () int32
    episode_sums: torch.Tensor     # (N, len(EP_TERMS))


class AnymalTerrain(VecTaskBase):
    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        e = cfg["env"]
        learn = e["learn"]
        self.decimation = int(e["control"]["decimation"])
        # the reference's decimation loop (4 simulate calls a policy step)
        # folded into engine substeps (anymal_terrain.py:156-167); the sim
        # section is copied so the caller's dict is folded only once, and
        # a given ``sim_params`` (parsed from the unfolded section) is
        # folded the same way
        cfg["sim"] = sim = dict(cfg["sim"])
        sim["substeps"] = self.decimation * int(sim.get("substeps", 1))
        sim["dt"] = float(sim["dt"]) * self.decimation
        if sim_params is not None:
            sim_params = sim_params._replace(
                substeps=self.decimation * sim_params.substeps,
                dt=sim_params.dt * self.decimation)
        e["controlFrequencyInv"] = 1
        dt_policy = sim["dt"]
        self.max_episode_length_s = float(learn["episodeLength_s"])
        e["episodeLength"] = int(self.max_episode_length_s / dt_policy + 0.5)
        self.lin_vel_scale = float(learn["linearVelocityScale"])
        self.ang_vel_scale = float(learn["angularVelocityScale"])
        self.dof_pos_scale = float(learn["dofPositionScale"])
        self.dof_vel_scale = float(learn["dofVelocityScale"])
        self.height_meas_scale = float(learn["heightMeasurementScale"])
        self.action_scale = float(e["control"]["actionScale"])
        self.Kp = float(e["control"]["stiffness"])
        self.Kd = float(e["control"]["damping"])
        self.allow_knee_contacts = bool(learn["allowKneeContacts"])
        self.curriculum = bool(e["terrain"]["curriculum"])
        self.push_interval = int(learn["pushInterval_s"] / dt_policy + 0.5)
        self.add_noise = bool(learn["addNoise"])
        rew_scales = {
            "lin_vel_xy": learn["linearVelocityXYRewardScale"],
            "ang_vel_z": learn["angularVelocityZRewardScale"],
            "lin_vel_z": learn["linearVelocityZRewardScale"],
            "ang_vel_xy": learn["angularVelocityXYRewardScale"],
            "orient": learn["orientationRewardScale"],
            "torque": learn["torqueRewardScale"],
            "joint_acc": learn["jointAccRewardScale"],
            "base_height": learn["baseHeightRewardScale"],
            "air_time": learn["feetAirTimeRewardScale"],
            "collision": learn["kneeCollisionRewardScale"],
            "stumble": learn["feetStumbleRewardScale"],
            "action_rate": learn["actionRateRewardScale"],
            "hip": learn["hipRewardScale"],
            "termination": learn["terminalReward"],
        }
        self.command_ranges = e["randomCommandVelocityRanges"]
        super().__init__(cfg, device=device, seed=seed,
                         sim_params=sim_params)
        # policy-dt-scaled reward scales (ref :94-97)
        self.policy_dt = dt_policy
        self.rew_scales = {k: v * dt_policy if k != "termination" else v
                           for k, v in rew_scales.items()}
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=self.device)
        order = joint_order(self)
        self.default_dof_pos = f32([e["defaultJointAngles"][n]
                                    for n in order])
        self.base_index = 0
        self.knee_indices = torch.as_tensor(
            body_indices(self.model, "THIGH"), device=self.device)
        self.feet_indices = torch.as_tensor(
            body_indices(self.model, "SHANK"), device=self.device)
        self.hip_dofs = torch.as_tensor(
            [i for i, n in enumerate(order) if n.endswith("HAA")],
            device=self.device)
        self.gravity_vec = f32([0.0, 0.0, -1.0])
        self.forward_vec = f32([1.0, 0.0, 0.0])
        self.up_axis = f32([0.0, 0.0, 1.0])
        b = e["baseInitState"]
        self.base_init = f32(b["pos"] + b["rot"] + b["vLinear"]
                             + b["vAngular"])
        self.cmd_scale = f32([self.lin_vel_scale, self.lin_vel_scale,
                              self.ang_vel_scale])

        # terrain map and height sample points (1 m x 1.6 m grid, ref
        # :503-513)
        tc = e["terrain"]
        self.terrain_map = CurriculumTerrain(
            num_levels=int(tc["numLevels"]), num_types=int(tc["numTerrains"]),
            terrain_width=float(tc["mapWidth"]),
            terrain_length=float(tc["mapLength"]),
            proportions=tuple(tc["terrainProportions"]),
            curriculum=self.curriculum, device=self.device)
        self.terrain = self.terrain_map.grid
        # terrain kind of each type column (the generator's cumulative-
        # proportion choice, terrain.py:300-335); only meaningful under
        # the curriculum (-1 otherwise)
        props = np.cumsum(tc["terrainProportions"]) \
            / np.sum(tc["terrainProportions"])
        choices = np.arange(int(tc["numTerrains"])) \
            / int(tc["numTerrains"]) + 0.001
        self._type_kind = torch.as_tensor(
            np.searchsorted(props, choices) if self.curriculum
            else np.full(int(tc["numTerrains"]), -1), dtype=torch.int32,
            device=self.device)
        ys = 0.1 * np.array([-5, -4, -3, -2, -1, 1, 2, 3, 4, 5])
        xs = 0.1 * np.array([-8, -7, -6, -5, -4, -3, -2, 2, 3, 4, 5, 6, 7,
                             8])
        gx, gy = np.meshgrid(xs, ys, indexing="ij")
        hp = np.stack([gx.ravel(), gy.ravel()], -1)              # (140, 2)
        self.height_points = f32(np.concatenate(
            [hp, np.zeros((len(hp), 1))], -1))                   # (140, 3)
        # noise scale vector (ref :174-186)
        nl = float(learn["noiseLevel"])
        nv = np.zeros(188, np.float32)
        nv[0:3] = learn["linearVelocityNoise"] * nl * self.lin_vel_scale
        nv[3:6] = learn["angularVelocityNoise"] * nl * self.ang_vel_scale
        nv[6:9] = learn["gravityNoise"] * nl
        nv[12:24] = learn["dofPositionNoise"] * nl * self.dof_pos_scale
        nv[24:36] = learn["dofVelocityNoise"] * nl * self.dof_vel_scale
        nv[36:176] = (learn["heightMeasurementNoise"] * nl
                      * self.height_meas_scale)
        self.noise_scale_vec = f32(nv)

    def create_model(self):
        from ..models.specs.anymal import SPEC
        return set_pd_drives(model_from_spec(SPEC), 80.0), True

    def initial_task_state(self):
        n, dev = self.num_envs, self.device
        z = lambda k: torch.zeros((n, k), dtype=DTYPE,  # noqa: E731
                                  device=dev)
        return ATTaskState(
            commands=z(4), actions=z(12), last_actions=z(12),
            last_dof_vel=z(12), feet_air_time=z(4),
            terrain_levels=torch.zeros(n, dtype=torch.int32, device=dev),
            terrain_types=((torch.arange(n, device=dev) + self.env_offset)
                           % self.terrain_map.num_types).to(torch.int32),
            common_step=torch.zeros((), dtype=torch.int32, device=dev),
            episode_sums=z(len(EP_TERMS)))

    # ------------------------------------------------------------------
    def pre_physics(self, state: EnvState, actions):
        return pd_control(self, actions)

    def draw_reset(self):
        """Reset draws from the task generator (anymal_terrain.py:
        307-356): the dof position factors U(0.5, 1.5) and velocities
        U(-0.1, 0.1), each (N, 12), the base's xy offset U(-0.5, 0.5)
        (N, 2), and the commands vx, vy and heading, each (N,)."""
        g, n, cr = self.generator, self.num_envs, self.command_ranges
        return (rand_float(g, 0.5, 1.5, (n, 12)),
                rand_float(g, -0.1, 0.1, (n, 12)),
                rand_float(g, -0.5, 0.5, (n, 2)),
                rand_float(g, *cr["linear_x"], (n,)),
                rand_float(g, *cr["linear_y"], (n,)),
                rand_float(g, *cr["yaw"], (n,)))

    def draw_step(self):
        """``post_physics``'s draws from the task generator: the push
        velocities U(-1, 1) (N, 2) and the observation noise U(0, 1)
        (N, 188), drawn every step as the JAX task draws them."""
        g, n = self.generator, self.num_envs
        return (rand_float(g, -1.0, 1.0, (n, 2)),
                rand_float(g, 0.0, 1.0, (n, 188)))

    def reset_idx(self, sim: SimState, task: ATTaskState, mask, draws=None):
        pos_u, vel, xy_noise, cx, cy, cyaw = (self.draw_reset()
                                              if draws is None else draws)
        n = self.num_envs
        sim = self.engine.set_dof_pos(sim, masked_update(
            mask, self.default_dof_pos * pos_u, self.engine.dof_pos(sim)))
        sim = self.engine.set_dof_vel(
            sim, masked_update(mask, vel, self.engine.dof_vel(sim)))

        # terrain curriculum (ref :427-435)
        origins_t = self.terrain_map.env_origins_t
        types = task.terrain_types
        origins = origins_t[task.terrain_levels, types]
        dist = torch.linalg.vector_norm(sim.q[:, 0:2] - origins[:, 0:2],
                                        dim=-1)
        cmd_norm = torch.linalg.vector_norm(task.commands[:, 0:2], dim=-1)
        demote = dist < cmd_norm * self.max_episode_length_s * 0.25
        promote = dist > self.terrain_map.env_length / 2
        new_levels = (task.terrain_levels - demote.to(torch.int32)
                      + promote.to(torch.int32))
        new_levels = torch.clamp(new_levels, min=0) \
            % self.terrain_map.num_levels
        levels = (torch.where(mask, new_levels, task.terrain_levels)
                  if self.curriculum else task.terrain_levels)
        origins = origins_t[levels, types]

        root0 = self.base_init
        root_pos = origins + root0[0:3] + torch.cat(
            [xy_noise, torch.zeros_like(xy_noise[:, :1])], -1)
        q, qd = sim.q.clone(), sim.qd.clone()
        q[:, 0:7] = masked_update(
            mask, torch.cat([root_pos, root0[3:7].expand(n, 4)], -1),
            q[:, 0:7])
        qd[:, 0:6] = masked_update(mask, root0[7:13].expand(n, 6),
                                   qd[:, 0:6])

        cmd = torch.stack([cx, cy, torch.zeros_like(cx), cyaw], -1)
        # zero out small commands (ref :412)
        cmd = cmd * (torch.linalg.vector_norm(cmd[:, 0:2], dim=-1)
                     > 0.25)[:, None]
        zero = lambda x: masked_update(  # noqa: E731
            mask, torch.zeros_like(x), x)
        task = ATTaskState(
            commands=masked_update(mask, cmd, task.commands),
            actions=zero(task.actions), last_actions=zero(task.last_actions),
            last_dof_vel=zero(task.last_dof_vel),
            feet_air_time=zero(task.feet_air_time),
            terrain_levels=levels, terrain_types=types,
            common_step=task.common_step,
            episode_sums=zero(task.episode_sums))
        return SimState(q, qd), task

    # ------------------------------------------------------------------
    def post_physics(self, state: EnvState, out, actions, draws=None):
        push_vel, noise_u = self.draw_step() if draws is None else draws
        task: ATTaskState = state.task
        n = self.num_envs
        common_step = task.common_step + 1

        # random pushes (ref :437-439): the bases' xy velocity replaced
        do_push = (common_step % self.push_interval) == 0
        qd = state.sim.qd.clone()
        qd[:, 0:2] = torch.where(do_push, push_vel, qd[:, 0:2])
        sim = state.sim._replace(qd=qd)
        out = self.engine.forward(sim, prev_out=out)

        root = out.root_states[:, 0]
        base_quat = root[:, 3:7]
        base_lin_vel = maths.quat_rotate_inverse(base_quat, root[:, 7:10])
        base_ang_vel = maths.quat_rotate_inverse(base_quat, root[:, 10:13])
        projected_gravity = maths.quat_rotate_inverse(base_quat,
                                                      self.gravity_vec)
        forward = maths.quat_apply(base_quat, self.forward_vec)
        heading = torch.atan2(forward[:, 1], forward[:, 0])
        yaw_cmd = torch.clamp(
            0.5 * maths.normalize_angle(task.commands[:, 3] - heading),
            -1.0, 1.0)
        commands = task.commands.clone()
        commands[:, 2] = yaw_cmd

        dof_pos = self.engine.dof_pos(sim)
        dof_vel = self.engine.dof_vel(sim)
        targets = self.action_scale * actions + self.default_dof_pos
        torques = torch.clamp(
            self.Kp * (targets - dof_pos) - self.Kd * dof_vel, -80.0, 80.0)

        # height samples in the yaw frame (ref :515-538)
        yaw_quat = maths.quat_from_angle_axis(heading, self.up_axis)
        pts = maths.quat_apply(yaw_quat[:, None, :],
                               self.height_points.expand(n, -1, -1))
        px = pts[..., 0] + root[:, None, 0]
        py = pts[..., 1] + root[:, None, 1]
        measured = self.step_terrain(state.sim).height_min2(px, py)
        heights_obs = torch.clamp(root[:, None, 2] - 0.5 - measured,
                                  -1.0, 1.0) * self.height_meas_scale

        obs = torch.cat([
            base_lin_vel * self.lin_vel_scale,
            base_ang_vel * self.ang_vel_scale,
            projected_gravity,
            commands[:, 0:3] * self.cmd_scale,
            dof_pos * self.dof_pos_scale,
            dof_vel * self.dof_vel_scale,
            heights_obs,
            actions,
        ], dim=-1)
        if self.add_noise:
            obs = obs + (2.0 * noise_u - 1.0) * self.noise_scale_vec

        # ---- termination (ref :294-300)
        cf = out.contact_force
        reset = torch.linalg.vector_norm(cf[:, self.base_index],
                                         dim=-1) > 1.0
        knee_contact = torch.linalg.vector_norm(cf[:, self.knee_indices],
                                                dim=-1) > 1.0
        if not self.allow_knee_contacts:
            reset = reset | torch.any(knee_contact, dim=1)
        timeout = state.progress >= self.max_episode_length - 1
        reset = (reset | timeout).to(torch.int32)

        # ---- reward (ref :316-385), the terms summed in the JAX order
        rs = self.rew_scales
        sq = torch.square
        lin_vel_error = torch.sum(sq(commands[:, :2] - base_lin_vel[:, :2]),
                                  1)
        ang_vel_error = sq(commands[:, 2] - base_ang_vel[:, 2])
        terms = {}
        terms["lin_vel_xy"] = torch.exp(-lin_vel_error / 0.25) \
            * rs["lin_vel_xy"]
        terms["ang_vel_z"] = torch.exp(-ang_vel_error / 0.25) \
            * rs["ang_vel_z"]
        terms["lin_vel_z"] = sq(base_lin_vel[:, 2]) * rs["lin_vel_z"]
        terms["ang_vel_xy"] = torch.sum(sq(base_ang_vel[:, :2]), 1) \
            * rs["ang_vel_xy"]
        terms["orient"] = torch.sum(sq(projected_gravity[:, :2]), 1) \
            * rs["orient"]
        terms["base_height"] = sq(root[:, 2] - 0.52) * rs["base_height"]
        terms["torques"] = torch.sum(sq(torques), 1) * rs["torque"]
        terms["joint_acc"] = torch.sum(sq(task.last_dof_vel - dof_vel), 1) \
            * rs["joint_acc"]
        terms["collision"] = torch.sum(knee_contact.to(DTYPE), 1) \
            * rs["collision"]
        feet_cf = cf[:, self.feet_indices]
        stumble = ((torch.linalg.vector_norm(feet_cf[..., :2], dim=-1) > 5.0)
                   & (torch.abs(feet_cf[..., 2]) < 1.0))
        terms["stumble"] = torch.sum(stumble.to(DTYPE), 1) * rs["stumble"]
        terms["action_rate"] = torch.sum(sq(task.last_actions - actions), 1) \
            * rs["action_rate"]
        contact = feet_cf[..., 2] > 1.0
        first_contact = (task.feet_air_time > 0.0) & contact
        feet_air_time = task.feet_air_time + self.policy_dt
        rew_air = torch.sum((feet_air_time - 0.5) * first_contact.to(DTYPE),
                            1) * rs["air_time"]
        rew_air = rew_air * (torch.linalg.vector_norm(commands[:, :2],
                                                      dim=-1) > 0.1)
        terms["air_time"] = rew_air
        feet_air_time = feet_air_time * (~contact)
        terms["hip"] = torch.sum(torch.abs(
            dof_pos[:, self.hip_dofs] - self.default_dof_pos[self.hip_dofs]),
            1) * rs["hip"]

        rew = sum(terms.values())
        rew = torch.clamp(rew, min=0.0)
        rew = rew + rs["termination"] * reset * (~timeout)

        episode_sums = task.episode_sums + torch.stack(
            [terms[k] for k in EP_TERMS], -1)
        done = reset > 0
        n_done = torch.clamp(torch.sum(reset), min=1)
        episode = {
            f"rew_{k}": torch.sum(torch.where(done, episode_sums[:, i], 0.0))
            / n_done / self.max_episode_length_s
            for i, k in enumerate(EP_TERMS)}
        lv = task.terrain_levels.to(DTYPE)
        episode["terrain_level"] = torch.mean(lv)
        # per-kind level means: which terrain family gates the curriculum
        env_kind = self._type_kind[task.terrain_types]
        for k, kname in enumerate(KINDS):
            sel = (env_kind == k).to(DTYPE)
            episode[f"lvl_{kname}"] = (torch.sum(lv * sel)
                                       / torch.clamp(torch.sum(sel), min=1.0))

        task = ATTaskState(
            commands=commands, actions=actions, last_actions=actions,
            last_dof_vel=dof_vel, feet_air_time=feet_air_time,
            terrain_levels=task.terrain_levels,
            terrain_types=task.terrain_types,
            common_step=common_step, episode_sums=episode_sums)
        return obs, None, rew, reset, task, {"episode": episode}, sim
