"""Trifinger cube repositioning (port of
isaacgymenvs_ma_tpu/tasks/trifinger.py) — obs 41 / states 113 / act 9 at
16384 envs, with the shipped domain randomization on.

Three 3-dof fingers around a 0.195 m arena move a 0.065 m cube to a goal
pose.  The scene: the finger robot from the port's copy of the trifinger
spec with a contact sphere at each fingertip, and the cube as a free
actor; contact rows are the fingertip spheres and cube corners against the
ground and the three fingertip spheres against the cube (11 ground + 3 pair
rows, reused across the 4 substeps), and force sensors sit at the
fingertips.

* Obs (ref :325-331): robot q(9), robot u(9), object pose(7), goal
  pose(7), command(9), scaled to [-1, 1] by the robot / object limit
  tables (ref :234-306); the asymmetric states (ref :333-342) add object
  velocity(6), fingertip states(39), joint torques(9) and fingertip
  wrenches(18).
* Control: torque (default; actions x 0.36 N m) or position (PD), with
  safety damping and torque saturation (ref :1013-1043).
* Reward (ref :1293-1383): finger-movement penalty, the finger-reach rate
  term while the frame count is within the schedule, and the keypoint
  reward over the cube's 8 corners.
* Goals by difficulty (ref :927-990); resets on timeout only; successes
  (pos 0.02, rot 0.4) are logged.
* Domain randomization (``task.randomize``, as shipped): the cube's scale
  and mass drawn once per env (setup_only), contact friction resampled at
  each reset, correlated and white action noise, white observation noise
  (utils/domain_rand.py).

Reset draws come from the task's generator, or are given to ``step`` as
``reset_draws`` (see :meth:`Trifinger.draw_reset`).
"""
from __future__ import annotations

import copy
import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..models.model import (FREE, GEOM_BOX, GEOM_SPHERE, Geom, ModelBuilder,
                            compose_scene, model_from_spec)
from ..models.specs.trifinger import SPEC
from ..ops import maths
from ..physics.engine import Control, PhysicsEngine, SimState
from .base import EnvState, VecTaskBase, masked_update

ARENA_RADIUS = 0.195
CUBE_SIZE = 0.065
CUBE_RADIUS_3D = CUBE_SIZE * np.sqrt(3) / 2
MAX_COM_DIST = ARENA_RADIUS - CUBE_RADIUS_3D
MIN_HEIGHT = CUBE_SIZE / 2
MAX_HEIGHT = 0.1
MAX_TORQUE = 0.36
MAX_JOINT_VEL = 10.0
TIP_OFFSET = np.array([0.019, 0.0, -0.16])   # finger_lower_to_tip_joint origin
TIP_RADIUS = 0.0155

DOF_DEFAULT = np.array([0.0, 0.9, -2.0] * 3, np.float32)
KP = np.array([10.0, 10.0, 10.0] * 3, np.float32)
KD = np.array([0.1, 0.3, 0.001] * 3, np.float32)
SAFETY_KD = np.array([0.08, 0.08, 0.04] * 3, np.float32)

TASK_CFG = {
    "name": "Trifinger",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 16384,
        "envSpacing": 1.0,
        "episodeLength": 750,
        "clipObservations": 5.0,
        "clipActions": 1.0,
        "task_difficulty": 4,
        "enable_ft_sensors": False,
        "asymmetric_obs": True,
        "normalize_obs": True,
        "apply_safety_damping": True,
        "command_mode": "torque",
        "normalize_action": True,
        "cube_obs_keypoints": True,
        "reset_distribution": {
            "object_initial_state": {"type": "random"},
            "robot_initial_state": {"type": "default",
                                    "dof_pos_stddev": 0.4,
                                    "dof_vel_stddev": 0.2},
        },
        "reward_terms": {
            "finger_move_penalty": {"activate": True, "weight": -0.5},
            "finger_reach_object_rate": {"activate": True, "weight": -250.0},
            "object_dist": {"activate": False, "weight": 2000.0},
            "object_rot": {"activate": False, "weight": 2000.0},
            "keypoints_dist": {"activate": True, "weight": 2000.0},
        },
        "termination_conditions": {
            "success": {"orientation_tolerance": 0.4,
                        "position_tolerance": 0.02}},
    },
    "sim": {
        "dt": 0.02, "substeps": 4, "up_axis": "z",
        "gravity": [0.0, 0.0, -9.81],
        "physx": {"num_position_iterations": 8, "num_velocity_iterations": 0,
                  "contact_offset": 0.002, "rest_offset": 0.0,
                  "reuse_contact_rows": True,
                  "max_depenetration_velocity": 1000.0},
    },
    # reference Trifinger.yaml:85-160 ships randomize: True (per-dof limit
    # noise is not modeled, as in the JAX package)
    "task": {
        "randomize": True,
        "randomization_params": {
            "frequency": 750,
            "observations": {"range": [0, 0.002],
                             "range_correlated": [0, 0.000],
                             "operation": "additive",
                             "distribution": "gaussian"},
            "actions": {"range": [0, 0.02],
                        "range_correlated": [0, 0.01],
                        "operation": "additive",
                        "distribution": "gaussian"},
            "actor_params": {
                "object": {
                    "scale": {"range": [0.97, 1.03], "operation": "scaling",
                              "distribution": "uniform", "setup_only": True},
                    "rigid_body_properties": {
                        "mass": {"range": [0.7, 1.3], "operation": "scaling",
                                 "distribution": "uniform",
                                 "setup_only": True}},
                    "rigid_shape_properties": {
                        "friction": {"range": [0.7, 1.3],
                                     "operation": "scaling",
                                     "distribution": "uniform"}},
                },
            },
        },
    },
}


class TrifingerTaskState(NamedTuple):
    goal_pose: torch.Tensor       # (N, 7)
    last_ft_pos: torch.Tensor     # (N, 3, 3) previous-step fingertips
    last_obj_pos: torch.Tensor    # (N, 3)
    successes: torch.Tensor       # (N,) success at this step (logging)
    frames: torch.Tensor          # () drives the finger-reach schedule


def lgsk_kernel(x, scale=50.0, eps=2.0):
    """Logistic kernel bounding a distance to (0, 1/(2+eps)] (ref
    :1261-1275)."""
    scaled = x * scale
    return 1.0 / (torch.exp(scaled) + eps + torch.exp(-scaled))


_CORNERS = np.array([[(1 if ((i >> k) & 1) == 0 else -1) * CUBE_SIZE / 2
                      for k in range(3)] for i in range(8)], np.float32)


def gen_keypoints(pose, corners):
    """The cube's corners in the world frame (ref gen_keypoints
    :1278-1290): ``pose`` (..., 7), ``corners`` (8, 3)."""
    pos, quat = pose[..., 0:3], pose[..., 3:7]
    return pos[..., None, :] + maths.quat_apply(quat[..., None, :], corners)


class Trifinger(VecTaskBase):
    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        e = cfg["env"]
        self.asymmetric_obs = bool(e.get("asymmetric_obs", True))
        e["numObservations"] = 41
        e["numActions"] = 9
        e["numStates"] = 113 if self.asymmetric_obs else 0
        self.difficulty = int(e.get("task_difficulty", 4))
        self.command_mode = e.get("command_mode", "torque")
        self.normalize_action = bool(e.get("normalize_action", True))
        self.normalize_obs = bool(e.get("normalize_obs", True))
        self.safety_damping = bool(e.get("apply_safety_damping", True))
        rt = e.get("reward_terms", TASK_CFG["env"]["reward_terms"])
        self.w_move = float(rt["finger_move_penalty"]["weight"])
        self.w_reach = float(rt["finger_reach_object_rate"]["weight"])
        self.w_dist = float(rt["object_dist"]["weight"])
        self.w_rot = float(rt["object_rot"]["weight"])
        self.w_kp = float(rt["keypoints_dist"]["weight"])
        self.use_keypoints = bool(rt["keypoints_dist"].get("activate", True))
        tc = e.get("termination_conditions",
                   TASK_CFG["env"]["termination_conditions"])
        self.pos_tol = float(tc["success"]["position_tolerance"])
        self.rot_tol = float(tc["success"]["orientation_tolerance"])
        rd = e.get("reset_distribution",
                   TASK_CFG["env"]["reset_distribution"])
        self.robot_reset = rd["robot_initial_state"]
        self.object_reset = rd["object_initial_state"]
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)

        m = self.model
        dev = self.device
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=dev)
        self.object_body = m.body_names.index("object")
        self.obj_qa = int(m.q_adr[self.object_body])
        self.obj_va = int(m.v_adr[self.object_body])
        self.lower_links = np.asarray(
            [m.body_names.index(f"finger_lower_link_{a}")
             for a in (0, 120, 240)], np.int64)
        self.finger_dofs = np.asarray(self.engine.scalar_dofs[:9])
        self._lower_links_t = torch.as_tensor(self.lower_links, device=dev)
        self._finger_dofs_t = torch.as_tensor(self.finger_dofs, device=dev)
        self.dof_lower = f32(np.asarray(m.dof_lower)[self.finger_dofs])
        self.dof_upper = f32(np.asarray(m.dof_upper)[self.finger_dofs])
        self.dof_default = f32(DOF_DEFAULT)
        self.kp, self.kd, self.safety_kd = f32(KP), f32(KD), f32(SAFETY_KD)
        self.tip_offset = f32(TIP_OFFSET)
        self.corners = f32(_CORNERS)
        self._ez = f32([0.0, 0.0, 1.0])
        self._quat_id = f32([0.0, 0.0, 0.0, 1.0])
        # observation normalization bounds (ref __configure_mdp_spaces
        # :592-676): [robot q, robot u, object pose, goal pose, command]
        cmd = MAX_TORQUE if self.command_mode == "torque" else 1.0
        lo_pos, hi_pos = [-0.3, -0.3, 0.0], [0.3, 0.3, 0.3]
        self._obs_low = torch.cat([
            self.dof_lower, f32([-MAX_JOINT_VEL] * 9), f32(lo_pos),
            f32([-1.0] * 4), f32(lo_pos), f32([-1.0] * 4), f32([-cmd] * 9)])
        self._obs_high = torch.cat([
            self.dof_upper, f32([MAX_JOINT_VEL] * 9), f32(hi_pos),
            f32([1.0] * 4), f32(hi_pos), f32([1.0] * 4), f32([cmd] * 9)])

    # ------------------------------------------------------------------
    def create_model(self):
        robot = model_from_spec(copy.deepcopy(SPEC))
        # torque control (command_mode torque): no implicit drives
        for d in range(robot.nv):
            robot.dof_damping[d] = max(robot.dof_damping[d], 0.01)
        # fingertip contact spheres at the tip-frame offset (the reference's
        # tip mesh approximated by the tip sphere)
        for a in (0, 120, 240):
            b = robot.body_names.index(f"finger_lower_link_{a}")
            robot.geoms.append(Geom(
                body=b, gtype=GEOM_SPHERE,
                size=np.array([TIP_RADIUS, 0, 0]), pos=TIP_OFFSET.copy(),
                quat=np.array([0.0, 0, 0, 1]), friction=1.0, contact=True,
                name=f"tip_{a}"))
        ob = ModelBuilder()
        ob.begin_actor()
        obj = ob.add_body("object", -1, FREE,
                          body_pos=np.array([0.0, 0.0, MIN_HEIGHT]))
        # cube_multicolor_rrc: 0.065 cube, 0.094 kg
        ob.add_geom(obj, GEOM_BOX, np.full(3, CUBE_SIZE / 2),
                    density=0.094 / CUBE_SIZE ** 3, name="object_geom")
        model = compose_scene([
            (robot, (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0)),
            (ob.finalize(), (0, 0, 0), (0, 0, 0, 1))])
        # fingertip force / torque sensors (the asymmetric states)
        model.sensor_body = np.asarray(
            [model.body_names.index(f"finger_lower_link_{a}")
             for a in (0, 120, 240)], np.int32)
        model.sensor_pos = np.tile(TIP_OFFSET, (3, 1))
        return model, True

    def build_engine(self, model, ground):
        names = [g.name for g in model.geoms]
        obj_geom = names.index("object_geom")
        pairs = [(names.index(f"tip_{a}"), obj_geom) for a in (0, 120, 240)]
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs, device=self.device)

    # ------------------------------------------------------------------
    def _tip_positions(self, body_pos, body_quat):
        ll = self._lower_links_t
        return body_pos[:, ll] + maths.quat_apply(body_quat[:, ll],
                                                  self.tip_offset)

    def initial_task_state(self):
        n = self.num_envs
        kw = dict(dtype=DTYPE, device=self.device)
        goal = torch.tensor([0, 0, MIN_HEIGHT, 0, 0, 0, 1.0], **kw)
        return TrifingerTaskState(
            goal_pose=goal.repeat(n, 1),
            last_ft_pos=torch.zeros((n, 3, 3), **kw),
            last_obj_pos=torch.zeros((n, 3), **kw),
            successes=torch.zeros(n, **kw),
            frames=torch.zeros((), **kw))

    def pre_physics(self, state: EnvState, actions) -> Control:
        n, nv = self.num_envs, self.engine.nv
        qd = self.engine.dof_vel(state.sim)[:, :9]
        if self.normalize_action:
            if self.command_mode == "torque":
                cmd = actions * MAX_TORQUE
            else:
                cmd = maths.unscale_transform(actions, self.dof_lower,
                                              self.dof_upper)
        else:
            cmd = actions
        if self.command_mode == "torque":
            tau9 = cmd
        else:
            q9 = self.engine.dof_pos(state.sim)[:, :9]
            tau9 = self.kp * (cmd - q9) - self.kd * qd
        tau9 = torch.clamp(tau9, -MAX_TORQUE, MAX_TORQUE)
        if self.safety_damping:
            tau9 = torch.clamp(tau9 - self.safety_kd * qd, -MAX_TORQUE,
                               MAX_TORQUE)
        kw = dict(dtype=DTYPE, device=self.device)
        tau = torch.zeros((n, nv), **kw)
        tau[:, self._finger_dofs_t] = tau9
        return Control(tau=tau, pos_target=torch.zeros((n, nv), **kw),
                       vel_target=torch.zeros((n, nv), **kw))

    # -- reset draws and samplers (ref :833-990, :1427-1516) -----------
    def draw_reset(self):
        """Every reset draw, whatever the distributions use, in the JAX
        key order (trifinger.py:342-386): robot dof position and velocity
        N(0, 1) (N, 9) each; the object's radius U[0, 1), angle U[0, 2 pi)
        and yaw U[-pi, pi) (N,) each; the goal's radius U[0, 1), angle
        U[0, 2 pi), height U[lo, hi) of the difficulty (3: MIN_HEIGHT ..
        MAX_HEIGHT, else CUBE_RADIUS_3D .. MAX_HEIGHT), yaw U[-pi, pi)
        (N,) each and its quaternion's U[0, 1) (N, 3)."""
        n, g = self.num_envs, self.generator
        kw = dict(generator=g, device=g.device, dtype=DTYPE)
        u = lambda *s: torch.rand(s, **kw)  # noqa: E731
        z_lo = MIN_HEIGHT if self.difficulty == 3 else CUBE_RADIUS_3D
        return (torch.randn((n, 9), **kw), torch.randn((n, 9), **kw),
                u(n), 2 * math.pi * u(n), math.pi * (2 * u(n) - 1),
                u(n), 2 * math.pi * u(n), z_lo + (MAX_HEIGHT - z_lo) * u(n),
                math.pi * (2 * u(n) - 1), u(n, 3))

    @staticmethod
    def _xy(r_u, th, max_r):
        r = max_r * torch.sqrt(r_u)
        return r * torch.cos(th), r * torch.sin(th)

    def _yaw_quat(self, yaw):
        return maths.quat_from_angle_axis(yaw, self._ez)

    @staticmethod
    def _random_quat(u):
        s0, s1 = torch.sqrt(1 - u[:, 0]), torch.sqrt(u[:, 0])
        a, b = 2 * np.pi * u[:, 1], 2 * np.pi * u[:, 2]
        return torch.stack([s0 * torch.sin(a), s0 * torch.cos(a),
                            s1 * torch.sin(b), s1 * torch.cos(b)], -1)

    def _goal(self, draws):
        """Goal poses by difficulty (ref :927-990)."""
        n = self.num_envs
        r_u, th, z, yaw, quat_u = draws[5], draws[6], draws[7], draws[8], \
            draws[9]
        d = self.difficulty
        ident = self._quat_id.expand(n, 4)
        if d in (1, -1):
            x, y = self._xy(r_u, th, MAX_COM_DIST)
            z = torch.full_like(x, MIN_HEIGHT)
            quat = self._yaw_quat(yaw) if d == -1 else ident
        elif d == 2:
            x = y = torch.zeros_like(r_u)
            z = torch.full_like(x, MIN_HEIGHT + 0.05)
            quat = ident
        elif d == 3:
            x, y = self._xy(r_u, th, MAX_COM_DIST)
            quat = ident
        else:
            x, y = self._xy(r_u, th, MAX_COM_DIST)
            quat = self._random_quat(quat_u)
        return torch.cat([torch.stack([x, y, z], -1), quat], -1)

    def reset_idx(self, sim: SimState, task: TrifingerTaskState, mask,
                  draws=None):
        n = self.num_envs
        draws = self.draw_reset() if draws is None else draws
        dof_n, vel_n, obj_r_u, obj_th, obj_yaw = draws[:5]
        dof = self.dof_default.expand(n, 9)
        dvel = torch.zeros_like(dof)
        if self.robot_reset.get("type") == "random":
            dof = dof + float(self.robot_reset["dof_pos_stddev"]) * dof_n
            dof = torch.clamp(dof, self.dof_lower, self.dof_upper)
            dvel = float(self.robot_reset["dof_vel_stddev"]) * vel_n
        full_pos = self.engine.dof_pos(sim).clone()
        full_pos[:, :9] = masked_update(mask, dof, full_pos[:, :9])
        sim = self.engine.set_dof_pos(sim, full_pos)
        full_vel = self.engine.dof_vel(sim).clone()
        full_vel[:, :9] = masked_update(mask, dvel, full_vel[:, :9])
        sim = self.engine.set_dof_vel(sim, full_vel)
        if self.object_reset.get("type") == "random":
            x, y = self._xy(obj_r_u, obj_th, MAX_COM_DIST)
            quat = self._yaw_quat(obj_yaw)
        else:
            x = y = torch.zeros_like(obj_r_u)
            quat = self._quat_id.expand(n, 4)
        opose = torch.cat([torch.stack(
            [x, y, torch.full_like(x, MIN_HEIGHT)], -1), quat], -1)
        qa, va = self.obj_qa, self.obj_va
        q, qd = sim.q.clone(), sim.qd.clone()
        q[:, qa: qa + 7] = masked_update(mask, opose, q[:, qa: qa + 7])
        qd[:, va: va + 6] = masked_update(mask, torch.zeros_like(
            qd[:, va: va + 6]), qd[:, va: va + 6])
        sim = SimState(q, qd)
        goal = self._goal(draws)
        body_x, body_q = self.engine.kinematics(q)[:2]
        task = TrifingerTaskState(
            goal_pose=masked_update(mask, goal, task.goal_pose),
            last_ft_pos=masked_update(mask, self._tip_positions(body_x,
                                                                body_q),
                                      task.last_ft_pos),
            last_obj_pos=masked_update(mask, opose[:, 0:3],
                                       task.last_obj_pos),
            successes=torch.where(mask, 0.0, task.successes),
            frames=task.frames)
        return sim, task

    def post_physics(self, state: EnvState, out, actions):
        n = self.num_envs
        task: TrifingerTaskState = state.task
        dt = self.dt
        obj = out.root_states[:, 1]
        obj_pose, obj_vel = obj[:, 0:7], obj[:, 7:13]
        ft_pos = self._tip_positions(out.body_pos, out.body_quat)
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)  # noqa: E731

        # ---- reward (ref :1293-1383)
        ft_vel = (ft_pos - task.last_ft_pos) / dt
        move_penalty = self.w_move * torch.sum(
            torch.square(ft_vel).reshape(n, -1), -1)
        curr_norms = norm(ft_pos - obj_pose[:, None, 0:3])
        prev_norms = norm(task.last_ft_pos - task.last_obj_pos[:, None, :])
        # the finger-reach schedule: env-step counts in [0, 5e7] (ref
        # :1317-1318)
        ft_sched = (task.frames <= 5e7).to(DTYPE)
        reach_reward = self.w_reach * ft_sched * torch.sum(
            curr_norms - prev_norms, -1)
        if self.use_keypoints:
            d = norm(gen_keypoints(obj_pose, self.corners)
                     - gen_keypoints(task.goal_pose, self.corners))
            pose_reward = self.w_kp * dt * torch.mean(
                lgsk_kernel(d, scale=30.0, eps=2.0), -1)
        else:
            od = norm(obj_pose[:, 0:3] - task.goal_pose[:, 0:3])
            dist_reward = self.w_dist * dt * lgsk_kernel(od, 50.0, 2.0)
            ang = maths.quat_diff_rad(obj_pose[:, 3:7], task.goal_pose[:, 3:7])
            rot_reward = self.w_rot * dt / (3.0 * torch.abs(ang) + 0.01)
            pose_reward = dist_reward + rot_reward
        reward = move_penalty + reach_reward + pose_reward

        # ---- success bookkeeping (ref _check_termination)
        pos_ok = norm(obj_pose[:, 0:3] - task.goal_pose[:, 0:3]) <= self.pos_tol
        rot_ok = torch.abs(maths.quat_diff_rad(
            obj_pose[:, 3:7], task.goal_pose[:, 3:7])) <= self.rot_tol
        success = pos_ok if self.difficulty < 4 else pos_ok & rot_ok
        reset = (state.progress >= self.max_episode_length - 1).to(torch.int32)

        # ---- observations
        q9 = self.engine.dof_pos(state.sim)[:, :9]
        u9 = self.engine.dof_vel(state.sim)[:, :9]
        obs = torch.cat([q9, u9, obj_pose, task.goal_pose, actions], -1)
        if self.normalize_obs:
            obs = maths.scale_transform(obs, self._obs_low, self._obs_high)
        states = None
        if self.asymmetric_obs:
            ll = self._lower_links_t
            ft_state = torch.cat([ft_pos, out.body_quat[:, ll],
                                  out.body_vel[:, ll]], -1)
            states = torch.cat([
                obs, obj_vel, ft_state.reshape(n, -1),
                out.dof_force[:, self._finger_dofs_t],
                out.sensor_forces.reshape(n, -1)], -1)

        task = TrifingerTaskState(
            goal_pose=task.goal_pose, last_ft_pos=ft_pos,
            last_obj_pos=obj_pose[:, 0:3], successes=success.to(DTYPE),
            frames=task.frames + self.num_envs)
        extras = {"consecutive_successes": task.successes.mean(),
                  "true_objective": task.successes.mean()}
        return obs, states, reward, reset, task, extras
