"""FrankaCabinet (port of isaacgymenvs_ma_tpu/tasks/franka_cabinet.py) —
drawer opening, obs 23 / act 9 at 4096 envs.

A Franka opens a cabinet's top drawer.  The cabinet is built as the JAX
package builds it (:func:`build_cabinet`): a FIXED box and a SLIDE drawer
(axis -x, 0-0.4 m travel, damping 10) with a handle point; the grasp is a
grab constraint between the grip site and the handle, live while the grip
site is within 5 cm of the handle and both finger actions close (measured
with kernel B1, where the JAX package calls ``engine.fk``).  Control:
joint torques on the arm (action x scale x 10), PD targets on the fingers;
no OSC, so no kernel B5.

Obs: dof positions scaled to [-1, 1] (9), dof velocities x 0.1 (9), the
grip-to-handle vector (3), the drawer's position and velocity.  Reward:
the reference's (ref :497-560) squared-inverse reach, gripper / drawer axis
alignment, around-handle and finger-distance shaping, drawer opening with
bonuses at 0.01 / 0.2 / 0.39 m, an action penalty and a behind-the-handle
penalty; an episode resets when the drawer opens past 0.39 m or times out.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..models.franka import FRANKA_DEFAULT_DOF_POS, build_franka
from ..models.model import (FIXED, GEOM_BOX, SLIDE, ModelBuilder,
                            compose_scene)
from ..ops import maths
from ..physics.engine import Control, PhysicsEngine, SimState
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "FrankaCabinet",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 4096,
        "envSpacing": 1.5,
        "episodeLength": 500,
        "enableDebugVis": False,
        "clipObservations": 5.0,
        "clipActions": 1.0,
        "actionScale": 7.5,
        "startPositionNoise": 0.0,
        "startRotationNoise": 0.0,
        "numProps": 4,
        "aggregateMode": 3,
        "dofVelocityScale": 0.1,
        "distRewardScale": 2.0,
        "rotRewardScale": 0.5,
        "aroundHandleRewardScale": 10.0,
        "openRewardScale": 7.5,
        "fingerDistRewardScale": 100.0,
        "actionPenaltyScale": 0.01,
    },
    "sim": {
        "dt": 0.01667, "substeps": 2, "up_axis": "z",
        "use_gpu_pipeline": True, "gravity": [0.0, 0.0, -9.81],
        "physx": {
            "num_threads": 4, "solver_type": 1, "use_gpu": True,
            "num_position_iterations": 12, "num_velocity_iterations": 1,
            "contact_offset": 0.005, "rest_offset": 0.0,
            "bounce_threshold_velocity": 0.2,
            "max_depenetration_velocity": 1000.0,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 1048576, "contact_collection": 0,
        },
    },
    "task": {"randomize": False},
}

CABINET_POS = np.array([0.8, 0.0, 0.4])
DRAWER_TRAVEL = 0.4
HANDLE_LOCAL = np.array([-0.35, 0.0, 0.1])  # handle point in drawer frame


def build_cabinet():
    """The cabinet actor and its drawer body (franka_cabinet.py:77-89):
    a FIXED box without contact and a damped SLIDE drawer along -x."""
    b = ModelBuilder()
    b.begin_actor()
    cab = b.add_body("cabinet", -1, FIXED, body_pos=CABINET_POS)
    b.add_geom(cab, GEOM_BOX, (0.25, 0.35, 0.4), density=None, contact=False)
    drawer = b.add_body(
        "drawer_top", cab, SLIDE, jnt_axis=(-1.0, 0.0, 0.0),
        body_pos=(0.0, 0.0, 0.25), limit_lower=0.0, limit_upper=DRAWER_TRAVEL,
        damping=10.0)
    b.add_geom(drawer, GEOM_BOX, (0.24, 0.3, 0.08), density=200.0,
               contact=False, name="drawer_box")
    return b.finalize(), drawer


class CabinetTaskState(NamedTuple):
    actions: torch.Tensor   # (N, 9) cached


class FrankaCabinet(VecTaskBase):
    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        e = cfg["env"]
        e["numObservations"] = 23
        e["numActions"] = 9
        self.action_scale = float(e["actionScale"])
        self.dof_vel_scale = float(e["dofVelocityScale"])
        self.dist_reward_scale = float(e["distRewardScale"])
        self.rot_reward_scale = float(e["rotRewardScale"])
        self.around_handle_reward_scale = float(e["aroundHandleRewardScale"])
        self.open_reward_scale = float(e["openRewardScale"])
        self.finger_dist_reward_scale = float(e["fingerDistRewardScale"])
        self.action_penalty_scale = float(e["actionPenaltyScale"])
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)
        m = self.model
        dev = self.device
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=dev)
        idx = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.int64), device=dev)
        names = m.body_names
        self.grip_body = names.index("panda_grip_site")
        self.hand_body = names.index("panda_hand")
        self.lfinger = names.index("panda_leftfinger")
        self.rfinger = names.index("panda_rightfinger")
        self.drawer_body = names.index("drawer_top")
        link0 = names.index("panda_link0")
        sub = [i for i in range(m.nb) if m.body_ancestor[link0, i]]
        self.franka_dofs = np.asarray(
            [d for d in range(m.nv) if m.dof_body[d] in sub])
        self.drawer_dof = int(m.v_adr[self.drawer_body])
        self.franka_qids = self.engine.dof_qid[self.franka_dofs]
        self.drawer_qid = int(self.engine.dof_qid[self.drawer_dof])
        self._franka_dofs_t = idx(self.franka_dofs)
        self._franka_qids_t = idx(self.franka_qids)
        self.dof_lower = f32(np.asarray(m.dof_lower)[self.franka_dofs])
        self.dof_upper = f32(np.asarray(m.dof_upper)[self.franka_dofs])
        self.default_dof = f32(FRANKA_DEFAULT_DOF_POS)
        self.handle_local = f32(HANDLE_LOCAL)
        self.gripper_forward = f32([0.0, 0.0, 1.0])
        self.gripper_up = f32([0.0, 1.0, 0.0])
        self.drawer_inward = f32([-1.0, 0.0, 0.0])
        self.drawer_up = f32([0.0, 0.0, 1.0])

    def create_model(self):
        franka = build_franka()
        cabinet, _ = build_cabinet()
        model = compose_scene([
            (franka, (0.0, 0.0, 0.0), (0, 0, 0, 1)),
            (cabinet, (0, 0, 0), (0, 0, 0, 1))])
        return model, True

    def build_engine(self, model, ground):
        drawer = model.body_names.index("drawer_top")
        grip = model.body_names.index("panda_grip_site")
        grabs = [(grip, (0, 0, 0), drawer, HANDLE_LOCAL)]
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             grabs=grabs, device=self.device)

    def initial_task_state(self):
        return CabinetTaskState(actions=torch.zeros(
            (self.num_envs, 9), dtype=DTYPE, device=self.device))

    def _handle(self, body_x, body_q):
        """The handle's world position from the drawer's pose."""
        return body_x[:, self.drawer_body] + maths.quat_apply(
            body_q[:, self.drawer_body], self.handle_local)

    def pre_physics(self, state: EnvState, actions) -> Control:
        """Arm torques = action x scale x 10 (ref :401-407 moves position
        targets; the JAX package keeps effort control), finger targets open
        (0.035) where their action is >= 0, and the handle grab live where
        the grip site is within 5 cm of the handle and both fingers close."""
        n, nv = self.num_envs, self.engine.nv
        kw = dict(dtype=DTYPE, device=self.device)
        fd = self._franka_dofs_t
        tau = torch.zeros((n, nv), **kw)
        tau[:, fd[:7]] = actions[:, :7] * self.action_scale * 10.0
        pos_target = torch.zeros((n, nv), **kw)
        pos_target[:, fd[7:9]] = torch.where(actions[:, 7:9] >= 0, 0.035, 0.0)
        body_x, body_q = self.engine.kinematics(state.sim.q)[:2]
        near = torch.linalg.vector_norm(
            body_x[:, self.grip_body] - self._handle(body_x, body_q),
            dim=-1) < 0.05
        closed = (actions[:, 7] < 0) & (actions[:, 8] < 0)
        return Control(tau=tau, pos_target=pos_target,
                       vel_target=torch.zeros((n, nv), **kw),
                       grab_active=(near & closed)[:, None].to(DTYPE))

    def draw_reset(self):
        """The reset draw (franka_cabinet.py:178-181): U[0, 1) (N, 9) for
        the arm's dof noise."""
        g = self.generator
        return (torch.rand((self.num_envs, 9), generator=g, device=g.device,
                           dtype=DTYPE),)

    def reset_idx(self, sim: SimState, task, mask, draws=None):
        (u,) = self.draw_reset() if draws is None else draws
        noise = 0.25 * (u - 0.5)
        pos = torch.clamp(self.default_dof + noise, self.dof_lower,
                          self.dof_upper)
        q = sim.q.clone()
        q[:, self._franka_qids_t] = masked_update(
            mask, pos, q[:, self._franka_qids_t])
        q[:, self.drawer_qid] = torch.where(mask, 0.0, q[:, self.drawer_qid])
        qd = torch.where(mask[:, None], 0.0, sim.qd)
        return SimState(q, qd), task

    def post_physics(self, state: EnvState, out, actions):
        grasp_pos = out.body_pos[:, self.grip_body]
        grasp_rot = out.body_quat[:, self.hand_body]
        handle_pos = self._handle(out.body_pos, out.body_quat)
        handle_rot = out.body_quat[:, self.drawer_body]
        lf = out.body_pos[:, self.lfinger]
        rf = out.body_pos[:, self.rfinger]
        dof_pos = state.sim.q[:, self._franka_qids_t]
        dof_vel = state.sim.qd[:, self._franka_dofs_t]
        drawer_pos = state.sim.q[:, self.drawer_qid]
        drawer_vel = state.sim.qd[:, self.drawer_dof]

        dof_pos_scaled = (2.0 * (dof_pos - self.dof_lower)
                          / (self.dof_upper - self.dof_lower) - 1.0)
        to_target = handle_pos - grasp_pos
        obs = torch.cat([dof_pos_scaled, dof_vel * self.dof_vel_scale,
                         to_target, drawer_pos[:, None],
                         drawer_vel[:, None]], -1)

        # reward kernel (ref :497-560)
        d = torch.linalg.vector_norm(to_target, dim=-1)
        dist_reward = (1.0 / (1.0 + d ** 2)) ** 2
        dist_reward = torch.where(d <= 0.02, dist_reward * 2, dist_reward)
        a1 = maths.quat_apply(grasp_rot, self.gripper_forward)
        a2 = maths.quat_apply(handle_rot, self.drawer_inward)
        a3 = maths.quat_apply(grasp_rot, self.gripper_up)
        a4 = maths.quat_apply(handle_rot, self.drawer_up)
        dot1 = torch.sum(a1 * a2, -1)
        dot2 = torch.sum(a3 * a4, -1)
        rot_reward = 0.5 * (torch.sign(dot1) * dot1 ** 2
                            + torch.sign(dot2) * dot2 ** 2)
        hz = handle_pos[:, 2]
        between = (lf[:, 2] > hz) & (rf[:, 2] < hz)
        zero = torch.zeros_like(d)
        around = torch.where(between, 0.5, zero)
        finger_dist = torch.where(
            between, (0.04 - torch.abs(lf[:, 2] - hz))
            + (0.04 - torch.abs(rf[:, 2] - hz)), zero)
        action_penalty = torch.sum(torch.square(actions), -1)
        open_reward = drawer_pos * around + drawer_pos
        rewards = (self.dist_reward_scale * dist_reward
                   + self.rot_reward_scale * rot_reward
                   + self.around_handle_reward_scale * around
                   + self.open_reward_scale * open_reward
                   + self.finger_dist_reward_scale * finger_dist
                   - self.action_penalty_scale * action_penalty)
        rewards = torch.where(drawer_pos > 0.01, rewards + 0.5, rewards)
        rewards = torch.where(drawer_pos > 0.2, rewards + around, rewards)
        rewards = torch.where(drawer_pos > 0.39, rewards + 2.0 * around,
                              rewards)
        behind = 0.04
        rewards = torch.where(lf[:, 0] < handle_pos[:, 0] - behind, -1.0,
                              rewards)
        rewards = torch.where(rf[:, 0] < handle_pos[:, 0] - behind, -1.0,
                              rewards)
        reset = ((drawer_pos > 0.39)
                 | (state.progress >= self.max_episode_length - 1)).to(
                     torch.int32)
        return obs, None, rewards, reset, CabinetTaskState(actions=actions), {}
