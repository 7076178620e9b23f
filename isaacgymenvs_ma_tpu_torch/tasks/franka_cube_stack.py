"""FrankaCubeStack (port of isaacgymenvs_ma_tpu/tasks/franka_cube_stack.py)
— obs 19 / act 7 at 8192 envs.

One Franka stacks cube A (0.050 m) on cube B (0.070 m) under OSC control
(kernel B5) of its 6-dof pose deltas; the 7th action opens (>= 0) or
closes the gripper.  Grasping is a grab constraint pinning cube A to the
grip site while the gripper closes within 4 cm of it (the JAX package
measures that with ``engine.fk``, the port with kernel B1, as its other
grab gates).  Contact rows: both cubes' corners against the ground and the
table top, cube A's corners against cube B.  Obs: [cubeA_quat, cubeA_pos,
cubeA_to_cubeB, eef_pos, eef_quat, gripper q(2)]; the reward is the
reference's (tanh reach of the eef and both fingers, lift bonus, align
over cube B, sparse stack bonus 16 with the gripper away), and an episode
resets on success or timeout.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..physics.engine import Control, PhysicsEngine
from ..utils.config import deep_merge
from .base import EnvState
from .franka_reach_ma import (TABLE_SURFACE_Z, FrankaReachMA,
                              TASK_CFG as REACH_CFG)

TASK_CFG = deep_merge(REACH_CFG, {
    "name": "FrankaCubeStack",
    "env": {"numEnvs": 8192, "numAgents": 1, "numTargets": 2,
            "episodeLength": 300},
})

CUBE_A = 0.050
CUBE_B = 0.070


class CubeStackTaskState(NamedTuple):
    actions: torch.Tensor   # (N, 7) cached for the reward


class FrankaCubeStack(FrankaReachMA):

    NUM_ACTIONS = 7

    def _obs_dim(self, K, T):
        return 19

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        cfg["env"]["numAgents"] = 1
        cfg["env"]["numTargets"] = 2
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)
        m = self.model
        dev = self.device
        idx = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.int64), device=dev)
        self.finger_bodies = np.asarray(
            [i for i, n in enumerate(m.body_names)
             if n in ("panda_leftfinger", "panda_rightfinger")])
        qa_a, qa_b = int(self.cube_q_adr[0]), int(self.cube_q_adr[1])
        # the step's index tensors, on the device once
        self._finger_bodies_t = idx(self.finger_bodies)
        self._cube_a_pos_t = idx(qa_a + np.arange(3))
        self._cube_a_quat_t = idx(qa_a + 3 + np.arange(4))
        self._cube_b_pos_t = idx(qa_b + np.arange(3))
        self._gripper0_t = idx(self.gripper_dofs[0])
        self._gripper0_qids_t = idx(self.engine.dof_qid[self.gripper_dofs[0]])
        self._stack_offset = torch.as_tensor(
            [0.0, 0.0, (CUBE_A + CUBE_B) / 2], dtype=DTYPE, device=dev)

    def create_model(self):
        model, ground = super().create_model()
        # the two cubes resized (the parent builds two 0.05 cubes)
        for g, size in zip([g for g in model.geoms if g.name == "cubeA_geom"],
                           (CUBE_A, CUBE_B)):
            g.size = np.full(3, size / 2)
        return model, ground

    def build_engine(self, model, ground):
        table = [i for i, g in enumerate(model.geoms) if g.name == "table_top"]
        cubes = [i for i, g in enumerate(model.geoms)
                 if g.name == "cubeA_geom"]
        pairs = [(c, table[0]) for c in cubes]
        pairs.append((cubes[0], cubes[1]))   # cube A's corners vs cube B
        # grab: grip site <-> cube A (the suction-grasp approximation)
        grabs = [(self._grip_bodies[0], (0, 0, 0), self._cube_bodies[0],
                  (0, 0, 0))]
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs, grabs=grabs,
                             device=self.device)

    def initial_task_state(self):
        return CubeStackTaskState(actions=torch.zeros(
            (self.rl_games_batch, 7), dtype=DTYPE, device=self.device))

    def pre_physics(self, state: EnvState, actions) -> Control:
        """OSC on actions[:, :6], the fingers opened (0.035) or closed by
        actions[:, 6] (ref :585-600), and cube A pinned to the grip site
        while the gripper closes within 4 cm of it."""
        ctrl = FrankaReachMA.pre_physics(self, state, actions)
        grip = torch.where(actions[:, 6] >= 0.0, 0.035, 0.0)
        pos_target = ctrl.pos_target
        pos_target[:, self._gripper0_t] = grip[:, None]
        eef = self.engine.kinematics(state.sim.q)[0][:, int(
            self.grip_bodies[0])]
        cube_a = state.sim.q[:, self._cube_a_pos_t]
        holding = ((torch.linalg.vector_norm(cube_a - eef, dim=-1) < 0.04)
                   & (actions[:, 6] < 0.0))
        return ctrl._replace(pos_target=pos_target,
                             grab_active=holding[:, None].to(DTYPE))

    def _cube_states(self, state: EnvState, out):
        """eef pos and quat, cube A's pos and quat, cube B's pos."""
        gb = int(self.grip_bodies[0])
        q = state.sim.q
        return (out.body_pos[:, gb], out.body_quat[:, gb],
                q[:, self._cube_a_pos_t], q[:, self._cube_a_quat_t],
                q[:, self._cube_b_pos_t])

    def post_physics(self, state: EnvState, out, actions):
        eef_pos, eef_quat, cube_a, cube_a_quat, cube_b = self._cube_states(
            state, out)
        lf_pos, rf_pos = out.body_pos[:, self._finger_bodies_t].unbind(1)
        a_to_b = cube_b - cube_a
        cube_a_rel = cube_a - eef_pos
        gripper_q = state.sim.q[:, self._gripper0_qids_t]
        obs = torch.cat([cube_a_quat, cube_a, a_to_b, eef_pos, eef_quat,
                         gripper_q], -1)

        # reward kernel (ref :660-717)
        target_height = CUBE_B + CUBE_A / 2.0
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)  # noqa: E731
        d = norm(cube_a_rel)
        d_lf, d_rf = norm(cube_a - lf_pos), norm(cube_a - rf_pos)
        dist_reward = 1 - torch.tanh(10.0 * (d + d_lf + d_rf) / 3)
        cube_a_height = cube_a[:, 2] - TABLE_SURFACE_Z
        lifted = (cube_a_height - CUBE_A) > 0.04
        d_ab = norm(a_to_b + self._stack_offset)
        align_reward = (1 - torch.tanh(10.0 * d_ab)) * lifted
        dist_reward = torch.maximum(dist_reward, align_reward)
        aligned = norm(a_to_b[:, :2]) < 0.02
        on_top = torch.abs(cube_a_height - target_height) < 0.02
        away = d > 0.04
        stack = aligned & on_top & away
        rs = self.cfg["env"]
        rewards = torch.where(
            stack, float(rs["stackRewardScale"]) * stack,
            float(rs["distRewardScale"]) * dist_reward
            + float(rs["liftRewardScale"]) * lifted
            + float(rs["alignRewardScale"]) * align_reward)
        reset = ((state.progress >= self.max_episode_length - 1)
                 | stack).to(torch.int32)
        return obs, None, rewards, reset, CubeStackTaskState(
            actions=actions), {}
