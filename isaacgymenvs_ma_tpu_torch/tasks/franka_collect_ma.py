"""FrankaCollectMA (port of isaacgymenvs_ma_tpu/tasks/franka_collect_ma.py)
— obs 28 / act 7 per agent at 2 arms and 2 cubes.

FrankaReachMA's scene plus a wall across the table (y = 0.3, 0.3 m tall),
composed in as an extra fixed actor; a gripper action (the 7th), a
per-agent 7-state FSM (approach -> hold -> lift -> move -> descend ->
release -> GOAL) with a global FSM over the agents, and an FSM-staged
reward with the behaviour-stage reward (BSR).  The FSM state is part of
each agent's observation.

Grasping is the engine's grab constraints: every (grip site, cube) pair has
one, and an agent whose gripper action closes within 2.25 cm of its
nearest cube (measured on the state before the step) pins that cube to its
grip site for the step (``Control.grab_active``).  Contact rows: the
cubes' and the wall's corners against the ground (the wall's 8 sit ~1 m
up and never touch it), the cubes' corners against the table top and the
wall, the two hand spheres against each other.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..models.model import FIXED, GEOM_BOX, ModelBuilder, compose_scene
from ..physics.engine import Control, PhysicsEngine
from ..utils.config import deep_merge
from .base import EnvState
from .franka_reach_ma import (CUBE_SIZE, FRANKA_BASE_Z, TABLE_HALF, TABLE_POS,
                              FrankaReachMA, TASK_CFG as REACH_CFG,
                              franka_start_poses)

TASK_CFG = deep_merge(REACH_CFG, {
    "name": "FrankaCollectMA",
    "env": {"episodeLength": 300},
})

WALL_HEIGHT = 0.3
WALL_Y = 0.3
GRAB_DIST = CUBE_SIZE * 0.5 * 0.9   # an agent this near its cube may hold it


class CollectTaskState(NamedTuple):
    actions: torch.Tensor   # (B, 7) cached for the reward
    fsm: torch.Tensor       # (N, K) int32


class FrankaCollectMA(FrankaReachMA):

    NUM_ACTIONS = 7

    def _obs_dim(self, K, T):
        # all targets + [eef_quat, eef_pos, min_rel, base_pos, base_quat]
        # + the others' eef + [FSM, FSM]
        return (3 + 4 + 3 + 7) + 3 * T + 3 * (K - 1) + 2

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)
        N, K, T = self.num_envs, self.num_agents, self.num_targets
        dev = self.device
        # static per-agent base poses (the link0 world frames)
        pos, quat = franka_start_poses(K)
        self.base_pos = torch.as_tensor(np.concatenate(
            [pos, np.full((K, 1), FRANKA_BASE_Z)], -1).astype(np.float32),
            device=dev)                                          # (K, 3)
        self.base_quat = torch.as_tensor(quat.astype(np.float32),
                                         device=dev)             # (K, 4)
        # the same per agent row, and the index tensors of the step, made
        # once here (no host waits in the step)
        self._base_pos_rows = self.base_pos.repeat(N, 1)         # (B, 3)
        self._base_quat_rows = self.base_quat.repeat(N, 1)       # (B, 4)
        qa = self.cube_q_adr.astype(np.int64)[:, None]
        self._cube_pos_qids_t = torch.as_tensor(qa + np.arange(3), device=dev)
        # each gripper dof's agent, in _gripper_dofs_t's order
        self._gripper_agent_t = torch.as_tensor(
            np.repeat(np.arange(K), self.gripper_dofs.shape[1]), device=dev)
        self._targets_t = torch.arange(T, device=dev)

    def create_model(self):
        model, ground = super().create_model()
        # the wall as an extra fixed actor
        wb = ModelBuilder()
        wb.begin_actor()
        wall = wb.add_body("wall", -1, FIXED, body_pos=(
            0.0, WALL_Y, TABLE_POS[2] + TABLE_HALF[2] + WALL_HEIGHT / 2))
        wb.add_geom(wall, GEOM_BOX, (0.6, 0.025, WALL_HEIGHT / 2),
                    density=None, contact=True, name="wall_geom")
        model = compose_scene(
            [(model, (0, 0, 0), (0, 0, 0, 1)),
             (wb.finalize(), (0, 0, 0), (0, 0, 0, 1))])
        # the bookkeeping again, on the composed model
        self._index_model(model)
        return model, ground

    def _grab_specs(self):
        """Every (arm grip site, cube) combination, grip-site-major."""
        return [(gb, (0, 0, 0), cb, (0, 0, 0))
                for gb in self._grip_bodies for cb in self._cube_bodies]

    def build_engine(self, model, ground):
        geoms = lambda name: [i for i, g in enumerate(model.geoms)  # noqa: E731
                              if g.name == name]
        table, wall = geoms("table_top"), geoms("wall_geom")
        cubes, hands = geoms("cubeA_geom"), geoms("hand_sphere")
        pairs = [(c, table[0]) for c in cubes]
        pairs += [(c, wall[0]) for c in cubes]
        for a in range(len(hands)):
            for b in range(a + 1, len(hands)):
                pairs.append((hands[a], hands[b]))
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs, grabs=self._grab_specs(),
                             device=self.device)

    # ------------------------------------------------------------------
    def initial_task_state(self):
        return CollectTaskState(
            actions=torch.zeros((self.rl_games_batch, 7), dtype=DTYPE,
                                device=self.device),
            fsm=torch.zeros((self.num_envs, self.num_agents),
                            dtype=torch.int32, device=self.device))

    def _cube_positions(self, sim):
        return sim.q[:, self._cube_pos_qids_t]                  # (N, T, 3)

    def _nearest(self, sim):
        """Each agent's grip site (N, K, 3), the cubes (N, T, 3), the vector
        to the nearest cube (N, K, 3), its index (first of equals) and its
        position, from the sim state.  The grip sites come from kernel B1,
        where the JAX package calls ``engine.fk``, as the engine's
        ``dynamics_readout`` does."""
        N, K = self.num_envs, self.num_agents
        body_x = self.engine.kinematics(sim.q)[0]
        eef = body_x[:, self._grip_bodies_t]
        cube = self._cube_positions(sim)
        rel = cube[:, None] - eef[:, :, None]                   # (N, K, T, 3)
        nearest = torch.argmin(torch.linalg.vector_norm(rel, dim=-1), dim=-1)
        min_rel = torch.gather(
            rel, 2, nearest[..., None, None].expand(N, K, 1, 3))[:, :, 0]
        nearest_pos = torch.gather(cube, 1, nearest[..., None].expand(N, K, 3))
        return eef, cube, min_rel, nearest, nearest_pos

    def _fsm(self, md, gripper_closed, nearest_pos):
        """The 7-state FSM (franka_collect_ma.py:138-154) per agent."""
        fsm = torch.zeros(md.shape, dtype=torch.int32, device=md.device)
        close = md <= GRAB_DIST
        fsm = torch.where(close, 1, fsm)
        holding = close & gripper_closed
        fsm = torch.where(holding, 2, fsm)
        high = (nearest_pos[..., 2] - 1.05) > (WALL_HEIGHT + CUBE_SIZE / 2)
        fsm = torch.where(holding & high, 3, fsm)
        in_area = ((nearest_pos[..., 1] > WALL_Y + CUBE_SIZE)
                   & (torch.abs(nearest_pos[..., 0]) < 0.6))
        fsm = torch.where(holding & in_area, 4, fsm)
        low = (nearest_pos[..., 2] - 1.05) < WALL_HEIGHT / 2
        fsm = torch.where(holding & in_area & low, 5, fsm)
        fsm = torch.where(holding & in_area & low & ~gripper_closed, 6, fsm)
        return fsm

    @staticmethod
    def _global_fsm(fsm):
        """The global FSM over the agents (franka_collect_ma.py:156-162)."""
        g = torch.zeros(fsm.shape[0], dtype=torch.int32, device=fsm.device)
        g = torch.where(torch.any(fsm > 0, dim=-1), 1, g)
        for s in range(1, 7):
            g = torch.where(torch.all(fsm >= s, dim=-1), s + 1, g)
        return g

    def _gripper_targets(self, ctrl: Control, actions) -> torch.Tensor:
        """The OSC control's position targets with each agent's fingers
        opened (0.035) where its gripper action is >= 0, else closed."""
        N, K = self.num_envs, self.num_agents
        grip = torch.where(actions[:, 6] >= 0.0, 0.035, 0.0).reshape(N, K)
        pos_target = ctrl.pos_target
        pos_target[:, self._gripper_dofs_t] = grip[:, self._gripper_agent_t]
        return pos_target

    def pre_physics(self, state: EnvState, actions) -> Control:
        """OSC on actions[:, :6], the gripper targets from actions[:, 6], and
        the grabs: a holding agent pins its nearest cube, from the state
        before the step (franka_collect_ma.py:164-183)."""
        N, K = self.num_envs, self.num_agents
        ctrl = super().pre_physics(state, actions)
        pos_target = self._gripper_targets(ctrl, actions)
        _, _, min_rel, nearest, _ = self._nearest(state.sim)
        md = torch.linalg.vector_norm(min_rel, dim=-1)
        gripper_closed = actions[:, 6].reshape(N, K) < 0.0
        holding = (md <= GRAB_DIST) & gripper_closed
        grab = (holding[:, :, None]
                & (nearest[..., None] == self._targets_t)).reshape(N, -1)
        return ctrl._replace(pos_target=pos_target,
                             grab_active=grab.to(DTYPE))

    # ------------------------------------------------------------------
    def post_physics(self, state: EnvState, out, actions):
        N, K, T = self.num_envs, self.num_agents, self.num_targets
        B = N * K
        gb = self._grip_bodies_t
        eef_pos, eef_quat = out.body_pos[:, gb], out.body_quat[:, gb]
        cube = self._cube_positions(state.sim)
        rel = cube[:, None] - eef_pos[:, :, None]
        nearest = torch.argmin(torch.linalg.vector_norm(rel, dim=-1), dim=-1)
        min_rel = torch.gather(
            rel, 2, nearest[..., None, None].expand(N, K, 1, 3))[:, :, 0]
        nearest_pos = torch.gather(cube, 1, nearest[..., None].expand(N, K, 3))
        md = torch.linalg.vector_norm(min_rel, dim=-1)          # (N, K)

        gripper_closed = actions[:, 6].reshape(N, K) < 0.0
        fsm = self._fsm(md, gripper_closed, nearest_pos)        # (N, K)
        gfsm = self._global_fsm(fsm)                            # (N,)

        obs_all_targets = torch.repeat_interleave(cube.reshape(N, T * 3), K,
                                                  dim=0)
        obs_self = torch.cat([
            eef_quat.reshape(B, 4), eef_pos.reshape(B, 3),
            min_rel.reshape(B, 3), self._base_pos_rows,
            self._base_quat_rows], -1)
        flat = eef_pos.reshape(N, K * 3)
        others = torch.stack([torch.roll(flat, -3 * k, dims=-1)
                              for k in range(K)], 1)[..., 3:].reshape(
                                  B, 3 * (K - 1))
        fsm_f = fsm.reshape(B)
        obs_fsm = torch.stack([fsm_f, fsm_f], -1).to(DTYPE)
        obs = torch.cat([obs_all_targets, obs_self, others, obs_fsm], -1)

        # FSM-staged reward with BSR (franka_collect_ma.py:213-230)
        mdf = md.reshape(B)
        ga = actions[:, 6]
        zero = torch.zeros((), dtype=DTYPE, device=ga.device)
        r = torch.zeros(B, dtype=DTYPE, device=ga.device)
        r = r + torch.where(fsm_f == 0, torch.exp(-5.0 * mdf ** 2), zero)
        r = r + torch.where(fsm_f == 1, torch.exp(-1.0 * ga), zero)
        lift = ((nearest_pos[..., 2].reshape(B) - 1.05)
                / (WALL_HEIGHT + CUBE_SIZE / 2))
        r = r + torch.where(fsm_f == 2, lift, zero)
        d_y = torch.abs(nearest_pos[..., 1].reshape(B)
                        - (WALL_Y + CUBE_SIZE * 2.0))
        r = r + torch.where(fsm_f == 3, torch.exp(-5.0 * d_y ** 2), zero)
        d_z = torch.abs(nearest_pos[..., 2].reshape(B)
                        - (WALL_HEIGHT / 2 + 1.05))
        r = r + torch.where(fsm_f == 4, torch.exp(-5.0 * d_z ** 2), zero)
        r = r + torch.where(fsm_f == 5, torch.exp(4.0 * ga), zero)
        r = r + torch.where(fsm_f == 6, 3.0, zero)
        r = r + fsm_f.to(DTYPE)                                 # BSR
        rew = torch.clamp(r, min=0.0)

        reset = (state.progress >= self.max_episode_length - 1).to(torch.int32)
        task = CollectTaskState(actions=actions, fsm=fsm)
        fsm_r = fsm_f.to(DTYPE)
        extras = {"gFSM_mean": gfsm.to(DTYPE).mean(),
                  "episode": {"fsm_mean": fsm_r.mean(),
                              **{f"fsm_occ{s}": (fsm_f == s).to(DTYPE).mean()
                                 for s in range(7)}}}
        return obs, None, rew, reset, task, extras
