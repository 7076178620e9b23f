"""FrankaCombineMA (port of isaacgymenvs_ma_tpu/tasks/franka_combine_ma.py)
— multi-agent cube stacking, obs 48 / act 7 per agent at 2 arms, 2 cubes.

FrankaPPMA with both destination pads at one stack base: two coincident
fixed boxes, as in the JAX package.  The agents bring their own cubes to
the stack base; the per-agent FSM has its first stages only (approach ->
hold -> lift; the reference comments out the rest), the global FSM flags
crowding.  Obs: all cube poses (7T), the stack base (3), all agents' eef
poses (7K), the agent's cube and stack-base vectors and base pose,
[FSM, FSM], gFSM and the agent's index.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DTYPE
from ..utils.config import deep_merge
from .base import EnvState
from .franka_collect_ma import GRAB_DIST, CollectTaskState
from .franka_ppma import DEST_SIZE, FrankaPPMA
from .franka_reach_ma import TABLE_SURFACE_Z, TASK_CFG as REACH_CFG

TASK_CFG = deep_merge(REACH_CFG, {
    "name": "FrankaCombineMA",
    "env": {"episodeLength": 300},
})

STACK_BASE = np.array([0.0, 0.4, TABLE_SURFACE_Z + DEST_SIZE / 2])


class FrankaCombineMA(FrankaPPMA):

    def _obs_dim(self, K, T):
        return 7 * T + 3 + 7 * K + (3 + 3 + 7) + 2 + 1 + 1

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)
        N, K = self.num_envs, self.num_agents
        self.stack_base = torch.as_tensor(STACK_BASE.astype(np.float32),
                                          device=self.device)
        self._agent_idx_rows = torch.arange(K, dtype=DTYPE,
                                            device=self.device).repeat(N)

    def _dest_positions(self, T):
        return np.tile(STACK_BASE, (T, 1))

    def post_physics(self, state: EnvState, out, actions):
        N, K = self.num_envs, self.num_agents
        B = N * K
        eef_pos, cube, cube_pose, agent_pose = self._obs_env(state, out)
        own, rel = self._assigned(eef_pos, cube)
        md = torch.linalg.vector_norm(rel, dim=-1)
        stack_rel = self.stack_base - own
        gripper_closed = actions[:, 6].reshape(N, K) < 0.0

        # FSM stages 0-2 (franka_combine_ma.py:56-60)
        fsm = torch.zeros(md.shape, dtype=torch.int32, device=md.device)
        on_cube = md <= GRAB_DIST
        fsm = torch.where(on_cube, 1, fsm)
        fsm = torch.where(on_cube & gripper_closed, 2, fsm)
        gfsm = self._gfsm_proximity(eef_pos, cube)

        obs_env = torch.repeat_interleave(torch.cat(
            [cube_pose, self.stack_base.expand(N, 3), agent_pose], -1), K,
            dim=0)
        obs_self = torch.cat([rel.reshape(B, 3), stack_rel.reshape(B, 3),
                              self._base_pose_rows], -1)
        fsm_f = fsm.reshape(B)
        obs_tail = torch.cat([
            torch.stack([fsm_f, fsm_f, gfsm.reshape(B)], -1).to(DTYPE),
            self._agent_idx_rows[:, None]], -1)
        obs = torch.cat([obs_env, obs_self, obs_tail], -1)

        mdf = md.reshape(B)
        ga = actions[:, 6]
        dxy = torch.linalg.vector_norm(stack_rel[..., :2], dim=-1).reshape(B)
        zero = torch.zeros((), dtype=DTYPE, device=ga.device)
        r = torch.zeros(B, dtype=DTYPE, device=ga.device)
        r = r + torch.where(fsm_f == 0, torch.exp(-5.0 * mdf ** 2), zero)
        r = r + torch.where(fsm_f == 1, torch.exp(-1.0 * ga), zero)
        r = r + torch.where(fsm_f == 2, torch.exp(-5.0 * dxy ** 2), zero)
        r = r + fsm_f.to(DTYPE)
        r = r + torch.where(gfsm.reshape(B) < 0, -1.0, zero)
        rew = torch.clamp(r, min=0.0)

        reset = (state.progress >= self.max_episode_length - 1).to(torch.int32)
        task = CollectTaskState(actions=actions, fsm=fsm)
        return obs, None, rew, reset, task, {}
