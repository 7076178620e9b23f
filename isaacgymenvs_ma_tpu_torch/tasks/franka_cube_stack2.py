"""FrankaCubeStack2 (port of isaacgymenvs_ma_tpu/tasks/
franka_cube_stack2.py) — the fork's cube stacking with a 7-stage FSM, obs
21 / act 7 at 8192 envs, on FrankaCubeStack's scene.

What differs from FrankaCubeStack: obs [eef_quat, eef_pos,
cubeA_pos_relative, cubeA_height, cubeA_quat, cubeA_to_cubeB_pos,
q_gripper, 2^FSM]; the FSM (0 approach -> 1 on cube A -> 2 gripper closed
-> 3 lifted -> 4 aligned over cube B -> 5 super close -> 6 released)
stages the shaped reward, plus the FSM index as progress reward and a +10
bonus in stage 6, clipped at 0; resets on timeout only; the OSC command
limit is 0.55 on all axes, and cube A spawns up to ``cubeSpawnZRange``
(0.5 m) higher.
"""
from __future__ import annotations

import torch

from ..device import DTYPE
from ..utils.config import deep_merge
from .base import EnvState
from .franka_cube_stack import (CUBE_A, CUBE_B, CubeStackTaskState,
                                FrankaCubeStack, TASK_CFG as STACK_CFG)
from .franka_reach_ma import TABLE_SURFACE_Z

TASK_CFG = deep_merge(STACK_CFG, {
    "name": "FrankaCubeStack2",
    "env": {"cubeSpawnZRange": 0.5, "oscCmdLimit": 0.55},
})


class FrankaCubeStack2(FrankaCubeStack):
    def _obs_dim(self, K, T):
        return 21

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)
        lim = float(cfg["env"].get("oscCmdLimit", 0.55))
        self.cmd_limit = torch.full((6,), lim, dtype=DTYPE,
                                    device=self.device)
        self.spawn_z_range = float(cfg["env"].get("cubeSpawnZRange", 0.5))

    @staticmethod
    def _fsm(d, cube_a_height, a_to_b, actions):
        """The 7-state stacking FSM (ref FSM :276-292)."""
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)  # noqa: E731
        on_a = d <= (CUBE_A / 2) * 0.9
        closed = actions[:, -1] < 0
        lifted = cube_a_height >= (CUBE_B + CUBE_A * 0.5)
        aligned = norm(a_to_b[:, :2]) <= CUBE_A * 0.5
        super_close = norm(a_to_b) < (CUBE_A * 0.7071 + CUBE_B * 0.5)
        fsm = torch.zeros(d.shape, dtype=torch.int32, device=d.device)
        fsm = torch.where(on_a, 1, fsm)
        fsm = torch.where(on_a & closed, 2, fsm)
        fsm = torch.where(on_a & closed & lifted, 3, fsm)
        fsm = torch.where(aligned, 4, fsm)
        fsm = torch.where(aligned & super_close, 5, fsm)
        fsm = torch.where(aligned & super_close & ~closed, 6, fsm)
        return fsm

    def draw_reset(self):
        """FrankaCubeStack's reset draws, then cube A's spawn lift, U[0, 1)
        (N,) (the JAX key fold_in(key, 77))."""
        g = self.generator
        return (*super().draw_reset(),
                torch.rand((self.num_envs,), generator=g, device=g.device,
                           dtype=DTYPE))

    def reset_idx(self, sim, task, mask, draws=None):
        draws = self.draw_reset() if draws is None else draws
        sim, task = super().reset_idx(sim, task, mask, draws[:3])
        # cube A lifted by U(0, cubeSpawnZRange) (ref :396-398)
        qa = int(self.cube_q_adr[0]) + 2
        q = sim.q.clone()
        q[:, qa] = torch.where(mask, q[:, qa] + self.spawn_z_range * draws[3],
                               q[:, qa])
        return sim._replace(q=q), task

    def post_physics(self, state: EnvState, out, actions):
        eef_pos, eef_quat, cube_a, cube_a_quat, cube_b = self._cube_states(
            state, out)
        cube_a_rel = cube_a - eef_pos
        a_to_b = cube_b - cube_a
        cube_a_height = cube_a[:, 2] - TABLE_SURFACE_Z
        gripper_q = state.sim.q[:, self._gripper0_qids_t]
        d = torch.linalg.vector_norm(cube_a_rel, dim=-1)
        fsm = self._fsm(d, cube_a_height, a_to_b, actions)
        fsm_f = fsm.to(DTYPE)
        obs = torch.cat([eef_quat, eef_pos, cube_a_rel, cube_a_height[:, None],
                         cube_a_quat, a_to_b, gripper_q,
                         torch.pow(2.0, fsm_f)[:, None]], -1)

        # staged reward (ref compute_franka_reward :482-530)
        a_grip = actions[:, -1]
        zero = torch.zeros_like(d)
        dist_reward = 1.0 / (0.5 + d ** 2) * 0.5
        rew = torch.where(fsm == 0, dist_reward, zero)
        close_reward = torch.clamp(torch.tanh(-a_grip * 3.0), min=0.0)
        rew = rew + torch.where(fsm == 1, (dist_reward + close_reward) / 2,
                                zero)
        h_reward = torch.clamp(cube_a_height / 0.095, max=1.0)
        rew = rew + torch.where(fsm == 2, h_reward, zero)
        target_dist = torch.linalg.vector_norm(a_to_b + self._stack_offset,
                                               dim=-1)
        rew = rew + torch.where(fsm == 3, torch.tanh(5.0 * -target_dist)
                                + 1.0, zero)
        rew = rew + torch.where(fsm == 4, torch.tanh(6.0 * -target_dist)
                                + 1.0, zero)
        rew = rew + torch.where(fsm == 5, torch.tanh(a_grip * 7.0) + 1.0,
                                zero)
        rew = rew + torch.where(fsm == 6, torch.tanh(7.0 * d) + 10.0, zero)
        rew = torch.clamp(rew + fsm_f, min=0.0)        # + progress term

        reset = (state.progress >= self.max_episode_length - 1).to(
            torch.int32)
        extras = {"mean_cube_height": cube_a_height.mean(),
                  "target_dist": target_dist.mean(),
                  "fsm_mean": fsm_f.mean()}
        return obs, None, rew, reset, CubeStackTaskState(
            actions=actions), extras
