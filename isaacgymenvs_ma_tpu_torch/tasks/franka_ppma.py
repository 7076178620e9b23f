"""FrankaPPMA (port of isaacgymenvs_ma_tpu/tasks/franka_ppma.py) —
multi-agent pick-and-place, obs 50 / act 7 per agent at 2 arms, 2 cubes.

FrankaReachMA's scene (no wall) plus a destination pad per cube (5 cm
fixed boxes at y = 0.4).  Agent k owns cube k (not the nearest) and must
place it on pad k: a per-agent 7-state FSM (approach -> hold -> lift ->
align -> super-close -> release -> GOAL) driven by the cube-to-pad vector,
and a proximity global FSM that is -1 where the agents crowd each other or
each other's cube (written for two agents and two cubes, as in the JAX
package).  Obs: all cube poses (7T), all pad positions (3T), all agents'
eef poses (7K), the agent's cube and pad vectors and base pose, [FSM, FSM],
gFSM.  An agent whose gripper action closes within 2.25 cm of its own
cube pins that cube (grab k * T + k).  Contact rows: the cubes' corners
against the ground, the table top and every pad, the hand spheres against
each other.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DTYPE
from ..models.model import FIXED, GEOM_BOX, ModelBuilder, compose_scene
from ..physics.engine import Control, PhysicsEngine
from ..utils.config import deep_merge
from .base import EnvState
from .franka_collect_ma import GRAB_DIST, CollectTaskState, FrankaCollectMA
from .franka_reach_ma import (CUBE_SIZE, TABLE_SURFACE_Z, FrankaReachMA,
                              TASK_CFG as REACH_CFG)

TASK_CFG = deep_merge(REACH_CFG, {
    "name": "FrankaPPMA",
    "env": {"episodeLength": 300},
})

DEST_SIZE = 0.05


class FrankaPPMA(FrankaCollectMA):
    """Destination pads replace the wall; per-agent cube assignment."""

    def _obs_dim(self, K, T):
        return 7 * T + 3 * T + 7 * K + (3 + 3 + 7) + 2 + 1

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)
        N, K, T = self.num_envs, self.num_agents, self.num_targets
        self._base_pose_rows = torch.cat(
            [self.base_pos, self.base_quat], -1).repeat(N, 1)   # (B, 7)
        # grab k * T + k of agent k on its own cube k (k < min(K, T))
        own = np.zeros((K, T), np.float32)
        for k in range(min(K, T)):
            own[k, k] = 1.0
        self._own_grab = torch.as_tensor(own, device=self.device)
        qa = self.cube_q_adr.astype(np.int64)[:, None]
        self._cube_quat_qids_t = torch.as_tensor(qa + 3 + np.arange(4),
                                                 device=self.device)

    def _dest_positions(self, T):
        xs = np.linspace(-0.2, 0.2, T) if T > 1 else np.array([0.0])
        return np.stack([
            xs, np.full(T, 0.4),
            np.full(T, TABLE_SURFACE_Z + DEST_SIZE / 2)], -1)

    def create_model(self):
        # FrankaReachMA's scene, not FrankaCollectMA's (no wall)
        model, ground = FrankaReachMA.create_model(self)
        T = self.num_targets
        dests = self._dest_positions(T)
        db = ModelBuilder()
        db.begin_actor()
        for t in range(T):
            body = db.add_body(f"dest{t}", -1, FIXED, body_pos=dests[t])
            db.add_geom(body, GEOM_BOX, (DEST_SIZE / 2,) * 3, density=None,
                        contact=True, name="dest_geom")
        model = compose_scene([
            (model, (0, 0, 0), (0, 0, 0, 1)),
            (db.finalize(), (0, 0, 0), (0, 0, 0, 1))])
        self._index_model(model)
        self.dest_pos = torch.as_tensor(dests.astype(np.float32),
                                        device=self.device)      # (T, 3)
        return model, ground

    def build_engine(self, model, ground):
        geoms = lambda name: [i for i, g in enumerate(model.geoms)  # noqa: E731
                              if g.name == name]
        table, dests = geoms("table_top"), geoms("dest_geom")
        cubes, hands = geoms("cubeA_geom"), geoms("hand_sphere")
        pairs = [(c, table[0]) for c in cubes]
        pairs += [(c, d) for c in cubes for d in dests]
        for a in range(len(hands)):
            for b in range(a + 1, len(hands)):
                pairs.append((hands[a], hands[b]))
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs, grabs=self._grab_specs(),
                             device=self.device)

    # ------------------------------------------------------------------
    def _assigned(self, eef_pos, cube):
        """Agent k's own cube k (N, K, 3) and the vector to it."""
        own = cube[:, :self.num_agents]
        return own, own - eef_pos

    def _fsm_pp(self, md, gripper_closed, dest_rel):
        """The pick-and-place FSM (franka_ppma.py:87-99) per agent."""
        fsm = torch.zeros(md.shape, dtype=torch.int32, device=md.device)
        on_cube = md <= GRAB_DIST
        fsm = torch.where(on_cube, 1, fsm)
        fsm = torch.where(on_cube & gripper_closed, 2, fsm)
        lifted = torch.abs(dest_rel[..., 2]) >= (DEST_SIZE + CUBE_SIZE) / 2
        fsm = torch.where(on_cube & lifted, 3, fsm)
        aligned = torch.linalg.vector_norm(dest_rel[..., :2], dim=-1) < 0.025
        fsm = torch.where(aligned, 4, fsm)
        stackable = torch.abs(dest_rel[..., 2]) <= (CUBE_SIZE * 0.866
                                                    + DEST_SIZE / 2)
        fsm = torch.where(aligned & stackable, 5, fsm)
        fsm = torch.where(aligned & stackable & ~gripper_closed, 6, fsm)
        return fsm

    def _gfsm_proximity(self, eef_pos, cube):
        """-1 per agent row where the two agents' grip sites are within
        0.18 of each other, or an agent's within 0.18 of the other's cube
        (franka_ppma.py:101-110; two agents and two cubes)."""
        d_ep = torch.linalg.vector_norm(eef_pos[:, 1] - eef_pos[:, 0], dim=-1)
        too_close_e = torch.repeat_interleave(d_ep <= 0.18, self.num_agents,
                                              dim=0)
        d01 = torch.linalg.vector_norm(eef_pos[:, 0] - cube[:, 1], dim=-1)
        d10 = torch.linalg.vector_norm(eef_pos[:, 1] - cube[:, 0], dim=-1)
        too_close_c = torch.stack([d01, d10], -1).reshape(-1) <= 0.18
        return torch.where(too_close_e | too_close_c, -1, 0).to(torch.int32)

    def pre_physics(self, state: EnvState, actions) -> Control:
        """OSC, the gripper targets, and agent k's grab of its own cube k
        from the state before the step (franka_ppma.py:112-133)."""
        N, K = self.num_envs, self.num_agents
        ctrl = FrankaReachMA.pre_physics(self, state, actions)
        pos_target = self._gripper_targets(ctrl, actions)
        body_x = self.engine.kinematics(state.sim.q)[0]
        eef = body_x[:, self._grip_bodies_t]
        _, rel = self._assigned(eef, self._cube_positions(state.sim))
        md = torch.linalg.vector_norm(rel, dim=-1)
        holding = (md <= GRAB_DIST) & (actions[:, 6].reshape(N, K) < 0.0)
        grab = holding.to(DTYPE)[:, :, None] * self._own_grab
        return ctrl._replace(pos_target=pos_target,
                             grab_active=grab.reshape(N, -1))

    def _obs_env(self, state: EnvState, out):
        """The grip-site poses (N, K, 3 / 4), the cubes (N, T, 3) and the
        per-env obs head [all cube poses (7T), all eef poses (7K)]."""
        N = self.num_envs
        gb = self._grip_bodies_t
        eef_pos, eef_quat = out.body_pos[:, gb], out.body_quat[:, gb]
        cube = self._cube_positions(state.sim)
        cube_quat = state.sim.q[:, self._cube_quat_qids_t]      # (N, T, 4)
        cube_pose = torch.cat([cube, cube_quat], -1).reshape(N, -1)
        agent_pose = torch.cat([eef_pos, eef_quat], -1).reshape(N, -1)
        return eef_pos, cube, cube_pose, agent_pose

    def post_physics(self, state: EnvState, out, actions):
        N, K, T = self.num_envs, self.num_agents, self.num_targets
        B = N * K
        eef_pos, cube, cube_pose, agent_pose = self._obs_env(state, out)
        own, rel = self._assigned(eef_pos, cube)
        md = torch.linalg.vector_norm(rel, dim=-1)
        dest_rel = self.dest_pos[None, :K] - own
        gripper_closed = actions[:, 6].reshape(N, K) < 0.0
        fsm = self._fsm_pp(md, gripper_closed, dest_rel)
        gfsm = self._gfsm_proximity(eef_pos, cube)

        all_dest = self.dest_pos[:T].reshape(1, -1).expand(N, 3 * T)
        obs_env = torch.repeat_interleave(
            torch.cat([cube_pose, all_dest, agent_pose], -1), K, dim=0)
        obs_self = torch.cat([rel.reshape(B, 3), dest_rel.reshape(B, 3),
                              self._base_pose_rows], -1)
        fsm_f = fsm.reshape(B)
        obs_fsm = torch.stack([fsm_f, fsm_f, gfsm.reshape(B)], -1).to(DTYPE)
        obs = torch.cat([obs_env, obs_self, obs_fsm], -1)

        # staged reward toward the destination, crowding punished
        mdf = md.reshape(B)
        ga = actions[:, 6]
        dz = torch.abs(dest_rel[..., 2]).reshape(B)
        dxy = torch.linalg.vector_norm(dest_rel[..., :2], dim=-1).reshape(B)
        zero = torch.zeros((), dtype=DTYPE, device=ga.device)
        r = torch.zeros(B, dtype=DTYPE, device=ga.device)
        r = r + torch.where(fsm_f == 0, torch.exp(-5.0 * mdf ** 2), zero)
        r = r + torch.where(fsm_f == 1, torch.exp(-1.0 * ga), zero)
        r = r + torch.where(fsm_f == 2, torch.exp(-5.0 * dxy ** 2), zero)
        r = r + torch.where(fsm_f == 3, torch.exp(-5.0 * dxy ** 2), zero)
        r = r + torch.where(fsm_f == 4, torch.exp(-5.0 * dz ** 2), zero)
        r = r + torch.where(fsm_f == 5, torch.exp(4.0 * ga), zero)
        r = r + torch.where(fsm_f == 6, 3.0, zero)
        r = r + fsm_f.to(DTYPE)                                 # BSR
        r = r + torch.where(gfsm.reshape(B) < 0, -1.0, zero)    # crowding
        rew = torch.clamp(r, min=0.0)

        reset = (state.progress >= self.max_episode_length - 1).to(torch.int32)
        task = CollectTaskState(actions=actions, fsm=fsm)
        return obs, None, rew, reset, task, {}
