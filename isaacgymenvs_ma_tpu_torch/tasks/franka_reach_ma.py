"""FrankaReachMA (port of isaacgymenvs_ma_tpu/tasks/franka_reach_ma.py) —
the fork's flagship multi-agent task, obs 19 / act 6 per agent at 2 arms.

N envs x K Franka arms on a circle of radius 0.45 around a table, each
driven by OSC torques from 6-dof pose-delta actions (no gripper); T target
cubes dropped on the table.  All learner-facing rows are per agent
(``rl_games_batch`` = N * K, agent-minor).  What the step exercises in the
engine beyond Ant and BallBalance:

* the controller readouts (mass matrix, end-effector Jacobians) and OSC's
  two SPD inverses per control step (kernel B5 on the card),
* 24 ground rows plus 17 pair rows (16 cube corners against the table box,
  the two hand spheres against each other), compacted to the 24 deepest
  rows per env, the row set reused across the two substeps with impulse
  continuation,
* position-held gripper drives (kp 800 / kd 40).

Per-agent obs: all target positions (3T, shared) + own eef quat/pos + the
vector to the nearest target + the other agents' eef positions (3(K-1)).
Cooperative reward: inverse-square distance + an all-targets-covered bonus
- 10 for a hand collision (the hand's net contact force), clipped >= 0;
resets on timeout only.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..models.franka import FRANKA_DEFAULT_DOF_POS, build_franka
from ..models.model import (DRIVE_POS, FIXED, FREE, GEOM_BOX, ModelBuilder,
                            compose_scene)
from ..physics.controllers import osc_torques
from ..physics.engine import Control, PhysicsEngine, SimState, _cross
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "FrankaReachMA",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 8192,
        "numAgents": 2,
        "numTargets": -1,
        "envSpacing": 1.5,
        "episodeLength": 150,
        "enableDebugVis": False,
        "clipObservations": 5.0,
        "clipActions": 1.0,
        "startPositionNoise": 0.25,
        "startRotationNoise": 0.785,
        "frankaPositionNoise": 0.0,
        "frankaRotationNoise": 0.0,
        "frankaDofNoise": 0.25,
        "aggregateMode": 3,
        "actionScale": 1.0,
        "distRewardScale": 0.1,
        "liftRewardScale": 1.5,
        "alignRewardScale": 2.0,
        "stackRewardScale": 16.0,
        "controlType": "osc",
        "asset": {},
        "enableCameraSensors": False,
    },
    "sim": {
        "dt": 0.01667,
        "substeps": 2,
        "up_axis": "z",
        "use_gpu_pipeline": True,
        "gravity": [0.0, 0.0, -9.81],
        "physx": {
            "num_threads": 4, "solver_type": 1, "use_gpu": True,
            "num_position_iterations": 8, "num_velocity_iterations": 1,
            "contact_capacity": 24,  # 41 candidate rows across 2 arms + cubes
            "reuse_contact_rows": True,
            "contact_offset": 0.005, "rest_offset": 0.0,
            "bounce_threshold_velocity": 0.2, "max_depenetration_velocity": 1000.0,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 1048576, "contact_collection": 0,
        },
    },
    "task": {"randomize": False},
}

TABLE_POS = np.array([0.0, 0.0, 1.0])
TABLE_HALF = np.array([0.6, 0.6, 0.025])
TABLE_SURFACE_Z = 1.0 + 0.025
CUBE_SIZE = 0.050
CIRCLE_RADIUS = 0.45
FRANKA_BASE_Z = 1.0 + 0.025 + 0.1  # table surface + stand height (ref :331)


def franka_start_poses(num_agents: int, r: float = CIRCLE_RADIUS):
    """Positions/rotations on a circle (ref :912-918)."""
    rads = np.deg2rad(np.arange(0, 359, 360 // num_agents, dtype=np.float64))
    pos = np.stack([-np.cos(rads) * r, np.sin(rads) * r], axis=-1)
    quat = np.stack([np.zeros_like(rads), np.zeros_like(rads),
                     np.sin(-rads / 2), np.cos(-rads / 2)], axis=-1)
    return pos, quat


class FrankaMATaskState(NamedTuple):
    actions: torch.Tensor   # (B, 6) cached for the reward


class FrankaReachMA(VecTaskBase):

    NUM_ACTIONS = 6

    def _obs_dim(self, K, T):
        return (3 + 4 + 3) + 3 * T + 3 * (K - 1)

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        e = cfg["env"]
        self.num_agents_cfg = int(e.get("numAgents", 2))
        self.num_targets = int(e.get("numTargets", -1))
        if self.num_targets <= -1:
            self.num_targets = self.num_agents_cfg
        e["numObservations"] = self._obs_dim(self.num_agents_cfg,
                                             self.num_targets)
        e["numActions"] = self.NUM_ACTIONS
        self.action_scale = float(e["actionScale"])
        self.start_position_noise = float(e["startPositionNoise"])
        self.franka_dof_noise = float(e["frankaDofNoise"])
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)

        K = self.num_agents
        m = self.model
        dev = self.device
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=dev)
        idx = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.int64), device=dev)
        # per-arm static index sets
        self.arm_dofs = np.stack([                               # (K, 7)
            np.asarray(self._arm_dof_lists[k][:7]) for k in range(K)])
        self.gripper_dofs = np.stack([                           # (K, 2)
            np.asarray(self._arm_dof_lists[k][7:9]) for k in range(K)])
        self.hand_bodies = np.asarray(self._hand_bodies)                 # (K,)
        self.grip_bodies = np.asarray(self._grip_bodies)                 # (K,)
        self.cube_bodies = np.asarray(self._cube_bodies)                 # (T,)
        self.cube_q_adr = np.asarray(self._cube_q_adr)
        self.cube_v_adr = np.asarray(self._cube_v_adr)
        # the same as index tensors on the device
        self._arm_dofs_t = idx(self.arm_dofs)
        self._arm_qids_t = idx(self.engine.dof_qid[self.arm_dofs])
        self._gripper_dofs_t = idx(self.gripper_dofs.reshape(-1))
        self._grip_bodies_t = idx(self.grip_bodies)
        self._hand_bodies_t = idx(self.hand_bodies)
        self._reset_dofs = [idx(self._arm_dof_lists[k][:9]) for k in range(K)]
        self._reset_qids = [idx(self.engine.dof_qid[d[:9]])
                            for d in self._arm_dof_lists]

        self.franka_default_dof_pos = f32(FRANKA_DEFAULT_DOF_POS)
        self.kp = 150.0
        self.kp_null = 10.0
        self.cmd_limit = f32([0.1, 0.1, 0.1, 0.5, 0.5, 0.5])
        arm0 = self.arm_dofs[0]
        self.franka_effort_limit = f32(np.asarray(m.dof_effort_limit)[arm0])
        self.franka_dof_lower = f32(
            np.asarray(m.dof_lower)[self._arm_dof_lists[0][:9]])
        self.franka_dof_upper = f32(
            np.asarray(m.dof_upper)[self._arm_dof_lists[0][:9]])
        self.table_xy = f32(TABLE_POS[:2])

    # ------------------------------------------------------------------
    def create_model(self):
        K = self.num_agents_cfg
        T = self.num_targets
        parts = []
        # table (+ stand is cosmetic; folded into the table box)
        tb = ModelBuilder()
        tb.begin_actor()
        tbody = tb.add_body("table", -1, FIXED, body_pos=TABLE_POS)
        tb.add_geom(tbody, GEOM_BOX, TABLE_HALF, density=None, contact=True,
                    name="table_top")
        parts.append((tb.finalize(), (0, 0, 0), (0, 0, 0, 1)))

        franka = build_franka()
        pos, quat = franka_start_poses(K)
        for k in range(K):
            parts.append((franka, (pos[k, 0], pos[k, 1], FRANKA_BASE_Z),
                          quat[k]))

        cb = ModelBuilder()
        cb.begin_actor()
        cbody = cb.add_body("cubeA", -1, FREE,
                            body_pos=(0, 0, TABLE_SURFACE_Z + CUBE_SIZE))
        cb.add_geom(cbody, GEOM_BOX, np.full(3, CUBE_SIZE / 2),
                    density=1000.0, name="cubeA_geom")
        cube = cb.finalize()
        for t in range(T):
            parts.append((cube, (0.1 * t - 0.2, 0, TABLE_SURFACE_Z + 0.1),
                          (0, 0, 0, 1)))

        m = compose_scene(parts)
        self._index_model(m)
        # gripper drives: position-held (ref dof props: kp 800 / kd 40)
        for k in range(K):
            for d in self._arm_dof_lists[k][7:9]:
                m.dof_drive_mode[d] = DRIVE_POS
                m.dof_stiffness[d] = 800.0
                m.dof_drive_damping[d] = 40.0
        return m, True

    def _index_model(self, m):
        """Static index bookkeeping of a composed scene (the JAX
        subclasses' ``_index_model``, franka_collect_ma.py:81-99): the
        hands, grip sites and dofs of each arm, the cubes' bodies and their
        q / qd addresses.  A subclass that composes more actors into the
        scene re-indexes it with this."""
        names = m.body_names
        self._hand_bodies = [i for i, n in enumerate(names)
                             if n == "panda_hand"]
        self._grip_bodies = [i for i, n in enumerate(names)
                             if n == "panda_grip_site"]
        self._arm_dof_lists = []
        for root in (i for i, n in enumerate(names) if n == "panda_link0"):
            # dofs of this arm: all dofs whose body is in this franka subtree
            sub = [i for i in range(m.nb) if m.body_ancestor[root, i]]
            self._arm_dof_lists.append(
                [d for d in range(m.nv) if m.dof_body[d] in sub])
        self._cube_bodies = [i for i, n in enumerate(names) if n == "cubeA"]
        self._cube_q_adr = [int(m.q_adr[i]) for i in self._cube_bodies]
        self._cube_v_adr = [int(m.v_adr[i]) for i in self._cube_bodies]

    def build_engine(self, model, ground):
        # pair specs: each cube against the table top; the hand spheres of
        # every pair of arms
        table = [i for i, g in enumerate(model.geoms) if g.name == "table_top"]
        cubes = [i for i, g in enumerate(model.geoms)
                 if g.name == "cubeA_geom"]
        hands = [i for i, g in enumerate(model.geoms)
                 if g.name == "hand_sphere"]
        pairs = [(c, table[0]) for c in cubes]
        for a in range(len(hands)):
            for b in range(a + 1, len(hands)):
                pairs.append((hands[a], hands[b]))
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs, device=self.device)

    # ------------------------------------------------------------------
    def initial_task_state(self):
        return FrankaMATaskState(actions=torch.zeros(
            (self.rl_games_batch, 6), dtype=DTYPE, device=self.device))

    def pre_physics(self, state: EnvState, actions) -> Control:
        """OSC torques on the arm dofs (franka_reach_ma.py:235-274)."""
        N, K = self.num_envs, self.num_agents
        B = N * K
        sim = state.sim
        eng = self.engine
        M, body_x, body_q, S, V = eng.dynamics_readout(sim)
        ad = self._arm_dofs_t                                    # (K, 7)
        mm = M[:, ad[:, :, None], ad[:, None, :]].reshape(B, 7, 7)
        j_eef = torch.stack([
            eng.point_jacobian(S, body_x, int(self.grip_bodies[k]))[:, ad[k]]
            for k in range(K)], dim=1).reshape(B, 7, 6).transpose(1, 2)
        # eef velocity [lin at the grip site, ang]
        w = V[..., 0:3]
        v_lin = V[..., 3:6] + _cross(w, body_x)
        eef_vel = torch.cat([v_lin, w], -1)[:, self._grip_bodies_t].reshape(
            B, 6)
        q_arm = sim.q[:, self._arm_qids_t].reshape(B, 7)
        qd_arm = sim.qd[:, ad].reshape(B, 7)

        dpose = actions[:, :6] * self.cmd_limit / self.action_scale
        u = osc_torques(mm, j_eef, eef_vel, q_arm, qd_arm, dpose,
                        self.franka_default_dof_pos[:7], kp=self.kp,
                        kp_null=self.kp_null,
                        effort_limit=self.franka_effort_limit)

        nv = eng.nv
        tau = torch.zeros((N, nv), dtype=DTYPE, device=self.device)
        tau[:, ad.reshape(-1)] = u.reshape(N, K * 7)
        # grippers position-held at default
        pos_target = torch.zeros((N, nv), dtype=DTYPE, device=self.device)
        # index_fill_: a scalar put through an index tensor waits for the
        # card
        pos_target.index_fill_(1, self._gripper_dofs_t, 0.035)
        return Control(tau=tau, pos_target=pos_target,
                       vel_target=torch.zeros((N, nv), dtype=DTYPE,
                                              device=self.device))

    # ------------------------------------------------------------------
    def draw_reset(self):
        """Reset draws from the task generator, uniform on [0, 1) in the JAX
        key order (franka_reach_ma.py:279-298): arm dof noise (N, K, 9),
        cube xy (N, T, 2), cube height (N, T)."""
        N, K, T = self.num_envs, self.num_agents, self.num_targets
        g = self.generator
        u = lambda *shape: torch.rand(  # noqa: E731
            shape, generator=g, device=g.device, dtype=DTYPE)
        return u(N, K, 9), u(N, T, 2), u(N, T)

    def reset_idx(self, sim: SimState, task: FrankaMATaskState, mask,
                  draws=None):
        N, K, T = self.num_envs, self.num_agents, self.num_targets
        noise, xy_u, z_u = self.draw_reset() if draws is None else draws
        # franka dofs: default + noise, grippers exact (ref :633-642)
        pos = torch.clamp(
            self.franka_default_dof_pos
            + self.franka_dof_noise * 2.0 * (noise - 0.5),
            self.franka_dof_lower, self.franka_dof_upper)
        pos[:, :, 7:] = self.franka_default_dof_pos[7:]
        q, qd = sim.q.clone(), sim.qd.clone()
        zeros9 = torch.zeros((N, 9), dtype=DTYPE, device=self.device)
        for k in range(K):
            dofs, qids = self._reset_dofs[k], self._reset_qids[k]
            q[:, qids] = masked_update(mask, pos[:, k], q[:, qids])
            qd[:, dofs] = masked_update(mask, zeros9, qd[:, dofs])
        # cubes: random xy around the table centre, z = surface + half +
        # U(0, 0.5)
        xy = self.table_xy + 2.0 * self.start_position_noise * (xy_u - 0.5)
        z = TABLE_SURFACE_Z + CUBE_SIZE / 2 + 0.5 * z_u
        kw = dict(dtype=DTYPE, device=self.device)
        for t in range(T):
            qa, va = int(self.cube_q_adr[t]), int(self.cube_v_adr[t])
            cq = torch.cat([xy[:, t], z[:, t: t + 1],
                            torch.zeros((N, 3), **kw),
                            torch.ones((N, 1), **kw)], -1)
            q[:, qa: qa + 7] = masked_update(mask, cq, q[:, qa: qa + 7])
            qd[:, va: va + 6] = masked_update(
                mask, torch.zeros((N, 6), **kw), qd[:, va: va + 6])
        task = task._replace(actions=masked_update(
            torch.repeat_interleave(mask, K, dim=0),
            torch.zeros_like(task.actions), task.actions))
        return SimState(q, qd), task

    # ------------------------------------------------------------------
    def post_physics(self, state: EnvState, out, actions):
        N, K, T = self.num_envs, self.num_agents, self.num_targets
        B = N * K
        gb = self._grip_bodies_t
        eef_pos, eef_quat = out.body_pos[:, gb], out.body_quat[:, gb]
        cube_pos = torch.stack([
            state.sim.q[:, int(qa): int(qa) + 3] for qa in self.cube_q_adr],
            dim=1)                                               # (N, T, 3)

        rel = cube_pos[:, None, :, :] - eef_pos[:, :, None, :]   # (N, K, T, 3)
        dist = torch.linalg.vector_norm(rel, dim=-1)             # (N, K, T)
        nearest = torch.argmin(dist, dim=-1)                     # (N, K)
        min_rel = torch.gather(
            rel, 2, nearest[..., None, None].expand(N, K, 1, 3))[:, :, 0]

        obs_all_targets = torch.repeat_interleave(
            cube_pos.reshape(N, T * 3), K, dim=0)                # (B, 3T)
        obs_self = torch.cat([eef_quat.reshape(B, 4), eef_pos.reshape(B, 3),
                              min_rel.reshape(B, 3)], dim=-1)
        flat = eef_pos.reshape(N, K * 3)
        others = torch.stack([torch.roll(flat, -3 * k, dims=-1)
                              for k in range(K)], dim=1)[..., 3:]
        obs = torch.cat([obs_all_targets, obs_self,
                         others.reshape(B, 3 * (K - 1))], dim=-1)

        # reward (ref :928-960)
        d = torch.linalg.vector_norm(min_rel.reshape(B, 3), dim=-1)
        dist_reward = 1.0 / (0.5 + d * d)
        actions_cost = torch.sum(torch.square(actions), dim=-1) * 0.01
        covered = torch.nn.functional.one_hot(nearest, T).amax(dim=1).to(
            DTYPE)                                               # (N, T)
        all_touched = torch.repeat_interleave(covered.sum(-1) / K, K, dim=0)
        hands_cf = out.contact_force[:, self._hand_bodies_t]     # (N, K, 3)
        colliding = (torch.linalg.vector_norm(hands_cf, dim=-1)
                     >= 0.1).reshape(B)
        rew = dist_reward - actions_cost + all_touched + colliding * -10.0
        rew = torch.clamp(rew, min=0.0)

        reset = (state.progress >= self.max_episode_length - 1).to(torch.int32)
        task = FrankaMATaskState(actions=actions)
        extras = {"episode": {"coverage": covered.sum(-1) / T,
                              "eef_target_dist": d}}
        return obs, None, rew, reset, task, extras
