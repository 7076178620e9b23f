"""IndustReal: IndustRealTaskPegsInsert and IndustRealTaskGearsInsert
(port of isaacgymenvs_ma_tpu/tasks/industreal.py, reference
tasks/industreal/) with the three IndustReal algorithms
(industreal_algo_utils.py):

* SAPU (:49-200), interpenetration-aware reward scaling: the plug's
  sampled surface points against the socket-material grid; envs whose
  deepest penetration is at most ``interpen_thresh`` scale their reward by
  ``1 - tanh(d / thresh)``, the others keep their previous reward.
* The SDF dense reward (:202-283): ``-log`` of the mean distance of the
  plug's points to the plug-at-goal grid, times ``sdf_reward_scale``.
* SBC, the sampling-based curriculum (:284-334): the largest initial
  downward displacement adapts to the insertion success rate within
  ``curriculum_height_bound``, and the last step's reward is shrunk or
  grown by the curriculum stage.

Both grids are baked by the port's voxelizer (``sdf_grid.from_mesh``) on
the task's device (``env.use_mesh_sdf``, on by default; else the analytic
primitive SDFs).  Scene: the Factory Franka holding the plug with a grab
constraint (the closed gripper), the socket's baked grid on the table
(finger pads against the plug and the table, the plug's rim cloud against
the socket, the shaft at GearsInsert, and the table).  Actions are 6-dim
pose deltas under task-space impedance control; obs 24.

Draws: ``reset_draws`` the Factory fingertip target's two (N, 3) U(-1, 1)
then the plug's xy (N, 2) U(-1, 1) and displacement fraction (N,)
U(0, 1); ``step_draws`` the goal's observation noise (N, 3) N(0, 1)
(JAX ``fold_in(state.rng, 29)``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE, resolve_device
from ..models import meshes
from ..models.model import FIXED, FREE, GEOM_BOX, GEOM_CYLINDER, ModelBuilder
from ..ops import maths
from ..physics import sdf_grid
from ..physics.engine import Control, PhysicsEngine
from .base import EnvState
from .factory import TABLE_HEIGHT, FactoryBase, _base_cfg

# 8 mm round peg / socket (factory_asset_info_insertion.yaml round_peg_8mm)
PLUG_RADIUS = 0.004
PLUG_LENGTH = 0.050
SOCKET_HALF = np.array([0.0145, 0.0145, 0.0125])   # socket block half-extents
SOCKET_HOLE_R = 0.0042
SOCKET_BASE_HEIGHT = 0.003
SOCKET_POS = np.array([0.0, 0.0, TABLE_HEIGHT], np.float32)

# gear / shaft (factory_asset_info_gears.yaml)
GEAR_RADIUS = 0.04
GEAR_HEIGHT = 0.020
SHAFT_RADIUS = 0.003
SHAFT_HEIGHT = 0.050
GEAR_HOLE_R = 0.0032


def _cfg_insert(name):
    cfg = _base_cfg(name, 24, 6, 256)
    cfg["rl"].update({
        "interpen_thresh": 0.001,
        "sdf_reward_scale": 10.0,
        "initial_max_disp": 0.01,
        "curriculum_success_thresh": 0.75,
        "curriculum_failure_thresh": 0.5,
        "curriculum_height_step": [-0.005, 0.003],
        "curriculum_height_bound": [-0.01, 0.01],
        "close_error_thresh": 0.15,
        "success_height_thresh": 0.003,
        "engagement_bonus": 10.0,
        "max_episode_length": 256,
    })
    cfg["env"]["socket_base_height"] = SOCKET_BASE_HEIGHT
    cfg["env"]["numObservations"] = 24
    cfg["env"]["numActions"] = 6
    # task-space impedance control; the gripper gains from ``all``
    cfg["ctrl"]["ctrl_type"] = "task_space_impedance"
    cfg["ctrl"]["all"] = {"jacobian_type": "geometric",
                          "gripper_prop_gains": [500.0, 500.0],
                          "gripper_deriv_gains": [2.0, 2.0]}
    cfg["ctrl"]["task_space_impedance"] = {
        "motion_ctrl_axes": [1, 1, 1, 1, 1, 1],
        "task_prop_gains": [300.0, 300.0, 300.0, 50.0, 50.0, 50.0],
        "task_deriv_gains": [34.0, 34.0, 34.0, 1.4, 1.4, 1.4]}
    return cfg


# -- the analytic SDFs (use_mesh_sdf False) ---------------------------------
def sdf_cylinder(p, radius, half_h):
    """Signed distance to a z-axis cylinder at the origin (negative
    inside)."""
    d_r = torch.linalg.vector_norm(p[..., 0:2], dim=-1) - radius
    d_z = torch.abs(p[..., 2]) - half_h
    outside = torch.sqrt(torch.clamp(d_r, min=0.0) ** 2
                         + torch.clamp(d_z, min=0.0) ** 2)
    inside = torch.clamp(torch.maximum(d_r, d_z), max=0.0)
    return outside + inside


def sdf_box(p, half):
    q = torch.abs(p) - torch.as_tensor(half, dtype=p.dtype, device=p.device)
    outside = torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    return outside + inside


def sdf_socket_material(p):
    """The socket block minus the hole: the solid the plug must not
    penetrate."""
    centered = p - torch.as_tensor([0.0, 0.0, SOCKET_HALF[2]],
                                   dtype=p.dtype, device=p.device)
    box = sdf_box(centered, SOCKET_HALF)
    hole = sdf_cylinder(centered, SOCKET_HOLE_R, SOCKET_HALF[2] + 1e-3)
    return torch.maximum(box, -hole)


def _plug_sample_points(n_side=6, n_ring=8):
    """Static surface samples on the peg."""
    zs = np.linspace(-PLUG_LENGTH / 2, PLUG_LENGTH / 2, n_side)
    th = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    pts = [[PLUG_RADIUS * np.cos(t), PLUG_RADIUS * np.sin(t), z]
           for z in zs for t in th]
    pts += [[0, 0, -PLUG_LENGTH / 2], [0, 0, PLUG_LENGTH / 2]]
    return np.asarray(pts, np.float32)


class IndustRealTaskState(NamedTuple):
    actions: torch.Tensor
    prev_rew: torch.Tensor         # (N,) SAPU's kept reward
    curr_max_disp: torch.Tensor    # () the SBC stage
    insert_success: torch.Tensor   # (N,)
    ep_success_rate: torch.Tensor  # () the last episode end's success rate


class IndustRealTaskPegsInsert(FactoryBase):
    """Peg into socket with SAPU, the SDF reward and SBC
    (industreal_task_pegs_insert.py)."""

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        dev = resolve_device(device)
        self._samples_np = self._sample_points()
        self.use_mesh_sdf = bool(cfg.get("env", {}).get("use_mesh_sdf", True))
        if self.use_mesh_sdf:
            sv, stt = self._material_solid_mesh()
            self._socket_grid = sdf_grid.from_mesh(sv, stt, resolution=56,
                                                   device=dev)
            pv, ptt = self._goal_solid_mesh()
            self._goal_grid = sdf_grid.from_mesh(pv, ptt, resolution=48,
                                                 device=dev)
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)
        t = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=self.device)
        self._samples = t(self._samples_np)
        self._socket_pos = t(SOCKET_POS)
        self._base_pos = t([0.5, 0.0, 0.0])
        self._base_quat = t([0.0, 0.0, 1.0, 0.0])
        self.plug_body = self.nut_body
        rl = self.cfg_rl
        self.interpen_thresh = float(rl["interpen_thresh"])
        self.sdf_scale = float(rl["sdf_reward_scale"])
        self.close_thresh = float(rl["close_error_thresh"])
        self.success_h = float(rl["success_height_thresh"])
        self.engagement_bonus = float(rl["engagement_bonus"])
        self.h_bound = tuple(rl["curriculum_height_bound"])
        self.h_step = tuple(rl["curriculum_height_step"])
        self.succ_thresh = float(rl["curriculum_success_thresh"])
        self.fail_thresh = float(rl["curriculum_failure_thresh"])

    # -- scene ------------------------------------------------------------
    def _extra_parts(self):
        ob = ModelBuilder()
        ob.begin_actor()
        plug = ob.add_body(
            "nut", -1, FREE,
            body_pos=(0.0, 0.0,
                      TABLE_HEIGHT + SOCKET_HALF[2] * 2 + PLUG_LENGTH / 2))
        if self.use_mesh_sdf:
            # the round peg's mesh: a pad target, rim rings as its points
            pv, pt = meshes.cylinder_mesh(PLUG_RADIUS, PLUG_LENGTH / 2, n=24)
            cp = meshes.cylinder_contact_points(PLUG_RADIUS, PLUG_LENGTH / 2,
                                                n_ring=8, n_rows=3)
            ob.add_sdf_geom(plug, pv, pt, density=7850.0, friction=0.5,
                            resolution=40, contact_points=cp, name="nut_geom")
        else:
            ob.add_geom(plug, GEOM_BOX,
                        np.array([PLUG_RADIUS, PLUG_RADIUS, PLUG_LENGTH / 2]),
                        density=7850.0, friction=0.5, name="nut_geom")
        sb = ModelBuilder()
        sb.begin_actor()
        sock = sb.add_body("socket", -1, FIXED, body_pos=SOCKET_POS)
        h = SOCKET_HALF
        if self.use_mesh_sdf:
            # the socket solid (block minus bore) as one grid target
            sv, stt = meshes.box_with_hole_mesh(h[:2], h[2], SOCKET_HOLE_R,
                                                n=64)
            sb.add_sdf_geom(sock, sv, stt, pos=np.array([0.0, 0.0, h[2]]),
                            friction=0.3, resolution=72, name="socket_sdf")
        else:
            rim = (h[0] - SOCKET_HOLE_R) / 2
            off = SOCKET_HOLE_R + rim
            # a 4-box rim around the hole
            for i, (dx, dy, hx, hy) in enumerate((
                    (off, 0, rim, h[1]), (-off, 0, rim, h[1]),
                    (0, off, SOCKET_HOLE_R, rim),
                    (0, -off, SOCKET_HOLE_R, rim))):
                sb.add_geom(sock, GEOM_BOX, np.array([hx, hy, h[2]]),
                            pos=np.array([dx, dy, h[2]]), friction=0.3,
                            name=f"socket_rim{i}")
        return [(ob.finalize(), (0, 0, 0), (0, 0, 0, 1)),
                (sb.finalize(), (0, 0, 0), (0, 0, 0, 1))]

    def build_engine(self, model, ground):
        names = [g.name for g in model.geoms]
        nut_geom = names.index("nut_geom")
        pairs = [(names.index(pn), nut_geom) for pn in names
                 if pn.startswith("pad_")]
        # the fingers collide with the table top (they close a SAPU
        # reward-freeze exploit: a hand through the table drags the held
        # plug deep into the socket)
        table = names.index("table_top")
        pairs += [(names.index(pn), table) for pn in names
                  if pn.startswith("pad_")]
        if "socket_sdf" in names:
            pairs.append((nut_geom, names.index("socket_sdf")))
        else:
            pairs += [(nut_geom, names.index(f"socket_rim{i}"))
                      for i in range(4)]
        if "shaft_geom" in names and self.use_mesh_sdf:
            # the gear's bore rim rides the shaft (an analytic cylinder)
            pairs.append((nut_geom, names.index("shaft_geom")))
        pairs.append((nut_geom, names.index("table_top")))
        # the rigid grasp: the grip site holds the plug's top
        grabs = [(model.body_names.index("panda_grip_site"), (0.0, 0.0, 0.0),
                  model.body_names.index("nut"),
                  (0.0, 0.0, PLUG_LENGTH / 2))]
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs, grabs=grabs,
                             device=self.device)

    def initial_task_state(self):
        n = self.num_envs
        kw = dict(dtype=DTYPE, device=self.device)
        return IndustRealTaskState(
            actions=torch.zeros((n, self.num_actions), **kw),
            prev_rew=torch.zeros(n, **kw),
            curr_max_disp=torch.tensor(self.cfg_rl["initial_max_disp"], **kw),
            insert_success=torch.zeros(n, **kw),
            ep_success_rate=torch.zeros((), **kw))

    # -- geometry ---------------------------------------------------------
    def _goal_pos(self):
        """The assembled plug's centre (its bottom at the socket base)."""
        return self._socket_pos + self._c(
            [0.0, 0.0, SOCKET_BASE_HEIGHT + PLUG_LENGTH / 2])

    def _plug_points_world(self, pos, quat):
        return pos[:, None, :] + maths.quat_apply(quat[:, None, :],
                                                  self._samples)

    def _sample_points(self):
        return _plug_sample_points()

    def _material_solid_mesh(self):
        """The solid the held part must not penetrate, in the ``pts -
        socket_frame`` query frame."""
        sv, stt = meshes.box_with_hole_mesh(
            SOCKET_HALF[:2], SOCKET_HALF[2], SOCKET_HOLE_R, n=64)
        return sv + np.asarray([0.0, 0.0, SOCKET_HALF[2]], np.float32), stt

    def _goal_solid_mesh(self):
        """The assembled plug (the goal-isosurface grid)."""
        return meshes.cylinder_mesh(PLUG_RADIUS, PLUG_LENGTH / 2, n=48)

    def _sapu_interpen(self, pos, quat):
        """Each env's deepest penetration of the socket material."""
        rel = self._plug_points_world(pos, quat) - self._socket_pos
        if self.use_mesh_sdf:
            sdf = sdf_grid.sample(self._socket_grid, rel)
        else:
            sdf = sdf_socket_material(rel)
        return torch.clamp(-sdf, min=0.0).amax(-1)

    def _sdf_reward(self, pos, quat):
        rel = self._plug_points_world(pos, quat) - self._goal_pos()
        if self.use_mesh_sdf:
            d = torch.clamp(sdf_grid.sample(self._goal_grid, rel), min=0.0)
        else:
            d = torch.clamp(sdf_cylinder(rel, PLUG_RADIUS, PLUG_LENGTH / 2),
                            min=0.0)
        return -torch.log(torch.clamp(d.mean(-1), min=1e-6))

    # -- control: the grab is always on -----------------------------------
    def pre_physics(self, state: EnvState, actions) -> Control:
        act12 = torch.cat([actions, torch.zeros(
            (self.num_envs, 6), dtype=DTYPE, device=self.device)], -1)
        ctrl = super().pre_physics(state, act12)
        return ctrl._replace(grab_active=torch.ones(
            (self.num_envs, 1), dtype=DTYPE, device=self.device))

    def _gripper_target_rl(self):
        return 0.0

    # -- reset with SBC ---------------------------------------------------
    def draw_objects(self):
        """The plug's xy U(-1, 1) (N, 2) and SBC displacement fraction
        U(0, 1) (N,)."""
        n, g = self.num_envs, self.generator
        return (2.0 * torch.rand((n, 2), generator=g, device=self.device)
                - 1.0, torch.rand((n,), generator=g, device=self.device))

    def reset_idx(self, sim, task, mask, draws=None):
        self._reset_task = task
        try:
            return super().reset_idx(sim, task, mask, draws)
        finally:
            self._reset_task = None

    def _reset_objects(self, sim, mask, draws):
        n = self.num_envs
        xy_u, disp_u = draws
        xy = 0.002 * xy_u
        # SBC: a downward displacement from the engagement height of up to
        # curr_max_disp (positive: deeper, easier)
        disp = disp_u * self._reset_task.curr_max_disp
        top_z = TABLE_HEIGHT + SOCKET_HALF[2] * 2
        z = top_z + PLUG_LENGTH / 2 - disp
        pose = torch.cat([xy + self._socket_pos[0:2], z[:, None],
                          self._ident.expand(n, 4)], -1)
        return self._set_nut_pose(sim, mask, pose)

    # -- reward -----------------------------------------------------------
    def post_physics(self, state: EnvState, out, actions, draws=None):
        n = self.num_envs
        task: IndustRealTaskState = state.task
        plug = out.root_states[:, 2]
        plug_pos, plug_quat = plug[:, 0:3], plug[:, 3:7]
        socket_top_z = self._socket_pos[2] + float(SOCKET_HALF[2] * 2)

        # the SDF dense reward, SAPU's weight and filter
        rew = self.sdf_scale * self._sdf_reward(plug_pos, plug_quat)
        interpen = self._sapu_interpen(plug_pos, plug_quat)
        low = interpen <= self.interpen_thresh
        rew = torch.where(low, rew * (1.0 - torch.tanh(
            interpen / self.interpen_thresh)), task.prev_rew)

        # keypoints along the plug and goal axes
        kp_plug = self._keypoints_from(plug_pos, plug_quat)
        goal = self._goal_pos().expand(n, 3)
        kp_goal = self._keypoints_from(goal, self._ident.expand(n, 4))
        kp_dist = torch.sum(torch.linalg.vector_norm(kp_goal - kp_plug,
                                                     dim=-1), -1)
        close = kp_dist < self.close_thresh
        engaged = ((plug_pos[:, 2] - PLUG_LENGTH / 2 + SOCKET_BASE_HEIGHT
                    < socket_top_z) & close)
        inserted = (plug_pos[:, 2] < goal[:, 2] + self.success_h) & close

        is_last = state.progress >= self.max_episode_length - 1
        height_dist = plug_pos[:, 2] - goal[:, 2]
        eng_scale = torch.where(
            engaged, 1.0 / (torch.clamp(height_dist - self.success_h,
                                        min=0.0) + 0.1), 0.0)
        rew = rew + is_last.to(DTYPE) * eng_scale * self.engagement_bonus
        # the SBC stage's scale on the last step (shrink negative rewards,
        # grow positive ones)
        stage = (self.h_bound[1] - task.curr_max_disp) / \
            (self.h_bound[1] - self.h_bound[0]) + 1.0
        rew = torch.where(is_last, torch.where(rew < 0, rew / stage,
                                               rew * stage), rew)

        # the SBC update at an episode's end
        succ_rate = (low & inserted).to(DTYPE).mean()
        new_disp = torch.where(
            succ_rate > self.succ_thresh,
            torch.clamp(task.curr_max_disp + self.h_step[0],
                        min=self.h_bound[0]),
            torch.where(succ_rate < self.fail_thresh,
                        torch.clamp(task.curr_max_disp + self.h_step[1],
                                    max=self.h_bound[1]),
                        task.curr_max_disp))
        any_last = is_last.any()
        curr_max_disp = torch.where(any_last, new_disp, task.curr_max_disp)
        ep_rate = torch.where(any_last, succ_rate, task.ep_success_rate)
        reset = is_last.to(torch.int32)

        # obs (ref compute_observations :282-320): arm dofs, fingertip and
        # noisy goal poses in the robot base frame, the noisy delta
        ft_pos, ft_quat, _, _ = self._fingertip_state(out)
        arm_q = self.engine.dof_pos(state.sim)[:, self._arm_t]
        inv = maths.quat_conjugate(self._base_quat)
        to_base = lambda p: maths.quat_apply(  # noqa: E731
            inv.expand(p.shape[:-1] + (4,)), p - self._base_pos)
        socket_top = self._socket_pos + self._c(
            [0.0, 0.0, float(SOCKET_HALF[2] * 2)])
        goal_grip = socket_top + self._c([0.0, 0.0, PLUG_LENGTH / 2])
        noise = (torch.randn((n, 3), generator=self.generator,
                             device=self.device)
                 if draws is None else draws[0])
        noisy_goal = goal_grip + 0.002 * noise
        obs = torch.cat([
            arm_q, to_base(ft_pos), maths.quat_mul(inv.expand(n, 4), ft_quat),
            to_base(noisy_goal),
            maths.quat_mul(inv, self._base_quat).expand(n, 4),
            noisy_goal - ft_pos], -1)

        task = IndustRealTaskState(
            actions=actions, prev_rew=rew, curr_max_disp=curr_max_disp,
            insert_success=inserted.to(DTYPE), ep_success_rate=ep_rate)
        # engagement depth: how far the plug's bottom is below the socket
        # top (m, >= 0)
        eng_depth = torch.clamp(
            socket_top_z - (plug_pos[:, 2] - PLUG_LENGTH / 2), min=0.0)
        extras = {"sdf_reward": rew.mean(),
                  "insertion_successes": inserted.to(DTYPE).mean(),
                  "engagement_depth": eng_depth.mean(),
                  "curr_max_disp": curr_max_disp,
                  "successes": ep_rate}
        return obs, None, rew, reset, task, extras

    def get_env_state(self, state):
        """The SBC stage persists into checkpoints (ref curr_max_disp)."""
        return {"curr_max_disp": state.task.curr_max_disp}

    def set_env_state(self, state, env_state):
        if env_state and "curr_max_disp" in env_state:
            return state._replace(task=state.task._replace(
                curr_max_disp=torch.as_tensor(
                    env_state["curr_max_disp"], dtype=DTYPE,
                    device=self.device)))
        return state


class IndustRealTaskGearsInsert(IndustRealTaskPegsInsert):
    """A gear onto a shaft (industreal_task_gears_insert.py): the same
    SAPU, SDF reward and SBC over gear and shaft geometry."""

    def _extra_parts(self):
        ob = ModelBuilder()
        ob.begin_actor()
        gear = ob.add_body(
            "nut", -1, FREE,
            body_pos=(0.0, 0.0, TABLE_HEIGHT + SHAFT_HEIGHT + GEAR_HEIGHT))
        if self.use_mesh_sdf:
            # an annular gear blank with its bore: a pad target, the outer
            # and bore rim rings as its points
            gv, gt = meshes.tube_mesh(GEAR_RADIUS, GEAR_HOLE_R,
                                      GEAR_HEIGHT / 2, n=32)
            cp = meshes.tube_contact_points(GEAR_RADIUS, GEAR_HOLE_R,
                                            GEAR_HEIGHT / 2, n_ring=8)
            ob.add_sdf_geom(gear, gv, gt, density=1200.0, friction=0.5,
                            resolution=48, contact_points=cp,
                            name="nut_geom")
        else:
            ob.add_geom(gear, GEOM_BOX,
                        np.array([GEAR_RADIUS * 0.8, GEAR_RADIUS * 0.8,
                                  GEAR_HEIGHT / 2]),
                        density=1200.0, friction=0.5, name="nut_geom")
        sb = ModelBuilder()
        sb.begin_actor()
        base = sb.add_body("socket", -1, FIXED, body_pos=SOCKET_POS)
        sb.add_geom(base, GEOM_BOX, np.array([0.05, 0.03, 0.0025]),
                    pos=np.array([0, 0, 0.0025]), friction=0.3,
                    name="socket_rim0")
        for i in range(1, 4):   # the 4-rim contact interface's shape
            sb.add_geom(base, GEOM_BOX, np.array([0.001, 0.001, 0.0005]),
                        pos=np.array([0.04 + 0.002 * i, 0.028, 0.0005]),
                        friction=0.3, name=f"socket_rim{i}")
        sb.add_geom(base, GEOM_CYLINDER,
                    np.array([SHAFT_RADIUS, SHAFT_HEIGHT / 2, 0]),
                    pos=np.array([0, 0, SHAFT_HEIGHT / 2]), contact=False,
                    name="shaft_geom")
        return [(ob.finalize(), (0, 0, 0), (0, 0, 0, 1)),
                (sb.finalize(), (0, 0, 0), (0, 0, 0, 1))]

    def _goal_pos(self):
        return self._socket_pos + self._c([0.0, 0.0, 0.005 + GEAR_HEIGHT / 2])

    def _sample_points(self):
        """Gear-shaped surface samples (a tube with the shaft's bore)."""
        v, t = meshes.tube_mesh(GEAR_RADIUS, GEAR_HOLE_R, GEAR_HEIGHT / 2,
                                n=32)
        return meshes.surface_sample(v, t, 64, seed=11)

    def _material_solid_mesh(self):
        """The shaft the gear must not penetrate (query frame: socket)."""
        v, t = meshes.cylinder_mesh(SHAFT_RADIUS, SHAFT_HEIGHT / 2, n=48)
        return v + np.asarray([0.0, 0.0, SHAFT_HEIGHT / 2], np.float32), t

    def _goal_solid_mesh(self):
        """The assembled gear: the annular tube with its bore."""
        return meshes.tube_mesh(GEAR_RADIUS, GEAR_HOLE_R, GEAR_HEIGHT / 2,
                                n=48)

    def _sapu_interpen(self, pos, quat):
        """The gear's penetration of the shaft, the bore rim's points left
        out (they slide along the shaft)."""
        pts = self._plug_points_world(pos, quat)
        rel = pts - self._socket_pos
        if self.use_mesh_sdf:
            sdf = sdf_grid.sample(self._socket_grid, rel)
        else:
            sdf = sdf_cylinder(
                rel - self._c([0.0, 0.0, SHAFT_HEIGHT / 2]),
                SHAFT_RADIUS, SHAFT_HEIGHT / 2)
        r_xy = torch.linalg.vector_norm(pts[..., 0:2] - self._socket_pos[0:2],
                                        dim=-1)
        pen = torch.where(r_xy > GEAR_HOLE_R, torch.clamp(-sdf, min=0.0),
                          0.0)
        return pen.amax(-1)

    def _sdf_reward(self, pos, quat):
        rel = self._plug_points_world(pos, quat) - self._goal_pos()
        if self.use_mesh_sdf:
            d = torch.clamp(sdf_grid.sample(self._goal_grid, rel), min=0.0)
        else:
            d = torch.clamp(sdf_cylinder(rel, GEAR_RADIUS, GEAR_HEIGHT / 2),
                            min=0.0)
        return -torch.log(torch.clamp(d.mean(-1), min=1e-6))


TASK_CFGS = {
    "IndustRealTaskPegsInsert": _cfg_insert("IndustRealTaskPegsInsert"),
    "IndustRealTaskGearsInsert": _cfg_insert("IndustRealTaskGearsInsert"),
}
TASK_CFG = TASK_CFGS["IndustRealTaskPegsInsert"]
