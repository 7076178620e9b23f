"""The Factory nut-bolt family and its scene playgrounds (port of
isaacgymenvs_ma_tpu/tasks/factory.py): FactoryTaskNutBoltPick, Place and
Screw, FactoryTaskGears and FactoryTaskInsertion, 128 envs each.

Scene: a gravity-free Franka at (0.5, 0, 0) facing -x with zero passive
joint damping, a limitless wrist and rigid body damping 1.0 / 5.0, 3 x 2
sphere clouds on its finger pads (and a pad-face box on each finger), over
a 0.6 x 1.0 m table (top z = 0.4), with an M16 nut and bolt baked from
procedural meshes into signed-distance grids (``env.use_mesh_sdf``, on by
default; the port's voxelizer).  Contact: the pads against the nut's grid
and the table top, the nut's corner / rim cloud against the table and the
bolt's grid.  The engine runs warm start 0.9, mass splitting and, where
the rows times nv reach 1024, bfloat16 solver rows: the batched loop with
B1-B3 (B5 also at Screw, whose operational-space controller inverts two
SPD matrices a step).

Actions (12): fingertip pose deltas (and force / torque targets) turned
into joint torques by the controller library (``ops/controllers.py``);
Pick runs joint_space_id, Screw operational_space_motion on z and yaw.
Rewards are keypoint distances; Pick scores lift success on the last step
of an episode after a scripted close-and-lift epilogue (50 engine steps).

Two branches depend on the data, as the JAX package's ``lax.cond``s do:
the masked reset (a 12-iteration IK to a random fingertip pose) runs only
when some env resets, and the epilogue only when some env is on its last
step.  Here they are host branches: :meth:`FactoryBase.step` reads both
flags in one host read a step (``self.branch_reads`` counts them), and
both branches keep the JAX semantics (warm-start impulses dropped and
restored by the base step, lift success masked to the last step).

Reset draws (``step(..., reset_draws=)``): the fingertip target's
position and Euler noise (N, 3) each, U(-1, 1), then the object's: Pick
the nut's xy (N, 2) U(-1, 1) and yaw (N,) U(-pi, pi), Gears and Insertion
the object's xy (N, 2) U(-1, 1); Place and Screw draw nothing more (Screw
no fingertip noise either: its reset pose is fixed).
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..models import meshes
from ..models.franka import build_franka
from ..models.model import (FIXED, FREE, GEOM_BOX, GEOM_CYLINDER, GEOM_SPHERE,
                            SCREW, Geom, ModelBuilder, compose_scene)
from ..ops import controllers as fc
from ..ops import maths
from ..physics.engine import Control, PhysicsEngine, SimState
from .base import EnvState, VecTaskBase, masked_update

TABLE_HEIGHT = 0.4
FRANKA_DEPTH = 0.5
# M16 nut/bolt (factory_asset_info_nut_bolt.yaml:85-98)
NUT_WIDTH = 0.024          # across flats
NUT_HEIGHT = 0.013
NUT_HOLE_R = 0.0085        # bore radius (0.5 mm clearance over the shank)
BOLT_WIDTH = 0.016         # shank diameter
BOLT_HEAD_HEIGHT = 0.016
BOLT_SHANK_LENGTH = 0.025
THREAD_PITCH = 0.002
FRANKA_HAND_LENGTH = 0.0584   # factory_asset_info_franka_table.yaml:1
FRANKA_FINGER_LENGTH = 0.053671
FRANKA_FINGERPAD_LENGTH = 0.017608
GRIPPER_WIDTH_MAX = 0.08
ARM_INIT = np.array([0.3413, -0.8011, -0.0670, -1.8299, 0.0266, 1.0185,
                     1.0927], np.float32)

# the mode sections of the reference task configs; only gym_default pins
# its own gripper gains, every other mode takes them from the task's
# ``all`` section (fc.parse_ctrl_cfg)
_CTRL_YAML = {
    "all": {"jacobian_type": "geometric"},
    "gym_default": {"ik_method": "dls", "joint_prop_gains": [40.0] * 7,
                    "joint_deriv_gains": [8.0] * 7,
                    "gripper_prop_gains": [500.0, 500.0],
                    "gripper_deriv_gains": [20.0, 20.0]},
    "joint_space_ik": {"ik_method": "dls", "joint_prop_gains": [1.0] * 7,
                       "joint_deriv_gains": [0.1] * 7},
    "joint_space_id": {"ik_method": "dls", "joint_prop_gains": [40.0] * 7,
                       "joint_deriv_gains": [8.0] * 7},
    "task_space_impedance": {"motion_ctrl_axes": [1] * 6,
                             "task_prop_gains": [40.0] * 6,
                             "task_deriv_gains": [8.0] * 6},
    "operational_space_motion": {"motion_ctrl_axes": [1] * 6,
                                 "task_prop_gains": [1.0] * 6,
                                 "task_deriv_gains": [1.0] * 6},
    "open_loop_force": {"force_ctrl_axes": [0, 0, 1, 0, 0, 0]},
    "closed_loop_force": {"force_ctrl_axes": [0, 0, 1, 0, 0, 0],
                          "wrench_prop_gains": [0.1] * 6},
    "hybrid_force_motion": {"motion_ctrl_axes": [1, 1, 0, 1, 1, 1],
                            "force_ctrl_axes": [0, 0, 1, 0, 0, 0],
                            "task_prop_gains": [40.0] * 6,
                            "task_deriv_gains": [8.0] * 6,
                            "wrench_prop_gains": [0.1] * 6},
}


def _base_cfg(name, num_obs, num_act, episode_len):
    return {
        "name": name,
        "physics_engine": "physx",
        "env": {"numEnvs": 128, "envSpacing": 0.5,
                "numObservations": num_obs, "numActions": num_act,
                "episodeLength": episode_len,
                "clipObservations": 5.0, "clipActions": 1.0,
                "close_and_lift": True,
                "num_gripper_close_sim_steps": 25,
                "num_gripper_lift_sim_steps": 25,
                # the nut and bolt as baked voxel-grid geoms (PhysX SDF
                # collisions, docs/factory.md); False: primitive proxies
                "use_mesh_sdf": True},
        "randomize": {
            "franka_arm_initial_dof_pos": ARM_INIT.tolist(),
            "fingertip_midpoint_pos_initial": [0.0, -0.2, 0.2],
            "fingertip_midpoint_pos_noise": [0.2, 0.2, 0.1],
            "fingertip_midpoint_rot_initial": [3.1416, 0.0, 3.1416],
            "fingertip_midpoint_rot_noise": [0.3, 0.3, 1.0],
            "nut_pos_xy_initial": [0.0, -0.3],
            "nut_pos_xy_initial_noise": [0.1, 0.1],
            "bolt_pos_xy_initial": [0.0, 0.0],
            "bolt_pos_xy_noise": [0.1, 0.1],
        },
        "rl": {"pos_action_scale": [0.1, 0.1, 0.1],
               "rot_action_scale": [0.1, 0.1, 0.1],
               "force_action_scale": [1.0, 1.0, 1.0],
               "torque_action_scale": [1.0, 1.0, 1.0],
               "clamp_rot": True, "clamp_rot_thresh": 1.0e-6,
               "num_keypoints": 4, "keypoint_scale": 0.5,
               "keypoint_reward_scale": 1.0, "action_penalty_scale": 0.0,
               "max_episode_length": episode_len, "success_bonus": 0.0,
               "far_error_thresh": 0.1},
        "ctrl": dict(copy.deepcopy(_CTRL_YAML), ctrl_type="joint_space_id"),
        "sim": {"dt": 0.016667, "substeps": 2, "up_axis": "z",
                "gravity": [0.0, 0.0, -9.81],
                "physx": {"num_position_iterations": 16,
                          "num_velocity_iterations": 0,
                          "max_depenetration_velocity": 5.0,
                          # speculative band (FactoryBase.yaml contact_offset)
                          "contact_offset": 0.005,
                          # persistent-contact impulses (PhysX warm start)
                          "warm_start": 0.9,
                          # mesh contact clouds rest many coincident rows
                          "mass_splitting": True}},
        "task": {"randomize": False, "randomization_params": {}},
    }


class FactoryTaskState(NamedTuple):
    actions: torch.Tensor        # (N, 12) last policy actions
    lift_success: torch.Tensor   # (N,) scored at an episode's end (pick)


class FactoryBase(VecTaskBase):
    """Franka-over-table base with task-space controllers
    (factory_base.py)."""

    nut_free = True            # the screw task overrides

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        e = cfg["env"]
        e.setdefault("clipObservations", 5.0)
        self.cfg_rl = cfg["rl"]
        self.cfg_rand = cfg["randomize"]
        self.use_mesh_sdf = bool(e.get("use_mesh_sdf", True))
        self.ctrl_type = cfg["ctrl"].get("ctrl_type", "joint_space_id")
        e["episodeLength"] = int(self.cfg_rl["max_episode_length"])
        self._consts = {}
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)
        dev = self.device
        self.cfg_ctrl = fc.parse_ctrl_cfg(cfg["ctrl"], self.ctrl_type,
                                          self.num_envs, dev)
        m = self.model
        self.hand_body = m.body_names.index("panda_hand")
        self.grip_site = m.body_names.index("panda_grip_site")
        self.lf_body = m.body_names.index("panda_leftfinger")
        self.rf_body = m.body_names.index("panda_rightfinger")
        self.nut_body = m.body_names.index("nut")
        sd = self.engine.scalar_dofs
        self.franka_dofs = np.asarray(sd[:9])
        t = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=dev)
        idx = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.int64), device=dev)
        self._franka_dofs_t = idx(self.franka_dofs)
        self._arm_t = idx(self.franka_dofs[:7])
        self.dof_lower = t(np.asarray(m.dof_lower)[self.franka_dofs])
        self.dof_upper = t(np.asarray(m.dof_upper)[self.franka_dofs])
        self.default_dof = t(np.concatenate([ARM_INIT, [0.035, 0.035]]))
        self.pos_scale = t(self.cfg_rl["pos_action_scale"])
        self.rot_scale = t(self.cfg_rl["rot_action_scale"])
        self.force_scale_a = t(self.cfg_rl["force_action_scale"])
        self.torque_scale_a = t(self.cfg_rl["torque_action_scale"])
        kp = self.cfg_rl["num_keypoints"]
        ko = np.zeros((kp, 3), np.float32)
        ko[:, 2] = (np.linspace(0.0, 1.0, kp) - 0.5) \
            * self.cfg_rl["keypoint_scale"]
        self.keypoint_offsets = t(ko)
        self._ident = t([0.0, 0.0, 0.0, 1.0])
        self._flip_y = t([0.0, 1.0, 0.0, 0.0])
        self._ez = t([0.0, 0.0, 1.0])
        self._table_z = t([0.0, 0.0, TABLE_HEIGHT])
        # the nut's root coordinates (Screw's: its joint's one)
        qa = self._nut_qa = int(m.q_adr[self.nut_body])
        va = self._nut_va = int(m.v_adr[self.nut_body])
        self._nut_q_t = idx(qa + np.arange(7 if self.nut_free else 1))
        self._nut_v_t = idx(va + np.arange(6 if self.nut_free else 1))
        # the data-dependent branches' flags of the step in progress (one
        # host read, :meth:`step`), and the count of those reads
        self._branch_flags = None
        self.branch_reads = 0

    def _c(self, x):
        """A float32 constant on the task's device, made on first use (a
        tensor made from host values at every step would copy to the card
        and wait for it)."""
        key = (np.shape(x),) + tuple(np.ravel(np.asarray(x, np.float64)))
        c = self._consts.get(key)
        if c is None:
            c = self._consts[key] = torch.as_tensor(
                np.asarray(x, np.float32), device=self.device)
        return c

    # -- scene ------------------------------------------------------------
    def create_model(self):
        franka = build_franka(hand_contact_sphere=0.0)
        for d in range(franka.nv):
            franka.dof_drive_mode[d] = 0   # torque control via controllers
            # zero passive joint damping (factory_base.py:414-416)
            franka.dof_damping[d] = 0.0
        # the factory Franka's wrist has no limit (factory_franka.urdf:147)
        franka.dof_lower[6] = -1e9
        franka.dof_upper[6] = 1e9
        franka.dof_has_limit[6] = False
        # sim.add_damping: rigid link damping 1.0 / 5.0
        # (factory_base.py:122-125)
        if self.cfg.get("sim", {}).get("add_damping", True):
            franka.body_lin_damping = np.ones(franka.nb)
            franka.body_ang_damping = np.full(franka.nb, 5.0)
        # a 3 x 2 grid of 4 mm spheres over each flat pad face, and the pad
        # face as a box (the Screw task's inverted grip pairs' target)
        pad_pts = np.array(
            [[sx, 0.0, FRANKA_FINGER_LENGTH - FRANKA_FINGERPAD_LENGTH + dz]
             for sx in (-0.005, 0.005)
             for dz in (0.003, 0.0088, 0.0146)], np.float32)
        for n in ("panda_leftfinger", "panda_rightfinger"):
            b = franka.body_names.index(n)
            franka.geoms.append(Geom(
                body=b, gtype=GEOM_SPHERE, size=np.array([0.004, 0, 0]),
                pos=np.array([0.0, 0.0, 0.0]),
                quat=np.array([0.0, 0, 0, 1]), friction=1.0, contact=True,
                contact_points=pad_pts, name=f"pad_{n}"))
            franka.geoms.append(Geom(
                body=b, gtype=GEOM_BOX,
                size=np.array([0.008, 0.004,
                               FRANKA_FINGERPAD_LENGTH / 2]),
                pos=np.array([0.0, 0.0, FRANKA_FINGER_LENGTH
                              - FRANKA_FINGERPAD_LENGTH / 2]),
                quat=np.array([0.0, 0, 0, 1]), friction=1.0, contact=False,
                name=f"padbox_{n}"))
        tb = ModelBuilder()
        tb.begin_actor()
        tbody = tb.add_body("table", -1, FIXED,
                            body_pos=(0.0, 0.0, TABLE_HEIGHT / 2))
        # the reference table: 0.6 (x) x 1.0 (y)
        tb.add_geom(tbody, GEOM_BOX, np.array([0.3, 0.5, TABLE_HEIGHT / 2]),
                    friction=0.3, name="table_top")
        parts = [
            (franka, (FRANKA_DEPTH, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0)),
            (tb.finalize(), (0, 0, 0), (0, 0, 0, 1)),
        ]
        parts += self._extra_parts()
        model = compose_scene(parts)
        # the Franka simulated gravity-free (factory_base.py:132)
        for i, n in enumerate(model.body_names):
            if n.startswith("panda_"):
                model.body_gravity[i] = 0.0
        model.sensor_body = np.asarray(
            [model.body_names.index("panda_leftfinger"),
             model.body_names.index("panda_rightfinger")], np.int32)
        model.sensor_pos = np.zeros((2, 3))
        return model, True

    def _extra_parts(self):
        return []

    def build_engine(self, model, ground):
        names = [g.name for g in model.geoms]
        pairs = []
        nut_geom = names.index("nut_geom")
        table = names.index("table_top")
        for pn in names:
            if pn.startswith("pad_"):
                pairs.append((names.index(pn), nut_geom))
                # the fingers collide with the table top
                pairs.append((names.index(pn), table))
        if self.nut_free:
            pairs.append((nut_geom, table))
            if "bolt_geom" in names:
                pairs.append((nut_geom, names.index("bolt_geom")))
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs, device=self.device)

    # -- controller plumbing ----------------------------------------------
    def _fingertip_state(self, out):
        pos = out.body_pos[:, self.grip_site]
        quat = out.body_quat[:, self.grip_site]
        vel = out.body_vel[:, self.grip_site]
        return pos, quat, vel[:, 0:3], vel[:, 3:6]

    def _arm_readouts(self, sim):
        """(jacobian (N, 6, 7), arm mass matrix (N, 7, 7), fingertip pose,
        its linear and angular velocity)."""
        M, body_x, body_q, S, V = self.engine.dynamics_readout(sim)
        arm = self._arm_t
        J_full = self.engine.point_jacobian(S, body_x, self.grip_site,
                                            point=body_x[:, self.grip_site])
        J = J_full[:, arm, :].transpose(1, 2)          # (N, 6, 7) [lin; ang]
        M_arm = M[:, arm][:, :, arm]
        ft_pos = body_x[:, self.grip_site]
        ft_quat = body_q[:, self.grip_site]
        Vg = V[:, self.grip_site]
        ang = Vg[:, 0:3]
        lin = Vg[:, 3:6] + torch.linalg.cross(ang, ft_pos, dim=-1)
        return J, M_arm, ft_pos, ft_quat, lin, ang

    def _apply_actions_as_ctrl_targets(self, sim, actions, gripper_target,
                                       do_scale=True):
        J, M_arm, ft_pos, ft_quat, lin, ang = self._arm_readouts(sim)
        pos_actions = actions[:, 0:3] * (self.pos_scale if do_scale else 1.0)
        target_pos = ft_pos + pos_actions
        rot_actions = actions[:, 3:6]
        if do_scale and self.cfg_rl.get("unidirectional_rot"):
            # the z-rotation action in [-1, 0]: the wrist only yaws
            # clockwise (factory_task_nut_bolt_screw.py:254-255)
            rot_actions = torch.cat(
                [rot_actions[:, :2], -(rot_actions[:, 2:3] + 1.0) * 0.5], -1)
        rot_actions = rot_actions * (self.rot_scale if do_scale else 1.0)
        angle = torch.linalg.vector_norm(rot_actions, dim=-1)
        axis = rot_actions / torch.clamp(angle, min=1e-9)[:, None]
        rot_quat = maths.quat_from_angle_axis(angle, axis)
        if self.cfg_rl.get("clamp_rot", True):
            rot_quat = torch.where(
                (angle > self.cfg_rl["clamp_rot_thresh"])[:, None],
                rot_quat, self._ident)
        target_quat = maths.quat_mul(rot_quat, ft_quat)
        wrench = None
        if self.cfg_ctrl.get("do_force_ctrl"):
            wrench = torch.cat([actions[:, 6:9] * self.force_scale_a,
                                actions[:, 9:12] * self.torque_scale_a], -1)
        n = self.num_envs
        dofs = self._franka_dofs_t
        dof_pos = self.engine.dof_pos(sim)[:, dofs]
        dof_vel = self.engine.dof_vel(sim)[:, dofs]
        zeros3 = torch.zeros((n, 3), dtype=DTYPE, device=self.device)
        if torch.is_tensor(gripper_target) and gripper_target.dim() == 2:
            gt = gripper_target
        else:
            gt = torch.full((n, 2), float(gripper_target), dtype=DTYPE,
                            device=self.device)
        tau9 = fc.compute_dof_torque(
            self.cfg_ctrl, dof_pos, dof_vel, ft_pos, ft_quat, lin, ang,
            J, M_arm, gt, target_pos, target_quat,
            target_contact_wrench=wrench,
            left_finger_force=zeros3, right_finger_force=zeros3)
        tau = torch.zeros((n, self.engine.nv), dtype=DTYPE,
                          device=self.device)
        tau[:, dofs] = tau9
        return tau

    def _gripper_target_rl(self):
        """The gripper dof target during RL steps (pick: open)."""
        return GRIPPER_WIDTH_MAX / 2

    def _control(self, tau):
        z = torch.zeros_like(tau)
        return Control(tau=tau, pos_target=z, vel_target=z)

    def pre_physics(self, state: EnvState, actions) -> Control:
        return self._control(self._apply_actions_as_ctrl_targets(
            state.sim, actions, self._gripper_target_rl()))

    # -- the data-dependent branches --------------------------------------
    def step(self, state: EnvState, actions, **draws):
        """``VecTaskBase.step`` with the flags of its two data-dependent
        branches (some env resets: the IK reset; some env on its last
        step: Pick's epilogue) read from the device in one host read."""
        reset = state.reset_buf > 0
        progress = torch.where(reset, 0, state.progress + 1)
        last = progress >= self.max_episode_length - 1
        self._branch_flags = torch.stack([reset.any(), last.any()]).tolist()
        self.branch_reads += 1
        try:
            return super().step(state, actions, **draws)
        finally:
            self._branch_flags = None

    def _any(self, mask, which: int) -> bool:
        """Whether ``mask`` has an env set: the step's flag where one is
        being read (``which``: 0 the resets, 1 the last steps), else one
        host read of its own."""
        if self._branch_flags is not None:
            return bool(self._branch_flags[which])
        self.branch_reads += 1
        return bool(mask.any())

    # -- resets -----------------------------------------------------------
    def draw_reset(self):
        """The reset's draws from the task's generator: the fingertip
        target's position and Euler noise U(-1, 1) (N, 3) each, then
        :meth:`draw_objects`'s."""
        n, g = self.num_envs, self.generator
        u = lambda *s: 2.0 * torch.rand(  # noqa: E731
            s, generator=g, device=self.device) - 1.0
        return (u(n, 3), u(n, 3)) + self.draw_objects()

    def draw_objects(self):
        return ()

    def _ik_to_random_gripper_pose(self, sim, pos_u, rot_u):
        """Jacobian IK (damped least squares, 12 iterations of half
        steps) to a randomized fingertip pose (factory.py:398-429)."""
        c, r = self._c, self.cfg_rand
        tp = self._table_z + c(r["fingertip_midpoint_pos_initial"])
        target_pos = tp + c(r["fingertip_midpoint_pos_noise"]) * pos_u
        euler = c(r["fingertip_midpoint_rot_initial"]) \
            + c(r["fingertip_midpoint_rot_noise"]) * rot_u
        target_quat = maths.quat_from_euler_xyz(
            euler[:, 0], euler[:, 1], euler[:, 2])
        eng = self.engine
        dofs = self._franka_dofs_t
        dof = eng.dof_pos(sim).clone()
        dof[:, dofs] = self.default_dof
        q = eng.set_dof_pos(sim, dof).q
        zero_qd = torch.zeros_like(sim.qd)
        for _ in range(12):
            s = SimState(q, zero_qd)
            J, _, ft_pos, ft_quat, _, _ = self._arm_readouts(s)
            pe, ae = fc.get_pose_error(ft_pos, ft_quat, target_pos,
                                       target_quat)
            dq = fc.get_delta_dof_pos(torch.cat([pe, ae], -1), "dls", J)
            dof = eng.dof_pos(s).clone()
            dof[:, self._arm_t] = dof[:, self._arm_t] + 0.5 * dq
            q = eng.set_dof_pos(s, dof).q
        return q

    def reset_idx(self, sim: SimState, task, mask, draws=None):
        """Masked reset (factory.py:431-454): the IK to a random fingertip
        pose and the objects' reset, only when some env resets (the JAX
        ``lax.cond``); both branches drop the warm-start impulses, which
        the base step restores."""
        if self._any(mask, 0):
            draws = self.draw_reset() if draws is None else draws
            q_ik = self._ik_to_random_gripper_pose(sim, draws[0], draws[1])
            q = torch.where(mask[:, None], q_ik, sim.q)
            qd = torch.where(mask[:, None], torch.zeros_like(sim.qd), sim.qd)
            out = self._reset_objects(SimState(q, qd), mask, draws[2:])
            sim = SimState(out.q, out.qd)
        else:
            sim = SimState(sim.q, sim.qd)
        if hasattr(task, "lift_success"):
            task = task._replace(lift_success=torch.where(
                mask, 0.0, task.lift_success))
        return sim, task

    def _reset_objects(self, sim, mask, draws):
        return sim

    def _set_nut_pose(self, sim, mask, pose):
        """The nut's root pose (N, 7) and zero velocity where ``mask``."""
        n = self.num_envs
        q, qd = sim.q.clone(), sim.qd.clone()
        qi, vi = self._nut_q_t, self._nut_v_t
        q[:, qi] = masked_update(mask, pose, sim.q[:, qi])
        qd[:, vi] = masked_update(mask, torch.zeros(
            (n, 6), dtype=DTYPE, device=self.device), sim.qd[:, vi])
        return SimState(q, qd)

    def initial_task_state(self):
        n = self.num_envs
        return FactoryTaskState(
            actions=torch.zeros((n, self.num_actions), dtype=DTYPE,
                                device=self.device),
            lift_success=torch.zeros(n, dtype=DTYPE, device=self.device))

    def _keypoints_from(self, pos, quat):
        return pos[:, None, :] + maths.quat_apply(quat[:, None, :],
                                                  self.keypoint_offsets)


# ---------------------------------------------------------------------------
TASK_CFG_PICK = _base_cfg("FactoryTaskNutBoltPick", 20, 12, 100)
TASK_CFG_PLACE = _base_cfg("FactoryTaskNutBoltPlace", 27, 12, 200)
TASK_CFG_SCREW = _base_cfg("FactoryTaskNutBoltScrew", 32, 12, 8192)
# per-task gripper gains from each reference config's ``all`` section
TASK_CFG_PICK["ctrl"]["all"] = {"jacobian_type": "geometric",
                                "gripper_prop_gains": [50.0, 50.0],
                                "gripper_deriv_gains": [2.0, 2.0]}
TASK_CFG_PLACE["ctrl"]["all"] = {"jacobian_type": "geometric",
                                 "gripper_prop_gains": [100.0, 100.0],
                                 "gripper_deriv_gains": [2.0, 2.0]}
TASK_CFG_SCREW["ctrl"]["all"] = {"jacobian_type": "geometric",
                                 "gripper_prop_gains": [100.0, 100.0],
                                 "gripper_deriv_gains": [1.0, 1.0]}
TASK_CFG_SCREW["rl"]["unidirectional_rot"] = True
TASK_CFG_SCREW["ctrl"]["ctrl_type"] = "operational_space_motion"
TASK_CFG_SCREW["ctrl"]["operational_space_motion"] = {
    "motion_ctrl_axes": [0, 0, 1, 0, 0, 1],
    "task_prop_gains": [1.0, 1, 1, 1, 1, 200.0],
    "task_deriv_gains": [1.0] * 6}
# Screw starts grasping the nut atop the bolt from a fixed arm pose
TASK_CFG_SCREW["randomize"]["franka_arm_initial_dof_pos"] = [
    1.5178e-03, -1.9651e-01, -1.4364e-03, -1.9761e+00, -2.7717e-04,
    1.7796e+00, 7.8556e-01]
TASK_CFG_SCREW["randomize"]["nut_rot_initial"] = 30.0
TASK_CFG = TASK_CFG_PICK


class FactoryTaskNutBoltPick(FactoryBase):
    """Pick the nut off the table (factory_task_nut_bolt_pick.py): obs 20
    (fingertip pose and velocities, the nut's grasp pose)."""

    def _extra_parts(self):
        ob = ModelBuilder()
        ob.begin_actor()
        nut = ob.add_body("nut", -1, FREE,
                          body_pos=(0.0, -0.3, TABLE_HEIGHT + NUT_HEIGHT / 2))
        if self.use_mesh_sdf:
            # the hex nut's mesh: mass from the bored solid, the collision
            # field from the solid hex prism, a corner / rim point cloud
            nv_, nt_ = meshes.hex_nut_mesh(NUT_WIDTH, NUT_HEIGHT, NUT_HOLE_R)
            cp = meshes.hex_nut_contact_points(NUT_WIDTH, NUT_HEIGHT,
                                               NUT_HOLE_R)
            solid = meshes.cylinder_mesh(NUT_WIDTH / np.sqrt(3.0),
                                         NUT_HEIGHT / 2.0, n=6)
            ob.add_sdf_geom(nut, nv_, nt_, density=7850.0, friction=0.8,
                            resolution=40, contact_points=cp,
                            sdf_from=[solid], name="nut_geom")
        else:
            ob.add_geom(nut, GEOM_BOX,
                        np.array([NUT_WIDTH / 2, NUT_WIDTH / 2,
                                  NUT_HEIGHT / 2]),
                        density=7850.0, friction=0.8, name="nut_geom")
        bb = ModelBuilder()
        bb.begin_actor()
        bolt = bb.add_body("bolt", -1, FIXED,
                           body_pos=(0.0, 0.0, TABLE_HEIGHT))
        if self.use_mesh_sdf:
            head, shank = meshes.bolt_mesh_parts(
                NUT_WIDTH, BOLT_HEAD_HEIGHT, BOLT_WIDTH / 2,
                BOLT_SHANK_LENGTH)
            bb.add_sdf_geom(bolt, head[0], head[1], friction=0.5,
                            resolution=64, union_with=[shank],
                            name="bolt_geom")
        else:
            bb.add_geom(bolt, GEOM_CYLINDER,
                        np.array([BOLT_WIDTH / 2,
                                  (BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH) / 2,
                                  0]),
                        pos=np.array([0, 0, (BOLT_HEAD_HEIGHT
                                             + BOLT_SHANK_LENGTH) / 2]),
                        friction=0.5, name="bolt_geom")
        return [(ob.finalize(), (0, 0, 0), (0, 0, 0, 1)),
                (bb.finalize(), (0, 0, 0), (0, 0, 0, 1))]

    def draw_objects(self):
        """The nut's xy U(-1, 1) (N, 2) and yaw U(-pi, pi) (N,)."""
        n, g = self.num_envs, self.generator
        xy_u = 2.0 * torch.rand((n, 2), generator=g, device=self.device) - 1
        yaw = (2.0 * torch.rand((n,), generator=g, device=self.device)
               - 1.0) * np.pi
        return (xy_u, yaw)

    def _reset_objects(self, sim, mask, draws):
        n = self.num_envs
        xy_u, yaw = draws
        xy = self._c(self.cfg_rand["nut_pos_xy_initial"]) \
            + self._c(self.cfg_rand["nut_pos_xy_initial_noise"]) * xy_u
        quat = maths.quat_from_angle_axis(yaw, self._ez)
        pose = torch.cat([xy, torch.full((n, 1), TABLE_HEIGHT
                                         + NUT_HEIGHT / 2, dtype=DTYPE,
                                         device=self.device), quat], -1)
        return self._set_nut_pose(sim, mask, pose)

    def evaluate_lift(self, state: EnvState):
        """The scripted close-and-lift epilogue (ref _close_gripper /
        _lift_gripper :350-377): close the gripper, lift open-loop, then
        score lift success (the nut above table + 3 nut heights), each
        engine step under the episode's physics scales."""
        n = self.num_envs
        close_steps = int(self.cfg["env"].get("num_gripper_close_sim_steps",
                                              25))
        lift_steps = int(self.cfg["env"].get("num_gripper_lift_sim_steps", 25))
        phys = state.phys

        def phase(sim, actions12, length):
            for _ in range(length):
                tau = self._apply_actions_as_ctrl_targets(
                    sim, actions12, 0.0, do_scale=False)
                sim, _ = self.engine.step(sim, self._control(tau), phys=phys)
            return sim

        still = torch.zeros((n, 12), dtype=DTYPE, device=self.device)
        sim = phase(state.sim, still, close_steps)
        lift = still.clone()
        lift[:, 2] = 0.3
        sim = phase(sim, lift, lift_steps)
        out = self.engine.forward(sim)
        nut_z = out.root_states[:, 2, 2]
        return (nut_z > TABLE_HEIGHT + NUT_HEIGHT * 3.0).to(DTYPE)

    def _nut_grasp_frame(self, out):
        """The grasp pose on the nut: its centre of mass, flipped about y
        (factory.py:613-627)."""
        nut = out.root_states[:, 2]
        return nut[:, 0:3], maths.quat_mul(nut[:, 3:7], self._flip_y)

    def post_physics(self, state: EnvState, out, actions):
        n = self.num_envs
        task: FactoryTaskState = state.task
        ft_pos, ft_quat, ft_lin, ft_ang = self._fingertip_state(out)
        grasp_pos, grasp_quat = self._nut_grasp_frame(out)
        kp_gripper = self._keypoints_from(ft_pos, ft_quat)
        kp_nut = self._keypoints_from(grasp_pos, grasp_quat)
        kp_dist = torch.sum(torch.linalg.vector_norm(kp_nut - kp_gripper,
                                                     dim=-1), -1)
        action_penalty = torch.linalg.vector_norm(actions, dim=-1)
        reward = -kp_dist * self.cfg_rl["keypoint_reward_scale"] \
            - action_penalty * self.cfg_rl["action_penalty_scale"]
        is_last = state.progress >= self.max_episode_length - 1
        last_f = is_last.to(DTYPE)
        if self.cfg["env"].get("close_and_lift", True):
            # scored after the epilogue, on the episode's last step only
            # (factory.py:643-659)
            if self._any(is_last, 1):
                lift_success = self.evaluate_lift(state)
            else:
                lift_success = torch.zeros(n, dtype=DTYPE,
                                           device=self.device)
            lift_success = lift_success * last_f
        else:
            nut_z = out.root_states[:, 2, 2]
            lift_success = (nut_z > TABLE_HEIGHT + NUT_HEIGHT * 3.0).to(DTYPE)
        reward = reward + last_f * lift_success * self.cfg_rl["success_bonus"]
        reset = is_last.to(torch.int32)
        obs = torch.cat([ft_pos, ft_quat, ft_lin, ft_ang,
                         grasp_pos, grasp_quat], -1)
        task = task._replace(actions=actions, lift_success=lift_success)
        n_last = last_f.sum()
        extras = {"successes": torch.where(
            n_last > 0, lift_success.sum() / torch.clamp(n_last, min=1.0),
            0.0)}
        return obs, None, reward, reset, task, extras


class FactoryTaskNutBoltPlace(FactoryTaskNutBoltPick):
    """Place the held nut onto the bolt tip (factory_task_nut_bolt_place.py):
    obs 27."""

    def _gripper_target_rl(self):
        return 0.0   # the gripper stays closed on the nut

    def draw_objects(self):
        return ()

    def _reset_objects(self, sim, mask, draws):
        """The nut starts in the closed gripper."""
        n = self.num_envs
        out = self.engine.forward(sim)
        ft_pos, ft_quat, _, _ = self._fingertip_state(out)
        grip_quat = maths.quat_mul(ft_quat, self._flip_y)
        pose = torch.cat([ft_pos, grip_quat], -1)
        qi = self._nut_q_t
        q = sim.q.clone()
        q[:, qi] = masked_update(mask, pose, sim.q[:, qi])
        # the fingers closed to the nut's width
        eng = self.engine
        dof = eng.dof_pos(SimState(q, sim.qd)).clone()
        fing = self._franka_dofs_t[7:9]
        dof[:, fing] = masked_update(
            mask, torch.full((n, 2), NUT_WIDTH / 2, dtype=DTYPE,
                             device=self.device), dof[:, fing])
        sim2 = eng.set_dof_pos(SimState(q, sim.qd), dof)
        qd = sim2.qd.clone()
        vi = self._nut_v_t
        qd[:, vi] = masked_update(mask, torch.zeros(
            (n, 6), dtype=DTYPE, device=self.device), sim2.qd[:, vi])
        return SimState(sim2.q, qd)

    def post_physics(self, state: EnvState, out, actions):
        task: FactoryTaskState = state.task
        ft_pos, ft_quat, ft_lin, ft_ang = self._fingertip_state(out)
        nut = out.root_states[:, 2]
        bolt = out.root_states[:, 3]
        # the target: the nut centred on the bolt tip
        bolt_tip = bolt[:, 0:3] + self._c(
            [0.0, 0.0, BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH])
        ident = self._ident.expand(self.num_envs, 4)
        kp_nut = self._keypoints_from(nut[:, 0:3], nut[:, 3:7])
        kp_target = self._keypoints_from(bolt_tip, ident)
        kp_dist = torch.sum(torch.linalg.vector_norm(kp_target - kp_nut,
                                                     dim=-1), -1)
        action_penalty = torch.linalg.vector_norm(actions, dim=-1)
        reward = -kp_dist * self.cfg_rl["keypoint_reward_scale"] \
            - action_penalty * self.cfg_rl["action_penalty_scale"]
        is_last = state.progress >= self.max_episode_length - 1
        close = (torch.linalg.vector_norm(nut[:, 0:3] - bolt_tip, dim=-1)
                 < 0.01).to(DTYPE)
        reward = reward + is_last.to(DTYPE) * close \
            * self.cfg_rl["success_bonus"]
        reset = is_last.to(torch.int32)
        obs = torch.cat([ft_pos, ft_quat, ft_lin, ft_ang,
                         nut[:, 0:3], nut[:, 3:7],
                         bolt[:, 0:3], bolt[:, 3:7]], -1)
        task = task._replace(actions=actions, lift_success=close)
        extras = {"successes": torch.where(is_last.any(), close.mean(),
                                           0.0)}
        return obs, None, reward, reset, task, extras


class FactoryTaskNutBoltScrew(FactoryBase):
    """Screw the nut down the bolt (factory_task_nut_bolt_screw.py): obs
    32.  The nut rides a SCREW joint (pitch 2 mm a turn) on the bolt's
    axis, and its corner / rim cloud collides against the pad-face boxes
    (inverted grip pairs: every grip normal is the pad's)."""

    nut_free = False

    def build_engine(self, model, ground):
        names = [g.name for g in model.geoms]
        nut_geom = names.index("nut_geom")
        pairs = [(nut_geom, names.index(f"padbox_panda_{s}finger"))
                 for s in ("left", "right")]
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs, device=self.device)

    def _gripper_target_rl(self):
        return 0.0

    def _extra_parts(self):
        bb = ModelBuilder()
        bb.begin_actor()
        bolt = bb.add_body("bolt", -1, FIXED,
                           body_pos=(0.0, 0.0, TABLE_HEIGHT))
        bb.add_geom(bolt, GEOM_CYLINDER,
                    np.array([BOLT_WIDTH / 2,
                              (BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH) / 2, 0]),
                    pos=np.array([0, 0,
                                  (BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH) / 2]),
                    friction=0.3, contact=False, name="bolt_geom")
        # the nut on the screw joint, its bottom flush with the shank's
        # tip; +q turns it clockwise and down, the whole shank's travel
        travel = BOLT_SHANK_LENGTH
        nut = bb.add_body(
            "nut", bolt, SCREW, jnt_axis=(0, 0, -1.0),
            jnt_pitch=THREAD_PITCH,
            body_pos=(0.0, 0.0, BOLT_HEAD_HEIGHT + BOLT_SHANK_LENGTH
                      + NUT_HEIGHT * 0.5),
            limit_lower=[0.0],
            limit_upper=[2 * np.pi * travel / THREAD_PITCH],
            damping=0.02)
        if self.use_mesh_sdf:
            nv_, nt_ = meshes.hex_nut_mesh(NUT_WIDTH, NUT_HEIGHT, NUT_HOLE_R)
            cp = meshes.hex_nut_contact_points(NUT_WIDTH, NUT_HEIGHT,
                                               NUT_HOLE_R)
            # mid-height corner and flat rings, on the pad box's clean face
            mid = np.concatenate([
                meshes._ring(NUT_WIDTH / np.sqrt(3.0), 0.0, 6),
                meshes._ring(NUT_WIDTH / 2.0, 0.0, 6, np.pi / 6)])
            cp = np.concatenate([cp, mid.astype(np.float32)])
            solid = meshes.cylinder_mesh(NUT_WIDTH / np.sqrt(3.0),
                                         NUT_HEIGHT / 2.0, n=6)
            bb.add_sdf_geom(nut, nv_, nt_, density=7850.0, friction=0.8,
                            resolution=40, contact_points=cp,
                            sdf_from=[solid], name="nut_geom")
        else:
            bb.add_geom(nut, GEOM_BOX,
                        np.array([NUT_WIDTH / 2, NUT_WIDTH / 2,
                                  NUT_HEIGHT / 2]),
                        density=7850.0, friction=0.8, name="nut_geom")
        return [(bb.finalize(), (0, 0, 0), (0, 0, 0, 1))]

    def reset_idx(self, sim: SimState, task, mask, draws=None):
        """The fixed grasp pose over the bolt, the fingers at 1.1 nut
        half-widths, and the nut at the shank's top turned nut_rot_initial
        (factory.py:830-863): no draws."""
        n = self.num_envs
        arm = self._c(self.cfg_rand["franka_arm_initial_dof_pos"])
        dof9 = torch.cat([arm.expand(n, 7),
                          torch.full((n, 2), NUT_WIDTH / 2 * 1.1,
                                     dtype=DTYPE, device=self.device)], -1)
        eng = self.engine
        dofs = self._franka_dofs_t
        dof = eng.dof_pos(sim).clone()
        dof[:, dofs] = masked_update(mask, dof9, dof[:, dofs])
        sim = eng.set_dof_pos(sim, dof)
        qd = torch.where(mask[:, None], torch.zeros_like(sim.qd), sim.qd)
        q0 = float(np.radians(self.cfg_rand.get("nut_rot_initial", 0.0)))
        q, qd = sim.q.clone(), qd.clone()
        qa, va = self._nut_qa, self._nut_va
        q[:, qa] = torch.where(mask, q0, sim.q[:, qa])
        qd[:, va] = torch.where(mask, 0.0, qd[:, va])
        if hasattr(task, "lift_success"):
            task = task._replace(lift_success=torch.where(
                mask, 0.0, task.lift_success))
        return SimState(q, qd), task

    def post_physics(self, state: EnvState, out, actions):
        n = self.num_envs
        task: FactoryTaskState = state.task
        ft_pos, ft_quat, ft_lin, ft_ang = self._fingertip_state(out)
        nut_pos = out.body_pos[:, self.nut_body]
        nut_quat = out.body_quat[:, self.nut_body]
        nut_vel = out.body_vel[:, self.nut_body]
        target = self._c(
            [0.0, 0.0, TABLE_HEIGHT + BOLT_HEAD_HEIGHT + NUT_HEIGHT * 0.5])
        dist_to_target = torch.linalg.vector_norm(target - nut_pos, dim=-1)
        # 4-point axis keypoints (ref _get_keypoint_dist :289-339)
        axis_len = FRANKA_HAND_LENGTH + FRANKA_FINGER_LENGTH
        fracs = self._c([0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0])[None, :, None]

        def axis_kp_dist(p1, p2, t1, t2):
            kp = p1[:, None, :] + (p2 - p1)[:, None, :] * fracs
            kt = t1[:, None, :] + (t2 - t1)[:, None, :] * fracs
            return torch.sum(torch.linalg.vector_norm(kt - kp, dim=-1), -1)

        up = self._c([0.0, 0.0, axis_len])
        targ_n = target.expand(n, 3)
        nut_axis = nut_pos + maths.quat_apply(nut_quat, up)
        nut_kp_dist = axis_kp_dist(nut_pos, nut_axis, targ_n, targ_n + up)
        # the pad midpoint: the finger origins' midpoint moved along the
        # hand's z to the pad centres
        pad_off = maths.quat_apply(
            out.body_quat[:, self.hand_body],
            self._c([0.0, 0.0, FRANKA_FINGER_LENGTH
                      - FRANKA_FINGERPAD_LENGTH * 0.5]))
        pad_mid = 0.5 * (out.body_pos[:, self.lf_body]
                         + out.body_pos[:, self.rf_body]) + pad_off
        finger_nut_dist = torch.linalg.vector_norm(pad_mid - nut_pos, dim=-1)
        ft_down = maths.quat_apply(ft_quat, -up)
        finger_nut_kp_dist = axis_kp_dist(pad_mid, pad_mid + ft_down,
                                          nut_pos, nut_axis)
        action_penalty = torch.linalg.vector_norm(actions, dim=-1)
        success = dist_to_target < THREAD_PITCH
        reward = -(nut_kp_dist + finger_nut_kp_dist) \
            * self.cfg_rl["keypoint_reward_scale"] \
            - action_penalty * self.cfg_rl["action_penalty_scale"] \
            + success.to(DTYPE) * self.cfg_rl["success_bonus"]
        expired = state.progress >= self.max_episode_length - 1
        far = dist_to_target > self.cfg_rl["far_error_thresh"]
        slipped = finger_nut_dist > (FRANKA_FINGERPAD_LENGTH * 0.5
                                     + NUT_HEIGHT * 0.5)
        reset = (success | expired | (far & ~success)
                 | (slipped & ~success)).to(torch.int32)
        obs = torch.cat([
            ft_pos, ft_quat, ft_lin, ft_ang,
            nut_pos, nut_quat, nut_vel[:, 3:6], nut_vel[:, 0:3],
            out.sensor_forces[:, 0, 0:3], out.sensor_forces[:, 1, 0:3]], -1)
        task = task._replace(actions=actions,
                             lift_success=success.to(DTYPE))
        extras = {"successes": success.to(DTYPE).mean()}
        return obs, None, reward, reset, task, extras


TASK_CFGS = {
    "FactoryTaskNutBoltPick": TASK_CFG_PICK,
    "FactoryTaskNutBoltPlace": TASK_CFG_PLACE,
    "FactoryTaskNutBoltScrew": TASK_CFG_SCREW,
}


# ---------------------------------------------------------------------------
# Gears / Insertion: the reference's policy-less scene playgrounds (their
# reward and reset hooks are no-ops)
TASK_CFG_GEARS = _base_cfg("FactoryTaskGears", 32, 12, 1024)
TASK_CFG_INSERT = _base_cfg("FactoryTaskInsertion", 32, 12, 1024)
for _c in (TASK_CFG_GEARS, TASK_CFG_INSERT):
    _c["ctrl"]["all"] = {"jacobian_type": "geometric",
                         "gripper_prop_gains": [500.0, 500.0],
                         "gripper_deriv_gains": [2.0, 2.0]}


class FactoryTaskGears(FactoryBase):
    """Gear-assembly scene (factory_task_gears.py): a base plate with two
    shafts, the medium gear as the free body (a box contact proxy)."""

    def _extra_parts(self):
        bb = ModelBuilder()
        bb.begin_actor()
        base = bb.add_body("gear_base", -1, FIXED,
                           body_pos=(0.0, 0.0, TABLE_HEIGHT))
        bb.add_geom(base, GEOM_BOX, np.array([0.05, 0.03, 0.0025]),
                    pos=np.array([0, 0, 0.0025]), name="gear_base_geom")
        for i, dx in enumerate((-0.025, 0.025)):
            bb.add_geom(base, GEOM_CYLINDER, np.array([0.003, 0.025, 0]),
                        pos=np.array([dx, 0, 0.03]), contact=False,
                        name=f"shaft{i}")
        ob = ModelBuilder()
        ob.begin_actor()
        gear = ob.add_body("nut", -1, FREE,   # the manipulated object slot
                           body_pos=(0.0, -0.2, TABLE_HEIGHT + 0.01))
        ob.add_geom(gear, GEOM_BOX, np.array([0.035, 0.035, 0.01]),
                    density=1200.0, friction=0.8, name="nut_geom")
        return [(bb.finalize(), (0, 0, 0), (0, 0, 0, 1)),
                (ob.finalize(), (0, 0, 0), (0, 0, 0, 1))]

    def draw_objects(self):
        """The object's xy U(-1, 1) (N, 2)."""
        return (2.0 * torch.rand((self.num_envs, 2), generator=self.generator,
                                 device=self.device) - 1.0,)

    def _reset_objects(self, sim, mask, draws):
        n = self.num_envs
        kw = dict(dtype=DTYPE, device=self.device)
        xy = self._c([0.0, -0.2]) + 0.05 * draws[0]
        pose = torch.cat([xy, torch.full((n, 1), TABLE_HEIGHT + 0.012, **kw),
                          self._ident.expand(n, 4)], -1)
        return self._set_nut_pose(sim, mask, pose)

    def post_physics(self, state: EnvState, out, actions):
        n = self.num_envs
        ft_pos, ft_quat, ft_lin, ft_ang = self._fingertip_state(out)
        obj = out.root_states[:, 2]
        obs = torch.cat([ft_pos, ft_quat, ft_lin, ft_ang, obj[:, 0:13]], -1)
        obs = torch.nn.functional.pad(obs, (0, self.num_obs - obs.shape[-1]))
        reward = torch.zeros(n, dtype=DTYPE, device=self.device)
        reset = (state.progress >= self.max_episode_length - 1).to(
            torch.int32)
        task = state.task._replace(actions=actions)
        return obs, None, reward, reset, task, {}


class FactoryTaskInsertion(FactoryTaskGears):
    """Peg-in-hole scene (factory_task_insertion.py): a round peg (a box
    proxy) as the free body, the socket fixed on the table."""

    def _extra_parts(self):
        bb = ModelBuilder()
        bb.begin_actor()
        sock = bb.add_body("socket", -1, FIXED,
                           body_pos=(0.0, 0.0, TABLE_HEIGHT))
        bb.add_geom(sock, GEOM_BOX, np.array([0.015, 0.015, 0.0125]),
                    pos=np.array([0, 0, 0.0125]), name="socket_geom")
        ob = ModelBuilder()
        ob.begin_actor()
        peg = ob.add_body("nut", -1, FREE,
                          body_pos=(0.0, -0.2, TABLE_HEIGHT + 0.025))
        ob.add_geom(peg, GEOM_BOX, np.array([0.004, 0.004, 0.025]),
                    density=7850.0, friction=0.8, name="nut_geom")
        return [(bb.finalize(), (0, 0, 0), (0, 0, 0, 1)),
                (ob.finalize(), (0, 0, 0), (0, 0, 0, 1))]


TASK_CFGS.update({
    "FactoryTaskGears": TASK_CFG_GEARS,
    "FactoryTaskInsertion": TASK_CFG_INSERT,
})
