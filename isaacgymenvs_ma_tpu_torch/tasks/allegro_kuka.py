"""AllegroKuka family (port of isaacgymenvs_ma_tpu/tasks/allegro_kuka.py):
the Reorientation, Regrasping and Throw subtasks on a KUKA iiwa7 with an
Allegro hand, and the TwoArms Reorientation and Regrasping, picked by
``env.subtask`` through :func:`resolve_allegro_kuka` /
:func:`resolve_allegro_kuka_two_arms`.  Obs 117 / act 23 at one arm, obs
204 / act 46 at two, 8192 envs.

* Control: position drives; the arm's targets integrate ``dofSpeedScale *
  dt * action``, the hand's are scaled absolute positions with an action
  moving average.  A random decaying force on the object (and, with
  ``privilegedActions``, a torque from three extra actions) goes through
  ``Control.f_ext``.
* The cuboid's size per env: the catalog of the reference's procedural
  cuboid sweep, shuffled by ``np.random.default_rng(42)`` and dealt round
  robin over the envs, rides as ``PhysScales.shape`` on the object body;
  the engine scales its inertia (kernel B2), gravity wrench (B3) and
  contact rows with it, and the keypoints and obs carry the same sizes.
* Reward: fingertip-delta before the lift, lifting reward and one-time
  bonus, keypoint-delta after, arm and hand velocity penalties and the
  near-goal bonus; a success resamples the goal on the next step (and, in
  Regrasping and Throw, puts the object back) and restarts the episode
  clock (``extras["_reset_progress_mask"]``, read by ``VecTaskBase.step``).
* The success-tolerance curriculum lives in the task state (scalars on
  the device), and ``get_env_state`` / ``set_env_state`` carry it through
  a checkpoint; ``extras["true_objective"]`` is the DexPBT objective.

Draws come from the task's generator or are given to ``step``: the reset
draws (:meth:`AllegroKukaBase.draw_reset`) as ``reset_draws`` and the
force draws of ``pre_physics`` (:meth:`AllegroKukaBase.draw_pre`) as
``pre_draws``.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..models.model import (DRIVE_POS, FIXED, FREE, GEOM_BOX, GEOM_SPHERE,
                            Geom, ModelBuilder, compose_scene,
                            model_from_spec)
from ..models.specs.kuka_allegro import SPEC
from ..ops import maths
from ..physics.engine import Control, PhysicsEngine, SimState
from ..utils.domain_rand import PhysScales
from .base import EnvState, VecTaskBase, masked_update

ARM_POS = np.array([0.0, 0.8, 0.0], np.float32)
TABLE_POS = ARM_POS + np.array([0.0, -0.8, 0.38], np.float32)
TABLE_SIZE = np.array([0.475, 0.4, 0.3], np.float32)   # table_narrow.urdf
OBJ_START = ARM_POS + np.array([0.0, -0.8, 0.63], np.float32)
KUKA_DEFAULT = np.array([-1.571, 1.571, 0.0, 1.376, 0.0, 1.485, 2.358],
                        np.float32)
FINGERTIPS = ["index_link_3", "middle_link_3", "ring_link_3", "thumb_link_3"]
FINGERTIP_OFFSETS = np.array([[0.05, 0.005, 0]] * 3 + [[0.06, 0.005, 0]],
                             np.float32)
PALM_OFFSET = np.array([-0.00, -0.02, 0.16], np.float32)
PALM_BODY = "iiwa7_link_7"
# target volume (ref allegro_kuka_base.py:302-304)
TARGET_ORIGIN = np.array([0.0, 0.05, 0.8], np.float32)
TARGET_EXTENT = np.array([[-0.4, 0.4], [-0.05, 0.3], [-0.12, 0.25]],
                         np.float32)

TASK_CFG = {
    "name": "AllegroKuka",
    "physics_engine": "physx",
    "env": {
        "subtask": "reorientation",
        "numEnvs": 8192,
        "envSpacing": 1.2,
        "episodeLength": 600,
        "clampAbsObservations": 10.0,
        "useRelativeControl": False,
        "dofSpeedScale": 10.0,
        "actionsMovingAverage": 1.0,
        "controlFrequencyInv": 1,
        "resetPositionNoiseX": 0.1,
        "resetPositionNoiseY": 0.1,
        "resetPositionNoiseZ": 0.02,
        "resetRotationNoise": 1.0,
        "resetDofPosRandomIntervalFingers": 0.1,
        "resetDofPosRandomIntervalArm": 0.1,
        "resetDofVelRandomInterval": 0.5,
        "forceScale": 2.0,
        "forceProbRange": [0.001, 0.1],
        "forceDecay": 0.99,
        "forceDecayInterval": 0.08,
        "liftingRewScale": 20.0,
        "liftingBonus": 300.0,
        "liftingBonusThreshold": 0.15,
        "keypointRewScale": 200.0,
        "distanceDeltaRewScale": 50.0,
        "reachGoalBonus": 1000.0,
        "kukaActionsPenaltyScale": 0.003,
        "allegroActionsPenaltyScale": 0.0003,
        "fallDistance": 0.24,
        "fallPenalty": 0.0,
        "privilegedActions": False,
        "privilegedActionsTorque": 0.02,
        "allegroStiffness": 40.0,
        "kukaStiffness": 40.0,
        "allegroDamping": 5.0,
        "kukaDamping": 5.0,
        "keypointScale": 1.5,
        "objectBaseSize": 0.05,
        "objectType": "block",
        "observationType": "full_state",
        "successTolerance": 0.075,
        "targetSuccessTolerance": 0.01,
        "toleranceCurriculumIncrement": 0.9,
        "toleranceCurriculumInterval": 3000,
        "maxConsecutiveSuccesses": 50,
        "successSteps": 1,
    },
    "sim": {
        "dt": 0.01667, "substeps": 2, "up_axis": "z",
        "gravity": [0.0, 0.0, -9.81],
        # 34 candidate rows (21 plane + 13 pair) compacted to the deepest
        # 16, reused across the substeps
        "physx": {"num_position_iterations": 8, "num_velocity_iterations": 0,
                  "contact_capacity": 16, "reuse_contact_rows": True,
                  "max_depenetration_velocity": 1000.0},
    },
    "task": {"randomize": False, "randomization_params": {}},
}


class KukaTaskState(NamedTuple):
    goal_pose: torch.Tensor               # (N, 7)
    successes: torch.Tensor               # (N,)
    prev_episode_successes: torch.Tensor  # (N,)
    near_goal_steps: torch.Tensor         # (N,) int32
    goal_reset: torch.Tensor              # (N,) int32: new goal next step
    lifted_object: torch.Tensor           # (N,) bool
    closest_keypoint_max_dist: torch.Tensor  # (N,) (-1 = not yet)
    closest_fingertip_dist: torch.Tensor  # (N, F)
    furthest_hand_dist: torch.Tensor      # (N,)
    prev_targets: torch.Tensor            # (N, nd)
    rb_force: torch.Tensor                # (N, 3) decaying object force
    force_prob: torch.Tensor              # (N,)
    success_tolerance: torch.Tensor       # ()
    last_curriculum_update: torch.Tensor  # ()
    frames: torch.Tensor                  # ()
    prev_rew: torch.Tensor                # (N,) reward obs


def cuboid_scale_catalog(small=True, big=True, sticks=True):
    """Per-axis scale catalog of the reference's procedural cuboid sweep
    (generate_cuboids.py:96-131): percent scales filtered by relative
    volume and the thin-plate / non-elongated aspect rules."""
    def thin(s):
        s = sorted(s)
        return s[0] * 3 <= s[1]

    def not_elongated(s):
        s = sorted(s)
        return s[2] <= s[0] * 3 or s[2] <= s[1] * 3

    def gen(scales, vmin, vmax, filters):
        out = []
        for x in scales:
            for y in scales:
                for z in scales:
                    v = x * y * z / 1e6
                    if v < vmin or v > vmax:
                        continue
                    if any(f([x, y, z]) for f in filters):
                        continue
                    out.append((x / 100.0, y / 100.0, z / 100.0))
        return out

    cat = [(1.0, 1.0, 1.0)]
    if small:
        cat += gen([100, 50, 66, 75, 90, 110, 125, 150, 175, 200, 250,
                    300], 1.0, 2.5, [])
    if big:
        cat += gen([100, 125, 150, 200, 250, 300, 350], 2.5, 15.0, [thin])
    if sticks:
        cat += gen([100, 50, 75, 200, 300, 400, 500, 600], 2.5, 6.0,
                   [thin, not_elongated])
    return cat


def random_quat(u):
    """Uniform random unit quaternions from U[0, 1) draws (N, 3)."""
    s0, s1 = torch.sqrt(1 - u[:, 0]), torch.sqrt(u[:, 0])
    a, b = 2 * np.pi * u[:, 1], 2 * np.pi * u[:, 2]
    return torch.stack([s0 * torch.cos(a), s1 * torch.sin(b),
                        s1 * torch.cos(b), s0 * torch.sin(a)], -1)


class AllegroKukaBase(VecTaskBase):
    """Single-arm base; the subtasks set the keypoints and goal sampler."""

    num_arms = 1
    num_fingertips = 4
    # whether a goal reset also puts the object back on the table
    reset_object_on_goal_reset = False

    def _keypoint_offsets_unit(self):
        raise NotImplementedError

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        e = cfg["env"]
        self.num_arm_dofs = 7
        self.num_hand_dofs = 16
        self.nd = (self.num_arm_dofs + self.num_hand_dofs) * self.num_arms
        self.privileged_actions = bool(e.get("privilegedActions", False))
        self.privileged_torque = float(e.get("privilegedActionsTorque", 0.02))
        self.kp_scale = float(e.get("keypointScale", 1.5))
        self.object_size = float(e.get("objectBaseSize", 0.05))
        offs = np.asarray(self._keypoint_offsets_unit(), np.float32)
        self.keypoint_offsets = offs * self.object_size / 2 * self.kp_scale
        self.num_keypoints = len(offs)
        F = self.num_fingertips * self.num_arms
        self.full_state_size = (
            2 * self.nd + (3 + 10) * self.num_arms + 10 + 3 * F
            + self.num_keypoints * 3 * self.num_arms + self.num_keypoints * 3
            + 3 + 1 + 1 + 2 + F + 1)
        e["numObservations"] = self.full_state_size
        e["numActions"] = self.nd + (3 if self.privileged_actions else 0)
        e["numStates"] = 0
        e["clipObservations"] = float(e.get("clampAbsObservations", 10.0))
        self.dof_speed_scale = float(e.get("dofSpeedScale", 10.0))
        self.act_avg = float(e.get("actionsMovingAverage", 1.0))
        self.lifting_rew_scale = float(e.get("liftingRewScale", 20.0))
        self.lifting_bonus = float(e.get("liftingBonus", 300.0))
        self.lifting_threshold = float(e.get("liftingBonusThreshold", 0.15))
        self.keypoint_rew_scale = float(e.get("keypointRewScale", 200.0))
        self.dist_delta_scale = float(e.get("distanceDeltaRewScale", 50.0))
        self.reach_goal_bonus = float(e.get("reachGoalBonus", 1000.0))
        self.kuka_pen = float(e.get("kukaActionsPenaltyScale", 0.003))
        self.allegro_pen = float(e.get("allegroActionsPenaltyScale", 0.0003))
        self.initial_tolerance = float(e.get("successTolerance", 0.075))
        self.target_tolerance = float(e.get("targetSuccessTolerance", 0.01))
        self.tol_increment = float(e.get("toleranceCurriculumIncrement", 0.9))
        self.tol_interval = int(e.get("toleranceCurriculumInterval", 3000))
        self.max_consecutive = int(e.get("maxConsecutiveSuccesses", 50))
        self.success_steps = int(e.get("successSteps", 1))
        self.force_scale = float(e.get("forceScale", 0.0))
        self.force_prob_range = tuple(e.get("forceProbRange", [0.001, 0.1]))
        self.force_decay = float(e.get("forceDecay", 0.99))
        self.force_decay_interval = float(e.get("forceDecayInterval", 0.08))
        self.reset_noise_fingers = float(
            e.get("resetDofPosRandomIntervalFingers", 0.1))
        self.reset_noise_arm = float(
            e.get("resetDofPosRandomIntervalArm", 0.1))
        self.reset_vel_noise = float(e.get("resetDofVelRandomInterval", 0.5))
        self.reset_pos_noise = np.array([
            float(e.get("resetPositionNoiseX", 0.1)),
            float(e.get("resetPositionNoiseY", 0.1)),
            float(e.get("resetPositionNoiseZ", 0.02))], np.float32)
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)

        m = self.model
        dev = self.device
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=dev)
        idx = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.int64), device=dev)
        self.object_body = m.body_names.index("object")
        self.obj_qa = int(m.q_adr[self.object_body])
        self.obj_va = int(m.v_adr[self.object_body])
        self.obj_mass = float(np.asarray(m.mass)[self.object_body])
        # per-env cuboid sizes: the reference generates one URDF per size
        # and deals them round robin over the envs (allegro_kuka_base.py:
        # 414-428); here they are per-env PhysScales.shape leaves
        self.randomize_object_dims = bool(
            e.get("randomizeObjectDimensions", True))
        if self.randomize_object_dims:
            cat = cuboid_scale_catalog(
                small=bool(e.get("withSmallCuboids", True)),
                big=bool(e.get("withBigCuboids", True)),
                sticks=bool(e.get("withSticks", True)))
            rng = np.random.default_rng(42)
            rng.shuffle(cat)
            sel = (np.arange(self.num_envs) + self.env_offset) % len(cat)
            self.object_scales_np = np.asarray(cat, np.float32)[sel]
        else:
            self.object_scales_np = np.ones((self.num_envs, 3), np.float32)
        self.object_scales = f32(self.object_scales_np)
        self.palm_bodies = np.asarray(
            [i for i, n in enumerate(m.body_names) if n.endswith(PALM_BODY)],
            np.int64)
        self.fingertip_bodies = np.asarray(
            [i for i, n in enumerate(m.body_names)
             if any(n.endswith(f) for f in FINGERTIPS)], np.int64)
        self.ctl_dofs = np.asarray(self.engine.scalar_dofs[: self.nd])
        dl = np.asarray(m.dof_lower)[self.ctl_dofs]
        du = np.asarray(m.dof_upper)[self.ctl_dofs]
        self.dof_lower, self.dof_upper = f32(dl), f32(du)
        dd = np.tile(np.concatenate([KUKA_DEFAULT, np.zeros(16, np.float32)]),
                     self.num_arms)
        self.default_dof = f32(np.clip(dd, dl, du))
        # the control dofs of each arm: 7 arm joints, then 16 hand joints
        na = self.num_arm_dofs + self.num_hand_dofs
        is_hand = (np.arange(self.nd) % na) >= self.num_arm_dofs
        # the step's constants and index tensors, on the device once
        self._is_hand = torch.as_tensor(is_hand, device=dev)
        self._arm_idx_t = idx(np.nonzero(~is_hand)[0])
        self._hand_idx_t = idx(np.nonzero(is_hand)[0])
        self._noise_coeff = f32(np.where(is_hand, self.reset_noise_fingers,
                                         self.reset_noise_arm))
        self._ctl_dofs_t = idx(self.ctl_dofs)
        self._palm_bodies_t = idx(self.palm_bodies)
        self._fingertip_bodies_t = idx(self.fingertip_bodies)
        self._palm_offset = f32(PALM_OFFSET)
        self._ft_offsets = f32(np.tile(FINGERTIP_OFFSETS, (self.num_arms, 1)))
        self._kp_offsets = f32(self.keypoint_offsets)
        self._obj_start = f32(self._object_start())
        self._reset_pos_noise = f32(self.reset_pos_noise)
        self._target_lo = f32(TARGET_ORIGIN + TARGET_EXTENT[:, 0])
        self._target_size = f32(TARGET_EXTENT[:, 1] - TARGET_EXTENT[:, 0])
        self._ident = f32([0.0, 0.0, 0.0, 1.0])

    # ------------------------------------------------------------------
    def initial_phys(self):
        """The randomizer's scales (or ones) with the object's per-env
        cuboid sizes as its shape scale (allegro_kuka.py:302-311)."""
        phys = super().initial_phys()
        if not self.randomize_object_dims:
            return phys
        if phys is None:
            phys = PhysScales.ones(self.num_envs, self.device)
        shape = np.ones((self.num_envs, self.model.nb, 3), np.float32)
        shape[:, self.object_body] = self.object_scales_np
        return phys._replace(shape=torch.as_tensor(shape, device=self.device))

    def _arm_poses(self):
        return [(ARM_POS, (0.0, 0.0, 0.0, 1.0))]

    def _object_start(self):
        return OBJ_START

    def create_model(self):
        e = self.cfg["env"]
        arms = []
        for ai, (pos, quat) in enumerate(self._arm_poses()):
            arm = model_from_spec(copy.deepcopy(SPEC))
            if self.num_arms > 1:
                arm.body_names = [f"arm{ai}_{n}" for n in arm.body_names]
            for d in range(arm.nv):
                arm.dof_drive_mode[d] = DRIVE_POS
                is_arm = d < self.num_arm_dofs
                arm.dof_stiffness[d] = float(
                    e.get("kukaStiffness", 40.0) if is_arm
                    else e.get("allegroStiffness", 40.0))
                arm.dof_drive_damping[d] = float(
                    e.get("kukaDamping", 5.0) if is_arm
                    else e.get("allegroDamping", 5.0))
            # fingertip and palm contact spheres (the meshes approximated)
            for f, off in zip(FINGERTIPS, FINGERTIP_OFFSETS):
                b = arm.body_names.index(
                    f"arm{ai}_{f}" if self.num_arms > 1 else f)
                arm.geoms.append(Geom(
                    body=b, gtype=GEOM_SPHERE, size=np.array([0.012, 0, 0]),
                    pos=off.copy(), quat=np.array([0.0, 0, 0, 1]),
                    friction=1.0, contact=True, name=f"tip{ai}_{f}"))
            pb = arm.body_names.index(
                f"arm{ai}_{PALM_BODY}" if self.num_arms > 1 else PALM_BODY)
            arm.geoms.append(Geom(
                body=pb, gtype=GEOM_SPHERE, size=np.array([0.04, 0, 0]),
                pos=PALM_OFFSET.copy(), quat=np.array([0.0, 0, 0, 1]),
                friction=1.0, contact=True, name=f"palm{ai}"))
            arms.append((arm, tuple(pos), tuple(quat)))
        tb = ModelBuilder()
        tb.begin_actor()
        tbody = tb.add_body("table", -1, FIXED, body_pos=TABLE_POS)
        tb.add_geom(tbody, GEOM_BOX, TABLE_SIZE / 2, name="table_top")
        ob = ModelBuilder()
        ob.begin_actor()
        obj = ob.add_body("object", -1, FREE, body_pos=self._object_start())
        # cube_multicolor 0.05 m
        ob.add_geom(obj, GEOM_BOX, np.full(3, self.object_size / 2),
                    density=400.0, name="object_geom")
        model = compose_scene(
            arms + [(tb.finalize(), (0, 0, 0), (0, 0, 0, 1)),
                    (ob.finalize(), (0, 0, 0), (0, 0, 0, 1))])
        return model, True

    def build_engine(self, model, ground):
        names = [g.name for g in model.geoms]
        obj_geom = names.index("object_geom")
        pairs = [(i, obj_geom) for i, n in enumerate(names)
                 if n.startswith("tip") or n.startswith("palm")]
        pairs.append((obj_geom, names.index("table_top")))
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=pairs, device=self.device)

    # ------------------------------------------------------------------
    def initial_task_state(self):
        n = self.num_envs
        F = self.num_fingertips * self.num_arms
        kw = dict(dtype=DTYPE, device=self.device)
        zi = torch.zeros(n, dtype=torch.int32, device=self.device)
        goal = torch.as_tensor(np.concatenate(
            [TARGET_ORIGIN, [0, 0, 0, 1.0]]).astype(np.float32), **kw)
        return KukaTaskState(
            goal_pose=goal.repeat(n, 1),
            successes=torch.zeros(n, **kw),
            prev_episode_successes=torch.zeros(n, **kw),
            near_goal_steps=zi, goal_reset=zi.clone(),
            lifted_object=torch.zeros(n, dtype=torch.bool,
                                      device=self.device),
            closest_keypoint_max_dist=-torch.ones(n, **kw),
            closest_fingertip_dist=-torch.ones((n, F), **kw),
            furthest_hand_dist=-torch.ones(n, **kw),
            prev_targets=self.default_dof.repeat(n, 1),
            rb_force=torch.zeros((n, 3), **kw),
            force_prob=torch.full((n,), 0.01, **kw),
            success_tolerance=torch.tensor(self.initial_tolerance, **kw),
            last_curriculum_update=torch.zeros((), **kw),
            frames=torch.zeros((), **kw),
            prev_rew=torch.zeros(n, **kw))

    # -- draws -----------------------------------------------------------
    def _draw_goal(self, u):
        """The goal draws (allegro_kuka.py:408-414): the position's and
        the quaternion's U[0, 1) (N, 3) each."""
        n = self.num_envs
        return u(n, 3), u(n, 3)

    def draw_reset(self):
        """Every reset draw, in the JAX key order (allegro_kuka.py:
        419-487): the goal's (:meth:`_draw_goal`), the dof positions'
        U[0, 1) and velocities' U[-1, 1) (N, nd), the object's position
        noise U[-1, 1) (N, 3) and quaternion U[0, 1) (N, 3), and the force
        probability's U[0, 1) (N,)."""
        n, nd, g = self.num_envs, self.nd, self.generator
        kw = dict(generator=g, device=g.device, dtype=DTYPE)
        u = lambda *s: torch.rand(s, **kw)  # noqa: E731
        goal_pos_u, goal_quat_u = self._draw_goal(u)
        return (goal_pos_u, goal_quat_u, u(n, nd), 2 * u(n, nd) - 1,
                2 * u(n, 3) - 1, u(n, 3), u(n))

    def draw_pre(self):
        """``pre_physics``'s draws (allegro_kuka.py:516-523): the force
        trigger's U[0, 1) (N,) and the new force's N(0, 1) (N, 3)."""
        g = self.generator
        kw = dict(generator=g, device=g.device, dtype=DTYPE)
        return (torch.rand((self.num_envs,), **kw),
                torch.randn((self.num_envs, 3), **kw))

    def _sample_target(self, goal_pos_u, goal_quat_u):
        """Default: a random pose in the target volume (reorientation)."""
        pos = self._target_lo + goal_pos_u * self._target_size
        return torch.cat([pos, random_quat(goal_quat_u)], -1)

    # ------------------------------------------------------------------
    def reset_idx(self, sim: SimState, task: KukaTaskState, mask,
                  draws=None):
        n, nd = self.num_envs, self.nd
        draws = self.draw_reset() if draws is None else draws
        goal_pos_u, goal_quat_u, dof_u, dvel_u, opos_u, oquat_u, fp_u = draws
        # goal-only resets (deferred from last step's success, ref
        # :1363-1367)
        goal_mask = (task.goal_reset > 0) | mask
        goal_pose = masked_update(goal_mask,
                                  self._sample_target(goal_pos_u, goal_quat_u),
                                  task.goal_pose)

        # full env reset: arm and hand dofs at default plus noise
        delta_min = self.dof_lower - self.default_dof
        delta_max = self.dof_upper - self.default_dof
        dof = self.default_dof + self._noise_coeff * (
            delta_min + (delta_max - delta_min) * dof_u)
        dvel = self.reset_vel_noise * dvel_u
        full_pos = self.engine.dof_pos(sim).clone()
        full_pos[:, :nd] = masked_update(mask, dof, full_pos[:, :nd])
        sim = self.engine.set_dof_pos(sim, full_pos)
        full_vel = self.engine.dof_vel(sim).clone()
        full_vel[:, :nd] = masked_update(mask, dvel, full_vel[:, :nd])
        sim = self.engine.set_dof_vel(sim, full_vel)

        # object pose: start plus noise (also on a goal reset in the
        # subtasks that put the object back)
        obj_mask = (mask | goal_mask) if self.reset_object_on_goal_reset \
            else mask
        pos = self._obj_start + self._reset_pos_noise * opos_u
        opose = torch.cat([pos, random_quat(oquat_u)], -1)
        qa, va = self.obj_qa, self.obj_va
        q, qd = sim.q.clone(), sim.qd.clone()
        q[:, qa: qa + 7] = masked_update(obj_mask, opose, q[:, qa: qa + 7])
        qd[:, va: va + 6] = masked_update(
            obj_mask, torch.zeros_like(qd[:, va: va + 6]), qd[:, va: va + 6])
        sim = SimState(q, qd)

        lo = np.log(self.force_prob_range[0])
        hi = np.log(self.force_prob_range[1])
        fp = torch.exp(float(lo - hi) * fp_u + float(hi))
        task = task._replace(
            goal_pose=goal_pose,
            prev_episode_successes=torch.where(mask, task.successes,
                                               task.prev_episode_successes),
            successes=torch.where(mask, 0.0, task.successes),
            near_goal_steps=torch.where(goal_mask, 0, task.near_goal_steps
                                        ).to(torch.int32),
            goal_reset=torch.zeros_like(task.goal_reset),
            lifted_object=task.lifted_object & ~obj_mask,
            closest_keypoint_max_dist=torch.where(
                goal_mask, -1.0, task.closest_keypoint_max_dist),
            closest_fingertip_dist=torch.where(
                mask[:, None], -1.0, task.closest_fingertip_dist),
            furthest_hand_dist=torch.where(mask, -1.0,
                                           task.furthest_hand_dist),
            prev_targets=masked_update(mask, dof, task.prev_targets),
            rb_force=torch.where(mask[:, None], 0.0, task.rb_force),
            force_prob=torch.where(mask, fp, task.force_prob),
            prev_rew=torch.where(mask, 0.0, task.prev_rew))
        return sim, task

    def pre_physics(self, state: EnvState, actions, draws=None) -> Control:
        n, nv = self.num_envs, self.engine.nv
        task: KukaTaskState = state.task
        if self.privileged_actions:
            torque_actions = actions[:, :3] * self.privileged_torque
            actions = actions[:, 3:]
        else:
            torque_actions = None
        prev = task.prev_targets
        lo, hi = self.dof_lower, self.dof_upper
        # the hand: scaled absolute targets with a moving average; the
        # arm: targets integrated from the previous ones
        hand = maths.scale(actions, lo, hi)
        hand = self.act_avg * hand + (1.0 - self.act_avg) * prev
        arm = prev + self.dof_speed_scale * self.dt * actions
        cur = torch.clamp(torch.where(self._is_hand, hand, arm), lo, hi)
        self._new_targets = cur
        kw = dict(dtype=DTYPE, device=self.device)
        pos_target = torch.zeros((n, nv), **kw)
        pos_target[:, self._ctl_dofs_t] = cur

        # random decaying object forces (ref :1402-1415) and privileged
        # torques
        f_ext = None
        if self.force_scale > 0.0 or torque_actions is not None:
            fire_u, force_n = self.draw_pre() if draws is None else draws
            force = task.rb_force * self.force_decay ** (
                self.dt / self.force_decay_interval)
            fire = fire_u < task.force_prob
            new_force = force_n * self.obj_mass * self.force_scale
            force = torch.where(fire[:, None], new_force, force)
            self._task_force = force
            f_ext = torch.zeros((n, self.model.nb, 6), **kw)
            f_ext[:, self.object_body, 3:6] = force
            if torque_actions is not None:
                f_ext[:, self.object_body, 0:3] = torque_actions
        else:
            self._task_force = task.rb_force
        return Control(tau=torch.zeros((n, nv), **kw), pos_target=pos_target,
                       vel_target=torch.zeros((n, nv), **kw), f_ext=f_ext)

    def _true_objective(self, task, successes):
        """tolerance_successes_objective (allegro_kuka_utils.py:128-158)."""
        span = self.initial_tolerance - self.target_tolerance
        tol_obj = ((self.initial_tolerance - task.success_tolerance) / span
                   if span > 0 else 1.0)
        above = task.success_tolerance > self.target_tolerance
        return torch.where(above, successes * 0.01 + tol_obj,
                           successes + tol_obj)

    def post_physics(self, state: EnvState, out, actions):
        n, A = self.num_envs, self.num_arms
        task: KukaTaskState = state.task
        fdt = lambda b: b.to(DTYPE)  # noqa: E731
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)  # noqa: E731
        obj = out.root_states[:, A + 1]
        obj_pos, obj_rot = obj[:, 0:3], obj[:, 3:7]

        palm_pos = out.body_pos[:, self._palm_bodies_t]      # (N, A, 3)
        palm_rot = out.body_quat[:, self._palm_bodies_t]
        palm_center = palm_pos + maths.quat_apply(palm_rot, self._palm_offset)
        ft_pos = out.body_pos[:, self._fingertip_bodies_t]
        ft_rot = out.body_quat[:, self._fingertip_bodies_t]
        ft_tip = ft_pos + maths.quat_apply(ft_rot, self._ft_offsets)
        curr_ft_dist = norm(ft_tip - obj_pos[:, None, :])
        closest_ft = torch.where(task.closest_fingertip_dist < 0.0,
                                 curr_ft_dist, task.closest_fingertip_dist)
        furthest_hand = torch.where(task.furthest_hand_dist < 0.0,
                                    curr_ft_dist[:, 0],
                                    task.furthest_hand_dist)

        kp_off = self._kp_offsets
        if self.randomize_object_dims:
            # keypoints on the object's (per-env scaled) surface
            kp_off = kp_off[None] * self.object_scales[:, None, :]
        kp_obj = obj_pos[:, None, :] + maths.quat_apply(
            obj_rot[:, None, :], kp_off)
        kp_goal = task.goal_pose[:, None, 0:3] + maths.quat_apply(
            task.goal_pose[:, None, 3:7], kp_off)
        kp_rel_goal = kp_obj - kp_goal
        kp_max_dist = norm(kp_rel_goal).amax(-1)
        closest_kp = torch.where(task.closest_keypoint_max_dist < 0.0,
                                 kp_max_dist, task.closest_keypoint_max_dist)

        # ---- reward (ref compute_kuka_reward :854-930)
        z_lift = 0.05 + obj_pos[:, 2] - self._obj_start[2]
        lifting_rew = torch.clamp(z_lift, 0.0, 0.5)
        lifted = (z_lift > self.lifting_threshold) | task.lifted_object
        just_lifted = lifted & ~task.lifted_object
        lift_bonus = self.lifting_bonus * fdt(just_lifted)
        lifting_rew = lifting_rew * fdt(~lifted)

        ft_deltas = torch.clamp(closest_ft - curr_ft_dist, 0.0, 10.0)
        closest_ft = torch.minimum(closest_ft, curr_ft_dist)
        ft_delta_rew = torch.sum(ft_deltas, -1) * fdt(~lifted)
        furthest_hand = torch.maximum(furthest_hand, curr_ft_dist[:, 0])

        kp_deltas = torch.clamp(closest_kp - kp_max_dist, 0.0, 100.0)
        closest_kp = torch.minimum(closest_kp, kp_max_dist)
        keypoint_rew = kp_deltas * fdt(lifted)

        dof_vel = self.engine.dof_vel(state.sim)[:, : self.nd]
        kuka_pen = -torch.sum(torch.abs(dof_vel[:, self._arm_idx_t]), -1) \
            * self.kuka_pen
        allegro_pen = -torch.sum(torch.abs(dof_vel[:, self._hand_idx_t]),
                                 -1) * self.allegro_pen

        tol = task.success_tolerance * self.kp_scale
        near_goal = kp_max_dist <= tol
        near_goal_steps = (task.near_goal_steps + near_goal.to(torch.int32)
                           ).to(torch.int32)
        is_success = near_goal_steps >= self.success_steps
        successes = task.successes + fdt(is_success)
        bonus_rew = fdt(near_goal) * (self.reach_goal_bonus
                                      / self.success_steps)

        reward = (self.dist_delta_scale * ft_delta_rew
                  + self.lifting_rew_scale * lifting_rew + lift_bonus
                  + self.keypoint_rew_scale * keypoint_rew
                  + kuka_pen + allegro_pen + bonus_rew)

        # ---- resets (ref _compute_resets :841-849); a success restarts
        # the episode clock through the base step's hook
        fell = obj_pos[:, 2] < 0.1
        progress = torch.where(is_success, 0, state.progress)
        reset = fell | (successes >= self.max_consecutive) | (
            progress >= self.max_episode_length - 1)
        reset = (reset | self._extra_reset_rules(curr_ft_dist)).to(
            torch.int32)

        # ---- curriculum (allegro_kuka_utils.py tolerance_curriculum)
        frames = task.frames + 1.0
        due = (frames - task.last_curriculum_update) >= self.tol_interval
        good = torch.mean(task.prev_episode_successes) >= 3.0
        upd = due & good
        new_tol = torch.clamp(task.success_tolerance * self.tol_increment,
                              self.target_tolerance, self.initial_tolerance)
        success_tolerance = torch.where(upd, new_tol, task.success_tolerance)
        last_update = torch.where(upd, frames, task.last_curriculum_update)

        # ---- full_state obs (ref compute_full_state :1091-1172)
        dof_pos = self.engine.dof_pos(state.sim)[:, : self.nd]
        palm_states = torch.cat([
            palm_rot, out.body_vel[:, self._palm_bodies_t]], -1)  # (N, A, 10)
        ft_rel_palm = (ft_tip.reshape(n, A, self.num_fingertips, 3)
                       - palm_center[:, :, None, :]).reshape(n, -1)
        kp_rel_palm = (kp_obj[:, None, :, :]
                       - palm_center[:, :, None, :]).reshape(n, -1)
        obs = torch.cat([
            maths.unscale(dof_pos, self.dof_lower, self.dof_upper),
            dof_vel,
            palm_center.reshape(n, -1),
            palm_states.reshape(n, -1),
            torch.cat([obj_rot, obj[:, 7:13]], -1),
            ft_rel_palm,
            kp_rel_palm,
            kp_rel_goal.reshape(n, -1),
            self.object_scales,
            closest_kp[:, None],
            closest_ft,
            fdt(lifted)[:, None],
            torch.log(progress[:, None] / 10.0 + 1.0),
            torch.log(successes[:, None] + 1.0),
            task.prev_rew[:, None],
        ], -1)

        true_obj = self._true_objective(task, successes)
        task = task._replace(
            successes=successes, near_goal_steps=near_goal_steps,
            goal_reset=is_success.to(torch.int32),
            lifted_object=lifted,
            closest_keypoint_max_dist=closest_kp,
            closest_fingertip_dist=closest_ft,
            furthest_hand_dist=furthest_hand,
            prev_targets=self._new_targets,
            rb_force=self._task_force,
            success_tolerance=success_tolerance,
            last_curriculum_update=last_update, frames=frames,
            prev_rew=reward * 0.01)
        extras = {
            "successes": torch.mean(task.prev_episode_successes),
            "true_objective": true_obj,
            "true_objective_mean": torch.mean(true_obj),
            "consecutive_successes": torch.mean(task.prev_episode_successes),
            "_reset_progress_mask": is_success,
        }
        return obs, None, reward, reset, task, extras

    def _extra_reset_rules(self, curr_ft_dist):
        return torch.zeros(curr_ft_dist.shape[0], dtype=torch.bool,
                           device=curr_ft_dist.device)

    def get_env_state(self, state: EnvState):
        """The curriculum's state for a checkpoint (ref :472-493)."""
        return {"success_tolerance": state.task.success_tolerance}

    def set_env_state(self, state: EnvState, env_state):
        if env_state and "success_tolerance" in env_state:
            tol = torch.as_tensor(env_state["success_tolerance"],
                                  dtype=DTYPE).to(self.device)
            return state._replace(task=state.task._replace(
                success_tolerance=tol))
        return state


class AllegroKukaReorientation(AllegroKukaBase):
    """Match the goal cube pose in the air (allegro_kuka_reorientation.py)."""

    def _keypoint_offsets_unit(self):
        return [[1, 1, 1], [1, 1, -1], [-1, -1, 1], [-1, -1, -1]]

    def _extra_reset_rules(self, curr_ft_dist):
        # hand far from the object (ref :152-156)
        return curr_ft_dist.amax(-1) > 1.5


class AllegroKukaRegrasping(AllegroKukaBase):
    """Lift and hold at a target point; the object respawns with each goal
    (allegro_kuka_regrasping.py: one centroid keypoint)."""

    reset_object_on_goal_reset = True

    def _keypoint_offsets_unit(self):
        return [[0, 0, 0]]

    def _sample_target(self, goal_pos_u, goal_quat_u):
        pos = self._target_lo + goal_pos_u * self._target_size
        return torch.cat([pos, self._ident.expand(self.num_envs, 4)], -1)


class AllegroKukaThrow(AllegroKukaBase):
    """Throw the cube into a bucket beside the table (allegro_kuka_throw.py:
    the goal sampled at the bucket's mouth)."""

    reset_object_on_goal_reset = True

    def _keypoint_offsets_unit(self):
        return [[0, 0, 0]]

    def _draw_goal(self, u):
        """The side U[-1, 1), the offset U[0, 0.4), y U[-1, 0.7) and z
        U[0, 1) as (N, 4) (allegro_kuka.py:742-750); the quaternion's
        draws are unused (zeros)."""
        n = self.num_envs
        r = u(n, 4)
        side = torch.cat([2 * r[:, :1] - 1, 0.4 * r[:, 1:2],
                          -1 + 1.7 * r[:, 2:3], r[:, 3:4]], -1)
        return side, torch.zeros_like(r[:, :3])

    def _sample_target(self, goal_pos_u, goal_quat_u):
        lr, off, y, z = goal_pos_u.unbind(-1)
        x = torch.where(lr > 0, 0.5, -0.5) + torch.sign(lr) * off
        pos = torch.stack([x, y, z + 0.05], -1)
        return torch.cat([pos, self._ident.expand(self.num_envs, 4)], -1)


# ---------------------------------------------------------------------------
class AllegroKukaTwoArmsBase(AllegroKukaBase):
    """Two mirrored arms around the table (allegro_kuka_two_arms.py)."""

    num_arms = 2

    def _arm_poses(self):
        # armXOfs=1.1 armYOfs=0.15: the arms straddle the table, facing
        # each other (allegro_kuka_two_arms.py arm placement)
        x, y = 1.1 / 2, 0.15

        def qz(a):
            return (0.0, 0.0, float(np.sin(a / 2)), float(np.cos(a / 2)))

        table_xy = ARM_POS + np.array([0.0, -0.8, 0.0], np.float32)
        return [(table_xy + np.array([-x, y, 0.0], np.float32),
                 qz(-np.pi / 2)),
                (table_xy + np.array([x, y, 0.0], np.float32), qz(np.pi / 2))]

    def _object_start(self):
        return TABLE_POS + np.array([0.0, 0.0, 0.25], np.float32)


class AllegroKukaTwoArmsReorientation(AllegroKukaTwoArmsBase,
                                      AllegroKukaReorientation):
    pass


class AllegroKukaTwoArmsRegrasping(AllegroKukaTwoArmsBase,
                                   AllegroKukaRegrasping):
    pass


SUBTASKS = dict(reorientation=AllegroKukaReorientation,
                regrasping=AllegroKukaRegrasping,
                throw=AllegroKukaThrow)
TWO_ARMS_SUBTASKS = dict(reorientation=AllegroKukaTwoArmsReorientation,
                         regrasping=AllegroKukaTwoArmsRegrasping)


def resolve_allegro_kuka(cfg, device="cuda", seed: int = 0,
                         sim_params=None):
    """Subtask dispatch (reference tasks/__init__.py:65-77)."""
    cls = SUBTASKS[cfg["env"].get("subtask", "reorientation")]
    return cls(cfg, device=device, seed=seed, sim_params=sim_params)


def resolve_allegro_kuka_two_arms(cfg, device="cuda", seed: int = 0,
                                  sim_params=None):
    cls = TWO_ARMS_SUBTASKS[cfg["env"].get("subtask", "reorientation")]
    return cls(cfg, device=device, seed=seed, sim_params=sim_params)
