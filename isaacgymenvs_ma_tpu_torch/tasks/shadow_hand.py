"""ShadowHand in-hand cube reorientation (port of
isaacgymenvs_ma_tpu/tasks/shadow_hand.py): act 20, obs per
``observationType`` (``openai`` 42, ``full_no_vel`` 77, ``full`` 157,
``full_state`` 211), 8192 envs.

* A 24-dof Shadow hand, palm up, holds a cube that must be turned to a
  goal orientation.  Position drives on every hand dof (the MJCF
  actuators' gains and force limits, ``DRIVE_PARAMS``); the four
  tendon-coupled distal joints track their middle joints.  Targets are
  scaled absolute actions with an optional moving average, a scalar or,
  in the ``{range: [lo, hi]}`` form, a static per-env draw.
* Contacts: up to 12 palm, distal and middle geoms against the cube's
  SDF, and the cube's corners against the two palm boxes.  The scene
  splits masses (``physx.mass_splitting``): a pinched cube carries many
  coincident rows, so the engine takes its batched-product loop even
  with ``use_contact_kernel`` (the JAX route rule).
* Reward: -10 x the goal distance + 1 / (|rotation distance| + 0.1), an
  action penalty, a 250 bonus on success (the goal resampled in the same
  step), a fall at 0.24 m; ``maxConsecutiveSuccesses`` resets an env after
  that many successes and each success restarts its episode clock
  (``extras["_reset_progress_mask"]``); ``resetTime`` sets the episode
  length.
* A persistent, decaying random force on the cube in its own frame
  (``forceScale``), re-rolled per env with a static log-uniform
  probability from ``np.random.RandomState(4273)``, through
  ``Control.f_ext``.
* With ``asymmetric_observations`` the critic's states are the
  ``full_state`` layout.

``pre_physics`` returns its control and the hand's new targets and the
cube's force as a carry, which the base step hands to ``post_physics``
(the JAX task keeps them on the task object between the two calls).
Draws come from the task's generator or are given to ``step``: the reset
draws (:meth:`ShadowHand.draw_reset`) as ``reset_draws``, the force draws
(:meth:`ShadowHand.draw_pre`) as ``pre_draws`` and the resampled goals
(:meth:`ShadowHand.draw_goal`) as ``step_draws``.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..models.model import (DRIVE_POS, FREE, GEOM_BOX, ModelBuilder,
                            _quat_mul_np, _quat_to_mat_np, compose_scene,
                            model_from_spec)
from ..ops import maths
from ..physics.engine import Control, PhysicsEngine, SimState
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "ShadowHand",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 8192,
        "envSpacing": 0.75,
        "episodeLength": 600,
        "enableDebugVis": False,
        "aggregateMode": 1,
        "clipObservations": 5.0,
        "clipActions": 1.0,
        "stiffnessScale": 1.0,
        "forceLimitScale": 1.0,
        "useRelativeControl": False,
        "dofSpeedScale": 20.0,
        "actionsMovingAverage": 1.0,
        "controlFrequencyInv": 1,
        "startPositionNoise": 0.01,
        "startRotationNoise": 0.0,
        "resetPositionNoise": 0.01,
        "resetRotationNoise": 0.0,
        "resetDofPosRandomInterval": 0.2,
        "resetDofVelRandomInterval": 0.0,
        "distRewardScale": -10.0,
        "rotRewardScale": 1.0,
        "rotEps": 0.1,
        "actionPenaltyScale": -0.0002,
        "reachGoalBonus": 250.0,
        "fallDistance": 0.24,
        "fallPenalty": 0.0,
        "objectType": "block",
        "observationType": "full_state",
        "asymmetric_observations": False,
        "successTolerance": 0.1,
        "printNumSuccesses": False,
        "maxConsecutiveSuccesses": 0,
        "averFactor": 0.1,
    },
    "sim": {
        "dt": 0.01667,
        "substeps": 2,
        "up_axis": "z",
        "use_gpu_pipeline": True,
        "gravity": [0.0, 0.0, -9.81],
        "physx": {
            "num_threads": 4, "solver_type": 1, "use_gpu": True,
            "num_position_iterations": 8, "num_velocity_iterations": 0,
            # 60 candidate rows, the 32 deepest solved
            "contact_capacity": 32,
            "reuse_contact_rows": True,
            "contact_offset": 0.002, "rest_offset": 0.0,
            "bounce_threshold_velocity": 0.2,
            "max_depenetration_velocity": 1000.0,
            # a pinched cube carries 10+ coincident rows: plain Jacobi
            # diverges there (R * relaxation > 2)
            "mass_splitting": True,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 8388608, "contact_collection": 0,
        },
    },
    "task": {"randomize": False, "randomization_params": {}},
}

# the palm centre's world position after the palm-up placement
PALM_TARGET = np.array([0.0, -0.01, 0.55])
CUBE_SIZE = 0.065

FINGERTIP_BODIES = ["robot0:ffdistal", "robot0:mfdistal", "robot0:rfdistal",
                    "robot0:lfdistal", "robot0:thdistal"]

OBS_DIMS = {"openai": 42, "full_no_vel": 77, "full": 157, "full_state": 211}


def _part_body_pose0(m, body: int):
    """World pose of a part body at q = 0 (numpy, build time only)."""
    chain = []
    b = body
    while b != -1:
        chain.append(b)
        b = int(m.parent[b])
    pos = np.zeros(3)
    quat = np.array([0.0, 0, 0, 1.0])
    for b in reversed(chain):
        pos = pos + _quat_to_mat_np(quat) @ np.asarray(m.body_pos[b], float)
        quat = _quat_mul_np(quat, np.asarray(m.body_quat[b], float))
    return pos, quat


def _palm_up_placement(hand, palm_geom_name: str, palm_axis: np.ndarray,
                       distal_axis=None, tilt: float = 0.0):
    """(base_pos, base_quat) turning the hand part so that its palm-frame
    axis ``palm_axis`` points at world +z and the palm geom's centre lands
    at PALM_TARGET; ``tilt`` (rad) then tips the palm plane down toward
    the palm-frame finger direction ``distal_axis``."""
    g = next(g for g in hand.geoms if g.name == palm_geom_name)
    bp, bq = _part_body_pose0(hand, g.body)
    Rb = _quat_to_mat_np(bq)
    c_part = bp + Rb @ np.asarray(g.pos, float)
    v = Rb @ np.asarray(palm_axis, float)
    v = v / np.linalg.norm(v)
    axis = np.cross(v, [0.0, 0, 1.0])
    s = np.linalg.norm(axis)
    if s < 1e-8:
        q = (np.array([0.0, 0, 0, 1.0]) if v[2] > 0
             else np.array([1.0, 0, 0, 0.0]))
    else:
        ang = float(np.arctan2(s, v[2]))
        axis = axis / s
        q = np.concatenate([axis * np.sin(ang / 2), [np.cos(ang / 2)]])
    if tilt and distal_axis is not None:
        d_w = _quat_to_mat_np(q) @ (Rb @ np.asarray(distal_axis, float))
        d_w[2] = 0.0
        d_w /= max(np.linalg.norm(d_w), 1e-9)
        ax = np.cross([0.0, 0, 1.0], d_w)   # a positive tilt tips d_w down
        qt = np.concatenate([ax * np.sin(tilt / 2), [np.cos(tilt / 2)]])
        q = _quat_mul_np(qt, q)
    base = PALM_TARGET - _quat_to_mat_np(q) @ c_part
    return base, q


class HandTaskState(NamedTuple):
    goal_rot: torch.Tensor        # (N, 4)
    successes: torch.Tensor       # (N,)
    consecutive: torch.Tensor     # () running mean
    prev_targets: torch.Tensor    # (N, num_hand_dofs)
    rb_force: torch.Tensor        # (N, 3) the cube's force, its own frame


class ShadowHand(VecTaskBase):
    num_hand_dofs = 24
    num_hand_actuated = 20
    fingertip_names = FINGERTIP_BODIES
    obs_dims = OBS_DIMS
    obs_include_fingertips = True

    # MJCF position-actuator gains and drive force limits per driven joint
    # (kp, effort), keyed by the dof's child body; the tendon-coupled
    # distals take their middle joint's values
    DRIVE_PARAMS = {
        "wrist": (5.0, 4.785), "palm": (5.0, 2.175),
        "ffknuckle": (1.0, 0.9), "ffproximal": (1.0, 0.9),
        "ffmiddle": (1.0, 0.7245), "ffdistal": (1.0, 0.7245),
        "mfknuckle": (1.0, 0.9), "mfproximal": (1.0, 0.9),
        "mfmiddle": (1.0, 0.7245), "mfdistal": (1.0, 0.7245),
        "rfknuckle": (1.0, 0.9), "rfproximal": (1.0, 0.9),
        "rfmiddle": (1.0, 0.7245), "rfdistal": (1.0, 0.7245),
        "lfmetacarpal": (1.0, 0.9), "lfknuckle": (1.0, 0.9),
        "lfproximal": (1.0, 0.9), "lfmiddle": (1.0, 0.7245),
        "lfdistal": (1.0, 0.7245),
        "thbase": (1.0, 2.3722), "thproximal": (1.0, 1.45),
        "thhub": (1.0, 0.99), "thmiddle": (1.0, 0.99),
        "thdistal": (1.0, 0.81),
    }

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        e = cfg["env"]
        self.obs_type = e.get("observationType", "full_state")
        e["numObservations"] = self.obs_dims[self.obs_type]
        e["numActions"] = self.num_hand_actuated
        if e.get("asymmetric_observations"):
            # the critic's privileged states: the full_state layout
            e["numStates"] = self.obs_dims["full_state"]
        # resetTime overrides episodeLength: the episode ends resetTime
        # seconds after the last success
        reset_time = float(e.get("resetTime", -1.0) or -1.0)
        if reset_time > 0.0:
            cfi = int(e.get("controlFrequencyInv", 1))
            dt = float(cfg.get("sim", {}).get("dt", 1.0 / 60.0))
            e["episodeLength"] = int(round(reset_time / (cfi * dt)))
        self.max_consecutive_successes = int(
            e.get("maxConsecutiveSuccesses", 0))
        self.force_scale = float(e.get("forceScale", 0.0))
        self.force_decay = float(e.get("forceDecay", 0.99))
        self.force_decay_interval = float(e.get("forceDecayInterval", 0.08))
        fpr = e.get("forceProbRange", (0.001, 0.1))
        # the per-env force probability and moving average: static draws
        # in the JAX package's order from the same numpy stream
        rs = np.random.RandomState(4273)
        n_env = int(e["numEnvs"])
        force_prob = np.exp(np.log(fpr[0]) + (np.log(fpr[1]) - np.log(fpr[0]))
                            * rs.rand(n_env))
        ama = e.get("actionsMovingAverage", 1.0)
        if isinstance(ama, dict):
            lo, hi = ama.get("range", (1.0, 1.0))
            ama = lo + (hi - lo) * rs.rand(n_env, 1)
        else:
            ama = float(ama)
        self.dist_reward_scale = float(e["distRewardScale"])
        self.rot_reward_scale = float(e["rotRewardScale"])
        self.rot_eps = float(e["rotEps"])
        self.action_penalty_scale = float(e["actionPenaltyScale"])
        self.success_tolerance = float(e["successTolerance"])
        self.reach_goal_bonus = float(e["reachGoalBonus"])
        self.fall_dist = float(e["fallDistance"])
        self.fall_penalty = float(e["fallPenalty"])
        self.reset_dof_pos_interval = float(e["resetDofPosRandomInterval"])
        self.reset_pos_noise = float(e["resetPositionNoise"])
        self.av_factor = float(e.get("averFactor", 0.1))
        self.use_relative_control = bool(e.get("useRelativeControl", False))
        self.dof_speed_scale = float(e.get("dofSpeedScale", 20.0))
        self.force_torque_obs_scale = 10.0
        self.vel_obs_scale = 0.2
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)

        m = self.model
        dev = self.device
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=dev)
        idx = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.int64), device=dev)
        self.random_force_prob = f32(force_prob)
        self.act_moving_average = (ama if isinstance(ama, float)
                                   else f32(ama))
        names = m.body_names
        nh = self.num_hand_dofs
        self.fingertip_bodies = np.asarray(
            [names.index(n) for n in self.fingertip_names], np.int64)
        self.object_body = names.index("object")
        self.obj_qa = int(m.q_adr[self.object_body])
        self.obj_va = int(m.v_adr[self.object_body])
        self.obj_mass = float(np.asarray(m.mass)[self.object_body])
        self.hand_dofs = np.asarray(self.engine.scalar_dofs[:nh])
        self.dof_lower = f32(np.asarray(m.dof_lower)[self.hand_dofs])
        self.dof_upper = f32(np.asarray(m.dof_upper)[self.hand_dofs])
        dof_names = [names[int(m.dof_body[d])] for d in self.hand_dofs]
        self.coupled_distal = np.asarray(
            [i for i, n in enumerate(dof_names)
             if n.split(":")[-1] in ("ffdistal", "mfdistal", "rfdistal",
                                     "lfdistal")], np.int64)
        self.actuated = np.asarray(
            [i for i in range(nh) if i not in self.coupled_distal], np.int64)
        # the step's index tensors and constants, on the device once
        self._fingertips_t = idx(self.fingertip_bodies)
        self._hand_dofs_t = idx(self.hand_dofs)
        self._actuated_t = idx(self.actuated)
        self._coupled_t = idx(self.coupled_distal)
        self._coupled_src_t = idx(self.coupled_distal - 1)
        self._act_lo = self.dof_lower[self._actuated_t]
        self._act_hi = self.dof_upper[self._actuated_t]
        self._obj_start = f32(self.obj_start)
        self._goal_pos = f32(self.goal_pos)
        self._ez = f32([0.0, 0.0, 1.0])
        self._ey = f32([0.0, 1.0, 0.0])

    def create_model(self):
        from ..models.specs.shadow_hand import SPEC
        hand = model_from_spec(copy.deepcopy(SPEC))
        # position drives on all hand dofs (the OpenAI position actuators)
        for d in range(hand.nv):
            bname = hand.body_names[int(hand.dof_body[d])].split(":")[-1]
            kp, eff = self.DRIVE_PARAMS.get(bname, (1.0, 0.9))
            hand.dof_drive_mode[d] = DRIVE_POS
            hand.dof_stiffness[d] = kp
            hand.dof_drive_damping[d] = 0.1
            hand.dof_effort_limit[d] = eff
        # the palmar normal (palm-frame -y) up, the fingers (+z) tipped
        # down by the tilt; the cube spawns over the palm/knuckle junction
        base, quat = _palm_up_placement(hand, "robot0:C_palm0",
                                        np.array([0.0, -1.0, 0.0]),
                                        distal_axis=np.array([0.0, 0, 1.0]),
                                        tilt=0.095)
        Rq = _quat_to_mat_np(np.asarray(quat, float))
        self.obj_start = (PALM_TARGET + Rq @ np.array([0.0, 0.0, 0.055])
                          + np.array([0.0, 0.0, 0.05]))
        # the reward's goal position: the spawn dropped 4 cm
        self.goal_pos = self.obj_start + np.array([0.0, 0.0, -0.04])
        ob = ModelBuilder()
        ob.begin_actor()
        obj = ob.add_body("object", -1, FREE, body_pos=self.obj_start)
        ob.add_geom(obj, GEOM_BOX, np.full(3, CUBE_SIZE / 2), density=400.0,
                    name="object_geom")
        model = compose_scene([
            (hand, base, tuple(quat)),
            (ob.finalize(), (0, 0, 0), (0, 0, 0, 1))])
        # fingertip force sensors on the composed model
        ft = [model.body_names.index(n) for n in FINGERTIP_BODIES]
        model.sensor_body = np.asarray(ft, np.int32)
        model.sensor_pos = np.zeros((len(ft), 3))
        return model, True

    def contact_pairs(self, model):
        """The engine's pair specs (geom A's points, geom B's SDF): palm,
        distal and middle points against the cube, then the cube's corners
        against the palm boxes."""
        names = [g.name for g in model.geoms]
        obj_geom = names.index("object_geom")
        pair_names = ["robot0:C_palm0", "robot0:C_palm1", "robot0:C_ffdistal",
                      "robot0:C_mfdistal", "robot0:C_rfdistal",
                      "robot0:C_lfdistal", "robot0:C_thdistal",
                      "robot0:C_ffmiddle", "robot0:C_mfmiddle",
                      "robot0:C_rfmiddle", "robot0:C_lfmiddle",
                      "robot0:C_thmiddle"]
        pairs = [(names.index(pn), obj_geom) for pn in pair_names
                 if pn in names]
        return pairs + [(obj_geom, names.index(pn))
                        for pn in ("robot0:C_palm0", "robot0:C_palm1")
                        if pn in names]

    def build_engine(self, model, ground):
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             pair_specs=self.contact_pairs(model),
                             device=self.device)

    # ------------------------------------------------------------------
    def initial_task_state(self):
        n = self.num_envs
        kw = dict(dtype=DTYPE, device=self.device)
        return HandTaskState(
            goal_rot=torch.tensor([0.0, 0, 0, 1.0], **kw).repeat(n, 1),
            successes=torch.zeros(n, **kw),
            consecutive=torch.zeros((), **kw),
            prev_targets=torch.zeros((n, self.num_hand_dofs), **kw),
            rb_force=torch.zeros((n, 3), **kw))

    # -- draws -----------------------------------------------------------
    def _uniform_angles(self):
        g = self.generator
        u = torch.rand((self.num_envs, 2), generator=g, device=g.device,
                       dtype=DTYPE)
        return u * (2 * np.pi) - np.pi

    def draw_reset(self):
        """``reset_idx``'s draws, in the JAX key order
        (shadow_hand.py:436-468): the cube's position noise N(0, 1)
        (N, 3), its orientation's angles about z and y U[-pi, pi) (N, 2),
        the dof noise U[0, 1) (N, num_hand_dofs) and the goal's angles
        (N, 2)."""
        g = self.generator
        kw = dict(generator=g, device=g.device, dtype=DTYPE)
        n = self.num_envs
        pos_n = torch.randn((n, 3), **kw)
        obj_ang = self._uniform_angles()
        dof_u = torch.rand((n, self.num_hand_dofs), **kw)
        return pos_n, obj_ang, dof_u, self._uniform_angles()

    def draw_pre(self):
        """``pre_physics``'s draws (shadow_hand.py:416-421, ``fold_in(rng,
        77)`` there): the force trigger's U[0, 1) (N,) and the new force's
        N(0, 1) (N, 3)."""
        g = self.generator
        kw = dict(generator=g, device=g.device, dtype=DTYPE)
        return (torch.rand((self.num_envs,), **kw),
                torch.randn((self.num_envs, 3), **kw))

    def draw_goal(self):
        """``post_physics``'s draws (shadow_hand.py:547-548, ``fold_in(rng,
        41)`` there): the resampled goals' angles about z and y (N, 2)."""
        return (self._uniform_angles(),)

    def _random_quat(self, ang):
        """A rotation about z by ang[:, 0], then about y by ang[:, 1]
        (the reference's randomize_rotation)."""
        rz = maths.quat_from_angle_axis(ang[:, 0], self._ez)
        ry = maths.quat_from_angle_axis(ang[:, 1], self._ey)
        return maths.quat_mul(rz, ry)

    # ------------------------------------------------------------------
    def pre_physics(self, state: EnvState, actions, draws=None):
        """The control, and the carry for ``post_physics``: the hand's new
        targets (N, num_hand_dofs) and the cube's force (N, 3)."""
        n, nv = self.num_envs, self.engine.nv
        task: HandTaskState = state.task
        cur = task.prev_targets
        act = self._actuated_t
        if self.use_relative_control:
            t_act = cur[:, act] + self.dof_speed_scale * self.dt * actions
        else:
            t_act = maths.scale(actions, self._act_lo, self._act_hi)
            ama = self.act_moving_average
            if not (isinstance(ama, float) and ama == 1.0):
                # the targets' low-pass: a * new + (1 - a) * previous
                t_act = ama * t_act + (1.0 - ama) * cur[:, act]
        t_act = torch.clamp(t_act, self._act_lo, self._act_hi)
        targets = cur.clone()
        targets[:, act] = t_act
        # the tendon-coupled distal joints follow their middle joints
        if len(self.coupled_distal):
            dof_pos = self.engine.dof_pos(state.sim)
            targets[:, self._coupled_t] = dof_pos[:, self._coupled_src_t]
        kw = dict(dtype=DTYPE, device=self.device)
        f_ext = None
        rb = task.rb_force
        if self.force_scale > 0.0:
            # the persistent force: decayed, re-rolled per env with its
            # static probability, applied in the cube's frame
            fire_u, force_n = self.draw_pre() if draws is None else draws
            decay = self.force_decay ** (self.dt / self.force_decay_interval)
            rb = rb * decay
            fire = fire_u < self.random_force_prob
            new = force_n * self.obj_mass * self.force_scale
            rb = torch.where(fire[:, None], new, rb)
            qa = self.obj_qa
            f_world = maths.quat_apply(state.sim.q[:, qa + 3: qa + 7], rb)
            f_ext = torch.zeros((n, self.engine.nb, 6), **kw)
            f_ext[:, self.object_body, 3:6] = f_world
        pos_target = torch.zeros((n, nv), **kw)
        pos_target[:, self._hand_dofs_t] = targets
        ctrl = Control(tau=torch.zeros((n, nv), **kw), pos_target=pos_target,
                       vel_target=torch.zeros((n, nv), **kw), f_ext=f_ext)
        return ctrl, (targets, rb)

    def reset_idx(self, sim: SimState, task: HandTaskState, mask,
                  draws=None):
        n, nh = self.num_envs, self.num_hand_dofs
        pos_n, obj_ang, dof_u, goal_ang = (self.draw_reset() if draws is None
                                           else draws)
        # the cube: its start plus noise, a random orientation, at rest
        pos = self._obj_start + self.reset_pos_noise * pos_n
        oq = torch.cat([pos, self._random_quat(obj_ang)], -1)
        qa, va = self.obj_qa, self.obj_va
        q, qd = sim.q.clone(), sim.qd.clone()
        q[:, qa: qa + 7] = masked_update(mask, oq, q[:, qa: qa + 7])
        qd[:, va: va + 6] = masked_update(
            mask, torch.zeros_like(qd[:, va: va + 6]), qd[:, va: va + 6])
        # the hand dofs: U(-interval / 2, interval / 2) about zero, at rest
        noise = self.reset_dof_pos_interval * (dof_u - 0.5)
        dof = torch.clamp(noise, self.dof_lower, self.dof_upper)
        sim = SimState(q, qd)
        full_pos = self.engine.dof_pos(sim).clone()
        full_pos[:, :nh] = masked_update(mask, dof, full_pos[:, :nh])
        sim = self.engine.set_dof_pos(sim, full_pos)
        dv = self.engine.dof_vel(sim).clone()
        dv[:, :nh] = masked_update(mask, torch.zeros_like(dv[:, :nh]),
                                   dv[:, :nh])
        sim = self.engine.set_dof_vel(sim, dv)
        task = HandTaskState(
            goal_rot=masked_update(mask, self._random_quat(goal_ang),
                                   task.goal_rot),
            successes=torch.where(mask, 0.0, task.successes),
            consecutive=task.consecutive,
            prev_targets=masked_update(mask, dof, task.prev_targets),
            rb_force=torch.where(mask[:, None], 0.0, task.rb_force))
        return sim, task

    def _assemble(self, obs_type, dim, p, goal_rot):
        """The observation of ``obs_type`` padded or trimmed to ``dim``
        (shadow_hand.py:498-539); ``p`` the step's readouts."""
        n = self.num_envs
        if obs_type == "openai":
            pieces = [p["ft_pos"].reshape(n, -1), p["obj_pos"],
                      p["quat_diff"], p["actions"]]
        else:
            pieces = [maths.unscale(p["dof_pos"], self.dof_lower,
                                    self.dof_upper)]
            if obs_type != "full_no_vel":
                pieces.append(self.vel_obs_scale * p["dof_vel"])
            if obs_type == "full_state":
                pieces.append(self.force_torque_obs_scale * p["dof_force"])
            pieces += [p["obj_pos"], p["obj_rot"]]
            if obs_type != "full_no_vel":
                pieces += [p["obj_linvel"],
                           self.vel_obs_scale * p["obj_angvel"]]
            pieces += [self._goal_pos.expand(n, 3), goal_rot, p["quat_diff"]]
            # Shadow's layouts carry the fingertip states (and, in
            # full_state, the fingertip wrenches); Allegro's do not
            if self.obs_include_fingertips:
                pieces.append(p["ft_state"].reshape(n, -1))
                if obs_type == "full_state":
                    pieces.append(self.force_torque_obs_scale
                                  * p["sensor_forces"].reshape(n, -1))
            pieces.append(p["actions"])
        x = torch.cat(pieces, -1)
        if x.shape[-1] < dim:
            x = torch.nn.functional.pad(x, (0, dim - x.shape[-1]))
        return x[:, :dim]

    def post_physics(self, state: EnvState, out, actions, *, carry,
                     draws=None):
        n, nh = self.num_envs, self.num_hand_dofs
        task: HandTaskState = state.task
        new_targets, rb_force = carry
        obj = out.root_states[:, 1]
        obj_pos, obj_rot = obj[:, 0:3], obj[:, 3:7]
        goal_rot = task.goal_rot
        quat_diff = maths.quat_mul(obj_rot, maths.quat_conjugate(goal_rot))
        rot_dist = 2.0 * torch.asin(torch.clamp(torch.linalg.vector_norm(
            quat_diff[:, 0:3], dim=-1), 0.0, 1.0))
        goal_dist = torch.linalg.vector_norm(obj_pos - self._goal_pos, dim=-1)
        ft = self._fingertips_t
        ft_pos = out.body_pos[:, ft]
        p = dict(
            ft_pos=ft_pos, obj_pos=obj_pos, obj_rot=obj_rot,
            obj_linvel=obj[:, 7:10], obj_angvel=obj[:, 10:13],
            quat_diff=quat_diff, actions=actions,
            dof_pos=self.engine.dof_pos(state.sim)[:, :nh],
            dof_vel=self.engine.dof_vel(state.sim)[:, :nh],
            dof_force=out.dof_force[:, self._hand_dofs_t],
            ft_state=torch.cat([ft_pos, out.body_quat[:, ft],
                                out.body_vel[:, ft]], -1),
            sensor_forces=out.sensor_forces)
        obs = self._assemble(self.obs_type, self.num_obs, p, goal_rot)

        action_penalty = torch.sum(torch.square(actions), -1)
        dist_rew = goal_dist * self.dist_reward_scale
        rot_rew = (1.0 / (torch.abs(rot_dist) + self.rot_eps)
                   * self.rot_reward_scale)
        reward = (dist_rew + rot_rew
                  + self.action_penalty_scale * action_penalty)
        success = torch.abs(rot_dist) <= self.success_tolerance
        reward = torch.where(success, reward + self.reach_goal_bonus, reward)
        fallen = goal_dist >= self.fall_dist
        reward = torch.where(fallen, reward + self.fall_penalty, reward)

        # the goal resampled in the same step on a success
        (ang,) = self.draw_goal() if draws is None else draws
        goal_rot = masked_update(success, self._random_quat(ang), goal_rot)
        successes = task.successes + success.to(DTYPE)

        timeout = state.progress >= self.max_episode_length - 1
        if self.max_consecutive_successes > 0:
            # a success restarts the episode clock, max successes reset
            # the env, and timing out costs half the fall penalty
            timeout = timeout & ~success
            reset = (fallen | timeout
                     | (successes >= self.max_consecutive_successes))
            reward = torch.where(timeout, reward + 0.5 * self.fall_penalty,
                                 reward)
        else:
            reset = fallen | timeout
        reset = reset.to(torch.int32)
        done_count = torch.sum(reset)
        cons = torch.where(
            done_count > 0,
            (1 - self.av_factor) * task.consecutive + self.av_factor
            * torch.sum(torch.where(reset > 0, successes, 0.0))
            / torch.clamp(done_count, min=1),
            task.consecutive)

        # the critic's privileged states: the full_state layout, with the
        # goal after this step's resampling (the JAX closure reads the
        # goal when it builds them, after the resample)
        states = (self._assemble("full_state", self.num_states, p, goal_rot)
                  if self.num_states > 0 else None)
        task = HandTaskState(goal_rot=goal_rot, successes=successes,
                             consecutive=cons, prev_targets=new_targets,
                             rb_force=rb_force)
        extras = {
            "consecutive_successes": cons, "true_objective": cons,
            "episode": {
                "rot_dist": rot_dist, "goal_dist": goal_dist,
                "dist_rew": dist_rew, "rot_rew": rot_rew,
                "success_rate_step": success.to(DTYPE),
                "fall_rate_step": fallen.to(DTYPE),
            },
        }
        if self.max_consecutive_successes > 0:
            extras["_reset_progress_mask"] = success
        return obs, states, reward, reset, task, extras
