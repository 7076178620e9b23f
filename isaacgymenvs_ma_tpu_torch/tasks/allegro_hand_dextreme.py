"""AllegroHandDextreme{ManualDR,ADR} (port of
isaacgymenvs_ma_tpu/tasks/allegro_hand_dextreme.py; reference
tasks/dextreme/allegro_hand_dextreme.py): the AllegroHand cube
reorientation hardened for sim-to-real, 8192 envs.

* **Dict observations** (``dict_obs_cls``): the flat 50-wide policy obs is
  the concatenation of the ``obs_spec`` groups and the 112-wide critic
  states of the ``state_spec`` groups; :meth:`split_obs` /
  :meth:`split_states` give the dict view that
  :class:`..utils.rlgames_utils.ComplexObsRLGPUEnv` serves.
* **Action corruption** in ``pre_physics``: the executed action comes from
  a newest-first history ring (``MAX_ACTION_LATENCY`` deep) at a per-env
  latency, then ``a x + b + c`` (per-episode scale and bias, per-step white
  noise), then with probability ``rnaProb`` a blend with the
  :class:`..utils.rna_util.RandomNetworkAdversary`'s output, whose dropout
  masks are redrawn every ``rnaRefreshInterval`` steps (step 0 included).
* **Camera noise** in ``post_physics``: the observed cube pose gets
  Gaussian position and axis-angle rotation noise with occasional large
  "unreliable" jumps, and refreshes only every ``cube_pose_refresh_rate``
  steps (plus a random extra hold).
* **ADR** (the ADR variant): 27 randomization ranges adapt through the
  boundary workers of :class:`..utils.adr.ADR`.  Each env's sampled row
  drives the engine's ``PhysScales`` (per-dof drive, armature, effort and
  joint-friction scales and additive limit shifts on the hand, per-body
  mass, friction and restitution) and the noise magnitudes.  The ranges
  are the checkpointed env state (``get_env_state``).  Restitution makes
  the engine take its batched-product loop, as does the hand's mass
  splitting; B1-B3 run, B4 does not.

Draws come from the task's generator or are given to ``step`` (the JAX
keys they stand for in brackets): ``reset_draws`` = the hand's four, the
six per-episode normals (``fold_in(key, 23)``) and, for ADR, the fresh
parameter rows' uniforms (``fold_in(key, 11)``), :meth:`draw_reset`;
``pre_draws`` = :class:`PreDraws` (``fold_in(rng, 7)``, the RNA key, the
hand's force ``fold_in(rng, 77)``); ``step_draws`` = :class:`StepDraws`
(the hand's goals ``fold_in(rng, 41)``, ``fold_in(rng, 13)``,
``fold_in(rng, 17)``).  ``pre_physics`` hands its task updates to
``post_physics`` as the carry (the JAX task keeps them on the object).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DTYPE
from ..ops import maths
from ..physics.engine import SimState
from ..utils.adr import ADR, ADRState, adr_config_from_params
from ..utils.config import deep_merge
from ..utils.domain_rand import PhysScales
from ..utils.rna_util import RandomNetworkAdversary
from .allegro_hand import AllegroHand, TASK_CFG as ALLEGRO_CFG
from .base import EnvState, masked_update
from .shadow_hand import HandTaskState

MAX_ACTION_LATENCY = 8   # action-history depth (policy steps)

# the 27-parameter ADR tree with the reference's init ranges, limits and
# deltas (cfg/task/AllegroHandDextremeADR.yaml:250-422), as the JAX package
# has it; lower / upper are additive limit shifts in radians
DEFAULT_ADR_PARAMS = {
    # hand dof properties (scales on the allegro drive/dof values; lower/
    # upper are ADDITIVE limit shifts in radians)
    "hand_damping": {"init_range": [0.5, 2.0], "limits": [0.01, 20.0],
                     "delta": 0.01},
    "hand_stiffness": {"init_range": [0.8, 1.2], "limits": [0.01, 20.0],
                       "delta": 0.01},
    "hand_joint_friction": {"init_range": [0.8, 1.2], "limits": [0.0, 10.0],
                            "delta": 0.01},
    "hand_armature": {"init_range": [0.8, 1.2], "limits": [0.0, 10.0],
                      "delta": 0.01},
    "hand_effort": {"init_range": [0.9, 1.1], "limits": [0.4, 10.0],
                    "delta": 0.01},
    "hand_lower": {"init_range": [0.0, 0.0], "limits": [-5.0, 5.0],
                   "delta": 0.02},
    "hand_upper": {"init_range": [0.0, 0.0], "limits": [-5.0, 5.0],
                   "delta": 0.02},
    "hand_mass": {"init_range": [0.8, 1.2], "limits": [0.01, 10.0],
                  "delta": 0.01},
    "hand_friction_fingertips": {"init_range": [0.9, 1.1],
                                 "limits": [0.1, 2.0], "delta": 0.01},
    "hand_restitution": {"init_range": [0.0, 0.1], "limits": [0.0, 1.0],
                         "delta": 0.01},
    # object physical properties
    "object_mass": {"init_range": [0.8, 1.2], "limits": [0.01, 10.0],
                    "delta": 0.01},
    "object_friction": {"init_range": [0.4, 0.8], "limits": [0.01, 2.0],
                        "delta": 0.01},
    "object_restitution": {"init_range": [0.0, 0.1], "limits": [0.0, 1.0],
                           "delta": 0.01},
    # cube-pose camera model: inverse refresh rate + extra-delay chance
    "cube_obs_delay_prob": {"init_range": [0.0, 0.05], "limits": [0.0, 0.7],
                            "delta": 0.01},
    "cube_pose_refresh_rate": {"init_range": [1.0, 1.0], "limits": [1.0, 6.0],
                               "delta": 0.2},
    # action latency (policy steps held in the action-history ring; the
    # reference allows up to 60 — the TPU ring is statically sized, so the
    # effective ceiling is the ring depth)
    "action_delay_prob": {"init_range": [0.0, 0.05], "limits": [0.0, 0.7],
                          "delta": 0.01},
    "action_latency": {"init_range": [0.0, 0.0],
                       "limits": [0.0, float(MAX_ACTION_LATENCY - 2)],
                       "delta": 0.1},
    # affine corruption a*x + b + c (OAI-style): _scaling is the std of the
    # per-episode multiplicative coefficient (a ~ N(1, std)), _additive the
    # per-episode bias std, _white the per-step noise std
    "affine_action_scaling": {"init_range": [0.0, 0.0], "limits": [0.0, 4.0],
                              "delta": 0.0},
    "affine_action_additive": {"init_range": [0.0, 0.04],
                               "limits": [0.0, 4.0], "delta": 0.01},
    "affine_action_white": {"init_range": [0.0, 0.04], "limits": [0.0, 4.0],
                            "delta": 0.01},
    "affine_cube_pose_scaling": {"init_range": [0.0, 0.0],
                                 "limits": [0.0, 4.0], "delta": 0.0},
    "affine_cube_pose_additive": {"init_range": [0.0, 0.04],
                                  "limits": [0.0, 4.0], "delta": 0.01},
    "affine_cube_pose_white": {"init_range": [0.0, 0.04],
                               "limits": [0.0, 4.0], "delta": 0.01},
    "affine_dof_pos_scaling": {"init_range": [0.0, 0.0],
                               "limits": [0.0, 4.0], "delta": 0.0},
    "affine_dof_pos_additive": {"init_range": [0.0, 0.04],
                                "limits": [0.0, 4.0], "delta": 0.01},
    "affine_dof_pos_white": {"init_range": [0.0, 0.04],
                             "limits": [0.0, 4.0], "delta": 0.01},
    # RandomNetworkAdversary blend weight
    "rna_alpha": {"init_range": [0.0, 0.0], "limits": [0.0, 1.0],
                  "delta": 0.01},
}

TASK_CFG = deep_merge(ALLEGRO_CFG, {
    "name": "AllegroHandDextremeManualDR",
    "env": {
        "numEnvs": 8192,
        "observationType": "full_state",
        "asymmetric_observations": True,
        # camera-noise model (ref cube pose corruption)
        "cubePosNoise": 0.01,
        "cubeRotNoise": 0.05,
        "unreliableProb": 0.05,
        "unreliablePosJump": 0.1,
        "unreliableRotJump": 0.5,
        # RNA (ref rna perturbation config)
        "rnaEnabled": True,
        "rnaAlpha": 0.2,
        "rnaProb": 0.2,
        "rnaRefreshInterval": 600,
        "actionNoise": 0.02,
        # hand-family training mechanics (the recipe that cracked
        # ShadowHandOpenAI_FF in round 4) — the reference Dextreme yaml has
        # them too (AllegroHandDextremeADR.yaml:11 resetTime 8, :60-64
        # object force perturbations, :93 maxConsecutiveSuccesses 50,
        # :31-34 action smoothing): without urgency + perturbations the
        # boundary workers never reach the 5/20 ADR success band
        "resetTime": 8,
        "forceScale": 2.0,
        "forceProbRange": [0.001, 0.1],
        "forceDecay": 0.99,
        "forceDecayInterval": 0.08,
        "maxConsecutiveSuccesses": 50,
        "actionsMovingAverage": {"range": [0.15, 0.2],
                                 "schedule_steps": 1000_000,
                                 "schedule_freq": 500},
    },
    # reference adr section values (AllegroHandDextremeADR.yaml:227-247)
    "adr": {
        "use_adr": True,
        "worker_adr_boundary_fraction": 0.4,
        "adr_queue_threshold_length": 256,
        "adr_objective_threshold_low": 5.0,
        "adr_objective_threshold_high": 20.0,
        "params": DEFAULT_ADR_PARAMS,
    },
})


class DextremeTaskState(NamedTuple):
    hand: HandTaskState
    rna: tuple                        # the RNA's dropout masks, (units,) each
    step_count: torch.Tensor          # () int32, the RNA refresh clock
    act_hist: torch.Tensor            # (N, L, A) newest-first action ring
    act_bias: torch.Tensor            # (N, A) per-episode action bias
    cube_pos_bias: torch.Tensor       # (N, 3)
    dof_bias: torch.Tensor            # (N, nh) dof-observation bias
    act_scale: torch.Tensor           # (N, A) per-episode a ~ N(1, std)
    cube_pos_scale: torch.Tensor      # (N, 3)
    dof_scale: torch.Tensor           # (N, nh)
    held_pos: torch.Tensor            # (N, 3) last refreshed cube pos obs
    held_rot: torch.Tensor            # (N, 4)
    pose_counter: torch.Tensor        # (N,) steps until the next refresh
    adr: Optional[ADRState] = None    # ADR variant only
    adr_params: Optional[torch.Tensor] = None   # (N, P) sampled rows


class PreDraws(NamedTuple):
    """``pre_physics``'s draws: ``fold_in(rng, 7)`` split 4 ways in JAX
    (k_n, k_p, _, k_d), the RNA key's refresh uniforms and the hand's
    force draws (``ShadowHand.draw_pre``)."""
    noise: torch.Tensor               # (N, A) N(0, 1) white action noise
    rna_u: torch.Tensor               # (N,) U[0, 1): blend when < rnaProb
    delay_u: torch.Tensor             # (N,) U[0, 1): an extra latency step
    mask_u: tuple                     # (units,) U[0, 1) per RNA layer
    hand: tuple                       # (fire_u (N,), force_n (N, 3))


class StepDraws(NamedTuple):
    """``post_physics``'s draws: the hand's resampled goals' angles, then
    ``fold_in(rng, 13)`` split 5 ways and ``fold_in(rng, 17)``."""
    goal_ang: torch.Tensor            # (N, 2)
    unreliable_u: torch.Tensor        # (N,)
    pos_n: torch.Tensor               # (N, 3)
    axis_n: torch.Tensor              # (N, 3)
    ang_n: torch.Tensor               # (N,)
    hold_u: torch.Tensor              # (N,)
    dof_n: torch.Tensor               # (N, nh)


class AllegroHandDextremeManualDR(AllegroHand):
    """Fixed-magnitude DR variant (ref AllegroHandDextremeManualDR)."""

    dict_obs_cls = True
    use_adr = False
    OBS_SPEC = [("dof_pos", 16), ("object_pose", 7), ("goal_pose", 7),
                ("goal_relative_rot", 4), ("last_actions", 16)]
    STATE_SPEC = OBS_SPEC + [("dof_vel", 16), ("dof_force", 16),
                             ("object_vels", 6), ("ft_force_torques", 24)]

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        e = cfg["env"]
        self.obs_spec = list(self.OBS_SPEC)
        self.state_spec = list(self.STATE_SPEC)
        e["asymmetric_observations"] = True
        self.cube_pos_noise = float(e.get("cubePosNoise", 0.01))
        self.cube_rot_noise = float(e.get("cubeRotNoise", 0.05))
        self.unreliable_prob = float(e.get("unreliableProb", 0.05))
        self.unreliable_pos_jump = float(e.get("unreliablePosJump", 0.1))
        self.unreliable_rot_jump = float(e.get("unreliableRotJump", 0.5))
        self.rna_enabled = bool(e.get("rnaEnabled", True))
        self.rna_alpha = float(e.get("rnaAlpha", 0.2))
        self.rna_prob = float(e.get("rnaProb", 0.2))
        self.rna_refresh = int(e.get("rnaRefreshInterval", 600))
        self.action_noise = float(e.get("actionNoise", 0.02))
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)
        # ShadowHand.__init__ set the widths of its own layouts
        self.num_obs = sum(s for _, s in self.obs_spec)
        self.num_states = sum(s for _, s in self.state_spec)
        e["numObservations"], e["numStates"] = self.num_obs, self.num_states
        self.rna = RandomNetworkAdversary(
            num_obs=self.num_hand_dofs, num_actions=self.num_actions,
            units=(256, 256), device=self.device)
        self.rna.init_weights(self.generator)
        # the fixed magnitudes per env, on the device once
        kw = dict(dtype=DTYPE, device=self.device)
        self._fixed = {k: torch.full((self.num_envs,), v, **kw) for k, v in (
            ("affine_action_white", self.action_noise),
            ("affine_cube_pose_white", self.cube_pos_noise),
            ("affine_cube_rot_white", self.cube_rot_noise),
            ("rna_alpha", self.rna_alpha), ("cube_pose_refresh_rate", 1.0))}
        self._unset = torch.zeros((self.num_envs,), **kw)

    # -- dict-obs surface ------------------------------------------------
    def split_obs(self, flat: torch.Tensor, spec=None) -> dict:
        out, i = {}, 0
        for name, size in (spec or self.obs_spec):
            out[name] = flat[..., i: i + size]
            i += size
        return out

    def split_states(self, flat: torch.Tensor) -> dict:
        return self.split_obs(flat, self.state_spec)

    # -- per-env DR magnitudes (ManualDR: fixed; ADR: from adr_params) ----
    def _adr_value(self, task: DextremeTaskState, name: str):
        """The per-env (N,) value of an ADR-tree parameter; ManualDR pins
        the fixed magnitudes (0 for the others)."""
        return self._fixed.get(name, self._unset)

    def _col(self, task, name):
        """:meth:`_adr_value` as a column (N, 1)."""
        return self._adr_value(task, name)[:, None]

    # -- lifecycle ---------------------------------------------------------
    def initial_task_state(self):
        n, nh, A = self.num_envs, self.num_hand_dofs, self.num_actions
        kw = dict(dtype=DTYPE, device=self.device)
        return DextremeTaskState(
            hand=super().initial_task_state(),
            rna=self.rna.refresh(self.generator),
            step_count=torch.zeros((), dtype=torch.int32, device=self.device),
            act_hist=torch.zeros((n, MAX_ACTION_LATENCY, A), **kw),
            act_bias=torch.zeros((n, A), **kw),
            cube_pos_bias=torch.zeros((n, 3), **kw),
            dof_bias=torch.zeros((n, nh), **kw),
            act_scale=torch.ones((n, A), **kw),
            cube_pos_scale=torch.ones((n, 3), **kw),
            dof_scale=torch.ones((n, nh), **kw),
            held_pos=torch.zeros((n, 3), **kw),
            held_rot=torch.tensor([0.0, 0, 0, 1.0], **kw).repeat(n, 1),
            pose_counter=torch.zeros((n,), **kw))

    # -- draws -------------------------------------------------------------
    def _normal(self, shape):
        g = self.generator
        return torch.randn(shape, generator=g, device=g.device, dtype=DTYPE)

    def _uniform(self, shape):
        g = self.generator
        return torch.rand(shape, generator=g, device=g.device, dtype=DTYPE)

    def draw_reset(self):
        """The hand's reset draws (``ShadowHand.draw_reset``), then the six
        per-episode normals: action bias (N, A), cube-position bias (N, 3),
        dof bias (N, nh), action scale, cube-position scale, dof scale."""
        n, nh, A = self.num_envs, self.num_hand_dofs, self.num_actions
        return (*super().draw_reset(), self._normal((n, A)),
                self._normal((n, 3)), self._normal((n, nh)),
                self._normal((n, A)), self._normal((n, 3)),
                self._normal((n, nh)))

    def draw_pre(self):
        n = self.num_envs
        return PreDraws(noise=self._normal((n, self.num_actions)),
                        rna_u=self._uniform((n,)),
                        delay_u=self._uniform((n,)),
                        mask_u=self.rna.draw(self.generator),
                        hand=super().draw_pre())

    def draw_step(self):
        n = self.num_envs
        return StepDraws(goal_ang=self.draw_goal()[0],
                         unreliable_u=self._uniform((n,)),
                         pos_n=self._normal((n, 3)),
                         axis_n=self._normal((n, 3)),
                         ang_n=self._normal((n,)),
                         hold_u=self._uniform((n,)),
                         dof_n=self._normal((n, self.num_hand_dofs)))

    # ----------------------------------------------------------------------
    def pre_physics(self, state: EnvState, actions, draws=None):
        """The hand's control from the corrupted actions, and the carry:
        the hand's own and this task's updates (the RNA masks, the clock,
        the action ring)."""
        task: DextremeTaskState = state.task
        d = self.draw_pre() if draws is None else draws
        # the executed action: from the newest-first ring, per env delayed
        # by floor(latency) plus a random extra step
        act_hist = torch.cat([actions[:, None, :], task.act_hist[:, :-1]], 1)
        lat = torch.floor(self._adr_value(task, "action_latency"))
        extra = d.delay_u < self._adr_value(task, "action_delay_prob")
        lat = torch.clamp(lat + extra.to(DTYPE), 0, MAX_ACTION_LATENCY - 1)
        idx = lat.to(torch.int64)[:, None, None].expand(-1, 1, actions.shape[1])
        act = torch.gather(act_hist, 1, idx)[:, 0]
        # the affine corruption a x + b + c
        act = (task.act_scale * act + task.act_bias
               + self._col(task, "affine_action_white") * d.noise)
        if self.rna_enabled:
            dof_pos = self.engine.dof_pos(state.sim)[:, :self.num_hand_dofs]
            adv = self.rna(dof_pos, task.rna)
            alpha = torch.where(d.rna_u < self.rna_prob,
                                self._adr_value(task, "rna_alpha"),
                                0.0)[..., None]
            act = (1.0 - alpha) * act + alpha * adv
        act = torch.clamp(act, -1.0, 1.0)
        # the masks redrawn on the refresh clock (step 0 included)
        refresh = (task.step_count % self.rna_refresh) == 0
        fresh = self.rna.refresh(u=d.mask_u)
        masks = tuple(torch.where(refresh, f, o)
                      for f, o in zip(fresh, task.rna))
        ctrl, hand_carry = super().pre_physics(
            state._replace(task=task.hand), act, draws=d.hand)
        updates = dict(rna=masks, step_count=task.step_count + 1,
                       act_hist=act_hist)
        return ctrl, (hand_carry, updates)

    def reset_idx(self, sim: SimState, task: DextremeTaskState, mask,
                  draws=None):
        d = self.draw_reset() if draws is None else draws
        sim, hand = super().reset_idx(sim, task.hand, mask, draws=d[:4])
        task = task._replace(hand=hand)
        # per-episode affine corruption with the (adaptive) stds; the
        # action ring and the camera hold restart
        nb, pb, db, ns, ps, ds = d[4:10]
        col = lambda name: self._col(task, name)  # noqa: E731
        return sim, task._replace(
            act_hist=torch.where(mask[:, None, None], 0.0, task.act_hist),
            act_bias=masked_update(
                mask, col("affine_action_additive") * nb, task.act_bias),
            cube_pos_bias=masked_update(
                mask, col("affine_cube_pose_additive") * pb,
                task.cube_pos_bias),
            dof_bias=masked_update(
                mask, col("affine_dof_pos_additive") * db, task.dof_bias),
            act_scale=masked_update(
                mask, 1.0 + col("affine_action_scaling") * ns,
                task.act_scale),
            cube_pos_scale=masked_update(
                mask, 1.0 + col("affine_cube_pose_scaling") * ps,
                task.cube_pos_scale),
            dof_scale=masked_update(
                mask, 1.0 + col("affine_dof_pos_scaling") * ds,
                task.dof_scale),
            pose_counter=torch.where(mask, 0.0, task.pose_counter))

    def post_physics(self, state: EnvState, out, actions, *, carry,
                     draws=None):
        task: DextremeTaskState = state.task
        n, nh = self.num_envs, self.num_hand_dofs
        d = self.draw_step() if draws is None else draws
        hand_carry, updates = carry
        _, _, rew, reset, hand, extras = super().post_physics(
            state._replace(task=task.hand), out, actions, carry=hand_carry,
            draws=(d.goal_ang,))

        # the observed cube pose: camera noise with unreliable jumps
        obj = out.root_states[:, 1]
        obj_pos, obj_rot = obj[:, 0:3], obj[:, 3:7]
        unreliable = d.unreliable_u < self.unreliable_prob
        pos_std = torch.where(unreliable, self.unreliable_pos_jump,
                              self._adr_value(task, "affine_cube_pose_white"))
        rot_std = torch.where(unreliable, self.unreliable_rot_jump,
                              self._adr_value(task, "affine_cube_rot_white"))
        noisy_pos = (task.cube_pos_scale * obj_pos + task.cube_pos_bias
                     + pos_std[:, None] * d.pos_n)
        axis = d.axis_n / torch.clamp(torch.linalg.vector_norm(
            d.axis_n, dim=-1, keepdim=True), min=1e-8)
        noisy_rot = maths.quat_mul(
            maths.quat_from_angle_axis(rot_std * d.ang_n, axis), obj_rot)
        # the camera refresh: the pose updates every refresh-rate steps,
        # with a random extra hold
        counter = task.pose_counter - 1.0
        refresh_now = counter <= 0.0
        extra_hold = d.hold_u < self._adr_value(task, "cube_obs_delay_prob")
        rate = torch.round(self._adr_value(task, "cube_pose_refresh_rate"))
        next_counter = torch.where(refresh_now, rate + extra_hold.to(DTYPE),
                                   counter)
        held_pos = torch.where(refresh_now[:, None], noisy_pos, task.held_pos)
        held_rot = torch.where(refresh_now[:, None], noisy_rot, task.held_rot)

        dof_pos = self.engine.dof_pos(state.sim)[:, :nh]
        dof_vel = self.engine.dof_vel(state.sim)[:, :nh]
        goal_pos = self._goal_pos.expand(n, 3)
        goal_conj = maths.quat_conjugate(hand.goal_rot)
        dof_unit = maths.unscale(dof_pos, self.dof_lower, self.dof_upper)
        dof_obs = (task.dof_scale * dof_unit + task.dof_bias
                   + self._col(task, "affine_dof_pos_white") * d.dof_n)
        obs = torch.cat([
            dof_obs, held_pos, held_rot, goal_pos, hand.goal_rot,
            maths.quat_mul(held_rot, goal_conj), actions], -1)
        # the critic sees the true state
        states = torch.cat([
            dof_unit, obj_pos, obj_rot, goal_pos, hand.goal_rot,
            maths.quat_mul(obj_rot, goal_conj), actions,
            self.vel_obs_scale * dof_vel,
            self.force_torque_obs_scale * out.dof_force[:, self._hand_dofs_t],
            obj[:, 7:13],
            self.force_torque_obs_scale * out.sensor_forces.reshape(n, -1),
        ], -1)
        task = task._replace(hand=hand, held_pos=held_pos, held_rot=held_rot,
                             pose_counter=next_counter, **updates)
        task = self._adr_update(task, reset, hand)
        return obs, states, rew, reset, task, extras

    def _adr_update(self, task, reset, hand):
        return task


class AllegroHandDextremeADR(AllegroHandDextremeManualDR):
    """ADR variant: the reference's 27-parameter tree
    (cfg/task/AllegroHandDextremeADR.yaml:250-422) adapts through boundary
    workers (adr_vec_task.py:489-920)."""

    use_adr = True

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)
        adr_cfg = dict(cfg.get("adr") or {})
        adr_cfg.setdefault("params", DEFAULT_ADR_PARAMS)
        self.adr = ADR(adr_config_from_params(adr_cfg), self.num_envs,
                       device=self.device)
        self._adr_idx = {nm: i for i, nm in enumerate(self.adr.cfg.names)}
        # per-dof / per-body wiring of the physics-level parameters
        m = self.model
        nv, nb = self.engine.nv, self.engine.nb
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=self.device)
        hand_dof = np.zeros(nv, np.float32)
        hand_dof[self.hand_dofs] = 1.0
        obj_body = m.body_names.index("object")
        hand_body = np.ones(nb, np.float32)
        hand_body[obj_body] = 0.0
        ft = np.zeros(nb, np.float32)
        ft[self.fingertip_bodies] = 1.0
        self._hand_dof_mask = f32(hand_dof)
        self._hand_body_mask = f32(hand_body)
        self._obj_body_mask = f32(np.eye(nb, dtype=np.float32)[obj_body])
        self._fingertip_body_mask = f32(ft)

    def _adr_value(self, task: DextremeTaskState, name: str):
        # the ManualDR rot-noise name rides the adaptive cube-pose std
        if name == "affine_cube_rot_white":
            name = "affine_cube_pose_white"
        if task.adr_params is not None and name in self._adr_idx:
            return task.adr_params[:, self._adr_idx[name]]
        return super()._adr_value(task, name)

    def initial_task_state(self):
        st = self.adr.init()
        return super().initial_task_state()._replace(
            adr=st, adr_params=self.adr.sample(st, self.generator))

    def initial_state(self) -> EnvState:
        """The engine's scales of the first step come from the same
        parameter rows as the task state (the JAX ``initial_phys`` and
        ``initial_task_state`` share one draw)."""
        st = super().initial_state()
        return st._replace(phys=self.phys_from_params(st.task.adr_params))

    def phys_from_params(self, params: torch.Tensor) -> PhysScales:
        """The engine's per-property values from the sampled rows
        (N, P): drive damping / stiffness / effort, joint friction and
        armature scales and additive limit shifts on the hand dofs, per-body
        mass (hand and object), friction (fingertips and object) and
        restitution (hand and object)."""
        def v(name):
            return params[:, self._adr_idx[name], None]
        hd, hb, ob = (self._hand_dof_mask, self._hand_body_mask,
                      self._obj_body_mask)
        return PhysScales(
            mass=(1.0 + (v("hand_mass") - 1.0) * hb
                  + (v("object_mass") - 1.0) * ob),
            damping=1.0 + (v("hand_damping") - 1.0) * hd,
            stiffness=1.0 + (v("hand_stiffness") - 1.0) * hd,
            friction=(1.0 + (v("hand_friction_fingertips") - 1.0)
                      * self._fingertip_body_mask
                      + (v("object_friction") - 1.0) * ob),
            joint_friction=1.0 + (v("hand_joint_friction") - 1.0) * hd,
            armature=1.0 + (v("hand_armature") - 1.0) * hd,
            effort=1.0 + (v("hand_effort") - 1.0) * hd,
            dof_lower_shift=v("hand_lower") * hd,
            dof_upper_shift=v("hand_upper") * hd,
            restitution=(v("hand_restitution") * hb
                         + v("object_restitution") * ob))

    def update_phys(self, state: EnvState, reset_mask, fresh=None):
        """The scales of this step from the task's current rows.  The base
        step calls this before ``reset_idx`` (JAX base.py:237-242), so a
        reset env's fresh rows reach the engine one step later."""
        return self.phys_from_params(state.task.adr_params)

    def draw_reset(self):
        """The fresh rows' uniforms (N, P) (``fold_in(key, 11)``), then the
        ManualDR draws."""
        return (self.adr.draw(self.generator), *super().draw_reset())

    def reset_idx(self, sim: SimState, task: DextremeTaskState, mask,
                  draws=None):
        d = self.draw_reset() if draws is None else draws
        # the rows resampled first, so the per-episode biases drawn below
        # take the fresh stds
        fresh = self.adr.sample(task.adr, u=d[0])
        task = task._replace(adr_params=masked_update(mask, fresh,
                                                      task.adr_params))
        return super().reset_idx(sim, task, mask, draws=d[1:])

    def _adr_update(self, task: DextremeTaskState, reset, hand):
        # boundary performance: the episode's consecutive successes
        return task._replace(adr=self.adr.observe(task.adr, reset > 0,
                                                  hand.successes))

    def post_physics(self, state, out, actions, *, carry, draws=None):
        obs, states, rew, reset, task, extras = super().post_physics(
            state, out, actions, carry=carry, draws=draws)
        extras = dict(extras)
        extras["adr_npd"] = self.adr.npd(task.adr)
        return obs, states, rew, reset, task, extras

    def get_env_state(self, state: EnvState):
        """The ADR state persists into checkpoints
        (docs/domain_randomization.md:337), as a dict of its fields (a
        checkpoint holds only plain containers)."""
        return {"adr": dict(state.task.adr._asdict())}

    def set_env_state(self, state: EnvState, env_state):
        """``state`` with the ADR state of ``env_state`` (an
        :class:`ADRState` or the dict :meth:`get_env_state` gives)."""
        if env_state and "adr" in env_state:
            a = env_state["adr"]
            a = a._asdict() if hasattr(a, "_asdict") else a
            adr = ADRState(**{k: torch.as_tensor(a[k], dtype=DTYPE,
                                                 device=self.device)
                              for k in ADRState._fields})
            return state._replace(task=state.task._replace(adr=adr))
        return state
