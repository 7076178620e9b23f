"""Vectorized env runtime (port of isaacgymenvs_ma_tpu/tasks/base.py).

``VecTaskBase.step`` keeps the JAX package's ordering exactly: clip actions
-> pre_physics -> ``control_freq_inv x`` engine.step -> sim-health net ->
progress += 1 -> masked ``reset_idx`` of the envs flagged on the *previous*
step -> readout refresh -> obs/reward -> timeouts -> clip obs.  ``reset_buf``
starts at 1, so the first step resets every env after physics (before
physics for tasks with ``reset_in_pre_physics``, as BallBalance).

The JAX version threads a PRNG key through ``EnvState``; here each task
owns a ``torch.Generator`` (``task.generator``) for its random draws, and
``step`` also accepts explicit ``reset_draws`` (``reset_idx``'s),
``pre_draws`` (``pre_physics``'s, for the tasks that draw there:
AllegroKuka's random object forces), ``step_draws`` (``post_physics``'s,
for the tasks that draw there: AnymalTerrain's pushes and observation
noise, Ingenuity's new targets, the hands' resampled goals) and
``dr_draws`` (the domain randomization's) so tests can inject the
reference's draws.  A task that takes draws in one of those hooks takes
them as its ``draws`` keyword, which the step passes only when it is given
them.

A task whose ``post_physics`` needs values its ``pre_physics`` computed
(the hands' new targets and object force) returns ``(Control, carry)``
from ``pre_physics`` and takes the carry back as ``post_physics``'s
``carry`` keyword, instead of keeping it on the task object.

A task may restart the episode clock of some envs without resetting them
(AllegroKuka on a success): its ``post_physics`` puts the mask in
``extras["_reset_progress_mask"]``, and the step zeroes ``progress`` there
after the time-outs are read from the old clock (base.py:286-292).
``get_env_state`` / ``set_env_state`` carry a task's curriculum through a
checkpoint (AllegroKuka's success tolerance); the other tasks have none.

With ``task.randomize`` the step adds the domain randomizer
(utils/domain_rand.py) in the JAX order (base.py:228-307): action noise
before the clip, the physics scales of the envs flagged on the previous
step resampled before physics (so those envs step once more with their new
scales, then reset), observation noise before the clip.  The scales ride
in ``EnvState.phys``.  A task whose ``post_physics``
changes the physics state (AnymalTerrain's pushes) returns the new
``SimState`` as a seventh value; the step carries it on.

Multi-agent tasks (``numAgents`` K > 1, the MA fork) fold the agents into
the batch: actions, obs, rewards, resets and time-outs have
``rl_games_batch`` = N * K rows, agent-minor (row n * K + k), while the
physics state, progress and ``reset_buf`` stay per env (base.py:154,
:357-369).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..device import DTYPE, resolve_device
from ..ops.rng import make_generator
from ..physics.engine import (Control, PhysicsEngine, SimOutput, SimParams,
                              SimState)
from ..utils.domain_rand import DomainRandomizer


class EnvState(NamedTuple):
    sim: SimState
    progress: torch.Tensor        # (N,) int32
    reset_buf: torch.Tensor       # (N,) int32 — starts at 1
    task: Any = None              # task-specific state (potentials, ...)
    phys: Any = None              # PhysScales of the domain randomization


class StepResult(NamedTuple):
    obs: torch.Tensor             # (B, num_obs) clipped
    states: Optional[torch.Tensor]
    rew: torch.Tensor             # (B,)
    reset: torch.Tensor           # (B,) int32
    extras: Dict[str, Any]


def parse_sim_params(sim_cfg: dict) -> SimParams:
    """Map the reference sim-config schema (vec_task.py:516-564) to
    SimParams, exactly as the JAX package does (base.py:54-103)."""
    import os
    physx = sim_cfg.get("physx", {})
    n_iter = int(physx.get("num_position_iterations", 4)) + int(
        physx.get("num_velocity_iterations", 0))
    return SimParams(
        dt=float(sim_cfg.get("dt", 1.0 / 60.0)),
        substeps=int(sim_cfg.get("substeps", 2)),
        gravity=tuple(sim_cfg.get("gravity", (0.0, 0.0, -9.81))),
        num_iterations=(int(physx["num_iterations"])
                        if "num_iterations" in physx
                        else max(2 * n_iter, 8)),
        warm_start=float(physx.get("warm_start", 0.0)),
        max_depenetration_velocity=float(
            physx.get("max_depenetration_velocity", 10.0)),
        contact_margin=float(physx.get("contact_offset", 0.0)),
        bounce_threshold_velocity=float(
            physx.get("bounce_threshold_velocity", 0.2)),
        reuse_mass_matrix=bool(physx.get(
            "reuse_mass_matrix",
            os.environ.get("IGMA_MM_REUSE", "1") == "1")),
        contact_capacity=(int(physx["contact_capacity"])
                          if physx.get("contact_capacity") is not None
                          else None),
        reuse_contact_rows=bool(physx.get(
            "reuse_contact_rows",
            os.environ.get("IGMA_ROW_REUSE", "0") == "1")),
        contact_continuation=bool(physx.get("contact_continuation", True)),
        mass_splitting=bool(physx.get("mass_splitting", False)),
    )


class VecTaskBase:
    """Static config + engine; the step is a function of (state, actions).

    ``device`` defaults to the card; ``sim_params`` replaces the SimParams
    parsed from ``cfg["sim"]`` (e.g. with ``use_contact_kernel=True``, which
    has no config key)."""

    # BallBalance resets in pre_physics_step (base.py:110-111)
    reset_in_pre_physics = False
    # tasks whose flat obs concatenate named groups (``obs_spec``;
    # Dextreme): get_env_info serves the dict space
    dict_obs_cls = False

    def __init__(self, cfg: dict, device="cuda", seed: int = 0,
                 sim_params: Optional[SimParams] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        eng = str(cfg.get("physics_engine", "physx"))
        if eng not in ("physx", ""):
            raise NotImplementedError(
                f"physics_engine={eng!r} is not supported: only the "
                "PhysX-equivalent rigid-body path exists")
        env_cfg = cfg["env"]
        self.num_envs = int(env_cfg["numEnvs"])
        # the global id of this process's first env when the envs are split
        # over ranks (parallel/mesh.py): tasks that lay envs out by their
        # index (AnymalTerrain's terrain types, AllegroKuka's cuboids) use
        # the global index, so a rank's envs are the slice of one program's
        self.env_offset = int(env_cfg.get("envOffset", 0))
        self.num_obs = int(env_cfg["numObservations"])
        self.num_actions = int(env_cfg["numActions"])
        self.num_states = int(env_cfg.get("numStates", 0))
        self.num_agents = int(env_cfg.get("numAgents", 1))
        self.clip_obs = float(env_cfg.get("clipObservations", math.inf))
        self.clip_actions = float(env_cfg.get("clipActions", math.inf))
        self.control_freq_inv = int(env_cfg.get("controlFrequencyInv", 1))
        self.max_episode_length = int(env_cfg.get("episodeLength", 500))
        self.sim_params = (parse_sim_params(cfg.get("sim", {}))
                           if sim_params is None else sim_params)
        self.dt = self.sim_params.dt
        self.terrain = None            # a TerrainGrid (AnymalTerrain)
        task_sec = cfg.get("task", {}) or {}
        self.randomizer = None
        if task_sec.get("randomize"):
            # the correlated-noise bases are per env: the agent-folded MA
            # batch gets none (base.py:138-147)
            single = self.num_agents == 1
            self.randomizer = DomainRandomizer(
                task_sec.get("randomization_params", {}), self.num_envs,
                num_obs=self.num_obs if single else None,
                num_actions=self.num_actions if single else None)
        self.generator = make_generator(seed, self.device)
        model, ground = self.create_model()
        self.model = model
        if self.randomizer is not None:
            self.randomizer.bind_model(model)
        self.engine = self.build_engine(model, ground)
        self.rl_games_batch = self.num_envs * self.num_agents

    # ------------------------------------------------------------------
    # hooks for concrete tasks
    def create_model(self):
        """Return (SceneModel, ground: bool)."""
        raise NotImplementedError

    def build_engine(self, model, ground: bool) -> PhysicsEngine:
        return PhysicsEngine(model, self.sim_params, ground=ground,
                             device=self.device)

    def initial_task_state(self) -> Any:
        return None

    def step_terrain(self, sim: SimState):
        """Terrain the control step's physics stands on (base.py:169-175);
        the JAX AnymalTerrain returns per-env windows of it here, the port
        the global grid itself."""
        return self.terrain

    def pre_physics(self, state: EnvState, actions) -> Control:
        raise NotImplementedError

    def post_physics(self, state: EnvState, out: SimOutput, actions):
        """Return (obs, states, rew, reset, task_state, extras) and, where
        it changes the physics state, the new ``SimState``."""
        raise NotImplementedError

    def reset_idx(self, sim: SimState, task: Any, mask, draws=None):
        """Masked per-env reset: return (sim', task').  ``draws`` are the
        task's random reset draws; None draws them from ``self.generator``."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    def initial_phys(self):
        """The physics scales of a fresh run (base.py:191-200): the
        randomizer's setup_only draws from the task's generator, or None
        without domain randomization."""
        if self.randomizer is None or not self.randomizer.enabled:
            return None
        return self.randomizer.initial_phys(self.generator, self.model.nb,
                                            self.device)

    def update_phys(self, state: EnvState, reset_mask, fresh=None):
        """The scales of the envs in ``reset_mask`` resampled (base.py:
        202-209, DR at reset); ``fresh`` the draws (every env's new
        values, ``DomainRandomizer.draw_resample``)."""
        if self.randomizer is None or state.phys is None:
            return state.phys
        if fresh is None:
            fresh = self.randomizer.draw_resample(self.generator, state.phys)
        return self.randomizer.resample_phys(reset_mask, state.phys, fresh)

    def initial_state(self) -> EnvState:
        n = self.num_envs
        return EnvState(
            sim=self.engine.default_state(n),
            progress=torch.zeros(n, dtype=torch.int32, device=self.device),
            reset_buf=torch.ones(n, dtype=torch.int32, device=self.device),
            task=self.initial_task_state(), phys=self.initial_phys())

    def reset(self, state: EnvState):
        """Initial obs (vec_task.py:428-440: no recompute, just zeros),
        one row per agent."""
        return state, torch.zeros((self.rl_games_batch, self.num_obs),
                                  dtype=DTYPE, device=self.device)

    def get_env_state(self, state: EnvState):
        """Curriculum state persisted into learner checkpoints
        (vec_task.py:197-205); None for a task without one."""
        return None

    def set_env_state(self, state: EnvState, env_state):
        """``state`` with the curriculum state ``env_state`` (what
        ``get_env_state`` returned) put back."""
        return state

    def render(self, state: EnvState, mode: str = "rgb_array",
               env_index: int = 0, **camera_kwargs):
        """Headless frame render (base.py:397-409; vec_task.py:459-514
        ``render`` with ``virtual_screen_capture``): (H, W, 3) uint8 via
        utils/viewer.py, from the poses of ``engine.forward`` (B1 on the
        card), of which only env ``env_index``'s are read to the host."""
        if mode != "rgb_array":
            raise ValueError("only rgb_array rendering is supported headless")
        from ..utils.viewer import env_poses, render_rgb
        bp, bq = env_poses(self.engine, state.sim, env_index)
        return render_rgb(self.model, bp, bq, ground=self.engine.ground,
                          **camera_kwargs)

    def set_train_info(self, state: EnvState, env_frames: int):
        """The learner-to-env channel for curricula (vec_task.py:188-194);
        no ported task has one."""
        return state

    def step(self, state: EnvState, actions: torch.Tensor,
             reset_draws=None, step_draws=None, dr_draws=None,
             pre_draws=None) -> Tuple[EnvState, StepResult]:
        """One control step.  ``dr_draws`` (with domain randomization): a
        dict with any of "actions" and "observations" (the white noise
        samples) and "phys" (the resampled scales, every env's), each
        drawn from the generator where missing."""
        dr = self.randomizer
        draws = dr_draws or {}
        if dr is not None:
            # action noise before the clip (vec_task.py:373-376), with the
            # correlated base of the state before this step's resample
            noise = draws.get("actions")
            if noise is None:
                noise = dr.action_noise(self.generator, actions.shape)
            actions = dr.randomize_actions(
                actions, noise, corr=getattr(state.phys, "act_corr", None))
        actions = torch.clamp(actions, -self.clip_actions, self.clip_actions)
        reset_mask = state.reset_buf > 0
        phys = self.update_phys(state, reset_mask, draws.get("phys"))
        if phys is not state.phys:
            state = state._replace(phys=phys)
        if self.reset_in_pre_physics:
            sim, task = self.reset_idx(state.sim, state.task, reset_mask,
                                       reset_draws)
            sim = self._restore_lam(sim, state.sim.lam, reset_mask)
            state = state._replace(sim=sim, task=task)
        ctrl = self.pre_physics(
            state, actions,
            **({} if pre_draws is None else {"draws": pre_draws}))
        post_kw = {} if step_draws is None else {"draws": step_draws}
        if not isinstance(ctrl, Control):
            ctrl, post_kw["carry"] = ctrl
        sim = state.sim
        terrain = self.step_terrain(sim)
        out = None
        for _ in range(self.control_freq_inv):
            sim, out = self.engine.step(sim, ctrl, terrain=terrain,
                                        phys=state.phys)

        # ---- sim-health safety net (base.py:254-267): sanitize exploded
        # envs and force-reset them next step
        unhealthy = (~torch.isfinite(sim.q).all(dim=-1)
                     | ~torch.isfinite(sim.qd).all(dim=-1)
                     | (torch.abs(sim.qd).amax(dim=-1) > 500.0))
        sim = sim._replace(
            q=torch.where(unhealthy[:, None], torch.nan_to_num(sim.q), sim.q),
            qd=torch.where(unhealthy[:, None],
                           torch.clamp(torch.nan_to_num(sim.qd), -500.0, 500.0),
                           sim.qd))

        # ---- post physics (base.py:269-283 ordering)
        progress = state.progress + 1
        task = state.task
        lam_cur = sim.lam
        if not self.reset_in_pre_physics:
            sim, task = self.reset_idx(sim, task, reset_mask, reset_draws)
            sim = self._restore_lam(sim, lam_cur, reset_mask | unhealthy)
        else:
            sim = self._restore_lam(sim, lam_cur, unhealthy)
        progress = torch.where(reset_mask, 0, progress).to(torch.int32)
        out = self.engine.forward(sim, prev_out=out)

        mid = state._replace(sim=sim, progress=progress, task=task)
        post = self.post_physics(mid, out, actions, **post_kw)
        obs, states, rew, reset, task, extras = post[:6]
        if len(post) == 7:
            sim = post[6]

        timeout = (progress >= self.max_episode_length - 1) & (reset != 0)
        extras = dict(extras)
        extras["time_outs"] = self._to_batch(timeout)
        # episode-extension hook: envs whose clock restarts without a reset
        clock_reset = extras.pop("_reset_progress_mask", None)
        if clock_reset is not None:
            progress = torch.where(clock_reset, 0, progress).to(torch.int32)
        if dr is not None:
            # observation noise before the clip (vec_task.py:404-406)
            noise = draws.get("observations")
            if noise is None:
                noise = dr.obs_noise(self.generator, obs.shape)
            obs = dr.randomize_observations(
                obs, noise, corr=getattr(state.phys, "obs_corr", None))
        obs = torch.nan_to_num(torch.clamp(obs, -self.clip_obs, self.clip_obs))
        if states is not None:
            states = torch.nan_to_num(
                torch.clamp(states, -self.clip_obs, self.clip_obs))
        rew = torch.nan_to_num(rew)
        reset = torch.where(unhealthy, 1, reset).to(torch.int32)

        new_state = EnvState(sim=sim, progress=progress, reset_buf=reset,
                             task=task, phys=state.phys)
        return new_state, StepResult(obs=obs, states=states, rew=rew,
                                     reset=self._to_batch(reset),
                                     extras=extras)

    def reset_done(self, state: EnvState, reset_draws=None, pre_draws=None,
                   step_draws=None, phys_draws=None):
        """Learner-driven reset (base.py:311-340, vec_task.py:442-457):
        reset every env whose ``reset_buf`` is set, recompute the
        observations of the fresh state with zero actions and clear the
        flags.  Returns ``(state', obs, states)``; the done ids are read
        on the host by the :class:`..utils.rlgames_utils.RLGPUEnv` shim.
        ``pre_physics`` runs first, its control discarded, and its carry
        goes to ``post_physics`` (whose task-state updates are kept, its
        reward and resets discarded).  The draws are ``step``'s, each from
        the generator where missing."""
        mask = state.reset_buf > 0
        phys = self.update_phys(state, mask, phys_draws)
        sim, task = self.reset_idx(state.sim, state.task, mask, reset_draws)
        sim = self._restore_lam(sim, state.sim.lam, mask)
        progress = torch.where(mask, 0, state.progress).to(torch.int32)
        out = self.engine.forward(sim)
        mid = EnvState(sim=sim, progress=progress,
                       reset_buf=torch.zeros_like(state.reset_buf),
                       task=task, phys=phys)
        zeros = self.zero_actions()
        ctrl = self.pre_physics(
            mid, zeros, **({} if pre_draws is None else {"draws": pre_draws}))
        post_kw = {} if step_draws is None else {"draws": step_draws}
        if not isinstance(ctrl, Control):
            post_kw["carry"] = ctrl[1]
        obs, states, _rew, _reset, task, _extras = self.post_physics(
            mid, out, zeros, **post_kw)[:6]
        obs = torch.nan_to_num(torch.clamp(obs, -self.clip_obs, self.clip_obs))
        if states is not None:
            states = torch.nan_to_num(
                torch.clamp(states, -self.clip_obs, self.clip_obs))
        return mid._replace(task=task), obs, states

    @staticmethod
    def _restore_lam(sim: SimState, lam_prev, zero_mask) -> SimState:
        """The warm-start impulses re-attached after a task's ``reset_idx``
        rebuilt ``SimState(q, qd)`` without them (base.py:343-356), zeroed
        for the envs in ``zero_mask`` (reset or found unhealthy: a fresh env
        has no persistent contacts).  Impulses ``reset_idx`` kept are the
        ones zeroed."""
        if lam_prev is None:
            return sim
        if sim.lam is not None:
            lam_prev = sim.lam
        return sim._replace(lam=tuple(
            torch.where(zero_mask.reshape((-1,) + (1,) * (x.dim() - 1)),
                        0.0, x) for x in lam_prev))

    def get_env_info(self) -> dict:
        """The learner contract (base.py ``get_env_info``, SURVEY.md
        Appendix B): action and observation spaces, the agent count and,
        with a critic, the state space; a ``dict_obs_cls`` task's
        observation space is the dict of its ``obs_spec`` groups."""
        info = {"action_space": (self.num_actions,),
                "observation_space": (self.num_obs,),
                "agents": self.num_agents}
        if self.num_states > 0:
            info["state_space"] = (self.num_states,)
        if self.dict_obs_cls and getattr(self, "obs_spec", None):
            info["observation_space"] = {n: (s,) for n, s in self.obs_spec}
        return info

    def _to_batch(self, per_env: torch.Tensor) -> torch.Tensor:
        """Per-env values to per-agent rows (base.py:357-366); values that
        already have a row per agent pass through."""
        if self.num_agents == 1 or per_env.shape[0] == self.rl_games_batch:
            return per_env
        return torch.repeat_interleave(per_env, self.num_agents, dim=0)

    def zero_actions(self) -> torch.Tensor:
        return torch.zeros((self.rl_games_batch, self.num_actions),
                           dtype=DTYPE, device=self.device)


def masked_update(mask, new, old):
    """Apply ``new`` where mask (broadcast over trailing dims)."""
    m = mask.reshape(mask.shape + (1,) * (old.dim() - mask.dim()))
    return torch.where(m, new, old)
