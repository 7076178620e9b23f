"""Domain randomization (port of isaacgymenvs_ma_tpu/utils/domain_rand.py;
reference ``vec_task.py:612-842`` and ``utils/dr_utils.py``).

Per-env physical parameters are batched leaves of a :class:`PhysScales`
tuple of tensors, resampled (masked, at reset) inside the step; the engine
reads them (mass and shape through kernel B2 and the gravity wrench of
kernel B3, friction through the contact rows' ``mu``, stiffness and damping
through the drives and the implicit diagonal).  Observation and action
noise follow the reference's ``randomization_params`` schema
(cfg/task/Ant.yaml:66-105): ``observations`` / ``actions``
({range, range_correlated, operation: additive|scaling, distribution:
gaussian|uniform|loguniform, schedule: linear|constant}) and
``actor_params.<actor>.{rigid_body_properties.mass, scale,
rigid_shape_properties.friction, dof_properties.{damping, stiffness}}``.

Every sample comes from an explicit ``torch.Generator``.  The JAX package
splits ``jax.random`` keys, whose streams cannot be matched, so the noise
and the resampled scales a step takes are separate draws
(:meth:`DomainRandomizer.action_noise`, ``obs_noise``, ``draw_resample``)
that the step also accepts from outside, which is how the parity tests
feed the reference's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DTYPE


class PhysScales(NamedTuple):
    """Per-env multiplicative physics factors consumed by the engine
    (domain_rand.py:27-58)."""

    mass: torch.Tensor        # (N, 1) or (N, nb)
    damping: torch.Tensor     # (N, 1) or (N, nv): passive + drive damping
    stiffness: torch.Tensor   # (N, 1) or (N, nv): drive kp
    friction: torch.Tensor    # (N, 1) global or (N, nb) per-body contact
    #                           friction scale (pair rows average both ends)
    # (N, nb, 3) per-body geometry scale in the body frame; None = nominal
    shape: Optional[torch.Tensor] = None
    # correlated-noise bases (standard normal), refreshed at reset
    obs_corr: Optional[torch.Tensor] = None   # (N, num_obs)
    act_corr: Optional[torch.Tensor] = None   # (N, num_actions)
    # dof-property and restitution leaves of the JAX package's ADR tasks:
    # the engine scales joint friction, armature and effort limit with the
    # first three, shifts the dof limits by the next two and takes the
    # bounce restitution from the last (a call with it solves contacts on
    # the loop, as in JAX)
    joint_friction: Optional[torch.Tensor] = None
    armature: Optional[torch.Tensor] = None
    effort: Optional[torch.Tensor] = None
    dof_lower_shift: Optional[torch.Tensor] = None
    dof_upper_shift: Optional[torch.Tensor] = None
    restitution: Optional[torch.Tensor] = None

    @staticmethod
    def ones(n: int, device="cpu") -> "PhysScales":
        one = torch.ones((n, 1), dtype=DTYPE, device=device)
        return PhysScales(one, one, one, one)


def _schedule_factor(spec: dict, frames) -> float:
    """The schedule's scale of a spec at ``frames`` env frames
    (domain_rand.py:61-68)."""
    sched = spec.get("schedule", None)
    steps = float(spec.get("schedule_steps", 1)) or 1.0
    if sched == "linear":
        return min(float(frames) / steps, 1.0)
    if sched == "constant":
        return float(float(frames) >= steps)
    return 1.0


def _sample(gen, spec: dict, shape, frames) -> torch.Tensor:
    """A noise or scale sample as the reference's generate_random_samples
    (dr_utils.py:71-133, domain_rand.py:71-94): gaussian mu + var N(0, 1)
    (``range`` = [mu, var]), uniform or loguniform on ``range``, annealed
    by the schedule toward 0 (additive) or 1 (scaling)."""
    lo, hi = spec.get("range", [0.0, 1.0])
    dist = spec.get("distribution", "uniform")
    op = spec.get("operation", "additive")
    sf = _schedule_factor(spec, frames)
    draw = torch.randn if dist == "gaussian" else torch.rand
    r = draw(shape, generator=gen, device=gen.device, dtype=DTYPE)
    if dist == "gaussian":
        mu, var = lo, hi
        if op == "additive":
            mu, var = mu * sf, var * sf
        else:
            var = var * sf
            mu = mu * sf + 1.0 * (1.0 - sf)
        return mu + var * r
    if dist == "loguniform":
        lo_s = float(np.log(max(lo, 1e-8)))
        hi_s = float(np.log(max(hi, 1e-8)))
        samples = torch.exp(lo_s + (hi_s - lo_s) * r)
    else:
        samples = lo + (hi - lo) * r
    if op == "additive":
        return samples * sf
    return samples * sf + 1.0 * (1.0 - sf)


def _corr_term(spec: dict, base, frames):
    """Correlated-noise part from a cached N(0, 1) base (reference
    vec_task.py:686-692, 710-717; domain_rand.py:97-119): base * var_c +
    mu_c, scheduled as the white part; a uniform spec uses the normal base
    too, as the reference does."""
    lo_c, hi_c = spec.get("range_correlated", [0.0, 0.0])
    op = spec.get("operation", "additive")
    dist = spec.get("distribution", "uniform")
    sf = _schedule_factor(spec, frames)
    if dist == "gaussian":
        mu_c, var_c = lo_c, hi_c
        if op == "additive":
            mu_c, var_c = mu_c * sf, var_c * sf
        else:
            var_c = var_c * sf
            mu_c = mu_c * sf + 1.0 * (1.0 - sf)
        return base * var_c + mu_c
    if op == "additive":
        lo_c, hi_c = lo_c * sf, hi_c * sf
    else:
        lo_c = lo_c * sf + 1.0 * (1.0 - sf)
        hi_c = hi_c * sf + 1.0 * (1.0 - sf)
    return base * (hi_c - lo_c) + lo_c


def _has_corr(spec) -> bool:
    return bool(spec) and any(spec.get("range_correlated", [0.0, 0.0]))


class DomainRandomizer:
    """The parsed ``randomization_params`` of one task (domain_rand.py:
    126-335).  ``bind_model`` resolves actor names to body ranges; the
    sampling methods draw from the generator ``gen``."""

    def __init__(self, params: dict, num_envs: int,
                 num_obs: Optional[int] = None,
                 num_actions: Optional[int] = None):
        self.params = params or {}
        self.num_envs = num_envs
        self.obs_spec = self.params.get("observations")
        self.act_spec = self.params.get("actions")
        # correlated noise needs per-env bases of a known width
        self._num_obs = num_obs
        self._num_actions = num_actions
        self.obs_corr_on = _has_corr(self.obs_spec) and num_obs is not None
        self.act_corr_on = (_has_corr(self.act_spec)
                            and num_actions is not None)
        # mass and scale specs keep their actor; the dof and friction
        # factors are scene-global (N, 1)
        self.mass_specs = []       # [(actor, spec)]
        self.damping_spec = None
        self.stiffness_spec = None
        self.friction_spec = None
        self.scale_specs = {}      # actor -> spec
        self._actor_bodies = {}
        self._nb = None
        for actor, props in (self.params.get("actor_params") or {}).items():
            rb = props.get("rigid_body_properties", {})
            if "mass" in rb:
                self.mass_specs.append((actor, rb["mass"]))
            dp = props.get("dof_properties", {})
            if "damping" in dp:
                self.damping_spec = dp["damping"]
            if "stiffness" in dp:
                self.stiffness_spec = dp["stiffness"]
            rs = props.get("rigid_shape_properties", {})
            if "friction" in rs:
                self.friction_spec = rs["friction"]
            if "scale" in props:
                self.scale_specs[actor] = props["scale"]

    @property
    def enabled(self) -> bool:
        return bool(self.params)

    def bind_model(self, model):
        """Actor names of the mass and scale specs -> their bodies (an
        actor's bodies are contiguous after compose_scene; matched by the
        root body's name).  An unresolved actor applies scene-wide."""
        self._nb = int(model.nb)
        names = {a for a, _ in self.mass_specs} | set(self.scale_specs)
        roots = np.asarray(model.actor_root_body, np.int64)
        ends = list(roots[1:]) + [model.nb]
        for actor in names:
            for r, e_ in zip(roots, ends):
                if model.body_names[int(r)] == actor:
                    self._actor_bodies[actor] = np.arange(r, e_)
                    break

    # -- mass ------------------------------------------------------------
    def _mass_specs(self, setup_pass: bool):
        return [(a, s) for a, s in self.mass_specs
                if bool(s.get("setup_only", False)) == setup_pass]

    def _apply_mass_specs(self, gen, mask, cur, setup_pass: bool,
                          frames=1e9):
        """Apply the mass specs whose setup_only flag is ``setup_pass``
        (domain_rand.py:190-217); ``mask`` None = every env."""
        n = self.num_envs
        for actor, spec in self._mass_specs(setup_pass):
            s = _sample(gen, spec, (n, 1), frames)
            if spec.get("operation") == "additive":
                s = 1.0 + s
            bodies = self._actor_bodies.get(actor)
            if bodies is None:
                new = s.expand(cur.shape)
                cur = new if mask is None else torch.where(mask[:, None],
                                                           new, cur)
            else:
                if cur.shape[-1] != self._nb:
                    cur = cur.expand(n, self._nb)
                cur = cur.clone()
                new = s.expand(n, len(bodies))
                old = cur[:, bodies]
                cur[:, bodies] = (new if mask is None else
                                  torch.where(mask[:, None], new, old))
        return cur

    # -- shape -----------------------------------------------------------
    def _scale_bound(self):
        return {a: b for a, b in self._actor_bodies.items()
                if a in self.scale_specs}

    def _sample_scale(self, gen, spec):
        s = _sample(gen, spec, (self.num_envs, 1, 1), 1e9)
        if spec.get("operation") == "additive":
            s = 1.0 + s
        return s

    def initial_shape(self, gen, nb: int, device):
        """(N, nb, 3) per-body geometry scales, or None when no scale spec
        binds (domain_rand.py:248-260)."""
        bound = self._scale_bound()
        if not bound:
            return None
        shape = torch.ones((self.num_envs, nb, 3), dtype=DTYPE, device=device)
        for actor, bodies in bound.items():
            s = self._sample_scale(gen, self.scale_specs[actor])
            shape[:, bodies, :] = s.expand(self.num_envs, len(bodies), 3)
        return shape

    def resample_shape(self, mask, shape, fresh):
        """The at-reset resample of the scale specs that are not
        setup_only (domain_rand.py:262-276): ``fresh`` (N, nb, 3) holds
        the new scales of every env."""
        bound = self._scale_bound()
        if shape is None or not bound:
            return shape
        shape = shape.clone()
        for actor, bodies in bound.items():
            if self.scale_specs[actor].get("setup_only", False):
                continue
            shape[:, bodies, :] = torch.where(mask[:, None, None],
                                              fresh[:, bodies, :],
                                              shape[:, bodies, :])
        return shape

    # -- state -----------------------------------------------------------
    def initial_phys(self, gen, nb: int, device) -> PhysScales:
        """PhysScales at t = 0 (domain_rand.py:219-236): the setup_only
        specs drawn once, the correlated bases drawn, everything else 1."""
        n = self.num_envs
        kw = dict(generator=gen, device=device, dtype=DTYPE)
        phys = PhysScales.ones(n, device)
        phys = phys._replace(mass=self._apply_mass_specs(
            gen, None, phys.mass, True))
        shape = self.initial_shape(gen, nb, device)
        if shape is not None:
            phys = phys._replace(shape=shape)
        if self.obs_corr_on:
            phys = phys._replace(obs_corr=torch.randn((n, self._num_obs),
                                                      **kw))
        if self.act_corr_on:
            phys = phys._replace(act_corr=torch.randn((n, self._num_actions),
                                                      **kw))
        return phys

    def draw_resample(self, gen, phys: PhysScales, frames=1e9) -> PhysScales:
        """Fresh values of every leaf that ``resample_phys`` resamples,
        for every env (the other leaves are ``phys``'s): the draws a reset
        takes.  The reference's draws are the JAX ``resample_phys`` with
        every env masked."""
        n = self.num_envs
        dev = phys.mass.device
        mass = self._apply_mass_specs(gen, None, phys.mass, False, frames)

        def fresh(spec, cur):
            if not spec:
                return cur
            new = _sample(gen, spec, (n, 1), frames)
            if spec.get("operation") == "additive":
                new = 1.0 + new
            return new

        shape = phys.shape
        if shape is not None:
            shape = shape.clone()
            for actor, bodies in self._scale_bound().items():
                spec = self.scale_specs[actor]
                if spec.get("setup_only", False):
                    continue
                shape[:, bodies, :] = self._sample_scale(gen, spec).expand(
                    n, len(bodies), 3)
        randn = lambda x: None if x is None else torch.randn(  # noqa: E731
            x.shape, generator=gen, device=dev, dtype=DTYPE)
        return phys._replace(
            mass=mass, damping=fresh(self.damping_spec, phys.damping),
            stiffness=fresh(self.stiffness_spec, phys.stiffness),
            friction=fresh(self.friction_spec, phys.friction), shape=shape,
            obs_corr=randn(phys.obs_corr), act_corr=randn(phys.act_corr))

    def resample_phys(self, mask, phys: PhysScales, fresh: PhysScales
                      ) -> PhysScales:
        """The masked per-env resample at reset (domain_rand.py:304-335):
        the envs of ``mask`` take ``fresh``'s values (see
        :meth:`draw_resample`) of every leaf a spec resamples, and new
        correlated-noise bases."""
        m = mask[:, None]

        def pick(resampled, new, cur):
            if not resampled or cur is None:
                return cur
            return torch.where(m, new, cur)     # (N, 1) and (N, nb) broadcast

        return phys._replace(
            mass=pick(bool(self._mass_specs(False)), fresh.mass, phys.mass),
            damping=pick(bool(self.damping_spec), fresh.damping,
                         phys.damping),
            stiffness=pick(bool(self.stiffness_spec), fresh.stiffness,
                           phys.stiffness),
            friction=pick(bool(self.friction_spec), fresh.friction,
                          phys.friction),
            shape=self.resample_shape(mask, phys.shape, fresh.shape),
            obs_corr=pick(True, fresh.obs_corr, phys.obs_corr),
            act_corr=pick(True, fresh.act_corr, phys.act_corr))

    # -- noise -----------------------------------------------------------
    def action_noise(self, gen, shape, frames=1e9) -> Optional[torch.Tensor]:
        """The white action-noise sample, or None without an actions
        spec."""
        if not self.act_spec:
            return None
        return _sample(gen, self.act_spec, shape, frames)

    def obs_noise(self, gen, shape, frames=1e9) -> Optional[torch.Tensor]:
        if not self.obs_spec:
            return None
        return _sample(gen, self.obs_spec, shape, frames)

    @staticmethod
    def _apply_noise(spec, x, noise, corr, frames):
        if not spec:
            return x
        if corr is not None:
            noise = noise + _corr_term(spec, corr, frames)
        if spec.get("operation", "additive") == "additive":
            return x + noise
        return x * noise

    def randomize_actions(self, actions, noise, frames=1e9, corr=None):
        """Actions with noise (domain_rand.py:283-291): ``noise`` the white
        sample (:meth:`action_noise`), ``corr`` the env's correlated
        base."""
        return self._apply_noise(self.act_spec, actions, noise, corr, frames)

    def randomize_observations(self, obs, noise, frames=1e9, corr=None):
        return self._apply_noise(self.obs_spec, obs, noise, corr, frames)
