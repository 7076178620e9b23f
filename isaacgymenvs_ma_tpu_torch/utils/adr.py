"""Automatic Domain Randomization (port of isaacgymenvs_ma_tpu/utils/adr.py;
reference tasks/dextreme/adr_vec_task.py:368-920).

Each randomized parameter p has an adaptive range ``[lo_p, hi_p]`` inside
hard outer limits.  A static fraction of the envs are boundary workers:
env e probes parameter ``assign_p[e]`` pinned at side ``assign_s[e]``
(round-robin, fixed at build time in numpy).  When a boundary env finishes
an episode its performance lands in that (param, side) accumulator; once
``queue_size`` episodes have accumulated the boundary moves (performance
>= ``threshold_high``: expand by ``delta``; <= ``threshold_low``:
contract) and the accumulator restarts.  Regular envs sample uniformly
inside the current ranges.

The state is a tuple of small tensors updated with masked reductions, no
host sync (no ``.item()``).  ``sample`` takes its uniforms from a
``torch.Generator`` or as injected draws (N, P).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DTYPE


class ADRConfig(NamedTuple):
    names: tuple                  # parameter names (P,)
    init_lo: tuple                # initial range low
    init_hi: tuple
    limit_lo: tuple               # hard outer limits
    limit_hi: tuple
    delta: tuple                  # boundary step per update
    queue_size: int = 256
    threshold_low: float = 0.05   # contract below
    threshold_high: float = 0.2   # expand above
    worker_fraction: float = 0.25


class ADRState(NamedTuple):
    ranges: torch.Tensor       # (P, 2) current [lo, hi]
    perf_sum: torch.Tensor     # (P, 2) accumulated boundary performance
    perf_cnt: torch.Tensor     # (P, 2)
    num_updates: torch.Tensor  # (P, 2) expansion / contraction counter


class ADR:
    def __init__(self, cfg: ADRConfig, num_envs: int, device="cpu"):
        self.cfg = cfg
        self.num_envs = num_envs
        self.device = torch.device(device)
        P = len(cfg.names)
        self.P = P
        n_workers = int(num_envs * cfg.worker_fraction)
        # static round-robin assignment: env -> (param, side); -1 = regular
        assign_p = np.full(num_envs, -1, np.int64)
        assign_s = np.zeros(num_envs, np.int64)
        for i in range(n_workers):
            assign_p[i] = (i % (P * 2)) // 2
            assign_s[i] = i % 2
        self.assign_p = assign_p
        self.assign_s = assign_s
        dev = self.device
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=dev)
        p_idx = np.maximum(assign_p, 0)
        worker = (assign_p >= 0).astype(np.float32)
        eye_p = np.eye(P, dtype=np.float32)
        # (N, P) the pinned parameter of each worker (zero rows: regular)
        self._pin = f32(worker[:, None] * eye_p[p_idx])
        self._p_idx = torch.as_tensor(p_idx, device=dev)
        self._s_idx = torch.as_tensor(assign_s, device=dev)
        # (N, P, 2) each worker's accumulator slot
        self._seg = f32(worker[:, None, None] * eye_p[p_idx][:, :, None]
                        * np.eye(2, dtype=np.float32)[assign_s][:, None, :])
        self.is_worker = torch.as_tensor(assign_p >= 0, device=dev)
        self._delta = f32(cfg.delta)
        self._limit_lo = f32(cfg.limit_lo)
        self._limit_hi = f32(cfg.limit_hi)

    def init(self) -> ADRState:
        c = self.cfg
        z = torch.zeros((self.P, 2), dtype=DTYPE, device=self.device)
        return ADRState(
            ranges=torch.as_tensor(
                np.stack([c.init_lo, c.init_hi], -1).astype(np.float32),
                device=self.device),
            perf_sum=z, perf_cnt=z.clone(), num_updates=z.clone())

    def draw(self, gen: torch.Generator) -> torch.Tensor:
        """The uniforms :meth:`sample` takes, U[0, 1) (N, P)."""
        return torch.rand((self.num_envs, self.P), generator=gen,
                          device=gen.device, dtype=DTYPE)

    def sample(self, state: ADRState, gen: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-env parameter values (N, P): regular envs uniform in range,
        boundary workers pinned to their boundary value.  ``u`` the
        uniforms (N, P), else drawn from ``gen``."""
        if u is None:
            u = self.draw(gen)
        lo, hi = state.ranges[:, 0], state.ranges[:, 1]
        vals = lo + u * (hi - lo)
        bound_val = state.ranges[self._p_idx, self._s_idx]
        return vals * (1 - self._pin) + self._pin * bound_val[:, None]

    def observe(self, state: ADRState, done_mask: torch.Tensor,
                performance: torch.Tensor) -> ADRState:
        """Accumulate the boundary performances of envs finishing episodes
        and apply the boundary updates where the queues are full."""
        c = self.cfg
        seg = self._seg * done_mask.to(DTYPE)[:, None, None]
        perf_sum = state.perf_sum + torch.einsum("nps,n->ps", seg,
                                                 performance.to(DTYPE))
        perf_cnt = state.perf_cnt + seg.sum(0)
        full = perf_cnt >= c.queue_size
        mean_perf = perf_sum / torch.clamp(perf_cnt, min=1.0)
        expand = full & (mean_perf >= c.threshold_high)
        contract = full & (mean_perf <= c.threshold_low)
        lo, hi = state.ranges[:, 0], state.ranges[:, 1]
        # side 0 = the low boundary (expanding lowers lo)
        lo = torch.where(expand[:, 0],
                         torch.maximum(lo - self._delta, self._limit_lo), lo)
        lo = torch.where(contract[:, 0], torch.minimum(lo + self._delta, hi),
                         lo)
        hi = torch.where(expand[:, 1],
                         torch.minimum(hi + self._delta, self._limit_hi), hi)
        hi = torch.where(contract[:, 1], torch.maximum(hi - self._delta, lo),
                         hi)
        return ADRState(
            ranges=torch.stack([lo, hi], -1),
            perf_sum=torch.where(full, 0.0, perf_sum),
            perf_cnt=torch.where(full, 0.0, perf_cnt),
            num_updates=(state.num_updates + expand.to(DTYPE)
                         + contract.to(DTYPE)))

    def sample_phys(self, state: ADRState,
                    gen: Optional[torch.Generator] = None,
                    u: Optional[torch.Tensor] = None):
        """ADR-driven :class:`.domain_rand.PhysScales`: the four
        engine-level factors sampled from the adaptive ranges.  Requires
        ``cfg.names == PHYS_PARAM_NAMES``."""
        from .domain_rand import PhysScales
        vals = self.sample(state, gen, u)
        return PhysScales(mass=vals[:, 0:1], damping=vals[:, 1:2],
                          stiffness=vals[:, 2:3], friction=vals[:, 3:4])

    def npd(self, state: ADRState) -> torch.Tensor:
        """Mean normalized range width, Dextreme's ADR progress metric."""
        span = self._limit_hi - self._limit_lo
        width = state.ranges[:, 1] - state.ranges[:, 0]
        return torch.mean(width / torch.clamp(span, min=1e-9))


def adr_config_from_params(adr_cfg: dict) -> ADRConfig:
    """An :class:`ADRConfig` from a reference-style ``adr`` config tree
    (cfg/task/AllegroHandDextremeADR.yaml:227-422): ``params`` maps each
    name to ``init_range``, ``limits`` and ``delta`` (0.01 when missing);
    the parameter order is the dict's."""
    params = adr_cfg["params"]
    names, lo0, hi0, llo, lhi, dl = [], [], [], [], [], []
    for name, p in params.items():
        names.append(name)
        lo0.append(float(p["init_range"][0]))
        hi0.append(float(p["init_range"][1]))
        llo.append(float(p["limits"][0]))
        lhi.append(float(p["limits"][1]))
        dl.append(float(p.get("delta", 0.01)))
    return ADRConfig(
        names=tuple(names), init_lo=tuple(lo0), init_hi=tuple(hi0),
        limit_lo=tuple(llo), limit_hi=tuple(lhi), delta=tuple(dl),
        queue_size=int(adr_cfg.get("adr_queue_threshold_length", 256)),
        threshold_low=float(adr_cfg.get("adr_objective_threshold_low", 5.0)),
        threshold_high=float(adr_cfg.get("adr_objective_threshold_high",
                                         20.0)),
        worker_fraction=float(adr_cfg.get("worker_adr_boundary_fraction",
                                          0.4)))


PHYS_PARAM_NAMES = ("mass", "damping", "stiffness", "friction")


def phys_adr(num_envs: int, device="cpu", **overrides) -> ADR:
    """ADR over the engine's multiplicative PhysScales factors."""
    cfg = ADRConfig(
        names=PHYS_PARAM_NAMES,
        init_lo=(0.95, 0.95, 0.95, 0.95),
        init_hi=(1.05, 1.05, 1.05, 1.05),
        limit_lo=(0.4, 0.4, 0.4, 0.4),
        limit_hi=(2.0, 2.0, 2.0, 2.0),
        delta=(0.02, 0.02, 0.02, 0.02),
    )._replace(**overrides)
    return ADR(cfg, num_envs, device)
