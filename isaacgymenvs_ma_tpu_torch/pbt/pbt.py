"""Decentralized population-based training (a copy of
isaacgymenvs_ma_tpu/pbt/pbt.py; reference pbt/pbt.py, 5,990 LoC
subsystem).

Same design: N independent training processes share a filesystem workspace;
each saves a checkpoint + json meta every ``interval_steps`` frames
(:505-525), scans the population for newest checkpoints <= its own iteration
(:530-562), and — if it sits in the bottom ``replace_fraction_worst`` of the
population by ``true_objective`` with a sufficient gap (:364-427) — restarts
itself from a better policy's checkpoint with mutated hyperparameters
(os.execv, :123-177).  Faulty/dead members are tolerated via outlier-trimmed
statistics and best-effort filesystem ops (:400-410; utils/utils.py:43-66).

Two options of the port's own, off by default: ``pbt.seed`` seeds the
``random`` module before each draw of mutations and donor, from the seed,
the member and the frame count (the reference leaves it unseeded), and
``pbt.sync_timeout`` makes a member wait, before each replacement check,
up to that many seconds until every other member has published a
checkpoint at its frame count or has finished (a ``finished`` file in its
policy dir).  With both, a population's outcome does not depend on its
processes' relative speed.  Metas are written whole and then renamed, so
a member never reads half of one.

Backend-agnostic: the shared-filesystem protocol is the same on any
cluster; only rank 0 of each policy's process group participates.  The
port's train entry point hands it save and restore functions over the
port's checkpoint (learning/checkpoint.py).  A restart execs
``python -m isaacgymenvs_ma_tpu_torch.train`` with the process's
arguments (the JAX package execs its ``train.py`` script).
"""
from __future__ import annotations

import json
import os
import random
import sys
import time
from typing import Any, Dict, List, Optional

from .mutation import DEFAULT_MUTATIONS, mutate

# the module a member restarts into
TRAIN_MODULE = "isaacgymenvs_ma_tpu_torch.train"


def _exec_train(argv: List[str], overrides: List[str]):
    """Replace this process by the train module with ``argv``'s
    arguments (``argv[0]``, the program, dropped) and ``overrides``."""
    os.execv(sys.executable, [sys.executable, "-m", TRAIN_MODULE]
             + list(argv[1:]) + overrides)


def _safe(op, *args, default=None, attempts=3):
    """Best-effort filesystem op (reference utils/utils.py:43-66 retry)."""
    for i in range(attempts):
        try:
            return op(*args)
        except OSError:
            time.sleep(0.2 * (i + 1))
    return default


class PbtParams:
    """Parsed ``pbt`` config section (reference pbt/pbt.py:64-120)."""

    def __init__(self, cfg: dict):
        p = cfg.get("pbt", {}) or {}
        self.enabled: bool = bool(p.get("enabled", False))
        self.policy_idx: int = int(p.get("policy_idx", 0))
        self.num_policies: int = int(p.get("num_policies", 8))
        self.workspace: str = p.get("workspace", "pbt_workspace")
        self.interval_steps: int = int(p.get("interval_steps", 10_000_000))
        self.start_after: int = int(p.get("start_after", 10_000_000))
        self.initial_delay: int = int(p.get("initial_delay", 20_000_000))
        self.replace_fraction_worst: float = float(p.get("replace_fraction_worst", 0.125))
        self.replace_fraction_best: float = float(p.get("replace_fraction_best", 0.3))
        self.replace_threshold_frac_std: float = float(
            p.get("replace_threshold_frac_std", 0.5))
        self.replace_threshold_frac_absolute: float = float(
            p.get("replace_threshold_frac_absolute", 0.05))
        self.mutation_rate: float = float(p.get("mutation_rate", 0.15))
        self.change_min: float = float(p.get("change_min", 1.1))
        self.change_max: float = float(p.get("change_max", 1.5))
        self.mutation: Dict[str, str] = p.get("mutation", DEFAULT_MUTATIONS)
        self.params: Dict[str, Any] = p.get("params", {})
        self.seed: Optional[int] = (None if p.get("seed") is None
                                    else int(p["seed"]))
        self.sync_timeout: float = float(p.get("sync_timeout", 0.0))

    @property
    def policy_dir(self):
        return os.path.join(self.workspace, f"policy_{self.policy_idx:02d}")

    def seed_draws(self, salt) -> None:
        """With ``seed``, seed the ``random`` module for this member's
        draws at ``salt``."""
        if self.seed is not None:
            random.seed(f"{self.seed}/{self.policy_idx}/{salt}")


def initial_pbt_check(cfg: dict, argv: Optional[List[str]] = None):
    """First-launch hyperparameter mutation + restart (reference :180-197).

    If this is the very first launch of a PBT population member (no restart
    marker), mutate the seed hyperparameters and exec the training script
    again with the mutated overrides so the population starts diverse.
    """
    params = PbtParams(cfg)
    if not params.enabled or os.environ.get("PBT_RESTARTED"):
        return
    mutable = dict(params.params)
    if not mutable:
        return
    params.seed_draws("initial")
    mutated = mutate(mutable, params.mutation, 0.8, params.change_min,
                     params.change_max)
    overrides = [f"train.params.config.{k}={v}" for k, v in mutated.items()]
    os.environ["PBT_RESTARTED"] = "1"
    argv = list(sys.argv if argv is None else argv)
    print(f"[pbt] initial mutation restart with {overrides}")
    sys.stdout.flush()
    _exec_train(argv, overrides)


class PbtAlgoObserver:
    """Observer driving the PBT meta-loop (reference PbtAlgoObserver :200+)."""

    def __init__(self, cfg: dict, train_cfg: dict, checkpoint_fn, restore_fn):
        """``checkpoint_fn(path) -> None`` saves the current learner state;
        ``restore_fn(path) -> None`` loads it in place."""
        self.p = PbtParams(cfg)
        self.train_cfg = train_cfg
        self.checkpoint_fn = checkpoint_fn
        self.restore_fn = restore_fn
        self.last_interval = 0
        # frame counter at PROCESS start (reference initial_env_frames,
        # pbt.py:269-283): restarted workers resume from the donor's
        # cumulative frames, so replacement gates must be RELATIVE to the
        # process's own start or a restarted worker is eligible for
        # replacement immediately — and the post-restore reset transient
        # tanks its objective, so it exec-loops forever (observed: a worker
        # replaced 10x in a row without completing an interval of fresh
        # training)
        self.first_frames: Optional[int] = None
        os.makedirs(self.p.policy_dir, exist_ok=True)
        if os.path.exists(self._finished(self.p.policy_idx)):
            os.remove(self._finished(self.p.policy_idx))

    def _finished(self, idx: int) -> str:
        return os.path.join(self.p.workspace, f"policy_{idx:02d}",
                            "finished")

    def finish(self):
        """Mark this member's training as ended (``sync_timeout``)."""
        _safe(lambda: open(self._finished(self.p.policy_idx), "w").close())

    # -- protocol ------------------------------------------------------
    def _save(self, frames: int, objective: float):
        """Checkpoint + meta (reference _save_pbt_checkpoint :505-525)."""
        ckpt = os.path.join(self.p.policy_dir, f"{frames:012d}.ckpt")
        self.checkpoint_fn(ckpt)
        meta = {
            "iteration": frames,
            "true_objective": float(objective),
            "params": {k: self.train_cfg["params"]["config"].get(k)
                       for k in self.p.params},
            "checkpoint": ckpt,
        }
        # written whole, then renamed: a reader never sees half a meta
        def publish():
            with open(ckpt + ".json.tmp", "w") as f:
                json.dump(meta, f)
            os.replace(ckpt + ".json.tmp", ckpt + ".json")
        _safe(publish)

    def _wait_for_population(self, frames: int):
        """Up to ``sync_timeout`` s until every other member has published
        a checkpoint at ``frames`` or beyond, or has finished."""
        def reached(idx):
            pdir = os.path.join(self.p.workspace, f"policy_{idx:02d}")
            if os.path.exists(self._finished(idx)):
                return True
            return any(f.endswith(".ckpt.json") and int(f[:12]) >= frames
                       for f in _safe(os.listdir, pdir, default=[]) or [])
        deadline = time.monotonic() + self.p.sync_timeout
        others = [i for i in range(self.p.num_policies)
                  if i != self.p.policy_idx]
        while not all(reached(i) for i in others) \
                and time.monotonic() < deadline:
            time.sleep(0.2)

    def _load_population(self, max_iteration: int) -> List[Optional[dict]]:
        """Newest meta <= our iteration per policy (reference :530-562)."""
        pop = []
        for idx in range(self.p.num_policies):
            pdir = os.path.join(self.p.workspace, f"policy_{idx:02d}")
            best = None
            for f in sorted(_safe(os.listdir, pdir, default=[]) or []):
                if not f.endswith(".ckpt.json"):
                    continue
                meta = _safe(lambda: json.load(open(os.path.join(pdir, f))))
                if meta and meta["iteration"] <= max_iteration:
                    best = meta
            pop.append(best)
        return pop

    def after_steps(self, epoch: int, frames: int, metrics: Dict[str, float]):
        p = self.p
        if not p.enabled:
            return
        if self.first_frames is None:
            self.first_frames = frames
        if frames - self.last_interval < p.interval_steps:
            return
        self.last_interval = frames
        objective = metrics.get("true_objective", metrics.get("mean_return", 0.0))
        self._save(frames, objective)
        if frames < max(p.start_after, p.initial_delay):
            return
        # per-process grace period (reference :269-283): a freshly
        # (re)started worker trains initial_delay frames of its OWN before
        # it can be replaced again
        if frames - self.first_frames < p.initial_delay:
            return

        if p.sync_timeout > 0:
            self._wait_for_population(frames)
        pop = self._load_population(frames)
        objectives = [(i, m["true_objective"]) for i, m in enumerate(pop)
                      if m is not None]
        if os.environ.get("PBT_DEBUG"):
            print(f"[pbt-debug] frames {frames} obj {objective:.2f} "
                  f"pop {objectives}")
        if len(objectives) < 3:
            return
        objectives.sort(key=lambda t: t[1])
        values = [v for _, v in objectives]
        # outlier-trimmed std (reference :400-410 tolerates dead members)
        trimmed = values[max(1, len(values) // 8): len(values) - 0 or None]
        import statistics
        std = statistics.pstdev(trimmed) if len(trimmed) > 1 else 0.0

        n_worst = max(1, int(len(objectives) * p.replace_fraction_worst))
        worst_ids = [i for i, _ in objectives[:n_worst]]
        if p.policy_idx not in worst_ids:
            return
        best_cut = max(1, int(len(objectives) * p.replace_fraction_best))
        best_pool = objectives[-best_cut:]
        p.seed_draws(frames)
        target_idx, target_obj = random.choice(best_pool)
        gap = target_obj - objective
        abs_thresh = p.replace_threshold_frac_absolute * max(abs(target_obj), 1e-6)
        if gap < max(p.replace_threshold_frac_std * std, abs_thresh):
            return

        target_meta = pop[target_idx]
        print(f"[pbt] policy {p.policy_idx} (obj {objective:.3f}) replaced by "
              f"policy {target_idx} (obj {target_obj:.3f})")
        mutated = mutate(target_meta["params"], p.mutation, p.mutation_rate,
                         p.change_min, p.change_max)
        self._restart(target_meta["checkpoint"], mutated)

    def _restart(self, checkpoint: str, mutated_params: Dict[str, Any]):
        """Process restart with new params (reference :123-177 os.execv)."""
        overrides = [f"train.params.config.{k}={v}"
                     for k, v in mutated_params.items() if v is not None]
        overrides.append(f"checkpoint={checkpoint}")
        os.environ["PBT_RESTARTED"] = "1"
        argv = [a for a in sys.argv if not a.startswith("checkpoint=")]
        print(f"[pbt] restarting: {overrides}")
        sys.stdout.flush()
        _exec_train(argv, overrides)
