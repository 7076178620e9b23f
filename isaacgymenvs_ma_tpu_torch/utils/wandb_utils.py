"""W&B observer module (a copy of isaacgymenvs_ma_tpu/utils/wandb_utils.py;
reference utils/wandb_utils.py:7-57).

The working implementation lives in :mod:`.observers` (``WandbObserver``:
retrying init, stable resume id, tensorboard sync, gated import).  This
module keeps the reference's import surface: ``WandbAlgoObserver`` adds the
``before_init`` hook (init W&B before the summary writer so
sync_tensorboard attaches) and config upload.
"""
from __future__ import annotations

from typing import Dict

from .observers import AlgoObserver, WandbObserver


class WandbAlgoObserver(AlgoObserver):
    """ref :7-57 — propagate the experiment name, init with retry+resume."""

    def __init__(self, cfg: dict):
        self.cfg = cfg or {}
        self._inner = None

    def before_init(self, base_name: str, config: dict,
                    experiment_name: str):
        self._inner = WandbObserver(
            project=self.cfg.get("wandb_project", "isaacgymenvs-ma-tpu"),
            group=self.cfg.get("wandb_group", ""),
            name=experiment_name,
            entity=self.cfg.get("wandb_entity", ""),
            tags=self.cfg.get("wandb_tags", ()),
            resume_uid=f"uid_{experiment_name}")
        if self._inner.enabled:
            import wandb
            wandb.config.update(dict(config), allow_val_change=True)

    def after_init(self, config: dict):
        if self._inner is None:
            self.before_init("run", config, config.get("name", "run"))

    def after_print_stats(self, epoch: int, metrics: Dict[str, float]):
        if self._inner is not None:
            self._inner.after_print_stats(epoch, metrics)
