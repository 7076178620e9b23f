"""Config reformatting helpers (a copy of isaacgymenvs_ma_tpu/utils/reformat.py;
reference utils/reformat.py:1-42).

The reference converts OmegaConf trees to plain dicts; this build's config
system is already plain dicts, so ``omegaconf_to_dict`` is a pass-through
that also accepts OmegaConf objects if one is ever handed in.
"""
from __future__ import annotations

from typing import Any, Dict


def omegaconf_to_dict(cfg: Any) -> Dict:
    """ref :9-24 — deep-convert to builtin containers."""
    try:  # tolerate real OmegaConf objects without requiring the package
        from omegaconf import OmegaConf  # type: ignore
        if OmegaConf.is_config(cfg):
            return OmegaConf.to_container(cfg, resolve=True)
    except ImportError:
        pass
    if isinstance(cfg, dict):
        return {k: omegaconf_to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [omegaconf_to_dict(v) for v in cfg]
    return cfg


def print_dict(d: Dict, prefix: str = "") -> None:
    """ref :27-42 — nested pretty print."""
    for k, v in d.items():
        if isinstance(v, dict):
            print(f"{prefix}{k}:")
            print_dict(v, prefix + "  ")
        else:
            print(f"{prefix}{k}: {v}")
