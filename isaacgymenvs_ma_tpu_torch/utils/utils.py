"""General utilities (a copy of isaacgymenvs_ma_tpu/utils/utils.py;
reference utils/utils.py, 158 LoC).

``set_seed`` (rank-offset, deterministic mode — :87-115; CUDA/cuBLAS knobs
are left to ``device.apply_precision_policy``), ``retry`` (:43),
``flatten_dict`` (:69), nested attr/dict helpers (:117-129), tmp-dir helpers
(:131-156).
"""
from __future__ import annotations

import os
import random
import tempfile
import time
from typing import Any, Dict

import numpy as np


def set_seed(seed: int, torch_deterministic: bool = False, rank: int = 0) -> int:
    """Global seeding with per-rank offset (ref :87-115).

    Returns the resolved seed; the port's ``torch.Generator`` objects are
    seeded from it (ops/rng.py ``make_generator``): determinism comes from
    explicit generators, not global generator state.
    """
    from ..ops.rng import make_seed
    seed = make_seed(seed, rank=rank, deterministic=torch_deterministic)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    return seed


def retry(times: int, exceptions=(Exception,)):
    """Retry decorator (ref :43-66) — used by PBT filesystem ops."""
    def decorator(func):
        def wrapper(*args, **kwargs):
            last = None
            for attempt in range(times):
                try:
                    return func(*args, **kwargs)
                except exceptions as e:  # noqa: PERF203
                    last = e
                    time.sleep(0.2 * (attempt + 1))
            raise last
        return wrapper
    return decorator


def flatten_dict(d: Dict, prefix: str = "", separator: str = ".") -> Dict:
    """(ref :69-84)."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}{separator}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, key, separator))
        else:
            out[key] = v
    return out


def nested_dict_get_attr(d: Dict, path: str, separator: str = "."):
    """(ref :117-122)."""
    node = d
    for p in path.split(separator):
        node = node[p]
    return node


def nested_dict_set_attr(d: Dict, path: str, value: Any, separator: str = "."):
    """(ref :124-129)."""
    parts = path.split(separator)
    node = d
    for p in parts[:-1]:
        node = node[p]
    node[parts[-1]] = value


def ensure_dir_exists(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def safe_ensure_dir_exists(path: str) -> str:
    try:
        return ensure_dir_exists(path)
    except OSError:
        return path


def get_project_tmp_dir() -> str:
    """(ref :131-156)."""
    return safe_ensure_dir_exists(
        os.path.join(tempfile.gettempdir(), "isaacgymenvs_ma_tpu"))
