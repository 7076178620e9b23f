"""Config helpers of the port (copy of ``deep_merge`` from
isaacgymenvs_ma_tpu/utils/config.py)."""
from __future__ import annotations

import copy


def deep_merge(base: dict, override: dict) -> dict:
    """``base`` with ``override`` merged in recursively; neither is
    modified."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out
