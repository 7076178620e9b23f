"""Checkpoint save/restore (port of isaacgymenvs_ma_tpu/learning/checkpoint.py,
the rl_games ``.pth`` checkpoint).

The payload has the JAX package's keys: ``ppo_state`` (the agent's
``state_dict()``: network and optimiser state, the normalisers (with the
asymmetric critic's ``states_rms``), ``lr``, epoch, frames, the episode
trackers, the generators' states, the LSTM carry and the env state with
its physics scales, so a resumed run continues exactly),
``env_state_extra`` (curriculum state from ``task.get_env_state``:
AllegroKuka's success tolerance, None for the other ported tasks; the
train entry point hands it back through ``task.set_env_state``) and
``meta``.
It is written with ``torch.save`` to ``path + ".tmp"`` and then moved onto
``path``, so a reader never sees half a file; it holds only tensors and
plain containers, so ``load_checkpoint`` reads it with
``weights_only=True``.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch


def save_checkpoint(path: str, ppo_state: dict, env_state_extra: Any = None,
                    meta: Optional[dict] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"ppo_state": ppo_state, "env_state_extra": env_state_extra,
               "meta": meta or {}}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu"):
    """(ppo_state, env_state_extra, meta) of a checkpoint."""
    payload = torch.load(path, map_location=map_location, weights_only=True)
    return (payload["ppo_state"], payload.get("env_state_extra"),
            payload.get("meta", {}))
