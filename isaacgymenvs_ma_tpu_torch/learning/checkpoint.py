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

``save_agent`` / ``load_agent`` are the train entry point's: the meta
records the global ``num_envs`` and ``batch`` and the ``world`` that wrote
it.  Under data parallelism (parallel/mesh.py) rank 0 gathers every
rank's per-env leaves and writes one full-width checkpoint, and a loading
rank takes its slice, so a checkpoint moves between world sizes.
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


def save_agent(path: str, agent, task, dist=None, meta: Optional[dict] = None):
    """The agent's checkpoint at ``path``, full width: with ``dist`` every
    rank must call it (a collective) and rank 0 writes.  Returns whether
    this process wrote."""
    world = 1 if dist is None else dist.world
    sd = agent.state_dict()
    if dist is not None:
        sd = dist.gather_state(sd, task.num_envs, task.rl_games_batch)
        if sd is None:
            return False
    meta = dict(meta or {}, num_envs=task.num_envs * world,
                batch=task.rl_games_batch * world, world=world)
    save_checkpoint(path, sd, env_state_extra=task.get_env_state(
        agent.env_state), meta=meta)
    return True


def load_agent(path: str, agent, task, dist=None):
    """Load a checkpoint into an ``init()``-ed agent, this rank's slice of
    it with ``dist``; returns (env_state_extra, meta).  The task's
    curriculum state is put back (``task.set_env_state``)."""
    from ..parallel.mesh import slice_state
    state, env_extra, meta = load_checkpoint(path)
    if "num_envs" in meta:
        rank, world = (0, 1) if dist is None else (dist.rank, dist.world)
        state = slice_state(state, rank, world, int(meta["num_envs"]),
                            int(meta["batch"]))
    agent.load_state_dict(state)
    agent.env_state = task.set_env_state(agent.env_state, env_extra)
    return env_extra, meta
