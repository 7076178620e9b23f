"""Carrying state from the JAX package to the port.

The engine constants need no conversion: both packages build them from the
same ``SceneModel``.  What differs per run is the env state, handed over as
numpy arrays under flat dotted names, e.g. from a JAX ``EnvState`` ``st``::

    arrays = {"sim.q": np.asarray(st.sim.q), "sim.qd": np.asarray(st.sim.qd),
              "progress": np.asarray(st.progress),
              "reset_buf": np.asarray(st.reset_buf),
              "task.potentials": np.asarray(st.task.potentials),
              "task.prev_potentials": np.asarray(st.task.prev_potentials),
              "task.actions": np.asarray(st.task.actions)}

The ``task.*`` keys name the fields of one task's state class (Ant's
``AntTaskState``, BallBalance's ``BBTaskState``, FrankaReachMA's
``FrankaMATaskState``); the class is picked by its field names.

``ppo_state_from_jax`` converts the learner part of a JAX ``PPOState``
(flax parameters, optax Adam moments, the normalisers, ``lr``) into the
keys of the port's ``PPOAgent.state_dict()``.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import DTYPE
from .physics.engine import SimState
from .tasks.ant import AntTaskState
from .tasks.ball_balance import BBTaskState
from .tasks.base import EnvState
from .tasks.franka_reach_ma import FrankaMATaskState

TASK_STATES = (AntTaskState, BBTaskState, FrankaMATaskState)


def env_state_from_jax(arrays: dict, device) -> EnvState:
    """The port's ``EnvState`` from a JAX ``EnvState`` turned into numpy
    (keys as in the module docstring).  The ``task.*`` keys must be exactly
    the fields of one class in ``TASK_STATES``."""
    # torch.tensor copies: the port's state never aliases the caller's arrays
    f32 = lambda k: torch.tensor(  # noqa: E731
        np.asarray(arrays[k], np.float32), dtype=DTYPE, device=device)
    i32 = lambda k: torch.tensor(  # noqa: E731
        np.asarray(arrays[k], np.int32), device=device)
    task = None
    task_keys = {k for k in arrays if k.startswith("task.")}
    if task_keys:
        by_fields = {frozenset(f"task.{f}" for f in cls._fields): cls
                     for cls in TASK_STATES}
        cls = by_fields.get(frozenset(task_keys))
        if cls is None:
            raise KeyError(f"task state keys {sorted(task_keys)} match no "
                           f"task state in {[c.__name__ for c in TASK_STATES]}")
        task = cls(*(f32(f"task.{f}") for f in cls._fields))
    return EnvState(sim=SimState(f32("sim.q"), f32("sim.qd")),
                    progress=i32("progress"), reset_buf=i32("reset_buf"),
                    task=task)


def params_from_jax(tree: dict) -> dict:
    """Flax ``ActorCritic`` parameters (or an Adam moment of them, the same
    tree) as {``nn.Module`` parameter name: tensor}.  Flax ``Dense`` kernels
    are (in, out) and ``nn.Linear`` weights (out, in); the trunks' layers
    are ``<trunk>/Dense_<i>`` in order."""
    tree = tree.get("params", tree)
    out = {}

    def dense(prefix, d):
        out[f"{prefix}.weight"] = torch.tensor(
            np.asarray(d["kernel"], np.float32).T.copy())
        out[f"{prefix}.bias"] = torch.tensor(np.asarray(d["bias"], np.float32))

    for top, sub in tree.items():
        if top in ("actor_mlp", "critic_mlp"):
            for layer, d in sub.items():
                dense(f"{top}.{int(layer.split('_')[1])}", d)
        elif top == "log_sigma":
            out[top] = torch.tensor(np.asarray(sub, np.float32))
        else:
            dense(top, sub)
    return out


def ppo_state_from_jax(arrays: dict) -> dict:
    """The port's learner state from a JAX ``PPOState``'s learner part as
    numpy::

        {"params": flax params tree,
         "adam": {"count": c, "mu": tree, "nu": tree},  # ScaleByAdamState
         "obs_rms": {"mean", "var", "count"}, "value_rms": {...},
         "lr": x}

    plus, optionally, ``epoch``, ``frames``, ``ep_return``, ``ep_length``,
    ``mean_return``, ``mean_length`` and ``last_obs``.  Returns a dict for
    ``PPOAgent.load_state_dict`` (CPU tensors)."""
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    adam = arrays["adam"]
    mu, nu = params_from_jax(adam["mu"]), params_from_jax(adam["nu"])
    step = f32(adam["count"])
    out = {
        "net": params_from_jax(arrays["params"]),
        "optim": {k: {"step": step.clone(), "exp_avg": mu[k],
                      "exp_avg_sq": nu[k]} for k in mu},
        "obs_rms": {k: f32(arrays["obs_rms"][k])
                    for k in ("mean", "var", "count")},
        "value_rms": {k: f32(arrays["value_rms"][k])
                      for k in ("mean", "var", "count")},
        "lr": f32(arrays["lr"]),
    }
    for k in ("epoch", "frames"):
        if k in arrays:
            out[k] = int(arrays[k])
    for k in ("ep_return", "ep_length", "mean_return", "mean_length",
              "last_obs"):
        if k in arrays:
            out[k] = f32(arrays[k])
    return out
