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
``FrankaMATaskState``); the class is picked by its field names.  This slice has no learned weights; the PPO slice extends
this module with network parameters.
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
