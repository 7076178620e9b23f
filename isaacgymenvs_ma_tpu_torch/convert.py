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
``FrankaMATaskState``, the other MA tasks' ``CollectTaskState``,
Anymal's, AnymalTerrain's, Ingenuity's, Quadcopter's, Trifinger's,
AllegroKuka's ``KukaTaskState`` and the hands' ``HandTaskState``, whose
``consecutive`` is a scalar);
the class is picked by its field names, or given (Humanoid's
``HumanoidTaskState`` has Ant's fields, the single-arm Franka tasks'
``CubeStackTaskState`` and ``CabinetTaskState`` FrankaReachMA's).  The
``phys.*`` keys, where a task randomizes its physics, name the leaves of
the JAX ``PhysScales`` (``phys.mass``, ``phys.friction``, ``phys.shape``,
...) and become the port's (:func:`phys_from_jax`).  A field keeps its kind: integer arrays (the MA tasks' FSM
states, AnymalTerrain's levels, types and step counter, AllegroKuka's
near-goal counts) become int32 tensors, boolean arrays (AllegroKuka's
lifted flags) bool tensors, the others float32.

``ppo_state_from_jax`` converts the learner part of a JAX ``PPOState``
(flax parameters, optax Adam moments, the normalisers, ``lr``) into the
keys of the port's ``PPOAgent.state_dict()``, with the asymmetric
critic's ``states_rms`` and the LSTM's carry where the agent has them;
``params_from_jax`` takes the ``ActorCritic``, ``AsymActorCritic``,
``CentralValueNet`` and ``ActorCriticLSTM`` parameter trees.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import DTYPE
from .physics.engine import SimState
from .tasks.allegro_kuka import KukaTaskState
from .tasks.ant import AntTaskState
from .tasks.anymal import AnymalTaskState
from .tasks.anymal_terrain import ATTaskState
from .tasks.ball_balance import BBTaskState
from .tasks.base import EnvState
from .tasks.franka_collect_ma import CollectTaskState
from .tasks.franka_reach_ma import FrankaMATaskState
from .tasks.ingenuity import IngenuityTaskState
from .tasks.quadcopter import QuadTaskState
from .tasks.shadow_hand import HandTaskState
from .tasks.trifinger import TrifingerTaskState
from .utils.domain_rand import PhysScales

TASK_STATES = (AntTaskState, BBTaskState, FrankaMATaskState,
               CollectTaskState, AnymalTaskState, ATTaskState,
               IngenuityTaskState, QuadTaskState, TrifingerTaskState,
               KukaTaskState, HandTaskState)


def phys_from_jax(arrays: dict, device) -> PhysScales:
    """The port's ``PhysScales`` from the leaves of a JAX ``PhysScales``
    as numpy arrays, keyed by leaf name (``mass``, ``damping``,
    ``stiffness``, ``friction`` and any optional leaf that is not None:
    ``shape``, ``obs_corr``, ``act_corr``, ...).  A missing optional leaf
    stays None."""
    unknown = set(arrays) - set(PhysScales._fields)
    if unknown:
        raise KeyError(f"not PhysScales leaves: {sorted(unknown)}")
    return PhysScales(**{k: torch.tensor(np.asarray(v, np.float32),
                                         dtype=DTYPE, device=device)
                         for k, v in arrays.items()})


def env_state_from_jax(arrays: dict, device, state_cls=None) -> EnvState:
    """The port's ``EnvState`` from a JAX ``EnvState`` turned into numpy
    (keys as in the module docstring).  The ``task.*`` keys must be exactly
    the fields of ``state_cls`` or, without it, of one class in
    ``TASK_STATES``."""
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
        cls = state_cls or by_fields.get(frozenset(task_keys))
        if cls is None:
            raise KeyError(f"task state keys {sorted(task_keys)} match no "
                           f"task state in {[c.__name__ for c in TASK_STATES]}")

        def leaf(k):
            kind = np.asarray(arrays[k]).dtype
            if kind == np.bool_:
                return torch.tensor(np.asarray(arrays[k]), device=device)
            return i32(k) if np.issubdtype(kind, np.integer) else f32(k)
        task = cls(*(leaf(f"task.{f}") for f in cls._fields))
    phys = {k[len("phys."):]: v for k, v in arrays.items()
            if k.startswith("phys.")}
    return EnvState(sim=SimState(f32("sim.q"), f32("sim.qd")),
                    progress=i32("progress"), reset_buf=i32("reset_buf"),
                    task=task,
                    phys=phys_from_jax(phys, device) if phys else None)


def params_from_jax(tree: dict) -> dict:
    """Flax actor-critic parameters (or an Adam moment of them, the same
    tree) as {``nn.Module`` parameter name: tensor}.  Flax ``Dense`` kernels
    are (in, out) and ``nn.Linear`` weights (out, in); the trunks' layers
    are ``<trunk>/Dense_<i>`` in order.  The LSTM cell's per-gate kernels
    (``lstm/i{i,f,g,o}`` without bias, ``lstm/h{i,f,g,o}`` with) are
    stacked in gate order into ``lstm.ih`` and ``lstm.hh``."""
    tree = tree.get("params", tree)
    out = {}
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731

    def dense(prefix, d):
        out[f"{prefix}.weight"] = torch.tensor(f32(d["kernel"]).T.copy())
        out[f"{prefix}.bias"] = torch.tensor(f32(d["bias"]))

    for top, sub in tree.items():
        if top in ("actor_mlp", "critic_mlp", "cv_mlp"):
            for layer, d in sub.items():
                dense(f"{top}.{int(layer.split('_')[1])}", d)
        elif top == "lstm":
            for src, dst in (("i", "ih"), ("h", "hh")):
                gates = [sub[f"{src}{g}"] for g in "ifgo"]
                out[f"lstm.{dst}.weight"] = torch.tensor(np.concatenate(
                    [f32(d["kernel"]) for d in gates], -1).T.copy())
                if src == "h":
                    out["lstm.hh.bias"] = torch.tensor(np.concatenate(
                        [f32(d["bias"]) for d in gates]))
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
    ``mean_return``, ``mean_length``, ``last_obs``, and with the
    asymmetric critic ``states_rms`` ({"mean", "var", "count"}) and
    ``last_states``, with the LSTM ``carry`` ((h, c), each (B, units)).
    Returns a dict for ``PPOAgent.load_state_dict`` (CPU tensors)."""
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
              "last_obs", "last_states"):
        if k in arrays:
            out[k] = f32(arrays[k])
    if arrays.get("states_rms"):
        out["states_rms"] = {k: f32(arrays["states_rms"][k])
                             for k in ("mean", "var", "count")}
    if arrays.get("carry") is not None and len(arrays["carry"]):
        out["carry"] = [f32(c) for c in arrays["carry"]]
    return out
