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
AllegroKuka's ``KukaTaskState``, the hands' ``HandTaskState``, whose
``consecutive`` is a scalar, and HumanoidAMP's ``AMPTaskState``);
the class is picked by its field names, or given (Humanoid's
``HumanoidTaskState`` has Ant's fields, the single-arm Franka tasks'
``CubeStackTaskState`` and ``CabinetTaskState`` FrankaReachMA's).  The
``phys.*`` keys, where a task randomizes its physics, name the leaves of
the JAX ``PhysScales`` (``phys.mass``, ``phys.friction``, ``phys.shape``,
...) and become the port's (:func:`phys_from_jax`).  A field keeps its kind: integer arrays (the MA tasks' FSM
states, AnymalTerrain's levels, types and step counter, AllegroKuka's
near-goal counts) become int32 tensors, boolean arrays (AllegroKuka's
lifted flags) bool tensors, the others float32.  The JAX
``SimState.lam`` of a warm-start engine (the Factory and IndustReal tasks)
comes as ``sim.lam.0`` (N, rows, 3), ``sim.lam.1`` and ``sim.lam.2`` (N,
nv); without them the state carries none.

Dextreme's ``DextremeTaskState`` nests: its hand state's fields are keyed
``task.hand.<field>``, the RNA's dropout masks ``task.rna.<i>`` (the JAX
``RNAState.masks``; its key is the JAX stream's and is not carried, its
parameters go through :func:`rna_state_dict_from_jax`), the ADR state's
fields (ADR only) ``task.adr.<field>``, and the other fields
``task.<field>`` (``step_count`` a scalar).

``ppo_state_from_jax`` converts the learner part of a JAX ``PPOState``
(flax parameters, optax Adam moments, the normalisers, ``lr``) into the
keys of the port's ``PPOAgent.state_dict()``, with the asymmetric
critic's ``states_rms`` and the LSTM's carry where the agent has them;
``params_from_jax`` takes the ``ActorCritic``, ``AsymActorCritic``,
``CentralValueNet`` and ``ActorCriticLSTM`` parameter trees, and those of
the other learners' networks: AMP's ``Discriminator``, SAC's
``TanhGaussianActor`` and ``TwinQ`` and HRL's ``LatentConditionedActor``.
``amp_state_from_jax`` adds the AMP learner's part of a JAX ``AMPState``
(the discriminator, its Adam state, ``amp_rms`` and the replay) and
``sac_state_from_jax`` converts a JAX ``SACState``'s learner part.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import DTYPE
from .physics.engine import SimState
from .tasks.allegro_hand_dextreme import DextremeTaskState
from .tasks.allegro_kuka import KukaTaskState
from .tasks.ant import AntTaskState
from .tasks.anymal import AnymalTaskState
from .tasks.anymal_terrain import ATTaskState
from .tasks.ball_balance import BBTaskState
from .tasks.base import EnvState
from .tasks.humanoid_amp import AMPTaskState
from .tasks.factory import FactoryTaskState
from .tasks.industreal import IndustRealTaskState
from .tasks.franka_collect_ma import CollectTaskState
from .tasks.franka_reach_ma import FrankaMATaskState
from .tasks.ingenuity import IngenuityTaskState
from .tasks.quadcopter import QuadTaskState
from .tasks.shadow_hand import HandTaskState
from .tasks.trifinger import TrifingerTaskState
from .utils.adr import ADRState
from .utils.domain_rand import PhysScales

TASK_STATES = (AntTaskState, BBTaskState, FrankaMATaskState,
               CollectTaskState, AnymalTaskState, ATTaskState,
               IngenuityTaskState, QuadTaskState, TrifingerTaskState,
               KukaTaskState, HandTaskState, FactoryTaskState,
               IndustRealTaskState, AMPTaskState)


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
    if "task.hand.goal_rot" in arrays:
        task = dextreme_state_from_jax(arrays, device)
    elif task_keys:
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
    lam = (tuple(f32(f"sim.lam.{i}") for i in range(3))
           if "sim.lam.0" in arrays else None)
    return EnvState(sim=SimState(f32("sim.q"), f32("sim.qd"), lam),
                    progress=i32("progress"), reset_buf=i32("reset_buf"),
                    task=task,
                    phys=phys_from_jax(phys, device) if phys else None)


def dextreme_state_from_jax(arrays: dict, device) -> DextremeTaskState:
    """Dextreme's nested task state from the ``task.*`` keys of the module
    docstring."""
    def t(k):
        a = np.asarray(arrays[k])
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a.astype(np.int32), device=device)
        return torch.tensor(a.astype(np.float32), dtype=DTYPE,
                            device=device)
    hand = HandTaskState(*(t(f"task.hand.{f}")
                           for f in HandTaskState._fields))
    masks = tuple(t(f"task.rna.{i}") for i in range(len(
        [k for k in arrays if k.startswith("task.rna.")])))
    adr = (ADRState(*(t(f"task.adr.{f}") for f in ADRState._fields))
           if "task.adr.ranges" in arrays else None)
    rest = {f: t(f"task.{f}") for f in DextremeTaskState._fields
            if f not in ("hand", "rna", "adr")
            and f"task.{f}" in arrays}
    unknown = {k for k in arrays if k.startswith("task.")} - (
        {f"task.hand.{f}" for f in HandTaskState._fields}
        | {f"task.rna.{i}" for i in range(len(masks))}
        | {f"task.adr.{f}" for f in ADRState._fields}
        | {f"task.{f}" for f in rest})
    if unknown:
        raise KeyError(f"not DextremeTaskState keys: {sorted(unknown)}")
    return DextremeTaskState(hand=hand, rna=masks, adr=adr, **rest)


def rna_state_dict_from_jax(params: dict) -> dict:
    """The ``state_dict`` of the port's ``RandomNetworkAdversary`` from
    the JAX RNA's flax parameters (numpy; ``{"params": {"fc0": {"kernel",
    "bias"}, "fc1": ..., "out": ...}}`` or the inner dict): the Dense
    kernels (in, out) transposed into ``Linear`` weights (out, in)."""
    params = params.get("params", params)
    out = {}
    for layer, d in params.items():
        name = (f"fc.{int(layer[2:])}" if layer.startswith("fc")
                else layer)
        out[f"{name}.weight"] = torch.tensor(
            np.asarray(d["kernel"], np.float32).T.copy())
        out[f"{name}.bias"] = torch.tensor(np.asarray(d["bias"], np.float32))
    return out


def params_from_jax(tree: dict) -> dict:
    """Flax network parameters (or an Adam moment of them, the same tree)
    as {``nn.Module`` parameter name: tensor}.  Flax ``Dense`` kernels are
    (in, out) and ``nn.Linear`` weights (out, in); a trunk (an ``MLP``:
    ``actor_mlp``, ``disc_mlp``, SAC's ``q1`` ...) holds its layers as
    ``<trunk>/Dense_<i>`` in order.  The LSTM cell's per-gate kernels
    (``lstm/i{i,f,g,o}`` without bias, ``lstm/h{i,f,g,o}`` with) are
    stacked in gate order into ``lstm.ih`` and ``lstm.hh``."""
    tree = tree.get("params", tree)
    out = {}
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731

    def dense(prefix, d):
        out[f"{prefix}.weight"] = torch.tensor(f32(d["kernel"]).T.copy())
        out[f"{prefix}.bias"] = torch.tensor(f32(d["bias"]))

    for top, sub in tree.items():
        if hasattr(sub, "keys") and len(sub) and all(
                k.startswith("Dense_") for k in sub):
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
    out = {
        "net": params_from_jax(arrays["params"]),
        "optim": _adam_from_jax(arrays["adam"]),
        "obs_rms": _rms(arrays["obs_rms"]),
        "value_rms": _rms(arrays["value_rms"]),
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
        out["states_rms"] = _rms(arrays["states_rms"])
    if arrays.get("carry") is not None and len(arrays["carry"]):
        out["carry"] = [f32(c) for c in arrays["carry"]]
    return out


def _adam_from_jax(adam: dict) -> dict:
    """{parameter name: torch Adam state} of an optax ``ScaleByAdamState``
    as numpy ({"count", "mu", "nu"})."""
    mu, nu = params_from_jax(adam["mu"]), params_from_jax(adam["nu"])
    step = torch.tensor(np.asarray(adam["count"], np.float32))
    return {k: {"step": step.clone(), "exp_avg": mu[k],
                "exp_avg_sq": nu[k]} for k in mu}


def _rms(d: dict) -> dict:
    return {k: torch.tensor(np.asarray(d[k], np.float32))
            for k in ("mean", "var", "count")}


def amp_state_from_jax(arrays: dict) -> dict:
    """The AMP learner's part of a JAX ``AMPState.amp`` as numpy::

        {"disc_params": flax tree, "disc_adam": {"count", "mu", "nu"},
         "amp_rms": {"mean", "var", "count"}, "replay": (R, amp_dim),
         "replay_n": n}

    as the keys ``AMPAgent.load_state_dict`` takes besides PPO's."""
    return {"disc": params_from_jax(arrays["disc_params"]),
            "disc_optim": _adam_from_jax(arrays["disc_adam"]),
            "amp_rms": _rms(arrays["amp_rms"]),
            "replay": torch.tensor(np.asarray(arrays["replay"], np.float32)),
            "replay_n": int(arrays["replay_n"])}


def sac_state_from_jax(arrays: dict) -> dict:
    """The port's SAC learner state from a JAX ``SACState``'s learner part
    as numpy::

        {"actor_params", "critic_params", "target_params": flax trees,
         "log_alpha": x, "actor_adam", "critic_adam", "alpha_adam":
         {"count", "mu", "nu"}, "obs_rms": {...}, "buffer": {obs, act, rew,
         next_obs, done}, "buf_n", "step", "mean_return", "ep_return",
         "last_obs"}

    Returns a dict for ``SACAgent.load_state_dict`` (CPU tensors; the
    buffer as given, all its rows)."""
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    al = arrays["alpha_adam"]
    out = {"actor": params_from_jax(arrays["actor_params"]),
           "critic": params_from_jax(arrays["critic_params"]),
           "target": params_from_jax(arrays["target_params"]),
           "log_alpha": f32(arrays["log_alpha"]),
           "actor_optim": _adam_from_jax(arrays["actor_adam"]),
           "critic_optim": _adam_from_jax(arrays["critic_adam"]),
           "alpha_optim": {"step": f32(al["count"]), "exp_avg": f32(al["mu"]),
                           "exp_avg_sq": f32(al["nu"])},
           "obs_rms": _rms(arrays["obs_rms"]),
           "buffer": {k: f32(v) for k, v in arrays["buffer"].items()}}
    for k in ("buf_n", "step"):
        if k in arrays:
            out[k] = int(arrays[k])
    for k in ("mean_return", "ep_return", "last_obs"):
        if k in arrays:
            out[k] = f32(arrays[k])
    return out
