"""Task registry of the port (counterpart of
isaacgymenvs_ma_tpu/tasks/registry.py, reference tasks/__init__.py:94-127
``isaacgym_task_map``).

Only the ported tasks are registered, with the config variants of the
hands (reference ``cfg/task/<Variant>.yaml``, JAX registry.py:59-98): a
variant builds its base task from the base's defaults with the variant's
deltas deep-merged over them.  Every other name of the JAX
registry (its tasks, config variants and config-only groups) raises
``NotImplementedError`` naming the ROADMAP queue-A item that ports it; a
name neither package knows raises ``KeyError``, as in the JAX package.
Nothing falls back to another task.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from ..utils.config import deep_merge

# name -> (module, class name); resolved lazily
_TASKS: Dict[str, Tuple[str, str]] = {
    "Cartpole": (".cartpole", "Cartpole"),
    "Ant": (".ant", "Ant"),
    "BallBalance": (".ball_balance", "BallBalance"),
    "FrankaReachMA": (".franka_reach_ma", "FrankaReachMA"),
    "FrankaCollectMA": (".franka_collect_ma", "FrankaCollectMA"),
    "FrankaPPMA": (".franka_ppma", "FrankaPPMA"),
    "FrankaCombineMA": (".franka_combine_ma", "FrankaCombineMA"),
    "Humanoid": (".humanoid", "Humanoid"),
    "Anymal": (".anymal", "Anymal"),
    "AnymalTerrain": (".anymal_terrain", "AnymalTerrain"),
    "Ingenuity": (".ingenuity", "Ingenuity"),
    "Quadcopter": (".quadcopter", "Quadcopter"),
    "FrankaReach": (".franka_reach", "FrankaReach"),
    "FrankaCabinet": (".franka_cabinet", "FrankaCabinet"),
    "FrankaCubeStack": (".franka_cube_stack", "FrankaCubeStack"),
    "FrankaCubeStack2": (".franka_cube_stack2", "FrankaCubeStack2"),
    "Trifinger": (".trifinger", "Trifinger"),
    # subtask-resolver entries (reference tasks/__init__.py:65-90): the
    # env.subtask key picks the class
    "AllegroKuka": (".allegro_kuka", "resolve_allegro_kuka"),
    "AllegroKukaLSTM": (".allegro_kuka", "resolve_allegro_kuka"),
    "AllegroKukaTwoArms": (".allegro_kuka", "resolve_allegro_kuka_two_arms"),
    "AllegroKukaTwoArmsLSTM": (".allegro_kuka",
                               "resolve_allegro_kuka_two_arms"),
    "ShadowHand": (".shadow_hand", "ShadowHand"),
    "AllegroHand": (".allegro_hand", "AllegroHand"),
}

# config variants: name -> (base task, deltas over its defaults)
_OPENAI_FF_DELTA = {
    "env": {
        "numEnvs": 16384, "episodeLength": 160, "resetTime": 8,
        "actionsMovingAverage": 0.3, "controlFrequencyInv": 3,
        "forceScale": 1.0, "fallPenalty": -50.0,
        "observationType": "openai", "asymmetric_observations": True,
        "successTolerance": 0.4, "maxConsecutiveSuccesses": 50,
        "averFactor": 0.1,
    },
    "task": {"randomize": True},
}
# cfg/task/AllegroHandLSTM.yaml (AllegroHandFF and AllegroHandLSTM_Big
# inherit it)
_ALLEGRO_LSTM_DELTA = {
    "env": {"numEnvs": 16384, "episodeLength": 320, "resetTime": 16,
            "controlFrequencyInv": 2, "forceScale": 2.0,
            "actionsMovingAverage": {"range": [0.15, 0.35],
                                     "schedule_steps": 1000_000},
            "successTolerance": 0.4, "maxConsecutiveSuccesses": 50,
            "fallPenalty": 0.0, "observationType": "full_no_vel",
            "asymmetric_observations": True},
}
_VARIANTS: Dict[str, Tuple[str, dict]] = {
    "ShadowHandOpenAI_FF": ("ShadowHand", _OPENAI_FF_DELTA),
    "ShadowHandOpenAI_LSTM": ("ShadowHand", _OPENAI_FF_DELTA),
    # OpenAI_FF at 256 envs, long episodes, no random object forces
    "ShadowHandTest": ("ShadowHand", {
        "env": dict(_OPENAI_FF_DELTA["env"], numEnvs=256,
                    episodeLength=1600, resetTime=80, forceScale=0.0,
                    printNumSuccesses=True),
        "task": {"randomize": True},
    }),
    "AllegroHandLSTM": ("AllegroHand", _ALLEGRO_LSTM_DELTA),
    "AllegroHandFF": ("AllegroHand", _ALLEGRO_LSTM_DELTA),
    "AllegroHandLSTM_Big": ("AllegroHand", _ALLEGRO_LSTM_DELTA),
}

# the JAX registry's other names -> ROADMAP queue-A item that ports them
_QUEUE_A = {
    "7": ("AllegroHandDextremeManualDR", "AllegroHandDextremeADR",
          "AllegroHandManualDR", "AllegroHandADR"),
    "9": ("FactoryTaskNutBoltPick", "FactoryTaskNutBoltPlace",
          "FactoryTaskNutBoltScrew", "FactoryTaskGears",
          "FactoryTaskInsertion", "IndustRealTaskPegsInsert",
          "IndustRealTaskGearsInsert", "FactoryBase", "FactoryEnvNutBolt",
          "FactoryEnvGears", "FactoryEnvInsertion", "IndustRealBase",
          "IndustRealEnvPegs", "IndustRealEnvGears"),
    "10": ("HumanoidAMP", "HumanoidAMPHands", "AntSAC", "HumanoidSAC"),
}
UNPORTED = {name: item for item, names in _QUEUE_A.items() for name in names}


def _check(name: str) -> None:
    if name in UNPORTED:
        raise NotImplementedError(
            f"task '{name}' is not ported yet: ROADMAP queue A, item "
            f"{UNPORTED[name]}")
    if name not in _TASKS and name not in _VARIANTS:
        raise KeyError(f"unknown task '{name}'; ported: {task_names()}")


def _module(name: str):
    _check(name)
    name = _VARIANTS.get(name, (name,))[0]
    return importlib.import_module(_TASKS[name][0], __package__)


def task_class(name: str):
    return getattr(_module(name), _TASKS[_VARIANTS.get(name, (name,))[0]][1])


def task_default_config(name: str) -> dict:
    if name in _VARIANTS:
        base, delta = _VARIANTS[name]
        return deep_merge(task_default_config(base), delta)
    return _module(name).TASK_CFG


def task_names():
    return sorted(set(_TASKS) | set(_VARIANTS))


def create_task(name: str, cfg: dict, seed: int = 42, headless: bool = True,
                device="cuda"):
    """The task ``name`` built from ``cfg`` on ``device``; ``seed`` seeds
    its reset draws."""
    if not headless:
        raise NotImplementedError(
            "the viewer (headless=False) is not ported yet: ROADMAP queue "
            "A, item 11")
    return task_class(name)(cfg, device=device, seed=seed)
