"""Task registry of the port (counterpart of
isaacgymenvs_ma_tpu/tasks/registry.py, reference tasks/__init__.py:94-127
``isaacgym_task_map``).

Only the ported tasks are registered.  Every other name of the JAX
registry (its tasks, config variants and config-only groups) raises
``NotImplementedError`` naming the ROADMAP queue-A item that ports it; a
name neither package knows raises ``KeyError``, as in the JAX package.
Nothing falls back to another task.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

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
}

# the JAX registry's other names -> ROADMAP queue-A item that ports them
_QUEUE_A = {
    "7": ("ShadowHand", "ShadowHandOpenAI_FF", "ShadowHandOpenAI_LSTM",
          "ShadowHandTest", "AllegroHand", "AllegroHandLSTM", "AllegroHandFF",
          "AllegroHandLSTM_Big", "AllegroHandDextremeManualDR",
          "AllegroHandDextremeADR", "AllegroHandManualDR", "AllegroHandADR"),
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
    if name not in _TASKS:
        raise KeyError(f"unknown task '{name}'; ported: {sorted(_TASKS)}")


def _module(name: str):
    _check(name)
    return importlib.import_module(_TASKS[name][0], __package__)


def task_class(name: str):
    return getattr(_module(name), _TASKS[name][1])


def task_default_config(name: str) -> dict:
    return _module(name).TASK_CFG


def task_names():
    return sorted(_TASKS)


def create_task(name: str, cfg: dict, seed: int = 42, headless: bool = True,
                device="cuda"):
    """The task ``name`` built from ``cfg`` on ``device``; ``seed`` seeds
    its reset draws."""
    if not headless:
        raise NotImplementedError(
            "the viewer (headless=False) is not ported yet: ROADMAP queue "
            "A, item 11")
    return task_class(name)(cfg, device=device, seed=seed)
