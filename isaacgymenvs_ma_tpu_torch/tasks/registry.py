"""Task registry of the port (counterpart of
isaacgymenvs_ma_tpu/tasks/registry.py, reference tasks/__init__.py:94-127
``isaacgym_task_map``).

Every name of the JAX registry is registered: its tasks, with the
config variants (reference ``cfg/task/<Variant>.yaml``, JAX
registry.py:59-110): a variant builds its base task from the base's
defaults with the variant's deltas deep-merged over them (HumanoidAMPHands
over HumanoidAMP, AntSAC and HumanoidSAC over Ant and Humanoid as they
are), and the config-only groups, whose configs resolve and whose
classes raise ``KeyError``; a name neither package knows raises
``KeyError``, as in the JAX package.  Nothing falls back to another task.
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
    "AllegroHandDextremeManualDR": (".allegro_hand_dextreme",
                                    "AllegroHandDextremeManualDR"),
    "AllegroHandDextremeADR": (".allegro_hand_dextreme",
                               "AllegroHandDextremeADR"),
    # the reference registry's short names (tasks/__init__.py:98-99)
    "AllegroHandManualDR": (".allegro_hand_dextreme",
                            "AllegroHandDextremeManualDR"),
    "AllegroHandADR": (".allegro_hand_dextreme", "AllegroHandDextremeADR"),
    "FactoryTaskNutBoltPick": (".factory", "FactoryTaskNutBoltPick"),
    "FactoryTaskNutBoltPlace": (".factory", "FactoryTaskNutBoltPlace"),
    "FactoryTaskNutBoltScrew": (".factory", "FactoryTaskNutBoltScrew"),
    "FactoryTaskGears": (".factory", "FactoryTaskGears"),
    "FactoryTaskInsertion": (".factory", "FactoryTaskInsertion"),
    "IndustRealTaskPegsInsert": (".industreal", "IndustRealTaskPegsInsert"),
    "IndustRealTaskGearsInsert": (".industreal", "IndustRealTaskGearsInsert"),
    "HumanoidAMP": (".humanoid_amp", "HumanoidAMP"),
}

# the reference's config-only groups (cfg/task/FactoryBase.yaml etc., the
# Hydra include bases tasks compose): their default configs resolve, as in
# the JAX registry (registry.py:113-123), and building one raises KeyError
_CONFIG_ONLY: Dict[str, Tuple[str, str]] = {
    "FactoryBase": (".factory", "FactoryTaskNutBoltPick"),
    "FactoryEnvNutBolt": (".factory", "FactoryTaskNutBoltPick"),
    "FactoryEnvGears": (".factory", "FactoryTaskGears"),
    "FactoryEnvInsertion": (".factory", "FactoryTaskInsertion"),
    "IndustRealBase": (".industreal", "IndustRealTaskPegsInsert"),
    "IndustRealEnvPegs": (".industreal", "IndustRealTaskPegsInsert"),
    "IndustRealEnvGears": (".industreal", "IndustRealTaskGearsInsert"),
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
    # cfg/task/HumanoidAMPHands.yaml: the hands join the contact bodies,
    # the cartwheel clip
    "HumanoidAMPHands": ("HumanoidAMP", {
        "env": {"contactBodies": ["right_foot", "left_foot",
                                  "right_hand", "left_hand"],
                "motion_file": "amp_humanoid_cartwheel.npy"},
    }),
    # cfg/task/{Ant,Humanoid}SAC.yaml: the task configs as they are (only
    # the train config differs)
    "AntSAC": ("Ant", {}),
    "HumanoidSAC": ("Humanoid", {}),
}

def _check(name: str) -> None:
    if name not in _TASKS and name not in _VARIANTS \
            and name not in _CONFIG_ONLY:
        raise KeyError(f"unknown task '{name}'; ported: {task_names()}")


def task_class(name: str):
    _check(name)
    if name in _CONFIG_ONLY:
        raise KeyError(
            f"'{name}' is a config-only group (Hydra include base); "
            "select one of the concrete tasks instead")
    mod, cls = _TASKS[_VARIANTS.get(name, (name,))[0]]
    return getattr(importlib.import_module(mod, __package__), cls)


def _module_config(mod_name: str, name: str) -> dict:
    """A task's default config: a multi-task module's ``TASK_CFGS[name]``,
    else its ``TASK_CFG`` (JAX registry.py:141-147)."""
    mod = importlib.import_module(mod_name, __package__)
    cfgs = getattr(mod, "TASK_CFGS", None)
    if cfgs and name in cfgs:
        return cfgs[name]
    return mod.TASK_CFG


def task_default_config(name: str) -> dict:
    _check(name)
    if name in _VARIANTS:
        base, delta = _VARIANTS[name]
        return deep_merge(task_default_config(base), delta)
    if name in _CONFIG_ONLY:
        return _module_config(*_CONFIG_ONLY[name])
    return _module_config(_TASKS[name][0], name)


def task_names():
    return sorted(set(_TASKS) | set(_VARIANTS))


def create_task(name: str, cfg: dict, seed: int = 42, headless: bool = True,
                device="cuda"):
    """The task ``name`` built from ``cfg`` on ``device``; ``seed`` seeds
    its reset draws.  ``headless`` is accepted for the reference's
    signature: the viewer is opened by the caller (``train._play`` with
    ``headless=False``, utils/viewer.py ``InteractiveViewer``)."""
    return task_class(name)(cfg, device=device, seed=seed)
