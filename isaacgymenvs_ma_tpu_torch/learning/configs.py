"""Train-config registry (copy of isaacgymenvs_ma_tpu/learning/configs.py).

The reference's ``cfg/train/*PPO.yaml`` family as Python dicts in the
rl_games ``params.{algo,model,network,config}`` schema; CLI overrides merge
on top (``utils/config.py``).  The dict data and the fallbacks of
``train_default_config`` are the JAX package's, verbatim
(``tests/test_torch_ppo.py`` holds every name to it).
"""
from __future__ import annotations

import copy
from typing import Dict

from ..utils.config import deep_merge


def _base(name: str, algo: str = "a2c_continuous") -> dict:
    return {
        "params": {
            "seed": 42,
            "algo": {"name": algo},
            "model": {"name": "continuous_a2c_logstd"},
            "network": {
                "name": "actor_critic",
                "separate": False,
                "space": {
                    "continuous": {
                        "mu_activation": "None",
                        "sigma_activation": "None",
                        "mu_init": {"name": "default"},
                        "sigma_init": {"name": "const_initializer", "val": 0},
                        "fixed_sigma": True,
                    }
                },
                "mlp": {"units": [256, 128, 64], "activation": "elu",
                        "initializer": {"name": "default"}},
            },
            "load_checkpoint": False,
            "load_path": "",
            "config": {
                "name": name,
                "env_name": "rlgpu",
                "multi_gpu": False,
                "ppo": True,
                "mixed_precision": False,
                "normalize_input": True,
                "normalize_value": True,
                "reward_shaper": {"scale_value": 1.0},
                "normalize_advantage": True,
                "gamma": 0.99,
                "tau": 0.95,
                "learning_rate": 3e-4,
                "lr_schedule": "adaptive",
                "schedule_type": "legacy",
                "kl_threshold": 0.008,
                "score_to_win": 20000,
                "max_epochs": 500,
                "save_best_after": 100,
                "save_frequency": 50,
                "grad_norm": 1.0,
                "entropy_coef": 0.0,
                "truncate_grads": True,
                "e_clip": 0.2,
                "horizon_length": 16,
                "minibatch_size": 32768,
                "mini_epochs": 4,
                "critic_coef": 2,
                "clip_value": True,
                "seq_len": 4,
                "bounds_loss_coef": 0.0001,
            },
        }
    }


def _cfg(name, algo="a2c_continuous", units=None, **config):
    c = _base(name, algo)
    if units is not None:
        c["params"]["network"]["mlp"]["units"] = list(units)
    c["params"]["config"].update(config)
    return c


# values mirror the reference cfg/train/<Task>PPO.yaml files
_TRAIN: Dict[str, dict] = {
    "Cartpole": _cfg(
        "Cartpole", units=[32, 32],
        reward_shaper={"scale_value": 0.1}, max_epochs=100, save_best_after=50,
        save_frequency=25, horizon_length=16, minibatch_size=8192,
        mini_epochs=8, critic_coef=4,
    ),
    "Ant": _cfg(
        "Ant", units=[256, 128, 64], mixed_precision=True, value_bootstrap=True,
        reward_shaper={"scale_value": 0.01}, max_epochs=500, save_best_after=200,
        horizon_length=16, minibatch_size=32768, mini_epochs=4, critic_coef=2,
        truncate_grads=False,
    ),
    "Humanoid": _cfg(
        "Humanoid", units=[400, 200, 100], mixed_precision=True,
        value_bootstrap=True, reward_shaper={"scale_value": 0.01},
        max_epochs=1000, save_best_after=200, horizon_length=32,
        minibatch_size=32768, mini_epochs=5, critic_coef=4,
    ),
    "BallBalance": _cfg(
        "BallBalance", units=[128, 64, 32], reward_shaper={"scale_value": 0.1},
        max_epochs=250, save_best_after=50, horizon_length=16,
        minibatch_size=8192, mini_epochs=8, critic_coef=4, learning_rate=3e-4,
    ),
    "Anymal": _cfg(
        "Anymal", units=[256, 128, 64], reward_shaper={"scale_value": 1.0},
        max_epochs=1000, horizon_length=24, minibatch_size=32768,
        mini_epochs=5, critic_coef=2, learning_rate=3e-4, kl_threshold=0.008,
    ),
    "AnymalTerrain": _cfg(
        "AnymalTerrain", units=[512, 256, 128], reward_shaper={"scale_value": 1.0},
        max_epochs=1500, horizon_length=24, minibatch_size=16384,
        mini_epochs=5, critic_coef=2, learning_rate=3e-4, kl_threshold=0.008,
        e_clip=0.2, entropy_coef=0.001, grad_norm=1.0,
    ),
    "FrankaReach": _cfg(
        "FrankaReach", units=[256, 128, 64], reward_shaper={"scale_value": 0.01},
        max_epochs=500, horizon_length=32, minibatch_size=8192, mini_epochs=8,
        critic_coef=4,
    ),
    # the fork's MA learner: same PPO core, agent-strided episode stats
    # (cfg/train/FrankaReachMAPPO.yaml:4 algo a2c_continuous_MA)
    "FrankaReachMA": _cfg(
        "FrankaReachMA", algo="a2c_continuous_MA", units=[256, 128, 64],
        reward_shaper={"scale_value": 0.01}, max_epochs=1500,
        horizon_length=32, minibatch_size=16384, mini_epochs=8, critic_coef=4,
    ),
    "FrankaCollectMA": _cfg(
        "FrankaCollectMA", algo="a2c_continuous_MA", units=[256, 128, 64],
        reward_shaper={"scale_value": 0.01}, max_epochs=1500,
        horizon_length=32, minibatch_size=16384, mini_epochs=8, critic_coef=4,
    ),
    "FrankaPPMA": _cfg(
        "FrankaPPMA", algo="a2c_continuous_MA", units=[256, 128, 64],
        reward_shaper={"scale_value": 0.01}, max_epochs=1500,
        horizon_length=32, minibatch_size=16384, mini_epochs=8, critic_coef=4,
    ),
    "FrankaCombineMA": _cfg(
        "FrankaCombineMA", algo="a2c_continuous_MA", units=[256, 128, 64],
        reward_shaper={"scale_value": 0.01}, max_epochs=1500,
        horizon_length=32, minibatch_size=16384, mini_epochs=8, critic_coef=4,
    ),
    "ShadowHand": _cfg(
        "ShadowHand", units=[512, 512, 256, 128], value_bootstrap=True,
        reward_shaper={"scale_value": 0.01}, max_epochs=5000,
        horizon_length=8, minibatch_size=32768, mini_epochs=5, critic_coef=4,
        learning_rate=5e-4,
    ),
    "AllegroHand": _cfg(
        "AllegroHand", units=[512, 256, 128], value_bootstrap=True,
        reward_shaper={"scale_value": 0.01}, max_epochs=5000,
        horizon_length=8, minibatch_size=32768, mini_epochs=5, critic_coef=4,
        learning_rate=5e-4,
    ),
    # dextreme (cfg/train/AllegroHandDextreme*PPO.yaml: big MLP, asymmetric
    # central value, heavy DR; ADR variant shares the config)
    "AllegroHandDextremeManualDR": _cfg(
        "AllegroHandDextremeManualDR", units=[512, 512, 256, 128],
        value_bootstrap=True,
        central_value_config={"network": {"mlp": {"units": [512, 256, 128]}},
                              "learning_rate": 5e-4},
        reward_shaper={"scale_value": 0.01}, max_epochs=10000,
        horizon_length=8, minibatch_size=32768, mini_epochs=5, critic_coef=4,
        learning_rate=5e-4,
    ),
    "AllegroHandDextremeADR": _cfg(
        "AllegroHandDextremeADR", units=[512, 512, 256, 128],
        value_bootstrap=True,
        central_value_config={"network": {"mlp": {"units": [512, 256, 128]}},
                              "learning_rate": 5e-4},
        reward_shaper={"scale_value": 0.01}, max_epochs=10000,
        horizon_length=8, minibatch_size=32768, mini_epochs=5, critic_coef=4,
        learning_rate=5e-4,
    ),
    # cfg/train/AllegroKukaPPO(LSTM).yaml: big MLP (+LSTM variant), long runs
    "AllegroKuka": _cfg(
        "AllegroKuka", units=[768, 512, 256], value_bootstrap=True,
        reward_shaper={"scale_value": 0.01}, max_epochs=100000,
        gamma=0.99, tau=0.95, horizon_length=16, minibatch_size=32768,
        mini_epochs=2, critic_coef=4, learning_rate=1e-4,
    ),
    "AllegroKukaTwoArms": _cfg(
        "AllegroKukaTwoArms", units=[768, 512, 256], value_bootstrap=True,
        reward_shaper={"scale_value": 0.01}, max_epochs=100000,
        horizon_length=16, minibatch_size=32768, mini_epochs=2,
        critic_coef=4, learning_rate=1e-4,
    ),
    # cfg/train/TrifingerPPO.yaml: asymmetric central value, constant LR
    "Trifinger": _cfg(
        "Trifinger", units=[256, 256, 128, 128], value_bootstrap=True,
        central_value_config={"network": {"mlp": {"units": [512, 512, 256, 128]}},
                              "learning_rate": 5e-4},
        reward_shaper={"scale_value": 0.01}, max_epochs=20000,
        lr_schedule="constant", kl_threshold=0.016, horizon_length=8,
        minibatch_size=16384, mini_epochs=4, critic_coef=4,
        learning_rate=3e-4,
    ),
    "Ingenuity": _cfg(
        "Ingenuity", units=[256, 256, 128], reward_shaper={"scale_value": 0.01},
        max_epochs=400, horizon_length=16, minibatch_size=16384, mini_epochs=8,
    ),
    "Quadcopter": _cfg(
        "Quadcopter", units=[256, 256, 128], reward_shaper={"scale_value": 0.1},
        max_epochs=1000, horizon_length=16, minibatch_size=16384, mini_epochs=8,
    ),
    "FrankaCabinet": _cfg(
        "FrankaCabinet", units=[256, 128, 64], reward_shaper={"scale_value": 0.01},
        max_epochs=1500, horizon_length=16, minibatch_size=8192, mini_epochs=8,
        critic_coef=4,
    ),
    "FrankaCubeStack": _cfg(
        "FrankaCubeStack", units=[256, 128, 64], reward_shaper={"scale_value": 0.1},
        max_epochs=10000, horizon_length=32, minibatch_size=16384, mini_epochs=8,
    ),
    # the fork's FSM cube-stack (cfg/train/FrankaCubeStack2PPO.yaml)
    "FrankaCubeStack2": _cfg(
        "FrankaCubeStack2", units=[256, 128, 64],
        reward_shaper={"scale_value": 0.1}, max_epochs=300,
        horizon_length=32, minibatch_size=16384, mini_epochs=8,
        learning_rate=3e-4,
    ),
    "HumanoidAMP": _cfg(
        "HumanoidAMP", algo="amp_continuous", units=[1024, 512],
        reward_shaper={"scale_value": 1.0}, max_epochs=5000,
        horizon_length=16, minibatch_size=32768, mini_epochs=6,
        critic_coef=5, learning_rate=5e-5, lr_schedule="fixed",
        e_clip=0.2, entropy_coef=0.0, truncate_grads=True, grad_norm=1.0,
    ),
}


# SAC variant (cfg/train/AntSAC.yaml)
_TRAIN["AntSAC"] = {
    "params": {
        "seed": 42,
        "algo": {"name": "sac"},
        "model": {"name": "soft_actor_critic"},
        "network": {"name": "soft_actor_critic", "separate": True,
                    "mlp": {"units": [512, 256], "activation": "relu"}},
        "config": {
            "name": "AntSAC", "env_name": "rlgpu", "normalize_input": True,
            "gamma": 0.99, "critic_tau": 0.005, "batch_size": 4096,
            "init_alpha": 1.0, "alpha_lr": 0.005, "actor_lr": 0.0005,
            "critic_lr": 0.0005, "learnable_temperature": True,
            "num_seed_steps": 5, "num_steps_per_episode": 8,
            "replay_buffer_size": 1000000, "max_epochs": 20000,
            "save_frequency": 1000,
        },
    }
}


# cfg/train/HumanoidSAC.yaml: AntSAC schema, longer run
_TRAIN["HumanoidSAC"] = copy.deepcopy(_TRAIN["AntSAC"])
_TRAIN["HumanoidSAC"]["params"]["config"].update(
    name="HumanoidSAC", max_epochs=50000)


# cfg/train/FactoryTaskNutBolt*PPO.yaml: small MLP, long horizons, low LR
for _fname, _hl, _mb in (("FactoryTaskNutBoltPick", 120, 512),
                         ("FactoryTaskNutBoltPlace", 120, 512),
                         ("FactoryTaskNutBoltScrew", 128, 512)):
    _TRAIN[_fname] = _cfg(
        _fname, units=[256, 128, 64], reward_shaper={"scale_value": 1.0},
        max_epochs=1024, horizon_length=_hl, minibatch_size=_mb,
        mini_epochs=8, learning_rate=1e-4, lr_schedule="fixed",
        critic_coef=2,
    )

# cfg/train/IndustRealTask*PPO.yaml: LSTM policy + central value critic
for _iname in ("IndustRealTaskPegsInsert", "IndustRealTaskGearsInsert"):
    _TRAIN[_iname] = _cfg(
        _iname, units=[512, 256, 128], value_bootstrap=True,
        central_value_config={"network": {"mlp": {"units": [512, 256, 128]}},
                              "learning_rate": 1e-3},
        reward_shaper={"scale_value": 1.0}, max_epochs=8192,
        horizon_length=128, minibatch_size=8192, mini_epochs=8,
        learning_rate=1e-3, lr_schedule="fixed",
    )

# cfg/train/FactoryTask{Gears,Insertion}PPO.yaml (scene playgrounds; same
# schema as the nut-bolt configs, horizon 32)
for _fname in ("FactoryTaskGears", "FactoryTaskInsertion"):
    _TRAIN[_fname] = _cfg(
        _fname, units=[256, 128, 64], reward_shaper={"scale_value": 1.0},
        value_bootstrap=True, mixed_precision=True, max_epochs=8192,
        horizon_length=32, minibatch_size=512, mini_epochs=8,
        learning_rate=1e-4, lr_schedule="fixed", kl_threshold=0.016,
    )

# cfg/train/ShadowHandPPOAsymm.yaml: asymmetric central-value critic
_TRAIN["ShadowHandPPOAsymm"] = _cfg(
    "ShadowHandAsymm", units=[400, 400, 200, 100],
    reward_shaper={"scale_value": 0.01}, learning_rate=5e-4,
    schedule_type="standard", kl_threshold=0.016, score_to_win=100000,
    max_epochs=10000, save_best_after=500, save_frequency=200,
    horizon_length=8, minibatch_size=16384, mini_epochs=8, critic_coef=4,
    central_value_config={
        "minibatch_size": 16384, "mini_epochs": 8, "learning_rate": 5e-4,
        "kl_threshold": 0.016, "clip_value": True, "normalize_input": True,
        "network": {"mlp": {"units": [512, 512, 256, 128]}},
    },
)

# cfg/train/ShadowHandPPOAsymmLSTM.yaml: LSTM policy (mlp [512] relu + lstm
# 1024) over the asymmetric critic, gamma 0.998
_TRAIN["ShadowHandPPOAsymmLSTM"] = copy.deepcopy(_TRAIN["ShadowHandPPOAsymm"])
_TRAIN["ShadowHandPPOAsymmLSTM"]["params"]["network"]["mlp"] = {
    "units": [512], "activation": "relu", "initializer": {"name": "default"}}
_TRAIN["ShadowHandPPOAsymmLSTM"]["params"]["network"]["rnn"] = {
    "name": "lstm", "units": 1024, "layers": 1,
    "before_mlp": True, "layer_norm": True}
_TRAIN["ShadowHandPPOAsymmLSTM"]["params"]["config"].update(
    name="ShadowHandAsymmLSTM", gamma=0.998, learning_rate=1e-4,
    save_frequency=500, horizon_length=16, mini_epochs=4, seq_len=4)

# cfg/train/ShadowHandPPOLSTM.yaml: symmetric LSTM variant
_TRAIN["ShadowHandPPOLSTM"] = copy.deepcopy(_TRAIN["ShadowHand"])
_TRAIN["ShadowHandPPOLSTM"]["params"]["network"]["rnn"] = {
    "name": "lstm", "units": 256, "layers": 1,
    "before_mlp": False, "concat_input": True, "layer_norm": True}
_TRAIN["ShadowHandPPOLSTM"]["params"]["config"]["seq_len"] = 4

# cfg/train/ShadowHandOpenAI{,_FF,_LSTM}PPO.yaml are pure Hydra
# defaults-inheritance of the asymmetric configs; the task-config variants
# (task=ShadowHandOpenAI_FF etc.) resolve to these train configs.
_TRAIN["ShadowHandOpenAI"] = copy.deepcopy(_TRAIN["ShadowHandPPOAsymm"])
_TRAIN["ShadowHandOpenAI_FF"] = copy.deepcopy(_TRAIN["ShadowHandPPOAsymm"])
_TRAIN["ShadowHandOpenAI_LSTM"] = copy.deepcopy(
    _TRAIN["ShadowHandPPOAsymmLSTM"])
_TRAIN["ShadowHandTest"] = copy.deepcopy(_TRAIN["ShadowHandPPOAsymm"])

# cfg/train/AllegroHandLSTMPPO.yaml: mlp [256] + lstm 512 policy, asymmetric
# central value, gamma 0.998, seq_len 16
_TRAIN["AllegroHandLSTM"] = _cfg(
    "AllegroHandAsymmLSTM", units=[256],
    reward_shaper={"scale_value": 1.0}, gamma=0.998, learning_rate=1e-4,
    schedule_type="standard", kl_threshold=0.016, score_to_win=100000,
    max_epochs=50000, save_best_after=200, save_frequency=500,
    horizon_length=16, minibatch_size=16384, mini_epochs=4, critic_coef=4,
    seq_len=16,
    central_value_config={
        "minibatch_size": 16384, "mini_epochs": 4, "learning_rate": 1e-4,
        "kl_threshold": 0.016, "clip_value": True, "normalize_input": True,
        "network": {"mlp": {"units": [512, 256, 128]}},
    },
)
_TRAIN["AllegroHandLSTM"]["params"]["network"]["rnn"] = {
    "name": "lstm", "units": 512, "layers": 1,
    "before_mlp": True, "layer_norm": True}
# cfg/train/AllegroHandLSTM_BigPPO.yaml: lstm 1024 variant
_TRAIN["AllegroHandLSTM_Big"] = copy.deepcopy(_TRAIN["AllegroHandLSTM"])
_TRAIN["AllegroHandLSTM_Big"]["params"]["network"]["rnn"]["units"] = 1024
# task=AllegroHandFF has no dedicated train yaml; uses the base PPO config
_TRAIN["AllegroHandFF"] = copy.deepcopy(_TRAIN["AllegroHand"])

# cfg/train/AnymalTerrainPPO_LSTM.yaml: terrain PPO + lstm 256 (no layer norm)
_TRAIN["AnymalTerrainPPO_LSTM"] = copy.deepcopy(_TRAIN["AnymalTerrain"])
_TRAIN["AnymalTerrainPPO_LSTM"]["params"]["network"]["rnn"] = {
    "name": "lstm", "units": 256, "layers": 1,
    "before_mlp": False, "concat_input": True, "layer_norm": False}

# cfg/train/HumanoidAMPPPOLowGP.yaml: low discriminator gradient penalty for
# dynamic motions (hop/backflip — cfg/task/HumanoidAMP.yaml comments)
_TRAIN["HumanoidAMPPPOLowGP"] = copy.deepcopy(_TRAIN["HumanoidAMP"])
_TRAIN["HumanoidAMPPPOLowGP"]["params"]["config"]["disc_grad_penalty"] = 0.2
# task=HumanoidAMPHands trains with the standard AMP config
_TRAIN["HumanoidAMPHands"] = copy.deepcopy(_TRAIN["HumanoidAMP"])

# LSTM variants (cfg/train/*PPOLSTM.yaml): same config + rnn block
for _name in ("AllegroKuka", "AllegroKukaTwoArms"):
    _lstm = copy.deepcopy(_TRAIN[_name])
    _lstm["params"]["network"]["rnn"] = {
        "name": "lstm", "units": 768, "layers": 1,
        "before_mlp": True, "concat_input": True, "layer_norm": True}
    _lstm["params"]["config"]["seq_len"] = 16
    _TRAIN[_name + "LSTM"] = _lstm


def train_default_config(task_name: str) -> dict:
    if task_name not in _TRAIN:
        # accept the reference's yaml-file names too (train=AntPPO,
        # train=ShadowHandOpenAI_FFPPO, train=AllegroKukaLSTMPPO ...)
        stripped = task_name[:-3] if task_name.endswith("PPO") else None
        if stripped and stripped in _TRAIN:
            return copy.deepcopy(_TRAIN[stripped])
        # sensible default for unlisted tasks
        return copy.deepcopy(_base(task_name))
    return copy.deepcopy(_TRAIN[task_name])
