"""FrankaReach (port of isaacgymenvs_ma_tpu/tasks/franka_reach.py) — the
fork's single-agent reach base, obs 13 / act 6: FrankaReachMA with one arm
and one target cube at 4096 envs (the same scene, OSC control through
kernel B5 and inverse-square distance reward)."""
from __future__ import annotations

from ..utils.config import deep_merge
from .franka_reach_ma import FrankaReachMA, TASK_CFG as MA_CFG

TASK_CFG = deep_merge(MA_CFG, {
    "name": "FrankaReach",
    "env": {"numEnvs": 4096, "numAgents": 1, "numTargets": 1},
})


class FrankaReach(FrankaReachMA):
    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        cfg["env"]["numAgents"] = 1
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)
