"""End-to-end learning of the port on the CPU: PPO trains Cartpole to
balance, the port's counterpart of tests/test_ppo_cartpole.py with its
setting (256 envs, minibatch 2048, seed 7, 60 epochs) and its bar: the
mean episode return, read every 10 epochs, must clear 100 (the reward is
~1 a step when balancing and episodes cap at 500 steps).  On one CPU
thread the port passes the bar by epoch 20 and runs the 60 epochs in
~25 s.
"""
import torch

from isaacgymenvs_ma_tpu_torch.learning.configs import train_default_config
from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
from isaacgymenvs_ma_tpu_torch.tasks.cartpole import Cartpole, TASK_CFG
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

torch.set_num_threads(1)   # small CPU ops: one thread a test worker


def test_port_ppo_learns_cartpole():
    cfg = deep_merge(TASK_CFG, {"env": {"numEnvs": 256}})
    task = Cartpole(cfg, device="cpu", seed=7)
    tcfg = train_default_config("Cartpole")
    tcfg["params"]["config"]["minibatch_size"] = 2048  # 256 envs * 16 / 2
    agent = PPOAgent(task, tcfg, seed=7)
    agent.init()
    best = -1e9
    for ep in range(60):
        metrics = agent.train_epoch()
        if (ep + 1) % 10 == 0:
            mr = float(metrics["mean_return"])
            best = max(best, mr)
            print("epoch", ep + 1, "mean_return", mr)
    assert best > 100.0, best
