"""One whole PPO epoch of the port against the JAX ``PPOAgent`` at Ant: 16
envs at the full network width (60 -> 256-128-64 -> 8), horizon 16,
minibatch 128, 4 mini-epochs (8 updates), ``value_bootstrap`` on and no
gradient truncation, as the Ant config has it.  The method (JAX's first
epoch, its state carried over, its draws injected into the second) is
``test_torch_ppo_epoch.run_epoch_pair``'s; no env resets in this window
(every Ant stands through its first 32 steps), the reset draws are
injected all the same.

Tolerances.  Measured on the CPU at seed 3: obs 2.1e-4, actions and mu
1.0e-5, neglogp 1.9e-6, values 1.1e-5, rewards 9.3e-5, advantages and
returns 9.7e-5, metrics within 6e-6 relative, parameters 6.2e-6,
normalisers 3.3e-6.  obs at the Ant step's 2e-3
(tests/test_torch_ant_step.py).  Rewards at the reward scale 0.01 times
(2e-3 + four float32 ulps of the ~6e4 potential): the progress term is a
difference of two potentials, and one ulp there is 3.9e-3 (ROADMAP C4).
Advantages and returns sum such errors over the horizon: held at 1e-3,
ten times the measured error.  Parameters at 5e-5, against one Adam step
of lr ~1.5e-3.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_ppo_epoch import (check_gae, check_metrics, check_normalisers,
                                  check_params, check_rollout, run_epoch_pair)

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

_ULP = float(np.spacing(np.float32(6e4)))
ANT_TOL = {"obs": 2e-3, "actions": 1e-4, "mu": 1e-4, "neglogp": 1e-4,
           "values": 1e-4, "rewards": 0.01 * (2e-3 + 4 * _ULP), "adv": 1e-3,
           "returns": 1e-3, "metrics_rtol": 1e-4, "params": 5e-5,
           "rms_rtol": 1e-4}


def ant_draws(k1, k2, n):
    return (jax.random.uniform(k1, (n, 8), minval=-0.2, maxval=0.2),
            jax.random.uniform(k2, (n, 8), minval=-0.1, maxval=0.1))


@pytest.fixture(scope="module")
def ant_epoch():
    from isaacgymenvs_ma_tpu.tasks.ant import Ant as JAnt
    from isaacgymenvs_ma_tpu.tasks.ant import TASK_CFG as JCFG
    from isaacgymenvs_ma_tpu_torch.tasks.ant import Ant, TASK_CFG
    return run_epoch_pair(JAnt, JCFG, Ant, TASK_CFG, "Ant", n=16,
                          minibatch=128, seed=3, draw=ant_draws)


def test_ant_rollout(ant_epoch):
    check_rollout(ant_epoch, ANT_TOL)


def test_ant_advantages_and_returns(ant_epoch):
    check_gae(ant_epoch, ANT_TOL)


def test_ant_epoch_metrics_and_lr(ant_epoch):
    check_metrics(ant_epoch, ANT_TOL)


def test_ant_parameters_after_epoch(ant_epoch):
    check_params(ant_epoch, ANT_TOL)


def test_ant_normalisers_after_epoch(ant_epoch):
    check_normalisers(ant_epoch, ANT_TOL)
