"""The port never imports jax, nor anything of the JAX package.

Runs in a subprocess because tests/conftest.py imports jax into this one:
import every module of isaacgymenvs_ma_tpu_torch, build and step Ant and
BallBalance at 8 envs on the CPU (default loop and contact-kernel route),
FrankaReachMA at 4 envs x 2 arms (OSC; compaction and row reuse on the
default loop, and the contact-kernel route) and Cartpole at 8 envs (the
contact-free path, which no route option changes), call ``spd_inverse``,
run one PPO ``train_epoch`` of Cartpole at 16 envs, then check that neither ``jax*`` nor
``isaacgymenvs_ma_tpu`` / ``isaacgymenvs_ma_tpu.*`` was loaded.
"""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    import torch
    import isaacgymenvs_ma_tpu_torch as port
    mods = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                  port.__name__ + ".")]
    for name in mods:
        importlib.import_module(name)
    from isaacgymenvs_ma_tpu_torch.tasks.ant import Ant, TASK_CFG
    from isaacgymenvs_ma_tpu_torch.tasks.ball_balance import (
        BallBalance, TASK_CFG as BB_CFG)
    from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    for cls, cfg0, n_obs, n_act in ((Ant, TASK_CFG, 60, 8),
                                    (BallBalance, BB_CFG, 24, 3)):
        for kernel_route in (False, True):
            cfg = deep_merge(cfg0, {"env": {"numEnvs": 8}})
            params = parse_sim_params(cfg["sim"])._replace(
                use_contact_kernel=kernel_route)
            task = cls(cfg, device="cpu", sim_params=params)
            state = task.initial_state()
            for _ in range(2):
                state, res = task.step(state,
                                       torch.tanh(torch.randn(8, n_act)))
            assert torch.isfinite(res.obs).all()
            assert res.obs.shape == (8, n_obs)
    from isaacgymenvs_ma_tpu_torch.tasks.franka_reach_ma import (
        FrankaReachMA, TASK_CFG as FR_CFG)
    from isaacgymenvs_ma_tpu_torch.physics.engine import spd_inverse
    for kernel_route in (False, True):
        cfg = deep_merge(FR_CFG, {"env": {"numEnvs": 4}})
        params = parse_sim_params(cfg["sim"])._replace(
            use_contact_kernel=kernel_route)
        task = FrankaReachMA(cfg, device="cpu", sim_params=params)
        state = task.initial_state()
        for _ in range(2):
            state, res = task.step(state, torch.tanh(torch.randn(8, 6)))
        assert torch.isfinite(res.obs).all() and res.obs.shape == (8, 19)
    from isaacgymenvs_ma_tpu_torch.tasks.cartpole import (
        Cartpole, TASK_CFG as CP_CFG)
    for kernel_route in (False, True):
        cfg = deep_merge(CP_CFG, {"env": {"numEnvs": 8}})
        params = parse_sim_params(cfg["sim"])._replace(
            use_contact_kernel=kernel_route)
        task = Cartpole(cfg, device="cpu", sim_params=params)
        assert task.engine.cplan is None
        state = task.initial_state()
        for _ in range(3):
            state, res = task.step(state, torch.tanh(torch.randn(8, 1)))
        assert torch.isfinite(res.obs).all() and res.obs.shape == (8, 4)
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config)
    from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
    cfg = deep_merge(CP_CFG, {"env": {"numEnvs": 16}})
    tcfg = train_default_config("Cartpole")
    tcfg["params"]["config"]["minibatch_size"] = 128
    agent = PPOAgent(Cartpole(cfg, device="cpu"), tcfg, seed=1)
    agent.init()
    before = [p.detach().clone() for p in agent.net.parameters()]
    m = agent.train_epoch()
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in m.values())
    assert any(not torch.equal(a, b)
               for a, b in zip(before, agent.net.parameters()))
    A = torch.randn(5, 7, 7)
    Hinv = spd_inverse(A @ A.transpose(1, 2) + 3 * torch.eye(7))
    assert torch.isfinite(Hinv).all()
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax")
                    or m == "isaacgymenvs_ma_tpu"
                    or m.startswith("isaacgymenvs_ma_tpu."))
    print("MODULES", len(mods), "LOADED", loaded)
    assert not loaded, loaded
""")


def test_port_imports_and_steps_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
    # every module of the package was imported (scaffold, models, ops,
    # physics, tasks, utils, convert), the learner (learning/*, train, api,
    # tasks.registry) too
    n_mods = int(proc.stdout.split("MODULES")[1].split()[0])
    assert n_mods >= 38, proc.stdout
