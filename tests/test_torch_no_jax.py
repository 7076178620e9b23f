"""The port never imports jax, nor anything of the JAX package.

Runs in a subprocess because tests/conftest.py imports jax into this one:
import every module of isaacgymenvs_ma_tpu_torch, build and step Ant and
BallBalance at 8 envs on the CPU (default loop and contact-kernel route),
FrankaReachMA at 4 envs x 2 arms (OSC; compaction and row reuse on the
default loop, and the contact-kernel route), FrankaCollectMA at 4 envs x 2
arms with live grabs (each agent's cube on its grip site, its gripper
closing; both routes), Cartpole at 8 envs (the
contact-free path, which no route option changes) and Humanoid, Anymal,
AnymalTerrain (on a 2 x 5 terrain map), Ingenuity and Quadcopter at 8 envs
on both routes, FrankaReach, FrankaCabinet, FrankaCubeStack,
FrankaCubeStack2 (the grab live in one env) and Trifinger (with its
shipped domain randomization) at 4 envs on both routes, the five
AllegroKuka subtasks (per-env cuboid sizes) at 4 envs (the two
Reorientation scenes on both routes), ShadowHand and AllegroHand (mass
splitting; AllegroHand's dof friction) at 4 envs with and without the
contact-kernel request (both take the loop) and ShadowHandOpenAI_FF and
AllegroHandLSTM (critic states, the random object force), call
``spd_inverse``,
run one PPO ``train_epoch`` of Cartpole at 16 envs, one of Cartpole with
an LSTM network and one of Trifinger with its central-value critic, then
check that neither ``jax*`` nor ``isaacgymenvs_ma_tpu`` /
``isaacgymenvs_ma_tpu.*`` was loaded.
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
    from isaacgymenvs_ma_tpu_torch.tasks.franka_collect_ma import (
        FrankaCollectMA, TASK_CFG as FC_CFG)
    from isaacgymenvs_ma_tpu_torch.utils.parity import live_grabs
    torch.manual_seed(0)
    for kernel_route in (False, True):
        cfg = deep_merge(FC_CFG, {"env": {"numEnvs": 4}})
        params = parse_sim_params(cfg["sim"])._replace(
            use_contact_kernel=kernel_route)
        task = FrankaCollectMA(cfg, device="cpu", sim_params=params)
        # two steps: the first resets every env on the second (the initial
        # state's OSC torques are not finite, so the first step flags all)
        state = task.initial_state()
        for _ in range(2):
            state, _ = task.step(state, torch.zeros(8, 7))
        actions = torch.tanh(torch.randn(8, 7))
        state = live_grabs(task, state, actions, [0, 2])
        assert float(task.pre_physics(state, actions).grab_active.sum()) == 4
        state, res = task.step(state, actions)
        assert torch.isfinite(res.obs).all() and res.obs.shape == (8, 28)
        assert (state.task.fsm[[0, 2]] >= 2).all()   # holding, or more
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
    from isaacgymenvs_ma_tpu_torch.tasks import registry
    for name, over in (("Humanoid", {}), ("Anymal", {}),
                       ("AnymalTerrain", {"terrain": {"numLevels": 2,
                                                      "numTerrains": 5}}),
                       ("Ingenuity", {}), ("Quadcopter", {})):
        for kernel_route in (False, True):
            cfg = deep_merge(registry.task_default_config(name),
                             {"env": {"numEnvs": 8, **over}})
            params = parse_sim_params(cfg["sim"])._replace(
                use_contact_kernel=kernel_route)
            task = registry.task_class(name)(cfg, device="cpu",
                                             sim_params=params)
            state = task.initial_state()
            for _ in range(2):
                state, res = task.step(
                    state, torch.tanh(torch.randn(8, task.num_actions)))
            assert torch.isfinite(res.obs).all()
            assert res.obs.shape == (8, task.num_obs)
    from isaacgymenvs_ma_tpu_torch.utils.parity import live_cabinet_grabs
    for name in ("FrankaReach", "FrankaCabinet", "FrankaCubeStack",
                 "FrankaCubeStack2", "Trifinger"):
        for kernel_route in (False, True):
            cfg = deep_merge(registry.task_default_config(name),
                             {"env": {"numEnvs": 4}})
            params = parse_sim_params(cfg["sim"])._replace(
                use_contact_kernel=kernel_route)
            task = registry.task_class(name)(cfg, device="cpu",
                                             sim_params=params)
            state = task.initial_state()
            for _ in range(2):
                state, res = task.step(state, torch.zeros(4, task.num_actions))
            actions = torch.tanh(torch.randn(4, task.num_actions))
            if name == "FrankaCabinet":
                state = live_cabinet_grabs(task, state, actions, [1])
            elif task.engine.grabs:
                state = live_grabs(task, state, actions, [1])
            if task.engine.grabs:
                ctrl = task.pre_physics(state, actions)
                assert ctrl.grab_active[:, 0].tolist() == [0, 1, 0, 0]
            state, res = task.step(state, actions)
            assert torch.isfinite(res.obs).all()
            assert res.obs.shape == (4, task.num_obs)
            if name == "Trifinger":   # the shipped randomization is on
                assert state.phys is not None
                assert res.states.shape == (4, 113)
    from isaacgymenvs_ma_tpu_torch.tasks import allegro_kuka
    for name, subtask, routes in (
            ("AllegroKuka", "reorientation", (False, True)),
            ("AllegroKuka", "regrasping", (False,)),
            ("AllegroKuka", "throw", (False,)),
            ("AllegroKukaTwoArms", "reorientation", (False, True)),
            ("AllegroKukaTwoArmsLSTM", "regrasping", (False,))):
        for kernel_route in routes:
            cfg = deep_merge(registry.task_default_config(name),
                             {"env": {"numEnvs": 4, "subtask": subtask}})
            params = parse_sim_params(cfg["sim"])._replace(
                use_contact_kernel=kernel_route)
            task = registry.task_class(name)(cfg, device="cpu",
                                             sim_params=params)
            assert isinstance(task, allegro_kuka.AllegroKukaBase)
            state = task.initial_state()
            assert state.phys.shape.shape == (4, task.model.nb, 3)
            for _ in range(2):
                state, res = task.step(
                    state, torch.tanh(torch.randn(4, task.num_actions)))
            assert torch.isfinite(res.obs).all()
            assert res.obs.shape == (4, task.num_obs)
    for name, routes in (("ShadowHand", (False, True)),
                         ("AllegroHand", (False, True)),
                         ("ShadowHandOpenAI_FF", (False,)),
                         ("AllegroHandLSTM", (False,))):
        for kernel_route in routes:
            cfg = deep_merge(registry.task_default_config(name),
                             {"env": {"numEnvs": 4}})
            params = parse_sim_params(cfg["sim"])._replace(
                use_contact_kernel=kernel_route)
            task = registry.task_class(name)(cfg, device="cpu",
                                             sim_params=params)
            assert task.engine.contact_route == "loop"
            state = task.initial_state()
            for _ in range(2):
                state, res = task.step(
                    state, torch.tanh(torch.randn(4, task.num_actions)))
            assert torch.isfinite(res.obs).all()
            assert res.obs.shape == (4, task.num_obs)
            if task.num_states:
                assert res.states.shape == (4, task.num_states)
    from isaacgymenvs_ma_tpu_torch.learning import networks
    tcfg = train_default_config("Cartpole")
    tcfg["params"]["config"].update(minibatch_size=128, seq_len=4)
    tcfg["params"]["network"]["rnn"] = {"name": "lstm", "units": 8}
    agent = PPOAgent(Cartpole(deep_merge(CP_CFG, {"env": {"numEnvs": 16}}),
                              device="cpu"), tcfg, seed=1)
    agent.init()
    assert isinstance(agent.net, networks.ActorCriticLSTM)
    m = agent.train_epoch()
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in m.values())
    tcfg = train_default_config("Trifinger")
    tcfg["params"]["config"]["minibatch_size"] = 16
    tri = registry.task_class("Trifinger")(deep_merge(
        registry.task_default_config("Trifinger"), {"env": {"numEnvs": 4}}),
        device="cpu")
    agent = PPOAgent(tri, tcfg, seed=1)
    agent.init()
    assert isinstance(agent.net, networks.AsymActorCritic)
    m = agent.train_epoch()
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in m.values())
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
    # tasks.registry), the MA tasks with grabs (franka_collect_ma,
    # franka_ppma, franka_combine_ma), the legged and aerial tasks with
    # the terrain and their specs, and the single-arm Franka tasks,
    # Trifinger, its spec and the domain randomizer, the AllegroKuka tasks
    # and their spec, the two hand tasks and their specs too
    n_mods = int(proc.stdout.split("MODULES")[1].split()[0])
    assert n_mods >= 62, proc.stdout
