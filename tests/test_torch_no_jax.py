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
AllegroHandLSTM (critic states, the random object force),
AllegroHandDextremeManualDR and AllegroHandADR at 4 envs (the RNA, the ADR
rows' restitution and limit shifts on the loop) and the dict-observation
shim over the latter, FactoryTaskNutBoltPick and IndustRealTaskPegsInsert
at 4 envs (the voxelizer's grids; warm start, body damping, bf16 rows,
SDF-grid targets; Pick over an episode's end, so that its close-and-lift
epilogue runs), HumanoidAMP at 4 envs on both routes (its clips and
motion library), call
``spd_inverse``,
run one PPO ``train_epoch`` of Cartpole at 16 envs, one of Cartpole with
an LSTM network and one of Trifinger with its central-value critic, one
AMP epoch of HumanoidAMP, one SAC epoch of AntSAC across its seed steps
and one step of the HRL wrapper over HumanoidAMP, run one rank worker
(a world-1 gloo group: a data-parallel Cartpole epoch and its full-width
checkpoint, a data-parallel AntSAC epoch), the motion ingest tool on a
shipped clip, the Factory lift evaluation (Pick at 4 envs, a 4-step
episode) and the glue modules (the event writer and reader, the YAML
emitter, a profiler trace, a rendered frame, a PBT save, a mutation, a
poselib pose), then check that neither ``jax*`` nor ``isaacgymenvs_ma_tpu`` /
``isaacgymenvs_ma_tpu.*`` was loaded.
"""
import copy
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, os, pkgutil, sys
    import torch
    torch.set_num_threads(1)    # small CPU ops: one thread
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
    from isaacgymenvs_ma_tpu_torch.utils.rlgames_utils import (
        ComplexObsRLGPUEnv)
    for name in ("AllegroHandDextremeManualDR", "AllegroHandADR"):
        cfg = deep_merge(registry.task_default_config(name),
                         {"env": {"numEnvs": 4}})
        task = registry.create_task(name, cfg, device="cpu")
        state = task.initial_state()
        assert task.engine.route_for(state.phys) == "loop"
        for _ in range(2):
            state, res = task.step(
                state, torch.tanh(torch.randn(4, task.num_actions)))
        assert torch.isfinite(res.obs).all() and res.obs.shape == (4, 50)
        assert res.states.shape == (4, 112)
    env = ComplexObsRLGPUEnv(task, {
        "obs": {"names": ["dof_pos", "object_pose"]},
        "priv": {"names": ["dof_vel"], "concat": False}})
    out, rew, reset, extras = env.step(torch.zeros(4, 16))
    assert out["obs"].shape == (4, 23) and "adr_npd" in extras
    out, done = env.reset_done()
    assert out["priv"]["dof_vel"].shape == (4, 16)
    for name, over in (("FactoryTaskNutBoltPick",
                        {"rl": {"max_episode_length": 3}}),
                       ("IndustRealTaskPegsInsert", {})):
        cfg = deep_merge(registry.task_default_config(name),
                         {"env": {"numEnvs": 4}, **over})
        task = registry.create_task(name, cfg, device="cpu")
        eng = task.engine
        assert eng.rows_bf16 and eng.has_body_damping
        assert eng.contact_route == "loop"
        assert any(p["grid"] is not None for p in eng.pairs)
        state = task.initial_state()
        for _ in range(3):
            state, res = task.step(
                state, torch.tanh(torch.randn(4, task.num_actions)))
        assert torch.isfinite(res.obs).all()
        assert res.obs.shape == (4, task.num_obs)
        assert state.sim.lam is not None and task.branch_reads == 3
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
    # HumanoidAMP (its clips and motion library) on both routes, one AMP
    # epoch, one SAC epoch across its seed steps and an HRL step
    from isaacgymenvs_ma_tpu_torch.learning.amp import AMPAgent
    from isaacgymenvs_ma_tpu_torch.learning.hrl import (
        HRLTaskWrapper, build_llc_from_checkpoint)
    from isaacgymenvs_ma_tpu_torch.learning.sac import SACAgent
    for kernel_route in (False, True):
        cfg = deep_merge(registry.task_default_config("HumanoidAMP"),
                         {"env": {"numEnvs": 4}})
        params = parse_sim_params(cfg["sim"])._replace(
            use_contact_kernel=kernel_route)
        amp_task = registry.task_class("HumanoidAMP")(
            cfg, device="cpu", sim_params=params)
        state = amp_task.initial_state()
        for _ in range(2):
            state, res = amp_task.step(state, torch.tanh(torch.randn(4, 28)))
        assert torch.isfinite(res.extras["amp_obs"]).all()
        assert res.obs.shape == (4, 105)
    tcfg = train_default_config("HumanoidAMP")
    tcfg["params"]["config"].update(minibatch_size=16, horizon_length=4,
                                    amp_batch_size=8)
    tcfg["params"]["network"]["mlp"]["units"] = [16, 8]
    agent = AMPAgent(amp_task, tcfg, seed=1)
    agent.init()
    m = agent.train_epoch()
    assert all(torch.isfinite(torch.as_tensor(v)).all() for v in m.values())
    assert agent.replay_n == 8
    tcfg = train_default_config("AntSAC")
    tcfg["params"]["config"].update(batch_size=16, replay_buffer_size=200,
                                    num_steps_per_episode=7)
    tcfg["params"]["network"]["mlp"]["units"] = [16, 8]
    sac = SACAgent(registry.create_task("AntSAC", deep_merge(
        registry.task_default_config("AntSAC"), {"env": {"numEnvs": 4}}),
        device="cpu"), tcfg, seed=1)
    sac.init()
    m = sac.train_epoch()
    assert sac.step == 7 and float(m["critic_loss"]) > 0
    llc, latent = build_llc_from_checkpoint(
        amp_task, {"latent_dim": 8, "units": [16, 8]})
    hrl = HRLTaskWrapper(amp_task, llc, latent, llc_steps=2)
    hst, _ = hrl.reset(hrl.initial_state())
    hst, res = hrl.step(hst, torch.randn(4, 8))
    assert torch.isfinite(res.obs).all() and res.obs.shape == (4, 105)
    A = torch.randn(5, 7, 7)
    Hinv = spd_inverse(A @ A.transpose(1, 2) + 3 * torch.eye(7))
    assert torch.isfinite(Hinv).all()
    # one rank worker (a world-1 gloo group on 127.0.0.1): a data-parallel
    # PPO epoch and its full-width checkpoint, then the glue modules
    import tempfile
    from isaacgymenvs_ma_tpu_torch.learning import checkpoint as ckpt
    from isaacgymenvs_ma_tpu_torch.parallel import mesh
    from isaacgymenvs_ma_tpu_torch.parallel.dryrun import free_port
    dp = mesh.DataParallel.init(device="cpu", backend="gloo", environ={
        "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())})
    ctask = Cartpole(deep_merge(CP_CFG, {"env": {"numEnvs": 16}}),
                     device="cpu")
    ctcfg = train_default_config("Cartpole")
    ctcfg["params"]["config"]["minibatch_size"] = 128
    dagent = PPOAgent(ctask, ctcfg, seed=0, dist=dp)
    dagent.init()
    assert torch.isfinite(dagent.train_epoch()["loss"])
    tmp = tempfile.mkdtemp()
    assert ckpt.save_agent(tmp + "/dp.pth", dagent, ctask, dp)
    # the AntSAC learner of above over the same group: the global rows,
    # the split update
    dsac = SACAgent(sac.task, tcfg, seed=1, dist=dp)
    dsac.init()
    assert float(dsac.train_epoch()["critic_loss"]) > 0
    assert mesh.state_digest(dsac) and dp.combine_bytes > 0
    torch.distributed.destroy_process_group()
    # the motion tools and the Factory evaluation
    import shutil
    from isaacgymenvs_ma_tpu_torch import eval_factory_lift
    from isaacgymenvs_ma_tpu_torch.poselib import (ingest_motions,
                                                   retarget_motion)
    clips = tmp + "/clips"
    os.makedirs(clips)
    shutil.copy(os.path.join(os.path.dirname(port.__file__), "data",
                             "motions", "amp_humanoid_run.npy"), clips)
    assert ingest_motions.main(["--src", clips, "--dst",
                                tmp + "/motions"]) == 0
    assert callable(retarget_motion.main)
    r = eval_factory_lift.main(["random", "3", "sim_device=cpu",
                                "num_envs=4",
                                "task.rl.max_episode_length=4"])
    assert r["envs"] == 4 and 0.0 <= r["lift"] <= 1.0
    from isaacgymenvs_ma_tpu_torch.utils import observers, profiling, viewer
    from isaacgymenvs_ma_tpu_torch.utils.config import dump_yaml
    from isaacgymenvs_ma_tpu_torch.pbt import PbtAlgoObserver, mutate
    from isaacgymenvs_ma_tpu_torch.poselib import SkeletonState, SkeletonTree
    tb = observers.TensorboardObserver(tmp + "/summaries")
    tb.after_print_stats(1, {"frames": 16, "loss": 0.5})
    assert observers.read_scalars(tmp + "/summaries")["losses/loss"] == [
        (16, 0.5)]
    assert dump_yaml({"a": [1, 2.5, "x"]}).startswith("a: [1, 2.5")
    with profiling.trace(tmp + "/trace"):
        with profiling.annotate("step"):
            ctask.step(ctask.initial_state(), torch.zeros(16, 1))
    frame = viewer.FrameRecorder(ctask).capture(ctask.initial_state())
    assert frame.shape == (240, 320, 3)
    pbt = PbtAlgoObserver({"pbt": {"enabled": True, "workspace": tmp,
                                   "params": {}}}, ctcfg,
                          lambda p: ckpt.save_agent(p, dagent, ctask),
                          lambda p: ckpt.load_agent(p, dagent, ctask))
    pbt._save(16, 1.0)
    assert mutate({"gamma": 0.99}, {}, 1.0, 1.1, 1.5)["gamma"] != 0.99
    tree = SkeletonTree(["r", "a"], [-1, 0], [[0, 0, 0], [1, 0, 0]])
    assert SkeletonState.zero_pose(tree).global_translation.shape == (2, 3)
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
    # and their spec, the two hand tasks and their specs, Dextreme, ADR,
    # the RNA and the rl_games shim, the Factory and IndustReal tasks with
    # the voxelizer, the meshes, the grid sampler and the controllers, and
    # HumanoidAMP with its spec and motion library, AMP, SAC and HRL too,
    # and the data parallelism, PBT, poselib, observers, profiling and
    # viewer modules, the motion tools and the Factory evaluation
    n_mods = int(proc.stdout.split("MODULES")[1].split()[0])
    assert n_mods >= 97, proc.stdout


# the port's copies of numpy / plain-Python modules of the JAX package, and
# the functions and methods each changes on purpose (the others' code is
# the original's, docstrings aside)
_COPIES = {
    "pbt.mutation": (), "pbt.pbt": ("initial_pbt_check",
                                    "PbtParams.__init__",
                                    "PbtAlgoObserver.__init__",
                                    "PbtAlgoObserver._save",
                                    "PbtAlgoObserver.after_steps",
                                    "PbtAlgoObserver._restart"),
    "pbt.launcher": ("pbt_population",),
    "poselib.rotation": (), "poselib.skeleton": (),
    "utils.viewer": ("FrameRecorder.capture", "InteractiveViewer.render"),
    "utils.utils": (), "utils.reformat": (), "utils.wandb_utils": (),
    "utils.observers": ("TensorboardObserver.__init__",),
    "utils.profiling": ("trace", "annotate"),
}


def _defs(tree):
    """{name or Class.method: AST dump without docstrings} of a module."""
    import ast

    def strip(node):
        node = copy.deepcopy(node)
        for n in ast.walk(node):
            body = getattr(n, "body", None)
            if (isinstance(body, list) and body
                    and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                n.body = body[1:] or [ast.Pass()]
        return ast.dump(node)
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = strip(node)
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{m.name}"] = strip(m)
    return out


@pytest.mark.parametrize("mod", sorted(_COPIES))
def test_copies_hold_to_their_originals(mod):
    """Every function and method of the JAX module is in the port's copy,
    with the same code unless the copy changes it on purpose (the PBT
    restart into the port's train module, PBT's seeded draws, its wait
    for the population and its metas written whole, the viewer's poses
    read from the card, the hand-written event writer, torch.profiler)."""
    import ast
    src = {p: open(os.path.join(REPO, p, *mod.split(".")) + ".py").read()
           for p in ("isaacgymenvs_ma_tpu", "isaacgymenvs_ma_tpu_torch")}
    j = _defs(ast.parse(src["isaacgymenvs_ma_tpu"]))
    t = _defs(ast.parse(src["isaacgymenvs_ma_tpu_torch"]))
    assert set(j) <= set(t), sorted(set(j) - set(t))
    changed = sorted(k for k in j if j[k] != t[k])
    assert changed == sorted(_COPIES[mod]), changed
    assert "jax" not in {a.split(".")[0] for a in _imports(
        src["isaacgymenvs_ma_tpu_torch"])}


def _imports(src):
    import ast
    out = []
    for n in ast.walk(ast.parse(src)):
        if isinstance(n, ast.Import):
            out += [a.name for a in n.names]
        elif isinstance(n, ast.ImportFrom) and n.module and not n.level:
            out.append(n.module)
    return out
