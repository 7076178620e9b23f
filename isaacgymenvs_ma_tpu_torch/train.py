"""CLI entry point of the port (counterpart of isaacgymenvs_ma_tpu/train.py,
reference train.py)::

    python -m isaacgymenvs_ma_tpu_torch.train task=Ant num_envs=4096 \\
        train.params.config.max_epochs=500 ...

Hydra-grammar dotted overrides on the same config surfaces as the JAX
package: global flags (``task=``, ``num_envs=``, ``max_iterations=``,
``seed=``, ``checkpoint=``, ``sigma=``, ``test=``, ``train=``,
``sim_device=``, ``multi_gpu=``, ``pbt.*``, ``capture_video*``,
``wandb_*``, ``headless=``), ``task.*`` and ``train.*``.  The task and the
learner run on ``sim_device`` (``cuda:0`` unless the caller asks for the
CPU); ``rl_device`` is accepted for CLI parity.  ``test=True
checkpoint=...`` runs the player path (with ``headless=False`` in the
viewer window).  The train config's algo picks the learner, as in the JAX
entry point: ``amp_continuous`` the AMP learner, ``sac`` SAC, the PPO
algos PPO.

* ``multi_gpu=True``: one process a rank under torchrun (``python -m
  torch.distributed.run --nproc_per_node=W -m isaacgymenvs_ma_tpu_torch.
  train ... multi_gpu=True``), the envs split over the ranks as one
  program sharded over the env axis, for every learner
  (parallel/mesh.py); ``sim_device`` defaults to ``cuda:{LOCAL_RANK}``
  there and ``dist_backend=nccl|gloo`` overrides the backend.  Rank 0 alone prints, writes the snapshot, the
  summaries, the videos and the checkpoints.
* The run directory ``runs/<experiment>_<time>/`` holds ``config.yaml``
  (the global, task and train configs), ``summaries/`` (TensorBoard event
  files, utils/observers.py), ``nn/<experiment>.pth`` and, with
  ``capture_video``, ``videos/step_<env steps>/frame_*.png`` (or .mp4 /
  .gif where imageio is installed) from a side rollout every
  ``capture_video_freq`` env steps.
* ``pbt.enabled``: the first launch mutates its hyperparameters and
  restarts (``pbt.initial_pbt_check``); ``PbtAlgoObserver`` saves a
  checkpoint with its json meta into the workspace each interval and
  replaces a lagging member by a better one's (pbt/pbt.py).
* ``wandb_activate``: ``WandbObserver``; without wandb installed it warns
  and the run goes on.
"""
from __future__ import annotations

import math
import os
import sys
import time
from datetime import datetime


def _split_overrides(argv):
    global_ov, task_ov, train_ov = [], [], []
    for a in argv:
        if "=" not in a:
            continue
        key = a.lstrip("+")
        if key.startswith("task."):
            task_ov.append(a.split(".", 1)[1])
        elif key.startswith("train."):
            train_ov.append(a.split(".", 1)[1])
        else:
            global_ov.append(a)
    return global_ov, task_ov, train_ov


# diagnostics of the epoch line: (metric key, label), as the JAX loop
# prints them (JAX train.py:212-224)
_LINE_EXTRAS = (("episode/episode/coverage", "cov"),
                ("episode/episode/rot_dist", "rot"),
                ("episode/episode/terrain_level", "lvl"),
                ("episode/episode/lvl_slope", "slp"),
                ("episode/episode/lvl_rough", "rgh"),
                ("episode/episode/lvl_stairs", "str"),
                ("episode/episode/lvl_discrete", "dsc"),
                ("episode/episode/lvl_stones", "stn"),
                ("episode/adr_npd", "npd"),
                ("episode/engagement_depth", "dep"),
                ("episode/curr_max_disp", "disp"),
                ("episode/episode/fsm_mean", "fsm"),
                ("sigma", "sig"))


def epoch_line(ep: int, max_epochs: int, m: dict, fps: float) -> str:
    """The JAX loop's log line from host metrics ``m``; SAC's (no KL or
    episode length) with its losses and temperature."""
    if "critic_loss" in m:
        return (f"epoch {ep}/{max_epochs} reward {m['mean_return']:.2f} "
                f"critic {m['critic_loss']:.4f} actor {m['actor_loss']:.4f} "
                f"alpha {m['alpha']:.4f} fps {fps:,.0f}")
    succ = ""
    for sk in ("episode/consecutive_successes", "episode/successes"):
        if sk in m:
            succ = f" succ {m[sk]:.2f}"
            break
    for sk, lbl in _LINE_EXTRAS:
        if m.get(sk) is not None:
            succ += f" {lbl} {m[sk]:.2f}"
    return (f"epoch {ep}/{max_epochs} reward {m['mean_return']:.2f} "
            f"len {m['mean_length']:.0f} kl {m['kl']:.4f}{succ} "
            f"fps {fps:,.0f}")


def launch(argv=None):
    from .learning import checkpoint as ckpt
    from .learning.amp import AMPAgent
    from .learning.ppo import PPOAgent
    from .learning.sac import SACAgent
    from .ops.rng import make_seed
    from .parallel import mesh
    from .tasks import registry
    from .utils.config import (GLOBAL_DEFAULTS, apply_overrides,
                               load_task_config, load_train_config,
                               resolve_default, write_config_snapshot)
    from .utils.observers import (MultiObserver, TensorboardObserver,
                                  WandbObserver)

    argv = list(sys.argv[1:] if argv is None else argv)
    global_ov, task_ov, train_ov = _split_overrides(argv)
    cfg = apply_overrides(dict(GLOBAL_DEFAULTS), global_ov)

    task_name = cfg.get("task", cfg.get("task_name", "Cartpole"))
    if isinstance(task_name, dict):
        task_name = task_name.get("name", "Cartpole")
    if cfg.get("num_envs"):
        task_ov = [f"env.numEnvs={cfg['num_envs']}"] + task_ov
    task_cfg = load_task_config(task_name, task_ov)
    # train=<Name> selects a named train config (``train: ${task}PPO``)
    train_name = cfg.get("train")
    if not isinstance(train_name, str) or not train_name:
        train_name = task_name
    train_cfg = load_train_config(train_name, train_ov)
    if cfg.get("max_iterations"):
        train_cfg["params"]["config"]["max_epochs"] = int(cfg["max_iterations"])
    algo = train_cfg["params"]["algo"]["name"]

    # multi-process data parallelism (reference README:165-172,
    # rlgames_utils.py:89-107): rank and world from torchrun; the split of
    # the envs and the learner's batches is checked before the process
    # group is joined
    dp, rank, world = None, 0, 1
    named_device = any(a.lstrip("+").split("=", 1)[0] == "sim_device"
                       for a in global_ov)
    device = str(cfg.get("sim_device", "cuda:0"))
    if cfg.get("multi_gpu"):
        env = mesh.dist_env()
        rank, world = env.rank, env.world
        c, n = train_cfg["params"]["config"], int(task_cfg["env"]["numEnvs"])
        if algo == "sac":
            mesh.check_batch("numEnvs", n, world)
            mesh.check_batch("batch_size", int(c.get("batch_size", 4096)),
                             world)
        else:
            mesh.check_split(n, int(c.get("minibatch_size", 8192)), world)
        if algo == "amp_continuous":
            mesh.check_batch("amp_batch_size",
                             int(c.get("amp_batch_size", 512)), world)
        if not named_device:
            device = f"cuda:{env.local_rank}"
        dp = mesh.DataParallel.init(device=device,
                                    backend=cfg.get("dist_backend") or None)
        print(f"torch.distributed: rank {rank}/{world} backend {dp.backend} "
              f"device {device}", flush=True)
    lead = rank == 0

    # PBT: first-launch mutation restart (reference train.py:88-89)
    if (cfg.get("pbt") or {}).get("enabled"):
        from .pbt import initial_pbt_check
        initial_pbt_check(cfg)

    seed = make_seed(int(cfg.get("seed", 42)), rank=rank,
                     deterministic=bool(cfg.get("torch_deterministic", False)))
    if lead:
        print(f"task: {task_name}  envs: {task_cfg['env']['numEnvs']}  "
              f"seed: {seed}  device: {device}  ranks: {world}")
    local_cfg = (task_cfg if world == 1
                 else mesh.local_task_config(task_cfg, rank, world))
    task = registry.create_task(task_name, local_cfg, seed=seed,
                                headless=bool(cfg.get("headless", True)),
                                device=device)
    # a2c_continuous and a2c_continuous_MA share the core; MA episode
    # striding is driven by the env's num_agents (A2CAgent_MA.py:44-47)
    learner = {"amp_continuous": AMPAgent, "sac": SACAgent}.get(algo,
                                                                PPOAgent)
    agent = learner(task, train_cfg, seed=seed, dist=dp)

    exp_name = resolve_default(
        train_cfg["params"]["config"].get("name", task_name),
        cfg.get("experiment"))
    run_dir = [os.path.join("runs",
                            f"{exp_name}_{datetime.now():%d-%H-%M-%S}")]
    if dp is not None:
        # every rank uses rank 0's run directory
        import torch.distributed as tdist
        tdist.broadcast_object_list(run_dir, src=0, group=dp.host_group)
    run_dir = run_dir[0]
    nn_dir = os.path.join(run_dir, "nn")

    # per-run config snapshot (reference train.py:204-210) and the
    # observers, on rank 0
    observers = []
    if lead:
        write_config_snapshot(os.path.join(run_dir, "config.yaml"), {
            "global": cfg, "task": task_cfg, "train": train_cfg})
        observers.append(TensorboardObserver(os.path.join(run_dir,
                                                          "summaries")))
        if cfg.get("wandb_activate"):
            observers.append(WandbObserver(
                project=cfg.get("wandb_project", "isaacgymenvs_ma_tpu"),
                group=cfg.get("wandb_group", ""),
                name=cfg.get("wandb_name", exp_name),
                entity=cfg.get("wandb_entity", ""),
                tags=cfg.get("wandb_tags", [])))
    observer = MultiObserver(*observers)

    agent.init()
    if cfg.get("checkpoint"):
        _, meta = ckpt.load_agent(cfg["checkpoint"], agent, task, dp)
        if lead:
            print(f"restored checkpoint {cfg['checkpoint']} (meta {meta})")
        if cfg.get("sigma") not in ("", None):
            # fixed exploration sigma at restore (reference train.py:212-216)
            if not getattr(getattr(agent, "net", None), "fixed_sigma",
                           False):
                raise ValueError("sigma= needs a fixed-sigma network")
            agent.net.log_sigma.data.fill_(math.log(float(cfg["sigma"])))
            if lead:
                print(f"sigma overridden to {float(cfg['sigma'])}")

    pbt_observer = None
    if (cfg.get("pbt") or {}).get("enabled"):
        from .pbt import PbtAlgoObserver
        pbt_observer = PbtAlgoObserver(
            cfg, train_cfg,
            lambda path: ckpt.save_agent(path, agent, task, dp),
            lambda path: ckpt.load_agent(path, agent, task, dp))

    if cfg.get("test"):
        return _play(task, agent, cfg, run_dir=run_dir)

    # periodic policy videos (reference capture_video / RecordVideo wrapper,
    # train.py:138-145): frames of env 0 from short side rollouts every
    # capture_video_freq per-env steps, on rank 0
    video = None
    if cfg.get("capture_video") and lead:
        video = [int(cfg.get("capture_video_freq", 1464)),
                 int(cfg.get("capture_video_len", 100)), 0]

    pcfg = agent.cfg
    save_freq = pcfg.save_frequency
    max_epochs = pcfg.max_epochs
    log_interval = int(cfg.get("log_interval", 20) or 20)
    ckpt_path = os.path.join(nn_dir, f"{exp_name}.pth")
    agent.epoch_seconds = []
    t0 = t_ep = time.time()
    for ep in range(1, max_epochs + 1):
        metrics = agent.train_epoch()
        if video is not None:
            freq, vlen, last = video
            env_steps = int(metrics["frames"]) // max(
                task.num_envs * world, 1)
            if env_steps // freq > last:
                video[2] = env_steps // freq
                p = capture_rollout(task, agent, vlen, os.path.join(
                    run_dir, "videos", f"step_{env_steps}.mp4"))
                print(f"captured video {p}")
        if pbt_observer is not None:
            m_host = {k: float(v) for k, v in metrics.items()}
            pbt_observer.after_steps(ep, int(m_host["frames"]), m_host)
        if ep % log_interval == 0 or ep == max_epochs:
            m = {k: float(v) for k, v in metrics.items()}
            agent.metrics = m
            now = time.time()
            agent.epoch_seconds.append(now - t_ep)
            t_ep = now
            fps = m["frames"] / max(now - t0, 1e-9)
            if lead:
                print(epoch_line(ep, max_epochs, m, fps), flush=True)
            observer.after_print_stats(ep, m)
            if m["mean_return"] >= pcfg.score_to_win:
                if lead:
                    print("score_to_win reached")
                break
        if save_freq and ep % save_freq == 0:
            ckpt.save_agent(ckpt_path, agent, task, dp, meta={"epoch": ep})
    if ckpt.save_agent(ckpt_path, agent, task, dp,
                       meta={"epoch": max_epochs}):
        print(f"saved {ckpt_path}")
    if pbt_observer is not None:
        pbt_observer.finish()
    agent.run_dir = run_dir
    return agent


def capture_rollout(task, agent, n_steps: int, out_path: str):
    """A deterministic side rollout of ``n_steps`` from the agent's env
    state, env 0's frames saved as a video (PNG frames where imageio is
    missing); the task's generator is put back, so training goes on as
    without it.  Returns the artifact's path."""
    from .utils.viewer import FrameRecorder
    rec = FrameRecorder(task)
    gen_state = task.generator.get_state()
    env_state, obs = agent.env_state, agent.last_obs
    for _ in range(n_steps):
        rec.capture(env_state)
        env_state, res = task.step(env_state,
                                   agent.act(obs, deterministic=True))
        obs = res.obs
    task.generator.set_state(gen_state)
    return rec.save_video(out_path)


# steps of the player loop, as in the JAX package
PLAY_STEPS = 2000


def _play(task, agent, cfg=None, run_dir="runs"):
    """Inference loop (rl_games player path — reference train.py:212-217 with
    {'play': True}; learning/common_player.py:54-152); ``capture_video``
    records its first ``capture_video_len`` steps, ``headless=False``
    draws them in the viewer window (ESC quits, V toggles sync, R
    records)."""
    cfg = cfg or {}
    env_state, obs = agent.env_state, agent.last_obs
    rec = vlen = None
    if cfg.get("capture_video"):
        from .utils.viewer import FrameRecorder
        rec = FrameRecorder(task)
        vlen = int(cfg.get("capture_video_len", 100))
    viewer = None
    if not cfg.get("headless", True):
        from .utils.viewer import InteractiveViewer
        viewer = InteractiveViewer(task)
    total_rew = 0.0
    games = 0
    for i in range(PLAY_STEPS):
        if rec is not None and i < vlen:
            rec.capture(env_state)
        if viewer is not None:
            if not viewer.open:
                break
            viewer.render(env_state)
        actions = agent.act(obs, deterministic=True)
        env_state, res = task.step(env_state, actions)
        obs = res.obs
        total_rew += float(res.rew.mean())
        games += int(res.reset.sum())
        if (i + 1) % 200 == 0:
            print(f"step {i+1}: mean step reward {total_rew/(i+1):.3f}, "
                  f"episodes finished {games}")
    if rec is not None:
        p = rec.save_video(os.path.join(run_dir, "videos", "play.mp4"))
        print(f"captured video {p}")
    return agent


if __name__ == "__main__":
    launch()
