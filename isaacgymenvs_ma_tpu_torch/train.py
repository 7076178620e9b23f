"""CLI entry point of the port (counterpart of isaacgymenvs_ma_tpu/train.py,
reference train.py)::

    python -m isaacgymenvs_ma_tpu_torch.train task=Ant num_envs=4096 \\
        train.params.config.max_epochs=500 ...

Hydra-grammar dotted overrides on the same config surfaces as the JAX
package: global flags (``task=``, ``num_envs=``, ``max_iterations=``,
``seed=``, ``checkpoint=``, ``sigma=``, ``test=``, ``train=``,
``sim_device=``), ``task.*`` and ``train.*``.  The task and the learner
run on ``sim_device`` (``cuda:0`` unless the caller asks for the CPU);
``rl_device`` is accepted for CLI parity.  ``test=True checkpoint=...``
runs the player path.  The train config's algo picks the learner, as in
the JAX entry point: ``amp_continuous`` the AMP learner, ``sac`` SAC, the
PPO algos PPO.

Not ported, each raising ``NotImplementedError`` when its flag is set
(ROADMAP queue A, item 11): ``multi_gpu``, ``pbt.enabled``,
``capture_video``, ``wandb_activate`` and the viewer (``headless=False``).
The TensorBoard summaries and the ``config.yaml`` snapshot are not written
(the card's machine has neither tensorboard nor PyYAML); the run says so.
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


def _unported_flags(cfg: dict) -> None:
    for flag, on in (("multi_gpu", cfg.get("multi_gpu")),
                     ("pbt.enabled", (cfg.get("pbt") or {}).get("enabled")),
                     ("capture_video", cfg.get("capture_video")),
                     ("wandb_activate", cfg.get("wandb_activate")),
                     ("headless=False (the viewer)",
                      not cfg.get("headless", True))):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet: ROADMAP queue A, item 11")


# diagnostics of the epoch line that the ported tasks report: (metric key,
# label); the JAX loop also prints its other tasks' keys
_LINE_EXTRAS = (("episode/episode/coverage", "cov"),
                ("episode/episode/fsm_mean", "fsm"), ("sigma", "sig"))


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
    from .tasks import registry
    from .utils.config import (GLOBAL_DEFAULTS, apply_overrides,
                               load_task_config, load_train_config,
                               resolve_default)

    argv = list(sys.argv[1:] if argv is None else argv)
    global_ov, task_ov, train_ov = _split_overrides(argv)
    cfg = apply_overrides(dict(GLOBAL_DEFAULTS), global_ov)
    _unported_flags(cfg)

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

    seed = make_seed(int(cfg.get("seed", 42)),
                     deterministic=bool(cfg.get("torch_deterministic", False)))
    device = str(cfg.get("sim_device", "cuda:0"))
    print(f"task: {task_name}  envs: {task_cfg['env']['numEnvs']}  seed: {seed}  "
          f"device: {device}")
    task = registry.create_task(task_name, task_cfg, seed=seed,
                                headless=bool(cfg.get("headless", True)),
                                device=device)
    algo = train_cfg["params"]["algo"]["name"]
    # a2c_continuous and a2c_continuous_MA share the core; MA episode
    # striding is driven by the env's num_agents (A2CAgent_MA.py:44-47)
    agent = {"amp_continuous": AMPAgent, "sac": SACAgent}.get(
        algo, PPOAgent)(task, train_cfg, seed=seed)

    exp_name = resolve_default(
        train_cfg["params"]["config"].get("name", task_name),
        cfg.get("experiment"))
    run_dir = os.path.join("runs", f"{exp_name}_{datetime.now():%d-%H-%M-%S}")
    nn_dir = os.path.join(run_dir, "nn")
    print(f"run dir {run_dir}: no config.yaml snapshot and no TensorBoard "
          "summaries (not ported: ROADMAP queue A, item 11)")

    agent.init()
    if cfg.get("checkpoint"):
        state, env_extra, meta = ckpt.load_checkpoint(cfg["checkpoint"])
        agent.load_state_dict(state)
        agent.env_state = task.set_env_state(agent.env_state, env_extra)
        print(f"restored checkpoint {cfg['checkpoint']} (meta {meta})")
        if cfg.get("sigma") not in ("", None):
            # fixed exploration sigma at restore (reference train.py:212-216)
            if not getattr(getattr(agent, "net", None), "fixed_sigma",
                           False):
                raise ValueError("sigma= needs a fixed-sigma network")
            agent.net.log_sigma.data.fill_(math.log(float(cfg["sigma"])))
            print(f"sigma overridden to {float(cfg['sigma'])}")

    if cfg.get("test"):
        return _play(task, agent)

    pcfg = agent.cfg
    save_freq = pcfg.save_frequency
    max_epochs = pcfg.max_epochs
    ckpt_path = os.path.join(nn_dir, f"{exp_name}.pth")
    t0 = time.time()
    for ep in range(1, max_epochs + 1):
        metrics = agent.train_epoch()
        if ep % int(cfg.get("log_interval", 20) or 20) == 0 or ep == max_epochs:
            m = {k: float(v) for k, v in metrics.items()}
            fps = m["frames"] / max(time.time() - t0, 1e-9)
            print(epoch_line(ep, max_epochs, m, fps), flush=True)
            if m["mean_return"] >= pcfg.score_to_win:
                print("score_to_win reached")
                break
        if save_freq and ep % save_freq == 0:
            ckpt.save_checkpoint(
                ckpt_path, agent.state_dict(),
                env_state_extra=task.get_env_state(agent.env_state),
                meta={"epoch": ep})
    ckpt.save_checkpoint(ckpt_path, agent.state_dict(),
                         env_state_extra=task.get_env_state(agent.env_state),
                         meta={"epoch": max_epochs})
    print(f"saved {ckpt_path}")
    return agent


# steps of the player loop, as in the JAX package
PLAY_STEPS = 2000


def _play(task, agent):
    """Inference loop (rl_games player path — reference train.py:212-217 with
    {'play': True}; learning/common_player.py:54-152)."""
    env_state, obs = agent.env_state, agent.last_obs
    total_rew = 0.0
    games = 0
    for i in range(PLAY_STEPS):
        actions = agent.act(obs, deterministic=True)
        env_state, res = task.step(env_state, actions)
        obs = res.obs
        total_rew += float(res.rew.mean())
        games += int(res.reset.sum())
        if (i + 1) % 200 == 0:
            print(f"step {i+1}: mean step reward {total_rew/(i+1):.3f}, "
                  f"episodes finished {games}")
    return agent


if __name__ == "__main__":
    launch()
