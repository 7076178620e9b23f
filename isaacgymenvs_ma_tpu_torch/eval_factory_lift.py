"""Score a FactoryTaskNutBoltPick checkpoint of the port with the
reference's success rule (counterpart of scripts/eval_factory_lift.py)::

    python -m isaacgymenvs_ma_tpu_torch.eval_factory_lift <checkpoint|random> \\
        [seed] [sim_device=cpu] [num_envs=N] [task.<key>=<value> ...]

The reference scores lift success only after a scripted close-and-lift
epilogue on an episode's last step (factory_task_nut_bolt_pick.py:144-203:
``_close_gripper`` and ``_lift_gripper``, then ``_check_lift_success`` with
``height_multiple=3.0``).  The raw nut height without the epilogue asks
whether the policy lifted the nut unassisted, a harder statistic that the
keypoint reward (success_bonus 0.0) never asks for.

This rolls the deterministic policy through one whole episode from a
fresh reset and prints both side by side, with the health-net early-reset
count (tasks/base.py: an unhealthy env is reset at once) that cuts
episodes short.  The learner's parameters and normalisers come from the
checkpoint (learning/checkpoint.py; its env state is not used, so the
evaluation may run at another env count); ``random`` scores a fresh,
untrained policy.  It runs on ``cuda:0`` unless ``sim_device=`` names
another device (``sim_device=cpu`` on a machine without a card).
"""
from __future__ import annotations

import sys

TASK = "FactoryTaskNutBoltPick"


def evaluate(task, agent, env_state=None, reset_draws=None) -> dict:
    """One deterministic episode of ``agent``'s policy from a fresh reset
    of ``env_state`` (the task's initial state by default): the envs that
    ran the whole episode, the early resets, and the shares of those envs
    that lifted the nut unassisted (``raw``) and after the close-and-lift
    epilogue (``lift``); ``lift_all`` over every env.  ``reset_draws``,
    one entry a step, hands each step its reset draws (drawn from the
    task's generator where missing); ``state`` is the episode's last env
    state, ``nut_z`` and ``lifted`` each env's final nut height and
    epilogue outcome."""
    import torch

    from .device import DTYPE
    from .tasks.factory import NUT_HEIGHT, TABLE_HEIGHT
    draws = iter(reset_draws or ())

    def step(env_state, obs):
        return task.step(env_state, agent.act(obs),
                         reset_draws=next(draws, None))
    env_state, obs = task.reset(task.initial_state() if env_state is None
                                else env_state)
    horizon = task.max_episode_length
    env_state, res = step(env_state, obs)  # the first reset
    obs = res.obs
    early = torch.zeros(task.num_envs, dtype=torch.int32,
                        device=task.device)
    for t in range(horizon - 1):
        env_state, res = step(env_state, obs)
        obs = res.obs
        if t < horizon - 2:
            early = early + res.reset.to(torch.int32)
    in_phase = env_state.progress >= horizon - 1   # ran the whole episode
    nut_z = task.engine.forward(env_state.sim).root_states[:, 2, 2]
    raw = (nut_z > TABLE_HEIGHT + NUT_HEIGHT * 3.0).to(DTYPE)
    lifted = task.evaluate_lift(env_state)
    sel = in_phase.to(DTYPE)
    denom = torch.clamp(sel.sum(), min=1.0)
    return {"envs": task.num_envs, "full_episode": int(in_phase.sum()),
            "early_resets": int(early.sum()),
            "raw": float((raw * sel).sum() / denom),
            "lift": float((lifted * sel).sum() / denom),
            "lift_all": float(lifted.mean()),
            "state": env_state, "nut_z": nut_z, "lifted": lifted}


def main(argv=None) -> dict:
    from .learning import checkpoint as ckpt
    from .learning.ppo import PPOAgent
    from .parallel.mesh import PER_ENV_KEYS
    from .tasks import registry
    from .utils.config import (GLOBAL_DEFAULTS, apply_overrides,
                               load_task_config, load_train_config)
    argv = list(sys.argv[1:] if argv is None else argv)
    pos = [a for a in argv if "=" not in a]
    if not pos:
        sys.exit("usage: python -m isaacgymenvs_ma_tpu_torch."
                 "eval_factory_lift <checkpoint|random> [seed] "
                 "[sim_device=cpu] [num_envs=N] [task.<key>=<value> ...]")
    path = pos[0]
    seed = int(pos[1]) if len(pos) > 1 else 123
    keyed = [a for a in argv if "=" in a]
    cfg = apply_overrides(dict(GLOBAL_DEFAULTS),
                          [a for a in keyed if not a.startswith("task.")])
    task_ov = [a.split(".", 1)[1] for a in keyed if a.startswith("task.")]
    if cfg.get("num_envs"):
        task_ov = [f"env.numEnvs={cfg['num_envs']}"] + task_ov
    task_cfg = load_task_config(TASK, task_ov)
    task = registry.create_task(TASK, task_cfg, seed=seed,
                                device=str(cfg.get("sim_device", "cuda:0")))
    train_cfg = load_train_config(TASK, [])
    c = train_cfg["params"]["config"]
    # no update runs here: one minibatch of any env count's rollout
    c["minibatch_size"] = task.num_envs * int(c["horizon_length"])
    agent = PPOAgent(task, train_cfg, seed=seed)
    agent.init()
    if path != "random":
        state, _, meta = ckpt.load_checkpoint(path)
        # the learner alone: the episode's env state and draws are fresh
        skip = PER_ENV_KEYS + ("generator", "task_generator")
        agent.load_state_dict({k: v for k, v in state.items()
                               if k not in skip})
        print(f"restored {path} (meta {meta})")
    else:
        print("scoring an untrained policy (baseline / sim-health probe)")
    r = evaluate(task, agent)
    print(f"envs: {r['envs']}  full-episode (never force-reset): "
          f"{r['full_episode']}  early resets total: {r['early_resets']}")
    print(f"raw lift success (no epilogue): {r['raw']:.3f}")
    print(f"close-and-lift epilogue success (the reference's metric, "
          f"_check_lift_success height_multiple=3.0): {r['lift']:.3f}")
    print(f"epilogue success over all envs (incl. mid-episode restarts): "
          f"{r['lift_all']:.3f}")
    return r


if __name__ == "__main__":
    main()
