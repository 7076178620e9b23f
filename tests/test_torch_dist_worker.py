"""Rank workers of tests/test_torch_dist.py (no tests here).

Each function runs in a process that ``spawn`` starts with
torch.multiprocessing, joins a gloo group on 127.0.0.1 and writes what it
computed to ``outdir/rank<r>.pt`` for the test to compare.  This module
imports torch and the port only, so the ranks load no JAX.
"""
import os

import torch

torch.set_num_threads(1)   # small CPU ops: one thread a rank


def spawn(fn, world: int, *args) -> None:
    """Run ``fn(rank, world, port, *args)`` on ``world`` spawned ranks and
    wait for them; a rank's exception fails the call."""
    import torch.multiprocessing as mp
    from isaacgymenvs_ma_tpu_torch.parallel.dryrun import free_port
    mp.start_processes(fn, args=(world, free_port()) + tuple(args),
                       nprocs=world, join=True, start_method="spawn")


def _join(rank, world, port):
    from isaacgymenvs_ma_tpu_torch.parallel.mesh import DataParallel
    return DataParallel.init(device="cpu", backend="gloo", environ={
        "RANK": str(rank), "WORLD_SIZE": str(world),
        "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(port)})


def _task(name, n, rank, world, seed):
    from isaacgymenvs_ma_tpu_torch.ops.rng import make_seed
    from isaacgymenvs_ma_tpu_torch.parallel.mesh import local_task_config
    from isaacgymenvs_ma_tpu_torch.tasks import registry
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    cfg = deep_merge(registry.task_default_config(name),
                     {"env": {"numEnvs": n}})
    return registry.create_task(name, local_task_config(cfg, rank, world),
                                seed=make_seed(seed, rank=rank),
                                device="cpu")


def epoch_rank(rank, world, port, inpath, outdir):
    """One PPO epoch of rank ``rank`` from a full-width learner state, with
    injected draws: ``inpath`` holds the task name, env count, seed, train
    config, the state (``slice_state``-able), the global action noise (T,
    B, A) and reset draws (each step's tuple of (N, ...) tensors), and
    each rank's local permutations."""
    import torch.distributed as dist
    from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
    from isaacgymenvs_ma_tpu_torch.parallel.mesh import (slice_state,
                                                         state_digest)
    inp = torch.load(inpath, weights_only=False)
    dp = _join(rank, world, port)
    n, seed = inp["n"], inp["seed"]
    task = _task(inp["task"], n, rank, world, seed)
    agent = PPOAgent(task, inp["train_cfg"], seed=seed + rank, dist=dp)
    agent.init()
    agent.load_state_dict(slice_state(inp["state"], rank, world, n,
                                      n * task.num_agents))
    nl, bl = task.num_envs, task.rl_games_batch
    noise = inp["noise"][:, rank * bl: (rank + 1) * bl]
    draws = [tuple(x[rank * nl: (rank + 1) * nl] for x in step)
             for step in inp["draws"]]
    roll, last_obs, stats = agent._rollout(noise, draws)
    adv, ret = agent._gae(roll, last_obs)
    m = agent._update(roll, adv, ret, inp["perms"][rank])
    m["episodes_done"] = stats["episodes_done"]
    torch.save({
        "roll": roll._asdict(), "adv": adv, "ret": ret,
        "metrics": {k: (v if isinstance(v, int) else float(v))
                    for k, v in m.items()},
        "net": dict(agent.net.state_dict()),
        "obs_rms": agent.obs_rms.state_dict(),
        "value_rms": agent.value_rms.state_dict(),
        "digest": state_digest(agent)},
        os.path.join(outdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def ckpt_rank(rank, world, port, outdir, mode, train_cfg):
    """Cartpole at 16 envs (global) on ``world`` ranks: ``mode`` "save"
    trains one epoch and writes ``outdir/ranks.pth`` through
    ``checkpoint.save_agent``; "load" loads ``outdir/one.pth``.  Each rank
    dumps its learner and local env state."""
    import torch.distributed as dist
    from isaacgymenvs_ma_tpu_torch.learning import checkpoint as ckpt
    from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
    from isaacgymenvs_ma_tpu_torch.parallel.mesh import state_digest
    dp = _join(rank, world, port)
    task = _task("Cartpole", 16, rank, world, 5)
    agent = PPOAgent(task, train_cfg, seed=5 + rank, dist=dp)
    agent.init()
    if mode == "save":
        agent.train_epoch()
        wrote = ckpt.save_agent(os.path.join(outdir, "ranks.pth"), agent,
                                task, dp, meta={"epoch": 1})
        assert wrote == (rank == 0)
    else:
        ckpt.load_agent(os.path.join(outdir, "one.pth"), agent, task, dp)
    sd = agent.state_dict()
    torch.save({"state": {k: sd[k] for k in (
        "env_state", "last_obs", "ep_return", "ep_length", "net", "optim",
        "obs_rms", "value_rms", "lr")}, "digest": state_digest(agent)},
        os.path.join(outdir, f"{mode}_rank{rank}.pt"))
    dist.destroy_process_group()
