"""Multi-process dry run (counterpart of the JAX package's
``dryrun_multichip``, __graft_entry__.py:33-82).

``dryrun_multiproc(n)`` spawns ``n`` ranks on ``127.0.0.1`` (gloo unless
``backend`` names NCCL) and runs one full PPO epoch (rollout, GAE,
minibatch SGD) of three legs over them, each at the JAX dry run's tiny
shapes (``numEnvs = max(2n, 8)``, horizon 8, two minibatches):

* Ant — the flagship single-agent layout (N rows),
* FrankaReachMA — the MA fork's agent-folded layout (N * K actor rows,
  the envs split over the ranks with their agents),
* ShadowHand with ``ShadowHandPPOAsymm`` and ``asymmetric_observations``
  — the central-value critic's (N, num_states) stream beside the obs.

Each leg checks that the loss is finite and that every rank ends with the
same parameter and Adam-state digest (``mesh.state_digest``).  Returns the
legs' results as rank 0 saw them.
"""
from __future__ import annotations

import socket

LEGS = (("Ant", None, None),
        ("FrankaReachMA", None, None),
        ("ShadowHand", "ShadowHandPPOAsymm",
         {"asymmetric_observations": True, "observationType": "openai"}))


def free_port() -> int:
    """A free TCP port on 127.0.0.1."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _leg(dp, task_name, train_name, env_overrides, n_ranks, device):
    import math

    import torch.distributed as dist

    from ..learning.configs import train_default_config
    from ..learning.ppo import PPOAgent
    from ..ops.rng import make_seed
    from ..tasks import registry
    from ..utils.config import deep_merge
    from .mesh import local_task_config, state_digest

    num_envs = max(2 * n_ranks, 8)
    horizon = 8
    cfg = deep_merge(registry.task_default_config(task_name),
                     {"env": dict({"numEnvs": num_envs},
                                  **(env_overrides or {}))})
    seed = make_seed(0, rank=dp.rank)
    task = registry.create_task(
        task_name, local_task_config(cfg, dp.rank, dp.world), seed=seed,
        device=device)
    tcfg = train_default_config(train_name or task_name)
    mb = task.rl_games_batch * dp.world * horizon // 2
    tcfg["params"]["config"]["horizon_length"] = horizon
    tcfg["params"]["config"]["minibatch_size"] = mb
    cvc = tcfg["params"]["config"].get("central_value_config")
    if cvc:
        cvc["minibatch_size"] = mb
    agent = PPOAgent(task, tcfg, seed=seed, dist=dp)
    agent.init()
    m = agent.train_epoch()
    loss, kl = float(m["loss"]), float(m["kl"])
    if not math.isfinite(loss):
        raise RuntimeError(f"{task_name}: non-finite loss {loss}")
    digests = [None] * dp.world
    dist.all_gather_object(digests, state_digest(agent), group=dp.host_group)
    if len(set(digests)) != 1:
        raise RuntimeError(f"{task_name}: the ranks' learners differ "
                           f"{digests}")
    return {"task": task_name, "loss": loss, "kl": kl, "digest": digests[0],
            "envs": num_envs, "ranks": dp.world}


def _worker(rank, n_ranks, port, device, backend, queue):
    import torch
    torch.set_num_threads(1)
    from .mesh import DataParallel
    env = {"RANK": str(rank), "WORLD_SIZE": str(n_ranks),
           "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    dp = DataParallel.init(device=device, backend=backend, environ=env)
    try:
        out = [_leg(dp, t, tr, ov, n_ranks, device) for t, tr, ov in LEGS]
        if rank == 0:
            queue.put(out)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multiproc(n_ranks: int, device: str = "cpu",
                     backend: str = "gloo"):
    """The three legs over ``n_ranks`` spawned processes; returns rank 0's
    results and prints a line a leg."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    mp.start_processes(_worker, args=(n_ranks, free_port(), device, backend,
                                      queue),
                       nprocs=n_ranks, join=True, start_method="spawn")
    out = queue.get()
    for r in out:
        print(f"dryrun_multiproc({n_ranks}) {r['task']}: ok — loss "
              f"{r['loss']:.4f}, kl {r['kl']:.5f}, digest "
              f"{r['digest'][:12]} on every rank")
    return out
