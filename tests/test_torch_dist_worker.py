"""Rank workers of tests/test_torch_dist.py and tests/test_torch_dist_sac.py
/ _amp.py (no tests here), and the toy SAC task they share with
tests/test_torch_sac.py.

Each rank function runs in a process that ``spawn`` starts with
torch.multiprocessing, joins a gloo group on 127.0.0.1 and writes what it
computed to ``outdir`` for the test to compare.  This module imports torch,
numpy and the port only, so the ranks load no JAX.
"""
import copy
import os

import numpy as np
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


# ---------------------------------------------------------------- SAC
# the toy point-mass task of tests/test_torch_sac.py: 16 envs, obs 4, act
# 2, episodes of 3-6 steps, every other env's end a time-out
TOY_ENVS, TOY_OBS, TOY_ACT = 16, 4, 2
TOY_TARGETS = np.random.default_rng(0).normal(
    size=(TOY_ENVS, 2)).astype(np.float32)
TOY_EP_LEN = 3 + np.arange(TOY_ENVS) % 4
TOY_TIMEOUT = np.arange(TOY_ENVS) % 2 == 0


class ToyTask:
    """Point mass toward a target: pos += 0.1 act, reward -|target - pos|;
    obs (pos, target - pos); reset at each env's episode length.  Envs
    ``[offset, offset + n)`` of the 16 (a rank's share)."""
    num_obs, num_actions, num_states, num_agents = TOY_OBS, TOY_ACT, 0, 1
    max_episode_length = 6
    dict_obs_cls = False
    randomizer = None
    device = torch.device("cpu")

    def __init__(self, offset: int = 0, n: int = TOY_ENVS):
        self.num_envs = self.rl_games_batch = n
        sl = slice(offset, offset + n)
        self.targets = torch.as_tensor(TOY_TARGETS[sl])
        self.ep_len = torch.as_tensor(TOY_EP_LEN[sl])
        self.timeout = torch.as_tensor(TOY_TIMEOUT[sl])
        self.generator = torch.Generator()

    def initial_state(self):
        n = self.num_envs
        return (torch.zeros((n, 2)), torch.zeros(n, dtype=torch.int32))

    def reset(self, st):
        return st, torch.zeros((self.num_envs, TOY_OBS))

    def step(self, st, act, reset_draws=None):
        from isaacgymenvs_ma_tpu_torch.tasks.base import StepResult
        pos, t = st
        pos, t = pos + 0.1 * act, t + 1
        obs = torch.cat([pos, self.targets - pos], -1)
        rew = -torch.linalg.vector_norm(self.targets - pos, dim=-1)
        done = t >= self.ep_len
        st = (torch.where(done[:, None], 0.0, pos), torch.where(done, 0, t))
        return st, StepResult(obs=obs, states=None, rew=rew,
                              reset=done.to(torch.int32),
                              extras={"time_outs": done & self.timeout})


def sac_epoch_rank(rank, world, port, inpath, outdir):
    """One SAC epoch of the toy task on rank ``rank`` (envs ``[r n, (r+1)
    n)``) from a full-width learner state: ``inpath`` holds the train
    config, seed, the state (``slice_state``-able), the env state and the
    epoch's draws (each step's global actions, sliced here, and its global
    replay indices and noise)."""
    import torch.distributed as dist
    from isaacgymenvs_ma_tpu_torch.learning import sac as psac
    from isaacgymenvs_ma_tpu_torch.parallel.mesh import (slice_state,
                                                         state_digest)
    # the toy's env state is a (pos, t) tuple, not an EnvState
    psac.env_state_arrays = lambda st: {"pos": st[0], "t": st[1]}
    inp = torch.load(inpath, weights_only=False)
    dp = _join(rank, world, port)
    n = TOY_ENVS // world
    sl = slice(rank * n, (rank + 1) * n)
    agent = psac.SACAgent(ToyTask(rank * n, n), inp["train_cfg"],
                          seed=inp["seed"] + rank, dist=dp)
    agent.init()
    agent.load_state_dict(slice_state(inp["state"], rank, world, TOY_ENVS,
                                      TOY_ENVS))
    agent.env_state = tuple(x[sl] for x in inp["env_state"])
    draws = [{k: (v[sl] if k == "act" else v) for k, v in d.items()}
             for d in inp["draws"]]
    m = agent.train_epoch(draws)
    torch.save({"state": agent.state_dict(), "step": agent.step,
                "metrics": {k: float(v) for k, v in m.items()},
                "digest": state_digest(agent)},
               os.path.join(outdir, f"sac_rank{rank}.pt"))
    dist.destroy_process_group()


def sac_ckpt_rank(rank, world, port, outdir, mode, train_cfg):
    """AntSAC at 8 envs (global) on ``world`` ranks: ``mode`` "save" runs
    one epoch and writes ``outdir/sac_ranks.pth``; "load" loads
    ``outdir/sac_one.pth`` and runs one more epoch.  Each rank dumps its
    learner state (after the load, and after the epoch) and digest."""
    import torch.distributed as dist
    from isaacgymenvs_ma_tpu_torch.learning import checkpoint as ckpt
    from isaacgymenvs_ma_tpu_torch.learning.sac import SACAgent
    from isaacgymenvs_ma_tpu_torch.parallel.mesh import state_digest
    dp = _join(rank, world, port)
    task = _task("AntSAC", 8, rank, world, 5)
    agent = SACAgent(task, train_cfg, seed=5 + rank, dist=dp)
    agent.init()
    out = {}
    if mode == "save":
        agent.train_epoch()
        wrote = ckpt.save_agent(os.path.join(outdir, "sac_ranks.pth"),
                                agent, task, dp, meta={"epoch": 1})
        assert wrote == (rank == 0)
    else:
        ckpt.load_agent(os.path.join(outdir, "sac_one.pth"), agent, task,
                        dp)
        out["loaded"] = copy.deepcopy(agent.state_dict())
        agent.train_epoch()
    out.update(state=agent.state_dict(), digest=state_digest(agent),
               buf_n=agent.buf_n, step=agent.step)
    torch.save(out, os.path.join(outdir, f"sac_{mode}_rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------- AMP
def amp_epoch_rank(rank, world, port, inpath, outdir):
    """One AMP epoch of HumanoidAMP on rank ``rank`` from a full-width
    learner state: ``inpath`` holds the env count, seed, train config,
    the state, the global action noise (T, B, A), each step's reset draws
    (global (N,) ids and times), each rank's local permutations and the
    discriminator phase's global draws."""
    import torch.distributed as dist
    from isaacgymenvs_ma_tpu_torch.learning.amp import AMPAgent
    from isaacgymenvs_ma_tpu_torch.parallel.mesh import (slice_state,
                                                         state_digest)
    inp = torch.load(inpath, weights_only=False)
    dp = _join(rank, world, port)
    n, seed = inp["n"], inp["seed"]
    task = _task("HumanoidAMP", n, rank, world, seed)
    agent = AMPAgent(task, inp["train_cfg"], seed=seed + rank, dist=dp)
    agent.init()
    agent.load_state_dict(slice_state(inp["state"], rank, world, n, n))
    nl = task.num_envs
    sl = slice(rank * nl, (rank + 1) * nl)
    seen = {}
    gae = agent._gae

    def spy(roll, last_obs):
        seen["roll"] = roll
        seen["adv"], seen["ret"] = gae(roll, last_obs)
        return seen["adv"], seen["ret"]
    agent._gae = spy
    m = agent.train_epoch(
        noise=inp["noise"][:, sl], perms=inp["perms"][rank],
        reset_draws=[tuple(x[sl] for x in step) for step in inp["draws"]],
        amp_draws=inp["amp_draws"])
    roll = {k: v for k, v in seen["roll"]._asdict().items()
            if torch.is_tensor(v)}
    torch.save({
        "roll": roll, "adv": seen["adv"], "ret": seen["ret"],
        "metrics": {k: (v if isinstance(v, int) else float(v))
                    for k, v in m.items()},
        "net": dict(agent.net.state_dict()),
        "disc": dict(agent.disc.state_dict()),
        "rms": {w: getattr(agent, w).state_dict()
                for w in ("obs_rms", "value_rms", "amp_rms")},
        "replay": agent.replay[: agent.replay_n].clone(),
        "replay_n": agent.replay_n, "q": agent.env_state.sim.q,
        "digest": state_digest(agent)},
        os.path.join(outdir, f"amp_rank{rank}.pt"))
    dist.destroy_process_group()
