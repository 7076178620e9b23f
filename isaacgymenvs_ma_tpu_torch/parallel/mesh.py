"""Data parallelism over ``torch.distributed`` (port of
isaacgymenvs_ma_tpu/parallel/mesh.py).

The JAX package shards ONE jitted program over a device mesh with one
``env`` axis: the env state and rollout are split over the envs, the
parameters, optimiser state and normalisers are replicated, and XLA
inserts the reductions.  The port keeps those semantics with one process a
rank (started by ``torchrun`` / ``python -m torch.distributed.run``):

* ``numEnvs`` and ``minibatch_size`` are global.  Rank ``r`` of ``W``
  steps envs ``[r N/W, (r+1) N/W)`` (:func:`local_task_config`; an MA
  task's K agent rows of an env stay on its rank) and takes
  ``minibatch_size / W`` of its rows a minibatch.  ``W`` must divide both.
* Rank and world come from torchrun's ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; without them
  :func:`dist_env` raises.  The backend is ``nccl`` on CUDA and ``gloo``
  on the CPU unless the caller names one.
* The env draws of rank ``r`` are seeded ``make_seed(seed, rank=r)``; the
  parameters (and any optimiser state) are broadcast from rank 0 at init
  (:meth:`DataParallel.broadcast_agent`).
* Reduced across ranks (:class:`DataParallel`): the gradients (one
  flattened all-reduce, divided by ``W``, before the global-norm clip),
  the advantage moments and the running normalisers' batch moments (global
  sums and counts, then the same Chan merge), the minibatch KL that drives
  the adaptive learning rate, and the epoch's metrics (finished episodes'
  return and length sums with their counts).
* Checkpoints are global, as the JAX package's global arrays are: rank 0
  gathers every rank's per-env leaves through host copies (gloo carries
  only ``broadcast`` and ``all_reduce`` for CUDA tensors) and writes one
  full-width checkpoint; a loading rank takes its slice
  (:func:`slice_state`), so a checkpoint moves between world sizes.

PPO is covered, with its LSTM, central-value and multi-agent paths, and
the HRL wrapper through PPO.  ``sac`` and ``amp_continuous`` with ``W >
1`` raise (:func:`check_algo`): their replay buffers are global buffers
under the JAX sharding (ROADMAP queue A, item 11).
"""
from __future__ import annotations

import copy
import hashlib
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

# torchrun's variables that a multi-process run needs
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")

# the agent ``state_dict()`` entries that hold per-env or per-row leaves;
# everything else (network, optimiser, normalisers, counters) is replicated
PER_ENV_KEYS = ("env_state", "last_obs", "last_states", "carry",
                "ep_return", "ep_length")

# learners whose W > 1 path is still to be ported
UNSHARDED_ALGOS = ("sac", "amp_continuous")


class DistEnv(NamedTuple):
    rank: int
    world: int
    local_rank: int
    master_addr: str
    master_port: int


def dist_env(environ=None) -> DistEnv:
    """torchrun's rank, world and rendezvous from the environment; raises
    naming torchrun when one is missing (never falls back to one
    process)."""
    env = os.environ if environ is None else environ
    missing = [k for k in TORCHRUN_VARS if not env.get(k)]
    if missing:
        raise RuntimeError(
            "multi_gpu=True needs torchrun's variables "
            f"({', '.join(missing)} not set): start the run with "
            "`torchrun --nproc_per_node=<W> -m isaacgymenvs_ma_tpu_torch."
            "train ... multi_gpu=True` (or python -m torch.distributed.run)")
    return DistEnv(int(env["RANK"]), int(env["WORLD_SIZE"]),
                   int(env["LOCAL_RANK"]), env["MASTER_ADDR"],
                   int(env["MASTER_PORT"]))


def check_split(num_envs: int, minibatch_size: int, world: int) -> None:
    """Raise where ``world`` does not divide the envs or the minibatch."""
    if num_envs % world:
        raise ValueError(f"{world} ranks do not divide numEnvs={num_envs}")
    if minibatch_size % world:
        raise ValueError(
            f"{world} ranks do not divide minibatch_size={minibatch_size}")


def check_algo(algo: str, world: int) -> None:
    if world > 1 and algo in UNSHARDED_ALGOS:
        raise NotImplementedError(
            f"{algo} over {world} ranks is not ported yet: its replay "
            "buffer is a global buffer under the JAX sharding (ROADMAP "
            "queue A, item 11)")


def local_task_config(task_cfg: dict, rank: int, world: int) -> dict:
    """The task config of rank ``rank``: its N/W envs, starting at global
    env id ``rank * N / W`` (``env.envOffset``)."""
    n = int(task_cfg["env"]["numEnvs"])
    if n % world:
        raise ValueError(f"{world} ranks do not divide numEnvs={n}")
    cfg = copy.deepcopy(task_cfg)
    cfg["env"]["numEnvs"] = n // world
    cfg["env"]["envOffset"] = rank * (n // world)
    return cfg


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class DataParallel:
    """The reductions of one data-parallel PPO run over the default
    process group.  ``time_allreduce`` records CUDA events around the
    gradient all-reduce (``allreduce_ms``, ``allreduce_bytes``)."""

    def __init__(self, rank: int, world: int, device, backend: str):
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self.backend = backend
        # host-side collectives (checkpoint gathers) go over gloo
        self.host_group = (dist.new_group(backend="gloo")
                           if backend == "nccl" else None)
        self.time_allreduce = self.device.type == "cuda"
        self.allreduce_ms = []
        self.allreduce_bytes = 0
        self._events = []

    @classmethod
    def init(cls, device=None, backend: Optional[str] = None,
             environ=None) -> "DataParallel":
        """Join the process group from torchrun's variables; ``device``
        defaults to ``cuda:{LOCAL_RANK}``."""
        e = dist_env(environ)
        if device is None:
            device = f"cuda:{e.local_rank}"
        device = torch.device(device)
        backend = backend or default_backend(device)
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"dist_backend must be nccl or gloo, not "
                             f"{backend!r}")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            dist.init_process_group(
                backend, init_method=f"tcp://{e.master_addr}:{e.master_port}",
                rank=e.rank, world_size=e.world)
        return cls(e.rank, e.world, device, backend)

    # ------------------------------------------------------------------
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (a new tensor)."""
        y = x.detach().clone()
        dist.all_reduce(y)
        return y

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return self.sum(x) / self.world

    def allreduce_grads(self, params) -> None:
        """Average the gradients over the ranks: one flattened all-reduce
        of every gradient, divided by W, copied back."""
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        if self.time_allreduce:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        dist.all_reduce(flat)
        if self.time_allreduce:
            ev[1].record()
            self._events.append(ev)
        self.allreduce_bytes = flat.numel() * flat.element_size()
        flat.div_(self.world)
        off = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[off: off + n].view_as(g))
            off += n

    def collect_timings(self) -> list:
        """The all-reduce ms of the updates since the last call (waits for
        the card)."""
        if self._events:
            torch.cuda.synchronize(self.device)
            self.allreduce_ms.extend(a.elapsed_time(b)
                                     for a, b in self._events)
            self._events = []
        out, self.allreduce_ms = self.allreduce_ms, []
        return out

    def broadcast_agent(self, agent) -> None:
        """Rank 0's parameters, buffers and optimiser state on every rank."""
        for t in list(agent.net.parameters()) + list(agent.net.buffers()):
            dist.broadcast(t.data, src=0)
        for st in agent.optim.state.values():
            for v in st.values():
                if torch.is_tensor(v):
                    dist.broadcast(v, src=0)

    # ------------------------------------------------------------------
    def gather_state(self, sd: dict, num_envs: int, batch: int):
        """Rank 0: the agent ``state_dict`` ``sd`` with every per-env leaf
        (leading dim ``num_envs`` or ``batch``, the local sizes) of every
        rank concatenated in rank order, on the host; the other ranks:
        None.  The generators' states go into ``rank_generators``."""
        local = {k: _to_cpu(sd.get(k)) for k in PER_ENV_KEYS if k in sd}
        local["generator"] = sd.get("generator")
        local["task_generator"] = sd.get("task_generator")
        parts = [None] * self.world if self.rank == 0 else None
        dist.gather_object(local, parts, dst=0, group=self.host_group)
        if self.rank != 0:
            return None
        full = {k: v for k, v in sd.items() if k not in PER_ENV_KEYS}
        full = _to_cpu(full)
        sizes = (num_envs, batch)
        for k in local:
            if k in PER_ENV_KEYS:
                full[k] = _concat([p[k] for p in parts], sizes)
        full["rank_generators"] = [(p["generator"], p["task_generator"])
                                   for p in parts]
        return full


def _to_cpu(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _concat(parts, sizes):
    """Per-env leaves of the ranks concatenated along their leading dim;
    other leaves taken from rank 0 (the JAX rule: a leaf whose leading dim
    is a batch size is sharded, the rest replicated)."""
    x = parts[0]
    if torch.is_tensor(x):
        if x.dim() >= 1 and int(x.shape[0]) in sizes:
            return torch.cat(parts, 0)
        return x
    if isinstance(x, dict):
        return {k: _concat([p[k] for p in parts], sizes) for k in x}
    if isinstance(x, (list, tuple)):
        return type(x)(_concat([p[i] for p in parts], sizes)
                       for i in range(len(x)))
    return x


def slice_state(sd: dict, rank: int, world: int, num_envs: int,
                batch: int) -> dict:
    """Rank ``rank``'s part of a full-width agent ``state_dict`` whose
    per-env leaves have ``num_envs`` (global) or ``batch`` (global rows)
    leading rows: the ``world``-th slice of each.  A checkpoint written by
    a different world size keeps rank 0's generators for rank 0 and
    leaves the others' as the rank seeded them."""
    sizes = {num_envs: num_envs // world, batch: batch // world}

    def cut(x):
        if torch.is_tensor(x):
            if x.dim() >= 1 and int(x.shape[0]) in sizes:
                n = sizes[int(x.shape[0])]
                return x[rank * n: (rank + 1) * n]
            return x
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        return x

    out = {k: (cut(v) if k in PER_ENV_KEYS else v) for k, v in sd.items()
           if k != "rank_generators"}
    gens = sd.get("rank_generators")
    if gens is not None and len(gens) == world:
        out["generator"], out["task_generator"] = gens[rank]
    elif rank != 0:
        out.pop("generator", None)
        out.pop("task_generator", None)
    return out


def state_digest(agent) -> str:
    """sha256 of the agent's parameters and Adam state (host bytes, in
    parameter order): equal digests mean bit-equal learners."""
    h = hashlib.sha256()
    for name, p in agent.net.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
        for k, v in sorted(agent.optim.state.get(p, {}).items()):
            if torch.is_tensor(v):
                h.update(k.encode())
                h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()
