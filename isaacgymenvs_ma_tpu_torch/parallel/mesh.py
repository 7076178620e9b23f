"""Data parallelism over ``torch.distributed`` (port of
isaacgymenvs_ma_tpu/parallel/mesh.py).

The JAX package shards ONE jitted program over a device mesh with one
``env`` axis: the env state and rollout are split over the envs, the
parameters, optimiser state, normalisers and replay buffers are
replicated, and XLA inserts the reductions.  The port keeps those
semantics with one process a rank (started by ``torchrun`` / ``python -m
torch.distributed.run``):

* ``numEnvs`` and the learners' batch sizes (PPO's ``minibatch_size``,
  SAC's ``batch_size``, AMP's ``amp_batch_size``) are global.  Rank ``r``
  of ``W`` steps envs ``[r N/W, (r+1) N/W)`` (:func:`local_task_config`;
  an MA task's K agent rows of an env stay on its rank) and takes ``1/W``
  of each batch.  ``W`` must divide them all (:func:`check_split`,
  :func:`check_batch`).
* Rank and world come from torchrun's ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; without them
  :func:`dist_env` raises.  The backend is ``nccl`` on CUDA and ``gloo``
  on the CPU unless the caller names one.
* The env draws of rank ``r`` are seeded ``make_seed(seed, rank=r)``; the
  parameters (and any optimiser state) are broadcast from rank 0 at init
  (:meth:`DataParallel.broadcast_agent`).  Draws that are global in JAX
  (SAC's replay indices and its update's noise, AMP's demo and replay
  draws) come from a generator seeded alike on every rank
  (:func:`shared_seed`).
* Reduced across ranks (:class:`DataParallel`): the gradients (one
  flattened all-reduce, divided by ``W``, before the global-norm clip),
  the advantage moments and the running normalisers' batch moments (global
  sums and counts, then the same Chan merge), the minibatch KL that drives
  the adaptive learning rate, and the epoch's metrics (finished episodes'
  return and length sums with their counts).
* Global rows (:meth:`DataParallel.rows`, :meth:`DataParallel.pick`): SAC's
  transitions of a step and AMP's discriminator batch are assembled on
  every rank, so the replay rings stay replicated, as the JAX package's
  are: each rank writes its rows into a zero-filled global tensor and one
  all-reduce sums them (gloo carries only ``broadcast`` and
  ``all_reduce`` for CUDA tensors).  Adding zeros is exact, except that
  ``-0.0`` becomes ``+0.0``.
* Checkpoints are global, as the JAX package's global arrays are: rank 0
  gathers every rank's per-env leaves through host copies and writes one
  full-width checkpoint (the replicated rings as they stand); a loading
  rank takes its slice (:func:`slice_state`), so a checkpoint moves
  between world sizes.

Every learner runs over ranks: PPO with its LSTM, central-value and
multi-agent paths, the HRL wrapper through PPO, AMP and SAC.
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

# a replicated generator's seed: rank 0's seed plus this offset, past any
# rank's seed (seed + rank) and the AMP discriminator's (seed + 1)
SHARED_SEED_OFFSET = 7919


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


def check_batch(name: str, size: int, world: int) -> None:
    """Raise where ``world`` does not divide a learner's global batch
    ``size`` (``name`` its config key)."""
    if size % world:
        raise ValueError(f"{world} ranks do not divide {name}={size}")


def shared_seed(seed: int, dist=None) -> int:
    """The seed of a generator that draws alike on every rank: rank 0's
    ``seed`` plus :data:`SHARED_SEED_OFFSET` (broadcast with ``dist``)."""
    if dist is not None:
        seed = dist.broadcast_int(seed)
    return seed + SHARED_SEED_OFFSET


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
    """The reductions of one data-parallel run over the default process
    group.  On CUDA, CUDA events time the gradient all-reduces and the
    global-row combines of the current epoch (:meth:`collect_timings`);
    ``allreduce_bytes`` and ``combine_bytes`` sum their sizes.  A learner
    calls :meth:`mark_epoch` as its epoch starts, which drops the last
    epoch's, so a long run keeps one epoch's events."""

    def __init__(self, rank: int, world: int, device, backend: str):
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self.backend = backend
        # host-side collectives (checkpoint gathers) go over gloo
        self.host_group = (dist.new_group(backend="gloo")
                           if backend == "nccl" else None)
        self.timed = self.device.type == "cuda"
        self.allreduce_bytes = 0
        self.combine_bytes = 0
        self._events = {"allreduce": [], "combine": []}

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

    def mark_epoch(self) -> None:
        """Start an epoch: forget the last epoch's timings and sizes."""
        self._events = {"allreduce": [], "combine": []}
        self.allreduce_bytes = self.combine_bytes = 0

    def _timed_all_reduce(self, x: torch.Tensor, kind: str) -> None:
        nbytes = x.numel() * x.element_size()
        if kind == "allreduce":
            self.allreduce_bytes += nbytes
        else:
            self.combine_bytes += nbytes
        if self.timed:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        dist.all_reduce(x)
        if self.timed:
            ev[1].record()
            self._events[kind].append(ev)

    def allreduce_grads(self, params) -> None:
        """Average the gradients over the ranks: one flattened all-reduce
        of every gradient, divided by W, copied back."""
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        self._timed_all_reduce(flat, "allreduce")
        flat.div_(self.world)
        off = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[off: off + n].view_as(g))
            off += n

    def rows(self, local: torch.Tensor) -> torch.Tensor:
        """The global ``(W n, ...)`` rows of every rank's ``(n, ...)``
        ``local``, in rank order, on every rank: each rank writes its rows
        into a zero-filled global tensor and one all-reduce sums them."""
        n = local.shape[0]
        out = local.new_zeros((self.world * n,) + tuple(local.shape[1:]))
        out[self.rank * n: (self.rank + 1) * n] = local
        self._timed_all_reduce(out, "combine")
        return out

    def pick(self, local: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` of the global ``(T, W n, ...)`` tensor whose rank
        ``r`` holds envs ``[r n, (r+1) n)`` as ``local`` ``(T, n, ...)``,
        flattened as JAX flattens it (global row ``t W n + e``), on every
        rank: each rank fills the picks it owns and one all-reduce sums
        them (no host wait)."""
        T, n = local.shape[:2]
        flat = local.reshape((T * n,) + tuple(local.shape[2:]))
        idx = idx.long()
        t, e = idx // (n * self.world), idx % (n * self.world)
        mine = (e // n) == self.rank
        row = torch.clamp(t * n + e - self.rank * n, 0, T * n - 1)
        got = flat[row]
        out = torch.where(mine.reshape((-1,) + (1,) * (got.dim() - 1)),
                          got, torch.zeros_like(got))
        self._timed_all_reduce(out, "combine")
        return out

    def collect_timings(self, kind: str = "allreduce") -> list:
        """The ms of the current epoch's ``kind`` (``allreduce`` or
        ``combine``) collectives not yet collected (waits for the card)."""
        if self._events[kind]:
            torch.cuda.synchronize(self.device)
        out = [a.elapsed_time(b) for a, b in self._events[kind]]
        self._events[kind] = []
        return out

    def broadcast_int(self, value: int) -> int:
        """Rank 0's ``value`` on every rank."""
        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=0)
        return int(t.item())

    def broadcast_tensors(self, tensors) -> None:
        """Rank 0's values of ``tensors`` (in place) on every rank."""
        for t in tensors:
            dist.broadcast(t.data, src=0)

    def broadcast_agent(self, agent) -> None:
        """Rank 0's parameters, buffers and optimiser state on every rank."""
        self.broadcast_tensors(list(agent.net.parameters())
                               + list(agent.net.buffers()))
        for st in agent.optim.state.values():
            self.broadcast_tensors(v for v in st.values()
                                   if torch.is_tensor(v))

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


def module_state(prefix: str, module, optim=None):
    """(name, tensor) of ``module``'s parameters, each followed by its
    ``optim`` state, in parameter order (the learners' replicated state
    for :func:`state_digest`)."""
    for name, p in module.named_parameters():
        yield prefix + name, p
        if optim is None:
            continue
        for k, v in sorted(optim.state.get(p, {}).items()):
            if torch.is_tensor(v):
                yield f"{prefix}{name}.{k}", v


def state_digest(agent) -> str:
    """sha256 of the learner's replicated state (``agent.
    replicated_state()``: parameters and Adam state, and where a learner
    has them its normalisers and replay ring; host bytes in order): equal
    digests mean bit-equal learners."""
    h = hashlib.sha256()
    for name, t in agent.replicated_state():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()
