#!/usr/bin/env python3
"""Smoke run of the PyTorch port (isaacgymenvs_ma_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:
  1. device: torch/CUDA versions, the card's name and power limit
  2. build: nvcc builds kernels B1-B3 for sm_90a from the checkout
  3. kernels: each kernel against its plain PyTorch twin at Ant-4096 shapes
     on a generic state, with kernel and twin times
  4. golden: the committed JAX Ant capture replayed through the kernels
  5. main path: Ant at 4096 envs, 200 steps of tanh(obs @ W) actions (as
     bench.py drives the JAX package), launch counts of B1-B3, env-steps/s
The line before the last is the kernels JSON, the last line
{"ok": true, "device": {...}}.  Needs a CUDA device; never falls back to
the CPU and never imports jax.
"""
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_ENVS = 4096
STEPS = 200
KERNELS = {  # wrapper name -> (CUDA source, TPU kernel replaced)
    "fk_motion": ("isaacgymenvs_ma_tpu_torch/physics/csrc/fk_motion.cu",
                  "isaacgymenvs_ma_tpu/physics/dyn_kernel.py:657"),
    "dyn_forward": ("isaacgymenvs_ma_tpu_torch/physics/csrc/dyn_forward.cu",
                    "isaacgymenvs_ma_tpu/physics/dyn_kernel.py:404"),
    "dyn_cached": ("isaacgymenvs_ma_tpu_torch/physics/csrc/dyn_cached.cu",
                   "isaacgymenvs_ma_tpu/physics/dyn_kernel.py:475"),
}


def phase(tag, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def gpu_ms(torch, fn, batches=5, per_batch=20):
    """Median over batches of the mean device time of ``per_batch`` calls,
    by CUDA events (warmed up first)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def generic_state(np, task, seed):
    """A mid-motion Ant state from a seed: displaced and tilted torsos,
    joints anywhere inside their limits, nonzero velocities."""
    g = np.random.default_rng(seed)
    n = task.num_envs
    m = task.model
    q = np.zeros((n, m.nq), np.float32)
    q[:, 0:2] = g.uniform(-1.0, 1.0, (n, 2))
    q[:, 2] = g.uniform(0.25, 0.7, n)
    quat = np.array([0, 0, 0, 1.0]) + 0.3 * g.normal(size=(n, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=-1, keepdims=True)
    q[:, 7:] = g.uniform(np.asarray(m.dof_lower[6:]),
                         np.asarray(m.dof_upper[6:]), (n, 8))
    qd = g.normal(0.0, 1.0, (n, m.nv)).astype(np.float32)
    return q, qd


def check_close(torch, name, got, ref, rtol, atol):
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")
    return float((got - ref).abs().max())


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device and does not fall back to the CPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import numpy as np
    import isaacgymenvs_ma_tpu_torch as port
    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) != HERE:
        raise RuntimeError(f"isaacgymenvs_ma_tpu_torch imported from "
                           f"{port.__file__}, not from this checkout")
    from isaacgymenvs_ma_tpu.utils.config import deep_merge
    from isaacgymenvs_ma_tpu_torch.physics import _build
    from isaacgymenvs_ma_tpu_torch.physics import dyn_kernel as dk
    from isaacgymenvs_ma_tpu_torch.tasks.ant import Ant, TASK_CFG
    from isaacgymenvs_ma_tpu_torch.utils import parity

    # ---- 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    phase("device", torch=torch.__version__, cuda=torch.version.cuda,
          name=repr(kind), count=torch.cuda.device_count())
    print(f"nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda", 0)

    # ---- 2. build
    task = Ant(deep_merge(TASK_CFG, {"env": {"numEnvs": N_ENVS}}),
               device=dev, seed=1)
    plan = task.engine.plan
    t0 = time.perf_counter()
    _build.build(plan)
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          kernels=",".join(sorted(plan.libs)))
    for name in sorted(plan.build_log):
        for line in plan.build_log[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    # ---- 3. kernels against their twins at Ant-4096 shapes
    q_np, qd_np = generic_state(np, task, seed=7)
    q_bl = torch.as_tensor(q_np, device=dev).t().contiguous()
    qd_bl = torch.as_tensor(qd_np, device=dev).t().contiguous()
    g = torch.Generator(device=dev).manual_seed(3)
    rhs_bl = torch.randn((plan.nv, N_ENVS), generator=g, device=dev)
    diag_bl = (task.engine.dof_armature[:, None] + 0.1).expand(
        plan.nv, N_ENVS).contiguous()
    consts = plan.consts(dev)
    report = {}

    bx, bq, S = dk.fk_motion(plan, q_bl)
    rbx, rbq, rS = dk._fk_motion_bl(plan, q_bl)
    err = max(check_close(torch, "fk_motion body_x", bx, rbx, 1e-5, 1e-5),
              check_close(torch, "fk_motion body_q", bq, rbq, 1e-5, 1e-5),
              check_close(torch, "fk_motion S", S, rS, 1e-5, 1e-5))
    report["fk_motion"] = dict(
        max_abs_err=err, ms=gpu_ms(torch, lambda: dk.fk_motion(plan, q_bl)),
        plain_ms=gpu_ms(torch, lambda: dk._fk_motion_bl(plan, q_bl)))

    args = (rbx, rbq, rS, qd_bl, rhs_bl, diag_bl)
    qdd, hinv, io = dk.dyn_forward(plan, *args)
    rqdd, rhinv, rio = dk.dyn_full_bl(plan, consts, *args)
    err = max(check_close(torch, "dyn_forward I_O", io, rio, 1e-5, 1e-5),
              check_close(torch, "dyn_forward Hinv", hinv, rhinv, 2e-4, 1e-5),
              check_close(torch, "dyn_forward qdd", qdd, rqdd, 2e-4, 2e-4))
    # per-env mass and shape scales (the domain-randomization inputs)
    ms = torch.rand((plan.nb, N_ENVS), generator=g, device=dev) + 0.5
    ss = torch.rand((plan.nb, 3, N_ENVS), generator=g, device=dev) * 0.7 + 0.7
    out_s = dk.dyn_forward(plan, *args, ms, ss)
    ref_s = dk.dyn_full_bl(plan, consts, *args, ms, ss)
    err = max(err, *(check_close(torch, f"dyn_forward scaled {k}", a, b, *tol)
                     for k, a, b, tol in zip(
                         ("qdd", "Hinv", "I_O"), out_s, ref_s,
                         ((2e-4, 2e-4), (2e-4, 1e-5), (1e-5, 1e-5)))))
    report["dyn_forward"] = dict(
        max_abs_err=err, ms=gpu_ms(torch, lambda: dk.dyn_forward(plan, *args)),
        plain_ms=gpu_ms(torch, lambda: dk.dyn_full_bl(plan, consts, *args)))

    body_x, body_q = rbx.permute(2, 0, 1), rbq.permute(2, 0, 1)
    fg = task.engine.gravity_wrench(body_x, body_q).permute(1, 2, 0).contiguous()
    cargs = (rS, qd_bl, rhs_bl, rio, rhinv, fg)
    qdd_c = dk.dyn_cached(plan, *cargs)
    rqdd_c = dk.dyn_cached_bl(plan, consts, *cargs)
    report["dyn_cached"] = dict(
        max_abs_err=check_close(torch, "dyn_cached qdd", qdd_c, rqdd_c,
                                2e-4, 2e-4),
        ms=gpu_ms(torch, lambda: dk.dyn_cached(plan, *cargs)),
        plain_ms=gpu_ms(torch, lambda: dk.dyn_cached_bl(plan, consts, *cargs)))
    for name, r in report.items():
        phase("kernel", name=name, max_abs_err=f"{r['max_abs_err']:.3g}",
              ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}")

    # ---- 4. golden JAX capture replayed through the kernels
    golden = os.path.join(HERE, "tests", "data", "torch_port",
                          "ant_golden.npz")
    e = parity.replay(golden, dev)
    if not e.finite:
        raise RuntimeError("golden replay produced non-finite values")
    for k, tol in parity.GOLDEN_TOL.items():
        errs = getattr(e, k)
        if not (errs <= tol).all():
            raise RuntimeError(f"golden replay {k} per-step errors {errs} "
                               f"exceed {tol}")
    if int(e.reset_mismatches.sum()):
        raise RuntimeError(f"golden replay reset mismatches "
                           f"{e.reset_mismatches}")
    phase("golden", steps=len(e.q),
          **{f"{k}_err": "/".join(f"{v:.2g}" for v in getattr(e, k))
             for k in parity.GOLDEN_TOL})

    # ---- 5. main path: Ant at 4096 envs, tanh(obs @ W) actions
    gw = torch.Generator(device=dev).manual_seed(0)
    W = torch.randn((task.num_obs, task.num_actions), generator=gw,
                    device=dev) * 0.1
    state = task.initial_state()
    obs = torch.zeros((N_ENVS, task.num_obs), device=dev)
    for _ in range(10):                                   # warm-up
        state, res = task.step(state, torch.tanh(obs @ W))
        obs = res.obs
    finite = torch.ones((), dtype=torch.bool, device=dev)
    resets = torch.zeros((), dtype=torch.int64, device=dev)
    for w in dk.KERNEL_WRAPPERS:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, res = task.step(state, torch.tanh(obs @ W))
        obs = res.obs
        finite &= torch.isfinite(obs).all() & torch.isfinite(res.rew).all()
        resets += res.reset.sum()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in dk.KERNEL_WRAPPERS}
    finite &= (torch.isfinite(state.sim.q).all()
               & torch.isfinite(state.sim.qd).all())
    if not bool(finite):
        raise RuntimeError("main path produced non-finite values")
    if tuple(obs.shape) != (N_ENVS, task.num_obs):
        raise RuntimeError(f"obs shape {tuple(obs.shape)}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise RuntimeError(f"main path never launched kernels {missing}")
    phase("main", envs=N_ENVS, steps=STEPS, seconds=f"{seconds:.4f}",
          env_steps_per_s=f"{N_ENVS * STEPS / seconds:.1f}",
          resets=int(resets), launches=json.dumps(launches).replace(" ", ""))

    kernels = [dict(name=name, route="cuda", source=KERNELS[name][0],
                    replaces=KERNELS[name][1], launches=launches[name],
                    max_abs_err=report[name]["max_abs_err"],
                    ms=report[name]["ms"], plain_ms=report[name]["plain_ms"])
               for name in KERNELS]
    print(f"nvidia-smi: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
