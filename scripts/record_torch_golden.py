"""Record the JAX golden trajectories that the PyTorch port replays.

Writes tests/data/torch_port/ant_golden.npz (``--task Ant``, the default)
or tests/data/torch_port/ball_balance_golden.npz (``--task BallBalance``)
in the capture format of isaacgymenvs_ma_tpu_torch/utils/parity.py: the task
at 64 envs from its JAX default path, warmed up for 20 steps (Ant: the feet
on the ground; BallBalance: the balls landed on the trays), then 6 recorded
steps under fixed seeded actions, with a quarter of the envs flagged to
reset on the first recorded step and the JAX reset draws stored for every
step.

    JAX_PLATFORMS=cpu python scripts/record_torch_golden.py [--task NAME]
"""
import argparse
import os

import numpy as np
import jax
import jax.numpy as jnp

from isaacgymenvs_ma_tpu.ops import rng as rng_ops
from isaacgymenvs_ma_tpu.tasks import ant, ball_balance
from isaacgymenvs_ma_tpu.utils.config import deep_merge

N, WARMUP, T = 64, 20, 6
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tests", "data", "torch_port")


def ant_draws(k_reset):
    """Ant.reset_idx's draws (ant.py:138-141)."""
    k1, k2 = jax.random.split(k_reset)
    return {"reset_pos": jax.random.uniform(k1, (N, 8), minval=-0.2,
                                            maxval=0.2),
            "reset_vel": jax.random.uniform(k2, (N, 8), minval=-0.1,
                                            maxval=0.1)}


def ball_balance_draws(k_reset):
    """BallBalance.reset_idx's draws (ball_balance.py:207-226)."""
    k1, k2, k3, k4 = jax.random.split(k_reset, 4)
    return {"reset_dists": rng_ops.rand_float(k1, 0.001, 0.5, (N, 1)),
            "reset_dirs": rng_ops.random_dir_2(k2, (N, 1))[:, 0, :],
            "reset_hspeeds": rng_ops.rand_float(k3, 0.0, 5.0, (N, 1)),
            "reset_height": rng_ops.rand_float(k4, 1.0, 2.0, (N,))}


TASKS = {
    "Ant": (ant.Ant, ant.TASK_CFG, ant_draws, "ant_golden.npz"),
    "BallBalance": (ball_balance.BallBalance, ball_balance.TASK_CFG,
                    ball_balance_draws, "ball_balance_golden.npz"),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="Ant", choices=sorted(TASKS))
    args = ap.parse_args()
    cls, task_cfg, draws_of, fname = TASKS[args.task]
    task = cls(deep_merge(task_cfg, {"env": {"numEnvs": N}}))
    A = task.num_actions
    step = jax.jit(task.step)
    rng = np.random.default_rng(2024)
    st = task.initial_state(jax.random.PRNGKey(2024))
    for _ in range(WARMUP):
        st, _ = step(st, jnp.asarray(rng.uniform(-1, 1, (N, A)), jnp.float32))
    flags = np.asarray(st.reset_buf).copy()
    flags[: N // 4] = 1
    st = st._replace(reset_buf=jnp.asarray(flags, jnp.int32))
    rec = {
        "task": np.asarray(args.task), "atol": np.float32(2e-3),
        "init_q": np.asarray(st.sim.q), "init_qd": np.asarray(st.sim.qd),
        "init_progress": np.asarray(st.progress),
        "init_reset_buf": np.asarray(st.reset_buf),
    }
    for f in st.task._fields:
        rec[f"init_{f}"] = np.asarray(getattr(st.task, f))
    actions = rng.uniform(-1, 1, (T, N, A)).astype(np.float32)
    fields = {k: [] for k in ("obs", "rew", "reset", "q", "qd")}
    for t in range(T):
        k_reset = jax.random.split(st.rng, 6)[1]   # VecTaskBase.step's key
        for k, v in draws_of(k_reset).items():
            fields.setdefault(k, []).append(np.asarray(v))
        st, res = step(st, jnp.asarray(actions[t]))
        fields["obs"].append(np.asarray(res.obs))
        fields["rew"].append(np.asarray(res.rew))
        fields["reset"].append(np.asarray(res.reset))
        fields["q"].append(np.asarray(st.sim.q))
        fields["qd"].append(np.asarray(st.sim.qd))
    rec["actions"] = actions
    for k, v in fields.items():
        rec[k] = np.stack(v)
    out = os.path.join(DATA, fname)
    os.makedirs(DATA, exist_ok=True)
    np.savez_compressed(out, **rec)
    print(out, os.path.getsize(out), "bytes")


if __name__ == "__main__":
    main()
