"""Record the JAX Ant golden trajectory that the PyTorch port replays.

Writes tests/data/torch_port/ant_golden.npz in the capture format of
isaacgymenvs_ma_tpu_torch/utils/parity.py: Ant at 64 envs, warmed up for
20 steps so the feet are on the ground, then 6 recorded steps under fixed
seeded actions, with a quarter of the envs flagged to reset on the first
recorded step and the JAX reset draws stored for every step.

    JAX_PLATFORMS=cpu python scripts/record_torch_golden.py
"""
import os

import numpy as np
import jax
import jax.numpy as jnp

from isaacgymenvs_ma_tpu.tasks.ant import Ant, TASK_CFG
from isaacgymenvs_ma_tpu.utils.config import deep_merge

N, WARMUP, T = 64, 20, 6
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "data", "torch_port", "ant_golden.npz")


def main():
    task = Ant(deep_merge(TASK_CFG, {"env": {"numEnvs": N}}))
    step = jax.jit(task.step)
    rng = np.random.default_rng(2024)
    st = task.initial_state(jax.random.PRNGKey(2024))
    for _ in range(WARMUP):
        st, _ = step(st, jnp.asarray(rng.uniform(-1, 1, (N, 8)), jnp.float32))
    flags = np.asarray(st.reset_buf).copy()
    flags[: N // 4] = 1
    st = st._replace(reset_buf=jnp.asarray(flags, jnp.int32))
    rec = {
        "task": np.asarray("Ant"), "atol": np.float32(2e-3),
        "init_q": np.asarray(st.sim.q), "init_qd": np.asarray(st.sim.qd),
        "init_progress": np.asarray(st.progress),
        "init_reset_buf": np.asarray(st.reset_buf),
        "init_potentials": np.asarray(st.task.potentials),
        "init_prev_potentials": np.asarray(st.task.prev_potentials),
        "init_actions": np.asarray(st.task.actions),
    }
    actions = rng.uniform(-1, 1, (T, N, 8)).astype(np.float32)
    fields = {k: [] for k in ("obs", "rew", "reset", "q", "qd",
                              "reset_pos", "reset_vel")}
    for t in range(T):
        k1, k2 = jax.random.split(jax.random.split(st.rng, 6)[1])
        fields["reset_pos"].append(np.asarray(jax.random.uniform(
            k1, (N, 8), minval=-0.2, maxval=0.2)))
        fields["reset_vel"].append(np.asarray(jax.random.uniform(
            k2, (N, 8), minval=-0.1, maxval=0.1)))
        st, res = step(st, jnp.asarray(actions[t]))
        fields["obs"].append(np.asarray(res.obs))
        fields["rew"].append(np.asarray(res.rew))
        fields["reset"].append(np.asarray(res.reset))
        fields["q"].append(np.asarray(st.sim.q))
        fields["qd"].append(np.asarray(st.sim.qd))
    rec["actions"] = actions
    for k, v in fields.items():
        rec[k] = np.stack(v)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **rec)
    print(OUT, os.path.getsize(OUT), "bytes")


if __name__ == "__main__":
    main()
