"""FrankaReachMA on the contact-kernel route (kernel B4's twin on the CPU)
against the JAX package's kernel route in Pallas interpret mode.

The JAX engine takes its kernel route only where its dynamics kernels
apply, whose lane blocks divide N by 128 (dyn_kernel.py:352-358), and B4's
by 64 (contact_kernel.py:196-212); elsewhere it runs its XLA loop with
compaction and row reuse, with no warning.  So these checks run at 128 envs
(256 agent rows) and assert that JAX's ``supports`` holds there.  On that
route the JAX engine neither compacts nor reuses contact rows
(engine.py:1304-1305, :1524, :1558): all 41 candidate rows are solved in
every substep, although FrankaReachMA's configuration sets
``contact_capacity`` 24 and ``reuse_contact_rows``.

The state is the warmed-up initial state of the committed B4-route capture
(tests/data/torch_port/franka_reach_ma_b4_golden.npz, replayed whole in
tests/test_torch_golden.py) with a quarter of the envs flagged to reset;
the JAX step ran eagerly with ``_FORCE_INTERPRET`` set (it is read while
tracing; ~120-300 s on the CPU) in ``scripts/record_torch_golden.py
--route-step FrankaReachMA``, which recorded it with its reset draws, and
the tests read that record; the draws are injected into the port.  Tolerances: q rtol 2e-4 / atol 2e-5, qd, obs and reward 3e-3 (the
JAX package's bounds for pair scenes, tests/test_dyn_kernel.py:139-159);
resets exact.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.physics import contact_kernel as jck
from isaacgymenvs_ma_tpu.physics import dyn_kernel as jdk
from isaacgymenvs_ma_tpu.tasks import franka_reach_ma as jfr
from isaacgymenvs_ma_tpu.utils.config import deep_merge as jdeep_merge
from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax
from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
from isaacgymenvs_ma_tpu_torch.tasks.franka_reach_ma import (
    FrankaReachMA, TASK_CFG)
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

CAPTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_port", "franka_reach_ma_b4_golden.npz")
ROUTE_STEP = os.path.join(os.path.dirname(os.path.dirname(CAPTURE)),
                          "torch_port", "franka_reach_ma_route_step.npz")


def _jax_supports(engine, n):
    """Whether the JAX engine takes its dynamics kernels and kernel B4 at
    ``n`` envs in interpret mode."""
    P = engine.n_ground + engine.n_pair_rows
    jdk._FORCE_INTERPRET = True
    try:
        return (jdk.supports(engine, n, jnp.float32)
                and jdk.fk_supports(engine, n, jnp.float32)
                and jck.supports(engine, n, jnp.float32, P,
                                 len(engine.attractors), len(engine.grabs),
                                 bool(engine.pairs)))
    finally:
        jdk._FORCE_INTERPRET = False


def _port_task(n, **overrides):
    cfg = deep_merge(TASK_CFG, {"env": {"numEnvs": n}})
    return FrankaReachMA(cfg, device="cpu", sim_params=parse_sim_params(
        cfg["sim"])._replace(use_contact_kernel=True, **overrides))


@pytest.fixture(scope="module")
def kernel_route():
    """The capture's state, the first recorded actions, the JAX reset
    draws and the JAX kernel route's step from there.  The step (~120-300 s
    interpreted on the CPU) was recorded from that state, with
    ``PRNGKey(7)``'s reset draws, by ``scripts/record_torch_golden.py
    --route-step FrankaReachMA`` into ROUTE_STEP, which this fixture reads;
    the draws are made here again from the key and must be the recorded
    ones."""
    d = np.load(CAPTURE)
    r = np.load(ROUTE_STEP)
    n = d["init_q"].shape[0]
    jt = jfr.FrankaReachMA(jdeep_merge(jfr.TASK_CFG, {"env": {"numEnvs": n}}))
    for k in ("q", "qd", "progress", "reset_buf", "actions"):
        np.testing.assert_array_equal(r[f"init_{k}"], d[f"init_{k}"])
    acts = d["actions"][0]
    np.testing.assert_array_equal(r["actions"], acts)
    # FrankaReachMA.reset_idx's uniform draws from VecTaskBase.step's key
    k1, k2, k3 = jax.random.split(
        jax.random.split(jax.random.PRNGKey(7), 6)[1], 3)
    K, T = jt.num_agents, jt.num_targets
    draws = tuple(torch.as_tensor(np.array(x)) for x in (
        jax.random.uniform(k1, (n, K, 9)), jax.random.uniform(k2, (n, T, 2)),
        jax.random.uniform(k3, (n, T))))
    for i, x in enumerate(draws):
        np.testing.assert_array_equal(r[f"draw_{i}"], x.numpy())
    port_state = env_state_from_jax(
        {"sim.q": d["init_q"], "sim.qd": d["init_qd"],
         "progress": d["init_progress"], "reset_buf": d["init_reset_buf"],
         "task.actions": d["init_actions"]}, "cpu")
    return dict(n=n, jt=jt, acts=acts, draws=draws, ref=r,
                port_state=port_state)


def test_jax_takes_its_kernel_route_at_128_envs(kernel_route):
    """At the capture's 128 envs the JAX engine takes its kernels; at 64,
    where B4 alone would fit, its dynamics kernels do not, and neither
    does B4 (it needs their batch-last H^-1)."""
    je = kernel_route["jt"].engine
    assert kernel_route["n"] == 128
    assert _jax_supports(je, 128)
    assert not jdk.supports(je, 64, jnp.float32)


def test_franka_kernel_route_matches_jax_interpret(kernel_route):
    """One FrankaReachMA step on the port's B4 route (capacity 24 and row
    reuse set, as configured) against the JAX kernel route."""
    tt = _port_task(kernel_route["n"])
    assert tt.engine.cplan is not None
    assert tt.sim_params.contact_capacity == 24
    assert tt.sim_params.reuse_contact_rows
    assert tt.engine.cplan.P == 41          # every candidate row
    ts2, tres = tt.step(kernel_route["port_state"],
                        torch.as_tensor(kernel_route["acts"]),
                        reset_draws=kernel_route["draws"])
    ref = kernel_route["ref"]
    np.testing.assert_allclose(ts2.sim.q.numpy(), ref["q"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ts2.sim.qd.numpy(), ref["qd"],
                               rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(tres.obs.numpy(), ref["obs"],
                               rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(tres.rew.numpy(), ref["rew"],
                               rtol=3e-3, atol=3e-3)
    np.testing.assert_array_equal(tres.reset.numpy(), ref["reset"])
    # the step reset the flagged envs and moved the others
    flagged = np.asarray(kernel_route["port_state"].reset_buf.numpy(), bool)
    assert flagged.sum() == kernel_route["n"] // 4
    assert float(np.abs(ref["qd"][~flagged]).max()) > 1e-3


def test_franka_kernel_route_ignores_capacity_and_reuse(kernel_route):
    """The B4 route's step is the same bit for bit with and without
    ``contact_capacity`` and ``reuse_contact_rows``."""
    state = kernel_route["port_state"]
    acts = torch.as_tensor(kernel_route["acts"])
    out = [_port_task(kernel_route["n"], **kw).step(
        state, acts, reset_draws=kernel_route["draws"])
        for kw in ({}, {"contact_capacity": None,
                        "reuse_contact_rows": False})]
    (a, ra), (b, rb) = out
    assert torch.equal(a.sim.q, b.sim.q) and torch.equal(a.sim.qd, b.sim.qd)
    assert torch.equal(ra.obs, rb.obs) and torch.equal(ra.rew, rb.rew)
