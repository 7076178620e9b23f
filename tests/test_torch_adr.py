"""The port's ADR (isaacgymenvs_ma_tpu_torch/utils/adr.py) against the JAX
package's (isaacgymenvs_ma_tpu/utils/adr.py) on the same inputs: the cases
of tests/test_adr.py (boundary workers, queue-triggered expansion and
contraction, the hard limits, full and partial queues, the npd metric,
the config tree), each held at 1e-6.  ``sample`` gets the JAX draw's
uniforms injected.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.utils import adr as jadr
from isaacgymenvs_ma_tpu_torch.utils import adr as tadr

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(num_envs=64, queue_size=8):
    kw = dict(names=("a", "b"), init_lo=(0.9, 0.8), init_hi=(1.1, 1.2),
              limit_lo=(0.5, 0.5), limit_hi=(1.5, 1.5), delta=(0.1, 0.1),
              queue_size=queue_size, threshold_low=0.1, threshold_high=0.5,
              worker_fraction=0.5)
    return (jadr.ADR(jadr.ADRConfig(**kw), num_envs),
            tadr.ADR(tadr.ADRConfig(**kw), num_envs))


def _to_jax(st):
    return jadr.ADRState(*(jnp.asarray(x.numpy()) for x in st))


def _close(tst, jst):
    for f in tadr.ADRState._fields:
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)), **TOL,
                                   err_msg=f)


def test_worker_assignment_and_init_match_jax():
    ja, ta = _pair(num_envs=37)
    np.testing.assert_array_equal(ta.assign_p, np.asarray(ja.assign_p))
    np.testing.assert_array_equal(ta.assign_s, np.asarray(ja.assign_s))
    np.testing.assert_array_equal(ta.is_worker.numpy(),
                                  np.asarray(ja.is_worker))
    _close(ta.init(), ja.init())


def test_sample_with_injected_uniforms():
    """Regular envs uniform in range, boundary workers pinned at their
    boundary, on ranges moved off their initial values."""
    ja, ta = _pair()
    st = ta.init()._replace(ranges=torch.tensor([[0.7, 1.3], [0.6, 1.0]]))
    key = jax.random.PRNGKey(0)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (64, 2))))
    got = ta.sample(st, u=u)
    want = ja.sample(key, _to_jax(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # pinned workers sit exactly on their boundary
    for e in range(64):
        if ta.assign_p[e] >= 0:
            assert float(got[e, ta.assign_p[e]]) == float(
                st.ranges[ta.assign_p[e], ta.assign_s[e]])
    # drawn from a generator instead: within the ranges
    g = torch.Generator().manual_seed(1)
    v = ta.sample(st, g)
    assert (v >= st.ranges[:, 0] - 1e-6).all()
    assert (v <= st.ranges[:, 1] + 1e-6).all()


@pytest.mark.parametrize("case", ["expand", "contract", "partial",
                                  "mixed"])
def test_observe_matches_jax(case):
    """``expand``: every env done with performance 1 (>= the high
    threshold, the queues fill at 4); ``contract``: performance 0;
    ``partial``: a queue of 100 that does not fill; ``mixed``: seeded done
    masks and performances over 12 calls, some queues filling."""
    queue = {"expand": 4, "contract": 4, "partial": 100, "mixed": 6}[case]
    ja, ta = _pair(queue_size=queue)
    js, ts = ja.init(), ta.init()
    g = np.random.default_rng(3)
    for _ in range(12 if case == "mixed" else 1):
        if case == "mixed":
            done = g.uniform(size=64) < 0.4
            perf = g.uniform(0.0, 0.7, 64).astype(np.float32)
        else:
            done = np.ones(64, bool)
            perf = np.full(64, 0.0 if case == "contract" else 1.0,
                           np.float32)
        js = ja.observe(js, jnp.asarray(done), jnp.asarray(perf))
        ts = ta.observe(ts, torch.as_tensor(done), torch.as_tensor(perf))
        _close(ts, js)
    if case == "expand":
        assert (ts.num_updates == 1).all() and (ts.perf_cnt == 0).all()
    if case == "partial":
        assert torch.equal(ts.ranges, ta.init().ranges)
        assert float(ts.perf_cnt.sum()) > 0


def test_expansion_saturates_at_the_limits_and_npd():
    ja, ta = _pair(queue_size=4)
    js, ts = ja.init(), ta.init()
    done = np.ones(64, bool)
    for _ in range(20):
        js = ja.observe(js, jnp.asarray(done), jnp.ones(64))
        ts = ta.observe(ts, torch.as_tensor(done), torch.ones(64))
    _close(ts, js)
    assert torch.allclose(ts.ranges[:, 0], torch.tensor(0.5))
    assert float(ta.npd(ts)) == float(ja.npd(js)) == 1.0
    mid = ta.init()
    np.testing.assert_allclose(float(ta.npd(mid)),
                               float(ja.npd(_to_jax(mid))), **TOL)


def test_adr_config_from_params_matches_jax():
    """The reference tree (AllegroHandDextremeADR.yaml:227-422 schema) and
    the Dextreme task's full 27-parameter tree."""
    from isaacgymenvs_ma_tpu.tasks.allegro_hand_dextreme import (
        DEFAULT_ADR_PARAMS as JPARAMS)
    from isaacgymenvs_ma_tpu_torch.tasks.allegro_hand_dextreme import (
        DEFAULT_ADR_PARAMS)
    assert DEFAULT_ADR_PARAMS == JPARAMS
    tree = {"worker_adr_boundary_fraction": 0.4,
            "adr_queue_threshold_length": 256,
            "adr_objective_threshold_low": 5,
            "adr_objective_threshold_high": 20,
            "params": {"hand_damping": {"init_range": [0.5, 2.0],
                                        "limits": [0.01, 20.0],
                                        "delta": 0.01},
                       "action_latency": {"init_range": [0.0, 0.0],
                                          "limits": [0.0, 6.0]}}}
    for t in (tree, dict(tree, params=DEFAULT_ADR_PARAMS)):
        got = tadr.adr_config_from_params(t)
        assert tuple(got) == tuple(jadr.adr_config_from_params(t))
    assert len(tadr.adr_config_from_params(
        {"params": DEFAULT_ADR_PARAMS}).names) == 27


def test_phys_adr_matches_jax():
    ja, ta = jadr.phys_adr(32), tadr.phys_adr(32)
    assert tuple(ta.cfg) == tuple(ja.cfg)
    key = jax.random.PRNGKey(1)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (32, 4))))
    got = ta.sample_phys(ta.init(), u=u)
    want = ja.sample_phys(key, ja.init())
    for f in ("mass", "damping", "stiffness", "friction"):
        assert getattr(got, f).shape == (32, 1)
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TOL)
