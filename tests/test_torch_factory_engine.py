"""The engine features of the Factory slice against the JAX engine, on the
small synthetic scene of ``utils/parity.py`` (``factory_engine_scene``):
contact warm start, per-body rigid damping, bfloat16 solver rows (the auto
rule on and off), SDF-grid pair targets, and all of them with active-set
compaction.  Each case steps the port's engine from the recorded start
under the recorded torques and is held at the ground rule (q atol 2e-5,
qd 2e-3, the warm-start impulses 2e-5) at every step against
``tests/data/torch_port/factory_engine.npz``, which
``scripts/record_torch_golden.py --factory-engine`` records from the JAX
engine on the same scene.  No JAX step runs here.
"""
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu_torch.models import model as md
from isaacgymenvs_ma_tpu_torch.physics import engine as teng
from isaacgymenvs_ma_tpu_torch.utils import parity

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

DATA = "tests/data/torch_port/factory_engine.npz"
Q_TOL, QD_TOL, LAM_TOL = 2e-5, 2e-3, 2e-5


@pytest.fixture(scope="module")
def capture():
    return np.load(DATA)


def _run(case):
    fields, damping = parity.FACTORY_ENGINE_CASES[case]
    model, pairs = parity.factory_engine_scene(md, damping)
    q0, qd0, tau = parity.factory_engine_start(model,
                                               parity.FACTORY_ENGINE_ENVS)
    eng = teng.PhysicsEngine(
        model, teng.SimParams(**parity.factory_engine_params(fields)),
        ground=True, pair_specs=pairs, device="cpu")
    st = teng.SimState(torch.tensor(q0), torch.tensor(qd0),
                       eng.zero_warm(len(q0)))
    states = []
    for t in range(len(tau)):
        st, _ = eng.step(st, teng.Control(tau=torch.tensor(tau[t])))
        states.append(st)
    return eng, states


@pytest.mark.parametrize("case", sorted(parity.FACTORY_ENGINE_CASES))
def test_engine_case_matches_jax(case, capture):
    """Every step of the case at the ground rule, on the loop (warm start
    and mass splitting keep it off B4, as in JAX), the bf16 rule as JAX's
    auto rule reads the scene."""
    eng, states = _run(case)
    fields, damping = parity.FACTORY_ENGINE_CASES[case]
    assert eng.contact_route == "loop"
    assert not teng.takes_contact_kernel(
        eng.params._replace(use_contact_kernel=True))
    assert eng.has_body_damping == damping
    want_bf16 = fields["solver_rows_bf16"]
    if want_bf16 is None:      # 96 rows x nv 13 reach the auto rule
        want_bf16 = True
    assert eng.rows_bf16 == want_bf16
    for t, st in enumerate(states):
        np.testing.assert_allclose(st.q.numpy(), capture[f"{case}_q"][t],
                                   atol=Q_TOL, rtol=0)
        np.testing.assert_allclose(st.qd.numpy(), capture[f"{case}_qd"][t],
                                   atol=QD_TOL, rtol=0)
        if fields["warm_start"] > 0:
            for i in range(3):
                np.testing.assert_allclose(
                    st.lam[i].numpy(), capture[f"{case}_lam_{i}"][t],
                    atol=LAM_TOL, rtol=0)
        else:
            assert st.lam is None


def test_features_change_the_result(capture):
    """Each feature moves the JAX trajectory by more than the bound that
    holds the port to it, so the cases above tell a missing feature apart:
    warm start and damping against the plain case, the bfloat16 rounding
    after one iteration (over 16 iterations a rounding that summation
    order flips grows to the rounding's own size)."""
    def gap(a, b):
        return np.abs(capture[f"{a}_qd"] - capture[f"{b}_qd"]).max()

    assert gap("warm_start", "bf16_off") > 5 * QD_TOL
    assert gap("damping", "bf16_off") > 5 * QD_TOL
    assert gap("bf16_one_iteration", "f32_one_iteration") > 5 * QD_TOL
    # the warm-start impulses are live: most resting rows carry some
    lam = capture["warm_start_lam_0"][-1]
    assert (np.abs(lam[..., 2]) > 0).sum() >= 16 * parity.FACTORY_ENGINE_ENVS


def test_sdf_pair_rows_sample_the_grid():
    """Block A's pair rows read the plate's baked grid (its top face at
    z = 0.07): gaps are the points' heights above it, normals +z."""
    model, pairs = parity.factory_engine_scene(md, False)
    eng = teng.PhysicsEngine(
        model, teng.SimParams(**parity.factory_engine_params(
            dict(warm_start=0.0, solver_rows_bf16=False))),
        pair_specs=pairs, device="cpu")
    assert eng.pairs[0]["grid"] is not None
    q0, _, _ = parity.factory_engine_start(model, 2)
    body_x, body_q, _, _ = eng.kinematics(torch.tensor(q0))
    p, phi, _, n = eng._pair_rows(body_x, body_q)
    bottom = np.arange(16)             # the cloud's bottom face first
    np.testing.assert_allclose(phi[:, bottom].numpy(),
                               p[:, bottom, 2].numpy() - 0.07, atol=1e-4)
    np.testing.assert_allclose(n[:, bottom, 2].numpy(), 1.0, atol=1e-3)


def test_zero_warm_and_route():
    """``zero_warm`` (engine.py:2147-2156): zeros at the candidate rows
    with warm start, None without; a warm-start engine never plans B4."""
    model, pairs = parity.factory_engine_scene(md, False)
    mk = lambda **f: teng.PhysicsEngine(  # noqa: E731
        model, teng.SimParams(**parity.factory_engine_params(
            dict(solver_rows_bf16=False, **f))),
        pair_specs=pairs, device="cpu")
    eng = mk(warm_start=0.9, use_contact_kernel=True)
    lam = eng.zero_warm(3)
    assert [tuple(x.shape) for x in lam] == [(3, 96, 3), (3, 13), (3, 13)]
    assert all(float(x.abs().sum()) == 0.0 for x in lam)
    assert eng.cplan is None and eng.contact_route == "loop"
    assert eng.default_state(3).lam is not None
    cold = mk(warm_start=0.0, mass_splitting=False, use_contact_kernel=True)
    assert cold.zero_warm(3) is None and cold.contact_route == "b4"
