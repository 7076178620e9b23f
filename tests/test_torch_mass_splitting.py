"""The port's engine with Jacobi mass splitting and dof dry friction against
the JAX engine, on the ShadowHand and AllegroHand scenes (CPU, float32).

Each scene's model goes to the JAX package through ``model_to_spec`` /
``model_from_spec`` with the task's SimParams (mass splitting, 32 of 60 /
44 candidate rows, rows reused over 2 substeps, 16 iterations) and pair
list, at 8 envs.  Both engines step 3 control steps from the same
warmed-up state (the first 8 envs of the scene's golden capture: the cube
resting in the hand) under the same torques tau ~ 0.05 N(0, 1) from a
numpy seed.  Bounds are the ground rule: q rtol 2e-4 / atol 2e-5, qd
2e-3, held without widening by the reference's one-ulp spread: over the
3 steps the port's errors were q <= 9.5e-6, qd <= 1.1e-3 at ShadowHand
and q <= 1.2e-6, qd <= 2.3e-4 at AllegroHand.  Without mass splitting qd
misses by 6.5 / 3.2, without AllegroHand's dof friction by 3.0.  The
first eager JAX step of a scene costs ~25 s, so each scene is built and
stepped once per file.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from isaacgymenvs_ma_tpu.models.model import model_from_spec as jmodel_from_spec
from isaacgymenvs_ma_tpu.physics.engine import Control as JControl
from isaacgymenvs_ma_tpu.physics.engine import PhysicsEngine as JEngine
from isaacgymenvs_ma_tpu.physics.engine import SimParams as JSimParams
from isaacgymenvs_ma_tpu.physics.engine import SimState as JSimState
from isaacgymenvs_ma_tpu.utils.domain_rand import PhysScales as JPhysScales
from isaacgymenvs_ma_tpu_torch.models.model import model_to_spec
from isaacgymenvs_ma_tpu_torch.physics import contact_kernel as ck
from isaacgymenvs_ma_tpu_torch.physics.engine import (Control, PhysicsEngine,
                                                      SimState,
                                                      solver_rows_bf16,
                                                      takes_contact_kernel)
from isaacgymenvs_ma_tpu_torch.tasks import registry
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.utils.domain_rand import PhysScales

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
N, STEPS = 8, 3
Q_RTOL, Q_ATOL, QD_ATOL = 2e-4, 2e-5, 2e-3
CAPTURE = {"ShadowHand": "shadow_hand_golden.npz",
           "AllegroHand": "allegro_hand_golden.npz"}


def _port_engine(task, **changes):
    return PhysicsEngine(task.model, task.sim_params._replace(**changes),
                         pair_specs=task.contact_pairs(task.model),
                         device="cpu")


def _run_port(engine, q0, qd0, taus, phys=None):
    """The port's 3 steps; also every solve's (active, row_scale)."""
    scales = []
    split = engine.mass_split_scale

    def spy(active, sel, frames):
        rs = split(active, sel, frames)
        scales.append((active.clone(), rs.clone()))
        return rs

    engine.mass_split_scale = spy
    sim = SimState(torch.as_tensor(q0), torch.as_tensor(qd0))
    out = []
    for tau in taus:
        sim, _ = engine.step(sim, Control(tau=torch.as_tensor(tau)), phys=phys)
        out.append((sim.q.numpy().copy(), sim.qd.numpy().copy()))
    return out, scales


def _run_jax(engine, q0, qd0, taus, phys=None):
    sim = JSimState(jnp.asarray(q0), jnp.asarray(qd0))
    out = []
    for tau in taus:
        sim, _ = engine.step(sim, JControl(tau=jnp.asarray(tau)), phys=phys)
        out.append((np.asarray(sim.q), np.asarray(sim.qd)))
    return out


def _excess(got, ref):
    """The largest error beyond the bounds over the steps (<= 0: held)."""
    worst = -np.inf
    for (gq, gqd), (rq, rqd) in zip(got, ref):
        worst = max(worst,
                    float(np.max(np.abs(gq - rq) - (Q_ATOL + Q_RTOL
                                                    * np.abs(rq)))),
                    float(np.max(np.abs(gqd - rqd) - QD_ATOL)))
    return worst


@pytest.fixture(scope="module", params=["ShadowHand", "AllegroHand"])
def scene(request):
    name = request.param
    cfg = deep_merge(registry.task_default_config(name),
                     {"env": {"numEnvs": N}})
    task = registry.create_task(name, cfg, device="cpu")
    pr = task.sim_params
    jparams = JSimParams(**pr._asdict())
    jeng = JEngine(jmodel_from_spec(model_to_spec(task.model)), jparams,
                   ground=True, pair_specs=task.contact_pairs(task.model))
    d = np.load(os.path.join(DATA, CAPTURE[name]))
    q0, qd0 = d["start_q"][0][:N], d["start_qd"][0][:N]
    g = np.random.default_rng(5)
    taus = [(0.05 * g.normal(size=(N, task.engine.nv))).astype(np.float32)
            for _ in range(STEPS)]
    return dict(name=name, task=task, jeng=jeng, q0=q0, qd0=qd0, taus=taus,
                ref=_run_jax(jeng, q0, qd0, taus))


def test_scene_takes_the_loop_with_mass_splitting(scene):
    """The hands split masses: their SimParams ask for it, and the engine
    runs the batched-product loop (no bf16 rows: 32 x 30 = 960 and 32 x 22
    = 704 stay below the auto rule's 1024)."""
    task = scene["task"]
    pr = task.sim_params
    assert pr.mass_splitting and pr.contact_capacity == 32
    assert task.engine.contact_route == "loop"
    rows = task.engine.n_ground + task.engine.n_pair_rows
    assert rows == {"ShadowHand": 60, "AllegroHand": 44}[scene["name"]]
    assert not solver_rows_bf16(task.model, pr, rows)
    assert task.engine.has_dof_friction == (scene["name"] == "AllegroHand")


def test_engine_matches_jax_with_mass_splitting(scene):
    """3 steps against the JAX engine at the ground-rule bounds; some
    active row is scaled below 1 in every solve of the first step."""
    got, scales = _run_port(_port_engine(scene["task"]), scene["q0"],
                            scene["qd0"], scene["taus"])
    for (gq, gqd), (rq, rqd) in zip(got, scene["ref"]):
        np.testing.assert_allclose(gq, rq, rtol=Q_RTOL, atol=Q_ATOL)
        np.testing.assert_allclose(gqd, rqd, rtol=0, atol=QD_ATOL)
    assert len(scales) == 2 * STEPS
    for active, rs in scales:
        assert rs.shape == active.shape
        assert bool((rs[active] < 1.0).any())
        assert bool((rs <= 1.0).all() and (rs > 0.0).all())


def test_turning_a_feature_off_breaks_the_match(scene):
    """Not vacuous: the same steps without mass splitting (and, at
    AllegroHand, without its dof friction) miss the JAX result by more
    than the bounds."""
    task = scene["task"]
    got, scales = _run_port(_port_engine(task, mass_splitting=False),
                            scene["q0"], scene["qd0"], scene["taus"])
    assert not scales
    assert _excess(got, scene["ref"]) > 0.0
    if scene["name"] == "AllegroHand":
        eng = _port_engine(task)
        eng.dof_friction = torch.zeros_like(eng.dof_friction)
        eng.has_dof_friction = False
        got, _ = _run_port(eng, scene["q0"], scene["qd0"], scene["taus"])
        assert _excess(got, scene["ref"]) > 0.0


def test_contact_kernel_request_takes_the_loop(scene, monkeypatch):
    """``use_contact_kernel`` with mass splitting takes the batched loop,
    as the JAX engine's route rule does (engine.py:1290): no B4 plan, no
    B4 launch or twin, and the default route's result bit for bit."""
    task = scene["task"]
    eng = _port_engine(task, use_contact_kernel=True)
    assert not takes_contact_kernel(eng.params)
    assert eng.cplan is None and eng.contact_route == "loop"

    def refuse(*a, **k):
        raise AssertionError("B4 or its twin called on a mass-split scene")

    monkeypatch.setattr(ck, "solve", refuse)
    monkeypatch.setattr(ck, "solve_bl", refuse)
    steps = scene["taus"][:1]
    got, _ = _run_port(eng, scene["q0"], scene["qd0"], steps)
    ref, _ = _run_port(_port_engine(task), scene["q0"], scene["qd0"], steps)
    assert np.array_equal(got[0][0], ref[0][0])
    assert np.array_equal(got[0][1], ref[0][1])


def test_dof_property_leaves_match_jax(scene):
    """The ``armature``, ``effort`` and ``joint_friction`` physics-scale
    leaves (seeded per env and per dof, 0.5-1.5) against the JAX engine's
    PhysScales leaves, one step under torques tau ~ N(0, 1), large enough
    to meet the scaled effort limits (0.5 N m at AllegroHand), at the
    ground-rule bounds.  At ShadowHand (no dof friction) the
    joint-friction scale turns the friction term on at zero friction, as
    in JAX.  Without the armature or effort leaf the port misses the
    scaled JAX step, and at AllegroHand without the joint-friction leaf
    too."""
    task = scene["task"]
    nv = task.engine.nv
    g = np.random.default_rng(9)
    names = ("armature", "effort", "joint_friction")
    leaves = {k: g.uniform(0.5, 1.5, (N, nv)).astype(np.float32)
              for k in names}
    ones = np.ones((N, 1), np.float32)
    jphys = JPhysScales(*(jnp.asarray(ones),) * 4,
                        **{k: jnp.asarray(v) for k, v in leaves.items()})
    tphys = PhysScales(*(torch.as_tensor(ones),) * 4,
                       **{k: torch.as_tensor(v) for k, v in leaves.items()})
    taus = [g.normal(size=(N, nv)).astype(np.float32)]
    ref = _run_jax(scene["jeng"], scene["q0"], scene["qd0"], taus, jphys)
    got, _ = _run_port(_port_engine(task), scene["q0"], scene["qd0"], taus,
                       tphys)
    np.testing.assert_allclose(got[0][0], ref[0][0], rtol=Q_RTOL, atol=Q_ATOL)
    np.testing.assert_allclose(got[0][1], ref[0][1], rtol=0, atol=QD_ATOL)
    matter = names if scene["name"] == "AllegroHand" else names[:2]
    for k in matter:
        without, _ = _run_port(_port_engine(task), scene["q0"], scene["qd0"],
                               taus, tphys._replace(**{k: None}))
        assert _excess(without, ref) > 0.0, k
