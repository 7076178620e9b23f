"""Port parity of the batch-last twins of kernels B1-B3
(isaacgymenvs_ma_tpu_torch/physics/dyn_kernel.py) against the JAX kernel
bodies (isaacgymenvs_ma_tpu/physics/dyn_kernel.py), and of the port's
reference-layout engine pieces against the JAX engine's.

Inputs: Ant at 8 and 128 envs on a generic state after a few JAX steps,
handed to both sides as numpy.  Tolerances are those of the JAX package's
own kernel parity tests (tests/test_dyn_kernel.py:67-75, :220-222).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.physics import dyn_kernel as jdk
from isaacgymenvs_ma_tpu.tasks.ant import Ant as JAnt, TASK_CFG as JCFG
from isaacgymenvs_ma_tpu.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.physics import _build
from isaacgymenvs_ma_tpu_torch.physics import dyn_kernel as tdk
from isaacgymenvs_ma_tpu_torch.tasks.ant import Ant, TASK_CFG

torch.set_num_threads(1)   # small CPU ops: one thread a test worker


@pytest.fixture(scope="module", params=[8, 128])
def scene(request):
    n = request.param
    jt = JAnt(deep_merge(JCFG, {"env": {"numEnvs": n}}))
    tt = Ant(deep_merge(TASK_CFG, {"env": {"numEnvs": n}}), device="cpu")
    st = jt.initial_state(jax.random.PRNGKey(3))
    acts = jnp.asarray(np.random.default_rng(n).uniform(
        -1, 1, (n, 8)).astype(np.float32))
    step = jax.jit(jt.step)
    for _ in range(4):                   # generic state: contacts, velocities
        st, _ = step(st, acts)
    rng = np.random.default_rng(7 + n)
    data = {
        "q": np.array(st.sim.q), "qd": np.array(st.sim.qd),
        "rhs": rng.normal(size=(n, 14)).astype(np.float32),
        "diag": np.broadcast_to(np.asarray(jt.engine.dof_armature) + 0.1,
                                (n, 14)).astype(np.float32),
        "mass_scale": rng.uniform(0.6, 1.5, (n, 9)).astype(np.float32),
        "shape_scale": rng.uniform(0.7, 1.4, (n, 9, 3)).astype(np.float32),
    }
    bx, bq = jt.engine.fk(jnp.asarray(data["q"]))
    data["body_x"], data["body_q"] = np.array(bx), np.array(bq)
    data["S"] = np.array(jt.engine.dof_motion(bx, bq))
    data["fg"] = np.array(jt.engine.gravity_wrench(bx, bq))
    return jt, tt, data


def _bl(x):
    """numpy standard layout (N, ...) -> batch-last (..., N)."""
    return np.ascontiguousarray(np.moveaxis(x, 0, -1))


def _j(x):
    return jnp.asarray(_bl(x))


def _t(x):
    return torch.as_tensor(_bl(x))


def _jconsts(jt):
    return {k: jnp.asarray(v)
            for k, v in jdk.get_plan(jt.engine).consts().items()}


def test_fk_motion_twin_matches_jax(scene):
    jt, tt, d = scene
    ref = jdk._fk_motion_bl(jt.engine, jdk.get_plan(jt.engine), _j(d["q"]))
    got = tdk._fk_motion_bl(tt.engine.plan, _t(d["q"]))
    for r, g in zip(ref, got, strict=True):
        assert float(np.abs(g.numpy() - np.asarray(r)).max()) < 1e-5
    # ... and the JAX reference-layout fk / dof_motion
    for r, g in zip((d["body_x"], d["body_q"], d["S"]), got, strict=True):
        assert float(np.abs(g.numpy() - _bl(r)).max()) < 1e-5


def test_fk_motion_wrapper_runs_twin_on_cpu(scene):
    _, tt, d = scene
    before = tdk.fk_motion.launches
    got = tdk.fk_motion(tt.engine.plan, _t(d["q"]))
    assert tdk.fk_motion.launches == before      # CPU twin launches nothing
    assert [tuple(g.shape) for g in got] == [
        (9, 3, d["q"].shape[0]), (9, 4, d["q"].shape[0]),
        (14, 6, d["q"].shape[0])]


def test_engine_fk_matches_jax(scene):
    _, tt, d = scene
    bx, bq = tt.engine.fk(torch.as_tensor(d["q"]))
    S = tt.engine.dof_motion(bx, bq)
    for r, g in ((d["body_x"], bx), (d["body_q"], bq), (d["S"], S)):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scales", [False, True])
def test_dyn_forward_twin_matches_jax(scene, scales):
    jt, tt, d = scene
    args = [d[k] for k in ("body_x", "body_q", "S", "qd", "rhs", "diag")]
    extra = [d["mass_scale"], d["shape_scale"]] if scales else []
    ref = jdk.dyn_full_bl(jdk.get_plan(jt.engine), _jconsts(jt),
                          *(_j(a) for a in args + extra))
    got = tdk.dyn_forward(tt.engine.plan, *(_t(a) for a in args + extra))
    qdd, hinv, io = (g.numpy() for g in got)
    np.testing.assert_allclose(io, np.asarray(ref[2]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hinv, np.asarray(ref[1]), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(qdd, np.asarray(ref[0]), rtol=2e-4, atol=2e-4)


def test_dyn_cached_twin_matches_jax(scene):
    jt, tt, d = scene
    plan_j = jdk.get_plan(jt.engine)
    _, hinv, io = jdk.dyn_full_bl(
        plan_j, _jconsts(jt),
        *(_j(d[k]) for k in ("body_x", "body_q", "S", "qd", "rhs", "diag")))
    ref = jdk.dyn_cached_bl(plan_j, _jconsts(jt), _j(d["S"]), _j(d["qd"]),
                            _j(d["rhs"]), io, hinv, _j(d["fg"]))
    got = tdk.dyn_cached(tt.engine.plan, _t(d["S"]), _t(d["qd"]),
                         _t(d["rhs"]), torch.as_tensor(np.array(io)),
                         torch.as_tensor(np.array(hinv)), _t(d["fg"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_twin_chain_matches_reference_layout(scene):
    """The port's batch-last chain against its own reference-layout pieces
    (spatial_inertia, mass_matrix, bias_force, an LU inverse) — the port
    counterpart of tests/test_dyn_kernel.py::test_chain_parity."""
    _, tt, d = scene
    eng = tt.engine
    bx, bq, S, qd, rhs, diag = (torch.as_tensor(d[k]) for k in (
        "body_x", "body_q", "S", "qd", "rhs", "diag"))
    I_O, _ = eng.spatial_inertia(bx, bq)
    M = eng.mass_matrix(S, I_O)
    C = eng.bias_force(S, qd, eng.body_velocities(S, qd), I_O)
    Hinv_ref = torch.linalg.inv(M + torch.diag_embed(diag))
    qdd_ref = torch.einsum("nij,nj->ni", Hinv_ref, rhs - C)
    qdd, hinv, io = tdk.dyn_forward(eng.plan, *(_t(d[k]) for k in (
        "body_x", "body_q", "S", "qd", "rhs", "diag")))
    np.testing.assert_allclose(np.moveaxis(io.numpy(), -1, 0), I_O.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.moveaxis(hinv.numpy(), -1, 0),
                               Hinv_ref.numpy(), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(qdd.numpy().T, qdd_ref.numpy(),
                               rtol=2e-4, atol=2e-4)
    # reference-layout pieces against the JAX engine's
    I_j, _ = scene[0].engine.spatial_inertia(jnp.asarray(d["body_x"]),
                                             jnp.asarray(d["body_q"]))
    np.testing.assert_allclose(I_O.numpy(), np.asarray(I_j),
                               rtol=1e-5, atol=1e-5)
    fg = eng.gravity_wrench(bx, bq)
    np.testing.assert_allclose(fg.numpy(), d["fg"], rtol=1e-5, atol=1e-5)


def test_sweep_inverse_matches_jax():
    from isaacgymenvs_ma_tpu.physics.engine import _sweep_inverse_batchlast
    rng = np.random.default_rng(0)
    A = rng.normal(size=(16, 14, 14)).astype(np.float32)
    H = A @ np.swapaxes(A, -1, -2) + 14 * np.eye(14, dtype=np.float32)
    ref = np.asarray(_sweep_inverse_batchlast(jnp.asarray(_bl(H))))
    got = tdk.sweep_inverse_bl(torch.as_tensor(_bl(H))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.moveaxis(got, -1, 0), np.linalg.inv(H),
                               rtol=1e-3, atol=1e-5)


def test_wrappers_reject_mixed_and_unknown_devices(scene):
    """A tensor that is neither all-CPU nor all-CUDA never reaches a twin."""
    _, tt, d = scene
    with pytest.raises(ValueError):
        tdk.fk_motion(tt.engine.plan, _t(d["q"]).to("meta"))
    args = [_t(d[k]) for k in ("body_x", "body_q", "S", "qd", "rhs", "diag")]
    args[3] = args[3].to("meta")
    with pytest.raises(ValueError):
        tdk.dyn_forward(tt.engine.plan, *args)


def test_scene_header_bakes_the_tree(scene):
    _, tt, _ = scene
    plan = tt.engine.plan
    h = tdk.scene_header(plan)
    assert "constexpr int NB = 9;" in h and "constexpr int NV = 14;" in h
    assert "constexpr int NQ = 15;" in h
    parent = ", ".join(str(int(p)) for p in plan.parent)
    assert f"__device__ const int b2_parent[9] = {{{parent}}};" in h
    # the float tables round-trip to the plan's float32 constants: B2's
    # masses, and B1's joint constants packed end to end
    import re

    def floats(name):
        m = re.search(rf"const float {name}\[\d+\] = \{{([^}}]*)\}}", h)
        return np.array([float(v.rstrip("f")) for v in m.group(1).split(",")],
                        np.float32)

    np.testing.assert_array_equal(floats("b2_mass"), plan.mass)
    b1 = floats("b1_ftab")
    for name, vals in (("TL0", [c["tl0"] for c in plan.fk]),
                       ("PITCH", [c["pitch"] for c in plan.fk])):
        vals = np.asarray(vals, np.float32).reshape(-1)
        off = int(re.search(rf"constexpr int B1T_{name} = (\d+);",
                            h).group(1))
        np.testing.assert_array_equal(b1[off:off + vals.size], vals,
                                      err_msg=name)
    # the build key follows the header
    assert (_build.lib_dir("fk_motion", h)
            != _build.lib_dir("fk_motion", h + "// other scene\n"))


def test_build_without_nvcc_raises(scene, monkeypatch):
    """No nvcc: the build raises; nothing falls back to the twin."""
    _, tt, _ = scene
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build, "NVCC_DEFAULT", "/nonexistent/nvcc")
    plan = tdk.DynPlan(tt.engine)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(plan)
