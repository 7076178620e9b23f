"""Port parity of kernel B4's twin and wrapper
(isaacgymenvs_ma_tpu_torch/physics/contact_kernel.py) against the JAX
contact kernel (isaacgymenvs_ma_tpu/physics/contact_kernel.py).

Inputs are made from a seed with numpy and handed to both sides: nv 7,
contact rows P 5, attractors A 2, grabs G 2, a random SPD H^-1, Delassus
diagonals consistent with it, with and without row frames.  Tolerance
rtol = atol = 1e-4 for the twin against JAX ``solve_bl`` (the same
arithmetic in float32; only sum orders differ) and for the wrapper against
``solve_pallas`` in interpret mode (standard layout in and out).  The CUDA
kernel itself is held against the twin on the card by chip_smoke.py.
"""
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.physics import contact_kernel as jck
from isaacgymenvs_ma_tpu.physics import dyn_kernel as jdk
from isaacgymenvs_ma_tpu_torch.physics import _build
from isaacgymenvs_ma_tpu_torch.physics import contact_kernel as ck

NV, P, A, G = 7, 5, 2, 2
PARAMS = SimpleNamespace(relaxation=0.35, num_iterations=8)


def make_case(B, frames, groups, seed=0):
    """Batch-last, component-leading numpy inputs of ``solve_bl``."""
    g = np.random.default_rng(seed)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    masks = {k: f32(g.choice([-1.0, 0.0, 0.0, 1.0], (r, NV)))
             for k, r in (("c", P), ("a", A), ("g", G)) if k in groups}
    M = g.normal(size=(B, NV, NV)) / np.sqrt(NV)
    Hinv = f32(np.moveaxis(M @ np.swapaxes(M, 1, 2) + 0.5 * np.eye(NV), 0, -1))
    S = f32(g.normal(size=(NV, 6, B)))
    d = dict(S=S, Hinv=Hinv, qd=f32(g.normal(size=(NV, B))),
             pts_c=f32(g.uniform(-1, 1, (3, P, B))),
             b_n=f32(g.uniform(0, 1, (P, B))),
             mu=f32(g.uniform(0.5, 1.0, (P, B))),
             active=f32(g.uniform(size=(P, B)) < 0.7),
             b_lo=f32(g.uniform(0, 1, (NV, B))),
             b_hi=f32(g.uniform(0, 1, (NV, B))),
             act_lo=f32(g.uniform(size=(NV, B)) < 0.3),
             act_hi=f32(g.uniform(size=(NV, B)) < 0.3), frames=None)
    if frames:
        Q, _ = np.linalg.qr(g.normal(size=(B, P, 3, 3)))
        d["frames"] = f32(np.moveaxis(Q, (0, 1), (-1, -2)))   # (3, 3, P, B)
    for k, r in (("a", A), ("g", G)):
        if k in groups:
            d[f"pts_{k}"] = f32(g.uniform(-1, 1, (3, r, B)))
            d[f"b_{k}"] = f32(g.normal(size=(3, r, B)))
    if "g" in groups:
        d["g_act"] = f32(g.uniform(size=(G, B)) < 0.5)
    # Delassus diagonals w = J_l . (H^-1 J_l) of the (frame-projected) rows
    for k in masks:
        J = np.asarray(jck._row_jacobian(jnp.asarray(S), jnp.asarray(
            d[f"pts_{k}"]), jnp.asarray(masks[k])))
        if k == "c" and frames:
            J = np.einsum("ckvb,clkb->lkvb", J, d["frames"])
        HJ = np.einsum("ivb,ckvb->ckib", Hinv, J)
        d[f"w_{k}"] = f32(np.maximum((J * HJ).sum(2), 1e-8))
    return masks, d


def plan_of(masks, frames):
    return ck.ContactPlan(masks, NV, PARAMS.num_iterations, PARAMS.relaxation,
                          has_frames=frames)


GROUPS = {"all": ("c", "a", "g"), "contacts": ("c",)}


@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("frames", [False, True], ids=["world", "frames"])
def test_twin_matches_jax_solve_bl(frames, groups):
    """solve_bl twin against the JAX kernel body, every group in order
    (grabs -> attractors -> contacts -> limits)."""
    masks, d = make_case(16, frames, GROUPS[groups])
    keys = ("pts_c", "b_n", "mu", "active", "frames", "w_c", "b_lo", "b_hi",
            "act_lo", "act_hi", "pts_a", "b_a", "w_a", "pts_g", "b_g",
            "g_act", "w_g")
    jx = lambda k: None if d.get(k) is None else jnp.asarray(d[k])  # noqa: E731
    tx = lambda k: None if d.get(k) is None else torch.as_tensor(d[k])  # noqa: E731
    ref = jck.solve_bl(PARAMS, jx("S"), jx("Hinv"), jx("qd"),
                       {k: jnp.asarray(v) for k, v in masks.items()},
                       *(jx(k) for k in keys))
    got = ck.solve_bl(plan_of(masks, frames), tx("S"), tx("Hinv"), tx("qd"),
                      *(tx(k) for k in keys))
    for name, a, b in zip(("qd", "lam", "imp_dof"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    assert float(np.abs(np.asarray(ref[1])).max()) > 0.01   # rows are live


@pytest.mark.parametrize("frames", [False, True], ids=["world", "frames"])
def test_wrapper_matches_jax_solve_pallas_interpret(frames):
    """The standard-layout wrapper (CPU: the twin) against solve_pallas run
    in interpret mode at N = 64, the smallest batch its block picker
    takes."""
    N = 64
    masks, d = make_case(N, frames, GROUPS["all"], seed=1)
    std = {  # batch-last -> standard layout (N leading), as solve_pallas takes
        "qd": d["qd"].T, "b_n": d["b_n"].T, "mu": d["mu"].T,
        "active": d["active"].T, "b_lo": d["b_lo"].T, "b_hi": d["b_hi"].T,
        "act_lo": d["act_lo"].T, "act_hi": d["act_hi"].T,
        "g_act": d["g_act"].T,
        "frames": None if d["frames"] is None
        else np.transpose(d["frames"], (3, 2, 0, 1)),
    }
    for k in ("pts_c", "w_c", "pts_a", "b_a", "w_a", "pts_g", "b_g", "w_g"):
        std[k] = np.transpose(d[k], (2, 1, 0))
    std = {k: None if v is None else np.ascontiguousarray(v)
           for k, v in std.items()}
    order = ("qd", "pts_c", "b_n", "mu", "active", "frames", "w_c", "b_lo",
             "b_hi", "act_lo", "act_hi")
    groups = ("pts_a", "b_a", "w_a", "pts_g", "b_g", "g_act", "w_g")
    jx = lambda k: None if std[k] is None else jnp.asarray(std[k])  # noqa: E731
    tx = lambda k: None if std[k] is None else torch.as_tensor(std[k])  # noqa: E731
    jdk._FORCE_INTERPRET = True
    try:
        ref = jck.solve_pallas(
            SimpleNamespace(params=PARAMS), jnp.asarray(d["S"]),
            jnp.asarray(d["Hinv"]), jx("qd"),
            {k: jnp.asarray(v) for k, v in masks.items()},
            *(jx(k) for k in order[1:]), **{k: jx(k) for k in groups})
    finally:
        jdk._FORCE_INTERPRET = False
    got = ck.solve(plan_of(masks, frames), torch.as_tensor(d["S"]),
                   torch.as_tensor(d["Hinv"]), *(tx(k) for k in order),
                   **{k: tx(k) for k in groups})
    for name, a, b in zip(("qd", "lam", "imp_dof"), got, ref):
        assert tuple(a.shape) == tuple(b.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_contact_header_bakes_the_plan():
    masks, _ = make_case(4, True, GROUPS["all"])
    plan = plan_of(masks, True)
    h = plan.header()
    for line in ("constexpr int NV = 7;", "constexpr int P = 5;",
                 "constexpr int A = 2;", "constexpr int G = 2;",
                 "constexpr bool FRAMES = true;", "constexpr int NITER = 8;"):
        assert line in h
    import re
    m = re.search(r"float dmask_c\[35\] = \{([^}]*)\}", h)
    vals = np.array([float(v.rstrip("f")) for v in m.group(1).split(",")],
                    np.float32)
    np.testing.assert_array_equal(vals, masks["c"].reshape(-1))
    used = re.search(r"bool used_a\(int v\) \{ constexpr bool t\[7\] = "
                     r"\{([^}]*)\}", h).group(1).split(", ")
    assert used == ["true" if u else "false"
                    for u in (masks["a"] != 0).any(0)]
    # an empty group still compiles: a one-entry table and no used dofs
    h0 = plan_of({"c": masks["c"]}, False).header()
    assert "constexpr int A = 0;" in h0 and "float dmask_g[1] = " in h0
    assert (_build.lib_dir("contact_solve", h)
            != _build.lib_dir("contact_solve", h0))


def test_plan_and_wrapper_reject_bad_inputs():
    masks, d = make_case(64, False, GROUPS["contacts"])
    with pytest.raises(ValueError, match="at least one contact row"):
        ck.ContactPlan({"a": masks["c"]}, NV, 8, 0.35, False)
    with pytest.raises(ValueError, match="unknown mask groups"):
        ck.ContactPlan({"c": masks["c"], "x": masks["c"]}, NV, 8, 0.35, False)
    plan = plan_of(masks, False)
    t = {k: None if v is None else torch.as_tensor(np.ascontiguousarray(
        v.T if v.ndim == 2 else np.transpose(v, (2, 1, 0))))
        for k, v in d.items() if k not in ("S", "Hinv")}
    args = [t[k] for k in ("qd", "pts_c", "b_n", "mu", "active", "frames",
                           "w_c", "b_lo", "b_hi", "act_lo", "act_hi")]
    S, H = torch.as_tensor(d["S"]), torch.as_tensor(d["Hinv"])
    with pytest.raises(ValueError, match="group 'a'"):
        ck.solve(plan, S, H, *args, pts_a=t["pts_c"][:, :2],
                 b_a=t["pts_c"][:, :2], w_a=t["pts_c"][:, :2])
    with pytest.raises(ValueError, match="frames"):
        ck.solve(plan, S, H, *args[:5], torch.zeros(64, P, 3, 3), *args[6:])
    # a tensor on another device never reaches the twin
    with pytest.raises(ValueError, match="mixed"):
        ck.solve(plan, S.to("meta"), H, *args)


def test_build_without_nvcc_raises(monkeypatch):
    """No nvcc: building B4 raises; nothing falls back to the twin."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build, "NVCC_DEFAULT", "/nonexistent/nvcc")
    masks, _ = make_case(4, False, GROUPS["contacts"])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(plan_of(masks, False))
