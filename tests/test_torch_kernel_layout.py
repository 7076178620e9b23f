"""The plan-side tables and launch layouts of the team kernels B1
(csrc/fk_motion.cu), B2 (csrc/dyn_forward.cu), B3 (csrc/dyn_cached.cu) and
B4 (csrc/contact_solve.cu), on the CPU.

The kernels themselves run only on the card (chip_smoke.py holds them
against their twins there); what they read is built here in Python and
checked without one: H's diagonal blocks and the block-wise sweep (against
the dense port sweep bit for bit, and against the JAX package's sweep),
B3's block-restricted H^-1 (rhs - C), B2's level, child and block tables,
the ancestor and subtree lists and packed scene tables of B1 and B3, the
generated headers, the shared-memory size of every plan the port builds,
and the rows each lane of B4's team owns.

Scenes: Ant and BallBalance (both contact routes' plans), FrankaReachMA at
its committed capture's warmed-up state (16 envs x 2 arms; its B4 plan from
the kernel route), Cartpole (the smallest tree B1-B3 take: a fixed root, a
SLIDE and a HINGE, nv 2; no contact plan), Humanoid (one 27-dof block),
Anymal, Ingenuity and Quadcopter (no contact plan), and a seeded contact
plan with every row group (the synthetic grab plan of chip_smoke.py: nv
14, P 8, A 2, G 2, frames).
"""
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.physics.engine import _sweep_inverse_batchlast
from isaacgymenvs_ma_tpu_torch.physics import contact_kernel as ck
from isaacgymenvs_ma_tpu_torch.physics import dyn_kernel as dk
from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
from isaacgymenvs_ma_tpu_torch.utils import parity
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "torch_port")
SCENES = ("Ant", "BallBalance", "FrankaReachMA", "Cartpole", "Humanoid",
          "Anymal", "Ingenuity", "Quadcopter")
BLOCK_SIZES = {"Ant": [14],               # the torso's free joint ties all
               "BallBalance": [12, 6],    # tray + legs, ball
               "FrankaReachMA": [9, 9, 6, 6],   # two arms, two cubes
               "Cartpole": [2],           # cart and pole under the slider
               "Humanoid": [27],          # a free base ties every dof
               "Anymal": [18], "Ingenuity": [6], "Quadcopter": [14]}
CONTACT_PLANS = ("Ant", "BallBalance", "FrankaReachMA", "Humanoid",
                 "Anymal", "Ingenuity", "grab")


def _task(name, n, kernel_route):
    cls, cfg, _ = parity.TASKS[name]
    cfg = deep_merge(cfg, {"env": {"numEnvs": n}})
    params = parse_sim_params(cfg["sim"])._replace(
        use_contact_kernel=kernel_route)
    return cls(cfg, device="cpu", seed=1, sim_params=params)


@pytest.fixture(scope="module")
def tasks():
    return {"Ant": _task("Ant", 4, True),
            "BallBalance": _task("BallBalance", 4, True),
            "FrankaReachMA": _task("FrankaReachMA", 16, True),
            "Cartpole": _task("Cartpole", 4, True),
            **{name: _task(name, 4, True)
               for name in ("Humanoid", "Anymal", "Ingenuity",
                            "Quadcopter")}}


def grab_plan():
    g = np.random.default_rng(5)
    masks = {k: g.choice([-1.0, 0.0, 0.0, 1.0], (r, 14)).astype(np.float32)
             for k, r in (("c", 8), ("a", 2), ("g", 2))}
    return ck.ContactPlan(masks, 14, num_iterations=8, relaxation=0.35,
                          has_frames=True)


def contact_plan(tasks, name):
    return grab_plan() if name == "grab" else tasks[name].engine.cplan


def _root(plan, b):
    while plan.parent[b] != -1:
        b = int(plan.parent[b])
    return b


@pytest.mark.parametrize("name", SCENES)
def test_dyn_blocks_partition_the_dofs(tasks, name):
    """The blocks cover every dof once, dof_anc couples no two blocks, and
    each block is the dofs under one root body."""
    plan = tasks[name].engine.plan
    assert [len(b) for b in plan.blocks] == BLOCK_SIZES[name]
    flat = sorted(v for b in plan.blocks for v in b)
    assert flat == list(range(plan.nv))
    label = np.empty(plan.nv, int)
    for i, blk in enumerate(plan.blocks):
        label[blk] = i
        assert blk == sorted(blk)
        assert len({_root(plan, int(plan.dof_body[v])) for v in blk}) == 1
    i, j = np.nonzero(plan.dof_anc)
    assert (label[i] == label[j]).all()
    roots = [_root(plan, int(plan.dof_body[b[0]])) for b in plan.blocks]
    assert len(set(roots)) == len(roots)


def test_block_sweep_equals_dense_sweep_at_franka_capture(tasks):
    """At the capture's warmed-up state, sweeping H block by block gives
    the dense sweep exactly (torch.equal: the dense sweep may write -0.0
    where the block sweep leaves 0.0), the dense result is exactly zero off
    the blocks, and both agree with the JAX package's sweep."""
    eng = tasks["FrankaReachMA"].engine
    plan = eng.plan
    d = np.load(os.path.join(DATA, "franka_reach_ma_golden.npz"))
    q = torch.as_tensor(d["init_q"]).t().contiguous()
    bx, bq, S = dk._fk_motion_bl(plan, q)
    I_O = dk.spatial_inertia_bl(plan, plan.consts("cpu"), bx, bq)
    M = dk.mass_matrix_bl(plan, plan.consts("cpu"), S, I_O)
    H = M + dk._eye_bl(plan.nv, S) * (eng.dof_armature[:, None] + 0.1)
    dense = dk.sweep_inverse_bl(H)
    blocks = torch.zeros_like(H)
    for blk in plan.blocks:
        idx = torch.as_tensor(blk)
        blocks[idx[:, None], idx[None, :]] = dk.sweep_inverse_bl(
            H[idx[:, None], idx[None, :]])
    assert torch.equal(dense, blocks)
    on = torch.zeros((plan.nv, plan.nv), dtype=torch.bool)
    for blk in plan.blocks:
        idx = torch.as_tensor(blk)
        on[idx[:, None], idx[None, :]] = True
    assert bool((dense[~on] == 0).all())
    assert bool((dense[on] != 0).any())
    ref = np.asarray(_sweep_inverse_batchlast(jnp.asarray(H.numpy())))
    np.testing.assert_allclose(blocks.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", SCENES)
def test_b2_tables_are_consistent(tasks, name):
    plan = tasks[name].engine.plan
    t = dk.b2_tables(plan)
    depth = [len(lv) for lv in plan.levels]
    assert t["lvl_off"] == np.cumsum([0] + depth).tolist()
    assert sorted(t["lvl_body"]) == list(range(plan.nb))
    for L in range(len(plan.levels)):
        for b in t["lvl_body"][t["lvl_off"][L]:t["lvl_off"][L + 1]]:
            assert plan._depth(b) == L
        gat = t["gat_body"][t["gat_off"][L]:t["gat_off"][L + 1]]
        assert gat == [b for b in plan.levels[L] if plan.children[b]]
    for b in range(plan.nb):
        kids = t["child"][t["child_off"][b]:t["child_off"][b + 1]]
        assert kids == [c for c in range(plan.nb) if plan.parent[c] == b]
        dofs = list(range(t["vadr"][b], t["vadr"][b] + t["ndof"][b]))
        assert dofs == plan.body_dofs[b]
    for v in range(plan.nv):
        base, size, at = (t["dof_block"][v] & 255,
                          t["dof_block"][v] >> 8 & 255,
                          t["dof_block"][v] >> 16)
        assert t["block_dofs"][base + at] == v
        assert v in t["block_dofs"][base:base + size]
    pairs = {(p & 255, p >> 8) for p in t["pair"]}
    assert pairs == set(zip(*map(lambda a: a.tolist(),
                                 np.nonzero(plan.dof_anc))))


@pytest.mark.parametrize("name", SCENES)
def test_scene_header_bakes_b2_layout_and_tables(tasks, name):
    plan = tasks[name].engine.plan
    h = plan.header()
    lay = plan.layout()
    t = dk.b2_tables(plan)
    for line in (f"constexpr int B2_TEAM = {lay.team};",
                 f"constexpr int B2_ENVS = {lay.envs};",
                 f"constexpr int B2_FLOATS = {lay.floats};",
                 f"constexpr int B2_SMEM_BYTES = {lay.smem_bytes};",
                 f"constexpr int NBLK = {len(plan.blocks)};",
                 f"constexpr int MAXBLK = {max(BLOCK_SIZES[name])};",
                 f"constexpr int NLEV = {len(plan.levels)};",
                 f"constexpr int NPAIR = {int(plan.dof_anc.sum())};"):
        assert line in h
    for tab in ("block_dofs", "dof_block", "lvl_body", "gat_body", "pair"):
        m = re.search(rf"const int b2_{tab}\[\d+\] = \{{([^}}]*)\}}", h)
        vals = [int(v) for v in m.group(1).split(",")]
        assert vals == (t[tab] or [0])
    m = re.search(r"const float b2_mass\[\d+\] = \{([^}]*)\}", h)
    np.testing.assert_array_equal(
        np.array([float(v.rstrip("f")) for v in m.group(1).split(",")],
                 np.float32), plan.mass)


@pytest.mark.parametrize("name", CONTACT_PLANS)
def test_contact_header_bakes_b4_layout(tasks, name):
    plan = contact_plan(tasks, name)
    lay = plan.layout()
    h = plan.header()
    for key in ("TEAM", "ENVS", "FLOATS", "SMEM_BYTES"):
        assert f"constexpr int B4_{key} = {getattr(lay, key.lower())};" in h
    assert f"constexpr int B4_JS = {dk.quad_odd(plan.nv)};" in h
    # the float4 reads of the kernel need 16-byte aligned arrays
    for k, off in lay.offsets.items():
        assert off % 4 == 0, k
        assert f"constexpr int B4_{k} = {off};" in h
    assert lay.floats % 4 == 0 and (lay.floats // 4) % 2 == 1
    m = re.search(r"const float dmask_c\[\d+\] = \{([^}]*)\}", h)
    np.testing.assert_array_equal(
        np.array([float(v.rstrip("f")) for v in m.group(1).split(",")],
                 np.float32), plan.masks["c"].reshape(-1))


DYN_KERNELS = ("fk_motion", "dyn_forward", "dyn_cached")


@pytest.mark.parametrize("kind,name", [(k, s) for k in DYN_KERNELS
                                       for s in SCENES]
                         + [("contact_solve", s) for s in CONTACT_PLANS])
def test_block_shared_memory_fits(tasks, kind, name):
    """Every plan the port builds asks for at most one block's shared
    memory (232,448 B on the H100), with teams that never span warps."""
    plan = (contact_plan(tasks, name) if kind == "contact_solve"
            else tasks[name].engine.plan)
    lay = plan.layout(kind)
    assert lay.smem_bytes == 4 * (lay.shared + lay.envs * lay.floats)
    assert lay.smem_bytes <= 232448 and lay.shared % 4 == 0
    assert lay.team in (8, 16, 32) and lay.envs >= 1
    assert lay.team * lay.envs <= 256


@pytest.mark.parametrize("name", CONTACT_PLANS)
def test_row_partition_covers_each_row_once(tasks, name):
    plan = contact_plan(tasks, name)
    team = plan.layout().team
    for group in ck.GROUPS:
        lanes = plan.row_lanes(group)
        assert len(lanes) == team
        rows = sorted(r for lane in lanes for r in lane)
        assert rows == list(range(plan.masks[group].shape[0]))
        for lane, owned in enumerate(lanes):
            assert all(r % team == lane for r in owned)


def test_layout_rules():
    """Team sizes, alignment helpers and the shared-memory limit."""
    assert [dk.KernelLayout(w, {}, 1).team for w in (1, 8, 9, 16, 17, 40)] \
        == [8, 8, 16, 16, 32, 32]
    assert dk.KernelLayout(14, {}, 10).floats == 11
    assert [dk.quad_odd(n) for n in (1, 4, 5, 8, 14, 30)] == \
        [4, 4, 12, 12, 20, 36]
    offsets, total = dk.packed_offsets([("a", 3), ("b", 5), ("c", 1)], 4)
    assert offsets == {"a": 0, "b": 4, "c": 12} and total == 16
    # a block that would pass the limit holds fewer envs; one env too big
    # for a block raises
    big = dk.KernelLayout(32, {}, 20000)
    assert big.envs == 2 and big.smem_bytes <= 232448
    with pytest.raises(ValueError, match="shared memory"):
        dk.KernelLayout(32, {}, 60000)
    # block-shared tables: rounded to float4s, ahead of the envs, and they
    # count against the limit
    tab = dk.KernelLayout(32, {}, 20000, shared=9)
    assert tab.shared == 12 and tab.smem_bytes == 4 * (12 + 2 * 20001)
    assert dk.KernelLayout(32, {}, 20000, shared=20000).envs == 1


# ---- B1, B3 and B4's wide plan

TEAMS = {"fk_motion": {"Ant": 8, "BallBalance": 8, "FrankaReachMA": 8,
                       "Cartpole": 8, "Humanoid": 8, "Anymal": 8,
                       "Ingenuity": 8, "Quadcopter": 8},
         "dyn_cached": {"Ant": 16, "BallBalance": 16, "FrankaReachMA": 32,
                        "Cartpole": 8, "Humanoid": 32, "Anymal": 16,
                        "Ingenuity": 8, "Quadcopter": 16}}


@pytest.mark.parametrize("kernel", list(TEAMS))
@pytest.mark.parametrize("name", SCENES)
def test_b1_b3_layouts(tasks, kernel, name):
    """B1 poses the tree level by level with 8 lanes an env (no level is
    wider than 16 bodies); B3 takes the power of two nearest max(NB, NV);
    both in blocks of 256 threads with their scene tables shared."""
    plan = tasks[name].engine.plan
    lay = plan.layout(kernel)
    assert lay.team == TEAMS[kernel][name]
    assert lay.team * lay.envs == 256
    ints, floats = dk.kernel_tables(plan, kernel)
    assert lay.shared == -(-(sum(map(len, ints.values()))
                             + sum(map(len, floats.values()))) // 4) * 4
    if kernel == "fk_motion":
        assert max(len(lv) for lv in plan.levels) <= 2 * lay.team


# (team, envs a block, shared-memory bytes) of the legged and aerial
# scenes' plans
LOCO_LAYOUTS = {
    ("Humanoid", "fk_motion"): (8, 32, 74832),
    ("Humanoid", "dyn_forward"): (32, 8, 80352),
    ("Humanoid", "dyn_cached"): (32, 8, 81504),
    ("Humanoid", "contact_solve"): (32, 4, 72768),
    ("Anymal", "dyn_forward"): (32, 8, 42656),
    ("Anymal", "dyn_cached"): (16, 16, 83872),
    ("Anymal", "contact_solve"): (32, 4, 90432),
    ("Ingenuity", "contact_solve"): (8, 16, 34048),
}


@pytest.mark.parametrize("name,kernel", sorted(LOCO_LAYOUTS))
def test_loco_plan_layouts(tasks, name, kernel):
    """The launch layouts of the Humanoid, Anymal (AnymalTerrain's plans
    are the same) and Ingenuity plans: Humanoid's B2 sweeps its one
    27-dof block with a team of 32 lanes, 8 envs a block; B4 at Anymal (68
    rows) fits two 90,432 B blocks an SM."""
    plan = (contact_plan(tasks, name) if kernel == "contact_solve"
            else tasks[name].engine.plan)
    lay = plan.layout(kernel)
    assert (lay.team, lay.envs, lay.smem_bytes) == LOCO_LAYOUTS[(name,
                                                                 kernel)]
    if kernel == "contact_solve":
        assert 2 * lay.smem_bytes <= 232448 or name == "Humanoid"


def test_franka_contact_plan_fits(tasks):
    """FrankaReachMA's B4 plan: all 41 candidate rows (24 ground, 17 pair
    rows with frames), no attractor or grab rows, nv 30; a team of 32 with
    4 envs in a 107,200 B block, and J's columns read from shared memory
    (3 * 41 + 30 floats a lane would not fit beside the rest in registers);
    the other plans keep them in registers."""
    plan = contact_plan(tasks, "FrankaReachMA")
    assert (plan.P, plan.A, plan.G, plan.nv, plan.has_frames) == \
        (41, 0, 0, 30, True)
    lay = plan.layout()
    assert (lay.team, lay.envs, lay.smem_bytes) == (32, 4, 107200)
    assert not plan.cols_in_registers()
    assert "constexpr bool B4_JREG = false;" in plan.header()
    for name in ("Ant", "BallBalance", "grab"):
        other = contact_plan(tasks, name)
        assert other.cols_in_registers()
        assert "constexpr bool B4_JREG = true;" in other.header()


def test_block_restricted_qdd_equals_dense_at_franka_capture(tasks):
    """B3's qdd = H^-1 (rhs - C) summed over each dof's block (the entries
    it stages, in dof order) equals the sum over all 30 dofs in the same
    order bit for bit, at the capture's warmed-up state with the dense
    sweep's H^-1: the terms off the blocks are exact zeros."""
    eng = tasks["FrankaReachMA"].engine
    plan = eng.plan
    consts = plan.consts("cpu")
    d = np.load(os.path.join(DATA, "franka_reach_ma_golden.npz"))
    q = torch.as_tensor(d["init_q"]).t().contiguous()
    qd = torch.as_tensor(d["init_qd"]).t().contiguous()
    bx, bq, S = dk._fk_motion_bl(plan, q)
    rhs = torch.as_tensor(np.random.default_rng(0).normal(
        size=qd.shape).astype(np.float32))
    diag = (eng.dof_armature[:, None] + 0.1).expand_as(qd).contiguous()
    _, hinv, io = dk.dyn_full_bl(plan, consts, bx, bq, S, qd, rhs, diag)
    fg = eng.gravity_wrench(bx.permute(2, 0, 1), bq.permute(2, 0, 1)
                            ).permute(1, 2, 0)
    r = rhs - dk.bias_force_bl(plan, consts, S, qd, io, fg=fg)
    t = dk.tree_lists(plan)
    hb = hinv.reshape(plan.nv * plan.nv, -1)[t["hb_row"]]
    dense = torch.zeros_like(r)
    block = torch.zeros_like(r)
    for v in range(plan.nv):
        for j in range(plan.nv):
            dense[v] = dense[v] + hinv[v, j] * r[j]
        blk = next(b for b in plan.blocks if v in b)
        for c, j in enumerate(blk):
            block[v] = block[v] + hb[t["dof_hb"][v] + c] * r[j]
    assert torch.equal(block, dense)
    assert len(t["hb_row"]) == 234 and float(block.abs().max()) > 1.0
    torch.testing.assert_close(
        block, dk.dyn_cached_bl(plan, consts, S, qd, rhs, io, hinv, fg),
        rtol=1e-5, atol=1e-4)


ACTIVE = {"Ant": 9, "BallBalance": 8, "FrankaReachMA": 32, "Cartpole": 2,
          # floating bases: every body is on the root's free joint
          "Humanoid": 25, "Anymal": 13, "Ingenuity": 3, "Quadcopter": 9}


@pytest.mark.parametrize("name", SCENES)
def test_tree_lists_match_the_tree(tasks, name):
    """The active bodies are those with a dof on their root path
    (FrankaReachMA: all but the table and the two fixed arm bases); each
    body's ancestor list is the active part of its path from its root,
    root first; its subtree list is itself then every descendant once;
    H^-1's block entries are each block's rows in dof order, dof v's row at
    dof_hb[v]."""
    plan = tasks[name].engine.plan
    t = dk.tree_lists(plan)

    def path(b):
        p = [b]
        while plan.parent[p[-1]] != -1:
            p.append(int(plan.parent[p[-1]]))
        return p[::-1]

    act = [b for b in range(plan.nb)
           if any(plan.body_dofs[a] for a in path(b))]
    assert t["act"] == act and len(act) == ACTIVE[name]
    for b in range(plan.nb):
        anc = t["anc"][t["anc_off"][b]:t["anc_off"][b + 1]]
        assert anc == [a for a in path(b) if a in act]
        sub = t["desc"][t["desc_off"][b]:t["desc_off"][b + 1]]
        assert sub[0] == b and len(set(sub)) == len(sub)
        assert set(sub) == {c for c in range(plan.nb) if b in path(c)}
    # every dof's body is active, and so is its whole subtree
    for v in range(plan.nv):
        b = int(plan.dof_body[v])
        assert set(t["desc"][t["desc_off"][b]:t["desc_off"][b + 1]]) <= \
            set(act)
    rows = [i * plan.nv + j for blk in plan.blocks for i in blk for j in blk]
    assert t["hb_row"] == rows
    for blk in plan.blocks:
        for i in blk:
            at = t["dof_hb"][i]
            assert t["hb_row"][at:at + len(blk)] == [i * plan.nv + j
                                                     for j in blk]


def _assert_packed_tables(plan, kernel, prefix):
    h = plan.header()
    ints, floats = dk.kernel_tables(plan, kernel)
    for ctype, tables in (("int", ints), ("float", floats)):
        if not tables:
            continue
        m = re.search(rf"const {ctype} {prefix}_{ctype[0]}tab\[\d+\] = "
                      r"\{([^}]*)\}", h)
        vals = np.array([float(v.rstrip("f")) for v in m.group(1).split(",")])
        for tname, tab in tables.items():
            off = int(re.search(rf"constexpr int {prefix.upper()}T_"
                                rf"{tname.upper()} = (\d+);", h).group(1))
            np.testing.assert_array_equal(
                vals[off:off + len(tab)].astype(np.float32),
                np.asarray(tab, np.float32), err_msg=tname)
    n_act = len(dk.tree_lists(plan)["act"])
    assert f"constexpr int B3_NACT = {n_act};" in h


@pytest.mark.parametrize("kernel,prefix", [("fk_motion", "b1"),
                                           ("dyn_cached", "b3")])
def test_scene_header_packs_b1_b3_tables(tasks, kernel, prefix):
    """Each kernel's tables sit end to end in one int and (B1) one float
    device array, at the offsets the header names."""
    _assert_packed_tables(tasks["FrankaReachMA"].engine.plan, kernel, prefix)


def test_cartpole_plan_at_the_smallest_tree(tasks):
    """Cartpole's plan: three levels of one body, the fixed slider inactive
    (no dof on its path), one H block of both dofs, B2's and B3's teams of
    3 and 4 lanes' work clamped up to 8, and B1's and B3's packed tables
    at the offsets the header names."""
    plan = tasks["Cartpole"].engine.plan
    assert (plan.nb, plan.nq, plan.nv) == (3, 2, 2)
    assert plan.levels == [[0], [1], [2]] and plan.blocks == [[0, 1]]
    t = dk.tree_lists(plan)
    assert t["act"] == [1, 2] and t["hb_row"] == [0, 1, 2, 3]
    assert dk.b2_tables(plan)["gat_body"] == [0, 1]
    for kernel in DYN_KERNELS:
        lay = plan.layout(kernel)
        assert lay.team == 8 and lay.team * lay.envs == 256
    for kernel, prefix in (("fk_motion", "b1"), ("dyn_cached", "b3")):
        _assert_packed_tables(plan, kernel, prefix)
    assert tasks["Cartpole"].engine.cplan is None
