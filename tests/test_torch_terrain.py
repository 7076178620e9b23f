"""Port parity of the terrain (isaacgymenvs_ma_tpu_torch/physics/
terrain.py) and of the engine's terrain rows against the JAX package, on
the CPU.

* The heightfield and env origins of ``CurriculumTerrain`` (numpy from the
  same seed): bit-equal.
* ``height_at`` / ``height_min2`` (gathers over the global grid) against
  the JAX ``TerrainGrid`` and its per-env ``LocalTerrain`` windows: atol
  1e-5 m.
* One AnymalTerrain engine step on terrain: the ROADMAP's q rtol 2e-4 /
  atol 2e-5, qd 2e-3.  The published map puts the robots 30-180 m from the
  world origin, where one ulp on q moves the JAX step itself by ~1e-3
  (ROADMAP C8), so the steps here stand on patches of the same heightfield
  moved under the world origin (the grid's ``origin_xy``); the states are
  envs of the committed capture tests/data/torch_port/
  anymal_terrain_golden.npz, and the JAX engine runs eagerly on them.
* B4's twin on terrain rows against the JAX ``solve_bl``: rtol = atol =
  1e-4.
"""
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from isaacgymenvs_ma_tpu.physics import terrain as jterrain
from isaacgymenvs_ma_tpu.physics.engine import SimState as JSimState
from isaacgymenvs_ma_tpu.tasks import anymal_terrain as jat
from isaacgymenvs_ma_tpu_torch.physics import terrain as tterrain
from isaacgymenvs_ma_tpu_torch.physics.engine import SimState
from isaacgymenvs_ma_tpu_torch.tasks import anymal_terrain as tat
from test_torch_humanoid import (
    N, Q_TOL, QD_TOL, capture_b4_inputs, compare_b4_twin, load_pair)


@pytest.fixture(scope="module")
def atp():
    return load_pair(jat, tat.AnymalTerrain, "anymal_terrain_golden.npz")


@pytest.mark.parametrize("curriculum", [True, False])
def test_terrain_heightfield_and_origins_bit_equal(curriculum):
    """The port's CurriculumTerrain against the JAX package's: the 1,200
    x 2,000 heightfield (10 levels x 20 types of 8 m at 0.1 m and a 20 m
    border) and every env origin, bit for bit, with the curriculum and
    with the random draws that replace it."""
    kw = dict(curriculum=curriculum)
    j = jterrain.CurriculumTerrain(**kw)
    t = tterrain.CurriculumTerrain(device="cpu", **kw)
    assert tuple(t.grid.heights.shape) == (1200, 2000)
    np.testing.assert_array_equal(t.grid.heights.numpy(),
                                  np.asarray(j.grid.heights))
    np.testing.assert_array_equal(t.env_origins, j.env_origins)
    np.testing.assert_array_equal(t.env_origins_t.numpy(),
                                  np.asarray(j.env_origins_j))
    assert float(np.ptp(t.grid.heights.numpy())) > 1.0


@pytest.fixture(scope="module")
def terrain_pair():
    return (jterrain.CurriculumTerrain(),
            tterrain.CurriculumTerrain(device="cpu"))


def test_height_lookups_match_grid_and_local_windows(terrain_pair):
    """``height_at`` and ``height_min2`` as gathers over the global grid
    against the JAX ``TerrainGrid`` and against its per-env
    ``LocalTerrain`` windows (the AnymalTerrain step's 30-cell windows,
    centred on each env), at 140 points within 1 m of each of 64 centres
    spread over the map, on cell corners and edges too."""
    j, t = terrain_pair
    g = np.random.default_rng(2)
    n, p = 64, 140
    cx = g.uniform(0.5, 119.5, n).astype(np.float32)
    cy = g.uniform(0.5, 199.5, n).astype(np.float32)
    off = g.uniform(-1.0, 1.0, (n, p, 2))
    off[:, :20] = np.round(off[:, :20], 1)         # on cell corners
    x = (cx[:, None] + off[..., 0]).astype(np.float32)
    y = (cy[:, None] + off[..., 1]).astype(np.float32)
    x[0, :4] = [-3.0, 121.0, 0.0, 119.9]           # clamped at the edges
    win = j.grid.local_window(jnp.asarray(cx), jnp.asarray(cy), 30)
    for name in ("height_at", "height_min2"):
        got = getattr(t.grid, name)(torch.as_tensor(x), torch.as_tensor(y))
        ref = getattr(j.grid, name)(jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0, err_msg=name)
        # the windows cover their env's points, not the edge ones
        loc = np.asarray(getattr(win, name)(jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_allclose(got.numpy()[1:], loc[1:], atol=1e-5,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(got.numpy()[0, 4:], loc[0, 4:],
                                   atol=1e-5, rtol=0, err_msg=name)
    with pytest.raises(NotImplementedError):
        t.grid.height_and_normal(torch.as_tensor(x), torch.as_tensor(y))


def moved_patch(atp, env, n=8, seed=0):
    """``n`` envs on env ``env``'s terrain patch moved under the world
    origin: the capture's state of that env with its base shifted by its
    patch's origin and each copy nudged (xy +-5 cm, qd N(0, 0.05)); the
    shifted JAX and port grids (``origin_xy`` minus the patch's origin)
    and the JAX step's LocalTerrain windows on it."""
    d, jt, tt = atp["d"], atp["jt"], atp["tt"]
    lv, ty = int(d["init_terrain_levels"][env]), int(
        d["init_terrain_types"][env])
    o = tt.terrain_map.env_origins[lv, ty]
    g = np.random.default_rng(seed)
    q = np.repeat(d["init_q"][env: env + 1], n, 0)
    qd = np.repeat(d["init_qd"][env: env + 1], n, 0)
    q[:, 0] += -o[0] + g.uniform(-0.05, 0.05, n)
    q[:, 1] += -o[1] + g.uniform(-0.05, 0.05, n)
    qd = qd + g.normal(0, 0.05, qd.shape)
    q, qd = q.astype(np.float32), qd.astype(np.float32)
    s = jt.terrain.horizontal_scale
    jgrid = jterrain.TerrainGrid(jt.terrain.heights, s,
                                 (float(-o[0]), float(-o[1])))
    tgrid = tterrain.TerrainGrid(tt.terrain.heights, s,
                                 (float(-o[0]), float(-o[1])))
    jwin = jgrid.local_window(jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]),
                              jt._terrain_win)
    return q, qd, jwin, tgrid


# patches of the capture's envs: a pyramid slope, rough, stairs, discrete
# obstacles and stepping stones
PATCH_ENVS = {"slope": 0, "rough": 2, "stairs": 8, "obstacles": 14,
              "stones": 17}


@pytest.mark.parametrize("route", ["default_loop", "contact_kernel",
                                   "row_reuse"])
@pytest.mark.parametrize("patch", sorted(PATCH_ENVS))
def test_terrain_engine_step_matches_jax(atp, patch, route):
    """One AnymalTerrain engine step (4 substeps of 5 ms, B2 on each) on a
    terrain patch under the world origin, the JAX engine on LocalTerrain
    windows: the port's default loop (16 of 68 rows by the terrain gaps),
    its B4 route (all 68 terrain rows through B4's twin) and the row-reuse
    path (``reuse_contact_rows``: later substeps move the cached points
    and read the heightfield again), each against the JAX engine with the
    same options."""
    from isaacgymenvs_ma_tpu.physics.engine import PhysicsEngine as JEngine
    from isaacgymenvs_ma_tpu_torch.physics.engine import PhysicsEngine
    jt, tt = atp["jt"], atp["tt"]
    q, qd, jwin, tgrid = moved_patch(atp, PATCH_ENVS[patch])
    n = q.shape[0]
    je, te = jt.engine, (atp["tb4"] if route == "contact_kernel"
                         else tt).engine
    if route == "row_reuse":
        je = JEngine(jt.model, je.params._replace(reuse_contact_rows=True))
        te = PhysicsEngine(tt.model, te.params._replace(
            reuse_contact_rows=True), device="cpu")
    a = np.random.default_rng(3).uniform(-1, 1, (n, 12)).astype(np.float32)
    tgt = np.zeros((n, 18), np.float32)
    tgt[:, 6:] = 0.5 * a + np.asarray(jt.default_dof_pos)
    from isaacgymenvs_ma_tpu.physics.engine import Control as JControl
    from isaacgymenvs_ma_tpu_torch.physics.engine import Control
    z = np.zeros((n, 18), np.float32)
    js, jo = je.step(JSimState(jnp.asarray(q), jnp.asarray(qd)),
                     JControl(jnp.asarray(z), jnp.asarray(tgt),
                              jnp.asarray(z)), terrain=jwin)
    ts, to = te.step(SimState(torch.as_tensor(q), torch.as_tensor(qd)),
                     Control(torch.as_tensor(z), torch.as_tensor(tgt),
                             torch.as_tensor(z)), terrain=tgrid)
    np.testing.assert_allclose(ts.q.numpy(), np.asarray(js.q), **Q_TOL)
    np.testing.assert_allclose(ts.qd.numpy(), np.asarray(js.qd), **QD_TOL)
    cf = np.asarray(jo.contact_force)
    assert float(np.abs(cf).max()) > 10.0                 # on the terrain
    np.testing.assert_allclose(to.contact_force.numpy(), cf, rtol=2e-3,
                               atol=2e-3 * float(np.abs(cf).max()))


def test_b4_twin_matches_jax_on_terrain_rows(atp):
    """B4's twin on the inputs the B4 route hands it on a stairs patch
    (68 terrain rows, their gaps read from the heightfield) against the
    JAX ``solve_bl``."""
    tt = atp["tb4"]
    q, qd, _, tgrid = moved_patch(atp, PATCH_ENVS["stairs"])
    n = q.shape[0]
    a = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, (n, 12)),
                        dtype=torch.float32)
    from isaacgymenvs_ma_tpu_torch.tasks.anymal import pd_control
    small = SimpleNamespace(num_envs=n, engine=tt.engine, device=tt.device,
                            action_scale=tt.action_scale,
                            default_dof_pos=tt.default_dof_pos)
    call = capture_b4_inputs(tt, SimState(torch.as_tensor(q),
                                          torch.as_tensor(qd)),
                             pd_control(small, a), terrain=tgrid)
    plan = compare_b4_twin(call)
    assert (plan.P, plan.nv) == (68, 18)


def test_terrain_normal_frames_raise(atp):
    """Terrain surface normals (SimParams.terrain_normal_frames, default
    off in both packages) are not ported: a terrain step with them on
    raises."""
    from isaacgymenvs_ma_tpu_torch.physics.engine import PhysicsEngine
    tt = atp["tt"]
    e = PhysicsEngine(tt.model, tt.sim_params._replace(
        terrain_normal_frames=True), device="cpu")
    a = torch.zeros((N, 12))
    with pytest.raises(NotImplementedError, match="normal"):
        e.step(atp["tst"].sim, tt.pre_physics(atp["tst"], a),
               terrain=tt.terrain)


