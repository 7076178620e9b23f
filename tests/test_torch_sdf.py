"""The port's SDF pieces against the JAX package's: the procedural meshes
(``models/meshes.py``, a numpy copy), the voxelizer (``native/``, the same
C++ source built into ``build/native/``) and its numpy twin,
``ModelBuilder.add_sdf_geom`` (grids, mass and inertia) and the grid
sampler ``physics/sdf_grid.py`` (plain torch; JAX's is XLA)."""
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.models import meshes as jmeshes
from isaacgymenvs_ma_tpu.models import model as jmd
from isaacgymenvs_ma_tpu.native import voxelize_mesh as jvoxelize
from isaacgymenvs_ma_tpu.physics import sdf_grid as jsdf
from isaacgymenvs_ma_tpu_torch import native
from isaacgymenvs_ma_tpu_torch.models import meshes
from isaacgymenvs_ma_tpu_torch.models import model as md
from isaacgymenvs_ma_tpu_torch.physics import sdf_grid
from isaacgymenvs_ma_tpu_torch.tasks import factory, industreal

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

MESHES = {
    "box": ("box_mesh", ((0.01, 0.02, 0.03),)),
    "cylinder": ("cylinder_mesh", (0.004, 0.025, 24)),
    "tube": ("tube_mesh", (0.04, 0.0032, 0.01, 32)),
    "threaded_rod": ("threaded_rod_mesh", (0.008, 0.0068, 0.025, 0.002)),
    "box_with_hole": ("box_with_hole_mesh", ((0.0145, 0.0145), 0.0125,
                                             0.0042, 64)),
    "hex_nut": ("hex_nut_mesh", (0.024, 0.013, 0.0085)),
    "hex_nut_points": ("hex_nut_contact_points", (0.024, 0.013, 0.0085)),
    "bolt": ("bolt_mesh", (0.024, 0.016, 0.008, 0.025)),
    "bolt_parts": ("bolt_mesh_parts", (0.024, 0.016, 0.008, 0.025)),
    "cylinder_points": ("cylinder_contact_points", (0.004, 0.025, 8, 3)),
    "tube_points": ("tube_contact_points", (0.04, 0.0032, 0.01, 8)),
    "uv_sphere": ("uv_sphere_mesh", (0.02, 16, 8)),
}


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [a for y in x for a in _flat(y)]
    return [np.asarray(x)]


@pytest.mark.parametrize("name", sorted(MESHES))
def test_meshes_bit_equal_to_jax(name):
    fn, args = MESHES[name]
    got = _flat(getattr(meshes, fn)(*args))
    want = _flat(getattr(jmeshes, fn)(*args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_surface_sample_bit_equal_to_jax():
    v, t = meshes.tube_mesh(0.04, 0.0032, 0.01, n=32)
    np.testing.assert_array_equal(
        meshes.surface_sample(v, t, 64, seed=11),
        jmeshes.surface_sample(v, t, 64, seed=11))


def _grid_inputs(verts, resolution, pad=0.15):
    """sdf_grid.from_mesh's box, pitch and size."""
    verts = np.asarray(verts, np.float32)
    lo, hi = verts.min(0), verts.max(0)
    margin = float((hi - lo).max()) * pad
    lo, hi = lo - margin, hi + margin
    h = float((hi - lo).max()) / (resolution - 1)
    dims = np.maximum(np.ceil((hi - lo) / h).astype(np.int32) + 1, 4)
    return lo, np.full(3, h, np.float32), dims


def _part_meshes():
    nut = meshes.hex_nut_mesh(factory.NUT_WIDTH, factory.NUT_HEIGHT,
                              factory.NUT_HOLE_R)
    head, shank = meshes.bolt_mesh_parts(
        factory.NUT_WIDTH, factory.BOLT_HEAD_HEIGHT, factory.BOLT_WIDTH / 2,
        factory.BOLT_SHANK_LENGTH)
    h = industreal.SOCKET_HALF
    socket = meshes.box_with_hole_mesh(h[:2], h[2], industreal.SOCKET_HOLE_R,
                                       n=64)
    return {"nut": (nut, 40), "bolt_head": (head, 64),
            "bolt_shank": (shank, 64), "socket": (socket, 72)}


@pytest.mark.parametrize("part", ["nut", "bolt_head", "bolt_shank",
                                  "socket"])
def test_grids_bit_equal_to_jax(part):
    """The same source built with the same flags bakes the same grid."""
    (v, t), res = _part_meshes()[part]
    lo, sp, dims = _grid_inputs(v, res)
    got = native.voxelize_mesh(v, t, lo, sp, dims)
    want = jvoxelize(v, t, lo, sp, dims)
    assert got.shape == tuple(dims) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got < 0).any() and (got > 0).any()


def test_library_matches_numpy_twin():
    """The C++ distances (double inside, float out) against the numpy
    version of the same algorithm on a small mesh, at points inside,
    outside and near the surface."""
    v, t = meshes.hex_nut_mesh(0.024, 0.013, 0.0085)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.02, 0.02, (300, 3)).astype(np.float32)
    got = native.query_mesh_sdf(v, t, pts)
    want = native.signed_distance_np(v, t, pts)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got < 0).sum() > 10 and (got > 0).sum() > 10


def test_library_builds_into_the_build_tree():
    so = native.build()
    assert so.is_file() and so.parent.parent.name == "native"
    assert so.parent.parent.parent.name == "build"


def _grid_pair(seed=0):
    v, t = meshes.hex_nut_mesh(0.024, 0.013, 0.0085)
    lo, sp, dims = _grid_inputs(v, 24)
    vals = native.voxelize_mesh(v, t, lo, sp, dims)
    tg = sdf_grid.to_device(vals, lo, sp, "cpu")
    jg = jsdf.SDFGrid(values=vals, origin=lo, spacing=sp)
    return tg, jg, lo, sp * (dims - 1)


def test_sample_with_normal_matches_jax():
    """Seeded points inside the box and up to 2 cm outside it (the
    extension: clamped value plus the distance to the box, the normal away
    from it), values and normals at atol 1e-6."""
    tg, jg, lo, ext = _grid_pair()
    rng = np.random.default_rng(5)
    inside = lo + ext * rng.uniform(0.0, 1.0, (400, 3))
    outside = lo + ext * rng.uniform(-0.8, 1.8, (400, 3))
    pts = np.concatenate([inside, outside]).astype(np.float32)
    d, n = sdf_grid.sample_with_normal(tg, torch.tensor(pts))
    jd, jn = jsdf.sample_with_normal(jg, pts)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sdf_grid.sample(tg, torch.tensor(pts)),
                               np.asarray(jsdf.sample(jg, pts)), atol=1e-6,
                               rtol=0)
    # the packed table holds each cell's 8 corners once
    dx, dy, dz = tg.values.shape
    assert tuple(tg.pack.shape) == ((dx - 1) * (dy - 1) * (dz - 1), 8)


def test_from_mesh_matches_jax():
    v, t = meshes.cylinder_mesh(industreal.PLUG_RADIUS,
                                industreal.PLUG_LENGTH / 2, n=48)
    tg = sdf_grid.from_mesh(v, t, resolution=48, device="cpu")
    jg = jsdf.from_mesh(v, t, resolution=48)
    np.testing.assert_array_equal(tg.values.numpy(), np.asarray(jg.values))
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    np.testing.assert_array_equal(tg.spacing.numpy(), np.asarray(jg.spacing))


def _build_nut_and_bolt(mdl, mesh_mod):
    b = mdl.ModelBuilder()
    b.begin_actor()
    nut = b.add_body("nut", -1, mdl.FREE)
    nv_, nt_ = mesh_mod.hex_nut_mesh(0.024, 0.013, 0.0085)
    cp = mesh_mod.hex_nut_contact_points(0.024, 0.013, 0.0085)
    solid = mesh_mod.cylinder_mesh(0.024 / np.sqrt(3.0), 0.0065, n=6)
    b.add_sdf_geom(nut, nv_, nt_, density=7850.0, friction=0.8,
                   resolution=40, contact_points=cp, sdf_from=[solid],
                   name="nut_geom")
    bolt = b.add_body("bolt", -1, mdl.FREE)
    head, shank = mesh_mod.bolt_mesh_parts(0.024, 0.016, 0.008, 0.025)
    b.add_sdf_geom(bolt, head[0], head[1], density=7850.0, resolution=64,
                   union_with=[shank], name="bolt_geom")
    return b.finalize()


def test_add_sdf_geom_matches_jax():
    """Grids (a separate collision field with ``sdf_from``, parts combined
    by a min with ``union_with``), contact clouds, mass and inertia from
    the primary mesh's interior voxels: equal to the JAX builder's."""
    tm = _build_nut_and_bolt(md, meshes)
    jm = _build_nut_and_bolt(jmd, jmeshes)
    for f in ("mass", "com", "inertia"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f),
                                      err_msg=f)
    assert (np.asarray(tm.mass) > 0).all()
    for tg, jg in zip(tm.geoms, jm.geoms):
        assert tg.gtype == jg.gtype == md.GEOM_SDF
        for f in ("sdf_values", "sdf_origin", "sdf_spacing", "size",
                  "contact_points"):
            a, b = getattr(tg, f), getattr(jg, f)
            if a is None:
                assert b is None
                continue
            np.testing.assert_array_equal(a, b, err_msg=f)
