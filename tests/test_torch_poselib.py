"""The port's poselib (a numpy copy, isaacgymenvs_ma_tpu_torch/poselib)
against the JAX package's: tests/test_poselib.py's cases on both
packages, their arrays equal.  The MJCF case reads an MJCF written from
the repo's own humanoid spec (models/specs/humanoid.py), not a file
outside the repo."""
import xml.etree.ElementTree as ET

import numpy as np
import pytest

import isaacgymenvs_ma_tpu.poselib as jpl
import isaacgymenvs_ma_tpu_torch.poselib as tpl
from isaacgymenvs_ma_tpu_torch.models.specs.humanoid import SPEC

PACKAGES = {"port": tpl, "jax": jpl}


def _chain3(pl):
    return pl.SkeletonTree(["root", "a", "b"], np.array([-1, 0, 1]),
                           np.array([[0, 0, 0], [1, 0, 0], [1, 0, 0]],
                                    np.float32))


def _fk(pl, _):
    st = pl.SkeletonState.zero_pose(_chain3(pl))
    rz = pl.quat_from_angle_axis(np.pi / 2, [0, 0, 1.0])
    lr = st.local_rotation.copy()
    lr[0] = rz
    st2 = pl.SkeletonState(st.skeleton_tree, lr, st.root_translation)
    assert np.allclose(st.global_translation,
                       [[0, 0, 0], [1, 0, 0], [2, 0, 0]], atol=1e-6)
    assert np.allclose(st2.global_translation,
                       [[0, 0, 0], [0, 1, 0], [0, 2, 0]], atol=1e-5)
    return {"gt": st.global_translation, "gt2": st2.global_translation,
            "gr2": st2.global_rotation}


def _roundtrip(pl, _):
    rng = np.random.default_rng(0)
    lr = rng.normal(size=(3, 4)).astype(np.float32)
    lr /= np.linalg.norm(lr, axis=-1, keepdims=True)
    st = pl.SkeletonState(_chain3(pl), lr, np.zeros(3, np.float32))
    gr = st.global_rotation
    st2 = pl.SkeletonState.from_rotation_and_root_translation(
        _chain3(pl), gr, np.zeros(3), is_local=False)
    assert np.allclose(np.abs(np.sum(st2.global_rotation * gr, -1)), 1.0,
                       atol=1e-5)
    return {"gr": gr, "lr2": st2.local_rotation}


def _motion(pl, tmp_path):
    T, fps = 30, 30.0
    tree = _chain3(pl)
    lr = np.tile(pl.SkeletonState.zero_pose(tree).local_rotation, (T, 1, 1))
    rt = np.stack([np.linspace(0, 1, T), np.zeros(T), np.zeros(T)], -1)
    mo = pl.SkeletonMotion(tree, lr, rt.astype(np.float32), fps)
    assert np.allclose(mo.global_velocity[5:-5, 0, 0], (T - 1) / T, atol=0.1)
    assert np.allclose(mo.global_angular_velocity, 0.0, atol=1e-4)
    p = str(tmp_path / f"m_{pl.__name__}.npy")
    mo.to_file(p)
    mo2 = pl.SkeletonMotion.from_file(p)
    assert mo2.fps == fps
    d = mo2.to_dict()
    assert d["rotation"]["arr"].shape == (T, 3, 4)
    assert d["global_velocity"]["arr"].shape == (T, 3, 3)
    return {"v": mo.global_velocity, "w": mo.global_angular_velocity,
            "gt2": mo2.global_translation, "rot": d["rotation"]["arr"]}


def _keep(pl, _):
    t2 = _chain3(pl).keep_nodes_by_names(["root", "b"])
    assert t2.node_names == ["root", "b"]
    assert np.allclose(t2.local_translation[1], [2, 0, 0])
    st = pl.SkeletonState.zero_pose(t2)
    assert np.allclose(st.global_translation[1], [2, 0, 0])
    return {"lt": t2.local_translation, "gt": st.global_translation}


def _retarget(pl, _):
    T = 8
    rng = np.random.default_rng(1)
    lr = rng.normal(size=(T, 3, 4)).astype(np.float32)
    lr /= np.linalg.norm(lr, axis=-1, keepdims=True)
    rt = rng.normal(size=(T, 3)).astype(np.float32)
    mo = pl.SkeletonMotion(_chain3(pl), lr, rt, 30.0)
    tpose = pl.SkeletonState.zero_pose(_chain3(pl))
    out = mo.retarget_to_by_tpose({"root": "root", "a": "a", "b": "b"},
                                  tpose, tpose)
    assert np.allclose(out.global_translation, mo.global_translation,
                       atol=1e-4)
    return {"gt": out.global_translation, "lr": out.local_rotation}


def humanoid_mjcf(path):
    """An MJCF body tree of the repo's humanoid spec: every body nested
    under its parent at its ``body_pos``."""
    root = ET.Element("mujoco", model="humanoid")
    world = ET.SubElement(root, "worldbody")
    nodes = []
    for i, (name, parent) in enumerate(zip(SPEC["body_names"],
                                           SPEC["parent"])):
        up = world if parent < 0 else nodes[parent]
        nodes.append(ET.SubElement(up, "body", name=name, pos=" ".join(
            repr(float(x)) for x in SPEC["body_pos"][i])))
    ET.ElementTree(root).write(path)
    return path


def _mjcf(pl, tmp_path):
    tree = pl.SkeletonTree.from_mjcf(humanoid_mjcf(str(
        tmp_path / f"humanoid_{pl.__name__}.xml")))
    assert "torso" in tree.node_names and len(tree) >= 10
    assert int(tree.parent_indices[0]) == -1
    assert list(tree.parent_indices) == SPEC["parent"]
    np.testing.assert_allclose(tree.local_translation,
                               np.asarray(SPEC["body_pos"], np.float32))
    st = pl.SkeletonState.zero_pose(tree)
    return {"parents": tree.parent_indices, "lt": tree.local_translation,
            "gt": st.global_translation}


CASES = {"fk_straight_and_bent": _fk, "local_global_roundtrip": _roundtrip,
         "motion_velocities_and_npy_roundtrip": _motion,
         "keep_drop_nodes": _keep, "retarget_identity_mapping": _retarget,
         "from_mjcf_humanoid": _mjcf}


@pytest.mark.parametrize("case", sorted(CASES))
def test_poselib_case_matches_jax(case, tmp_path):
    got = CASES[case](tpl, tmp_path)
    want = CASES[case](jpl, tmp_path)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_fbx_gated(pkg):
    with pytest.raises(ImportError):
        PACKAGES[pkg].SkeletonMotion.from_fbx("x.fbx")


def test_rotation_core_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(16, 4)).astype(np.float32)
    b = rng.normal(size=(16, 4)).astype(np.float32)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    a, b = tpl.quat_normalize(a), tpl.quat_normalize(b)
    for name, args in (("quat_mul", (a, b)), ("quat_inverse", (a,)),
                       ("quat_rotate", (a, v)), ("quat_to_exp_map", (a,)),
                       ("quat_slerp", (a, b, 0.3)),
                       ("quat_between", (v, v[::-1])),
                       ("quat_normalize", (a * 3.0,))):
        np.testing.assert_array_equal(getattr(tpl, name)(*args),
                                      getattr(jpl, name)(*args),
                                      err_msg=name)
