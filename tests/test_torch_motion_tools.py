"""The port's motion tools (isaacgymenvs_ma_tpu_torch/poselib/ingest_motions.py
and retarget_motion.py) against the JAX package's scripts
(scripts/ingest_reference_motions.py ``ingest``, scripts/retarget_motion.py
``main``) on the CPU: the same inputs, the written clips' arrays within
1e-6 of each other.

* Ingest: a temp copy of a shipped clip (the run clip, 0.9 s) through both
  pipelines (identity retarget, ``to_file``, the MotionLib check), and the
  port's command line over a directory of it.
* Retarget: the clip onto a five-joint target (pelvis, torso, head and the
  two thighs of the same tree) through a joint mapping, with a target
  T-pose whose torso and thighs are turned, a rotation of 90 degrees about
  z and a scale of 0.8.
"""
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest

import isaacgymenvs_ma_tpu.poselib as jpl
import isaacgymenvs_ma_tpu_torch.poselib as tpl
from isaacgymenvs_ma_tpu_torch.poselib import ingest_motions, retarget_motion

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = os.path.join(REPO, "isaacgymenvs_ma_tpu_torch", "data", "motions",
                    "amp_humanoid_run.npy")
TOL = 1e-6


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same(a, b, what=""):
    """Two poselib dicts (nested, arrays or plain values) equal to TOL."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
        assert a.shape == b.shape, what
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=what)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _load(path):
    return np.load(path, allow_pickle=True).item()


def test_ingest_matches_jax(tmp_path, capsys):
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(CLIP, src)
    clip = str(src / os.path.basename(CLIP))
    out_j, out_t = str(tmp_path / "jax.npy"), str(tmp_path / "port.npy")
    _script("ingest_reference_motions").ingest(clip, out_j)
    drift = ingest_motions.ingest(clip, out_t)
    assert drift < 1e-4
    _same(_load(out_t), _load(out_j), "clip")
    # the identity retarget reproduces the source clip
    _same(_load(out_t)["rotation"], _load(clip)["rotation"])
    # the command line over the directory
    dst = tmp_path / "dst"
    assert ingest_motions.main(["--src", str(src), "--dst", str(dst)]) == 0
    assert os.listdir(dst) == [os.path.basename(CLIP)]
    _same(_load(str(dst / os.path.basename(CLIP))), _load(out_j), "cli")
    assert "ingested 1 clips" in capsys.readouterr().out
    with pytest.raises(SystemExit):          # --src is required
        ingest_motions.main(["--dst", str(dst)])


def _tpose(pl, tree, turns):
    """The zero pose of ``tree`` with each named joint's local rotation
    turned by (angle, axis)."""
    st = pl.SkeletonState.zero_pose(tree)
    lr = np.array(st.local_rotation)
    for name, (angle, axis) in turns.items():
        lr[tree.index(name)] = pl.quat_from_angle_axis(angle, axis)
    return pl.SkeletonState(tree, lr, st.root_translation)


def test_retarget_matches_jax(tmp_path):
    joints = ["pelvis", "torso", "head", "right_thigh", "left_thigh"]
    src_tree = tpl.SkeletonMotion.from_file(CLIP).skeleton_tree
    assert all(j in src_tree.node_names for j in joints)
    paths = {}
    for tag, pl in (("port", tpl), ("jax", jpl)):
        tree = pl.SkeletonMotion.from_file(CLIP).skeleton_tree
        src_t = pl.SkeletonState.zero_pose(tree)
        tgt_t = _tpose(pl, tree.keep_nodes_by_names(joints), {
            "torso": (0.3, [1.0, 0, 0]), "right_thigh": (-0.5, [0, 1.0, 0]),
            "left_thigh": (0.4, [0, 0, 1.0])})
        for name, st in (("src", src_t), ("tgt", tgt_t)):
            np.save(tmp_path / f"{tag}_{name}_tpose.npy", st.to_dict(),
                    allow_pickle=True)
        cfg = {"source_motion": CLIP,
               "source_tpose": str(tmp_path / f"{tag}_src_tpose.npy"),
               "target_tpose": str(tmp_path / f"{tag}_tgt_tpose.npy"),
               "target_motion_path": str(tmp_path / f"{tag}_out.npy"),
               "joint_mapping": {j: j for j in joints},
               "rotation": [0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)],
               "scale": 0.8}
        paths[tag] = str(tmp_path / f"{tag}.json")
        with open(paths[tag], "w") as f:
            json.dump(cfg, f)
    _script("retarget_motion").main(paths["jax"])
    out = retarget_motion.main(paths["port"])
    got, want = _load(str(tmp_path / "port_out.npy")), \
        _load(str(tmp_path / "jax_out.npy"))
    _same(got, want, "retarget")
    assert out.skeleton_tree.node_names == joints
    # the rotation and scale took effect: the root path turned and shrunk
    root = _load(CLIP)["root_translation"]["arr"]
    np.testing.assert_allclose(got["root_translation"]["arr"][:, :2],
                               0.8 * np.stack([-root[:, 1], root[:, 0]], -1),
                               atol=1e-5)
