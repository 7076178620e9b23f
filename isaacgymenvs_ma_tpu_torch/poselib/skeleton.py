"""Skeleton tree / state / motion (a numpy copy of
isaacgymenvs_ma_tpu/poselib/skeleton.py; reference
tasks/amp/poselib/poselib/skeleton/skeleton3d.py:42,290,1026 — ~2 kLoC)
re-built as plain-numpy offline tooling.

Differences from the reference: no torch tensor backend (numpy arrays),
FBX import is gated (the proprietary FBX SDK is unavailable; convert to
.npy offline), and retargeting implements the T-pose method
(``retarget_to_by_tpose`` :978) — rotation transfer through per-joint
mapping with T-pose correction plus root-translation scaling.
The ``.npy`` dict format round-trips with learning/motion_lib.py.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np

from .rotation import (quat_between, quat_from_angle_axis, quat_identity,
                       quat_inverse, quat_mul, quat_normalize, quat_rotate,
                       quat_slerp, quat_to_exp_map)


class SkeletonTree:
    """Static topology: node names, parent indices, local translations
    (ref :42-288)."""

    def __init__(self, node_names: List[str], parent_indices: np.ndarray,
                 local_translation: np.ndarray):
        self.node_names = list(node_names)
        self.parent_indices = np.asarray(parent_indices, np.int64)
        self.local_translation = np.asarray(local_translation, np.float32)

    def __len__(self):
        return len(self.node_names)

    @property
    def num_joints(self):
        return len(self)

    def index(self, node_name: str) -> int:
        return self.node_names.index(node_name)

    def parent_of(self, node_name: str) -> Optional[str]:
        p = int(self.parent_indices[self.index(node_name)])
        return self.node_names[p] if p >= 0 else None

    # -- serialization --------------------------------------------------
    @classmethod
    def from_dict(cls, d: dict) -> "SkeletonTree":
        return cls(list(d["node_names"]), np.asarray(d["parent_indices"]),
                   np.asarray(d["local_translation"]))

    def to_dict(self) -> dict:
        return {"node_names": list(self.node_names),
                "parent_indices": self.parent_indices.copy(),
                "local_translation": self.local_translation.copy()}

    @classmethod
    def from_mjcf(cls, path: str) -> "SkeletonTree":
        """Parse an MJCF body tree (ref :176-221)."""
        root = ET.parse(path).getroot()
        world = root.find("worldbody")
        names, parents, trans = [], [], []

        def visit(node, parent_idx):
            name = node.attrib.get("name", f"body_{len(names)}")
            pos = np.fromstring(node.attrib.get("pos", "0 0 0"), sep=" ")
            idx = len(names)
            names.append(name)
            parents.append(parent_idx)
            trans.append(pos)
            for child in node.findall("body"):
                visit(child, idx)

        for body in world.findall("body"):
            visit(body, -1)
        return cls(names, np.asarray(parents), np.asarray(trans, np.float32))

    # -- editing --------------------------------------------------------
    def keep_nodes_by_names(self, names: Sequence[str]) -> "SkeletonTree":
        """Subtree restriction (ref :283-288): kept nodes re-parent to their
        nearest kept ancestor, local translations accumulate."""
        keep = [n for n in self.node_names if n in set(names)]
        new_idx = {n: i for i, n in enumerate(keep)}
        parents, trans = [], []
        for n in keep:
            i = self.index(n)
            t = self.local_translation[i].copy()
            p = int(self.parent_indices[i])
            while p >= 0 and self.node_names[p] not in new_idx:
                t = t + self.local_translation[p]
                p = int(self.parent_indices[p])
            parents.append(new_idx[self.node_names[p]] if p >= 0 else -1)
            trans.append(t)
        return SkeletonTree(keep, np.asarray(parents),
                            np.asarray(trans, np.float32))

    def drop_nodes_by_names(self, names: Sequence[str]) -> "SkeletonTree":
        return self.keep_nodes_by_names(
            [n for n in self.node_names if n not in set(names)])


class SkeletonState:
    """Pose = per-joint local rotations + root translation (ref :290-1024).
    Arrays broadcast over leading (time) axes."""

    def __init__(self, skeleton_tree: SkeletonTree, local_rotation,
                 root_translation):
        self.skeleton_tree = skeleton_tree
        self.local_rotation = np.asarray(local_rotation, np.float32)
        self.root_translation = np.asarray(root_translation, np.float32)

    @classmethod
    def zero_pose(cls, tree: SkeletonTree) -> "SkeletonState":
        return cls(tree, quat_identity((len(tree),)), np.zeros(3, np.float32))

    @classmethod
    def from_rotation_and_root_translation(cls, tree, r, t, is_local=True):
        if is_local:
            return cls(tree, r, t)
        # convert global rotations to local (ref is_local=False path)
        r = np.asarray(r, np.float32)
        local = r.copy()
        for i, p in enumerate(tree.parent_indices):
            if p >= 0:
                local[..., i, :] = quat_mul(quat_inverse(r[..., p, :]),
                                            r[..., i, :])
        return cls(tree, local, t)

    # -- forward kinematics --------------------------------------------
    @property
    def global_rotation(self):
        tree = self.skeleton_tree
        lr = self.local_rotation
        out = np.empty_like(lr)
        for i, p in enumerate(tree.parent_indices):
            if p < 0:
                out[..., i, :] = lr[..., i, :]
            else:
                out[..., i, :] = quat_mul(out[..., p, :], lr[..., i, :])
        return out

    @property
    def global_translation(self):
        tree = self.skeleton_tree
        gr = self.global_rotation
        J = len(tree)
        shape = self.local_rotation.shape[:-2] + (J, 3)
        out = np.empty(shape, np.float32)
        for i, p in enumerate(tree.parent_indices):
            if p < 0:
                out[..., i, :] = self.root_translation
            else:
                out[..., i, :] = out[..., p, :] + quat_rotate(
                    gr[..., p, :], tree.local_translation[i])
        return out

    @property
    def global_root_rotation(self):
        return self.local_rotation[..., 0, :]

    # -- serialization (.npy dict) --------------------------------------
    # Arrays are wrapped as {"arr": ndarray} matching the reference
    # poselib tensor-dict layout, so reference-converted .npy motions and
    # ours are interchangeable (learning/motion_lib.py reads both).
    def to_dict(self) -> dict:
        tree = self.skeleton_tree
        return {"skeleton_tree": {
                    "node_names": list(tree.node_names),
                    "parent_indices": {"arr": tree.parent_indices.copy()},
                    "local_translation": {"arr": tree.local_translation.copy()}},
                "rotation": {"arr": self.local_rotation.copy()},
                "root_translation": {"arr": self.root_translation.copy()},
                "is_local": True}

    @classmethod
    def from_dict(cls, d: dict) -> "SkeletonState":
        td = d["skeleton_tree"]
        tree = SkeletonTree(list(td["node_names"]),
                            _unwrap(td["parent_indices"]),
                            _unwrap(td["local_translation"]))
        st = cls(tree, _unwrap(d["rotation"]),
                 _unwrap(d["root_translation"]))
        if not d.get("is_local", True):
            return cls.from_rotation_and_root_translation(
                st.skeleton_tree, st.local_rotation, st.root_translation,
                is_local=False)
        return st


def _unwrap(v):
    """Accept both raw arrays and the reference's {"arr": ...} wrapping."""
    if isinstance(v, dict) and "arr" in v:
        return np.asarray(v["arr"])
    return np.asarray(v)


def _gaussian_smooth(x, sigma=1.0):
    r = int(np.ceil(2 * sigma))
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    pad = [(r, r)] + [(0, 0)] * (x.ndim - 1)
    xp = np.pad(x, pad, mode="edge")
    out = np.zeros_like(x)
    for i, w in enumerate(k):
        out += w * xp[i: i + x.shape[0]]
    return out


class SkeletonMotion(SkeletonState):
    """Timed pose sequence with derived velocities (ref :1026-1412)."""

    def __init__(self, skeleton_tree, local_rotation, root_translation,
                 fps: float):
        super().__init__(skeleton_tree, local_rotation, root_translation)
        self.fps = float(fps)

    @property
    def time_delta(self):
        return 1.0 / self.fps

    @property
    def num_frames(self):
        return self.local_rotation.shape[0]

    @property
    def global_velocity(self):
        """Finite-difference linear velocities (ref _compute_velocity
        :1251-1259, gaussian-filtered)."""
        p = self.global_translation
        v = np.gradient(p, self.time_delta, axis=0)
        return _gaussian_smooth(v)

    @property
    def global_angular_velocity(self):
        """(ref _compute_angular_velocity :1261-1274)."""
        r = self.global_rotation
        dq = quat_mul(r[1:], quat_inverse(r[:-1]))
        w = quat_to_exp_map(dq) / self.time_delta
        w = np.concatenate([w, w[-1:]], 0)
        return _gaussian_smooth(w)

    @property
    def global_root_velocity(self):
        return self.global_velocity[..., 0, :]

    @property
    def global_root_angular_velocity(self):
        return self.global_angular_velocity[..., 0, :]

    def crop(self, start: int, end: int,
             fps: Optional[float] = None) -> "SkeletonMotion":
        return SkeletonMotion(self.skeleton_tree,
                              self.local_rotation[start:end],
                              self.root_translation[start:end],
                              fps or self.fps)

    # -- serialization --------------------------------------------------
    def to_dict(self) -> dict:
        d = super().to_dict()
        d["fps"] = self.fps
        d["global_velocity"] = {"arr": self.global_velocity}
        d["global_angular_velocity"] = {"arr": self.global_angular_velocity}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SkeletonMotion":
        st = SkeletonState.from_dict(d)
        return cls(st.skeleton_tree, st.local_rotation, st.root_translation,
                   float(d.get("fps", 30.0)))

    def to_file(self, path: str):
        np.save(path, self.to_dict(), allow_pickle=True)

    @classmethod
    def from_file(cls, path: str) -> "SkeletonMotion":
        return cls.from_dict(np.load(path, allow_pickle=True).item())

    @classmethod
    def from_fbx(cls, *args, **kwargs):
        raise ImportError(
            "FBX import requires the proprietary Autodesk FBX SDK (the "
            "reference gates it the same way — poselib fbx backend). "
            "Convert FBX to the .npy dict format offline and use from_file.")

    # -- retargeting (ref retarget_to_by_tpose :978-1024, :1373-1412) ---
    def retarget_to_by_tpose(
        self, joint_mapping: Dict[str, str],
        source_tpose: SkeletonState, target_tpose: SkeletonState,
        rotation_to_target_skeleton=None, scale_to_target_skeleton: float = 1.0,
    ) -> "SkeletonMotion":
        """Transfer motion onto the target skeleton: per-joint global
        rotations are carried through the mapping with T-pose correction
        (q_tgt = q_src * q_src_tpose^-1 * q_tgt_tpose per mapped joint),
        root translation is scaled by ``scale_to_target_skeleton``."""
        tgt_tree = target_tpose.skeleton_tree
        T = self.num_frames
        src_g = self.global_rotation                       # (T, Js, 4)
        src_tpose_g = source_tpose.global_rotation         # (Js, 4)
        tgt_tpose_g = target_tpose.global_rotation         # (Jt, 4)
        rot_extra = rotation_to_target_skeleton
        if rot_extra is None:
            rot_extra = quat_identity(())

        tgt_global = np.tile(quat_identity((len(tgt_tree),)), (T, 1, 1))
        for src_name, tgt_name in joint_mapping.items():
            si = self.skeleton_tree.index(src_name)
            ti = tgt_tree.index(tgt_name)
            # motion of the source joint relative to its tpose, applied to
            # the target's tpose orientation
            delta = quat_mul(src_g[:, si],
                             quat_inverse(src_tpose_g[si])[None])
            delta = quat_mul(rot_extra[None], delta)
            tgt_global[:, ti] = quat_normalize(
                quat_mul(delta, tgt_tpose_g[ti][None]))

        root_t = quat_rotate(rot_extra[None],
                             self.root_translation) * scale_to_target_skeleton
        st = SkeletonState.from_rotation_and_root_translation(
            tgt_tree, tgt_global, root_t, is_local=False)
        return SkeletonMotion(tgt_tree, st.local_rotation,
                              st.root_translation, self.fps)
