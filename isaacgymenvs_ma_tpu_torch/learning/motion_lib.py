"""Motion library for AMP (port of isaacgymenvs_ma_tpu/learning/motion_lib.py,
reference tasks/amp/utils_amp/motion_lib.py).

Loads ``SkeletonMotion`` .npy files (plain numpy dicts: per-frame local
rotations, root translation, global velocities, the skeleton tree), maps
the local joint rotations to the humanoid's 28 dof coordinates (3-hinge
exp-map clusters and 1-dof knees and elbows), takes finite-difference dof
velocities, runs key-body FK and **resamples every motion to the
control-dt grid** at load time, so the runtime state fetch is a
uniform-grid lerp.  The load is numpy, as in the JAX package; the root
rotation is slerped on CPU float32 tensors, then the bank moves to the
device.  Several files make one bank padded to the longest (``edge``).

Runtime (torch, on the bank's device): ``sample_motions`` (inverse CDF of
the normalised weights: a uniform draw and ``torch.searchsorted``, so a
sample never waits on the host), ``sample_time``, ``get_motion_state``
and ``sample_state_pairs``.  Each draw comes from the caller's
``torch.Generator``, or is given: the motion ids and times.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DTYPE
from ..ops import maths

# amp_humanoid dof layout (reference tasks/amp/humanoid_amp_base.py:41-47)
DOF_BODY_IDS = [1, 2, 3, 4, 6, 7, 9, 10, 11, 12, 13, 14]
DOF_OFFSETS = [0, 3, 6, 9, 10, 13, 14, 17, 18, 21, 24, 25, 28]
KEY_BODY_NAMES = ["right_hand", "left_hand", "right_foot", "left_foot"]
NUM_DOF = DOF_OFFSETS[-1]

# single-dof joints rotate about these local axes (knees and elbows in
# amp_humanoid.xml; the reference extracts the same components)
_1DOF_AXIS = {4: 1, 7: 1, 10: 1, 13: 1}  # body_id -> axis idx (y)


def _quat_to_exp_np(q):
    sin_half = np.linalg.norm(q[..., 0:3], axis=-1)
    angle = 2.0 * np.arctan2(sin_half, q[..., 3])
    angle = np.arctan2(np.sin(angle), np.cos(angle))
    axis = q[..., 0:3] / np.maximum(sin_half, 1e-9)[..., None]
    axis = np.where((sin_half > 1e-5)[..., None], axis,
                    np.array([0.0, 0, 1.0]))
    return angle[..., None] * axis


def _fk_positions(parents, local_t, root_pos, local_rot):
    """Global body positions from local rotations (poselib FK semantics)."""
    T, nb = local_rot.shape[0], local_rot.shape[1]
    g_rot = np.zeros_like(local_rot)
    g_pos = np.zeros((T, nb, 3), np.float32)

    def qmul(a, b):
        x1, y1, z1, w1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        x2, y2, z2, w2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return np.stack([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)

    def qrot(q, v):
        xyz, w = q[..., :3], q[..., 3:4]
        t = 2.0 * np.cross(xyz, v)
        return v + w * t + np.cross(xyz, t)

    for b in range(nb):
        p = parents[b]
        if p < 0:
            g_rot[:, b] = local_rot[:, b]
            g_pos[:, b] = root_pos
        else:
            g_rot[:, b] = qmul(g_rot[:, p], local_rot[:, b])
            g_pos[:, b] = g_pos[:, p] + qrot(g_rot[:, p],
                                             np.broadcast_to(local_t[b], (T, 3)))
    return g_pos, g_rot


class MotionData(NamedTuple):
    """Uniform-dt resampled motion bank (padded over motions)."""

    root_pos: torch.Tensor       # (M, T, 3)
    root_rot: torch.Tensor       # (M, T, 4)
    root_vel: torch.Tensor       # (M, T, 3)
    root_ang_vel: torch.Tensor   # (M, T, 3)
    dof_pos: torch.Tensor        # (M, T, 28)
    dof_vel: torch.Tensor        # (M, T, 28)
    key_pos: torch.Tensor        # (M, T, 4, 3)
    length_s: torch.Tensor       # (M,)
    num_frames: torch.Tensor     # (M,) int64
    weights: torch.Tensor        # (M,) sampling weights (normalized)


class MotionLib:
    def __init__(self, motion_files, dt: float, weights=None,
                 device="cuda"):
        """``motion_files``: a .npy path or a list of paths or (path,
        weight) pairs; a missing file raises ``FileNotFoundError``."""
        if isinstance(motion_files, str):
            motion_files = [motion_files]
        files, ws = [], []
        for m in motion_files:
            if isinstance(m, (tuple, list)):
                files.append(m[0])
                ws.append(float(m[1]))
            else:
                files.append(m)
                ws.append(1.0)
        if weights is not None:
            ws = list(weights)
        for f in files:
            if not os.path.isfile(f):
                raise FileNotFoundError(f"motion file {f} not found")
        self.dt = float(dt)
        self.device = torch.device(device)
        banks = [self._load(f) for f in files]
        T_max = max(b["root_pos"].shape[0] for b in banks)

        def pad(key):
            out = []
            for b in banks:
                a = b[key]
                reps = [(0, T_max - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
                out.append(np.pad(a, reps, mode="edge"))
            return self._on(np.stack(out).astype(np.float32))

        w = np.asarray(ws, np.float64)
        self.data = MotionData(
            root_pos=pad("root_pos"), root_rot=pad("root_rot"),
            root_vel=pad("root_vel"), root_ang_vel=pad("root_ang_vel"),
            dof_pos=pad("dof_pos"), dof_vel=pad("dof_vel"),
            key_pos=pad("key_pos"),
            length_s=self._on(np.asarray(
                [(b["root_pos"].shape[0] - 1) * self.dt for b in banks],
                np.float32)),
            num_frames=torch.as_tensor(
                [b["root_pos"].shape[0] for b in banks], dtype=torch.int64,
                device=self.device),
            weights=self._on(np.asarray(w / w.sum(), np.float32)),
        )
        # the inverse CDF of the weights (float32, as the weights)
        self.cdf = torch.cumsum(self.data.weights, 0)
        self.num_motions = len(banks)

    def _on(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=DTYPE).to(self.device)

    # -- loading ---------------------------------------------------------
    def _load(self, path: str) -> dict:
        raw = np.load(path, allow_pickle=True).item()
        fps = float(np.asarray(raw["fps"]))
        rot = raw["rotation"]["arr"].astype(np.float32)        # (T, 15, 4)
        root_pos = raw["root_translation"]["arr"].astype(np.float32)
        gvel = raw["global_velocity"]["arr"].astype(np.float32)
        gavel = raw["global_angular_velocity"]["arr"].astype(np.float32)
        tree = raw["skeleton_tree"]
        parents = np.asarray(tree["parent_indices"]["arr"])
        local_t = np.asarray(tree["local_translation"]["arr"], np.float32)
        names = list(tree["node_names"])
        key_ids = [names.index(n) for n in KEY_BODY_NAMES]

        T = rot.shape[0]
        src_dt = 1.0 / fps
        # local rotations -> 28 dof coordinates (motion_lib.py:221-248)
        dof_pos = np.zeros((T, NUM_DOF), np.float32)
        for j, b in enumerate(DOF_BODY_IDS):
            off = DOF_OFFSETS[j]
            size = DOF_OFFSETS[j + 1] - off
            q = rot[:, b]
            if size == 3:
                dof_pos[:, off: off + 3] = _quat_to_exp_np(q)
            else:
                exp = _quat_to_exp_np(q)
                dof_pos[:, off] = exp[:, _1DOF_AXIS.get(b, 1)]
        dof_vel = np.zeros_like(dof_pos)
        dof_vel[:-1] = (dof_pos[1:] - dof_pos[:-1]) * fps
        dof_vel[-1] = dof_vel[-2] if T > 1 else 0.0

        g_pos, _ = _fk_positions(parents, local_t, root_pos, rot)
        key_pos = g_pos[:, key_ids]

        bank = dict(root_pos=root_pos, root_rot=rot[:, 0], root_vel=gvel[:, 0],
                    root_ang_vel=gavel[:, 0], dof_pos=dof_pos, dof_vel=dof_vel,
                    key_pos=key_pos)
        # resample from src fps grid to the control-dt grid
        length = (T - 1) * src_dt
        n_out = max(int(length / self.dt) + 1, 2)
        t_out = np.arange(n_out) * self.dt
        idx = np.minimum((t_out / src_dt).astype(int), T - 2)
        frac = (t_out / src_dt - idx)[:, None].astype(np.float32)

        def lerp(a):
            flat = a.reshape(T, -1)
            out = flat[idx] * (1 - frac) + flat[idx + 1] * frac
            return out.reshape((n_out,) + a.shape[1:])

        out = {k: lerp(v) for k, v in bank.items() if k != "root_rot"}
        # slerp root rotation, float32 on the CPU
        q0, q1 = bank["root_rot"][idx], bank["root_rot"][idx + 1]
        out["root_rot"] = maths.slerp(
            torch.as_tensor(q0), torch.as_tensor(q1),
            torch.as_tensor(frac)).numpy()
        return out

    # -- runtime sampling --------------------------------------------------
    def sample_motions(self, n: int, generator: Optional[torch.Generator]
                       = None) -> torch.Tensor:
        """(n,) motion ids drawn by the normalised weights
        (motion_lib.py:61-65): a uniform draw through the inverse CDF."""
        u = torch.rand(n, generator=generator, device=self.device,
                       dtype=DTYPE)
        ids = torch.searchsorted(self.cdf, u, right=True)
        return torch.clamp(ids, max=self.num_motions - 1)

    def sample_time(self, motion_ids, generator: Optional[torch.Generator]
                    = None, truncate_t: float = 0.0) -> torch.Tensor:
        """Uniform times within each motion, ``truncate_t`` short of its
        end (motion_lib.py:67-81)."""
        lens = self.data.length_s[motion_ids] - truncate_t
        u = torch.rand(motion_ids.shape, generator=generator,
                       device=self.device, dtype=DTYPE)
        return u * torch.clamp(lens, min=0.0)

    def get_motion_state(self, motion_ids, motion_times) -> dict:
        """Batched state fetch with uniform-grid lerp (motion_lib.py:83-153);
        the root rotation slerped."""
        d = self.data
        ids = motion_ids.long()
        f = motion_times / self.dt
        n = d.num_frames[ids]
        i0 = torch.minimum(torch.clamp(torch.floor(f).long(), min=0), n - 2)
        i1 = i0 + 1
        t = torch.clamp(f - i0, 0.0, 1.0)[:, None]

        def lerp(arr):
            a0, a1 = arr[ids, i0], arr[ids, i1]
            tt = t.reshape(t.shape + (1,) * (a0.dim() - 2))
            return a0 * (1 - tt) + a1 * tt

        root_rot = maths.slerp(d.root_rot[ids, i0], d.root_rot[ids, i1], t)
        return dict(
            root_pos=lerp(d.root_pos), root_rot=root_rot,
            root_vel=lerp(d.root_vel), root_ang_vel=lerp(d.root_ang_vel),
            dof_pos=lerp(d.dof_pos), dof_vel=lerp(d.dof_vel),
            key_pos=lerp(d.key_pos),
        )

    def sample_state_pairs(self, n: int, pair_dt: float,
                           generator: Optional[torch.Generator] = None,
                           draws=None):
        """(s_{t-dt}, s_t) transition pairs for the AMP demos
        (humanoid_amp.py:105-134 fetch_amp_obs_demo).  ``draws``: (motion
        ids (n,), times (n,) as ``sample_time(ids, truncate_t=pair_dt)``
        gives them), else drawn from ``generator``."""
        if draws is None:
            ids = self.sample_motions(n, generator)
            times = self.sample_time(ids, generator, truncate_t=pair_dt)
        else:
            ids, times = draws
        t1 = times + pair_dt
        s1 = self.get_motion_state(ids, t1)
        s0 = self.get_motion_state(ids, t1 - pair_dt)
        return s0, s1
