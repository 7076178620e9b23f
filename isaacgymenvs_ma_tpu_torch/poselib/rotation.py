"""Rotation core (a numpy copy of isaacgymenvs_ma_tpu/poselib/rotation.py;
reference tasks/amp/poselib/poselib/core/rotation3d.py):
batched xyzw-quaternion algebra in numpy for the offline motion tooling
(the port's runtime uses ops/maths.py in PyTorch)."""
from __future__ import annotations

import numpy as np


def quat_identity(shape=()):
    q = np.zeros(tuple(shape) + (4,), np.float32)
    q[..., 3] = 1.0
    return q


def quat_normalize(q):
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)


def quat_mul(a, b):
    x1, y1, z1, w1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    x2, y2, z2, w2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], -1)


def quat_inverse(q):
    return np.concatenate([-q[..., :3], q[..., 3:4]], -1)


def quat_rotate(q, v):
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def quat_from_angle_axis(angle, axis):
    axis = np.asarray(axis, np.float32)
    axis = axis / np.maximum(np.linalg.norm(axis, axis=-1, keepdims=True),
                             1e-9)
    half = np.asarray(angle, np.float32)[..., None] * 0.5
    return np.concatenate([axis * np.sin(half), np.cos(half)], -1)


def quat_to_exp_map(q):
    """Rotation vector (axis * angle) from quaternion."""
    q = np.where(q[..., 3:4] < 0, -q, q)
    mag = np.linalg.norm(q[..., :3], axis=-1)
    angle = 2.0 * np.arctan2(mag, q[..., 3])
    axis = q[..., :3] / np.maximum(mag, 1e-9)[..., None]
    return axis * angle[..., None]


def quat_between(a, b):
    """Quaternion rotating unit vector a onto b."""
    a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-9)
    b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-9)
    c = np.cross(a, b)
    d = np.sum(a * b, -1, keepdims=True)
    q = np.concatenate([c, 1.0 + d], -1)
    return quat_normalize(q)


def quat_slerp(a, b, t):
    d = np.sum(a * b, -1, keepdims=True)
    b = np.where(d < 0, -b, b)
    d = np.abs(d)
    theta = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(theta)
    near = s[..., 0] < 1e-6
    w0 = np.where(near[..., None], 1.0 - t, np.sin((1 - t) * theta)
                  / np.maximum(s, 1e-9))
    w1 = np.where(near[..., None], t, np.sin(t * theta)
                  / np.maximum(s, 1e-9))
    return quat_normalize(w0 * a + w1 * b)
