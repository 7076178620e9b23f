"""Batched quaternion / transform / scaling math (port of
isaacgymenvs_ma_tpu/ops/maths.py).

Same conventions as the JAX module: quaternions are ``(x, y, z, w)`` in the
last axis, every function broadcasts over leading batch axes, float32.
Constant arguments (axes, basis vectors) may be tensors or array-likes; they
are moved to the device and dtype of the batched argument.
"""
from __future__ import annotations

import math

import torch


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    """``v`` as a tensor on ``ref``'s device and dtype."""
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _unit_vec(ref: torch.Tensor, axis: int) -> torch.Tensor:
    v = torch.zeros(ref.shape[:-1] + (3,), dtype=ref.dtype, device=ref.device)
    v[..., axis] = 1.0
    return v


# ---------------------------------------------------------------------------
# basics


def normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Unit-normalize along the last axis (ref torch_jit_utils.py:66)."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def tensor_clamp(t, lo, hi):
    return torch.maximum(torch.minimum(t, _like(hi, t)), _like(lo, t))


saturate = tensor_clamp  # ref :338-351


def scale(x, lower, upper):
    """[-1,1] -> [lower,upper] (ref :234)."""
    return 0.5 * (x + 1.0) * (upper - lower) + lower


def unscale(x, lower, upper):
    """[lower,upper] -> [-1,1] (ref :239)."""
    return (2.0 * x - upper - lower) / (upper - lower)


def scale_transform(x, lower, upper):
    """Normalize to [-1,1] with broadcasting (ref :292-311)."""
    offset = (lower + upper) * 0.5
    return 2.0 * (x - offset) / (upper - lower)


def unscale_transform(x, lower, upper):
    """Denormalize from [-1,1] (ref :313-333)."""
    offset = (lower + upper) * 0.5
    return x * (upper - lower) * 0.5 + offset


def normalize_angle(x):
    """Wrap angle to (-pi, pi] (ref :130)."""
    return torch.atan2(torch.sin(x), torch.cos(x))


# ---------------------------------------------------------------------------
# quaternions (xyzw)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, xyzw layout (ref :42-63)."""
    x1, y1, z1, w1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    x2, y2, z2, w2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    return torch.stack([x, y, z, w], dim=-1)


def quat_conjugate(a: torch.Tensor) -> torch.Tensor:
    """(ref :107)."""
    return torch.cat([-a[..., :3], a[..., 3:4]], dim=-1)


def quat_unit(a):
    return normalize(a)


def quat_apply(a: torch.Tensor, b) -> torch.Tensor:
    """Rotate vector(s) b by quaternion(s) a (ref :71-79)."""
    b = _like(b, a)
    xyz = a[..., :3]
    w = a[..., 3:4]
    t = 2.0 * _cross(xyz, b)
    return b + w * t + _cross(xyz, t)


# quat_rotate / quat_rotate_inverse (ref :81-105) are the same rotation as
# quat_apply, just a different evaluation order; one implementation is kept.
quat_rotate = quat_apply
tf_vector = quat_apply
get_basis_vector = quat_apply


def quat_rotate_inverse(q: torch.Tensor, v) -> torch.Tensor:
    """Rotate v by q^-1 (ref :95-105)."""
    return quat_apply(quat_conjugate(q), v)


def quat_from_angle_axis(angle: torch.Tensor, axis) -> torch.Tensor:
    """(ref :119-124)."""
    axis = _like(axis, angle)
    theta = (angle / 2)[..., None]
    xyz = normalize(axis) * torch.sin(theta)
    w = torch.cos(theta).expand(xyz.shape[:-1] + (1,))
    return quat_unit(torch.cat([xyz, w], dim=-1))


def quat_axis(q: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Basis vector of rotated frame (ref :293-297)."""
    return quat_apply(q, _unit_vec(q, axis))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion -> 3x3 rotation matrix (batched)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_diff_rad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation angle between two quaternions (ref :354-375)."""
    mul = quat_mul(a, quat_conjugate(b))
    sin_half = torch.linalg.vector_norm(mul[..., :3], dim=-1)
    return 2.0 * torch.asin(torch.clamp(sin_half, -1.0, 1.0))


def axisangle2quat(vec: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Exponential-map rotation vector -> xyzw quaternion (the fork's
    ``tasks/franka_reach.py`` helper, reused by the MA tasks)."""
    angle = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    small = angle < eps
    safe_angle = torch.where(small, torch.ones_like(angle), angle)
    xyz = vec * torch.where(small, torch.full_like(angle, 0.5),
                            torch.sin(safe_angle / 2) / safe_angle)
    w = torch.cos(angle / 2)
    return torch.cat([xyz, w], dim=-1)


# ---------------------------------------------------------------------------
# euler


def copysign_scalar(a: float, b: torch.Tensor) -> torch.Tensor:
    """|a| with sign of b (ref :169-173)."""
    return abs(a) * torch.sign(b)


def get_euler_xyz(q: torch.Tensor):
    """Quaternion -> (roll, pitch, yaw), each wrapped to [0, 2pi)
    (ref :176-198)."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (qw * qx + qy * qz)
    cosr_cosp = qw * qw - qx * qx - qy * qy + qz * qz
    roll = torch.atan2(sinr_cosp, cosr_cosp)

    sinp = 2.0 * (qw * qy - qz * qx)
    pitch = torch.where(
        torch.abs(sinp) >= 1.0, copysign_scalar(math.pi / 2.0, sinp),
        torch.asin(torch.clamp(sinp, -1.0, 1.0)))

    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = qw * qw + qx * qx - qy * qy - qz * qz
    yaw = torch.atan2(siny_cosp, cosy_cosp)

    two_pi = 2 * math.pi
    return roll % two_pi, pitch % two_pi, yaw % two_pi


def quat_from_euler_xyz(roll, pitch, yaw):
    """(ref :201-214)."""
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    return torch.stack([qx, qy, qz, qw], dim=-1)


# ---------------------------------------------------------------------------
# transforms (quat, trans) pairs


def tf_inverse(q, t):
    """(ref :133-136)."""
    q_inv = quat_conjugate(q)
    return q_inv, -quat_apply(q_inv, t)


def tf_apply(q, t, v):
    """(ref :138-141)."""
    return quat_apply(q, v) + t


def tf_combine(q1, t1, q2, t2):
    """(ref :148-151)."""
    return quat_mul(q1, q2), quat_apply(q1, t2) + t1


def get_axis_params(value, axis_idx, x_value=0.0, n_dims=3):
    """Axis-aligned parameter vector (ref :156-165); host-side list."""
    params = [0.0] * n_dims
    params[axis_idx] = float(value)
    params[0] = x_value
    return params


# ---------------------------------------------------------------------------
# locomotion helpers (Ant/Humanoid family)


def compute_heading_and_up(torso_rotation, inv_start_rot, to_target, vec0,
                           vec1, up_idx):
    """(ref :248-263)."""
    target_dirs = normalize(to_target)
    torso_quat = quat_mul(torso_rotation, _like(inv_start_rot, torso_rotation))
    up_vec = quat_apply(torso_quat, vec1)
    heading_vec = quat_apply(torso_quat, vec0)
    up_proj = up_vec[..., up_idx]
    heading_proj = torch.sum(heading_vec * target_dirs, dim=-1)
    return torso_quat, up_proj, heading_proj, up_vec, heading_vec


def compute_rot(torso_quat, velocity, ang_velocity, targets, torso_positions):
    """(ref :266-277)."""
    vel_loc = quat_rotate_inverse(torso_quat, velocity)
    angvel_loc = quat_rotate_inverse(torso_quat, ang_velocity)
    roll, pitch, yaw = get_euler_xyz(torso_quat)
    targets = _like(targets, torso_positions)
    walk_target_angle = torch.atan2(
        targets[..., 2] - torso_positions[..., 2],
        targets[..., 0] - torso_positions[..., 0])
    angle_to_target = walk_target_angle - yaw
    return vel_loc, angvel_loc, roll, pitch, yaw, angle_to_target


# ---------------------------------------------------------------------------
# AMP rotation conversions (reference utils/torch_jit_utils.py:377-567)


def quat_to_tan_norm(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> 6d tangent/normal rotation representation
    (ref :380-394)."""
    tan = quat_apply(q, _unit_vec(q, 0))
    norm = quat_apply(q, _unit_vec(q, 2))
    return torch.cat([tan, norm], dim=-1)


def quat_to_exp_map(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> exponential map (ref :425-434 via angle-axis)."""
    sin_half = torch.linalg.vector_norm(q[..., 0:3], dim=-1)
    angle = 2.0 * torch.atan2(sin_half, q[..., 3])
    angle = normalize_angle(angle)
    axis = q[..., 0:3] / torch.clamp(sin_half, min=1e-9)[..., None]
    mask = (sin_half > 1e-5)[..., None]
    axis = torch.where(mask, axis, _unit_vec(q, 2))
    return angle[..., None] * axis


def exp_map_to_quat(exp_map: torch.Tensor) -> torch.Tensor:
    """Exponential map -> quaternion (ref :437-451)."""
    angle = torch.linalg.vector_norm(exp_map, dim=-1)
    axis = exp_map / torch.clamp(angle, min=1e-9)[..., None]
    mask = (angle > 1e-5)[..., None]
    axis = torch.where(mask, axis, _unit_vec(exp_map, 2))
    return quat_from_angle_axis(angle, axis)


def calc_heading(q: torch.Tensor) -> torch.Tensor:
    """Heading angle about z of the rotated x-axis (ref :533-540)."""
    rot_dir = quat_apply(q, _unit_vec(q, 0))
    return torch.atan2(rot_dir[..., 1], rot_dir[..., 0])


def calc_heading_quat(q: torch.Tensor) -> torch.Tensor:
    return quat_from_angle_axis(calc_heading(q), _unit_vec(q, 2))


def calc_heading_quat_inv(q: torch.Tensor) -> torch.Tensor:
    """(ref :556-566)."""
    return quat_from_angle_axis(-calc_heading(q), _unit_vec(q, 2))


def slerp(q0, q1, t):
    """Quaternion slerp (batched, ref poselib semantics)."""
    t = _like(t, q0)
    cos_half = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(cos_half < 0, -q1, q1)
    cos_half = torch.abs(cos_half)
    half = torch.acos(torch.clamp(cos_half, -1.0, 1.0))
    sin_half = torch.sqrt(torch.clamp(1.0 - cos_half * cos_half, min=1e-12))
    ratio_a = torch.where(sin_half > 1e-5,
                          torch.sin((1 - t) * half) / sin_half, 1 - t)
    ratio_b = torch.where(sin_half > 1e-5,
                          torch.sin(t * half) / sin_half, t)
    return normalize(ratio_a * q0 + ratio_b * q1)
