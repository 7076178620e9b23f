"""Task-space controllers (port of isaacgymenvs_ma_tpu/physics/controllers.py).

``osc_torques`` is the fork's per-arm operational-space controller
(Khatib 1987 OSC with nullspace posture control, franka_reach_MA.py:770-802
of the reference), on batched per-arm mass matrices and end-effector
Jacobians from :meth:`.engine.PhysicsEngine.dynamics_readout` and
:meth:`~.engine.PhysicsEngine.point_jacobian`.  Its two SPD inverses go
through :func:`.engine.spd_inverse`, i.e. kernel B5 on the card.
"""
from __future__ import annotations

import math

import torch

from .engine import spd_inverse


def osc_torques(mm, j_eef, eef_vel, q, qd, dpose, default_dof_pos,
                kp=150.0, kd=None, kp_null=10.0, kd_null=None,
                effort_limit=None):
    """Batched OSC: (B, n, n) mass matrix, (B, 6, n) Jacobian -> (B, n)
    torques (controllers.py:19-50 of the JAX package).

    ``dpose``: desired 6-dof pose delta [dpos(3), drot(3)];
    ``eef_vel``: [linvel(3), angvel(3)] of the end effector."""
    kd = 2.0 * math.sqrt(kp) if kd is None else kd
    kd_null = 2.0 * math.sqrt(kp_null) if kd_null is None else kd_null
    j_t = j_eef.transpose(1, 2)
    # both inverses are SPD (the mass matrix; J M^-1 J^T)
    mm_inv = spd_inverse(mm)
    m_eef = spd_inverse(j_eef @ mm_inv @ j_t)
    u = j_t @ m_eef @ (kp * dpose - kd * eef_vel)[..., None]

    # nullspace posture control toward the default configuration; the
    # angle is wrapped with a floor modulo (jnp's %), not fmod
    j_eef_inv = m_eef @ j_eef @ mm_inv
    u_null = kd_null * -qd + kp_null * (
        torch.remainder(default_dof_pos - q + math.pi, 2 * math.pi) - math.pi)
    u_null = mm @ u_null[..., None]
    proj = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device) \
        - j_t @ j_eef_inv
    u = (u + proj @ u_null)[..., 0]
    if effort_limit is not None:
        u = torch.clamp(u, -effort_limit, effort_limit)
    return u
