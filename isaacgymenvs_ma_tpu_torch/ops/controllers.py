"""Low-level task-space controllers: the seven Factory controller modes
(port of isaacgymenvs_ma_tpu/ops/controllers.py, reference
tasks/factory/factory_control.py).

The same control math on the engine's readouts (``dynamics_readout`` /
``point_jacobian``):

* ``get_pose_error`` (ref :179-213): position and axis-angle (or quat)
  error,
* ``get_delta_dof_pos`` (ref :233-268): IK by pinv, transpose, damped least
  squares or adaptive SVD,
* ``compute_dof_torque`` (ref :74-177): joint-space PD (optionally with the
  arm mass matrix), task-space motion and force control (optionally with
  the operational-space inertia Lambda, whose two SPD inverses run through
  ``engine.spd_inverse``: kernel B5 on CUDA tensors), gripper PD, the
  +-100 N m clamp,
* ``axis_angle_from_quat`` (ref :369-382) with the small-angle guard.

The 6 x 6 inverse of damped least squares and the pinv / SVD methods are
``torch.linalg`` calls, as the JAX package computes them outside any Pallas
kernel (``inv_ex``: no host wait for the error check on the card).
``cfg_ctrl`` mirrors the reference's dict (gain_space, ik_method,
do_motion_ctrl, do_force_ctrl, do_inertial_comp, the axes and gains), its
gains tensors on the caller's device.
"""
from __future__ import annotations

import torch

from . import maths


def axis_angle_from_quat(quat: torch.Tensor, eps: float = 1.0e-6):
    """Rotation vector of xyzw quaternions (ref :369-382)."""
    mag = torch.linalg.vector_norm(quat[..., 0:3], dim=-1)
    half_angle = torch.atan2(mag, quat[..., 3])
    angle = 2.0 * half_angle
    small = torch.abs(angle) < eps
    # sin(x/2)/x ~= 1/2 - x^2/48 near zero (Taylor, as in the reference)
    sin_half_over_angle = torch.where(
        small, 0.5 - angle * angle / 48.0,
        torch.sin(half_angle) / torch.where(small, 1.0, angle))
    return quat[..., 0:3] / torch.clamp(sin_half_over_angle,
                                        min=1e-12)[..., None]


def get_pose_error(pos, quat, target_pos, target_quat,
                   rot_error_type: str = "axis_angle"):
    """Fingertip pose error (ref get_pose_error :179-213)."""
    pos_error = target_pos - pos
    quat_dot = torch.sum(quat * target_quat, dim=-1, keepdim=True)
    quat_ = torch.where(quat_dot >= 0, quat, -quat)   # shortest arc
    quat_error = maths.quat_mul(target_quat, maths.quat_conjugate(quat_))
    if rot_error_type == "quat":
        return pos_error, quat_error
    return pos_error, axis_angle_from_quat(quat_error)


def get_delta_dof_pos(delta_pose, ik_method: str, jacobian):
    """IK: the dof change of a 6-dim task-space change (ref :233-268);
    ``jacobian`` (N, 6, D)."""
    JT = jacobian.transpose(1, 2)
    if ik_method == "pinv":
        J_pinv = torch.linalg.pinv(jacobian)
        return torch.einsum("ndk,nk->nd", J_pinv, delta_pose)
    if ik_method == "trans":
        return torch.einsum("ndk,nk->nd", JT, delta_pose)
    if ik_method == "dls":
        lam = 0.1
        eye = torch.eye(jacobian.shape[1], dtype=jacobian.dtype,
                        device=jacobian.device)
        JJT = jacobian @ JT + (lam ** 2) * eye
        return torch.einsum("ndk,nk->nd",
                            JT @ torch.linalg.inv_ex(JJT).inverse,
                            delta_pose)
    if ik_method == "svd":
        U, S, Vh = torch.linalg.svd(jacobian, full_matrices=False)
        S_inv = torch.where(S > 1.0e-5, 1.0 / S, 0.0)
        J_pinv = Vh.transpose(1, 2) @ (S_inv[:, :, None]
                                       * U.transpose(1, 2))
        return torch.einsum("ndk,nk->nd", J_pinv, delta_pose)
    raise ValueError(f"unknown ik_method {ik_method}")


def apply_task_space_gains(delta_pose, linvel, angvel, task_prop_gains,
                           task_deriv_gains):
    """(ref _apply_task_space_gains :271-290)."""
    lin = task_prop_gains[..., 0:3] * delta_pose[..., 0:3] \
        + task_deriv_gains[..., 0:3] * (0.0 - linvel)
    rot = task_prop_gains[..., 3:6] * delta_pose[..., 3:6] \
        + task_deriv_gains[..., 3:6] * (0.0 - angvel)
    return torch.cat([lin, rot], -1)


def compute_dof_torque(cfg_ctrl, dof_pos, dof_vel, fingertip_pos,
                       fingertip_quat, fingertip_linvel, fingertip_angvel,
                       jacobian, arm_mass_matrix, target_gripper_dof_pos,
                       target_pos, target_quat,
                       target_contact_wrench=None,
                       left_finger_force=None, right_finger_force=None):
    """Franka 9-dof torques toward the fingertip pose target
    (ref :74-177)."""
    n = dof_pos.shape[0]
    JT = jacobian.transpose(1, 2)
    if cfg_ctrl["gain_space"] == "joint":
        pos_err, aa_err = get_pose_error(fingertip_pos, fingertip_quat,
                                         target_pos, target_quat)
        delta = torch.cat([pos_err, aa_err], -1)
        d_arm = get_delta_dof_pos(delta, cfg_ctrl["ik_method"], jacobian)
        arm_tau = cfg_ctrl["joint_prop_gains"] * d_arm \
            + cfg_ctrl["joint_deriv_gains"] * (0.0 - dof_vel[:, 0:7])
        if cfg_ctrl.get("do_inertial_comp"):
            arm_tau = torch.einsum("nij,nj->ni", arm_mass_matrix, arm_tau)
    elif cfg_ctrl["gain_space"] == "task":
        task_wrench = torch.zeros((n, 6), dtype=dof_pos.dtype,
                                  device=dof_pos.device)
        if cfg_ctrl.get("do_motion_ctrl", True):
            pos_err, aa_err = get_pose_error(fingertip_pos, fingertip_quat,
                                             target_pos, target_quat)
            delta = torch.cat([pos_err, aa_err], -1)
            w_motion = apply_task_space_gains(
                delta, fingertip_linvel, fingertip_angvel,
                cfg_ctrl["task_prop_gains"], cfg_ctrl["task_deriv_gains"])
            if cfg_ctrl.get("do_inertial_comp"):
                # operational-space Lambda = (J M^-1 J^T)^-1 (ETH eq. 3.86),
                # both inverses through B5 on the card
                from ..physics.engine import spd_inverse
                M_inv = spd_inverse(arm_mass_matrix)
                eye6 = torch.eye(6, dtype=dof_pos.dtype,
                                 device=dof_pos.device)
                lam = spd_inverse(jacobian @ M_inv @ JT + 1e-6 * eye6)
                w_motion = torch.einsum("nij,nj->ni", lam, w_motion)
            task_wrench = task_wrench + cfg_ctrl["motion_ctrl_axes"] \
                * w_motion
        if cfg_ctrl.get("do_force_ctrl"):
            w_force = target_contact_wrench
            if cfg_ctrl.get("force_ctrl_method") == "closed":
                # closed-loop wrench error from the finger force sensors
                force = left_finger_force + right_finger_force
                err = torch.cat([target_contact_wrench[:, 0:3] - force,
                                 target_contact_wrench[:, 3:6]], -1)
                w_force = w_force + cfg_ctrl["wrench_prop_gains"] * err
            task_wrench = task_wrench + cfg_ctrl["force_ctrl_axes"] * w_force
        arm_tau = torch.einsum("ndk,nk->nd", JT, task_wrench)  # J^T w
    else:
        raise ValueError(f"unknown gain_space {cfg_ctrl['gain_space']}")

    gripper_tau = cfg_ctrl["gripper_prop_gains"] * (
        target_gripper_dof_pos - dof_pos[:, 7:9]) \
        + cfg_ctrl["gripper_deriv_gains"] * (0.0 - dof_vel[:, 7:9])
    return torch.clamp(torch.cat([arm_tau, gripper_tau], -1), -100.0, 100.0)


def parse_ctrl_cfg(ctrl_cfg: dict, ctrl_type: str, num_envs: int,
                   device="cuda") -> dict:
    """``cfg_ctrl`` from the task config's ``ctrl`` section (factory_base.py
    parse_controller_spec): the ``all`` section gives every mode its
    defaults and the mode's own keys win (hydra-merge semantics); gains and
    axes as float32 tensors on ``device``."""
    c = dict(ctrl_cfg.get("all", {}))
    c.update(ctrl_cfg[ctrl_type])
    out = {"num_envs": num_envs, "ctrl_type": ctrl_type,
           "jacobian_type": c.get("jacobian_type", "geometric"),
           "ik_method": c.get("ik_method", "dls")}

    def t(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    grip = dict(gripper_prop_gains=t(c.get("gripper_prop_gains", [500, 500])),
                gripper_deriv_gains=t(c.get("gripper_deriv_gains", [20, 20])))
    if ctrl_type == "gym_default":
        out.update(gain_space="joint", do_inertial_comp=False,
                   joint_prop_gains=t(c["joint_prop_gains"]),
                   joint_deriv_gains=t(c["joint_deriv_gains"]),
                   gripper_prop_gains=t(c["gripper_prop_gains"]),
                   gripper_deriv_gains=t(c["gripper_deriv_gains"]))
    elif ctrl_type in ("joint_space_ik", "joint_space_id"):
        out.update(gain_space="joint",
                   do_inertial_comp=ctrl_type == "joint_space_id",
                   joint_prop_gains=t(c["joint_prop_gains"]),
                   joint_deriv_gains=t(c["joint_deriv_gains"]), **grip)
    elif ctrl_type in ("task_space_impedance", "operational_space_motion"):
        out.update(gain_space="task", do_motion_ctrl=True,
                   do_force_ctrl=False,
                   do_inertial_comp=ctrl_type == "operational_space_motion",
                   motion_ctrl_axes=t(c.get("motion_ctrl_axes", [1] * 6)),
                   task_prop_gains=t(c["task_prop_gains"]),
                   task_deriv_gains=t(c["task_deriv_gains"]), **grip)
    elif ctrl_type == "open_loop_force":
        out.update(gain_space="task", do_motion_ctrl=False,
                   do_force_ctrl=True, do_inertial_comp=False,
                   force_ctrl_method="open",
                   force_ctrl_axes=t(c.get("force_ctrl_axes", [1] * 6)),
                   **grip)
    elif ctrl_type == "closed_loop_force":
        out.update(gain_space="task", do_motion_ctrl=False,
                   do_force_ctrl=True, do_inertial_comp=False,
                   force_ctrl_method="closed",
                   force_ctrl_axes=t(c.get("force_ctrl_axes", [1] * 6)),
                   wrench_prop_gains=t(c["wrench_prop_gains"]), **grip)
    elif ctrl_type == "hybrid_force_motion":
        out.update(gain_space="task", do_motion_ctrl=True,
                   do_force_ctrl=True, do_inertial_comp=True,
                   force_ctrl_method="closed",
                   motion_ctrl_axes=t(c.get("motion_ctrl_axes", [1] * 6)),
                   force_ctrl_axes=t(c.get("force_ctrl_axes", [0] * 6)),
                   task_prop_gains=t(c["task_prop_gains"]),
                   task_deriv_gains=t(c["task_deriv_gains"]),
                   wrench_prop_gains=t(c["wrench_prop_gains"]), **grip)
    else:
        raise ValueError(f"unknown ctrl_type {ctrl_type}")
    return out
