"""Offline motion tooling (a numpy copy of isaacgymenvs_ma_tpu/poselib) (the reference's tasks/amp/poselib, ~3.5 kLoC):
skeleton trees/states/motions, rotation core, T-pose retargeting, .npy
round-trip compatible with learning/motion_lib.py."""
from .rotation import (quat_between, quat_from_angle_axis, quat_identity,
                       quat_inverse, quat_mul, quat_normalize, quat_rotate,
                       quat_slerp, quat_to_exp_map)
from .skeleton import SkeletonMotion, SkeletonState, SkeletonTree
