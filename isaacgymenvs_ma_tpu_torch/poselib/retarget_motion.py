"""Offline motion retargeting over the port's poselib (counterpart of
scripts/retarget_motion.py, reference tasks/amp/poselib/retarget_motion.py):
map a source .npy motion onto a target skeleton through a T-pose joint
mapping::

    python -m isaacgymenvs_ma_tpu_torch.poselib.retarget_motion config.json

The config has the reference's retarget schema: ``source_motion``,
``source_tpose``, ``target_tpose``, ``target_motion_path``,
``joint_mapping`` {source joint: target joint}, and optionally
``rotation`` (xyzw, applied to the motion) and ``scale`` (of the root
translation).  T-pose .npy files hold a SkeletonState dict, motions a
SkeletonMotion dict (the poselib format).  Nothing here touches a GPU.
"""
from __future__ import annotations

import json
import sys

import numpy as np

from .skeleton import SkeletonMotion, SkeletonState


def main(cfg_path: str) -> SkeletonMotion:
    """Retarget as the config at ``cfg_path`` says; writes and returns the
    target motion."""
    with open(cfg_path) as f:
        cfg = json.load(f)
    motion = SkeletonMotion.from_file(cfg["source_motion"])
    src_tpose = SkeletonState.from_dict(
        np.load(cfg["source_tpose"], allow_pickle=True).item())
    tgt_tpose = SkeletonState.from_dict(
        np.load(cfg["target_tpose"], allow_pickle=True).item())
    rot = np.asarray(cfg.get("rotation", [0.0, 0, 0, 1.0]), np.float32)
    out = motion.retarget_to_by_tpose(
        cfg["joint_mapping"], src_tpose, tgt_tpose,
        rotation_to_target_skeleton=rot,
        scale_to_target_skeleton=float(cfg.get("scale", 1.0)))
    out.to_file(cfg["target_motion_path"])
    print(f"retargeted {motion.num_frames} frames -> "
          f"{cfg['target_motion_path']}")
    return out


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m isaacgymenvs_ma_tpu_torch.poselib."
                 "retarget_motion config.json")
    main(sys.argv[1])
