"""Ingest AMP mocap clips through the port's poselib (counterpart of
scripts/ingest_reference_motions.py)::

    python -m isaacgymenvs_ma_tpu_torch.poselib.ingest_motions --src DIR \\
        [--dst DIR]

Each ``*.npy`` SkeletonMotion clip in ``--src`` (the reference's
``assets/amp/motions`` layout) goes through the whole motion pipeline:
``SkeletonMotion.from_file``, the identity retarget through
``retarget_to_by_tpose`` (the source skeleton onto itself from its zero
pose: the code path a mocap retarget takes, so a pipeline fault shows up
as drift) and ``SkeletonMotion.to_file`` into ``--dst`` (default: the
port's ``data/motions/``).  The written clip is then verified with the
port's ``MotionLib`` on the CPU: its root, dof and key-body banks within
1e-3 of the source clip's.  Nothing here touches a GPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .skeleton import SkeletonMotion, SkeletonState

DEFAULT_DST = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "motions")


def ingest(src_path: str, dst_path: str) -> float:
    """Retarget ``src_path`` onto its own skeleton, write it to
    ``dst_path`` and verify it through ``MotionLib``; returns the
    retarget's drift (max global translation change)."""
    motion = SkeletonMotion.from_file(src_path)
    tree = motion.skeleton_tree
    tpose = SkeletonState.zero_pose(tree)
    mapping = {n: n for n in tree.node_names}
    out = motion.retarget_to_by_tpose(
        mapping, source_tpose=tpose, target_tpose=tpose,
        scale_to_target_skeleton=1.0)
    drift = float(np.abs(out.global_translation
                         - motion.global_translation).max())
    if drift >= 1e-4:
        raise RuntimeError(f"{src_path}: identity retarget drifted {drift}")
    out.to_file(dst_path)

    # training-side verification: MotionLib builds the same banks
    from ..learning.motion_lib import MotionLib
    a = MotionLib(src_path, dt=1.0 / 30.0, device="cpu")
    b = MotionLib(dst_path, dt=1.0 / 30.0, device="cpu")
    for field in ("root_pos", "dof_pos", "key_pos"):
        err = float((getattr(a.data, field)
                     - getattr(b.data, field)).abs().max())
        if err >= 1e-3:
            raise RuntimeError(f"{dst_path}: MotionLib {field} differs by "
                               f"{err}")
    print(f"  {os.path.basename(src_path)} -> {dst_path} "
          f"({out.num_frames} frames @ {out.fps} fps, retarget drift "
          f"{drift:.2e})")
    return drift


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="directory of SkeletonMotion .npy clips")
    ap.add_argument("--dst", default=DEFAULT_DST,
                    help="output directory (default: the port's "
                         "data/motions)")
    args = ap.parse_args(argv)
    clips = sorted(f for f in os.listdir(args.src) if f.endswith(".npy"))
    if not clips:
        sys.exit(f"no .npy clips in {args.src}")
    os.makedirs(args.dst, exist_ok=True)
    for f in clips:
        ingest(os.path.join(args.src, f), os.path.join(args.dst, f))
    print(f"ingested {len(clips)} clips into {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
