"""Copy of isaacgymenvs_ma_tpu/models/robots.py for the PyTorch port (numpy only).

Procedural robot builders.

Standalone constructions of the core locomotion assets so the framework does
not depend on external asset files; physical parameters follow the published
MuJoCo/IsaacGymEnvs models (Ant: torso sphere r=0.25, 4 legs of two capsules
r=0.08, density 5, armature 0.01, damping 0.1, gear 15 — ``nv_ant.xml``).
When an asset path is supplied in the task config, the MJCF/URDF parsers load
it instead; tests cross-check the procedural build against the parsed one.
"""
from __future__ import annotations

import numpy as np

from .model import (FREE, GEOM_CAPSULE, GEOM_SPHERE, HINGE, ModelBuilder,
                    SceneModel, quat_between_np)


def _capsule_fromto(b: ModelBuilder, body: int, a, c, r, density):
    a = np.asarray(a, np.float64)
    c = np.asarray(c, np.float64)
    mid = 0.5 * (a + c)
    seg = c - a
    ln = np.linalg.norm(seg)
    quat = quat_between_np([0.0, 0.0, 1.0], seg / ln)
    b.add_geom(body, GEOM_CAPSULE, (r, ln / 2.0, 0.0), mid, quat, density=density)


def build_ant() -> SceneModel:
    """The 8-DoF ant (9 bodies): freejoint torso + 4x(hip, ankle)."""
    density = 5.0
    damping, armature = 0.1, 0.01
    b = ModelBuilder()
    b.begin_actor()
    torso = b.add_body("torso", -1, FREE, body_pos=(0, 0, 0.75))
    b.add_geom(torso, GEOM_SPHERE, (0.25, 0, 0), density=density)
    for i, (sx, sy) in enumerate([(1, 1), (-1, 1), (-1, -1), (1, -1)], start=1):
        # aux capsule on the torso toward the hip
        _capsule_fromto(b, torso, (0, 0, 0), (0.2 * sx, 0.2 * sy, 0), 0.08, density)

    legs = []
    # (leg index, sign x, sign y, hip range deg, ankle axis, ankle range deg)
    spec = [
        ("front_left", 1, 1, (-40, 40), (-1, 1, 0), (30, 100)),
        ("front_right", -1, 1, (-40, 40), (1, 1, 0), (-100, -30)),
        ("left_back", -1, -1, (-40, 40), (-1, 1, 0), (-100, -30)),
        ("right_back", 1, -1, (-40, 40), (1, 1, 0), (30, 100)),
    ]
    for name, sx, sy, hip_rng, ankle_axis, ankle_rng in spec:
        hip = b.add_body(
            f"{name}_leg", torso, HINGE, jnt_axis=(0, 0, 1),
            body_pos=(0.2 * sx, 0.2 * sy, 0),
            limit_lower=np.deg2rad(hip_rng[0]), limit_upper=np.deg2rad(hip_rng[1]),
            damping=damping, armature=armature,
        )
        _capsule_fromto(b, hip, (0, 0, 0), (0.2 * sx, 0.2 * sy, 0), 0.08, density)
        ax = np.asarray(ankle_axis, np.float64)
        ax = ax / np.linalg.norm(ax)
        foot = b.add_body(
            f"{name}_foot", hip, HINGE, jnt_axis=ax,
            body_pos=(0.2 * sx, 0.2 * sy, 0),
            limit_lower=np.deg2rad(ankle_rng[0]), limit_upper=np.deg2rad(ankle_rng[1]),
            damping=damping, armature=armature,
        )
        _capsule_fromto(b, foot, (0, 0, 0), (0.4 * sx, 0.4 * sy, 0), 0.08, density)
        legs.append((hip, foot))

    # actuators in the MJCF's order: hip_4, ankle_4, hip_1, ankle_1, hip_2,
    # ankle_2, hip_3, ankle_3 — but Isaac Gym orders dofs by tree traversal,
    # and joint_gears are gathered per-dof (all 15), so order is uniform here.
    for hip, foot in legs:
        b.add_actuator(hip, 15.0)
        b.add_actuator(foot, 15.0)
    for _, foot in legs:
        b.add_force_sensor(foot)

    m = b.finalize()
    # init_qpos from the MJCF custom numeric (z=0.55, identity quat, legs bent)
    init_q = np.zeros(m.nq)
    init_q[2] = 0.55
    init_q[6] = 1.0
    init_q[7:] = [0.0, 1.0, 0.0, -1.0, 0.0, -1.0, 0.0, 1.0]
    m.init_qpos = init_q
    return m
