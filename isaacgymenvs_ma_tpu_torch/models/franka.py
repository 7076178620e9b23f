"""Franka Panda arm model (numpy-only copy of
isaacgymenvs_ma_tpu/models/franka.py; a test holds it to the original).

Kinematics (joint origins/axes/limits/damping, 7R + 2P gripper + grip-site
frame) come from the generated ``specs/franka_panda`` spec; the source URDF
carries no inertials (Isaac derives them from collision meshes at import), so
we attach the published Franka Emika Panda mass properties here (the
identified dynamic parameters distributed with franka_ros — public data) and
capsule/sphere contact approximations for the hand/fingers (mesh collisions
are out of scope for this contact tier; the reach task disables arm-cube
collisions anyway via filters — franka_reach_MA.py:363-422).
"""
from __future__ import annotations

import copy

import numpy as np

from .model import GEOM_SPHERE, SceneModel, model_from_spec

# name -> (mass, com(3), inertia diagonal(3)); franka_ros identified values
_MASS_PROPS = {
    "panda_link0": (2.92, (-0.025566, -2.88e-5, 0.057332), (0.00782, 0.01088, 0.01069)),
    "panda_link1": (4.970684, (0.003875, 0.002081, -0.04762), (0.70337, 0.70661, 0.009117)),
    "panda_link2": (0.646926, (-0.003141, -0.02872, 0.003495), (0.007962, 0.02811, 0.025995)),
    "panda_link3": (3.228604, (0.027518, 0.039252, -0.066502), (0.037242, 0.036155, 0.01083)),
    "panda_link4": (3.587895, (-0.05317, 0.104419, 0.027454), (0.025853, 0.019552, 0.028323)),
    "panda_link5": (1.225946, (-0.011953, 0.041065, -0.038437), (0.035549, 0.029474, 0.008627)),
    "panda_link6": (1.666555, (0.060149, -0.014117, -0.010517), (0.001964, 0.004354, 0.005433)),
    "panda_link7": (0.735522, (0.010517, -0.004252, 0.061597), (0.012516, 0.010027, 0.004815)),
    "panda_hand": (0.73, (-0.01, 0.0, 0.03), (0.001, 0.0025, 0.0017)),
    "panda_leftfinger": (0.015, (0.0, 0.0, 0.02), (2.4e-6, 2.4e-6, 7.7e-7)),
    "panda_rightfinger": (0.015, (0.0, 0.0, 0.02), (2.4e-6, 2.4e-6, 7.7e-7)),
}

FRANKA_DEFAULT_DOF_POS = np.array(
    [0.0, 0.1963, 0.0, -2.6180, 0.0, 2.9416, 0.7854, 0.035, 0.035])


def build_franka(hand_contact_sphere: float = 0.07) -> SceneModel:
    """One fixed-base Franka with the published mass properties attached.

    ``hand_contact_sphere``: radius of the contact sphere on ``panda_hand``
    used for hand<->hand collision punishment in the MA tasks
    (franka_reach_MA.py:928-960 checks hand net contact forces).
    """
    from .specs.franka_panda import SPEC
    m = model_from_spec(copy.deepcopy(SPEC))
    for i, name in enumerate(m.body_names):
        if name in _MASS_PROPS:
            mass, com, idiag = _MASS_PROPS[name]
            m.mass[i] = mass
            m.com[i] = np.asarray(com)
            m.inertia[i] = np.diag(idiag)
    # drop any parsed collision geoms; attach a hand contact sphere
    m.geoms = []
    if hand_contact_sphere > 0:
        hand = m.body_names.index("panda_hand")
        from .model import Geom
        m.geoms.append(Geom(
            body=hand, gtype=GEOM_SPHERE,
            size=np.array([hand_contact_sphere, 0.0, 0.0]),
            pos=np.array([0.0, 0.0, 0.04]), quat=np.array([0.0, 0, 0, 1]),
            friction=1.0, contact=True, name="hand_sphere"))
    return m
