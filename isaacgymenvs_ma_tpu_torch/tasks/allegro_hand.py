"""AllegroHand in-hand cube reorientation (port of
isaacgymenvs_ma_tpu/tasks/allegro_hand.py): act 16, obs per type
(``openai`` 42, ``full_no_vel`` 50, ``full`` 72, ``full_state`` 88),
8192 envs, two control steps of physics per policy step.

The 16-dof Allegro hand counterpart of :class:`.shadow_hand.ShadowHand`
(the same reward, goal and force machinery).  The reference's dof
overrides: kp 3, kd 0.1, a 0.5 N m drive force limit, joint friction 0.01
(the engine's dof dry friction) and armature 0.001.  Contacts: a thin palm
slab and a thick fill box below it, fingertip and phalanx spheres, all
against the cube's SDF, and the cube's corners against both palm boxes.
The obs layouts carry no fingertip states.
"""
from __future__ import annotations

import copy

import numpy as np

from ..models.model import (DRIVE_POS, FREE, GEOM_BOX, GEOM_SPHERE, Geom,
                            ModelBuilder, _quat_to_mat_np, compose_scene,
                            model_from_spec)
from ..utils.config import deep_merge
from .shadow_hand import (PALM_TARGET, ShadowHand, TASK_CFG as SH_CFG,
                          _palm_up_placement)

TASK_CFG = deep_merge(SH_CFG, {
    "name": "AllegroHand",
    # a 30 Hz policy over the 60 Hz sim
    "env": {"numEnvs": 8192, "observationType": "full_state",
            "controlFrequencyInv": 2},
})

FINGERTIPS = ["index_biotac_tip", "middle_biotac_tip", "ring_biotac_tip",
              "thumb_biotac_tip"]
OBS_DIMS = {"openai": 42, "full_no_vel": 50, "full": 72, "full_state": 88}
# one mid-link sphere per proximal and medial segment: (body, offset, r)
PHALANX_SPHERES = [
    ("index_link_1", (0.027, 0, 0), 0.0134),
    ("index_link_2", (0.019, 0, 0), 0.0134),
    ("middle_link_1", (0.027, 0, 0), 0.0134),
    ("middle_link_2", (0.019, 0, 0), 0.0134),
    ("ring_link_1", (0.027, 0, 0), 0.0134),
    ("ring_link_2", (0.019, 0, 0), 0.0134),
    ("thumb_link_1", (0.0, 0, 0.0275), 0.0134),
    ("thumb_link_2", (0.0255, 0, 0), 0.0134),
]


class AllegroHand(ShadowHand):
    num_hand_dofs = 16
    num_hand_actuated = 16
    fingertip_names = FINGERTIPS
    obs_dims = OBS_DIMS
    obs_include_fingertips = False

    def create_model(self):
        from ..models.specs.allegro_hand import SPEC
        hand = model_from_spec(copy.deepcopy(SPEC))
        # the reference's dof-property override: kp 3, kd 0.1, drive force
        # limit 0.5 N m, joint friction 0.01, armature 0.001
        hand.dof_friction = np.full(hand.nv, 0.01)
        for d in range(hand.nv):
            hand.dof_drive_mode[d] = DRIVE_POS
            hand.dof_stiffness[d] = 3.0
            hand.dof_drive_damping[d] = 0.1
            hand.dof_effort_limit[d] = 0.5
            hand.dof_armature[d] = 0.001
        # the palm: a thin slab on the palmar face (the placement's anchor)
        # and a thick fill box below it, so a falling cube cannot wedge
        # under the slab
        palm = hand.body_names.index("palm_link")
        hand.geoms.append(Geom(body=palm, gtype=GEOM_BOX,
                               size=np.array([0.05, 0.058, 0.0075]),
                               pos=np.array([-0.008, 0.009, -0.0075]),
                               quat=np.array([0.0, 0, 0, 1]), friction=1.0,
                               contact=True, name="palm_box"))
        hand.geoms.append(Geom(body=palm, gtype=GEOM_BOX,
                               size=np.array([0.05, 0.058, 0.035]),
                               pos=np.array([-0.008, 0.009, -0.05]),
                               quat=np.array([0.0, 0, 0, 1]), friction=1.0,
                               contact=True, name="palm_fill"))
        for n in FINGERTIPS:
            b = hand.body_names.index(n)
            hand.geoms.append(Geom(body=b, gtype=GEOM_SPHERE,
                                   size=np.array([0.012, 0, 0]),
                                   pos=np.zeros(3),
                                   quat=np.array([0.0, 0, 0, 1]), friction=1.0,
                                   contact=True, name=f"tip_{n}"))
        for body, off, r in PHALANX_SPHERES:
            bidx = hand.body_names.index(body)
            hand.geoms.append(Geom(body=bidx, gtype=GEOM_SPHERE,
                                   size=np.array([r, 0, 0]),
                                   pos=np.asarray(off, float),
                                   quat=np.array([0.0, 0, 0, 1]), friction=1.0,
                                   contact=True, name=f"pad_{body}"))
        # the palmar normal (palm-frame +z) up, the fingers (+x) tipped
        # down by the tilt; the cube over the palm / proximal-link
        # junction, clear of the knuckle spheres
        base, quat = _palm_up_placement(hand, "palm_box",
                                        np.array([0.0, 0, 1.0]),
                                        distal_axis=np.array([1.0, 0, 0]),
                                        tilt=0.095)
        Rq = _quat_to_mat_np(np.asarray(quat, float))
        self.obj_start = (PALM_TARGET + Rq @ np.array([0.05, 0.009, 0.0])
                          + np.array([0.0, 0.0, 0.068]))
        self.goal_pos = self.obj_start + np.array([0.0, 0.0, -0.04])
        ob = ModelBuilder()
        ob.begin_actor()
        obj = ob.add_body("object", -1, FREE, body_pos=self.obj_start)
        ob.add_geom(obj, GEOM_BOX, np.full(3, 0.065 / 2), density=400.0,
                    name="object_geom")
        model = compose_scene([
            (hand, base, tuple(quat)),
            (ob.finalize(), (0, 0, 0), (0, 0, 0, 1))])
        ft = [model.body_names.index(n) for n in FINGERTIPS]
        model.sensor_body = np.asarray(ft, np.int32)
        model.sensor_pos = np.zeros((len(ft), 3))
        return model, True

    def contact_pairs(self, model):
        """The palm slab, fingertip and phalanx spheres against the cube,
        then the cube's corners against both palm boxes."""
        names = [g.name for g in model.geoms]
        obj_geom = names.index("object_geom")
        pairs = [(names.index(n), obj_geom) for n in names
                 if n.startswith(("tip_", "pad_")) or n == "palm_box"]
        return pairs + [(obj_geom, names.index("palm_box")),
                        (obj_geom, names.index("palm_fill"))]
