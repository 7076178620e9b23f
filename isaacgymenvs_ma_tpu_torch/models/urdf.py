"""Copy of isaacgymenvs_ma_tpu/models/urdf.py for the PyTorch port (numpy only).

URDF -> :class:`SceneModel` parser.

Replaces the URDF import path of the reference's external ``gym.load_asset``
(Cartpole ``tasks/cartpole.py:87-92``, BallBalance's procedurally generated
bot ``tasks/ball_balance.py:136-225``, Anymal ``tasks/anymal.py:168-183``,
Franka, etc.).  Supports primitive geometries (box/sphere/cylinder), revolute/
continuous/prismatic/fixed/floating joints, ``<dynamics>`` damping, joint
limits, and ``collapseFixedJoints`` (fixed-joint subtrees merged into their
parent body with transformed mass properties and collisions, matching
``gymapi.AssetOptions.collapse_fixed_joints``).

PhysX derives missing inertia tensors from the collision shapes scaled to the
given mass; we reproduce that (the cartpole URDF gives masses but no inertia).
``fix_base_link`` mirrors ``gymapi.AssetOptions.fix_base_link``.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, Optional

import numpy as np

from .model import (
    FIXED, FREE, GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_SPHERE, HINGE,
    SLIDE, ModelBuilder, SceneModel, geom_mass_props, _quat_mul_np,
    _quat_to_mat_np,
)


def _floats(s):
    return np.array([float(x) for x in s.split()])


def _rpy_to_quat(rpy):
    r, p, y = rpy
    cr, sr = np.cos(r / 2), np.sin(r / 2)
    cp, sp = np.cos(p / 2), np.sin(p / 2)
    cy, sy = np.cos(y / 2), np.sin(y / 2)
    return np.array(
        [
            cy * sr * cp - sy * cr * sp,
            cy * cr * sp + sy * sr * cp,
            sy * cr * cp - cy * sr * sp,
            cy * cr * cp + sy * sr * sp,
        ]
    )


def _origin(elem) -> tuple:
    o = elem.find("origin") if elem is not None else None
    if o is None:
        return np.zeros(3), np.array([0.0, 0, 0, 1])
    xyz = _floats(o.get("xyz", "0 0 0"))
    rpy = _floats(o.get("rpy", "0 0 0"))
    return xyz, _rpy_to_quat(rpy)


def _tf(pos_a, quat_a, pos_b, quat_b):
    """Compose transforms: T_a * T_b."""
    return pos_a + _quat_to_mat_np(quat_a) @ pos_b, _quat_mul_np(quat_a, quat_b)


_JTYPES = {
    "revolute": HINGE,
    "continuous": HINGE,
    "prismatic": SLIDE,
    "fixed": FIXED,
    "floating": FREE,
}


def _parse_geometry(geom_elem, use_capsules: bool):
    for g in geom_elem:
        if g.tag == "box":
            return GEOM_BOX, _floats(g.get("size")) / 2.0
        if g.tag == "sphere":
            return GEOM_SPHERE, np.array([float(g.get("radius")), 0.0, 0.0])
        if g.tag == "cylinder":
            r = float(g.get("radius"))
            l = float(g.get("length"))
            if use_capsules:
                return GEOM_CAPSULE, np.array([r, max(l / 2.0 - r, 1e-4), 0.0])
            return GEOM_CYLINDER, np.array([r, l / 2.0, 0.0])
        if g.tag == "mesh":
            return None  # mesh collisions: approximated/skipped at this tier
    return None


def load_urdf(path_or_text: str, fix_base_link: bool = False,
              base_pos=(0, 0, 0), base_quat=(0, 0, 0, 1),
              collapse_fixed: bool = False, cylinders_as_capsules: bool = False,
              density_fallback: float = 1000.0) -> SceneModel:
    if path_or_text.lstrip().startswith("<"):
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    root = ET.fromstring(text)

    links: Dict[str, ET.Element] = {l.get("name"): l for l in root.findall("link")}
    child_of: Dict[str, list] = {}
    parent_of: Dict[str, ET.Element] = {}
    for j in root.findall("joint"):
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        child_of.setdefault(parent, []).append(j)
        parent_of[child] = j
    roots = [name for name in links if name not in parent_of]
    assert len(roots) == 1, f"URDF must have one root link, got {roots}"

    b = ModelBuilder()
    b.begin_actor()

    def attach_link(name: str, body_idx: int, off_pos, off_quat):
        """Add link `name`'s collisions + inertial into body_idx at offset."""
        elem = links[name]
        geom_descrs = []
        for c in elem.findall("collision"):
            parsed = _parse_geometry(c.find("geometry"), cylinders_as_capsules)
            if parsed is None:
                continue
            gtype, size = parsed
            pos, quat = _origin(c)
            gp, gq = _tf(off_pos, off_quat, pos, quat)
            geom_descrs.append((gtype, size, gp, gq))
            b.add_geom(body_idx, gtype, size, gp, gq, density=None)
        inertial = elem.find("inertial")
        if inertial is not None:
            mass = float(inertial.find("mass").get("value"))
            ipos, iquat = _origin(inertial)
            ipos, iquat = _tf(off_pos, off_quat, ipos, iquat)
            itag = inertial.find("inertia")
            if itag is not None:
                ixx = float(itag.get("ixx", 0)); iyy = float(itag.get("iyy", 0))
                izz = float(itag.get("izz", 0)); ixy = float(itag.get("ixy", 0))
                ixz = float(itag.get("ixz", 0)); iyz = float(itag.get("iyz", 0))
                I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
                b._accumulate_inertia(body_idx, mass, np.zeros(3), I, ipos, iquat)
            elif geom_descrs:
                # derive from collision shapes, scaled to the given mass
                m0, parts = 0.0, []
                for gtype, size, pos, quat in geom_descrs:
                    mm, cc, ii = geom_mass_props(gtype, size, 1.0)
                    R = _quat_to_mat_np(quat)
                    parts.append((mm, pos + R @ cc, R @ ii @ R.T))
                    m0 += mm
                if m0 > 0:
                    scl = mass / m0
                    for mm, cc, ii in parts:
                        b._accumulate_inertia(body_idx, mm * scl, np.zeros(3),
                                              ii * scl, cc, np.array([0.0, 0, 0, 1]))
            else:
                b._accumulate_inertia(body_idx, mass, np.zeros(3),
                                      np.eye(3) * 0.4 * mass * 1e-4, ipos, iquat)

    def recurse(name: str, body_idx: int, off_pos, off_quat):
        for j in child_of.get(name, []):
            child = j.find("child").get("link")
            jtype = _JTYPES[j.get("type")]
            o_pos, o_quat = _origin(j)
            j_pos, j_quat = _tf(off_pos, off_quat, o_pos, o_quat)
            if jtype == FIXED and collapse_fixed:
                attach_link(child, body_idx, j_pos, j_quat)
                recurse(child, body_idx, j_pos, j_quat)
                continue
            ax = j.find("axis")
            jaxis = _floats(ax.get("xyz")) if ax is not None else np.array([1.0, 0, 0])
            n = np.linalg.norm(jaxis)
            jaxis = jaxis / n if n > 0 else np.array([1.0, 0, 0])
            lim = j.find("limit")
            lo = hi = None
            effort = velocity = 1e9
            if lim is not None:
                if lim.get("lower") is not None:
                    lo = float(lim.get("lower"))
                if lim.get("upper") is not None:
                    hi = float(lim.get("upper"))
                effort = float(lim.get("effort", 1e9))
                velocity = float(lim.get("velocity", 1e9))
            if j.get("type") == "continuous":
                lo = hi = None
            dyn = j.find("dynamics")
            damping = float(dyn.get("damping", 0)) if dyn is not None else 0.0
            cidx = b.add_body(child, body_idx, jtype, jnt_axis=jaxis,
                              body_pos=j_pos, body_quat=j_quat,
                              limit_lower=lo, limit_upper=hi, damping=damping,
                              effort_limit=effort, velocity_limit=velocity)
            attach_link(child, cidx, np.zeros(3), np.array([0.0, 0, 0, 1]))
            recurse(child, cidx, np.zeros(3), np.array([0.0, 0, 0, 1]))

    root_name = roots[0]
    ridx = b.add_body(root_name, -1, FIXED if fix_base_link else FREE,
                      jnt_axis=np.array([0.0, 0, 1]),
                      body_pos=np.asarray(base_pos, np.float64),
                      body_quat=np.asarray(base_quat, np.float64))
    attach_link(root_name, ridx, np.zeros(3), np.array([0.0, 0, 0, 1]))
    recurse(root_name, ridx, np.zeros(3), np.array([0.0, 0, 0, 1]))
    return b.finalize()
