"""Copy of isaacgymenvs_ma_tpu/models/mjcf.py for the PyTorch port (numpy only).

MJCF (MuJoCo XML) -> :class:`SceneModel` parser.

Replaces the MJCF import path of the reference's external ``gym.load_asset``
(used by Ant/Humanoid/AMP, ``tasks/ant.py:154``).  Covers the subset of MJCF
the reference assets use: nested ``<default>`` classes with ``childclass``,
``<body>``/``<joint>``/``<freejoint>``/``<geom>`` trees, ``fromto`` capsules,
``<motor>`` actuators with gear, and the ``init_qpos`` custom numeric
(``nv_ant.xml``).  MuJoCo quats are **wxyz** and angles may be degrees
(``compiler angle="degree"``); we convert to xyzw / radians here.

MuJoCo allows several joints per body; our core has one joint per body, so
extra joints introduce massless intermediate bodies (standard tree expansion).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, Optional

import numpy as np

from .model import (
    FIXED, FREE, GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_SPHERE, HINGE,
    SLIDE, ModelBuilder, SceneModel, quat_between_np,
)

_GEOM_TYPES = {"sphere": GEOM_SPHERE, "capsule": GEOM_CAPSULE, "box": GEOM_BOX,
               "cylinder": GEOM_CYLINDER}
_JOINT_TYPES = {"hinge": HINGE, "slide": SLIDE, "free": FREE}


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split()])


def _wxyz_to_xyzw(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([x, y, z, w])


class _Defaults:
    """Resolved attribute defaults for one class, per element tag."""

    def __init__(self, parent: Optional["_Defaults"] = None):
        self.attrs: Dict[str, Dict[str, str]] = {}
        if parent is not None:
            for tag, d in parent.attrs.items():
                self.attrs[tag] = dict(d)

    def update_from(self, elem: ET.Element):
        for child in elem:
            if child.tag == "default":
                continue
            self.attrs.setdefault(child.tag, {}).update(child.attrib)

    def get(self, elem: ET.Element, attr: str, fallback: Optional[str] = None) -> Optional[str]:
        if attr in elem.attrib:
            return elem.attrib[attr]
        return self.attrs.get(elem.tag, {}).get(attr, fallback)


def _collect_defaults(elem: ET.Element, parent: _Defaults, out: Dict[str, _Defaults]):
    d = _Defaults(parent)
    d.update_from(elem)
    name = elem.get("class", "__root__")
    out[name] = d
    for child in elem.findall("default"):
        _collect_defaults(child, d, out)


def _resolve_includes(elem: ET.Element, base_dir: str):
    """Inline <include file="..."/> elements (OpenAI hand assets use them)."""
    i = 0
    children = list(elem)
    for child in children:
        _resolve_includes(child, base_dir)
    while True:
        incs = [(i, c) for i, c in enumerate(list(elem)) if c.tag == "include"]
        if not incs:
            break
        idx, inc = incs[0]
        path = os.path.join(base_dir, inc.get("file"))
        sub = ET.parse(path).getroot()
        _resolve_includes(sub, os.path.dirname(path))
        elem.remove(inc)
        # mujoco <include> splices the included file's children in place
        for j, c in enumerate(list(sub)):
            elem.insert(idx + j, c)
    return elem


class MJCFParser:
    def __init__(self, xml_text: str, base_dir: str = "."):
        self.root = ET.fromstring(xml_text)
        _resolve_includes(self.root, base_dir)
        # merge worldbody/default/actuator sections that includes may add
        # (mujoco merges same-tag top-level sections)
        for tag in ("worldbody", "default", "actuator", "asset"):
            sections = self.root.findall(tag)
            if len(sections) > 1:
                first = sections[0]
                for extra in sections[1:]:
                    for c in list(extra):
                        first.append(c)
                    self.root.remove(extra)
        compiler = self.root.find("compiler")
        self.degrees = (compiler is None) or (compiler.get("angle", "degree") == "degree")
        self.classes: Dict[str, _Defaults] = {"__root__": _Defaults()}
        for d in self.root.findall("default"):
            _collect_defaults(d, self.classes["__root__"], self.classes)
        self.builder = ModelBuilder()
        self.joint_names: list = []          # (name, dof index) in order
        self.actuator_joint_names: list = []

    # -- attribute resolution -------------------------------------------
    def _resolve(self, elem: ET.Element, attr: str, cls: str, fallback=None):
        if attr in elem.attrib:
            return elem.attrib[attr]
        cd = self.classes.get(elem.get("class", cls)) or self.classes["__root__"]
        return cd.get(elem, attr, fallback)

    def _angle(self, x: float) -> float:
        return np.deg2rad(x) if self.degrees else x

    # -- geoms -----------------------------------------------------------
    def _parse_geom(self, g: ET.Element, body_idx: int, cls: str):
        gtype = self._resolve(g, "type", cls, "sphere")
        if gtype == "plane":
            return  # world ground plane is handled by the engine itself
        if gtype not in _GEOM_TYPES:
            return
        size = _floats(self._resolve(g, "size", cls, "0.05"))
        density = float(self._resolve(g, "density", cls, "1000"))
        friction_s = self._resolve(g, "friction", cls, "1 0.005 0.0001")
        friction = float(_floats(friction_s)[0])
        contype = self._resolve(g, "contype", cls, "1")
        contact = contype != "0"
        pos = np.zeros(3)
        quat = np.array([0.0, 0, 0, 1])
        fromto = g.get("fromto")
        if fromto is not None:
            ft = _floats(fromto)
            a, b = ft[:3], ft[3:]
            pos = 0.5 * (a + b)
            seg = b - a
            ln = np.linalg.norm(seg)
            if ln > 1e-9:
                quat = quat_between_np([0.0, 0, 1], seg / ln)
            hl = ln / 2.0
            size = np.array([size[0], hl, 0.0])
        else:
            if g.get("pos") is not None:
                pos = _floats(g.get("pos"))
            if g.get("quat") is not None:
                quat = _wxyz_to_xyzw(_floats(g.get("quat")))
            if gtype in ("capsule", "cylinder") and size.shape[0] >= 2:
                size = np.array([size[0], size[1], 0.0])
        if gtype == "sphere":
            size = np.array([size[0], 0.0, 0.0])
        self.builder.add_geom(
            body_idx, _GEOM_TYPES[gtype], size, pos, quat,
            density=density, friction=friction, contact=contact, name=g.get("name", ""),
        )

    # -- bodies ----------------------------------------------------------
    def _parse_body(self, elem: ET.Element, parent_idx: int, cls: str):
        name = elem.get("name", f"body{len(self.builder.bodies)}")
        cls = elem.get("childclass", cls)
        body_pos = _floats(elem.get("pos", "0 0 0"))
        if elem.get("quat") is not None:
            body_quat = _wxyz_to_xyzw(_floats(elem.get("quat")))
            body_quat = body_quat / np.linalg.norm(body_quat)
        else:
            body_quat = np.array([0.0, 0, 0, 1])

        joints = list(elem.findall("joint")) + list(elem.findall("freejoint"))
        if not joints:
            idx = self.builder.add_body(name, parent_idx, FIXED,
                                        body_pos=body_pos, body_quat=body_quat)
        else:
            # chain of joints: intermediate massless bodies carry all but the
            # last joint; frame offsets apply to the first link of the chain.
            idx = parent_idx
            for k, j in enumerate(joints):
                jtype = FREE if j.tag == "freejoin" or j.tag == "freejoint" else \
                    _JOINT_TYPES[self._resolve(j, "type", cls, "hinge")]
                axis = _floats(self._resolve(j, "axis", cls, "0 0 1") or "0 0 1")
                n = np.linalg.norm(axis)
                axis = axis / n if n > 0 else np.array([0.0, 0, 1])
                jpos = _floats(self._resolve(j, "pos", cls, "0 0 0") or "0 0 0")
                rng = self._resolve(j, "range", cls)
                limited = self._resolve(j, "limited", cls, "false") in ("true", "1")
                lo = hi = None
                if rng is not None and (limited or jtype == HINGE or jtype == SLIDE):
                    r = _floats(rng)
                    if jtype == HINGE:
                        r = np.array([self._angle(r[0]), self._angle(r[1])])
                    if limited or rng is not None:
                        lo, hi = r[0], r[1]
                if not limited and rng is None:
                    lo = hi = None
                damping = float(self._resolve(j, "damping", cls, "0") or 0)
                spring = float(self._resolve(j, "stiffness", cls, "0") or 0)
                armature = float(self._resolve(j, "armature", cls, "0") or 0)
                first = k == 0
                idx = self.builder.add_body(
                    name if k == len(joints) - 1 else f"{name}__j{k}",
                    idx,
                    jtype,
                    jnt_axis=axis,
                    jnt_pos=jpos,
                    body_pos=body_pos if first else np.zeros(3),
                    body_quat=body_quat if first else np.array([0.0, 0, 0, 1]),
                    limit_lower=lo,
                    limit_upper=hi,
                    damping=damping,
                    spring=spring,
                    armature=armature,
                )
                jname = j.get("name", f"{name}_j{k}")
                if jtype != FREE:
                    self.joint_names.append((jname, idx))

        for g in elem.findall("geom"):
            self._parse_geom(g, idx, cls)
        for child in elem.findall("body"):
            self._parse_body(child, idx, cls)

    def parse(self) -> SceneModel:
        world = self.root.find("worldbody")
        self.builder.begin_actor()
        for body in world.findall("body"):
            self._parse_body(body, -1, "__root__")
        # static world geoms (other than the plane)
        # actuators
        act = self.root.find("actuator")
        model_joint_dof = {}
        for jname, bidx in self.joint_names:
            model_joint_dof[jname] = bidx
        gears = []
        if act is not None:
            for motor in act.findall("motor"):
                jname = motor.get("joint")
                gear = float(self._resolve(motor, "gear", "__root__", "1") or 1)
                bidx = model_joint_dof[jname]
                self.builder.add_actuator(bidx, gear)
                gears.append(gear)
        model = self.builder.finalize()
        # init_qpos custom numeric (nv_ant.xml <custom><numeric name="init_qpos">)
        custom = self.root.find("custom")
        if custom is not None:
            for num in custom.findall("numeric"):
                if num.get("name") == "init_qpos":
                    q0 = _floats(num.get("data"))
                    # MuJoCo free-joint quats are wxyz; convert to xyzw
                    for b in range(model.nb):
                        if model.jnt_type[b] == FREE:
                            qa = int(model.q_adr[b])
                            q0[qa + 3: qa + 7] = _wxyz_to_xyzw(q0[qa + 3: qa + 7])
                    model.init_qpos = q0
        return model


def load_mjcf(path_or_text: str) -> SceneModel:
    if path_or_text.lstrip().startswith("<"):
        text = path_or_text
        base_dir = "."
    else:
        with open(path_or_text) as f:
            text = f.read()
        base_dir = os.path.dirname(os.path.abspath(path_or_text))
    return MJCFParser(text, base_dir).parse()
