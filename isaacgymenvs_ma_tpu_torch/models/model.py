"""Static articulation/scene description (copy of
isaacgymenvs_ma_tpu/models/model.py for the PyTorch port, which imports
nothing of the JAX package).  Numpy only.  The mesh voxelizer entry point
``ModelBuilder.add_sdf_geom`` is left out: the port has no SDF-grid
collision targets yet.

Original description:

Static articulation/scene description for the TPU physics core.

This is the replacement for the reference's asset pipeline
(``gym.load_asset`` + ``create_actor`` loops, e.g. ``tasks/ant.py:140-197``):
instead of building N copies of a scene through O(num_envs) host calls, we
build ONE static :class:`SceneModel` at trace time (pure numpy) and batch all
dynamic state over the env axis on device.  Every shape here is static, so the
whole simulation compiles to a single XLA program.

Conventions
-----------
* quaternions xyzw (Isaac Gym order), frames right-handed, Z-up.
* one joint per body connecting it to its parent (``parent[b] == -1`` means
  the world); multiple actors per env form a forest under the world root.
* q layout: FREE -> 7 (pos xyz + quat xyzw), HINGE/SLIDE -> 1, FIXED -> 0.
* v layout: FREE -> 6 (linear world vel of body origin + angular world vel,
  matching the root-state tensor layout ``[pos quat linvel angvel]`` of
  ``gym.acquire_actor_root_state_tensor``), HINGE/SLIDE -> 1.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# joint types
FREE, HINGE, SLIDE, FIXED, SCREW = 0, 1, 2, 3, 4
# geom types
GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX, GEOM_PLANE, GEOM_CYLINDER = 0, 1, 2, 3, 4
# mesh shape represented by a baked signed-distance voxel grid (the
# TPU-native analog of PhysX SDF collisions, docs/factory.md §Collisions;
# grids are baked by native/sdf_voxelize.cpp at build time)
GEOM_SDF = 5
# dof drive modes (mirror gymapi.DOF_MODE_*, set via dof props as in
# tasks/cartpole.py:115-119)
DRIVE_NONE, DRIVE_POS, DRIVE_VEL, DRIVE_EFFORT = 0, 1, 2, 3

# SCREW: 1-dof helical joint (rotation about the axis + coupled translation
# axis * pitch/(2*pi) per radian) — the TPU-native stand-in for the Factory
# nut-on-bolt thread constraint (docs/factory.md SDF thread collisions)
_NQ = {FREE: 7, HINGE: 1, SLIDE: 1, FIXED: 0, SCREW: 1}
_NV = {FREE: 6, HINGE: 1, SLIDE: 1, FIXED: 0, SCREW: 1}


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64)


def _quat_to_mat_np(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def _quat_mul_np(a, b):
    x1, y1, z1, w1 = a
    x2, y2, z2, w2 = b
    return np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )


def quat_between_np(a, b):
    """Quaternion rotating unit vector a onto unit vector b."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = np.cross(a, b)
    d = float(np.dot(a, b))
    if d < -1.0 + 1e-9:
        # 180 degrees: pick any orthogonal axis
        axis = np.cross(a, [1.0, 0, 0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0, 1.0, 0])
        axis /= np.linalg.norm(axis)
        return np.array([axis[0], axis[1], axis[2], 0.0])
    q = np.array([c[0], c[1], c[2], 1.0 + d])
    return q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# geom mass properties


def geom_mass_props(gtype: int, size: np.ndarray, density: float):
    """(mass, com-offset(3), inertia 3x3 about com) in the geom frame.

    Capsule axis is the geom-frame Z axis, ``size = (radius, half_length, 0)``.
    Box ``size`` = half-extents.  Mirrors what PhysX derives with
    ``inertiafromgeom`` (the Ant MJCF sets density=5, nv_ant.xml defaults).
    """
    if gtype == GEOM_SPHERE:
        r = size[0]
        m = density * 4.0 / 3.0 * np.pi * r**3
        i = 0.4 * m * r * r
        return m, np.zeros(3), np.diag([i, i, i])
    if gtype == GEOM_CAPSULE:
        r, hl = size[0], size[1]
        L = 2 * hl
        m_cyl = density * np.pi * r * r * L
        m_sph = density * 4.0 / 3.0 * np.pi * r**3
        m = m_cyl + m_sph
        # cylinder about its com (axis z)
        iz = 0.5 * m_cyl * r * r
        ix = m_cyl * (L * L / 12.0 + r * r / 4.0)
        # two hemispheres (= one sphere split at the cylinder ends)
        i_s = 0.4 * m_sph * r * r
        # parallel-axis: hemisphere com at +-(hl + 3r/8)
        d = hl + 3.0 * r / 8.0
        # hemisphere inertia about its own com (transverse) = 83/320 m r^2
        i_hs_t = (83.0 / 320.0) * m_sph * r * r  # both hemispheres combined mass
        ix += i_hs_t + m_sph * d * d
        iz += i_s
        return m, np.zeros(3), np.diag([ix, ix, iz])
    if gtype == GEOM_BOX:
        hx, hy, hz = size
        m = density * 8.0 * hx * hy * hz
        c = m / 3.0
        return m, np.zeros(3), np.diag(
            [c * (hy * hy + hz * hz), c * (hx * hx + hz * hz), c * (hx * hx + hy * hy)]
        )
    if gtype == GEOM_CYLINDER:
        r, hh = size[0], size[1]  # radius, half-height (axis z)
        m = density * np.pi * r * r * 2.0 * hh
        iz = 0.5 * m * r * r
        ix = m * ((2 * hh) ** 2 / 12.0 + r * r / 4.0)
        return m, np.zeros(3), np.diag([ix, ix, iz])
    raise ValueError(f"no mass props for geom type {gtype}")


@dataclasses.dataclass
class Body:
    name: str
    parent: int
    jnt_type: int
    jnt_axis: np.ndarray          # in child body frame
    jnt_pos: np.ndarray           # joint anchor in child body frame
    body_pos: np.ndarray          # joint/body frame origin in parent frame
    body_quat: np.ndarray         # frame rotation in parent frame (xyzw)
    mass: float = 0.0
    com: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((3, 3)))
    # dof properties (len == nv of this joint)
    limit_lower: Optional[np.ndarray] = None
    limit_upper: Optional[np.ndarray] = None
    damping: Optional[np.ndarray] = None      # passive joint damping
    spring: Optional[np.ndarray] = None       # passive joint spring stiffness
    armature: Optional[np.ndarray] = None
    effort_limit: Optional[np.ndarray] = None
    velocity_limit: Optional[np.ndarray] = None
    friction: Optional[np.ndarray] = None     # joint dry friction (unused yet)
    jnt_pitch: float = 0.0                    # SCREW: translation per 2*pi rad
    actor: int = 0


@dataclasses.dataclass
class Geom:
    body: int
    gtype: int
    size: np.ndarray              # sphere (r,-,-), capsule (r, hl, -), box half-extents
    pos: np.ndarray
    quat: np.ndarray
    friction: float = 1.0
    contact: bool = True          # participates in collision
    name: str = ""
    # GEOM_SDF payload: baked signed-distance voxel grid in the geom frame
    sdf_values: Optional[np.ndarray] = None    # (dx, dy, dz) f32
    sdf_origin: Optional[np.ndarray] = None    # (3,)
    sdf_spacing: Optional[np.ndarray] = None   # (3,)
    # optional explicit contact-candidate cloud (local frame) — used for
    # mesh-shaped bodies whose corners/crests should collide with targets
    contact_points: Optional[np.ndarray] = None  # (P, 3)


@dataclasses.dataclass
class SceneModel:
    """Finalized, immutable scene description (all numpy; static shapes)."""

    nb: int
    nq: int
    nv: int
    body_names: List[str]
    parent: np.ndarray            # (nb,) int, -1 = world
    jnt_type: np.ndarray          # (nb,)
    jnt_axis: np.ndarray          # (nb, 3)
    jnt_pos: np.ndarray           # (nb, 3) joint anchor in child frame
    body_pos: np.ndarray          # (nb, 3)
    body_quat: np.ndarray         # (nb, 4)
    q_adr: np.ndarray             # (nb,) start of this body's q block
    v_adr: np.ndarray             # (nb,)
    mass: np.ndarray              # (nb,)
    com: np.ndarray               # (nb, 3) in body frame
    inertia: np.ndarray           # (nb, 3, 3) about com, body frame
    # per-dof (nv,)
    dof_body: np.ndarray
    dof_lower: np.ndarray
    dof_upper: np.ndarray
    dof_has_limit: np.ndarray     # bool
    dof_damping: np.ndarray
    dof_spring: np.ndarray        # passive spring to q=0 (MJCF joint stiffness)
    dof_armature: np.ndarray
    dof_effort_limit: np.ndarray
    dof_velocity_limit: np.ndarray
    dof_drive_mode: np.ndarray    # DRIVE_* per dof
    dof_stiffness: np.ndarray     # PD drive kp (drive mode POS)
    dof_drive_damping: np.ndarray  # PD drive kd (modes POS/VEL)
    # structure masks
    body_ancestor: np.ndarray     # (nb, nb) bool: [i, j] = i is ancestor-or-self of j
    dof_ancestor: np.ndarray      # (nv, nv) bool: [i, j] = dof i on ancestor-or-self body of body(dof j)
    dof_body_mask: np.ndarray     # (nv, nb) bool: dof i on ancestor-or-self body of body b
    # SCREW joints: translation per 2*pi radians, 0 for other joint types
    jnt_pitch: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    # per-body gravity switch (asset_options.disable_gravity — the Factory
    # franka is simulated gravity-free, factory_base.py:132)
    body_gravity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    # per-body rigid damping (asset_options.linear/angular_damping — the
    # Factory franka sets 1.0/5.0 when sim.add_damping, factory_base.py:
    # 122-125); empty = zeros
    body_lin_damping: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    body_ang_damping: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    # per-dof Coulomb (dry) friction torque bound, N*m (PhysX
    # dof_properties['friction'] — e.g. allegro_hand.py:266 sets 0.01);
    # empty = zeros
    dof_friction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    # geoms
    geoms: List[Geom] = dataclasses.field(default_factory=list)
    # actors: index ranges over bodies; root body per actor
    actor_root_body: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    num_actors: int = 1
    # force sensors: body indices + local poses (tasks/ant.py:174-178,
    # ball_balance.py:265-271 places them at offsets on the tray)
    sensor_body: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    sensor_pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 3)))
    # actuated dofs (MJCF <actuator> or URDF effort joints): dof index + gear
    actuator_dof: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    actuator_gear: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    init_qpos: Optional[np.ndarray] = None

    @property
    def dof_names(self):
        out = []
        for b in range(self.nb):
            n = _NV[int(self.jnt_type[b])]
            for k in range(n):
                out.append(f"{self.body_names[b]}:{k}")
        return out


class ModelBuilder:
    """Incrementally build a :class:`SceneModel` (one env's worth of actors)."""

    def __init__(self):
        self.bodies: List[Body] = []
        self.geoms: List[Geom] = []
        self.sensors: List[int] = []
        self.actuator_dof: List[int] = []
        self.actuator_gear: List[float] = []
        self.actor_root_body: List[int] = []
        self._cur_actor = -1
        self.init_qpos: List[np.ndarray] = []

    # -- construction -----------------------------------------------------
    def begin_actor(self) -> int:
        self._cur_actor += 1
        return self._cur_actor

    def add_body(
        self,
        name: str,
        parent: int,
        jnt_type: int,
        jnt_axis=(0.0, 0.0, 1.0),
        jnt_pos=(0.0, 0.0, 0.0),
        body_pos=(0.0, 0.0, 0.0),
        body_quat=(0.0, 0.0, 0.0, 1.0),
        mass: float = 0.0,
        com=(0.0, 0.0, 0.0),
        inertia=None,
        limit_lower=None,
        limit_upper=None,
        damping=0.0,
        spring=0.0,
        armature=0.0,
        effort_limit=1e9,
        velocity_limit=1e9,
        jnt_pitch: float = 0.0,
    ) -> int:
        if self._cur_actor < 0:
            self.begin_actor()
        nvj = _NV[jnt_type]
        b = Body(
            name=name,
            parent=parent,
            jnt_type=jnt_type,
            jnt_axis=np.asarray(jnt_axis, np.float64),
            jnt_pos=np.asarray(jnt_pos, np.float64),
            body_pos=np.asarray(body_pos, np.float64),
            body_quat=np.asarray(body_quat, np.float64),
            mass=mass,
            com=np.asarray(com, np.float64),
            inertia=np.zeros((3, 3)) if inertia is None else np.asarray(inertia, np.float64),
            limit_lower=np.full(nvj, -1e9) if limit_lower is None else np.atleast_1d(np.asarray(limit_lower, np.float64)),
            limit_upper=np.full(nvj, 1e9) if limit_upper is None else np.atleast_1d(np.asarray(limit_upper, np.float64)),
            damping=np.full(nvj, damping, np.float64),
            spring=np.full(nvj, spring, np.float64),
            armature=np.full(nvj, armature, np.float64),
            effort_limit=np.full(nvj, effort_limit, np.float64),
            velocity_limit=np.full(nvj, velocity_limit, np.float64),
            friction=np.zeros(nvj),
            jnt_pitch=float(jnt_pitch),
            actor=self._cur_actor,
        )
        idx = len(self.bodies)
        self.bodies.append(b)
        if parent == -1:
            self.actor_root_body.append(idx)
        return idx

    def add_geom(self, body: int, gtype: int, size, pos=(0, 0, 0), quat=(0, 0, 0, 1),
                 density: Optional[float] = None, friction: float = 1.0, contact: bool = True,
                 name: str = ""):
        g = Geom(
            body=body,
            gtype=gtype,
            size=np.asarray(size, np.float64),
            pos=np.asarray(pos, np.float64),
            quat=np.asarray(quat, np.float64),
            friction=friction,
            contact=contact,
            name=name,
        )
        self.geoms.append(g)
        if density is not None:
            m, c, i = geom_mass_props(gtype, g.size, density)
            self._accumulate_inertia(body, m, c, i, g.pos, g.quat)
        return len(self.geoms) - 1

    def add_contact_points(self, body: int, pts, radius: float = 0.0,
                           friction: float = 1.0, name: str = ""):
        """Attach an explicit contact-candidate point cloud to a body (one
        zero-size sphere geom carrying the cloud) — e.g. crest points of a
        threaded rod colliding with a nut's SDF grid."""
        g = Geom(body=body, gtype=GEOM_SPHERE,
                 size=np.array([radius, 0.0, 0.0]),
                 pos=np.zeros(3), quat=np.array([0.0, 0, 0, 1]),
                 friction=friction, contact=True, name=name,
                 contact_points=np.asarray(pts, np.float32))
        self.geoms.append(g)
        return len(self.geoms) - 1

    def _accumulate_inertia(self, body, m, com_g, I_g, pos, quat):
        """Accumulate a geom's mass properties into its body (body frame)."""
        R = _quat_to_mat_np(quat)
        com_b = pos + R @ com_g
        I_b = R @ I_g @ R.T
        bd = self.bodies[body]
        m_old, c_old, I_old = bd.mass, bd.com, bd.inertia
        m_new = m_old + m
        c_new = (m_old * c_old + m * com_b) / max(m_new, 1e-12)
        # parallel-axis both to the new com
        def shift(I, m, d):
            return I + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
        bd.inertia = shift(I_old, m_old, c_old - c_new) + shift(I_b, m, com_b - c_new)
        bd.mass, bd.com = m_new, c_new

    def set_body_mass(self, body, mass, com=None, inertia=None):
        bd = self.bodies[body]
        bd.mass = mass
        if com is not None:
            bd.com = np.asarray(com, np.float64)
        if inertia is not None:
            bd.inertia = np.asarray(inertia, np.float64)

    def add_force_sensor(self, body: int, pos=(0.0, 0.0, 0.0)):
        self.sensors.append((body, np.asarray(pos, np.float64)))

    def add_actuator(self, dof_body: int, gear: float, sub_dof: int = 0):
        # resolved to flat dof index at finalize
        self.actuator_dof.append((dof_body, sub_dof))
        self.actuator_gear.append(gear)

    # -- finalize ---------------------------------------------------------
    def finalize(self) -> SceneModel:
        nb = len(self.bodies)
        q_adr = np.zeros(nb, np.int32)
        v_adr = np.zeros(nb, np.int32)
        nq = nv = 0
        for i, b in enumerate(self.bodies):
            q_adr[i], v_adr[i] = nq, nv
            nq += _NQ[b.jnt_type]
            nv += _NV[b.jnt_type]

        parent = np.array([b.parent for b in self.bodies], np.int32)
        # ancestor masks
        body_anc = np.zeros((nb, nb), bool)
        for j in range(nb):
            a = j
            while a != -1:
                body_anc[a, j] = True
                a = parent[a]

        dof_body = np.zeros(nv, np.int32)
        for i, b in enumerate(self.bodies):
            for k in range(_NV[b.jnt_type]):
                dof_body[v_adr[i] + k] = i
        dof_anc = body_anc[dof_body][:, dof_body]  # [i,j]: body(i) anc-of body(j)
        dof_body_mask = body_anc[dof_body]         # (nv, nb)

        def cat(attr, default):
            out = np.full(nv, default, np.float64)
            for i, b in enumerate(self.bodies):
                n = _NV[b.jnt_type]
                if n:
                    out[v_adr[i]: v_adr[i] + n] = getattr(b, attr)
            return out

        dof_lower = cat("limit_lower", -1e9)
        dof_upper = cat("limit_upper", 1e9)
        has_limit = (dof_lower > -1e8) | (dof_upper < 1e8)
        vel_limit = cat("velocity_limit", 1e9)
        # free-joint dofs never have limits; clamp their velocities to the
        # PhysX defaults (maxLinearVelocity 1000, maxAngularVelocity 64) so
        # contact blow-ups cannot propagate unbounded energy
        for i, b in enumerate(self.bodies):
            if b.jnt_type == FREE:
                has_limit[v_adr[i]: v_adr[i] + 6] = False
                vel_limit[v_adr[i]: v_adr[i] + 3] = np.minimum(
                    vel_limit[v_adr[i]: v_adr[i] + 3], 1000.0)
                vel_limit[v_adr[i] + 3: v_adr[i] + 6] = np.minimum(
                    vel_limit[v_adr[i] + 3: v_adr[i] + 6], 64.0)

        act_dof = np.array(
            [v_adr[b] + k for (b, k) in self.actuator_dof], np.int32
        ) if self.actuator_dof else np.zeros(0, np.int32)

        m = SceneModel(
            nb=nb,
            nq=nq,
            nv=nv,
            body_names=[b.name for b in self.bodies],
            parent=parent,
            jnt_type=np.array([b.jnt_type for b in self.bodies], np.int32),
            jnt_axis=np.stack([b.jnt_axis for b in self.bodies]) if nb else np.zeros((0, 3)),
            jnt_pos=np.stack([b.jnt_pos for b in self.bodies]) if nb else np.zeros((0, 3)),
            body_pos=np.stack([b.body_pos for b in self.bodies]),
            body_quat=np.stack([b.body_quat for b in self.bodies]),
            q_adr=q_adr,
            v_adr=v_adr,
            mass=np.array([b.mass for b in self.bodies]),
            com=np.stack([b.com for b in self.bodies]),
            inertia=np.stack([b.inertia for b in self.bodies]),
            dof_body=dof_body,
            dof_lower=dof_lower,
            dof_upper=dof_upper,
            dof_has_limit=has_limit,
            dof_damping=cat("damping", 0.0),
            dof_spring=cat("spring", 0.0),
            dof_armature=cat("armature", 0.0),
            dof_friction=cat("friction", 0.0),
            dof_effort_limit=cat("effort_limit", 1e9),
            dof_velocity_limit=vel_limit,
            dof_drive_mode=np.full(nv, DRIVE_NONE, np.int32),
            dof_stiffness=np.zeros(nv),
            dof_drive_damping=np.zeros(nv),
            body_ancestor=body_anc,
            dof_ancestor=dof_anc,
            dof_body_mask=dof_body_mask,
            jnt_pitch=np.array([b.jnt_pitch for b in self.bodies]),
            body_gravity=np.ones(nb),
            geoms=list(self.geoms),
            actor_root_body=np.array(self.actor_root_body, np.int32),
            num_actors=self._cur_actor + 1,
            sensor_body=np.array([b for b, _ in self.sensors], np.int32),
            sensor_pos=(np.stack([p for _, p in self.sensors])
                        if self.sensors else np.zeros((0, 3))),
            actuator_dof=act_dof,
            actuator_gear=np.array(self.actuator_gear, np.float64),
            init_qpos=None,
        )
        return m


def default_qpos(model: SceneModel) -> np.ndarray:
    """Neutral generalized position: identity free joints, zero angles."""
    q = np.zeros(model.nq)
    for b in range(model.nb):
        if model.jnt_type[b] == FREE:
            q[model.q_adr[b] + 6] = 1.0  # quat w
    if model.init_qpos is not None:
        return model.init_qpos.copy()
    return q


# ---------------------------------------------------------------------------
# spec (de)serialization — lets finalized robots ship as plain Python data


def model_to_spec(m: SceneModel) -> dict:
    """Serialize a finalized model to a JSON-able dict (arrays -> lists)."""
    spec = {}
    for f in dataclasses.fields(SceneModel):
        v = getattr(m, f.name)
        if f.name == "geoms":
            spec["geoms"] = [
                {
                    "body": int(g.body), "gtype": int(g.gtype),
                    "size": g.size.tolist(), "pos": g.pos.tolist(),
                    "quat": g.quat.tolist(), "friction": float(g.friction),
                    "contact": bool(g.contact), "name": g.name,
                }
                for g in v
            ]
        elif isinstance(v, np.ndarray):
            spec[f.name] = v.tolist()
        else:
            spec[f.name] = v
    return spec


def model_from_spec(spec: dict) -> SceneModel:
    kw = dict(spec)
    kw["geoms"] = [
        Geom(body=g["body"], gtype=g["gtype"], size=np.asarray(g["size"], np.float64),
             pos=np.asarray(g["pos"], np.float64), quat=np.asarray(g["quat"], np.float64),
             friction=g["friction"], contact=g["contact"], name=g.get("name", ""))
        for g in spec["geoms"]
    ]
    int_fields = {"parent", "jnt_type", "q_adr", "v_adr", "dof_body",
                  "dof_drive_mode", "actor_root_body", "sensor_body", "actuator_dof"}
    bool_fields = {"dof_has_limit"}
    for f in dataclasses.fields(SceneModel):
        n = f.name
        if n in ("geoms", "nb", "nq", "nv", "body_names", "num_actors"):
            continue
        v = kw.get(n)
        if isinstance(v, list):
            if n in int_fields:
                kw[n] = np.asarray(v, np.int32)
            elif n in bool_fields or n in ("body_ancestor", "dof_ancestor", "dof_body_mask"):
                kw[n] = np.asarray(v, bool)
            else:
                kw[n] = np.asarray(v, np.float64)
    if kw.get("init_qpos") is not None and not isinstance(kw["init_qpos"], np.ndarray):
        kw["init_qpos"] = np.asarray(kw["init_qpos"], np.float64)
    return SceneModel(**kw)


def compose_scene(parts) -> SceneModel:
    """Compose several finalized models into one scene (the create_actor loop).

    ``parts``: list of (SceneModel, base_pos(3), base_quat(4) xyzw).  Each
    part's root bodies are re-rooted at the given world transform; fixed-base
    actors get the transform folded into their root body frame, free-base
    actors get it folded into their init_qpos.  Replaces the reference's
    per-env ``create_actor`` calls (e.g. franka_reach_MA.py:363-422) with a
    single static description.
    """
    b = ModelBuilder()
    for m, base_pos, base_quat in parts:
        base_pos = np.asarray(base_pos, np.float64)
        base_quat = np.asarray(base_quat, np.float64)
        b.begin_actor()
        off = len(b.bodies)
        q0_src = m.init_qpos if m.init_qpos is not None else default_qpos(m)
        for i in range(m.nb):
            nvj = _NV[int(m.jnt_type[i])]
            parent = int(m.parent[i])
            bp, bq = m.body_pos[i].copy(), m.body_quat[i].copy()
            if parent == -1 and m.jnt_type[i] != FREE:
                bp = base_pos + _quat_to_mat_np(base_quat) @ bp
                bq = _quat_mul_np(base_quat, bq)
            v0, v1 = int(m.v_adr[i]), int(m.v_adr[i]) + nvj
            b.add_body(
                m.body_names[i],
                parent + off if parent != -1 else -1,
                int(m.jnt_type[i]),
                jnt_axis=m.jnt_axis[i], jnt_pos=m.jnt_pos[i],
                jnt_pitch=(float(m.jnt_pitch[i])
                           if len(m.jnt_pitch) == m.nb else 0.0),
                body_pos=bp, body_quat=bq,
                mass=float(m.mass[i]), com=m.com[i], inertia=m.inertia[i],
                limit_lower=m.dof_lower[v0:v1] if nvj else None,
                limit_upper=m.dof_upper[v0:v1] if nvj else None,
            )
            bd = b.bodies[-1]
            if nvj:
                bd.damping = m.dof_damping[v0:v1].copy()
                bd.spring = m.dof_spring[v0:v1].copy()
                bd.armature = m.dof_armature[v0:v1].copy()
                bd.effort_limit = m.dof_effort_limit[v0:v1].copy()
                bd.velocity_limit = m.dof_velocity_limit[v0:v1].copy()
                if len(m.dof_friction) == m.nv:
                    bd.friction = m.dof_friction[v0:v1].copy()
        for g in m.geoms:
            # field-preserving copy (SDF payloads / explicit contact clouds
            # must survive composition)
            b.geoms.append(dataclasses.replace(g, body=off + g.body))
        for s in range(len(m.sensor_body)):
            b.add_force_sensor(off + int(m.sensor_body[s]), m.sensor_pos[s])
        for a in range(len(m.actuator_dof)):
            dof = int(m.actuator_dof[a])
            body = int(m.dof_body[dof])
            b.add_actuator(off + body, float(m.actuator_gear[a]),
                           sub_dof=dof - int(m.v_adr[body]))
    out = b.finalize()
    # stitch per-body gravity flags from the parts
    gv = []
    for m, _, _ in parts:
        gv.append(m.body_gravity if len(m.body_gravity) == m.nb
                  else np.ones(m.nb))
    out.body_gravity = np.concatenate(gv) if gv else np.ones(out.nb)
    out.body_lin_damping = np.concatenate(
        [m.body_lin_damping if len(m.body_lin_damping) == m.nb
         else np.zeros(m.nb) for m, _, _ in parts]) \
        if parts else np.zeros(out.nb)
    out.body_ang_damping = np.concatenate(
        [m.body_ang_damping if len(m.body_ang_damping) == m.nb
         else np.zeros(m.nb) for m, _, _ in parts]) \
        if parts else np.zeros(out.nb)
    # stitch per-dof DRIVE config (mode / kp / kd).  These live only on the
    # finalized SceneModel arrays (ModelBuilder bodies don't carry them), so
    # tasks set them on part models BEFORE composing — dropping them here
    # silently disabled every PD drive configured that way (the hand tasks
    # were fully limp: actions never reached the sim).
    if parts:
        out.dof_drive_mode = np.concatenate(
            [np.asarray(m.dof_drive_mode, np.int32) for m, _, _ in parts])
        out.dof_stiffness = np.concatenate(
            [np.asarray(m.dof_stiffness, np.float64) for m, _, _ in parts])
        out.dof_drive_damping = np.concatenate(
            [np.asarray(m.dof_drive_damping, np.float64)
             for m, _, _ in parts])
    # stitch init_qpos (applying base transforms to free roots)
    q0 = default_qpos(out)
    adr = 0
    for m, base_pos, base_quat in parts:
        src = m.init_qpos if m.init_qpos is not None else default_qpos(m)
        q0[adr: adr + m.nq] = src
        for i in range(m.nb):
            if int(m.parent[i]) == -1 and int(m.jnt_type[i]) == FREE:
                qa = adr + int(m.q_adr[i])
                base_pos_a = np.asarray(base_pos, np.float64)
                base_quat_a = np.asarray(base_quat, np.float64)
                q0[qa: qa + 3] = base_pos_a + _quat_to_mat_np(base_quat_a) @ src[int(m.q_adr[i]): int(m.q_adr[i]) + 3]
                q0[qa + 3: qa + 7] = _quat_mul_np(base_quat_a, src[int(m.q_adr[i]) + 3: int(m.q_adr[i]) + 7])
        adr += m.nq
    out.init_qpos = q0
    return out
