"""Batched reduced-coordinate rigid-body engine (port of
isaacgymenvs_ma_tpu/physics/engine.py).

Same model as the JAX engine: world-frame joint-space dynamics, implicit
drives folded into the mass-matrix diagonal, a velocity-level projected-
Jacobi contact solve over a static candidate set.  The per-substep
kinematics and dynamics chain run through the dispatching wrappers of
:mod:`.dyn_kernel` — CUDA kernels B1-B3 for CUDA tensors, their plain twins
for CPU tensors — exactly where the JAX engine runs its Pallas kernels
(engine.py:802-803, :938-949).  With ``SimParams.use_contact_kernel`` the
contact iteration loop runs through :func:`.contact_kernel.solve` (kernel
B4, engine.py:1708-1735) unless the scene splits masses; otherwise it is a
loop of batched products (:func:`takes_contact_kernel`, the JAX engine's
own route rule; ``PhysicsEngine.contact_route`` names the route taken).
:func:`spd_inverse` (OSC's two inverses) runs through kernel B5
(:mod:`.spd_kernel`).

Ported so far: what the Ant, BallBalance, Cartpole, the four
multi-arm Franka, the Humanoid, Anymal, AnymalTerrain, Ingenuity and
Quadcopter, the single-arm Franka, Trifinger, AllegroKuka, the hands,
Dextreme, Factory and IndustReal steps run (per-env domain-randomization
scales of mass, shape,
friction, stiffness, damping, armature, effort limit and joint friction;
dof dry friction; Jacobi mass splitting, contact warm start and bfloat16
solver rows on the batched-product loop; per-body rigid damping;
ground contact rows, on a flat plane or on a
heightfield terrain (with ``terrain_normal_frames``, gaps along the
surface normal and tangent frames about it), body-pair contact rows against primitive SDFs or
baked SDF grids (:mod:`.sdf_grid`) with
tangent frames, rigid-body attractors, conditional grab constraints
switched per env by ``Control.grab_active``, external body wrenches
``Control.f_ext``, joint limits, effort and PD actuation with position
targets, mass-matrix reuse, active-set compaction and contact-row reuse
with impulse continuation on the batched-product loop (the B4 route
ignores both, as the JAX kernel route does), the controller readouts, and
for a scene without contact rows or grabs the joint-limit solve
:meth:`PhysicsEngine._limit_solve`): every option of the JAX engine's
SimParams.  Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..models import model as md

from ..device import DTYPE, apply_precision_policy, resolve_device
from ..ops import maths
from . import contact_kernel as ck
from . import dyn_kernel as dk
from . import sdf_grid, spd_kernel


class SimParams(NamedTuple):
    """Mirror of the JAX engine's SimParams (engine.py:69-163); see there
    for what each field means."""

    dt: float = 1.0 / 60.0
    substeps: int = 2
    gravity: tuple = (0.0, 0.0, -9.81)
    num_iterations: int = 8
    relaxation: float = 0.35
    baumgarte: float = 0.2
    contact_slop: float = 0.001
    max_depenetration_velocity: float = 10.0
    contact_margin: float = 0.0
    terrain_normal_frames: bool = False
    plane_friction: float = 1.0
    plane_restitution: float = 0.0
    bounce_threshold_velocity: float = 0.2
    reuse_mass_matrix: bool = True
    use_contact_kernel: bool = False
    mass_splitting: bool = False
    solver_rows_bf16: Optional[bool] = None
    contact_capacity: Optional[int] = None
    reuse_contact_rows: bool = False
    contact_continuation: bool = True
    warm_start: float = 0.0


class Control(NamedTuple):
    """Per-step actuation inputs: ``tau`` (N, nv) dof effort, optional PD
    ``pos_target``/``vel_target`` (N, nv), ``f_ext`` (N, nb, 6) external
    wrenches [torque, force] on each body about its own origin, in world
    axes, and ``grab_active`` (N, G), 1 where a grab constraint is on
    (None: every grab off; ignored by a scene without grabs, as in the JAX
    engine)."""

    tau: torch.Tensor
    pos_target: Optional[torch.Tensor] = None
    vel_target: Optional[torch.Tensor] = None
    f_ext: Optional[torch.Tensor] = None
    grab_active: Optional[torch.Tensor] = None


class SimState(NamedTuple):
    q: torch.Tensor    # (N, nq)
    qd: torch.Tensor   # (N, nv)
    # warm-start impulses (SimParams.warm_start > 0, else None): the
    # previous substep's (lam_rows (N, rows, 3) in the row frames, lam_lo,
    # lam_hi (N, nv)) at the full candidate rows
    lam: Any = None


class SimOutput(NamedTuple):
    """Derived per-step readouts (the refresh_* tensor family)."""

    body_pos: torch.Tensor        # (N, nb, 3)
    body_quat: torch.Tensor       # (N, nb, 4)
    body_vel: torch.Tensor        # (N, nb, 6) [linvel at body origin, angvel]
    root_states: torch.Tensor     # (N, num_actors, 13)
    contact_force: torch.Tensor   # (N, nb, 3) net contact force (world)
    sensor_forces: torch.Tensor   # (N, n_sensors, 6) [force, torque] body frame
    qdd: torch.Tensor             # (N, nv) smooth accelerations (pre-contact)
    dof_force: torch.Tensor       # (N, nv) applied + constraint force


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def spd_inverse(H: torch.Tensor) -> torch.Tensor:
    """Batched SPD matrix inverse (engine.py:274-312) of (..., n, n).

    n = 1 and n = 2 in closed form, as the JAX package; n >= 3 through
    :func:`.spd_kernel.sweep_inverse`: kernel B5 for CUDA tensors, its plain
    twin (the Gauss-Jordan sweep) for CPU tensors.  H must be symmetric
    positive definite (no pivoting)."""
    n = H.shape[-1]
    if n == 1:
        return 1.0 / H
    if n == 2:
        a, b, d = H[..., 0, 0], H[..., 0, 1], H[..., 1, 1]
        det = a * d - b * b
        inv = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-b, a], -1)], -2)
        return inv / det[..., None, None]
    flat = H.reshape(-1, n, n).contiguous()
    return spd_kernel.sweep_inverse(flat).reshape(H.shape)


def takes_contact_kernel(params: SimParams) -> bool:
    """Whether a scene with contact rows solves them through kernel B4:
    ``use_contact_kernel`` without ``mass_splitting`` and without
    ``warm_start``, the JAX engine's own route rule (engine.py:1289-1290,
    ``kernel_on and not (warm ...) and not pr.mass_splitting``): the split
    masses' per-row scale and the warm-start seeds exist only on the
    batched-product loop, which then compacts and reuses rows as on the
    default route.  (JAX reads the warm-start clause per call, from a
    state that carries impulses; every state of a warm-start engine
    carries them, :meth:`PhysicsEngine.zero_warm`.)"""
    return bool(params.use_contact_kernel and not params.mass_splitting
                and not params.warm_start > 0)


def solver_rows_bf16(model, params: SimParams, n_rows: int,
                     on_loop: Optional[bool] = None) -> bool:
    """Whether the JAX engine stores the loop's row matrices in bfloat16
    (SimParams.solver_rows_bf16; None = its auto rule, engine.py:1798-1803:
    the rows left after active-set compaction times nv reach 1024).  The
    kernel route has no bf16 rows; a mass-split scene takes the loop
    (:func:`takes_contact_kernel`), and so does a call with restitution on
    any scene (``on_loop``, :meth:`PhysicsEngine.route_for`): the rule then
    counts the loop's rows."""
    if params.solver_rows_bf16 is not None:
        return bool(params.solver_rows_bf16)
    if on_loop is None:
        on_loop = not takes_contact_kernel(params)
    cap = params.contact_capacity
    rows = n_rows if cap is None else min(n_rows, int(cap))
    return rows * int(model.nv) >= 1024 and on_loop


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (to nearest, ties to even) and back: with
    both operands of a float32 product so rounded the product is exact, so
    a float32 bmm of rounded operands computes the JAX loop's bfloat16
    products with float32 accumulation (engine.py:1805-1817) up to the
    order of the sums."""
    return t.to(torch.bfloat16).to(t.dtype)


def _check_supported(model):
    """Reject a model the engine cannot step as the JAX engine does."""
    for b in range(model.nb):
        if int(model.jnt_type[b]) in (md.HINGE, md.SLIDE, md.SCREW):
            nrm = float(np.linalg.norm(np.asarray(model.jnt_axis[b])))
            if abs(nrm - 1.0) > 1e-5:
                # the two JAX FK paths agree only for unit axes (ROADMAP C2)
                raise ValueError(
                    f"joint axis of body {b} has norm {nrm}: unit axes "
                    "are required")


class PhysicsEngine:
    """Physics stepper for one scene replicated over N envs on ``device``."""

    def __init__(self, model: md.SceneModel, params: SimParams,
                 ground: bool = True, pair_specs=None, attractors=None,
                 grabs=None, device="cuda"):
        apply_precision_policy()
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.ground = ground
        m = model
        dev = self.device
        f32 = lambda x: torch.as_tensor(  # noqa: E731
            np.asarray(x, np.float32), device=dev)

        self.nb, self.nq, self.nv = int(m.nb), int(m.nq), int(m.nv)
        self.parent = np.asarray(m.parent)
        self.jnt_type_np = np.asarray(m.jnt_type)
        self.q_adr = np.asarray(m.q_adr)
        self.v_adr = np.asarray(m.v_adr)
        self.jnt_pitch_np = (np.asarray(m.jnt_pitch)
                             if len(m.jnt_pitch) == m.nb else np.zeros(m.nb))
        self.grav_mask_np = (np.asarray(m.body_gravity, np.float32)
                             if len(getattr(m, "body_gravity", [])) == m.nb
                             else np.ones(m.nb, np.float32))

        self.body_pos = f32(m.body_pos)
        self.body_quat = f32(m.body_quat)
        self.jnt_axis = f32(m.jnt_axis)
        self.jnt_pos = f32(m.jnt_pos)
        self.grav_mask = f32(self.grav_mask_np)
        self.mass = f32(m.mass)
        self.com = f32(m.com)
        self.inertia = f32(m.inertia)
        self.dof_damping = f32(m.dof_damping)
        self.dof_spring = f32(m.dof_spring)
        self.dof_armature = f32(m.dof_armature)
        # per-dof Coulomb friction torque (engine.py:370-375)
        dfr = np.asarray(getattr(m, "dof_friction", np.zeros(0)))
        if len(dfr) != m.nv:
            dfr = np.zeros(m.nv)
        self.dof_friction = f32(dfr)
        self.has_dof_friction = bool(np.any(dfr > 0.0))
        # per-body rigid damping (PhysX linear / angular damping; the
        # Factory Franka's 1.0 / 5.0, engine.py:347-357)
        bld = np.asarray(getattr(m, "body_lin_damping", np.zeros(0)))
        bad = np.asarray(getattr(m, "body_ang_damping", np.zeros(0)))
        self.body_damp_lin = f32(bld if len(bld) == m.nb else np.zeros(m.nb))
        self.body_damp_ang = f32(bad if len(bad) == m.nb else np.zeros(m.nb))
        self.has_body_damping = bool((len(bld) == m.nb and bld.any())
                                     or (len(bad) == m.nb and bad.any()))
        self.dof_lower = f32(m.dof_lower)
        self.dof_upper = f32(m.dof_upper)
        self.dof_has_limit = torch.as_tensor(
            np.asarray(m.dof_has_limit, bool), device=dev)
        self.dof_effort_limit = f32(m.dof_effort_limit)
        self.dof_velocity_limit = f32(m.dof_velocity_limit)
        drive_mode = np.asarray(m.dof_drive_mode)
        self.kp_drive = f32(np.where(drive_mode == md.DRIVE_POS,
                                     m.dof_stiffness, 0.0))
        self.kd_drive = f32(np.where(drive_mode != md.DRIVE_NONE,
                                     m.dof_drive_damping, 0.0))

        # structure masks
        self.dof_body_mask_f = f32(m.dof_body_mask)       # (nv, nb)
        dof_body_np = np.asarray(m.dof_body)
        same_body = dof_body_np[:, None] == dof_body_np[None, :]
        iu = np.arange(m.nv)
        upper_tri = iu[:, None] <= iu[None, :]
        anc = np.asarray(m.dof_ancestor)
        # CRBA mask: each (i, j) pair once (strict ancestor, or same body
        # with i <= j)
        self.dof_anc_np = (anc & ~same_body) | (same_body & upper_tri)
        self.dof_anc = torch.as_tensor(self.dof_anc_np, device=dev)
        eye_nb = np.eye(m.nb, dtype=np.float32)
        self.oh_dof_body = f32(eye_nb[dof_body_np])       # (nv, nb)
        self.dof_comp = f32(eye_nb[dof_body_np] @ np.asarray(
            m.body_ancestor, np.float32))                # (nv, nb)

        # scalar joint coordinates (hinge/slide/screw)
        dof_qid = np.full(m.nv, -1, np.int64)
        for b in range(m.nb):
            if int(m.jnt_type[b]) in (md.HINGE, md.SLIDE, md.SCREW):
                dof_qid[m.v_adr[b]] = m.q_adr[b]
        self.dof_qid = dof_qid                            # (nv,) q index
        self.scalar_dofs = np.nonzero(dof_qid >= 0)[0]
        self.scalar_qids = dof_qid[self.scalar_dofs]
        # the index and constant tensors of the step, on the device once:
        # a numpy index or a torch.tensor(...) constant would copy to the
        # card and wait for it on every use
        self.scalar_dofs_t = torch.as_tensor(self.scalar_dofs, device=dev)
        self._scalar_qids_t = torch.as_tensor(self.scalar_qids, device=dev)
        self._quat_id = f32([0.0, 0.0, 0.0, 1.0])
        self._ez = f32([0.0, 0.0, 1.0])
        q2d = np.zeros((m.nv, m.nq), np.float32)
        for d, qid in zip(self.scalar_dofs, self.scalar_qids):
            q2d[d, qid] = 1.0
        self.q_to_dof = f32(q2d)                          # (nv, nq)

        self._build_contact_set(m, ground, pair_specs or [])
        self._build_attractors(m, attractors or [])
        self._build_grabs(m, grabs or [])
        _check_supported(m)
        # the loop's row matrices and the vectors they multiply rounded to
        # bfloat16 (SimParams.solver_rows_bf16 or its auto rule); the B4
        # route has no bf16 rows, as the JAX kernel route has none
        self.rows_bf16 = solver_rows_bf16(
            m, params, self.n_ground + self.n_pair_rows, on_loop=True)
        self.gravity = f32(params.gravity)
        self.h = params.dt / params.substeps
        self.plan = dk.get_plan(self)
        # a scene without ground rows, pair rows or grabs takes the
        # joint-limit solve, whatever use_contact_kernel says
        # (engine.py:966-978); the JAX engine then ignores its attractors
        # too.  Grabs alone run the batched loop with no contact rows: B4
        # needs one (engine.py:1297, ContactPlan)
        self.has_contact_rows = bool(self.n_ground or self.pairs
                                     or self.grabs)
        # kernel B4's static plan: row masks per group, loop constants
        self.cplan = None
        if takes_contact_kernel(params) and (self.n_ground or self.pairs):
            masks = {"c": self.row_masks_np}
            if self.attractors:
                masks["a"] = np.stack([a["mask"] for a in self.attractors])
            if self.grabs:
                masks["g"] = np.stack([g["mask"] for g in self.grabs])
            self.cplan = ck.ContactPlan(
                masks, self.nv, params.num_iterations, params.relaxation,
                has_frames=bool(self.pairs))
        # the route the contact solve takes without restitution: B4, the
        # batched-product loop, or the joint-limit solve of a scene without
        # contact rows or grabs
        self.contact_route = self.route_for(None)

    def route_for(self, phys=None, terrain=None) -> str:
        """The route a step with the physics scales ``phys`` on
        ``terrain`` takes: ``"b4"``, ``"loop"`` or ``"limit_solve"``.  A
        call whose ``phys`` carries restitution takes the batched-product
        loop even on a scene planned for B4, with the loop's own capacity
        and row reuse, as the JAX engine does (engine.py:1291-1292,
        ``kernel_on and restitution is None``; :1304 ``reuse_rows``): the
        bounce target is lifted after J is built, which B4 does not do.  So
        does a call on a terrain with ``terrain_normal_frames``
        (engine.py:1294-1295): B4 does not model the terrain rows' frames.
        A pure function of the scene and the call, so a captured graph
        holds no route state."""
        if not self.has_contact_rows:
            return "limit_solve"
        if self.cplan is None:
            return "loop"
        if terrain is not None and self.params.terrain_normal_frames:
            return "loop"
        if getattr(phys, "restitution", None) is None:
            return "b4"
        return "loop"

    def _build_contact_set(self, m, ground, pair_specs):
        """Contact candidates (engine.py:415-470), body-pair rows
        (engine.py:478-503) and the static row/sensor attribution the
        readouts use (engine.py:504-513).  Rows are the ground rows, then
        the pair rows, in the JAX engine's order."""
        dev = self.device
        pts_body, pts_off, pts_rad, pts_mu = [], [], [], []
        geom_pts = {}
        for gi, g in enumerate(m.geoms):
            if not g.contact:
                continue
            Rg = md._quat_to_mat_np(g.quat)
            if getattr(g, "contact_points", None) is not None:
                cands = [np.asarray(c, np.float64) for c in g.contact_points]
                r = float(g.size[0]) if g.gtype == md.GEOM_SPHERE else 0.0
            elif g.gtype == md.GEOM_SPHERE:
                cands = [np.zeros(3)]
                r = g.size[0]
            elif g.gtype == md.GEOM_CAPSULE:
                hl = g.size[1]
                cands = [np.array([0, 0, -hl]), np.array([0, 0, hl])]
                r = g.size[0]
            elif g.gtype == md.GEOM_BOX:
                hx, hy, hz = g.size
                cands = [np.array([sx * hx, sy * hy, sz * hz])
                         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
                r = 0.0
            else:
                continue
            geom_pts[gi] = list(range(len(pts_body), len(pts_body) + len(cands)))
            for c in cands:
                pts_body.append(g.body)
                pts_off.append(g.pos + Rg @ c)
                pts_rad.append(r)
                pts_mu.append(g.friction)
        self.pts_body = np.asarray(pts_body, np.int64)
        self.pts_off = np.asarray(pts_off, np.float32).reshape(-1, 3)
        self.pts_rad = np.asarray(pts_rad, np.float32)
        dbm = np.asarray(m.dof_body_mask, np.float32)           # (nv, nb)
        self.n_ground = 0
        self.gnd_body = np.zeros(0, np.int64)
        mask_parts = []
        if ground and len(pts_body):
            keep = np.nonzero(_ground_reachable(
                m, self.pts_body, self.pts_off, self.pts_rad))[0]
            self.n_ground = len(keep)
            self.gnd_body = self.pts_body[keep]
            self.gnd_off = torch.as_tensor(self.pts_off[keep], device=dev)
            self.gnd_rad = torch.as_tensor(self.pts_rad[keep], device=dev)
            self.gnd_mu = torch.as_tensor(
                np.array(pts_mu, np.float32)[keep], device=dev)
            # (rows, nv) ancestor-dof mask of each ground row
            mask_parts.append(dbm[:, self.gnd_body].T)
        # body-pair rows: candidate points of geom A against the SDF of B
        self.pairs = []
        for ga, gb in pair_specs:
            gA, gB = m.geoms[ga], m.geoms[gb]
            if gB.gtype not in (md.GEOM_SPHERE, md.GEOM_CAPSULE,
                                md.GEOM_CYLINDER, md.GEOM_BOX, md.GEOM_SDF):
                raise ValueError(f"no SDF for geom type {gB.gtype}")
            idx = np.asarray(geom_pts[ga], np.int64)
            row_mask = dbm[:, self.pts_body[idx]].T - dbm[:, gB.body][None, :]
            # a baked mesh target: the narrowphase samples its voxel grid,
            # whose corner table is built here, once, on the engine's
            # device (engine.py:495-500)
            grid = (sdf_grid.to_device(gB.sdf_values, gB.sdf_origin,
                                       gB.sdf_spacing, dev)
                    if gB.gtype == md.GEOM_SDF else None)
            self.pairs.append(dict(
                pt_idx=idx, tgt_body=int(gB.body), tgt_type=int(gB.gtype),
                grid=grid,
                # the candidates' bodies as an index on the device: a numpy
                # index would copy to the card and wait, every narrowphase
                pt_body=torch.as_tensor(self.pts_body[idx], device=dev),
                tgt_size=torch.as_tensor(np.asarray(gB.size, np.float32),
                                         device=dev),
                tgt_pos=torch.as_tensor(np.asarray(gB.pos, np.float32),
                                        device=dev),
                tgt_quat=torch.as_tensor(np.asarray(gB.quat, np.float32),
                                         device=dev),
                pts_off=torch.as_tensor(self.pts_off[idx], device=dev),
                pts_rad=torch.as_tensor(self.pts_rad[idx], device=dev),
                mu=float(0.5 * (gA.friction + gB.friction))))
            mask_parts.append(row_mask)
        self.n_pair_rows = sum(len(p["pt_idx"]) for p in self.pairs)
        # static (rows, nv) dof masks of all contact rows (_row_masks_np)
        self.row_masks_np = (np.concatenate(mask_parts, 0).astype(np.float32)
                             if mask_parts else np.zeros((0, m.nv), np.float32))
        self.row_masks = torch.as_tensor(self.row_masks_np, device=dev)
        # row attribution: +f on body a, -f on body b (-1 = world)
        ra = self.gnd_body.tolist()
        rb = [-1] * self.n_ground
        for p_ in self.pairs:
            ra.extend(self.pts_body[p_["pt_idx"]].tolist())
            rb.extend([p_["tgt_body"]] * len(p_["pt_idx"]))
        self.row_body_a = np.asarray(ra, np.int64)
        self.row_body_b = np.asarray(rb, np.int64)
        eye = np.eye(m.nb, dtype=np.float32)
        seg_a = eye[self.row_body_a].reshape(-1, m.nb)
        seg_b = np.concatenate([eye, np.zeros((1, m.nb), np.float32)])[
            np.where(self.row_body_b >= 0, self.row_body_b, m.nb)
        ].reshape(-1, m.nb)
        self.seg = torch.as_tensor(seg_a - seg_b, device=dev)
        # mass splitting: per row, a one-hot over the movable bodies it
        # pushes (world and dof-less bodies left out), engine.py:514-524
        movable = np.asarray(m.dof_body_mask).any(axis=0)       # (nb,)
        oh = np.zeros((len(ra), m.nb), np.float32)
        for r, (ba, bb) in enumerate(zip(ra, rb)):
            if ba >= 0 and movable[ba]:
                oh[r, ba] = 1.0
            if bb >= 0 and movable[bb]:
                oh[r, bb] = 1.0
        self.row_body_oh = torch.as_tensor(oh, device=dev)     # (P, nb)
        self.sensor_body = np.asarray(m.sensor_body, np.int64)
        sp = np.asarray(m.sensor_pos)
        if sp.shape != (len(self.sensor_body), 3):
            sp = np.zeros((len(self.sensor_body), 3))
        self.sensor_pos = torch.as_tensor(sp.astype(np.float32), device=dev)
        self.sens_a = torch.as_tensor(
            seg_a[:, self.sensor_body], device=dev)
        self.sens_b = torch.as_tensor(seg_b[:, self.sensor_body], device=dev)
        self.actor_root_body = np.asarray(m.actor_root_body, np.int64)
        idx = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        self._gnd_body_t = idx(self.gnd_body)
        self._row_a_t = idx(self.row_body_a)
        self._row_b_t = idx(np.maximum(self.row_body_b, 0))
        self._row_b_body_t = idx(self.row_body_b >= 0)   # not the plane
        self._sensor_body_t = idx(self.sensor_body)
        self._root_body_t = idx(self.actor_root_body)

    def _build_attractors(self, m, attractors):
        """Rigid-body attractors (engine.py:537-546): soft pins of a body
        point to a world point, solved as bilateral world-axis rows."""
        dbm = np.asarray(m.dof_body_mask, np.float32)
        self.attractors = [dict(
            body=int(ab),
            offset=torch.as_tensor(np.asarray(off, np.float32),
                                   device=self.device),
            target=torch.as_tensor(np.asarray(tgt, np.float32),
                                   device=self.device),
            mask=dbm[:, int(ab)].copy()) for ab, off, tgt in attractors]
        if self.attractors:
            self.att_mask = torch.as_tensor(
                np.stack([a["mask"] for a in self.attractors]),
                device=self.device)                              # (A, nv)

    def _build_grabs(self, m, grabs):
        """Grab constraints (engine.py:526-535): conditional bilateral pins
        of a point on body a to a point on body b, in spec order; the row
        mask is body a's ancestor dofs minus body b's."""
        dbm = np.asarray(m.dof_body_mask, np.float32)
        dev = self.device
        self.grabs = [dict(
            body_a=int(ba), body_b=int(bb),
            off_a=torch.as_tensor(np.asarray(oa, np.float32), device=dev),
            off_b=torch.as_tensor(np.asarray(ob, np.float32), device=dev),
            mask=dbm[:, int(ba)] - dbm[:, int(bb)])
            for ba, oa, bb, ob in grabs]
        if self.grabs:
            self.grab_mask = torch.as_tensor(
                np.stack([g["mask"] for g in self.grabs]), device=dev)
            self._grab_a = torch.as_tensor(
                [g["body_a"] for g in self.grabs], device=dev)
            self._grab_b = torch.as_tensor(
                [g["body_b"] for g in self.grabs], device=dev)
            self._grab_off_a = torch.stack([g["off_a"] for g in self.grabs])
            self._grab_off_b = torch.stack([g["off_b"] for g in self.grabs])

    def _grab_rows(self, body_x, body_q, S, Hinv, grab_active):
        """The grab rows of one solve (engine.py:1652-1682), rebuilt every
        substep (they sit outside the contact-row cache): the world points
        pa, pb of each grab, its rows' Jacobian at their midpoint pm
        (N, 3G, nv), H^-1 J, the Delassus diagonal W (N, G, 3), the target
        velocity b = -baumgarte / h (pa - pb) and the gate (N, G), zero
        everywhere without ``grab_active``."""
        pr, h = self.params, self.h
        N, G = body_x.shape[0], len(self.grabs)
        pa = body_x[:, self._grab_a] + maths.quat_apply(
            body_q[:, self._grab_a], self._grab_off_a)          # (N, G, 3)
        pb = body_x[:, self._grab_b] + maths.quat_apply(
            body_q[:, self._grab_b], self._grab_off_b)
        pm = 0.5 * (pa + pb)
        J = self._build_J_flat(S, pm, self.grab_mask)           # (N, 3G, nv)
        HJ = torch.bmm(J, Hinv)
        W = self._w_diag(J, HJ, N, G)
        b = -pr.baumgarte / h * (pa - pb)
        g_act = (torch.zeros((N, G), dtype=body_x.dtype, device=body_x.device)
                 if grab_active is None else grab_active.to(body_x.dtype))
        return pm, J, HJ, W, b, g_act

    # ------------------------------------------------------------------
    # kinematics
    def kinematics(self, q: torch.Tensor):
        """Kernel B1 on standard-layout q (N, nq): body_x (N, nb, 3),
        body_q (N, nb, 4), S (N, nv, 6) as views of the batch-last outputs,
        plus the batch-last tensors themselves for B2/B3."""
        bx_bl, bq_bl, S_bl = dk.fk_motion(self.plan, q.t().contiguous())
        return (bx_bl.permute(2, 0, 1), bq_bl.permute(2, 0, 1),
                S_bl.permute(2, 0, 1), (bx_bl, bq_bl, S_bl))

    def fk(self, q: torch.Tensor):
        """Forward kinematics in the reference layout (engine.py:561-599)."""
        xs, qs = [], []
        for b in range(self.nb):
            t = int(self.jnt_type_np[b])
            qa = int(self.q_adr[b])
            if self.parent[b] == -1:
                xp = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype,
                                 device=q.device)
                qp = self._quat_id.expand(q.shape[:-1] + (4,))
            else:
                xp, qp = xs[self.parent[b]], qs[self.parent[b]]
            if t == md.FREE:
                xb = q[..., qa: qa + 3]
                qb = q[..., qa + 3: qa + 7]
            else:
                bp, bq = self.body_pos[b], self.body_quat[b]
                if t in (md.HINGE, md.SCREW):
                    qj = maths.quat_from_angle_axis(q[..., qa], self.jnt_axis[b])
                    ql = maths.quat_mul(bq.expand(qj.shape), qj)
                    anchor = self.jnt_pos[b]
                    tl = (bp + maths.quat_apply(bq, anchor)
                          - maths.quat_apply(ql, anchor))
                    if t == md.SCREW:
                        pitch = float(self.jnt_pitch_np[b]) / (2.0 * np.pi)
                        tl = tl + maths.quat_apply(bq, self.jnt_axis[b]) \
                            * (pitch * q[..., qa: qa + 1])
                elif t == md.SLIDE:
                    ql = bq.expand(qp.shape)
                    tl = bp + maths.quat_apply(bq, self.jnt_axis[b]) \
                        * q[..., qa: qa + 1]
                else:  # FIXED
                    ql = bq.expand(qp.shape)
                    tl = bp.expand(xp.shape)
                xb = xp + maths.quat_apply(qp, tl)
                qb = maths.quat_mul(qp, ql)
            xs.append(xb)
            qs.append(qb)
        return torch.stack(xs, dim=-2), torch.stack(qs, dim=-2)

    def dof_motion(self, body_x, body_q):
        """Motion subspace S (N, nv, 6) about the world origin: [ang, lin]
        (engine.py:601-634)."""
        N = body_x.shape[0]
        zero3 = torch.zeros((N, 3), dtype=body_x.dtype, device=body_x.device)
        eye = torch.eye(3, dtype=body_x.dtype, device=body_x.device)
        cols = []
        for b in range(self.nb):
            t = int(self.jnt_type_np[b])
            if t == md.FREE:
                p = body_x[:, b]
                for i in range(3):
                    cols.append(torch.cat([zero3, eye[i].expand(N, 3)], -1))
                for i in range(3):
                    ei = eye[i].expand(N, 3)
                    cols.append(torch.cat([ei, _cross(p, ei)], -1))
            elif t in (md.HINGE, md.SCREW):
                a_w = maths.quat_apply(body_q[:, b], self.jnt_axis[b])
                anchor = body_x[:, b] + maths.quat_apply(body_q[:, b],
                                                         self.jnt_pos[b])
                lin = _cross(anchor, a_w)
                if t == md.SCREW:
                    lin = lin + float(self.jnt_pitch_np[b]) / (2.0 * np.pi) * a_w
                cols.append(torch.cat([a_w, lin], -1))
            elif t == md.SLIDE:
                a_w = maths.quat_apply(body_q[:, b], self.jnt_axis[b])
                cols.append(torch.cat([zero3, a_w], -1))
        return torch.stack(cols, dim=1)

    def body_velocities(self, S, qd):
        """Spatial velocity [ang, lin@origin] per body: V (N, nb, 6)."""
        return torch.matmul(self.dof_body_mask_f.T, S * qd[..., None])

    # ------------------------------------------------------------------
    # dynamics pieces in the reference layout (the plain chain the batch-
    # last twins are held against)
    def spatial_inertia(self, body_x, body_q, mass_scale=None,
                        shape_scale=None):
        """World spatial inertia about the origin (N, nb, 6, 6) and world
        com (engine.py:643-686)."""
        R = maths.quat_to_rotmat(body_q)                       # (N, nb, 3, 3)
        I_loc = self.inertia.expand(R.shape)
        com = self.com
        m = self.mass[None, :, None, None]
        eye3 = torch.eye(3, dtype=body_x.dtype, device=body_x.device)
        if shape_scale is not None:
            s = shape_scale                                    # (N, nb, 3)
            svol = torch.prod(s, dim=-1)[..., None, None]
            tr = torch.diagonal(I_loc, dim1=-2, dim2=-1).sum(-1)[..., None, None]
            Cm = 0.5 * tr * eye3 - I_loc
            Cm = svol * (s[..., :, None] * Cm * s[..., None, :])
            trc = torch.diagonal(Cm, dim1=-2, dim2=-1).sum(-1)[..., None, None]
            I_loc = trc * eye3 - Cm
            m = m * svol
            com = com * s
        Ic = torch.matmul(torch.matmul(R, I_loc), R.transpose(-1, -2))
        c = body_x + maths.quat_apply(body_q, com)
        if mass_scale is not None:
            m = m * mass_scale[:, :, None, None]
            Ic = Ic * mass_scale[:, :, None, None]
        cx = self._skew(c)
        mcx = m * cx
        top_left = Ic - m * torch.matmul(cx, cx)
        I = torch.cat([torch.cat([top_left, mcx], dim=-1),
                       torch.cat([-mcx, m * eye3.expand(cx.shape)], dim=-1)],
                      dim=-2)
        return I, c

    @staticmethod
    def _skew(v):
        z = torch.zeros_like(v[..., 0])
        return torch.stack([
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ], dim=-2)

    @staticmethod
    def _cross_motion(a, b):
        """Spatial motion cross product a x b for [ang, lin] vectors."""
        aw, av = a[..., :3], a[..., 3:]
        bw, bv = b[..., :3], b[..., 3:]
        return torch.cat([_cross(aw, bw), _cross(aw, bv) + _cross(av, bw)], -1)

    @staticmethod
    def _cross_force(v, f):
        """Spatial force cross product v x* f."""
        w, vl = v[..., :3], v[..., 3:]
        n, fl = f[..., :3], f[..., 3:]
        return torch.cat([_cross(w, n) + _cross(vl, fl), _cross(w, fl)], -1)

    def mass_matrix(self, S, I_O):
        """CRBA in world coordinates via ancestor masks: (N, nv, nv)."""
        N = I_O.shape[0]
        comb = torch.matmul(self.dof_comp, I_O.reshape(N, self.nb, 36))
        F = torch.matmul(comb.reshape(N, self.nv, 6, 6), S[..., None])[..., 0]
        G = torch.matmul(S, F.transpose(-1, -2))
        upper = torch.where(self.dof_anc, G, 0.0)
        diag = torch.diagonal(upper, dim1=-2, dim2=-1)
        return upper + upper.transpose(-1, -2) - torch.diag_embed(diag)

    def gravity_wrench(self, body_x, body_q, mass_scale=None,
                       shape_scale=None):
        """Per-body gravity spatial force about the world origin from fresh
        kinematics, in the RNEA a0 = -g sign convention (N, nb, 6)."""
        m = self.mass[None, :].expand(body_x.shape[:2])
        com = self.com
        if shape_scale is not None:
            m = m * torch.prod(shape_scale, dim=-1)
            com = com[None] * shape_scale
        c = body_x + maths.quat_apply(body_q, com.expand(body_x.shape))
        if mass_scale is not None:
            m = m * mass_scale
        f_lin = (m * self.grav_mask[None, :])[..., None] \
            * (-self.gravity)[None, None, :]
        return torch.cat([_cross(c, f_lin), f_lin], -1)

    def bias_force(self, S, qd, V, I_O, f_grav=None):
        """RNEA with qdd = 0 and a0 = -g: C (N, nv)."""
        V_dof = torch.matmul(self.oh_dof_body, V)
        xi = self._cross_motion(V_dof, S * qd[..., None])
        a = torch.matmul(self.dof_body_mask_f.T, xi)
        if f_grav is None:
            a0 = torch.cat([torch.zeros(3, dtype=S.dtype, device=S.device),
                            -self.gravity])
            a = a + a0 * self.grav_mask[:, None]
        Iv = torch.matmul(I_O, V[..., None])[..., 0]
        f = torch.matmul(I_O, a[..., None])[..., 0] + self._cross_force(V, Iv)
        if f_grav is not None:
            f = f + f_grav
        return torch.sum(S * torch.matmul(self.dof_comp, f), dim=-1)

    # ------------------------------------------------------------------
    # substep
    def substep(self, q, qd, ctrl: Control, terrain=None, phys=None,
                dyn_cache=None, contact_cache=None, warm=None):
        """One physics substep (engine.py:785-987, kernel branch).

        ``dyn_cache``: batch-last ``(I_O, Hinv)`` from the first substep of
        the control step (SimParams.reuse_mass_matrix); given, the cached
        chain B3 runs instead of the full chain B2.  ``contact_cache``: the
        contact-row cache of the first substep (SimParams.
        reuse_contact_rows, see :meth:`_contact_solve`).  ``terrain``: a
        :class:`.terrain.TerrainGrid` the ground rows stand on instead of
        the plane z = 0 (with ``SimParams.terrain_normal_frames`` along its
        surface normals, :meth:`_contact_rows`).  ``phys``: the per-env
        :class:`..utils.domain_rand.PhysScales` of the domain randomization
        (engine.py:807-878): mass and shape into B2 and into B3's gravity
        wrench, stiffness and damping into the drives, the passive damping
        and the implicit diagonal, friction and shape into the contact
        rows, ``armature``, ``effort`` and ``joint_friction`` into the
        implicit diagonal, both effort clamps and the dof friction
        (engine.py:860-870), the additive limit shifts ``dof_lower_shift``
        / ``dof_upper_shift`` (N, nv) into the joint-limit gaps of the
        contact solve and of :meth:`_limit_solve` (engine.py:1425-1428,
        :1927-1935), and ``restitution`` (N, nb) per body or (N, 1) into
        the contact rows' bounce targets (:meth:`_contact_solve`); a call
        with restitution takes the loop (:meth:`route_for`).  ``warm``: the
        previous substep's impulses (``SimState.lam``) with
        ``SimParams.warm_start``; the last item of the returned tuple is
        this substep's, or None.  With per-body rigid damping
        (``body_lin_damping`` / ``body_ang_damping`` of the model) the
        damping wrenches join the right-hand side (:meth:`damping_wrench`)."""
        if terrain is not None:
            if self.n_ground != len(self.pts_body):
                raise ValueError(
                    "ground-candidate pruning assumed a flat z=0 plane, but "
                    "this scene steps with a terrain heightfield and has "
                    "pruned candidates on a fixed-base tree; rebuild the "
                    "engine without fixed-base trees or disable pruning for "
                    "this scene")
        mass_s = shape_s = fric_s = None
        kp_drive, kd_drive, d_damp = self.kp_drive, self.kd_drive, \
            self.dof_damping
        armature, eff_lim = self.dof_armature, self.dof_effort_limit
        jfric = self.dof_friction if self.has_dof_friction else None
        lo_lim, hi_lim, restitution = self.dof_lower, self.dof_upper, None
        if phys is not None:
            # additive joint-limit shifts (engine.py:1425-1428)
            if phys.dof_lower_shift is not None:
                lo_lim = lo_lim + phys.dof_lower_shift
            if phys.dof_upper_shift is not None:
                hi_lim = hi_lim + phys.dof_upper_shift
            restitution = phys.restitution
            mass_s, shape_s, fric_s = phys.mass, phys.shape, phys.friction
            # drive gains and passive damping (engine.py:856-859)
            kp_drive = kp_drive * phys.stiffness
            kd_drive = kd_drive * phys.damping
            d_damp = d_damp * phys.damping
            # the dof-property leaves (engine.py:860-870); a joint-friction
            # scale turns the friction term on even at zero friction, as
            # in JAX
            if phys.armature is not None:
                armature = armature * phys.armature
            if phys.effort is not None:
                eff_lim = eff_lim * phys.effort
            if phys.joint_friction is not None:
                jfric = self.dof_friction * phys.joint_friction
        h = self.h
        N = q.shape[0]
        body_x, body_q, S, (bx_bl, bq_bl, S_bl) = self.kinematics(q)

        qpos_dof = q @ self.q_to_dof.T
        tau = torch.clamp(ctrl.tau, -eff_lim, eff_lim)
        rhs = tau - self.dof_spring * (qpos_dof + h * qd) - d_damp * qd
        if jfric is not None:
            # joint dry friction, smooth Coulomb mu tanh(qd / v0); its
            # slope at rest joins the implicit diagonal below
            # (engine.py:880-885, :933-934)
            rhs = rhs - jfric * torch.tanh(qd / 0.05)
        # PD drive with PhysX's drive-force limit; a saturated drive drops
        # its implicit stiffening from the diagonal (engine.py:886-904)
        drive = torch.zeros_like(rhs)
        if ctrl.pos_target is not None:
            drive = drive + kp_drive * (ctrl.pos_target - qpos_dof - h * qd)
        if ctrl.vel_target is not None:
            drive = drive + kd_drive * (ctrl.vel_target - qd)
        else:
            drive = drive - kd_drive * qd
        drive_sat = torch.abs(drive) > eff_lim
        rhs = rhs + torch.clamp(drive, -eff_lim, eff_lim)
        imp = torch.where(drive_sat, 0.0, 1.0)
        if ctrl.f_ext is not None:
            # each body's wrench moved to the world origin, then onto the
            # dofs that move the body (engine.py:905-911)
            f_b = ctrl.f_ext[..., 3:]
            f_o = torch.cat([ctrl.f_ext[..., :3] + _cross(body_x, f_b), f_b],
                            -1)                                 # (N, nb, 6)
            rhs = rhs + torch.einsum("nvd,vb,nbd->nv", S,
                                     self.dof_body_mask_f, f_o)
        if self.has_body_damping:
            # the damping wrenches onto the dofs, as f_ext's above
            rhs = rhs + torch.einsum(
                "nvd,vb,nbd->nv", S, self.dof_body_mask_f,
                self.damping_wrench(body_x, body_q, S, qd))
        diag = (armature + h * d_damp + h * h * self.dof_spring
                + imp * (h * kd_drive + h * h * kp_drive))
        if jfric is not None:
            diag = diag + h * jfric / 0.05

        rhs_bl = rhs.t().contiguous()
        qd_bl = qd.t().contiguous()
        if dyn_cache is None:
            diag_bl = diag.t().contiguous()
            # the scales batch-last for B2: mass (nb, N), shape (nb, 3, N)
            ms_bl = (None if mass_s is None
                     else mass_s.expand(N, self.nb).t().contiguous())
            ss_bl = (None if shape_s is None
                     else shape_s.permute(1, 2, 0).contiguous())
            qdd_bl, hinv_bl, io_bl = dk.dyn_forward(
                self.plan, bx_bl, bq_bl, S_bl, qd_bl, rhs_bl, diag_bl,
                ms_bl, ss_bl)
            cache_out = (io_bl, hinv_bl)
        else:
            io_bl, hinv_bl = dyn_cache
            # the fresh gravity wrench carries the scales too: with
            # reuse_mass_matrix a scale missing here is wrong only from the
            # second substep on (engine.py:836-837, :946-947)
            fg = self.gravity_wrench(body_x, body_q, mass_s, shape_s)
            qdd_bl = dk.dyn_cached(self.plan, S_bl, qd_bl, rhs_bl, io_bl,
                                   hinv_bl, fg.permute(1, 2, 0).contiguous())
            cache_out = dyn_cache
        Hinv = hinv_bl.permute(2, 0, 1)
        qdd = qdd_bl.t()
        qd_new = qd + h * qdd

        if self.has_contact_rows:
            qd_new, impulse_pts, p_w, imp_dof, ccache_out, warm_out = \
                self._contact_solve(qd_new, body_x, body_q, S, Hinv,
                                    qpos_dof, S_bl, hinv_bl,
                                    ccache=contact_cache, qd_geom=qd,
                                    warm=warm,
                                    grab_active=ctrl.grab_active,
                                    terrain=terrain, friction_scale=fric_s,
                                    shape_scale=shape_s, lo_lim=lo_lim,
                                    hi_lim=hi_lim, restitution=restitution,
                                    route=self.route_for(phys, terrain))
        else:
            qd_new = self._limit_solve(qd_new, Hinv, qpos_dof, lo_lim,
                                       hi_lim)
            impulse_pts = p_w = ccache_out = warm_out = None
            imp_dof = torch.zeros_like(qd_new)
        qd_new = torch.clamp(qd_new, -self.dof_velocity_limit,
                             self.dof_velocity_limit)
        q_new = self._integrate(q, qd_new)
        return q_new, qd_new, (body_x, body_q, qdd, impulse_pts, p_w,
                               imp_dof, cache_out, ccache_out, warm_out)

    def damping_wrench(self, body_x, body_q, S, qd):
        """Each body's rigid damping wrench about the world origin
        (N, nb, 6) [torque, force] (engine.py:913-929): the force
        -d_lin m v_com at the centre of mass and the torque -d_ang
        (R I R^T) w, explicit in the substep's velocity."""
        V = self.body_velocities(S, qd)
        w_b, v_o = V[..., 0:3], V[..., 3:6]
        com_w = body_x + maths.quat_apply(body_q, self.com[None])
        v_com = v_o + _cross(w_b, com_w)
        F = -(self.body_damp_lin * self.mass)[None, :, None] * v_com
        w_loc = maths.quat_apply(maths.quat_conjugate(body_q), w_b)
        L_w = maths.quat_apply(
            body_q, torch.einsum("bij,nbj->nbi", self.inertia, w_loc))
        tau_com = -self.body_damp_ang[None, :, None] * L_w
        return torch.cat([tau_com + _cross(com_w, F), F], -1)

    def _limit_solve(self, qd, Hinv, qpos_dof, lo_lim=None, hi_lim=None):
        """Joint-limit-only solve of a scene without contact rows
        (engine.py:1927-1953, e.g. Cartpole): 4 projected-Jacobi sweeps over
        the dofs past a lower or upper limit, with Baumgarte targets and
        H^-1's diagonal (clamped at 1e-8) as the row masses; each sweep
        adds H^-1 times the impulse change to qd.  A batched product, as
        the JAX package computes it outside any Pallas kernel.  ``lo_lim``
        / ``hi_lim``: the limits with the per-env shifts added, (N, nv)."""
        if not bool(np.any(np.asarray(self.model.dof_has_limit))):
            return qd
        pr, h = self.params, self.h
        lo_gap = qpos_dof - (self.dof_lower if lo_lim is None else lo_lim)
        hi_gap = (self.dof_upper if hi_lim is None else hi_lim) - qpos_dof
        hinv_diag = torch.clamp(torch.diagonal(Hinv, dim1=-2, dim2=-1),
                                min=1e-8)
        b_lo = -pr.baumgarte / h * torch.clamp(lo_gap, max=0.0)
        b_hi = -pr.baumgarte / h * torch.clamp(hi_gap, max=0.0)
        act_lo = self.dof_has_limit & (lo_gap < 0.0)
        act_hi = self.dof_has_limit & (hi_gap < 0.0)
        lam_lo = torch.zeros_like(qd)
        lam_hi = torch.zeros_like(qd)
        for _ in range(4):
            lam_lo_new = torch.where(
                act_lo, torch.clamp(lam_lo + (b_lo - qd) / hinv_diag,
                                    min=0.0), 0.0)
            lam_hi_new = torch.where(
                act_hi, torch.clamp(lam_hi + (b_hi + qd) / hinv_diag,
                                    min=0.0), 0.0)
            dlim = (lam_lo_new - lam_lo) - (lam_hi_new - lam_hi)
            qd = qd + torch.einsum("nvw,nw->nv", Hinv, dlim)
            lam_lo, lam_hi = lam_lo_new, lam_hi_new
        return qd

    def _contact_points(self, body_x, body_q, shape_scale=None):
        """World ground-candidate positions p (N, n_ground, 3); with
        ``shape_scale`` (N, nb, 3) the offsets scale in their body's frame
        (engine.py:1219-1226)."""
        off = self.gnd_off
        if shape_scale is not None:
            off = off * shape_scale[:, self._gnd_body_t]           # (N, P, 3)
        return (body_x[:, self._gnd_body_t]
                + maths.quat_apply(body_q[:, self._gnd_body_t], off))

    def _ground_radii(self, shape_scale=None):
        """Ground-candidate radii (P,), or (N, P) scaled by the mean of
        their body's shape scales (engine.py:1327-1329)."""
        if shape_scale is None:
            return self.gnd_rad
        return self.gnd_rad * shape_scale[:, self._gnd_body_t].mean(-1)

    @staticmethod
    def _sdf_local(gtype: int, size, p):
        """Signed distance and outward normal of a primitive at local
        points p (engine.py:990-1035)."""
        eps = 1e-9
        if gtype == md.GEOM_SPHERE:
            r = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
            return r[..., 0] - size[..., 0], p / torch.clamp(r, min=eps)
        if gtype == md.GEOM_CAPSULE:
            hl = size[..., 1:2]
            z = torch.minimum(torch.maximum(p[..., 2:3], -hl), hl)
            d = p - torch.cat([torch.zeros_like(z), torch.zeros_like(z), z], -1)
            r = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
            return r[..., 0] - size[..., 0], d / torch.clamp(r, min=eps)
        if gtype == md.GEOM_CYLINDER:
            rad = torch.linalg.vector_norm(p[..., :2], dim=-1)
            a = rad - size[..., 0]                 # radial distance to side
            b = torch.abs(p[..., 2]) - size[..., 1]  # axial distance to cap
            outside = torch.sqrt(torch.square(torch.clamp(a, min=0.0))
                                 + torch.square(torch.clamp(b, min=0.0)))
            dist = torch.clamp(torch.maximum(a, b), max=0.0) + outside
            radial_n = p[..., :2] / torch.clamp(rad, min=eps)[..., None]
            cap_n = torch.sign(p[..., 2])
            n = torch.where(
                (b > a)[..., None],
                torch.cat([torch.zeros_like(radial_n), cap_n[..., None]], -1),
                torch.cat([radial_n, torch.zeros_like(cap_n)[..., None]], -1))
            return dist, n
        if gtype == md.GEOM_BOX:
            qv = torch.abs(p) - size
            outside = torch.linalg.vector_norm(torch.clamp(qv, min=0.0),
                                               dim=-1)
            inside = torch.clamp(torch.amax(qv, dim=-1), max=0.0)
            n_out = torch.clamp(qv, min=0.0) * torch.sign(p)
            face = torch.nn.functional.one_hot(
                torch.argmax(qv, dim=-1), 3).to(p.dtype)
            n_in = face * torch.sign(p)
            n = torch.where((outside > 0)[..., None],
                            n_out / torch.clamp(outside, min=eps)[..., None],
                            n_in)
            return outside + inside, n
        raise ValueError(f"no SDF for geom type {gtype}")

    @staticmethod
    def _tangent_frame(n):
        """(t1, t2, n) columns (..., 3, 3) from normals (..., 3)
        (engine.py:1038-1046)."""
        # the reference axis: ez, or ex where the normal is near z (built
        # from n: a constant tensor would be copied to the card each call)
        near_z = (~(torch.abs(n[..., 2:3]) < 0.9)).to(n.dtype)
        ref = torch.cat([near_z, torch.zeros_like(near_z), 1.0 - near_z], -1)
        t1 = _cross(n, ref)
        t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1,
                                                       keepdim=True), min=1e-9)
        t2 = _cross(n, t1)
        return torch.stack([t1, t2, n], dim=-1)

    def _pair_rows(self, body_x, body_q, shape_scale=None):
        """Narrowphase of the body-pair rows (engine.py:1048-1100): contact
        points p_c (N, K, 3), gaps phi (N, K), friction (K,) and world
        normals n (N, K, 3).  ``shape_scale`` (N, nb, 3) scales geom A's
        candidate offsets (radii by the mean) and geom B's SDF size and
        offset, per env."""
        ps, phis, mus, ns = [], [], [], []
        for pr_ in self.pairs:
            bodies = pr_["pt_body"]
            xb, qb = body_x[:, bodies], body_q[:, bodies]
            off, rad = pr_["pts_off"], pr_["pts_rad"]
            tgt_size, tgt_pos = pr_["tgt_size"], pr_["tgt_pos"]
            tb = pr_["tgt_body"]
            if shape_scale is not None:
                sp = shape_scale[:, bodies]                      # (N, k, 3)
                off = off * sp
                rad = rad * sp.mean(-1)
                st = shape_scale[:, tb, None, :]                 # (N, 1, 3)
                tgt_size = tgt_size * st
                tgt_pos = tgt_pos * st
            p = xb + maths.quat_apply(qb, off)
            x_t = body_x[:, tb, None, :] + maths.quat_apply(
                body_q[:, tb, None, :], tgt_pos)
            q_t = maths.quat_mul(body_q[:, tb, None, :],
                                 pr_["tgt_quat"].expand(qb.shape))
            lp = maths.quat_rotate_inverse(q_t, p - x_t)
            if pr_["grid"] is not None:
                # a baked grid; with shape scales the uniform-scale
                # approximation d_s(p) = s d(p / s) (engine.py:1079-1087)
                if shape_scale is not None:
                    st_ = shape_scale[:, tb, None, :]
                    d, n_l = sdf_grid.sample_with_normal(pr_["grid"],
                                                         lp / st_)
                    d = d * torch.mean(st_, -1)
                else:
                    d, n_l = sdf_grid.sample_with_normal(pr_["grid"], lp)
            else:
                d, n_l = self._sdf_local(pr_["tgt_type"], tgt_size, lp)
            n_w = maths.quat_apply(q_t, n_l)
            ps.append(p - rad[..., None] * n_w)
            phis.append(d - rad)
            mus.append(torch.full((len(bodies),), pr_["mu"], dtype=DTYPE,
                                  device=body_x.device))
            ns.append(n_w)
        return (torch.cat(ps, 1), torch.cat(phis, 1), torch.cat(mus, 0),
                torch.cat(ns, 1))

    @staticmethod
    def _build_J_flat(S, p_rows, mk, frames=None):
        """Row Jacobians in the flat (N, 3R, nv) layout (engine.py:1445-1480):
        per world axis S_lin + S_ang x p, masked by ``mk`` (R, nv) or, after
        compaction, per env (N, R, nv), and with ``frames`` (N, R, 3, 3)
        projected into the row frames."""
        N, R = p_rows.shape[:2]
        nv = S.shape[1]
        mk = mk[None] if mk.dim() == 2 else mk
        Sa, Sl = S[:, :, 0:3], S[:, :, 3:6]
        px, py, pz = (p_rows[..., k][:, :, None] for k in range(3))
        sax, say, saz = (Sa[..., k][:, None, :] for k in range(3))
        Jx = (Sl[..., 0][:, None, :] + say * pz - saz * py) * mk
        Jy = (Sl[..., 1][:, None, :] + saz * px - sax * pz) * mk
        Jz = (Sl[..., 2][:, None, :] + sax * py - say * px) * mk
        if frames is None:
            return torch.stack([Jx, Jy, Jz], dim=2).reshape(N, 3 * R, nv)
        planes = [frames[..., 0, l][:, :, None] * Jx
                  + frames[..., 1, l][:, :, None] * Jy
                  + frames[..., 2, l][:, :, None] * Jz for l in range(3)]
        return torch.stack(planes, dim=2).reshape(N, 3 * R, nv)

    @staticmethod
    def _w_diag(J_flat, HinvJ_flat, N, R_rows):
        """Per-axis Delassus diagonal (N, R, 3): w_l = J_l . (Hinv J_l)."""
        return torch.clamp(
            torch.sum(J_flat * HinvJ_flat, dim=-1).reshape(N, R_rows, 3),
            min=1e-8)

    def _contact_rows(self, body_x, body_q, N, terrain=None,
                      friction_scale=None, shape_scale=None):
        """Narrowphase of every candidate row, ground rows first
        (engine.py:1306-1397): points p (N, P, 3), gaps phi (N, P),
        friction mu (N, P) and, when pairs exist, row frames (N, P, 3, 3)
        (identity on the ground rows), else None.  Ground rows measure
        their gap from z = 0 or, with ``terrain``, from the heightfield's
        bilinear height under the point.  With ``terrain`` and
        ``SimParams.terrain_normal_frames`` (engine.py:1317-1339,
        :1382-1390) the gap is measured along the surface normal n,
        ``(z - h) n_z - r``, and the ground rows get tangent frames about n
        (frames are then never None); on near-vertical cells n_z -> 0 and
        the gap reads about -r whatever the separation, as in the JAX
        engine (its default is off).  A scene with grabs and no
        candidate rows gets an empty row set (engine.py:1392-1398).
        ``friction_scale`` (N, 1) scales every row's mu, (N, nb) a ground
        row's by its body's and a pair row's by the mean of its two
        bodies' (engine.py:1341-1367); ``shape_scale`` (N, nb, 3) scales
        the geometry (:meth:`_contact_points`, :meth:`_pair_rows`)."""
        pr = self.params
        if not (self.n_ground or self.pairs):
            z = body_x.new_zeros((N, 0))
            return body_x.new_zeros((N, 0, 3)), z, z, None
        per_body = (friction_scale is not None
                    and friction_scale.shape[-1] == self.nb)
        ps, phis, mus, frames = [], [], [], None
        n_terr = None
        if self.n_ground:
            p = self._contact_points(body_x, body_q, shape_scale)  # (N, G, 3)
            ps.append(p)
            rad = self._ground_radii(shape_scale)
            if terrain is None:
                phis.append(p[..., 2] - rad)                     # flat z = 0
            elif pr.terrain_normal_frames:
                gz, n_terr = terrain.height_and_normal(p[..., 0], p[..., 1])
                phis.append((p[..., 2] - gz) * n_terr[..., 2] - rad)
            else:
                phis.append(p[..., 2] - rad
                            - terrain.height_at(p[..., 0], p[..., 1]))
            mu = (self.gnd_mu * pr.plane_friction).expand(N, -1)
            if friction_scale is not None:
                mu = mu * (friction_scale[:, self._gnd_body_t] if per_body
                           else friction_scale)
            mus.append(mu)
        if self.pairs:
            pp, pphi, pmu, pn = self._pair_rows(body_x, body_q, shape_scale)
            frame = self._tangent_frame(pn)                     # (N, K, 3, 3)
            ps.append(pp)
            phis.append(pphi)
            pmu = pmu.expand(N, -1)
            if friction_scale is not None:
                if per_body:
                    ra = self._row_a_t[self.n_ground:]
                    rb = self._row_b_t[self.n_ground:]
                    pmu = pmu * 0.5 * (friction_scale[:, ra]
                                       + friction_scale[:, rb])
                else:
                    pmu = pmu * friction_scale
            mus.append(pmu)
            if n_terr is None:
                eye = torch.eye(3, dtype=body_x.dtype, device=body_x.device)
                g_frames = eye.expand(N, self.n_ground, 3, 3)
            else:
                g_frames = self._tangent_frame(n_terr)
            frames = torch.cat([g_frames, frame], 1)
        elif n_terr is not None:
            frames = self._tangent_frame(n_terr)
        return (torch.cat(ps, 1), torch.cat(phis, 1), torch.cat(mus, 1),
                frames)

    def _normal_targets(self, phi):
        """Active mask and normal target velocity of rows with gaps ``phi``
        (engine.py:1398-1406): speculative rows (0 <= phi < margin) cap the
        approach speed at phi/h, penetrating rows push out by Baumgarte."""
        pr, h = self.params, self.h
        active = phi < pr.contact_margin
        b_n = -pr.baumgarte / h * torch.clamp(phi + pr.contact_slop, max=0.0)
        if pr.contact_margin > 0.0:
            b_n = torch.where(phi >= 0.0, -phi / h, b_n)
        return active, torch.clamp(b_n, max=pr.max_depenetration_velocity)

    def _restitution_rows(self, restitution, N):
        """Each candidate row's restitution (N, P) (engine.py:1407-1421):
        a per-body ``restitution`` (N, nb) takes the average of the row's
        two bodies, a ground row's body b being the plane
        (``SimParams.plane_restitution``); an (N, 1) one is every row's."""
        P = self.n_ground + self.n_pair_rows
        if restitution.shape[-1] != self.nb:
            return restitution.expand(N, P)
        ea = restitution[:, self._row_a_t]
        eb = torch.where(self._row_b_body_t, restitution[:, self._row_b_t],
                         self.params.plane_restitution)
        return 0.5 * (ea + eb)

    def _bounce_targets(self, b_n, e_rows, J_flat, qd, R):
        """The normal targets lifted to the restitution bounce: at least
        e (v_impact - bounce threshold) outward, v_impact = -(J qd) normal
        before the solve (engine.py:1570-1578)."""
        N = qd.shape[0]
        v_n_pre = torch.bmm(J_flat, qd[..., None])[..., 0].reshape(
            N, R, 3)[..., 2]
        return torch.maximum(b_n, e_rows * torch.clamp(
            -v_n_pre - self.params.bounce_threshold_velocity, min=0.0))

    def _contact_solve(self, qd, body_x, body_q, S, Hinv, qpos_dof, S_bl,
                       hinv_bl, ccache=None, qd_geom=None, grab_active=None,
                       terrain=None, friction_scale=None, shape_scale=None,
                       warm=None, *, lo_lim, hi_lim, restitution, route):
        """Projected-Jacobi impulse solve over grabs, attractors, ground
        rows, body-pair rows and joint limits, in that order in each
        iteration (engine.py:1248-1925).  With ``terrain`` the ground rows' gaps are taken
        from the heightfield (:meth:`_contact_rows`); B4 sees terrain only
        through those gaps, as the JAX kernel route does.  The per-env
        ``friction_scale`` and ``shape_scale`` of the domain randomization
        enter through the rows (:meth:`_contact_rows`): B4 takes them in its
        per-env ``mu`` and points.

        Grab rows (:meth:`_grab_rows`) are bilateral world-axis rows gated
        per env by ``grab_active``; they are rebuilt every substep, their
        impulses start at zero in every solve and enter neither ``imp_dof``
        nor the world impulses (engine.py:1897-1899).

        Rows are speculative (active at phi < contact_margin, approach speed
        capped at phi/h).  Pair rows carry tangent frames; when pairs exist
        the ground rows get identity frames, and every row is built already
        projected into its frame.  Rows, the H^-1 J products and the
        Delassus diagonals are built once here; the iteration loop is a
        Python loop of batched products, or kernel B4 through
        :func:`.contact_kernel.solve` with ``SimParams.use_contact_kernel``
        (engine.py:1708-1735; ``S_bl``/``hinv_bl`` are the batch-last
        inputs it takes).

        On the batched-product loop, ``SimParams.contact_capacity`` K keeps
        only the K deepest rows per env (active-set compaction,
        engine.py:1498-1557), selected before any Jacobian is built, ties to
        the lower row index as ``lax.top_k``; the impulses are scattered back
        to the candidate rows.  With ``SimParams.reuse_contact_rows`` the
        first substep returns its row set as a cache; given it as
        ``ccache``, a later substep reuses selection, Jacobians, Delassus
        diagonals, frames and friction, advances the gaps by
        ``h J qd_geom`` (``qd_geom``: the velocity the previous substep
        integrated with; on terrain the ground rows' points move by that
        velocity and their gaps are read from the heightfield again,
        engine.py:1607-1625) and, with ``contact_continuation``, seeds the loop
        from the cached impulses on still-active rows (engine.py:1582-1651,
        :1837-1842).  The B4 route takes neither option, as the JAX
        engine's kernel route does not (engine.py:1304-1305, :1524, :1558):
        it solves every candidate row from zero impulses in every substep
        and returns no row cache.

        ``lo_lim`` / ``hi_lim`` (nv,) or (N, nv): the joint limits, with the
        per-env shifts added, whose gaps B4 takes as inputs
        (engine.py:1425-1428).  ``restitution`` None, or (N, nb) or (N, 1):
        each row's coefficient
        (:meth:`_restitution_rows`) is gathered with the compaction and
        cached with the rows, and once J is built the normal target is
        lifted to the bounce (:meth:`_bounce_targets`), on a cached substep
        against the cached J (engine.py:1570-1578, :1632-1639).  Such a call
        takes the loop: ``route`` is :meth:`route_for`'s.

        ``warm`` (``SimParams.warm_start`` > 0): the previous substep's
        (lam_rows (N, P, 3), lam_lo, lam_hi) at the full candidate rows.
        The loop starts from ``warm_start`` times them on the rows (and
        limits) still active, gathered through the compaction's selection,
        with their velocity applied once up front (engine.py:1843-1856; a
        cached substep with ``contact_continuation`` seeds from the cache
        instead), and returns its own impulses scattered back to the
        candidate rows (engine.py:1911-1924).  With ``self.rows_bf16`` J,
        H^-1 J, H^-1 and the grab and attractor rows, and the vectors each
        loop product multiplies them with, are rounded to bfloat16
        (:func:`_bf16_round`, engine.py:1794-1817).  Returns (qd, world
        impulses (N, P, 3), contact points (N, P, 3), J^T lambda (N, nv),
        the row cache or None, the warm-start impulses or None)."""
        pr = self.params
        h = self.h
        N, nv = qd.shape[0], self.nv
        lo_gap = qpos_dof - lo_lim
        hi_gap = hi_lim - qpos_dof
        b_lo = -pr.baumgarte / h * torch.clamp(lo_gap, max=0.0)
        b_hi = -pr.baumgarte / h * torch.clamp(hi_gap, max=0.0)
        act_lo = self.dof_has_limit & (lo_gap < 0.0)
        act_hi = self.dof_has_limit & (hi_gap < 0.0)

        A = len(self.attractors)
        if A:
            # attractor rows (engine.py:1684-1706): world axes, no frames
            pa = torch.stack([
                body_x[:, a["body"]]
                + maths.quat_apply(body_q[:, a["body"]], a["offset"])
                for a in self.attractors], 1)                    # (N, A, 3)
            tgt = torch.stack([a["target"] for a in self.attractors])
            att_b = -pr.baumgarte / h * (pa - tgt)
            aJ = self._build_J_flat(S, pa, self.att_mask)       # (N, 3A, nv)
            aHJ = torch.bmm(aJ, Hinv)
            att_W = self._w_diag(aJ, aHJ, N, A)

        G = len(self.grabs)
        if G:
            g_pts, gJ, gHJ, g_W, g_b, g_act = self._grab_rows(
                body_x, body_q, S, Hinv, grab_active)

        rows = lambda: self._contact_rows(  # noqa: E731
            body_x, body_q, N, terrain, friction_scale, shape_scale)
        if route == "b4":
            p, phi, mu, frames = rows()
            active, b_n = self._normal_targets(phi)
            J_flat = self._build_J_flat(S, p, self.row_masks, frames)
            w_diag = self._w_diag(J_flat, torch.bmm(J_flat, Hinv), N,
                                  p.shape[1])
            groups = {}
            if A:
                groups.update(pts_a=pa, b_a=att_b, w_a=att_W)
            if G:
                groups.update(pts_g=g_pts, b_g=g_b, g_act=g_act, w_g=g_W)
            qd, lam, imp_dof = ck.solve(
                self.cplan, S_bl, hinv_bl, qd, p, b_n, mu, active.to(qd.dtype),
                frames, w_diag, b_lo, b_hi, act_lo.to(qd.dtype),
                act_hi.to(qd.dtype), **groups)
            return qd, self._to_world(lam, frames), p, imp_dof, None, None

        reuse_rows = pr.reuse_contact_rows and pr.substeps > 1
        if ccache is None:
            p, phi, mu, frames = rows()
            sel = None
            phi_r, p_r, mu_r, masks_r, frames_r = (phi, p, mu, self.row_masks,
                                                   frames)
            e_r = (None if restitution is None or not p.shape[1]
                   else self._restitution_rows(restitution, N))
            terr_r = None
            if reuse_rows and terrain is not None:
                # per row: its radius and whether it stands on the ground
                # (the rows the later substeps read the heightfield for)
                rad = self._ground_radii(shape_scale).expand(N, -1)
                terr_r = torch.cat([
                    torch.stack([rad, torch.ones_like(rad)], -1),
                    phi.new_zeros((N, self.n_pair_rows, 2))], 1)
            K = pr.contact_capacity
            if K is not None and p.shape[1] > K:
                # the K deepest rows per env; a stable ascending sort puts
                # equal gaps (resting faces) in row order, as top_k(-phi)
                sel = torch.sort(phi, dim=1, stable=True).indices[:, :K]
                env = torch.arange(N, device=qd.device)[:, None]
                phi_r, p_r, mu_r = phi[env, sel], p[env, sel], mu[env, sel]
                masks_r = self.row_masks[sel]                   # (N, K, nv)
                if frames is not None:
                    frames_r = frames[env, sel]
                if terr_r is not None:
                    terr_r = terr_r[env, sel]
                if e_r is not None:
                    e_r = e_r[env, sel]
            R = p_r.shape[1]
            active, b_n = self._normal_targets(phi_r)
            J_flat = self._build_J_flat(S, p_r, masks_r, frames_r)  # (N,3R,nv)
            HinvJ_flat = torch.bmm(J_flat, Hinv)
            w_diag = self._w_diag(J_flat, HinvJ_flat, N, R)
            if e_r is not None:
                b_n = self._bounce_targets(b_n, e_r, J_flat, qd, R)
            lam = torch.zeros((N, R, 3), dtype=qd.dtype, device=qd.device)
            lam_lo = torch.zeros_like(qd)
            lam_hi = torch.zeros_like(qd)
        else:
            cc = ccache
            sel, J_flat, HinvJ_flat, w_diag = (
                cc["sel"], cc["J_flat"], cc["HinvJ_flat"], cc["w_diag"])
            frames_r, mu_r, p = cc["frames_r"], cc["mu"], cc["p_full"]
            p_r, terr_r, e_r = cc["p_rows"], cc["terr_rows"], cc["e_rows"]
            R = w_diag.shape[1]
            # gaps advanced by the normal velocity through the cached rows
            v3 = torch.bmm(J_flat, qd_geom[..., None])[..., 0].reshape(
                N, R, 3)
            phi_r = cc["phi_rows"] + h * v3[..., 2]
            if terr_r is not None:
                # terrain rows: advance the points by the world velocity
                # and read the heightfield there; the vertical gap is
                # projected onto the row normal, whose z is 1 without
                # normal frames (engine.py:1607-1625)
                p_r = p_r + h * self._to_world(v3, frames_r)
                gz = terrain.height_at(p_r[..., 0], p_r[..., 1])
                nz = 1.0 if frames_r is None else frames_r[..., 2, 2]
                phi_g = (p_r[..., 2] - gz) * nz - terr_r[..., 0]
                phi_r = torch.where(terr_r[..., 1] > 0.5, phi_g, phi_r)
            active, b_n = self._normal_targets(phi_r)
            if e_r is not None:
                # against the cached J, before the seeds' velocity
                b_n = self._bounce_targets(b_n, e_r, J_flat, qd, R)
            if pr.contact_continuation:
                # seeded from the previous substep (their velocity is
                # applied below, with the loop's operands)
                lam = torch.where(active[..., None], cc["lam"], 0.0)
                lam_lo = torch.where(act_lo, cc["lam_lo"], 0.0)
                lam_hi = torch.where(act_hi, cc["lam_hi"], 0.0)
            else:
                lam = torch.zeros((N, R, 3), dtype=qd.dtype, device=qd.device)
                lam_lo = torch.zeros_like(qd)
                lam_hi = torch.zeros_like(qd)

        hinv_diag = torch.clamp(torch.diagonal(Hinv, dim1=-2, dim2=-1),
                                min=1e-8)
        # the loop's operands: bfloat16-rounded row matrices, and rb rounds
        # each vector they multiply (identities on float32 rows)
        rb = _bf16_round if self.rows_bf16 else (lambda t: t)
        Jr, HJr, Hinv_r = rb(J_flat), rb(HinvJ_flat), rb(Hinv)
        if G:
            gJ, gHJ = rb(gJ), rb(gHJ)
        if A:
            aJ, aHJ = rb(aJ), rb(aHJ)
        ws = float(pr.warm_start)
        if ccache is not None and pr.contact_continuation:
            # the continuation seeds' velocity, applied once before the loop
            qd = (qd + torch.bmm(rb(lam).reshape(N, 1, 3 * R), HJr)[:, 0]
                  + torch.bmm(Hinv_r, rb(lam_lo - lam_hi)[..., None])[..., 0])
        elif warm is not None and ws > 0.0:
            # warm start from the previous substep's impulses on the rows
            # and limits still active, their velocity applied the same way
            w_rows, w_lo, w_hi = warm
            if sel is not None:
                w_rows = w_rows[torch.arange(N, device=qd.device)[:, None],
                                sel]
            lam = torch.where(active[..., None], ws * w_rows, 0.0)
            lam_lo = torch.where(act_lo, ws * w_lo, 0.0)
            lam_hi = torch.where(act_hi, ws * w_hi, 0.0)
            qd = (qd + torch.bmm(rb(lam).reshape(N, 1, 3 * R), HJr)[:, 0]
                  + torch.bmm(Hinv_r, rb(lam_lo - lam_hi)[..., None])[..., 0])
        relax = pr.relaxation
        # with mass splitting the contact rows step by relax * row_scale;
        # the scale is taken in every solve from that solve's active set,
        # on a cached substep too, where the JAX engine takes it
        # (engine.py:1746-1782, after both the fresh and the cached branch)
        rs = (relax * self.mass_split_scale(active, sel, frames_r)
              if pr.mass_splitting and R > 0 else relax)
        for _ in range(pr.num_iterations):
            if G:
                v_g = torch.bmm(gJ, rb(qd)[..., None])[..., 0].reshape(N, G, 3)
                dl_g = relax * (g_b - v_g) / g_W * g_act[..., None]
                qd = qd + torch.bmm(rb(dl_g).reshape(N, 1, 3 * G), gHJ)[:, 0]
            if A:
                v_a = torch.bmm(aJ, rb(qd)[..., None])[..., 0].reshape(N, A, 3)
                dl_a = relax * (att_b - v_a) / att_W
                qd = qd + torch.bmm(rb(dl_a).reshape(N, 1, 3 * A), aHJ)[:, 0]
            # row-frame velocities; normal rows, then the friction box
            # against the new normal
            v_c = torch.bmm(Jr, rb(qd)[..., None])[..., 0].reshape(N, R, 3)
            dv_n = b_n - v_c[..., 2]
            lam_n = torch.clamp(lam[..., 2] + rs * dv_n / w_diag[..., 2],
                                min=0.0)
            lam_n = torch.where(active, lam_n, 0.0)
            max_f = mu_r * lam_n
            lam_t1 = torch.clamp(
                lam[..., 0] + rs * (-v_c[..., 0]) / w_diag[..., 0],
                -max_f, max_f)
            lam_t2 = torch.clamp(
                lam[..., 1] + rs * (-v_c[..., 1]) / w_diag[..., 1],
                -max_f, max_f)
            lam_new = torch.stack([lam_t1, lam_t2, lam_n], dim=-1)
            lam_new = torch.where(active[..., None], lam_new, 0.0)
            dlam = lam_new - lam
            qd2 = qd + torch.bmm(rb(dlam).reshape(N, 1, 3 * R), HJr)[:, 0]
            # joint limits (J = e_i): lower pushes +, upper pushes -
            lam_lo_new = torch.where(act_lo, torch.clamp(
                lam_lo + relax * (b_lo - qd2) / hinv_diag, min=0.0), 0.0)
            lam_hi_new = torch.where(act_hi, torch.clamp(
                lam_hi + relax * (b_hi + qd2) / hinv_diag, min=0.0), 0.0)
            dlim = (lam_lo_new - lam_lo) - (lam_hi_new - lam_hi)
            qd = qd2 + torch.bmm(Hinv_r, rb(dlim)[..., None])[..., 0]
            lam, lam_lo, lam_hi = lam_new, lam_lo_new, lam_hi_new
        imp_dof = (torch.bmm(rb(lam).reshape(N, 1, 3 * R), Jr)[:, 0]
                   + (lam_lo - lam_hi))
        lam_w = self._to_world(lam, frames_r)
        ccache_out = None
        if reuse_rows:
            ccache_out = (dict(ccache) if ccache is not None else dict(
                sel=sel, J_flat=J_flat, HinvJ_flat=HinvJ_flat, w_diag=w_diag,
                frames_r=frames_r, mu=mu_r, p_full=p, terr_rows=terr_r,
                e_rows=e_r))
            ccache_out.update(p_rows=p_r, phi_rows=phi_r, lam=lam,
                              lam_lo=lam_lo, lam_hi=lam_hi)
        if sel is not None:
            # compacted impulses back to their candidate rows
            idx3 = sel[..., None].expand(-1, -1, 3)
            lam_w = torch.zeros_like(p).scatter(1, idx3, lam_w)
            lam = torch.zeros_like(p).scatter(1, idx3, lam)
        warm_out = ((lam, lam_lo, lam_hi) if warm is not None and ws > 0.0
                    else None)
        return qd, lam_w, p, imp_dof, ccache_out, warm_out

    def mass_split_scale(self, active, sel, frames):
        """Each row's step scale under mass splitting (engine.py:1739-1782):
        1 / max(n_r, 1) (N, R), where n_r = sum_b oh_rb n_r^T C_b n_r and
        C_b = sum_r' active_r' oh_r'b n_r' n_r'^T sums the outer products
        of the normals of the active rows that push movable body b: R
        coincident rows get 1 / R, orthogonal rows do not throttle each
        other.  ``sel`` (N, R) the compaction's row indices or None,
        ``frames`` (N, R, 3, 3) the row frames (normal: column 2) or None
        (normals +z)."""
        N, R = active.shape
        oh = (self.row_body_oh[sel] if sel is not None
              else self.row_body_oh.expand(N, R, self.nb))      # (N, R, nb)
        if frames is not None:
            n_w = frames[..., :, 2]                             # (N, R, 3)
        else:
            n_w = self._ez.expand(N, R, 3)
        nn = (n_w[..., :, None] * n_w[..., None, :]).reshape(N, R, 9)
        counts = torch.bmm((active.to(nn.dtype)[..., None] * oh
                            ).transpose(1, 2), nn)              # (N, nb, 9)
        n_r = torch.sum(oh * torch.bmm(nn, counts.transpose(1, 2)), -1)
        return 1.0 / torch.clamp(n_r, min=1.0)

    @staticmethod
    def _to_world(lam, frames):
        """Row-frame impulses (N, P, 3) -> world (engine.py:1828-1834)."""
        if frames is None:
            return lam
        return (frames[..., :, 0] * lam[..., 0, None]
                + frames[..., :, 1] * lam[..., 1, None]
                + frames[..., :, 2] * lam[..., 2, None])

    def _integrate(self, q, qd):
        """Semi-implicit Euler; free-joint quaternions by the exponential
        map (engine.py:1961-1981)."""
        h = self.h
        segs = []
        up = self._ez
        for b in range(self.nb):
            t = int(self.jnt_type_np[b])
            qa, va = int(self.q_adr[b]), int(self.v_adr[b])
            if t == md.FREE:
                pos = q[:, qa: qa + 3] + h * qd[:, va: va + 3]
                quat = q[:, qa + 3: qa + 7]
                w = qd[:, va + 3: va + 6]
                wn = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
                angle = wn[..., 0] * h
                axis = torch.where(wn > 1e-9, w / torch.clamp(wn, min=1e-9), up)
                dq = maths.quat_from_angle_axis(angle, axis)
                segs.append(pos)
                segs.append(maths.normalize(maths.quat_mul(dq, quat)))
            elif t in (md.HINGE, md.SLIDE, md.SCREW):
                segs.append(q[:, qa: qa + 1] + h * qd[:, va: va + 1])
        return torch.cat(segs, dim=-1) if segs else q

    # ------------------------------------------------------------------
    # full control step
    def step(self, state: SimState, ctrl: Control, terrain=None, phys=None):
        """Advance one control step (= ``substeps`` physics substeps) with
        actuation held across substeps (engine.py:1985-2021)."""
        q, qd = state.q, state.qd
        impulse_accum = None
        imp_dof_accum = torch.zeros_like(qd)
        cache = None
        aux = None
        ccache = None
        # warm-start impulses carry across substeps and steps
        # (engine.py:1998-2021)
        warm = state.lam if self.params.warm_start > 0 else None
        for _ in range(self.params.substeps):
            q, qd, aux = self.substep(q, qd, ctrl, terrain, phys,
                                      dyn_cache=cache, contact_cache=ccache,
                                      warm=warm)
            if self.params.reuse_mass_matrix:
                cache = aux[6]
            if self.params.reuse_contact_rows:
                ccache = aux[7]
            if aux[8] is not None:
                warm = aux[8]
            if aux[3] is not None:
                impulse_accum = (aux[3] if impulse_accum is None
                                 else impulse_accum + aux[3])
            imp_dof_accum = imp_dof_accum + aux[5]
        qdd, p_w = aux[2], aux[4]
        # refresh kinematic outputs at the new state (kernel B1)
        body_x, body_q, S, _ = self.kinematics(q)
        V = self.body_velocities(S, qd)
        dof_force = ctrl.tau + imp_dof_accum / self.params.dt
        out = self._outputs(body_x, body_q, V, qdd, impulse_accum, p_w,
                            dof_force)
        lam = warm if self.params.warm_start > 0 else state.lam
        return SimState(q, qd, lam), out

    def _outputs(self, body_x, body_q, V, qdd, impulses, p_w, dof_force):
        """Readouts incl. net contact forces (+f on a row's body a, -f on its
        body b) and force sensors with the wrenches of both ends
        (engine.py:2023-2080; Ant's obs[28:52], BallBalance's tray
        sensors).  A scene without contact rows reads zeros."""
        w = V[..., 0:3]
        v_lin = V[..., 3:6] + _cross(w, body_x)
        N = body_x.shape[0]
        if impulses is None:        # no contact rows: zero rows to sum
            impulses = p_w = body_x.new_zeros((N, 0, 3))
        force_rows = impulses / self.params.dt                  # world frame
        contact_force = torch.einsum("npk,pb->nbk", force_rows, self.seg)
        if len(self.sensor_body):
            # wrench about each sensor point, rotated into the body frame
            xa = body_x[:, self._row_a_t]
            xb = body_x[:, self._row_b_t]
            tq_a = _cross(p_w - xa, force_rows)
            tq_b = _cross(p_w - xb, force_rows)
            f_b = (torch.einsum("npk,ps->nsk", force_rows, self.sens_a)
                   - torch.einsum("npk,ps->nsk", force_rows, self.sens_b))
            n_o = (torch.einsum("npk,ps->nsk", tq_a, self.sens_a)
                   - torch.einsum("npk,ps->nsk", tq_b, self.sens_b))
            qs = body_q[:, self._sensor_body_t]
            r_s = maths.quat_apply(qs, self.sensor_pos)
            n_b = n_o - _cross(r_s, f_b)
            sensor_forces = torch.cat([maths.quat_rotate_inverse(qs, f_b),
                                       maths.quat_rotate_inverse(qs, n_b)], -1)
        else:
            sensor_forces = torch.zeros((N, 0, 6), dtype=DTYPE,
                                        device=body_x.device)
        return SimOutput(
            body_pos=body_x, body_quat=body_q,
            body_vel=torch.cat([v_lin, w], dim=-1),
            root_states=self._root_states(body_x, body_q, v_lin, w),
            contact_force=contact_force, sensor_forces=sensor_forces,
            qdd=qdd, dof_force=dof_force)

    def _root_states(self, body_x, body_q, v_lin, w):
        rb = self._root_body_t
        return torch.cat([body_x[:, rb], body_q[:, rb], v_lin[:, rb],
                          w[:, rb]], dim=-1)

    def dynamics_readout(self, state: SimState):
        """Mass matrix and kinematics for task-level controllers
        (engine.py:2082-2094; OSC): (M (N, nv, nv), body_x, body_q, S, V).
        Kinematics through kernel B1; the mass matrix in plain PyTorch, as
        the JAX package computes it outside any Pallas kernel."""
        body_x, body_q, S, _ = self.kinematics(state.q)
        V = self.body_velocities(S, state.qd)
        I_O, _ = self.spatial_inertia(body_x, body_q)
        return self.mass_matrix(S, I_O), body_x, body_q, S, V

    def point_jacobian(self, S, body_x, body: int, point=None):
        """Jacobian rows [lin(3), ang(3)] per dof of a point on ``body``
        (engine.py:2096-2107): (N, nv, 6), zero on the dofs that do not move
        the body.  ``point``: world point (default: the body origin)."""
        p = body_x[:, body] if point is None else point
        S_ang, S_lin = S[..., 0:3], S[..., 3:6]
        J_lin = S_lin + _cross(S_ang, p[:, None, :])
        mask = self.dof_body_mask_f[:, body][None, :, None]
        return torch.cat([J_lin, S_ang], dim=-1) * mask

    def forward(self, state: SimState,
                prev_out: Optional[SimOutput] = None) -> SimOutput:
        """Kinematics-only readout refresh (engine.py:2109-2138); contact
        and sensor readouts carry over from ``prev_out``."""
        q, qd = state.q, state.qd
        body_x, body_q, S, _ = self.kinematics(q)
        V = self.body_velocities(S, qd)
        N = q.shape[0]
        w = V[..., 0:3]
        v_lin = V[..., 3:6] + _cross(w, body_x)
        kw = dict(dtype=q.dtype, device=q.device)
        return SimOutput(
            body_pos=body_x, body_quat=body_q,
            body_vel=torch.cat([v_lin, w], dim=-1),
            root_states=self._root_states(body_x, body_q, v_lin, w),
            contact_force=(prev_out.contact_force if prev_out is not None
                           else torch.zeros((N, self.nb, 3), **kw)),
            sensor_forces=(prev_out.sensor_forces if prev_out is not None
                           else torch.zeros((N, len(self.sensor_body), 6),
                                            **kw)),
            qdd=(prev_out.qdd if prev_out is not None
                 else torch.zeros((N, self.nv), **kw)),
            dof_force=(prev_out.dof_force if prev_out is not None
                       else torch.zeros((N, self.nv), **kw)))

    # ------------------------------------------------------------------
    # state helpers (the set_*_tensor family)
    def default_state(self, num_envs: int) -> SimState:
        q0 = torch.as_tensor(md.default_qpos(self.model).astype(np.float32),
                             device=self.device)
        q = q0[None].repeat(num_envs, 1)
        qd = torch.zeros((num_envs, self.nv), dtype=DTYPE, device=self.device)
        return SimState(q, qd, self.zero_warm(num_envs))

    def zero_warm(self, num_envs: int):
        """Cold-start warm-start impulses (``SimState.lam``,
        engine.py:2147-2156): zeros (rows (N, P, 3), lam_lo, lam_hi (N, nv))
        with ``SimParams.warm_start`` on a scene with contact rows, else
        None."""
        n_rows = self.n_ground + self.n_pair_rows
        if self.params.warm_start <= 0 or n_rows == 0:
            return None
        z = lambda *s: torch.zeros(s, dtype=DTYPE,  # noqa: E731
                                   device=self.device)
        return (z(num_envs, n_rows, 3), z(num_envs, self.nv),
                z(num_envs, self.nv))

    def dof_pos(self, state: SimState):
        """Scalar-dof positions (N, n_scalar_dofs)."""
        return state.q[:, self._scalar_qids_t]

    def dof_vel(self, state: SimState):
        return state.qd[:, self.scalar_dofs_t]

    def set_dof_pos(self, state: SimState, pos):
        q = state.q.clone()
        q[:, self._scalar_qids_t] = pos
        return state._replace(q=q)

    def set_dof_vel(self, state: SimState, vel):
        qd = state.qd.clone()
        qd[:, self.scalar_dofs_t] = vel
        return state._replace(qd=qd)


def _ground_reachable(m, pts_body, pts_off, pts_rad) -> np.ndarray:
    """Static reachability of the ground plane per candidate point
    (numpy port of engine.py:1116-1217): candidates on fixed-base trees that
    provably never reach z = 0 are pruned; floating trees always reach."""
    parent = np.asarray(m.parent)
    jnt = np.asarray(m.jnt_type)
    body_pos = np.asarray(m.body_pos, np.float64)
    body_quat = np.asarray(m.body_quat, np.float64)
    jnt_pos = np.asarray(m.jnt_pos, np.float64)
    v_adr = np.asarray(m.v_adr)
    lo = np.asarray(m.dof_lower, np.float64)
    hi = np.asarray(m.dof_upper, np.float64)
    has_lim = np.asarray(m.dof_has_limit, bool)

    def joint_trans(link):
        t = int(jnt[link])
        d = 0.0
        if t in (md.HINGE, md.SCREW):
            d += 2.0 * float(np.linalg.norm(jnt_pos[link]))
        if t in (md.SLIDE, md.SCREW):
            v = int(v_adr[link])
            if not has_lim[v]:
                return None
            d += max(abs(lo[v]), abs(hi[v]))
        return d

    min_z = np.full(m.nb, -np.inf)
    for b in range(m.nb):
        path = []
        a = b
        while a != -1:
            path.append(a)
            a = int(parent[a])
        path.reverse()
        pos = np.zeros(3)
        R = np.eye(3)
        i = 0
        while i < len(path) and jnt[path[i]] == md.FIXED:
            link = path[i]
            pos = pos + R @ body_pos[link]
            R = R @ md._quat_to_mat_np(body_quat[link])
            i += 1
        if i == len(path):
            min_z[b] = float(pos[2])
            continue
        L = path[i]
        if jnt[L] == md.FREE:
            continue
        anchor = pos + R @ body_pos[L] + \
            R @ md._quat_to_mat_np(body_quat[L]) @ jnt_pos[L]
        bound = float(anchor[2]) - float(np.linalg.norm(jnt_pos[L]))
        ok = True
        if jnt[L] in (md.SLIDE, md.SCREW):
            v = int(v_adr[L])
            if not has_lim[v]:
                ok = False
            else:
                bound -= max(abs(lo[v]), abs(hi[v]))
        for link in (path[i + 1:] if ok else ()):
            if jnt[link] == md.FREE:
                ok = False
                break
            d = joint_trans(link)
            if d is None:
                ok = False
                break
            bound -= float(np.linalg.norm(body_pos[link])) + d
        if ok:
            min_z[b] = bound
    pt_term = 2.0 * (np.linalg.norm(np.asarray(pts_off, np.float64), axis=-1)
                     + np.asarray(pts_rad, np.float64))
    return min_z[pts_body] - pt_term - 0.1 <= 0.0
