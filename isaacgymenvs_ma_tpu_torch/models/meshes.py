"""Procedural triangle meshes for SDF baking (copy of
isaacgymenvs_ma_tpu/models/meshes.py for the PyTorch port, which imports
nothing of the JAX package).  Numpy only.

The reference ships Factory/IndustReal part meshes as OBJ assets and collides
them with PhysX SDF collisions (docs/factory.md §Collisions); we generate the
part geometry procedurally (watertight, parameterized) and bake it with the
native voxelizer (native/sdf_voxelize.cpp) into :class:`~..physics.sdf_grid.
SDFGrid`s.  All generators return (verts (V, 3) f32, tris (T, 3) i32),
z being the symmetry axis.
"""
from __future__ import annotations

import numpy as np


def _ring(radius: float, z: float, n: int, phase: float = 0.0):
    a = np.arange(n) * (2 * np.pi / n) + phase
    return np.stack([radius * np.cos(a), radius * np.sin(a),
                     np.full(n, z)], -1)


def _stitch(a0: int, b0: int, n: int, flip: bool = False):
    """Triangles between two rings of n verts starting at indices a0/b0."""
    tris = []
    for j in range(n):
        j1 = (j + 1) % n
        if flip:
            tris.append((a0 + j, b0 + j1, b0 + j))
            tris.append((a0 + j, a0 + j1, b0 + j1))
        else:
            tris.append((a0 + j, b0 + j, b0 + j1))
            tris.append((a0 + j, b0 + j1, a0 + j1))
    return tris


def _fan(center: int, ring0: int, n: int, flip: bool = False):
    tris = []
    for j in range(n):
        j1 = (j + 1) % n
        if flip:
            tris.append((center, ring0 + j1, ring0 + j))
        else:
            tris.append((center, ring0 + j, ring0 + j1))
    return tris


def box_mesh(half_extents):
    hx, hy, hz = np.asarray(half_extents, np.float64)
    v = np.array([[sx * hx, sy * hy, sz * hz]
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                 np.float32)
    # 12 triangles, outward-facing
    t = np.array([
        [0, 1, 3], [0, 3, 2],   # -x
        [4, 6, 7], [4, 7, 5],   # +x
        [0, 4, 5], [0, 5, 1],   # -y
        [2, 3, 7], [2, 7, 6],   # +y
        [0, 2, 6], [0, 6, 4],   # -z
        [1, 5, 7], [1, 7, 3],   # +z
    ], np.int32)
    return v, t


def cylinder_mesh(radius: float, half_height: float, n: int = 48):
    bot = _ring(radius, -half_height, n)
    top = _ring(radius, half_height, n)
    verts = [bot, top, np.array([[0, 0, -half_height]], np.float64),
             np.array([[0, 0, half_height]], np.float64)]
    v = np.concatenate(verts).astype(np.float32)
    # wall needs flip=True for an OUTWARD orientation consistent with the
    # caps (regression: the unflipped wall made the voxelizer's winding sign
    # read the whole interior as outside — tests/test_sdf_contacts.py pins
    # interior signs for every generator)
    tris = _stitch(0, n, n, flip=True)
    tris += _fan(2 * n, 0, n, flip=True)       # bottom cap (faces -z)
    tris += _fan(2 * n + 1, n, n)              # top cap (faces +z)
    return v, np.asarray(tris, np.int32)


def tube_mesh(r_outer: float, r_inner: float, half_height: float,
              n: int = 48):
    """Annular tube (nut blank / hole plate), watertight."""
    ob = _ring(r_outer, -half_height, n)
    ot = _ring(r_outer, half_height, n)
    ib = _ring(r_inner, -half_height, n)
    it_ = _ring(r_inner, half_height, n)
    v = np.concatenate([ob, ot, ib, it_]).astype(np.float32)
    tris = _stitch(0, n, n)                    # outer wall
    tris += _stitch(2 * n, 3 * n, n, flip=True)  # inner wall (faces inward)
    tris += _stitch(2 * n, 0, n)               # bottom annulus (faces -z)
    tris += _stitch(n, 3 * n, n)               # top annulus (faces +z)
    return v, np.asarray(tris, np.int32)


def threaded_rod_mesh(major_radius: float, minor_radius: float,
                      half_height: float, pitch: float, n_seg: int = 48,
                      segs_per_turn: int = 48):
    """Externally threaded rod (bolt shank): the surface radius oscillates
    between minor and major along a helical phase — a single-start
    triangular thread profile, watertight with end caps."""
    turns = 2.0 * half_height / pitch
    rows = max(int(turns * segs_per_turn), 4)
    zs = np.linspace(-half_height, half_height, rows)
    rings = []
    for z in zs:
        a = np.arange(n_seg) * (2 * np.pi / n_seg)
        # helical phase: thread crest where (theta - 2 pi z / pitch) = 0
        phase = a - 2 * np.pi * z / pitch
        tri_wave = 2.0 * np.abs(((phase / (2 * np.pi)) % 1.0) - 0.5)  # 0..1
        r = minor_radius + (major_radius - minor_radius) * tri_wave
        rings.append(np.stack([r * np.cos(a), r * np.sin(a),
                               np.full(n_seg, z)], -1))
    v = [np.concatenate(rings)]
    tris = []
    for i in range(rows - 1):
        tris += _stitch(i * n_seg, (i + 1) * n_seg, n_seg)
    base = rows * n_seg
    v.append(np.array([[0, 0, -half_height], [0, 0, half_height]]))
    tris += _fan(base, 0, n_seg, flip=True)
    tris += _fan(base + 1, (rows - 1) * n_seg, n_seg)
    return np.concatenate(v).astype(np.float32), np.asarray(tris, np.int32)


def box_with_hole_mesh(half_xy, half_height: float, hole_radius: float,
                       n: int = 64):
    """Rectangular block with a cylindrical through-hole along z (the
    IndustReal socket solid), watertight.  The outer perimeter is sampled at
    the same n angles as the hole circle so walls and annuli stitch."""
    hx, hy = float(half_xy[0]), float(half_xy[1])
    a = np.arange(n) * (2 * np.pi / n) + np.pi / n  # avoid corner-exact rays
    ca, sa = np.cos(a), np.sin(a)
    # square-perimeter point at angle a: scale direction to the box edge
    scale = np.minimum(hx / np.maximum(np.abs(ca), 1e-9),
                       hy / np.maximum(np.abs(sa), 1e-9))
    sq = np.stack([scale * ca, scale * sa], -1)
    circ = hole_radius * np.stack([ca, sa], -1)

    def ring(xy, z):
        return np.concatenate([xy, np.full((n, 1), z)], -1)

    sb = ring(sq, -half_height)    # 0: outer bottom
    st = ring(sq, half_height)     # n: outer top
    cb = ring(circ, -half_height)  # 2n: hole bottom
    ct = ring(circ, half_height)   # 3n: hole top
    v = np.concatenate([sb, st, cb, ct]).astype(np.float32)
    tris = _stitch(0, n, n)                      # outer wall
    tris += _stitch(2 * n, 3 * n, n, flip=True)  # hole wall (faces inward)
    tris += _stitch(2 * n, 0, n)                 # bottom annulus (-z)
    tris += _stitch(n, 3 * n, n)                 # top annulus (+z)
    return v, np.asarray(tris, np.int32)


def hex_nut_mesh(width_flats: float, height: float, hole_radius: float):
    """Hex nut solid (M-series: hexagonal prism with a through-bore), the
    mesh-accurate replacement for the box nut proxy (reference nut OBJ assets,
    docs/factory.md §Collisions and Contacts).  The bore is a hexagonal prism
    CIRCUMSCRIBED about ``hole_radius`` (flats at hole_radius, corners at
    hole_radius/cos(30°)) so the solid clears a shank of that radius — an
    inscribed bore put the flats at 0.866*hole_radius, geometrically
    interpenetrating the bolt (same 6-angle sampling as the outer wall so
    the annuli stitch watertight)."""
    circum = width_flats / np.sqrt(3.0)     # across-flats -> across-corners/2
    bore_circum = hole_radius / np.cos(np.pi / 6.0)
    v, t = tube_mesh(circum, bore_circum, height / 2.0, n=6)
    return v, t


def hex_nut_contact_points(width_flats: float, height: float,
                           hole_radius: float) -> np.ndarray:
    """Structured contact-candidate cloud for a hex nut: outer corners and
    flat midpoints on both faces (table/ground resting, pad gripping) plus
    bore-rim corners on both faces (riding a bolt shank)."""
    circum = width_flats / np.sqrt(3.0)
    hh = height / 2.0
    pts = []
    for z in (-hh, hh):
        pts.append(_ring(circum, z, 6))                      # outer corners
        pts.append(_ring(width_flats / 2.0, z, 6, np.pi / 6))  # flat midpoints
        # bore flat midpoints: the circumscribed bore's closest approach to
        # the shank is the flats (radius hole_radius, phase pi/6 off the
        # corner-aligned tube_mesh rings)
        pts.append(_ring(hole_radius, z, 6, np.pi / 6))
    return np.concatenate(pts).astype(np.float32)


def bolt_mesh_parts(head_width_flats: float, head_height: float,
                    shank_radius: float, shank_length: float, n: int = 24):
    """Bolt as two clean watertight solids for CSG-union baking
    (``ModelBuilder.add_sdf_geom(..., union_with=...)``): hex head on z=0 and
    a round shank reaching half-way into it."""
    hv, ht = cylinder_mesh(head_width_flats / np.sqrt(3.0),
                           head_height / 2.0, n=6)
    hv = hv + np.array([0, 0, head_height / 2.0], np.float32)
    s_lo = head_height * 0.5
    s_hh = (head_height * 0.5 + shank_length) / 2.0
    sv, st = cylinder_mesh(shank_radius, s_hh, n=n)
    sv = sv + np.array([0, 0, s_lo + s_hh], np.float32)
    return [(hv, ht), (sv, st)]


def bolt_mesh(head_width_flats: float, head_height: float,
              shank_radius: float, shank_length: float, n: int = 24):
    """Single concatenated bolt mesh (visualization / sampling only).  For
    SDF baking use ``bolt_mesh_parts`` + ``union_with`` — a concatenated
    union mesh has interior-interface triangles that cap |SDF| near the
    head/shank seam."""
    (hv, ht), (sv, st) = bolt_mesh_parts(head_width_flats, head_height,
                                         shank_radius, shank_length, n)
    v = np.concatenate([hv, sv]).astype(np.float32)
    t = np.concatenate([ht, st + len(hv)]).astype(np.int32)
    return v, t


def cylinder_contact_points(radius: float, half_height: float,
                            n_ring: int = 8, n_rows: int = 2) -> np.ndarray:
    """Structured cloud for a round peg: rim rings at both ends (+ optional
    intermediate rows) and the two axis endpoints."""
    zs = np.linspace(-half_height, half_height, max(n_rows, 2))
    pts = [_ring(radius, z, n_ring) for z in zs]
    pts.append(np.array([[0, 0, -half_height], [0, 0, half_height]]))
    return np.concatenate(pts).astype(np.float32)


def tube_contact_points(r_outer: float, r_inner: float, half_height: float,
                        n_ring: int = 8) -> np.ndarray:
    """Structured cloud for an annular part (gear blank): outer and bore rims
    on both faces."""
    pts = []
    for z in (-half_height, half_height):
        pts.append(_ring(r_outer, z, n_ring))
        pts.append(_ring(r_inner, z, n_ring))
    return np.concatenate(pts).astype(np.float32)


def uv_sphere_mesh(radius: float, nu: int = 32, nv: int = 16):
    vs = []
    for i in range(nv + 1):
        th = np.pi * i / nv
        for j in range(nu):
            ph = 2 * np.pi * j / nu
            vs.append((radius * np.sin(th) * np.cos(ph),
                       radius * np.sin(th) * np.sin(ph),
                       radius * np.cos(th)))
    tris = []
    for i in range(nv):
        for j in range(nu):
            a = i * nu + j
            b = i * nu + (j + 1) % nu
            c = (i + 1) * nu + j
            d = (i + 1) * nu + (j + 1) % nu
            tris.append((a, b, d))
            tris.append((a, d, c))
    return np.asarray(vs, np.float32), np.asarray(tris, np.int32)


def surface_sample(verts: np.ndarray, tris: np.ndarray, n: int,
                   seed: int = 0) -> np.ndarray:
    """n area-weighted surface points — contact-candidate clouds for
    mesh-shaped bodies (engine candidate points vs an SDF target)."""
    rng = np.random.default_rng(seed)
    a = verts[tris[:, 0]].astype(np.float64)
    b = verts[tris[:, 1]].astype(np.float64)
    c = verts[tris[:, 2]].astype(np.float64)
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
    idx = rng.choice(len(tris), n, p=area / area.sum())
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    return (a[idx] + u * (b[idx] - a[idx])
            + v * (c[idx] - a[idx])).astype(np.float32)
