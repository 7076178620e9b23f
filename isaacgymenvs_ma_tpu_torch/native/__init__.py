"""The mesh voxelizer (native/sdf_voxelize.cpp) and its loader: the port's
counterpart of isaacgymenvs_ma_tpu/native/__init__.py.

The C++ source is built with ``g++ -O3 -march=native -shared -fPIC
-fopenmp`` (the JAX loader's flags, so that both packages bake the same
grids bit for bit on one machine) into ``build/native/<hash>/`` next to the
package (a directory git ignores), keyed by a hash of the source and the
flags, and loaded through ctypes.  A missing compiler or a failed build
raises: a grid from another implementation is another collision field, so
there is no fallback.  :func:`signed_distance_np` is the plain numpy
version of the same algorithm, the twin tests hold the library against.

Baked grids are cached under ``build/native/grids/``, keyed on the exact
inputs as the JAX package keys its own cache.  Nothing here runs in the
step: the grids become device tensors once, at engine build
(physics/sdf_grid.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "sdf_voxelize.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")
_LIB: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_ROOT / f"sdf_voxelize-{h.hexdigest()[:16]}" / \
        "libsdf_voxelize.so"


def build() -> Path:
    """Compile the voxelizer where not yet built; its path.  Raises with
    the compiler's output when ``g++`` is missing or fails."""
    so = lib_path()
    if so.is_file():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the SDF voxelizer "
                           "cannot be built")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name} (rc "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)       # atomic: a reader never sees a partial file
    return so


def load() -> ctypes.CDLL:
    """The loaded voxelizer, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.sdf_voxelize.argtypes = [f32p, ctypes.c_int32, i32p,
                                     ctypes.c_int32, f32p, f32p, i32p, f32p]
        lib.sdf_voxelize.restype = None
        lib.sdf_query_points.argtypes = [f32p, ctypes.c_int32, i32p,
                                         ctypes.c_int32, f32p,
                                         ctypes.c_int32, f32p]
        lib.sdf_query_points.restype = None
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(ctypes.POINTER(kind))


# ---------------------------------------------------------------------------
# the plain numpy twin (the same algorithms, vectorized over triangles)
def _point_tri_dist_np(p, a, b, c):
    """p (3,), a/b/c (T, 3) -> distances (T,).  Ericson 5.1.5, vectorized."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    eps = 1e-30
    v_edge_ab = d1 / np.maximum(d1 - d3, eps)
    w_edge_ac = d2 / np.maximum(d2 - d6, eps)
    w_edge_bc = (d4 - d3) / np.maximum((d4 - d3) + (d5 - d6), eps)
    denom = 1.0 / np.maximum(va + vb + vc, eps)
    v_in = vb * denom
    w_in = vc * denom

    q = a + v_in[:, None] * ab + w_in[:, None] * ac  # interior default
    q = np.where((va <= 0)[:, None] & ((d4 - d3) >= 0)[:, None]
                 & ((d5 - d6) >= 0)[:, None],
                 b + w_edge_bc[:, None] * (c - b), q)
    q = np.where((vb <= 0)[:, None] & (d2 >= 0)[:, None] & (d6 <= 0)[:, None],
                 a + w_edge_ac[:, None] * ac, q)
    q = np.where((vc <= 0)[:, None] & (d1 >= 0)[:, None] & (d3 <= 0)[:, None],
                 a + v_edge_ab[:, None] * ab, q)
    q = np.where(((d6 >= 0) & (d5 <= d6))[:, None], c, q)
    q = np.where(((d3 >= 0) & (d4 <= d3))[:, None], b, q)
    q = np.where(((d1 <= 0) & (d2 <= 0))[:, None], a, q)
    d = p - q
    return np.sqrt((d * d).sum(-1))


def signed_distance_np(verts, tris, pts):
    """Signed distances (P,) of pts (P, 3) to a mesh: the nearest
    triangle's distance, negative where the winding number says inside."""
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64)
    pts = np.asarray(pts, np.float64)
    a = verts[tris[:, 0]]
    b = verts[tris[:, 1]]
    c = verts[tris[:, 2]]
    out = np.empty(len(pts), np.float32)
    for i, p in enumerate(pts):
        d = _point_tri_dist_np(p, a, b, c).min()
        va, vb_, vc_ = a - p, b - p, c - p
        la = np.linalg.norm(va, axis=-1)
        lb = np.linalg.norm(vb_, axis=-1)
        lc = np.linalg.norm(vc_, axis=-1)
        numer = (va * np.cross(vb_, vc_)).sum(-1)
        denom = (la * lb * lc + (va * vb_).sum(-1) * lc
                 + (va * vc_).sum(-1) * lb + (vb_ * vc_).sum(-1) * la)
        wind = 2.0 * np.arctan2(numer, denom)
        out[i] = -d if abs(wind.sum()) > 2.0 * np.pi else d
    return out


# ---------------------------------------------------------------------------
# public API
def voxelize_mesh(verts: np.ndarray, tris: np.ndarray, origin, spacing,
                  dims) -> np.ndarray:
    """Signed-distance voxel grid of a triangle mesh through the C++
    library: verts (V, 3), tris (T, 3); voxel center (i, j, k) at origin +
    spacing * (i, j, k); returns (dims[0], dims[1], dims[2]) f32."""
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    origin = np.ascontiguousarray(origin, np.float32)
    spacing = np.ascontiguousarray(spacing, np.float32)
    dims = np.ascontiguousarray(dims, np.int32)
    shape = tuple(int(x) for x in dims)
    # the JAX package's cache key (native/__init__.py:155-170)
    h = hashlib.sha256(b"igma-sdf-v1:native")
    for a in (verts, tris, origin, spacing, dims):
        h.update(a.tobytes())
    cache = BUILD_ROOT / "grids" / f"{h.hexdigest()[:20]}.npy"
    if cache.is_file():
        g = np.load(cache)
        if g.shape == shape and g.dtype == np.float32:
            return g
    lib = load()
    out = np.empty(int(np.prod(shape)), np.float32)
    lib.sdf_voxelize(_ptr(verts, ctypes.c_float), np.int32(len(verts)),
                     _ptr(tris, ctypes.c_int32), np.int32(len(tris)),
                     _ptr(origin, ctypes.c_float),
                     _ptr(spacing, ctypes.c_float),
                     _ptr(dims, ctypes.c_int32), _ptr(out, ctypes.c_float))
    grid = out.reshape(shape)
    cache.parent.mkdir(parents=True, exist_ok=True)
    tmp = cache.with_name(f"{cache.stem}.w{os.getpid()}.npy")
    np.save(tmp, grid)
    os.replace(tmp, cache)
    return grid


def query_mesh_sdf(verts: np.ndarray, tris: np.ndarray,
                   pts: np.ndarray) -> np.ndarray:
    """Signed distances (P,) of arbitrary points (P, 3) to a mesh through
    the C++ library (host side; the step samples a baked grid)."""
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    pts = np.ascontiguousarray(pts, np.float32)
    out = np.empty(len(pts), np.float32)
    load().sdf_query_points(
        _ptr(verts, ctypes.c_float), np.int32(len(verts)),
        _ptr(tris, ctypes.c_int32), np.int32(len(tris)),
        _ptr(pts, ctypes.c_float), np.int32(len(pts)),
        _ptr(out, ctypes.c_float))
    return out
