"""Signed-distance voxel grids on the device (port of
isaacgymenvs_ma_tpu/physics/sdf_grid.py).

The voxelizer (..native, native/sdf_voxelize.cpp) bakes a triangle mesh into
a dense SDF grid when a scene is built; this module is the step's side:
trilinear sampling with the analytic gradient of the interpolant, used by
the contact narrowphase (mesh-shaped collision targets: the Factory nut and
bolt, the IndustReal socket and gear) and by the IndustReal rewards (SAPU
and the SDF dense reward).

The JAX package computes this in XLA, not in a Pallas kernel, and so does
the port: plain PyTorch.  Each query is one gather of its cell's 8 corners
from a packed (cells, 8) table built once per grid on its device (the JAX
package gets the same table by constant folding), then the interpolant
and its gradient.  Outside the grid's box the field is the clamped
boundary value plus the distance to the box, with the normal pointing away
from the box, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE


class SDFGrid(NamedTuple):
    """A baked grid on one device."""

    values: torch.Tensor    # (dx, dy, dz) signed distances at voxel centers
    origin: torch.Tensor    # (3,) position of voxel (0, 0, 0)
    spacing: torch.Tensor   # (3,) voxel pitch per axis
    pack: torch.Tensor      # ((dx-1)(dy-1)(dz-1), 8) each cell's corners
    hi: torch.Tensor        # (3,) dims - 1 - 1e-4: the clamp of the voxel
                            # coordinates (sdf_grid.py:71)


def to_device(values, origin, spacing, device) -> SDFGrid:
    """A grid of numpy ``values`` (dx, dy, dz), ``origin`` and ``spacing``
    (3,) as float32 tensors on ``device``, with its packed corner table:
    corner k = 4 ox + 2 oy + oz of cell (ix, iy, iz) at row
    (ix (dy - 1) + iy) (dz - 1) + iz (sdf_grid.py:77-82)."""
    v = torch.as_tensor(np.asarray(values, np.float32), device=device)
    dx, dy, dz = v.shape
    pack = torch.stack(
        [v[ox: dx - 1 + ox, oy: dy - 1 + oy, oz: dz - 1 + oz]
         for ox in (0, 1) for oy in (0, 1) for oz in (0, 1)],
        dim=-1).reshape(-1, 8).contiguous()
    dims = torch.as_tensor([dx, dy, dz], dtype=DTYPE, device=device)
    return SDFGrid(
        values=v,
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=device),
        spacing=torch.as_tensor(np.asarray(spacing, np.float32),
                                device=device),
        pack=pack, hi=dims - 1.0 - 1e-4)


def from_mesh(verts, tris, resolution: int = 48, pad: float = 0.15,
              device="cuda") -> SDFGrid:
    """Bake a mesh into a grid on ``device`` (sdf_grid.py:33-55):
    ``resolution`` voxels along the longest box axis, the box padded by
    ``pad`` of its longest side."""
    from ..native import voxelize_mesh
    verts = np.asarray(verts, np.float32)
    lo = verts.min(0)
    hi = verts.max(0)
    extent = hi - lo
    margin = float(extent.max()) * pad
    lo = lo - margin
    hi = hi + margin
    extent = hi - lo
    h = float(extent.max()) / (resolution - 1)
    dims = np.maximum(np.ceil(extent / h).astype(np.int32) + 1, 4)
    spacing = np.full(3, h, np.float32)
    vals = voxelize_mesh(verts, tris, lo, spacing, dims)
    return to_device(vals, lo, spacing, device)


def sample(grid: SDFGrid, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear SDF values at pts (..., 3) -> (...,)."""
    return sample_with_normal(grid, pts)[0]


def sample_with_normal(grid: SDFGrid, pts: torch.Tensor):
    """(values (...,), outward normals (..., 3)) at pts (..., 3)
    (sdf_grid.py:63-116): the normal is the analytic gradient of the
    trilinear interpolant, normalized; outside the box, the direction away
    from it."""
    dx, dy, dz = grid.values.shape
    u = (pts - grid.origin) / grid.spacing            # voxel coordinates
    uc = torch.minimum(torch.clamp(u, min=0.0), grid.hi)
    # the cell indices clamped into the table at both ends, as the JAX
    # gather clamps them: a non-finite point (an env the step's health net
    # is about to reset) reads a corner cell instead of out of bounds
    i0 = torch.floor(uc).to(torch.int64)
    ix = torch.clamp(i0[..., 0], 0, dx - 2)
    iy = torch.clamp(i0[..., 1], 0, dy - 2)
    iz = torch.clamp(i0[..., 2], 0, dz - 2)
    fx = uc[..., 0] - ix.to(uc.dtype)
    fy = uc[..., 1] - iy.to(uc.dtype)
    fz = uc[..., 2] - iz.to(uc.dtype)
    c8 = grid.pack[(ix * (dy - 1) + iy) * (dz - 1) + iz]     # (..., 8)
    (c000, c001, c010, c011,
     c100, c101, c110, c111) = c8.unbind(-1)

    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    d = c0 * (1 - fx) + c1 * fx

    # analytic trilinear gradient (per voxel, then to length units)
    sp = grid.spacing
    gx = (c1 - c0) / sp[0]
    gy = ((c01 - c00) * (1 - fx) + (c11 - c10) * fx) / sp[1]
    gz = (((c001 - c000) * (1 - fy) + (c011 - c010) * fy) * (1 - fx)
          + ((c101 - c100) * (1 - fy) + (c111 - c110) * fy) * fx) / sp[2]
    n = torch.stack([gx, gy, gz], -1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-9)

    # outside the box: clamped value + distance to the box
    over = (u - uc) * sp
    out_d = torch.linalg.vector_norm(over, dim=-1)
    d = d + out_d
    n_out = over / torch.clamp(out_d, min=1e-9)[..., None]
    n = torch.where((out_d > 0.0)[..., None], n_out, n)
    return d, n
