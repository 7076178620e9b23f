"""Procedural terrain (port of isaacgymenvs_ma_tpu/physics/terrain.py).

The heightfield generators and :class:`CurriculumTerrain` are numpy at
build time, copied from the JAX package (the ``isaacgym.terrain_utils``
replacement of the reference's AnymalTerrain, ``tasks/anymal_terrain.py:
542-673``).  The runtime surface is :class:`TerrainGrid`, the global grid
as one float32 tensor on the device with the bilinear ``height_at`` the
contact rows read and the reference's min-of-two-cells ``height_min2`` the
140-point height observations read, each a gather of the cells under the
query points.  (The JAX package also has ``LocalTerrain``, per-env windows
looked up by one-hot matrix products, a TPU workaround for slow batched
gathers; the port does not carry it, and the tests hold its lookups to
these gathers.)  Surface normals (``SimParams.terrain_normal_frames``) are
not ported: ``normal_at`` and ``height_and_normal`` raise.
"""
from __future__ import annotations

import numpy as np
import torch


class SubTerrain:
    """Height patch in integer units of ``vertical_scale`` (terrain_utils parity)."""

    def __init__(self, name="terrain", width=256, length=256,
                 vertical_scale=0.005, horizontal_scale=0.1):
        self.name = name
        self.width = width
        self.length = length
        self.vertical_scale = vertical_scale
        self.horizontal_scale = horizontal_scale
        self.height_field_raw = np.zeros((width, length), dtype=np.int16)


def random_uniform_terrain(terrain: SubTerrain, min_height, max_height,
                           step=0.05, downsampled_scale=None, rng=None):
    rng = rng or np.random.default_rng()
    if downsampled_scale is None:
        downsampled_scale = terrain.horizontal_scale
    hmin = int(min_height / terrain.vertical_scale)
    hmax = int(max_height / terrain.vertical_scale)
    hstep = max(int(step / terrain.vertical_scale), 1)
    levels = np.arange(hmin, hmax + hstep, hstep)
    dw = max(int(terrain.width * terrain.horizontal_scale / downsampled_scale), 2)
    dl = max(int(terrain.length * terrain.horizontal_scale / downsampled_scale), 2)
    coarse = rng.choice(levels, (dw, dl))
    # bilinear upsample to the full grid
    xi = np.linspace(0, dw - 1, terrain.width)
    yi = np.linspace(0, dl - 1, terrain.length)
    x0 = np.clip(xi.astype(int), 0, dw - 2)
    y0 = np.clip(yi.astype(int), 0, dl - 2)
    fx = (xi - x0)[:, None]
    fy = (yi - y0)[None, :]
    c00 = coarse[x0][:, y0]
    c10 = coarse[x0 + 1][:, y0]
    c01 = coarse[x0][:, y0 + 1]
    c11 = coarse[x0 + 1][:, y0 + 1]
    up = (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
          + c01 * (1 - fx) * fy + c11 * fx * fy)
    terrain.height_field_raw += up.astype(np.int16)
    return terrain


def sloped_terrain(terrain: SubTerrain, slope=1.0):
    x = np.arange(terrain.width)
    max_h = int(slope * terrain.horizontal_scale / terrain.vertical_scale
                * terrain.width)
    terrain.height_field_raw += (max_h * x / terrain.width)[:, None].astype(np.int16)
    return terrain


def pyramid_sloped_terrain(terrain: SubTerrain, slope=1.0, platform_size=1.0):
    x = np.arange(terrain.width)
    y = np.arange(terrain.length)
    cx, cy = terrain.width // 2, terrain.length // 2
    xf = (cx - np.abs(cx - x)) / cx
    yf = (cy - np.abs(cy - y)) / cy
    max_h = int(slope * (terrain.horizontal_scale / terrain.vertical_scale)
                * (terrain.width / 2))
    hf = max_h * np.outer(xf, yf)
    platform = int(platform_size / terrain.horizontal_scale / 2)
    x1, x2 = cx - platform, cx + platform
    hf_center = hf[x1: x2, cy - platform: cy + platform]
    cap = hf_center.min() if slope > 0 else hf_center.max()
    hf = np.clip(hf, None, cap) if slope > 0 else np.clip(hf, cap, None)
    terrain.height_field_raw += hf.astype(np.int16)
    return terrain


def discrete_obstacles_terrain(terrain: SubTerrain, max_height=0.15,
                               min_size=1.0, max_size=2.0, num_rects=20,
                               platform_size=1.0, rng=None):
    rng = rng or np.random.default_rng()
    hmax = int(max_height / terrain.vertical_scale)
    heights = np.array([-hmax, -hmax // 2, hmax // 2, hmax])
    wmin = int(min_size / terrain.horizontal_scale)
    wmax = int(max_size / terrain.horizontal_scale)
    for _ in range(num_rects):
        w = int(rng.integers(wmin, wmax))
        l = int(rng.integers(wmin, wmax))
        sx = int(rng.integers(0, max(terrain.width - w, 1)))
        sy = int(rng.integers(0, max(terrain.length - l, 1)))
        terrain.height_field_raw[sx: sx + w, sy: sy + l] = rng.choice(heights)
    cx, cy = terrain.width // 2, terrain.length // 2
    platform = int(platform_size / terrain.horizontal_scale / 2)
    terrain.height_field_raw[cx - platform: cx + platform,
                             cy - platform: cy + platform] = 0
    return terrain


def wave_terrain(terrain: SubTerrain, num_waves=1, amplitude=1.0):
    amp = int(0.5 * amplitude / terrain.vertical_scale)
    if num_waves > 0:
        dx = np.arange(terrain.width) / terrain.width * num_waves * 2 * np.pi
        dy = np.arange(terrain.length) / terrain.length * num_waves * 2 * np.pi
        terrain.height_field_raw += (
            amp * (np.cos(dx)[:, None] + np.sin(dy)[None, :])).astype(np.int16)
    return terrain


def stairs_terrain(terrain: SubTerrain, step_width=0.75, step_height=0.1):
    sw = int(step_width / terrain.horizontal_scale)
    sh = int(step_height / terrain.vertical_scale)
    h = 0
    for i in range(terrain.width // sw):
        terrain.height_field_raw[i * sw: (i + 1) * sw, :] += h
        h += sh
    return terrain


def pyramid_stairs_terrain(terrain: SubTerrain, step_width=0.75,
                           step_height=0.1, platform_size=1.0):
    sw = int(step_width / terrain.horizontal_scale)
    sh = int(step_height / terrain.vertical_scale)
    platform = int(platform_size / terrain.horizontal_scale)
    h = 0
    sx, ex = 0, terrain.width
    sy, ey = 0, terrain.length
    while (ex - sx) > platform and (ey - sy) > platform:
        sx += sw; ex -= sw; sy += sw; ey -= sw
        h += sh
        terrain.height_field_raw[sx: ex, sy: ey] = h
    return terrain


def stepping_stones_terrain(terrain: SubTerrain, stone_size=1.0,
                            stone_distance=0.25, max_height=0.2,
                            platform_size=1.0, depth=-10.0, rng=None):
    rng = rng or np.random.default_rng()
    ss = max(int(stone_size / terrain.horizontal_scale), 1)
    sd = int(stone_distance / terrain.horizontal_scale)
    hmax = int(max_height / terrain.vertical_scale)
    d = int(depth / terrain.vertical_scale)
    terrain.height_field_raw[:] = d
    y = 0
    while y < terrain.length:
        x = int(rng.integers(0, ss)) - ss
        while x < terrain.width:
            x1, x2 = max(x, 0), min(x + ss, terrain.width)
            h = int(rng.integers(-hmax, hmax + 1))
            terrain.height_field_raw[x1: x2, y: min(y + ss, terrain.length)] = h
            x += ss + sd
        y += ss + sd
    cx, cy = terrain.width // 2, terrain.length // 2
    platform = int(platform_size / terrain.horizontal_scale / 2)
    terrain.height_field_raw[cx - platform: cx + platform,
                             cy - platform: cy + platform] = 0
    return terrain


class TerrainGrid:
    """Runtime heightfield: a world-aligned grid ``heights`` (W, L) in
    meters (a float32 tensor), cell size ``horizontal_scale``, grid[0, 0]
    at world ``origin_xy``."""

    def __init__(self, heights: torch.Tensor, horizontal_scale: float,
                 origin_xy: tuple):
        self.heights = heights
        self.horizontal_scale = horizontal_scale
        self.origin_xy = origin_xy
        self._flat = heights.reshape(-1)

    def _cells(self, x, y):
        """Lower-left cell (clamped into the grid) of each query point and
        the fractional grid coordinates."""
        hx = (x - self.origin_xy[0]) / self.horizontal_scale
        hy = (y - self.origin_xy[1]) / self.horizontal_scale
        W, L = self.heights.shape
        x0 = torch.clamp(torch.floor(hx).to(torch.int64), 0, W - 2)
        y0 = torch.clamp(torch.floor(hy).to(torch.int64), 0, L - 2)
        return hx, hy, x0, y0, x0 * L + y0

    def height_at(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Bilinear height under world points (x, y) (terrain.py:211-224)."""
        hx, hy, x0, y0, i = self._cells(x, y)
        L = self.heights.shape[1]
        fx = torch.clamp(hx - x0, 0.0, 1.0)
        fy = torch.clamp(hy - y0, 0.0, 1.0)
        h00 = self._flat[i]
        h10 = self._flat[i + L]
        h01 = self._flat[i + 1]
        h11 = self._flat[i + L + 1]
        return (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
                + h01 * (1 - fx) * fy + h11 * fx * fy)

    def height_min2(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The reference's conservative sample: min(h[x, y], h[x+1, y+1])
        (anymal_terrain.py:515-538; terrain.py:226-235)."""
        _, _, _, _, i = self._cells(x, y)
        L = self.heights.shape[1]
        return torch.minimum(self._flat[i], self._flat[i + L + 1])

    def normal_at(self, x, y):
        raise NotImplementedError(
            "terrain surface normals (terrain_normal_frames) are not ported "
            "to isaacgymenvs_ma_tpu_torch yet (see ROADMAP.md)")

    def height_and_normal(self, x, y):
        return self.normal_at(x, y)


class CurriculumTerrain:
    """The AnymalTerrain map: rows = difficulty levels, cols = terrain types
    (anymal_terrain.py:543-673), assembled into one TerrainGrid on
    ``device`` with per-cell env origins for curriculum placement
    (``env_origins`` numpy float64, ``env_origins_t`` the float32 tensor).
    The generators draw from ``np.random.default_rng(seed)`` in the JAX
    package's order, so the heightfield and the origins are bit-equal to
    its ``CurriculumTerrain``'s."""

    def __init__(self, num_levels=10, num_types=20, terrain_width=8.0,
                 terrain_length=8.0, horizontal_scale=0.1, vertical_scale=0.005,
                 border_size=20.0, slope_threshold=None, seed=17,
                 proportions=(0.1, 0.1, 0.35, 0.25, 0.2), curriculum=True,
                 device="cuda"):
        rng = np.random.default_rng(seed)
        self.num_levels = num_levels
        self.num_types = num_types
        self.env_length = terrain_length
        self.env_width = terrain_width
        w = int(terrain_width / horizontal_scale)
        l = int(terrain_length / horizontal_scale)
        border = int(border_size / horizontal_scale)
        H = num_levels * w + 2 * border
        L = num_types * l + 2 * border
        field = np.zeros((H, L), np.float64)
        self.env_origins = np.zeros((num_levels, num_types, 3))
        props = np.cumsum(proportions) / np.sum(proportions)

        for i in range(num_levels):
            for j in range(num_types):
                t = SubTerrain(width=w, length=l, vertical_scale=vertical_scale,
                               horizontal_scale=horizontal_scale)
                if curriculum:
                    difficulty = i / max(num_levels - 1, 1)
                    choice = j / num_types + 0.001
                else:
                    difficulty = rng.uniform(0.5, 0.9)
                    choice = rng.uniform()
                slope = difficulty * 0.4
                step_height = 0.05 + 0.175 * difficulty
                discrete_height = 0.025 + 0.15 * difficulty
                stone_size = 2.0 - 1.4 * difficulty
                if choice < props[0]:
                    pyramid_sloped_terrain(t, slope=slope if choice >= props[0] / 2
                                           else -slope, platform_size=3.0)
                elif choice < props[1]:
                    pyramid_sloped_terrain(t, slope=slope, platform_size=3.0)
                    random_uniform_terrain(t, -0.05, 0.05, 0.005,
                                           downsampled_scale=0.2, rng=rng)
                elif choice < props[2]:
                    pyramid_stairs_terrain(
                        t, step_width=0.31,
                        step_height=step_height if choice >= (props[1] + props[2]) / 2
                        else -step_height, platform_size=3.0)
                elif choice < props[3]:
                    discrete_obstacles_terrain(t, discrete_height, 1.0, 2.0, 40,
                                               platform_size=3.0, rng=rng)
                else:
                    stepping_stones_terrain(t, stone_size=stone_size,
                                            stone_distance=0.1, max_height=0.0,
                                            platform_size=3.0, rng=rng)
                x0 = border + i * w
                y0 = border + j * l
                field[x0: x0 + w, y0: y0 + l] = (
                    t.height_field_raw.astype(np.float64) * vertical_scale)
                cx1, cx2 = x0 + w // 2 - 1, x0 + w // 2 + 1
                cy1, cy2 = y0 + l // 2 - 1, y0 + l // 2 + 1
                env_origin_z = field[cx1: cx2, cy1: cy2].max()
                self.env_origins[i, j] = [
                    (x0 + w / 2) * horizontal_scale,
                    (y0 + l / 2) * horizontal_scale,
                    env_origin_z,
                ]
        self.grid = TerrainGrid(
            heights=torch.as_tensor(field.astype(np.float32), device=device),
            horizontal_scale=horizontal_scale,
            origin_xy=(0.0, 0.0),
        )
        self.env_origins_t = torch.as_tensor(
            self.env_origins.astype(np.float32), device=device)
