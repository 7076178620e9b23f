"""Headless rendering (port of isaacgymenvs_ma_tpu/utils/viewer.py; reference
vec_task.py:271-514 ``set_viewer``/
``render``: camera, `render(mode='rgb_array')` via pyvirtualdisplay screen
capture, frame recording to PNG).

The reference renders through the isaacgym viewer + a virtual X display.
Here a small pure-numpy splat rasterizer draws the scene's collision geoms
from the engine's pose readouts — no GL, no display, runs in any headless
job.  The rasterizer, the PNG writer, :class:`FrameRecorder` and
:class:`InteractiveViewer` are copies of the JAX package's; the poses come
from ``engine.forward`` (kinematics on the task's device, B1 on the card)
and only the rendered env's are read to the host (:func:`env_poses`).  Not a photorealistic renderer: it is the debug/monitoring surface the
reference's `virtual_screen_capture` path provides (env videos for wandb,
docs/framework.md "Recording videos").

* :func:`render_rgb` — one env -> (H, W, 3) uint8, z-buffered sphere
  splats (spheres/capsules/boxes are splatted as shaded discs along their
  primitive skeletons) over a checkerboard ground.
* :func:`write_png` — dependency-free PNG writer (zlib + struct).
* :class:`FrameRecorder` — `capture(state)` appends frames; `save(dir)`
  writes `frame_%04d.png`, the reference's record-frames loop.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..models import model as md


def env_poses(engine, sim, env_index: int = 0):
    """(body_pos (nb, 3), body_quat (nb, 4)) of one env as float32 numpy,
    from ``engine.forward``; only that env's rows leave the device."""
    out = engine.forward(sim)
    return (out.body_pos[env_index].detach().cpu().numpy(),
            out.body_quat[env_index].detach().cpu().numpy())


def _look_at(eye, target, up=(0.0, 0.0, 1.0)):
    eye = np.asarray(eye, np.float32)
    f = np.asarray(target, np.float32) - eye
    f /= np.linalg.norm(f) + 1e-9
    r = np.cross(f, np.asarray(up, np.float32))
    r /= np.linalg.norm(r) + 1e-9
    u = np.cross(r, f)
    R = np.stack([r, u, f])            # world -> camera rows
    return R, eye


def _quat_mat(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _geom_splats(model: md.SceneModel, body_pos, body_quat):
    """(centers (M,3), radii (M,), colors (M,3)) — primitive skeletons."""
    rng = np.random.default_rng(0)
    centers, radii, colors = [], [], []
    for g in model.geoms:
        R = _quat_mat(np.asarray(body_quat[g.body], np.float32))
        base = np.asarray(body_pos[g.body], np.float32) \
            + R @ np.asarray(g.pos, np.float32)
        Rg = R @ _quat_mat(np.asarray(g.quat, np.float32))
        col = 0.35 + 0.6 * rng.random(3)
        if g.gtype == md.GEOM_SPHERE:
            pts = [base]
            rs = [g.size[0]]
        elif g.gtype == md.GEOM_CAPSULE:
            n = 5
            ts = np.linspace(-g.size[1], g.size[1], n)
            pts = [base + Rg @ np.array([0, 0, t], np.float32) for t in ts]
            rs = [g.size[0]] * n
        elif g.gtype == md.GEOM_CYLINDER:
            n = 4
            ts = np.linspace(-g.size[1], g.size[1], n)
            pts = [base + Rg @ np.array([0, 0, t], np.float32) for t in ts]
            rs = [g.size[0]] * n
        elif g.gtype == md.GEOM_BOX:
            hx, hy, hz = np.asarray(g.size, np.float32)
            r = float(min(hx, hy, hz))
            nx = max(1, int(round(hx / r)))
            ny = max(1, int(round(hy / r)))
            nz = max(1, int(round(hz / r)))
            pts, rs = [], []
            for ix in np.linspace(-hx + r, hx - r, min(nx, 4)):
                for iy in np.linspace(-hy + r, hy - r, min(ny, 4)):
                    for iz in np.linspace(-hz + r, hz - r, min(nz, 4)):
                        pts.append(base + Rg @ np.array([ix, iy, iz],
                                                        np.float32))
                        rs.append(r)
        else:
            continue
        centers += list(pts)
        radii += list(rs)
        colors += [col] * len(pts)
    if not centers:
        return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                np.zeros((0, 3), np.float32))
    return (np.asarray(centers, np.float32), np.asarray(radii, np.float32),
            np.asarray(colors, np.float32))


def render_rgb(model: md.SceneModel, body_pos, body_quat,
               camera_eye=(2.0, 2.0, 1.5), camera_target=(0.0, 0.0, 0.5),
               size=(240, 320), fov_deg=55.0, ground: bool = True):
    """Rasterize one env's geoms into an (H, W, 3) uint8 image."""
    H, W = size
    img = np.zeros((H, W, 3), np.float32)
    zbuf = np.full((H, W), np.inf, np.float32)
    R, eye = _look_at(camera_eye, camera_target)
    focal = 0.5 * W / np.tan(np.radians(fov_deg) / 2)

    if ground:
        # checkerboard plane via per-pixel ray cast (vectorized)
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        dirs_cam = np.stack([(xs - W / 2) / focal, -(ys - H / 2) / focal,
                             np.ones_like(xs)], -1)
        dirs = dirs_cam @ R               # camera -> world
        t = -eye[2] / np.where(np.abs(dirs[..., 2]) < 1e-6, 1e-6,
                               dirs[..., 2])
        hit = (t > 0) & (dirs[..., 2] < 0)
        px = eye[0] + t * dirs[..., 0]
        py = eye[1] + t * dirs[..., 1]
        checker = ((np.floor(px) + np.floor(py)) % 2).astype(bool)
        shade = np.where(checker, 0.32, 0.42)[..., None] * np.ones(3)
        img = np.where(hit[..., None], shade, np.array([0.65, 0.78, 0.9]))
        zbuf = np.where(hit, t, np.inf)
    else:
        img[:] = np.array([0.65, 0.78, 0.9])

    centers, radii, colors = _geom_splats(model, body_pos, body_quat)
    if len(centers):
        cam = (centers - eye) @ R.T       # (M, 3), z forward
        order = np.argsort(-cam[:, 2])    # far to near
        for i in order:
            z = cam[i, 2]
            if z <= 0.05:
                continue
            u = focal * cam[i, 0] / z + W / 2
            v = -focal * cam[i, 1] / z + H / 2
            pr = focal * radii[i] / z
            if pr < 0.5 or u < -pr or u > W + pr or v < -pr or v > H + pr:
                continue
            x0, x1 = int(max(0, u - pr)), int(min(W, u + pr + 1))
            y0, y1 = int(max(0, v - pr)), int(min(H, v + pr + 1))
            if x0 >= x1 or y0 >= y1:
                continue
            yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
            d2 = ((xx - u) ** 2 + (yy - v) ** 2) / (pr * pr)
            mask = (d2 <= 1.0) & (z < zbuf[y0:y1, x0:x1])
            shade = (0.55 + 0.45 * np.sqrt(np.maximum(1.0 - d2, 0.0)))
            patch = img[y0:y1, x0:x1]
            patch[mask] = (colors[i] * shade[..., None])[mask]
            zb = zbuf[y0:y1, x0:x1]
            zb[mask] = z
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray):
    """Minimal PNG encoder (8-bit RGB) — no imageio/PIL dependency."""
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


class FrameRecorder:
    """Frame capture loop (the reference's record-frames path,
    vec_task.py `render` + virtual_screen_capture)."""

    def __init__(self, task, env_index: int = 0, **camera_kwargs):
        self.task = task
        self.env_index = env_index
        self.camera_kwargs = camera_kwargs
        self.frames = []

    def capture(self, env_state):
        bp, bq = env_poses(self.task.engine, env_state.sim, self.env_index)
        frame = render_rgb(self.task.model, bp, bq,
                           ground=getattr(self.task.engine, "ground", True),
                           **self.camera_kwargs)
        self.frames.append(frame)
        return frame

    def save(self, out_dir: str, prefix: str = "frame"):
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for i, f in enumerate(self.frames):
            p = os.path.join(out_dir, f"{prefix}_{i:04d}.png")
            write_png(p, f)
            paths.append(p)
        return paths

    def save_video(self, path: str, fps: int = 30):
        """mp4 via imageio when available (the RecordVideo analog,
        reference train.py:138-145); falls back to a PNG sequence next to
        ``path``.  Returns the artifact path."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        try:
            import imageio.v2 as iio
            iio.mimwrite(path, self.frames, fps=fps)
            return path
        except Exception:
            pass
        try:  # gif needs only the Pillow plugin
            import imageio.v2 as iio
            gif = os.path.splitext(path)[0] + ".gif"
            iio.mimwrite(gif, self.frames, duration=1000.0 / fps, loop=0)
            return gif
        except Exception:
            return self.save(os.path.splitext(path)[0])

    def clear(self):
        self.frames = []


class InteractiveViewer:
    """Interactive viewer surface (reference ``set_viewer``/``render``,
    vec_task.py:271-300,459-514): a live window with the reference's
    keyboard semantics —

    * **ESC / Q** — quit (subscribe_viewer_keyboard_event QUIT :276-279),
    * **V** — toggle ``enable_viewer_sync`` (:280-283, :474-489): when off,
      stepping continues but frames stop being drawn (the reference's
      free-running mode),
    * **R** — toggle frame recording into :class:`FrameRecorder`
      (``record_frames`` :290-300),

    plus ``sync_frame_time`` real-time throttling (:499-503) via the
    ``render_fps`` argument and a follow camera re-aimed at the tracked
    env's root each draw (``viewer_camera_look_at`` analog).

    The window is a matplotlib figure so it runs anywhere a display (or
    X-forwarding) exists; on a headless machine matplotlib's Agg backend
    has no window, so construction raises unless ``headless_ok`` — the same
    loud failure the reference gives without an X server (camera_props path
    :266-268).  The draw path reuses the splat rasterizer, so what you see
    is exactly what `render(rgb_array)` records.

    Usage::

        viewer = InteractiveViewer(task)
        while viewer.open:
            state, _ = step_fn(state, actions)
            viewer.render(state)          # throttles, draws, handles keys
    """

    def __init__(self, task, env_index: int = 0, render_fps: float = 60.0,
                 headless_ok: bool = False, **camera_kwargs):
        import matplotlib
        self.task = task
        self.env_index = env_index
        self.render_fps = float(render_fps)
        self.camera_kwargs = camera_kwargs
        self.enable_viewer_sync = True
        self.recording = False
        self.recorder = FrameRecorder(task, env_index, **camera_kwargs)
        self.open = True
        self._last_draw = 0.0
        backend = matplotlib.get_backend().lower()
        self._headless = "agg" in backend and "webagg" not in backend
        if self._headless and not headless_ok:
            raise RuntimeError(
                "InteractiveViewer needs a GUI matplotlib backend (got "
                f"{backend!r}); run with a display / X forwarding, or use "
                "render(mode='rgb_array') + FrameRecorder headless")
        import matplotlib.pyplot as plt
        self._plt = plt
        self.fig, self._ax = plt.subplots(figsize=(6.4, 4.8))
        self._ax.set_axis_off()
        self._im = None
        self.fig.canvas.mpl_connect("key_press_event", self._on_key)
        self.fig.canvas.mpl_connect("close_event", lambda e: self._quit())
        if not self._headless:
            plt.ion()
            self.fig.show()

    # -- keyboard events (reference QUIT / toggle_viewer_sync / record) --
    def _on_key(self, event):
        k = (event.key or "").lower()
        if k in ("escape", "q"):
            self._quit()
        elif k == "v":
            self.enable_viewer_sync = not self.enable_viewer_sync
        elif k == "r":
            self.recording = not self.recording

    def _quit(self):
        self.open = False
        try:
            self._plt.close(self.fig)
        except Exception:
            pass

    def render(self, env_state):
        """Draw the tracked env, honoring sync/record toggles and the
        real-time throttle.  Returns the frame when one was drawn."""
        if not self.open:
            return None
        import time
        if self.recording:
            frame = self.recorder.capture(env_state)
        elif self.enable_viewer_sync:
            frame = None
        else:
            # free-running mode: keep the event loop alive, draw nothing
            self.fig.canvas.flush_events()
            return None
        # sync_frame_time: don't outrun real time (vec_task.py:499-503)
        now = time.monotonic()
        wait = (1.0 / self.render_fps) - (now - self._last_draw)
        if wait > 0:
            time.sleep(wait)
        self._last_draw = time.monotonic()
        if frame is None:
            bp, bq = env_poses(self.task.engine, env_state.sim,
                               self.env_index)
            frame = render_rgb(
                self.task.model, bp, bq,
                ground=getattr(self.task.engine, "ground", True),
                **self.camera_kwargs)
        if self._im is None:
            self._im = self._ax.imshow(frame)
        else:
            self._im.set_data(frame)
        self.fig.canvas.draw_idle()
        self.fig.canvas.flush_events()
        return frame
