"""The port's viewer (utils/viewer.py) and ``VecTaskBase.render`` against the
JAX package's, on the CPU, at Ant with 4 envs.

* The rasterizer is a copy: on the same poses both packages' images are
  bit-equal.  ``task.render`` reads the port's own poses (``engine.
  forward``), within 1.2e-7 of JAX's (one float32 ulp); splats of nearly
  equal depth can then be drawn in the other order and whole edge pixels
  change, as they do when JAX's own poses move by one ulp (measured on
  the CPU: 275 of 76,800 pixels differ by more than one intensity step
  from JAX's image, against 599 for JAX's image of its own poses nudged
  by one ulp).  So the images are held at one intensity step on all but
  1% of the pixels.
* The PNG writer round-trips and writes JAX's bytes; ``FrameRecorder``
  records a rollout whose frames differ; ``save_video`` falls back to
  PNG frames without imageio; ``InteractiveViewer`` raises under Agg and
  runs with ``headless_ok=True``, its keys toggling sync, recording and
  quit.
"""
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.physics.engine import SimState as JSimState
from isaacgymenvs_ma_tpu.tasks.ant import Ant as JAnt
from isaacgymenvs_ma_tpu.tasks.ant import TASK_CFG as JCFG
from isaacgymenvs_ma_tpu.utils import viewer as jviewer
from isaacgymenvs_ma_tpu.utils.config import deep_merge as jdeep_merge
from isaacgymenvs_ma_tpu_torch.physics.engine import SimState
from isaacgymenvs_ma_tpu_torch.tasks.ant import TASK_CFG, Ant
from isaacgymenvs_ma_tpu_torch.utils import viewer as tviewer
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

torch.set_num_threads(1)   # small CPU ops: one thread a test worker


@pytest.fixture(scope="module")
def ant_pair():
    jt = JAnt(jdeep_merge(JCFG, {"env": {"numEnvs": 4}}))
    tt = Ant(deep_merge(TASK_CFG, {"env": {"numEnvs": 4}}), device="cpu")
    st = tt.initial_state()
    g = np.random.default_rng(0)
    q = st.sim.q.numpy().copy()
    q[:, 7:] += g.uniform(-0.5, 0.5, q[:, 7:].shape)
    q[:, :2] += g.uniform(-0.3, 0.3, (4, 2))
    q = q.astype(np.float32)
    jst = jt.initial_state(jax.random.PRNGKey(0))
    jst = jst._replace(sim=JSimState(jnp.asarray(q),
                                     jnp.zeros_like(jst.sim.qd)))
    tst = st._replace(sim=SimState(torch.as_tensor(q),
                                   torch.zeros_like(st.sim.qd)))
    return jt, tt, jst, tst


def test_rasterizer_bit_equal_on_the_same_poses(ant_pair):
    jt, tt, jst, _ = ant_pair
    out = jt.engine.forward(jst.sim)
    for e in range(4):
        bp, bq = np.asarray(out.body_pos[e]), np.asarray(out.body_quat[e])
        for ground in (True, False):
            a = jviewer.render_rgb(jt.model, bp, bq, ground=ground)
            b = tviewer.render_rgb(tt.model, bp, bq, ground=ground)
            np.testing.assert_array_equal(a, b)


def test_render_matches_jax(ant_pair):
    jt, tt, jst, tst = ant_pair
    jo, to = jt.engine.forward(jst.sim), tt.engine.forward(tst.sim)
    assert float(np.abs(np.asarray(jo.body_pos)
                        - to.body_pos.numpy()).max()) <= 1.2e-7
    assert float(np.abs(np.asarray(jo.body_quat)
                        - to.body_quat.numpy()).max()) <= 2.4e-7
    drawn = 0
    for e in range(4):
        a = np.asarray(jt.render(jst, env_index=e)).astype(int)
        b = tt.render(tst, env_index=e)
        assert b.shape == (240, 320, 3) and b.dtype == np.uint8
        off = np.abs(a - b.astype(int)).max(-1) > 1
        assert off.mean() <= 0.01, (e, int(off.sum()))
        drawn += int((b != b[0, 0]).any(-1).sum())
    assert drawn > 1000                     # the robot is in the picture
    with pytest.raises(ValueError):
        tt.render(tst, mode="human")


def _read_png(path):
    buf = open(path, "rb").read()
    assert buf[:8] == b"\x89PNG\r\n\x1a\n"
    i, idat, w, h = 8, b"", None, None
    while i < len(buf):
        (n,) = struct.unpack(">I", buf[i: i + 4])
        tag, data = buf[i + 4: i + 8], buf[i + 8: i + 8 + n]
        (crc,) = struct.unpack(">I", buf[i + 8 + n: i + 12 + n])
        assert crc == zlib.crc32(tag + data) & 0xFFFFFFFF
        if tag == b"IHDR":
            w, h = struct.unpack(">II", data[:8])
        elif tag == b"IDAT":
            idat += data
        i += 12 + n
    raw = zlib.decompress(idat)
    rows = [raw[r * (3 * w + 1) + 1: (r + 1) * (3 * w + 1)] for r in range(h)]
    return np.frombuffer(b"".join(rows), np.uint8).reshape(h, w, 3)


def test_png_round_trip(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (17, 23, 3),
                                            dtype=np.uint8)
    tviewer.write_png(str(tmp_path / "t.png"), img)
    jviewer.write_png(str(tmp_path / "j.png"), img)
    np.testing.assert_array_equal(_read_png(str(tmp_path / "t.png")), img)
    assert (open(tmp_path / "t.png", "rb").read()
            == open(tmp_path / "j.png", "rb").read())


def test_frame_recorder_and_png_fallback(ant_pair, tmp_path, monkeypatch):
    _, tt, _, tst = ant_pair
    rec = tviewer.FrameRecorder(tt)
    st = tst
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        rec.capture(st)
        st, _ = tt.step(st, torch.rand((4, 8), generator=g) * 2 - 1)
    assert len(rec.frames) == 3
    for a, b in zip(rec.frames, rec.frames[1:]):
        assert not np.array_equal(a, b)
    # no imageio: the frames land as PNGs beside the video's path
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    out = rec.save_video(str(tmp_path / "videos" / "step_8.mp4"))
    assert out == [str(tmp_path / "videos" / "step_8" / f"frame_{i:04d}.png")
                   for i in range(3)]
    for p, f in zip(out, rec.frames):
        np.testing.assert_array_equal(_read_png(p), f)
    rec.clear()
    assert rec.frames == []


def test_interactive_viewer_under_agg(ant_pair):
    import matplotlib
    matplotlib.use("Agg")
    _, tt, _, tst = ant_pair
    with pytest.raises(RuntimeError, match="GUI matplotlib backend"):
        tviewer.InteractiveViewer(tt)
    v = tviewer.InteractiveViewer(tt, headless_ok=True, render_fps=1e6)
    frame = v.render(tst)
    assert frame.shape == (240, 320, 3)

    def press(k):
        v._on_key(type("KeyEvent", (), {"key": k})())
    press("r")                       # record: the next draw is captured
    assert v.recording and len(v.recorder.frames) == 0
    v.render(tst)
    assert len(v.recorder.frames) == 1
    press("r")
    press("v")                       # sync off: nothing is drawn
    assert v.render(tst) is None and not v.enable_viewer_sync
    press("escape")
    assert not v.open and v.render(tst) is None
