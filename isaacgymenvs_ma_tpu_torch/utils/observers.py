"""Training observers (port of isaacgymenvs_ma_tpu/utils/observers.py;
reference utils/rlgames_utils.py:130-239 + wandb_utils).

``AlgoObserver``, ``ConsoleObserver``, ``MultiObserver`` and
``WandbObserver`` are copies of the JAX package's.  ``TensorboardObserver``
writes the same Episode/* / losses/* / info/* scalars, but with its own
event-file writer: the JAX package goes through tensorboardX, which the
card's machine does not have.  :class:`EventFileWriter` frames each
``Event`` protobuf as a TFRecord (little-endian length, its masked CRC32C,
the bytes, their masked CRC32C) and encodes the two messages it needs by
hand (``Event``: wall_time 1, step 2, file_version 3, summary 5;
``Summary.Value``: tag 1, simple_value 2).  :func:`read_events` reads such
a file back, checking every CRC, so a run can check what it wrote.
Metrics arrive as a flat host dict once per log interval.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, List, Optional, Tuple


class AlgoObserver:
    def after_init(self, config: dict):
        pass

    def after_print_stats(self, epoch: int, metrics: Dict[str, float]):
        pass

    def after_steps(self, epoch: int, frames: int, metrics: Dict[str, float]):
        pass


# ----------------------------------------------------------------------
# TFRecord framing and the Event / Summary protobufs

def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum TFRecord uses."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1                 # int64 as the wire's two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, data: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(data)) + data


def encode_event(wall_time: float, step: int = 0,
                 file_version: Optional[str] = None,
                 scalars: Optional[List[Tuple[str, float]]] = None) -> bytes:
    """One ``Event`` message: its wall time, step, and either the file
    version or a ``Summary`` of (tag, simple_value) scalars."""
    out = bytes([1 << 3 | 1]) + struct.pack("<d", wall_time)
    out += _varint(2 << 3) + _varint(int(step))
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(1, _field_bytes(1, tag.encode())
                         + bytes([2 << 3 | 5]) + struct.pack("<f", value))
            for tag, value in scalars)
        out += _field_bytes(5, summary)
    return out


def frame_record(data: bytes) -> bytes:
    """A TFRecord: length, masked CRC of the length, data, masked CRC."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    n, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message; value is an
    int (varint), bytes (length-delimited) or the raw 4 / 8 bytes."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v, i = buf[i: i + 8], i + 8
        elif wt == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i: i + n], i + n
        elif wt == 5:
            v, i = buf[i: i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield num, wt, v


def decode_event(buf: bytes) -> dict:
    """{"wall_time", "step", "file_version" or None, "scalars": [(tag,
    value)]} of one ``Event``; only ``simple_value`` summaries are read."""
    ev = {"wall_time": 0.0, "step": 0, "file_version": None, "scalars": []}
    for num, _, v in _fields(buf):
        if num == 1:
            ev["wall_time"] = struct.unpack("<d", v)[0]
        elif num == 2:
            ev["step"] = v - (1 << 64) if v >= 1 << 63 else v
        elif num == 3:
            ev["file_version"] = v.decode()
        elif num == 5:
            for snum, _, sval in _fields(v):
                if snum != 1:
                    continue
                tag, value = None, None
                for vnum, _, vv in _fields(sval):
                    if vnum == 1:
                        tag = vv.decode()
                    elif vnum == 2:
                        value = struct.unpack("<f", vv)[0]
                if tag is not None and value is not None:
                    ev["scalars"].append((tag, value))
    return ev


def read_events(path: str) -> List[dict]:
    """Every event of a TFRecord event file (:func:`decode_event`); raises
    ValueError on a truncated record or a CRC that does not match."""
    with open(path, "rb") as f:
        buf = f.read()
    out, i = [], 0
    while i < len(buf):
        if i + 12 > len(buf):
            raise ValueError(f"{path}: truncated record header at {i}")
        length = buf[i: i + 8]
        (n,) = struct.unpack("<Q", length)
        (lcrc,) = struct.unpack("<I", buf[i + 8: i + 12])
        if lcrc != masked_crc32c(length):
            raise ValueError(f"{path}: length CRC mismatch at {i}")
        data = buf[i + 12: i + 12 + n]
        if len(data) != n or i + 16 + n > len(buf):
            raise ValueError(f"{path}: truncated record at {i}")
        (dcrc,) = struct.unpack("<I", buf[i + 12 + n: i + 16 + n])
        if dcrc != masked_crc32c(data):
            raise ValueError(f"{path}: data CRC mismatch at {i}")
        out.append(decode_event(data))
        i += 16 + n
    return out


def read_scalars(logdir: str) -> Dict[str, List[Tuple[int, float]]]:
    """{tag: [(step, value), ...]} over every event file in ``logdir``, in
    file-name then record order."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    for name in sorted(os.listdir(logdir)):
        if "tfevents" not in name:
            continue
        for ev in read_events(os.path.join(logdir, name)):
            for tag, value in ev["scalars"]:
                out.setdefault(tag, []).append((ev["step"], value))
    return out


class EventFileWriter:
    """Appends events to ``logdir/events.out.tfevents.<time>.<host>``, the
    name TensorBoard looks for; the first record is the file version."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time()):010d}."
                    f"{socket.gethostname()}")
        self._f = open(self.path, "ab")
        self._f.write(frame_record(encode_event(
            time.time(), 0, file_version="brain.Event:2")))

    def add_scalars(self, scalars: List[Tuple[str, float]], step: int):
        self._f.write(frame_record(encode_event(time.time(), step,
                                                scalars=scalars)))

    def add_scalar(self, tag: str, value: float, step: int):
        self.add_scalars([(tag, float(value))], step)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


class TensorboardObserver(AlgoObserver):
    """Writes Episode/* and losses/* scalars (rlgames_utils.py:149-209):
    one event a metric, as tensorboardX's ``add_scalar`` writes them."""

    def __init__(self, logdir: str):
        self.writer = EventFileWriter(logdir)

    def after_print_stats(self, epoch, metrics):
        frames = int(metrics.get("frames", epoch))
        for k, v in metrics.items():
            if k == "frames":
                continue
            section = "losses" if "loss" in k else (
                "Episode" if k.startswith("episode_") or k.startswith("mean_")
                else "info")
            self.writer.add_scalar(f"{section}/{k}", float(v), frames)
        self.writer.flush()


class ConsoleObserver(AlgoObserver):
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.t0 = time.time()

    def after_print_stats(self, epoch, metrics):
        pass  # the agent already prints


class MultiObserver(AlgoObserver):
    """Fan-out composite (rlgames_utils.py:212-239)."""

    def __init__(self, *observers: AlgoObserver):
        self.observers = [o for o in observers if o is not None]

    def after_init(self, config):
        for o in self.observers:
            o.after_init(config)

    def after_print_stats(self, epoch, metrics):
        for o in self.observers:
            o.after_print_stats(epoch, metrics)

    def after_steps(self, epoch, frames, metrics):
        for o in self.observers:
            o.after_steps(epoch, frames, metrics)


class WandbObserver(AlgoObserver):
    """W&B init with retry + tensorboard sync (utils/wandb_utils.py:7-57).

    Gated import: wandb is not installed here, so this degrades to a
    no-op with a warning when unavailable.
    """

    def __init__(self, project: str, group: str = "", name: str = "",
                 entity: str = "", tags=(), resume_uid: Optional[str] = None):
        self.enabled = False
        try:
            import wandb  # noqa
            for attempt in range(3):
                try:
                    wandb.init(project=project, group=group or None,
                               name=name or None, entity=entity or None,
                               tags=list(tags), id=resume_uid, resume="allow",
                               sync_tensorboard=True)
                    self.enabled = True
                    break
                except Exception:
                    time.sleep(2 * (attempt + 1))
        except ImportError:
            print("[observers] wandb not installed; WandbObserver disabled")
        self._wandb = None if not self.enabled else __import__("wandb")

    def after_print_stats(self, epoch, metrics):
        if self.enabled:
            self._wandb.log({k: float(v) for k, v in metrics.items()},
                            step=int(metrics.get("frames", epoch)))
