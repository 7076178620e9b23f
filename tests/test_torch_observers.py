"""The port's observers and config snapshot (utils/observers.py,
utils/config.py ``dump_yaml``) against the JAX package's, on the CPU.

* The same metrics fed to the port's ``TensorboardObserver`` (its own
  TFRecord / protobuf writer) and to the JAX one (tensorboardX): both
  event files, read by tensorboard's ``EventAccumulator``, give equal
  tags, steps and values; the port's reader reads both, every CRC
  checked, and refuses a corrupted file.
* For every registry name, the ``config.yaml`` emitter's output of the
  task and train configs reads back under ``yaml.safe_load`` equal to
  ``yaml.safe_load(yaml.safe_dump(cfg))``, the JAX snapshot's reading.
"""
import os

import numpy as np
import pytest
import torch
import yaml

from isaacgymenvs_ma_tpu.utils import observers as jobs
from isaacgymenvs_ma_tpu_torch.tasks import registry
from isaacgymenvs_ma_tpu_torch.utils import observers as tobs
from isaacgymenvs_ma_tpu_torch.utils.config import (
    GLOBAL_DEFAULTS, dump_yaml, load_task_config, load_train_config,
    write_config_snapshot)

torch.set_num_threads(1)   # small CPU ops: one thread a test worker


def _metrics(seed):
    g = np.random.default_rng(seed)
    keys = ("loss", "a_loss", "c_loss", "entropy", "kl", "lr",
            "mean_return", "mean_length", "sigma", "episodes_done",
            "episode/episode/terrain_level", "episode_x")
    out = []
    for e in range(1, 4):
        m = {k: float(g.normal()) for k in keys}
        m["frames"] = 4096 * e
        out.append((e, m))
    return out


def _accumulate(logdir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    ea = EventAccumulator(logdir)
    ea.Reload()
    return {t: [(e.step, e.value) for e in ea.Scalars(t)]
            for t in ea.Tags()["scalars"]}


@pytest.fixture(scope="module")
def event_dirs(tmp_path_factory):
    tdir = str(tmp_path_factory.mktemp("port"))
    jdir = str(tmp_path_factory.mktemp("jax"))
    t, j = tobs.TensorboardObserver(tdir), jobs.TensorboardObserver(jdir)
    for ep, m in _metrics(0):
        t.after_print_stats(ep, m)
        j.after_print_stats(ep, m)
    j.writer.close()
    t.writer.close()
    return tdir, jdir


def test_event_files_match_tensorboardx(event_dirs):
    tdir, jdir = event_dirs
    got, want = _accumulate(tdir), _accumulate(jdir)
    assert sorted(got) == sorted(want)
    assert {"losses/loss", "info/kl", "Episode/mean_return",
            "Episode/episode_x", "info/episode/episode/terrain_level"} <= set(
        got)
    for tag in want:
        assert got[tag] == want[tag], tag


def test_port_reader_reads_both_files(event_dirs):
    tdir, jdir = event_dirs
    want = _accumulate(jdir)
    for d in (tdir, jdir):
        got = tobs.read_scalars(d)
        assert sorted(got) == sorted(want)
        for tag in want:
            assert got[tag] == want[tag], (d, tag)
    name = [f for f in os.listdir(tdir) if "tfevents" in f][0]
    evs = tobs.read_events(os.path.join(tdir, name))
    assert evs[0]["file_version"] == "brain.Event:2"
    assert [e["step"] for e in evs[1:4]] == [4096] * 3


def test_reader_checks_every_crc(event_dirs, tmp_path):
    tdir, _ = event_dirs
    name = [f for f in os.listdir(tdir) if "tfevents" in f][0]
    buf = bytearray(open(os.path.join(tdir, name), "rb").read())
    assert tobs.crc32c(b"123456789") == 0xE3069283     # the check value
    for at, match in ((30, "data CRC"), (8, "length CRC")):
        bad = bytearray(buf)
        bad[at] ^= 0x01
        p = tmp_path / f"events.out.tfevents.bad{at}"
        p.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match=match):
            tobs.read_events(str(p))
    p = tmp_path / "events.out.tfevents.short"
    p.write_bytes(bytes(buf[:-3]))
    with pytest.raises(ValueError, match="truncated"):
        tobs.read_events(str(p))


@pytest.mark.parametrize("name", registry.task_names())
def test_config_snapshot_round_trips(name, tmp_path):
    cfg = {"global": dict(GLOBAL_DEFAULTS, task=name),
           "task": load_task_config(name), "train": load_train_config(name)}
    path = write_config_snapshot(str(tmp_path / "config.yaml"), cfg)
    with open(path) as f:
        got = yaml.safe_load(f)
    assert got == yaml.safe_load(yaml.safe_dump(cfg))
    assert dump_yaml(cfg) == open(path).read()


def test_yaml_scalars_read_back_as_pyyaml_reads_them():
    """Values PyYAML's resolver would take for another type, floats that
    need a dot, non-ASCII and control characters, empty and nested
    containers, tuples and non-string keys."""
    cfg = {"x": float("inf"), "nx": float("-inf"), "y": 1e-5, "z": "1e-5",
           "s": "yes", "o": "off", "n": None, "l": [], "d": {}, "e": "",
           "q": 'a: "b"\\', "big": 10 ** 20, "f": 3.0, "ff": 1e18,
           "u": "ünï\U0001f600", "t": (1, 2.5, [3, {"a": None}]),
           1: "k", "nested": {"a": {"b": [True, False]}}, "nl": "a\nb\tc",
           "null": "~", "np": np.float32(0.25), "ni": np.int64(7)}
    got = yaml.safe_load(dump_yaml(cfg))
    want = yaml.safe_load(yaml.safe_dump(
        {k: (v.item() if hasattr(v, "item") else v) for k, v in cfg.items()}))
    assert got == want
