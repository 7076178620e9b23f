"""The port's train entry point with the flags of the JAX ``train.py``
that it used to refuse, on the CPU at 16 envs (Cartpole, horizon 8):
``pbt.enabled``, ``capture_video``, ``wandb_activate``, ``headless=False``
and ``multi_gpu`` (2 gloo ranks under ``torch.distributed.run``), with the
run directory's ``config.yaml`` snapshot and TensorBoard summaries, the
epoch line's task diagnostics and ``sigma=`` on a restore."""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from isaacgymenvs_ma_tpu_torch import train as ptrain
from isaacgymenvs_ma_tpu_torch.learning import checkpoint as ckpt
from isaacgymenvs_ma_tpu_torch.utils.observers import read_scalars

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["task=Cartpole", "num_envs=16", "sim_device=cpu", "log_interval=1",
        "train.params.config.horizon_length=8",
        "train.params.config.minibatch_size=64"]


def _run_dir(tmp_path):
    (d,) = list((tmp_path / "runs").glob("Cartpole_*"))
    return d


def test_snapshot_and_summaries_land_in_the_run_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    agent = ptrain.launch(BASE + ["max_iterations=2", "seed=7"])
    d = _run_dir(tmp_path)
    assert agent.run_dir == os.path.join("runs", d.name)
    cfg = yaml.safe_load(open(d / "config.yaml"))
    assert set(cfg) == {"global", "task", "train"}
    assert cfg["global"]["seed"] == 7 and cfg["task"]["env"]["numEnvs"] == 16
    assert cfg["train"]["params"]["config"]["horizon_length"] == 8
    sc = read_scalars(str(d / "summaries"))
    assert [s for s, _ in sc["losses/loss"]] == [128, 256]
    assert {"Episode/mean_return", "info/kl", "info/lr"} <= set(sc)
    assert (d / "nn" / "Cartpole.pth").exists()


def test_pbt_writes_checkpoint_and_meta(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PBT_RESTARTED", raising=False)
    ws = tmp_path / "ws"
    ptrain.launch(BASE + ["max_iterations=2", "pbt.enabled=True",
                          f"pbt.workspace={ws}", "pbt.policy_idx=1",
                          "pbt.interval_steps=100"])
    pdir = ws / "policy_01"
    metas = sorted(pdir.glob("*.ckpt.json"))
    assert [m.name for m in metas] == ["000000000128.ckpt.json",
                                       "000000000256.ckpt.json"]
    meta = json.load(open(metas[-1]))
    assert meta["iteration"] == 256 and "true_objective" in meta
    state, _, cmeta = ckpt.load_checkpoint(meta["checkpoint"])
    assert cmeta["num_envs"] == 16 and state["frames"] == 256


def test_capture_video_writes_frames(tmp_path, monkeypatch):
    """Ant (Cartpole's pole stays out of the default camera's view): a
    side rollout of 4 frames every 8 env steps, PNG frames without
    imageio, consecutive frames differ, and training goes on as it does
    without the video."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "imageio", None)   # the PNG fallback
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    ant = ["task=Ant"] + BASE[1:] + ["max_iterations=2", "seed=3"]
    straight = ptrain.launch(ant + ["experiment=straight"])
    agent = ptrain.launch(ant + ["capture_video=True",
                                 "capture_video_freq=8",
                                 "capture_video_len=4"])
    (d,) = list((tmp_path / "runs").glob("Ant_*"))
    vids = sorted((d / "videos").iterdir())
    assert [v.name for v in vids] == ["step_16", "step_8"]
    frames = sorted(vids[1].glob("frame_*.png"))
    assert len(frames) == 4
    data = [f.read_bytes() for f in frames]
    assert all(a != b for a, b in zip(data, data[1:]))
    for (k, p), q in zip(agent.net.named_parameters(),
                         straight.net.parameters()):
        assert torch.equal(p, q), k


def test_wandb_warns_and_runs(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "wandb", None)
    agent = ptrain.launch(BASE + ["max_iterations=1", "wandb_activate=True"])
    assert "wandb not installed" in capsys.readouterr().out
    assert agent.epoch == 1


def test_sigma_applied_on_restore_and_viewer_needs_a_gui(tmp_path,
                                                        monkeypatch, capsys):
    import matplotlib
    matplotlib.use("Agg")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(ptrain, "PLAY_STEPS", 20)
    agent = ptrain.launch(BASE + ["max_iterations=1"])
    path = str(_run_dir(tmp_path) / "nn" / "Cartpole.pth")
    played = ptrain.launch(BASE + ["test=True", f"checkpoint={path}",
                                   "sigma=0.25"])
    assert "sigma overridden to 0.25" in capsys.readouterr().out
    assert torch.allclose(played.net.log_sigma,
                          torch.full((1,), math.log(0.25)))
    for k, v in agent.net.state_dict().items():
        if k != "log_sigma":
            assert torch.equal(v, played.net.state_dict()[k]), k
    with pytest.raises(RuntimeError, match="GUI matplotlib backend"):
        ptrain.launch(BASE + ["test=True", f"checkpoint={path}",
                              "headless=False"])
    # headless=False trains as before (the viewer opens only in play)
    assert ptrain.launch(BASE + ["max_iterations=1",
                                 "headless=False"]).epoch == 1


def test_epoch_line_carries_every_jax_diagnostic():
    m = {"mean_return": 1.0, "mean_length": 2.0, "kl": 0.01,
         "episode/consecutive_successes": 3.0}
    keys = [k for k, _ in ptrain._LINE_EXTRAS]
    m.update({k: float(i) for i, k in enumerate(keys)})
    line = ptrain.epoch_line(1, 2, m, 10.0)
    assert line.startswith("epoch 1/2 reward 1.00 len 2 kl 0.0100 succ 3.00")
    for i, (_, lbl) in enumerate(ptrain._LINE_EXTRAS):
        assert f" {lbl} {float(i):.2f}" in line
    assert [lbl for _, lbl in ptrain._LINE_EXTRAS] == [
        "cov", "rot", "lvl", "slp", "rgh", "str", "dsc", "stn", "npd", "dep",
        "disp", "fsm", "sig"]


def test_multi_gpu_two_gloo_ranks_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node=2`` on the CPU:
    one run directory, rank 0 alone prints and writes, and the checkpoint
    is full width (16 envs, world 2)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "RANK", "WORLD_SIZE",
                                "LOCAL_RANK", "MASTER_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "isaacgymenvs_ma_tpu_torch.train"]
        + BASE + ["max_iterations=2", "multi_gpu=True"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("epoch 2/2 reward") == 1
    assert "rank 1/2 backend gloo" in out.stdout
    d = _run_dir(tmp_path)
    state, _, meta = ckpt.load_checkpoint(str(d / "nn" / "Cartpole.pth"))
    assert (meta["num_envs"], meta["world"]) == (16, 2)
    assert state["env_state"]["sim.q"].shape[0] == 16
    assert len(state["rank_generators"]) == 2
    assert np.isfinite(state["mean_return"].item())
