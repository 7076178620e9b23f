"""The port's PBT (pbt/) against the JAX package's, on the CPU: the cases of
tests/test_pbt.py run on both packages (the same ``random.seed`` gives the
same mutations, the same workspace the same replacement and donor, the
launcher the same grid and population), the save / restore functions the
train entry point hands the observer (a donor's parameters restored
bit-equal), and a 3-process Cartpole population through the port's entry
point.
"""
import json
import os
import random
import subprocess
import sys

import pytest
import torch

from isaacgymenvs_ma_tpu.pbt import launcher as jlauncher
from isaacgymenvs_ma_tpu.pbt import mutation as jmutation
from isaacgymenvs_ma_tpu.pbt.pbt import PbtAlgoObserver as JObserver
from isaacgymenvs_ma_tpu_torch.pbt import launcher as tlauncher
from isaacgymenvs_ma_tpu_torch.pbt import mutation as tmutation
from isaacgymenvs_ma_tpu_torch.pbt.pbt import PbtAlgoObserver as TObserver

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _draws(mod, seed):
    random.seed(seed)
    out = []
    for _ in range(50):
        out += [mod.mutate_discount(0.99), mod.mutate_eps_clip(0.2),
                mod.mutate_mini_epochs(4), mod.mutate_float("1e-7"),
                mod.mutate_float_min_1(1.2)]
    out.append(mod.mutate(
        {"learning_rate": 3e-4, "gamma": 0.99, "mini_epochs": 4,
         "e_clip": 0.2, "tau": 0.95},
        dict(mod.DEFAULT_MUTATIONS), 0.5, 1.1, 1.5))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutations_match_jax(seed):
    t, j = _draws(tmutation, seed), _draws(jmutation, seed)
    assert t == j
    assert tmutation.DEFAULT_MUTATIONS == jmutation.DEFAULT_MUTATIONS
    for _ in range(50):
        assert 0.9 < t[0] < 0.9999 and 0.02 <= t[1] <= 0.4
        assert 1 <= t[2] <= 12


def _observer(cls, ws, idx, num=4):
    cfg = {"pbt": {
        "enabled": True, "policy_idx": idx, "num_policies": num,
        "workspace": str(ws), "interval_steps": 100,
        "start_after": 0, "initial_delay": 0,
        "replace_fraction_worst": 0.25, "replace_fraction_best": 0.5,
        "replace_threshold_frac_std": 0.1,
        "params": {"learning_rate": 3e-4, "gamma": 0.99},
    }}
    train_cfg = {"params": {"config": {"learning_rate": 3e-4,
                                       "gamma": 0.99}}}
    obs = cls(cfg, train_cfg,
              checkpoint_fn=lambda p: open(p, "w").write("x"),
              restore_fn=lambda p: None)
    restarts = []
    obs._restart = lambda ckpt, params: restarts.append((ckpt, params))
    return obs, restarts


def _population(cls, ws, objectives, seed):
    random.seed(seed)
    members = [_observer(cls, ws, i, len(objectives))
               for i in range(len(objectives))]
    for (obs, _), o in zip(members, objectives):
        obs.after_steps(1, 200, {"true_objective": o})
    out = []
    for (obs, restarts), o in zip(members, objectives):
        obs.after_steps(2, 400, {"true_objective": o})
        out.append([(os.path.relpath(c, ws), p) for c, p in restarts])
    return out


@pytest.mark.parametrize("objectives", [(1.0, 5.0, 6.0, 7.0),
                                        (3.0, 2.9, 9.0, 9.5, 8.0, 0.5),
                                        (1.0, 1.0, 1.0, 1.0)])
@pytest.mark.parametrize("seed", [0, 7])
def test_replacement_and_donor_match_jax(objectives, seed, tmp_path):
    """The same workspace gives the same decision: who replaces itself,
    from which donor's checkpoint, with which mutated parameters; the
    worst never replaces the best, equal objectives replace nobody."""
    t = _population(TObserver, tmp_path / "port", objectives, seed)
    j = _population(JObserver, tmp_path / "jax", objectives, seed)
    assert t == j
    best = max(range(len(objectives)), key=lambda i: objectives[i])
    assert not t[best]
    if len(set(objectives)) == 1:
        assert not any(t)
    else:
        worst = min(range(len(objectives)), key=lambda i: objectives[i])
        assert t[worst], "the worst member did not restart"
        meta = json.load(open(tmp_path / "port" / (t[worst][0][0] + ".json")))
        assert meta["params"] == {"learning_rate": 3e-4, "gamma": 0.99}


def test_launcher_grid_and_population_match_jax():
    grid = [("lr", [1e-4, 3e-4]), ("gamma", [0.99, 0.995])]
    assert (list(tlauncher.ParamGrid(grid).generate_params())
            == list(jlauncher.ParamGrid(grid).generate_params()))
    for mod in (tlauncher, jlauncher):
        e = mod.Experiment("sweep", "python train.py task=Ant",
                           mod.ParamGrid(grid))
        cmds = list(e.generate_experiments())
        assert len(cmds) == 4 and cmds[1][0].endswith("lr=0.0001 gamma=0.995")
    t = list(tlauncher.pbt_population("Ant", 3, "/ws", ["num_envs=64"],
                                      python="py").generate_experiments())
    j = list(jlauncher.pbt_population("Ant", 3, "/ws", ["num_envs=64"],
                                      python="py").generate_experiments())
    assert [(c.replace("py -m isaacgymenvs_ma_tpu_torch.train",
                       "py train.py"), n, e) for c, n, e in t] == j
    assert "pbt.policy_idx=2" in t[2][0] and "num_envs=64" in t[0][0]
    pl = [{"a": 1}, {"a": 2}]
    assert (list(tlauncher.ParamList(pl).generate_params())
            == list(jlauncher.ParamList(pl).generate_params()))


def test_slurm_script_matches_jax(tmp_path):
    rd = [mod.RunDescription("r", [mod.Experiment(
        "x", "python train.py", mod.ParamList([{"a": 1}, {"a": 2}]))])
        for mod in (tlauncher, jlauncher)]
    t = tlauncher.emit_slurm_script(rd[0], str(tmp_path), out=str(
        tmp_path / "t.sbatch"))
    j = jlauncher.emit_slurm_script(rd[1], str(tmp_path), out=str(
        tmp_path / "j.sbatch"))
    assert open(t).read() == open(j).read()


def test_save_and_restore_functions_restore_the_donor(tmp_path):
    """The functions the entry point hands ``PbtAlgoObserver``
    (``checkpoint.save_agent`` / ``load_agent``): a member restored from
    a donor's checkpoint holds the donor's parameters bit for bit."""
    from isaacgymenvs_ma_tpu_torch.learning import checkpoint as ckpt
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config)
    from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
    from isaacgymenvs_ma_tpu_torch.tasks.cartpole import Cartpole, TASK_CFG
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    tcfg = train_default_config("Cartpole")
    tcfg["params"]["config"].update(horizon_length=8, minibatch_size=64)
    agents = []
    for seed in (1, 2):
        task = Cartpole(deep_merge(TASK_CFG, {"env": {"numEnvs": 16}}),
                        device="cpu", seed=seed)
        a = PPOAgent(task, tcfg, seed=seed)
        a.init()
        a.train_epoch()
        agents.append((a, task))
    (donor, dtask), (member, mtask) = agents
    obs = TObserver({"pbt": {"enabled": True, "workspace": str(tmp_path),
                             "params": {}}}, tcfg,
                    lambda p: ckpt.save_agent(p, donor, dtask),
                    lambda p: ckpt.load_agent(p, member, mtask))
    obs._save(200, 1.0)
    path = os.path.join(obs.p.policy_dir, f"{200:012d}.ckpt")
    assert os.path.exists(path + ".json")
    obs.restore_fn(path)
    for (k, p), q in zip(donor.net.named_parameters(),
                         member.net.parameters()):
        assert torch.equal(p, q), k
    assert torch.equal(donor.env_state.sim.q, member.env_state.sim.q)


def test_three_process_population_exchange(tmp_path):
    """Three ``python -m isaacgymenvs_ma_tpu_torch.train`` members share a
    workspace (tests/test_pbt_population.py's run, on the port): each
    publishes checkpoints with their json metas, each restarts once with
    mutated seed parameters, the sabotaged member 0 (learning rate 1e-7,
    fixed: the adaptive schedule would raise it) replaces itself from a
    better one's checkpoint and every member finishes.  Members 1 and 2
    are held out of replacement (an absolute threshold no gap reaches) and
    member 0 is replaced only by a donor at least four times as good:
    where any gap replaces the worst, whoever is worst after each restart
    is replaced again (a restart runs ``max_iterations`` epochs anew, as in
    the JAX entry point), and a member restarted without end here.

    The run's outcome is fixed, whatever the processes' relative speed
    under load: ``pbt.seed`` seeds every member's mutations, and member 0
    waits at each replacement check (``pbt.sync_timeout``) until members
    1 and 2 have published a checkpoint at its frame count or finished,
    so each check reads the same donor checkpoints.  Without the wait, the
    load decided which donor checkpoints member 0 saw (none yet, a few
    early ones, or all), hence whether, from which checkpoint and how
    often it was replaced within its 240 s."""
    ws = str(tmp_path / "ws")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_FLAGS", "JAX_", "PBT_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    try:
        for idx in range(3):
            args = [
                sys.executable, "-m", "isaacgymenvs_ma_tpu_torch.train",
                "task=Cartpole", "num_envs=32", "max_iterations=40",
                "sim_device=cpu", f"seed={idx + 1}",
                f"experiment=pbt_pop_{idx}",
                "train.params.config.minibatch_size=128",
                "train.params.config.horizon_length=8",
                "train.params.config.save_frequency=0",
                "pbt.enabled=true", f"pbt.policy_idx={idx}",
                "pbt.num_policies=3", f"pbt.workspace={ws}",
                "pbt.interval_steps=1024", "pbt.start_after=5120",
                "pbt.initial_delay=5120",
                "pbt.replace_fraction_worst=0.34",
                "pbt.replace_fraction_best=0.34",
                "pbt.replace_threshold_frac_std=0.0", "pbt.seed=7",
                "pbt.sync_timeout=" + ("150" if idx == 0 else "0"),
                "pbt.replace_threshold_frac_absolute="
                + ("0.75" if idx == 0 else "1e9"),
                "pbt.params.learning_rate=" + ("1e-7" if idx == 0
                                               else "3e-4"),
            ] + (["train.params.config.lr_schedule=fixed"] if idx == 0
                 else [])
            procs.append(subprocess.Popen(
                args, env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for idx in range(3):
        pdir = os.path.join(ws, f"policy_{idx:02d}")
        metas = [f for f in os.listdir(pdir) if f.endswith(".ckpt.json")]
        assert metas, f"policy {idx} never published a checkpoint"
        meta = json.load(open(os.path.join(pdir, sorted(metas)[-1])))
        assert "true_objective" in meta and "params" in meta
    assert all("[pbt] initial mutation restart" in o for o in outs)
    assert "replaced by policy" in outs[0], outs[0][-3000:]
    restart = outs[0].split("[pbt] restarting:")[1]
    assert "checkpoint=" in restart.split("\n")[0]
    assert "restored checkpoint" in restart and "saved" in restart
