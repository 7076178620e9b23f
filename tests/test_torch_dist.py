"""Data parallelism of the port (parallel/mesh.py) on the CPU: 2-rank gloo
runs on 127.0.0.1, started with torch.multiprocessing
(tests/test_torch_dist_worker.py), held to the JAX package and to the
1-process port.

* Cartpole-64 PPO epoch, 32 envs a rank, from JAX's state after its first
  epoch with JAX's draws rebuilt from its keys (``run_epoch_pair``'s setup,
  tests/test_torch_ppo_epoch.py), each rank taking its half.  The minibatch
  is the whole batch: with more than one, JAX's global permutation does
  not give each rank an equal share of every minibatch, so no per-rank
  split can match it.  The rollout, advantages, metrics, ``lr``,
  parameters and normalisers are held to JAX at ``CARTPOLE_TOL`` and to
  the 1-process port at ``ONE_PROCESS_TOL``; the ranks end with equal
  parameter and Adam digests.
* Two minibatches: the 2-rank port against the 1-process port given a
  global permutation in which each minibatch takes equal shares of both
  ranks' rows (the ranks' own permutations, side by side).
* The MA split: FrankaReachMA at 8 envs x 2 arms, each rank's step equals
  its half of the 1-process step, each env's two agent rows on its rank.
* Checkpoints: a 2-rank checkpoint resumes in one process, and a
  1-process checkpoint in 2 ranks, each taking its slice.
* Refusals, and ``dryrun_multiproc(2)``.
"""
import copy
import os

import jax
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.learning.configs import train_default_config
from isaacgymenvs_ma_tpu.learning.ppo import PPOAgent as JPPO
from isaacgymenvs_ma_tpu.utils.config import deep_merge as jdeep_merge
from isaacgymenvs_ma_tpu_torch import train as ptrain
from isaacgymenvs_ma_tpu_torch.convert import ppo_state_from_jax
from isaacgymenvs_ma_tpu_torch.learning import checkpoint as ckpt
from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
from isaacgymenvs_ma_tpu_torch.parallel import mesh

import test_torch_dist_worker as worker
from test_torch_ppo import jax_action_noise, jax_learner_arrays
from test_torch_ppo_epoch import (CARTPOLE_TOL, METRICS, cartpole_draws,
                                  jax_reset_draws)

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

N, SEED, WORLD = 64, 3, 2
# the 2-rank port against the 1-process port on the same inputs: sums
# split over ranks and the global moments taken as sums change only the
# float32 rounding (measured on the CPU at one minibatch: rollout,
# advantages and returns bit-equal, metrics within 3.7e-7 relative (a_loss),
# parameters 6.0e-8, normalisers 1.2e-7 relative); bounds about ten times
# that
ONE_PROCESS_TOL = {"roll": 1e-6, "adv": 1e-6, "metrics_rtol": 5e-6,
                   "params": 1e-6, "rms_rtol": 1e-6}


def _tensors(x):
    if isinstance(x, np.ndarray):
        return torch.tensor(x)
    if isinstance(x, dict):
        return {k: _tensors(v) for k, v in x.items()}
    return x


def _local_perm(perm, rank, T, B):
    """The rows of ``rank`` in the global (T * B) permutation ``perm``, in
    its order, as that rank's local row indices."""
    bl = B // WORLD
    t, b = perm // B, perm % B
    mine = (b >= rank * bl) & (b < (rank + 1) * bl)
    return t[mine] * bl + (b[mine] - rank * bl)


@pytest.fixture(scope="module")
def epoch_inputs():
    """JAX's Cartpole-64 epochs 1-2 at one minibatch, and the inputs of the
    port's second epoch: the learner state after JAX's first, the action
    noise, reset draws and permutations of JAX's second."""
    from isaacgymenvs_ma_tpu.tasks.cartpole import Cartpole as JCartpole
    from isaacgymenvs_ma_tpu.tasks.cartpole import TASK_CFG as JCFG
    tcfg = train_default_config("Cartpole")
    horizon = tcfg["params"]["config"]["horizon_length"]
    tcfg["params"]["config"]["minibatch_size"] = N * horizon
    jtask = JCartpole(jdeep_merge(JCFG, {"env": {"numEnvs": N}}))
    ja = JPPO(jtask, tcfg, seed=SEED)
    st, _ = ja.train_epoch(ja.init())

    @jax.jit
    def rollout_gae(state):
        s2, roll, last_obs, stats = ja._rollout(state)
        adv, ret = ja._gae(s2, roll, last_obs)
        return roll, adv, ret
    jroll, jadv, jret = rollout_gae(st)
    st2, jm = ja.train_epoch(st)
    T, B, A = ja.horizon, jtask.rl_games_batch, jtask.num_actions
    noise, key = jax_action_noise(st.key, T, B, A)
    _, k_perm = jax.random.split(key)
    perms = torch.tensor(np.stack([
        np.asarray(jax.random.permutation(k, T * B))
        for k in jax.random.split(k_perm, ja.cfg.mini_epochs)]))
    es = st.env_state
    d = ppo_state_from_jax(jax_learner_arrays(st))
    d["env_state"] = {"sim.q": np.asarray(es.sim.q),
                      "sim.qd": np.asarray(es.sim.qd),
                      "progress": np.asarray(es.progress),
                      "reset_buf": np.asarray(es.reset_buf)}
    return {"train_cfg": tcfg, "state": _tensors(d), "noise": noise,
            "draws": jax_reset_draws(es.rng, T, N, cartpole_draws),
            "perms": perms, "T": T, "B": B,
            "jax": dict(roll=jroll, adv=jadv, ret=jret, metrics=jm,
                        net=ppo_state_from_jax(jax_learner_arrays(st2))[
                            "net"],
                        obs_rms=st2.obs_rms, value_rms=st2.value_rms)}


def _one_process(inp, perms):
    """The 1-process port's epoch on the same inputs."""
    from isaacgymenvs_ma_tpu_torch.tasks.cartpole import Cartpole, TASK_CFG
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    task = Cartpole(deep_merge(TASK_CFG, {"env": {"numEnvs": N}}),
                    device="cpu", seed=SEED)
    pa = PPOAgent(task, inp["train_cfg"], seed=SEED)
    pa.init()
    pa.load_state_dict(copy.deepcopy(inp["state"]))
    roll, last_obs, stats = pa._rollout(inp["noise"], inp["draws"])
    adv, ret = pa._gae(roll, last_obs)
    m = pa._update(roll, adv, ret, perms)
    m["episodes_done"] = stats["episodes_done"]
    return dict(roll=roll._asdict(), adv=adv, ret=ret,
                metrics={k: (v if isinstance(v, int) else float(v))
                         for k, v in m.items()},
                net=dict(pa.net.state_dict()),
                obs_rms=pa.obs_rms.state_dict(),
                value_rms=pa.value_rms.state_dict())


def _two_ranks(inp, local_perms, tmp_path, train_cfg=None):
    """The 2-rank epoch: every rank's output, then rank 0's metrics,
    parameters and normalisers with the per-row outputs joined in rank
    order (the rollout along B, advantages and returns along B)."""
    path = str(tmp_path / "inputs.pt")
    torch.save({"task": "Cartpole", "n": N, "seed": SEED,
                "train_cfg": train_cfg or inp["train_cfg"],
                "state": inp["state"], "noise": inp["noise"],
                "draws": inp["draws"], "perms": local_perms}, path)
    worker.spawn(worker.epoch_rank, WORLD, path, str(tmp_path))
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    out = dict(ranks[0])
    out["roll"] = {k: (None if v is None else torch.cat(
        [r["roll"][k] for r in ranks], 1)) for k, v in ranks[0]["roll"].items()
        if not isinstance(v, tuple)}
    out["adv"] = torch.cat([r["adv"] for r in ranks], 1)
    out["ret"] = torch.cat([r["ret"] for r in ranks], 1)
    return out, ranks


def _err(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    return float(np.abs(a.astype(np.float64) - np.asarray(b)).max())


@pytest.fixture(scope="module")
def one_minibatch(epoch_inputs, tmp_path_factory):
    inp = epoch_inputs
    T, B = inp["T"], inp["B"]
    local = [torch.stack([_local_perm(p, r, T, B) for p in inp["perms"]])
             for r in range(WORLD)]
    two, ranks = _two_ranks(inp, local, tmp_path_factory.mktemp("epoch1"))
    return {"two": two, "ranks": ranks,
            "one": _one_process(inp, inp["perms"]), "jax": inp["jax"]}


def test_two_rank_epoch_matches_jax(one_minibatch):
    """The 2-rank epoch against JAX's at CARTPOLE_TOL: the rollout, the
    advantages and returns, the metrics and ``lr``, the parameters and the
    normalisers; ``frames`` counts both ranks' samples."""
    two, j = one_minibatch["two"], one_minibatch["jax"]
    tol = CARTPOLE_TOL
    for f in ("obs", "actions", "mu", "neglogp", "values", "rewards"):
        assert _err(two["roll"][f], getattr(j["roll"], f)) <= tol[f], f
    np.testing.assert_array_equal(two["roll"]["dones"].numpy(),
                                  np.asarray(j["roll"].dones))
    assert int(two["roll"]["dones"].sum()) > 0
    assert _err(two["adv"], j["adv"]) <= tol["adv"]
    assert _err(two["ret"], j["ret"]) <= tol["returns"]
    for k in METRICS:
        np.testing.assert_allclose(two["metrics"][k], float(j["metrics"][k]),
                                   rtol=tol["metrics_rtol"], atol=1e-6,
                                   err_msg=k)
    assert two["metrics"]["frames"] == int(j["metrics"]["frames"])
    np.testing.assert_allclose(two["metrics"]["lr"], float(j["metrics"]["lr"]),
                               rtol=1e-6)
    for k, v in j["net"].items():
        assert _err(two["net"][k], v.numpy()) <= tol["params"], k
    for which in ("obs_rms", "value_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(
                two[which][f].numpy(), np.asarray(getattr(j[which], f)),
                rtol=tol["rms_rtol"], atol=1e-6, err_msg=f"{which}.{f}")


def test_two_rank_epoch_matches_one_process(one_minibatch):
    """The same epoch against the 1-process port at ONE_PROCESS_TOL, and
    the two ranks bit-equal: same parameters, Adam state and digests."""
    two, one, ranks = (one_minibatch["two"], one_minibatch["one"],
                       one_minibatch["ranks"])
    tol = ONE_PROCESS_TOL
    for f, v in two["roll"].items():
        if v is not None:
            assert _err(v, one["roll"][f]) <= tol["roll"], f
    assert _err(two["adv"], one["adv"]) <= tol["adv"]
    assert _err(two["ret"], one["ret"]) <= tol["adv"]
    for k in METRICS + ("lr",):
        np.testing.assert_allclose(two["metrics"][k], one["metrics"][k],
                                   rtol=tol["metrics_rtol"], atol=1e-7,
                                   err_msg=k)
    for k, v in one["net"].items():
        assert _err(two["net"][k], v) <= tol["params"], k
    for which in ("obs_rms", "value_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(two[which][f].numpy(),
                                       one[which][f].numpy(),
                                       rtol=tol["rms_rtol"], atol=1e-7)
    assert ranks[0]["digest"] == ranks[1]["digest"]
    for k in ranks[0]["net"]:
        assert torch.equal(ranks[0]["net"][k], ranks[1]["net"][k]), k


def test_two_minibatches_match_one_process(epoch_inputs, tmp_path):
    """Two minibatches a mini-epoch: each rank permutes its own rows, and
    the 1-process port is given the global permutation whose every
    minibatch is the two ranks' halves side by side, so both take the same
    rows into each update."""
    inp = dict(epoch_inputs)
    T, B = inp["T"], inp["B"]
    tcfg = copy.deepcopy(inp["train_cfg"])
    tcfg["params"]["config"]["minibatch_size"] = T * B // 2
    g = torch.Generator().manual_seed(11)
    E = tcfg["params"]["config"]["mini_epochs"]
    bl = B // WORLD
    local = [torch.stack([torch.randperm(T * bl, generator=g)
                          for _ in range(E)]) for _ in range(WORLD)]

    def to_global(idx, r):
        return (idx // bl) * B + r * bl + idx % bl
    half = T * bl // 2
    glob = torch.stack([torch.cat([
        torch.cat([to_global(local[r][e, k * half: (k + 1) * half], r)
                   for r in range(WORLD)]) for k in range(2)])
        for e in range(E)])
    inp["train_cfg"] = tcfg
    two, ranks = _two_ranks(inp, local, tmp_path, train_cfg=tcfg)
    one = _one_process(inp, glob)
    tol = ONE_PROCESS_TOL
    for k in METRICS + ("lr",):
        np.testing.assert_allclose(two["metrics"][k], one["metrics"][k],
                                   rtol=tol["metrics_rtol"], atol=1e-7,
                                   err_msg=k)
    for k, v in one["net"].items():
        assert _err(two["net"][k], v) <= tol["params"], k
    assert ranks[0]["digest"] == ranks[1]["digest"]


def test_ma_split_keeps_agents_together():
    """FrankaReachMA at 8 envs x 2 arms: rank r's task (its 4 envs from
    ``local_task_config``) stepped from its slice of the 1-process state
    (``slice_state``: the env leaves and the 16 agent rows) gives rows
    ``[8 r, 8 r + 8)`` of the 1-process step, both agents of each env."""
    from isaacgymenvs_ma_tpu_torch.learning.ppo import (
        env_state_arrays, env_state_from_arrays)
    from isaacgymenvs_ma_tpu_torch.tasks import registry
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    cfg = deep_merge(registry.task_default_config("FrankaReachMA"),
                     {"env": {"numEnvs": 8}})
    full = registry.create_task("FrankaReachMA", cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    st = full.initial_state()
    for _ in range(3):
        st, res = full.step(st, torch.tanh(torch.randn(16, 6, generator=g)))
    assert int(st.reset_buf.sum()) == 0          # no reset draws below
    a = torch.tanh(torch.randn(16, 6, generator=g))
    ref_st, ref = full.step(st, a)
    sd = {"env_state": env_state_arrays(st), "last_obs": res.obs}
    for r in range(WORLD):
        part = mesh.slice_state(sd, r, WORLD, 8, 16)
        task = registry.create_task(
            "FrankaReachMA", mesh.local_task_config(cfg, r, WORLD), seed=0,
            device="cpu")
        assert (task.num_envs, task.rl_games_batch) == (4, 8)
        local = env_state_from_arrays(part["env_state"],
                                      task.initial_state(), lambda x: x)
        assert torch.equal(part["last_obs"], res.obs[8 * r: 8 * r + 8])
        got_st, got = task.step(local, a[8 * r: 8 * r + 8])
        # batched products round otherwise at 4 envs than at 8 (measured:
        # at most one float32 ulp, 1.2e-7 on the obs)
        for f in ("obs", "rew"):
            torch.testing.assert_close(getattr(got, f),
                                       getattr(ref, f)[8 * r: 8 * r + 8],
                                       rtol=1e-5, atol=1e-6)
        assert torch.equal(got.reset, ref.reset[8 * r: 8 * r + 8])
        torch.testing.assert_close(got_st.sim.q, ref_st.sim.q[4 * r:
                                                              4 * r + 4],
                                   rtol=1e-5, atol=1e-6)


def test_checkpoint_two_ranks_to_one_process_and_back(tmp_path):
    """A 2-rank checkpoint (rank 0 gathers the env state) resumes in one
    process with the ranks' parameters and their env states joined in rank
    order; a 1-process checkpoint resumes in 2 ranks, each with its
    slice."""
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config as tdefault)
    from isaacgymenvs_ma_tpu_torch.tasks.cartpole import Cartpole, TASK_CFG
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    tcfg = tdefault("Cartpole")
    tcfg["params"]["config"].update(horizon_length=8, minibatch_size=64)
    worker.spawn(worker.ckpt_rank, WORLD, str(tmp_path), "save", tcfg)
    saved = [torch.load(str(tmp_path / f"save_rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    assert saved[0]["digest"] == saved[1]["digest"]
    task = Cartpole(deep_merge(TASK_CFG, {"env": {"numEnvs": 16}}),
                    device="cpu", seed=5)
    agent = PPOAgent(task, tcfg, seed=5)
    agent.init()
    _, meta = ckpt.load_agent(str(tmp_path / "ranks.pth"), agent, task)
    assert (meta["num_envs"], meta["world"]) == (16, WORLD)
    sd = agent.state_dict()
    for k, v in saved[0]["state"]["net"].items():
        assert torch.equal(sd["net"][k], v), k
    for k, v in sd["env_state"].items():
        assert torch.equal(v, torch.cat([s["state"]["env_state"][k]
                                         for s in saved])), k
    for k in ("last_obs", "ep_return", "ep_length"):
        assert torch.equal(sd[k], torch.cat([s["state"][k] for s in saved]))
    # and back: one more epoch in one process, then 2 ranks load it
    agent.train_epoch()
    ckpt.save_agent(str(tmp_path / "one.pth"), agent, task)
    one = agent.state_dict()
    worker.spawn(worker.ckpt_rank, WORLD, str(tmp_path), "load", tcfg)
    for r in range(WORLD):
        got = torch.load(str(tmp_path / f"load_rank{r}.pt"),
                         weights_only=False)["state"]
        for k, v in one["env_state"].items():
            assert torch.equal(got["env_state"][k], v[8 * r: 8 * r + 8]), k
        for k, v in one["net"].items():
            assert torch.equal(got["net"][k], v), k
        assert torch.equal(got["last_obs"], one["last_obs"][8 * r:
                                                            8 * r + 8])


def _sac_cfg(**config):
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config as tdefault)
    cfg = tdefault("AntSAC")
    cfg["params"]["config"].update(config)
    return cfg


_TORCHRUN = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}


@pytest.mark.parametrize("case", ["envs_not_divisible",
                                  "minibatch_not_divisible",
                                  "sac_batch_not_divisible",
                                  "amp_batch_not_divisible", "no_torchrun"])
def test_refusals(case, tmp_path, monkeypatch):
    """These raise before any process group is joined: a world that does
    not divide the envs, the minibatch, SAC's ``batch_size`` or AMP's
    ``amp_batch_size`` (all global), and ``multi_gpu`` without torchrun's
    variables (never one process instead)."""
    monkeypatch.chdir(tmp_path)
    for k, v in _TORCHRUN.items():
        if case == "no_torchrun":
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    args = ["multi_gpu=True", "sim_device=cpu", "max_iterations=1"]
    if case == "envs_not_divisible":
        monkeypatch.setenv("WORLD_SIZE", "3")
        with pytest.raises(ValueError, match="do not divide numEnvs"):
            ptrain.launch(args + ["task=Cartpole", "num_envs=64"])
    elif case == "minibatch_not_divisible":
        with pytest.raises(ValueError, match="minibatch_size"):
            ptrain.launch(args + ["task=Cartpole", "num_envs=64",
                                  "train.params.config.minibatch_size=511"])
        fake = type("FakeDist", (), {"world": 2})()
        from isaacgymenvs_ma_tpu_torch.tasks.cartpole import (Cartpole,
                                                              TASK_CFG)
        from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
        from isaacgymenvs_ma_tpu_torch.learning.configs import (
            train_default_config as tdefault)
        tcfg = tdefault("Cartpole")
        tcfg["params"]["config"].update(horizon_length=8, minibatch_size=63)
        task = Cartpole(deep_merge(TASK_CFG, {"env": {"numEnvs": 8}}),
                        device="cpu")
        with pytest.raises(ValueError, match="minibatch_size"):
            PPOAgent(task, tcfg, dist=fake)
    elif case == "sac_batch_not_divisible":
        with pytest.raises(ValueError, match="batch_size=255"):
            ptrain.launch(args + ["task=Ant", "train=AntSAC", "num_envs=8",
                                  "train.params.config.batch_size=255"])
        from isaacgymenvs_ma_tpu_torch.learning.sac import SACAgent
        from test_torch_dist_worker import ToyTask
        with pytest.raises(ValueError, match="batch_size=63"):
            SACAgent(ToyTask(0, 8), _sac_cfg(batch_size=63),
                     dist=type("FakeDist", (), {"world": 2})())
    elif case == "amp_batch_not_divisible":
        with pytest.raises(ValueError, match="amp_batch_size=33"):
            ptrain.launch(args + ["task=HumanoidAMP", "num_envs=8",
                                  "train.params.config.amp_batch_size=33"])
    else:
        with pytest.raises(RuntimeError, match="torchrun"):
            ptrain.launch(args + ["task=Cartpole", "num_envs=64"])
        with pytest.raises(RuntimeError, match="torchrun"):
            mesh.DataParallel.init(device="cpu", environ={})


def test_dryrun_multiproc():
    """``dryrun_multiproc(2)``: one PPO epoch of Ant, FrankaReachMA and
    the asymmetric ShadowHand over two gloo ranks, finite losses and equal
    digests on both ranks."""
    from isaacgymenvs_ma_tpu_torch.parallel.dryrun import dryrun_multiproc
    out = dryrun_multiproc(2)
    assert [r["task"] for r in out] == ["Ant", "FrankaReachMA",
                                        "ShadowHand"]
    assert all(np.isfinite(r["loss"]) and r["ranks"] == 2 for r in out)
    assert os.environ.get("RANK") is None
