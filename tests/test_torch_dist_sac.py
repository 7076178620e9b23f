"""SAC over torch.distributed ranks (learning/sac.py with ``dist``) on the
CPU: 2-rank gloo runs on 127.0.0.1 started with torch.multiprocessing
(tests/test_torch_dist_worker.py), held to the JAX package and to the
1-process port.

* The toy task of tests/test_torch_sac.py (16 envs, 8 a rank), one epoch
  from a fresh JAX state across the 5 seed steps (updates at steps 6-8,
  batch 64, 32 rows a rank) with JAX's draws injected: each rank's actions
  its rows of the global draws, the replay indices and the update's noise
  the global ones.  Held three ways: against the JAX epoch as
  test_torch_sac.py holds the 1-process port (its base bounds widened by
  four times the reference's own one-ulp spread, ROADMAP C15); against the
  1-process port at ``ONE_PROCESS_TOL``; and the two ranks bit-equal in
  the networks, the temperature, the three Adams, ``obs_rms`` and the
  replicated ring.
* Checkpoints (AntSAC at 8 envs): a 2-rank checkpoint resumes in one
  process with rank 0's learner and ring and the ranks' env states joined;
  a 1-process checkpoint resumes in 2 ranks, each with its slice and the
  whole ring, and the next epoch leaves both ranks bit-equal.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu_torch.convert import sac_state_from_jax
from isaacgymenvs_ma_tpu_torch.learning import checkpoint as ckpt
from isaacgymenvs_ma_tpu_torch.learning import sac as psac
from isaacgymenvs_ma_tpu_torch.learning.configs import (
    train_default_config as tdefault)

import test_torch_dist_worker as worker
from test_torch_sac import (PToy, _cfg, _check_learner, _epoch_draws, _held,
                            _jax_arrays, _np, _pair, _ulp_runs)
from test_torch_sac import jagent  # noqa: F401  (the JAX learner fixture)

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

WORLD, N = 2, worker.TOY_ENVS
# the 2-rank epoch against the 1-process port on the same draws: the seed
# steps' transitions are bit-equal (the global rows are the 1-process
# rows); from step 6 the actor's products over 8 rows a rank round
# otherwise than over 16, and the update's means over 32 rows a rank,
# averaged, otherwise than one mean over 64.  Measured on the CPU: ring
# rows 3.6e-7 (actions), obs_rms 1.0e-7 relative, parameters 3.0e-8,
# Adam moments 4.9e-7 of their largest entry, losses 7.6e-8 relative;
# bounds about ten times that
ONE_PROCESS_TOL = {"ring": 4e-6, "rms_rtol": 1e-6, "params": 3e-7,
                   "moments_rtol": 5e-6, "metrics_rtol": 1e-6}
SEED_ROWS = 5 * N           # the seed steps' transitions


def _learner(sd):
    """A 1-process toy agent holding the learner state ``sd`` (a rank's
    ``state_dict()``, its env state a (pos, t) dict)."""
    sd = dict(sd)
    env = sd.pop("env_state")
    pa = psac.SACAgent(PToy(), _cfg(), seed=0)
    pa.init()
    pa.load_state_dict(sd)
    pa.env_state = (env["pos"], env["t"])
    return pa


@pytest.fixture(scope="module")
def epoch(jagent, tmp_path_factory):
    st = jagent.init(jax.random.PRNGKey(5))
    draws = _epoch_draws(st, jagent)
    st2, jm = jagent.train_epoch(st)
    with pytest.MonkeyPatch.context() as mp:
        runs = _ulp_runs(jagent, st, mp)
    one = _pair(st)
    m1 = one.train_epoch(copy.deepcopy(draws))
    tmp = tmp_path_factory.mktemp("sac_epoch")
    path = str(tmp / "inputs.pt")
    torch.save({"train_cfg": _cfg(), "seed": 0,
                "state": sac_state_from_jax(_jax_arrays(st)),
                "env_state": tuple(torch.as_tensor(np.array(x))
                                   for x in st.env_state),
                "draws": draws}, path)
    worker.spawn(worker.sac_epoch_rank, WORLD, path, str(tmp))
    ranks = [torch.load(str(tmp / f"sac_rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    joined = dict(ranks[0]["state"])
    for k in ("ep_return", "last_obs"):
        joined[k] = torch.cat([r["state"][k] for r in ranks])
    joined["env_state"] = {k: torch.cat([r["state"]["env_state"][k]
                                         for r in ranks])
                           for k in ("pos", "t")}
    return {"st2": st2, "jm": jm, "runs": runs, "one": one, "m1": m1,
            "ranks": ranks, "two": _learner(joined)}


def test_two_rank_epoch_matches_jax(epoch):
    """The 2-rank epoch (rank 0's learner and ring, the ranks' episode
    returns joined) against JAX's, as test_torch_sac.py holds the
    1-process epoch: the losses, temperature and mean return, the
    networks, targets and Adam state, the ring, ``obs_rms`` and the
    trackers; ``frames`` counts both ranks' transitions."""
    two, st2, jm, runs = epoch["two"], epoch["st2"], epoch["jm"], \
        epoch["runs"]
    m = epoch["ranks"][0]["metrics"]
    assert epoch["ranks"][0]["step"] == int(st2.step) == 8
    assert m["frames"] == int(jm["frames"]) == 8 * N
    for k in ("critic_loss", "actor_loss", "alpha", "mean_return"):
        want = float(jm[k])
        _held(np.asarray(m[k]), want, 1e-5 * abs(want) + 1e-6, k,
              4 * max(abs(want - float(r[k])) for _, r in runs))
    _check_learner(two, st2, spread=[s for s, _ in runs])
    for k, v in _np(st2.buffer).items():
        np.testing.assert_allclose(two.buffer[k].numpy(), v, rtol=0,
                                   atol=1e-5, err_msg=k)
    assert two.buf_n == int(st2.buf_n) == 8 * N
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(two.obs_rms, f).numpy(),
                                   np.asarray(getattr(st2.obs_rms, f)),
                                   rtol=1e-6, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(two.ep_return.numpy(),
                               np.asarray(st2.ep_return), atol=1e-5)


def _moments(agent):
    out = {}
    for which, net in (("actor", agent.actor_optim), ("critic",
                                                     agent.critic_optim)):
        mod = getattr(agent, which)
        for name, p in mod.named_parameters():
            for f in ("exp_avg", "exp_avg_sq"):
                out[f"{which}.{name}.{f}"] = net.state[p][f]
    for f in ("exp_avg", "exp_avg_sq"):
        out[f"alpha.{f}"] = agent.alpha_optim.state[agent.log_alpha][f]
    return out


def test_two_rank_epoch_matches_one_process(epoch):
    """The same epoch against the 1-process port at ``ONE_PROCESS_TOL``:
    the seed steps' ring rows bit for bit, the rest of the ring,
    ``obs_rms``, the trackers, the networks, targets, temperature, Adam
    moments and losses within the bounds."""
    two, one = epoch["two"], epoch["one"]
    m2, m1 = epoch["ranks"][0]["metrics"], epoch["m1"]
    tol = ONE_PROCESS_TOL
    for k in ("critic_loss", "actor_loss", "alpha", "mean_return"):
        np.testing.assert_allclose(m2[k], float(m1[k]),
                                   rtol=tol["metrics_rtol"], atol=1e-7,
                                   err_msg=k)
    for k, v in one.buffer.items():
        assert torch.equal(two.buffer[k][:SEED_ROWS], v[:SEED_ROWS]), k
        assert float((two.buffer[k] - v).abs().max()) <= tol["ring"], k
    for f in ("mean", "var", "count"):
        np.testing.assert_allclose(getattr(two.obs_rms, f).numpy(),
                                   getattr(one.obs_rms, f).numpy(),
                                   rtol=tol["rms_rtol"], atol=1e-7,
                                   err_msg=f)
    for f in ("ep_return", "last_obs"):
        assert float((getattr(two, f) - getattr(one, f)).abs().max()) \
            <= tol["ring"], f
    assert two.buf_n == one.buf_n and two.step == one.step
    for which in ("actor", "critic", "target"):
        for k, v in getattr(one, which).state_dict().items():
            err = float((getattr(two, which).state_dict()[k] - v).abs().max())
            assert err <= tol["params"], (which, k, err)
    assert float((two.log_alpha - one.log_alpha).detach().abs()) \
        <= tol["params"]
    got, want = _moments(two), _moments(one)
    for k, v in want.items():
        scale = float(v.abs().max()) or 1.0
        err = float((got[k] - v).abs().max())
        assert err <= tol["moments_rtol"] * scale, (k, err / scale)


def test_two_ranks_bit_equal(epoch):
    """Both ranks end with the same networks, temperature, Adam state,
    ``obs_rms``, ring and counters: equal digests, and each leaf
    ``torch.equal``."""
    a, b = (r["state"] for r in epoch["ranks"])
    assert epoch["ranks"][0]["digest"] == epoch["ranks"][1]["digest"]
    for k in ("actor", "critic", "target", "obs_rms", "buffer"):
        for f, v in a[k].items():
            assert torch.equal(v, b[k][f]), (k, f)
    for k in ("actor_optim", "critic_optim"):
        for name, s in a[k].items():
            for f in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(s[f], b[k][name][f]), (k, name, f)
    for f in ("exp_avg", "exp_avg_sq"):
        assert torch.equal(a["alpha_optim"][f], b["alpha_optim"][f])
    assert torch.equal(a["log_alpha"], b["log_alpha"])
    assert torch.equal(a["mean_return"], b["mean_return"])
    assert (a["buf_n"], a["step"]) == (b["buf_n"], b["step"]) == (8 * N, 8)
    assert torch.equal(a["shared_generator"], b["shared_generator"])
    assert not torch.equal(a["ep_return"], b["ep_return"])


def _sac_cfg():
    cfg = tdefault("AntSAC")
    c = cfg["params"]["config"]
    c.update(batch_size=64, replay_buffer_size=1000)
    cfg["params"]["network"]["mlp"]["units"] = [32, 32]
    return cfg


def test_checkpoint_two_ranks_to_one_process_and_back(tmp_path):
    """A 2-rank AntSAC checkpoint resumes in one process: rank 0's
    networks, Adams, temperature and ring, the ranks' env states, last
    obs and episode returns joined in rank order.  A 1-process checkpoint
    resumes in 2 ranks, each with its slice and the whole ring, and one
    more epoch leaves the ranks bit-equal."""
    from isaacgymenvs_ma_tpu_torch.tasks import registry
    from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
    cfg = _sac_cfg()
    worker.spawn(worker.sac_ckpt_rank, WORLD, str(tmp_path), "save", cfg)
    saved = [torch.load(str(tmp_path / f"sac_save_rank{r}.pt"),
                        weights_only=False) for r in range(WORLD)]
    assert saved[0]["digest"] == saved[1]["digest"]
    assert saved[0]["buf_n"] == 8 * 8                 # 8 steps x 8 envs
    task = registry.create_task("AntSAC", deep_merge(
        registry.task_default_config("AntSAC"), {"env": {"numEnvs": 8}}),
        seed=5, device="cpu")
    agent = psac.SACAgent(task, cfg, seed=5)
    agent.init()
    _, meta = ckpt.load_agent(str(tmp_path / "sac_ranks.pth"), agent, task)
    assert (meta["num_envs"], meta["world"]) == (8, WORLD)
    sd, s0 = agent.state_dict(), saved[0]["state"]
    for which in ("actor", "critic", "target"):
        for k, v in s0[which].items():
            assert torch.equal(sd[which][k], v), (which, k)
    for k, v in s0["buffer"].items():
        assert torch.equal(sd["buffer"][k], v), k
    for name, s in s0["critic_optim"].items():
        assert torch.equal(sd["critic_optim"][name]["exp_avg"],
                           s["exp_avg"]), name
    assert torch.equal(sd["log_alpha"], s0["log_alpha"])
    assert (agent.buf_n, agent.step) == (s0["buf_n"], s0["step"])
    for k, v in sd["env_state"].items():
        assert torch.equal(v, torch.cat([s["state"]["env_state"][k]
                                         for s in saved])), k
    for k in ("last_obs", "ep_return"):
        assert torch.equal(sd[k], torch.cat([s["state"][k] for s in saved]))
    # and back: one more epoch in one process, then 2 ranks load it
    agent.train_epoch()
    ckpt.save_agent(str(tmp_path / "sac_one.pth"), agent, task)
    one = agent.state_dict()
    worker.spawn(worker.sac_ckpt_rank, WORLD, str(tmp_path), "load", cfg)
    got = [torch.load(str(tmp_path / f"sac_load_rank{r}.pt"),
                      weights_only=False) for r in range(WORLD)]
    for r, g in enumerate(got):
        ld = g["loaded"]
        for k, v in one["env_state"].items():
            assert torch.equal(ld["env_state"][k], v[4 * r: 4 * r + 4]), k
        assert torch.equal(ld["last_obs"], one["last_obs"][4 * r: 4 * r + 4])
        for which in ("actor", "critic", "target"):
            for k, v in one[which].items():
                assert torch.equal(ld[which][k], v), (which, k)
        for k, v in one["buffer"].items():
            assert torch.equal(ld["buffer"][k], v), k
        assert torch.equal(ld["shared_generator"], one["shared_generator"])
    assert got[0]["digest"] == got[1]["digest"]
    assert got[0]["buf_n"] == one["buf_n"] + 8 * 8
