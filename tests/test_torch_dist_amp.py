"""AMP over torch.distributed ranks (learning/amp.py with ``dist``) on the
CPU: a 2-rank gloo run on 127.0.0.1 started with torch.multiprocessing
(tests/test_torch_dist_worker.py), held to the JAX capture and to the
1-process port.

The epoch of tests/data/torch_port/amp_epoch.npz (HumanoidAMP at 8 envs,
4 a rank, horizon 8, one minibatch of 64 rows (32 a rank), amp_batch_size
32 (16 a rank), the JAX learner's third epoch, so the replay joins the
discriminator batch) from the state it started from, with every draw
injected: each rank's action noise and reset draws its envs' rows, its
permutations its rows of the global ones, and the discriminator phase's
demo, agent and replay draws the global ones (the agent indices over the
global ``horizon x 8`` rows).  Held to the capture at
tests/test_torch_amp.py's ``EPOCH_TOL`` and to the 1-process port at
``ONE_PROCESS_TOL``; both ranks end with equal parameters,
discriminators, ``amp_rms`` and replay rings (bit for bit) and digests.
"""
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu_torch.learning.configs import train_default_config

import test_torch_dist_worker as worker
from test_torch_amp import (EPOCH, EPOCH_ENVS, EPOCH_SEED, EPOCH_TOL, UNITS,
                            _close, _learner)
from test_torch_amp import amp_epoch  # noqa: F401  (the 1-process epoch)
from test_torch_dist import _local_perm

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

WORLD, N = 2, EPOCH_ENVS
# the 2-rank epoch against the 1-process port on the same inputs: the
# engine's batched products over 4 envs a rank round otherwise than over
# 8, and HumanoidAMP's contact-rich steps amplify that over the horizon
# (the capture's own bounds are 2e-3); the global moments are sums over
# ranks, the updates' gradients means of the ranks' halves.  Measured on
# the CPU: rollout 5.0e-4 (values; obs 2.8e-4, AMP obs 3.1e-4), advantages
# 3.7e-4, metrics 2.3e-4 relative (kl; the losses 1.2e-5), parameters
# 3.0e-8, discriminator 7.5e-9, normalisers 2.3e-5 (a variance) and 4e-6
# relative, replay 3.1e-4; bounds about four times the rollout's and ten
# times the learners'
ONE_PROCESS_TOL = {"roll": 2e-3, "adv": 2e-3, "metrics_rtol": 1e-3,
                   "params": 3e-7, "rms_rtol": 4e-5, "rms_atol": 1e-5,
                   "aux": 2e-3}
ROLL = ("obs", "actions", "mu", "neglogp", "values", "rewards", "aux")


def _tensors(x):
    if isinstance(x, np.ndarray):
        return torch.tensor(x)
    if isinstance(x, dict):
        return {k: _tensors(v) for k, v in x.items()}
    return x


def _cfg():
    cfg = train_default_config("HumanoidAMP")
    cfg["params"]["config"].update(minibatch_size=64, horizon_length=8,
                                   amp_batch_size=32)
    cfg["params"]["network"]["mlp"]["units"] = list(UNITS)
    return cfg


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = np.load(EPOCH)
    T = d["noise"].shape[0]
    t = lambda k: torch.as_tensor(d[k])  # noqa: E731
    perms = t("perms").long()
    tmp = tmp_path_factory.mktemp("amp_epoch")
    path = str(tmp / "inputs.pt")
    torch.save({
        "n": N, "seed": EPOCH_SEED, "train_cfg": _cfg(),
        "state": _tensors(_learner(d, "init_")), "noise": t("noise"),
        "draws": [(t("motion_ids")[i], t("motion_times")[i])
                  for i in range(T)],
        "perms": [torch.stack([_local_perm(p, r, T, N) for p in perms])
                  for r in range(WORLD)],
        "amp_draws": {"demo": (t("demo_ids"), t("demo_times")),
                      "replay_idx": t("replay_idx"),
                      "agent_idx": t("agent_idx")}}, path)
    worker.spawn(worker.amp_epoch_rank, WORLD, path, str(tmp))
    ranks = [torch.load(str(tmp / f"amp_rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    out = dict(ranks[0])
    out["roll"] = {k: torch.cat([r["roll"][k] for r in ranks], 1)
                   for k in ranks[0]["roll"]}
    for k in ("adv", "ret"):
        out[k] = torch.cat([r[k] for r in ranks], 1)
    out["q"] = torch.cat([r["q"] for r in ranks])
    return d, out, ranks


def test_two_rank_epoch_matches_capture(two_ranks):
    """The 2-rank epoch (the ranks' rollouts joined along the envs)
    against the capture at ``EPOCH_TOL``: the rollout with its AMP obs and
    style rewards, the advantages and returns, the metrics (the
    discriminator's loss, BCE, R1 penalty and accuracies among them), the
    parameters and discriminator after, the normalisers, the replay ring
    and the env state."""
    d, two, _ = two_ranks
    for f in ROLL:
        _close(two["roll"][f], d[f"roll_{f}"], EPOCH_TOL[f], f)
    np.testing.assert_array_equal(two["roll"]["dones"].numpy(),
                                  d["roll_dones"])
    _close(two["adv"], d["adv"], EPOCH_TOL["adv"], "advantages")
    _close(two["ret"], d["returns"], EPOCH_TOL["returns"], "returns")
    keys = [k[len("metric_"):] for k in d.files if k.startswith("metric_")]
    for k in ("disc_loss", "disc_bce", "disc_grad_penalty",
              "disc_acc_agent", "disc_acc_demo"):
        assert k in keys
    m = two["metrics"]
    for k in keys:
        if k == "frames":
            assert m[k] == int(d["metric_frames"])
            continue
        np.testing.assert_allclose(m[k], float(d[f"metric_{k}"]),
                                   rtol=EPOCH_TOL["metrics_rtol"], atol=1e-6,
                                   err_msg=k)
    want = _learner(d, "after_")
    for which in ("net", "disc"):
        assert two[which].keys() == want[which].keys()
        for k, v in want[which].items():
            _close(two[which][k], v.numpy(), EPOCH_TOL["params"],
                   f"{which}.{k}")
    for which in ("obs_rms", "value_rms", "amp_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(
                two["rms"][which][f].numpy(), want[which][f].numpy(),
                rtol=EPOCH_TOL["rms_rtol"], atol=EPOCH_TOL["rms_atol"],
                err_msg=f"{which}.{f}")
    assert two["replay_n"] == int(d["after_replay_n"]) == 96
    _close(two["replay"], d["after_replay"], EPOCH_TOL["aux"], "replay")
    _close(two["q"], d["after_env_q"], 2e-4, "q after")


def test_two_rank_epoch_matches_one_process(two_ranks, amp_epoch):
    """The same epoch against the 1-process port at ``ONE_PROCESS_TOL``."""
    _, two, _ = two_ranks
    _, agent, seen, m = amp_epoch
    tol = ONE_PROCESS_TOL
    for f in ROLL:
        got, want = two["roll"][f], getattr(seen["roll"], f)
        assert float((got - want).abs().max()) <= tol["roll"], f
    assert torch.equal(two["roll"]["dones"], seen["roll"].dones)
    assert float((two["adv"] - seen["adv"]).abs().max()) <= tol["adv"]
    assert float((two["ret"] - seen["returns"]).abs().max()) <= tol["adv"]
    for k, v in m.items():
        np.testing.assert_allclose(two["metrics"][k], float(v),
                                   rtol=tol["metrics_rtol"], atol=1e-7,
                                   err_msg=k)
    for which, net in (("net", agent.net), ("disc", agent.disc)):
        for k, v in net.state_dict().items():
            assert float((two[which][k] - v).abs().max()) <= tol["params"], \
                (which, k)
    for which in ("obs_rms", "value_rms", "amp_rms"):
        for f in ("mean", "var", "count"):
            np.testing.assert_allclose(
                two["rms"][which][f].numpy(),
                getattr(getattr(agent, which), f).numpy(),
                rtol=tol["rms_rtol"], atol=tol["rms_atol"],
                err_msg=f"{which}.{f}")
    assert two["replay_n"] == agent.replay_n
    assert float((two["replay"] - agent.replay[: agent.replay_n]).abs()
                 .max()) <= tol["aux"]


def test_two_ranks_bit_equal(two_ranks):
    """Both ranks end with the same parameters, discriminator, ``amp_rms``
    and replay ring, bit for bit, and equal digests (the learner's Adam
    states and normalisers included)."""
    _, _, ranks = two_ranks
    a, b = ranks
    assert a["digest"] == b["digest"]
    for which in ("net", "disc"):
        for k, v in a[which].items():
            assert torch.equal(v, b[which][k]), (which, k)
    for which in ("obs_rms", "value_rms", "amp_rms"):
        for f, v in a["rms"][which].items():
            assert torch.equal(v, b["rms"][which][f]), (which, f)
    assert a["replay_n"] == b["replay_n"]
    assert torch.equal(a["replay"], b["replay"])
    assert not torch.equal(a["q"], b["q"])
    assert a["metrics"] == b["metrics"]
