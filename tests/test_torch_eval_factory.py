"""The port's Factory lift evaluation (isaacgymenvs_ma_tpu_torch/
eval_factory_lift.py) on the CPU, three ways: a FactoryTaskNutBoltPick
checkpoint freshly saved by the port at 16 envs, scored at 8 envs over a
shortened episode (12 steps, then the 50-engine-step close-and-lift
epilogue), runs to the end, prints the three statistics and evaluates the
checkpoint's policy; the JAX script (scripts/eval_factory_lift.py) and
the port score one scripted episode alike; and the port replays the JAX
script's run on the real task from the capture factory_lift_eval.npz."""
import collections
import importlib.util
import os
import re
import sys
import types

import numpy as np
import torch

from isaacgymenvs_ma_tpu_torch import eval_factory_lift
from isaacgymenvs_ma_tpu_torch.convert import (env_state_from_jax,
                                               ppo_state_from_jax)
from isaacgymenvs_ma_tpu_torch.learning import checkpoint as ckpt
from isaacgymenvs_ma_tpu_torch.learning.configs import train_default_config
from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
from isaacgymenvs_ma_tpu_torch.tasks import registry
from isaacgymenvs_ma_tpu_torch.tasks.factory import (NUT_HEIGHT, TABLE_HEIGHT,
                                                    FactoryTaskState)
from isaacgymenvs_ma_tpu_torch.utils import parity
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = eval_factory_lift.TASK
ARGS = ["sim_device=cpu", "num_envs=8", "task.rl.max_episode_length=12"]


def test_scores_a_port_checkpoint(tmp_path, capsys, monkeypatch):
    task = registry.create_task(TASK, deep_merge(
        registry.task_default_config(TASK), {"env": {"numEnvs": 16}}),
        seed=2, device="cpu")
    tcfg = train_default_config(TASK)
    tcfg["params"]["config"]["minibatch_size"] = 16 * int(
        tcfg["params"]["config"]["horizon_length"])
    agent = PPOAgent(task, tcfg, seed=2)
    agent.init()
    with torch.no_grad():                     # a policy unlike a fresh one
        agent.net.mu.bias.add_(0.3)
    path = str(tmp_path / "pick.pth")
    ckpt.save_agent(path, agent, task)
    acts = []
    act = PPOAgent.act
    monkeypatch.setattr(PPOAgent, "act", lambda self, obs, **k: acts.append(
        (self, obs)) or act(self, obs, **k))
    r = eval_factory_lift.main([path, "5"] + ARGS)
    out = capsys.readouterr().out
    assert f"restored {path}" in out
    for line in ("raw lift success (no epilogue): ",
                 "close-and-lift epilogue success",
                 "epilogue success over all envs"):
        assert line in out, out
    assert r["envs"] == 8 and len(acts) == 12
    assert 0 <= r["full_episode"] <= 8 and r["early_resets"] >= 0
    for k in ("raw", "lift", "lift_all"):
        assert 0.0 <= r[k] <= 1.0 and np.isfinite(r[k])
    # the policy evaluated is the checkpoint's
    evaluated = acts[0][0]
    for (k, p), q in zip(agent.net.named_parameters(),
                         evaluated.net.parameters()):
        assert torch.equal(p, q), k
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(agent.obs_rms, f),
                           getattr(evaluated.obs_rms, f))



# A scripted episode both evaluations score: 8 envs, a 6-step episode.
# Each step's reset flags (step 0 takes the initial all-reset), the final
# progress, nut heights and epilogue outcomes are tables, chosen so that
# every rule of the scoring shows: resets counted only before the last two
# steps, envs cut short left out of ``raw`` and ``lift`` but not of
# ``lift_all``, a nut exactly at the height threshold (not above it).
EPISODE = 6
RESETS = np.zeros((EPISODE, 8), np.int32)
RESETS[0] = 1
RESETS[1, 1] = RESETS[3, [1, 2]] = RESETS[4, 3] = 1
RESETS[5, [0, 4, 5, 6, 7]] = 1          # the episode's end: not early
PROGRESS = np.array([5, 1, 4, 1, 5, 5, 5, 5], np.int32)
NUT_Z = np.float32(TABLE_HEIGHT + NUT_HEIGHT * 3.0) + np.float32(1e-3) * \
    np.array([1, 1, -1, 1, -1, 1, -1, 0], np.float32)
LIFTED = np.array([1, 0, 1, 1, 1, 0, 1, 0], np.float32)
# what those tables score (envs 0 and 4-7 ran the whole episode)
WANT = {"full_episode": 5, "early_resets": 4, "raw": "0.400",
        "lift": "0.600", "lift_all": "0.625"}


def _scripted(asarray):
    """The scripted task and a zero policy over one array library
    (``asarray`` makes its arrays): a step returns the next row of RESETS,
    PROGRESS and, from its state, NUT_Z; the epilogue returns LIFTED."""
    state = collections.namedtuple("State", "t progress sim")
    res = collections.namedtuple("Res", "obs reset")
    out = collections.namedtuple("Out", "root_states")
    mark = np.zeros((1, 3, 13), np.float32)
    mark[0, 2, 2] = 1.0                 # the nut's root z

    class Engine:
        def forward(self, sim):
            return out(asarray(NUT_Z)[:, None, None] * sim)

    class Task:
        num_envs, max_episode_length, device = 8, EPISODE, "cpu"
        engine = Engine()

        def initial_state(self, *key):
            return state(asarray(np.int32(0)), asarray(PROGRESS * 0),
                         asarray(mark * 0))

        def reset(self, st):
            return st, asarray(np.zeros((8, 4), np.float32))

        def step(self, st, actions, reset_draws=None):
            return (state(st.t + 1, asarray(PROGRESS), asarray(mark)),
                    res(asarray(np.zeros((8, 4), np.float32)),
                        asarray(RESETS)[st.t]))

        def evaluate_lift(self, st):
            return asarray(LIFTED)

    class Agent:
        def __init__(self, *args, **kwargs):
            pass

        def init(self):
            return None

        def act(self, *args, **kwargs):
            return asarray(np.zeros((8, 12), np.float32))
    return Task(), Agent


def test_scoring_matches_the_jax_script(monkeypatch, capsys):
    """The JAX script (scripts/eval_factory_lift.py, its main as it
    stands) and the port's evaluate() score the same scripted episode:
    the same counts and the same printed shares, which are the tables'."""
    import jax.numpy as jnp
    spec = importlib.util.spec_from_file_location(
        "jax_eval_factory_lift", os.path.join(REPO, "scripts",
                                              "eval_factory_lift.py"))
    jscript = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jscript)
    jtask, jagent = _scripted(jnp.asarray)
    monkeypatch.setattr(jscript, "registry", types.SimpleNamespace(
        create_task=lambda *a, **k: jtask))
    monkeypatch.setattr(jscript, "load_task_config", lambda *a: {})
    monkeypatch.setattr(jscript, "load_train_config", lambda *a: {})
    monkeypatch.setattr(jscript, "PPOAgent", jagent)
    monkeypatch.setattr(sys, "argv", ["eval_factory_lift.py", "random"])
    jscript.main()
    out = capsys.readouterr().out

    def num(label):
        return re.search(re.escape(label) + r"[^:]*: (\S+)", out).group(1)
    got_jax = {"full_episode": int(num("full-episode")),
               "early_resets": int(num("early resets total")),
               "raw": num("raw lift success"),
               "lift": num("close-and-lift epilogue success"),
               "lift_all": num("epilogue success over ALL envs")}
    assert got_jax == WANT, out

    ttask, tagent = _scripted(torch.as_tensor)
    r = eval_factory_lift.evaluate(ttask, tagent())
    got = {k: r[k] if k in ("full_episode", "early_resets")
           else f"{r[k]:.3f}" for k in WANT}
    assert got == got_jax and r["envs"] == 8


def _tree(d, prefix):
    """{a.b.c: array} keys under ``prefix`` back into a nested dict."""
    out = {}
    for k in d.files:
        if k.startswith(prefix + "."):
            node = out
            *path, leaf = k[len(prefix) + 1:].split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = d[k]
    return out


def test_episode_matches_the_jax_capture():
    """tests/data/torch_port/factory_lift_eval.npz
    (scripts/record_torch_golden.py --factory-lift-eval): the JAX script
    scoring an untrained policy at 8 envs over a 12-step episode.  The
    port's evaluate() takes the same policy, start state and reset draws:
    the same full-episode count and early resets, the same printed
    shares, each env's final progress, its coordinates and nut height
    within GROUND_RULE_TOL's q (2e-6 and 6e-8 measured on the CPU) and
    the same epilogue outcome.  The untrained policy lifts no nut and no
    env is cut short here: the scripted episode above holds those
    rules."""
    d = np.load(os.path.join(REPO, "tests", "data", "torch_port",
                             "factory_lift_eval.npz"))
    cfg = deep_merge(registry.task_default_config(TASK), {
        "env": {"numEnvs": 8},
        "rl": {"max_episode_length": int(d["rl_max_episode_length"])}})
    task = registry.create_task(TASK, cfg, seed=int(d["seed"]),
                                device="cpu")
    tcfg = train_default_config(TASK)
    tcfg["params"]["config"]["minibatch_size"] = 8 * int(
        tcfg["params"]["config"]["horizon_length"])
    agent = PPOAgent(task, tcfg, seed=int(d["seed"]))
    agent.init()
    agent.load_state_dict(ppo_state_from_jax({
        k: _tree(d, k) for k in ("params", "adam", "obs_rms", "value_rms")}
        | {"lr": d["lr"]}))
    start = env_state_from_jax(
        {parity._state_key(k[len("init_"):]): d[k] for k in d.files
         if k.startswith("init_")}, "cpu", FactoryTaskState)
    draws = [tuple(torch.as_tensor(d[k][t])
                   for k in parity.RESET_DRAWS[TASK])
             for t in range(len(d["reset"]))]
    r = eval_factory_lift.evaluate(task, agent, start, draws)
    assert r["full_episode"] == int(d["full_episode"])
    assert r["early_resets"] == int(d["early_resets"])
    for k in ("raw", "lift", "lift_all"):
        assert f"{r[k]:.3f}" == str(d[k]), k
    np.testing.assert_array_equal(r["state"].progress.numpy(),
                                  d["progress"])
    for got, want in ((r["state"].sim.q, d["q"]), (r["nut_z"], d["nut_z"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=parity.GROUND_RULE_TOL["q"])
    np.testing.assert_array_equal(r["lifted"].numpy(), d["lifted"])
