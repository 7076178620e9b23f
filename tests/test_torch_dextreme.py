"""Port parity of AllegroHandDextreme{ManualDR,ADR}
(isaacgymenvs_ma_tpu_torch/tasks/allegro_hand_dextreme.py), the
dict-observation shim (utils/rlgames_utils.py) and ``reset_done``
(tasks/base.py) against the JAX package.

* Each hook against the JAX method run eagerly (no JAX Dextreme step is
  jitted here) from a committed capture's start state, with the JAX
  keys' draws injected (``scripts/record_torch_golden.py``'s
  ``dextreme_*_draws``): ``pre_physics`` with and without the RNA mask
  refresh, ``reset_idx``, ``post_physics``, ``update_phys`` and
  ``_adr_update`` with queues about to fill.
* The two captures (``--dextreme AllegroHandDextremeManualDR`` /
  ``AllegroHandDextremeADR``: 32 envs, 6 steps, a quarter of the envs
  reset in the first, successes, RNA blends, the mask refresh in the
  third; the ADR one from widened ranges, so limit shifts, latency,
  the camera refresh rate, the affine scales and restitution are live)
  replayed one step at a time against the reference's own one-ulp spread
  at ``parity.TOLERANCES``.
* The registry's four names, an ADR checkpoint round trip, one CPU epoch
  of AllegroHandDextremeADR at 16 envs, the shim on the cases of
  tests/test_rlgames_shim.py against the JAX shim, and the entry point
  asking for the card.

Tolerances: the controls, the reset's values and the ADR state at
rtol = atol = 1e-5 (float32 arithmetic on the same draws; the RNA's
256-wide products round otherwise); obs, states and reward at the ground
rule (``parity.GROUND_RULE_TOL``); resets and masks exact.
"""
import copy
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.physics.engine import SimState as JSimState
from isaacgymenvs_ma_tpu.tasks import registry as jregistry
from isaacgymenvs_ma_tpu.tasks.allegro_hand_dextreme import (
    DextremeTaskState as JDxState)
from isaacgymenvs_ma_tpu.tasks.base import EnvState as JEnvState
from isaacgymenvs_ma_tpu.tasks.shadow_hand import HandTaskState as JHand
from isaacgymenvs_ma_tpu.utils.adr import ADRState as JADRState
from isaacgymenvs_ma_tpu.utils.config import deep_merge as jdeep_merge
from isaacgymenvs_ma_tpu.utils.rna_util import RNAState
from isaacgymenvs_ma_tpu_torch.convert import (env_state_from_jax,
                                               rna_state_dict_from_jax)
from isaacgymenvs_ma_tpu_torch.physics.engine import SimOutput
from isaacgymenvs_ma_tpu_torch.tasks import registry as pregistry
from isaacgymenvs_ma_tpu_torch.tasks.allegro_hand_dextreme import (
    PreDraws, StepDraws)
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge
from isaacgymenvs_ma_tpu_torch.utils.parity import (
    GROUND_RULE_TOL, ONE_STEP_RESET_MISMATCHES, TOLERANCES, replay)

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "torch_port")
GOLDEN = {"AllegroHandDextremeManualDR":
          "allegro_hand_dextreme_manual_dr_golden.npz",
          "AllegroHandDextremeADR": "allegro_hand_dextreme_adr_golden.npz"}
N = 32
TOL = dict(rtol=1e-5, atol=1e-5)


def _recorder():
    """scripts/record_torch_golden.py as a module (its draw helpers)."""
    spec = importlib.util.spec_from_file_location(
        "record_torch_golden",
        os.path.join(REPO, "scripts", "record_torch_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REC = _recorder()


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, what, **tol):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               err_msg=what, **(tol or TOL))


# ---------------------------------------------------------------- setup
@pytest.fixture(scope="module", params=list(GOLDEN))
def dx(request):
    """Both packages' tasks at the capture's 32 envs (the port's RNA with
    the capture's weights) and both env states at its start."""
    name = request.param
    d = np.load(os.path.join(DATA, GOLDEN[name]))
    over = {"env": {"numEnvs": N}}
    jt = jregistry.task_class(name)(jdeep_merge(
        jregistry.task_default_config(name), over))
    pt = pregistry.create_task(name, deep_merge(
        pregistry.task_default_config(name), over), seed=3, device="cpu")
    tree = {}
    for k in d.files:
        if k.startswith("rna_params."):
            _, layer, leaf = k.split(".")
            tree.setdefault(layer, {})[leaf] = d[k]
    pt.rna.load_state_dict(rna_state_dict_from_jax(tree))
    init = {k[len("init_"):]: d[k] for k in d.files if k.startswith("init_")}
    return dict(name=name, d=d, jt=jt, pt=pt, tree=tree,
                jstate=_jax_state(init, tree, jax.random.PRNGKey(11)),
                pstate=_port_state(init))


def _jax_state(a, tree, key):
    """A JAX Dextreme EnvState from flat capture arrays (``dextreme_
    state_arrays``' keys), the RNA with ``tree`` and key PRNGKey(5)."""
    j = lambda k: jnp.asarray(a[k])  # noqa: E731
    hand = JHand(*(j(f"hand.{f}") for f in JHand._fields))
    rna = RNAState(params={"params": jax.tree_util.tree_map(jnp.asarray,
                                                             tree)},
                   masks=(j("rna.0"), j("rna.1")),
                   key=jax.random.PRNGKey(5))
    adr = (JADRState(*(j(f"adr.{f}") for f in JADRState._fields))
           if "adr.ranges" in a else None)
    rest = {f: j(f) for f in JDxState._fields
            if f not in ("hand", "rna", "adr") and f in a}
    return JEnvState(sim=JSimState(j("q"), j("qd")), progress=j("progress"),
                     reset_buf=j("reset_buf"), rng=key,
                     task=JDxState(hand=hand, rna=rna, adr=adr, **rest))


def _port_state(a):
    prefix = {"q": "sim.", "qd": "sim.", "progress": "", "reset_buf": ""}
    return env_state_from_jax({prefix.get(k, "task.") + k: v
                               for k, v in a.items()}, "cpu")


def _pre_draws(jt, rng, rna_key):
    d = REC.dextreme_pre_draws(rng, rna_key, jt)
    return PreDraws(noise=_t(d["act_noise_n"]), rna_u=_t(d["rna_u"]),
                    delay_u=_t(d["delay_u"]),
                    mask_u=(_t(d["mask_u_0"]), _t(d["mask_u_1"])),
                    hand=(_t(d["force_fire_u"]), _t(d["force_n"])))


def _step_draws(jt, key):
    d = REC.dextreme_step_draws(key, jt)
    return StepDraws(*(_t(d[k]) for k in (
        "new_goal_ang", "unreliable_u", "cam_pos_n", "cam_axis_n",
        "cam_ang_n", "hold_u", "dof_obs_n")))


def _reset_draws(jt, key):
    return tuple(_t(v) for v in REC.dextreme_reset_draws(key, jt).values())


def _assert_task(pt_task, jt_task):
    """Every field of the port's Dextreme state against the JAX one's."""
    for f in JHand._fields:
        _close(getattr(pt_task.hand, f), getattr(jt_task.hand, f),
               f"hand.{f}")
    for a, b in zip(pt_task.rna, jt_task.rna.masks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in JDxState._fields:
        if f in ("hand", "rna"):
            continue
        a, b = getattr(pt_task, f), getattr(jt_task, f)
        if b is None:
            assert a is None, f
        elif f == "adr":
            for g in JADRState._fields:
                _close(getattr(a, g), getattr(b, g), f"adr.{g}")
        else:
            _close(a, b, f)


# ---------------------------------------------------------------- hooks
@pytest.mark.parametrize("refresh", [False, True])
def test_pre_physics_matches_jax(dx, refresh):
    """The corrupted action's control (latency from the ring, the affine
    corruption, the RNA blend; the hand's drive and object force) and the
    carried updates, on the RNA refresh clock's step (refresh) or not."""
    jt, pt = dx["jt"], dx["pt"]
    count = 1200 if refresh else 1199
    jst = dx["jstate"]._replace(task=dx["jstate"].task._replace(
        step_count=jnp.asarray(count, jnp.int32)))
    pst = dx["pstate"]._replace(task=dx["pstate"].task._replace(
        step_count=torch.tensor(count, dtype=torch.int32)))
    acts = dx["d"]["actions"][0]
    jc = jt.pre_physics(jst, jnp.asarray(acts))
    draws = _pre_draws(jt, jst.rng, jst.task.rna.key)
    pc, (hand_carry, upd) = pt.pre_physics(pst, _t(acts), draws=draws)
    nv = pt.engine.nv
    _close(pc.pos_target, np.asarray(jc.pos_target).reshape(N, nv),
           "pos_target")
    _close(pc.f_ext, jc.f_ext, "f_ext")
    _close(hand_carry[0], jt._new_targets, "new targets")
    _close(hand_carry[1], jt._rb_force, "rb_force")
    ju = jt._task_updates
    _close(upd["act_hist"], ju["act_hist"], "act_hist")
    assert int(upd["step_count"]) == int(ju["step_count"]) == count + 1
    for a, b in zip(upd["rna"], ju["rna"].masks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    changed = any(not torch.equal(a, b)
                  for a, b in zip(upd["rna"], pst.task.rna))
    assert changed == refresh
    # the RNA blended some envs' actions
    assert bool((draws.rna_u < pt.rna_prob).any())


def test_reset_idx_matches_jax(dx):
    """Half the envs reset: the hand's reset, the per-episode affine
    biases and scales with the (adaptive) stds, the ring and camera hold
    cleared, ADR's fresh rows first."""
    jt, pt = dx["jt"], dx["pt"]
    jst, pst = dx["jstate"], dx["pstate"]
    mask = np.arange(N) % 2 == 0
    key = jax.random.PRNGKey(23)
    jsim, jtask = jt.reset_idx(jst.sim, jst.task, jnp.asarray(mask), key)
    psim, ptask = pt.reset_idx(pst.sim, pst.task, torch.as_tensor(mask),
                               draws=_reset_draws(jt, key))
    _close(psim.q, jsim.q, "q")
    _close(psim.qd, jsim.qd, "qd")
    _assert_task(ptask, jtask)
    if pt.use_adr:
        assert not torch.equal(ptask.adr_params[mask],
                               pst.task.adr_params[mask])


def _outputs(jt, pt, jsim, g):
    """The readouts post_physics takes, for both packages: the JAX
    forward's poses and velocities with seeded dof forces and sensor
    wrenches."""
    out = jt.engine.forward(jsim)
    n, nv = N, pt.engine.nv
    dof_force = g.normal(0, 0.3, (n, nv)).astype(np.float32)
    sensors = g.normal(0, 0.3, (n, 4, 6)).astype(np.float32)
    out = out._replace(dof_force=jnp.asarray(dof_force),
                       sensor_forces=jnp.asarray(sensors))
    pout = SimOutput(*(_t(getattr(out, f)) for f in SimOutput._fields))
    return out, pout


def test_post_physics_matches_jax(dx):
    """The 50-wide noisy policy obs, the 112-wide true critic states, the
    hand's reward and resets, the camera model's held pose and counter,
    the carried updates applied, ADR's observe and ``adr_npd``."""
    jt, pt = dx["jt"], dx["pt"]
    jst, pst = dx["jstate"], dx["pstate"]
    acts = dx["d"]["actions"][0]
    jt.pre_physics(jst, jnp.asarray(acts))
    _, carry = pt.pre_physics(pst, _t(acts), draws=_pre_draws(
        jt, jst.rng, jst.task.rna.key))
    out, pout = _outputs(jt, pt, jst.sim, np.random.default_rng(1))
    k_step = jax.random.PRNGKey(41)
    jmid = jst._replace(rng=k_step)
    jobs, jstates, jrew, jreset, jtask, jex = jt.post_physics(
        jmid, out, jnp.asarray(acts))
    obs, states, rew, reset, ptask, ex = pt.post_physics(
        pst, pout, _t(acts), carry=carry, draws=_step_draws(jt, k_step))
    tol = GROUND_RULE_TOL
    _close(obs, jobs, "obs", rtol=tol["obs"], atol=tol["obs"])
    _close(states, jstates, "states", rtol=tol["obs"], atol=tol["obs"])
    _close(rew, jrew, "rew", rtol=tol["rew"], atol=tol["rew"])
    np.testing.assert_array_equal(reset.numpy(), np.asarray(jreset))
    _assert_task(ptask, jtask)
    assert obs.shape == (N, 50) and states.shape == (N, 112)
    for k in ("consecutive_successes", "_reset_progress_mask"):
        _close(ex[k], jex[k], k)
    if pt.use_adr:
        _close(ex["adr_npd"], jex["adr_npd"], "adr_npd")
    # the split views are the flat obs' slices
    parts = pt.split_obs(obs)
    assert torch.equal(parts["last_actions"], _t(acts))
    assert pt.split_states(states)["ft_force_torques"].shape == (N, 24)


def test_update_phys_matches_jax(dx):
    """ADR's engine scales from the current rows: every PhysScales leaf,
    per dof and per body (ManualDR hands the engine none)."""
    jt, pt = dx["jt"], dx["pt"]
    jst, pst = dx["jstate"], dx["pstate"]
    mask = np.zeros(N, bool)
    if not pt.use_adr:
        assert pt.initial_state().phys is None
        assert pt.update_phys(pst, torch.as_tensor(mask)) is None
        return
    jp = jt.update_phys(jst, jnp.asarray(mask), jax.random.PRNGKey(0))
    pp = pt.update_phys(pst, torch.as_tensor(mask))
    for f in jp._fields:
        a, b = getattr(pp, f), getattr(jp, f)
        if b is None:
            assert a is None, f
        else:
            _close(a, b, f, rtol=1e-6, atol=1e-6)
    # the families reach the engine live: shifts, restitution
    assert float(pp.dof_lower_shift.abs().max()) > 0.05
    assert float(pp.restitution.max()) > 0.05
    # the first state's scales come from its own rows
    st = pt.initial_state()
    for f in ("mass", "restitution", "dof_upper_shift"):
        assert torch.equal(getattr(st.phys, f), getattr(
            pt.phys_from_params(st.task.adr_params), f))


def test_adr_update_matches_jax(dx):
    """ADR's observe from the task: queues one episode short of full (255
    of 256), half the slots with a mean performance of 25 (expand), half
    with 2 (contract); done envs with their successes."""
    jt, pt = dx["jt"], dx["pt"]
    if not pt.use_adr:
        return
    jst, pst = dx["jstate"], dx["pstate"]
    P = pt.adr.P
    cnt = np.full((P, 2), 255.0, np.float32)
    perf = np.where(np.arange(P)[:, None] % 2 == 0, 25.0, 2.0) * cnt
    adr = pst.task.adr._replace(perf_sum=_t(perf.astype(np.float32)),
                                perf_cnt=_t(cnt))
    reset = np.ones(N, np.int32)
    succ = np.where(np.arange(N) % 2 == 0, 25.0, 2.0).astype(np.float32)
    hand = pst.task.hand._replace(successes=_t(succ))
    ptask = pt._adr_update(pst.task._replace(adr=adr), _t(reset), hand)
    jadr = JADRState(*(jnp.asarray(x.numpy()) for x in adr))
    jtask = jt._adr_update(jst.task._replace(adr=jadr), jnp.asarray(reset),
                           jst.task.hand._replace(successes=jnp.asarray(succ)))
    for g in JADRState._fields:
        _close(getattr(ptask.adr, g), getattr(jtask.adr, g), f"adr.{g}")
    assert float(ptask.adr.num_updates.sum()) > 0


# ------------------------------------------------------------- captures
@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden_replay_on_cpu_twins(name):
    r = replay(os.path.join(DATA, GOLDEN[name]), "cpu")
    tol = TOLERANCES[name]
    assert r.finite
    for k in ("q", "qd", "obs", "rew"):
        assert (getattr(r, k) <= tol[k]).all(), (k, getattr(r, k), r.raw[k])
    assert (r.reset_mismatches <= ONE_STEP_RESET_MISMATCHES).all()
    assert (r.wild_envs <= N // 4).all()


@pytest.mark.parametrize("name", list(GOLDEN))
def test_captures_exercise_the_features(name):
    """What the captures hold: a quarter of the envs reset in the first
    step, successes, RNA blends, the mask refresh at the third step; the
    ADR capture's rows carry limit shifts, latency >= 1, a camera refresh
    rate above 1, affine scales and restitution."""
    d = np.load(os.path.join(DATA, GOLDEN[name]))
    assert int(d["start_reset_buf"][0].sum()) >= N // 4
    assert (d["rew"][0] > 200).any()          # the success bonus
    assert (d["rna_u"] < 0.2).any()
    counts = d["start_step_count"]
    assert [int(c) % 600 for c in counts[:3]] == [598, 599, 0]
    if name.endswith("ADR"):
        from isaacgymenvs_ma_tpu_torch.tasks.allegro_hand_dextreme import (
            DEFAULT_ADR_PARAMS)
        idx = {k: i for i, k in enumerate(DEFAULT_ADR_PARAMS)}
        p = d["init_adr_params"]
        assert np.abs(p[:, idx["hand_lower"]]).max() > 0.1
        assert p[:, idx["action_latency"]].max() >= 1.0
        assert p[:, idx["cube_pose_refresh_rate"]].max() > 1.5
        assert p[:, idx["affine_action_scaling"]].max() > 0.0
        assert p[:, idx["object_restitution"]].max() > 0.1


# --------------------------------------------- registry, checkpoint, PPO
@pytest.mark.parametrize("name", ["AllegroHandDextremeManualDR",
                                  "AllegroHandDextremeADR",
                                  "AllegroHandManualDR", "AllegroHandADR"])
def test_registry_names_match_jax(name):
    assert (pregistry.task_class(name).__name__
            == jregistry.task_class(name).__name__)
    assert pregistry.task_default_config(name) == \
        jregistry.task_default_config(name)
    assert name in pregistry.task_names()


def test_adr_checkpoint_round_trip(tmp_path):
    """The ADR ranges and the nested task state through the port's
    checkpoint: ``get_env_state`` into ``env_state_extra``, the agent's
    state dict (hand, RNA masks, ADR) out and back, ``set_env_state``."""
    from isaacgymenvs_ma_tpu_torch.learning import checkpoint as ckpt
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config)
    from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
    name = "AllegroHandDextremeADR"
    cfg = deep_merge(pregistry.task_default_config(name),
                     {"env": {"numEnvs": 8}})
    tcfg = train_default_config(name)
    c = tcfg["params"]["config"]
    c["minibatch_size"] = c["central_value_config"]["minibatch_size"] = 64
    task = pregistry.create_task(name, copy.deepcopy(cfg), device="cpu")
    agent = PPOAgent(task, tcfg, seed=1)
    agent.init()
    st = agent.env_state
    st = st._replace(task=st.task._replace(adr=st.task.adr._replace(
        ranges=st.task.adr.ranges + 0.01)))
    agent.env_state = st
    path = str(tmp_path / "nn" / "dx.pth")
    ckpt.save_checkpoint(path, agent.state_dict(),
                         env_state_extra=task.get_env_state(st))
    state, extra, _ = ckpt.load_checkpoint(path)
    task2 = pregistry.create_task(name, copy.deepcopy(cfg), device="cpu")
    agent2 = PPOAgent(task2, tcfg, seed=2)
    agent2.init()
    agent2.load_state_dict(state)
    for a, b in zip(agent2.env_state.task.rna, st.task.rna):
        assert torch.equal(a, b)
    assert torch.equal(agent2.env_state.task.hand.goal_rot,
                       st.task.hand.goal_rot)
    assert torch.equal(agent2.env_state.task.adr.ranges, st.task.adr.ranges)
    fresh = task2.set_env_state(task2.initial_state(), extra)
    assert torch.allclose(fresh.task.adr.ranges, st.task.adr.ranges)


def test_one_cpu_epoch_of_adr():
    """One PPO epoch of AllegroHandDextremeADR with its config's
    central-value critic at 16 envs (minibatches cut to the rollout, one
    mini-epoch):
    finite losses, the critic on the 112 states, parameters moved."""
    from isaacgymenvs_ma_tpu_torch.learning import networks
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config)
    from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
    name = "AllegroHandDextremeADR"
    task = pregistry.create_task(name, deep_merge(
        pregistry.task_default_config(name), {"env": {"numEnvs": 16}}),
        device="cpu")
    tcfg = train_default_config(name)
    c = tcfg["params"]["config"]
    c["minibatch_size"] = c["central_value_config"]["minibatch_size"] = 64
    c["mini_epochs"] = 1
    agent = PPOAgent(task, tcfg, seed=1)
    agent.init()
    assert isinstance(agent.net, networks.AsymActorCritic)
    before = [p.detach().clone() for p in agent.net.parameters()]
    m = agent.train_epoch()
    assert all(np.isfinite(float(v)) for v in m.values())
    assert any(not torch.equal(a, b)
               for a, b in zip(before, agent.net.parameters()))


@pytest.mark.parametrize("name", ["AllegroHandDextremeManualDR",
                                  "AllegroHandADR"])
def test_entry_point_asks_for_the_card(name):
    cfg = deep_merge(pregistry.task_default_config(name),
                     {"env": {"numEnvs": 8}})
    if torch.cuda.is_available():
        assert pregistry.create_task(name, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pregistry.create_task(name, cfg)


# ----------------------------------------------------------------- shim
@pytest.fixture(scope="module")
def cartpole_pair():
    jt = jregistry.task_class("Cartpole")(jdeep_merge(
        jregistry.task_default_config("Cartpole"), {"env": {"numEnvs": 8}}))
    pt = pregistry.create_task("Cartpole", deep_merge(
        pregistry.task_default_config("Cartpole"), {"env": {"numEnvs": 8}}),
        device="cpu")
    return jt, pt


def test_reset_done_returns_real_obs(cartpole_pair):
    """A fresh state (every env flagged): the obs of the reset state, as
    the JAX ``reset_done`` gives them with the same draws; flags and
    clocks cleared."""
    jt, pt = cartpole_pair
    jst = jt.initial_state(jax.random.PRNGKey(0))
    jst2, jobs, _ = jax.jit(jt.reset_done)(jst)
    _, k_reset, _ = jax.random.split(jst.rng, 3)
    draws = tuple(_t(v) for v in REC.cartpole_draws(k_reset, jt).values())
    pst2, obs, states = pt.reset_done(pt.initial_state(), reset_draws=draws)
    _close(obs, jobs, "obs", rtol=1e-6, atol=1e-6)
    _close(pst2.sim.q, jst2.sim.q, "q", rtol=1e-6, atol=1e-6)
    assert states is None and float(obs.abs().sum()) > 0
    assert (pst2.reset_buf == 0).all() and (pst2.progress == 0).all()


def test_reset_done_noop_matches_step_obs(cartpole_pair):
    _, pt = cartpole_pair
    st = pt.initial_state()
    for _ in range(3):
        st, res = pt.step(st, pt.zero_actions())
    st = st._replace(reset_buf=torch.zeros_like(st.reset_buf))
    _, obs, _ = pt.reset_done(st)
    _close(obs, res.obs.numpy(), "obs", rtol=1e-6, atol=1e-7)


def test_rlgpu_env_reset_done_shim(cartpole_pair):
    from isaacgymenvs_ma_tpu_torch.utils.rlgames_utils import (
        RLGPUEnv, get_rlgames_env_creator, multi_gpu_get_rank)
    _, pt = cartpole_pair
    env = RLGPUEnv(pt)
    obs_dict, done = env.reset_done()
    assert done.shape == (8,) and float(obs_dict["obs"].abs().sum()) > 0
    obs_dict, done = env.reset_done()
    assert done.shape == (0,)
    _, _, _, extras = env.step(pt.zero_actions())
    assert "time_outs" in extras
    assert env.get_env_info() == {"action_space": (1,),
                                  "observation_space": (4,), "agents": 1}
    assert multi_gpu_get_rank() == 0
    make = get_rlgames_env_creator(
        1, deep_merge(pregistry.task_default_config("Cartpole"),
                      {"env": {"numEnvs": 4}}), "Cartpole", "cpu", "cpu")
    assert make().task.num_envs == 4


OBS_SPEC = {
    "obs": {"names": ["dof_pos", "object_pose", "goal_relative_rot"],
            "concat": True, "space_name": "observation_space"},
    "priv": {"names": ["dof_vel", "ft_force_torques"], "concat": False,
             "space_name": "priv_space"},
    "states": {"names": ["states"], "concat": True,
               "space_name": "state_space"},
}


@pytest.fixture(scope="module")
def shim_pair(dx):
    """The JAX and the port shims over ManualDR (the JAX one built, never
    stepped: its step is jitted)."""
    from isaacgymenvs_ma_tpu.utils.rlgames_utils import (
        ComplexObsRLGPUEnv as JShim)
    from isaacgymenvs_ma_tpu_torch.utils.rlgames_utils import (
        ComplexObsRLGPUEnv)
    return JShim(dx["jt"], OBS_SPEC, seed=5), ComplexObsRLGPUEnv(
        dx["pt"], OBS_SPEC)


def test_complex_obs_groups_and_spaces_match_jax(shim_pair):
    """The groups built from the same flat obs and states, and the env
    info's spaces, against the JAX shim."""
    jenv, penv = shim_pair
    g = np.random.default_rng(2)
    obs = g.normal(size=(N, 50)).astype(np.float32)
    states = g.normal(size=(N, 112)).astype(np.float32)
    jout = jenv._build(jnp.asarray(obs), jnp.asarray(states))
    pout = penv._build(_t(obs), _t(states))
    _close(pout["obs"], jout["obs"], "obs", rtol=0, atol=0)
    assert pout["obs"].shape == (N, 27)
    for k in ("dof_vel", "ft_force_torques"):
        _close(pout["priv"][k], jout["priv"][k], k, rtol=0, atol=0)
    _close(pout["states"], jout["states"], "states", rtol=0, atol=0)
    assert penv.get_env_info() == jenv.get_env_info()
    with pytest.raises(KeyError):
        type(penv)(penv.task, {"obs": {"names": ["nonexistent_part"]}})._build(
            _t(obs), _t(states))


def test_complex_obs_step_and_reset_done(shim_pair, dx):
    """The port's shim steps and resets: each group's shape, and
    ``reset_done``'s obs against the JAX task's ``reset_done`` run eagerly
    with the same draws."""
    jenv, penv = shim_pair
    jt, pt = dx["jt"], dx["pt"]
    out, rew, reset, extras = penv.step(pt.zero_actions())
    assert out["obs"].shape == (N, 27) and out["states"].shape == (N, 112)
    assert out["priv"]["dof_vel"].shape == (N, 16)
    jst = dx["jstate"]
    key, k_reset, _ = jax.random.split(jst.rng, 3)
    jst2, jobs, jstates = jt.reset_done(jst)
    pst2, obs, states = pt.reset_done(
        dx["pstate"], reset_draws=_reset_draws(jt, k_reset),
        pre_draws=_pre_draws(jt, key, jst.task.rna.key),
        step_draws=_step_draws(jt, key))
    tol = GROUND_RULE_TOL["obs"]
    _close(obs, jobs, "obs", rtol=tol, atol=tol)
    _close(states, jstates, "states", rtol=tol, atol=tol)
    _assert_task(pst2.task, jst2.task)
    penv._state = dx["pstate"]
    out, done = penv.reset_done()
    assert len(done) == int(dx["pstate"].reset_buf.sum())
    assert out["obs"].shape == (N, 27)
    assert torch.isfinite(out["obs"]).all()
