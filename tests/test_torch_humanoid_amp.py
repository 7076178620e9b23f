"""HumanoidAMP and HumanoidAMPHands in the port
(isaacgymenvs_ma_tpu_torch/tasks/humanoid_amp.py) against the JAX
package's.

* The copied spec (``models/specs/amp_humanoid.py``) equals the original
  and builds the same model.
* ``dof_to_obs`` and ``build_amp_observations`` on seeded inputs (1e-5:
  float32 trigonometry of the two packages).
* The scene and the PD gains, offsets and scales, the key, contact and
  non-foot bodies; HumanoidAMPHands' contact bodies and clip.
* ``reset_idx`` (Reference State Init) and ``fetch_amp_obs_demo`` on the
  JAX keys' draws, run eagerly in JAX (1e-6: the same float32 lerp and
  slerp).
* The 3-step captures at 8 envs from a reset state
  (``humanoid_amp_golden.npz``, ``humanoid_amp_hands_golden.npz``) at the
  ground rule (``parity.GROUND_RULE_TOL``: q 2e-4, qd and obs 2e-3), resets
  exact, on the default loop and (HumanoidAMP) on the B4 route.  Measured
  on the CPU: q <= 8.1e-6, qd <= 2.3e-4, obs <= 2.2e-4 on both routes.
* B4's twin on the inputs the port's B4 route hands it (42 candidate rows,
  nv 34) against JAX ``contact_kernel.solve_bl``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaacgymenvs_ma_tpu.tasks import humanoid_amp as jha
from isaacgymenvs_ma_tpu.tasks import registry as jregistry
from isaacgymenvs_ma_tpu.utils.config import deep_merge as jdeep_merge
from isaacgymenvs_ma_tpu_torch.tasks import humanoid_amp as pha
from isaacgymenvs_ma_tpu_torch.tasks import registry as pregistry
from isaacgymenvs_ma_tpu_torch.utils import parity
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

torch.set_num_threads(1)   # small CPU ops: one thread a test worker

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
N = 8
GOLDEN = {"HumanoidAMP": os.path.join(DATA, "humanoid_amp_golden.npz"),
          "HumanoidAMPHands": os.path.join(DATA,
                                           "humanoid_amp_hands_golden.npz")}


def _cfg(name, n=N, pkg=pregistry, merge=deep_merge):
    return merge(pkg.task_default_config(name), {"env": {"numEnvs": n}})


@pytest.fixture(scope="module")
def tasks():
    """The JAX and the port's HumanoidAMP at 8 envs (no JAX jit)."""
    j = jregistry.task_class("HumanoidAMP")(
        _cfg("HumanoidAMP", pkg=jregistry, merge=jdeep_merge))
    p = pregistry.create_task("HumanoidAMP", _cfg("HumanoidAMP"), seed=3,
                              device="cpu")
    return j, p


def test_spec_copy_matches_jax():
    from isaacgymenvs_ma_tpu.models.model import model_from_spec as jmfs
    from isaacgymenvs_ma_tpu.models.specs.amp_humanoid import SPEC as JSPEC
    from isaacgymenvs_ma_tpu_torch.models.model import model_from_spec
    from isaacgymenvs_ma_tpu_torch.models.specs.amp_humanoid import SPEC
    from test_torch_ball_balance import _assert_models_equal
    assert SPEC == JSPEC
    _assert_models_equal(model_from_spec(SPEC), jmfs(JSPEC))


def _quats(g, n):
    q = g.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_amp_observations_match_jax():
    g = np.random.default_rng(0)
    n = 64
    pose = g.uniform(-2.5, 2.5, (n, 28)).astype(np.float32)
    pose[:4] = 0.0                      # the zero exp-map branch
    root = np.concatenate([g.normal(size=(n, 3)), _quats(g, n),
                           g.normal(size=(n, 6))], -1).astype(np.float32)
    dof_vel = g.normal(size=(n, 28)).astype(np.float32)
    key = g.normal(size=(n, 4, 3)).astype(np.float32)
    t = torch.as_tensor
    np.testing.assert_allclose(pha.dof_to_obs(t(pose)).numpy(),
                               np.asarray(jha.dof_to_obs(jnp.asarray(pose))),
                               rtol=1e-5, atol=1e-5)
    for local in (False, True):
        got = pha.build_amp_observations(t(root), t(pose), t(dof_vel),
                                         t(key), local).numpy()
        want = np.asarray(jha.build_amp_observations(
            jnp.asarray(root), jnp.asarray(pose), jnp.asarray(dof_vel),
            jnp.asarray(key), local))
        assert got.shape == (n, pha.NUM_AMP_OBS_PER_STEP)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_scene_and_pd_gains(tasks):
    j, p = tasks
    assert (p.num_obs, p.num_actions, p.num_amp_obs) == (105, 28, 210)
    assert (p.engine.nb, p.engine.nv) == (31, 34)
    assert p.policy_dt == pytest.approx(j.policy_dt) == 0.0332
    for f in ("dof_drive_mode", "dof_stiffness", "dof_drive_damping",
              "dof_lower", "dof_upper", "body_names"):
        np.testing.assert_array_equal(np.asarray(getattr(p.model, f)),
                                      np.asarray(getattr(j.model, f)), f)
    assert (np.asarray(p.model.dof_stiffness)[6:] > 0).all()
    np.testing.assert_array_equal(p.pd_offset.numpy(),
                                  np.asarray(j.pd_offset))
    np.testing.assert_array_equal(p.pd_scale.numpy(), np.asarray(j.pd_scale))
    for f in ("key_body_ids", "contact_body_ids", "nonfoot_bodies"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(j, f)), f)
    # the PD targets of an action
    a = np.random.default_rng(1).uniform(-1, 1, (N, 28)).astype(np.float32)
    pc = p.pre_physics(None, torch.as_tensor(a))
    jc = j.pre_physics(None, jnp.asarray(a))
    np.testing.assert_allclose(pc.pos_target.numpy(),
                               np.asarray(jc.pos_target), rtol=1e-6,
                               atol=1e-6)
    assert float(pc.tau.abs().max()) == 0.0


def test_hands_variant():
    """HumanoidAMPHands: the JAX delta (the hands join the contact bodies,
    the cartwheel clip)."""
    assert pregistry.task_default_config("HumanoidAMPHands") == \
        jregistry.task_default_config("HumanoidAMPHands")
    p = pregistry.create_task("HumanoidAMPHands", _cfg("HumanoidAMPHands", 2),
                              device="cpu")
    names = p.model.body_names
    assert [names[i] for i in p.contact_body_ids.tolist()] == [
        "right_foot", "left_foot", "right_hand", "left_hand"]
    assert not set(p.contact_body_ids.tolist()) & set(
        p.nonfoot_bodies.tolist())
    assert len(p.nonfoot_bodies) == p.engine.nb - 4
    j = jha.MotionLib(os.path.join(jha.MOTIONS_DIR,
                                   "amp_humanoid_cartwheel.npy"), dt=0.0332)
    np.testing.assert_allclose(p.motion_lib.data.dof_pos.numpy(),
                               np.asarray(j.data.dof_pos), atol=1e-6)


def _jax_reset_draws(j, key):
    k1, k2 = jax.random.split(key)
    ids = j.motion_lib.sample_motions(k1, j.num_envs)
    return ids, j.motion_lib.sample_time(k2, ids)


def test_reset_idx_matches_jax(tasks):
    j, p = tasks
    g = np.random.default_rng(2)
    jst = j.initial_state(jax.random.PRNGKey(0))
    q = np.asarray(jst.sim.q) + g.normal(0, 0.1, jst.sim.q.shape).astype(
        np.float32)
    qd = g.normal(0, 0.5, jst.sim.qd.shape).astype(np.float32)
    hist = g.normal(size=jst.task.amp_obs_hist.shape).astype(np.float32)
    mask = np.arange(N) % 2 == 0
    key = jax.random.PRNGKey(7)
    jsim, jtask = j.reset_idx(
        jst.sim._replace(q=jnp.asarray(q), qd=jnp.asarray(qd)),
        jha.AMPTaskState(jnp.asarray(hist)), jnp.asarray(mask), key)
    ids, times = _jax_reset_draws(j, key)
    from isaacgymenvs_ma_tpu_torch.physics.engine import SimState
    psim, ptask = p.reset_idx(
        SimState(torch.as_tensor(q), torch.as_tensor(qd)),
        pha.AMPTaskState(torch.as_tensor(hist)), torch.as_tensor(mask),
        draws=(torch.as_tensor(np.array(ids)),
               torch.as_tensor(np.array(times))))
    for got, want in ((psim.q, jsim.q), (psim.qd, jsim.qd),
                      (ptask.amp_obs_hist, jtask.amp_obs_hist)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    # the kept envs are untouched, the reset ones stand on the clip
    np.testing.assert_array_equal(psim.q.numpy()[~mask], q[~mask])
    assert (psim.q.numpy()[mask, 2] > 0.5).all()


def test_fetch_amp_obs_demo_matches_jax(tasks):
    j, p = tasks
    key = jax.random.PRNGKey(11)
    want = np.asarray(j.fetch_amp_obs_demo(key, 64))
    k1, k2 = jax.random.split(key)
    ids = j.motion_lib.sample_motions(k1, 64)
    times = j.motion_lib.sample_time(k2, ids, truncate_t=j.policy_dt)
    got = p.fetch_amp_obs_demo(64, draws=(
        torch.as_tensor(np.array(ids)), torch.as_tensor(np.array(times))))
    assert got.shape == (64, 210)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # drawn from the task generator: finite demo pairs of the clip
    assert torch.isfinite(p.fetch_amp_obs_demo(16)).all()


@pytest.mark.parametrize("name,b4", [("HumanoidAMP", False),
                                     ("HumanoidAMP", True),
                                     ("HumanoidAMPHands", False)])
def test_capture_replays_at_the_ground_rule(name, b4):
    """On the default loop, and at HumanoidAMP also on the B4 route (all
    42 candidate rows uncompacted: at most 16 are active, so it holds the
    loop's capture as Humanoid's does)."""
    e = parity.replay(GOLDEN[name], "cpu", use_contact_kernel=b4)
    assert e.finite
    tol = parity.TOLERANCES[name]
    assert tol == parity.GROUND_RULE_TOL
    for k, bound in tol.items():
        errs = getattr(e, k)
        assert (errs <= bound).all(), (k, errs)
    assert (e.reset_mismatches == 0).all()
    d = np.load(GOLDEN[name])
    # the first step resets the flagged envs by Reference State Init
    assert d["init_reset_buf"].sum() == N // 4


def test_early_termination_on_a_fallen_body(tasks):
    """A non-foot body in contact below the termination height ends the
    episode; the feet in contact do not."""
    _, p = tasks
    d = np.load(GOLDEN["HumanoidAMP"])
    from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax
    st = env_state_from_jax(
        {"sim.q": d["init_q"], "sim.qd": d["init_qd"],
         "progress": d["init_progress"],
         "reset_buf": np.zeros(N, np.int32),
         "task.amp_obs_hist": d["init_amp_obs_hist"]}, "cpu")
    out = p.engine.forward(st.sim)
    force = torch.zeros_like(out.contact_force)
    pos = out.body_pos.clone()
    head = p.model.body_names.index("head")
    feet = p.contact_body_ids
    force[0, head, 2] = 50.0
    pos[0, head, 2] = 0.2           # env 0: the head down and pressed
    force[1, feet, 2] = 300.0       # env 1: standing on its feet
    res = p.post_physics(st, out._replace(contact_force=force,
                                          body_pos=pos),
                         torch.zeros((N, 28)))
    assert res[3].tolist()[:2] == [1, 0]
    assert res[5]["amp_obs"].shape == (N, 210)


def test_b4_twin_matches_jax_solve_bl(monkeypatch):
    """The B4 twin on the inputs the port's B4 route hands it in one step
    from the capture's state (all 42 candidate rows: the route ignores
    ``contact_capacity``, as the JAX kernel route does) against the JAX
    kernel body."""
    import inspect
    from types import SimpleNamespace
    from isaacgymenvs_ma_tpu.physics import contact_kernel as jck
    from isaacgymenvs_ma_tpu_torch.convert import env_state_from_jax
    from isaacgymenvs_ma_tpu_torch.physics import contact_kernel as ck
    from isaacgymenvs_ma_tpu_torch.tasks.base import parse_sim_params
    d = np.load(GOLDEN["HumanoidAMP"])
    cfg = _cfg("HumanoidAMP")
    pt = pha.HumanoidAMP(cfg, device="cpu", seed=3,
                         sim_params=parse_sim_params(cfg["sim"])._replace(
                             use_contact_kernel=True))
    assert pt.engine.contact_route == "b4"
    st = env_state_from_jax(
        {"sim.q": d["q"][0], "sim.qd": d["qd"][0],
         "progress": np.ones(N, np.int32), "reset_buf": d["reset"][0],
         "task.amp_obs_hist": np.zeros((N, 2, 105), np.float32)}, "cpu")
    calls = []
    twin = ck.solve_bl

    def spy(plan, *a, **k):
        calls.append((plan, a, k))
        return twin(plan, *a, **k)

    monkeypatch.setattr(ck, "solve_bl", spy)
    pt.step(st, torch.as_tensor(d["actions"][1]),
            reset_draws=tuple(torch.as_tensor(d[k][1])
                              for k in ("motion_ids", "motion_times")))
    # two engine steps a control step (controlFrequencyInv), two substeps
    assert len(calls) == 2 * pt.sim_params.substeps
    for plan, a, k in calls:
        assert plan.P == 42
        got = twin(plan, *a, **k)
        args = inspect.signature(twin).bind(plan, *a, **k).arguments
        ref = jck.solve_bl(
            SimpleNamespace(relaxation=plan.relaxation,
                            num_iterations=plan.num_iterations),
            masks={"c": jnp.asarray(plan.masks["c"])},
            **{n: None if x is None else jnp.asarray(x.numpy())
               for n, x in args.items() if n != "plan"})
        for name, x, y in zip(("qd", "lam", "imp_dof"), got, ref):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
        assert float(np.abs(np.asarray(ref[1])).max()) > 0.01


def test_entry_point_asks_for_the_card():
    cfg = _cfg("HumanoidAMP")
    if torch.cuda.is_available():
        assert pregistry.create_task("HumanoidAMP", cfg).device.type == \
            "cuda"
    else:
        with pytest.raises(RuntimeError):
            pregistry.create_task("HumanoidAMP", cfg)
