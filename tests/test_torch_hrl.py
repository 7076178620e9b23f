"""The port's HRL layer (isaacgymenvs_ma_tpu_torch/learning/hrl.py): the
three cases of tests/test_hrl.py on the port, and the wrapper's step
against the JAX package's with the same LLC parameters at Cartpole-8.

JAX's reset draws cannot be matched in torch: each inner step's Cartpole
reset draws are rebuilt from the inner env's key chain
(``test_torch_ppo_epoch.jax_reset_draws``) and injected.  Tolerances: the
obs, the averaged reward and the state at Cartpole's capture bounds
(``parity.CARTPOLE_GOLDEN_TOL``), resets exact; the LLC's actions 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from isaacgymenvs_ma_tpu.learning import hrl as jhrl
from isaacgymenvs_ma_tpu.tasks.cartpole import Cartpole as JCartpole
from isaacgymenvs_ma_tpu.tasks.cartpole import TASK_CFG as JCFG
from isaacgymenvs_ma_tpu_torch.convert import params_from_jax
from isaacgymenvs_ma_tpu_torch.learning.hrl import (HRLTaskWrapper,
                                                    LatentConditionedActor,
                                                    build_llc_from_checkpoint)
from isaacgymenvs_ma_tpu_torch.tasks.cartpole import TASK_CFG, Cartpole
from isaacgymenvs_ma_tpu_torch.utils.parity import CARTPOLE_GOLDEN_TOL

from test_torch_ppo_epoch import cartpole_draws, jax_reset_draws

torch.set_num_threads(1)   # small CPU ops: one thread a test worker


def _wrapped(n=8, llc_steps=3, latent_dim=4):
    cfg = copy.deepcopy(TASK_CFG)
    cfg["env"]["numEnvs"] = n
    task = Cartpole(cfg, device="cpu", seed=0)
    llc, latent_dim = build_llc_from_checkpoint(
        task, {"latent_dim": latent_dim, "units": [32, 32]})
    return HRLTaskWrapper(task, llc, latent_dim, llc_steps)


def test_wrapper_surface_and_step():
    w = _wrapped()
    assert w.num_actions == 4                      # latent_dim
    assert w.get_env_info()["action_space"] == (4,)
    st, obs = w.reset(w.initial_state())
    st, res = w.step(st, torch.zeros((8, 4)))
    assert res.obs.shape == (8, w.num_obs)
    assert torch.isfinite(res.obs).all() and torch.isfinite(res.rew).all()
    # the reward is averaged over llc_steps: Cartpole's ~1 a step -> ~1
    assert float(res.rew.abs().max()) < 10.0
    assert not any(p.requires_grad for p in w.llc.parameters())


def test_llc_substeps_advance_inner_env():
    w = _wrapped(llc_steps=4)
    st, _ = w.reset(w.initial_state())
    st1, _ = w.step(st, torch.ones((8, 4)))
    # inner progress advanced by llc_steps (minus the reset on step 1)
    assert int(st1.inner.progress.max()) == 3


def test_ppo_trains_on_wrapper():
    from isaacgymenvs_ma_tpu_torch.learning.configs import (
        train_default_config)
    from isaacgymenvs_ma_tpu_torch.learning.ppo import PPOAgent
    w = _wrapped(n=16)
    tcfg = train_default_config("Cartpole")
    tcfg["params"]["config"]["horizon_length"] = 8
    tcfg["params"]["config"]["minibatch_size"] = 64
    agent = PPOAgent(w, tcfg, seed=0)
    agent.init()
    before = [p.detach().clone() for p in agent.net.parameters()]
    m = agent.train_epoch()
    assert np.isfinite(float(m["loss"]))
    assert all(torch.isfinite(p).all() for p in agent.net.parameters())
    assert any(not torch.equal(a, b)
               for a, b in zip(before, agent.net.parameters()))
    assert agent.last_obs.shape == (16, w.num_obs)


def test_llc_network_matches_jax():
    net = jhrl.LatentConditionedActor(1, (32, 32))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)),
                      jnp.zeros((1, 4)))
    llc = LatentConditionedActor(4, 4, 1, (32, 32))
    llc.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    g = np.random.default_rng(0)
    o = g.normal(size=(64, 4)).astype(np.float32)
    z = g.normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        llc(torch.as_tensor(o), torch.as_tensor(z)).detach().numpy(),
        np.asarray(net.apply(params, o, z)), rtol=1e-5, atol=1e-5)


def test_wrapper_step_matches_jax():
    """Two outer steps of 3 inner steps (every env reset in the first
    inner step) from the same state, LLC and latents."""
    n, ld, llc_steps = 8, 4, 3
    jcfg = copy.deepcopy(JCFG)
    jcfg["env"]["numEnvs"] = n
    jtask = JCartpole(jcfg)
    apply_fn, params, _ = jhrl.build_llc_from_checkpoint(
        jtask, {"latent_dim": ld, "units": [32, 32]},
        key=jax.random.PRNGKey(4))
    jw = jhrl.HRLTaskWrapper(jtask, apply_fn, params, ld, llc_steps)
    jst, _ = jw.reset(jw.initial_state(jax.random.PRNGKey(1)))
    jstep = jax.jit(jw.step)

    pw = _wrapped(n=n, llc_steps=llc_steps, latent_dim=ld)
    pw.llc.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        params)))
    pst, _ = pw.reset(pw.initial_state())
    g = np.random.default_rng(5)
    for _ in range(2):
        latents = g.normal(size=(n, ld)).astype(np.float32)
        draws = jax_reset_draws(jst.inner.rng, llc_steps, n, cartpole_draws)
        jst, jres = jstep(jst, jnp.asarray(latents))
        pst, pres = pw.step(pst, torch.as_tensor(latents),
                            reset_draws=draws)
        np.testing.assert_array_equal(pres.reset.numpy(),
                                      np.asarray(jres.reset))
        for got, want, k in ((pres.obs, jres.obs, "obs"),
                             (pres.rew, jres.rew, "rew"),
                             (pst.inner.sim.q, jst.inner.sim.q, "q"),
                             (pst.inner.sim.qd, jst.inner.sim.qd, "qd")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=CARTPOLE_GOLDEN_TOL[k],
                                       err_msg=k)
        np.testing.assert_array_equal(pst.inner.progress.numpy(),
                                      np.asarray(jst.inner.progress))
    assert int(pst.inner.progress.max()) == 2 * llc_steps - 1


def test_llc_from_a_saved_state_dict(tmp_path):
    """``build_llc_from_checkpoint`` loads an LLC's weights from a
    checkpoint written by ``checkpoint.save_checkpoint``."""
    from isaacgymenvs_ma_tpu_torch.learning.checkpoint import save_checkpoint
    w = _wrapped()
    path = str(tmp_path / "llc.pth")
    save_checkpoint(path, w.llc.state_dict())
    llc, latent = build_llc_from_checkpoint(
        w.task, {"latent_dim": 4, "units": [32, 32]}, path, seed=9)
    assert latent == 4
    for a, b in zip(llc.state_dict().values(), w.llc.state_dict().values()):
        assert torch.equal(a, b)
