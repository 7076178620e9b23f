"""Port parity of AllegroHand and its config variants
(isaacgymenvs_ma_tpu_torch/tasks/allegro_hand.py) against the JAX package,
with the checks of tests/test_torch_shadow_hand.py (the same tolerances).

* The composed scene: the copied spec with the reference's dof overrides
  (kp 3, kd 0.1, drive force limit 0.5, dof friction 0.01, armature
  0.001), the palm slab and fill boxes, fingertip and phalanx spheres,
  the tilted placement; the engine's rows and pair list.
* ``reset_idx``, ``pre_physics`` (AllegroHandLSTM's per-env moving
  average from the ``{range}`` form, the random object force) and
  ``post_physics`` for each of the four observation types (42 / 50 / 72 /
  88, no fingertip states) with the 88 critic states, against the JAX
  methods from a capture's state.
* The AllegroHand and AllegroHandLSTM captures replayed on the CPU twins
  one step at a time; the registry's variant deltas; the entry point.
"""
import numpy as np
import pytest
import torch

from test_torch_shadow_hand import (SIZES, _pair, check_capture,
                                    check_post_physics, check_pre_physics,
                                    check_replay, check_reset_idx,
                                    check_scene, check_variant)
from isaacgymenvs_ma_tpu_torch.tasks import registry as pregistry
from isaacgymenvs_ma_tpu_torch.utils.config import deep_merge

torch.set_num_threads(1)   # small CPU ops: one thread a test worker


@pytest.mark.parametrize("name", ["AllegroHand", "AllegroHandLSTM"])
def test_scene_matches_jax(name):
    jt, pt = check_scene(name)
    m = pt.model
    hand = slice(0, 16)                  # the cube's 6 dofs come after
    assert (np.asarray(m.dof_friction)[hand] == 0.01).all()
    assert (np.asarray(m.dof_stiffness)[hand] == 3.0).all()
    assert (np.asarray(m.dof_effort_limit)[hand] == 0.5).all()
    assert (np.asarray(m.dof_armature)[hand] == 0.001).all()
    assert not np.asarray(m.dof_friction)[16:].any()
    assert pt.engine.has_dof_friction and not pt.obs_include_fingertips
    names = [g.name for g in m.geoms]
    assert {"palm_box", "palm_fill"} <= set(names)
    assert sum(n.startswith(("tip_", "pad_")) for n in names) == 12
    assert len(pt.coupled_distal) == 0 and len(pt.actuated) == 16


@pytest.mark.parametrize("name", ["AllegroHand", "AllegroHandLSTM"])
def test_reset_idx_matches_jax(name):
    check_reset_idx(name)


@pytest.mark.parametrize("name", ["AllegroHand", "AllegroHandLSTM"])
def test_pre_physics_matches_jax(name):
    check_pre_physics(name)


def test_lstm_variant_moving_average_is_per_env():
    """The ``{range: [0.15, 0.35]}`` moving average: a static per-env draw
    (N, 1) after the force probabilities from the same numpy stream."""
    jt, pt = _pair("AllegroHandLSTM", n=64)
    ama = pt.act_moving_average.numpy()
    assert ama.shape == (64, 1)
    assert 0.15 <= ama.min() < ama.max() <= 0.35
    np.testing.assert_array_equal(ama, np.asarray(jt.act_moving_average))


@pytest.mark.parametrize("obs_type,max_successes", [
    ("openai", 0), ("full_no_vel", 50), ("full", 0), ("full_state", 50)])
def test_post_physics_matches_jax(obs_type, max_successes):
    check_post_physics("AllegroHand", obs_type, max_successes)


@pytest.mark.parametrize("name", ["AllegroHand", "AllegroHandLSTM"])
def test_capture_format(name):
    d = check_capture(name, *SIZES[name][4:6])
    if name == "AllegroHandLSTM":
        assert np.abs(d["init_rb_force"]).max() > 0


@pytest.mark.parametrize("name", ["AllegroHand", "AllegroHandLSTM"])
def test_golden_replay_on_cpu_twins(name):
    check_replay(name)


@pytest.mark.parametrize("name", ["AllegroHandLSTM", "AllegroHandFF",
                                  "AllegroHandLSTM_Big"])
def test_registry_variants_match_jax(name):
    check_variant(name, "AllegroHand")


def test_dextreme_names_stay_unported():
    """The four Dextreme names raised until ROADMAP queue A item 7c was
    ported (tests/test_torch_dextreme.py), the Factory and IndustReal
    names (item 9) until they were (tests/test_torch_factory.py), and the
    AMP and SAC names (item 10) until they were
    (tests/test_torch_humanoid_amp.py, tests/test_torch_sac.py): no name
    raises now, and the SAC names build their PPO tasks as they are."""
    for name in ("FactoryTaskNutBoltPick", "IndustRealTaskPegsInsert",
                 "HumanoidAMP"):
        assert pregistry.task_class(name).__name__ == name
    for name, base in (("AntSAC", "Ant"), ("HumanoidSAC", "Humanoid")):
        assert pregistry.task_class(name).__name__ == base
        assert pregistry.task_default_config(name) == \
            pregistry.task_default_config(base)


@pytest.mark.parametrize("name", ["AllegroHand", "AllegroHandLSTM"])
def test_entry_point_asks_for_the_card(name):
    cfg = deep_merge(pregistry.task_default_config(name),
                     {"env": {"numEnvs": 8}})
    if torch.cuda.is_available():
        assert pregistry.create_task(name, cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pregistry.create_task(name, cfg)
