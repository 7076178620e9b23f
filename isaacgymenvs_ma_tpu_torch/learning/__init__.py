"""The PPO learner of the port (counterpart of isaacgymenvs_ma_tpu/learning):
``configs``, ``networks``, ``running_norm``, ``ppo``, ``checkpoint``."""
