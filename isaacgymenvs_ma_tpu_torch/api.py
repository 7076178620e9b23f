"""Programmatic environment-creation API (port of isaacgymenvs_ma_tpu/api.py,
reference isaacgymenvs/__init__.py:14-55)."""
from __future__ import annotations


def make(seed: int, task: str, num_envs: int, sim_device: str = "cuda:0",
         rl_device: str = "cuda:0", graphics_device_id: int = -1,
         headless: bool = True, multi_gpu: bool = False,
         virtual_screen_capture: bool = False, force_render: bool = False,
         cfg=None):
    """Create a vectorized task env, mirroring ``isaacgymenvs.make``.

    The task lives on ``sim_device`` (the card unless the caller asks for
    the CPU); the other device and display arguments are accepted for API
    parity, as in the JAX package.
    """
    from .tasks import registry
    from .utils.config import load_task_config

    if cfg is None:
        cfg = load_task_config(task, overrides=[f"env.numEnvs={num_envs}"])
    return registry.create_task(task, cfg, seed=seed, headless=headless,
                                device=sim_device)
