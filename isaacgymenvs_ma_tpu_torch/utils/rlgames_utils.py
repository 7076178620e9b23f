"""The rl_games adapter layer (port of
isaacgymenvs_ma_tpu/utils/rlgames_utils.py; reference
utils/rlgames_utils.py).

The port's learner drives the functional task API itself; these thin
stateful shims keep code written against the reference's adapters
working:

* :func:`multi_gpu_get_rank` (ref :44-50): ``torch.distributed``'s rank
  when it is initialized, else 0;
* :func:`get_rlgames_env_creator` (ref :53-127): a closure that builds the
  task through the registry and wraps it;
* :class:`RLGPUEnv` (ref :242-297): step / reset / ``reset_done`` over a
  carried ``EnvState``, ``get_env_info`` (the MA hook ``agents``) and the
  ``get/set_env_state`` checkpoint pass-through;
* :class:`ComplexObsRLGPUEnv` (ref :300-424): the dict-observation variant
  driven by an ``obs_spec`` (Dextreme).

The task's ``step`` is called as it is (no graph capture or compile).
"""
from __future__ import annotations

from typing import Any, Dict

import torch


def multi_gpu_get_rank(multi_gpu: bool = True) -> int:
    if multi_gpu and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def get_rlgames_env_creator(seed, task_config, task_name, sim_device,
                            rl_device, graphics_device_id=0, headless=True,
                            multi_gpu=False, post_create_hook=None,
                            virtual_screen_capture=False, force_render=False):
    """A closure building the task on ``sim_device`` and wrapping it in
    :class:`RLGPUEnv` (ref :53-127); ``rl_device`` and the graphics
    arguments are accepted for parity and unused."""
    def create_rlgpu_env(**kwargs):
        from ..tasks import registry
        task = registry.create_task(task_name, task_config, seed=seed,
                                    headless=headless, device=sim_device)
        env = RLGPUEnv(task)
        if post_create_hook is not None:
            post_create_hook()
        return env
    return create_rlgpu_env


class RLGPUEnv:
    """Stateful gym-style wrapper over the functional task API; the
    task's draws come from its own generator."""

    def __init__(self, task):
        self.task = task
        self._state = task.initial_state()

    def step(self, actions):
        self._state, res = self.task.step(self._state, actions)
        obs = {"obs": res.obs}
        if res.states is not None:
            obs["states"] = res.states
        return obs, res.rew, res.reset, res.extras

    def reset(self):
        self._state, obs = self.task.reset(self._state)
        return {"obs": obs}

    def _reset_done(self):
        """The ids of the flagged envs (one host read) and the task's
        ``reset_done``."""
        done = torch.nonzero(self._state.reset_buf)[:, 0].cpu()
        self._state, obs, states = self.task.reset_done(self._state)
        return done, obs, states

    def reset_done(self):
        """(vec_task.py:442-457) reset the done envs, return their fresh
        observations and the done env ids (the AMP / common_agent
        contract)."""
        done, obs, states = self._reset_done()
        obs_dict = {"obs": obs}
        if states is not None:
            obs_dict["states"] = states
        return obs_dict, done

    def get_number_of_agents(self) -> int:
        return self.task.num_agents

    def get_env_info(self) -> Dict[str, Any]:
        return self.task.get_env_info()

    def get_env_state(self):
        return self.task.get_env_state(self._state)

    def set_env_state(self, env_state):
        self._state = self.task.set_env_state(self._state, env_state)

    def set_train_info(self, env_frames, *args, **kwargs):
        self._state = self.task.set_train_info(self._state, env_frames)


class ComplexObsRLGPUEnv(RLGPUEnv):
    """Dict-observation wrapper driven by an ``obs_spec`` (ref :300-424).

    Each entry is ``{out_name: {"names": [part, ...], "concat": bool,
    "space_name": str}}``.  The parts are the task's named groups
    (``split_obs`` / ``split_states`` of a ``dict_obs_cls`` task) and the
    flat ``obs`` / ``states``; ``concat`` (default) joins the parts into
    one ``(B, sum)`` tensor, else the entry is a dict by part; an unknown
    part raises ``KeyError``.  ``space_name`` keys the entry's space in
    :meth:`get_env_info` (default ``observation_space`` for ``obs``, else
    ``<name>_space``).
    """

    def __init__(self, task, obs_spec: Dict[str, dict]):
        super().__init__(task)
        self.obs_spec = obs_spec
        sizes = {"obs": task.num_obs, "states": task.num_states}
        for name, size in (getattr(task, "obs_spec", None) or []):
            sizes[name] = size
        for name, size in (getattr(task, "state_spec", None) or []):
            sizes.setdefault(name, size)
        self._part_sizes = sizes

    def _env_obs(self, obs, states) -> Dict[str, Any]:
        """The named observation parts, as the reference env emits them."""
        parts: Dict[str, Any] = {"obs": obs}
        if states is not None:
            parts["states"] = states
        t = self.task
        if t.dict_obs_cls and getattr(t, "obs_spec", None):
            parts.update(t.split_obs(obs))
            if states is not None and getattr(t, "state_spec", None):
                for k, v in t.split_states(states).items():
                    parts.setdefault(k, v)
        return parts

    def _build(self, obs, states):
        parts = self._env_obs(obs, states)
        out = {}
        for name, spec in self.obs_spec.items():
            names = spec.get("names", [name])
            missing = [n for n in names if n not in parts]
            if missing:
                raise KeyError(
                    f"obs_spec entry {name!r} references unknown observation "
                    f"parts {missing}; available: {sorted(parts)}")
            if spec.get("concat", True):
                out[name] = torch.cat([parts[n] for n in names], -1)
            else:
                out[name] = {n: parts[n] for n in names}
        return out

    def step(self, actions):
        self._state, res = self.task.step(self._state, actions)
        return self._build(res.obs, res.states), res.rew, res.reset, \
            res.extras

    def reset(self):
        self._state, obs = self.task.reset(self._state)
        t = self.task
        states = (torch.zeros((t.rl_games_batch, t.num_states),
                              dtype=obs.dtype, device=obs.device)
                  if t.num_states > 0 else None)
        return self._build(obs, states)

    def reset_done(self):
        done, obs, states = self._reset_done()
        return self._build(obs, states), done

    def get_env_info(self) -> Dict[str, Any]:
        info = dict(self.task.get_env_info())
        for name, spec in self.obs_spec.items():
            names = spec.get("names", [name])
            space_name = spec.get(
                "space_name",
                "observation_space" if name == "obs" else f"{name}_space")
            if spec.get("concat", True):
                info[space_name] = (sum(self._part_sizes[n] for n in names),)
            else:
                info[space_name] = {n: (self._part_sizes[n],) for n in names}
        return info
