"""Ingenuity Mars helicopter (port of isaacgymenvs_ma_tpu/tasks/
ingenuity.py): obs 13 / act 6.

A free-flying chassis box with two rotor bodies fixed to it (nb 3, nv 6);
the actions command a thrust vector per rotor in the chassis frame,
applied as external wrenches (``Control.f_ext``) at the rotors; Mars
gravity from the config.  Targets are drawn again every 500 steps;
obs = [(target - pos) / 3, quat, linvel / 2, angvel / pi]; position, up
and spin rewards with distance gating.  The chassis box gives 8 ground
candidate rows.

The JAX package draws the new targets from ``fold_in(rng, 31)``; here
they come from the task's generator, or from ``step(...,
step_draws=(targets_xy_u, targets_z_u))``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import DTYPE
from ..models.model import FIXED, FREE, GEOM_BOX, GEOM_CYLINDER, ModelBuilder
from ..ops import maths
from ..ops.rng import rand_float
from ..physics.engine import Control, SimState
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "Ingenuity",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 4096,
        "envSpacing": 2.5,
        "episodeLength": 2000,
        "enableDebugVis": False,
        "clipObservations": 5.0,
        "clipActions": 1.0,
    },
    "sim": {
        "dt": 0.01,
        "substeps": 2,
        "up_axis": "z",
        "use_gpu_pipeline": True,
        "gravity": [0.0, 0.0, -3.721],  # Mars (ref :114-117)
        "physx": {
            "num_threads": 4, "solver_type": 1, "use_gpu": True,
            "num_position_iterations": 4, "num_velocity_iterations": 0,
            "contact_offset": 0.02, "rest_offset": 0.001,
            "bounce_threshold_velocity": 0.2,
            "max_depenetration_velocity": 1000.0,
            "default_buffer_size_multiplier": 5.0,
            "max_gpu_contact_pairs": 1048576, "contact_collection": 0,
        },
    },
    "task": {"randomize": False},
}


def build_ingenuity():
    """Chassis box (0.06 half, density 50) + two locked rotor cylinders
    (r 0.15, half-thickness 0.005, density 1000) at z=0 and z=0.025."""
    b = ModelBuilder()
    b.begin_actor()
    chassis = b.add_body("chassis", -1, FREE, body_pos=(0, 0, 1.0))
    b.add_geom(chassis, GEOM_BOX, (0.06, 0.06, 0.06), density=50.0)
    rotors = []
    for i in range(2):
        r = b.add_body(f"rotor_physics_{i}", chassis, FIXED,
                       body_pos=(0, 0, 0.025 * i))
        b.add_geom(r, GEOM_CYLINDER, (0.15, 0.005, 0.0), density=1000.0,
                   contact=False)
        rotors.append(r)
    m = b.finalize()
    return m, rotors


class IngenuityTaskState(NamedTuple):
    target: torch.Tensor  # (N, 3)


class Ingenuity(VecTaskBase):
    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        cfg["env"]["numObservations"] = 13
        cfg["env"]["numActions"] = 6
        super().__init__(cfg, device=device, seed=seed,
                         sim_params=sim_params)
        self.thrust_upper_limit = 2000.0
        self.thrust_lateral_component = 0.2
        self._rotor_bodies = torch.as_tensor(self.rotor_bodies,
                                             device=self.device)
        self.root0 = torch.tensor([0.0, 0.0, 1.0], device=self.device)
        self.quat0 = torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.device)

    def create_model(self):
        model, rotors = build_ingenuity()
        self.rotor_bodies = np.asarray(rotors)
        return model, True

    def initial_task_state(self):
        t = torch.zeros((self.num_envs, 3), dtype=DTYPE, device=self.device)
        t[:, 2] = 1.0
        return IngenuityTaskState(target=t)

    # ------------------------------------------------------------------
    def pre_physics(self, state: EnvState, actions) -> Control:
        """Rotor thrusts (ingenuity.py:97-124): each rotor's vertical
        thrust and its lateral share, rotated by the chassis orientation
        (the rotors are fixed to it) into world forces at the rotors."""
        n = self.num_envs
        lim, lat = self.thrust_upper_limit, self.thrust_lateral_component
        v0 = torch.clamp(actions[:, 2] * 2000.0, -lim, lim)
        v1 = torch.clamp(actions[:, 5] * 2000.0, -lim, lim)
        lat0 = torch.clamp(actions[:, 0:2], -lat, lat)
        lat1 = torch.clamp(actions[:, 3:5], -lat, lat)
        t0z = self.dt * v0
        t1z = self.dt * v1
        thrust0 = torch.cat([t0z[:, None] * lat0, t0z[:, None]], -1)
        thrust1 = torch.cat([t1z[:, None] * lat1, t1z[:, None]], -1)
        root_quat = state.sim.q[:, 3:7]
        f = torch.stack([maths.quat_apply(root_quat, thrust0),
                         maths.quat_apply(root_quat, thrust1)], 1)
        # no thrust in the envs reset this step (ref :356)
        f = torch.where((state.reset_buf > 0)[:, None, None], 0.0, f)
        f_ext = torch.zeros((n, self.engine.nb, 6), dtype=DTYPE,
                            device=self.device)
        f_ext[:, self._rotor_bodies, 3:6] = f
        return Control(tau=torch.zeros((n, self.engine.nv), dtype=DTYPE,
                                       device=self.device), f_ext=f_ext)

    def draw_targets(self):
        """New targets' draws from the task generator: U(0, 1) (N, 2) for
        x, y and (N, 1) for z (ingenuity.py:142-154)."""
        n, g = self.num_envs, self.generator
        return rand_float(g, 0.0, 1.0, (n, 2)), rand_float(g, 0.0, 1.0,
                                                           (n, 1))

    def draw_reset(self):
        """Reset draws from the task generator: the chassis offsets xy
        U(-1.5, 1.5) (N, 2) and z U(-0.2, 1.5) (N, 1), then the targets'
        (:meth:`draw_targets`)."""
        n, g = self.num_envs, self.generator
        return (rand_float(g, -1.5, 1.5, (n, 2)),
                rand_float(g, -0.2, 1.5, (n, 1)), *self.draw_targets())

    def _sample_targets(self, draws, mask, cur):
        xy_u, z_u = draws
        t = torch.cat([xy_u * 10.0 - 5.0, z_u + 1.0], -1)
        return masked_update(mask, t, cur)

    def reset_idx(self, sim: SimState, task: IngenuityTaskState, mask,
                  draws=None):
        off_xy, off_z, t_xy, t_z = self.draw_reset() if draws is None \
            else draws
        n = self.num_envs
        q, qd = sim.q.clone(), sim.qd.clone()
        root = torch.cat([self.root0 + torch.cat([off_xy, off_z], -1),
                          self.quat0.expand(n, 4)], -1)
        q[:, 0:7] = masked_update(mask, root, q[:, 0:7])
        qd[:, 0:6] = masked_update(mask, torch.zeros_like(qd[:, 0:6]),
                                   qd[:, 0:6])
        task = IngenuityTaskState(
            target=self._sample_targets((t_xy, t_z), mask, task.target))
        return SimState(q, qd), task

    def post_physics(self, state: EnvState, out, actions, draws=None):
        task: IngenuityTaskState = state.task
        # mid-episode targets drawn again every 500 steps (:322-326)
        retarget = (state.progress % 500) == 0
        target = self._sample_targets(
            self.draw_targets() if draws is None else draws, retarget,
            task.target)

        root = out.root_states[:, 0]
        root_pos, root_quat = root[:, 0:3], root[:, 3:7]
        linvel, angvel = root[:, 7:10], root[:, 10:13]
        obs = torch.cat([(target - root_pos) / 3.0, root_quat, linvel / 2.0,
                         angvel / math.pi], -1)

        target_dist = torch.linalg.vector_norm(target - root_pos, dim=-1)
        pos_reward = 1.0 / (1.0 + target_dist * target_dist)
        ups = maths.quat_axis(root_quat, 2)
        tiltage = torch.abs(1.0 - ups[:, 2])
        up_reward = 5.0 / (1.0 + tiltage * tiltage)
        spinnage = torch.abs(angvel[:, 2])
        spin_reward = 1.0 / (1.0 + spinnage * spinnage)
        rew = pos_reward + pos_reward * (up_reward + spin_reward)

        die = (target_dist > 8.0) | (root_pos[:, 2] < 0.5)
        reset = torch.where(state.progress >= self.max_episode_length - 1, 1,
                            die.to(torch.int32)).to(torch.int32)
        return obs, None, rew, reset, IngenuityTaskState(target=target), {}
