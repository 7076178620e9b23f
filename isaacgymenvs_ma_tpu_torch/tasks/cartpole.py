"""Cartpole (port of isaacgymenvs_ma_tpu/tasks/cartpole.py) — obs 4 / act 1.

The JAX package's bitwise-parity anchor (tests/test_golden_cartpole.py).
A fixed-base 2-dof articulation: a prismatic cart along Y and a pole
hinged about X with its com 0.47 m out, an effort drive on the cart only
with zero drive stiffness and damping, built procedurally with the
parameters of ``assets/urdf/cartpole.urdf`` (``env.asset.assetFileName``
parses a URDF instead).  What the step exercises in the engine: the
smallest tree kernels B1-B3 run (a fixed root, a SLIDE and a HINGE, nv 2),
and, with no contact rows, the joint-limit solve
(:meth:`..physics.engine.PhysicsEngine._limit_solve`) on the cart's +-4 m
limits; no kernel B4 and no B5.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..device import DTYPE
from ..models.model import (DRIVE_EFFORT, FIXED, GEOM_BOX, HINGE, SLIDE,
                            ModelBuilder)
from ..models.urdf import load_urdf
from ..physics.engine import Control, SimState
from .base import EnvState, VecTaskBase, masked_update

TASK_CFG = {
    "name": "Cartpole",
    "physics_engine": "physx",
    "env": {
        "numEnvs": 512,
        "envSpacing": 4.0,
        "resetDist": 3.0,
        "maxEffort": 400.0,
        "numObservations": 4,
        "numActions": 1,
        "clipObservations": 5.0,
        "clipActions": 1.0,
        "asset": {},
        "enableCameraSensors": False,
    },
    "sim": {
        "dt": 0.0166,  # 1/60 s (cfg/task/Cartpole.yaml:27)
        "substeps": 2,
        "up_axis": "z",
        "use_gpu_pipeline": True,
        "gravity": [0.0, 0.0, -9.81],
        "physx": {
            "num_threads": 4,
            "solver_type": 1,
            "use_gpu": True,
            "num_position_iterations": 4,
            "num_velocity_iterations": 0,
            "contact_offset": 0.02,
            "rest_offset": 0.001,
            "bounce_threshold_velocity": 0.2,
            "max_depenetration_velocity": 100.0,
            "default_buffer_size_multiplier": 2.0,
            "max_gpu_contact_pairs": 1048576,
            "contact_collection": 0,
        },
    },
    "task": {"randomize": False},
}


def build_cartpole_model():
    """Procedural cartpole with the urdf's physical parameters (z-up, base
    at z = 2); copy of the JAX package's ``build_cartpole_model``."""
    b = ModelBuilder()
    b.begin_actor()
    slider = b.add_body("slider", -1, FIXED, body_pos=(0.0, 0.0, 2.0))
    # slider visual box has no mass in the urdf
    cart = b.add_body(
        "cart", slider, SLIDE, jnt_axis=(0.0, 1.0, 0.0),
        limit_lower=-4.0, limit_upper=4.0, effort_limit=1000.0,
        velocity_limit=100.0,
    )
    # mass 1, inertia from the 0.2 x 0.25 x 0.2 collision box
    cart_dims = np.array([0.2, 0.25, 0.2]) / 2
    b.add_geom(cart, GEOM_BOX, cart_dims, contact=False)
    b.set_body_mass(cart, 1.0, inertia=np.diag([
        (0.25**2 + 0.2**2) / 12.0, (0.2**2 + 0.2**2) / 12.0,
        (0.2**2 + 0.25**2) / 12.0]))
    pole = b.add_body(
        "pole", cart, HINGE, jnt_axis=(1.0, 0.0, 0.0),
        body_pos=(0.12, 0.0, 0.0), effort_limit=1000.0, velocity_limit=8.0,
    )
    # mass 1 at com (0, 0, 0.47), inertia of the 0.04 x 0.06 x 1.0 box
    b.add_geom(pole, GEOM_BOX, np.array([0.04, 0.06, 1.0]) / 2,
               pos=(0, 0, 0.47), contact=False)
    b.set_body_mass(pole, 1.0, com=(0.0, 0.0, 0.47), inertia=np.diag([
        (0.06**2 + 1.0**2) / 12.0, (0.04**2 + 1.0**2) / 12.0,
        (0.04**2 + 0.06**2) / 12.0]))
    m = b.finalize()
    # drive modes: dof 0 EFFORT, dof 1 NONE, zero stiffness and damping
    # (ref :115-119)
    m.dof_drive_mode[0] = DRIVE_EFFORT
    return m


class Cartpole(VecTaskBase):

    def __init__(self, cfg, device="cuda", seed: int = 0, sim_params=None):
        cfg["env"]["numObservations"] = 4
        cfg["env"]["numActions"] = 1
        cfg["env"].setdefault("episodeLength", 500)
        self.reset_dist = float(cfg["env"]["resetDist"])
        self.max_push_effort = float(cfg["env"]["maxEffort"])
        super().__init__(cfg, device=device, seed=seed, sim_params=sim_params)
        self.max_episode_length = 500   # hardcoded in the reference (:44)

    def create_model(self):
        asset = self.cfg["env"].get("asset", {})
        if asset.get("assetFileName"):
            root = asset.get("assetRoot", ".")
            model = load_urdf(os.path.join(root, asset["assetFileName"]),
                              fix_base_link=True, base_pos=(0, 0, 2.0))
            model.dof_drive_mode[0] = DRIVE_EFFORT
            return model, False
        return build_cartpole_model(), False

    # ------------------------------------------------------------------
    def pre_physics(self, state: EnvState, actions) -> Control:
        # force on the cart slider only (ref :159-163)
        tau = torch.zeros((self.num_envs, self.engine.nv), dtype=DTYPE,
                          device=self.device)
        tau[:, 0] = actions[:, 0] * self.max_push_effort
        return Control(tau=tau)

    def draw_reset(self):
        """Reset draws from the task generator (ref :144-149): dof positions
        0.2 (U - 0.5) and velocities 0.5 (U - 0.5), each (N, 2)."""
        n, g = self.num_envs, self.generator
        pos, vel = (torch.rand((n, 2), generator=g, device=g.device,
                               dtype=DTYPE) for _ in range(2))
        return 0.2 * (pos - 0.5), 0.5 * (vel - 0.5)

    def reset_idx(self, sim: SimState, task, mask, draws=None):
        positions, velocities = self.draw_reset() if draws is None else draws
        dof_pos = masked_update(mask, positions, self.engine.dof_pos(sim))
        dof_vel = masked_update(mask, velocities, self.engine.dof_vel(sim))
        sim = self.engine.set_dof_pos(sim, dof_pos)
        sim = self.engine.set_dof_vel(sim, dof_vel)
        return sim, task

    def post_physics(self, state: EnvState, out, actions):
        dof_pos = self.engine.dof_pos(state.sim)
        dof_vel = self.engine.dof_vel(state.sim)
        obs = torch.stack([dof_pos[:, 0], dof_vel[:, 0], dof_pos[:, 1],
                           dof_vel[:, 1]], dim=-1)
        cart_pos, cart_vel = obs[:, 0], obs[:, 1]
        pole_angle, pole_vel = obs[:, 2], obs[:, 3]
        # reward kernel (ref :186-205)
        reward = (1.0 - pole_angle * pole_angle - 0.01 * torch.abs(cart_vel)
                  - 0.005 * torch.abs(pole_vel))
        fail = ((torch.abs(cart_pos) > self.reset_dist)
                | (torch.abs(pole_angle) > np.pi / 2))
        reward = torch.where(fail, -2.0, reward)
        reset = (fail | (state.progress >= self.max_episode_length - 1)).to(
            torch.int32)
        return obs, None, reward, reset, state.task, {}
