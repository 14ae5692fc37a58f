"""Cartpole swing-up and balance (counterpart of ``judo_tpu/tasks/cartpole.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from judo_tpu_torch.ops.costs import quadratic_norm, smooth_l1_norm
from judo_tpu_torch.physics.model import PhysicsModel
from judo_tpu_torch.tasks.base import Task, TaskConfig, model_from_mujoco

# The JAX package's judo_tpu/models/xml/cartpole.xml.
CARTPOLE_XML = """<!-- Cartpole swing-up/balance scene for judo_tpu.
     Physical spec matches the reference task (slide cart + hinge pole,
     kp=100 position actuator, cart damping 10, dt=0.04, contacts off). -->
<mujoco model="cartpole">
  <option timestep="0.04">
    <flag contact="disable"/>
  </option>

  <asset>
    <material name="body_mat" rgba="0.7 0.5 0.3 1"/>
  </asset>

  <worldbody>
    <body name="cart">
      <joint name="joint_cart" type="slide" axis="1 0 0" range="-1.8 1.8" damping="10"/>
      <geom name="cart" type="box" size="0.2 0.15 0.1" mass="1" material="body_mat"/>
      <site name="trace_cart" size="0.01"/>
      <body name="pole">
        <joint name="joint_pole" type="hinge" axis="0 1 0" damping="0"/>
        <geom name="pole" type="capsule" fromto="0 0 0 0 0 1" size="0.045" mass="0.1" material="body_mat"/>
        <site name="trace_pole" pos="0 0 1" size="0.01"/>
      </body>
    </body>
  </worldbody>

  <actuator>
    <position name="actuator_cart" joint="joint_cart" kp="100" ctrlrange="-1.8 1.8" forcerange="-10 10"/>
  </actuator>

  <sensor>
    <framepos name="trace_cart" objtype="site" objname="trace_cart"/>
    <framepos name="trace_pole" objtype="site" objname="trace_pole"/>
  </sensor>
</mujoco>
"""


@dataclass
class CartpoleConfig(TaskConfig):
    """MJPC-style reward weights."""

    w_vertical: float = 10.0
    w_centered: float = 10.0
    w_velocity: float = 0.1
    w_control: float = 0.1
    p_vertical: float = 0.01
    p_centered: float = 0.1


class Cartpole(Task[CartpoleConfig]):
    """Swing up and balance the pole while centering the cart."""

    name: str = "cartpole"
    config_t: type[CartpoleConfig] = CartpoleConfig

    def __init__(self, device: Any = "cuda", dtype: torch.dtype = torch.float32) -> None:
        super().__init__(device=device, dtype=dtype)
        self.reset()

    @classmethod
    def model_xml(cls) -> str:
        return CARTPOLE_XML

    @classmethod
    def _model_from_mujoco(cls) -> tuple[PhysicsModel, dict]:
        return model_from_mujoco(cls.model_xml(), cls.planning_solver_iterations)

    def reward(self, states, sensors, controls, params, system_metadata=None) -> torch.Tensor:
        """Pole-vertical and cart-centered (smooth L1), quadratic velocity and
        control penalties, summed over time."""
        vertical = -params["w_vertical"] * smooth_l1_norm(torch.cos(states[..., 1]) - 1.0, params["p_vertical"]).sum(-1)
        centered = -params["w_centered"] * smooth_l1_norm(states[..., 0], params["p_centered"]).sum(-1)
        velocity = -params["w_velocity"] * quadratic_norm(states[..., 2:]).sum(-1)
        control = -params["w_control"] * quadratic_norm(controls).sum(-1)
        return vertical + centered + velocity + control

    def reset(self) -> None:
        """Random start around (1, pi), from numpy's global generator."""
        self.qpos = np.array([1.0, np.pi]) + np.random.randn(2)
        self.qvel = 1e-1 * np.random.randn(2)
        self.time = 0.0
