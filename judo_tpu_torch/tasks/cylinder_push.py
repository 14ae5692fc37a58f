"""Planar cylinder pushing (counterpart of ``judo_tpu/tasks/cylinder_push.py``);
the CLI's default task."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from judo_tpu_torch.gui import slider
from judo_tpu_torch.ops.costs import quadratic_norm
from judo_tpu_torch.physics.model import PhysicsModel
from judo_tpu_torch.tasks.base import Task, TaskConfig, model_from_mujoco
from judo_tpu_torch.utils.fields import np_1d_field

# The JAX package's judo_tpu/models/xml/cylinder_push.xml.
CYLINDER_PUSH_XML = """<!-- Planar cylinder-pushing scene for judo_tpu.
     Physical spec matches the reference task: two frictionless upright
     cylinders on x/y sliders (pusher actuated with kp=10 position servos,
     cart passive), dt=0.02. -->
<mujoco model="cylinder_push">
  <option timestep="0.02"/>

  <worldbody>
    <body name="floor_body">
      <geom name="floor" type="box" size="10 10 0.1" pos="0 0 -0.25" mass="0" condim="3" rgba="0 1 1 1"/>
    </body>

    <body name="pusher">
      <joint name="slider_x" type="slide" axis="1 0 0" damping="4"/>
      <joint name="slider_y" type="slide" axis="0 1 0" damping="4"/>
      <geom name="pusher" type="cylinder" size="0.25 0.1" mass="1" friction="0" rgba="0.9 0.5 0.5 1"/>
      <site name="pusher_site" pos="0 0 0.15"/>
    </body>

    <body name="cart">
      <joint name="slider_cart_x" type="slide" axis="1 0 0" damping="4"/>
      <joint name="slider_cart_y" type="slide" axis="0 1 0" damping="4"/>
      <geom name="cart" type="cylinder" size="0.25 0.1" mass="1" friction="0" rgba="0.1 0.5 0.5 1"/>
      <site name="cart_site" pos="0 0 0.15"/>
    </body>
  </worldbody>

  <actuator>
    <position name="actuator_pusher_x" joint="slider_x" kp="10" ctrlrange="-10 10" forcerange="-1000 1000"/>
    <position name="actuator_pusher_y" joint="slider_y" kp="10" ctrlrange="-10 10" forcerange="-1000 1000"/>
  </actuator>

  <sensor>
    <framepos name="trace_pusher" objtype="site" objname="pusher_site"/>
    <framepos name="trace_cart" objtype="site" objname="cart_site"/>
  </sensor>
</mujoco>
"""


@slider("w_pusher_proximity", 0.0, 5.0, 0.1)
@dataclass
class CylinderPushConfig(TaskConfig):
    """Reward weights and the draggable goal."""

    w_pusher_proximity: float = 0.5
    w_pusher_velocity: float = 0.0
    w_cart_position: float = 0.1
    pusher_goal_offset: float = 0.25
    goal_pos: np.ndarray = np_1d_field(
        np.array([0.0, 0.0]),
        names=["x", "y"],
        mins=[-1.0, -1.0],
        maxs=[1.0, 1.0],
        steps=[0.01, 0.01],
        vis_name="goal_position",
        xyz_vis_indices=[0, 1, None],
        xyz_vis_defaults=[0.0, 0.0, 0.0],
    )


class CylinderPush(Task[CylinderPushConfig]):
    """Push the cart cylinder to a movable goal with the pusher cylinder."""

    name: str = "cylinder_push"
    config_t: type[CylinderPushConfig] = CylinderPushConfig

    def __init__(self, device: Any = "cuda", dtype: torch.dtype = torch.float32) -> None:
        super().__init__(device=device, dtype=dtype)
        self.reset()

    @classmethod
    def _model_from_mujoco(cls) -> tuple[PhysicsModel, dict]:
        return model_from_mujoco(CYLINDER_PUSH_XML, cls.planning_solver_iterations)

    def reward(self, states, sensors, controls, params, system_metadata=None) -> torch.Tensor:
        """Pusher behind the cart, pusher velocity, cart to goal."""
        pusher_pos, cart_pos, pusher_vel = states[..., 0:2], states[..., 2:4], states[..., 4:6]
        goal = params["goal_pos"][0:2]
        cart_to_goal = goal - cart_pos
        direction = cart_to_goal / torch.linalg.norm(cart_to_goal, dim=-1, keepdim=True)
        pusher_goal = cart_pos - params["pusher_goal_offset"] * direction
        pusher_rew = -params["w_pusher_proximity"] * quadratic_norm(pusher_pos - pusher_goal).sum(-1)
        velocity_rew = -params["w_pusher_velocity"] * quadratic_norm(pusher_vel).sum(-1)
        goal_rew = -params["w_cart_position"] * quadratic_norm(cart_pos - goal).sum(-1)
        return pusher_rew + velocity_rew + goal_rew

    def reset(self) -> None:
        """Random start on two rings, from numpy's global generator."""
        theta = 2 * np.pi * np.random.rand(2)
        self.qpos = np.array([np.cos(theta[0]), np.sin(theta[0]), 2 * np.cos(theta[1]), 2 * np.sin(theta[1])])
        self.qvel = np.zeros(4)
        self.time = 0.0
