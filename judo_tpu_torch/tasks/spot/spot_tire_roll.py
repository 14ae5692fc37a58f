"""SpotTireRoll: roll an upright tire to a goal (counterpart of
``judo_tpu/tasks/spot/spot_tire_roll.py``). The tire is the reference's own
primitive proxy, a cylinder of radius 0.33 and half width 0.17
(``models/spot.py:TIRE_WORLDBODY``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from judo_tpu_torch.tasks.spot import spot_constants as sc
from judo_tpu_torch.tasks.spot.spot_base import SpotBase, SpotBaseConfig
from judo_tpu_torch.utils.fields import np_1d_field


@dataclass
class SpotTireRollConfig(SpotBaseConfig):
    fall_penalty: float = 5000.0
    tire_fallen_threshold: float = 0.1
    w_goal: float = 60.0
    w_torso_proximity: float = 1.0
    torso_goal_offset: float = 1.0
    w_gripper_proximity: float = 1.0
    gripper_goal_offset: float = 0.15
    gripper_goal_altitude: float = 0.05
    w_tire_linear_velocity: float = 10.0
    w_tire_angular_velocity: float = 0.30
    w_controls: float = 0.0
    goal_position: np.ndarray = np_1d_field(
        np.array([0.0, 0.0, sc.TIRE_RADIUS]),
        names=["x", "y", "z"],
        mins=[-5.0, -5.0, 0.0],
        maxs=[5.0, 5.0, 3.0],
        vis_name="goal_position",
        xyz_vis_indices=[0, 1, None],
    )


class SpotTireRoll(SpotBase[SpotTireRollConfig]):
    """Roll the tire to the goal, the gripper behind it and the torso back."""

    name: str = "spot_tire_roll"
    config_t: type[SpotTireRollConfig] = SpotTireRollConfig  # type: ignore[assignment]
    use_gripper = True
    object_joint = "tire_joint"

    def reward(self, states, sensors, controls, params, system_metadata=None) -> torch.Tensor:
        """Goal + offset targets + velocity damping + fall terms (spot_tire_roll.py:73-137)."""
        i, o, ov = self.body_pose_idx, self.object_pose_idx, self.object_vel_idx
        qpos = states[..., : self.nq]
        qvel = states[..., self.nq :]
        body_height = qpos[..., i + 2]
        body_pos = qpos[..., i : i + 3]
        object_pos = qpos[..., o : o + 3]
        tire_linvel = qvel[..., ov : ov + 3]
        tire_angvel = qvel[..., ov + 3 : ov + 6]
        g = self.sensor_adr["trace_fngr_site"]
        y = self.sensor_adr["object_y_axis"]
        gripper_pos = sensors[..., g : g + 3]
        object_y_axis = sensors[..., y : y + 3]
        dtype = states.dtype

        tire_to_goal = params["goal_position"] - object_pos
        direction = tire_to_goal / (1e-2 + torch.linalg.norm(tire_to_goal, dim=-1, keepdim=True))
        gripper_goal = object_pos - params["gripper_goal_offset"] * direction
        gripper_goal[..., 2] = params["gripper_goal_altitude"]
        torso_goal = object_pos - params["torso_goal_offset"] * direction

        fallen = -params["fall_penalty"] * torch.any(body_height <= params["spot_fallen_threshold"], dim=-1).to(dtype)
        # object_y_axis @ Z_AXIS: the axis' z component
        tire_up = object_y_axis[..., 2] > params["tire_fallen_threshold"]
        tire_fallen = -params["fall_penalty"] * tire_up.to(dtype).sum(-1)
        goal = -params["w_goal"] * torch.linalg.norm(object_pos - params["goal_position"], dim=-1).mean(-1)
        torso = -params["w_torso_proximity"] * torch.linalg.norm(body_pos - torso_goal, dim=-1).mean(-1)
        gripper = -params["w_gripper_proximity"] * torch.linalg.norm(gripper_goal - gripper_pos, dim=-1).mean(-1)
        ctrl_cost = -params["w_controls"] * torch.linalg.norm(controls, dim=-1).mean(-1)
        linvel = -params["w_tire_linear_velocity"] * torch.linalg.norm(tire_linvel, dim=-1).mean(-1)
        angvel = -params["w_tire_angular_velocity"] * torch.linalg.norm(tire_angvel, dim=-1).mean(-1)
        return fallen + tire_fallen + goal + torso + gripper + ctrl_cost + linvel + angvel

    @property
    def reset_pose(self) -> np.ndarray:
        """The tire upright at a random place at least 1 m from the robot
        (spot_tire_roll.py:139-151), drawn from ``np.random`` in the JAX
        package's order."""
        standing = np.array([0, 0, sc.STANDING_HEIGHT])
        tire = (np.random.rand(7) - 0.5) * 3.0
        tire[2] = sc.TIRE_RADIUS
        tire[3:] = [1, 0, 0, 0]
        while np.linalg.norm(tire[:3] - standing) < 1.0:
            tire = (np.random.rand(7) - 0.5) * 3.0
            tire[2] = sc.TIRE_RADIUS
            tire[3:] = [1, 0, 0, 0]
        return np.array([*standing, 1, 0, 0, 0, *sc.LEGS_STANDING_POS, *self.reset_arm_pos, *tire])
