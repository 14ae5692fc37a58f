"""SpotBoxPush: push a large box to a goal (counterpart of
``judo_tpu/tasks/spot/spot_box_push.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from judo_tpu_torch.tasks.spot import spot_constants as sc
from judo_tpu_torch.tasks.spot.spot_base import SpotBase, SpotBaseConfig
from judo_tpu_torch.utils.fields import np_1d_field

RADIUS_MIN, RADIUS_MAX = 1.0, 2.0


@dataclass
class SpotBoxPushConfig(SpotBaseConfig):
    w_goal: float = 60.0
    w_orientation: float = 15.0
    w_torso_proximity: float = 0.1
    w_gripper_proximity: float = 4.0
    orientation_threshold: float = 0.5
    fall_penalty: float = 2500.0
    w_controls: float = 0.0
    goal_position: np.ndarray = np_1d_field(
        np.array([0.0, 0.0, sc.BOX_HALF_LENGTH]),
        names=["x", "y", "z"],
        mins=[-5.0, -5.0, 0.0],
        maxs=[5.0, 5.0, 3.0],
        vis_name="goal_position",
        xyz_vis_indices=[0, 1, None],
    )


class SpotBoxPush(SpotBase[SpotBoxPushConfig]):
    """Push the box to the goal with the arm out, keeping it upright."""

    name: str = "spot_box_push"
    config_t: type[SpotBoxPushConfig] = SpotBoxPushConfig  # type: ignore[assignment]
    object_joint = "box_joint"

    def reward(self, states, sensors, controls, params, system_metadata=None) -> torch.Tensor:
        """Goal + orientation + torso and gripper proximity + fall (spot_box_push.py:63-106)."""
        i, o = self.body_pose_idx, self.object_pose_idx
        qpos = states[..., : self.nq]
        body_height = qpos[..., i + 2]
        body_pos = qpos[..., i : i + 3]
        object_pos = qpos[..., o : o + 3]
        y = self.sensor_adr["object_y_axis"]
        g = self.sensor_adr["trace_fngr_site"]
        object_y_axis = sensors[..., y : y + 3]
        gripper_pos = sensors[..., g : g + 3]
        dtype = states.dtype
        fallen = -params["fall_penalty"] * torch.any(body_height <= params["spot_fallen_threshold"], dim=-1).to(dtype)
        goal = -params["w_goal"] * torch.linalg.norm(object_pos - params["goal_position"][None, None], dim=-1).mean(-1)
        # object_y_axis @ Z_AXIS: the axis' z component
        upright = (object_y_axis[..., 2] > params["orientation_threshold"]).to(dtype)
        orientation = -params["w_orientation"] * upright.sum(-1)
        # the torso-proximity term is positive: it keeps the torso back from the box
        torso = params["w_torso_proximity"] * torch.linalg.norm(body_pos - object_pos, dim=-1).mean(-1)
        gripper = -params["w_gripper_proximity"] * torch.linalg.norm(gripper_pos - object_pos, dim=-1).mean(-1)
        ctrl_cost = -params["w_controls"] * torch.linalg.norm(controls, dim=-1).mean(-1)
        return fallen + goal + orientation + torso + gripper + ctrl_cost

    @property
    def reset_pose(self) -> np.ndarray:
        """The box at a random place on a ring around the robot
        (spot_box_push.py:108-127), drawn from ``np.random`` in the JAX
        package's order."""
        radius = RADIUS_MIN + (RADIUS_MAX - RADIUS_MIN) * np.random.rand()
        theta = 2 * np.pi * np.random.rand()
        object_xy = np.array([radius * np.cos(theta), radius * np.sin(theta)]) + np.random.randn(2)
        box_pose = np.array([*object_xy, sc.BOX_HALF_LENGTH, 1, 0, 0, 0])
        return np.array([
            *np.random.randn(2), sc.STANDING_HEIGHT, 1, 0, 0, 0, *sc.LEGS_STANDING_POS, *self.reset_arm_pos, *box_pose,
        ])
