"""SpotTireUpright: flip a flat-lying tire upright with the gripper and the
front legs (counterpart of ``judo_tpu/tasks/spot/spot_tire_upright.py``).

The action is 17-dim: base 3, arm 7, front-leg overrides 6 and the leg
selection 1. The wanted gripper, foot and torso positions follow from the
unit vector from the tire to the torso, the feet at +-pi/8 of yaw from it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from judo_tpu_torch.ops.math import quat_rotate
from judo_tpu_torch.tasks.spot import spot_constants as sc
from judo_tpu_torch.tasks.spot.spot_base import SpotBase, SpotBaseConfig


@dataclass
class SpotTireUprightConfig(SpotBaseConfig):
    """Reward weights (spot_tire_upright.py:28-47)."""

    orientation_error_smoothing_width: float = 1.0
    w_tire_orientation: float = 200.0
    w_gripper_proximity: float = 10.0
    w_foot_proximity: float = 5.0
    w_torso_proximity: float = 5.0
    gripper_too_inside_tire_penalty: float = 150.0
    gripper_not_above_tire_penalty: float = 100.0
    w_controls: float = 2.0
    fall_penalty: float = 10_000.0


class SpotTireUpright(SpotBase[SpotTireUprightConfig]):
    """Stand the tire up: its y axis horizontal."""

    name: str = "spot_tire_upright"
    config_t: type[SpotTireUprightConfig] = SpotTireUprightConfig  # type: ignore[assignment]
    use_legs = True
    object_joint = "tire_joint"

    def reward(self, states, sensors, controls, params, system_metadata=None) -> torch.Tensor:
        """Orientation goal + proximity shaping + penalties against reward
        hacking (spot_tire_upright.py:101-237)."""
        dtype = states.dtype
        qpos = states[..., : self.nq]
        adr = self.sensor_adr
        o, i = self.object_pose_idx, self.body_pose_idx

        tire_pos = qpos[..., o : o + 3]
        torso_pos = qpos[..., i : i + 3]
        tire_to_torso = torso_pos - tire_pos
        u = tire_to_torso / (torch.linalg.norm(tire_to_torso, dim=-1, keepdim=True) + 1e-8)

        # the gripper just inside the rim on the torso's side, above the tire
        gripper_des = tire_pos + (sc.TIRE_RADIUS - 0.05) * u
        gripper_des[..., 2] = sc.TIRE_HALF_WIDTH + 0.1
        gripper_pos = sensors[..., adr["trace_fngr_site"] : adr["trace_fngr_site"] + 3]
        gripper_prox = -params["w_gripper_proximity"] * torch.linalg.norm(gripper_pos - gripper_des, dim=-1).mean(-1)

        # the feet on the rim at +-pi/8 of yaw from the torso's direction
        c, s = np.cos(np.pi / 8), np.sin(np.pi / 8)
        q_pos = self.on_device("yaw_plus", [c, 0.0, 0.0, s], states)
        q_neg = self.on_device("yaw_minus", [c, 0.0, 0.0, -s], states)
        right_des = tire_pos + sc.TIRE_RADIUS * quat_rotate(q_pos, u)
        right_des[..., 2] = 0.1
        left_des = tire_pos + sc.TIRE_RADIUS * quat_rotate(q_neg, u)
        left_des[..., 2] = 0.1
        fr = sensors[..., adr["fr_pos"] : adr["fr_pos"] + 3]
        fl = sensors[..., adr["fl_pos"] : adr["fl_pos"] + 3]
        right_prox = -params["w_foot_proximity"] * torch.linalg.norm(fr - right_des, dim=-1).mean(-1)
        left_prox = -params["w_foot_proximity"] * torch.linalg.norm(fl - left_des, dim=-1).mean(-1)
        foot_prox = torch.maximum(right_prox, left_prox)

        # the torso standing off at standing height
        torso_des = tire_pos + 0.75 * u
        torso_des[..., 2] = sc.STANDING_HEIGHT
        torso_prox = -params["w_torso_proximity"] * torch.linalg.norm(torso_pos - torso_des, dim=-1).mean(-1)

        # the goal: the tire's y axis horizontal; |z| smoothed by exp into [1, e]
        tire_y = sensors[..., adr["object_y_axis"] : adr["object_y_axis"] + 3]
        orientation = -params["w_tire_orientation"] * torch.exp(
            torch.abs(tire_y[..., 2]) / params["orientation_error_smoothing_width"]
        ).mean(-1)

        # penalties: the gripper near the hub, or below the tire's top and outside its rim
        gripper_from_tire = torch.linalg.norm(gripper_pos - tire_pos, dim=-1)
        too_inside = gripper_from_tire < sc.TIRE_RADIUS * 0.5
        inside = -params["gripper_too_inside_tire_penalty"] * too_inside.to(dtype).mean(-1)
        not_above = (gripper_pos[..., 2] < 2 * sc.TIRE_HALF_WIDTH + 0.05) & (gripper_from_tire > sc.TIRE_RADIUS)
        not_above_pen = -params["gripper_not_above_tire_penalty"] * not_above.to(dtype).mean(-1)

        body_height = qpos[..., i + 2]
        fallen = -params["fall_penalty"] * torch.any(body_height <= params["spot_fallen_threshold"], dim=-1).to(dtype)
        ctrl_cost = -params["w_controls"] * torch.linalg.norm(controls, dim=-1).mean(-1)
        return orientation + gripper_prox + foot_prox + torso_prox + inside + not_above_pen + fallen + ctrl_cost

    @property
    def reset_pose(self) -> np.ndarray:
        """A flat tire and the robot standing at least 1 m from it
        (spot_tire_upright.py:239-313), drawn from ``np.random`` in the JAX
        package's order."""
        for _ in range(100):
            tire_xy = np.random.uniform(-2, 2, size=2)
            roll_sign = 1.0 if np.random.random() < 0.5 else -1.0
            tire_quat = np.array([1.0, roll_sign, 0.0, 0.0]) / np.sqrt(2)
            yaw = np.random.uniform(0, 2 * np.pi)
            w1, x1, y1, z1 = np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)
            w2, x2, y2, z2 = tire_quat
            quat = np.array([
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            ])
            robot_xy = np.random.uniform(-2, 2, size=2)
            robot_yaw = np.random.uniform(0, 2 * np.pi)
            if np.linalg.norm(robot_xy - tire_xy) > 1.0:
                return np.array([
                    *robot_xy, sc.STANDING_HEIGHT, np.cos(robot_yaw / 2), 0, 0, np.sin(robot_yaw / 2),
                    *sc.LEGS_STANDING_POS, *self.reset_arm_pos, *tire_xy, sc.TIRE_HALF_WIDTH, *quat,
                ])
        return np.array([  # after 100 draws too close (spot_tire_upright.py:298-313)
            0.0, 0.0, sc.STANDING_HEIGHT, 1, 0, 0, 0, *sc.LEGS_STANDING_POS, *self.reset_arm_pos,
            2.0, 0.0, sc.TIRE_HALF_WIDTH, np.cos(np.pi / 4), np.sin(np.pi / 4), 0, 0,
        ])

    def success(self, metadata: dict[str, Any] | None = None) -> bool:
        """The tire's y axis horizontal within 0.1 (spot_tire_upright.py:315-336)."""
        tire_y_z = self.current_sensors()[self.sensor_adr["object_y_axis"] + 2]
        return bool(abs(tire_y_z) <= 0.1)
