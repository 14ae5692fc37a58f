"""SpotNavigate: drive the base to a goal (counterpart of
``judo_tpu/tasks/spot/spot_navigate.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from judo_tpu_torch.tasks.spot import spot_constants as sc
from judo_tpu_torch.tasks.spot.spot_base import SpotBase, SpotBaseConfig
from judo_tpu_torch.utils.fields import np_1d_field


@dataclass
class SpotNavigateConfig(SpotBaseConfig):
    w_goal: float = 60.0
    fall_penalty: float = 2500.0
    w_controls: float = 0.0
    goal_position: np.ndarray = np_1d_field(
        np.array([0.0, 0.0, sc.STANDING_HEIGHT]),
        names=["x", "y", "z"],
        mins=[-5.0, -5.0, 0.0],
        maxs=[5.0, 5.0, 3.0],
        vis_name="goal_position",
        xyz_vis_indices=[0, 1, None],
    )


class SpotNavigate(SpotBase[SpotNavigateConfig]):
    """Navigate the base to a goal; the fall penalty keeps it standing."""

    name: str = "spot_navigate"
    config_t: type[SpotNavigateConfig] = SpotNavigateConfig  # type: ignore[assignment]
    use_arm = False

    def reward(self, states, sensors, controls, params, system_metadata=None) -> torch.Tensor:
        """Goal proximity + fall penalty + control cost (spot_navigate.py:40-61)."""
        i = self.body_pose_idx
        qpos = states[..., : self.nq]
        body_height = qpos[..., i + 2]
        body_pos = qpos[..., i : i + 3]
        fallen = -params["fall_penalty"] * torch.any(body_height <= params["spot_fallen_threshold"], dim=-1).to(states.dtype)
        goal = -params["w_goal"] * torch.linalg.norm(body_pos - params["goal_position"][None, None], dim=-1).mean(-1)
        ctrl_cost = -params["w_controls"] * torch.linalg.norm(controls, dim=-1).mean(-1)
        return fallen + goal + ctrl_cost

    @property
    def reset_pose(self) -> np.ndarray:
        return np.array([0, 0, sc.STANDING_HEIGHT, 1, 0, 0, 0, *sc.LEGS_STANDING_POS, *self.reset_arm_pos])
