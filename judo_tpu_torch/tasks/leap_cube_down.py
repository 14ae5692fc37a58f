"""LEAP cube held under the downward-facing palm (counterpart of
``judo_tpu/tasks/leap_cube_down.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from judo_tpu_torch.gui import slider
from judo_tpu_torch.tasks.leap_cube import LeapCube, LeapCubeConfig

QPOS_HOME = np.array(
    [
        -0.04, -0.035, -0.065, 1.0, 0.0, 0.0, 0.0,  # cube below the palm
        1.0, 0.0, 0.8, 0.8,  # index
        1.0, 0.0, 0.8, 0.8,  # middle
        1.0, 0.0, 0.8, 0.8,  # ring
        1.0, 1.0, 0.4, 0.9,  # thumb
    ]
)  # fmt: skip


@slider("w_pos", 0.0, 200.0)
@slider("w_rot", 0.0, 1.0)
@dataclass
class LeapCubeDownConfig(LeapCubeConfig):
    w_rot: float = 0.05


class LeapCubeDown(LeapCube):
    """Cube held underneath the downward-facing palm."""

    name: str = "leap_cube_down"
    config_t: type[LeapCubeDownConfig] = LeapCubeDownConfig
    qpos_home_default: np.ndarray = QPOS_HOME
    goal_position: tuple = (-0.04, -0.035, -0.065)
