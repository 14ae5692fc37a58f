"""LEAP cube rotation on the Caltech hand mount (counterpart of
``judo_tpu/tasks/caltech_leap_cube.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from judo_tpu_torch.gui import slider
from judo_tpu_torch.tasks.leap_cube import LeapCube, LeapCubeConfig

QPOS_HOME = np.array(
    [
        0.11, 0.005, 0.04, 1.0, 0.0, 0.0, 0.0,  # cube
        0.5, -0.75, 0.75, 0.25,  # index
        0.5, 0.0, 0.75, 0.25,  # middle
        0.5, 0.75, 0.75, 0.25,  # ring
        0.65, 0.9, 0.75, 0.6,  # thumb
    ]
)  # fmt: skip


@slider("w_pos", 0.0, 200.0)
@slider("w_rot", 0.0, 1.0)
@dataclass
class CaltechLeapCubeConfig(LeapCubeConfig):
    pass


class CaltechLeapCube(LeapCube):
    """LEAP cube rotation on the Caltech hand mount."""

    name: str = "caltech_leap_cube"
    config_t: type[CaltechLeapCubeConfig] = CaltechLeapCubeConfig
    qpos_home_default: np.ndarray = QPOS_HOME
    goal_position: tuple = (0.11, 0.005, 0.03)

    def __init__(self, device: Any = "cuda", dtype: torch.dtype = torch.float32, seed: int | None = None) -> None:
        super().__init__(device=device, dtype=dtype, seed=seed)
        self.reset()  # the JAX variant resets once more after LeapCube's constructor: its first goal is discarded
