"""LEAP cube in-hand rotation (counterpart of ``judo_tpu/tasks/leap_cube.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from judo_tpu_torch.gui import slider
from judo_tpu_torch.models.leap import leap_cube_xml
from judo_tpu_torch.ops.math import quat_diff_so3
from judo_tpu_torch.physics.model import PhysicsModel
from judo_tpu_torch.tasks.base import Task, TaskConfig, model_from_mujoco

QPOS_HOME = np.array(
    [
        0.0, 0.03, 0.1, 1.0, 0.0, 0.0, 0.0,  # cube free joint
        0.5, -0.75, 0.75, 0.25,  # index
        0.5, 0.0, 0.75, 0.25,  # middle
        0.5, 0.75, 0.75, 0.25,  # ring
        0.65, 0.9, 0.75, 0.6,  # thumb
    ]
)  # fmt: skip

# The cube at rest in the palm-up hand: 60 mujoco steps of the planning model
# from QPOS_HOME with the reset command held. A state with active contacts,
# for tests and the GPU smoke run.
QPOS_REST = np.array(
    [
        -4.2815700514839113e-04, 4.8277564356308048e-02, 5.8354075600546791e-02, 9.9290809501983157e-01,
        1.3728913861247964e-03, -1.1881414127176297e-01, 3.8509540614784735e-03, 3.3791624444885709e-01,
        -7.6227704689213349e-01, 7.1621350616121360e-01, 2.4576482792734192e-01, 3.0808645898711717e-01,
        7.3183457581372824e-05, 7.1710851813312948e-01, 2.4603755206622688e-01, 3.1734526932097723e-01,
        7.5785413676987157e-01, 7.1599852646510720e-01, 2.4571117959231101e-01, 5.8082202367244340e-01,
        8.4937889884897322e-01, 7.6207848464996075e-01, 6.1228211488531403e-01,
    ]
)  # fmt: skip


@slider("w_pos", 0.0, 200.0)
@slider("w_rot", 0.0, 1.0)
@dataclass
class LeapCubeConfig(TaskConfig):
    """Tracking weights."""

    w_pos: float = 100.0
    w_rot: float = 0.1


class LeapCube(Task[LeapCubeConfig]):
    """Rotate the cube in-hand to track goal orientations; the goal arrives
    through sim metadata ("goal_quat"), identity when absent. The scene
    variants (leap_cube_down, caltech_leap_cube) set ``name``, ``qpos_home``
    and ``goal_position``; ``name`` also picks the MJCF variant.

    The plant's side draws the goals: ``reset`` and every goal reached
    (within 0.4 rad) draw a uniform random orientation from the task's own
    ``np.random.RandomState(seed)``, in the order and arithmetic of the JAX
    task's draws from numpy's global state, and ``post_sim_step`` resets the
    task when the cube drops below z = -0.3."""

    name: str = "leap_cube"
    config_t: type[LeapCubeConfig] = LeapCubeConfig
    qpos_home_default: np.ndarray = QPOS_HOME
    goal_position: tuple = (0.0, 0.03, 0.1)

    def __init__(self, device: Any = "cuda", dtype: torch.dtype = torch.float32, seed: int | None = None) -> None:
        super().__init__(device=device, dtype=dtype)
        self.rng = np.random.RandomState(seed)
        self.goal_pos = np.array(self.goal_position)
        self.goal_quat = np.array([1.0, 0.0, 0.0, 0.0])
        self.qpos_home = np.asarray(self.extras["qpos_home"], np.float64)
        self.reset_command = np.asarray(self.extras["reset_command"], np.float64)
        self.reset()

    @classmethod
    def model_xml(cls) -> str:
        return leap_cube_xml(cls.name)

    @classmethod
    def plant_xml(cls) -> str:
        """leap_cube's plant integrates ``leap_cube_sim`` (dt 0.002, 5x finer
        than the planner); the variants' plants are their planning models."""
        return leap_cube_xml("leap_cube_sim") if cls.name == "leap_cube" else cls.model_xml()

    @classmethod
    def _model_from_mujoco(cls) -> tuple[PhysicsModel, dict]:
        m, extras = model_from_mujoco(cls.model_xml(), cls.planning_solver_iterations)
        home = cls.qpos_home_default
        return m, {**extras, "qpos_home": home, "reset_command": home[7:].copy()}

    def reward(self, states, sensors, controls, params, system_metadata=None) -> torch.Tensor:
        """Position + SO(3) log-map orientation tracking, averaged over time."""
        metadata = system_metadata or {}
        goal_quat = metadata.get("goal_quat")
        if goal_quat is None:
            goal_quat = self.on_device("identity_quat", [1.0, 0.0, 0.0, 0.0], states)
        goal_pos = self.on_device("goal_pos", self.goal_pos, states)
        pos_diff = states[..., :3] - goal_pos
        quat_err = quat_diff_so3(states[..., 3:7], goal_quat)
        pos_cost = params["w_pos"] * 0.5 * torch.square(pos_diff).sum(-1).mean(-1)
        rot_cost = params["w_rot"] * 0.5 * torch.square(quat_err).sum(-1).mean(-1)
        return -(pos_cost + rot_cost)

    def optimizer_warm_start(self) -> np.ndarray:
        return self.reset_command.copy()

    def post_sim_step(self) -> None:
        """Reset when the cube drops; a new goal once the cube is within
        0.4 rad of the current one."""
        if self.qpos[2] < -0.3:
            self.reset()
        q_diff = _quat_mul(self.qpos[3:7] * np.array([1.0, -1.0, -1.0, -1.0]), self.goal_quat)
        angle = 2.0 * np.arctan2(np.linalg.norm(q_diff[1:]), q_diff[0])
        if angle > np.pi:
            angle -= 2.0 * np.pi
        if np.abs(angle) < 0.4:
            self._update_goal_quat()

    def _update_goal_quat(self) -> None:
        """A uniform random unit quaternion, to the goal and its mocap body."""
        uvw = self.rng.rand(3)
        goal_quat = np.array(
            [
                np.sqrt(1 - uvw[0]) * np.sin(2 * np.pi * uvw[1]),
                np.sqrt(1 - uvw[0]) * np.cos(2 * np.pi * uvw[1]),
                np.sqrt(uvw[0]) * np.sin(2 * np.pi * uvw[2]),
                np.sqrt(uvw[0]) * np.cos(2 * np.pi * uvw[2]),
            ]
        )
        if self.mocap_quat.shape[0] > 0:
            self.mocap_quat[0] = goal_quat
        self.goal_quat = goal_quat

    def get_sim_metadata(self) -> dict[str, Any]:
        return {"goal_quat": self.goal_quat}

    def reset(self) -> None:
        self.qpos = self.qpos_home.copy()
        self.qvel = np.zeros(self.nv)
        self.time = 0.0
        self._update_goal_quat()


def _quat_mul(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Hamilton product of two wxyz quaternions."""
    w1, x1, y1, z1 = u
    w2, x2, y2, z2 = v
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])
