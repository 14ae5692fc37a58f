"""Spot base task (counterpart of ``judo_tpu/tasks/spot/spot_base.py``).

The planner's action is a compact vector, mapped to the 25-dim policy command
[base velocity 3, arm 7, legs 12, torso 3] by ``task_to_sim_ctrl``; the
locomotion policy in the rollout turns the command into position targets
(``tasks/spot/policy.py``). The planning model keeps ground contacts and
object contacts and drops the robot's self-collision (``_spot_planner_pairs``,
applied when the model is lowered). A scene with an object (a box or a tire)
names the object's free joint in ``object_joint``; its qpos and qvel
addresses and the sensor addresses the rewards read are lowered with the
model into ``extras``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, TypeVar

import numpy as np
import torch

from judo_tpu_torch.models.spot import spot_xml
from judo_tpu_torch.physics.lane_engine import kinematics_l
from judo_tpu_torch.physics.lane_step import evaluate_sensors_l
from judo_tpu_torch.physics.model import PhysicsModel
from judo_tpu_torch.tasks.base import Task, TaskConfig, model_from_mujoco
from judo_tpu_torch.tasks.spot import spot_constants as sc
from judo_tpu_torch.tasks.spot.policy import SpotPolicy


@dataclass
class SpotBaseConfig(TaskConfig):
    fall_penalty: float = 2500.0
    spot_fallen_threshold: float = 0.35
    w_goal: float = 60.0
    w_controls: float = 0.0


ConfigT = TypeVar("ConfigT", bound=SpotBaseConfig)
# Sensors the object tasks' rewards read, by name (models/spot.py).
OBJECT_TASK_SENSORS = ("object_y_axis", "trace_fngr_site", "fl_pos", "fr_pos")


def _spot_planner_pairs(m, g1: int, g2: int) -> bool:
    """Keep ground and object contacts, drop robot self-collision."""
    import mujoco

    b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
    names = (mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_BODY, b1) or "", mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_BODY, b2) or "")
    return b1 == 0 or b2 == 0 or "box_body" in names or "tire" in names


class SpotBase(Task[ConfigT], Generic[ConfigT]):
    """Spot with the locomotion policy in the loop; subclasses set the
    action-space flags and the reward."""

    name: str = "spot_base"
    config_t: type[SpotBaseConfig] = SpotBaseConfig  # type: ignore[assignment]
    use_arm: bool = True
    use_gripper: bool = False
    use_legs: bool = False
    use_torso: bool = False
    object_joint: str | None = None  # the free joint of the scene's object

    def __init__(self, device: Any = "cuda", dtype: torch.dtype = torch.float32) -> None:
        super().__init__(device=device, dtype=dtype)
        self.policy = SpotPolicy.load(device=self.device)
        self.default_command = self._default_command()
        self.default_policy_command = np.array(
            [0, 0, 0, *sc.ARM_STOWED_POS, *([0.0] * 12), 0, 0, sc.STANDING_HEIGHT_CMD]
        )
        self.body_pose_idx = int(self.extras["body_pose_idx"])
        if self.object_joint is not None:
            self.object_pose_idx = int(self.extras["object_pose_idx"])
            self.object_vel_idx = int(self.extras["object_vel_idx"])
            self.sensor_adr = {n: int(self.extras[f"sensor_adr_{n}"]) for n in OBJECT_TASK_SENSORS}
        self.reset()

    @classmethod
    def _model_from_mujoco(cls) -> tuple[PhysicsModel, dict]:
        import mujoco

        m, extras = model_from_mujoco(spot_xml(cls.name), cls.planning_solver_iterations, _spot_planner_pairs)
        mj = mujoco.MjModel.from_xml_string(spot_xml(cls.name))
        extras["body_pose_idx"] = np.int64(mj.jnt_qposadr[mj.joint("base").id])
        if cls.object_joint is not None:
            joint = mj.joint(cls.object_joint).id
            extras["object_pose_idx"] = np.int64(mj.jnt_qposadr[joint])
            extras["object_vel_idx"] = np.int64(mj.jnt_dofadr[joint])
            extras.update({f"sensor_adr_{n}": np.int64(mj.sensor(n).adr[0]) for n in OBJECT_TASK_SENSORS})
        return m, extras

    # --- action space (spot_base.py:84-108, 127-147) ---
    def _default_command(self) -> np.ndarray:
        vals: list[float] = [0, 0, 0]
        if self.use_arm:
            vals += [*sc.ARM_UNSTOWED_POS] + ([0.0] if self.use_gripper else [])
        if self.use_legs:
            vals += [*sc.LEGS_STANDING_POS[0:6], 0]
        if self.use_torso:
            vals += [0, 0, sc.STANDING_HEIGHT]
        return np.array(vals, np.float64)

    @property
    def nu(self) -> int:
        return len(self.default_command)

    @property
    def physics_substeps(self) -> int:
        return 2

    @property
    def uses_locomotion_policy(self) -> bool:
        return True

    @property
    def actuator_ctrlrange(self) -> np.ndarray:
        """Soft bounds of the compact action."""
        gl = sc.GRIPPER_OPEN_POS if self.use_gripper else sc.GRIPPER_CLOSED_POS
        arm_lower = np.concatenate((sc.ARM_SOFT_LOWER_JOINT_LIMITS[:-1], [gl]))
        arm_upper = np.concatenate((sc.ARM_SOFT_UPPER_JOINT_LIMITS[:-1], [sc.GRIPPER_CLOSED_POS]))
        lo, hi = [-sc.BASE_SOFT_LIMITS], [sc.BASE_SOFT_LIMITS]
        if self.use_arm:
            lo.append(arm_lower)
            hi.append(arm_upper)
            if self.use_gripper:
                lo.append(-np.ones(1))
                hi.append(np.ones(1))
        if self.use_legs:
            lo.extend([sc.LEG_SOFT_LOWER_JOINT_LIMITS[0:6], -np.ones(1)])
            hi.extend([sc.LEG_SOFT_UPPER_JOINT_LIMITS[0:6], np.ones(1)])
        if self.use_torso:
            lo.append(sc.TORSO_LOWER)
            hi.append(sc.TORSO_UPPER)
        return np.stack([np.concatenate(lo), np.concatenate(hi)], axis=-1)

    def task_to_sim_ctrl(self, controls: torch.Tensor) -> torch.Tensor:
        """Compact action (..., nu) -> 25-dim policy command (spot_base.py:149-184)."""
        base_end = 3
        arm_end = base_end + (7 if self.use_arm else 0)
        grip_sel_end = arm_end + (1 if (self.use_arm and self.use_gripper) else 0)
        legs_end = grip_sel_end + (6 if self.use_legs else 0)
        leg_sel_end = legs_end + (1 if self.use_legs else 0)
        out = self.on_device("default_policy_command", self.default_policy_command, controls)
        out = out.expand(*controls.shape[:-1], 25).clone()
        out[..., 0:3] = controls[..., 0:3]
        if self.use_arm:
            arm = controls[..., base_end:arm_end].clone()
            if self.use_gripper:
                sel = controls[..., grip_sel_end - 1]
                arm[..., 6] = torch.where(sel < 0.0, torch.full_like(sel, sc.GRIPPER_CLOSED_POS), arm[..., 6])
            out[..., 3:10] = arm
        if self.use_legs:
            leg = controls[..., grip_sel_end:legs_end]
            sel = controls[..., leg_sel_end - 1][..., None]
            out[..., 10:13] = torch.where(sel < -0.5, leg[..., 0:3], torch.zeros_like(leg[..., 0:3]))
            out[..., 13:16] = torch.where(sel > 0.5, leg[..., 3:6], torch.zeros_like(leg[..., 3:6]))
        if self.use_torso:
            out[..., 22:25] = controls[..., leg_sel_end : leg_sel_end + 3]
        return out

    def reward(self, states, sensors, controls, params, system_metadata=None) -> torch.Tensor:
        return torch.zeros(states.shape[0], dtype=states.dtype, device=states.device)

    def optimizer_warm_start(self) -> np.ndarray:
        return self.default_command.copy()

    @property
    def reset_arm_pos(self) -> np.ndarray:
        return sc.ARM_UNSTOWED_POS if self.use_arm else sc.ARM_STOWED_POS

    @property
    def reset_pose(self) -> np.ndarray:
        return np.array([0, 0, sc.STANDING_HEIGHT, 1, 0, 0, 0, *sc.LEGS_STANDING_POS_RL, *self.reset_arm_pos])

    def reset(self) -> None:
        self.qpos = self.reset_pose.astype(np.float64)
        self.qvel = np.zeros(self.nv)
        self.time = 0.0

    def current_sensors(self) -> np.ndarray:
        """The sensor values at the task's state (``qpos``, ``qvel``): what
        mujoco's ``sensordata`` holds after ``mj_forward``, evaluated on the
        host with the plain step's sensor code, in float64 on the planning
        model's values."""
        q = torch.tensor(self.qpos, dtype=torch.float64)[:, None]
        v = torch.tensor(self.qvel, dtype=torch.float64)[:, None]
        m = self.planning_model
        return evaluate_sensors_l(m, kinematics_l(m, q), q, v)[:, 0].numpy()
