"""FR3 pick and place (counterpart of ``judo_tpu/tasks/fr3_pick.py``).

The phase (lift, move, place, homing) is computed on the host in
``pre_rollout`` from the current state and crosses into the solve as the
metadata scalar ``phase``; the reward selects the phase's term per rollout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any

import numpy as np
import torch

from judo_tpu_torch.gui import slider
from judo_tpu_torch.models.fr3 import build_fr3_pick_xml
from judo_tpu_torch.physics.model import PhysicsModel
from judo_tpu_torch.tasks.base import Task, TaskConfig, model_from_mujoco
from judo_tpu_torch.utils.fields import np_1d_field

QPOS_HOME = np.array(
    [
        0.7, 0, 0.02, 1, 0, 0, 0,  # object free joint
        0, -0.7854, 0.0, -2.3562, 0.0, 1.5708, 0.7854,  # arm
        0.04, 0.04,  # gripper (equality-coupled)
    ]
)  # fmt: skip

# Joints whose first qpos address, and sensors whose first sensordata address,
# the task reads (stored in the snapshot, as the card's machine has no mujoco).
JOINTS = ("object_joint", "fr3_joint1")
SENSORS = ("left_finger_table", "right_finger_table", "obj_table", "trace_grasp_site", "ee_z")


class Phase(Enum):
    LIFT = 0
    MOVE = 1
    PLACE = 2
    HOMING = 3


@slider("w_lift_close", 0.0, 10.0, 0.01)
@slider("w_lift_height", 0.0, 10.0, 0.01)
@dataclass
class LiftConfig:
    w_lift_close: float = 1.0
    w_lift_height: float = 10.0


@slider("w_move_goal", 0.0, 10.0, 0.01)
@slider("w_move_close", 0.0, 10.0, 0.01)
@dataclass
class MoveConfig:
    w_move_goal: float = 1.0
    w_move_close: float = 10.0


@slider("w_place_table", 0.0, 10.0, 0.01)
@slider("w_place_goal", 0.0, 10.0, 0.01)
@dataclass
class PlaceConfig:
    w_place_table: float = 1.0
    w_place_goal: float = 1.0


@slider("w_upright", 0.0, 10.0, 0.01)
@slider("w_coll", 0.0, 10.0, 0.01)
@slider("w_qvel", 0.0, 10.0, 0.01)
@slider("w_open", 0.0, 10.0, 0.01)
@dataclass
class GlobalConfig:
    w_upright: float = 0.25
    w_coll: float = 0.1
    w_qvel: float = 0.005
    w_open: float = 2.0


@slider("goal_radius", 0.005, 0.1, 0.005)
@slider("pick_height", 0.0, 1.0, 0.01)
@dataclass
class FR3PickConfig(TaskConfig):
    lift_weights: LiftConfig = field(default_factory=LiftConfig)
    move_weights: MoveConfig = field(default_factory=MoveConfig)
    place_weights: PlaceConfig = field(default_factory=PlaceConfig)
    global_weights: GlobalConfig = field(default_factory=GlobalConfig)
    goal_pos: np.ndarray = np_1d_field(
        np.array([0.6, 0.4]),
        names=["x", "y"],
        mins=[0.4, -1.0],
        maxs=[1.0, 1.0],
        steps=[0.01, 0.01],
        vis_name="goal_position",
        xyz_vis_indices=[0, 1, None],
        xyz_vis_defaults=[0.0, 0.0, 0.0],
    )
    goal_radius: float = 0.05
    pick_height: float = 0.3


class FR3Pick(Task[FR3PickConfig]):
    """Lift the cube, carry it to the goal, place it, go home."""

    name: str = "fr3_pick"
    config_t: type[FR3PickConfig] = FR3PickConfig

    def __init__(self, device: Any = "cuda", dtype: torch.dtype = torch.float32) -> None:
        super().__init__(device=device, dtype=dtype)
        self.obj_pos_adr = int(self.extras["qpos_adr_object_joint"])
        self.obj_pos_slice = slice(self.obj_pos_adr, self.obj_pos_adr + 3)
        arm_pos_adr = int(self.extras["qpos_adr_fr3_joint1"])
        self.arm_pos_slice = slice(arm_pos_adr, arm_pos_adr + 9)
        self.left_finger_table_adr, self.right_finger_table_adr, self.obj_table_adr, self.grasp_site_adr, \
            self.ee_z_adr = (int(self.extras[f"sensor_adr_{n}"]) for n in SENSORS)
        self.phase = Phase.LIFT
        self.reset_command = np.concatenate([QPOS_HOME[7:14], [0.04]])
        self.reset()

    @classmethod
    def model_xml(cls) -> str:
        return build_fr3_pick_xml()

    @classmethod
    def _model_from_mujoco(cls) -> tuple[PhysicsModel, dict]:
        import mujoco

        xml = cls.model_xml()
        m, extras = model_from_mujoco(xml, cls.planning_solver_iterations)
        mj = mujoco.MjModel.from_xml_string(xml)
        extras.update({f"qpos_adr_{n}": np.int64(mj.jnt_qposadr[mj.joint(n).id]) for n in JOINTS})
        extras.update({f"sensor_adr_{n}": np.int64(mj.sensor(n).adr[0]) for n in SENSORS})
        return m, extras

    def in_goal_xy(self, curr_state: np.ndarray) -> bool:
        """The object within the goal radius in xy."""
        obj_xy = curr_state[self.obj_pos_adr : self.obj_pos_adr + 2]
        return bool(np.linalg.norm(obj_xy - self.config.goal_pos) <= self.config.goal_radius)

    def pre_rollout(self, curr_state: np.ndarray) -> dict[str, Any]:
        """The phase from the current state: lift until the object is in the
        air, move it to the goal, place it, then go home."""
        obj_in_air = curr_state[self.obj_pos_adr + 2] > 0.02 + 1e-3
        in_goal = self.in_goal_xy(curr_state)
        phase = Phase.LIFT
        if obj_in_air:
            phase = Phase.MOVE
        if in_goal and obj_in_air:
            phase = Phase.PLACE
        if in_goal and curr_state[self.obj_pos_adr + 2] <= 0.02 + 1e-3:
            phase = Phase.HOMING
        self.phase = phase
        return {"phase": np.asarray(phase.value)}

    def reward(self, states, sensors, controls, params, system_metadata=None) -> torch.Tensor:
        """The phase's reward plus the upright, no-collision, velocity and
        open-gripper terms, summed over time."""
        meta = system_metadata or {}
        phase = meta.get("phase", torch.zeros((), dtype=states.dtype, device=states.device))
        nq, nv = self.nq, self.nv
        lf_table = sensors[..., self.left_finger_table_adr]
        rf_table = sensors[..., self.right_finger_table_adr]
        obj_table = sensors[..., self.obj_table_adr]
        grasp_pos = sensors[..., self.grasp_site_adr : self.grasp_site_adr + 3]
        ee_z = sensors[..., self.ee_z_adr : self.ee_z_adr + 3]

        obj_pos = states[..., self.obj_pos_slice]
        arm_pos = states[..., self.arm_pos_slice]
        obj_xy = states[..., self.obj_pos_adr : self.obj_pos_adr + 2]
        z_obj = states[..., self.obj_pos_adr + 2]
        qvel_norm = torch.linalg.norm(states[..., nq : nq + nv], dim=-1)
        gripper_pos = arm_pos[..., -1]

        q_arm_goal = self.on_device("q_arm_goal", QPOS_HOME[self.arm_pos_slice], states)
        grasp_dist = torch.square(grasp_pos - obj_pos).sum(-1)
        pick_height_err = torch.square(z_obj - params["pick_height"])
        goal_dist = torch.linalg.norm(obj_xy - params["goal_pos"], dim=-1)
        home_dist = torch.linalg.norm(arm_pos - q_arm_goal, dim=-1)

        lw, mw, pw, gw = params["lift_weights"], params["move_weights"], params["place_weights"], params["global_weights"]
        r_lift = -(lw["w_lift_close"] * grasp_dist + lw["w_lift_height"] * pick_height_err).sum(-1)
        r_move = -(mw["w_move_goal"] * goal_dist + mw["w_move_close"] * grasp_dist).sum(-1)
        r_place = -(pw["w_place_table"] * obj_table + pw["w_place_goal"] * goal_dist).sum(-1)
        r_home = -home_dist.sum(-1)
        phase_rewards = torch.stack([r_lift, r_move, r_place, r_home], dim=-1)  # (R, 4)
        idx = torch.clamp(phase.to(torch.int64), 0, 3).reshape(1)
        rewards = torch.index_select(phase_rewards, -1, idx)[..., 0]

        hand_touching = (lf_table <= 0.0) | (rf_table <= 0.0)
        down = self.on_device("down", [0.0, 0.0, -1.0], states)
        rew_upright = -torch.linalg.norm(ee_z - down, dim=-1).sum(-1)
        rew_coll = (1.0 - hand_touching.to(states.dtype)).sum(-1)
        time_decay = torch.linspace(1.0, 0.0, states.shape[1], dtype=states.dtype, device=states.device)
        rew_qvel = -(time_decay * qvel_norm).sum(-1)
        rew_open = -torch.square(gripper_pos - 0.04).sum(-1)
        return rewards + (
            gw["w_upright"] * rew_upright + gw["w_coll"] * rew_coll + gw["w_qvel"] * rew_qvel + gw["w_open"] * rew_open
        )

    def optimizer_warm_start(self) -> np.ndarray:
        return self.reset_command.copy()

    def reset(self) -> None:
        self.qpos = QPOS_HOME.copy()
        self.qvel = np.zeros(self.nv)
        self.time = 0.0
