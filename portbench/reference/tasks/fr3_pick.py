"""Franka FR3 pick and place: the benchmark's frozen copy of the reward of
``judo_tpu_torch/tasks/fr3_pick.py`` with its default weights and pick
height 0.3 m, in the phase the planner works out on the host for a cube
resting on the table outside the goal: lift. The reward does not see the
state a plan starts from, so the phase is fixed here, and only lift's term
is copied (the goal at (0.6, 0.4) enters the other phases' terms alone); a
traffic that lifts or moves the cube needs the other terms.

Lift's term (the grasp site to the cube, the cube to the pick height) plus
the end effector pointing down, no finger on the table, a velocity penalty
that decays over the horizon and an open gripper, summed over time."""

from __future__ import annotations

import numpy as np
import torch

SNAPSHOT = "judo_tpu_torch/models/fr3_pick.npz"
POLICY = None
SUBSTEPS = 1

# the home pose: the cube's free joint, the arm's seven joints, the two fingers
QPOS_HOME = (0.7, 0.0, 0.02, 1.0, 0.0, 0.0, 0.0,
             0.0, -0.7854, 0.0, -2.3562, 0.0, 1.5708, 0.7854,
             0.04, 0.04)  # fmt: skip
NQ, NV = 16, 15
PICK_HEIGHT = 0.3
W_LIFT_CLOSE, W_LIFT_HEIGHT = 1.0, 10.0
W_UPRIGHT, W_COLL, W_QVEL, W_OPEN = 0.25, 0.1, 0.005, 2.0


def warm_start(model, extras) -> np.ndarray:
    """The arm's home pose and the gripper open, held at every knot."""
    return np.asarray(QPOS_HOME[7:14] + (0.04,), np.float64)


def ctrl_bounds(model, extras) -> np.ndarray:
    """(nu, 2) control limits, unlimited actuators at +-inf."""
    limits = np.asarray(model.actuator_ctrlrange, np.float64).copy()
    limits[~np.asarray(model.actuator_ctrllimited, bool)] = np.array([-np.inf, np.inf])
    return limits


def sim_ctrl(controls: torch.Tensor) -> torch.Tensor:
    return controls


def reward(states, sensors, controls, params: dict, extras) -> torch.Tensor:
    """(R, T, nq + nv), (R, T, nsensordata) -> (R,)."""
    like = dict(dtype=states.dtype, device=states.device)
    obj = int(extras["qpos_adr_object_joint"])
    arm = int(extras["qpos_adr_fr3_joint1"])
    sensor = {n: int(extras[f"sensor_adr_{n}"])
              for n in ("left_finger_table", "right_finger_table", "trace_grasp_site", "ee_z")}
    grasp_pos = sensors[..., sensor["trace_grasp_site"] : sensor["trace_grasp_site"] + 3]
    ee_z = sensors[..., sensor["ee_z"] : sensor["ee_z"] + 3]
    obj_pos = states[..., obj : obj + 3]
    arm_pos = states[..., arm : arm + 9]

    grasp_dist = torch.square(grasp_pos - obj_pos).sum(-1)
    lift = -(W_LIFT_CLOSE * grasp_dist + W_LIFT_HEIGHT * torch.square(obj_pos[..., 2] - PICK_HEIGHT)).sum(-1)

    touching = (sensors[..., sensor["left_finger_table"]] <= 0.0) | (sensors[..., sensor["right_finger_table"]] <= 0.0)
    upright = -torch.linalg.norm(ee_z - torch.tensor([0.0, 0.0, -1.0], **like), dim=-1).sum(-1)
    no_touch = (1.0 - touching.to(states.dtype)).sum(-1)
    decay = torch.linspace(1.0, 0.0, states.shape[1], **like)
    qvel = -(decay * torch.linalg.norm(states[..., NQ : NQ + NV], dim=-1)).sum(-1)
    gripper_open = -torch.square(arm_pos[..., -1] - 0.04).sum(-1)
    return lift + W_UPRIGHT * upright + W_COLL * no_touch + W_QVEL * qvel + W_OPEN * gripper_open
