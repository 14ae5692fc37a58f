"""LEAP hand cube rotation: the benchmark's frozen copy of the reward of
``judo_tpu_torch/tasks/leap_cube.py`` (position and SO(3) orientation
tracking, averaged over the horizon) with the goal the planner sees when no
plant sends one: the cube at (0, 0.03, 0.1), the identity orientation."""

from __future__ import annotations

import math

import numpy as np
import torch

SNAPSHOT = "judo_tpu_torch/models/leap_cube.npz"
POLICY = None
SUBSTEPS = 1
GOAL_POS = (0.0, 0.03, 0.1)
GOAL_QUAT = (1.0, 0.0, 0.0, 0.0)


def warm_start(model, extras) -> np.ndarray:
    """The hand's reset command, held at every knot."""
    return np.asarray(extras["reset_command"], np.float64)


def ctrl_bounds(model, extras) -> np.ndarray:
    """(nu, 2) control limits, unlimited actuators at +-inf."""
    limits = np.asarray(model.actuator_ctrlrange, np.float64).copy()
    limits[~np.asarray(model.actuator_ctrllimited, bool)] = np.array([-np.inf, np.inf])
    return limits


def sim_ctrl(controls: torch.Tensor) -> torch.Tensor:
    return controls


def _quat_diff_so3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """SO(3) log map of u^* (x) v (wxyz), an axis of [1, 0, 0] where the
    rotation's axis is below 1e-6."""
    u = torch.cat([u[..., :1], -u[..., 1:]], dim=-1)
    v = v.expand_as(u)
    w = u[..., 0] * v[..., 0] - u[..., 1] * v[..., 1] - u[..., 2] * v[..., 2] - u[..., 3] * v[..., 3]
    x = u[..., 0] * v[..., 1] + u[..., 1] * v[..., 0] + u[..., 2] * v[..., 3] - u[..., 3] * v[..., 2]
    y = u[..., 0] * v[..., 2] - u[..., 1] * v[..., 3] + u[..., 2] * v[..., 0] + u[..., 3] * v[..., 1]
    z = u[..., 0] * v[..., 3] + u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1] + u[..., 3] * v[..., 0]
    axis = torch.stack([x, y, z], dim=-1)
    sin_half = torch.linalg.vector_norm(axis, dim=-1)
    small = sin_half < 1e-6
    axis = axis / torch.where(small, torch.ones_like(sin_half), sin_half)[..., None]
    fallback = torch.zeros_like(axis)
    fallback[..., 0] = 1.0
    axis = torch.where(small[..., None], fallback, axis)
    speed = 2.0 * torch.atan2(sin_half, w)
    speed = torch.where(speed > math.pi, speed - 2.0 * math.pi, speed)
    return axis * speed[..., None]


def reward(states, sensors, controls, params: dict, extras) -> torch.Tensor:
    """(R, T, nq + nv) -> (R,): -(w_pos / 2 |p - goal|^2 + w_rot / 2 |log(q^* goal)|^2), averaged over T."""
    goal_pos = torch.tensor(GOAL_POS, dtype=states.dtype, device=states.device)
    goal_quat = torch.tensor(GOAL_QUAT, dtype=states.dtype, device=states.device)
    pos_diff = states[..., :3] - goal_pos
    quat_err = _quat_diff_so3(states[..., 3:7], goal_quat)
    pos_cost = params["w_pos"] * 0.5 * torch.square(pos_diff).sum(-1).mean(-1)
    rot_cost = params["w_rot"] * 0.5 * torch.square(quat_err).sum(-1).mean(-1)
    return -(pos_cost + rot_cost)
