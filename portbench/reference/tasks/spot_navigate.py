"""Spot navigating its base to a goal with the locomotion policy in the loop:
the benchmark's frozen copy of the reward and command mapping of
``judo_tpu_torch/tasks/spot/spot_navigate.py`` and ``spot_base.py`` (the
compact action is the base velocity command; no arm, legs or torso)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import spot as sc

SNAPSHOT = "judo_tpu_torch/models/spot_navigate.npz"
POLICY = "judo_tpu_torch/models/policies/spot_locomotion.jtw"
SUBSTEPS = 2
# the command with the arm stowed and the torso at standing height; the
# planner's action fills its base velocity
DEFAULT_POLICY_COMMAND = np.array([0, 0, 0, *sc.ARM_STOWED_POS, *([0.0] * 12), 0, 0, sc.STANDING_HEIGHT_CMD])


def warm_start(model, extras) -> np.ndarray:
    return np.zeros(3)


def ctrl_bounds(model, extras) -> np.ndarray:
    return np.stack([-sc.BASE_SOFT_LIMITS, sc.BASE_SOFT_LIMITS], axis=-1)


def sim_ctrl(controls: torch.Tensor) -> torch.Tensor:
    """(..., 3) base velocity -> (..., 25) policy command."""
    out = torch.as_tensor(DEFAULT_POLICY_COMMAND, dtype=controls.dtype, device=controls.device)
    out = out.expand(*controls.shape[:-1], sc.COMMAND_DIM).clone()
    out[..., 0:3] = controls[..., 0:3]
    return out


def reward(states, sensors, controls, params: dict, extras) -> torch.Tensor:
    """Goal proximity (the base's mean distance to the goal), a fall penalty
    when the base drops to the threshold, and a control cost."""
    i = int(extras["body_pose_idx"])
    body_height = states[..., i + 2]
    body_pos = states[..., i : i + 3]
    fallen = -params["fall_penalty"] * torch.any(body_height <= params["spot_fallen_threshold"], dim=-1).to(states.dtype)
    goal = -params["w_goal"] * torch.linalg.norm(body_pos - params["goal_position"][None, None], dim=-1).mean(-1)
    ctrl_cost = -params["w_controls"] * torch.linalg.norm(controls, dim=-1).mean(-1)
    return fallen + goal + ctrl_cost
