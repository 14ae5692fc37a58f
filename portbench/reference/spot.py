"""Spot's robot and policy interface constants, as the reference's Spot tasks
and policy read them: the benchmark's frozen copy of the values in
``judo_tpu_torch/tasks/spot/spot_constants.py``."""

from __future__ import annotations

import numpy as np

GRIPPER_CLOSED_POS = 0.0
STANDING_HEIGHT = 0.52
STANDING_HEIGHT_CMD = STANDING_HEIGHT

LEGS_STANDING_POS = np.array([0.12, 0.72, -1.45, -0.12, 0.72, -1.45, 0.12, 0.72, -1.45, -0.12, 0.72, -1.45])
# the policy's normalization origin: legs in the RL training pose, the arm
# unstowed with the gripper open (mujoco joint order)
LEGS_STANDING_POS_RL = np.array([0.12, 0.5, -1.0, -0.12, 0.5, -1.0, 0.12, 0.5, -1.0, -0.12, 0.5, -1.0])
DEFAULT_JOINT_POS = np.concatenate([LEGS_STANDING_POS_RL, np.array([0, -0.9, 1.8, 0, -0.9, 0, -1.54])])

ARM_STOWED_POS = np.array([0, -3.11, 3.13, 1.56, 0, -1.56, GRIPPER_CLOSED_POS])
BASE_SOFT_LIMITS = 0.7 * np.ones(3)

# The 25-dim policy command: [base velocity 3, arm 7, legs 12, torso 3].
COMMAND_DIM = 25
POLICY_OUTPUT_DIM = 12

# Joint order permutations between mujoco (legs FL, FR, HL, HR x (hx, hy,
# kn), then the arm) and the policy's joint-type-major order:
# v_policy = v_mujoco[MUJOCO_TO_ORBIT]; legs_mujoco = legs_policy[ORBIT_TO_MUJOCO_LEGS].
MUJOCO_TO_ORBIT = np.argsort(np.array([1, 6, 11, 2, 7, 12, 3, 8, 13, 4, 9, 14, 0, 5, 10, 15, 16, 17, 18]))
ORBIT_TO_MUJOCO_LEGS = np.argsort(np.array([0, 3, 6, 9, 1, 4, 7, 10, 2, 5, 8, 11]))
