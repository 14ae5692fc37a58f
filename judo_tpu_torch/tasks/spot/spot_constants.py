"""Spot task constants (the port's own copy of
``judo_tpu/tasks/spot/spot_constants.py``: the robot and policy interface
contract)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

# The locomotion policy's weights: the layers of the Gemm/activation chain of
# the Spot locomotion ONNX network, in the package's own container format.
SPOT_LOCOMOTION_POLICY_PATH = Path(__file__).resolve().parents[2] / "models" / "policies" / "spot_locomotion.jtw"

DEFAULT_SPOT_ROLLOUT_CUTOFF_TIME: float = 0.125  # 8 Hz MPC budget

N_LEGS = 4
N_LEG_JOINTS = 3
POLICY_OUTPUT_DIM = N_LEGS * N_LEG_JOINTS  # 12

LEG_JOINT_NAMES = [
    "fl_hx", "fl_hy", "fl_kn",
    "fr_hx", "fr_hy", "fr_kn",
    "hl_hx", "hl_hy", "hl_kn",
    "hr_hx", "hr_hy", "hr_kn",
]

ARM_JOINT_NAMES = ["arm_sh0", "arm_sh1", "arm_el0", "arm_el1", "arm_wr0", "arm_wr1", "arm_f1x"]

GRIPPER_CLOSED_POS = 0.0
GRIPPER_OPEN_POS = -1.54

LEGS_STANDING_POS = np.array([0.12, 0.72, -1.45] * 2 + [0.12, 0.72, -1.45] * 2)
LEGS_STANDING_POS[3] = LEGS_STANDING_POS[9] = -0.12  # right-side hip_x mirror

# RL-training default joint positions (policy normalization origin)
LEGS_STANDING_POS_RL = np.array([0.12, 0.5, -1.0, -0.12, 0.5, -1.0, 0.12, 0.5, -1.0, -0.12, 0.5, -1.0])

ARM_STOWED_POS = np.array([0, -3.11, 3.13, 1.56, 0, -1.56, GRIPPER_CLOSED_POS])
ARM_UNSTOWED_POS = np.array([0, -0.9, 1.8, 0, -0.9, 0, GRIPPER_CLOSED_POS])

STANDING_HEIGHT = 0.52
STANDING_HEIGHT_CMD = STANDING_HEIGHT

LEG_SOFT_LOWER_JOINT_LIMITS = np.array([-0.6, -0.8, -2.7] * N_LEGS)
LEG_SOFT_UPPER_JOINT_LIMITS = np.array([0.6, 1.65, -0.3] * N_LEGS)
ARM_SOFT_LOWER_JOINT_LIMITS = ARM_UNSTOWED_POS - np.array([1.0, 1.0, 0.8, np.pi / 2, 0.7, np.pi / 4, 0])
ARM_SOFT_UPPER_JOINT_LIMITS = ARM_UNSTOWED_POS + np.array([1.0, 0.8, 0.6, np.pi / 2, 0.9, np.pi / 4, 0])

# 25-dim policy command: [base_vel(3), arm(7), legs(12), torso(3)]
COMMAND_DIM = 25
BASE_VEL_CMD_INDS = [0, 1, 2]
ARM_CMD_INDS = [3, 4, 5, 6, 7, 8, 9]
LEG_CMD_INDS = list(range(10, 22))
FRONT_LEG_CMD_INDS = [10, 11, 12, 13, 14, 15]
TORSO_CMD_INDS = [22, 23, 24]

BASE_SOFT_LIMITS = 0.7 * np.ones(3)
TORSO_LOWER = np.array([-0.0, -1.0, 0.3])
TORSO_UPPER = np.array([+0.0, +1.0, 1.0])

Z_AXIS = np.array([0.0, 0.0, 1.0])
TIRE_RADIUS = 0.33
TIRE_HALF_WIDTH = 0.17
BOX_HALF_LENGTH = 0.254

# default joint pose used by the policy normalization: 12 legs (RL pose) + 7
# arm (unstowed, gripper open) — mujoco joint order
# (system_class.cpp:121-122)
DEFAULT_JOINT_POS = np.concatenate([LEGS_STANDING_POS_RL, np.array([0, -0.9, 1.8, 0, -0.9, 0, -1.54])])

# Permutations between mujoco joint order (legs FL,FR,HL,HR x (hx,hy,kn) then
# arm) and the policy's "orbit" order (breadth-first: joint type major).
# Convention: v_orbit = v_mujoco[MUJOCO_TO_ORBIT]; v_mujoco = v_orbit[ORBIT_TO_MUJOCO].
# (Derived from the Eigen permutation semantics in system_class.cpp:103-118.)
_sigma_m2o = np.array([1, 6, 11, 2, 7, 12, 3, 8, 13, 4, 9, 14, 0, 5, 10, 15, 16, 17, 18])
MUJOCO_TO_ORBIT = np.argsort(_sigma_m2o)  # gather indices: orbit[j] = mujoco[argsort][j]
ORBIT_TO_MUJOCO = _sigma_m2o.copy()

_sigma_o2m_legs = np.array([0, 3, 6, 9, 1, 4, 7, 10, 2, 5, 8, 11])
ORBIT_TO_MUJOCO_LEGS = np.argsort(_sigma_o2m_legs)
MUJOCO_TO_ORBIT_LEGS = _sigma_o2m_legs.copy()
