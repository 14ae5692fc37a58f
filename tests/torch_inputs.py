"""Seeded inputs shared by the port's tests: leap contact batches, Spot
policy-rollout batches, and the Spot object scenes' batches, made with numpy
from a seed. Batch-first arrays unless a builder says otherwise; ``lanes``
turns them into the kernels' batch-last tensors."""

import numpy as np
import pytest
import torch

from judo_tpu_torch.tasks.leap_cube import QPOS_REST
from judo_tpu_torch.tasks.spot import spot_constants as sc

# Spot standing with its arm stowed, and the joint targets that hold it there.
STAND = np.array([0, 0, sc.STANDING_HEIGHT, 1, 0, 0, 0, *sc.LEGS_STANDING_POS, *sc.ARM_STOWED_POS])
TARGETS = np.r_[sc.LEGS_STANDING_POS, sc.ARM_STOWED_POS]
# The tire of spot_tire_upright tipped onto its rim, as in the middle of a
# flip. Lying flat, its axis is along the ground's normal, where the
# plane-cylinder rim direction is rounding noise (ROADMAP.md, "The reference
# behaves as follows").
TIRE_TILT = 0.5


def leap_batch(R: int, T: int, seed: int):
    """(qpos (R, 23), qvel (R, 22), ctrl (R, T, 16)): the cube resting in the
    hand, moved by up to a millimetre, and the fingers' targets around rest."""
    rng = np.random.default_rng(seed)
    qp = np.tile(QPOS_REST, (R, 1))
    qp[:, :3] += 5e-4 * rng.standard_normal((R, 3))
    qv = 0.05 * rng.standard_normal((R, 22))
    ct = np.tile(QPOS_REST[7:], (R, T, 1)) + 0.1 * rng.standard_normal((R, T, 16))
    return qp, qv, ct


def policy_inputs(nv: int, T: int, seed: int, B: int = 3):
    """(qpos (B, 26), qvel (B, nv), policy output (B, 12), commands (B, T, 25)):
    Spot standing, small velocities, a random nonzero policy output and
    walking commands; the second rollout overrides its front-right leg."""
    rng = np.random.default_rng(seed)
    qp = np.tile(STAND, (B, 1))
    qv = 0.05 * rng.standard_normal((B, nv))
    pout = 0.3 * rng.standard_normal((B, 12))
    cmds = np.zeros((B, T, 25))
    cmds[..., :3] = 0.4 * rng.standard_normal((B, T, 3))
    cmds[..., 3:10] = sc.ARM_STOWED_POS
    cmds[..., 24] = sc.STANDING_HEIGHT_CMD
    cmds[1 % B, :, 13:16] = 0.3
    return qp, qv, pout, cmds


def object_pose(task, rng, tilt: float = TIRE_TILT) -> np.ndarray:
    """Spot standing at the origin with its arm at the task's reset, and the
    object against its front feet, a few cm from its place and 5 mm into the
    ground: the box upright, the tire of spot_tire_roll upright, the tire of
    spot_tire_upright flat under a random yaw and tipped ``tilt`` about x."""
    robot = np.r_[0.0, 0.0, sc.STANDING_HEIGHT, 1, 0, 0, 0, sc.LEGS_STANDING_POS, task.reset_arm_pos]
    dx, dy = 0.03 * rng.standard_normal(2)
    sink = 0.005
    if task.name == "spot_box_push":
        obj = [0.6 + dx, dy, sc.BOX_HALF_LENGTH - sink, 1, 0, 0, 0]
    elif task.name == "spot_tire_roll":
        obj = [0.66 + dx, dy, sc.TIRE_RADIUS - sink, 1, 0, 0, 0]
    else:
        yaw, sign = rng.uniform(0, 2 * np.pi), rng.choice([-1.0, 1.0])
        c, s = np.cos(yaw / 2), np.sin(yaw / 2)
        w, x, y, z = np.array([c, sign * c, sign * s, s]) / np.sqrt(2)
        ct, st = np.cos(tilt / 2), np.sin(tilt / 2)
        quat = [ct * w - st * x, ct * x + st * w, ct * y - st * z, ct * z + st * y]
        height = sc.TIRE_RADIUS * np.sin(tilt) + sc.TIRE_HALF_WIDTH * np.cos(tilt) - sink
        obj = [0.66 + dx, dy, height, *quat]
    return np.r_[robot, obj]


def object_inputs(task, B: int, T: int, seed: int, tilt: float = TIRE_TILT):
    """(qpos (B, 33), qvel (B, 31), policy output (B, 12), commands (B, T, 25))
    on a Spot object scene: ``object_pose`` per rollout with the robot's
    joints perturbed, small velocities, a random nonzero policy output, and
    walking commands with the arm at the task's reset."""
    rng = np.random.default_rng(seed)
    qp = np.stack([object_pose(task, rng, tilt) for _ in range(B)])
    qp[:, 7:26] += 0.05 * rng.standard_normal((B, 19))
    qv = 0.05 * rng.standard_normal((B, task.nv))
    pout = 0.3 * rng.standard_normal((B, 12))
    cmds = np.zeros((B, T, 25))
    cmds[..., :3] = 0.5 * rng.standard_normal((B, T, 3))
    cmds[..., 3:10] = task.reset_arm_pos
    cmds[..., 24] = sc.STANDING_HEIGHT_CMD
    return qp, qv, pout, cmds


def lanes(*arrays):
    """Batch-first arrays as the kernels' batch-last float64 tensors: (B, n)
    -> (n, B) and (B, T, n) -> (T, n, B)."""
    return [torch.tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1) if a.ndim == 2 else a.transpose(1, 2, 0)))
            for a in arrays]


# A pusher touching the cart (cylinder_push).
CYLINDER_PUSH_CONTACT = np.array([0.0, 0.0, 0.45, 0.05])


def scene_batch(scene: str, m, B: int, T: int, seed: int):
    """(qpos (B, nq), qvel (B, nv), ctrl (B, T, nu)) with contacts active: leap
    as ``leap_batch``; cylinder_push's pusher against the cart; fr3_pick's arm
    around its home pose with the object on the table; on the check scene
    (``judo_tpu_torch/models/check_scene.py``) the free and ball joints
    turned from their springs' rest and the pusher near the pendulum's rod."""
    if scene == "leap":
        return leap_batch(B, T, seed)
    rng = np.random.default_rng(seed)
    if scene == "check":
        qp = np.tile(np.asarray(m.qpos0, np.float64), (B, 1))
        qp[:, :2] += 0.005 * rng.standard_normal((B, 2))
        for adr in (3, 7):  # the free joint's and the ball joint's quaternions
            q = qp[:, adr : adr + 4] + 0.1 * rng.standard_normal((B, 4))
            qp[:, adr : adr + 4] = q / np.linalg.norm(q, axis=1, keepdims=True)
        qp[:, 11] = -0.02 + 0.01 * rng.standard_normal(B)
        qv = 0.1 * rng.standard_normal((B, m.nv))
        ct = 0.5 * rng.standard_normal((B, T, m.nu))
    elif scene == "cylinder_push":
        qp = np.tile(CYLINDER_PUSH_CONTACT, (B, 1)) + 0.02 * rng.standard_normal((B, 4))
        qv = 0.3 * rng.standard_normal((B, m.nv))
        ct = 0.5 * rng.standard_normal((B, T, m.nu))
    else:
        from judo_tpu_torch.tasks.fr3_pick import QPOS_HOME

        qp = np.tile(QPOS_HOME, (B, 1))
        qp[:, 7:14] += 0.05 * rng.standard_normal((B, 7))
        qv = 0.1 * rng.standard_normal((B, m.nv))
        ct = np.r_[QPOS_HOME[7:14], 0.04] + 0.05 * rng.standard_normal((B, T, m.nu))
    return qp, qv, ct


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for torch while a test runs: the port's plain
    versions are thousands of small operations, which a pool of threads per
    test process only slows when the suite's processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
