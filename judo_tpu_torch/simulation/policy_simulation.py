"""Policy-in-the-loop plant for Spot (counterpart of
``judo_tpu/simulation/policy_simulation.py``).

Each tick runs one 50 Hz locomotion-policy tick on the host (observation,
MLP, 19-dim ctrl) and then ``task.physics_substeps`` calls to ``mj_step``,
carrying the policy's last output across ticks and zeroing it on a task
switch. The policy is numpy, as in the JAX package: an 84 -> 12 MLP for one
environment is microseconds on the host. Its weights are the port's own
``models/policies/spot_locomotion.jtw``.
"""

from __future__ import annotations

import numpy as np

from judo_tpu_torch.simulation.base import sim_ctrl
from judo_tpu_torch.simulation.mj_simulation import MJSimulation
from judo_tpu_torch.tasks import Task
from judo_tpu_torch.tasks.spot import spot_constants as sc
from judo_tpu_torch.utils.onnx_loader import gemm_chain, read_container

_NP_ACTIVATIONS = {
    "Relu": lambda x: np.maximum(x, 0.0),
    "Elu": lambda x: np.where(x > 0, x, np.expm1(x)),
    "Tanh": np.tanh,
    "Sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "LeakyRelu": lambda x: np.where(x > 0, x, 0.01 * x),
    "Softsign": lambda x: x / (1.0 + np.abs(x)),
}


def _np_quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate v by unit quaternion q (wxyz)."""
    w, x, y, z = q
    u = np.array([x, y, z])
    return 2.0 * np.dot(u, v) * u + (w * w - np.dot(u, u)) * v + 2.0 * w * np.cross(u, v)


class HostSpotPolicy:
    """Numpy evaluation of the locomotion policy for the host-side plant, with
    the semantics of ``tasks/spot/policy.py`` (the planning side's)."""

    def __init__(self) -> None:
        layers, activations = gemm_chain(read_container(sc.SPOT_LOCOMOTION_POLICY_PATH))
        # the container holds W as (out, in); x @ W^T + b
        self.layers = [(np.asarray(w, np.float64).T, np.asarray(b, np.float64)) for w, b in layers]
        self.activations = activations
        self.default_joint_pos = np.asarray(sc.DEFAULT_JOINT_POS, np.float64)
        self.mujoco_to_orbit = np.asarray(sc.MUJOCO_TO_ORBIT)
        self.orbit_to_mujoco_legs = np.asarray(sc.ORBIT_TO_MUJOCO_LEGS)

    def mlp(self, x: np.ndarray) -> np.ndarray:
        for (w, b), act in zip(self.layers, self.activations):
            x = x @ w + b
            if act:
                x = _NP_ACTIVATIONS[act](x)
        return x

    def observation(
        self, qpos: np.ndarray, qvel: np.ndarray, command: np.ndarray, last_output: np.ndarray
    ) -> np.ndarray:
        """The 84-dim observation (policy_simulation.py:77-90)."""
        inv_quat = qpos[3:7] * np.array([1.0, -1.0, -1.0, -1.0])
        linvel_body = _np_quat_rotate(inv_quat, qvel[0:3])
        angvel = qvel[3:6]
        gravity = _np_quat_rotate(inv_quat, np.array([0.0, 0.0, -1.0]))
        joint_pos = (qpos[7:26] - self.default_joint_pos)[self.mujoco_to_orbit]
        joint_vel = qvel[6:25][self.mujoco_to_orbit]
        return np.concatenate(
            [linvel_body, angvel, gravity, command[0:3], command[3:10], command[10:22],
             command[22:25], joint_pos, joint_vel, last_output]
        )

    def control(self, policy_output: np.ndarray, command: np.ndarray) -> np.ndarray:
        """The 19-dim ctrl from the policy output and command; the first
        nonzero leg command overrides its leg (policy_simulation.py:92-102)."""
        legs = (0.2 * policy_output)[self.orbit_to_mujoco_legs] + self.default_joint_pos[:12]
        leg_cmd = command[10:22]
        for i in range(4):
            block = leg_cmd[3 * i : 3 * i + 3]
            if np.linalg.norm(block) > 0:
                legs = legs.copy()
                legs[3 * i : 3 * i + 3] = block
                break
        return np.concatenate([legs, command[3:10]])

    def tick(
        self, qpos: np.ndarray, qvel: np.ndarray, command: np.ndarray, last_output: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """One policy tick: (ctrl (19,), policy_output (12,))."""
        out = self.mlp(self.observation(qpos, qvel, command, last_output))
        return self.control(out, command), out


class PolicySimulation(MJSimulation):
    """MuJoCo plant with the locomotion policy in the loop; plain
    ``MJSimulation`` for a task without one."""

    def __init__(self, task: Task) -> None:
        super().__init__(task)
        self._init_policy()

    def _init_policy(self) -> None:
        self._policy: HostSpotPolicy | None = HostSpotPolicy() if self.task.uses_locomotion_policy else None
        self._last_policy_output = np.zeros(sc.POLICY_OUTPUT_DIM)

    def set_task_instance(self, task: Task) -> None:
        super().set_task_instance(task)
        self._init_policy()

    @property
    def last_policy_output(self) -> np.ndarray:
        return self._last_policy_output.copy()

    @property
    def timestep(self) -> float:
        # one step() is one policy tick, task.dt (the substeps folded in)
        if self._policy is not None:
            return float(self.task.dt)
        return super().timestep

    def step(self, command: np.ndarray) -> None:
        if self._policy is None:
            super().step(command)
            return
        if self.paused:
            return
        self._pull_task_state()
        policy_cmd = sim_ctrl(self.task, command)
        if policy_cmd.shape[0] != sc.COMMAND_DIM:
            raise ValueError(f"policy command has {policy_cmd.shape[0]} dims, expected {sc.COMMAND_DIM}")
        d = self.data
        self.task.pre_sim_step()
        ctrl, self._last_policy_output = self._policy.tick(d.qpos, d.qvel, policy_cmd, self._last_policy_output)
        if ctrl.shape[0] != self.model.nu:
            raise ValueError(f"policy ctrl has {ctrl.shape[0]} dims, model.nu={self.model.nu}")
        d.ctrl[:] = ctrl
        for _ in range(self.task.physics_substeps):
            self.mujoco.mj_step(self.model, d)
        self._push_task_state()
        self.task.post_sim_step()
        self._pull_task_state()
