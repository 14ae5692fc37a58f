"""The Spot locomotion policy in the loop, batch-last (counterpart of
``judo_tpu/tasks/spot/policy.py`` and ``policy_lanes.py``).

- ``SpotPolicy``: the locomotion MLP as an ``nn.Module`` (84 -> 512 -> 256 ->
  128 -> 12, ELU on the hidden layers), an ``MLPPolicy`` of
  ``utils/onnx_loader.py`` loaded from the package's ``.jtw`` container or a
  user's ``.onnx`` or ``.jtw`` (``SpotPolicy.load``), or carried across from
  the JAX parameters (``policy_from_numpy``). Its parameters are float32 at
  every dtype, as the JAX lanes path rounds them (``policy_lanes.py:60-67``);
  a float64 rollout runs the same rounded values.
- ``build_observation_l``: the 84-dim observation; ``control_from_policy_l``:
  the 19 position targets with the first-active-leg override;
  ``spot_policy_step_l``: one 50 Hz tick (obs -> MLP -> ctrl -> substeps).

Every function here is the plain version of the policy part of the fused
policy rollout kernel (``csrc/jt_policy.cuh``).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from judo_tpu_torch.physics.lane_engine import bsum, l_quat_rotate
from judo_tpu_torch.physics.lane_step import step_l
from judo_tpu_torch.physics.model import PhysicsModel, resolve_device
from judo_tpu_torch.tasks.spot import spot_constants as sc
from judo_tpu_torch.utils.onnx_loader import MLPPolicy, gemm_chain, load_graph

# Activation codes of csrc/jt_policy.cuh (the ones the Spot network uses).
# ELU is the exp form of the JAX lanes path (policy_lanes.py:42-46).
ACTIVATIONS = {"": 0, "Elu": 1}


def activate(act: str, x: torch.Tensor) -> torch.Tensor:
    if act == "Elu":
        return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)
    return x


class SpotPolicy(MLPPolicy):
    """The locomotion MLP, in float32. ``layers[i].weight`` (out, in) is the
    kernel's W^T; ``activations[i]`` follows layer i ("" for none), each one
    the kernel computes."""

    def __init__(self, layers: list, activations: tuple) -> None:
        bad = [a for a in activations if a not in ACTIVATIONS]
        if bad:
            raise NotImplementedError(f"activations {bad} (ported: {sorted(ACTIVATIONS)})")
        super().__init__(layers, activations, dtype=torch.float32)
        self._packed: dict = {}

    @staticmethod
    def load(path: str | Path | None = None, device="cuda") -> "SpotPolicy":
        """A locomotion policy from a user's ``.onnx`` or ``.jtw`` (the
        package's own ``.jtw`` by default) on ``device``."""
        graph = load_graph(sc.SPOT_LOCOMOTION_POLICY_PATH if path is None else path)
        return SpotPolicy(*gemm_chain(graph)).to(resolve_device(device))

    @property
    def dims(self) -> list:
        return [self.layers[0].in_features] + [lin.out_features for lin in self.layers]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., in) -> (..., out), in the input's dtype."""
        cols = x.reshape(-1, x.shape[-1]).T
        return mlp_l(self, cols).T.reshape(*x.shape[:-1], -1)


def policy_from_numpy(weights, activations) -> SpotPolicy:
    """A ``SpotPolicy`` from JAX-layout parameters: ``weights`` is
    ((W (in, out), b (out,)), ...) as ``judo_tpu``'s ``MLPPolicy`` holds them."""
    return SpotPolicy([(np.asarray(w).T, np.asarray(b)) for w, b in weights], tuple(activations))


# Columns the MLP multiplies at a time: bounds its (out, in, columns) product
# (at 512 x 512 inputs of a hidden layer, 64 columns hold 16 MiB in float64).
MLP_COLUMNS = 64


def mlp_l(policy: SpotPolicy, x: torch.Tensor) -> torch.Tensor:
    """The MLP on (in, B) columns, in x's dtype (the float32 weights widen
    exactly). Each column's products are summed by ``bsum``, so a rollout's
    output does not depend on the batch width; the columns go MLP_COLUMNS
    at a time."""
    for lin, act in zip(policy.layers, policy.activations):
        w = lin.weight.to(x.dtype)[:, :, None]
        y = torch.cat([bsum(w * x[None, :, c : c + MLP_COLUMNS], 1) for c in range(0, x.shape[1], MLP_COLUMNS)], dim=1)
        x = activate(act, y + lin.bias.to(x.dtype)[:, None])
    return x


def build_observation_l(qpos: torch.Tensor, qvel: torch.Tensor, command: torch.Tensor, last_output: torch.Tensor):
    """84-dim observation columns from (nq, B), (nv, B), (25, B), (12, B):
    body-frame linear velocity, angular velocity, projected gravity, the
    command, joint positions (minus the default pose) and velocities in the
    policy's joint order, and the last policy output."""
    qinv = qpos[3:7] * qpos.new_tensor([1.0, -1.0, -1.0, -1.0])[:, None]
    down = qpos.new_tensor([0.0, 0.0, -1.0])[:, None].expand(3, qpos.shape[-1])
    m2o = torch.as_tensor(sc.MUJOCO_TO_ORBIT, device=qpos.device)
    djp = torch.as_tensor(sc.DEFAULT_JOINT_POS, dtype=qpos.dtype, device=qpos.device)[:, None]
    return torch.cat(
        [
            l_quat_rotate(qinv, qvel[0:3]),
            qvel[3:6],
            l_quat_rotate(qinv, down),
            command,
            (qpos[7:26] - djp)[m2o],
            qvel[6:25][m2o],
            last_output,
        ]
    )


def control_from_policy_l(policy_output: torch.Tensor, command: torch.Tensor) -> torch.Tensor:
    """(12, B) policy output + (25, B) command -> (19, B) position targets:
    legs = default pose + 0.2 x output in mujoco order; the first leg whose
    command is nonzero takes it instead; the arm takes the command."""
    o2m = torch.as_tensor(sc.ORBIT_TO_MUJOCO_LEGS, device=command.device)
    djp12 = torch.as_tensor(sc.DEFAULT_JOINT_POS[:12], dtype=command.dtype, device=command.device)[:, None]
    legs = (0.2 * policy_output)[o2m] + djp12
    leg_cmd = command[10:22]
    active = (leg_cmd * leg_cmd).reshape(4, 3, -1).sum(1) > 0  # (4, B)
    first = active & (torch.cumsum(active.to(torch.int32), 0) == 1)
    legs = torch.where(torch.repeat_interleave(first, 3, dim=0), leg_cmd, legs)
    return torch.cat([legs, command[3:10]])


class PolicyStepOut(NamedTuple):
    qpos: torch.Tensor
    qvel: torch.Tensor
    sensordata: torch.Tensor
    efc_force: torch.Tensor
    cw_v: torch.Tensor
    policy_output: torch.Tensor  # (12, B)


def spot_policy_step_l(
    m: PhysicsModel,
    policy: SpotPolicy,
    qpos: torch.Tensor,
    qvel: torch.Tensor,
    command: torch.Tensor,  # (25, B)
    last_output: torch.Tensor,  # (12, B)
    physics_substeps: int = 2,
    f_warm: torch.Tensor | None = None,
    cw_v: torch.Tensor | None = None,
    solver_iterations: int | None = None,
) -> PolicyStepOut:
    """One policy tick: obs -> MLP -> ctrl -> ``physics_substeps`` x step_l
    (none leaves the state as it was and the sensors at zero)."""
    pout = mlp_l(policy, build_observation_l(qpos, qvel, command, last_output))
    ctrl = control_from_policy_l(pout, command)
    sens = qpos.new_zeros((m.nsensordata, qpos.shape[-1]))  # no substeps: the policy alone
    for _ in range(physics_substeps):
        out = step_l(m, qpos, qvel, ctrl, f_warm, solver_iterations, cw_v=cw_v)
        qpos, qvel, sens, f_warm, cw_v = out.qpos, out.qvel, out.sensordata, out.efc_force, out.cw_v
    return PolicyStepOut(qpos, qvel, sens, f_warm, cw_v, pout)


__all__ = [
    "SpotPolicy", "build_observation_l", "control_from_policy_l", "mlp_l", "policy_from_numpy",
    "spot_policy_step_l",
]
