"""The Spot locomotion policy in the loop, batch-last, in plain PyTorch: the
benchmark's frozen copy of ``judo_tpu_torch/tasks/spot/policy.py`` and of
the ``.jtw`` reader of ``judo_tpu_torch/utils/onnx_loader.py``.

The weights are read from the container file (``spot_locomotion.jtw``) as
data: float32, an (out, in) matrix and a bias per Gemm, an activation after
each. ``policy_step`` is one 50 Hz tick: observation, MLP, position targets,
then the physics substeps.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import spot as sc
from portbench.reference.engine import bsum, l_quat_rotate
from portbench.reference.step import step_l

_ONNX_DTYPES = {1: np.float32, 7: np.int64, 11: np.float64}
# Columns the MLP multiplies at a time (at 512 x 512 inputs of a hidden
# layer, 64 columns hold 16 MiB in float64).
MLP_COLUMNS = 64


class Policy(NamedTuple):
    weights: tuple  # float32 (out, in) per layer
    biases: tuple  # float32 (out,) per layer
    activations: tuple  # "" or "Elu" per layer

    @property
    def dims(self) -> list:
        return [self.weights[0].shape[1]] + [w.shape[0] for w in self.weights]


def read_container(path: str | Path) -> tuple[dict, list]:
    """(tensors, nodes) of a ``.jtw`` container: the magic ``JTONNX1\\0``; a
    u32 count of tensors, each a u32-length name, u32 ONNX dtype, u32 rank,
    u64 dims, u64 byte count and the raw bytes; a u32 count of nodes, each a
    u32-length op type and u32-counted lists of u32-length input and output
    names (little-endian)."""
    data = Path(path).read_bytes()
    if data[:8] != b"JTONNX1\0":
        raise ValueError(f"{path}: not a .jtw container")
    off = 8

    def take(fmt: str) -> int:
        nonlocal off
        v = struct.unpack_from(fmt, data, off)[0]
        off += struct.calcsize(fmt)
        return v

    def text() -> str:
        nonlocal off
        n = take("<I")
        off += n
        return data[off - n : off].decode()

    tensors = {}
    for _ in range(take("<I")):
        name, dtype, ndims = text(), take("<I"), take("<I")
        dims = [take("<Q") for _ in range(ndims)]
        nbytes = take("<Q")
        tensors[name] = np.frombuffer(data[off : off + nbytes], dtype=_ONNX_DTYPES.get(dtype, np.float32)).reshape(dims)
        off += nbytes
    nodes = []
    for _ in range(take("<I")):
        op = text()
        ins = [text() for _ in range(take("<I"))]
        outs = [text() for _ in range(take("<I"))]
        nodes.append((op, ins, outs))
    return tensors, nodes


def load_policy(path: str | Path, device) -> Policy:
    """The Gemm/Elu chain of a ``.jtw`` container, as float32 tensors on ``device``."""
    tensors, nodes = read_container(path)
    ws, bs, acts = [], [], []
    for op, ins, _ in nodes:
        if op == "Gemm":
            ws.append(tensors[next(i for i in ins if "weight" in i)])
            bs.append(tensors[next(i for i in ins if "bias" in i)])
            acts.append("")
        elif op == "Elu":
            acts[-1] = op
        elif op not in ("Flatten", "Identity", "Cast"):
            raise NotImplementedError(f"op {op} in the policy's graph")
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return Policy(tuple(f32(w) for w in ws), tuple(f32(b) for b in bs), tuple(acts))


def activate(act: str, x: torch.Tensor) -> torch.Tensor:
    if act == "Elu":
        return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)
    return x


def mlp_l(policy: Policy, x: torch.Tensor) -> torch.Tensor:
    """The MLP on (in, B) columns, in x's dtype (the float32 weights cast to it)."""
    for w, b, act in zip(policy.weights, policy.biases, policy.activations):
        w3 = w.to(x.dtype)[:, :, None]
        y = torch.cat([bsum(w3 * x[None, :, c : c + MLP_COLUMNS], 1) for c in range(0, x.shape[1], MLP_COLUMNS)], dim=1)
        x = activate(act, y + b.to(x.dtype)[:, None])
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


def policy_step(m, policy: Policy, qpos, qvel, command, last_output, substeps: int, f_warm, cw_v, iterations):
    """One policy tick -> (qpos, qvel, sensordata, forces, cw_v, policy output)."""
    pout = mlp_l(policy, build_observation_l(qpos, qvel, command, last_output))
    ctrl = control_from_policy_l(pout, command)
    sens = qpos.new_zeros((m.nsensordata, qpos.shape[-1]))
    for _ in range(substeps):
        out = step_l(m, qpos, qvel, ctrl, f_warm, iterations, cw_v=cw_v)
        qpos, qvel, sens, f_warm, cw_v = out.qpos, out.qvel, out.sensordata, out.efc_force, out.cw_v
    return qpos, qvel, sens, f_warm, cw_v, pout
