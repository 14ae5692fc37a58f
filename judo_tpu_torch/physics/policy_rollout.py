"""The fused policy-in-the-loop rollout (counterpart of
``judo_tpu/physics/pallas_step.py:310-513``).

``fused_policy_rollout`` is the wrapper of the hand-written CUDA kernel
(``csrc/fused_policy_rollout.cu``, the port of the Pallas kernel
``pallas_step.py::_build_fused_policy_rollout``). For CUDA tensors it launches
the kernel or raises; for CPU tensors it runs
``policy_rollout_lanes_reference``, the plain PyTorch version:
``spot_policy_step_l`` in a Python loop over the policy ticks, forces cold at
the first tick and the probe carried. ``policy_rollout_lanes`` is the public
entry with the JAX package's batch-first layout. The kernel runs one warp per
rollout with its scratch in dynamic shared memory, in the layout the sizes
pick (see ``fused_rollout.py``: J moves to global memory where the whole
scratch does not fit, and a model that fits neither way raises), so rollouts
are not padded.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from judo_tpu_torch.physics.fused_rollout import (
    SHARED,
    _check_layout,
    _cuda_lib,
    _sizes,
    choose_layout,
    count_launch,
    jslab,
    model_tensors,
    pack_model,
    scratch_elems,
    smem_limit,
)
from judo_tpu_torch.physics.model import PhysicsModel, num_constraint_rows
from judo_tpu_torch.tasks.spot import spot_constants as sc
from judo_tpu_torch.tasks.spot.policy import ACTIVATIONS, SpotPolicy, spot_policy_step_l

NCMD, NPOUT = 25, 12


class PolicyLaneRolloutOutput(NamedTuple):
    states: torch.Tensor  # (R, T, nq + nv)
    sensordata: torch.Tensor  # (R, T, nsensordata)
    final_policy_output: torch.Tensor  # (R, 12) the output of the last tick


def policy_rollout_lanes_reference(
    m: PhysicsModel,
    policy: SpotPolicy,
    qpos: torch.Tensor,  # (nq, B)
    qvel: torch.Tensor,  # (nv, B)
    pout0: torch.Tensor,  # (12, B)
    cmds: torch.Tensor,  # (T, 25, B)
    substeps: int = 2,
    iterations: int | None = None,
):
    """The plain version of the kernel: -> ((T,nq,B), (T,nv,B), (T,ns_,B), (T,12,B))."""
    nefc = num_constraint_rows(m)
    B = qpos.shape[-1]
    f = qpos.new_zeros((nefc, B)) if nefc else None
    v = qpos.new_ones((nefc, B)) if nefc else None
    pout = pout0
    qps, qvs, senss, pouts = [], [], [], []
    for cmd in cmds:
        out = spot_policy_step_l(m, policy, qpos, qvel, cmd, pout, substeps, f, v, iterations)
        qpos, qvel, pout = out.qpos, out.qvel, out.policy_output
        if nefc:
            f, v = out.efc_force, out.cw_v
        qps.append(qpos)
        qvs.append(qvel)
        senss.append(out.sensordata if m.nsensordata else qpos.new_zeros((1, B)))
        pouts.append(pout)
    return torch.stack(qps), torch.stack(qvs), torch.stack(senss), torch.stack(pouts)


def pack_policy(policy: SpotPolicy, device, dtype) -> tuple:
    """The policy as the kernel reads it (layouts of csrc/jt_policy.cuh), on
    ``device`` in ``dtype``, made once per device and dtype: an int32 array
    (layer dims and activations, joint-order permutations), a scalar array
    (default joint pose, then each layer's weights input-major, element
    (i, r) of an in x out layer at i * out + r, then its biases) and the widest
    layer. The input-major order lets the lanes of a warp, one output neuron
    each, read consecutive weights."""
    key = (str(device), dtype)
    if key not in policy._packed:
        dims = policy.dims
        ints = [len(policy.layers), *dims, *(ACTIVATIONS[a] for a in policy.activations),
                *sc.MUJOCO_TO_ORBIT, *sc.ORBIT_TO_MUJOCO_LEGS]
        blocks = [torch.cat([lin.weight.T, lin.bias[None]], 0).reshape(-1).double().cpu() for lin in policy.layers]
        scalars = torch.cat([torch.as_tensor(sc.DEFAULT_JOINT_POS, dtype=torch.float64), *blocks])
        policy._packed[key] = (
            torch.as_tensor(np.asarray(ints, np.int32)).to(device), scalars.to(device=device, dtype=dtype), max(dims)
        )
    return policy._packed[key]


def _check_inputs(m: PhysicsModel, policy: SpotPolicy, qpos, qvel, pout0, cmds):
    B = qpos.shape[-1]
    if policy.dims[0] != 84 or policy.dims[-1] != NPOUT or m.nu != 19:
        raise ValueError(f"the Spot policy path needs an 84 -> ... -> 12 policy and 19 actuators, "
                         f"got {policy.dims} and nu {m.nu}")
    want = {"qpos": (m.nq, B), "qvel": (m.nv, B), "pout0": (NPOUT, B), "cmds": (cmds.shape[0], NCMD, B)}
    for name, x in (("qpos", qpos), ("qvel", qvel), ("pout0", pout0), ("cmds", cmds)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {want[name]}")
        if x.dtype != qpos.dtype or x.device != qpos.device:
            raise ValueError(f"{name} must share qpos's dtype and device")
    if qpos.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {qpos.dtype}")


def _launch(lib, m, policy, qpos, qvel, pout0, cmds, substeps, iterations, stream, layout=None):
    """Run the library's fused policy rollout on contiguous tensors; ``layout``
    as in fused_rollout.py:_launch."""
    B, T = qpos.shape[-1], cmds.shape[0]
    dev, dtype = qpos.device, qpos.dtype
    sizes = _sizes(m, B, T, substeps, iterations)
    _check_layout(lib, m, sizes)
    mi, mf = model_tensors(m, dev, dtype)
    pi, pf, maxw = pack_policy(policy, dev, dtype)
    c = pack_model(m)["counts"]
    if layout is not None:
        scratch_elems(lib, sizes, layout, maxw)
    else:
        limit = smem_limit(lib) if qpos.is_cuda else None
        choose_layout(lib, sizes, qpos.element_size(), "fused_policy_rollout", maxw, limit)
    ins = [x.contiguous() for x in (qpos, qvel, pout0, cmds)]
    oq = torch.empty((T, m.nq, B), dtype=dtype, device=dev)
    ov = torch.empty((T, m.nv, B), dtype=dtype, device=dev)
    os_ = torch.empty((T, c["ns_"], B), dtype=dtype, device=dev)
    op = torch.empty((T, NPOUT, B), dtype=dtype, device=dev)
    fn = lib.jt_fused_policy_rollout_f64 if dtype == torch.float64 else lib.jt_fused_policy_rollout_f32
    args = [mi, mf, pi, pf, *ins, oq, ov, os_, op, jslab(lib, sizes, B, dtype, dev)]
    err = fn(ctypes.byref(sizes), *[a.data_ptr() for a in args], maxw, stream)
    if err != 0:
        raise RuntimeError(f"fused_policy_rollout kernel launch failed: {lib.jt_error_string(err).decode()} ({err})")
    return oq, ov, os_, op


def fused_policy_rollout(
    m: PhysicsModel,
    policy: SpotPolicy,
    qpos: torch.Tensor,  # (nq, B)
    qvel: torch.Tensor,  # (nv, B)
    pout0: torch.Tensor,  # (12, B)
    cmds: torch.Tensor,  # (T, 25, B)
    substeps: int = 2,
    iterations: int | None = None,
):
    """The fused policy rollout, batch-last: -> ((T,nq,B), (T,nv,B), (T,ns_,B), (T,12,B)).

    CUDA tensors launch the kernel (``fused_policy_rollout.launches`` counts
    each launch, a solve graph's replay the launches it captured); CPU
    tensors run the plain version. Nothing else is accepted.
    """
    _check_inputs(m, policy, qpos, qvel, pout0, cmds)
    if qpos.device.type == "cpu":
        return policy_rollout_lanes_reference(m, policy, qpos, qvel, pout0, cmds, substeps, iterations)
    lib = _cuda_lib(qpos, "fused_policy_rollout")
    with torch.cuda.device(qpos.device):
        stream = torch.cuda.current_stream(qpos.device).cuda_stream
        out = _launch(lib, m, policy, qpos, qvel, pout0, cmds, substeps, iterations, stream)
    count_launch(fused_policy_rollout)
    return out


fused_policy_rollout.launches = 0


def fused_policy_rollout_host_twin(m, policy, qpos, qvel, pout0, cmds, substeps: int = 2, iterations=None,
                                   layout: str = SHARED):
    """The kernel's own code built with g++ and run on the CPU, one rollout
    after another, with the warp's 32 lanes played in one thread in the
    card's order (csrc/fused_policy_rollout_host.cpp), in scratch layout
    ``layout``. For tests."""
    _check_inputs(m, policy, qpos, qvel, pout0, cmds)
    from judo_tpu_torch import _build

    return _launch(_build.load("host"), m, policy, qpos, qvel, pout0, cmds, substeps, iterations, None, layout)


def policy_rollout_lanes(
    m: PhysicsModel,
    policy: SpotPolicy,
    qpos0: torch.Tensor,  # (R, nq)
    qvel0: torch.Tensor,  # (R, nv)
    commands: torch.Tensor,  # (R, T, 25)
    last_policy_output: torch.Tensor,  # (R, 12)
    physics_substeps: int = 2,
    iterations: int | None = None,
) -> PolicyLaneRolloutOutput:
    """Batched policy-in-the-loop rollout with batch-first states at the
    boundary (the semantics of pallas_step.policy_rollout_lanes: post-tick
    (qpos, qvel), the last substep's pre-integration sensors, and the policy
    output of the last tick)."""
    qps, qvs, senss, pouts = fused_policy_rollout(
        m, policy, qpos0.T.contiguous(), qvel0.T.contiguous(), last_policy_output.T.contiguous(),
        commands.permute(1, 2, 0).contiguous(), physics_substeps, iterations,
    )
    states = torch.cat([qps, qvs], dim=1).permute(2, 0, 1)
    senss = senss.permute(2, 0, 1)[:, :, : m.nsensordata]
    return PolicyLaneRolloutOutput(states=states, sensordata=senss, final_policy_output=pouts[-1].T)
