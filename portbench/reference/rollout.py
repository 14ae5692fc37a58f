"""Rollouts over the horizon, the plain way: the reference's counterparts of
the port's two rollout kernels, the fused rollout (K1) and the fused policy
rollout (K2). The benchmark's frozen copy of
``judo_tpu_torch/physics/fused_rollout.py:rollout_lanes_reference`` and
``physics/policy_rollout.py:policy_rollout_lanes_reference``, with the
batch-first boundary of ``rollout_lanes`` and ``policy_rollout_lanes``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.model import PhysicsModel, num_constraint_rows
from portbench.reference.policy import Policy, policy_step
from portbench.reference.step import step_l


class Rollouts(NamedTuple):
    states: torch.Tensor  # (R, T, nq + nv)
    sensors: torch.Tensor  # (R, T, nsensordata)
    carry: torch.Tensor  # (R, nefc) step-0 forces (K1), or (R, 12) the last tick's policy output (K2)


def rollout(m: PhysicsModel, qpos0, qvel0, ctrl, efc_warm, substeps: int, iterations: int | None) -> Rollouts:
    """K1's semantics: (R, nq), (R, nv), (R, T, nu), (R, nefc) -> post-step
    states and the last substep's pre-integration sensors per control, and
    the step-0 forces (the next solve's warm start)."""
    nefc = num_constraint_rows(m)
    qpos, qvel = qpos0.T.contiguous(), qvel0.T.contiguous()
    f = efc_warm.T.contiguous()[:nefc] if nefc else None
    v = torch.ones_like(f) if nefc else None
    efc0 = torch.zeros_like(efc_warm)
    qps, qvs, senss = [], [], []
    for t in range(ctrl.shape[1]):
        for _ in range(substeps):
            out = step_l(m, qpos, qvel, ctrl[:, t, : m.nu].T.contiguous(), f, iterations, cw_v=v)
            qpos, qvel, sens = out.qpos, out.qvel, out.sensordata
            if nefc:
                f, v = out.efc_force, out.cw_v
        qps.append(qpos)
        qvs.append(qvel)
        senss.append(sens)
        if t == 0 and nefc:
            efc0 = f.T
    states = torch.cat([torch.stack(qps), torch.stack(qvs)], dim=1).permute(2, 0, 1)
    return Rollouts(states, torch.stack(senss).permute(2, 0, 1), efc0)


def policy_rollout(m: PhysicsModel, policy: Policy, qpos0, qvel0, cmds, pout0, substeps: int,
                   iterations: int | None) -> Rollouts:
    """K2's semantics: (R, nq), (R, nv), (R, T, 25) commands, (R, 12) the
    previous solve's last policy output -> post-tick states, the last
    substep's sensors per tick, and the last tick's policy output. The
    constraint forces start cold every solve."""
    nefc = num_constraint_rows(m)
    qpos, qvel = qpos0.T.contiguous(), qvel0.T.contiguous()
    B = qpos.shape[-1]
    f = qpos.new_zeros((nefc, B)) if nefc else None
    v = qpos.new_ones((nefc, B)) if nefc else None
    pout = pout0.T.contiguous()
    qps, qvs, senss = [], [], []
    for t in range(cmds.shape[1]):
        qpos, qvel, sens, f, v, pout = policy_step(m, policy, qpos, qvel, cmds[:, t].T.contiguous(), pout, substeps,
                                                   f, v, iterations)
        qps.append(qpos)
        qvs.append(qvel)
        senss.append(sens)
    states = torch.cat([torch.stack(qps), torch.stack(qvs)], dim=1).permute(2, 0, 1)
    return Rollouts(states, torch.stack(senss).permute(2, 0, 1), pout.T)
