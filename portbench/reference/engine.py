"""Smooth dynamics of the lanes step in plain PyTorch: the benchmark's frozen
copy of ``judo_tpu_torch/physics/lane_engine.py``.

Every dynamic quantity is batch-last: a per-rollout scalar is (B,), a vector
(3, B), a matrix (3, 3, B), the mass matrix (nv, nv, B). Tree loops run in
Python over the static topology, as in the JAX package. This module is the
plain version the port's CUDA rollout kernels are held against; the
benchmark keeps its own copy so that no change to the port moves the
yardstick.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.model import BALL, FREE, HINGE, SLIDE, PhysicsModel

_MINVAL = 1e-15


def bsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` of a batch-last tensor, each rollout's sum taken in
    an order that does not depend on the batch width. ``torch.sum`` over a
    dimension other than the last reduces the batch columns together, in an
    order that changes with the width (and at a width of 1 reduces along the
    contiguous dimension instead), so a rollout would round differently in a
    shard of the batch than in the whole; here every column is one
    contiguous inner sum, as the kernel's one warp per rollout is."""
    return torch.sum(x.movedim(dim, -1).contiguous(), dim=-1)


def l_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product along the 3-axis (-2) of (..., 3, B) tensors."""
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-2)


def l_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the 3-axis: (..., 3, B) -> (..., B)."""
    return torch.sum(a * b, dim=-2)


def l_quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product on (4, ...) quaternions."""
    uw, ux, uy, uz = u[0], u[1], u[2], u[3]
    vw, vx, vy, vz = v[0], v[1], v[2], v[3]
    return torch.stack(
        [
            uw * vw - ux * vx - uy * vy - uz * vz,
            uw * vx + ux * vw + uy * vz - uz * vy,
            uw * vy - ux * vz + uy * vw + uz * vx,
            uw * vz + ux * vy - uy * vx + uz * vw,
        ]
    )


def l_quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (3, ...) vectors by (4, ...) quaternions."""
    u = q[1:4]
    uv = torch.stack([u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0]])
    uuv = torch.stack([u[1] * uv[2] - u[2] * uv[1], u[2] * uv[0] - u[0] * uv[2], u[0] * uv[1] - u[1] * uv[0]])
    return v + 2.0 * (q[0:1] * uv + uuv)


def l_quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(4, ...) quaternion -> (3, 3, ...) rotation matrix."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
        ]
    )


def l_quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q * torch.rsqrt(torch.clamp(torch.sum(q * q, dim=0), min=_MINVAL))


def l_quat_integrate(q: torch.Tensor, omega: torch.Tensor, h: float) -> torch.Tensor:
    """mju_quatIntegrate on (4, B) quaternions and (3, B) body angular velocity."""
    speed = torch.sqrt(torch.clamp(torch.sum(omega * omega, dim=0), min=1e-24))
    axis = omega / speed
    half = 0.5 * (speed * h)
    dq = torch.cat([torch.cos(half)[None], axis * torch.sin(half)[None]], dim=0)
    out = l_quat_mul(q, dq)
    return out / torch.sqrt(torch.clamp(torch.sum(out * out, dim=0), min=_MINVAL))[None]


def _col(v: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host constants as a (n, 1) column on ``like``'s device and dtype."""
    return torch.as_tensor(np.asarray(v, np.float64).reshape(-1, 1), dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# kinematics
# ---------------------------------------------------------------------------


class LaneKin(NamedTuple):
    xpos: torch.Tensor  # (nbody, 3, B)
    xquat: torch.Tensor  # (nbody, 4, B)
    xmat: torch.Tensor  # (nbody, 3, 3, B)
    xipos: torch.Tensor  # (nbody, 3, B)
    ximat: torch.Tensor  # (nbody, 3, 3, B)
    xanchor: list  # njnt x (3, B)
    xaxis: list  # njnt x (3, B)
    geom_xpos: torch.Tensor  # (ngeom, 3, B)
    geom_xmat: torch.Tensor  # (ngeom, 3, 3, B)
    site_xpos: torch.Tensor  # (nsite, 3, B)
    site_xmat: torch.Tensor  # (nsite, 3, 3, B)


def _frames(xpos: torch.Tensor, xquat: torch.Tensor, ids, pos: np.ndarray, quat: np.ndarray):
    """World frames of objects fixed to bodies ``ids`` at local (pos, quat)."""
    B = xpos.shape[-1]
    if len(ids) == 0:
        return xpos.new_zeros((0, 3, B)), xpos.new_zeros((0, 3, 3, B))
    idx = torch.as_tensor(list(ids), device=xpos.device)
    bp = xpos[idx].permute(1, 0, 2)  # (3, n, B)
    bq = xquat[idx].permute(1, 0, 2)  # (4, n, B)
    lp = _col(np.asarray(pos).T.reshape(3, -1), bp).reshape(3, -1, 1)
    lq = _col(np.asarray(quat).T.reshape(4, -1), bq).reshape(4, -1, 1)
    p = bp + l_quat_rotate(bq, lp.expand_as(bp))
    mat = l_quat_to_mat(l_quat_mul(bq, lq.expand_as(bq)))  # (3, 3, n, B)
    return p.permute(1, 0, 2), mat.permute(2, 0, 1, 3)


def kinematics_l(m: PhysicsModel, qpos: torch.Tensor) -> LaneKin:
    """Forward kinematics, batch-last (lane_engine.kinematics_l)."""
    B = qpos.shape[-1]
    body_pos, body_quat = m.np64("body_pos"), m.np64("body_quat")
    jnt_pos, jnt_axis, qpos0 = m.np64("jnt_pos"), m.np64("jnt_axis"), m.np64("qpos0")
    one = qpos.new_ones(B)
    zero = qpos.new_zeros(B)

    def c(v):  # host vector -> (n, B) constant
        return torch.stack([float(x) * one for x in v])

    xpos = [torch.stack([zero, zero, zero])]
    xquat = [torch.stack([one, zero, zero, zero])]
    xanchor: list = [None] * m.njnt
    xaxis: list = [None] * m.njnt
    for b in range(1, m.nbody):
        p = m.body_parentid[b]
        pos = xpos[p] + l_quat_rotate(xquat[p], c(body_pos[b]))
        quat = l_quat_mul(xquat[p], c(body_quat[b]))
        for k in range(m.body_jntnum[b]):
            j = m.body_jntadr[b] + k
            jt = m.jnt_type[j]
            qadr = m.jnt_qposadr[j]
            anchor = l_quat_rotate(quat, c(jnt_pos[j])) + pos
            axis = l_quat_rotate(quat, c(jnt_axis[j]))
            if jt == FREE:
                pos = qpos[qadr : qadr + 3]
                quat = l_quat_normalize(qpos[qadr + 3 : qadr + 7])
                anchor = pos
            elif jt == BALL:
                quat = l_quat_mul(quat, l_quat_normalize(qpos[qadr : qadr + 4]))
                pos = anchor - l_quat_rotate(quat, c(jnt_pos[j]))
            elif jt == SLIDE:
                pos = pos + (qpos[qadr] - float(qpos0[qadr])) * axis
            elif jt == HINGE:
                half = 0.5 * (qpos[qadr] - float(qpos0[qadr]))
                s = torch.sin(half)
                ax = jnt_axis[j]
                qloc = torch.stack([torch.cos(half), float(ax[0]) * s, float(ax[1]) * s, float(ax[2]) * s])
                quat = l_quat_mul(quat, qloc)
                pos = anchor - l_quat_rotate(quat, c(jnt_pos[j]))
            xanchor[j] = anchor
            xaxis[j] = l_quat_rotate(quat, c(jnt_axis[j])) if jt in (BALL, HINGE) else axis
        xpos.append(pos)
        xquat.append(quat)

    xpos_s = torch.stack(xpos)
    xquat_s = torch.stack(xquat)
    bodies = range(m.nbody)
    xipos, ximat = _frames(xpos_s, xquat_s, bodies, m.np64("body_ipos"), m.np64("body_iquat"))
    _, xmat = _frames(xpos_s, xquat_s, bodies, np.zeros((m.nbody, 3)), np.tile([1.0, 0, 0, 0], (m.nbody, 1)))
    gxpos, gxmat = _frames(xpos_s, xquat_s, m.geom_bodyid, m.np64("geom_pos"), m.np64("geom_quat"))
    sxpos, sxmat = _frames(xpos_s, xquat_s, m.site_bodyid, m.np64("site_pos"), m.np64("site_quat"))
    return LaneKin(xpos_s, xquat_s, xmat, xipos, ximat, xanchor, xaxis, gxpos, gxmat, sxpos, sxmat)


# ---------------------------------------------------------------------------
# CoM quantities, CRB mass matrix, RNE bias
# ---------------------------------------------------------------------------


class LaneCom(NamedTuple):
    subtree_com: list  # nbody x (3, B)
    root_com: list  # nbody x (3, B)
    cinert: list  # nbody x (6, 6, B)
    cdof: list  # nv x (6, B)


def com_l(m: PhysicsModel, kin: LaneKin) -> LaneCom:
    """mj_comPos semantics (lane_engine.com_l)."""
    B = kin.xpos.shape[-1]
    mass = m.np64("body_mass")
    inertia = m.np64("body_inertia")
    sub_mass = mass.copy()
    acc = [float(mass[b]) * kin.xipos[b] for b in range(m.nbody)]
    for b in range(m.nbody - 1, 0, -1):
        p = m.body_parentid[b]
        sub_mass[p] += sub_mass[b]
        acc[p] = acc[p] + acc[b]
    subtree_com = [acc[b] / max(float(sub_mass[b]), 1e-12) for b in range(m.nbody)]
    root_com = [subtree_com[m.body_rootid[b]] for b in range(m.nbody)]

    eye3 = torch.eye(3, dtype=kin.xpos.dtype, device=kin.xpos.device)[:, :, None]
    cinert = []
    for b in range(m.nbody):
        R = kin.ximat[b]
        iw = sum(float(inertia[b, k]) * R[:, k][:, None, :] * R[:, k][None, :, :] for k in range(3))
        cvec = kin.xipos[b] - root_com[b]
        z = torch.zeros_like(cvec[0])
        cx = torch.stack(
            [
                torch.stack([z, -cvec[2], cvec[1]]),
                torch.stack([cvec[2], z, -cvec[0]]),
                torch.stack([-cvec[1], cvec[0], z]),
            ]
        )
        cxT = cx.transpose(0, 1)
        mb = float(mass[b])
        tl = iw + mb * bsum(cx[:, :, None] * cxT[None], 1)
        top = torch.cat([tl, mb * cx], dim=1)
        bot = torch.cat([mb * cxT, mb * eye3.expand(3, 3, B)], dim=1)
        cinert.append(torch.cat([top, bot], dim=0))

    cdof: list = [None] * m.nv
    zero3 = kin.xpos.new_zeros((3, B))
    for j in range(m.njnt):
        jt = m.jnt_type[j]
        b = m.jnt_bodyid[j]
        d = m.jnt_dofadr[j]
        off = kin.xanchor[j] - root_com[b]
        if jt == HINGE:
            ax = kin.xaxis[j]
            cdof[d] = torch.cat([ax, l_cross(ax, -off)], dim=0)
        elif jt == SLIDE:
            cdof[d] = torch.cat([zero3, kin.xaxis[j]], dim=0)
        elif jt == BALL:
            rot = l_quat_to_mat(kin.xquat[b])
            for i in range(3):
                cdof[d + i] = torch.cat([rot[:, i], l_cross(rot[:, i], -off)], dim=0)
        elif jt == FREE:
            for i in range(3):
                e = zero3.clone()
                e[i] = 1.0
                cdof[d + i] = torch.cat([zero3, e], dim=0)
            rot = l_quat_to_mat(kin.xquat[b])
            for i in range(3):
                cdof[d + 3 + i] = torch.cat([rot[:, i], l_cross(rot[:, i], -off)], dim=0)
    return LaneCom(subtree_com, root_com, cinert, cdof)


def dof_ancestors(m: PhysicsModel) -> list:
    """Static ancestor dof lists (self included)."""
    anc = []
    for i in range(m.nv):
        chain, j = [], i
        while j >= 0:
            chain.append(j)
            j = m.dof_parentid[j]
        anc.append(chain)
    return anc


def _mv6(i66: torch.Tensor, v6: torch.Tensor) -> torch.Tensor:
    return bsum(i66 * v6[None], 1)


def crb_mass_matrix_l(m: PhysicsModel, com: LaneCom) -> torch.Tensor:
    """Dense (nv, nv, B) joint-space mass matrix via CRB."""
    armature = m.np64("dof_armature")
    crb = list(com.cinert)
    for b in range(m.nbody - 1, 0, -1):
        p = m.body_parentid[b]
        crb[p] = crb[p] + crb[b]
    B = com.cdof[0].shape[-1]
    M = com.cdof[0].new_zeros((m.nv, m.nv, B))
    for i, anc in enumerate(dof_ancestors(m)):
        f_i = _mv6(crb[m.dof_bodyid[i]], com.cdof[i])
        for j in anc:
            mij = bsum(f_i * com.cdof[j], 0)
            if i == j:
                mij = mij + float(armature[i])
            M[i, j] = mij
            M[j, i] = mij
    return M


class LaneVel(NamedTuple):
    cvel: list  # nbody x (6, B)
    cdof_dot: list  # nv x (6, B)


def _mcross(v: torch.Tensor, mv: torch.Tensor) -> torch.Tensor:
    ang = l_cross(v[:3], mv[:3])
    lin = l_cross(v[:3], mv[3:]) + l_cross(v[3:], mv[:3])
    return torch.cat([ang, lin], dim=0)


def velocity_l(m: PhysicsModel, com: LaneCom, qvel: torch.Tensor) -> LaneVel:
    """mj_comVel semantics by forward tree recursion."""
    zero6 = qvel.new_zeros((6, qvel.shape[-1]))
    cvel: list = [zero6] * m.nbody
    cdof_dot: list = [zero6] * m.nv
    for b in range(1, m.nbody):
        v = cvel[m.body_parentid[b]]
        for k in range(m.body_jntnum[b]):
            j = m.body_jntadr[b] + k
            jt = m.jnt_type[j]
            d = m.jnt_dofadr[j]
            if jt in (HINGE, SLIDE):
                cdof_dot[d] = _mcross(v, com.cdof[d])
                v = v + com.cdof[d] * qvel[d][None]
            elif jt == BALL:
                for i in range(3):
                    cdof_dot[d + i] = _mcross(v, com.cdof[d + i])
                for i in range(3):
                    v = v + com.cdof[d + i] * qvel[d + i][None]
            elif jt == FREE:
                for i in range(3):
                    v = v + com.cdof[d + i] * qvel[d + i][None]
                for i in range(3):
                    cdof_dot[d + 3 + i] = _mcross(v, com.cdof[d + 3 + i])
                for i in range(3):
                    v = v + com.cdof[d + 3 + i] * qvel[d + 3 + i][None]
        cvel[b] = v
    return LaneVel(cvel, cdof_dot)


_NDOF = {FREE: 6, BALL: 3, SLIDE: 1, HINGE: 1}


def rne_bias_l(m: PhysicsModel, com: LaneCom, vel: LaneVel, qvel: torch.Tensor) -> torch.Tensor:
    """Bias force C(q, v) (mj_rne with flg_acc=0) -> (nv, B)."""
    grav = m.np64("gravity") * (1.0 if m.gravity_enabled else 0.0)
    base = _col(np.concatenate([np.zeros(3), -grav]), qvel).expand(6, qvel.shape[-1])

    def mcross_force(v, f):
        ang = l_cross(v[:3], f[:3]) + l_cross(v[3:], f[3:])
        return torch.cat([ang, l_cross(v[:3], f[3:])], dim=0)

    cacc: list = [base] * m.nbody
    for b in range(1, m.nbody):
        a = cacc[m.body_parentid[b]]
        for k in range(m.body_jntnum[b]):
            j = m.body_jntadr[b] + k
            d = m.jnt_dofadr[j]
            for i in range(_NDOF[m.jnt_type[j]]):
                a = a + vel.cdof_dot[d + i] * qvel[d + i][None]
        cacc[b] = a
    cfrc = [
        _mv6(com.cinert[b], cacc[b]) + mcross_force(vel.cvel[b], _mv6(com.cinert[b], vel.cvel[b]))
        for b in range(m.nbody)
    ]
    for b in range(m.nbody - 1, 0, -1):
        p = m.body_parentid[b]
        cfrc[p] = cfrc[p] + cfrc[b]
    return torch.stack([bsum(com.cdof[i] * cfrc[m.dof_bodyid[i]], 0) for i in range(m.nv)])


# ---------------------------------------------------------------------------
# passive and actuation forces
# ---------------------------------------------------------------------------


def passive_force_l(m: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """Joint springs + dof dampers -> (nv, B) (lane_engine.py:700-732 of the
    JAX package). A ball joint's spring, and a free joint's on its rotation,
    turns by 2 Im(conj(qpos_spring) * q)."""
    qfrc = -_col(m.np64("dof_damping"), qvel) * qvel
    stiff = m.np64("jnt_stiffness")
    qspring = m.np64("qpos_spring")
    for j in range(m.njnt):
        k = float(stiff[j])
        if k == 0.0:
            continue
        jt, qadr, dadr = m.jnt_type[j], m.jnt_qposadr[j], m.jnt_dofadr[j]
        if jt in (SLIDE, HINGE):
            qfrc[dadr] = qfrc[dadr] - k * (qpos[qadr] - float(qspring[qadr]))
            continue
        if jt == FREE:
            for i in range(3):
                qfrc[dadr + i] = qfrc[dadr + i] - k * (qpos[qadr + i] - float(qspring[qadr + i]))
            qadr, dadr = qadr + 3, dadr + 3
        qs = [float(x) for x in qspring[qadr : qadr + 4] * np.array([1.0, -1.0, -1.0, -1.0])]
        dq = l_quat_mul(qs, qpos[qadr : qadr + 4])
        for i in range(3):
            qfrc[dadr + i] = qfrc[dadr + i] - k * 2.0 * dq[1 + i]
    return qfrc


def actuation_l(m: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """Actuator joint-space force -> (nv, B) (fixed gain + affine bias)."""
    out = qvel.new_zeros(qvel.shape)
    if m.nu == 0:
        return out
    gear = m.np64("actuator_gear")[:, 0]
    gain = m.np64("actuator_gainprm")[:, 0]
    bias = m.np64("actuator_biasprm")[:, :3]
    crange = m.np64("actuator_ctrlrange")
    frange = m.np64("actuator_forcerange")
    for u in range(m.nu):
        j = m.actuator_trnid[u]
        qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
        c = ctrl[u]
        if m.actuator_ctrllimited[u]:
            c = torch.clamp(c, float(crange[u, 0]), float(crange[u, 1]))
        g = float(gear[u])
        force = (
            float(gain[u]) * c + float(bias[u, 0]) + float(bias[u, 1]) * (qpos[qadr] * g)
            + float(bias[u, 2]) * (qvel[dadr] * g)
        )
        if m.actuator_forcelimited[u]:
            force = torch.clamp(force, float(frange[u, 0]), float(frange[u, 1]))
        out[dadr] = out[dadr] + g * force
    afr = m.np64("jnt_actfrcrange")
    for j in range(m.njnt):
        if m.jnt_actfrclimited[j]:  # every dof of the joint (ball: 3, free: 6)
            for d in range(m.jnt_dofadr[j], m.jnt_dofadr[j] + _NDOF[m.jnt_type[j]]):
                out[d] = torch.clamp(out[d], float(afr[j, 0]), float(afr[j, 1]))
    return out


# ---------------------------------------------------------------------------
# exact SPD inverses over dof islands
# ---------------------------------------------------------------------------


def dof_islands(m: PhysicsModel) -> list:
    """Contiguous [start, end) dof ranges of independent kinematic subtrees."""
    comp = [0] * m.nv
    n_comp = 0
    for i in range(m.nv):
        p = m.dof_parentid[i]
        if p < 0:
            comp[i] = n_comp
            n_comp += 1
        else:
            comp[i] = comp[p]
    ranges: list = []
    start = 0
    for i in range(1, m.nv + 1):
        if i == m.nv or comp[i] != comp[start]:
            ranges.append((start, i))
            start = i
    if len({comp[s] for s, _ in ranges}) != len(ranges):
        return [(0, m.nv)]
    return ranges


def spd_inverse_l(a: torch.Tensor) -> torch.Tensor:
    """Explicit SPD inverse of (n, n, B) by Gauss-Jordan without pivoting."""
    n = a.shape[0]
    a = a.clone()
    x = torch.eye(n, dtype=a.dtype, device=a.device)[:, :, None].expand_as(a).clone()
    notj = torch.ones(n, 1, dtype=a.dtype, device=a.device)
    for j in range(n):
        d = a[j, j]
        nj = notj.clone()
        nj[j] = 0.0
        f = a[:, j, :] * nj / d[None, :]
        a = a - f[:, None, :] * a[j : j + 1]
        x = x - f[:, None, :] * x[j : j + 1]
    diag = torch.stack([a[j, j] for j in range(n)])
    x = x / diag[:, None, :]
    return 0.5 * (x + x.transpose(0, 1))


def spd_inverse_blocks(m: PhysicsModel, a: torch.Tensor) -> list:
    """Blockwise inverse over dof_islands: [(start, (k, k, B))]."""
    return [(s, spd_inverse_l(a[s:e, s:e])) for s, e in dof_islands(m)]


def mat_vec_l(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(n, n, B) @ (n, B) -> (n, B)."""
    return bsum(a * v[None], 1)


def bd_mat_vec(blocks: list, v: torch.Tensor) -> torch.Tensor:
    """Block-diagonal matrix-vector product."""
    return torch.cat([mat_vec_l(blk, v[s : s + blk.shape[0]]) for s, blk in blocks], dim=0)


def bd_abs(blocks: list) -> list:
    return [(s, torch.abs(blk)) for s, blk in blocks]
