"""Constraint assembly, the APGD dual solve, sensors and integration of the
lanes step in plain PyTorch (counterpart of ``judo_tpu/physics/lane_step.py``).

``step_l`` advances a batch of rollouts one physics step, batch-last. Row
order matches the JAX package: joint equalities (a +/- row pair each), joint
limits, then the contact rows. Elliptic cones give the contact rows grouped as
[normals | t1 | t2]; pyramidal cones give four facet rows per contact,
contact-major [n+mu t1, n-mu t1, n+mu t2, n-mu t2].
Only the Collatz-Wielandt ("cw") Lipschitz bound is ported; contractions over
constraint rows are plain sums.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from judo_tpu_torch.physics import lane_engine as le
from judo_tpu_torch.physics.lane_collision import _L_KERNELS, LaneContacts, find_contacts_l, tangent_frame_l
from judo_tpu_torch.physics.model import (
    BALL,
    FREE,
    HINGE,
    INT_IMPLICITFAST,
    OBJ_BODY,
    OBJ_SITE,
    OBJ_XBODY,
    SENSOR_DISTANCE,
    SENSOR_FRAMEPOS,
    SENSOR_FRAMEQUAT,
    SENSOR_FRAMEXAXIS,
    SENSOR_FRAMEYAXIS,
    SENSOR_FRAMEZAXIS,
    SENSOR_JOINTPOS,
    SENSOR_JOINTVEL,
    SLIDE,
    PhysicsModel,
    distance_sensor_pairs,
    joint_equalities,
    lane_supported,
    limit_joints,
    num_constraint_rows,
    num_contact_slots,
    num_noncontact_rows,
)

_MINVAL = 1e-15
_MINIMP, _MAXIMP = 1e-4, 0.9999


def impedance_np(solimp: np.ndarray):
    """Host constants of MuJoCo's impedance curve d(r) for one solimp row."""
    dmin, dmax, width, mid, power = (float(v) for v in solimp)
    return dmin, dmax, max(width, _MINVAL), min(max(mid, _MINIMP), _MAXIMP), max(power, 1.0)


def impedance_l(solimp: np.ndarray, pos: torch.Tensor) -> torch.Tensor:
    """Constraint impedance d(r) with host-constant solimp."""
    dmin, dmax, width, mid, power = impedance_np(solimp)
    x = torch.clamp(torch.abs(pos) / width, 0.0, 1.0)
    if power == 1.0:
        y = x
    else:
        lo = (mid ** (1.0 - power)) * x**power
        hi = 1.0 - ((1.0 - mid) ** (1.0 - power)) * (1.0 - x) ** power
        y = torch.where(x <= mid, lo, hi)
    return torch.clamp(dmin + y * (dmax - dmin), _MINIMP, _MAXIMP)


def kb_from_solref_np(solref: np.ndarray, solimp: np.ndarray, timestep: float) -> tuple:
    """Host-side stiffness and damping from solref."""
    dmax = min(max(float(solimp[1]), _MINIMP), _MAXIMP)
    timeconst = max(float(solref[0]), 2.0 * timestep)
    dampratio = float(solref[1])
    if solref[0] > 0:
        k = 1.0 / max(dmax * dmax * timeconst * timeconst * dampratio * dampratio, _MINVAL)
        b = 2.0 / max(dmax * timeconst, _MINVAL)
    else:
        k, b = -float(solref[0]), -float(solref[1])
    return k, b


def joint_equality_terms(m: PhysicsModel, e: int, qpos: torch.Tensor) -> tuple:
    """(dof of joint 1, violation, slope or None, invweight) of joint
    equality ``e``: q1 - q1_0 = poly(q2 - q2_0), a quartic in the second
    joint's displacement (a constant without a second joint)."""
    qpos0, inv = m.np64("qpos0"), m.np64("dof_invweight0")
    c = [float(v) for v in m.np64("eq_data")[e]]
    j1, j2 = m.eq_obj1id[e], m.eq_obj2id[e]
    q1, d1 = m.jnt_qposadr[j1], m.jnt_dofadr[j1]
    if j2 < 0:
        return d1, (qpos[q1] - float(qpos0[q1])) - c[0], None, float(inv[d1])
    q2, d2 = m.jnt_qposadr[j2], m.jnt_dofadr[j2]
    dq2 = qpos[q2] - float(qpos0[q2])
    poly = c[0] + dq2 * (c[1] + dq2 * (c[2] + dq2 * (c[3] + dq2 * c[4])))
    dpoly = c[1] + dq2 * (2 * c[2] + dq2 * (3 * c[3] + dq2 * 4 * c[4]))
    return d1, (qpos[q1] - float(qpos0[q1])) - poly, dpoly, float(inv[d1] + inv[d2])


class LaneRows(NamedTuple):
    J: torch.Tensor  # (nefc, nv, B)
    aref: torch.Tensor  # (nefc, B)
    reg: torch.Tensor  # (nefc, B)
    active: torch.Tensor  # (nefc, B)
    diag: torch.Tensor  # (nefc, B)


def assemble_constraints_l(
    m: PhysicsModel, com: le.LaneCom, contacts: LaneContacts | None, qpos: torch.Tensor, qvel: torch.Tensor
) -> LaneRows | None:
    """Joint-equality, joint-limit and contact rows (elliptic or pyramidal), batch-last."""
    B = qvel.shape[-1]
    dev, dtype = qvel.device, qvel.dtype
    ts = float(m.np64("timestep"))
    inv_dof = m.np64("dof_invweight0")
    jnt_range, jnt_margin = m.np64("jnt_range"), m.np64("jnt_margin")
    jnt_solref, jnt_solimp = m.np64("jnt_solref"), m.np64("jnt_solimp")
    ones = qvel.new_ones(B)
    rows_J, rows_aref, rows_reg, rows_active, rows_diag = [], [], [], [], []

    for e in joint_equalities(m):
        d1, pos, dpoly, inv_w = joint_equality_terms(m, e, qpos)
        row = qvel.new_zeros((m.nv, B))
        row[d1] = 1.0
        vel = qvel[d1]
        if dpoly is not None:
            d2 = m.jnt_dofadr[m.eq_obj2id[e]]
            row[d2] = -dpoly
            vel = vel - dpoly * qvel[d2]
        solimp = m.np64("eq_solimp")[e]
        imp = impedance_l(solimp, pos)
        k, b = kb_from_solref_np(m.np64("eq_solref")[e], solimp, ts)
        reg = (1.0 - imp) / torch.clamp(imp, min=_MINIMP) * inv_w
        for sgn in (1.0, -1.0):
            rows_J.append(sgn * row)
            rows_aref.append(sgn * (-b * vel - k * imp * pos))
            rows_reg.append(reg)
            rows_active.append(ones)
            rows_diag.append(inv_w * ones)

    for j in limit_joints(m):
        qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
        k, b = kb_from_solref_np(jnt_solref[j], jnt_solimp[j], ts)
        for sgn in (1.0, -1.0):
            q = qpos[qadr]
            dist = (q - float(jnt_range[j, 0])) if sgn > 0 else (float(jnt_range[j, 1]) - q)
            pos = dist - float(jnt_margin[j])
            imp = impedance_l(jnt_solimp[j], pos)
            row = qvel.new_zeros((m.nv, B))
            row[dadr] = sgn
            rows_J.append(row)
            rows_aref.append(-b * (sgn * qvel[dadr]) - k * imp * pos)
            rows_reg.append((1.0 - imp) / torch.clamp(imp, min=_MINIMP) * float(inv_dof[dadr]))
            rows_active.append((dist < float(jnt_margin[j])).to(dtype))
            rows_diag.append(float(inv_dof[dadr]) * ones)

    parts = None
    if rows_J:
        parts = [torch.stack(r) for r in (rows_J, rows_aref, rows_reg, rows_active, rows_diag)]

    if contacts is not None and contacts.ncon:
        C = contacts.ncon
        cdof = torch.stack(com.cdof)  # (nv, 6, B)
        ANG, LIN = cdof[:, :3], cdof[:, 3:]  # (nv, 3, B)
        rc1 = torch.stack([com.root_com[b] for b in contacts.body1])
        rc2 = torch.stack([com.root_com[b] for b in contacts.body2])
        arm1 = contacts.pos - rc1  # (C, 3, B)
        arm2 = contacts.pos - rc2
        n = contacts.normal
        t1, t2 = tangent_frame_l(n)
        bdm = m.np64("body_dof_mask")
        m1c = torch.as_tensor(bdm[list(contacts.body1)], dtype=dtype, device=dev)[:, :, None]  # (C, nv, 1)
        m2c = torch.as_tensor(bdm[list(contacts.body2)], dtype=dtype, device=dev)[:, :, None]

        def rows_for(d: torch.Tensor) -> torch.Tensor:
            """J rows along direction d (C, 3, B) -> (C, nv, B)."""
            w1 = le.l_cross(arm1, d)
            w2 = le.l_cross(arm2, d)
            lin_d = torch.sum(LIN[None] * d[:, None], dim=2)
            ang1 = torch.sum(ANG[None] * w1[:, None], dim=2)
            ang2 = torch.sum(ANG[None] * w2[:, None], dim=2)
            return m2c * (lin_d + ang2) - m1c * (lin_d + ang1)

        row_n, row_t1, row_t2 = rows_for(n), rows_for(t1), rows_for(t2)

        def col(v):
            return torch.as_tensor(np.asarray(v, np.float64)[:, None], dtype=dtype, device=dev)

        margin_c = col(contacts.includemargin)
        pos = contacts.dist - margin_c
        imp = torch.stack([impedance_l(contacts.solimp[i], pos[i]) for i in range(C)])
        kb = np.asarray([kb_from_solref_np(contacts.solref[i], contacts.solimp[i], ts) for i in range(C)])
        k_c, b_c = col(kb[:, 0]), col(kb[:, 1])
        bi = m.np64("body_invweight0")
        inv_w = np.maximum(np.asarray([bi[b1, 0] + bi[b2, 0] for b1, b2 in zip(contacts.body1, contacts.body2)]), _MINVAL)
        active = (contacts.dist < margin_c).to(dtype)

        def vel(row):
            return le.bsum(row * qvel[None], 1)

        if m.cone_pyramidal:
            mu = col(contacts.friction)[:, :, None]
            diag_np = np.maximum(2.0 * inv_w * contacts.friction**2 * (1.0 + contacts.friction**2), _MINVAL)
            reg = (1.0 - imp) / torch.clamp(imp, min=_MINIMP) * col(diag_np)
            facets = torch.stack([row_n + mu * row_t1, row_n - mu * row_t1, row_n + mu * row_t2, row_n - mu * row_t2], 1)
            J_c = facets.reshape(4 * C, m.nv, B)

            def rep4(a):
                return torch.repeat_interleave(a, 4, dim=0)

            c_parts = [
                J_c,
                -rep4(b_c * torch.ones_like(pos)) * vel(J_c) - rep4(k_c * imp * pos),
                rep4(reg),
                rep4(active),
                rep4(col(diag_np) * torch.ones_like(active)),
            ]
        else:
            reg_n = (1.0 - imp) / torch.clamp(imp, min=_MINIMP) * col(inv_w)
            reg_t = reg_n / float(m.np64("impratio"))
            c_parts = [
                torch.cat([row_n, row_t1, row_t2], dim=0),
                torch.cat([-b_c * vel(row_n) - k_c * imp * pos, -b_c * vel(row_t1), -b_c * vel(row_t2)], dim=0),
                torch.cat([reg_n, reg_t, reg_t], dim=0),
                torch.cat([active, active, active], dim=0),
                col(np.tile(inv_w, 3)).expand(3 * C, B),
            ]
        parts = c_parts if parts is None else [torch.cat([a, c], dim=0) for a, c in zip(parts, c_parts)]
    if parts is None:
        return None
    return LaneRows(*parts)


def jt_vec(J: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """J^T f: (nefc, nv, B), (nefc, B) -> (nv, B)."""
    return le.bsum(J * f[:, None], 0)


def j_vec(J: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """J v: (nefc, nv, B), (nv, B) -> (nefc, B)."""
    return le.bsum(J * v[None], 1)


def solve_dual_qp_l(
    J: torch.Tensor,
    minv: list,
    reg: torch.Tensor,
    b: torch.Tensor,
    iterations: int,
    f_warm: torch.Tensor | None,
    ncon_start: int = 0,
    mus: list | None = None,
    diag: torch.Tensor | None = None,
    cw_v: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """min_{f in K} 0.5 f^T (J M^-1 J^T + diag(reg)) f + f^T b by APGD.

    ``minv`` is the dof-island block inverse of M. K is the nonnegative
    orthant, times one second-order cone per contact when ``mus`` (the
    per-contact friction) is given. Returns (f, cw_v_out), cw_v_out being the
    Collatz-Wielandt probe to carry into the next step.
    """
    inv_s = torch.rsqrt(torch.clamp(diag + reg, min=_MINVAL)) if diag is not None else torch.ones_like(reg)
    J = J * inv_s[:, None]
    reg = reg * inv_s * inv_s
    b = b * inv_s
    a_blocks = le.bd_abs(minv)

    if mus:
        nc = len(mus)
        s_n = inv_s[ncon_start : ncon_start + nc]
        s_t = inv_s[ncon_start + nc : ncon_start + 2 * nc]
        mu = torch.as_tensor(np.asarray(mus, np.float64)[:, None], dtype=b.dtype, device=b.device)
        mu_c = mu * s_n / torch.clamp(s_t, min=_MINVAL)

        def project(z):
            zn = torch.clamp(z[:ncon_start], min=0.0)
            n = z[ncon_start : ncon_start + nc]
            t1 = z[ncon_start + nc : ncon_start + 2 * nc]
            t2 = z[ncon_start + 2 * nc :]
            s = torch.sqrt(t1 * t1 + t2 * t2)
            inside = s <= mu_c * n
            polar = mu_c * s <= -n
            a = (mu_c * s + n) / (1.0 + mu_c * mu_c)
            coef = mu_c * a / torch.clamp(s, min=_MINVAL)
            zero = torch.zeros_like(n)
            n_out = torch.where(inside, n, torch.where(polar, zero, a))
            t_scale = torch.where(inside, torch.ones_like(n), torch.where(polar, zero, coef))
            return torch.cat([zn, n_out, t1 * t_scale, t2 * t_scale], dim=0)
    else:

        def project(z):
            return torch.clamp(z, min=0.0)

    def apply_A(f):
        return j_vec(J, le.bd_mat_vec(minv, jt_vec(J, f))) + reg * f

    aJ = torch.abs(J)

    def apply_B(v):
        return j_vec(aJ, le.bd_mat_vec(a_blocks, jt_vec(aJ, v))) + reg * v

    def unit(x):
        return x * torch.rsqrt(torch.clamp(le.bsum(x * x, 0), min=_MINVAL))[None]

    if cw_v is None:
        v = torch.ones_like(b)
        for _ in range(3):
            v = unit(apply_B(v))
    else:
        v = torch.clamp(unit(cw_v), min=1e-7)
    bv = apply_B(v)
    L = torch.amax(bv / torch.clamp(v, min=1e-12), dim=0)
    cw_v_out = unit(bv)
    step = 1.0 / torch.clamp(L, min=_MINVAL)

    f = torch.zeros_like(b) if f_warm is None else project(f_warm / torch.clamp(inv_s, min=_MINVAL))
    y = f
    t = torch.ones_like(b[0])
    for _ in range(iterations):
        grad = apply_A(y) + b
        f_new = project(y - step[None] * grad)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y_new = f_new + ((t - 1.0) / t_new)[None] * (f_new - f)
        restart = le.bsum(grad * (f_new - f), 0) > 0
        y = torch.where(restart[None], f_new, y_new)
        t = torch.where(restart, torch.ones_like(t_new), t_new)
        f = f_new
    return f * inv_s, cw_v_out


def implicit_damping_np(m: PhysicsModel) -> np.ndarray:
    """Per-dof implicit damping diagonal."""
    damp = m.np64("dof_damping").copy()
    if m.integrator == INT_IMPLICITFAST and m.nu:
        gear = m.np64("actuator_gear")[:, 0]
        bias = m.np64("actuator_biasprm")
        for u in range(m.nu):
            damp[m.jnt_dofadr[m.actuator_trnid[u]]] += -bias[u, 2] * gear[u] * gear[u]
    return damp


def integrate_pos_l(m: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor, h: float) -> torch.Tensor:
    """mj_integratePos, batch-last."""
    out = qpos.clone()
    for j in range(m.njnt):
        jt = m.jnt_type[j]
        qadr, dadr = m.jnt_qposadr[j], m.jnt_dofadr[j]
        if jt in (SLIDE, HINGE):
            out[qadr] = qpos[qadr] + h * qvel[dadr]
        elif jt == BALL:
            out[qadr : qadr + 4] = le.l_quat_integrate(qpos[qadr : qadr + 4], qvel[dadr : dadr + 3], h)
        elif jt == FREE:
            out[qadr : qadr + 3] = qpos[qadr : qadr + 3] + h * qvel[dadr : dadr + 3]
            out[qadr + 3 : qadr + 7] = le.l_quat_integrate(qpos[qadr + 3 : qadr + 7], qvel[dadr + 3 : dadr + 6], h)
    return out


def distance_sensor_l(m: PhysicsModel, kin: le.LaneKin, i: int) -> torch.Tensor:
    """Distance sensor ``i`` (mjSENS_GEOMDIST between two bodies): the least of
    its cutoff and every slot distance of its geom pairs, (B,)."""
    size = m.np64("geom_size")
    out = kin.geom_xpos[0].new_full(kin.geom_xpos.shape[-1:], float(m.np64("sensor_cutoff")[i]))
    for a, b in distance_sensor_pairs(m, i):
        s1, s2 = (torch.as_tensor(size[g][None], dtype=out.dtype, device=out.device) for g in (a, b))
        kernel = _L_KERNELS[(m.geom_type[a], m.geom_type[b])]
        for d, _, _ in kernel(kin.geom_xpos[a][None], kin.geom_xmat[a][None], s1, kin.geom_xpos[b][None],
                              kin.geom_xmat[b][None], s2):
            out = torch.minimum(out, d[0])
    return out


def evaluate_sensors_l(m: PhysicsModel, kin: le.LaneKin, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """Flat (nsensordata, B) sensordata; uncovered sensor types read zero."""
    out = qpos.new_zeros((m.nsensordata, qpos.shape[-1]))
    site_quat, body_iquat = m.np64("site_quat"), m.np64("body_iquat")

    def q4(v):
        return torch.as_tensor(np.asarray(v, np.float64)[:, None], dtype=qpos.dtype, device=qpos.device)

    for i in range(m.nsensor):
        st, ot, oid = m.sensor_type[i], m.sensor_objtype[i], m.sensor_objid[i]
        adr, dim = m.sensor_adr[i], m.sensor_dim[i]
        val = None
        if st == SENSOR_JOINTPOS:
            val = qpos[m.jnt_qposadr[oid]][None]
        elif st == SENSOR_JOINTVEL:
            val = qvel[m.jnt_dofadr[oid]][None]
        elif st == SENSOR_FRAMEPOS:
            if ot == OBJ_SITE:
                val = kin.site_xpos[oid]
            elif ot == OBJ_BODY:
                val = kin.xipos[oid]
            elif ot == OBJ_XBODY:
                val = kin.xpos[oid]
            refid = m.sensor_refid[i]
            if val is not None and refid >= 0 and m.sensor_reftype[i] == OBJ_SITE:
                val = torch.sum(kin.site_xmat[refid] * (val - kin.site_xpos[refid])[:, None], dim=0)
        elif st == SENSOR_DISTANCE and ot == OBJ_BODY:
            val = distance_sensor_l(m, kin, i)[None]
        elif st in (SENSOR_FRAMEXAXIS, SENSOR_FRAMEYAXIS, SENSOR_FRAMEZAXIS):
            c = st - SENSOR_FRAMEXAXIS
            if ot == OBJ_SITE:
                val = kin.site_xmat[oid][:, c]
            elif ot in (OBJ_BODY, OBJ_XBODY):
                val = kin.xmat[oid][:, c]
        elif st == SENSOR_FRAMEQUAT:
            if ot == OBJ_SITE:
                b = m.site_bodyid[oid]
                val = le.l_quat_mul(kin.xquat[b], q4(site_quat[oid]).expand(4, qpos.shape[-1]))
            elif ot == OBJ_BODY:
                val = le.l_quat_mul(kin.xquat[oid], q4(body_iquat[oid]).expand(4, qpos.shape[-1]))
            elif ot == OBJ_XBODY:
                val = kin.xquat[oid]
        if val is not None:
            out[adr : adr + dim] = val
    return out


class LaneStepOut(NamedTuple):
    qpos: torch.Tensor  # (nq, B)
    qvel: torch.Tensor  # (nv, B)
    sensordata: torch.Tensor  # (nsensordata, B)
    efc_force: torch.Tensor  # (nefc, B)
    cw_v: torch.Tensor  # (nefc, B)


def step_l(
    m: PhysicsModel,
    qpos: torch.Tensor,
    qvel: torch.Tensor,
    ctrl: torch.Tensor,
    f_warm: torch.Tensor | None = None,
    solver_iterations: int | None = None,
    cw_v: torch.Tensor | None = None,
) -> LaneStepOut:
    """One mj_step, batch-last (lane_step.step_l with the "cw" bound)."""
    lane_supported(m)
    h = float(m.np64("timestep"))
    kin = le.kinematics_l(m, qpos)
    com = le.com_l(m, kin)
    vel = le.velocity_l(m, com, qvel)
    mm = le.crb_mass_matrix_l(m, com)
    qfrc_bias = le.rne_bias_l(m, com, vel, qvel)
    qfrc_smooth = le.actuation_l(m, qpos, qvel, ctrl) + le.passive_force_l(m, qpos, qvel) - qfrc_bias
    minv = le.spd_inverse_blocks(m, mm)
    qacc_smooth = le.bd_mat_vec(minv, qfrc_smooth)
    sens = evaluate_sensors_l(m, kin, qpos, qvel)

    nefc = num_constraint_rows(m)
    if nefc > 0:
        has_contacts = m.contact_enabled and num_contact_slots(m) > 0
        contacts = find_contacts_l(m, kin) if has_contacts else None
        rows = assemble_constraints_l(m, com, contacts, qpos, qvel)
        J = rows.J * rows.active[:, None]
        aref = rows.aref * rows.active
        reg = torch.where(rows.active > 0, rows.reg, torch.ones_like(rows.reg))
        b = j_vec(J, qacc_smooth) - aref
        iters = max(m.solver_iterations if solver_iterations is None else solver_iterations, 8)
        mus = [float(v) for v in contacts.friction] if contacts is not None and not m.cone_pyramidal else None
        diag = torch.where(rows.active > 0, rows.diag, torch.ones_like(rows.diag))
        f, cw_v_out = solve_dual_qp_l(
            J, minv, reg, b, iters, f_warm, ncon_start=num_noncontact_rows(m), mus=mus, diag=diag, cw_v=cw_v
        )
        qacc = qacc_smooth + le.bd_mat_vec(minv, jt_vec(J, f))
    else:
        f = qpos.new_zeros((0, qpos.shape[-1]))
        cw_v_out = f
        qacc = qacc_smooth

    damp = torch.as_tensor(implicit_damping_np(m), dtype=qpos.dtype, device=qpos.device)
    mh = mm + h * torch.diag_embed(damp.expand(qpos.shape[-1], m.nv)).permute(1, 2, 0)
    dv = le.bd_mat_vec(le.spd_inverse_blocks(m, mh), h * le.mat_vec_l(mm, qacc))
    qvel_new = qvel + dv
    qpos_new = integrate_pos_l(m, qpos, qvel_new, h)
    return LaneStepOut(qpos_new, qvel_new, sens, f, cw_v_out)
