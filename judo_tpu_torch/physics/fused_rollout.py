"""The fused T-step rollout and the single step (counterpart of
``judo_tpu/physics/pallas_step.py``).

``fused_rollout`` is the wrapper of the hand-written CUDA kernel
(``csrc/fused_rollout.cu``, the port of the Pallas kernel
``pallas_step.py::_build_fused_rollout``). For CUDA tensors it launches the
kernel or raises; for CPU tensors it runs ``rollout_lanes_reference``, the
plain PyTorch version: ``step_l`` in a Python loop over T with the same carry
semantics. ``rollout_lanes`` is the public entry with the JAX package's
batch-first layout. ``physics_step`` wraps the single-step kernel (the port of
``pallas_step.py::_build_pallas_step``): one step with a cold probe, whose
plain version is ``step_l(..., cw_v=None)``.

The kernels run one block per rollout with the rollout's scratch
(``jt_scratch_per_lane`` elements) in dynamic shared memory. A block is one
warp, or for the rollout kernel W warps where the rollouts are too few to
give each SM's four schedulers a warp (``rollout_warps``: W from the batch,
the model's constraint rows and the card's SM count, never a setting). Before a launch
the wrapper picks the scratch layout from the sizes: all of it in shared
memory where that fits the card's per-block opt-in limit, else the layout
that keeps each rollout's constraint Jacobian J in a slab of global memory
(``jt_jslab_per_lane`` elements per rollout) and the rest in shared memory.
Where even that does not fit it raises a ``RuntimeError`` naming the bytes
and the limit. Inputs and outputs are batch-last, ``(T, n, B)``.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from judo_tpu_torch.physics.lane_collision import pair_groups, pair_params_np
from judo_tpu_torch.physics.lane_engine import dof_islands
from judo_tpu_torch.physics.lane_step import implicit_damping_np, kb_from_solref_np, step_l
from judo_tpu_torch.physics.model import (
    BALL,
    FREE,
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_PLANE,
    GEOM_SPHERE,
    OBJ_BODY,
    SENSOR_DISTANCE,
    SLOTS_PER_PAIR,
    PhysicsModel,
    contact_rows_per,
    distance_sensor_pairs,
    joint_equalities,
    lane_supported,
    limit_joints,
    num_constraint_rows,
)

# Pair kind codes of csrc/jt_common.cuh.
PAIR_KINDS = {
    (GEOM_BOX, GEOM_BOX): 0,
    (GEOM_CAPSULE, GEOM_BOX): 1,
    (GEOM_PLANE, GEOM_SPHERE): 2,
    (GEOM_PLANE, GEOM_CAPSULE): 3,
    (GEOM_PLANE, GEOM_BOX): 4,
    (GEOM_CAPSULE, GEOM_CAPSULE): 5,
    (GEOM_CYLINDER, GEOM_CYLINDER): 6,
    (GEOM_CYLINDER, GEOM_BOX): 7,
    (GEOM_SPHERE, GEOM_BOX): 8,
    (GEOM_PLANE, GEOM_CYLINDER): 9,
    (GEOM_SPHERE, GEOM_CYLINDER): 10,
    (GEOM_CAPSULE, GEOM_CYLINDER): 11,
    (GEOM_SPHERE, GEOM_SPHERE): 12,
    (GEOM_SPHERE, GEOM_CAPSULE): 13,
}
# Scratch layouts (csrc/jt_common.cuh:make_scratch): the whole scratch in
# shared memory, or J in a slab of global memory and the rest in shared memory.
SHARED, GLOBAL_J = "shared", "global_j"
# Kinds of the rows before the contact block (csrc/jt_common.cuh).
ROW_LIMIT, ROW_EQUALITY = 0, 1


class JtSizes(ctypes.Structure):
    """Mirror of ``JtSizes`` in csrc/jt_common.cuh."""

    _fields_ = [
        (name, ctypes.c_int)
        for name in (
            "B", "T", "substeps", "iterations", "pyramidal", "cold", "nq", "nv", "nu", "nbody", "njnt", "ngeom", "nsite",
            "nsensor", "nsensordata", "nnc", "npair", "ncon", "nefc", "nisl", "ndist", "ndpair", "nu_", "ns_",
            "nefc_", "jglobal",
        )
    ]


class LaneRolloutOutput(NamedTuple):
    states: torch.Tensor  # (R, T, nq + nv)
    sensordata: torch.Tensor  # (R, T, nsensordata)
    efc0: torch.Tensor  # (R, max(nefc, 1)) step-0 constraint forces


def solver_iters(m: PhysicsModel, iterations: int | None) -> int:
    """APGD iterations of a step (lane_step.py:828)."""
    return max(m.solver_iterations if iterations is None else iterations, 8)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def rollout_lanes_reference(
    m: PhysicsModel,
    qpos: torch.Tensor,  # (nq, B)
    qvel: torch.Tensor,  # (nv, B)
    ctrl: torch.Tensor,  # (T, nu_, B)
    f0: torch.Tensor,  # (nefc_, B)
    substeps: int = 1,
    iterations: int | None = None,
):
    """The plain version of the kernel: -> ((T, nq, B), (T, nv, B), (T, ns_, B), (nefc_, B))."""
    nefc = num_constraint_rows(m)
    T, B = ctrl.shape[0], qpos.shape[-1]
    f = f0[:nefc] if nefc else None
    v = torch.ones_like(f0[:nefc]) if nefc else None
    qps, qvs, senss = [], [], []
    efc0 = torch.zeros_like(f0)
    for t in range(T):
        sens = None
        for _ in range(substeps):
            out = step_l(m, qpos, qvel, ctrl[t, : m.nu], f, iterations, cw_v=v)
            qpos, qvel, sens = out.qpos, out.qvel, out.sensordata
            if nefc:
                f, v = out.efc_force, out.cw_v
        qps.append(qpos)
        qvs.append(qvel)
        senss.append(sens if m.nsensordata else qpos.new_zeros((1, B)))
        if t == 0 and nefc:
            efc0 = f
    return torch.stack(qps), torch.stack(qvs), torch.stack(senss), efc0


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def _spring7(m: PhysicsModel, qpos_spring: np.ndarray, j: int) -> list:
    """Joint j's qpos_spring entries, zero-padded to 7 (the joint record's spring7)."""
    nq = {FREE: 7, BALL: 4}.get(int(m.jnt_type[j]), 1)
    adr = m.jnt_qposadr[j]
    return [*qpos_spring[adr : adr + nq], *([0.0] * (7 - nq))]


def pack_model(m: PhysicsModel) -> dict:
    """The model as the kernel reads it: an int32 and a float64 array in the
    record layouts of csrc/jt_common.cuh, plus the counts of a JtSizes."""
    cached = m._packed.get("packed")
    if cached is not None:
        return cached
    lane_supported(m)
    I: list = []
    F: list = [float(m.np64("timestep")), *(m.np64("gravity") * (1.0 if m.gravity_enabled else 0.0)), float(m.np64("impratio"))]
    f64 = m.np64
    mass = f64("body_mass")
    sub_mass = mass.copy()
    for b in range(m.nbody - 1, 0, -1):
        sub_mass[m.body_parentid[b]] += sub_mass[b]
    bp, bq, bip, biq, binr = f64("body_pos"), f64("body_quat"), f64("body_ipos"), f64("body_iquat"), f64("body_inertia")
    for b in range(m.nbody):
        I += [m.body_parentid[b], m.body_rootid[b], m.body_jntadr[b], m.body_jntnum[b]]
    floats_body = [[*bp[b], *bq[b], *bip[b], *biq[b], mass[b], *binr[b], sub_mass[b]] for b in range(m.nbody)]
    jp, ja, q0 = f64("jnt_pos"), f64("jnt_axis"), f64("qpos0")
    stiff, qs, afr = f64("jnt_stiffness"), f64("qpos_spring"), f64("jnt_actfrcrange")
    for j in range(m.njnt):
        I += [m.jnt_type[j], m.jnt_qposadr[j], m.jnt_dofadr[j], m.jnt_bodyid[j], int(m.jnt_actfrclimited[j])]
    floats_jnt = [
        [*jp[j], *ja[j], q0[m.jnt_qposadr[j]], stiff[j], qs[m.jnt_qposadr[j]], *afr[j], *_spring7(m, qs, j)]
        for j in range(m.njnt)
    ]
    for d in range(m.nv):
        I += [m.dof_bodyid[d], m.dof_parentid[d]]
    damp = implicit_damping_np(m)
    floats_dof = [[f64("dof_damping")[d], f64("dof_armature")[d], damp[d]] for d in range(m.nv)]
    gp, gq, sp, sq = f64("geom_pos"), f64("geom_quat"), f64("site_pos"), f64("site_quat")
    I += list(m.geom_bodyid)
    floats_geom = [[*gp[g], *gq[g]] for g in range(m.ngeom)]
    I += list(m.site_bodyid)
    floats_site = [[*sp[s], *sq[s]] for s in range(m.nsite)]
    gear, gain, bias = f64("actuator_gear")[:, 0], f64("actuator_gainprm")[:, 0], f64("actuator_biasprm")[:, :3]
    cr, fr = f64("actuator_ctrlrange"), f64("actuator_forcerange")
    floats_act = []
    for u in range(m.nu):
        j = m.actuator_trnid[u]
        I += [m.jnt_qposadr[j], m.jnt_dofadr[j], int(m.actuator_ctrllimited[u]), int(m.actuator_forcelimited[u])]
        floats_act.append([gear[u], gain[u], *bias[u], *cr[u], *fr[u]])
    for i in range(m.nsensor):
        I += [m.sensor_type[i], m.sensor_objtype[i], m.sensor_objid[i], m.sensor_adr[i], m.sensor_dim[i],
              m.sensor_reftype[i], m.sensor_refid[i]]
    ts = float(f64("timestep"))
    jr, jm, jsr, jsi, inv_dof = f64("jnt_range"), f64("jnt_margin"), f64("jnt_solref"), f64("jnt_solimp"), f64("dof_invweight0")
    floats_row = []
    for e in joint_equalities(m):
        j1, j2 = m.eq_obj1id[e], m.eq_obj2id[e]
        q1, d1 = m.jnt_qposadr[j1], m.jnt_dofadr[j1]
        q2, d2 = (m.jnt_qposadr[j2], m.jnt_dofadr[j2]) if j2 >= 0 else (-1, -1)
        si = f64("eq_solimp")[e]
        k, bb = kb_from_solref_np(f64("eq_solref")[e], si, ts)
        inv_w = inv_dof[d1] + inv_dof[d2] if j2 >= 0 else inv_dof[d1]
        for side in (1.0, -1.0):
            I += [ROW_EQUALITY, q1, d1, q2, d2]
            floats_row.append([side, q0[q1], q0[q2] if j2 >= 0 else 0.0, *si, k, bb, inv_w, *f64("eq_data")[e, :5]])
    for j in limit_joints(m):
        k, bb = kb_from_solref_np(jsr[j], jsi[j], ts)
        for side, rng in ((1.0, jr[j, 0]), (-1.0, jr[j, 1])):
            I += [ROW_LIMIT, m.jnt_qposadr[j], m.jnt_dofadr[j], -1, -1]
            floats_row.append([side, rng, jm[j], *jsi[j], k, bb, inv_dof[m.jnt_dofadr[j]], 0.0, 0.0, 0.0, 0.0, 0.0])
    floats_pair, slot_i, floats_slot = [], [], []
    size = f64("geom_size")
    bi = f64("body_invweight0")
    npair = ncon = 0
    if m.contact_enabled:
        for sig, pairs in pair_groups(m):
            nslot = SLOTS_PER_PAIR[sig]
            for g1, g2 in pairs:
                I += [PAIR_KINDS[sig], g1, g2, ncon, nslot]
                floats_pair.append([*size[g1], *size[g2]])
                mu, sr, si, mg = pair_params_np(m, g1, g2)
                k, bb = kb_from_solref_np(sr, si, ts)
                b1, b2 = m.geom_bodyid[g1], m.geom_bodyid[g2]
                diag = max(bi[b1, 0] + bi[b2, 0], 1e-15)
                if m.cone_pyramidal:
                    diag = max(2.0 * diag * mu**2 * (1.0 + mu**2), 1e-15)
                for _ in range(nslot):
                    slot_i += [b1, b2]
                    floats_slot.append([mu, k, bb, *si, mg, diag])
                npair += 1
                ncon += nslot
    I += slot_i
    islands = dof_islands(m)
    for s, e in islands:
        I += [s, e - s]
    # distance sensors: each its list of geom pairs (fixed by the model)
    dist_i, floats_dist, dpair_i, floats_dpair = [], [], [], []
    for i in range(m.nsensor):
        if m.sensor_type[i] != SENSOR_DISTANCE or m.sensor_objtype[i] != OBJ_BODY:
            continue
        pairs = distance_sensor_pairs(m, i)
        dist_i += [m.sensor_adr[i], len(dpair_i) // 4, len(pairs)]
        floats_dist.append([f64("sensor_cutoff")[i]])
        for a, b in pairs:
            sig = (m.geom_type[a], m.geom_type[b])
            dpair_i += [PAIR_KINDS[sig], a, b, SLOTS_PER_PAIR[sig]]
            floats_dpair.append([*size[a], *size[b]])
    I += dist_i + dpair_i
    I += [int(v) for v in np.asarray(m.body_dof_mask).reshape(-1)]
    for block in (floats_body, floats_jnt, floats_dof, floats_geom, floats_site, floats_act, floats_row,
                  floats_pair, floats_slot, floats_dist, floats_dpair):
        for rec in block:
            F += [float(x) for x in rec]
    nefc = num_constraint_rows(m)
    assert nefc == len(floats_row) + contact_rows_per(m) * ncon, (nefc, len(floats_row), ncon)
    packed = {
        "mi": np.asarray(I, np.int32),
        "mf": np.asarray(F, np.float64),
        "counts": dict(
            nq=m.nq, nv=m.nv, nu=m.nu, nbody=m.nbody, njnt=m.njnt, ngeom=m.ngeom, nsite=m.nsite,
            nsensor=m.nsensor, nsensordata=m.nsensordata, nnc=len(floats_row), npair=npair, ncon=ncon,
            nefc=nefc, nisl=len(islands), ndist=len(floats_dist), ndpair=len(floats_dpair), nu_=max(m.nu, 1),
            ns_=max(m.nsensordata, 1), nefc_=max(nefc, 1),
        ),
    }
    m._packed["packed"] = packed
    return packed


def _sizes(m: PhysicsModel, B: int, T: int, substeps: int, iterations: int | None, cold: bool = False) -> JtSizes:
    return JtSizes(
        B=B, T=T, substeps=substeps, iterations=solver_iters(m, iterations), pyramidal=int(m.cone_pyramidal),
        cold=int(cold), **pack_model(m)["counts"],
    )


# The warps per rollout the rollout kernel is built for (csrc/fused_rollout.cu),
# the schedulers of an SM, each of which runs warps of its own, and the lanes
# of a warp.
ROLLOUT_WARPS, SCHEDULERS_PER_SM, WARP_LANES = (1, 4), 4, 32


def rollout_warps(rollouts: int, sms: int, rows: int) -> int:
    """Warps per rollout of the rollout kernel for a solve of ``rollouts``
    rollouts of a model with ``rows`` constraint rows on a card of ``sms``
    SMs. One warp where its 32 lanes take the rows in one pass (cylinder_push's
    24, cartpole's 2): the row passes are what more warps speed up, and
    elsewhere they add only barriers. Else the most of ``ROLLOUT_WARPS`` with
    which the ceil(rollouts / sms) blocks of an SM give its four schedulers at
    most one warp each (fr3_pick's 64 rollouts on 132 SMs: 4; leap's 320,
    three blocks an SM: 1)."""
    if rows <= WARP_LANES:
        return 1
    per_sm = -(-rollouts // sms)
    return max(w for w in ROLLOUT_WARPS if per_sm * w <= SCHEDULERS_PER_SM or w == 1)


_SMS: dict[str, int] = {}


def sm_count(dev) -> int | None:
    """The SMs of CUDA device ``dev``, read once per device; None for a
    device that is not a CUDA one."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return None
    key = str(dev)
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[key]


def fold_smem(warps: int, itemsize: int) -> int:
    """Static shared memory of the rollout kernel's folds at ``warps`` warps
    per rollout (csrc/jt_common.cuh:fold_partials), in bytes."""
    return warps * itemsize if warps > 1 else 0


def _check_layout(lib, m: PhysicsModel, sizes: JtSizes) -> None:
    """Assert the packed model matches the library's layout."""
    nint, nflt = ctypes.c_int(), ctypes.c_int()
    lib.jt_model_sizes(ctypes.byref(sizes), ctypes.byref(nint), ctypes.byref(nflt))
    pk = pack_model(m)
    if (nint.value, nflt.value) != (pk["mi"].size, pk["mf"].size):
        raise RuntimeError(f"model packing {pk['mi'].size, pk['mf'].size} != kernel layout {nint.value, nflt.value}")


def _check_inputs(m: PhysicsModel, qpos, qvel, ctrl, f0):
    pk = pack_model(m)["counts"]
    B = qpos.shape[-1]
    want = {"qpos": (m.nq, B), "qvel": (m.nv, B), "ctrl": (ctrl.shape[0], pk["nu_"], B), "f0": (pk["nefc_"], B)}
    for name, x in (("qpos", qpos), ("qvel", qvel), ("ctrl", ctrl), ("f0", f0)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {want[name]}")
        if x.dtype != qpos.dtype or x.device != qpos.device:
            raise ValueError(f"{name} must share qpos's dtype and device")
    if qpos.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {qpos.dtype}")


def model_tensors(m: PhysicsModel, dev, dtype) -> tuple:
    """The packed model on ``dev`` in ``dtype`` (made once per device and dtype)."""
    key = ("packed_dev", str(dev), dtype)
    mt = m._packed.get(key)
    if mt is None:
        pk = pack_model(m)
        mt = (torch.as_tensor(pk["mi"]).to(dev), torch.as_tensor(pk["mf"], dtype=dtype).to(dev))
        m._packed[key] = mt
    return mt


_SMEM_LIMITS: dict[int, int] = {}


def smem_limit(lib) -> int:
    """The current card's opt-in limit of shared memory per block, in bytes
    (``lib`` is the CUDA library), read once per card."""
    dev = torch.cuda.current_device()
    if dev not in _SMEM_LIMITS:
        limit = ctypes.c_int()
        err = lib.jt_smem_optin(ctypes.byref(limit))
        if err != 0:
            raise RuntimeError(f"reading the shared-memory limit failed: {lib.jt_error_string(err).decode()}")
        _SMEM_LIMITS[dev] = limit.value
    return _SMEM_LIMITS[dev]


def scratch_elems(lib, sizes: JtSizes, layout: str, maxw: int | None = None) -> int:
    """Elements of one rollout's scratch in shared memory under ``layout``;
    ``maxw``: the policy rollout's, with its policy scratch."""
    sizes.jglobal = int(layout == GLOBAL_J)
    if maxw is None:
        return int(lib.jt_scratch_per_lane(ctypes.byref(sizes)))
    return int(lib.jt_policy_scratch_per_lane(ctypes.byref(sizes), maxw))


def choose_layout(lib, sizes: JtSizes, itemsize: int, name: str, maxw: int | None = None,
                  limit: int | None = None) -> tuple[str, int]:
    """(layout, shared-memory bytes per block) of a launch, and set
    ``sizes.jglobal`` to match: the whole scratch in shared memory where it
    fits ``limit`` (the card's opt-in bytes per block; None: no limit), else J
    in global memory; raises where neither fits."""
    need = {lay: scratch_elems(lib, sizes, lay, maxw) * itemsize for lay in (SHARED, GLOBAL_J)}
    for lay in (SHARED, GLOBAL_J):
        if limit is None or need[lay] <= limit:
            scratch_elems(lib, sizes, lay, maxw)
            return lay, need[lay]
    raise RuntimeError(
        f"{name}: one rollout's scratch needs {need[SHARED]} bytes of shared memory per block, and "
        f"{need[GLOBAL_J]} with its constraint Jacobian in global memory, more than this card's opt-in limit of "
        f"{limit} bytes; the model is too large for the kernel"
    )


def jslab(lib, sizes: JtSizes, B: int, dtype, dev) -> torch.Tensor:
    """The global-memory slab of J for ``B`` rollouts (empty in the shared layout)."""
    n = int(lib.jt_jslab_per_lane(ctypes.byref(sizes))) if sizes.jglobal else 0
    return torch.empty((B, n), dtype=dtype, device=dev)


def kernel_layout(m: PhysicsModel, dtype: torch.dtype, cold: bool = False, policy=None,
                  warps: int = 1) -> tuple[str, int, int]:
    """(layout, dynamic shared-memory bytes per block, resident blocks per
    SM) of the rollout kernel in blocks of ``warps`` warps (``cold``: the
    single-step kernel; ``policy``: the policy rollout kernel with that
    policy; both one warp) for ``m`` on the current card."""
    from judo_tpu_torch import _build

    lib = _build.load("cuda")
    sizes = _sizes(m, 1, 1, 1, None, cold)
    _check_layout(lib, m, sizes)
    maxw = None if policy is None else max(policy.dims)
    itemsize = torch.empty((), dtype=dtype).element_size()
    limit = smem_limit(lib) - fold_smem(warps, itemsize)
    layout, nbytes = choose_layout(lib, sizes, itemsize, "kernel_layout", maxw, limit)
    blocks = ctypes.c_int()
    f64 = int(dtype == torch.float64)
    if policy is None:
        err = lib.jt_rollout_blocks_per_sm(int(cold), sizes.jglobal, f64, warps, nbytes, ctypes.byref(blocks))
    else:
        err = lib.jt_policy_blocks_per_sm(sizes.jglobal, f64, nbytes, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: {lib.jt_error_string(err).decode()}")
    return layout, nbytes, blocks.value


def _launch(lib, m, qpos, qvel, ctrl, f0, substeps, iterations, stream, cold=False, layout=None, warps=1):
    """Run the library's fused rollout in blocks of ``warps`` warps (or, with
    ``cold``, the single-step kernel, one warp) on contiguous tensors; returns
    the outputs. ``layout`` forces a scratch layout (tests run the host twin
    in both); by default the card's limit picks it, and the host twin keeps
    the whole scratch in one buffer."""
    B, T = qpos.shape[-1], ctrl.shape[0]
    sizes = _sizes(m, B, T, substeps, iterations, cold)
    _check_layout(lib, m, sizes)
    dev, dtype = qpos.device, qpos.dtype
    limit = smem_limit(lib) - fold_smem(warps, qpos.element_size()) if qpos.is_cuda and layout is None else None
    if layout is not None:
        scratch_elems(lib, sizes, layout)
    else:
        choose_layout(lib, sizes, qpos.element_size(), "physics_step" if cold else "fused_rollout", None, limit)
    mi, mf = model_tensors(m, dev, dtype)
    c = pack_model(m)["counts"]
    ins = [x.contiguous() for x in (qpos, qvel, ctrl, f0)]
    oq = torch.empty((T, m.nq, B), dtype=dtype, device=dev)
    ov = torch.empty((T, m.nv, B), dtype=dtype, device=dev)
    os_ = torch.empty((T, c["ns_"], B), dtype=dtype, device=dev)
    of0 = torch.empty((c["nefc_"], B), dtype=dtype, device=dev)
    fn = lib.jt_fused_rollout_f64 if dtype == torch.float64 else lib.jt_fused_rollout_f32
    args = [mi, mf, *ins, oq, ov, os_, of0, jslab(lib, sizes, B, dtype, dev)]
    err = fn(ctypes.byref(sizes), warps, *[a.data_ptr() for a in args], stream)
    if err != 0:
        raise RuntimeError(f"fused_rollout kernel launch failed: {lib.jt_error_string(err).decode()} ({err})")
    return oq, ov, os_, of0


_tally = threading.local()


def add_launches(wrapper, n: int, warps: int = 1) -> None:
    """``n`` launches of ``wrapper``'s kernel in blocks of ``warps`` warps:
    added to ``wrapper.launches`` and, where the wrapper keeps them by W
    (``fused_rollout.launches_by_warps``), to its count at ``warps``."""
    wrapper.launches += n
    by_warps = getattr(wrapper, "launches_by_warps", None)
    if by_warps is not None:
        by_warps[warps] = by_warps.get(warps, 0) + n


def count_launch(wrapper, warps: int = 1) -> None:
    """One launch of ``wrapper``'s kernel in blocks of ``warps`` warps
    (``add_launches``), or, while this thread tallies (a solve graph's
    warm-up and capture), one more in the tally instead."""
    tally = getattr(_tally, "counts", None)
    if tally is None:
        add_launches(wrapper, 1, warps)
    else:
        tally[wrapper, warps] = tally.get((wrapper, warps), 0) + 1


@contextlib.contextmanager
def tallied_launches():
    """Count this thread's kernel launches into the dict it yields ((wrapper,
    warps) -> launches), not into the wrappers' counters. A solve graph
    tallies its warm-up and its capture: its replays add the captured
    kernels' launches (``add_launches``)."""
    _tally.counts = {}
    try:
        yield _tally.counts
    finally:
        _tally.counts = None


def fused_rollout(
    m: PhysicsModel,
    qpos: torch.Tensor,  # (nq, B)
    qvel: torch.Tensor,  # (nv, B)
    ctrl: torch.Tensor,  # (T, nu_, B)
    f0: torch.Tensor,  # (nefc_, B)
    substeps: int = 1,
    iterations: int | None = None,
    warps: int | None = None,
):
    """The fused rollout, batch-last: -> ((T,nq,B), (T,nv,B), (T,ns_,B), (nefc_,B)).

    CUDA tensors launch the kernel in blocks of ``warps`` warps per rollout
    (a solve passes the W of its whole batch, so that its shards run as one
    launch would; None: ``rollout_warps`` of B, the model's rows and the
    device's SMs).
    ``fused_rollout.launches`` counts each launch and
    ``fused_rollout.launches_by_warps`` each at its W (``count_launch``: a
    solve graph's replay adds the launches it captured). CPU tensors run the
    plain version, whose arithmetic has no W. Nothing else is accepted.
    """
    _check_inputs(m, qpos, qvel, ctrl, f0)
    if qpos.device.type == "cpu":
        return rollout_lanes_reference(m, qpos, qvel, ctrl, f0, substeps, iterations)
    lib = _cuda_lib(qpos, "fused_rollout")
    if warps is None:
        warps = rollout_warps(qpos.shape[-1], sm_count(qpos.device), num_constraint_rows(m))
    with torch.cuda.device(qpos.device):
        stream = torch.cuda.current_stream(qpos.device).cuda_stream
        out = _launch(lib, m, qpos, qvel, ctrl, f0, substeps, iterations, stream, warps=warps)
    count_launch(fused_rollout, warps)
    return out


fused_rollout.launches = 0
fused_rollout.launches_by_warps = {}


def _cuda_lib(x: torch.Tensor, name: str):
    """The CUDA library for a tensor on the card; raises for other devices."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {x.device}")
    from judo_tpu_torch import _build

    return _build.load("cuda")


def physics_step(
    m: PhysicsModel,
    qpos: torch.Tensor,  # (nq, B)
    qvel: torch.Tensor,  # (nv, B)
    ctrl: torch.Tensor,  # (nu_, B)
    f: torch.Tensor,  # (nefc_, B) warm-start forces
    iterations: int | None = None,
):
    """One physics step with a cold probe, batch-last:
    -> ((nq,B), (nv,B), (ns_,B), (nefc_,B)) post-step state, sensors, forces.

    CUDA tensors launch the single-step kernel (``physics_step.launches``
    counts each launch); CPU tensors run the plain version
    ``step_l(..., cw_v=None)``.
    """
    _check_inputs(m, qpos, qvel, ctrl[None], f)
    if qpos.device.type == "cpu":
        return physics_step_reference(m, qpos, qvel, ctrl, f, iterations)
    lib = _cuda_lib(qpos, "physics_step")
    with torch.cuda.device(qpos.device):
        stream = torch.cuda.current_stream(qpos.device).cuda_stream
        oq, ov, os_, of = _launch(lib, m, qpos, qvel, ctrl[None], f, 1, iterations, stream, cold=True)
    count_launch(physics_step)
    return oq[0], ov[0], os_[0], of


physics_step.launches = 0


def physics_step_reference(m: PhysicsModel, qpos, qvel, ctrl, f, iterations: int | None = None):
    """The plain version of the single-step kernel: ``step_l`` with a cold probe."""
    nefc = num_constraint_rows(m)
    out = step_l(m, qpos, qvel, ctrl[: m.nu], f[:nefc] if nefc else None, iterations, cw_v=None)
    sens = out.sensordata if m.nsensordata else qpos.new_zeros((1, qpos.shape[-1]))
    return out.qpos, out.qvel, sens, out.efc_force if nefc else torch.zeros_like(f)


def physics_step_host_twin(m: PhysicsModel, qpos, qvel, ctrl, f, iterations: int | None = None):
    """The single-step kernel's own arithmetic built with g++, on the CPU. For tests."""
    _check_inputs(m, qpos, qvel, ctrl[None], f)
    from judo_tpu_torch import _build

    oq, ov, os_, of = _launch(_build.load("host"), m, qpos, qvel, ctrl[None], f, 1, iterations, None, cold=True)
    return oq[0], ov[0], os_[0], of


def fused_rollout_host_twin(
    m: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor, ctrl: torch.Tensor, f0: torch.Tensor,
    substeps: int = 1, iterations: int | None = None, layout: str = SHARED, warps: int = 1,
):
    """The kernel's own code built with g++ and run on the CPU, one rollout
    after another, with the block's ``warps`` x 32 threads played in one
    thread in the card's order (csrc/fused_rollout_host.cpp), in scratch
    layout ``layout``. For tests."""
    _check_inputs(m, qpos, qvel, ctrl, f0)
    if warps not in ROLLOUT_WARPS:
        raise ValueError(f"warps {warps} is none of the built {ROLLOUT_WARPS}")
    from judo_tpu_torch import _build

    return _launch(_build.load("host"), m, qpos, qvel, ctrl, f0, substeps, iterations, None, layout=layout,
                   warps=warps)


def rollout_lanes(
    m: PhysicsModel,
    qpos0: torch.Tensor,  # (R, nq)
    qvel0: torch.Tensor,  # (R, nv)
    controls: torch.Tensor,  # (R, T, nu)
    physics_substeps: int = 1,
    iterations: int | None = None,
    efc_warm: torch.Tensor | None = None,  # (R, nefc) onset warm start
    warps: int | None = None,
) -> LaneRolloutOutput:
    """Batched rollout with batch-first states at the boundary (the semantics
    of pallas_step.rollout_lanes: post-step (qpos, qvel) and the last
    substep's pre-integration sensors per control, plus the step-0 forces);
    ``warps`` as ``fused_rollout``'s."""
    R, T = controls.shape[0], controls.shape[1]
    nefc = num_constraint_rows(m)
    ns = m.nsensordata
    dtype, dev = qpos0.dtype, qpos0.device
    qp = qpos0.T.contiguous()
    qv = qvel0.T.contiguous()
    ct = controls.permute(1, 2, 0) if m.nu else torch.zeros((T, 1, R), dtype=dtype, device=dev)
    if efc_warm is None:
        f0 = torch.zeros((max(nefc, 1), R), dtype=dtype, device=dev)
    else:
        f0 = efc_warm.T.to(dtype)
    qps, qvs, senss, f0_out = fused_rollout(m, qp, qv, ct.contiguous(), f0.contiguous(), physics_substeps, iterations,
                                            warps)
    states = torch.cat([qps, qvs], dim=1).permute(2, 0, 1)
    senss = senss.permute(2, 0, 1)[:, :, :ns]
    return LaneRolloutOutput(states=states, sensordata=senss, efc0=f0_out.T[:, : max(nefc, 1)])
