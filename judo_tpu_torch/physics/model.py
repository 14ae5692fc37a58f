"""Host-side physics model for the PyTorch port (counterpart of
``judo_tpu/physics/model.py``).

``put_model`` lowers a compiled ``mujoco.MjModel`` exactly as the JAX package
does: static topology stays Python tuples, array fields are host numpy in the
model's dtype. The kernel's device copy of the model is made on first use per
``(device, dtype)`` (``physics/fused_rollout.py``). ``mujoco`` is imported only
inside ``put_model``: the machine that runs the GPU path has no ``mujoco``, so
it builds its model from a snapshot (``load_snapshot``) instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Tuple

import numpy as np
import torch

# Joint type codes (mujoco.mjtJoint).
FREE, BALL, SLIDE, HINGE = 0, 1, 2, 3

# Geom type codes (mujoco.mjtGeom).
GEOM_PLANE, GEOM_HFIELD, GEOM_SPHERE, GEOM_CAPSULE = 0, 1, 2, 3
GEOM_ELLIPSOID, GEOM_CYLINDER, GEOM_BOX, GEOM_MESH = 4, 5, 6, 7

# Integrator codes (mujoco.mjtIntegrator).
INT_EULER, INT_RK4, INT_IMPLICIT, INT_IMPLICITFAST = 0, 1, 2, 3

# Sensor type codes (mujoco.mjtSensor); tests check them against mujoco.
SENSOR_JOINTPOS = 9
SENSOR_JOINTVEL = 10
SENSOR_FRAMEPOS = 26
SENSOR_FRAMEQUAT = 27
SENSOR_FRAMEXAXIS = 28
SENSOR_FRAMEYAXIS = 29
SENSOR_FRAMEZAXIS = 30
SENSOR_FRAMELINVEL = 31
SENSOR_DISTANCE = 39  # mjSENS_GEOMDIST

# Equality constraint types (mujoco.mjtEq).
EQ_CONNECT, EQ_WELD, EQ_JOINT, EQ_TENDON = 0, 1, 2, 3

# Object types (mujoco.mjtObj).
OBJ_BODY, OBJ_XBODY, OBJ_GEOM, OBJ_SITE, OBJ_SENSOR = 1, 2, 5, 6, 20

# Disable bits and cone code (mujoco.mjtDisableBit / mjtCone).
_DSBL_LIMIT, _DSBL_CONTACT, _DSBL_GRAVITY = 8, 16, 128
_CONE_PYRAMIDAL = 0

# Pair types with a narrowphase kernel in this port, and their slot counts
# (judo_tpu/physics/lane_collision.py:_SLOTS_PER_PAIR).
SLOTS_PER_PAIR = {
    (GEOM_PLANE, GEOM_SPHERE): 1,
    (GEOM_PLANE, GEOM_CAPSULE): 2,
    (GEOM_PLANE, GEOM_CYLINDER): 2,
    (GEOM_PLANE, GEOM_BOX): 4,
    (GEOM_SPHERE, GEOM_SPHERE): 1,
    (GEOM_SPHERE, GEOM_CAPSULE): 1,
    (GEOM_SPHERE, GEOM_CYLINDER): 1,
    (GEOM_SPHERE, GEOM_BOX): 1,
    (GEOM_CAPSULE, GEOM_CAPSULE): 1,
    (GEOM_CAPSULE, GEOM_CYLINDER): 1,
    (GEOM_CAPSULE, GEOM_BOX): 2,
    (GEOM_CYLINDER, GEOM_CYLINDER): 2,
    (GEOM_CYLINDER, GEOM_BOX): 2,
    (GEOM_BOX, GEOM_BOX): 4,
}

# Slot counts of every pair type the JAX narrowphase knows
# (judo_tpu/physics/collision.py:_num_slots), for the row counters.
_NUM_SLOTS = {
    (GEOM_PLANE, GEOM_SPHERE): 1, (GEOM_PLANE, GEOM_CAPSULE): 2,
    (GEOM_PLANE, GEOM_CYLINDER): 2, (GEOM_PLANE, GEOM_BOX): 4,
    (GEOM_SPHERE, GEOM_SPHERE): 1, (GEOM_SPHERE, GEOM_CAPSULE): 1,
    (GEOM_SPHERE, GEOM_CYLINDER): 1, (GEOM_SPHERE, GEOM_BOX): 1,
    (GEOM_CAPSULE, GEOM_CAPSULE): 1, (GEOM_CAPSULE, GEOM_CYLINDER): 1,
    (GEOM_CAPSULE, GEOM_BOX): 2, (GEOM_CYLINDER, GEOM_CYLINDER): 2,
    (GEOM_CYLINDER, GEOM_BOX): 2, (GEOM_BOX, GEOM_BOX): 4,
}

def _t(x) -> tuple:
    """Static tuple of ints from an array."""
    return tuple(int(v) for v in np.asarray(x).reshape(-1))


STATIC_FIELDS = (
    "nq", "nv", "nu", "nbody", "njnt", "ngeom", "nsite", "nsensor", "nsensordata",
    "integrator", "cone_pyramidal", "contact_enabled", "limit_enabled",
    "gravity_enabled", "solver_iterations",
    "body_parentid", "body_rootid", "body_jntadr", "body_jntnum", "body_dofadr",
    "body_dofnum", "jnt_type", "jnt_qposadr", "jnt_dofadr", "jnt_bodyid",
    "jnt_limited", "jnt_actfrclimited", "dof_bodyid", "dof_jntid", "dof_parentid",
    "geom_type", "geom_bodyid", "geom_condim", "geom_priority", "site_bodyid",
    "actuator_trnid", "sensor_type", "sensor_objtype", "sensor_objid", "sensor_adr",
    "sensor_dim", "sensor_reftype", "sensor_refid", "sensor_objname", "neq",
    "eq_type", "eq_obj1id", "eq_obj2id", "collision_pairs",
)

ARRAY_FIELDS = (
    "timestep", "gravity", "qpos0", "qpos_spring", "body_pos", "body_quat",
    "body_ipos", "body_iquat", "body_mass", "body_inertia", "jnt_pos", "jnt_axis",
    "jnt_range", "jnt_stiffness", "jnt_solref", "jnt_solimp", "jnt_margin",
    "jnt_actfrcrange", "dof_damping", "dof_armature", "dof_frictionloss",
    "dof_invweight0", "geom_pos", "geom_quat", "geom_size", "geom_friction",
    "geom_solref", "geom_solimp", "geom_solmix", "geom_margin", "geom_gap",
    "site_pos", "site_quat", "sensor_cutoff", "eq_data", "eq_solref", "eq_solimp",
    "actuator_gear", "actuator_gainprm", "actuator_biasprm", "actuator_ctrlrange",
    "actuator_forcerange", "actuator_ctrllimited", "actuator_forcelimited",
    "dof_ancestor_mask", "body_dof_mask", "subtree_mask", "dofdot_mask",
    "body_invweight0", "impratio",
)

_BOOL_STATICS = ("cone_pyramidal", "contact_enabled", "limit_enabled", "gravity_enabled")
_INT_STATICS = (
    "nq", "nv", "nu", "nbody", "njnt", "ngeom", "nsite", "nsensor", "nsensordata",
    "integrator", "solver_iterations", "neq",
)

# Arrays that keep their own (bool) dtype instead of the model's float dtype.
_BOOL_ARRAYS = ("actuator_ctrllimited", "actuator_forcelimited")


@dataclass(eq=False)
class PhysicsModel:
    """Static topology as Python tuples, arrays as host numpy in ``dtype``.

    Field names and meanings follow ``judo_tpu.physics.model.PhysicsModel``.
    """

    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    nsensor: int
    nsensordata: int
    integrator: int
    cone_pyramidal: bool
    contact_enabled: bool
    limit_enabled: bool
    gravity_enabled: bool
    solver_iterations: int
    body_parentid: Tuple[int, ...]
    body_rootid: Tuple[int, ...]
    body_jntadr: Tuple[int, ...]
    body_jntnum: Tuple[int, ...]
    body_dofadr: Tuple[int, ...]
    body_dofnum: Tuple[int, ...]
    jnt_type: Tuple[int, ...]
    jnt_qposadr: Tuple[int, ...]
    jnt_dofadr: Tuple[int, ...]
    jnt_bodyid: Tuple[int, ...]
    jnt_limited: Tuple[int, ...]
    jnt_actfrclimited: Tuple[int, ...]
    dof_bodyid: Tuple[int, ...]
    dof_jntid: Tuple[int, ...]
    dof_parentid: Tuple[int, ...]
    geom_type: Tuple[int, ...]
    geom_bodyid: Tuple[int, ...]
    geom_condim: Tuple[int, ...]
    geom_priority: Tuple[int, ...]
    site_bodyid: Tuple[int, ...]
    actuator_trnid: Tuple[int, ...]
    sensor_type: Tuple[int, ...]
    sensor_objtype: Tuple[int, ...]
    sensor_objid: Tuple[int, ...]
    sensor_adr: Tuple[int, ...]
    sensor_dim: Tuple[int, ...]
    sensor_reftype: Tuple[int, ...]
    sensor_refid: Tuple[int, ...]
    sensor_objname: Tuple[str, ...]
    neq: int
    eq_type: Tuple[int, ...]
    eq_obj1id: Tuple[int, ...]
    eq_obj2id: Tuple[int, ...]
    collision_pairs: Tuple[Tuple[int, int], ...]

    timestep: np.ndarray
    gravity: np.ndarray
    qpos0: np.ndarray
    qpos_spring: np.ndarray
    body_pos: np.ndarray
    body_quat: np.ndarray
    body_ipos: np.ndarray
    body_iquat: np.ndarray
    body_mass: np.ndarray
    body_inertia: np.ndarray
    jnt_pos: np.ndarray
    jnt_axis: np.ndarray
    jnt_range: np.ndarray
    jnt_stiffness: np.ndarray
    jnt_solref: np.ndarray
    jnt_solimp: np.ndarray
    jnt_margin: np.ndarray
    jnt_actfrcrange: np.ndarray
    dof_damping: np.ndarray
    dof_armature: np.ndarray
    dof_frictionloss: np.ndarray
    dof_invweight0: np.ndarray
    geom_pos: np.ndarray
    geom_quat: np.ndarray
    geom_size: np.ndarray
    geom_friction: np.ndarray
    geom_solref: np.ndarray
    geom_solimp: np.ndarray
    geom_solmix: np.ndarray
    geom_margin: np.ndarray
    geom_gap: np.ndarray
    site_pos: np.ndarray
    site_quat: np.ndarray
    sensor_cutoff: np.ndarray
    eq_data: np.ndarray
    eq_solref: np.ndarray
    eq_solimp: np.ndarray
    actuator_gear: np.ndarray
    actuator_gainprm: np.ndarray
    actuator_biasprm: np.ndarray
    actuator_ctrlrange: np.ndarray
    actuator_forcerange: np.ndarray
    actuator_ctrllimited: np.ndarray
    actuator_forcelimited: np.ndarray
    dof_ancestor_mask: np.ndarray
    body_dof_mask: np.ndarray
    subtree_mask: np.ndarray
    dofdot_mask: np.ndarray
    body_invweight0: np.ndarray
    impratio: np.ndarray

    # the kernel's packed copy of the model, and its device copies per
    # (device, dtype), made on first use (physics/fused_rollout.py)
    _packed: dict = field(default_factory=dict, repr=False)

    @property
    def dtype(self) -> np.dtype:
        return self.qpos0.dtype

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == np.float64 else torch.float32

    def np64(self, name: str) -> np.ndarray:
        """A model array as float64 numpy (host constants for the step)."""
        return np.asarray(getattr(self, name), np.float64)

    def astype(self, dtype) -> "PhysicsModel":
        """The same model with its float arrays cast to ``dtype``."""
        static, arrays = model_to_numpy(self)
        return physics_model_from_numpy(static, arrays, dtype=dtype)


def resolve_device(device: Any) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA GPU and torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch version on the CPU"
        )
    return dev


@dataclass
class PhysicsState:
    """Carried state of one simulation (batch via leading dims)."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    time: float = 0.0


def make_state(m: PhysicsModel, qpos=None, qvel=None, time: float = 0.0, device: Any = "cuda") -> PhysicsState:
    """Fresh state at the model's reference pose, on the card unless the
    caller asks for another device (without a CUDA GPU, ``device="cuda"``
    raises; pass ``device="cpu"``)."""
    device = resolve_device(device)
    dtype = m.torch_dtype
    qp = torch.as_tensor(np.asarray(m.qpos0) if qpos is None else qpos, dtype=dtype, device=device)
    qv = torch.zeros(m.nv, dtype=dtype, device=device) if qvel is None else torch.as_tensor(
        qvel, dtype=dtype, device=device
    )
    return PhysicsState(qpos=qp, qvel=qv, time=float(time))


# ---------------------------------------------------------------------------
# row and slot counters (judo_tpu/physics/solver.py, collision.py)
# ---------------------------------------------------------------------------


def num_contact_slots(m: PhysicsModel) -> int:
    """Contact slots of the static pair list (collision.num_contact_slots)."""
    return sum(_NUM_SLOTS.get((m.geom_type[g1], m.geom_type[g2]), 0) for g1, g2 in m.collision_pairs)


def limit_joints(m: PhysicsModel) -> list:
    """Joints with limit rows, in row order (solver._limit_meta)."""
    if not m.limit_enabled:
        return []
    return [j for j in range(m.njnt) if m.jnt_limited[j] and m.jnt_type[j] in (SLIDE, HINGE)]


def joint_equalities(m: PhysicsModel) -> list:
    """Joint equalities, in row order (one +/- row pair each)."""
    return [e for e in range(m.neq) if m.eq_type[e] == EQ_JOINT]


def num_noncontact_rows(m: PhysicsModel) -> int:
    """Rows before the contact block: joint equalities and limits."""
    return 2 * len(joint_equalities(m)) + 2 * len(limit_joints(m))


def distance_sensor_pairs(m: PhysicsModel, i: int) -> list:
    """Geom pairs (a, b) whose slot distances distance sensor ``i`` (two
    bodies) takes the minimum of, in the order and orientation of
    judo_tpu/physics/lane_step.py:_distance_sensor_l: a pair of two geoms of
    one type enters in both orientations, and a pair type with no narrowphase
    in the JAX package is left out, as there."""
    body1, body2 = m.sensor_objid[i], m.sensor_refid[i]
    bid, gt = m.geom_bodyid, m.geom_type
    pairs = []
    for g1 in range(m.ngeom):
        if bid[g1] not in (body1, body2):
            continue
        for g2 in range(m.ngeom):
            if bid[g2] != (body2 if bid[g1] == body1 else body1) or bid[g1] == bid[g2]:
                continue
            if gt[g1] <= gt[g2] and (gt[g1], gt[g2]) in _NUM_SLOTS:
                pairs.append((g1, g2))
    return pairs


def contact_rows_per(m: PhysicsModel) -> int:
    return 4 if m.cone_pyramidal else 3


def num_constraint_rows(m: PhysicsModel) -> int:
    """Constraint rows of one step (solver.num_constraint_rows)."""
    ncon = num_contact_slots(m) if m.contact_enabled else 0
    return num_noncontact_rows(m) + contact_rows_per(m) * ncon


def lane_supported(m: PhysicsModel) -> None:
    """Raise ``NotImplementedError`` naming every feature of ``m`` that this
    port's lanes step does not cover. Nothing is dropped silently."""
    missing = []
    pairs = sorted({(m.geom_type[g1], m.geom_type[g2]) for g1, g2 in m.collision_pairs})
    if m.contact_enabled:
        bad = [p for p in pairs if p not in SLOTS_PER_PAIR]
        if bad:
            missing.append(f"collision pair types {bad} (ported: {sorted(SLOTS_PER_PAIR)})")
    eq_other = sorted({t for t in m.eq_type if t != EQ_JOINT})
    if eq_other:
        missing.append(f"equality constraints of types {eq_other}")
    for i in range(m.nsensor):
        if m.sensor_type[i] != SENSOR_DISTANCE:
            continue
        if m.sensor_objtype[i] != OBJ_BODY or m.sensor_reftype[i] != OBJ_BODY:
            missing.append(f"distance sensor {i} between objects other than two bodies")
            continue
        bad = sorted({(m.geom_type[a], m.geom_type[b]) for a, b in distance_sensor_pairs(m, i)} - set(SLOTS_PER_PAIR))
        if bad:
            missing.append(f"distance sensor {i} over pair types {bad} (ported: {sorted(SLOTS_PER_PAIR)})")
    for u in range(m.nu):
        if m.jnt_type[m.actuator_trnid[u]] not in (SLIDE, HINGE):
            missing.append(f"actuator {u} on a ball/free joint")
    if missing:
        raise NotImplementedError("lanes step does not cover: " + "; ".join(missing))


# ---------------------------------------------------------------------------
# lowering from MuJoCo
# ---------------------------------------------------------------------------


def _collision_pairs(m, pair_filter=None) -> Tuple[Tuple[int, int], ...]:
    """Candidate geom pairs under MuJoCo's filtering rules (same logic as
    judo_tpu/physics/model.py:_collision_pairs)."""
    pairs = []
    weld = m.body_weldid
    for g1 in range(m.ngeom):
        for g2 in range(g1 + 1, m.ngeom):
            b1, b2 = m.geom_bodyid[g1], m.geom_bodyid[g2]
            if weld[b1] == weld[b2]:
                continue
            wp1 = weld[m.body_parentid[weld[b1]]]
            wp2 = weld[m.body_parentid[weld[b2]]]
            if (wp1 == weld[b2] and weld[b2] != 0) or (wp2 == weld[b1] and weld[b1] != 0):
                continue
            if not (
                (m.geom_contype[g1] & m.geom_conaffinity[g2])
                or (m.geom_contype[g2] & m.geom_conaffinity[g1])
            ):
                continue
            if pair_filter is not None and not pair_filter(m, g1, g2):
                continue
            t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
            pairs.append((g1, g2) if t1 <= t2 else (g2, g1))
    return tuple(pairs)


def _masks(m) -> dict:
    """Ancestry masks of put_model (judo_tpu/physics/model.py:264-306)."""
    nv = m.nv
    mask = np.zeros((nv, nv))
    for i in range(nv):
        j = i
        while j >= 0:
            mask[i, j] = 1.0
            j = m.dof_parentid[j]
    body_dof = np.zeros((m.nbody, nv))
    for b in range(m.nbody):
        bb = b
        while bb > 0:
            d0 = m.body_dofadr[bb]
            body_dof[b, d0 : d0 + m.body_dofnum[bb]] = 1.0
            bb = m.body_parentid[bb]
    subtree = np.eye(m.nbody)
    for b in range(m.nbody - 1, 0, -1):
        subtree[m.body_parentid[b]] += subtree[b]
    subtree = np.minimum(subtree, 1.0)
    dofdot = np.zeros((nv, nv))
    for i in range(nv):
        jnt = int(m.dof_jntid[i])
        jt = int(m.jnt_type[jnt])
        dadr = int(m.jnt_dofadr[jnt])
        if jt == FREE and i - dadr < 3:
            continue
        j = int(m.dof_parentid[i])
        while j >= 0:
            dofdot[i, j] = 1.0
            j = int(m.dof_parentid[j])
        if jt == BALL:
            dofdot[i, dadr : dadr + 3] = 0.0
        elif jt == FREE:
            dofdot[i, dadr + 3 : dadr + 6] = 0.0
            dofdot[i, dadr : dadr + 3] = 1.0
    return {"dof_ancestor_mask": mask, "body_dof_mask": body_dof, "subtree_mask": subtree, "dofdot_mask": dofdot}


def put_model(
    mj_model,
    dtype: Any = np.float32,
    solver_iterations: int | None = None,
    collision_pair_filter=None,
) -> PhysicsModel:
    """Lower a compiled ``mujoco.MjModel`` (same lowering as
    ``judo_tpu.physics.model.put_model``)."""
    import mujoco

    m = mj_model
    disable = int(m.opt.disableflags)
    static = {
        "nq": m.nq, "nv": m.nv, "nu": m.nu, "nbody": m.nbody, "njnt": m.njnt,
        "ngeom": m.ngeom, "nsite": m.nsite, "nsensor": m.nsensor,
        "nsensordata": m.nsensordata,
        "integrator": int(m.opt.integrator),
        "cone_pyramidal": int(m.opt.cone) == _CONE_PYRAMIDAL,
        "contact_enabled": not (disable & _DSBL_CONTACT),
        "limit_enabled": not (disable & _DSBL_LIMIT),
        "gravity_enabled": not (disable & _DSBL_GRAVITY),
        "solver_iterations": int(m.opt.iterations) if solver_iterations is None else int(solver_iterations),
        "body_parentid": _t(m.body_parentid), "body_rootid": _t(m.body_rootid),
        "body_jntadr": _t(m.body_jntadr), "body_jntnum": _t(m.body_jntnum),
        "body_dofadr": _t(m.body_dofadr), "body_dofnum": _t(m.body_dofnum),
        "jnt_type": _t(m.jnt_type), "jnt_qposadr": _t(m.jnt_qposadr),
        "jnt_dofadr": _t(m.jnt_dofadr), "jnt_bodyid": _t(m.jnt_bodyid),
        "jnt_limited": _t(m.jnt_limited), "jnt_actfrclimited": _t(m.jnt_actfrclimited),
        "dof_bodyid": _t(m.dof_bodyid), "dof_jntid": _t(m.dof_jntid),
        "dof_parentid": _t(m.dof_parentid), "geom_type": _t(m.geom_type),
        "geom_bodyid": _t(m.geom_bodyid), "geom_condim": _t(m.geom_condim),
        "geom_priority": _t(m.geom_priority), "site_bodyid": _t(m.site_bodyid),
        "actuator_trnid": _t(m.actuator_trnid[:, 0]), "sensor_type": _t(m.sensor_type),
        "sensor_objtype": _t(m.sensor_objtype), "sensor_objid": _t(m.sensor_objid),
        "sensor_adr": _t(m.sensor_adr), "sensor_dim": _t(m.sensor_dim),
        "sensor_reftype": _t(m.sensor_reftype), "sensor_refid": _t(m.sensor_refid),
        "sensor_objname": tuple(
            mujoco.mj_id2name(m, int(m.sensor_objtype[i]), int(m.sensor_objid[i])) or ""
            for i in range(m.nsensor)
        ),
        "neq": m.neq, "eq_type": _t(m.eq_type), "eq_obj1id": _t(m.eq_obj1id),
        "eq_obj2id": _t(m.eq_obj2id),
        "collision_pairs": _collision_pairs(m, collision_pair_filter),
    }
    arrays = {"timestep": m.opt.timestep, "gravity": m.opt.gravity, "impratio": m.opt.impratio}
    arrays.update(_masks(m))
    for name in ARRAY_FIELDS:
        if name not in arrays:
            arrays[name] = getattr(m, name)
    return physics_model_from_numpy(static, arrays, dtype=dtype)


def physics_model_from_numpy(static: dict, arrays: dict, dtype: Any = None) -> PhysicsModel:
    """Build a ``PhysicsModel`` from static fields and numpy arrays.

    This is how a JAX ``PhysicsModel`` crosses to the port: pass its static
    fields and ``np.asarray`` of each array leaf. ``dtype`` defaults to the
    dtype of ``arrays["qpos0"]``.
    """
    if dtype is None:
        dtype = np.asarray(arrays["qpos0"]).dtype
    np_dtype = np.dtype(dtype) if not isinstance(dtype, torch.dtype) else (
        np.dtype(np.float64) if dtype == torch.float64 else np.dtype(np.float32)
    )
    kw: dict = {}
    for name in STATIC_FIELDS:
        v = static[name]
        if name == "collision_pairs":
            kw[name] = tuple((int(a), int(b)) for a, b in np.asarray(v, np.int64).reshape(-1, 2))
        elif name == "sensor_objname":
            kw[name] = tuple(str(s) for s in v)
        elif name in _BOOL_STATICS:
            kw[name] = bool(v)
        elif name in _INT_STATICS:
            kw[name] = int(v)
        else:
            kw[name] = _t(v)  # per-object tables: body_*, jnt_*, dof_*, ...
    for name in ARRAY_FIELDS:
        a = np.asarray(arrays[name])
        kw[name] = a.astype(bool) if name in _BOOL_ARRAYS else a.astype(np_dtype)
    return PhysicsModel(**kw)


def model_to_numpy(m: PhysicsModel) -> tuple[dict, dict]:
    """(static, arrays) of a model: the inverse of physics_model_from_numpy."""
    static = {name: getattr(m, name) for name in STATIC_FIELDS}
    arrays = {name: np.asarray(getattr(m, name)) for name in ARRAY_FIELDS}
    return static, arrays


# ---------------------------------------------------------------------------
# mujoco-free snapshots
# ---------------------------------------------------------------------------


def snapshot_dict(m: PhysicsModel, extras: dict | None = None) -> dict:
    """Flat dict of numpy arrays holding a float64 model and ``extras``
    (saved with ``np.savez``)."""
    m64 = m.astype(np.float64)
    static, arrays = model_to_numpy(m64)
    out: dict = {}
    for k, v in static.items():
        if k == "collision_pairs":
            out["s_" + k] = np.asarray(v, np.int64).reshape(-1, 2)
        elif k == "sensor_objname":
            out["s_" + k] = np.asarray(v, dtype=str)
        else:
            out["s_" + k] = np.asarray(v, np.int64)
    for k, v in arrays.items():
        out["a_" + k] = np.asarray(v)
    for k, v in (extras or {}).items():
        out["x_" + k] = np.asarray(v)
    return out


def load_snapshot(path, dtype: Any = np.float32) -> tuple[PhysicsModel, dict]:
    """(model in ``dtype``, extras) from a file written from snapshot_dict."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    static = {k[2:]: v for k, v in data.items() if k.startswith("s_")}
    arrays = {k[2:]: v for k, v in data.items() if k.startswith("a_")}
    extras = {k[2:]: v for k, v in data.items() if k.startswith("x_")}
    return physics_model_from_numpy(static, arrays, dtype=dtype), extras


__all__ = [
    "PhysicsModel", "PhysicsState", "make_state", "put_model", "physics_model_from_numpy",
    "model_to_numpy", "snapshot_dict", "load_snapshot", "lane_supported",
    "num_constraint_rows", "num_noncontact_rows", "num_contact_slots", "limit_joints",
]
