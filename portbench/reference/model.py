"""The physics model of the benchmark's reference: the benchmark's frozen copy
of the model half of ``judo_tpu_torch/physics/model.py``, loaded from a task's
snapshot file (``judo_tpu_torch/models/<task>.npz``, read as data). Static
topology stays Python tuples, array fields are host numpy in the model's
dtype. The lowering from MuJoCo is left out: the card's machine has no
``mujoco``, and the snapshot is the model both sides read.
"""

from __future__ import annotations

from dataclasses import dataclass
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


def load_snapshot(path, dtype: Any = np.float32) -> tuple[PhysicsModel, dict]:
    """(model in ``dtype``, extras) from a file written from snapshot_dict."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    static = {k[2:]: v for k, v in data.items() if k.startswith("s_")}
    arrays = {k[2:]: v for k, v in data.items() if k.startswith("a_")}
    extras = {k[2:]: v for k, v in data.items() if k.startswith("x_")}
    return physics_model_from_numpy(static, arrays, dtype=dtype), extras
