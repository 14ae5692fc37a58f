"""Task base: the planning model plus a pure batched reward (the mujoco-free
part of ``judo_tpu/tasks/base.py``).

A task owns its lowered planning model, in the task's ``dtype``, and the
host-side state the controller plans from (``qpos``, ``qvel``, ``time``).
Where ``mujoco`` is installed the model is lowered from the task's MJCF with
``put_model``; elsewhere it is read from a committed snapshot of the same
lowering (``judo_tpu_torch/models/*.npz``).

The snapshot also holds what a scene draws and the planning model does not
(``render_fields``: names, colours, contact types, mesh triangles), so the
GUI draws a task without mujoco and without building it.

Tasks live on the card unless the caller asks for the CPU: ``device``
defaults to ``"cuda"``, and ``resolve_device`` refuses it, naming the way
out, where no CUDA GPU exists.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Generic, TypeVar

import numpy as np
import torch

from judo_tpu_torch.physics.model import (
    GEOM_MESH, SENSOR_FRAMEPOS, PhysicsModel, load_snapshot, put_model, resolve_device, snapshot_dict,
)

SNAPSHOT_DIR = Path(__file__).resolve().parents[1] / "models"


@dataclass
class TaskConfig:
    """Base task configuration dataclass."""


ConfigT = TypeVar("ConfigT", bound=TaskConfig)


def config_to_params(cfg: Any, dtype: torch.dtype, device: Any) -> dict[str, Any]:
    """Numeric config fields as tensors (bools and strings stay host-side)."""
    out: dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            out[f.name] = config_to_params(v, dtype, device)
        elif isinstance(v, (bool, str)):
            continue
        elif isinstance(v, (int, float, np.ndarray, np.floating, np.integer)):
            out[f.name] = torch.as_tensor(v, dtype=dtype, device=device)
    return out


def _config_flags(cfg: Any) -> tuple:
    """The bool and str fields of a config dataclass, nested ones included."""
    out = []
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            out.append((f.name, _config_flags(v)))
        elif isinstance(v, (bool, str)):
            out.append((f.name, v))
    return tuple(out)


def trace_sensors_from_mujoco(mj_model) -> list[int]:
    """Framepos sensors whose name contains 'trace' (controller.get_trace_sensor_ids)."""
    import mujoco

    ids = []
    for i in range(mj_model.nsensor):
        if int(mj_model.sensor_type[i]) != SENSOR_FRAMEPOS:
            continue
        name = mujoco.mj_id2name(mj_model, mujoco.mjtObj.mjOBJ_SENSOR, i)
        if name and "trace" in name:
            ids.append(i)
    return ids


# A mesh with more faces than this is drawn as its convex hull (judo_tpu/visualizers/scene.py:104-124).
MESH_MAX_FACES = 3000


def _mesh_triangles(mj, mesh_id: int) -> np.ndarray:
    """(F, 3, 3) triangle soup of a compiled mesh; a large mesh decimated to
    its convex hull, or cut to its first faces where scipy cannot hull it."""
    va, vn = int(mj.mesh_vertadr[mesh_id]), int(mj.mesh_vertnum[mesh_id])
    fa, fn = int(mj.mesh_faceadr[mesh_id]), int(mj.mesh_facenum[mesh_id])
    verts = np.asarray(mj.mesh_vert[va : va + vn], np.float64)
    faces = np.asarray(mj.mesh_face[fa : fa + fn], np.int64)
    if fn > MESH_MAX_FACES:
        try:
            from scipy.spatial import ConvexHull

            hull = ConvexHull(verts)
            verts, faces = hull.points, hull.simplices
        except Exception:  # noqa: BLE001 — any failure of the hull falls back to truncation, as in the JAX scene
            faces = faces[:MESH_MAX_FACES]
    return verts[faces]


def render_fields(mj) -> dict:
    """What a scene draws of a compiled ``mujoco.MjModel`` beyond the planning
    model: ``body_names`` and ``geom_names`` ('' where unnamed),
    ``geom_rgba`` (float32, as mujoco holds it), ``geom_contype``, and the
    triangles of every mesh geom, ``geom_mesh_tri`` (F, 3, 3), geom g's rows
    from ``geom_mesh_tri_adr[g]`` to ``geom_mesh_tri_adr[g + 1]`` (none for
    a geom that is not a mesh or names no mesh)."""
    import mujoco

    def names(obj, n: int) -> np.ndarray:
        return np.asarray([mujoco.mj_id2name(mj, obj, i) or "" for i in range(n)], dtype=str)

    tris = []
    for g in range(mj.ngeom):
        mesh_id = int(mj.geom_dataid[g])
        if int(mj.geom_type[g]) == GEOM_MESH and 0 <= mesh_id < mj.nmesh:
            tris.append(_mesh_triangles(mj, mesh_id))
        else:
            tris.append(np.zeros((0, 3, 3)))
    return {
        "body_names": names(mujoco.mjtObj.mjOBJ_BODY, mj.nbody),
        "geom_names": names(mujoco.mjtObj.mjOBJ_GEOM, mj.ngeom),
        "geom_rgba": np.asarray(mj.geom_rgba).copy(),
        "geom_contype": np.asarray(mj.geom_contype, np.int64).copy(),
        "geom_mesh_tri": np.concatenate(tris).reshape(-1, 3, 3),
        "geom_mesh_tri_adr": np.cumsum([0] + [len(t) for t in tris]).astype(np.int64),
    }


def model_from_mujoco(xml: str, solver_iterations: int, collision_pair_filter=None) -> tuple[PhysicsModel, dict]:
    """(float64 planning model, extras) lowered with mujoco from an MJCF string;
    the extras hold the trace sensors, the mocap bodies and ``render_fields``."""
    import mujoco

    mj = mujoco.MjSpec.from_string(xml).compile()
    m = put_model(mj, dtype=np.float64, solver_iterations=solver_iterations, collision_pair_filter=collision_pair_filter)
    trace = trace_sensors_from_mujoco(mj)
    mocap = sorted((b for b in range(mj.nbody) if mj.body_mocapid[b] >= 0), key=lambda b: mj.body_mocapid[b])
    extras = {
        "timestep": np.float64(mj.opt.timestep),
        "trace_sensor_ids": np.asarray(trace, np.int64),
        "trace_sensor_adr": np.asarray([int(mj.sensor_adr[i]) for i in trace], np.int64),
        "mocap_body_ids": np.asarray(mocap, np.int64),
        **render_fields(mj),
    }
    return m, extras


class Task(Generic[ConfigT]):
    """Planning model + pure reward; subclasses set ``name``, ``config_t`` and
    implement ``reward``, ``model_xml`` and ``_model_from_mujoco``.

    The host-side state a plant steps is ``qpos``, ``qvel``, ``time`` and the
    mocap bodies' ``mocap_pos`` and ``mocap_quat``; the plant hooks
    (``pre_sim_step``, ``post_sim_step``, ``get_sim_metadata``) read and write
    it."""

    name: str
    config_t: type[ConfigT]
    planning_solver_iterations: int = 25

    def __init__(self, device: Any = "cuda", dtype: torch.dtype = torch.float32) -> None:
        self.device = resolve_device(device)
        self.config = self.config_t()
        self.dtype = dtype
        m64, extras = self._model_or_snapshot()
        self.extras = extras
        self.planning_model = m64.astype(np.float64 if dtype == torch.float64 else np.float32)
        self.time = 0.0
        self.qpos = np.asarray(m64.qpos0, np.float64).copy()
        self.qvel = np.zeros(m64.nv)
        mocap = np.asarray(extras["mocap_body_ids"], np.int64)
        self.mocap_body_ids = mocap
        self.mocap_pos = np.asarray(m64.body_pos, np.float64)[mocap].copy()
        self.mocap_quat = np.asarray(m64.body_quat, np.float64)[mocap].copy()
        self._constants: dict = {}

    # --- model source ---
    @classmethod
    def snapshot_path(cls) -> Path:
        return SNAPSHOT_DIR / f"{cls.name}.npz"

    @classmethod
    def snapshot(cls) -> dict:
        """Snapshot arrays of this task's model built from mujoco now."""
        return snapshot_dict(*cls._model_from_mujoco())

    @classmethod
    def model_xml(cls) -> str:
        """The MJCF of the planning model, as a string."""
        raise NotImplementedError

    @classmethod
    def plant_xml(cls) -> str:
        """The MJCF a MuJoCo plant integrates: the planning model unless the
        task names a finer one (the JAX task's ``sim_model``)."""
        return cls.model_xml()

    @classmethod
    def _model_from_mujoco(cls) -> tuple[PhysicsModel, dict]:
        raise NotImplementedError

    def _model_or_snapshot(self) -> tuple[PhysicsModel, dict]:
        """(float64 model, extras) from mujoco where it is installed, else
        from the committed snapshot."""
        try:
            import mujoco  # noqa: F401
        except ImportError:
            return load_snapshot(self.snapshot_path(), dtype=np.float64)
        return self._model_from_mujoco()

    # --- host-side properties ---
    @property
    def nu(self) -> int:
        return self.planning_model.nu

    @property
    def nq(self) -> int:
        return self.planning_model.nq

    @property
    def nv(self) -> int:
        return self.planning_model.nv

    @property
    def physics_substeps(self) -> int:
        return 1

    @property
    def uses_locomotion_policy(self) -> bool:
        """True where a policy in the rollout maps commands to ctrl."""
        return False

    @property
    def dt(self) -> float:
        return float(self.extras["timestep"]) * self.physics_substeps

    @property
    def trace_sensor_ids(self) -> list[int]:
        return [int(i) for i in self.extras["trace_sensor_ids"]]

    @property
    def trace_sensor_adr(self) -> list[int]:
        return [int(i) for i in self.extras["trace_sensor_adr"]]

    @property
    def actuator_ctrlrange(self) -> np.ndarray:
        """Ctrl limits with unlimited actuators mapped to +-inf."""
        m = self.planning_model
        limits = np.asarray(m.actuator_ctrlrange, np.float64).copy()
        limits[~np.asarray(m.actuator_ctrllimited, bool)] = np.array([-np.inf, np.inf])
        return limits

    def reset(self) -> None:
        self.qpos = np.asarray(self.planning_model.qpos0, np.float64).copy()
        self.qvel = np.zeros(self.nv)
        self.time = 0.0

    # --- device-side pure functions ---
    def on_device(self, name: str, values, like: torch.Tensor) -> torch.Tensor:
        """Host values as a tensor on ``like``'s device and dtype, uploaded
        once per distinct value: a copy from pageable host memory waits for
        the device's queue, so an upload on every solve would serialize
        pipelined solves. Each value's tensor is kept: a captured solve graph
        reads the one it was captured with, and ``solve_key`` names the
        values a reward reads."""
        values = np.asarray(values, np.float64)
        key = (name, like.dtype, like.device, values.shape, values.tobytes())
        held = self._constants.get(key)
        if held is None:
            held = self._constants[key] = torch.as_tensor(values, dtype=like.dtype, device=like.device)
        return held

    def solve_key(self) -> tuple:
        """The Python values that ``reward`` and ``task_to_sim_ctrl`` read when
        they run, beyond ``task_params``: the config's bools and strings (which
        ``task_params`` leaves out) and the task's class. A captured solve bakes
        them in, so they key the controller's solve cache; a task whose reward
        reads an attribute of its own adds it."""
        return (f"{type(self).__module__}.{type(self).__qualname__}", _config_flags(self.config))

    def task_params(self) -> dict[str, Any]:
        return config_to_params(self.config, self.dtype, self.device)

    def reward(self, states, sensors, controls, params, system_metadata=None) -> torch.Tensor:
        """(R, T, nq+nv), (R, T, nsensordata), (R, T, nu) -> (R,)."""
        raise NotImplementedError

    def pre_rollout(self, curr_state: np.ndarray) -> dict[str, Any]:
        return {}

    def post_rollout(self, states, sensors, controls, system_metadata=None) -> None:
        """Host hook after a solve (does nothing by default)."""

    def pre_sim_step(self) -> None:
        """Plant hook before each plant step (does nothing by default)."""

    def post_sim_step(self) -> None:
        """Plant hook after each plant step (does nothing by default)."""

    def get_sim_metadata(self) -> dict[str, Any]:
        """Plant -> controller metadata, sent with every state message."""
        return {}

    def optimizer_warm_start(self) -> np.ndarray:
        return np.zeros(self.nu)

    def task_to_sim_ctrl(self, controls: torch.Tensor) -> torch.Tensor:
        return controls
