"""The render scene of a task (counterpart of ``judo_tpu/visualizers/scene.py``).

The reference's ViserMjModel (judo/visualizers/model.py:38-302) turns a
model into scene nodes: a frame per body, primitive and mesh geoms with
their colours, and gold and purple elite trace segments. This module gives
the same structure as plain dataclasses, which the browser client draws
from their dict form; ``set_data`` moves the bodies to a state's frames.

The scene is read from a task's snapshot (``tasks/base.py:render_fields``
holds what the planning model does not: names, colours, contact types, mesh
triangles), so it needs neither mujoco nor a built task; a task without a
snapshot is lowered from its MJCF through mujoco. Nothing here touches the
card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from judo_tpu_torch.physics.model import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_ELLIPSOID, GEOM_MESH, GEOM_PLANE, GEOM_SPHERE, PhysicsModel,
    load_snapshot,
)

# trace colours (reference: elite gold, rest purple — visualizers/model.py:195-241)
TRACE_ELITE_RGBA = (1.0, 0.84, 0.0, 1.0)
TRACE_OTHER_RGBA = (0.5, 0.2, 0.8, 1.0)

_GEOM_TYPE_NAMES = {
    GEOM_PLANE: "plane",
    GEOM_SPHERE: "sphere",
    GEOM_CAPSULE: "capsule",
    GEOM_CYLINDER: "cylinder",
    GEOM_BOX: "box",
    GEOM_ELLIPSOID: "ellipsoid",
    GEOM_MESH: "mesh",
}


@dataclass
class SceneGeom:
    name: str
    body: str
    geom_type: str
    size: np.ndarray
    pos: np.ndarray  # local offset in body frame
    quat: np.ndarray
    rgba: np.ndarray
    mesh_tri: np.ndarray | None = None  # (F, 3, 3) triangle soup (mesh geoms)


@dataclass
class SceneBody:
    name: str
    body_id: int
    xpos: np.ndarray
    xquat: np.ndarray
    geoms: list[SceneGeom] = field(default_factory=list)


@dataclass
class SceneModel:
    """Body tree + geoms + live trace segments, updatable from sim states."""

    bodies: list[SceneBody]
    traces: np.ndarray | None = None  # (n, 2, 3) line segments
    num_elite_traces: int = 0

    def set_data(self, xpos: np.ndarray, xquat: np.ndarray) -> None:
        """Each body to its frame (ViserMjModel.set_data semantics)."""
        for b in self.bodies:
            b.xpos = xpos[b.body_id]
            b.xquat = xquat[b.body_id]

    def set_traces(self, segments: np.ndarray | None, num_elite: int = 0) -> None:
        self.traces = segments
        self.num_elite_traces = num_elite

    def to_dict(self) -> dict[str, Any]:
        """Wire form for web/remote clients."""
        return {
            "bodies": [
                {
                    "name": b.name,
                    "xpos": b.xpos.tolist(),
                    "xquat": b.xquat.tolist(),
                    "geoms": [
                        {
                            "name": g.name,
                            "type": g.geom_type,
                            "size": g.size.tolist(),
                            "pos": g.pos.tolist(),
                            "quat": g.quat.tolist(),
                            "rgba": g.rgba.tolist(),
                            **(
                                {"verts": np.round(g.mesh_tri.reshape(-1), 4).tolist()}
                                if g.mesh_tri is not None
                                else {}
                            ),
                        }
                        for g in b.geoms
                    ],
                }
                for b in self.bodies
            ],
            "traces": None if self.traces is None else self.traces.tolist(),
        }


def scene_source(task_cls) -> tuple[PhysicsModel, dict]:
    """(float64 model, extras) of a task class, without building the task:
    its committed snapshot, or, for a task that has none, its MJCF lowered
    through mujoco."""
    path = task_cls.snapshot_path()
    if path.exists():
        return load_snapshot(path, dtype=np.float64)
    return task_cls._model_from_mujoco()


def build_scene(m: PhysicsModel, extras: dict, show_collision_geoms: bool = True) -> SceneModel:
    """The render scene of a float64 model and its ``render_fields`` extras."""
    body_names = [str(n) or f"body_{b}" for b, n in enumerate(extras["body_names"])]
    body_geoms: dict[int, list[SceneGeom]] = {b: [] for b in range(m.nbody)}
    tri, tri_adr = extras["geom_mesh_tri"], extras["geom_mesh_tri_adr"]
    for g in range(m.ngeom):
        gtype = _GEOM_TYPE_NAMES.get(int(m.geom_type[g]))
        if gtype is None:
            continue
        if not show_collision_geoms and extras["geom_contype"][g] != 0:
            continue
        mesh_tri = None
        if gtype == "mesh":
            # a user's MJCF mesh renders as a triangle soup; a mesh geom that names no mesh is not drawn
            if tri_adr[g + 1] == tri_adr[g]:
                continue
            mesh_tri = tri[tri_adr[g] : tri_adr[g + 1]].copy()
        body_id = int(m.geom_bodyid[g])
        body_geoms[body_id].append(
            SceneGeom(
                name=str(extras["geom_names"][g]) or f"geom_{g}",
                body=body_names[body_id],
                geom_type=gtype,
                size=np.asarray(m.geom_size[g]).copy(),
                pos=np.asarray(m.geom_pos[g]).copy(),
                quat=np.asarray(m.geom_quat[g]).copy(),
                rgba=np.asarray(extras["geom_rgba"][g]).copy(),
                mesh_tri=mesh_tri,
            )
        )
    bodies = [
        SceneBody(
            name=body_names[b],
            body_id=b,
            xpos=np.asarray(m.body_pos[b]).copy(),
            xquat=np.asarray(m.body_quat[b]).copy(),
            geoms=body_geoms[b],
        )
        for b in range(m.nbody)
    ]
    return SceneModel(bodies=bodies)


def trace_segments_to_scene(
    scene: SceneModel, traces: np.ndarray, num_trace_sensors: int, sensor_rollout_size: int
) -> None:
    """Attach controller trace segments; the first rollout's segments are the
    elites (the controller packs them best-first)."""
    num_elite = num_trace_sensors * sensor_rollout_size
    scene.set_traces(traces, num_elite=min(num_elite, traces.shape[0]))
