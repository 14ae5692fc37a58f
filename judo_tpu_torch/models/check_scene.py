"""A small scene that holds the lanes step's rarer features, for holding the
kernels against their plain versions: sphere-sphere and sphere-capsule
contacts, springs on a free and on a ball joint, and actuator force limits on
both (the ball joint's range excludes zero, so its clamp shows as a constant
torque on each of its three dofs). MuJoCo compiles ``actuatorfrclimited`` on
scalar joints only, so the lowering sets the flag of the free and the ball
joint itself (``LIMITED_JOINTS``), as a model built another way may carry it.
No task plans the scene.

Where ``mujoco`` is installed the model is lowered from ``CHECK_SCENE_XML``;
elsewhere it is read from the committed snapshot ``check_scene.npz``, which
``python -m judo_tpu_torch.models.export_snapshot`` writes.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from judo_tpu_torch.physics.model import PhysicsModel, load_snapshot, put_model, snapshot_dict

SNAPSHOT_PATH = Path(__file__).resolve().parent / "check_scene.npz"

CHECK_SCENE_XML = """
<mujoco model="check_scene">
  <option timestep="0.01"/>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 0.05"/>
    <body name="ball" pos="0 0 0.05">
      <joint name="ball_free" type="free" stiffness="2" actuatorfrcrange="-1 1" actuatorfrclimited="true"/>
      <geom name="ball" type="sphere" size="0.05" mass="0.2"/>
    </body>
    <body name="pendulum" pos="0 0 0.24">
      <joint name="pendulum_ball" type="ball" stiffness="0.5" damping="0.02" actuatorfrcrange="0.01 0.05"
             actuatorfrclimited="true"/>
      <geom name="bob" type="sphere" size="0.04" pos="0 0 -0.1" mass="0.1"/>
      <geom name="rod" type="capsule" fromto="0 0 0 0 0 -0.06" size="0.015" mass="0.02"/>
    </body>
    <body name="pusher" pos="0.06 0 0.2">
      <joint name="pusher_x" type="slide" axis="1 0 0" damping="0.5"/>
      <geom name="pusher" type="sphere" size="0.03" mass="0.05"/>
    </body>
  </worldbody>
  <actuator>
    <motor joint="pusher_x" ctrlrange="-1 1" gear="1"/>
  </actuator>
</mujoco>
"""


# Joints whose actuator force is clamped to their actuatorfrcrange: the free
# joint and the ball joint.
LIMITED_JOINTS = (0, 1)


def model_from_mujoco() -> PhysicsModel:
    """The float64 model lowered with mujoco, the force limits of
    ``LIMITED_JOINTS`` set."""
    import mujoco

    m = put_model(mujoco.MjModel.from_xml_string(CHECK_SCENE_XML), dtype=np.float64)
    limited = tuple(int(j in LIMITED_JOINTS or v) for j, v in enumerate(m.jnt_actfrclimited))
    return dataclasses.replace(m, jnt_actfrclimited=limited, _packed={})


def snapshot() -> dict:
    """The snapshot's arrays, built from the MJCF now."""
    return snapshot_dict(model_from_mujoco())


def load(dtype=np.float64) -> PhysicsModel:
    """The model in ``dtype``: lowered from the MJCF where mujoco is installed,
    else read from the committed snapshot."""
    try:
        import mujoco  # noqa: F401
    except ImportError:
        return load_snapshot(SNAPSHOT_PATH, dtype=dtype)[0]
    return model_from_mujoco().astype(dtype)
