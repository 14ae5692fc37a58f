"""The port's plain lanes rollout held against MuJoCo's ``mj_step`` on the
Spot object scenes (spot_box_push here, the two tire scenes in
``test_torch_ground_truth_tire.py``, each file a worker of its own), with
the inputs, horizon and tolerance of the JAX package's
``tests/test_physics/test_scene_parity.py``: 50 steps from the model's reset
under its ``_mj_trajectory`` controls, every qpos within 0.05 of
``mj_step``'s, float64, the model's own solver iterations.

Every case also runs JAX's lanes path (``rollout_lanes(backend="xla")``) on
the same inputs; it meets the tolerance too, and the port equals it within
1e-9. The two tire tasks share one model and reset, so they share the JAX
trajectory.
"""

import hashlib

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest

from judo_tpu.physics import put_model as jax_put_model
from judo_tpu.physics.pallas_step import rollout_lanes as jax_rollout_lanes
from judo_tpu.tasks import get_registered_tasks as jax_tasks

from .test_physics.test_scene_parity import _mj_trajectory
from .test_torch_ground_truth import port_states
from .torch_inputs import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

def _lanes_states(mj, qpos0, qvel0, ctrl, cache: dict) -> np.ndarray:
    """JAX's lanes trajectory, computed once per model and inputs in ``cache``."""
    buf = np.empty(mujoco.mj_sizeModel(mj), np.uint8)
    mujoco.mj_saveModel(mj, None, buf)
    key = hashlib.sha256(buf.tobytes() + b"".join(np.asarray(x, np.float64).tobytes() for x in (qpos0, qvel0, ctrl)))
    key = key.hexdigest()
    if key not in cache:
        jm = jax_put_model(mj, dtype=jnp.float64)
        t = lambda x: jnp.asarray(np.asarray(x, np.float64)[None])  # noqa: E731
        out = jax.jit(lambda a, b, c: jax_rollout_lanes(jm, a, b, c, backend="xla"))(t(qpos0), t(qvel0), t(ctrl))
        cache[key] = np.asarray(out.states[0])
    return cache[key]


def spot_scene_against_mj_step(task_name: str, lanes_cache: dict) -> None:
    task = jax_tasks()[task_name][0]()
    qpos0, qvel0, ctrl, ref, ncon = _mj_trajectory(task, 50)
    assert ncon >= 2  # contacts
    nq = task.model.nq
    ours = port_states(task.model, qpos0, qvel0, ctrl)
    lanes = _lanes_states(task.model, qpos0, qvel0, ctrl, lanes_cache)
    np.testing.assert_allclose(ours, lanes, atol=1e-9, rtol=0)
    assert np.abs(lanes[:, :nq] - ref[:, :nq]).max() < 0.05  # JAX's lanes path meets the tolerance
    assert np.isfinite(ours).all() and np.abs(ours[:, :nq] - ref[:, :nq]).max() < 0.05


def test_spot_box_push_against_mj_step():
    spot_scene_against_mj_step("spot_box_push", {})
