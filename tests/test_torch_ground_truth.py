"""The port's plain lanes rollout held against MuJoCo's ``mj_step``, float64,
with the scenes, inputs, horizons and tolerances of the JAX package's
ground-truth checks (``tests/test_physics/test_parity.py``: cartpole T 200,
a tumbling free body T 300, a sphere-plane impact with friction T 150, a
joint limit T 150, cylinder_push T 100; ``test_scene_parity.py``: leap_cube
and fr3_pick over 50 steps). Each rollout runs the model's own solver
iterations.

Those tolerances were set for the JAX package's vmap formulation, which the
port does not have. So every case also runs JAX's lanes path
(``rollout_lanes(backend="xla")``) on the same inputs, and the port equals it
within 1e-9. Where JAX's lanes path itself misses a tolerance (leap_cube
0.402 against 0.03, fr3_pick 0.0522 against 0.05; ROADMAP.md, "The reference
behaves as follows"), the case pins that miss and holds the port's error
against ``mj_step`` to the lanes path's within 1e-9.

On leap_cube the two free-running trajectories part by up to 5e-9: at the
model's 100 iterations the solve converges, APGD's restart sum turns to
rounding noise, and the two restart at different iterations
(``test_torch_full_horizon_twin.py::test_apgd_restart_at_rounding_level``);
the cube's flight amplifies that. There the port's step is held against
JAX's step by step instead, each from JAX's state and carried forces and
probe: within 1e-9 at all but 2 of the 50 steps, and at those two (gaps of
7e-9 and 4e-9) within 1e-9 once both solve the same step to convergence. fr3_pick's distance sensors run JAX's
with a pair axis (``test_torch_collision.py:patched_jax_distance_sensor``).
"""

from contextlib import nullcontext

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from judo_tpu.physics import lane_step as jls
from judo_tpu.physics import put_model as jax_put_model
from judo_tpu.physics.pallas_step import rollout_lanes as jax_rollout_lanes
from judo_tpu.tasks import get_registered_tasks as jax_tasks
from judo_tpu_torch.physics import fused_rollout as fr
from judo_tpu_torch.physics import lane_step as ls
from judo_tpu_torch.physics.model import num_constraint_rows, put_model

from .test_physics import test_parity as tp
from .test_physics.test_scene_parity import _mj_trajectory
from .test_torch_collision import patched_jax_distance_sensor
from .torch_inputs import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (xml, qpos0, qvel0, T, tolerance, every element within it or only the largest)
PARITY = {
    "cartpole": (tp.CARTPOLE, [0.3, 2.5], [0.1, -0.2], 200, 1e-10, "allclose"),
    "free_body_tumbling": (tp.FREE_TUMBLE, [0, 0, 1, 1, 0, 0, 0], [0.3, -0.2, 0.5, 3.0, 2.0, 1.0], 300, 1e-9,
                           "allclose"),
    "sphere_plane_impact_friction": (tp.SPHERE_PLANE, [0, 0, 0.3, 1, 0, 0, 0], [0.5, 0.1, 0, 0.3, 0, 0], 150, 1e-6,
                                     "allclose"),
    "joint_limit": (tp.LIMIT_HIT, [0.0], [1.5], 150, 1e-10, "allclose"),
    "cylinder_push": (tp.CYLINDER_PUSH, [1.0, 0.0, 0.55, 0.0], [2.0, 0, 0, 0], 100, 2e-2, "max"),
}


def mj_states(mj, qpos0, qvel0, ctrl) -> np.ndarray:
    """(T, nq + nv) after each mj_step under ``ctrl`` (T, nu)."""
    d = mujoco.MjData(mj)
    d.qpos[:], d.qvel[:] = qpos0, qvel0
    out = []
    for u in ctrl:
        if mj.nu:
            d.ctrl[:] = u
        mujoco.mj_step(mj, d)
        out.append(np.concatenate([d.qpos, d.qvel]))
    return np.asarray(out)


def port_states(mj, qpos0, qvel0, ctrl) -> np.ndarray:
    pm = put_model(mj, dtype=np.float64)
    t = lambda x: torch.tensor(np.asarray(x, np.float64)[None])  # noqa: E731
    return fr.rollout_lanes(pm, t(qpos0), t(qvel0), t(ctrl)).states[0].numpy()


def jax_lanes_states(mj, qpos0, qvel0, ctrl, distance_patch: bool = False) -> np.ndarray:
    jm = jax_put_model(mj, dtype=jnp.float64)
    t = lambda x: jnp.asarray(np.asarray(x, np.float64)[None])  # noqa: E731
    with patched_jax_distance_sensor() if distance_patch else nullcontext():
        out = jax.jit(lambda a, b, c: jax_rollout_lanes(jm, a, b, c, backend="xla"))(t(qpos0), t(qvel0), t(ctrl))
    return np.asarray(out.states[0])


@pytest.mark.parametrize("case", sorted(PARITY))
def test_parity_scene_against_mj_step(case):
    xml, qpos0, qvel0, T, tol, how = PARITY[case]
    mj = mujoco.MjModel.from_xml_string(xml)
    ctrl = 0.5 * np.sin(0.05 * np.arange(T))[:, None] * np.ones((1, mj.nu))
    ref = mj_states(mj, qpos0, qvel0, ctrl)
    ours = port_states(mj, qpos0, qvel0, ctrl)
    lanes = jax_lanes_states(mj, qpos0, qvel0, ctrl)
    np.testing.assert_allclose(ours, lanes, atol=1e-9, rtol=0)
    assert np.abs(lanes - ref).max() < tol  # JAX's lanes path meets the vmap tolerance
    if how == "allclose":
        np.testing.assert_allclose(ours, ref, atol=tol)
    else:
        assert np.abs(ours - ref).max() < tol


# task -> (the JAX test's tolerance on qpos over 50 steps, JAX's lanes path's
# own error there, measured)
FLAGSHIP = {"leap_cube": (0.03, 0.40220), "fr3_pick": (0.05, 0.05219)}


def _stepwise_against_jax(mj, qpos0, qvel0, ctrl) -> list:
    """The port's step against JAX's lanes step along JAX's trajectory, each
    from JAX's state, forces and probe: the gap at each step, and at the
    steps where it exceeds 1e-9 the gap with both solved to convergence
    (300 iterations) from the same inputs."""
    jm, pm = jax_put_model(mj, dtype=jnp.float64), put_model(mj, dtype=np.float64)
    jstep = jax.jit(lambda q, v, u, f, w, it: jls.step_l(jm, q, v, u, f, solver_iterations=it, cw_v=w),
                    static_argnums=5)
    col = lambda x: np.asarray(x, np.float64)[:, None]  # noqa: E731
    nefc = num_constraint_rows(pm)
    q, v, f, w = col(qpos0), col(qvel0), np.zeros((nefc, 1)), np.ones((nefc, 1))
    gaps = []
    for u in ctrl:
        def gap(iterations):
            ref = [np.asarray(x) for x in jstep(*(jnp.asarray(x) for x in (q, v, col(u), f, w)), iterations)]
            out = ls.step_l(pm, *(torch.tensor(x) for x in (q, v, col(u), f)), iterations, cw_v=torch.tensor(w))
            worst = max(float(np.abs(getattr(out, name).numpy() - a).max())
                        for name, a in zip(("qpos", "qvel", "sensordata", "efc_force"), ref))
            return ref, worst

        ref, worst = gap(None)
        gaps.append((worst, gap(300)[1] if worst > 1e-9 else None))
        q, v, _, f, w = ref
    return gaps


@pytest.mark.parametrize("task_name", sorted(FLAGSHIP))
def test_flagship_scene_against_mj_step(task_name):
    tol, lanes_err = FLAGSHIP[task_name]
    task = jax_tasks()[task_name][0]()
    qpos0, qvel0, ctrl, ref, ncon = _mj_trajectory(task, 50)
    assert ncon >= 2  # contacts
    nq = task.model.nq
    ours = port_states(task.model, qpos0, qvel0, ctrl)
    lanes = jax_lanes_states(task.model, qpos0, qvel0, ctrl, distance_patch=task_name == "fr3_pick")
    err, err_lanes = (float(np.abs(x[:, :nq] - ref[:, :nq]).max()) for x in (ours, lanes))
    assert np.isfinite(ours).all() and err_lanes > tol and abs(err_lanes - lanes_err) < 1e-5  # the lanes path's miss
    assert abs(err - err_lanes) <= 1e-9
    if task_name == "leap_cube":
        gaps = _stepwise_against_jax(task.model, qpos0, qvel0, ctrl)
        parted = [(k, g, g300) for k, (g, g300) in enumerate(gaps) if g300 is not None]
        assert len(gaps) == 50 and len(parted) <= 3 and max(g for g, _ in gaps) < 1e-8  # restarts at rounding noise
        assert all(g300 <= 1e-9 for _, _, g300 in parted), parted  # the same forces, solved to convergence
    else:
        np.testing.assert_allclose(ours, lanes, atol=1e-9, rtol=0)
