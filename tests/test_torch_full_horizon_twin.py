"""The CUDA kernels' own arithmetic (their bodies built with g++, the warp's
32 lanes played in one thread in the card's order) held against the plain
PyTorch versions over each planning path's full horizon, float64, within
1e-9:

- ``fused_rollout_host_twin`` (K1), 8 APGD iterations, onset forces from one
  plain step: leap T 100 (the 4-rollout batch of the 3-step check in
  ``test_torch_kernel_path.py``), cylinder_push T 52, fr3_pick T 252 with its
  five distance sensors, the check scene T 50;
- ``fused_policy_rollout_host_twin`` (K2), 100 policy ticks of 2 steps:
  spot_navigate, spot_box_push, spot_tire_roll, and spot_tire_upright with
  its tire tipped 0.5 rad onto its rim;
- ``physics_step_host_twin`` (K3) chained 100 times at one environment, the
  way the ``judo_tpu`` plant steps: each tick from the last one's state, a
  cold probe and zero forces, the planning model's own 25 iterations.

The twin sums in the warp's order and the plain version in its own, so the
two part by rounding. Two things make that rounding grow (ROADMAP.md, "The
reference behaves as follows"): a trajectory that shakes the cube hard
amplifies it step by step, and APGD's restart test compares a sum that is
rounding noise once the iterate has nearly converged, so the two may restart
at different iterations (``test_apgd_restart_at_rounding_level``).
"""

import numpy as np
import pytest
import torch

from judo_tpu_torch.models import check_scene
from judo_tpu_torch.physics import fused_rollout as fr
from judo_tpu_torch.physics import policy_rollout as pr
from judo_tpu_torch.physics.model import SENSOR_DISTANCE, num_constraint_rows
from judo_tpu_torch.tasks import get_registered_tasks

from .torch_inputs import one_torch_thread  # noqa: F401 (a fixture)
from .torch_inputs import lanes, leap_batch, object_inputs, policy_inputs, scene_batch

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TASK = {"leap": "leap_cube", "cylinder_push": "cylinder_push", "fr3": "fr3_pick"}


def _task(name: str):
    return get_registered_tasks()[name][0](device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("scene,B,T,seed", [("leap", 4, 100, 3), ("cylinder_push", 2, 52, 32),
                                            ("fr3", 2, 252, 33), ("check", 2, 50, 34)])
def test_rollout_host_twin_full_horizon(scene, B, T, seed):
    m = check_scene.load(np.float64) if scene == "check" else _task(TASK[scene]).planning_model
    qp, qv, ct = lanes(*scene_batch(scene, m, B, T + 1, seed))
    zeros = torch.zeros((max(num_constraint_rows(m), 1), B), dtype=torch.float64)
    f0 = fr.rollout_lanes_reference(m, qp, qv, ct[:1], zeros, 1, 8)[3]  # onset forces from one step
    ct = ct[1:].contiguous()
    ref = fr.rollout_lanes_reference(m, qp, qv, ct, f0, 1, 8)
    twin = fr.fused_rollout_host_twin(m, qp, qv, ct, f0, 1, 8)
    assert ref[0].shape[0] == T and float(ref[3].abs().max()) > 1e-3  # constraints carry force
    if scene == "fr3":
        rows = [m.sensor_adr[i] for i in range(m.nsensor) if m.sensor_type[i] == SENSOR_DISTANCE]
        assert len(rows) == 5 and float(ref[2][:, rows].min()) < float(ref[2][:, rows].max()) < 1.0  # under the cutoff
    for name, a, b in zip(("qpos", "qvel", "sensors", "efc0"), ref, twin):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-9, rtol=0, err_msg=name)


@pytest.mark.parametrize("scene", ["spot_navigate", "spot_box_push", "spot_tire_roll", "spot_tire_upright"])
def test_policy_rollout_host_twin_full_horizon(scene):
    task = _task(scene)
    T = 100
    if scene == "spot_navigate":
        x = policy_inputs(task.nv, T, seed=35, B=2)
    else:
        x = object_inputs(task, 2, T, seed=36)
    args = lanes(*x)
    ref = pr.policy_rollout_lanes_reference(task.planning_model, task.policy, *args, 2, 8)
    twin = pr.fused_policy_rollout_host_twin(task.planning_model, task.policy, *args, 2, 8)
    assert ref[0].shape[0] == T and np.isfinite(ref[0].numpy()).all()
    if scene != "spot_navigate":
        assert float((ref[0][-1, 26:29] - ref[0][0, 26:29]).abs().max()) > 1e-3  # the object moves
    for name, a, b in zip(("qpos", "qvel", "sensors", "pout"), ref, twin):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-9, rtol=0, err_msg=name)


def test_physics_step_host_twin_chained_as_the_plant():
    m = _task("leap_cube").planning_model
    assert m.solver_iterations == 25
    qp, qv, ct = lanes(*leap_batch(1, 100, seed=38))
    zeros = torch.zeros((num_constraint_rows(m), 1), dtype=torch.float64)
    ref, twin, force = (qp, qv), (qp, qv), 0.0
    for t in range(100):
        ref_out = fr.physics_step_reference(m, *ref, ct[t], zeros)
        twin_out = fr.physics_step_host_twin(m, *twin, ct[t], zeros)
        for name, a, b in zip(("qpos", "qvel", "sensors", "efc"), ref_out, twin_out):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-9, rtol=0, err_msg=f"tick {t} {name}")
        ref, twin, force = ref_out[:2], twin_out[:2], max(force, float(ref_out[3].abs().max()))
    assert force > 1e-2  # contacts carry force


def test_apgd_restart_at_rounding_level():
    """The plant's chain on another seed: at tick 92 the twin and the plain
    version, given the same state, part by ~7e-9 in qvel. From iteration 20
    on, APGD's restart sum grad . (f_new - f) is rounding noise (1e-15 to
    1e-18, of either sign), so the two restart at different iterations and
    stop at different unconverged iterates; with 100 iterations both reach
    the same forces."""
    m = _task("leap_cube").planning_model
    qp, qv, ct = lanes(*leap_batch(1, 100, seed=37))
    zeros = torch.zeros((num_constraint_rows(m), 1), dtype=torch.float64)
    state = (qp, qv)
    for t in range(92):
        state = fr.physics_step_reference(m, *state, ct[t], zeros)[:2]

    def gap(iterations):
        ref = fr.physics_step_reference(m, *state, ct[92], zeros, iterations)
        twin = fr.physics_step_host_twin(m, *state, ct[92], zeros, iterations)
        return float((ref[1] - twin[1]).abs().max())

    assert 1e-9 < gap(None) < 1e-8  # the plant's 25 iterations
    assert gap(100) < 1e-13
