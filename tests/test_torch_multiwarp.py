"""K1 in blocks of W warps per rollout, on the CPU: the rollout kernel's body
built with g++ (``fused_rollout_host_twin``), whose ``Group<W>`` plays the
block's W x 32 threads in one thread in the card's partition and reduction
order, so these tests hold the arithmetic the card runs at W > 1.

- At W = 4 the twin agrees with the plain version in float64 within 1e-9 on
  fr3_pick (516 rows, five distance sensors), the check scene and
  cylinder_push, B 2, T 8, from onset forces of one plain step.
- On the same inputs the twin at W = 4 agrees with W = 1 within 1e-9, the
  full-horizon twin tests' limit: the folds and J^T x sum in another order
  at W > 1, and APGD restarts at rounding noise
  (``test_torch_full_horizon_twin.py``), so a tighter limit would fail on
  the order alone. On fr3_pick the orders do differ: W reaches the build.
- The rule that picks W from the solve's rollouts, the model's constraint
  rows and the card's SMs, and a two-shard solve launching each shard at the
  W of the whole batch.
- The launch counter by W, directly and through a solve graph's tally.
"""

import functools

import numpy as np
import pytest
import torch

from judo_tpu_torch import _build
from judo_tpu_torch.controller import Controller, ControllerConfig
from judo_tpu_torch.controller import controller as controller_module
from judo_tpu_torch.models import check_scene
from judo_tpu_torch.optimizers import MPPI, MPPIConfig
from judo_tpu_torch.parallel import make_rollout_mesh
from judo_tpu_torch.physics import fused_rollout as fr
from judo_tpu_torch.physics.model import num_constraint_rows
from judo_tpu_torch.tasks import get_registered_tasks

from .torch_inputs import one_torch_thread  # noqa: F401 (a fixture)
from .torch_inputs import lanes, scene_batch

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SCENES = {"fr3": ("fr3_pick", 40), "check": (None, 41), "cylinder_push": ("cylinder_push", 42)}
B, T = 2, 8


@functools.lru_cache(maxsize=None)
def _runs(scene: str):
    """(the plain version's outputs, {W: the twin's outputs}) on the scene's
    seeded batch, float64."""
    task, seed = SCENES[scene]
    if task is None:
        m = check_scene.load(np.float64)
    else:
        m = get_registered_tasks()[task][0](device="cpu", dtype=torch.float64).planning_model
    qp, qv, ct = lanes(*scene_batch(scene, m, B, T + 1, seed))
    zeros = torch.zeros((max(num_constraint_rows(m), 1), B), dtype=torch.float64)
    f0 = fr.rollout_lanes_reference(m, qp, qv, ct[:1], zeros, 1, 8)[3]  # onset forces from one step
    ct = ct[1:].contiguous()
    ref = fr.rollout_lanes_reference(m, qp, qv, ct, f0, 1, 8)
    twins = {w: fr.fused_rollout_host_twin(m, qp, qv, ct, f0, 1, 8, warps=w) for w in fr.ROLLOUT_WARPS}
    return ref, twins


def _close(got, want, what: str) -> None:
    for name, a, b in zip(("qpos", "qvel", "sensors", "efc0"), want, got):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-9, rtol=0, err_msg=f"{what} {name}")


@pytest.mark.parametrize("scene", list(SCENES))
def test_four_warp_twin_against_plain(scene):
    ref, twins = _runs(scene)
    assert float(ref[3].abs().max()) > 1e-3  # constraints carry force
    _close(twins[4], ref, f"{scene} W=4 vs plain")


@pytest.mark.parametrize("warps", fr.ROLLOUT_WARPS[1:])
@pytest.mark.parametrize("scene", list(SCENES))
def test_multiwarp_twin_against_one_warp(scene, warps):
    _, twins = _runs(scene)
    _close(twins[warps], twins[1], f"{scene} W={warps} vs W=1")
    if scene == "fr3":  # 516 rows: J^T x and the folds sum in another order
        assert any(not torch.equal(a, b) for a, b in zip(twins[warps], twins[1]))


def test_host_build_refuses_an_unbuilt_width():
    m = get_registered_tasks()["cylinder_push"][0](device="cpu", dtype=torch.float64).planning_model
    qp, qv, ct = lanes(*scene_batch("cylinder_push", m, 1, 1, 43))
    f0 = torch.zeros((max(num_constraint_rows(m), 1), 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="warps 3"):
        fr.fused_rollout_host_twin(m, qp, qv, ct, f0, warps=3)
    for warps in (2, 8):
        with pytest.raises(RuntimeError, match=f"no build at {warps} warps"):
            fr._launch(_build.load("host"), m, qp, qv, ct, f0, 1, 8, None, warps=warps)


@pytest.mark.parametrize("rollouts,sms,rows,warps", [
    (64, 132, 516, 4), (32, 132, 236, 4), (320, 132, 236, 1), (132, 132, 33, 4), (133, 132, 516, 1),
    (264, 132, 516, 1), (1056, 132, 236, 1), (1, 132, 40, 4), (32, 132, 32, 1), (32, 132, 24, 1), (32, 132, 2, 1)])
def test_rollout_warps_rule(rollouts, sms, rows, warps):
    """Fill the schedulers where the rows take more than one pass of a warp;
    one warp where they do not (cylinder_push's 24 rows, cartpole's 2)."""
    assert fr.rollout_warps(rollouts, sms, rows) == warps


def test_sm_count_off_the_card():
    assert fr.sm_count("cpu") is None


def test_sharded_solve_launches_at_the_whole_batch_width(monkeypatch):
    """leap (236 rows), R 8 over two shards on a card of 4 SMs: the whole
    batch puts 2 blocks on an SM (W = 1), a shard's 4 would put 1 (W = 4);
    both shards take 1."""
    seen = []
    real = controller_module.rollout_lanes

    def recording(*args):
        seen.append((args[1].shape[0], args[-1]))
        return real(*args)

    monkeypatch.setattr(controller_module, "sm_count", lambda dev: 4)
    monkeypatch.setattr(controller_module, "rollout_lanes", recording)
    task = get_registered_tasks()["leap_cube"][0](device="cpu", dtype=torch.float64)
    opt = MPPI(MPPIConfig(num_rollouts=8, num_nodes=4, sigma=0.2), task.nu)
    c = Controller(ControllerConfig(horizon=0.1), task, opt, seed=0, mesh=make_rollout_mesh(devices=["cpu"] * 2))
    c.update_action()
    assert c.last_shards == [("cpu", 4)] * 2 and fr.rollout_warps(4, 4, num_constraint_rows(task.planning_model)) == 4
    assert seen and all(s == (4, 1) for s in seen)


def test_launch_counter_by_width():
    def wrapper():
        pass

    wrapper.launches, wrapper.launches_by_warps = 0, {}
    fr.count_launch(wrapper, 4)
    with fr.tallied_launches() as tally:
        fr.count_launch(wrapper, 4)
        fr.count_launch(wrapper, 1)
    assert wrapper.launches == 1 and wrapper.launches_by_warps == {4: 1}
    assert tally == {(wrapper, 4): 1, (wrapper, 1): 1}
    for (w, warps), n in tally.items():  # as a solve graph's replay adds them
        fr.add_launches(w, 3 * n, warps)
    assert wrapper.launches == 7 and wrapper.launches_by_warps == {4: 4, 1: 3}
