"""The rollout mesh across two processes (``torch.distributed``, gloo on the
CPU): each rank holds a row of a (2, 2) hybrid mesh of ``cpu`` shards and
plans cylinder_push with MPPI at 16 rollouts, float64. The ranks start from
different numpy seeds: ``Controller.reset`` broadcasts rank 0's sampling seed,
so both sample rank 0's candidates. Rank 0's rewards and knots equal the
single-process unsharded solve's, bitwise, and both ranks' carries agree. The
ranks are spawned (``torch.multiprocessing``) on a free localhost port; a rank
that stalls fails the test after 120 s instead of hanging it.
"""

import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from judo_tpu_torch.controller import Controller, ControllerConfig
from judo_tpu_torch.optimizers import MPPI, MPPIConfig
from judo_tpu_torch.tasks import get_registered_tasks

SEED, R, TIMEOUT = 1234, 16, 120.0
STATE = np.array([0.0, 0.0, 0.45, 0.1, 0.2, -0.1, 0.3, 0.05])  # the cylinders in contact, moving


def _controller(mesh) -> Controller:
    task = get_registered_tasks()["cylinder_push"][0](device="cpu", dtype=torch.float64)
    opt = MPPI(MPPIConfig(num_rollouts=R, num_nodes=4, sigma=0.2), task.nu)
    cc = ControllerConfig(horizon=0.1, spline_order="zero", full_outputs=True)
    c = Controller(cc, task, opt, mesh=mesh)  # seed None: drawn from numpy, then rank 0's broadcast
    c.current_state = STATE.copy()
    c.update_action()
    return c


def _rank(rank: int, port: int, out: str) -> None:
    from judo_tpu_torch.parallel import initialize_distributed, make_rollout_mesh

    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", 2, rank)
    try:
        mesh = make_rollout_mesh(devices=["cpu"] * 4, hybrid=True, devices_per_host=2)
        np.random.seed(SEED + rank)
        c = _controller(mesh)
        np.savez(f"{out}/rank{rank}.npz", rewards=c.rewards, knots=c.nominal_knots, efc=c._carry.efc_warm.numpy(),
                 shards=np.asarray([b for _, b in c.last_shards]), shape=np.asarray(mesh.devices.shape))
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_two_process_mesh_equals_unsharded_solve(tmp_path):
    ctx = mp.start_processes(_rank, args=(_free_port(), str(tmp_path)), nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"a rank did not finish within {TIMEOUT:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    np.random.seed(SEED)
    ref = _controller(None)
    assert not torch.distributed.is_initialized()
    for z in ranks:
        assert z["shape"].tolist() == [2, 2] and z["shards"].tolist() == [4, 4]
        np.testing.assert_array_equal(z["efc"], ranks[0]["efc"])
        np.testing.assert_array_equal(z["rewards"], ranks[0]["rewards"])
        np.testing.assert_array_equal(z["knots"], ranks[0]["knots"])
    assert np.all(np.isfinite(ref.rewards)) and np.ptp(ref.rewards) > 0
    np.testing.assert_array_equal(ranks[0]["rewards"], ref.rewards)
    np.testing.assert_array_equal(ranks[0]["knots"], ref.nominal_knots)
    np.testing.assert_array_equal(ranks[0]["efc"], ref._carry.efc_warm.numpy())
