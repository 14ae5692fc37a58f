"""Pipelined planning (``pipeline_depth > 0``) in the PyTorch port's
controller, on the CPU, against the same controller at depth 0 and against
the JAX package's closed-loop API.

Each controller plans cylinder_push with MPPI (8 rollouts, 4 knots, a 0.2 s
horizon) in float64, sampling through ``sample_from_noise`` on one numpy
noise array per call, so two controllers see the same noise. At depth d the
mirrors published after call n (times, knots, rewards, traces, the spline)
are depth 0's after call n - d, bitwise; the carried solver state equals
depth 0's after every call; after ``flush_pipeline`` everything equals depth
0's. ``update_states``, ``spline_data`` and ``update_traces`` behave as the
JAX controller's.
"""

import numpy as np
import pytest
import torch

from judo_tpu.app.structs import MujocoState as JaxMujocoState
from judo_tpu.controller import make_controller as jax_make_controller
from judo_tpu_torch.app.structs import MujocoState
from judo_tpu_torch.controller import make_controller

R, N, CALLS = 8, 4, 6


def _controller(depth: int):
    c = make_controller("cylinder_push", "mppi", device="cpu", dtype=torch.float64, seed=0)
    c.optimizer_cfg.num_rollouts, c.optimizer_cfg.num_nodes = R, N
    c.controller_cfg.horizon = 0.2
    c.controller_cfg.pipeline_depth = depth
    noise = np.random.default_rng(1).standard_normal((CALLS + 2, R - 1, N, c.task.nu))
    calls = iter(range(len(noise)))
    opt = c.optimizer
    opt.draw_noise = lambda g, out: out.copy_(torch.tensor(noise[next(calls)]))
    c.reset()
    return c


def _state(n: int) -> np.ndarray:
    """The simulation's state before call n: the pusher moving towards the cart."""
    return np.array([0.1 * n, 0.0, 0.45, 0.05, 0.5, 0.0, 0.0, 0.0])


def _published(c) -> tuple:
    """What the host reads, once the consumer has published what was handed to it."""
    for f in c._consume_futures:
        f.result()
    traces = None if c.traces is None else c.traces.copy()
    return c.times.copy(), c.nominal_knots.copy(), c.rewards.copy(), traces, c.action(c.times[0] + 0.05)


def _carry(c) -> list:
    k = c._carry
    return [k.times, k.nominal_knots, k.efc_warm, *(k.opt_state or {}).values()]


def _run(depth: int, calls: int = CALLS):
    """(published after each call, carry after each call, the controller)."""
    c = _controller(depth)
    published, carries = [_published(c)], []
    for n in range(calls):
        c.current_state, c.time = _state(n), 0.02 * n
        c.update_action()
        published.append(_published(c))
        carries.append([x.clone() for x in _carry(c)])
    return published, carries, c


def _assert_equal(a: tuple, b: tuple, what: str) -> None:
    for name, x, y in zip(("times", "knots", "rewards", "traces", "action"), a, b):
        if x is None or y is None:
            assert x is None and y is None, f"{what}: {name}"
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what}: {name}")


@pytest.fixture(scope="module")
def depth0():
    published, carries, c = _run(0)
    return published, carries, c


@pytest.mark.parametrize("depth", [1, 2])
def test_published_mirrors_lag_by_depth(depth0, depth):
    published0, _, _ = depth0
    published, _, c = _run(depth)
    assert c.last_plan_timing["sync_ms"] >= 0
    for n in range(1, CALLS + 1):  # after call n: depth 0's after call n - depth (the reset's before that)
        _assert_equal(published[n], published0[max(n - depth, 0)], f"depth {depth} after call {n}")
    assert len(c._pending) == depth


@pytest.mark.parametrize("depth", [1, 2])
def test_carry_does_not_lag(depth0, depth):
    _, carries0, _ = depth0
    _, carries, _ = _run(depth)
    for n, (ours, ref) in enumerate(zip(carries, carries0)):
        for k, (x, y) in enumerate(zip(ours, ref)):
            assert torch.equal(x, y), f"depth {depth} call {n} carry field {k}"


@pytest.mark.parametrize("depth", [1, 2])
def test_flush_pipeline_ends_on_depth_zero(depth0, depth):
    published0, _, c0 = depth0
    _, _, c = _run(depth)
    c.flush_pipeline()
    assert not c._pending and not c._consume_futures
    _assert_equal(_published(c), published0[-1], f"depth {depth} flushed")
    assert torch.equal(c.last_outputs.rewards, c0.last_outputs.rewards)
    c.flush_pipeline()  # nothing left: a no-op
    _assert_equal(_published(c), published0[-1], f"depth {depth} flushed twice")


def test_reset_drops_in_flight_solves():
    _, _, c = _run(2, calls=3)
    c.reset()
    assert not c._pending and not c._consume_futures
    c.flush_pipeline()  # no solve from before the reset is published after it
    ours, ref = _published(c), _published(_controller(2))
    for k in (0, 1, 4):  # times, knots and the spline: the reset's (rewards and traces keep the last solve's)
        np.testing.assert_array_equal(ours[k], ref[k])


def test_device_params_follow_config_values():
    """Task, optimizer and normalizer parameters, the control bounds and the
    time grids are kept between solves and made again when a value changes."""
    c = _controller(0)
    first = c._device_params()
    assert all(a is b for a, b in zip(first, c._device_params()))
    times = c._device_times()
    assert all(a is b for a, b in zip(times, c._device_times()))
    c.task.config.goal_pos = np.asarray(c.task.config.goal_pos) + 0.5
    c.optimizer.config.temperature = 2 * c.optimizer.config.temperature
    again = c._device_params()
    assert again[0] is not first[0] and again[1] is not first[1] and again[2] is first[2]
    np.testing.assert_array_equal(again[0]["goal_pos"].numpy(), c.task.config.goal_pos)
    assert float(again[1]["temperature"]) == c.optimizer.config.temperature
    c.controller_cfg.horizon = 0.4
    assert c._device_times()[1].shape[0] > times[1].shape[0]


@pytest.fixture(scope="module")
def jax_cylinder_push():
    return jax_make_controller("cylinder_push", "mppi")


def test_update_states_and_spline_data_match_jax(jax_cylinder_push):
    ours, ref = _controller(0), jax_cylinder_push
    ref.reset()
    rng = np.random.default_rng(7)
    qpos, qvel = rng.standard_normal(4), rng.standard_normal(4)
    meta = {"goal": np.array([0.3, 0.1])}
    for c, msg in ((ours, MujocoState), (ref, JaxMujocoState)):
        c.update_states(msg(1.25, qpos.copy(), qvel.copy(), None, None, None, None, dict(meta)))
    np.testing.assert_array_equal(ours.current_state, ref.current_state)
    assert ours.time == ref.time == ours.task.time == 1.25
    assert ours.system_metadata.keys() == ref.system_metadata.keys() == meta.keys()
    sd, jsd = ours.spline_data, ref.spline_data
    assert (sd.kind, jsd.kind) == (ours.spline_order, ref.spline_order) and sd.extrapolate == jsd.extrapolate
    np.testing.assert_array_equal(sd.x, ours.nominal_knots)
    np.testing.assert_array_equal(sd.t, ours.times)
    for t in (sd.t[0] - 1.0, sd.t[0] + 0.01, sd.t[-1] + 1.0):  # inside and beyond both ends
        np.testing.assert_array_equal(sd.spline()(t), ours.action(t))
    assert sd.spline()(sd.t[-1] + 1.0).shape == jsd.spline()(jsd.t[-1] + 1.0).shape


def test_update_traces_matches_jax(jax_cylinder_push):
    ours, ref = _controller(0), jax_cylinder_push
    tr = np.random.default_rng(8).standard_normal((3, 2, 5, 2, 3))
    ours.update_traces(None, tr)
    ref.update_traces(None, tr)
    np.testing.assert_array_equal(ours.traces, ref.traces)
    assert ours.traces.shape == (3 * 2 * 5, 2, 3)
    ours.update_traces(None, np.zeros((0, 0, 0, 2, 3)))
    ref.update_traces(None, np.zeros((0, 0, 0, 2, 3)))
    assert ours.traces is None and ref.traces is None
    ours.controller_cfg.full_outputs = True  # the solve's outputs keep the traces
    ours.update_action()
    published = ours.traces.copy()
    ours.update_traces(ours.last_outputs)
    np.testing.assert_array_equal(ours.traces, published)
    assert published.shape == (min(5, R) * 2 * (ours.num_timesteps - 1), 2, 3)
