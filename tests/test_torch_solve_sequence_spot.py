"""Consecutive solves of spot_navigate + MPPI held against the JAX
``Controller`` on its lanes path, as ``test_torch_solve_sequence.py`` holds
leap_cube and cylinder_push: float64, 3 rollouts, the task's default 2 s
horizon (100 policy ticks of 2 physics steps), 2 solves one after another
with the state and the time advanced between them (20 Hz), the same numpy
noise at each. After each solve the rewards, nominal knots, times, traces,
``action(t)`` and the carried policy output agree within 1e-6. A file of its
own: the JAX Spot solve's compile takes most of its time.
"""

import numpy as np
import pytest
import torch

from judo_tpu_torch.controller import make_controller

from .test_torch_solve_sequence import PERIOD, _jax, _port
from .torch_inputs import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

R_SPOT, SOLVES_SPOT = 3, 2


def test_consecutive_spot_solves_match_jax_controller():
    rng = np.random.default_rng(12)
    probe = make_controller("spot_navigate", "mppi", device="cpu", dtype=torch.float64, seed=0)
    noise = rng.standard_normal((R_SPOT - 1, probe.optimizer_cfg.num_nodes, probe.task.nu))
    ours = _port("spot_navigate", "mppi", noise, R_SPOT)
    ref = _jax("spot_navigate", "mppi", noise, ours)
    state = np.r_[ours.task.qpos, ours.task.qvel]
    for k in range(SOLVES_SPOT):
        state = state.copy()
        state[7 : ours.task.nq] += 0.01 * rng.standard_normal(ours.task.nq - 7)
        state[ours.task.nq :] = 0.05 * rng.standard_normal(ours.task.nv)
        t = k * PERIOD
        for c in (ours, ref):
            c.current_state, c.time = state.copy(), t
            c.update_action()
        assert ours.num_timesteps == ref.num_timesteps == 100
        assert np.all(np.isfinite(ours.rewards)) and np.ptp(ours.rewards) > 0
        msg = f"solve {k}"
        np.testing.assert_allclose(ours.rewards, np.asarray(ref.rewards), atol=1e-6, rtol=0, err_msg=msg)
        np.testing.assert_allclose(ours.nominal_knots, np.asarray(ref.nominal_knots), atol=1e-6, rtol=0, err_msg=msg)
        np.testing.assert_allclose(ours.times, np.asarray(ref.times), atol=1e-12, err_msg=msg)
        np.testing.assert_allclose(ours.traces, np.asarray(ref.traces), atol=1e-6, rtol=0, err_msg=msg)
        for dt in (0.0, 0.02, 0.3):
            np.testing.assert_allclose(ours.action(t + dt), ref.action(t + dt), atol=1e-6, err_msg=msg)
        np.testing.assert_allclose(ours._carry.last_policy_output.numpy(), np.asarray(ref._carry.last_policy_output),
                                   atol=1e-6, rtol=0, err_msg=msg)
