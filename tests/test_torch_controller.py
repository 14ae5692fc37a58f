"""One leap_cube + MPPI planning step of the PyTorch port held against the JAX
``Controller`` on its lanes path (``rollout_backend="lanes_xla"``).

Both run in float64 with 8 rollouts, one optimizer iteration and the horizon
cut to 0.2 s (T = 20). Their random streams differ, so the port's noise draws
(``draw_noise``) and the JAX optimizer's ``sample`` are replaced: both sample
through ``sample_from_noise`` on the same numpy noise.
Rewards and nominal knots agree within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import torch

from judo_tpu.controller import Controller as JaxController
from judo_tpu.controller import ControllerConfig as JaxControllerConfig
from judo_tpu.optimizers.mppi import MPPI as JaxMPPI
from judo_tpu.optimizers.mppi import MPPIConfig as JaxMPPIConfig
from judo_tpu.tasks.leap_cube import LeapCube as JaxLeapCube
from judo_tpu_torch.controller import make_controller
from judo_tpu_torch.tasks.leap_cube import QPOS_REST

R, N, NU = 8, 4, 16


def _port(noise, state):
    c = make_controller("leap_cube", "mppi", device="cpu", dtype=torch.float64, seed=0)
    assert c.optimizer_cfg.sigma == 0.2 and c.optimizer_cfg.noise_ramp == 4.0  # overrides registered
    assert c.spline_order == "cubic" and c.max_num_traces == 1
    c.optimizer_cfg.num_rollouts = R
    c.controller_cfg.horizon = 0.2
    opt = c.optimizer
    opt.draw_noise = lambda g, out: out.copy_(torch.tensor(noise))
    c.current_state = state.copy()
    c.update_action()
    return c


def _jax(noise, state):
    task = JaxLeapCube()
    task._planning_dtype = jnp.float64  # the test's own task object, planned in f64
    cfg = JaxMPPIConfig(num_rollouts=R, num_nodes=N, use_noise_ramp=True, noise_ramp=4.0, sigma=0.2, temperature=0.0025)
    opt = JaxMPPI(cfg, task.nu)
    opt.sample = lambda p, s, nom, rng: opt.sample_from_noise(p, s, nom, jnp.asarray(noise))
    cc = JaxControllerConfig(horizon=0.2, spline_order="cubic", max_num_traces=1)
    c = JaxController(cc, task, opt, rollout_backend="lanes_xla")
    c.current_state = state.copy()
    c.update_action()
    return c


def test_update_action_matches_jax_controller():
    noise = np.random.default_rng(0).standard_normal((R - 1, N, NU))
    state = np.concatenate([QPOS_REST, 0.01 * np.random.default_rng(1).standard_normal(22)])
    ours, ref = _port(noise, state), _jax(noise, state)
    assert ours.num_timesteps == ref.num_timesteps == 20
    assert np.all(np.isfinite(ours.rewards)) and np.ptp(ours.rewards) > 0
    np.testing.assert_allclose(ours.rewards, np.asarray(ref.rewards), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.nominal_knots, np.asarray(ref.nominal_knots), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.times, np.asarray(ref.times), atol=1e-12)
    np.testing.assert_allclose(ours.traces, np.asarray(ref.traces), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.action(0.05), ref.action(0.05), atol=1e-6)
    assert set(ours.last_plan_timing) == {"prep_ms", "device_ms", "sync_ms", "total_ms"}
