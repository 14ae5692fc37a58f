"""The Spot policy-in-the-loop planner of the PyTorch port held against the
JAX package: the policy's weights, observation, MLP and ctrl mapping, the
task's command mapping and reward, and one spot_navigate + MPPI solve
against the JAX ``Controller`` on its lanes path (``lanes_xla``).

The solve runs in float64 with 4 rollouts and the horizon cut to 0.08 s
(T = 4 policy ticks of 2 physics steps); both sides sample through
``sample_from_noise`` on the same numpy noise. Rewards and knots agree within
1e-6 (measured ~1e-15). The policy math agrees within 1e-10 in float64.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from judo_tpu.controller import Controller as JaxController
from judo_tpu.controller import ControllerConfig as JaxControllerConfig
from judo_tpu.optimizers.mppi import MPPI as JaxMPPI
from judo_tpu.optimizers.mppi import MPPIConfig as JaxMPPIConfig
from judo_tpu.tasks.spot import policy_lanes as jpl
from judo_tpu.tasks.spot.policy import SpotPolicy as JaxSpotPolicy
from judo_tpu.tasks.spot.spot_navigate import SpotNavigate as JaxSpotNavigate
from judo_tpu_torch.controller import make_controller
from judo_tpu_torch.tasks.spot import policy as tp
from judo_tpu_torch.tasks.spot.spot_navigate import SpotNavigate

R, N, NU = 4, 3, 3


@pytest.fixture(scope="module")
def jax_spot():
    task = JaxSpotNavigate()
    task._planning_dtype = jnp.float64  # the test's own task object, planned in f64
    return task


@pytest.fixture(scope="module")
def port_spot():
    return SpotNavigate(device="cpu", dtype=torch.float64)


def test_weights_equal_jax_policy(port_spot):
    """The port's own copy of the weights equals SpotPolicy.load()'s, bitwise."""
    jp = JaxSpotPolicy.load()
    assert port_spot.policy.activations == tuple(jp.mlp.activations) == ("Elu", "Elu", "Elu", "")
    assert port_spot.policy.dims == [84, 512, 256, 128, 12]
    for lin, (w, b) in zip(port_spot.policy.layers, jp.mlp.weights):
        np.testing.assert_array_equal(lin.weight.numpy(), np.asarray(w).T)
        np.testing.assert_array_equal(lin.bias.numpy(), np.asarray(b))
    carried = tp.policy_from_numpy([(np.asarray(w), np.asarray(b)) for w, b in jp.mlp.weights], jp.mlp.activations)
    for a, b in zip(carried.layers, port_spot.policy.layers):
        assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)


@pytest.fixture
def pinned_numerics():
    """Pin, for one test, the process state a float64 comparison with the JAX
    package rests on, and restore it after: float64 enabled in JAX, JAX's
    persistent compilation cache off (no executable written by another
    process of the run), and one torch thread (one summation order in the
    BLAS whatever the load on the machine)."""
    saved = (jax.config.jax_enable_x64, jax.config.jax_enable_compilation_cache, torch.get_num_threads())
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_enable_compilation_cache", False)
    torch.set_num_threads(1)
    yield
    jax.config.update("jax_enable_x64", saved[0])
    jax.config.update("jax_enable_compilation_cache", saved[1])
    torch.set_num_threads(saved[2])


def test_observation_mlp_ctrl_match_jax(port_spot, pinned_numerics):
    rng = np.random.default_rng(0)
    B = 5
    qp = np.tile(port_spot.qpos, (B, 1)).T + 0.05 * rng.standard_normal((26, B))
    qp[3:7] /= np.linalg.norm(qp[3:7], axis=0)
    qv = 0.3 * rng.standard_normal((25, B))
    cmd = 0.3 * rng.standard_normal((25, B))
    po = 0.3 * rng.standard_normal((12, B))
    j = lambda *xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    t = lambda *xs: [torch.tensor(x) for x in xs]  # noqa: E731
    obs = tp.build_observation_l(*t(qp, qv, cmd, po))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jpl.build_observation_l(*j(qp, qv, cmd, po))), atol=1e-12, rtol=0)
    lp = jax.block_until_ready(jpl.lanes_policy_params(JaxSpotPolicy.load(), jnp.float64))
    # JAX gets its own copy of the observation: no JAX buffer aliases torch's memory
    ref = np.asarray(jax.block_until_ready(jpl.mlp_aug_l(lp, jnp.asarray(obs.numpy().copy()))))
    assert ref.dtype == np.float64 and all(w.dtype == jnp.float64 for w in lp.waugs)
    pout = tp.mlp_l(port_spot.policy, obs)
    np.testing.assert_allclose(pout.numpy(), ref, atol=1e-10, rtol=0)
    # forward() repeats these products on a view: the same order is not guaranteed (the BLAS may take
    # another path for other threads or memory alignment), so the two agree to rounding, not bitwise
    np.testing.assert_allclose(port_spot.policy(obs.T).T.numpy(), pout.numpy(), atol=1e-12, rtol=0)
    ctrl = tp.control_from_policy_l(pout, torch.tensor(cmd))
    ref = jpl.control_from_policy_l(jnp.asarray(pout.numpy()), jnp.asarray(cmd))
    np.testing.assert_allclose(ctrl.numpy(), np.asarray(ref), atol=1e-12, rtol=0)


@pytest.mark.parametrize("active_legs", [(), (2,), (1, 3), (0, 1, 2, 3)])
def test_ctrl_first_active_leg_override_matches_jax(active_legs):
    """The C++ else-if chain's cases: no leg, one leg, several legs."""
    pout = 0.1 * np.random.default_rng(1).standard_normal((12, 1))
    cmd = np.zeros((25, 1))
    cmd[:3] = 0.3
    for leg in active_legs:
        cmd[10 + 3 * leg : 13 + 3 * leg] = 0.5 + leg
    ours = tp.control_from_policy_l(torch.tensor(pout), torch.tensor(cmd)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jpl.control_from_policy_l(jnp.asarray(pout), jnp.asarray(cmd))), atol=0)
    if active_legs:
        first = active_legs[0]
        np.testing.assert_array_equal(ours[3 * first : 3 * first + 3, 0], cmd[10 + 3 * first : 13 + 3 * first, 0])


def test_task_matches_jax(port_spot, jax_spot):
    """Action space, command mapping, reset pose and reward."""
    np.testing.assert_array_equal(port_spot.actuator_ctrlrange, jax_spot.actuator_ctrlrange)
    np.testing.assert_array_equal(port_spot.optimizer_warm_start(), jax_spot.optimizer_warm_start())
    np.testing.assert_array_equal(port_spot.qpos, jax_spot.data.qpos)
    assert (port_spot.nu, port_spot.physics_substeps, port_spot.dt) == (jax_spot.nu, 2, jax_spot.dt)
    assert port_spot.trace_sensor_ids == [4] and port_spot.uses_locomotion_policy
    rng = np.random.default_rng(2)
    controls = 0.5 * rng.standard_normal((3, 6, NU))
    np.testing.assert_array_equal(
        port_spot.task_to_sim_ctrl(torch.tensor(controls)).numpy(), np.asarray(jax_spot.task_to_sim_ctrl(jnp.asarray(controls)))
    )
    states = np.tile(np.r_[port_spot.qpos, np.zeros(25)], (3, 6, 1))
    states[..., :3] += 0.2 * rng.standard_normal((3, 6, 3))
    states[1, 4, 2] = 0.3  # one rollout falls
    sensors = np.zeros((3, 6, 48))
    params = {"fall_penalty": 2500.0, "spot_fallen_threshold": 0.35, "w_goal": 60.0, "w_controls": 0.5,
              "goal_position": np.array([1.0, -0.5, 0.52])}
    ours = port_spot.reward(*(torch.tensor(x) for x in (states, sensors, controls)),
                            {k: torch.tensor(v) for k, v in params.items()})
    ref = jax_spot.reward(*(jnp.asarray(x) for x in (states, sensors, controls)), {k: jnp.asarray(v) for k, v in params.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-12, rtol=0)
    assert ours[1] < -2000


def _port_solve(noise, state):
    c = make_controller("spot_navigate", "mppi", device="cpu", dtype=torch.float64, seed=0)
    cfg = c.optimizer_cfg
    assert (cfg.num_rollouts, cfg.num_nodes, cfg.noise_ramp, cfg.use_noise_ramp) == (24, 3, 3.5, True)
    assert c.horizon == 2.0 and c.num_timesteps == 100 and c._carry.last_policy_output.shape == (24, 12)
    cfg.num_rollouts = R
    c.controller_cfg.horizon = 0.08
    opt = c.optimizer
    opt.draw_noise = lambda g, out: out.copy_(torch.tensor(noise))
    c.current_state = state.copy()
    c.update_action()
    return c


def _jax_solve(task, noise, state):
    cfg = JaxMPPIConfig(num_rollouts=R, num_nodes=N, use_noise_ramp=True, noise_ramp=3.5)
    opt = JaxMPPI(cfg, task.nu)
    opt.sample = lambda p, s, nom, rng: opt.sample_from_noise(p, s, nom, jnp.asarray(noise))
    c = JaxController(JaxControllerConfig(horizon=0.08), task, opt, rollout_backend="lanes_xla")
    c.current_state = state.copy()
    c.update_action()
    return c


def test_update_action_matches_jax_controller(jax_spot):
    noise = np.random.default_rng(0).standard_normal((R - 1, N, NU))
    state = np.concatenate([jax_spot.data.qpos, 0.05 * np.random.default_rng(1).standard_normal(25)])
    ours, ref = _port_solve(noise, state), _jax_solve(jax_spot, noise, state)
    assert ours.num_timesteps == ref.num_timesteps == 4
    assert np.all(np.isfinite(ours.rewards)) and np.ptp(ours.rewards) > 0
    np.testing.assert_allclose(ours.rewards, np.asarray(ref.rewards), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.nominal_knots, np.asarray(ref.nominal_knots), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.traces, np.asarray(ref.traces), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        ours._carry.last_policy_output.numpy(), np.asarray(ref._carry.last_policy_output), atol=1e-6, rtol=0
    )
    assert torch.equal(ours._carry.efc_warm, torch.zeros_like(ours._carry.efc_warm))  # no onset carry on this path
    ours.optimizer_cfg.num_rollouts = 6
    ours._sync_state_shapes()
    assert ours._carry.last_policy_output.shape == (6, 12) and not ours._carry.last_policy_output.any()


def test_entry_points_default_to_cuda_and_refuse_without_gpu():
    with mock.patch("torch.cuda.is_available", return_value=False):
        for build in (lambda: make_controller("spot_navigate", "mppi"), lambda: SpotNavigate(),
                      lambda: make_controller("leap_cube", "mppi")):
            with pytest.raises(RuntimeError, match="pass device='cpu'"):
                build()
