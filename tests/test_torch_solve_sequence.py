"""Consecutive solves of the port's controller held against the JAX
``Controller`` on its lanes path (``rollout_backend="lanes_xla"``), float64,
each task at its default horizon: leap_cube + MPPI (8 rollouts, T 100) and
cylinder_push + PS (8 rollouts, T 52), 3 solves one after another.

Between solves the state and the time advance along one fixed trajectory
(20 Hz), so the nominal's time shift, the spline resampling and the carry of
the onset forces from one solve to the next all act. Both sides sample
through ``sample_from_noise`` on the same numpy noise, the same at every
solve (the JAX solve is compiled once with its noise). After each solve the
rewards, nominal knots, times, traces, ``action(t)`` and the carried onset
forces agree within 1e-6, the limit of the one-solve test
(``test_torch_controller.py``). The JAX solve runs its narrowphase op by op
(``test_torch_full_horizon.py:unfused_narrowphase``): compiled with the rest
of its solve, it gives a leap rollout of the first solve a zero contact
normal and a reward 0.016 away.

spot_navigate + MPPI (3 rollouts, 2 solves) is in
``test_torch_solve_sequence_spot.py``, a file of its own for its time.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from judo_tpu.controller import Controller as JaxController
from judo_tpu.controller import ControllerConfig as JaxControllerConfig
from judo_tpu.optimizers import get_registered_optimizers as jax_optimizers
from judo_tpu.tasks import get_registered_tasks as jax_tasks
from judo_tpu_torch.controller import make_controller
from judo_tpu_torch.tasks.leap_cube import QPOS_REST

from .test_torch_full_horizon import unfused_narrowphase
from .torch_inputs import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

R, SOLVES, PERIOD = 8, 3, 0.05


def _trajectory(c, name, rng):
    """(state, time) before each solve: a start with contacts, then small
    steps of position and fresh small velocities."""
    s = np.r_[c.task.qpos, c.task.qvel]
    if name == "cylinder_push":
        s[:4] = [0.0, 0.0, 0.45, 0.1]  # the cylinders in contact
    else:
        s[: c.task.nq] = QPOS_REST  # the cube resting in the hand
    out = []
    for k in range(SOLVES):
        s = s.copy()
        if name == "cylinder_push":
            s[:4] += 0.01 * rng.standard_normal(4)
            s[4:] = 0.05 * rng.standard_normal(4)
        else:
            s[7 : c.task.nq] += 0.005 * rng.standard_normal(c.task.nq - 7)  # the fingers move; the cube rests
            s[c.task.nq + 6 :] = 0.002 * rng.standard_normal(c.task.nv - 6)
        out.append((s, k * PERIOD))
    return out


def _port(name, opt, noise, rollouts=R):
    c = make_controller(name, opt, device="cpu", dtype=torch.float64, seed=0)
    c.optimizer_cfg.num_rollouts = rollouts
    c.optimizer.draw_noise = lambda g, out: out.copy_(torch.tensor(noise))
    return c


def _jax(name, opt, noise, ours):
    task = jax_tasks()[name][0]()
    task._planning_dtype = jnp.float64  # the test's own task object, planned in f64
    opt_cls, cfg_cls = jax_optimizers()[opt]
    cfg = cfg_cls(**{f.name: getattr(ours.optimizer_cfg, f.name) for f in dataclasses.fields(cfg_cls)
                     if hasattr(ours.optimizer_cfg, f.name)})
    assert cfg.num_rollouts == ours.optimizer_cfg.num_rollouts
    o = opt_cls(cfg, task.nu)
    o.sample = lambda p, s, nom, rng: o.sample_from_noise(p, s, nom, jnp.asarray(noise))
    cc = JaxControllerConfig(horizon=ours.controller_cfg.horizon, spline_order=ours.spline_order,
                             max_num_traces=ours.max_num_traces)
    return JaxController(cc, task, o, rollout_backend="lanes_xla")


@pytest.mark.parametrize("name,opt,T", [("leap_cube", "mppi", 100), ("cylinder_push", "ps", 52)])
def test_consecutive_solves_match_jax_controller(name, opt, T):
    rng = np.random.default_rng(11)
    probe = make_controller(name, opt, device="cpu", dtype=torch.float64, seed=0)
    noise = rng.standard_normal((R - 1, probe.optimizer_cfg.num_nodes, probe.task.nu))
    ours = _port(name, opt, noise)
    ref = _jax(name, opt, noise, ours)
    efc = []
    for k, (state, t) in enumerate(_trajectory(ours, name, rng)):
        for c in (ours, ref):
            c.current_state, c.time = state.copy(), t
        ours.update_action()
        with unfused_narrowphase():
            ref.update_action()
        assert ours.num_timesteps == ref.num_timesteps == T
        assert np.all(np.isfinite(ours.rewards)) and np.ptp(ours.rewards) > 0
        msg = f"solve {k}"
        np.testing.assert_allclose(ours.rewards, np.asarray(ref.rewards), atol=1e-6, rtol=0, err_msg=msg)
        np.testing.assert_allclose(ours.nominal_knots, np.asarray(ref.nominal_knots), atol=1e-6, rtol=0, err_msg=msg)
        np.testing.assert_allclose(ours.times, np.asarray(ref.times), atol=1e-12, err_msg=msg)
        np.testing.assert_allclose(ours.traces, np.asarray(ref.traces), atol=1e-6, rtol=0, err_msg=msg)
        for dt in (0.0, 0.02, 0.3):
            np.testing.assert_allclose(ours.action(t + dt), ref.action(t + dt), atol=1e-6, err_msg=msg)
        efc.append(ours._carry.efc_warm.numpy().copy())
        np.testing.assert_allclose(efc[-1], np.asarray(ref._carry.efc_warm), atol=1e-6, rtol=0, err_msg=msg)
    assert np.abs(efc[0]).max() > 1e-3 and np.abs(efc[-1] - efc[0]).max() > 1e-6  # the carried onset forces act
