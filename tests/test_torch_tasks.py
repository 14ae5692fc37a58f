"""The tasks of the PyTorch port held against the JAX package's: action space,
home pose, warm start and reward of cartpole, cylinder_push, leap_cube_down,
caltech_leap_cube and fr3_pick (its phase machine in all four phases), a
build-and-solve of every ported task with every optimizer, and one planning
solve each of cylinder_push + PS and fr3_pick + CEM against the JAX
``Controller`` on its lanes path (``lanes_xla``).

Rewards agree within 1e-12 in float64. The solves run in float64 with 4
rollouts and a horizon of 4 steps; both sides sample through
``sample_from_noise`` on the same numpy noise; rewards and knots agree within
1e-6. The JAX fr3 solve runs with its lanes distance sensor patched to take
the pair axis its kernels expect (see test_torch_collision.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from judo_tpu.controller import Controller as JaxController
from judo_tpu.controller import ControllerConfig as JaxControllerConfig
from judo_tpu.optimizers import get_registered_optimizers as jax_registered_optimizers
from judo_tpu.tasks import get_registered_tasks as jax_registered_tasks
from judo_tpu_torch.controller import make_controller
from judo_tpu_torch.tasks import get_registered_tasks
from judo_tpu_torch.tasks.fr3_pick import Phase

from .test_torch_collision import patched_jax_distance_sensor

NEW_TASKS = ["cartpole", "cylinder_push", "leap_cube_down", "caltech_leap_cube", "fr3_pick"]


def _tasks(name: str):
    ours = get_registered_tasks()[name][0](device="cpu", dtype=torch.float64)
    ref = jax_registered_tasks()[name][0]()
    ref._planning_dtype = jnp.float64  # the test's own task object, planned in f64
    return ours, ref


def _batch(ours, rng, R=3, T=6):
    states = np.tile(np.r_[ours.qpos, ours.qvel], (R, T, 1)) + 0.1 * rng.standard_normal((R, T, ours.nq + ours.nv))
    sensors = rng.standard_normal((R, T, ours.planning_model.nsensordata))
    controls = rng.standard_normal((R, T, ours.nu))
    return states, sensors, controls


def _rewards(ours, ref, states, sensors, controls, meta=None):
    t = lambda d: {k: (t(v) if isinstance(v, dict) else torch.as_tensor(np.asarray(v))) for k, v in d.items()}  # noqa: E731
    r = ours.reward(torch.tensor(states), torch.tensor(sensors), torch.tensor(controls), ours.task_params(),
                    None if meta is None else t(meta))
    j = ref.reward(jnp.asarray(states), jnp.asarray(sensors), jnp.asarray(controls), ref.task_params(jnp.float64),
                   None if meta is None else {k: jnp.asarray(v, jnp.float64) for k, v in meta.items()})
    return r.numpy(), np.asarray(j)


@pytest.mark.parametrize("name", NEW_TASKS)
def test_task_matches_jax(name):
    ours, ref = _tasks(name)
    np.testing.assert_array_equal(ours.actuator_ctrlrange, ref.actuator_ctrlrange)
    np.testing.assert_array_equal(ours.optimizer_warm_start(), ref.optimizer_warm_start())
    assert (ours.nu, ours.dt, ours.trace_sensor_ids) == (ref.nu, ref.dt, [
        i for i in range(ref.model.nsensor) if "trace" in ref.model.sensor(i).name and ref.model.sensor_type[i] == 26
    ])
    if name not in ("cartpole", "cylinder_push"):  # those two reset at random
        np.testing.assert_array_equal(ours.qpos, ref.data.qpos)
    states, sensors, controls = _batch(ours, np.random.default_rng(NEW_TASKS.index(name)))
    r, j = _rewards(ours, ref, states, sensors, controls)
    assert np.all(np.isfinite(r)) and np.ptp(r) > 0
    np.testing.assert_allclose(r, j, atol=1e-12, rtol=0)


@pytest.mark.parametrize("phase", list(Phase))
def test_fr3_phase_machine_and_reward_match_jax(phase):
    ours, ref = _tasks("fr3_pick")
    state = np.r_[ours.qpos, ours.qvel]
    goal = np.r_[ours.config.goal_pos, 0.0]
    state[:3] = {Phase.LIFT: [0.7, 0.0, 0.02], Phase.MOVE: [0.5, 0.1, 0.2], Phase.PLACE: goal + [0.01, 0.0, 0.15],
                 Phase.HOMING: goal + [0.0, 0.01, 0.02]}[phase]
    meta, jmeta = ours.pre_rollout(state), ref.pre_rollout(state)
    assert ours.phase.value == ref.phase.value == phase.value
    assert int(meta["phase"]) == int(jmeta["phase"]) == phase.value
    rng = np.random.default_rng(10 + phase.value)
    states, sensors, controls = _batch(ours, rng)
    sensors[0, :3, [ours.left_finger_table_adr, ours.right_finger_table_adr]] = -0.01  # a hand touches the table
    r, j = _rewards(ours, ref, states, sensors, controls, meta)
    np.testing.assert_allclose(r, j, atol=1e-12, rtol=0)


@pytest.mark.parametrize("opt", ["ps", "cem", "mppi"])
@pytest.mark.parametrize("name", sorted(get_registered_tasks()))
def test_every_task_builds_and_solves(name, opt):
    c = make_controller(name, opt, device="cpu", dtype=torch.float64, seed=0)
    c.optimizer_cfg.num_rollouts = 3
    c.controller_cfg.horizon = 2 * c.task.dt
    c.update_action()
    assert np.all(np.isfinite(c.rewards)) and c.rewards.shape == (3,) and np.all(np.isfinite(c.nominal_knots))


def test_registry_matches_jax():
    """Every task the JAX package registers, in its order; ``spot_base``, a
    base class, is refused as an unknown task in both packages."""
    assert list(get_registered_tasks()) == list(jax_registered_tasks())
    with pytest.raises(KeyError, match="spot_base"):
        make_controller("spot_base", "mppi", device="cpu")


R = 4


def _port_solve(name, opt, noise, state):
    c = make_controller(name, opt, device="cpu", dtype=torch.float64, seed=0)
    c.optimizer_cfg.num_rollouts = R
    c.controller_cfg.horizon = 4 * c.task.dt
    o = c.optimizer
    o.draw_noise = lambda g, out: out.copy_(torch.tensor(noise))
    c.current_state = state.copy()
    c.update_action()
    return c


def _jax_solve(name, opt, noise, state, ours):
    _, ref = _tasks(name)
    cfg = jax_registered_optimizers()[opt][1](**{k: getattr(ours.optimizer_cfg, k) for k in (
        "num_nodes", "use_noise_ramp", "noise_ramp", *(("sigma",) if opt == "ps" else ("sigma_min", "sigma_max", "num_elites"))
    )}, num_rollouts=R)
    o = jax_registered_optimizers()[opt][0](cfg, ref.nu)
    o.sample = lambda p, s, nom, rng: o.sample_from_noise(p, s, nom, jnp.asarray(noise))
    cc = JaxControllerConfig(horizon=ours.horizon, spline_order=ours.spline_order, max_num_traces=ours.max_num_traces)
    c = JaxController(cc, ref, o, rollout_backend="lanes_xla")
    c.current_state = state.copy()
    with patched_jax_distance_sensor():
        c.update_action()
    return c


@pytest.mark.parametrize("name,opt", [("cylinder_push", "ps"), ("fr3_pick", "cem")])
def test_update_action_matches_jax_controller(name, opt):
    probe = make_controller(name, opt, device="cpu", dtype=torch.float64, seed=0)
    n, nu = probe.optimizer_cfg.num_nodes, probe.task.nu
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((R - 1, n, nu))
    state = np.r_[probe.task.qpos, probe.task.qvel]
    if name == "cylinder_push":
        state[:4] = [0.0, 0.0, 0.45, 0.1]  # the cylinders in contact
        state[4:] = 0.3 * rng.standard_normal(4)
    else:
        state[7:16] += 0.02 * rng.standard_normal(9)
        state[16:] = 0.1 * rng.standard_normal(probe.task.nv)
    ours = _port_solve(name, opt, noise, state)
    ref = _jax_solve(name, opt, noise, state, ours)
    assert ours.num_timesteps == ref.num_timesteps == 4
    assert np.all(np.isfinite(ours.rewards)) and np.ptp(ours.rewards) > 0
    np.testing.assert_allclose(ours.rewards, np.asarray(ref.rewards), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.nominal_knots, np.asarray(ref.nominal_knots), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.traces, np.asarray(ref.traces), atol=1e-6, rtol=0)
    if opt == "cem":
        np.testing.assert_allclose(ours._carry.opt_state["sigma"].numpy(), np.asarray(ref._carry.opt_state["sigma"]),
                                   atol=1e-6, rtol=0)
