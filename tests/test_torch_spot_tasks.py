"""The three Spot tasks with an object (spot_box_push, spot_tire_roll and
spot_tire_upright) in the PyTorch port, held against the JAX package's: the
action space, warm start, seeded random reset and object indices, the command
mapping, the reward, ``SpotTireUpright.success``, and one planning solve of
spot_box_push against the JAX ``Controller`` on its lanes path
(``lanes_xla``); ``test_torch_spot_tire_solves.py`` holds the tire tasks'
solves, in a file of its own so that parallel test workers split the JAX
compiles.

The command mapping agrees exactly and the reward within 1e-12 in float64.
The solves run in float64 with 4 rollouts and the horizon cut to 0.08 s
(T = 4 policy ticks of 2 physics steps); both sides sample through
``sample_from_noise`` on the same numpy noise; rewards, knots, traces and the
carried policy output agree within 1e-6.
"""

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from judo_tpu.controller import Controller as JaxController
from judo_tpu.controller import ControllerConfig as JaxControllerConfig
from judo_tpu.optimizers.mppi import MPPI as JaxMPPI
from judo_tpu.optimizers.mppi import MPPIConfig as JaxMPPIConfig
from judo_tpu.tasks import get_registered_tasks as jax_registered_tasks
from judo_tpu_torch.controller import make_controller
from judo_tpu_torch.tasks import get_registered_tasks

SCENES = ["spot_box_push", "spot_tire_roll", "spot_tire_upright"]
OBJECT_JOINT = {"spot_box_push": "box_joint", "spot_tire_roll": "tire_joint", "spot_tire_upright": "tire_joint"}
R, N = 4, 3


@pytest.fixture(scope="module", params=SCENES)
def tasks(request):
    """(port task, JAX task) of one scene, both planned in float64; one JAX
    task per scene is shared by the file's tests."""
    name = request.param
    ref = jax_registered_tasks()[name][0]()
    ref._planning_dtype = jnp.float64  # the test's own task object, planned in f64
    return name, get_registered_tasks()[name][0](device="cpu", dtype=torch.float64), ref


def test_task_matches_jax(tasks):
    """Action space, warm start, object and sensor indices, and the random
    reset drawn from the same numpy seed."""
    name, ours, ref = tasks
    np.testing.assert_array_equal(ours.actuator_ctrlrange, ref.actuator_ctrlrange)
    np.testing.assert_array_equal(ours.optimizer_warm_start(), ref.optimizer_warm_start())
    assert (ours.nu, ours.nq, ours.nv, ours.dt) == (ref.nu, ref.model.nq, ref.model.nv, ref.dt)
    assert (ours.nu, ours.nq) == ({"spot_box_push": 10, "spot_tire_roll": 11, "spot_tire_upright": 17}[name], 33)
    assert ours.object_pose_idx == ref.object_pose_idx == ref.get_joint_position_start_index(OBJECT_JOINT[name])
    assert ours.object_vel_idx == int(ref.model.jnt_dofadr[ref.model.joint(OBJECT_JOINT[name]).id])
    for sensor, adr in ours.sensor_adr.items():
        assert adr == ref.get_sensor_start_index(sensor), sensor
    for seed in range(6):
        np.random.seed(seed)
        want = ref.reset_pose
        np.random.seed(seed)
        np.testing.assert_array_equal(ours.reset_pose, want)
    ours.reset()
    assert ours.qpos.shape == (33,) and np.isclose(np.linalg.norm(ours.qpos[29:]), 1.0)


def test_task_to_sim_ctrl_matches_jax(tasks):
    """The compact action to the 25-dim policy command, on random controls
    that reach both sides of the gripper and leg selections."""
    _, ours, ref = tasks
    controls = 1.5 * np.random.default_rng(3).standard_normal((5, 6, ours.nu))
    got = ours.task_to_sim_ctrl(torch.tensor(controls)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.task_to_sim_ctrl(jnp.asarray(controls))))


def test_reward_matches_jax(tasks):
    """The reward on random states and sensors, with a fallen robot and
    object axes past the orientation thresholds in some rollouts."""
    name, ours, ref = tasks
    rng = np.random.default_rng(SCENES.index(name))
    Rr, T = 4, 6
    states = np.tile(np.r_[ours.qpos, ours.qvel], (Rr, T, 1)) + 0.2 * rng.standard_normal((Rr, T, ours.nq + ours.nv))
    states[..., ours.body_pose_idx + 2] = ours.qpos[ours.body_pose_idx + 2]  # standing
    states[1, 3, ours.body_pose_idx + 2] = 0.2  # but for one step of one rollout, where the robot falls
    sensors = rng.standard_normal((Rr, T, ours.planning_model.nsensordata))
    y = ours.sensor_adr["object_y_axis"]
    sensors[2, :3, y + 2] = 0.9  # the object's y axis turned up
    controls = rng.standard_normal((Rr, T, ours.nu))
    params = ours.task_params()
    got = ours.reward(*(torch.tensor(x) for x in (states, sensors, controls)), params)
    want = ref.reward(*(jnp.asarray(x) for x in (states, sensors, controls)), ref.task_params(jnp.float64))
    assert np.all(np.isfinite(got.numpy())) and np.ptp(got.numpy()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12, rtol=0)
    assert got[1] < got[0] - float(params["fall_penalty"]) / 2  # the fall term counts


@pytest.fixture(scope="module")
def upright_tasks():
    return (get_registered_tasks()["spot_tire_upright"][0](device="cpu", dtype=torch.float64),
            jax_registered_tasks()["spot_tire_upright"][0]())


@pytest.mark.parametrize("upright", [False, True])
def test_tire_upright_success_matches_jax(upright_tasks, upright):
    """Flat after the reset, or upright with the tire's body quat at
    identity: the sensors evaluated on the host equal mujoco's after
    mj_forward, and so does ``success``."""
    ours, ref = upright_tasks
    np.random.seed(4)
    qpos = ours.reset_pose
    if upright:
        qpos[ours.object_pose_idx + 2 :] = [0.33, 1.0, 0.0, 0.0, 0.0]
    ours.qpos, ours.qvel = qpos.copy(), np.zeros(ours.nv)
    ref.data.qpos[:], ref.data.qvel[:] = qpos, 0.0
    mujoco.mj_forward(ref.model, ref.data)
    np.testing.assert_allclose(ours.current_sensors(), ref.data.sensordata, atol=1e-12, rtol=0)
    assert ours.success() == ref.success() == upright




def _port_solve(name, noise, state):
    c = make_controller(name, "mppi", device="cpu", dtype=torch.float64, seed=0)
    cfg = c.optimizer_cfg
    assert (cfg.num_rollouts, cfg.num_nodes, cfg.noise_ramp, c.horizon, c.num_timesteps) == (24, N, 3.5, 2.0, 100)
    cfg.num_rollouts = R
    c.controller_cfg.horizon = 0.08
    opt = c.optimizer
    opt.draw_noise = lambda g, out: out.copy_(torch.tensor(noise))
    c.current_state = state.copy()
    c.update_action()
    return c


def _jax_solve(task, noise, state):
    opt = JaxMPPI(JaxMPPIConfig(num_rollouts=R, num_nodes=N, use_noise_ramp=True, noise_ramp=3.5), task.nu)
    opt.sample = lambda p, s, nom, rng: opt.sample_from_noise(p, s, nom, jnp.asarray(noise))
    c = JaxController(JaxControllerConfig(horizon=0.08), task, opt, rollout_backend="lanes_xla")
    c.current_state = state.copy()
    c.update_action()
    return c


def assert_solve_matches_jax(name, ref_task):
    """One float64 solve of the port against the JAX controller on the same
    state (the task's seeded reset with the object in reach of the arm) and
    the same noise."""
    ours_task = get_registered_tasks()[name][0](device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(11)
    noise = rng.standard_normal((R - 1, N, ours_task.nu))
    np.random.seed(5)
    qpos = ours_task.reset_pose
    o = ours_task.object_pose_idx
    qpos[o : o + 2] = qpos[:2] + [0.9, 0.2]  # the object in reach of the arm
    state = np.r_[qpos, 0.05 * rng.standard_normal(ours_task.nv)]
    ours, ref = _port_solve(name, noise, state), _jax_solve(ref_task, noise, state)
    assert ours.num_timesteps == ref.num_timesteps == 4
    assert np.all(np.isfinite(ours.rewards)) and np.ptp(ours.rewards) > 0
    np.testing.assert_allclose(ours.rewards, np.asarray(ref.rewards), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.nominal_knots, np.asarray(ref.nominal_knots), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.traces, np.asarray(ref.traces), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        ours._carry.last_policy_output.numpy(), np.asarray(ref._carry.last_policy_output), atol=1e-6, rtol=0
    )


@pytest.mark.parametrize("tasks", ["spot_box_push"], indirect=True)
def test_update_action_matches_jax_controller(tasks):
    name, _, ref_task = tasks
    assert_solve_matches_jax(name, ref_task)
