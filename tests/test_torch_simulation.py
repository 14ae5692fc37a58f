"""The plants of the PyTorch port held against the JAX package's, float64.

- ``JTSimulation`` (the plain ``physics_step`` on the CPU) against the JAX
  lanes step with a cold probe, three ticks on cartpole and leap_cube from a
  contact state: 1e-10; against the JAX ``JTSimulation``, which steps the
  vmap engine: 1e-9 on cartpole (no contacts) and 1e-5 on leap (contacts),
  the lanes-vs-vmap tolerances of ``tests/test_physics/test_lanes.py``.
- The plant's body frames against ``mj_forward``: 1e-10.
- ``MJSimulation`` (leap_cube's plant at dt 0.002) and ``PolicySimulation``
  (a Spot policy tick and two ``mj_step``) against the JAX ones on the same
  states and commands: 1e-12; ``HostSpotPolicy`` against the JAX one: 1e-12.
- leap_cube's goal draws and cube-drop reset: bitwise the JAX task's under
  the same seed.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from judo_tpu.physics.pallas_step import _xla_step_fn
from judo_tpu.physics.solver import num_constraint_rows as jax_num_constraint_rows
from judo_tpu.simulation import JTSimulation as JaxJTSimulation
from judo_tpu.simulation import MJSimulation as JaxMJSimulation
from judo_tpu.simulation import PolicySimulation as JaxPolicySimulation
from judo_tpu.tasks import get_registered_tasks as jax_registered_tasks
from judo_tpu_torch.simulation import (
    HostSpotPolicy, JTSimulation, MJSimulation, PolicySimulation, get_simulation_backend, register_simulation_backend,
)
from judo_tpu_torch.tasks import get_registered_tasks
from judo_tpu_torch.tasks.leap_cube import QPOS_REST

TICKS = 3


def _tasks(name: str, seed: int = 0):
    """(port task on the CPU in float64, JAX task planned in float64), both
    reset from numpy's global state seeded with ``seed`` (the port's leap
    tasks draw from their own state, seeded the same)."""
    np.random.seed(seed)
    cls = get_registered_tasks()[name][0]
    ours = cls(device="cpu", dtype=torch.float64, **({"seed": seed} if "leap" in name else {}))
    np.random.seed(seed)
    ref = jax_registered_tasks()[name][0]()
    ref._planning_dtype = jnp.float64
    return ours, ref


def _start(name: str, ours, ref):
    """A shared starting state (leap: the cube resting in the hand, with
    contacts) and a fixed command."""
    rng = np.random.default_rng(7)
    if name == "cartpole":
        q, v, ctrl = np.array([0.3, 2.9]), np.array([0.1, -0.2]), np.array([0.4])
    else:
        q, v = QPOS_REST.copy(), 0.05 * rng.standard_normal(ours.nv)
        ctrl = QPOS_REST[7:] + 0.1 * rng.standard_normal(16)
    ours.qpos, ours.qvel = q.copy(), v.copy()
    ref.data.qpos[:], ref.data.qvel[:] = q, v
    return q, v, ctrl


@pytest.mark.parametrize("name", ["cartpole", "leap_cube"])
def test_jt_simulation_matches_jax_lanes_step_and_plant(name):
    ours, ref = _tasks(name)
    q0, v0, ctrl = _start(name, ours, ref)
    sim, jsim = JTSimulation(ours), JaxJTSimulation(ref)
    step = jax.jit(_xla_step_fn(ref.planning_model, None))
    nefc = max(jax_num_constraint_rows(ref.planning_model), 1)
    q, v = jnp.asarray(q0)[:, None], jnp.asarray(v0)[:, None]
    plant_tol = 1e-9 if name == "cartpole" else 1e-5
    for k in range(TICKS):
        sim.step(ctrl)
        jsim.step(ctrl)
        q, v, _, _, _ = step(q, v, jnp.asarray(ctrl)[:, None], jnp.zeros((nefc, 1)), None)  # cold probe, no warm start
        np.testing.assert_allclose(ours.qpos, np.asarray(q)[:, 0], atol=1e-10, rtol=0, err_msg=f"tick {k}")
        np.testing.assert_allclose(ours.qvel, np.asarray(v)[:, 0], atol=1e-10, rtol=0, err_msg=f"tick {k}")
        np.testing.assert_allclose(ours.qpos, ref.data.qpos, atol=plant_tol, rtol=0, err_msg=f"tick {k}")
        np.testing.assert_allclose(ours.qvel, ref.data.qvel, atol=plant_tol, rtol=0, err_msg=f"tick {k}")
        assert ours.time == pytest.approx(ref.data.time, abs=1e-12)
    state = sim.sim_state
    np.testing.assert_array_equal(state.qpos, ours.qpos)
    assert state.time == ours.time and sim.timestep == pytest.approx(float(ref.model.opt.timestep), abs=1e-15)


@pytest.mark.parametrize("name", ["cartpole", "leap_cube"])
def test_jt_simulation_body_frames_match_mj_forward(name):
    ours = get_registered_tasks()[name][0](device="cpu", dtype=torch.float64, **({"seed": 3} if "leap" in name else {}))
    sim = JTSimulation(ours)
    sim.step(np.zeros(ours.nu) if name == "cartpole" else ours.reset_command)
    state = sim.sim_state
    mj = mujoco.MjModel.from_xml_string(ours.model_xml())
    d = mujoco.MjData(mj)
    d.qpos[:] = state.qpos
    d.mocap_pos[:], d.mocap_quat[:] = state.mocap_pos, state.mocap_quat
    mujoco.mj_forward(mj, d)
    np.testing.assert_allclose(state.xpos, d.xpos, atol=1e-10, rtol=0)
    np.testing.assert_allclose(state.xquat, d.xquat, atol=1e-10, rtol=0)
    if name == "leap_cube":  # the goal reaches the mocap body and the metadata
        np.testing.assert_array_equal(state.mocap_quat[0], ours.goal_quat)
        np.testing.assert_array_equal(state.sim_metadata["goal_quat"], ours.goal_quat)


def test_jt_simulation_frames_of_a_message_outlive_a_task_switch():
    """A state message published before a task switch and read after it
    still gives its own task's body frames (1e-10 against mj_forward)."""
    leap = get_registered_tasks()["leap_cube"][0](device="cpu", dtype=torch.float64, seed=3)
    sim = JTSimulation(leap)
    sim.step(leap.reset_command)
    state = sim.sim_state  # frames not read yet
    sim.set_task_instance(get_registered_tasks()["cartpole"][0](device="cpu", dtype=torch.float64))
    sim.step(np.zeros(1))
    mj = mujoco.MjModel.from_xml_string(leap.model_xml())
    d = mujoco.MjData(mj)
    d.qpos[:] = state.qpos
    d.mocap_pos[:], d.mocap_quat[:] = state.mocap_pos, state.mocap_quat
    mujoco.mj_forward(mj, d)
    np.testing.assert_allclose(state.xpos, d.xpos, atol=1e-10, rtol=0)
    np.testing.assert_allclose(state.xquat, d.xquat, atol=1e-10, rtol=0)


def test_jt_simulation_refused_switch_keeps_the_old_task():
    """Switching the judo_tpu plant to a Spot task raises, naming
    mujoco_policy, and leaves the plant stepping its old task."""
    cartpole = get_registered_tasks()["cartpole"][0](device="cpu", dtype=torch.float64)
    sim = JTSimulation(cartpole)
    spot = get_registered_tasks()["spot_navigate"][0](device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="mujoco_policy"):
        sim.set_task_instance(spot)
    assert sim.task is cartpole
    q0 = cartpole.qpos.copy()
    sim.step(np.array([0.5]))
    assert not np.array_equal(cartpole.qpos, q0) and cartpole.time == pytest.approx(sim.timestep)


def test_mj_simulation_matches_jax_on_leap_sim_plant():
    ours, ref = _tasks("leap_cube")
    sim, jsim = MJSimulation(ours), JaxMJSimulation(ref)
    assert sim.model.opt.timestep == pytest.approx(0.002) and jsim.model.opt.timestep == pytest.approx(0.002)
    _, _, ctrl = _start("leap_cube", ours, ref)
    for k in range(5):
        sim.step(ctrl)
        jsim.step(ctrl)
        np.testing.assert_allclose(ours.qpos, ref.data.qpos, atol=1e-12, rtol=0, err_msg=f"tick {k}")
        np.testing.assert_allclose(ours.qvel, ref.data.qvel, atol=1e-12, rtol=0, err_msg=f"tick {k}")
    np.testing.assert_allclose(sim.sim_state.xpos, jsim.sim_state.xpos, atol=1e-12, rtol=0)
    assert ours.time == ref.data.time


def test_policy_simulation_matches_jax_on_spot():
    ours, ref = _tasks("spot_navigate")
    sim, jsim = PolicySimulation(ours), JaxPolicySimulation(ref)
    assert sim.timestep == jsim.timestep == pytest.approx(0.02)
    command = np.array([0.4, -0.1, 0.2])
    for k in range(2):
        sim.step(command)
        jsim.step(command)
        np.testing.assert_allclose(sim.last_policy_output, jsim.last_policy_output, atol=1e-12, rtol=0)
        np.testing.assert_allclose(ours.qpos, ref.data.qpos, atol=1e-12, rtol=0, err_msg=f"tick {k}")
        np.testing.assert_allclose(ours.qvel, ref.data.qvel, atol=1e-12, rtol=0, err_msg=f"tick {k}")
    assert np.any(sim.last_policy_output != 0.0)
    sim.set_task("spot_navigate")  # a task switch zeroes the carried policy output
    np.testing.assert_array_equal(sim.last_policy_output, np.zeros(12))


def test_host_spot_policy_matches_jax():
    from judo_tpu.simulation.policy_simulation import HostSpotPolicy as JaxHostSpotPolicy

    ours, ref = HostSpotPolicy(), JaxHostSpotPolicy()
    assert ours.activations == tuple(ref.activations)
    reset_pose = get_registered_tasks()["spot_navigate"][0](device="cpu", dtype=torch.float64).reset_pose
    rng = np.random.default_rng(0)
    for _ in range(5):
        qpos = reset_pose + 0.02 * rng.standard_normal(26)
        qpos[3:7] /= np.linalg.norm(qpos[3:7])
        qvel, cmd, last = 0.1 * rng.standard_normal(25), rng.standard_normal(25), 0.1 * rng.standard_normal(12)
        obs = ours.observation(qpos, qvel, cmd, last)
        np.testing.assert_allclose(obs, ref.observation(qpos, qvel, cmd, last), atol=1e-12, rtol=0)
        np.testing.assert_allclose(ours.mlp(obs), ref.mlp(obs), atol=1e-12, rtol=0)
        for a, b in zip(ours.tick(qpos, qvel, cmd, last), ref.tick(qpos, qvel, cmd, last)):
            np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
    cmd = np.zeros(25)
    cmd[13:16], cmd[19:22] = [0.5, 0.6, 0.7], [0.1, 0.2, 0.3]  # two leg blocks: only the first overrides
    np.testing.assert_array_equal(ours.control(np.zeros(12), cmd), ref.control(np.zeros(12), cmd))


@pytest.mark.parametrize("name", ["leap_cube", "leap_cube_down"])
def test_leap_goal_draws_and_drop_reset_match_jax(name, temp_np_seed):
    """Same seed, same goals: at construction, on every goal reached, and at
    the reset after a drop (bitwise, with the reset state)."""
    with temp_np_seed(11):
        ours, ref = _tasks(name, seed=11)
        np.testing.assert_array_equal(ours.goal_quat, ref.goal_quat)
        for k in range(6):
            if k % 3 == 2:  # the cube falls below -0.3: reset, and a new goal
                ours.qpos[2] = ref.data.qpos[2] = -0.5
            else:  # the cube within 0.4 rad of the goal: a new goal
                ours.qpos[3:7] = ref.data.qpos[3:7] = ours.goal_quat
            ours.post_sim_step()
            ref.post_sim_step()
            np.testing.assert_array_equal(ours.goal_quat, ref.goal_quat, err_msg=f"event {k}")
            np.testing.assert_array_equal(ours.mocap_quat, ref.data.mocap_quat)
            np.testing.assert_array_equal(ours.qpos, ref.data.qpos)
        np.testing.assert_array_equal(ours.get_sim_metadata()["goal_quat"], ref.get_sim_metadata()["goal_quat"])
        ours.reset()
        ref.reset()
        np.testing.assert_array_equal(ours.goal_quat, ref.goal_quat)


def test_backend_registry_and_refusals(monkeypatch):
    assert get_simulation_backend("mujoco") is MJSimulation
    assert get_simulation_backend("mujoco_policy") is PolicySimulation
    assert get_simulation_backend("judo_tpu") is JTSimulation
    with pytest.raises(ValueError, match="Unknown simulation backend"):
        get_simulation_backend("nope")
    register_simulation_backend("judo_tpu_again", JTSimulation)
    assert get_simulation_backend("judo_tpu_again") is JTSimulation
    spot = get_registered_tasks()["spot_navigate"][0](device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="mujoco_policy"):
        JTSimulation(spot)  # the judo_tpu plant steps actuators, not a policy's commands
    with pytest.raises(ValueError, match="mujoco_policy"):
        MJSimulation(spot).step(np.zeros(spot.nu))
    monkeypatch.setitem(__import__("sys").modules, "mujoco", None)
    with pytest.raises(ImportError, match="judo_tpu"):
        MJSimulation(get_registered_tasks()["cartpole"][0](device="cpu"))


def test_jt_simulation_pause_resync_and_reset():
    task = get_registered_tasks()["leap_cube"][0](device="cpu", dtype=torch.float64, seed=0)
    sim = JTSimulation(task)
    q0 = task.qpos.copy()
    sim.pause()
    sim.step(task.reset_command)
    np.testing.assert_array_equal(task.qpos, q0)  # paused: no motion
    sim.pause()
    sim.step(task.reset_command)
    assert not np.array_equal(task.qpos, q0) and task.time == pytest.approx(0.01)
    task.reset()  # behind the plant's back: the next tick starts from the reset state
    sim.step(task.reset_command)
    fresh = get_registered_tasks()["leap_cube"][0](device="cpu", dtype=torch.float64, seed=0)
    JTSimulation(fresh).step(fresh.reset_command)
    np.testing.assert_array_equal(task.qpos, fresh.qpos)
    assert task.time == pytest.approx(0.01)
