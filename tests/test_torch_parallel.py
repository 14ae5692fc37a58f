"""The rollout mesh of the PyTorch port (``judo_tpu_torch/parallel``) and its
sharded solve, on the CPU, case by case after
``tests/test_parallel/test_sharded_solve.py``: meshes of repeated ``cpu``
devices, the plain versions of K1 and K2, and the JAX package on conftest's 8
virtual CPU devices.

- The mesh helpers have the JAX ones' shapes, axes, specs, spec errors and
  blocks (``jax.device_put`` over the same mesh).
- The sharded solve equals the unsharded one bitwise (rewards, nominal knots,
  the carried warm start and policy output) on cylinder_push, leap_cube and
  spot_navigate, float64, over an 8-shard and a (2, 4) hybrid mesh.
- It matches the JAX package's sharded solve (``rollout_backend="lanes_xla"``)
  on both meshes, with shared noise through ``sample_from_noise``, within the
  JAX tests' own tolerance: rtol 1e-6, atol 1e-8 on rewards and knots.
- The split is real: 8 launches of B 2 per optimizer iteration at R 16;
  ``update`` of PS, MPPI and CEM on gathered shards equals it on the whole
  batch; the plain MLP's columns do not depend on the batch width; the
  cache keys on the mesh; a batch that does not divide, and a device that
  is not the mesh's lead, are refused; make_controller with a mesh and no
  device plans on the card (and raises without one); the nodes and the CLI
  take a mesh; ``initialize_distributed`` is a no-op with nothing
  configured.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from judo_tpu.controller import Controller as JaxController
from judo_tpu.controller import ControllerConfig as JaxControllerConfig
from judo_tpu.optimizers import MPPI as JaxMPPI
from judo_tpu.optimizers import MPPIConfig as JaxMPPIConfig
from judo_tpu.parallel import mesh as jax_mesh
from judo_tpu.tasks import get_registered_tasks as jax_registered_tasks
from judo_tpu_torch.app.bus import MessageBus
from judo_tpu_torch.app.nodes import ControllerNode
from judo_tpu_torch.cli import build_parser, main
from judo_tpu_torch.controller import Controller, ControllerConfig, make_controller
from judo_tpu_torch.controller import controller as controller_module
from judo_tpu_torch.optimizers import (
    MPPI,
    CrossEntropyMethod,
    CrossEntropyMethodConfig,
    MPPIConfig,
    PredictiveSampling,
    PredictiveSamplingConfig,
)
from judo_tpu_torch.parallel import (
    HOST_AXIS,
    ROLLOUT_AXIS,
    RolloutMesh,
    initialize_distributed,
    make_rollout_mesh,
    replicated,
    resolve_mesh,
    rollout_sharding,
)
from judo_tpu_torch.tasks import get_registered_tasks

MESHES = {
    "8": dict(devices=["cpu"] * 8),
    "2x4": dict(devices=["cpu"] * 8, hybrid=True, devices_per_host=4),
}
# The JAX package's tolerance for a sharded solve against another solve
# (tests/test_parallel/test_sharded_solve.py).
RTOL, ATOL = 1e-6, 1e-8
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _port_mesh(name: str | None) -> RolloutMesh | None:
    return None if name is None else make_rollout_mesh(**MESHES[name])


def _jax_mesh(name: str):
    if name == "8":
        return jax_mesh.make_rollout_mesh(8)
    return jax_mesh.make_rollout_mesh(8, hybrid=True, devices_per_host=4)


def _controller(task_name: str, mesh, num_rollouts: int = 8, horizon: float = 0.1) -> Controller:
    """As the JAX tests build theirs: MPPI with 4 knots and sigma 0.2, zero
    order, full outputs; float64 on the CPU, seeded."""
    np.random.seed(1234)
    task = get_registered_tasks()[task_name][0](device="cpu", dtype=torch.float64)
    opt = MPPI(MPPIConfig(num_rollouts=num_rollouts, num_nodes=4, sigma=0.2), task.nu)
    cc = ControllerConfig(horizon=horizon, spline_order="zero", full_outputs=True)
    return Controller(cc, task, opt, seed=0, mesh=mesh)


@functools.cache
def _solved(task_name: str, mesh_name: str | None) -> tuple:
    """(rewards, nominal knots, carried warm start, carried policy output)
    after one solve on the mesh (None: unsharded)."""
    c = _controller(task_name, _port_mesh(mesh_name), horizon=0.2 if task_name == "spot_navigate" else 0.1)
    c.update_action()
    pout = c._carry.last_policy_output
    return c.rewards, c.nominal_knots, c._carry.efc_warm.clone(), None if pout is None else pout.clone()


# --- the mesh helpers against JAX's ---


@pytest.mark.parametrize("name", list(MESHES))
def test_make_rollout_mesh_matches_jax(name):
    ours, ref = _port_mesh(name), _jax_mesh(name)
    assert ours.devices.shape == ref.devices.shape
    assert ours.axis_names == tuple(ref.axis_names)
    assert ours.shape == dict(ref.shape)
    assert ours.devices.size == 8 and all(d == torch.device("cpu") for d in ours.devices.flat)
    assert rollout_sharding(ours).spec[0] == (ROLLOUT_AXIS if name == "8" else HOST_AXIS)
    if name == "8":
        assert rollout_sharding(ours).spec[0] == jax_mesh.rollout_sharding(ref).spec[0] == ROLLOUT_AXIS
    assert replicated(ours).spec == () == tuple(jax_mesh.replicated(ref).spec)
    assert make_rollout_mesh(4, devices=["cpu"] * 8).devices.shape == jax_mesh.make_rollout_mesh(4).devices.shape
    with pytest.raises(ValueError, match="do not tile"):
        make_rollout_mesh(devices=["cpu"] * 6, hybrid=True, devices_per_host=4)


def test_resolve_mesh_specs(monkeypatch):
    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    mesh = _port_mesh("8")
    for spec in (None, "none", ""):
        assert resolve_mesh(spec) is None and jax_mesh.resolve_mesh(spec) is None
    assert resolve_mesh(mesh) is mesh
    assert resolve_mesh("auto") is None  # no GPU here: one device
    hybrid = resolve_mesh("hybrid")  # no process group configured: this process's devices
    assert hybrid.axis_names == (HOST_AXIS, ROLLOUT_AXIS) and hybrid.devices.shape == (1, 1)
    with pytest.raises(ValueError) as ours:
        resolve_mesh("bogus")
    with pytest.raises(ValueError) as ref:
        jax_mesh.resolve_mesh("bogus")
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("name", list(MESHES))
def test_split_and_gather_match_device_put(name):
    x = np.random.default_rng(0).standard_normal((16, 3, 2))
    sh = rollout_sharding(_port_mesh(name))
    parts = sh.split(torch.as_tensor(x))
    ref = jax.device_put(jnp.asarray(x), jax_mesh.rollout_sharding(_jax_mesh(name)))
    by_device = {s.device: np.asarray(s.data) for s in ref.addressable_shards}
    blocks = [by_device[d] for d in _jax_mesh(name).devices.flat]
    assert len(parts) == len(blocks) == 8
    for ours, theirs in zip(parts, blocks):
        np.testing.assert_array_equal(ours.numpy(), theirs)
    assert torch.equal(sh.gather(parts, "cpu"), torch.as_tensor(x))
    rep = replicated(_port_mesh(name))
    assert all(torch.equal(p, torch.as_tensor(x)) for p in rep.split(torch.as_tensor(x)))
    with pytest.raises(ValueError, match="does not split"):
        sh.split(torch.zeros(12))


# --- the sharded solve: bitwise against the unsharded one ---


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("task_name", ["cylinder_push", "leap_cube", "spot_navigate"])
def test_sharded_solve_equals_unsharded_bitwise(task_name, mesh_name):
    rewards, knots, efc, pout = _solved(task_name, mesh_name)
    ref_rewards, ref_knots, ref_efc, ref_pout = _solved(task_name, None)
    assert np.all(np.isfinite(rewards)) and np.ptp(rewards) > 0
    np.testing.assert_array_equal(rewards, ref_rewards)
    np.testing.assert_array_equal(knots, ref_knots)
    assert torch.equal(efc, ref_efc)
    if task_name == "spot_navigate":
        assert pout.shape == (8, 12) and torch.equal(pout, ref_pout)
    else:
        assert pout is None and ref_pout is None


# --- the slice against the JAX package's sharded solve ---


def _cylinder_push_inputs():
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((15, 4, 2))
    state = np.r_[[0.0, 0.0, 0.45, 0.1], 0.3 * rng.standard_normal(4)]  # the cylinders in contact
    return noise, state


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_solve_matches_jax_sharded_solve(mesh_name):
    noise, state = _cylinder_push_inputs()
    ours = _controller("cylinder_push", _port_mesh(mesh_name), num_rollouts=16)
    ours.optimizer.draw_noise = lambda g, out: out.copy_(torch.as_tensor(noise))
    ours.current_state = state.copy()
    ours.update_action()

    task = jax_registered_tasks()["cylinder_push"][0]()
    task._planning_dtype = jnp.float64  # the test's own task object, planned in f64
    opt = JaxMPPI(JaxMPPIConfig(num_rollouts=16, num_nodes=4, sigma=0.2), task.nu)
    opt.sample = lambda p, s, nom, rng: opt.sample_from_noise(p, s, nom, jnp.asarray(noise))
    cc = JaxControllerConfig(horizon=0.1, spline_order="zero", full_outputs=True)
    ref = JaxController(cc, task, opt, rollout_backend="lanes_xla", mesh=_jax_mesh(mesh_name))
    ref.current_state = state.copy()
    ref.update_action()

    assert {b for _, b in ours.last_shards} == {2}
    assert np.all(np.isfinite(ours.rewards)) and np.ptp(ours.rewards) > 0
    np.testing.assert_allclose(ours.rewards, np.asarray(ref.rewards), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours.nominal_knots, np.asarray(ref.nominal_knots), rtol=RTOL, atol=ATOL)


# --- the split is real, and the update reduces exactly ---


def test_solve_outputs_actually_sharded(monkeypatch):
    calls = []
    real = controller_module.rollout_lanes

    def spy(m, qpos0, *args):
        calls.append(qpos0.shape[0])
        return real(m, qpos0, *args)

    monkeypatch.setattr(controller_module, "rollout_lanes", spy)
    c = _controller("cylinder_push", _port_mesh("8"), num_rollouts=16)
    c.controller_cfg.max_opt_iters = 2
    c.update_action()
    assert c.last_shards == [("cpu", 2)] * 8
    assert calls == [2] * 16  # 8 shards in each of 2 optimizer iterations
    assert c.last_outputs.states.shape[0] == 16


def test_spot_mlp_columns_do_not_depend_on_the_batch_width():
    """The plain MLP takes its columns MLP_COLUMNS at a time: at a batch over
    two chunks each column equals the MLP on that column alone, bitwise, and
    the whole equals the matmul form within float64 rounding."""
    from judo_tpu_torch.tasks.spot.policy import MLP_COLUMNS, SpotPolicy, activate, mlp_l

    policy = SpotPolicy.load(device="cpu")
    B = 2 * MLP_COLUMNS + 3
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((84, B)))
    y = mlp_l(policy, x)
    for i in (0, MLP_COLUMNS - 1, MLP_COLUMNS, B - 1):
        assert torch.equal(mlp_l(policy, x[:, i : i + 1])[:, 0], y[:, i])
    ref = x
    for lin, act in zip(policy.layers, policy.activations):
        ref = activate(act, lin.weight.double() @ ref + lin.bias.double()[:, None])
    torch.testing.assert_close(y, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize(
    "opt_cls,cfg_cls",
    [
        (PredictiveSampling, PredictiveSamplingConfig),
        (MPPI, MPPIConfig),
        (CrossEntropyMethod, CrossEntropyMethodConfig),
    ],
)
def test_optimizer_update_with_sharded_rewards(opt_cls, cfg_cls):
    nu, n, r = 3, 4, 16
    opt = opt_cls(cfg_cls(num_rollouts=r, num_nodes=n), nu)
    rng = np.random.default_rng(0)
    cands = torch.as_tensor(rng.standard_normal((r, n, nu)))
    rewards = torch.as_tensor(rng.standard_normal(r))
    params, state = opt.params(torch.float64), opt.init_state(torch.float64)
    ref_nominal, ref_state = opt.update(params, state, cands, rewards)
    sh = rollout_sharding(_port_mesh("8"))
    out_nominal, out_state = opt.update(
        params, state, sh.gather(sh.split(cands), "cpu"), sh.gather(sh.split(rewards), "cpu")
    )
    np.testing.assert_allclose(out_nominal, ref_nominal, rtol=1e-12, atol=0)
    for k in ref_state:
        np.testing.assert_allclose(out_state[k], ref_state[k], rtol=1e-12, atol=0)


# --- the cache's key, and the refusals ---


def test_signature_keys_on_the_mesh_and_refusals():
    Controller._solve_cache.clear()
    try:
        for mesh in (None, _port_mesh("8"), _port_mesh("2x4")):
            c = _controller("cylinder_push", mesh, num_rollouts=16)
            c.update_action()
        assert len(Controller._solve_cache) == 3
        assert [dict(sig)["mesh"] is None for sig in Controller._solve_cache] == [True, False, False]
    finally:
        Controller._solve_cache.clear()
    with pytest.raises(ValueError, match=r"num_rollouts 9 must divide over the 8-device mesh"):
        _controller("cylinder_push", _port_mesh("8"), num_rollouts=9)
    c = _controller("cylinder_push", _port_mesh("8"), num_rollouts=16)
    c.optimizer_cfg.num_rollouts = 12
    with pytest.raises(ValueError, match=r"num_rollouts 12 must divide over the 8-device mesh"):
        c.update_action()
    with pytest.raises(ValueError, match=r"task's device cpu is not the mesh's lead device cuda:1"):
        _controller("cylinder_push", make_rollout_mesh(devices=["cuda:1", "cuda:1"]))


@pytest.mark.parametrize("mesh_name", ["hybrid", "cpu x2"])
def test_make_controller_with_a_mesh_defaults_to_the_card(monkeypatch, mesh_name):
    """With a mesh and no device, make_controller plans on the card as it does
    without one: where no GPU is visible it raises, also over a mesh of
    ``cpu`` devices; the CPU only when the caller names it."""
    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    mesh = "hybrid" if mesh_name == "hybrid" else make_rollout_mesh(devices=["cpu"] * 2)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        make_controller("cylinder_push", "mppi", mesh=mesh)
    c = make_controller("cylinder_push", "mppi", device="cpu", mesh=mesh)
    assert c.device == torch.device("cpu") and c.mesh is not None


# --- the nodes and the CLI ---


def test_nodes_and_cli_take_a_mesh(monkeypatch, capsys):
    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    assert ControllerNode(MessageBus(), "cartpole", "ps", mesh="auto", device="cpu").mesh is None
    mesh = make_rollout_mesh(devices=["cpu"] * 2)
    bus = MessageBus()
    node = ControllerNode(bus, "cartpole", "ps", mesh=mesh, device="cpu")
    assert node.mesh is mesh and node.controller.mesh is mesh
    bus.publish("task", "cylinder_push")
    node.join_switch(timeout=300)
    assert node.controller.task.name == "cylinder_push" and node.controller.mesh is mesh
    bus.publish("optimizer", "mppi")
    node.join_switch(timeout=300)
    assert type(node.controller.optimizer).__name__ == "MPPI" and node.controller.mesh is mesh
    assert node.controller.last_shards == [("cpu", 16)] * 2

    assert build_parser().parse_args(["run", "--mesh", "hybrid"]).mesh == "hybrid"
    rep = main(["--platform", "cpu", "run", "--task", "cartpole", "--optimizer", "ps", "--sim-backend", "judo_tpu",
                "--mesh", "hybrid", "--seconds", "0.5"])
    out = capsys.readouterr().out
    assert f"mesh: sharding {rep.rollouts} rollouts over 1 devices {{'hosts': 1, 'rollouts': 1}}" in out
    assert out.strip().endswith("shutdown complete") and rep.plans >= 1


def test_initialize_distributed_single_host_noop(monkeypatch):
    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    initialize_distributed()  # nothing configured: a no-op
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="num_processes given without a coordinator_address"):
        initialize_distributed(num_processes=2)
    assert not torch.distributed.is_initialized()
