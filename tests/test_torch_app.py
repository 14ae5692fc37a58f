"""The app layer of the PyTorch port, as the JAX package's app tests hold
its own (``tests/test_app/test_app.py``, ``test_launch_config.py``,
``tests/test_simulation/test_policy_simulation.py``), on the CPU: the bus,
closed loops of the two nodes on each plant, stale states at a task switch,
pause, the harness's table, the parser, the launch config, the backend
auto-upgrade, and the CLI's ``run`` in a process where jax, mujoco and the
JAX package cannot be imported."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from judo_tpu_torch.app.benchmark import format_table, run_benchmark
from judo_tpu_torch.app.bus import MessageBus
from judo_tpu_torch.app.nodes import ControllerNode, SimulationNode
from judo_tpu_torch.cli import apply_launch_config, build_parser, main
from judo_tpu_torch.config import get_override_registry
from judo_tpu_torch.optimizers import get_registered_optimizers
from judo_tpu_torch.simulation import JTSimulation, MJSimulation, PolicySimulation
from judo_tpu_torch.tasks import get_registered_tasks

REPO = Path(__file__).resolve().parents[1]
EXAMPLE_YAML = str(REPO / "judo_tpu_torch" / "examples" / "example.yaml")


@pytest.fixture(autouse=True)
def _restore_registries():
    """Launch configs register tasks, optimizers and overrides process-wide:
    put all three back after each test."""
    tasks, opts = dict(get_registered_tasks()), dict(get_registered_optimizers())
    overrides = {cls: {k: dict(v) for k, v in per.items()} for cls, per in get_override_registry().items()}
    yield
    for registry, saved in ((get_registered_tasks(), tasks), (get_registered_optimizers(), opts)):
        registry.clear()
        registry.update(saved)
    get_override_registry().clear()
    for cls, per in overrides.items():
        for key, values in per.items():
            get_override_registry()[cls][key] = values


def test_bus_latest_wins():
    bus = MessageBus()
    bus.publish("x", 1)
    bus.publish("x", 2)
    assert bus.read("x") == 2
    seen = []
    bus.subscribe("y", seen.append)
    bus.publish("y", "a")
    bus.publish("y", "b")
    assert seen == ["a", "b"]
    _, seq = bus.read_versioned("x")
    assert seq == 2


@pytest.mark.parametrize("backend", ["mujoco", "judo_tpu"])
def test_sim_and_controller_nodes_closed_loop(backend):
    np.random.seed(0)
    bus = MessageBus()
    sim_node = SimulationNode(bus, "cartpole", backend=backend, device="cpu")
    ctrl_node = ControllerNode(bus, "cartpole", "ps", device="cpu")
    assert isinstance(sim_node.sim, MJSimulation if backend == "mujoco" else JTSimulation)
    for _ in range(5):
        sim_node.step_once()
        plan_time = ctrl_node.step_once()
    assert plan_time is not None and plan_time > 0
    state = bus.read("states")
    assert state is not None and state.qpos.shape == (2,) and state.time == pytest.approx(0.2)
    spline = bus.read("controls")
    assert spline is not None
    assert spline.spline()(state.time).shape == (1,)
    assert bus.read("plan_time") > 0
    assert (sim_node.ticks, ctrl_node.plans, sim_node.nonfinite_states) == (5, 5, 0)
    # the controller planned from the plant's last published state
    np.testing.assert_array_equal(ctrl_node.controller.current_state[:2], sim_node.sim.task.qpos)


def test_node_task_switch_guards_stale_states():
    np.random.seed(0)
    bus = MessageBus()
    sim_node = SimulationNode(bus, "cartpole", backend="judo_tpu", device="cpu")
    ctrl_node = ControllerNode(bus, "cartpole", "ps", device="cpu")
    sim_node.step_once()
    ctrl_node.step_once()
    # the switch builds and runs the new controller on a worker thread while the old one plans
    ctrl_node._on_task("cylinder_push")
    assert ctrl_node.controller.task.name == "cartpole"
    ctrl_node.join_switch()
    assert ctrl_node.controller.task.name == "cylinder_push"
    assert ctrl_node.controller.task.device == torch.device("cpu")
    assert ctrl_node.step_once() is None  # a stale cartpole state on the bus: skipped
    sim_node._on_task("cylinder_push")
    sim_node.step_once()
    assert ctrl_node.step_once() is not None
    ctrl_node._on_optimizer("mppi")
    ctrl_node.join_switch()
    assert type(ctrl_node.controller.optimizer).__name__ == "MPPI" and ctrl_node.step_once() is not None


def test_pause_resume_and_reset():
    np.random.seed(0)
    bus = MessageBus()
    sim_node = SimulationNode(bus, "cartpole", backend="judo_tpu", device="cpu")
    ctrl_node = ControllerNode(bus, "cartpole", "ps", device="cpu")
    task = sim_node.sim.task
    q0 = task.qpos.copy()
    sim_node._on_pause(None)
    sim_node.step_once()
    np.testing.assert_array_equal(task.qpos, q0)  # paused: no motion, no tick counted
    assert sim_node.ticks == 0
    sim_node._on_pause(None)
    sim_node.step_once()
    assert not np.array_equal(task.qpos, q0) and sim_node.ticks == 1
    ctrl_node._on_pause(None)
    assert ctrl_node.step_once() is None
    ctrl_node._on_pause(None)
    assert ctrl_node.step_once() is not None
    bus.publish("task_reset", None)  # both nodes reset
    assert task.time == 0.0


class _FakeClock:
    """``time.perf_counter`` and ``time.sleep`` for the plant loop: sleeping
    wakes ``late`` seconds after it was asked to."""

    def __init__(self, late: float) -> None:
        self.t, self.late = 0.0, late

    def perf_counter(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds + self.late


@pytest.mark.parametrize(
    "stall, behind",
    [(None, 0), (3.5, 2)],  # a tick of 3.5 timesteps puts the loop 2.5 behind: it resumes, no burst
)
def test_plant_loop_keeps_pace_with_the_wall_clock(monkeypatch, stall, behind):
    """The plant's loop against a clock whose sleeps wake late by 5 % of a
    timestep, with every tenth tick overrunning by 30 %: ticks stay with the
    ticks the wall clock called for (exactly, in whole ticks), overruns are
    counted, and a stall is not caught up in a burst."""
    from judo_tpu_torch.app import nodes

    node = SimulationNode(MessageBus(), "cartpole", backend="judo_tpu", device="cpu")
    dt = node.sim.timestep
    clock = _FakeClock(late=0.05 * dt)
    monkeypatch.setattr(nodes, "time", clock)
    durations = [(1.3 if k % 10 == 9 else 0.3) * dt for k in range(200)]
    if stall is not None:
        durations[105] = stall * dt
    starts = []

    def fake_tick():
        starts.append(clock.t)
        clock.t += durations[node.ticks]
        node.ticks += 1
        if node.ticks == len(durations):
            node.stop()

    monkeypatch.setattr(node, "step_once", fake_tick)
    node.spin()
    due = int(node.wall_seconds / dt)
    assert node.ticks == 200 and due - node.ticks == behind
    assert node.overruns == 20 + (stall is not None)
    assert min(np.diff(starts)) >= 0.3 * dt  # no tick started before the one before it ended


def test_plant_loop_counts_ticks_due_across_a_task_switch(monkeypatch):
    """A switch from cartpole (40 ms) to cylinder_push (20 ms) halfway: the
    ticks due are each stretch's wall time over its own timestep, not the
    whole wall time over the last one."""
    from judo_tpu_torch.app import nodes

    node = SimulationNode(MessageBus(), "cartpole", backend="judo_tpu", device="cpu")
    dt_before = node.sim.timestep
    clock = _FakeClock(late=0.05 * dt_before)
    monkeypatch.setattr(nodes, "time", clock)
    starts = []

    def fake_tick():
        if node.ticks == 100:
            node._on_task("cylinder_push")
        starts.append(clock.t)
        clock.t += 0.3 * node.sim.timestep
        node.ticks += 1
        if node.ticks == 200:
            node.stop()

    monkeypatch.setattr(node, "step_once", fake_tick)
    node.spin()
    dt_after = node.sim.timestep
    assert (dt_before, dt_after) == (0.04, 0.02)
    t_switch = starts[100]
    expected = int(t_switch / dt_before + (node.wall_seconds - t_switch) / dt_after)
    assert node.ticks == 200 and node.ticks_due == expected == 200
    assert int(node.wall_seconds / dt_after) >= 290  # the whole run over the last timestep


def test_benchmark_harness_runs_and_formats():
    np.random.seed(0)
    results = run_benchmark(tasks=["cartpole"], optimizers=["ps", "mppi"], num_samples=4, warmup=1,
                            sim_backend="judo_tpu", device="cpu")
    assert [(r.task, r.optimizer) for r in results] == [("cartpole", "ps"), ("cartpole", "mppi")]
    r = results[0]
    assert r.times_s.shape == (4,)
    stats = r.stats
    assert stats["median"] > 0 and stats["p95"] >= stats["median"]
    assert set(r.stages) == {"prep_ms", "device_ms", "sync_ms"} and all(v >= 0 for v in r.stages.values())
    table = format_table(results)
    assert "cartpole" in table and "mppi" in table and "prep / device / sync" in table


def test_cli_parser():
    p = build_parser()
    args = p.parse_args(["run", "--task", "cartpole", "--optimizer", "mppi", "--seconds", "3"])
    assert (args.task, args.optimizer, args.seconds, args.sim_backend, args.platform) == (
        "cartpole", "mppi", 3.0, "mujoco", "")
    args = p.parse_args(["--platform", "cpu", "benchmark", "--tasks", "cartpole", "--num-samples", "10",
                         "--sim-backend", "judo_tpu"])
    assert (args.num_samples, args.sim_backend, args.platform) == (10, "judo_tpu", "cpu")
    with pytest.raises(SystemExit):
        p.parse_args(["--platform", "tpu", "run"])


def test_cli_refusals():
    if not torch.cuda.is_available():  # "auto" takes every visible GPU; without one there is no mesh
        assert ControllerNode(MessageBus(), "cartpole", "ps", mesh="auto", device="cpu").mesh is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--platform cpu"):
            main(["run", "--task", "cartpole", "--seconds", "0.1"])


def test_example_config_registers_and_overrides():
    args = build_parser().parse_args(["run", "--config", EXAMPLE_YAML])
    apply_launch_config(args)
    assert (args.task, args.optimizer) == ("my_cylinder_push", "my_cem")
    tasks, optimizers = get_registered_tasks(), get_registered_optimizers()
    assert "my_cylinder_push" in tasks and "my_cem" in optimizers

    from judo_tpu_torch.controller import ControllerConfig

    cc = ControllerConfig()
    cc.set_override("my_cylinder_push")
    assert cc.spline_order == "zero" and cc.horizon == 1.0
    oc = optimizers["my_cem"][1]()
    assert oc.my_custom_param == 42
    oc.set_override("my_cylinder_push")
    assert oc.num_rollouts == 32 and oc.use_noise_ramp is True and oc.noise_ramp == 4.0
    # the custom task plans on its parent's model, with its own config
    task = tasks["my_cylinder_push"][0](device="cpu")
    assert task.config.my_custom_param == 42 and task.snapshot_path().name == "cylinder_push.npz"


def test_cli_flags_override_yaml():
    args = build_parser().parse_args(["run", "--config", EXAMPLE_YAML, "--task", "cartpole"])
    apply_launch_config(args)
    assert args.task == "cartpole"  # an explicit flag wins
    assert args.optimizer == "my_cem"  # the yaml's value applies


def test_registered_overrides_reapply_on_task_switch():
    from judo_tpu_torch.config import set_config_overrides
    from judo_tpu_torch.controller import ControllerConfig

    np.random.seed(0)
    node = ControllerNode(MessageBus(), "cartpole", "mppi", device="cpu")
    set_config_overrides("cylinder_push", ControllerConfig, {"horizon": 0.77})
    set_config_overrides("cylinder_push", get_registered_optimizers()["mppi"][1], {"num_rollouts": 24})
    node.bus.publish("task", "cylinder_push")
    node.join_switch(timeout=300)
    assert node.controller.task.name == "cylinder_push"
    assert node.controller.controller_cfg.horizon == 0.77
    assert node.controller.optimizer_cfg.num_rollouts == 24


def test_simulation_node_auto_upgrades_backend():
    node = SimulationNode(MessageBus(), "spot_navigate", backend="mujoco", device="cpu")
    assert isinstance(node.sim, PolicySimulation)
    node.step_once()
    node2 = SimulationNode(MessageBus(), "cartpole", backend="mujoco", device="cpu")
    assert isinstance(node2.sim, MJSimulation) and not isinstance(node2.sim, PolicySimulation)
    node2._on_task("spot_navigate")
    assert isinstance(node2.sim, PolicySimulation)
    node2.step_once()
    assert node2.ticks == 1 and node2.nonfinite_states == 0


def test_cli_run_closes_the_loop_without_jax_or_mujoco():
    """``python -m judo_tpu_torch.cli --platform cpu run ... --sim-backend
    judo_tpu`` with jax, mujoco and the JAX package unimportable: plan-time
    telemetry, the loop's summary and a clean shutdown."""
    code = (
        "import sys, runpy\n"
        "for k in ('jax', 'flax', 'jaxlib', 'mujoco', 'judo_tpu'): sys.modules[k] = None\n"
        "sys.argv = ['judo_tpu_torch.cli', '--platform', 'cpu', 'run', '--task', 'cartpole', '--optimizer', 'ps',\n"
        "            '--sim-backend', 'judo_tpu', '--seconds', '2']\n"
        "runpy.run_module('judo_tpu_torch.cli', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "plan=" in out and "shutdown complete" in out.splitlines()[-1]
    summary = next(line for line in out.splitlines() if line.startswith("loop cartpole + ps (32 rollouts) on cpu"))
    assert "judo_tpu plant" in summary and " 0 non-finite states" in summary
