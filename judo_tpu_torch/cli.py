"""Command-line entry points of the port (counterpart of ``judo_tpu/cli.py``).

One process hosts the plant and controller threads:

    python -m judo_tpu_torch.cli run --task leap_cube --optimizer mppi --sim-backend judo_tpu --seconds 10
    python -m judo_tpu_torch.cli run --config judo_tpu_torch/examples/example.yaml --sim-backend judo_tpu
    python -m judo_tpu_torch.cli benchmark --tasks cartpole --optimizers ps,mppi --sim-backend judo_tpu
    python -m judo_tpu_torch.cli --platform cpu run --task cartpole --optimizer ps --sim-backend judo_tpu
    python -m judo_tpu_torch.cli run --task leap_cube --optimizer mppi --sim-backend judo_tpu --gui --gui-port 8008
    python -m judo_tpu_torch.cli run --task leap_cube --optimizer mppi --sim-backend judo_tpu --mesh auto

Tasks and controllers run on the card; ``--platform cpu`` runs the plain
PyTorch versions on the CPU instead. The ``judo_tpu`` plant needs no
``mujoco``; ``mujoco`` and ``mujoco_policy`` need it. The ``--config`` YAML
has the JAX package's launch-config keys (``task``, ``optimizer``,
``simulation_backend``, ``custom_tasks``, ``custom_optimizers``,
``controller_config_overrides``, ``optimizer_config_overrides``). ``--gui``
serves the browser GUI (``visualizers/server.py``) beside the two loops and
prints its address. ``--mesh`` (or the YAML ``mesh`` key) shards the planning
solve's rollouts over the visible GPUs (``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import threading
import time

import numpy as np

RUN_DEFAULTS = {"task": "cylinder_push", "optimizer": "ps", "sim_backend": "mujoco", "mesh": "none"}


def apply_launch_config(args: argparse.Namespace) -> None:
    """Load a YAML launch config and fold it into the parsed args: register
    its custom tasks and optimizers and its per-task overrides; its task,
    optimizer and backend apply where the flag was left at its default."""
    if not getattr(args, "config", None):
        return
    import yaml

    from judo_tpu_torch.app.utils import register_optimizers_from_cfg, register_tasks_from_cfg
    from judo_tpu_torch.config import set_config_overrides
    from judo_tpu_torch.controller import ControllerConfig
    from judo_tpu_torch.optimizers import get_registered_optimizers

    with open(args.config) as f:
        cfg = yaml.safe_load(f) or {}

    if cfg.get("custom_tasks"):
        register_tasks_from_cfg(cfg["custom_tasks"])
    if cfg.get("custom_optimizers"):
        register_optimizers_from_cfg(cfg["custom_optimizers"])

    for task_name, values in (cfg.get("controller_config_overrides") or {}).items():
        set_config_overrides(task_name, ControllerConfig, dict(values))
    optimizers = get_registered_optimizers()
    for task_name, per_opt in (cfg.get("optimizer_config_overrides") or {}).items():
        for opt_name, values in (per_opt or {}).items():
            entry = optimizers.get(opt_name)
            if entry is None:
                raise KeyError(f"optimizer_config_overrides: unknown optimizer '{opt_name}'")
            set_config_overrides(task_name, entry[1], dict(values))

    for key, cfg_key in (("task", "task"), ("optimizer", "optimizer"), ("sim_backend", "simulation_backend"),
                         ("mesh", "mesh")):
        if cfg.get(cfg_key) and getattr(args, key, RUN_DEFAULTS[key]) == RUN_DEFAULTS[key]:
            setattr(args, key, cfg[cfg_key])


@dataclasses.dataclass
class LoopReport:
    """What one ``run`` did: counts and host times of both loops."""

    task: str
    optimizer: str
    sim_backend: str
    device: str
    rollouts: int
    seconds: float  # wall time of the paced loops
    ticks: int  # plant steps taken
    ticks_due: int  # plant steps the wall time of its loop called for, at each task's timestep
    plans: int  # update_action calls in the paced loop
    warmup_plans: int  # update_action calls before it
    overruns: int  # ticks longer than the plant's timestep
    nonfinite_states: int  # published states with a non-finite qpos or qvel
    tick_ms: np.ndarray
    plan_ms: np.ndarray

    def summary(self) -> str:
        def pct(x: np.ndarray) -> str:
            return f"p50 {np.percentile(x, 50):.3f} ms p95 {np.percentile(x, 95):.3f} ms" if x.size else "none"

        return (
            f"loop {self.task} + {self.optimizer} ({self.rollouts} rollouts) on {self.device}, {self.sim_backend} "
            f"plant: {self.seconds:.2f} s, {self.plans} plans ({pct(self.plan_ms)}), {self.ticks} ticks of "
            f"{self.ticks_due} due ({pct(self.tick_ms)}), {self.overruns} overruns, "
            f"{self.nonfinite_states} non-finite states"
        )


def _cmd_run(args: argparse.Namespace) -> LoopReport:
    from judo_tpu_torch.app.bus import MessageBus
    from judo_tpu_torch.app.nodes import ControllerNode, SimulationNode

    apply_launch_config(args)
    bus = MessageBus()
    sim_node = SimulationNode(bus, args.task, backend=args.sim_backend, device=args.device)
    ctrl_node = ControllerNode(bus, args.task, args.optimizer, mesh=args.mesh, device=args.device)
    if ctrl_node.mesh is not None:
        print(
            f"mesh: sharding {ctrl_node.controller.optimizer_cfg.num_rollouts} rollouts "
            f"over {ctrl_node.mesh.devices.size} devices {ctrl_node.mesh.shape}",
            flush=True,
        )

    # the first solve builds and loads the kernel: run it before the paced threads start
    print("warming up: the first solve (on the card it loads, or first builds, the kernels)...", flush=True)
    t0 = time.perf_counter()
    ctrl_node.warmup()
    print(f"warmup done in {time.perf_counter() - t0:.1f}s", flush=True)

    gui_server = None
    if args.gui:
        from judo_tpu_torch.visualizers.server import GuiServer

        gui_server = GuiServer(bus, ctrl_node, port=args.gui_port)
        gui_server.start()
        print(f"GUI: http://localhost:{gui_server.port}", flush=True)

    threads = [
        threading.Thread(target=sim_node.spin, daemon=True),
        threading.Thread(target=ctrl_node.spin, daemon=True),
    ]
    t_start = time.perf_counter()
    for t in threads:
        t.start()

    t_end = time.time() + args.seconds if args.seconds > 0 else None
    try:
        while t_end is None or time.time() < t_end:
            time.sleep(0.5)
            plan_time = bus.read("plan_time")
            state = bus.read("states")
            if plan_time is not None and state is not None:
                print(
                    f"t={state.time:7.2f}s plan={plan_time * 1e3:7.1f}ms qpos[:3]={state.qpos[:3].round(3)}",
                    flush=True,
                )
    except KeyboardInterrupt:
        pass
    finally:
        # stop and join both loops: never abandon a thread in the middle of a dispatch
        sim_node.stop()
        ctrl_node.stop()
        for t in threads:
            t.join(timeout=30.0)
        if gui_server is not None:
            gui_server.stop()
        report = LoopReport(
            task=ctrl_node.controller.task.name, optimizer=args.optimizer, sim_backend=args.sim_backend,
            device=str(args.device), rollouts=ctrl_node.controller.optimizer_cfg.num_rollouts,
            seconds=time.perf_counter() - t_start, ticks=sim_node.ticks,
            ticks_due=sim_node.ticks_due, plans=ctrl_node.plans, warmup_plans=1,
            overruns=sim_node.overruns, nonfinite_states=sim_node.nonfinite_states,
            tick_ms=1e3 * np.asarray(sim_node.tick_times), plan_ms=1e3 * np.asarray(ctrl_node.plan_times),
        )
        print(report.summary(), flush=True)
        print("shutdown complete", flush=True)
    return report


def _cmd_benchmark(args: argparse.Namespace) -> list:
    from judo_tpu_torch.app.benchmark import format_table, run_benchmark

    tasks = args.tasks.split(",") if args.tasks else None
    optimizers = args.optimizers.split(",") if args.optimizers else None
    results = run_benchmark(tasks=tasks, optimizers=optimizers, num_samples=args.num_samples,
                            sim_backend=args.sim_backend, device=args.device)
    print(format_table(results))
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="judo-tpu-torch", description="Sampling-based MPC on one NVIDIA GPU")
    p.add_argument(
        "--platform",
        default="",
        choices=["", "cpu", "cuda"],
        help="device of the tasks and controllers: '' or cuda for the card, cpu for the plain PyTorch versions",
    )
    sub = p.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="closed-loop plant + controller")
    run.add_argument("--task", default=RUN_DEFAULTS["task"])
    run.add_argument("--optimizer", default=RUN_DEFAULTS["optimizer"])
    run.add_argument("--sim-backend", default=RUN_DEFAULTS["sim_backend"],
                     help="mujoco | mujoco_policy (need mujoco) | judo_tpu (the port's own engine)")
    run.add_argument(
        "--mesh",
        default=RUN_DEFAULTS["mesh"],
        help="shard the rollout batch over a device mesh: none|auto|hybrid (auto = all visible devices; hybrid = "
        "(hosts, devices/host) after the torch.distributed bootstrap)",
    )
    run.add_argument("--config", default="", help="YAML launch config (see judo_tpu_torch/examples/example.yaml)")
    run.add_argument("--seconds", type=float, default=10.0, help="<=0 runs until Ctrl+C")
    run.add_argument("--gui", action="store_true", help="serve the browser GUI: the scene and live-tunable widgets")
    run.add_argument("--gui-port", type=int, default=8008, help="the GUI's HTTP port; 0 picks a free one")
    run.set_defaults(func=_cmd_run)

    bench = sub.add_parser("benchmark", help="plan-time distribution per task/optimizer pair")
    bench.add_argument("--tasks", default="")
    bench.add_argument("--optimizers", default="")
    bench.add_argument("--num-samples", type=int, default=100)
    bench.add_argument("--sim-backend", default=RUN_DEFAULTS["sim_backend"])
    bench.set_defaults(func=_cmd_benchmark)
    return p


def main(argv: list[str] | None = None):
    """Parse ``argv`` (the command line when None) and run the command;
    returns what the command returns (``run``: a ``LoopReport``)."""
    import torch

    args = build_parser().parse_args(argv)
    args.device = "cpu" if args.platform == "cpu" else "cuda"
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "torch.cuda.is_available() is False: the tasks and controllers run on a CUDA GPU by default; "
            "pass --platform cpu to run the plain PyTorch versions on the CPU"
        )
    return args.func(args)


def benchmark_main() -> None:
    """Console entry of the ``benchmark`` command."""
    import sys

    main(["benchmark", *sys.argv[1:]])


if __name__ == "__main__":
    main()
