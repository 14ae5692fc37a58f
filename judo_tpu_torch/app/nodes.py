"""App nodes: the simulation loop and the controller loop over the message
bus, as threads of one process (counterpart of ``judo_tpu/app/nodes.py``).
Topics:

    simulation --states--> controller
    controller --controls (SplineData), plan_time, traces--> simulation
    CLI        --task, optimizer, sim_pause, controller_pause, task_reset--> both

Both nodes build their tasks on ``device``: the card unless the caller asks
for the CPU. Each keeps counts for telemetry: the plant's ticks, their
host times, the ticks that overran the plant's timestep, the wall time of
its loop and the ticks that wall time called for; the controller's plans and
their host times.
"""

from __future__ import annotations

import collections
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np

from judo_tpu_torch.app.bus import MessageBus
from judo_tpu_torch.app.structs import MujocoState, SplineData
from judo_tpu_torch.controller import Controller, make_controller
from judo_tpu_torch.parallel.mesh import resolve_mesh
from judo_tpu_torch.simulation import PolicySimulation, Simulation, get_simulation_backend
from judo_tpu_torch.tasks import get_registered_tasks

# host times kept for percentiles (the counts cover the whole run)
TIMES_KEPT = 100_000


class SimulationNode:
    """Paced plant loop: evaluate the received control spline at the plant's
    time, step, publish the state (nodes.py:25-108 of the JAX package).
    ``backend="mujoco"`` is upgraded to ``"mujoco_policy"`` for a task with a
    locomotion policy in the loop."""

    def __init__(self, bus: MessageBus, init_task: str, backend: str = "mujoco", device: Any = "cuda") -> None:
        self.bus = bus
        self.device = device
        task = get_registered_tasks()[init_task][0](device=device)
        self._requested_backend = backend
        if backend == "mujoco" and task.uses_locomotion_policy:
            backend = "mujoco_policy"
        self.sim: Simulation = get_simulation_backend(backend)(task)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.ticks = 0
        self.overruns = 0
        self.wall_seconds = 0.0  # wall time of spin()
        self.ticks_due = 0  # ticks the wall time of spin() called for, at the timestep of each stretch of it
        self.nonfinite_states = 0
        self.tick_times: collections.deque = collections.deque(maxlen=TIMES_KEPT)
        bus.subscribe("task", self._on_task)
        bus.subscribe("sim_pause", self._on_pause)
        bus.subscribe("task_reset", self._on_reset)

    def _on_task(self, name: str) -> None:
        entry = get_registered_tasks().get(name)
        if entry is None:
            warnings.warn(f"unknown task '{name}'", stacklevel=1)
            return
        task = entry[0](device=self.device)  # built outside the lock: the plant ticks on meanwhile
        with self._lock:
            if (
                self._requested_backend == "mujoco"
                and task.uses_locomotion_policy
                and not isinstance(self.sim, PolicySimulation)
            ):
                self.sim = PolicySimulation(task)
            else:
                self.sim.set_task_instance(task)

    def _on_pause(self, _msg: Any) -> None:
        with self._lock:
            self.sim.pause()

    def _on_reset(self, _msg: Any) -> None:
        with self._lock:
            self.sim.task.reset()

    def step_once(self) -> None:
        """One plant tick (also called directly by tests and the benchmark)."""
        with self._lock:
            spline_msg: SplineData | None = self.bus.read("controls")
            task = self.sim.task
            if spline_msg is not None and spline_msg.x.shape[-1] == task.nu:
                command = spline_msg.spline()(task.time)
            else:
                command = np.zeros(task.nu)
            if not self.sim.paused:
                self.ticks += 1
            self.sim.step(command)
            state = self.sim.sim_state
            if not (np.isfinite(state.qpos).all() and np.isfinite(state.qvel).all()):
                self.nonfinite_states += 1
            self.bus.publish("states", state)

    def spin(self) -> None:
        """Tick at the plant's timestep against the wall clock: each tick is
        due one timestep after the one before was due, so neither a tick's
        own time nor a late wake-up lengthens the period. A loop more than a
        timestep behind resumes its schedule from now instead of catching
        up in a burst. ``ticks_due`` counts the ticks the wall clock called
        for stretch by stretch: a task switch that changes the timestep
        starts a new stretch at the tick where the loop first sees it."""
        t_start = due = seg_start = time.perf_counter()
        seg_dt, due_before = self.sim.timestep, 0.0
        while not self._stop.is_set():
            t0 = time.perf_counter()
            self.step_once()
            elapsed = time.perf_counter() - t0
            self.tick_times.append(elapsed)
            budget = self.sim.timestep
            if budget != seg_dt:
                due_before += (t0 - seg_start) / seg_dt
                seg_start, seg_dt = t0, budget
            if elapsed > budget:
                self.overruns += 1
                warnings.warn(f"sim step overran: {elapsed * 1e3:.1f}ms > {budget * 1e3:.1f}ms", stacklevel=1)
            due += budget
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            elif delay < -budget:
                due = time.perf_counter()
            now = time.perf_counter()
            self.wall_seconds = now - t_start
            self.ticks_due = int(due_before + (now - seg_start) / seg_dt)

    def stop(self) -> None:
        self._stop.set()


class ControllerNode:
    """Controller loop at ``control_freq``: take the latest state, plan,
    publish the spline, the plan time and the traces (nodes.py:111-255 of
    the JAX package).

    A task or optimizer switch builds the new controller and runs its first
    solve on a worker thread while the old one keeps planning, then swaps it
    in; ``join_switch()`` waits for the swap. States of another task (a
    different nq) are skipped. ``mesh`` (``resolve_mesh``: ``None``,
    ``"none"``, ``"auto"``, ``"hybrid"`` or a ``RolloutMesh``) shards the
    rollouts of this controller and of every controller a switch builds."""

    def __init__(self, bus: MessageBus, init_task: str, init_optimizer: str, mesh=None, device: Any = "cuda") -> None:
        self.bus = bus
        self.device = device
        self.mesh = resolve_mesh(mesh)
        self.controller: Controller = make_controller(init_task, init_optimizer, device=device, mesh=self.mesh)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._paused = False
        self._swapper = ThreadPoolExecutor(max_workers=1, thread_name_prefix="judo-swap")
        self._swap_future = None
        self._swap_gen = 0
        self.plans = 0
        self.plan_times: collections.deque = collections.deque(maxlen=TIMES_KEPT)
        bus.subscribe("task", self._on_task)
        bus.subscribe("optimizer", self._on_optimizer)
        bus.subscribe("task_reset", self._on_reset)
        bus.subscribe("controller_pause", self._on_pause)

    def _submit_swap(self, build) -> None:
        """Run ``build()`` (construction and a first solve) on the worker;
        swap the result in unless a newer switch superseded it."""
        self._swap_gen += 1
        gen = self._swap_gen

        def job():
            try:
                new_controller = build()
            except Exception as e:  # noqa: BLE001 — a failed switch must not kill the loop
                warnings.warn(f"controller switch failed: {e}", stacklevel=1)
                return
            with self._lock:
                if gen == self._swap_gen:  # latest request wins
                    self.controller = new_controller

        self._swap_future = self._swapper.submit(job)

    def join_switch(self, timeout: float | None = None) -> None:
        """Block until an in-flight task or optimizer switch has been applied."""
        f = self._swap_future
        if f is not None:
            f.result(timeout=timeout)

    def _on_task(self, name: str) -> None:
        with self._lock:
            entry = self.controller.available_tasks.get(name)
            if entry is None:
                warnings.warn(f"unknown task '{name}'", stacklevel=1)
                return
            task_cls, _ = entry
            opt_cls = type(self.controller.optimizer)
            opt_cfg_cls = type(self.controller.optimizer.config)
            cfg_cls = type(self.controller.controller_cfg)
            device, mesh = self.device, self.mesh

        def build() -> Controller:
            task = task_cls(device=device)
            opt_cfg = opt_cfg_cls()
            opt_cfg.set_override(name)
            cfg = cfg_cls()
            cfg.set_override(name)
            c = Controller(cfg, task, opt_cls(opt_cfg, task.nu), mesh=mesh)
            c.update_action()  # the first solve off the control loop
            c.reset()
            return c

        self._submit_swap(build)

    def _on_optimizer(self, name: str) -> None:
        with self._lock:
            entry = self.controller.available_optimizers.get(name)
            if entry is None:
                warnings.warn(f"unknown optimizer '{name}'", stacklevel=1)
                return
            opt_cls, opt_cfg_cls = entry
            task = self.controller.task
            cfg = self.controller.controller_cfg
            mesh = self.mesh

        def build() -> Controller:
            opt_cfg = opt_cfg_cls()
            opt_cfg.set_override(task.name)
            c = Controller(cfg, task, opt_cls(opt_cfg, task.nu), mesh=mesh)
            c.update_action()
            c.reset()
            return c

        self._submit_swap(build)

    def _on_reset(self, _msg: Any) -> None:
        with self._lock:
            self.controller.reset()

    def _on_pause(self, _msg: Any) -> None:
        with self._lock:
            self._paused = not self._paused

    def warmup(self) -> None:
        """Run the solve once and discard the result, so the paced loop's
        first plan pays no one-time cost (the kernel's build and load)."""
        with self._lock:
            self.controller.update_action()
            self.controller.reset()

    def step_once(self) -> float | None:
        """One plan; returns the plan time in seconds (None if skipped)."""
        with self._lock:
            if self._paused:
                return None
            state_msg: MujocoState | None = self.bus.read("states")
            if state_msg is not None:
                if state_msg.qpos.shape[0] != self.controller.pm.nq:
                    return None  # a stale message of the previous task
                self.controller.update_states(state_msg)
            t0 = time.perf_counter()
            self.controller.update_action()
            plan_time = time.perf_counter() - t0
            self.plans += 1
            self.plan_times.append(plan_time)
            self.bus.publish("controls", self.controller.spline_data)
            self.bus.publish("plan_time", plan_time)
            if self.controller.traces is not None:
                self.bus.publish("traces", self.controller.traces)
            return plan_time

    def spin(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            self.step_once()
            period = 1.0 / self.controller.controller_cfg.control_freq
            elapsed = time.perf_counter() - t0
            if elapsed < period:
                time.sleep(period - elapsed)

    def stop(self) -> None:
        self._stop.set()
