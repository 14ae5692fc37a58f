"""The planner: a solve function over an explicit ``SolverState`` and the host
``Controller`` around it (counterpart of ``judo_tpu/controller/controller.py``).

One ``update_action`` runs ``solve``: resample the nominal spline, draw the
optimizer's samples and clip them, evaluate the candidate splines at the rollout
times, roll out the physics (one fused kernel on CUDA; for a task with a
locomotion policy in the loop, the fused policy rollout), score, update the
nominal, and pack everything the host reads into one mirror vector that
crosses to the host in one copy.

With ``pipeline_depth > 0`` a call dispatches its solve and returns while the
card runs it: the mirror's copy to the host is queued behind the solve into a
pinned buffer of its own, a CUDA event marks its end, and a single consumer
thread publishes the oldest solve's mirrors once more than ``depth`` solves
are in flight. Nothing on the dispatch path waits for the card: the state and
time go up through pinned memory without blocking, and the task, optimizer
and normalizer parameters, the time grids and the control bounds stay on the
card, uploaded again only when their values change. The carried solver state
chains on the card, so only the published mirrors lag, by ``depth`` solves.
On the CPU the same code runs without pinned memory or events.
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Any, Literal, NamedTuple

import numpy as np
import torch
from scipy.interpolate import interp1d

from judo_tpu_torch.app.structs import MujocoState, SplineData
from judo_tpu_torch.config import OverridableConfig
from judo_tpu_torch.gui import slider
from judo_tpu_torch.ops.splines import eval_spline
from judo_tpu_torch.optimizers import Optimizer, OptimizerConfig, get_registered_optimizers
from judo_tpu_torch.optimizers.base import top_k_indices
from judo_tpu_torch.physics.fused_rollout import rollout_lanes
from judo_tpu_torch.physics.model import lane_supported, num_constraint_rows
from judo_tpu_torch.physics.policy_rollout import policy_rollout_lanes
from judo_tpu_torch.tasks import Task, get_registered_tasks
from judo_tpu_torch.utils import normalization as norm


@slider("horizon", 0.1, 10.0, bounded=True)
@slider("control_freq", 0.25, 50.0)
@dataclass
class ControllerConfig(OverridableConfig):
    """Controller config (same fields as the JAX package's)."""

    horizon: float = 1.0
    spline_order: Literal["zero", "linear", "cubic"] = "linear"
    control_freq: float = 20.0
    max_opt_iters: int = 1
    max_num_traces: int = 5
    action_normalizer: Literal["none", "min_max", "running"] = "none"
    solver_iterations: int | None = 8
    pipeline_depth: int = 0
    full_outputs: bool = False


@dataclass
class SolverState:
    """Carried planner state."""

    times: torch.Tensor  # (N,) knot times
    nominal_knots: torch.Tensor  # (N, nu)
    opt_state: Any
    norm_state: Any
    efc_warm: torch.Tensor  # (R, max(nefc, 1)) previous solve's step-0 forces
    generator: torch.Generator  # sampling stream
    last_policy_output: torch.Tensor | None = None  # (R, 12) with a policy in the loop


class SolveOutputs(NamedTuple):
    rewards: torch.Tensor  # (R,)
    states: torch.Tensor | None  # (R, T, nq + nv)
    sensors: torch.Tensor | None  # (R, T, nsensordata)
    rollout_controls: torch.Tensor | None  # (R, T, nu)
    candidate_knots: torch.Tensor | None  # (R, N, nu)
    traces: torch.Tensor | None  # (k, n_trace, T - 1, 2, 3)
    mirror: torch.Tensor  # [times | knots | rewards | traces]


def solve(
    ctrl: "Controller",
    carry: SolverState,
    current_state: torch.Tensor,
    time: torch.Tensor,
    task_params: dict,
    opt_params: Any,
    norm_params: dict,
    metadata: dict,
    spline_ts: torch.Tensor,
    rollout_ts: torch.Tensor,
    ctrl_bounds: tuple[torch.Tensor, torch.Tensor],
) -> tuple[SolverState, SolveOutputs]:
    """One planning solve (controller.py:361-547 of the JAX package)."""
    task, optimizer, pm = ctrl.task, ctrl.optimizer, ctrl.pm
    order = ctrl.spline_order
    kind = ctrl.normalizer_kind
    new_times = time + spline_ts
    nominal = eval_spline(carry.times, carry.nominal_knots, new_times, order)
    nominal_n = norm.normalize(kind, norm_params, carry.norm_state, nominal)
    opt_state = optimizer.pre_optimization(opt_params, carry.opt_state, carry.times, new_times)
    norm_state = carry.norm_state
    ctrl_lo, ctrl_hi = ctrl_bounds
    efc_warm, last_pout = carry.efc_warm, carry.last_policy_output
    states = sensors = rollout_controls = rewards = candidates = None
    for _ in range(1 if optimizer.stop_cond() else ctrl.max_opt_iters):
        cand_n, opt_state = optimizer.sample(opt_params, opt_state, nominal_n, carry.generator)
        lo = norm.normalize(kind, norm_params, norm_state, ctrl_lo)
        hi = norm.normalize(kind, norm_params, norm_state, ctrl_hi)
        cand_n = torch.minimum(torch.maximum(cand_n, lo), hi)
        candidates = norm.denormalize(kind, norm_params, norm_state, cand_n)
        rollout_controls = eval_spline(new_times, candidates, time + rollout_ts, order)
        sim_controls = task.task_to_sim_ctrl(rollout_controls)
        R = sim_controls.shape[0]
        qpos0, qvel0 = current_state[: pm.nq].expand(R, pm.nq), current_state[pm.nq :].expand(R, pm.nv)
        iterations = ctrl.controller_cfg.solver_iterations
        if task.uses_locomotion_policy:
            # forces start cold every solve; efc_warm is carried unchanged
            out = policy_rollout_lanes(
                pm, task.policy, qpos0, qvel0, sim_controls, carry.last_policy_output, task.physics_substeps,
                iterations,
            )
            states, sensors, last_pout = out.states, out.sensordata, out.final_policy_output
        else:
            out = rollout_lanes(pm, qpos0, qvel0, sim_controls, task.physics_substeps, iterations, efc_warm)
            states, sensors, efc_warm = out.states, out.sensordata, out.efc0
        rewards = task.reward(states, sensors, rollout_controls, task_params, metadata)
        nominal_n, opt_state = optimizer.update(opt_params, opt_state, cand_n, rewards)
        norm_state = norm.update_normalizer(kind, norm_params, norm_state, candidates)
    new_nominal = norm.denormalize(kind, norm_params, norm_state, nominal_n)

    n_trace = len(ctrl.trace_sensors)
    k = min(ctrl.max_num_traces, optimizer.num_rollouts)
    if n_trace > 0 and k > 0:
        elite = top_k_indices(rewards, k)
        tr = sensors[elite][:, :, ctrl.trace_inds]  # (k, T, 3 * n_trace)
        tr = tr.reshape(k, tr.shape[1], n_trace, 3).transpose(1, 2)  # (k, n_trace, T, 3)
        traces = torch.stack([tr[:, :, :-1], tr[:, :, 1:]], dim=3)
    else:
        traces = torch.zeros((0, 0, 0, 2, 3), dtype=ctrl.dtype, device=ctrl.device)
    new_carry = replace(
        carry, times=new_times, nominal_knots=new_nominal, opt_state=opt_state, norm_state=norm_state,
        efc_warm=efc_warm, last_policy_output=last_pout,
    )
    mirror = torch.cat([new_times.reshape(-1), new_nominal.reshape(-1), rewards.reshape(-1), traces.reshape(-1)])
    if ctrl.controller_cfg.full_outputs or type(task).post_rollout is not Task.post_rollout:
        return new_carry, SolveOutputs(rewards, states, sensors, rollout_controls, candidates, traces, mirror)
    return new_carry, SolveOutputs(rewards, None, None, None, None, None, mirror)


class _InFlight(NamedTuple):
    """A dispatched solve: its carry, outputs and metadata, the host buffer
    its mirror is copied into, and the event that ends that copy (None on the
    CPU)."""

    carry: SolverState
    outputs: SolveOutputs
    metadata: dict
    host_mirror: torch.Tensor
    ready: torch.cuda.Event | None


class Controller:
    """Host-side controller with the JAX package's API (update_action,
    action(t), spline_data, update_states, flush_pipeline, rewards,
    nominal_knots, traces, last_plan_timing), on the task's device and
    dtype."""

    def __init__(
        self, controller_config: ControllerConfig, task: Task, optimizer: Optimizer, seed: int | None = None
    ) -> None:
        self._controller_cfg = controller_config
        self.task = task
        self.optimizer = optimizer
        self.pm = task.planning_model
        lane_supported(self.pm)
        self.device = task.device
        self.dtype = task.dtype
        self.seed = seed
        self.system_metadata: dict[str, Any] = {}
        self.available_optimizers = get_registered_optimizers()
        self.available_tasks = get_registered_tasks()
        self.trace_sensors = task.trace_sensor_ids
        # on the device: indexing with a host list would copy it up, and wait, on every solve
        self.trace_inds = torch.as_tensor(
            [adr + k for adr in task.trace_sensor_adr for k in range(3)], dtype=torch.long, device=self.device
        )
        self.last_plan_timing: dict[str, float] | None = None
        self.last_outputs: SolveOutputs | None = None
        self.traces: np.ndarray | None = None
        self.rewards = np.zeros(self.optimizer_cfg.num_rollouts)
        self._args_cache: dict[str, Any] = {}
        self._pending: list[_InFlight] = []  # dispatched solves whose mirrors are not handed off yet
        self._consume_futures: list[Future] = []
        self._consumer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="judo-consume")
        self._mirror_lock = threading.Lock()
        self.reset()

    # --- config plumbing ---
    @property
    def controller_cfg(self) -> ControllerConfig:
        return self._controller_cfg

    @property
    def optimizer_cfg(self) -> OptimizerConfig:
        return self.optimizer.config

    @property
    def horizon(self) -> float:
        return self.controller_cfg.horizon

    @property
    def spline_order(self) -> str:
        return self.controller_cfg.spline_order

    @property
    def max_opt_iters(self) -> int:
        return self.controller_cfg.max_opt_iters

    @property
    def max_num_traces(self) -> int:
        return self.controller_cfg.max_num_traces

    @property
    def normalizer_kind(self) -> str:
        kind = self.controller_cfg.action_normalizer
        return kind if kind in norm.normalizer_registry else "none"

    @property
    def num_timesteps(self) -> int:
        """Rollout length, bucketed up to a multiple of 4 steps."""
        T = int(np.ceil(self.horizon / self.task.dt - 1e-9))
        return 4 * int(np.ceil(T / 4))

    @property
    def rollout_times(self) -> np.ndarray:
        return self.task.dt * np.arange(self.num_timesteps)

    @property
    def spline_timesteps(self) -> np.ndarray:
        return np.linspace(0.0, self.horizon, self.optimizer_cfg.num_nodes, endpoint=True)

    @property
    def time(self) -> float:
        return self.task.time

    @time.setter
    def time(self, value: float) -> None:
        self.task.time = value

    @property
    def spline_data(self) -> SplineData:
        """The published (times, knots, order), for the simulation loop."""
        with self._mirror_lock:
            return SplineData(t=self.times, x=self.nominal_knots, kind=self.spline_order)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    def _stage(self, x) -> torch.Tensor:
        """Per-solve host values on the device. On the card they go through
        pinned memory with a copy that does not wait: a copy from pageable
        memory would wait for every solve queued before it. The pinned
        block is not reused before its copy ends (PyTorch's host allocator
        records the copy's stream)."""
        host = torch.as_tensor(np.asarray(x, np.float64), dtype=self.dtype)
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    @staticmethod
    def _fingerprint(cfg: Any) -> tuple:
        """A value fingerprint of a config dataclass (arrays by their bytes)."""
        out = []
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if isinstance(v, np.ndarray):
                out.append((f.name, v.tobytes()))
            elif dataclasses.is_dataclass(v) and not isinstance(v, type):
                out.append((f.name, Controller._fingerprint(v)))
            else:
                out.append((f.name, v))
        return tuple(out)

    def _cached(self, name: str, key: Any, make) -> Any:
        """``make()``, kept on the device and made again only when ``key`` changes."""
        held = self._args_cache.get(name)
        if held is None or held[0] != key:
            held = self._args_cache[name] = (key, make())
        return held[1]

    def _device_params(self) -> tuple[Any, Any, Any, tuple[torch.Tensor, torch.Tensor]]:
        """(task_params, opt_params, norm_params, control bounds) on the
        device, uploaded again only when their source values change
        (controller.py:598-615 of the JAX package). An upload on every solve
        would wait for the card and serialize pipelined solves."""
        lohi = np.asarray(self.task.actuator_ctrlrange, np.float64)
        return (
            self._cached("task_params", self._fingerprint(self.task.config), self.task.task_params),
            self._cached("opt_params", (self._fingerprint(self.optimizer.config), self.dtype),
                         lambda: self.optimizer.params(self.dtype, self.device)),
            self._cached("norm_params", (self.normalizer_kind, lohi.tobytes()), self._norm_params),
            self._cached("ctrl_bounds", lohi.tobytes(), lambda: (self._tensor(lohi[:, 0]), self._tensor(lohi[:, 1]))),
        )

    def _device_times(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(spline_ts, rollout_ts) on the device, uploaded again only when the
        horizon, node count or bucketed rollout length change (controller.py:617-626)."""
        key = (float(self.horizon), self.optimizer_cfg.num_nodes, self.num_timesteps, float(self.task.dt))
        return self._cached(
            "times", key, lambda: (self._tensor(self.spline_timesteps), self._tensor(self.rollout_times))
        )

    def _enforce_cubic_min_nodes(self) -> None:
        if self.optimizer_cfg.num_nodes < 4 and self.spline_order == "cubic":
            warnings.warn("Cubic splines require at least 4 nodes. Setting num_nodes=4.", stacklevel=2)
            self.optimizer_cfg.num_nodes = 4

    def _norm_params(self) -> dict:
        return norm.make_normalizer_params(
            self.normalizer_kind, self.task.nu, ctrlrange=self.task.actuator_ctrlrange, dtype=self.dtype,
            device=self.device,
        )

    def _init_efc_warm(self) -> torch.Tensor:
        nefc = num_constraint_rows(self.pm)
        return torch.zeros((self.optimizer_cfg.num_rollouts, max(nefc, 1)), dtype=self.dtype, device=self.device)

    def _init_policy_output(self) -> torch.Tensor | None:
        if not self.task.uses_locomotion_policy:
            return None
        return torch.zeros((self.optimizer_cfg.num_rollouts, 12), dtype=self.dtype, device=self.device)

    # --- main entry points ---
    def update_action(self) -> None:
        """One planning step; per-stage times land in ``last_plan_timing``:
        prep (host staging), device (the dispatch, which returns before the
        card has run the solve) and sync (publishing the mirrors; at
        ``pipeline_depth > 0`` only handing the oldest solve to the consumer).

        With ``pipeline_depth > 0`` the call dispatches the new solve first and
        then hands the oldest in-flight solve to the consumer thread once more
        than ``depth`` are pending: the card works on solve N while the host
        publishes solve N - depth. The carry chains on the device with no
        host round trip, so only the published mirrors lag by ``depth``
        solves (controller.py:629-717 of the JAX package)."""
        t0 = _time.perf_counter()
        if self.current_state.shape != (self.pm.nq + self.pm.nv,):
            raise ValueError(f"current_state has shape {self.current_state.shape}")
        if self.optimizer_cfg.num_rollouts < 1:
            raise ValueError("Need at least one rollout!")
        self._enforce_cubic_min_nodes()
        self._sync_state_shapes()
        metadata = self.task.pre_rollout(self.current_state)
        merged = {**self.system_metadata, **metadata}
        device_meta = {k: self._stage(v) for k, v in merged.items() if not isinstance(v, str)}
        task_params, opt_params, norm_params, ctrl_bounds = self._device_params()
        spline_ts, rollout_ts = self._device_times()
        t1 = _time.perf_counter()
        self._carry, outputs = solve(
            self, self._carry, self._stage(self.current_state), self._stage(self.time), task_params, opt_params,
            norm_params, device_meta, spline_ts, rollout_ts, ctrl_bounds,
        )
        self._pending.append(_InFlight(self._carry, outputs, merged, *self._start_readback(outputs.mirror)))
        t2 = _time.perf_counter()
        depth = max(int(self.controller_cfg.pipeline_depth), 0)
        if depth == 0:
            while self._pending:
                self._consume(self._pending.pop(0))
        else:
            while len(self._pending) > depth:
                solved = self._pending.pop(0)
                # post_rollout stays on this thread: it may change task state
                # that the next dispatch reads; only the wait for the mirror
                # goes to the consumer, which publishes strictly in order
                self._post_rollout(solved)
                self._consume_futures.append(self._consumer.submit(self._consume_mirrors, solved))
            while len(self._consume_futures) > 2:  # bound the backlog (controller.py:706-707)
                self._consume_futures.pop(0).result()
        t3 = _time.perf_counter()
        self.last_plan_timing = {
            "prep_ms": 1e3 * (t1 - t0), "device_ms": 1e3 * (t2 - t1), "sync_ms": 1e3 * (t3 - t2),
            "total_ms": 1e3 * (t3 - t0),
        }

    def _start_readback(self, mirror: torch.Tensor) -> tuple[torch.Tensor, torch.cuda.Event | None]:
        """Queue the mirror's copy to the host behind the solve: on the card
        into a pinned buffer of this solve's own (the host allocator reuses
        no block while a copy into it is pending), followed by an event the
        consumer waits on (the counterpart of ``copy_to_host_async``,
        controller.py:678-681). On the CPU the mirror is already there."""
        if mirror.device.type != "cuda":
            return mirror, None
        host = torch.empty(mirror.shape, dtype=mirror.dtype, pin_memory=True)
        host.copy_(mirror, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(mirror.device))
        return host, ready

    def _post_rollout(self, solved: "_InFlight") -> None:
        outputs = solved.outputs
        if outputs.states is not None:
            self.task.post_rollout(outputs.states, outputs.sensors, outputs.rollout_controls, solved.metadata)

    def _consume(self, solved: "_InFlight") -> None:
        """Publish one solve's outputs on this thread."""
        self._post_rollout(solved)
        self._consume_mirrors(solved)

    def _consume_mirrors(self, solved: "_InFlight") -> None:
        """Wait for one solve's mirror to reach the host and publish it. The
        layout's sizes come from that solve's own carry."""
        if solved.ready is not None:
            solved.ready.synchronize()
        flat = solved.host_mirror.numpy().astype(np.float64)
        n, nu = solved.carry.times.shape[0], solved.carry.nominal_knots.shape[1]
        r = solved.outputs.rewards.shape[0]
        times = flat[:n]
        knots = flat[n : n + n * nu].reshape(n, nu)
        rewards = flat[n + n * nu : n + n * nu + r]
        traces = flat[n + n * nu + r :].reshape(-1, 2, 3)
        with self._mirror_lock:
            self.last_outputs = solved.outputs
            self.times, self.nominal_knots, self.rewards = times, knots, rewards
            self.update_spline(times, knots)
            self.traces = traces if traces.size else None

    def flush_pipeline(self) -> None:
        """Publish every in-flight solve (``pipeline_depth > 0``), in order."""
        while self._consume_futures:
            self._consume_futures.pop(0).result()
        while self._pending:
            self._consume(self._pending.pop(0))

    def update_states(self, state_msg: MujocoState) -> None:
        """Take the simulation's state message (controller.py:777-781)."""
        self.current_state = np.concatenate([state_msg.qpos, state_msg.qvel])
        self.time = state_msg.time
        self.system_metadata = state_msg.sim_metadata

    def update_traces(self, outputs: SolveOutputs, traces: np.ndarray | None = None) -> None:
        """Flatten the elite traces (k, n_trace, T - 1, 2, 3) to the (k * n_trace * (T - 1), 2, 3)
        wire layout, elite-major (controller.py:767-775)."""
        tr = np.asarray(outputs.traces.cpu()) if traces is None else traces
        if tr.size == 0:
            self.traces = None
            return
        self.traces = tr.reshape(-1, 2, 3)

    def action(self, time: float) -> np.ndarray:
        """The published plan at ``time``; a consistent snapshot while the
        consumer thread publishes."""
        with self._mirror_lock:
            return self.spline(time)

    def update_spline(self, times: np.ndarray, controls: np.ndarray) -> None:
        fill = (controls[..., 0, :], controls[..., -1, :])
        self.spline = interp1d(times, controls, kind=self.spline_order, axis=-2, fill_value=fill, bounds_error=False)

    def reset(self) -> None:
        """Reset task and solver state. In-flight solves are dropped; a
        publish already running on the consumer cannot be cancelled and is
        waited for, so no pre-reset mirror lands after this returns."""
        for f in self._consume_futures:
            if not f.cancel():
                f.result()
        self._consume_futures = []
        self._pending = []
        self.task.reset()
        self._enforce_cubic_min_nodes()
        n = self.optimizer_cfg.num_nodes
        warm = np.tile(self.task.optimizer_warm_start(), (n, 1))
        times0 = self.task.time + self.spline_timesteps
        seed = self.seed if self.seed is not None else int(np.random.randint(0, 2**31 - 1))
        self._carry = SolverState(
            times=self._tensor(times0),
            nominal_knots=self._tensor(warm),
            opt_state=self.optimizer.init_state(self.dtype, self.device),
            norm_state=norm.init_normalizer_state(
                self.normalizer_kind, self.task.nu, self._norm_params(), self.dtype, self.device
            ),
            efc_warm=self._init_efc_warm(),
            generator=torch.Generator(device=self.device).manual_seed(seed),
            last_policy_output=self._init_policy_output(),
        )
        self.times = np.asarray(times0)
        self.nominal_knots = warm
        self.current_state = np.concatenate([self.task.qpos, self.task.qvel])
        self.update_spline(self.times, self.nominal_knots)

    def _sync_state_shapes(self) -> None:
        """Re-zero the per-rollout carries after a change of num_rollouts;
        after a change of num_nodes, re-interpolate the nominal knots and the
        optimizer state (CEM's sigma) linearly onto the new knot times, and
        re-initialise any state that has no knot axis to carry."""
        if self._carry.efc_warm.shape[0] != self.optimizer_cfg.num_rollouts:
            self._carry.efc_warm = self._init_efc_warm()
            self._carry.last_policy_output = self._init_policy_output()
        n = self.optimizer_cfg.num_nodes
        if self._carry.nominal_knots.shape[0] != n:
            old_times = self._carry.times
            new_times = torch.linspace(float(old_times[0]), float(old_times[-1]), n, dtype=self.dtype, device=self.device)
            nominal = eval_spline(old_times, self._carry.nominal_knots, new_times, "linear")
            opt_state = self.optimizer.pre_optimization(
                self.optimizer.params(self.dtype, self.device), self._carry.opt_state, old_times, new_times
            )
            init = self.optimizer.init_state(self.dtype, self.device)
            opt_state = {k: v if v.shape == init[k].shape else init[k] for k, v in opt_state.items()}
            self._carry = replace(self._carry, times=new_times, nominal_knots=nominal, opt_state=opt_state)


def make_controller(
    init_task: str,
    init_optimizer: str,
    device: Any = "cuda",
    dtype: torch.dtype = torch.float32,
    seed: int | None = None,
) -> Controller:
    """A controller from registry names, on ``device`` in ``dtype``. The
    default device is the card; without a CUDA GPU this raises, and the
    caller passes ``device="cpu"``. The per-task defaults are registered
    once, when the packages are imported, so a launch config's overrides of
    them stand."""
    task_entry = get_registered_tasks().get(init_task)
    opt_entry = get_registered_optimizers().get(init_optimizer)
    if task_entry is None:
        raise KeyError(f"Task {init_task} not found in task registry.")
    if opt_entry is None:
        raise KeyError(f"Optimizer {init_optimizer} not found in optimizer registry.")
    task = task_entry[0](device=device, dtype=dtype)
    opt_cls, opt_cfg_cls = opt_entry
    opt_cfg = opt_cfg_cls()
    opt_cfg.set_override(init_task)
    controller_cfg = ControllerConfig()
    controller_cfg.set_override(init_task)
    return Controller(controller_cfg, task, opt_cls(opt_cfg, task.nu), seed=seed)
