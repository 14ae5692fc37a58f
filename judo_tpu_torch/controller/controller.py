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

Each solve runs through the solve cache (``Controller._get_solve``), as the
JAX package's runs through its LRU cache of compiled solves: one entry per
shape signature, at most 16, shared by the controllers of the process. On the
card an entry is the solve captured once as a CUDA graph on static buffers
and replayed on every plan (``solve_graph.py``); on the CPU it runs this
module's eager ``solve`` on the same buffers. ``solve`` stays the plain
version the graph is held against.

With a mesh (``parallel/mesh.py``), each optimizer iteration runs the rollout
kernel once per shard on the shard's block of the batch and gathers the
outputs back to the lead device in block order (``parallel/shards.py``).
Sampling, the rewards, the update, the normalizer and the traces run on the
lead device on the whole batch, with the code they use unsharded, and each
rollout is computed alone (one warp per rollout on the card, ``bsum`` in the
plain version), so the sharded solve equals the unsharded one bitwise.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import warnings
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, replace
from typing import Any, Callable, Literal, NamedTuple

import numpy as np
import torch
from scipy.interpolate import interp1d

from judo_tpu_torch.app.structs import MujocoState, SplineData
from judo_tpu_torch.config import OverridableConfig
from judo_tpu_torch.controller.solve_graph import SolveGraph, tree_spec
from judo_tpu_torch.gui import slider
from judo_tpu_torch.ops.splines import eval_spline
from judo_tpu_torch.optimizers import Optimizer, OptimizerConfig, get_registered_optimizers
from judo_tpu_torch.optimizers.base import top_k_indices
from judo_tpu_torch.parallel.mesh import RolloutMesh, broadcast_from_rank0, process_group, resolve_mesh, same_device
from judo_tpu_torch.parallel.shards import run_rollouts
from judo_tpu_torch.physics.fused_rollout import pack_model, rollout_lanes
from judo_tpu_torch.physics.model import lane_supported, num_constraint_rows
from judo_tpu_torch.physics.policy_rollout import policy_rollout_lanes
from judo_tpu_torch.tasks import Task, get_registered_tasks
from judo_tpu_torch.utils import normalization as norm
from judo_tpu_torch.utils.profiling import span


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


class SolveInputs(NamedTuple):
    """What one solve reads besides the carry and the noise: the state and
    time (staged host tensors, pinned on the card), the parameters, control
    bounds and time offsets on the device, and the metadata (staged)."""

    current_state: torch.Tensor  # (nq + nv,)
    time: torch.Tensor  # ()
    task_params: dict
    opt_params: Any
    norm_params: dict
    metadata: dict
    spline_ts: torch.Tensor  # (N,)
    rollout_ts: torch.Tensor  # (T,)
    ctrl_bounds: tuple[torch.Tensor, torch.Tensor]


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
    noise: torch.Tensor,
    rollouts: Callable = run_rollouts,
) -> tuple[SolverState, SolveOutputs]:
    """One planning solve (controller.py:361-547 of the JAX package).
    ``noise`` (iterations, R - 1, N, nu) holds each optimizer iteration's
    standard normal draws (``solve_graph.draw_noise``); the carry's
    generator is not read here. ``rollouts(ctrl, launch, inputs)`` runs each
    iteration's rollouts: ``run_rollouts`` (over the shards of a mesh), or a
    solve graph's cut capture (``solve_graph.SolveCapture``)."""
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
    for it in range(1 if optimizer.stop_cond() else ctrl.max_opt_iters):
        cand_n, opt_state = optimizer.sample_from_noise(opt_params, opt_state, nominal_n, noise[it])
        lo = norm.normalize(kind, norm_params, norm_state, ctrl_lo)
        hi = norm.normalize(kind, norm_params, norm_state, ctrl_hi)
        cand_n = torch.minimum(torch.maximum(cand_n, lo), hi)
        candidates = norm.denormalize(kind, norm_params, norm_state, cand_n)
        rollout_controls = eval_spline(new_times, candidates, time + rollout_ts, order)
        sim_controls = task.task_to_sim_ctrl(rollout_controls)
        R = sim_controls.shape[0]
        qpos0, qvel0 = current_state[: pm.nq].expand(R, pm.nq), current_state[pm.nq :].expand(R, pm.nv)
        if task.uses_locomotion_policy:
            # forces start cold every solve; efc_warm is carried unchanged
            states, sensors, last_pout = rollouts(
                ctrl, _policy_lanes, (qpos0, qvel0, sim_controls, carry.last_policy_output)
            )
        else:
            states, sensors, efc_warm = rollouts(ctrl, _lanes, (qpos0, qvel0, sim_controls, efc_warm))
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


def _lanes(ctrl: "Controller", qpos0, qvel0, sim_controls, efc_warm) -> tuple:
    """K1 on one batch: -> (states, sensors, step-0 forces)."""
    out = rollout_lanes(ctrl.pm, qpos0, qvel0, sim_controls, ctrl.task.physics_substeps,
                        ctrl.controller_cfg.solver_iterations, efc_warm)
    return out.states, out.sensordata, out.efc0


def _policy_lanes(ctrl: "Controller", qpos0, qvel0, sim_controls, last_policy_output) -> tuple:
    """K2 on one batch: -> (states, sensors, the last tick's policy output)."""
    out = policy_rollout_lanes(ctrl.pm, ctrl.task.policy, qpos0, qvel0, sim_controls, last_policy_output,
                               ctrl.task.physics_substeps, ctrl.controller_cfg.solver_iterations)
    return out.states, out.sensordata, out.final_policy_output


def _model_key(m) -> str:
    """A digest of the packed model the kernels read."""
    key = m._packed.get("digest")
    if key is None:
        pk = pack_model(m)
        key = m._packed["digest"] = hashlib.sha1(pk["mi"].tobytes() + pk["mf"].tobytes()).hexdigest()
    return key


def _policy_key(policy) -> str | None:
    """A digest of a locomotion policy's weights."""
    if policy is None:
        return None
    key = policy._packed.get("digest")
    if key is None:
        h = hashlib.sha1(str(policy.activations).encode())
        for lin in policy.layers:
            h.update(lin.weight.detach().double().cpu().numpy().tobytes())
            h.update(lin.bias.detach().double().cpu().numpy().tobytes())
        key = policy._packed["digest"] = h.hexdigest()
    return key


class _InFlight(NamedTuple):
    """A dispatched solve: its carry, outputs and metadata, the host buffer
    its mirror is copied into, the event that ends that copy (None on the
    CPU), its id, its spans (name -> ms) and the ``perf_counter_ns`` at the
    entry of the call that dispatched it."""

    carry: SolverState
    outputs: SolveOutputs
    metadata: dict
    host_mirror: torch.Tensor
    ready: torch.cuda.Event | None
    solve_id: int
    spans: dict
    t_call: int


class Controller:
    """Host-side controller with the JAX package's API (update_action,
    action(t), spline_data, update_states, flush_pipeline, rewards,
    nominal_knots, traces, last_plan_timing), on the task's device and
    dtype."""

    # The solve cache (controller.py:555-570 of the JAX package): at most
    # _SOLVE_CACHE_MAX entries, least recently used first. It is the
    # process's, not one controller's: a task or optimizer switch in the GUI
    # builds a new controller, and switching back finds the entry its first
    # controller made.
    _SOLVE_CACHE_MAX = 16
    _solve_cache: dict[tuple, SolveGraph] = {}
    _solve_cache_lock = threading.Lock()
    # The records of the last PLAN_LOG_MAX published solves (``plan_log``).
    PLAN_LOG_MAX = 4096

    def __init__(
        self, controller_config: ControllerConfig, task: Task, optimizer: Optimizer, seed: int | None = None,
        mesh: RolloutMesh | None = None,
    ) -> None:
        self._controller_cfg = controller_config
        self.task = task
        self.optimizer = optimizer
        self.pm = task.planning_model
        lane_supported(self.pm)
        self.device = task.device
        self.dtype = task.dtype
        self.seed = seed
        self.mesh = mesh  # optional: shard the rollouts over it
        self.last_shards: list[tuple[str, int]] | None = None  # (device, batch) of each shard of the last solve
        self._shard_streams: dict[tuple[int, torch.device], torch.cuda.Stream] = {}
        if mesh is not None and not same_device(self.device, mesh.lead):
            raise ValueError(
                f"the task's device {self.device} is not the mesh's lead device {mesh.lead} (the first device of this "
                "process's row), where the solve runs"
            )
        self._check_mesh()
        self.system_metadata: dict[str, Any] = {}
        self.available_optimizers = get_registered_optimizers()
        self.available_tasks = get_registered_tasks()
        self.trace_sensors = task.trace_sensor_ids
        # on the device: indexing with a host list would copy it up, and wait, on every solve
        self.trace_inds = torch.as_tensor(
            [adr + k for adr in task.trace_sensor_adr for k in range(3)], dtype=torch.long, device=self.device
        )
        self.last_plan_timing: dict[str, float] | None = None
        self.solves_dispatched = 0  # the next solve's id
        # one record a published solve, in the order they publish: {"id", "spans" (name -> ms), "latency_ms"}
        self.plan_log: deque[dict] = deque(maxlen=self.PLAN_LOG_MAX)
        self._solve_spans: dict | None = None  # the spans of the solve being dispatched, for the cache's entry
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

    def _check_mesh(self) -> None:
        """The rollouts must divide over the mesh: each shard takes an equal block."""
        if self.mesh is None:
            return
        R, ndev = self.optimizer_cfg.num_rollouts, self.mesh.devices.size
        if R % ndev:
            raise ValueError(f"num_rollouts {R} must divide over the {ndev}-device mesh for the lanes backend")

    def shard_stream(self, i: int, device: torch.device) -> torch.cuda.Stream:
        """The CUDA stream of shard ``i`` on ``device``, made at its first use."""
        key = (i, device)
        if key not in self._shard_streams:
            self._shard_streams[key] = torch.cuda.Stream(device)
        return self._shard_streams[key]

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    def _stage(self, x) -> torch.Tensor:
        """A per-solve host value as a host tensor the solve cache's entry
        copies into its buffer. On the card it is pinned, so that copy does
        not wait: a copy from pageable memory would wait for every solve
        queued before it. The pinned block is not reused before its copy ends
        (PyTorch's host allocator records the copy's stream)."""
        host = torch.as_tensor(np.asarray(x, np.float64), dtype=self.dtype)
        return host.pin_memory() if self.device.type == "cuda" else host

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

    def _signature(self, inputs: SolveInputs) -> tuple:
        """The shape signature of a solve on ``inputs``, as (name, value)
        pairs: every value the solve reads as a Python value, which a capture
        bakes in. The first 17 are the JAX package's ``_signature``
        (controller.py:283-315; the rollout backend names the port's kernel).
        The rest it leaves out: the optimizer config's fields that are not
        tensors of ``opt_params`` (``noise_ramp`` among them, which the JAX
        cache leaves out although its solve reads it), the normalizer kind,
        the trace sensors, a ``post_rollout`` override, dtype and device, the
        task's own values, the packed model and policy, and the keys, shapes
        and dtypes of the inputs (the metadata's keys among them)."""
        oc, cc, task = self.optimizer_cfg, self.controller_cfg, self.task
        extra = tuple(sorted((f, getattr(oc, f)) for f in ("num_elites",) if hasattr(oc, f)))
        opt_fields = tuple(
            (f.name, getattr(oc, f.name)) for f in dataclasses.fields(oc) if f.name not in inputs.opt_params
        )
        return (
            ("optimizer", type(self.optimizer).__name__),
            ("stop_cond", bool(self.optimizer.stop_cond())),
            ("num_rollouts", oc.num_rollouts),
            ("num_nodes", oc.num_nodes),
            ("use_noise_ramp", bool(oc.use_noise_ramp)),
            ("spline_order", cc.spline_order),
            ("num_timesteps", self.num_timesteps),
            ("max_opt_iters", int(cc.max_opt_iters)),
            ("action_normalizer", cc.action_normalizer),
            ("num_trace_elites", min(cc.max_num_traces, oc.num_rollouts)),
            ("rollout_backend", "fused_policy_rollout" if task.uses_locomotion_policy else "fused_rollout"),
            ("solver_iterations", cc.solver_iterations),
            ("full_outputs", bool(cc.full_outputs)),
            ("physics_substeps", int(task.physics_substeps)),
            ("uses_locomotion_policy", bool(task.uses_locomotion_policy)),
            ("ctrlrange", hash(np.asarray(task.actuator_ctrlrange).tobytes())),
            ("extra", extra),
            ("noise_ramp", float(oc.noise_ramp)),
            ("optimizer_config", opt_fields),
            ("optimizer_class", f"{type(self.optimizer).__module__}.{type(self.optimizer).__qualname__}"),
            ("normalizer_kind", self.normalizer_kind),
            ("trace_inds", tuple(task.trace_sensor_adr)),
            ("post_rollout", type(task).post_rollout is not Task.post_rollout),
            ("dtype", str(self.dtype)),
            ("device", str(self.device)),
            ("mesh", None if self.mesh is None else (self.mesh.key(), process_group())),
            ("task", task.solve_key()),
            ("model", _model_key(self.pm)),
            ("policy", _policy_key(getattr(task, "policy", None) if task.uses_locomotion_policy else None)),
            ("inputs", tree_spec(inputs)),
        )

    def _get_solve(self, inputs: SolveInputs) -> SolveGraph:
        """The solve cache's entry for the current signature (controller.py:
        557-570 of the JAX package): a hit refreshes the entry's place in the
        LRU order; a miss makes a new entry (captured at its first call on the
        card) and evicts the oldest beyond ``_SOLVE_CACHE_MAX``."""
        sig = self._signature(inputs)
        with Controller._solve_cache_lock:
            cache = Controller._solve_cache
            entry = cache.get(sig)
            if entry is None:
                entry = cache[sig] = SolveGraph(self, self._carry, inputs, solve)
                while len(cache) > self._SOLVE_CACHE_MAX:
                    cache.pop(next(iter(cache))).close()
            else:  # refresh the LRU order
                cache[sig] = cache.pop(sig)
        return entry

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
        """One planning step. Each dispatched solve gets an id (its
        ``solves_dispatched`` count) and a record of its spans
        (``utils/profiling.py`` names them), which goes into ``plan_log``
        when the solve is published, on the thread that publishes it, with
        ``latency_ms``: from this call's entry to the end of the solve's
        ``publish`` span, when ``action(t)`` starts to read the new plan.
        ``last_plan_timing`` holds this call's split, in ms, from the same
        spans: prep (``prep.inputs`` and ``prep.lookup``: host staging, with
        the task's ``pre_rollout`` inside it as ``prep.task``, and the solve
        cache's lookup),
        device (``dispatch.*``: the entry's copies, noise draws and graph
        replay, and the mirror's copy queued behind it, which return before
        the card has run the solve), sync (the rest of the call: publishing
        the mirrors; at ``pipeline_depth > 0`` only handing the oldest solve
        to the consumer, and waiting on its backlog) and total (``plan``).
        The spans cost two clock reads and a dict store each with no
        profiler; while ``torch.profiler`` records, they lie in its trace as
        ``judo.<span>`` events.

        With ``pipeline_depth > 0`` the call dispatches the new solve first and
        then hands the oldest in-flight solve to the consumer thread once more
        than ``depth`` are pending: the card works on solve N while the host
        publishes solve N - depth. The carry chains on the device with no
        host round trip, so only the published mirrors lag by ``depth``
        solves (controller.py:629-717 of the JAX package). A call waits only
        once more than two handed-off solves are unpublished, so with calls
        back to back a state is published about ``depth`` + 3 of the card's
        solves after the call that took it (its ``latency_ms``)."""
        solve_id, spans = self.solves_dispatched, {}
        with span("plan", spans, args=solve_id) as plan:
            self._plan(solve_id, spans, plan.t0)
        prep = spans["prep.inputs"] + spans["prep.lookup"]
        device = sum(ms for name, ms in spans.items() if name.startswith("dispatch."))
        total = spans["plan"]
        self.last_plan_timing = {"prep_ms": prep, "device_ms": device, "sync_ms": total - prep - device,
                                 "total_ms": total}

    def _plan(self, solve_id: int, spans: dict, t_call: int) -> None:
        """The body of ``update_action``'s ``plan`` span: dispatch solve
        ``solve_id`` and publish what the pipeline depth lets go. Its locals
        (the staged pinned buffers among them, whose release records CUDA
        events) are freed when it returns, inside the span."""
        with span("prep.inputs", spans):
            if self.current_state.shape != (self.pm.nq + self.pm.nv,):
                raise ValueError(f"current_state has shape {self.current_state.shape}")
            if self.optimizer_cfg.num_rollouts < 1:
                raise ValueError("Need at least one rollout!")
            self._enforce_cubic_min_nodes()
            self._check_mesh()
            self._sync_state_shapes()
            merged, inputs = self._solve_inputs(spans)
        with span("prep.lookup", spans):
            entry = self._get_solve(inputs)
        self._solve_spans = spans
        try:
            self._carry, outputs = entry(self, self._carry, inputs)
        finally:
            self._solve_spans = None
        with span("dispatch.readback", spans):
            readback = self._start_readback(outputs.mirror)
        self._pending.append(_InFlight(self._carry, outputs, merged, *readback, solve_id, spans, t_call))
        self.solves_dispatched = solve_id + 1
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
            with span("sync.backlog", spans):
                while len(self._consume_futures) > 2:  # bound the backlog (controller.py:706-707)
                    self._consume_futures.pop(0).result()

    def _solve_inputs(self, spans: dict | None = None) -> tuple[dict, SolveInputs]:
        """(the task's and the system's metadata, the next solve's inputs):
        the state, time and metadata staged, the rest kept on the device. The
        task's ``pre_rollout`` is the ``prep.task`` span, added to ``spans`` where given."""
        with span("prep.task", spans):
            task_metadata = self.task.pre_rollout(self.current_state)
        metadata = {**self.system_metadata, **task_metadata}
        task_params, opt_params, norm_params, ctrl_bounds = self._device_params()
        spline_ts, rollout_ts = self._device_times()
        staged = {k: self._stage(v) for k, v in metadata.items() if not isinstance(v, str)}
        return metadata, SolveInputs(
            self._stage(self.current_state), self._stage(self.time), task_params, opt_params, norm_params, staged,
            spline_ts, rollout_ts, ctrl_bounds,
        )

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
        with span("post_rollout", solved.spans):
            if outputs.states is not None:
                self.task.post_rollout(outputs.states, outputs.sensors, outputs.rollout_controls, solved.metadata)

    def _consume(self, solved: "_InFlight") -> None:
        """Publish one solve's outputs on this thread."""
        self._post_rollout(solved)
        self._consume_mirrors(solved)

    def _consume_mirrors(self, solved: "_InFlight") -> None:
        """Wait for one solve's mirror to reach the host and publish it, then
        log the solve's record. The layout's sizes come from that solve's own
        carry."""
        with span("wait", solved.spans):
            if solved.ready is not None:
                solved.ready.synchronize()
        with span("publish", solved.spans) as publish:
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
        # at depth 0 the call's own ``plan`` span lands in ``spans`` once the call returns
        self.plan_log.append({"id": solved.solve_id, "spans": solved.spans,
                              "latency_ms": (publish.t1 - solved.t_call) / 1e6})

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
        if self.mesh is not None and process_group()[0] > 1:
            # every process samples the same candidates: rank 0's seed
            seed = int(broadcast_from_rank0(torch.tensor([seed], device=self.device)).item())
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
    device: Any = None,
    dtype: torch.dtype = torch.float32,
    seed: int | None = None,
    mesh=None,
) -> Controller:
    """A controller from registry names, on ``device`` in ``dtype``. The
    default device is the card (with a mesh of CUDA devices, its lead
    device); without a CUDA GPU this raises, also with a mesh, and the
    caller passes ``device="cpu"`` (with a mesh of ``cpu`` devices). ``mesh``
    takes ``None``/``"none"``, ``"auto"``, ``"hybrid"`` or a ``RolloutMesh``
    (``resolve_mesh``): the rollouts shard over it, and ``num_rollouts``
    must divide by its device count. The per-task defaults are registered
    once, when the packages are imported, so a launch config's overrides of
    them stand."""
    mesh = resolve_mesh(mesh)
    if device is None:
        device = mesh.lead if mesh is not None and mesh.lead.type == "cuda" else "cuda"
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
    return Controller(controller_cfg, task, opt_cls(opt_cfg, task.nu), seed=seed, mesh=mesh)
