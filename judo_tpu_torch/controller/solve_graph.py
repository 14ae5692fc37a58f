"""The solve cache's entry: one planning solve on static buffers, captured once
as a CUDA graph and replayed on every plan (the port's counterpart of the
``jax.jit(solve)`` that ``judo_tpu/controller/controller.py:_build_solve``
makes once per shape signature).

An entry belongs to one shape signature (``Controller._signature``). It owns
static buffers for everything a solve reads: the state and the time, the task,
optimizer and normalizer parameters, the control bounds, the metadata, the
knot and rollout time offsets, the carried solver state and the sampling noise
of each optimizer iteration. A call

- copies the inputs into their buffers: the per-solve ones from the pinned
  staging the controller made, without waiting; a parameter only when its
  tensor is another than the one the buffer took last (the controller makes
  a new tensor when a value changes);
- draws the noise from the carry's generator into the noise buffer, one draw
  per optimizer iteration in iteration order, which gives the values the eager
  ``solve`` draws, bitwise;
- runs the solve: on the card a replay of the graph; on the CPU the eager
  ``solve`` on the same buffers;
- clones the outputs behind it on the card (the next replay overwrites the
  graph's own) and hands out a carry made of its buffers.

Each of these is a span (``utils/profiling.py``: ``dispatch.copy``,
``dispatch.noise``, ``dispatch.capture``, ``dispatch.replay``,
``dispatch.readback``) in the record of the solve; the spans sit around the
capture and the replay, never inside the captured solve.

The graph is captured at the entry's first call on the card. The solve is first
run once on a side stream, which fills what a capture may not: the packed model
and policy, the task's constants on the card, the kernels' shared-memory
attribute. That warm-up leaves the carry and the generator alone. The capture
uses ``capture_error_mode="thread_local"``, since the plant's thread launches
its kernel meanwhile, and ends by copying the new carry into the carry's
buffers, so the carry chains on the card with no trip to the host. A capture
that fails raises ``SolveCaptureError`` naming the operation; nothing falls
back to the eager solve.

With a mesh (``parallel/mesh.py``) the capture is cut at each optimizer
iteration's rollouts (``SolveCapture``). One graph cannot hold a solve whose
shards sit on other devices (a capture is bound to one device) or in other
processes (a collective waits outside it); every mesh takes the cut path, a
mesh whose shards all sit on the lead device too, so that a mesh on one card
runs the code a mesh over several runs. The lead device's graphs run from sampling to the shards'
input blocks and from the gathered outputs on; each device of this process's
shards has a graph of its own, in its own memory pool, with its shards'
launches (several shards on one device fork onto streams of their own inside
it). Between the replays the inputs are copied to the other devices'
buffers, and the outputs joined into the lead device's and gathered from
every process, as ``parallel/shards.py`` joins them when the solve runs
eagerly (``non_blocking`` copies, ordered by the streams' events). The
warm-up runs the shards eagerly on their streams.

The cache is shared by the controllers of a process. When another
controller's solve of the same signature comes, the carry handed to the
previous one is cloned off the buffers first. The kernels' launch counters
grow by the launches the graph holds at each replay, so they count solves
run; warm-ups and captures are tallied apart (``SolveGraph.captures``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable

import torch

from judo_tpu_torch.parallel.mesh import same_device
from judo_tpu_torch.parallel.shards import batch_first, join_buffers, join_shards, launch_shards, shard_blocks
from judo_tpu_torch.physics.fused_rollout import add_launches, tallied_launches
from judo_tpu_torch.utils.profiling import span

# The carried solver state's fields that are tensors (or trees of them); the
# generator stays with the controller that holds the carry.
CARRY_FIELDS = ("times", "nominal_knots", "opt_state", "norm_state", "efc_warm", "last_policy_output")


class SolveCaptureError(RuntimeError):
    """Capturing the planning solve as a CUDA graph failed."""


def leaves(tree) -> list:
    """The tensors (and Nones) of a tree of dicts, lists and tuples, dict
    entries in the order of their keys."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` applied to every tensor of a tree; Nones stay."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def tree_spec(tree) -> Any:
    """A hashable description of a tree: its keys, and each tensor's shape and dtype."""
    if isinstance(tree, dict):
        return tuple((k, tree_spec(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(tree_spec(v) for v in tree)
    return None if tree is None else (tuple(tree.shape), str(tree.dtype))


def noise_shape(ctrl) -> tuple[int, ...]:
    """(optimizer iterations, R - 1, N, nu): the noise of one solve of ``ctrl``."""
    return (1 if ctrl.optimizer.stop_cond() else ctrl.max_opt_iters, *ctrl.optimizer.noise_shape())


def draw_noise(ctrl, generator: torch.Generator, out: torch.Tensor | None = None) -> torch.Tensor:
    """The noise of one solve of ``ctrl``, drawn from ``generator`` one
    optimizer iteration after another into ``out``, or into a new tensor."""
    if out is None:
        out = torch.empty(noise_shape(ctrl), dtype=ctrl.dtype, device=ctrl.device)
    for i in range(out.shape[0]):
        ctrl.optimizer.draw_noise(generator, out[i])
    return out


def _where(e: BaseException) -> str:
    """The innermost line of the port in an exception's traceback, apart from this module."""
    frames = traceback.extract_tb(e.__traceback__)
    ours = [f for f in frames if "judo_tpu_torch" in f.filename and not f.filename.endswith("solve_graph.py")]
    f = (ours or frames)[-1]
    return f"{Path(f.filename).parent.name}/{Path(f.filename).name}:{f.lineno} ({f.line})"


class SolveGraph:
    """One cache entry: the solve of one shape signature on static buffers.

    ``solve_fn`` is the eager solve, ``solve(ctrl, carry, *inputs, noise)``;
    ``carry`` and ``inputs`` of the first call size the buffers."""

    builds = 0  # entries made
    captures = 0  # graphs captured (each with one warm-up run of the solve)

    def __init__(self, ctrl, carry, inputs, solve_fn: Callable) -> None:
        SolveGraph.builds += 1
        self.device = ctrl.device
        self.solve_fn = solve_fn
        self.lock = threading.Lock()
        self.carry = {f: tree_map(torch.empty_like, getattr(carry, f)) for f in CARRY_FIELDS}
        self.inputs = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device=self.device), inputs)
        self.noise = torch.empty(noise_shape(ctrl), dtype=ctrl.dtype, device=self.device)
        self._taken: list = [None] * len(leaves(self.inputs))  # the source tensor each input buffer took last
        self._holder: tuple | None = None  # (the controller, the carry handed to it)
        self.graphs: list[torch.cuda.CUDAGraph] = []  # one, or the segments and shard graphs of a cut capture
        self.steps: list[Callable] = []  # what one replay runs, in order: graph replays and the copies between
        self.outputs = None  # the graph's own outputs, overwritten by each replay
        self.launches: dict = {}  # (kernel wrapper, warps per rollout) -> its launches in one replay
        self.shards: list | None = None  # (device, batch) of each shard, as the capture split the rollouts
        self._devices: tuple = (self.device,)  # the devices the graphs run on
        self._held: tuple = ()  # the task, optimizer, trace indices and buffers whose tensors the graphs read

    # --- buffers ---
    def _carry_view(self):
        """The carry buffers as a SolverState (the solve reads no generator)."""
        from judo_tpu_torch.controller.controller import SolverState

        return SolverState(**self.carry, generator=None)

    def _release(self, handed) -> None:
        """Clone the buffers out of a carry handed to another controller."""
        bufs = [x for f in CARRY_FIELDS for x in leaves(self.carry[f]) if x is not None]
        for f in CARRY_FIELDS:
            setattr(handed, f, tree_map(lambda x: x.clone() if any(x is b for b in bufs) else x, getattr(handed, f)))

    def _take(self, ctrl, carry) -> None:
        """Make the carry buffers hold ``carry``: copy each field that is not
        already the buffer itself, after cloning the previous holder's carry
        off the buffers where that is another controller."""
        if self._holder is not None:
            owner, handed = self._holder
            other = owner()
            if other is not None and other is not ctrl:
                self._release(handed)
        for f in CARRY_FIELDS:
            for buf, src in zip(leaves(self.carry[f]), leaves(getattr(carry, f))):
                if src is not buf:
                    buf.copy_(src)

    def _copy_inputs(self, inputs) -> None:
        for i, (buf, src) in enumerate(zip(leaves(self.inputs), leaves(inputs))):
            if src is not self._taken[i]:
                buf.copy_(src, non_blocking=True)
                self._taken[i] = src

    # --- the solve ---
    def _step(self, ctrl, rollouts: Callable | None = None):
        """The eager solve on the buffers, its new carry copied into the carry
        buffers; ``rollouts`` runs its rollouts in place of the solve's own."""
        extra = () if rollouts is None else (rollouts,)
        new_carry, outputs = self.solve_fn(ctrl, self._carry_view(), *self.inputs, self.noise, *extra)
        for f in CARRY_FIELDS:
            for buf, new in zip(leaves(self.carry[f]), leaves(getattr(new_carry, f))):
                if new is not buf:
                    buf.copy_(new)
        return outputs

    def _capture(self, ctrl) -> None:
        """Warm the solve up on a side stream (outputs dropped, carry buffers
        untouched), then capture it with the carry's copy-back: into one
        graph, or, with a mesh, in segments cut at the rollouts
        (``SolveCapture``)."""
        current = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(current)
        with tallied_launches():
            with torch.cuda.stream(stream):
                self.solve_fn(ctrl, self._carry_view(), *self.inputs, self.noise)
            current.wait_stream(stream)
        mesh = ctrl.mesh
        # capture_begin/end, not torch.cuda.graph: its entry synchronizes the
        # card and empties the device and pinned-host caches, which would make
        # the plant's next tick allocate anew and wait behind in-flight solves
        capture = SolveCapture(self.device, cut=mesh is not None)
        try:
            with tallied_launches() as launches, torch.cuda.stream(stream):
                capture.begin()
                try:
                    outputs = self._step(ctrl, capture if mesh is not None else None)
                except BaseException:
                    capture.abort()
                    raise
                capture.end()
        except Exception as e:
            raise SolveCaptureError(
                f"capturing the planning solve as a CUDA graph failed at {_where(e)}: {e}. Inside the solve no "
                "operation may read a tensor on the host, wait for the card or allocate outside the graph's memory "
                "pool; the solve does not fall back to running eagerly"
            ) from e
        self.graphs, self.steps, self.outputs, self.launches = capture.graphs, capture.steps, outputs, dict(launches)
        self.shards = ctrl.last_shards
        self._devices = tuple(dict.fromkeys([self.device, *(mesh.local_devices() if mesh is not None else ())]))
        self._held = (ctrl.task, ctrl.optimizer, ctrl.trace_inds, capture.held)
        SolveGraph.captures += 1

    def __call__(self, ctrl, carry, inputs) -> tuple[Any, Any]:
        """One solve of ``ctrl`` from ``carry`` on ``inputs``: -> (the new
        carry, made of the entry's buffers; the outputs, cloned). Its
        ``dispatch.*`` spans go into the record of the solve ``ctrl``
        dispatches (``ctrl._solve_spans``)."""
        spans = ctrl._solve_spans
        with self.lock:
            with span("dispatch.copy", spans):
                self._take(ctrl, carry)
                self._copy_inputs(inputs)
            with span("dispatch.noise", spans):
                draw_noise(ctrl, carry.generator, self.noise)
            if self.device.type == "cuda":
                if not self.steps:
                    with span("dispatch.capture", spans):
                        self._capture(ctrl)
                with span("dispatch.replay", spans):
                    for step in self.steps:
                        step()
                for (wrapper, warps), n in self.launches.items():
                    add_launches(wrapper, n, warps)
                ctrl.last_shards = self.shards
                outputs = self.outputs
            else:
                with span("dispatch.replay", spans):
                    outputs = self._step(ctrl)
            with span("dispatch.readback", spans):
                outputs = type(outputs)(*(None if x is None else x.clone() for x in outputs))
                handed = dataclasses.replace(carry, **{f: tree_map(lambda x: x, v) for f, v in self.carry.items()})
                self._holder = (weakref.ref(ctrl), handed)
            return handed, outputs

    def close(self) -> None:
        """Free the graphs once the cards have run every replay queued on them."""
        with self.lock:
            if self.graphs:
                for d in self._devices:
                    torch.cuda.synchronize(d)
                for graph in self.graphs:
                    graph.reset()
                self.graphs, self.steps, self.outputs = [], [], None


class SolveCapture:
    """A solve captured as graphs on the ``lead`` device, the lead's capture
    running on the current stream. Without ``cut`` it is one graph. With
    ``cut`` it is the solve's ``rollouts`` and cuts the capture at each
    rollout: the lead graph so far ends after the shards' input blocks; each
    device of the shards captures its launches in a graph of its own (own
    pool, own stream); between the replays the inputs go to the other
    devices, and the outputs are joined into batch-last buffers on the lead
    and gathered from every process (``parallel/shards.py``); a new lead
    graph, in the lead graphs' shared pool, starts with the gathered outputs.
    ``steps`` replays the whole in order."""

    def __init__(self, lead: torch.device, cut: bool) -> None:
        self.lead = lead
        self.pool = torch.cuda.graph_pool_handle() if cut else None
        self.graphs: list[torch.cuda.CUDAGraph] = []
        self.steps: list[Callable] = []
        self.held: list = []  # the blocks, buffers and shard outputs the steps read
        self.graph: torch.cuda.CUDAGraph | None = None

    def begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def end(self) -> None:
        graph, self.graph = self.graph, None
        graph.capture_end()
        self.graphs.append(graph)
        self.steps.append(graph.replay)

    def abort(self) -> None:
        if self.graph is not None:
            with contextlib.suppress(Exception):
                self.graph.capture_end()
            self.graph = None

    def __call__(self, ctrl, launch, inputs: tuple) -> tuple:
        """The solve's rollouts at a cut: -> the gathered outputs, batch-first
        views of buffers the next lead graph reads."""
        lead = self.lead
        blocks = shard_blocks(ctrl, inputs[0].shape[0])
        parts = [[x[rows].contiguous() for x in inputs] for _, rows in blocks]
        self.end()
        outs: list = [None] * len(blocks)
        streams: dict = {}
        for dev in dict.fromkeys(d for d, _ in blocks):
            idx = [i for i, (d, _) in enumerate(blocks) if d == dev]
            stream = streams[dev] = torch.cuda.Stream(dev)
            if same_device(dev, lead):
                ins = {i: parts[i] for i in idx}
                pairs = []
            else:
                ins = {i: [torch.empty(p.shape, dtype=p.dtype, device=dev) for p in parts[i]] for i in idx}
                pairs = [(ins[i], parts[i]) for i in idx]
            self.steps.append(functools.partial(_copy_in, lead, stream, pairs))
            self.held.append(ins)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    shard_outs = launch_shards(ctrl, launch, [(dev, ins[i]) for i in idx])
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
            self.graphs.append(graph)
            self.steps.append(functools.partial(_replay_on, graph, stream))
            for i, o in zip(idx, shard_outs):
                outs[i] = [y.movedim(0, -1) for y in o]
        local, full = join_buffers(lead, outs)
        self.steps.append(functools.partial(join_shards, lead, outs, [streams[d] for d, _ in blocks], local, full))
        self.held.append((parts, outs, local, full))
        self.begin()
        return batch_first(local, full)


def _copy_in(lead: torch.device, stream: torch.cuda.Stream, pairs: list) -> None:
    """``stream`` waits for the lead's current stream; then each (buffers,
    sources) pair's sources are copied into its buffers on ``stream``'s
    device, ``stream`` waiting for the copies."""
    stream.wait_stream(torch.cuda.current_stream(lead))
    with torch.cuda.stream(stream):
        for dsts, srcs in pairs:
            for dst, src in zip(dsts, srcs):
                dst.copy_(src, non_blocking=True)


def _replay_on(graph: torch.cuda.CUDAGraph, stream: torch.cuda.Stream) -> None:
    with torch.cuda.stream(stream):
        graph.replay()
