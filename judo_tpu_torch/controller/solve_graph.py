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

The graph is captured at the entry's first call on the card. The solve is first
run once on a side stream, which fills what a capture may not: the packed model
and policy, the task's constants on the card, the kernels' shared-memory
attribute. That warm-up leaves the carry and the generator alone. The capture
uses ``capture_error_mode="thread_local"``, since the plant's thread launches
its kernel meanwhile, and ends by copying the new carry into the carry's
buffers, so the carry chains on the card with no trip to the host. A capture
that fails raises ``SolveCaptureError`` naming the operation; nothing falls
back to the eager solve.

The cache is shared by the controllers of a process. When another
controller's solve of the same signature comes, the carry handed to the
previous one is cloned off the buffers first. The kernels' launch counters
grow by the launches the graph holds at each replay, so they count solves
run; warm-ups and captures are tallied apart (``SolveGraph.captures``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import traceback
import weakref
from pathlib import Path
from typing import Any, Callable

import torch

from judo_tpu_torch.physics.fused_rollout import tallied_launches

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
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs = None  # the graph's own outputs, overwritten by each replay
        self.launches: dict = {}  # kernel wrapper -> its launches in one replay
        self._held: tuple = ()  # the task, optimizer and trace indices whose tensors the graph reads

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
    def _step(self, ctrl):
        """The eager solve on the buffers, its new carry copied into the carry buffers."""
        new_carry, outputs = self.solve_fn(ctrl, self._carry_view(), *self.inputs, self.noise)
        for f in CARRY_FIELDS:
            for buf, new in zip(leaves(self.carry[f]), leaves(getattr(new_carry, f))):
                if new is not buf:
                    buf.copy_(new)
        return outputs

    def _capture(self, ctrl) -> None:
        """Warm the solve up on a side stream (outputs dropped, carry buffers
        untouched), then capture it with the carry's copy-back into a graph."""
        current = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(current)
        with tallied_launches():
            with torch.cuda.stream(stream):
                self.solve_fn(ctrl, self._carry_view(), *self.inputs, self.noise)
            current.wait_stream(stream)
        # capture_begin/end, not torch.cuda.graph: its entry synchronizes the
        # card and empties the device and pinned-host caches, which would make
        # the plant's next tick allocate anew and wait behind in-flight solves
        graph = torch.cuda.CUDAGraph()
        try:
            with tallied_launches() as launches, torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outputs = self._step(ctrl)
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                graph.capture_end()
        except Exception as e:
            raise SolveCaptureError(
                f"capturing the planning solve as a CUDA graph failed at {_where(e)}: {e}. Inside the solve no "
                "operation may read a tensor on the host, wait for the card or allocate outside the graph's memory "
                "pool; the solve does not fall back to running eagerly"
            ) from e
        self.graph, self.outputs, self.launches = graph, outputs, dict(launches)
        self._held = (ctrl.task, ctrl.optimizer, ctrl.trace_inds)
        SolveGraph.captures += 1

    def __call__(self, ctrl, carry, inputs) -> tuple[Any, Any]:
        """One solve of ``ctrl`` from ``carry`` on ``inputs``: -> (the new
        carry, made of the entry's buffers; the outputs, cloned)."""
        with self.lock:
            self._take(ctrl, carry)
            self._copy_inputs(inputs)
            draw_noise(ctrl, carry.generator, self.noise)
            if self.device.type == "cuda":
                if self.graph is None:
                    self._capture(ctrl)
                self.graph.replay()
                for wrapper, n in self.launches.items():
                    wrapper.launches += n
                outputs = self.outputs
            else:
                outputs = self._step(ctrl)
            outputs = type(outputs)(*(None if x is None else x.clone() for x in outputs))
            handed = dataclasses.replace(carry, **{f: tree_map(lambda x: x, v) for f, v in self.carry.items()})
            self._holder = (weakref.ref(ctrl), handed)
            return handed, outputs

    def close(self) -> None:
        """Free the graph once the card has run every replay queued on it."""
        with self.lock:
            if self.graph is not None:
                torch.cuda.synchronize(self.device)
                self.graph.reset()
                self.graph = self.outputs = None
