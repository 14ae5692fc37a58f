"""Profiling hooks (counterpart of ``judo_tpu/utils/profiling.py``).

- ``span(name, into)`` times a host region of the controller: the always-on
  record of each solve (``Controller.plan_log``, ``last_plan_timing``) is
  built from its spans, and while ``torch.profiler`` records, each span also
  lies in the profiler's trace as ``judo.<name>``, on the card's timeline;
- ``trace(logdir)`` records a block with ``torch.profiler``: host activity,
  and the card's kernels and copies where a CUDA device exists, written as a
  Chrome trace JSON under ``logdir`` (open it in Perfetto or
  chrome://tracing). Use it around a few solves, not a whole benchmark.

The controller's spans (``controller/controller.py``, ``controller/
solve_graph.py``), each added to the record of the solve it serves:

- ``plan``: one ``update_action`` call, around all of the below that runs in
  it; its trace event's args carry the solve's id;
- ``prep.inputs``: the checks, the metadata, the parameters and time grids
  kept on the card, the pinned staging of the state and time;
- ``prep.task``: inside ``prep.inputs``, the task's ``pre_rollout``, whose
  metadata (fr3_pick's phase) the solve reads;
- ``prep.lookup``: the shape signature and the solve cache's lookup, insert or
  evict;
- ``dispatch.copy``, ``dispatch.noise``: the solve cache's entry copying the
  carry and inputs into its buffers, and drawing the noise;
- ``dispatch.capture``: an entry's warm-up and graph capture (its first call
  on the card);
- ``dispatch.replay``: the graph replay (on a mesh, with the copies between
  its graphs); on the CPU, the eager solve;
- ``dispatch.readback``: the output clones and the mirror's copy to the host,
  queued behind the solve, and its event;
- ``sync.backlog`` (``pipeline_depth`` > 0): the dispatching thread's wait on
  the consumer's backlog;
- ``post_rollout``: the task's hook on the solve's outputs;
- ``wait``: the host blocked until the solve's mirror is on the host;
- ``publish``: the mirror's unpack and the new spline, under the mirror lock.

No span sits inside a captured solve, and none reads the card. With no
profiler a span costs two ``perf_counter_ns`` reads and a dict store (about
a microsecond in CPython); no ``record_function`` is entered and nothing
reaches torch's dispatcher. While a profiler records, each span also enters
and leaves one ``record_function``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator

import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

# The prefix of every span's name in the profiler's trace.
TRACE_PREFIX = "judo."


class span:
    """A named host region: ``with span("prep.lookup", spans):``.

    On exit its duration in ms is added to ``into[name]`` (where ``into`` is
    given); ``t0`` and ``t1`` hold its ``perf_counter_ns`` stamps at entry
    and exit. Only while torch's profiler records does it also open
    ``record_function("judo." + name)``, with ``args`` as the event's
    arguments, so that the region lies in the profiler's trace on the same
    clock as the card's kernels."""

    __slots__ = ("name", "into", "args", "t0", "t1", "_event")

    def __init__(self, name: str, into: dict | None = None, args=None) -> None:
        self.name, self.into, self.args = name, into, args
        self._event = None

    def __enter__(self) -> "span":
        if autograd_profiler._is_profiler_enabled:
            self._event = record_function(TRACE_PREFIX + self.name, None if self.args is None else str(self.args))
            self._event.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self.into is not None:
            self.into[self.name] = self.into.get(self.name, 0.0) + (self.t1 - self.t0) / 1e6
        if self._event is not None:
            self._event.__exit__(*exc)
            self._event = None


@contextmanager
def trace(logdir: str | Path) -> Iterator[profile]:
    """``torch.profiler`` around a block: ``with profiling.trace("/tmp/tr") as prof:``.
    On leaving the block the trace is written to
    ``logdir/trace_<nanoseconds since the epoch>.json``; its path is
    ``prof.trace_path``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = logdir / f"trace_{time.time_ns()}.json"
    prof.export_chrome_trace(str(prof.trace_path))
