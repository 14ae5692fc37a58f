"""Profiling hooks (counterpart of ``judo_tpu/utils/profiling.py``).

- ``Controller.last_plan_timing`` gives the per-solve stage split (prep /
  device / sync) with no configuration;
- ``trace(logdir)`` records a block with ``torch.profiler``: host activity,
  and the card's kernels and copies where a CUDA device exists, written as a
  Chrome trace JSON under ``logdir`` (open it in Perfetto or
  chrome://tracing). Use it around a few solves, not a whole benchmark;
- ``annotate(name)`` labels a host region inside a live trace.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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


@contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named host region inside an active trace (``record_function``)."""
    with record_function(name):
        yield
