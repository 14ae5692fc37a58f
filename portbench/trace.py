"""The traced run's profile: ``torch.profiler`` over a steady slice of plans
after the window, read back from its Chrome trace.

The slice is bounded by the card's own events: it runs from the start of
the first launch of the cell's rollout kernel to the end of the last, with
the pipeline flushed before the profiler starts and before it stops, so that
every launch in the trace belongs to one of the slice's plans and a plan
that returns before its solve has run (``pipeline_depth`` > 0) is still
measured by its device work. The card's busy time is the union of its
kernel, copy and set intervals over the slice. The breakdown names the
device operations that took most time, and splits the card's idle time by what the benchmark's
thread was doing meanwhile: its innermost span and innermost host event.
"""

from __future__ import annotations

import json
import shutil
import tempfile
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Profile:
    """``torch.profiler`` with CPU and CUDA activities, started and stopped
    by hand; its trace goes to a directory of its own under ``TMPDIR``, is
    read back and removed."""

    def __init__(self) -> None:
        import torch

        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        )

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> None:
        self.prof.stop()

    def read(self) -> list:
        """The trace's complete events ("ph": "X")."""
        tmp = Path(tempfile.mkdtemp(prefix="portbench-trace-"))
        try:
            path = tmp / "trace.json"
            self.prof.export_chrome_trace(str(path))
            with open(path) as f:
                return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def span(name: str):
    import torch

    return torch.profiler.record_function(name)


def merged(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], as disjoint sorted intervals."""
    out: list = []
    for s_, e_ in sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi):
        if out and s_ <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e_)
        else:
            out.append([s_, e_])
    return out


def union_ms(intervals, lo: float, hi: float) -> float:
    """Length in ms of the union of (start, end) microsecond intervals clipped to [lo, hi]."""
    return sum(e_ - s_ for s_, e_ in merged(intervals, lo, hi)) / 1e3


class Slice:
    """The traced slice of a run, read from the profiler's events: from the
    start of the first launch of ``kernel`` (one a plan) to the end of the
    last; ``plans`` is the number of its launches. A trace without one (no
    card) gives an empty slice, from which the readers read nothing."""

    def __init__(self, events: list, kernel: str) -> None:
        self.events = events
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        launches = [e for e in self.device if e.get("cat") == "kernel" and kernel in e["name"]]
        self.lo = min((e["ts"] for e in launches), default=0.0)
        self.hi = max((e["ts"] + e["dur"] for e in launches), default=0.0)
        self.plans = len(launches)
        self.window_s = (self.hi - self.lo) / 1e6
        self.busy_s = union_ms([(e["ts"], e["ts"] + e["dur"]) for e in self.device], self.lo, self.hi) / 1e3

    def kernels(self, name: str) -> list:
        """The slice's kernel events whose name holds ``name``."""
        return [e for e in self.device if e.get("cat") == "kernel" and name in e["name"] and self.lo <= e["ts"] < self.hi]

    def breakdown(self, top: int = 10) -> dict:
        by_op: dict = defaultdict(float)
        for e in self.device:
            s_, e_ = max(e["ts"], self.lo), min(e["ts"] + e["dur"], self.hi)
            if e_ > s_:
                by_op[e["name"]] += (e_ - s_) / 1e6
        busy = merged([(e["ts"], e["ts"] + e["dur"]) for e in self.device], self.lo, self.hi)
        gaps = [(a[1], b[0]) for a, b in zip([[self.lo, self.lo]] + busy, busy + [[self.hi, self.hi]]) if b[0] > a[1]]
        by_host: dict = defaultdict(float)
        pieces, g = self.host_timeline(), 0
        for name, s_, e_ in pieces:  # both sorted: walk the gaps alongside
            while g < len(gaps) and gaps[g][1] <= s_:
                g += 1
            k = g
            while k < len(gaps) and gaps[k][0] < e_:
                by_host[name] += (min(e_, gaps[k][1]) - max(s_, gaps[k][0])) / 1e6
                k += 1
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}

    def host_timeline(self) -> list:
        """The benchmark's thread over the slice, cut where its events open or
        close, each piece named "span / event": the benchmark's innermost span
        and the innermost host event open there (the latest opened)."""
        tids = {e.get("tid") for e in self.events if e.get("cat") == "user_annotation"
                and e["name"].startswith("portbench.")}
        host = [e for e in self.events if e.get("cat") in HOST_CATS and e.get("tid") in tids
                and e["ts"] < self.hi and e["ts"] + e["dur"] > self.lo]
        points = sorted([(e["ts"] + e["dur"], 0, i) for i, e in enumerate(host)]
                        + [(e["ts"], 1, i) for i, e in enumerate(host)])
        spans: list = []  # open events, in the order they opened
        inner: list = []
        out, t_prev = [], self.lo
        for t, opens, i in points:
            t = min(max(t, self.lo), self.hi)
            if t > t_prev:
                name = host[spans[-1]]["name"] if spans else "between spans"
                if inner:
                    name += " / " + host[inner[-1]]["name"]
                out.append((name, t_prev, t))
                t_prev = t
            stack = spans if host[i]["name"].startswith("portbench.") else inner
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
        if self.hi > t_prev:
            out.append(("between spans", t_prev, self.hi))
        return out
