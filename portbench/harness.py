"""One run of one cell: set-up, warm-up, the timed window, in a traced run
the traced slice after it, the metrics, and the output check.

Nothing here names a cell, a configuration or a metric: the cell's files say
what to build and feed, ``BENCHMARK.json`` which metrics the cell reports,
and each per-layer metric is read by its own reader in ``metrics/``.
"""

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import cells, check, drive
from portbench.reference import plan as ref_plan
from portbench.reference.engine import dof_islands
from portbench.reference.model import num_constraint_rows
from portbench.trace import Profile, Slice, span


def shapes(setup: ref_plan.Setup, R: int) -> dict:
    """The sizes the kernel counts read, from the reference's model."""
    m = setup.model
    return {
        "nq": m.nq, "nv": m.nv, "nu": m.nu, "nsensordata": m.nsensordata, "nefc": num_constraint_rows(m),
        "islands": [e - s for s, e in dof_islands(m)], "iterations": max(setup.config["controller"]["solver_iterations"], 8),
        "rollouts": R, "steps": setup.num_timesteps, "substeps": setup.task.SUBSTEPS,
        "mlp": None if setup.policy is None else setup.policy.dims,
        "itemsize": np.dtype(setup.config["dtype"]).itemsize,
    }


class GcWatch:
    """Counts the cyclic collector's full collections while it is on, and their seconds."""

    def __init__(self) -> None:
        self.full, self.seconds, self._t = 0, 0.0, None

    def __call__(self, phase: str, info: dict) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.full += 1
            self.seconds += time.perf_counter() - self._t
            self._t = None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phases(t_start: float, marks: list) -> str:
    """The set-up's phases in seconds, from ``(phase, its end on the host clock)`` marks."""
    ends = [t_start] + [t for _, t in marks]
    return ", ".join(f"{p} {b - a:.3f}" for (p, _), a, b in zip(marks, ends, ends[1:]))


def run_cell(args, bench: dict, entry: dict, workload: dict, config: dict, t_start: float, device="cuda",
             producer: str = "program", marks: tuple = ()) -> dict:
    """One run: -> the result line's dict, with the compared numbers under
    ``checks``. ``producer`` is "program", "control" or "witness"
    (``check.run``). ``marks``: the set-up's phases before this call, each
    ``(phase, its end)``."""
    name, seed, tracing = entry["name"], args.seed, bool(args.trace)
    marks = [*marks, ("harness import", time.perf_counter())]
    readers = {m["name"]: cells.metric_reader(m["name"]) for m in cells.metrics_of(name, bench, "per_layer")} \
        if tracing else {}
    rec = drive.Record()
    stream = drive.StateStream(config, workload, [abs(seed), 0])
    period, depth = workload["plan_period_s"], workload["pipeline_depth"]
    c = drive.build(config, workload, seed, device)
    drive.watch(c, rec)
    marks.append(("controller", time.perf_counter()))
    for k in range(workload["warmup_plans"]):
        drive.call(c, rec, stream, period)
        if k == 0:
            _sync(device)
            marks.append(("first plan", time.perf_counter()))
    sample = drive.CarrySample(c, workload["check"]["plans"], np.random.default_rng([abs(seed), 1]))
    if depth:
        drive.flush(c)
    drive.call(c, rec, stream, period, sample=sample)  # the carry before the window's first plan
    if depth:
        drive.flush(c)
    _sync(device)
    gc.collect()
    ctx = SimpleNamespace(config=config, workload=workload, store={}, program=c)
    for r in readers.values():
        if hasattr(r, "before_window"):
            r.before_window(ctx)
    marks.append(("warm-up plans", time.perf_counter()))
    setup_s = marks[-1][1] - t_start

    # the window: the same in a traced run as in an untraced one
    first = len(rec.call_s)
    watch = GcWatch()
    gc.callbacks.append(watch)
    t0 = time.perf_counter()
    while True:
        t_end = drive.call(c, rec, stream, period, sample=sample, window=True)
        if t_end - t0 >= args.seconds:
            break
    if depth:
        drive.flush(c)
        t_end = time.perf_counter()
    _sync(device)
    gc.callbacks.remove(watch)
    sample.into(rec)
    n_plans = len(rec.call_s) - first
    plan_ms = 1e3 * (t_end - t0) / n_plans
    for r in readers.values():
        if hasattr(r, "after_window"):
            r.after_window(ctx)
    if tracing:  # the traced slice, after the window: the profiler's start-up first, outside it
        prof = Profile()
        prof.start()
        drive.call(c, rec, stream, period, span)
        drive.flush(c)
        prof.stop()
        prof = Profile()
        prof.start()
        for _ in range(workload["trace"]["plans"]):
            drive.call(c, rec, stream, period, span)
        drive.flush(c)
        prof.stop()
    peak = int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0

    setup = ref_plan.load_setup(cells.ROOT, config, device)
    R = workload["rollouts"]
    result = {"correct": False, "attempted": n_plans, "failed": 0, "metrics": {}}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu",
           "count": entry["chips"], "memory_peak_bytes": peak}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if tracing:
        sl = Slice(prof.read(), config["rollout_kernel"])
        ctx.slice = sl
        ctx.calls = list(range(first, first + n_plans))
        ctx.record = rec
        ctx.shapes = shapes(setup, R)
        for metric, reader in readers.items():
            v = reader.read(ctx)
            if v is not None:
                result["metrics"][metric] = {"value": float(v), "unit": units[metric]}
        dev["busy_s"], dev["window_s"] = sl.busy_s, sl.window_s
        result["breakdown"] = sl.breakdown()
    else:
        e2e = {"plan_ms": plan_ms, "setup_s": setup_s}
        for m in cells.metrics_of(name, bench, "end_to_end"):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result["device"] = dev

    # the output check, with the program's state let go
    ctx.program = c = None
    gc.collect()
    bounds = setup.task.ctrl_bounds(setup.model, setup.extras)
    np_dtype = np.dtype(config["dtype"])
    window = range(first, first + n_plans)
    result["failed"] = check.unsound_plans(rec, window, bounds.astype(np_dtype).astype(np.float64))
    t_ref = time.perf_counter()
    values = check.run(setup, rec, seed, R, device, producer)
    split = {k: np.mean([rec.timing[j][k] for j in window]) for k in rec.timing[first]}
    print(f"portbench: {name} seed {seed}: set-up {setup_s:.3f} s ({phases(t_start, marks)}), "
          f"window {t_end - t0:.3f} s of {n_plans} plans, output check {time.perf_counter() - t_ref:.3f} s; "
          "a call's host ms: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; between calls {plan_ms - 1e3 * np.mean(rec.call_s[first:first + n_plans]):.3f} ms; "
          f"full collections in the window: {watch.full} ({watch.seconds:.3f} s)", file=sys.stderr)
    ok, result["checks"] = check.judge(values, workload["limits"])
    result["correct"] = ok and result["failed"] == 0
    return result
