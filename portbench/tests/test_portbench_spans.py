"""The readers of the controller's spans (``lookup_ms``, ``replay_ms``,
``publish_ms``, ``action_latency_ms``) on a fake program: the window's
solves picked by their ids, nothing read where there are no records or the
program keeps none; and a traced run on the CPU that reads them all."""

from __future__ import annotations

from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import cells

READERS = {"lookup_ms": "prep.lookup", "replay_ms": "dispatch.replay", "publish_ms": "publish"}


def record(i: int) -> dict:
    return {"id": i, "spans": {"prep.lookup": 0.1 * i, "dispatch.replay": 0.2 * i, "publish": 0.3 * i},
            "latency_ms": 10.0 * i}


def window(reader, log: deque, first: int, last: int):
    """Run ``reader``'s hooks around a window that dispatched solves ``first``..``last - 1``."""
    program = SimpleNamespace(solves_dispatched=first, plan_log=log)
    ctx = SimpleNamespace(store={}, program=program)
    reader.before_window(ctx)
    program.solves_dispatched = last
    reader.after_window(ctx)
    return reader.read(ctx)


@pytest.mark.parametrize("metric", [*READERS, "action_latency_ms"])
def test_window_solves_picked_by_id(metric):
    """Records of solves before the window (warm-up) and after it (the traced slice) are left out."""
    reader = cells.metric_reader(metric)
    log = deque(record(i) for i in range(12))
    got = window(reader, log, 3, 8)
    ids = range(3, 8)
    if metric == "action_latency_ms":
        assert got == pytest.approx(float(np.median([10.0 * i for i in ids])))
    else:
        assert got == pytest.approx(float(np.mean([record(i)["spans"][READERS[metric]] for i in ids])))


@pytest.mark.parametrize("metric", [*READERS, "action_latency_ms"])
def test_nothing_to_read(metric):
    reader = cells.metric_reader(metric)
    assert window(reader, deque(record(i) for i in range(3)), 3, 3) is None  # no solve in the window
    assert window(reader, deque(), 0, 4) is None  # no records
    ctx = SimpleNamespace(store={}, program=SimpleNamespace())  # a program that keeps no records
    reader.before_window(ctx)
    reader.after_window(ctx)
    assert reader.read(ctx) is None


@pytest.mark.parametrize("cell", ["leap_cube-mppi.r320", "leap_cube-mppi.r320-pipe2"])
def test_traced_run_reads_the_span_metrics(small_run, cell):
    """Each span metric that lists the cell reads a value in a traced run on the CPU."""
    res = small_run(cell, trace=1)
    listed = {m["name"] for m in cells.metrics_of(cell, cells.benchmark(), "per_layer")}
    span_metrics = {*READERS, "action_latency_ms"} & listed
    assert span_metrics and span_metrics <= set(res["metrics"])
    assert all(res["metrics"][m]["value"] >= 0 for m in span_metrics)
