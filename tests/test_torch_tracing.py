"""The spans of the PyTorch port's controller and solve cache
(``utils/profiling.span``), on the CPU: one ``plan_log`` record a published
solve, in solve order, with every span that ran; the children inside their
parent; ``latency_ms`` from the dispatching call's entry to the end of the
solve's publish; ``last_plan_timing`` made of the same spans; no
``record_function`` without a profiler, and the spans nested in the
profiler's trace while one records; the log's bound; the task's
``pre_rollout`` as ``prep.task`` inside ``prep.inputs``; and the benchmark's
readers of that span and of the calls that outlast the control period,
which read nothing where a program lacks the records.

Each controller plans cartpole with PS (8 rollouts, a 0.2 s horizon) in
float64."""

import json
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from judo_tpu_torch.controller import make_controller
from judo_tpu_torch.controller.controller import Controller
from judo_tpu_torch.tasks.cartpole import Cartpole
from judo_tpu_torch.utils import profiling
from portbench import cells

CALLS = 5
# the spans of one solve on the CPU (no capture: there is no graph), by pipeline depth
SPANS = {"plan", "prep.inputs", "prep.task", "prep.lookup", "dispatch.copy", "dispatch.noise", "dispatch.replay",
         "dispatch.readback", "post_rollout", "wait", "publish"}
# spans that run inside another span of the same solve, and their parents
NESTED = {"prep.task": "prep.inputs"}
EXPECTED = {0: SPANS, 2: SPANS | {"sync.backlog"}}


def _controller(depth: int) -> Controller:
    np.random.seed(0)
    c = make_controller("cartpole", "ps", device="cpu", dtype=torch.float64, seed=0)
    c.optimizer_cfg.num_rollouts = 8
    c.controller_cfg.horizon = 0.2
    c.controller_cfg.pipeline_depth = depth
    return c


def _run(depth: int, calls: int = CALLS):
    """(the controller after ``calls`` calls and a flush, ``last_plan_timing`` after each call)."""
    c = _controller(depth)
    timings = []
    for n in range(calls):
        c.current_state, c.time = np.array([0.1 * n, 0.0, 0.0, 0.0]), 0.02 * n
        c.update_action()
        timings.append(c.last_plan_timing)
    c.flush_pipeline()
    return c, timings


@pytest.fixture(scope="module", params=[0, 2], ids=lambda d: f"depth{d}")
def ran(request):
    return request.param, *_run(request.param)


def test_one_record_a_solve_in_order_with_every_span(ran):
    depth, c, _ = ran
    assert c.solves_dispatched == CALLS
    assert [r["id"] for r in c.plan_log] == list(range(CALLS))
    for r in c.plan_log:
        assert set(r) == {"id", "spans", "latency_ms"}
        assert set(r["spans"]) == EXPECTED[depth], r["id"]
        assert all(ms >= 0 for ms in r["spans"].values()) and r["latency_ms"] >= 0


def test_children_within_their_parent(ran):
    """At depth 0 every span of a solve runs inside its call's ``plan``; at
    depth 2 its post_rollout, wait and publish run in a later call or on the
    consumer thread, so only the prep, dispatch and backlog spans do."""
    depth, c, _ = ran
    for r in c.plan_log:
        s = r["spans"]
        inside = [k for k in s if k != "plan" and k not in NESTED
                  and (depth == 0 or k.split(".")[0] in ("prep", "dispatch", "sync"))]
        assert sum(s[k] for k in inside) <= s["plan"]
        assert all(s[k] <= s[parent] for k, parent in NESTED.items())
        assert s["wait"] + s["publish"] <= r["latency_ms"]


def test_latency_covers_the_dispatching_call(ran):
    depth, c, _ = ran
    for r in c.plan_log:
        s = r["spans"]
        dispatched = sum(ms for k, ms in s.items() if k.startswith(("prep.", "dispatch.")) and k not in NESTED)
        assert r["latency_ms"] >= dispatched
        if depth == 0:  # published inside the call that took its state
            assert r["latency_ms"] <= s["plan"]


def test_last_plan_timing_is_the_span_sums(ran):
    _, c, timings = ran
    for t, r in zip(timings, c.plan_log):  # call j dispatched solve j
        assert set(t) == {"prep_ms", "device_ms", "sync_ms", "total_ms"}
        s = r["spans"]
        assert t["prep_ms"] == pytest.approx(s["prep.inputs"] + s["prep.lookup"], rel=1e-12)
        assert t["device_ms"] == pytest.approx(sum(ms for k, ms in s.items() if k.startswith("dispatch.")), rel=1e-12)
        assert t["total_ms"] == s["plan"]
        assert t["sync_ms"] == pytest.approx(t["total_ms"] - t["prep_ms"] - t["device_ms"], rel=1e-12)
        assert min(t.values()) >= 0


class _Counting:
    """``record_function`` that counts its entries."""

    def __init__(self, real) -> None:
        self.real, self.entered = real, 0

    def __call__(self, name, args=None):
        self.entered += 1
        return self.real(name, args)


@pytest.mark.parametrize("depth", [0, 2])
def test_no_record_function_without_a_profiler(monkeypatch, depth):
    counting = _Counting(profiling.record_function)
    monkeypatch.setattr(profiling, "record_function", counting)
    c, _ = _run(depth, calls=3)
    assert counting.entered == 0 and len(c.plan_log) == 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        c.update_action()
        c.flush_pipeline()
    assert counting.entered >= len(EXPECTED[depth])  # the same spans, with the profiler on


def test_spans_nest_in_the_profilers_trace(tmp_path):
    c = _controller(0)
    c.update_action()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            c.update_action()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("judo.")]
    plans = [e for e in events if e["name"] == "judo.plan"]
    assert len(plans) == 2
    for p in plans:
        lo, hi = p["ts"], p["ts"] + p["dur"]
        inner = {e["name"] for e in events if e["tid"] == p["tid"] and lo <= e["ts"] and e["ts"] + e["dur"] <= hi}
        assert {"judo.prep.inputs", "judo.prep.task", "judo.prep.lookup"} <= inner
        assert {"judo.dispatch.copy", "judo.dispatch.noise", "judo.dispatch.replay", "judo.dispatch.readback"} <= inner
        assert {"judo.post_rollout", "judo.wait", "judo.publish"} <= inner  # depth 0: published inside the call


def test_log_stays_at_its_bound(monkeypatch):
    assert Controller.PLAN_LOG_MAX >= 4096
    monkeypatch.setattr(Controller, "PLAN_LOG_MAX", 3)
    c, _ = _run(0, calls=5)
    assert c.plan_log.maxlen == 3 and [r["id"] for r in c.plan_log] == [2, 3, 4]


def test_task_prep_is_counted_within_prep_inputs(monkeypatch):
    """A slow ``pre_rollout`` shows in ``prep.task``, inside ``prep.inputs``,
    and in ``prep_ms`` once."""
    pre_rollout = Cartpole.pre_rollout

    def slow(self, state):
        time.sleep(0.02)
        return pre_rollout(self, state)

    monkeypatch.setattr(Cartpole, "pre_rollout", slow)
    c, timings = _run(0, calls=2)
    for t, r in zip(timings, c.plan_log):
        s = r["spans"]
        assert 20.0 <= s["prep.task"] <= s["prep.inputs"]
        assert t["prep_ms"] == pytest.approx(s["prep.inputs"] + s["prep.lookup"], rel=1e-12)


def _window(metric: str, c, calls: int):
    """A reader's hooks around ``calls`` calls of the controller ``c``."""
    reader = cells.metric_reader(metric)
    ctx = SimpleNamespace(store={}, program=c, calls=list(range(calls)))
    reader.before_window(ctx)
    for _ in range(calls):
        c.update_action()
    reader.after_window(ctx)
    return reader.read(ctx)


def test_period_overruns_count_calls_slower_than_the_period(monkeypatch):
    """``overrun_share`` over windows of a controller's calls: every call
    outlasts a 1 us period and none a 1e6 ms one; at 2 Hz a call slowed past
    500 ms counts and a fast one does not."""
    c = _controller(0)
    c.current_state = np.zeros(4)
    c.controller_cfg.control_freq = 1e6
    assert _window("overrun_share", c, 2) == 100.0
    c.controller_cfg.control_freq = 1e-3
    assert _window("overrun_share", c, 2) == 0.0
    pre_rollout, slowed = Cartpole.pre_rollout, []

    def slow_once(self, state):
        if not slowed:
            slowed.append(time.sleep(0.6))
        return pre_rollout(self, state)

    monkeypatch.setattr(Cartpole, "pre_rollout", slow_once)
    c.controller_cfg.control_freq = 2.0
    assert _window("overrun_share", c, 2) == 50.0
    assert [r["spans"]["plan"] > 500.0 for r in list(c.plan_log)[-2:]] == [True, False]


def _read(metric: str, program, first, last, calls):
    """A reader's hooks around a window of ``calls`` calls, with the program's
    ``solves_dispatched`` set to ``first`` before and ``last`` after it (where
    the program keeps it)."""
    reader = cells.metric_reader(metric)
    for k, v in first.items():
        setattr(program, k, v)
    ctx = SimpleNamespace(store={}, program=program, calls=list(range(calls)))
    reader.before_window(ctx)
    for k, v in last.items():
        setattr(program, k, v)
    reader.after_window(ctx)
    return reader.read(ctx)


AT_20_HZ = SimpleNamespace(control_freq=20.0)  # a 50 ms period


def test_task_prep_and_overrun_readers():
    log = deque({"id": i, "spans": {"prep.task": 0.01 * i}, "latency_ms": 1.0} for i in range(10))
    program = SimpleNamespace(plan_log=log, controller_cfg=AT_20_HZ)
    got = _read("task_prep_ms", program, {"solves_dispatched": 2}, {"solves_dispatched": 6}, 4)
    assert got == pytest.approx(np.mean([0.01 * i for i in range(2, 6)]))
    log = deque({"id": i, "spans": {"plan": 10.0 * i}, "latency_ms": 1.0} for i in range(10))
    program = SimpleNamespace(plan_log=log, controller_cfg=AT_20_HZ)
    got = _read("overrun_share", program, {"solves_dispatched": 2}, {"solves_dispatched": 8}, 6)
    assert got == pytest.approx(100.0 * 2 / 6)  # 60 and 70 ms of 20 to 70


def test_readers_read_nothing_without_the_span_or_counter():
    """A program without ``prep.task`` in its records, or without records at all, gives None."""
    log = deque({"id": i, "spans": {"prep.inputs": 0.1}, "latency_ms": 1.0} for i in range(10))
    assert _read("task_prep_ms", SimpleNamespace(plan_log=log), {"solves_dispatched": 2},
                 {"solves_dispatched": 6}, 4) is None
    assert _read("task_prep_ms", SimpleNamespace(), {}, {}, 4) is None  # no records at all
    assert _read("overrun_share", SimpleNamespace(controller_cfg=AT_20_HZ), {}, {}, 4) is None
