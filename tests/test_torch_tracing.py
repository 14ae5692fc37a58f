"""The spans of the PyTorch port's controller and solve cache
(``utils/profiling.span``), on the CPU: one ``plan_log`` record a published
solve, in solve order, with every span that ran; the children inside their
parent; ``latency_ms`` from the dispatching call's entry to the end of the
solve's publish; ``last_plan_timing`` made of the same spans; no
``record_function`` without a profiler, and the spans nested in the
profiler's trace while one records; the log's bound.

Each controller plans cartpole with PS (8 rollouts, a 0.2 s horizon) in
float64."""

import json

import numpy as np
import pytest
import torch

from judo_tpu_torch.controller import make_controller
from judo_tpu_torch.controller.controller import Controller
from judo_tpu_torch.utils import profiling

CALLS = 5
# the spans of one solve on the CPU (no capture: there is no graph), by pipeline depth
SPANS = {"plan", "prep.inputs", "prep.lookup", "dispatch.copy", "dispatch.noise", "dispatch.replay",
         "dispatch.readback", "post_rollout", "wait", "publish"}
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
        inside = [k for k in s if k != "plan" and (depth == 0 or k.split(".")[0] in ("prep", "dispatch", "sync"))]
        assert sum(s[k] for k in inside) <= s["plan"]
        assert s["wait"] + s["publish"] <= r["latency_ms"]


def test_latency_covers_the_dispatching_call(ran):
    depth, c, _ = ran
    for r in c.plan_log:
        s = r["spans"]
        dispatched = sum(ms for k, ms in s.items() if k.startswith(("prep.", "dispatch.")))
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
        assert {"judo.prep.inputs", "judo.prep.lookup"} <= inner
        assert {"judo.dispatch.copy", "judo.dispatch.noise", "judo.dispatch.replay", "judo.dispatch.readback"} <= inner
        assert {"judo.post_rollout", "judo.wait", "judo.publish"} <= inner  # depth 0: published inside the call


def test_log_stays_at_its_bound(monkeypatch):
    assert Controller.PLAN_LOG_MAX >= 4096
    monkeypatch.setattr(Controller, "PLAN_LOG_MAX", 3)
    c, _ = _run(0, calls=5)
    assert c.plan_log.maxlen == 3 and [r["id"] for r in c.plan_log] == [2, 3, 4]
