"""The metric arithmetic on a synthetic trace and record: the union idle
share, a kernel's roofline, the whole plan's share of the peak, the per-call
p95 over every plan, the breakdown, and the frozen counts against the bounds
PERF.md gives (K1 leap 0.1691 ms, K2 spot_navigate 0.05431 ms, both bound by
operations)."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import cells, drive, harness
from portbench.counts import peaks
from portbench.reference import plan as ref_plan
from portbench.trace import Slice, union_ms


def event(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


K1 = "fused_rollout_kernel"


def synthetic_slice():
    """Two plans of 1000 us each: a 600 us K1 launch and a 100 us copy that
    overlaps it by 50 us, the host in a sync during the rest. The slice runs
    from the first K1's start (200 us) to the last one's end (1800 us)."""
    ev = []
    for k, t in enumerate((0.0, 1000.0)):
        ev.append(event("user_annotation", "portbench.call", t, 1000.0))
        ev.append(event("cuda_runtime", "cudaEventSynchronize", t + 100.0, 890.0))
        ev.append(event("kernel", "void fused_rollout_kernel<float, false>(JtSizes)", t + 200.0, 600.0))
        ev.append(event("gpu_memcpy", "Memcpy DtoH", t + 750.0, 100.0))
    ev.append(event("gpu_memset", "Memset (Device)", 5000.0, 50.0))  # outside the slice
    return Slice(ev, K1)


def test_union_and_idle_share():
    assert union_ms([(0, 10), (5, 20), (30, 40)], 0, 100) == pytest.approx(0.030)
    assert union_ms([(0, 10), (5, 20)], 8, 12) == pytest.approx(0.004)
    sl = synthetic_slice()
    assert sl.plans == 2 and sl.window_s == pytest.approx(1.6e-3)
    assert sl.busy_s == pytest.approx(650e-6 + 600e-6)  # the second copy is cut at the slice's end
    ctx = SimpleNamespace(slice=sl)
    assert cells.metric_reader("idle_share").read(ctx) == pytest.approx(100 * (1 - 1250 / 1600))


def test_slice_follows_the_card_not_the_host_calls():
    """At pipeline depth 2 a call returns before its solve runs: three 100-us
    calls queue three back-to-back 1-ms launches. The slice is the card's
    3 ms, busy throughout, and a plan takes 1 ms of it."""
    ev = [event("user_annotation", "portbench.call", 100.0 * k, 100.0) for k in range(3)]
    ev += [event("kernel", "fused_rollout_kernel<float>", 50.0 + 1000.0 * k, 1000.0) for k in range(3)]
    sl = Slice(ev, K1)
    assert sl.plans == 3 and sl.window_s == pytest.approx(3e-3) and sl.busy_s == pytest.approx(3e-3)
    shapes = leap_shapes()
    ctx = SimpleNamespace(slice=sl, shapes=shapes, config=cells.config("leap_cube-mppi"))
    assert cells.metric_reader("idle_share").read(ctx) == pytest.approx(0.0, abs=1e-9)
    flops, _ = cells.kernel_count(K1).count(shapes)
    mfu = cells.metric_reader("solve_mfu").read(ctx)
    assert mfu == pytest.approx(100 * flops / (1e-3 * peaks.PEAK_F32_FLOPS))
    assert mfu <= cells.metric_reader("k1_roofline").read(ctx)


def test_a_trace_without_the_rollout_kernel_reads_nothing():
    sl = Slice([event("user_annotation", "portbench.call", 0.0, 10.0), event("cpu_op", "aten::mm", 1.0, 5.0)], K1)
    assert sl.plans == 0 and sl.window_s == 0 and sl.busy_s == 0
    ctx = SimpleNamespace(slice=sl, shapes=leap_shapes(), config=cells.config("leap_cube-mppi"))
    for metric in ("idle_share", "solve_mfu", "k1_roofline"):
        assert cells.metric_reader(metric).read(ctx) is None
    assert sl.breakdown() == {"device_ops": [], "idle_gaps": []}


def test_breakdown_names_ops_and_gaps():
    bd = synthetic_slice().breakdown()
    ops = dict(bd["device_ops"])
    assert ops["void fused_rollout_kernel<float, false>(JtSizes)"] == pytest.approx(1.2e-3)
    assert ops["Memcpy DtoH"] == pytest.approx(1.5e-4)
    gaps = dict(bd["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(1.6e-3 - 1.25e-3)
    # idle from the first copy's end (850) to the second K1 (1200): the first call's sync is open until
    # 990, its span until 1000; the second call's span opens at 1000 and its sync at 1100
    assert gaps["portbench.call / cudaEventSynchronize"] == pytest.approx(140e-6 + 100e-6)
    assert gaps["portbench.call"] == pytest.approx(10e-6 + 100e-6)


def leap_shapes(R=320):
    setup = ref_plan.load_setup(cells.ROOT, cells.config("leap_cube-mppi"), "cpu")
    return harness.shapes(setup, R)


def test_counts_reproduce_the_bounds_of_perf_md():
    k1 = cells.kernel_count("fused_rollout_kernel").count(leap_shapes())
    bound, by = peaks.bound_s(*k1)
    assert by == "operations" and 1e3 * bound == pytest.approx(0.1691, rel=5e-4)
    setup = ref_plan.load_setup(cells.ROOT, cells.config("spot_navigate-mppi"), "cpu")
    k2 = cells.kernel_count("fused_policy_rollout_kernel").count(harness.shapes(setup, 24))
    bound, by = peaks.bound_s(*k2)
    assert by == "operations" and 1e3 * bound == pytest.approx(0.05431, rel=5e-4)


def test_roofline_and_mfu_of_a_synthetic_slice():
    shapes = leap_shapes()
    ctx = SimpleNamespace(slice=synthetic_slice(), shapes=shapes, config=cells.config("leap_cube-mppi"))
    flops, nbytes = cells.kernel_count("fused_rollout_kernel").count(shapes)
    bound, _ = peaks.bound_s(flops, nbytes)
    assert cells.metric_reader("k1_roofline").read(ctx) == pytest.approx(100 * bound / 600e-6)
    assert cells.metric_reader("k2_roofline").read(ctx) is None  # no K2 launch: nothing to read
    assert cells.metric_reader("solve_mfu").read(ctx) == pytest.approx(100 * flops / (0.8e-3 * peaks.PEAK_F32_FLOPS))


def test_p95_over_every_plan_and_prep_mean():
    rec = drive.Record()
    rec.call_s = [1e-3 * x for x in range(1, 201)]
    rec.timing = [{"prep_ms": float(x)} for x in range(200)]
    ctx = SimpleNamespace(record=rec, calls=list(range(200)))
    assert cells.metric_reader("plan_p95_ms").read(ctx) == pytest.approx(np.percentile(np.arange(1, 201), 95))
    assert cells.metric_reader("host_prep_ms").read(ctx) == pytest.approx(99.5)
    ctx.calls = []
    assert cells.metric_reader("plan_p95_ms").read(ctx) is None


def test_graph_captures_counts_the_window_only():
    from judo_tpu_torch.controller.solve_graph import SolveGraph

    reader = cells.metric_reader("graph_captures")
    ctx = SimpleNamespace(store={})
    reader.before_window(ctx)
    before = SolveGraph.captures
    try:
        SolveGraph.captures += 2
        reader.after_window(ctx)
    finally:
        SolveGraph.captures = before
    assert reader.read(ctx) == 2
