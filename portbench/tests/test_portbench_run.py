"""``run.py`` itself: no card, no result; the JAX check compares whole
top-level names; the last line's shape, from a run whose look for a card is
skipped; and, on the card, one short run of each cell."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest
import torch

from portbench import cells, harness, run

RUN = [sys.executable, str(cells.HERE / "run.py")]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the run would use it")
    cell = cells.benchmark()["workloads"][0]["name"]
    out = subprocess.run([*RUN, "--workload", cell, "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    for name in ("judo_tpu_torch", "judo_tpu_torchx.y", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "judo_tpu.physics", types.ModuleType("judo_tpu.physics"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.forbidden_modules() == ["jaxlib", "judo_tpu"]


def test_last_line(small_run, monkeypatch, capsys):
    """``run.main`` with the card's look answered yes and the cell run small on the CPU."""
    cell = cells.benchmark()["workloads"][0]["name"]
    result = small_run(cell)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: result)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "open_context", lambda: None)
    assert run.main(["--workload", cell, "--seed", "3", "--seconds", "1", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert {m for m in line["metrics"]} == {"plan_ms", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_traced_run_reads_the_per_layer_metrics(small_run):
    """A traced run on the CPU: the metrics that need the card's trace read nothing and are left out."""
    res = small_run(cells.benchmark()["workloads"][0]["name"], trace=1)
    assert res["correct"]
    assert {"host_prep_ms", "graph_captures", "plan_p95_ms"} <= set(res["metrics"])
    assert "k1_roofline" not in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"]) and set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in cells.benchmark()["workloads"]])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for trace in (0, 1):
        out = subprocess.run([*RUN, "--workload", cell, "--seed", str(2**31 + 77), "--seconds", "2", "--trace",
                              str(trace)], capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-4000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"], line["checks"]
        assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
