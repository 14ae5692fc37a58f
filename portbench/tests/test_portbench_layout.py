"""The benchmark is data: every configuration, cell, metric and kernel count
that BENCHMARK.json names is found by its name, and the file keeps to the
limits of its format."""

from __future__ import annotations

import importlib
import math
import re

import pytest

from portbench import cells, check

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert (cells.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_seconds_fits_the_full_check():
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s of compile a cell and 1200 s spare within 43200 s."""
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(entry):
    cfg = cells.config(entry["name"])
    assert cfg["name"] == entry["name"]
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    importlib.import_module(f"portbench.reference.tasks.{cfg['task']}")
    importlib.import_module(f"portbench.reference.optimizers.{cfg['optimizer']}")
    assert hasattr(cells.kernel_count(cfg["rollout_kernel"]), "count")
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(entry):
    bench_entry, workload, config = cells.cell(entry["name"], BENCH)
    assert workload["name"] == entry["traffic"] and config["name"] == entry["config"]
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    assert set(workload["limits"]) == set(check.NUMBERS)
    e2e = cells.metrics_of(entry["name"], BENCH, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert cells.metrics_of(entry["name"], BENCH, "per_layer")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    reader = cells.metric_reader(metric["name"])
    assert callable(reader.read)
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    cell_names = {w["name"] for w in BENCH["workloads"]}
    assert set(metric["workloads"]) <= cell_names


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["unit"] == "%" or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and not math.isnan(m["bound"])
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
