"""The benchmark as data: a cell's traffic file, its configuration's file, and
the per-layer metric readers and kernel counts, each found by its name.

- ``BENCHMARK.json`` at the checkout's root: the cells, their metrics and bounds;
- ``portbench/workloads/<cell>.json``: one traffic mix (its configuration,
  rollouts, pipeline depth, state stream, window and trace slice, and the
  limits of the output check);
- ``portbench/configs/<config>.json``: one configuration as it is run;
- ``portbench/metrics/<metric>.py``: one reader per per-layer metric;
- ``portbench/counts/<kernel>.py``: operations and bytes of one kernel.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

WORKLOAD_KEYS = {"name", "config", "rollouts", "pipeline_depth", "warmup_plans", "plan_period_s", "perturb", "trace",
                 "check", "limits"}
CONFIG_KEYS = {"name", "source", "reduced", "assumed", "task", "optimizer", "dtype", "rollout_kernel", "controller",
               "optimizer_config", "task_config", "state", "why"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _keys(d: dict, allowed: set, what: str) -> dict:
    extra = set(d) - allowed
    if extra:
        raise ValueError(f"{what}: unknown keys {sorted(extra)}")
    return d


def workload(name: str) -> dict:
    return _keys(load_json(HERE / "workloads" / f"{name}.json"), WORKLOAD_KEYS, f"workload {name}")


def config(name: str) -> dict:
    return _keys(load_json(HERE / "configs" / f"{name}.json"), CONFIG_KEYS, f"config {name}")


def cell(name: str, bench: dict) -> tuple[dict, dict, dict]:
    """(the BENCHMARK.json entry, the workload file, the config file) of a cell."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(entries)})")
    entry = entries[name]
    wl = workload(entry["traffic"])
    if wl["config"] != entry["config"]:
        raise ValueError(f"cell {name}: BENCHMARK.json names config {entry['config']}, its traffic {wl['config']}")
    return entry, wl, config(entry["config"])


def metrics_of(name: str, bench: dict, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in bench[kind] if "workloads" not in m or name in m["workloads"]]


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``: ``read(ctx)`` -> a number, or None where it finds
    nothing to read; optionally ``before_window(ctx)`` and ``after_window(ctx)``."""
    return _module(HERE / "metrics" / f"{name}.py", f"portbench_metric_{name.replace('.', '_')}")


def kernel_count(kernel: str) -> ModuleType:
    """``counts/<kernel>.py``: ``count(shapes)`` -> (operations, bytes) of one launch."""
    return _module(HERE / "counts" / f"{kernel}.py", f"portbench_count_{kernel.replace('.', '_')}")
