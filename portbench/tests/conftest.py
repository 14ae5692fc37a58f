"""Shared helpers of the benchmark's tests: a cell run on the CPU at a small
size, through the harness's own path with the look for a card skipped. A
cell is taken from its files, also one that BENCHMARK.json leaves out."""

from __future__ import annotations

import copy
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import cells, harness

# one thread a test process: the tests run side by side on several workers
torch.set_num_threads(1)


def run_small(cell: str, R: int = 6, horizon: float = 0.08, dtype: str = "float32", seed: int = 2**31 + 5,
              producer: str = "program", trace: int = 0) -> dict:
    """``cell`` on the CPU with ``R`` rollouts over ``horizon`` seconds, in
    ``dtype``, its own limits, a one-second window and two compared plans."""
    bench = cells.benchmark()
    workload = copy.deepcopy(cells.workload(cell))
    config = copy.deepcopy(cells.config(workload["config"]))
    entry = {"name": cell, "config": workload["config"], "traffic": cell, "chips": 1}
    workload.update(rollouts=R, warmup_plans=1, check={"plans": 2}, trace={"plans": 2})
    config["controller"]["horizon"] = horizon
    config["dtype"] = dtype
    args = SimpleNamespace(seed=seed, seconds=1.0, trace=trace)
    return harness.run_cell(args, bench, entry, workload, config, time.perf_counter(), device="cpu", producer=producer)


@pytest.fixture
def small_run():
    return run_small
