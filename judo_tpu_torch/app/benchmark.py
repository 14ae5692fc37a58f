"""Benchmark harness: plan-time distributions per (task x optimizer) pair
(counterpart of ``judo_tpu/app/benchmark.py``).

Every pair runs a closed loop in step: one plant tick, one plan, repeated;
``num_samples`` plan times are kept after ``warmup`` plans, with the mean
split of each plan into host staging, dispatch and publishing
(``Controller.last_plan_timing``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np

from judo_tpu_torch.app.bus import MessageBus
from judo_tpu_torch.app.nodes import ControllerNode, SimulationNode
from judo_tpu_torch.optimizers import get_registered_optimizers
from judo_tpu_torch.tasks import get_registered_tasks

STAGES = ("prep_ms", "device_ms", "sync_ms")


@dataclasses.dataclass
class BenchmarkResult:
    task: str
    optimizer: str
    times_s: np.ndarray
    # mean per-stage split (prep/device/sync ms) from Controller.last_plan_timing
    stages: dict | None = None

    @property
    def stats(self) -> dict[str, float]:
        t = self.times_s
        return {
            "mean": float(t.mean()),
            "std": float(t.std()),
            "median": float(np.median(t)),
            "iqr_lo": float(np.percentile(t, 25)),
            "iqr_hi": float(np.percentile(t, 75)),
            "p95": float(np.percentile(t, 95)),
            "min": float(t.min()),
            "max": float(t.max()),
        }


def run_benchmark(
    tasks: Iterable[str] | None = None,
    optimizers: Iterable[str] | None = None,
    num_samples: int = 100,
    warmup: int = 3,
    sim_backend: str = "mujoco",
    device: Any = "cuda",
) -> list[BenchmarkResult]:
    """Sequential benchmark over all pairs (in-process, deterministic)."""
    task_names = list(tasks) if tasks is not None else sorted(get_registered_tasks())
    opt_names = list(optimizers) if optimizers is not None else sorted(get_registered_optimizers())

    results = []
    for task_name in task_names:
        for opt_name in opt_names:
            bus = MessageBus()
            sim_node = SimulationNode(bus, task_name, backend=sim_backend, device=device)
            ctrl_node = ControllerNode(bus, task_name, opt_name, device=device)
            times = []
            stage_sums = dict.fromkeys(STAGES, 0.0)
            n_staged = 0
            for i in range(warmup + num_samples):
                sim_node.step_once()
                plan_time = ctrl_node.step_once()
                if i >= warmup and plan_time is not None:
                    times.append(plan_time)
                    timing = ctrl_node.controller.last_plan_timing
                    if timing is not None:
                        for k in stage_sums:
                            stage_sums[k] += timing[k]
                        n_staged += 1
            stages = {k: v / n_staged for k, v in stage_sums.items()} if n_staged else None
            results.append(BenchmarkResult(task_name, opt_name, np.asarray(times), stages=stages))
    return results


def format_table(results: list[BenchmarkResult]) -> str:
    """Plain-text stats table, with the mean prep / device / sync split."""
    header = (
        f"{'task':<18} {'optimizer':<10} {'mean±std (ms)':<18} "
        f"{'median (IQR) (ms)':<24} {'min':>8} {'max':>8}   {'prep / device / sync (ms)'}"
    )
    lines = [header, "-" * len(header)]
    for r in results:
        s = r.stats
        split = " / ".join(f"{r.stages[k]:.2f}" for k in STAGES) if r.stages else "-"
        lines.append(
            f"{r.task:<18} {r.optimizer:<10} "
            f"{s['mean'] * 1e3:7.2f}±{s['std'] * 1e3:<7.2f}   "
            f"{s['median'] * 1e3:7.2f} ({s['iqr_lo'] * 1e3:.2f}-{s['iqr_hi'] * 1e3:.2f})      "
            f"{s['min'] * 1e3:8.2f} {s['max'] * 1e3:8.2f}   {split}"
        )
    return "\n".join(lines)
