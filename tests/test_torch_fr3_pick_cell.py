"""The benchmark's cell ``fr3_pick-mppi.r64`` on the CPU: run small through
the harness's own path (4 rollouts, T 8, float64), the port's plans agree
with the plain reference (``portbench/reference/``) to rounding; the task's
host phase is lift on every state of the cell's stream, as the reference's
reward assumes; the reference's task imports nothing of the port, the JAX
package or JAX; and a plan of the port with a planted fault (a wrong phase,
a reward weight off by 1 %, the carried warm-start forces zeroed or frozen)
comes out as not correct."""

from __future__ import annotations

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from judo_tpu_torch.controller.controller import Controller
from judo_tpu_torch.tasks.fr3_pick import FR3Pick, Phase
from portbench import cells, drive

from .torch_inputs import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CELL = "fr3_pick-mppi.r64"
R, HORIZON = 4, 0.032  # T 8 at 4 ms
SEED = 2**31 + 23
FORBIDDEN = {"judo_tpu", "judo_tpu_torch", "jax", "jaxlib", "flax"}
REFERENCE = cells.HERE / "reference" / "tasks" / "fr3_pick.py"


def run_small(dtype: str) -> dict:
    """The cell on the CPU through the benchmark tests' own helper: ``R``
    rollouts over ``HORIZON``, in ``dtype``, the cell's own limits. Imported
    here: the helper's module sets torch's threads for the whole process."""
    from portbench.tests.conftest import run_small as portbench_run_small

    return portbench_run_small(CELL, R, HORIZON, dtype, SEED)


def failing(res: dict) -> set:
    return {k for k, v in res["checks"].items() if v["value"] is None or v["value"] > v["limit"]}


def test_cell_agrees_with_the_reference_in_float64():
    res = run_small("float64")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res["checks"]
    values = {k: v["value"] for k, v in res["checks"].items()}
    assert all(v is not None and v < 1e-9 for v in values.values()), values


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 3180000001])
def test_phase_is_lift_on_the_cells_stream(seed):
    """The harness's stream of the seed (``drive.StateStream`` from ``[seed, 0]``)."""
    workload = cells.workload(CELL)
    stream = drive.StateStream(cells.config(workload["config"]), workload, [seed, 0])
    task = FR3Pick(device="cpu", dtype=torch.float64)
    phases = {int(task.pre_rollout(stream(j))["phase"]) for j in range(200)}
    assert phases == {Phase.LIFT.value}


def test_reference_task_imports_nothing_of_the_port_or_jax():
    for node in ast.walk(ast.parse(REFERENCE.read_text())):
        names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
            [node.module] if isinstance(node, ast.ImportFrom) and node.module else []
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{REFERENCE.name} imports {n}"
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import portbench.reference.tasks.fr3_pick; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(sys.argv[2].split(','))))")
    out = subprocess.run([sys.executable, "-c", code, str(cells.ROOT), ",".join(FORBIDDEN)], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def _wrong_phase(monkeypatch):
    monkeypatch.setattr(FR3Pick, "pre_rollout", lambda self, state: {"phase": np.asarray(Phase.MOVE.value)})


def _weight_off(monkeypatch):
    task_params = FR3Pick.task_params

    def off(self):
        params = task_params(self)
        params["lift_weights"]["w_lift_height"] = params["lift_weights"]["w_lift_height"] * 1.01
        return params

    monkeypatch.setattr(FR3Pick, "task_params", off)


@pytest.mark.parametrize("plant", [_wrong_phase, _weight_off], ids=["wrong_phase", "weight_off_1pct"])
def test_planted_fault_is_caught(monkeypatch, plant):
    """In float64, where the sound program agrees with the reference to rounding
    (``test_cell_agrees_with_the_reference_in_float64``): the cell's limits
    are read for float32, whose own gap at this short horizon is wider than
    at the cell's T 252."""
    plant(monkeypatch)
    res = run_small("float64")
    assert not res["correct"] and {"reward_gap_median", "reward_gap_p90"} & failing(res), res["checks"]


def _carry_zeroed(monkeypatch):
    """The warm-start forces zeroed after every plan: each plan's solves start cold."""
    update_action = Controller.update_action

    def zeroed(self):
        update_action(self)
        self._carry.efc_warm.zero_()

    monkeypatch.setattr(Controller, "update_action", zeroed)


def _carry_frozen(monkeypatch):
    """The warm-start forces kept as the first plan left them: later plans read and write a stale copy."""
    update_action, first = Controller.update_action, []

    def frozen(self):
        update_action(self)
        if not first:
            first.append(self._carry.efc_warm.clone())
        self._carry.efc_warm.copy_(first[0])

    monkeypatch.setattr(Controller, "update_action", frozen)


@pytest.mark.parametrize("plant", [_carry_zeroed, _carry_frozen], ids=["zeroed", "frozen"])
def test_carry_fault_is_caught(monkeypatch, plant):
    """The carry reaches no reward of the plan that writes it, so only
    ``carry_gap_p90`` sees it: with the cube resting in its contact, on in
    float32 as in float64, the sound carry parts from the reference's at
    rounding, while a zeroed or a stale one parts by a share of its forces."""
    plant(monkeypatch)
    res = run_small("float64")
    assert not res["correct"] and "carry_gap_p90" in failing(res), res["checks"]
