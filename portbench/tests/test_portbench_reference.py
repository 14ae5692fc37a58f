"""The reference stands alone and agrees with the port's plain path: it
imports nothing of the port, the JAX package or JAX, and on the CPU in
float64 it works out the port's plans (leap_cube + MPPI and spot_navigate +
MPPI, few rollouts, a short horizon) to rounding."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench import cells

FORBIDDEN = {"judo_tpu", "judo_tpu_torch", "jax", "jaxlib", "flax"}


def test_reference_imports_nothing_of_the_port_or_jax():
    files = sorted((cells.HERE / "reference").rglob("*.py")) + sorted((cells.HERE / "counts").glob("*.py"))
    assert files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module] if isinstance(node, ast.ImportFrom) and node.module else []
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path.name} imports {n}"
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import portbench.reference.plan, portbench.counts.peaks; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(sys.argv[2].split(','))))")
    out = subprocess.run([sys.executable, "-c", code, str(cells.ROOT), ",".join(FORBIDDEN)], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("cell,R,horizon", [("leap_cube-mppi.r320", 6, 0.08), ("spot_navigate-mppi.r24", 4, 0.16)])
def test_reference_works_out_the_ports_plans_in_float64(small_run, cell, R, horizon):
    res = small_run(cell, R, horizon, "float64", 2**31 + 11)
    assert res["failed"] == 0 and res["attempted"] >= 1
    values = {k: v["value"] for k, v in res["checks"].items()}
    assert all(v is not None and v < 1e-9 for v in values.values()), values
