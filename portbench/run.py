"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the controller of the cell's configuration with the port
(``judo_tpu_torch``), loads its kernels (building them on the first run in a
checkout, into ``build/judo_tpu_torch/``), captures the solve graph and
warms the cell's shapes up. The window then calls ``update_action`` back to
back for ``--seconds``. With ``--trace 1`` the same window is timed, a slice
of plans after it runs under ``torch.profiler``, and the cell's per-layer
metrics are read; with ``--trace 0`` its end-to-end metrics. After the window the published plans
are held against the plain reference (``check.py``). The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last the
compared numbers with their limits (``checks``), which also end standard
error.

Without a CUDA card, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded once the window has closed, it exits with 2 and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# Top-level module names that may not be loaded in the process that prints a result.
FORBIDDEN = ("jax", "jaxlib", "flax", "judo_tpu")


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return 2


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    """The card's power limit as nvidia-smi reports it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def open_context() -> None:
    """Create the card's CUDA context, so that set-up's phases show it apart."""
    import torch

    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import cells

    bench = cells.benchmark()
    entry, workload, config = cells.cell(args.workload, bench)
    marks = [("start", time.perf_counter())]

    import torch

    marks.append(("import torch", time.perf_counter()))

    if not torch.cuda.is_available():
        return fail("no CUDA card (torch.cuda.is_available() is False): the benchmark runs on the card only")
    if torch.cuda.device_count() < entry["chips"]:
        return fail(f"the cell asks for {entry['chips']} cards, {torch.cuda.device_count()} visible")
    # the program's kernel caches stay inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    torch.set_num_threads(1)
    open_context()
    marks.append(("CUDA context", time.perf_counter()))

    from portbench import harness

    result = harness.run_cell(args, bench, entry, workload, config, T_START, marks=marks)
    found = forbidden_modules()
    if found:
        return fail(f"modules loaded in this process: {', '.join(found)} (none of {', '.join(FORBIDDEN)} may be)")
    result["device"]["power_limit"] = power_limit()
    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
