"""Host time of the port's plain planning solve on the CPU (the path of
``--platform cpu``), this checkout against another.

    python3 plain_solve_time.py [OTHER_CHECKOUT] [--solves N] [--threads T]

Each (task, optimizer, rollouts) of CASES is planned in float32 with the
task's defaults: one warm-up solve, then N timed ``update_action`` calls. A
checkout runs in a process of its own (``judo_tpu_torch`` imported from its
root, ``torch.set_num_threads(T)``), in the order this, other, other, this.
Each process prints one JSON line: per case the times in ms and the median;
the process's peak resident memory (``ru_maxrss``) after all cases. Without
OTHER_CHECKOUT only this checkout runs, twice.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

# (task, optimizer, rollouts; None: the task's default)
CASES = [("leap_cube", "mppi", None), ("spot_navigate", "mppi", None), ("spot_navigate", "mppi", 256)]


def child(solves: int, threads: int) -> None:
    import numpy as np
    import torch

    from judo_tpu_torch.controller import make_controller

    torch.set_num_threads(threads)
    out = {}
    for task, opt, R in CASES:
        c = make_controller(task, opt, device="cpu", dtype=torch.float32, seed=0)
        if R is not None:
            c.optimizer_cfg.num_rollouts = R
        c.update_action()
        ms = []
        for _ in range(solves):
            t0 = time.perf_counter()
            c.update_action()
            ms.append(1e3 * (time.perf_counter() - t0))
        out[f"{task} {opt} R={c.optimizer_cfg.num_rollouts}"] = {"ms": ms, "median_ms": float(np.median(ms))}
    out["maxrss_mib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print(json.dumps(out), flush=True)


def run(root: Path, solves: int, threads: int) -> dict:
    env = {**os.environ, "PYTHONPATH": str(root)}
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child", "--solves", str(solves), "--threads", str(threads)]
    p = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, check=True)
    return json.loads(p.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--solves", type=int, default=5)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        child(args.solves, args.threads)
        return
    here = Path(__file__).resolve().parent
    other = Path(args.other).resolve() if args.other else here
    for label, root in (("this", here), ("other", other), ("other", other), ("this", here)):
        res = run(root, args.solves, args.threads)
        medians = {k: round(v["median_ms"], 1) for k, v in res.items() if isinstance(v, dict)}
        print(f"{label} ({root}): medians {medians}; peak RSS {res['maxrss_mib']:.0f} MiB", flush=True)
        print(json.dumps({"checkout": label, **res}), flush=True)


if __name__ == "__main__":
    main()
