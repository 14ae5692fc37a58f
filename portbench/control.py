"""The readings that the limits of the output check are set from, for one cell
on the card, in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds 1,2,... --control-seeds 7,8,9

For each of ``--seeds`` it runs the cell (set-up, a window of ``--seconds``
at the cell's own load, the check) and prints the program's compared
numbers: their largest over the seeds is each number's lower reading. For
each of ``--control-seeds`` it runs the cell the same way and prints the
numbers of the control, the reference in the precision below the
configuration's (``check.CONTROL_DTYPE``: bfloat16 for float32) in the
program's place on the same inputs: their smallest is the upper reading.
For each of ``--witness-seeds`` it prints the numbers of the reference in
the configuration's own precision in the program's place: how far that
precision parts from the float64 reference, a witness for the lower readings. The last line is one
JSON object with both readings of every number. The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--witness-seeds", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench import cells, check, harness

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    bench = cells.benchmark()
    entry, workload, config = cells.cell(args.workload, bench)
    readings = {"program": {}, "control": {}, "witness": {}}
    runs = [("program", int(s)) for s in args.seeds.split(",")]
    runs += [("control", int(s)) for s in args.control_seeds.split(",")]
    runs += [("witness", int(s)) for s in args.witness_seeds.split(",") if s]
    for producer, seed in runs:
        t0 = time.perf_counter()
        run = SimpleNamespace(seed=seed, seconds=args.seconds, trace=0)
        res = harness.run_cell(run, bench, entry, workload, config, t0, producer=producer)
        values = {k: v["value"] for k, v in res["checks"].items()}
        readings[producer][seed] = values
        print(json.dumps({"side": producer, "seed": seed, "plans": res["attempted"], "failed": res["failed"],
                          "seconds": time.perf_counter() - t0, "numbers": values}), flush=True)
    summary = {}
    for name in check.NUMBERS:
        got = {side: [v[name] for v in readings[side].values()] for side in readings}
        lower = None if not got["program"] or any(x is None for x in got["program"]) else max(got["program"])
        upper = min((x for x in got["control"] if x is not None), default=None)  # a control with no number fails
        witness = max((x for x in got["witness"] if x is not None), default=None)
        summary[name] = {"lower": lower, "upper": upper, "witness": witness,
                         "ratio": None if not lower or upper is None else upper / lower}
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(0), "readings": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
