"""The port's profiling hooks on the CPU: ``trace`` writes a Chrome trace of
the block with the regions ``annotate`` names, as the JAX package's
``trace`` and ``annotate`` do with ``jax.profiler``."""

import json

import numpy as np
import torch

from judo_tpu_torch.controller import make_controller
from judo_tpu_torch.utils.profiling import annotate, trace


def test_trace_writes_a_chrome_trace_with_annotated_regions(tmp_path):
    np.random.seed(0)
    c = make_controller("cartpole", "ps", device="cpu", dtype=torch.float64, seed=0)
    with trace(tmp_path / "tr") as prof:
        for _ in range(2):
            with annotate("update_action"):
                c.update_action()
    assert prof.trace_path.parent == tmp_path / "tr" and prof.trace_path.suffix == ".json"
    events = json.loads(prof.trace_path.read_text())["traceEvents"]
    regions = [e for e in events if e.get("name") == "update_action"]
    assert len(regions) == 2 and all(e["dur"] > 0 for e in regions)
    assert any(e.get("cat") == "cpu_op" for e in events)  # the solve's operations inside the regions
