"""Per-task controller defaults ported so far (the leap and spot_navigate
values of ``judo_tpu/controller/overrides.py``)."""

from __future__ import annotations

from judo_tpu_torch.config import set_config_overrides
from judo_tpu_torch.controller.controller import ControllerConfig


def set_default_controller_overrides() -> None:
    for name in ("leap_cube", "leap_cube_down", "caltech_leap_cube"):
        set_config_overrides(name, ControllerConfig, {"horizon": 1.0, "spline_order": "cubic", "max_num_traces": 1})
    set_config_overrides("spot_navigate", ControllerConfig, {"horizon": 2.0})
