"""Per-task controller defaults (the values of
``judo_tpu/controller/overrides.py``, for every task of the JAX package)."""

from __future__ import annotations

from judo_tpu_torch.config import set_config_overrides
from judo_tpu_torch.controller.controller import ControllerConfig
from judo_tpu_torch.optimizers.overrides import SPOT_TASK_NAMES


def set_default_controller_overrides() -> None:
    for name in ("cartpole", "cylinder_push"):
        set_config_overrides(name, ControllerConfig, {"horizon": 1.0, "spline_order": "zero"})
    for name in ("leap_cube", "leap_cube_down", "caltech_leap_cube"):
        set_config_overrides(name, ControllerConfig, {"horizon": 1.0, "spline_order": "cubic", "max_num_traces": 1})
    for name in SPOT_TASK_NAMES:
        set_config_overrides(name, ControllerConfig, {"horizon": 2.0})
    set_config_overrides(
        "fr3_pick", ControllerConfig,
        {"horizon": 1.0, "spline_order": "linear", "max_num_traces": 3, "control_freq": 20.0},
    )
