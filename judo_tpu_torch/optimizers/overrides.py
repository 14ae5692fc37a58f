"""Per-task optimizer defaults ported so far (the leap_cube and spot_navigate
values of ``judo_tpu/optimizers/overrides.py`` for MPPI)."""

from __future__ import annotations

from judo_tpu_torch.config import set_config_overrides
from judo_tpu_torch.optimizers.mppi import MPPIConfig


def set_default_optimizer_overrides() -> None:
    set_config_overrides(
        "leap_cube",
        MPPIConfig,
        {"num_nodes": 4, "use_noise_ramp": True, "noise_ramp": 4.0, "num_rollouts": 32, "sigma": 0.2,
         "temperature": 0.0025},
    )
    set_config_overrides(
        "spot_navigate", MPPIConfig, {"num_rollouts": 24, "num_nodes": 3, "use_noise_ramp": True, "noise_ramp": 3.5}
    )
