"""Per-task optimizer defaults ported so far (values of
``judo_tpu/optimizers/overrides.py`` for the leap tasks and MPPI)."""

from __future__ import annotations

from judo_tpu.config import set_config_overrides
from judo_tpu_torch.optimizers.mppi import MPPIConfig


def set_leap_optimizer_overrides(name: str = "leap_cube", num_rollouts: int = 32) -> None:
    set_config_overrides(
        name,
        MPPIConfig,
        {"num_nodes": 4, "use_noise_ramp": True, "noise_ramp": 4.0, "num_rollouts": num_rollouts,
         "sigma": 0.2, "temperature": 0.0025},
    )
