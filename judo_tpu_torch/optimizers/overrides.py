"""Per-task optimizer defaults (the values of
``judo_tpu/optimizers/overrides.py``, for every task of the JAX package)."""

from __future__ import annotations

from judo_tpu_torch.config import set_config_overrides
from judo_tpu_torch.optimizers.base import OptimizerConfig
from judo_tpu_torch.optimizers.cem import CrossEntropyMethodConfig
from judo_tpu_torch.optimizers.mppi import MPPIConfig
from judo_tpu_torch.optimizers.ps import PredictiveSamplingConfig

SPOT_TASK_NAMES = ("spot_base", "spot_box_push", "spot_navigate", "spot_tire_roll", "spot_tire_upright")


def _simple_task(name: str) -> None:
    base = {"num_nodes": 4, "num_rollouts": 32, "use_noise_ramp": True}
    set_config_overrides(name, PredictiveSamplingConfig, base)
    set_config_overrides(name, CrossEntropyMethodConfig, {**base, "num_elites": 2})
    set_config_overrides(name, MPPIConfig, base)


def _leap_task(name: str, num_rollouts_cem_mppi: int = 32) -> None:
    ramp = {"num_nodes": 4, "use_noise_ramp": True, "noise_ramp": 4.0}
    set_config_overrides(name, PredictiveSamplingConfig, {**ramp, "num_rollouts": 32, "sigma": 0.2})
    set_config_overrides(name, CrossEntropyMethodConfig, {**ramp, "num_rollouts": num_rollouts_cem_mppi, "num_elites": 3})
    set_config_overrides(
        name, MPPIConfig, {**ramp, "num_rollouts": num_rollouts_cem_mppi, "sigma": 0.2, "temperature": 0.0025}
    )


def set_default_optimizer_overrides() -> None:
    """Register every per-task optimizer default."""
    _simple_task("cartpole")
    _simple_task("cylinder_push")
    _leap_task("leap_cube")
    _leap_task("caltech_leap_cube")
    _leap_task("leap_cube_down", num_rollouts_cem_mppi=64)

    spot_base = {"num_rollouts": 24, "num_nodes": 3, "use_noise_ramp": True, "noise_ramp": 3.5}
    for name in SPOT_TASK_NAMES:
        set_config_overrides(name, OptimizerConfig, spot_base)
        set_config_overrides(name, PredictiveSamplingConfig, spot_base)
        set_config_overrides(name, CrossEntropyMethodConfig, {**spot_base, "num_elites": 3})
        set_config_overrides(name, MPPIConfig, spot_base)

    fr3 = {"num_rollouts": 64, "use_noise_ramp": True, "noise_ramp": 4.0}
    set_config_overrides("fr3_pick", PredictiveSamplingConfig, {**fr3, "num_nodes": 8, "sigma": 0.2})
    set_config_overrides(
        "fr3_pick", CrossEntropyMethodConfig, {**fr3, "num_nodes": 4, "num_elites": 3, "sigma_min": 0.01, "sigma_max": 0.3}
    )
    set_config_overrides("fr3_pick", MPPIConfig, {**fr3, "num_nodes": 4, "sigma": 0.01, "temperature": 0.002})
