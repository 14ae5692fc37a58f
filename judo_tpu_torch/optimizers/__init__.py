"""Optimizer registry: predictive sampling, CEM and MPPI."""

from typing import Type

from judo_tpu_torch.optimizers.base import Optimizer, OptimizerConfig
from judo_tpu_torch.optimizers.cem import CrossEntropyMethod, CrossEntropyMethodConfig
from judo_tpu_torch.optimizers.mppi import MPPI, MPPIConfig
from judo_tpu_torch.optimizers.overrides import set_default_optimizer_overrides
from judo_tpu_torch.optimizers.ps import PredictiveSampling, PredictiveSamplingConfig

set_default_optimizer_overrides()

_registered_optimizers: dict[str, tuple[Type[Optimizer], Type[OptimizerConfig]]] = {}


def register_optimizer(name: str, opt_type: Type[Optimizer], cfg_type: Type[OptimizerConfig]) -> None:
    _registered_optimizers[name] = (opt_type, cfg_type)


def get_registered_optimizers() -> dict[str, tuple[Type[Optimizer], Type[OptimizerConfig]]]:
    return _registered_optimizers


register_optimizer("ps", PredictiveSampling, PredictiveSamplingConfig)
register_optimizer("cem", CrossEntropyMethod, CrossEntropyMethodConfig)
register_optimizer("mppi", MPPI, MPPIConfig)

__all__ = [
    "MPPI", "CrossEntropyMethod", "CrossEntropyMethodConfig", "MPPIConfig", "Optimizer", "OptimizerConfig",
    "PredictiveSampling", "PredictiveSamplingConfig", "get_registered_optimizers", "register_optimizer",
]
