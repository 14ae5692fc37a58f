"""Optimizer registry (the port holds MPPI so far)."""

from typing import Type

from judo_tpu_torch.optimizers.base import Optimizer, OptimizerConfig
from judo_tpu_torch.optimizers.mppi import MPPI, MPPIConfig

_registered_optimizers: dict[str, tuple[Type[Optimizer], Type[OptimizerConfig]]] = {}


def register_optimizer(name: str, opt_type: Type[Optimizer], cfg_type: Type[OptimizerConfig]) -> None:
    _registered_optimizers[name] = (opt_type, cfg_type)


def get_registered_optimizers() -> dict[str, tuple[Type[Optimizer], Type[OptimizerConfig]]]:
    return _registered_optimizers


register_optimizer("mppi", MPPI, MPPIConfig)

__all__ = ["MPPI", "MPPIConfig", "Optimizer", "OptimizerConfig", "get_registered_optimizers", "register_optimizer"]
