"""MPPI (counterpart of ``judo_tpu/optimizers/mppi.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from judo_tpu_torch.gui import slider
from judo_tpu_torch.optimizers.base import Optimizer, OptimizerConfig


@slider("sigma", 0.001, 1.0, 0.01)
@slider("temperature", 0.001, 2.0, 0.05)
@dataclass
class MPPIConfig(OptimizerConfig):
    sigma: float = 0.1
    temperature: float = 0.05


class MPPI(Optimizer[MPPIConfig]):
    """Gaussian sampling; softmax-weighted average update."""

    def params(self, dtype: torch.dtype = torch.float32, device: Any = "cpu") -> Any:
        return {
            "sigma": torch.tensor(self.config.sigma, dtype=dtype, device=device),
            "temperature": torch.tensor(self.config.temperature, dtype=dtype, device=device),
        }

    def sample_from_noise(self, params: Any, state: Any, nominal: torch.Tensor, noise: torch.Tensor):
        sigma = params["sigma"]
        if self.use_noise_ramp:
            sigma = self._ramp(nominal.dtype, nominal.device) * sigma
        noised = nominal[None] + sigma * noise
        return torch.cat([nominal[None], noised], dim=0), state

    def update(self, params: Any, state: Any, samples: torch.Tensor, rewards: torch.Tensor):
        """exp(-(cost - min) / temperature)-weighted knot average."""
        costs = -rewards
        weights = torch.exp(-(costs - torch.min(costs)) / params["temperature"])
        weights = weights / torch.sum(weights)
        return torch.sum(weights[:, None, None] * samples, dim=0), state
