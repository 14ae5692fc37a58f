"""Predictive sampling (counterpart of ``judo_tpu/optimizers/ps.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from judo_tpu_torch.optimizers.base import Optimizer, OptimizerConfig


@dataclass
class PredictiveSamplingConfig(OptimizerConfig):
    sigma: float = 0.05


class PredictiveSampling(Optimizer[PredictiveSamplingConfig]):
    """Gaussian perturbations around the nominal; the best sample wins."""

    def params(self, dtype: torch.dtype = torch.float32, device: Any = "cpu") -> Any:
        return {"sigma": torch.tensor(self.config.sigma, dtype=dtype, device=device)}

    def sample_from_noise(self, params: Any, state: Any, nominal: torch.Tensor, noise: torch.Tensor):
        """samples[0] is the nominal, the rest nominal + sigma * noise."""
        sigma = params["sigma"]
        if self.use_noise_ramp:
            sigma = self._ramp(nominal.dtype, nominal.device) * sigma
        return torch.cat([nominal[None], nominal[None] + sigma * noise], dim=0), state

    def update(self, params: Any, state: Any, samples: torch.Tensor, rewards: torch.Tensor):
        """The sample of the largest reward; the first one on ties (jnp.argmax)."""
        return samples[torch.argmax(rewards)], state
