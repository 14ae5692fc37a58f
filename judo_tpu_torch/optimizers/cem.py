"""Cross-entropy method (counterpart of ``judo_tpu/optimizers/cem.py``).

The per-(node, nu) sigma is carried state, threaded through ``sample`` and
``update`` as ``{"sigma": (N, nu)}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from judo_tpu_torch.ops.splines import interp_linear
from judo_tpu_torch.optimizers.base import Optimizer, OptimizerConfig, top_k_indices


@dataclass
class CrossEntropyMethodConfig(OptimizerConfig):
    sigma_min: float = 0.1
    sigma_max: float = 1.0
    num_elites: int = 2


class CrossEntropyMethod(Optimizer[CrossEntropyMethodConfig]):
    """Elite-fit Gaussian: the elites' mean is the nominal, their clipped
    population std the next sigma."""

    @property
    def num_elites(self) -> int:
        return self.config.num_elites

    def params(self, dtype: torch.dtype = torch.float32, device: Any = "cpu") -> Any:
        return {
            "sigma_min": torch.tensor(self.config.sigma_min, dtype=dtype, device=device),
            "sigma_max": torch.tensor(self.config.sigma_max, dtype=dtype, device=device),
        }

    def init_state(self, dtype: torch.dtype = torch.float32, device: Any = "cpu") -> Any:
        sigma0 = (self.config.sigma_min + self.config.sigma_max) / 2.0
        return {"sigma": torch.full((self.num_nodes, self.nu), sigma0, dtype=dtype, device=device)}

    def pre_optimization(self, params: Any, state: Any, old_times: torch.Tensor, new_times: torch.Tensor) -> Any:
        """Re-interpolate sigma onto the new knot grid when the node count changed."""
        if state["sigma"].shape[0] != new_times.shape[0]:
            state = {"sigma": interp_linear(old_times, state["sigma"], new_times)}
        return state

    def sample_from_noise(self, params: Any, state: Any, nominal: torch.Tensor, noise: torch.Tensor):
        sigma = state["sigma"]
        if self.use_noise_ramp:
            n = self.num_nodes
            ramp = torch.linspace(
                self.config.noise_ramp / n, self.config.noise_ramp, n, dtype=nominal.dtype, device=nominal.device
            )[:, None]
            sigma = torch.minimum(torch.maximum(sigma * ramp, params["sigma_min"]), params["sigma_max"])
            state = {"sigma": sigma}
        return torch.cat([nominal[None], nominal[None] + sigma[None] * noise], dim=0), state

    def update(self, params: Any, state: Any, samples: torch.Tensor, rewards: torch.Tensor):
        """Mean of the top-k elites, and their population std clipped to
        [sigma_min, sigma_max]."""
        elites = samples[top_k_indices(rewards, self.num_elites)]
        sigma = torch.std(elites, dim=0, correction=0)
        sigma = torch.minimum(torch.maximum(sigma, params["sigma_min"]), params["sigma_max"])
        return torch.mean(elites, dim=0), {"sigma": sigma}
