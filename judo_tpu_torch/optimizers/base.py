"""Optimizer base: configs plus the pure sample/update interface
(counterpart of ``judo_tpu/optimizers/base.py``).

    params()                                     -> hyperparameters as tensors
    init_state(dtype, device)                    -> carried optimizer state
    sample(params, state, nominal, generator)    -> (samples (R, N, nu), state)
    draw_noise(generator, out)                   -> out filled with standard normal noise
    sample_from_noise(params, state, nominal, noise) -> (samples (R, N, nu), state)
    update(params, state, samples, rewards)      -> (nominal (N, nu), state)
    pre_optimization(params, state, old_t, new_t) -> state

Sampling draws from an explicit ``torch.Generator``. The controller draws
each optimizer iteration's noise with ``draw_noise`` before the solve runs and
hands it to ``sample_from_noise`` inside the solve, so a captured solve reads
the noise from a buffer that the draws fill.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Generic, TypeVar

import torch

from judo_tpu_torch.config import OverridableConfig
from judo_tpu_torch.gui import slider


@slider("num_nodes", 3, 12, 1)
@dataclass
class OptimizerConfig(OverridableConfig):
    num_rollouts: int = 16
    num_nodes: int = 4
    use_noise_ramp: bool = False
    noise_ramp: float = 2.5


OptimizerConfigT = TypeVar("OptimizerConfigT", bound=OptimizerConfig)


class Optimizer(Generic[OptimizerConfigT]):
    """Base class of the sampling optimizers."""

    def __init__(self, config: OptimizerConfigT, nu: int) -> None:
        self.config = config
        self.nu = nu

    @property
    def num_rollouts(self) -> int:
        return self.config.num_rollouts

    @property
    def num_nodes(self) -> int:
        return self.config.num_nodes

    @property
    def use_noise_ramp(self) -> bool:
        return self.config.use_noise_ramp

    def params(self, dtype: torch.dtype = torch.float32, device: Any = "cpu") -> Any:
        return {}

    def init_state(self, dtype: torch.dtype = torch.float32, device: Any = "cpu") -> Any:
        return {}

    def pre_optimization(self, params: Any, state: Any, old_times: torch.Tensor, new_times: torch.Tensor) -> Any:
        return state

    def stop_cond(self) -> bool:
        return False

    def _ramp(self, dtype: torch.dtype, device: Any) -> torch.Tensor:
        """Noise ramp column: noise_ramp * linspace(1/N, 1, N)."""
        n = self.num_nodes
        return self.config.noise_ramp * torch.linspace(1.0 / n, 1.0, n, dtype=dtype, device=device)[:, None]

    def sample_from_noise(self, params: Any, state: Any, nominal: torch.Tensor, noise: torch.Tensor):
        raise NotImplementedError

    def noise_shape(self) -> tuple[int, int, int]:
        """Shape of one iteration's noise: (R - 1, N, nu)."""
        return (self.num_rollouts - 1, self.num_nodes, self.nu)

    def draw_noise(self, generator: torch.Generator, out: torch.Tensor) -> torch.Tensor:
        """Fill ``out`` (R - 1, N, nu) with standard normal noise from ``generator``."""
        return torch.randn(self.noise_shape(), generator=generator, out=out)

    def sample(self, params: Any, state: Any, nominal: torch.Tensor, generator: torch.Generator):
        """Draw standard normal noise (R - 1, N, nu) and sample from it."""
        noise = torch.empty(self.noise_shape(), dtype=nominal.dtype, device=nominal.device)
        return self.sample_from_noise(params, state, nominal, self.draw_noise(generator, noise))

    def update(self, params: Any, state: Any, samples: torch.Tensor, rewards: torch.Tensor):
        raise NotImplementedError


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of x, largest first, the lower index
    first among equal values (jax.lax.top_k's order; torch.topk leaves ties
    unordered)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]
