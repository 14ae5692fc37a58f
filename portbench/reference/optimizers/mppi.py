"""MPPI, the benchmark's frozen copy of ``judo_tpu_torch/optimizers/mppi.py``."""

from __future__ import annotations

import torch


def sample(params: dict, nominal: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """(N, nu) nominal, (R - 1, N, nu) noise -> (R, N, nu) candidates: the
    nominal first, then the nominal plus sigma (times the noise ramp) times
    the noise. The ramp is noise_ramp * linspace(1/N, 1, N) over the knots."""
    sigma = params["sigma"]
    if params["use_noise_ramp"]:
        n = nominal.shape[0]
        ramp = params["noise_ramp"] * torch.linspace(1.0 / n, 1.0, n, dtype=nominal.dtype, device=nominal.device)
        sigma = ramp[:, None] * sigma
    return torch.cat([nominal[None], nominal[None] + sigma * noise], dim=0)


def update(params: dict, samples: torch.Tensor, rewards: torch.Tensor) -> torch.Tensor:
    """The exp(-(cost - min cost) / temperature)-weighted average of the candidates."""
    costs = -rewards
    weights = torch.exp(-(costs - torch.min(costs)) / params["temperature"])
    weights = weights / torch.sum(weights)
    return torch.sum(weights[:, None, None] * samples, dim=0)
