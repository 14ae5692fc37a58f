"""Cost kernels shared by task rewards (counterpart of ``judo_tpu/ops/costs.py``)."""

from __future__ import annotations

import torch


def smooth_l1_norm(x: torch.Tensor, p: float) -> torch.Tensor:
    """Elementwise pseudo-Huber: sqrt(x^2 + p^2) - p."""
    return torch.sqrt(torch.square(x) + p * p) - p


def quadratic_norm(x: torch.Tensor) -> torch.Tensor:
    """0.5 * sum of squares over the trailing axis."""
    return 0.5 * torch.sum(torch.square(x), dim=-1)
