"""Action normalizers as pure functions with explicit state (counterpart of
``judo_tpu/utils/normalization.py``): identity, min-max over finite
ctrlrange dims, and a running Welford mean/std."""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np
import torch

_EPS = 1e-6

normalizer_registry = ("none", "min_max", "running")


def make_normalizer_params(
    kind: str, nu: int, ctrlrange: np.ndarray | None = None, init_std: float = 1.0, min_std: float = 1e-5,
    max_std: float = 1e3, dtype: torch.dtype = torch.float32, device: Any = "cpu",
) -> dict[str, Any]:
    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    if kind == "min_max":
        lo, hi = np.asarray(ctrlrange)[:, 0], np.asarray(ctrlrange)[:, 1]
        finite = np.isfinite(lo) & np.isfinite(hi)
        if not finite.all():
            warnings.warn(
                f"MinMax normalizer: action dims {np.where(~finite)[0].tolist()} have infinite ctrlrange "
                "and will not be normalized.",
                UserWarning,
                stacklevel=2,
            )
        return {"min": t(np.where(finite, lo, 0.0)), "max": t(np.where(finite, hi, 1.0)),
                "finite": torch.as_tensor(finite, device=device)}
    if kind == "running":
        return {"min_std": t(min_std), "max_std": t(max_std), "init_std": t(init_std)}
    return {}


def init_normalizer_state(kind: str, nu: int, params: dict, dtype: torch.dtype = torch.float32, device: Any = "cpu") -> dict:
    if kind == "running":
        z = torch.zeros(nu, dtype=dtype, device=device)
        return {"count": torch.zeros((), dtype=dtype, device=device), "mean": z, "m2": z.clone(),
                "std": torch.ones(nu, dtype=dtype, device=device) * params["init_std"]}
    return {}


def normalize(kind: str, params: dict, state: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "min_max":
        scaled = 2.0 * (x - params["min"]) / (params["max"] - params["min"]) - 1.0
        return torch.where(params["finite"], scaled, x)
    if kind == "running":
        return (x - state["mean"]) / (state["std"] + _EPS)
    return x


def denormalize(kind: str, params: dict, state: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "min_max":
        scaled = (x + 1.0) * (params["max"] - params["min"]) / 2.0 + params["min"]
        return torch.where(params["finite"], scaled, x)
    if kind == "running":
        return x * state["std"] + state["mean"]
    return x


def update_normalizer(kind: str, params: dict, state: dict, x: torch.Tensor) -> dict:
    """Welford batch update of the running statistics."""
    if kind != "running":
        return state
    batch = x.reshape(-1, x.shape[-1])
    count = state["count"] + batch.shape[0]
    delta = batch - state["mean"]
    mean = state["mean"] + torch.sum(delta, dim=0) / count
    m2 = torch.clamp(state["m2"] + torch.sum(delta * (batch - mean), dim=0), min=0.0)
    std = torch.minimum(torch.maximum(torch.sqrt(m2 / count), params["min_std"]), params["max_std"])
    return {"count": count, "mean": mean, "m2": m2, "std": std}
