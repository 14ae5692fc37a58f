"""Batched quaternion math (wxyz), counterpart of ``judo_tpu/ops/math.py``."""

from __future__ import annotations

import math

import torch


def safe_normalize_axis(axis: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize 3D axis vectors, substituting [1, 0, 0] for near-zero norms."""
    norm = torch.linalg.vector_norm(axis, dim=-1)
    small = norm < eps
    normalized = axis / torch.where(small, torch.ones_like(norm), norm)[..., None]
    fallback = torch.zeros_like(normalized)
    fallback[..., 0] = 1.0
    return torch.where(small[..., None], fallback, normalized)


def quat_inv(u: torch.Tensor) -> torch.Tensor:
    """Conjugate of a (unit) quaternion (no host-to-device copy: a planning
    solve must not wait for the device's queue)."""
    return torch.cat([u[..., :1], -u[..., 1:]], dim=-1)


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product with broadcasting."""
    w = u[..., 0] * v[..., 0] - u[..., 1] * v[..., 1] - u[..., 2] * v[..., 2] - u[..., 3] * v[..., 3]
    x = u[..., 0] * v[..., 1] + u[..., 1] * v[..., 0] + u[..., 2] * v[..., 3] - u[..., 3] * v[..., 2]
    y = u[..., 0] * v[..., 2] - u[..., 1] * v[..., 3] + u[..., 2] * v[..., 0] + u[..., 3] * v[..., 1]
    z = u[..., 0] * v[..., 3] + u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1] + u[..., 3] * v[..., 0]
    return torch.stack([w, x, y, z], dim=-1)


def quat_diff(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u^* (x) v."""
    return quat_mul(quat_inv(u), v)


def quat_diff_so3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """SO(3) log map of the relative rotation u^* (x) v."""
    diff = quat_diff(u, v)
    axis = diff[..., 1:]
    sin_half = torch.linalg.vector_norm(axis, dim=-1)
    axis = safe_normalize_axis(axis, eps=1e-6)
    speed = 2.0 * torch.atan2(sin_half, diff[..., 0])
    speed = torch.where(speed > math.pi, speed - 2.0 * math.pi, speed)
    return axis * speed[..., None]


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` by quaternions ``q`` (wxyz), broadcasting leading dims."""
    u, v = torch.broadcast_tensors(q[..., 1:], v)
    w = q[..., :1]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))
