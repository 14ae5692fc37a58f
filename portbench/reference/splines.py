"""Control-knot splines: the benchmark's frozen copy of
``judo_tpu_torch/ops/splines.py``.

Same semantics as ``scipy.interpolate.interp1d`` with kind in {"zero",
"linear", "cubic"} along axis -2 and constant extrapolation with the edge
knots; "cubic" is the not-a-knot C2 spline, whose (N, N) system for the knot
slopes is tridiagonal and is solved by elimination down the band.
"""

from __future__ import annotations

import torch


def _interval_index(ts: torch.Tensor, tq: torch.Tensor, n_max: int) -> torch.Tensor:
    idx = torch.searchsorted(ts.contiguous(), tq.contiguous(), right=True) - 1
    return torch.clamp(idx, 0, n_max)


def _notaknot_slopes(ts: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """Knot slopes of the not-a-knot cubic: ts (N,), knots (..., N, nu).

    Row i of the system couples slopes i - 1, i and i + 1 (sub, diag and
    sup below; the two not-a-knot rows have two entries each), so forward
    elimination and back substitution solve it in 2N steps of elementwise
    operations. A dense solve would take the same pivots (partial pivoting
    never swaps rows here) but, on the card, waits for the device's queue on
    the host, which would serialize pipelined solves."""
    n = ts.shape[0]
    dt = ts[1:] - ts[:-1]
    slope = (knots[..., 1:, :] - knots[..., :-1, :]) / dt[:, None]
    d0, dn = ts[2] - ts[0], ts[-1] - ts[-3]
    sub = [None, *dt[1:], dn]
    diag = [dt[1], *(2.0 * (dt[:-1] + dt[1:])), dt[-2]]
    sup = [d0, *dt[:-1]]
    b0 = ((dt[0] + 2.0 * d0) * dt[1] * slope[..., 0, :] + dt[0] ** 2 * slope[..., 1, :]) / d0
    b_mid = 3.0 * (dt[1:, None] * slope[..., :-1, :] + dt[:-1, None] * slope[..., 1:, :])
    bn = (dt[-1] ** 2 * slope[..., -2, :] + (2.0 * dn + dt[-1]) * dt[-2] * slope[..., -1, :]) / dn
    rhs = [b0, *b_mid.unbind(-2), bn]
    c, y = [sup[0] / diag[0]], [rhs[0] / diag[0]]
    for i in range(1, n):
        m = diag[i] - sub[i] * c[-1]
        if i < n - 1:
            c.append(sup[i] / m)
        y.append((rhs[i] - sub[i] * y[-1]) / m)
    x = [y[-1]]
    for i in range(n - 2, -1, -1):
        x.insert(0, y[i] - c[i] * x[0])
    return torch.stack(x, dim=-2)


def eval_spline(ts: torch.Tensor, knots: torch.Tensor, tq: torch.Tensor, order: str = "linear") -> torch.Tensor:
    """Evaluate knots (..., N, nu) at times ts (N,) on queries tq (T,) -> (..., T, nu)."""
    n = ts.shape[0]
    if order == "zero":
        return torch.index_select(knots, -2, _interval_index(ts, tq, n - 1))
    tq_c = torch.minimum(torch.maximum(tq, ts[0]), ts[-1])
    idx = _interval_index(ts, tq_c, n - 2)
    t0 = ts[idx]
    y0 = torch.index_select(knots, -2, idx)
    y1 = torch.index_select(knots, -2, idx + 1)
    h = ts[idx + 1] - t0
    x = ((tq_c - t0) / h)[:, None]
    if order == "linear":
        return y0 + (y1 - y0) * x
    if order == "cubic":
        if n < 4:
            raise ValueError("cubic splines require at least 4 knots (reference forces num_nodes>=4)")
        slopes = _notaknot_slopes(ts, knots)
        s0 = torch.index_select(slopes, -2, idx) * h[:, None]
        s1 = torch.index_select(slopes, -2, idx + 1) * h[:, None]
        dy = y1 - y0
        c2 = 3.0 * dy - 2.0 * s0 - s1
        c3 = -2.0 * dy + s0 + s1
        return y0 + x * (s0 + x * (c2 + x * c3))
    raise ValueError(f"unknown spline order: {order}")


def interp_linear(old_ts: torch.Tensor, values: torch.Tensor, new_ts: torch.Tensor) -> torch.Tensor:
    """Linear re-interpolation of values (..., N, nu) at times old_ts (N,)
    onto new_ts (M,), extrapolating linearly past both ends (scipy's
    interp1d(kind="linear", fill_value="extrapolate"); CEM carries its sigma
    across a change of num_nodes with it)."""
    n = old_ts.shape[0]
    idx = _interval_index(old_ts, new_ts, n - 2)
    t0 = old_ts[idx]
    h = old_ts[idx + 1] - t0
    y0 = torch.index_select(values, -2, idx)
    y1 = torch.index_select(values, -2, idx + 1)
    x = ((new_ts - t0) / h)[:, None]
    return y0 + (y1 - y0) * x
