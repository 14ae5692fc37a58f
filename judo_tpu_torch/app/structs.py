"""Messages between the simulation loop and the controller (the port's own
copy of ``MujocoState`` and ``SplineData`` from ``judo_tpu/app/structs.py``).
They stay plain numpy: only the solve runs on the device."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Literal

import numpy as np
from scipy.interpolate import interp1d


@dataclass
class MujocoState:
    """Simulation state snapshot published to the controller and visualizer."""

    time: float
    qpos: np.ndarray
    qvel: np.ndarray
    xpos: np.ndarray
    xquat: np.ndarray
    mocap_pos: np.ndarray
    mocap_quat: np.ndarray
    sim_metadata: dict[str, Any] = field(default_factory=dict)


KindType = Literal["zero", "linear", "cubic"]


@dataclass
class SplineData:
    """(Possibly batched) spline knots; ``spline()`` builds the evaluator."""

    t: np.ndarray
    x: np.ndarray
    kind: KindType = "zero"
    extrapolate: bool = True

    def spline(self) -> interp1d:
        fill_value = (self.x[..., 0, :], self.x[..., -1, :])
        return interp1d(
            self.t, self.x, kind=self.kind, axis=-2, copy=False, fill_value=fill_value,  # type: ignore[arg-type]
            bounds_error=not self.extrapolate,
        )
