"""Dataclass field factory for GUI-visible 1D numpy arrays (the port's own
copy of ``judo_tpu/utils/fields.py``).

Mirrors judo/utils/fields.py:11-101: attaches per-element slider metadata
(names/mins/maxs/steps) and an optional 3D goal-marker visualization spec
(vis_name + xyz index mapping) to a numpy default, via dataclass field
metadata. The GUI layer reflects these into sliders + draggable markers.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


def np_1d_field(
    default: np.ndarray,
    names: Sequence[str] | None = None,
    mins: Sequence[float] | None = None,
    maxs: Sequence[float] | None = None,
    steps: Sequence[float] | None = None,
    vis_name: str | None = None,
    xyz_vis_indices: Sequence[int | None] | None = None,
    xyz_vis_defaults: Sequence[float] | None = None,
) -> dataclasses.Field:
    """A dataclass field holding a 1D ndarray with per-element GUI metadata."""
    default = np.asarray(default)
    if default.ndim != 1:
        raise ValueError("np_1d_field requires a 1D array default")
    n = default.shape[0]
    names = list(names) if names is not None else [f"[{i}]" for i in range(n)]
    for label, seq in (("names", names), ("mins", mins), ("maxs", maxs), ("steps", steps)):
        if seq is not None and len(seq) != n:
            raise ValueError(f"{label} must have length {n}")
    metadata = {
        "ui_1d_array": {
            "names": names,
            "mins": list(mins) if mins is not None else None,
            "maxs": list(maxs) if maxs is not None else None,
            "steps": list(steps) if steps is not None else None,
            "vis_name": vis_name,
            "xyz_vis_indices": list(xyz_vis_indices) if xyz_vis_indices is not None else None,
            "xyz_vis_defaults": list(xyz_vis_defaults) if xyz_vis_defaults is not None else None,
        }
    }
    return dataclasses.field(default_factory=lambda: default.copy(), metadata=metadata)
