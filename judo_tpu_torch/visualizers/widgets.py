"""Config dataclass -> widget tree (the port's own copy of
``judo_tpu/visualizers/widgets.py``).

Fields reflect into a backend-agnostic ``WidgetSpec`` tree as the
reference's GUI reflects them into live widgets (judo/gui.py:90-419): int
and float -> slider, bounded by ``@slider`` metadata or derived from the
default; bool -> checkbox; Literal -> dropdown; 1D ndarray -> a folder of
per-element sliders (with the goal-marker metadata of ``np_1d_field``);
nested dataclass -> folder. ``ConfigBinding`` writes a widget's change back
into the shared config under a lock and sets a change event.
"""

from __future__ import annotations

import dataclasses
import threading
import typing
from dataclasses import dataclass, field
from typing import Any, Callable, Literal

import numpy as np

from judo_tpu_torch.gui import get_slider_metadata

WidgetKind = Literal["slider", "int_slider", "checkbox", "dropdown", "array", "folder"]


@dataclass
class WidgetSpec:
    kind: WidgetKind
    name: str
    path: tuple[str, ...]
    value: Any = None
    minimum: float | None = None
    maximum: float | None = None
    step: float | None = None
    options: list[str] | None = None
    children: list["WidgetSpec"] = field(default_factory=list)
    element_names: list[str] | None = None
    vis_name: str | None = None
    xyz_vis_indices: list[int | None] | None = None


def _auto_bounds(value: float) -> tuple[float, float, float]:
    """Bounds derived from the default value (gui.py auto-bounds heuristic)."""
    if value == 0:
        lo, hi = -1.0, 1.0
    elif value > 0:
        lo, hi = 0.0, 2.0 * value
    else:
        lo, hi = 2.0 * value, 0.0
    return lo, hi, (hi - lo) / 100.0


def reflect_config(cfg: Any, path: tuple[str, ...] = ()) -> list[WidgetSpec]:
    """Reflect a config dataclass instance into widget specs."""
    specs: list[WidgetSpec] = []
    hints = typing.get_type_hints(type(cfg))
    for f in dataclasses.fields(cfg):
        value = getattr(cfg, f.name)
        fpath = path + (f.name,)
        hint = hints.get(f.name, type(value))
        origin = typing.get_origin(hint)

        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            specs.append(
                WidgetSpec("folder", f.name, fpath, children=reflect_config(value, fpath))
            )
        elif origin is Literal:
            options = [str(o) for o in typing.get_args(hint)]
            specs.append(WidgetSpec("dropdown", f.name, fpath, value=str(value), options=options))
        elif isinstance(value, bool):
            specs.append(WidgetSpec("checkbox", f.name, fpath, value=value))
        elif isinstance(value, (int, float)):
            meta = get_slider_metadata(type(cfg), f.name)
            if meta is not None:
                lo, hi, st = meta["min"], meta["max"], meta["step"] or (meta["max"] - meta["min"]) / 100.0
            else:
                lo, hi, st = _auto_bounds(float(value))
            kind = "int_slider" if isinstance(value, int) else "slider"
            if kind == "int_slider":
                st = max(1, int(st)) if meta is None or meta["step"] is None else int(meta["step"])
            specs.append(WidgetSpec(kind, f.name, fpath, value=value, minimum=lo, maximum=hi, step=st))
        elif isinstance(value, np.ndarray) and value.ndim == 1:
            ui = (f.metadata or {}).get("ui_1d_array", {})
            n = value.shape[0]
            names = ui.get("names") or [f"[{i}]" for i in range(n)]
            mins = ui.get("mins") or [_auto_bounds(float(v))[0] for v in value]
            maxs = ui.get("maxs") or [_auto_bounds(float(v))[1] for v in value]
            steps = ui.get("steps") or [(hi - lo) / 100.0 for lo, hi in zip(mins, maxs)]
            children = [
                WidgetSpec(
                    "slider", names[i], fpath + (str(i),), value=float(value[i]),
                    minimum=float(mins[i]), maximum=float(maxs[i]), step=float(steps[i]),
                )
                for i in range(n)
            ]
            specs.append(
                WidgetSpec(
                    "array", f.name, fpath, value=value.copy(), children=children,
                    element_names=list(names), vis_name=ui.get("vis_name"),
                    xyz_vis_indices=ui.get("xyz_vis_indices"),
                )
            )
    return specs


class ConfigBinding:
    """Thread-safe write-back of widget changes into a config instance.

    Mirrors the lock + Event contract of the reference's gui callbacks
    (judo/gui.py:269-316): every change sets the event so the consuming node
    republishes the config.
    """

    def __init__(self, cfg: Any, on_change: Callable[[], None] | None = None) -> None:
        self.cfg = cfg
        self.lock = threading.Lock()
        self.changed = threading.Event()
        self._on_change = on_change

    def set_value(self, path: tuple[str, ...], value: Any) -> None:
        with self.lock:
            if path[-1].isdigit():  # 1D-array element: (..., field, "i")
                target = self.cfg
                for p in path[:-2]:
                    target = getattr(target, p)
                getattr(target, path[-2])[int(path[-1])] = value
            else:
                target = self.cfg
                for p in path[:-1]:
                    target = getattr(target, p)
                setattr(target, path[-1], value)
        self.changed.set()
        if self._on_change is not None:
            self._on_change()
