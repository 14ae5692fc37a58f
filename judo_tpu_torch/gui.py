"""GUI metadata layer: the ``slider`` decorator (the port's own copy of
``judo_tpu/gui.py``).

The reference attaches per-field slider metadata to dataclass configs via a
decorator that rebuilds the dataclass (judo/gui.py:25-75); the browser GUI then
reflects configs into widgets. Here the decorator just records metadata in a
side table keyed by (class, field) — the same information, without rebuilding
classes — which the visualization layer reads to build widgets and which is a
no-op for headless use.
"""

from __future__ import annotations

from typing import Any, Callable

# (class qualname, field) -> dict(min, max, step, bounded)
_SLIDER_METADATA: dict[tuple[str, str], dict[str, Any]] = {}


def slider(
    field_name: str,
    min_value: float,
    max_value: float,
    step: float | None = None,
    bounded: bool = False,
) -> Callable[[type], type]:
    """Attach slider bounds to a config dataclass field."""

    def wrap(cls: type) -> type:
        _SLIDER_METADATA[(cls.__qualname__, field_name)] = {
            "min": min_value,
            "max": max_value,
            "step": step,
            "bounded": bounded,
        }
        return cls

    return wrap


def get_slider_metadata(cls: type, field_name: str) -> dict[str, Any] | None:
    """Look up slider metadata along the MRO."""
    for klass in cls.__mro__:
        meta = _SLIDER_METADATA.get((klass.__qualname__, field_name))
        if meta is not None:
            return meta
    return None
