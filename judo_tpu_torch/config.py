"""Overridable dataclass config system (the port's own copy of
``judo_tpu/config.py``, with its own registry).

Behavioral parity with the reference's config layer (judo/config.py:12-96):
- configs are plain dataclasses mixing in ``OverridableConfig``
- a global registry maps (config class, override key, field name) -> value
- ``set_override(key)`` applies every registered value for that key and, by
  default, resets all *unregistered* fields back to their dataclass defaults
  (honoring ``default_factory`` and comparing ndarrays element-wise)
- ``set_config_overrides`` registers values, warning on unknown fields.

The implementation here is original; only the observable semantics match.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import defaultdict
from typing import Any, Type

import numpy as np

# Global override registry: cls -> override key -> field name -> value.
_OVERRIDE_REGISTRY: dict[type, dict[str, dict[str, Any]]] = defaultdict(lambda: defaultdict(dict))


def get_override_registry() -> dict[type, dict[str, dict[str, Any]]]:
    """Expose the registry (used by tests and by the GUI layer)."""
    return _OVERRIDE_REGISTRY


def clear_override_registry() -> None:
    """Wipe all registered overrides (test isolation helper)."""
    _OVERRIDE_REGISTRY.clear()


def _field_default(f: dataclasses.Field) -> tuple[bool, Any]:
    """Return (has_default, default_value) for a dataclass field."""
    if f.default is not dataclasses.MISSING:
        return True, f.default
    if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
        return True, f.default_factory()  # type: ignore[misc]
    return False, None


def _values_equal(a: Any, b: Any) -> bool:
    """Equality that tolerates numpy arrays (reference: judo/config.py:44-52)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        try:
            return bool(np.array_equal(a, b))
        except Exception:
            return False
    try:
        return bool(a == b)
    except Exception:
        return False


class OverridableConfig:
    """Mixin giving dataclass configs keyed override support."""

    def set_override(self, key: str, reset_to_defaults: bool = True) -> None:
        """Apply the registered overrides for ``key`` to this instance.

        Fields without a registered override for this key are reset to their
        dataclass defaults when ``reset_to_defaults`` is True; fields with no
        default are left untouched.
        """
        cls_entries: dict[str, Any] = {}
        # Walk the MRO so overrides registered on a base class apply to subclasses.
        for klass in type(self).__mro__:
            if klass in _OVERRIDE_REGISTRY and key in _OVERRIDE_REGISTRY[klass]:
                for name, value in _OVERRIDE_REGISTRY[klass][key].items():
                    cls_entries.setdefault(name, value)

        for f in dataclasses.fields(self):  # type: ignore[arg-type]
            if f.name in cls_entries:
                setattr(self, f.name, cls_entries[f.name])
            elif reset_to_defaults:
                has_default, default = _field_default(f)
                if has_default and not _values_equal(getattr(self, f.name), default):
                    setattr(self, f.name, default)


def set_config_overrides(key: str, cls: Type, values: dict[str, Any]) -> None:
    """Register override ``values`` for ``cls`` under override ``key``.

    Unknown field names produce a warning and are skipped; non-dataclass
    classes are rejected (reference: judo/config.py:65-96).
    """
    if not dataclasses.is_dataclass(cls):
        raise ValueError(f"{cls} is not a dataclass; cannot register config overrides for it.")
    field_names = {f.name for f in dataclasses.fields(cls)}
    for name, value in values.items():
        if name not in field_names:
            warnings.warn(
                f"Ignoring override for unknown field '{name}' on {cls.__name__} (key '{key}').",
                stacklevel=2,
            )
            continue
        f = next(f for f in dataclasses.fields(cls) if f.name == name)
        has_default, _ = _field_default(f)
        if not has_default:
            warnings.warn(
                f"Field '{name}' on {cls.__name__} has no default; overrides may not reset cleanly.",
                stacklevel=2,
            )
        _OVERRIDE_REGISTRY[cls][key][name] = value
