"""Custom-optimizer registration demo: a subclass of CEM with one extra
config field (a user optimizer overrides ``sample`` and ``update``, or just
the config)."""

from __future__ import annotations

from dataclasses import dataclass

from judo_tpu_torch.optimizers.cem import CrossEntropyMethod, CrossEntropyMethodConfig


@dataclass
class MyCrossEntropyMethodConfig(CrossEntropyMethodConfig):
    """CEM config with one extra user parameter."""

    my_custom_param: int = 42


class MyCrossEntropyMethod(CrossEntropyMethod):
    """CEM variant demonstrating subclass registration."""
