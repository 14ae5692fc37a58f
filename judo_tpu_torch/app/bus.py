"""In-process message bus with latest-wins topics (the port's copy of
``judo_tpu/app/bus.py``).

The simulation loop and the controller loop run as threads of one process,
as in the JAX package; each topic is a thread-safe single-slot mailbox, the
contract of the reference's queue_size=1 dataflow topics.
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class Topic:
    """Single-slot (latest-wins) mailbox."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value: Any = None
        self._seq = 0

    def publish(self, value: Any) -> None:
        with self._lock:
            self._value = value
            self._seq += 1

    def read(self) -> tuple[Any, int]:
        with self._lock:
            return self._value, self._seq


class MessageBus:
    """Named topics + optional synchronous subscribers."""

    def __init__(self) -> None:
        self._topics: dict[str, Topic] = {}
        self._subs: dict[str, list[Callable[[Any], None]]] = {}
        self._lock = threading.Lock()

    def topic(self, name: str) -> Topic:
        with self._lock:
            if name not in self._topics:
                self._topics[name] = Topic()
            return self._topics[name]

    def publish(self, name: str, value: Any) -> None:
        self.topic(name).publish(value)
        for cb in self._subs.get(name, []):
            cb(value)

    def subscribe(self, name: str, callback: Callable[[Any], None]) -> None:
        with self._lock:
            self._subs.setdefault(name, []).append(callback)

    def read(self, name: str) -> Any:
        return self.topic(name).read()[0]

    def read_versioned(self, name: str) -> tuple[Any, int]:
        return self.topic(name).read()
