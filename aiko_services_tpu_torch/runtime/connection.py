"""Connection state ladder.

The port's copy of ``aiko_services_tpu/runtime/connection.py`` (it has
no JAX in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/connection.py:
12-46``.  Ordered states NONE → NETWORK → TRANSPORT → REGISTRAR with
"at least" semantics: ``is_connected(REGISTRAR)`` implies all lower rungs.
Handlers fire on every state change.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Callable, List

__all__ = ["ConnectionState", "Connection"]


class ConnectionState(IntEnum):
    NONE = 0
    NETWORK = 1
    TRANSPORT = 2
    REGISTRAR = 3


class Connection:
    def __init__(self):
        self._state = ConnectionState.NONE
        self._handlers: List[Callable] = []

    @property
    def state(self) -> ConnectionState:
        return self._state

    def add_handler(self, handler: Callable):
        self._handlers.append(handler)
        handler(self, self._state)

    def remove_handler(self, handler: Callable):
        if handler in self._handlers:
            self._handlers.remove(handler)

    def is_connected(self, state: ConnectionState) -> bool:
        return self._state >= state

    def update(self, state: ConnectionState):
        if state == self._state:
            return
        self._state = state
        for handler in list(self._handlers):
            handler(self, state)

    def notify(self):
        """Re-fire handlers without a state change (e.g. the registrar
        identity changed while the rung stayed REGISTRAR)."""
        for handler in list(self._handlers):
            handler(self, self._state)
