"""Abstract message transport.

The port's copy of ``aiko_services_tpu/transport/message.py`` (it has no
JAX in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/message/
message.py:11-46``.  The seam that makes every distributed component
testable in-process: implementations are ``Loopback`` (in-memory broker,
default — MQTT semantics without a broker), ``MQTT`` (paho, gated on the
package being installed), and ``Null`` (offline mode, the reference's
"Castaway").

Topic wildcard rules are MQTT's: ``+`` matches one level, ``#`` (final
level only) matches any remainder.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Iterable, Optional, Union

__all__ = ["Message", "NullMessage", "topic_matcher"]


def topic_matcher(pattern: str, topic: str) -> bool:
    """MQTT topic matching with ``+`` and ``#`` wildcards
    (reference: ``main/process.py:344-360``).  The JAX package also
    dispatches to a C matcher when one is built; the port keeps the
    Python definition only."""
    if pattern == topic:
        return True
    p_levels = pattern.split("/")
    t_levels = topic.split("/")
    for i, p in enumerate(p_levels):
        if p == "#":
            return i == len(p_levels) - 1
        if i >= len(t_levels):
            return False
        if p != "+" and p != t_levels[i]:
            return False
    return len(p_levels) == len(t_levels)


class Message(ABC):
    """Transport contract.

    ``message_handler(topic, payload)`` is called for every delivery;
    ``payload`` is ``str`` for text topics and ``bytes`` for binary topics
    (topics registered via ``subscribe(..., binary=True)``).
    """

    @property
    @abstractmethod
    def connected(self) -> bool: ...

    @abstractmethod
    def publish(self, topic: str, payload: Union[str, bytes],
                retain: bool = False, wait: bool = False): ...

    @abstractmethod
    def subscribe(self, topic: Union[str, Iterable[str]],
                  binary: bool = False): ...

    @abstractmethod
    def unsubscribe(self, topic: Union[str, Iterable[str]]): ...

    @abstractmethod
    def set_last_will_and_testament(
            self, topic: Optional[str] = None,
            payload: Union[str, bytes, None] = None,
            retain: bool = False): ...

    def add_last_will_and_testament(self, topic: str,
                                    payload: Union[str, bytes],
                                    retain: bool = False):
        """Arm an *additional* will.  Loopback supports many wills per
        client; single-will transports (MQTT) fall back to replacement —
        callers needing both a liveness and an election will should prefer
        a dedicated client there."""
        self.set_last_will_and_testament(topic, payload, retain)

    def remove_last_will_and_testament(self, topic: str):
        self.set_last_will_and_testament(None)

    @abstractmethod
    def disconnect(self, graceful: bool = True): ...


class NullMessage(Message):
    """No-op transport for broker-less operation (reference "Castaway",
    ``main/message/castaway.py:9-44``)."""

    def __init__(self, message_handler: Optional[Callable] = None,
                 topics: Optional[Iterable[str]] = None, **_ignored):
        self.message_handler = message_handler

    @property
    def connected(self) -> bool:
        return False

    def publish(self, topic, payload, retain=False, wait=False):
        pass

    def subscribe(self, topic, binary=False):
        pass

    def unsubscribe(self, topic):
        pass

    def set_last_will_and_testament(self, topic=None, payload=None,
                                    retain=False):
        pass

    def disconnect(self, graceful=True):
        pass
