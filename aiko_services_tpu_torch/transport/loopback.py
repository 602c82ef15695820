"""In-memory broker with MQTT semantics.

The port's copy of ``aiko_services_tpu/transport/loopback.py`` (it has
no JAX in it); its imports point at the port's own modules.

The default control-plane transport (no MQTT client library ships in this
image) and the test seam SURVEY.md §4 calls for: every distributed protocol
— registrar election, EC shares, remote pipeline elements — runs unmodified
against this broker inside one OS process.  Implements the three broker
features the framework's protocols rely on:

* **Wildcards** ``+`` / ``#`` on subscription patterns.
* **Retained messages** — last retained payload per topic is stored and
  replayed to new subscribers (registrar ``(primary found …)`` discovery);
  publishing an empty retained payload clears it (``system_reset``).
* **Last-will-and-testament** — a client's LWT fires when it disconnects
  ungracefully (process-death ``(absent)`` liveness signal).

Brokers are named so tests can isolate universes; ``LoopbackMessage``
clients attach to a broker by name.  Delivery is synchronous into the
client's ``message_handler`` — clients queue into their event engine, as
the process runtime does, so re-entrancy mirrors the paho-thread model.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

from .message import Message, topic_matcher

__all__ = ["LoopbackBroker", "LoopbackMessage", "get_broker", "reset_brokers"]

_brokers: Dict[str, "LoopbackBroker"] = {}
_brokers_lock = threading.Lock()


def get_broker(name: str = "default") -> "LoopbackBroker":
    with _brokers_lock:
        if name not in _brokers:
            _brokers[name] = LoopbackBroker(name)
        return _brokers[name]


def reset_brokers():
    """Drop all brokers (test isolation)."""
    with _brokers_lock:
        _brokers.clear()


class LoopbackBroker:
    def __init__(self, name: str = "default"):
        self.name = name
        self._lock = threading.RLock()
        self._clients: List["LoopbackMessage"] = []
        self._retained: Dict[str, Union[str, bytes]] = {}

    # -- client management ------------------------------------------------- #

    def attach(self, client: "LoopbackMessage"):
        with self._lock:
            self._clients.append(client)

    def detach(self, client: "LoopbackMessage", graceful: bool):
        wills: List[Tuple[str, Union[str, bytes], bool]] = []
        with self._lock:
            if client in self._clients:
                self._clients.remove(client)
                if not graceful:
                    wills = list(client._wills)
        for topic, payload, retain in wills:
            self.publish(topic, payload, retain)

    # -- pub/sub ----------------------------------------------------------- #

    def publish(self, topic: str, payload: Union[str, bytes],
                retain: bool = False):
        if retain:
            with self._lock:
                if payload == "" or payload == b"":
                    self._retained.pop(topic, None)
                else:
                    self._retained[topic] = payload
        with self._lock:
            clients = list(self._clients)
        for client in clients:
            client._deliver(topic, payload)

    def replay_retained(self, client: "LoopbackMessage", pattern: str):
        with self._lock:
            matches = [(t, p) for t, p in self._retained.items()
                       if topic_matcher(pattern, t)]
        for topic, payload in matches:
            client._deliver(topic, payload)

    def retained(self, topic: str):
        with self._lock:
            return self._retained.get(topic)

    def clear_retained(self, topic: Optional[str] = None):
        with self._lock:
            if topic is None:
                self._retained.clear()
            else:
                self._retained.pop(topic, None)


class LoopbackMessage(Message):
    def __init__(self, message_handler: Optional[Callable] = None,
                 topics: Optional[Iterable[str]] = None,
                 lwt_topic: Optional[str] = None,
                 lwt_payload: Union[str, bytes, None] = None,
                 lwt_retain: bool = False,
                 broker: Union[str, LoopbackBroker] = "default"):
        self.message_handler = message_handler
        self.connection_handler = None  # optional: called with (connected)
        self._broker = (broker if isinstance(broker, LoopbackBroker)
                        else get_broker(broker))
        # Routing index: exact topics (no wildcard) hit a dict lookup;
        # only wildcard patterns scan — _deliver runs once per client
        # per published message, the control plane's hottest path
        # (profiled: ~1,000 matcher calls per pipeline frame without
        # the split).  The two dicts together ARE the subscription
        # set; there is deliberately no third combined mapping to
        # keep in sync.
        self._exact: Dict[str, bool] = {}
        self._wildcards: Dict[str, bool] = {}
        self._wills: List[Tuple[str, Union[str, bytes], bool]] = []
        self._connected = False
        if lwt_topic is not None:
            self._wills.append((lwt_topic, lwt_payload, lwt_retain))
        self._broker.attach(self)
        self._connected = True
        if topics:
            self.subscribe(topics)

    # -- Message API ------------------------------------------------------- #

    @property
    def connected(self) -> bool:
        return self._connected

    def publish(self, topic, payload, retain=False, wait=False):
        if not self._connected:
            return
        self._broker.publish(topic, payload, retain)

    def subscribe(self, topic, binary=False):
        patterns = [topic] if isinstance(topic, str) else list(topic)
        for pattern in patterns:
            if "+" in pattern or "#" in pattern:
                self._wildcards[pattern] = binary
            else:
                self._exact[pattern] = binary
            self._broker.replay_retained(self, pattern)

    def unsubscribe(self, topic):
        patterns = [topic] if isinstance(topic, str) else list(topic)
        for pattern in patterns:
            self._exact.pop(pattern, None)
            self._wildcards.pop(pattern, None)

    def set_last_will_and_testament(self, topic=None, payload=None,
                                    retain=False):
        # Unlike paho (which requires a disconnect/reconnect cycle,
        # reference mqtt.py:192-201), the loopback broker updates in place.
        # Replace-all semantics for MQTT parity.
        self._wills = [] if topic is None else [(topic, payload, retain)]

    def add_last_will_and_testament(self, topic, payload, retain=False):
        self._wills = [w for w in self._wills if w[0] != topic]
        self._wills.append((topic, payload, retain))

    def remove_last_will_and_testament(self, topic):
        self._wills = [w for w in self._wills if w[0] != topic]

    def disconnect(self, graceful=True):
        if not self._connected:
            return
        self._connected = False
        self._broker.detach(self, graceful)

    # -- delivery ---------------------------------------------------------- #

    def _deliver(self, topic: str, payload: Union[str, bytes]):
        if not self._connected or self.message_handler is None:
            return
        binary = self._exact.get(topic)
        if binary is None:
            # Snapshot: a concurrent subscribe from another thread must
            # not raise dictionary-changed-size mid-delivery (this
            # client class is deliberately lock-free).
            for pattern, wildcard_binary in list(self._wildcards.items()):
                if topic_matcher(pattern, topic):
                    binary = wildcard_binary
                    break
            else:
                return
        if binary:
            data = (payload.encode() if isinstance(payload, str)
                    else payload)
        else:
            data = (payload.decode(errors="replace")
                    if isinstance(payload, bytes) else payload)
        self.message_handler(topic, data)
