"""Process runtime: owns the transport, the event engine, and N Services.

The port's copy of ``aiko_services_tpu/runtime/process.py`` (it has no
JAX in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/process.py:
76-365``.  Key behaviors carried over:

* Topic scheme ``namespace/hostname/pid/service_id`` with the process
  itself as service 0; LWT ``(absent)`` on ``{process_path}/0/state`` is
  the liveness signal the Registrar watches.
* Every inbound transport message is queued onto the event engine
  ("message" queue) so all application code runs on the event-loop thread.
* Registrar bootstrap: subscribes ``{namespace}/service/registrar``; on
  retained ``(primary found topic_path version timestamp)`` it promotes the
  connection to REGISTRAR and (re)announces every Service with
  ``(add topic_path name protocol transport owner (tags…))``; on
  ``(primary absent)`` it drops back to TRANSPORT.

Deviation by design: ``Process`` is *instantiable* — each instance owns its
own event engine and transport client — so multi-process distributed
scenarios (election, failover, remote pipelines) are testable inside one
OS process over the loopback broker.  ``default_process()`` provides the
reference's ``aiko`` singleton behavior.
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.config import (
    get_default_transport, get_hostname, get_namespace, get_pid,
)
from ..utils.logger import get_logger
from ..utils.sexpr import generate, parse
from ..transport import create_message
from ..transport.message import Message, topic_matcher
from .connection import Connection, ConnectionState
from .event import EventEngine, event as default_engine
from . import faults

__all__ = ["Process", "default_process", "set_default_process",
           "SERVICE_REGISTRAR_TOPIC_SUFFIX"]

SERVICE_REGISTRAR_TOPIC_SUFFIX = "service/registrar"

_logger = get_logger(__name__)
_test_pid_counter = itertools.count(1)

# Processes per engine: an engine shared by several in-process "processes"
# (distributed tests) must only stop when the last one terminates.
_engine_refs: Dict[int, int] = {}
_engine_refs_lock = threading.Lock()


class Process:
    def __init__(self, namespace: Optional[str] = None,
                 hostname: Optional[str] = None,
                 pid: Optional[str] = None,
                 engine: Optional[EventEngine] = None,
                 transport: Optional[str] = None,
                 message: Optional[Message] = None,
                 broker: str = "default"):
        self.namespace = namespace or get_namespace()
        self.hostname = hostname or get_hostname()
        self.pid = pid or get_pid()
        self.event = engine or default_engine
        with _engine_refs_lock:
            _engine_refs[id(self.event)] = \
                _engine_refs.get(id(self.event), 0) + 1
        self.connection = Connection()
        self.services: Dict[int, object] = {}       # sid -> Service
        self._service_counter = itertools.count(1)
        self._message_handlers: Dict[str, List[Callable]] = {}
        # Dispatch index over _message_handlers: exact topics vs
        # wildcard patterns (see add_message_handler).  Values alias
        # the same handler lists.
        self._exact_handlers: Dict[str, List[Callable]] = {}
        self._wildcard_handlers: Dict[str, List[Callable]] = {}
        self.registrar: Optional[dict] = None       # {topic_path, version}
        self._lock = threading.RLock()

        self.topic_path_process = (
            f"{self.namespace}/{self.hostname}/{self.pid}")
        self.topic_state = f"{self.topic_path_process}/0/state"
        self.topic_registrar_boot = (
            f"{self.namespace}/{SERVICE_REGISTRAR_TOPIC_SUFFIX}")

        # Queue name is per-process: multiple Processes may share one event
        # engine (in-process distributed tests), each with its own inbound
        # message queue.
        self._message_queue = f"message/{self.topic_path_process}/{id(self)}"
        self.event.add_queue_handler(self._message_queue_handler,
                                     self._message_queue)
        if message is not None:
            self.message = message
            self.message.message_handler = self._on_message
        else:
            transport = transport or get_default_transport()
            self.message = create_message(
                transport,
                message_handler=self._on_message,
                lwt_topic=self.topic_state,
                lwt_payload="(absent)",
                **({"broker": broker} if transport
                   in ("loopback", "memory") else {}))
        # Async transports (MQTT) report connection completion via the
        # connection_handler callback; loopback is connected immediately.
        self.message.connection_handler = self._transport_state_changed
        if self.message.connected:
            self.connection.update(ConnectionState.TRANSPORT)
        self.add_message_handler(self._registrar_handler,
                                 self.topic_registrar_boot)

    def _transport_state_changed(self, connected: bool):
        if connected:
            if self.connection.state < ConnectionState.TRANSPORT:
                self.connection.update(ConnectionState.TRANSPORT)
        else:
            self.connection.update(ConnectionState.NONE)

    # -- topics ------------------------------------------------------------ #

    def service_topic_path(self, service_id) -> str:
        return f"{self.topic_path_process}/{service_id}"

    # -- services ---------------------------------------------------------- #

    def add_service(self, service):
        with self._lock:
            service_id = next(self._service_counter)
            service.service_id = service_id
            service.topic_path = self.service_topic_path(service_id)
            self.services[service_id] = service
        if self.registrar:
            self._announce_service(service, add=True)

    def remove_service(self, service):
        with self._lock:
            self.services.pop(service.service_id, None)
        if self.registrar:
            self._announce_service(service, add=False)

    def _announce_service(self, service, add: bool):
        registrar_topic_in = f"{self.registrar['topic_path']}/in"
        if add:
            fields = service.service_fields()
            payload = generate("add", [
                fields.topic_path, fields.name, fields.protocol or "*",
                fields.transport, fields.owner or "*", fields.tags])
        else:
            payload = generate("remove", [service.topic_path])
        self.message.publish(registrar_topic_in, payload)

    # -- message plumbing --------------------------------------------------- #

    def add_message_handler(self, handler: Callable, topic: str,
                            binary: bool = False):
        with self._lock:
            first = topic not in self._message_handlers
            self._message_handlers.setdefault(topic, []).append(handler)
            # Dispatch index: exact topics hit a dict lookup; only
            # wildcard patterns scan.  Dispatch runs once per inbound
            # message, and a process hosting thousands of services
            # (reference scale goal, main/process.py:45-48) registers
            # thousands of exact topics — a linear matcher scan made
            # RPC dispatch O(services) per message.
            if "+" in topic or "#" in topic:
                self._wildcard_handlers[topic] = \
                    self._message_handlers[topic]
            else:
                self._exact_handlers[topic] = \
                    self._message_handlers[topic]
        if first:
            # The transport owns binary-vs-text delivery per
            # subscription; no process-side bookkeeping needed.
            self.message.subscribe(topic, binary=binary)

    def remove_message_handler(self, handler: Callable, topic: str):
        with self._lock:
            handlers = self._message_handlers.get(topic, [])
            if handler in handlers:
                handlers.remove(handler)
            if not handlers:
                self._message_handlers.pop(topic, None)
                self._exact_handlers.pop(topic, None)
                self._wildcard_handlers.pop(topic, None)
                self.message.unsubscribe(topic)

    def _on_message(self, topic: str, payload):
        """Transport thread → event queue."""
        if faults.PLAN is not None:
            # Key: topic + payload head, so a plan can target e.g. all
            # infer_partial traffic or one replica's /in topic.
            head = payload[:64] if isinstance(payload, str) else ""
            key = f"{topic} {head}"
            if faults.PLAN.check("drop_message", key=key) is not None:
                return
            delay = faults.PLAN.check("delay_message", key=key)
            if delay is not None:
                # Wall-clock delay (not VirtualClock-driven): reorders
                # delivery under a real engine only.
                timer = threading.Timer(
                    float(delay.get("ms", 10.0)) / 1e3,
                    lambda: self.event.queue_put(
                        (topic, payload), self._message_queue))
                timer.daemon = True
                timer.start()
                return
        self.event.queue_put((topic, payload), self._message_queue)

    def _message_queue_handler(self, item: Tuple[str, object]):
        topic, payload = item
        with self._lock:
            matches = list(self._exact_handlers.get(topic, ()))
            for pattern, handlers in self._wildcard_handlers.items():
                if topic_matcher(pattern, topic):
                    matches.extend(handlers)
        for handler in matches:
            try:
                handler(topic, payload)
            except Exception:  # noqa: BLE001 - a bad handler must not
                _logger.exception(  # kill the event loop
                    "Message handler error on topic %s", topic)

    # -- registrar bootstrap ------------------------------------------------ #

    def _registrar_handler(self, topic: str, payload: str):
        try:
            command, parameters = parse(payload)
        except Exception:
            return
        if command == "primary" and parameters:
            action = parameters[0]
            if action == "found" and len(parameters) >= 2:
                previous = (self.registrar or {}).get("topic_path")
                self.registrar = {
                    "topic_path": parameters[1],
                    "version": parameters[2] if len(parameters) > 2 else "0",
                }
                if self.connection.state >= ConnectionState.REGISTRAR:
                    if previous != parameters[1]:
                        # Registrar identity changed without a state change
                        # (split-brain resolution): re-notify watchers.
                        self.connection.notify()
                else:
                    self.connection.update(ConnectionState.REGISTRAR)
                with self._lock:
                    services = list(self.services.values())
                for service in services:
                    self._announce_service(service, add=True)
                    service.registrar_changed(
                        self.registrar["topic_path"], True)
            elif action == "absent":
                self.registrar = None
                if self.message.connected:
                    self.connection.update(ConnectionState.TRANSPORT)
                else:
                    self.connection.update(ConnectionState.NONE)
                with self._lock:
                    services = list(self.services.values())
                for service in services:
                    service.registrar_changed(None, False)

    # -- lifecycle ---------------------------------------------------------- #

    def run(self, in_thread: bool = False):
        if in_thread:
            return self.event.run_in_thread()
        self.event.loop()
        return None

    def terminate(self, graceful: bool = True):
        self.message.disconnect(graceful=graceful)
        self.event.remove_queue_handler(self._message_queue)
        with _engine_refs_lock:
            key = id(self.event)
            _engine_refs[key] = _engine_refs.get(key, 1) - 1
            last = _engine_refs[key] <= 0
            if last:
                _engine_refs.pop(key, None)
        if last:
            self.event.terminate()

    def kill(self):
        """Simulate process death: LWT fires (tests / fault injection)."""
        self.terminate(graceful=False)


_default_process: Optional[Process] = None
_default_lock = threading.Lock()


def default_process() -> Process:
    global _default_process
    with _default_lock:
        if _default_process is None:
            _default_process = Process()
        return _default_process


def set_default_process(process: Optional[Process]):
    global _default_process
    with _default_lock:
        _default_process = process
