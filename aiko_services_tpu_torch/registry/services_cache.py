"""ServicesCache: a live local mirror of the Registrar directory.

The port's copy of ``aiko_services_tpu/registry/services_cache.py`` (it
has no JAX in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/share.py:
477-649``.  On REGISTRAR connection it requests a directory snapshot
(``(share …)`` query) and subscribes the registrar's ``…/out`` for live
``(add …)`` / ``(remove …)`` events; filter-keyed handlers fire as
matching services appear/disappear — the discovery mechanism behind
remote pipeline elements and the dashboard.  States: ``empty`` →
``loaded`` (snapshot synced) with live updates thereafter; a registrar
failover resets to ``empty`` and re-syncs against the new primary.

Unlike the reference (which spins a dedicated event-loop thread,
share.py:641-649) the cache runs on its process's own event engine.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Tuple

from ..utils.logger import get_logger
from ..utils.sexpr import SExprError, generate, parse
from ..runtime.connection import ConnectionState
from ..runtime.service import ServiceFields, ServiceFilter, Services

__all__ = ["ServicesCache", "services_cache_create_singleton"]

_logger = get_logger(__name__)


class ServicesCache:
    _ids = itertools.count(1)

    def __init__(self, process):
        self.process = process
        self.services = Services()
        self.state = "empty"
        self._handlers: List[Tuple[ServiceFilter, Callable, Callable]] = []
        self._registrar_topic: Optional[str] = None
        self.response_topic = (
            f"{process.topic_path_process}/0/cache/{next(self._ids)}")
        process.add_message_handler(self._response_handler,
                                    self.response_topic)
        process.connection.add_handler(self._connection_handler)

    # -- discovery handlers --------------------------------------------------- #

    def add_handler(self, service_filter: ServiceFilter,
                    add_handler: Callable,
                    remove_handler: Optional[Callable] = None):
        """``add_handler(fields)`` for every current and future match."""
        self._handlers.append((service_filter, add_handler,
                               remove_handler or (lambda fields: None)))
        for fields in self.services.filter(service_filter):
            add_handler(fields)

    def remove_handler(self, add_handler: Callable):
        self._handlers = [h for h in self._handlers if h[1] != add_handler]

    # -- registrar connection -------------------------------------------------- #

    def _connection_handler(self, connection, state):
        if state >= ConnectionState.REGISTRAR and self.process.registrar:
            registrar_topic = self.process.registrar["topic_path"]
            if registrar_topic != self._registrar_topic:
                if self._registrar_topic:
                    # Registrar identity changed (failover/split-brain
                    # resolution): drop the old mirror before re-syncing.
                    self._detach_registrar()
                self._registrar_topic = registrar_topic
                self._resync()
        elif state < ConnectionState.REGISTRAR and self._registrar_topic:
            self._detach_registrar()

    def _resync(self):
        self.state = "empty"
        self.process.add_message_handler(self._event_handler,
                                         f"{self._registrar_topic}/out")
        self.process.message.publish(
            f"{self._registrar_topic}/in",
            generate("share", [self.response_topic]))

    def _detach_registrar(self):
        if self._registrar_topic:
            self.process.remove_message_handler(
                self._event_handler, f"{self._registrar_topic}/out")
        self._registrar_topic = None
        self.state = "empty"
        for fields in list(self.services):
            self._dispatch_remove(fields)
        self.services = Services()

    # -- wire ------------------------------------------------------------------- #

    def _parse_fields(self, parameters) -> Optional[ServiceFields]:
        if len(parameters) < 5:
            return None
        tags = parameters[5] if len(parameters) > 5 else []
        return ServiceFields(
            parameters[0], parameters[1],
            None if parameters[2] == "*" else parameters[2],
            parameters[3],
            None if parameters[4] == "*" else parameters[4],
            list(tags) if isinstance(tags, list) else [tags])

    def _response_handler(self, topic: str, payload: str):
        """Snapshot replies from the (share …) query."""
        try:
            command, parameters = parse(payload)
        except SExprError:
            return
        if command == "add":
            fields = self._parse_fields(parameters)
            if fields:
                self._add_service(fields)
        elif command == "sync":
            self.state = "loaded"
        # item_count is informational

    def _event_handler(self, topic: str, payload: str):
        """Live add/remove events from the registrar's out topic."""
        try:
            command, parameters = parse(payload)
        except SExprError:
            return
        if command == "add":
            fields = self._parse_fields(parameters)
            if fields:
                self._add_service(fields)
        elif command == "remove" and parameters:
            fields = self.services.remove(parameters[0])
            if fields:
                self._dispatch_remove(fields)

    def _add_service(self, fields: ServiceFields):
        known = self.services.get(fields.topic_path)
        self.services.add(fields)
        if known is None:
            for service_filter, add_cb, _ in list(self._handlers):
                if service_filter.matches(fields):
                    add_cb(fields)

    def _dispatch_remove(self, fields: ServiceFields):
        for service_filter, _, remove_cb in list(self._handlers):
            if service_filter.matches(fields):
                remove_cb(fields)

    def terminate(self):
        self.process.connection.remove_handler(self._connection_handler)
        self.process.remove_message_handler(self._response_handler,
                                            self.response_topic)
        if self._registrar_topic:
            self.process.remove_message_handler(
                self._event_handler, f"{self._registrar_topic}/out")


def services_cache_create_singleton(process) -> ServicesCache:
    """One cache per process (reference share.py:641-649).  Stored on the
    process object itself so its lifetime tracks the process (no global
    id()-keyed map to leak or collide)."""
    cache = getattr(process, "_services_cache_singleton", None)
    if cache is None:
        cache = ServicesCache(process)
        process._services_cache_singleton = cache
    return cache
