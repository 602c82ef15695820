"""Registrar: the service directory with primary/secondary failover.

The port's copy of ``aiko_services_tpu/registry/registrar.py`` (it has no
JAX in it); its imports point at the port's own modules, and it runs on
the port's actor runtime and loopback broker.

Reference parity: upstream aiko_services ``main/registrar.py:
136-357``.  Election protocol on the retained boot topic
``{namespace}/service/registrar``:

* On start, a registrar enters *primary_search* and waits
  ``PRIMARY_SEARCH_TIMEOUT`` (2 s, reference registrar.py:130).  If a
  retained ``(primary found topic_path version timestamp)`` arrives first
  it becomes *secondary*; otherwise it self-promotes: clears any stale
  retained message, arms a last-will ``(primary absent)`` (retained) and
  publishes retained ``(primary found …)``.
* Secondaries watch for ``(primary absent)`` and re-run the election with
  a per-instance jittered delay derived from their topic path — addressing
  the reference's documented multi-secondary split-brain bug
  (registrar.py:54-55) by making simultaneous promotion unlikely and
  deterministic per process.

Directory protocol on the registrar's ``…/in`` topic:
``(add topic_path name protocol transport owner (tags…))``,
``(remove topic_path)``,
``(share response_topic filter…)`` query → ``(item_count N)`` +
N × ``(add …)`` + ``(sync)`` on the response topic,
``(history count)`` → removed-service history ring (4096 entries).
Live events are re-published on ``…/out``.  Liveness: subscribes
``{namespace}/+/+/+/state``; an ``(absent)`` LWT evicts every service of
the dead process.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from ..utils.logger import get_logger
from ..utils.sexpr import SExprError, generate, parse
from ..utils.state_machine import StateMachine
from ..runtime.actor import Actor
from ..runtime.context import actor_args
from ..runtime.service import ServiceFields, ServiceFilter, Services

__all__ = ["Registrar", "REGISTRAR_PROTOCOL", "PRIMARY_SEARCH_TIMEOUT"]

REGISTRAR_PROTOCOL = "registrar:2"
PRIMARY_SEARCH_TIMEOUT = 2.0   # reference registrar.py:130
HISTORY_RING_SIZE = 4096       # reference registrar.py:129

_logger = get_logger(__name__)

_STATES = ["start", "primary_search", "secondary", "primary"]
_TRANSITIONS = [
    {"source": "start", "trigger": "initialize", "dest": "primary_search"},
    {"source": "primary_search", "trigger": "found", "dest": "secondary"},
    {"source": "primary_search", "trigger": "promote", "dest": "primary"},
    {"source": "secondary", "trigger": "promote", "dest": "primary"},
    {"source": "secondary", "trigger": "absent", "dest": "primary_search"},
    {"source": "primary", "trigger": "demote", "dest": "secondary"},
]


class Registrar(Actor):
    def __init__(self, context=None, process=None):
        context = context or actor_args("registrar",
                                        protocol=REGISTRAR_PROTOCOL)
        context.protocol = context.protocol or REGISTRAR_PROTOCOL
        super().__init__(context, process)
        self.services = Services()
        self.history: deque = deque(maxlen=HISTORY_RING_SIZE)
        self._command_handlers.update({
            "share": self.share_request,     # "share" attr is the EC dict
            "history": self.history_request,
        })
        self._machine = StateMachine(_STATES, "start", _TRANSITIONS, self)
        topic_boot = self.process.topic_registrar_boot
        self._topic_boot = topic_boot
        self.process.add_message_handler(self._boot_handler, topic_boot)
        self.process.add_message_handler(
            self._service_state_handler,
            f"{self.process.namespace}/+/+/+/state")
        self._machine.transition("initialize")
        # The process may already know the primary (bootstrap message
        # handled before this Registrar existed): defer to it immediately.
        if self.process.registrar and \
                self.process.registrar["topic_path"] != self.topic_path:
            self._machine.transition("found")

    # -- election ------------------------------------------------------------ #

    @property
    def state(self) -> str:
        return self._machine.state

    def _election_delay(self) -> float:
        """Deterministic per-instance jitter so simultaneous secondaries
        don't promote at once (split-brain mitigation)."""
        return PRIMARY_SEARCH_TIMEOUT + (
            hash(self.topic_path) % 1000) / 1000.0

    def on_enter_primary_search(self, _event):
        self.process.event.add_timer_handler(
            self._search_timeout, self._election_delay(), once=True)

    def _search_timeout(self):
        if self._machine.state == "primary_search":
            self._machine.transition("promote")

    def on_enter_secondary(self, _event):
        self.process.event.remove_timer_handler(self._search_timeout)
        _logger.info("%s: secondary registrar standing by", self.topic_path)

    def on_enter_primary(self, _event):
        # Clear any stale retained election message, arm an *additional*
        # last will (keeping the process liveness will intact), then claim
        # the primary slot with a retained announcement.
        message = self.process.message
        message.publish(self._topic_boot, "", retain=True)
        message.add_last_will_and_testament(
            self._topic_boot, "(primary absent)", retain=True)
        message.publish(
            self._topic_boot,
            generate("primary", ["found", self.topic_path, "2",
                                 str(time.time())]),
            retain=True)
        self.share["lifecycle"] = "primary"
        _logger.info("%s: primary registrar", self.topic_path)

    def _boot_handler(self, topic: str, payload: str):
        try:
            command, parameters = parse(payload)
        except SExprError:
            return
        if command != "primary" or not parameters:
            return
        action = parameters[0]
        if action == "found":
            found_topic = parameters[1] if len(parameters) > 1 else None
            if found_topic == self.topic_path or found_topic is None:
                return
            if self._machine.state == "primary_search":
                self._machine.transition("found")
            elif self._machine.state == "primary":
                # Dual-primary reconciliation (partition heal / races the
                # jitter didn't prevent): deterministic total order — the
                # lexicographically-smaller topic path keeps the crown.
                if self.topic_path < found_topic:
                    # I win: reassert my retained claim.
                    self.process.message.publish(
                        self._topic_boot,
                        generate("primary",
                                 ["found", self.topic_path, "2",
                                  str(time.time())]),
                        retain=True)
                else:
                    # I lose: disarm my election will and stand down.
                    self.process.message.remove_last_will_and_testament(
                        self._topic_boot)
                    self.share["lifecycle"] = "secondary"
                    self._machine.transition("demote")
        elif action == "absent":
            if self._machine.state == "secondary":
                self._machine.transition("absent")

    # -- directory ------------------------------------------------------------ #

    def _is_primary(self) -> bool:
        return self._machine.state == "primary"

    def add(self, topic_path, name, protocol=None, transport=None,
            owner=None, tags=None):
        if not self._is_primary():
            return
        fields = ServiceFields(
            str(topic_path), str(name),
            None if protocol in ("*", None) else str(protocol),
            str(transport or "loopback"),
            None if owner in ("*", None) else str(owner),
            [str(t) for t in (tags or [])])
        self.services.add(fields)
        self.publish_out("add", fields.as_list())

    def remove(self, topic_path):
        if not self._is_primary():
            return
        fields = self.services.remove(str(topic_path))
        if fields is not None:
            self.history.appendleft((fields, time.time()))
            self.publish_out("remove", [str(topic_path)])

    def share_request(self, response_topic, name="*", protocol="*",
                      transport="*", owner="*", tags="*"):
        """Directory query ``(share response_topic name protocol transport
        owner tags)``: reply with the matching services snapshot."""
        service_filter = ServiceFilter("*", name, protocol, transport,
                                       owner, tags)
        matches = self.services.filter(service_filter)
        publish = self.process.message.publish
        publish(str(response_topic),
                generate("item_count", [str(len(matches))]))
        for fields in matches:
            publish(str(response_topic), generate("add", fields.as_list()))
        publish(str(response_topic), generate("sync", [str(response_topic)]))

    def history_request(self, response_topic, count="10"):
        entries = list(self.history)[:int(count)]
        publish = self.process.message.publish
        publish(str(response_topic),
                generate("item_count", [str(len(entries))]))
        for fields, removed_at in entries:
            publish(str(response_topic),
                    generate("removed",
                             fields.as_list() + [str(removed_at)]))

    # -- liveness -------------------------------------------------------------- #

    def _service_state_handler(self, topic: str, payload: str):
        if not self._is_primary():
            return
        try:
            command, _ = parse(payload)
        except SExprError:
            return
        if command != "absent":
            return
        # topic: ns/host/pid/sid/state -> evict all services of the process.
        parts = topic.split("/")
        if len(parts) < 5:
            return
        process_path = "/".join(parts[:3])
        for fields in self.services.remove_process(process_path):
            self.history.appendleft((fields, time.time()))
            self.publish_out("remove", [fields.topic_path])

    # -- shutdown --------------------------------------------------------------- #

    def stop(self):
        if self._is_primary():
            # Graceful handover: disarm the election will and re-arm the
            # process liveness will (on single-will transports add_ had
            # replaced it), then tell everyone the primary is gone.
            self.process.message.remove_last_will_and_testament(
                self._topic_boot)
            self.process.message.set_last_will_and_testament(
                self.process.topic_state, "(absent)")
            self.process.message.publish(self._topic_boot, "", retain=True)
            self.process.message.publish(self._topic_boot,
                                         "(primary absent)")
        self.process.remove_message_handler(self._boot_handler,
                                            self._topic_boot)
        self.process.remove_message_handler(
            self._service_state_handler,
            f"{self.process.namespace}/+/+/+/state")
        super().stop()
