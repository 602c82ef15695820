"""Actor layer: Services with mailboxes and command dispatch.

The port's copy of ``aiko_services_tpu/runtime/actor.py`` (it has no JAX
in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/actor.py:
112-283``.  An Actor owns two event-engine mailboxes — CONTROL (priority)
and IN — fed by its ``…/control`` and ``…/in`` topics.  Inbound payloads
``(command arg…)`` are parsed and posted as :class:`ActorMessage`
envelopes; the mailbox handler dispatches via ``getattr`` to any public
method.  ``_post_message(…, delay=s)`` self-schedules (the retry-until-
discovered pattern pipelines use).

The EC share producer (``self.share`` / ``self.ec_producer``) is attached
by :class:`..registry.share.ECProducer` when available;
Actor works standalone without it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from ..utils.logger import get_logger
from ..utils.sexpr import SExprError, generate, parse
from .context import ServiceContext
from .service import Service

__all__ = ["Actor", "ActorMessage", "Mailbox"]

_logger = get_logger(__name__)


class Mailbox:
    CONTROL = "control"
    IN = "in"


class ActorMessage:
    """Command envelope dispatched on the event-loop thread."""

    __slots__ = ("command", "parameters")

    def __init__(self, command: str,
                 parameters: Union[List, Dict, None] = None):
        self.command = command
        self.parameters = parameters if parameters is not None else []

    def invoke(self, target) -> bool:
        if self.command.startswith("_"):
            _logger.warning("Refusing private command: %s", self.command)
            return False
        method = getattr(target, self.command, None)
        if not callable(method):
            _logger.warning("%s: unknown command: %s",
                            getattr(target, "name", target), self.command)
            return False
        if isinstance(self.parameters, dict):
            method(**self.parameters)
        else:
            method(*self.parameters)
        return True

    def __repr__(self):
        return f"ActorMessage({self.command}, {self.parameters})"


class Actor(Service):
    def __init__(self, context: ServiceContext, process=None):
        super().__init__(context, process)
        self.logger = get_logger(f"aiko.actor.{self.name}")
        self.share: Dict[str, Any] = {
            "lifecycle": "ready",
            "log_level": "INFO",
            "source_file": type(self).__module__,
        }
        self.ec_producer = None  # attached by ECProducer when created
        # Explicit wire-command handlers take precedence over getattr
        # dispatch — lets a command name coexist with an attribute
        # (e.g. the Registrar's "(share …)" query vs Actor.share dict).
        self._command_handlers: Dict[str, Any] = {}

        self._mailbox_control = f"{self.topic_path}/{Mailbox.CONTROL}"
        self._mailbox_in = f"{self.topic_path}/{Mailbox.IN}"
        engine = self.process.event
        engine.add_mailbox_handler(self._mailbox_handler,
                                   self._mailbox_control, priority=True)
        engine.add_mailbox_handler(self._mailbox_handler, self._mailbox_in)
        # Only topic_in feeds command dispatch (reference actor.py:221-227);
        # topic_control belongs to the EC share producer.  The CONTROL
        # mailbox is for internal priority posts (_post_message).
        self.process.add_message_handler(self._topic_in_handler,
                                         self.topic_in)
        from ..registry.share import ECProducer  # late: avoid import cycle
        self.ec_producer = ECProducer(self, self.share)

    # -- inbound ------------------------------------------------------------ #

    def _parse_payload(self, payload: str) -> Optional[ActorMessage]:
        try:
            command, parameters = parse(payload)
        except SExprError as error:
            _logger.warning("%s: bad payload %r: %s",
                            self.name, payload, error)
            return None
        if not command:
            return None
        return ActorMessage(command, parameters)

    def _topic_in_handler(self, topic: str, payload: str):
        message = self._parse_payload(payload)
        if message:
            self._post_message(Mailbox.IN, message)

    def _post_message(self, mailbox_name: str, message: ActorMessage,
                      delay: float = 0.0):
        target = (self._mailbox_control if mailbox_name == Mailbox.CONTROL
                  else self._mailbox_in)
        self.process.event.mailbox_put(target, message, delay=delay)

    def _mailbox_handler(self, mailbox_name: str, message: ActorMessage):
        try:
            handler = self._command_handlers.get(message.command)
            if handler is not None:
                if isinstance(message.parameters, dict):
                    handler(**message.parameters)
                else:
                    handler(*message.parameters)
            else:
                message.invoke(self)
        except Exception:  # noqa: BLE001 - a bad command must not kill loop
            _logger.exception("%s: command failed: %r", self.name, message)

    # -- outbound helpers --------------------------------------------------- #

    def publish_out(self, command: str, parameters=None):
        self.process.message.publish(self.topic_out,
                                     generate(command, parameters))

    # -- built-in commands (invocable remotely) ------------------------------ #

    def log_level(self, level: str):
        level = str(level).upper()
        if self.ec_producer is not None:
            self.ec_producer.update("log_level", level)  # echoes on state
        else:
            self.share["log_level"] = level
        self.logger.setLevel(level)

    def metrics(self, response_topic: str = ""):
        """Dump the process-wide metrics registry as Prometheus text:
        ``(metrics <response_topic>)`` → ``(metrics_response <name>
        <text>)`` on the response topic (or this actor's topic_out).
        Every actor answers — any service in the fleet is scrapeable
        over the wire without an HTTP port."""
        from ..obs.metrics import REGISTRY
        text = REGISTRY.to_prometheus()
        topic = str(response_topic) or self.topic_out
        self.process.message.publish(
            topic, generate("metrics_response", [self.name, text]))

    def capture(self, trace_id: str = "", response_topic: str = "",
                trigger: str = "operator", reason: str = ""):
        """Dump a flight-recorder capture bundle:
        ``(capture [trace_id] [response_topic])`` →
        ``(capture_response <name> <path|uninstalled|suppressed>)``.
        Every actor answers, so an operator (or the router's fleet
        fan-out) can ask any process to dump forensics around one
        shared trace id.  No recorder installed → reply says so;
        never an error."""
        from ..obs import flight
        if flight.FLIGHT is not None:
            path = flight.FLIGHT.capture(
                str(trigger) or "operator",
                trace_id=str(trace_id) or None,
                reason=str(reason) or f"(capture) on {self.name}")
            result = path or "suppressed"
        else:
            result = "uninstalled"
        if response_topic:
            self.process.message.publish(
                str(response_topic),
                generate("capture_response", [self.name, result]))

    def profile(self, steps: int = 4, trace_id: str = "",
                response_topic: str = "", reason: str = ""):
        """Request an on-demand device-profile bracket:
        ``(profile [steps] [trace_id] [response_topic] [reason])`` →
        ``(profile_response <name> <started|busy|unsupported>)``.
        Every actor answers; only actors carrying an engine with
        :meth:`request_profile` (ContinuousReplica) can actually run
        the bracket — others reply ``unsupported`` instead of
        dropping the command (the router's fleet fan-out expects one
        reply per process)."""
        server = getattr(self, "server", None)
        if server is None or not hasattr(server, "request_profile"):
            result = "unsupported"
        else:
            try:
                steps = max(1, int(steps))
            except (TypeError, ValueError):
                steps = 4
            started = server.request_profile(
                steps=steps, trace_id=str(trace_id),
                reason=str(reason) or f"(profile) on {self.name}")
            result = "started" if started else "busy"
        if response_topic:
            self.process.message.publish(
                str(response_topic),
                generate("profile_response", [self.name, result]))

    def census(self, trace_id: str = "", response_topic: str = "",
               reason: str = ""):
        """Dump a flight capture bundle on a census trigger:
        ``(census [trace_id] [response_topic] [reason])`` →
        ``(census_response <name>
        <path|uninstalled|suppressed|unsupported>)``.  Every actor
        answers, keeping the fleet fan-out one reply per process like
        ``(capture)``.  The port has no pool census yet
        (``obs/pool_audit.py``): an actor carrying an engine, whose
        bundle would hold its pool's census, answers ``unsupported``
        rather than a bundle without one; an actor with none (the
        router) still dumps its bundle.  No recorder installed → reply
        says so; never an error."""
        from ..obs import flight
        if getattr(self, "server", None) is not None:
            result = "unsupported"
        elif flight.FLIGHT is not None:
            path = flight.FLIGHT.capture(
                "census", trace_id=str(trace_id) or None,
                reason=str(reason) or f"(census) on {self.name}")
            result = path or "suppressed"
        else:
            result = "uninstalled"
        if response_topic:
            self.process.message.publish(
                str(response_topic),
                generate("census_response", [self.name, result]))

    def terminate(self):
        self.stop()

    def stop(self):
        engine = self.process.event
        engine.remove_mailbox_handler(self._mailbox_control)
        engine.remove_mailbox_handler(self._mailbox_in)
        self.process.remove_message_handler(self._topic_in_handler,
                                            self.topic_in)
        if self.ec_producer is not None:
            self.ec_producer.terminate()
        super().stop()

    def run(self, in_thread: bool = False):
        return self.process.run(in_thread=in_thread)
