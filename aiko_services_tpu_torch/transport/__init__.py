"""Message transports of the port: the loopback broker only.

The JAX package's ``transport/__init__.py`` also builds MQTT clients
(paho) and carries its own MQTT broker; neither machine the port runs on
has paho, so the port leaves MQTT out (``ROADMAP.md``) and
:func:`create_message` raises for it by name.
"""

from .loopback import (LoopbackBroker, LoopbackMessage, get_broker,
                       reset_brokers)
from .message import Message, NullMessage, topic_matcher

__all__ = ["LoopbackBroker", "LoopbackMessage", "Message", "NullMessage",
           "create_message", "get_broker", "reset_brokers",
           "topic_matcher"]


def create_message(transport: str, **kwargs) -> Message:
    """Transport factory keyed by the service's ``transport`` field:
    ``"loopback"`` (or ``"memory"``) is the in-process broker; any other
    name raises."""
    if transport in ("loopback", "memory"):
        kwargs.pop("host", None)
        kwargs.pop("port", None)
        return LoopbackMessage(**kwargs)
    raise NotImplementedError(
        f"transport {transport!r} is not ported: the port has the loopback "
        "broker only (the MQTT transport needs paho, which is not "
        "installed)")
