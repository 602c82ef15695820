"""Remote actor proxies: RPC by reflection.

The port's copy of ``aiko_services_tpu/runtime/proxy.py`` (it has no JAX
in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/transport/
transport_mqtt.py:109-141``.  A proxy enumerates the public methods of an
interface class and synthesizes a stand-in whose calls serialize to
``(method arg…)`` S-expressions published to the target's ``…/in`` topic.
Fire-and-forget: responses, by convention, arrive as separate messages on
a caller-chosen response topic (see the Storage actor's request/response
idiom, reference ``main/storage.py:87-103``).
"""

from __future__ import annotations

import inspect
from typing import List, Type

from ..utils.sexpr import generate

__all__ = ["get_public_methods", "make_remote_proxy", "get_actor_proxy",
           "ProxyAllMethods", "proxy_trace"]


def get_public_methods(cls: Type) -> List[str]:
    methods = []
    for name, member in inspect.getmembers(cls):
        if name.startswith("_"):
            continue
        if inspect.isfunction(member) or inspect.ismethod(member):
            methods.append(name)
    return methods


class RemoteProxy:
    """Synthesized stand-in for an Actor living in another process."""

    def __init__(self, publish, topic_in: str, method_names: List[str]):
        self._publish = publish
        self._proxy_topic_in = topic_in
        for name in method_names:
            setattr(self, name, self._make_stub(name))

    def _make_stub(self, method_name: str):
        def stub(*args, **kwargs):
            parameters = list(args)
            if kwargs:
                if parameters:
                    raise TypeError(
                        "Remote calls take either positional or keyword "
                        "arguments, not both (wire format limitation)")
                parameters = kwargs
            self._publish(self._proxy_topic_in,
                          generate(method_name, parameters))
        stub.__name__ = method_name
        return stub

    def __repr__(self):
        return f"RemoteProxy({self._proxy_topic_in})"


def make_remote_proxy(publish, topic_in: str, cls: Type) -> RemoteProxy:
    return RemoteProxy(publish, topic_in, get_public_methods(cls))


def get_actor_proxy(topic_path: str, cls: Type, process) -> RemoteProxy:
    """Proxy for the actor at ``topic_path`` using the process transport
    (reference ``get_actor_mqtt``, transport_mqtt.py:138-141)."""
    topic_in = topic_path if topic_path.endswith("/in") \
        else f"{topic_path}/in"
    return make_remote_proxy(process.message.publish, topic_in, cls)


# --------------------------------------------------------------------------- #
# Local AOP interception (reference main/proxy.py:39-72)

class ProxyAllMethods:
    """Intercept every public method call on ``target``.

    Reference parity: ``main/proxy.py:39-62`` (wrapt.ObjectProxy based).
    Implemented with plain ``__getattr__`` delegation — no wrapt
    dependency.  ``hook(proxy_name, target, method_name, args, kwargs,
    call)`` decides whether/how to invoke ``call()`` (the bound method
    with arguments applied) and returns its result.
    """

    _PROXY_SLOTS = ("_proxy_name", "_proxy_target", "_proxy_hook")

    def __init__(self, proxy_name, target, hook):
        object.__setattr__(self, "_proxy_name", proxy_name)
        object.__setattr__(self, "_proxy_target", target)
        object.__setattr__(self, "_proxy_hook", hook)

    def __getattr__(self, name):
        value = getattr(object.__getattribute__(self, "_proxy_target"), name)
        if not callable(value) or name.startswith("_"):
            return value
        hook = object.__getattribute__(self, "_proxy_hook")
        proxy_name = object.__getattribute__(self, "_proxy_name")
        target = object.__getattribute__(self, "_proxy_target")

        def wrapper(*args, **kwargs):
            return hook(proxy_name, target, name, args, kwargs,
                        lambda: value(*args, **kwargs))
        wrapper.__name__ = name
        return wrapper

    def __setattr__(self, name, value):
        if name in ProxyAllMethods._PROXY_SLOTS:
            object.__setattr__(self, name, value)
        else:
            setattr(object.__getattribute__(self, "_proxy_target"),
                    name, value)

    def __repr__(self):
        target = object.__getattribute__(self, "_proxy_target")
        return f"ProxyAllMethods({target!r})"


def proxy_trace(target, name=None, printer=None):
    """Wrap ``target`` so every public method call prints enter/exit
    (reference ``proxy_trace``, main/proxy.py:64-72)."""
    printer = printer or (lambda text: print(text))
    name = name or type(target).__name__

    def hook(proxy_name, _target, method_name, args, kwargs, call):
        printer(f"TRACE {proxy_name}.{method_name}(args={args}, "
                f"kwargs={kwargs}) enter")
        try:
            return call()
        finally:
            printer(f"TRACE {proxy_name}.{method_name} exit")
    return ProxyAllMethods(name, target, hook)
