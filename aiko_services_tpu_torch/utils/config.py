"""Environment-driven configuration.

The port's copy of ``aiko_services_tpu/utils/config.py`` (it has no JAX in
it), cut to what the loopback runtime reads: ``AIKO_NAMESPACE`` (default
``"aiko"``), ``AIKO_HOSTNAME`` and ``AIKO_TRANSPORT``.  The reference's MQTT
settings and its UDP broadcast bootstrap (``boot?`` on port 4149) serve
the MQTT transport, which the port does not have yet; see ``ROADMAP.md``.
"""

from __future__ import annotations

import os
import socket

__all__ = ["get_namespace", "get_hostname", "get_pid",
           "get_default_transport"]

DEFAULT_NAMESPACE = "aiko"


def get_namespace() -> str:
    return os.environ.get("AIKO_NAMESPACE", DEFAULT_NAMESPACE)


def get_hostname() -> str:
    hostname = os.environ.get("AIKO_HOSTNAME")
    if hostname:
        return hostname
    return socket.gethostname().split(".")[0]


def get_pid() -> str:
    return str(os.getpid())


def get_default_transport() -> str:
    return os.environ.get("AIKO_TRANSPORT", "loopback")
