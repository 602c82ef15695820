"""Time-bounded leases.

The port's copy of ``aiko_services_tpu/runtime/lease.py`` (it has no JAX
in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/lease.py:38-83``.
A ``Lease`` expires after ``lease_time`` seconds unless extended; with
``automatic_extend`` it re-extends itself at 0.8× of the period (the EC
share consumer behavior).  On expiry the ``lease_expired_handler`` runs on
the event-loop thread.  Used by EC shares, stream lifetimes, and the
LifeCycleManager handshake/deletion protocol.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .event import EventEngine, event as _default_engine
from . import faults

__all__ = ["Lease"]

_EXTEND_FRACTION = 0.8


class Lease:
    def __init__(self, lease_time: float, lease_uuid: Any,
                 lease_expired_handler: Optional[Callable] = None,
                 automatic_extend: bool = False,
                 engine: Optional[EventEngine] = None):
        self.lease_time = lease_time
        self.lease_uuid = lease_uuid
        self.lease_expired_handler = lease_expired_handler
        self.automatic_extend = automatic_extend
        self.terminated = False
        self._engine = engine or _default_engine
        self._engine.add_timer_handler(self._expired, lease_time, once=True)
        if automatic_extend:
            self._engine.add_timer_handler(
                self._auto_extend, lease_time * _EXTEND_FRACTION)

    def _auto_extend(self):
        if not self.terminated:
            self.extend()

    def _expired(self):
        if self.terminated:
            return
        self.terminated = True
        self._cancel_timers()
        if self.lease_expired_handler:
            self.lease_expired_handler(self.lease_uuid)

    def _cancel_timers(self):
        self._engine.remove_timer_handler(self._expired)
        self._engine.remove_timer_handler(self._auto_extend)

    def extend(self, lease_time: Optional[float] = None):
        """Push the expiry another ``lease_time`` seconds into the future."""
        if self.terminated:
            return
        if faults.PLAN is not None:
            if faults.PLAN.check("expire_lease",
                                 key=str(self.lease_uuid)) is not None:
                self._expired()
                return
        if lease_time is not None:
            self.lease_time = lease_time
        self._engine.remove_timer_handler(self._expired)
        self._engine.add_timer_handler(
            self._expired, self.lease_time, once=True)

    def terminate(self):
        self.terminated = True
        self._cancel_timers()
