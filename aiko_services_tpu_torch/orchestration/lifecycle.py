"""LifeCycleManager / LifeCycleClient: supervised fleets of worker
processes with handshake and deletion leases.

The port's copy of ``aiko_services_tpu/orchestration/lifecycle.py``
(it has no JAX in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/lifecycle.py:
98-388``.  Protocol:

* Manager ``create_client(id)`` spawns a worker (via a pluggable spawner —
  default :class:`ProcessManager` Popen; tests inject in-process spawners)
  and arms a **handshake lease** (30 s, reference lifecycle.py:74): the
  client must announce ``(add_client client_topic_path id)`` on the
  manager's ``…/control`` before it expires or it is force-deleted.
* Manager ``delete_client(id)`` sends ``(terminate)`` to the client and
  arms a **deletion lease** (30 s): if the client hasn't vanished when it
  expires, it is killed through the spawner.
* Client side: :class:`LifeCycleClient` announces itself on startup.

This is the replica-fleet controller the TPU build reuses for
data-parallel serving replicas (SURVEY.md §2.6).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..utils.logger import get_logger
from ..utils.sexpr import generate
from ..runtime.actor import Actor
from ..runtime.context import actor_args
from ..runtime.lease import Lease

__all__ = ["LifeCycleManager", "LifeCycleClient",
           "HANDSHAKE_LEASE_TIME", "DELETION_LEASE_TIME"]

_logger = get_logger(__name__)

HANDSHAKE_LEASE_TIME = 30.0  # reference lifecycle.py:74
DELETION_LEASE_TIME = 30.0   # reference lifecycle.py:75


class LifeCycleManager(Actor):
    """``spawner(id, manager_topic_control) -> None`` starts a worker;
    ``killer(id) -> None`` force-removes one."""

    def __init__(self, context=None, process=None,
                 spawner: Optional[Callable] = None,
                 killer: Optional[Callable] = None,
                 client_ready_handler: Optional[Callable] = None,
                 client_exit_handler: Optional[Callable] = None,
                 handshake_lease_time: float = HANDSHAKE_LEASE_TIME,
                 deletion_lease_time: float = DELETION_LEASE_TIME):
        context = context or actor_args("lifecycle_manager",
                                        protocol="lifecycle_manager:0")
        super().__init__(context, process)
        self.clients: Dict[str, Optional[str]] = {}  # id -> topic_path
        self._spawner = spawner
        self._killer = killer
        self._client_ready_handler = client_ready_handler
        self._client_exit_handler = client_exit_handler
        self._handshake_time = handshake_lease_time
        self._deletion_time = deletion_lease_time
        self._handshake_leases: Dict[str, Lease] = {}
        self._deletion_leases: Dict[str, Lease] = {}
        # successor id -> predecessor id (replace_client handoffs).
        self._replacements: Dict[str, str] = {}
        # Clients handshake on the manager's control topic (reference
        # lifecycle.py _lcm_topic_control_handler); this coexists with the
        # ECProducer's handler on the same topic.
        self.process.add_message_handler(self._control_handler,
                                         self.topic_control)

    def _control_handler(self, topic: str, payload: str):
        from ..utils.sexpr import SExprError, parse
        try:
            command, parameters = parse(payload)
        except SExprError:
            return
        if command == "add_client" and len(parameters) >= 2:
            self.add_client(parameters[0], parameters[1])
        elif command == "remove_client" and parameters:
            self.remove_client(parameters[0])

    # -- fleet API ----------------------------------------------------------- #

    def create_client(self, client_id):
        client_id = str(client_id)
        if client_id in self.clients:
            raise ValueError(f"Client already exists: {client_id}")
        self.clients[client_id] = None
        self._handshake_leases[client_id] = Lease(
            self._handshake_time, client_id,
            lease_expired_handler=self._handshake_expired,
            engine=self.process.event)
        if self._spawner:
            self._spawner(client_id, self.topic_control)

    def delete_client(self, client_id, force: bool = False):
        client_id = str(client_id)
        topic_path = self.clients.get(client_id)
        if client_id not in self.clients:
            return
        if force or topic_path is None:
            self._force_delete(client_id)
            return
        self.process.message.publish(f"{topic_path}/in", "(terminate)")
        stale = self._deletion_leases.pop(client_id, None)
        if stale:
            stale.terminate()  # re-delete: restart the grace window
        self._deletion_leases[client_id] = Lease(
            self._deletion_time, client_id,
            lease_expired_handler=self._deletion_expired,
            engine=self.process.event)

    def replace_client(self, client_id, new_client_id) -> None:
        """Zero-downtime replacement: spawn ``new_client_id`` now and
        delete ``client_id`` only once the successor completes its
        handshake — the lifecycle-layer analogue of the autoscaler's
        rolling upgrade (the fleet never dips below size during the
        swap).  If the successor misses its handshake lease, the
        predecessor is kept and the replacement is dropped."""
        client_id, new_client_id = str(client_id), str(new_client_id)
        if client_id not in self.clients:
            raise ValueError(f"Unknown client: {client_id}")
        self._replacements[new_client_id] = client_id
        self.create_client(new_client_id)

    def client_count(self, ready_only: bool = False) -> int:
        if ready_only:
            return sum(1 for tp in self.clients.values() if tp)
        return len(self.clients)

    # -- wire commands (client -> manager control topic) ---------------------- #

    def add_client(self, client_topic_path, client_id):
        """Handshake: ``(add_client topic_path id)``."""
        client_id = str(client_id)
        if client_id not in self.clients:
            _logger.warning("add_client for unknown id: %s", client_id)
            return
        self.clients[client_id] = str(client_topic_path)
        lease = self._handshake_leases.pop(client_id, None)
        if lease:
            lease.terminate()
        if self._client_ready_handler:
            self._client_ready_handler(client_id, str(client_topic_path))
        predecessor = self._replacements.pop(client_id, None)
        if predecessor is not None:
            self.delete_client(predecessor)

    def remove_client(self, client_id):
        """Client announced clean exit: ``(remove_client id)``."""
        self._finish(str(client_id))

    # -- lease expiry --------------------------------------------------------- #

    def _handshake_expired(self, client_id: str):
        _logger.warning("Client %s missed handshake; force delete",
                        client_id)
        self._handshake_leases.pop(client_id, None)
        self._force_delete(client_id)

    def _deletion_expired(self, client_id: str):
        _logger.warning("Client %s ignored terminate; force delete",
                        client_id)
        self._deletion_leases.pop(client_id, None)
        self._force_delete(client_id)

    def _force_delete(self, client_id: str):
        if self._killer:
            self._killer(client_id)
        self._finish(client_id)

    def _finish(self, client_id: str):
        for leases in (self._handshake_leases, self._deletion_leases):
            lease = leases.pop(client_id, None)
            if lease:
                lease.terminate()
        existed = client_id in self.clients
        self.clients.pop(client_id, None)
        self._replacements.pop(client_id, None)
        if existed and self._client_exit_handler:
            self._client_exit_handler(client_id)

    def stop(self):
        self.process.remove_message_handler(self._control_handler,
                                            self.topic_control)
        for leases in (self._handshake_leases, self._deletion_leases):
            for lease in leases.values():
                lease.terminate()
            leases.clear()
        super().stop()


class LifeCycleClient(Actor):
    def __init__(self, context=None, process=None,
                 manager_topic_control: str = "", client_id: str = ""):
        context = context or actor_args("lifecycle_client",
                                        protocol="lifecycle_client:0")
        super().__init__(context, process)
        self.client_id = str(client_id)
        self.manager_topic_control = manager_topic_control
        if manager_topic_control:
            self.announce()

    def announce(self):
        self.process.message.publish(
            self.manager_topic_control,
            generate("add_client", [self.topic_path, self.client_id]))

    def terminate(self):
        if self.manager_topic_control:
            self.process.message.publish(
                self.manager_topic_control,
                generate("remove_client", [self.client_id]))
        super().terminate()
