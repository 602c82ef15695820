"""Eventual-consistency shared state: ECProducer / ECConsumer.

The port's copy of ``aiko_services_tpu/registry/share.py`` (it has no
JAX in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/share.py:
153-452``.  Protocol (S-expressions on the producer service's topics):

* Producer listens on ``…/control``:
  - ``(add name value)`` / ``(update name value)`` / ``(remove name)``
    mutate the share and are echoed on ``…/state`` for live watchers.
  - ``(share response_topic lease_time filter)`` requests a snapshot:
    producer replies on ``response_topic`` with ``(item_count N)``,
    N × ``(add name value)``, then ``(sync response_topic)``, and
    registers a lease; while the lease lives, every mutation matching
    ``filter`` is pushed to ``response_topic``.
* Consumer sends the share request and auto-extends its lease (300 s
  default, extend at 0.8× — reference share.py:86, lease.py:33).

Keys are dotted paths of maximum depth 2 (``"a.b"``), mirroring the
reference's constraint (share.py:115-119).  Values are stored as strings
on the wire; the share dict holds whatever the producer put in it.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional

from ..utils.logger import get_logger
from ..utils.sexpr import SExprError, generate, parse
from ..runtime.lease import Lease

__all__ = ["ECProducer", "ECConsumer",
           "dict_path_get", "dict_path_set", "dict_path_delete",
           "dict_to_flat_commands"]

_logger = get_logger(__name__)

EC_LEASE_TIME = 300.0  # seconds
_MAX_DEPTH = 2


def _split_path(path: str) -> List[str]:
    keys = str(path).split(".")
    if len(keys) > _MAX_DEPTH:
        raise ValueError(f"Share path deeper than {_MAX_DEPTH}: {path}")
    return keys


def dict_path_get(tree: Dict, path: str, default=None):
    node = tree
    for key in _split_path(path):
        if not isinstance(node, dict) or key not in node:
            return default
        node = node[key]
    return node


def dict_path_set(tree: Dict, path: str, value):
    keys = _split_path(path)
    node = tree
    for key in keys[:-1]:
        node = node.setdefault(key, {})
        if not isinstance(node, dict):
            raise ValueError(f"Share path {path} crosses a leaf")
    node[keys[-1]] = value


def dict_path_delete(tree: Dict, path: str):
    keys = _split_path(path)
    node = tree
    for key in keys[:-1]:
        node = node.get(key)
        if not isinstance(node, dict):
            return
    node.pop(keys[-1], None)


def dict_to_flat_commands(tree: Dict, prefix: str = "") -> List[tuple]:
    """Flatten to [(path, value)] with depth-2 dotted paths."""
    items = []
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            items.extend(dict_to_flat_commands(value, f"{path}."))
        else:
            items.append((path, value))
    return items


class _ShareLease:
    __slots__ = ("lease", "response_topic", "filter")

    def __init__(self, lease, response_topic, filter_spec):
        self.lease = lease
        self.response_topic = response_topic
        self.filter = filter_spec


class ECProducer:
    """Attaches replicated-state behavior to a Service's share dict."""

    def __init__(self, service, share: Optional[Dict] = None):
        self.service = service
        self.share = share if share is not None else {}
        self._leases: Dict[str, _ShareLease] = {}  # response_topic -> lease
        self._handlers: List[Callable] = []
        service.process.add_message_handler(
            self._control_handler, service.topic_control)

    # -- local mutation API -------------------------------------------------- #

    def get(self, path: str, default=None):
        return dict_path_get(self.share, path, default)

    def update(self, path: str, value):
        """Set + broadcast UNCONDITIONALLY — identical-value updates
        still go to the wire.  Consumers may rely on re-broadcast as a
        liveness signal (the kvstore prefix directory refreshes its
        per-replica lease on every ``kv_prefixes`` update, changed or
        not); use :meth:`update_if_changed` to suppress no-op traffic
        for plain counters."""
        dict_path_set(self.share, path, value)
        self._broadcast("update", path, value)

    def update_if_changed(self, path: str, value) -> bool:
        """Broadcast only when ``value`` differs from the stored one
        (compared post-stringification, matching what the wire would
        carry).  Returns True when a broadcast was sent."""
        sentinel = object()
        current = dict_path_get(self.share, path, sentinel)
        if current is not sentinel and str(current) == str(value):
            return False
        self.update(path, value)
        return True

    def add(self, path: str, value):
        dict_path_set(self.share, path, value)
        self._broadcast("add", path, value)

    def remove(self, path: str):
        dict_path_delete(self.share, path)
        self._broadcast("remove", path, None)

    def add_handler(self, handler: Callable):
        """handler(command, path, value) on every mutation (local or remote)."""
        self._handlers.append(handler)

    # -- wire ----------------------------------------------------------------- #

    def _publish(self, topic: str, command: str, parameters):
        self.service.process.message.publish(topic,
                                             generate(command, parameters))

    def _broadcast(self, command: str, path: str, value):
        parameters = [path] if value is None else [path, str(value)]
        # Echo on the service state topic for passive watchers...
        self._publish(self.service.topic_state, command, parameters)
        # ...and push to live share leases whose filter matches.
        for holder in list(self._leases.values()):
            if self._filter_matches(holder.filter, path):
                self._publish(holder.response_topic, command, parameters)
        for handler in self._handlers:
            handler(command, path, value)

    @staticmethod
    def _filter_matches(filter_spec, path: str) -> bool:
        if filter_spec in ("*", None, []):
            return True
        specs = filter_spec if isinstance(filter_spec, list) else [filter_spec]
        return any(path == s or path.startswith(f"{s}.") for s in specs)

    def _control_handler(self, topic: str, payload: str):
        try:
            command, parameters = parse(payload)
        except SExprError:
            return
        if command in ("add", "update") and len(parameters) >= 2:
            dict_path_set(self.share, parameters[0], parameters[1])
            self._broadcast(command, parameters[0], parameters[1])
        elif command == "remove" and len(parameters) >= 1:
            dict_path_delete(self.share, parameters[0])
            self._broadcast(command, parameters[0], None)
        elif command == "share" and len(parameters) >= 2:
            self._share_request(*parameters[:3])

    def _share_request(self, response_topic: str, lease_time,
                       filter_spec="*"):
        try:
            lease_seconds = float(lease_time)
        except (TypeError, ValueError):
            lease_seconds = EC_LEASE_TIME
        items = [(p, v) for p, v in dict_to_flat_commands(self.share)
                 if self._filter_matches(filter_spec, p)]
        self._publish(response_topic, "item_count", [str(len(items))])
        for path, value in items:
            self._publish(response_topic, "add", [path, str(value)])
        self._publish(response_topic, "sync", [response_topic])
        if lease_seconds > 0:
            existing = self._leases.get(response_topic)
            if existing:
                existing.lease.extend(lease_seconds)
                existing.filter = filter_spec
            else:
                lease = Lease(lease_seconds, response_topic,
                              lease_expired_handler=self._lease_expired,
                              engine=self.service.process.event)
                self._leases[response_topic] = _ShareLease(
                    lease, response_topic, filter_spec)

    def _lease_expired(self, response_topic: str):
        self._leases.pop(response_topic, None)

    def terminate(self):
        for holder in self._leases.values():
            holder.lease.terminate()
        self._leases.clear()
        self.service.process.remove_message_handler(
            self._control_handler, self.service.topic_control)


class ECConsumer:
    """Mirrors a remote producer's share into a local cache dict."""

    _ids = itertools.count(1)

    def __init__(self, process, cache: Dict, producer_topic_control: str,
                 filter_spec="*", lease_time: float = EC_LEASE_TIME,
                 sync_handler: Optional[Callable] = None):
        self.process = process
        self.cache = cache
        self.producer_topic_control = producer_topic_control
        self.filter = filter_spec
        self.lease_time = lease_time
        self.sync_handler = sync_handler
        self.synced = False
        self._item_count: Optional[int] = None
        self._items_seen = 0
        self._snapshot_paths: Optional[set] = None
        consumer_id = next(self._ids)
        self.response_topic = (
            f"{process.topic_path_process}/0/ec/{consumer_id}")
        process.add_message_handler(self._consumer_handler,
                                    self.response_topic)
        # Re-send the share request at 0.8x the lease period, refreshing the
        # producer-side lease before it expires (reference share.py:420-436).
        process.event.add_timer_handler(self._request_share,
                                        lease_time * 0.8)
        self._request_share()

    def _request_share(self, *_args):
        self.process.message.publish(
            self.producer_topic_control,
            generate("share", [self.response_topic,
                               str(self.lease_time), self.filter]))

    def _consumer_handler(self, topic: str, payload: str):
        try:
            command, parameters = parse(payload)
        except SExprError:
            return
        if command == "item_count" and parameters:
            self._item_count = int(parameters[0])
            self._items_seen = 0
            self._snapshot_paths = set()
        elif command in ("add", "update") and len(parameters) >= 2:
            dict_path_set(self.cache, parameters[0], parameters[1])
            self._items_seen += 1
            if self._snapshot_paths is not None:
                self._snapshot_paths.add(parameters[0])
        elif command == "remove" and parameters:
            dict_path_delete(self.cache, parameters[0])
        elif command == "sync":
            # Prune keys absent from the snapshot: removes that happened
            # while we were disconnected must not survive the re-sync.
            if self._snapshot_paths is not None:
                for path, _ in dict_to_flat_commands(self.cache):
                    if path not in self._snapshot_paths and \
                            ECProducer._filter_matches(self.filter, path):
                        dict_path_delete(self.cache, path)
                self._snapshot_paths = None
            self.synced = True
            if self.sync_handler:
                self.sync_handler(self.cache)

    def terminate(self):
        self.process.event.remove_timer_handler(self._request_share)
        self.process.remove_message_handler(self._consumer_handler,
                                            self.response_topic)
