"""Service layer: identity, tags, filters, the Services collection.

The port's copy of ``aiko_services_tpu/runtime/service.py`` (it has no
JAX in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/service.py:
99-583``.  A Service is a discoverable unit owned by a Process, addressed
by topic path ``namespace/host/pid/service_id`` with per-service topics
``…/in``, ``…/out``, ``…/control``, ``…/state``, ``…/log``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Union

__all__ = [
    "ServiceFields", "ServiceFilter", "ServiceTags", "ServiceTopicPath",
    "Services", "Service",
]


class ServiceTags:
    """Tags are ``key=value`` strings (reference service.py:236-252)."""

    @staticmethod
    def parse(tags: List[str]) -> Dict[str, str]:
        result = {}
        for tag in tags or []:
            key, _, value = str(tag).partition("=")
            result[key] = value
        return result

    @staticmethod
    def generate(tags: Dict[str, str]) -> List[str]:
        return [f"{k}={v}" for k, v in tags.items()]

    @staticmethod
    def match(tags: List[str], required: List[str]) -> bool:
        if not required or required == ["*"]:
            return True
        return all(tag in (tags or []) for tag in required)


@dataclass
class ServiceTopicPath:
    """``namespace/host/pid/service_id`` (reference service.py:254-330)."""
    namespace: str
    hostname: str
    process_id: str
    service_id: Union[int, str]

    @classmethod
    def parse(cls, topic_path: str) -> Optional["ServiceTopicPath"]:
        parts = str(topic_path).split("/")
        if len(parts) < 4:
            return None
        return cls(parts[0], parts[1], parts[2], parts[3])

    @property
    def process_path(self) -> str:
        return f"{self.namespace}/{self.hostname}/{self.process_id}"

    @property
    def terse(self) -> str:
        return f"{self.hostname}/{self.process_id}/{self.service_id}"

    def __str__(self) -> str:
        return f"{self.process_path}/{self.service_id}"


@dataclass
class ServiceFields:
    """The registrar's record of one Service."""
    topic_path: str
    name: str
    protocol: Optional[str] = None
    transport: str = "loopback"
    owner: Optional[str] = None
    tags: List[str] = field(default_factory=list)

    def as_list(self) -> List:
        return [self.topic_path, self.name, self.protocol or "*",
                self.transport, self.owner or "*", self.tags]


@dataclass
class ServiceFilter:
    """Match criteria over ServiceFields; "*" wildcards any field
    (reference service.py:212-233)."""
    topic_paths: Union[str, List[str]] = "*"
    name: str = "*"
    protocol: str = "*"
    transport: str = "*"
    owner: str = "*"
    tags: Union[str, List[str]] = "*"

    @classmethod
    def with_topic_path(cls, topic_path="*", name="*", protocol="*",
                        transport="*", owner="*", tags="*"):
        paths = "*" if topic_path == "*" else [str(topic_path)]
        return cls(paths, name, protocol, transport, owner, tags)

    def matches(self, fields: ServiceFields) -> bool:
        if self.topic_paths != "*":
            if str(fields.topic_path) not in [str(p) for p in
                                              self.topic_paths]:
                return False
        if self.name not in ("*", fields.name):
            return False
        if self.protocol != "*":
            # Protocol match allows version-insensitive prefix matching:
            # "…/image_to_rgb" matches "…/image_to_rgb:0".
            actual = fields.protocol or ""
            if actual != self.protocol and \
                    not actual.startswith(f"{self.protocol}:"):
                return False
        if self.transport not in ("*", fields.transport):
            return False
        if self.owner not in ("*", fields.owner):
            return False
        tags = self.tags if isinstance(self.tags, list) else (
            [] if self.tags == "*" else [self.tags])
        return ServiceTags.match(fields.tags, tags)


class Services:
    """Two-level registry: process topic path → service_id → ServiceFields
    (reference service.py:335-490)."""

    def __init__(self):
        self._processes: Dict[str, Dict[str, ServiceFields]] = {}
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def __iter__(self) -> Iterator[ServiceFields]:
        for services in self._processes.values():
            yield from services.values()

    def add(self, fields: ServiceFields):
        topic = ServiceTopicPath.parse(fields.topic_path)
        if topic is None:
            raise ValueError(f"Bad topic path: {fields.topic_path}")
        process = self._processes.setdefault(topic.process_path, {})
        key = str(topic.service_id)
        if key not in process:
            self._count += 1
        process[key] = fields

    def remove(self, topic_path: str) -> Optional[ServiceFields]:
        topic = ServiceTopicPath.parse(topic_path)
        if topic is None:
            return None
        process = self._processes.get(topic.process_path)
        if not process:
            return None
        fields = process.pop(str(topic.service_id), None)
        if fields is not None:
            self._count -= 1
        if not process:
            self._processes.pop(topic.process_path, None)
        return fields

    def remove_process(self, process_path: str) -> List[ServiceFields]:
        """Evict every service of a dead process (LWT handling)."""
        process = self._processes.pop(process_path, None)
        if not process:
            return []
        removed = list(process.values())
        self._count -= len(removed)
        return removed

    def get(self, topic_path: str) -> Optional[ServiceFields]:
        topic = ServiceTopicPath.parse(topic_path)
        if topic is None:
            return None
        return self._processes.get(topic.process_path, {}).get(
            str(topic.service_id))

    def filter(self, service_filter: ServiceFilter) -> List[ServiceFields]:
        return [f for f in self if service_filter.matches(f)]

    def copy(self) -> "Services":
        result = Services()
        for fields in self:
            result.add(fields)
        return result


class Service:
    """Base class for everything discoverable.

    Subclasses are constructed with a ``ServiceContext`` (see
    :mod:`aiko_services_tpu_torch.runtime.context`) and a ``Process``;
    the process assigns the service id and topic path at registration.
    """

    def __init__(self, context, process=None):
        from .process import default_process  # late: avoid import cycle
        self.context = context
        self.process = process or default_process()
        self.name = context.name
        self.protocol = context.protocol
        self.transport = context.transport
        self.owner = context.owner
        self._tags: List[str] = list(context.tags or [])
        self.service_id: Optional[int] = None
        self.topic_path: Optional[str] = None
        self.process.add_service(self)

    # Topics (assigned once registered with the process).
    def _topic(self, suffix: str) -> str:
        return f"{self.topic_path}/{suffix}"

    @property
    def topic_in(self) -> str:
        return self._topic("in")

    @property
    def topic_out(self) -> str:
        return self._topic("out")

    @property
    def topic_control(self) -> str:
        return self._topic("control")

    @property
    def topic_state(self) -> str:
        return self._topic("state")

    @property
    def topic_log(self) -> str:
        return self._topic("log")

    # Tags.
    @property
    def tags(self) -> List[str]:
        return list(self._tags)

    def add_tags(self, tags: List[str]):
        for tag in tags:
            if tag not in self._tags:
                self._tags.append(tag)

    def service_fields(self) -> ServiceFields:
        return ServiceFields(self.topic_path, self.name, self.protocol,
                             self.transport, self.owner, self.tags)

    # Lifecycle hooks the Process calls.
    def registrar_changed(self, registrar_topic: Optional[str],
                          available: bool):
        """Called when the registrar appears/disappears."""

    def stop(self):
        self.process.remove_service(self)
