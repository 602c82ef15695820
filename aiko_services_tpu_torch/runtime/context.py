"""Construction contexts.

The port's copy of ``aiko_services_tpu/runtime/context.py`` (it has no
JAX in it); its imports point at the port's own modules.

Reference parity: upstream aiko_services ``main/context.py:
56-190`` — the single-argument constructor payload for Services, Actors,
PipelineElements and Pipelines, plus the ``*_args()`` convenience
builders.  Unlike the reference there is no interface/implementation
"Frankenstein" weaving (``main/component.py:50-107``): classes are plain
Python, and ``compose_instance(cls, context)`` simply instantiates —
explicit inheritance replaces compose-time method grafting.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..utils.config import get_default_transport

__all__ = [
    "ServiceContext", "PipelineElementContext", "PipelineContext",
    "service_args", "actor_args", "pipeline_element_args", "pipeline_args",
    "compose_instance",
]


@dataclass
class ServiceContext:
    name: str
    protocol: Optional[str] = None
    transport: str = field(default_factory=get_default_transport)
    owner: Optional[str] = None
    tags: List[str] = field(default_factory=list)
    parameters: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PipelineElementContext(ServiceContext):
    definition: Any = None          # PipelineElementDefinition
    pipeline: Any = None            # owning Pipeline (set at graph build)


@dataclass
class PipelineContext(ServiceContext):
    definition: Any = None          # PipelineDefinition
    definition_pathname: str = ""
    graph_path: Optional[str] = None
    stream_id: Optional[str] = None
    frame_data: Optional[str] = None


def service_args(name, protocol=None, transport=None, owner=None,
                 tags=None, parameters=None) -> ServiceContext:
    return ServiceContext(
        name=name, protocol=protocol,
        transport=transport or get_default_transport(),
        owner=owner, tags=list(tags or []), parameters=dict(parameters or {}))


actor_args = service_args  # identical payload; alias for API parity


def pipeline_element_args(name, definition=None, pipeline=None,
                          protocol=None, transport=None, tags=None,
                          parameters=None) -> PipelineElementContext:
    return PipelineElementContext(
        name=name, protocol=protocol,
        transport=transport or get_default_transport(),
        tags=list(tags or []), parameters=dict(parameters or {}),
        definition=definition, pipeline=pipeline)


def pipeline_args(name, definition=None, definition_pathname="",
                  graph_path=None, stream_id=None, frame_data=None,
                  protocol=None, transport=None, tags=None,
                  parameters=None) -> PipelineContext:
    return PipelineContext(
        name=name, protocol=protocol,
        transport=transport or get_default_transport(),
        tags=list(tags or []), parameters=dict(parameters or {}),
        definition=definition, definition_pathname=definition_pathname,
        graph_path=graph_path, stream_id=stream_id, frame_data=frame_data)


def compose_instance(cls, context, **kwargs):
    """Instantiate a Service class from its context (reference
    ``compose_instance``, ``main/component.py:91-107``, minus the
    metaclass machinery)."""
    return cls(context, **kwargs)
