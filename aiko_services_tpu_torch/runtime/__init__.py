"""The port's copy of the actor runtime (``aiko_services_tpu/runtime/``):
the event engine, faults, leases, contexts, services, processes and
actors.  The reference's remote proxies (``proxy.py``) and service
categories (``category.py``) are not ported: nothing on the wire needs
them yet."""

from .event import EventEngine, VirtualClock, event
from .faults import FaultPlan, plan_from_spec
from .lease import Lease
from .connection import Connection, ConnectionState
from .context import (
    ServiceContext, PipelineElementContext, PipelineContext,
    service_args, actor_args, pipeline_element_args, pipeline_args,
    compose_instance,
)
from .service import (
    Service, ServiceFields, ServiceFilter, ServiceTags, ServiceTopicPath,
    Services,
)
from .process import Process, default_process, set_default_process
from .actor import Actor, ActorMessage, Mailbox
