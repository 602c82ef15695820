"""Serving engines of the port, its fleet and its supervisors: what the
JAX package's ``orchestration`` exports, less the trainer actor."""

from .process_manager import ProcessManager
from .lifecycle import (
    LifeCycleManager, LifeCycleClient,
    HANDSHAKE_LEASE_TIME, DELETION_LEASE_TIME,
)
from .serving import (
    ModelReplica, ReplicaRouter, REPLICA_PROTOCOL, make_llama_infer,
)
from .continuous import (
    ContinuousBatchingServer, ContinuousReplica, DecodeRequest,
)
from .paged import PagedContinuousServer
from .client import InferClient, InferFuture
from .autoscaler import (
    FleetAutoscaler, AutoscalerPolicy, FleetSnapshot, ReplicaView,
    PendingView, DeathEvent, Action, ControllerState, decide,
    AUTOSCALER_PROTOCOL, manager_spawner, manager_terminator,
)
