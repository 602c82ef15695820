"""Data-parallel model replica serving: the replica side of the wire.

The port's copy of the jax-free part of
``aiko_services_tpu/orchestration/serving.py``: the replica protocol name,
the operator telemetry projection (:data:`TELEMETRY_KEYS`,
:func:`serving_telemetry`) and :class:`ModelReplica`, an Actor hosting one
model instance that answers ``(infer request_id response_topic
(payload…))`` with ``(infer_response request_id (outputs…))`` on
``response_topic``.  :class:`~.continuous.ContinuousReplica` speaks the
same protocol over a continuous batch.

The reference's ``ReplicaRouter`` (discovery, power-of-two-choices load
balancing, re-dispatch, shedding) and its model factories
(``make_llama_infer`` and the others) are not ported yet: they come with
the fleet entry points (``ROADMAP.md``, queue 1 item 4).

Payloads are swag-codec dicts (numpy arrays travel as typed tags), so
token tensors cross process boundaries losslessly.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from ..pipeline.codec import decode_swag, encode_swag
from ..runtime.actor import Actor
from ..utils.sexpr import generate

__all__ = ["ModelReplica", "REPLICA_PROTOCOL", "RETRIABLE_ERRORS",
           "TELEMETRY_KEYS", "serving_telemetry"]

REPLICA_PROTOCOL = "model_replica:0"

#: Replica-reported errors the router retries on a different replica
#: instead of forwarding to the client (the failure is the REPLICA's,
#: not the request's).
RETRIABLE_ERRORS = ("watchdog_stalled",)

#: Server-stats keys worth broadcasting to operators.  Shared by
#: ContinuousReplica EC shares, dashboard rendering, and bench
#: reporting so all three show the SAME derived counters.
TELEMETRY_KEYS = (
    "slots_active", "queue_depth", "in_flight",
    "decode_steps_per_sec", "sync_stalls_per_100_steps",
    "admission_deferred", "state_uploads", "tokens_committed",
    # Host-tax levers: the adaptive dispatch ring and the
    # compact dirty-row upload path
    "ring_depth", "ring_starved_steps", "dirty_rows_uploaded",
    "prefix_hits", "prefix_misses", "prefix_evictions",
    "prefix_remote_hits", "kv_transfer_bytes", "kv_transfer_ms",
    "kv_transfer_failures", "kv_demotions", "kv_restores",
    "kv_host_blocks", "kv_host_bytes", "restore_queue_depth",
    "prefix_hits_host", "kv_export_sync_count",
    "kv_transfer_host_ms", "kv_imports_async",
    "kv_spills", "kv_disk_blocks", "kv_disk_bytes",
    "kv_disk_restores", "kv_checksum_failures", "kv_adopted_chains",
    "kv_prefetch_promotions",
    "decode_attention_path", "blocks_read_per_step",
    "prefill_tokens_per_sec", "prefill_queue_depth",
    "prefill_attention_path",
    "deadline_exceeded", "shed", "watchdog_trips", "free_slots",
    "healthy", "tp_degree", "mesh_shape",
    # 2-D replica meshes: second-axis degrees and the count of
    # admission dispatches that went through the sp-sharded window path
    "sp_degree", "ep_degree", "sp_prefill_dispatches",
    # Speculative decoding (present only when a draft is configured)
    "spec_k", "spec_rounds", "spec_proposed", "spec_accepted",
    "spec_acceptance_rate", "spec_tokens_per_target_pass",
    "spec_rollback_blocks",
    # Speculation v2: draft mode, per-slot effective-k
    # histogram (adaptive controller), grammar jump-forward and
    # n-gram self-draft counters
    "spec_draft_mode", "spec_k_effective",
    "spec_jump_forward_tokens", "spec_ngram_hits",
    # Compile ledger + device profiling (present only when a
    # CompileLedger is installed / a profile bracket ran)
    "compiles", "compiles_steady_state", "compile_cache_hits",
    "compile_cache_misses", "compile_wall_ms",
    "device_step_ms", "profiles",
    # Memory accountant + pool auditor (kv_hbm_* always on a
    # paged server, audit counters only when an AUDITOR is installed)
    "kv_hbm_blocks", "kv_hbm_bytes",
    "kv_audit_sweeps", "kv_audit_violations",
    # Multi-tenant adapters: paged adapter-weight residency per
    # tier plus warm-vs-cold load provenance, so the dashboard's
    # adapter pane and the loadgen A/B read the same counters.
    "adapter_pages_hbm", "adapter_pages_host", "adapter_pages_disk",
    "adapter_warm_loads", "adapter_cold_loads",
    "adapters_loaded_count",
    # The port's CUDA graph ledger (obs/compiles.py): captures, replays
    # and captures after the warm-up fence.
    "graph_captures", "graph_replays", "graph_captures_steady_state",
)


def serving_telemetry(stats: Dict) -> Dict:
    """Project a server's :meth:`stats` dict onto the operator
    telemetry keys (ints stay ints, rates stay floats, tags stay
    strings; absent keys — e.g. prefix counters on a non-paged server
    — are omitted)."""
    out = {}
    for key in TELEMETRY_KEYS:
        if key in stats:
            value = stats[key]
            if isinstance(value, str):
                out[key] = value
            elif isinstance(value, float):
                out[key] = round(float(value), 2)
            else:
                out[key] = int(value)
    return out


def _register_unsupported_adapter_commands(actor) -> None:
    """Adapter hot-deploy is a ContinuousReplica capability; other
    protocol speakers ACK with an error instead of silently dropping
    the command (a client future must always resolve)."""
    def unsupported(request_id, response_topic, payload=None):
        actor.process.message.publish(
            str(response_topic),
            generate("adapter_response",
                     [str(request_id),
                      encode_swag({"error": "unsupported_command"})]))

    actor._command_handlers["adapter_load"] = unsupported
    actor._command_handlers["adapter_unload"] = unsupported


class ModelReplica(Actor):
    """Hosts one model instance and serves ``infer`` requests."""

    def __init__(self, context, process=None,
                 infer: Optional[Callable[[Dict], Dict]] = None):
        context.protocol = context.protocol or REPLICA_PROTOCOL
        super().__init__(context, process)
        self._infer = infer or (lambda payload: payload)
        self._command_handlers["infer"] = self._wire_infer
        _register_unsupported_adapter_commands(self)
        self.share["requests_served"] = 0

    def _wire_infer(self, request_id, response_topic, payload=None):
        inputs = decode_swag(payload or {})
        try:
            outputs = self._infer(inputs)
        except Exception:  # noqa: BLE001 - a bad request must not kill us
            self.logger.exception("%s: infer failed for %s", self.name,
                                  request_id)
            outputs = {"error": "infer_failed"}
        self.share["requests_served"] += 1
        if self.ec_producer is not None:
            self.ec_producer.update("requests_served",
                                    self.share["requests_served"])
        self.process.message.publish(
            response_topic,
            generate("infer_response",
                     [str(request_id), encode_swag(outputs)]))
