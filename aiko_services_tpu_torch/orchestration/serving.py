"""Data-parallel model replica serving.

The port's copy of ``aiko_services_tpu/orchestration/serving.py``:

- :class:`ModelReplica` — an Actor hosting one model instance.  Wire
  protocol: ``(infer request_id response_topic (payload…))`` → runs the
  model, publishes ``(infer_response request_id (outputs…))`` to
  ``response_topic``.  :class:`~.continuous.ContinuousReplica` speaks the
  same protocol over a continuous batch.
- :class:`ReplicaRouter` — an Actor that discovers replicas through the
  ServicesCache (by protocol), load-balances requests (power-of-two-
  choices over replica-published queue depth, round-robin while load is
  unknown), routes by prefix over the replicas' advertised KV digests
  (HBM, host and disk tiers priced apart, adapter affinity), and prunes
  replicas the moment the Registrar evicts them (LWT death or lease
  expiry).  Requests OUTLIVE replicas: the router proxies responses
  through its own reply topic, tracks every in-flight request, and on
  replica death or health-state change re-dispatches the stranded work
  to a survivor with bounded exponential backoff + jitter.  Greedy
  requests replay idempotently from the prompt; streaming clients get
  token-offset dedup, so no token is ever delivered twice.  When every
  candidate replica is saturated the router sheds explicitly
  (``error="overloaded"`` + ``retry_after_ms``).  It also drives live
  migration (:mod:`.migration`) and disaggregated prefill, and fans the
  ``capture`` / ``profile`` / ``census`` operator commands out to the
  fleet (a port replica answers ``(profile)`` and ``(census)`` with
  ``unsupported``: the device-profile bracket and the pool census are
  not ported yet).
- The operator telemetry projection (:data:`TELEMETRY_KEYS`,
  :func:`serving_telemetry`) and the ``ModelReplica`` factories
  :func:`make_llama_infer` and :func:`make_speculative_infer` on the
  port's ``llama`` and ``speculative``.

Payloads are swag-codec dicts (numpy arrays travel as typed tags), so
token tensors cross process boundaries losslessly.
"""

from __future__ import annotations

import random
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs import flight, trace
from ..obs.metrics import CounterDict, Histogram
from ..pipeline.codec import decode_swag, decode_value, encode_swag
from ..registry.services_cache import services_cache_create_singleton
from ..runtime.actor import Actor
from ..runtime.service import ServiceFilter
from ..utils.sexpr import generate, parse

__all__ = ["ModelReplica", "ReplicaRouter", "REPLICA_PROTOCOL",
           "RETRIABLE_ERRORS", "ROUTER_PROTOCOL", "TELEMETRY_KEYS",
           "make_llama_infer", "make_speculative_infer",
           "make_constrained_infer", "serving_telemetry"]

REPLICA_PROTOCOL = "model_replica:0"
ROUTER_PROTOCOL = "replica_router:0"

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


class ReplicaRouter(Actor):
    """Discovers :class:`ModelReplica` services, load-balances
    ``infer`` requests across the live set, and guarantees that a
    request outlives the replica serving it.

    Survivability machinery (each piece off the hot path until a
    failure actually happens):

    * Responses are PROXIED: replicas answer on the router's reply
      topic, the router forwards to the client — this is what lets it
      observe completion (in-flight tracking), dedup re-played
      streaming tokens by offset, and intercept retriable errors.
    * Registrar eviction (LWT death) or a replica flipping its shared
      ``lifecycle`` to ``unhealthy`` re-dispatches that replica's
      in-flight requests to survivors with bounded exponential
      backoff + seeded jitter (``backoff_base_s``·2^attempt, capped;
      ``max_redispatch`` attempts, then ``error="redispatch_failed"``).
    * Routing is power-of-two-choices over replica-published
      ``queue_depth`` (watched passively off each replica's EC-share
      state topic — no lease held); while no load is known it is exact
      round-robin.  When every candidate sits at ``shed_queue_depth``
      or beyond, the request sheds immediately with
      ``error="overloaded"`` and a ``retry_after_ms`` hint.
    """

    def __init__(self, context, process=None,
                 replica_protocol: str = REPLICA_PROTOCOL,
                 shed_queue_depth: int = 32,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0,
                 max_redispatch: int = 4, seed: int = 0,
                 prefix_alpha: float = 1.0,
                 host_prefix_weight: float = 0.5,
                 disk_prefix_weight: float = 0.25,
                 adapter_affinity: float = 1.0,
                 kv_transfer: bool = False,
                 disaggregate: bool = False,
                 directory_lease_s: float = 30.0,
                 anomaly_interval_s: float = 2.0):
        context.protocol = context.protocol or ROUTER_PROTOCOL
        super().__init__(context, process)
        self._replicas: List[str] = []   # replica topic paths, stable order
        self._next = 0
        self._command_handlers["infer"] = self.route
        self._command_handlers["infer_cancel"] = self._route_cancel
        _register_unsupported_adapter_commands(self)
        self.shed_queue_depth = shed_queue_depth
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.max_redispatch = max_redispatch
        #: Prefix-aware scoring weight: a candidate's score is
        #: ``queue_depth − prefix_alpha · matched_prefix_blocks``
        #: (lower wins).  0 disables prefix routing entirely (plain
        #: load balancing); with no directory match the route falls
        #: back to exact P2C regardless.
        self.prefix_alpha = prefix_alpha
        #: Value of a HOST-tier matched block relative to an HBM one
        #: (tiered KV cache): an advertised block that needs a restore
        #: upload before decode can read it scores ``host_prefix_weight
        #: · prefix_alpha`` instead of ``prefix_alpha``.  The default
        #: 0.5 prices a restore below an HBM hit but well above a
        #: recompute (weight 0); 1.0 ignores tier entirely.
        self.host_prefix_weight = host_prefix_weight
        #: Value of a DISK-tier (spilled) matched block: the restore
        #: pays an SSD read on top of the upload, so the default 0.25
        #: prices it below a host hit and still above a recompute —
        #: the tower's full ordering HBM > host > disk > nothing.
        self.disk_prefix_weight = disk_prefix_weight
        #: Adapter-locality weight (multi-tenant LoRA serving): a
        #: candidate whose digest advertises the request's adapter
        #: scores an extra ``adapter_affinity`` when the factors sit
        #: in HBM, discounted by ``host_prefix_weight`` /
        #: ``disk_prefix_weight`` for demoted/spilled copies — the
        #: same tier pricing as prefix blocks, because restoring a
        #: paged adapter rides the same promotion machinery.  A warm
        #: adapter ANYWHERE beats a cold one: when no prefix matches
        #: at all, the route still prefers a warm-adapter replica over
        #: plain P2C.  0 disables adapter-aware routing (adapter-blind
        #: baseline for the loadgen A/B).
        self.adapter_affinity = adapter_affinity
        #: Attach ``kv_source`` warm-start hints when the prefix
        #: owner is not the chosen target (opt-in: transfers cost
        #: wire bytes; prefix AFFINITY alone is free).
        self.kv_transfer = kv_transfer
        #: Opt-in disaggregated serving: requests prefill on a
        #: ``prefill``-role replica first, then decode on a decode
        #: replica that pulls the prefix.  Requires ``kv_transfer``
        #: semantics regardless of the flag.
        self.disaggregate = disaggregate
        from ..kvstore.directory import PrefixDirectory
        self.directory = PrefixDirectory(lease_s=directory_lease_s)
        self._rng = random.Random(seed)
        #: request_id -> replica topic path, so infer_cancel follows
        #: its request to the SAME replica.  Bounded ring evicting the
        #: OLDEST ROUTED id: a cancel for an aged-out id resolves with
        #: ``error="cancel_unrouted"``, so size the ring well above the
        #: maximum in-flight window (entries are two short strings
        #: each).  Entries persist after completion: a cancel lost in
        #: transit can be retried.
        self._routed: "OrderedDict[str, str]" = OrderedDict()
        self._routed_limit = 65536
        #: request_id -> live routing record (replica, client topic,
        #: original payload, delivery offsets, attempts).  Unlike
        #: ``_routed`` this IS completion-aware — entries leave when
        #: the terminal response forwards.  Bounded as a safety net
        #: against clients that never complete.
        self._inflight: "OrderedDict[str, Dict]" = OrderedDict()
        self._inflight_limit = 4096
        #: replica topic path -> latest load numbers parsed off its
        #: EC-share state topic (passive watch; no lease).
        self._loads: Dict[str, Dict] = {}
        self._unhealthy: set = set()
        #: replica topic paths mid graceful drain (``lifecycle`` flip
        #: to ``retiring``, usually by the autoscaler): excluded from
        #: NEW routing immediately, but — unlike ``_unhealthy`` — their
        #: in-flight requests are left to finish in place.  Death while
        #: retiring falls through to the normal re-dispatch path, so
        #: drain + kill still loses nothing.
        self._retiring: set = set()
        #: replica topic path -> {phase: encoded histogram string}
        #: parsed off EC-share ``hist.*`` broadcasts — the mergeable
        #: replacements for sampling one replica's nearest-rank p95.
        self._replica_hists: Dict[str, Dict[str, str]] = {}
        self.counters: Dict[str, int] = CounterDict(dict(
            redispatches=0, replica_deaths_observed=0, shed=0,
            deadline_exceeded=0, cancel_unrouted=0,
            prefix_routed=0, prefix_routed_host=0,
            prefix_routed_disk=0, kv_tier_hints=0, kv_remote_hints=0,
            adapter_warm_routes=0, adapter_cold_routes=0,
            anomaly_flags=0, fleet_captures=0, fleet_profiles=0,
            fleet_steady_compiles=0, fleet_censuses=0,
            fleet_audit_violations=0,
            migrations_started=0, migrations_completed=0,
            migrations_aborted=0, migration_blocks_streamed=0),
            prefix="router", labels={"actor": self.name})
        #: replica topic path -> last steady-state compile count
        #: broadcast (``compiles_steady_state`` from a JAX replica,
        #: ``graph_captures_steady_state`` from a port replica); a DELTA
        #: is a bucket-discipline breach somewhere in the fleet —
        #: flagged as an anomaly + fleet capture.
        self._steady_compiles: Dict[str, int] = {}
        #: replica topic path -> {kv_hbm_bytes, kv_host_bytes,
        #: kv_disk_bytes} parsed off EC broadcasts; folded into
        #: ``fleet_kv_<tier>_bytes`` share keys for the dashboard's
        #: fleet memory pane.
        self._replica_memory: Dict[str, Dict[str, int]] = {}
        #: replica topic path -> last kv_audit_violations broadcast;
        #: a DELTA means a replica's pool auditor caught the
        #: accountant disagreeing with ground truth — anomaly + fleet
        #: capture, exactly like a steady-state compile.
        self._audit_violations: Dict[str, int] = {}
        self.share["replicas"] = 0
        self.share["replicas_retiring"] = 0
        self.share["requests_routed"] = 0
        self.share["kv_directory_size"] = 0
        self.share.update(self.counters)
        #: replicas answer here; _on_reply forwards to the client.
        self.topic_reply = f"{self.topic_path}/reply"
        self.process.add_message_handler(self._on_reply,
                                         self.topic_reply)
        #: Live-migration machinery (drain-free replica replacement):
        #: destination replies arrive on a DISTINCT topic keyed by
        #: migration id, which is what attributes them during the
        #: double-delivery window.
        from .migration import MigrationController
        self.migration = MigrationController(self)
        self.topic_migrate = f"{self.topic_path}/migrate"
        self.process.add_message_handler(self._on_migrate_reply,
                                         self.topic_migrate)
        self._command_handlers["migrate"] = self._wire_migrate
        self.share["migration_cutover_ms"] = 0.0
        self._cache = services_cache_create_singleton(self.process)
        self._cache.add_handler(
            ServiceFilter(protocol=replica_protocol),
            self._replica_added, self._replica_removed)
        #: Per-window p95 drift over the EXACT fleet merges — delta
        #: histograms (element-wise count subtraction) flag drift
        #: BEFORE the autoscaler's SLO hard-trip.  0 disables the
        #: timer entirely.
        self.anomaly_interval_s = float(anomaly_interval_s)
        self._drift = flight.P95DriftDetector()
        self._anomaly_phases = ("ttft", "total")
        self.share["last_anomaly"] = ""
        if self.anomaly_interval_s > 0:
            self.process.event.add_timer_handler(
                self._anomaly_tick, self.anomaly_interval_s)

    # -- membership & health ---------------------------------------- #

    def _replica_added(self, fields):
        if fields.topic_path not in self._replicas:
            self._replicas.append(fields.topic_path)
            self._replicas.sort()
            # Passive load watch: the replica's ECProducer broadcasts
            # every share mutation on its state topic; queue depth and
            # lifecycle arrive without holding a lease.
            self.process.add_message_handler(
                self._replica_state, f"{fields.topic_path}/state")
            self._update_share()
            self.logger.info("%s: replica up %s (%d live)", self.name,
                             fields.topic_path, len(self._replicas))

    def _replica_removed(self, fields):
        if fields.topic_path in self._replicas:
            self._replicas.remove(fields.topic_path)
            self.process.remove_message_handler(
                self._replica_state, f"{fields.topic_path}/state")
            self._loads.pop(fields.topic_path, None)
            self._replica_hists.pop(fields.topic_path, None)
            self._steady_compiles.pop(fields.topic_path, None)
            self._audit_violations.pop(fields.topic_path, None)
            if self._replica_memory.pop(fields.topic_path, None):
                self._publish_fleet_memory()
            self._unhealthy.discard(fields.topic_path)
            self._set_retiring(fields.topic_path, False)
            # A dead owner's advertised prefixes must stop attracting
            # routes IMMEDIATELY — survivors recompute (in-flight
            # fetches against it time out into local prefill).
            self.directory.evict_replica(fields.topic_path)
            self._update_directory_share()
            self._bump("replica_deaths_observed")
            self._update_share()
            self.logger.info("%s: replica down %s (%d live)", self.name,
                             fields.topic_path, len(self._replicas))
            self._drain_replica(fields.topic_path)

    def _replica_state(self, topic: str, payload: str):
        """EC-share broadcast off a replica's state topic:
        ``(update|add key value)``.  Load keys feed P2C routing;
        a ``lifecycle`` flip to ``unhealthy`` drains the replica."""
        try:
            command, params = parse(payload)
        except Exception:
            return
        if command not in ("update", "add") or len(params) < 2:
            return
        replica = topic[:-len("/state")]
        key, value = str(params[0]), params[1]
        if key in ("queue_depth", "slots_active", "free_slots",
                   "free_blocks", "slots"):
            try:
                self._loads.setdefault(replica, {})[key] = int(value)
            except (TypeError, ValueError):
                pass
        elif key == "kv_prefixes":
            now = self.process.event.now()
            if self.directory.update(replica, str(value), now):
                self.directory.purge_expired(now)
                self._update_directory_share()
        elif key.startswith("hist."):
            self._replica_hists.setdefault(
                replica, {})[key[len("hist."):]] = str(value)
            self._publish_fleet_latency(key[len("hist."):])
        elif key in ("compiles_steady_state",
                     "graph_captures_steady_state"):
            self._watch_steady_compiles(replica, value)
        elif key in ("kv_hbm_bytes", "kv_host_bytes", "kv_disk_bytes"):
            try:
                self._replica_memory.setdefault(
                    replica, {})[key] = int(value)
            except (TypeError, ValueError):
                return
            self._publish_fleet_memory()
        elif key == "kv_audit_violations":
            self._watch_audit_violations(replica, value)
        elif key == "healthy":
            self._set_health(replica, str(value) not in ("0", "False"))
        elif key == "lifecycle":
            self._set_retiring(replica, str(value) == "retiring")
            self._set_health(replica, str(value) != "unhealthy")

    def _update_directory_share(self):
        size = self.directory.size
        if self.ec_producer is not None:
            self.ec_producer.update_if_changed("kv_directory_size", size)
        self.share["kv_directory_size"] = size

    def _set_retiring(self, replica: str, retiring: bool):
        """Graceful-drain membership: a retiring replica NEVER receives
        a new route (ARCHITECTURE invariant 8) but keeps its in-flight
        work — the drain's whole point is letting that work finish
        instead of re-dispatch-replaying it."""
        if retiring == (replica in self._retiring):
            return
        if retiring:
            self._retiring.add(replica)
            # Its cached prefixes must stop attracting routes too.
            self.directory.evict_replica(replica)
            self._update_directory_share()
            self.logger.info("%s: replica %s retiring — no new routes",
                             self.name, replica)
        else:
            self._retiring.discard(replica)
        self.share["replicas_retiring"] = len(self._retiring)
        if self.ec_producer is not None:
            self.ec_producer.update_if_changed(
                "replicas_retiring", len(self._retiring))

    def _set_health(self, replica: str, healthy: bool):
        if healthy:
            self._unhealthy.discard(replica)
            return
        if replica in self._unhealthy:
            return
        self._unhealthy.add(replica)
        self.directory.evict_replica(replica)
        self._update_directory_share()
        self.logger.warning("%s: replica %s unhealthy — draining",
                            self.name, replica)
        self._drain_replica(replica)

    def _candidates(self) -> List[str]:
        live = [r for r in self._replicas if r not in self._unhealthy
                and r not in self._retiring]
        if live:
            return live
        # A fleet that is ALL retiring still serves: the drain is an
        # operator intent, not a failure — better to extend one
        # replica's drain than to shed everything.
        live = [r for r in self._replicas if r not in self._unhealthy]
        # A fleet that is ALL unhealthy beats routing nowhere: the
        # watchdogged replica still answers (with a retriable error)
        # faster than a black hole.
        return live or list(self._replicas)

    def _update_share(self):
        self.share["replicas"] = len(self._replicas)
        if self.ec_producer is not None:
            self.ec_producer.update("replicas", len(self._replicas))

    def _bump(self, counter: str, by: int = 1):
        self.counters[counter] += by
        self.share[counter] = self.counters[counter]
        if self.ec_producer is not None:
            self.ec_producer.update(counter, self.counters[counter])

    # -- fleet latency (merged replica histograms) -------------------- #

    def fleet_histogram(self, phase: str) -> Histogram:
        """Merge every replica's ``hist.<phase>`` EC broadcast into one
        histogram — EXACT because the buckets are fixed process-wide,
        unlike sampling one replica's window."""
        merged = Histogram(name=f"fleet_{phase}")
        for hists in self._replica_hists.values():
            encoded = hists.get(phase)
            if not encoded:
                continue
            try:
                merged.merge(Histogram.decode(encoded))
            except (ValueError, IndexError):
                continue
        return merged

    def _publish_fleet_latency(self, phase: str):
        """Fleet p50/p95/p99 for the phase that just updated, into the
        router's own share (dashboard + loadgen read these)."""
        merged = self.fleet_histogram(phase)
        if not merged.count:
            return
        for label, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
            key = f"fleet_{phase}_{label}_ms"
            value = round(merged.quantile(q), 2)
            self.share[key] = value
            if self.ec_producer is not None:
                self.ec_producer.update_if_changed(key, value)

    # -- fleet memory (merged replica census digests) ----------------- #

    def _publish_fleet_memory(self):
        """Fold every replica's broadcast per-tier KV byte counters
        into ``fleet_kv_<tier>_bytes`` share keys — the live fleet
        memory pane.  Sums are exact because each replica's numbers
        come from its own pool counters, not a sample."""
        totals = {"kv_hbm_bytes": 0, "kv_host_bytes": 0,
                  "kv_disk_bytes": 0}
        for digest in self._replica_memory.values():
            for key in totals:
                totals[key] += int(digest.get(key, 0))
        for key, value in totals.items():
            share_key = f"fleet_{key}"
            self.share[share_key] = value
            if self.ec_producer is not None:
                self.ec_producer.update_if_changed(share_key, value)

    # -- anomaly detection & fleet capture ---------------------------- #

    def _anomaly_tick(self):
        """Per-window p95 drift check over the fleet merges.  A flag
        bumps ``anomaly_flags``, lands in the share for the dashboard,
        and fans a flight capture out fleet-wide — the early-warning
        record EXISTS by the time the SLO hard-trips."""
        for phase in self._anomaly_phases:
            merged = self.fleet_histogram(phase)
            if not merged.count:
                continue
            drift = self._drift.observe(phase, merged)
            if drift is None:
                continue
            self._bump("anomaly_flags")
            note = (f"{phase}: p95 {drift['p95_ms']:g}ms vs baseline "
                    f"{drift['baseline_ms']:g}ms "
                    f"({drift['ratio']:g}x, n={drift['window_count']})")
            self.share["last_anomaly"] = note
            if self.ec_producer is not None:
                self.ec_producer.update_if_changed("last_anomaly", note)
            self.logger.warning("%s: p95 drift — %s", self.name, note)
            self.capture(trigger="anomaly", reason=note)

    def _watch_steady_compiles(self, replica: str, value):
        """Steady-state compile watch: a replica's broadcast
        steady-state counter MOVING means it compiled something after
        its warm-up fence — a bucket-discipline regression in
        production.  A JAX replica broadcasts ``compiles_steady_state``
        (XLA compiles); a port replica broadcasts
        ``graph_captures_steady_state``, since on the card a CUDA graph
        capture after the fence is the port's steady-state compile.  A
        replica broadcasts one of the two, and either is treated
        exactly like p95 drift: anomaly flag, share note, fleet
        capture."""
        try:
            count = int(value)
        except (TypeError, ValueError):
            return
        previous = self._steady_compiles.get(replica, 0)
        self._steady_compiles[replica] = count
        if count <= previous:
            return
        self._bump("anomaly_flags")
        self._bump("fleet_steady_compiles", by=count - previous)
        note = (f"steady-state compile on {replica.rsplit('/', 1)[-1]}: "
                f"+{count - previous} (total {count})")
        self.share["last_anomaly"] = note
        if self.ec_producer is not None:
            self.ec_producer.update_if_changed("last_anomaly", note)
        self.logger.warning("%s: %s", self.name, note)
        self.capture(trigger="compile", reason=note)

    def _watch_audit_violations(self, replica: str, value):
        """Pool-audit watch: a replica's broadcast
        ``kv_audit_violations`` counter MOVING means its online
        auditor caught the memory accountant disagreeing with pool
        ground truth — invariant 16 held (serving is unaffected) but
        the books are wrong somewhere.  Treated exactly like p95
        drift: anomaly flag, share note, fleet capture (the breaching
        replica's bundle carries its full census)."""
        try:
            count = int(value)
        except (TypeError, ValueError):
            return
        previous = self._audit_violations.get(replica, 0)
        self._audit_violations[replica] = count
        if count <= previous:
            return
        self._bump("anomaly_flags")
        self._bump("fleet_audit_violations", by=count - previous)
        note = (f"pool audit violation on {replica.rsplit('/', 1)[-1]}: "
                f"+{count - previous} (total {count})")
        self.share["last_anomaly"] = note
        if self.ec_producer is not None:
            self.ec_producer.update_if_changed("last_anomaly", note)
        self.logger.warning("%s: %s", self.name, note)
        self.capture(trigger="pool_audit", reason=note)

    def capture(self, trace_id: str = "", response_topic: str = "",
                trigger: str = "operator", reason: str = ""):
        """Router override of the actor built-in: capture locally AND
        fan the command out to every live replica with ONE shared
        trace id, so one anomaly (or one operator ``(capture)``)
        yields one fleet-wide bundle set that ``tools/doctor.py``
        groups back together."""
        trace_id = str(trace_id) or flight.new_trace_id()
        super().capture(trace_id=trace_id,
                        response_topic=response_topic,
                        trigger=trigger, reason=reason)
        for replica in list(self._replicas):
            self.process.message.publish(
                f"{replica}/in",
                generate("capture", [trace_id, str(response_topic),
                                     str(trigger),
                                     str(reason)
                                     or f"fleet capture via {self.name}"]))
        self._bump("fleet_captures")

    def profile(self, steps: int = 4, trace_id: str = "",
                response_topic: str = "", reason: str = ""):
        """Router override of the ``(profile …)`` built-in: fan the
        bracket request out to every live replica with ONE shared
        trace id (the router itself carries no engine, so the local
        built-in answers ``unsupported`` — the fan-out is the point).
        Each replica's bracket finishes into its own flight bundle;
        ``doctor`` groups the set by the shared trace id."""
        trace_id = str(trace_id) or flight.new_trace_id()
        super().profile(steps=steps, trace_id=trace_id,
                        response_topic=response_topic, reason=reason)
        for replica in list(self._replicas):
            self.process.message.publish(
                f"{replica}/in",
                generate("profile", [str(steps), trace_id,
                                     str(response_topic),
                                     str(reason)
                                     or f"fleet profile via {self.name}"]))
        self._bump("fleet_profiles")

    def census(self, trace_id: str = "", response_topic: str = "",
               reason: str = ""):
        """Router override of the ``(census …)`` built-in: snapshot
        locally (the router carries no pool, so its bundle documents
        the fleet counters) AND fan the command out to every live
        replica with ONE shared trace id — each replica dumps its
        pool census into its own bundle, and ``tools/doctor.py``
        groups the set back into one fleet memory report."""
        trace_id = str(trace_id) or flight.new_trace_id()
        super().census(trace_id=trace_id,
                       response_topic=response_topic, reason=reason)
        for replica in list(self._replicas):
            self.process.message.publish(
                f"{replica}/in",
                generate("census", [trace_id, str(response_topic),
                                    str(reason)
                                    or f"fleet census via {self.name}"]))
        self._bump("fleet_censuses")

    # -- tracing ------------------------------------------------------ #

    @staticmethod
    def _trace_ctx(payload) -> Optional[str]:
        """Propagated trace context out of an ENCODED swag (the route
        hot path never decodes the full payload)."""
        carrier = (payload or {}).get("trace")
        if not carrier:
            return None
        try:
            return str(decode_value(str(carrier)))
        except Exception:  # noqa: BLE001 - junk context → no parent
            return None

    def _finish_trace(self, request_id: str, entry: Dict, swag):
        """Terminal response passing through the proxy: close the
        route span, merge the replica's ride-back spans with the
        router's own, and return a REBUILT response payload carrying
        the combined ``trace_spans``.  Only called when this request
        actually has router spans — untraced requests forward the
        replica's payload byte-identical."""
        spans = entry.get("spans") or []
        route_span = entry.get("route_span")
        if route_span is not None and trace.TRACER is not None:
            trace.TRACER.finish(route_span)
        try:
            outputs = decode_swag(swag)
        except Exception:  # noqa: BLE001 - corrupt stays corrupt
            return None
        remote = outputs.get("trace_spans")
        combined = (trace.decode_spans(remote) if remote else [])
        combined += [span for span in spans if span.end is not None]
        outputs["trace_spans"] = trace.encode_spans(combined)
        return generate("infer_response",
                        [request_id, encode_swag(outputs)])

    # -- routing ----------------------------------------------------- #

    def _pick(self, candidates: List[str]) -> str:
        """Power-of-two-choices by reported queue depth; exact
        round-robin while load is unknown (cold start, static
        ModelReplica fleets that publish no queue_depth)."""
        known = [r for r in candidates if "queue_depth"
                 in self._loads.get(r, ())]
        if len(known) < 2 or len(known) < len(candidates):
            target = candidates[self._next % len(candidates)]
            self._next += 1
            return target
        first, second = self._rng.sample(known, 2)
        return first if (self._loads[first]["queue_depth"]
                         <= self._loads[second]["queue_depth"]) else second

    # -- prefix-aware routing (kvstore directory) -------------------- #

    def _decode_candidates(self, candidates: List[str]) -> List[str]:
        """Exclude dedicated PREFILL replicas from decode routing —
        they clamp generation to one token.  A fleet that is ALL
        prefill still serves (degraded) rather than black-holing."""
        decode = [r for r in candidates
                  if self.directory.role(r) != "prefill"]
        return decode or candidates

    def _prefill_candidates(self) -> List[str]:
        return [r for r in self._candidates()
                if self.directory.role(r) == "prefill"]

    def _prompt_keys(self, payload) -> Dict[int, List[str]]:
        """Directory-width chain keys of the request's prompt, one
        list per block size advertised in the fleet (usually one).
        Decodes only the ``tokens`` entry of the swag — and only when
        a directory exists to match against."""
        from ..kvstore.directory import chain_keys_hex
        try:
            tokens = np.asarray(
                decode_value(payload["tokens"])).reshape(-1)
        except Exception:  # noqa: BLE001 - malformed → no prefix info
            return {}
        sizes = {self.directory.block_size(r)
                 for r in self.directory.replicas()}
        return {bs: chain_keys_hex(tokens, bs)
                for bs in sizes if bs}

    def _request_adapter_hex(self, payload) -> Optional[str]:
        """Directory-width root key of the request's named adapter
        (``payload["adapter"]``), or None for base-model requests —
        the name alone determines the key (kvstore/adapters.py), so
        the router never needs the factor bytes."""
        if not payload or "adapter" not in payload:
            return None
        try:
            name = decode_value(payload["adapter"])
        except Exception:  # noqa: BLE001 - malformed → adapter-blind
            return None
        if not name:
            return None
        from ..kvstore.adapters import adapter_hex
        return adapter_hex(str(name))

    def _adapter_weights(self, candidates: List[str],
                         adapter_hex: str, now) -> Dict[str, float]:
        """Tier-weighted warmth of one adapter per candidate: 1.0 for
        factors advertised in HBM, ``host_prefix_weight`` /
        ``disk_prefix_weight`` for demoted / spilled copies, 0.0 when
        the replica has no paged copy at all."""
        tier_weight = (1.0, self.host_prefix_weight,
                       self.disk_prefix_weight)
        weights = {}
        for replica in candidates:
            tier = self.directory.adapter_tier(replica, adapter_hex,
                                               now)
            weights[replica] = tier_weight[tier] \
                if tier is not None and tier < 3 else 0.0
        return weights

    def _pick_prefix(self, candidates: List[str], payload,
                     adapter_weights: Optional[Dict[str, float]]
                     = None):
        """Score ``queue_depth − α·effective_matched_blocks −
        adapter_affinity·adapter_warmth`` (lower wins; ties break by
        replica order for determinism), where a matched block
        advertised in the HOST tier contributes
        ``host_prefix_weight`` of an HBM block and one in the DISK
        tier ``disk_prefix_weight`` — each rung of the tower is
        cheaper than a recompute but dearer than the rung above, and
        the placement decision should reflect that.  Returns
        ``(target, owner, owner_matched, target_matched,
        target_host_matched, target_disk_matched)`` or None when
        nothing matches — the caller falls back to an adapter-only
        pick (warm adapter, no prefix) and then EXACT P2C, so fleets
        without paged prefix caches see plain load balancing."""
        if self.prefix_alpha <= 0 or not payload \
                or not self.directory.size:
            return None
        keys_by_bs = self._prompt_keys(payload)
        if not keys_by_bs:
            return None
        now = self.process.event.now()
        matched, host, disk = {}, {}, {}
        for replica in candidates:
            keys = keys_by_bs.get(self.directory.block_size(replica))
            # A replica mid-migration (digest ``/migrating`` flag) is
            # on its way OUT: plain P2C may still use it, but scoring
            # it for NEW prefix placement would anchor fresh chains to
            # a replica about to retire.
            if keys and self.directory.migrating(replica):
                keys = None
            matched[replica], host[replica], disk[replica] = \
                self.directory.matched_tiers(replica, keys, now) \
                if keys else (0, 0, 0)
        if not any(matched.values()):
            return None

        def effective(replica):
            return matched[replica] \
                - (1.0 - self.host_prefix_weight) * host[replica] \
                - (1.0 - self.disk_prefix_weight) * disk[replica]

        def score(replica):
            depth = self._loads.get(replica, {}).get("queue_depth", 0)
            warmth = adapter_weights.get(replica, 0.0) \
                if adapter_weights else 0.0
            return depth - self.prefix_alpha * effective(replica) \
                - self.adapter_affinity * warmth

        target = min(candidates, key=lambda r: (score(r), r))
        owner = max(candidates,
                    key=lambda r: (effective(r), matched[r], r))
        return (target, owner, matched[owner], matched[target],
                host[target], disk[target])

    def _saturated(self, candidates: List[str]) -> bool:
        """True only when EVERY candidate reports a queue at or past
        the shed threshold — unknown load never sheds."""
        if not candidates:
            return False
        return all(
            self._loads.get(r, {}).get("queue_depth", -1)
            >= self.shed_queue_depth for r in candidates)

    def _shed(self, request_id, response_topic, error: str,
              retry_after_ms: Optional[int] = None, parent=None):
        """Terminal rejection published straight to the client — a
        future must ALWAYS resolve; a silent drop would leave it
        hanging."""
        if error == "overloaded":
            self._bump("shed")
        elif error == "deadline_exceeded":
            self._bump("deadline_exceeded")
        outputs: Dict = {"error": error}
        if retry_after_ms is not None:
            outputs["retry_after_ms"] = int(retry_after_ms)
        if trace.TRACER is not None and parent is not None:
            span = trace.TRACER.start_span(
                "shed", parent=parent,
                attrs={"request_id": str(request_id), "error": error})
            trace.TRACER.finish(span)
            outputs["trace_spans"] = trace.encode_spans([span])
        if response_topic:
            self.process.message.publish(
                str(response_topic),
                generate("infer_response",
                         [str(request_id), encode_swag(outputs)]))

    def route(self, request_id, response_topic, payload=None) -> bool:
        """Dispatch one request to a live replica and begin tracking
        it.  Returns False when no replicas are live — the request
        then sheds with ``error="overloaded"`` so the caller's future
        resolves instead of hanging."""
        request_id = str(request_id)
        ctx = None
        if trace.TRACER is not None:
            ctx = self._trace_ctx(payload)
        if not self._replicas:
            self.logger.warning("%s: no live replicas for %s",
                                self.name, request_id)
            self._shed(request_id, response_topic, "overloaded",
                       retry_after_ms=1000, parent=ctx)
            return False
        candidates = self._candidates()
        if self._saturated(candidates):
            depths = [self._loads[r]["queue_depth"] for r in candidates]
            self._shed(request_id, response_topic, "overloaded",
                       retry_after_ms=min(5000, 50 * min(depths)),
                       parent=ctx)
            return False
        decode = self._decode_candidates(candidates)
        adapter_hex = self._request_adapter_hex(payload) \
            if self.adapter_affinity > 0 else None
        adapter_weights = None
        if adapter_hex is not None and self.directory.size:
            weights = self._adapter_weights(
                decode, adapter_hex, self.process.event.now())
            warm = [r for r in decode if weights.get(r, 0.0) > 0]
            if warm:
                # A cold landing is not a SLOW request but a FAILED
                # one (``unknown_adapter`` → the tenant re-uploads
                # factors), so adapter warmth is a hard preference,
                # not a score bonus load can outbid: restrict the
                # candidate set to warm replicas and let prefix
                # affinity, load, and tier order THEM — zero cold
                # starts whenever the adapter is warm anywhere.
                decode = warm
                adapter_weights = weights
            # Cold everywhere: route blind — any replica costs the
            # same upload.
        picked = self._pick_prefix(decode, payload, adapter_weights)
        if picked is None:
            if adapter_weights:
                # No prefix match: among the warm replicas, trade
                # queue depth against the copy's tier (an HBM-resident
                # adapter beats one needing a restore from host/disk).
                target = min(decode, key=lambda r: (
                    self._loads.get(r, {}).get("queue_depth", 0)
                    - self.adapter_affinity * adapter_weights[r], r))
            else:
                target = self._pick(decode)
            owner = owner_matched = target_matched = None
            target_host = target_disk = 0
        else:
            (target, owner, owner_matched, target_matched,
             target_host, target_disk) = picked
            self._bump("prefix_routed")
            if target_host:
                # The chosen target's match includes demoted blocks —
                # this request will trigger (or ride) a restore there.
                self._bump("prefix_routed_host")
            if target_disk:
                self._bump("prefix_routed_disk")
        if adapter_hex is not None:
            # Provenance of every adapter-tagged route: did the chosen
            # target already hold the factors (any tier), or does this
            # request pay the cold-start?  The loadgen A/B asserts the
            # aware router's cold count is ZERO when the adapter is
            # warm anywhere in the fleet.
            if adapter_weights is not None \
                    and adapter_weights.get(target, 0.0) > 0:
                self._bump("adapter_warm_routes")
            else:
                self._bump("adapter_cold_routes")
        send_payload = payload or {}
        if target_host or target_disk:
            # Tier-aware prefetch: tell the target NOW that this
            # request lands on a demoted/spilled chain, so it begins
            # the async promotion while the request rides the wire and
            # the queue — instead of at the admission walk's deferral.
            send_payload = dict(send_payload)
            send_payload["kv_tier_hint"] = "i:1"
            self._bump("kv_tier_hints")
        phase = "decode"
        if self.kv_transfer and owner is not None \
                and owner != target and owner_matched > (
                    target_matched or 0):
            # Load won over affinity — hint the target to PULL the
            # owner's blocks instead of recomputing the prefix.
            send_payload = dict(send_payload)
            send_payload["kv_source"] = f"s:{owner}"
            self._bump("kv_remote_hints")
        elif self.disaggregate and self.kv_transfer:
            prefill = [r for r in self._prefill_candidates()
                       if r in candidates]
            if prefill and target not in prefill:
                # Two-phase: prefill replica computes the prompt KV,
                # the decode target pulls it (see _begin_decode_phase).
                phase = "prefill"
                prefill_target = self._pick(prefill)
                send_payload = dict(send_payload)
                send_payload["prefill_only"] = "i:1"
                target = prefill_target
        route_span = None
        if trace.TRACER is not None:
            # The route span OPENS here and closes when the terminal
            # response passes back through the proxy — it measures the
            # request's routed lifetime; redispatch/shed spans nest
            # under it.
            route_span = trace.TRACER.start_span(
                "route", parent=ctx,
                attrs={"request_id": request_id, "target": target,
                       "phase": phase})
            if owner_matched:
                route_span.set_attr("prefix_matched",
                                    int(owner_matched))
            send_payload = dict(send_payload)
            send_payload["trace"] = f"s:{trace.inject(route_span)}"
        self._routed[request_id] = target
        while len(self._routed) > self._routed_limit:
            self._routed.popitem(last=False)
        self._inflight[request_id] = dict(
            replica=target, client_topic=str(response_topic),
            payload=payload or {}, attempts=0, delivered=0,
            replica_sent=0, routed_at=self.process.event.now(),
            deadline_ts=-1.0,    # -1 = not yet resolved from payload
            phase=phase, route_span=route_span,
            # Every token delivered to the client, in order — the
            # migration resume's carried context (len == delivered).
            tokens=[], migration=None,
            spans=[route_span] if route_span is not None else None)
        while len(self._inflight) > self._inflight_limit:
            dropped_id, _ = self._inflight.popitem(last=False)
            self.logger.warning(
                "%s: in-flight table full, dropping tracking for %s "
                "(request still routed; no re-dispatch protection)",
                self.name, dropped_id)
        self.process.message.publish(
            f"{target}/in",
            generate("infer", [request_id, self.topic_reply,
                               send_payload]))
        self.share["requests_routed"] += 1
        if self.ec_producer is not None:
            self.ec_producer.update("requests_routed",
                                    self.share["requests_routed"])
        return True

    # -- response proxy ---------------------------------------------- #

    def _on_reply(self, _topic: str, payload: str):
        """A replica answered on the reply topic: dedup + forward
        partials, intercept retriable errors, forward terminal
        responses and close out tracking."""
        try:
            command, params = parse(payload)
        except Exception:
            return
        if command not in ("infer_partial", "infer_response") \
                or len(params) < 2:
            return
        entry = self._inflight.get(str(params[0]))
        if entry is None:
            return        # already terminal (late reply after re-dispatch)
        if command == "infer_partial":
            self._forward_partial(str(params[0]), entry, params[1])
            return
        try:
            outputs = decode_swag(params[1])
            error = outputs.get("error")
        except Exception:
            error = None  # corrupt swag: client resolves corrupt_response
        if entry.get("migration") is not None \
                and self.migration.absorb_source_final(str(params[0]),
                                                       entry):
            # Post-cutover: the destination owns the stream now — the
            # source's terminal (cancel ack or a racing finish) is the
            # double-delivery window's tail and must not reach the
            # client.  Pre-cutover the call aborted the migration and
            # returned False: the terminal proceeds normally below.
            return
        if error is not None and str(error) in RETRIABLE_ERRORS \
                and entry["attempts"] < self.max_redispatch:
            # The REPLICA failed, not the request — move the work.
            self._schedule_redispatch(str(params[0]), entry)
            return
        if entry.get("phase") == "prefill":
            if error is not None and str(error) != "cancelled":
                # Prefill leg failed terminally: decode from scratch
                # on a decode replica (no kv hint) — the request still
                # MUST resolve.
                self._begin_decode_phase(str(params[0]), entry, None)
            elif error is None:
                self._begin_decode_phase(str(params[0]), entry,
                                         entry["replica"])
            else:             # cancelled: terminal for the client too
                self._inflight.pop(str(params[0]), None)
                self.process.message.publish(entry["client_topic"],
                                             payload)
            return
        self._inflight.pop(str(params[0]), None)
        if entry.get("spans"):
            rebuilt = self._finish_trace(str(params[0]), entry,
                                         params[1])
            if rebuilt is not None:
                payload = rebuilt
        self.process.message.publish(entry["client_topic"], payload)

    def _begin_decode_phase(self, request_id: str, entry: Dict,
                            prefill_replica: Optional[str]):
        """Second leg of disaggregated serving: the prefill replica
        finished (its 1-token answer is DISCARDED — the decode leg
        regenerates it from the transferred KV), now route the full
        request to a decode replica with a ``kv_source`` hint at the
        warm prefill cache.  ``prefill_replica=None`` means the
        prefill leg failed and decode recomputes locally."""
        entry["phase"] = "decode"
        entry["replica_sent"] = 0
        candidates = self._decode_candidates(self._candidates())
        picked = self._pick_prefix(candidates, entry["payload"])
        target = picked[0] if picked else self._pick(candidates)
        send_payload = entry["payload"]
        if prefill_replica is not None and self.kv_transfer \
                and target != prefill_replica:
            send_payload = dict(send_payload)
            send_payload["kv_source"] = f"s:{prefill_replica}"
            self._bump("kv_remote_hints")
        if trace.TRACER is not None and \
                entry.get("route_span") is not None:
            span = trace.TRACER.start_span(
                "decode_phase", parent=entry["route_span"],
                attrs={"request_id": request_id, "target": target})
            trace.TRACER.finish(span)
            entry["spans"].append(span)
            send_payload = dict(send_payload)
            send_payload["trace"] = \
                f"s:{trace.inject(entry['route_span'])}"
        entry["replica"] = target
        self._routed[request_id] = target
        self.process.message.publish(
            f"{target}/in",
            generate("infer", [request_id, self.topic_reply,
                               send_payload]))

    def _forward_partial(self, request_id: str, entry: Dict, swag):
        """Token-offset dedup: a re-dispatched greedy request replays
        from the prompt, so the new replica re-streams tokens the
        client already has — forward only the suffix past what was
        delivered."""
        if entry.get("phase") == "prefill":
            return    # prefill leg's token is regenerated by decode
        try:
            increment = [int(t) for t in
                         np.asarray(decode_swag(swag)["tokens_out"])]
        except Exception:
            return              # corrupt partial: drop (final is authoritative)
        sent = entry["replica_sent"]
        entry["replica_sent"] = sent + len(increment)
        skip = max(0, entry["delivered"] - sent)
        fresh = increment[skip:]
        if not fresh:
            return
        entry["delivered"] += len(fresh)
        entry["tokens"].extend(fresh)
        self.process.message.publish(
            entry["client_topic"],
            generate("infer_partial",
                     [request_id,
                      encode_swag({"tokens_out":
                                   np.asarray(fresh, np.int32)})]))

    # -- live migration (drain-free replica replacement) -------------- #

    def migrate_request(self, request_id: str,
                        dest: Optional[str] = None) -> bool:
        """Migrate ONE in-flight request to ``dest`` (default: best
        live candidate that is not the source).  Returns False when
        the request is unknown or unmigratable — the original stream
        is untouched either way."""
        request_id = str(request_id)
        entry = self._inflight.get(request_id)
        if entry is None:
            return False
        source = entry.get("replica")
        if dest is None:
            others = [r for r in self._candidates() if r != source]
            if not others:
                return False
            dest = self._pick(self._decode_candidates(others))
        return self.migration.start(request_id, entry, str(dest))

    def migrate_replica(self, source: str,
                        dest: Optional[str] = None) -> int:
        """Drain-free evacuation: migrate every eligible in-flight
        request off ``source``.  Returns the number of migrations
        started (requests that cannot migrate — grammar-constrained,
        prefill-leg, unknown budget — stay put and finish in place,
        exactly like a graceful drain)."""
        source = str(source)
        started = 0
        for request_id, entry in list(self._inflight.items()):
            if entry.get("replica") == source:
                started += self.migrate_request(
                    request_id, dest=dest)
        return started

    def _wire_migrate(self, source, dest=None, response_topic=None):
        """Wire command ``(migrate source [dest] [reply_topic])`` —
        the autoscaler's migrate action and operators use this to
        evacuate a replica without a drain hole."""
        started = self.migrate_replica(
            str(source), dest=None if dest in (None, "", "-")
            else str(dest))
        if response_topic:
            self.process.message.publish(
                str(response_topic),
                generate("migrate_response",
                         [str(source),
                          encode_swag({"started": started})]))

    def _on_migrate_reply(self, _topic: str, payload: str):
        """Migration side-channel: source ``migrate_ready`` acks and
        the DESTINATION's resume stream (partials + terminal), all
        keyed by migration id."""
        try:
            command, params = parse(payload)
        except Exception:
            return
        if len(params) < 2:
            return
        mid = str(params[0])
        if command == "migrate_ready":
            self.migration.on_ready(mid, params[1])
        elif command == "infer_partial":
            self.migration.on_dest_partial(mid, params[1])
        elif command == "infer_response":
            self.migration.on_dest_final(mid, params[1])

    # -- re-dispatch -------------------------------------------------- #

    def _drain_replica(self, replica: str):
        """Re-dispatch every in-flight request the dead/unhealthy
        replica holds.  Migration-aware: a migration whose DESTINATION
        died aborts (the source never stopped serving); one whose
        SOURCE died mid-transfer promotes the destination instead of
        replaying."""
        self.migration.on_replica_down(replica)
        for request_id, entry in list(self._inflight.items()):
            if entry["replica"] == replica:
                if entry.get("migration") is not None \
                        and self.migration.on_owner_lost(
                            request_id, entry, replica):
                    continue     # destination promoted — no replay
                self._schedule_redispatch(request_id, entry)

    def _schedule_redispatch(self, request_id: str, entry: Dict):
        """Arm a once-timer with bounded exponential backoff + seeded
        jitter (0.5–1.5×): failures are correlated — a thundering herd
        of instant retries onto the one survivor is how cascades
        start."""
        if entry.get("migration") is not None:
            # Replay supersedes any in-flight migration: the new
            # replica regenerates everything, so the half-moved chain
            # is worthless — tear it down (idempotent).
            self.migration.abort(request_id, entry, "redispatch")
        entry["replica"] = None
        delay = min(self.backoff_cap_s,
                    self.backoff_base_s * (2 ** entry["attempts"]))
        delay *= 0.5 + self._rng.random()
        self.process.event.add_timer_handler(
            lambda: self._redispatch(request_id), delay, once=True)

    def _redispatch(self, request_id: str):
        entry = self._inflight.get(request_id)
        if entry is None or entry["replica"] is not None:
            return    # completed, or another path already re-routed it
        if entry["deadline_ts"] < 0:
            entry["deadline_ts"] = self._resolve_deadline(entry)
        if entry["deadline_ts"] is not None and \
                self.process.event.now() >= entry["deadline_ts"]:
            self._inflight.pop(request_id, None)
            self._shed(request_id, entry["client_topic"],
                       "deadline_exceeded",
                       parent=entry.get("route_span"))
            return
        if entry["attempts"] >= self.max_redispatch:
            self._inflight.pop(request_id, None)
            self._shed(request_id, entry["client_topic"],
                       "redispatch_failed",
                       parent=entry.get("route_span"))
            return
        entry["attempts"] += 1
        # Re-dispatch prefers non-retiring survivors; a fleet that is
        # ALL retiring still absorbs stranded work (drain ≠ dead).
        live = [r for r in self._replicas if r not in self._unhealthy
                and r not in self._retiring] or \
               [r for r in self._replicas if r not in self._unhealthy]
        if not live:
            # Nothing to route to YET — back off again; the attempt
            # budget above bounds how long we hope.
            self._schedule_redispatch(request_id, entry)
            return
        if entry.get("phase") == "prefill":
            # The prefill leg died: demote to a plain single-phase
            # request on a decode survivor (recompute, no kv hint) —
            # the zero-lost guarantee outranks disaggregation.
            entry["phase"] = "decode"
        live = self._decode_candidates(live)
        picked = self._pick_prefix(live, entry["payload"])
        target = picked[0] if picked else self._pick(live)
        entry["replica"] = target
        entry["replica_sent"] = 0     # new replica replays from prompt
        self._routed[request_id] = target
        self._bump("redispatches")
        send_payload = entry["payload"]
        if trace.TRACER is not None and \
                entry.get("route_span") is not None:
            span = trace.TRACER.start_span(
                "redispatch", parent=entry["route_span"],
                attrs={"request_id": request_id, "target": target,
                       "attempt": entry["attempts"]})
            trace.TRACER.finish(span)
            entry["spans"].append(span)
            # Re-point the propagated context at the route span so the
            # NEW replica's spans still join this request's tree.
            send_payload = dict(send_payload)
            send_payload["trace"] = \
                f"s:{trace.inject(entry['route_span'])}"
        self.logger.info("%s: re-dispatching %s to %s (attempt %d)",
                         self.name, request_id, target,
                         entry["attempts"])
        self.process.message.publish(
            f"{target}/in",
            generate("infer", [request_id, self.topic_reply,
                               send_payload]))

    def _resolve_deadline(self, entry: Dict) -> Optional[float]:
        """Lazily decode the original payload's ``deadline_ms`` (only
        on the failure path — the route hot path never decodes swag).
        Approximates the client's budget as starting at route time."""
        try:
            deadline_ms = decode_swag(entry["payload"]).get(
                "deadline_ms")
        except Exception:
            return None
        if deadline_ms is None:
            return None
        return entry["routed_at"] + float(np.asarray(deadline_ms)) / 1e3

    # -- cancel ------------------------------------------------------- #

    def _route_cancel(self, request_id, response_topic=None) -> None:
        """Forward ``(infer_cancel id [reply_topic])`` to the replica
        currently holding the request (the live in-flight record wins
        over the routed-affinity ring — a re-dispatch may have moved
        it).  An unknown or aged-out id resolves the caller's future
        with ``error="cancel_unrouted"`` when a reply topic rides
        along, instead of leaving it to time out.  Affinity entries are
        KEPT after forwarding so a cancel lost in transit can be
        retried; request ids must be unique per client
        (``InferClient`` guarantees this)."""
        request_id = str(request_id)
        entry = self._inflight.get(request_id)
        target = entry["replica"] if entry is not None \
            else self._routed.get(request_id)
        if target is None:
            self.logger.info("%s: infer_cancel for unrouted id %s",
                             self.name, request_id)
            self._bump("cancel_unrouted")
            if response_topic:
                self.process.message.publish(
                    str(response_topic),
                    generate("infer_response",
                             [request_id,
                              encode_swag({"error":
                                           "cancel_unrouted"})]))
            return
        if entry is not None and entry.get("migration") is not None:
            # Both legs of a migrating request must die — the
            # destination's resume runs under the migration id.
            self.migration.cancel_dest(entry)
        self.process.message.publish(
            f"{target}/in",
            generate("infer_cancel", [request_id]))


def _coerce_request(inputs: Dict, config, default_new: int, device):
    """Shared request scaffolding for the infer factories: coerce the
    token array to (batch, prompt) on ``device``, clamp the generation
    budget to the model's max_seq_len.  Returns (tokens, prompt_len,
    new) or an error payload dict."""
    import torch

    tokens = torch.as_tensor(np.asarray(inputs["tokens"], np.int32),
                             device=device)
    if tokens.ndim == 1:
        tokens = tokens[None]
    prompt_len = tokens.shape[1]
    if prompt_len >= config.max_seq_len:
        # Reject cleanly: a cache shorter than the prompt would fail
        # deep inside prefill with an opaque shape error.
        return {"error": f"prompt_len {prompt_len} >= max_seq_len "
                         f"{config.max_seq_len}"}
    requested = int(np.asarray(inputs.get("max_new_tokens",
                                          default_new)))
    if requested <= 0:
        return {"error": f"max_new_tokens must be positive, got "
                         f"{requested}"}
    new = min(requested, config.max_seq_len - prompt_len)
    return tokens, prompt_len, new


def make_llama_infer(config_name: str = "tiny", quantize: bool = False,
                     max_new_tokens: int = 16, seed: int = 0,
                     quantize_kv: bool = False,
                     checkpoint: str = None, params=None,
                     device=None) -> Callable:
    """Build a ModelReplica ``infer`` callable running the flagship
    Llama-architecture model: ``{"tokens": (batch, prompt)}`` →
    ``{"tokens_out": (batch, prompt+new)}`` (greedy: a batch-1 or
    batched ``prefill`` + ``generate_tokens`` on a contiguous cache of
    the request's rows rounded up by :func:`~..ops.paged_attention.
    contiguous_rows`).

    ``params``: the weights to serve (a test passes bridged weights);
    without them, random weights from ``seed`` under the named config
    (int8 when ``quantize``).  ``device``: where the model runs — the
    card unless the caller names another.  ``checkpoint`` (serving
    trained weights from a safetensors directory) needs the weight
    importer's ``import_llama`` (item 9c), which is not ported yet."""
    import torch

    from ..device import resolve_device
    from ..models import llama
    from ..ops.paged_attention import contiguous_rows

    if checkpoint:
        raise NotImplementedError(
            "make_llama_infer(checkpoint=...) needs import_llama of "
            "tools/import_weights.py (ROADMAP queue 1 item 9c), which is not "
            "ported yet")
    device = resolve_device(device)
    config = llama.CONFIGS[config_name]
    if params is None:
        params = llama.init_params(config, seed=seed, device=device)
        if quantize:
            params = llama.quantize_params(params)

    def infer(inputs: Dict) -> Dict:
        request = _coerce_request(inputs, config, max_new_tokens, device)
        if isinstance(request, dict):
            return request
        tokens, prompt_len, new = request
        cache = llama.init_cache(config, tokens.shape[0],
                                 contiguous_rows(prompt_len + new),
                                 quantize_kv=quantize_kv, device=device)
        logits, cache = llama.prefill(params, tokens, cache, config)
        first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        generated, _ = llama.generate_tokens(params, first, cache,
                                             prompt_len, new - 1, config)
        return {"tokens_out": np.concatenate(
            [tokens.cpu().numpy(), first.cpu().numpy(),
             generated.cpu().numpy()], axis=1)}

    return infer


def make_speculative_infer(target_config="small", draft_config="tiny",
                           quantize: bool = False,
                           max_new_tokens: int = 16, k: int = 4,
                           seed: int = 0, draft_seed: int = 1,
                           target_params=None, draft_params=None,
                           device=None) -> Callable:
    """Build a ModelReplica ``infer`` callable running GREEDY speculative
    decoding (:func:`~..models.speculative.speculative_generate`): a draft
    model proposes ``k`` tokens and the target verifies them in one
    chunked-prefill pass, so the output is identical to target-only greedy
    decode and a router may mix speculative and plain replicas freely.

    ``target_config`` / ``draft_config``: ``CONFIGS`` names or
    :class:`~..models.llama.LlamaConfig` instances sharing a vocabulary.
    Weights: ``target_params`` / ``draft_params`` when given (a test passes
    bridged ones), else random from ``seed`` / ``draft_seed`` on
    ``device`` (the target int8 when ``quantize``).  ``device``: the card
    unless the caller names another.  Batch-1 requests only: speculation
    serves the low-batch latency regime, a ContinuousReplica the
    throughput one.  The answer carries ``tokens_out`` (prompt + new),
    ``acceptance_rate`` and ``tokens_per_target_pass``."""
    from ..device import resolve_device
    from ..models import llama
    from ..models.speculative import speculative_generate

    def resolve(config):
        return (llama.CONFIGS[config] if isinstance(config, str)
                else config)
    target_cfg = resolve(target_config)
    draft_cfg = resolve(draft_config)
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    device = resolve_device(device)
    if target_params is None:
        target_params = llama.init_params(target_cfg, seed=seed,
                                          device=device)
        if quantize:
            target_params = llama.quantize_params(target_params)
    if draft_params is None:
        draft_params = llama.init_params(draft_cfg, seed=draft_seed,
                                         device=device)

    def infer(inputs: Dict) -> Dict:
        prompt = np.asarray(inputs["tokens"], np.int32).reshape(-1)
        new = int(np.asarray(inputs.get("max_new_tokens",
                                        max_new_tokens)))
        # speculative_generate bounds by BOTH models' max_seq_len (the
        # draft runs the same positions).
        max_seq = min(target_cfg.max_seq_len, draft_cfg.max_seq_len)
        budget = max_seq - len(prompt) - k - 1
        if budget <= 0:
            return {"error": f"prompt_len {len(prompt)} too long for "
                             f"max_seq {max_seq} with k={k} "
                             "speculation"}
        new = min(new, budget)
        generated, stats = speculative_generate(
            target_params, draft_params, prompt, new, target_cfg,
            draft_cfg, k=k)
        return {"tokens_out": np.concatenate(
                    [prompt, np.asarray(generated, np.int32)])[None],
                "acceptance_rate": np.float32(stats.acceptance_rate),
                "tokens_per_target_pass": np.float32(
                    stats.tokens_per_target_pass)}

    return infer


def make_constrained_infer(config_name: str = "tiny", automaton=None,
                           quantize: bool = False,
                           max_new_tokens: int = 16, seed: int = 0,
                           temperature: float = 0.0, params=None,
                           device=None) -> Callable:
    """Build a ModelReplica ``infer`` callable whose outputs are guaranteed
    grammatical: a token DFA masks every decode step
    (:func:`~..models.constrained.constrained_generate`), so the replica
    can ONLY emit sequences the grammar accepts.  Responses carry
    ``tokens_out`` (each row the grammatical output followed by
    ``pad_token`` zeros once its state went terminal) and per-row
    ``accepted`` flags.

    ``params``: the weights to serve (a test passes bridged weights);
    without them random weights from ``seed`` (int8 when ``quantize``).
    ``device``: the card unless the caller names another.  A sampled
    request (``temperature`` > 0) draws from a generator seeded with the
    request's ``seed``."""
    import torch

    from ..device import resolve_device
    from ..models import llama
    from ..models.constrained import constrained_generate
    from ..ops.paged_attention import contiguous_rows

    if automaton is None:
        raise ValueError("make_constrained_infer requires automaton=")
    config = llama.CONFIGS[config_name]
    if automaton.vocab != config.vocab_size:
        raise ValueError(
            f"automaton vocab {automaton.vocab} != model vocab "
            f"{config.vocab_size}")
    device = resolve_device(device)
    if params is None:
        params = llama.init_params(config, seed=seed, device=device)
        if quantize:
            params = llama.quantize_params(params)
    # Device-resident once: re-uploading (n_states, vocab) masks per
    # request would put a host transfer on the serving path.
    allowed = torch.as_tensor(automaton.allowed, device=device)
    next_state = torch.as_tensor(automaton.next_state.astype(np.int64),
                                 device=device)

    def infer(inputs: Dict) -> Dict:
        request = _coerce_request(inputs, config, max_new_tokens, device)
        if isinstance(request, dict):
            return request
        tokens, prompt_len, new = request
        cache = llama.init_cache(config, tokens.shape[0],
                                 contiguous_rows(prompt_len + new),
                                 device=device)
        logits, cache = llama.prefill(params, tokens, cache, config)
        generator = torch.Generator(device=device).manual_seed(
            int(np.asarray(inputs.get("seed", 0))))
        out, states, _ = constrained_generate(
            params, logits[:, -1], cache, prompt_len, new, config, allowed,
            next_state, temperature=temperature, generator=generator)
        accepted = automaton.accepting[states.cpu().numpy()]
        return {"tokens_out": out.cpu().numpy(),
                "accepted": accepted.astype(np.int32)}

    return infer
