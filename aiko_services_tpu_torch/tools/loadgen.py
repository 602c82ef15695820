"""Serving load generator and the fleet rigs: drive replicas over the
wire, report tails.

The port's copy of ``aiko_services_tpu/tools/loadgen.py``:
:class:`LoadGenerator` and :class:`LoadReport`, the shared-prefix,
elastic and long-tail payloads, the diurnal trace, the fleet aggregation
helpers, the fault schedules, the in-process rigs and the CLI
(:func:`main`).  The rigs: :func:`run_shared_prefix` (prefix-aware
routing), :func:`run_chaos` (zero lost requests under a replica kill),
:func:`run_migration_chaos` (drain-free live migration, bit-exact against
a control run), :func:`run_elastic` / :func:`run_elastic_chaos` /
:func:`run_rolling_upgrade` (a fleet owned by the
:class:`~..orchestration.autoscaler.FleetAutoscaler`), :func:`run_longtail`
(the host tier's capacity A/B), :func:`run_restart` /
:func:`run_restart_ab` (a warm restart from the spill directory against a
cold one), :func:`run_structured` (grammar-constrained agentic traffic
with jump-forward, against the same payloads free) and
:func:`run_multitenant` (adapter-aware routing against adapter-blind,
over zipf-popular LoRA tenants).  Each stands up a Registrar, its
:class:`~..orchestration.continuous.ContinuousReplica` s and a
:class:`~..orchestration.serving.ReplicaRouter` on one loopback broker and
one engine thread, and builds its servers through ``make_server(name)``
(:func:`run_restart`: ``make_server(name, spill_dir)``) or, without one,
as ``PagedContinuousServer(config_name, params=params, device=device, …)``
— the card unless the caller passes ``device="cpu"``.

    generator = LoadGenerator(process, target_topic="ns/h/1/0/in",
                              payload_fn=make_payload, rate_hz=50)
    report = generator.run(n_requests=500)
    report.p50_ms, report.p99_ms, report.throughput_rps, report.errors

Open-loop: requests are posted on schedule regardless of completions
(late responses still count; missing ones surface as ``timeouts``).

Not ported: :func:`run_compile_cache_ab`.  Its cold arm would be a fresh
engine's kernel build (minutes of ``nvcc``), and aiming the build at
another directory would be a new knob (``ROADMAP.md``, queued under item
8).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import threading
import time
import types
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import trace
from ..pipeline.codec import encode_swag
from ..utils.sexpr import generate, parse

__all__ = ["LoadGenerator", "LoadReport", "PHASES", "chaos_schedule",
           "diurnal_trace", "elastic_chaos_schedule", "fleet",
           "fleet_latency", "longtail_payloads", "main",
           "migration_chaos_schedule", "run_chaos", "run_compile_cache_ab",
           "run_elastic", "run_elastic_chaos", "run_longtail",
           "run_migration_chaos", "run_restart", "run_restart_ab",
           "run_rolling_upgrade", "run_shared_prefix", "run_spec_ab",
           "shared_prefix_payloads", "command_automaton",
           "structured_payloads", "run_structured", "multitenant_payloads",
           "run_multitenant"]

#: Per-phase latency keys the replicas stamp on responses, in report
#: order (``kv_restore`` is the cross-replica transfer phase).
PHASES = ("queue", "prefill", "decode", "kv_restore")


@dataclasses.dataclass
class LoadReport:
    sent: int
    completed: int
    errors: int
    timeouts: int
    elapsed_s: float
    latencies_ms: List[float]
    tokens_total: int = 0
    #: Server-reported time-to-first-token per completed request (the
    #: replica stamps ``ttft_ms`` on the wire response) — what SLOs
    #: watch; wire p50/p99 above includes full generation time.
    ttfts_ms: List[float] = dataclasses.field(default_factory=list)
    #: Optional server-side counters snapshot (``server.stats()`` or
    #: :func:`~..orchestration.serving.serving_telemetry` payload)
    #: attached by the harness after the run — ties the wire-level
    #: tails to the decode-attention path that produced them.
    server_stats: Optional[Dict] = None
    #: error string -> count.  ``errors`` alone can't distinguish a
    #: healthy shed (``overloaded``/``deadline_exceeded`` — the
    #: backpressure design working) from real failures.
    error_kinds: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: Fleet prefix-cache hit fraction over the run
    #: (``Σ prefix_hits / Σ (prefix_hits + prefix_misses)`` across
    #: replicas; None when the fleet has no prefix caches) — attached
    #: by the harness from server stats, like ``server_stats``.
    prefix_hit_rate: Optional[float] = None
    #: Fraction of prefix HITS that adopted blocks restored from the
    #: host tier (``Σ prefix_hits_host / Σ prefix_hits``; None when
    #: the fleet has no host tier or took no hits) — the tiered-KV
    #: number the longtail workload reports: hits the HBM pool alone
    #: would have lost.
    prefix_hit_rate_host: Optional[float] = None
    #: Total cross-replica KV bytes moved during the run (Σ replica
    #: ``kv_transfer_bytes`` deltas).
    kv_transfer_bytes: int = 0
    #: phase -> per-request latencies (ms) as stamped by the replicas
    #: (``queue_ms``/``prefill_ms``/``decode_ms``/``kv_restore_ms``)
    #: — the per-phase breakdown :meth:`phase_table` renders.
    phase_ms: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    #: Fleet-level quantiles from EXACT merges of the replicas'
    #: fixed-bucket histograms (phase -> {p50_ms, p95_ms, p99_ms,
    #: count}); attached by the harness via :func:`fleet_latency`.
    fleet_latency_ms: Optional[Dict[str, Dict[str, float]]] = None
    #: TTFT SLO (ms) goodput is judged against; None = goodput is raw
    #: throughput.  Attached by the harness (``run_elastic``).
    slo_ttft_ms: Optional[float] = None
    #: ∫ replica-count dt over the run — the denominator of
    #: :attr:`goodput_per_replica` (autoscaler share delta, or
    #: ``N * elapsed_s`` for a static fleet).
    replica_seconds: float = 0.0
    #: Final ``infer_response`` arriving for an already-completed
    #: request id — the double-delivery a drain/re-dispatch chaos run
    #: asserts is ZERO.
    duplicate_finals: int = 0
    #: replica topic/name -> TP degree (chips per replica), attached
    #: by the harness from fleet telemetry — per-chip efficiency needs
    #: the chip count, not the replica count, as denominator.
    replica_tp: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: request id -> final token list as delivered on the wire,
    #: attached by the harness — lets A/B runs over the same seeded
    #: payload sequence assert BIT-EXACT outputs (e.g. tier-on chaos
    #: vs tier-off chaos must produce identical greedy tokens).
    final_tokens: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)
    #: request id -> per-spec-round accepted-token counts as stamped
    #: by draft-enabled replicas; empty when the fleet runs no draft.
    #: An A/B run reports the acceptance distribution per request —
    #: the number that explains WHERE speculative decoding paid off
    #: (long accepted runs) and where it degraded to plain decode.
    spec_accept_hist: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)
    #: Fleet speculative counters (Σ over replicas of the server
    #: ``spec_*`` stats); None when no replica runs a draft.
    spec_stats: Optional[Dict] = None
    #: Warmup-vs-steady split: the first-request capture tax reported
    #: SEPARATELY from steady throughput.  On the port a CUDA graph
    #: capture is the counterpart of the JAX package's XLA compile
    #: (``obs/compiles.py``).  ``warmup_s`` is the harness-measured
    #: window before the servers' capture fences dropped;
    #: ``warmup_captures`` is what the fleet captured inside it;
    #: ``captures_steady_state`` is what it captured AFTER it — the
    #: chaos gate asserts this stays ZERO (a steady capture is a
    #: bucket-discipline regression).
    warmup_s: float = 0.0
    warmup_captures: int = 0
    captures_steady_state: int = 0
    #: Tokens/s measured over the steady window only (completed-token
    #: throughput with the warmup window excluded from the clock);
    #: 0.0 when the harness ran no warm-up wave.
    steady_tokens_per_sec: float = 0.0
    #: Time to first token per request on the GENERATOR's own clock:
    #: send to the first streamed increment, or to the final response
    #: for a request that does not stream — what the caller sees,
    #: transport included (``ttfts_ms`` are the replicas' own stamps).
    client_ttfts_ms: List[float] = dataclasses.field(default_factory=list)
    #: End-of-run pool census from the (first paged) server —
    #: ``PagedContinuousServer.pool_census()``; None on non-paged
    #: fleets.  :meth:`pool_census` renders it.
    census: Optional[Dict] = None
    #: Multi-tenant adapters: client-observed cold starts — an
    #: ``unknown_adapter`` rejection is a request that landed on a
    #: replica without the tenant's factors and would force a factor
    #: re-upload before retry.  The adapter-aware arm of the
    #: multitenant A/B asserts this is ZERO whenever the adapter is
    #: warm anywhere in the fleet.
    adapter_cold_starts: int = 0
    #: Router's warm/cold split over adapter-tagged routes (mirrors
    #: ``router.counters``; both 0 under the adapter-blind baseline,
    #: which never inspects the adapter field).
    adapter_warm_routes: int = 0
    adapter_cold_routes: int = 0

    def pool_census(self) -> str:
        """Readable end-of-run memory summary: per-tier blocks/bytes
        plus the pool state histogram."""
        if not self.census:
            return "(no pool census attached)"
        lines = [f"{'tier':<6}{'blocks':>9}{'bytes':>13}"]
        for tier in ("hbm", "host", "disk"):
            info = self.census.get("tiers", {}).get(tier, {})
            lines.append(
                f"{tier:<6}{int(info.get('blocks', 0)):>9}"
                f"{int(info.get('bytes', 0)):>13}")
        states = self.census.get("states", {})
        if states:
            lines.append("states: " + ", ".join(
                f"{state}={count}" for state, count
                in sorted(states.items()) if count))
        return "\n".join(lines)

    @property
    def lost(self) -> int:
        """Requests neither completed nor error-terminal (hung or
        dropped) — the number a chaos run asserts is ZERO."""
        return self.sent - self.completed - self.errors

    @property
    def throughput_rps(self) -> float:
        return self.completed / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def throughput_tps(self) -> float:
        """Generated tokens per second — the number the device-resident
        serving work moves; req/s alone hides per-request length."""
        return (self.tokens_total / self.elapsed_s
                if self.elapsed_s else 0.0)

    @property
    def good_completions(self) -> int:
        """Completions WITHIN the TTFT SLO (DistServe's goodput
        numerator).  Completions without a ``ttft_ms`` stamp count as
        good — only a measured breach disqualifies."""
        if self.slo_ttft_ms is None:
            return self.completed
        within = sum(1 for ttft in self.ttfts_ms
                     if ttft <= self.slo_ttft_ms)
        unstamped = self.completed - len(self.ttfts_ms)
        return within + max(0, unstamped)

    @property
    def goodput_rps(self) -> float:
        """SLO-attaining completions per second."""
        return (self.good_completions / self.elapsed_s
                if self.elapsed_s else 0.0)

    @property
    def avg_replicas(self) -> float:
        """Time-averaged fleet size over the run."""
        return (self.replica_seconds / self.elapsed_s
                if self.elapsed_s else 0.0)

    @property
    def goodput_per_replica(self) -> float:
        """Goodput divided by average fleet size — the efficiency
        number an autoscaled fleet must beat a static-peak fleet on
        (serving the valleys with fewer replicas is the whole
        point)."""
        average = self.avg_replicas
        return self.goodput_rps / average if average else 0.0

    @staticmethod
    def _quantile(values: List[float], q: float) -> float:
        if not values:
            return 0.0
        ordered = sorted(values)
        index = min(len(ordered) - 1, int(q * len(ordered)))
        return ordered[index]

    @property
    def p50_ms(self) -> float:
        return (statistics.median(self.latencies_ms)
                if self.latencies_ms else 0.0)

    @property
    def p99_ms(self) -> float:
        return self._quantile(self.latencies_ms, 0.99)

    @property
    def ttft_p50_ms(self) -> float:
        return (statistics.median(self.ttfts_ms)
                if self.ttfts_ms else 0.0)

    @property
    def ttft_p95_ms(self) -> float:
        return self._quantile(self.ttfts_ms, 0.95)

    def phase_table(self) -> str:
        """Per-phase latency breakdown (queue/prefill/decode/
        kv_restore) — WHERE a slow run spent its time, one line per
        phase with nearest-rank quantiles over this run's samples."""
        if not self.phase_ms:
            return "(no per-phase latency samples)"
        lines = [f"{'phase':<12}{'p50_ms':>9}{'p95_ms':>9}"
                 f"{'p99_ms':>9}{'n':>7}"]
        for phase in PHASES:
            values = self.phase_ms.get(phase)
            if not values:
                continue
            lines.append(
                f"{phase:<12}"
                f"{self._quantile(values, 0.5):>9.1f}"
                f"{self._quantile(values, 0.95):>9.1f}"
                f"{self._quantile(values, 0.99):>9.1f}"
                f"{len(values):>7}")
        return "\n".join(lines)

    def __repr__(self):
        attn = ""
        if self.server_stats and "decode_attention_path" in \
                self.server_stats:
            attn = (f", attn={self.server_stats['decode_attention_path']}"
                    f"/{self.server_stats.get('blocks_read_per_step', 0)}"
                    f" blk/step")
        ttft = (f", ttft_p50={self.ttft_p50_ms:.1f}/"
                f"p95={self.ttft_p95_ms:.1f} ms"
                if self.ttfts_ms else "")
        kinds = (", kinds=" + "/".join(
            f"{k}:{n}" for k, n in sorted(self.error_kinds.items()))
            if self.error_kinds else "")
        prefix = (f", prefix_hit={self.prefix_hit_rate:.0%}"
                  if self.prefix_hit_rate is not None else "")
        if self.prefix_hit_rate_host is not None:
            prefix += f" ({self.prefix_hit_rate_host:.0%} via host tier)"
        kv = (f", kv_xfer={self.kv_transfer_bytes}B"
              if self.kv_transfer_bytes else "")
        adapters = ""
        if (self.adapter_cold_starts or self.adapter_warm_routes
                or self.adapter_cold_routes):
            adapters = (f", adapters={self.adapter_warm_routes} warm"
                        f"/{self.adapter_cold_routes} cold routes, "
                        f"{self.adapter_cold_starts} cold starts")
        tp = ""
        if any(degree > 1 for degree in self.replica_tp.values()):
            tp = ", tp=" + "/".join(
                f"{name}:{degree}" for name, degree
                in sorted(self.replica_tp.items()))
        goodput = ""
        if self.slo_ttft_ms is not None:
            goodput = (f", goodput={self.goodput_rps:.1f} req/s"
                       f"@{self.slo_ttft_ms:g}ms")
            if self.replica_seconds:
                goodput += (f", {self.goodput_per_replica:.2f} "
                            f"req/s/replica (avg "
                            f"{self.avg_replicas:.2f})")
        compile_note = ""
        if self.warmup_captures or self.captures_steady_state:
            compile_note = (
                f", captures={self.warmup_captures} warmup"
                f"/{self.captures_steady_state} steady"
                f" (warmup {self.warmup_s:.1f}s")
            if self.steady_tokens_per_sec:
                compile_note += (f", steady "
                                 f"{self.steady_tokens_per_sec:.1f} "
                                 f"tok/s")
            compile_note += ")"
        return (f"LoadReport(sent={self.sent}, done={self.completed}, "
                f"errors={self.errors}{kinds}, "
                f"timeouts={self.timeouts}, "
                f"{self.throughput_rps:.1f} req/s, "
                f"{self.throughput_tps:.1f} tok/s, "
                f"p50={self.p50_ms:.1f} ms, p99={self.p99_ms:.1f} ms"
                f"{ttft}{goodput}{prefix}{kv}{adapters}{tp}{attn}"
                f"{compile_note})")


class LoadGenerator:
    """Open-loop ``(infer …)`` load against a replica or router topic."""

    def __init__(self, process, target_topic: str,
                 payload_fn: Callable[[int], Dict], rate_hz: float = 50.0,
                 response_topic: Optional[str] = None,
                 clock=None, sleep=None):
        self.process = process
        self.target_topic = target_topic
        self.payload_fn = payload_fn
        self.rate_hz = rate_hz
        self.response_topic = response_topic or (
            f"loadgen/{uuid.uuid4().hex[:8]}/response")
        self._clock = clock or time.perf_counter
        self._sleep = sleep or time.sleep
        self._sent_at: Dict[str, float] = {}
        #: request_id -> generator-clock time of its first token (first
        #: streamed increment, or the final response).
        self._first_at: Dict[str, float] = {}
        self._latencies: List[float] = []
        self._ttfts: List[float] = []
        self._phases: Dict[str, List[float]] = {}
        self._errors = 0
        self._error_kinds: Dict[str, int] = {}
        self._tokens = 0
        self._run_index = 0
        #: request_id -> concatenated streaming increments as
        #: delivered (``infer_partial``); public so chaos tests can
        #: assert partials == final tokens with no double-delivery.
        self.partial_tokens: Dict[str, List[int]] = {}
        #: request_id -> the final response's token list.
        self.final_tokens: Dict[str, List[int]] = {}
        #: request_id -> per-spec-round accepted-token counts as
        #: stamped by draft-enabled replicas (absent otherwise).
        self.spec_accept_hist: Dict[str, List[int]] = {}
        self._completed_ids: set = set()
        self._duplicate_finals = 0
        # Tracing (rides the global trace.TRACER switchboard): root
        # span per request, full ride-back tree kept per request id
        # for dump_traces().
        self._root_spans: Dict[str, object] = {}
        self._traces: List[Tuple[float, str, List]] = []
        process.add_message_handler(self._on_response,
                                    self.response_topic)

    def close(self):
        """Deregister the response handler (and its subscription) —
        required in long-lived processes doing rate sweeps, or dead
        generators keep receiving."""
        self.process.remove_message_handler(self._on_response,
                                            self.response_topic)

    def _on_response(self, _topic: str, payload: str):
        command, params = parse(payload)
        if command == "infer_partial" and len(params) > 1:
            self._on_partial(str(params[0]), params[1])
            return
        if command != "infer_response" or not params:
            return
        request_id = str(params[0])
        # Look up (don't pop yet): the drain loop in run_trace exits
        # the moment _sent_at goes empty, so the request must stay in
        # it until its latency/error is recorded — popping first lets
        # the report snapshot race ahead of the append and under-count
        # completions.  The pop happens at the end of this handler.
        started = self._sent_at.get(request_id)
        if started is None:
            if request_id in self._completed_ids:
                # A second FINAL for a finished request: the
                # double-delivery chaos runs must never see.
                self._duplicate_finals += 1
            return
        self._completed_ids.add(request_id)
        self._first_at.setdefault(request_id, self._clock())
        outputs = params[1] if len(params) > 1 else {}
        self._record_final_tokens(request_id, outputs)
        if isinstance(outputs, dict) and "spec_accepted_rounds" in outputs:
            try:
                from ..pipeline.codec import decode_value
                import numpy as np
                self.spec_accept_hist[request_id] = [
                    int(count) for count in np.asarray(decode_value(
                        outputs["spec_accepted_rounds"])).reshape(-1)]
            except Exception:  # noqa: BLE001 - telemetry only
                pass
        self._collect_trace(request_id, started, outputs)
        if isinstance(outputs, dict) and "error" in outputs:
            self._first_at.pop(request_id, None)
            self._errors += 1
            # Values on the wire are codec-tagged ("s:overloaded") —
            # decode, so error_kinds keys match the error strings the
            # replicas publish.
            try:
                from ..pipeline.codec import decode_value
                kind = str(decode_value(outputs["error"]))
            except Exception:  # noqa: BLE001 - count it regardless
                kind = str(outputs["error"])
            self._error_kinds[kind] = \
                self._error_kinds.get(kind, 0) + 1
        else:
            self._latencies.append((self._clock() - started) * 1e3)
            if isinstance(outputs, dict) and "ttft_ms" in outputs:
                try:
                    from ..pipeline.codec import decode_value
                    self._ttfts.append(
                        float(decode_value(outputs["ttft_ms"])))
                except Exception:  # noqa: BLE001 - telemetry only
                    pass
            if isinstance(outputs, dict) and "tokens_out" in outputs:
                try:
                    from ..pipeline.codec import decode_value
                    import numpy as np
                    self._tokens += int(np.asarray(
                        decode_value(outputs["tokens_out"])).size)
                except Exception:  # noqa: BLE001 - telemetry only
                    pass
            if isinstance(outputs, dict):
                for phase in PHASES:
                    if f"{phase}_ms" not in outputs:
                        continue
                    try:
                        from ..pipeline.codec import decode_value
                        self._phases.setdefault(phase, []).append(
                            float(decode_value(outputs[f"{phase}_ms"])))
                    except Exception:  # noqa: BLE001 - telemetry only
                        pass
        # Everything recorded — only now mark the request finished so
        # run_trace cannot observe "done" before the stats landed.
        self._sent_at.pop(request_id, None)

    def _on_partial(self, request_id: str, outputs) -> None:
        """Accumulate a streaming increment (chaos tests assert the
        concatenation equals the final token list — a drained replica
        finishing in place must never re-stream)."""
        if not isinstance(outputs, dict) or "tokens_out" not in outputs:
            return
        if request_id in self._sent_at:
            self._first_at.setdefault(request_id, self._clock())
        try:
            from ..pipeline.codec import decode_value
            import numpy as np
            increment = [int(t) for t in
                         np.asarray(decode_value(outputs["tokens_out"]))
                         .reshape(-1)]
        except Exception:  # noqa: BLE001 - telemetry only
            return
        self.partial_tokens.setdefault(request_id, []).extend(increment)

    def _record_final_tokens(self, request_id: str, outputs) -> None:
        if not isinstance(outputs, dict) or "tokens_out" not in outputs:
            return
        try:
            from ..pipeline.codec import decode_value
            import numpy as np
            self.final_tokens[request_id] = [
                int(t) for t in
                np.asarray(decode_value(outputs["tokens_out"]))
                .reshape(-1)]
        except Exception:  # noqa: BLE001 - telemetry only
            pass

    def _collect_trace(self, request_id: str, started: float,
                       outputs) -> None:
        """Close this request's root span and keep the full ride-back
        tree (root + router + replica + kv source spans), keyed by
        wire latency so :meth:`dump_traces` can rank by slowest."""
        span = self._root_spans.pop(request_id, None)
        if span is None:
            return
        if trace.TRACER is not None:
            trace.TRACER.finish(span)
        elif span.end is None:
            span.end = span.start
        spans = [span]
        if isinstance(outputs, dict) and "trace_spans" in outputs:
            try:
                from ..pipeline.codec import decode_value
                spans.extend(trace.decode_spans(
                    str(decode_value(outputs["trace_spans"]))))
            except Exception:  # noqa: BLE001 - telemetry only
                pass
        self._traces.append(((self._clock() - started) * 1e3,
                             request_id, spans))

    def dump_traces(self, directory: str, top_k: int = 5) -> List[str]:
        """Export the ``top_k`` SLOWEST traced requests' span trees as
        Chrome trace-event JSON files (Perfetto-loadable), one file
        per request, named ``trace_<rank>_<request_id>.json``.
        Returns the written paths (empty when tracing was off)."""
        if not self._traces:
            return []
        os.makedirs(directory, exist_ok=True)
        ranked = sorted(self._traces,
                        key=lambda entry: -entry[0])[:top_k]
        paths = []
        for rank, (_total_ms, request_id, spans) in enumerate(ranked):
            path = os.path.join(
                directory, f"trace_{rank:02d}_{request_id}.json")
            trace.export_chrome(path, spans)
            paths.append(path)
        return paths

    def run(self, n_requests: int, drain_timeout_s: float = 30.0,
            pump: Optional[Callable[[], None]] = None) -> LoadReport:
        """Send ``n_requests`` at ``rate_hz``, then wait for stragglers.
        ``pump`` (optional) is called between waits — pass
        ``engine.drain`` when driving a VirtualClock engine in tests."""
        interval = 1.0 / self.rate_hz if self.rate_hz > 0 else 0.0
        return self.run_trace(
            [index * interval for index in range(n_requests)],
            drain_timeout_s=drain_timeout_s, pump=pump)

    def run_trace(self, send_offsets_s: List[float],
                  drain_timeout_s: float = 30.0,
                  pump: Optional[Callable[[], None]] = None
                  ) -> LoadReport:
        """Open-loop injection on an explicit schedule: request ``i``
        is sent ``send_offsets_s[i]`` seconds after the run starts
        (:func:`diurnal_trace` generates such schedules).  ``run()``
        is the constant-rate special case."""
        # Per-run state: runs are re-runnable (rate sweeps), and ids
        # are unique per run so a run-1 straggler cannot satisfy a
        # run-2 request.
        self._sent_at.clear()
        self._first_at = {}
        self._latencies = []
        self._ttfts = []
        self._phases = {}
        self._errors = 0
        self._error_kinds = {}
        self._tokens = 0
        self._root_spans.clear()
        self._traces = []
        self.partial_tokens = {}
        self.final_tokens = {}
        self.spec_accept_hist = {}
        self._completed_ids = set()
        self._duplicate_finals = 0
        self._run_index += 1
        run_tag = self._run_index
        started = self._clock()
        sent_at: Dict[str, float] = {}
        for index, offset in enumerate(send_offsets_s):
            delay = started + offset - self._clock()
            if delay > 0:
                self._sleep(delay)
            request_id = f"lg{run_tag}_{index}"
            swag = self.payload_fn(index)
            if trace.TRACER is not None:
                span = trace.TRACER.start_span(
                    "infer", attrs={"request_id": request_id,
                                    "target": self.target_topic})
                swag = dict(swag, trace=trace.inject(span))
                self._root_spans[request_id] = span
            self._sent_at[request_id] = sent_at[request_id] = self._clock()
            self.process.message.publish(
                self.target_topic,
                generate("infer",
                         [request_id, self.response_topic,
                          encode_swag(swag)]))
            if pump is not None:
                pump()
        deadline = self._clock() + drain_timeout_s
        while self._sent_at and self._clock() < deadline:
            if pump is not None:
                pump()
            self._sleep(0.01)
        elapsed = self._clock() - started
        return LoadReport(sent=len(send_offsets_s),
                          completed=len(self._latencies),
                          errors=self._errors,
                          timeouts=len(self._sent_at),
                          elapsed_s=elapsed,
                          latencies_ms=list(self._latencies),
                          tokens_total=self._tokens,
                          ttfts_ms=list(self._ttfts),
                          error_kinds=dict(self._error_kinds),
                          phase_ms={phase: list(values) for phase,
                                    values in self._phases.items()},
                          duplicate_finals=self._duplicate_finals,
                          client_ttfts_ms=[
                              (self._first_at[rid] - sent) * 1e3
                              for rid, sent in sent_at.items()
                              if rid in self._first_at
                              and rid in self._completed_ids])


def shared_prefix_payloads(n_conversations: int = 4, turns: int = 4,
                           system_len: int = 48, turn_len: int = 8,
                           max_new_tokens: int = 6, vocab: int = 1024,
                           seed: int = 0, stream: bool = True
                           ) -> Callable[[int], Dict]:
    """Multi-turn chat-style workload: ``n_conversations`` interleaved
    conversations of ``turns`` turns, ALL sharing one
    ``system_len``-token system prompt, each turn re-sending the
    conversation so far plus ``turn_len`` fresh tokens — the workload
    shape where a cluster-wide prefix cache pays (every request's
    prompt head is either the shared system prompt or a prior turn's
    whole prompt).

    ``payload_fn(index)``: conversation ``index % n_conversations``,
    turn ``(index // n_conversations) % turns`` — so concurrent
    requests hit DIFFERENT conversations (interleaving, like real
    traffic) while turn order within a conversation is preserved by
    send order.  Deterministic from ``seed`` (the JAX package's
    payloads, token for token)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    system = rng.randint(1, vocab, size=system_len).astype(np.int32)
    turn_tokens = [[rng.randint(1, vocab,
                                size=turn_len).astype(np.int32)
                    for _ in range(turns)]
                   for _ in range(n_conversations)]

    def payload_fn(index: int) -> Dict:
        conversation = index % n_conversations
        turn = (index // n_conversations) % turns
        prompt = np.concatenate(
            [system] + turn_tokens[conversation][:turn + 1])
        payload = {"tokens": prompt, "max_new_tokens": max_new_tokens}
        if stream:
            payload["stream"] = 1
        return payload

    return payload_fn


def _elastic_payloads(seed: int = 0, prompt_len: int = 12,
                      max_new_tokens: int = 4, vocab: int = 1024,
                      stream: bool = False) -> Callable[[int], Dict]:
    """Independent random prompts (no shared prefix — cache locality is
    not under test)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    prompts = rng.randint(1, vocab,
                          size=(32, prompt_len)).astype(np.int32)

    def payload_fn(index: int) -> Dict:
        payload = {"tokens": prompts[index % len(prompts)],
                   "max_new_tokens": max_new_tokens}
        if stream:
            payload["stream"] = 1
        return payload

    return payload_fn


def fleet_latency(servers) -> Dict[str, Dict[str, float]]:
    """Fleet-level latency quantiles by EXACTLY merging the replicas'
    fixed-bucket phase histograms (element-wise bucket adds — the
    same numbers a router derives from the ``hist.<phase>`` EC shares
    it watches).  phase -> {p50_ms, p95_ms, p99_ms, count}."""
    from ..obs.metrics import Histogram
    out: Dict[str, Dict[str, float]] = {}
    by_phase: Dict[str, List[Histogram]] = {}
    for server in servers:
        for phase, histogram in getattr(server, "latency_hists",
                                        {}).items():
            by_phase.setdefault(phase, []).append(histogram)
    for phase, histograms in sorted(by_phase.items()):
        merged = Histogram.merged(histograms)
        if merged.count:
            out[phase] = {"p50_ms": round(merged.quantile(0.5), 1),
                          "p95_ms": round(merged.quantile(0.95), 1),
                          "p99_ms": round(merged.quantile(0.99), 1),
                          "count": merged.count}
    return out


def _fleet_kv_stats(servers) -> Dict:
    """Aggregate the kvstore + tier counters a fleet run reports."""
    totals = dict(prefix_hits=0, prefix_misses=0, kv_transfer_bytes=0,
                  prefix_remote_hits=0, kv_transfer_failures=0,
                  kv_demotions=0, kv_restores=0, kv_host_blocks=0,
                  kv_host_bytes=0, restore_queue_depth=0,
                  prefix_hits_host=0, kv_spills=0, kv_disk_blocks=0,
                  kv_disk_bytes=0, kv_disk_restores=0,
                  kv_checksum_failures=0, kv_adopted_chains=0,
                  kv_prefetch_promotions=0)
    for server in servers:
        stats = server.stats()
        for key in totals:
            totals[key] += int(stats.get(key, 0))
    return totals


def _attach_kv_rates(report: LoadReport, totals: Dict) -> None:
    """Derive the report's hit-rate fields from fleet totals."""
    lookups = totals["prefix_hits"] + totals["prefix_misses"]
    if lookups:
        report.prefix_hit_rate = totals["prefix_hits"] / lookups
    if totals["prefix_hits"] and (totals["kv_demotions"]
                                  or totals["prefix_hits_host"]):
        report.prefix_hit_rate_host = \
            totals["prefix_hits_host"] / totals["prefix_hits"]
    report.kv_transfer_bytes = totals["kv_transfer_bytes"]


def _attach_pool_census(report: LoadReport, servers) -> None:
    """Attach the end-of-run pool census of the first server that keeps
    one (``pool_census()``).  The port's servers keep none until the pool
    auditor is ported, and then nothing is attached."""
    for server in servers:
        if hasattr(server, "pool_census"):
            report.census = server.pool_census()
            break


def _wait_for(predicate, timeout_s: float, what: str) -> None:
    deadline = time.time() + timeout_s
    while not predicate():
        if time.time() > deadline:
            raise TimeoutError(what)
        time.sleep(0.02)


def _server_factory(make_server, config_name: str, params, device,
                    spec_k: int = 0, **defaults) -> Callable[[str], object]:
    """``make_server`` itself, or a factory of ``PagedContinuousServer``
    s on ``params`` (random weights from the seed when None) and
    ``device`` with the rig's ``defaults``.  ``spec_k`` > 0 gives every
    server a ``spec_k``-token paired draft (:func:`_enable_paired_draft`;
    a caller's ``make_server`` must build servers with a draft)."""
    if make_server is None:
        def make_server(_name: str):
            from ..orchestration.paged import PagedContinuousServer
            return PagedContinuousServer(
                config_name=config_name, params=params, device=device,
                draft_config_name=config_name if spec_k else None,
                spec_k=spec_k or 4, **defaults)
    if not spec_k:
        return make_server

    def build_paired(name: str):
        server = make_server(name)
        _enable_paired_draft(server, spec_k)
        return server
    return build_paired


def _fleet_spec_stats(servers) -> Optional[Dict]:
    """The replicas' speculative counters summed (None when no replica
    runs a draft).  Rates are recomputed from the summed raw counts:
    averaging per-replica rates would weight idle replicas equally."""
    totals: Dict[str, float] = {}
    modes: set = set()
    k_effs: list = []
    for server in servers:
        stats = server.stats()
        if "spec_rounds" not in stats:
            continue
        for key in ("spec_rounds", "spec_proposed", "spec_accepted",
                    "spec_rollback_blocks", "spec_jump_forward_tokens",
                    "spec_ngram_hits"):
            totals[key] = totals.get(key, 0) + int(stats.get(key, 0))
        modes.add(str(stats.get("spec_draft_mode", "model")))
        k_eff = stats.get("spec_k_effective", "-")
        if k_eff not in (None, "-"):
            k_effs.append(str(k_eff))
    if not totals:
        return None
    totals["spec_draft_mode"] = "|".join(sorted(modes))
    totals["spec_k_effective"] = ";".join(k_effs) if k_effs else "-"
    proposed = totals["spec_proposed"]
    rounds = totals["spec_rounds"]
    totals["spec_acceptance_rate"] = round(
        totals["spec_accepted"] / proposed, 4) if proposed else 0.0
    totals["spec_tokens_per_target_pass"] = round(
        (totals["spec_accepted"] + rounds) / rounds, 4) \
        if rounds else 0.0
    return totals


def _enable_paired_draft(server, spec_k: int) -> None:
    """Alias the target weights in as the draft (the "paired toy"): an
    identical draft gives the HIGH-acceptance regime, multi-token commits
    every round, while greedy outputs stay bitwise the plain server's by
    the verify's construction (what the A/B asserts).  ``spec_k`` is the
    server's own, set when it was built."""
    if server._draft is None:
        raise ValueError(f"a {spec_k}-token paired draft needs a server "
                         "built with a draft (draft_config_name=)")
    server._draft["params"] = server.params
    server._draft["config"] = server.config


@contextlib.contextmanager
def fleet(namespace: str, make_server: Callable[[str], object],
          names: Sequence[str] = ("replica_a", "replica_b"),
          replica_kwargs: Optional[Dict[str, Dict]] = None,
          **router_kwargs):
    """An in-process fleet: a Registrar, one ContinuousReplica over
    ``make_server(name)`` per name and a ReplicaRouter, each actor in a
    process of its own, all on ONE loopback broker and ONE engine thread
    (every server call runs on that thread).  Yields a namespace with
    ``router``, ``replicas`` and ``servers`` (by name) and
    ``make_process`` (for load generators and probes); tears every
    process and the engine down on exit."""
    from ..orchestration.continuous import ContinuousReplica
    from ..orchestration.serving import ReplicaRouter
    from ..registry import Registrar
    from ..runtime import Process, actor_args, compose_instance
    from ..runtime.event import EventEngine

    engine = EventEngine()
    thread = engine.run_in_thread()
    broker = f"{namespace}-{uuid.uuid4().hex[:6]}"
    processes = []

    def make_process(pid):
        process = Process(namespace=namespace, hostname="h",
                          pid=str(pid), engine=engine, broker=broker)
        processes.append(process)
        return process

    try:
        registrar = Registrar(process=make_process(1))
        _wait_for(lambda: registrar.state == "primary", 10,
                  f"{namespace} rig: registrar primary")
        servers, replicas = {}, {}
        for index, name in enumerate(names):
            servers[name] = make_server(name)
            replicas[name] = compose_instance(
                ContinuousReplica, actor_args(name),
                process=make_process(2 + index), server=servers[name],
                **(replica_kwargs or {}).get(name, {}))
        router = compose_instance(ReplicaRouter, actor_args("router"),
                                  process=make_process(len(names) + 2),
                                  **router_kwargs)
        _wait_for(lambda: router.share["replicas"] == len(names), 30,
                  f"{namespace} rig: router discovery")
        yield types.SimpleNamespace(router=router, replicas=replicas,
                                    servers=servers,
                                    make_process=make_process)
    finally:
        for process in reversed(processes):
            try:
                process.terminate()
            except Exception:  # noqa: BLE001 - a chaos kill may have
                pass           # already taken this process
        engine.terminate()
        thread.join(timeout=5)


def run_shared_prefix(n_requests: int = 24, rate_hz: float = 50.0,
                      prefix_routing: bool = True,
                      disaggregate: bool = False,
                      drain_timeout_s: float = 90.0,
                      payload_fn: Optional[Callable[[int], Dict]] = None,
                      make_server: Optional[Callable] = None,
                      config_name: str = "tiny", params=None,
                      device=None, spec_k: int = 0) -> LoadReport:
    """In-process 2-replica PAGED serving rig (prefix caches on) driven
    through a ReplicaRouter with KV transfer on, by ``payload_fn`` or
    :func:`shared_prefix_payloads` (three conversations of four turns on
    a 48-token system prompt, seed 0: the JAX rig's default payloads).
    ``prefix_routing=False`` degrades the router to pure least-loaded
    P2C (``prefix_alpha=0``) — the A/B baseline.  ``disaggregate=True``
    makes ``replica_a`` a dedicated prefill replica (``prefill_only``)
    and the router two-phase: every request prefills there and decodes
    on ``replica_b`` from the pulled blocks.  The report carries
    ``prefix_hit_rate``, ``kv_transfer_bytes``, histogram-merged
    ``fleet_latency_ms``, the final tokens and the caller-clock TTFTs
    (``client_ttfts_ms``).  ``spec_k`` > 0 serves with a paired draft
    (:func:`_server_factory`); the report then carries the fleet's
    ``spec_stats`` and the requests' ``spec_accept_hist``."""
    make_server = _server_factory(
        make_server, config_name, params, device, spec_k=spec_k, slots=2,
        chunk_steps=4, seed=0, enable_prefix_cache=True, max_queue=256,
        watchdog_s=5.0)
    with fleet("sharedpfx", make_server,
               replica_kwargs={"replica_a": dict(prefill_only=disaggregate)},
               prefix_alpha=1.0 if prefix_routing else 0.0,
               kv_transfer=True, disaggregate=disaggregate) as rig:
        router, servers = rig.router, list(rig.servers.values())
        if disaggregate:
            # Replica roles arrive with the replicas' periodic digest
            # advertisement; until then the router cannot tell the
            # prefill replica from a decode one.
            prefill = rig.replicas["replica_a"].topic_path
            _wait_for(lambda: router.directory.role(prefill) == "prefill",
                      30, "sharedpfx rig: the prefill role advertised")
        generator = LoadGenerator(
            rig.make_process(9), f"{router.topic_path}/in",
            payload_fn=payload_fn or shared_prefix_payloads(
                n_conversations=3, turns=4, system_len=48, seed=0),
            rate_hz=rate_hz)
        report = generator.run(n_requests, drain_timeout_s=drain_timeout_s)
        generator.close()
        totals = _fleet_kv_stats(servers)
        _attach_kv_rates(report, totals)
        _attach_pool_census(report, servers)
        report.fleet_latency_ms = fleet_latency(servers)
        report.final_tokens = dict(generator.final_tokens)
        report.spec_stats = _fleet_spec_stats(servers)
        report.spec_accept_hist = dict(generator.spec_accept_hist)
        report.server_stats = dict(
            router.counters, **totals,
            kv_directory_size=router.share.get("kv_directory_size", 0))
        return report


def chaos_schedule(seed: int):
    """The canonical seeded fault schedule of a chaos run: one replica
    death mid-decode, streaming-increment message drops, and a
    device-step stall — the three failure classes the serving
    robustness machinery covers (re-dispatch, dedup-tolerant
    streaming, watchdog/latency).  Deriving the plan purely from
    ``seed`` is what makes a chaos run reproducible (the JAX package's
    schedule, rule for rule)."""
    from ..runtime import faults
    return (
        faults.FaultPlan(seed=seed)
        # replica_a dies on its Nth pump — mid-decode under load.
        .add("kill_replica", nth=6 + seed % 5, match="replica_a")
        # Streamed increments are droppable by design (the final
        # response is authoritative); finals are NOT dropped — nothing
        # retries a silently-eaten terminal response.
        .add("drop_message", nth=4, match="infer_partial")
        .add("drop_message", nth=9, match="infer_partial")
        # Latency blip well under the watchdog threshold: chaos runs
        # exercise the stall POINT; the watchdog trip itself is
        # unit-tested deterministically.
        .add("stall_step", nth=7 + seed % 3, ms=40))


def run_chaos(seed: int = 0, n_requests: int = 40,
              rate_hz: float = 100.0,
              drain_timeout_s: float = 90.0,
              capture_gate: bool = False,
              warmup_requests: Optional[int] = None,
              payload_fn: Optional[Callable[[int], Dict]] = None,
              make_server: Optional[Callable] = None,
              config_name: str = "tiny", params=None,
              device=None, spec_k: int = 0) -> LoadReport:
    """Run an in-process 2-replica serving rig (loopback broker, real
    event engine, Registrar + router) under :func:`chaos_schedule` and
    return the LoadReport.  The invariant a chaos run checks:
    ``report.lost == 0 and report.timeouts == 0`` — every request
    reaches a terminal state (completed, or an explicit error like
    ``deadline_exceeded``/``overloaded``) no matter which replica died
    or which messages vanished.

    Replicas run the PAGED backend with prefix caches on and the
    router routes prefix-aware with KV transfer enabled — the chaos
    gate covers the kvstore path too: killing a directory-advertised
    prefix owner mid-stream must still lose ZERO requests (directory
    eviction + fetch-timeout fallback to local prefill).  A tiered or
    spilling fleet comes from ``make_server``.

    ``capture_gate=True`` is the port's counterpart of the JAX rig's
    compile gate: a warmup wave of ``warmup_requests`` (default 12 = one
    full period of the shared-prefix payload cycle) runs BEFORE the
    fault plan is armed, every server's capture fence drops, and the
    measured chaos wave must then record ZERO CUDA-graph captures — a
    replica dying mid-decode and re-dispatching its work may never cost
    the fleet a new capture.  The report carries the warmup/steady split
    (``warmup_s``, ``warmup_captures``, ``captures_steady_state``,
    ``steady_tokens_per_sec``).

    ``spec_k`` > 0 serves with a paired draft, so a replica dies
    mid-speculation-round: greedy determinism and the idempotent replay
    must hold through rejected-tail rollbacks as through plain decode."""
    from ..runtime import faults

    make_server = _server_factory(
        make_server, config_name, params, device, spec_k=spec_k, slots=2,
        chunk_steps=4, seed=0, enable_prefix_cache=True, max_queue=256,
        watchdog_s=5.0)
    warmup_began = time.time()
    # The fault plan arms AFTER the warmup wave when gating captures —
    # warmup pumps must not consume the schedule's nth counters, or
    # the kill would land mid-warmup instead of mid-measured-decode.
    plan = faults.install(chaos_schedule(seed)) \
        if not capture_gate else None
    try:
        with fleet("chaos", make_server,
                   # Dead-owner fallback must fire well inside the drain
                   # budget.
                   replica_kwargs={name: dict(kv_fetch_timeout_s=2.0)
                                   for name in ("replica_a",
                                                "replica_b")},
                   kv_transfer=True) as rig:
            router, servers = rig.router, list(rig.servers.values())
            generator = LoadGenerator(
                rig.make_process(9), f"{router.topic_path}/in",
                # Shared 32-token system prefix: the fault schedule then
                # kills a replica the directory advertises as an owner.
                payload_fn=payload_fn or shared_prefix_payloads(
                    n_conversations=3, turns=4, system_len=32,
                    seed=seed),
                rate_hz=rate_hz)
            warmup_s = 0.0
            warmup_captures = 0
            if capture_gate:
                # One full payload period: every distinct prompt the
                # measured wave will send is captured (or replayed) here.
                generator.run(12 if warmup_requests is None
                              else int(warmup_requests),
                              drain_timeout_s=drain_timeout_s)
                for server in servers:
                    warmup_captures += server.graph_ledger.captures
                    server.graph_ledger.fence()
                warmup_s = time.time() - warmup_began
                plan = faults.install(chaos_schedule(seed))
            report = generator.run(n_requests,
                                   drain_timeout_s=drain_timeout_s)
            generator.close()
            totals = _fleet_kv_stats(servers)
            _attach_kv_rates(report, totals)
            report.final_tokens = dict(generator.final_tokens)
            report.fleet_latency_ms = fleet_latency(servers)
            report.spec_stats = _fleet_spec_stats(servers)
            report.spec_accept_hist = dict(generator.spec_accept_hist)
            report.server_stats = dict(
                router.counters, **totals,
                replicas_live=router.share["replicas"],
                faults_fired=len(plan.fired))
            if capture_gate:
                steady = sum(server.graph_ledger.steady_captures
                             for server in servers)
                report.warmup_s = round(warmup_s, 3)
                report.warmup_captures = warmup_captures
                report.captures_steady_state = steady
                if report.elapsed_s > 0:
                    report.steady_tokens_per_sec = round(
                        report.tokens_total / report.elapsed_s, 2)
                if steady:
                    raise AssertionError(
                        f"chaos capture gate: {steady} CUDA-graph "
                        "capture(s) after the warmup fence")
            return report
    finally:
        faults.uninstall()


def migration_chaos_schedule(seed: int, phase: str = "none"):
    """Seeded fault schedule for the live-migration chaos gate — one
    fault class per ``phase`` so a run exercises exactly one migration
    failure point:

    * ``transfer``  — ``drop_migration_block``: the source drops the
      last exported KV block; the destination resumes one block colder
      and recomputes the tail (still bit-exact).
    * ``cutover``   — ``stall_cutover``: wedge the router inside the
      double-delivery window, forcing the token-offset dedup to earn
      its keep.
    * ``source``    — ``kill_source_mid_migration``: the source
      replica dies while migrations are in flight; TRANSFER-phase
      requests promote to the destination, earlier phases abort into
      the normal re-dispatch path.
    * ``none``      — no faults: the clean-migration control.
    """
    from ..runtime import faults
    plan = faults.FaultPlan(seed=seed)
    if phase == "transfer":
        plan.add("drop_migration_block", nth=1)
    elif phase == "cutover":
        plan.add("stall_cutover", nth=1, ms=60)
    elif phase == "source":
        plan.add("kill_source_mid_migration", nth=2,
                 match="replica_a")
    elif phase != "none":
        raise ValueError(f"unknown migration chaos phase: {phase}")
    return plan


def run_migration_chaos(seed: int = 0, n_requests: int = 10,
                        rate_hz: float = 60.0,
                        phase: str = "none",
                        max_new_tokens: int = 48,
                        drain_timeout_s: float = 90.0,
                        make_server: Optional[Callable] = None,
                        config_name: str = "tiny", params=None,
                        device=None) -> Tuple[LoadReport, LoadReport]:
    """Drain-free live-migration chaos gate: an in-process 2-replica
    rig streams requests while a mid-run ``(migrate replica_a)``
    operator command evacuates replica_a's whole in-flight population
    to replica_b mid-decode, under the :func:`migration_chaos_schedule`
    fault ``phase``.  Returns ``(control, migrated)`` where control is
    the identical seeded run WITHOUT the migration (a fleet of its own,
    built by the same ``make_server``).

    The invariants (asserted by tests/test_torch_fleet.py): zero lost,
    zero hung, zero duplicated finals, zero stream mismatches
    (concatenated partials == final sequence, i.e. the double-delivery
    window deduped exactly), and BIT-EXACT final tokens against the
    unmigrated control for every request both runs completed —
    migration must be invisible to the token stream.  The migrated
    report's ``server_stats`` also carries ``on_source_at_migrate``: the
    request ids replica_a held when the ``(migrate …)`` command went
    out, and ``kv_tails_adopted``: the resumes admitted on their
    source's own tail rows."""
    from ..runtime import faults

    make_server = _server_factory(
        make_server, config_name, params, device, slots=4, chunk_steps=2,
        seed=0, enable_prefix_cache=True, max_queue=256, watchdog_s=5.0)
    payload_fn = _elastic_payloads(seed=seed, prompt_len=18,
                                   max_new_tokens=max_new_tokens,
                                   stream=True)

    def one_run(migrate: bool) -> LoadReport:
        plan = None
        on_source: List[str] = []
        try:
            with fleet("migrate", make_server,
                       replica_kwargs={name: dict(kv_fetch_timeout_s=2.0)
                                       for name in ("replica_a",
                                                    "replica_b")},
                       kv_transfer=True) as rig:
                router = rig.router
                generator = LoadGenerator(
                    rig.make_process(9), f"{router.topic_path}/in",
                    payload_fn=payload_fn, rate_hz=rate_hz)
                # Warm the decode paths first (both arms identically):
                # the measured wave then runs at steady speed, so the
                # migration trigger really lands mid-decode.
                generator.run(2, drain_timeout_s=drain_timeout_s)
                if migrate:
                    plan = faults.install(migration_chaos_schedule(
                        seed, phase))
                    source_topic = rig.replicas["replica_a"].topic_path

                    def fire_when_mid_decode():
                        # Deterministic trigger: wait until the source
                        # owns a request that has already streamed at
                        # least one token, then evacuate the source.
                        deadline = time.time() + 30.05
                        time.sleep(0.05)
                        while time.time() < deadline:
                            inflight = list(router._inflight.values())
                            if any(entry.get("replica") == source_topic
                                   and entry.get("delivered", 0) > 0
                                   for entry in inflight):
                                on_source.extend(sorted(
                                    request_id for request_id, entry
                                    in list(router._inflight.items())
                                    if entry.get("replica") == source_topic))
                                router.process.message.publish(
                                    f"{router.topic_path}/in",
                                    f"(migrate {source_topic})")
                                return
                            time.sleep(0.002)

                    timer = threading.Thread(target=fire_when_mid_decode,
                                             daemon=True)
                    timer.start()
                report = generator.run(n_requests,
                                       drain_timeout_s=drain_timeout_s)
                generator.close()
                report.final_tokens = dict(generator.final_tokens)
                stream_mismatches = sum(
                    1 for request_id, partials
                    in generator.partial_tokens.items()
                    if request_id in generator.final_tokens
                    and partials != generator.final_tokens[request_id])
                report.server_stats = dict(
                    router.counters,
                    stream_mismatches=stream_mismatches,
                    migration_cutover_ms=list(
                        router.migration.cutover_ms),
                    on_source_at_migrate=on_source,
                    kv_tails_adopted=sum(
                        getattr(replica.server, "kv_tails_adopted", 0)
                        for replica in rig.replicas.values()),
                    faults_fired=(len(plan.fired) if plan else 0),
                    replicas_live=router.share["replicas"])
                return report
        finally:
            faults.uninstall()

    control = one_run(migrate=False)
    migrated = one_run(migrate=True)
    return control, migrated


def longtail_payloads(n_prefixes: int = 8, prefix_len: int = 96,
                      tail_len: int = 8, max_new_tokens: int = 4,
                      vocab: int = 1024, seed: int = 0,
                      stream: bool = True) -> Callable[[int], Dict]:
    """Long-tail prefix workload: ``n_prefixes`` DISTINCT shared
    prefixes visited round-robin, each request re-sending its prefix
    plus ``tail_len`` fresh tokens.  The reuse distance is therefore
    ``n_prefixes`` requests — size the prefix working set
    (``n_prefixes × prefix_len/block_size`` blocks) past the device pool
    and a pool-only cache thrashes (every hit evicted before its
    reuse), while a host tier holds the whole tail and serves it back
    through restores.  Deterministic from ``seed`` (the JAX package's
    payloads, token for token)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(1, vocab, size=prefix_len).astype(np.int32)
                for _ in range(n_prefixes)]

    def payload_fn(index: int) -> Dict:
        which = index % n_prefixes
        tail = np.asarray(
            [1 + (7919 * (index + 1) + 31 * position) % (vocab - 1)
             for position in range(tail_len)], np.int32)
        payload = {"tokens": np.concatenate([prefixes[which], tail]),
                   "max_new_tokens": max_new_tokens}
        if stream:
            payload["stream"] = 1
        return payload

    return payload_fn


def _longtail_max_seq(prefix_len: int, tail_len: int) -> int:
    """The rigs' ``max_seq``: the prompt plus 8 new tokens, rounded up
    to 16 rows."""
    return ((prefix_len + tail_len + 8 + 15) // 16) * 16


def run_longtail(n_requests: int = 36, rate_hz: float = 25.0,
                 n_prefixes: int = 6, prefix_len: int = 384,
                 tail_len: int = 8,
                 total_blocks: int = 52,
                 host_tier_blocks: int = 160,
                 restore_blocks_per_step: int = 24,
                 chunk_prefill_tokens: int = 64,
                 warmup_requests: int = 12,
                 drain_timeout_s: float = 180.0,
                 seed: int = 0,
                 spill_dir: Optional[str] = None,
                 spill_blocks: int = 1024,
                 make_server: Optional[Callable] = None,
                 config_name: str = "tiny", params=None,
                 device=None) -> LoadReport:
    """Capacity A/B rig for the tiered KV cache: ONE paged replica
    whose device pool (``total_blocks``) is deliberately smaller than
    the longtail workload's prefix working set, behind a prefix-aware
    router.  ``host_tier_blocks=0`` is the pool-only baseline — same
    pool, same workload, eviction deletes.  The tier-on run must beat
    it on ``prefix_hit_rate``; the report's ``prefix_hit_rate_host``
    says how many of the hits only existed because demotion preserved
    them.

    Default sizing makes restore beat recompute in STEPS: a 384-token
    prefix is 24 blocks, so a miss re-prefills 6 chunks of
    ``chunk_prefill_tokens`` = 64 while a host hit defers one step,
    lands the whole chain in one batched scatter
    (``restore_blocks_per_step=24``) and prefills only the tail.

    ``spill_dir`` enables the disk spill tier under the host tier:
    host overflow demotes to disk instead of purging, and the report's
    ``kv_spills`` / ``kv_disk_restores`` counters say how much of the
    working set only survived on disk.  ``make_server(name)`` builds the
    replica's server; without one it is a ``PagedContinuousServer`` of
    ``config_name`` on ``params`` and ``device`` with this sizing."""
    make_server = _server_factory(
        make_server, config_name, params, device, slots=2,
        max_seq=_longtail_max_seq(prefix_len, tail_len), chunk_steps=4,
        seed=0, enable_prefix_cache=True, total_blocks=total_blocks,
        host_tier_blocks=host_tier_blocks,
        restore_blocks_per_step=restore_blocks_per_step,
        chunk_prefill_tokens=chunk_prefill_tokens, spill_dir=spill_dir,
        spill_blocks=spill_blocks, max_queue=256, watchdog_s=10.0)
    with fleet("longtail", make_server, names=("replica_a",)) as rig:
        router, servers = rig.router, list(rig.servers.values())
        generator = LoadGenerator(
            rig.make_process(9), f"{router.topic_path}/in",
            payload_fn=longtail_payloads(
                n_prefixes=n_prefixes, prefix_len=prefix_len,
                tail_len=tail_len, seed=seed),
            rate_hz=rate_hz)
        if warmup_requests:
            # The same payload sequence both arms see in the measured
            # run brings each arm to ITS steady state (tier-on: working
            # set demoted to host; tier-off: pool thrashed), so the A/B
            # measures serving, not first touch.
            generator.run(warmup_requests, drain_timeout_s=drain_timeout_s)
        report = generator.run(n_requests, drain_timeout_s=drain_timeout_s)
        generator.close()
        totals = _fleet_kv_stats(servers)
        _attach_kv_rates(report, totals)
        _attach_pool_census(report, servers)
        report.fleet_latency_ms = fleet_latency(servers)
        report.final_tokens = dict(generator.final_tokens)
        report.server_stats = dict(router.counters, **totals)
        return report


def run_restart(n_requests: int = 12, rate_hz: float = 40.0,
                n_prefixes: int = 3, prefix_len: int = 192,
                tail_len: int = 8,
                total_blocks: int = 20,
                restore_blocks_per_step: int = 16,
                chunk_prefill_tokens: int = 64,
                warmup_requests: int = 6,
                recovery_batch: int = 4,
                hit_rate_floor: float = 0.34,
                drain_timeout_s: float = 180.0,
                seed: int = 0,
                spill_dir: Optional[str] = None,
                spill_blocks: int = 1024,
                adopt: bool = True,
                make_server: Optional[Callable] = None,
                config_name: str = "tiny", params=None,
                device=None) -> LoadReport:
    """Warm-replica-restart rig (loadgen ``--restart-replica``): ONE
    paged replica with ``host_tier_blocks=0`` and a disk spill
    directory, so every demotion lands straight on disk — the durable
    working set.  After a warmup phase that spills the longtail
    prefixes, the replica's PROCESS is killed (the LWT fires, the
    router sees it leave) and a fresh replica is composed on the same
    broker.  ``adopt=True`` hands the respawn the same ``spill_dir``
    (warm restart: the constructor's scan re-adopts every intact chain
    and advertises it); ``adopt=False`` is the cold-restart A/B
    baseline — same death, same respawn, same spill CONFIG (an empty
    sibling directory, so both arms pay the durability tax on
    eviction), but the pre-crash state is lost.  Adoption is the only
    variable.

    ``make_server(name, spill_dir)`` builds a server over ``spill_dir``
    (the directory is the rig's to choose, so the factory takes it);
    without one it is a ``PagedContinuousServer`` of ``config_name`` on
    ``params`` and ``device`` with this sizing.

    The measured phase runs in ``recovery_batch``-request sub-batches;
    per batch the rig computes the respawned replica's prefix hit rate
    from counter deltas and stamps ``restart_recovery_ms`` — time from
    respawn to the END of the first batch at or above
    ``hit_rate_floor`` — into ``report.server_stats`` (beside the
    per-batch ``restart_hit_rates`` curve, ``None`` recovery when the
    floor is never reached).  :func:`run_restart_ab` asserts the two
    arms' greedy outputs are bit-exact."""
    from ..orchestration.continuous import ContinuousReplica
    from ..runtime import actor_args, compose_instance

    if spill_dir is None:
        raise ValueError("run_restart needs a spill_dir — the rig "
                         "exists to measure spill adoption")
    if make_server is None:
        def make_server(_name: str, directory: str):
            from ..orchestration.paged import PagedContinuousServer
            return PagedContinuousServer(
                config_name=config_name, params=params, device=device,
                slots=2, max_seq=_longtail_max_seq(prefix_len, tail_len),
                chunk_steps=4, seed=0, enable_prefix_cache=True,
                total_blocks=total_blocks, host_tier_blocks=0,
                restore_blocks_per_step=restore_blocks_per_step,
                chunk_prefill_tokens=chunk_prefill_tokens,
                spill_dir=directory, spill_blocks=spill_blocks,
                max_queue=256, watchdog_s=10.0)

    with fleet("restart", lambda name: make_server(name, spill_dir),
               names=("replica_a",)) as rig:
        router = rig.router
        server_a = rig.servers["replica_a"]
        payloads = longtail_payloads(
            n_prefixes=n_prefixes, prefix_len=prefix_len,
            tail_len=tail_len, seed=seed)
        generator = LoadGenerator(
            rig.make_process(9), f"{router.topic_path}/in",
            payload_fn=payloads, rate_hz=rate_hz)
        sent_total = 0
        if warmup_requests:
            generator.run(warmup_requests, drain_timeout_s=drain_timeout_s)
            sent_total += warmup_requests
        spilled = int(server_a.stats().get("kv_spills", 0))

        # --- the restart: CRASH the only replica (LWT fires, the
        # registrar evicts it), then respawn it fresh.  The warmup wave
        # has drained, so no server call is in flight on the engine
        # thread: the new server is built here, on the caller's thread,
        # with nothing it could race (a CUDA graph capture fails if
        # another thread does CUDA work meanwhile). ---
        rig.replicas["replica_a"].process.kill()
        _wait_for(lambda: router.share["replicas"] == 0, 30,
                  "restart rig: dead replica leaving the fleet")
        server_b = make_server("replica_b", spill_dir if adopt
                               else spill_dir + "-cold")
        respawned_at = time.time()
        compose_instance(ContinuousReplica, actor_args("replica_b"),
                         process=rig.make_process(4), server=server_b)
        _wait_for(lambda: router.share["replicas"] == 1, 30,
                  "restart rig: respawn discovery")

        # --- measured phase: sub-batched so the hit-rate RECOVERY curve
        # is observable, payload index offset so batches keep walking
        # the same longtail instead of replaying batch one ---
        batches: List[LoadReport] = []
        final_tokens: Dict[str, List[int]] = {}
        hit_rates: List[float] = []
        recovery_ms: Optional[float] = None
        remaining = n_requests
        while remaining > 0:
            batch_n = min(recovery_batch, remaining)
            before = server_b.stats()
            generator.payload_fn = \
                lambda i, base=sent_total: payloads(base + i)
            batch = generator.run(batch_n, drain_timeout_s=drain_timeout_s)
            for request_id, tokens in generator.final_tokens.items():
                final_tokens[f"r{sent_total}_{request_id}"] = tokens
            after = server_b.stats()
            hits = int(after["prefix_hits"]) - int(before["prefix_hits"])
            lookups = hits + (int(after["prefix_misses"])
                              - int(before["prefix_misses"]))
            rate = hits / lookups if lookups else 0.0
            hit_rates.append(round(rate, 4))
            if recovery_ms is None and rate >= hit_rate_floor:
                recovery_ms = round((time.time() - respawned_at) * 1000.0,
                                    1)
            batches.append(batch)
            sent_total += batch_n
            remaining -= batch_n
        generator.close()
        report = LoadReport(
            sent=sum(b.sent for b in batches),
            completed=sum(b.completed for b in batches),
            errors=sum(b.errors for b in batches),
            timeouts=sum(b.timeouts for b in batches),
            elapsed_s=sum(b.elapsed_s for b in batches),
            latencies_ms=[v for b in batches for v in b.latencies_ms],
            tokens_total=sum(b.tokens_total for b in batches),
            ttfts_ms=[v for b in batches for v in b.ttfts_ms],
            duplicate_finals=sum(b.duplicate_finals for b in batches),
            client_ttfts_ms=[v for b in batches
                             for v in b.client_ttfts_ms])
        for batch in batches:
            for phase, values in batch.phase_ms.items():
                report.phase_ms.setdefault(phase, []).extend(values)
            for kind, count in batch.error_kinds.items():
                report.error_kinds[kind] = \
                    report.error_kinds.get(kind, 0) + count
        report.final_tokens = final_tokens
        totals = _fleet_kv_stats([server_b])
        _attach_kv_rates(report, totals)
        report.fleet_latency_ms = fleet_latency([server_b])
        report.server_stats = dict(
            router.counters, **totals,
            warmup_spills=spilled,
            restart_recovery_ms=recovery_ms,
            restart_hit_rates=hit_rates)
        return report


def run_restart_ab(n_requests: int = 18, rate_hz: float = 25.0,
                   seed: int = 0,
                   drain_timeout_s: float = 180.0,
                   **kwargs) -> Tuple[LoadReport, LoadReport]:
    """Warm-restart A/B gate: the SAME seeded longtail sequence through
    :func:`run_restart` twice — cold (respawn spills to an empty
    sibling directory) then warm (respawn adopts the dead replica's) —
    each arm rooted in its own fresh temporary directory so the warmup
    phases are identical.  Asserts the greedy outputs are BIT-EXACT
    request for request (a restored block may never change a token),
    then returns ``(cold, warm)``; the caller checks warm beats cold on
    measured-phase hit rate (and reads mean TTFT)."""
    import tempfile

    reports = []
    for adopt in (False, True):
        with tempfile.TemporaryDirectory(prefix="kvspill-ab-") as root:
            reports.append(run_restart(
                n_requests=n_requests, rate_hz=rate_hz, seed=seed,
                drain_timeout_s=drain_timeout_s,
                spill_dir=os.path.join(root, "spill"),
                adopt=adopt, **kwargs))
    cold, warm = reports
    both = set(cold.final_tokens) & set(warm.final_tokens)
    mismatched = [request_id for request_id in sorted(both)
                  if cold.final_tokens[request_id]
                  != warm.final_tokens[request_id]]
    if mismatched:
        raise AssertionError(
            f"restart A/B not bit-exact (seed={seed}): "
            f"{len(mismatched)}/{len(both)} requests diverged, first "
            f"{mismatched[0]}")
    if not both:
        raise AssertionError(
            "restart A/B compared zero requests — the gate proved "
            "nothing")
    return cold, warm


def run_compile_cache_ab(*_args, **_kwargs):
    """The JAX package's persistent-compilation-cache A/B.  The port's
    kernel build cache is the digest-named library under ``BUILD_DIR``
    (its hits and misses ride the compile ledger); an A/B of it would
    need a fresh engine whose cold arm is an ``nvcc`` build and a knob
    that points the build at another directory (``ROADMAP.md``, queued
    under item 8)."""
    raise NotImplementedError(
        "run_compile_cache_ab needs a cold arm on the kernel build cache "
        "(an nvcc build in another directory; ROADMAP.md, queued under "
        "item 8), which is not ported")


def diurnal_trace(duration_s: float, base_hz: float = 2.0,
                  peak_hz: float = 12.0, period_s: float = 8.0,
                  burst_hz: float = 0.0, burst_every_s: float = 0.0,
                  burst_len_s: float = 1.0,
                  seed: int = 0) -> List[float]:
    """Seeded diurnal arrival schedule: send offsets (seconds) for a
    sinusoidal base rate — ``base_hz`` in the valley, ``peak_hz`` at
    the crest, period ``period_s`` — with optional Poisson-arriving
    bursts (``burst_hz`` extra for ``burst_len_s``, mean gap
    ``burst_every_s``).  Arrivals are a non-homogeneous Poisson
    process generated by thinning, fully deterministic per ``seed`` —
    the workload shape an autoscaler must track (valleys are where a
    static peak-sized fleet wastes replicas; bursts are what hysteresis
    must not overreact to).  Feed to :meth:`LoadGenerator.run_trace`."""
    import math
    import random

    rng = random.Random(seed)
    bursts: List[Tuple[float, float]] = []
    if burst_hz > 0 and burst_every_s > 0:
        t = rng.expovariate(1.0 / burst_every_s)
        while t < duration_s:
            bursts.append((t, t + burst_len_s))
            t += burst_len_s + rng.expovariate(1.0 / burst_every_s)

    def rate_at(t: float) -> float:
        wave = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / period_s))
        rate = base_hz + (peak_hz - base_hz) * wave
        if any(start <= t < end for start, end in bursts):
            rate += burst_hz
        return rate

    rate_max = max(base_hz, peak_hz) + burst_hz
    times: List[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate_max)
        if t >= duration_s:
            return times
        if rng.random() * rate_max < rate_at(t):
            times.append(t)


def elastic_chaos_schedule(seed: int):
    """The seeded fault schedule gating elastic scale-down: during a
    scripted ``scale_target`` 3→2 scale-down (victim: the idlest
    replica — lexicographically ``decode1`` in the early-run valley),
    ``decode3`` is killed outright, its replacement's first spawn
    attempt fails, and the retry is slow-started.  The invariant: the
    fleet still converges to the target with zero lost and zero
    double-delivered requests.  The rig installs this plan AFTER its
    warmup phase, so ``nth`` counts start with the measured run (the
    JAX package's schedule, rule for rule)."""
    from ..runtime import faults
    return (
        faults.FaultPlan(seed=seed)
        # In-process kill (no hard=1: os._exit would take the whole
        # rig); pump count puts it mid-load, after the scale-down.
        .add("kill_replica", nth=6 + seed % 5, match="decode3")
        # The post-kill REPLACEMENT spawn fails outright (bootstrap
        # spawns happened before the plan was installed).
        .add("fail_spawn", nth=1, match="decode3")
        # The retry after the failed replacement announces late
        # (pending-spawn accounting covers the gap — no spawn storm).
        .add("slow_start", nth=1, match="decode3", ms=300))


def run_elastic(duration_s: float = 10.0, seed: int = 0,
                base_hz: float = 2.0, peak_hz: float = 12.0,
                period_s: float = 8.0, burst_hz: float = 0.0,
                burst_every_s: float = 0.0, burst_len_s: float = 1.0,
                slo_ttft_ms: float = 500.0,
                static_replicas: Optional[int] = None,
                policy=None, stream: bool = False,
                max_new_tokens: int = 4,
                drain_timeout_s: float = 90.0,
                fault_plan=None,
                scale_script: Tuple[Tuple[float, int], ...] = (),
                command_script: Tuple[Tuple[float, str], ...] = (),
                converge_s: float = 0.0,
                warmup: int = 0,
                make_server: Optional[Callable] = None,
                config_name: str = "tiny", params=None,
                device=None) -> LoadReport:
    """In-process ELASTIC serving rig: a :class:`~..orchestration
    .autoscaler.FleetAutoscaler` owns the replica fleet (its spawner
    builds a ContinuousReplica over ``make_server(slot)``; its
    terminator kills the replica's Process so the Registrar LWT path
    runs for real) behind a ReplicaRouter, driven by a
    :func:`diurnal_trace` schedule, on one loopback broker and one
    engine thread (:func:`fleet`).

    ``static_replicas=N`` instead pins a fixed N-replica fleet with no
    autoscaler — the A/B baseline: the autoscaled fleet must beat the
    static PEAK-sized fleet on ``goodput_per_replica`` over a diurnal
    day.

    ``scale_script`` is a sequence of ``(delay_s, target)`` operator
    ``(scale_target …)`` commands fired mid-run (the chaos gate's
    scripted scale-down); ``command_script`` fires arbitrary raw
    operator s-exprs at the autoscaler (e.g. ``(rolling_upgrade)``
    for the zero-downtime upgrade rig); ``fault_plan`` installs a
    :mod:`~..runtime.faults` plan for the run; ``converge_s`` waits
    after the load for the fleet to settle (live == target, nothing
    pending or draining) and records ``converged`` in
    ``server_stats``.

    ``warmup`` sends that many throwaway requests BEFORE the measured
    run (and before the fault plan installs), so the first steps'
    graph captures do not smear the scale/fault timeline.

    Without ``make_server`` each replica serves a
    ``PagedContinuousServer`` of ``config_name`` on ``params`` and
    ``device`` (the card unless ``device="cpu"``).  The report carries
    the final tokens and, in ``server_stats``, the autoscaler's
    counters, the router's migration counters, ``kv_tails_adopted``, the
    steady-state captures summed over every server built and
    ``fleet_events``: each spawn, stop and operator command with its
    seconds from the measured run's start."""
    from ..orchestration.autoscaler import AutoscalerPolicy, FleetAutoscaler
    from ..orchestration.continuous import ContinuousReplica
    from ..runtime import actor_args, compose_instance, faults

    make_server = _server_factory(
        make_server, config_name, params, device, slots=2, chunk_steps=4,
        seed=0, enable_prefix_cache=True, max_queue=256, watchdog_s=5.0)
    #: every server built for the run (static and spawned), in order.
    servers: List = []
    #: slot -> the Process of its latest replica.
    processes: Dict[str, object] = {}
    #: (seconds from the measured run's start, event, slot or command):
    #: the fleet's spawns, stops and operator commands, in order.
    events: List[Tuple[float, str, str]] = []
    began = [0.0]

    def note(event: str, what: str) -> None:
        events.append((time.time(), event, what))

    def build(name: str):
        server = make_server(name)
        servers.append(server)
        return server

    names = [f"static{index + 1}" for index in range(static_replicas or 0)]
    timers: List[threading.Timer] = []
    try:
        with fleet("elastic", build, names=names,
                   kv_transfer=True) as rig:
            router = rig.router
            pids = iter(range(100, 10 ** 6))

            def spawner(slot: str, _role: str):
                # The autoscaler calls this from its tick timer, ON the
                # engine thread — the thread every server call runs on.
                # The new server is built there, so no step of another
                # server (and no CUDA graph capture, which fails if
                # another thread does CUDA work meanwhile) can run
                # beside its construction.  The tick stalls for the
                # build; a caller that cannot afford that hands
                # ``make_server`` servers built beforehand.
                note("spawn", slot)
                process = rig.make_process(next(pids))
                compose_instance(ContinuousReplica, actor_args(slot),
                                 process=process, server=build(slot))
                processes[slot] = process

            def terminator(slot: str, _mode: str):
                # Non-graceful: the LWT (absent) fires, exactly the
                # eviction path a dead OS process takes.  On the engine
                # thread, as the kill_replica fault does it: a loopback
                # disconnect only queues messages.
                process = processes.get(slot)
                if process is not None:
                    note("stop", slot)
                    process.terminate(graceful=False)

            autoscaler = None
            if static_replicas is not None:
                expected = static_replicas
            else:
                if policy is None:
                    policy = AutoscalerPolicy(
                        target=1, max_replicas=3, ttft_slo_ms=slo_ttft_ms,
                        breach_windows=2, clear_windows=8,
                        cooldown_s=2.0, spawn_timeout_s=60.0,
                        drain_timeout_s=15.0)
                expected = policy.initial_targets().get("decode", 1)
                autoscaler = compose_instance(
                    FleetAutoscaler, actor_args("autoscaler"),
                    process=rig.make_process(8), spawner=spawner,
                    terminator=terminator, policy=policy, tick_s=0.25)
            _wait_for(lambda: router.share["replicas"] >= expected, 90,
                      f"elastic rig: router discovery of {expected} "
                      "replicas")
            generator = LoadGenerator(
                rig.make_process(9), f"{router.topic_path}/in",
                payload_fn=_elastic_payloads(
                    seed=seed, max_new_tokens=max_new_tokens,
                    stream=stream),
                rate_hz=0)
            if warmup:
                # Throwaway burst; spacing gives P2C a chance to touch
                # every replica.
                generator.run_trace([0.1 * i for i in range(warmup)],
                                    drain_timeout_s=30.0)
            if fault_plan is not None:
                faults.install(fault_plan)
            commands = [(delay_s, f"(scale_target {target})")
                        for delay_s, target in scale_script]
            commands += list(command_script)

            def fire(command: str) -> None:
                note("command", command)
                autoscaler.process.message.publish(
                    f"{autoscaler.topic_path}/in", command)
            began[0] = time.time()
            for delay_s, command in (commands if autoscaler is not None
                                     else ()):
                timer = threading.Timer(delay_s, fire, args=(command,))
                timer.daemon = True
                timer.start()
                timers.append(timer)
            times = diurnal_trace(
                duration_s, base_hz=base_hz, peak_hz=peak_hz,
                period_s=period_s, burst_hz=burst_hz,
                burst_every_s=burst_every_s, burst_len_s=burst_len_s,
                seed=seed)
            replica_seconds_0 = (
                float(autoscaler.share["replica_seconds"])
                if autoscaler is not None else 0.0)
            report = generator.run_trace(times,
                                         drain_timeout_s=drain_timeout_s)
            generator.close()
            report.slo_ttft_ms = slo_ttft_ms
            report.final_tokens = dict(generator.final_tokens)
            # Stream-consistency audit: for every streamed request the
            # concatenated partials must equal the final token sequence
            # — a drain/kill/re-dispatch that re-streams or drops a
            # token shows up here as a mismatch.
            stream_mismatches = sum(
                1 for request_id, partials
                in generator.partial_tokens.items()
                if request_id in generator.final_tokens
                and partials != generator.final_tokens[request_id])
            fleet_stats = dict(
                kv_tails_adopted=sum(getattr(server, "kv_tails_adopted", 0)
                                     for server in servers),
                graph_captures_steady_state=sum(
                    server.graph_ledger.steady_captures
                    for server in servers),
                servers_built=len(servers),
                fleet_events=[(round(at - began[0], 3), event, what)
                              for at, event, what in events])
            if autoscaler is not None:
                converged = None
                if converge_s:
                    want = sum(autoscaler.state.targets.values())

                    def settled():
                        return (autoscaler.share["replicas_live"] == want
                                and autoscaler.share["replicas_pending"]
                                == 0
                                and autoscaler.share["replicas_draining"]
                                == 0)

                    deadline = time.time() + converge_s
                    while not settled() and time.time() < deadline:
                        time.sleep(0.05)
                    converged = settled()
                report.replica_seconds = (
                    float(autoscaler.share["replica_seconds"])
                    - replica_seconds_0)
                report.server_stats = dict(
                    autoscaler.stats(),
                    router_shed=router.counters["shed"],
                    redispatches=router.counters["redispatches"],
                    migrations_started=router.counters[
                        "migrations_started"],
                    migrations_completed=router.counters[
                        "migrations_completed"],
                    migrations_aborted=router.counters[
                        "migrations_aborted"],
                    migration_cutover_ms=list(router.migration.cutover_ms),
                    stream_mismatches=stream_mismatches,
                    faults_fired=(len(fault_plan.fired)
                                  if fault_plan is not None else 0),
                    **fleet_stats)
                if converged is not None:
                    report.server_stats["converged"] = converged
            else:
                report.replica_seconds = static_replicas * report.elapsed_s
                report.server_stats = dict(
                    replicas_live=router.share["replicas"],
                    router_shed=router.counters["shed"],
                    redispatches=router.counters["redispatches"],
                    stream_mismatches=stream_mismatches, **fleet_stats)
            report.fleet_latency_ms = fleet_latency(servers)
            return report
    finally:
        for timer in timers:
            timer.cancel()
        if fault_plan is not None:
            faults.uninstall()


def run_elastic_chaos(seed: int = 0, duration_s: float = 8.0,
                      **kwargs) -> LoadReport:
    """The chaos gate for elastic scale-down: a 3-replica autoscaled
    fleet under streaming load gets a scripted ``scale_target 2``
    (graceful drain) while :func:`elastic_chaos_schedule` kills a
    NON-draining replica and fails its replacement's first spawn.  The
    run must converge to the target with ``lost == 0`` and
    ``duplicate_finals == 0`` — the hard invariant of the drain
    design.  SLO-driven scaling is frozen (huge windows) so only the
    scripted scale-in and self-healing move the fleet."""
    from ..orchestration.autoscaler import AutoscalerPolicy

    policy = AutoscalerPolicy(
        target=3, min_replicas=1, max_replicas=4,
        breach_windows=10 ** 6, clear_windows=10 ** 6,
        cooldown_s=3600.0, spawn_timeout_s=60.0,
        drain_timeout_s=10.0, backoff_base_s=0.5,
        crash_loop_threshold=3, crash_loop_window_s=60.0)
    kwargs.setdefault("scale_script", ((max(0.6, duration_s * 0.1), 2),))
    kwargs.setdefault("converge_s", 30.0)
    kwargs.setdefault("stream", True)
    kwargs.setdefault("warmup", 6)
    return run_elastic(duration_s=duration_s, seed=seed, policy=policy,
                       fault_plan=elastic_chaos_schedule(seed), **kwargs)


def run_rolling_upgrade(duration_s: float = 10.0, seed: int = 0,
                        replicas: int = 4,
                        drain_based: bool = False,
                        **kwargs) -> LoadReport:
    """Zero-downtime rolling upgrade goodput trace: a ``replicas``-
    strong autoscaled fleet under streaming diurnal load receives a
    mid-run ``(rolling_upgrade)`` — every replica is replaced one at a
    time with its in-flight population LIVE-MIGRATED onto the
    successor.  ``drain_based=True`` is the A/B control: the same
    replacement loop but each predecessor drains its tail instead of
    migrating it (``policy.migrate_drains`` off)."""
    from ..orchestration.autoscaler import AutoscalerPolicy

    policy = AutoscalerPolicy(
        target=replicas, min_replicas=1, max_replicas=replicas + 2,
        breach_windows=10 ** 6, clear_windows=10 ** 6,
        cooldown_s=3600.0, spawn_timeout_s=60.0,
        drain_timeout_s=20.0,
        migrate_drains=not drain_based)
    kwargs.setdefault("command_script",
                      ((max(0.6, duration_s * 0.15), "(rolling_upgrade)"),))
    kwargs.setdefault("converge_s", 60.0)
    kwargs.setdefault("stream", True)
    kwargs.setdefault("warmup", 6)
    # Dense enough that every replica holds live streams at any
    # instant: each handoff then really carries an in-flight
    # population instead of landing in a gap between requests.
    kwargs.setdefault("base_hz", 8.0)
    kwargs.setdefault("peak_hz", 12.0)
    kwargs.setdefault("max_new_tokens", 48)
    return run_elastic(duration_s=duration_s, seed=seed, policy=policy,
                       **kwargs)


def run_spec_ab(spec_k: int = 4, n_requests: int = 24,
                rate_hz: float = 50.0, seed: int = 0, chaos: bool = False,
                drain_timeout_s: float = 90.0, config_name: str = "tiny",
                params=None, device=None) -> Tuple[LoadReport, LoadReport]:
    """A/B gate for speculative decoding on the serving path: the SAME
    seeded payload sequence through the same 2-replica paged rig, once
    plain and once with a ``spec_k``-token paired draft, asserting the
    greedy outputs BIT-EXACT request for request.  ``chaos=True`` runs
    both sides under :func:`chaos_schedule`: a replica dying mid-round
    must re-dispatch idempotently (zero lost, zero duplicated finals) and
    still match the plain side token for token, which rules out
    half-committed speculative state leaking across the replay.  Returns
    ``(base_report, spec_report)``; the spec report carries the fleet's
    ``spec_stats`` and the requests' ``spec_accept_hist``."""
    serving = dict(rate_hz=rate_hz, drain_timeout_s=drain_timeout_s,
                   config_name=config_name, params=params, device=device)
    if chaos:
        base = run_chaos(seed=seed, n_requests=n_requests, **serving)
        spec = run_chaos(seed=seed, n_requests=n_requests, spec_k=spec_k,
                         **serving)
    else:
        payloads = dict(n_conversations=3, turns=4, system_len=48,
                        seed=seed)
        base = run_shared_prefix(
            n_requests=n_requests,
            payload_fn=shared_prefix_payloads(**payloads), **serving)
        spec = run_shared_prefix(
            n_requests=n_requests,
            payload_fn=shared_prefix_payloads(**payloads), spec_k=spec_k,
            **serving)
    both = set(base.final_tokens) & set(spec.final_tokens)
    mismatched = [request_id for request_id in sorted(both)
                  if base.final_tokens[request_id]
                  != spec.final_tokens[request_id]]
    if mismatched:
        raise AssertionError(
            f"spec A/B not bit-exact (spec_k={spec_k}, seed={seed}): "
            f"{len(mismatched)}/{len(both)} requests diverged, first "
            f"{mismatched[0]}")
    if not both:
        raise AssertionError(
            "spec A/B compared zero requests: both runs completed "
            "disjoint id sets, the gate proved nothing")
    return base, spec


def command_automaton(vocab: int = 1024):
    """Token grammar of the structured workload's agentic "tool call": a
    JSON-shaped command ``{ "action" : VERB , "args" : [ ARG{0..2} ] }``
    where every skeleton token (braces, key names, colons, commas) is the
    SOLE legal token of its state.  Those states chain into deterministic
    segments the jump-forward path commits with no model choice: of the
    8-11 generated tokens only the verb and args are the model's.  Token
    ids 3-17, so any vocabulary of 18 or more takes it."""
    from ..models.constrained import automaton_from_rules

    LBRACE, KEY_ACTION, COLON, COMMA = 10, 11, 12, 13
    KEY_ARGS, LBRACK, RBRACK, RBRACE = 14, 15, 16, 17
    VERBS, ARGS = (3, 4, 5), (6, 7, 8, 9)
    return automaton_from_rules(
        vocab=vocab,
        rules={
            0: [((LBRACE,), 1)],
            1: [((KEY_ACTION,), 2)],      # forced: "action"
            2: [((COLON,), 3)],           # forced: :
            3: [(VERBS, 4)],              # the model picks the verb
            4: [((COMMA,), 5)],           # forced: ,
            5: [((KEY_ARGS,), 6)],        # forced: "args"
            6: [((COLON,), 7)],           # forced: :
            7: [((LBRACK,), 8)],          # forced: [
            8: [(ARGS, 9), ((RBRACK,), 10)],
            9: [(ARGS, 11), ((RBRACK,), 10)],
            11: [((RBRACK,), 10)],        # forced: ] (args capped)
            10: [((RBRACE,), 12)],        # forced: }
            12: [],                       # terminal
        },
        accepting=[12])


def structured_payloads(n_contexts: int = 3, context_len: int = 32,
                        tail_len: int = 8, max_new_tokens: int = 16,
                        vocab: int = 1024, seed: int = 0,
                        constrained: bool = True) -> Callable[[int], Dict]:
    """Agentic structured-output traffic (the JAX rig's payloads):
    ``n_contexts`` shared "tool context" prefixes (the scaffold every turn
    re-sends: prefix-cache food), each followed by a fresh observation
    tail, answered with a grammar-constrained command
    (``automaton="cmd"``), greedy.  ``constrained=False`` sends the same
    sequence without the automaton field: the free side of the A/B."""
    import numpy as np

    rng = np.random.RandomState(seed)
    contexts = [rng.randint(1, vocab, size=context_len).astype(np.int32)
                for _ in range(n_contexts)]

    def payload_fn(index: int) -> Dict:
        context = contexts[index % n_contexts]
        tail = np.asarray(
            [1 + (7451 * (index + 1) + 17 * position) % (vocab - 1)
             for position in range(tail_len)], np.int32)
        payload = {"tokens": np.concatenate([context, tail]),
                   "max_new_tokens": max_new_tokens, "temperature": 0.0}
        if constrained:
            payload["automaton"] = "cmd"
        return payload

    return payload_fn


def run_structured(n_requests: int = 24, rate_hz: float = 50.0,
                   spec_k: int = 4, draft_mode: str = "ngram",
                   chaos: bool = False, drain_timeout_s: float = 90.0,
                   seed: int = 0, make_server: Optional[Callable] = None,
                   config_name: str = "tiny", params=None, device=None,
                   payload_kwargs: Optional[Dict] = None
                   ) -> Tuple[LoadReport, LoadReport]:
    """Structured-output gate: the SAME seeded agentic payload sequence
    (:func:`structured_payloads`, with ``payload_kwargs``) through a
    2-replica paged rig with :func:`command_automaton` registered as
    ``"cmd"``, once grammar-constrained and once free; returns
    ``(constrained_report, free_report)``.  Raises unless every
    constrained final is accepted by the grammar (chaos replays included:
    half-committed automaton state leaking across a re-dispatch would show
    here).  The reports carry ``spec_stats`` (``spec_jump_forward_tokens``:
    the skeleton's forced segments committed through verify windows) and
    the pair gives the constrained-against-free tokens/s.  ``chaos=True``
    arms :func:`chaos_schedule` on both sides.  ``make_server(name)``
    builds each pass's servers (with ``automata={"cmd": ...}`` and
    speculation); without it ``PagedContinuousServer`` s of
    ``config_name`` on ``params`` and ``device`` (``draft_mode`` "ngram"
    runs model-free; "model" a paired draft)."""
    from ..runtime import faults

    payload_kwargs = dict(payload_kwargs or {})
    vocab = payload_kwargs.get("vocab", 1024)
    automaton = command_automaton(vocab)
    if make_server is None:
        def make_server(_name: str):
            from ..orchestration.paged import PagedContinuousServer
            server = PagedContinuousServer(
                config_name=config_name, params=params, device=device,
                slots=2, chunk_steps=4, seed=0, enable_prefix_cache=True,
                max_queue=256, watchdog_s=5.0, draft_mode=draft_mode,
                draft_config_name=(config_name if draft_mode == "model"
                                   else None),
                spec_k=spec_k, automata={"cmd": automaton})
            if draft_mode == "model":
                _enable_paired_draft(server, spec_k)
            return server

    def one_pass(constrained: bool) -> LoadReport:
        plan = faults.install(chaos_schedule(seed)) if chaos else None
        try:
            with fleet("structured", make_server, kv_transfer=True) as rig:
                router, servers = rig.router, list(rig.servers.values())
                generator = LoadGenerator(
                    rig.make_process(9), f"{router.topic_path}/in",
                    payload_fn=structured_payloads(
                        seed=seed, constrained=constrained,
                        **payload_kwargs),
                    rate_hz=rate_hz)
                report = generator.run(n_requests,
                                       drain_timeout_s=drain_timeout_s)
                generator.close()
                report.final_tokens = dict(generator.final_tokens)
                report.fleet_latency_ms = fleet_latency(servers)
                report.spec_stats = _fleet_spec_stats(servers)
                report.spec_accept_hist = dict(generator.spec_accept_hist)
                report.server_stats = dict(router.counters)
                if plan is not None:
                    report.server_stats["faults_fired"] = len(plan.fired)
                return report
        finally:
            if chaos:
                faults.uninstall()

    cons = one_pass(constrained=True)
    free = one_pass(constrained=False)
    bad = [request_id for request_id, tokens
           in sorted(cons.final_tokens.items())
           if not automaton.accepts(list(tokens))]
    if bad:
        raise AssertionError(
            f"structured workload: {len(bad)}/{len(cons.final_tokens)} "
            f"constrained finals ungrammatical (seed={seed}, "
            f"chaos={chaos}), first {bad[0]}")
    if not cons.final_tokens:
        raise AssertionError(
            "structured workload: zero constrained finals, the grammar gate "
            "proved nothing")
    return cons, free


def multitenant_payloads(n_adapters: int = 4, zipf_s: float = 1.2,
                         prompt_len: int = 12, max_new_tokens: int = 4,
                         vocab: int = 1024, seed: int = 0,
                         schedule_len: int = 4096) -> Callable[[int], Dict]:
    """Multi-tenant traffic (the JAX rig's payloads): every request names
    one of ``n_adapters`` tenants' adapters, drawn from a zipf-shaped
    popularity (``weight ∝ 1 / rank^zipf_s``: a few hot tenants, a long
    tail), on per-request prompts with NO shared prefix, so the A/B
    isolates adapter locality from prefix locality."""
    import numpy as np

    rng = np.random.RandomState(seed)
    weights = 1.0 / np.arange(1, n_adapters + 1) ** zipf_s
    weights /= weights.sum()
    schedule = rng.choice(n_adapters, size=schedule_len, p=weights)

    def payload_fn(index: int) -> Dict:
        which = int(schedule[index % schedule_len])
        prompt = np.asarray(
            [1 + (7919 * (index + 1) + 31 * position) % (vocab - 1)
             for position in range(prompt_len)], np.int32)
        return {"tokens": prompt, "max_new_tokens": max_new_tokens,
                "adapter": f"tenant-{which}"}

    return payload_fn


def _noisy_loadgen_adapter(config, lora_config, seed: int):
    """A host-side random adapter whose B factors are non-zero (a fresh
    adapter is an exact no-op): numpy only, the JAX rig's draws, so the
    rig mints tenants without touching the device."""
    import numpy as np

    from ..models.lora import factor_dims
    rng = np.random.RandomState(seed)
    in_dims, out_dims = factor_dims(config)
    layers = []
    for _ in range(config.n_layers):
        layer = {}
        for target in lora_config.targets:
            layer[target] = {
                "a": (rng.randn(in_dims[target], lora_config.rank)
                      * in_dims[target] ** -0.5).astype(np.float32),
                "b": (rng.randn(lora_config.rank, out_dims[target])
                      * 0.05).astype(np.float32)}
        layers.append(layer)
    return {"layers": layers}


def run_multitenant(n_requests: int = 32, rate_hz: float = 25.0,
                    n_adapters: int = 4, zipf_s: float = 1.2,
                    adapter_aware: bool = True, warmup_requests: int = 8,
                    drain_timeout_s: float = 120.0, seed: int = 0,
                    make_server: Optional[Callable] = None,
                    config_name: str = "tiny", params=None, device=None,
                    lora_config=None,
                    payload_kwargs: Optional[Dict] = None) -> LoadReport:
    """Warm-adapter-routing A/B rig: TWO paged replicas, each holding HALF
    the tenants' adapters (evens on ``replica_a``, odds on ``replica_b``:
    every adapter warm on exactly one replica), behind the adapter-aware
    router (``adapter_affinity=1``) or the adapter-blind baseline (0: P2C,
    never reading the adapter field).  The blind router lands about half
    the zipf-distributed requests on the WRONG replica, each an
    ``unknown_adapter`` rejection the client must answer with a re-upload
    (``adapter_cold_starts``); the aware one reads adapter residency off
    the same prefix digests and must take ZERO.

    ``make_server(name)`` builds a replica's server; the rig then loads
    its tenants (``_noisy_loadgen_adapter`` of ``lora_config``, default
    rank 4 on ``wq``/``wv``, seeds 100 + tenant).  Without it
    ``PagedContinuousServer`` s of ``config_name`` on ``params`` and
    ``device`` at the JAX rig's shape.  ``payload_kwargs`` go to
    :func:`multitenant_payloads`.  The report's ``final_tokens`` and
    ``final_adapters`` (request id -> tenant) let a caller hold every
    final to its oracle."""
    from ..kvstore.adapters import adapter_hex
    from ..models import llama
    from ..models.lora import LoRAConfig

    lora_config = lora_config or LoRAConfig(rank=4, alpha=8.0,
                                            targets=("wq", "wv"))
    config = llama.CONFIGS[config_name]
    if make_server is None:
        def make_server(_name: str):
            from ..orchestration.paged import PagedContinuousServer
            return PagedContinuousServer(
                config_name=config_name, params=params, device=device,
                slots=4, max_seq=64, chunk_steps=4, seed=0,
                enable_prefix_cache=True, total_blocks=96, max_queue=256,
                watchdog_s=10.0)
    names = ("replica_a", "replica_b")

    def build(name: str):
        server = make_server(name)
        # Home placement: each tenant's factors are paged (and
        # digest-advertised) on exactly one replica, so routing alone
        # decides warm against cold.
        for tenant in range(names.index(name), n_adapters, 2):
            server.load_adapter(
                f"tenant-{tenant}",
                _noisy_loadgen_adapter(config, lora_config,
                                       seed=100 + tenant),
                lora_config)
        return server

    payload_fn = multitenant_payloads(n_adapters=n_adapters, zipf_s=zipf_s,
                                      seed=seed, **(payload_kwargs or {}))
    with fleet("mtenant", build, names=names,
               adapter_affinity=1.0 if adapter_aware else 0.0) as rig:
        router, servers = rig.router, list(rig.servers.values())
        hexes = [adapter_hex(f"tenant-{t}") for t in range(n_adapters)]
        _wait_for(lambda: all(
            router.directory.adapter_owners(h, router.process.event.now())
            for h in hexes), 30,
            "mtenant rig: adapter residency in the fleet's digests")
        generator = LoadGenerator(rig.make_process(9),
                                  f"{router.topic_path}/in",
                                  payload_fn=payload_fn, rate_hz=rate_hz)
        if warmup_requests:
            generator.run(warmup_requests, drain_timeout_s=drain_timeout_s)
            for counter in ("adapter_warm_routes", "adapter_cold_routes"):
                router.counters[counter] = 0
        report = generator.run(n_requests, drain_timeout_s=drain_timeout_s)
        generator.close()
        report.adapter_cold_starts = \
            report.error_kinds.get("unknown_adapter", 0)
        report.adapter_warm_routes = \
            router.counters.get("adapter_warm_routes", 0)
        report.adapter_cold_routes = \
            router.counters.get("adapter_cold_routes", 0)
        report.final_tokens = dict(generator.final_tokens)
        # Request ids are ``lg<run>_<index>``; the payloads are the
        # deterministic ``payload_fn(index)``.
        report.final_adapters = {
            request_id: payload_fn(int(request_id.rsplit("_", 1)[1]))
            ["adapter"] for request_id in report.final_tokens}
        totals = _fleet_kv_stats(servers)
        _attach_kv_rates(report, totals)
        _attach_pool_census(report, servers)
        report.server_stats = dict(router.counters, **{
            key: sum(server.stats().get(key, 0) for server in servers)
            for key in ("adapter_warm_loads", "adapter_cold_loads",
                        "adapter_pages_hbm", "adapter_pages_host",
                        "adapter_pages_disk")})
        return report


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m aiko_services_tpu_torch.tools.loadgen --chaos`` (seeded
    fault schedule; exit 1 if any request was lost or hung),
    ``--elastic-chaos``, ``--migrate-mid-stream``, ``--rolling-upgrade``,
    ``--restart-replica``, ``--spec-k K`` (the speculative A/B, under
    the chaos schedule with ``--chaos``) or ``--workload shared_prefix|
    diurnal|longtail|structured|multitenant``.  Every rig serves ``tiny``
    with random weights from the seed on the card, or on the CPU with
    ``--device cpu``."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Serving load generator of the port (chaos mode: "
                    "seeded fault-injection run asserting zero lost "
                    "requests; workloads through the router)")
    parser.add_argument("--device", default=None,
                        help="torch device of every server (default: the "
                             "card; 'cpu' to run without one)")
    parser.add_argument("--chaos", action="store_true",
                        help="run the seeded fault schedule against "
                             "an in-process 2-replica rig")
    parser.add_argument("--elastic-chaos", action="store_true",
                        help="run the elastic scale-down chaos gate "
                             "(drain + kill-during-drain + failed "
                             "replacement spawn; exit 1 unless zero "
                             "lost/duplicated and converged)")
    parser.add_argument("--migrate-mid-stream", action="store_true",
                        help="live-migration chaos gate; exit 1 unless "
                             "zero lost/duplicated/mismatched and "
                             "bit-exact vs the unmigrated control")
    parser.add_argument("--migration-phase", default="none",
                        choices=["none", "transfer", "cutover", "source"],
                        help="--migrate-mid-stream: which migration phase "
                             "the seeded fault hits")
    parser.add_argument("--rolling-upgrade", action="store_true",
                        help="zero-downtime rolling upgrade trace: replace "
                             "every replica one at a time with live "
                             "migration, vs the drain-based control")
    parser.add_argument("--workload",
                        choices=["shared_prefix", "diurnal", "longtail",
                                 "structured", "multitenant"],
                        help="named workload profile (in-process rig)")
    parser.add_argument("--tenants", type=int, default=4,
                        help="multitenant: distinct LoRA adapters "
                             "(tenants), half warm on each replica")
    parser.add_argument("--zipf-s", type=float, default=1.2,
                        help="multitenant: zipf exponent of adapter "
                             "popularity")
    parser.add_argument("--draft-mode", default="ngram",
                        choices=["ngram", "model"],
                        help="structured: proposer for the free rows")
    parser.add_argument("--structured-k", type=int, default=4,
                        help="structured: speculation window (jump-forward "
                             "segments ride it)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--requests", type=int, default=40)
    parser.add_argument("--rate-hz", type=float, default=100.0)
    parser.add_argument("--duration", type=float, default=12.0,
                        help="diurnal/elastic: run length (seconds)")
    parser.add_argument("--base-hz", type=float, default=2.0,
                        help="diurnal: valley request rate")
    parser.add_argument("--peak-hz", type=float, default=12.0,
                        help="diurnal: crest request rate")
    parser.add_argument("--period", type=float, default=8.0,
                        help="diurnal: sinusoid period (seconds)")
    parser.add_argument("--slo-ttft-ms", type=float, default=500.0,
                        help="diurnal: TTFT SLO goodput is judged against")
    parser.add_argument("--static-replicas", type=int, default=None,
                        help="diurnal: pin a fixed fleet (A/B baseline) "
                             "instead of autoscaling")
    parser.add_argument("--conversations", type=int, default=3,
                        help="shared_prefix: interleaved conversations")
    parser.add_argument("--turns", type=int, default=4,
                        help="shared_prefix: turns per conversation")
    parser.add_argument("--system-len", type=int, default=48,
                        help="shared_prefix: shared system prompt tokens")
    parser.add_argument("--no-prefix-routing", action="store_true",
                        help="shared_prefix: disable prefix-aware scoring "
                             "(A/B baseline)")
    parser.add_argument("--prefixes", type=int, default=6,
                        help="longtail: distinct shared prefixes")
    parser.add_argument("--prefix-len", type=int, default=384,
                        help="longtail: tokens per shared prefix")
    parser.add_argument("--hbm-blocks", type=int, default=52,
                        help="longtail: device pool size in blocks "
                             "(deliberately smaller than the prefix "
                             "working set)")
    parser.add_argument("--host-blocks", type=int, default=160,
                        help="longtail: host tier capacity in blocks "
                             "(0 = tier off, the A/B baseline)")
    parser.add_argument("--tier-off", action="store_true",
                        help="longtail: shorthand for --host-blocks 0")
    parser.add_argument("--disk-blocks", type=int, default=0,
                        help="longtail: disk spill tier capacity in blocks "
                             "under a fresh temporary directory (0 = no "
                             "spill tier)")
    parser.add_argument("--restart-replica", action="store_true",
                        help="warm-restart chaos A/B: kill the only "
                             "replica mid-run and respawn it cold vs "
                             "spill-adopting; exit 1 unless greedy outputs "
                             "are bit-exact and the warm arm beats cold "
                             "on hit rate")
    parser.add_argument("--spec-k", type=int, default=0,
                        help="speculative A/B gate: run the seeded "
                             "payload sequence plain AND with a "
                             "k-token paired draft, assert BIT-EXACT "
                             "outputs, report acceptance histograms "
                             "(with --chaos: under the fault schedule)")
    args = parser.parse_args(argv)
    serving = dict(device=args.device)
    if args.workload == "structured":
        cons, free = run_structured(
            n_requests=args.requests, rate_hz=args.rate_hz,
            spec_k=args.structured_k, draft_mode=args.draft_mode,
            chaos=args.chaos, seed=args.seed, **serving)
        print("constrained:", cons)
        print("free:", free)
        jump = (cons.spec_stats or {}).get("spec_jump_forward_tokens", 0)
        print(f"structured A/B: constrained {cons.throughput_tps:.1f} tok/s "
              f"against free {free.throughput_tps:.1f} tok/s; every "
              f"constrained final grammatical; jump-forward tokens {jump}")
        if cons.lost or cons.timeouts or not jump:
            print(f"STRUCTURED FAIL (seed={args.seed}): {cons.lost} lost, "
                  f"{cons.timeouts} hung, {jump} jump-forward tokens")
            return 1
        return 0
    if args.workload == "multitenant":
        aware = run_multitenant(
            n_requests=args.requests, rate_hz=args.rate_hz,
            n_adapters=args.tenants, zipf_s=args.zipf_s,
            adapter_aware=True, seed=args.seed, **serving)
        blind = run_multitenant(
            n_requests=args.requests, rate_hz=args.rate_hz,
            n_adapters=args.tenants, zipf_s=args.zipf_s,
            adapter_aware=False, seed=args.seed, **serving)
        print("adapter-aware:", aware)
        print("adapter-blind:", blind)
        failed = (aware.adapter_cold_starts or aware.lost
                  or aware.timeouts
                  or aware.adapter_warm_routes < aware.completed
                  or blind.adapter_cold_starts == 0)
        print(f"warm-routing A/B ({args.tenants} tenants, zipf "
              f"s={args.zipf_s}): aware {aware.adapter_cold_starts} cold "
              f"starts ({aware.adapter_warm_routes} warm routes) against "
              f"blind {blind.adapter_cold_starts}")
        if failed:
            print(f"MULTITENANT FAIL (seed={args.seed})")
            return 1
        return 0
    if args.spec_k:
        base, spec = run_spec_ab(
            spec_k=args.spec_k, n_requests=args.requests,
            rate_hz=args.rate_hz, seed=args.seed, chaos=args.chaos,
            **serving)
        print("base:", base)
        print("spec:", spec)
        print(f"fleet spec counters: {spec.spec_stats}")
        lengths = sorted(len(hist) for hist
                         in spec.spec_accept_hist.values())
        accepted = [count for hist in spec.spec_accept_hist.values()
                    for count in hist]
        mean_accept = statistics.fmean(accepted) if accepted else 0.0
        print(f"accept histograms: {len(lengths)} requests, "
              f"rounds/request p50="
              f"{lengths[len(lengths) // 2] if lengths else 0}, "
              f"mean accepted/round={mean_accept:.2f}")
        if args.chaos and (spec.lost or spec.timeouts
                           or spec.duplicate_finals):
            print(f"SPEC CHAOS FAIL (seed={args.seed}): "
                  f"{spec.lost} lost, {spec.timeouts} hung, "
                  f"{spec.duplicate_finals} duplicated")
            return 1
        mode = "chaos" if args.chaos else "shared_prefix"
        print(f"SPEC A/B OK (k={args.spec_k}, {mode}, "
              f"seed={args.seed}): bit-exact, "
              f"tokens/target-pass="
              f"{(spec.spec_stats or {}).get('spec_tokens_per_target_pass')}")
        return 0
    if args.migrate_mid_stream:
        control, migrated = run_migration_chaos(
            seed=args.seed,
            n_requests=args.requests if args.requests != 40 else 10,
            rate_hz=args.rate_hz, phase=args.migration_phase, **serving)
        print("control: ", control)
        print("migrated:", migrated)
        stats = migrated.server_stats
        print(f"router counters: {stats}")
        both = set(control.final_tokens) & set(migrated.final_tokens)
        mismatched = [request_id for request_id in both
                      if control.final_tokens[request_id]
                      != migrated.final_tokens[request_id]]
        ok = (not migrated.lost and not migrated.timeouts
              and not migrated.duplicate_finals
              and not stats.get("stream_mismatches")
              and stats.get("migrations_started", 0) > 0
              and not mismatched and both)
        if not ok:
            print(f"MIGRATION CHAOS FAIL (seed={args.seed}, "
                  f"phase={args.migration_phase}): {migrated.lost} lost, "
                  f"{migrated.timeouts} hung, {migrated.duplicate_finals} "
                  f"duplicated, {stats.get('stream_mismatches')} stream "
                  f"mismatches, {len(mismatched)} diverged vs control")
            return 1
        print(f"MIGRATION CHAOS OK (seed={args.seed}, "
              f"phase={args.migration_phase}): "
              f"{stats.get('migrations_completed')} migrated / "
              f"{stats.get('migrations_aborted')} aborted, "
              f"{len(stats.get('migration_cutover_ms', []))} cutovers, "
              "bit-exact vs control")
        return 0
    if args.rolling_upgrade:
        migrated = run_rolling_upgrade(duration_s=args.duration,
                                       seed=args.seed, **serving)
        drained = run_rolling_upgrade(duration_s=args.duration,
                                      seed=args.seed, drain_based=True,
                                      **serving)
        for label, report in (("live-migrated", migrated),
                              ("drain-based ", drained)):
            stats = report.server_stats
            print(f"{label}: goodput={report.goodput_rps:.2f} req/s, "
                  f"upgrades={stats.get('upgrades_completed')}, "
                  f"migrations={stats.get('migrations_completed')}, "
                  f"lost={report.lost}")
        stats = migrated.server_stats
        ok = (not migrated.lost and not migrated.timeouts
              and not migrated.duplicate_finals
              and not stats.get("stream_mismatches")
              and stats.get("upgrades_completed", 0) > 0
              and stats.get("converged"))
        if not ok:
            print(f"ROLLING UPGRADE FAIL (seed={args.seed}): "
                  f"{migrated.lost} lost, {migrated.timeouts} hung, "
                  f"{migrated.duplicate_finals} duplicated, "
                  f"converged={stats.get('converged')}")
            return 1
        print(f"ROLLING UPGRADE OK (seed={args.seed}): fleet replaced "
              "with zero lost/duplicated tokens")
        return 0
    if args.elastic_chaos:
        report = run_elastic_chaos(seed=args.seed, duration_s=args.duration,
                                   base_hz=args.base_hz,
                                   peak_hz=args.peak_hz,
                                   period_s=args.period, **serving)
        print(report)
        print(f"autoscaler: {report.server_stats}")
        ok = (not report.lost and not report.timeouts
              and not report.duplicate_finals
              and not report.server_stats.get("stream_mismatches")
              and report.server_stats.get("converged"))
        if not ok:
            print(f"ELASTIC CHAOS FAIL (seed={args.seed}): "
                  f"{report.lost} lost, {report.timeouts} hung, "
                  f"{report.duplicate_finals} duplicated, "
                  f"{report.server_stats.get('stream_mismatches')} stream "
                  f"mismatches, "
                  f"converged={report.server_stats.get('converged')}")
            return 1
        print(f"ELASTIC CHAOS OK (seed={args.seed}): drain + kill + "
              "failed respawn, nothing lost, fleet converged")
        return 0
    if args.workload == "diurnal":
        report = run_elastic(duration_s=args.duration, seed=args.seed,
                             base_hz=args.base_hz, peak_hz=args.peak_hz,
                             period_s=args.period,
                             slo_ttft_ms=args.slo_ttft_ms,
                             static_replicas=args.static_replicas,
                             **serving)
        print(report)
        print(f"fleet: {report.server_stats}")
        print(f"goodput {report.goodput_rps:.2f} req/s over avg "
              f"{report.avg_replicas:.2f} replicas = "
              f"{report.goodput_per_replica:.2f} req/s/replica")
        return 1 if (report.lost or report.timeouts) else 0
    if args.restart_replica:
        cold, warm = run_restart_ab(
            n_requests=args.requests if args.requests != 40 else 18,
            seed=args.seed, **serving)
        for label, report in (("cold", cold), ("warm", warm)):
            stats = report.server_stats or {}
            mean_ttft = (statistics.fmean(report.ttfts_ms)
                         if report.ttfts_ms else 0.0)
            print(f"{label}: hit_rate={report.prefix_hit_rate}, "
                  f"mean TTFT={mean_ttft:.1f}ms, "
                  f"recovery={stats.get('restart_recovery_ms')}ms, "
                  f"batch hit rates={stats.get('restart_hit_rates')}, "
                  f"adopted={stats.get('kv_adopted_chains')}, "
                  f"disk restores={stats.get('kv_disk_restores')}")
        ok = (not cold.lost and not warm.lost
              and not cold.timeouts and not warm.timeouts
              and (warm.prefix_hit_rate or 0.0)
              > (cold.prefix_hit_rate or 0.0))
        if not ok:
            print(f"RESTART A/B FAIL (seed={args.seed}): warm must beat "
                  "cold on hit rate with zero lost")
            return 1
        print(f"RESTART A/B OK (seed={args.seed}): bit-exact, warm restart "
              "adopted the spill tier")
        return 0
    if args.workload == "longtail":
        import tempfile

        host_blocks = 0 if args.tier_off else args.host_blocks
        with contextlib.ExitStack() as stack:
            spill_dir = None
            if args.disk_blocks:
                spill_dir = os.path.join(stack.enter_context(
                    tempfile.TemporaryDirectory(prefix="kvspill-")),
                    "spill")
            report = run_longtail(
                n_requests=args.requests, rate_hz=args.rate_hz,
                n_prefixes=args.prefixes, prefix_len=args.prefix_len,
                total_blocks=args.hbm_blocks,
                host_tier_blocks=host_blocks, seed=args.seed,
                spill_dir=spill_dir,
                spill_blocks=args.disk_blocks or 1024, **serving)
        print(report)
        print(report.phase_table())
        print(f"fleet counters: {report.server_stats}")
        mean_ttft = (statistics.fmean(report.ttfts_ms)
                     if report.ttfts_ms else 0.0)
        print(f"longtail ({args.prefixes} prefixes x {args.prefix_len} "
              f"tok over {args.hbm_blocks} device blocks, host tier "
              f"{host_blocks} blocks, disk tier {args.disk_blocks} "
              f"blocks): prefix_hit_rate={report.prefix_hit_rate}, "
              f"host share={report.prefix_hit_rate_host}, "
              f"mean TTFT={mean_ttft:.1f}ms")
        return 1 if (report.lost or report.timeouts) else 0
    if args.workload == "shared_prefix":
        report = run_shared_prefix(
            n_requests=args.requests, rate_hz=args.rate_hz,
            prefix_routing=not args.no_prefix_routing,
            payload_fn=shared_prefix_payloads(
                n_conversations=args.conversations, turns=args.turns,
                system_len=args.system_len, seed=args.seed), **serving)
        print(report)
        print(report.phase_table())
        if report.fleet_latency_ms:
            print(f"fleet latency (merged histograms): "
                  f"{report.fleet_latency_ms}")
        print(f"fleet counters: {report.server_stats}")
        return 1 if (report.lost or report.timeouts) else 0
    if not args.chaos:
        parser.error("API runs use LoadGenerator directly; the CLI wires "
                     "--chaos, --elastic-chaos, --migrate-mid-stream, "
                     "--rolling-upgrade, --restart-replica and --workload")
    report = run_chaos(seed=args.seed, n_requests=args.requests,
                       rate_hz=args.rate_hz, **serving)
    print(report)
    print(report.phase_table())
    print(f"router counters: {report.server_stats}")
    if report.lost or report.timeouts:
        print(f"CHAOS FAIL (seed={args.seed}): {report.lost} lost, "
              f"{report.timeouts} hung")
        return 1
    print(f"CHAOS OK (seed={args.seed}): {report.sent}/{report.sent} "
          "requests terminal under kill + drop + stall schedule")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
