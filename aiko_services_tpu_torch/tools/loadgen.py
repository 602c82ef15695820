"""Serving load generator and the fleet rigs: drive replicas over the
wire, report tails.

The port's copy of the parts of ``aiko_services_tpu/tools/loadgen.py``
that drive a fleet of the port's servers: :class:`LoadGenerator` and
:class:`LoadReport`, the shared-prefix and elastic payloads, the fleet
aggregation helpers, the fault schedules, and three in-process rigs —
:func:`run_shared_prefix` (prefix-aware routing), :func:`run_chaos`
(zero lost requests under a replica kill) and :func:`run_migration_chaos`
(drain-free live migration, bit-exact against a control run).  Each rig
stands up a Registrar, two :class:`~..orchestration.continuous
.ContinuousReplica` s and a :class:`~..orchestration.serving
.ReplicaRouter` on one loopback broker and one engine thread, and builds
its servers through ``make_server(name)`` or, without one, as
``PagedContinuousServer(config_name, params=params, device=device, …)``
— the card unless the caller passes ``device="cpu"``.

    generator = LoadGenerator(process, target_topic="ns/h/1/0/in",
                              payload_fn=make_payload, rate_hz=50)
    report = generator.run(n_requests=500)
    report.p50_ms, report.p99_ms, report.throughput_rps, report.errors

Open-loop: requests are posted on schedule regardless of completions
(late responses still count; missing ones surface as ``timeouts``).

Not ported yet, each with the module it needs: the elastic, restart,
long-tail, multi-tenant, speculative and structured rigs and the CLI.
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
           "fleet", "fleet_latency", "migration_chaos_schedule",
           "run_chaos", "run_migration_chaos", "run_shared_prefix",
           "shared_prefix_payloads"]

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
                    **defaults) -> Callable[[str], object]:
    """``make_server`` itself, or a factory of ``PagedContinuousServer``
    s on ``params`` (random weights from the seed when None) and
    ``device`` with the rig's ``defaults``."""
    if make_server is not None:
        return make_server

    def build(_name: str):
        from ..orchestration.paged import PagedContinuousServer
        return PagedContinuousServer(config_name=config_name,
                                     params=params, device=device,
                                     **defaults)
    return build


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
                      device=None) -> LoadReport:
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
    (``client_ttfts_ms``)."""
    make_server = _server_factory(
        make_server, config_name, params, device, slots=2, chunk_steps=4,
        seed=0, enable_prefix_cache=True, max_queue=256, watchdog_s=5.0)
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
              device=None) -> LoadReport:
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
    ``steady_tokens_per_sec``)."""
    from ..runtime import faults

    make_server = _server_factory(
        make_server, config_name, params, device, slots=2, chunk_steps=4,
        seed=0, enable_prefix_cache=True, max_queue=256, watchdog_s=5.0)
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
