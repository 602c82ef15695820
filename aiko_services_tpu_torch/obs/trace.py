"""Distributed request tracing: spans, propagation, Chrome export.

The port's copy of ``aiko_services_tpu/obs/trace.py``: the same spans and
wire form; its device annotation is an NVTX range in place of a JAX
profiler annotation.

One request → one span tree across processes::

    InferClient "infer" (root)
      └─ ReplicaRouter "route" / "redispatch" / "shed"
           └─ replica "queue" → "prefill" → "decode"
                └─ kv transfer source "kv_export"

**Context propagation** rides the EXISTING message layer: the compact
string ``"<trace_id>/<span_id>"`` travels as an optional ``trace``
field inside the S-expression infer swag (and as an extra parameter on
kv fetch requests), through MQTT and loopback alike — no transport
changes.  Finished spans ride BACK on the response as a
``trace_spans`` JSON field, so the client ends the request holding the
entire tree and can export it (``loadgen --trace-out``).

**Clock**: spans use an epoch-aligned monotonic clock —
``time.time()`` anchored once, advanced by ``time.perf_counter()`` —
monotonic within a process, comparable across processes to wall-clock
sync accuracy.  Good enough to LOOK AT a cross-process tree; per-span
durations are exact.

**Export** is Chrome trace-event JSON (``chrome://tracing`` /
https://ui.perfetto.dev): complete ``"X"`` events per span, ``"i"``
instants for marks (first/last token), ``"M"`` process-name metadata
per service, and ``"s"``/``"f"`` flow arrows stitching parent→child
across processes.

**Zero-cost discipline**: the module-level :data:`TRACER` is ``None``
by default; every call site guards with ``trace.TRACER is not None``
(the ``faults.PLAN`` idiom — one attribute load + identity test when
disabled).  At span start the active tracer can push an NVTX range
named ``span:<name>#<span_id>`` (``torch.cuda.nvtx``, when a card is
present) so a device trace links back to host spans by name; torch is
imported lazily and only when annotation is requested.

Env bootstrap (like ``AIKO_FAULTS``): ``AIKO_TRACE=<service-name>``
installs a tracer at import so child processes opt in without code.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Span", "SpanContext", "Tracer", "TRACER", "install",
           "uninstall", "current_ids", "inject", "extract",
           "encode_spans", "decode_spans", "chrome_events",
           "export_chrome", "now", "synth_span", "annotate"]


class SpanContext:
    """What propagates: the (trace_id, span_id) pair."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext({self.trace_id}/{self.span_id})"


class Span:
    """One timed operation.  ``start``/``end`` are epoch-aligned
    seconds (see module docstring); ``marks`` are named instants."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "service",
                 "start", "end", "attrs", "marks")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str, service: str,
                 start: float, attrs: Optional[Dict] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.service = service
        self.start = start
        self.end: Optional[float] = None
        self.attrs: Dict = dict(attrs or {})
        self.marks: List[Tuple[str, float]] = []

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration_ms(self) -> float:
        return ((self.end or self.start) - self.start) * 1e3

    def set_attr(self, key: str, value):
        self.attrs[key] = value

    def mark(self, name: str, at: Optional[float] = None):
        self.marks.append((name, at if at is not None else _now()))

    def to_dict(self) -> Dict:
        out = {"tid": self.trace_id, "sid": self.span_id,
               "name": self.name, "svc": self.service,
               "t0": round(self.start, 6),
               "t1": round(self.end if self.end is not None
                           else self.start, 6)}
        if self.parent_id:
            out["pid"] = self.parent_id
        if self.attrs:
            out["attrs"] = self.attrs
        if self.marks:
            out["marks"] = [[name, round(at, 6)]
                            for name, at in self.marks]
        return out

    @classmethod
    def from_dict(cls, data: Dict) -> "Span":
        span = cls(data["tid"], data["sid"], data.get("pid"),
                   data["name"], data.get("svc", "?"), data["t0"],
                   attrs=data.get("attrs"))
        span.end = data.get("t1", data["t0"])
        span.marks = [(name, at) for name, at in data.get("marks", [])]
        return span

    def __repr__(self):
        return (f"Span({self.name}@{self.service} "
                f"{self.trace_id}/{self.span_id} "
                f"{self.duration_ms:.3f}ms)")


# Epoch-aligned monotonic clock, anchored once per process.
_EPOCH0 = time.time() - time.perf_counter()


def _now() -> float:
    return _EPOCH0 + time.perf_counter()


def now() -> float:
    """The span clock (epoch-aligned monotonic seconds) — for call
    sites that time work themselves and synthesize spans after."""
    return _now()


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "aiko_active_span", default=None)


class Tracer:
    """Span factory + finished-span ring buffer for one process/service.

    ``capacity`` bounds memory exactly like the steplog ring: old
    finished spans fall off; a request's spans are ALSO returned to the
    caller that finished them (ride-back), so the ring is a local
    debugging window, not the primary export path.
    """

    def __init__(self, service: str = "", capacity: int = 8192,
                 annotate: bool = False, seed: Optional[int] = None):
        self.service = service or f"pid{os.getpid()}"
        self.annotate = annotate
        self._rng = random.Random(seed)
        self._finished: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    # -- ids ----------------------------------------------------------------- #

    def _id(self, bits: int = 64) -> str:
        return f"{self._rng.getrandbits(bits):0{bits // 4}x}"

    # -- span lifecycle ------------------------------------------------------ #

    def start_span(self, name: str, parent=None,
                   attrs: Optional[Dict] = None,
                   start: Optional[float] = None) -> Span:
        """``parent``: a Span, SpanContext, propagation string, or
        None (new root — fresh trace_id)."""
        if isinstance(parent, str):
            parent = extract(parent)
        if parent is None:
            parent = _ACTIVE.get()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = self._id(96), None
        span = Span(trace_id, self._id(), parent_id, name,
                    self.service,
                    start if start is not None else _now(),
                    attrs=attrs)
        return span

    def finish(self, span: Span, end: Optional[float] = None) -> Span:
        if span.end is None:
            span.end = end if end is not None else _now()
        with self._lock:
            self._finished.append(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, parent=None, attrs: Optional[Dict] = None):
        """Start + activate + finish.  When ``annotate`` is on and a card
        is present, the body also runs inside an NVTX range named
        ``span:<name>#<span_id>`` so device traces cross-reference host
        spans."""
        span = self.start_span(name, parent=parent, attrs=attrs)
        token = _ACTIVE.set(span.context)
        nvtx = None
        if self.annotate:
            try:
                import torch
                if torch.cuda.is_available():
                    nvtx = torch.cuda.nvtx
                    nvtx.range_push(f"span:{name}#{span.span_id}")
            except Exception:  # noqa: BLE001 - build may lack NVTX
                nvtx = None
        try:
            yield span
        finally:
            if nvtx is not None:
                with contextlib.suppress(Exception):
                    nvtx.range_pop()
            _ACTIVE.reset(token)
            self.finish(span)

    # -- ring access --------------------------------------------------------- #

    def finished(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def drain(self) -> List[Span]:
        with self._lock:
            spans = list(self._finished)
            self._finished.clear()
        return spans


#: The module-level switchboard.  ``None`` → tracing is OFF and every
#: guarded site costs one attribute load + identity test.
TRACER: Optional[Tracer] = None


def install(tracer: Optional[Tracer] = None, **kwargs) -> Tracer:
    global TRACER
    TRACER = tracer or Tracer(**kwargs)
    return TRACER


def uninstall():
    global TRACER
    TRACER = None


@contextlib.contextmanager
def annotate(name: str, cuda: bool = False):
    """A ``torch.profiler`` range named ``name`` around the body and, with
    ``cuda``, an NVTX range of the same name: the port's counterpart of
    ``jax.profiler.TraceAnnotation`` (the pipeline's fused stages name
    theirs ``stage:<name>``).  Needs no tracer; with no profiler running
    the range costs a few microseconds of host."""
    import torch
    with torch.profiler.record_function(name):
        if not cuda:
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def current_ids() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the active span, tracer or not — the
    log-handler hook; costs one ContextVar read."""
    context = _ACTIVE.get()
    if context is None:
        return None
    return (context.trace_id, context.span_id)


# -- propagation ------------------------------------------------------------- #

def inject(span_or_context) -> str:
    """Compact wire form of a span context: ``trace_id/span_id``."""
    if isinstance(span_or_context, Span):
        span_or_context = span_or_context.context
    return f"{span_or_context.trace_id}/{span_or_context.span_id}"


def extract(carrier) -> Optional[SpanContext]:
    """Parse the wire form back; tolerant of junk (returns None)."""
    if isinstance(carrier, SpanContext):
        return carrier
    if not isinstance(carrier, str) or "/" not in carrier:
        return None
    trace_id, _, span_id = carrier.partition("/")
    if not trace_id or not span_id:
        return None
    return SpanContext(trace_id, span_id)


def synth_span(name: str, parent, service: str, start: float,
               end: float, attrs: Optional[Dict] = None) -> Span:
    """Build an already-FINISHED span without any tracer installed.

    Replicas reconstruct their phase spans (queue/prefill/decode, kv
    export) from request timestamps at response time: the decision to
    trace was the CLIENT's and arrived on the wire as a context — the
    serving process participates in the tree without opting into a
    process-local :class:`Tracer` (and pays nothing when no context
    rides the request)."""
    context = parent if isinstance(parent, SpanContext) \
        else extract(parent)
    if context is None:
        trace_id, parent_id = f"{random.getrandbits(96):024x}", None
    else:
        trace_id, parent_id = context.trace_id, context.span_id
    span = Span(trace_id, f"{random.getrandbits(64):016x}", parent_id,
                name, service, start, attrs=attrs)
    span.end = end
    return span


def encode_spans(spans: Iterable[Span]) -> str:
    """JSON-compact span list for the response ``trace_spans`` field."""
    return json.dumps([span.to_dict() if isinstance(span, Span)
                       else span for span in spans],
                      separators=(",", ":"))


def decode_spans(text: str) -> List[Span]:
    try:
        data = json.loads(text)
    except (TypeError, ValueError):
        return []
    spans = []
    for item in data:
        try:
            spans.append(Span.from_dict(item))
        except (KeyError, TypeError):
            continue
    return spans


# -- Chrome trace-event export ----------------------------------------------- #

def chrome_events(spans: Iterable[Span]) -> List[Dict]:
    """Complete events + instants + process metadata + flow arrows.

    Each distinct service gets its own synthetic pid (sorted order →
    stable output, golden-file testable); parent→child links across
    pids are drawn as flow events so Perfetto renders ONE connected
    tree for a cross-process request.
    """
    spans = [span for span in spans if span is not None]
    services = sorted({span.service for span in spans})
    pid_of = {service: index + 1
              for index, service in enumerate(services)}
    events: List[Dict] = []
    for service in services:
        events.append({"ph": "M", "name": "process_name",
                       "pid": pid_of[service], "tid": 0,
                       "args": {"name": service}})
    by_id = {span.span_id: span for span in spans}
    for span in sorted(spans, key=lambda s: (s.start, s.span_id)):
        pid = pid_of[span.service]
        ts = int(round(span.start * 1e6))
        duration = max(1, int(round(
            ((span.end if span.end is not None else span.start)
             - span.start) * 1e6)))
        args = dict(span.attrs)
        args["trace_id"] = span.trace_id
        args["span_id"] = span.span_id
        if span.parent_id:
            args["parent_id"] = span.parent_id
        events.append({"ph": "X", "name": span.name, "cat": "span",
                       "pid": pid, "tid": 1, "ts": ts,
                       "dur": duration, "args": args})
        for mark_name, at in span.marks:
            events.append({"ph": "i", "name": mark_name, "cat": "mark",
                           "pid": pid, "tid": 1,
                           "ts": int(round(at * 1e6)), "s": "t"})
        parent = by_id.get(span.parent_id) if span.parent_id else None
        if parent is not None and parent.service != span.service:
            flow = {"cat": "trace", "name": "link",
                    "id": int(span.span_id[:8], 16)}
            events.append(dict(flow, ph="s",
                               pid=pid_of[parent.service], tid=1,
                               ts=int(round(parent.start * 1e6))))
            events.append(dict(flow, ph="f", bp="e", pid=pid, tid=1,
                               ts=ts))
    return events


def export_chrome(path: str, spans: Iterable[Span]) -> str:
    """Write ``{"traceEvents": […]}`` (Perfetto/chrome://tracing)."""
    document = {"traceEvents": chrome_events(spans),
                "displayTimeUnit": "ms"}
    with open(path, "w", encoding="utf-8") as handle:
        json.dump(document, handle, indent=1)
    return path


# -- env bootstrap (AIKO_FAULTS discipline) ----------------------------------- #

_SPEC = os.environ.get("AIKO_TRACE", "")
if _SPEC:
    install(service=("" if _SPEC in ("1", "on", "true") else _SPEC))
