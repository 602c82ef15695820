"""Flight recorder: anomaly-triggered capture bundles + p95 drift.

The port's copy of ``aiko_services_tpu/obs/flight.py`` (it has no JAX in
it); its imports point at the port's own modules.  The port's bundle has
the manifest, spans, steplog and counters sections.  It leaves out the
reference's ``compiles``, ``profile`` and ``census`` sections: they read
the compile ledger, the device profiler and the pool auditor
(``compiles.LEDGER``, ``profiler.LAST``, ``pool_audit.AUDITOR``), which the
port has not ported yet (``ROADMAP.md``, queue 1 item 8).

The span trees, step log and mergeable histograms make the fleet
*observable*.  This module makes it *self-recording*: a
per-process :class:`FlightRecorder` holds a bounded window of recent
spans, step-log rows and counter values, and on a trigger dumps one
self-contained **capture bundle** — a single JSON file that
``tools/doctor.py`` renders as a full report:

- ``manifest``  — trigger, reason, trace id, service, pid, wall time,
  the ``AIKO_*`` environment, format version;
- ``spans``     — recent finished spans (from an installed tracer
  and/or spans noted explicitly via :meth:`FlightRecorder.note_spans`)
  plus their Chrome trace events;
- ``steplog``   — the engine step-log ring slice, counts and drop
  count;
- ``counters``  — the metrics registry snapshot, the baseline snapshot
  taken at install time (so the doctor diffs them), and any attached
  provider dicts (e.g. a server's ``stats()``);
- (the reference's ``compiles``, ``profile`` and ``census`` sections
  are left out; see above).

Every section is stamped with the SAME trace id, so bundles from
different processes join into one fleet-wide forensic record: the
router fans an operator/anomaly ``(capture …)`` out to every replica
with a shared trace id, and each process dumps *around* it.

Triggers wired elsewhere in the stack (all guarded, invariant 7/14):
watchdog trip (`continuous._trip_watchdog`), SLO-breach streak
(`autoscaler._tick`), fault-injection fire (`faults.FaultPlan.check`),
process exit (``capture_on_exit``), operator ``(capture …)`` and
``(census …)`` commands (`Actor` built-ins), pool-audit violations
(`pool_audit.PoolAuditor.sweep`), and the router's p95-drift anomaly
detector (:class:`P95DriftDetector` below).

**Zero-cost discipline**: module-level :data:`FLIGHT` is ``None`` by
default; every call site guards with ``flight.FLIGHT is not None``
(the ``faults.PLAN`` / ``trace.TRACER`` idiom).  Captures are
rate-limited per trigger and bundle files are bounded, so even a
storming trigger cannot turn the recorder into an IO hazard.

Env bootstrap (like ``AIKO_TRACE``): ``AIKO_FLIGHT=<dir>`` installs a
recorder at import; ``AIKO_FLIGHT_EXIT=1`` adds the exit trigger.
"""

from __future__ import annotations

import atexit
import json
import os
import random
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from . import metrics, steplog, trace

__all__ = ["FlightRecorder", "P95DriftDetector", "FLIGHT", "install",
           "uninstall", "new_trace_id", "FORMAT_VERSION"]

#: Bundle schema version — bumped on incompatible layout changes so
#: ``tools/doctor.py`` can refuse bundles it cannot read.
FORMAT_VERSION = 1

#: Spans kept in the note ring / written per bundle.
_SPAN_LIMIT = 512
#: Step-log rows written per bundle (newest-first slice of the ring).
_STEPLOG_LIMIT = 2048


def new_trace_id() -> str:
    """Fresh 96-bit trace id — the router mints one per fleet-wide
    capture fan-out so every process's bundle joins on it."""
    return f"{random.getrandbits(96):024x}"


class FlightRecorder:
    """Bounded in-memory flight window + capture-bundle writer.

    ``out_dir``        where bundle files land (created on demand);
    ``service``        name stamped into the manifest (defaults to
                       ``pid<pid>`` like the tracer);
    ``max_bundles``    oldest bundle files beyond this are deleted;
    ``min_interval_s`` per-trigger rate limit (operator and census
                       captures are exempt — a human asked);
    ``capture_on_exit`` register an ``atexit`` "exit" capture.
    """

    def __init__(self, out_dir: str, service: str = "",
                 max_bundles: int = 16, min_interval_s: float = 5.0,
                 capture_on_exit: bool = False):
        self.out_dir = str(out_dir)
        self.service = service or f"pid{os.getpid()}"
        self.max_bundles = int(max_bundles)
        self.min_interval_s = float(min_interval_s)
        self._noted: deque = deque(maxlen=_SPAN_LIMIT)
        self._providers: Dict[str, Callable[[], Dict]] = {}
        self._recent: deque = deque(maxlen=32)
        self._last_capture: Dict[str, float] = {}
        self._bundles: deque = deque()
        self._seq = 0
        self._lock = threading.Lock()
        self._baseline = metrics.REGISTRY.snapshot()
        if capture_on_exit:
            atexit.register(self._atexit_capture)

    # -- feeding the window ------------------------------------------- #

    def note_spans(self, spans) -> None:
        """Remember finished spans in processes that run NO tracer
        (replicas synthesize spans at respond time — this is the hook
        that keeps a copy for forensics).  Accepts ``Span`` objects or
        their ``to_dict()`` form."""
        with self._lock:
            for span in spans:
                self._noted.append(
                    span.to_dict() if isinstance(span, trace.Span)
                    else dict(span))

    def attach(self, name: str, provider: Callable[[], Dict]) -> None:
        """Register a zero-arg callable whose dict lands in the
        bundle's ``counters.providers.<name>`` section (e.g. a
        server's ``stats()``)."""
        self._providers[str(name)] = provider

    # -- capture ------------------------------------------------------- #

    def capture(self, trigger: str, trace_id: Optional[str] = None,
                reason: str = "") -> Optional[str]:
        """Dump one bundle; returns its path, or ``None`` when the
        per-trigger rate limit suppressed it.  Never raises — a
        forensic tool must not add failure modes to the path it is
        recording."""
        trigger = str(trigger)
        now_mono = time.monotonic()
        with self._lock:
            last = self._last_capture.get(trigger)
            if (trigger not in ("operator", "census")
                    and last is not None
                    and now_mono - last < self.min_interval_s):
                return None
            self._last_capture[trigger] = now_mono
            self._seq += 1
            seq = self._seq
        try:
            return self._write_bundle(trigger, trace_id, reason, seq)
        except Exception:  # noqa: BLE001 - never fail the caller
            return None

    def _write_bundle(self, trigger: str, trace_id: Optional[str],
                      reason: str, seq: int) -> str:
        span_dicts = self._collect_spans()
        if not trace_id:
            trace_id = (span_dicts[-1]["tid"] if span_dicts
                        else new_trace_id())
        matched = [s for s in span_dicts if s.get("tid") == trace_id]
        spans_out = matched if matched else span_dicts
        span_objs = [trace.Span.from_dict(s) for s in spans_out]

        events: List = []
        counts: Dict = {}
        dropped = 0
        if steplog.RECORDER is not None:
            events = [[t, name, fields] for t, name, fields
                      in steplog.RECORDER.events()[-_STEPLOG_LIMIT:]]
            counts = steplog.RECORDER.counts()
            dropped = steplog.RECORDER.dropped

        providers: Dict[str, Dict] = {}
        for name, provider in self._providers.items():
            try:
                providers[name] = dict(provider())
            except Exception:  # noqa: BLE001 - provider bugs stay local
                providers[name] = {"error": "provider raised"}

        wall = time.time()
        bundle = {
            "manifest": {
                "format": FORMAT_VERSION,
                "trigger": trigger,
                "reason": reason,
                "trace_id": trace_id,
                "service": self.service,
                "pid": os.getpid(),
                "captured_unix": round(wall, 6),
                "captured": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime(wall)),
                "env": {key: value for key, value in os.environ.items()
                        if key.startswith("AIKO_")},
            },
            "spans": {
                "trace_id": trace_id,
                "matched": bool(matched),
                "spans": spans_out,
                "chrome": trace.chrome_events(span_objs),
            },
            "steplog": {
                "trace_id": trace_id,
                "events": events,
                "counts": counts,
                "dropped": dropped,
            },
            "counters": {
                "trace_id": trace_id,
                "metrics": metrics.REGISTRY.snapshot(),
                "baseline": self._baseline,
                "providers": providers,
            },
        }

        os.makedirs(self.out_dir, exist_ok=True)
        name = f"capture_{trigger}_{seq:04d}_{os.getpid()}.json"
        path = os.path.join(self.out_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as handle:
            json.dump(bundle, handle, separators=(",", ":"))
        os.replace(tmp, path)

        metrics.REGISTRY.counter(
            "aiko_flight_captures_total",
            help="Capture bundles written by the flight recorder.",
            labels={"trigger": trigger}).inc()
        with self._lock:
            self._recent.append({"ts": round(wall, 3),
                                 "trigger": trigger,
                                 "trace_id": trace_id, "path": path})
            self._bundles.append(path)
            while len(self._bundles) > self.max_bundles:
                stale = self._bundles.popleft()
                try:
                    os.remove(stale)
                except OSError:
                    pass
        return path

    def _collect_spans(self) -> List[Dict]:
        with self._lock:
            span_dicts = list(self._noted)
        if trace.TRACER is not None:
            span_dicts.extend(span.to_dict()
                              for span in trace.TRACER.finished())
        return span_dicts[-_SPAN_LIMIT:]

    def _atexit_capture(self) -> None:
        if FLIGHT is self:
            self.capture("exit", reason="process exit")

    # -- introspection -------------------------------------------------- #

    def recent(self) -> List[Dict]:
        """Newest-last ring of ``{ts, trigger, trace_id, path}`` —
        feeds the dashboard's recent-triggers pane and the replica
        telemetry share."""
        with self._lock:
            return list(self._recent)

    @property
    def captures(self) -> int:
        return self._seq


class P95DriftDetector:
    """Flags p95 drift from per-window DELTA histograms — pure logic,
    no IO, router-owned.

    The fleet histograms use fixed log-spaced buckets, so the delta of
    two snapshots is EXACT: element-wise count subtraction, no
    re-sampling error.  Each ``observe(phase, hist)`` diffs against
    the previous snapshot, computes the window's p95 and compares it
    against a slow EMA baseline; a window whose p95 exceeds
    ``ratio × baseline`` (with at least ``min_count`` samples and a
    baseline above ``floor_ms``) returns a flag dict — the early-
    warning hook that fires BEFORE the autoscaler's SLO hard-trip.
    """

    def __init__(self, ratio: float = 1.5, min_count: int = 20,
                 alpha: float = 0.3, floor_ms: float = 0.1):
        self.ratio = float(ratio)
        self.min_count = int(min_count)
        self.alpha = float(alpha)
        self.floor_ms = float(floor_ms)
        self._last: Dict[str, tuple] = {}
        self._ema: Dict[str, float] = {}

    def observe(self, phase: str, hist) -> Optional[Dict]:
        """``hist`` is a cumulative :class:`obs.metrics.Histogram`
        (e.g. the router's fleet merge).  Returns a flag dict on
        drift, else ``None``."""
        snapshot = (tuple(hist.counts), hist.sum)
        previous = self._last.get(phase)
        self._last[phase] = snapshot
        if previous is None:
            return None
        delta_counts = [current - before for current, before
                        in zip(snapshot[0], previous[0])]
        if any(count < 0 for count in delta_counts):
            # Snapshot went backwards (replica churn reset the merge);
            # re-baseline on the next window.
            return None
        window_count = sum(delta_counts)
        if window_count < self.min_count:
            return None
        window = metrics.Histogram(hist.name, bounds=hist.bounds)
        window.counts = delta_counts
        window.count = window_count
        window.sum = max(0.0, snapshot[1] - previous[1])
        p95 = window.quantile(0.95)
        baseline = self._ema.get(phase)
        self._ema[phase] = (p95 if baseline is None
                            else baseline + self.alpha
                            * (p95 - baseline))
        if baseline is None or baseline < self.floor_ms:
            return None
        if p95 > self.ratio * baseline:
            return {"phase": phase, "p95_ms": round(p95, 3),
                    "baseline_ms": round(baseline, 3),
                    "ratio": round(p95 / baseline, 3),
                    "window_count": window_count}
        return None


#: The module-level switchboard.  ``None`` → flight recording is OFF
#: and every guarded site costs one attribute load + identity test.
FLIGHT: Optional[FlightRecorder] = None


def install(recorder: Optional[FlightRecorder] = None,
            **kwargs) -> FlightRecorder:
    global FLIGHT
    FLIGHT = recorder or FlightRecorder(**kwargs)
    return FLIGHT


def uninstall():
    global FLIGHT
    FLIGHT = None


_env_dir = os.environ.get("AIKO_FLIGHT")
if _env_dir:
    install(out_dir=_env_dir,
            service=os.environ.get("AIKO_TRACE", ""),
            capture_on_exit=os.environ.get("AIKO_FLIGHT_EXIT") == "1")
