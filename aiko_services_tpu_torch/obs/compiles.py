"""The port's compile ledger: CUDA graph captures, observed and attributed,
and the kernel library's build cache.

``aiko_services_tpu/obs/compiles.py`` records every XLA compile and, once
its warm-up fence drops, flags every later one as a steady-state anomaly:
a serving loop whose shapes are bucketed compiles nothing new once warm.
On the card the port's counterpart of a compile is a graph capture
(``models/llama.py`` ``ChunkGraph``), and of a compiled call a replay.

* :class:`CaptureLedger` is one engine's count of captures and replays,
  with its own fence (``stats()``: ``graph_captures``,
  ``graph_replays``, ``graph_captures_steady_state``).  It forwards every
  capture to the process-wide ledger when one is installed.
* :class:`CompileLedger` (the ``LEDGER`` switchboard) is the rest of the
  JAX ledger: per-thread program labels set at the engines' dispatch
  sites, a bounded ring of records (program, signature, wall ms, steady),
  distinct :meth:`~CompileLedger.signatures`, a :meth:`~CompileLedger.
  snapshot` for flight bundles and the doctor, REGISTRY counters, and the
  steady-state detector: once :meth:`~CompileLedger.fence` drops, any
  capture bumps ``aiko_compiles_steady_state_total`` and fires a flight
  capture (trigger ``"compile"``).
* The persistent-cache counters describe the kernel library
  (``ops/_cuda.py``): a digest-named library found already built under
  ``BUILD_DIR`` counts as a hit (its saved ms: the build time recorded
  beside it, less the lookup), a build counts as a miss with its ms.
  Pointing the build at another directory (the JAX package's
  ``enable_persistent_cache``) is not ported: the engines'
  ``compilation_cache_dir`` raises naming it.

Switchboard discipline: ``LEDGER = None`` by default and every call site
outside this module guards with ``compiles.LEDGER is not None``.  The
ledger only counts: nothing here runs on the card or triggers a capture.
Stdlib-only at import time.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from .metrics import REGISTRY

__all__ = ["CaptureLedger", "CompileLedger", "LEDGER", "install",
           "uninstall", "record_kernel_build", "set_label", "clear_label",
           "current_label", "label"]

#: Process-wide switchboard.  ``None`` (the default) means compile
#: observability is OFF and every guarded call site is a pointer test.
LEDGER: Optional["CompileLedger"] = None

_TLS = threading.local()


# --------------------------------------------------------------------------- #
# Per-thread program labels: a capture records what the engine named before
# it dispatched the work.

def set_label(program: str, signature: str = ""):
    """Name subsequent captures on THIS thread (engine dispatch sites)."""
    _TLS.label = (str(program), str(signature))


def clear_label():
    _TLS.label = None


def current_label() -> Tuple[str, str]:
    got = getattr(_TLS, "label", None)
    return got if got else ("unlabeled", "")


@contextlib.contextmanager
def label(program: str, signature: str = ""):
    """Scoped :func:`set_label` (tests and one-shot call sites)."""
    previous = getattr(_TLS, "label", None)
    set_label(program, signature)
    try:
        yield
    finally:
        _TLS.label = previous


class CaptureLedger:
    """Captures and replays of one engine's CUDA graphs, and the captures
    made after the warm-up fence dropped."""

    def __init__(self):
        self.captures = 0
        self.steady_captures = 0
        self.replays = 0
        self.fenced = False

    def fence(self) -> None:
        """Drop the warm-up fence: every later capture is a steady-state
        anomaly.  Idempotent."""
        self.fenced = True

    def lift_fence(self) -> None:
        """Re-enter warm-up (e.g. before an intentional reconfigure)."""
        self.fenced = False

    def record_capture(self, wall_ms: float = 0.0,
                       signature: str = "") -> None:
        """Book one capture (its host ms and the graph's key), here and,
        when installed, in the process-wide :data:`LEDGER`."""
        self.captures += 1
        if self.fenced:
            self.steady_captures += 1
        if LEDGER is not None:
            LEDGER.record_compile(wall_ms, signature=signature)

    def record_replay(self) -> None:
        self.replays += 1

    def counters(self) -> Dict[str, int]:
        """The ``stats()`` keys of the engine that owns the ledger."""
        return dict(graph_captures=self.captures,
                    graph_replays=self.replays,
                    graph_captures_steady_state=self.steady_captures)


class CompileLedger:
    """Record of every graph capture and kernel-library build seen by this
    process.  Thread-safe; ``max_records`` bounds the detail ring
    (counters are unbounded and monotonic)."""

    def __init__(self, service: str = "", max_records: int = 256,
                 registry=None):
        self.service = service or f"pid{os.getpid()}"
        self.registry = registry or REGISTRY
        self._lock = threading.Lock()
        self.compiles = 0                 # captures
        self.steady_compiles = 0          # captures AFTER the fence
        self.cache_hits = 0               # kernel library found built
        self.cache_misses = 0             # kernel library built
        self.cache_saved_ms = 0.0         # build ms a hit did not pay
        self.total_ms = 0.0
        self.build_ms = 0.0
        self.fenced = False
        self.records: deque = deque(maxlen=max(1, int(max_records)))
        self._counter_compiles = self.registry.counter(
            "aiko_compiles_total", "CUDA graph captures observed by the "
            "ledger")
        self._counter_steady = self.registry.counter(
            "aiko_compiles_steady_state_total",
            "captures after the warmup fence (bucket-discipline breaches)")
        self._counter_hits = self.registry.counter(
            "aiko_compile_cache_hits_total",
            "kernel library found built under its digest")
        self._counter_misses = self.registry.counter(
            "aiko_compile_cache_misses_total",
            "kernel library builds")
        self._gauge_saved = self.registry.gauge(
            "aiko_compile_cache_saved_ms",
            "cumulative build ms the kernel library cache saved")
        self._hist_wall = self.registry.histogram(
            "aiko_compile_wall_ms", "per-capture host wall time (ms)")

    # -- warmup fence -------------------------------------------------------- #

    def fence(self):
        """Drop the warmup fence: from now on every capture is a
        steady-state anomaly (bumps the counter and fires a flight
        capture).  Idempotent."""
        with self._lock:
            self.fenced = True

    def lift_fence(self):
        """Re-enter warmup (e.g. before an intentional reconfigure)."""
        with self._lock:
            self.fenced = False

    # -- event sinks --------------------------------------------------------- #

    def record_build(self, library: str, hit: bool, wall_ms: float,
                     saved_ms: float = 0.0):
        """Book one kernel-library lookup: a hit (found built) saves
        ``saved_ms``; a miss built it in ``wall_ms``."""
        with self._lock:
            if hit:
                self.cache_hits += 1
                self._counter_hits.inc()
                self.cache_saved_ms += float(saved_ms)
                self._gauge_saved.inc(float(saved_ms))
            else:
                self.cache_misses += 1
                self._counter_misses.inc()
                self.build_ms += float(wall_ms)
            self.records.append({"program": "kernel_library",
                                 "signature": str(library),
                                 "wall_ms": round(float(wall_ms), 3),
                                 "cache_hit": bool(hit), "steady": False,
                                 "ts": time.time()})

    def record_compile(self, wall_ms: float, program: str = "",
                       signature: str = "", cache_hit: bool = False):
        """Book one capture.  The program defaults to this thread's label
        (:func:`set_label`) and the signature to the label's when the
        capture names none."""
        label_program, label_signature = current_label()
        program = program or label_program
        signature = signature or label_signature
        steady = False
        with self._lock:
            entry = {"program": program, "signature": signature,
                     "wall_ms": round(float(wall_ms), 3),
                     "cache_hit": bool(cache_hit),
                     "steady": False, "ts": time.time()}
            if not cache_hit:
                self.compiles += 1
                self.total_ms += float(wall_ms)
                self._counter_compiles.inc()
                self._hist_wall.observe(float(wall_ms))
                if self.fenced:
                    steady = True
                    entry["steady"] = True
                    self.steady_compiles += 1
                    self._counter_steady.inc()
            self.records.append(entry)
        if steady:
            self._fire_steady_capture(entry)

    def _fire_steady_capture(self, entry: Dict):
        # Lazy import: flight imports THIS module at top level for its
        # bundle section.  A capture failure never leaks into the serving
        # path.
        try:
            from . import flight
            if flight.FLIGHT is not None:
                flight.FLIGHT.capture(
                    "compile",
                    reason=(f"steady-state capture: {entry['program']}"
                            f"[{entry['signature']}] "
                            f"{entry['wall_ms']:.1f}ms"))
        except Exception:  # noqa: BLE001 - observability must stay passive
            pass

    # -- distinct signatures ------------------------------------------------- #

    def signatures(self, program: Optional[str] = None
                   ) -> List[Tuple[str, str]]:
        """Distinct (program, signature) pairs among retained records of
        captures (library lookups excluded), optionally of one program."""
        with self._lock:
            seen = []
            for entry in self.records:
                if entry["cache_hit"] or entry["program"] == \
                        "kernel_library":
                    continue
                key = (entry["program"], entry["signature"])
                if program is not None and key[0] != program:
                    continue
                if key not in seen:
                    seen.append(key)
            return seen

    # -- export -------------------------------------------------------------- #

    def snapshot(self) -> Dict:
        """Flight-bundle / doctor section: counters + recent records."""
        with self._lock:
            return {
                "service": self.service,
                "compiles": self.compiles,
                "compiles_steady_state": self.steady_compiles,
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "cache_saved_ms": round(self.cache_saved_ms, 3),
                "compile_wall_ms_total": round(self.total_ms, 3),
                "kernel_build_ms_total": round(self.build_ms, 3),
                "fenced": self.fenced,
                "records": [dict(entry) for entry in self.records],
            }


def record_kernel_build(library: str, hit: bool, wall_ms: float,
                        saved_ms: float = 0.0) -> None:
    """The kernel library's build hook (``ops/_cuda.py``): books into
    :data:`LEDGER` when one is installed."""
    ledger = LEDGER
    if ledger is not None:
        ledger.record_build(library, hit, wall_ms, saved_ms)


def install(service: str = "", max_records: int = 256,
            ledger: Optional[CompileLedger] = None) -> CompileLedger:
    """Turn the ledger on (idempotent; returns the active ledger)."""
    global LEDGER
    if LEDGER is None:
        LEDGER = ledger or CompileLedger(service=service,
                                         max_records=max_records)
    return LEDGER


def uninstall():
    """Null the switchboard."""
    global LEDGER
    LEDGER = None
