"""On-demand device profiling: bracket N engine steps in a
``torch.profiler`` trace.

The port of ``aiko_services_tpu/obs/profiler.py``.  An operator sends
``(profile N)`` to any actor (the router fans it out like ``(capture)``).
The actor calls :func:`request`, which installs a :class:`DeviceProfiler`
session on the process-global switchboard ``PROFILER``.  There is one
session a process: Kineto, the profiler's tracing back end, is
process-global.

* The FIRST engine whose step loop sees the session claims it
  (:meth:`DeviceProfiler.wants`), drains its ring and runs its next N
  steps synchronously inside the trace, each dispatched chunk timed by
  CUDA events around it (the host clock on a CPU engine, and the
  manifest says which), so the manifest carries per-step device ms.
* :meth:`DeviceProfiler.finish` stops the trace, exports it as a Chrome
  trace (``trace.json``, Perfetto-loadable) and writes ``manifest.json``
  beside it, publishes ``aiko_device_step_ms`` / ``aiko_profiles_total``
  to REGISTRY, parks the manifest in :data:`LAST` (the flight recorder
  attaches it to the next bundle; ``tools/doctor.py`` renders it beside
  the tax table and feeds ``device_step_ms`` into
  ``attrib.attribute_steps``), and uninstalls itself.

Host spans already push NVTX ranges (``obs/trace.py``), which the trace
lines up against the kernels: the manifest records the scheme and the
live request trace ids.

Switchboard discipline: ``PROFILER = None`` by default, call sites guard
``profiler.PROFILER is not None``.  The bracket only times: a served
token, a cache byte and a replay's launches are the same with a session
pending or absent, and no bracket triggers a graph capture.  Stdlib-only
at import time; ``torch`` strictly lazily.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from .metrics import REGISTRY

__all__ = ["DeviceProfiler", "PROFILER", "LAST", "request", "uninstall",
           "MANIFEST_FORMAT"]

MANIFEST_FORMAT = "aiko-profile-1"

#: Process-wide switchboard: the pending/active profiling session.
PROFILER: Optional["DeviceProfiler"] = None

#: Manifest of the most recently FINISHED session (flight bundles and
#: engine stats read this; survives the session's uninstall).
LAST: Optional[Dict] = None

_SEQ_LOCK = threading.Lock()
_SEQ = 0


def _next_seq() -> int:
    global _SEQ
    with _SEQ_LOCK:
        _SEQ += 1
        return _SEQ


class DeviceProfiler:
    """One bracketed capture: N engine steps inside a ``torch.profiler``
    trace.  The first engine step loop that calls :meth:`wants` claims
    the session; other engines in the same process keep serving
    untouched."""

    def __init__(self, out_dir: str, steps: int = 4, reason: str = "",
                 trace_id: str = "", service: str = "", registry=None):
        seq = _next_seq()
        self.trace_dir = os.path.join(
            str(out_dir), f"profile_{os.getpid()}_{seq:03d}")
        self.steps_target = max(1, int(steps))
        self.reason = str(reason)
        self.trace_id = str(trace_id)
        self.service = service or f"pid{os.getpid()}"
        self.registry = registry or REGISTRY
        self.owner: Optional[int] = None
        self.started = False
        self.finished = False
        self.error = ""
        self.timing = "host_clock"
        self.chunks: List[Dict] = []      # {"ms": float, "steps": int}
        self.steps_done = 0
        self.requested_unix = time.time()
        self._profile = None

    # -- claim / lifecycle --------------------------------------------------- #

    def wants(self, owner_id: int) -> bool:
        """True if ``owner_id`` owns (or just claimed) this session and
        it still needs steps.  First caller wins."""
        if self.finished:
            return False
        if self.owner is None:
            self.owner = owner_id
        return self.owner == owner_id

    def ensure_started(self, cuda: bool = False) -> bool:
        """Start the trace (idempotent): CPU activity, and CUDA activity
        (timing by CUDA events) when ``cuda``.  A failure (another trace
        active in the process) finishes the session with an error
        instead of wedging the step loop."""
        if self.started:
            return True
        try:
            os.makedirs(self.trace_dir, exist_ok=True)
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if cuda:
                activities.append(ProfilerActivity.CUDA)
            self._profile = profile(activities=activities)
            self._profile.start()
        except Exception as error:  # noqa: BLE001
            self._profile = None
            self.error = f"profiler start failed: {error}"
            self.finish()
            return False
        self.timing = "cuda_events" if cuda else "host_clock"
        self.started = True
        return True

    def chunk_done(self, ms: float, steps: int):
        """Record one dispatched-and-synced chunk inside the bracket."""
        self.chunks.append({"ms": round(float(ms), 3),
                            "steps": int(steps)})
        self.steps_done += max(0, int(steps))

    @property
    def remaining(self) -> int:
        return max(0, self.steps_target - self.steps_done)

    # -- finish --------------------------------------------------------------- #

    def _artifacts(self) -> List[Dict]:
        found: List[Dict] = []
        for root, _dirs, files in os.walk(self.trace_dir):
            for name in sorted(files):
                if name == "manifest.json":
                    continue
                path = os.path.join(root, name)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    size = 0
                found.append({"path": os.path.relpath(path, self.trace_dir),
                              "bytes": size})
        return found

    def finish(self, live_trace_ids: Optional[List[str]] = None) -> Dict:
        """Stop the trace, export it, write the manifest, publish metrics,
        park the manifest in :data:`LAST`, and release the switchboard."""
        global LAST, PROFILER
        if self.finished:
            return LAST or {}
        self.finished = True
        if self._profile is not None:
            try:
                self._profile.stop()
                self._profile.export_chrome_trace(
                    os.path.join(self.trace_dir, "trace.json"))
            except Exception as error:  # noqa: BLE001
                self.error = self.error or f"profiler stop failed: {error}"
            self._profile = None
        total_ms = sum(chunk["ms"] for chunk in self.chunks)
        total_steps = sum(chunk["steps"] for chunk in self.chunks)
        device_step_ms = (total_ms / total_steps) if total_steps else 0.0
        manifest = {
            "format": MANIFEST_FORMAT,
            "service": self.service,
            "trace_id": self.trace_id,
            "reason": self.reason,
            "trace_dir": self.trace_dir,
            "artifacts": self._artifacts() if self.started else [],
            "steps": total_steps,
            "steps_target": self.steps_target,
            "chunks": list(self.chunks),
            "device_step_ms": round(device_step_ms, 3),
            "timing": self.timing,
            "live_trace_ids": list(live_trace_ids or []),
            "annotation_scheme": "nvtx:span:<name>#<span_id>",
            "captured_unix": time.time(),
            "ok": self.started and not self.error,
        }
        if self.error:
            manifest["error"] = self.error
        if self.started:
            try:
                path = os.path.join(self.trace_dir, "manifest.json")
                with open(path, "w", encoding="utf-8") as handle:
                    json.dump(manifest, handle, indent=1, sort_keys=True)
            except OSError:
                pass
        self.registry.counter(
            "aiko_profiles_total",
            "on-demand device profile captures").inc()
        if total_steps:
            self.registry.gauge(
                "aiko_device_step_ms",
                "measured per-step device ms from the last profile"
            ).set(device_step_ms)
        LAST = manifest
        if PROFILER is self:
            PROFILER = None
        return manifest


# --------------------------------------------------------------------------- #
# Module-level entry points.

def request(out_dir: Optional[str] = None, steps: int = 4,
            reason: str = "", trace_id: str = "",
            service: str = "") -> Optional[DeviceProfiler]:
    """Install a profiling session; ``None`` if one is already pending
    (a process profiles one bracket at a time: callers report ``busy``).
    ``out_dir`` defaults beside the flight-bundle ring when the recorder
    is installed, else ``$TMPDIR``."""
    global PROFILER
    if PROFILER is not None:
        return None
    if out_dir is None:
        # Lazy import: flight imports THIS module at top level for its
        # bundle section; keep the import-time dependency one-way.
        try:
            from . import flight
            if flight.FLIGHT is not None:
                out_dir = flight.FLIGHT.out_dir
        except Exception:  # noqa: BLE001
            out_dir = None
    if out_dir is None:
        out_dir = os.environ.get("TMPDIR", "/tmp")
    PROFILER = DeviceProfiler(out_dir, steps=steps, reason=reason,
                              trace_id=trace_id, service=service)
    return PROFILER


def uninstall():
    """Abort any pending session (finishing it if it already started)
    and clear :data:`LAST`."""
    global PROFILER, LAST
    session = PROFILER
    if session is not None and not session.finished:
        session.finish()
    PROFILER = None
    LAST = None
