"""Engine step timeline: fixed-size ring-buffer event recorder.

The port's copy of ``aiko_services_tpu/obs/steplog.py`` (it has no JAX
in it); its imports point at the port's own modules.

The profiling instrument ROADMAP item 5 asks for: WHERE does the
host-path tax between raw decode throughput and served throughput go?
The serving engines already count sync stalls; this recorder captures
the per-step event SEQUENCE — dispatch, ring-sync wait (with the wait
duration), commit, admission wave, sampling-param edit — so a slow
step is attributable, not just countable.

Zero-cost discipline (identical to ``faults.PLAN``): the module-level
:data:`RECORDER` defaults to ``None`` and every call site in
``orchestration/continuous.py`` / ``orchestration/paged.py`` is
guarded::

    if steplog.RECORDER is not None:
        steplog.RECORDER.record("dispatch", step=n, slots=k)

Disabled cost: one module-attribute load + identity test per site.
AST tests pin the guard on every site, and the jaxpr guard test pins
that an installed recorder cannot change the traced step program —
recording is HOST-side orchestration only, never inside jit.

Events export as Chrome trace-event instants/durations on a dedicated
"engine" track so a step timeline can be overlaid with request spans
(:func:`aiko_services_tpu_torch.obs.trace.chrome_events`) in one Perfetto
view.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

__all__ = ["StepRecorder", "RECORDER", "install", "uninstall"]

_EPOCH0 = time.time() - time.perf_counter()


def _now() -> float:
    return _EPOCH0 + time.perf_counter()


class StepRecorder:
    """Bounded ring of ``(t, event, fields)`` host-step events."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self.dropped = 0  # events that fell off the ring

    def record(self, event: str, **fields):
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self._ring.append((_now(), event, fields))

    def events(self) -> List[Tuple[float, str, Dict]]:
        return list(self._ring)

    def clear(self):
        self._ring.clear()
        self.dropped = 0

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for _, event, _fields in self._ring:
            out[event] = out.get(event, 0) + 1
        return out

    # -- export -------------------------------------------------------------- #

    def chrome_events(self, pid: int = 0, tid: int = 0) -> List[Dict]:
        """Instant events, except events carrying a ``wait_ms`` /
        ``ms`` field which render as complete events ENDING at the
        recorded timestamp (the wait is measured, then recorded)."""
        events: List[Dict] = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": tid,
             "args": {"name": "engine"}},
        ]
        for at, event, fields in self._ring:
            ts = int(round(at * 1e6))
            duration_ms = fields.get("wait_ms", fields.get("ms"))
            args = {key: value for key, value in fields.items()
                    if isinstance(value, (int, float, str, bool))}
            if duration_ms:
                duration = max(1, int(round(float(duration_ms) * 1e3)))
                events.append({"ph": "X", "name": event,
                               "cat": "engine", "pid": pid, "tid": tid,
                               "ts": ts - duration, "dur": duration,
                               "args": args})
            else:
                events.append({"ph": "i", "name": event,
                               "cat": "engine", "pid": pid, "tid": tid,
                               "ts": ts, "s": "t", "args": args})
        return events

    def export_chrome(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as handle:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, handle, indent=1)
        return path


#: Module switchboard — ``None`` means recording is OFF everywhere.
RECORDER: Optional[StepRecorder] = None


def install(recorder: Optional[StepRecorder] = None,
            capacity: int = 4096) -> StepRecorder:
    global RECORDER
    RECORDER = recorder or StepRecorder(capacity=capacity)
    return RECORDER


def uninstall():
    global RECORDER
    RECORDER = None
