"""Step-time attribution: the host-path tax budget table.

The standing ROADMAP item: the continuous-batching engine decodes at
0.42–0.51× raw-decode throughput on CPU against a ≥0.50 target, and
the gap is HOST tax — but which host work?  This module turns the
PR-6 step log (the engine loop's phase sequence: ``dispatch``,
``sync`` waits, ``token_dispatch``, ``commit``, ``admission``,
``state_upload``, ``sampling_edit``) into a per-step **tax budget
table** whose rows must sum to within tolerance of measured wall
time — so the gap is attributed to NAMED levers instead of guessed
at.

**Attribution model.**  Step-log rows are recorded when a phase
*ends*, and two events carry embedded durations (``sync.wait_ms`` —
the device→host wait, and ``token_dispatch.ms`` — the per-token
host fan-out).  Walking rows in time order:

- an embedded duration is attributed to its own component
  (``sync_wait`` / ``token_dispatch``);
- the REST of the gap back to the previous row (gap − embedded) is
  host work that ended at this row — attributed to the row's event
  name (``dispatch``, ``commit``, ``admission``, …).

Gaps tile the recorded window exactly, so the component rows sum to
the covered window by construction; against an externally measured
wall time the residual shows up honestly as an ``uninstrumented``
row rather than silently inflating a phase.  With a device-time
sample (``probe_device_ms`` — CUDA events around a step off the hot
path, or a ``(profile)`` bracket on ``torch.profiler``), the ``sync_wait``
row splits into ``device_compute`` (the part the hardware needed)
and ``sync_excess`` (scheduling slack — host tax again).

Each component row names its ROADMAP lever, so the bench table reads
as a worklist, not a post-mortem.

Stdlib-only, host-side; ``torch`` is imported lazily and ONLY inside
:func:`probe_device_ms` (importing this module never touches a device).
A copy of ``aiko_services_tpu/obs/attrib.py``: the table, the levers and
the attribution model are the same; the device probe times on CUDA
events.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["TaxRow", "TaxTable", "attribute_steps", "probe_device_ms",
           "LEVERS", "ADMISSION_COMPONENTS"]

#: Component → the ROADMAP lever that would shrink it.
LEVERS: Dict[str, str] = {
    "token_dispatch": "batched host-side token dispatch",
    "sync_wait": "wider in-flight ring",
    "sync_excess": "wider in-flight ring",
    "device_compute": "(device time — not host tax)",
    "sampling_edit": "device-resident sampling-param edits",
    "state_upload": "device-resident sampling-param edits",
    "dispatch": "wider in-flight ring",
    "sync": "wider in-flight ring",
    "commit": "batched host-side token dispatch",
    "admission": "(per-request admission cost)",
    "paged_prefill": "(prefill — not decode-loop tax)",
    "post_admission_dispatch":
        "(prefill compute absorbed by the wave's first dispatch "
        "on a throttled backend — not decode-loop tax)",
    "uninstrumented": "(outside the step log's window)",
}

#: Components that belong to ADMISSION (prompt intake + prefill), not
#: the steady-state decode loop — the split behind the decode-loop
#: engine-vs-raw ratio (``bench.py --section step_attribution``).
ADMISSION_COMPONENTS = ("admission", "paged_prefill", "sampling_edit",
                        "post_admission_dispatch")

#: event name → (field carrying an embedded duration, component name).
_EMBEDDED: Dict[str, Tuple[str, str]] = {
    "sync": ("wait_ms", "sync_wait"),
    "token_dispatch": ("ms", "token_dispatch"),
}


@dataclass
class TaxRow:
    component: str
    ms: float
    share: float           # fraction of the table's wall time
    events: int            # step-log rows contributing
    lever: str = ""

    def to_dict(self) -> Dict:
        return {"component": self.component, "ms": round(self.ms, 3),
                "share": round(self.share, 4), "events": self.events,
                "lever": self.lever}


@dataclass
class TaxTable:
    rows: List[TaxRow] = field(default_factory=list)
    wall_ms: float = 0.0        # what the rows are budgeted against
    covered_ms: float = 0.0     # the step-log window itself
    steps: int = 0              # ring syncs observed (decode steps)

    @property
    def total_ms(self) -> float:
        return sum(row.ms for row in self.rows)

    def within(self, tolerance: float = 0.10) -> bool:
        """Do the rows sum to the wall time within ``tolerance``?
        This is the acceptance gate: an attribution that does not add
        up is worse than none."""
        if self.wall_ms <= 0:
            return False
        return abs(self.total_ms - self.wall_ms) \
            <= tolerance * self.wall_ms

    def to_dict(self) -> Dict:
        return {"wall_ms": round(self.wall_ms, 3),
                "covered_ms": round(self.covered_ms, 3),
                "total_ms": round(self.total_ms, 3),
                "steps": self.steps,
                "rows": [row.to_dict() for row in self.rows]}

    def render(self) -> str:
        """Aligned text table (the doctor / bench output)."""
        lines = [f"step-time tax budget — wall {self.wall_ms:.1f} ms, "
                 f"attributed {self.total_ms:.1f} ms "
                 f"({self.steps} steps)"]
        header = (f"  {'component':<16} {'ms':>10} {'share':>7} "
                  f"{'events':>7}  lever")
        lines.append(header)
        lines.append("  " + "-" * (len(header) + 8))
        for row in sorted(self.rows, key=lambda r: -r.ms):
            lines.append(
                f"  {row.component:<16} {row.ms:>10.2f} "
                f"{row.share:>6.1%} {row.events:>7}  {row.lever}")
        return "\n".join(lines)


def attribute_steps(events: Iterable[Tuple[float, str, Dict]],
                    wall_ms: Optional[float] = None,
                    device_step_ms: Optional[float] = None) -> TaxTable:
    """Build the tax table from step-log rows.

    ``events``         ``(t, event, fields)`` rows (the
                       ``StepRecorder.events()`` form), any order;
    ``wall_ms``        externally measured wall time the rows must
                       account for — defaults to the covered window;
    ``device_step_ms`` a per-step device-time sample: splits
                       ``sync_wait`` into ``device_compute`` +
                       ``sync_excess``.
    """
    rows = sorted(events, key=lambda row: row[0])
    table = TaxTable()
    if len(rows) < 2:
        table.wall_ms = wall_ms or 0.0
        if table.wall_ms > 0:
            table.rows.append(TaxRow("uninstrumented", table.wall_ms,
                                     1.0, 0,
                                     LEVERS["uninstrumented"]))
        return table

    ms_of: Dict[str, float] = {}
    hits: Dict[str, int] = {}
    previous_t = rows[0][0]
    syncs = 0
    for t, event, fields in rows[1:]:
        gap_ms = max(0.0, (t - previous_t) * 1e3)
        previous_t = t
        embedded_field, embedded_component = _EMBEDDED.get(
            event, (None, None))
        embedded_ms = 0.0
        if embedded_field is not None:
            try:
                embedded_ms = min(gap_ms,
                                  float(fields.get(embedded_field, 0.0)))
            except (TypeError, ValueError):
                embedded_ms = 0.0
            ms_of[embedded_component] = \
                ms_of.get(embedded_component, 0.0) + embedded_ms
            if embedded_component != event:
                hits[embedded_component] = \
                    hits.get(embedded_component, 0) + 1
        component = event
        if event == "dispatch" and fields.get("after_admission"):
            component = "post_admission_dispatch"
        hits[component] = hits.get(component, 0) + 1
        # The rest of the gap is host work ending at this row.
        ms_of[component] = ms_of.get(component, 0.0) \
            + gap_ms - embedded_ms
        if event == "sync":
            syncs += int(fields.get("steps", 1) or 1)

    # The gaps tile [t_first, t_last] exactly.
    covered_ms = max(0.0, (rows[-1][0] - rows[0][0]) * 1e3)
    table.covered_ms = covered_ms
    table.steps = syncs
    table.wall_ms = wall_ms if wall_ms is not None else covered_ms

    # Device-time split: the wait the hardware genuinely needed vs
    # scheduling slack.
    if device_step_ms is not None and syncs > 0 \
            and "sync_wait" in ms_of:
        device_ms = min(ms_of["sync_wait"],
                        float(device_step_ms) * syncs)
        excess = ms_of.pop("sync_wait") - device_ms
        ms_of["device_compute"] = device_ms
        hits["device_compute"] = syncs
        if excess > 0:
            ms_of["sync_excess"] = excess
            hits["sync_excess"] = hits.pop("sync_wait", syncs)

    residual = table.wall_ms - covered_ms
    if residual > 0:
        ms_of["uninstrumented"] = residual
        hits["uninstrumented"] = 0

    wall = table.wall_ms or 1.0
    for component, ms in ms_of.items():
        table.rows.append(TaxRow(
            component=component, ms=ms, share=ms / wall,
            events=hits.get(component, 0),
            lever=LEVERS.get(component, "")))
    table.rows.sort(key=lambda row: -row.ms)
    return table


def probe_device_ms(thunk, reps: int = 5, warmup: int = 1) -> float:
    """Median card time of ``thunk()``, OFF the serving hot path: CUDA
    events recorded before and after each call on the current stream,
    synchronised.  The sample feeds ``device_step_ms`` so the tax table
    can separate device compute from host slack.  Needs a card: a probe
    without one raises rather than timing the host."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("probe_device_ms times on CUDA events: it needs "
                           "a CUDA card")
    for _ in range(max(0, warmup)):
        thunk()
    torch.cuda.synchronize()
    samples = []
    for _ in range(max(1, reps)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        thunk()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    samples.sort()
    return samples[len(samples) // 2]
