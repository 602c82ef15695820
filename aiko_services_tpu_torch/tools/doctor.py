"""Capture-bundle doctor: one readable report per flight recording.

``obs/flight.py`` dumps self-contained JSON capture bundles (span
window + step-log slice + counter snapshot + manifest, all stamped
with one trace id).  This CLI is the consumer: it loads one or more
bundles — files, directories, or a whole fleet's worth — and renders
each as a single report:

- the **manifest** header (trigger, reason, trace id, service, time);
- the **span tree**, indented parent→child with durations, filtered
  to the bundle's trace id when spans match it;
- the **tax table** — the step-log slice run through
  :func:`obs.attrib.attribute_steps`; when the bundle carries a
  device-profile manifest its MEASURED ``device_step_ms`` feeds the
  attribution (the probe estimate is only a fallback), so a watchdog
  bundle directly shows where the stalled step's time went;
- the **compile ledger** section — capture counts, the kernel
  library's cache hit/miss/saved-ms, and the recent per-capture records
  with their graph keys (steady-state captures flagged);
- the **profile manifest** — artifact paths + sizes, per-chunk device
  ms, and the span-annotation scheme that stitches device kernels to
  the request span tree;
- the **pool census** — the memory accountant's per-tier
  block/byte table, flow integrals, audit sweep/violation counters,
  and the auditor's last violation list, so a ``pool_audit`` capture
  reads as "what the books said vs what the pool held";
- **counter diffs** against the recorder's install-time baseline
  (what moved since the process started flying).

Bundles sharing a trace id (the router's fleet fan-out) group into
one fleet section, so "one slow request" reads as one record across
every process that touched it; census-carrying fleet groups get a
fleet memory total line summing every process's tiers.

``--json`` renders the same content machine-readable: one summary
object per bundle under a pinned schema (:data:`JSON_FORMAT`,
``tests/test_torch_obs.py`` pins the keys) — the CI/scripting face of
the same reports.

Usage::

    python -m aiko_services_tpu_torch.tools.doctor /tmp/flight/     # dir
    python -m aiko_services_tpu_torch.tools.doctor capture_watchdog_*.json
    python -m aiko_services_tpu_torch.tools.doctor --json /tmp/flight/

Host-side, stdlib + ``obs`` only — running the doctor never imports
``torch``.  The port's copy of ``aiko_services_tpu/tools/doctor.py``: the
same report for the same bundle.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, Iterable, List, Optional

from ..obs import attrib
from ..obs.flight import FORMAT_VERSION

__all__ = ["load_bundle", "collect_paths", "span_tree_lines",
           "counter_diff_lines", "census_lines", "render_report",
           "render_fleet", "bundle_summary", "JSON_FORMAT", "main"]

#: ``--json`` output schema version — tests pin the per-bundle keys.
JSON_FORMAT = 1


def load_bundle(path: str) -> Dict:
    """Parse + validate one bundle file.  Raises ``ValueError`` on a
    bundle the doctor cannot read (wrong shape / future format)."""
    with open(path) as handle:
        bundle = json.load(handle)
    manifest = bundle.get("manifest")
    if not isinstance(manifest, dict):
        raise ValueError(f"{path}: not a capture bundle (no manifest)")
    version = manifest.get("format")
    if version != FORMAT_VERSION:
        raise ValueError(f"{path}: bundle format {version!r}, "
                         f"this doctor reads {FORMAT_VERSION}")
    bundle["_path"] = path
    return bundle


def collect_paths(arguments: Iterable[str]) -> List[str]:
    """Expand files / directories / globs into bundle file paths."""
    paths: List[str] = []
    for argument in arguments:
        if os.path.isdir(argument):
            paths.extend(sorted(
                glob.glob(os.path.join(argument, "capture_*.json"))))
        elif os.path.exists(argument):
            paths.append(argument)
        else:
            paths.extend(sorted(glob.glob(argument)))
    return paths


# -- span tree ---------------------------------------------------------------- #

def span_tree_lines(span_dicts: List[Dict]) -> List[str]:
    """Indented parent→child rendering of span dicts (the
    ``Span.to_dict`` form).  Orphans (parent outside the window)
    render as roots — a bounded ring legitimately loses ancestors."""
    by_id = {span["sid"]: span for span in span_dicts
             if isinstance(span, dict) and "sid" in span}
    children: Dict[str, List[Dict]] = {}
    roots: List[Dict] = []
    for span in by_id.values():
        parent = span.get("pid")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(span)
        else:
            roots.append(span)
    lines: List[str] = []

    def walk(span: Dict, depth: int):
        duration_ms = (span.get("t1", span["t0"]) - span["t0"]) * 1e3
        marks = span.get("marks") or []
        note = (" [" + ", ".join(name for name, _ in marks) + "]"
                if marks else "")
        lines.append(f"  {'  ' * depth}{span.get('name', '?'):<24} "
                     f"{duration_ms:>9.2f} ms  "
                     f"({span.get('svc', '?')}){note}")
        for child in sorted(children.get(span["sid"], []),
                            key=lambda s: s.get("t0", 0.0)):
            walk(child, depth + 1)

    for root in sorted(roots, key=lambda s: s.get("t0", 0.0)):
        walk(root, 0)
    return lines


# -- counters ----------------------------------------------------------------- #

def _fmt(value) -> str:
    return f"{value:g}" if isinstance(value, (int, float)) \
        else str(value)


def counter_diff_lines(counters: Dict, limit: int = 40) -> List[str]:
    """What moved between the recorder's install-time baseline and the
    capture — the "what was the process doing" section."""
    current = counters.get("metrics", {}) or {}
    baseline = counters.get("baseline", {}) or {}
    lines: List[str] = []
    for key in sorted(current):
        now_value, then_value = current[key], baseline.get(key)
        if now_value == then_value:
            continue
        if isinstance(now_value, dict):
            # Histogram snapshot entries: diff on the sample count.
            now_count = now_value.get("count", 0)
            then_count = (then_value or {}).get("count", 0) \
                if isinstance(then_value, dict) else 0
            if now_count == then_count:
                continue
            lines.append(
                f"  {key:<56} n {then_count} -> {now_count} "
                f"(p95 {now_value.get('p95', 0):g} ms)")
        else:
            lines.append(
                f"  {key:<56} "
                f"{_fmt(then_value if then_value is not None else 0)}"
                f" -> {_fmt(now_value)}")
    if len(lines) > limit:
        lines = lines[:limit] + [f"  … {len(lines) - limit} more"]
    return lines


# -- pool census -------------------------------------------------------------- #

def _mib(nbytes) -> str:
    return f"{int(nbytes) / (1024 * 1024):.2f} MiB"


def census_lines(census: Dict) -> List[str]:
    """Render one bundle's ``census`` section (the auditor snapshot):
    per-tier occupancy table, flow integrals, state histogram, audit
    counters, and the most recent violations."""
    lines = [
        f"pool census: {census.get('sweeps', 0)} audit sweeps, "
        f"{census.get('violations_total', 0)} violations"]
    snap = census.get("census") or {}
    tiers = snap.get("tiers") or {}
    integrated = census.get("integrated_bytes") or {}
    if tiers:
        lines.append(f"  {'tier':<6} {'blocks':>8} {'bytes':>14} "
                     f"{'flow integral':>14}")
        for tier in ("hbm", "host", "disk"):
            info = tiers.get(tier, {})
            lines.append(
                f"  {tier:<6} {int(info.get('blocks', 0)):>8} "
                f"{_mib(info.get('bytes', 0)):>14} "
                f"{_mib(integrated.get(tier, 0)):>14}")
    states = snap.get("states") or {}
    if states:
        lines.append("  states: " + ", ".join(
            f"{state}={count}" for state, count
            in sorted(states.items()) if count))
    flows = census.get("flows") or {}
    moved = {name: entry for name, entry in flows.items()
             if entry.get("blocks")}
    if moved:
        lines.append("  flows:  " + ", ".join(
            f"{name}={entry['blocks']}" for name, entry
            in sorted(moved.items())))
    for violation in (census.get("last_violations") or [])[:8]:
        lines.append(f"  VIOLATION: {violation}")
    return lines


# -- report ------------------------------------------------------------------- #

def render_report(bundle: Dict) -> str:
    manifest = bundle["manifest"]
    lines = [
        "=" * 72,
        f"capture: {manifest.get('trigger', '?')} — "
        f"{manifest.get('reason') or '(no reason recorded)'}",
        f"  trace_id: {manifest.get('trace_id', '?')}",
        f"  service:  {manifest.get('service', '?')} "
        f"(pid {manifest.get('pid', '?')})  "
        f"at {manifest.get('captured', '?')}",
    ]
    if bundle.get("_path"):
        lines.append(f"  bundle:   {bundle['_path']}")

    spans = (bundle.get("spans") or {}).get("spans") or []
    lines.append("")
    if spans:
        matched = (bundle.get("spans") or {}).get("matched")
        lines.append(f"span tree ({len(spans)} spans"
                     + (", matched trace" if matched else "") + "):")
        lines.extend(span_tree_lines(spans))
    else:
        lines.append("span tree: (no spans in the window)")

    steplog = bundle.get("steplog") or {}
    events = steplog.get("events") or []
    profile = bundle.get("profile") or {}
    device_step_ms = profile.get("device_step_ms") or None
    lines.append("")
    if len(events) >= 2:
        table = attrib.attribute_steps(
            [(row[0], row[1], row[2]) for row in events],
            device_step_ms=device_step_ms)
        lines.append(table.render())
        if device_step_ms:
            lines.append(f"  (device_step_ms {device_step_ms:g} "
                         f"MEASURED by the profile bracket below)")
        if steplog.get("dropped"):
            lines.append(f"  (ring dropped {steplog['dropped']} "
                         f"older rows)")
    else:
        lines.append("step log: (empty — no engine loop in this "
                     "process, or recorder off)")

    compiles = bundle.get("compiles") or {}
    if compiles:
        lines.append("")
        lines.append(
            f"compile ledger: {compiles.get('compiles', 0)} compiles "
            f"({compiles.get('compiles_steady_state', 0)} steady-state)"
            f", cache {compiles.get('cache_hits', 0)} hit / "
            f"{compiles.get('cache_misses', 0)} miss, "
            f"saved {compiles.get('cache_saved_ms', 0):g} ms"
            + (", FENCED" if compiles.get("fenced") else ""))
        for record in (compiles.get("records") or [])[-12:]:
            flag = "  << STEADY-STATE" if record.get("steady") else (
                "  (cache hit)" if record.get("cache_hit") else "")
            lines.append(
                f"  {record.get('program', '?'):<16} "
                f"{record.get('signature', '') or '-':<12} "
                f"{record.get('wall_ms', 0):>9.2f} ms{flag}")

    if profile:
        lines.append("")
        status = "ok" if profile.get("ok") else \
            f"FAILED: {profile.get('error', '?')}"
        lines.append(
            f"device profile ({status}): {profile.get('steps', 0)} "
            f"steps bracketed, device_step_ms "
            f"{profile.get('device_step_ms', 0):g}"
            + (f" — {profile.get('reason')}" if profile.get("reason")
               else ""))
        lines.append(f"  trace_dir: {profile.get('trace_dir', '?')}  "
                     f"(annotations: "
                     f"{profile.get('annotation_scheme', '?')})")
        for artifact in (profile.get("artifacts") or [])[:8]:
            lines.append(f"  artifact: {artifact.get('path', '?')} "
                         f"({artifact.get('bytes', 0)} bytes)")
        if profile.get("live_trace_ids"):
            lines.append("  live requests during bracket: "
                         + ", ".join(profile["live_trace_ids"][:6]))

    census = bundle.get("census") or {}
    if census:
        lines.append("")
        lines.extend(census_lines(census))

    diff = counter_diff_lines(bundle.get("counters") or {})
    lines.append("")
    if diff:
        lines.append("counters (baseline -> capture):")
        lines.extend(diff)
    else:
        lines.append("counters: (nothing moved since baseline)")

    providers = ((bundle.get("counters") or {}).get("providers")
                 or {})
    for name, payload in sorted(providers.items()):
        interesting = {key: value for key, value in payload.items()
                       if isinstance(value, (int, float)) and value}
        if interesting:
            lines.append(f"  provider {name}: " + ", ".join(
                f"{key}={value:g}" for key, value
                in sorted(interesting.items())[:12]))
    return "\n".join(lines)


def bundle_summary(bundle: Dict) -> Dict:
    """Machine-readable per-bundle summary — the ``--json`` schema
    (version :data:`JSON_FORMAT`; tests pin these keys)."""
    manifest = bundle.get("manifest") or {}
    spans = bundle.get("spans") or {}
    steplog = bundle.get("steplog") or {}
    events = steplog.get("events") or []
    profile = bundle.get("profile") or {}
    compiles = bundle.get("compiles") or {}
    tax = None
    if len(events) >= 2:
        tax = attrib.attribute_steps(
            [(row[0], row[1], row[2]) for row in events],
            device_step_ms=profile.get("device_step_ms") or None
        ).to_dict()
    summary = {
        "path": bundle.get("_path", ""),
        "trigger": manifest.get("trigger", ""),
        "reason": manifest.get("reason", ""),
        "trace_id": manifest.get("trace_id", ""),
        "service": manifest.get("service", ""),
        "pid": manifest.get("pid", 0),
        "captured_unix": manifest.get("captured_unix", 0.0),
        "spans": {"count": len(spans.get("spans") or []),
                  "matched": bool(spans.get("matched"))},
        "steplog": {"events": len(events),
                    "dropped": steplog.get("dropped", 0)},
        "tax_table": tax,
        "counters_moved": len(
            counter_diff_lines(bundle.get("counters") or {},
                               limit=10_000)),
        "compiles": None,
        "profile": None,
        "census": None,
    }
    if compiles:
        summary["compiles"] = {
            "compiles": compiles.get("compiles", 0),
            "compiles_steady_state":
                compiles.get("compiles_steady_state", 0),
            "cache_hits": compiles.get("cache_hits", 0),
            "cache_misses": compiles.get("cache_misses", 0),
            "cache_saved_ms": compiles.get("cache_saved_ms", 0.0),
            "fenced": bool(compiles.get("fenced")),
            "records": len(compiles.get("records") or []),
        }
    if profile:
        summary["profile"] = {
            "ok": bool(profile.get("ok")),
            "steps": profile.get("steps", 0),
            "device_step_ms": profile.get("device_step_ms", 0.0),
            "trace_dir": profile.get("trace_dir", ""),
            "artifacts": len(profile.get("artifacts") or []),
        }
    census = bundle.get("census") or {}
    if census:
        snap = census.get("census") or {}
        summary["census"] = {
            "sweeps": census.get("sweeps", 0),
            "violations_total": census.get("violations_total", 0),
            "last_violations": len(census.get("last_violations")
                                   or []),
            "tiers": {tier: dict(info) for tier, info
                      in (snap.get("tiers") or {}).items()},
        }
    return summary


def render_fleet(bundles: List[Dict]) -> str:
    """Group bundles by trace id: the router fan-out makes one
    incident → N bundles → ONE fleet section here."""
    groups: Dict[str, List[Dict]] = {}
    for bundle in bundles:
        groups.setdefault(
            bundle["manifest"].get("trace_id", "?"), []).append(bundle)
    sections: List[str] = []
    for trace_id, group in sorted(
            groups.items(),
            key=lambda item: item[1][0]["manifest"].get(
                "captured_unix", 0.0)):
        if len(group) > 1:
            services = ", ".join(sorted(
                b["manifest"].get("service", "?") for b in group))
            sections.append(f"\n### fleet capture {trace_id} "
                            f"({len(group)} processes: {services})")
            totals = {"hbm": 0, "host": 0, "disk": 0}
            carrying = 0
            for bundle in group:
                tiers = ((bundle.get("census") or {}).get("census")
                         or {}).get("tiers") or {}
                if tiers:
                    carrying += 1
                    for tier in totals:
                        totals[tier] += int(
                            tiers.get(tier, {}).get("bytes", 0))
            if carrying:
                sections.append(
                    f"fleet memory ({carrying} censuses): " + ", ".join(
                        f"{tier} {_mib(totals[tier])}"
                        for tier in ("hbm", "host", "disk")))
        for bundle in sorted(
                group, key=lambda b: b["manifest"].get(
                    "captured_unix", 0.0)):
            sections.append(render_report(bundle))
    return "\n".join(sections)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m aiko_services_tpu_torch.tools.doctor",
        description="Render flight-recorder capture bundles as "
                    "readable reports (grouped by trace id).")
    parser.add_argument("paths", nargs="+",
                        help="bundle files, globs, or directories")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable summaries (pinned "
                             "schema) instead of the text report")
    arguments = parser.parse_args(argv)
    paths = collect_paths(arguments.paths)
    if not paths:
        print("doctor: no capture bundles found", file=sys.stderr)
        return 1
    bundles: List[Dict] = []
    failed = 0
    for path in paths:
        try:
            bundles.append(load_bundle(path))
        except (OSError, ValueError, json.JSONDecodeError) as error:
            print(f"doctor: skipping {path}: {error}", file=sys.stderr)
            failed += 1
    if not bundles:
        return 1
    if arguments.json:
        print(json.dumps(
            {"format": JSON_FORMAT,
             "bundles": [bundle_summary(b) for b in bundles]},
            indent=1, sort_keys=True))
    else:
        print(render_fleet(bundles))
    return 0 if not failed else 2


if __name__ == "__main__":
    raise SystemExit(main())
