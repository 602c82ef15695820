"""KV pool audit: byte-exact tier census + online cross-tier auditor.

The paged pool is three tiers deep (HBM -> host RAM -> CRC-sealed SSD
spill, ARCHITECTURE invariants 10-13) but its observability was a
handful of point-in-time counters: nothing could answer "who owns
every byte of pool memory right now, on which tier, and is the pool's
internal accounting actually consistent?"  ROADMAP items 1 (adapters
and KV in ONE unified pool) and 2 (fleet-shared cold tiers) are
un-debuggable without that answer.  This module provides it in two
passive layers:

* :class:`PoolAccountant` — attributes every pool block on every tier
  to its owner (chain key, depth, tier, dtype, bytes, refcount,
  pin state, producing/RESTORING sentinel, adapter-seeded flag) via
  the engine's ground-truth :meth:`~..orchestration.paged
  .PagedContinuousServer.pool_census`, exposed as REGISTRY gauges
  (``aiko_kv_bytes{tier=hbm|host|disk}``, ``aiko_kv_blocks{tier=}``,
  ``aiko_kv_blocks_by_state{state=}``) plus tier-FLOW counters
  (``aiko_kv_flow_blocks_total{flow=}`` /
  ``aiko_kv_flow_bytes_total{flow=}``) for every block movement —
  alloc/free/demote/restore/spill/adopt/purge/... — so per-tier
  occupancy is INTEGRABLE from the counters alone
  (:func:`integrate_flows`; exactness pinned in
  tests/test_pool_audit.py and tests/test_torch_obs.py).  Snapshot-able
  without stopping the engine: a census is a host-side dict walk, no
  device sync.
* :class:`PoolAuditor` — an online auditor OFF the hot path that
  reconciles the accountant against ground truth each sweep:
  free + owned + producing partition the pool exactly, refcounts
  match reachable readers (each owning slot holds one ref; an import
  lease may hold one more), the eviction clock is monotone across all
  three tiers, single-residency holds between index / host dict /
  SpillStore, and the spill directory's files match the index.  Any
  violation bumps ``aiko_kv_audit_violations_total`` and fires a
  flight capture (trigger ``"pool_audit"``, rate-limited by the
  recorder) with the full census attached — but NEVER alters pool
  state or serving behavior (invariant 16: the auditor is passive;
  bit-exact tokens pinned under injected corruption in tests).

Switchboard discipline (swept by ``scripts/obs_lint.py``): module
default ``AUDITOR = None``; every call site outside this module
guards with ``pool_audit.AUDITOR is not None``, so the uninstalled
cost is a pointer test.  Nothing here touches a tensor: a served
token, a cache byte and a chunk graph's launches are the same with the
auditor installed or absent, no sweep triggers a capture, and no audit
code exists under ``models/`` or ``ops/``.

A copy of ``aiko_services_tpu/obs/pool_audit.py`` (it imports no JAX):
the census layout, the flow names and the checks are the same, so the
two packages' flow integrals agree on the same flows.  Stdlib-only at
import time (``obs`` package discipline); the flight recorder is
imported lazily at capture time only.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from .metrics import REGISTRY

__all__ = ["PoolAccountant", "PoolAuditor", "AUDITOR", "install",
           "uninstall", "TIERS", "FLOWS", "integrate_flows"]

#: Process-wide switchboard.  ``None`` (the default) means pool audit
#: observability is OFF and every guarded call site is a pointer test.
AUDITOR: Optional["PoolAuditor"] = None

#: The tier tower, top down.
TIERS = ("hbm", "host", "disk")

#: Every block movement the engine books (paged.py + kvstore hooks).
#: Flows — not levels — are the exported primitive so occupancy can be
#: integrated from monotonic counters alone (no sampling gaps):
#:
#: ============== ===================================================
#: flow           movement
#: ============== ===================================================
#: alloc          free list -> HBM (reservation, restore, import)
#: free           HBM -> free list (release, purge, cancel)
#: demote         HBM -> host RAM (eviction with a tier below)
#: restore        host RAM -> HBM landing queue (promotion)
#: disk_restore   disk -> HBM landing queue (promotion)
#: spill          host RAM -> disk (host overflow, durable group)
#: adopt          spill directory -> disk tier (warm restart)
#: disk_to_host   disk -> host RAM (restore that could not fit)
#: purge_host     host RAM -> gone (overflow with no spill)
#: purge_disk     disk -> gone (capacity overflow, checksum trip)
#: discard_host   host RAM -> gone (HBM re-registration supersedes)
#: discard_disk   disk -> gone (HBM re-registration supersedes)
#: ============== ===================================================
FLOWS = ("alloc", "free", "demote", "restore", "disk_restore",
         "spill", "adopt", "disk_to_host", "purge_host", "purge_disk",
         "discard_host", "discard_disk")

#: tier -> (inflows, outflows): the integration identity.  A restore
#: books only the SOURCE tier's outflow — the matching HBM inflow is
#: the ``alloc`` at the pool pop, so nothing double-counts.
_INTEGRATION = {
    "hbm": (("alloc",), ("free", "demote")),
    "host": (("demote", "disk_to_host"),
             ("restore", "spill", "purge_host", "discard_host")),
    "disk": (("spill", "adopt"),
             ("disk_restore", "disk_to_host", "purge_disk",
              "discard_disk")),
}


#: flow name -> [(tier, sign), …] — the transpose of
#: ``_INTEGRATION``, so the hot-path flow hook can keep a running
#: occupancy (and its peak) without re-integrating every counter.
_FLOW_TIERS: Dict[str, List] = {name: [] for name in FLOWS}
for _tier, (_inflows, _outflows) in _INTEGRATION.items():
    for _name in _inflows:
        _FLOW_TIERS[_name].append((_tier, 1))
    for _name in _outflows:
        _FLOW_TIERS[_name].append((_tier, -1))


def integrate_flows(flows: Dict[str, Dict[str, int]],
                    field: str = "blocks") -> Dict[str, int]:
    """Per-tier net occupancy from cumulative flow counters alone
    (``field`` is ``"blocks"`` or ``"bytes"``).  With the accountant
    installed from engine construction this EQUALS the live census —
    the exactness test pins it."""
    out: Dict[str, int] = {}
    for tier, (inflows, outflows) in _INTEGRATION.items():
        net = 0
        for name in inflows:
            net += int(flows.get(name, {}).get(field, 0))
        for name in outflows:
            net -= int(flows.get(name, {}).get(field, 0))
        out[tier] = net
    return out


class PoolAccountant:
    """Books every tier flow and mirrors the latest census into
    REGISTRY gauges.  Thread-safe on the flow path (engine step thread
    vs. wire census commands); gauge refresh is last-writer-wins like
    every other gauge in the registry."""

    def __init__(self, service: str = "", registry=None):
        self.service = service or f"pid{os.getpid()}"
        self.registry = registry or REGISTRY
        self._lock = threading.Lock()
        self.flows: Dict[str, Dict[str, int]] = {
            name: {"blocks": 0, "bytes": 0} for name in FLOWS}
        #: Running flow-integrated occupancy and its high-water mark
        #: per tier — byte-exact at every transition (no sampling), so
        #: ``LoadReport.peak_kv_bytes`` is a true peak.
        self.occupancy: Dict[str, Dict[str, int]] = {
            tier: {"blocks": 0, "bytes": 0} for tier in TIERS}
        self.peak: Dict[str, Dict[str, int]] = {
            tier: {"blocks": 0, "bytes": 0} for tier in TIERS}
        self.last_census: Optional[Dict] = None
        self._gauge_bytes = {
            tier: self.registry.gauge(
                "aiko_kv_bytes",
                "KV pool bytes resident per tier",
                labels={"tier": tier}) for tier in TIERS}
        self._gauge_blocks = {
            tier: self.registry.gauge(
                "aiko_kv_blocks",
                "KV pool blocks resident per tier",
                labels={"tier": tier}) for tier in TIERS}
        self._flow_blocks = {
            name: self.registry.counter(
                "aiko_kv_flow_blocks_total",
                "KV pool block movements by flow (occupancy is the "
                "integral; see obs/pool_audit.py)",
                labels={"flow": name}) for name in FLOWS}
        self._flow_bytes = {
            name: self.registry.counter(
                "aiko_kv_flow_bytes_total",
                "KV pool byte movements by flow",
                labels={"flow": name}) for name in FLOWS}
        self._state_gauges: Dict[str, object] = {}
        #: Multi-tenant adapter paging: factor-page residency per tier
        #: and per-adapter slot occupancy, mirrored from the census's
        #: ``adapters`` section (lazily — base-model pools never
        #: create the series).
        self._adapter_page_gauges: Dict[str, object] = {}
        self._adapter_slot_gauges: Dict[str, object] = {}

    # -- hot-path hook (one dict update + two counter incs) ---------------- #

    def flow(self, name: str, blocks: int, nbytes: int):
        """Book one block movement.  Unknown flow names raise — a
        typo'd call site must fail tests, not silently unbalance the
        integration identity."""
        entry = self.flows[name]
        with self._lock:
            entry["blocks"] += int(blocks)
            entry["bytes"] += int(nbytes)
            for tier, sign in _FLOW_TIERS[name]:
                occupancy = self.occupancy[tier]
                occupancy["blocks"] += sign * int(blocks)
                occupancy["bytes"] += sign * int(nbytes)
                peak = self.peak[tier]
                if occupancy["blocks"] > peak["blocks"]:
                    peak["blocks"] = occupancy["blocks"]
                if occupancy["bytes"] > peak["bytes"]:
                    peak["bytes"] = occupancy["bytes"]
        self._flow_blocks[name].inc(int(blocks))
        self._flow_bytes[name].inc(int(nbytes))

    # -- census mirror ------------------------------------------------------ #

    def refresh(self, census: Dict):
        """Mirror one engine census into the tier/state gauges."""
        self.last_census = census
        for tier in TIERS:
            info = census.get("tiers", {}).get(tier, {})
            self._gauge_blocks[tier].set(int(info.get("blocks", 0)))
            self._gauge_bytes[tier].set(int(info.get("bytes", 0)))
        for state, count in census.get("states", {}).items():
            gauge = self._state_gauges.get(state)
            if gauge is None:
                gauge = self.registry.gauge(
                    "aiko_kv_blocks_by_state",
                    "KV pool blocks by ownership state",
                    labels={"state": state})
                self._state_gauges[state] = gauge
            gauge.set(int(count))
        adapters = census.get("adapters") or {}
        for tier, pages in adapters.get("pages", {}).items():
            gauge = self._adapter_page_gauges.get(tier)
            if gauge is None:
                gauge = self.registry.gauge(
                    "aiko_adapter_pages",
                    "paged LoRA adapter factor pages resident per "
                    "tier (same pool as KV; see kvstore/adapters.py)",
                    labels={"tier": tier})
                self._adapter_page_gauges[tier] = gauge
            gauge.set(int(pages))
        for name, slots in adapters.get("slots", {}).items():
            gauge = self._adapter_slot_gauges.get(name)
            if gauge is None:
                gauge = self.registry.gauge(
                    "aiko_adapter_slots",
                    "decode slots currently pinned to each loaded "
                    "adapter",
                    labels={"adapter": name})
                self._adapter_slot_gauges[name] = gauge
            gauge.set(int(slots))

    def occupancy_from_flows(self, field: str = "blocks") \
            -> Dict[str, int]:
        with self._lock:
            flows = {name: dict(entry)
                     for name, entry in self.flows.items()}
        return integrate_flows(flows, field)

    def snapshot(self) -> Dict:
        """Flight-bundle / doctor section payload."""
        with self._lock:
            flows = {name: dict(entry)
                     for name, entry in self.flows.items()}
            peak = {tier: dict(entry)
                    for tier, entry in self.peak.items()}
        return {
            "service": self.service,
            "flows": flows,
            "integrated_blocks": integrate_flows(flows, "blocks"),
            "integrated_bytes": integrate_flows(flows, "bytes"),
            "peak": peak,
            "census": self.last_census,
        }


class PoolAuditor:
    """Online pool-invariant auditor (the ``AUDITOR`` switchboard).

    Owns a :class:`PoolAccountant`; :meth:`maybe_sweep` runs from the
    engine step at ``sweep_every`` cadence, entirely host-side.  A
    sweep NEVER mutates engine state and never raises into the serve
    path — an internal error books itself as a violation instead.
    """

    def __init__(self, service: str = "", sweep_every: int = 8,
                 registry=None, max_violations: int = 64):
        self.accountant = PoolAccountant(service=service,
                                         registry=registry)
        self.registry = self.accountant.registry
        self.sweep_every = max(1, int(sweep_every))
        self.max_violations = max(1, int(max_violations))
        self.sweeps = 0
        self.violations_total = 0
        self.last_violations: List[str] = []
        self._steps = 0
        self._counter_sweeps = self.registry.counter(
            "aiko_kv_audit_sweeps_total",
            "pool audit reconciliation sweeps completed")
        self._counter_violations = self.registry.counter(
            "aiko_kv_audit_violations_total",
            "pool-accounting invariant violations found by the "
            "auditor")

    # -- accountant passthroughs (engine call sites guard the module
    #    switchboard once and talk to the auditor only) --------------------- #

    def flow(self, name: str, blocks: int, nbytes: int):
        self.accountant.flow(name, blocks, nbytes)

    def observe_census(self, census: Dict):
        """Mirror a census produced elsewhere (the ``(census)`` wire
        command) without running the invariant checks."""
        self.accountant.refresh(census)

    # -- the sweep ----------------------------------------------------------- #

    def maybe_sweep(self, server) -> Optional[List[str]]:
        """Engine-step cadence gate; returns the sweep's violation
        list when one ran, else None."""
        self._steps += 1
        if self._steps % self.sweep_every:
            return None
        return self.sweep(server)

    def sweep(self, server) -> List[str]:
        """Reconcile the pool against ground truth once.  Read-only
        over the engine; an internal failure is itself a violation
        (the auditor must never take the serve path down with it)."""
        census = None
        try:
            census = server.pool_census()
            violations = self._check(server)
        except Exception as error:  # noqa: BLE001 - stay passive
            violations = [f"sweep error: "
                          f"{type(error).__name__}: {error}"]
        self.sweeps += 1
        self._counter_sweeps.inc()
        if census is not None:
            self.accountant.refresh(census)
        if violations:
            violations = violations[:self.max_violations]
            self.violations_total += len(violations)
            self._counter_violations.inc(len(violations))
            self.last_violations = violations
            self._fire_capture(violations)
        return violations

    def _check(self, server) -> List[str]:
        violations: List[str] = []
        total = int(server.total_blocks)
        all_ids = set(range(1, total + 1))      # block 0 is scratch

        # 1. free + owned + producing partition the pool exactly.
        free_list = list(server._free)
        free_set = set(free_list)
        if len(free_set) != len(free_list):
            violations.append(
                f"free list holds {len(free_list) - len(free_set)} "
                "duplicate block id(s)")
        producing_set = set(server._producing)
        owned_set = set()
        for blocks in server._owned:
            owned_set.update(blocks)
        owned_set.update(server._block_key)
        owned_set -= producing_set
        for name_a, set_a, name_b, set_b in (
                ("free", free_set, "owned", owned_set),
                ("free", free_set, "producing", producing_set),
                ("owned", owned_set, "producing", producing_set)):
            overlap = set_a & set_b
            if overlap:
                violations.append(
                    f"{name_a}/{name_b} sets overlap on blocks "
                    f"{sorted(overlap)[:4]}")
        union = free_set | owned_set | producing_set
        if union != all_ids:
            leaked = sorted(all_ids - union)
            alien = sorted(union - all_ids)
            violations.append(
                f"pool partition broken: {len(leaked)} "
                f"unattributed block(s) {leaked[:4]}, "
                f"{len(alien)} alien id(s) {alien[:4]}")

        # 2. Refcounts match reachable readers: every owning slot
        #    holds exactly one ref; an import lease (or an in-flight
        #    restore pin) may hold one more.
        owners: Dict[int, int] = {}
        for blocks in server._owned:
            for block in blocks:
                owners[block] = owners.get(block, 0) + 1
        for block, key in server._block_key.items():
            refs = int(server._refs.get(block, 0))
            held = owners.get(block, 0)
            if not held <= refs <= held + 1:
                violations.append(
                    f"refcount skew on block {block} "
                    f"(key {key.hex()[:12]}): refs={refs} "
                    f"owners={held}")
        for key, block in server._evictable.items():
            if server._refs.get(block, 0):
                violations.append(
                    f"evictable block {block} has nonzero refs")
            if block in server._producing:
                violations.append(
                    f"evictable block {block} is producing")
            if server._index.get(key) != block:
                violations.append(
                    f"evictable key {key.hex()[:12]} not indexed "
                    f"to block {block}")
        for block, key in server._block_key.items():
            if not server._refs.get(block, 0) \
                    and block not in server._producing \
                    and key not in server._evictable:
                violations.append(
                    f"zero-ref cached block {block} missing from "
                    "the evictable LRU")

        # 3. Tier byte counters are exact sums of their entries.
        host_sum = sum(int(entry["nbytes"])
                       for entry in server._host.values())
        if host_sum != int(server.kv_host_bytes):
            violations.append(
                f"kv_host_bytes={server.kv_host_bytes} != "
                f"host entry sum {host_sum}")
        disk_sum = sum(int(meta["nbytes"])
                       for meta in server._spill.values())
        if disk_sum != int(server.kv_disk_bytes):
            violations.append(
                f"kv_disk_bytes={server.kv_disk_bytes} != "
                f"spill entry sum {disk_sum}")

        # 4. One eviction clock spans the tower: host insertion order
        #    strictly ascending (every insert stamps a fresh tick),
        #    spill order non-decreasing (adoption may carry equal
        #    clocks from a prior process), nothing past the clock.
        clock_now = int(server._evict_clock)
        previous = 0
        for key, entry in server._host.items():
            clock = int(entry.get("clock", 0))
            if clock <= previous:
                violations.append(
                    f"host tier clock not ascending at key "
                    f"{key.hex()[:12]}: {clock} after {previous}")
                break
            previous = clock
        if previous > clock_now:
            violations.append(
                f"host tier clock {previous} ahead of eviction "
                f"clock {clock_now}")
        previous = -1
        for key, meta in server._spill.items():
            clock = int(meta.get("clock", 0))
            if clock < previous:
                violations.append(
                    f"disk tier clock not monotone at key "
                    f"{key.hex()[:12]}: {clock} after {previous}")
                break
            previous = clock
        if previous > clock_now:
            violations.append(
                f"disk tier clock {previous} ahead of eviction "
                f"clock {clock_now}")

        # 5. Single residency: a chain key resolves in exactly one of
        #    index / host dict / SpillStore.
        index_keys = set(server._index)
        host_keys = set(server._host)
        disk_keys = set(server._spill)
        for name_a, set_a, name_b, set_b in (
                ("index", index_keys, "host", host_keys),
                ("index", index_keys, "disk", disk_keys),
                ("host", host_keys, "disk", disk_keys)):
            overlap = set_a & set_b
            if overlap:
                shown = [key.hex()[:12] for key in list(overlap)[:4]]
                violations.append(
                    f"double residency {name_a}/{name_b}: {shown}")

        # 6. The spill directory's files match the disk index (names
        #    only — CRC verification happens at read; invariant 13).
        spill = getattr(server, "spill", None)
        if spill is not None and spill.enabled:
            expected = {key.hex() for key in server._spill}
            on_disk = set()
            try:
                names = os.listdir(spill.root)
            except FileNotFoundError:
                names = []          # created lazily on first write
            except OSError as error:
                violations.append(f"spill dir unlistable: {error}")
                names = []
                on_disk = expected
            for name in names:
                stem, _, suffix = name.rpartition(".")
                if suffix == "kvb" and len(stem) == 64:
                    on_disk.add(stem)
            if expected != on_disk:
                missing = sorted(expected - on_disk)
                orphan = sorted(on_disk - expected)
                violations.append(
                    f"spill dir mismatch: {len(missing)} indexed "
                    f"file(s) missing {[m[:12] for m in missing[:4]]},"
                    f" {len(orphan)} orphan file(s) "
                    f"{[o[:12] for o in orphan[:4]]}")
        return violations

    def _fire_capture(self, violations: List[str]):
        # Lazy import: flight imports THIS module at top level for its
        # bundle section, so the dependency must stay one-way at
        # import time.  Never let a capture failure leak into a sweep.
        try:
            from . import flight
            if flight.FLIGHT is not None:
                flight.FLIGHT.capture(
                    "pool_audit",
                    reason=(f"pool audit: {len(violations)} "
                            f"violation(s): {violations[0]}"))
        except Exception:  # noqa: BLE001 - observability stays passive
            pass

    # -- export --------------------------------------------------------------- #

    def snapshot(self) -> Dict:
        """Flight-bundle / doctor ``census`` section."""
        out = self.accountant.snapshot()
        out.update(sweeps=self.sweeps,
                   violations_total=self.violations_total,
                   last_violations=list(self.last_violations),
                   ts=time.time())
        return out


def install(service: str = "", sweep_every: int = 8,
            auditor: Optional[PoolAuditor] = None) -> PoolAuditor:
    """Turn the auditor on (idempotent; returns the active one).
    Install BEFORE engine construction to make the flow integration
    exact from block zero — a mid-flight install still audits, but
    its flow integrals start from the install-time occupancy."""
    global AUDITOR
    if AUDITOR is None:
        AUDITOR = auditor or PoolAuditor(service=service,
                                         sweep_every=sweep_every)
    return AUDITOR


def uninstall():
    """Null the switchboard; every guarded call site goes quiet."""
    global AUDITOR
    AUDITOR = None
