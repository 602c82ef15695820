"""Deterministic fault injection for the serving stack.

The port's copy of ``aiko_services_tpu/runtime/faults.py`` (it has no
JAX in it); its imports point at the port's own modules.

The reference framework's identity is surviving partial failure, yet
failure behavior is only trustworthy when it is *provoked on demand*:
a fault injector, not hope.  This module is the single switchboard —
seeded, selectable via env or API — for every injection point wired
into the runtime:

==================  =====================================================
point               effect at the wired site
==================  =====================================================
``kill_replica``    :class:`~..orchestration.continuous.ContinuousReplica`
                    pump loop kills its own Process (LWT ``(absent)``
                    fires, the Registrar evicts every service of the
                    process, routers re-dispatch).  ``hard=1`` follows
                    with ``os._exit`` — a real OS child dies outright.
``drop_message``    :class:`~.process.Process` drops the inbound
                    transport message before it reaches any handler.
``delay_message``   ...delays it ``ms=`` milliseconds instead (wall
                    clock: a ``threading.Timer`` requeues it, so use
                    under a real engine, not the VirtualClock).
``stall_step``      :class:`~..orchestration.continuous
                    .ContinuousBatchingServer` sleeps ``ms=`` inside
                    the in-flight ring sync — a wedged device step, the
                    watchdog's quarry.
``expire_lease``    :class:`~.lease.Lease.extend` expires the lease
                    instead of extending it (EC shares, LifeCycle
                    handshakes).
``corrupt_response``  the replica mangles the response swag on the
                    wire; the client resolves the future with
                    ``error="corrupt_response"``.
``fail_spawn``      :class:`~..orchestration.autoscaler.FleetAutoscaler`
                    spawn path fails the replica launch outright (the
                    spawner is never called); the supervisor records a
                    spawn failure and retries with backoff — the
                    crash-loop/quarantine machinery's quarry.
``slow_start``      ...delays the launch ``ms=`` milliseconds instead
                    (a replica that takes forever to announce), so the
                    controller's pending-spawn accounting, not a fresh
                    spawn storm, must cover the gap.
``corrupt_disk_block``  :class:`~..kvstore.spill.SpillStore` flips one
                    payload byte as it writes the block: the header
                    stays valid (a warm restart re-adopts the file)
                    but the per-field CRC trips at read — the chain
                    must degrade to recompute, never serve the bytes.
``disk_full``       ...fails the block-group write with ``ENOSPC``;
                    the spill tier disables itself and the cache
                    degrades to two-tier behaviour, serving unstalled.
``slow_disk``       ...sleeps ``ms=`` milliseconds inside the spill
                    write/read path — a saturated or dying device; the
                    admission walk must keep deferring, not block.
``leak_block``      :class:`~..orchestration.paged
                    .PagedContinuousServer` pops one block off the
                    free list with NO owner registered — a classic
                    pool leak.  Serving is untouched (the block just
                    goes missing); the pool auditor's partition check
                    must catch it within one sweep.
``skew_refcount``   ...bumps one cached block's refcount by ``by=``
                    (default 2) without a matching owner — the
                    use-after-free precursor.  Again invisible to
                    serving; the auditor's reachable-readers check
                    is what must trip.
``drop_migration_block``  the SOURCE replica drops the last block out
                    of the exported KV payload during a migration
                    transfer — the destination's import comes up
                    short and its resume recomputes the missing tail:
                    the migration still completes bit-exact, just
                    colder (zero lost tokens either way).
``stall_cutover``   ...sleeps ``ms=`` milliseconds inside the cutover
                    phase, between the destination resume dispatch
                    and the source cancel — the double-delivery
                    window the router's token-offset dedup must
                    absorb without a duplicate.
``kill_source_mid_migration``  the SOURCE replica kills its own
                    Process while a migration it serves is in flight
                    (same LWT path as ``kill_replica``) — the router
                    must promote the destination if the cutover was
                    dispatched, else fall back to plain redispatch.
==================  =====================================================

Zero-cost when disabled: every site guards with ``if faults.PLAN is
not None`` — one module-attribute load and an identity test, nothing
else — and NO fault code exists in the port's model or kernel modules
(asserted by the AST guards in ``tests/test_torch_runtime.py``).

Selection: rules are ``nth=`` (fire on exactly the nth matching call —
fully deterministic) or ``prob=`` (seeded RNG per call), optionally
``match=`` (substring of the site's context key: a topic, a replica
name, a payload head).  Env spec, parsed at import::

    AIKO_FAULTS="seed=7;kill_replica:nth=5:hard=1;drop_message:prob=0.05:match=infer_partial;stall_step:nth=3:ms=80"

API::

    plan = FaultPlan(seed=7).add("stall_step", nth=3, ms=80)
    faults.install(plan)
    try: ...
    finally: faults.uninstall()

``plan.fired`` logs every firing ``(point, key, rule)`` so a chaos
harness can assert counters match the faults actually injected.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, List, Optional

__all__ = ["FaultPlan", "FAULT_POINTS", "PLAN", "install", "uninstall",
           "plan_from_spec"]

FAULT_POINTS = ("kill_replica", "drop_message", "delay_message",
                "stall_step", "expire_lease", "corrupt_response",
                "fail_spawn", "slow_start", "corrupt_disk_block",
                "disk_full", "slow_disk", "leak_block",
                "skew_refcount", "drop_migration_block",
                "stall_cutover", "kill_source_mid_migration")


@dataclasses.dataclass
class _Rule:
    point: str
    nth: Optional[int] = None    # fire on the nth matching call (1-based)
    prob: float = 0.0            # else: fire with this probability
    match: str = ""              # substring the site key must contain
    params: Dict = dataclasses.field(default_factory=dict)
    seen: int = 0                # matching calls observed
    fires: int = 0               # times actually fired

    def describe(self) -> str:
        how = f"nth={self.nth}" if self.nth is not None \
            else f"prob={self.prob}"
        match = f":match={self.match}" if self.match else ""
        return f"{self.point}:{how}{match}"


class FaultPlan:
    """A seeded set of fault rules.  Deterministic: the same seed and
    the same sequence of ``check`` calls fire the same faults."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._rules: List[_Rule] = []
        #: firing log: (point, site key, rule description).
        self.fired: List[tuple] = []

    def add(self, point: str, nth: Optional[int] = None,
            prob: float = 0.0, match: str = "",
            **params) -> "FaultPlan":
        """Register a rule; chainable.  ``params`` ride to the site
        (``ms=`` for delays/stalls, ``hard=1`` for the kill point)."""
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}; "
                             f"known: {FAULT_POINTS}")
        if nth is None and prob <= 0.0:
            raise ValueError(f"rule {point!r} needs nth= or prob=")
        self._rules.append(_Rule(point, nth=nth, prob=float(prob),
                                 match=str(match), params=dict(params)))
        return self

    def check(self, point: str, key: str = "") -> Optional[Dict]:
        """Called from an injection site (ONLY behind the
        ``PLAN is not None`` guard).  Returns the firing rule's params
        dict, or None.  Rules evaluate in registration order; the
        first to fire wins that call."""
        for rule in self._rules:
            if rule.point != point:
                continue
            if rule.match and rule.match not in key:
                continue
            rule.seen += 1
            if rule.nth is not None:
                fire = rule.seen == rule.nth
            else:
                fire = self._rng.random() < rule.prob
            if fire:
                rule.fires += 1
                self.fired.append((point, key, rule.describe()))
                # A firing fault is exactly the moment forensics are
                # cheap and valuable: snapshot the process around it.
                # Lazy import keeps the fault layer import-light; the
                # recorder rate-limits, so a prob= storm cannot turn
                # this into an IO hazard.
                from ..obs import flight
                if flight.FLIGHT is not None:
                    flight.FLIGHT.capture(
                        "fault", reason=f"{rule.describe()} key={key}")
                return dict(rule.params)
        return None

    def fires(self, point: str) -> int:
        """Total firings of a point (chaos harness assertions)."""
        return sum(rule.fires for rule in self._rules
                   if rule.point == point)

    def __repr__(self):
        rules = ", ".join(r.describe() for r in self._rules)
        return f"FaultPlan(seed={self.seed}, [{rules}])"


def _coerce(value: str):
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            continue
    return value


def plan_from_spec(spec: str) -> FaultPlan:
    """Parse the ``AIKO_FAULTS`` clause syntax (module docstring)."""
    clauses = [c.strip() for c in spec.split(";") if c.strip()]
    seed = 0
    if clauses and clauses[0].startswith("seed="):
        seed = int(clauses.pop(0).split("=", 1)[1])
    plan = FaultPlan(seed=seed)
    for clause in clauses:
        parts = clause.split(":")
        point, options = parts[0], parts[1:]
        kwargs: Dict = {}
        for option in options:
            if "=" not in option:
                raise ValueError(f"bad fault option {option!r} in "
                                 f"{clause!r} (want key=value)")
            key, value = option.split("=", 1)
            kwargs[key] = _coerce(value)
        rule_kwargs = {k: kwargs.pop(k) for k in ("nth", "prob", "match")
                      if k in kwargs}
        plan.add(point, **rule_kwargs, **kwargs)
    return plan


#: The active plan — None means faults disabled, and every injection
#: site reduces to one attribute load + identity test (the zero-cost
#: guard the AST tests pin down).
PLAN: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    global PLAN
    PLAN = plan
    return plan


def uninstall() -> None:
    global PLAN
    PLAN = None


# Env bootstrap: a chaos child process (tests/child_replica.py under
# loadgen --chaos or the cross-process failover test) selects its
# faults purely through AIKO_FAULTS — no code changes, no RPC.
_spec = os.environ.get("AIKO_FAULTS")
if _spec:
    install(plan_from_spec(_spec))
del _spec
