"""SLO-driven fleet autoscaler: self-healing, scale-out, graceful drain.

The port's copy of ``aiko_services_tpu/orchestration/autoscaler.py`` (it
has no JAX in it); its imports point at the port's own modules.  One
difference: the SLO-breach flight capture names steady-state captures
from the replicas' own ``graph_captures_steady_state`` telemetry, summed
over the fleet, where the JAX package reads its process-wide compile
ledger (the port keeps one capture ledger per engine).

Closes the loop that every prior serving PR left open: the router
publishes ``shed``/``redispatches``/``fleet_ttft_p95_ms``, replicas
publish ``queue_depth``/``healthy``/``lifecycle`` — and a human picks
the replica count.  :class:`FleetAutoscaler` is the supervisor actor
that converts that EC-share telemetry into spawn/drain decisions
against an SLO target (DistServe's *goodput* framing: requests served
WITHIN the TTFT SLO per replica, not raw throughput):

* **Self-healing** — a dead or permanently-unhealthy replica (Registrar
  LWT eviction, watchdog ``healthy=false``) is respawned into the same
  logical *slot*, with per-slot exponential backoff; a slot that dies
  ``crash_loop_threshold`` times inside ``crash_loop_window_s`` is
  **quarantined** instead of hot-looped (effective capacity drops — a
  crash-looper replaced by a fresh crash-looper is the loop, not a
  fix; ``(clear_quarantine slot)`` is the operator override).
* **Scale out** — TTFT p95 over the SLO or a non-zero shed rate for
  ``breach_windows`` consecutive ticks raises the target (hysteresis),
  never more than once per ``cooldown_s`` (burst damping).
* **Scale in** — after ``clear_windows`` healthy ticks with an idle
  queue, the idlest replica gets ``(retire)``: the router stops
  routing to it immediately (ARCHITECTURE invariant 8), its in-flight
  work finishes in place (or re-dispatches if it dies mid-drain), it
  advertises ``drained 1``, and only then is the process stopped
  through the escalating kill ladder.  Zero lost requests, chaos-gated
  (``tools/loadgen.run_elastic_chaos``).

In the disaggregated prefill/decode mode the controller holds separate
targets per role and rebalances the ratio: TTFT breaches grow the
``prefill`` pool (admission latency lives there), shed breaches grow
``decode``.

The decision core is :func:`decide` — a PURE function of a
:class:`FleetSnapshot` + :class:`AutoscalerPolicy` + controller state,
no clock, no RNG, no I/O — so scaling behavior is unit-testable and a
production incident replays from logged snapshots.  The actor is a
thin shell: build snapshot → ``decide`` → execute actions.

Fault points ``fail_spawn`` and ``slow_start`` (``runtime/faults.py``)
are wired into the spawn path behind the standard zero-cost
``PLAN is not None`` guard, so chaos schedules can fail or delay
replacements while a drain is in flight.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import flight
from ..obs.metrics import CounterDict
from ..registry.services_cache import services_cache_create_singleton
from ..runtime import faults
from ..runtime.actor import Actor
from ..runtime.service import ServiceFilter
from ..utils.sexpr import generate, parse

__all__ = [
    "AUTOSCALER_PROTOCOL", "AutoscalerPolicy", "ReplicaView",
    "PendingView", "DeathEvent", "FleetSnapshot", "Action",
    "ControllerState", "decide", "FleetAutoscaler",
    "manager_spawner", "manager_terminator",
]

AUTOSCALER_PROTOCOL = "autoscaler:0"

#: Role names the controller balances independently in disaggregated
#: mode.  ``decode`` is the default role for every adopted replica.
ROLES = ("decode", "prefill")


# ------------------------------------------------------------------ #
# Telemetry snapshot (decide()'s entire world)
# ------------------------------------------------------------------ #

@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """One announced replica as the controller sees it this tick."""
    slot: str
    role: str = "decode"
    healthy: bool = True
    retiring: bool = False
    drained: bool = False
    queue_depth: int = 0
    slots_active: int = 0
    deadline_exceeded: int = 0
    #: chips this replica occupies (TP=k replica = k chips in the
    #: capacity ledger; 1 = the single-chip replica).
    tp_degree: int = 1


@dataclasses.dataclass(frozen=True)
class PendingView:
    """A spawn in flight: initiated, not yet announced.  ``due`` is
    the announce deadline; past it the actor reports a spawn
    failure."""
    slot: str
    role: str = "decode"
    due: float = 0.0


@dataclasses.dataclass(frozen=True)
class DeathEvent:
    """A replica (or spawn attempt) that went away since the previous
    tick.  ``expected=True`` marks a drain-completion termination the
    controller itself ordered — bookkeeping, not a crash."""
    slot: str
    ts: float
    exit_code: Optional[int] = None
    spawn_failure: bool = False
    expected: bool = False


@dataclasses.dataclass(frozen=True)
class FleetSnapshot:
    """Everything :func:`decide` may look at.  ``now`` is the only
    clock; deltas are since the previous decide call."""
    now: float
    replicas: Tuple[ReplicaView, ...] = ()
    pending: Tuple[PendingView, ...] = ()
    deaths: Tuple[DeathEvent, ...] = ()
    ttft_p95_ms: Optional[float] = None
    shed_delta: int = 0
    redispatch_delta: int = 0


@dataclasses.dataclass
class AutoscalerPolicy:
    """SLO target + scaling discipline.  Windows are DECIDE TICKS
    (the actor calls decide once per ``tick_s``)."""
    ttft_slo_ms: float = 500.0
    #: sheds per tick tolerated before the tick counts as a breach.
    shed_tolerance: int = 0
    min_replicas: int = 1
    max_replicas: int = 8
    #: initial decode target (adopted replicas can exceed it).
    target: int = 1
    #: dedicated prefill replicas (0 = aggregated mode).
    prefill_target: int = 0
    prefill_min: int = 0
    prefill_max: int = 4
    #: consecutive breach ticks before scaling out (hysteresis).
    breach_windows: int = 3
    #: consecutive clear ticks before scaling in.
    clear_windows: int = 6
    #: total queued requests at or under this allow scale-in.
    scale_in_max_queue: int = 0
    #: minimum seconds between scale-target changes.
    cooldown_s: float = 10.0
    #: a spawn that has not announced by then counts as failed.
    spawn_timeout_s: float = 30.0
    #: a drain that has not reported ``drained`` by then is stopped
    #: anyway (the kill ladder + router re-dispatch cover stragglers).
    drain_timeout_s: float = 30.0
    #: per-slot respawn backoff: ``base * 2^(deaths-1)`` capped.
    backoff_base_s: float = 0.5
    backoff_cap_s: float = 30.0
    crash_loop_threshold: int = 3
    crash_loop_window_s: float = 60.0
    quarantine_s: float = 300.0

    #: Per-role TP degree for spawned replicas (the DistServe
    #: argument: prefill is compute-bound and wants wide TP, decode is
    #: memory-bandwidth-bound and wants narrow TP × more replicas).
    #: The spawner builds ``ReplicaMesh(tp=role_tp(role))``; cross-
    #: degree KV transfer between the roles is exact (the pool's host
    #: view is degree-agnostic, tested in test_kvstore).
    decode_tp: int = 1
    #: 0 = same as ``decode_tp`` (homogeneous fleet, the default).
    prefill_tp: int = 0

    #: Drain-free scale-in: emit ``migrate`` instead of ``drain`` for
    #: surplus capacity.  The executor live-migrates the victim's
    #: in-flight population to the rest of the fleet before retiring
    #: it, so scale-in (and resharding, below) opens no goodput hole
    #: waiting for long-tail requests to finish on a retiring replica.
    migrate_drains: bool = False
    #: In-place TP resharding: when a live replica's chip weight no
    #: longer matches ``role_tp(role)`` (the operator changed
    #: ``decode_tp``/``prefill_tp`` under a running fleet), spawn a
    #: replacement at the new degree and migrate the old-degree
    #: replica out — one replacement in flight at a time per role.
    #: Requires ``migrate_drains`` to be drain-free end to end.
    reshard_tp: bool = False

    def role_tp(self, role: str) -> int:
        if role == "prefill" and self.prefill_tp:
            return int(self.prefill_tp)
        return max(1, int(self.decode_tp))

    def role_bounds(self, role: str) -> Tuple[int, int]:
        if role == "prefill":
            return self.prefill_min, self.prefill_max
        return self.min_replicas, self.max_replicas

    def initial_targets(self) -> Dict[str, int]:
        targets = {"decode": int(self.target)}
        if self.prefill_target > 0:
            targets["prefill"] = int(self.prefill_target)
        return targets


# ------------------------------------------------------------------ #
# Controller state & actions
# ------------------------------------------------------------------ #

@dataclasses.dataclass
class ControllerState:
    """Persistent memory between decide calls.  decide() never mutates
    its input — it returns a fresh copy — so a snapshot sequence
    replays identically (the purity the unit tests pin)."""
    targets: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: slot -> role, every slot the controller owns (live, pending,
    #: backing off or draining — NOT quarantined-forgotten).
    slots: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: slot -> recent unexpected-death timestamps (pruned to window).
    deaths: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)
    #: slot -> do-not-respawn-before timestamp.
    backoff_until: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    #: slot -> quarantine release timestamp.
    quarantined: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    #: slot -> chip weight (TP degree) last seen in telemetry — kept
    #: here so a draining or dead TP=4 replica still counts as 4
    #: chips in the ledger after its telemetry stops.
    chips: Dict[str, int] = dataclasses.field(default_factory=dict)
    breach_streak: int = 0
    clear_streak: int = 0
    last_scale_ts: Optional[float] = None
    spawn_seq: int = 0

    def copy(self) -> "ControllerState":
        return ControllerState(
            targets=dict(self.targets),
            slots=dict(self.slots),
            deaths={slot: list(ts) for slot, ts in self.deaths.items()},
            backoff_until=dict(self.backoff_until),
            quarantined=dict(self.quarantined),
            chips=dict(self.chips),
            breach_streak=self.breach_streak,
            clear_streak=self.clear_streak,
            last_scale_ts=self.last_scale_ts,
            spawn_seq=self.spawn_seq)


@dataclasses.dataclass(frozen=True)
class Action:
    """One controller decision.  ``spawn`` (new slot or respawn into
    an existing one), ``drain`` (begin graceful retire), ``migrate``
    (drain-free retire: live-migrate the in-flight population to the
    rest of the fleet — or to ``dest`` — THEN retire), ``quarantine``
    (stop respawning a crash-looper)."""
    kind: str
    slot: str
    role: str = "decode"
    reason: str = ""
    #: chips the spawned replica should occupy (``spawn`` only):
    #: the policy's per-role TP degree, for the spawner to build the
    #: matching ReplicaMesh.
    tp_degree: int = 1
    #: migration destination SLOT (``migrate`` only; empty = let the
    #: router pick a destination per request).
    dest: str = ""

    def describe(self) -> str:
        return f"{self.kind}:{self.slot}" + \
            (f"->{self.dest}" if self.dest else "") + \
            (f" ({self.reason})" if self.reason else "")


# ------------------------------------------------------------------ #
# The pure decision function
# ------------------------------------------------------------------ #

def _scale_out_role(policy: AutoscalerPolicy, ttft_breach: bool) -> str:
    """Breach attribution in disaggregated mode: admission latency
    (TTFT) lives in the prefill pool, saturation sheds in decode."""
    if policy.prefill_target > 0 and ttft_breach:
        return "prefill"
    return "decode"


def decide(snapshot: FleetSnapshot, policy: AutoscalerPolicy,
           state: Optional[ControllerState] = None
           ) -> Tuple[List[Action], ControllerState]:
    """Pure scaling decision: ``(actions, next_state)`` from a
    telemetry snapshot.  No clock (``snapshot.now`` is the time), no
    RNG, no I/O — identical snapshot sequences yield identical action
    sequences, which is what makes fleet behavior testable and a
    production trace replayable."""
    state = state.copy() if state is not None else ControllerState()
    if not state.targets:
        state.targets = policy.initial_targets()
    now = snapshot.now
    actions: List[Action] = []

    # -- adopt replicas spawned outside this controller ------------- #
    for view in snapshot.replicas:
        state.slots.setdefault(view.slot, view.role)
        state.chips[view.slot] = max(1, int(view.tp_degree))

    # -- ingest deaths ---------------------------------------------- #
    for death in snapshot.deaths:
        if death.expected:
            # Drain completion: the slot's story ends cleanly.
            state.slots.pop(death.slot, None)
            state.deaths.pop(death.slot, None)
            state.backoff_until.pop(death.slot, None)
            state.chips.pop(death.slot, None)
            continue
        history = state.deaths.setdefault(death.slot, [])
        history.append(death.ts)
        history[:] = [ts for ts in history
                      if ts > death.ts - policy.crash_loop_window_s]
        if len(history) >= policy.crash_loop_threshold:
            if death.slot not in state.quarantined:
                state.quarantined[death.slot] = \
                    death.ts + policy.quarantine_s
                actions.append(Action(
                    "quarantine", death.slot,
                    role=state.slots.get(death.slot, "decode"),
                    reason=f"{len(history)} deaths in "
                           f"{policy.crash_loop_window_s:g}s"
                           + (f", exit={death.exit_code}"
                              if death.exit_code is not None else "")))
        else:
            delay = min(policy.backoff_cap_s,
                        policy.backoff_base_s
                        * (2 ** (len(history) - 1)))
            state.backoff_until[death.slot] = death.ts + delay

    # -- release expired quarantines -------------------------------- #
    for slot, release in list(state.quarantined.items()):
        if now >= release:
            state.quarantined.pop(slot)
            state.deaths.pop(slot, None)

    # -- SLO window accounting --------------------------------------- #
    ttft_breach = (snapshot.ttft_p95_ms is not None
                   and snapshot.ttft_p95_ms > policy.ttft_slo_ms)
    shed_breach = snapshot.shed_delta > policy.shed_tolerance
    if ttft_breach or shed_breach:
        state.breach_streak += 1
        state.clear_streak = 0
    else:
        state.clear_streak += 1
        state.breach_streak = 0

    cooled = (state.last_scale_ts is None
              or now - state.last_scale_ts >= policy.cooldown_s)
    total_queue = sum(v.queue_depth for v in snapshot.replicas)

    # -- scale out ---------------------------------------------------- #
    if state.breach_streak >= policy.breach_windows and cooled:
        role = _scale_out_role(policy, ttft_breach)
        _, cap = policy.role_bounds(role)
        if state.targets.get(role, 0) < cap:
            state.targets[role] = state.targets.get(role, 0) + 1
            state.last_scale_ts = now
            state.breach_streak = 0
            cooled = False

    # -- scale in ----------------------------------------------------- #
    elif (state.clear_streak >= policy.clear_windows and cooled
          and not snapshot.pending
          and total_queue <= policy.scale_in_max_queue):
        # Shrink the role with the most headroom above its floor
        # (deterministic tie-break by role name).
        candidates = [(state.targets[role] - policy.role_bounds(role)[0],
                       role) for role in sorted(state.targets)
                      if state.targets[role]
                      > policy.role_bounds(role)[0]]
        if candidates:
            _, role = max(candidates)
            state.targets[role] -= 1
            state.last_scale_ts = now
            state.clear_streak = 0

    # -- reconcile slots against targets ------------------------------ #
    # Capacity ledger per role: ``owned`` is every slot the controller
    # answers for — live, pending, draining, down-awaiting-respawn,
    # even quarantined.  Quarantined slots COUNT as capacity on
    # purpose: backfilling a crash-looper with a fresh slot that will
    # crash-loop in turn is the hot loop with extra steps, so a
    # quarantine deliberately shrinks the effective fleet until the
    # operator intervenes (or the quarantine expires).  Draining slots
    # are capacity on the way OUT, so the eventual fleet size is
    # ``owned − draining`` — that is what reconciles to the target.
    alive = {v.slot: v for v in snapshot.replicas}
    pending = {p.slot for p in snapshot.pending}
    for role in sorted(state.targets):
        target = state.targets[role]
        owned = [slot for slot, slot_role in sorted(state.slots.items())
                 if slot_role == role]
        live = [slot for slot in owned if slot in alive
                and not alive[slot].retiring]
        draining = [slot for slot in owned if slot in alive
                    and alive[slot].retiring]
        down = [slot for slot in owned
                if slot not in alive and slot not in pending
                and slot not in state.quarantined]
        quarantined = [slot for slot in owned
                       if slot in state.quarantined]
        # The ledger counts CHIPS, not replicas: a TP=k replica is k
        # chips of capacity, so targets reconcile in chip units.  With
        # every weight 1 (the TP=1 fleet) this is exactly the old
        # replica count.
        weight = lambda slot: state.chips.get(slot, 1)
        eventual = sum(weight(slot) for slot in owned) \
            - sum(weight(slot) for slot in draining)

        # Shrinking with dead surplus: forget down slots outright —
        # respawning capacity the target no longer wants just to
        # drain it again is churn.
        while down and eventual > target:
            slot = down.pop()
            state.slots.pop(slot, None)
            state.backoff_until.pop(slot, None)
            state.deaths.pop(slot, None)
            eventual -= weight(slot)
            state.chips.pop(slot, None)

        # Self-healing: respawn dead owned slots once backoff expires.
        for slot in down:
            if now >= state.backoff_until.get(slot, 0.0):
                actions.append(Action("spawn", slot, role=role,
                                      reason="replace",
                                      tp_degree=policy.role_tp(role)))
                state.chips[slot] = policy.role_tp(role)

        # New capacity up to the target, counted in CHIPS: a policy
        # with role_tp(role) = k closes a k-chip gap with ONE spawn
        # (with every degree 1 this is exactly the old replica loop).
        # The sequence number skips names already owned — adopted
        # replicas may squat on them.
        while eventual < target:
            state.spawn_seq += 1
            slot = f"{role}{state.spawn_seq}"
            while slot in state.slots or slot in state.quarantined:
                state.spawn_seq += 1
                slot = f"{role}{state.spawn_seq}"
            state.slots[slot] = role
            actions.append(Action("spawn", slot, role=role,
                                  reason="scale_out",
                                  tp_degree=policy.role_tp(role)))
            state.chips[slot] = policy.role_tp(role)
            eventual += policy.role_tp(role)

        # Surplus: drain the idlest live replica.  One per tick per
        # role — drains are deliberate, not avalanches.  A
        # quarantined slot pads the ledger against backfill but is NOT
        # serving capacity: it must never get a healthy replica
        # drained on its behalf.  Surplus is measured in chips; prefer
        # a replica that FITS the surplus (draining a TP=4 replica to
        # shed one chip of excess overshoots by three), falling back
        # to any live replica when none fits.
        surplus = eventual - sum(weight(s) for s in quarantined) \
            - target
        if surplus > 0 and live:
            fitting = [slot for slot in live
                       if weight(slot) <= surplus] or live
            # Under resharding, surplus exists BECAUSE a new-degree
            # replacement came up: evict mismatched-degree replicas
            # first so the fleet converges on the policy degree.
            idlest = min(fitting, key=lambda slot: (
                (weight(slot) == policy.role_tp(role))
                if policy.reshard_tp else False,
                alive[slot].queue_depth, alive[slot].slots_active,
                slot))
            kind = "migrate" if policy.migrate_drains else "drain"
            actions.append(Action(kind, idlest, role=role,
                                  reason="scale_in"))

        # In-place TP resharding: with the fleet stable at target and
        # nothing pending, replace ONE mismatched-degree live replica
        # per tick by spawning its new-degree successor.  The spawn
        # overshoots the chip target; next tick's surplus branch
        # (migrate, per the mismatched-first victim preference above)
        # evicts old-degree capacity until the ledger re-balances —
        # repeat until every replica matches ``role_tp(role)``.
        elif (policy.reshard_tp and surplus == 0 and live
              and not pending):
            mismatched = [slot for slot in live
                          if weight(slot) != policy.role_tp(role)]
            if mismatched:
                state.spawn_seq += 1
                slot = f"{role}{state.spawn_seq}"
                while slot in state.slots or slot in state.quarantined:
                    state.spawn_seq += 1
                    slot = f"{role}{state.spawn_seq}"
                state.slots[slot] = role
                actions.append(Action(
                    "spawn", slot, role=role,
                    reason=f"reshard:{sorted(mismatched)[0]}",
                    tp_degree=policy.role_tp(role)))
                state.chips[slot] = policy.role_tp(role)

    return actions, state


# ------------------------------------------------------------------ #
# ProcessManager adapters
# ------------------------------------------------------------------ #

def manager_spawner(manager, command: str,
                    argv_fn: Optional[Callable] = None,
                    env_fn: Optional[Callable] = None) -> Callable:
    """Spawner backed by :class:`~.process_manager.ProcessManager`:
    ``spawn(slot, role)`` launches ``command`` with
    ``argv_fn(slot, role)`` arguments and ``env_fn(slot, role)`` env.
    Wire ``manager.exit_handler`` to
    :meth:`FleetAutoscaler.note_exit` so exit codes reach the
    crash-loop detector."""
    def spawn(slot: str, role: str) -> None:
        arguments = list(argv_fn(slot, role)) if argv_fn else []
        env = env_fn(slot, role) if env_fn else None
        manager.create(slot, command, arguments, env=env)
    return spawn


def manager_terminator(manager, grace: float = 5.0,
                       wait: float = 5.0) -> Callable:
    """Terminator riding the escalating kill ladder
    (terminate → grace → kill)."""
    def terminate(slot: str, mode: str = "drain_complete") -> None:
        manager.delete(slot, grace=grace, wait=wait)
    return terminate


# ------------------------------------------------------------------ #
# The supervisor actor
# ------------------------------------------------------------------ #

class FleetAutoscaler(Actor):
    """Supervisor actor around :func:`decide`.

    ``spawner(slot, role)`` must (eventually) produce a replica actor
    whose NAME is ``slot`` — that name is how announcements map back
    to logical slots; ``terminator(slot, mode)`` must stop it
    (``mode`` is ``drain_complete``, ``drain_timeout`` or
    ``replace``).  Both default to no-ops so a telemetry-only
    autoscaler can run in observe mode.

    Operator commands: ``(scale_target N)`` / ``(scale_target role N)``
    pins a role's target; ``(clear_quarantine slot)`` lifts a
    quarantine and resets the slot's death history;
    ``(rolling_upgrade)`` / ``(rolling_upgrade role)`` replaces every
    live replica one at a time with the in-flight population
    live-migrated across (zero-downtime weight/version upgrade)."""

    def __init__(self, context, process=None,
                 spawner: Optional[Callable] = None,
                 terminator: Optional[Callable] = None,
                 policy: Optional[AutoscalerPolicy] = None,
                 replica_protocol: Optional[str] = None,
                 router_protocol: Optional[str] = None,
                 tick_s: float = 0.5):
        from .serving import REPLICA_PROTOCOL, ROUTER_PROTOCOL
        context.protocol = context.protocol or AUTOSCALER_PROTOCOL
        super().__init__(context, process)
        self.policy = policy or AutoscalerPolicy()
        self.tick_s = float(tick_s)
        self._spawner = spawner or (lambda slot, role: None)
        self._terminator = terminator or (lambda slot, mode: None)
        self.state = ControllerState(
            targets=self.policy.initial_targets())
        self._command_handlers["scale_target"] = self._wire_scale_target
        self._command_handlers["clear_quarantine"] = \
            self._wire_clear_quarantine
        self._command_handlers["rolling_upgrade"] = \
            self._wire_rolling_upgrade

        #: rolling upgrade: sources awaiting replacement, FIFO.
        self._upgrade_queue: List[str] = []
        #: replacement slot -> source slot it supersedes.
        self._upgrade_pairs: Dict[str, str] = {}
        self._upgrade_seq = 0

        #: slot -> latest telemetry parsed off the replica state topic.
        self._telemetry: Dict[str, Dict] = {}
        #: slot -> topic path (announced replicas).
        self._topics: Dict[str, str] = {}
        #: slot -> PendingView (spawn initiated, not announced).
        self._pending: Dict[str, PendingView] = {}
        #: slot -> drain deadline (retire sent, terminator not yet).
        self._draining: Dict[str, float] = {}
        #: slots we terminated on purpose (their removal is expected).
        self._expected_down: set = set()
        #: slots whose exit already reached note_exit (skip the
        #: duplicate death the services-cache removal would add).
        self._exit_noted: set = set()
        #: slot -> last exit code from the process supervisor.
        self._exit_codes: Dict[str, Optional[int]] = {}
        self._deaths: List[DeathEvent] = []
        self._router_topic: Optional[str] = None
        self._router_stats: Dict[str, float] = {}
        self._last_shed = 0.0
        self._last_redispatch = 0.0
        self._last_tick: Optional[float] = None

        self.counters: Dict[str, int] = CounterDict(dict(
            spawns=0, respawns=0, spawn_failures=0, slow_starts=0,
            drains=0, drain_completed=0, drain_timeouts=0,
            migrates=0, upgrades_started=0, upgrades_completed=0,
            scale_out=0, scale_in=0, quarantines=0,
            deaths_observed=0),
            prefix="autoscaler", labels={"actor": self.name})
        self.share.update(self.counters)
        self.share["replicas_live"] = 0
        self.share["replicas_pending"] = 0
        self.share["replicas_draining"] = 0
        self.share["quarantine"] = ""
        self.share["last_action"] = ""
        self.share["slo_headroom_ms"] = ""
        #: ∫ live-replica count dt — the denominator of
        #: goodput-per-replica (loadgen reads this).
        self.share["replica_seconds"] = 0.0
        for role, target in self.state.targets.items():
            self.share[f"target_{role}"] = target

        self._cache = services_cache_create_singleton(self.process)
        self._cache.add_handler(
            ServiceFilter(protocol=replica_protocol or REPLICA_PROTOCOL),
            self._replica_added, self._replica_removed)
        self._cache.add_handler(
            ServiceFilter(protocol=router_protocol or ROUTER_PROTOCOL),
            self._router_added, self._router_removed)
        self.process.event.add_timer_handler(self._tick, self.tick_s)

    # -- membership --------------------------------------------------- #

    def _replica_added(self, fields):
        slot = fields.name
        self._topics[slot] = fields.topic_path
        self._pending.pop(slot, None)
        self._exit_noted.discard(slot)
        self._telemetry.setdefault(slot, {})
        self.process.add_message_handler(
            self._replica_state, f"{fields.topic_path}/state")
        self.logger.info("%s: replica %s announced (%s)", self.name,
                         slot, fields.topic_path)
        source = self._upgrade_pairs.pop(slot, None)
        if source is not None:
            self._complete_upgrade(source, slot)

    def _replica_removed(self, fields):
        slot = fields.name
        if self._topics.pop(slot, None) is None:
            return
        self.process.remove_message_handler(
            self._replica_state, f"{fields.topic_path}/state")
        self._telemetry.pop(slot, None)
        # A replica killed while it was DRAINING is an expected death:
        # the controller already decided it goes away, the router
        # re-dispatches whatever was in flight — do not respawn it.
        expected = (slot in self._expected_down
                    or self._draining.pop(slot, None) is not None)
        self._expected_down.discard(slot)
        if slot in self._exit_noted:
            # note_exit already queued this death with its exit code.
            self._exit_noted.discard(slot)
            return
        self._note_death(slot, expected=expected,
                         exit_code=self._exit_codes.pop(slot, None))

    def _router_added(self, fields):
        if self._router_topic is not None:
            return
        self._router_topic = fields.topic_path
        self.process.add_message_handler(
            self._router_state, f"{fields.topic_path}/state")

    def _router_removed(self, fields):
        if self._router_topic != fields.topic_path:
            return
        self.process.remove_message_handler(
            self._router_state, f"{fields.topic_path}/state")
        self._router_topic = None

    # -- telemetry ----------------------------------------------------- #

    def _replica_state(self, topic: str, payload: str):
        try:
            command, params = parse(payload)
        except Exception:  # noqa: BLE001 - junk broadcast, skip
            return
        if command not in ("update", "add") or len(params) < 2:
            return
        replica_topic = topic[:-len("/state")]
        slot = next((s for s, t in self._topics.items()
                     if t == replica_topic), None)
        if slot is None:
            return
        key, value = str(params[0]), params[1]
        telemetry = self._telemetry.setdefault(slot, {})
        if key in ("queue_depth", "slots_active", "deadline_exceeded",
                   "drained", "tp_degree", "graph_captures_steady_state"):
            try:
                telemetry[key] = int(value)
            except (TypeError, ValueError):
                pass
        elif key == "healthy":
            telemetry["healthy"] = str(value) not in ("0", "False")
        elif key == "lifecycle":
            telemetry["lifecycle"] = str(value)
        elif key == "ttft_p95_ms":
            try:
                telemetry["ttft_p95_ms"] = float(value)
            except (TypeError, ValueError):
                pass

    def _router_state(self, _topic: str, payload: str):
        try:
            command, params = parse(payload)
        except Exception:  # noqa: BLE001 - junk broadcast, skip
            return
        if command not in ("update", "add") or len(params) < 2:
            return
        key, value = str(params[0]), params[1]
        if key in ("shed", "redispatches", "fleet_ttft_p95_ms"):
            try:
                self._router_stats[key] = float(value)
            except (TypeError, ValueError):
                pass

    # -- death funnel -------------------------------------------------- #

    def note_exit(self, slot, _command=None,
                  exit_code: Optional[int] = None) -> None:
        """Process-supervisor exit funnel — wire as
        ``ProcessManager(exit_handler=autoscaler.note_exit)``.
        ``exit_code is None`` means the spawn itself failed.  Exit
        codes feed the crash-loop detector; a child that dies before
        it ever announces (instant crash) is caught HERE, not by the
        spawn timeout."""
        slot = str(slot)
        self._exit_codes[slot] = exit_code
        if slot in self._pending:
            self._pending.pop(slot, None)
            self._note_death(slot, exit_code=exit_code,
                             spawn_failure=exit_code is None)
            return
        if slot in self._topics:
            # Announced and died: the cache removal is coming — note
            # the code now, skip the duplicate event later.  Dying
            # mid-drain counts as expected (drain completed abruptly).
            expected = (slot in self._expected_down
                        or self._draining.pop(slot, None) is not None)
            self._expected_down.discard(slot)
            self._exit_noted.add(slot)
            self._note_death(slot, expected=expected,
                             exit_code=exit_code)

    def _note_death(self, slot: str, expected: bool = False,
                    exit_code: Optional[int] = None,
                    spawn_failure: bool = False) -> None:
        self._deaths.append(DeathEvent(
            slot=slot, ts=self.process.event.now(),
            exit_code=exit_code, spawn_failure=spawn_failure,
            expected=expected))
        if not expected:
            self._bump("deaths_observed")
            self.logger.warning(
                "%s: replica %s died (exit=%s%s)", self.name, slot,
                exit_code, ", spawn failure" if spawn_failure else "")

    # -- operator commands --------------------------------------------- #

    def _wire_scale_target(self, *params):
        """``(scale_target N)`` or ``(scale_target role N)``."""
        try:
            if len(params) >= 2:
                role, value = str(params[0]), int(str(params[1]))
            else:
                role, value = "decode", int(str(params[0]))
        except (IndexError, ValueError):
            self.logger.warning("%s: bad scale_target %r", self.name,
                                params)
            return
        if role not in ROLES:
            self.logger.warning("%s: unknown role %r", self.name, role)
            return
        floor, cap = self.policy.role_bounds(role)
        self.state.targets[role] = max(floor, min(cap, value))
        self._set_share(f"target_{role}", self.state.targets[role])
        self._set_share("last_action",
                        f"scale_target:{role}={self.state.targets[role]}")

    def _wire_clear_quarantine(self, *params):
        slot = str(params[0]) if params else ""
        if self.state.quarantined.pop(slot, None) is not None:
            self.state.deaths.pop(slot, None)
            self.state.backoff_until.pop(slot, None)
            self._set_share("quarantine", " ".join(
                sorted(self.state.quarantined)))
            self.logger.info("%s: quarantine cleared for %s",
                             self.name, slot)

    # -- the control loop ---------------------------------------------- #

    def snapshot(self) -> FleetSnapshot:
        """Assemble the pure decision input from watched telemetry."""
        now = self.process.event.now()
        replicas = []
        for slot in sorted(self._topics):
            telemetry = self._telemetry.get(slot, {})
            lifecycle = telemetry.get("lifecycle", "")
            replicas.append(ReplicaView(
                slot=slot,
                role=self.state.slots.get(
                    slot, "prefill" if "prefill" in slot else "decode"),
                healthy=bool(telemetry.get("healthy", True))
                and lifecycle != "unhealthy",
                retiring=lifecycle == "retiring"
                or slot in self._draining,
                drained=bool(telemetry.get("drained", 0)),
                queue_depth=int(telemetry.get("queue_depth", 0)),
                slots_active=int(telemetry.get("slots_active", 0)),
                deadline_exceeded=int(
                    telemetry.get("deadline_exceeded", 0)),
                tp_degree=int(telemetry.get("tp_degree", 1) or 1)))
        shed = self._router_stats.get("shed", 0.0)
        redispatch = self._router_stats.get("redispatches", 0.0)
        shed_delta = max(0, int(shed - self._last_shed))
        redispatch_delta = max(0, int(redispatch
                                      - self._last_redispatch))
        self._last_shed, self._last_redispatch = shed, redispatch
        ttft = self._router_stats.get("fleet_ttft_p95_ms")
        if ttft is None:
            # No router quantile yet: the worst replica-reported p95
            # stands in (same histograms, unmerged).
            values = [t["ttft_p95_ms"] for t in self._telemetry.values()
                      if "ttft_p95_ms" in t]
            ttft = max(values) if values else None
        deaths, self._deaths = tuple(self._deaths), []
        return FleetSnapshot(
            now=now, replicas=tuple(replicas),
            pending=tuple(self._pending.values()), deaths=deaths,
            ttft_p95_ms=ttft, shed_delta=shed_delta,
            redispatch_delta=redispatch_delta)

    def _tick(self):
        now = self.process.event.now()
        self._check_pending(now)
        self._check_draining(now)
        self._check_upgrades(now)
        snapshot = self.snapshot()
        before = dict(self.state.targets)
        streak_before = self.state.breach_streak
        actions, self.state = decide(snapshot, self.policy, self.state)
        self._maybe_flight_capture(snapshot, streak_before)
        for role, target in self.state.targets.items():
            if before.get(role) != target:
                self._bump("scale_out" if target > before.get(role, 0)
                           else "scale_in")
                self._set_share(f"target_{role}", target)
                self._set_share(
                    "last_action",
                    f"{'scale_out' if target > before.get(role, 0) else 'scale_in'}"
                    f":{role}={target}")
        for action in actions:
            self._execute(action, now)
        self._publish_fleet_state(snapshot, now)
        self._last_tick = now

    def _maybe_flight_capture(self, snapshot: FleetSnapshot,
                              streak_before: int) -> None:
        """SLO-breach flight trigger: fires at the tick the breach
        streak CROSSES ``policy.breach_windows`` — the same streak
        ``decide()`` scales out on (which resets it to 0 when it
        does) — capturing local forensics and asking the router to
        fan one fleet-wide capture out around a shared trace id.
        The scale-out fixes the symptom; the bundle records why."""
        breach = ((snapshot.ttft_p95_ms is not None
                   and snapshot.ttft_p95_ms > self.policy.ttft_slo_ms)
                  or snapshot.shed_delta > self.policy.shed_tolerance)
        streak = self.state.breach_streak
        crossed = breach and (
            streak == self.policy.breach_windows
            or (streak == 0
                and streak_before == self.policy.breach_windows - 1))
        if not crossed:
            return
        reason = (f"slo breach streak={streak_before + 1} "
                  f"ttft_p95={snapshot.ttft_p95_ms} "
                  f"shed_delta={snapshot.shed_delta}")
        steady = self.steady_captures()
        if steady:
            # A steady-state capture storm stalls steps fleet-wide —
            # name the prime TTFT-breach suspect in the bundle reason.
            reason += f" steady_compiles={steady}"
        if flight.FLIGHT is not None:
            flight.FLIGHT.capture("slo_breach", reason=reason)
        if self._router_topic is not None:
            self.process.message.publish(
                f"{self._router_topic}/in",
                generate("capture", ["", "", "slo_breach", reason]))

    def steady_captures(self) -> int:
        """CUDA-graph captures after the warm-up fence, summed over the
        announced replicas' latest ``graph_captures_steady_state``."""
        return sum(int(telemetry.get("graph_captures_steady_state", 0))
                   for telemetry in self._telemetry.values())

    def _execute(self, action: Action, now: float) -> None:
        if action.kind == "spawn":
            self._begin_spawn(action, now)
        elif action.kind == "drain":
            self._begin_drain(action, now)
        elif action.kind == "migrate":
            self._begin_migrate(action, now)
        elif action.kind == "quarantine":
            self._bump("quarantines")
            self._set_share("quarantine", " ".join(
                sorted(self.state.quarantined)))
            self._set_share("last_action", action.describe())
            self.logger.warning("%s: QUARANTINED %s (%s)", self.name,
                                action.slot, action.reason)

    def _begin_spawn(self, action: Action, now: float) -> None:
        slot, role = action.slot, action.role
        delay_s = 0.0
        if faults.PLAN is not None:
            hit = faults.PLAN.check("fail_spawn", key=slot)
            if hit is not None:
                # The launch fails outright: report through the same
                # funnel as a real spawn failure and let backoff /
                # quarantine decide what happens next.
                self._bump("spawn_failures")
                self._set_share("last_action", f"fail_spawn:{slot}")
                self.logger.warning("%s: fault fail_spawn firing for %s",
                                    self.name, slot)
                self._note_death(slot, exit_code=None,
                                 spawn_failure=True)
                return
            hit = faults.PLAN.check("slow_start", key=slot)
            if hit is not None:
                delay_s = float(hit.get("ms", 1000.0)) / 1e3
                self._bump("slow_starts")
                self.logger.warning(
                    "%s: fault slow_start delaying %s by %.2fs",
                    self.name, slot, delay_s)
        self._bump("respawns" if action.reason == "replace"
                   else "spawns")
        self._pending[slot] = PendingView(
            slot=slot, role=role,
            due=now + delay_s + self.policy.spawn_timeout_s)
        self._set_share("last_action", action.describe())
        if delay_s > 0:
            self.process.event.add_timer_handler(
                lambda: self._do_spawn(slot, role), delay_s, once=True)
        else:
            self._do_spawn(slot, role)

    def _do_spawn(self, slot: str, role: str) -> None:
        if slot not in self._pending:
            return    # spawn was cancelled/superseded during the delay
        try:
            self._spawner(slot, role)
        except Exception:  # noqa: BLE001 - spawn failure, not our death
            self.logger.exception("%s: spawner failed for %s",
                                  self.name, slot)
            self._pending.pop(slot, None)
            self._bump("spawn_failures")
            self._note_death(slot, exit_code=None, spawn_failure=True)

    def _begin_drain(self, action: Action, now: float) -> None:
        slot = action.slot
        topic = self._topics.get(slot)
        if topic is None or slot in self._draining:
            return
        self._draining[slot] = now + self.policy.drain_timeout_s
        self._bump("drains")
        self._set_share("last_action", action.describe())
        self.logger.info("%s: draining %s (%s)", self.name, slot,
                         action.reason)
        self.process.message.publish(f"{topic}/in", "(retire)")

    def _begin_migrate(self, action: Action, now: float) -> None:
        """Drain-free retire: ask the router to live-migrate the
        victim's in-flight population away (to ``action.dest`` when
        set, else router's choice per request), then retire it.  The
        retire lands with the population already moving, so the slot
        reports ``drained`` as soon as the cutovers finish instead of
        after its longest request does."""
        slot = action.slot
        topic = self._topics.get(slot)
        if topic is None or slot in self._draining:
            return
        if self._router_topic is not None:
            params = [topic]
            dest_topic = self._topics.get(action.dest)
            if dest_topic:
                params.append(dest_topic)
            self.process.message.publish(
                f"{self._router_topic}/in",
                generate("migrate", params))
        self._draining[slot] = now + self.policy.drain_timeout_s
        self._bump("migrates")
        self._set_share("last_action", action.describe())
        self.logger.info("%s: migrating %s away (%s)", self.name,
                         slot, action.reason)
        self.process.message.publish(f"{topic}/in", "(retire)")

    # -- rolling upgrades ---------------------------------------------- #

    def _wire_rolling_upgrade(self, *params):
        """``(rolling_upgrade)`` / ``(rolling_upgrade role)``: replace
        every live replica (of one role, or all) one at a time —
        spawn a successor, live-migrate the in-flight population onto
        it at announce, retire the predecessor — so a weight/version
        upgrade rolls through the fleet with zero downtime and the
        population carried across."""
        role_filter = str(params[0]) if params else ""
        added = 0
        for slot in sorted(self._topics):
            if role_filter and \
                    self.state.slots.get(slot, "decode") != role_filter:
                continue
            if slot in self._draining or slot in self._upgrade_queue \
                    or slot in self._upgrade_pairs.values():
                continue
            self._upgrade_queue.append(slot)
            added += 1
        self._set_share("last_action",
                        f"rolling_upgrade:{added} queued")
        self.logger.info("%s: rolling upgrade queued for %d replicas",
                         self.name, added)

    def _check_upgrades(self, now: float) -> None:
        # A replacement that died before announcing (spawn failure,
        # instant crash): abort that leg and requeue the source so a
        # later attempt still replaces it.
        for new_slot, source in list(self._upgrade_pairs.items()):
            if new_slot in self._pending or new_slot in self._topics:
                continue
            self._upgrade_pairs.pop(new_slot, None)
            self._draining.pop(source, None)
            self.logger.warning(
                "%s: upgrade replacement %s for %s died before "
                "announcing — requeueing the source", self.name,
                new_slot, source)
            if source in self._topics:
                self._upgrade_queue.insert(0, source)
        # One replacement in flight at a time: the fleet never dips
        # below (or spikes above) target by more than one replica.
        if self._upgrade_pairs or self._pending \
                or not self._upgrade_queue:
            return
        while self._upgrade_queue:
            source = self._upgrade_queue.pop(0)
            if source in self._topics \
                    and source not in self._draining:
                break
        else:
            return
        role = self.state.slots.get(source, "decode")
        self._upgrade_seq += 1
        new_slot = f"{role}u{self._upgrade_seq}"
        while new_slot in self.state.slots \
                or new_slot in self.state.quarantined:
            self._upgrade_seq += 1
            new_slot = f"{role}u{self._upgrade_seq}"
        tp = int(self.state.chips.get(source, 0)) \
            or self.policy.role_tp(role)
        # Register the successor in the ledger AND mark the source
        # draining now: the chip total stays at target through the
        # handoff, so decide() never drains a healthy bystander to
        # shed the temporary overlap.  The generous deadline covers
        # the spawn; it tightens once the retire actually goes out.
        self.state.slots[new_slot] = role
        self.state.chips[new_slot] = tp
        self._upgrade_pairs[new_slot] = source
        self._draining[source] = now + self.policy.spawn_timeout_s \
            + self.policy.drain_timeout_s
        self._bump("upgrades_started")
        self._begin_spawn(Action(
            "spawn", new_slot, role=role,
            reason=f"upgrade:{source}", tp_degree=tp), now)

    def _complete_upgrade(self, source: str, dest: str) -> None:
        """The upgrade successor announced: hand the source's live
        population to it and retire the source.  With
        ``policy.migrate_drains`` off this degrades to the drain-based
        replacement (retire and wait out the in-flight tail) — the
        A/B control the bench compares against."""
        topic = self._topics.get(source)
        if topic is None:
            self._bump("upgrades_completed")
            return
        if self._router_topic is not None and \
                self.policy.migrate_drains:
            self.process.message.publish(
                f"{self._router_topic}/in",
                generate("migrate", [topic, self._topics[dest]]))
            self._bump("migrates")
        self._draining[source] = self.process.event.now() \
            + self.policy.drain_timeout_s
        self._bump("upgrades_completed")
        self._set_share("last_action", f"upgrade:{source}->{dest}")
        self.logger.info("%s: upgrade handoff %s -> %s", self.name,
                         source, dest)
        self.process.message.publish(f"{topic}/in", "(retire)")

    def _check_pending(self, now: float) -> None:
        for slot, pending in list(self._pending.items()):
            if now >= pending.due:
                self._pending.pop(slot, None)
                self._bump("spawn_failures")
                self.logger.warning(
                    "%s: spawn of %s timed out (never announced)",
                    self.name, slot)
                self._note_death(slot, exit_code=None,
                                 spawn_failure=True)

    def _check_draining(self, now: float) -> None:
        for slot, deadline in list(self._draining.items()):
            telemetry = self._telemetry.get(slot, {})
            drained = bool(telemetry.get("drained", 0))
            if not drained and now < deadline:
                continue
            self._draining.pop(slot, None)
            self._expected_down.add(slot)
            mode = "drain_complete" if drained else "drain_timeout"
            if not drained:
                self._bump("drain_timeouts")
                self.logger.warning(
                    "%s: drain of %s timed out — stopping anyway "
                    "(router re-dispatch covers stragglers)",
                    self.name, slot)
            else:
                self._bump("drain_completed")
            self._set_share("last_action", f"{mode}:{slot}")
            try:
                self._terminator(slot, mode)
            except Exception:  # noqa: BLE001 - supervisor must survive
                self.logger.exception("%s: terminator failed for %s",
                                      self.name, slot)

    # -- shares -------------------------------------------------------- #

    def _bump(self, counter: str, by: int = 1):
        self.counters[counter] += by
        self._set_share(counter, self.counters[counter])

    def _set_share(self, key: str, value):
        self.share[key] = value
        if self.ec_producer is not None:
            self.ec_producer.update_if_changed(key, value)

    def _publish_fleet_state(self, snapshot: FleetSnapshot,
                             now: float) -> None:
        live = [v for v in snapshot.replicas if not v.retiring]
        self._set_share("replicas_live", len(live))
        self._set_share("replicas_pending", len(self._pending))
        self._set_share("replicas_draining", len(self._draining))
        if snapshot.ttft_p95_ms is not None:
            self._set_share(
                "slo_headroom_ms",
                round(self.policy.ttft_slo_ms - snapshot.ttft_p95_ms,
                      1))
        if self._last_tick is not None:
            dt = max(0.0, now - self._last_tick)
            self.share["replica_seconds"] = round(
                float(self.share["replica_seconds"])
                + len(snapshot.replicas) * dt, 3)

    @property
    def quarantined_slots(self) -> List[str]:
        return sorted(self.state.quarantined)

    def stats(self) -> Dict:
        """Counters + fleet state for bench/loadgen reporting."""
        return dict(self.counters,
                    replicas_live=self.share["replicas_live"],
                    replicas_draining=self.share["replicas_draining"],
                    replica_seconds=self.share["replica_seconds"],
                    quarantine=self.share["quarantine"],
                    targets=dict(self.state.targets))
