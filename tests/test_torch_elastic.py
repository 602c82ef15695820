"""Port parity: the elastic fleet — FleetAutoscaler, decide, the lifecycle
manager, the process manager, remote proxies and categories, and the
elastic, rolling-upgrade, restart and long-tail rigs — against the JAX
package's, on the CPU.

* ``decide``: every scenario of tests/test_autoscaler.py's pure-decision
  section runs through both packages' ``decide`` with the same inputs and
  must give the same actions and the same state after, and a hypothesis
  search over snapshot sequences and policies does the same.
* ``FleetAutoscaler`` on each package's loopback broker and virtual clock:
  ``scale_target`` clamps, ``fail_spawn`` reaches the death funnel,
  ``slow_start`` delays the launch, and a real child exiting 13 through
  ``ProcessManager`` is quarantined after its crash loop; each outcome
  equals the JAX package's.
* The lifecycle manager's four scenarios, the process manager's kill
  ladder and the proxy and category cases run on both packages with equal
  outcomes.
* The pure helpers (diurnal trace, schedules, payloads, goodput
  accounting) equal the JAX package's.
* The rigs on ``device="cpu"``: ``run_elastic_chaos``,
  ``run_rolling_upgrade``, ``run_restart_ab`` and ``run_longtail`` hold
  their invariants, every final held to a JAX oracle on the same weights.
  TTFT orderings follow the CPU's timing and are printed, not asserted.

Port servers serve an f32 copy of ``tiny`` on the JAX package's weights
through the weight bridge.  The rigs run torch with one intra-op thread
(restored after the module): on a shared CPU the thread pool's contention
costs the tiny model's steps a hundredfold.  No assertion reads wall time;
every real-time wait has a deadline.
"""

import dataclasses
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from aiko_services_tpu import orchestration as jax_orchestration
from aiko_services_tpu import runtime as jax_runtime
from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.orchestration import autoscaler as jax_autoscaler
from aiko_services_tpu.orchestration import lifecycle as jax_lifecycle
from aiko_services_tpu.orchestration import (
    process_manager as jax_process_manager)
from aiko_services_tpu.runtime import category as jax_category
from aiko_services_tpu.runtime import faults as jax_faults
from aiko_services_tpu.runtime import proxy as jax_proxy
from aiko_services_tpu.tools import loadgen as jax_loadgen
from aiko_services_tpu_torch import orchestration, runtime, transport
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.models.bridge import params_from_numpy
from aiko_services_tpu_torch.orchestration import (autoscaler, lifecycle,
                                                   process_manager)
from aiko_services_tpu_torch.orchestration.paged import PagedContinuousServer
from aiko_services_tpu_torch.registry import registrar as port_registrar
from aiko_services_tpu_torch.runtime import category, faults, proxy
from aiko_services_tpu_torch.tools import loadgen

CONFIG = "tiny_f32"

SIDES = {
    "jax": types.SimpleNamespace(
        runtime=jax_runtime, autoscaler=jax_autoscaler,
        lifecycle=jax_lifecycle, process_manager=jax_process_manager,
        proxy=jax_proxy, category=jax_category, faults=jax_faults,
        loadgen=jax_loadgen),
    "torch": types.SimpleNamespace(
        runtime=runtime, autoscaler=autoscaler, lifecycle=lifecycle,
        process_manager=process_manager, proxy=proxy, category=category,
        faults=faults, loadgen=loadgen),
}


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_cold():
    """Later test modules in the same worker count their own JAX
    compiles; drop what this module compiled once it is done."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _f32_tiny(monkeypatch):
    monkeypatch.setitem(
        jax_llama.CONFIGS, CONFIG,
        dataclasses.replace(jax_llama.CONFIGS["tiny"], dtype=jnp.float32))
    monkeypatch.setitem(
        llama.CONFIGS, CONFIG,
        dataclasses.replace(llama.CONFIGS["tiny"], dtype=torch.float32))


@pytest.fixture(autouse=True)
def _port_side_isolated():
    """The port has its own broker registry and fault plan: reset them
    around every test, as tests/conftest.py does for the JAX package."""
    transport.reset_brokers()
    yield
    faults.uninstall()
    transport.reset_brokers()


@pytest.fixture()
def quick_election(monkeypatch):
    """The rigs run on a real clock, where every fleet first waits out the
    registrar's primary search; nothing contests it here, so shorten it."""
    monkeypatch.setattr(port_registrar, "PRIMARY_SEARCH_TIMEOUT", 0.05)


def virtual_engine(side):
    return side.runtime.EventEngine(clock=side.runtime.VirtualClock())


def both(scenario):
    """Run ``scenario(side)`` on both packages and require equal
    outcomes; returns the port's."""
    outcomes = {name: scenario(side) for name, side in SIDES.items()}
    assert outcomes["torch"] == outcomes["jax"], outcomes
    return outcomes["torch"]


# --------------------------------------------------------------------------- #
# decide(): tests/test_autoscaler.py's pure-decision scenarios on both sides


def _policy(m, **overrides):
    """tests/test_autoscaler.py's deterministic policy: SLO scaling frozen
    unless a scenario opts in, tight backoff."""
    defaults = dict(target=1, min_replicas=1, max_replicas=8,
                    backoff_base_s=1.0, backoff_cap_s=8.0, cooldown_s=10.0,
                    breach_windows=10 ** 6, clear_windows=10 ** 6,
                    crash_loop_threshold=3, crash_loop_window_s=60.0,
                    quarantine_s=300.0)
    defaults.update(overrides)
    return m.AutoscalerPolicy(**defaults)


class Trace:
    """Runs ``decide`` on one side and records every call's actions and
    state after, as plain data comparable across the packages."""

    def __init__(self, m):
        self.m, self.calls = m, []

    def __call__(self, snapshot, policy, state=None):
        actions, after = self.m.decide(snapshot, policy, state)
        self.calls.append(([dataclasses.asdict(a) for a in actions],
                           dataclasses.asdict(after)))
        return actions, after


def _live(m, slot, **kw):
    return m.ReplicaView(slot=slot, **kw)


def scenario_bootstrap(m, decide):
    actions, state = decide(m.FleetSnapshot(now=0.0), _policy(m, target=2))
    assert [a.kind for a in actions] == ["spawn", "spawn"]
    assert [a.slot for a in actions] == ["decode1", "decode2"]
    assert all(a.reason == "scale_out" for a in actions)
    assert state.targets == {"decode": 2}


def scenario_replace_dead_slot(m, decide):
    policy = _policy(m)
    actions, state = decide(
        m.FleetSnapshot(now=0.0, replicas=(_live(m, "decode1"),)), policy)
    assert actions == []
    actions, state = decide(m.FleetSnapshot(
        now=10.0, deaths=(m.DeathEvent("decode1", ts=10.0),)), policy,
        state)
    assert actions == [] and state.backoff_until["decode1"] == 11.0
    actions, state = decide(m.FleetSnapshot(now=10.5), policy, state)
    assert actions == []
    actions, state = decide(m.FleetSnapshot(now=11.0), policy, state)
    assert actions == [m.Action("spawn", "decode1", role="decode",
                                reason="replace")]
    actions, state = decide(m.FleetSnapshot(
        now=20.0, deaths=(m.DeathEvent("decode1", ts=20.0),)), policy,
        state)
    assert state.backoff_until["decode1"] == 22.0


def scenario_pending_not_down(m, decide):
    policy = _policy(m)
    _, state = decide(m.FleetSnapshot(now=0.0), policy)
    actions, state = decide(m.FleetSnapshot(
        now=1.0, pending=(m.PendingView("decode1", due=30.0),)), policy,
        state)
    assert actions == []


def scenario_expected_death(m, decide):
    state = m.ControllerState(
        targets={"decode": 1},
        slots={"decode1": "decode", "decode2": "decode"})
    actions, state = decide(m.FleetSnapshot(
        now=5.0, replicas=(_live(m, "decode2"),),
        deaths=(m.DeathEvent("decode1", ts=5.0, expected=True),)),
        _policy(m), state)
    assert "decode1" not in state.slots and actions == []


def scenario_squatters(m, decide):
    actions, state = decide(
        m.FleetSnapshot(now=0.0, replicas=(_live(m, "decode1"),)),
        _policy(m, target=2))
    assert actions == [m.Action("spawn", "decode2", role="decode",
                                reason="scale_out")]


def _quarantine_decode1(m, decide, policy):
    _, state = decide(m.FleetSnapshot(
        now=0.0, replicas=(_live(m, "decode1"), _live(m, "decode2"))),
        policy)
    actions = []
    for ts in (10.0, 12.0, 14.0):
        actions, state = decide(m.FleetSnapshot(
            now=ts, replicas=(_live(m, "decode2"),),
            deaths=(m.DeathEvent("decode1", ts=ts, exit_code=13),)),
            policy, state)
    return actions, state


def scenario_crash_loop(m, decide):
    policy = _policy(m, target=2)
    actions, state = _quarantine_decode1(m, decide, policy)
    assert [a.kind for a in actions] == ["quarantine"]
    assert "exit=13" in actions[0].reason
    assert state.quarantined["decode1"] == 314.0
    for now in (20.0, 40.0):
        actions, state = decide(m.FleetSnapshot(
            now=now, replicas=(_live(m, "decode2"),)), policy, state)
        assert actions == []


def scenario_quarantine_expiry(m, decide):
    state = m.ControllerState(
        targets={"decode": 1},
        slots={"decode1": "decode", "decode2": "decode"},
        quarantined={"decode1": 314.0})
    actions, state = decide(m.FleetSnapshot(
        now=315.0, replicas=(_live(m, "decode2"),)), _policy(m), state)
    assert actions == [] and state.quarantined == {}
    assert list(state.slots) == ["decode2"]


def scenario_draining_capacity(m, decide):
    state = m.ControllerState(
        targets={"decode": 1},
        slots={"decode1": "decode", "decode2": "decode"})
    actions, state = decide(m.FleetSnapshot(
        now=5.0, replicas=(_live(m, "decode1", retiring=True),
                           _live(m, "decode2"))), _policy(m), state)
    assert actions == []


def scenario_scale_out_hysteresis(m, decide):
    policy = _policy(m, breach_windows=3, cooldown_s=10.0)
    _, state = decide(m.FleetSnapshot(now=0.0), policy)
    fleet = (_live(m, "decode1"),)
    for now in (1.0, 2.0):
        actions, state = decide(m.FleetSnapshot(
            now=now, replicas=fleet, ttft_p95_ms=900.0), policy, state)
        assert state.targets == {"decode": 1}
    actions, state = decide(m.FleetSnapshot(
        now=3.0, replicas=fleet, ttft_p95_ms=900.0), policy, state)
    assert state.targets == {"decode": 2}
    fleet = (_live(m, "decode1"), _live(m, "decode2"))
    for now in (4.0, 5.0, 6.0, 9.0):
        actions, state = decide(m.FleetSnapshot(
            now=now, replicas=fleet, ttft_p95_ms=900.0), policy, state)
        assert state.targets == {"decode": 2}
    actions, state = decide(m.FleetSnapshot(
        now=13.0, replicas=fleet, ttft_p95_ms=900.0), policy, state)
    assert state.targets == {"decode": 3}


def scenario_shed_breach(m, decide):
    policy = _policy(m, breach_windows=1, cooldown_s=0.0)
    _, state = decide(m.FleetSnapshot(now=0.0), policy)
    actions, state = decide(m.FleetSnapshot(
        now=1.0, replicas=(_live(m, "decode1"),), shed_delta=4), policy,
        state)
    assert state.targets == {"decode": 2}


def scenario_scale_in_idlest(m, decide):
    policy = _policy(m, target=2, clear_windows=3, cooldown_s=0.0)
    fleet = (_live(m, "decode1", slots_active=1), _live(m, "decode2"))
    _, state = decide(m.FleetSnapshot(now=0.0, replicas=fleet), policy)
    actions, state = decide(m.FleetSnapshot(now=1.0, replicas=fleet),
                            policy, state)
    actions, state = decide(m.FleetSnapshot(now=2.0, replicas=fleet),
                            policy, state)
    assert state.targets == {"decode": 1}
    assert actions == [m.Action("drain", "decode2", role="decode",
                                reason="scale_in")]


def scenario_scale_in_blocked(m, decide):
    policy = _policy(m, target=2, clear_windows=2, cooldown_s=0.0)
    _, state = decide(m.FleetSnapshot(now=0.0, replicas=(
        _live(m, "decode1", queue_depth=3), _live(m, "decode2"))), policy)
    actions, state = decide(m.FleetSnapshot(
        now=1.0, replicas=(_live(m, "decode1", queue_depth=3),
                           _live(m, "decode2"))), policy, state)
    assert state.targets == {"decode": 2}
    actions, state = decide(m.FleetSnapshot(
        now=2.0, replicas=(_live(m, "decode1"), _live(m, "decode2")),
        pending=(m.PendingView("decode3", due=30.0),)), policy, state)
    assert state.targets == {"decode": 2}
    floor = _policy(m, target=1, clear_windows=1, cooldown_s=0.0)
    _, state = decide(m.FleetSnapshot(now=0.0,
                                      replicas=(_live(m, "decode1"),)), floor)
    for now in (1.0, 2.0, 3.0):
        actions, state = decide(m.FleetSnapshot(
            now=now, replicas=(_live(m, "decode1"),)), floor, state)
        assert state.targets == {"decode": 1} and actions == []


def scenario_disaggregated(m, decide):
    policy = _policy(m, target=1, prefill_target=1, prefill_max=4,
                     breach_windows=1, cooldown_s=0.0)
    _, state = decide(m.FleetSnapshot(now=0.0), policy)
    assert state.targets == {"decode": 1, "prefill": 1}
    prefill_slot = next(s for s, r in state.slots.items() if r == "prefill")
    fleet = (_live(m, "decode1"), _live(m, prefill_slot, role="prefill"))
    actions, state = decide(m.FleetSnapshot(
        now=1.0, replicas=fleet, ttft_p95_ms=900.0), policy, state)
    assert state.targets == {"decode": 1, "prefill": 2}
    assert [a.role for a in actions if a.kind == "spawn"] == ["prefill"]
    actions, state = decide(m.FleetSnapshot(
        now=2.0, replicas=fleet, shed_delta=5), policy, state)
    assert state.targets == {"decode": 2, "prefill": 2}


def scenario_pure(m, decide):
    policy = _policy(m, target=2, breach_windows=1, cooldown_s=0.0)
    state = m.ControllerState(
        targets={"decode": 2},
        slots={"decode1": "decode", "decode2": "decode"},
        deaths={"decode1": [3.0]}, backoff_until={"decode1": 4.0})
    snapshot = m.FleetSnapshot(
        now=9.0, replicas=(_live(m, "decode2", queue_depth=1),),
        deaths=(m.DeathEvent("decode2", ts=9.0),), ttft_p95_ms=800.0)
    frozen = dataclasses.asdict(state)
    first = decide(snapshot, policy, state)
    second = decide(snapshot, policy, state)
    assert dataclasses.asdict(state) == frozen
    assert first[0] == second[0]
    assert dataclasses.asdict(first[1]) == dataclasses.asdict(second[1])


DECIDE_SCENARIOS = {name[len("scenario_"):]: fn
                    for name, fn in dict(globals()).items()
                    if name.startswith("scenario_")}


@pytest.mark.parametrize("name", sorted(DECIDE_SCENARIOS))
def test_decide_scenarios_match_jax(name):
    """tests/test_autoscaler.py's decide scenarios (bootstrap,
    self-healing, quarantine, hysteresis, scale-in, disaggregation,
    purity): each holds on both packages, and every decide call gives the
    same actions and state."""
    def run(side):
        trace = Trace(side.autoscaler)
        DECIDE_SCENARIOS[name](side.autoscaler, trace)
        return trace.calls
    assert both(run)


_SLOTS = ("decode1", "decode2", "decode3", "prefill1", "decode4")
_replica = st.fixed_dictionaries(dict(
    slot=st.sampled_from(_SLOTS), healthy=st.booleans(),
    retiring=st.booleans(), queue_depth=st.integers(0, 4),
    slots_active=st.integers(0, 3), tp_degree=st.sampled_from((1, 1, 2))))
_snapshot = st.fixed_dictionaries(dict(
    dt=st.sampled_from((0.0, 0.5, 1.0, 3.0, 11.0, 70.0)),
    replicas=st.lists(_replica, max_size=4, unique_by=lambda r: r["slot"]),
    pending=st.lists(st.sampled_from(_SLOTS), max_size=2, unique=True),
    deaths=st.lists(st.tuples(st.sampled_from(_SLOTS),
                              st.sampled_from((None, 13, 1)),
                              st.booleans(), st.booleans()), max_size=3),
    ttft=st.sampled_from((None, 100.0, 900.0)),
    shed=st.integers(0, 3)))
_knobs = st.fixed_dictionaries(dict(
    target=st.integers(0, 3), min_replicas=st.integers(0, 2),
    max_replicas=st.integers(2, 5), prefill_target=st.integers(0, 2),
    breach_windows=st.integers(1, 3), clear_windows=st.integers(1, 3),
    cooldown_s=st.sampled_from((0.0, 2.0, 10.0)),
    crash_loop_threshold=st.integers(1, 3),
    migrate_drains=st.booleans(), reshard_tp=st.booleans(),
    decode_tp=st.sampled_from((1, 2)), prefill_tp=st.sampled_from((0, 2))))


def _snapshot_of(m, spec, now):
    role = lambda slot: "prefill" if "prefill" in slot else "decode"
    return m.FleetSnapshot(
        now=now,
        replicas=tuple(m.ReplicaView(role=role(r["slot"]), **r)
                       for r in spec["replicas"]),
        pending=tuple(m.PendingView(slot, role=role(slot), due=now + 30.0)
                      for slot in spec["pending"]),
        deaths=tuple(m.DeathEvent(slot, ts=now, exit_code=code,
                                  spawn_failure=failed, expected=expected)
                     for slot, code, failed, expected in spec["deaths"]),
        ttft_p95_ms=spec["ttft"], shed_delta=spec["shed"])


@settings(max_examples=60, deadline=None)
@given(knobs=_knobs, snapshots=st.lists(_snapshot, min_size=1, max_size=6))
def test_decide_matches_jax_on_random_fleets(knobs, snapshots):
    """Random snapshot sequences (adopted replicas of TP 1 and 2, pending
    spawns, expected and unexpected deaths, TTFT and shed breaches) under
    random policies (disaggregated targets, migrate drains, resharding):
    the port's decide gives the JAX package's actions and state at every
    tick."""
    def run(side):
        m = side.autoscaler
        policy = _policy(m, **knobs)
        state, now, calls = None, 0.0, []
        for spec in snapshots:
            now += spec["dt"]
            actions, state = m.decide(_snapshot_of(m, spec, now), policy,
                                      state)
            calls.append(([dataclasses.asdict(a) for a in actions],
                          dataclasses.asdict(state)))
        return calls
    both(run)


# --------------------------------------------------------------------------- #
# FleetAutoscaler on each package's loopback broker and virtual clock


def _make_autoscaler(side, engine, policy, spawner=None, terminator=None,
                     broker="asc"):
    process = side.runtime.Process(namespace="asc", hostname="h", pid="1",
                                   engine=engine, broker=broker)
    return side.runtime.compose_instance(
        side.autoscaler.FleetAutoscaler, side.runtime.actor_args("autoscaler"),
        process=process, spawner=spawner, terminator=terminator,
        policy=policy, tick_s=0.05)


def test_scale_target_wire_command_clamps():
    def run(side):
        autoscaler_ = _make_autoscaler(
            side, virtual_engine(side),
            _policy(side.autoscaler, target=1, max_replicas=4,
                    prefill_max=2))
        autoscaler_._wire_scale_target("9")
        clamped = (autoscaler_.state.targets["decode"],
                   autoscaler_.share["target_decode"])
        autoscaler_._wire_scale_target("prefill", "2")
        autoscaler_._wire_scale_target("warp", "3")
        autoscaler_._wire_scale_target("not_a_number")
        return clamped, dict(autoscaler_.state.targets), \
            autoscaler_.share["last_action"]
    assert both(run) == ((4, 4), {"decode": 4, "prefill": 2},
                         "scale_target:prefill=2")


def test_fail_spawn_fault_reports_through_the_death_funnel():
    def run(side):
        engine, calls = virtual_engine(side), []
        autoscaler_ = _make_autoscaler(
            side, engine, _policy(side.autoscaler, target=1,
                                  backoff_base_s=0.2),
            spawner=lambda slot, role: calls.append(slot),
            broker="failspawn")
        side.faults.install(side.faults.FaultPlan().add("fail_spawn", nth=1))
        try:
            for tick in range(40):
                engine.advance(0.05)
                if calls:
                    break
        finally:
            side.faults.uninstall()
        return calls, tick, dict(autoscaler_.counters)
    calls, _, counters = both(run)
    assert calls == ["decode1"]
    assert (counters["spawn_failures"], counters["respawns"],
            counters["spawns"], counters["deaths_observed"]) == (1, 1, 0, 1)


def test_slow_start_fault_delays_the_launch():
    def run(side):
        engine, calls = virtual_engine(side), []
        autoscaler_ = _make_autoscaler(
            side, engine, _policy(side.autoscaler, target=1),
            spawner=lambda slot, role: calls.append(slot),
            broker="slowstart")
        side.faults.install(side.faults.FaultPlan().add(
            "slow_start", nth=1, ms=500))
        seen = []
        try:
            for dt in (0.05, 0.3, 0.3):
                engine.advance(dt)
                seen.append((list(calls), autoscaler_.counters["slow_starts"],
                             sorted(autoscaler_._pending)))
        finally:
            side.faults.uninstall()
        return seen
    assert both(run) == [([], 1, ["decode1"]), ([], 1, ["decode1"]),
                         (["decode1"], 1, ["decode1"])]


def test_exit_13_crash_loop_quarantines_and_stops_respawning():
    """A slot whose real child exits 13 three times is quarantined, the
    supervisor stops launching it, and ``(clear_quarantine)`` resumes it:
    the same counters, exit codes and shares on both packages."""
    def run(side):
        engine = virtual_engine(side)
        m = side.autoscaler
        policy = _policy(m, target=1, backoff_base_s=0.1, backoff_cap_s=0.4,
                         crash_loop_threshold=3, crash_loop_window_s=60.0,
                         spawn_timeout_s=30.0)
        autoscaler_ = _make_autoscaler(side, engine, policy,
                                       broker="crashloop")
        manager = side.process_manager.ProcessManager(
            exit_handler=autoscaler_.note_exit, engine=engine)
        autoscaler_._spawner = m.manager_spawner(
            manager, sys.executable,
            argv_fn=lambda slot, role: ["-c", "import sys; sys.exit(13)"])
        autoscaler_._terminator = m.manager_terminator(manager)

        def pump(predicate, what):
            deadline = time.time() + 60.0
            while not predicate():
                assert time.time() < deadline, what
                engine.advance(0.05)
                time.sleep(0.005)
        try:
            pump(lambda: "decode1" in autoscaler_.state.quarantined,
                 "slot never quarantined")
            quarantined = (dict(autoscaler_.counters),
                           manager.exit_codes["decode1"],
                           autoscaler_.share["quarantine"])
            launches = (autoscaler_.counters["spawns"]
                        + autoscaler_.counters["respawns"])
            for _ in range(40):
                engine.advance(0.05)
                time.sleep(0.002)
            contained = (autoscaler_.counters["spawns"]
                         + autoscaler_.counters["respawns"] == launches,
                         autoscaler_.share["replicas_live"])
            autoscaler_._wire_clear_quarantine("decode1")
            cleared = dict(autoscaler_.state.quarantined)
            pump(lambda: (autoscaler_.counters["spawns"]
                          + autoscaler_.counters["respawns"]) > launches,
                 "no respawn after clear_quarantine")
        finally:
            manager.terminate_all(kill=True)
        return quarantined, contained, cleared
    (counters, code, share), contained, cleared = both(run)
    assert (counters["quarantines"], counters["deaths_observed"], code,
            share) == (1, 3, 13, "decode1")
    assert contained == (True, 0) and cleared == {}


def test_steady_captures_name_the_suspect_in_the_breach_capture(monkeypatch):
    """The port's SLO-breach flight capture reads steady-state captures
    from the replicas' telemetry (the JAX package reads its compile
    ledger): the reason names ``steady_compiles=N`` summed over them."""
    captured = []
    monkeypatch.setattr(autoscaler.flight, "FLIGHT", types.SimpleNamespace(
        capture=lambda kind, reason: captured.append((kind, reason))))
    m = autoscaler
    scaler = _make_autoscaler(
        SIDES["torch"], virtual_engine(SIDES["torch"]),
        _policy(m, breach_windows=1, cooldown_s=0.0), broker="steady")
    scaler._topics.update(decode1="asc/h/7/1", decode2="asc/h/8/1")
    for slot, topic, value in (("decode1", "asc/h/7/1", 2),
                               ("decode2", "asc/h/8/1", 3)):
        scaler._replica_state(
            f"{topic}/state",
            f"(update graph_captures_steady_state {value})")
    assert scaler.steady_captures() == 5
    snapshot = m.FleetSnapshot(now=1.0, ttft_p95_ms=900.0)
    scaler.state.breach_streak = 1
    scaler._maybe_flight_capture(snapshot, 0)
    assert captured and captured[0][0] == "slo_breach"
    assert captured[0][1].endswith(" steady_compiles=5")


# --------------------------------------------------------------------------- #
# Lifecycle, process manager, proxies and categories on both sides


def _lifecycle_fleet(side, engine, broker):
    process = lambda pid: side.runtime.Process(
        namespace="test", hostname="h", pid=str(pid), engine=engine,
        broker=broker)
    workers, killed = {}, []

    def spawner(client_id, manager_topic_control):
        workers[client_id] = side.lifecycle.LifeCycleClient(
            side.runtime.actor_args(f"worker_{client_id}"),
            process=process(100 + int(client_id)),
            manager_topic_control=manager_topic_control,
            client_id=client_id)
    manager = side.lifecycle.LifeCycleManager(
        process=process(1), spawner=spawner, killer=killed.append,
        handshake_lease_time=30.0, deletion_lease_time=30.0)
    return manager, workers, killed, process


def lifecycle_create_handshake(side):
    engine = virtual_engine(side)
    manager, workers, killed, _ = _lifecycle_fleet(side, engine, "lcm")
    for i in range(3):
        manager.create_client(i)
    engine.drain()
    return (manager.client_count(ready_only=True),
            manager.clients["1"] == workers["1"].topic_path, killed)


def lifecycle_missed_handshake(side):
    engine, killed = virtual_engine(side), []
    manager = side.lifecycle.LifeCycleManager(
        process=side.runtime.Process(namespace="test", hostname="h", pid="1",
                                     engine=engine, broker="lcm2"),
        spawner=lambda cid, topic: None, killer=killed.append)
    manager.create_client("a")
    engine.advance(31.0)
    return killed, manager.client_count()


def lifecycle_clean_exit(side):
    engine = virtual_engine(side)
    manager, _, killed, _ = _lifecycle_fleet(side, engine, "lcm3")
    manager.create_client("0")
    engine.drain()
    ready = manager.client_count(ready_only=True)
    exits = []
    manager._client_exit_handler = exits.append
    manager.delete_client("0")
    engine.drain()
    after = (manager.client_count(), list(exits), list(killed))
    engine.advance(40.0)
    return ready, after, killed


def lifecycle_unresponsive(side):
    engine, killed = virtual_engine(side), []
    process = lambda pid: side.runtime.Process(
        namespace="test", hostname="h", pid=str(pid), engine=engine,
        broker="lcm4")

    def spawner(client_id, manager_topic_control):
        client = side.lifecycle.LifeCycleClient(
            side.runtime.actor_args("zombie"), process=process(200),
            manager_topic_control=manager_topic_control, client_id=client_id)
        client.terminate = lambda: None      # ignores (terminate)
    manager = side.lifecycle.LifeCycleManager(
        process=process(1), spawner=spawner, killer=killed.append)
    manager.create_client("z")
    engine.drain()
    ready = manager.client_count(ready_only=True)
    manager.delete_client("z")
    engine.advance(31.0)
    return ready, killed, manager.client_count()


LIFECYCLE = {"create_handshake": (lifecycle_create_handshake,
                                  (3, True, [])),
             "missed_handshake": (lifecycle_missed_handshake, (["a"], 0)),
             "clean_exit": (lifecycle_clean_exit,
                            (1, (0, ["0"], []), [])),
             "unresponsive": (lifecycle_unresponsive, (1, ["z"], 0))}


@pytest.mark.parametrize("name", sorted(LIFECYCLE))
def test_lifecycle_scenarios_match_jax(name):
    """tests/test_lifecycle.py's four scenarios on both packages."""
    scenario, want = LIFECYCLE[name]
    assert both(scenario) == want


def test_process_manager_escalation_matches_jax():
    """tests/test_faults.py's kill ladder: terminate, escalate after the
    grace, kill at once, unknown id, already exited."""
    def run(side):
        manager = side.process_manager.ProcessManager()
        outcomes = []
        manager.processes["good"] = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(60)"])
        outcomes.append(manager.delete("good", grace=10.0, wait=10.0))
        stubborn = subprocess.Popen(
            [sys.executable, "-c",
             "import signal, time; "
             "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
             "print('armed', flush=True); time.sleep(60)"],
            stdout=subprocess.PIPE, text=True)
        assert stubborn.stdout.readline().strip() == "armed"
        manager.processes["stubborn"] = stubborn
        manager.commands["stubborn"] = ["stubborn"]
        outcomes.append(manager.delete("stubborn", grace=0.5, wait=10.0))
        outcomes.append(stubborn.poll() is not None)
        stubborn.stdout.close()
        quick = subprocess.Popen([sys.executable, "-c",
                                  "import time; time.sleep(60)"])
        manager.processes["quick"] = quick
        outcomes.append(manager.delete("quick", kill=True, wait=10.0))
        outcomes.append(manager.delete("missing"))
        gone = subprocess.Popen([sys.executable, "-c", "pass"])
        gone.wait(timeout=30)
        manager.processes["gone"] = gone
        outcomes.append(manager.delete("gone"))
        return outcomes
    assert both(run) == ["terminated", "escalated_kill", True, "killed",
                         None, "already_exited"]


def test_process_manager_reports_exits_and_spawn_failures(tmp_path):
    """A child exiting on its own reaches the exit handler with its code
    through the poll timer; a spawn that fails reports ``None`` through
    the same funnel and raises."""
    # Executable, but no program: the OS refuses to run it.
    unrunnable = tmp_path / "unrunnable"
    unrunnable.write_bytes(b"\0\0\0\0")
    unrunnable.chmod(0o755)

    def run(side):
        engine, exits = virtual_engine(side), []
        manager = side.process_manager.ProcessManager(
            exit_handler=lambda id, argv, code: exits.append((id, code)),
            engine=engine)
        manager.create("seven", sys.executable,
                       ["-c", "import sys; sys.exit(7)"])
        deadline = time.time() + 30.0
        while not exits:
            assert time.time() < deadline
            engine.advance(0.2)
            time.sleep(0.01)
        with pytest.raises(OSError):
            manager.create("nothing", str(unrunnable))
        return exits, dict(manager.exit_codes), "seven" in manager
    assert both(run) == ([("seven", 7), ("nothing", None)],
                         {"seven": 7, "nothing": None}, False)


def test_proxy_trace_and_hooks_match_jax():
    """tests/test_aux.py's proxy cases: the trace proxy's enter/exit lines,
    a hook that vetoes, attribute writes passing through."""
    def run(side):
        class Greeter:
            tone = "warm"

            def greet(self, name):
                return f"hello {name}"

        class Counter:
            value = 0

            def bump(self, by):
                self.value += by
                return self.value

        class Box:
            def get(self):
                return self.item

        lines = []
        traced = side.proxy.proxy_trace(Greeter(), printer=lines.append)
        first = (traced.greet("pele"), traced.tone, lines)
        calls, target = [], Counter()

        def hook(proxy_name, target_, method, args, kwargs, call):
            calls.append(method)
            return None if args[0] < 0 else call()
        vetoing = side.proxy.ProxyAllMethods("counter", target, hook)
        second = (vetoing.bump(2), vetoing.bump(-5), target.value, calls)
        box = side.proxy.ProxyAllMethods("box", Box(), lambda *a: a[-1]())
        box.item = 9
        return first, second, box.get(), repr(traced).split("(")[0]
    first, second, item, name = both(run)
    assert first[:2] == ("hello pele", "warm") and len(first[2]) == 2
    assert second == (2, None, 2, ["bump", "bump"]) and item == 9


def test_remote_proxy_and_category_match_jax():
    """tests/test_actor.py's remote proxy RPC between two processes on one
    broker, the proxy's public methods, and tests/test_aux.py's category
    membership and listing."""
    def run(side):
        rt = side.runtime
        engine = virtual_engine(side)

        class Greeter(rt.Actor):
            def __init__(self, context, process=None):
                super().__init__(context, process)
                self.greetings = []

            def aloha(self, name):
                self.greetings.append(name)

        p1, p2 = (rt.Process(namespace="test", hostname="h", pid=str(pid),
                             engine=engine, broker="t") for pid in (1, 2))
        callee = rt.compose_instance(Greeter, rt.actor_args("callee"),
                                     process=p2)
        remote = rt.get_actor_proxy(callee.topic_path, Greeter, p1)
        remote.aloha("Honua")
        engine.drain()
        published = []

        class Manager(side.category.Category):
            process = types.SimpleNamespace(message=types.SimpleNamespace(
                publish=lambda topic, payload: published.append(
                    (topic, payload))))
        manager = Manager()
        manager.category_add("pe_1", {"state": "ready"})
        manager.category_add("pe_2")
        members = ("pe_1" in manager, len(manager))
        manager.category_list("ns/h/1/0/response")
        removed = manager.category_remove("pe_1")
        return (callee.greetings, "aloha" in rt.get_public_methods(Greeter),
                repr(remote), members, published, removed, len(manager))
    greetings, public, _, members, published, removed, left = both(run)
    assert greetings == ["Honua"] and public and members == (True, 2)
    assert published[0][1] == "(item_count 2)" and removed == {
        "state": "ready"} and left == 1


def test_exports_match_jax_less_the_trainer():
    ours = {name for name in dir(orchestration) if not name.startswith("_")}
    theirs = {name for name in dir(jax_orchestration)
              if not name.startswith("_")}
    # Submodule names differ with what each package holds; the exports
    # are the rest.
    modules = {name for name in theirs | ours
               if isinstance(getattr(jax_orchestration, name,
                                     getattr(orchestration, name, None)),
                             types.ModuleType)}
    assert ours - modules == theirs - modules - {"TrainerActor",
                                                 "TRAINER_PROTOCOL"}
    ours = {name for name in dir(runtime) if not name.startswith("_")}
    theirs = {name for name in dir(jax_runtime) if not name.startswith("_")}
    modules = {name for name in theirs | ours
               if isinstance(getattr(jax_runtime, name,
                                     getattr(runtime, name, None)),
                             types.ModuleType)}
    assert ours - modules == theirs - modules
    assert autoscaler.__all__ == jax_autoscaler.__all__
    assert (lifecycle.HANDSHAKE_LEASE_TIME, lifecycle.DELETION_LEASE_TIME) \
        == (jax_lifecycle.HANDSHAKE_LEASE_TIME,
            jax_lifecycle.DELETION_LEASE_TIME)


# --------------------------------------------------------------------------- #
# Pure helpers


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_traces_schedules_and_payloads_equal_jax(seed):
    for kwargs in (dict(duration_s=20.0, base_hz=2.0, peak_hz=10.0,
                        period_s=5.0),
                   dict(duration_s=12.0, base_hz=1.0, peak_hz=8.0,
                        period_s=8.0, burst_hz=40.0, burst_every_s=5.0,
                        burst_len_s=0.5)):
        assert loadgen.diurnal_trace(seed=seed, **kwargs) \
            == jax_loadgen.diurnal_trace(seed=seed, **kwargs)
    ours, theirs = (side.elastic_chaos_schedule(seed)
                    for side in (loadgen, jax_loadgen))
    assert [(r.point, r.nth, r.match, r.params) for r in ours._rules] \
        == [(r.point, r.nth, r.match, r.params) for r in theirs._rules]
    for kwargs in (dict(seed=seed), dict(seed=seed, prompt_len=18,
                                         max_new_tokens=48, stream=True)):
        pairs = (loadgen._elastic_payloads(**kwargs),
                 jax_loadgen._elastic_payloads(**kwargs))
        for index in (0, 5, 31, 32, 77):
            a, b = (fn(index) for fn in pairs)
            assert a.keys() == b.keys()
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            assert a["max_new_tokens"] == b["max_new_tokens"]
    for kwargs in (dict(seed=seed), dict(seed=seed, n_prefixes=3,
                                         prefix_len=192, stream=False)):
        pairs = (loadgen.longtail_payloads(**kwargs),
                 jax_loadgen.longtail_payloads(**kwargs))
        for index in (0, 1, 2, 9, 40):
            a, b = (fn(index) for fn in pairs)
            assert a.keys() == b.keys()
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_goodput_accounting_equals_jax():
    """tests/test_autoscaler.py's goodput case on both reports."""
    def report(side):
        return side.loadgen.LoadReport(
            sent=10, completed=8, errors=2, timeouts=0, elapsed_s=4.0,
            latencies_ms=[10.0] * 8,
            ttfts_ms=[100.0, 100.0, 100.0, 100.0, 100.0, 900.0],
            slo_ttft_ms=500.0, replica_seconds=8.0)
    got = both(lambda side: (
        lambda r: (r.good_completions, r.goodput_rps, r.avg_replicas,
                   r.goodput_per_replica, "goodput" in repr(r)))(
        report(side)))
    assert got == (7, 7 / 4.0, 2.0, 7 / 8.0, True)


@pytest.mark.parametrize("workload,verdict", [
    ("multitenant", "warm-routing A/B"), ("structured", "structured A/B")])
def test_cli_workloads_run_on_the_cpu(quick_election, capsys, workload,
                                      verdict):
    """The grammar and LoRA workloads (which raised before their slice)
    end to end on ``--device cpu``: each A/B exits 0 and reports."""
    assert loadgen.main(["--workload", workload, "--device", "cpu",
                         "--requests", "6", "--rate-hz", "50"]) == 0
    assert verdict in capsys.readouterr().out


def test_cli_restart_replica_runs_on_the_cpu(quick_election, capsys):
    """A ported CLI mode end to end on ``--device cpu``: the warm-restart
    A/B exits 0 and says so."""
    assert loadgen.main(["--restart-replica", "--device", "cpu",
                         "--requests", "8"]) == 0
    assert "RESTART A/B OK" in capsys.readouterr().out


def test_compile_cache_ab_raises_naming_the_build_cache():
    with pytest.raises(NotImplementedError, match="kernel build cache"):
        loadgen.run_compile_cache_ab()


# --------------------------------------------------------------------------- #
# The rigs on the CPU, held to the JAX oracle

_JAX_PARAMS = {}
_ORACLE = {}


def jax_params():
    if "p" not in _JAX_PARAMS:
        _JAX_PARAMS["p"] = jax_llama.init_params(
            dataclasses.replace(jax_llama.CONFIGS["tiny"],
                                dtype=jnp.float32), jax.random.PRNGKey(0))
    return _JAX_PARAMS["p"]


def bridged():
    return params_from_numpy(jax.tree.map(np.asarray, jax_params()), "cpu")


def jax_oracle(prompt, max_new):
    """Greedy tokens of ``prompt`` from the JAX package's batch-1
    ``prefill`` + ``generate_tokens`` on :func:`jax_params`."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    key = (prompt.tobytes(), int(max_new))
    if key not in _ORACLE:
        config = jax_llama.CONFIGS[CONFIG]
        rows = ((len(prompt) + max_new + 15) // 16) * 16
        cache = jax_llama.init_cache(config, 1, rows)
        logits, cache = jax_llama.prefill(
            jax_params(), jnp.asarray(prompt)[None, :], cache, config)
        first = logits[:, -1].argmax(-1).astype(jnp.int32)[:, None]
        out = [int(first[0, 0])]
        if max_new > 1:
            generated, _ = jax_llama.generate_tokens(
                jax_params(), first, cache, jnp.int32(len(prompt)),
                max_new - 1, config)
            out += [int(t) for t in np.asarray(generated)[0]]
        _ORACLE[key] = out
    return _ORACLE[key]


def _assert_oracle_tokens(finals, payload_fn, index_of):
    assert finals
    for request_id, tokens in finals.items():
        payload = payload_fn(index_of(request_id))
        assert tokens == jax_oracle(payload["tokens"],
                                    int(payload["max_new_tokens"])), \
            request_id


def _by_index(request_id):
    return int(request_id.rsplit("_", 1)[1])


def _elastic_server():
    """The rigs' servers at the rigs' shape, with 64-row tables (12-token
    prompts, at most 48 new tokens) and a pool of 64 blocks: a migration's
    imported blocks stay lease-pinned for 30 s, and a smaller pool would
    defer admissions that long."""
    params = bridged()

    def make_server(_name):
        return PagedContinuousServer(
            config_name=CONFIG, params=params, device="cpu", slots=2,
            max_seq=64, total_blocks=64, chunk_steps=4, seed=0,
            enable_prefix_cache=True, max_queue=256, watchdog_s=5.0)
    return make_server


def test_run_elastic_chaos_drain_loses_nothing(quick_election):
    """tests/test_autoscaler.py:513's invariants on the port's rig: a
    scripted scale-down drain, a kill of a live replica, a failed and then
    slow-started replacement — the fleet converges to the target, nothing
    lost, duplicated or re-streamed; every final is the JAX oracle's."""
    report = loadgen.run_elastic_chaos(seed=0, duration_s=6.0,
                                       make_server=_elastic_server())
    assert report.lost == 0, report
    assert report.timeouts == 0, report
    assert report.duplicate_finals == 0, report
    stats = report.server_stats
    assert stats["stream_mismatches"] == 0
    assert stats["converged"] is True
    assert stats["drains"] >= 1
    assert stats["drain_completed"] >= 1
    assert stats["spawn_failures"] >= 1
    assert stats["slow_starts"] >= 1
    assert stats["deaths_observed"] >= 2
    assert stats["faults_fired"] >= 3
    assert stats["replicas_live"] == sum(stats["targets"].values())
    assert stats["graph_captures_steady_state"] == 0
    _assert_oracle_tokens(report.final_tokens, loadgen._elastic_payloads(
        seed=0, max_new_tokens=4, stream=True), _by_index)
    print(f"elastic chaos (CPU): TTFT p50 {report.ttft_p50_ms:.1f} ms, "
          f"servers built {stats['servers_built']}")


def test_run_rolling_upgrade_zero_downtime(quick_election):
    """tests/test_migration.py:355's invariants on the port's rig, two
    replicas: every replica replaced, at least one stream migrated and
    resumed on its source's tail rows, nothing lost or duplicated, the
    fleet converged; every final (migrated or not) is the JAX oracle's,
    so equal to an unmigrated run's."""
    report = loadgen.run_rolling_upgrade(duration_s=4.0, seed=0, replicas=2,
                                         make_server=_elastic_server())
    stats = report.server_stats
    assert report.lost == 0, (report, stats)
    assert report.timeouts == 0, (report, stats)
    assert report.duplicate_finals == 0, stats
    assert stats["stream_mismatches"] == 0, stats
    assert stats["upgrades_completed"] >= 2, stats
    assert stats["migrations_started"] >= 1, stats
    assert stats["converged"], stats
    assert stats["kv_tails_adopted"] >= stats["migrations_completed"], stats
    _assert_oracle_tokens(report.final_tokens, loadgen._elastic_payloads(
        seed=0, max_new_tokens=48, stream=True), _by_index)
    print(f"rolling upgrade (CPU): goodput {report.goodput_rps:.2f} req/s, "
          f"migrations {stats['migrations_completed']} of "
          f"{stats['migrations_started']}")


def test_run_restart_ab_warm_adopts_and_out_hits_cold(quick_election):
    """tests/test_kv_spill.py:479's gate on the port's rig: the arms are
    bit-exact (inside the rig), the warm arm adopted chains from the dead
    replica's spill directory and restored from disk, the cold arm adopted
    none, no checksum failed, and warm's hit rate beats cold's; the cold
    arm's finals are the JAX oracle's."""
    params = bridged()

    def make_server(_name, spill_dir):
        return PagedContinuousServer(
            config_name=CONFIG, params=params, device="cpu", slots=2,
            max_seq=208, chunk_steps=4, seed=0, enable_prefix_cache=True,
            total_blocks=20, host_tier_blocks=0, restore_blocks_per_step=16,
            chunk_prefill_tokens=64, spill_dir=spill_dir, max_queue=256,
            watchdog_s=10.0)
    cold, warm = loadgen.run_restart_ab(seed=0, make_server=make_server)
    for report in (cold, warm):
        assert report.lost == 0 and report.timeouts == 0, report
    assert (warm.prefix_hit_rate or 0.0) > (cold.prefix_hit_rate or 0.0), \
        (warm, cold)
    stats = warm.server_stats
    assert stats["kv_adopted_chains"] > 0
    assert stats["kv_disk_restores"] > 0
    assert stats["kv_checksum_failures"] == 0
    assert cold.server_stats["kv_adopted_chains"] == 0
    payloads = loadgen.longtail_payloads(n_prefixes=3, prefix_len=192,
                                         tail_len=8, seed=0)
    _assert_oracle_tokens(
        cold.final_tokens, payloads,
        lambda rid: int(rid[1:].split("_", 1)[0]) + _by_index(rid))
    print(f"restart A/B (CPU): mean TTFT cold "
          f"{np.mean(cold.ttfts_ms):.1f} ms, warm "
          f"{np.mean(warm.ttfts_ms):.1f} ms; hit rate cold "
          f"{cold.prefix_hit_rate:.3f}, warm {warm.prefix_hit_rate:.3f}")


def test_run_longtail_host_tier_out_hits_the_pool_alone(quick_election):
    """tests/test_kv_tier.py:375's capacity gate on the port's rig, its hit
    rates: the pool holds 52 blocks of a ~144-block working set; with the
    host tier on every hit comes through the tier and the rate beats the
    tier-off run's; every final is the JAX oracle's."""
    params = bridged()

    def run(host_tier_blocks):
        def make_server(_name):
            return PagedContinuousServer(
                config_name=CONFIG, params=params, device="cpu", slots=2,
                max_seq=400, chunk_steps=4, seed=0, enable_prefix_cache=True,
                total_blocks=52, host_tier_blocks=host_tier_blocks,
                restore_blocks_per_step=24, chunk_prefill_tokens=64,
                max_queue=256, watchdog_s=10.0)
        return loadgen.run_longtail(n_requests=18, warmup_requests=6,
                                    host_tier_blocks=host_tier_blocks,
                                    seed=0, make_server=make_server)
    tier_on, tier_off = run(160), run(0)
    for report in (tier_on, tier_off):
        assert report.lost == 0 and report.timeouts == 0, report
    assert (tier_on.prefix_hit_rate or 0.0) \
        > (tier_off.prefix_hit_rate or 0.0), (tier_on, tier_off)
    assert tier_on.prefix_hit_rate_host == 1.0
    assert tier_on.server_stats["kv_restores"] > 0
    assert tier_off.server_stats["kv_demotions"] == 0
    payloads = loadgen.longtail_payloads(n_prefixes=6, prefix_len=384,
                                         tail_len=8, seed=0)
    _assert_oracle_tokens(tier_on.final_tokens, payloads, _by_index)
    print(f"longtail (CPU): mean TTFT tier on "
          f"{np.mean(tier_on.ttfts_ms):.1f} ms, off "
          f"{np.mean(tier_off.ttfts_ms):.1f} ms")
