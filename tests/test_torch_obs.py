"""Port parity: the observability hooks of ``aiko_services_tpu_torch``
(the pool census and auditor, the capture ledger, the ``(profile)``
bracket on ``torch.profiler``, attribution and the doctor) against the
JAX package's scenarios (tests/test_pool_audit.py, test_compiles.py,
test_flight.py), on the CPU.

Where a function is deterministic the port's output equals the JAX
package's on the same input: ``integrate_flows``, ``attribute_steps``'s
table and ``doctor.render_report`` / ``bundle_summary`` on one bundle.
The hooks are passive: a paged server serves the same tokens and holds
the same pool bytes with the auditor, the ledger and a profile bracket
installed as without them.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from aiko_services_tpu.obs import attrib as jax_attrib
from aiko_services_tpu.obs import pool_audit as jax_pool_audit
from aiko_services_tpu.tools import doctor as jax_doctor
from aiko_services_tpu_torch import runtime, transport
from aiko_services_tpu_torch.obs import (attrib, compiles, flight, metrics,
                                         pool_audit, profiler, steplog,
                                         trace)
from aiko_services_tpu_torch.orchestration import serving
from aiko_services_tpu_torch.orchestration.continuous import (
    ContinuousReplica, DecodeRequest)
from aiko_services_tpu_torch.orchestration.paged import PagedContinuousServer
from aiko_services_tpu_torch.runtime import faults
from aiko_services_tpu_torch.tools import doctor
from aiko_services_tpu_torch.tools import profiler as profiler_tool
from aiko_services_tpu_torch.utils.sexpr import generate, parse

PROMPT = np.arange(1, 50, dtype=np.int32)           # 3 shareable blocks


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_cold():
    """Later test modules in the same worker count their own JAX
    compiles; drop what this module compiled once it is done."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _no_leaked_hooks():
    """Never let an installed auditor, ledger, profiler session, recorder
    or fault plan escape its test."""
    transport.reset_brokers()
    yield
    pool_audit.uninstall()
    compiles.uninstall()
    profiler.uninstall()
    steplog.uninstall()
    trace.uninstall()
    flight.uninstall()
    faults.uninstall()
    transport.reset_brokers()


@pytest.fixture()
def engine():
    return runtime.EventEngine(clock=runtime.VirtualClock())


def make_server(**kwargs):
    return PagedContinuousServer(config_name="tiny", device="cpu", slots=2,
                                 max_seq=96, chunk_steps=4, block_size=16,
                                 enable_prefix_cache=True,
                                 **dict(dict(seed=0), **kwargs))


def _warm(server, prompt=PROMPT, max_new=4):
    server.submit(DecodeRequest(request_id="warm", prompt=prompt,
                                max_new_tokens=max_new))
    return server.run_until_drained()[0].tokens


def _bundles(directory, trigger="*") -> list:
    return sorted(str(p) for p in pathlib.Path(directory).glob(
        f"capture_{trigger}_*.json"))


def _load(path) -> dict:
    with open(path) as handle:
        return json.load(handle)


# --------------------------------------------------------------------------- #
# obs/pool_audit.py

def test_flow_integration_identity_and_peaks():
    """tests/test_pool_audit.py::test_flow_integration_identity_and_peaks
    on the port."""
    accountant = pool_audit.PoolAccountant(
        service="unit", registry=metrics.MetricsRegistry())
    accountant.flow("alloc", 4, 4096)
    accountant.flow("demote", 1, 1024)
    accountant.flow("spill", 1, 1024)
    accountant.flow("disk_restore", 1, 1024)
    assert accountant.occupancy_from_flows("blocks") == \
        {"hbm": 3, "host": 0, "disk": 0}
    assert accountant.occupancy_from_flows("bytes") == \
        {"hbm": 3072, "host": 0, "disk": 0}
    assert accountant.occupancy["hbm"] == {"blocks": 3, "bytes": 3072}
    assert accountant.peak["hbm"] == {"blocks": 4, "bytes": 4096}
    assert accountant.peak["host"] == {"blocks": 1, "bytes": 1024}
    assert accountant.peak["disk"] == {"blocks": 1, "bytes": 1024}
    with pytest.raises(KeyError):
        accountant.flow("teleport", 1, 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_integrate_flows_equals_jax(seed):
    """The same cumulative flow counters integrate to the same per-tier
    occupancy in both packages, blocks and bytes."""
    rng = np.random.default_rng(seed)
    flows = {name: {"blocks": int(rng.integers(0, 50)),
                    "bytes": int(rng.integers(0, 10 ** 6))}
             for name in pool_audit.FLOWS}
    assert pool_audit.FLOWS == jax_pool_audit.FLOWS
    for field in ("blocks", "bytes"):
        assert pool_audit.integrate_flows(flows, field) == \
            jax_pool_audit.integrate_flows(flows, field)


def _ground_truth(server):
    block_bytes = server._block_nbytes()
    used = server.total_blocks - len(server._free)
    return {
        "blocks": {"hbm": used, "host": len(server._host),
                   "disk": len(server._spill)},
        "bytes": {"hbm": used * block_bytes,
                  "host": sum(int(entry["nbytes"])
                              for entry in server._host.values()),
                  "disk": sum(int(meta["nbytes"])
                              for meta in server._spill.values())},
    }


def _assert_reconciled(auditor, server):
    census = server.pool_census()
    truth = _ground_truth(server)
    for tier in pool_audit.TIERS:
        assert census["tiers"][tier]["blocks"] == truth["blocks"][tier]
        assert census["tiers"][tier]["bytes"] == truth["bytes"][tier]
    accountant = auditor.accountant
    assert accountant.occupancy_from_flows("blocks") == truth["blocks"]
    assert accountant.occupancy_from_flows("bytes") == truth["bytes"]
    states = census["states"]
    assert states["free"] + states["private"] + states["producing"] \
        + states["restoring"] + states["pinned"] \
        + states["evictable"] == census["total_blocks"]
    assert auditor.sweep(server) == []


def test_census_reconciles_exactly_on_live_tiered_engine(tmp_path):
    """census == ground truth == flow integral on a port engine driving
    all three tiers (demotion, spill, async restore), swept every step
    with no violation."""
    auditor = pool_audit.install(service="census_exact", sweep_every=1)
    server = make_server(host_tier_blocks=2,
                         spill_dir=str(tmp_path / "spill"),
                         restore_blocks_per_step=1)
    want = _warm(server)
    _assert_reconciled(auditor, server)
    while server._evict_one():
        pass
    assert len(server._host) == 2 and len(server._spill) == 1
    _assert_reconciled(auditor, server)
    assert _warm(server) == want
    stats = server.stats()
    assert stats["kv_restores"] + stats["kv_disk_restores"] == 3
    assert stats["kv_audit_sweeps"] > 3
    assert stats["kv_audit_violations"] == 0
    _assert_reconciled(auditor, server)
    assert auditor.accountant.peak["disk"]["blocks"] == 1
    record = server.pool_census()["blocks"][0]
    assert {"tier", "key", "depth", "bytes", "refs", "state"} <= set(record)


def test_kv_wire_import_books_its_alloc_flow():
    """An imported prefix (kvstore/transfer.py) books its pool inflow:
    the importer's flow integral still equals its census."""
    auditor = pool_audit.install(service="import", sweep_every=1)
    owner = make_server()
    want = _warm(owner)
    importer = make_server()
    payload = owner.kv_export_payload(owner.prefix_keys_hex(PROMPT), 0)
    before = auditor.accountant.occupancy_from_flows("blocks")["hbm"]
    assert importer.kv_import_payload(payload) == 3
    flows = auditor.accountant.occupancy_from_flows("blocks")
    assert flows["hbm"] == before + 3
    assert _warm(importer) == want
    assert auditor.sweep(importer) == []


def test_metrics_scrape_emits_help_and_type(engine):
    auditor = pool_audit.install(service="prom", sweep_every=1)
    server = make_server()
    _warm(server)
    assert auditor.sweep(server) == []
    process = runtime.Process(namespace="pa", hostname="h", pid="1",
                              engine=engine, broker="pamet")
    actor = runtime.compose_instance(runtime.Actor,
                                     runtime.actor_args("svc_m"),
                                     process=process)
    scraped = []

    def handler(_topic, payload):
        command, params = parse(payload)
        if command == "metrics_response":
            scraped.append(params[1])
    process.add_message_handler(handler, "pa/met_reply")
    process.message.publish(actor.topic_in,
                            generate("metrics", ["pa/met_reply"]))
    engine.drain()
    text, = scraped
    assert "# HELP aiko_kv_bytes KV pool bytes resident per tier" in text
    for kind, name in (("gauge", "aiko_kv_blocks"),
                       ("gauge", "aiko_kv_blocks_by_state"),
                       ("counter", "aiko_kv_flow_blocks_total"),
                       ("counter", "aiko_kv_flow_bytes_total"),
                       ("counter", "aiko_kv_audit_sweeps_total"),
                       ("counter", "aiko_kv_audit_violations_total")):
        assert f"# TYPE {name} {kind}" in text
    for tier in pool_audit.TIERS:
        assert f'aiko_kv_bytes{{tier="{tier}"}}' in text
    assert 'aiko_kv_flow_blocks_total{flow="alloc"}' in text


@pytest.mark.parametrize("point,needle", [
    ("leak_block", "unattributed"),
    ("skew_refcount", "refcount skew"),
], ids=["leak_block", "skew_refcount"])
def test_pool_fault_caught_in_one_sweep_serving_bit_exact(tmp_path, point,
                                                          needle):
    want = _warm(make_server())
    auditor = pool_audit.install(service="faulted", sweep_every=1)
    flight.install(out_dir=str(tmp_path), service="faulted",
                   min_interval_s=60.0)
    server = make_server()
    _warm(server)
    assert auditor.violations_total == 0
    faults.install(faults.FaultPlan().add(point, nth=1))
    server.submit(DecodeRequest(request_id="probe", prompt=PROMPT,
                                max_new_tokens=4))
    server.step()
    assert auditor.violations_total > 0
    assert any(needle in v for v in auditor.last_violations)
    finished = server.run_until_drained()
    assert [r.request_id for r in finished] == ["probe"]
    assert finished[0].tokens == want
    paths = _bundles(tmp_path, "pool_audit")
    assert len(paths) == 1
    bundle = _load(paths[0])
    assert needle in bundle["manifest"]["reason"]
    assert bundle["census"]["violations_total"] >= 1


def test_router_census_fans_out_and_the_doctor_folds_it(tmp_path, engine,
                                                        capsys):
    """One ``(census)`` at the router: a bundle from the router and from
    every replica on one minted trace id; the replica carrying a paged
    engine lands its census in the accountant first; both doctors render
    the fleet's memory total."""
    process = runtime.Process(namespace="fl", hostname="h", pid="15",
                              engine=engine, broker="flcensus")
    router = runtime.compose_instance(serving.ReplicaRouter,
                                      runtime.actor_args("router"),
                                      process=process)
    replicas = [runtime.compose_instance(runtime.Actor,
                                         runtime.actor_args(f"rep{i}"),
                                         process=process) for i in (1, 2)]
    router._replicas = [replica.topic_path for replica in replicas]
    auditor = pool_audit.install(service="fleet", sweep_every=4)
    replicas[0].server = make_server()
    _warm(replicas[0].server)
    flight.install(out_dir=str(tmp_path), service="fleet")
    replies = []

    def handler(_topic, payload):
        command, params = parse(payload)
        if command == "census_response":
            replies.append(params)
    process.add_message_handler(handler, "fl/census_reply")
    process.message.publish(router.topic_in, generate(
        "census", ["", "fl/census_reply", "fleet smoke"]))
    engine.drain()
    bundles = [_load(path) for path in _bundles(tmp_path)]
    assert len(bundles) == 3
    trace_ids = {b["manifest"]["trace_id"] for b in bundles}
    assert len(trace_ids) == 1
    assert router.counters["fleet_censuses"] == 1
    assert sorted(name for name, _ in replies) == ["rep1", "rep2", "router"]
    assert auditor.accountant.last_census["tiers"]["hbm"]["blocks"] > 0
    assert doctor.main([str(tmp_path)]) == 0
    report = capsys.readouterr().out
    assert jax_doctor.main([str(tmp_path)]) == 0
    assert capsys.readouterr().out == report
    assert f"fleet capture {trace_ids.pop()} (3 processes" in report
    assert "fleet memory (2 censuses): hbm" in report
    assert "pool census:" in report


# --------------------------------------------------------------------------- #
# obs/compiles.py

def test_ledger_books_labeled_captures_and_fence():
    ledger = compiles.install(service="unit")
    with compiles.label("serve_chunk", "s2"):
        ledger.record_compile(12.5)
    assert (ledger.compiles, ledger.steady_compiles) == (1, 0)
    entry = ledger.records[-1]
    assert (entry["program"], entry["signature"]) == ("serve_chunk", "s2")
    ledger.fence()
    ledger.record_compile(3.0, program="serve_chunk", signature="s4")
    assert ledger.steady_compiles == 1 and ledger.records[-1]["steady"]
    ledger.lift_fence()
    ledger.record_compile(1.0, program="spec_round")
    assert ledger.steady_compiles == 1
    assert ledger.signatures("serve_chunk") == [("serve_chunk", "s2"),
                                                ("serve_chunk", "s4")]


def test_capture_ledger_forwards_and_kernel_library_counts():
    """An engine's capture ledger forwards each capture (its host ms and
    graph key) to the process ledger under the dispatch site's label; the
    kernel library's lookups book as cache hits (with the build ms they
    saved) or misses, never as captures."""
    engine_ledger = compiles.CaptureLedger()
    engine_ledger.record_capture(5.0, signature="k0")   # no LEDGER: local
    ledger = compiles.install(service="unit")
    with compiles.label("serve_chunk", "s2"):
        engine_ledger.record_capture(7.0, signature="('contiguous', 3)")
    assert engine_ledger.counters()["graph_captures"] == 2
    assert ledger.compiles == 1
    assert ledger.records[-1]["program"] == "serve_chunk"
    assert ledger.records[-1]["signature"] == "('contiguous', 3)"
    compiles.record_kernel_build("libaiko_kernels_x.so", False, 9000.0)
    compiles.record_kernel_build("libaiko_kernels_x.so", True, 2.0, 8998.0)
    snap = ledger.snapshot()
    assert (snap["cache_misses"], snap["cache_hits"]) == (1, 1)
    assert snap["cache_saved_ms"] == pytest.approx(8998.0)
    assert snap["compiles"] == 1
    assert ledger.signatures() == [("serve_chunk", "('contiguous', 3)")]


def test_steady_capture_fires_flight_capture(tmp_path):
    flight.install(out_dir=str(tmp_path), service="unit")
    ledger = compiles.install(service="unit")
    ledger.fence()
    with compiles.label("serve_chunk", "s4"):
        compiles.CaptureLedger().record_capture(40.0)
    bundle = _load(_bundles(tmp_path)[0])
    assert bundle["manifest"]["trigger"] == "compile"
    assert "serve_chunk[s4]" in bundle["manifest"]["reason"]
    assert bundle["compiles"]["compiles_steady_state"] == 1
    assert bundle["compiles"]["records"][-1]["program"] == "serve_chunk"


def test_compilation_cache_dir_still_raises_by_name():
    with pytest.raises(NotImplementedError, match="compilation"):
        make_server(compilation_cache_dir="/nowhere")


# --------------------------------------------------------------------------- #
# obs/profiler.py, the (profile) bracket, flight sections and the doctor

def test_profile_bracket_measures_step_ms_and_lands_in_doctor(tmp_path):
    """tests/test_compiles.py's bracket scenario on the port: the engine
    claims the session, runs its steps synchronously in the
    torch.profiler trace, writes the manifest beside the exported trace,
    and the bracket's bundle renders in both doctors alike."""
    flight.install(out_dir=str(tmp_path / "flight"), service="prof")
    compiles.install(service="prof")
    steplog.install()
    server = make_server()
    rng = np.random.RandomState(0)

    def submit(tag, count=2):
        for index in range(count):
            server.submit(DecodeRequest(
                request_id=f"{tag}{index}",
                prompt=rng.randint(1, 64, size=12).astype(np.int32),
                max_new_tokens=8))
    submit("warm")
    server.run_until_drained()
    assert server.request_profile(steps=4, reason="test bracket",
                                  out_dir=str(tmp_path / "prof"))
    assert not server.request_profile(steps=4)      # one at a time
    submit("p")
    server.run_until_drained()
    stats = server.stats()
    assert stats["profiles"] == 1 and stats["device_step_ms"] > 0
    manifest = profiler.LAST
    assert manifest["ok"] and manifest["steps"] >= 4
    assert manifest["timing"] == "host_clock"      # a CPU engine
    assert {a["path"] for a in manifest["artifacts"]} >= {"trace.json"}
    trace_dir = pathlib.Path(manifest["trace_dir"])
    assert json.loads((trace_dir / "manifest.json").read_text())[
        "device_step_ms"] == manifest["device_step_ms"]
    assert profiler.PROFILER is None
    bundle = _load(_bundles(tmp_path / "flight")[-1])
    assert bundle["manifest"]["trigger"] == "profile"
    assert bundle["profile"]["device_step_ms"] == stats["device_step_ms"]
    assert set(bundle) >= {"manifest", "spans", "steplog", "counters",
                           "compiles", "profile"}
    report = doctor.render_report(bundle)
    assert "device profile" in report and "MEASURED" in report
    assert report == jax_doctor.render_report(bundle)
    summary = doctor.bundle_summary(bundle)
    assert summary == jax_doctor.bundle_summary(bundle)
    assert set(summary) == {
        "path", "trigger", "reason", "trace_id", "service", "pid",
        "captured_unix", "spans", "steplog", "tax_table",
        "counters_moved", "compiles", "profile", "census"}
    assert summary["profile"]["ok"] is True


def test_bundle_sections_share_one_trace_id(tmp_path):
    """tests/test_flight.py's bundle on the port, with the three sections
    the port now writes (compiles, profile, census), each on the
    bundle's trace id where it carries one."""
    tracer = trace.install(service="svc_a")
    steplog.install()
    with tracer.span("engine_step"):
        with tracer.span("decode_chunk"):
            pass
    steplog.RECORDER.record("dispatch", ring=1)
    steplog.RECORDER.record("sync", wait_ms=2.0, steps=2)
    compiles.install(service="svc_a").record_compile(
        1.0, program="serve_chunk", signature="s2")
    pool_audit.install(service="svc_a")
    profiler.LAST = {"format": profiler.MANIFEST_FORMAT, "steps": 2,
                     "device_step_ms": 1.5, "ok": True}
    recorder = flight.install(out_dir=str(tmp_path), service="svc_a")
    bundle = _load(recorder.capture("operator", reason="smoke"))
    tid = bundle["manifest"]["trace_id"]
    for section in ("spans", "steplog", "counters", "compiles", "census"):
        assert bundle[section]["trace_id"] == tid, section
    assert bundle["profile"]["device_step_ms"] == 1.5
    assert bundle["compiles"]["records"][-1]["signature"] == "s2"
    assert {s["name"] for s in bundle["spans"]["spans"]} == \
        {"engine_step", "decode_chunk"}
    assert doctor.render_report(bundle) == jax_doctor.render_report(bundle)


def _step_events(seed):
    rng = np.random.default_rng(seed)
    ts, events = 100.0, []
    for _ in range(6):
        for name in ("admission", "dispatch", "sync", "token_dispatch",
                     "commit"):
            ts += float(rng.uniform(0.1, 3.0)) / 1e3
            fields = {}
            if name == "sync":
                fields = {"wait_ms": float(rng.uniform(0.1, 2.0)),
                          "steps": 2}
            elif name == "token_dispatch":
                fields = {"ms": float(rng.uniform(0.01, 0.2))}
            events.append((ts, name, fields))
    return events


@pytest.mark.parametrize("device_step_ms", [None, 0.4])
def test_attribute_steps_table_equals_jax(device_step_ms):
    """The tax table (rows, shares, levers, render) equals the JAX
    package's on the same step events and wall time."""
    events = _step_events(3)
    wall = (events[-1][0] - events[0][0]) * 1e3 * 1.05
    got = attrib.attribute_steps(events, wall_ms=wall,
                                 device_step_ms=device_step_ms)
    want = jax_attrib.attribute_steps(events, wall_ms=wall,
                                      device_step_ms=device_step_ms)
    assert got.render() == want.render()
    assert [(r.component, r.ms, r.events, r.lever) for r in got.rows] == \
        [(r.component, r.ms, r.events, r.lever) for r in want.rows]
    assert attrib.LEVERS == jax_attrib.LEVERS
    assert got.within(0.10)


def test_probe_device_ms_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the probe's failure mode is the no-card one")
    with pytest.raises(RuntimeError, match="CUDA"):
        attrib.probe_device_ms(lambda: None)


def test_replica_answers_profile_started_and_census_a_bundle(tmp_path,
                                                             engine):
    """A port replica over a paged server: ``(profile 4)`` starts a
    bracket (a second while it is pending answers busy), and
    ``(census)`` answers a bundle path whose bundle has the census,
    profile and compiles sections; the doctor renders it."""
    pool_audit.install(service="wire", sweep_every=1)
    compiles.install(service="wire")
    flight.install(out_dir=str(tmp_path), service="wire")
    process = runtime.Process(namespace="test", hostname="h", pid="7",
                              engine=engine, broker="obswire")
    server = make_server()
    replica = runtime.compose_instance(
        ContinuousReplica, runtime.actor_args("obs0"), process=process,
        server=server)
    answers = {}

    def handler(_topic, payload):
        command, params = parse(payload)
        answers.setdefault(command, []).append(params[1])
    process.add_message_handler(handler, "test/ops")
    for command in ("(profile 4 tid test/ops)", "(profile 4 tid test/ops)"):
        process.message.publish(replica.topic_in, command)
        engine.drain()
    assert answers["profile_response"] == ["started", "busy"]
    for index in range(2):
        server.submit(DecodeRequest(f"w{index}", PROMPT + index, 8))
    server.run_until_drained()
    assert profiler.LAST["steps"] >= 4 and profiler.PROFILER is None
    process.message.publish(replica.topic_in, "(census tid test/ops)")
    engine.drain()
    path, = answers["census_response"]
    bundle = _load(path)
    assert set(bundle) >= {"census", "profile", "compiles"}
    assert bundle["census"]["census"]["tiers"]["hbm"]["blocks"] > 0
    assert doctor.main([path]) == 0


def test_hooks_are_passive_on_a_paged_server(tmp_path):
    """The auditor (sweeping every step), the ledger and a profile
    bracket installed: the same tokens and the same pool bytes as a
    server without them."""
    prompts = [np.arange(1, 40, dtype=np.int32),
               np.arange(5, 30, dtype=np.int32)]

    def serve(hooks):
        if hooks:
            pool_audit.install(service="passive", sweep_every=1)
            compiles.install(service="passive")
        server = make_server()
        if hooks:
            assert server.request_profile(steps=3,
                                          out_dir=str(tmp_path / "prof"))
        requests = [DecodeRequest(f"r{i}", prompt, 10)
                    for i, prompt in enumerate(prompts)]
        for request in requests:
            server.submit(request)
        server.run_until_drained()
        if hooks:
            assert profiler.LAST["steps"] >= 3
            assert pool_audit.AUDITOR.violations_total == 0
        pool_audit.uninstall()
        compiles.uninstall()
        return [r.tokens for r in requests], server

    plain_tokens, plain = serve(False)
    hooked_tokens, hooked = serve(True)
    assert hooked_tokens == plain_tokens
    for want_layer, got_layer in zip(plain.pool, hooked.pool):
        for key in want_layer:
            assert torch.equal(got_layer[key][1:], want_layer[key][1:]), key
    assert hooked.stats()["graph_captures"] == 0


def test_profiler_actor_traces_on_torch_profiler(tmp_path, engine):
    """The standalone profiler actor: start, stop (a Chrome trace in the
    directory the share names), status."""
    process = runtime.Process(namespace="test", hostname="h", pid="3",
                              engine=engine, broker="profactor")
    actor = runtime.compose_instance(profiler_tool.ProfilerActor,
                                     runtime.actor_args("prof"),
                                     process=process)
    trace_dir = str(tmp_path / "trace")
    actor.profile_start(trace_dir)
    assert actor.share["profiling"] is True
    torch.ones(4).sum()
    actor.profile_stop()
    assert actor.share["profiling"] is False
    assert actor.share["last_trace_dir"] == trace_dir
    assert (pathlib.Path(trace_dir) / "trace.json").exists()
