"""Port parity: the jax-free pieces the wire runs on.

The port keeps its own copies of the JAX package's runtime, transport,
share, metrics, tracing, step log, flight recorder and fault plan; each
scenario runs on both packages and the two must agree: the same timer
firings, the same deliveries, the same strings and numbers.  The fault
plan's zero-cost discipline is held on the port's modules by AST guards,
as tests/test_faults.py holds it on the reference's.
"""

import ast
import json
import pathlib
import types

import jax
import numpy as np
import pytest

from aiko_services_tpu import registry as jax_registry
from aiko_services_tpu import runtime as jax_runtime
from aiko_services_tpu import transport as jax_transport
from aiko_services_tpu.obs import metrics as jax_metrics
from aiko_services_tpu.obs import trace as jax_trace
from aiko_services_tpu.orchestration import serving as jax_serving
from aiko_services_tpu.pipeline import codec as jax_codec
from aiko_services_tpu.runtime import faults as jax_faults
from aiko_services_tpu.utils import sexpr as jax_sexpr
from aiko_services_tpu_torch import registry, runtime, transport
from aiko_services_tpu_torch.obs import flight, metrics, steplog, trace
from aiko_services_tpu_torch.orchestration import continuous, serving
from aiko_services_tpu_torch.pipeline import codec
from aiko_services_tpu_torch.runtime import faults
from aiko_services_tpu_torch.utils import sexpr

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "aiko_services_tpu_torch"

SIDES = {
    "jax": types.SimpleNamespace(
        runtime=jax_runtime, transport=jax_transport, registry=jax_registry,
        metrics=jax_metrics, faults=jax_faults, sexpr=jax_sexpr,
        serving=jax_serving, codec=jax_codec),
    "torch": types.SimpleNamespace(
        runtime=runtime, transport=transport, registry=registry,
        metrics=metrics, faults=faults, sexpr=sexpr, serving=serving,
        codec=codec),
}


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_cold():
    """Later test modules in the same worker count their own JAX
    compiles; drop whatever this module compiled once it is done."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _port_side_isolated():
    transport.reset_brokers()
    yield
    faults.uninstall()
    flight.uninstall()
    steplog.uninstall()
    transport.reset_brokers()


def _both(scenario):
    """``scenario(side)`` on both packages: ``(jax result, port result)``."""
    return scenario(SIDES["jax"]), scenario(SIDES["torch"])


# --------------------------------------------------------------------------- #
# metrics


def _metrics_scenario(side):
    registry_ = side.metrics.MetricsRegistry()
    rng = np.random.default_rng(5)
    labels = {"instance": "srv0"}
    histogram = registry_.histogram("aiko_latency_ttft_ms", help="TTFT.",
                                    labels=labels)
    for value in rng.lognormal(3.0, 1.2, 500):
        histogram.observe(float(value))
    registry_.counter("aiko_requests_total", labels=labels).inc(7)
    counters = side.metrics.CounterDict(dict(shed=0, decode_steps=0),
                                        prefix="server", labels=labels,
                                        registry=registry_)
    counters["shed"] += 3
    counters["decode_steps"] = 1234
    merged = side.metrics.Histogram.merged(
        [histogram, side.metrics.Histogram.decode(histogram.encode())])
    return dict(encoded=histogram.encode(),
                quantiles=[histogram.quantile(q) for q in
                           (0.5, 0.9, 0.95, 0.99)],
                merged=merged.encode(), text=registry_.to_prometheus(),
                snapshot=registry_.snapshot())


def test_metrics_match_jax():
    """Histograms (buckets, encoding, quantiles, merge), counters, the
    engine CounterDict's gauges and the Prometheus text are the JAX
    package's."""
    jax_out, port_out = _both(_metrics_scenario)
    assert port_out == jax_out
    assert "aiko_server_shed{instance=\"srv0\"} 3" in port_out["text"]
    assert "aiko_latency_ttft_ms_bucket{instance=\"srv0\",le=\"+Inf\"} 500" \
        in port_out["text"]


def test_server_counters_and_histograms_reach_the_registry():
    """A port server's counters mirror into the process registry under
    its instance label, and its latency histograms are registered there."""
    server = continuous.ContinuousBatchingServer(
        config_name="tiny", slots=1, max_seq=32, chunk_steps=2,
        device="cpu")
    server.counters["shed"] += 2
    label = f"srv{server._instance_id}"
    text = metrics.REGISTRY.to_prometheus()
    assert f'aiko_server_shed{{instance="{label}"}} 2' in text
    assert f'aiko_server_watchdog_trips{{instance="{label}"}} 0' in text
    assert set(server.latency_hists) == {"ttft", "total", "queue",
                                         "prefill", "decode", "kv_restore"}
    assert server.latency_hists["ttft"] is metrics.REGISTRY.histogram(
        "aiko_latency_ttft_ms", labels={"instance": label})


# --------------------------------------------------------------------------- #
# faults


@pytest.mark.parametrize("spec", [
    "seed=7;stall_step:nth=3:ms=80",
    "seed=3;drop_message:prob=0.3:match=infer_partial",
    "seed=11;kill_replica:nth=2:hard=1;corrupt_response:prob=0.5"])
def test_fault_plans_fire_as_in_jax(spec):
    """The same spec fires on the same calls with the same parameters."""
    def scenario(side):
        plan = side.faults.plan_from_spec(spec)
        hits = []
        for index in range(40):
            for point in ("stall_step", "drop_message", "kill_replica",
                          "corrupt_response"):
                key = "t (infer_partial r)" if index % 2 else "t (x)"
                hits.append(plan.check(point, key=key))
        return hits, plan.fired, repr(plan)
    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    assert any(hit is not None for hit in port_out[0])


def test_fault_plan_rejects_what_jax_rejects():
    for side in SIDES.values():
        with pytest.raises(ValueError):
            side.faults.FaultPlan().add("not_a_point", nth=1)
        with pytest.raises(ValueError):
            side.faults.FaultPlan().add("stall_step")


def _is_plan_check(node) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "check"
            and isinstance(node.func.value, ast.Attribute)
            and node.func.value.attr == "PLAN"
            and isinstance(node.func.value.value, ast.Name)
            and node.func.value.value.id == "faults")


def _is_plan_guard(test) -> bool:
    return (isinstance(test, ast.Compare)
            and isinstance(test.ops[0], ast.IsNot)
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "PLAN")


_INJECTION_MODULES = ("orchestration/continuous.py", "runtime/process.py",
                      "runtime/lease.py")


@pytest.mark.parametrize("module", _INJECTION_MODULES)
def test_port_injection_sites_exist_and_are_guarded(module):
    """The port keeps the reference's fault sites, each under an
    ``if faults.PLAN is not None`` guard."""
    tree = ast.parse((PORT / module).read_text())
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.If) and _is_plan_guard(node.test):
            guarded.update(id(sub) for sub in ast.walk(node)
                           if _is_plan_check(sub))
    checks = [node for node in ast.walk(tree) if _is_plan_check(node)]
    assert checks, f"{module} lost its injection sites"
    assert all(id(node) in guarded for node in checks), module


def test_no_fault_code_in_the_ports_model_and_kernel_modules():
    for path in sorted((PORT / "models").glob("*.py")) \
            + sorted((PORT / "ops").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            assert not (isinstance(node, ast.Name) and node.id == "faults"), \
                f"{path.name}:{node.lineno} references faults"


def test_fault_sites_fire_on_the_port():
    """drop_message drops an inbound message, expire_lease expires a
    lease instead of extending it."""
    engine = runtime.EventEngine(clock=runtime.VirtualClock())
    process = runtime.Process(namespace="t", hostname="h", pid="1",
                              engine=engine, broker="faults")
    seen = []
    process.add_message_handler(lambda t, p: seen.append(p), "t/x")
    faults.install(faults.FaultPlan().add("drop_message", nth=1)
                   .add("expire_lease", nth=1))
    process.message.publish("t/x", "(a)")
    process.message.publish("t/x", "(b)")
    engine.drain()
    assert seen == ["(b)"]
    expired = []
    lease = runtime.Lease(10.0, "l1", lambda uuid: expired.append(uuid),
                          engine=engine)
    lease.extend()
    engine.drain()
    assert expired == ["l1"]


# --------------------------------------------------------------------------- #
# event engine, loopback broker, process, share


def _engine_scenario(side):
    rt = side.runtime
    engine = rt.EventEngine(clock=rt.VirtualClock())
    fired = []
    engine.add_timer_handler(lambda: fired.append(("tick", engine.now())),
                             0.25)
    engine.add_timer_handler(lambda: fired.append(("once", engine.now())),
                             0.4, once=True)
    engine.add_mailbox_handler(lambda name, item: fired.append((name, item)),
                               "box")
    engine.mailbox_put("box", "late", delay=0.3)
    engine.mailbox_put("box", "now")
    engine.add_queue_handler(lambda item: fired.append(("q", item)), "q")
    engine.queue_put(1, "q")
    for _ in range(10):
        engine.advance(0.1)
    return [(name, round(value, 6) if isinstance(value, float) else value)
            for name, value in fired]


def test_event_engine_fires_as_in_jax():
    jax_out, port_out = _both(_engine_scenario)
    assert port_out == jax_out
    assert ("once", 0.4) in port_out


def _broker_scenario(side):
    tr = side.transport
    tr.reset_brokers()
    got = []
    publisher = tr.LoopbackMessage(broker="b", lwt_topic="n/h/1/0/state",
                                   lwt_payload="(absent)")
    publisher.publish("n/h/1/0/state", "(ready)", retain=True)
    publisher.publish("n/a/b", "(one)")
    listener = tr.LoopbackMessage(
        message_handler=lambda topic, payload: got.append((topic, payload)),
        broker="b")
    listener.subscribe(["n/+/1/0/state", "n/#"])
    publisher.publish("n/a/b", "(two)")
    publisher.publish("x/y", "(missed)")
    publisher.disconnect(graceful=False)
    tr.reset_brokers()
    return got


def test_loopback_broker_delivers_as_in_jax():
    """Retained replay to a late subscriber, ``+``/``#`` wildcards and
    the last will on an ungraceful disconnect."""
    jax_out, port_out = _both(_broker_scenario)
    assert port_out == jax_out
    assert ("n/h/1/0/state", "(absent)") in port_out


def test_create_message_names_mqtt():
    """The port's transport factory builds the loopback broker only."""
    message = transport.create_message("loopback", broker="factory")
    assert isinstance(message, transport.LoopbackMessage)
    for name in ("mqtt", "null"):
        with pytest.raises(NotImplementedError, match="MQTT"):
            transport.create_message(name)


def _share_scenario(side):
    rt, reg = side.runtime, side.registry
    engine = rt.EventEngine(clock=rt.VirtualClock())
    a = rt.Process(namespace="t", hostname="h", pid="1", engine=engine,
                   broker="share")
    b = rt.Process(namespace="t", hostname="h", pid="2", engine=engine,
                   broker="share")
    actor = rt.compose_instance(rt.Actor, rt.actor_args("producer"),
                                process=a)
    cache = {}
    reg.ECConsumer(b, cache, f"{actor.topic_path}/control")
    engine.drain()
    actor.ec_producer.update("slots_active", 3)
    actor.ec_producer.update("hist.ttft", "h1:1:2:3=1")
    actor.ec_producer.remove("log_level")
    engine.drain()
    # The actor's module name is its package's own.
    cache["source_file"] = cache["source_file"].split(".", 1)[1]
    return actor.topic_path, sorted(cache.items())


def test_ec_share_replicates_as_in_jax():
    jax_out, port_out = _both(_share_scenario)
    assert port_out == jax_out
    assert ("slots_active", "3") in port_out[1]


def test_model_replica_answers_infer():
    """ModelReplica (serving.py's jax-free replica) answers
    (infer …) with its function's outputs, on both packages alike."""
    def scenario(side):
        rt = side.runtime
        engine = rt.EventEngine(clock=rt.VirtualClock())
        process = rt.Process(namespace="t", hostname="h", pid="3",
                             engine=engine, broker="model")
        replica = rt.compose_instance(
            side.serving.ModelReplica, rt.actor_args("m"), process=process,
            infer=lambda inputs: {"tokens_out": np.asarray(
                inputs["tokens"], np.int32)[::-1].copy()})
        got = []
        process.add_message_handler(lambda t, p: got.append(p), "t/resp")
        process.message.publish(replica.topic_in, side.sexpr.generate(
            "infer", ["r1", "t/resp", side.codec.encode_swag(
                {"tokens": np.arange(4, dtype=np.int32)})]))
        process.message.publish(replica.topic_in, side.sexpr.generate(
            "adapter_load", ["a1", "t/resp", side.codec.encode_swag(
                {"name": "x"})]))
        engine.drain()
        return got, replica.share["requests_served"]
    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    assert port_out[1] == 1


def test_serving_telemetry_projects_as_in_jax():
    """The operator projection keeps the reference's keys and types; the
    port adds its CUDA graph ledger's three counters."""
    stats = dict(slots_active=2, queue_depth=1, decode_steps_per_sec=12.345,
                 decode_attention_path="kernel", healthy=1, shed=0,
                 graph_replays=5, graph_captures=2,
                 graph_captures_steady_state=0, not_a_key=9)
    port = serving.serving_telemetry(stats)
    reference = jax_serving.serving_telemetry(stats)
    assert {k: v for k, v in port.items()
            if not k.startswith("graph_")} == reference
    assert (port["graph_replays"], port["graph_captures"]) == (5, 2)
    assert set(jax_serving.TELEMETRY_KEYS) < set(serving.TELEMETRY_KEYS)


# --------------------------------------------------------------------------- #
# tracing, step log, flight recorder


def test_trace_context_and_spans_cross_the_packages():
    """A context injected by one package extracts in the other, and span
    trees encoded by the port's replica decode in the JAX package."""
    tracer = trace.Tracer(service="port", seed=1)
    root = tracer.start_span("infer")
    carrier = trace.inject(root)
    context = jax_trace.extract(carrier)
    assert (context.trace_id, context.span_id) == (root.trace_id,
                                                   root.span_id)
    child = trace.synth_span("replica", carrier, "cb0", 10.0, 10.5,
                             attrs={"request_id": "r"})
    child.mark("first_token", 10.1)
    decoded = jax_trace.decode_spans(trace.encode_spans([child]))
    assert [span.to_dict() for span in decoded] == [child.to_dict()]
    assert trace.decode_spans(jax_trace.encode_spans(decoded))[0] \
        .to_dict() == child.to_dict()


def test_traced_request_carries_replica_spans():
    """A request with a ``trace`` context answers with the replica's
    phase spans (replica, queue, prefill, decode) under it."""
    server = continuous.ContinuousBatchingServer(
        config_name="tiny", slots=1, max_seq=32, chunk_steps=2,
        device="cpu")
    engine = runtime.EventEngine(clock=runtime.VirtualClock())
    process = runtime.Process(namespace="t", hostname="h", pid="4",
                              engine=engine, broker="traced")
    replica = runtime.compose_instance(
        continuous.ContinuousReplica, runtime.actor_args("cbtr"),
        process=process, server=server)
    got = []
    process.add_message_handler(lambda t, p: got.append(p), "t/resp")
    process.message.publish(replica.topic_in, sexpr.generate(
        "infer", ["r1", "t/resp", codec.encode_swag(
            {"tokens": np.arange(1, 6, dtype=np.int32),
             "max_new_tokens": 3, "trace": "00aa/00bb"})]))
    for _ in range(2000):
        engine.advance(0.001)
        if got:
            break
    _, params = sexpr.parse(got[0])
    outputs = codec.decode_swag(params[1])
    spans = jax_trace.decode_spans(outputs["trace_spans"])
    assert [span.name for span in spans] == ["replica", "queue", "prefill",
                                             "decode"]
    assert {span.trace_id for span in spans} == {"00aa"}
    assert spans[0].parent_id == "00bb"


def test_steplog_records_the_servers_events():
    recorder = steplog.install()
    server = continuous.ContinuousBatchingServer(
        config_name="tiny", slots=2, max_seq=32, chunk_steps=2,
        device="cpu")
    for index in range(2):
        server.submit(continuous.DecodeRequest(
            f"r{index}", np.arange(1, 6, dtype=np.int32), 4))
    server.run_until_drained()
    counts = recorder.counts()
    for event in ("admission", "sampling_edit", "state_upload", "dispatch",
                  "sync", "token_dispatch", "commit"):
        assert counts.get(event, 0) > 0, counts
    commits = sum(fields["tokens"] for _, name, fields in recorder.events()
                  if name == "token_dispatch")
    assert commits == 8


def test_flight_bundle_on_a_watchdog_trip(tmp_path):
    """A watchdog trip writes a capture bundle with the manifest, spans,
    step log and counters sections, and none of the three sections whose
    modules the port does not have yet."""
    flight.install(out_dir=str(tmp_path), service="port")
    steplog.install()
    server = continuous.ContinuousBatchingServer(
        config_name="tiny", slots=1, max_seq=32, chunk_steps=2,
        device="cpu", watchdog_s=0.01)
    faults.install(faults.FaultPlan().add("stall_step", nth=1, ms=60))
    server.submit(continuous.DecodeRequest(
        "w", np.arange(1, 6, dtype=np.int32), 8, trace_ctx="00cc/00dd"))
    done = []
    while not done:
        done.extend(server.step())
    assert done[0].error == "watchdog_stalled"
    bundles = sorted(tmp_path.glob("capture_*.json"))
    triggers = [json.loads(path.read_text())["manifest"]["trigger"]
                for path in bundles]
    assert "watchdog" in triggers
    bundle = json.loads(bundles[triggers.index("watchdog")].read_text())
    assert set(bundle) == {"manifest", "spans", "steplog", "counters"}
    assert bundle["manifest"]["trace_id"] == "00cc"
    assert bundle["steplog"]["counts"]["dispatch"] > 0
    assert flight.FLIGHT.captures >= 1
