"""Port parity: the ``(infer …)`` wire.

The port's ``ContinuousReplica`` on its own actor runtime and loopback
broker against the JAX package's, on the reference's wire scenarios
(tests/test_continuous.py: wire protocol, streaming partials, cancel and
latency, telemetry in the share).  Both replicas serve an f32 copy of
``tiny`` (registered in both config tables for the test) on the SAME
weights: the JAX server builds them from its seed and the port receives
them through the weight bridge; tokens and streamed partials must be
equal.  Payloads cross between the packages both ways, the two codecs
give the same strings, and the server's robustness scenarios of
tests/test_faults.py (deadlines, shedding, the watchdog, InferClient's
wait, timeout and cancel) run on the port.
"""

import contextlib
import dataclasses
import json
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from aiko_services_tpu import runtime as jax_runtime
from aiko_services_tpu import transport as jax_transport
from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.orchestration import client as jax_client
from aiko_services_tpu.orchestration import continuous as jax_continuous
from aiko_services_tpu.orchestration import paged as jax_paged
from aiko_services_tpu.pipeline import codec as jax_codec
from aiko_services_tpu.utils import sexpr as jax_sexpr
from aiko_services_tpu_torch import runtime, transport
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.models.bridge import params_from_numpy
from aiko_services_tpu_torch.obs import flight
from aiko_services_tpu_torch.orchestration import client, continuous
from aiko_services_tpu_torch.orchestration.paged import PagedContinuousServer
from aiko_services_tpu_torch.pipeline import codec
from aiko_services_tpu_torch.runtime import faults
from aiko_services_tpu_torch.utils import sexpr

CONFIG = "tiny_f32"

#: Each package's side of the wire: its runtime, replica, client and codec.
SIDES = {
    "jax": types.SimpleNamespace(
        runtime=jax_runtime, continuous=jax_continuous, client=jax_client,
        codec=jax_codec, sexpr=jax_sexpr, transport=jax_transport),
    "torch": types.SimpleNamespace(
        runtime=runtime, continuous=continuous, client=client, codec=codec,
        sexpr=sexpr, transport=transport),
}


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_cold():
    """Later test modules in the same worker count their own JAX
    compiles; drop what this module compiled once it is done."""
    yield
    jax.clear_caches()


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


def _servers(**kwargs):
    """``{"jax": server, "torch": server}`` on the JAX server's weights."""
    jax_server = jax_continuous.ContinuousBatchingServer(
        config_name=CONFIG, **kwargs)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_server.params),
                               "cpu")
    kwargs.pop("seed", None)
    port_server = continuous.ContinuousBatchingServer(
        config_name=CONFIG, params=params, device="cpu", **kwargs)
    return {"jax": jax_server, "torch": port_server}


def reference_greedy(server, prompt, max_new):
    """Batch-1 oracle on the port server's own params."""
    config = server.config
    prompt = torch.from_numpy(np.asarray(prompt, np.int32))[None, :]
    cache = llama.init_cache(config, 1, server.max_seq, device="cpu")
    logits, cache = llama.prefill(server.params, prompt, cache, config)
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    if max_new == 1:
        return [int(first[0, 0])]
    tokens, _ = llama.generate_tokens(server.params, first, cache,
                                      prompt.shape[1], max_new - 1, config)
    return [int(first[0, 0])] + tokens[0].tolist()


class Wire:
    """One package's replica on a loopback broker, driven by a virtual
    clock; every message on ``test/responses`` is kept decoded."""

    def __init__(self, side, server, broker, name="cb0", pid="9",
                 decoder=None):
        self.side = SIDES[side]
        rt = self.side.runtime
        self.engine = rt.EventEngine(clock=rt.VirtualClock())
        self.process = rt.Process(namespace="test", hostname="h", pid=pid,
                                  engine=self.engine, broker=broker)
        self.server = server
        self.replica = rt.compose_instance(
            self.side.continuous.ContinuousReplica, rt.actor_args(name),
            process=self.process, server=server)
        decoder = decoder or self.side
        self.raw = []
        self.events = []

        def handler(_topic, payload):
            self.raw.append(payload)
            command, params = decoder.sexpr.parse(payload)
            self.events.append((command, str(params[0]),
                                decoder.codec.decode_swag(params[1])))
        self.process.add_message_handler(handler, "test/responses")

    def infer(self, request_id, prompt, encoder=None, **swag):
        encoder = encoder or self.side
        self.publish(encoder.sexpr.generate("infer", [
            request_id, "test/responses",
            encoder.codec.encode_swag(dict(tokens=np.asarray(prompt,
                                                             np.int32),
                                           **swag))]))

    def publish(self, payload):
        self.process.message.publish(self.replica.topic_in, payload)

    def run(self, until, steps=5000, dt=0.001):
        for _ in range(steps):
            self.engine.advance(dt)
            if until(self):
                return
        raise AssertionError(f"no answer: {self.events}")

    def responses(self, command="infer_response"):
        return {rid: out for cmd, rid, out in self.events if cmd == command}

    def partials(self):
        return [(rid, [int(t) for t in out["tokens_out"]])
                for cmd, rid, out in self.events if cmd == "infer_partial"]


def _tokens(outputs):
    return [int(t) for t in np.asarray(outputs["tokens_out"])]


# --------------------------------------------------------------------------- #
# The reference's four wire scenarios, on both packages


def test_wire_protocol_matches_jax():
    """(infer …) over each package's loopback broker -> infer_response
    with the greedy tokens; the pump retires itself when drained."""
    servers = _servers(slots=2, max_seq=64, chunk_steps=4, seed=6)
    prompt = np.arange(1, 10, dtype=np.int32)
    tokens = {}
    for side, server in servers.items():
        wire = Wire(side, server, "cont")
        wire.infer("q1", prompt, max_new_tokens=5)
        wire.run(lambda w: w.responses())
        outputs = wire.responses()["q1"]
        tokens[side] = _tokens(outputs)
        assert not wire.replica._pumping
    assert tokens["torch"] == tokens["jax"] == reference_greedy(
        servers["torch"], prompt, 5)


def test_streaming_partials_match_jax():
    """(infer … (stream: 1)) delivers the same infer_partial increments
    on both packages; their concatenation equals the final tokens, which
    equal the greedy oracle.  ``ring_max=2`` fixes the ring depth, which
    otherwise adapts to wall-clock waits."""
    servers = _servers(slots=2, max_seq=96, chunk_steps=3, seed=6,
                       ring_max=2)
    prompt = np.arange(1, 12, dtype=np.int32)
    partials, finals = {}, {}
    for side, server in servers.items():
        wire = Wire(side, server, "stream")
        wire.infer("s1", prompt, max_new_tokens=9, stream=1)
        wire.run(lambda w: w.responses())
        partials[side] = wire.partials()
        finals[side] = _tokens(wire.responses()["s1"])
        assert len(partials[side]) >= 2, partials[side]
        assert [t for _, inc in partials[side] for t in inc] \
            == finals[side]
        assert wire.replica._stream_sent == {}
    assert partials["torch"] == partials["jax"]
    assert finals["torch"] == finals["jax"] == reference_greedy(
        servers["torch"], prompt, 9)


def test_cancel_and_latency_match_jax():
    """(infer_cancel id) completes a queued request with error=cancelled
    on both packages; the served request's tokens are equal and carry
    ttft_ms / total_ms; the share's latency quantiles count served
    requests only."""
    servers = _servers(slots=1, max_seq=64, chunk_steps=2, seed=6)
    prompt = np.arange(1, 8, dtype=np.int32)
    tokens = {}
    for side, server in servers.items():
        wire = Wire(side, server, "cancel")
        for rid in ("run", "cancel_me"):
            wire.infer(rid, prompt, max_new_tokens=8)
        wire.publish(wire.side.sexpr.generate("infer_cancel", ["cancel_me"]))
        wire.run(lambda w: len(w.responses()) == 2)
        responses = wire.responses()
        assert responses["cancel_me"].get("error") == "cancelled"
        done = responses["run"]
        tokens[side] = _tokens(done)
        assert float(np.asarray(done["ttft_ms"])) >= 0
        assert float(np.asarray(done["total_ms"])) >= \
            float(np.asarray(done["ttft_ms"]))
        share = wire.replica.share
        assert float(share["ttft_p50_ms"]) >= 0
        assert float(share["total_p50_ms"]) >= float(share["ttft_p50_ms"])
        assert share["requests_served"] == 2
    assert tokens["torch"] == tokens["jax"] == reference_greedy(
        servers["torch"], prompt, 8)


def test_telemetry_in_share_matches_jax():
    """Slot occupancy and queue depth surface on the replica's EC share
    state topic while requests are live and return to zero once drained;
    the three requests' tokens are equal on both packages."""
    servers = _servers(slots=2, max_seq=64, chunk_steps=2, ring_max=2)
    prompt = np.arange(1, 6, dtype=np.int32)
    tokens = {}
    for side, server in servers.items():
        wire = Wire(side, server, "telemetry", name="cb_tel", pid="41")
        rt = wire.side.runtime
        peer = rt.Process(namespace="test", hostname="h", pid="42",
                          engine=wire.engine, broker="telemetry")
        updates = []

        def on_state(_topic, payload, parse=wire.side.sexpr.parse):
            command, args = parse(payload)
            if command == "update":
                updates.append((args[0], args[1]))
        peer.add_message_handler(on_state,
                                 f"{wire.replica.topic_path}/state")
        for i in range(3):
            peer.message.publish(wire.replica.topic_in, wire.side.sexpr
                                 .generate("infer", [
                                     f"t{i}", "test/responses",
                                     wire.side.codec.encode_swag({
                                         "tokens": prompt,
                                         "max_new_tokens": np.int64(6)})]))
        for _ in range(200):
            wire.engine.advance(0.01)
            wire.engine.drain()
            if not server.busy and not wire.replica._pumping:
                break
        active = [int(v) for k, v in updates if k == "slots_active"]
        queued = [int(v) for k, v in updates if k == "queue_depth"]
        assert max(active) == 2, updates
        assert max(queued) >= 1, updates
        assert wire.replica.share["slots_active"] == 0
        assert wire.replica.share["queue_depth"] == 0
        tokens[side] = {rid: _tokens(out)
                        for rid, out in wire.responses().items()}
    assert sorted(tokens["torch"]) == ["t0", "t1", "t2"]
    assert tokens["torch"] == tokens["jax"]


# --------------------------------------------------------------------------- #
# Payloads across the packages


@pytest.mark.parametrize("maker,reader", [("jax", "torch"),
                                          ("torch", "jax")])
def test_payloads_cross_between_the_packages(maker, reader):
    """An (infer …) payload built with one package's generate /
    encode_swag is served by the other package's replica, and its
    responses decode with the first package's parse / decode_swag: the
    tokens and partials equal those of the same payload served by the
    first package."""
    servers = _servers(slots=2, max_seq=64, chunk_steps=3, seed=6,
                       ring_max=2)
    prompt = np.arange(3, 14, dtype=np.int32)
    swag = dict(max_new_tokens=np.int64(7), stream=1, temperature=0.0,
                top_p=1.0, deadline_ms=60_000, trace="abcd/ef01")
    seen = {}
    for side in (maker, reader):
        wire = Wire(side, servers[side], "cross", decoder=SIDES[maker])
        wire.infer("x1", prompt, encoder=SIDES[maker], **swag)
        wire.run(lambda w: w.responses())
        outputs = wire.responses()["x1"]
        assert "trace_spans" in outputs
        seen[side] = (_tokens(outputs), wire.partials())
    assert seen[reader] == seen[maker]
    assert seen[reader][0] == reference_greedy(servers["torch"], prompt, 7)


CORPUS = [
    ("infer", ["q1", "test/responses", {"tokens": "n:abc", "k": "i:3"}]),
    ("infer_cancel", ["a b", None, ""]),
    ("update", ["slots_active", 2]),
    ("share", ["topic/a/b", "*", ["lifecycle", "log_level"]]),
    ("metrics_response", ["cb0", "# TYPE x gauge\nx 1\n"]),
    ("add", ["test/h/9/1", "cb0", "model_replica:0", "loopback", "*",
             ["a=1", "b=2"]]),
    ("x", [{"a": {"b": ["1", "2:", "'q'"]}}, "3:abc", "(", ")"]),
    ("empty", []),
]


@pytest.mark.parametrize("command,params", CORPUS)
def test_sexpr_strings_equal_on_the_corpus(command, params):
    text = sexpr.generate(command, params)
    assert text == jax_sexpr.generate(command, params)
    assert sexpr.parse(text) == jax_sexpr.parse(text)
    assert sexpr.parse_tree(text) == jax_sexpr.parse_tree(text)


SWAGS = [
    {"tokens": np.arange(1, 9, dtype=np.int32), "max_new_tokens": 5,
     "stream": 1, "temperature": 0.7, "top_p": 0.9, "adapter": None},
    {"k": np.zeros((2, 16, 4), np.float32), "flag": True, "j": [1, "a"]},
    {"bf16": np.arange(70_000, dtype=np.uint32).astype(np.uint16)},
    {"nested": {"a": [1, 2, {"b": 3.5}]}, "s": "a b (c)"},
]


@pytest.mark.parametrize("swag", SWAGS, ids=range(len(SWAGS)))
def test_swag_strings_equal_on_the_corpus(swag):
    encoded = codec.encode_swag(swag)
    assert encoded == jax_codec.encode_swag(swag)
    decoded, jax_decoded = (codec.decode_swag(encoded),
                            jax_codec.decode_swag(encoded))
    assert decoded.keys() == jax_decoded.keys()
    for key, value in decoded.items():
        if isinstance(value, np.ndarray):
            assert value.dtype == jax_decoded[key].dtype
            np.testing.assert_array_equal(value, jax_decoded[key])
        else:
            assert value == jax_decoded[key]


_atoms = st.one_of(st.text(max_size=12), st.integers(-10**6, 10**6),
                   st.none(), st.booleans())
_keys = st.from_regex(r"[a-z][a-z0-9_]{0,7}", fullmatch=True)
_trees = st.recursive(
    _atoms, lambda children: st.one_of(
        st.lists(children, max_size=4),
        st.dictionaries(_keys, children, min_size=1, max_size=3)),
    max_leaves=12)


@contextlib.contextmanager
def _jax_python_codec():
    """The JAX package's Python codec, its semantic definition, even where
    its C codec is built: the C codec emits a symbol holding non-ASCII
    whitespace (``\\xa0``) bare where the Python codec length-prefixes
    it.  Both strings parse to the same tree in either package."""
    saved = jax_sexpr._NATIVE
    jax_sexpr._NATIVE = False
    try:
        yield
    finally:
        jax_sexpr._NATIVE = saved


@settings(max_examples=150, deadline=None)
@given(command=_keys, params=st.lists(_trees, max_size=5))
def test_sexpr_strings_equal_under_hypothesis(command, params):
    text = sexpr.generate(command, params)
    tree = sexpr.parse(text)
    assert jax_sexpr.parse(text) == tree
    native = jax_sexpr.generate(command, params)
    assert sexpr.parse(native) == tree
    with _jax_python_codec():
        assert jax_sexpr.generate(command, params) == text
        assert jax_sexpr.parse(text) == tree


_arrays = st.one_of(
    st.lists(st.integers(-2**31, 2**31 - 1), max_size=64).map(
        lambda v: np.asarray(v, np.int32)),
    st.lists(st.floats(width=32, allow_nan=False), max_size=64).map(
        lambda v: np.asarray(v, np.float32)),
    st.lists(st.integers(0, 2**16 - 1), max_size=64).map(
        lambda v: np.asarray(v, np.uint16)))
_values = st.one_of(_arrays, st.integers(-10**9, 10**9),
                    st.floats(allow_nan=False), st.text(max_size=16),
                    st.booleans(), st.none(),
                    st.lists(st.integers(0, 9), max_size=4),
                    st.dictionaries(_keys, st.integers(0, 9), max_size=3))


@settings(max_examples=150, deadline=None)
@given(swag=st.dictionaries(_keys, _values, min_size=1, max_size=5))
def test_swag_strings_equal_under_hypothesis(swag):
    encoded = codec.encode_swag(swag)
    assert encoded == jax_codec.encode_swag(swag)
    payload = sexpr.generate("infer", ["r", "t", encoded])
    with _jax_python_codec():
        assert payload == jax_sexpr.generate("infer", ["r", "t", encoded])
    assert sexpr.parse(jax_sexpr.generate("infer", ["r", "t", encoded])) \
        == sexpr.parse(payload)
    _, params = jax_sexpr.parse(payload)
    decoded = codec.decode_swag(params[2])
    for key, value in swag.items():
        if isinstance(value, np.ndarray):
            assert decoded[key].dtype == value.dtype
            np.testing.assert_array_equal(decoded[key], value)
        else:
            assert decoded[key] == value


_symbols = st.text(alphabet=st.one_of(
    st.sampled_from(list(" \t\r\n()\x0b\x0c\x1c\x1f\x85\u2028\xa0"
                         "ab:'\"019N=+/")), st.characters()), max_size=40)


@settings(max_examples=400, deadline=None)
@given(symbol=_symbols)
def test_symbol_scans_equal_the_regular_expressions(symbol):
    """The codec's scans for long symbols (a base64 KV payload) answer as
    the regular expression and the character loop they stand for."""
    assert sexpr._needs_canonical(symbol) == bool(
        sexpr._NEEDS_CANONICAL.search(symbol))
    for start in range(len(symbol) + 1):
        want = next((i for i in range(start, len(symbol))
                     if symbol[i] in " \t\r\n()"), len(symbol))
        assert sexpr._bare_end(symbol, start, len(symbol)) == want


# --------------------------------------------------------------------------- #
# The commands the port answers for what it does not serve yet


def _prefix_cached_paged_servers():
    """A JAX and a port prefix-cached paged server on the same weights."""
    kwargs = dict(slots=2, max_seq=96, chunk_steps=2,
                  enable_prefix_cache=True, chunk_prefill_tokens=16,
                  ring_max=2)
    jax_server = jax_paged.PagedContinuousServer(config_name=CONFIG, seed=6,
                                                 **kwargs)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_server.params),
                               "cpu")
    return {"jax": jax_server,
            "torch": PagedContinuousServer(config_name=CONFIG, params=params,
                                           device="cpu", **kwargs)}


def test_prefix_cached_paged_replica_never_touches_the_kv_wire():
    """A prefix-cached paged server behind each package's replica: a
    request whose ``kv_source`` names no live owner falls back to local
    prefill after ``kv_fetch_timeout_s`` (counted as a transfer failure),
    a request sharing its prefix hits the cache, and the replica answers
    ``(kv_export …)`` for an unknown chain with ``kv_prefix_gone`` and
    ``(migrate_prepare …)`` with ``migrate_ready`` carrying the live
    request's exportable blocks and committed tokens, or
    ``migrate_unknown_request``.  The port's answers, tokens and digest
    equal the JAX replica's; the tokens equal the batch-1 oracle's."""
    servers = _prefix_cached_paged_servers()
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, 1024, 48).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, 1024, n)
                               .astype(np.int32)]) for n in (5, 9)]
    answers = {}
    for side, server in servers.items():
        wire = Wire(side, server, "kv")
        wire.infer("a", prompts[0], max_new_tokens=6, kv_source="peer/x")
        wire.run(lambda w: w.responses())
        # "b" streams: once its first partial is out it is live, and the
        # migrate_prepare for it finds it.
        wire.infer("b", prompts[1], max_new_tokens=6, stream=1)
        wire.run(lambda w: w.partials())
        gen = wire.side.sexpr.generate
        swag = wire.side.codec.encode_swag
        wire.publish(gen("kv_export", ["k1", "test/responses",
                                       swag({"kv_keys": ["00ff"]})]))
        wire.publish(gen("migrate_prepare", ["m1", "test/responses",
                                             swag({"request_id": "b"})]))
        wire.publish(gen("migrate_prepare", ["m2", "test/responses",
                                             swag({"request_id": "zz"})]))
        wire.run(lambda w: len(w.responses()) == 2)
        ready = wire.responses("migrate_ready")
        answers[side] = dict(
            kv=wire.responses("kv_export_response")["k1"],
            live={key: int(np.asarray(value)) if key != "request_id"
                  else value for key, value in ready["m1"].items()},
            gone=ready["m2"],
            tokens={rid: _tokens(out)
                    for rid, out in wire.responses().items()},
            digest=wire.replica.share["kv_prefixes"],
            failures=server.kv_transfer_failures, hits=server.prefix_hits)
    port = answers["torch"]
    for rid, prompt in zip("ab", prompts):
        assert port["tokens"][rid] == reference_greedy(servers["torch"],
                                                       prompt, 6)
    assert port == answers["jax"]
    assert port["kv"] == {"error": "kv_prefix_gone"}
    assert port["gone"] == {"request_id": "zz",
                            "error": "migrate_unknown_request"}
    assert port["live"]["request_id"] == "b" and port["live"]["blocks"] >= 3
    # The timed-out fetch and the export of an unknown chain.
    assert port["failures"] == 2 and port["hits"] >= 1


@pytest.mark.parametrize("command", ["adapter_load", "adapter_unload"])
def test_adapter_commands_answer_with_an_error(command):
    """Adapter hot-deploy has no server to land on yet: the replica still
    answers (adapter_response id (error: …)), so a client future
    resolves."""
    server = _servers(slots=1, max_seq=32, chunk_steps=2)["torch"]
    wire = Wire("torch", server, "adapters")
    wire.publish(sexpr.generate(command, [
        "a1", "test/responses",
        codec.encode_swag({"name": "fin", "path": "/nowhere"})]))
    wire.run(lambda w: w.events)
    (reply, rid, outputs), = wire.events
    assert (reply, rid) == ("adapter_response", "a1")
    assert outputs["error"]


def test_operator_commands_answer():
    """(metrics) names the server's counters and latency histograms in
    Prometheus text; (profile) answers unsupported (no device profiler
    yet); (census) answers unsupported (no pool census yet)."""
    server = _servers(slots=1, max_seq=32, chunk_steps=2)["torch"]
    wire = Wire("torch", server, "ops")
    wire.infer("m", np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
    wire.run(lambda w: w.responses())
    got = {}

    def on_reply(_topic, payload):
        command, params = sexpr.parse(payload)
        got[command] = params[1]
    wire.process.add_message_handler(on_reply, "test/ops")
    for command in ("metrics", "profile", "census"):
        args = ["test/ops"] if command == "metrics" else ["", "test/ops"]
        if command == "profile":
            args = [4, "", "test/ops"]
        wire.publish(sexpr.generate(command, args))
    wire.run(lambda w: len(got) == 3)
    label = f'instance="srv{server._instance_id}"'
    assert f"aiko_server_decode_steps{{{label}}}" in got["metrics_response"]
    assert f"aiko_latency_ttft_ms_count{{{label}}} 1" \
        in got["metrics_response"]
    assert got["profile_response"] == "unsupported"
    assert got["census_response"] == "unsupported"


def test_retire_drains_and_advertises():
    """(retire) flips the shared lifecycle to retiring, keeps serving the
    queued request and advertises drained once idle."""
    server = _servers(slots=1, max_seq=32, chunk_steps=2)["torch"]
    wire = Wire("torch", server, "retire")
    wire.infer("r", np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
    wire.publish(sexpr.generate("retire", []))
    wire.run(lambda w: w.responses() and not w.replica._pumping)
    assert wire.replica.share["lifecycle"] == "retiring"
    assert wire.replica.share["drained"] == 1
    assert len(_tokens(wire.responses()["r"])) == 4


# --------------------------------------------------------------------------- #
# Robustness on the port (tests/test_faults.py's scenarios)


def _server(**kwargs):
    kwargs.setdefault("config_name", "tiny")
    kwargs.setdefault("slots", 2)
    kwargs.setdefault("max_seq", 64)
    kwargs.setdefault("chunk_steps", 2)
    return continuous.ContinuousBatchingServer(device="cpu", **kwargs)


def _request(request_id, max_new=4, **kwargs):
    return continuous.DecodeRequest(request_id=request_id,
                                    prompt=np.arange(1, 6, dtype=np.int32),
                                    max_new_tokens=max_new, **kwargs)


def test_deadline_rejects_expired_at_admission():
    server = _server()
    request = _request("r1", deadline_ts=time.monotonic() - 0.01)
    server.submit(request)
    assert request.error == "deadline_exceeded"
    assert request.finished_ts is not None
    assert server.counters["deadline_exceeded"] == 1
    assert server.step() == [request]


def test_deadline_evicts_queued_and_live():
    server = _server(slots=1)
    warm = _request("warm", max_new=4)
    server.submit(warm)
    server.run_until_drained()
    # Every ring sync now stalls 30 ms, so the hog cannot finish its
    # 40-token budget inside the deadline, but it commits a few chunks
    # first (partial work kept on eviction).
    faults.install(faults.FaultPlan().add("stall_step", prob=1.0, ms=30))
    hog = _request("hog", max_new=40, deadline_ts=time.monotonic() + 0.15)
    queued = _request("queued", deadline_ts=time.monotonic() + 0.15)
    server.submit(hog)
    server.submit(queued)
    done = []
    deadline = time.time() + 60
    while len(done) < 2 and time.time() < deadline:
        done.extend(server.step())
    by_id = {r.request_id: r for r in done}
    assert by_id["hog"].error == "deadline_exceeded"
    assert by_id["hog"].tokens
    assert by_id["queued"].error == "deadline_exceeded"
    assert server.counters["deadline_exceeded"] == 2
    assert not server.busy


def test_overload_shed_with_retry_after():
    server = _server(max_queue=1)
    server.submit(_request("q0"))
    shed = _request("q1")
    server.submit(shed)
    assert shed.error == "overloaded"
    assert shed.retry_after_ms and shed.retry_after_ms > 0
    assert server.counters["shed"] == 1
    stats = server.stats()
    assert stats["shed"] == 1 and stats["free_slots"] == server.slots


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_watchdog_trips_and_fails_retriable(layout):
    kwargs = dict(slots=1, watchdog_s=0.01)
    server = (_server(**kwargs) if layout == "contiguous" else
              PagedContinuousServer(config_name="tiny", max_seq=64,
                                    chunk_steps=2, device="cpu", **kwargs))
    faults.install(faults.FaultPlan().add("stall_step", nth=1, ms=60))
    victim = _request("w1", max_new=8)
    server.submit(victim)
    done = []
    deadline = time.time() + 30
    while not done and time.time() < deadline:
        done.extend(server.step())
    assert victim.error == "watchdog_stalled"
    assert server.healthy is False
    assert server.counters["watchdog_trips"] >= 1
    assert server.stats()["healthy"] == 0
    late = _request("w2")
    server.submit(late)
    assert late.error == "watchdog_stalled"


def test_watchdog_alarm_flips_healthy_during_the_wait():
    """The alarm thread flips ``healthy`` while the sync still blocks:
    a stall of one second under a 20 ms watchdog trips from the timer
    thread long before the blocked step returns."""
    server = _server(slots=1, watchdog_s=0.02)
    trips = []
    trip = server._trip_watchdog

    def recorded():
        trips.append((threading.current_thread().name, time.monotonic(),
                      server.healthy))
        trip()
    server._trip_watchdog = recorded
    faults.install(faults.FaultPlan().add("stall_step", nth=1, ms=1000))
    server.submit(_request("w1", max_new=8))
    began = time.monotonic()
    done = []
    while not done and time.monotonic() - began < 30:
        done.extend(server.step())
        returned = time.monotonic()
        if trips:
            break
    name, tripped_at, was_healthy = trips[0]
    assert name != threading.current_thread().name and was_healthy
    assert returned - tripped_at > 0.5
    assert server.healthy is False


def test_watchdog_counts_one_trip_when_alarm_and_sync_both_trip(tmp_path):
    """A stall that ends past ``watchdog_s`` trips from the alarm thread
    during the wait and again from the check after it: the trip is
    counted once and one watchdog bundle is written (the fault plan
    writes its own)."""
    flight.install(out_dir=str(tmp_path), service="port",
                              min_interval_s=0.0)
    try:
        server = _server(slots=1, watchdog_s=0.05)
        callers = []
        trip = server._trip_watchdog

        def recorded():
            callers.append(threading.current_thread().name)
            trip()
        server._trip_watchdog = recorded
        faults.install(faults.FaultPlan().add("stall_step", nth=1, ms=150))
        server.submit(_request("w1", max_new=8))
        done = []
        deadline = time.monotonic() + 30
        while not done and time.monotonic() < deadline:
            done.extend(server.step())
    finally:
        flight.uninstall()
    assert len(set(callers)) == 2
    assert server.counters["watchdog_trips"] == 1
    triggers = [json.loads(path.read_text())["manifest"]["trigger"]
                for path in tmp_path.glob("capture_*.json")]
    assert triggers.count("watchdog") == 1
    assert done[0].error == "watchdog_stalled"


def test_watchdog_trip_is_counted_once_across_threads(tmp_path):
    """Eight threads trip one server at the same moment: one counts the
    trip and captures, the rest return."""
    recorder = flight.install(out_dir=str(tmp_path), service="port",
                              min_interval_s=0.0)
    try:
        server = _server(slots=1, watchdog_s=1.0)
        barrier = threading.Barrier(8)

        def trip():
            barrier.wait()
            server._trip_watchdog()
        threads = [threading.Thread(target=trip) for _ in range(8)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(30)
    finally:
        flight.uninstall()
    assert server.counters["watchdog_trips"] == 1
    assert recorder.captures == 1
    assert server.healthy is False


def test_replica_share_turns_unhealthy_on_a_trip():
    """A tripped server's replica answers watchdog_stalled and flips the
    shared lifecycle to unhealthy, which routers watch."""
    server = _server(slots=1, watchdog_s=0.01)
    wire = Wire("torch", server, "watchdog")
    faults.install(faults.FaultPlan().add("stall_step", nth=1, ms=60))
    wire.infer("w1", np.arange(1, 6, dtype=np.int32), max_new_tokens=8)
    wire.run(lambda w: w.responses())
    assert wire.responses()["w1"]["error"] == "watchdog_stalled"
    assert wire.replica.share["lifecycle"] == "unhealthy"
    assert wire.replica.share["healthy"] == 0
    wire.infer("w2", np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
    wire.run(lambda w: "w2" in w.responses())
    assert wire.responses()["w2"]["error"] == "watchdog_stalled"


def test_corrupt_response_fault_resolves_the_client_future():
    """The ``corrupt_response`` fault site garbles the response swag; the
    port's InferClient resolves the future with corrupt_response."""
    server = _server(slots=1)
    wire = Wire("torch", server, "corrupt")
    user = client.InferClient(wire.process, wire.replica.topic_in)
    faults.install(faults.FaultPlan().add("corrupt_response", nth=1))
    future = user.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
    wire.run(lambda w: future.done)
    assert future.error == "corrupt_response"


def test_client_wait_timeout_resolves_future():
    engine = runtime.EventEngine(clock=runtime.VirtualClock())
    process = runtime.Process(namespace="test", hostname="h", pid="1",
                              engine=engine, broker="cliwait")
    user = client.InferClient(process, "nowhere/in")
    future = user.submit(np.arange(1, 5, dtype=np.int32))
    user.wait(future, timeout=0.05)
    assert future.done and future.error == "timeout"
    assert user._futures == {}


def test_client_wait_wakes_on_resolve():
    engine = runtime.EventEngine(clock=runtime.VirtualClock())
    process = runtime.Process(namespace="test", hostname="h", pid="1",
                              engine=engine, broker="cliwake")
    user = client.InferClient(process, "nowhere/in")
    future = user.submit(np.arange(1, 5, dtype=np.int32))
    timer = threading.Timer(
        0.05, lambda: future._resolve(
            {"tokens_out": np.asarray([3], np.int32)}, None))
    timer.start()
    started = time.monotonic()
    user.wait(future, timeout=30.0)
    assert future.done and future.error is None
    assert time.monotonic() - started < 5.0
    timer.cancel()


def test_client_cancel_over_a_threaded_engine():
    """InferClient against the port's replica on a real engine thread:
    a streamed request cancelled after its first partial resolves with
    error=cancelled and its partial tokens (partials equal tokens_out);
    a cancel for an unknown id resolves with cancel_unrouted; a normal
    request equals the batch-1 oracle."""
    server = continuous.ContinuousBatchingServer(
        config_name=CONFIG, slots=2, max_seq=256, chunk_steps=1,
        device="cpu")
    engine = runtime.EventEngine()
    process = runtime.Process(namespace="test", hostname="h", pid="7",
                              engine=engine, broker="threaded")
    replica = runtime.compose_instance(
        continuous.ContinuousReplica, runtime.actor_args("cbt"),
        process=process, server=server)
    user = client.InferClient(process, replica.topic_in)
    thread = engine.run_in_thread()
    try:
        first = threading.Event()
        prompt = np.arange(1, 9, dtype=np.int32)
        long = user.submit(prompt, max_new_tokens=200, stream=True,
                           on_partial=lambda inc: first.set())
        plain = user.submit(prompt, max_new_tokens=6)
        assert first.wait(60)
        user.cancel(long)
        user.wait(long, timeout=60)
        user.wait(plain, timeout=60)
        ghost = client.InferFuture("ghost1")
        user._futures["ghost1"] = ghost
        user.cancel(ghost)
        user.wait(ghost, timeout=60)
    finally:
        engine.terminate()
        thread.join(30)
    assert long.error == "cancelled"
    assert 0 < len(long.tokens) < 200
    assert long.partial_tokens == long.tokens
    assert long.tokens == reference_greedy(server, prompt, 200)[
        :len(long.tokens)]
    assert plain.error is None
    assert plain.tokens == reference_greedy(server, prompt, 6)
    assert ghost.error == "cancel_unrouted"
