"""Port parity: the fleet — Registrar, services cache, ReplicaRouter,
make_llama_infer and the load-generator rigs — against the JAX package's,
on the CPU.

* Registrar and services cache: the same scenario script runs on both
  packages' runtimes (virtual clocks, loopback brokers) and gives the same
  transcript: election states, retained registrar strings (timestamps
  masked), directory contents, cache add/remove events, eviction on a
  process's LWT and on an EC share's lease expiry.
* Routing decisions: both routers get the same synthetic fleet (replica
  queue depths, prefix digests with HBM, host and disk blocks, adapter
  residency, migrating flags, a seed) and must take the same decisions in
  ``_pick``, ``_pick_prefix``, ``_adapter_weights``, ``_saturated`` and
  ``route``, hypothesis-driven.
* The JAX router scenarios (tests/test_serving.py, test_kvstore.py,
  test_kv_tier.py, test_faults.py, test_infer_client.py) run on the port.
* ``make_llama_infer`` answers as the JAX factory on the same weights.
* The rigs: the port's ``run_chaos`` loses nothing, ``run_shared_prefix``
  hits the prefix cache at least as often as the JAX rig on the same
  payloads, and ``run_migration_chaos`` holds tests/test_migration.py's
  invariants in every fault phase.

Port servers serve an f32 copy of ``tiny`` (registered in both config
tables) on the JAX package's weights through the weight bridge, and every
completed request's tokens are held to a JAX ``llama.prefill`` +
``generate_tokens`` oracle on those weights: equal greedy tokens at f32.
No assertion reads wall time; every real-time wait has a deadline.
"""

import dataclasses
import re
import types
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from aiko_services_tpu import registry as jax_registry
from aiko_services_tpu import runtime as jax_runtime
from aiko_services_tpu.kvstore import adapters as jax_adapters
from aiko_services_tpu.kvstore import directory as jax_directory
from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.orchestration import serving as jax_serving
from aiko_services_tpu.pipeline import codec as jax_codec
from aiko_services_tpu.tools import loadgen as jax_loadgen
from aiko_services_tpu.utils import sexpr as jax_sexpr
from aiko_services_tpu_torch import registry, runtime, transport
from aiko_services_tpu_torch.kvstore import adapters, directory
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.models.bridge import params_from_numpy
from aiko_services_tpu_torch.orchestration import serving
from aiko_services_tpu_torch.orchestration.client import InferClient
from aiko_services_tpu_torch.orchestration.continuous import (
    ContinuousBatchingServer, ContinuousReplica, DecodeRequest)
from aiko_services_tpu_torch.orchestration.paged import PagedContinuousServer
from aiko_services_tpu_torch.pipeline import codec
from aiko_services_tpu_torch.registry import registrar as port_registrar
from aiko_services_tpu_torch.runtime import faults
from aiko_services_tpu_torch.tools import loadgen
from aiko_services_tpu_torch.utils import sexpr

CONFIG = "tiny_f32"

SIDES = {
    "jax": types.SimpleNamespace(
        runtime=jax_runtime, registry=jax_registry, serving=jax_serving,
        directory=jax_directory, adapters=jax_adapters, codec=jax_codec,
        sexpr=jax_sexpr),
    "torch": types.SimpleNamespace(
        runtime=runtime, registry=registry, serving=serving,
        directory=directory, adapters=adapters, codec=codec, sexpr=sexpr),
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


@pytest.fixture()
def engine():
    """The port's event engine on a virtual clock."""
    return runtime.EventEngine(clock=runtime.VirtualClock())


def make_process(engine, pid, broker, side=runtime):
    return side.Process(namespace="test", hostname="h", pid=str(pid),
                        engine=engine, broker=broker)


# --------------------------------------------------------------------------- #
# Weights and the JAX oracle

_JAX_PARAMS = {}
_ORACLE = {}


def jax_params():
    """The JAX package's ``tiny`` weights at f32 from PRNGKey(0): what the
    JAX ``make_llama_infer`` builds, and what every port server here
    serves through the bridge."""
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
        tokens = jnp.asarray(prompt)[None, :]
        cache = jax_llama.init_cache(config, 1, 128)
        logits, cache = jax_llama.prefill(jax_params(), tokens, cache,
                                          config)
        first = logits[:, -1].argmax(-1).astype(jnp.int32)[:, None]
        out = [int(first[0, 0])]
        if max_new > 1:
            generated, _ = jax_llama.generate_tokens(
                jax_params(), first, cache, jnp.int32(len(prompt)),
                max_new - 1, config)
            out += [int(t) for t in np.asarray(generated)[0]]
        _ORACLE[key] = out
    return _ORACLE[key]


def paged_server(**kwargs):
    defaults = dict(slots=2, max_seq=96, chunk_steps=4, block_size=16,
                    enable_prefix_cache=True)
    defaults.update(kwargs)
    return PagedContinuousServer(config_name=CONFIG, params=bridged(),
                                 device="cpu", **defaults)


def _pump(engine, check, steps=20000, dt=0.001):
    for _ in range(steps):
        engine.advance(dt)
        if check():
            return True
    return False


# --------------------------------------------------------------------------- #
# Registrar and services cache: one script, both packages

_TIMESTAMP = re.compile(r"(\(primary found \S+ 2 )[0-9.e+-]+\)")


def _registry_script(name):
    """Run the registrar/services-cache scenarios of tests/test_registry.py
    on one package and return what an observer sees."""
    side = SIDES[name]
    rt, reg = side.runtime, side.registry
    engine = rt.EventEngine(clock=rt.VirtualClock())
    broker = f"fleet-registry-{name}"
    seen = []
    transcript = []

    def note(*what):
        transcript.append(what)

    observer = make_process(engine, 90, broker, rt)
    boot = observer.topic_registrar_boot
    observer.add_message_handler(
        lambda _topic, payload: seen.append(_TIMESTAMP.sub(r"\1T)",
                                                           payload)), boot)
    p1, p2 = make_process(engine, 1, broker, rt), \
        make_process(engine, 2, broker, rt)
    r1 = reg.Registrar(process=p1)
    note("r1 start", r1.state)
    engine.advance(4.0)
    note("r1 elected", r1.state, p1.registrar["topic_path"])
    r2 = reg.Registrar(process=p2)
    engine.drain()
    note("r2 joins", r2.state)
    # Services announce; a cache mirrors them and filters by protocol.
    p3 = make_process(engine, 3, broker, rt)
    workers = [rt.compose_instance(rt.Actor, rt.actor_args(
        f"svc_{i}", protocol=f"p{i % 2}:0"), process=p3) for i in range(3)]
    p4 = make_process(engine, 4, broker, rt)
    cache = reg.ServicesCache(p4)
    engine.drain()
    events = []
    cache.add_handler(rt.ServiceFilter(protocol="p0"),
                      lambda f: events.append(("add", f.name)),
                      lambda f: events.append(("remove", f.name)))
    note("cache", cache.state, sorted(f.name for f in cache.services))
    note("directory", sorted(tuple(f.as_list()[:3])
                             for f in r1.services))
    late = rt.compose_instance(rt.Actor, rt.actor_args(
        "svc_late", protocol="p0:0"), process=p4)
    engine.drain()
    # LWT: p3 dies, its services are evicted everywhere.
    p3.kill()
    engine.drain()
    note("after kill", sorted(f.name for f in r1.services),
         sorted(f.name for f in cache.services),
         [entry[0].name for entry in r1.history])
    # The primary dies: the secondary re-elects and the cache resyncs.
    p1.kill()
    engine.drain()
    note("primary died", r2.state)
    engine.advance(4.0)
    engine.drain()
    note("failover", r2.state, p4.registrar["topic_path"], cache.state,
         sorted(f.name for f in cache.services), late.topic_path)
    note("cache events", events)
    # Dual primaries reconcile by topic order.
    p5, p6 = make_process(engine, 5, broker + "x", rt), \
        make_process(engine, 6, broker + "x", rt)
    d5, d6 = reg.Registrar(process=p5), reg.Registrar(process=p6)
    for r in (d5, d6):
        r._machine.state = "primary"
        r.on_enter_primary({})
    engine.drain()
    note("dual", d5.state, d6.state)
    # EC share lease: a consumer that stops extending stops receiving.
    actor = rt.compose_instance(rt.Actor, rt.actor_args("prod"),
                                process=p2)
    actor.ec_producer.add("k", "v")
    mirror = {}
    consumer = reg.ECConsumer(p4, mirror, actor.topic_control,
                              lease_time=10.0)
    engine.drain()

    def share(mirror):
        # ``source_file`` names the package's own actor module.
        return {key: value for key, value in mirror.items()
                if key != "source_file"}
    note("ec", share(mirror), mirror["source_file"].split(".", 1)[1])
    consumer.terminate()
    engine.advance(11.0)
    actor.ec_producer.update("k", "v2")
    engine.drain()
    note("ec after lease expiry", share(mirror)["k"])
    note("retained", seen)
    return transcript, r1, r2


def test_registrar_and_services_cache_match_jax():
    """Election, the retained registrar strings, the directory, the
    services cache's events, LWT eviction, failover, dual-primary
    reconciliation and EC lease expiry give the same transcript on both
    packages."""
    got, r1, r2 = _registry_script("torch")
    want, _, _ = _registry_script("jax")
    assert got == want
    # The transcript says what the JAX tests assert.
    notes = dict((entry[0], entry[1:]) for entry in got)
    assert notes["r1 elected"][0] == "primary"
    assert notes["r2 joins"] == ("secondary",)
    # p3's three services are evicted from the registrar and the cache.
    assert notes["after kill"][:2] == (["registrar", "registrar",
                                        "svc_late"],) * 2
    assert notes["after kill"][2] == ["svc_2", "svc_1", "svc_0"]
    assert notes["failover"][0] == "primary"
    assert notes["dual"] == ("primary", "secondary")
    assert notes["ec"][0]["k"] == "v"
    assert notes["ec after lease expiry"] == ("v",)
    assert isinstance(r1, port_registrar.Registrar)
    assert r2.state == "primary"


def test_registry_exports_match_jax():
    for name in ("Registrar", "REGISTRAR_PROTOCOL", "PRIMARY_SEARCH_TIMEOUT",
                 "ServicesCache", "services_cache_create_singleton"):
        assert hasattr(registry, name), name
    assert registry.REGISTRAR_PROTOCOL == jax_registry.REGISTRAR_PROTOCOL
    assert registry.PRIMARY_SEARCH_TIMEOUT \
        == jax_registry.PRIMARY_SEARCH_TIMEOUT
    assert serving.ROUTER_PROTOCOL == jax_serving.ROUTER_PROTOCOL
    assert serving.RETRIABLE_ERRORS == jax_serving.RETRIABLE_ERRORS


@pytest.mark.parametrize("name", ["", "tenant", "tenant-7", "ünï"])
def test_adapter_keys_equal_jax(name):
    assert adapters.adapter_hex(name) == jax_adapters.adapter_hex(name)
    assert adapters.adapter_chain_keys(name, 3) \
        == jax_adapters.adapter_chain_keys(name, 3)


# --------------------------------------------------------------------------- #
# Routing decisions: both routers on the same synthetic fleet

PROMPT = np.arange(1, 50, dtype=np.int32)           # 3 shareable blocks
ADAPTER = "tenant"


def _decision_router(name, **kwargs):
    side = SIDES[name]
    rt = side.runtime
    engine = rt.EventEngine(clock=rt.VirtualClock())
    process = make_process(engine, 9, f"decide-{uuid.uuid4().hex[:8]}", rt)
    router = rt.compose_instance(side.serving.ReplicaRouter,
                                 rt.actor_args("router"), process=process,
                                 anomaly_interval_s=0, **kwargs)
    sent = []
    router.process.message.publish = \
        lambda topic, payload, **_: sent.append((topic, payload))
    return router, sent


_replica = st.fixed_dictionaries({
    "depth": st.one_of(st.none(), st.integers(0, 40)),
    "blocks": st.lists(st.sampled_from([0, 1, 2]), max_size=3),
    "adapter_tier": st.one_of(st.none(), st.sampled_from([0, 1, 2])),
    "migrating": st.booleans(),
    "role": st.sampled_from(["decode", "decode", "prefill"]),
    "state": st.sampled_from(["live", "live", "live", "unhealthy",
                              "retiring"]),
})


def _fleet_state(router, fleet, side):
    """Hand ``router`` the synthetic fleet: membership, queue depths and
    advertised digests."""
    topics = [f"test/h/{20 + i}/1" for i in range(len(fleet))]
    router._replicas = list(topics)
    router._loads = {}
    keys = side.directory.chain_keys_hex(PROMPT, 16)
    adapter_key = side.adapters.adapter_hex(ADAPTER)
    for topic, replica in zip(topics, fleet):
        if replica["depth"] is not None:
            router._loads[topic] = {"queue_depth": replica["depth"]}
        entries = [(key, depth + 1, 0, 1, tier)
                   for depth, (key, tier)
                   in enumerate(zip(keys, replica["blocks"]))]
        if replica["adapter_tier"] is not None:
            entries.append((adapter_key, 1, 0, 1, replica["adapter_tier"],
                            0, 0, 1))
        if entries or replica["role"] == "prefill":
            router.directory.update(topic, side.directory.digest_encode(
                16, replica["role"], entries,
                migrating=int(replica["migrating"])), 0.0)
        if replica["state"] == "unhealthy":
            router._unhealthy.add(topic)
        elif replica["state"] == "retiring":
            router._retiring.add(topic)
    return topics


def _decisions(name, fleet, knobs, seed):
    side = SIDES[name]
    router, sent = _decision_router(name, seed=seed, **knobs)
    topics = _fleet_state(router, fleet, side)
    payload = side.codec.encode_swag({"tokens": PROMPT, "adapter": ADAPTER})
    plain = side.codec.encode_swag({"tokens": PROMPT})
    candidates = router._candidates()
    decode = router._decode_candidates(candidates)
    adapter_hex = router._request_adapter_hex(payload)
    weights = router._adapter_weights(decode, adapter_hex, 0.0)
    out = dict(
        candidates=candidates, decode=decode, adapter_hex=adapter_hex,
        weights=weights, saturated=router._saturated(candidates),
        prefix=router._pick_prefix(decode, payload, weights),
        prefix_plain=router._pick_prefix(decode, plain),
        picks=[router._pick(list(topics)) for _ in range(6)])
    routed = []
    for index, swag in enumerate((payload, plain, payload)):
        ok = router.route(f"r{index}", "test/client", dict(swag))
        entry = router._inflight.get(f"r{index}")
        routed.append((ok, entry and entry["replica"],
                       entry and entry["phase"]))
    out["routed"] = routed
    out["sent"] = [(topic, side.sexpr.parse(message)) for topic, message
                   in sent]
    out["counters"] = dict(router.counters)
    return out


@settings(max_examples=60, deadline=None)
@given(fleet=st.lists(_replica, min_size=1, max_size=4),
       alpha=st.sampled_from([0.0, 0.5, 1.0, 3.0]),
       host_weight=st.sampled_from([0.5, 1.0, 0.0]),
       affinity=st.sampled_from([0.0, 1.0, 8.0]),
       shed=st.integers(1, 40), seed=st.integers(0, 2 ** 16),
       kv_transfer=st.booleans(), disaggregate=st.booleans())
def test_routing_decisions_match_jax(fleet, alpha, host_weight, affinity,
                                     shed, seed, kv_transfer,
                                     disaggregate):
    """Power-of-two choices and round robin, prefix and tier pricing,
    adapter affinity, shedding and the kv_source / prefill_only hints:
    the port's router decides as the JAX router on the same inputs."""
    knobs = dict(prefix_alpha=alpha, host_prefix_weight=host_weight,
                 adapter_affinity=affinity, shed_queue_depth=shed,
                 kv_transfer=kv_transfer, disaggregate=disaggregate)
    got = _decisions("torch", fleet, knobs, seed)
    want = _decisions("jax", fleet, knobs, seed)
    assert got == want


def test_steady_capture_watch_raises_the_fleet_anomaly(engine):
    """A port replica's ``graph_captures_steady_state`` moving is the
    port's steady-state compile: the router flags it as the JAX router
    flags ``compiles_steady_state``, and the JAX key still works."""
    router, _ = _decision_router("torch")
    replica = "test/h/20/1"
    router._replicas = [replica]
    for key, values in (("graph_captures_steady_state", ("0", "2")),
                        ("compiles_steady_state", ("1",))):
        for value in values:
            router._replica_state(f"{replica}/state",
                                  sexpr.generate("update", [key, value]))
    assert router.counters["fleet_steady_compiles"] == 2
    assert router.counters["anomaly_flags"] == 1
    assert router.counters["fleet_captures"] == 1
    assert "steady-state compile on 1: +2" in router.share["last_anomaly"]
    # A JAX replica's counter on a fresh router: the same watch.
    other, _ = _decision_router("torch")
    other._replicas = [replica]
    other._replica_state(f"{replica}/state",
                         sexpr.generate("update",
                                        ["compiles_steady_state", "3"]))
    assert other.counters["fleet_steady_compiles"] == 3


def test_fleet_commands_fan_out_and_every_replica_answers(engine):
    """``(capture)``, ``(profile)`` and ``(census)`` sent to the router
    reach every replica on one trace id, and every actor answers the
    caller — a port replica answers ``(profile)`` and ``(census)`` with
    ``unsupported`` (the device-profile bracket and the pool census are
    not ported), never silence."""
    broker = "fanout"
    registry.Registrar(process=make_process(engine, 1, broker))
    engine.advance(4.0)
    names = []
    for index in range(2):
        replica = runtime.compose_instance(
            ContinuousReplica, runtime.actor_args(f"fan{index}"),
            process=make_process(engine, 20 + index, broker),
            server=paged_server())
        names.append(replica.name)
    pr = make_process(engine, 9, broker)
    router = runtime.compose_instance(serving.ReplicaRouter,
                                      runtime.actor_args("router"),
                                      process=pr)
    engine.drain()
    answers = []
    pr.add_message_handler(
        lambda _t, payload: answers.append(sexpr.parse(payload)),
        "test/ops")
    for command in ("(capture tid test/ops)", "(profile 2 tid test/ops)",
                    "(census tid test/ops)"):
        pr.message.publish(f"{router.topic_path}/in", command)
        engine.drain()
    by_command = {}
    for command, params in answers:
        by_command.setdefault(command, {})[params[0]] = params[1]
    assert by_command["capture_response"] == dict.fromkeys(
        names + ["router"], "uninstalled")
    assert by_command["profile_response"] == dict.fromkeys(
        names + ["router"], "unsupported")
    assert by_command["census_response"] == dict(
        dict.fromkeys(names, "unsupported"), router="uninstalled")
    assert (router.counters["fleet_captures"],
            router.counters["fleet_profiles"],
            router.counters["fleet_censuses"]) == (1, 1, 1)


# --------------------------------------------------------------------------- #
# The JAX router scenarios, on the port

def collect_responses(process, topic, into):
    def handler(_topic, payload):
        command, params = sexpr.parse(payload)
        if command == "infer_response":
            into.append((params[0], codec.decode_swag(params[1])))
    process.add_message_handler(handler, topic)


def test_round_robin_and_failover(engine):
    """tests/test_serving.py:31 on the port."""
    registry.Registrar(process=make_process(engine, 1, "serve"))
    engine.advance(4.0)
    replica_procs, replicas = [], []
    for i in range(3):
        p = make_process(engine, 10 + i, "serve")
        replicas.append(runtime.compose_instance(
            serving.ModelReplica, runtime.actor_args(f"replica_{i}"),
            process=p,
            infer=lambda payload: {"doubled": payload["value"] * 2}))
        replica_procs.append(p)
    pr = make_process(engine, 99, "serve")
    router = runtime.compose_instance(serving.ReplicaRouter,
                                      runtime.actor_args("router"),
                                      process=pr)
    engine.drain()
    assert router.share["replicas"] == 3
    responses = []
    collect_responses(pr, "test/h/99/client/response", responses)
    for i in range(9):
        pr.message.publish(f"{router.topic_path}/in", sexpr.generate(
            "infer", [f"req{i}", "test/h/99/client/response",
                      codec.encode_swag({"value": np.int64(i)})]))
    engine.drain()
    assert sorted(int(v["doubled"]) for _, v in responses) == \
        [2 * i for i in range(9)]
    assert [r.share["requests_served"] for r in replicas] == [3, 3, 3]
    replica_procs[0].kill()
    engine.drain()
    assert router.share["replicas"] == 2
    assert router.counters["replica_deaths_observed"] == 1
    responses.clear()
    for i in range(4):
        pr.message.publish(f"{router.topic_path}/in", sexpr.generate(
            "infer", [f"again{i}", "test/h/99/client/response",
                      codec.encode_swag({"value": np.int64(i)})]))
    engine.drain()
    assert len(responses) == 4


def test_router_reports_no_replicas(engine):
    """tests/test_serving.py:82 on the port."""
    registry.Registrar(process=make_process(engine, 1, "empty"))
    engine.advance(4.0)
    router = runtime.compose_instance(
        serving.ReplicaRouter, runtime.actor_args("router"),
        process=make_process(engine, 2, "empty"))
    engine.drain()
    assert router.route("r1", "test/topic", {}) is False
    assert router.counters["shed"] == 1


def test_llama_replica_end_to_end_matches_jax(engine):
    """tests/test_serving.py:93 on the port: make_llama_infer behind a
    ModelReplica and the router; its tokens equal the JAX factory's on
    the same weights (PRNGKey(0), f32)."""
    registry.Registrar(process=make_process(engine, 1, "llm"))
    engine.advance(4.0)
    infer = serving.make_llama_infer(CONFIG, max_new_tokens=4,
                                     params=bridged(), device="cpu")
    runtime.compose_instance(serving.ModelReplica,
                             runtime.actor_args("llm_replica"),
                             process=make_process(engine, 2, "llm"),
                             infer=infer)
    pr = make_process(engine, 3, "llm")
    router = runtime.compose_instance(serving.ReplicaRouter,
                                      runtime.actor_args("router"),
                                      process=pr)
    engine.drain()
    assert router.share["replicas"] == 1
    responses = []
    collect_responses(pr, "test/h/3/client/response", responses)
    prompt = np.stack([np.arange(1, 9, dtype=np.int32),
                       np.arange(30, 38, dtype=np.int32)])
    pr.message.publish(f"{router.topic_path}/in", sexpr.generate(
        "infer", ["chat1", "test/h/3/client/response",
                  codec.encode_swag({"tokens": prompt})]))
    engine.drain()
    (request_id, outputs), = responses
    assert request_id == "chat1"
    tokens_out = np.asarray(outputs["tokens_out"])
    assert tokens_out.shape == (2, 12)
    assert (tokens_out[:, :8] == prompt).all()
    want = jax_serving.make_llama_infer(CONFIG, max_new_tokens=4)(
        {"tokens": prompt})["tokens_out"]
    np.testing.assert_array_equal(tokens_out, np.asarray(want))
    for row in range(2):
        assert list(tokens_out[row, 8:]) == jax_oracle(prompt[row], 4)


def test_llama_infer_rejects_overlong_prompt():
    """tests/test_serving.py:124 on the port, and the errors the JAX
    factory gives."""
    infer = serving.make_llama_infer(CONFIG, max_new_tokens=4,
                                     params=bridged(), device="cpu")
    jax_infer = jax_serving.make_llama_infer(CONFIG, max_new_tokens=4)
    too_long = llama.CONFIGS[CONFIG].max_seq_len
    for inputs in ({"tokens": np.zeros((1, too_long), np.int32)},
                   {"tokens": np.ones((1, 4), np.int32),
                    "max_new_tokens": 0}):
        out = infer(inputs)
        assert "error" in out and out == jax_infer(inputs)
    assert "max_seq_len" in infer(
        {"tokens": np.zeros((1, too_long), np.int32)})["error"]


@pytest.mark.parametrize("factory,needs", [
    ("make_speculative_infer", "speculative_generate"),
    ("make_constrained_infer", "models/constrained.py")])
def test_unported_factories_raise_naming_what_they_need(factory, needs):
    with pytest.raises(NotImplementedError, match=re.escape(needs)):
        getattr(serving, factory)()
    with pytest.raises(NotImplementedError, match="import_weights"):
        serving.make_llama_infer(CONFIG, checkpoint="weights",
                                 device="cpu")


def _router_rig(engine, broker, n_replicas=2, **router_kwargs):
    registry.Registrar(process=make_process(engine, 1, broker))
    engine.advance(4.0)
    topics = []
    for i in range(n_replicas):
        replica = runtime.compose_instance(
            serving.ModelReplica, runtime.actor_args(f"replica_{i}"),
            process=make_process(engine, 10 + i, broker),
            infer=lambda payload: {"ok": 1})
        topics.append(replica.topic_path)
    pr = make_process(engine, 99, broker)
    router = runtime.compose_instance(serving.ReplicaRouter,
                                      runtime.actor_args("router"),
                                      process=pr, **router_kwargs)
    engine.drain()
    assert router.share["replicas"] == n_replicas
    return router, topics, pr


def _advertise(process, replica_topic, prompt, tiers=None, role="decode"):
    keys = directory.chain_keys_hex(prompt, 16)
    tiers = tiers or [0] * len(keys)
    entries = [(key, depth + 1, 0, 1, tier)
               for depth, (key, tier) in enumerate(zip(keys, tiers))]
    process.message.publish(f"{replica_topic}/state", sexpr.generate(
        "update", ["kv_prefixes", directory.digest_encode(16, role,
                                                          entries)]))


def test_router_prefix_affinity_beats_round_robin(engine):
    """tests/test_kvstore.py:479 on the port."""
    router, topics, pr = _router_rig(engine, "kvaff")
    _advertise(pr, topics[0], PROMPT)
    engine.drain()
    assert router.share["kv_directory_size"] == 3
    payload = codec.encode_swag({"tokens": PROMPT})
    picks = []
    for i in range(4):
        assert router.route(f"m{i}", "test/resp", dict(payload))
        picks.append(router._inflight[f"m{i}"]["replica"])
        engine.drain()
    assert picks == [topics[0]] * 4
    assert router.counters["prefix_routed"] == 4
    other = codec.encode_swag({"tokens": np.arange(500, 549,
                                                   dtype=np.int32)})
    targets = set()
    for i in range(2):
        router.route(f"u{i}", "test/resp", dict(other))
        targets.add(router._inflight[f"u{i}"]["replica"])
        engine.drain()
    assert targets == set(topics)


def test_router_load_beats_affinity_and_hints_transfer(engine):
    """tests/test_kvstore.py:509 on the port."""
    router, topics, pr = _router_rig(engine, "kvhint", kv_transfer=True)
    _advertise(pr, topics[0], PROMPT)
    for topic, depth in ((topics[0], 50), (topics[1], 0)):
        pr.message.publish(f"{topic}/state", sexpr.generate(
            "update", ["queue_depth", str(depth)]))
    engine.drain()
    delivered = []
    pr.add_message_handler(lambda _t, m: delivered.append(sexpr.parse(m)),
                           f"{topics[1]}/in")
    assert router.route("h1", "test/resp",
                        codec.encode_swag({"tokens": PROMPT}))
    assert router._inflight["h1"]["replica"] == topics[1]
    engine.drain()
    assert router.counters["kv_remote_hints"] == 1
    infer = [p for c, p in delivered if c == "infer"]
    assert infer and infer[0][2]["kv_source"] == f"s:{topics[0]}"


def test_router_evicts_dead_and_unhealthy_owners(engine):
    """tests/test_kvstore.py:536 on the port: an unhealthy owner's
    prefixes leave the directory, and lease expiry empties it."""
    router, topics, pr = _router_rig(engine, "kvdead")
    _advertise(pr, topics[0], PROMPT)
    _advertise(pr, topics[1], PROMPT)
    engine.drain()
    assert router.share["kv_directory_size"] == 6
    pr.message.publish(f"{topics[0]}/state",
                       sexpr.generate("update", ["lifecycle", "unhealthy"]))
    engine.drain()
    assert router.share["kv_directory_size"] == 3
    assert topics[0] not in router.directory.replicas()
    engine.advance(31.0)
    router.directory.purge_expired(router.process.event.now())
    assert router.directory.size == 0


def test_router_prefers_hbm_owner_over_host_owner(engine):
    """tests/test_kv_tier.py:318 on the port."""
    router, topics, pr = _router_rig(engine, "kvtier")
    _advertise(pr, topics[0], PROMPT, tiers=[1, 1, 1])
    _advertise(pr, topics[1], PROMPT, tiers=[0, 0, 0])
    engine.drain()
    payload = codec.encode_swag({"tokens": PROMPT})
    assert router.route("m1", "test/resp", dict(payload))
    assert router._inflight["m1"]["replica"] == topics[1]
    engine.drain()
    assert router.counters["prefix_routed"] == 1
    assert router.counters["prefix_routed_host"] == 0
    pr.message.publish(f"{topics[1]}/state",
                       sexpr.generate("update", ["lifecycle", "unhealthy"]))
    engine.drain()
    assert router.route("m2", "test/resp", dict(payload))
    assert router._inflight["m2"]["replica"] == topics[0]
    engine.drain()
    assert router.counters["prefix_routed_host"] == 1
    assert router.counters["kv_tier_hints"] == 1


def test_router_cancel_unrouted_resolves_future(engine):
    """tests/test_faults.py:413 on the port."""
    registry.Registrar(process=make_process(engine, 1, "cancelun"))
    engine.advance(4.0)
    pr = make_process(engine, 9, "cancelun")
    router = runtime.compose_instance(serving.ReplicaRouter,
                                      runtime.actor_args("router"),
                                      process=pr)
    engine.drain()
    from aiko_services_tpu_torch.orchestration.client import InferFuture
    client = InferClient(pr, f"{router.topic_path}/in")
    ghost = InferFuture("ghost1")
    client._futures["ghost1"] = ghost
    client.cancel(ghost)
    engine.drain()
    assert ghost.done and ghost.error == "cancel_unrouted"
    assert router.counters["cancel_unrouted"] == 1


def test_router_sheds_when_all_replicas_saturated(engine):
    """tests/test_faults.py:428 on the port."""
    router, _ = _decision_router("torch")
    responses = []

    def publish(topic, payload, **_):
        if topic == "test/client/resp":
            responses.append(codec.decode_swag(sexpr.parse(payload)[1][1]))
    router.process.message.publish = publish
    router.shed_queue_depth = 4
    router._replicas = ["test/h/21/1", "test/h/22/1"]
    router._loads = {"test/h/21/1": {"queue_depth": 4},
                     "test/h/22/1": {"queue_depth": 9}}
    assert router.route("s1", "test/client/resp", {}) is False
    assert responses[0]["error"] == "overloaded"
    assert int(np.asarray(responses[0]["retry_after_ms"])) == 200
    assert router.counters["shed"] == 1
    router._loads["test/h/21/1"]["queue_depth"] = 0
    assert router.route("s2", "test/client/resp", {}) is True


def test_router_p2c_prefers_shallow_queue(engine):
    """tests/test_faults.py:456 on the port."""
    router, _ = _decision_router("torch")
    router._replicas = ["test/h/21/1", "test/h/22/1"]
    router._loads = {"test/h/21/1": {"queue_depth": 7},
                     "test/h/22/1": {"queue_depth": 1}}
    assert {router._pick(list(router._replicas)) for _ in range(8)} \
        == {"test/h/22/1"}
    del router._loads["test/h/21/1"]["queue_depth"]
    assert [router._pick(list(router._replicas)) for _ in range(4)] \
        == ["test/h/21/1", "test/h/22/1"] * 2


def test_router_redispatch_streaming_failover(engine):
    """tests/test_faults.py:470 on the port: the replica holding a
    streaming request dies mid-stream; the request re-dispatches to the
    survivor and completes with the oracle's tokens, none delivered
    twice."""
    registry.Registrar(process=make_process(engine, 1, "failover"))
    engine.advance(4.0)
    procs = {}
    for index, name in enumerate(("cba", "cbb")):
        p = make_process(engine, 20 + index, "failover")
        server = ContinuousBatchingServer(
            config_name=CONFIG, slots=2, max_seq=64, chunk_steps=2,
            params=bridged(), device="cpu")
        replica = runtime.compose_instance(
            ContinuousReplica, runtime.actor_args(name), process=p,
            server=server)
        procs[replica.topic_path] = p
    pr = make_process(engine, 9, "failover")
    router = runtime.compose_instance(serving.ReplicaRouter,
                                      runtime.actor_args("router"),
                                      process=pr)
    engine.drain()
    assert router.share["replicas"] == 2
    client = InferClient(pr, f"{router.topic_path}/in")
    prompt = np.arange(1, 8, dtype=np.int32)
    increments = []
    victim = client.submit(prompt, max_new_tokens=12, stream=True,
                           on_partial=increments.append)
    assert _pump(engine, lambda: victim.partial_tokens)
    assert not victim.done
    holder = router._inflight[victim.request_id]["replica"]
    procs[holder].kill()
    assert _pump(engine, lambda: victim.done, steps=60000)
    want = jax_oracle(prompt, 12)
    assert victim.error is None and victim.tokens == want
    assert [t for inc in increments for t in inc] == want
    assert victim.partial_tokens == want
    assert router.counters["redispatches"] == 1
    assert router.counters["replica_deaths_observed"] == 1
    assert router._inflight == {}


def test_cancel_through_router(engine):
    """tests/test_infer_client.py:127 on the port."""
    process = make_process(engine, 97, "rcancel")
    registry.Registrar(process=process)
    engine.advance(4.0)
    server = ContinuousBatchingServer(config_name=CONFIG, slots=1,
                                      max_seq=64, chunk_steps=2,
                                      params=bridged(), device="cpu")
    runtime.compose_instance(ContinuousReplica, runtime.actor_args("rc0"),
                             process=process, server=server)
    router = runtime.compose_instance(serving.ReplicaRouter,
                                      runtime.actor_args("rr0"),
                                      process=process)
    engine.drain()
    assert _pump(engine, lambda: router.share["replicas"] == 1, steps=2000)
    client = InferClient(process, f"{router.topic_path}/in")
    prompt = np.arange(1, 8, dtype=np.int32)
    victim = client.submit(prompt, max_new_tokens=40, stream=True)
    keeper = client.submit(prompt, max_new_tokens=4)
    assert _pump(engine, lambda: victim.partial_tokens)
    client.cancel(victim)
    assert _pump(engine, lambda: victim.done and keeper.done)
    assert victim.error == "cancelled"
    assert 0 < len(victim.tokens) < 40
    assert keeper.tokens == jax_oracle(prompt, 4)
    assert victim.request_id in router._routed
    client.cancel(victim)
    engine.drain()


def test_disaggregated_prefill_decode_exact_over_wire(engine):
    """tests/test_kvstore.py:649 on the port: the prefill replica computes
    the prompt's KV, the decode replica pulls it and generates; the
    client sees the oracle's tokens, streamed once, and the prefill leg's
    one-token answer is never forwarded."""
    broker = "disagg"
    registry.Registrar(process=make_process(engine, 1, broker))
    engine.advance(4.0)
    # A pool with room for a second prompt beside the imported blocks,
    # which stay lease-pinned for 30 s.
    server_p, server_d = paged_server(), paged_server(total_blocks=16)
    replica_p = runtime.compose_instance(
        ContinuousReplica, runtime.actor_args("prefiller"),
        process=make_process(engine, 2, broker), server=server_p,
        prefill_only=True)
    replica_d = runtime.compose_instance(
        ContinuousReplica, runtime.actor_args("decoder"),
        process=make_process(engine, 3, broker), server=server_d)
    pr = make_process(engine, 99, broker)
    router = runtime.compose_instance(serving.ReplicaRouter,
                                      runtime.actor_args("router"),
                                      process=pr, kv_transfer=True,
                                      disaggregate=True)
    engine.drain()
    assert router.share["replicas"] == 2
    assert replica_p.kv_role == "prefill"
    engine.advance(6.0)
    engine.drain()
    assert router.directory.role(replica_p.topic_path) == "prefill"
    assert router.directory.role(replica_d.topic_path) == "decode"
    responses, partials = [], []

    def handler(_topic, payload):
        command, params = sexpr.parse(payload)
        if command == "infer_response":
            responses.append(codec.decode_swag(params[1]))
        elif command == "infer_partial":
            partials.append(codec.decode_swag(params[1]))
    pr.add_message_handler(handler, "test/disagg/resp")
    prompt = np.arange(1, 41, dtype=np.int32)
    pr.message.publish(f"{router.topic_path}/in", sexpr.generate(
        "infer", ["g1", "test/disagg/resp", codec.encode_swag(
            {"tokens": prompt, "max_new_tokens": 5, "stream": 1})]))
    for _ in range(4000):
        engine.advance(0.01)
        engine.drain()
        if responses:
            break
    want = jax_oracle(prompt, 5)
    assert [int(t) for t in responses[0]["tokens_out"]] == want
    assert [int(t) for p in partials for t in p["tokens_out"]] == want
    assert server_d.prefix_remote_hits == 1
    assert server_d.kv_transfer_bytes > 0
    assert server_p.stats()["dispatches"] == 1
    assert router.counters["kv_remote_hints"] == 1
    # The payload key does the same on a replica that is not dedicated:
    # one token, no stream, and the prompt's blocks stay cached.
    other = np.arange(60, 97, dtype=np.int32)
    pr.message.publish(replica_d.topic_in, sexpr.generate(
        "infer", ["p1", "test/disagg/resp", codec.encode_swag(
            {"tokens": other, "max_new_tokens": 6, "stream": 1,
             "prefill_only": 1})]))
    streamed = len(partials)
    assert _pump(engine, lambda: len(responses) == 2)
    assert [int(t) for t in responses[1]["tokens_out"]] \
        == jax_oracle(other, 1)
    assert len(partials) == streamed
    keys = directory.chain_keys_hex(other, 16)
    advertised = {entry[0] for entry in directory.digest_decode(
        server_d.prefix_digest())[2]}
    assert set(keys[:directory.shareable_blocks(len(other), 16)]) \
        <= advertised


# --------------------------------------------------------------------------- #
# The rigs against the JAX rigs' outcomes


@pytest.fixture()
def quick_election(monkeypatch):
    """The rigs run on a real clock, where every fleet first waits out
    the registrar's primary search (2 s plus up to 1 s of jitter) before
    it serves; nothing contests the election here, so shorten it."""
    monkeypatch.setattr(port_registrar, "PRIMARY_SEARCH_TIMEOUT", 0.05)


def _assert_oracle_tokens(report, payload_fn):
    """Every completed request's final tokens equal the JAX oracle's."""
    assert report.final_tokens
    for request_id, tokens in report.final_tokens.items():
        payload = payload_fn(int(request_id.rsplit("_", 1)[1]))
        assert tokens == jax_oracle(payload["tokens"],
                                    int(payload["max_new_tokens"])), \
            request_id


def test_run_chaos_loses_nothing(quick_election):
    """tests/test_chaos.py:34's invariants on the port's rig: a replica
    killed mid-decode, two partials dropped, a stalled step — zero lost,
    zero timeouts, one death observed, the stranded work re-dispatched,
    and the captures gate (no capture after the warm-up wave) held."""
    report = loadgen.run_chaos(seed=1, n_requests=8, rate_hz=200.0,
                               drain_timeout_s=60.0, capture_gate=True,
                               warmup_requests=3, config_name=CONFIG,
                               params=bridged(), device="cpu")
    assert report.lost == 0, report
    assert report.timeouts == 0, report
    assert report.completed + sum(report.error_kinds.values()) == 8
    stats = report.server_stats
    assert stats["replica_deaths_observed"] == 1
    assert stats["redispatches"] >= 1
    assert stats["faults_fired"] >= 2
    assert stats["replicas_live"] == 1
    assert report.captures_steady_state == 0
    _assert_oracle_tokens(report, loadgen.shared_prefix_payloads(
        n_conversations=3, turns=4, system_len=32, seed=1))


def test_chaos_schedule_equals_jax():
    for seed in (0, 1, 4, 5):
        ours, theirs = loadgen.chaos_schedule(seed), \
            jax_loadgen.chaos_schedule(seed)
        assert [(r.point, r.nth, r.match, r.params) for r in ours._rules] \
            == [(r.point, r.nth, r.match, r.params)
                for r in theirs._rules]
    for phase in ("none", "transfer", "cutover", "source"):
        ours = loadgen.migration_chaos_schedule(0, phase)
        theirs = jax_loadgen.migration_chaos_schedule(0, phase)
        assert [(r.point, r.nth, r.match) for r in ours._rules] \
            == [(r.point, r.nth, r.match) for r in theirs._rules]
    payloads = (loadgen.shared_prefix_payloads(seed=3),
                jax_loadgen.shared_prefix_payloads(seed=3))
    for index in range(8):
        ours, theirs = (fn(index) for fn in payloads)
        assert ours.keys() == theirs.keys()
        np.testing.assert_array_equal(ours["tokens"], theirs["tokens"])


def test_run_shared_prefix_hit_rate_against_jax(quick_election):
    """Prefix-aware routing on the port's rig hits the prefix cache at
    least as often as the JAX rig on the same payloads, and more often
    than its own rig with prefix routing off; every token is the
    oracle's."""
    common = dict(n_requests=8, rate_hz=5.0, drain_timeout_s=60.0)
    on = loadgen.run_shared_prefix(config_name=CONFIG, params=bridged(),
                                   device="cpu", **common)
    off = loadgen.run_shared_prefix(prefix_routing=False,
                                    config_name=CONFIG, params=bridged(),
                                    device="cpu", **common)
    reference = jax_loadgen.run_shared_prefix(**common)
    for report in (on, off, reference):
        assert report.lost == 0 and report.timeouts == 0, report
    assert on.prefix_hit_rate >= reference.prefix_hit_rate, (on, reference)
    assert on.prefix_hit_rate > off.prefix_hit_rate, (on, off)
    assert on.server_stats["prefix_routed"] > 0
    assert off.server_stats["prefix_routed"] == 0
    payload_fn = loadgen.shared_prefix_payloads(n_conversations=3, turns=4,
                                                system_len=48, seed=0)
    _assert_oracle_tokens(on, payload_fn)
    _assert_oracle_tokens(off, payload_fn)
    assert len(on.client_ttfts_ms) == on.completed


def _assert_migration_invariants(control, migrated,
                                 require_completed: bool = True):
    """tests/test_migration.py's invariant bundle."""
    stats = migrated.server_stats
    assert migrated.lost == 0, (migrated, stats)
    assert migrated.timeouts == 0, (migrated, stats)
    assert migrated.duplicate_finals == 0, stats
    assert stats["stream_mismatches"] == 0, stats
    assert stats["migrations_started"] >= 1, stats
    if require_completed:
        assert stats["migrations_completed"] >= 1, stats
        assert stats["migration_cutover_ms"], stats
    both = set(control.final_tokens) & set(migrated.final_tokens)
    assert both, (control.final_tokens, migrated.final_tokens)
    for request_id in both:
        assert control.final_tokens[request_id] \
            == migrated.final_tokens[request_id], request_id


@pytest.mark.parametrize("chunk_prefill_tokens", [None, 16])
def test_migration_resume_decodes_on_the_source_cache(chunk_prefill_tokens):
    """A resume admitted on its source's tail rows starts from the
    source's exact cache: the destination's pool rows for the chain equal
    the source's byte for byte, it prefills nothing (in a plain and in a
    chunked admission), and its tokens continue the source's stream."""
    from aiko_services_tpu_torch.kvstore import transfer

    source, dest = (paged_server(chunk_prefill_tokens=chunk_prefill_tokens)
                    for _ in range(2))
    prompt = np.arange(3, 24, dtype=np.int32)           # 21 tokens
    request = DecodeRequest("src", prompt, max_new_tokens=20)
    source.submit(request)
    while len(request.tokens or []) < 7:
        source.step()
    assert source.publish_live_chain(request) >= 1
    base = 6
    chain = np.concatenate([prompt, np.asarray(request.tokens[:base],
                                               np.int32)])
    rows = len(chain) - 1                               # 26: 1 block + 10
    keys = source.prefix_keys_hex(chain)
    payload = dict(source.kv_export_payload(keys, 0),
                   **source.migration_tail_rows(request, rows))
    assert payload["kv_tail_len"] == rows % 16 == 10
    assert dest.kv_import_payload(payload) == len(keys) == 1
    resume = DecodeRequest("dst", chain, max_new_tokens=20 - base)
    resume.kv_tail = dest.migration_tail_from_payload(payload)
    dest.submit(resume)
    dest.step()
    assert (dest.kv_tails_adopted, dest.counters["prefill_dispatches"]) \
        == (1, 0)

    def chain_rows(server, req):
        slot = server._requests.index(req)
        got = transfer.gather_block_rows(server, server._owned[slot][:2])
        return {field: value.reshape(-1, *value.shape[2:])[:rows]
                for field, value in got.items()}
    want, got = chain_rows(source, request), chain_rows(dest, resume)
    assert sorted(got) == sorted(want)
    for field in want:
        assert np.array_equal(got[field].view(np.uint8),
                              want[field].view(np.uint8)), field
    source.run_until_drained()
    dest.run_until_drained()
    assert resume.tokens == request.tokens[base:]


@pytest.mark.parametrize("phase", ["none", "transfer", "cutover", "source"])
def test_run_migration_chaos_invariants(phase, quick_election):
    """Live migration on the port's rig, clean and under each fault
    phase: the invariants of tests/test_migration.py (a clean migration
    must complete), bit-exact against the unmigrated control and the JAX
    oracle."""
    control, migrated = loadgen.run_migration_chaos(
        seed=0, n_requests=5, rate_hz=60.0, phase=phase, max_new_tokens=24,
        drain_timeout_s=60.0, config_name=CONFIG, params=bridged(),
        device="cpu")
    _assert_migration_invariants(control, migrated,
                                 require_completed=phase == "none")
    if phase != "none":
        assert migrated.server_stats["faults_fired"] >= 1, \
            migrated.server_stats
    else:
        # Every completed cutover resumed on its source's own tail rows.
        assert migrated.server_stats["kv_tails_adopted"] \
            >= migrated.server_stats["migrations_completed"], \
            migrated.server_stats
    payload_fn = loadgen._elastic_payloads(seed=0, prompt_len=18,
                                           max_new_tokens=24, stream=True)
    _assert_oracle_tokens(migrated, payload_fn)
