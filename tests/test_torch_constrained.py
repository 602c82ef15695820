"""Port parity: grammar-constrained decoding against the JAX package, on
the CPU.

* ``models/constrained.py``: the automata (dense arrays, ``accepts``, the
  stacked table's offsets, forced segments and navigation) equal to the
  JAX package's; ``constrained_generate`` greedy on bridged f32 ``tiny``
  weights token for token the JAX one's, sampled runs grammatical (the
  two packages draw different bits); ``constrained_accept_batch`` greedy
  equal to JAX's on equal inputs, its sampled rows held to
  ``sampling_probs`` by their distribution; ``merge_forced`` equal.
* The servers: the JAX package's tests/test_spec_v2.py grammar scenarios
  (the masked oracle under n-gram and adaptive model drafts, terminal
  retirement, sampled rows grammatical, a mixed batch, unknown automata)
  on the port's paged and contiguous servers, tokens and jump-forward
  counts equal to the JAX servers' on the same weights, free rows of a
  mixed batch bitwise the port's plain server's.
* ``make_constrained_infer`` over the wire (tests/test_serving.py:248)
  and ``run_structured`` (its payloads and automaton the JAX rig's; every
  constrained final grammatical, jump-forward tokens committed).

Logits agree within ``atol=1e-4`` (f32), greedy tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import constrained as jax_constrained
from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.models import speculative as jax_spec
from aiko_services_tpu.orchestration import continuous as jax_continuous
from aiko_services_tpu.orchestration import paged as jax_paged
from aiko_services_tpu.orchestration import serving as jax_serving
from aiko_services_tpu.tools import loadgen as jax_loadgen
from aiko_services_tpu_torch import runtime, transport
from aiko_services_tpu_torch.models import constrained, llama, speculative
from aiko_services_tpu_torch.models.bridge import params_from_numpy
from aiko_services_tpu_torch.orchestration import continuous, serving
from aiko_services_tpu_torch.orchestration.continuous import (
    ContinuousBatchingServer, DecodeRequest)
from aiko_services_tpu_torch.orchestration.paged import PagedContinuousServer
from aiko_services_tpu_torch.pipeline import codec
from aiko_services_tpu_torch.tools import loadgen
from aiko_services_tpu_torch.utils import sexpr

CONFIG = "tiny_f32"
LP, RP = 1, 2
VERBS, ARGS = (3, 4, 5), (6, 7, 8, 9)
SEXPR_RULES = {
    0: [((LP,), 1)],
    1: [(VERBS, 2)],
    2: [(ARGS, 4), ((RP,), 3)],
    4: [(ARGS, 5), ((RP,), 3)],
    5: [(ARGS, 6), ((RP,), 3)],
    6: [((RP,), 3)],
    3: [],
}
#: tests/test_spec_v2.py's mixed shapes through 2 slots.
SHAPES = [(5, 12), (11, 9), (3, 14), (17, 8)]


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


def _automata(module=constrained):
    return module.automaton_from_rules(vocab=1024, rules=SEXPR_RULES,
                                       accepting=[3])


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


# --------------------------------------------------------------------------- #
# models/constrained.py


def test_automaton_accepts_and_rejects():
    port, ref = _automata(), _automata(jax_constrained)
    for name in ("allowed", "next_state", "accepting"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    cases = [[LP, 3, 6, 7, RP], [LP, 5, RP], [3, 6, RP], [LP, 6, RP],
             [LP, 3, 6]]
    assert [port.accepts(c) for c in cases] == \
        [ref.accepts(c) for c in cases] == [True, True, False, False, False]


def test_automaton_wildcard_rules():
    kwargs = dict(vocab=16, rules={0: [("*", 1), ((5,), 2)], 1: [], 2: []},
                  accepting=[1, 2])
    port = constrained.automaton_from_rules(**kwargs)
    ref = jax_constrained.automaton_from_rules(**kwargs)
    np.testing.assert_array_equal(port.next_state, ref.next_state)
    np.testing.assert_array_equal(port.allowed, ref.allowed)
    assert port.next_state[0, 4] == 1 and port.next_state[0, 5] == 2
    assert port.allowed[0].all()


def test_automaton_table_matches_jax():
    """The stacked registry: offsets, arrays, and every state's forced
    segment, advance and terminal flag equal to the JAX table's."""
    named = {"sexpr": _automata(), "cmd": loadgen.command_automaton(1024)}
    port = constrained.stack_automata(named)
    ref = jax_constrained.stack_automata(
        {"sexpr": _automata(jax_constrained),
         "cmd": jax_loadgen.command_automaton(1024)})
    assert port.offsets == ref.offsets and port.n_states == ref.n_states
    for name in ("allowed", "next_state", "accepting"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    for state in range(port.n_states):
        assert port.deterministic_segment(state, 4) == \
            ref.deterministic_segment(state, 4)
        assert port.is_terminal(state) == ref.is_terminal(state)
        for token in (1, 3, 10, 16, 17, 900):
            assert port.advance(state, token) == ref.advance(state, token)
    with pytest.raises(ValueError, match="vocab"):
        constrained.stack_automata(
            {"a": _automata(), "b": loadgen.command_automaton(64)})


def _prefilled(params_jax, batch, seed=1, prompt_len=6):
    """Bridged weights, a random prompt batch and both packages' prefill
    logits and caches (64 rows)."""
    config = jax_llama.CONFIGS[CONFIG]
    prompts = np.random.default_rng(seed).integers(
        10, config.vocab_size, (batch, prompt_len)).astype(np.int32)
    jax_cache = jax_llama.init_cache(config, batch, 64)
    jax_logits, jax_cache = jax_llama.prefill(
        params_jax, jnp.asarray(prompts), jax_cache, config)
    params = _bridge(params_jax)
    cache = llama.init_cache(llama.CONFIGS[CONFIG], batch, 64, device="cpu")
    logits, cache = llama.prefill(params, torch.from_numpy(prompts), cache,
                                  llama.CONFIGS[CONFIG])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax_logits),
                               atol=1e-4)
    return params, logits, cache, jax_logits, jax_cache


@pytest.fixture(scope="module")
def jax_tiny_params():
    return jax_llama.init_params(
        dataclasses.replace(jax_llama.CONFIGS["tiny"], dtype=jnp.float32),
        jax.random.PRNGKey(0))


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_constrained_generate_always_grammatical(jax_tiny_params,
                                                 temperature):
    """Every row grammatical, padding after the close; greedy rows token
    for token (and final states) the JAX package's."""
    automaton = _automata()
    params, logits, cache, jax_logits, jax_cache = _prefilled(
        jax_tiny_params, 4)
    tokens, states, _ = constrained.constrained_generate(
        params, logits[:, -1], cache, 6, 12, llama.CONFIGS[CONFIG],
        automaton.allowed, automaton.next_state, pad_token=0,
        temperature=temperature,
        generator=torch.Generator().manual_seed(7))
    tokens = tokens.numpy()
    assert tokens.shape == (4, 12)
    for row in tokens:
        emitted = [int(t) for t in row]
        assert RP in emitted, emitted
        close = emitted.index(RP)
        assert all(t == 0 for t in emitted[close + 1:]), emitted
        assert automaton.accepts(emitted[:close + 1]), emitted
    if temperature == 0.0:
        jax_tokens, jax_states, _ = jax_constrained.constrained_generate(
            jax_tiny_params, jax_logits[:, -1], jax_cache, jnp.int32(6), 12,
            jax_llama.CONFIGS[CONFIG], automaton.allowed,
            automaton.next_state, pad_token=0)
        np.testing.assert_array_equal(tokens, np.asarray(jax_tokens))
        np.testing.assert_array_equal(states.numpy(), np.asarray(jax_states))


def test_constraint_actually_binds(jax_tiny_params):
    """The unconstrained greedy continuation is NOT grammatical for this
    random model: the mask does real work."""
    automaton = _automata()
    params, logits, cache, *_ = _prefilled(jax_tiny_params, 1)
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    free, _ = llama.generate_tokens(params, first, cache, 6, 8,
                                    llama.CONFIGS[CONFIG])
    tokens = [int(first[0, 0])] + free[0].tolist()
    assert not automaton.accepts(tokens) and not automaton.allowed[0,
                                                                   tokens[0]]


def test_constrained_sampled_varies_but_stays_grammatical(jax_tiny_params):
    automaton = _automata()
    outs = set()
    for seed in range(4):
        params, logits, cache, *_ = _prefilled(jax_tiny_params, 1)
        tokens, _, _ = constrained.constrained_generate(
            params, logits[:, -1], cache, 6, 10, llama.CONFIGS[CONFIG],
            automaton.allowed, automaton.next_state, temperature=1.5,
            generator=torch.Generator().manual_seed(seed))
        emitted = tokens[0].tolist()
        assert automaton.accepts(emitted[:emitted.index(RP) + 1])
        outs.add(tuple(emitted))
    assert len(outs) > 1


def _accept_inputs(seed=0, slots=6, k=4, vocab=64):
    rng = np.random.default_rng(seed)
    automaton = constrained.automaton_from_rules(
        vocab=vocab, rules=dict(SEXPR_RULES), accepting=[3])
    logits = rng.standard_normal((slots, k + 1, vocab)).astype(np.float32)
    base_window = rng.integers(0, vocab, (slots, k + 1)).astype(np.int32)
    base_counts = rng.integers(1, k + 2, slots).astype(np.int32)
    forced = rng.integers(0, vocab, (slots, k)).astype(np.int32)
    forced_counts = np.array([0, 2, 4, 1, 0, 3], np.int32)[:slots]
    states = np.array([0, 1, 2, 3, 4, 6], np.int32)[:slots]   # 3: terminal
    cons = np.array([True, True, True, True, False, True])[:slots]
    return automaton, dict(
        target_logits=logits, base_window=base_window,
        base_counts=base_counts, forced=forced, forced_counts=forced_counts,
        states=states, cons_mask=cons)


def test_constrained_accept_batch_matches_jax():
    """Greedy rows equal to the JAX kernel's on equal inputs, a terminal
    row committing its forced prefix only, unconstrained rows passing
    through."""
    automaton, inputs = _accept_inputs()
    slots = inputs["states"].shape[0]
    temps = np.zeros(slots, np.float32)
    tops = np.ones(slots, np.float32)
    jax_window, jax_counts = jax_constrained.constrained_accept_batch(
        *[jnp.asarray(v) for v in inputs.values()],
        jnp.asarray(automaton.allowed), jnp.asarray(temps),
        jnp.asarray(tops), jax.random.PRNGKey(0))
    window, counts = constrained.constrained_accept_batch(
        *[torch.from_numpy(v) for v in inputs.values()],
        torch.from_numpy(automaton.allowed), torch.from_numpy(temps),
        torch.from_numpy(tops))
    np.testing.assert_array_equal(window.numpy(), np.asarray(jax_window))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jax_counts))
    assert counts[3] == inputs["forced_counts"][3]       # terminal row


def test_constrained_accept_batch_samples_the_masked_distribution():
    """A sampled constrained row draws its free token from the masked
    ``sampling_probs`` (the two packages' random bits differ, so the
    distribution is what is held): 4,000 identical rows, every draw
    allowed, frequencies within 0.03 of the probabilities."""
    automaton, inputs = _accept_inputs()
    row = 2                     # state 2: args or the close allowed
    n = 4000
    tiled = {key: np.repeat(value[row:row + 1], n, axis=0)
             for key, value in inputs.items()}
    temps = np.full(n, 0.8, np.float32)
    tops = np.full(n, 0.95, np.float32)
    window, counts = constrained.constrained_accept_batch(
        *[torch.from_numpy(v) for v in tiled.values()],
        torch.from_numpy(automaton.allowed), torch.from_numpy(temps),
        torch.from_numpy(tops), torch.Generator().manual_seed(3))
    fc = int(inputs["forced_counts"][row])
    free = window[:, fc].numpy()
    assert automaton.allowed[inputs["states"][row]][free].all()
    assert (counts.numpy() == fc + 1).all()
    logits = torch.from_numpy(inputs["target_logits"][row, fc][None])
    masked = torch.where(torch.from_numpy(automaton.allowed[
        inputs["states"][row]][None]), logits, -torch.inf)
    probs = llama.sampling_probs(masked, torch.tensor([[0.8]]),
                                 torch.tensor([[0.95]]))[0].numpy()
    freq = np.bincount(free, minlength=probs.shape[0]) / n
    assert np.abs(freq - probs).max() < 0.03


def test_merge_forced_matches_jax():
    rng = np.random.default_rng(4)
    proposals = rng.integers(0, 99, (5, 4)).astype(np.int32)
    forced = rng.integers(0, 99, (5, 4)).astype(np.int32)
    mask = np.array([True, False, True, False, False])
    np.testing.assert_array_equal(
        speculative.merge_forced(torch.from_numpy(proposals),
                                 torch.from_numpy(forced),
                                 torch.from_numpy(mask)).numpy(),
        np.asarray(jax_spec.merge_forced(jnp.asarray(proposals),
                                         jnp.asarray(forced),
                                         jnp.asarray(mask))))


# --------------------------------------------------------------------------- #
# The servers' grammar path


def _pair(layout="paged", **kwargs):
    """A JAX server and the port's (CPU) on the JAX server's weights;
    ``ring_max=2`` on both pins the in-flight rings to the traffic."""
    kwargs = dict(dict(slots=2, max_seq=96, chunk_steps=4, seed=3,
                       ring_max=2), **kwargs)
    if layout == "paged":
        kwargs.setdefault("block_size", 16)
        jax_cls, port_cls = (jax_paged.PagedContinuousServer,
                             PagedContinuousServer)
    else:
        jax_cls, port_cls = (jax_continuous.ContinuousBatchingServer,
                             ContinuousBatchingServer)
    jax_server = jax_cls(config_name=CONFIG, **kwargs)
    if kwargs.get("draft_config_name"):
        jax_server._draft["params"] = jax_server.params
    params = _bridge(jax_server.params)
    kwargs.pop("seed")
    port_server = port_cls(
        config_name=CONFIG, params=params, device="cpu",
        draft_params=params if kwargs.get("draft_config_name") else None,
        **kwargs)
    return jax_server, port_server


def _drain(server, spec, seed=0, automaton_for=None, **kwargs):
    """``spec`` (prompt_len, new) requests from ``seed`` into either
    package's server; ``automaton_for`` (index -> name or None) picks each
    request's grammar."""
    module = (continuous if isinstance(server, ContinuousBatchingServer)
              else jax_continuous)
    rng = np.random.default_rng(seed)
    requests = []
    for index, (plen, new) in enumerate(spec):
        prompt = rng.integers(1, 1024, plen).astype(np.int32)
        requests.append(module.DecodeRequest(
            f"r{index}", prompt, new,
            automaton=automaton_for(index) if automaton_for else None,
            **kwargs))
    for request in requests:
        server.submit(request)
    server.run_until_drained()
    return requests


def _masked_oracle(server, prompt, automaton, max_new):
    """The masked-argmax host oracle on the port's own weights: batch-1
    prefill, then each step's logits filtered through the automaton,
    stopping at an accepting state with no legal continuation."""
    config = server.config
    cache = llama.init_cache(config, 1, server.max_seq, device="cpu")
    position = len(prompt)
    logits, cache = llama.prefill(
        server.params, torch.from_numpy(np.asarray(prompt, np.int32))[None],
        cache, config)
    logits = logits[:, -1]
    state, tokens = 0, []
    for _ in range(max_new):
        masked = np.where(automaton.allowed[state], logits[0].numpy(),
                          -np.inf)
        token = int(masked.argmax())
        tokens.append(token)
        state = int(automaton.next_state[state, token])
        if automaton.accepting[state] and not automaton.allowed[state].any():
            break
        logits, cache = llama.decode_step(
            server.params, torch.tensor([[token]], dtype=torch.int32), cache,
            position, config)
        logits = logits[:, -1]
        position += 1
    return tokens


GRAMMAR_SPEC = [(5, 16), (11, 16), (3, 16), (7, 16)]


@pytest.mark.parametrize("mode_kwargs", [
    dict(draft_mode="ngram", spec_k=4),
    dict(draft_config_name=CONFIG, spec_k=4, spec_adaptive=True),
], ids=["ngram", "model-adaptive"])
def test_constrained_greedy_matches_masked_oracle(mode_kwargs):
    """Every constrained request equals the masked oracle and the JAX
    server's tokens; the jump-forward counter is the JAX server's, > 0."""
    jax_server, server = _pair(automata={"sexpr": _automata()},
                               **mode_kwargs)
    port = _drain(server, GRAMMAR_SPEC,
                  automaton_for=lambda i: "sexpr")
    ref = _drain(jax_server, GRAMMAR_SPEC,
                 automaton_for=lambda i: "sexpr")
    automaton = _automata()
    for request, ref_request in zip(port, ref):
        assert list(request.tokens) == list(ref_request.tokens)
        assert list(request.tokens) == _masked_oracle(
            server, request.prompt, automaton, 16)
        assert automaton.accepts(list(request.tokens))
    assert server.stats()["spec_jump_forward_tokens"] == \
        jax_server.stats()["spec_jump_forward_tokens"] > 0
    assert server.pool_balance()["free"] == server.total_blocks


def test_constrained_on_the_contiguous_layout_matches_jax():
    """The contiguous server's grammar round (its verify on the slot rows)
    gives the JAX contiguous server's tokens and jump-forward count."""
    jax_server, server = _pair("contiguous", draft_mode="ngram", spec_k=4,
                               automata={"sexpr": _automata()})
    port = _drain(server, GRAMMAR_SPEC,
                  automaton_for=lambda i: "sexpr" if i % 2 else None)
    ref = _drain(jax_server, GRAMMAR_SPEC,
                 automaton_for=lambda i: "sexpr" if i % 2 else None)
    assert [r.tokens for r in port] == [list(r.tokens) for r in ref]
    assert server.stats()["spec_jump_forward_tokens"] == \
        jax_server.stats()["spec_jump_forward_tokens"] > 0


def test_constrained_terminal_retires_early():
    """Reaching the accepting terminal state retires the request with
    budget left."""
    server = _pair(draft_mode="ngram", spec_k=4,
                   automata={"sexpr": _automata()})[1]
    for request in _drain(server, [(5, 64), (9, 64)],
                          automaton_for=lambda i: "sexpr"):
        assert 0 < len(request.tokens) < 64
        assert _automata().accepts(list(request.tokens))


def test_constrained_sampled_stays_grammatical():
    server = _pair(draft_mode="ngram", spec_k=4,
                   automata={"sexpr": _automata()})[1]
    for request in _drain(server,
                          [(5, 24), (9, 24), (3, 24), (7, 24)],
                          automaton_for=lambda i: "sexpr", temperature=0.9,
                          top_p=0.95):
        assert _automata().accepts(list(request.tokens))


def test_mixed_constrained_unconstrained_batch():
    """Constrained and free slots share rounds: the free rows stay bitwise
    the port's plain server's (port against port) and the JAX server's,
    the constrained rows grammatical and the JAX server's."""
    jax_server, server = _pair(draft_config_name=CONFIG, spec_k=4,
                               automata={"sexpr": _automata()})
    plain = PagedContinuousServer(config_name=CONFIG, params=server.params,
                                  device="cpu", slots=2, max_seq=96,
                                  chunk_steps=4, block_size=16)
    base = _drain(plain, SHAPES)
    pick = (lambda i: "sexpr" if i % 2 else None)
    port = _drain(server, SHAPES, automaton_for=pick)
    ref = _drain(jax_server, SHAPES, automaton_for=pick)
    for index, (request, ref_request) in enumerate(zip(port, ref)):
        assert list(request.tokens) == list(ref_request.tokens)
        if index % 2:
            assert _automata().accepts(list(request.tokens))
        else:
            assert request.tokens == base[index].tokens


def test_unknown_automaton_rejected():
    server = PagedContinuousServer(
        config_name=CONFIG, slots=2, max_seq=96, device="cpu",
        draft_mode="ngram", spec_k=4, automata={"sexpr": _automata()})
    request = DecodeRequest("r0", np.asarray([5, 6, 7], np.int32), 4,
                            automaton="nope")
    server.submit(request)
    server.run_until_drained()
    assert request.error == "unknown_automaton"
    bare = PagedContinuousServer(config_name=CONFIG, slots=2, max_seq=96,
                                 device="cpu", draft_mode="ngram", spec_k=4)
    request = DecodeRequest("r1", np.asarray([5, 6, 7], np.int32), 4,
                            automaton="sexpr")
    bare.submit(request)
    bare.run_until_drained()
    assert request.error == "unknown_automaton"
    assert bare.stats()["spec_draft_mode"] == "ngram"
    with pytest.raises(ValueError, match="vocab"):
        PagedContinuousServer(config_name=CONFIG, slots=1, max_seq=32,
                              device="cpu",
                              automata={"g": loadgen.command_automaton(64)})


# --------------------------------------------------------------------------- #
# make_constrained_infer and the structured rig


def test_constrained_replica_grammatical_over_wire(jax_tiny_params):
    """tests/test_serving.py:248 on the port: a ModelReplica over
    ``make_constrained_infer`` answers grammatical rows over the wire;
    greedy, on the JAX factory's weights, its rows equal the JAX
    factory's answer."""
    automaton = constrained.automaton_from_rules(
        vocab=1024,
        rules={0: [((LP,), 1)], 1: [((3, 4, 5), 2)],
               2: [((6, 7, 8, 9), 4), ((RP,), 3)], 4: [((RP,), 3)], 3: []},
        accepting=[3])
    prompt = np.asarray([[30, 40, 50, 60]], np.int32)
    infer = serving.make_constrained_infer(
        CONFIG, automaton=automaton, max_new_tokens=8,
        params=_bridge(jax_tiny_params), device="cpu")
    ref = jax_serving.make_constrained_infer(
        CONFIG, automaton=jax_constrained.automaton_from_rules(
            vocab=1024,
            rules={0: [((LP,), 1)], 1: [((3, 4, 5), 2)],
                   2: [((6, 7, 8, 9), 4), ((RP,), 3)], 4: [((RP,), 3)],
                   3: []}, accepting=[3]), max_new_tokens=8)
    expected = ref({"tokens": prompt})
    transport.reset_brokers()
    engine = runtime.EventEngine(clock=runtime.VirtualClock())
    process = runtime.Process(namespace="test", hostname="h", pid="2",
                              engine=engine, broker="grammar")
    replica = runtime.compose_instance(
        serving.ModelReplica, runtime.actor_args("grammar_replica"),
        process=process, infer=infer)
    responses = []

    def handler(_topic, payload):
        command, params = sexpr.parse(payload)
        if command == "infer_response":
            responses.append(codec.decode_swag(params[1]))
    process.add_message_handler(handler, "test/h/2/client/response")
    process.message.publish(
        f"{replica.topic_path}/in",
        sexpr.generate("infer", ["g1", "test/h/2/client/response",
                                 codec.encode_swag({"tokens": prompt})]))
    engine.drain()
    (outputs,) = responses
    np.testing.assert_array_equal(outputs["tokens_out"],
                                  expected["tokens_out"])
    np.testing.assert_array_equal(outputs["accepted"], expected["accepted"])
    row = [int(t) for t in np.asarray(outputs["tokens_out"])[0]]
    assert automaton.accepts(row[:row.index(RP) + 1])
    transport.reset_brokers()
    with pytest.raises(ValueError, match="automaton"):
        serving.make_constrained_infer(CONFIG, device="cpu")


def test_structured_payloads_and_automaton_match_jax():
    """The rig's traffic is the JAX rig's, request for request."""
    port, ref = loadgen.command_automaton(), jax_loadgen.command_automaton()
    for name in ("allowed", "next_state", "accepting"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    for constrained_side in (True, False):
        mine = loadgen.structured_payloads(seed=5,
                                           constrained=constrained_side)
        theirs = jax_loadgen.structured_payloads(
            seed=5, constrained=constrained_side)
        for index in range(7):
            a, b = mine(index), theirs(index)
            assert set(a) == set(b)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.fixture()
def _one_thread():
    """A shared CPU makes torch's intra-op pool slow the tiny model's steps
    ~100-fold: the rig runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    transport.reset_brokers()
    yield
    torch.set_num_threads(threads)
    transport.reset_brokers()


def test_run_structured_on_the_cpu(_one_thread, monkeypatch):
    """``run_structured`` (n-gram, k 4): every constrained final
    grammatical (the rig raises otherwise), nothing lost, the skeleton's
    forced segments committed through verify windows, the free side
    answering the same payloads."""
    from aiko_services_tpu_torch.registry import registrar
    # Nothing contests the rig's election: shorten the primary search.
    monkeypatch.setattr(registrar, "PRIMARY_SEARCH_TIMEOUT", 0.05)
    cons, free = loadgen.run_structured(n_requests=8, rate_hz=50.0,
                                        device="cpu")
    assert cons.completed == free.completed == 8
    assert cons.lost == cons.timeouts == 0
    assert cons.spec_stats["spec_jump_forward_tokens"] > 0
    assert len(cons.final_tokens) == 8
    automaton = loadgen.command_automaton()
    assert all(automaton.accepts(tokens)
               for tokens in cons.final_tokens.values())
