"""Port parity: the port's ``ContinuousBatchingServer`` against the JAX
package's, on the scenarios of tests/test_continuous.py.

Both servers run an f32 copy of ``tiny`` (registered in both config
tables for the test) on the SAME weights: the JAX server builds them from
its seed and the port receives them through the weight bridge.  Every
greedy request must produce the JAX server's tokens and the port's own
batch-1 oracle (``prefill`` + ``generate_tokens``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.orchestration import continuous as jax_continuous
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.models.bridge import params_from_numpy
from aiko_services_tpu_torch.orchestration.continuous import (
    ContinuousBatchingServer, DecodeRequest)

CONFIG = "tiny_f32"


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


def _pair(**kwargs):
    """A JAX server and a port server (CPU) on the JAX server's weights."""
    jax_server = jax_continuous.ContinuousBatchingServer(
        config_name=CONFIG, **kwargs)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_server.params),
                               "cpu")
    kwargs.pop("seed", None)
    port_server = ContinuousBatchingServer(config_name=CONFIG, params=params,
                                           device="cpu", **kwargs)
    return jax_server, port_server


def reference_greedy(server, prompt, max_new):
    """Per-request oracle: prefill + generate_tokens at batch 1 with the
    port server's own params."""
    config = server.config
    prompt = torch.from_numpy(np.asarray(prompt, np.int32))[None, :]
    cache = llama.init_cache(config, 1, server.max_seq,
                             quantize_kv=server.quantize_kv, device="cpu")
    logits, cache = llama.prefill(server.params, prompt, cache, config)
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    if max_new == 1:
        return [int(first[0, 0])]
    tokens, _ = llama.generate_tokens(server.params, first, cache,
                                      prompt.shape[1], max_new - 1, config)
    return [int(first[0, 0])] + tokens[0].tolist()


def _requests(module, specs, seed, vocab=1024):
    rng = np.random.default_rng(seed)
    out = []
    for i, (plen, new) in enumerate(specs):
        prompt = rng.integers(1, vocab, plen).astype(np.int32)
        out.append(module(f"r{i}", prompt, new))
    return out


def _serve(server, requests):
    for request in requests:
        server.submit(request)
    finished = server.run_until_drained()
    assert sorted(r.request_id for r in finished) == \
        sorted(r.request_id for r in requests)
    return requests


def test_six_requests_through_two_slots():
    """Forced queueing + slot reuse: every output equals the JAX server's
    and the port's batch-1 oracle."""
    specs = [(5, 6), (11, 3), (3, 9), (17, 5), (8, 1), (24, 7)]
    jax_server, port_server = _pair(slots=2, max_seq=96, chunk_steps=4,
                                    seed=3)
    ref = _serve(jax_server, _requests(jax_continuous.DecodeRequest, specs,
                                       0))
    got = _serve(port_server, _requests(DecodeRequest, specs, 0))
    for want, have in zip(ref, got):
        assert have.tokens == want.tokens, have.request_id
        assert have.tokens == reference_greedy(port_server, have.prompt,
                                               have.max_new_tokens)
    stats = port_server.stats()
    assert stats["tokens_committed"] == sum(new for _, new in specs)
    assert stats["prefill_dispatches"] >= 3
    assert stats["decode_attention_path"] == "reference"


def test_late_admission_does_not_disturb_running_slots():
    jax_server, port_server = _pair(slots=2, max_seq=96, chunk_steps=2,
                                    seed=4)
    outputs = []
    for server, module in ((jax_server, jax_continuous.DecodeRequest),
                           (port_server, DecodeRequest)):
        rng = np.random.default_rng(1)
        a = module("a", rng.integers(1, 500, 9).astype(np.int32), 8)
        b = module("b", rng.integers(1, 500, 13).astype(np.int32), 8)
        server.submit(a)
        server.step()                   # a runs alone for one chunk
        server.submit(b)                # b admitted mid-flight
        server.run_until_drained()
        outputs.append((a.tokens, b.tokens))
    assert outputs[0] == outputs[1]
    a_tokens, b_tokens = outputs[1]
    rng = np.random.default_rng(1)
    a_prompt = rng.integers(1, 500, 9).astype(np.int32)
    b_prompt = rng.integers(1, 500, 13).astype(np.int32)
    assert a_tokens == reference_greedy(port_server, a_prompt, 8)
    assert b_tokens == reference_greedy(port_server, b_prompt, 8)


def test_eos_retires_slot_early():
    jax_server, port_server = _pair(slots=1, max_seq=96, chunk_steps=4,
                                    seed=5)
    prompt = np.arange(1, 8, dtype=np.int32)
    want = reference_greedy(port_server, prompt, 12)
    eos = want[2]                   # third generated token becomes EOS
    for server, module in ((jax_server, jax_continuous.DecodeRequest),
                           (port_server, DecodeRequest)):
        server.eos_id = eos
        request = module("e", prompt, 12)
        server.submit(request)
        server.run_until_drained()
        assert request.tokens == want[:3]     # truncated at the EOS token


@pytest.mark.parametrize("prompt,error", [
    (np.ones(40, np.int32), "prompt_too_long"),
    (np.zeros(0, np.int32), "empty_prompt")])
def test_bad_prompts_rejected_cleanly(prompt, error):
    jax_server, port_server = _pair(slots=1, max_seq=32, chunk_steps=2)
    for server, module in ((jax_server, jax_continuous.DecodeRequest),
                           (port_server, DecodeRequest)):
        server.submit(module("x", prompt, 8))
        finished = server.run_until_drained()
        assert finished[0].error == error
        assert finished[0].tokens == []


def test_mixed_greedy_and_sampled_slots():
    """A sampled request sharing the batch does not perturb a greedy
    one: the greedy row equals the JAX server's and the oracle; the
    sampled row (different RNGs) is held to its length and range."""
    jax_server, port_server = _pair(slots=2, max_seq=96, chunk_steps=4,
                                    seed=8)
    greedy_tokens = []
    for server, module in ((jax_server, jax_continuous.DecodeRequest),
                           (port_server, DecodeRequest)):
        rng = np.random.default_rng(9)
        greedy = module("g", rng.integers(1, 500, 10).astype(np.int32), 8)
        sampled = module("s", rng.integers(1, 500, 7).astype(np.int32), 8,
                         temperature=1.0, top_p=0.9)
        server.submit(greedy)
        server.submit(sampled)
        server.run_until_drained()
        greedy_tokens.append(greedy.tokens)
        assert len(sampled.tokens) == 8
        assert all(0 <= t < 1024 for t in sampled.tokens)
    assert greedy_tokens[0] == greedy_tokens[1]
    assert greedy_tokens[1] == reference_greedy(port_server, greedy.prompt,
                                                8)


def test_int8_weights_and_kv_match_jax_server():
    """The main path's layout: int8 weights and int8 KV, three requests
    through two slots, tokens equal to the JAX server's."""
    specs = [(9, 5), (20, 4), (4, 6)]
    jax_server, port_server = _pair(slots=2, max_seq=64, chunk_steps=3,
                                    seed=11, quantize=True,
                                    quantize_kv=True)
    ref = _serve(jax_server, _requests(jax_continuous.DecodeRequest, specs,
                                       12))
    got = _serve(port_server, _requests(DecodeRequest, specs, 12))
    assert [r.tokens for r in got] == [r.tokens for r in ref]


def test_no_device_raises_without_cuda():
    """Entry points run on the card unless told otherwise: with no
    device given and no CUDA present they raise instead of quietly
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingServer(config_name=CONFIG, slots=1, max_seq=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_cache(llama.CONFIGS[CONFIG], 1, 32)


@pytest.mark.parametrize("option", [
    dict(mesh=object()), dict(replica_mesh=object()),
    dict(adapters={"a": {}}), dict(draft_config_name="tiny"),
    dict(automata={"g": object()}), dict(chunk_prefill_tokens=16),
    dict(compilation_cache_dir="cache")])
def test_features_outside_the_slice_raise(option):
    with pytest.raises(NotImplementedError):
        ContinuousBatchingServer(config_name=CONFIG, slots=1, max_seq=32,
                                 device="cpu", **option)


def test_cancel_update_and_shedding():
    """Host-side control on the port: cancel keeps partial tokens, a
    budget edit mid-flight drains to exactly the new budget, a full
    queue sheds with a retry hint, an expired deadline is rejected."""
    server = ContinuousBatchingServer(config_name=CONFIG, slots=1,
                                      max_seq=64, chunk_steps=2,
                                      max_queue=1, device="cpu")
    a = DecodeRequest("a", np.arange(1, 6, dtype=np.int32), 20)
    b = DecodeRequest("b", np.arange(1, 4, dtype=np.int32), 4)
    c = DecodeRequest("c", np.arange(1, 4, dtype=np.int32), 4)
    late = DecodeRequest("late", np.arange(1, 4, dtype=np.int32), 4,
                         deadline_ts=0.0)
    server.submit(a)
    server.step()
    server.submit(b)
    server.submit(c)                 # queue holds b: c is shed
    server.submit(late)
    assert c.error == "overloaded" and c.retry_after_ms > 0
    assert late.error == "deadline_exceeded"
    server.step()
    assert server.update_sampling("a", max_new_tokens=6)
    assert server.update_sampling("b", temperature=0.0)
    server.run_until_drained()
    assert a.error is None and len(a.tokens) == 6
    assert b.tokens == reference_greedy(server, b.prompt, 4)
    d = DecodeRequest("d", np.arange(1, 6, dtype=np.int32), 20)
    server.submit(d)
    server.step()
    server.step()
    assert server.cancel("d") and d.error == "cancelled"
    assert 0 < len(d.tokens) < 20
    assert d.tokens == reference_greedy(server, d.prompt, 20)[:len(d.tokens)]
    assert not server.cancel("nope")
    stats = server.stats()
    assert stats["shed"] == 1 and stats["deadline_exceeded"] == 1


def test_steady_decode_uploads_no_state():
    """After admission the decode loop uploads nothing: the resident
    state advances on the device and only dirty rows ever travel."""
    server = ContinuousBatchingServer(config_name=CONFIG, slots=2,
                                      max_seq=96, chunk_steps=2,
                                      device="cpu")
    server.submit(DecodeRequest("s", np.arange(1, 9, dtype=np.int32), 16))
    server.step()
    uploads = server.counters["state_uploads"]
    for _ in range(4):
        server.step()
    assert server.counters["state_uploads"] == uploads
    assert server.stats()["ring_depth"] >= 2
    server.run_until_drained()
