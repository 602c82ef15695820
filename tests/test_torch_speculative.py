"""Port parity: the contiguous layout's residue and the standalone
speculation loops, against the JAX package, on the CPU.

Both packages run f32 copies of ``tiny`` and ``mistral_tiny`` (sliding
window 16), registered in both config tables for the test, on the SAME
weights: the JAX side builds them from a PRNG key and the port receives
them through the weight bridge.

* ``models/llama.py``: ``prefill_chunk`` and ``verify_chunk_ragged``
  (per-row starts, an inactive row, int8 KV) against the JAX functions:
  logits within 1e-4 (1e-3 with int8 KV), the active rows' cache rows
  within 2e-5 (int8 codes within one step); ``decode_chunk_ragged``
  greedy tokens equal and its ``return_logits`` rows within 1e-4;
  rolling caches (prefill, then decode past three windows) equal in
  tokens and within 1e-4 in logits, the rejections raising with the JAX
  messages; ``complete`` equal to JAX's, with and without ``eos_token``;
  and against a third oracle, ``transformers.LlamaForCausalLM`` built in
  the test.
* ``models/speculative.py``: ``speculative_generate`` equal to JAX in
  tokens and ``SpecStats`` (a distinct and a self draft); the sampled
  loop by its distribution and its determinism (the two packages draw
  different random bits).
* ``make_speculative_infer``, ``run_spec_ab`` and the CLI's ``--spec-k``.

The contiguous server's speculation, chunked admission and legacy upload
are held to the JAX server in tests/test_torch_spec.py, beside the paged
server's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.models import speculative as jax_spec
from aiko_services_tpu.orchestration import serving as jax_serving
from aiko_services_tpu_torch.models import llama, speculative
from aiko_services_tpu_torch.models.bridge import params_from_numpy
from aiko_services_tpu_torch.orchestration import serving
from aiko_services_tpu_torch.registry import registrar as port_registrar
from aiko_services_tpu_torch.tools import loadgen

CONFIG = "tiny_f32"
ROLLING = "mistral_tiny_f32"


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_cold():
    """Later test modules in the same worker count their own JAX
    compiles; drop what this module compiled once it is done."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _f32_configs(monkeypatch):
    for name, base in ((CONFIG, "tiny"), (ROLLING, "mistral_tiny")):
        monkeypatch.setitem(
            jax_llama.CONFIGS, name,
            dataclasses.replace(jax_llama.CONFIGS[base], dtype=jnp.float32))
        monkeypatch.setitem(
            llama.CONFIGS, name,
            dataclasses.replace(llama.CONFIGS[base], dtype=torch.float32))


def _params(name=CONFIG, seed=0):
    """JAX params of ``name`` from ``PRNGKey(seed)`` and their bridge."""
    jax_params = jax_llama.init_params(jax_llama.CONFIGS[name],
                                       jax.random.PRNGKey(seed))
    return jax_params, params_from_numpy(jax.tree.map(np.asarray,
                                                      jax_params), "cpu")


def _tokens(rng, shape, vocab=1024):
    return rng.integers(1, vocab, shape).astype(np.int32)


def _assert_rows(cache, jax_cache, rows):
    """The cache rows ``rows[b]`` (a slice a batch row) equal: f32 within
    2e-5, int8 codes within one step (a value at a rounding edge may land
    on either side after matmuls in another order), scales within 1e-5."""
    for layer, jax_layer in zip(cache, jax_cache):
        for key, buf in layer.items():
            for b, span in enumerate(rows):
                got = buf.numpy()[b, span].astype(np.float32)
                want = np.asarray(jax_layer[key])[b, span].astype(np.float32)
                atol = 1 if buf.dtype == torch.int8 else 2e-5
                np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5,
                                           err_msg=f"{key} row {b}")


def _prefilled(prompts, quantize_kv, max_seq=64, name=CONFIG):
    """Each prompt prefilled at batch 1 on both sides, then stacked into a
    (rows, max_seq) cache: a contiguous server's slot rows."""
    jax_params, params = _params(name)
    jax_config, config = jax_llama.CONFIGS[name], llama.CONFIGS[name]
    jax_caches, caches = [], []
    for prompt in prompts:
        jax_cache = jax_llama.init_cache(jax_config, 1, max_seq,
                                         quantize_kv=quantize_kv)
        _, jax_cache = jax_llama.prefill(jax_params,
                                         jnp.asarray(prompt)[None],
                                         jax_cache, jax_config)
        jax_caches.append(jax_cache)
        cache = llama.init_cache(config, 1, max_seq,
                                 quantize_kv=quantize_kv, device="cpu")
        _, cache = llama.prefill(params, torch.from_numpy(prompt)[None],
                                 cache, config)
        caches.append(cache)
    jax_cache = [{key: jnp.concatenate([c[i][key] for c in jax_caches])
                  for key in jax_caches[0][i]}
                 for i in range(len(jax_caches[0]))]
    cache = [{key: torch.cat([c[i][key] for c in caches])
              for key in caches[0][i]} for i in range(len(caches[0]))]
    return jax_params, params, jax_config, config, jax_cache, cache


# --------------------------------------------------------------------------- #
# models/llama.py: the chunk stack

@pytest.mark.parametrize("quantize_kv", [False, True])
def test_prefill_chunk_matches_jax(quantize_kv):
    """A 7-token chunk at position 13 of two prefilled rows: logits within
    1e-4 (1e-3 with int8 KV), cache rows [0, 20) equal."""
    rng = np.random.default_rng(3)
    prompts = [_tokens(rng, 13), _tokens(rng, 13)]
    jax_params, params, jax_config, config, jax_cache, cache = \
        _prefilled(prompts, quantize_kv)
    chunk = _tokens(rng, (2, 7))
    jax_logits, jax_cache = jax_llama.prefill_chunk(
        jax_params, jnp.asarray(chunk), jax_cache, jnp.int32(13),
        jax_config)
    logits, cache = llama.prefill_chunk(params, torch.from_numpy(chunk),
                                        cache, 13, config)
    tol = 1e-3 if quantize_kv else 1e-4
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax_logits),
                               rtol=tol, atol=tol)
    _assert_rows(cache, jax_cache, [slice(0, 20)] * 2)


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_verify_chunk_ragged_matches_jax(quantize_kv):
    """Three slots verify a 5-token window at their own positions (6, 17
    and 29), the middle one inactive: the active rows' logits within 1e-4
    (1e-3 with int8 KV) and their cache rows equal; the inactive row's
    garbage is not held."""
    rng = np.random.default_rng(4)
    prompts = [_tokens(rng, 7), _tokens(rng, 18), _tokens(rng, 30)]
    jax_params, params, jax_config, config, jax_cache, cache = \
        _prefilled(prompts, quantize_kv)
    window = _tokens(rng, (3, 5))
    positions = np.array([6, 17, 29], np.int32)
    active = np.array([True, False, True])
    jax_logits, jax_cache = jax_llama.verify_chunk_ragged(
        jax_params, jnp.asarray(window), jax_cache, jnp.asarray(positions),
        jnp.asarray(active), jax_config)
    logits, cache = llama.verify_chunk_ragged(
        params, torch.from_numpy(window), cache,
        torch.from_numpy(positions), torch.from_numpy(active), config)
    tol = 1e-3 if quantize_kv else 1e-4
    for row in (0, 2):
        np.testing.assert_allclose(logits.numpy()[row],
                                   np.asarray(jax_logits)[row], rtol=tol,
                                   atol=tol)
    _assert_rows([{k: v[[0, 2]] for k, v in layer.items()}
                  for layer in cache],
                 [{k: v[jnp.asarray([0, 2])] for k, v in layer.items()}
                  for layer in jax_cache], [slice(0, 11), slice(0, 34)])


def test_prefill_chunk_matches_whole_prefill():
    """tests/test_speculative.py's check on the port: a prompt prefilled
    in two chunks equals one prefill, cache rows within 2e-5 (f32) and the
    last position's logits within 1e-4."""
    _, params = _params(seed=50)
    config = llama.CONFIGS[CONFIG]
    tokens = torch.from_numpy(_tokens(np.random.default_rng(51), (2, 24)))
    whole = llama.init_cache(config, 2, 64, device="cpu")
    logits_whole, whole = llama.prefill(params, tokens, whole, config)
    chunked = llama.init_cache(config, 2, 64, device="cpu")
    llama.prefill(params, tokens[:, :10], chunked, config)
    logits_chunk, chunked = llama.prefill_chunk(params, tokens[:, 10:],
                                                chunked, 10, config)
    for a, b in zip(whole, chunked):
        for key in ("k", "v"):
            np.testing.assert_allclose(a[key][:, :24].numpy(),
                                       b[key][:, :24].numpy(), atol=2e-5)
    np.testing.assert_allclose(logits_chunk[:, -1].numpy(),
                               logits_whole[:, -1].numpy(), atol=1e-4)


def test_verify_chunk_ragged_matches_prefill_chunk():
    """tests/test_spec_continuous.py's check on the port: the ragged verify
    at per-row positions gives each row's batch-1 prefill_chunk logits,
    within 1e-4 at f32."""
    rng = np.random.default_rng(1)
    lens = (6, 11)
    prompts = [_tokens(rng, n) for n in lens]
    _, params, _, config, _, merged = _prefilled(prompts, False)
    chunks = _tokens(rng, (2, 4))
    want = []
    for row, n in enumerate(lens):
        cache = [{key: buf[row:row + 1].clone() for key, buf in layer.items()}
                 for layer in merged]
        logits, _ = llama.prefill_chunk(
            params, torch.from_numpy(chunks[row:row + 1]), cache, n - 1,
            config)
        want.append(logits[0].numpy())
    got, _ = llama.verify_chunk_ragged(
        params, torch.from_numpy(chunks), merged,
        torch.tensor([lens[0] - 1, lens[1] - 1], dtype=torch.int32),
        torch.ones(2, dtype=torch.bool), config)
    for row in range(2):
        np.testing.assert_allclose(got[row].numpy(), want[row], atol=1e-4)


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_decode_chunk_ragged_matches_jax(quantize_kv):
    """Six greedy steps from per-row positions with an inactive row: the
    active rows' tokens equal, their ``return_logits`` rows within 1e-4
    (1e-3 with int8 KV), positions equal (the inactive one frozen)."""
    rng = np.random.default_rng(5)
    prompts = [_tokens(rng, 9), _tokens(rng, 14), _tokens(rng, 4)]
    jax_params, params, jax_config, config, jax_cache, cache = \
        _prefilled(prompts, quantize_kv)
    tokens = np.array([[p[-1]] for p in prompts], np.int32)
    positions = np.array([8, 13, 3], np.int32)
    active = np.array([True, True, False])
    jax_out, jax_logits, _, jax_pos, _ = jax_llama.decode_chunk_ragged(
        jax_params, jnp.asarray(tokens), jax_cache, jnp.asarray(positions),
        jnp.asarray(active), 6, jax_config, return_logits=True)
    out, logits, _, pos, _ = llama.decode_chunk_ragged(
        params, torch.from_numpy(tokens), cache, torch.from_numpy(positions),
        torch.from_numpy(active), 6, config, return_logits=True)
    assert out.numpy()[:2].tolist() == np.asarray(jax_out)[:2].tolist()
    assert pos.tolist() == np.asarray(jax_pos).tolist() == [14, 19, 3]
    tol = 1e-3 if quantize_kv else 1e-4
    np.testing.assert_allclose(logits.numpy()[:2],
                               np.asarray(jax_logits)[:2], rtol=tol,
                               atol=tol)
    # The greedy program (no return_logits) gives the same tokens.
    again, _, _, _ = llama.decode_chunk_ragged(
        params, torch.from_numpy(tokens),
        _prefilled(prompts, quantize_kv)[5], torch.from_numpy(positions),
        torch.from_numpy(active), 6, config)
    assert again.numpy()[:2].tolist() == out.numpy()[:2].tolist()


def test_sampled_rows_are_teacher_forced_logits():
    """``sample_tokens_with_logits``' rows equal the decode logits of the
    tokens it sampled, teacher-forced through ``decode_step`` (1e-5); the
    same generator seed gives the same run; ``decode_chunk_ragged`` at
    temperature 0 equals its greedy program."""
    _, params = _params()
    config = llama.CONFIGS[CONFIG]
    prompt = torch.from_numpy(_tokens(np.random.default_rng(6), (2, 9)))

    def primed():
        cache = llama.init_cache(config, 2, 64, device="cpu")
        logits, cache = llama.prefill(params, prompt, cache, config)
        return logits[:, -1].argmax(-1).to(torch.int32)[:, None], cache

    first, cache = primed()
    tokens, rows, _ = llama.sample_tokens_with_logits(
        params, first, cache, 9, 6, config, 0.9,
        torch.Generator().manual_seed(7))
    again, rows_again, _ = llama.sample_tokens_with_logits(
        params, first, primed()[1], 9, 6, config, 0.9,
        torch.Generator().manual_seed(7))
    assert torch.equal(tokens, again) and torch.equal(rows, rows_again)
    token, cache = primed()
    for step in range(6):
        logits, cache = llama.decode_step(params, token, cache, 9 + step,
                                          config)
        np.testing.assert_allclose(rows[:, step].numpy(),
                                   logits[:, -1].numpy(), atol=1e-5)
        token = tokens[:, step:step + 1]
    first, cache = primed()
    positions = torch.tensor([9, 9], dtype=torch.int32)
    active = torch.ones(2, dtype=torch.bool)
    greedy, _, _, _ = llama.decode_chunk_ragged(params, first, cache,
                                                positions, active, 5, config)
    zero, _, _, _ = llama.decode_chunk_ragged(
        params, first, primed()[1], positions, active, 5, config,
        temperatures=torch.zeros(2), top_ps=torch.ones(2),
        generator=torch.Generator().manual_seed(1))
    assert torch.equal(greedy, zero)


# --------------------------------------------------------------------------- #
# models/llama.py: rolling caches

@pytest.mark.parametrize("quantize_kv", [False, True])
def test_rolling_cache_matches_jax(quantize_kv):
    """``mistral_tiny`` (window 16): a 20-token prompt prefilled into a
    rolling cache of 16 rows, then 50 decode steps (past three windows):
    every step's logits within 1e-4 of JAX's (1e-3 with int8 KV) on the
    same teacher-forced tokens, the stored positions equal; greedy
    ``generate_tokens`` equal to JAX's and to the port's own decode over a
    plain 96-row cache."""
    jax_params, params = _params(ROLLING, seed=2)
    jax_config, config = jax_llama.CONFIGS[ROLLING], llama.CONFIGS[ROLLING]
    prompt = _tokens(np.random.default_rng(7), (2, 20))
    jax_cache = jax_llama.init_cache(jax_config, 2, quantize_kv=quantize_kv,
                                     rolling=True)
    cache = llama.init_cache(config, 2, quantize_kv=quantize_kv,
                             rolling=True, device="cpu")
    assert cache[0]["k"].shape[1] == 16
    assert cache[0]["pos"].tolist() == [[-1] * 16] * 2
    jax_logits, jax_cache = jax_llama.prefill(jax_params, jnp.asarray(prompt),
                                              jax_cache, jax_config)
    logits, cache = llama.prefill(params, torch.from_numpy(prompt), cache,
                                  config)
    tol = 1e-3 if quantize_kv else 1e-4
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax_logits),
                               rtol=tol, atol=tol)
    assert cache[0]["pos"].tolist() == np.asarray(jax_cache[0]["pos"]) \
        .tolist()
    walk = _tokens(np.random.default_rng(8), (2, 50))
    for step in range(50):
        jax_logits, jax_cache = jax_llama.decode_step(
            jax_params, jnp.asarray(walk[:, step:step + 1]), jax_cache,
            jnp.int32(20 + step), jax_config)
        logits, cache = llama.decode_step(
            params, torch.from_numpy(walk[:, step:step + 1]), cache,
            20 + step, config)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jax_logits),
                                   rtol=tol, atol=tol, err_msg=str(step))
    assert cache[1]["pos"].tolist() == np.asarray(jax_cache[1]["pos"]) \
        .tolist()
    first = np.array(jax_logits[:, -1].argmax(-1), np.int32)[:, None]
    jax_tokens, _ = jax_llama.generate_tokens(
        jax_params, jnp.asarray(first), jax_cache, jnp.int32(70), 20,
        jax_config)
    tokens, _ = llama.generate_tokens(params, torch.from_numpy(first), cache,
                                      70, 20, config)
    assert tokens.tolist() == np.asarray(jax_tokens).tolist()
    if quantize_kv:
        return
    plain = llama.init_cache(config, 2, 96, device="cpu")
    llama.prefill(params, torch.from_numpy(prompt), plain, config)
    for step in range(50):
        llama.decode_step(params, torch.from_numpy(walk[:, step:step + 1]),
                          plain, 20 + step, config)
    windowed, _ = llama.generate_tokens(params, torch.from_numpy(first),
                                        plain, 70, 20, config)
    assert windowed.tolist() == tokens.tolist()


def test_rolling_cache_rejections_match_jax():
    """The layouts a rolling cache cannot take raise with the JAX
    package's messages."""
    config = llama.CONFIGS[ROLLING]
    _, params = _params(ROLLING)
    cache = llama.init_cache(config, 1, rolling=True, device="cpu")
    jax_cache = jax_llama.init_cache(jax_llama.CONFIGS[ROLLING], 1,
                                     rolling=True)
    two = np.ones((1, 2), np.int32)
    one = torch.ones(1, dtype=torch.int32)
    cases = [
        (lambda: llama.prefill_chunk(params, torch.from_numpy(two), cache,
                                     0, config),
         lambda: jax_llama.prefill_chunk(_params(ROLLING)[0],
                                         jnp.asarray(two), jax_cache,
                                         jnp.int32(0),
                                         jax_llama.CONFIGS[ROLLING])),
        (lambda: llama.verify_chunk_ragged(params, torch.from_numpy(two),
                                           cache, one, one.bool(), config),
         None),
        (lambda: llama.decode_chunk_ragged(params, one[:, None], cache, one,
                                           one.bool(), 2, config),
         None),
        (lambda: llama.init_cache(llama.CONFIGS[CONFIG], 1, rolling=True,
                                  device="cpu"),
         lambda: jax_llama.init_cache(jax_llama.CONFIGS[CONFIG], 1,
                                      rolling=True))]
    for port_call, jax_call in cases:
        with pytest.raises(ValueError) as port_error:
            port_call()
        if jax_call is not None:
            with pytest.raises(ValueError) as jax_error:
                jax_call()
            assert str(port_error.value) == str(jax_error.value)
    # One token at a time is the way to feed a rolling cache a chunk.
    llama.prefill_chunk(params, torch.ones((1, 1), dtype=torch.int32), cache,
                        0, config)
    assert cache[0]["pos"][0, 0] == 0


# --------------------------------------------------------------------------- #
# models/speculative.py and complete

@pytest.mark.parametrize("draft", ["distinct", "self"])
def test_speculative_generate_matches_jax(draft):
    """Greedy speculation equals JAX's in tokens and SpecStats, for a
    distinct draft (low acceptance) and the target as its own draft
    (every proposal accepted), and equals the port's greedy decode."""
    jax_params, params = _params(seed=50)
    jax_draft, draft_params = (_params(seed=99) if draft == "distinct"
                               else (jax_params, params))
    jax_config, config = jax_llama.CONFIGS[CONFIG], llama.CONFIGS[CONFIG]
    prompt = _tokens(np.random.default_rng(52), 12)
    want, jax_stats = jax_spec.speculative_generate(
        jax_params, jax_draft, prompt, 16, jax_config, jax_config, k=4,
        max_seq=128)
    got, stats = speculative.speculative_generate(
        params, draft_params, prompt, 16, config, config, k=4, max_seq=128)
    assert got.tolist() == np.asarray(want).tolist()
    assert (stats.target_passes, stats.drafted, stats.accepted) == (
        jax_stats.target_passes, jax_stats.drafted, jax_stats.accepted)
    assert got.tolist() == llama.complete(params, prompt[None], config,
                                          max_new_tokens=16)[0].tolist()
    if draft == "self":
        assert stats.acceptance_rate == 1.0
        assert stats.tokens_per_target_pass > 2.5
    with pytest.raises(ValueError, match="vocabulary"):
        speculative.speculative_generate(
            params, params, np.ones(4, np.int32), 4, config,
            dataclasses.replace(config, vocab_size=2048))


def test_speculative_step_preserves_target_distribution():
    """The modified-rejection-sampling step: proposals drawn from q,
    accepted with min(1, p/q), rejections resampled from the residual,
    give tokens distributed as p (20k trials, 4 sigma a bucket)."""
    rng = np.random.default_rng(0)
    vocab = 8
    p = rng.dirichlet(np.ones(vocab))
    q = rng.dirichlet(np.ones(vocab))
    n = 20_000
    counts = np.zeros(vocab)
    for _ in range(n):
        proposal = int(rng.choice(vocab, p=q))
        token, _ = speculative._speculative_step(p, q, proposal, rng)
        counts[token] += 1
    assert np.abs(counts / n - p).max() < 0.016
    np.testing.assert_allclose(speculative._softmax64([1.0, 2.0, 3.0], 0.5),
                               jax_spec._softmax64([1.0, 2.0, 3.0], 0.5))


def test_speculative_sampled_loop():
    """The sampled loop at temperature 0 is the greedy one; a seed repeats
    its run and another seed samples another; a self draft at 0.7 accepts
    nearly everything (p == q)."""
    _, target = _params()
    _, draft = _params(seed=5)
    config = llama.CONFIGS[CONFIG]
    prompt = np.asarray([5, 17, 200, 3], np.int32)
    greedy, _ = speculative.speculative_generate(target, draft, prompt, 8,
                                                 config, config, k=3)
    zero, _ = speculative.speculative_generate_sampled(
        target, draft, prompt, 8, config, config, k=3, temperature=0.0)
    assert greedy.tolist() == zero.tolist()
    runs = [speculative.speculative_generate_sampled(
        target, draft, prompt, 10, config, config, k=3, temperature=0.8,
        seed=seed) for seed in (42, 42, 43)]
    assert runs[0][0].tolist() == runs[1][0].tolist()
    assert runs[0][0].tolist() != runs[2][0].tolist()
    assert runs[0][0].shape == (10,)
    assert all(0 <= t < 1024 for t in runs[0][0])
    assert runs[0][1].tokens_per_target_pass >= 1.0
    _, stats = speculative.speculative_generate_sampled(
        target, target, prompt, 16, config, config, k=4, temperature=0.7,
        seed=1)
    assert stats.acceptance_rate > 0.95


@pytest.mark.parametrize("eos", [False, True])
def test_complete_matches_jax(eos):
    """``complete`` greedy equals JAX's on two prompts; with an
    ``eos_token`` (a token row 0 emits at step 3) both truncate and pad
    alike."""
    jax_params, params = _params(seed=11)
    jax_config, config = jax_llama.CONFIGS[CONFIG], llama.CONFIGS[CONFIG]
    prompts = _tokens(np.random.default_rng(12), (2, 9))
    plain = jax_llama.complete(jax_params, prompts, jax_config,
                               max_new_tokens=10)
    eos_token = int(plain[0, 3]) if eos else None
    want = jax_llama.complete(jax_params, prompts, jax_config,
                              max_new_tokens=10, eos_token=eos_token)
    got = llama.complete(params, prompts, config, max_new_tokens=10,
                         eos_token=eos_token)
    assert got.tolist() == np.asarray(want).tolist()
    if eos:
        first = got[0].tolist().index(eos_token)
        assert first <= 3 and (got[0, first:] == eos_token).all()


def test_entry_points_size_caches_with_a_block_view(monkeypatch):
    """``complete`` (prompt 9 + 10 new), ``speculative_generate`` (a
    ``max_seq`` of 133) and ``make_llama_infer`` allocate their contiguous
    caches at the rows asked for rounded up to a multiple of 128
    (``contiguous_rows``), whose block view the card's kernels read (a
    row count without one raises there); the rows past the ones asked for
    are masked, so ``complete`` still equals JAX's on its exact-size
    cache."""
    from aiko_services_tpu_torch.ops.paged_attention import (
        contiguous_block_size, contiguous_rows)
    assert [contiguous_rows(n) for n in (1, 128, 129, 289, 511, 512)] \
        == [128, 128, 256, 384, 512, 512]
    rows, init_cache = [], llama.init_cache

    def recorded(config, batch, max_seq=None, **kwargs):
        rows.append(max_seq)
        return init_cache(config, batch, max_seq, **kwargs)
    monkeypatch.setattr(llama, "init_cache", recorded)
    jax_params, params = _params(seed=11)
    jax_config, config = jax_llama.CONFIGS[CONFIG], llama.CONFIGS[CONFIG]
    prompts = _tokens(np.random.default_rng(12), (2, 9))
    got = llama.complete(params, prompts, config, max_new_tokens=10)
    want = jax_llama.complete(jax_params, prompts, jax_config,
                              max_new_tokens=10)
    assert got.tolist() == np.asarray(want).tolist()
    speculative.speculative_generate(params, params, prompts[0], 6, config,
                                     config, k=3, max_seq=133)
    infer = serving.make_llama_infer(CONFIG, params=params,
                                     max_new_tokens=4, device="cpu")
    infer({"tokens": prompts})
    assert rows == [128, 256, 256, 128]
    assert all(contiguous_block_size(r) == 128 for r in rows)


def test_complete_matches_transformers(tmp_path):
    """A third oracle: a tiny random ``transformers.LlamaForCausalLM``
    carried into the JAX tree by the JAX package's importer (test side
    only), then through the bridge: the port's greedy ``complete`` equals
    HF ``generate(do_sample=False)`` token for token."""
    transformers = pytest.importorskip("transformers")
    from aiko_services_tpu.tools.import_weights import import_llama
    hf_config = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_theta=10_000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_config).eval().to(torch.float32)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    jax_params, jax_config = import_llama(str(tmp_path), dtype=jnp.float32)
    config = llama.LlamaConfig(**{
        field.name: getattr(jax_config, field.name)
        for field in dataclasses.fields(llama.LlamaConfig)
        if field.name != "dtype"}, dtype=torch.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")
    prompt = np.array([[1, 5, 9, 200, 7, 42, 3, 17]], np.int32)
    got = llama.complete(params, prompt, config, max_new_tokens=12)
    with torch.no_grad():
        hf = model.generate(torch.from_numpy(prompt).long(),
                            attention_mask=torch.ones_like(
                                torch.from_numpy(prompt)).long(),
                            max_new_tokens=12, do_sample=False,
                            eos_token_id=None, pad_token_id=0)
    assert got[0].tolist() == hf[0, prompt.shape[1]:].tolist()


# --------------------------------------------------------------------------- #
# make_speculative_infer, run_spec_ab and the CLI

def test_make_speculative_infer_matches_jax():
    """The port's factory on the JAX factory's weights (bridged): the same
    ``tokens_out``, acceptance and tokens per target pass; the same error
    answer for a prompt too long for k = 4."""
    jax_config = jax_llama.CONFIGS[CONFIG]
    jax_infer = jax_serving.make_speculative_infer(
        target_config=jax_config, draft_config=jax_config, k=4, seed=0,
        draft_seed=1)
    target = _params(seed=0)[1]
    draft = _params(seed=1)[1]
    infer = serving.make_speculative_infer(
        target_config=llama.CONFIGS[CONFIG], draft_config=CONFIG, k=4,
        target_params=target, draft_params=draft, device="cpu")
    for payload in ({"tokens": np.array([5, 17, 200, 3, 9], np.int32),
                     "max_new_tokens": 10},
                    {"tokens": np.ones(510, np.int32)}):
        want, got = jax_infer(payload), infer(payload)
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if key == "error":
                assert got[key] == value
            else:
                np.testing.assert_array_equal(got[key], np.asarray(value))
    self_draft = serving.make_speculative_infer(
        target_config=CONFIG, draft_config=CONFIG, target_params=target,
        draft_params=target, device="cpu")({"tokens": [1, 2, 3]})
    assert self_draft["acceptance_rate"] == 1.0


@pytest.fixture
def rigs(monkeypatch):
    """The rigs run on a real clock, where every fleet first waits out the
    registrar's primary search: nothing contests it here, so shorten it;
    and one intra-op thread (the tiny model's steps on a shared CPU)."""
    monkeypatch.setattr(port_registrar, "PRIMARY_SEARCH_TIMEOUT", 0.05)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_oracle(params, prompt, max_new):
    config = jax_llama.CONFIGS[CONFIG]
    out = jax_llama.complete(params, np.asarray(prompt, np.int32)[None],
                             config, max_new_tokens=max_new)
    return np.asarray(out)[0].tolist()


@pytest.mark.parametrize("chaos", [False, True])
def test_run_spec_ab_matches_jax_oracle(chaos, rigs):
    """``run_spec_ab`` on bridged f32 weights: plain and paired-draft
    finals bit-exact (the rig's own gate), every final the JAX oracle's,
    the paired draft accepting everything; under the chaos schedule
    nothing is lost or duplicated."""
    jax_params, params = _params(seed=0)
    base, spec = loadgen.run_spec_ab(spec_k=4, n_requests=12, chaos=chaos,
                                     config_name=CONFIG, params=params,
                                     device="cpu")
    assert spec.spec_stats["spec_acceptance_rate"] == 1.0
    assert spec.spec_stats["spec_tokens_per_target_pass"] > 1.0
    assert spec.spec_accept_hist and base.spec_stats is None
    if chaos:
        assert spec.lost == 0 and spec.timeouts == 0
        assert spec.duplicate_finals == 0
    payload_fn = loadgen.shared_prefix_payloads(
        n_conversations=3, turns=4, system_len=32 if chaos else 48, seed=0)
    checked = 0
    for request_id, tokens in spec.final_tokens.items():
        payload = payload_fn(int(request_id.rsplit("_", 1)[1]))
        if len(tokens) == int(payload["max_new_tokens"]):
            assert tokens == _jax_oracle(jax_params, payload["tokens"],
                                         len(tokens)), request_id
            checked += 1
    assert checked >= 8


def test_cli_spec_k_runs_on_the_cpu(rigs, capsys):
    """``loadgen --spec-k 4 --device cpu`` runs the A/B and says so."""
    assert loadgen.main(["--spec-k", "4", "--device", "cpu",
                         "--requests", "8"]) == 0
    assert "SPEC A/B OK" in capsys.readouterr().out
