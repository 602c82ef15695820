"""Port parity: speculative decoding on both servers, against the JAX
package, on the CPU.

* ``ops/paged_prefill.py``: the plain ``append_kv_ragged`` against the JAX
  package's ``_append_kv_ragged(..., interpret=True)`` (its Pallas kernel
  in interpret mode) over the phase-2 grid of ``chip_smoke.py`` (8 rows,
  starts 0, 15, 16, 17, 1023 and 1030, T in {2, 5, 9, 17}, one row with
  ``chunk_len`` 0): bf16 pools equal; int8 scales within one ulp (the
  interpreted kernel's own division is one ulp off the JAX reference in
  places) and codes equal wherever the scales are, one step at most
  where they are not; and bit for bit the JAX reference writer
  (``_write_rows_reference`` + ``_kv_quantize_rows``) over the live rows.
  ``paged_verify_attention`` against the JAX one in interpret mode: f32
  outputs within 2e-5 (summation order), int8 within 1e-3, pools as
  above.
* ``models/llama.py``: ``verify_chunk_paged`` against the JAX one with
  ``AIKO_PREFILL_ATTENTION=interpret`` (logits within 1e-4, 1e-3 with int8
  KV), and the draft's helpers (``paged_insert_prefix``,
  ``decode_chunk_paged(return_logits=True)``).
* ``models/speculative.py``: greedy acceptance, commit, delta drafts and
  n-gram proposals equal to JAX on equal inputs; modified rejection
  sampling by its distribution (the two packages draw different random
  bits).
* ``orchestration/spec_control.py``: the controller equal to JAX on the
  same observation sequences.
* ``orchestration/paged.py``: the port's speculative server against the
  JAX one on bridged target and draft weights (paired, independent,
  n-gram and adaptive drafts; int8 KV, chunked admission, prefix cache):
  equal tokens, spec counters, per-request accepted rounds and block
  accounting; and invariant 11 port against port (speculative greedy
  equals plain greedy).
* ``orchestration/continuous.py``: the contiguous server the same way
  (its verify ``verify_chunk_ragged``, its draft on its own cache), its
  chunked admission and its legacy full-mirror upload against the JAX
  server, the JAX package's tests/test_spec_continuous.py scenarios, and
  invariant 11 port against port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.models import speculative as jax_spec
from aiko_services_tpu.ops import paged_prefill as jax_pp
from aiko_services_tpu.orchestration import continuous as jax_continuous
from aiko_services_tpu.orchestration import paged as jax_paged
from aiko_services_tpu.orchestration import spec_control as jax_control
from aiko_services_tpu_torch.models import llama, speculative
from aiko_services_tpu_torch.models.bridge import (params_from_numpy,
                                                   tensor_from_numpy,
                                                   tensor_to_numpy)
from aiko_services_tpu_torch.ops import paged_prefill as pp
from aiko_services_tpu_torch.orchestration import spec_control
from aiko_services_tpu_torch.orchestration.continuous import (
    ContinuousBatchingServer, DecodeRequest)
from aiko_services_tpu_torch.orchestration.paged import (
    PagedContinuousServer)

from .test_torch_server import reference_greedy

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


# --------------------------------------------------------------------------- #
# ops/paged_prefill.py: the ragged writer and the verify entry point

#: chip_smoke.py phase 2's grid: per-row starts, and chunk lengths as a
#: function of T (row 7 has chunk_len 0).
STARTS = (0, 15, 16, 17, 1023, 1030, 40, 5)


def _chunk_lens(T):
    return (T, T, max(T - 1, 1), T, T, 1, T, 0)


def _ragged_case(seed, T, quant, starts=STARTS, chunk_lens=None, kv=2,
                 hd=32, bs=16, dtype="bfloat16"):
    """A random pool with shuffled per-row block tables long enough for
    every row's window, and a (rows, T, kv, hd) window slab."""
    rng = np.random.default_rng(seed)
    rows = len(starts)
    chunk_lens = chunk_lens or _chunk_lens(T)
    max_blocks = (max(starts) + T) // bs + 2
    n_blocks = rows * max_blocks + 1
    ids = list(range(1, n_blocks))
    rng.shuffle(ids)
    tables = np.array(ids, np.int32).reshape(rows, max_blocks)
    if quant:
        pool = dict(
            k=rng.integers(-127, 128, (n_blocks, bs, kv, hd)).astype(np.int8),
            v=rng.integers(-127, 128, (n_blocks, bs, kv, hd)).astype(np.int8),
            ks=np.abs(rng.standard_normal((n_blocks, bs, kv))).astype(
                np.float32) / 127.0 + 1e-3,
            vs=np.abs(rng.standard_normal((n_blocks, bs, kv))).astype(
                np.float32) / 127.0 + 1e-3)
    else:
        pool = dict(
            k=rng.standard_normal((n_blocks, bs, kv, hd)).astype(np.float32),
            v=rng.standard_normal((n_blocks, bs, kv, hd)).astype(np.float32))
    k_new = rng.standard_normal((rows, T, kv, hd)).astype(np.float32)
    v_new = rng.standard_normal((rows, T, kv, hd)).astype(np.float32)
    k_new[0, 0, 0] = 0.0                     # an all-zero vector: scale 1
    return dict(pool=pool, tables=tables, k_new=k_new, v_new=v_new,
                cached=np.array(starts, np.int32),
                chunk=np.array(chunk_lens, np.int32), dtype=dtype)


def _jax_arrays(case):
    """The case on the JAX side: k/v (and float pools) in ``dtype``."""
    dtype = getattr(jnp, case["dtype"])
    pool = {key: (jnp.asarray(val) if val.dtype != np.float32
                  or key in ("ks", "vs") else jnp.asarray(val).astype(dtype))
            for key, val in case["pool"].items()}
    return (jnp.asarray(case["k_new"]).astype(dtype),
            jnp.asarray(case["v_new"]).astype(dtype), pool,
            jnp.asarray(case["tables"]))


def _port_arrays(case):
    dtype = getattr(torch, case["dtype"])
    pool = {key: (tensor_from_numpy(val) if val.dtype != np.float32
                  or key in ("ks", "vs")
                  else tensor_from_numpy(val).to(dtype))
            for key, val in case["pool"].items()}
    return (tensor_from_numpy(case["k_new"]).to(dtype),
            tensor_from_numpy(case["v_new"]).to(dtype), pool,
            tensor_from_numpy(case["tables"]))


def _as_f32(array):
    return np.asarray(array).astype(np.float32)


def _assert_pools_match_kernel(pool, jax_pool):
    """Float pools equal everywhere (block 0 included: the JAX kernel
    flushes it back unchanged, the port never touches it).  int8: scales
    within one ulp, and codes equal wherever the two scales are equal; in
    a vector whose interpreted scale is one ulp off, a value at a rounding
    edge may land one code away (the port's codes are the JAX reference
    writer's bit for bit, see the test below)."""
    for key, buf in pool.items():
        got = tensor_to_numpy(buf)
        want = _as_f32(jax_pool[key]) if buf.dtype == torch.bfloat16 \
            else np.asarray(jax_pool[key])
        if key in ("ks", "vs"):
            np.testing.assert_allclose(got, want, atol=0, rtol=2 ** -23,
                                       err_msg=key)
        elif buf.dtype == torch.int8:
            scale = "ks" if key == "k" else "vs"
            same = pool[scale].numpy() == np.asarray(jax_pool[scale])
            step = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert not step[same].any(), key
            assert step.max() <= 1, key
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("T", [2, 5, 9, 17])
def test_append_kv_ragged_matches_pallas_interpret(T, quant):
    case = _ragged_case(T, T, quant)
    k_new, v_new, pool, tables = _port_arrays(case)
    before = pp.append_kv_ragged.launches
    pp.append_kv_ragged(k_new, v_new, pool, tables,
                        torch.from_numpy(case["cached"]),
                        torch.from_numpy(case["chunk"]))
    assert pp.append_kv_ragged.launches == before      # the CPU path
    jk, jv, jpool, jtables = _jax_arrays(case)
    meta = jnp.stack([jnp.asarray(case["cached"]),
                      jnp.asarray(case["chunk"])], axis=1)
    _assert_pools_match_kernel(
        pool, jax_pp._append_kv_ragged(jk, jv, jpool, jtables, meta, True))

    # Bit for bit the JAX reference writer over the live rows only.
    want = jpool
    for row, (start, length) in enumerate(zip(case["cached"],
                                              case["chunk"])):
        if length:
            positions = jnp.asarray(start + np.arange(length, dtype=np.int32))
            want = jax_pp._write_rows_reference(
                want, jk[row:row + 1, :length], jv[row:row + 1, :length],
                jtables[row:row + 1], positions[None])
    for key, buf in pool.items():
        got = tensor_to_numpy(buf)
        ref = _as_f32(want[key]) if buf.dtype == torch.bfloat16 \
            else np.asarray(want[key])
        np.testing.assert_array_equal(got, ref, err_msg=key)
    # Pool rows outside the live windows are untouched.
    untouched = _port_arrays(case)[2]
    live = {(int(tables[row, (start + t) // 16]), (start + t) % 16)
            for row, (start, length) in enumerate(zip(case["cached"],
                                                      case["chunk"]))
            for t in range(length)}
    mask = torch.ones(pool["k"].shape[:2], dtype=torch.bool)
    for block, offset in live:
        mask[block, offset] = False
    for key in pool:
        assert torch.equal(pool[key][mask], untouched[key][mask]), key


VERIFY_CASES = {
    # (starts, chunk_lens, T, window, quant)
    "f32": ((0, 17, 30, 45), (5, 5, 3, 0), 5, None, False),
    "f32_window": ((3, 17, 30, 45), (5, 4, 5, 5), 5, 16, False),
    "f32_one_token": ((15, 16, 31, 0), (1, 1, 1, 0), 1, None, False),
    "int8": ((0, 17, 30, 45), (5, 5, 3, 0), 5, None, True),
    "int8_window": ((3, 17, 30, 45), (5, 4, 5, 5), 5, 16, True),
}


@pytest.mark.parametrize("name", sorted(VERIFY_CASES))
def test_paged_verify_attention_matches_pallas_interpret(name):
    starts, chunk_lens, T, window, quant = VERIFY_CASES[name]
    case = _ragged_case(len(name), T, quant, starts=starts,
                        chunk_lens=chunk_lens, dtype="float32")
    rng = np.random.default_rng(11)
    q = rng.standard_normal((len(starts), T, 2, 2, 32)).astype(np.float32)
    k_new, v_new, pool, tables = _port_arrays(case)
    out, pool = pp.paged_verify_attention(
        torch.from_numpy(q), k_new, v_new, pool, tables,
        torch.from_numpy(case["cached"]), torch.from_numpy(case["chunk"]),
        window=window)
    jk, jv, jpool, jtables = _jax_arrays(case)
    jout, jax_pool = jax_pp.paged_verify_attention(
        jnp.asarray(q), jk, jv, jpool, jtables, jnp.asarray(case["cached"]),
        jnp.asarray(case["chunk"]), window=window, interpret=True)
    tol = 1e-3 if quant else 2e-5
    out, jout = out.numpy(), np.asarray(jout)
    for row, length in enumerate(chunk_lens):
        np.testing.assert_allclose(out[row, :length], jout[row, :length],
                                   atol=tol, rtol=tol, err_msg=f"row {row}")
    assert np.isfinite(out).all()
    _assert_pools_match_kernel(pool, jax_pool)


def test_verify_outside_the_envelope_takes_the_reference():
    """head_dim > 128 on CPU tensors: the JAX dispatch's reference (which
    writes every window row at its position)."""
    case = _ragged_case(3, 4, False, starts=(0, 20), chunk_lens=(4, 2),
                        hd=160, kv=1, dtype="float32")
    q = np.random.default_rng(4).standard_normal((2, 4, 1, 2, 160)) \
        .astype(np.float32)
    k_new, v_new, pool, tables = _port_arrays(case)
    out, pool = pp.paged_verify_attention(
        torch.from_numpy(q), k_new, v_new, pool, tables,
        torch.from_numpy(case["cached"]), torch.from_numpy(case["chunk"]))
    jk, jv, jpool, jtables = _jax_arrays(case)
    jout, jax_pool = jax_pp.paged_prefill_reference(
        jnp.asarray(q), jk, jv, jpool, jtables, jnp.asarray(case["cached"]),
        jnp.asarray(case["chunk"]))
    np.testing.assert_allclose(out.numpy()[0], np.asarray(jout)[0],
                               atol=2e-5, rtol=2e-5)
    for key in pool:
        np.testing.assert_array_equal(pool[key].numpy(),
                                      np.asarray(jax_pool[key]))


# --------------------------------------------------------------------------- #
# models/llama.py: the verify and the draft's helpers


def _tiny(quantize_kv, seed=1, n_blocks=13):
    jax_config = jax_llama.CONFIGS[CONFIG]
    config = llama.CONFIGS[CONFIG]
    jax_params = jax_llama.init_params(jax_config, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")
    jax_pool = jax_llama.init_paged_cache(jax_config, n_blocks, 16,
                                          quantize_kv=quantize_kv)
    pool = llama.init_paged_cache(config, n_blocks, 16,
                                  quantize_kv=quantize_kv, device="cpu")
    return jax_config, jax_params, jax_pool, config, params, pool


def _assert_pools(pool, jax_pool, int8_step=0):
    """Pools equal past scratch block 0: f32 within 2e-5; int8 codes
    within one step (a value at a rounding edge may land on either side
    after f32 matmuls in another order) and scales within 1e-5."""
    for layer, jax_layer in zip(pool, jax_pool):
        for key, buf in layer.items():
            got = buf.numpy()[1:].astype(np.float32)
            want = np.asarray(jax_layer[key])[1:].astype(np.float32)
            atol = int8_step if buf.dtype == torch.int8 else 2e-5
            np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5,
                                       err_msg=key)


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_verify_chunk_paged_matches_jax_interpret(quantize_kv, monkeypatch):
    """Two prefilled rows verify a 4-token window at their own unaligned
    positions (19 and 39), a third row inactive; the JAX side runs its
    Pallas kernels in interpret mode."""
    jax_config, jax_params, jax_pool, config, params, pool = \
        _tiny(quantize_kv)
    rng = np.random.default_rng(8)
    tables = np.zeros((3, 8), np.int32)
    tables[0, :3] = [4, 2, 9]
    tables[1, :4] = [1, 7, 3, 11]
    for row, length in ((0, 32), (1, 48)):
        prompt = rng.integers(1, 1024, (1, length)).astype(np.int32)
        jax_pool = jax_llama.prefill_append_paged(
            jax_params, jnp.asarray(prompt), jax_pool,
            jnp.asarray(tables[row:row + 1]), jnp.int32(0), jax_config,
            compute_logits=False)[1]
        pool = llama.prefill_append_paged(
            params, torch.from_numpy(prompt), pool,
            torch.from_numpy(tables[row:row + 1]), 0, config,
            compute_logits=False)[1]
    monkeypatch.setenv("AIKO_PREFILL_ATTENTION", "interpret")
    jax.clear_caches()           # the mode is read when a program traces
    window = rng.integers(1, 1024, (3, 4)).astype(np.int32)
    positions = np.array([19, 39, 0], np.int32)
    active = np.array([True, True, False])
    jax_logits, jax_pool = jax_llama.verify_chunk_paged(
        jax_params, jnp.asarray(window), jax_pool, jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(active), jax_config)
    logits, pool = llama.verify_chunk_paged(
        params, torch.from_numpy(window), pool, torch.from_numpy(tables),
        torch.from_numpy(positions), torch.from_numpy(active), config)
    jax.clear_caches()
    tol = 1e-3 if quantize_kv else 1e-4
    np.testing.assert_allclose(logits.numpy()[:2],
                               np.asarray(jax_logits)[:2], atol=tol,
                               rtol=tol)
    _assert_pools(pool, jax_pool, int8_step=1)


def test_draft_helpers_match_jax():
    """``paged_insert_prefix`` of a contiguous prefill lands the JAX
    package's pool, and ``decode_chunk_paged(return_logits=True)`` returns
    its tokens and per-step logits (within 1e-4)."""
    jax_config, jax_params, jax_pool, config, params, pool = _tiny(False, 5)
    prompt = np.random.default_rng(6).integers(1, 1024, (1, 32)) \
        .astype(np.int32)
    tables = np.array([[0, 0, 0, 0], [5, 2, 8, 0]], np.int32)
    jax_cache = jax_llama.init_cache(jax_config, 1, 32)
    _, jax_cache = jax_llama.prefill(jax_params, jnp.asarray(prompt),
                                     jax_cache, jax_config)
    jax_pool = jax_llama.paged_insert_prefix(jax_pool, jnp.asarray(tables),
                                             jax_cache, jnp.int32(1))
    cache = llama.init_cache(config, 1, 32, device="cpu")
    _, cache = llama.prefill(params, torch.from_numpy(prompt), cache, config)
    pool = llama.paged_insert_prefix(pool, torch.from_numpy(tables), cache, 1)
    _assert_pools(pool, jax_pool)
    token = np.array([[0], [prompt[0, -1]]], np.int32)
    positions = np.array([0, 31], np.int32)
    active = np.array([False, True])
    jax_out = jax_llama.decode_chunk_paged(
        jax_params, jnp.asarray(token), jax_pool, jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(active), 3, jax_config,
        return_logits=True)
    out = llama.decode_chunk_paged(
        params, torch.from_numpy(token), pool, torch.from_numpy(tables),
        torch.from_numpy(positions), torch.from_numpy(active), 3, config,
        return_logits=True)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jax_out[0]))
    np.testing.assert_allclose(out[1].numpy()[1], np.asarray(jax_out[1])[1],
                               atol=1e-4, rtol=1e-4)
    assert out[1].shape == (2, 3, config.vocab_size)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(jax_out[3]))


# --------------------------------------------------------------------------- #
# models/speculative.py


def _accept_inputs(seed, slots=6, k=4, vocab=50):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((slots, k + 1, vocab)).astype(np.float32)
    proposals = rng.integers(0, vocab, (slots, k)).astype(np.int32)
    # Varied accepted prefixes: row r copies the target's argmax for its
    # first r proposals.
    argmax = logits.argmax(-1)
    for row in range(slots):
        proposals[row, :min(row, k)] = argmax[row, :min(row, k)]
    caps = rng.integers(0, k + 1, slots).astype(np.int32)
    return logits, proposals, caps


@pytest.mark.parametrize("use_caps", [False, True])
def test_greedy_accept_and_commit_match_jax(use_caps):
    logits, proposals, caps = _accept_inputs(3)
    caps_j = jnp.asarray(caps) if use_caps else None
    caps_t = torch.from_numpy(caps) if use_caps else None
    jwin, jcounts = jax_spec.greedy_accept_batch(
        jnp.asarray(logits), jnp.asarray(proposals), caps=caps_j)
    win, counts = speculative.greedy_accept_batch(
        torch.from_numpy(logits), torch.from_numpy(proposals), caps=caps_t)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    slots = logits.shape[0]
    state = dict(token=np.arange(slots, dtype=np.int32)[:, None],
                 positions=np.arange(10, 10 + slots, dtype=np.int32),
                 active=np.array([True, True, False, True, True, True]),
                 remaining=np.array([9, 2, 5, 1, 9, 9], np.int32),
                 temps=np.zeros(slots, np.float32),
                 tops=np.ones(slots, np.float32))
    # An EOS inside row 5's window (its third token).
    eos = int(np.asarray(jwin)[5, 2])
    for eos_id in (-1, eos):
        jout = jax_spec.spec_commit(
            {key: jnp.asarray(val) for key, val in state.items()}, jwin,
            jcounts, eos_id=eos_id)
        out = speculative.spec_commit(
            {key: torch.from_numpy(val) for key, val in state.items()}, win,
            counts, eos_id=eos_id)
        # JAX's (emit_tokens, emit_counts, drafted, accepted, resync,
        # state): the port leaves the two counts to the host.
        for got, want in zip(out[:3], (jout[0], jout[1], jout[4])):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for key in state:
            np.testing.assert_array_equal(out[3][key].numpy(),
                                          np.asarray(jout[5][key]),
                                          err_msg=key)


def test_delta_draft_and_ngram_match_jax():
    proposals = np.array([[3, 0, 9], [7, 7, 1]], np.int32)
    np.testing.assert_array_equal(
        speculative.delta_draft_logits(torch.from_numpy(proposals),
                                       12).numpy(),
        np.asarray(jax_spec.delta_draft_logits(jnp.asarray(proposals), 12)))
    rng = np.random.default_rng(2)
    phrase = rng.integers(1, 50, 6)
    histories = [np.concatenate([phrase, rng.integers(1, 50, 5), phrase[:3]]),
                 np.tile(phrase, 4), rng.integers(1, 50, 30),
                 np.array([4]), np.array([4, 4]), np.array([], np.int64)]
    for history in histories:
        for k, max_ngram in ((3, 3), (5, 2), (1, 4)):
            got = speculative.ngram_propose(list(history), k, max_ngram)
            want = jax_spec.ngram_propose(list(history), k, max_ngram)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


def _tv(samples, probs):
    counts = np.bincount(samples, minlength=probs.shape[0])
    return 0.5 * np.abs(counts / counts.sum() - probs).sum()


@pytest.mark.parametrize("draft", ["delta", "model"])
def test_mrs_first_token_is_target_distributed(draft):
    """20,000 rows of one window: the first committed token of the sampled
    rows follows the target's tempered, nucleus-truncated softmax within
    a total variation of 0.03 (the sampling spread at this count is about
    0.01), whatever the draft proposes and whatever the caps; the greedy
    rows equal greedy acceptance."""
    n, k, vocab, temperature, top_p = 20_000, 3, 10, 0.8, 0.95
    rng = np.random.default_rng(5)
    row_logits = rng.standard_normal((k + 1, vocab)).astype(np.float32) * 2
    target = np.broadcast_to(row_logits, (n, k + 1, vocab)).copy()
    temps = np.full(n, temperature, np.float32)
    tops = np.full(n, top_p, np.float32)
    temps[:50] = 0.0                              # greedy rows
    caps = rng.integers(0, k + 1, n).astype(np.int32)
    if draft == "delta":
        proposals = rng.integers(0, vocab, (n, k)).astype(np.int32)
        draft_logits = speculative.delta_draft_logits(
            torch.from_numpy(proposals), vocab)
    else:
        q_logits = rng.standard_normal((k, vocab)).astype(np.float32)
        q = np.asarray(jax_llama.sampling_probs(
            jnp.asarray(q_logits), temperature, top_p))
        proposals = np.stack([rng.choice(vocab, n, p=q[j] / q[j].sum())
                              for j in range(k)], axis=1).astype(np.int32)
        draft_logits = torch.from_numpy(
            np.broadcast_to(q_logits, (n, k, vocab)).copy())
    generator = torch.Generator().manual_seed(0)
    window, counts = speculative.mrs_accept_batch(
        torch.from_numpy(target), draft_logits, torch.from_numpy(proposals),
        torch.from_numpy(temps), torch.from_numpy(tops), generator,
        caps=torch.from_numpy(caps))
    p = np.asarray(jax_llama.sampling_probs(jnp.asarray(row_logits[:1]),
                                            temperature, top_p))[0]
    assert _tv(window.numpy()[50:, 0], p) < 0.03
    greedy, greedy_counts = speculative.greedy_accept_batch(
        torch.from_numpy(target[:50]), torch.from_numpy(proposals[:50]),
        caps=torch.from_numpy(caps[:50]))
    assert torch.equal(window[:50], greedy)
    assert torch.equal(counts[:50], greedy_counts)
    assert bool(((counts >= 1) & (counts <= torch.from_numpy(caps) + 1))
                .all())


# --------------------------------------------------------------------------- #
# orchestration/spec_control.py


def test_ladders_match_jax():
    for k in (0, 1, 2, 3, 4, 6, 8, 13):
        assert spec_control.default_ladder(k) == jax_control.default_ladder(k)
    for ladder, floor in (((0, 2, 4), 16), ((1,), 2), ((0, 2, 4, 8), 8),
                          ((), 16), ((2, 2), 16), ((-1, 2), 16)):
        try:
            want = jax_control.validate_ladder(ladder, floor)
        except ValueError as error:
            with pytest.raises(ValueError) as got:
                spec_control.validate_ladder(ladder, floor)
            assert str(got.value) == str(error)
        else:
            assert spec_control.validate_ladder(ladder, floor) == want


def test_spec_controller_matches_jax():
    rng = np.random.default_rng(0)
    ladder = spec_control.default_ladder(8)
    ours = spec_control.SpecController(4, ladder)
    theirs = jax_control.SpecController(4, ladder)
    for _ in range(400):
        live = rng.random(4) < 0.8
        assert ours.round_k(live) == theirs.round_k(live)
        np.testing.assert_array_equal(ours.caps(live), theirs.caps(live))
        ours.note_dispatch(live)
        theirs.note_dispatch(live)
        action = rng.random()
        if action < 0.05:
            slot = int(rng.integers(4))
            ours.reset(slot)
            theirs.reset(slot)
        elif action < 0.15:
            ours.tick_cold_round(live)
            theirs.tick_cold_round(live)
        else:
            for slot in np.nonzero(live)[0]:
                k = ours.k_for(slot)
                # Acceptance drifting per slot: slot 0 always cold, slot 3
                # always hot, the others random.
                accepted = (0 if slot == 0 else k if slot == 3
                            else int(rng.integers(0, k + 1)))
                ours.observe(slot, k, accepted)
                theirs.observe(slot, k, accepted)
        np.testing.assert_array_equal(ours.rung, theirs.rung)
        np.testing.assert_array_equal(ours.ema, theirs.ema)
    assert ours.hist_string() == theirs.hist_string()
    assert len(ours.k_hist) == len(ladder)


# --------------------------------------------------------------------------- #
# orchestration: the speculative paged server


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _spec_pair(draft, **kwargs):
    """A JAX speculative paged server and the port's (CPU) on the JAX
    server's target and draft weights.  ``ring_max=2`` pins both in-flight
    rings at two rounds, so the round count is a function of the traffic
    alone (the ring policy otherwise reads wall-clock waits)."""
    kwargs = dict(dict(slots=2, max_seq=128, chunk_steps=4, block_size=16,
                       total_blocks=16, seed=3, ring_max=2), **kwargs)
    if draft in ("paired", "independent"):
        kwargs["draft_config_name"] = CONFIG
    jax_server = jax_paged.PagedContinuousServer(config_name=CONFIG, **kwargs)
    params = _bridge(jax_server.params)
    draft_params = None
    if draft == "paired":
        jax_server._draft["params"] = jax_server.params
        draft_params = params
    elif draft == "independent":
        draft_params = _bridge(jax_server._draft["params"])
    kwargs.pop("seed")
    port_server = PagedContinuousServer(config_name=CONFIG, params=params,
                                        draft_params=draft_params,
                                        device="cpu", **kwargs)
    return jax_server, port_server


def _accounting(server):
    return dict(free=server.free_blocks, evictable=list(server._evictable),
                producing=dict(server._producing), hits=server.prefix_hits,
                misses=server.prefix_misses,
                reused=server.prefix_blocks_reused,
                index=dict(server._index), tables=server.tables.tolist())


SPEC_KEYS = ("spec_k", "spec_rounds", "spec_proposed", "spec_accepted",
             "spec_rollback_blocks", "spec_draft_mode", "spec_k_effective",
             "spec_ngram_hits")


def _waves(kind):
    """Two waves; the second shares prompt prefixes with the first (prefix
    hits) and a 40-token prompt takes three 16-token slices."""
    rng = np.random.default_rng(21)
    if kind == "ngram":
        phrase = rng.integers(1, 1024, 7).astype(np.int32)
        first = [np.concatenate([np.tile(phrase, reps),
                                 rng.integers(1, 1024, tail)
                                 .astype(np.int32)])
                 for reps, tail in ((5, 2), (2, 5), (3, 0))]
    else:
        first = [rng.integers(1, 1024, n).astype(np.int32)
                 for n in (5, 40, 3)]
    second = [np.concatenate([first[1][:33],
                              rng.integers(1, 1024, 4).astype(np.int32)]),
              first[0].copy()]
    return [list(zip(first, (12, 9, 14))), list(zip(second, (8, 6)))]


def _drive(server, module, waves, edit=None):
    """Serve ``waves`` in order; ``edit(server)`` after each wave's first
    step, while its requests are live."""
    requests = []
    for wave in waves:
        for prompt, new in wave:
            request = module(f"r{len(requests)}", prompt, new)
            requests.append(request)
            server.submit(request)
        if edit is not None:
            server.step()
            edit(server)
        server.run_until_drained()
    return requests


SPEC_SCENARIOS = {
    "paired": ("paired", dict(spec_k=3)),
    "independent": ("independent", dict(spec_k=3)),
    "ngram": ("ngram", dict(draft_mode="ngram", spec_k=4)),
    "adaptive": ("independent", dict(spec_k=4, spec_adaptive=True)),
}


@pytest.mark.parametrize("name", sorted(SPEC_SCENARIOS))
def test_spec_server_matches_jax_server(name):
    draft, kwargs = SPEC_SCENARIOS[name]
    jax_server, port_server = _spec_pair(
        draft, quantize_kv=True, enable_prefix_cache=True,
        chunk_prefill_tokens=16, **kwargs)
    if kwargs.get("spec_adaptive"):
        jax_server.warm_spec_ladder()
        assert port_server.warm_spec_ladder() == 2       # rungs 2 and 4
    kind = "ngram" if draft == "ngram" else "model"
    want = _drive(jax_server, jax_continuous.DecodeRequest, _waves(kind))
    got = _drive(port_server, DecodeRequest, _waves(kind))
    for have, ref in zip(got, want):
        assert have.error is None and ref.error is None, have.request_id
        assert have.tokens == ref.tokens, have.request_id
        assert have.spec_accepted_rounds == [
            int(a) for a in ref.spec_accepted_rounds], have.request_id
    ours, theirs = port_server.stats(), jax_server.stats()
    assert {key: ours[key] for key in SPEC_KEYS} \
        == {key: theirs[key] for key in SPEC_KEYS}
    assert ours["spec_rounds"] > 0 and ours["prefix_hits"] > 0
    assert _accounting(port_server) == _accounting(jax_server)
    balance = port_server.pool_balance()
    assert balance["free"] + balance["evictable"] + balance["producing"] \
        == balance["total"]
    if name == "paired":
        assert ours["spec_tokens_per_target_pass"] > 1.0
    if name == "adaptive":
        assert ours["spec_k_effective"].startswith("0:")   # walked to k=0
    if name == "ngram":
        assert ours["spec_ngram_hits"] > 0


@pytest.mark.parametrize("draft", ["paired", "independent", "ngram"])
def test_spec_greedy_equals_plain_greedy(draft):
    """Invariant 11, port against port: int8 KV, chunked admission and the
    prefix cache, speculated or not, give the same tokens; the f32 KV
    paired run also equals the batch-1 contiguous oracle."""
    kwargs = dict(config_name=CONFIG, slots=2, max_seq=128, chunk_steps=4,
                  block_size=16, seed=3, device="cpu")
    kind = "ngram" if draft == "ngram" else "model"
    plain = PagedContinuousServer(chunk_prefill_tokens=0, quantize_kv=True,
                                  enable_prefix_cache=True, **kwargs)
    want = _drive(plain, DecodeRequest, _waves(kind))
    spec_kwargs = dict(draft_mode="ngram") if draft == "ngram" else dict(
        draft_config_name=CONFIG,
        draft_params=plain.params if draft == "paired" else None)
    spec = PagedContinuousServer(chunk_prefill_tokens=16, quantize_kv=True,
                                 enable_prefix_cache=True, spec_k=3,
                                 params=plain.params, **spec_kwargs,
                                 **kwargs)
    got = _drive(spec, DecodeRequest, _waves(kind))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert spec.stats()["spec_rounds"] > 0
    assert all(0 <= a <= 3 for r in got for a in r.spec_accepted_rounds)
    if draft == "paired":
        oracle = PagedContinuousServer(draft_config_name=CONFIG, spec_k=3,
                                       params=plain.params,
                                       draft_params=plain.params, **kwargs)
        for request in _drive(oracle, DecodeRequest, _waves(kind)):
            assert request.tokens == reference_greedy(
                oracle, request.prompt, request.max_new_tokens)
        assert oracle.stats()["spec_tokens_per_target_pass"] > 1.0


def test_spec_sampled_requests_finish_in_vocab():
    """A sampled request (temperature 0.8, top_p 0.95) beside a greedy one
    through the model draft and through n-gram self-drafting (the delta
    draft): both finish with their budgets, tokens in the vocabulary; the
    greedy one equals the plain server's."""
    kwargs = dict(config_name=CONFIG, slots=2, max_seq=128, chunk_steps=4,
                  block_size=16, seed=3, device="cpu", spec_k=3)
    rng = np.random.default_rng(4)
    prompts = [np.tile(rng.integers(1, 1024, 5).astype(np.int32), 4),
               rng.integers(1, 1024, 9).astype(np.int32)]
    plain = PagedContinuousServer(config_name=CONFIG, slots=2, max_seq=128,
                                  chunk_steps=4, block_size=16, seed=3,
                                  device="cpu")
    greedy = DecodeRequest("g", prompts[1], 10)
    plain.submit(greedy)
    plain.run_until_drained()
    for spec_kwargs in (dict(draft_config_name=CONFIG),
                        dict(draft_mode="ngram")):
        server = PagedContinuousServer(params=plain.params, **spec_kwargs,
                                       **kwargs)
        requests = [DecodeRequest("s", prompts[0], 12, temperature=0.8,
                                  top_p=0.95),
                    DecodeRequest("g", prompts[1], 10)]
        for request in requests:
            server.submit(request)
        server.run_until_drained()
        assert [len(r.tokens) for r in requests] == [12, 10]
        assert all(0 <= t < 1024 for r in requests for t in r.tokens)
        assert requests[1].tokens == greedy.tokens
        assert server.stats()["spec_rounds"] > 0
        assert server.pool_balance()["free"] == server.total_blocks


def test_speculation_options_route_and_raise():
    """The contiguous server speculates too (n-gram here); grammars alone
    turn speculation on (n-gram) on the paged one; bad modes and ladders
    raise as in the JAX package."""
    from aiko_services_tpu_torch.models.constrained import (
        automaton_from_rules)
    contiguous = ContinuousBatchingServer(config_name=CONFIG, slots=1,
                                          max_seq=32, device="cpu",
                                          draft_mode="ngram")
    assert contiguous.stats()["spec_draft_mode"] == "ngram"
    grammar = PagedContinuousServer(
        config_name=CONFIG, slots=1, max_seq=32, device="cpu",
        automata={"g": automaton_from_rules(1024, {0: [((1,), 1)]}, [1])})
    assert grammar.stats()["spec_draft_mode"] == "ngram"
    for kwargs, message in ((dict(draft_mode="bogus"), "draft_mode"),
                            (dict(draft_mode="model"), "draft_config_name"),
                            (dict(draft_mode="ngram", spec_k=16), "ladder")):
        with pytest.raises(ValueError, match=message):
            PagedContinuousServer(config_name=CONFIG, slots=1, max_seq=32,
                                  device="cpu", **kwargs)
    server = PagedContinuousServer(config_name=CONFIG, slots=1, max_seq=64,
                                   device="cpu", draft_mode="ngram",
                                   spec_k=4)
    assert server.stats()["spec_draft_mode"] == "ngram"
    server.submit(DecodeRequest("long", np.ones(40, np.int32), 20))
    assert server.run_until_drained()[0].error == "prompt_too_long"


# --------------------------------------------------------------------------- #
# orchestration/continuous.py: speculation, chunked admission and the
# legacy upload on the contiguous layout

def _contiguous_pair(draft=None, **kwargs):
    """A JAX contiguous server and the port's (CPU) on the JAX server's
    target and draft weights.  ``ring_max=2`` pins both rings at two
    rounds, so the round count follows the traffic alone."""
    kwargs = dict(dict(slots=2, max_seq=96, chunk_steps=4, seed=3,
                       ring_max=2), **kwargs)
    if draft in ("paired", "independent"):
        kwargs["draft_config_name"] = CONFIG
    jax_server = jax_continuous.ContinuousBatchingServer(config_name=CONFIG,
                                                         **kwargs)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_server.params),
                               "cpu")
    draft_params = None
    if draft == "paired":
        jax_server._draft["params"] = jax_server.params
        draft_params = params
    elif draft == "independent":
        draft_params = params_from_numpy(
            jax.tree.map(np.asarray, jax_server._draft["params"]), "cpu")
    kwargs.pop("seed")
    port_server = ContinuousBatchingServer(
        config_name=CONFIG, params=params, draft_params=draft_params,
        device="cpu", **kwargs)
    return jax_server, port_server


@pytest.mark.parametrize("name", sorted(SPEC_SCENARIOS))
def test_contiguous_spec_server_matches_jax_server(name):
    """The contiguous speculative server against the JAX one (int8 KV,
    16-token chunked admission): tokens, accepted rounds and the spec
    counters equal."""
    draft, kwargs = SPEC_SCENARIOS[name]
    jax_server, port_server = _contiguous_pair(
        draft, quantize_kv=True, chunk_prefill_tokens=16, **kwargs)
    if kwargs.get("spec_adaptive"):
        jax_server.warm_spec_ladder()
        assert port_server.warm_spec_ladder() == 2       # rungs 2 and 4
    kind = "ngram" if draft == "ngram" else "model"
    want = _drive(jax_server, jax_continuous.DecodeRequest, _waves(kind))
    got = _drive(port_server, DecodeRequest, _waves(kind))
    for have, ref in zip(got, want):
        assert have.error is None and ref.error is None, have.request_id
        assert have.tokens == ref.tokens, have.request_id
        assert have.spec_accepted_rounds == [
            int(a) for a in ref.spec_accepted_rounds], have.request_id
    ours, theirs = port_server.stats(), jax_server.stats()
    assert {key: ours[key] for key in SPEC_KEYS} \
        == {key: theirs[key] for key in SPEC_KEYS}
    assert ours["spec_rounds"] > 0
    assert ours["prefill_tokens"] == theirs["prefill_tokens"]
    if name == "paired":
        assert ours["spec_tokens_per_target_pass"] > 1.0
    if name == "ngram":
        assert ours["spec_ngram_hits"] > 0


@pytest.mark.parametrize("mode", ["chunked", "legacy_upload"])
def test_contiguous_admission_and_upload_match_jax(mode):
    """Chunked admission (16-token chunks into a batch-1 bucket) and the
    legacy full-mirror upload (with a live sampling edit, which settles
    the ring first) against the JAX server: equal tokens, prefill tokens
    and dispatches."""
    kwargs = (dict(chunk_prefill_tokens=16) if mode == "chunked"
              else dict(compact_upload=False))
    jax_server, port_server = _contiguous_pair(**kwargs)

    def edit(server):
        server.update_sampling("r1", temperature=0.0, top_p=0.5)

    want = _drive(jax_server, jax_continuous.DecodeRequest, _waves("model"),
                  edit=edit)
    got = _drive(port_server, DecodeRequest, _waves("model"), edit=edit)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    for key in ("prefill_tokens", "tokens_committed"):
        assert port_server.stats()[key] == jax_server.stats()[key], key
    for request in got:
        assert request.tokens == reference_greedy(
            port_server, request.prompt, request.max_new_tokens)


@pytest.mark.parametrize("option", ["spec", "chunked", "compact"])
def test_contiguous_options_keep_greedy_tokens(option):
    """Invariant 11 port against port: speculation (paired, int8 KV),
    chunked admission and the legacy upload each leave every greedy token
    the plain server's."""
    base = dict(config_name=CONFIG, slots=2, max_seq=96, chunk_steps=4,
                seed=3, device="cpu")
    plain = ContinuousBatchingServer(quantize_kv=option == "spec", **base)
    want = _drive(plain, DecodeRequest, _waves("model"))
    extra = {"spec": dict(quantize_kv=True, draft_config_name=CONFIG,
                          draft_params=plain.params, spec_k=3,
                          chunk_prefill_tokens=16),
             "chunked": dict(chunk_prefill_tokens=32),
             "compact": dict(compact_upload=False)}[option]
    other = ContinuousBatchingServer(params=plain.params, **extra, **base)
    got = _drive(other, DecodeRequest, _waves("model"))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    if option == "spec":
        assert other.stats()["spec_tokens_per_target_pass"] > 1.0


def test_contiguous_spec_eos_and_headroom():
    """tests/test_spec_continuous.py: EOS inside a round truncates
    exactly; a request without k + 1 rows of headroom is rejected."""
    server = ContinuousBatchingServer(config_name=CONFIG, slots=1,
                                      max_seq=64, chunk_steps=4, seed=7,
                                      draft_config_name=CONFIG, spec_k=3,
                                      device="cpu")
    prompt = np.arange(1, 9, dtype=np.int32)
    want = reference_greedy(server, prompt, 12)
    server.eos_id = want[2]
    request = DecodeRequest("e", prompt, 12)
    server.submit(request)
    server.run_until_drained()
    assert request.tokens == want[:3]
    too_long = DecodeRequest("h", np.ones(40, np.int32), 64 - 40 - 1)
    server.submit(too_long)
    server.run_until_drained()
    assert too_long.error == "prompt_too_long"


def test_contiguous_spec_sampled_mixed_batch():
    """tests/test_spec_continuous.py: a sampled request beside a greedy
    one (draft model, then n-gram): the greedy one equals the oracle, the
    sampled one finishes in the vocabulary, the same seed repeats it."""
    for spec in (dict(draft_config_name=CONFIG), dict(draft_mode="ngram")):
        outs = []
        for _ in range(2):
            server = ContinuousBatchingServer(
                config_name=CONFIG, slots=2, max_seq=96, chunk_steps=4,
                seed=13, spec_k=3, device="cpu", **spec)
            rng = np.random.default_rng(21)
            greedy = DecodeRequest(
                "g", rng.integers(1, 500, 9).astype(np.int32), 8)
            sampled = DecodeRequest(
                "s", rng.integers(1, 500, 7).astype(np.int32), 8,
                temperature=1.0, top_p=0.9)
            server.submit(greedy)
            server.submit(sampled)
            server.run_until_drained()
            assert greedy.tokens == reference_greedy(server, greedy.prompt,
                                                     8)
            assert len(sampled.tokens) == 8
            assert all(0 <= t < 1024 for t in sampled.tokens)
            outs.append(list(sampled.tokens))
        assert outs[0] == outs[1]
