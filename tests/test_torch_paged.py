"""Port parity: the paged serving path of ``aiko_services_tpu_torch``
against the JAX package's, on the CPU.

* ``ops/paged_prefill.py``: the plain ``append_kv``, ``chunk_attention``
  and ``paged_prefill_reference`` against the JAX package's
  ``paged_prefill_attention(..., interpret=True)`` (its Pallas kernels in
  interpret mode) and ``paged_prefill_reference``, on the ``_case``
  shapes of tests/test_paged_prefill.py.  f32 outputs within 2e-5 (the
  JAX test's own bound: summation order); int8 pools bitwise equal.
* ``kvstore/directory.py``: chain keys byte for byte.
* ``models/llama.py``: the paged functions on an f32 ``tiny`` with the
  JAX package's weights (logits within 1e-4, tokens equal).
* ``orchestration/paged.py``: the port's ``PagedContinuousServer``
  against the JAX one on the same bridged weights, on the scenarios of
  tests/test_paged.py and tests/test_paged_prefill.py: greedy tokens
  equal, and equal block accounting (free blocks, prefix hits, reused
  blocks, the prefix index and the pool balance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.kvstore import directory as jax_directory
from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.ops import paged_prefill as jax_pp
from aiko_services_tpu.orchestration import continuous as jax_continuous
from aiko_services_tpu.orchestration import paged as jax_paged
from aiko_services_tpu_torch.kvstore import directory
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.models.bridge import (params_from_numpy,
                                                   tensor_from_numpy,
                                                   tensor_to_numpy)
from aiko_services_tpu_torch.ops import paged_prefill as pp
from aiko_services_tpu_torch.orchestration.continuous import DecodeRequest
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
# ops/paged_prefill.py: the plain kernels against the Pallas kernels


def _case(seed, batch=3, kv=2, group=4, hd=32, bs=16, max_blocks=4,
          cached_blocks=(0, 1, 2), T=32, chunk_lens=(32, 17, 5),
          quant=False):
    """tests/test_paged_prefill.py's ``_case``: a random pool, shuffled
    block tables and a ragged append chunk (``chunk_lens[b]`` real tokens
    after ``cached_blocks[b]`` resident blocks)."""
    rng = np.random.default_rng(seed)
    n_blocks = batch * max_blocks + 1
    q = rng.standard_normal((batch, T, kv, group, hd)).astype(np.float32)
    k_new = rng.standard_normal((batch, T, kv, hd)).astype(np.float32)
    v_new = rng.standard_normal((batch, T, kv, hd)).astype(np.float32)
    ids = list(range(1, n_blocks))
    rng.shuffle(ids)
    tables = np.array(ids[:batch * max_blocks],
                      np.int32).reshape(batch, max_blocks)
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
    cached_lens = np.array([c * bs for c in cached_blocks], np.int32)
    return dict(q=q, k_new=k_new, v_new=v_new, pool=pool, tables=tables,
                cached_lens=cached_lens,
                chunk_lens=np.array(chunk_lens, np.int32), bs=bs)


def _jax_run(case, path, window=None):
    pool = {key: jnp.asarray(val) for key, val in case["pool"].items()}
    args = (jnp.asarray(case["q"]), jnp.asarray(case["k_new"]),
            jnp.asarray(case["v_new"]), pool, jnp.asarray(case["tables"]),
            jnp.asarray(case["cached_lens"]), jnp.asarray(case["chunk_lens"]))
    if path == "reference":
        out, new_pool = jax_pp.paged_prefill_reference(*args, window=window)
    else:
        out, new_pool = jax_pp.paged_prefill_attention(*args, window=window,
                                                       interpret=True)
    return np.asarray(out, np.float32), {
        key: np.asarray(val) for key, val in new_pool.items()}


def _port_args(case):
    pool = {key: tensor_from_numpy(val) for key, val in case["pool"].items()}
    return (tensor_from_numpy(case["q"]), tensor_from_numpy(case["k_new"]),
            tensor_from_numpy(case["v_new"]), pool,
            tensor_from_numpy(case["tables"]),
            tensor_from_numpy(case["cached_lens"]),
            tensor_from_numpy(case["chunk_lens"]))


def _port_run(case, path, window=None):
    q, k_new, v_new, pool, tables, cached, chunk = _port_args(case)
    if path == "reference":
        out, pool = pp.paged_prefill_reference(q, k_new, v_new, pool, tables,
                                               cached, chunk, window=window)
    else:
        out, pool = pp.paged_prefill_attention(q, k_new, v_new, pool, tables,
                                               cached, chunk, window=window)
    return tensor_to_numpy(out), {key: val.numpy()
                                  for key, val in pool.items()}


def _assert_parity(case, window=None, tol=2e-5):
    jax_out, jax_pool = _jax_run(case, "kernel", window)
    ref_out, ref_pool = _jax_run(case, "reference", window)
    bs = case["bs"]
    for path in ("kernel", "reference"):
        out, pool = _port_run(case, path, window)
        for b in range(out.shape[0]):
            chunk = int(case["chunk_lens"][b])
            cached = int(case["cached_lens"][b])
            # Only the row's real queries: pad rows are discarded.
            for want in (jax_out, ref_out):
                np.testing.assert_allclose(out[b, :chunk], want[b, :chunk],
                                           atol=tol, rtol=tol,
                                           err_msg=f"{path} row {b}")
            for position in range(cached, cached + chunk):
                block = int(case["tables"][b, position // bs])
                offset = position % bs
                for key in pool:
                    np.testing.assert_array_equal(
                        pool[key][block, offset],
                        ref_pool[key][block, offset],
                        err_msg=f"{path} row {b} pos {position} {key}")
        if path != "reference":
            # The append writes whole live blocks, as the Pallas kernel
            # does; the kernel also flushes dead blocks into scratch block
            # 0, which the port leaves alone: equal everywhere else.  The
            # Pallas kernel's own int8 scales differ from the JAX
            # reference's by one ulp in places (XLA's division inside the
            # interpreted kernel), so scales are held to 2^-23 relative
            # there; every int8 code and every float row is exact.
            for key in pool:
                if key in ("ks", "vs"):
                    np.testing.assert_allclose(pool[key][1:],
                                               jax_pool[key][1:], atol=0,
                                               rtol=2 ** -23,
                                               err_msg=f"{path} {key}")
                else:
                    np.testing.assert_array_equal(
                        pool[key][1:], jax_pool[key][1:],
                        err_msg=f"{path} pool {key}")


PARITY_CASES = {
    "ragged": (dict(), None),
    "mid_block": (dict(cached_blocks=(1, 2, 0), chunk_lens=(17, 16, 31)),
                  None),
    "one_block": (dict(batch=2, cached_blocks=(0, 1), T=16,
                       chunk_lens=(1, 15)), None),
    "gqa_1_1": (dict(kv=1, group=1), None),
    "gqa_4_1": (dict(kv=1, group=4), None),
    "gqa_8_2": (dict(kv=2, group=4), None),
    "window_3": (dict(), 3),
    "window_16": (dict(), 16),
    "window_40": (dict(), 40),
    "zero_cached": (dict(cached_blocks=(0, 0, 0), chunk_lens=(32, 20, 7)),
                    None),
}


@pytest.mark.parametrize("name", sorted(PARITY_CASES))
def test_append_attention_matches_pallas_interpret(name):
    kwargs, window = PARITY_CASES[name]
    _assert_parity(_case(len(name), **kwargs), window=window)


@pytest.mark.parametrize("kwargs,window", [
    (dict(), None),
    (dict(cached_blocks=(2, 1, 0), chunk_lens=(9, 32, 23)), 19)])
def test_append_int8_pools_bitwise(kwargs, window):
    """int8 pools: every quantized row and scale bitwise equal to the JAX
    package's, outputs within 1e-3 (the JAX test's int8 bound)."""
    _assert_parity(_case(7, quant=True, **kwargs), window=window, tol=1e-3)


def test_kv_quantizer_is_the_cache_writers():
    assert llama._kv_quantize is pp._kv_quantize_rows
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((5, 3, 32)).astype(np.float32)
    rows[1, 2] = 0.0
    q, scale = pp._kv_quantize_rows(torch.from_numpy(rows))
    jq, jscale = jax_pp._kv_quantize_rows(jnp.asarray(rows))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def test_dispatch_outside_the_kernel_envelope_takes_the_reference():
    """T not block-aligned: the reference path (which writes every row at
    its position), as the JAX package dispatches."""
    case = _case(5, T=24, chunk_lens=(24, 17, 5))
    q, k_new, v_new, pool, tables, cached, chunk = _port_args(case)
    out, pool = pp.paged_prefill_attention(q, k_new, v_new, pool, tables,
                                           cached, chunk)
    ref_out, ref_pool = _jax_run(case, "reference")
    np.testing.assert_allclose(tensor_to_numpy(out)[0], ref_out[0],
                               atol=2e-5, rtol=2e-5)
    for key in pool:
        np.testing.assert_array_equal(pool[key].numpy(), ref_pool[key])


def test_every_new_wrapper_counts_its_launches():
    wrappers = (pp.append_kv, pp.chunk_attention, pp.append_kv_ragged)
    for wrapper in wrappers:
        assert isinstance(wrapper.launches, int)
    before = [wrapper.launches for wrapper in wrappers]
    _port_run(_case(1), "kernel")
    q, k_new, v_new, pool, tables, cached, chunk = _port_args(_case(2))
    pp.paged_verify_attention(q[:, :5], k_new[:, :5], v_new[:, :5], pool,
                              tables, cached + 3, chunk.clamp(max=5))
    assert [wrapper.launches for wrapper in wrappers] == before


# --------------------------------------------------------------------------- #
# kvstore/directory.py


@pytest.mark.parametrize("length,block_size,adapter", [
    (0, 16, 0), (15, 16, 0), (16, 16, 0), (65, 16, 0), (1041, 16, 0),
    (100, 32, 3), (33, 16, 7)])
def test_chain_keys_byte_identical(length, block_size, adapter):
    prompt = np.random.default_rng(length).integers(
        1, 128_000, length).astype(np.int32)
    assert directory.chain_keys(prompt, block_size, adapter) == \
        jax_directory.chain_keys(prompt, block_size, adapter)
    assert directory.chain_keys_hex(prompt, block_size, adapter) == \
        jax_directory.chain_keys_hex(prompt, block_size, adapter)
    assert directory.shareable_blocks(length, block_size) == \
        jax_directory.shareable_blocks(length, block_size)
    assert directory.HEX_KEY_CHARS == jax_directory.HEX_KEY_CHARS


# --------------------------------------------------------------------------- #
# models/llama.py: the paged functions


def _tiny(quantize_kv, seed=1):
    jax_config = jax_llama.CONFIGS[CONFIG]
    config = llama.CONFIGS[CONFIG]
    jax_params = jax_llama.init_params(jax_config, jax.random.PRNGKey(seed))
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")
    jax_pool = jax_llama.init_paged_cache(jax_config, 9, 16,
                                          quantize_kv=quantize_kv)
    pool = llama.init_paged_cache(config, 9, 16, quantize_kv=quantize_kv,
                                  device="cpu")
    return jax_config, jax_params, jax_pool, config, params, pool


def _assert_pools(pool, jax_pool, int8_step=0):
    """Pools equal past scratch block 0: f32 within 2e-5; int8 codes
    within one step (a score at a rounding edge may land on either side
    after f32 matmuls in another order) and scales within 1e-5."""
    for layer, jax_layer in zip(pool, jax_pool):
        for key, buf in layer.items():
            got = buf.numpy()[1:].astype(np.float32)
            want = np.asarray(jax_layer[key])[1:].astype(np.float32)
            atol = int8_step if buf.dtype == torch.int8 else 2e-5
            np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5,
                                       err_msg=key)


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_prefill_append_then_serve_chunk_paged(quantize_kv):
    """Two append slices (0..32, 32..48) then five device-resident paged
    decode steps of a 2-slot state (slot 1 inactive): logits within 1e-4
    (1e-3 with int8 KV, where an f32 rounding difference can move a K/V
    code by one step), tokens equal, pools equal past scratch block 0."""
    jax_config, jax_params, jax_pool, config, params, pool = \
        _tiny(quantize_kv)
    prompt = np.random.default_rng(2).integers(1, 1024, (1, 48)) \
        .astype(np.int32)
    tables = np.zeros((2, 8), np.int32)
    tables[0, :4] = [3, 1, 4, 2]
    for start, width, logits_on in ((0, 32, False), (32, 16, True)):
        chunk = prompt[:, start:start + width]
        jax_logits, jax_pool = jax_llama.prefill_append_paged(
            jax_params, jnp.asarray(chunk), jax_pool,
            jnp.asarray(tables[:1]), jnp.int32(start), jax_config,
            kv_limit=4, compute_logits=logits_on)
        logits, pool = llama.prefill_append_paged(
            params, torch.from_numpy(chunk), pool,
            torch.from_numpy(tables[:1]), start, config, kv_limit=4,
            compute_logits=logits_on)
    tol = 1e-3 if quantize_kv else 1e-4
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax_logits),
                               atol=tol, rtol=tol)
    _assert_pools(pool, jax_pool, int8_step=1)
    state = dict(token=np.array([[prompt[0, -1]], [0]], np.int32),
                 positions=np.array([47, 0], np.int32),
                 active=np.array([True, False]),
                 remaining=np.array([5, 0], np.int32),
                 temps=np.zeros(2, np.float32), tops=np.ones(2, np.float32),
                 tables=tables)
    jax_out = jax_llama.serve_chunk_paged(
        jax_params, {key: jnp.asarray(val) for key, val in state.items()},
        jax_pool, 6, jax_config)
    out = llama.serve_chunk_paged(
        params, {key: torch.from_numpy(val) for key, val in state.items()},
        pool, 6, config)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jax_out[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jax_out[1]))
    assert out[1].tolist() == [5, 0]
    _assert_pools(out[3], jax_out[3], int8_step=1)


def test_decode_chunk_paged_and_mixed_step_match_jax():
    """``decode_chunk_paged`` (the JAX package's paged oracle) and one
    ``serve_chunk_mixed`` call (a slice for slot 1 while slot 0 decodes):
    tokens equal, pools within 2e-5."""
    jax_config, jax_params, jax_pool, config, params, pool = _tiny(False, 4)
    prompt = np.random.default_rng(5).integers(1, 1024, (2, 32)) \
        .astype(np.int32)
    tables = np.array([[1, 2, 0, 0], [3, 4, 5, 0]], np.int32)
    jax_pool = jax_llama.prefill_append_paged(
        jax_params, jnp.asarray(prompt[:1]), jax_pool,
        jnp.asarray(tables[:1]), jnp.int32(0), jax_config,
        compute_logits=False)[1]
    pool = llama.prefill_append_paged(params, torch.from_numpy(prompt[:1]),
                                      pool, torch.from_numpy(tables[:1]), 0,
                                      config, compute_logits=False)[1]
    token = np.array([[prompt[0, -1]], [0]], np.int32)
    positions = np.array([31, 0], np.int32)
    active = np.array([True, False])
    jax_tokens, _, jax_positions, jax_pool = jax_llama.decode_chunk_paged(
        jax_params, jnp.asarray(token), jax_pool, jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(active), 3, jax_config)
    tokens, _, new_positions, pool = llama.decode_chunk_paged(
        params, torch.from_numpy(token), pool, torch.from_numpy(tables),
        torch.from_numpy(positions), torch.from_numpy(active), 3, config)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jax_tokens))
    np.testing.assert_array_equal(new_positions.numpy(),
                                  np.asarray(jax_positions))
    state = dict(token=np.array([[tokens[0, -1]], [0]], np.int32),
                 positions=np.array([34, 0], np.int32), active=active,
                 remaining=np.array([4, 0], np.int32),
                 temps=np.zeros(2, np.float32), tops=np.ones(2, np.float32),
                 tables=tables)
    jax_out = jax_llama.serve_chunk_mixed(
        jax_params, {key: jnp.asarray(val) for key, val in state.items()},
        jax_pool, jnp.asarray(prompt[1:, :16]), jnp.int32(1), jnp.int32(0),
        4, jax_config, prefill_kv_limit=3)
    out = llama.serve_chunk_mixed(
        params, {key: torch.from_numpy(val) for key, val in state.items()},
        pool, torch.from_numpy(prompt[1:, :16]), 1, 0, 4, config,
        prefill_kv_limit=3)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jax_out[0]))
    _assert_pools(out[3], jax_out[3])


def test_paged_write_slab_matches_jax():
    jax_config, _, jax_pool, config, _, pool = _tiny(True)
    rng = np.random.default_rng(6)
    k = rng.standard_normal((1, 20, 2, 32)).astype(np.float32)
    v = rng.standard_normal((1, 20, 2, 32)).astype(np.float32)
    tables = np.array([[2, 5, 1, 0]], np.int32)
    positions = (8 + np.arange(20, dtype=np.int32))[None, :]
    want = jax_llama._paged_write_slab(jax_pool[0], jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(tables),
                                       jnp.asarray(positions))
    got = llama._paged_write_slab(pool[0], torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  torch.from_numpy(tables),
                                  torch.from_numpy(positions))
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


# --------------------------------------------------------------------------- #
# orchestration/paged.py: the port's server against the JAX server


def _pair(**kwargs):
    """A JAX paged server and a port paged server (CPU) on the JAX
    server's weights."""
    jax_server = jax_paged.PagedContinuousServer(config_name=CONFIG, **kwargs)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_server.params),
                               "cpu")
    kwargs.pop("seed", None)
    port_server = PagedContinuousServer(config_name=CONFIG, params=params,
                                        device="cpu", **kwargs)
    return jax_server, port_server


def _accounting(server):
    return dict(free=server.free_blocks, evictable=list(server._evictable),
                producing=dict(server._producing), hits=server.prefix_hits,
                misses=server.prefix_misses,
                reused=server.prefix_blocks_reused,
                index=dict(server._index), tables=server.tables.tolist())


def _prompts(spec, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 1024, plen).astype(np.int32), new)
            for plen, new in spec]


def _shared(seed, tails, system_len=32):
    rng = np.random.default_rng(seed)
    system = rng.integers(1, 1024, system_len).astype(np.int32)
    return [np.concatenate([system, rng.integers(1, 1024, tail)
                            .astype(np.int32)]) for tail in tails]


def _drive(server, module, waves):
    """Submit each wave, then step until the server is idle; returns the
    requests in submission order."""
    requests = []
    for wave in waves:
        for prompt, new in wave:
            request = module(f"r{len(requests)}", prompt, new)
            requests.append(request)
            server.submit(request)
        server.run_until_drained()
    return requests


SCENARIOS = {
    # tests/test_paged.py
    "per_request_greedy": (
        dict(slots=2, max_seq=96, chunk_steps=4, seed=3, block_size=16),
        lambda: [_prompts([(5, 6), (11, 3), (3, 9), (17, 5), (24, 7)], 0)]),
    "defers_until_blocks_free": (
        dict(slots=2, max_seq=64, chunk_steps=4, block_size=16,
             total_blocks=2),
        lambda: [_prompts([(10, 6), (9, 5)], 0)]),
    "int8_kv": (
        dict(slots=2, max_seq=64, chunk_steps=3, seed=2, quantize_kv=True),
        lambda: [_prompts([(6, 5), (12, 4)], 4)]),
    "leaf_first_eviction": (
        dict(slots=1, max_seq=128, chunk_steps=4, block_size=16,
             total_blocks=9, enable_prefix_cache=True),
        lambda: [[(p, n)] for p, n in zip(
            [_prompts([(65, 0)], 18)[0][0], _prompts([(30, 0)], 19)[0][0],
             _prompts([(65, 0)], 18)[0][0]], (4, 66, 4))]),
    "concurrent_same_wave_sharing": (
        dict(slots=2, max_seq=96, chunk_steps=2, block_size=16,
             total_blocks=12, enable_prefix_cache=True),
        lambda: [list(zip(_shared(16, (6, 6)), (3, 9)))]),
    "prefix_cache_int8": (
        dict(slots=1, max_seq=96, chunk_steps=3, block_size=16,
             quantize_kv=True, enable_prefix_cache=True),
        lambda: [[(p, 4) for p in _shared(15, (5, 5))]]),
    # tests/test_paged_prefill.py
    "chunked": (
        dict(slots=2, max_seq=96, chunk_steps=3, seed=6, block_size=16,
             chunk_prefill_tokens=16),
        lambda: [_prompts([(5, 6), (33, 5), (17, 4), (40, 7)], 19)]),
    "chunked_prefix_cache_int8": (
        dict(slots=2, max_seq=96, chunk_steps=3, block_size=16,
             quantize_kv=True, enable_prefix_cache=True,
             chunk_prefill_tokens=16),
        lambda: [[(p, 5) for p in _shared(23, (9, 9, 9))]]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_paged_server_matches_jax_server(name):
    kwargs, waves = SCENARIOS[name]
    jax_server, port_server = _pair(**kwargs)
    want = _drive(jax_server, jax_continuous.DecodeRequest, waves())
    got = _drive(port_server, DecodeRequest, waves())
    for have, ref in zip(got, want):
        assert have.error == ref.error, have.request_id
        assert have.tokens == ref.tokens, have.request_id
    assert _accounting(port_server) == _accounting(jax_server)
    balance = port_server.pool_balance()
    assert balance["free"] + balance["evictable"] + balance["producing"] \
        == balance["total"]
    if not kwargs.get("quantize_kv"):
        # bf16-free f32 KV: the port's contiguous batch-1 oracle agrees.
        for request in got:
            assert request.tokens == reference_greedy(
                port_server, request.prompt, request.max_new_tokens)


def test_deferred_admission_waits_for_blocks():
    """A pool sized for ONE request: after the first step both servers
    hold the second request in the queue with no block free."""
    kwargs, waves = SCENARIOS["defers_until_blocks_free"]
    for server, module in zip(_pair(**kwargs),
                              (jax_continuous.DecodeRequest, DecodeRequest)):
        for i, (prompt, new) in enumerate(waves()[0]):
            server.submit(module(f"r{i}", prompt, new))
        server.step()
        assert server.free_blocks == 0 and len(server._queue) == 1
        assert server.counters["admission_deferred"] >= 1


def test_same_wave_sharing_pins_the_producers_blocks():
    """Two live slots read the same shared prefix blocks at once: both
    servers own the same blocks with refcount 2 after the first step."""
    kwargs, waves = SCENARIOS["concurrent_same_wave_sharing"]
    servers = _pair(**kwargs)
    for server, module in zip(servers, (jax_continuous.DecodeRequest,
                                        DecodeRequest)):
        for i, (prompt, new) in enumerate(waves()[0]):
            server.submit(module(f"r{i}", prompt, new))
        server.step()
    jax_server, port_server = servers
    shared = port_server._owned[1][:2]
    assert port_server._owned == jax_server._owned
    assert port_server._owned[0][:2] == shared
    assert all(port_server._refs[block] == 2 for block in shared)


def test_chunked_equals_whole_bucket_admission():
    spec = [(5, 6), (33, 5), (17, 4), (40, 7)]
    outs = {}
    for chunk in (0, 16):
        server = PagedContinuousServer(
            config_name=CONFIG, slots=2, max_seq=96, chunk_steps=3, seed=6,
            block_size=16, total_blocks=16, chunk_prefill_tokens=chunk,
            device="cpu")
        requests = _drive(server, DecodeRequest, [_prompts(spec, 19)])
        outs[chunk] = [r.tokens for r in requests]
        if chunk:
            assert server.counters["prefill_slices_mixed"] > 0
    assert outs[0] == outs[16]


def test_cancel_mid_prefill_releases_blocks():
    """Cancelling while the chunked prefill is in flight returns every
    block (the registered keys purged) on both servers alike, and the pool
    serves the next request."""
    prompt = np.random.default_rng(29).integers(1, 1024, 40) \
        .astype(np.int32)
    kwargs = dict(slots=1, max_seq=96, chunk_steps=4, block_size=16,
                  enable_prefix_cache=True, chunk_prefill_tokens=16)
    results = []
    for server, module in zip(_pair(**kwargs),
                              (jax_continuous.DecodeRequest, DecodeRequest)):
        server.submit(module("a", prompt, 5))
        server.step()
        assert server._prefilling
        assert server.cancel("a")
        assert not server._prefilling and not server._producing
        assert server.free_blocks + len(server._evictable) == \
            server.total_blocks
        server.submit(module("b", prompt, 4))
        finished = server.run_until_drained()
        assert [r.request_id for r in finished if r.error is None] == ["b"]
        results.append((finished[-1].tokens, _accounting(server)))
    assert results[0] == results[1]


def test_bucket_and_chunk_alignment_checks():
    with pytest.raises(ValueError, match="multiple of block_size"):
        PagedContinuousServer(config_name=CONFIG, slots=1, max_seq=64,
                              block_size=32, chunk_prefill_tokens=16,
                              device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        PagedContinuousServer(config_name=CONFIG, slots=1, max_seq=72,
                              block_size=16, device="cpu")
    server = PagedContinuousServer(config_name=CONFIG, slots=1, max_seq=64,
                                   device="cpu")
    assert server.chunk_prefill_tokens == \
        PagedContinuousServer.DEFAULT_CHUNK_PREFILL_TOKENS == 256
    big = DecodeRequest("big", np.ones(33, np.int32), 10)
    small = PagedContinuousServer(config_name=CONFIG, slots=1, max_seq=64,
                                  total_blocks=2, device="cpu")
    small.submit(big)
    assert small.run_until_drained()[0].error == "request_exceeds_pool"


def test_warm_prefill_ladder_matches_jax():
    kwargs = dict(slots=1, max_seq=64, block_size=16,
                  chunk_prefill_tokens=32)
    jax_server, port_server = _pair(**kwargs)
    assert port_server.warm_prefill_ladder() == \
        jax_server.warm_prefill_ladder() == 5
    assert port_server.free_blocks == port_server.total_blocks


@pytest.mark.parametrize("option", [
    dict(adapters={"a": {}}),
    dict(replica_mesh=object()), dict(automata={"g": object()}),
    dict(compilation_cache_dir="cache")])
def test_paged_features_outside_the_slice_raise(option):
    with pytest.raises(NotImplementedError):
        PagedContinuousServer(config_name=CONFIG, slots=1, max_seq=32,
                              device="cpu", **option)

