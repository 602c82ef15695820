"""Port parity: the decode step's K/V write, ``ops/paged_prefill.py``
``write_kv_rows``, against the JAX package's, on the CPU.

* ``write_kv_rows``'s plain path (the one a CPU tensor takes) against JAX
  ``models/llama.py`` ``_paged_write_rows`` on a block pool and
  ``_cache_write_rows`` on a contiguous cache: bf16 and f32 pools and int8
  codes and scales, bitwise, inputs from a numpy seed; the slots of the
  paged case include inactive lanes redirected to scratch block 0 at
  their slot offset, as the decode step writes them.
* A row given as a strided slice (the rotary pass's ``k``) writes what its
  contiguous copy writes.
* An f32 ``tiny`` served through the port's paged and contiguous servers
  keeps the JAX servers' greedy tokens, with the decode write called once
  a layer a decode step and no kernel launch counted on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.orchestration import continuous as jax_continuous
from aiko_services_tpu.orchestration import paged as jax_paged
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.models.bridge import params_from_numpy
from aiko_services_tpu_torch.ops import paged_prefill as pp
from aiko_services_tpu_torch.orchestration.continuous import (
    ContinuousBatchingServer, DecodeRequest)
from aiko_services_tpu_torch.orchestration.paged import (
    PagedContinuousServer)

CONFIG = "tiny_f32"
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f32": (torch.float32, jnp.float32)}


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


def _config(dtype):
    """tiny (kv 2, head_dim 32) in the pool dtype under test."""
    return (dataclasses.replace(jax_llama.CONFIGS["tiny"],
                                dtype=DTYPES[dtype][1]),
            dataclasses.replace(llama.CONFIGS["tiny"],
                                dtype=DTYPES[dtype][0]))


def _rows(rng, batch, dtype):
    """One (batch, 1, kv 2, hd 32) K and V row a slot, a zero vector among
    them (scale 1 on int8 pools), in the dtype under test."""
    k = rng.standard_normal((batch, 1, 2, 32)).astype(np.float32)
    v = rng.standard_normal((batch, 1, 2, 32)).astype(np.float32)
    k[1, 0, 1] = 0.0
    torch_dtype, jax_dtype = DTYPES[dtype]
    return ((torch.from_numpy(k).to(torch_dtype),
             torch.from_numpy(v).to(torch_dtype)),
            (jnp.asarray(k).astype(jax_dtype),
             jnp.asarray(v).astype(jax_dtype)))


def _assert_bitwise(got, want):
    assert set(got) == set(want)
    for key, buf in got.items():
        have = buf.float().numpy() if buf.dtype == torch.bfloat16 \
            else buf.numpy()
        ref = np.asarray(want[key])
        ref = ref.astype(np.float32) if ref.dtype == jnp.bfloat16 else ref
        np.testing.assert_array_equal(have, ref, err_msg=key)


@pytest.mark.parametrize("quantize_kv", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_write_kv_rows_matches_jax_paged_write_rows(dtype, quantize_kv):
    """Six slots over a 9-block pool of 16-row blocks: four live slots at
    positions inside, at the start and at the end of their blocks, and two
    inactive lanes written as the decode step redirects them (block 0 at
    offset slot % 16)."""
    jax_config, config = _config(dtype)
    rng = np.random.default_rng(5)
    jax_pool = jax_llama.init_paged_cache(jax_config, 9, 16,
                                          quantize_kv=quantize_kv)[0]
    pool = llama.init_paged_cache(config, 9, 16, quantize_kv=quantize_kv,
                                  device="cpu")[0]
    (k, v), (jk, jv) = _rows(rng, 6, dtype)
    tables = np.array([[3, 7, 0], [0, 0, 0], [5, 2, 8], [1, 4, 0],
                       [0, 0, 0], [6, 0, 0]], np.int32)
    positions = np.array([20, 1, 16, 15, 4, 0], np.int32)
    want = jax_llama._paged_write_rows(jax_pool, jk, jv, jnp.asarray(tables),
                                       jnp.asarray(positions))
    before = pp.write_kv_rows.launches
    got = pp.write_kv_rows(k, v, pool, torch.from_numpy(tables),
                           torch.from_numpy(positions))
    assert got is pool and pp.write_kv_rows.launches == before
    _assert_bitwise(pool, want)


@pytest.mark.parametrize("quantize_kv", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cache_write_rows_matches_jax(dtype, quantize_kv):
    """Three rows of a 40-row contiguous cache at positions 0, 17 and the
    scratch row 39 (an inactive slot): llama's ``_cache_write_rows``, now
    ``write_kv_rows`` over the cache as a pool of one block a row."""
    jax_config, config = _config(dtype)
    rng = np.random.default_rng(6)
    jax_cache = jax_llama.init_cache(jax_config, 3, 40,
                                     quantize_kv=quantize_kv)[0]
    cache = llama.init_cache(config, 3, 40, quantize_kv=quantize_kv,
                             device="cpu")[0]
    (k, v), (jk, jv) = _rows(rng, 3, dtype)
    positions = np.array([0, 17, 39], np.int32)
    want = jax_llama._cache_write_rows(jax_cache, jk, jv,
                                       jnp.asarray(positions))
    got = llama._cache_write_rows(
        cache, k, v, llama._cache_rows(torch.from_numpy(positions)))
    assert got is cache
    _assert_bitwise(cache, want)


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_strided_rows_write_what_their_copy_writes(quantize_kv):
    """``k`` as the rotary pass hands it over, a slice of the fused q/k
    tensor (batch, 1, heads + kv, hd): the same pool bytes as its
    contiguous copy."""
    _, config = _config("bf16")
    rng = np.random.default_rng(7)
    fused = torch.from_numpy(rng.standard_normal((4, 1, 6, 32)).astype(
        np.float32)).to(torch.bfloat16)
    k = fused[:, :, 4:]
    v = torch.from_numpy(rng.standard_normal((4, 1, 2, 32)).astype(
        np.float32)).to(torch.bfloat16)
    assert not k.is_contiguous()
    tables = torch.tensor([[1, 2], [3, 4], [5, 6], [7, 8]], dtype=torch.int32)
    positions = torch.tensor([3, 17, 30, 9], dtype=torch.int32)
    pools = [llama.init_paged_cache(config, 9, 16, quantize_kv=quantize_kv,
                                    device="cpu")[0] for _ in range(2)]
    pp.write_kv_rows(k, v, pools[0], tables, positions)
    pp.write_kv_rows(k.contiguous(), v, pools[1], tables, positions)
    for key in pools[0]:
        assert torch.equal(pools[0][key], pools[1][key]), key


def _count_writes(monkeypatch):
    """Count llama's calls of ``write_decode_rows`` (the decode write,
    ``write_kv_rows`` at a step's ``DecodeRows``)."""
    calls = []
    inner = llama.write_decode_rows

    def counted(*args):
        calls.append(args[0].shape[0])
        return inner(*args)
    monkeypatch.setattr(llama, "write_decode_rows", counted)
    return calls


def _serve(server, module, specs, seed):
    rng = np.random.default_rng(seed)
    requests = [module(f"r{i}", rng.integers(1, 1024, plen).astype(np.int32),
                       new) for i, (plen, new) in enumerate(specs)]
    for request in requests:
        server.submit(request)
    server.run_until_drained()
    return requests


SERVERS = {
    "contiguous": (jax_continuous.ContinuousBatchingServer,
                   ContinuousBatchingServer, dict(max_seq=96)),
    "paged": (jax_paged.PagedContinuousServer, PagedContinuousServer,
              dict(max_seq=96, block_size=16, enable_prefix_cache=True,
                   chunk_prefill_tokens=16)),
}


@pytest.mark.parametrize("quantize_kv", [False, True])
@pytest.mark.parametrize("layout", sorted(SERVERS))
def test_servers_keep_the_jax_greedy_tokens(monkeypatch, layout,
                                            quantize_kv):
    """Five requests through two slots of an f32 tiny on the JAX server's
    weights: the port's tokens equal the JAX server's, the decode write
    runs once a layer a decode step over every slot, and the CPU path
    counts no kernel launch."""
    jax_cls, port_cls, kwargs = SERVERS[layout]
    kwargs = dict(kwargs, slots=2, chunk_steps=3, quantize_kv=quantize_kv)
    jax_server = jax_cls(config_name=CONFIG, seed=4, **kwargs)
    params = params_from_numpy(jax.tree.map(np.asarray, jax_server.params),
                               "cpu")
    port_server = port_cls(config_name=CONFIG, params=params, device="cpu",
                           **kwargs)
    specs = [(5, 6), (20, 4), (3, 7), (33, 5), (12, 3)]
    want = _serve(jax_server, jax_continuous.DecodeRequest, specs, 8)
    calls = _count_writes(monkeypatch)
    before = pp.write_kv_rows.launches
    got = _serve(port_server, DecodeRequest, specs, 8)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    steps = port_server.stats()["decode_steps"]
    assert steps > 0
    assert calls == [2] * port_server.config.n_layers * steps
    assert pp.write_kv_rows.launches == before
