"""Port parity of the chunk-attention kernel's split algorithm, on the CPU.

``ops/paged_prefill.py::chunk_attention_split_reference`` is the plain
f32 version of what ``csrc/paged_prefill.cu`` computes: the key axis cut
into :func:`chunk_split_keys` splits on absolute key positions, one
(max, sum, weighted values) partial a split, merged by log-sum-exp in
split order.  Here it is held against the one-shot plain version
(``chunk_attention_reference``) and the JAX package's ``_chunk_attention``
(its Pallas kernel in interpret mode) on numpy inputs from a seed, f32
pools within 2e-5 (summation order), int8 pools within 1e-4 (the scales
multiply in another order), on ragged chunks over pools of several
splits: windows of 3, 16 and 40 keys, GQA groups of 1, 4 and 8, chunks
that start or end on a split edge, and rows whose early or late splits
hold no visible key.  Only each row's real queries are compared: padding
queries are discarded by every caller.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.ops import paged_prefill as jax_pp
from aiko_services_tpu_torch.models.bridge import (tensor_from_numpy,
                                                   tensor_to_numpy)
from aiko_services_tpu_torch.ops import paged_prefill as pp

from .test_torch_paged import _case


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_cold():
    """Later test modules in the same worker count their own JAX
    compiles; drop what this module compiled once it is done."""
    yield
    jax.clear_caches()


#: name -> (_case kwargs, window).  Block size 16: splits of 256 keys, so
#: 40 blocks of table are three splits (0-255, 256-511, 512-639).
SPLIT_CASES = {
    # Rows at 0, 272 and 480 cached tokens: one, two and three live
    # splits; the first row's later splits hold no key at all.
    "ragged": (dict(cached_blocks=(0, 17, 30)), None),
    "window_3": (dict(cached_blocks=(0, 17, 30)), 3),
    "window_16": (dict(cached_blocks=(0, 17, 30)), 16),
    # Window 40 at 480 cached: splits 0 and 1 wholly outside it.
    "window_40": (dict(cached_blocks=(0, 17, 30)), 40),
    "gqa_1": (dict(kv=1, group=1, cached_blocks=(14, 31, 2)), None),
    "gqa_4": (dict(kv=1, group=4, cached_blocks=(14, 31, 2)), 40),
    "gqa_8": (dict(kv=1, group=8, cached_blocks=(14, 31, 2)), None),
    # A chunk that starts on a split edge (256) and one that ends on one
    # (240 + 16), and a chunk crossing the edge at 512.
    "split_edges": (dict(cached_blocks=(16, 15, 31), T=16,
                         chunk_lens=(16, 16, 9)), None),
    "split_edges_window": (dict(cached_blocks=(16, 15, 31), T=16,
                                chunk_lens=(16, 16, 9)), 16),
}


def _split_case(name, quant=False):
    kwargs, window = SPLIT_CASES[name]
    kwargs = dict(dict(max_blocks=40), **kwargs)
    return _case(len(name) + 3 * quant, quant=quant, **kwargs), window


def _port(case, window, split):
    q = tensor_from_numpy(case["q"])
    pool = {key: tensor_from_numpy(val) for key, val in case["pool"].items()}
    args = (q, pool, tensor_from_numpy(case["tables"]),
            tensor_from_numpy(case["cached_lens"]))
    if split:
        out = pp.chunk_attention_split_reference(
            *args, tensor_from_numpy(case["chunk_lens"]), window=window)
    else:
        out = pp.chunk_attention_reference(*args, window=window)
    return tensor_to_numpy(out)


def _jax_chunk(case, window):
    """The JAX package's ``_chunk_attention`` in interpret mode over the
    same (already appended) pool."""
    T, hd = case["q"].shape[1], case["q"].shape[-1]
    meta = jnp.stack([jnp.asarray(case["cached_lens"]),
                      jnp.asarray(case["chunk_lens"])], axis=1)
    pool = {key: jnp.asarray(val) for key, val in case["pool"].items()}
    out = jax_pp._chunk_attention(
        jnp.asarray(case["q"]), pool, jnp.asarray(case["tables"]), meta,
        window=window, sm_scale=hd ** -0.5, q_tile=jax_pp._q_tile_size(T),
        kv_blocks=case["tables"].shape[1], interpret=True)
    return np.asarray(out, np.float32)


def _assert_real_rows(got, want, case, tol, label):
    for b, chunk in enumerate(case["chunk_lens"].tolist()):
        np.testing.assert_allclose(got[b, :chunk], want[b, :chunk],
                                   atol=tol, rtol=tol,
                                   err_msg=f"{label} row {b}")


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_split_reference_matches_one_shot_and_pallas(name, quant):
    case, window = _split_case(name, quant)
    tol = 1e-4 if quant else 2e-5
    got = _port(case, window, split=True)
    _assert_real_rows(got, _port(case, window, split=False), case, tol,
                      "one-shot plain version")
    _assert_real_rows(got, _jax_chunk(case, window), case, tol,
                      "JAX _chunk_attention (interpret)")


def test_split_reference_empty_rows_and_idle_rows_are_finite():
    """A row of chunk_len 0 (an idle verify slot) at cached 0 sees no key:
    its output is zero, and no other row changes."""
    case, _ = _split_case("ragged")
    case["cached_lens"][0] = 0
    case["chunk_lens"][0] = 0
    got = _port(case, None, split=True)
    assert np.all(got[0] == 0)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("block_size", [1, 16, 48, 128, 256, 512])
def test_chunk_split_keys_are_whole_blocks(block_size):
    """A split is whole blocks, 256 keys where the block size divides
    256, one block from 256 rows up; a function of the block size
    alone."""
    keys = pp.chunk_split_keys(block_size)
    assert keys % block_size == 0
    assert keys == (pp.CHUNK_SPLIT_KEYS if 256 % block_size == 0
                    else max(block_size, 256 // block_size * block_size))
    assert keys <= max(block_size, pp.CHUNK_SPLIT_KEYS)


def test_split_reference_does_not_depend_on_the_chunk():
    """A query at position p over the same pool gives the same output
    (to f32 rounding) in a 32-token chunk and in a 16-token chunk that
    starts 16 tokens later: visibility is by absolute ids and the splits
    by absolute key positions."""
    case, _ = _split_case("ragged")
    whole = _port(case, None, split=True)
    late = dict(case, q=np.ascontiguousarray(case["q"][:, 16:]),
                cached_lens=case["cached_lens"] + 16,
                chunk_lens=np.maximum(case["chunk_lens"] - 16, 0)
                .astype(np.int32))
    part = _port(late, None, split=True)
    np.testing.assert_allclose(part[0], whole[0, 16:32], atol=2e-6,
                               rtol=2e-6)


def _kernel_live_splits(T, group, cached, window, split_keys):
    """Every query tile's live splits as the kernel counts them (64-row
    GQA-packed tiles, each chunk row real, a table long enough)."""
    counts = []
    for r0 in range(0, T * group, pp.CHUNK_TILE_ROWS):
        tok_first = r0 // group
        tok_last = min((r0 + pp.CHUNK_TILE_ROWS - 1) // group, T - 1)
        key_hi = cached + tok_last
        key_lo = max(cached + tok_first - window + 1, 0) if window else 0
        counts.append(key_hi // split_keys - key_lo // split_keys + 1)
    return counts


@pytest.mark.parametrize("window", [None, 3, 16, 40, 300, 4096])
@pytest.mark.parametrize("group", [1, 3, 4, 8])
def test_chunk_live_splits_bounds_every_tile(group, window):
    """The partial slots the wrapper gives a query tile hold every live
    split of every tile: chunks of 1 to 256 tokens at cached lengths on
    and off split edges, over a table of 32,768 keys."""
    split_keys = pp.chunk_split_keys(16)
    for T in (1, 5, 16, 17, 64, 256):
        for cached in (0, 37, 240, 255, 256, 1000, 32_768 - T):
            cap = pp.chunk_live_splits(T, group, 16, 2048, window)
            worst = max(_kernel_live_splits(T, group, cached, window,
                                            split_keys))
            assert worst <= cap, (T, cached)
            assert cap <= 2048 * 16 // split_keys
    if window is None:
        assert pp.chunk_live_splits(256, group, 16, 2048) == 128
