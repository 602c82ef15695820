"""Ragged paged decode attention: the hand-written CUDA kernel and the
plain oracle it is held against.

Port of ``aiko_services_tpu/ops/paged_attention.py``.  Decode attention
is the serving hot path: one query token per row against that row's
whole KV history.  :func:`cached_gqa_attention` masks over the full cache
(the CPU path and the oracle); :func:`paged_decode_attention` launches
``csrc/paged_decode.cu`` on CUDA tensors, which reads only the blocks a
row occupies.  The contiguous ``(batch, S, kv, hd)`` cache is the
degenerate pool: a free reshape to ``(batch*S/bs, bs, kv, hd)`` with iota
block tables (see ``models/llama._decode_attention_contiguous``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .attention import NEG_INF

__all__ = ["paged_decode_attention", "paged_decode_reference",
           "paged_decode_split_reference", "cached_gqa_attention",
           "contiguous_block_size", "decode_split_keys"]

#: Maximum pool block size the degenerate contiguous view uses.
CONTIGUOUS_BLOCK_CAP = 128

#: Most keys one CTA of the decode kernel covers (``kSplitKeys`` of
#: csrc/paged_decode.cu).
DECODE_SPLIT_KEYS = 256

#: Quantized-fallback dequantization span cap (see :func:`_dequant_block`).
DEQUANT_BLOCK_CAP = 512


def contiguous_block_size(max_seq: int) -> int:
    """Block size for viewing a contiguous ``(batch, max_seq, kv, hd)``
    cache as a degenerate block pool, or 0 when no usable size exists
    (the caller then takes :func:`cached_gqa_attention`).  Largest power
    of two dividing ``max_seq``, capped at :data:`CONTIGUOUS_BLOCK_CAP`,
    at least 16."""
    if max_seq <= 0:
        return 0
    bs = min(max_seq & -max_seq, CONTIGUOUS_BLOCK_CAP)
    return bs if bs >= 16 else 0


def decode_split_keys(block_size: int) -> int:
    """Keys of one split of the decode kernel's key sweep: whole blocks,
    at most :data:`DECODE_SPLIT_KEYS` (16 blocks at block size 16), and one
    block from half of it up (the contiguous path's 128-row blocks, whose
    rows are short).  A function of the block size alone, so a row's
    result never depends on its batch."""
    if block_size >= DECODE_SPLIT_KEYS // 2:
        return block_size
    return DECODE_SPLIT_KEYS // block_size * block_size


def _dequant_block(seq: int) -> int:
    """Span the quantized fallback dequantizes at a time: the largest
    power-of-two divisor of ``seq`` capped at :data:`DEQUANT_BLOCK_CAP`,
    halved if it would cover the whole cache, so no full-cache float copy
    of an int8 cache is ever made.  Odd ``seq`` is one span."""
    if seq <= 1 or seq % 2:
        return seq
    block = min(seq & -seq, DEQUANT_BLOCK_CAP)
    if block == seq:
        block = seq // 2
    return block


def _quantized_scores(q, k_cache, ks, hd):
    """q.k scores against an int8 K cache, one :func:`_dequant_block`
    span at a time (the hd contraction never crosses a span, so each
    element equals the single-shot product).  f32 ``(b, kv, group, Q,
    S)``."""
    seq = k_cache.shape[1]
    span = _dequant_block(seq)
    scale = hd ** -0.5
    q32 = q.to(torch.float32)
    batch, n_q, kv, group = q.shape[:4]
    out = torch.empty((batch, kv, group, n_q, seq), dtype=torch.float32,
                      device=q.device)
    for start in range(0, seq, span):
        k_blk = k_cache[:, start:start + span].to(q.dtype)
        s = torch.einsum("bqkgd,bskd->bkgqs", q32,
                         k_blk.to(torch.float32)) * scale
        ks_blk = ks[:, start:start + span].permute(0, 2, 1)
        out[..., start:start + span] = s * ks_blk[:, :, None, None, :]
    return out


def _quantized_weighted_sum(weights, v_cache, vs, out_dtype):
    """``softmax-weights @ V`` against an int8 V cache, one span at a
    time, f32 accumulation across spans.  ``weights`` f32 ``(b, kv,
    group, Q, S)``; returns ``(b, Q, kv, group, hd)``."""
    seq = v_cache.shape[1]
    span = _dequant_block(seq)
    acc = None
    for start in range(0, seq, span):
        w = weights[..., start:start + span] \
            * vs[:, start:start + span].permute(0, 2, 1)[:, :, None, None, :]
        v_blk = v_cache[:, start:start + span].to(out_dtype)
        part = torch.einsum("bkgqs,bskd->bqkgd",
                            w.to(out_dtype).to(torch.float32),
                            v_blk.to(torch.float32))
        acc = part if acc is None else acc + part
    return acc.to(out_dtype)


def cached_gqa_attention(q, cache_layer, query_positions, hd,
                         window: Optional[int] = None):
    """Masked GQA attention over a KV cache: the oracle of the decode
    kernel and the CPU decode path.  ``q`` (batch, Q, kv, group, hd);
    ``query_positions`` (batch, Q) absolute positions; key row ``s`` is
    attended iff ``s <= position`` (and within ``window`` of it).

    Int8 KV: per-(token, head) scales factor out of the q.k contraction
    (they multiply the score) and into the softmax weights on the value
    side, both exact dequantizations, one span at a time."""
    k_cache, v_cache = cache_layer["k"], cache_layer["v"]
    quantized = "ks" in cache_layer
    if quantized:
        s = _quantized_scores(q, k_cache, cache_layer["ks"], hd)
    else:
        s = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                         k_cache.to(torch.float32)) * hd ** -0.5
    key_pos = torch.arange(k_cache.shape[1], device=q.device)[None, None, :]
    positions = query_positions.to(torch.int64)[:, :, None]
    mask = key_pos <= positions
    if window is not None:
        mask &= key_pos > positions - window
    s = torch.where(mask[:, None, None, :, :], s,
                    torch.full_like(s, NEG_INF))
    weights = torch.softmax(s, dim=-1)
    if quantized:
        return _quantized_weighted_sum(weights, v_cache, cache_layer["vs"],
                                       q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", weights.to(v_cache.dtype),
                        v_cache)


def paged_decode_reference(q, k_pool, v_pool, tables, positions,
                           ks=None, vs=None, window: Optional[int] = None):
    """Gather-then-masked-attend plain version of the kernel: pool[tables]
    -> per-row contiguous view, then :func:`cached_gqa_attention`.  ``q``
    (batch, kv, group, hd); pools (n_blocks, bs, kv, hd); returns (batch,
    kv, group, hd)."""
    tables = tables.to(torch.int64)

    def view(pool):
        gathered = pool[tables]
        batch, n_blocks, bs = gathered.shape[:3]
        return gathered.reshape((batch, n_blocks * bs)
                                + tuple(gathered.shape[3:]))

    cache_layer = {"k": view(k_pool), "v": view(v_pool)}
    if ks is not None:
        cache_layer["ks"] = view(ks)
        cache_layer["vs"] = view(vs)
    out = cached_gqa_attention(q[:, None], cache_layer, positions[:, None],
                               q.shape[-1], window=window)
    return out[:, 0]


def paged_decode_split_reference(q, k_pool, v_pool, tables, positions,
                                 ks=None, vs=None,
                                 window: Optional[int] = None):
    """The kernel's algorithm in plain f32 PyTorch: the key axis cut into
    :func:`decode_split_keys` splits, each split's (max, sum, weighted
    values) partial over its live keys, and the live splits merged by
    log-sum-exp in split order (a split with no live key contributes
    nothing; a row whose sum is 0 divides by 1).  Same arguments and
    result as :func:`paged_decode_reference`; only the tests use it."""
    batch, kv, group, hd = q.shape
    block_size = k_pool.shape[1]
    max_keys = tables.shape[1] * block_size
    split = decode_split_keys(block_size)
    n_splits = -(-max_keys // split)
    pad = n_splits * split - max_keys
    ids = tables.to(torch.int64)

    def view(pool):
        gathered = pool[ids].to(torch.float32)
        flat = gathered.reshape((batch, max_keys) + tuple(gathered.shape[3:]))
        widths = [0, 0] * (flat.dim() - 2) + [0, pad]
        return torch.nn.functional.pad(flat, widths).reshape(
            (batch, n_splits, split) + tuple(flat.shape[2:]))

    k, v = view(k_pool), view(v_pool)                 # (b, n, s, kv, hd)
    scores = torch.einsum("bkgd,bnskd->bkgns", q.to(torch.float32),
                          k) * hd ** -0.5
    weight_scale = None
    if ks is not None:
        scores = scores * view(ks).permute(0, 3, 1, 2)[:, :, None]
        weight_scale = view(vs).permute(0, 3, 1, 2)[:, :, None]
    key = torch.arange(n_splits * split, device=q.device)
    pos = positions.to(torch.int64)[:, None]
    visible = (key[None, :] <= pos) & (key[None, :] < max_keys)
    if window is not None:
        visible &= key[None, :] > pos - window
    visible = visible.reshape(batch, 1, 1, n_splits, split)
    live = visible.any(-1)                            # (b, 1, 1, n)
    scores = torch.where(visible, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(-1)                               # (b, kv, g, n)
    p = torch.where(visible, torch.exp(scores - m[..., None]),
                    torch.zeros_like(scores))
    total = p.sum(-1)
    if weight_scale is not None:
        p = p * weight_scale
    acc = torch.einsum("bkgns,bnskd->bkgnd", p, v)
    m = torch.where(live, m, torch.full_like(m, NEG_INF))
    big = m.amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - big), torch.zeros_like(m))
    value = (w[..., None] * acc).sum(-2)
    denom = (w * total).sum(-1, keepdim=True)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return (value / denom).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, tables, positions,
                           ks=None, vs=None, window: Optional[int] = None,
                           sm_scale: Optional[float] = None):
    """Ragged paged GQA decode attention.

    Args:
      q: ``(batch, kv_heads, group, head_dim)``, one query token per row.
      k_pool / v_pool: ``(n_blocks, block_size, kv_heads, head_dim)``
        (bf16/f32, or int8 with ``ks``/``vs``).
      tables: ``(batch, max_blocks)`` int32 pool block id of each row's
        logical block ``j`` (entries past the row's length are never
        read).
      positions: ``(batch,)`` int32 query positions; keys
        ``0..positions[row]`` are visible (the current token's K/V must
        already be in the pool).
      ks / vs: optional ``(n_blocks, block_size, kv_heads)`` f32 scales.
      window: sliding-window size.

    Returns ``(batch, kv_heads, group, head_dim)`` in ``q.dtype``.  CPU
    tensors take :func:`paged_decode_reference`; CUDA tensors launch the
    kernel (one CUDA kernel a call; rows spanning several splits merge in
    the last CTA of the row to finish)."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, tables, positions,
                                      ks=ks, vs=vs, window=window)
    batch, kv_heads, group, head_dim = q.shape
    n_blocks, block_size = k_pool.shape[:2]
    max_blocks = tables.shape[1]
    if sm_scale is None:
        sm_scale = head_dim ** -0.5
    if head_dim > 128 or head_dim % 16 or group > 8 or block_size > 128:
        raise ValueError(
            f"paged_decode_attention: head_dim {head_dim}, group {group}, "
            f"block_size {block_size} outside the kernel's envelope "
            "(head_dim <= 128 and a multiple of 16, group <= 8, "
            "block_size <= 128)")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged_decode_attention: q dtype {q.dtype}")
    quantized = ks is not None
    if quantized != (k_pool.dtype == torch.int8) or v_pool.dtype \
            != k_pool.dtype:
        raise TypeError("paged_decode_attention: int8 pools need ks/vs "
                        "and float pools take none")
    if k_pool.shape != v_pool.shape or k_pool.shape[2:] \
            != (kv_heads, head_dim):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}")
    if tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("paged_decode_attention: tables and positions "
                        "must be int32")
    if tables.shape[0] != batch or tuple(positions.shape) != (batch,):
        raise ValueError("paged_decode_attention: tables/positions do not "
                         "match the batch")
    out = torch.empty_like(q)
    operands = [q, k_pool, v_pool, tables, positions, out]
    if quantized:
        if ks.shape != k_pool.shape[:3] or vs.shape != ks.shape \
                or ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise ValueError("paged_decode_attention: scales must be f32 "
                             "(n_blocks, block_size, kv_heads)")
        operands += [ks, vs]
    device = _cuda.check_cuda("paged_decode_attention", *operands)
    # Rows with several live splits merge per-split partials.
    n_splits = -(-max_blocks * block_size // decode_split_keys(block_size))
    partials, arrivals = _cuda.scratch(
        device, batch * kv_heads * n_splits * group * (head_dim + 2),
        batch * kv_heads)
    _cuda.launch("aiko_paged_decode", device, q.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), _cuda.ptr(ks),
                 _cuda.ptr(vs), tables.data_ptr(), positions.data_ptr(),
                 out.data_ptr(), partials.data_ptr(), arrivals.data_ptr(),
                 batch, kv_heads, group, head_dim, block_size, max_blocks,
                 int(window or 0), float(sm_scale),
                 _cuda.DTYPE_CODES[q.dtype], _cuda.DTYPE_CODES[k_pool.dtype])
    paged_decode_attention.launches += 1
    return out


#: Kernel launches on the CUDA path (never counts the plain version).
_cuda.counted(paged_decode_attention)
