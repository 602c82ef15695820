"""Ragged paged append attention: chunked prefill and speculative verify
straight against the block pool, and the decode step's K/V write, with
their hand-written CUDA kernels (the KV writer's three modes and the chunk
attention) and their plain versions.

Port of ``aiko_services_tpu/ops/paged_prefill.py``.  Admission appends a
prompt chunk into the slot's block chain and attends its queries over the
cached prefix blocks plus the causally visible part of the chunk, reading
K/V in place: no bucket cache, no gather, no scatter-back.  A speculative
verify does the same for each slot's short window at its own, unaligned
decode position.

* :func:`append_kv` writes the chunk's ``(batch, T, kv, hd)`` K/V into
  pool blocks ``tables[row, cached // bs + cb]`` in place
  (``csrc/kv_write.cu``'s aligned mode on CUDA tensors); int8 pools
  quantize each (token, kv head) vector exactly as
  :func:`_kv_quantize_rows`.  Blocks past a row's ``chunk_len`` are not
  written by the kernel; the plain version flushes them into scratch
  block 0 (never attended), as the JAX kernel does, so the two agree
  everywhere but block 0.
* :func:`append_kv_ragged` writes a verify window's rows at any per-row
  start: row ``t < chunk_lens[b]`` lands at position ``cached_lens[b] +
  t`` (``csrc/kv_write.cu``'s ragged mode on CUDA tensors).  Neither it
  nor its plain version writes anything for rows past ``chunk_len``.
* :func:`write_kv_rows` is the decode step's write: one ``(batch, 1, kv,
  hd)`` row a slot at ``positions`` through the slots' tables
  (``csrc/kv_write.cu``'s row mode on CUDA tensors, the ragged writer at
  T = 1 with every row live); a contiguous cache is a pool of ``batch``
  blocks of ``max_seq`` rows with tables ``arange(batch)[:, None]``.  Past
  the end it clamps to the last row on a contiguous cache and drops the
  row on a pool, as the JAX package's decode writes do.
* :func:`chunk_attention` runs the chunk's queries over the appended
  pool (``csrc/paged_prefill.cu`` on CUDA tensors: fixed-size key splits
  merged in split order, see :func:`chunk_attention_split_reference`).
* :func:`paged_prefill_attention` is :func:`append_kv` then
  :func:`chunk_attention`; :func:`paged_verify_attention` is
  :func:`append_kv_ragged` then :func:`chunk_attention`.  On CPU tensors
  both keep the JAX package's dispatch rule: shapes outside the kernels'
  envelope take :func:`paged_prefill_reference`.  On CUDA tensors such
  shapes raise.

Every function here updates the pool IN PLACE and returns it, which is
what the JAX kernels' input/output aliasing buys on the TPU.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _cuda
from .attention import NEG_INF
from .paged_attention import cached_gqa_attention

__all__ = ["paged_prefill_attention", "paged_prefill_reference",
           "paged_verify_attention", "append_kv", "append_kv_reference",
           "append_kv_ragged", "append_kv_ragged_reference",
           "write_kv_rows", "write_kv_rows_reference", "write_decode_rows",
           "DecodeRows", "KVLayer",
           "chunk_attention", "chunk_attention_reference",
           "chunk_attention_split_reference", "chunk_split_keys",
           "chunk_live_splits"]

#: Head dims the chunk-attention kernel is built for.
CHUNK_HEAD_DIMS = (16, 32, 64, 128)
#: Most keys one CTA of the chunk-attention kernel covers (``kSplitKeys``
#: of csrc/paged_prefill.cu), and the (token, query head) rows of its
#: query tile (``kRows``).
CHUNK_SPLIT_KEYS = 256
CHUNK_TILE_ROWS = 64
#: Most bytes of split partials one chunk-attention launch may keep; a
#: launch that would need more walks each query tile's splits in one CTA
#: (the same bits, about 1.5x the work, no partials).
CHUNK_SCRATCH_BYTES = 1 << 29
#: Widest verify window the dispatch sends through the kernels (the JAX
#: package's ``Q_TILE_CAP``).
VERIFY_T_MAX = 128


def _kv_quantize_rows(rows):
    """(..., hd) -> (int8 rows, f32 scales (...,)): symmetric absmax per
    vector (one scale per cached token per kv head).  THE int8 KV
    quantizer of the port: the model's cache writers use it too, and
    ``csrc/kv_write.cu`` reproduces it bit for bit (a true division
    by the scale, round half to even).  The 127 is a tensor: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, which
    is one ulp off a true division in places."""
    r32 = rows.to(torch.float32)
    amax = r32.abs().amax(dim=-1)
    scale = torch.where(amax == 0, 1.0,
                        amax / torch.full_like(amax, 127.0))
    q = torch.clamp(torch.round(r32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _pool_sources(layer: Dict, k, v) -> Dict:
    """(key -> source) map of a KV write: k/v, or on an int8 layer their
    codes and scales (K and V quantized in one pass: the quantizer is per
    vector, so stacking them changes no value)."""
    if "ks" in layer:
        q, scale = _kv_quantize_rows(torch.stack([k, v]))
        return {"k": q[0], "v": q[1], "ks": scale[0], "vs": scale[1]}
    return {"k": k, "v": v}


def _write_rows_reference(pool: Dict, k_new, v_new, tables, positions):
    """Scatter every chunk row (padding rows too) into the pool at its
    absolute position ``positions`` (batch, T), in place; int8 layouts
    quantize like the cache writer.  A row whose table entry is past the
    table is dropped, as the JAX package's scatter drops the out-of-range
    gather's row."""
    block_size = pool["k"].shape[1]
    positions = positions.to(torch.int64)
    entries = positions // block_size
    live = entries < tables.shape[1]
    block_ids = tables.to(torch.int64).gather(
        1, entries.clamp(max=tables.shape[1] - 1))[live]
    offsets = (positions % block_size)[live]
    for key, src in _pool_sources(pool, k_new, v_new).items():
        pool[key][block_ids, offsets] = src[live].to(pool[key].dtype)
    return pool


def _gathered_view(pool: Dict, tables) -> Dict:
    """``pool[tables]`` as per-row contiguous caches (batch, blocks*bs,
    ...)."""
    tables = tables.to(torch.int64)

    def view(buf):
        gathered = buf[tables]
        batch, n_blocks, block_size = gathered.shape[:3]
        return gathered.reshape((batch, n_blocks * block_size)
                                + tuple(gathered.shape[3:]))
    return {key: view(buf) for key, buf in pool.items()}


def _query_positions(cached_lens, T: int):
    return (cached_lens.to(torch.int64)[:, None]
            + torch.arange(T, device=cached_lens.device)[None, :])


def paged_prefill_reference(q, k_new, v_new, pool, tables, cached_lens,
                            chunk_lens, window: Optional[int] = None):
    """Write-then-gather-then-attend oracle: scatter the chunk's K/V into
    the pool, view ``pool[tables]`` as per-row contiguous caches and run
    :func:`cached_gqa_attention` with query positions ``cached + [0,
    T)``.  ``q`` (batch, T, kv, group, hd); returns ``(out (batch, T, kv,
    group, hd), pool)``.  Output rows at or past ``chunk_lens[row]`` are
    padding, attended against garbage and discarded by callers."""
    T = k_new.shape[1]
    positions = _query_positions(cached_lens, T)
    _write_rows_reference(pool, k_new, v_new, tables, positions)
    out = cached_gqa_attention(q, _gathered_view(pool, tables), positions,
                               q.shape[-1], window=window)
    return out, pool


# --------------------------------------------------------------------------- #
# append_kv: TPU kernel 5 (``_append_kv``)

def _chunk_blocks(k_new, pool, tables, cached_lens, chunk_lens):
    """(pool block id, live) of each ``block_size`` block of the chunk:
    ``tables[row, cached // bs + cb]`` (entry clamped to the table, as
    the JAX index map does) and whether the block starts before the
    row's ``chunk_len``."""
    T = k_new.shape[1]
    block_size = pool["k"].shape[1]
    cb = torch.arange(T // block_size, device=k_new.device)
    entries = (cached_lens.to(torch.int64)[:, None] // block_size
               + cb[None, :]).clamp(max=tables.shape[1] - 1)
    block_ids = tables.to(torch.int64).gather(1, entries)
    live = cb[None, :] * block_size < chunk_lens.to(torch.int64)[:, None]
    return block_ids, live


def append_kv_reference(k_new, v_new, pool, tables, cached_lens,
                        chunk_lens):
    """Plain version of :func:`append_kv`: whole blocks of the chunk land
    in their table-resolved pool blocks, in place; blocks past
    ``chunk_len`` flush into scratch block 0 (one scatter, no host
    sync)."""
    batch, T = k_new.shape[:2]
    block_size = pool["k"].shape[1]
    block_ids, live = _chunk_blocks(k_new, pool, tables, cached_lens,
                                    chunk_lens)
    targets = torch.where(live, block_ids, 0)
    for key, src in _pool_sources(pool, k_new, v_new).items():
        blocks = src.reshape((batch, T // block_size, block_size)
                             + tuple(src.shape[2:]))
        pool[key][targets] = blocks.to(pool[key].dtype)
    return pool


def append_kv(k_new, v_new, pool, tables, cached_lens, chunk_lens):
    """Write a chunk's K/V into its pool blocks, in place.

    Args:
      k_new / v_new: ``(batch, T, kv_heads, head_dim)``, ``T`` a multiple
        of the pool's block size.
      pool: per-layer dict ``{"k", "v"[, "ks", "vs"]}`` of ``(n_blocks,
        block_size, kv_heads, head_dim)`` pools (int8 with f32 ``(n_blocks,
        block_size, kv_heads)`` scales).
      tables: ``(batch, max_blocks)`` int32 block tables.
      cached_lens: ``(batch,)`` int32 tokens already in the pool per row,
        multiples of ``block_size``.
      chunk_lens: ``(batch,)`` int32 real tokens of the chunk per row.

    CPU tensors take :func:`append_kv_reference`; CUDA tensors launch
    ``csrc/kv_write.cu``'s aligned writer.  Returns ``pool``."""
    if k_new.device.type == "cpu":
        return append_kv_reference(k_new, v_new, pool, tables, cached_lens,
                                   chunk_lens)
    T, block_size = k_new.shape[1], pool["k"].shape[1]
    if T % block_size:
        raise ValueError(f"append_kv: chunk width {T} is not a multiple of "
                         f"block_size {block_size}")
    _launch_append("aiko_append_kv", "append_kv", k_new, v_new, pool, tables,
                   cached_lens, chunk_lens)
    append_kv.launches += 1
    return pool


#: Kernel launches on the CUDA path (never counts the plain version).
_cuda.counted(append_kv)


def _launch_append(entry: str, name: str, k_new, v_new, pool, tables,
                   cached_lens, chunk_lens) -> None:
    """Check a K/V append's CUDA operands and launch C entry ``entry`` (the
    aligned and the ragged writer take the same arguments)."""
    batch, T, kv_heads, head_dim = k_new.shape
    block_size = pool["k"].shape[1]
    quantized = "ks" in pool
    if v_new.shape != k_new.shape or pool["k"].shape[2:] \
            != (kv_heads, head_dim) or pool["v"].shape != pool["k"].shape:
        raise ValueError(f"{name}: k/v {tuple(k_new.shape)}, pool "
                         f"{tuple(pool['k'].shape)}")
    if k_new.dtype not in (torch.bfloat16, torch.float32) \
            or v_new.dtype != k_new.dtype:
        raise TypeError(f"{name}: k/v dtype {k_new.dtype}")
    if quantized != (pool["k"].dtype == torch.int8):
        raise TypeError(f"{name}: int8 pools need ks/vs and float pools "
                        "take none")
    if pool["k"].dtype not in _cuda.DTYPE_CODES:
        raise TypeError(f"{name}: pool dtype {pool['k'].dtype}")
    _check_head_dim(name, k_new)
    _check_meta(name, tables, cached_lens, chunk_lens, batch)
    operands = [k_new, v_new, pool["k"], pool["v"], tables, cached_lens,
                chunk_lens]
    if quantized:
        _check_scales(name, pool)
        operands += [pool["ks"], pool["vs"]]
    device = _cuda.check_cuda(name, *operands)
    _cuda.launch(entry, device, k_new.data_ptr(), v_new.data_ptr(),
                 pool["k"].data_ptr(), pool["v"].data_ptr(),
                 _cuda.ptr(pool.get("ks")), _cuda.ptr(pool.get("vs")),
                 tables.data_ptr(), cached_lens.data_ptr(),
                 chunk_lens.data_ptr(), batch, T, kv_heads, head_dim,
                 block_size, tables.shape[1], _cuda.DTYPE_CODES[k_new.dtype],
                 _cuda.DTYPE_CODES[pool["k"].dtype])


def _check_meta(name, tables, cached_lens, chunk_lens, batch):
    if tables.dtype != torch.int32 or cached_lens.dtype != torch.int32 \
            or chunk_lens.dtype != torch.int32:
        raise TypeError(f"{name}: tables, cached_lens and chunk_lens must "
                        "be int32")
    if tables.shape[0] != batch or tuple(cached_lens.shape) != (batch,) \
            or tuple(chunk_lens.shape) != (batch,):
        raise ValueError(f"{name}: tables/cached_lens/chunk_lens do not "
                         "match the batch")


def _check_scales(name, pool):
    if pool["ks"].shape != pool["k"].shape[:3] \
            or pool["vs"].shape != pool["ks"].shape \
            or pool["ks"].dtype != torch.float32 \
            or pool["vs"].dtype != torch.float32:
        raise ValueError(f"{name}: scales must be f32 (n_blocks, "
                         "block_size, kv_heads)")


# --------------------------------------------------------------------------- #
# append_kv_ragged: TPU kernel 7 (``_append_kv_ragged``)

def append_kv_ragged_reference(k_new, v_new, pool, tables, cached_lens,
                               chunk_lens):
    """Plain version of :func:`append_kv_ragged`: every live window row
    lands at its table-resolved (block, offset), in place (table entry
    clamped to the table, as the JAX index map does); rows past
    ``chunk_len`` write nowhere."""
    T = k_new.shape[1]
    block_size = pool["k"].shape[1]
    positions = _query_positions(cached_lens, T)
    live = torch.arange(T, device=k_new.device)[None, :] \
        < chunk_lens.to(torch.int64)[:, None]
    entries = (positions // block_size).clamp(max=tables.shape[1] - 1)
    block_ids = tables.to(torch.int64).gather(1, entries)[live]
    offsets = (positions % block_size)[live]
    for key, src in _pool_sources(pool, k_new, v_new).items():
        pool[key][block_ids, offsets] = src[live].to(pool[key].dtype)
    return pool


def append_kv_ragged(k_new, v_new, pool, tables, cached_lens, chunk_lens):
    """Write a verify window's K/V into its pool blocks, in place, each row
    from its own (unaligned) start.

    Args as :func:`append_kv`, except that ``T`` is any width,
    ``cached_lens`` need not be block-aligned, and a row with
    ``chunk_lens[row] == 0`` writes nothing.  Row ``t < chunk_lens[b]``
    lands at pool block ``tables[b, (cached_lens[b] + t) // bs]``, offset
    ``(cached_lens[b] + t) % bs``.

    CPU tensors take :func:`append_kv_ragged_reference`; CUDA tensors
    launch ``csrc/kv_write.cu``'s ragged writer.  Returns ``pool``."""
    if k_new.device.type == "cpu":
        return append_kv_ragged_reference(k_new, v_new, pool, tables,
                                          cached_lens, chunk_lens)
    _launch_append("aiko_append_kv_ragged", "append_kv_ragged", k_new, v_new,
                   pool, tables, cached_lens, chunk_lens)
    append_kv_ragged.launches += 1
    return pool


#: Kernel launches on the CUDA path (never counts the plain version).
_cuda.counted(append_kv_ragged)


# --------------------------------------------------------------------------- #
# write_kv_rows: the decode step's K/V write (the ragged writer at T = 1)

def write_kv_rows_reference(k, v, pool, tables, positions,
                            clamp: bool = False):
    """Plain version of :func:`write_kv_rows`: the eager scatter of every
    slot's row at its table-resolved (block, offset),
    :func:`_write_rows_reference` at ``positions[:, None]`` (clamped to
    the last row first when ``clamp``), in place."""
    if clamp:
        positions = positions.clamp(
            max=tables.shape[1] * pool["k"].shape[1] - 1)
    return _write_rows_reference(pool, k, v, tables, positions[:, None])


def write_kv_rows(k, v, pool, tables, positions, clamp: bool = False):
    """The decode step's K/V write, in place: slot ``b``'s row lands in
    pool block ``tables[b, positions[b] // bs]`` at offset ``positions[b]
    % bs``, int8 pools quantized as :func:`_kv_quantize_rows`.  Past the
    end it does what the JAX package's decode writes do: with ``clamp``
    (a contiguous cache, ``_cache_write_rows``'s ``dynamic_update_slice``)
    a position at or past ``max_blocks * bs`` writes the last row; without
    it (a pool, ``_paged_write_rows``'s scatter) that row is dropped.  A
    contiguous cache and a one-entry pool table look alike, so the caller
    says which rule holds.

    Args:
      k / v: ``(batch, 1, kv_heads, head_dim)``.  On CUDA tensors only the
        kv heads and features need be contiguous: the rotary pass hands
        ``k`` over as a slice of the fused q/k tensor, and the kernel takes
        its row stride.
      pool: per-layer dict as :func:`append_kv`'s.  A contiguous cache
        ``(batch, max_seq, kv, hd)`` is a pool of ``batch`` blocks of
        ``max_seq`` rows, with tables ``arange(batch)[:, None]``.
      tables: ``(batch, max_blocks)`` int32 block tables.
      positions: ``(batch,)`` int32 non-negative positions.
      clamp: the contiguous cache's rule past the end (see above).

    CPU tensors take :func:`write_kv_rows_reference`; CUDA tensors launch
    ``csrc/kv_write.cu``'s row writer (the ragged writer with ``T = 1`` and
    every row live) or raise.  A decode step writes every layer through
    the same tables and positions: it makes their :class:`DecodeRows`
    once and calls :func:`write_decode_rows`, this write, for each layer.
    Returns ``pool``."""
    return write_decode_rows(k, v, pool, DecodeRows(tables, positions,
                                                    clamp))


#: Kernel launches on the CUDA path (never counts the plain version).
_cuda.counted(write_kv_rows)


class DecodeRows:
    """Where one decode step writes its rows: the ``(batch, max_blocks)``
    tables and ``(batch,)`` positions of :func:`write_kv_rows`, and its
    rule past the end (``clamp``: a contiguous cache's).  The model's
    decode core makes it once a step; on CUDA tensors it checks them then
    (int32, on one device, contiguous), for every layer."""

    __slots__ = ("tables", "positions", "clamp", "batch", "device")

    def __init__(self, tables, positions, clamp: bool = False):
        self.tables, self.positions = tables, positions
        self.clamp = bool(clamp)
        self.batch, self.device = positions.shape[0], None
        if not (tables.is_cuda or positions.is_cuda):
            return
        name = "write_kv_rows"
        if tables.dtype != torch.int32 or positions.dtype != torch.int32:
            raise TypeError(f"{name}: tables and positions must be int32")
        if tables.dim() != 2 or positions.dim() != 1 \
                or tables.shape[0] != self.batch:
            raise ValueError(f"{name}: tables {tuple(tables.shape)} and "
                             f"positions {tuple(positions.shape)} do not "
                             "match")
        self.device = _cuda.check_cuda(name, tables, positions)


class KVLayer(dict):
    """One layer's KV buffers ``{"k", "v"[, "ks", "vs"]}`` as the model's
    caches and pools hold them: a dict that also keeps its buffers as the
    row writer checked them (:class:`_LayerPlan`), from its first write on
    the card, checked again only if a buffer is replaced.  A plain dict
    of buffers is written the same way, checked on every call."""

    __slots__ = ("row_plan",)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.row_plan = None


class _LayerPlan:
    """A pool layer's buffers, checked for the row writer (one CUDA
    device, contiguous, 16-byte aligned; int8 pools with f32 scales), and
    the sizes its launch takes, with the row dtypes whose (token, kv
    head) vector the writer takes at this head_dim."""

    __slots__ = ("k", "v", "ks", "vs", "device", "block_size", "kv_heads",
                 "head_dim", "pool_code", "row_dtypes")

    def __init__(self, pool):
        name = "write_kv_rows"
        k_pool, v_pool = pool["k"], pool["v"]
        quantized = "ks" in pool
        if k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
            raise ValueError(f"{name}: pool k {tuple(k_pool.shape)}, v "
                             f"{tuple(v_pool.shape)}")
        if k_pool.dtype not in _cuda.DTYPE_CODES \
                or v_pool.dtype != k_pool.dtype \
                or quantized != (k_pool.dtype == torch.int8) \
                or set(pool) - {"k", "v", "ks", "vs"}:
            raise TypeError(f"{name}: pool dtype {k_pool.dtype} (int8 pools "
                            "need ks/vs and float pools take none)")
        operands = [k_pool, v_pool]
        if quantized:
            _check_scales(name, pool)
            operands += [pool["ks"], pool["vs"]]
        self.device = _cuda.check_cuda(name, *operands)
        if self.device.type != "cuda":
            raise ValueError(f"{name}: the pool is on {self.device}")
        self.k, self.v = k_pool, v_pool
        self.ks, self.vs = pool.get("ks"), pool.get("vs")
        self.block_size, self.kv_heads, self.head_dim = k_pool.shape[1:]
        self.pool_code = _cuda.DTYPE_CODES[k_pool.dtype]
        self.row_dtypes = tuple(
            dtype for dtype in (torch.bfloat16, torch.float32)
            if _vector_chunks_fit(self.head_dim * dtype.itemsize))

    def holds(self, pool) -> bool:
        """Whether ``pool`` still holds the buffers checked."""
        if self.ks is None:
            return "ks" not in pool and pool["k"] is self.k \
                and pool["v"] is self.v
        return "ks" in pool and "vs" in pool and pool["k"] is self.k \
            and pool["v"] is self.v and pool["ks"] is self.ks \
            and pool["vs"] is self.vs


def write_decode_rows(k, v, pool, rows: DecodeRows):
    """:func:`write_kv_rows` at a decode step's :class:`DecodeRows`."""
    if not k.is_cuda:
        return write_kv_rows_reference(k, v, pool, rows.tables,
                                       rows.positions, rows.clamp)
    try:
        layer = pool.row_plan
    except AttributeError:               # a plain dict: checked every call
        layer = None
    if layer is None or not layer.holds(pool):
        layer = _LayerPlan(pool)
        if isinstance(pool, KVLayer):
            pool.row_plan = layer
    k_ptr, v_ptr, k_stride, v_stride = _checked_rows(k, v, layer, rows)
    quantized = layer.ks is not None
    code = _cuda.library().aiko_write_kv_rows(
        k_ptr, v_ptr, layer.k.data_ptr(), layer.v.data_ptr(),
        layer.ks.data_ptr() if quantized else None,
        layer.vs.data_ptr() if quantized else None,
        rows.tables.data_ptr(), rows.positions.data_ptr(), rows.batch,
        layer.kv_heads, layer.head_dim, layer.block_size,
        rows.tables.shape[1], k_stride, v_stride,
        _cuda.DTYPE_CODES[k.dtype], layer.pool_code, int(rows.clamp),
        torch._C._cuda_getCurrentRawStream(layer.device.index))
    if code:
        _cuda.raise_error("aiko_write_kv_rows", code)
    write_kv_rows.launches += 1
    return pool


def _checked_rows(k, v, layer: _LayerPlan, rows: DecodeRows):
    """Check a decode write's ``k`` and ``v`` against its pool layer and
    the step's rows: ``(batch, 1, kv_heads, head_dim)``, bf16 or f32 (a
    vector the writer takes), on the pool's device, their kv heads and
    features contiguous, each row and row stride 16-byte aligned.
    Returns their pointers and row strides for the launch."""
    name = "write_kv_rows"
    if k.shape != (rows.batch, 1, layer.kv_heads, layer.head_dim) \
            or v.shape != k.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} for {rows.batch} slots of "
                         f"{layer.kv_heads} x {layer.head_dim}")
    dtype = k.dtype
    if dtype not in layer.row_dtypes or v.dtype != dtype:
        if dtype in (torch.bfloat16, torch.float32) and v.dtype == dtype:
            _check_head_dim(name, k)
        raise TypeError(f"{name}: k/v dtype {dtype}, {v.dtype}")
    if rows.device != layer.device:
        raise ValueError(f"{name}: tables and positions on "
                         f"{rows.tables.device}, the pool on {layer.device}")
    k_stride, v_stride = k.stride(), v.stride()
    k_ptr, v_ptr = k.data_ptr(), v.data_ptr()
    for x, stride, ptr in ((k, k_stride, k_ptr), (v, v_stride, v_ptr)):
        if x.device != layer.device:
            raise ValueError(f"{name}: rows on {x.device}, the pool on "
                             f"{layer.device}")
        if stride[3] != 1 or (layer.kv_heads > 1
                              and stride[2] != layer.head_dim) or ptr % 16 \
                or (rows.batch > 1 and stride[0] * dtype.itemsize % 16):
            raise ValueError(f"{name}: a row of shape {tuple(x.shape[2:])} "
                             f"with strides {stride} is not contiguous and "
                             "16-byte aligned")
    return k_ptr, v_ptr, k_stride[0], v_stride[0]


def _vector_chunks_fit(vector_bytes: int) -> bool:
    """The KV writer's envelope: a (token, kv head) vector is a power of
    two of 16-byte chunks, at most 32 (one lane each of a warp)."""
    chunks, rest = divmod(vector_bytes, 16)
    return not rest and 0 < chunks <= 32 and not chunks & (chunks - 1)


def _check_head_dim(name, k_new) -> None:
    """Raise unless ``k_new``'s vectors fit :func:`_vector_chunks_fit`."""
    if not _vector_chunks_fit(k_new.shape[-1] * k_new.element_size()):
        raise ValueError(f"{name}: head_dim {k_new.shape[-1]} in "
                         f"{k_new.dtype} is not a power of two of 16-byte "
                         "chunks, at most 32")


# --------------------------------------------------------------------------- #
# chunk_attention: TPU kernel 6 (``_chunk_attention``)

def chunk_attention_reference(q, pool, tables, cached_lens,
                              window: Optional[int] = None):
    """Plain version of :func:`chunk_attention` over an already appended
    pool: the gathered per-row view and :func:`cached_gqa_attention` with
    query positions ``cached + [0, T)`` (the JAX package's reference
    dispatch)."""
    positions = _query_positions(cached_lens, q.shape[1])
    return cached_gqa_attention(q, _gathered_view(pool, tables), positions,
                                q.shape[-1], window=window)


def chunk_split_keys(block_size: int) -> int:
    """Keys of one split of the chunk kernel's key sweep: whole blocks,
    :data:`CHUNK_SPLIT_KEYS` where the block size divides it, else one
    block.  A function of the block size alone, so a query's result never
    depends on its chunk, its batch or the data."""
    if block_size >= CHUNK_SPLIT_KEYS:
        return block_size
    return CHUNK_SPLIT_KEYS // block_size * block_size


def chunk_live_splits(T: int, group: int, block_size: int, kv_blocks: int,
                      window: Optional[int] = None) -> int:
    """Most splits that hold a live key of one query tile of the chunk
    kernel: every split of the table, or with a window the splits that
    a tile's span of tokens plus the window can touch."""
    split = chunk_split_keys(block_size)
    n_splits = -(-kv_blocks * block_size // split)
    if not window:
        return n_splits
    span = min(T - 1, (CHUNK_TILE_ROWS - 1) // group + 1)
    return min(n_splits, (span + window - 1) // split + 2)


def chunk_attention_split_reference(q, pool, tables, cached_lens,
                                    chunk_lens, window: Optional[int] = None,
                                    kv_limit: Optional[int] = None):
    """The kernel's algorithm in plain f32 PyTorch: the key axis cut into
    :func:`chunk_split_keys` splits on absolute key positions, each
    split's (max, sum, weighted values) partial over its visible keys, and
    the splits merged by log-sum-exp in split order (a split with no
    visible key carries no mass; a query whose sum is 0 divides by 1).
    Query ``t`` of row ``b`` sees keys ``<= min(cached + t, cached +
    chunk_len - 1)`` inside the window and the first ``kv_limit`` table
    entries, as the kernel does (padding queries see the chunk's real
    keys).  Same arguments and result as :func:`chunk_attention`; only the
    tests use it."""
    batch, T, kv, group, hd = q.shape
    block_size = pool["k"].shape[1]
    kv_blocks = tables.shape[1] if kv_limit is None \
        else min(int(kv_limit), tables.shape[1])
    n_keys = kv_blocks * block_size
    split = chunk_split_keys(block_size)
    n_splits = -(-n_keys // split)
    pad = n_splits * split - n_keys
    ids = tables[:, :kv_blocks].to(torch.int64)

    def view(buf):
        gathered = buf[ids].to(torch.float32)
        flat = gathered.reshape((batch, n_keys) + tuple(gathered.shape[3:]))
        widths = [0, 0] * (flat.dim() - 2) + [0, pad]
        return torch.nn.functional.pad(flat, widths).reshape(
            (batch, n_splits, split) + tuple(flat.shape[2:]))

    k, v = view(pool["k"]), view(pool["v"])           # (b, n, s, kv, hd)
    scores = torch.einsum("btkgd,bnskd->bkgtns", q.to(torch.float32),
                          k) * hd ** -0.5
    weight_scale = None
    if "ks" in pool:
        scores = scores * view(pool["ks"]).permute(0, 3, 1, 2)[
            :, :, None, None]
        weight_scale = view(pool["vs"]).permute(0, 3, 1, 2)[:, :, None, None]
    key = torch.arange(n_splits * split, device=q.device)
    pos = _query_positions(cached_lens, T)                    # (b, T)
    last = torch.minimum(pos, (cached_lens.to(torch.int64)
                               + chunk_lens.to(torch.int64) - 1)[:, None])
    visible = (key <= last[..., None]) & (key < n_keys)
    if window is not None:
        visible &= key > pos[..., None] - window
    visible = visible.reshape(batch, 1, 1, T, n_splits, split)
    m = torch.where(visible, scores, torch.full_like(scores, NEG_INF)) \
        .amax(-1)                                             # (b,k,g,T,n)
    p = torch.where(visible, torch.exp(scores - m[..., None]),
                    torch.zeros_like(scores))
    total = p.sum(-1)
    if weight_scale is not None:
        p = p * weight_scale
    acc = torch.einsum("bkgtns,bnskd->bkgtnd", p, v)
    big = m.amax(-1, keepdim=True)
    w = torch.exp(m - big)                  # dead splits: w * 0 mass
    value = (w[..., None] * acc).sum(-2)
    denom = (w * total).sum(-1)
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    out = value / denom[..., None]                        # (b, k, g, T, hd)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def chunk_attention(q, pool, tables, cached_lens, chunk_lens,
                    window: Optional[int] = None,
                    kv_limit: Optional[int] = None):
    """Attend a chunk's queries over the row's cached prefix blocks plus
    the causally visible part of the chunk, K/V read straight from the
    pool through the block table.

    ``q`` ``(batch, T, kv_heads, group, head_dim)`` (rope applied); the
    pool must already hold the chunk (:func:`append_kv`).  Query ``t`` of
    row ``b`` sits at position ``cached_lens[b] + t`` and sees keys at
    positions ``<=`` its own (and inside ``window``).  ``kv_limit`` bounds
    the kernel's sweep to the first ``kv_limit`` table entries.  Rows at
    or past ``chunk_lens[b]`` are padding: the kernel reads no key past
    the chunk for them and the caller discards them.  Returns the same
    shape as ``q`` in ``q.dtype``.  CPU tensors take
    :func:`chunk_attention_reference`; CUDA tensors launch
    ``csrc/paged_prefill.cu`` (one CUDA kernel a call: query tiles whose
    keys span several :func:`chunk_split_keys` splits merge in the last
    CTA of the tile to finish, or, where their partials would pass
    :data:`CHUNK_SCRATCH_BYTES`, in one CTA a tile that walks them all)."""
    if q.device.type == "cpu":
        return chunk_attention_reference(q, pool, tables, cached_lens,
                                         window=window)
    batch, T, kv_heads, group, head_dim = q.shape
    n_blocks, block_size = pool["k"].shape[:2]
    max_blocks = tables.shape[1]
    kv_blocks = max_blocks if kv_limit is None else min(int(kv_limit),
                                                        max_blocks)
    _check_query("chunk_attention", q)
    quantized = "ks" in pool
    if pool["k"].dtype not in (torch.bfloat16, torch.int8) \
            or quantized != (pool["k"].dtype == torch.int8) \
            or pool["v"].dtype != pool["k"].dtype:
        raise TypeError(f"chunk_attention: pool dtype {pool['k'].dtype} "
                        "(bf16, or int8 with ks/vs)")
    if pool["k"].shape[2:] != (kv_heads, head_dim) \
            or pool["v"].shape != pool["k"].shape:
        raise ValueError(f"chunk_attention: q {tuple(q.shape)}, pool "
                         f"{tuple(pool['k'].shape)}")
    _check_meta("chunk_attention", tables, cached_lens, chunk_lens, batch)
    out = torch.empty_like(q)
    operands = [q, pool["k"], pool["v"], tables, cached_lens, chunk_lens,
                out]
    if quantized:
        _check_scales("chunk_attention", pool)
        operands += [pool["ks"], pool["vs"]]
    device = _cuda.check_cuda("chunk_attention", *operands)
    # Query tiles whose keys span several splits merge per-split partials,
    # one slot for each live split of a tile.
    tiles = batch * kv_heads * -(-T * group // CHUNK_TILE_ROWS)
    live_cap = chunk_live_splits(T, group, block_size, kv_blocks, window)
    floats = tiles * live_cap * CHUNK_TILE_ROWS * (head_dim + 2)
    if 4 * floats > CHUNK_SCRATCH_BYTES:
        live_cap, floats = 0, 0
    partials, arrivals = _cuda.scratch(device, floats, tiles)
    _cuda.launch("aiko_chunk_attention", device, q.data_ptr(),
                 pool["k"].data_ptr(), pool["v"].data_ptr(),
                 _cuda.ptr(pool.get("ks")), _cuda.ptr(pool.get("vs")),
                 tables.data_ptr(), cached_lens.data_ptr(),
                 chunk_lens.data_ptr(), out.data_ptr(), partials.data_ptr(),
                 arrivals.data_ptr(), batch, T, kv_heads,
                 group, head_dim, block_size, max_blocks, kv_blocks,
                 int(window or 0), live_cap, float(head_dim ** -0.5),
                 _cuda.DTYPE_CODES[pool["k"].dtype])
    chunk_attention.launches += 1
    return out


#: Kernel launches on the CUDA path (never counts the plain version).
_cuda.counted(chunk_attention)


def _check_query(name, q):
    """The chunk-attention kernel's query envelope."""
    if q.shape[-1] not in CHUNK_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} outside the "
                         f"kernel's envelope {CHUNK_HEAD_DIMS}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bf16 queries, got "
                        f"{q.dtype}")


# --------------------------------------------------------------------------- #
# The append-attention entry point

def paged_prefill_attention(q, k_new, v_new, pool, tables, cached_lens,
                            chunk_lens, window: Optional[int] = None,
                            kv_limit: Optional[int] = None):
    """Ragged paged append attention: :func:`append_kv` then
    :func:`chunk_attention`.

    ``q`` ``(batch, T, kv_heads, group, head_dim)``; ``k_new``/``v_new``
    ``(batch, T, kv_heads, head_dim)`` written at positions
    ``cached_lens[row] + [0, T)``; ``cached_lens`` block-aligned (shared
    prefixes are whole blocks and slice widths powers of two, so every
    caller satisfies this by construction); ``kv_limit`` trims the
    attention sweep.  Returns ``(out, pool)`` with the pool updated in
    place.  Shapes outside the kernels' envelope (``head_dim > 128``,
    ``T`` not block-aligned) take :func:`paged_prefill_reference` on CPU
    tensors, as the JAX package does, and raise on CUDA tensors."""
    T, head_dim = q.shape[1], q.shape[-1]
    block_size = pool["k"].shape[1]
    if head_dim > 128 or T % block_size != 0:
        if q.device.type != "cpu":
            raise ValueError(
                f"paged_prefill_attention: head_dim {head_dim}, chunk width "
                f"{T} and block_size {block_size} are outside the kernels' "
                "envelope (head_dim <= 128, block-aligned chunks)")
        return paged_prefill_reference(q, k_new, v_new, pool, tables,
                                       cached_lens, chunk_lens,
                                       window=window)
    append_kv(k_new, v_new, pool, tables, cached_lens, chunk_lens)
    out = chunk_attention(q, pool, tables, cached_lens, chunk_lens,
                          window=window, kv_limit=kv_limit)
    return out, pool


def paged_verify_attention(q, k_new, v_new, pool, tables, cached_lens,
                           chunk_lens, window: Optional[int] = None,
                           kv_limit: Optional[int] = None):
    """Ragged paged VERIFY attention, the speculative twin of
    :func:`paged_prefill_attention`: :func:`append_kv_ragged` then
    :func:`chunk_attention`.

    Two contract differences from the prefill entry: ``cached_lens`` need
    not be block-aligned (each slot verifies at its own decode position),
    and ``chunk_lens`` may differ per row; a row with ``chunk_lens == 0``
    (an inactive slot) writes nothing.  The attention is the prefill
    kernel's, whose absolute-position masking already handles unaligned
    starts, so a verify pass reads each row's history in place.

    Returns ``(out (batch, T, kv_heads, group, head_dim), pool)``, output
    rows past a row's ``chunk_len`` being padding.  Outside the kernels'
    envelope (``head_dim > 128`` or ``T > VERIFY_T_MAX``) CPU tensors take
    :func:`paged_prefill_reference`, as the JAX package does, and CUDA
    tensors raise before anything is written."""
    T, head_dim = q.shape[1], q.shape[-1]
    on_cpu = q.device.type == "cpu"
    if head_dim > 128 or T > VERIFY_T_MAX:
        if not on_cpu:
            raise ValueError(
                f"paged_verify_attention: head_dim {head_dim} and window "
                f"width {T} are outside the kernels' envelope (head_dim <= "
                f"128, T <= {VERIFY_T_MAX})")
        return paged_prefill_reference(q, k_new, v_new, pool, tables,
                                       cached_lens, chunk_lens,
                                       window=window)
    if not on_cpu:
        _check_query("paged_verify_attention", q)
    append_kv_ragged(k_new, v_new, pool, tables, cached_lens, chunk_lens)
    out = chunk_attention(q, pool, tables, cached_lens, chunk_lens,
                          window=window, kv_limit=kv_limit)
    return out, pool
