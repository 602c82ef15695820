"""Cross-replica KV block transfer: export/import of pool blocks.

The port of the JAX package's ``kvstore/transfer.py``: the same wire
format, the same counters, with the device half rewritten for PyTorch.
The JAX package moves blocks through jitted gathers and scatters outside
any Pallas kernel; here they are plain tensor ops on the pool's own
device (a CUDA pool never takes a CPU path).

A replica→replica RPC body: the owner resolves directory-width hex keys
through its full-key prefix index and gathers the table-resolved pool
rows through the FUSED STAGING engine — one ``index_select`` a layer and
buffer, each into its slice of one contiguous uint8 staging tensor on the
device, then ONE device→host copy into pinned memory and ONE sync an
export (``kv_export_sync_count``).  The wire fields are zero-copy views
of that host buffer (bf16 rows view as uint16 bit patterns).  A staging
buffer is never reused while a view of it lives: every gather allocates
its own, so an export payload owns its bytes for as long as it lives.  A
host-tier entry copies its rows out of the staging into the tier's own
pageable memory (the paged server's arena), so page-locked memory holds
only the bytes in transit.  A chain demoted to the owner's host tier exports
straight from its host rows — no promotion.  The importer allocates
blocks from its own pool (evicting — demoting, when a host tier is
configured — cold cached prefixes if needed), assembles the inbound rows
into one pinned staging buffer host-side, uploads it with ONE
host→device copy and writes every layer with ``index_copy_`` INTO the
existing pool tensors: the
captured chunk graphs (``llama.ChunkGraph``) hold the pool's pointers,
so a write that rebound a buffer would leave every replay reading the old
one.  The imported chain keys register in the prefix index under a
lease, pinned until adopted by an admission or released at expiry.

On the serving path imports are ASYNC and step-overlapped
(``async_import=True``): the keys register immediately behind the
tiered-cache ``RESTORING`` producing sentinel and the rows land a few
blocks per engine step through the same queue as host-tier restores —
decode never stalls on an inbound segment, no reader ever sees a
half-landed chain, and the lease arms only when the last block lands
(``kv_imports_async``).  An upload may free its pinned host buffer as
soon as the copy is queued: PyTorch's caching host allocator records an
event on the stream for every ``non_blocking`` copy out of a pinned
block it allocated, and reuses the block only once that event has
passed.

The same fused primitives back the TIERED KV cache:
:func:`gather_block_rows` is the demotion copy (device→host, one sync
per victim batch), :func:`scatter_block_rows` /
:func:`scatter_block_row_dicts` the restore upload (host→device, one
upload per landing batch).  The per-layer implementations survive as
``*_legacy`` for the byte-identity tests.  Every call runs on the thread
that owns the server (a replica's engine thread): a CUDA graph capture
fails if another thread does CUDA work meanwhile.

Host rows are numpy arrays in the wire's dtypes: bf16 as its uint16 bit
pattern, int8 and f32 as themselves.  Wire format (swag dict values;
arrays ride the numpy codec tag), byte for byte the JAX package's:

======================  =============================================
``kv_keys``             json list of FULL (64-hex) chain keys,
                        contiguous
``kv_parent``           full hex of the key preceding ``kv_keys[0]``
                        (empty string at chain root)
``kv_start_depth``      chain depth of ``kv_parent`` (0 at root)
``kv_block_size``       pool block size (must match importer)
``kv_sig``              :func:`pool_signature` (layout handshake)
``kv_dtype``            source dtype name (numpy's: ``bfloat16``,
                        ``int8``, ``float32``)
``kv_l<i>_<name>``      per-layer stacked rows, ``(n_blocks,
                        block_size, kv_heads, head_dim)`` for
                        ``k``/``v`` (+ ``ks``/``vs`` scale planes,
                        ``(n_blocks, block_size, kv_heads)`` f32, on
                        int8 pools)
======================  =============================================

KV transfers are base-model chains (key seed 0); adapter WEIGHT pages
(seed ``ADAPTER_SEED``, :mod:`~.adapters`) export too, flagged
``kv_adapter`` 1, and import under that seed, so a peer can warm-load the
adapter from them.  Per-request adapter KV (a positive seed: the stacked
index is replica-local) never leaves its replica.  Bit-exactness: exported
rows are the owner's pool bytes verbatim and
:func:`~.directory.shareable_blocks` guarantees an imported block is
never rewritten by the importer's admission seed, so greedy decode after
an imported prefix equals local prefill bitwise
(``tests/test_torch_kvstore.py``).

The importer books its pool inflow with the pool auditor
(:mod:`~..obs.pool_audit`, ``alloc`` flows) as the JAX package's does.
Left out: tensor-parallel pools (queue 1 item 11 of ``ROADMAP.md``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs import pool_audit
from .directory import HEX_KEY_CHARS, chain_keys, shareable_blocks

__all__ = ["pool_signature", "export_payload", "import_payload",
           "payload_bytes", "drop_one_block", "seed_chain",
           "gather_block_bytes", "gather_block_rows",
           "scatter_block_rows", "scatter_block_row_dicts",
           "gather_block_rows_legacy", "scatter_block_rows_legacy"]

_BF16 = "bfloat16"

#: torch dtype -> numpy's dtype name (the wire's and the signature's).
_DTYPE_NAMES = {torch.bfloat16: _BF16, torch.float32: "float32",
                torch.float16: "float16", torch.int8: "int8"}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a pool dtype (``bfloat16``, never
    ``torch.bfloat16``)."""
    return _DTYPE_NAMES[dtype]


def wire_dtype(name: str) -> np.dtype:
    """The numpy dtype host rows of a ``name`` pool field travel in: bf16
    as its uint16 bit pattern."""
    return np.dtype(np.uint16) if name == _BF16 else np.dtype(name)


def pool_signature(server) -> str:
    """Layout handshake string: two pools may exchange blocks only when
    every field matches (mismatch means the bytes would be
    reinterpreted, silently corrupting attention)."""
    config = server.config
    return (f"{config.n_layers}:{config.n_kv_heads}:"
            f"{config.head_dim}:{int(server.quantize_kv)}:"
            f"{dtype_name(server.pool[0]['k'].dtype)}")


def payload_bytes(payload: Dict) -> int:
    """Transferred tensor bytes (the MB/s numerator; codec/base64
    framing overhead excluded by convention)."""
    return sum(int(value.nbytes) for value in payload.values()
               if isinstance(value, np.ndarray))


def drop_one_block(payload: Dict) -> Optional[Dict]:
    """Chaos helper (the ``drop_migration_block`` fault point): trim the
    LAST block off an export payload — keys and every per-layer row
    stack — so the chain stays contiguous but arrives one block short.
    Returns ``None`` when the payload held a single block."""
    keys = list(payload.get("kv_keys", []))
    if len(keys) <= 1:
        return None
    trimmed = dict(payload)
    trimmed["kv_keys"] = keys[:-1]
    for field, value in payload.items():
        if field.startswith("kv_l") and isinstance(value, np.ndarray):
            trimmed[field] = value[:-1]
    return trimmed


# ---------------------------------------------------------------- #
# Fused staging engine.  The pool crosses the host/device boundary as
# ONE contiguous uint8 staging tensor in field-major order: for every
# layer x buffer (sorted name order within a layer), the selected
# blocks' raw bytes sit in one contiguous span, so each host-side field
# is a zero-copy ``.view(dtype)`` of its span — the JAX package's
# staging order, so the two packages' staging bytes are the same.


def _field_layout(server) -> List[tuple]:
    """Ordered staging schema: ``(field, per-row shape, dtype name,
    row_bytes)`` per layer buffer, sorted buffer name within layer."""
    layout = []
    for layer, buffers in enumerate(server.pool):
        for name in sorted(buffers):
            buf = buffers[name]
            shape = tuple(int(s) for s in buf.shape[1:])
            layout.append((f"l{layer}_{name}", shape,
                           dtype_name(buf.dtype),
                           int(np.prod(shape)) * buf.element_size()))
    return layout


def _account(server, syncs: int = 0, host_ms: float = 0.0) -> None:
    if syncs:
        server.kv_export_sync_count = \
            getattr(server, "kv_export_sync_count", 0) + syncs
    if host_ms:
        server.kv_transfer_host_ms = \
            getattr(server, "kv_transfer_host_ms", 0.0) + host_ms


def _pool_device(server) -> torch.device:
    return server.pool[0]["k"].device


def _block_ids(blocks: List[int], device: torch.device) -> torch.Tensor:
    """Block ids on ``device``; on a card through pinned memory and a
    copy queued on the stream, so the host does not wait for the chunks
    in flight (a pageable copy would).  The pinned ids are freed at once:
    the caching host allocator holds their block until the copy is
    done."""
    ids = torch.from_numpy(np.asarray(blocks, np.int64))
    if device.type != "cuda":
        return ids
    return ids.pin_memory().to(device, non_blocking=True)


def gather_block_bytes(server, blocks: List[int]):
    """Fused export gather: one ``index_select`` a layer and buffer, each
    into its slice of a single field-major staging tensor on the pool's
    device, pulled to host with ONE copy into a fresh pinned buffer and
    ONE sync.  Returns ``(staging uint8 ndarray, layout)``; the ndarray
    keeps its host buffer alive."""
    started = time.perf_counter()
    device = _pool_device(server)
    count = len(blocks)
    layout = _field_layout(server)
    total = count * sum(row_bytes for *_rest, row_bytes in layout)
    ids = _block_ids(blocks, device)
    staging = torch.empty(total, dtype=torch.uint8, device=device)
    offset = 0
    for buffers in server.pool:
        for name in sorted(buffers):
            buf = buffers[name]
            nbytes = count * buf[0].numel() * buf.element_size()
            out = staging[offset:offset + nbytes].view(buf.dtype).view(
                (count,) + tuple(buf.shape[1:]))
            torch.index_select(buf, 0, ids, out=out)
            offset += nbytes
    if device.type == "cuda":
        host = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        host.copy_(staging, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()  # the ONE sync
    else:
        host = staging
    _account(server, syncs=1,
             host_ms=(time.perf_counter() - started) * 1e3)
    return host.numpy(), layout


def _staging_views(staging: np.ndarray, layout,
                   count: int) -> Dict[str, np.ndarray]:
    """Zero-copy per-field views of a staging buffer, in the wire's
    dtypes."""
    views, offset = {}, 0
    for field, shape, name, row_bytes in layout:
        nbytes = count * row_bytes
        flat = staging[offset:offset + nbytes]
        views[field] = flat.view(wire_dtype(name)).reshape((count,) + shape)
        offset += nbytes
    return views


def gather_block_rows(server, blocks: List[int]) -> Dict[str,
                                                         np.ndarray]:
    """Host copy of the pool rows for ``blocks``: ``{"l<i>_<name>":
    (n_blocks, block_size, ...)}``, the pool bytes verbatim (bf16 as
    uint16 bit patterns, int8 with its f32 scale planes), which is what
    makes demotion → restore bit-exact.  One device program per field,
    one sync, zero-copy views of a buffer no later call reuses."""
    staging, layout = gather_block_bytes(server, blocks)
    return _staging_views(staging, layout, len(blocks))


def gather_block_rows_legacy(server, blocks: List[int]) -> Dict[
        str, np.ndarray]:
    """Per-field gather: one blocking host pull per layer x buffer.  Kept
    for the byte-identity tests — never on the serving path."""
    ids = _block_ids(blocks, _pool_device(server))
    rows = {}
    for layer, buffers in enumerate(server.pool):
        for name, buf in buffers.items():
            picked = buf.index_select(0, ids).cpu()
            if picked.dtype == torch.bfloat16:
                picked = picked.view(torch.int16)
            array = picked.numpy()
            rows[f"l{layer}_{name}"] = array.view(
                wire_dtype(dtype_name(buf.dtype)))
    return rows


def _scatter_staged(server, blocks: List[int], layout, fill) -> None:
    """Shared fused-import tail: allocate the field-major host staging,
    let ``fill(field_index, region)`` write each field's ``(count,
    row_bytes)`` rows, then ONE host→device copy and one ``index_copy_``
    a layer and buffer into the pool's existing tensors."""
    started = time.perf_counter()
    device = _pool_device(server)
    count = len(blocks)
    total = count * sum(row_bytes for *_rest, row_bytes in layout)
    cuda = device.type == "cuda"
    host = torch.empty(total, dtype=torch.uint8, pin_memory=cuda)
    staging = host.numpy()
    offset = 0
    for index, (_field, _shape, _name, row_bytes) in enumerate(layout):
        region = staging[offset:offset + count * row_bytes]
        fill(index, region.reshape(count, row_bytes))
        offset += count * row_bytes
    # The ONE upload.  ``host`` is freed on return with its copy still
    # queued: the caching host allocator holds the block until it is done.
    uploaded = host.to(device, non_blocking=True) if cuda else host
    ids = _block_ids(blocks, device)
    offset = 0
    for buffers in server.pool:
        for name in sorted(buffers):
            buf = buffers[name]
            nbytes = count * buf[0].numel() * buf.element_size()
            rows = uploaded[offset:offset + nbytes].view(buf.dtype).view(
                (count,) + tuple(buf.shape[1:]))
            buf.index_copy_(0, ids, rows)
            offset += nbytes
    _account(server, host_ms=(time.perf_counter() - started) * 1e3)


def _row_bytes_2d(array: np.ndarray) -> np.ndarray:
    """(n, ...) array → (n, row_bytes) uint8 view (copy only if the
    source is non-contiguous)."""
    return np.ascontiguousarray(array).view(np.uint8).reshape(
        array.shape[0], -1)


def scatter_block_rows(server, blocks: List[int],
                       rows: Dict[str, np.ndarray]) -> None:
    """Write stacked host rows (the :func:`gather_block_rows` layout)
    into pool ``blocks``, in place: one host staging assembly, one
    upload, one ``index_copy_`` a layer buffer.  Takes the rows' bytes
    as they are (the scatter reinterprets, never casts)."""
    count = len(blocks)
    layout = _field_layout(server)

    def fill(index, region):
        field, _shape, _name, row_bytes = layout[index]
        source = _row_bytes_2d(np.asarray(rows[field]))
        if source.shape != (count, row_bytes):
            raise ValueError(
                f"{field}: rows {source.shape} != ({count}, {row_bytes})")
        region[:] = source

    _scatter_staged(server, blocks, layout, fill)


def scatter_block_row_dicts(server, blocks: List[int],
                            row_dicts: List[Dict[str, np.ndarray]]
                            ) -> None:
    """Per-block variant of :func:`scatter_block_rows` for the
    restore/async-import landing queue: assembles the staging straight
    from each block's row dict."""
    if len(blocks) != len(row_dicts):
        raise ValueError(f"{len(blocks)} blocks, {len(row_dicts)} rows")
    layout = _field_layout(server)

    def fill(index, region):
        field, _shape, _name, row_bytes = layout[index]
        for position, row_dict in enumerate(row_dicts):
            source = np.ascontiguousarray(
                row_dict[field]).view(np.uint8).reshape(-1)
            if source.shape[0] != row_bytes:
                raise ValueError(
                    f"{field}[{position}]: {source.shape[0]} != "
                    f"{row_bytes} bytes")
            region[position] = source

    _scatter_staged(server, blocks, layout, fill)


def scatter_block_rows_legacy(server, blocks: List[int],
                              rows: Dict[str, np.ndarray]) -> None:
    """Per-field scatter: one upload and one ``index_copy_`` per layer
    buffer.  Kept for the byte-identity tests — never on the serving
    path."""
    device = _pool_device(server)
    ids = _block_ids(blocks, device)
    for layer, buffers in enumerate(server.pool):
        for name, buf in buffers.items():
            data = np.ascontiguousarray(rows[f"l{layer}_{name}"])
            value = torch.from_numpy(data.view(np.uint8).copy()).view(
                buf.dtype).view((len(blocks),) + tuple(buf.shape[1:]))
            buf.index_copy_(0, ids, value.to(device))


def export_payload(server, keys_hex: List[str], start_depth: int,
                   fused: bool = True) -> Optional[Dict]:
    """Resolve ``keys_hex`` (a contiguous chain segment starting at
    depth ``start_depth + 1``) through the owner's prefix index and
    gather the pool rows.  A key demoted to the owner's host tier is
    served straight from its host rows, and a key spilled to the owner's
    disk tier splices in through its checksum-verified read (a corrupt
    file fails the export instead of shipping bad KV).  Returns the wire
    dict, or ``None`` when the owner no longer holds a usable segment
    (evicted since it was advertised, still producing, or depth
    drifted).

    ``fused`` (default) serves the wire fields as zero-copy views of the
    one-sync staging buffer; ``fused=False`` is the per-field gather and
    per-position splice, kept for the byte-identity tests."""
    start_depth = int(start_depth)
    host_tier = getattr(server, "_host", {})
    resolved: List[bytes] = []
    sources: List = []          # int pool block | host rows dict
    for offset, hex_key in enumerate(keys_hex):
        key = server._hex_key.get(str(hex_key)[:HEX_KEY_CHARS])
        if key is None:
            break
        block = server._index.get(key)
        if block is None:
            entry = host_tier.get(key)
            if entry is None:
                spill_rows = getattr(server, "_spill_rows", None)
                rows = spill_rows(key) \
                    if spill_rows is not None else None
                if rows is None:
                    break
                source = rows
            else:
                source = entry["rows"]
        elif block in server._producing:
            break                      # content not landed yet
        else:
            source = block
        if server._depth.get(key) != start_depth + offset + 1:
            break                      # not the chain we advertised
        if server._key_seed.get(key, 0) > 0:
            break    # per-request adapter KV: replica-local, never exported
            #          (adapter WEIGHT pages do export, flagged below)
        if resolved and server._parent.get(key) != resolved[-1]:
            break                      # chain discontinuity
        if resolved and server._key_seed.get(key, 0) \
                != server._key_seed.get(resolved[0], 0):
            break                      # KV and adapter pages never mix
        resolved.append(key)
        sources.append(source)
    if not resolved:
        return None
    parent = server._parent.get(resolved[0])
    payload: Dict = {
        "kv_keys": [key.hex() for key in resolved],
        "kv_parent": parent.hex() if parent else "",
        "kv_start_depth": start_depth,
        "kv_block_size": int(server.block_size),
        "kv_sig": pool_signature(server),
        "kv_dtype": dtype_name(server.pool[0]["k"].dtype),
    }
    if server._key_seed.get(resolved[0], 0):
        payload["kv_adapter"] = 1
    layout = _field_layout(server)
    hbm = [source for source in sources if isinstance(source, int)]
    if not fused:
        gathered = gather_block_rows_legacy(server, hbm) if hbm else {}
        for field, *_rest in layout:
            stacked, cursor = [], 0
            for source in sources:
                if isinstance(source, int):
                    stacked.append(gathered[field][cursor])
                    cursor += 1
                else:
                    stacked.append(np.asarray(source[field]))
            payload[f"kv_{field}"] = np.stack(stacked)
        return payload
    views = _staging_views(*gather_block_bytes(server, hbm), len(hbm)) \
        if hbm else {}
    started = time.perf_counter()
    if len(hbm) == len(sources):
        # Pure-HBM segment (the common wire case): the payload fields
        # ARE the staging views — zero host copies past the one pull.
        for field, *_rest in layout:
            payload[f"kv_{field}"] = views[field]
    else:
        # Mixed HBM/host splice: one allocation per field, HBM positions
        # filled with one vectorised assignment, host rows copied in.
        hbm_at = np.array([position for position, source
                           in enumerate(sources)
                           if isinstance(source, int)], np.intp)
        for field, shape, name, _row_bytes in layout:
            out = np.empty((len(sources),) + shape, wire_dtype(name))
            if len(hbm_at):
                out[hbm_at] = views[field]
            for position, source in enumerate(sources):
                if not isinstance(source, int):
                    out[position] = np.asarray(source[field]).view(
                        out.dtype).reshape(shape)
            payload[f"kv_{field}"] = out
    _account(server, host_ms=(time.perf_counter() - started) * 1e3)
    return payload


def import_payload(server, payload: Dict, engine=None,
                   lease_s: float = 30.0, fused: bool = True,
                   async_import: bool = False) -> int:
    """Adopt an exported segment into ``server``'s pool + prefix index;
    returns the number of blocks imported (0 = nothing usable: layout
    mismatch, broken chain linkage, or pool too full even after
    eviction).

    Imported keys are registered ref-pinned under a
    :class:`~..runtime.lease.Lease` (released — made evictable — at
    expiry if no admission adopted them; ``engine=None`` skips the pin
    and registers them immediately evictable, the synchronous test
    mode).  ``async_import=True`` (the serving path, requires ``engine``)
    registers the keys behind the ``RESTORING`` producing sentinel and
    queues the rows to land a few blocks per engine step alongside
    host-tier restores; the lease arms when the last block lands.
    ``fused=False`` keeps the per-field scatter (synchronous only)."""
    if str(payload.get("kv_sig")) != pool_signature(server) or \
            int(payload.get("kv_block_size", -1)) != server.block_size:
        return 0
    try:
        keys = [bytes.fromhex(str(k)) for k in payload.get("kv_keys", [])]
    except ValueError:
        return 0
    if not keys or any(len(k) != 32 for k in keys):
        return 0
    start_depth = int(payload.get("kv_start_depth", 0))
    parent: Optional[bytes] = None
    if start_depth > 0:
        try:
            parent = bytes.fromhex(str(payload.get("kv_parent", "")))
        except ValueError:
            return 0
        if server._index.get(parent) is None \
                or server._depth.get(parent) != start_depth:
            return 0       # local prefix evicted since the request
    # Skip the prefix another import/admission already landed; stop at
    # any later already-present key (never re-import, never fork).
    offset = 0
    while offset < len(keys):
        key = keys[offset]
        if server._index.get(key) is None \
                or server._index[key] in server._producing:
            break
        parent = key
        offset += 1
    fresh = keys[offset:]
    for index, key in enumerate(fresh):
        if key in server._index:
            fresh = fresh[:index]
            break
    if not fresh:
        return 0
    needed = len(fresh)
    if needed > len(server._free) + len(server._evictable):
        return 0
    # Validate + slice EVERY layer's rows before touching the pool or the
    # free list: an incomplete or misshapen payload rejects with zero
    # side effects.  Slices are views of the wire arrays.
    layout = _field_layout(server)
    rows: Dict[str, np.ndarray] = {}
    for field, _shape, _name, row_bytes in layout:
        data = payload.get(f"kv_{field}")
        if data is None or data.shape[0] < offset + needed:
            return 0
        sliced = np.asarray(data)[offset:offset + needed]
        if int(sliced.nbytes) != needed * row_bytes:
            return 0               # trailing-shape/dtype mismatch
        rows[field] = sliced
    server._evict_until(needed)
    if needed > len(server._free):
        return 0
    blocks = [server._free.pop() for _ in range(needed)]
    if pool_audit.AUDITOR is not None:
        # The accountant's pool inflow for imported blocks: their tier-out
        # happened on the exporting peer, not here.
        pool_audit.AUDITOR.flow("alloc", needed,
                                needed * server._block_nbytes())
    queue_async = bool(async_import) and engine is not None \
        and hasattr(server, "_queue_import")
    if not queue_async:
        if fused:
            scatter_block_rows(server, blocks, rows)
        else:
            scatter_block_rows_legacy(server, blocks, rows)

    discard_host = getattr(server, "_host_discard", None)
    # Adapter weight pages import under their sentinel seed: the importer
    # can warm-load the adapter from them, and they keep demoting and
    # advertising as adapter pages, never as base KV.
    from .adapters import ADAPTER_SEED
    key_seed = ADAPTER_SEED if payload.get("kv_adapter") else 0
    imported: List[bytes] = []
    for index, key in enumerate(fresh):
        block = blocks[index]
        depth = start_depth + offset + index + 1
        if discard_host is not None:
            # Freshly imported content supersedes any demoted copy of
            # the same chain key (identical bytes by construction).
            discard_host(key)
        server._index[key] = block
        server._block_key[block] = key
        server._refs[block] = 1
        server._key_seed[key] = key_seed
        server._depth[key] = depth
        server._hex_key[key.hex()[:HEX_KEY_CHARS]] = key
        server._imported_keys.add(key)
        if parent is not None:
            server._parent[key] = parent
            server._children[parent] = server._children.get(parent, 0) + 1
        parent = key
        imported.append(key)

    def release(_uuid=None):
        server.digest_epoch += 1
        for key in imported:
            block = server._index.get(key)
            if block is None or server._block_key.get(block) != key:
                continue               # already purged/re-owned
            if server._refs.get(block, 0) > 0:
                server._refs[block] -= 1
                if server._refs[block] == 0:
                    server._evictable[key] = block

    label = f"kv_import:{fresh[0].hex()[:8]}"
    if queue_async:
        per_block = [{field: rows[field][index] for field, *_rest in layout}
                     for index in range(needed)]
        server._queue_import(
            list(zip(imported, blocks)), per_block,
            dict(engine=engine, lease_s=lease_s, release=release,
                 label=label))
    elif engine is not None:
        from ..runtime.lease import Lease
        Lease(lease_s, label, lease_expired_handler=release, engine=engine)
    else:
        release()
    return needed


def seed_chain(server, tokens, adapter_id: int = 0) -> int:
    """Test helper: allocate and REGISTER the shareable chain for
    ``tokens`` without prefilling (block content stays as it is), so
    transfers can be measured without a prefill first.  Never used on the
    serving path."""
    tokens = np.asarray(tokens)
    block_size = server.block_size
    n = shareable_blocks(len(tokens), block_size)
    keys = chain_keys(tokens, block_size, adapter_id)[:n]
    registered = 0
    parent = None
    discard_host = getattr(server, "_host_discard", None)
    server.digest_epoch += 1
    for position, key in enumerate(keys):
        if key in server._index:
            parent = key
            continue
        if discard_host is not None:
            discard_host(key)
        server._evict_until(1)
        if not server._free:
            break
        block = server._free.pop()
        if pool_audit.AUDITOR is not None:
            pool_audit.AUDITOR.flow("alloc", 1, server._block_nbytes())
        server._index[key] = block
        server._block_key[block] = key
        server._refs[block] = 0
        server._key_seed[key] = adapter_id
        server._depth[key] = position + 1
        server._hex_key[key.hex()[:HEX_KEY_CHARS]] = key
        if parent is not None:
            server._parent[key] = parent
            server._children[parent] = server._children.get(parent, 0) + 1
        server._evictable[key] = block
        parent = key
        registered += 1
    return registered
