"""Paged-KV continuous batching: the block pool, the prefix cache and
chunked admission.

Port of ``PagedContinuousServer`` (``aiko_services_tpu/orchestration/
paged.py``), a subclass of the port's
:class:`~.continuous.ContinuousBatchingServer` through its layout hooks.
All slots share one block pool (``total_blocks`` usable blocks of
``block_size`` rows per layer, plus reserved scratch block 0) and each
slot owns a block table; a request holds only the blocks its own worst
case needs.

* Allocation is worst-case reservation, preemption-free: admission
  reserves blocks for ``prompt_bucket + max_new_tokens`` rows and keeps
  them until retirement, and defers (stays queued) when the pool cannot
  cover that.
* Prefix cache (``enable_prefix_cache``): full prompt blocks are indexed
  by chained content keys (:mod:`~..kvstore.directory`); a later prompt
  with the same prefix pins the cached blocks and prefills only its tail.
  Zero-reference cached blocks stay indexed and are evicted leaf first,
  least recently used first, under pool pressure.
* Admission appends straight into the slot's block chain
  (:func:`~..models.llama.prefill_append_paged`, the ``append_kv`` and
  ``chunk_attention`` kernels on the card): no bucket cache, no gather, no
  scatter-back.  Prompts longer than ``chunk_prefill_tokens`` admit in
  power-of-two slices; while decode is live each slice rides the decode
  dispatch (:func:`~..models.llama.serve_chunk_mixed`).
* The block tables ride the resident device state and reach the device
  only through the dirty-row packet.
* Speculative decoding (``draft_config_name=`` or ``draft_mode="ngram"``,
  ``spec_k``, ``spec_adaptive``): the verify window appends straight into
  each slot's blocks at its own unaligned position
  (:func:`~..models.llama.verify_chunk_paged`, the ``append_kv_ragged``
  and ``chunk_attention`` kernels on the card).  The draft's KV lives in a
  pool of its own with the target's geometry, navigated by the TARGET's
  block tables; the worst-case reservation holds ``spec_k + 1`` rows of
  headroom, and rejected rows are a logical rollback
  (``spec_rollback_blocks``).  With speculation on, chunked-prefill slices
  always advance standalone, between rounds.

* Tiered KV cache (``host_tier_blocks > 0``): leaf-first eviction DEMOTES
  zero-ref cached blocks to host RAM (one device→host gather a victim
  batch, :mod:`~..kvstore.transfer`) instead of deleting them; the chain
  index keeps demoted chains addressable.  A prefix hit on a demoted
  chain starts an asynchronous restore: host rows land back in freshly
  allocated pool blocks a few a step (``restore_blocks_per_step``), with
  ``_producing``-style miss semantics (the ``RESTORING`` sentinel) until
  landed, so decode never stalls on a restore and never reads a
  half-landed chain.
* SSD spill tier (``spill_dir=``, ``spill_blocks``): host overflow spills
  block rows to CRC-sealed files (:mod:`~..kvstore.spill`, the JAX
  package's format byte for byte) instead of purging them, and a fresh
  server over the same directory re-adopts it: a restart is a warm
  start.  A checksum trip never serves the bytes: the chain recomputes
  and ``kv_checksum_failures`` counts it.  One eviction clock spans HBM →
  host → disk.
* The KV wire: ``prefix_digest`` (the ``kv_prefixes`` advertisement),
  ``publish_live_chain`` (a live request's chain for migration),
  ``kv_export_payload`` / ``kv_import_payload`` (the transfer RPC body,
  :mod:`~..kvstore.transfer`).

The pool is updated in place — appends, the decode write, restores and
imports alike (``index_copy_`` into the existing tensors, which the
captured chunk graphs hold) — and every kernel and copy runs on PyTorch's
current stream in dispatch order, so blocks freed by a retirement can be
reused by the next admission while older chunks are still in flight.

Left out so far (they raise ``NotImplementedError``): adapters (and with
them adapter weight pages in the pool), grammar-constrained decoding
(``automata``), replica meshes (TP pools) and the compilation cache; the
pool auditor and its tier-flow hooks (the pool balance ``free + evictable
+ producing == total_blocks`` at idle is kept by plain counters).
"""

from __future__ import annotations

import math
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..kvstore import directory as _kvdir
from ..kvstore import transfer as _kvxfer
from ..models import llama
from ..runtime.lease import Lease
from .continuous import ContinuousBatchingServer, _bucket

__all__ = ["PagedContinuousServer", "RESTORING"]

#: ``_producing`` owner sentinel for blocks whose content is an in-flight
#: host→device restore or wire import (real owners are slot ids ≥ 0, so
#: no slot's cancel/finish path can ever claim these).
RESTORING = -1


class PagedContinuousServer(ContinuousBatchingServer):
    """Continuous batching over a paged KV pool.

    ``total_blocks`` sizes the pool (excluding the scratch block); the
    default covers half of ``slots x max_seq``."""

    #: Default chunked-prefill slice width (tokens): chunked admission is
    #: the paged backend's default mode.  ``chunk_prefill_tokens=0``
    #: restores whole-bucket admission.
    DEFAULT_CHUNK_PREFILL_TOKENS = 256
    SPECULATION = True

    def __init__(self, config_name: str = "tiny", slots: int = 4,
                 max_seq: Optional[int] = None, chunk_steps: int = 8,
                 quantize: bool = False, eos_id: Optional[int] = None,
                 seed: int = 0, quantize_kv: bool = False,
                 block_size: int = 16,
                 total_blocks: Optional[int] = None,
                 enable_prefix_cache: bool = False,
                 lookahead: int = 1, adapters=None, lora_config=None,
                 params=None,
                 chunk_prefill_tokens: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 watchdog_s: float = 0.0, replica_mesh=None,
                 host_tier_blocks: Optional[int] = None,
                 restore_blocks_per_step: int = 4,
                 spill_dir: Optional[str] = None,
                 spill_blocks: Optional[int] = None,
                 draft_config_name: Optional[str] = None,
                 draft_params=None, spec_k: int = 4,
                 draft_quantize: bool = False,
                 draft_mode: str = "auto", spec_ladder=None,
                 spec_adaptive: bool = False, automata=None,
                 compilation_cache_dir: Optional[str] = None,
                 compact_upload: bool = True,
                 ring_max: Optional[int] = None, device=None):
        self.block_size = int(block_size)
        self._requested_blocks = total_blocks
        self.enable_prefix_cache = enable_prefix_cache
        #: Host-RAM demotion tier capacity in blocks (0/None disables the
        #: tier: eviction deletes).  A host block costs the same bytes as
        #: a pool block.
        self.host_tier_blocks = int(host_tier_blocks or 0)
        #: Restore upload rate: host→device blocks landed per engine step
        #: (one batched scatter).
        self.restore_blocks_per_step = max(1, int(restore_blocks_per_step))
        #: SSD spill tier directory (None disables it).
        self.spill_dir = str(spill_dir) if spill_dir else None
        #: Disk tier capacity in blocks.
        self.spill_blocks = int(spill_blocks) if spill_blocks else 1024
        if chunk_prefill_tokens is None:
            chunk_prefill_tokens = self.DEFAULT_CHUNK_PREFILL_TOKENS
        super().__init__(config_name=config_name, slots=slots,
                         max_seq=max_seq, chunk_steps=chunk_steps,
                         quantize=quantize, eos_id=eos_id, seed=seed,
                         quantize_kv=quantize_kv, lookahead=lookahead,
                         adapters=adapters, lora_config=lora_config,
                         params=params,
                         chunk_prefill_tokens=chunk_prefill_tokens,
                         max_queue=max_queue, watchdog_s=watchdog_s,
                         replica_mesh=replica_mesh,
                         draft_config_name=draft_config_name,
                         draft_params=draft_params, spec_k=spec_k,
                         draft_quantize=draft_quantize,
                         draft_mode=draft_mode, spec_ladder=spec_ladder,
                         spec_adaptive=spec_adaptive, automata=automata,
                         compilation_cache_dir=compilation_cache_dir,
                         compact_upload=compact_upload,
                         ring_max=ring_max, device=device)
        self.counters["prefill_slices_mixed"] = 0

    # ------------------------------------------------------------- #
    # Layout hooks

    def _init_layout(self) -> None:
        block_size = self.block_size
        if self.max_seq % block_size:
            raise ValueError(
                f"max_seq {self.max_seq} not a multiple of block_size "
                f"{block_size}")
        # Prompt buckets must land on block boundaries: raise the bucket
        # floor to one block and require it to be a block multiple
        # (buckets double from the floor).
        self._bucket_minimum = max(self._bucket_minimum, block_size)
        if self._bucket_minimum % block_size:
            raise ValueError(
                f"block_size {block_size} must divide the prompt bucket "
                f"floor {self._bucket_minimum}")
        # Slices append straight into block chains: every slice boundary
        # must land on a block boundary.
        if self.chunk_prefill_tokens % block_size:
            raise ValueError(
                f"chunk_prefill_tokens {self.chunk_prefill_tokens} must be a "
                f"multiple of block_size {block_size} on the paged backend "
                "(slices land on block boundaries)")
        max_blocks = self.max_seq // block_size
        if self._requested_blocks is None:
            usable = max(max_blocks, self.slots * max_blocks // 2)
        else:
            usable = int(self._requested_blocks)
        self.pool = llama.init_paged_cache(
            self.config, usable + 1, block_size,        # +1: scratch
            quantize_kv=self.quantize_kv, device=self.device)
        if self._draft is not None:
            # The draft's KV: a pool of its own with the target's geometry,
            # navigated by the TARGET's block tables (no allocator of its
            # own).  Sharing tables is safe because draft KV only moves
            # proposal quality, never committed output: prefix-shared
            # blocks get identical draft content (same tokens, same
            # prefill), and a stale row costs at most a rejected proposal.
            self._draft["pool"] = llama.init_paged_cache(
                self._draft["config"], usable + 1, block_size,
                device=self.device)
        self.tables = np.zeros((self.slots, max_blocks), np.int32)
        self.total_blocks = usable
        self._free: List[int] = list(range(1, usable + 1))
        self._owned: List[List[int]] = [[] for _ in range(self.slots)]
        # Prefix cache (content-addressed full prompt blocks):
        #   _index: chain key -> block for every cached full prompt block;
        #   _block_key / _refs: reverse map and per-block reference count;
        #   _evictable: zero-ref cached blocks in LRU order;
        #   _parent / _children: chain topology (leaf-first eviction);
        #   _pending_shared: per slot, the shared blocks staged between
        #     _reserve_slot and the prefill.
        self._index: Dict[bytes, int] = {}
        self._block_key: Dict[int, bytes] = {}
        self._refs: Dict[int, int] = {}
        self._evictable: "OrderedDict[bytes, int]" = OrderedDict()
        self._parent: Dict[bytes, bytes] = {}
        self._children: Dict[bytes, int] = {}
        self._pending_shared: List[int] = [0] * self.slots
        #: block -> slot whose chunked prefill has not yet written the
        #: block: the hit walk treats these as misses until the content
        #: lands.  Cleared at _finish_prefill; purged on cancel.
        self._producing: Dict[int, int] = {}
        # Distributed KV-cache state:
        #   _key_seed: chain key -> adapter id that seeded it (always 0
        #     on the port: no adapters);
        #   _hex_key: directory-width hex16 -> full chain key (export
        #     requests arrive with truncated keys);
        #   _depth: chain key -> position in its chain (1-based);
        #   _key_hits: chain key -> admission hit count (digest hotness);
        #   _imported_keys: keys whose content arrived by transfer — the
        #     first admission adopting one counts a remote hit.
        self._key_seed: Dict[bytes, int] = {}
        self._hex_key: Dict[str, bytes] = {}
        self._depth: Dict[bytes, int] = {}
        self._key_hits: Dict[bytes, int] = {}
        self._imported_keys: set = set()
        # Tiered KV cache (host-RAM demotion tier):
        #   _host: chain key -> {"rows": {l<i>_<name>: (block_size, ...)
        #     ndarray}, "slot", "nbytes", "clock"} for every DEMOTED
        #     block, in demotion order (leaf-first eviction demotes
        #     children before parents, so overflow popping the oldest
        #     entry drops a chain's deepest remnant first).  A key is
        #     in _index XOR _host XOR _spill.  Demoted keys keep _depth,
        #     _parent, _key_seed, _hex_key, _key_hits: the chain stays
        #     addressable.
        #   _restoring: [{"key", "block", "rows", "group", "src",
        #     "slot"}]
        #     host→device uploads waiting for _advance_restores; their
        #     blocks are allocated, indexed, ref-pinned and
        #     _producing[block] = RESTORING.  Tier restores queue with
        #     group=None; async wire imports share a group dict (lease
        #     armed when the group's last block lands).
        #   _restored_keys: landed restores not yet adopted by an
        #     admission (the first adoption counts prefix_hits_host).
        self._host: "OrderedDict[bytes, dict]" = OrderedDict()
        self._restoring: list = []
        self._restored_keys: set = set()
        # SSD spill tier: _spill: chain key -> {"nbytes", "clock"} for
        # every block whose rows live on disk, in spill order under the
        # one eviction clock; _adopted_keys: chains re-adopted from disk
        # by a warm restart and not yet promoted.
        self._spill: "OrderedDict[bytes, dict]" = OrderedDict()
        self._adopted_keys: set = set()
        self._evict_clock = 0
        #: Moves whenever what :meth:`prefix_digest` reads may have
        #: changed (admission, retirement, prefill completion, restores,
        #: imports, exports, migration): a replica recomputes its
        #: ``kv_prefixes`` advertisement only when this moved.
        self.digest_epoch = 0
        self._block_bytes_cache: Optional[int] = None
        # The host tier's RAM: one arena row a block, reserved and
        # touched here as the pool reserves HBM (rows copied into fresh
        # memory would pay a page fault a page inside the demotion), and
        # pageable (page-locked memory holds only the bytes in transit).
        # A host entry's rows view its row ("slot"), which goes back to
        # _host_free when the rows have landed, spilled or gone; with
        # every row taken (restores still in flight) an entry gets an
        # array of its own.
        self._host_arena = np.full(
            (self.host_tier_blocks, self._block_nbytes()), 0, np.uint8)
        self._host_free: List[int] = list(range(self.host_tier_blocks))
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_blocks_reused = 0
        self.prefix_evictions = 0
        self.prefix_remote_hits = 0
        self.prefix_hits_host = 0
        self.kv_transfer_bytes = 0
        self.kv_transfer_ms = 0.0
        self.kv_transfer_failures = 0
        self.kv_demotions = 0
        self.kv_restores = 0
        self.kv_host_bytes = 0
        # Fused transfer-engine counters (kvstore/transfer.py writes
        # them): device→host syncs paid by exports and demotions, host
        # staging time, and wire imports landed step-overlapped.
        self.kv_export_sync_count = 0
        self.kv_transfer_host_ms = 0.0
        self.kv_imports_async = 0
        self.kv_spills = 0
        self.kv_disk_bytes = 0
        self.kv_disk_restores = 0
        self.kv_checksum_failures = 0
        self.kv_adopted_chains = 0
        self.kv_prefetch_promotions = 0
        #: Migration resumes admitted on the source's own tail rows, and
        #: the slots among this wave's admissions that skip their prefill
        #: for it (:meth:`_adopt_migration_tail`).
        self.kv_tails_adopted = 0
        self._resumed: set = set()
        self.spill = None
        if self.spill_dir:
            from ..kvstore.spill import SpillStore
            self.spill = SpillStore(self.spill_dir,
                                    _kvxfer.pool_signature(self),
                                    self.block_size)
            self._adopt_spill()

    def _init_device_state(self):
        state = super()._init_device_state()
        # Block tables ride the resident state: admission and retirement
        # mark the slot dirty and the row merges in at the next dispatch.
        state["tables"] = self._upload(self.tables)
        return state

    def _host_state(self):
        host = super()._host_state()
        host["tables"] = self.tables
        return host

    def _graph_cache(self):
        return self.pool, True

    def _attention_blocks(self):
        # Real pool geometry: the kernel walks the slot's block table.
        return self.block_size, self.tables.shape[1]

    def _decode_attention_path(self) -> str:
        return "kernel" if self.device.type == "cuda" else "reference"

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def pool_balance(self) -> Dict[str, int]:
        """Free, evictable and producing block counts beside the pool's
        size: with no request held, ``free + evictable + producing ==
        total``."""
        return dict(free=len(self._free), evictable=len(self._evictable),
                    producing=len(self._producing), total=self.total_blocks)

    def stats(self) -> Dict:
        out = super().stats()
        out.update(
            prefix_hits=self.prefix_hits,
            prefix_misses=self.prefix_misses,
            prefix_blocks_reused=self.prefix_blocks_reused,
            prefix_evictions=self.prefix_evictions,
            prefix_remote_hits=self.prefix_remote_hits,
            kv_transfer_bytes=self.kv_transfer_bytes,
            kv_transfer_ms=round(self.kv_transfer_ms, 2),
            kv_transfer_failures=self.kv_transfer_failures,
            kv_demotions=self.kv_demotions,
            kv_restores=self.kv_restores,
            kv_host_blocks=len(self._host),
            kv_host_bytes=self.kv_host_bytes,
            restore_queue_depth=len(self._restoring),
            prefix_hits_host=self.prefix_hits_host,
            kv_export_sync_count=self.kv_export_sync_count,
            kv_transfer_host_ms=round(self.kv_transfer_host_ms, 2),
            kv_imports_async=self.kv_imports_async,
            kv_spills=self.kv_spills,
            kv_disk_blocks=len(self._spill),
            kv_disk_bytes=self.kv_disk_bytes,
            kv_disk_restores=self.kv_disk_restores,
            kv_checksum_failures=self.kv_checksum_failures,
            kv_adopted_chains=self.kv_adopted_chains,
            kv_prefetch_promotions=self.kv_prefetch_promotions,
            kv_tails_adopted=self.kv_tails_adopted,
            free_blocks=self.free_blocks,
            total_blocks=self.total_blocks,
            evictable_blocks=len(self._evictable),
            producing_blocks=len(self._producing),
            kv_hbm_blocks=self.total_blocks - len(self._free),
            kv_hbm_bytes=(self.total_blocks - len(self._free))
            * self._block_nbytes())
        return out

    def _block_nbytes(self) -> int:
        """Pool bytes one block holds across every layer field (a host or
        disk block holds the same bytes)."""
        if self._block_bytes_cache is None:
            self._block_bytes_cache = sum(
                row_bytes for *_rest, row_bytes
                in _kvxfer._field_layout(self))
        return self._block_bytes_cache

    # ------------------------------------------------------------- #
    # Admission size checks

    def _blocks_for(self, rows: int) -> int:
        return math.ceil(rows / self.block_size)

    def _spec_headroom(self) -> int:
        """Rows past the live position a verify may write: the (k+1)-token
        window lands at ``[pos, pos + k + 1)``, sized by the ladder top
        (adaptive rounds only narrow it)."""
        return self._spec["k"] + 1 if self._spec is not None else 0

    def _worst_case_blocks(self, prompt_len: int, max_new: int) -> int:
        padded = min(_bucket(prompt_len, self._bucket_minimum),
                     self.max_seq)
        return self._blocks_for(min(padded + max_new
                                    + self._spec_headroom(), self.max_seq))

    def _admission_reject(self, prompt_len: int, request):
        reason = super()._admission_reject(prompt_len, request)
        if reason:
            return reason
        # Never queue what can never run: a head request whose worst case
        # exceeds the WHOLE pool would defer forever.
        if self._worst_case_blocks(prompt_len, request.max_new_tokens) \
                > self.total_blocks:
            return "request_exceeds_pool"
        return None

    # ------------------------------------------------------------- #
    # Prefix cache

    def _chain_keys(self, prompt) -> List[bytes]:
        """Chained content keys, one per FULL prompt block, byte-identical
        to the JAX package's (:func:`~..kvstore.directory.chain_keys`)."""
        return _kvdir.chain_keys(prompt, self.block_size)

    def _shareable_blocks(self, prompt_len: int) -> int:
        """Full blocks strictly before position ``prompt_len - 1``: the
        admission seed rewrites the last prompt position's row, which must
        never land in a block other requests read."""
        return _kvdir.shareable_blocks(prompt_len, self.block_size)

    def _purge_cached(self, key, block) -> None:
        self._index.pop(key, None)
        self._evictable.pop(key, None)
        self._block_key.pop(block, None)
        self._refs.pop(block, None)
        self._key_seed.pop(key, None)
        self._depth.pop(key, None)
        self._key_hits.pop(key, None)
        self._imported_keys.discard(key)
        hex_key = key.hex()[:_kvdir.HEX_KEY_CHARS]
        if self._hex_key.get(hex_key) == key:
            del self._hex_key[hex_key]
        parent = self._parent.pop(key, None)
        if parent is not None and parent in self._children:
            self._children[parent] -= 1
            if self._children[parent] <= 0:
                del self._children[parent]
        self._children.pop(key, None)
        self._free.append(block)

    def _evict_one(self) -> bool:
        """Evict ONE zero-ref cached block: the least recently used chain
        LEAF (no indexed children), so chains stay rooted.  With a host or
        spill tier it DEMOTES instead of deleting: the rows copy down the
        tower and the chain key stays addressable."""
        for key, block in self._evictable.items():          # LRU order
            if self._children.get(key, 0) == 0:
                if self._tier_enabled():
                    self._demote(key, block)
                else:
                    self._purge_cached(key, block)
                    self.prefix_evictions += 1
                return True
        return False

    # ------------------------------------------------------------- #
    # Tiered KV cache: host-RAM demotion tier, async restore, disk spill.
    # Host-side bookkeeping around the transfer engine's gathers and
    # scatters; nothing here runs inside a chunk program.

    def _demote(self, key, block) -> None:
        """Move one zero-ref cached block's rows to the host tier and free
        its pool block (:meth:`_demote_rows`)."""
        self._demote_rows(key, block,
                          _kvxfer.gather_block_rows(self, [block]), 0)

    def _host_copy(self, rows, position):
        """Block ``position`` of a demotion gather (``rows``: views of its
        pinned staging) copied into the host tier's own memory.  Returns
        the row dict, views of that memory, and its arena row (None for
        an array of its own)."""
        slot = self._host_free.pop() if self._host_free else None
        memory = self._host_arena[slot] if slot is not None \
            else np.empty(self._block_nbytes(), np.uint8)
        row_dict, offset = {}, 0
        for field, stack in rows.items():
            value = stack[position]
            row = memory[offset:offset + value.nbytes].view(
                value.dtype).reshape(value.shape)
            row[...] = value
            row_dict[field] = row
            offset += value.nbytes
        return row_dict, slot

    def _host_release(self, entry) -> None:
        """The entry's rows are no longer read: its arena row is free."""
        slot = entry.pop("slot", None)
        if slot is not None:
            self._host_free.append(slot)

    def _tier_enabled(self) -> bool:
        """Eviction demotes (host RAM and/or disk) instead of deleting.  A
        disabled spill store (disk full, write error) with no host tier
        reverts eviction to plain deletion."""
        return self.host_tier_blocks > 0 or (
            self.spill is not None and self.spill.enabled)

    def _demote_rows(self, key, block, rows, position) -> None:
        """Block ``position`` of the demotion gather ``rows`` enters the
        host tier (:meth:`_host_copy`).  The chain identity (_depth,
        _parent, _key_seed, _hex_key, _key_hits) survives; only the pool
        binding drops.  The parent's indexed-children count decrements
        (leaf-first order then demotes the parent next), and host
        overflow spills or discards the OLDEST demotion — a chain's
        deepest remnant, so host chains stay rooted."""
        row_dict, slot = self._host_copy(rows, position)
        entry = {"rows": row_dict, "slot": slot}
        entry["nbytes"] = sum(int(r.nbytes) for r in row_dict.values())
        # One eviction clock spans the whole tower: stamped here, carried
        # into the disk header, restored by adoption.
        self._evict_clock += 1
        entry["clock"] = self._evict_clock
        self._index.pop(key, None)
        self._evictable.pop(key, None)
        self._block_key.pop(block, None)
        self._refs.pop(block, None)
        parent = self._parent.get(key)
        if parent is not None and parent in self._children:
            self._children[parent] -= 1
            if self._children[parent] <= 0:
                del self._children[parent]
        self._free.append(block)
        self._host[key] = entry
        self.kv_demotions += 1
        self.kv_host_bytes += entry["nbytes"]
        self._host_overflow()

    def _host_overflow(self) -> None:
        """Pop host-tier overflow and SPILL it to disk as one
        crash-consistent block group; entries the spill cannot take (no
        store, store disabled) purge for good.  Disk overflow then drops
        the oldest-clock remnant."""
        excess = []
        while len(self._host) > self.host_tier_blocks:
            excess.append(self._host.popitem(last=False))
        if not excess:
            return
        spilled = self._spill_entries(
            [(key, entry) for key, entry in excess
             if self.spill is not None and self.spill.enabled])
        for key, entry in excess:
            if key in spilled:
                self._spill[key] = {"nbytes": entry["nbytes"],
                                    "clock": entry.get("clock", 0)}
                self.kv_host_bytes -= entry["nbytes"]
                self.kv_spills += 1
                self.kv_disk_bytes += entry["nbytes"]
            else:
                self._purge_host_entry(key, entry)
            self._host_release(entry)
        while len(self._spill) > self.spill_blocks:
            old_key, old_meta = self._spill.popitem(last=False)
            self._purge_spill_entry(old_key, old_meta)

    def _spill_entries(self, items) -> set:
        """Write ``[(key, host_entry)]`` to the spill store as ONE block
        group; returns the keys durably on disk (empty when the store is
        off, disabled, or the write failed)."""
        if not items or self.spill is None:
            return set()
        group = []
        for key, entry in items:
            parent = self._parent.get(key)
            group.append((key.hex(), dict(
                parent=parent.hex() if parent is not None else "",
                depth=int(self._depth.get(key, 0)),
                key_seed=int(self._key_seed.get(key, 0)),
                hits=int(self._key_hits.get(key, 0)),
                clock=int(entry.get("clock", 0))), entry["rows"]))
        if not self.spill.put_group(group):
            return set()
        return {key for key, _entry in items}

    def _purge_host_entry(self, key, entry) -> None:
        """A host-tier entry leaves the cache for good (overflow with
        nowhere lower to go): its chain identity goes too."""
        self.kv_host_bytes -= entry["nbytes"]
        self.prefix_evictions += 1
        self._purge_tier_identity(key)

    def _purge_spill_entry(self, key, meta) -> None:
        """A disk-tier entry leaves the cache for good (capacity overflow
        or a failed checksum): file and chain identity both go."""
        if self.spill is not None:
            self.spill.discard(key.hex())
        self.kv_disk_bytes -= meta["nbytes"]
        self._adopted_keys.discard(key)
        self.prefix_evictions += 1
        self._purge_tier_identity(key)

    def _purge_tier_identity(self, key) -> None:
        """Drop a tier-resident key's chain identity."""
        self._depth.pop(key, None)
        self._key_seed.pop(key, None)
        self._key_hits.pop(key, None)
        self._imported_keys.discard(key)
        hex_key = key.hex()[:_kvdir.HEX_KEY_CHARS]
        if self._hex_key.get(hex_key) == key:
            del self._hex_key[hex_key]
        self._parent.pop(key, None)
        self._children.pop(key, None)

    def _host_discard(self, key) -> None:
        """Drop a host/disk copy whose key is about to re-register in the
        pool (recompute admission, import, or seed): identical bytes by
        construction, but a key must never resolve two ways.  Not an
        eviction: the content lives on in the pool."""
        entry = self._host.pop(key, None)
        if entry is not None:
            self.kv_host_bytes -= entry["nbytes"]
            self._host_release(entry)
        meta = self._spill.pop(key, None)
        if meta is not None:
            self.kv_disk_bytes -= meta["nbytes"]
            self._adopted_keys.discard(key)
            if self.spill is not None:
                self.spill.discard(key.hex())

    def _spill_rows(self, key) -> Optional[Dict]:
        """Checksum-verified rows of a spilled block in the pool's wire
        layout (bf16 as uint16 bit patterns).  Non-destructive on success
        (exports read in place).  ANY verification failure purges the
        entry and returns None: corrupt KV never leaves this method."""
        if self.spill is None or key not in self._spill:
            return None
        from ..kvstore import spill as _kvspill
        record = None
        try:
            record = self.spill.read(key.hex())
        except _kvspill.SpillCorruptionError:
            self.kv_checksum_failures += 1
        except _kvspill.SpillFormatError:
            pass
        rows = None
        if record is not None:
            rows = {}
            for field, shape, name, row_bytes in \
                    _kvxfer._field_layout(self):
                raw = record["rows"].get(field)
                if raw is None or raw.nbytes != row_bytes:
                    self.kv_checksum_failures += 1
                    rows = None
                    break
                rows[field] = raw.view(_kvxfer.wire_dtype(name)).reshape(
                    shape)
        if rows is None:
            meta = self._spill.pop(key, None)
            if meta is not None:
                self._purge_spill_entry(key, meta)
            return None
        return rows

    def _take_spill(self, key) -> Optional[Dict]:
        """Destructive verified read for a restore: the rows leave the
        disk tier.  Returns a host-entry-shaped dict, or None on a
        verification failure (the chain tail recomputes)."""
        rows = self._spill_rows(key)
        if rows is None:
            return None
        meta = self._spill.pop(key)
        self.kv_disk_bytes -= meta["nbytes"]
        self._adopted_keys.discard(key)
        self.spill.discard(key.hex())
        return {"rows": rows, "nbytes": meta["nbytes"]}

    def _adopt_spill(self) -> None:
        """Warm restart: inventory the spill directory and re-adopt every
        chain that is still ROOTED (depth 1 upward, no gaps), in the
        previous process's clock order.  Rootless files are discarded;
        corrupt files were already deleted (and counted) by the scan.
        Only base-model chains (key seed 0) adopt: adapter weight pages
        wait for adapters on the port."""
        metas, corrupt = self.spill.scan()
        self.kv_checksum_failures += corrupt
        by_hex: Dict[str, dict] = {}
        for meta in metas:
            hex_key = str(meta.get("key", ""))
            if len(hex_key) == 64 and meta.get("key_seed", 0) == 0 \
                    and int(meta.get("depth", 0)) >= 1:
                by_hex[hex_key] = meta
        adopted: Dict[str, dict] = {}
        for hex_key, meta in sorted(
                by_hex.items(), key=lambda kv: kv[1].get("depth", 0)):
            if int(meta["depth"]) == 1 \
                    or meta.get("parent", "") in adopted:
                adopted[hex_key] = meta
        for meta in metas:
            hex_key = str(meta.get("key", ""))
            if hex_key not in adopted:
                self.spill.discard(hex_key)
        for hex_key, meta in sorted(
                adopted.items(), key=lambda kv: kv[1].get("clock", 0)):
            key = bytes.fromhex(hex_key)
            depth = int(meta["depth"])
            self._depth[key] = depth
            self._key_seed[key] = 0
            self._key_hits[key] = int(meta.get("hits", 0))
            self._hex_key[hex_key[:_kvdir.HEX_KEY_CHARS]] = key
            parent_hex = meta.get("parent", "")
            if parent_hex in adopted:
                self._parent[key] = bytes.fromhex(parent_hex)
            nbytes = int(meta.get("nbytes", 0))
            self._spill[key] = {"nbytes": nbytes,
                                "clock": int(meta.get("clock", 0))}
            self.kv_disk_bytes += nbytes
            self._adopted_keys.add(key)
            self._evict_clock = max(self._evict_clock,
                                    int(meta.get("clock", 0)))
            if depth == 1:
                self.kv_adopted_chains += 1
        while len(self._spill) > self.spill_blocks:
            old_key, old_meta = self._spill.popitem(last=False)
            self._purge_spill_entry(old_key, old_meta)

    def prefetch_promote(self, prompt) -> bool:
        """Tier-aware prefetch: begin the async promotion of a
        demoted/spilled chain for ``prompt`` BEFORE its admission walk
        trips over it (the ``kv_tier_hint`` of a routed request).  Returns
        True when a restore was queued."""
        if not self.enable_prefix_cache:
            return False
        self.digest_epoch += 1
        prompt = np.asarray(prompt)
        keys = self._chain_keys(prompt)[
            :self._shareable_blocks(len(prompt))]
        shared: List[int] = []
        for key in keys:
            block = self._index.get(key)
            if block is None:
                break
            if block in self._producing:
                return False     # producing or already restoring
            shared.append(block)
        if len(shared) == len(keys):
            return False            # fully resident: nothing to do
        key = keys[len(shared)]
        if key not in self._host and key not in self._spill:
            return False            # cold continuation: recompute
        if not self._begin_restore(keys, shared):
            return False
        self.kv_prefetch_promotions += 1
        return True

    def _begin_restore(self, keys, shared) -> bool:
        """Start an asynchronous promotion of the demoted tail of ``keys``
        (everything past the ``shared`` pool prefix) back into pool
        blocks.  Each host key registers under a freshly allocated block
        with ``_producing[block] = RESTORING`` and its rows queue for
        upload (:meth:`_advance_restores`).

        Returns True when the restore was queued (the caller DEFERS the
        admission; the FIFO head retries and adopts the chain once
        landed) or False when the pool cannot hold the segment now (the
        caller admits as a plain miss and recomputes)."""
        segment = []
        for position in range(len(shared), len(keys)):
            # Pop host entries FIRST: the eviction below may demote more
            # blocks, and an overflow purge must never race away rows we
            # are about to upload.  Disk entries splice in where the host
            # runs out.
            key = keys[position]
            entry = self._host.pop(key, None)
            if entry is None:
                if key not in self._spill:
                    break
                entry = self._take_spill(key)
                if entry is None:
                    break   # checksum trip: the tail recomputes
                entry["src"] = "disk"
            segment.append((position, key, entry))
        if not segment:
            return False
        # Pin the pool prefix across the eviction (it must not demote out
        # from under the chain we are rebuilding onto it).
        for block in shared:
            self._refs[block] += 1
            self._evictable.pop(self._block_key[block], None)
        needed = len(segment)
        self._evict_until(needed)
        fits = needed <= len(self._free)
        blocks = [self._free.pop() for _ in range(needed)] if fits else []
        for block in shared:
            self._refs[block] -= 1
            if self._refs[block] == 0:
                self._evictable[self._block_key[block]] = block
        if not fits:
            for position, key, entry in segment:
                # A failed promotion re-enters the host tier WARM, with a
                # fresh clock tick.
                self._evict_clock += 1
                entry["clock"] = self._evict_clock
                self._host[key] = entry
                if entry.pop("src", None) == "disk":
                    self.kv_host_bytes += entry["nbytes"]
            self._host_overflow()
            return False
        for (position, key, entry), block in zip(segment, blocks):
            self._index[key] = block
            self._block_key[block] = key
            self._refs[block] = 1          # pinned until landed
            self._producing[block] = RESTORING
            if position > 0:
                parent = keys[position - 1]
                self._parent[key] = parent
                self._children[parent] = self._children.get(parent, 0) + 1
            src = entry.get("src")
            if src != "disk":
                self.kv_host_bytes -= entry["nbytes"]
            self._restoring.append(dict(key=key, block=block,
                                        rows=entry["rows"], group=None,
                                        src=src,
                                        slot=entry.pop("slot", None)))
        return True

    def _queue_import(self, key_blocks, per_block_rows,
                      group_info) -> None:
        """Queue an async wire import's blocks onto the restore landing
        queue (called by :func:`~..kvstore.transfer.import_payload` with
        ``async_import=True`` AFTER registering the keys ref-pinned).
        Each block gets ``_producing[block] = RESTORING`` and the segment
        shares one group dict: when its last block lands, the import
        lease arms."""
        group = dict(group_info)
        group["remaining"] = len(key_blocks)
        for (key, block), rows in zip(key_blocks, per_block_rows):
            self._producing[block] = RESTORING
            self._restoring.append(dict(key=key, block=block, rows=rows,
                                        group=group))

    def _advance_restores(self) -> None:
        """Land up to ``restore_blocks_per_step`` queued host→device
        uploads (tier restores and async wire imports share the queue) as
        ONE batched scatter into the pool's tensors, in place.  Called at
        the top of every :meth:`step`, so the upload is queued on the
        stream ahead of the chunk that follows; stream order makes the
        rows resident before any later read, so the sentinel clears at
        once — a landed key is shareable the same step, and a not yet
        landed key is still a miss."""
        if not self._restoring:
            return
        self.digest_epoch += 1
        batch = self._restoring[:self.restore_blocks_per_step]
        del self._restoring[:len(batch)]
        _kvxfer.scatter_block_row_dicts(
            self, [entry["block"] for entry in batch],
            [entry["rows"] for entry in batch])
        for entry in batch:
            self._host_release(entry)
            block = entry["block"]
            self._producing.pop(block, None)
            group = entry["group"]
            if group is None:
                # Tier restore: cached again, MRU, adoptable.
                self._refs[block] = 0
                self._evictable[entry["key"]] = block
                self._restored_keys.add(entry["key"])
                if entry.get("src") == "disk":
                    self.kv_disk_restores += 1
                else:
                    self.kv_restores += 1
                continue
            # Async wire import: the block stays ref-pinned; the lease
            # arms once the whole segment has landed.
            group["remaining"] -= 1
            if group["remaining"] == 0:
                self.kv_imports_async += 1
                Lease(group["lease_s"], group["label"],
                      lease_expired_handler=group["release"],
                      engine=group["engine"])

    def step(self):
        # Restores land BEFORE admission so a deferred head request adopts
        # freshly landed chains this very step.
        self._advance_restores()
        return super().step()

    def _select_victims(self, want: int) -> List:
        """Leaf-first LRU victims without touching the index: exactly what
        ``want`` sequential :meth:`_evict_one` calls would take."""
        victims: List = []
        taken = set()
        pending: Dict = {}
        while len(victims) < want:
            picked = None
            for key, block in self._evictable.items():   # LRU order
                if key in taken:
                    continue
                if self._children.get(key, 0) - pending.get(key, 0) == 0:
                    picked = (key, block)
                    break
            if picked is None:
                break
            victims.append(picked)
            taken.add(picked[0])
            parent = self._parent.get(picked[0])
            if parent is not None:
                pending[parent] = pending.get(parent, 0) + 1
        return victims

    def _evict_until(self, needed: int) -> None:
        """Free pool blocks until ``needed`` are available.  Demotions are
        BATCHED: victims are selected up front and their rows leave the
        device in ONE gather (one sync a batch, not one a block)."""
        want = needed - len(self._free)
        if want <= 0:
            return
        demote = []
        for key, block in self._select_victims(want):
            if self._tier_enabled():
                demote.append((key, block))
            else:
                self._purge_cached(key, block)
                self.prefix_evictions += 1
        if demote:
            rows = _kvxfer.gather_block_rows(
                self, [block for _, block in demote])
            for position, (key, block) in enumerate(demote):
                self._demote_rows(key, block, rows, position)
        while len(self._free) < needed:    # selection fell short
            if not self._evict_one():
                break

    def _reserve_slot(self, slot: int, padded: int, request) -> bool:
        self.digest_epoch += 1
        # Worst case rows: the padded prompt bucket (prefill writes all of
        # it) or prompt + every generated token, plus the verify window's
        # k + 1 rows under speculation, never more than max_seq.
        rows = min(padded + request.max_new_tokens + self._spec_headroom(),
                   self.max_seq)
        needed = self._blocks_for(rows)
        prompt = np.asarray(request.prompt)
        shared: List[int] = []
        keys: List[bytes] = []
        if self.enable_prefix_cache:
            keys = self._chain_keys(prompt)[
                :self._shareable_blocks(len(prompt))]
            restore_host = restore_wait = False
            for key in keys:
                block = self._index.get(key)
                if block is None:
                    # A demoted continuation: restore it instead of
                    # recomputing what a lower tier still holds.
                    restore_host = key in self._host or key in self._spill
                    break
                if block in self._producing:
                    # A block an in-flight chunked prefill is still
                    # writing is a miss (sharing it now would read zeros).
                    # A RESTORING block is this chain's own promotion or
                    # import still landing: WAIT for it.
                    restore_wait = self._producing[block] == RESTORING
                    break
                shared.append(block)
            if restore_wait:
                return False       # defer: the restore lands next steps
            if restore_host and self._begin_restore(keys, shared):
                # Defer WITHOUT pinning anything: the queue head retries
                # each step and adopts the chain once landed.
                return False
        # PIN the hits before any eviction, with rollback on deferral that
        # restores each block's ORIGINAL LRU position.
        evictable_snapshot = list(self._evictable.items())
        for block in shared:
            self._refs[block] += 1
            self._evictable.pop(self._block_key[block], None)
        private_needed = needed - len(shared)
        if private_needed > len(self._free) + len(self._evictable):
            # Cannot admit even after a full cache flush: defer WITHOUT
            # destroying cached prefixes for zero benefit.
            for block in shared:
                self._refs[block] -= 1
            self._evictable.clear()
            self._evictable.update(
                (key, block) for key, block in evictable_snapshot
                if self._refs[block] == 0)
            return False
        self._evict_until(private_needed)
        private = [self._free.pop() for _ in range(private_needed)]
        blocks = shared + private
        self._owned[slot] = blocks
        self._pending_shared[slot] = len(shared)
        row = np.zeros(self.tables.shape[1], np.int32)
        row[:needed] = blocks
        self.tables[slot] = row
        self._adopt_migration_tail(slot, request, shared, keys, blocks)
        if shared:
            self.prefix_hits += 1
            self.prefix_blocks_reused += len(shared)
            adopted = [key for key in keys[:len(shared)]
                       if key in self._imported_keys]
            if adopted:
                # First local use of peer-transferred blocks.
                self.prefix_remote_hits += 1
                self._imported_keys.difference_update(adopted)
            restored = [key for key in keys[:len(shared)]
                        if key in self._restored_keys]
            if restored:
                # First adoption of blocks back from the host/disk tier.
                self.prefix_hits_host += 1
                self._restored_keys.difference_update(restored)
            for key in keys[:len(shared)]:
                self._key_hits[key] = self._key_hits.get(key, 0) + 1
        elif keys:
            self.prefix_misses += 1
        # Register this prompt's remaining shareable blocks.  A later
        # request of the same admission wave may pin them before they are
        # written: _prefill_and_insert runs producers before readers.
        # Keys already indexed are skipped (an overwrite would strand the
        # old block in _evictable under a reused key).
        for position in range(len(shared), len(keys)):
            key = keys[position]
            if key in self._index:
                continue
            # Recomputing a chain a lower tier still holds (the restore
            # could not fit): the fresh registration supersedes it.
            self._host_discard(key)
            block = blocks[position]
            self._index[key] = block
            self._block_key[block] = key
            self._refs[block] = 1
            self._key_seed[key] = 0
            self._depth[key] = position + 1
            self._hex_key[key.hex()[:_kvdir.HEX_KEY_CHARS]] = key
            if position > 0:
                parent = keys[position - 1]
                self._parent[key] = parent
                self._children[parent] = self._children.get(parent, 0) + 1
        return True

    def _adopt_migration_tail(self, slot: int, request, shared, keys,
                              blocks) -> None:
        """A live migration's resume carries the source's rows past the
        chain's last full block (``request.kv_tail``).  When every full
        block is here too, those rows land in the slot's first private
        block and the admission skips its prefill: the seed then decodes
        the chain's last token on exactly the cache the source had, so
        the resume's stream is the source's bit for bit (a recompute of
        the tail runs the chunk kernels where the source ran the decode
        kernels, and rounds differently).  Otherwise the tail recomputes
        as any admission does."""
        tail = getattr(request, "kv_tail", None)
        if tail is None:
            return
        request.kv_tail = None
        prompt_len = int(np.asarray(request.prompt).shape[0])
        full = self._shareable_blocks(prompt_len)
        if len(keys) != full or len(shared) != full \
                or tail["length"] != (prompt_len - 1) % self.block_size:
            return
        if tail["length"]:
            _kvxfer.scatter_block_rows(self, [blocks[full]], tail["rows"])
        self._resumed.add(slot)
        self.kv_tails_adopted += 1

    def migration_tail_rows(self, request, rows: int) -> Optional[Dict]:
        """Live-migration source: the pool rows of ``request``'s chain
        from its last full block below position ``rows`` up to ``rows``
        (exclusive), as this server wrote them — ``{"kv_tail_len": n,
        "kv_tail_<field>": (1, block_size, ...)}`` plus the pool's
        signature, the field arrays left out when n is 0.  ``rows`` is
        the resume's prompt length less one; its positions are written
        once the request committed that many tokens.  None when the
        request holds no slot here or is still prefilling."""
        try:
            slot = self._requests.index(request)
        except ValueError:
            return None
        if slot in self._prefilling:
            return None
        length = int(rows) % self.block_size
        tail: Dict = {"kv_tail_len": length,
                      "kv_sig": _kvxfer.pool_signature(self),
                      "kv_block_size": self.block_size}
        if length:
            block = self._owned[slot][int(rows) // self.block_size]
            for field, value in _kvxfer.gather_block_rows(
                    self, [block]).items():
                tail[f"kv_tail_{field}"] = value
        return tail

    def migration_tail_from_payload(self, payload: Dict) -> Optional[Dict]:
        """The ``request.kv_tail`` of a resume from a source's export
        answer (:meth:`migration_tail_rows`), or None when the answer
        holds no tail or one of another pool layout."""
        if "kv_tail_len" not in payload \
                or str(payload.get("kv_sig")) != \
                _kvxfer.pool_signature(self) \
                or int(np.asarray(payload.get("kv_block_size", -1))) \
                != self.block_size:
            return None
        length = int(np.asarray(payload["kv_tail_len"]))
        rows = {}
        if length:
            for field, *_rest in _kvxfer._field_layout(self):
                value = payload.get(f"kv_tail_{field}")
                if value is None:
                    return None
                rows[field] = np.asarray(value)
        return dict(length=length, rows=rows)

    def _release_slot(self, slot: int) -> None:
        self.digest_epoch += 1
        self._resumed.discard(slot)
        for block in self._owned[slot]:
            if self._producing.pop(block, None) == slot:
                # Cancelled mid-prefill: the block's key points at content
                # that never fully landed; purge it (purge frees it).
                key = self._block_key.get(block)
                if key is not None:
                    self._purge_cached(key, block)
                else:
                    self._free.append(block)
                continue
            key = self._block_key.get(block)
            if key is None:
                self._free.append(block)        # plain private block
                continue
            self._refs[block] -= 1
            if self._refs[block] == 0:
                # Stays cached and findable, evictable under pressure.
                self._evictable[key] = block
        self._owned[slot] = []
        self._pending_shared[slot] = 0
        self.tables[slot] = 0

    # ------------------------------------------------------------- #
    # Admission: append attention into the block chain

    def _tables_row(self, slot: int):
        return self._upload(self.tables[slot:slot + 1])

    def _prefill_and_insert(self, admissions) -> None:
        """Each request's prompt K/V lands in its own blocks and shared
        prefix blocks are only read.  Requests whose shared prefix holds
        blocks another admission of this wave writes run after their
        producer (admission order kept); the rest run first."""
        produced = {}       # block -> wave index that writes it here
        plans = []
        for index, (slot, request, prompt_padded, _) \
                in enumerate(admissions):
            n_shared = self._pending_shared[slot]
            n_total = prompt_padded.shape[1] // self.block_size
            for block in self._owned[slot][n_shared:n_total]:
                produced[block] = index
            plans.append((slot, prompt_padded, n_shared))
        independent, dependent = [], []
        for index, plan in enumerate(plans):
            slot, _, n_shared = plan
            deps = {produced[block] for block in self._owned[slot][:n_shared]
                    if block in produced and produced[block] != index}
            (dependent if deps else independent).append((index, plan, deps))
        ran = set()
        for index, plan, deps in independent + dependent:
            assert deps <= ran, (
                "shared-prefix overlap requires the producing admission "
                f"{sorted(deps - ran)} to prefill before wave index {index}")
            self._append_prefill(*plan)
            ran.add(index)

    def _append_prefill(self, slot: int, prompt_padded,
                        n_shared: int) -> None:
        """Prefill one admitted prompt past its shared prefix, the
        uncached tail in descending power-of-two pieces (log-many shapes
        per bucket)."""
        self._pending_shared[slot] = 0
        block_size = self.block_size
        kv_limit = prompt_padded.shape[1] // block_size
        tables_row = self._tables_row(slot)
        start = n_shared * block_size
        # A migration resume on the source's tail has nothing to prefill.
        remaining = 0 if slot in self._resumed else kv_limit - n_shared
        self._resumed.discard(slot)
        while remaining > 0:
            size = 1 << (remaining.bit_length() - 1)
            width = size * block_size
            llama.prefill_append_paged(
                self.params, self._upload(prompt_padded[:, start:start + width]),
                self.pool, tables_row, start, self.config,
                kv_limit=kv_limit, compute_logits=False)
            self._note_prefill(width)
            start += width
            remaining -= size
        if self._draft is not None:
            # The draft has no prefix cache: it always prefills the whole
            # padded prompt, whatever the target reused.
            self._prefill_draft_rows([slot], prompt_padded)

    def _begin_chunked_prefill(self, slot: int, request, prompt_padded,
                               prompt_len: int) -> None:
        """Chunked admission appends into the slot's block chain; a prefix
        hit skips its shared blocks.  Blocks this slot produces are marked
        in flight so later hit walks treat them as misses until the
        content lands.  The slot is marked dirty so its table row is
        resident before the first mixed dispatch reads it."""
        self.digest_epoch += 1
        if slot in self._resumed:
            # A migration resume on the source's tail: nothing to prefill.
            self._resumed.discard(slot)
            self._pending_shared[slot] = 0
            self._prefilling[slot] = state = dict(
                request=request, prompt_padded=prompt_padded,
                prompt_len=prompt_len)
            self._finish_prefill(slot, state)
            return
        n_shared = self._pending_shared[slot]
        self._pending_shared[slot] = 0
        n_total = prompt_padded.shape[1] // self.block_size
        for block in self._owned[slot][n_shared:n_total]:
            if block in self._block_key:
                self._producing[block] = slot
        self._dirty[slot] = True
        self._prefilling[slot] = dict(
            request=request, prompt_padded=prompt_padded,
            prompt_len=prompt_len, start=n_shared * self.block_size,
            kv_limit=prompt_padded.shape[1] // self.block_size)

    def _next_slice_width(self, prefill) -> int:
        """The largest power-of-two block count that fits both the
        remaining prompt and the configured chunk width."""
        block_size = self.block_size
        remaining = (prefill["prompt_padded"].shape[1]
                     - prefill["start"]) // block_size
        cap = self.chunk_prefill_tokens // block_size
        return min(cap, 1 << (remaining.bit_length() - 1)) * block_size

    def _advance_prefills(self) -> None:
        """With live decode work the slices ride the mixed dispatch
        (:meth:`_serve_chunk`); only when no decode can be scheduled does
        each prefilling slot run one standalone slice per step.  A
        speculative round never runs the mixed step (the verify is its own
        call), so with speculation on the slices always advance
        standalone, one per prefilling slot per step."""
        if not self._prefilling:
            return
        if self._spec is None and (self._plan_remaining() > 0).any():
            return
        for slot in list(self._prefilling):
            state = self._prefilling[slot]
            start = state["start"]
            width = self._next_slice_width(state)
            llama.prefill_append_paged(
                self.params,
                self._upload(state["prompt_padded"][:, start:start + width]),
                self.pool, self._tables_row(slot), start, self.config,
                kv_limit=state["kv_limit"], compute_logits=False)
            state["start"] = start + width
            self._note_prefill(width)
            if state["start"] >= state["prompt_len"]:
                self._finish_prefill(slot, state)

    def _finish_prefill(self, slot: int, state) -> None:
        # The chain's content is complete: its blocks become shareable.
        self.digest_epoch += 1
        for block, owner in list(self._producing.items()):
            if owner == slot:
                del self._producing[block]
        super()._finish_prefill(slot, state)

    def warm_prefill_ladder(self, buckets=None) -> int:
        """Run every pow2 slice width up to ``chunk_prefill_tokens`` for
        every prompt bucket's ``kv_limit`` once against the scratch block
        (a zero table row), so the first long admission finds the card's
        libraries and allocator warm.  Returns the dispatches run."""
        if self.slots_active or self._ring or self._prefilling:
            raise RuntimeError(
                "warm_prefill_ladder must run on an idle engine")
        if not self.chunk_prefill_tokens:
            return 0
        if buckets is None:
            buckets, bucket = [], self._bucket_minimum
            while bucket <= self.max_seq:
                buckets.append(bucket)
                bucket *= 2
        tables_row = self._upload(np.zeros((1, self.tables.shape[1]),
                                           np.int32))
        dispatched = 0
        for bucket in buckets:
            width = self.block_size
            while width <= min(self.chunk_prefill_tokens, bucket):
                llama.prefill_append_paged(
                    self.params, self._upload(np.zeros((1, width), np.int32)),
                    self.pool, tables_row, 0, self.config,
                    kv_limit=bucket // self.block_size, compute_logits=False)
                dispatched += 1
                width *= 2
        return dispatched

    def _serve_chunk(self, state, steps: int, eos_id: int, sampled: bool):
        """Decode dispatch, MIXED while a chunked admission is in flight:
        the oldest prefilling slot's next slice and the decode chunk run
        in one call (:func:`~..models.llama.serve_chunk_mixed`)."""
        generator = self._generator if sampled else None
        slot = next(iter(self._prefilling), None)
        if slot is None:
            tokens_d, counts_d, new_state, self.pool = \
                llama.serve_chunk_paged(
                    self.params, state, self.pool, steps, self.config,
                    eos_id=eos_id, sampled=sampled, generator=generator)
            return tokens_d, counts_d, new_state
        prefill = self._prefilling[slot]
        start = prefill["start"]
        width = self._next_slice_width(prefill)
        tokens_d, counts_d, new_state, self.pool = llama.serve_chunk_mixed(
            self.params, state, self.pool,
            self._upload(prefill["prompt_padded"][:, start:start + width]),
            slot, start, steps, self.config, eos_id=eos_id, sampled=sampled,
            generator=generator, prefill_kv_limit=prefill["kv_limit"])
        prefill["start"] = start + width
        self._note_prefill(width)
        self.counters["prefill_slices_mixed"] += 1
        if prefill["start"] >= prefill["prompt_len"]:
            self._finish_prefill(slot, prefill)
        return tokens_d, counts_d, new_state

    # ------------------------------------------------------------- #
    # Speculative decoding on the paged layout

    def _spec_verify(self, st, chunk):
        """Pool-direct verify: the (slots, k+1) window's K/V append straight
        into each slot's table-resolved blocks at its own position, and the
        logits come back for the acceptance kernel.  Inactive rows (chunked
        prefills in flight, free slots) write nothing."""
        logits, self.pool = llama.verify_chunk_paged(
            self.params, chunk, self.pool, st["tables"], st["positions"],
            st["active"], self.config)
        return logits

    def _note_spec_rollback(self, slot: int, advance: int,
                            width: int) -> None:
        """Count the blocks a verify window touched BEYOND the committed
        frontier: rows ``[pos + advance, pos + width)`` hold rejected
        speculation.  The rollback is logical, not a free: the worst-case
        reservation owns these blocks for the request's own later tokens,
        the stale rows are unattendable and rewritten before they become
        reachable, and none is ever indexed by the prefix cache (only full
        blocks strictly before ``prompt_len - 1`` are)."""
        pos = int(self.positions[slot])       # pre-advance mirror
        last_written = (pos + width - 1) // self.block_size
        last_committed = (pos + advance - 1) // self.block_size
        self.spec_stats.rollback_blocks += max(0,
                                               last_written - last_committed)

    def _prefill_draft_rows(self, slots_list, prompts) -> None:
        """Draft admission: prefill the whole padded prompt into a
        batch-sized contiguous cache (``flash_attention`` on the card),
        then copy each row into its slot's target-table-resolved draft-pool
        blocks.  Prompt buckets are block multiples, so the copy is
        exact."""
        draft = self._draft
        bucket = llama.init_cache(draft["config"], len(slots_list),
                                  prompts.shape[1], device=self.device)
        _, bucket = llama.prefill(draft["params"], self._upload(prompts),
                                  bucket, draft["config"])
        tables = self._upload(self.tables)
        for index, slot in enumerate(slots_list):
            row = [{key: buf[index:index + 1] for key, buf in layer.items()}
                   for layer in bucket]
            llama.paged_insert_prefix(draft["pool"], tables, row, slot)

    def _draft_propose(self, st, k: int, sampled: bool):
        """The draft proposes ``k`` tokens per slot: ``decode_chunk_paged``
        over its pool through the target's resident block tables.  Returns
        ``(proposals (slots, k), draft logits (slots, k, vocab) or None)``;
        the logits only for sampled acceptance."""
        draft = self._draft
        if sampled:
            proposals, draft_logits, _, _, draft["pool"] = \
                llama.decode_chunk_paged(
                    draft["params"], st["token"], draft["pool"],
                    st["tables"], st["positions"], st["active"], k,
                    draft["config"], temperatures=st["temps"],
                    top_ps=st["tops"], generator=self._generator,
                    return_logits=True)
            return proposals, draft_logits
        proposals, _, _, draft["pool"] = llama.decode_chunk_paged(
            draft["params"], st["token"], draft["pool"], st["tables"],
            st["positions"], st["active"], k, draft["config"])
        return proposals, None

    def _draft_resync(self, st, resync, prev_positions, prev_active) -> None:
        """Replay the committed window minus its last token through the
        draft, so its KV matches the target's history before the next
        round (zero-padded rows land past the frontier, stale until
        rewritten)."""
        draft = self._draft
        _, draft["pool"] = llama.verify_chunk_paged(
            draft["params"], resync, draft["pool"], st["tables"],
            prev_positions + 1, prev_active, draft["config"])

    # ------------------------------------------------------------- #
    # The distributed KV cache's server side: digests, live chains and
    # the transfer RPC body.  Host-side; the gathers and scatters run on
    # the pool's device through kvstore/transfer.py.

    def prefix_digest(self, role: str = "decode", max_entries: int = 64,
                      migrating: bool = False) -> str:
        """Compact advertisement of this replica's cached prefix blocks
        for the cluster directory (the ``kv_prefixes`` share value):
        content-complete (not producing) base-model chains, hottest +
        deepest first, capped at ``max_entries``.  Host-tier entries
        advertise ``tier=1``, spilled ones ``tier=2`` (plus the adopted
        flag for warm-restart survivors)."""
        entries = []

        def _entry(key, refs, tier, adopted=0):
            if self._key_seed.get(key, 0) != 0:
                return           # adapter chains never leave the replica
            entries.append((key.hex()[:_kvdir.HEX_KEY_CHARS],
                            self._depth.get(key, 0), refs,
                            self._key_hits.get(key, 0), tier, adopted, 0,
                            0))

        for key, block in self._index.items():
            if block in self._producing:
                continue
            _entry(key, self._refs.get(block, 0), 0)
        for key in self._host:
            _entry(key, 0, 1)
        for key in self._spill:
            _entry(key, 0, 2, 1 if key in self._adopted_keys else 0)
        entries.sort(key=lambda e: (-e[3], -e[1], e[0]))
        return _kvdir.digest_encode(self.block_size, role,
                                    entries[:max_entries],
                                    migrating=int(migrating))

    def publish_live_chain(self, request) -> int:
        """Live-migration prepare: register a HELD request's chain —
        prompt plus every committed generated token, bounded by
        ``_shareable_blocks`` so the decode frontier's rewritten row never
        ships — in the prefix index, making it resolvable by ``kv_export``
        like a retired chain.  Returns the number of exportable blocks (0
        = nothing shippable: cache off or a chain shorter than one
        block).  Registered blocks carry the slot's ref like any
        admission-registered key, so ``_release_slot`` at the request's
        retirement leaves them cached-evictable."""
        if not self.enable_prefix_cache:
            return 0
        self.digest_epoch += 1
        # Settle the in-flight ring so ``request.tokens`` (and the pool
        # rows behind it) are final before we advertise them.
        self._drain_ring()
        try:
            slot = self._requests.index(request)
        except ValueError:
            return 0        # finished while the ring drained
        full = np.concatenate(
            [np.asarray(request.prompt, np.int32).reshape(-1),
             np.asarray(request.tokens or [], np.int32)])
        keys = self._chain_keys(full)[:self._shareable_blocks(len(full))]
        owned = self._owned[slot]
        total = 0
        for position, key in enumerate(keys):
            existing = self._index.get(key)
            if existing is not None:
                if existing in self._producing:
                    break          # not content-complete yet
                total = position + 1
                continue           # already advertised (shared chain)
            if position >= len(owned):
                break
            block = owned[position]
            if block in self._producing:
                break
            self._host_discard(key)
            self._index[key] = block
            self._block_key[block] = key
            self._refs[block] = 1
            self._key_seed[key] = 0
            self._depth[key] = position + 1
            self._hex_key[key.hex()[:_kvdir.HEX_KEY_CHARS]] = key
            if position > 0:
                parent = keys[position - 1]
                self._parent[key] = parent
                self._children[parent] = self._children.get(parent, 0) + 1
            total = position + 1
        return total

    def prefix_keys_hex(self, prompt) -> List[str]:
        """Directory-width keys for a prompt's shareable blocks (base
        model: the only chains that cross replicas)."""
        return _kvdir.chain_keys_hex(prompt, self.block_size)

    def prefix_local_depth(self, prompt) -> int:
        """Longest locally cached, content-complete prefix of ``prompt``
        in blocks — what a warm-start fetch may SKIP requesting from the
        owner.  Host-tier and spilled blocks count as local: a restore
        beats a wire transfer of the same bytes."""
        prompt = np.asarray(prompt)
        depth = 0
        for key in self._chain_keys(prompt)[
                :self._shareable_blocks(len(prompt))]:
            block = self._index.get(key)
            if block is None:
                if key not in self._host and key not in self._spill:
                    break
            elif block in self._producing:
                break
            depth += 1
        return depth

    def kv_export_payload(self, keys_hex: List[str],
                          start_depth: int) -> Optional[Dict]:
        """Serve one export RPC: gather the requested chain segment's pool
        rows host-side.  Returns the wire dict or ``None`` (the segment is
        gone: the caller answers with an error and the importer
        recomputes)."""
        started = time.perf_counter()
        self.digest_epoch += 1       # a corrupt spill file purges
        payload = _kvxfer.export_payload(self, keys_hex, start_depth)
        if payload is None:
            self.kv_transfer_failures += 1
            return None
        self.kv_transfer_bytes += _kvxfer.payload_bytes(payload)
        self.kv_transfer_ms += (time.perf_counter() - started) * 1e3
        return payload

    def kv_import_payload(self, payload: Dict, engine=None,
                          lease_s: float = 30.0,
                          async_import: bool = False) -> int:
        """Adopt an exported segment into this pool under a lease; returns
        blocks imported (0 counts as a transfer failure: the caller falls
        back to local prefill).  ``async_import=True`` (the serving path)
        registers the keys behind the ``RESTORING`` sentinel and lands the
        rows a few blocks per step (:func:`~..kvstore.transfer
        .import_payload`)."""
        started = time.perf_counter()
        self.digest_epoch += 1
        imported = _kvxfer.import_payload(self, payload, engine=engine,
                                          lease_s=lease_s,
                                          async_import=async_import)
        if imported:
            self.kv_transfer_bytes += _kvxfer.payload_bytes(payload)
            self.kv_transfer_ms += (time.perf_counter() - started) * 1e3
        else:
            self.kv_transfer_failures += 1
        return imported
