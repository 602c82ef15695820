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

The pool is updated in place, and every kernel runs on PyTorch's current
stream in dispatch order, so blocks freed by a retirement can be reused by
the next admission while older chunks are still in flight.

Left out so far (they raise ``NotImplementedError``): the host and disk
KV tiers, the KV transfer export/import and prefix digests, adapters,
grammar-constrained decoding (``automata``), replica meshes and the
compilation cache; the pool auditor (the pool balance ``free + evictable +
producing == total_blocks`` at idle is kept by plain counters).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..kvstore import directory as _kvdir
from ..models import llama
from .continuous import ContinuousBatchingServer, _bucket

__all__ = ["PagedContinuousServer"]


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
                 spill_dir: Optional[str] = None,
                 draft_config_name: Optional[str] = None,
                 draft_params=None, spec_k: int = 4,
                 draft_quantize: bool = False,
                 draft_mode: str = "auto", spec_ladder=None,
                 spec_adaptive: bool = False, automata=None,
                 compilation_cache_dir: Optional[str] = None,
                 compact_upload: bool = True,
                 ring_max: Optional[int] = None, device=None):
        unsupported = [name for name, given in (
            ("host_tier_blocks", bool(host_tier_blocks)),
            ("spill_dir", spill_dir is not None)) if given]
        if unsupported:
            raise NotImplementedError(
                f"not ported yet: {', '.join(unsupported)}")
        self.block_size = int(block_size)
        self._requested_blocks = total_blocks
        self.enable_prefix_cache = enable_prefix_cache
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
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_blocks_reused = 0
        self.prefix_evictions = 0

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
            free_blocks=self.free_blocks,
            total_blocks=self.total_blocks,
            evictable_blocks=len(self._evictable),
            producing_blocks=len(self._producing),
            kv_hbm_blocks=self.total_blocks - len(self._free))
        return out

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
        parent = self._parent.pop(key, None)
        if parent is not None and parent in self._children:
            self._children[parent] -= 1
            if self._children[parent] <= 0:
                del self._children[parent]
        self._children.pop(key, None)
        self._free.append(block)

    def _evict_one(self) -> bool:
        """Evict ONE zero-ref cached block: the least recently used chain
        LEAF (no indexed children), so chains stay rooted."""
        for key, block in self._evictable.items():          # LRU order
            if self._children.get(key, 0) == 0:
                self._purge_cached(key, block)
                self.prefix_evictions += 1
                return True
        return False

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
        """Free pool blocks until ``needed`` are available."""
        want = needed - len(self._free)
        if want <= 0:
            return
        for key, block in self._select_victims(want):
            self._purge_cached(key, block)
            self.prefix_evictions += 1
        while len(self._free) < needed:    # selection fell short
            if not self._evict_one():
                break

    def _reserve_slot(self, slot: int, padded: int, request) -> bool:
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
            for key in keys:
                block = self._index.get(key)
                if block is None or block in self._producing:
                    # A miss, or a block an in-flight chunked prefill is
                    # still writing (sharing it now would read zeros).
                    break
                shared.append(block)
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
        if shared:
            self.prefix_hits += 1
            self.prefix_blocks_reused += len(shared)
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
            block = blocks[position]
            self._index[key] = block
            self._block_key[block] = key
            self._refs[block] = 1
            if position > 0:
                parent = keys[position - 1]
                self._parent[key] = parent
                self._children[parent] = self._children.get(parent, 0) + 1
        return True

    def _release_slot(self, slot: int) -> None:
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
        remaining = kv_limit - n_shared
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
    # The KV transfer wire and prefix digests wait for their slice.

    def prefix_digest(self, *args, **kwargs):
        raise NotImplementedError("not ported yet: prefix digests")

    def kv_export_payload(self, *args, **kwargs):
        raise NotImplementedError("not ported yet: KV export")

    def kv_import_payload(self, *args, **kwargs):
        raise NotImplementedError("not ported yet: KV import")
