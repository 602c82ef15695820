"""Continuous batching: slot-based LLM decode serving in PyTorch.

Port of ``ContinuousBatchingServer`` (``aiko_services_tpu/orchestration/
continuous.py``) with its host protocol: the server owns ``slots`` decode
lanes and a ``(slots, max_seq, ...)`` KV cache; a request is one slot for
its lifetime.

* Admission: prompts are right-padded to a power-of-2 bucket and each
  admission wave prefills per-bucket groups in power-of-2 sub-batches
  (causal attention keeps every row exact whatever its batch-mates),
  landing each sub-batch's KV rows in its slots with one batched copy.
  The slot is seeded with the LAST prompt token at ``prompt_len - 1``:
  the first decode step rewrites that row with identical values and
  emits the first generated token.
* Decode: :func:`~..models.llama.serve_chunk_ragged` runs ``steps``
  device-resident steps for ALL slots: per-slot state (token tail,
  positions, active, remaining budget, sampling controls) lives on the
  device and EOS/budget retirement happens there.  Host mirrors reach the
  device only through :meth:`_sync_dirty`, a compact scatter of the rows
  an admission, retirement or sampling edit touched.  On the card a greedy
  chunk with no admission slice replays a captured CUDA graph
  (:class:`~..models.llama.ChunkGraph`, one a key, the first chunk of a
  key its eager warm-up) over static state buffers, which the dirty-row
  merge updates in place and which are refilled on the device after an
  eager round (a speculation round, a mixed step, a sampled chunk);
  ``graph_ledger`` counts captures and replays for :meth:`stats`.
* In-flight ring: each dispatched chunk queues a non-blocking copy of its
  tiny ``(tokens_out, counts, active)`` result into pinned host memory
  and an event; :meth:`_consume_ready` waits on that event, the ONLY
  host sync of the serving loop, and applies the results (deliver,
  advance mirrors, retire).  The ring depth adapts between ``ring_min``
  and ``ring_max`` (:meth:`_ring_policy`).
* Speculative decoding (:meth:`_dispatch_spec_round`): a proposer fills
  each live slot's ``k``-token window (a draft model, or n-gram lookup in
  the slot's own history), one target verify pass scores it, the
  acceptance kernel (greedy, or modified rejection sampling for sampled
  slots; per-slot caps from the adaptive
  :class:`~.spec_control.SpecController`) picks each slot's committed
  prefix, and :func:`~..models.speculative.spec_commit` advances the
  resident state.  Rounds ride the same ring as chunks.  The verify,
  the draft's cache and the rollback accounting are layout hooks that
  only the paged server supplies (``_spec_verify``, ``_draft_propose``,
  ``_draft_resync``, ``_prefill_draft_rows``, ``_note_spec_rollback``).

Greedy decode through this path matches per-request ``prefill`` +
``generate_tokens`` output whatever the admission order, with or without
speculation.

Layout hooks (``_init_layout``, ``_attention_blocks``, ``_reserve_slot``,
``_release_slot``, ``_prefill_and_insert``, ``_begin_chunked_prefill``,
``_advance_prefills``, ``_finish_prefill``, ``_serve_chunk``) are where the
paged server (:mod:`.paged`) plugs in its block pool, as in the JAX
package.

Robustness as in the reference: a bounded queue sheds with
``error="overloaded"`` and a retry-after hint; deadlines reject at
admission and evict live slots; the watchdog (``watchdog_s``) arms an
alarm thread around the ring sync, which flips ``healthy`` while the
event wait still blocks, and a sync past the threshold fails every queued
and live request with the retriable ``error="watchdog_stalled"`` and
refuses later submits.  The ``stall_step`` fault site
(:mod:`~..runtime.faults`) sits in front of that sync.  Per-phase latency
histograms (``latency_hists``) and the step log
(:mod:`~..obs.steplog`, off unless a recorder is installed) follow the
reference's sites.

:class:`ContinuousReplica` is the actor that serves a server over the
wire: ``(infer …)`` in, ``(infer_partial …)`` / ``(infer_response …)``
out (:mod:`~..runtime`, :mod:`~..transport`, :mod:`.client`).

Left out so far (they raise ``NotImplementedError``): meshes, LoRA
adapters, grammars, speculation and chunked prefill on the contiguous
layout (they need ``llama.verify_chunk_ragged`` and ``llama.prefill_chunk``;
the paged server has its own), the compilation cache and the legacy
full-mirror upload; the on-demand device profiler.  On the wire, the KV
transfer (``kv_export``, warm starts from a ``kv_source``) and live
migration answer as the reference does for a server without them.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models import llama
from ..models.speculative import (SpecStats, delta_draft_logits,
                                  greedy_accept_batch, mrs_accept_batch,
                                  ngram_propose, spec_commit)
from ..obs import flight, steplog, trace
from ..obs.compiles import CaptureLedger
from ..obs.metrics import REGISTRY, CounterDict, Histogram
from ..ops.paged_attention import contiguous_block_size
from ..runtime import faults
from ..runtime.actor import Actor
from ..utils.sexpr import generate, parse
from .spec_control import SpecController, default_ladder, validate_ladder

__all__ = ["ContinuousBatchingServer", "ContinuousReplica",
           "DecodeRequest"]

#: Distinct ``instance=`` metric label per server in this process.
_SERVER_INSTANCE_IDS = itertools.count()


@dataclasses.dataclass
class DecodeRequest:
    request_id: str
    prompt: "np.ndarray"           # (prompt_len,) int32
    max_new_tokens: int
    response_topic: Optional[str] = None
    #: 0 = greedy (exact, default); > 0 samples with optional nucleus.
    temperature: float = 0.0
    top_p: float = 1.0
    #: Deliver partial tokens as chunks complete (used by the replica).
    stream: bool = False
    #: Named LoRA adapter / grammar: not ported, so any name is rejected.
    adapter: Optional[str] = None
    automaton: Optional[str] = None
    #: Absolute host-monotonic deadline; expired requests are rejected at
    #: admission and evicted from their slot (``deadline_exceeded``).
    deadline_ts: Optional[float] = None
    # Filled by the server:
    tokens: Optional[List[int]] = None
    error: Optional[str] = None
    #: Back-off hint attached to an ``error="overloaded"`` shed.
    retry_after_ms: Optional[int] = None
    #: Host-monotonic stamps: TTFT is measured at the host sync that
    #: DELIVERS the first token.
    submitted_ts: Optional[float] = None
    activated_ts: Optional[float] = None
    first_token_ts: Optional[float] = None
    finished_ts: Optional[float] = None
    #: Speculative serving: proposals accepted in each of the request's
    #: rounds (each in [0, k]).
    spec_accepted_rounds: Optional[List[int]] = None
    #: Milliseconds spent restoring this request's prefix KV from a
    #: remote replica (0 when no kv_source hint / local hit).
    kv_restore_ms: float = 0.0
    #: Propagated trace context (``trace_id/span_id`` wire form): the
    #: replica synthesizes phase spans under it at response time.
    trace_ctx: Optional[str] = None
    #: Encoded spans fetched alongside a remote KV restore (the
    #: source's ``kv_export`` span), merged into the response tree.
    remote_spans: Optional[str] = None
    #: A live migration's resume: the source's pool rows past the chain's
    #: last full block (``{"length": rows, "rows": {field: (1, ...)}}``),
    #: which the paged admission lands instead of recomputing them.
    kv_tail: Optional[Dict] = None


def _bucket(n: int, minimum: int = 16) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


class ContinuousBatchingServer:
    """Slot-based continuous batching around a Llama-family model."""

    #: Whether this layout supplies the speculation hooks (the paged
    #: server does).
    SPECULATION = False

    def __init__(self, config_name: str = "tiny", slots: int = 4,
                 max_seq: Optional[int] = None, chunk_steps: int = 8,
                 quantize: bool = False, eos_id: Optional[int] = None,
                 seed: int = 0, quantize_kv: bool = False, mesh=None,
                 lookahead: int = 1, adapters: Optional[Dict] = None,
                 lora_config=None, chunk_prefill_tokens: int = 0,
                 draft_config_name: Optional[str] = None,
                 draft_params=None, spec_k: int = 4,
                 draft_quantize: bool = False, draft_mode: str = "auto",
                 spec_ladder=None, spec_adaptive: bool = False,
                 automata=None, params=None,
                 max_queue: Optional[int] = None, watchdog_s: float = 0.0,
                 replica_mesh=None,
                 compilation_cache_dir: Optional[str] = None,
                 compact_upload: bool = True,
                 ring_max: Optional[int] = None, device=None):
        speculation = (draft_config_name is not None
                       or draft_params is not None or draft_quantize
                       or draft_mode != "auto" or spec_ladder is not None
                       or spec_adaptive)
        if speculation and not self.SPECULATION:
            raise NotImplementedError(
                "speculative decoding runs on the paged server "
                "(PagedContinuousServer); the contiguous layout's verify "
                "(llama.verify_chunk_ragged) is not ported yet")
        unsupported = {
            "mesh": mesh is not None,
            "replica_mesh": replica_mesh is not None,
            "adapters/lora_config": bool(adapters)
            or lora_config is not None,
            "automata (grammar-constrained decoding, "
            "models/constrained.py)": bool(automata),
            "compilation_cache_dir": compilation_cache_dir is not None,
            "compact_upload=False": not compact_upload,
        }
        named = [name for name, given in unsupported.items() if given]
        if named:
            raise NotImplementedError(
                f"not ported yet: {', '.join(named)}")
        self.device = resolve_device(device)
        self.config = llama.CONFIGS[config_name]
        if params is not None:
            # Caller-built weights (bridged, random_quantized_params):
            # ``quantize=`` only declares the tree's layout.
            self.params = params
        else:
            self.params = llama.init_params(self.config, seed=seed,
                                            device=self.device)
            if quantize:
                self.params = llama.quantize_params(self.params)
        self.slots = slots
        # Row max_seq-1 is the inactive-slot scratch row; a live request
        # may use at most max_seq-2 positions.
        self.max_seq = max_seq or self.config.max_seq_len
        self.chunk_steps = chunk_steps
        self.lookahead = max(1, int(lookahead))
        self.eos_id = eos_id
        self.quantize_kv = quantize_kv
        self._bucket_minimum = 16
        self.chunk_prefill_tokens = int(chunk_prefill_tokens)
        if self.chunk_prefill_tokens and (
                self.chunk_prefill_tokens < 16
                or self.chunk_prefill_tokens
                & (self.chunk_prefill_tokens - 1)):
            raise ValueError("chunk_prefill_tokens must be a power of two "
                             f">= 16, got {self.chunk_prefill_tokens}")
        #: slot -> in-progress chunked admission state.
        self._prefilling: Dict[int, Dict] = {}
        # The paired draft of model-mode speculation: its KV lives in the
        # layout's draft pool (_init_layout), prefilled at admission.
        self._draft = None
        if draft_config_name is not None:
            draft_config = llama.CONFIGS[draft_config_name]
            if draft_config.vocab_size != self.config.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            if draft_params is None:
                draft_params = llama.init_params(draft_config, seed=seed + 1,
                                                 device=self.device)
            if draft_quantize:
                draft_params = llama.quantize_params(draft_params)
            self._draft = dict(config=draft_config, params=draft_params)
        #: Speculation policy, set after _init_layout (the ladder validates
        #: against the final prompt-bucket floor); None = plain decode.
        self._spec = None
        self._init_layout()
        self._init_spec(draft_mode, spec_k, spec_ladder, spec_adaptive)
        # Decode-attention path tag and view geometry, decided once.
        self._attn_block_size, self._attn_total_blocks = \
            self._attention_blocks()
        self.decode_attention_path = self._decode_attention_path()
        # Host mirrors of the per-slot decode state (numpy): admissions
        # and retirements mutate them for free; they reach the device
        # only through _sync_dirty.
        self.positions = np.zeros((slots,), np.int32)
        self.active = np.zeros((slots,), bool)
        self.tokens = np.zeros((slots, 1), np.int32)
        self._temperatures = np.zeros(slots, np.float32)
        self._top_ps = np.ones(slots, np.float32)
        self._remaining = np.zeros(slots, np.int32)
        self._generator = torch.Generator(device=self.device) \
            .manual_seed(seed)
        self._any_sampled = False
        self._requests: List[Optional[DecodeRequest]] = [None] * slots
        self._emitted = np.zeros(slots, np.int64)
        self._queue: List[DecodeRequest] = []
        self.completed: List[DecodeRequest] = []
        self._state = self._init_device_state()
        # On the card a greedy steady chunk replays a captured CUDA graph
        # (llama.ChunkGraph) that reads and writes these first state
        # tensors in place, the static buffers; CPU tensors never capture.
        # _graphs_on is private: tests and measurements turn it off for the
        # eager chunk.
        self.graph_ledger = CaptureLedger()
        self._static_state = (self._state if self.device.type == "cuda"
                              else None)
        self._graphs_on = self._static_state is not None
        self._chunk_graph = None
        # In-flight ring of dispatched-but-unconsumed chunks; depth adapts
        # between ring_min (double buffering) and ring_max.
        self._ring = collections.deque()
        self.ring_min = max(2, self.lookahead)
        self.ring_max = (int(ring_max) if ring_max is not None
                         else max(4, 2 * self.ring_min))
        if self.ring_max < self.ring_min:
            raise ValueError(
                f"ring_max {self.ring_max} below the double-buffer floor "
                f"max(2, lookahead) = {self.ring_min}")
        self._ring_depth = self.ring_min
        self._ema_wait_ms: Optional[float] = None
        self._ema_dispatch_ms: Optional[float] = None
        self._starved_streak = 0
        #: per-slot admission generation: an in-flight entry applies only
        #: to a slot whose serial still matches its snapshot.
        self._slot_serial = np.zeros(slots, np.int64)
        #: decode steps dispatched but not yet consumed, per slot.
        self._inflight_sched = np.zeros(slots, np.int64)
        #: STRUCTURAL dirty rows (admission, retirement, budget rebase):
        #: every leaf uploads.  SAMPLING dirty rows (live edits): only the
        #: sampling leaves, since chunks may be in flight for the slot.
        self._dirty = np.zeros(slots, bool)
        self._dirty_sampling = np.zeros(slots, bool)
        #: The wave's last prefill may still be in flight at the next
        #: dispatch (step-log classification only).
        self._post_admission = False
        self.max_queue = max_queue
        self._instance_id = next(_SERVER_INSTANCE_IDS)
        self._metrics_labels = {"instance": f"srv{self._instance_id}"}
        self.counters: Dict = CounterDict(dict(
            dispatches=0, decode_steps=0, tokens_committed=0,
            host_syncs=0, sync_wait_ms=0.0, sync_elements=0,
            state_uploads=0, dirty_rows_uploaded=0, max_in_flight=0,
            ring_starved_steps=0, admission_deferred=0,
            decode_blocks_read=0, prefill_tokens=0, prefill_dispatches=0,
            deadline_exceeded=0, shed=0, watchdog_trips=0),
            prefix="server", labels=self._metrics_labels)
        # Per-phase latency histograms: fixed log-spaced buckets, so
        # replicas' histograms merge exactly (they ride EC shares as
        # ``hist.<phase>``) and the ``(metrics …)`` scrape renders them.
        self.latency_hists: Dict[str, Histogram] = {
            phase: REGISTRY.histogram(
                f"aiko_latency_{phase}_ms",
                help=f"Per-request {phase} latency (ms).",
                labels=self._metrics_labels)
            for phase in ("ttft", "total", "queue", "prefill",
                          "decode", "kv_restore")}
        self._serve_started: Optional[float] = None
        #: Host-side stall threshold (seconds) around the in-flight ring
        #: sync; 0 disables.  A sync past it trips the watchdog: queued
        #: and live work fails with the retriable
        #: ``error="watchdog_stalled"`` and the server stays unhealthy
        #: until an operator restarts it.
        self.watchdog_s = float(watchdog_s)
        self.healthy = True
        self._watchdog_tripped = False
        #: The alarm thread and the sync's own check after the wait can
        #: both trip; the lock lets exactly one count and capture.
        self._watchdog_lock = threading.Lock()

    # ---- layout hooks (the paged server overrides these) ---------------- #

    def _init_layout(self) -> None:
        """The contiguous layout reserves ``slots x max_seq`` rows."""
        if self.chunk_prefill_tokens:
            raise NotImplementedError(
                "not ported yet: chunk_prefill_tokens on the contiguous "
                "layout (llama.prefill_chunk); the paged server supports it")
        self.cache = llama.init_cache(self.config, self.slots, self.max_seq,
                                      quantize_kv=self.quantize_kv,
                                      device=self.device)

    def _graph_cache(self):
        """``(KV buffers, paged)`` the chunk graph decodes into."""
        return self.cache, False

    def _attention_blocks(self):
        """``(block_size, blocks_per_row)`` of the decode-attention view:
        the contiguous cache is the kernel's degenerate block pool."""
        block_size = contiguous_block_size(self.max_seq) or self.max_seq
        return block_size, -(-self.max_seq // block_size)

    def _decode_attention_path(self) -> str:
        """The kernel on the card when the cache has a block view, else
        the plain path."""
        return ("kernel" if self.device.type == "cuda"
                and contiguous_block_size(self.max_seq) else "reference")

    def _reserve_slot(self, slot: int, padded: int, request) -> bool:
        """Capacity hook: the contiguous layout always has room (the slot
        IS the room)."""
        return True

    def _release_slot(self, slot: int) -> None:
        """Layout hook: return a retiring slot's resources."""

    def _begin_chunked_prefill(self, slot: int, request, prompt_padded,
                               prompt_len: int) -> None:
        """Open a chunked admission for ``slot`` (paged layout only)."""
        raise NotImplementedError("chunked prefill on the contiguous layout")

    def _advance_prefills(self) -> None:
        """Run the next slice of every chunked admission (paged layout;
        the contiguous layout never has one in flight)."""

    def _finish_prefill(self, slot: int, state: Dict) -> None:
        """A chunked admission's prompt is in: the slot turns decode-
        active, the draft (if any) prefilled with the whole prompt first."""
        del self._prefilling[slot]
        if self._draft is not None:
            self._prefill_draft_rows([slot], state["prompt_padded"])
        self._activate_slot(slot, state["request"], state["prompt_padded"],
                            state["prompt_len"])

    def _init_spec(self, draft_mode: str, spec_k: int, spec_ladder,
                   spec_adaptive: bool) -> None:
        """Speculation wiring.  Two proposers share one verify, accept and
        commit path: ``model`` (the draft of ``draft_config_name``) and
        ``ngram`` (suffix-match proposals from each slot's own committed
        history, assembled on the host).  ``draft_mode="auto"`` resolves to
        ``model`` when a draft is configured; speculation is off when
        there is no draft and no explicit ``ngram``."""
        if self._draft is None and draft_mode not in ("ngram", "model"):
            if draft_mode != "auto":
                raise ValueError(
                    f"draft_mode must be 'model', 'ngram' or 'auto', got "
                    f"{draft_mode!r}")
            return
        mode = draft_mode
        if mode == "auto":
            mode = "model" if self._draft is not None else "ngram"
        if mode not in ("model", "ngram"):
            raise ValueError(
                f"draft_mode must be 'model', 'ngram' or 'auto', got "
                f"{draft_mode!r}")
        if mode == "model" and self._draft is None:
            raise ValueError("draft_mode='model' requires draft_config_name=")
        if mode == "ngram" and self._draft is not None:
            raise ValueError(
                "draft_mode='ngram' does not take draft_config_name= (the "
                "slot's own committed history is the draft)")
        ladder = (tuple(int(k) for k in spec_ladder)
                  if spec_ladder is not None
                  else default_ladder(int(spec_k)))
        ladder = validate_ladder(ladder, self._bucket_minimum)
        if ladder[-1] < 1:
            raise ValueError(
                f"spec ladder {ladder} has no usable rung: the top rung must "
                "be >= 1 (k=0 alone is just plain decode)")
        controller = (SpecController(self.slots, ladder)
                      if spec_adaptive else None)
        self._spec = dict(mode=mode, k=int(ladder[-1]), ladder=ladder,
                          controller=controller)
        self.spec_stats = SpecStats()

    # ---- device state -------------------------------------------------- #

    def _init_device_state(self) -> Dict[str, torch.Tensor]:
        slots, device = self.slots, self.device
        return {
            "token": torch.zeros((slots, 1), dtype=torch.int32,
                                 device=device),
            "positions": torch.zeros((slots,), dtype=torch.int32,
                                     device=device),
            "active": torch.zeros((slots,), dtype=torch.bool,
                                  device=device),
            "remaining": torch.zeros((slots,), dtype=torch.int32,
                                     device=device),
            "temps": torch.zeros((slots,), dtype=torch.float32,
                                 device=device),
            "tops": torch.ones((slots,), dtype=torch.float32,
                               device=device),
        }

    def _host_state(self) -> Dict[str, np.ndarray]:
        """Host mirror of :meth:`_init_device_state` (same keys)."""
        return {"token": self.tokens, "positions": self.positions,
                "active": self.active, "remaining": self._remaining,
                "temps": self._temperatures, "tops": self._top_ps}

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without a stream sync: through
        pinned memory, non-blocking (a pageable copy would wait for every
        chunk in flight)."""
        tensor = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cpu":
            return tensor
        return tensor.pin_memory().to(self.device, non_blocking=True)

    def _sync_dirty(self) -> None:
        """Merge dirty host-mirror rows into the resident device state:
        the ONLY host->device path for decode state, and none at all when
        no admission, retirement or edit happened since the last
        dispatch.  The dirty rows are gathered into a small packet
        (fancy indexing copies, so later mirror edits cannot race the
        upload), padded to a pow2 bucket by repeating the last row, and
        row-scattered by :func:`~..models.llama.scatter_state_rows`; with
        graphs on, into the static buffers in place
        (:func:`~..models.llama.scatter_state_rows_`)."""
        structural = self._dirty
        sampling = self._dirty_sampling & ~structural
        if not (structural.any() or sampling.any()):
            return
        if self._graphs_on:
            self._adopt_static()
            scatter = llama.scatter_state_rows_
        else:
            scatter = llama.scatter_state_rows
        rows = np.nonzero(structural)[0].astype(np.int32)
        sampling_rows = np.nonzero(sampling)[0].astype(np.int32)
        if steplog.RECORDER is not None:
            steplog.RECORDER.record(
                "state_upload", rows=len(rows) + len(sampling_rows))
        if len(rows):
            padded = self._pow2_rows(rows)
            packet = {key: self._upload(value[padded])
                      for key, value in self._host_state().items()}
            self._state = scatter(
                self._state, self._upload(padded.astype(np.int64)), packet)
        if len(sampling_rows):
            padded = self._pow2_rows(sampling_rows)
            packet = {"temps": self._upload(self._temperatures[padded]),
                      "tops": self._upload(self._top_ps[padded])}
            self._state = scatter(
                self._state, self._upload(padded.astype(np.int64)), packet)
        self._dirty[:] = False
        self._dirty_sampling[:] = False
        self.counters["state_uploads"] += 1
        self.counters["dirty_rows_uploaded"] += len(rows) \
            + len(sampling_rows)

    def _adopt_static(self) -> None:
        """Make the static buffers hold the resident state: after an eager
        round (a spec round, a mixed step, a sampled chunk) the state is
        new tensors, copied back on the device (a few bytes a slot)."""
        static = self._static_state
        if self._state is static:
            return
        for key, value in self._state.items():
            if value is not static[key]:
                static[key].copy_(value)
        self._state = static

    def _graph_chunk(self, steps: int, eos_id: int):
        """A greedy steady chunk as a replay of the server's
        :class:`~..models.llama.ChunkGraph` over the static state, which
        becomes the resident state: ``(tokens_out, counts)``."""
        self._adopt_static()
        if self._chunk_graph is None:
            cache, paged = self._graph_cache()
            self._chunk_graph = llama.ChunkGraph(
                self.params, self.config, cache, self._static_state, paged,
                self.graph_ledger)
        return self._chunk_graph.run(steps, eos_id)

    def _pow2_rows(self, rows: np.ndarray) -> np.ndarray:
        """Pad a dirty-row index vector to its pow2 bucket (clamped to
        the fleet size) by repeating the LAST row."""
        bucket = 1
        while bucket < len(rows):
            bucket *= 2
        bucket = min(bucket, self.slots)
        padded = np.empty(bucket, np.int32)
        padded[:len(rows)] = rows
        padded[len(rows):] = rows[-1]
        return padded

    def _note_decode_blocks(self, live, sched) -> None:
        """Estimate the KV blocks each dispatched decode step reads: the
        kernel reads only a row's live blocks (window-clamped), the plain
        path the whole cache every step."""
        sched_live = sched[live]
        if self.decode_attention_path == "kernel":
            block_size = self._attn_block_size
            blocks = (self.positions[live] + block_size) // block_size
            window = self.config.sliding_window
            if window:
                blocks = np.minimum(blocks, window // block_size + 1)
        else:
            blocks = np.full(sched_live.shape, self._attn_total_blocks,
                             np.int64)
        self.counters["decode_blocks_read"] += int(
            (blocks * sched_live).sum())

    # ---- submission and admission --------------------------------------- #

    def submit(self, request: DecodeRequest) -> None:
        request.tokens = []
        request.submitted_ts = time.monotonic()
        if request.deadline_ts is not None \
                and request.submitted_ts >= request.deadline_ts:
            self._finish_rejected(request, "deadline_exceeded")
            return
        if not self.healthy:
            # Tripped watchdog: a router re-dispatches on this error.
            self._finish_rejected(request, "watchdog_stalled")
            return
        if self.max_queue is not None \
                and len(self._queue) >= self.max_queue:
            request.retry_after_ms = self._retry_after_ms()
            self._finish_rejected(request, "overloaded")
            return
        prompt_len = int(np.asarray(request.prompt).shape[0])
        reason = self._admission_reject(prompt_len, request)
        if reason:
            request.error = reason
            self.completed.append(request)
            return
        self._queue.append(request)

    def _finish_rejected(self, request: DecodeRequest, reason: str) -> None:
        request.error = reason
        request.finished_ts = time.monotonic()
        if reason == "deadline_exceeded":
            self.counters["deadline_exceeded"] += 1
        elif reason == "overloaded":
            self.counters["shed"] += 1
        self.completed.append(request)

    def _retry_after_ms(self) -> int:
        """Shed hint, scaled with how far over capacity the queue is."""
        per_request_ms = 50
        return int(min(5_000, per_request_ms * max(1, len(self._queue))))

    def _admission_reject(self, prompt_len: int,
                          request: DecodeRequest) -> Optional[str]:
        """A non-None reason fails the request at submit time (never
        queue what can never run)."""
        if prompt_len == 0:
            return "empty_prompt"
        if prompt_len + request.max_new_tokens > self.max_seq - 1:
            return "prompt_too_long"
        if request.adapter is not None:
            return "unknown_adapter"
        if request.automaton is not None:
            return "unknown_automaton"
        if self._spec is not None and prompt_len + request.max_new_tokens \
                + self._spec["k"] + 1 > self.max_seq:
            # A verify window writes k + 1 rows from the live position,
            # bounded by the ladder top (adaptivity only narrows it).
            return "prompt_too_long"
        return None

    def live_requests(self) -> List[DecodeRequest]:
        return [r for r in self._requests if r is not None]

    @property
    def slots_active(self) -> int:
        return len(self.live_requests())

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def busy(self) -> bool:
        return bool(self._queue) or self.slots_active > 0 \
            or bool(self._ring)

    def _admit(self) -> None:
        admissions = []
        for slot in range(self.slots):
            if self._requests[slot] is not None or not self._queue:
                continue
            request = self._queue[0]
            prompt = np.asarray(request.prompt, np.int32)
            prompt_len = prompt.shape[0]
            # Clamp the bucket to the cache.
            padded = min(_bucket(prompt_len, self._bucket_minimum),
                         self.max_seq)
            if not self._reserve_slot(slot, padded, request):
                self.counters["admission_deferred"] += 1
                break          # capacity (paged pool) exhausted; retry later
            self._queue.pop(0)
            request.activated_ts = time.monotonic()
            prompt_padded = np.zeros((1, padded), np.int32)
            prompt_padded[0, :prompt_len] = prompt
            if self.chunk_prefill_tokens \
                    and prompt_len > self.chunk_prefill_tokens:
                # Chunked admission: the slot is OCCUPIED but not yet
                # active; its slices ride later dispatches.
                self._requests[slot] = request
                self._begin_chunked_prefill(slot, request, prompt_padded,
                                            prompt_len)
                continue
            admissions.append((slot, request, prompt_padded, prompt_len))
        if steplog.RECORDER is not None:
            if admissions or self._prefilling:
                steplog.RECORDER.record("admission",
                                        slots=len(admissions),
                                        chunked=len(self._prefilling))
        if not admissions:
            return
        self._prefill_and_insert(admissions)
        for slot, request, prompt_padded, prompt_len in admissions:
            self._activate_slot(slot, request, prompt_padded, prompt_len)
        # The wave's last prefill is still in flight here; the step log
        # files the gap to the next dispatch under admission.
        self._post_admission = True

    def _activate_slot(self, slot: int, request, prompt_padded,
                       prompt_len: int) -> None:
        """Seed a prefilled slot with the LAST prompt token at its own
        position."""
        self.tokens[slot, 0] = prompt_padded[0, prompt_len - 1]
        self.positions[slot] = prompt_len - 1
        self.active[slot] = True
        self._temperatures[slot] = max(0.0, float(request.temperature))
        self._top_ps[slot] = float(request.top_p)
        self._requests[slot] = request
        self._emitted[slot] = 0
        self._remaining[slot] = request.max_new_tokens
        self._inflight_sched[slot] = 0
        self._slot_serial[slot] += 1
        self._dirty[slot] = True
        self._any_sampled = bool((self._temperatures > 0).any())
        if self._spec is not None and self._spec["controller"] is not None:
            # New occupant: forget the previous request's acceptance
            # history (optimistic start at the ladder top).
            self._spec["controller"].reset(slot)
        if steplog.RECORDER is not None:
            steplog.RECORDER.record(
                "sampling_edit", slot=slot,
                temperature=float(request.temperature),
                top_p=float(request.top_p))

    def _prefill_and_insert(self, admissions) -> None:
        """Group admissions by bucket size and prefill each group in
        power-of-2 sub-batches, landing each sub-batch's KV rows in its
        slots with one batched copy."""
        groups: Dict[int, List] = {}
        for slot, _, prompt_padded, _ in admissions:
            groups.setdefault(prompt_padded.shape[1], []).append(
                (slot, prompt_padded))
        for padded, group in groups.items():
            start = 0
            while start < len(group):
                size = 1 << ((len(group) - start).bit_length() - 1)
                sub = group[start:start + size]
                start += size
                slots = [slot for slot, _ in sub]
                prompts = np.concatenate([p for _, p in sub], axis=0)
                bucket_cache = llama.init_cache(
                    self.config, len(sub), padded,
                    quantize_kv=self.quantize_kv, device=self.device)
                _, bucket_cache = llama.prefill(
                    self.params, self._upload(prompts), bucket_cache,
                    self.config)
                self._insert_slots(bucket_cache, slots, padded)
                self._note_prefill(len(sub) * padded)

    def _insert_slots(self, bucket_cache, slots: List[int],
                      padded: int) -> None:
        """Land a (k, padded, ...) prefilled bucket batch in the k slot
        rows (in place; rows past each prompt hold pad garbage that the
        decode step making them attendable rewrites)."""
        slot_rows = self._upload(np.asarray(slots, np.int64))
        for cache_layer, filled in zip(self.cache, bucket_cache):
            for key, dst in cache_layer.items():
                dst[slot_rows, :padded] = filled[key].to(dst.dtype)

    def _note_prefill(self, tokens: int) -> None:
        if self._serve_started is None:
            self._serve_started = time.monotonic()
        self.counters["prefill_tokens"] += int(tokens)
        self.counters["prefill_dispatches"] += 1

    # ---- retirement and control ----------------------------------------- #

    def _retire(self, slot: int) -> None:
        request = self._requests[slot]
        if request is not None:
            request.finished_ts = time.monotonic()
            self.completed.append(request)
        self._release_slot(slot)
        self._requests[slot] = None
        self.active[slot] = False
        self._remaining[slot] = 0
        self._inflight_sched[slot] = 0
        # Any still-in-flight entry's data for this slot is now stale.
        self._slot_serial[slot] += 1
        self._dirty[slot] = True
        self._temperatures[slot] = 0.0
        self._top_ps[slot] = 1.0
        self._any_sampled = bool((self._temperatures > 0).any())

    def update_sampling(self, request_id: str,
                        temperature: Optional[float] = None,
                        top_p: Optional[float] = None,
                        max_new_tokens: Optional[int] = None) -> bool:
        """Edit a live (or queued) request's sampling params / budget in
        place.  A sampling edit rides the next dispatch as a sampling-leaf
        packet (chunks may be in flight for the slot); a budget edit
        drains the ring first so the device's ``remaining`` is rebased
        against a settled count (a new budget at or below the tokens
        already emitted retires the request).  False for an unknown
        id."""
        for request in self._queue:
            if request.request_id == request_id:
                if temperature is not None:
                    request.temperature = float(temperature)
                if top_p is not None:
                    request.top_p = float(top_p)
                if max_new_tokens is not None:
                    request.max_new_tokens = int(max_new_tokens)
                return True
        for slot in range(self.slots):
            request = self._requests[slot]
            if request is None or request.request_id != request_id:
                continue
            if max_new_tokens is not None:
                self._drain_ring()
                if self._requests[slot] is not request:
                    return True    # finished naturally while draining
                request.max_new_tokens = int(max_new_tokens)
                if request.max_new_tokens <= self._emitted[slot]:
                    self._prefilling.pop(slot, None)
                    self._retire(slot)
                    return True
                self._remaining[slot] = (request.max_new_tokens
                                         - self._emitted[slot])
                self._dirty[slot] = True
            if temperature is not None:
                request.temperature = float(temperature)
                self._temperatures[slot] = max(0.0, float(temperature))
            if top_p is not None:
                request.top_p = float(top_p)
                self._top_ps[slot] = float(top_p)
            if max_new_tokens is None:
                self._dirty_sampling[slot] = True
            self._any_sampled = bool((self._temperatures > 0).any())
            if steplog.RECORDER is not None:
                steplog.RECORDER.record(
                    "sampling_edit", slot=slot,
                    temperature=float(self._temperatures[slot]),
                    top_p=float(self._top_ps[slot]))
            return True
        return False

    def cancel(self, request_id: str) -> bool:
        """Cancel by id wherever the request lives: queued (dropped) or
        decoding (the ring is drained first so dispatched chunks deliver
        their partial tokens, then the slot retires).  The request
        completes with ``error="cancelled"``."""
        for i, request in enumerate(self._queue):
            if request.request_id == request_id:
                self._queue.pop(i)
                request.error = "cancelled"
                request.finished_ts = time.monotonic()
                self.completed.append(request)
                return True
        for slot in range(self.slots):
            request = self._requests[slot]
            if request is None or request.request_id != request_id:
                continue
            if slot not in self._prefilling:
                # Decoding: drain the ring first so dispatched chunks
                # deliver their partial tokens.  A chunk-prefilling slot
                # has none; its blocks may be reused at once, because every
                # kernel runs on one stream in dispatch order.
                self._drain_ring()
                if self._requests[slot] is not request:
                    return True      # finished naturally while draining
            request.error = "cancelled"
            self._prefilling.pop(slot, None)
            self._retire(slot)
            return True
        return False

    def _evict_expired(self) -> None:
        """Deadline enforcement between chunks: drop expired queued
        requests and evict live slots past deadline (after draining the
        ring, as :meth:`cancel` does)."""
        now = time.monotonic()
        for index in reversed(range(len(self._queue))):
            request = self._queue[index]
            if request.deadline_ts is not None \
                    and now >= request.deadline_ts:
                self._queue.pop(index)
                request.error = "deadline_exceeded"
                request.finished_ts = now
                self.counters["deadline_exceeded"] += 1
                self.completed.append(request)
        expired = [slot for slot in range(self.slots)
                   if self._requests[slot] is not None
                   and self._requests[slot].deadline_ts is not None
                   and now >= self._requests[slot].deadline_ts]
        if not expired:
            return
        self._drain_ring()
        for slot in expired:
            request = self._requests[slot]
            if request is None or request.deadline_ts is None \
                    or time.monotonic() < request.deadline_ts:
                continue       # finished naturally while draining
            request.error = "deadline_exceeded"
            self.counters["deadline_exceeded"] += 1
            self._prefilling.pop(slot, None)
            self._retire(slot)

    def _fail_all(self, reason: str) -> None:
        """Fail every queued and live request with ``reason`` (the
        watchdog path: in-flight results are consumed first so partial
        tokens stay on the responses)."""
        self._drain_ring()
        now = time.monotonic()
        for request in self._queue:
            request.error = reason
            request.finished_ts = now
            self.completed.append(request)
        self._queue.clear()
        for slot in range(self.slots):
            if self._requests[slot] is not None:
                self._requests[slot].error = reason
                self._prefilling.pop(slot, None)
                self._retire(slot)

    # ---- the step loop -------------------------------------------------- #

    def step(self) -> List[DecodeRequest]:
        """Admit pending requests, keep the in-flight ring full, apply one
        (or, at the drain tail, every) completed chunk's results, retire
        finished slots.  Returns (and clears) the completed list."""
        self._evict_expired()
        self._admit()
        self._advance_prefills()
        if self.slots_active and not self._ring:
            self.counters["ring_starved_steps"] += 1
            self._starved_streak += 1
        else:
            self._starved_streak = 0
        depth = self._ring_depth
        dispatched = False
        while len(self._ring) < depth and self._dispatch_round():
            dispatched = True
        target = depth - 1 if dispatched else 0
        if len(self._ring) > target:
            self._consume_ready(len(self._ring) - target)
        self._ring_depth = self._ring_policy(
            depth, self.ring_min, self.ring_max, self._ema_wait_ms,
            self._ema_dispatch_ms, self._starved_streak)
        if self._watchdog_tripped:
            # A stalled sync already failed this batch's guarantees:
            # fail everything live or queued with the retriable error so
            # routers move the work, rather than letting clients find
            # the wedge by timeout.
            self._fail_all("watchdog_stalled")
        done, self.completed = self.completed, []
        return done

    def _plan_remaining(self) -> np.ndarray:
        """Per-slot decode budget still UNSCHEDULED: max_new - emitted -
        in-flight."""
        plan = np.zeros(self.slots, np.int64)
        for slot in range(self.slots):
            request = self._requests[slot]
            if request is None or not self.active[slot]:
                continue
            plan[slot] = (request.max_new_tokens - self._emitted[slot]
                          - self._inflight_sched[slot])
        return plan

    @staticmethod
    def _ring_policy(depth: int, ring_min: int, ring_max: int,
                     wait_ema, dispatch_ema, starved_streak: int) -> int:
        """Adaptive ring depth: widen while the DEVICE is starved (syncs
        return near-instantly and the ring keeps running dry), shrink
        while syncs dwarf dispatch cost, clamp to [ring_min, ring_max]."""
        if wait_ema is not None and dispatch_ema is not None \
                and dispatch_ema > 0.0:
            if starved_streak >= 2 and wait_ema < 0.25 * dispatch_ema:
                depth += 1
            elif wait_ema > 2.0 * dispatch_ema:
                depth -= 1
        return max(ring_min, min(ring_max, depth))

    def _dispatch_round(self) -> bool:
        """Launch one decode chunk, or one speculative round, against the
        resident device state WITHOUT waiting for it; False when no slot
        needs scheduling.  The call's duration feeds the dispatch EMA the
        ring policy weighs sync waits against."""
        began = time.monotonic()
        dispatched = (self._dispatch_spec_round() if self._spec is not None
                      else self._dispatch_chunk())
        if dispatched:
            elapsed_ms = (time.monotonic() - began) * 1e3
            self._ema_dispatch_ms = (
                elapsed_ms if self._ema_dispatch_ms is None
                else 0.25 * elapsed_ms + 0.75 * self._ema_dispatch_ms)
        return dispatched

    def _dispatch_chunk(self) -> bool:
        """Launch one decode chunk; False when no slot needs scheduling."""
        plan = self._plan_remaining()
        live = plan > 0
        if not live.any():
            return False
        steps = int(min(self.chunk_steps, int(plan[live].max())))
        self._sync_dirty()
        serial = self._slot_serial.copy()
        eos_id = -1 if self.eos_id is None else int(self.eos_id)
        if self._graphs_on and not self._any_sampled \
                and not self._prefilling:
            tokens_d, counts_d = self._graph_chunk(steps, eos_id)
        else:
            tokens_d, counts_d, self._state = self._serve_chunk(
                self._state, steps, eos_id, self._any_sampled)
        # Packed on the stream now, before a later replay can overwrite a
        # graph's outputs.
        result = torch.cat([tokens_d, counts_d[:, None],
                            self._state["active"][:, None].to(torch.int32)],
                           dim=1)
        sched = np.where(live, np.minimum(steps, plan), 0)
        self._inflight_sched += sched
        self._note_decode_blocks(live, sched)
        self._enqueue(result, kind="chunk", cols=steps, steps=steps,
                      sched=sched, serial=serial)
        return True

    def _enqueue(self, result, **entry) -> None:
        """Put a dispatched round on the in-flight ring: its packed int32
        ``result`` holds ``entry["cols"]`` token columns, then per-slot
        emit counts and the active flags (and, for a spec round, the full
        committed windows).  On the card the result is copied into pinned
        host memory behind the round on the stream; _consume_ready waits
        on the event, not the stream."""
        event = None
        if result.is_cuda:
            host = torch.empty(result.shape, dtype=result.dtype,
                               pin_memory=True)
            host.copy_(result, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            result = host
        self._ring.append(dict(entry, result=result, event=event))
        self._note_dispatch()

    def _serve_chunk(self, state, steps: int, eos_id: int, sampled: bool):
        tokens_d, counts_d, new_state, self.cache = \
            llama.serve_chunk_ragged(
                self.params, state, self.cache, steps, self.config,
                eos_id=eos_id, sampled=sampled,
                generator=self._generator if sampled else None)
        return tokens_d, counts_d, new_state

    def _dispatch_spec_round(self) -> bool:
        """ONE speculative round for every live slot, dispatched without a
        host sync: the proposer fills each slot's ``k``-token window, one
        target verify pass scores it, the acceptance kernel picks each
        slot's committed window, and :func:`spec_commit` applies EOS and
        budget caps and advances the resident state.  Greedy outputs are
        exactly the plain server's under every proposer and cap; sampled
        slots commit tokens distributed exactly as target-only sampling
        (MRS, or its delta-draft form for n-gram proposals).

        Adaptive rounds run at the controller's ``round_k`` (the max rung
        over live slots, always a ladder member); ``round_k == 0`` (every
        live slot parked at k = 0) runs the plain chunk instead."""
        plan = self._plan_remaining()
        live = plan > 0
        if not live.any():
            return False
        spec = self._spec
        mode, controller = spec["mode"], spec["controller"]
        if mode == "ngram" and self._ring:
            # n-gram proposals read the host's committed history: consume
            # what is in flight first, dispatch on the next pass.
            return False
        k, caps_host = spec["k"], None
        if controller is not None:
            k = controller.round_k(live)
            caps_host = controller.caps(live)
            controller.note_dispatch(live)
            if k == 0:
                controller.tick_cold_round(live)
                return self._dispatch_chunk()
        self._sync_dirty()
        st = self._state
        sampled = self._any_sampled
        draft_logits = None
        if mode == "model":
            proposals, draft_logits = self._draft_propose(st, k, sampled)
        else:
            props = np.zeros((self.slots, k), np.int32)
            for slot in np.nonzero(live)[0]:
                request = self._requests[int(slot)]
                props[slot], hit = ngram_propose(
                    list(request.prompt) + list(request.tokens), k)
                self.spec_stats.ngram_hits += int(hit)
            proposals = self._upload(props)
            if sampled:
                draft_logits = delta_draft_logits(proposals,
                                                  self.config.vocab_size)
        logits = self._spec_verify(st, torch.cat([st["token"], proposals],
                                                 dim=1))
        caps = self._upload(caps_host) if caps_host is not None else None
        if sampled:
            window, counts_raw = mrs_accept_batch(
                logits, draft_logits, proposals, st["temps"], st["tops"],
                self._generator, caps=caps)
        else:
            window, counts_raw = greedy_accept_batch(logits, proposals,
                                                     caps=caps)
        emit_tokens, emit_counts, resync, self._state = spec_commit(
            st, window, counts_raw,
            eos_id=-1 if self.eos_id is None else int(self.eos_id))
        if mode == "model":
            self._draft_resync(st, resync, st["positions"], st["active"])
        counts_full = torch.where(st["active"], counts_raw,
                                  torch.zeros_like(counts_raw))
        result = torch.cat([emit_tokens, emit_counts[:, None],
                            self._state["active"][:, None].to(torch.int32),
                            counts_full[:, None]], dim=1)
        # A round commits at least one token per live lane, so 1 is the
        # safe in-flight schedule increment (lanes that run out go
        # inactive on the device and emit nothing).
        sched = np.where(live, 1, 0)
        self._inflight_sched += sched
        self._enqueue(result, kind="spec", cols=k + 1, steps=1, sched=sched,
                      serial=self._slot_serial.copy(), caps=caps_host,
                      drafted_host=(int(caps_host[live].sum())
                                    if caps_host is not None else None))
        return True

    def _note_spec_round(self, entry) -> None:
        """SpecStats of one consumed round: drafted proposals (the caps the
        round ran under, or k per lane live at dispatch) and accepted
        ones (the full committed windows minus their final tokens)."""
        counts_full = entry["counts_full"]
        stats = self.spec_stats
        stats.target_passes += 1
        stats.drafted += (entry["drafted_host"]
                          if entry["drafted_host"] is not None
                          else int((counts_full > 0).sum())
                          * (entry["cols"] - 1))
        stats.accepted += int(np.maximum(counts_full - 1, 0).sum())

    def _note_dispatch(self) -> None:
        if self._serve_started is None:
            self._serve_started = time.monotonic()
        self.counters["dispatches"] += 1
        self.counters["max_in_flight"] = max(
            self.counters["max_in_flight"], len(self._ring))
        if steplog.RECORDER is not None:
            if self._post_admission:
                steplog.RECORDER.record("dispatch", ring=len(self._ring),
                                        after_admission=1)
            else:
                steplog.RECORDER.record("dispatch", ring=len(self._ring))
        self._post_admission = False

    def _consume_ready(self, max_entries: int) -> None:
        """Apply the oldest ``max_entries`` in-flight entries' results to
        host bookkeeping in ONE pass: deliver tokens, advance mirrors,
        retire lanes the device deactivated.  Waiting on each entry's
        event is the only device->host sync of the serving path: per
        entry, (slots x steps) token ids plus two slots-sized vectors,
        never logits."""
        count = min(int(max_entries), len(self._ring))
        if count <= 0:
            return
        entries = [self._ring.popleft() for _ in range(count)]
        wait_start = time.monotonic()
        alarm = None
        if self.watchdog_s > 0:
            # The alarm thread flips ``healthy`` even while this thread
            # still blocks in the event wait (a wedged kernel never
            # returns), so telemetry readers on other threads see the
            # trip; the check after the wait handles a stall that ends.
            alarm = threading.Timer(self.watchdog_s, self._trip_watchdog)
            alarm.daemon = True
            alarm.start()
        if faults.PLAN is not None:
            stall = faults.PLAN.check("stall_step")
            if stall is not None:
                # Simulated device wedge: the sync "takes" this long,
                # which is what the watchdog exists to catch.  Inside the
                # alarm's window (the reference sleeps before arming it),
                # so the alarm fires during the stall as during a real one.
                time.sleep(float(stall.get("ms", 50.0)) / 1e3)
        elements = 0
        for entry in entries:
            if entry["event"] is not None:
                entry["event"].synchronize()
            packed = entry["result"].numpy()
            cols = entry["cols"]
            entry["tokens"] = packed[:, :cols]
            entry["counts"] = packed[:, cols]
            entry["active_after"] = packed[:, cols + 1].astype(bool)
            if entry["kind"] == "spec":
                entry["counts_full"] = packed[:, cols + 2]
            elements += packed.size
        if alarm is not None:
            alarm.cancel()
            if time.monotonic() - wait_start > self.watchdog_s:
                self._trip_watchdog()
        now = time.monotonic()
        wait_ms = (now - wait_start) * 1e3
        self._ema_wait_ms = (wait_ms if self._ema_wait_ms is None
                             else 0.25 * wait_ms + 0.75 * self._ema_wait_ms)
        self.counters["host_syncs"] += 1
        self.counters["sync_wait_ms"] += wait_ms
        self.counters["sync_elements"] += elements
        batch_steps = sum(int(entry["steps"]) for entry in entries)
        self.counters["decode_steps"] += batch_steps
        if steplog.RECORDER is not None:
            steplog.RECORDER.record(
                "sync", wait_ms=round(wait_ms, 3), steps=batch_steps,
                entries=count)
        dispatch_start = time.monotonic()
        committed_upper = 0
        touched_slots = set()
        # An entry's lane is live iff its dispatch-time serial still
        # matches and the slot is active and occupied; rows retired while
        # walking entry i are cleared from the younger entries' masks.
        serials = np.stack([entry["serial"] for entry in entries])
        occupied = np.fromiter((r is not None for r in self._requests),
                               bool, self.slots)
        batch_live = (serials == self._slot_serial) & self.active \
            & occupied
        delivered = 0
        for index, entry in enumerate(entries):
            spec = entry["kind"] == "spec"
            if spec:
                self._note_spec_round(entry)
            live = batch_live[index]
            sched = entry["sched"]
            self._inflight_sched[live] -= sched[live]
            token_rows = entry["tokens"].tolist()
            count_list = entry["counts"].tolist()
            # Mirrors advance by what the device WROTE: the full committed
            # window of a spec round (cache rows exist past the emit caps),
            # the emitted prefix of a chunk.
            full_list = entry["counts_full"].tolist() if spec else count_list
            active_list = entry["active_after"].tolist()
            caps = entry["caps"] if spec else None
            committed_upper += int(entry["counts"].sum())
            for slot in np.nonzero(live)[0]:
                slot = int(slot)
                touched_slots.add(slot)
                request = self._requests[slot]
                emitted = count_list[slot]
                if emitted:
                    if request.first_token_ts is None:
                        request.first_token_ts = now
                    request.tokens.extend(token_rows[slot][:emitted])
                    self._emitted[slot] += emitted
                    self._remaining[slot] = (request.max_new_tokens
                                             - self._emitted[slot])
                    advance = full_list[slot]
                    if spec:
                        self._note_spec_rollback(slot, advance,
                                                 entry["cols"])
                        if request.spec_accepted_rounds is None:
                            request.spec_accepted_rounds = []
                        request.spec_accepted_rounds.append(advance - 1)
                    self.positions[slot] += advance
                    self.tokens[slot, 0] = token_rows[slot][advance - 1]
                    delivered += emitted
                if caps is not None:
                    # Acceptance feedback at the cap this slot ran under
                    # (k = 0 ticks the re-probe counter instead).
                    self._spec["controller"].observe(
                        slot, int(caps[slot]),
                        full_list[slot] - 1 if emitted else 0)
                if not active_list[slot]:
                    self._retire(slot)
                    batch_live[index + 1:, slot] = False
        self.counters["tokens_committed"] += delivered
        if steplog.RECORDER is not None:
            steplog.RECORDER.record(
                "token_dispatch", slots=len(touched_slots),
                tokens=delivered,
                ms=round((time.monotonic() - dispatch_start) * 1e3, 3))
            # Device-reported emit counts: stale-serial lanes may be
            # excluded above, so this is an upper bound on committed.
            steplog.RECORDER.record("commit", tokens=committed_upper)

    def _trip_watchdog(self) -> None:
        """Mark the server wedged (idempotent; callable from the alarm
        thread and the engine thread at once: only the first caller
        counts the trip and captures).  ``step()`` fails outstanding
        work on its next pass; recovery is an operator restart, never
        self-clearing."""
        with self._watchdog_lock:
            if self._watchdog_tripped:
                return
            self._watchdog_tripped = True
        self.healthy = False
        self.counters["watchdog_trips"] += 1
        if flight.FLIGHT is not None:
            # Forensics around the stall, joined on whichever in-flight
            # request's trace id there is.
            carrier = next((r.trace_ctx for r in self._requests
                            if r is not None and r.trace_ctx), "")
            context = trace.extract(carrier)
            flight.FLIGHT.capture(
                "watchdog",
                trace_id=context.trace_id if context else None,
                reason=f"ring sync stalled past {self.watchdog_s:g}s")

    def _drain_ring(self) -> None:
        while self._ring:
            self._consume_ready(len(self._ring))

    # ---- reporting ------------------------------------------------------- #

    def stats(self) -> Dict:
        """Serving counters and derived rates."""
        steps = self.counters["decode_steps"]
        elapsed = (time.monotonic() - self._serve_started
                   if self._serve_started is not None else 0.0)
        out = dict(
            self.counters,
            in_flight=len(self._ring),
            ring_depth=self._ring_depth,
            queue_depth=self.queue_depth,
            prefill_queue_depth=len(self._prefilling),
            slots_active=self.slots_active,
            free_slots=self.slots - self.slots_active,
            healthy=int(self.healthy),
            device=str(self.device),
            decode_attention_path=self.decode_attention_path,
            blocks_read_per_step=(
                round(self.counters["decode_blocks_read"] / steps, 2)
                if steps else 0.0),
            decode_steps_per_sec=(
                round(steps / elapsed, 1) if elapsed > 0 else 0.0),
            prefill_tokens_per_sec=(
                round(self.counters["prefill_tokens"] / elapsed, 1)
                if elapsed > 0 else 0.0),
            sync_stalls_per_100_steps=(
                round(100.0 * self.counters["host_syncs"] / steps, 2)
                if steps else 0.0),
            **self.graph_ledger.counters())
        if self._spec is not None:
            controller = self._spec["controller"]
            stats = self.spec_stats
            out.update(
                spec_k=self._spec["k"],
                spec_rounds=stats.target_passes,
                spec_proposed=stats.drafted,
                spec_accepted=stats.accepted,
                spec_acceptance_rate=round(stats.acceptance_rate, 4),
                spec_tokens_per_target_pass=round(
                    stats.tokens_per_target_pass, 4),
                spec_rollback_blocks=stats.rollback_blocks,
                spec_draft_mode=self._spec["mode"],
                spec_k_effective=(controller.hist_string()
                                  if controller is not None else "-"),
                spec_jump_forward_tokens=stats.jump_forward_tokens,
                spec_ngram_hits=stats.ngram_hits)
        return out

    def warm_spec_ladder(self, sampled: bool = False) -> int:
        """Run every non-zero rung of the speculation ladder once on an
        IDLE engine (no live slot, empty ring), so the first adaptive round
        of each width finds the card's libraries and allocator warm.  Each
        rung's proposer, verify, acceptance and commit run against the
        all-inactive resident state: inactive rows write nothing in the
        verify (the draft's decode writes scratch block 0) and the commit
        is a masked no-op.  ``sampled=True`` runs the sampled variants.
        Returns the rungs run."""
        if self._spec is None:
            return 0
        if self.slots_active or self._ring:
            raise RuntimeError("warm_spec_ladder must run on an idle engine")
        self._sync_dirty()
        rungs = 0
        for k in self._spec["ladder"]:
            if k == 0:
                continue        # the plain chunk
            st = self._state
            if self._spec["mode"] == "model":
                proposals, draft_logits = self._draft_propose(st, k, sampled)
            else:
                proposals = self._upload(np.zeros((self.slots, k), np.int32))
                draft_logits = (delta_draft_logits(
                    proposals, self.config.vocab_size) if sampled else None)
            logits = self._spec_verify(st, torch.cat([st["token"], proposals],
                                                     dim=1))
            caps = (self._upload(np.zeros(self.slots, np.int32))
                    if self._spec["controller"] is not None else None)
            if sampled:
                window, counts_raw = mrs_accept_batch(
                    logits, draft_logits, proposals, st["temps"], st["tops"],
                    self._generator, caps=caps)
            else:
                window, counts_raw = greedy_accept_batch(logits, proposals,
                                                         caps=caps)
            _, _, resync, self._state = spec_commit(
                st, window, counts_raw,
                eos_id=-1 if self.eos_id is None else int(self.eos_id))
            if self._spec["mode"] == "model":
                self._draft_resync(st, resync, st["positions"],
                                   st["active"])
            rungs += 1
        return rungs

    def run_until_drained(self, max_chunks: int = 10_000):
        """Synchronous helper (tests / batch jobs): pump until every
        queued request completes."""
        finished, self.completed = self.completed, []
        chunks = 0
        while self.busy:
            finished.extend(self.step())
            chunks += 1
            if chunks > max_chunks:
                raise RuntimeError("continuous batching did not drain")
        return finished


class ContinuousReplica(Actor):
    """Actor wrapper: same ``(infer …)`` protocol as
    :class:`~.serving.ModelReplica`, but requests join the continuous
    batch instead of running serially.  A delayed self-post pump runs
    server steps between message deliveries while any slot is live;
    every server call runs on the engine's thread.

    The port's copy of the reference's ``ContinuousReplica``: ``infer``,
    ``pump``, ``infer_cancel``, ``retire``, streaming partials, the
    telemetry share, per-phase latencies, slow requests and trace spans
    on every response, and the ``kill_replica`` / ``corrupt_response`` /
    ``kill_source_mid_migration`` / ``drop_migration_block`` fault sites.

    Paged servers with the prefix cache enabled also join the distributed
    KV cache (:mod:`~..kvstore`): the replica advertises its cached
    prefix digest (``kv_prefixes``) on its share (every pump, plus a slow
    re-advertise timer so an idle replica keeps its directory lease),
    answers ``(kv_export …)`` block-transfer RPCs from peers, registers a
    live request's chain for ``(migrate_prepare …)`` and answers
    ``migrate_ready`` with its blocks and tokens, and — when a request
    carries a ``kv_source`` hint — pulls the prefix from the named owner
    before admission (``kv_migrate`` marks a migration's resume, which
    also pulls the source's rows past the chain's last full block, so it
    decodes on from the source's exact cache instead of recomputing
    them), falling back to plain local prefill if the owner does not
    answer within
    ``kv_fetch_timeout_s`` (counted in ``kv_transfer_failures``).  The
    import lands behind the ``RESTORING`` sentinel a few blocks a step,
    on the engine thread like every other server call.  A server without
    the KV methods answers ``kv_unsupported`` / ``migrate_unsupported``.
    ``kv_tier_hint`` starts the promotion of a demoted or spilled chain
    at arrival.

    ``prefill_only=True`` makes this a dedicated PREFILL replica for the
    router's opt-in disaggregated mode: generation budgets clamp to one
    token (the admission seed), the cache retains the prompt's blocks,
    and the digest advertises role ``prefill`` so routers never send it
    decode traffic.  A request whose payload carries ``prefill_only``
    gets the same treatment on any replica.
    ``adapter_load`` / ``adapter_unload`` answer ``unsupported_command``
    (the port's servers take no adapters yet), as every other replica
    protocol speaker does."""

    #: Re-advertise the prefix digest this often even when idle — must
    #: stay well under the router directory's ``lease_s``.
    KV_ADVERTISE_S = 5.0

    def __init__(self, context, process=None, server=None,
                 prefill_only: bool = False,
                 kv_fetch_timeout_s: float = 2.0):
        from .serving import (REPLICA_PROTOCOL,
                              _register_unsupported_adapter_commands)
        context.protocol = context.protocol or REPLICA_PROTOCOL
        super().__init__(context, process)
        self.server = server or ContinuousBatchingServer()
        self.prefill_only = prefill_only
        self.kv_fetch_timeout_s = kv_fetch_timeout_s
        #: (digest_epoch, migrating) of the last advertised digest.
        self._digest_stamp = None
        self._command_handlers["infer"] = self._wire_infer
        self._command_handlers["pump"] = self._pump
        _register_unsupported_adapter_commands(self)
        self._command_handlers["infer_cancel"] = self._wire_cancel
        self._command_handlers["kv_export"] = self._wire_kv_export
        self._command_handlers["retire"] = self._wire_retire
        self._command_handlers["migrate_prepare"] = \
            self._wire_migrate_prepare
        self.share["slots"] = self.server.slots
        self.share["tp_degree"] = getattr(self.server, "tp_degree", 1)
        self.share["mesh_shape"] = getattr(self.server, "mesh_shape",
                                           "")
        self.share["requests_served"] = 0
        self._pumping = False
        #: Graceful drain in progress (``(retire)`` received): routers
        #: stop sending new work; queued/active requests finish here.
        self._retiring = False
        #: id(request) -> tokens already delivered via infer_partial.
        #: Keyed by object identity, not request_id: the client owns
        #: that string and may reuse it across concurrent requests.
        self._stream_sent: Dict[int, int] = {}
        #: request ids being live-migrated AWAY from this replica: while
        #: non-empty the prefix digest carries the ``/migrating`` flag and
        #: the shared lifecycle reads ``migrating``.
        self._migrating_ids: set = set()
        #: slowest completed requests — ``(total_ms, request_id,
        #: {phase: ms})`` kept sorted descending; surfaces in the EC
        #: share as ``slow_requests`` for the dashboard pane.
        self._slow: List = []
        # Warm-start fetches in flight: token -> parked DecodeRequest.
        self._kv_pending: Dict[str, DecodeRequest] = {}
        self._kv_started: Dict[str, float] = {}
        self._kv_counter = 0
        self._kv_topic = f"{self.topic_path}/kv"
        if self._kv_capable():
            self.process.add_message_handler(self._on_kv_message,
                                             self._kv_topic)
            self.process.event.add_timer_handler(
                self._kv_advertise, self.KV_ADVERTISE_S)

    def _kv_capable(self) -> bool:
        return getattr(self.server, "enable_prefix_cache", False) \
            and hasattr(self.server, "kv_export_payload")

    @property
    def kv_role(self) -> str:
        """The digest's role: ``prefill`` on a dedicated prefill replica,
        else ``decode``."""
        return "prefill" if self.prefill_only else "decode"

    def _wire_infer(self, request_id, response_topic, payload=None):
        from ..pipeline.codec import decode_swag
        request = DecodeRequest(request_id=str(request_id), prompt=None,
                                max_new_tokens=0, tokens=[],
                                response_topic=str(response_topic))
        try:
            inputs = decode_swag(payload or {})
            request.prompt = np.asarray(inputs["tokens"],
                                        np.int32).reshape(-1)
            request.max_new_tokens = int(
                np.asarray(inputs.get("max_new_tokens", 16)))
            request.temperature = float(
                np.asarray(inputs.get("temperature", 0.0)))
            request.top_p = float(np.asarray(inputs.get("top_p", 1.0)))
            request.stream = bool(
                int(np.asarray(inputs.get("stream", 0))))
            adapter = inputs.get("adapter")
            request.adapter = str(adapter) if adapter else None
            automaton = inputs.get("automaton")
            request.automaton = str(automaton) if automaton else None
            deadline_ms = inputs.get("deadline_ms")
            if deadline_ms is not None:
                # Relative budget → local monotonic deadline (wall
                # clocks never cross processes; transit time before
                # arrival is not charged).
                request.deadline_ts = time.monotonic() + \
                    float(np.asarray(deadline_ms)) / 1e3
            carrier = inputs.get("trace")
            if carrier:
                request.trace_ctx = str(carrier)
            kv_source = inputs.get("kv_source")
            kv_tier_hint = inputs.get("kv_tier_hint")
            kv_migrate = bool(
                int(np.asarray(inputs.get("kv_migrate", 0))))
            if self.prefill_only or inputs.get("prefill_only"):
                # Dedicated prefill: the admission seed IS the one
                # generated token; the prompt's blocks stay cached
                # for the decode replica to pull.
                request.max_new_tokens = 1
                request.stream = False
        except Exception:  # noqa: BLE001 - bad request must still respond
            self.logger.exception("%s: malformed infer request %s",
                                  self.name, request_id)
            request.error = "infer_failed"
            self._respond(request)
            return
        if kv_source and self._kv_capable() \
                and request.adapter is None:
            if self._begin_kv_fetch(request, str(kv_source),
                                    migrate=kv_migrate):
                return        # parked until import or timeout
        if kv_tier_hint and request.adapter is None \
                and hasattr(self.server, "prefetch_promote"):
            # A router hinted this prompt at a demoted/spilled chain:
            # start the async promotion now, so the restore overlaps the
            # request's queue wait.
            self.server.prefetch_promote(request.prompt)
        self.server.submit(request)
        self._ensure_pumping()

    def _wire_retire(self, *_args):
        """``(retire)`` — graceful drain (autoscaler scale-in): flip
        the shared ``lifecycle`` to ``retiring`` so routers stop
        sending NEW work, keep serving whatever is queued or active,
        and advertise ``drained 1`` once idle so the supervisor knows
        the process is safe to stop.  Requests that raced the flip in
        transit are still served — zero-lost outranks a prompt exit."""
        if self._retiring:
            return
        self._retiring = True
        self.logger.info("%s: retiring — draining %d queued / %d active",
                         self.name, self.server.queue_depth,
                         self.server.slots_active)
        updates = {"lifecycle": "retiring"}
        if not self.server.busy and not self._kv_pending:
            updates["drained"] = 1
        self.share.update(updates)
        if self.ec_producer is not None:
            for key, value in updates.items():
                self.ec_producer.update(key, value)
        if self.server.busy:
            self._ensure_pumping()

    def _wire_migrate_prepare(self, request_id, response_topic,
                              payload=None):
        """``(migrate_prepare mid reply swag{request_id})`` — a router is
        live-migrating one of our requests away.  Register the request's
        LIVE chain (prompt + committed tokens) in the prefix index so
        ``kv_export`` can serve it, mark the request migrating (digest
        flag + ``migrating`` lifecycle), and answer ``(migrate_ready mid
        swag{request_id, blocks, tokens})`` — or an error swag the router
        degrades on (``migrate_unknown_request`` when the request is not
        live here, ``migrate_unsupported`` for a server without KV
        transfer, ``migrate_export_failed``).  The request keeps being
        served: the double-delivery window is the point."""
        from ..pipeline.codec import decode_swag, encode_swag
        mid = str(request_id)
        try:
            target_id = str(decode_swag(payload or {})["request_id"])
        except Exception:  # noqa: BLE001 - malformed → router aborts
            target_id = ""
        request = next(
            (r for r in self.server.live_requests()
             if r.request_id == target_id), None)
        if request is None:
            outputs: Dict = {"request_id": target_id,
                             "error": "migrate_unknown_request"}
        elif not self._kv_capable() \
                or not hasattr(self.server, "publish_live_chain"):
            outputs = {"request_id": target_id,
                       "error": "migrate_unsupported"}
        else:
            try:
                blocks = int(self.server.publish_live_chain(request))
            except Exception:  # noqa: BLE001 - degrade to cold resume
                self.logger.exception(
                    "%s: publish_live_chain failed for %s",
                    self.name, target_id)
                blocks = -1
            if blocks < 0:
                outputs = {"request_id": target_id,
                           "error": "migrate_export_failed"}
            else:
                outputs = {"request_id": target_id, "blocks": blocks,
                           "tokens": len(request.tokens or [])}
                self._migrating_ids.add(target_id)
                updates = {}
                if self.share.get("lifecycle") == "ready":
                    updates["lifecycle"] = "migrating"
                # Push the flagged digest NOW: routers must stop scoring
                # us for new prefix placement before the transfer starts.
                updates["kv_prefixes"] = self.server.prefix_digest(
                    role=self.kv_role, migrating=True)
                self.share.update(updates)
                if self.ec_producer is not None:
                    for key, value in updates.items():
                        self.ec_producer.update(key, value)
        self.process.message.publish(
            str(response_topic),
            generate("migrate_ready", [mid, encode_swag(outputs)]))

    def _ensure_pumping(self):
        if not self._pumping:
            self._pumping = True
            self._schedule_pump()

    def _schedule_pump(self):
        from ..runtime.actor import ActorMessage, Mailbox
        self._post_message(Mailbox.IN, ActorMessage("pump", []),
                           delay=0.001)

    def _pump(self):
        if faults.PLAN is not None:
            hit = faults.PLAN.check("kill_replica", key=self.name)
            if hit is not None:
                # Die mid-decode with requests in flight — the LWT
                # (absent) fires, the Registrar evicts this process's
                # services, and routers re-dispatch.  ``hard=1``
                # additionally kills the OS process (cross-process
                # chaos; the exit code marks an injected death).
                self.logger.warning("%s: fault kill_replica firing",
                                    self.name)
                self._pumping = False
                self.process.kill()
                if hit.get("hard"):
                    import os
                    os._exit(13)
                return
            if self._migrating_ids:
                hit = faults.PLAN.check("kill_source_mid_migration",
                                        key=self.name)
                if hit is not None:
                    # Die as the SOURCE of an in-flight migration: the
                    # same LWT path as kill_replica.
                    self.logger.warning(
                        "%s: fault kill_source_mid_migration firing",
                        self.name)
                    self._pumping = False
                    self.process.kill()
                    if hit.get("hard"):
                        import os
                        os._exit(13)
                    return
        finished = self.server.step()
        self._stream_partials()
        for request in finished:
            self._respond(request)
        self._share_telemetry()
        if self.server.busy or self.server.completed:
            self._schedule_pump()
        else:
            self._pumping = False

    def _share_telemetry(self):
        """Operator view (dashboard / any ECConsumer): live slot
        occupancy, queue depth, async-loop perf counters, latency
        quantiles and encoded histograms, refreshed every pump.

        Quantiles come from the server's fixed-bucket histograms
        (obs.metrics) rather than a rolling raw-sample window: the
        SAME bucket bounds everywhere mean a router can merge the
        ``hist.<phase>`` encodings it watches across replicas and
        quote exact fleet-level p50/p95/p99 — nearest-rank lists
        cannot merge without shipping every sample."""
        from .serving import serving_telemetry
        updates = serving_telemetry(self.server.stats())
        if self._kv_capable():
            # The digest walks every tier: recompute it only when the
            # server's cache moved or the migrating flag flipped.
            stamp = (self.server.digest_epoch, bool(self._migrating_ids))
            if stamp != self._digest_stamp:
                self._digest_stamp = stamp
                updates["kv_prefixes"] = self.server.prefix_digest(
                    role=self.kv_role, migrating=stamp[1])
        hists = self.server.latency_hists
        if hists["ttft"].count:
            updates["ttft_p50_ms"] = round(hists["ttft"].quantile(0.5), 1)
            # p95 is the admission-stall number SLOs watch (p50 hides
            # a prefill convoy behind the median).
            updates["ttft_p95_ms"] = round(
                hists["ttft"].quantile(0.95), 1)
        if hists["total"].count:
            updates["total_p50_ms"] = round(
                hists["total"].quantile(0.5), 1)
        for phase, hist in hists.items():
            if hist.count:
                updates[f"hist.{phase}"] = hist.encode()
        if self._slow:
            updates["slow_requests"] = " ".join(
                f"{request_id}:{total_ms}:" + ",".join(
                    f"{phase}={value}" for phase, value
                    in sorted(breakdown.items()))
                for total_ms, request_id, breakdown in self._slow)
        if flight.FLIGHT is not None and flight.FLIGHT.captures:
            # Recent flight-recorder triggers, newest last — the
            # dashboard's recent-triggers pane reads this.
            updates["flight_captures"] = flight.FLIGHT.captures
            recent = flight.FLIGHT.recent()
            if recent:
                updates["last_capture"] = " ".join(
                    f"{entry['trigger']}@{entry['ts']:.0f}"
                    for entry in recent[-3:])
        if self._retiring and not self.server.busy \
                and not self._kv_pending:
            # Drain complete: every queued/active request reached a
            # terminal state.  The supervisor watches this key before
            # stopping the process.
            updates["drained"] = 1
        if not self.server.healthy \
                and self.share.get("lifecycle") != "unhealthy":
            # The router watches lifecycle on the replica's state
            # topic: flipping it drains this replica (in-flight work
            # re-dispatched, no new routes) without waiting for the
            # process to die.
            updates["lifecycle"] = "unhealthy"
        changed = {key: value for key, value in updates.items()
                   if self.share.get(key) != value}
        if not changed:
            return
        self.share.update(changed)
        if self.ec_producer is not None:
            for key, value in changed.items():
                self.ec_producer.update(key, value)

    # -- distributed KV cache (kvstore subsystem) ------------------- #

    def _kv_advertise(self, *_args):
        """Slow periodic re-advertise: refreshes the router directory's
        lease on this replica's prefixes while idle (no pump runs, so
        :meth:`_share_telemetry`'s diff never fires)."""
        if not self._kv_capable():
            return
        digest = self.server.prefix_digest(
            role=self.kv_role, migrating=bool(self._migrating_ids))
        self.share["kv_prefixes"] = digest
        if self.ec_producer is not None:
            self.ec_producer.update("kv_prefixes", digest)

    def _wire_kv_export(self, request_id, response_topic,
                        payload=None):
        """``(kv_export id reply swag)`` — peer block-transfer RPC:
        resolve the requested chain segment and answer with the pool
        rows, or an error the importer treats as a recompute fallback.
        The gather runs here, on the engine thread."""
        from ..pipeline.codec import decode_swag, encode_swag
        started = trace.now()
        carrier = None
        outputs = {"error": "kv_unsupported"}
        if self._kv_capable():
            try:
                inputs = decode_swag(payload or {})
                carrier = inputs.get("trace")
                keys = [str(k) for k in inputs["kv_keys"]]
                exported = self.server.kv_export_payload(
                    keys,
                    int(np.asarray(inputs.get("kv_start_depth", 0)))) \
                    if keys else {}
                if faults.PLAN is not None:
                    if exported \
                            and inputs.get("kv_migrate") \
                            and faults.PLAN.check(
                                "drop_migration_block",
                                key=str(request_id)) is not None:
                        # Ship the migration chain one block short: the
                        # destination's admission recomputes the tail.
                        from ..kvstore.transfer import drop_one_block
                        self.logger.warning(
                            "%s: fault drop_migration_block firing",
                            self.name)
                        exported = drop_one_block(exported)
                if exported is not None \
                        and inputs.get("kv_tail_chain") is not None:
                    tail = self._migration_tail(inputs["kv_tail_chain"])
                    if tail is not None:
                        exported = dict(exported, **tail)
                    elif not keys:
                        exported = None
                outputs = exported if exported is not None \
                    else {"error": "kv_prefix_gone"}
            except Exception:  # noqa: BLE001 - RPC must answer
                self.logger.exception("%s: kv_export failed",
                                      self.name)
                outputs = {"error": "kv_export_failed"}
        if carrier and "error" not in outputs:
            # Transfer-source span: the exporter's share of a traced
            # request's warm start, riding back with the blocks.
            span = trace.synth_span(
                "kv_export", str(carrier), self.name, started,
                trace.now(), attrs={"keys": len(keys)})
            outputs["trace_spans"] = trace.encode_spans([span])
        self.process.message.publish(
            str(response_topic),
            generate("kv_export_response",
                     [str(request_id), encode_swag(outputs)]))

    def _migration_tail(self, chain) -> Optional[Dict]:
        """The tail rows (:meth:`~.paged.PagedContinuousServer
        .migration_tail_rows`) for a resume whose prompt is ``chain``:
        from the live request migrating away from here whose prompt plus
        committed tokens begins with it, or None when none does."""
        chain = np.asarray(chain, np.int32).reshape(-1)
        for request in self.server.live_requests():
            if request.request_id not in self._migrating_ids:
                continue
            full = np.concatenate(
                [np.asarray(request.prompt, np.int32).reshape(-1),
                 np.asarray(request.tokens or [], np.int32)])
            if len(full) >= len(chain) \
                    and np.array_equal(full[:len(chain)], chain):
                return self.server.migration_tail_rows(request,
                                                       len(chain) - 1)
        return None

    def _begin_kv_fetch(self, request: DecodeRequest, kv_source: str,
                        migrate: bool = False) -> bool:
        """Warm start: request the prompt's missing prefix blocks from
        the owner the router named.  Returns False when there is nothing
        worth fetching (prompt too short, already cached locally, or the
        owner is this replica): the caller submits normally.  Otherwise
        the request PARKS until the import lands or the fallback timer
        fires; either way it is submitted exactly once."""
        from ..pipeline.codec import encode_swag
        if kv_source == self.topic_path:
            return False
        keys = self.server.prefix_keys_hex(request.prompt)
        local = self.server.prefix_local_depth(request.prompt)
        # A migration also asks for the chain's tail, however few blocks
        # it lacks here.
        tail = migrate and hasattr(self.server, "migration_tail_rows")
        if not tail and (not keys or local >= len(keys)):
            return False
        self._kv_counter += 1
        token = f"kvf{self._kv_counter}"
        self._kv_pending[token] = request
        self._kv_started[token] = time.monotonic()
        swag = {"kv_keys": keys[local:], "kv_start_depth": local}
        if migrate:
            # Marks the export as a live-migration transfer (the
            # ``drop_migration_block`` fault point keys off it).
            swag["kv_migrate"] = 1
        if tail:
            # The resume's whole prompt names the live request whose tail
            # rows the source ships with the blocks.
            swag["kv_tail_chain"] = np.asarray(request.prompt, np.int32)
        if request.trace_ctx:
            swag["trace"] = request.trace_ctx
        self.process.message.publish(
            f"{kv_source}/in",
            generate("kv_export",
                     [token, self._kv_topic, encode_swag(swag)]))
        self.process.event.add_timer_handler(
            lambda: self._kv_fetch_timeout(token),
            self.kv_fetch_timeout_s, once=True)
        return True

    def _kv_fetch_timeout(self, token: str):
        """The owner never answered (dead, partitioned, or slow): fall
        back to plain local prefill, counted in ``kv_transfer_failures``.
        Runs on the engine thread (a timer)."""
        request = self._kv_pending.pop(token, None)
        started = self._kv_started.pop(token, None)
        if request is None:
            return                    # the import landed first
        if started is not None:
            request.kv_restore_ms = round(
                (time.monotonic() - started) * 1e3, 3)
        self.server.kv_transfer_failures += 1
        self.logger.warning("%s: kv fetch %s timed out — local "
                            "prefill fallback", self.name, token)
        self.server.submit(request)
        self._ensure_pumping()

    def _on_kv_message(self, _topic: str, payload: str):
        """``(kv_export_response token swag)`` from the owner: import,
        then submit the parked request (the admission hit walk adopts the
        imported blocks).  Message handlers run on the engine thread, so
        the import's host work does too; its rows land in later steps."""
        from ..pipeline.codec import decode_swag
        try:
            command, params = parse(payload)
        except Exception:  # noqa: BLE001 - not ours to answer
            return
        if command != "kv_export_response" or len(params) < 2:
            return
        request = self._kv_pending.pop(str(params[0]), None)
        started = self._kv_started.pop(str(params[0]), None)
        if request is None:
            return                    # timed out already; late reply
        try:
            outputs = decode_swag(params[1])
            if "error" in outputs:
                self.server.kv_transfer_failures += 1
            else:
                if hasattr(self.server, "migration_tail_from_payload"):
                    request.kv_tail = \
                        self.server.migration_tail_from_payload(outputs)
                # Async landing: the keys register behind the RESTORING
                # sentinel now, the rows land a few blocks a step; the
                # submit below parks on the hit walk's restore wait until
                # the chain is whole.  A tail-only answer has no keys.
                if len(outputs.get("kv_keys", ())):
                    self.server.kv_import_payload(
                        outputs, engine=self.process.event,
                        async_import=True)
                remote = outputs.get("trace_spans")
                if remote:
                    request.remote_spans = str(remote)
        except Exception:  # noqa: BLE001 - fall back to local prefill
            self.logger.exception("%s: kv import failed", self.name)
            self.server.kv_transfer_failures += 1
        if started is not None:
            request.kv_restore_ms = round(
                (time.monotonic() - started) * 1e3, 3)
        self.server.submit(request)
        self._ensure_pumping()

    def _wire_cancel(self, request_id, response_topic=None):
        """``(infer_cancel request_id [response_topic])``: the
        cancelled request's normal ``infer_response`` (error
        ``cancelled``, any partial tokens) is the acknowledgement.  An
        unknown id — already responded, or aged out — resolves the
        caller's future with ``error="cancel_unrouted"`` when a reply
        topic rides along (the true response may still arrive first;
        the client's terminal-state race rules apply)."""
        if self.server.cancel(str(request_id)):
            self._ensure_pumping()
            return
        self.logger.info("%s: infer_cancel for unknown id %s",
                         self.name, request_id)
        if response_topic:
            from ..pipeline.codec import encode_swag
            self.process.message.publish(
                str(response_topic),
                generate("infer_response",
                         [request_id,
                          encode_swag({"error": "cancel_unrouted"})]))

    def _stream_partials(self):
        """Deliver newly decoded tokens for every live streaming
        request — one ``(infer_partial request_id swag)`` per pump
        with the increment since the last delivery."""
        for request in self.server.live_requests():
            self._emit_partial(request)

    def _emit_partial(self, request: DecodeRequest):
        if not (request.stream and request.response_topic
                and request.tokens):
            return
        sent = self._stream_sent.get(id(request), 0)
        if len(request.tokens) <= sent:
            return
        from ..pipeline.codec import encode_swag
        increment = np.asarray(request.tokens[sent:], np.int32)
        self._stream_sent[id(request)] = len(request.tokens)
        self.process.message.publish(
            request.response_topic,
            generate("infer_partial",
                     [request.request_id,
                      encode_swag({"tokens_out": increment})]))

    def _respond(self, request: DecodeRequest):
        from ..pipeline.codec import encode_swag
        # Flush the final streaming increment first: concatenated
        # partials always equal the final sequence.
        self._emit_partial(request)
        self._stream_sent.pop(id(request), None)
        if request.request_id in self._migrating_ids:
            # The migrated-away request reached a terminal state here
            # (usually the post-cutover cancel): this replica is no
            # longer anyone's migration source.
            self._migrating_ids.discard(request.request_id)
            if not self._migrating_ids \
                    and self.share.get("lifecycle") == "migrating":
                self.share["lifecycle"] = "ready"
                if self.ec_producer is not None:
                    self.ec_producer.update("lifecycle", "ready")
        self.share["requests_served"] += 1
        if self.ec_producer is not None:
            self.ec_producer.update("requests_served",
                                    self.share["requests_served"])
        if request.error is not None:
            outputs: Dict = {"error": request.error}
            if request.error == "cancelled" and request.tokens:
                # Partial tokens are real work the client may keep.
                outputs["tokens_out"] = np.asarray(request.tokens,
                                                   np.int32)
            if request.retry_after_ms is not None:
                outputs["retry_after_ms"] = int(request.retry_after_ms)
        else:
            outputs = {"tokens_out": np.asarray(request.tokens,
                                                np.int32)}
        if request.spec_accepted_rounds is not None:
            # Per-round accepted-token counts (draft replicas only):
            # the client-side acceptance histogram loadgen A/B runs
            # aggregate without touching server internals.
            outputs["spec_accepted_rounds"] = np.asarray(
                request.spec_accepted_rounds, np.int32)
        served = request.error is None
        phases = self._phase_latencies(request)
        for phase, seconds in phases.items():
            outputs[f"{phase}_ms"] = round(seconds * 1e3, 2)
        if served:
            # Aggregates track SERVED requests only: a burst of
            # queued-then-cancelled requests must not drag the
            # dashboard's p50 toward zero.
            for phase, seconds in phases.items():
                self.server.latency_hists[phase].observe(seconds * 1e3)
            self._note_slow(request, phases)
        if request.trace_ctx:
            outputs["trace_spans"] = self._request_spans(request)
        if request.response_topic:
            encoded = encode_swag(outputs)
            if faults.PLAN is not None:
                if faults.PLAN.check("corrupt_response",
                                     key=request.request_id) is not None:
                    # Undecodable swag on the wire: the client resolves
                    # the future with error="corrupt_response".
                    encoded = "!corrupt!"
            self.process.message.publish(
                request.response_topic,
                generate("infer_response",
                         [request.request_id, encoded]))

    def _phase_latencies(self, request: DecodeRequest) -> Dict[str, float]:
        """Seconds per phase from the request's lifecycle stamps:
        ``queue`` (submit→slot), ``prefill`` (slot→first token),
        ``decode`` (first→finish), the classic end-to-end ``ttft`` /
        ``total``, and any ``kv_restore`` time (the warm-start fetch
        runs BEFORE submission, so it is invisible to — not double-
        counted by — the queue phase).  Keys match the server's
        ``latency_hists`` phases and respond as ``<phase>_ms``."""
        out: Dict[str, float] = {}
        if request.submitted_ts is None:
            return out
        if request.first_token_ts is not None:
            out["ttft"] = request.first_token_ts - request.submitted_ts
        if request.finished_ts is not None:
            out["total"] = request.finished_ts - request.submitted_ts
        if request.activated_ts is not None:
            out["queue"] = request.activated_ts - request.submitted_ts
            if request.first_token_ts is not None:
                out["prefill"] = (request.first_token_ts
                                  - request.activated_ts)
                if request.finished_ts is not None:
                    out["decode"] = (request.finished_ts
                                     - request.first_token_ts)
        if request.kv_restore_ms:
            out["kv_restore"] = request.kv_restore_ms / 1e3
        return out

    _SLOW_K = 5

    def _note_slow(self, request: DecodeRequest,
                   phases: Dict[str, float]) -> None:
        """Track the top-k slowest served requests with their phase
        breakdown — the dashboard's \"slowest requests\" pane."""
        total = phases.get("total")
        if total is None:
            return
        self._slow.append((round(total * 1e3, 1), request.request_id,
                           {phase: round(seconds * 1e3, 1)
                            for phase, seconds in phases.items()}))
        self._slow.sort(key=lambda entry: -entry[0])
        del self._slow[self._SLOW_K:]

    def _request_spans(self, request: DecodeRequest) -> str:
        """Synthesize this replica's phase spans for a TRACED request
        (``trace_ctx`` arrived on the wire) from its lifecycle stamps
        — no tracer calls anywhere near the engine hot path, and an
        untraced request pays exactly one ``is None`` test.

        The monotonic stamps convert to the epoch-aligned span clock
        through one wall-clock anchor taken here; sub-ms skew at
        worst, far below the cross-process clock sync the tree
        already tolerates."""
        from ..obs import trace
        offset = time.time() - time.monotonic()
        spans = []
        if request.submitted_ts is not None:
            submitted = offset + request.submitted_ts
            finished = offset + (request.finished_ts
                                 or request.submitted_ts)
            restore_s = request.kv_restore_ms / 1e3
            replica_span = trace.synth_span(
                "replica", request.trace_ctx, self.name,
                submitted - restore_s, finished,
                attrs={"request_id": request.request_id,
                       "tokens_out": len(request.tokens or [])})
            if request.error is not None:
                replica_span.set_attr("error", request.error)
            spans.append(replica_span)
            parent = trace.inject(replica_span)
            if restore_s:
                spans.append(trace.synth_span(
                    "kv_restore", parent, self.name,
                    submitted - restore_s, submitted))
            if request.activated_ts is not None:
                activated = offset + request.activated_ts
                spans.append(trace.synth_span(
                    "queue", parent, self.name, submitted, activated))
                if request.first_token_ts is not None:
                    first = offset + request.first_token_ts
                    spans.append(trace.synth_span(
                        "prefill", parent, self.name, activated,
                        first))
                    decode_span = trace.synth_span(
                        "decode", parent, self.name, first, finished)
                    decode_span.mark("first_token", first)
                    decode_span.mark("last_token", finished)
                    spans.append(decode_span)
        encoded = [span.to_dict() for span in spans]
        if request.remote_spans:
            encoded.extend(span.to_dict() for span in
                           trace.decode_spans(request.remote_spans))
        return trace.encode_spans(encoded)
