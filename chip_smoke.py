#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of aiko_services_tpu on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Device: the card's name and power limit as nvidia-smi reports them;
   the port's CUDA kernels are built from aiko_services_tpu_torch/csrc
   (nvcc, sm_90a, one process per source) into
   aiko_services_tpu_torch/_build/.
2. Kernels: each hand-written kernel against its plain PyTorch version
   computed in f32 on the same inputs, on the card, at the main path's
   llama3_8b shapes: max abs error and worst error over the per-element
   tolerance (TOL_REL, TOL_ROW below), the kernel's time, the plain
   version's time, the least time the card could take (bytes over
   3.35 TB/s or operations over 989 TFLOP/s) and, where one PyTorch call
   computes the same function, that call's time (the port never calls
   it).
3. Serving: llama3_8b with random int8 weights built on the card,
   ContinuousBatchingServer with 8 slots and a 1024-row cache, bf16 KV
   then int8 KV: staggered requests of 64-700 prompt tokens, 32 new
   tokens each, every served token held against a batch-1 prefill +
   generate_tokens oracle on the card (teacher-forced past a near-tie),
   the kernels' launch counts held against the decode steps and the
   prefill dispatches of the run (the decode step's K/V write,
   write_kv_rows, once a layer a step).  The greedy steady chunks serve
   through captured CUDA graphs (llama.ChunkGraph, the servers' default
   on the card; a replay counts the launches its capture made, so the
   counts stay exact), and the run must replay some.  Then, after the
   bf16-KV run (the int8-KV runs of phases 3, 4 and 6 have none, to make
   room for phase 12), a full-batch
   steady decode window (steady_decode): once the steady chunk is
   captured the capture ledger's fence drops, and the same server decodes
   in turns with its graphs on and off, timed bare; the eager path under
   cProfile (host functions; the K/V write's host microseconds a call)
   and under torch.profiler (device time by kernel, kernels a step, and
   no per-layer index_put_ left in the step; int8_matmul's time per step
   in the kernel line is read from it); the graphed path under
   torch.profiler (kernels a replay, busy share) and with CUDA events
   around the replays; no capture after the fence.  Then phase 6's
   64-slot run on these int8 weights, for the comparison with int4.
4. Paged serving: the same weights through PagedContinuousServer (8
   slots, 4096-row tables of 16-row blocks, the default 1,024-block pool,
   prefix cache on, 256-token chunked admission), bf16 KV then int8 KV:
   12 requests in three waves (a shared 1,024-token prefix, distinct
   prompts of 64-1,800 tokens, re-submissions), every served token held
   to a batch-1 oracle (bf16: contiguous prefill + decode; int8: a
   batch-1 paged run with the prefix cache off), launches of every kernel
   held to the decode steps and prefill slices, prefix hits > 0, the pool
   balanced after the drain, then (bf16 KV) phase 3's steady decode
   window at positions ~1,025-1,120; then that window at 64 slots (512-row tables,
   bf16 KV, 128-token prompts).
5. Speculative serving: phase 4's server with spec_k = 4 (SPEC_RUNS):
   bf16 KV with a paired draft (the target as its own draft), the int8
   1b draft under the adaptive controller at int8 KV, then the paired
   draft at int8 KV (n-gram self-drafting on this server shape: phase 13
   (b)), every greedy token held to phase 4's oracle and the verify's
   launches held to the spec rounds; the bf16-KV paired run with its
   steady window.
6. int4 weights: llama3_8b with random int4 weights built on the card
   (int8 embedding), through the contiguous server (phase 3's traffic
   and steady window, then 64 slots at the JAX bench's int4 shape:
   prompt 128, 128 new tokens), the paged server (phase 4's traffic,
   bf16 and int8 KV) and a short paired-draft speculative run (the
   verify at m = 40 and the resync at m = 32 through the int4 kernel),
   each held as phases 3-5 are, the launches of both int4 instances exact
   (every prefill slice of m > 64 through the m-tiled one), TTFT p50
   printed beside the int8 runs', and the 64-slot steady step's weight
   matmul ms beside its device ms (int4 and int8), and the paged 64-slot
   steady window.  One line a steady window then sets the graphed step
   beside the eager one (ms, tok/s, busy share, kernels a replay or a
   step) for 8 and 64 slots, int8 and int4, contiguous and paged.
7. The ring collective matmuls (parallel/rdma_collective.py): four ranks
   on this card, each with its own compute and copy streams, at
   llama3_8b's TP-4 MLP shapes in bf16 (the w_gate all-gather and the
   w_down reduce-scatter, m = 2048 and 64), then the JAX tests' shapes on
   eight ranks in f32 and bf16, each against the plain version (the same
   schedule with torch.mm in f32); R^2 step launches and R(R - 1) copies
   a call; a rank slowed on purpose still gives the right result.
8. The wire (run after phase 5, while phase 4's int8 weights are still on
   the card): phase 4's traffic and budgets through InferClient ->
   ContinuousReplica -> PagedContinuousServer (8 slots, 4096-row tables
   of 16-row blocks, prefix cache, 256-token slices, bf16 KV) on a
   loopback broker, the engine in its own thread; three requests stream
   and a 13th is cancelled after its first partial.  Every request must
   be answered (no error, no timeout, no command failure in the log),
   every greedy token held to phase 4's oracle, concatenated partials
   equal to tokens_out, the cancelled request answered "cancelled" with
   its partial tokens, graphed chunks replayed with no capture after the
   warm-up fence, the launches exact, the (metrics) scrape naming the
   server's counters, the replica idle with requests_served 13.  The
   same traffic also runs driven by step() on the caller's thread, on a
   server warmed the same way: a wire turn, then a direct one
   (WIRE_TURNS; scripts/smoke_wire.py runs a pair of each, alternating),
   each on a fresh server, every wire turn with every check but the
   oracle (the first one only).  End to end it prints
   what the caller sees on its own clock, each turn and the spread over
   turns: TTFT p50 / max over the four requests that stream,
   send-to-answer p50 / max over the 12 that finish, served tok/s, and
   the wire's own time a request (send-to-answer less total_ms).  The
   servers' own stamps (the responses' *_ms fields, which start at the
   server's submit and so leave out the wire's time) are printed as the
   server layer's, beside phase 4's direct step() run.  After the first
   wire turn's traffic, with a flight recorder, the capture ledger and
   the pool auditor installed: (profile 4) must answer started, two
   requests carry the bracket, whose manifest must carry device ms a
   step by CUDA events; (census) must answer a bundle path whose bundle
   has the census, profile and compiles sections, and tools/doctor
   renders it (wire_observability).
9. The KV tiers and the KV wire (run after phase 8, on phase 4's int8
   weights), bf16 KV then int8 KV, on phase 4's server shape: (a) a pool
   of TIER_POOL blocks with a host tier: later waves demote the shared
   1,024-token prefix's chain, and its re-submission restores it
   TIER_RATE blocks a step while two other slots decode; (b) a small host
   tier over a temporary spill directory (removed at the end): the
   prefix's chain overflows to disk, a fresh server adopts the directory
   and serves the prefix from disk; (c) replicas A and B on one loopback
   broker, their engine in its own thread: A serves the prefix, and a
   fresh B a turn serves it with another tail, with kv_source = A (warm)
   or without (cold) (KV_TURNS), printing TTFT and, for a
   warm turn, the export, wire and import ms, the payload bytes and the
   MB/s; (d) migrate_prepare for a request A streams, answered
   migrate_ready, and a fresh replica resumes prompt + committed tokens
   with kv_source = A and kv_migrate.  Every token is held to phase 4's
   oracle (each wire turn to the first warm turn's tokens), every import
   must land with no fall-back to local prefill (KV_FETCH_TIMEOUT_S), the
   restores and adoptions are counted, the five kernels' launches are
   held to the decode steps and prefill slices, and graph replays go on
   with no capture after the fence.  The pool auditor is installed over
   (a)'s server and each of (b)'s, before it is built, sweeping every
   step: no violation, and the tiers' blocks and bytes integrated from
   its flow counters equal the server's census.
10. The fleet (run after phase 9, on phase 4's weights): a Registrar, a
   ReplicaRouter and two ContinuousReplicas, each over its own phase-8
   server (warmed and fenced) on the one weight set, one loopback broker
   and one engine thread, driven by the port's loadgen rigs
   (tools/loadgen.py): (a) phase 4's 12 requests at FLEET_RATE_HZ,
   streamed, with prefix_alpha 1.0 then 0.0 (FLEET_TURNS), printing
   prefix_routed, the fleet's prefix hit rate, the KV hints and the
   caller's TTFT and tok/s; (b) run_chaos, seed 1 (replica_a killed
   mid-decode, two partials dropped, a stalled step): zero lost, zero
   timeouts, one death, a re-dispatch; (c) run_migration_chaos: (migrate
   replica_a) while requests stream, against a control fleet, printing
   the cutover ms; (d) (a)'s traffic with replica_a prefill_only and the
   router disaggregated, each request's TTFT beside (a)'s first turn.
   Every token of (a), (b) and (d), and of (c)'s control, is held to
   phase 4's oracle; every final of (c) to its control bit for bit, each
   migrated request resumed on its source's own tail rows.  Each part's
   launches are held to its servers' steps and slices, and no server
   captures after its fence.
11. The elastic fleet (run after phase 10, on phase 4's weights): the
   FleetAutoscaler owns the replicas behind a Registrar and a
   ReplicaRouter, each replica over its own phase-8 server (warmed and
   fenced) on the one weight set, one loopback broker and one engine
   thread, driven by the port's loadgen rigs: (a) run_elastic_chaos, seed
   0 (three replicas, a scripted scale_target 2 drains decode1, decode3
   killed mid-decode, its replacement's first spawn failed and the retry
   slow-started): lost 0, timeouts 0, no duplicated final or stream
   mismatch, converged to the target, drains completed, spawn failures,
   slow starts and deaths observed; (b) run_rolling_upgrade with two
   replicas in UPGRADE_TURNS (one live-migration turn, one drain turn):
   both replicas
   replaced a turn, a migration started in every migrating turn and each
   completed one resumed on its source's tail rows, every migrated final
   bit-exact against the drain turn's; (c) run_restart_ab in
   RESTART_TURNS pair: the only replica killed after its warm-up and
   respawned cold and warm (adopting its spill directory), the arms
   bit-exact, warm adopting chains and restoring from disk, cold adopting
   none, no checksum failed, warm's hit rate above cold's, the respawn
   warmed and fenced as it is built.  Every final of (a), of (b)'s drain
   turns and of (c)'s cold arms is held to phase 4's oracle; each part's
   launches to its servers' steps and slices; no server captures after
   its fence.  Prints
   the drain and respawn times, the upgrade's wall time and goodput a
   turn, TTFT mean and p50 an arm, and the peak device memory.

12. The contiguous layout's residue and the standalone loops (run after
   phase 5, on phase 4's int8 weights and phase 5's int8 1b draft): a
   route check first, the chunked forwards' append_kv_ragged +
   chunk_attention on a contiguous cache seen as a degenerate block pool
   (CONTIG_CASES: verify windows across block edges with an inactive slot
   that must write nothing, an admission chunk, the standalone verify and
   resync) byte- and tolerance-equal to the plain path; (a)
   ContinuousBatchingServer at phase 3's shape and traffic with spec_k = 4
   (CONTIG_RUNS: a paired draft with 256-token chunked admission, a paired
   draft with int8 KV, the 1b draft under the adaptive controller with
   int8 KV, n-gram), every greedy token held to phase 3's oracle,
   chunk_attention and append_kv_ragged launches held to (verify passes +
   prefill chunks) x 32 + resyncs x the draft's layers, the paired draft
   above one token a target pass; (b) speculative_generate (1b draft, a
   256-token prompt, 64 tokens, 512-row caches) held to the oracle and
   beside complete(), itself equal to prefill + generate_tokens, the
   sampled loop at 0.8 in the vocabulary and at 0 (given an unaligned
   max_seq of 511) the greedy loop, launches held to the prefill_chunk
   calls, and complete() at an unaligned 289 rows (rounded up to 384)
   launching the decode kernels once a layer a step; (c) mistral_7b (window
   4,096, int8 weights built on the card and freed) at batch 2, a
   4,352-token prompt, 32 greedy tokens on a rolling cache (the plain
   masked decode attention, by layout; the decode write kernel on the ring)
   held to a plain 4,384-row cache (the decode kernel with the window), and
   both caches' memory.
   Prints each part's seconds.
13. Grammars and adapters (run after phase 11, on phase 4's int8
   weights; GRAMMAR_LORA_PARTS, scripts/smoke_grammar_lora.py runs it
   alone): (a) constrained_generate at phase 3's contiguous shape (8 rows
   of 256 tokens, 16 steps) masked by loadgen's command automaton at
   llama3_8b's vocabulary: every row grammatical then padded, every token
   the masked batch-1 oracle's within TIE_GAP, the launches one prefill's
   and 15 decode steps'; (b) run_structured on two phase-4-shaped
   replicas handed in, n-gram speculation with spec_k = 4 and the
   automaton as "cmd", 24 requests constrained then free: every
   constrained final grammatical, jump-forward tokens committed,
   constrained tokens held to the masked oracle and free ones to phase
   4's, the launches the rounds' and slices' (no decode step), then 8
   sampled constrained requests at 0.9 grammatical; tokens/s constrained
   against free printed as a figure; (c) a phase-4-shaped server with four
   rank-8 tenants on wq / wv (non-zero B) loaded at run time (their pages
   in the pool) on phase 4's 12 requests, every fifth on the base: base
   rows bitwise the tokens of phase 4's bf16-KV run (an adapter-free
   server of the same shape on the same schedule), adapter rows held to a
   batch-1 oracle under their adapter, launches by phase 4's formula; a
   steady 8-slot graphed window with adapters (step ms beside phase 4's
   base step, no capture after the fence); tenant-0 unloaded, its pages
   demoted to the host tier, warm-loaded from them and its request served
   again to the same tokens; adapter_load / adapter_unload over the wire
   with packed factor bytes (no safetensors needed); (d) run_multitenant
   aware then blind on two replicas handed in (each warmed under its home
   tenants and fenced): 0 cold starts aware, at least one blind, every
   final held to its tenant's oracle, launches per fleet part.
14. Mixture-of-experts (run after phase 6 frees its weights; MOE_PARTS,
   scripts/smoke_moe.py runs it alone): mixtral_8x7b at its full width
   (d 4,096, 32 / 8 heads, d_ff 14,336, 8 experts, top-2, cf 4.0, vocab
   32,000, rope theta 1e6) cut to MOE_LAYERS of its 32 layers (its bf16
   experts are 2.82 GB a layer: 32 layers do not fit the card), random
   weights from seed 0 through init_params + quantize_params (int8 and
   int4 attention and LM head on the same bf16 experts).  The router's
   f32 products (N = 8: no kernel shape) against the CPU's, with TF32
   staying off; (a) ContinuousBatchingServer, 8 slots, 1,024 rows, eight
   requests of 40-512 tokens in two waves, then the steady 8-slot window
   (step ms beside the bound: the weights a step reads over 3.35 TB/s);
   (b) PagedContinuousServer, 16-row blocks, prefix cache, 256-token
   slices, four requests sharing a 512-token prefix, mixed steps; (c)
   (a)'s server with the dense small config as draft, spec_k = 4; (d) the
   int4 tree through (a)'s server.  Every token is held by TIE_GAP to a
   batch-1 oracle at the served shapes (the request alone, prefilled as
   the server prefills it, then decode steps, or (c)'s verify windows, of
   8 rows with the request in its served slot): a MoE layer routes every
   token of a call, so a bf16 oracle at batch 1 would round the experts'
   products otherwise and reroute near-tied tokens.  Launches by the
   phases' formulas, prefix hits and a balanced pool in (b), no capture
   after the fence, peak device memory under 80 GB.
15. The vision-LLM pipeline (run after phase 14 frees its weights):
   examples/vision_llm's graph
   and element names through the port's Pipeline (compose_instance(
   Pipeline, pipeline_args(...)), what the CLI wraps), with the port's
   module paths and no device given: ImageNormalize, VisionEncoderElement
   (clip_base) and DetectorElement (yolo_n) fused into one stage captured
   as a CUDA graph, the example's PromptBuilder (this script's copy),
   LlamaChatElement (llama3_8b, random int8 weights from seed 0, 32 new
   tokens); one warm-up frame, then 8 seeded 224 x 224 uint8 images on one
   stream with device_metrics_interval 2.  Held: the stage captured once
   and replayed every frame, each frame's stage outputs bitwise the same
   elements run eagerly on the card, each tokens_out the greedy prefill +
   generate_tokens oracle's on the element's params, the launches of
   flash_attention, paged_decode_attention, int8_matmul and write_kv_rows
   over the 8 frames exactly the prefills' and decode steps', one
   DevicePrefetcher pass over the images equal to the host arrays.
   Prints frames/s, time_{stage} and time_{stage}_device per stage, the
   chat's tokens_per_second.

The batch-1 oracles of phases 3, 4 (bf16 KV) and 6 walk side by side
(lockstep_results: each request prefilled alone, then one decode step a
token for all of them, each row computed as it is alone), as the wide
runs' do.

Phase 2 holds int8_matmul at every projection width and m = 1, 8, 40
(the verify of 8 slots x 5) and 64, with torch._weight_int8pack_mm as
its library call.  It also holds int4_matmul (both numerics: scale after
each group, the path's; and scale first) at every projection width and
m = 1, 8, 40, 64 against its plain version (the int4 kernel lab's shapes at m = 64
printed on their own line), and its m-tiled instance at m = 256 and
2,048, there also to the tighter TIGHT_REL / TIGHT_ROW; chunk_attention
at every admission slice and the verify shape, each with SDPA and the
bound beside it; flash_attention
at batch 1 (64-1,024 tokens) and at the 64-slot admission shape (64 rows
of 128 tokens); paged_decode_attention on the contiguous server's
128-row blocks and on the paged server's 16-row blocks at 8 and 64 rows;
the KV writer's three modes byte-equal to their plain versions:
append_kv at every admission slice, append_kv_ragged at every verify
window, and write_kv_rows (the decode step's K/V write, through the
functions the serving path calls) at 8 and 64 slots of the paged
server's 16-row blocks and on the contiguous caches of phase 3 (8 x
1,024 rows) and of the 64-slot run (64 x 512), bf16 and int8 KV, each
beside two index_put_ calls; and past the end, slot 0 at max_seq - 1,
max_seq and max_seq + 3 on the 8-slot pool (the row dropped) and cache
(clamped to the last row), byte-equal to the plain version.

The line before the last is one JSON object with every kernel's
numbers; the last line is {"ok": true, "device": {...}}.  Without a CUDA
card, or without the repository beside it, the script exits non-zero
and prints no result.
"""

import contextlib
import dataclasses
import gc
import json
import logging
import math
import os
import queue
import subprocess
import sys
import time
import types

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12            # dense bf16 tensor-core peak
SLOTS, MAX_SEQ, NEW_TOKENS = 8, 1024, 32
#: Decode steps per dispatched chunk.  Each step is its own host loop
#: iteration on this backend, so a short chunk costs no extra host work
#: and bounds how long a first token waits behind the in-flight ring.
CHUNK_STEPS = 2
#: Prompt lengths of the served requests.  The 64-token prompt prefills
#: at m = 64, where every projection takes the int8 kernel, as the JAX
#: package's does at b * bucket <= 64; the rest take the matrix product.
PROMPTS = [64, 700, 128, 333, 512, 97, 640, 250, 180, 420]
#: A served token that is not the oracle's argmax is accepted only where
#: its oracle logit is within this gap of the top one (prefill sub-batches
#: run the matrix product at another m than the oracle, in another
#: summation order).
TIE_GAP = 0.1
#: Per-element tolerance of a kernel against its plain version computed
#: in f32 on the same inputs: |got - want| <= TOL_REL * |want| + TOL_ROW
#: * max |want| over the element's row (last axis).  The kernels round
#: their f32 result to bf16 once (2^-9 * |want|); flash_attention also
#: rounds its softmax weights to bf16 for the P.V product (the JAX
#: reference rounds them to v.dtype), an error of about 2^-9 times the
#: spread of the row's outputs, hence the row term.  A kernel that drops
#: a key tile or misweights a block in the log-sum-exp merge moves an
#: output by a sizeable share of its row's spread, far past it.
TOL_REL, TOL_ROW = 2 ** -7, 2 ** -7


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr)
    sys.exit(1)


def log(message: str) -> None:
    print(message, flush=True)


# --------------------------------------------------------------------------- #
# Timing and bounds

def device_ms(torch, fn, reps: int, sleep_cycles: int = 100_000_000,
              timing=None) -> float:
    """Card time of one call of ``fn``: CUDA events around ``reps`` calls
    queued behind a device-side sleep (~50 ms at the card's clock by
    default), so the kernels run back to back and the host's launch path
    (slower than the smaller kernels) adds no gaps to the window.  With a
    dict ``timing``, also the host's enqueue ms a call (``host_ms``) and
    whether the sleep ended before the enqueue did (``host_bound``: the
    window then measured the host)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    began = time.perf_counter()
    for _ in range(reps):
        fn()
    if timing is not None:
        timing["host_ms"] = (time.perf_counter() - began) * 1e3 / reps
        timing["host_bound"] = start.query()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, rel=TOL_REL, row=TOL_ROW):
    """(max abs error, worst error over tolerance) of a kernel's ``got``
    against the f32 plain ``want``, per element (``rel`` * |want| +
    ``row`` * max |want| of the row)."""
    got, want = got.float(), want.float()
    magnitude = want.abs()
    tol = rel * magnitude + row * magnitude.amax(-1, keepdim=True)
    err = (got - want).abs()
    return float(err.max()), float((err / tol.clamp_min(1e-30)).max())


def projections(config):
    """(K, N) of every int8 projection a layer runs, in order.  A MoE
    layer's MLP is its router (N = n_experts, which no kernel instance
    takes: the f32 plain product, as in the JAX package) and bf16 expert
    products."""
    d, kvd = config.d_model, config.n_kv_heads * config.head_dim
    attention = [(d, config.n_heads * config.head_dim), (d, kvd), (d, kvd),
                 (config.n_heads * config.head_dim, d)]
    if config.n_experts:
        return attention + [(d, config.n_experts)]
    return attention + [(d, config.d_ff), (d, config.d_ff), (config.d_ff, d)]


class Weights:
    """The weight layout a serving run uses: ``matmul`` is the wrapper
    every projection goes through (``int8_matmul`` or ``int4_matmul``),
    ``rule(m, K, N)`` says whether it launches its kernel at that shape,
    ``rules`` maps the name of every kernel wrapper a projection may reach
    to its rule (int4: the m <= 64 instance and, where that does not take
    the shape, the m-tiled instance ``int4_matmul_tiled``), and
    ``trace_key`` names the kernel in a profiler trace."""

    def __init__(self, quant, bits: int):
        self.bits = bits
        if bits == 8:
            self.matmul, self.rule = quant.int8_matmul, quant.kernel_shape
            self.rules = {"int8_matmul": self.rule}
        else:
            self.matmul = quant.int4_matmul
            # llama3_8b's and 1b's K are multiples of 128: K // 128 groups.
            self.rule = lambda m, k, n: quant.int4_kernel_shape(
                m, k, n, max(1, k // 128))
            self.rules = {"int4_matmul": self.rule,
                          "int4_matmul_tiled": lambda m, k, n: (
                              not self.rule(m, k, n) and quant.tiles_int4(
                                  k, n, max(1, k // 128)))}
        self.name = self.matmul.__name__
        self.trace_key = f"{self.name}_kernel"
        self.label = f"int{bits}"


def matmul_launches(weights, config, rows: int, seq: int,
                    name=None) -> int:
    """Kernel launches of wrapper ``name`` (default ``weights.matmul``) in
    one forward pass over ``rows`` sequences of ``seq`` positions: the
    projections that take the kernel at m = rows * seq in every layer, and
    the LM head at each row's last position (m = rows)."""
    rule = weights.rules[name or weights.name]
    return (layer_launches(weights, config, rows * seq, name)
            + rule(rows, config.d_model, config.vocab_size))


def layer_launches(weights, config, m: int, name=None) -> int:
    """Kernel launches of wrapper ``name`` (default ``weights.matmul``) in
    every layer's projections at m rows (a prefill slice: the paged path
    computes no logits there)."""
    rule = weights.rules[name or weights.name]
    return config.n_layers * sum(rule(m, k, n)
                                 for k, n in projections(config))


class MatmulShapes:
    """Records (m, K, N, groups) of every int4 projection the model runs
    (``llama._matmul`` wrapped) while it is entered: the launches the
    shape rule predicts for a run whose forwards are not a closed formula
    of the server's counters (speculation)."""

    def __init__(self, llama, quant):
        self.llama, self.quant = llama, quant
        self.shapes = []

    def __enter__(self):
        inner = self._inner = self.llama._matmul

        def recorded(x, w):
            if self.quant.is_quantized_int4(w):
                khalf, n = w["q4"].shape
                self.shapes.append((x.numel() // (2 * khalf), 2 * khalf, n,
                                    w["s"].shape[0]))
            return inner(x, w)
        self.llama._matmul = recorded
        return self

    def __exit__(self, *exc):
        self.llama._matmul = self._inner

    def predicted(self):
        """{wrapper name: launches} of both int4 kernel instances."""
        small = [self.quant.int4_kernel_shape(*shape)
                 for shape in self.shapes]
        tiled = [not fits and self.quant.tiles_int4(*shape[1:])
                 for fits, shape in zip(small, self.shapes)]
        return {"int4_matmul": sum(small), "int4_matmul_tiled": sum(tiled)}


# --------------------------------------------------------------------------- #
# Phase 2: kernels against their plain versions

#: Rows of x in the int8 checks: batch-1 decode, the 8-slot decode batch,
#: phase 15's chat prefill (12 tokens, a part-filled 16-row instance), 16
#: and 32 (the 16- and 32-row instances full), the verify of k = 4 on 8
#: slots (8 x 5), and 64 (the 64-slot decode batch and the largest kernel
#: prefill): every row instance of the kernel (8, 16, 32, 64).
INT8_ROWS = (1, 8, 12, 16, 32, 40, 64)


def check_int8_matmul(torch, quant, device, config):
    """Every llama3_8b projection width and the LM head at m in INT8_ROWS.
    Weights rotate through enough copies to exceed the 50 MB
    L2, as a decode step finds them: cold.  Also probes
    ``torch._weight_int8pack_mm`` (bf16 x, int8 (N, K) weights, per-row
    scales in x's type) as the library call; if the card's PyTorch has
    no CUDA version of it, its error is reported instead of a time."""
    d, vocab, layers = config.d_model, config.vocab_size, config.n_layers
    counts = {}
    for k, n in projections(config):
        counts[(k, n)] = counts.get((k, n), 0) + layers
    counts[(d, vocab)] = 1
    names = {(d, d): "wq/wo", (d, config.n_kv_heads * config.head_dim):
             "wk/wv", (d, config.d_ff): "w_gate/w_up",
             (config.d_ff, d): "w_down", (d, vocab): "lm_head"}
    gen = torch.Generator(device=device).manual_seed(0)
    rows, worst, library_error = [], 0.0, None
    step = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                launches=sum(counts.values()))
    for (k, n), per_step in counts.items():
        name = names[(k, n)]
        copies = max(1, math.ceil(256e6 / (k * n)))
        weights = [{"q": torch.randint(-127, 128, (k, n), generator=gen,
                                       device=device, dtype=torch.int8),
                    "s": torch.rand((1, n), generator=gen, device=device)
                    * (k ** -0.5 / 64)} for _ in range(copies)]
        if library_error is None:
            for w in weights:
                w["qt"] = w["q"].t().contiguous()
                w["st"] = w["s"].flatten().to(torch.bfloat16)
        for m in INT8_ROWS:
            x = torch.randn((m, k), generator=gen, device=device) \
                .to(torch.bfloat16)
            w = weights[0]
            got = quant.int8_matmul(x, w["q"], w["s"])
            want = quant.int8_matmul_reference(x.float(), w["q"], w["s"])
            torch.cuda.synchronize()
            err, ratio = compare(got, want)
            if not ratio <= 1.0:
                fail(f"int8_matmul {name} m={m}: max abs err {err}, "
                     f"err/tol {ratio}")
            worst = max(worst, ratio)
            turn = iter(range(10 ** 9))

            def kernel():
                w = weights[next(turn) % copies]
                quant.int8_matmul(x, w["q"], w["s"])

            def plain():
                w = weights[next(turn) % copies]
                quant.int8_matmul_reference(x, w["q"], w["s"])

            def library():
                w = weights[next(turn) % copies]
                return torch._weight_int8pack_mm(x, w["qt"], w["st"])

            library_ms = library_err = None
            if library_error is None:
                try:
                    library_err = float((library().float() - want)
                                        .abs().max())
                    library_ms = device_ms(torch, library, 20)
                except Exception as error:   # no CUDA kernel for the op
                    library_error = f"{type(error).__name__}: {error}"
                    for w in weights:
                        w.pop("qt", None)
                        w.pop("st", None)
            ms = device_ms(torch, kernel, 20)
            plain_ms = device_ms(torch, plain, 4)
            b_ms, b_by = bound(k * n + 4 * n + 2 * m * k + 2 * m * n,
                               2 * m * k * n)
            rows.append(dict(shape=f"{name} m={m} K={k} N={n}", m=m, k=k,
                             n=n, err=err, ratio=ratio, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms, library_err=library_err))
            if m == SLOTS:
                step["ms"] += per_step * ms
                step["plain_ms"] += per_step * plain_ms
                step["bound_ms"] += per_step * b_ms
                if library_ms is not None:
                    step["library_ms"] += per_step * library_ms
        del weights
    if library_error is not None:
        step["library_ms"] = None
    step["library_error"] = library_error
    return rows, worst, step


#: Rows of x in the int4 checks: batch-1 decode, the 8-slot decode batch,
#: the verify of k = 4 on 8 slots, and 64 (the 64-slot decode batch, the
#: kernel's largest m).
INT4_ROWS = (1, 8, 40, 64)
#: Rows of x in the checks of the m-tiled int4 instance: a 256-token prefill
#: slice (the paged server's chunk) and a 2,048-row prefill.
TILED_ROWS = (256, 2048)
#: (K, N) of the int4 kernel lab's shapes (w_gate/w_up, w_down, wq/wo),
#: which phase 2 times at m = 64 among its rows.
INT4_LAB_SHAPES = ((4096, 14336), (14336, 4096), (4096, 4096))
#: The scale-after numerics, held tighter than TOL_REL / TOL_ROW: the
#: kernel's f32 result differs from the f32 plain version by summation
#: order only, so its bf16 output is within its own rounding (2^-8 of
#: |want|) plus 2^-14 of the row's largest output.  bf16(q * s) weights
#: (scale first, 2^-8 a weight) miss that several times over near zero.
TIGHT_REL, TIGHT_ROW = 2 ** -8, 2 ** -14


def int4_library(torch, quant, w):
    """``torch._weight_int4pack_mm``'s weight for the int4 leaf ``w``: its
    own packing of the nibbles plus 8 as uint8 (N, K/2) (even k in the
    high nibble), converted to its tiled layout, and bf16 (scale, zero 0)
    pairs.  It dequantizes (q + 8 - 8) * bf16(s): another function than
    ``int4_matmul`` to the bit (bf16 scales, its own summation)."""
    codes = quant._unpacked_rows(w["q4"]).t() + 8                 # (N, K)
    packed = ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8)
    tiled = torch._convert_weight_to_int4pack(packed.contiguous(), 8)
    scales = w["s"].to(torch.bfloat16)
    pairs = torch.stack([scales, torch.zeros_like(scales)], dim=-1)
    return tiled, pairs.contiguous()


def check_int4_matmul(torch, quant, device, config):
    """int4_matmul (scale after each group, the path's numerics) and its
    scale-first instance, each against its own f32 plain version, at every
    llama3_8b projection width and the LM head, m in INT4_ROWS; and
    int4_matmul at m in TILED_ROWS, which must launch the m-tiled instance
    and hold the plain version to TIGHT_REL / TIGHT_ROW as well.  The
    packed bytes are drawn uniformly from all 256 values (nibbles -8..7)
    with 128-row groups, and rotate through enough copies to exceed the
    50 MB L2, as a decode step finds them: cold.  Library calls, timed
    beside the kernel (the port never makes them):
    ``torch._weight_int4pack_mm`` on its own packing (its error instead
    of a time where the card's PyTorch has no CUDA kernel for it) and the
    large-m route, dequantize to bf16 + ``torch.mm``."""
    d, vocab, layers = config.d_model, config.vocab_size, config.n_layers
    counts = {}
    for k, n in projections(config):
        counts[(k, n)] = counts.get((k, n), 0) + layers
    counts[(d, vocab)] = 1
    names = {(d, d): "wq/wo", (d, config.n_kv_heads * config.head_dim):
             "wk/wv", (d, config.d_ff): "w_gate/w_up",
             (config.d_ff, d): "w_down", (d, vocab): "lm_head"}
    variants = {"after": (quant.int4_matmul, quant.int4_matmul_reference),
                "first": (quant.int4_matmul_scale_first,
                          quant.int4_matmul_scale_first_reference)}
    tiled_variant = {"tiled": (quant.int4_matmul, quant.int4_matmul_reference)}
    gen = torch.Generator(device=device).manual_seed(10)
    rows, worst, library_error = [], 0.0, None
    steps = {key: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                       dequant_mm_ms=0.0, launches=sum(counts.values()))
             for key in variants}
    # One layer's seven projections at m = TILED_ROWS[-1] through the
    # m-tiled instance (a prefill's per-layer matmul time).
    steps["tiled"] = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                          dequant_mm_ms=0.0,
                          launches=sum(counts.values()) // layers)
    for (k, n), per_step in counts.items():
        name, groups = names[(k, n)], k // 128
        copies = max(1, math.ceil(256e6 / (k * n // 2)))
        weights = [{"q4": torch.randint(-128, 128, (k // 2, n), generator=gen,
                                        device=device, dtype=torch.int8),
                    "s": torch.rand((groups, n), generator=gen, device=device)
                    * (k ** -0.5 / 4)} for _ in range(copies)]
        if not all(int(torch.unique(w["q4"]).numel()) == 256
                   for w in weights):
            fail(f"int4 {name}: the packed bytes miss some of the 256 values")
        if library_error is None:
            try:
                for w in weights:
                    w["lib"] = int4_library(torch, quant, w)
            except Exception as error:   # no CUDA kernel for the op
                library_error = f"{type(error).__name__}: {error}"
        if library_error is not None:
            for w in weights:
                w.pop("lib", None)
        for m in INT4_ROWS + TILED_ROWS:
            tiled = m > 64
            if tiled and n == vocab:    # no prefill computes its logits so
                continue
            x = torch.randn((m, k), generator=gen, device=device) \
                .to(torch.bfloat16)
            turn = iter(range(10 ** 9))

            def library():
                w = weights[next(turn) % copies]
                return torch._weight_int4pack_mm(x, w["lib"][0], 128,
                                                 w["lib"][1])

            def dequant_mm():
                w = weights[next(turn) % copies]
                return torch.mm(x, quant.dequantize_int4(w, torch.bfloat16))

            library_ms = library_err = None
            if library_error is None:
                try:
                    want = quant.int4_matmul_reference(
                        x.float(), weights[0]["q4"], weights[0]["s"])
                    library_err = float((library().float() - want)
                                        .abs().max())
                    library_ms = device_ms(torch, library, 20)
                except Exception as error:
                    if tiled:       # the library call's own limit at large m
                        library_err = f"{type(error).__name__}: {error}"
                    else:
                        library_error = f"{type(error).__name__}: {error}"
                        for w in weights:
                            w.pop("lib", None)
            dequant_mm_ms = device_ms(torch, dequant_mm, 4)
            b_ms, b_by = bound(k * n // 2 + 4 * groups * n + 2 * m * k
                               + 2 * m * n, 2 * m * k * n)
            for key, (kernel_fn, plain_fn) in (
                    tiled_variant if tiled else variants).items():
                w = weights[0]
                before = quant.int4_matmul_tiled.launches
                got = kernel_fn(x, w["q4"], w["s"])
                want = plain_fn(x.float(), w["q4"], w["s"])
                torch.cuda.synchronize()
                err, ratio = compare(got, want)
                if tiled:
                    if quant.int4_matmul_tiled.launches != before + 1:
                        fail(f"int4_matmul {name} m={m} did not launch the "
                             "m-tiled instance")
                    ratio = max(ratio, compare(got, want, TIGHT_REL,
                                               TIGHT_ROW)[1])
                if not ratio <= 1.0:
                    fail(f"int4_matmul ({key}) {name} m={m}: max abs err "
                         f"{err}, err/tol {ratio}")
                worst = max(worst, ratio)

                def kernel():
                    w = weights[next(turn) % copies]
                    kernel_fn(x, w["q4"], w["s"])

                def plain():
                    w = weights[next(turn) % copies]
                    plain_fn(x, w["q4"], w["s"])

                ms = device_ms(torch, kernel, 5 if tiled else 20)
                plain_ms = device_ms(torch, plain, 2)
                rows.append(dict(
                    shape=f"{key} {name} m={m} K={k} N={n} G={groups}",
                    numerics=key, m=m, k=k, n=n, err=err, ratio=ratio, ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=library_ms, library_err=library_err,
                    dequant_mm_ms=dequant_mm_ms))
                if m == SLOTS or m == TILED_ROWS[-1]:
                    step = steps[key]
                    times = counts[(k, n)] // layers if tiled else per_step
                    step["ms"] += times * ms
                    step["plain_ms"] += times * plain_ms
                    step["bound_ms"] += times * b_ms
                    step["dequant_mm_ms"] += times * dequant_mm_ms
                    if library_ms is None:
                        step["library_missing"] = True
                    else:
                        step["library_ms"] += times * library_ms
        del weights
    for step in steps.values():
        if library_error is not None or step.pop("library_missing", False):
            step["library_ms"] = None
        step["library_error"] = library_error
    return rows, worst, steps


def _visible_pairs(q_len, k_len, window):
    total = 0
    for i in range(q_len):
        qpos = i + k_len - q_len
        lo = 0 if window is None else max(0, qpos - window + 1)
        total += qpos + 1 - lo
    return total


#: (batch, sequence, windows) of the phase-2 flash rows: phase 15's chat
#: prefill (12 tokens, a part-filled tile), admission buckets 64..1024 at
#: batch 1, then the 64-slot admission shape (64 rows of 128).
FLASH_CASES = [(1, 12, (None,)), (1, 64, (None, 256)),
               (1, 256, (None, 256)), (1, 1024, (None, 256)),
               (64, 128, (None,))]


def check_flash(torch, attention, device):
    """Admission prefill: llama3_8b heads (32 q, 8 kv, hd 128), batch 1,
    12 tokens (phase 15's chat prompt) and buckets 64..1024, window off
    and 256; and batch 64 at 128 tokens."""
    import torch.nn.functional as F
    gen = torch.Generator(device=device).manual_seed(1)
    h, kv, hd = 32, 8, 128
    rows, worst, main = [], 0.0, None
    for batch, seq, windows in FLASH_CASES:
        q = torch.randn((batch, h, seq, hd), generator=gen, device=device) \
            .to(torch.bfloat16)
        k = torch.randn((batch, kv, seq, hd), generator=gen, device=device) \
            .to(torch.bfloat16)
        v = torch.randn((batch, kv, seq, hd), generator=gen, device=device) \
            .to(torch.bfloat16)
        for window in windows:
            got = attention.flash_attention(q, k, v, window=window)

            def plain():
                # The wrapper's CPU path: K/V repeated to the query heads.
                return attention.attention_reference(
                    q, k.repeat_interleave(h // kv, 1),
                    v.repeat_interleave(h // kv, 1), window=window)

            want = attention.attention_reference(
                q.float(), k.float().repeat_interleave(h // kv, 1),
                v.float().repeat_interleave(h // kv, 1), window=window)
            torch.cuda.synchronize()
            err, ratio = compare(got, want)
            if not ratio <= 1.0:
                fail(f"flash_attention S={seq} window={window}: max abs "
                     f"err {err}, err/tol {ratio}")
            worst = max(worst, ratio)
            ms = device_ms(torch, lambda: attention.flash_attention(
                q, k, v, window=window), 20)
            plain_ms = device_ms(torch, plain, 3)
            if window is None:
                def library():
                    F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True)
            else:
                mask = attention._visible(seq, seq, window, device)

                def library():
                    F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, enable_gqa=True)
            library_ms = device_ms(torch, library, 10)
            pairs = batch * _visible_pairs(seq, seq, window)
            b_ms, b_by = bound(
                2 * batch * (2 * h * seq * hd + 2 * kv * seq * hd),
                4 * hd * h * pairs)
            row = dict(shape=f"b={batch} h=32 kv=8 S={seq} hd=128 "
                             f"window={window}", err=err, ratio=ratio, ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=library_ms)
            rows.append(row)
            if batch == 1 and seq == 1024 and window is None:
                main = row
    return rows, worst, main


def check_decode(torch, paged_attention, llama, device):
    """Every decode step: 8 rows x 8 kv heads x group 4 over a 1024-row
    contiguous cache viewed as 8 blocks of 128 (the server's degenerate
    pool), ragged positions incl. block edges, bf16 and int8 KV, window
    off and 256."""
    import torch.nn.functional as F
    gen = torch.Generator(device=device).manual_seed(2)
    kv, group, hd, bs = 8, 4, 128, 128
    bpr = MAX_SEQ // bs
    positions = torch.tensor([0, 127, 128, 300, 511, 640, 900, 1022],
                             dtype=torch.int32, device=device)
    tables = (torch.arange(SLOTS, dtype=torch.int32, device=device)[:, None]
              * bpr + torch.arange(bpr, dtype=torch.int32,
                                   device=device)[None, :])
    rows, worst, main = [], 0.0, None
    for quant_kv in (False, True):
        k = torch.randn((SLOTS * bpr, bs, kv, hd), generator=gen,
                        device=device)
        v = torch.randn((SLOTS * bpr, bs, kv, hd), generator=gen,
                        device=device)
        q = torch.randn((SLOTS, kv, group, hd), generator=gen,
                        device=device).to(torch.bfloat16)
        scales = {}
        if quant_kv:
            k, ks = llama._kv_quantize(k)
            v, vs = llama._kv_quantize(v)
            scales = dict(ks=ks, vs=vs)
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        for window in (None, 256):
            got = paged_attention.paged_decode_attention(
                q, k, v, tables, positions, window=window, **scales)

            def plain():
                return paged_attention.paged_decode_reference(
                    q, k, v, tables, positions, window=window, **scales)

            pools = (k, v) if quant_kv else (k.float(), v.float())
            want = paged_attention.paged_decode_reference(
                q.float(), *pools, tables, positions, window=window,
                **scales)
            torch.cuda.synchronize()
            err, ratio = compare(got, want)
            if not ratio <= 1.0:
                fail(f"paged_decode_attention int8={quant_kv} "
                     f"window={window}: max abs err {err}, err/tol "
                     f"{ratio}")
            worst = max(worst, ratio)
            ms = device_ms(
                torch, lambda: paged_attention.paged_decode_attention(
                    q, k, v, tables, positions, window=window, **scales),
                50)
            plain_ms = device_ms(torch, plain, 5)
            library_ms = None
            if not quant_kv:
                k_c = k.reshape(SLOTS, MAX_SEQ, kv, hd).transpose(1, 2)
                v_c = v.reshape(SLOTS, MAX_SEQ, kv, hd).transpose(1, 2)
                key = torch.arange(MAX_SEQ, device=device)[None, :]
                pos = positions.to(torch.int64)[:, None]
                mask = key <= pos
                if window is not None:
                    mask &= key > pos - window
                mask = mask[:, None, None, :]
                q_s = q.reshape(SLOTS, kv * group, 1, hd)
                library_ms = device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q_s, k_c, v_c, attn_mask=mask, enable_gqa=True), 20)
            keys = [min(int(p) + 1, window or 10 ** 9)
                    for p in positions.tolist()]
            elem = 1 if quant_kv else 2
            kv_bytes = sum(keys) * kv * hd * elem * 2
            if quant_kv:
                kv_bytes += sum(keys) * kv * 4 * 2
            io_bytes = 2 * SLOTS * kv * group * hd * 2 + SLOTS * 4 \
                + sum(-(-n // bs) for n in keys) * 4
            b_ms, b_by = bound(kv_bytes + io_bytes,
                               4 * hd * group * kv * sum(keys))
            row = dict(shape=f"B=8 kv=8 group=4 hd=128 bs=128 "
                             f"int8={quant_kv} window={window}", err=err,
                       ratio=ratio, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=library_ms)
            rows.append(row)
            if not quant_kv and window is None:
                main = row
    return rows, worst, main


#: Batches of the phase-2 block-size-16 decode rows: the paged server's 8
#: slots, and 64 rows (positions spread over 1,100-1,199 alike).
PAGED_DECODE_ROWS = (8, 64)


def check_decode_paged(torch, paged_attention, llama, device):
    """The paged server's decode step: rows at positions 1,100-1,199 over
    16-row blocks of shuffled 256-entry tables (block size 16: ~75 live
    blocks a row), 8 and 64 rows, bf16 and int8 KV, against the f32 plain
    version.  Library: SDPA with a boolean mask over each row's gathered
    live blocks (the gather not timed), bf16 only."""
    import torch.nn.functional as F
    gen = torch.Generator(device=device).manual_seed(6)
    kv, group, hd = 8, 4, 128
    live = 80     # table entries a row holds: 1,280 keys
    rows, worst = [], 0.0
    for n_rows in PAGED_DECODE_ROWS:
        if n_rows == SLOTS:
            positions = [1100, 1115, 1116, 1131, 1150, 1163, 1180, 1199]
        else:
            positions = [1100 + (37 * i) % 100 for i in range(n_rows)]
        positions = torch.tensor(positions, dtype=torch.int32, device=device)
        for quant_kv in (False, True):
            pool, table = paged_pool(torch, llama, device, gen, quant_kv,
                                     n_blocks=max(PAGED_MAX_SEQ // BLOCK * 4,
                                                  n_rows * live) + 1)
            # Distinct shuffled blocks for each row's 80 first entries (the
            # live ones), scratch block 0 past them, as the server's tables.
            ids = torch.randperm(pool["k"].shape[0] - 1, generator=gen,
                                 device=device)[:n_rows * live] + 1
            tables = torch.zeros_like(table).repeat(n_rows, 1)
            tables[:, :live] = ids.to(torch.int32).reshape(n_rows, live)
            q = torch.randn((n_rows, kv, group, hd), generator=gen,
                            device=device).to(torch.bfloat16)
            scales = {key: pool[key] for key in ("ks", "vs") if key in pool}
            got = paged_attention.paged_decode_attention(
                q, pool["k"], pool["v"], tables, positions, **scales)
            pools = (pool["k"], pool["v"]) if quant_kv else (
                pool["k"].float(), pool["v"].float())
            want = paged_attention.paged_decode_reference(
                q.float(), *pools, tables, positions, **scales)
            torch.cuda.synchronize()
            err, ratio = compare(got, want)
            if not ratio <= 1.0:
                fail(f"paged_decode_attention bs=16 rows={n_rows} "
                     f"int8={quant_kv}: max abs err {err}, err/tol {ratio}")
            worst = max(worst, ratio)
            ms = device_ms(
                torch, lambda: paged_attention.paged_decode_attention(
                    q, pool["k"], pool["v"], tables, positions, **scales),
                50)
            plain_ms = device_ms(torch, lambda: paged_attention
                                 .paged_decode_reference(
                                     q, pool["k"], pool["v"], tables,
                                     positions, **scales), 5)
            library_ms = None
            if not quant_kv:
                ids = tables[:, :live].long()
                k_view = pool["k"][ids].reshape(n_rows, live * BLOCK, kv,
                                                hd).transpose(1, 2)
                v_view = pool["v"][ids].reshape(n_rows, live * BLOCK, kv,
                                                hd).transpose(1, 2)
                key = torch.arange(live * BLOCK, device=device)
                mask = (key[None, :] <= positions.to(torch.int64)[:, None]) \
                    [:, None, None, :]
                q_s = q.reshape(n_rows, kv * group, 1, hd)
                library_ms = device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q_s, k_view, v_view, attn_mask=mask,
                        enable_gqa=True), 20)
                del k_view, v_view
            keys = sum(int(p) + 1 for p in positions.tolist())
            elem = 1 if quant_kv else 2
            moved = keys * kv * hd * elem * 2 + (keys * kv * 8 if quant_kv
                                                 else 0) \
                + 2 * n_rows * kv * group * hd * 2 + keys // BLOCK * 4
            b_ms, b_by = bound(moved, 4 * hd * group * kv * keys)
            rows.append(dict(shape=f"B={n_rows} kv=8 group=4 hd=128 bs=16 "
                                   f"positions 1100-1199 int8={quant_kv}",
                             err=err, ratio=ratio, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms))
            del pool
    return rows, worst


# The paged path's shapes: llama3_8b heads, 16-row blocks, a 4096-row table.
PAGED_MAX_SEQ, BLOCK, CHUNK = 4096, 16, 256
#: (cached prefix tokens, slice width) of the phase-2 paged rows: slices of
#: 16, 64 and 256 tokens over no prefix, a 1,024-token prefix hit and a
#: 1,792-token prefix.  The main row is the first slice of a prefix hit.
PAGED_CASES = [(c, t) for c in (0, 1024, 1792) for t in (16, 64, 256)]
PAGED_MAIN = (1024, 256)


def paged_pool(torch, llama, device, gen, quant_kv, kv=8, hd=128,
               n_blocks=PAGED_MAX_SEQ // BLOCK * 4 + 1):
    """A pool of random K/V (1,025 blocks unless told; bf16, or int8 from
    the plain quantizer) and one shuffled 256-entry block table."""
    k = torch.randn((n_blocks, BLOCK, kv, hd), generator=gen, device=device)
    v = torch.randn((n_blocks, BLOCK, kv, hd), generator=gen, device=device)
    if quant_kv:
        (k, ks), (v, vs) = llama._kv_quantize(k), llama._kv_quantize(v)
        pool = dict(k=k, v=v, ks=ks, vs=vs)
    else:
        pool = dict(k=k.to(torch.bfloat16), v=v.to(torch.bfloat16))
    ids = torch.randperm(n_blocks - 1, generator=gen, device=device) + 1
    tables = ids[:PAGED_MAX_SEQ // BLOCK].to(torch.int32)[None]
    return pool, tables


def plant_division_ties(torch, rows):
    """Fill the (n, hd) bf16 ``rows`` in place with vectors [m, m / 2, ...,
    m / 2], m a bf16 value for which (m / 2) / (m / 127) lands on a
    half-integer under IEEE division but not under a multiply by the
    scale's reciprocal: an int8 quantizer that multiplies rounds those
    codes otherwise than the plain one's true division."""
    import numpy as np
    bits = (np.arange(0x3F00, 0x4080, dtype=np.uint32) << 16) \
        .view(np.float32)
    scale, half = bits / np.float32(127), bits / np.float32(2)
    ties = bits[np.rint(half / scale)
                != np.rint(half * (np.float32(1) / scale))]
    m = torch.from_numpy(np.resize(ties, rows.shape[0])).to(rows.device)
    rows[:] = (m / 2)[:, None].to(rows.dtype)
    rows[:, 0] = m.to(rows.dtype)


def check_append(torch, pp, llama, device):
    """Every admission slice: the chunk's K/V (1, T, 8 kv heads, 128) into
    shuffled 16-row blocks after a cached prefix, bf16 and int8 pools,
    head 0's K vectors :func:`plant_division_ties`'s.  The kernel's pool
    must equal the plain version's byte for byte (the slices are whole,
    so both write the same blocks and nothing else).
    Library: two ``index_put_`` calls (K, V) with precomputed rows, bf16
    only (no single call quantizes)."""
    gen = torch.Generator(device=device).manual_seed(4)
    kv, hd = 8, 128
    rows, main = [], None
    for quant_kv in (False, True):
        pool, tables = paged_pool(torch, llama, device, gen, quant_kv)
        for cached, T in PAGED_CASES:
            k_new = torch.randn((1, T, kv, hd), generator=gen,
                                device=device).to(torch.bfloat16)
            v_new = torch.randn((1, T, kv, hd), generator=gen,
                                device=device).to(torch.bfloat16)
            plant_division_ties(torch, k_new[0, :, 0])
            meta = (torch.tensor([cached], dtype=torch.int32, device=device),
                    torch.tensor([T], dtype=torch.int32, device=device))
            got = {key: buf.clone() for key, buf in pool.items()}
            want = {key: buf.clone() for key, buf in pool.items()}
            pp.append_kv(k_new, v_new, got, tables, *meta)
            pp.append_kv_reference(k_new, v_new, want, tables, *meta)
            torch.cuda.synchronize()
            err = max(float((got[key].float() - want[key].float())
                            .abs().max()) for key in got)
            if not all(torch.equal(got[key], want[key]) for key in got):
                fail(f"append_kv int8={quant_kv} cached={cached} T={T}: "
                     f"pool differs from the plain version (max abs {err})")
            ms = device_ms(torch, lambda: pp.append_kv(
                k_new, v_new, got, tables, *meta), 50)
            plain_ms = device_ms(torch, lambda: pp.append_kv_reference(
                k_new, v_new, want, tables, *meta), 5)
            library_ms = None
            if not quant_kv:
                positions = torch.arange(cached, cached + T, device=device)
                flat_rows = (tables[0].long()[positions // BLOCK] * BLOCK
                             + positions % BLOCK)
                flat = {key: got[key].view(-1, kv, hd) for key in got}

                def library():
                    flat["k"].index_put_((flat_rows,), k_new[0])
                    flat["v"].index_put_((flat_rows,), v_new[0])
                library_ms = device_ms(torch, library, 20)
            elem = 1 if quant_kv else 2
            moved = 2 * T * kv * hd * 2 + 2 * T * kv * hd * elem \
                + (2 * T * kv * 4 if quant_kv else 0)
            b_ms, b_by = bound(moved, 0)
            row = dict(shape=f"T={T} cached={cached} kv=8 hd=128 bs=16 "
                             f"int8={quant_kv}", err=err, ratio=0.0, ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=library_ms)
            rows.append(row)
            if (cached, T) == PAGED_MAIN and not quant_kv:
                main = row
            del got, want
    return rows, main


def _chunk_pairs(cached, T, window):
    """(visible (query token, key) pairs, live keys) of one chunk."""
    pairs, first = 0, None
    for t in range(T):
        pos = cached + t
        lo = 0 if window is None else max(0, pos - window + 1)
        first = lo if first is None else first
        pairs += pos + 1 - lo
    return pairs, cached + T - first


def check_chunk(torch, pp, llama, device):
    """Every admission slice's attention: 32 query heads over 8 kv heads
    (hd 128) for slices of 16-256 tokens over 0-1,792 cached tokens in
    shuffled 16-row blocks, bf16 and int8 pools, window off and 256,
    against the f32 plain version.  Library: SDPA with a boolean mask over
    a pre-gathered bf16 view (the gather not timed); none for int8."""
    import torch.nn.functional as F
    gen = torch.Generator(device=device).manual_seed(5)
    kv, group, hd = 8, 4, 128
    rows, worst, main = [], 0.0, None
    for quant_kv in (False, True):
        pool, tables = paged_pool(torch, llama, device, gen, quant_kv)
        plain_pool = pool if quant_kv else {key: buf.float()
                                            for key, buf in pool.items()}
        for cached, T in PAGED_CASES:
            q = torch.randn((1, T, kv, group, hd), generator=gen,
                            device=device).to(torch.bfloat16)
            meta = (torch.tensor([cached], dtype=torch.int32, device=device),
                    torch.tensor([T], dtype=torch.int32, device=device))
            kv_limit = -(-(cached + T) // BLOCK)
            for window in (None, 256):
                got = pp.chunk_attention(q, pool, tables, *meta,
                                         window=window, kv_limit=kv_limit)
                want = pp.chunk_attention_reference(
                    q.float(), plain_pool, tables, meta[0], window=window)
                torch.cuda.synchronize()
                err, ratio = compare(got, want)
                if not ratio <= 1.0:
                    fail(f"chunk_attention int8={quant_kv} cached={cached} "
                         f"T={T} window={window}: max abs err {err}, "
                         f"err/tol {ratio}")
                worst = max(worst, ratio)
                ms = device_ms(torch, lambda: pp.chunk_attention(
                    q, pool, tables, *meta, window=window,
                    kv_limit=kv_limit), 20)
                plain_ms = device_ms(torch, lambda: pp.chunk_attention_reference(
                    q, pool, tables, meta[0], window=window), 3)
                library_ms = None
                if not quant_kv:
                    ids = tables[0, :kv_limit].long()
                    k_view = pool["k"][ids].reshape(1, -1, kv, hd) \
                        .transpose(1, 2)
                    v_view = pool["v"][ids].reshape(1, -1, kv, hd) \
                        .transpose(1, 2)
                    q_s = q.reshape(1, T, kv * group, hd).transpose(1, 2)
                    key = torch.arange(kv_limit * BLOCK, device=device)
                    pos = cached + torch.arange(T, device=device)[:, None]
                    mask = key[None, :] <= pos
                    if window is not None:
                        mask &= key[None, :] > pos - window
                    library_ms = device_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            q_s, k_view, v_view, attn_mask=mask,
                            enable_gqa=True), 10)
                pairs, live = _chunk_pairs(cached, T, window)
                elem = 1 if quant_kv else 2
                moved = live * kv * hd * elem * 2 \
                    + (live * kv * 4 * 2 if quant_kv else 0) \
                    + 2 * T * kv * group * hd * 2
                b_ms, b_by = bound(moved, 4 * hd * kv * group * pairs)
                row = dict(shape=f"T={T} cached={cached} h=32 kv=8 hd=128 "
                                 f"bs=16 int8={quant_kv} window={window}",
                           err=err, ratio=ratio, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           library_ms=library_ms)
                rows.append(row)
                if (cached, T) == PAGED_MAIN and not quant_kv \
                        and window is None:
                    main = row
        del pool, plain_pool
    return rows, worst, main


#: Verify windows of the ragged rows: per-row starts (some spans inside one
#: block, some across a block edge; 1,023 and 1,030 deep in a long row),
#: chunk lengths as a function of the window width T (the last row idle).
RAGGED_STARTS = (0, 15, 16, 17, 1023, 1030, 40, 5)
RAGGED_WIDTHS = (2, 5, 9, 17)
#: The main path's window: spec_k = 4, so k + 1 = 5 tokens.
SPEC_K = 4


def ragged_chunk_lens(T):
    return (T, T, max(T - 1, 1), T, T, 1, T, 0)


def ragged_tables(torch, pool, gen, rows, entries):
    """Distinct shuffled pool blocks for ``rows`` tables of ``entries``."""
    ids = torch.randperm(pool["k"].shape[0] - 1, generator=gen,
                         device=pool["k"].device)[:rows * entries] + 1
    return ids.to(torch.int32).reshape(rows, entries).contiguous()


def check_append_ragged(torch, pp, llama, device):
    """Every verify window's append: 8 rows of (T, 8 kv heads, 128) at the
    RAGGED_STARTS into shuffled 16-row blocks, bf16 and int8 pools, each
    row's first K vector :func:`plant_division_ties`'s.  The kernel's
    pool must equal the plain version's byte for byte, and every
    pool row outside the live windows must be as it was.  Library: two
    ``index_put_`` calls (K, V) with precomputed rows, bf16 only."""
    gen = torch.Generator(device=device).manual_seed(8)
    kv, hd, rows_n = 8, 128, len(RAGGED_STARTS)
    rows, main = [], None
    for quant_kv in (False, True):
        pool, _ = paged_pool(torch, llama, device, gen, quant_kv)
        for T in RAGGED_WIDTHS:
            lens = ragged_chunk_lens(T)
            tables = ragged_tables(torch, pool, gen, rows_n,
                                   (max(RAGGED_STARTS) + T) // BLOCK + 2)
            k_new = torch.randn((rows_n, T, kv, hd), generator=gen,
                                device=device).to(torch.bfloat16)
            v_new = torch.randn((rows_n, T, kv, hd), generator=gen,
                                device=device).to(torch.bfloat16)
            plant_division_ties(torch, k_new[:, 0, 0])
            meta = (torch.tensor(RAGGED_STARTS, dtype=torch.int32,
                                 device=device),
                    torch.tensor(lens, dtype=torch.int32, device=device))
            got = {key: buf.clone() for key, buf in pool.items()}
            want = {key: buf.clone() for key, buf in pool.items()}
            pp.append_kv_ragged(k_new, v_new, got, tables, *meta)
            pp.append_kv_ragged_reference(k_new, v_new, want, tables, *meta)
            torch.cuda.synchronize()
            err = max(float((got[key].float() - want[key].float())
                            .abs().max()) for key in got)
            if not all(torch.equal(got[key], want[key]) for key in got):
                fail(f"append_kv_ragged int8={quant_kv} T={T}: pool differs "
                     f"from the plain version (max abs {err})")
            live_rows = [int(tables[r, (s + t) // BLOCK]) * BLOCK
                         + (s + t) % BLOCK
                         for r, (s, n) in enumerate(zip(RAGGED_STARTS, lens))
                         for t in range(n)]
            dead = torch.ones(pool["k"].shape[0] * BLOCK, dtype=torch.bool,
                              device=device)
            dead[live_rows] = False
            for key in got:
                flat_got = got[key].reshape((-1,) + got[key].shape[2:])
                flat_old = pool[key].reshape(flat_got.shape)
                if not torch.equal(flat_got[dead], flat_old[dead]):
                    fail(f"append_kv_ragged int8={quant_kv} T={T}: a pool "
                         f"row outside the live windows changed ({key})")
            ms = device_ms(torch, lambda: pp.append_kv_ragged(
                k_new, v_new, got, tables, *meta), 50)
            plain_ms = device_ms(torch, lambda: pp.append_kv_ragged_reference(
                k_new, v_new, want, tables, *meta), 5)
            library_ms = None
            live = sum(lens)
            if not quant_kv:
                flat_rows = torch.tensor(live_rows, device=device)
                sel = torch.cat([torch.arange(n, device=device) + r * T
                                 for r, n in enumerate(lens)])
                k_live = k_new.reshape(-1, kv, hd)[sel]
                v_live = v_new.reshape(-1, kv, hd)[sel]
                flat = {key: got[key].view(-1, kv, hd) for key in got}

                def library():
                    flat["k"].index_put_((flat_rows,), k_live)
                    flat["v"].index_put_((flat_rows,), v_live)
                library_ms = device_ms(torch, library, 20)
            elem = 1 if quant_kv else 2
            moved = 2 * live * kv * hd * 2 + 2 * live * kv * hd * elem \
                + (2 * live * kv * 4 if quant_kv else 0)
            b_ms, b_by = bound(moved, 0)
            row = dict(shape=f"8 rows T={T} live={live} kv=8 hd=128 bs=16 "
                             f"int8={quant_kv}", err=err, ratio=0.0, ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=library_ms)
            rows.append(row)
            if T == SPEC_K + 1 and not quant_kv:
                main = row
            del got, want
        del pool
    return rows, main


#: The phase-2 decode-write cases: (layout, slots, rows a slot), as the
#: serving phases write: the paged server's 4096-row tables of 16-row
#: blocks at 8 and 64 slots, and the contiguous cache of phase 3 (8
#: slots of 1,024 rows, its main row: its launches are the kernels
#: line's) and of the 64-slot run (64 of 512).
DECODE_WRITE_CASES = (("paged", 8, PAGED_MAX_SEQ),
                      ("paged", 64, PAGED_MAX_SEQ),
                      ("contiguous", SLOTS, MAX_SEQ),
                      ("contiguous", 64, 512))


def decode_write_case(torch, llama, device, gen, layout, slots, max_seq,
                      quant_kv, kv=8, hd=128, heads=32):
    """One decode step's K/V write as the serving path makes it: ``k``
    a slice of the fused q/k tensor, head 0's vectors
    :func:`plant_division_ties`'s, every fourth slot inactive.  Paged: a
    pool of 16-row blocks (every slot its own blocks of ``max_seq``
    rows), the inactive lanes redirected to scratch block 0 at offset
    ``slot % 16`` as ``llama._paged_step_core`` does.  Contiguous: a
    (slots, max_seq, kv, hd) cache from ``llama.init_cache``, one block
    of ``max_seq`` rows a slot, the inactive lanes at the scratch row
    ``max_seq - 1`` as ``llama.serve_chunk_ragged`` does.  Returns (k, v,
    pool, tables, positions, first block compared): pools are compared
    from block 1 on where inactive lanes s and s + 16 share a scratch row
    of block 0, in no set order."""
    active = torch.arange(slots, device=device) % 4 != 3
    positions = torch.randint(0, max_seq - 1, (slots,), generator=gen,
                              device=device, dtype=torch.int32)
    if layout == "paged":
        entries = max_seq // BLOCK
        pool, _ = paged_pool(torch, llama, device, gen, quant_kv,
                             n_blocks=slots * entries + 1)
        tables = ragged_tables(torch, pool, gen, slots, entries)
        tables = torch.where(active[:, None], tables,
                             torch.zeros_like(tables))
        positions = torch.where(active, positions, torch.arange(
            slots, device=device, dtype=torch.int32) % BLOCK)
        first = 1
    else:
        config = dataclasses.replace(llama.CONFIGS["llama3_8b"], n_layers=1)
        pool = llama.init_cache(config, slots, max_seq,
                                quantize_kv=quant_kv, device=device)[0]
        tables = llama._slot_tables(slots, device)
        positions = torch.where(active, positions,
                                torch.full_like(positions, max_seq - 1))
        first = 0
    fused = torch.randn((slots, 1, heads + kv, hd), generator=gen,
                        device=device).to(torch.bfloat16)
    k_new = fused[:, :, heads:]
    v_new = torch.randn((slots, 1, kv, hd), generator=gen,
                        device=device).to(torch.bfloat16)
    plant_division_ties(torch, k_new[:, 0, 0])
    return k_new, v_new, pool, tables, positions, first


def check_write_kv_rows(torch, pp, llama, device):
    """The decode step's K/V write (``write_kv_rows``, the KV writer's row
    mode) at every :data:`DECODE_WRITE_CASES` case, bf16 and int8 KV
    (:func:`decode_write_case`), through the function the serving path
    calls: ``llama._paged_write_rows`` on the pool,
    ``llama._cache_write_rows`` on the contiguous cache, each with the
    step's ``DecodeRows``.  The kernel's pool must equal the plain
    version's byte for byte (every block but the paged pool's scratch
    block 0).  Library: two ``index_put_`` calls (K, V) with precomputed
    rows, bf16 only.  The main row is phase 3's (contiguous, 8 slots,
    bf16)."""
    gen = torch.Generator(device=device).manual_seed(10)
    kv, hd = 8, 128
    rows, main = [], None
    for quant_kv in (False, True):
        for layout, slots, max_seq in DECODE_WRITE_CASES:
            k_new, v_new, pool, tables, positions, first = \
                decode_write_case(torch, llama, device, gen, layout, slots,
                                  max_seq, quant_kv)
            write, step_rows = decode_write_rows(llama, pp, layout, tables,
                                                 positions)
            got = pool
            want = {key: buf.clone() for key, buf in pool.items()}
            write(got, k_new, v_new, step_rows)
            pp.write_kv_rows_reference(k_new, v_new, want, tables, positions,
                                       clamp=step_rows.clamp)
            torch.cuda.synchronize()
            err = max(float((got[key][first:].float()
                             - want[key][first:].float()).abs().max())
                      for key in got)
            shape = (f"decode write {layout} {slots} slots x {max_seq} rows "
                     f"T=1 kv=8 hd=128 bs="
                     f"{BLOCK if layout == 'paged' else max_seq} "
                     f"int8={quant_kv}")
            if not all(torch.equal(got[key][first:], want[key][first:])
                       for key in got):
                fail(f"write_kv_rows {shape}: pool differs from the plain "
                     f"version{' outside block 0' if first else ''} "
                     f"(max abs {err})")
            ms = device_ms(torch, lambda: write(got, k_new, v_new,
                                                step_rows), 50)
            plain_ms = device_ms(torch, lambda: pp.write_kv_rows_reference(
                k_new, v_new, want, tables, positions, step_rows.clamp), 20)
            library_ms = None
            if not quant_kv:
                block = got["k"].shape[1]
                flat_rows = (tables.long().gather(
                    1, positions.long()[:, None] // block)[:, 0] * block
                    + positions.long() % block)
                flat = {key: got[key].view(-1, kv, hd) for key in got}
                k_rows, v_rows = k_new[:, 0], v_new[:, 0]

                def library():
                    flat["k"].index_put_((flat_rows,), k_rows)
                    flat["v"].index_put_((flat_rows,), v_rows)
                library_ms = device_ms(torch, library, 20)
            elem = 1 if quant_kv else 2
            moved = 2 * slots * kv * hd * 2 + 2 * slots * kv * hd * elem \
                + (2 * slots * kv * 4 if quant_kv else 0)
            b_ms, b_by = bound(moved, 0)
            row = dict(shape=shape, err=err, ratio=0.0, ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=library_ms)
            rows.append(row)
            if (layout, slots, quant_kv) == ("contiguous", SLOTS, False):
                main = row
            del got, want, pool
    check_write_past_end(torch, pp, llama, device, gen)
    return rows, main


def decode_write_rows(llama, pp, layout, tables, positions):
    """(llama's write function, the step's ``DecodeRows``) of a decode
    write as the serving path makes them: a contiguous cache's rows clamp
    past its end (``llama._cache_rows``), a pool's drop."""
    if layout == "paged":
        return llama._paged_write_rows, pp.DecodeRows(tables, positions)
    return llama._cache_write_rows, llama._cache_rows(positions)


def check_write_past_end(torch, pp, llama, device, gen):
    """The decode write with slot 0 at ``max_seq - 1``, ``max_seq`` and
    ``max_seq + 3`` (the other slots as :func:`decode_write_case` makes
    them), on the 8-slot paged pool and contiguous cache, bf16 and int8
    KV: every byte of the kernel's pool equal to the plain version's (the
    contiguous cache clamps to its last row, the pool drops the row), and
    the contiguous cache's row 0 of slot 0 untouched."""
    cases, equal = 0, 0
    for quant_kv in (False, True):
        for layout, slots, max_seq in DECODE_WRITE_CASES:
            if slots != SLOTS:
                continue
            for past in (-1, 0, 3):
                k_new, v_new, pool, tables, positions, first = \
                    decode_write_case(torch, llama, device, gen, layout,
                                      slots, max_seq, quant_kv)
                positions[0] = max_seq + past
                write, step_rows = decode_write_rows(llama, pp, layout,
                                                     tables, positions)
                want = {key: buf.clone() for key, buf in pool.items()}
                write(pool, k_new, v_new, step_rows)
                pp.write_kv_rows_reference(k_new, v_new, want, tables,
                                           positions, clamp=step_rows.clamp)
                torch.cuda.synchronize()
                cases += 1
                if not all(torch.equal(pool[key][first:], want[key][first:])
                           for key in pool):
                    fail(f"write_kv_rows at position {max_seq + past} of a "
                         f"{layout} {slots} x {max_seq} cache, int8="
                         f"{quant_kv}: pool differs from the plain version")
                elif layout == "contiguous" and bool(pool["k"][0, 0].any()):
                    fail(f"write_kv_rows at position {max_seq + past}: the "
                         "contiguous cache's row 0 was written")
                else:
                    equal += 1
                del pool, want
    log(f"write_kv_rows past the end (slot 0 at max_seq - 1, max_seq, "
        f"max_seq + 3; paged {SLOTS} x {PAGED_MAX_SEQ} drops, contiguous "
        f"{SLOTS} x {MAX_SEQ} clamps; bf16 and int8 KV): {equal} of {cases} "
        "cases byte-equal to the plain version")


def check_chunk_verify(torch, pp, llama, device):
    """The verify's attention: T = 5 windows of 32 query heads over 8 kv
    heads (hd 128) for 8 rows at unaligned positions 1,030-1,199 plus an
    idle row (chunk_len 0), after the ragged append, bf16 and int8 pools,
    window off and 256, against the f32 plain version; the idle row's
    output must be finite.  Library: SDPA with a boolean mask over each
    live row's pre-gathered bf16 view (the gather not timed)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=device).manual_seed(9)
    kv, group, hd, T = 8, 4, 128, SPEC_K + 1
    starts = (1030, 1047, 1064, 1100, 1121, 1150, 1183, 1199, 0)
    lens = (T,) * 8 + (0,)
    rows_n = len(starts)
    rows, worst, main = [], 0.0, None
    for quant_kv in (False, True):
        pool, _ = paged_pool(torch, llama, device, gen, quant_kv)
        entries = (max(starts) + T) // BLOCK + 1
        tables = ragged_tables(torch, pool, gen, rows_n, entries)
        meta = (torch.tensor(starts, dtype=torch.int32, device=device),
                torch.tensor(lens, dtype=torch.int32, device=device))
        k_new = torch.randn((rows_n, T, kv, hd), generator=gen,
                            device=device).to(torch.bfloat16)
        v_new = torch.randn((rows_n, T, kv, hd), generator=gen,
                            device=device).to(torch.bfloat16)
        pp.append_kv_ragged(k_new, v_new, pool, tables, *meta)
        plain_pool = pool if quant_kv else {key: buf.float()
                                            for key, buf in pool.items()}
        q = torch.randn((rows_n, T, kv, group, hd), generator=gen,
                        device=device).to(torch.bfloat16)
        for window in (None, 256):
            got = pp.chunk_attention(q, pool, tables, *meta, window=window)
            want = pp.chunk_attention_reference(q.float(), plain_pool, tables,
                                                meta[0], window=window)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got[-1]).all()):
                fail(f"chunk_attention verify int8={quant_kv} window="
                     f"{window}: the idle row's output is not finite")
            err, ratio = compare(got[:-1], want[:-1])
            if not ratio <= 1.0:
                fail(f"chunk_attention verify int8={quant_kv} window="
                     f"{window}: max abs err {err}, err/tol {ratio}")
            worst = max(worst, ratio)
            ms = device_ms(torch, lambda: pp.chunk_attention(
                q, pool, tables, *meta, window=window), 20)
            plain_ms = device_ms(torch, lambda: pp.chunk_attention_reference(
                q, pool, tables, meta[0], window=window), 3)
            library_ms = None
            if not quant_kv:
                ids = tables[:-1].long()
                k_view = pool["k"][ids].reshape(8, -1, kv, hd).transpose(1, 2)
                v_view = pool["v"][ids].reshape(8, -1, kv, hd).transpose(1, 2)
                q_s = q[:-1].reshape(8, T, kv * group, hd).transpose(1, 2)
                key = torch.arange(entries * BLOCK, device=device)
                pos = (meta[0][:-1].long()[:, None]
                       + torch.arange(T, device=device)[None, :])[..., None]
                mask = key[None, None, :] <= pos
                if window is not None:
                    mask &= key[None, None, :] > pos - window
                mask = mask[:, None]
                library_ms = device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q_s, k_view, v_view, attn_mask=mask,
                        enable_gqa=True), 20)
            pairs = live_keys = 0
            for start in starts[:-1]:
                p, n = _chunk_pairs(start, T, window)
                pairs, live_keys = pairs + p, live_keys + n
            elem = 1 if quant_kv else 2
            moved = live_keys * kv * hd * elem * 2 \
                + (live_keys * kv * 4 * 2 if quant_kv else 0) \
                + 2 * rows_n * T * kv * group * hd * 2
            b_ms, b_by = bound(moved, 4 * hd * kv * group * pairs)
            row = dict(shape=f"verify T={T} 8 rows at 1030-1199 + 1 idle "
                             f"h=32 kv=8 hd=128 bs=16 int8={quant_kv} "
                             f"window={window}", err=err, ratio=ratio, ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=library_ms)
            rows.append(row)
            if not quant_kv and window is None:
                main = row
        del pool, plain_pool
    return rows, worst, main


def step_bound_by(rows, numerics, m=SLOTS):
    """What bounds the int4 launches summed at m rows (an 8-slot decode
    step by default): "operations" if any of them is, else "bytes"."""
    kinds = {r["bound_by"] for r in rows
             if r["numerics"] == numerics and r["m"] == m}
    return "operations" if "operations" in kinds else "bytes"


def fmt_ms(value):
    return "not measured" if value is None else f"{value:.4f}"


def print_rows(title, rows):
    log(f"--- {title}")
    for row in rows:
        library = row.get("library_ms")
        floor = f"  floor_ms {row['floor_ms']:.4f}" if "floor_ms" in row \
            else ""
        if "host_ms" in row:
            floor += f"  host_ms {row['host_ms']:.3f}"
        kernel = "not measured (host-bound)" if row.get("host_bound") \
            else f"{row['ms']:.4f}"
        log(f"  {row['shape']}: max_abs_err {row['err']:.3g} (err/tol "
            f"{row['ratio']:.3f})  kernel_ms {kernel}  plain_ms "
            f"{row['plain_ms']:.4f}  bound_ms {row['bound_ms']:.4f} "
            f"({row['bound_by']}){floor}  library_ms "
            f"{'n/a' if library is None else f'{library:.4f}'}")


# --------------------------------------------------------------------------- #
# Phase 3: serving

def np_bytes(array) -> bytes:
    """The bytes of a prompt (any integer array) as int32."""
    import numpy as np
    return np.asarray(array, np.int32).tobytes()


def contiguous_oracle(torch, llama, params, config, prompt, quantize_kv,
                      device, rows=MAX_SEQ):
    """Batch-1 ``prefill`` + ``decode_step`` on a contiguous cache of
    ``rows`` rows: (logits of the first served token, step(token,
    position) -> logits of the next)."""
    tokens = torch.as_tensor(prompt, device=device)[None]
    cache = llama.init_cache(config, 1, rows, quantize_kv=quantize_kv,
                             device=device)
    logits, cache = llama.prefill(params, tokens, cache, config)

    def step(token, position):
        nonlocal cache
        token = torch.tensor([[token]], dtype=torch.int32, device=device)
        out, cache = llama.decode_step(params, token, cache, position,
                                       config)
        return out[0, -1]
    return logits[0, -1], step


def check_request(torch, request, first_logits, step):
    """Hold every served token of ``request`` to a batch-1 oracle, walked
    teacher-forced: the oracle reads the served tokens, so each token is
    compared with what the oracle picks after the same prefix.  Returns
    (tokens equal to the oracle's argmax, [(index, gap)] of the accepted
    near-ties); a token off by more than TIE_GAP fails the run."""
    prompt_len = len(request.prompt)
    logits, equal, ties = first_logits, 0, []
    for index, served in enumerate(request.tokens):
        best = int(logits.argmax())
        if served == best:
            equal += 1
        else:
            gap = float(logits[best] - logits[served])
            if gap > TIE_GAP:
                fail(f"request {request.request_id} (prompt {prompt_len}): "
                     f"token {index} is {served}, oracle {best}, logit gap "
                     f"{gap:.4f} > {TIE_GAP}")
            ties.append((index, round(gap, 4)))
        if index + 1 < len(request.tokens):
            logits = step(served, prompt_len + index)
    return equal, ties


#: A served token sequence already held to its batch-1 oracle: (oracle
#: key, prompt bytes, tokens) -> (tokens equal, near-ties).  The same
#: prompt serving the same tokens on the same weights and cache walks the
#: oracle the same way, so phases that serve one traffic on one weight set
#: (phases 3 and 12) check it once.
CHECKED = {}


def check_requests(torch, requests, oracle, memo=None, side_by_side=False):
    """``oracle(request)`` -> (first logits, step) for every request:
    (requests exactly equal, tokens equal, tokens checked, near-ties).
    ``memo`` names the oracle (weights, KV dtype, cache rows): a request
    whose prompt and tokens it has held before is not walked again.  With
    ``side_by_side``, ``oracle(requests)`` -> (first logits, step) of
    :func:`lockstep_results` for the requests not held before, whose
    batch-1 oracles then walk side by side (the same walks, one step a
    token for all of them), but for the first, which walks alone: a fault
    that mixes the rows of one decode step shows in the served run and in
    the side-by-side walks alike, and still shows against that one."""
    keys = [(memo, np_bytes(request.prompt), tuple(request.tokens))
            for request in requests]
    results = {key: CHECKED[key] for key in keys
               if memo is not None and key in CHECKED}
    todo = [(request, key) for request, key in zip(requests, keys)
            if key not in results]
    if todo:
        walking = [request for request, _ in todo]
        if side_by_side:
            walked = [result for part in (walking[:1], walking[1:]) if part
                      for result in lockstep_results(torch, part,
                                                     *oracle(part))]
        else:
            walked = [check_request(torch, request, *oracle(request))
                      for request in walking]
        for (_, key), result in zip(todo, walked):
            results[key] = result
            if memo is not None:
                CHECKED[key] = result
    exact, equal, checked, ties = 0, 0, 0, []
    for request, key in zip(requests, keys):
        same, near = results[key]
        exact += not near and same == len(request.tokens)
        equal += same
        checked += len(request.tokens)
        ties += [(request.request_id, index, gap) for index, gap in near]
    return exact, equal, checked, ties


def graph_counts(stats, where):
    """The serving run's chunk graphs: captures (one a key the run met
    twice) and replays, which must not be 0: the greedy steady chunks
    serve through the graph on the card."""
    if not stats["graph_replays"]:
        fail(f"{where}: no decode chunk replayed a CUDA graph "
             f"({stats['graph_captures']} captures)")
    return dict(run_graph_captures=stats["graph_captures"],
                run_graph_replays=stats["graph_replays"])


def serve(torch, np, llama, weights, kernels, server_cls, request_cls,
          params, quantize_kv, device):
    """ContinuousBatchingServer, llama3_8b, 8 slots, 1024-row cache: the
    PROMPTS traffic in three waves, every served token held to the batch-1
    oracle, every kernel's launches held to the decode steps and prefill
    dispatches of the run (a kernel in ``kernels`` with no expected count
    must not launch at all), then the steady decode window."""
    config = llama.CONFIGS["llama3_8b"]
    server = server_cls(config_name="llama3_8b", slots=SLOTS,
                        max_seq=MAX_SEQ, chunk_steps=CHUNK_STEPS,
                        params=params, quantize=True,
                        quantize_kv=quantize_kv, device=device)
    rng = np.random.default_rng(7)
    # Warm the card (allocator, cuBLAS handles) outside the measured run.
    server.submit(request_cls("warm", rng.integers(
        1, config.vocab_size, 100).astype(np.int32), 4))
    server.run_until_drained()
    server = server_cls(config_name="llama3_8b", slots=SLOTS,
                        max_seq=MAX_SEQ, chunk_steps=CHUNK_STEPS,
                        params=params, quantize=True,
                        quantize_kv=quantize_kv, device=device)
    requests = [request_cls(f"r{i}", rng.integers(
        1, config.vocab_size, plen).astype(np.int32), NEW_TOKENS)
        for i, plen in enumerate(PROMPTS)]
    # The (rows, bucket) of every prefill dispatch of the run, recorded
    # around the model's prefill entry point, for the expected counts.
    dispatches, prefill = [], llama.prefill

    def recorded_prefill(params, tokens, cache, config, **kwargs):
        dispatches.append(tuple(tokens.shape))
        return prefill(params, tokens, cache, config, **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    llama.prefill = recorded_prefill
    try:
        for kernel in kernels:
            kernel.launches = 0
        began = time.monotonic()
        for batch in (requests[:5], requests[5:8], requests[8:]):
            for request in batch:
                server.submit(request)
            for _ in range(3):
                server.step()
        server.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - began
        launches = {kernel.__name__: kernel.launches for kernel in kernels}
    finally:
        llama.prefill = prefill
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = server.stats()

    for request in requests:
        if request.error is not None or len(request.tokens) != NEW_TOKENS:
            fail(f"request {request.request_id}: error {request.error}, "
                 f"{len(request.tokens)} tokens")
    if len(dispatches) != stats["prefill_dispatches"]:
        fail(f"{len(dispatches)} prefill calls recorded, the server "
             f"counted {stats['prefill_dispatches']}")
    layers, steps = config.n_layers, stats["decode_steps"]
    kernel_prefills = sum(weights.rule(rows * seq, config.d_model,
                                       config.d_model)
                          for rows, seq in dispatches)
    want = {name: matmul_launches(weights, config, SLOTS, 1, name) * steps
            + sum(matmul_launches(weights, config, rows, seq, name)
                  for rows, seq in dispatches) for name in weights.rules}
    want.update(paged_decode_attention=layers * steps,
                write_kv_rows=layers * steps,
                flash_attention=layers * len(dispatches))
    for name, expected in want.items():
        if launches[name] != expected or expected == 0:
            fail(f"{name}: {launches[name]} launches, expected {expected} "
                 f"(decode_steps {steps}, prefill dispatches {dispatches})")
    for name, count in launches.items():
        if name not in want and count:
            fail(f"{name} launched {count} times on {weights.label} weights")
    if not kernel_prefills:
        fail(f"no prefill dispatch took the {weights.label} kernel: "
             f"{dispatches}")
    if not peak_gb < 80:
        fail(f"peak device memory {peak_gb:.2f} GB")

    exact, equal, checked, ties = check_requests(
        torch, requests, lambda todo: lockstep_contiguous(
            torch, llama, params, config, todo, device, MAX_SEQ,
            quantize_kv=quantize_kv),
        memo=("contiguous", id(params), quantize_kv, MAX_SEQ),
        side_by_side=True)

    ttfts = sorted((r.first_token_ts - r.submitted_ts) * 1e3
                   for r in requests)
    generated = sum(len(r.tokens) for r in requests)
    steady = {} if quantize_kv else steady_decode(
        torch, np, weights, lambda: server_cls(
            config_name="llama3_8b", slots=SLOTS, max_seq=MAX_SEQ,
            chunk_steps=CHUNK_STEPS, params=params, quantize=True,
            quantize_kv=quantize_kv, device=device),
        request_cls, quantize_kv, config)
    return dict(weights=weights.label, kv="int8" if quantize_kv else "bf16",
                requests=len(requests), requests_exact=exact,
                tokens_checked=checked, tokens_equal=equal,
                accepted_near_ties=ties, launches=launches,
                decode_steps=steps, prefill_dispatches=dispatches,
                kernel_prefills=kernel_prefills,
                wall_s=wall, served_tok_s=generated / wall,
                ttft_ms_p50=ttfts[len(ttfts) // 2], ttft_ms_max=ttfts[-1],
                peak_gb=peak_gb, **graph_counts(stats, "contiguous"),
                **steady)


#: Decode steps of each timed turn of the steady window (STEADY_TURNS), of
#: the eager window under cProfile, and of each profiled or event-timed
#: window.
TURN_STEPS, TRACE_STEPS = 12, 8
#: The timed turns of a steady window, graphed (True) and eager.
STEADY_TURNS = (True, False, True)
#: The eager path's window under torch.profiler: its CPU-op records make
#: the trace's processing most of a steady window's seconds (on the H100,
#: 3.4 s of a paged 8-slot window's 8.9 at 8 steps), so it traces half as
#: many steps as the graphed path's.
EAGER_TRACE_STEPS = 4


def steady_decode(torch, np, weights, make_server, request_cls, quantize_kv,
                  config, prompt_len=128, slots=SLOTS, new_tokens=128):
    """Decode at a full batch: ``slots`` requests of ``prompt_len`` prompt
    tokens admitted together into ``make_server()``; once every request
    has its first token and the steady chunk's graph is captured, the
    capture ledger's fence drops and the same server decodes in turns of
    TURN_STEPS steps with its chunk graphs on and off (graphed, eager,
    graphed; ``_graphs_on``, the private switch), timed with
    nothing attached.  Then, on the eager path, a window of TURN_STEPS
    under cProfile (the host's top functions by own time are printed; the
    K/V write's microseconds a call, llama's ``_cache_write_rows`` /
    ``_paged_write_rows``) and one under torch.profiler, host ops and
    kernels for EAGER_TRACE_STEPS (the card's kernel time per step, by
    kernel; busy share = kernel time per step over the unprofiled eager step;
    kernels a step;
    the weight matmul's device time per step; ``aten::index_put_`` ops a
    step, which must stay under one a layer: the decode write launches
    the row writer, not an eager scatter); on the graphed path one window
    under torch.profiler (kernel time, kernels a step and a replay, busy
    over the unprofiled graphed step) and one with CUDA events around
    every replay (the replays' device span a step, and busy by it).  No
    chunk may be captured after the fence.  A tree whose servers have no
    chunk graph runs the eager windows only.

    The tracer may miss the kernels launched while it comes up, and a
    window of consumed steps need not hold whole dispatched steps (the
    ring keeps chunks in flight across its edges), so a step's device
    time is not the window's total over its step count: the steps the
    tracer saw are its records of the matmul kernel over the exact
    launches of one decode step (the kernel-shape rule, which the
    serving run's launch counts hold), and the matmul's time per step is
    its mean recorded launch times those launches."""
    import cProfile
    import io
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    window_began = time.monotonic()
    server = make_server()
    graphs = hasattr(server, "graph_ledger")
    label = (f"{weights.label} weights, {slots} slots, "
             f"{'int8' if quantize_kv else 'bf16'} KV, "
             f"{type(server).__name__}")
    rng = np.random.default_rng(11)
    requests = [request_cls(f"s{i}", rng.integers(
        1, config.vocab_size, prompt_len).astype(np.int32), new_tokens)
        for i in range(slots)]
    for request in requests:
        server.submit(request)
    while any(r.first_token_ts is None for r in requests) or (
            graphs and not server.stats()["graph_replays"]):
        server.step()
    if graphs:
        server.graph_ledger.fence()

    def window(steps, graphed):
        if graphs:
            server._graphs_on = graphed
        start = server.counters["decode_steps"]
        torch.cuda.synchronize()
        began = time.perf_counter()
        while server.counters["decode_steps"] - start < steps:
            if not server.busy:
                fail(f"steady decode ({label}): the requests ran out "
                     "before the window ended")
            server.step()
        torch.cuda.synchronize()
        return time.perf_counter() - began, \
            server.counters["decode_steps"] - start

    turns = {True: [], False: []}
    for graphed in (STEADY_TURNS if graphs else (False,)):
        wall, steps = window(TURN_STEPS, graphed)
        turns[graphed].append(wall * 1e3 / steps)
    eager_ms = sum(turns[False]) / len(turns[False])
    host = cProfile.Profile()
    host.enable()
    host_wall, host_steps = window(TURN_STEPS, False)
    host.disable()
    text = io.StringIO()
    host_stats = pstats.Stats(host, stream=text)
    host_stats.sort_stats("tottime").print_stats(12)
    # The decode step's K/V write under cProfile: llama's write function
    # (write_kv_rows inside), microseconds a call with the profiler on.
    writes = [(calls, cumulative) for (_, _, fn), (_, calls, _, cumulative,
                                                   _) in
              host_stats.stats.items()
              if fn in ("_cache_write_rows", "_paged_write_rows")]
    write_calls = sum(calls for calls, _ in writes)
    write_host_us = (sum(cum for _, cum in writes) * 1e6 / write_calls
                     if write_calls else None)
    log(f"--- host, {label}, eager steady decode (cProfile, "
        f"{host_wall * 1e3 / host_steps:.3f} ms a step with it on):")
    for line in text.getvalue().splitlines():
        if line.strip() and not line.lstrip().startswith(("Ordered", "List")):
            log("  " + line.rstrip())
    per_step = matmul_launches(weights, config, slots, 1)

    def traced(graphed):
        """One window under torch.profiler: (averages, kernels, device ms a
        step or None, steps the tracer saw, matmul records, steps)."""
        launched = weights.matmul.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, steps = window(TRACE_STEPS if graphed else EAGER_TRACE_STEPS,
                              graphed)
        launched = weights.matmul.launches - launched
        averages = prof.key_averages()
        kernels = [event for event in averages
                   if event.device_type == DeviceType.CUDA]
        device_us = sum(event.self_device_time_total for event in kernels)
        matmul = [event for event in kernels
                  if weights.trace_key in event.key]
        recorded = sum(event.count for event in matmul)
        seen = recorded / per_step if device_us and recorded else None
        return dict(averages=averages, kernels=kernels, launched=launched,
                    recorded=recorded, steps=steps, seen=seen,
                    device_ms=device_us / 1e3 / seen if seen else None,
                    matmul_ms=(sum(e.self_device_time_total for e in matmul)
                               / 1e3 / seen if seen else None),
                    kernels_per_step=(sum(e.count for e in kernels) / seen
                                      if seen else None))

    eager = traced(False)
    # In-place index_put_ ops of the window (host-side records, which the
    # tracer does not miss): the eager K/V write issued 2 (bf16 KV) or 4
    # (int8 KV) a layer a step; the decode write now launches none.
    index_puts = sum(event.count for event in eager["averages"]
                     if event.key == "aten::index_put_") / eager["steps"]
    if index_puts >= config.n_layers:
        fail(f"{label} steady decode: {index_puts:g} index_put_ a step, a "
             "per-layer K/V write left outside write_kv_rows")
    if eager["seen"] is None:
        log(f"--- device, {label}, eager: the profiler recorded no "
            f"{weights.name} launch (not measured)")
    else:
        log(f"--- device, {label}, eager ({eager['device_ms']:.3f} ms of "
            f"kernels a step over {eager['seen']:g} steps; {weights.name}: "
            f"{eager['recorded']} launches recorded of {eager['launched']} "
            "made under the profiler):")
        for line in eager["averages"].table(
                sort_by="self_device_time_total", row_limit=10,
                max_name_column_width=50).splitlines():
            log("  " + line)
    result = dict(steady_slots=slots, steady_layout=type(server).__name__,
                  eager_step_ms=eager_ms, eager_step_ms_turns=turns[False],
                  eager_decode_tok_s=slots * 1e3 / eager_ms,
                  eager_device_ms_per_step=eager["device_ms"],
                  eager_busy=(eager["device_ms"] / eager_ms
                              if eager["device_ms"] else None),
                  eager_kernels_per_step=eager["kernels_per_step"],
                  matmul_device_ms_per_step=eager["matmul_ms"],
                  matmul_launches_traced=eager["recorded"],
                  matmul_launches_in_trace=eager["launched"],
                  steady_index_put_per_step=index_puts,
                  write_host_us_per_call=write_host_us,
                  write_calls_per_step=write_calls / host_steps,
                  steady_step_ms=eager_ms, steady_decode_tok_s=(
                      slots * 1e3 / eager_ms))
    if not graphs:
        server.run_until_drained()
        return result

    graphed = traced(True)
    # The replays' device span: CUDA events around every replay of a
    # window (the graph's kernels and the gaps between them).
    spans, chunk_graph = [], server._chunk_graph
    run = chunk_graph.run

    def timed_run(num_steps, eos_id=-1, *lora):
        began, ended = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        began.record()
        out = run(num_steps, eos_id, *lora)
        ended.record()
        spans.append((began, ended, num_steps))
        return out
    chunk_graph.run = timed_run
    try:
        window(TRACE_STEPS, True)
    finally:
        del chunk_graph.run
    torch.cuda.synchronize()
    replay_ms = (sum(b.elapsed_time(e) for b, e, _ in spans)
                 / sum(n for _, _, n in spans))
    server._graphs_on = True
    server.run_until_drained()
    stats = server.stats()
    if stats["graph_captures_steady_state"]:
        fail(f"{label} steady decode: {stats['graph_captures_steady_state']}"
             " graph captures after the warm-up fence")
    graphed_ms = sum(turns[True]) / len(turns[True])
    steady_keys = [key for key, value in chunk_graph._graphs.items()
                   if value is not None and key[2] == CHUNK_STEPS]
    port_launches = (sum(chunk_graph._graphs[steady_keys[0]][2].values())
                     if steady_keys else None)
    per_replay = (graphed["kernels_per_step"] * CHUNK_STEPS
                  if graphed["kernels_per_step"] else None)
    result.update(
        steady_step_ms=graphed_ms, steady_decode_tok_s=slots * 1e3
        / graphed_ms, graphed_step_ms_turns=turns[True],
        graphed_device_ms_per_step=graphed["device_ms"],
        graphed_busy=(graphed["device_ms"] / graphed_ms
                      if graphed["device_ms"] else None),
        graphed_replay_ms_per_step=replay_ms,
        graphed_busy_by_events=replay_ms / graphed_ms,
        graphed_kernels_per_replay=per_replay,
        graphed_port_launches_per_replay=port_launches,
        graphed_matmul_device_ms_per_step=graphed["matmul_ms"],
        graph_captures=stats["graph_captures"],
        graph_replays=stats["graph_replays"],
        graph_captures_steady_state=stats["graph_captures_steady_state"],
        steady_window_s=round(time.monotonic() - window_began, 1))
    profiled = (f"{graphed['device_ms']:.3f} ms of kernels a step "
                f"(profiler), busy {result['graphed_busy']:.3f}, "
                f"{per_replay:g} kernels a replay of {CHUNK_STEPS} steps"
                if graphed["device_ms"] else
                "the profiler broke no replay into kernels: device ms "
                "from CUDA events around the replays only")
    log(f"--- steady decode, {label}: graphed {graphed_ms:.3f} ms a step "
        f"(turns {', '.join(f'{t:.3f}' for t in turns[True])}), "
        f"{profiled}; replays' device span {replay_ms:.3f} ms a step "
        f"(CUDA events), busy by it {replay_ms / graphed_ms:.3f}; "
        f"{port_launches} port kernel launches a replay | eager "
        f"{eager_ms:.3f} ms a step (turns "
        f"{', '.join(f'{t:.3f}' for t in turns[False])}), "
        + (f"{eager['device_ms']:.3f} ms of kernels, busy "
           f"{result['eager_busy']:.3f}, {eager['kernels_per_step']:g} "
           "kernels a step" if eager["device_ms"] else
           "device ms not measured")
        + f"; the window took {result['steady_window_s']} s")
    if graphed["device_ms"]:
        for line in graphed["averages"].table(
                sort_by="self_device_time_total", row_limit=6,
                max_name_column_width=50).splitlines():
            log("  " + line)
    return result


#: The JAX bench's int4 shape (bench.py llama3_8b_int4): 64 slots, 128
#: prompt tokens, 128 new tokens, here in a 512-row cache.
WIDE_SLOTS, WIDE_MAX_SEQ, WIDE_PROMPT, WIDE_NEW = 64, 512, 128, 128
#: Requests of the 64-slot run held token by token to the batch-1 oracle
#: (every 8th; the rest must finish with WIDE_NEW tokens).
WIDE_CHECKED = 8


def serve_wide(torch, np, llama, weights, kernels, server_cls, request_cls,
               params, device):
    """ContinuousBatchingServer at 64 slots, bf16 KV: 64 requests of
    WIDE_PROMPT tokens and WIDE_NEW new tokens submitted together.  Every
    request must finish; WIDE_CHECKED of them are held to their batch-1
    oracles, walked side by side (:func:`check_requests`); every
    kernel's launches are held to the decode steps and
    prefill dispatches of the run; peak memory < 80 GB; then the steady
    decode window at 64 slots."""
    config = llama.CONFIGS["llama3_8b"]

    def make_server():
        return server_cls(config_name="llama3_8b", slots=WIDE_SLOTS,
                          max_seq=WIDE_MAX_SEQ, chunk_steps=CHUNK_STEPS,
                          params=params, quantize=True, quantize_kv=False,
                          device=device)
    rng = np.random.default_rng(13)
    warm = make_server()
    warm.submit(request_cls("warm", rng.integers(
        1, config.vocab_size, 100).astype(np.int32), 4))
    warm.run_until_drained()
    del warm
    server = make_server()
    requests = [request_cls(f"w{i}", rng.integers(
        1, config.vocab_size, WIDE_PROMPT).astype(np.int32), WIDE_NEW)
        for i in range(WIDE_SLOTS)]
    dispatches, prefill = [], llama.prefill

    def recorded_prefill(params, tokens, cache, config, **kwargs):
        dispatches.append(tuple(tokens.shape))
        return prefill(params, tokens, cache, config, **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    llama.prefill = recorded_prefill
    try:
        for kernel in kernels:
            kernel.launches = 0
        began = time.monotonic()
        for request in requests:
            server.submit(request)
        server.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - began
        launches = {kernel.__name__: kernel.launches for kernel in kernels}
    finally:
        llama.prefill = prefill
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = server.stats()
    for request in requests:
        if request.error is not None or len(request.tokens) != WIDE_NEW:
            fail(f"64-slot request {request.request_id}: error "
                 f"{request.error}, {len(request.tokens)} tokens")
    if len(dispatches) != stats["prefill_dispatches"]:
        fail(f"64 slots: {len(dispatches)} prefill calls recorded, the "
             f"server counted {stats['prefill_dispatches']}")
    layers, steps = config.n_layers, stats["decode_steps"]
    want = {name: matmul_launches(weights, config, WIDE_SLOTS, 1, name)
            * steps + sum(matmul_launches(weights, config, rows, seq, name)
                          for rows, seq in dispatches)
            for name in weights.rules}
    want.update(paged_decode_attention=layers * steps,
                write_kv_rows=layers * steps,
                flash_attention=layers * len(dispatches))
    for name, expected in want.items():
        if launches[name] != expected or expected == 0:
            fail(f"64 slots {name}: {launches[name]} launches, expected "
                 f"{expected} (decode_steps {steps}, prefill dispatches "
                 f"{dispatches})")
    for name, count in launches.items():
        if name not in want and count:
            fail(f"64 slots: {name} launched {count} times")
    if not peak_gb < 80:
        fail(f"64 slots: peak device memory {peak_gb:.2f} GB")
    checked_requests = requests[::WIDE_SLOTS // WIDE_CHECKED]
    exact, equal, checked, ties = check_requests(
        torch, checked_requests, lambda todo: lockstep_contiguous(
            torch, llama, params, config, todo, device, WIDE_MAX_SEQ),
        side_by_side=True)
    ttfts = sorted((r.first_token_ts - r.submitted_ts) * 1e3
                   for r in requests)
    steady = steady_decode(torch, np, weights, make_server, request_cls,
                           False, config, prompt_len=WIDE_PROMPT,
                           slots=WIDE_SLOTS, new_tokens=WIDE_NEW)
    return dict(weights=weights.label, kv="bf16", slots=WIDE_SLOTS,
                requests=len(requests), requests_checked=len(checked_requests),
                requests_exact=exact, tokens_checked=checked,
                tokens_equal=equal, accepted_near_ties=ties,
                launches=launches, decode_steps=steps,
                prefill_dispatches=dispatches, wall_s=wall,
                served_tok_s=WIDE_SLOTS * WIDE_NEW / wall,
                ttft_ms_p50=ttfts[len(ttfts) // 2], ttft_ms_max=ttfts[-1],
                peak_gb=peak_gb, **graph_counts(stats, "64 slots"),
                **steady)


# --------------------------------------------------------------------------- #
# Phase 4: the paged server

#: The tokens of phase 4's runs, by (weights label, int8 KV): phase 13 (c)
#: holds its base rows to the bf16-KV int8 run's, served by an adapter-free
#: server of its shape on the same schedule.
PAGED_TOKENS = {}


def paged_traffic(np, vocab):
    """Three waves, 12 requests: six share a 1,024-token prefix with tails
    of 16-500 tokens (two arrive with their producer, four after it has
    prefilled), four distinct prompts of 64-1,800 tokens, then two
    re-submissions of finished prompts."""
    rng = np.random.default_rng(17)

    def ints(n):
        return rng.integers(1, vocab, n).astype(np.int32)
    prefix = ints(1024)
    shared = [np.concatenate([prefix, ints(tail)])
              for tail in (16, 300, 40, 500, 100, 200)]
    distinct = [ints(n) for n in (64, 1800, 700, 130)]
    return [shared[:2] + distinct[:2], shared[2:] + distinct[2:],
            [distinct[0].copy(), shared[0].copy()]]


def paged_oracle(torch, llama, server_cls, request_cls, params, config,
                 prompt, device):
    """Batch-1 paged run of one request, int8 KV: a 1-slot
    PagedContinuousServer with the prefix cache off admits the prompt on
    its own schedule (one whole-bucket piece, or standalone slices of up
    to 256 tokens), then decode steps read and extend its pool through
    its table row: (logits of the first served token, step(token,
    position) -> logits of the next)."""
    server = server_cls(config_name="llama3_8b", slots=1,
                        max_seq=PAGED_MAX_SEQ, params=params, quantize=True,
                        quantize_kv=True, block_size=BLOCK,
                        chunk_prefill_tokens=CHUNK, device=device)
    server.submit(request_cls("oracle", prompt, NEW_TOKENS))
    server._admit()
    while server._prefilling:
        server._advance_prefills()
    tables = torch.as_tensor(server.tables[:1], device=device)

    def step(token, position):
        with torch.no_grad():
            logits, _ = llama._decode_core_paged(
                params, torch.tensor([[token]], dtype=torch.int32,
                                     device=device), server.pool, tables,
                torch.tensor([position], dtype=torch.int32, device=device),
                config)
        return logits[0, -1]
    return step(int(prompt[-1]), len(prompt) - 1), step


def serve_paged(torch, np, llama, weights, kernels, server_cls, request_cls,
                params, quantize_kv, device):
    """PagedContinuousServer, llama3_8b, 8 slots, 4096-row tables of
    16-row blocks, the default pool (1,024 usable blocks), prefix cache on,
    256-token chunked admission; the traffic of :func:`paged_traffic`,
    every served token held to its oracle (bf16 KV: the contiguous batch-1
    prefill + decode; int8 KV: :func:`paged_oracle`)."""
    config = llama.CONFIGS["llama3_8b"]

    def make_server():
        return server_cls(config_name="llama3_8b", slots=SLOTS,
                          max_seq=PAGED_MAX_SEQ, chunk_steps=CHUNK_STEPS,
                          params=params, quantize=True,
                          quantize_kv=quantize_kv, block_size=BLOCK,
                          enable_prefix_cache=True,
                          chunk_prefill_tokens=CHUNK, device=device)
    warm = make_server()
    rng = np.random.default_rng(9)
    for n in (100, 600):
        warm.submit(request_cls(f"warm{n}", rng.integers(
            1, config.vocab_size, n).astype(np.int32), 4))
    warm.run_until_drained()
    del warm
    server = make_server()
    waves = paged_traffic(np, config.vocab_size)
    requests = []
    # The width of every prefill slice of the run, recorded around the
    # model's append-prefill core, for the expected launch counts.
    widths, core = [], llama._prefill_append_core

    def recorded_core(params, tokens, *args, **kwargs):
        widths.append(int(tokens.shape[1]))
        return core(params, tokens, *args, **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    llama._prefill_append_core = recorded_core
    try:
        for kernel in kernels:
            kernel.launches = 0
        began = time.monotonic()
        for index, wave in enumerate(waves):
            batch = [request_cls(f"p{len(requests) + i}", prompt, NEW_TOKENS)
                     for i, prompt in enumerate(wave)]
            requests += batch
            for request in batch:
                server.submit(request)
            if index == 0:      # the next wave once the producer prefilled
                while batch[0].first_token_ts is None:
                    server.step()
            elif index == 1:    # the last once wave 1's requests finished
                while any(r.finished_ts is None for r in requests[:4]):
                    server.step()
        server.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - began
        launches = {kernel.__name__: kernel.launches for kernel in kernels}
    finally:
        llama._prefill_append_core = core
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = server.stats()
    for request in requests:
        if request.error is not None or len(request.tokens) != NEW_TOKENS:
            fail(f"paged request {request.request_id}: error "
                 f"{request.error}, {len(request.tokens)} tokens")
    slices = stats["prefill_dispatches"]
    if len(widths) != slices:
        fail(f"{len(widths)} prefill slices recorded, the server counted "
             f"{slices}")
    layers, steps = config.n_layers, stats["decode_steps"]
    want = {"append_kv": layers * slices, "chunk_attention": layers * slices,
            "paged_decode_attention": layers * steps,
            "write_kv_rows": layers * steps}
    for name in weights.rules:
        want[name] = matmul_launches(weights, config, SLOTS, 1, name) \
            * steps + sum(layer_launches(weights, config, w, name)
                          for w in widths)
    for name, expected in want.items():
        if launches[name] != expected or expected == 0:
            fail(f"paged {name}: {launches[name]} launches, expected "
                 f"{expected} (decode_steps {steps}, slices {widths})")
    for name, count in launches.items():
        if name not in want and count:
            fail(f"the paged path launched {name} {count} times "
                 f"({weights.label} weights)")
    if not peak_gb < 80:
        fail(f"paged: peak device memory {peak_gb:.2f} GB")
    if stats["prefix_hits"] <= 0:
        fail(f"no prefix hit: {stats['prefix_misses']} misses")
    balance = server.pool_balance()
    if balance["free"] + balance["evictable"] + balance["producing"] \
            != balance["total"] or balance["producing"]:
        fail(f"pool out of balance after the drain: {balance}")

    if quantize_kv:
        exact, equal, checked, ties = check_requests(
            torch, requests, lambda request: paged_oracle(
                torch, llama, server_cls, request_cls, params, config,
                request.prompt, device))
    else:
        exact, equal, checked, ties = check_requests(
            torch, requests, lambda todo: lockstep_contiguous(
                torch, llama, params, config, todo, device, PAGED_MAX_SEQ),
            side_by_side=True)
    PAGED_TOKENS[(weights.label, quantize_kv)] = [list(r.tokens)
                                                  for r in requests]
    ttfts = sorted((r.first_token_ts - r.submitted_ts) * 1e3
                   for r in requests)
    totals = sorted((r.finished_ts - r.submitted_ts) * 1e3
                    for r in requests)
    mixed = stats["prefill_slices_mixed"]
    steady = {} if quantize_kv else steady_decode(
        torch, np, weights, make_server, request_cls, quantize_kv, config,
        prompt_len=1023)
    return dict(weights=weights.label, kv="int8" if quantize_kv else "bf16",
                server="paged",
                requests=len(requests), requests_exact=exact,
                tokens_checked=checked, tokens_equal=equal,
                accepted_near_ties=ties, launches=launches,
                decode_steps=steps, prefill_slices=slices,
                slices_mixed=mixed, slices_standalone=slices - mixed,
                slice_widths=widths, prefix_hits=stats["prefix_hits"],
                prefix_misses=stats["prefix_misses"],
                prefix_blocks_reused=stats["prefix_blocks_reused"],
                pool_balance=balance, wall_s=wall,
                served_tok_s=len(requests) * NEW_TOKENS / wall,
                ttft_ms_p50=ttfts[len(ttfts) // 2], ttft_ms_max=ttfts[-1],
                total_ms_p50=totals[len(totals) // 2],
                peak_gb=peak_gb, **graph_counts(stats, "paged"), **steady)


def steady_paged_wide(torch, np, llama, weights, server_cls, request_cls,
                      params, device):
    """The paged server's steady window at 64 slots: bf16 KV, 512-row
    tables of 16-row blocks, a pool that holds every slot's whole table,
    WIDE_PROMPT-token prompts (:func:`steady_decode`: the graphed step
    beside the eager one)."""
    config = llama.CONFIGS["llama3_8b"]

    def make_server():
        return server_cls(config_name="llama3_8b", slots=WIDE_SLOTS,
                          max_seq=WIDE_MAX_SEQ, chunk_steps=CHUNK_STEPS,
                          params=params, quantize=True, quantize_kv=False,
                          block_size=BLOCK, enable_prefix_cache=True,
                          chunk_prefill_tokens=CHUNK,
                          total_blocks=WIDE_SLOTS * WIDE_MAX_SEQ // BLOCK,
                          device=device)
    return dict(weights=weights.label, kv="bf16", server="paged",
                **steady_decode(torch, np, weights, make_server, request_cls,
                                False, config, prompt_len=WIDE_PROMPT,
                                slots=WIDE_SLOTS, new_tokens=WIDE_NEW))


def print_steady_cells(cells):
    """One line a steady cell: the graphed step beside the eager one."""
    log("steady decode, graphed beside eager (step ms unprofiled, mean of "
        "two turns; busy = kernel ms a step (profiler) over the step, "
        "'events' = the replays' device span over the step):")
    for name, run in cells:
        graphed_busy = run.get("graphed_busy")
        eager_busy = run.get("eager_busy")
        log(f"  {name}: graphed {run['steady_step_ms']:.3f} ms, "
            f"{run['steady_decode_tok_s']:.1f} tok/s, busy "
            f"{fmt_ms(graphed_busy)} (events "
            f"{fmt_ms(run.get('graphed_busy_by_events'))}), kernels a "
            f"replay {run.get('graphed_kernels_per_replay')} | eager "
            f"{run['eager_step_ms']:.3f} ms, "
            f"{run['eager_decode_tok_s']:.1f} tok/s, busy "
            f"{fmt_ms(eager_busy)}, kernels a step "
            f"{run.get('eager_kernels_per_step')}")


# --------------------------------------------------------------------------- #
# Phase 5: speculative decoding on the paged server

def spec_traffic(np, vocab, kind):
    """(prompt, temperature) waves.  ``model``: 10 prompts of 64-1,100
    tokens, two sharing a 512-token prefix (the second arrives after the
    first prefilled: a prefix hit); ``adaptive``: six of them; ``short``:
    five of them (the two sharing the prefix, 64, 1,100 and 300)."""
    rng = np.random.default_rng(23)

    def ints(n):
        return rng.integers(1, vocab, n).astype(np.int32)
    prefix = ints(512)
    shared = [np.concatenate([prefix, ints(tail)]) for tail in (64, 200)]
    distinct = [ints(n) for n in (64, 1100, 300, 700, 128, 97, 850, 400)]
    if kind == "adaptive":
        return [[(shared[0], 0.0)] + [(p, 0.0) for p in distinct[:3]],
                [(shared[1], 0.0), (distinct[4], 0.0)]]
    if kind == "short":
        return [[(shared[0], 0.0)] + [(p, 0.0) for p in distinct[:3]],
                [(shared[1], 0.0)]]
    return [[(shared[0], 0.0)] + [(p, 0.0) for p in distinct[:5]],
            [(shared[1], 0.0)] + [(p, 0.0) for p in distinct[5:]]]


#: Phase 5's runs: (draft mode, int8 KV).  The 1b draft under the adaptive
#: controller runs at int8 KV (the ladder's verify widths on an int8 pool);
#: the paged n-gram rounds run in phase 13 (b), whose free pass holds every
#: token to phase 4's oracle and the launches to the rounds and slices.
SPEC_RUNS = (("paired", False), ("adaptive", True), ("paired", True))


def serve_spec(torch, np, llama, quant, weights, kernels, server_cls,
               request_cls, params, quantize_kv, device, mode, draft_params,
               steady_plain=None, short=False):
    """PagedContinuousServer as phase 4 (8 slots, 16-row blocks, prefix
    cache, 256-token chunked admission) with spec_k = 4: ``mode`` is
    "paired" (the target as its own draft) or "adaptive" (an independent
    int8 1b draft, spec_adaptive).  Every
    greedy token is held to phase 4's batch-1 oracle, every request must
    finish with 32 tokens in the vocabulary, the pool must balance, and
    the launches of the verify's kernels are held exactly to the spec
    rounds and prefill slices of the run; on int4 weights, int4_matmul's
    launches to what the shape rule predicts for every projection the run
    made (MatmulShapes).  ``short``: the five-request traffic and no
    steady window."""
    config = llama.CONFIGS["llama3_8b"]
    draft_name = {"paired": "llama3_8b", "adaptive": "1b"}[mode]
    kwargs = dict(config_name="llama3_8b", slots=SLOTS,
                  max_seq=PAGED_MAX_SEQ, chunk_steps=CHUNK_STEPS,
                  params=params, quantize=True, quantize_kv=quantize_kv,
                  block_size=BLOCK, enable_prefix_cache=True,
                  chunk_prefill_tokens=CHUNK, spec_k=SPEC_K, device=device,
                  draft_config_name=draft_name, draft_params=draft_params,
                  spec_adaptive=mode == "adaptive")

    def make_server():
        return server_cls(**kwargs)
    server = make_server()
    server.warm_spec_ladder()          # each rung once on the idle engine
    waves = spec_traffic(np, config.vocab_size,
                         "adaptive" if mode == "adaptive" else
                         "short" if short else "model")
    widths, core = [], llama._prefill_append_core

    def recorded_core(params, tokens, *args, **kwargs):
        widths.append(int(tokens.shape[1]))
        return core(params, tokens, *args, **kwargs)
    requests = []
    shapes = MatmulShapes(llama, quant)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    llama._prefill_append_core = recorded_core
    try:
        with shapes:
            for kernel in kernels:
                kernel.launches = 0
            began = time.monotonic()
            for index, wave in enumerate(waves):
                batch = [request_cls(f"s{len(requests) + i}", prompt,
                                     NEW_TOKENS, temperature=temp,
                                     top_p=0.95 if temp else 1.0)
                         for i, (prompt, temp) in enumerate(wave)]
                requests += batch
                for request in batch:
                    server.submit(request)
                if index == 0:    # the next wave once the producer prefilled
                    while batch[0].first_token_ts is None:
                        server.step()
            server.run_until_drained()
            torch.cuda.synchronize()
            wall = time.monotonic() - began
            launches = {kernel.__name__: kernel.launches
                        for kernel in kernels}
    finally:
        llama._prefill_append_core = core
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = server.stats()
    for request in requests:
        if request.error is not None or len(request.tokens) != NEW_TOKENS \
                or not all(0 <= t < config.vocab_size
                           for t in request.tokens):
            fail(f"spec {mode} request {request.request_id}: error "
                 f"{request.error}, {len(request.tokens)} tokens")
    rounds, slices = stats["spec_rounds"], stats["prefill_dispatches"]
    if len(widths) != slices or rounds <= 0:
        fail(f"spec {mode}: {len(widths)} slices recorded, {slices} counted, "
             f"{rounds} rounds")
    layers = config.n_layers
    draft_layers = llama.CONFIGS[draft_name].n_layers
    want = {"append_kv_ragged": (layers + draft_layers) * rounds,
            "chunk_attention": layers * slices
            + (layers + draft_layers) * rounds,
            "append_kv": layers * slices,
            "flash_attention": draft_layers * len(requests)}
    if mode != "adaptive":
        # Fixed k: every decode step is a draft proposal step.
        want["paged_decode_attention"] = draft_layers * SPEC_K * rounds
    # Every decode step's attention follows its K/V write, one each a layer
    # (the adaptive controller's k varies: the two counts tie).
    want["write_kv_rows"] = want.get("paged_decode_attention",
                                     launches["paged_decode_attention"])
    if weights.bits == 4:
        want.update(shapes.predicted())
        for name in ("int8_matmul", "int4_matmul_scale_first"):
            if name in launches:
                want[name] = 0
    for name, expected in want.items():
        if launches[name] != expected:
            fail(f"spec {mode} {name}: {launches[name]} launches, expected "
                 f"{expected} (rounds {rounds}, slices {slices}, requests "
                 f"{len(requests)})")
    used = (weights.name, "append_kv", "append_kv_ragged",
            "chunk_attention", "paged_decode_attention", "write_kv_rows",
            "flash_attention")
    for name in used:
        if not launches[name]:
            fail(f"spec {mode}: {name} was never launched")
    if mode == "paired" and not stats["spec_tokens_per_target_pass"] > 1.0:
        fail(f"spec paired: {stats['spec_tokens_per_target_pass']} tokens "
             "per target pass")
    balance = server.pool_balance()
    if balance["free"] + balance["evictable"] + balance["producing"] \
            != balance["total"] or balance["producing"]:
        fail(f"spec {mode}: pool out of balance after the drain: {balance}")
    if not peak_gb < 80:
        fail(f"spec {mode}: peak device memory {peak_gb:.2f} GB")
    greedy = [r for r in requests if r.temperature == 0.0]
    if quantize_kv:
        def oracle(request):
            return paged_oracle(torch, llama, server_cls, request_cls,
                                params, config, request.prompt, device)
    else:
        def oracle(request):
            return contiguous_oracle(torch, llama, params, config,
                                     request.prompt, False, device,
                                     rows=PAGED_MAX_SEQ)
    exact, equal, checked, ties = check_requests(torch, greedy, oracle)
    int4_rows = sorted({shape[0] for shape in shapes.shapes
                        if quant.int4_kernel_shape(*shape)})
    run = dict(weights=weights.label, kv="int8" if quantize_kv else "bf16",
               mode=mode, int4_kernel_rows=int4_rows, peak_gb=peak_gb,
               draft=draft_name, requests=len(requests),
               greedy_requests=len(greedy), requests_exact=exact,
               tokens_checked=checked, tokens_equal=equal,
               accepted_near_ties=ties, launches=launches,
               prefill_slices=slices, pool_balance=balance, wall_s=wall,
               served_tok_s=len(requests) * NEW_TOKENS / wall,
               **{key: stats[key] for key in (
                   "spec_rounds", "spec_proposed", "spec_accepted",
                   "spec_acceptance_rate", "spec_tokens_per_target_pass",
                   "spec_rollback_blocks", "spec_k_effective",
                   "spec_ngram_hits", "prefix_hits", "decode_steps")})
    if mode == "paired" and not short and not quantize_kv:
        run.update(steady_spec(torch, np, make_server, request_cls, config,
                               quantize_kv))
        run["phase4_plain_steady_step_ms"] = steady_plain
    return run


def steady_spec(torch, np, make_server, request_cls, config, quantize_kv):
    """Speculative decode at a full batch: 8 requests of 1,023 prompt
    tokens (positions ~1,025-1,090 in the window) with the paired draft;
    after every request has its first token, 6 rounds timed bare (ms a
    round, tokens per target pass, tok/s) and 4 more under torch.profiler
    (the card's kernel time per round by kernel; busy share = kernel time
    per round over the bare round).  Rounds the tracer saw are its
    append_kv_ragged records over the 64 launches of one round."""
    from torch.profiler import ProfilerActivity, profile

    from aiko_services_tpu_torch.ops import paged_prefill as pp
    server = make_server()
    rng = np.random.default_rng(12)
    requests = [request_cls(f"w{i}", rng.integers(
        1, config.vocab_size, 1023).astype(np.int32), 256)
        for i in range(SLOTS)]
    for request in requests:
        server.submit(request)
    while any(r.first_token_ts is None for r in requests):
        server.step()
    stats = server.spec_stats

    def window(rounds):
        passes, accepted = stats.target_passes, stats.accepted
        tokens = server.counters["tokens_committed"]
        torch.cuda.synchronize()
        began = time.perf_counter()
        while stats.target_passes - passes < rounds:
            server.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - began, stats.target_passes - passes,
                stats.accepted - accepted,
                server.counters["tokens_committed"] - tokens)

    wall, rounds, accepted, tokens = window(6)
    round_ms = wall * 1e3 / rounds
    per_round = 2 * config.n_layers
    made = pp.append_kv_ragged.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window(4)
    made = pp.append_kv_ragged.launches - made
    positions = [int(p) for p in server.positions]
    server.run_until_drained()
    averages = prof.key_averages()
    result = dict(steady_round_ms=round_ms, steady_rounds=rounds,
                  steady_tokens_per_target_pass=(accepted + rounds) / rounds,
                  steady_tokens_per_slot_round=tokens / rounds / SLOTS,
                  steady_tok_s=tokens / wall, steady_positions=positions,
                  steady_device_ms_per_round=None, steady_device_busy=None,
                  steady_kernel_ms_per_round=None)
    recorded = sum(e.count for e in averages
                   if "append_kv_ragged_kernel" in e.key)
    device_us = sum(e.self_device_time_total for e in averages)
    if not recorded or not device_us:
        log("--- spec steady: the profiler recorded no append_kv_ragged "
            "launch (not measured)")
        return result
    seen = recorded / per_round
    by_kernel = {}
    for name in ("int8_matmul_kernel", "paged_decode", "chunk_attention",
                 "append_kv_ragged_kernel", "append_kv_kernel",
                 "write_kv_rows_kernel", "flash_attention"):
        us = sum(e.self_device_time_total for e in averages if name in e.key)
        by_kernel[name] = us / 1e3 / seen
    device_ms = device_us / 1e3 / seen
    by_kernel["other (PyTorch glue)"] = device_ms - sum(by_kernel.values())
    log(f"--- spec steady, {'int8' if quantize_kv else 'bf16'} KV "
        f"({device_ms:.3f} ms of kernels a round over {seen:g} rounds; "
        f"append_kv_ragged: {recorded} launches recorded of {made} made "
        "under the profiler):")
    for line in averages.table(sort_by="self_device_time_total",
                               row_limit=10,
                               max_name_column_width=50).splitlines():
        log("  " + line)
    result.update(steady_device_ms_per_round=device_ms,
                  steady_device_busy=device_ms / round_ms,
                  steady_kernel_ms_per_round=by_kernel)
    return result


# --------------------------------------------------------------------------- #
# Phase 8: the wire

#: Wire requests that stream (``stream: 1``): the shared prefix's producer
#: in wave 1, one each in waves 2 and 3.
WIRE_STREAMED = ("p0", "p5", "p10")
#: Budget of the extra streamed request that is cancelled after its first
#: partial: long enough that the cancel lands while it still decodes.
WIRE_CANCEL_TOKENS = 4 * NEW_TOKENS
#: Seconds the caller waits for any one answer before the run fails.
WIRE_TIMEOUT_S = 120.0


class ErrorRecords(logging.Handler):
    """Keeps every log record at ERROR or above: a command that raises on
    the engine thread is logged and swallowed by the actor runtime (the
    protocol keeps the loop alive), so the smoke fails on the log
    instead."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(
            f"{record.name}: {record.getMessage()}"
            + (f" ({record.exc_info[1]!r})" if record.exc_info else ""))


def warm_wire_server(np, server_cls, request_cls, params, device, config,
                     quantize_kv=False, **kwargs):
    """Phase 8's PagedContinuousServer (8 slots, 4096-row tables of 16-row
    blocks, prefix cache, 256-token slices, bf16 KV unless
    ``quantize_kv``; ``kwargs`` for phase 9's tiers), warmed and fenced
    before any traffic (:func:`warm_and_fence`)."""
    server = server_cls(config_name="llama3_8b", slots=SLOTS,
                        max_seq=PAGED_MAX_SEQ, chunk_steps=CHUNK_STEPS,
                        params=params, quantize=True, quantize_kv=quantize_kv,
                        block_size=BLOCK, enable_prefix_cache=True,
                        chunk_prefill_tokens=CHUNK, device=device, **kwargs)
    return warm_and_fence(np, server, request_cls, config, 100)


def warm_and_fence(np, server, request_cls, config, prompt_len):
    """Warm ``server`` before any traffic: two short requests of
    ``prompt_len`` tokens, one after the other, meet both chunk keys of
    the run (2 and 1 steps) twice, so both are captured; then the fence
    drops and any later capture counts."""
    rng = np.random.default_rng(23)
    for index in range(2):
        server.submit(request_cls(f"warm{index}", rng.integers(
            1, config.vocab_size, prompt_len).astype(np.int32), 5))
        server.run_until_drained()
    server.graph_ledger.fence()
    return server


def wire_cancel_prompt(np, vocab):
    """The prompt of phase 8's 13th request, the one cancelled."""
    return np.random.default_rng(29).integers(1, vocab, 200).astype(np.int32)


def percentiles(values):
    """(p50, max) of a list of numbers: the upper median, as elsewhere in
    the smoke."""
    values = sorted(values)
    return values[len(values) // 2], values[-1]


def caller_side(sent_at, first_at, answered_at, began):
    """The end-to-end numbers a caller sees, from its own clock: TTFT over
    the requests that stream (the three of WIRE_STREAMED and the
    cancelled one: a request that does not stream shows its first token
    only with its answer), send-to-answer over the 12 that finish, and
    served tok/s over the 12 from the first send to the last answer."""
    ttft = [(first_at[name] - sent_at[name]) * 1e3
            for name in WIRE_STREAMED + ("cancel",)]
    finished = [name for name in sent_at if name != "cancel"]
    totals = [(answered_at[name] - sent_at[name]) * 1e3 for name in finished]
    wall = max(answered_at[name] for name in finished) - began
    ttft_p50, ttft_max = percentiles(ttft)
    total_p50, total_max = percentiles(totals)
    return dict(client_ttft_ms_p50=ttft_p50, client_ttft_ms_max=ttft_max,
                client_total_ms_p50=total_p50, client_total_ms_max=total_max,
                wall_s=wall,
                served_tok_s=len(finished) * NEW_TOKENS / wall)


def serve_direct_twin(torch, np, config, server, request_cls):
    """Phase 8's traffic and pacing driven by ``step()`` on the caller's
    thread, on a server warmed as the wire's was.  The caller is the
    client here: a request's first token and its answer are stamped when
    the ``step()`` that delivered them returns, on the definitions
    :func:`caller_side` uses for the wire.  Also TTFT / total from the
    requests' own stamps (what the replica's ``*_ms`` fields read), the
    run's captures, and the requests' tokens."""
    waves = paged_traffic(np, config.vocab_size)
    requests, tracked = [], []
    sent_at, first_at, answered_at = {}, {}, {}
    before = server.stats()

    def step():
        done = server.step()
        now = time.monotonic()
        for request in tracked:
            if request.tokens:
                first_at.setdefault(request.request_id, now)
        for request in done:
            answered_at.setdefault(request.request_id, now)

    def submit(request):
        tracked.append(request)
        sent_at[request.request_id] = time.monotonic()
        server.submit(request)

    began = time.monotonic()
    for index, wave in enumerate(waves):
        batch = [request_cls(f"p{len(requests) + i}", prompt, NEW_TOKENS)
                 for i, prompt in enumerate(wave)]
        requests += batch
        for request in batch:
            submit(request)
        if index == 0:
            while batch[0].request_id not in first_at:
                step()
        elif index == 1:
            while any(r.request_id not in answered_at for r in requests[:4]):
                step()
    cancelled = request_cls("cancel", wire_cancel_prompt(
        np, config.vocab_size), WIRE_CANCEL_TOKENS)
    submit(cancelled)
    while "cancel" not in first_at:
        step()
    server.cancel("cancel")
    while server.busy or any(r.request_id not in answered_at
                             for r in tracked):
        step()
    torch.cuda.synchronize()
    for request in requests:
        if request.error is not None or len(request.tokens) != NEW_TOKENS:
            fail(f"direct twin: {request.request_id} error {request.error}, "
                 f"{len(request.tokens)} tokens")
    if cancelled.error != "cancelled":
        fail(f"direct twin: the cancel ended {cancelled.error!r}")
    ttft_p50, ttft_max = percentiles(
        (r.first_token_ts - r.submitted_ts) * 1e3 for r in requests)
    total_p50, _ = percentiles(
        (r.finished_ts - r.submitted_ts) * 1e3 for r in requests)
    stats = server.stats()
    return dict(caller_side(sent_at, first_at, answered_at, began),
                ttft_ms_p50=ttft_p50, ttft_ms_max=ttft_max,
                total_ms_p50=total_p50,
                run_graph_captures=stats["graph_captures"]
                - before["graph_captures"],
                run_graph_replays=stats["graph_replays"]
                - before["graph_replays"],
                tokens={r.request_id: r.tokens for r in requests})


def serve_wire_turn(torch, np, llama, weights, kernels, server_cls,
                    request_cls, params, device, observe=False):
    """Phase 4's traffic through the wire, once: a fresh
    PagedContinuousServer (:func:`warm_wire_server`) behind a
    ContinuousReplica on a loopback broker, an InferClient on a real
    EventEngine in its own thread.  The caller's thread only publishes
    and waits, so every server call, capture and launch runs on the
    engine thread.  Checks every answer, partials against the final
    tokens, the cancel, the graph counters, exact launches, the
    ``(metrics)`` scrape and the replica's drained share; returns the
    run, the served requests and the cancelled one, for the oracle.
    End-to-end numbers are the client's (:func:`caller_side`); the
    responses' ``*_ms`` fields, stamped by the server from its submit,
    are the server layer's.  With ``observe``, after the traffic:
    :func:`wire_observability` over the same replica."""
    import threading

    from aiko_services_tpu_torch.orchestration.client import InferClient
    from aiko_services_tpu_torch.orchestration.continuous import (
        ContinuousReplica)
    from aiko_services_tpu_torch.runtime import (EventEngine, Process,
                                                 actor_args,
                                                 compose_instance)
    from aiko_services_tpu_torch.transport import reset_brokers
    from aiko_services_tpu_torch.utils.sexpr import generate, parse

    config = llama.CONFIGS["llama3_8b"]
    server = warm_wire_server(np, server_cls, request_cls, params, device,
                              config)
    before = server.stats()

    errors = ErrorRecords()
    logging.getLogger().addHandler(errors)
    reset_brokers()
    engine = EventEngine()
    process = Process(namespace="smoke", hostname="card", pid="1",
                      engine=engine, broker="wire")
    replica = compose_instance(ContinuousReplica, actor_args("llama3_8b"),
                               process=process, server=server)
    client = InferClient(process, replica.topic_in)
    scraped, scrape_done = [], threading.Event()

    def on_metrics(_topic, payload):
        command, params_ = parse(payload)
        if command == "metrics_response":
            scraped.append(str(params_[1]))
            scrape_done.set()
    process.add_message_handler(on_metrics, f"{replica.topic_path}/scrape")
    # Client-side stamps: when each request was sent, when its first
    # partial and its answer reached the client's topic (the partial in
    # the client's own callback, the answer beside its handler).
    sent_at, first_at, answered_at = {}, {}, {}

    def on_answer(_topic, payload):
        command, params_ = parse(payload)
        if command == "infer_response":
            answered_at.setdefault(str(params_[0]), time.monotonic())
    process.add_message_handler(on_answer, client.response_topic)

    waves = paged_traffic(np, config.vocab_size)
    widths, core = [], llama._prefill_append_core

    def recorded_core(params_, tokens, *args, **kwargs):
        widths.append(int(tokens.shape[1]))
        return core(params_, tokens, *args, **kwargs)

    first_partial = {}

    def submit(name, prompt, budget, stream):
        first_partial[name] = threading.Event()

        def on_partial(_increment):
            first_at.setdefault(name, time.monotonic())
            first_partial[name].set()
        sent_at[name] = time.monotonic()
        future = client.submit(
            prompt, max_new_tokens=budget, stream=stream, request_id=name,
            on_partial=on_partial)
        return name, prompt, future

    def wait(future):
        client.wait(future, timeout=WIRE_TIMEOUT_S)
        if future.error == "timeout":
            fail(f"wire: request {future.request_id} was not answered in "
                 f"{WIRE_TIMEOUT_S:.0f} s ({errors.records})")

    def wait_partial(name):
        if not first_partial[name].wait(WIRE_TIMEOUT_S):
            fail(f"wire: no partial of {name} in {WIRE_TIMEOUT_S:.0f} s "
                 f"({errors.records})")

    torch.cuda.synchronize()
    llama._prefill_append_core = recorded_core
    thread = None
    try:
        for kernel in kernels:
            kernel.launches = 0
        thread = engine.run_in_thread()
        began = time.monotonic()
        sent = []
        for index, wave in enumerate(waves):
            batch = [submit(f"p{len(sent) + i}", prompt, NEW_TOKENS,
                            f"p{len(sent) + i}" in WIRE_STREAMED)
                     for i, prompt in enumerate(wave)]
            sent += batch
            if index == 0:      # the next wave once the producer prefilled
                wait_partial(batch[0][0])
            elif index == 1:    # the last once wave 1's requests finished
                for _, _, future in sent[:4]:
                    wait(future)
        cancelled = submit("cancel", wire_cancel_prompt(
            np, config.vocab_size), WIRE_CANCEL_TOKENS, True)
        wait_partial("cancel")
        client.cancel(cancelled[2])
        for _, _, future in sent:
            wait(future)
        wait(cancelled[2])
        process.message.publish(replica.topic_in, generate(
            "metrics", [f"{replica.topic_path}/scrape"]))
        if not scrape_done.wait(WIRE_TIMEOUT_S):
            fail("wire: no (metrics_response ...)")
        observed = (wire_observability(np, process, replica, client,
                                       config) if observe else None)
        deadline = time.monotonic() + WIRE_TIMEOUT_S
        while (replica._pumping or server.busy) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        pumping = replica._pumping
        engine.terminate()
        thread.join(WIRE_TIMEOUT_S)
        torch.cuda.synchronize()
        launches = {kernel.__name__: kernel.launches for kernel in kernels}
    finally:
        llama._prefill_append_core = core
        logging.getLogger().removeHandler(errors)
        if thread is not None and thread.is_alive():
            engine.terminate()
    if thread.is_alive():
        fail("wire: the engine thread did not stop")
    process.terminate()
    reset_brokers()
    if errors.records:
        fail(f"wire: logged failures: {errors.records}")
    if pumping:
        fail("wire: the replica still pumps after the drain")
    extra = len(WIRE_PROFILED) if observe else 0
    if replica.share.get("requests_served") != len(sent) + 1 + extra:
        fail(f"wire: requests_served {replica.share.get('requests_served')}"
             f", expected {len(sent) + 1 + extra}")

    served = []
    for name, prompt, future in sent:
        outputs = future.outputs or {}
        if future.error is not None or "tokens_out" not in outputs:
            fail(f"wire: {name} answered error {future.error!r}")
        tokens = [int(t) for t in np.asarray(outputs["tokens_out"])]
        if len(tokens) != NEW_TOKENS:
            fail(f"wire: {name} has {len(tokens)} tokens")
        if name in WIRE_STREAMED and future.partial_tokens != tokens:
            fail(f"wire: {name}'s partials {future.partial_tokens} differ "
                 f"from its tokens_out {tokens}")
        request = request_cls(name, prompt, NEW_TOKENS)
        request.tokens = tokens
        served.append((request, outputs))
    name, prompt, future = cancelled
    tokens = future.tokens
    if future.error != "cancelled" or not tokens \
            or len(tokens) >= WIRE_CANCEL_TOKENS \
            or future.partial_tokens != tokens:
        fail(f"wire: the cancelled request answered {future.error!r} with "
             f"{len(tokens)} tokens (partials {len(future.partial_tokens)})")
    cancel_request = request_cls(name, prompt, WIRE_CANCEL_TOKENS)
    cancel_request.tokens = tokens

    stats = server.stats()
    if not stats["graph_replays"] > before["graph_replays"]:
        fail("wire: no decode chunk replayed a CUDA graph")
    if stats["graph_captures_steady_state"]:
        fail(f"wire: {stats['graph_captures_steady_state']} captures after "
             "the fence")
    slices = stats["prefill_dispatches"] - before["prefill_dispatches"]
    steps = stats["decode_steps"] - before["decode_steps"]
    if len(widths) != slices:
        fail(f"wire: {len(widths)} prefill slices recorded, the server "
             f"counted {slices}")
    layers = config.n_layers
    want = {"append_kv": layers * slices, "chunk_attention": layers * slices,
            "paged_decode_attention": layers * steps,
            "write_kv_rows": layers * steps}
    for name in weights.rules:
        want[name] = matmul_launches(weights, config, SLOTS, 1, name) \
            * steps + sum(layer_launches(weights, config, w, name)
                          for w in widths)
    for name, expected in want.items():
        if launches[name] != expected or expected == 0:
            fail(f"wire {name}: {launches[name]} launches, expected "
                 f"{expected} (decode_steps {steps}, slices {widths})")
    for name, count in launches.items():
        if name not in want and count:
            fail(f"the wire's path launched {name} {count} times")
    text = scraped[0]
    label = f'instance="srv{server._instance_id}"'
    named = [key for key in ("decode_steps", "tokens_committed",
                             "prefill_dispatches", "watchdog_trips")
             if f"aiko_server_{key}{{{label}}}" in text]
    if len(named) != 4 or "aiko_latency_ttft_ms_bucket" not in text:
        fail(f"wire: the (metrics) text names {named} of the server's "
             "counters, or no TTFT histogram")

    ttft_p50, ttft_max = percentiles(float(np.asarray(o["ttft_ms"]))
                                     for _, o in served)
    total_p50, _ = percentiles(float(np.asarray(o["total_ms"]))
                               for _, o in served)
    # The wire's own time a request: the client's send-to-answer span
    # less the server's submit-to-finish span (``total_ms``).
    wire_p50, wire_max = percentiles(
        (answered_at[r.request_id] - sent_at[r.request_id]) * 1e3
        - float(np.asarray(o["total_ms"])) for r, o in served)
    run = dict(caller_side(sent_at, first_at, answered_at, began),
               weights=weights.label, kv="bf16", server="paged, wire",
               requests=len(served) + 1, cancelled_tokens=len(tokens),
               launches=launches, decode_steps=steps, prefill_slices=slices,
               metrics_counters_named=named,
               requests_served=replica.share["requests_served"],
               ttft_ms_p50=ttft_p50, ttft_ms_max=ttft_max,
               total_ms_p50=total_p50,
               wire_ms_per_request_p50=wire_p50,
               wire_ms_per_request_max=wire_max,
               run_graph_captures=stats["graph_captures"]
               - before["graph_captures"],
               run_graph_replays=stats["graph_replays"]
               - before["graph_replays"],
               graph_captures_steady_state=stats[
                   "graph_captures_steady_state"])
    if observed is not None:
        run["observability"] = observed
    return run, served, cancel_request


#: The wire turn's (profile 4) bracket: two requests (prompt tokens, new
#: tokens) that keep the replica stepping through it.
WIRE_PROFILED = ((24, 16), (40, 16))
WIRE_PROFILE_STEPS = 4


def wire_observability(np, process, replica, client, config):
    """Phase 8's observability hooks over its replica, on the engine
    thread: with a flight recorder, the capture ledger and the pool
    auditor installed, ``(profile 4)`` must answer ``started``; two
    requests carry the bracket (its manifest must carry device step ms
    by CUDA events); ``(census)`` must answer a bundle path whose bundle
    has the census, profile and compiles sections, which
    ``tools/doctor`` renders.  Everything is uninstalled after."""
    import shutil
    import tempfile
    import threading

    from aiko_services_tpu_torch.obs import (compiles, flight, pool_audit,
                                             profiler)
    from aiko_services_tpu_torch.tools import doctor
    from aiko_services_tpu_torch.utils.sexpr import generate, parse

    root = tempfile.mkdtemp(prefix="aiko_obs_")
    answers, answered = {}, threading.Event()
    topic = f"{replica.topic_path}/ops"

    def on_answer(_topic, payload):
        command, params_ = parse(payload)
        answers[command] = str(params_[1])
        answered.set()
    process.add_message_handler(on_answer, topic)

    def ask(command, args):
        answered.clear()
        process.message.publish(replica.topic_in, generate(command, args))
        if not answered.wait(WIRE_TIMEOUT_S):
            fail(f"wire: no answer to ({command} ...)")
    try:
        flight.install(out_dir=root, service="smoke")
        compiles.install(service="smoke")
        pool_audit.install(service="smoke", sweep_every=8)
        began = time.monotonic()
        ask("profile", [WIRE_PROFILE_STEPS, "", topic, "phase 8"])
        if answers.get("profile_response") != "started":
            fail(f"wire: (profile) answered {answers}")
        rng = np.random.default_rng(41)
        futures = [client.submit(rng.integers(1, config.vocab_size, plen)
                                 .astype(np.int32), max_new_tokens=new,
                                 request_id=f"prof{i}")
                   for i, (plen, new) in enumerate(WIRE_PROFILED)]
        for future, (_, new) in zip(futures, WIRE_PROFILED):
            client.wait(future, timeout=WIRE_TIMEOUT_S)
            if future.error is not None or len(future.tokens) != new:
                fail(f"wire: a bracket request answered {future.error!r}")
        manifest = profiler.LAST
        if profiler.PROFILER is not None or manifest is None \
                or not manifest["ok"] or manifest["timing"] != "cuda_events" \
                or not manifest["device_step_ms"] > 0 \
                or manifest["steps"] < WIRE_PROFILE_STEPS:
            fail(f"wire: the profile bracket did not finish: {manifest}")
        ask("census", ["", topic, "phase 8"])
        path = answers.get("census_response", "")
        if not os.path.isfile(path):
            fail(f"wire: (census) answered {path!r}")
        with open(path) as handle:
            bundle = json.load(handle)
        if not {"census", "profile", "compiles"} <= set(bundle):
            fail(f"wire: the census bundle has sections {sorted(bundle)}")
        census = bundle["census"]
        if not census["census"]["tiers"]["hbm"]["blocks"] \
                or census["violations_total"]:
            fail(f"wire: census {census['census']['tiers']}, "
                 f"{census['violations_total']} violations")
        report = doctor.render_report(bundle)
        if "pool census:" not in report or "device profile" not in report:
            fail("wire: the doctor's report lacks the census or profile")
        return dict(profile_response=answers["profile_response"],
                    profile_steps=manifest["steps"],
                    profile_device_step_ms=manifest["device_step_ms"],
                    profile_chunks=manifest["chunks"],
                    trace_bytes=sum(a["bytes"]
                                    for a in manifest["artifacts"]),
                    census_tiers=census["census"]["tiers"],
                    audit_sweeps=census["sweeps"],
                    audit_violations=census["violations_total"],
                    compiles_section=dict(
                        captures=bundle["compiles"]["compiles"],
                        cache_hits=bundle["compiles"]["cache_hits"]),
                    doctor_lines=len(report.splitlines()),
                    seconds=round(time.monotonic() - began, 1))
    finally:
        profiler.uninstall()
        pool_audit.uninstall()
        compiles.uninstall()
        flight.uninstall()
        shutil.rmtree(root, ignore_errors=True)


#: Phase 8's turns, in order, each on a fresh server warmed the same way:
#: the wire, then its direct twin (one of each, to make room for phase 12).
#: ``scripts/smoke_wire.py`` runs WIRE_TURN_PAIRS, a pair of each kind,
#: alternating, so that the wire's end-to-end cost is read against the
#: spread between turns of one kind.
WIRE_TURNS = ("wire", "direct")
WIRE_TURN_PAIRS = ("wire", "direct", "direct", "wire")
#: What each turn reports in the phase's spread, all from the caller's
#: clock except the wire's own time a request.
WIRE_TURN_KEYS = ("served_tok_s", "client_ttft_ms_p50", "client_ttft_ms_max",
                  "client_total_ms_p50", "client_total_ms_max", "wall_s")


def serve_wire(torch, np, llama, weights, kernels, server_cls, request_cls,
               params, device, turn_kinds=WIRE_TURNS):
    """Phase 8: the ``turn_kinds`` turns of phase 4's traffic, through the
    wire (:func:`serve_wire_turn`) and by ``step()`` on the caller's
    thread (:func:`serve_direct_twin`).  Every wire turn makes every
    check; the first one's greedy tokens are held to phase 4's bf16
    oracle.  Returns the first wire turn with its oracle counts, the
    first direct turn as ``direct_twin``, every turn's numbers, and per
    kind the least and most of each, with the wire's margin."""
    import gc

    config = llama.CONFIGS["llama3_8b"]
    first, twin, turns, wire_tokens = None, None, [], None
    for kind in turn_kinds:
        if kind == "wire":
            run, served, cancel_request = serve_wire_turn(
                torch, np, llama, weights, kernels, server_cls, request_cls,
                params, device, observe=first is None)
            if first is None:
                first = run
                exact, equal, checked, ties = check_requests(
                    torch, [request for request, _ in served]
                    + [cancel_request],
                    lambda request: contiguous_oracle(
                        torch, llama, params, config, request.prompt,
                        False, device, rows=PAGED_MAX_SEQ))
                first.update(requests_exact=exact, tokens_checked=checked,
                             tokens_equal=equal, accepted_near_ties=ties)
                wire_tokens = {r.request_id: r.tokens for r, _ in served}
        else:
            run = serve_direct_twin(
                torch, np, config, warm_wire_server(
                    np, server_cls, request_cls, params, device, config),
                request_cls)
            tokens = run.pop("tokens")
            if twin is None:
                twin = run
        turns.append(dict(kind=kind, **{key: run[key]
                                        for key in WIRE_TURN_KEYS}))
        if kind == "wire":
            turns[-1]["wire_ms_per_request_p50"] = \
                run["wire_ms_per_request_p50"]
        else:
            turns[-1]["requests_equal_to_first_wire_turn"] = sum(
                tokens[name] == wire_tokens.get(name) for name in tokens)
        gc.collect()
        torch.cuda.empty_cache()
    spread = {}
    for key in WIRE_TURN_KEYS:
        for kind in ("wire", "direct"):
            values = [turn[key] for turn in turns if turn["kind"] == kind]
            spread[f"{kind}_{key}_min"] = min(values)
            spread[f"{kind}_{key}_max"] = max(values)
    first.update(direct_twin=twin, turns=turns, spread=spread)
    return first


# --------------------------------------------------------------------------- #
# Phase 9: the KV tiers and the KV wire

#: Phase 9 (a): the pool (usable blocks), the host tier and the restore
#: rate.  The shared prefix's request reserves 130 blocks and caches 64;
#: two distinct prompts fill the pool; a third long one then demotes the
#: prefix's whole chain (least recently used, leaf first) to the host tier,
#: and the prefix's re-submission restores it while two slots decode.
TIER_POOL, TIER_HOST, TIER_RATE = 280, 256, 4
#: Phase 9 (b): the spill server's pool and its small host tier: two long
#: prompts after the prefix overflow its whole chain to disk, so a fresh
#: server over the same directory adopts it.
SPILL_POOL, SPILL_HOST = 140, 16
#: Phase 9 (c), (d): how long an importer waits for the owner's export
#: before it falls back to local prefill.  The reference's 2.0 s need not
#: cover a 64-block llama3_8b payload (134 MB at bf16) through the codec's
#: base64; a fall-back fails the phase either way.
KV_FETCH_TIMEOUT_S = 60.0
#: Phase 9 (c): the prefix request on a fresh replica B a turn, pulling the
#: prefix from A ("warm") or prefilling it ("cold"): one of each, to make
#: room for phase 12.
KV_TURNS = ("warm", "cold")
#: Phase 9 (d): tokens streamed before ``migrate_prepare`` is sent.
MIGRATE_AFTER = 8


class LaunchWindow:
    """The kernels' launch counts over a stretch of serving: every count
    set to 0 on entry and read on exit, the width of every prefill slice
    recorded around the append-prefill core; :meth:`hold` holds them to
    the decode steps and slices of the stretch (phase 4's formula)."""

    def __init__(self, llama, kernels):
        self.llama, self.kernels = llama, kernels
        self.widths, self.launches = [], None

    def __enter__(self):
        core = self._core = self.llama._prefill_append_core
        widths = self.widths

        def recorded_core(params, tokens, *args, **kwargs):
            widths.append(int(tokens.shape[1]))
            return core(params, tokens, *args, **kwargs)
        for kernel in self.kernels:
            kernel.launches = 0
        self.llama._prefill_append_core = recorded_core
        return self

    def __exit__(self, *exc):
        self.llama._prefill_append_core = self._core
        self.launches = {kernel.__name__: kernel.launches
                         for kernel in self.kernels}
        return False

    def hold(self, where, weights, config, steps, slices):
        if len(self.widths) != slices:
            fail(f"{where}: {len(self.widths)} prefill slices recorded, the "
                 f"servers counted {slices}")
        layers = config.n_layers
        want = {"append_kv": layers * slices,
                "chunk_attention": layers * slices,
                "paged_decode_attention": layers * steps,
                "write_kv_rows": layers * steps}
        for name in weights.rules:
            want[name] = matmul_launches(weights, config, SLOTS, 1, name) \
                * steps + sum(layer_launches(weights, config, w, name)
                              for w in self.widths)
        for name, expected in want.items():
            if self.launches[name] != expected or expected == 0:
                fail(f"{where} {name}: {self.launches[name]} launches, "
                     f"expected {expected} (decode_steps {steps}, slices "
                     f"{self.widths})")
        for name, count in self.launches.items():
            if name not in want and count:
                fail(f"{where}: the path launched {name} {count} times")
        return self.launches


def phase9_oracle(torch, llama, server_cls, request_cls, params, config,
                  quantize_kv, device):
    """Phase 4's oracle of one request: bf16 KV the contiguous batch-1
    prefill + decode, int8 KV a batch-1 paged run."""
    if quantize_kv:
        return lambda request: paged_oracle(
            torch, llama, server_cls, request_cls, params, config,
            request.prompt, device)
    return lambda request: contiguous_oracle(
        torch, llama, params, config, request.prompt, False, device,
        rows=PAGED_MAX_SEQ)


def kv_block_bytes(config, quantize_kv):
    """Pool bytes of one 16-row block over every layer: K and V (bf16, or
    int8 with f32 scale planes)."""
    rows = BLOCK * config.n_kv_heads
    per_layer = 2 * rows * config.head_dim * (1 if quantize_kv else 2)
    if quantize_kv:
        per_layer += 2 * rows * 4
    return config.n_layers * per_layer


def delta(after, before, key):
    return after[key] - before[key]


def owned_by_tier(np, server, entry, rows):
    """A host-tier row lies in its arena row, or in memory of its own
    (an ndarray at the root of its views, never a staging tensor)."""
    if entry.get("slot") is not None:
        return rows.base is not None and np.shares_memory(
            rows, server._host_arena[entry["slot"]])
    while isinstance(rows.base, np.ndarray):
        rows = rows.base
    return rows.base is None


def host_memory(torch):
    """Pinned bytes the caching host allocator has handed out and holds
    (handed out or cached), where this PyTorch reports them, and the
    process's resident bytes."""
    stats = torch.cuda.host_memory_stats() \
        if hasattr(torch.cuda, "host_memory_stats") else {}
    with open("/proc/self/statm") as statm:
        resident = int(statm.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    return dict(pinned_active=stats.get("active_bytes.current"),
                pinned_held=stats.get("allocated_bytes.current"),
                resident=resident)


def audit_begin(where):
    """Phase 9's pool auditor, installed before the server it watches is
    built (so the flow integral is exact from block zero), sweeping every
    step."""
    from aiko_services_tpu_torch.obs import pool_audit
    return pool_audit.install(service=f"phase9_{where}", sweep_every=1)


def audit_end(where, server):
    """Uninstall the auditor after its server's run: its sweeps found no
    violation, and the tiers' blocks and bytes integrated from its flow
    counters alone equal the server's census."""
    from aiko_services_tpu_torch.obs import pool_audit
    auditor = pool_audit.AUDITOR
    pool_audit.uninstall()
    census = server.pool_census()["tiers"]
    integral = {field: auditor.accountant.occupancy_from_flows(field)
                for field in ("blocks", "bytes")}
    want = {field: {tier: census[tier][field] for tier in pool_audit.TIERS}
            for field in ("blocks", "bytes")}
    if auditor.violations_total or not auditor.sweeps or integral != want:
        fail(f"{where}: {auditor.violations_total} audit violations "
             f"({auditor.last_violations}) in {auditor.sweeps} sweeps; flow "
             f"integral {integral} against the census {want}")
    return dict(audit_sweeps=auditor.sweeps,
                audit_violations=auditor.violations_total,
                flow_integral_blocks=integral["blocks"])


def serve_tier(torch, np, llama, weights, kernels, server_cls, request_cls,
               params, quantize_kv, device):
    """Phase 9 (a): the host tier.  Phase 4's server shape with a pool of
    TIER_POOL blocks and a host tier of TIER_HOST, warmed and fenced; the
    shared prefix's request, two distinct prompts (1,800 and 700 tokens),
    then one that decodes long (64 tokens) and a third long prompt whose
    reservation demotes the prefix's chain; once that one has its first
    token the prefix comes back with another tail and its chain restores
    TIER_RATE blocks a step while both decode.  Every token is held to
    the oracle, the launches to the steps and slices.  After the
    demotion burst every host-tier row must lie in the tier's own
    pageable memory (no view of a pinned staging buffer); the pinned and
    resident bytes are reported beside the tier's."""
    from aiko_services_tpu_torch.kvstore.directory import chain_keys

    config = llama.CONFIGS["llama3_8b"]
    audit_begin("tier")
    server = warm_wire_server(
        np, server_cls, request_cls, params, device, config,
        quantize_kv=quantize_kv, total_blocks=TIER_POOL,
        host_tier_blocks=TIER_HOST, restore_blocks_per_step=TIER_RATE)
    before = server.stats()
    waves = paged_traffic(np, config.vocab_size)
    shared0, shared1, short, long0 = waves[0]
    mid = waves[1][4]
    long1 = np.random.default_rng(31).integers(
        1, config.vocab_size, 1800).astype(np.int32)
    prefix_keys = chain_keys(shared0, BLOCK)[:64]
    requests = []

    def submit(name, prompt, budget):
        request = request_cls(name, prompt, budget)
        requests.append(request)
        server.submit(request)
        return request

    restore_steps = overlapped = 0
    torch.cuda.synchronize()
    memory_before = host_memory(torch)
    with LaunchWindow(llama, kernels) as window:
        began = time.monotonic()
        submit("prefix", shared0, NEW_TOKENS)
        server.run_until_drained()
        submit("long0", long0, NEW_TOKENS)
        submit("mid", mid, NEW_TOKENS)
        server.run_until_drained()
        active = submit("active", short, 2 * NEW_TOKENS)
        heavy = submit("long1", long1, NEW_TOKENS)
        while heavy.first_token_ts is None:
            server.step()
        demoted = sum(key in server._host for key in prefix_keys)
        if demoted != len(prefix_keys):
            fail(f"tier: {demoted} of the prefix's {len(prefix_keys)} "
                 "blocks in the host tier before its re-submission")
        if any(not owned_by_tier(np, server, entry, rows)
               for entry in server._host.values()
               for rows in entry["rows"].values()):
            fail("tier: a host-tier row is not in the tier's own memory")
        memory_burst = host_memory(torch)
        burst_host_bytes = server.kv_host_bytes
        again = submit("again", shared1, NEW_TOKENS)
        while server.busy:
            queued = len(server._restoring)
            emitted = len(active.tokens) + len(heavy.tokens)
            server.step()
            if queued:
                restore_steps += 1
                overlapped += len(active.tokens) + len(heavy.tokens) \
                    > emitted
        torch.cuda.synchronize()
        wall = time.monotonic() - began
    stats = server.stats()
    audit = audit_end("tier", server)
    for request in requests:
        if request.error is not None \
                or len(request.tokens) != request.max_new_tokens:
            fail(f"tier: {request.request_id} error {request.error}, "
                 f"{len(request.tokens)} tokens")
    steps = delta(stats, before, "decode_steps")
    launches = window.hold("tier", weights, config, steps,
                           delta(stats, before, "prefill_dispatches"))
    restores = delta(stats, before, "kv_restores")
    if restores != len(prefix_keys) \
            or delta(stats, before, "prefix_hits_host") != 1:
        fail(f"tier: {restores} blocks restored, "
             f"{delta(stats, before, 'prefix_hits_host')} host hits")
    if restore_steps < len(prefix_keys) // TIER_RATE or not overlapped:
        fail(f"tier: the restore took {restore_steps} steps, {overlapped} "
             "of them with decode tokens")
    if stats["graph_captures_steady_state"] \
            or not delta(stats, before, "graph_replays"):
        fail(f"tier: {stats['graph_captures_steady_state']} captures after "
             f"the fence, {delta(stats, before, 'graph_replays')} replays")
    balance = server.pool_balance()
    if balance["free"] + balance["evictable"] + balance["producing"] \
            != balance["total"] or balance["producing"]:
        fail(f"tier: pool out of balance after the drain: {balance}")
    exact, equal, checked, ties = check_requests(
        torch, requests, phase9_oracle(torch, llama, server_cls, request_cls,
                                       params, config, quantize_kv, device))
    ttft = {r.request_id: (r.first_token_ts - r.submitted_ts) * 1e3
            for r in requests}
    return dict(
        requests=len(requests), requests_exact=exact, tokens_checked=checked,
        tokens_equal=equal, accepted_near_ties=ties, launches=launches,
        decode_steps=steps, prefill_slices=len(window.widths),
        demotions=delta(stats, before, "kv_demotions"),
        restores=restores, restore_steps=restore_steps,
        restore_steps_with_decode_tokens=overlapped,
        host_blocks_after=stats["kv_host_blocks"],
        host_bytes_after=stats["kv_host_bytes"],
        burst_host_tier_bytes=burst_host_bytes,
        burst_pinned_active_bytes=memory_burst["pinned_active"],
        burst_pinned_held_bytes=memory_burst["pinned_held"],
        pinned_held_bytes_before=memory_before["pinned_held"],
        burst_resident_growth_bytes=(memory_burst["resident"]
                                     - memory_before["resident"]),
        prefix_hits_host=delta(stats, before, "prefix_hits_host"),
        export_syncs=delta(stats, before, "kv_export_sync_count"),
        transfer_host_ms=delta(stats, before, "kv_transfer_host_ms"),
        prefix_ttft_ms=ttft["prefix"], restored_ttft_ms=ttft["again"],
        run_graph_replays=delta(stats, before, "graph_replays"),
        graph_captures_steady_state=stats["graph_captures_steady_state"],
        wall_s=wall, **audit)


def serve_spill(torch, np, llama, weights, kernels, server_cls, request_cls,
                params, quantize_kv, device):
    """Phase 9 (b): the disk tier and a warm restart.  A server of
    SPILL_POOL blocks with a SPILL_HOST-block host tier over a temporary
    spill directory serves the shared prefix, then two 1,800-token
    prompts whose reservations demote its chain through the host tier to
    disk; a fresh server over the directory adopts it and serves the
    prefix with another tail from disk.  The directory is removed at the
    end."""
    import shutil
    import tempfile

    config = llama.CONFIGS["llama3_8b"]
    root = tempfile.mkdtemp(prefix="aiko_spill_")

    def make_server():
        return server_cls(config_name="llama3_8b", slots=SLOTS,
                          max_seq=PAGED_MAX_SEQ, chunk_steps=CHUNK_STEPS,
                          params=params, quantize=True,
                          quantize_kv=quantize_kv, block_size=BLOCK,
                          enable_prefix_cache=True,
                          chunk_prefill_tokens=CHUNK,
                          total_blocks=SPILL_POOL,
                          host_tier_blocks=SPILL_HOST, spill_dir=root,
                          device=device)

    waves = paged_traffic(np, config.vocab_size)
    shared0, shared1, _, long0 = waves[0]
    long1 = np.random.default_rng(31).integers(
        1, config.vocab_size, 1800).astype(np.int32)
    try:
        torch.cuda.synchronize()
        with LaunchWindow(llama, kernels) as window:
            audit_begin("spill")
            first = make_server()
            for name, prompt in (("prefix", shared0), ("long0", long0),
                                 ("long1", long1)):
                first.submit(request_cls(name, prompt, 4))
                first.run_until_drained()
            spilled = first.stats()
            audit_spill = audit_end("spill", first)
            files = sum(name.endswith(".kvb") for name in os.listdir(root))
            disk_bytes = sum(os.path.getsize(os.path.join(root, name))
                             for name in os.listdir(root))
            del first                   # the restart: the host tier is lost
            audit_begin("adopt")
            t0 = time.monotonic()
            second = make_server()
            adopt_ms = (time.monotonic() - t0) * 1e3
            adopted = second.stats()
            again = request_cls("again", shared1, NEW_TOKENS)
            second.submit(again)
            second.run_until_drained()
            torch.cuda.synchronize()
        stats = second.stats()
        audit_adopt = audit_end("spill, the adopting server", second)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if again.error is not None or len(again.tokens) != NEW_TOKENS:
        fail(f"spill: error {again.error}, {len(again.tokens)} tokens")
    launches = window.hold(
        "spill", weights, config,
        spilled["decode_steps"] + stats["decode_steps"],
        spilled["prefill_dispatches"] + stats["prefill_dispatches"])
    if spilled["kv_spills"] < 64 or adopted["kv_adopted_chains"] < 1 \
            or adopted["kv_disk_blocks"] < 64:
        fail(f"spill: {spilled['kv_spills']} blocks spilled, "
             f"{adopted['kv_adopted_chains']} chains and "
             f"{adopted['kv_disk_blocks']} blocks adopted")
    if stats["kv_disk_restores"] != 64 or stats["prefix_hits_host"] != 1 \
            or stats["kv_checksum_failures"]:
        fail(f"spill: {stats['kv_disk_restores']} disk restores, "
             f"{stats['prefix_hits_host']} hits, "
             f"{stats['kv_checksum_failures']} checksum failures")
    exact, equal, checked, ties = check_requests(
        torch, [again], phase9_oracle(torch, llama, server_cls, request_cls,
                                      params, config, quantize_kv, device))
    return dict(
        requests_exact=exact, tokens_checked=checked, tokens_equal=equal,
        accepted_near_ties=ties, launches=launches,
        demotions=spilled["kv_demotions"], spills=spilled["kv_spills"],
        spill_files=files, spill_dir_bytes=disk_bytes,
        adopted_chains=adopted["kv_adopted_chains"],
        adopted_blocks=adopted["kv_disk_blocks"], adopt_ms=adopt_ms,
        disk_restores=stats["kv_disk_restores"],
        restored_ttft_ms=(again.first_token_ts - again.submitted_ts) * 1e3,
        run_graph_replays=stats["graph_replays"],
        audit_spill=audit_spill, audit_adopt=audit_adopt)


def serve_kv_wire(torch, np, llama, weights, kernels, server_cls,
                  request_cls, params, quantize_kv, device):
    """Phase 9 (c) and (d): paged replicas on one loopback broker, their
    engine in its own thread, each server warmed and fenced before the
    engine starts.  A serves the shared prefix.  (c) A fresh replica B a
    turn (KV_TURNS) serves the prefix with another tail, with
    ``kv_source`` = A (warm: B pulls A's 64 prefix blocks over the wire)
    or without (cold).  (d) A streams the prefix with a third tail; after
    MIGRATE_AFTER tokens ``migrate_prepare`` asks A for it, and a fresh
    replica takes prompt + the committed tokens with ``kv_source`` = A
    and ``kv_migrate`` and continues.  Every import must land (no
    timeout fall-back), every token is held to the oracle (the first warm
    turn's and the migration's; every other turn's equal to the first
    warm turn's), the launches to the steps and slices."""
    import threading

    from aiko_services_tpu_torch.kvstore.directory import shareable_blocks
    from aiko_services_tpu_torch.orchestration.client import InferClient
    from aiko_services_tpu_torch.orchestration.continuous import (
        ContinuousReplica)
    from aiko_services_tpu_torch.pipeline.codec import (decode_swag,
                                                        encode_swag)
    from aiko_services_tpu_torch.runtime import (EventEngine, Process,
                                                 actor_args,
                                                 compose_instance)
    from aiko_services_tpu_torch.transport import reset_brokers
    from aiko_services_tpu_torch.utils.sexpr import generate, parse

    config = llama.CONFIGS["llama3_8b"]
    waves = paged_traffic(np, config.vocab_size)
    shared0, shared1 = waves[0][:2]
    moving = waves[1][0]
    names = ["a"] + [f"b{i}" for i in range(len(KV_TURNS))] + ["m"]
    servers = {name: warm_wire_server(np, server_cls, request_cls, params,
                                      device, config,
                                      quantize_kv=quantize_kv)
               for name in names}
    before = {name: server.stats() for name, server in servers.items()}
    block_bytes = kv_block_bytes(config, quantize_kv)

    errors = ErrorRecords()
    logging.getLogger().addHandler(errors)
    reset_brokers()
    engine = EventEngine()
    probe = Process(namespace="smoke", hostname="card", pid="0",
                    engine=engine, broker="kv")
    replicas, clients = {}, {}
    for index, name in enumerate(names):
        process = Process(namespace="smoke", hostname="card",
                          pid=str(index + 1), engine=engine, broker="kv")
        replicas[name] = compose_instance(
            ContinuousReplica, actor_args(f"llama3_8b_{name}"),
            process=process, server=servers[name],
            kv_fetch_timeout_s=KV_FETCH_TIMEOUT_S)
        clients[name] = InferClient(probe, replicas[name].topic_in)
    source = replicas["a"].topic_path
    answers, answered = [], threading.Event()

    def on_ready(_topic, payload):
        command, params_ = parse(payload)
        if command == "migrate_ready":
            answers.append(decode_swag(params_[1]))
            answered.set()
    probe.add_message_handler(on_ready, "smoke/migrate")

    def send(name, prompt, budget, **kwargs):
        stamps = {"sent": time.monotonic()}

        def on_partial(_increment):
            stamps.setdefault("first", time.monotonic())
        future = clients[name].submit(prompt, max_new_tokens=budget,
                                      stream=True, on_partial=on_partial,
                                      **kwargs)
        return future, stamps

    def wait(name, future):
        clients[name].wait(future, timeout=WIRE_TIMEOUT_S)
        if future.error is not None:
            fail(f"kv wire: {name}'s {future.request_id} answered "
                 f"{future.error!r} ({errors.records})")
        return future

    def idle():
        deadline = time.monotonic() + WIRE_TIMEOUT_S
        while any(r._pumping or r.server.busy or r._kv_pending
                  for r in replicas.values()):
            if time.monotonic() > deadline:
                fail("kv wire: the replicas did not go idle")
            time.sleep(0.001)

    turns, thread = [], None
    torch.cuda.synchronize()
    try:
        with LaunchWindow(llama, kernels) as window:
            thread = engine.run_in_thread()
            owner, _ = send("a", shared0, NEW_TOKENS)
            wait("a", owner)
            idle()
            for index, kind in enumerate(KV_TURNS):
                name = f"b{index}"
                a0, b0 = servers["a"].stats(), servers[name].stats()
                extra = dict(kv_source=source) if kind == "warm" else {}
                future, stamps = send(name, shared1, NEW_TOKENS, **extra)
                wait(name, future)
                idle()
                a1, b1 = servers["a"].stats(), servers[name].stats()
                turn = dict(kind=kind, tokens=future.tokens,
                            ttft_ms=(stamps["first"] - stamps["sent"]) * 1e3,
                            total_ms=(time.monotonic() - stamps["sent"])
                            * 1e3)
                if kind == "warm":
                    fetch_ms = float(np.asarray(
                        future.outputs["kv_restore_ms"]))
                    export_ms = delta(a1, a0, "kv_transfer_ms")
                    import_ms = delta(b1, b0, "kv_transfer_ms")
                    nbytes = delta(b1, b0, "kv_transfer_bytes")
                    turn.update(
                        payload_bytes=nbytes, blocks=nbytes / block_bytes,
                        fetch_ms=fetch_ms, export_ms=export_ms,
                        import_ms=import_ms,
                        wire_ms=fetch_ms - export_ms - import_ms,
                        landing_host_ms=delta(b1, b0,
                                              "kv_transfer_host_ms"),
                        mb_per_s=nbytes / 1e6 / (fetch_ms / 1e3),
                        imports_async=delta(b1, b0, "kv_imports_async"),
                        remote_hits=delta(b1, b0, "prefix_remote_hits"),
                        failures=delta(b1, b0, "kv_transfer_failures"))
                    if (turn["imports_async"], turn["remote_hits"],
                            turn["failures"], nbytes) \
                            != (1, 1, 0, 64 * block_bytes):
                        fail(f"kv wire turn {index}: the import did not land"
                             f" ({turn})")
                elif delta(b1, b0, "kv_imports_async") \
                        or delta(b1, b0, "kv_transfer_failures"):
                    fail(f"kv wire turn {index} (cold) imported or failed")
                turns.append(turn)
            # (d) live migration: A streams, the router's prepare, B resumes.
            a0, m0 = servers["a"].stats(), servers["m"].stats()
            source_future, _ = send("a", moving, NEW_TOKENS)
            deadline = time.monotonic() + WIRE_TIMEOUT_S
            while len(source_future.partial_tokens) < MIGRATE_AFTER:
                if time.monotonic() > deadline or source_future.done:
                    fail("migrate: the source did not stream "
                         f"{MIGRATE_AFTER} tokens")
                time.sleep(0.0005)
            probe.message.publish(replicas["a"].topic_in, generate(
                "migrate_prepare", ["mig", "smoke/migrate", encode_swag(
                    {"request_id": source_future.request_id})]))
            if not answered.wait(WIRE_TIMEOUT_S):
                fail("migrate: no (migrate_ready ...)")
            ready = answers[0]
            if "error" in ready:
                fail(f"migrate: migrate_ready answered {ready}")
            committed = int(np.asarray(ready["tokens"]))
            blocks = int(np.asarray(ready["blocks"]))
            while len(source_future.partial_tokens) < committed:
                if time.monotonic() > deadline:
                    fail("migrate: the committed tokens never streamed")
                time.sleep(0.0005)
            kept = list(source_future.partial_tokens[:committed])
            resumed, _ = send("m", np.concatenate(
                [moving, np.asarray(kept, np.int32)]),
                NEW_TOKENS - committed, kv_source=source, kv_migrate=True)
            wait("m", resumed)
            wait("a", source_future)
            idle()
            engine.terminate()
            thread.join(WIRE_TIMEOUT_S)
            torch.cuda.synchronize()
    finally:
        logging.getLogger().removeHandler(errors)
        if thread is not None and thread.is_alive():
            engine.terminate()
    if thread.is_alive():
        fail("kv wire: the engine thread did not stop")
    reset_brokers()
    if errors.records:
        fail(f"kv wire: logged failures: {errors.records}")
    after = {name: server.stats() for name, server in servers.items()}
    steps = sum(delta(after[n], before[n], "decode_steps") for n in names)
    slices = sum(delta(after[n], before[n], "prefill_dispatches")
                 for n in names)
    launches = window.hold("kv wire", weights, config, steps, slices)
    for name in names:
        if after[name]["graph_captures_steady_state"] \
                or delta(after[name], before[name], "kv_transfer_failures"):
            fail(f"kv wire: {name} captured after its fence or fell back")
    m1 = after["m"]
    # The resume lands A's rows past the chain's last full block too, one
    # block's bytes on the wire when there are any.
    tails = delta(m1, m0, "kv_tails_adopted")
    tail_blocks = tails if (len(moving) + committed - 1) % BLOCK else 0
    migration = dict(
        committed_tokens=committed, blocks=blocks, tails_adopted=tails,
        imported_blocks=delta(m1, m0, "kv_transfer_bytes") / block_bytes
        - tail_blocks,
        imports_async=delta(m1, m0, "kv_imports_async"),
        remote_hits=delta(m1, m0, "prefix_remote_hits"),
        fetch_ms=float(np.asarray(resumed.outputs["kv_restore_ms"])),
        export_ms=delta(after["a"], a0, "kv_transfer_ms"))
    if blocks != shareable_blocks(len(moving) + committed, BLOCK) \
            or (migration["imported_blocks"], migration["imports_async"],
                migration["remote_hits"]) != (blocks, 1, 1):
        fail(f"migrate: {migration}")
    oracle = phase9_oracle(torch, llama, server_cls, request_cls, params,
                           config, quantize_kv, device)
    checked_requests = []
    for name, prompt, tokens in (
            ("owner", shared0, owner.tokens),
            ("warm", shared1, turns[0]["tokens"]),
            ("migrate_source", moving, source_future.tokens),
            ("migrate_resumed", moving, kept + resumed.tokens)):
        request = request_cls(name, prompt, NEW_TOKENS)
        request.tokens = list(tokens)
        if len(request.tokens) != NEW_TOKENS:
            fail(f"kv wire: {name} has {len(request.tokens)} tokens")
        checked_requests.append(request)
    exact, equal, checked, ties = check_requests(torch, checked_requests,
                                                 oracle)
    for index, turn in enumerate(turns):
        if turn.pop("tokens") != checked_requests[1].tokens:
            fail(f"kv wire turn {index} ({turn['kind']}): tokens differ "
                 "from the first warm turn's")
    warm = [t for t in turns if t["kind"] == "warm"]
    cold = [t for t in turns if t["kind"] == "cold"]
    return dict(
        requests_exact=exact, tokens_checked=checked, tokens_equal=equal,
        accepted_near_ties=ties, launches=launches, decode_steps=steps,
        prefill_slices=slices, kv_fetch_timeout_s=KV_FETCH_TIMEOUT_S,
        turns=turns, migration=migration,
        warm_ttft_ms=[t["ttft_ms"] for t in warm],
        cold_ttft_ms=[t["ttft_ms"] for t in cold],
        run_graph_replays=sum(delta(after[n], before[n], "graph_replays")
                              for n in names))


# --------------------------------------------------------------------------- #
# Phase 10: the fleet

#: The smoke's fleet rigs (phases 10, 11, 13): the registrar's primary
#: search, and the replicas' idle digest period where a rig waits for an
#: advertisement (disaggregated roles, adapter residency).
ELECTION_S, ADVERTISE_S = 0.05, 0.5


@contextlib.contextmanager
def quick_fleet(advertise_s=None):
    """Cut a fleet rig's idle waits: the registrar's primary search to
    ELECTION_S (one registrar a broker: nothing contests it) and, given
    ``advertise_s``, the replicas' idle digest advertisement to that period
    (the router's directory lease is 30 s).  Both are restored on exit."""
    from aiko_services_tpu_torch.orchestration.continuous import (
        ContinuousReplica)
    from aiko_services_tpu_torch.registry import registrar

    search = registrar.PRIMARY_SEARCH_TIMEOUT
    period = ContinuousReplica.KV_ADVERTISE_S
    registrar.PRIMARY_SEARCH_TIMEOUT = ELECTION_S
    if advertise_s is not None:
        ContinuousReplica.KV_ADVERTISE_S = advertise_s
    try:
        yield
    finally:
        registrar.PRIMARY_SEARCH_TIMEOUT = search
        ContinuousReplica.KV_ADVERTISE_S = period


#: Phase 10's parts: (a) prefix routing, (b) chaos, (c) live migration,
#: (d) disaggregated prefill.
FLEET_PARTS = ("prefix", "chaos", "migration", "disaggregation")
#: Phase 10 (a): the router's ``prefix_alpha`` a turn, alternating.
FLEET_TURNS = (1.0, 0.0)
#: Phase 10 (a), (d): requests a second the load generator sends, open loop:
#: the shared prefix's producer prefills well inside one gap.
FLEET_RATE_HZ = 4.0
#: Phase 10 (c): requests of the migration run and tokens each generates.
MIGRATE_REQUESTS, MIGRATE_TOKENS = 8, 64


def fleet_payloads(np, vocab):
    """Phase 4's 12 requests in wave order as the load generator's
    payloads, streamed: (payload_fn, prompts)."""
    prompts = [prompt for wave in paged_traffic(np, vocab)
               for prompt in wave]

    def payload_fn(index):
        return {"tokens": prompts[index], "max_new_tokens": NEW_TOKENS,
                "stream": 1}
    return payload_fn, prompts


def finals_by_index(report):
    """The load generator's final tokens by request index
    (``lg<run>_<index>``)."""
    return {int(request_id.rsplit("_", 1)[1]): tokens
            for request_id, tokens in report.final_tokens.items()}


def served_pairs(prompts, finals):
    """(prompt, tokens) of every final, from the prompts by request index
    and the finals by request index."""
    return [(prompts[index], tokens)
            for index, tokens in sorted(finals.items())]


def hold_to_oracle(torch, np, llama, params, config, device, label, pairs,
                   held):
    """Hold served (prompt, tokens) pairs to phase 4's bf16 contiguous
    oracle.  ``held`` is the set of (prompt bytes, tokens) already held: a
    pair in it passes as it did, the distinct others join it once held.
    Those of one prompt length and one budget are prefilled together in
    one ``prefill`` and decoded teacher-forced on their served tokens by
    ``decode_step`` (near-ties within TIE_GAP accepted, as
    :func:`check_request`).  The rigs' prompts mostly share a length, so
    one batch holds a whole part for the decode steps of one request."""
    groups, todo = {}, set()
    for prompt, tokens in pairs:
        prompt = np.asarray(prompt, np.int32)
        key = (prompt.tobytes(), tuple(tokens))
        if key in held or key in todo:
            continue
        todo.add(key)
        groups.setdefault((len(prompt), len(tokens)), []).append(
            (prompt, list(tokens)))
    checked, equal, ties = 0, 0, []
    for (length, new), group in sorted(groups.items()):
        prompts = torch.as_tensor(np.stack([p for p, _ in group]),
                                  device=device)
        served = torch.as_tensor([t for _, t in group], dtype=torch.int64,
                                 device=device)
        rows = -(-(length + new) // BLOCK) * BLOCK
        cache = llama.init_cache(config, len(group), rows, device=device)
        logits, cache = llama.prefill(params, prompts, cache, config)
        logits = logits[:, -1]
        for index in range(new):
            want = served[:, index]
            best = logits.argmax(-1)
            gaps = (logits.gather(1, best[:, None])
                    - logits.gather(1, want[:, None]))[:, 0].tolist()
            for row, (hit, gap) in enumerate(zip((best == want).tolist(),
                                                 gaps)):
                if hit:
                    equal += 1
                elif gap > TIE_GAP:
                    fail(f"{label}: request {row} of {len(group)} (prompt "
                         f"{length}): token {index} is {int(want[row])}, "
                         f"oracle {int(best[row])}, logit gap {gap:.4f} > "
                         f"{TIE_GAP}")
                else:
                    ties.append((row, index, round(gap, 4)))
            checked += len(group)
            if index + 1 < new:
                out, cache = llama.decode_step(
                    params, want[:, None].to(torch.int32), cache,
                    length + index, config)
                logits = out[:, -1]
    held |= todo
    return dict(requests=len(pairs), checked_here=len(todo),
                tokens_checked_here=checked, tokens_equal=equal,
                accepted_near_ties=ties)


def fleet_part(torch, llama, weights, kernels, config, label, servers, rig,
               killed=(), build=None):
    """Run ``rig(make_server)`` (a loadgen rig) over ``servers``, built and
    warmed beforehand and handed out in order (then, if the rig asks for
    more, ``build(name, *args)``'s), with every kernel's count set to 0
    just before and read just after: the launches are held to the handed
    servers' decode steps and prefill slices (phase 4's formula summed over
    them), no server captures after its fence, every server that decoded
    replayed graphs, and nothing is logged at ERROR.  ``killed`` names the
    replicas the rig's fault plan kills: only the first server handed to
    each may end with dispatched chunks uncollected."""
    pool = list(servers)
    named, handed = {}, []

    def make_server(name, *args):
        if pool:
            server = pool.pop(0)
        elif build is not None:
            server = build(name, *args)
        else:
            fail(f"fleet {label}: the rig asked for more servers than built")
        named.setdefault(name, []).append(server)
        handed.append(server)
        return server
    before = {id(server): server.stats() for server in servers}
    errors = ErrorRecords()
    logging.getLogger().addHandler(errors)
    torch.cuda.synchronize()
    try:
        with LaunchWindow(llama, kernels) as window:
            result = rig(make_server)
    finally:
        logging.getLogger().removeHandler(errors)
    torch.cuda.synchronize()
    if pool:
        fail(f"fleet {label}: {len(pool)} servers left unused")
    if errors.records:
        fail(f"fleet {label}: logged failures: {errors.records}")
    after = [server.stats() for server in handed]
    zero = {key: 0 for key in ("decode_steps", "prefill_dispatches",
                               "graph_captures", "graph_replays")}
    before = [before.get(id(server), zero) for server in handed]
    # A server counts its decode steps when it collects a chunk; a replica
    # killed mid-decode leaves the chunks it had dispatched uncollected on
    # its ring, their kernels launched all the same.  Every other server
    # drained its ring.
    dead = [named[name][0] for name in killed if name in named]
    if len(dead) != len(killed):
        fail(f"fleet {label}: no server for the killed {killed}")
    for index, server in enumerate(handed):
        if server._ring and not any(server is other for other in dead):
            fail(f"fleet {label}: server {index} survived with "
                 f"{len(server._ring)} chunks uncollected")
    uncollected = sum(int(entry["steps"]) for server in dead
                      for entry in server._ring)
    steps = uncollected + sum(delta(a, b, "decode_steps")
                              for a, b in zip(after, before))
    slices = sum(delta(a, b, "prefill_dispatches")
                 for a, b in zip(after, before))
    launches = window.hold(f"fleet {label}", weights, config, steps, slices)
    captures, replays = [], []
    for index, (a, b) in enumerate(zip(after, before)):
        if a["graph_captures_steady_state"]:
            fail(f"fleet {label}: server {index} captured after its fence")
        if delta(a, b, "decode_steps") and not delta(a, b, "graph_replays"):
            fail(f"fleet {label}: server {index} decoded without a replay")
        captures.append(delta(a, b, "graph_captures"))
        replays.append(delta(a, b, "graph_replays"))
    return result, dict(launches=launches, decode_steps=steps,
                        uncollected_steps=uncollected,
                        prefill_slices=slices, graph_captures=captures,
                        graph_replays=replays, servers_handed=len(handed))


def fleet_served(report, label, count):
    """Every one of ``count`` requests answered, none with an error."""
    if (report.completed, report.errors, report.timeouts) != (count, 0, 0):
        fail(f"fleet {label}: {report} ({report.error_kinds})")


def caller_ttft(report):
    """TTFT p50 / max on the load generator's clock, and served tok/s."""
    p50, most = percentiles(report.client_ttfts_ms)
    return dict(client_ttft_ms_p50=p50, client_ttft_ms_max=most,
                served_tok_s=report.throughput_tps)


def serve_fleet(torch, np, llama, weights, kernels, server_cls, request_cls,
                params, device, parts=FLEET_PARTS):
    """Phase 10: the fleet through the port's loadgen rigs — a Registrar, a
    ReplicaRouter and two ContinuousReplicas, each over its own phase-8
    server (warmed and fenced, :func:`warm_wire_server`) on one weight set,
    one loopback broker and one engine thread.  (a) phase 4's traffic in
    turns of FLEET_TURNS; (b) ``run_chaos`` (seed 1); (c)
    ``run_migration_chaos`` (a clean migration against its control); (d)
    disaggregated prefill on (a)'s traffic, beside (a)'s first turn.
    ``parts`` names the parts to run (FLEET_PARTS).  Every token is held to
    phase 4's oracle (or to the control, in (c)), the launches of each part
    to its steps and slices."""
    from aiko_services_tpu_torch.tools import loadgen
    from aiko_services_tpu_torch.transport import reset_brokers

    config = llama.CONFIGS["llama3_8b"]
    payload_fn, prompts = fleet_payloads(np, config.vocab_size)
    held = set()

    def build(count):
        servers = [warm_wire_server(np, server_cls, request_cls, params,
                                    device, config) for _ in range(count)]
        if any(server.params is not params for server in servers):
            fail("fleet: the servers do not share one weight set")
        return servers

    def part(label, count, rig, killed=(), advertise_s=None):
        servers = build(count)
        try:
            with quick_fleet(advertise_s):
                return fleet_part(torch, llama, weights, kernels, config,
                                  label, servers, rig, killed=killed)
        finally:
            del servers
            reset_brokers()
            gc.collect()
            torch.cuda.empty_cache()

    out, colocated = {}, None
    # (a) prefix routing, in turns.
    turns = []
    for index, alpha in enumerate(FLEET_TURNS if "prefix" in parts else ()):
        report, counts = part(
            f"(a) turn {index}", 2, lambda make_server: loadgen
            .run_shared_prefix(n_requests=len(prompts),
                               rate_hz=FLEET_RATE_HZ,
                               prefix_routing=alpha > 0,
                               drain_timeout_s=WIRE_TIMEOUT_S,
                               payload_fn=payload_fn,
                               make_server=make_server))
        fleet_served(report, f"(a) turn {index}", len(prompts))
        stats = report.server_stats
        if alpha > 0 and not stats["prefix_routed"]:
            fail(f"fleet (a) turn {index}: nothing prefix-routed")
        turn = dict(prefix_alpha=alpha,
                    prefix_routed=stats["prefix_routed"],
                    prefix_hit_rate=report.prefix_hit_rate,
                    kv_tier_hints=stats["kv_tier_hints"],
                    kv_remote_hints=stats["kv_remote_hints"],
                    kv_transfer_bytes=report.kv_transfer_bytes,
                    **caller_ttft(report), **counts)
        turn["oracle"] = hold_to_oracle(
            torch, np, llama, params, config, device, "a",
            served_pairs(prompts, finals_by_index(report)), held)
        turns.append(turn)
        if index == 0:
            # The colocated turn (d) sets beside the disaggregated one.
            colocated = dict(client_ttft_ms=report.client_ttfts_ms,
                             **caller_ttft(report))
    if turns:
        out["prefix_turns"] = turns
    if "chaos" in parts:
        out["chaos"] = fleet_chaos(torch, np, llama, params, config, device,
                                   part, held)
    if "migration" in parts:
        out["migration"] = fleet_migration(torch, np, llama, params, config,
                                           device, part, held)
    if "disaggregation" in parts:
        out["disaggregation"] = fleet_disaggregation(
            torch, np, llama, params, config, device, part, payload_fn,
            prompts, held, colocated)
    return out


def fleet_chaos(torch, np, llama, params, config, device, part, held):
    """Phase 10 (b): ``run_chaos``'s schedule (seed 1) on the fleet."""
    from aiko_services_tpu_torch.tools import loadgen

    # (b) chaos: a replica killed mid-decode, partials dropped, a stall.
    # The rig's payloads with phase 4's budget: replica_a's 7th pump, where
    # the schedule kills it, then falls mid-decode on 8-slot servers.
    chaos_fn = loadgen.shared_prefix_payloads(
        n_conversations=3, turns=4, system_len=32, seed=1,
        max_new_tokens=NEW_TOKENS)
    report, counts = part("(b) chaos", 2, lambda make_server: loadgen
                          .run_chaos(seed=1, n_requests=8, rate_hz=200.0,
                                     drain_timeout_s=WIRE_TIMEOUT_S,
                                     payload_fn=chaos_fn,
                                     make_server=make_server),
                          killed=("replica_a",))
    stats = report.server_stats
    if (report.lost, report.timeouts, stats["replica_deaths_observed"]) \
            != (0, 0, 1) or stats["redispatches"] < 1 or report.errors:
        fail(f"fleet (b) chaos: {report} {stats}")
    chaos_prompts = [np.asarray(chaos_fn(i)["tokens"]) for i in range(8)]
    return dict(
        lost=report.lost, timeouts=report.timeouts,
        completed=report.completed,
        replica_deaths_observed=stats["replica_deaths_observed"],
        redispatches=stats["redispatches"],
        faults_fired=stats["faults_fired"], **counts,
        oracle=hold_to_oracle(
            torch, np, llama, params, config, device, "b",
            served_pairs(chaos_prompts, finals_by_index(report)), held))


def fleet_migration(torch, np, llama, params, config, device, part, held):
    """Phase 10 (c): router-driven live migration against an unmigrated
    control, every final equal to the control's bit for bit, the
    control's held to the oracle."""
    from aiko_services_tpu_torch.tools import loadgen

    (control, migrated), counts = part(
        "(c) migration", 4, lambda make_server: loadgen.run_migration_chaos(
            seed=0, n_requests=MIGRATE_REQUESTS, rate_hz=60.0, phase="none",
            max_new_tokens=MIGRATE_TOKENS, drain_timeout_s=WIRE_TIMEOUT_S,
            make_server=make_server))
    stats = migrated.server_stats
    for label, report in (("control", control), ("migrated", migrated)):
        fleet_served(report, f"(c) {label}", MIGRATE_REQUESTS)
    # Each resume decodes on from its source's own cache (the source ships
    # the rows past the chain's last full block), so every final, migrated
    # or not, equals the control's.
    differ = sorted(request_id for request_id, want
                    in control.final_tokens.items()
                    if migrated.final_tokens[request_id] != want)
    if differ:
        fail(f"fleet (c): finals differ from the control's for {differ} "
             f"(migrated: {sorted(stats['on_source_at_migrate'])})")
    if stats["stream_mismatches"] or stats["migrations_completed"] < 1 \
            or migrated.duplicate_finals \
            or stats["kv_tails_adopted"] < stats["migrations_completed"]:
        fail(f"fleet (c): {stats}")
    migrate_fn = loadgen._elastic_payloads(
        seed=0, prompt_len=18, max_new_tokens=MIGRATE_TOKENS, stream=True)
    prompts = [np.asarray(migrate_fn(i)["tokens"])
               for i in range(MIGRATE_REQUESTS)]
    return dict(
        migrations_started=stats["migrations_started"],
        migrations_completed=stats["migrations_completed"],
        migrations_aborted=stats["migrations_aborted"],
        migration_blocks_streamed=stats["migration_blocks_streamed"],
        kv_tails_adopted=stats["kv_tails_adopted"],
        migration_cutover_ms=stats["migration_cutover_ms"],
        on_source_at_migrate=sorted(stats["on_source_at_migrate"]),
        finals_equal_to_control=len(control.final_tokens),
        stream_mismatches=stats["stream_mismatches"], **counts,
        oracle=hold_to_oracle(
            torch, np, llama, params, config, device, "c",
            served_pairs(prompts, finals_by_index(control)), held))


def fleet_disaggregation(torch, np, llama, params, config, device, part,
                         payload_fn, prompts, held, colocated):
    """Phase 10 (d): disaggregated prefill on (a)'s traffic, beside (a)'s
    first turn (colocated) when that ran."""
    from aiko_services_tpu_torch.tools import loadgen

    report, counts = part(
        "(d) disaggregated", 2, lambda make_server: loadgen
        .run_shared_prefix(n_requests=len(prompts), rate_hz=FLEET_RATE_HZ,
                           disaggregate=True, drain_timeout_s=WIRE_TIMEOUT_S,
                           payload_fn=payload_fn, make_server=make_server),
        advertise_s=ADVERTISE_S)
    fleet_served(report, "(d) disaggregated", len(prompts))
    stats = report.server_stats
    if len(report.client_ttfts_ms) != len(prompts) \
            or not stats["prefix_remote_hits"]:
        fail(f"fleet (d): {len(report.client_ttfts_ms)} TTFTs, "
             f"{stats['prefix_remote_hits']} pulls of the prefill "
             "replica's blocks")
    return dict(
        colocated=colocated,
        disaggregated=dict(
            client_ttft_ms=report.client_ttfts_ms,
            kv_transfer_bytes=report.kv_transfer_bytes,
            kv_remote_hints=stats["kv_remote_hints"],
            prefix_remote_hits=stats["prefix_remote_hits"],
            **caller_ttft(report), **counts,
            oracle=hold_to_oracle(
                torch, np, llama, params, config, device, "d",
                served_pairs(prompts, finals_by_index(report)), held)))


def print_fleet(fleet, smi):
    """Phase 10's lines: each part's figures, the card's name and power
    limit on each."""
    for index, turn in enumerate(fleet.get("prefix_turns", ())):
        log(f"phase 10 (a) turn {index} (prefix_alpha "
            f"{turn['prefix_alpha']}): prefix_routed "
            f"{turn['prefix_routed']}, fleet prefix hit rate "
            f"{turn['prefix_hit_rate']:.3f}, kv_tier_hints "
            f"{turn['kv_tier_hints']}, kv_remote_hints "
            f"{turn['kv_remote_hints']}; caller's TTFT p50 "
            f"{turn['client_ttft_ms_p50']:.1f} ms, max "
            f"{turn['client_ttft_ms_max']:.1f} ms; served "
            f"{turn['served_tok_s']:.1f} tok/s; {smi}")
    chaos = fleet.get("chaos")
    if chaos:
        log(f"phase 10 (b) chaos (seed 1): {chaos['completed']} of 8 "
            f"completed, lost {chaos['lost']}, timeouts {chaos['timeouts']}, "
            f"deaths observed {chaos['replica_deaths_observed']}, "
            f"redispatches {chaos['redispatches']}, faults fired "
            f"{chaos['faults_fired']}; {smi}")
    mig = fleet.get("migration")
    if mig:
        log(f"phase 10 (c) migration: {mig['migrations_completed']} of "
            f"{mig['migrations_started']} completed, migration_cutover_ms "
            f"{mig['migration_cutover_ms']}; finals bit-exact against the "
            f"control: {mig['finals_equal_to_control']} of "
            f"{MIGRATE_REQUESTS} (migrated: "
            f"{', '.join(mig['on_source_at_migrate'])}; resumed on the "
            f"source's tail rows: {mig['kv_tails_adopted']}); "
            f"{mig['stream_mismatches']} stream mismatches; {smi}")
    both = fleet.get("disaggregation")
    if both:
        apart = both["disaggregated"]
        colocated = both["colocated"] or dict(
            client_ttft_ms=[math.nan] * len(apart["client_ttft_ms"]),
            client_ttft_ms_p50=math.nan)
        log("phase 10 (d) caller's TTFT ms a request, colocated (turn (a) "
            "0) | disaggregated: " + ", ".join(
                f"{c:.1f} | {d:.1f}" for c, d in zip(
                    colocated["client_ttft_ms"], apart["client_ttft_ms"]))
            + f"; p50 {colocated['client_ttft_ms_p50']:.1f} | "
            f"{apart['client_ttft_ms_p50']:.1f}; pulled "
            f"{apart['kv_transfer_bytes']} bytes; {smi}")

# --------------------------------------------------------------------------- #
# Phase 11: the elastic fleet

#: Phase 11's parts: (a) elastic chaos, (b) rolling upgrade, (c) restart.
ELASTIC_PARTS = ("chaos", "upgrade", "restart")
#: Phase 11 (a): the diurnal trace's seconds, and the servers built for it:
#: three replicas and the killed one's replacement.
ELASTIC_DURATION_S, ELASTIC_SERVERS = 6.0, 4
#: Phase 11 (b): the rolling upgrade's turns (live migration or drain),
#: its trace's seconds and tokens a request; two replicas and their two
#: successors a turn.
UPGRADE_TURNS = ("migrate", "drain")
UPGRADE_DURATION_S, UPGRADE_TOKENS, UPGRADE_SERVERS = 4.0, 48, 4
#: Phase 11 (c): run_restart_ab's pairs (a cold then a warm arm each) and
#: the rig's sizing at llama3_8b: three 96-token prefixes with 8-token
#: tails visited round robin by RESTART_REQUESTS 4-token requests (after
#: 6 of warm-up) over a pool of 10 blocks, so the prefixes' 18 blocks do
#: not fit and every demotion spills to disk; 64-token slices, 16 blocks
#: restored a step.  (The rig's defaults, 192-token prefixes over 20
#: blocks, spill 2 MiB blocks twice as often: 31 s a pair on the card.)
RESTART_TURNS, RESTART_REQUESTS = 1, 12
RESTART_PREFIX, RESTART_TAIL = 96, 8
RESTART_POOL, RESTART_SLICE, RESTART_RATE = 10, 64, 16


def elastic_prompts(np, count):
    """The elastic rigs' prompts by request index (seed 0)."""
    from aiko_services_tpu_torch.tools import loadgen
    payload_fn = loadgen._elastic_payloads(seed=0)
    return [np.asarray(payload_fn(index)["tokens"]) for index in range(count)]


def fleet_times(stats, kind):
    """Seconds of the rig's ``fleet_events`` of one kind, by slot."""
    return {what: at for at, event, what in stats["fleet_events"]
            if event == kind}


def serve_elastic(torch, np, llama, weights, kernels, server_cls,
                  request_cls, params, device, parts=ELASTIC_PARTS):
    """Phase 11: the elastic fleet through the port's loadgen rigs — a
    Registrar, a ReplicaRouter and the FleetAutoscaler that owns the
    replicas, each over its own phase-8 server (warmed and fenced,
    :func:`warm_wire_server`) on one weight set, on one loopback broker and
    one engine thread.  (a) ``run_elastic_chaos`` (seed 0); (b)
    ``run_rolling_upgrade`` with two replicas in UPGRADE_TURNS, every
    migrated final against the drain turns' and those held to the oracle;
    (c) ``run_restart_ab`` in RESTART_TURNS pairs, on servers the rig
    builds over its spill directories.  The registrar's primary search is
    cut to ELECTION_S for the phase (:func:`quick_fleet`).  ``parts`` names
    the parts to run (ELASTIC_PARTS)."""
    from aiko_services_tpu_torch.transport import reset_brokers

    config = llama.CONFIGS["llama3_8b"]
    torch.cuda.reset_peak_memory_stats()

    def part(label, count, rig, **kwargs):
        servers = [warm_wire_server(np, server_cls, request_cls, params,
                                    device, config) for _ in range(count)]
        if any(server.params is not params for server in servers):
            fail("elastic: the servers do not share one weight set")
        try:
            began = time.monotonic()
            result, counts = fleet_part(torch, llama, weights, kernels,
                                        config, label, servers, rig,
                                        **kwargs)
            counts["seconds"] = round(time.monotonic() - began, 1)
            counts["peak_gb"] = round(
                torch.cuda.max_memory_allocated() / 2 ** 30, 2)
            return result, counts
        finally:
            del servers
            reset_brokers()
            gc.collect()
            torch.cuda.empty_cache()

    out = {}
    with quick_fleet():
        if "chaos" in parts:
            out["chaos"] = elastic_chaos(torch, np, llama, params, config,
                                         device, part)
        if "upgrade" in parts:
            out["upgrade"] = elastic_upgrade(torch, np, llama, params,
                                             config, device, part)
        if "restart" in parts:
            out["restart"] = elastic_restart(torch, np, llama, server_cls,
                                             request_cls, params, config,
                                             device, part)
    out["peak_gb"] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
    return out


def elastic_chaos(torch, np, llama, params, config, device, part):
    """Phase 11 (a): ``run_elastic_chaos`` (seed 0) — three replicas, a
    scripted ``scale_target 2`` (decode1 drained), decode3 killed
    mid-decode, its replacement's first spawn failed and the retry
    slow-started.  Every final is held to phase 4's oracle."""
    from aiko_services_tpu_torch.tools import loadgen

    report, counts = part(
        "(11a) elastic chaos", ELASTIC_SERVERS,
        lambda make_server: loadgen.run_elastic_chaos(
            seed=0, duration_s=ELASTIC_DURATION_S,
            make_server=make_server),
        killed=("decode3",))
    stats = report.server_stats
    gates = dict(lost=report.lost == 0, timeouts=report.timeouts == 0,
                 errors=report.errors == 0,
                 duplicate_finals=report.duplicate_finals == 0,
                 stream_mismatches=stats["stream_mismatches"] == 0,
                 converged=stats["converged"] is True,
                 drain_completed=stats["drain_completed"] >= 1,
                 spawn_failures=stats["spawn_failures"] >= 1,
                 slow_starts=stats["slow_starts"] >= 1,
                 deaths_observed=stats["deaths_observed"] >= 2,
                 replicas_live=stats["replicas_live"]
                 == sum(stats["targets"].values()))
    if not all(gates.values()):
        fail(f"elastic (11a): {report} {stats} {gates}")
    stops, spawns = fleet_times(stats, "stop"), fleet_times(stats, "spawn")
    commands = fleet_times(stats, "command")
    # The drain: the scripted scale_target to decode1's stop once drained;
    # the respawn: decode3's last spawn (the slow-started retry) — both on
    # the rig's clock from the measured run's start.
    drain_s = stops.get("decode1", math.nan) \
        - commands.get("(scale_target 2)", math.nan)
    return dict(
        sent=report.sent, completed=report.completed, lost=report.lost,
        timeouts=report.timeouts, duplicate_finals=report.duplicate_finals,
        **{key: stats[key] for key in (
            "spawns", "respawns", "spawn_failures", "slow_starts", "drains",
            "drain_completed", "deaths_observed", "quarantines",
            "replicas_live", "redispatches", "faults_fired",
            "replica_seconds", "stream_mismatches", "converged",
            "fleet_events")},
        targets=stats["targets"], drain_s=round(drain_s, 3),
        respawn_at_s=spawns.get("decode3"), **caller_ttft(report),
        ttft_ms_p50=report.ttft_p50_ms, goodput_rps=report.goodput_rps,
        **counts, oracle=hold_to_oracle(
            torch, np, llama, params, config, device, "11a", served_pairs(
                elastic_prompts(np, report.sent), finals_by_index(report)),
            set()))


def elastic_upgrade(torch, np, llama, params, config, device, part):
    """Phase 11 (b): ``run_rolling_upgrade`` with two replicas, a turn each
    of UPGRADE_TURNS.  Every migrating turn completes both upgrades and
    starts a migration, each completed one resumed on its source's tail
    rows; nothing is lost or duplicated.  The drain turns migrate nothing:
    they are the control, their finals held to the oracle, and every final
    of a migrating turn equals theirs bit for bit."""
    from aiko_services_tpu_torch.tools import loadgen

    turns, control = [], {}
    for index, kind in enumerate(UPGRADE_TURNS):
        label = f"(11b) upgrade turn {index} ({kind})"
        report, counts = part(
            label, UPGRADE_SERVERS,
            lambda make_server, kind=kind: loadgen.run_rolling_upgrade(
                duration_s=UPGRADE_DURATION_S, seed=0, replicas=2,
                drain_based=kind == "drain",
                max_new_tokens=UPGRADE_TOKENS, make_server=make_server))
        stats = report.server_stats
        gates = dict(lost=report.lost == 0, timeouts=report.timeouts == 0,
                     errors=report.errors == 0,
                     duplicate_finals=report.duplicate_finals == 0,
                     stream_mismatches=stats["stream_mismatches"] == 0,
                     converged=bool(stats["converged"]),
                     upgrades=stats["upgrades_completed"] >= 2)
        if kind == "migrate":
            gates.update(
                started=stats["migrations_started"] >= 1,
                tails=stats["kv_tails_adopted"]
                >= stats["migrations_completed"])
        else:
            gates.update(none=stats["migrations_started"] == 0)
            for request_id, tokens in report.final_tokens.items():
                if control.setdefault(request_id, tokens) != tokens:
                    fail(f"{label}: {request_id} differs between drain "
                         "turns")
        if not all(gates.values()):
            fail(f"{label}: {report} {stats} {gates}")
        commands = fleet_times(stats, "command")
        stops = fleet_times(stats, "stop")
        began = commands.get("(rolling_upgrade)", math.nan)
        turns.append(dict(
            kind=kind, sent=report.sent, completed=report.completed,
            lost=report.lost, duplicate_finals=report.duplicate_finals,
            upgrades_completed=stats["upgrades_completed"],
            migrations_started=stats["migrations_started"],
            migrations_completed=stats["migrations_completed"],
            migrations_aborted=stats["migrations_aborted"],
            kv_tails_adopted=stats["kv_tails_adopted"],
            migration_cutover_ms=stats["migration_cutover_ms"],
            # From the (rolling_upgrade) command to the last predecessor's
            # stop, on the rig's clock.
            upgrade_wall_s=round(max(stops.values(), default=math.nan)
                                 - began, 3),
            goodput_rps=report.goodput_rps, **caller_ttft(report),
            fleet_events=stats["fleet_events"], finals=report.final_tokens,
            **counts))
    for turn in turns:
        finals = turn.pop("finals")
        if turn["kind"] == "migrate" and control:
            differ = sorted(rid for rid, tokens in finals.items()
                            if control.get(rid) != tokens)
            if differ or set(finals) != set(control):
                fail(f"elastic (11b): migrated finals differ from the "
                     f"drain turns' for {differ or 'the request set'}")
            turn["finals_equal_to_control"] = len(finals)
    oracle = None
    if control:
        finals = {int(request_id.rsplit("_", 1)[1]): tokens
                  for request_id, tokens in control.items()}
        oracle = hold_to_oracle(
            torch, np, llama, params, config, device, "11b", served_pairs(
                elastic_prompts(np, max(finals) + 1), finals), set())
    return dict(turns=turns, control_oracle=oracle)


def elastic_restart(torch, np, llama, server_cls, request_cls, params,
                    config, device, part):
    """Phase 11 (c): ``run_restart_ab`` in RESTART_TURNS pairs — the only
    replica killed after its warm-up, respawned cold (an empty spill
    directory) and warm (adopting the dead replica's).  The rig holds the
    arms bit-exact; here warm adopts chains and restores from disk, cold
    adopts none, no checksum fails, warm's hit rate beats cold's, and the
    cold finals are held to the oracle.  The respawn is warmed and fenced
    as it is built (:func:`warm_and_fence`, on prompts shorter than a
    block, so nothing of the warm-up is cached, spilled or looked up), so
    its measured TTFTs hold no capture and a capture in them fails the
    part.  The first replica serves only the rig's warm-up wave, where it
    captures, and is not fenced: warming it beforehand would put chains
    of its own into the directory the warm arm adopts."""
    from aiko_services_tpu_torch.tools import loadgen

    max_seq = -(-(RESTART_PREFIX + RESTART_TAIL + 8) // BLOCK) * BLOCK

    def build(name, spill_dir):
        server = server_cls(
            config_name="llama3_8b", slots=SLOTS, max_seq=max_seq,
            chunk_steps=CHUNK_STEPS, params=params, quantize=True,
            block_size=BLOCK, enable_prefix_cache=True,
            chunk_prefill_tokens=RESTART_SLICE, total_blocks=RESTART_POOL,
            host_tier_blocks=0, restore_blocks_per_step=RESTART_RATE,
            spill_dir=spill_dir, max_queue=256, watchdog_s=10.0,
            device=device)
        if name == "replica_a":
            return server
        return warm_and_fence(np, server, request_cls, config, BLOCK - 4)

    payloads = loadgen.longtail_payloads(
        n_prefixes=3, prefix_len=RESTART_PREFIX, tail_len=RESTART_TAIL,
        seed=0)
    turns, held = [], set()
    for index in range(RESTART_TURNS):
        label = f"(11c) restart pair {index}"
        (cold, warm), counts = part(
            label, 0, lambda make_server: loadgen.run_restart_ab(
                n_requests=RESTART_REQUESTS, seed=0,
                prefix_len=RESTART_PREFIX, tail_len=RESTART_TAIL,
                make_server=make_server), build=build)
        for arm, report in (("cold", cold), ("warm", warm)):
            if report.lost or report.timeouts or report.errors:
                fail(f"{label} {arm}: {report}")
        ws, cs = warm.server_stats, cold.server_stats
        gates = dict(adopted=ws["kv_adopted_chains"] > 0,
                     restored=ws["kv_disk_restores"] > 0,
                     cold_adopted=cs["kv_adopted_chains"] == 0,
                     checksums=ws["kv_checksum_failures"] == 0
                     and cs["kv_checksum_failures"] == 0,
                     hit_rate=(warm.prefix_hit_rate or 0.0)
                     > (cold.prefix_hit_rate or 0.0))
        if not all(gates.values()):
            fail(f"{label}: {gates} cold {cs} warm {ws}")
        turn = dict(finals_equal=len(cold.final_tokens), **counts)
        for arm, report in (("cold", cold), ("warm", warm)):
            stats = report.server_stats
            turn[arm] = dict(
                prefix_hit_rate=report.prefix_hit_rate,
                ttft_ms_mean=float(np.mean(report.ttfts_ms)),
                ttft_ms_p50=report.ttft_p50_ms,
                client_ttft_ms_mean=float(np.mean(report.client_ttfts_ms)),
                client_ttft_ms_p50=float(np.median(report.client_ttfts_ms)),
                **{key: stats[key] for key in (
                    "kv_adopted_chains", "kv_disk_restores", "kv_spills",
                    "warmup_spills", "restart_recovery_ms",
                    "restart_hit_rates", "kv_checksum_failures")})
        # The rig names a request r<offset>_lg<run>_<index>: its payload
        # is the offset's plus the index's.
        turn["oracle"] = hold_to_oracle(
            torch, np, llama, params, config, device, "11c", [
                (payloads(int(rid[1:].split("_", 1)[0])
                          + int(rid.rsplit("_", 1)[1]))["tokens"], tokens)
                for rid, tokens in cold.final_tokens.items()], held)
        turns.append(turn)
    return dict(turns=turns)


def print_elastic(elastic, smi):
    """Phase 11's lines: each part's figures, the card's name and power
    limit on each."""
    chaos = elastic.get("chaos")
    if chaos:
        log(f"phase 11 (a) elastic chaos (seed 0): {chaos['completed']} of "
            f"{chaos['sent']} completed, lost {chaos['lost']}, timeouts "
            f"{chaos['timeouts']}, duplicated {chaos['duplicate_finals']}; "
            f"spawns {chaos['spawns']}, respawns {chaos['respawns']}, spawn "
            f"failures {chaos['spawn_failures']}, slow starts "
            f"{chaos['slow_starts']}, drains completed "
            f"{chaos['drain_completed']} (scale_target to decode1's stop "
            f"{chaos['drain_s']:.3f} s), deaths {chaos['deaths_observed']}, "
            f"decode3 respawned at {chaos['respawn_at_s']} s, replicas live "
            f"{chaos['replicas_live']} of {chaos['targets']}; caller's TTFT "
            f"p50 {chaos['client_ttft_ms_p50']:.1f} ms, max "
            f"{chaos['client_ttft_ms_max']:.1f} ms; {chaos['seconds']} s; "
            f"{smi}")
    upgrade = elastic.get("upgrade")
    for index, turn in enumerate(upgrade["turns"] if upgrade else ()):
        log(f"phase 11 (b) upgrade turn {index} ({turn['kind']}): "
            f"{turn['completed']} of {turn['sent']} completed, lost "
            f"{turn['lost']}; upgrades {turn['upgrades_completed']}, "
            f"migrations {turn['migrations_completed']} of "
            f"{turn['migrations_started']} (on tail rows "
            f"{turn['kv_tails_adopted']}), cutover ms "
            f"{turn['migration_cutover_ms']}; upgrade wall "
            f"{turn['upgrade_wall_s']:.3f} s, goodput "
            f"{turn['goodput_rps']:.2f} req/s, caller's TTFT p50 "
            f"{turn['client_ttft_ms_p50']:.1f} ms"
            + (f"; finals bit-exact against the drain turns: "
               f"{turn['finals_equal_to_control']}"
               if "finals_equal_to_control" in turn else "")
            + f"; {turn['seconds']} s; {smi}")
    restart = elastic.get("restart")
    for index, turn in enumerate(restart["turns"] if restart else ()):
        cold, warm = turn["cold"], turn["warm"]
        log(f"phase 11 (c) restart pair {index}: hit rate cold "
            f"{cold['prefix_hit_rate']:.3f}, warm "
            f"{warm['prefix_hit_rate']:.3f}; TTFT mean / p50 ms (server) "
            f"cold {cold['ttft_ms_mean']:.1f} / {cold['ttft_ms_p50']:.1f}, "
            f"warm {warm['ttft_ms_mean']:.1f} / {warm['ttft_ms_p50']:.1f}; "
            f"caller's cold {cold['client_ttft_ms_mean']:.1f} / "
            f"{cold['client_ttft_ms_p50']:.1f}, warm "
            f"{warm['client_ttft_ms_mean']:.1f} / "
            f"{warm['client_ttft_ms_p50']:.1f}; warm adopted "
            f"{warm['kv_adopted_chains']} chains, {warm['kv_disk_restores']}"
            f" disk restores; arms bit-exact over {turn['finals_equal']} "
            f"requests; {turn['seconds']} s; {smi}")
    log(f"phase 11 peak device memory {elastic['peak_gb']} GiB; {smi}")


# --------------------------------------------------------------------------- #
# Phase 12: the contiguous layout's residue and the standalone loops

#: Phase 12 (b): one prompt through the standalone loops on caches of
#: STANDALONE_MAX_SEQ rows (128-row blocks: the chunked forwards keep to
#: the kernels; a row count with no power-of-two block of 16 or more
#: would take the plain path).
STANDALONE_MAX_SEQ, STANDALONE_PROMPT, STANDALONE_NEW = 512, 256, 64
#: Phase 12 (b)'s sampled loop: its temperature, and the tokens of its
#: temperature-0 run (the greedy loop's first tokens).
STANDALONE_TEMP, STANDALONE_ZERO_NEW = 0.8, 32
#: Phase 12 (b)'s unaligned sizes: the temperature-0 run's max_seq, and
#: complete()'s new tokens (prompt + new = 289 rows).  Both caches round
#: up to the greedy runs' row counts (512 and 384), so their tokens are
#: the greedy runs' first ones exactly.
STANDALONE_UNALIGNED_MAX_SEQ = STANDALONE_MAX_SEQ - 1
STANDALONE_UNALIGNED_NEW = STANDALONE_ZERO_NEW + 1
#: Phase 12 (c): mistral_7b (window 4,096) at batch 2, a prompt past the
#: window, greedy steps on a rolling cache and on a plain cache of
#: prompt + steps rows.
ROLLING_BATCH, ROLLING_PROMPT, ROLLING_STEPS = 2, 4352, 32
#: Phase 12 (a)'s runs: (draft, int8 KV, chunk_prefill_tokens).
CONTIG_RUNS = (("paired", False, CHUNK), ("paired", True, 0),
               ("adaptive", True, 0), ("ngram", False, 0))
#: Phase 12's route check: (label, slots, rows a slot, window width,
#: starts, inactive rows) at the shapes its runs give the chunked
#: forwards on the degenerate pool (128-row blocks): (a)'s verify (8 x
#: 1,024, k + 1 = 5; starts across block edges, one slot inactive) and its
#: 256-token admission chunk into a batch-1 1,024-row bucket, (b)'s verify
#: and the draft's resync (k = 4) on 512 rows.
CONTIG_CASES = (
    ("verify", SLOTS, MAX_SEQ, SPEC_K + 1,
     (0, 120, 126, 127, 128, 500, 40, 1018), (6,)),
    ("prefill chunk", 1, MAX_SEQ, CHUNK, (256,), ()),
    ("standalone verify", 1, STANDALONE_MAX_SEQ, SPEC_K + 1, (300,), ()),
    ("standalone resync", 1, STANDALONE_MAX_SEQ, SPEC_K, (381,), ()))


def check_contiguous_chunk(torch, llama, device):
    """Phase 12's route check: a chunked forward's K/V write and attention
    over a contiguous cache seen as a degenerate block pool
    (``llama._chunk_attention_contiguous``: one ``append_kv_ragged`` and
    one ``chunk_attention`` launch), 32 query heads over 8 kv heads of
    128, bf16 and int8 KV, at every CONTIG_CASES shape, against the plain
    version on the same inputs (the ragged slab write, then
    ``cached_gqa_attention`` in f32): the cache bytes equal to the plain
    write's, an inactive slot's rows untouched, the active rows' outputs
    within tolerance.  Library: SDPA with a boolean mask over the cache
    (bf16)."""
    import torch.nn.functional as F

    from aiko_services_tpu_torch.ops import paged_prefill as pp
    from aiko_services_tpu_torch.ops.paged_attention import (
        cached_gqa_attention)
    gen = torch.Generator(device=device).manual_seed(12)
    config = dataclasses.replace(llama.CONFIGS["llama3_8b"], n_layers=1)
    kv, group, hd = config.n_kv_heads, config.n_heads // config.n_kv_heads, \
        config.head_dim
    rows, worst = [], 0.0

    def plain_route(*_):
        fail("phase 12 route check: the chunk took the plain path on the "
             "card")
    for quant_kv in (False, True):
        for label, slots, max_seq, T, starts, idle in CONTIG_CASES:
            cache = llama.init_cache(config, slots, max_seq,
                                     quantize_kv=quant_kv, device=device)[0]
            for key, src in llama._pool_sources(
                    cache, torch.randn(cache["k"].shape, generator=gen,
                                       device=device),
                    torch.randn(cache["k"].shape, generator=gen,
                                device=device)).items():
                cache[key].copy_(src)
            active = torch.tensor([s not in idle for s in range(slots)],
                                  device=device)
            starts_t = torch.where(active, torch.tensor(
                starts, dtype=torch.int32, device=device), 0) \
                .to(torch.int32)
            lens = torch.where(active, T, 0).to(torch.int32)
            positions = starts_t.long()[:, None] \
                + torch.arange(T, device=device)[None, :]
            q = torch.randn((slots, T, kv, group, hd), generator=gen,
                            device=device).to(torch.bfloat16)
            k_new = torch.randn((slots, T, kv, hd), generator=gen,
                                device=device).to(torch.bfloat16)
            v_new = torch.randn((slots, T, kv, hd), generator=gen,
                                device=device).to(torch.bfloat16)
            plant_division_ties(torch, k_new[:, 0, 0])
            got = {key: buf.clone() for key, buf in cache.items()}
            before = (pp.append_kv_ragged.launches,
                      pp.chunk_attention.launches)

            def route():
                return llama._chunk_attention_contiguous(
                    q, k_new, v_new, got, starts_t, lens, positions,
                    plain_route, hd, None)
            out = route()
            if (pp.append_kv_ragged.launches - before[0],
                    pp.chunk_attention.launches - before[1]) != (1, 1):
                fail(f"phase 12 route check {label}: not one launch of each "
                     "kernel")
            want = {key: buf.clone() for key, buf in cache.items()}
            live = torch.nonzero(active)[:, 0]
            sub = {key: buf[live] for key, buf in want.items()}
            llama._cache_write_ragged_slab(sub, k_new[live], v_new[live],
                                           starts_t[live])
            for key in want:
                want[key][live] = sub[key]
            torch.cuda.synchronize()
            where = f"phase 12 route check {label} int8={quant_kv}"
            for key in got:
                if not torch.equal(got[key], want[key]):
                    fail(f"{where}: cache {key} differs from the plain "
                         "write (or an inactive slot's rows changed)")
            plain_cache = want if quant_kv else {
                key: buf.float() for key, buf in want.items()}
            expect = cached_gqa_attention(q.float(), plain_cache, positions,
                                          hd)
            err, ratio = compare(out[live], expect[live])
            if not ratio <= 1.0:
                fail(f"{where}: max abs err {err}, err/tol {ratio}")
            worst = max(worst, ratio)
            ms = device_ms(torch, route, 20)
            scratch = {key: buf.clone() for key, buf in cache.items()}

            def plain():
                llama._cache_write_ragged_slab(scratch, k_new, v_new,
                                               starts_t)
                return cached_gqa_attention(q, scratch, positions, hd)
            plain_ms = device_ms(torch, plain, 3)
            library_ms = None
            if not quant_kv:
                q_s = q.reshape(slots, T, kv * group, hd).transpose(1, 2)
                k_s = got["k"].transpose(1, 2)
                v_s = got["v"].transpose(1, 2)
                mask = (torch.arange(max_seq, device=device)[None, None, :]
                        <= positions[..., None])[:, None]
                library_ms = device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q_s, k_s, v_s, attn_mask=mask, enable_gqa=True), 20)
            live_n = int(live.numel())
            keys = sum(int(starts_t[s]) + T for s in live.tolist())
            pairs = sum(_chunk_pairs(int(starts_t[s]), T, None)[0]
                        for s in live.tolist())
            elem = 1 if quant_kv else 2
            moved = (keys * kv * hd * elem * 2
                     + (keys * kv * 4 * 2 if quant_kv else 0)
                     + 2 * live_n * T * kv * group * hd * 2
                     + 2 * live_n * T * kv * hd * (2 + elem))
            b_ms, b_by = bound(moved, 4 * hd * kv * group * pairs)
            rows.append(dict(
                shape=f"{label}: {slots} x {max_seq} rows, T={T} at "
                      f"{list(starts)}{' inactive ' + str(list(idle)) if idle else ''}"
                      f" h=32 kv=8 hd=128 bs=128 int8={quant_kv}",
                err=err, ratio=ratio, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms))
            del cache, got, want, scratch
    return rows, worst


def contig_prompts(np, vocab):
    """Phase 3's ten prompts (PROMPTS), drawn as phase 3 draws them."""
    rng = np.random.default_rng(7)
    rng.integers(1, vocab, 100)                 # phase 3's warm-up prompt
    return [rng.integers(1, vocab, plen).astype(np.int32)
            for plen in PROMPTS]


def serve_contig(torch, np, llama, kernels, server_cls, request_cls, params,
                 draft_1b, device, mode, quantize_kv, chunk):
    """Phase 12 (a): ContinuousBatchingServer at phase 3's shape (8 slots,
    1,024 rows) with spec_k = 4 and phase 3's traffic in its three waves:
    ``mode`` "paired" (the target as its own draft), "adaptive" (the int8
    1b draft, spec_adaptive) or "ngram"; ``chunk`` > 0 admits prompts past
    it a chunk a step (prefill_chunk).  Every greedy token is held to
    phase 3's batch-1 oracle (teacher-forced past a near-tie), and the
    launches of ``chunk_attention`` and ``append_kv_ragged`` exactly to
    (verify passes + prefill chunks) x 32 layers + draft resyncs x the
    draft's layers."""
    config = llama.CONFIGS["llama3_8b"]
    draft_name = {"paired": "llama3_8b", "adaptive": "1b"}.get(mode)
    kwargs = dict(config_name="llama3_8b", slots=SLOTS, max_seq=MAX_SEQ,
                  chunk_steps=CHUNK_STEPS, params=params, quantize=True,
                  quantize_kv=quantize_kv, chunk_prefill_tokens=chunk,
                  spec_k=SPEC_K, device=device)
    if mode == "ngram":
        kwargs["draft_mode"] = "ngram"
    else:
        kwargs.update(draft_config_name=draft_name,
                      draft_params=params if mode == "paired" else draft_1b,
                      spec_adaptive=mode == "adaptive")
    server = server_cls(**kwargs)
    server.warm_spec_ladder()          # each rung once on the idle engine
    requests = [request_cls(f"c{i}", prompt, NEW_TOKENS) for i, prompt
                in enumerate(contig_prompts(np, config.vocab_size))]
    chunks, prefill_chunk = [], llama.prefill_chunk

    def recorded_chunk(params, tokens, *args, **kw):
        chunks.append(int(tokens.shape[1]))
        return prefill_chunk(params, tokens, *args, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    llama.prefill_chunk = recorded_chunk
    try:
        for kernel in kernels:
            kernel.launches = 0
        began = time.monotonic()
        for batch in (requests[:5], requests[5:8], requests[8:]):
            for request in batch:
                server.submit(request)
            for _ in range(3):
                server.step()
        server.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - began
        launches = {kernel.__name__: kernel.launches for kernel in kernels}
    finally:
        llama.prefill_chunk = prefill_chunk
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = server.stats()
    where = f"phase 12 (a) {mode}, int8 KV {quantize_kv}"
    for request in requests:
        if request.error is not None or len(request.tokens) != NEW_TOKENS:
            fail(f"{where} request {request.request_id}: error "
                 f"{request.error}, {len(request.tokens)} tokens")
    rounds, layers = stats["spec_rounds"], config.n_layers
    draft_layers = llama.CONFIGS[draft_name].n_layers if draft_name else 0
    expected_chunks = sum(-(-len(r.prompt) // chunk) for r in requests
                          if chunk and len(r.prompt) > chunk)
    if rounds <= 0 or len(chunks) != expected_chunks:
        fail(f"{where}: {rounds} rounds, {len(chunks)} prefill chunks "
             f"(expected {expected_chunks})")
    want = layers * (rounds + len(chunks)) + draft_layers * rounds
    for name in ("chunk_attention", "append_kv_ragged"):
        if launches[name] != want:
            fail(f"{where}: {name} {launches[name]} launches, expected "
                 f"{want} (rounds {rounds}, prefill chunks {len(chunks)}, "
                 f"draft layers {draft_layers})")
    used = ("int8_matmul", "flash_attention") + (() if mode == "ngram" else (
        "paged_decode_attention", "write_kv_rows"))
    for name in used:
        if not launches[name]:
            fail(f"{where}: {name} was never launched")
    if launches["append_kv"]:
        fail(f"{where}: the aligned writer launched {launches['append_kv']} "
             "times (the contiguous chunks take the ragged one)")
    if mode == "paired" and not stats["spec_tokens_per_target_pass"] > 1.0:
        fail(f"{where}: {stats['spec_tokens_per_target_pass']} tokens per "
             "target pass")
    if not peak_gb < 80:
        fail(f"{where}: peak device memory {peak_gb:.2f} GB")
    exact, equal, checked, ties = check_requests(
        torch, requests, lambda request: contiguous_oracle(
            torch, llama, params, config, request.prompt, quantize_kv,
            device), memo=("contiguous", id(params), quantize_kv, MAX_SEQ))
    ttfts = sorted((r.first_token_ts - r.submitted_ts) * 1e3
                   for r in requests)
    return dict(mode=mode, draft=draft_name or "ngram",
                kv="int8" if quantize_kv else "bf16",
                chunk_prefill_tokens=chunk, requests=len(requests),
                requests_exact=exact, tokens_checked=checked,
                tokens_equal=equal, accepted_near_ties=ties,
                launches=launches, prefill_chunks=len(chunks),
                wall_s=wall, served_tok_s=len(requests) * NEW_TOKENS / wall,
                ttft_ms_p50=ttfts[len(ttfts) // 2], ttft_ms_max=ttfts[-1],
                peak_gb=peak_gb,
                **{key: stats[key] for key in (
                    "spec_rounds", "spec_proposed", "spec_accepted",
                    "spec_acceptance_rate", "spec_tokens_per_target_pass",
                    "spec_k_effective", "spec_ngram_hits",
                    "decode_steps")})


def serve_standalone(torch, np, llama, speculative, kernels, params,
                     draft_1b, device):
    """Phase 12 (b): the standalone batch-1 loops, llama3_8b int8 with the
    int8 1b draft, k = 4, one 256-token prompt, 64 new tokens, caches of
    512 rows.  ``speculative_generate``'s tokens are set beside
    ``complete()``'s greedy tokens, which must equal ``prefill`` +
    ``generate_tokens`` on the same 384-row cache bit for bit (the oracle's
    argmax chain); where they part, the speculative tokens are held to the
    batch-1 oracle, teacher-forced past a near-tie; ``chunk_attention`` and
    ``append_kv_ragged`` launch once a layer of every ``prefill_chunk``
    call (the verify on the target, the resync on the draft), and the
    verifies are the target passes after the prefill.  The sampled loop at
    STANDALONE_TEMP gives 64 tokens in the vocabulary; at temperature 0,
    given the unaligned max_seq STANDALONE_UNALIGNED_MAX_SEQ (its caches
    round up to 512 rows), its first STANDALONE_ZERO_NEW tokens are the
    greedy loop's, with the chunk kernels launched once a layer of each of
    its ``prefill_chunk`` calls.  ``complete()`` at the unaligned 256 +
    STANDALONE_UNALIGNED_NEW rows (rounded up to 384) gives the 64-token
    completion's first tokens and launches the decode attention and write
    kernels once a layer a step."""
    from aiko_services_tpu_torch.ops.paged_attention import contiguous_rows
    config, draft_config = llama.CONFIGS["llama3_8b"], llama.CONFIGS["1b"]
    kernels_by_name = {kernel.__name__: kernel for kernel in kernels}
    prompt = np.random.default_rng(31).integers(
        1, config.vocab_size, STANDALONE_PROMPT).astype(np.int32)
    calls, prefill_chunk = [], llama.prefill_chunk

    def recorded_chunk(params, tokens, cache, start, config, **kwargs):
        calls.append(config.n_layers)
        return prefill_chunk(params, tokens, cache, start, config, **kwargs)

    def timed(fn):
        torch.cuda.synchronize()
        began = time.monotonic()
        result = fn()
        torch.cuda.synchronize()
        return result, (time.monotonic() - began) * 1e3
    where = "phase 12 (b)"
    llama.prefill_chunk = recorded_chunk
    try:
        for kernel in kernels:
            kernel.launches = 0
        (tokens, stats), greedy_ms = timed(
            lambda: speculative.speculative_generate(
                params, draft_1b, prompt, STANDALONE_NEW, config,
                draft_config, k=SPEC_K, max_seq=STANDALONE_MAX_SEQ))
        launches = {kernel.__name__: kernel.launches for kernel in kernels}
        greedy_calls = list(calls)
        (sampled, sampled_stats), sampled_ms = timed(
            lambda: speculative.speculative_generate_sampled(
                params, draft_1b, prompt, STANDALONE_NEW, config,
                draft_config, k=SPEC_K, temperature=STANDALONE_TEMP,
                seed=0, max_seq=STANDALONE_MAX_SEQ))
        del calls[:]
        for kernel in kernels:
            kernel.launches = 0
        zero, _ = speculative.speculative_generate_sampled(
            params, draft_1b, prompt, STANDALONE_ZERO_NEW, config,
            draft_config, k=SPEC_K, temperature=0.0,
            max_seq=STANDALONE_UNALIGNED_MAX_SEQ)
        zero_launches = {kernel.__name__: kernel.launches
                         for kernel in kernels}
        zero_calls = list(calls)
    finally:
        llama.prefill_chunk = prefill_chunk
    for name in ("chunk_attention", "append_kv_ragged"):
        if not zero_calls or zero_launches[name] != sum(zero_calls):
            fail(f"{where}: max_seq {STANDALONE_UNALIGNED_MAX_SEQ}: {name} "
                 f"{zero_launches[name]} launches, expected "
                 f"{sum(zero_calls)} (prefill_chunk calls {zero_calls})")
    for name in ("chunk_attention", "append_kv_ragged"):
        if launches[name] != sum(greedy_calls):
            fail(f"{where}: {name} {launches[name]} launches, expected "
                 f"{sum(greedy_calls)} (prefill_chunk calls {greedy_calls})")
    verifies = greedy_calls.count(config.n_layers)
    if verifies != stats.target_passes - 1:
        fail(f"{where}: {verifies} verifies for {stats.target_passes} "
             "target passes")
    for name in ("int8_matmul", "flash_attention", "paged_decode_attention",
                 "write_kv_rows"):
        if not launches[name]:
            fail(f"{where}: {name} was never launched")
    if launches["append_kv"]:
        fail(f"{where}: the aligned writer launched {launches['append_kv']} "
             "times")
    if len(tokens) != STANDALONE_NEW or len(sampled) != STANDALONE_NEW \
            or not all(0 <= t < config.vocab_size for t in sampled):
        fail(f"{where}: {len(tokens)} greedy tokens, {len(sampled)} sampled "
             f"(max {int(max(sampled))})")
    if zero.tolist() != tokens[:STANDALONE_ZERO_NEW].tolist():
        fail(f"{where}: the sampled loop at temperature 0 is not the greedy "
             "loop")
    completed, complete_ms = timed(lambda: llama.complete(
        params, prompt[None], config, max_new_tokens=STANDALONE_NEW))
    cache = llama.init_cache(config, 1, contiguous_rows(
        STANDALONE_PROMPT + STANDALONE_NEW), device=device)
    logits, cache = llama.prefill(
        params, torch.as_tensor(prompt, device=device)[None], cache, config)
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    rest, _ = llama.generate_tokens(params, first, cache, STANDALONE_PROMPT,
                                    STANDALONE_NEW - 1, config)
    reference = [int(first[0, 0])] + rest[0].tolist()
    if completed[0].tolist() != reference:
        fail(f"{where}: complete() differs from prefill + generate_tokens")
    for kernel in kernels:
        kernel.launches = 0
    unaligned = llama.complete(params, prompt[None], config,
                               max_new_tokens=STANDALONE_UNALIGNED_NEW)
    rows = STANDALONE_PROMPT + STANDALONE_UNALIGNED_NEW
    steps = (STANDALONE_UNALIGNED_NEW - 1) * config.n_layers
    for name in ("paged_decode_attention", "write_kv_rows"):
        if kernels_by_name[name].launches != steps:
            fail(f"{where}: complete() at {rows} rows: {name} "
                 f"{kernels_by_name[name].launches} launches, expected "
                 f"{steps}")
    if unaligned[0].tolist() != reference[:STANDALONE_UNALIGNED_NEW]:
        fail(f"{where}: complete() at {rows} rows differs from the "
             f"{STANDALONE_NEW}-token completion")
    served = [int(t) for t in tokens]
    agree = next((i for i, (a, b) in enumerate(zip(served, reference))
                  if a != b), STANDALONE_NEW)
    equal, ties = agree, []
    if agree < STANDALONE_NEW:
        # Past complete()'s argmax chain, the teacher-forced oracle.
        request = types.SimpleNamespace(request_id="standalone",
                                        prompt=prompt, tokens=served)
        equal, ties = check_request(torch, request, *contiguous_oracle(
            torch, llama, params, config, prompt, False, device,
            rows=STANDALONE_MAX_SEQ))
    return dict(prompt=STANDALONE_PROMPT, new=STANDALONE_NEW,
                max_seq=STANDALONE_MAX_SEQ, draft="1b",
                tokens_equal_oracle=equal, accepted_near_ties=ties,
                leading_tokens_equal_complete=agree, launches=launches,
                prefill_chunk_calls=len(greedy_calls), verifies=verifies,
                unaligned_max_seq=STANDALONE_UNALIGNED_MAX_SEQ,
                unaligned_prefill_chunk_calls=len(zero_calls),
                unaligned_complete_rows=rows,
                greedy_ms=greedy_ms, greedy_target_passes=stats.target_passes,
                greedy_acceptance=stats.acceptance_rate,
                greedy_tokens_per_target_pass=stats.tokens_per_target_pass,
                sampled_ms=sampled_ms,
                sampled_target_passes=sampled_stats.target_passes,
                sampled_acceptance=sampled_stats.acceptance_rate,
                sampled_tokens_per_target_pass=(
                    sampled_stats.tokens_per_target_pass),
                complete_ms=complete_ms)


def serve_rolling(torch, np, llama, kernels, device):
    """Phase 12 (c): mistral_7b (window 4,096) with random int8 weights
    built on the card, batch 2, a 4,352-token prompt, 32 greedy tokens, on
    a rolling cache (4,096 rows; its decode takes the plain masked
    attention by layout, no decode attention kernel launches, and writes
    its rows by the decode write kernel, row ``pos % 4,096``) and on a
    plain cache of 4,384 rows (the paged decode kernel
    with window 4,096).  The rolling run's tokens are held to the plain
    run's, and where a row differs, to a batch-1 oracle on the plain layout
    teacher-forced past a near-tie.  The weights are freed at the end."""
    config = llama.CONFIGS["mistral_7b"]
    began = time.monotonic()
    params = llama.random_quantized_params(config, seed=2, device=device)
    torch.cuda.synchronize()
    build_s = time.monotonic() - began
    rng = np.random.default_rng(41)
    prompts = rng.integers(1, config.vocab_size, (
        ROLLING_BATCH, ROLLING_PROMPT)).astype(np.int32)
    rows = ROLLING_PROMPT + ROLLING_STEPS
    runs = {}
    for layout in ("rolling", "plain"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for kernel in kernels:
            kernel.launches = 0
        began = time.monotonic()
        cache = llama.init_cache(config, ROLLING_BATCH, rows,
                                 rolling=layout == "rolling", device=device)
        logits, cache = llama.prefill(
            params, torch.as_tensor(prompts, device=device), cache, config)
        first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_began = time.monotonic()
        rest, cache = llama.generate_tokens(params, first, cache,
                                            ROLLING_PROMPT,
                                            ROLLING_STEPS - 1, config)
        torch.cuda.synchronize()
        runs[layout] = dict(
            tokens=torch.cat([first, rest], dim=1).tolist(),
            wall_s=time.monotonic() - began,
            decode_step_ms=(time.monotonic() - decode_began) * 1e3
            / (ROLLING_STEPS - 1),
            cache_rows=int(cache[0]["k"].shape[1]),
            cache_gb=sum(buf.numel() * buf.element_size()
                         for layer in cache for buf in layer.values()) / 1e9,
            peak_gb_over_weights=(torch.cuda.max_memory_allocated()
                                  - base) / 1e9,
            launches={kernel.__name__: kernel.launches
                      for kernel in kernels})
        del cache, logits
    rolling, plain = runs["rolling"], runs["plain"]
    layers, steps = config.n_layers, ROLLING_STEPS - 1
    want = {"rolling": dict(flash_attention=layers, paged_decode_attention=0,
                            write_kv_rows=layers * steps),
            "plain": dict(flash_attention=layers,
                          paged_decode_attention=layers * steps,
                          write_kv_rows=layers * steps)}
    for layout, run in runs.items():
        for name, expected in want[layout].items():
            if run["launches"][name] != expected:
                fail(f"phase 12 (c) {layout}: {name} {run['launches'][name]}"
                     f" launches, expected {expected}")
        if not run["launches"]["int8_matmul"]:
            fail(f"phase 12 (c) {layout}: int8_matmul was never launched")
    checked, equal, ties = 0, 0, []
    for row in range(ROLLING_BATCH):
        tokens = rolling["tokens"][row]
        checked += len(tokens)
        if tokens == plain["tokens"][row]:
            equal += len(tokens)
            continue
        request = types.SimpleNamespace(request_id=f"rolling{row}",
                                        prompt=prompts[row], tokens=tokens)
        same, near = check_request(torch, request, *contiguous_oracle(
            torch, llama, params, config, prompts[row], False, device,
            rows=rows))
        equal += same
        ties += [(row, index, gap) for index, gap in near]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(config="mistral_7b", window=config.sliding_window,
                batch=ROLLING_BATCH, prompt=ROLLING_PROMPT,
                steps=ROLLING_STEPS, weights_build_s=build_s,
                tokens_checked=checked, tokens_equal=equal,
                accepted_near_ties=ties,
                **{f"{layout}_{key}": value for layout, run in runs.items()
                   for key, value in run.items() if key != "tokens"})


def serve_contiguous_phase(torch, np, llama, speculative, kernels,
                           server_cls, request_cls, params, draft_1b, device,
                           parts=("route", "servers", "standalone",
                                  "rolling")):
    """Phase 12, the parts named in ``parts``: the route check, then (a)
    CONTIG_RUNS, (b) the standalone loops, (c) rolling caches.  Returns
    ``{part: result}`` with each part's seconds."""
    out = {}
    for part in parts:
        began = time.monotonic()
        if part == "route":
            out[part] = check_contiguous_chunk(torch, llama, device)
        elif part == "servers":
            out[part] = [serve_contig(torch, np, llama, kernels, server_cls,
                                      request_cls, params, draft_1b, device,
                                      mode, quantize_kv, chunk)
                         for mode, quantize_kv, chunk in CONTIG_RUNS]
        elif part == "standalone":
            out[part] = serve_standalone(torch, np, llama, speculative,
                                         kernels, params, draft_1b, device)
        else:
            out[part] = serve_rolling(torch, np, llama, kernels, device)
        out[f"{part}_s"] = time.monotonic() - began
        gc.collect()
        torch.cuda.empty_cache()
    return out


def print_contiguous_phase(phase, smi):
    """One line a run of phase 12, each with the card's name and power
    limit."""
    if "route" in phase:
        rows, worst = phase["route"]
        print_rows("phase 12 route check: append_kv_ragged + chunk_attention"
                   " on the degenerate pool (cache bytes equal to the plain "
                   "write's)", rows)
        log(f"phase 12 route check worst err/tol {worst:.3f}; "
            f"{phase['route_s']:.1f} s; {smi}")
    for run in phase.get("servers", ()):
        log(f"--- phase 12 (a) contiguous speculation ({run['mode']}), "
            f"llama3_8b int8, {run['kv']} KV: " + json.dumps(run))
        log(f"phase 12 (a) {run['mode']}, {run['kv']} KV, chunk "
            f"{run['chunk_prefill_tokens']}: {run['spec_rounds']} spec "
            f"rounds, acceptance {run['spec_acceptance_rate']:.4f}, "
            f"{run['spec_tokens_per_target_pass']:.4f} tokens a target "
            f"pass, TTFT p50 {run['ttft_ms_p50']:.1f} ms, "
            f"{run['served_tok_s']:.1f} tok/s, {run['tokens_equal']} of "
            f"{run['tokens_checked']} tokens the oracle's argmax; {smi}")
    if "standalone" in phase:
        run = phase["standalone"]
        log("--- phase 12 (b) the standalone loops, llama3_8b int8, 1b "
            "draft: " + json.dumps(run))
        log(f"phase 12 (b): speculative_generate {run['greedy_ms']:.1f} ms "
            f"({run['greedy_tokens_per_target_pass']:.4f} tokens a target "
            f"pass), speculative_generate_sampled at {STANDALONE_TEMP} "
            f"{run['sampled_ms']:.1f} ms "
            f"({run['sampled_tokens_per_target_pass']:.4f}), complete() "
            f"{run['complete_ms']:.1f} ms, {STANDALONE_NEW} tokens each; "
            f"{smi}")
    if "rolling" in phase:
        run = phase["rolling"]
        log("--- phase 12 (c) rolling cache, mistral_7b int8: "
            + json.dumps(run))
        log(f"phase 12 (c): rolling cache {run['rolling_cache_gb']:.3f} GB "
            f"(peak {run['rolling_peak_gb_over_weights']:.3f} GB over the "
            f"weights), plain {run['plain_cache_gb']:.3f} GB (peak "
            f"{run['plain_peak_gb_over_weights']:.3f} GB); an eager decode "
            f"step (batch 2) {run['rolling_decode_step_ms']:.2f} ms on the "
            f"rolling cache (plain attention), "
            f"{run['plain_decode_step_ms']:.2f} ms on the plain one (the "
            f"decode kernel); "
            f"{run['tokens_equal']} of {run['tokens_checked']} tokens "
            f"equal; {smi}")
    log("phase 12 parts: " + ", ".join(
        f"{key[:-2]} {value:.1f} s" for key, value in phase.items()
        if key.endswith("_s")) + f"; {smi}")


# --------------------------------------------------------------------------- #
# Phase 13: grammars and adapters

#: The phase's parts (scripts/smoke_grammar_lora.py names them).
GRAMMAR_LORA_PARTS = ("constrained", "structured", "adapters", "multitenant")
#: (a) constrained_generate at phase 3's contiguous shape: 8 rows of 256
#: prompt tokens, 16 constrained steps (the command grammar ends within 12).
GRAMMAR_BATCH, GRAMMAR_PROMPT, GRAMMAR_NEW = 8, 256, 16
#: (b) run_structured's requests (each pass), their arrival rate (every
#: request in well under a second: the passes are decode-bound), and the
#: temperature of its sampled constrained check.
STRUCTURED_REQUESTS, STRUCTURED_RATE_HZ, STRUCTURED_TEMP = 24, 48.0, 0.9
#: (c), (d): four tenants of rank 8 on wq / wv with non-zero B (the JAX
#: tests' noisy adapters, numpy from loadgen's seeds), tenant t at stacked
#: index t + 1 of the oracle's stack.
TENANTS, TENANT_RANK, TENANT_ALPHA = 4, 8, 16.0
#: (c) the host tier that takes tenant-0's demoted pages (2 MiB a block).
ADAPTER_HOST_BLOCKS = 16
#: (d) run_multitenant's measured requests an arm (after 8 warm-up ones).
MULTITENANT_REQUESTS = 16


def tenant_config(lora):
    return lora.LoRAConfig(rank=TENANT_RANK, alpha=TENANT_ALPHA,
                           targets=("wq", "wv"))


def tenant_factors(loadgen, config, lora_config, index):
    """Tenant ``index``'s factors: loadgen's noisy adapter (seed 100 +
    index, the multi-tenant rig's)."""
    return loadgen._noisy_loadgen_adapter(config, lora_config, 100 + index)


def hold_constrained(torch, np, llama, params, config, device, label, table,
                     start, pairs, pad=None, rows=None):
    """Hold constrained (prompt, tokens) pairs to a teacher-forced oracle
    whose logits are masked to the automaton's allowed set: every token
    the masked argmax or within TIE_GAP of it, and legal.  Pairs of one
    prompt length prefill together, at most ``rows`` at a time (None: all
    of them), and decode on their served tokens; ``rows=1`` is the batch-1
    oracle, which a batched program under test cannot share.  ``pad``: the
    token a row emits once its state is terminal (constrained_generate); a
    served row otherwise ends there."""
    allowed = torch.as_tensor(table.allowed, device=device)
    groups = {}
    for number, (prompt, tokens) in enumerate(pairs):
        groups.setdefault(len(prompt), []).append(
            (number, np.asarray(prompt, np.int32), list(tokens)))
    batches = []
    for length, group in sorted(groups.items()):
        step = rows or len(group)
        batches += [(length, group[i:i + step])
                    for i in range(0, len(group), step)]
    checked, equal, ties = 0, 0, []
    for length, group in batches:
        new = max(len(tokens) for _, _, tokens in group)
        prompts = torch.as_tensor(np.stack([p for _, p, _ in group]),
                                  device=device)
        cache = llama.init_cache(config, len(group),
                                 -(-(length + new) // 128) * 128,
                                 device=device)
        logits, cache = llama.prefill(params, prompts, cache, config)
        logits = logits[:, -1]
        states = [start] * len(group)
        for index in range(new):
            masked = torch.where(allowed[torch.as_tensor(
                states, device=device)], logits,
                torch.full_like(logits, -torch.inf))
            best = masked.argmax(-1).tolist()
            scores = masked.float().cpu()
            feed = []
            for row, (number, _, tokens) in enumerate(group):
                if index >= len(tokens):
                    feed.append(0)
                    continue
                served = int(tokens[index])
                feed.append(served)
                if table.is_terminal(states[row]):
                    if pad is None or served != pad:
                        fail(f"{label}: row {number} emitted {served} past "
                             "its terminal state")
                    continue
                if not table.allowed[states[row], served]:
                    fail(f"{label}: row {number} token {index} ({served}) is "
                         f"illegal in state {states[row]}")
                checked += 1
                if served == best[row]:
                    equal += 1
                else:
                    gap = float(scores[row, best[row]] - scores[row, served])
                    if gap > TIE_GAP:
                        fail(f"{label}: row {number} token {index} is "
                             f"{served}, masked oracle {best[row]}, gap "
                             f"{gap:.4f}")
                    ties.append((number, index, round(gap, 4)))
                states[row] = int(table.next_state[states[row], served])
            if index + 1 < new:
                out, cache = llama.decode_step(
                    params, torch.tensor(feed, dtype=torch.int32,
                                         device=device)[:, None],
                    cache, length + index, config)
                logits = out[:, -1]
    return dict(tokens_checked=checked, tokens_equal=equal,
                accepted_near_ties=ties)


def hold_adapted(torch, np, llama, params, config, device, label, stack,
                 triples):
    """Hold (prompt, tokens, stacked adapter index) triples to a
    teacher-forced batch-1 oracle under the same adapter: contiguous
    prefill + decode_step with per-row ``lora`` from ``stack``
    (near-ties within TIE_GAP), one batch a (prompt length, budget)."""
    groups = {}
    for prompt, tokens, index in triples:
        groups.setdefault((len(prompt), len(tokens)), []).append(
            (np.asarray(prompt, np.int32), list(tokens), int(index)))
    checked, equal, ties = 0, 0, []
    for (length, new), group in sorted(groups.items()):
        prompts = torch.as_tensor(np.stack([p for p, _, _ in group]),
                                  device=device)
        served = torch.as_tensor([t for _, t, _ in group],
                                 dtype=torch.int64, device=device)
        lora = dict(stack, ids=torch.as_tensor([i for _, _, i in group],
                                               dtype=torch.int32,
                                               device=device))
        cache = llama.init_cache(config, len(group),
                                 -(-(length + new) // 128) * 128,
                                 device=device)
        logits, cache = llama.prefill(params, prompts, cache, config,
                                      lora=lora)
        logits = logits[:, -1]
        for index in range(new):
            want = served[:, index]
            best = logits.argmax(-1)
            gaps = (logits.gather(1, best[:, None])
                    - logits.gather(1, want[:, None]))[:, 0].tolist()
            for row, (hit, gap) in enumerate(zip((best == want).tolist(),
                                                 gaps)):
                if hit:
                    equal += 1
                elif gap > TIE_GAP:
                    fail(f"{label}: request {row} of {len(group)} (prompt "
                         f"{length}, adapter {group[row][2]}): token {index}"
                         f" is {int(want[row])}, oracle {int(best[row])}, "
                         f"gap {gap:.4f}")
                else:
                    ties.append((row, index, round(gap, 4)))
            checked += len(group)
            if index + 1 < new:
                out, cache = llama.decode_step(
                    params, want[:, None].to(torch.int32), cache,
                    length + index, config, lora=lora)
                logits = out[:, -1]
    return dict(tokens_checked=checked, tokens_equal=equal,
                accepted_near_ties=ties)


def grammar_generate(torch, np, llama, constrained, loadgen, weights,
                     kernels, params, device):
    """(a) ``constrained_generate`` at phase 3's shape: 8 rows of
    GRAMMAR_PROMPT tokens prefilled together on a contiguous cache, then
    GRAMMAR_NEW steps masked by loadgen's command automaton at llama3_8b's
    vocabulary.  Every row is grammatical (then padding), every token the
    masked oracle's within TIE_GAP, the launches one prefill's and
    GRAMMAR_NEW - 1 decode steps'."""
    from aiko_services_tpu_torch.ops.paged_attention import contiguous_rows
    config = llama.CONFIGS["llama3_8b"]
    automaton = loadgen.command_automaton(config.vocab_size)
    table = constrained.stack_automata({"cmd": automaton})
    prompts = np.random.default_rng(41).integers(
        1, config.vocab_size, (GRAMMAR_BATCH, GRAMMAR_PROMPT)).astype(np.int32)
    torch.cuda.synchronize()
    with LaunchWindow(llama, kernels) as window:
        began = time.monotonic()
        cache = llama.init_cache(config, GRAMMAR_BATCH,
                                 contiguous_rows(GRAMMAR_PROMPT + GRAMMAR_NEW),
                                 device=device)
        logits, cache = llama.prefill(params, torch.as_tensor(
            prompts, device=device), cache, config)
        tokens, states, _ = constrained.constrained_generate(
            params, logits[:, -1], cache, GRAMMAR_PROMPT, GRAMMAR_NEW, config,
            automaton.allowed, automaton.next_state)
        torch.cuda.synchronize()
        wall = time.monotonic() - began
    launches = window.launches
    steps = GRAMMAR_NEW - 1
    want = {"flash_attention": config.n_layers,
            "paged_decode_attention": config.n_layers * steps,
            "write_kv_rows": config.n_layers * steps,
            "append_kv": 0, "chunk_attention": 0, "append_kv_ragged": 0,
            weights.name: matmul_launches(weights, config, GRAMMAR_BATCH,
                                          GRAMMAR_PROMPT)
            + matmul_launches(weights, config, GRAMMAR_BATCH, 1) * steps}
    for name, expected in want.items():
        if launches.get(name, 0) != expected:
            fail(f"phase 13 (a) {name}: {launches.get(name)} launches, "
                 f"expected {expected}")
    rows = tokens.cpu().numpy()
    for row in rows:
        # The command ends at its closing brace (token 17), then pads.
        emitted = [int(t) for t in row]
        close = emitted.index(17) if 17 in emitted else None
        if close is None or not automaton.accepts(emitted[:close + 1]) \
                or any(emitted[close + 1:]):
            fail(f"phase 13 (a): row not grammatical then padded: {emitted}")
    held = hold_constrained(torch, np, llama, params, config, device,
                            "phase 13 (a)", table, 0,
                            list(zip(prompts, rows.tolist())), pad=0, rows=1)
    accepted = automaton.accepting[states.cpu().numpy()]
    if not accepted.all():
        fail(f"phase 13 (a): final states {states.tolist()} not accepting")
    return dict(rows=GRAMMAR_BATCH, prompt=GRAMMAR_PROMPT, steps=GRAMMAR_NEW,
                launches=launches, wall_s=wall,
                command_tokens=[int(np.count_nonzero(row)) for row in rows],
                **held)


def structured_server(server_cls, params, device, automaton):
    """Phase 4's paged shape with n-gram speculation (spec_k = 4) and the
    command automaton as ``"cmd"``: the structured rig's replica."""
    return server_cls(config_name="llama3_8b", slots=SLOTS,
                      max_seq=PAGED_MAX_SEQ, chunk_steps=CHUNK_STEPS,
                      params=params, quantize=True, block_size=BLOCK,
                      enable_prefix_cache=True, chunk_prefill_tokens=CHUNK,
                      draft_mode="ngram", spec_k=SPEC_K,
                      automata={"cmd": automaton}, device=device)


def serve_structured(torch, np, llama, loadgen, weights, kernels, server_cls,
                     request_cls, params, device):
    """(b) ``run_structured`` on two replicas handed in (phase 4's shape,
    n-gram speculation, the command automaton): STRUCTURED_REQUESTS
    requests constrained, then the same free.  Every constrained final is
    grammatical (the rig raises otherwise), jump-forward tokens were
    committed, constrained tokens hold to the masked oracle and free ones
    to phase 4's; the launches are the rounds' and slices' (the verify
    and append windows, no decode step: n-gram rounds only); then
    STRUCTURED_TEMP sampled constrained requests stay grammatical."""
    config = llama.CONFIGS["llama3_8b"]
    automaton = loadgen.command_automaton(config.vocab_size)
    servers = [structured_server(server_cls, params, device, automaton)
               for _ in range(2)]
    for server in servers:
        server.warm_spec_ladder()
    handed = []

    def make_server(name):
        server = servers[len(handed) % 2]
        handed.append(server)
        return server
    before = [server.stats() for server in servers]
    errors = ErrorRecords()
    logging.getLogger().addHandler(errors)
    torch.cuda.synchronize()
    try:
        with quick_fleet(), LaunchWindow(llama, kernels) as window:
            began = time.monotonic()
            cons, free = loadgen.run_structured(
                n_requests=STRUCTURED_REQUESTS, rate_hz=STRUCTURED_RATE_HZ,
                spec_k=SPEC_K,
                drain_timeout_s=240.0, make_server=make_server,
                payload_kwargs=dict(vocab=config.vocab_size))
            torch.cuda.synchronize()
            wall = time.monotonic() - began
    finally:
        logging.getLogger().removeHandler(errors)
    if errors.records:
        fail(f"phase 13 (b): logged failures: {errors.records}")
    after = [server.stats() for server in servers]
    rounds = sum(delta(a, b, "spec_rounds") for a, b in zip(after, before))
    steps = sum(delta(a, b, "decode_steps") for a, b in zip(after, before))
    slices = sum(delta(a, b, "prefill_dispatches")
                 for a, b in zip(after, before))
    jump = sum(delta(a, b, "spec_jump_forward_tokens")
               for a, b in zip(after, before))
    launches = window.launches
    if len(window.widths) != slices:
        fail(f"phase 13 (b): {len(window.widths)} slices recorded, "
             f"{slices} counted")
    layers, verify_m = config.n_layers, SLOTS * (SPEC_K + 1)
    rule = weights.rules[weights.name]
    want = {"append_kv": layers * slices, "append_kv_ragged": layers * rounds,
            "chunk_attention": layers * (slices + rounds),
            "paged_decode_attention": layers * (steps - rounds),
            "write_kv_rows": layers * (steps - rounds), "flash_attention": 0,
            weights.name: rounds * (layer_launches(weights, config, verify_m)
                                    + rule(verify_m, config.d_model,
                                           config.vocab_size))
            + sum(layer_launches(weights, config, w) for w in window.widths)}
    for name, expected in want.items():
        if launches.get(name, 0) != expected:
            fail(f"phase 13 (b) {name}: {launches.get(name)} launches, "
                 f"expected {expected} (rounds {rounds}, steps {steps}, "
                 f"slices {window.widths})")
    for label, report in (("constrained", cons), ("free", free)):
        if (report.completed, report.errors, report.timeouts) != (
                STRUCTURED_REQUESTS, 0, 0):
            fail(f"phase 13 (b) {label}: {report} ({report.error_kinds})")
    if not jump or not (cons.spec_stats or {}).get(
            "spec_jump_forward_tokens"):
        fail(f"phase 13 (b): no jump-forward token ({cons.spec_stats})")
    payloads = {flag: loadgen.structured_payloads(
        vocab=config.vocab_size, constrained=flag) for flag in (True, False)}
    table = servers[0]._automata["table"]
    held_cons = hold_constrained(
        torch, np, llama, params, config, device, "phase 13 (b) constrained",
        table, table.start("cmd"),
        [(payloads[True](index)["tokens"], tokens)
         for index, tokens in sorted(finals_by_index(cons).items())])
    held_free = hold_to_oracle(
        torch, np, llama, params, config, device, "phase 13 (b) free",
        [(payloads[False](index)["tokens"], tokens)
         for index, tokens in sorted(finals_by_index(free).items())], set())
    # Sampled constrained rows on an idle replica: grammatical, whatever
    # they draw.
    rng = np.random.default_rng(43)
    sampled = [request_cls(f"t{i}", rng.integers(
        1, config.vocab_size, 40).astype(np.int32), 16,
        temperature=STRUCTURED_TEMP, top_p=0.95, automaton="cmd")
        for i in range(SLOTS)]
    for request in sampled:
        servers[0].submit(request)
    servers[0].run_until_drained()
    for request in sampled:
        if request.error is not None or not automaton.accepts(request.tokens):
            fail(f"phase 13 (b) sampled {request.request_id}: "
                 f"{request.error}, {request.tokens}")
    cons_tokens = [len(t) for t in cons.final_tokens.values()]
    return dict(
        requests=STRUCTURED_REQUESTS, launches=launches, spec_rounds=rounds,
        prefill_slices=slices, jump_forward_tokens=jump,
        jump_forward_per_request=jump / STRUCTURED_REQUESTS,
        constrained_tokens_mean=sum(cons_tokens) / len(cons_tokens),
        constrained_tok_s=cons.throughput_tps, free_tok_s=free.throughput_tps,
        constrained_ttft_ms_p50=cons.ttft_p50_ms,
        free_ttft_ms_p50=free.ttft_p50_ms,
        tokens_per_target_pass=cons.spec_stats[
            "spec_tokens_per_target_pass"],
        free_tokens_per_target_pass=(free.spec_stats or {}).get(
            "spec_tokens_per_target_pass"),
        sampled_grammatical=len(sampled), wall_s=wall,
        held_constrained=held_cons, held_free=held_free)


def adapter_server(server_cls, params, device, **kwargs):
    """Phase 4's paged shape (8 slots, 4096-row tables of 16-row blocks,
    prefix cache, 256-token slices, bf16 KV), adapters loaded later."""
    return server_cls(config_name="llama3_8b", slots=SLOTS,
                      max_seq=PAGED_MAX_SEQ, chunk_steps=CHUNK_STEPS,
                      params=params, quantize=True, block_size=BLOCK,
                      enable_prefix_cache=True, chunk_prefill_tokens=CHUNK,
                      device=device, **kwargs)


def paged_waves(server, request_cls, waves, adapter_of):
    """Phase 4's wave schedule of ``waves`` through ``server``, request i
    under ``adapter_of(i)``: the requests."""
    requests = []
    for index, wave in enumerate(waves):
        batch = [request_cls(f"p{len(requests) + i}", prompt, NEW_TOKENS,
                             adapter=adapter_of(len(requests) + i))
                 for i, prompt in enumerate(wave)]
        requests += batch
        for request in batch:
            server.submit(request)
        if index == 0:
            while batch[0].first_token_ts is None:
                server.step()
        elif index == 1:
            while any(r.finished_ts is None for r in requests[:4]):
                server.step()
    server.run_until_drained()
    return requests


def serve_adapters(torch, np, llama, lora, lora_paged, loadgen, weights,
                   kernels, server_cls, request_cls, params, device,
                   base_step_ms, base_tokens=None):
    """(c) A mixed-adapter paged server: TENANTS tenants loaded at run time
    (pages in the pool), phase 4's 12 requests, request i on tenant
    (i % 5) - 1 (every fifth on the base).  Base rows are bitwise the
    tokens of an adapter-free server of the same shape on the same
    schedule (``base_tokens``: phase 4's bf16-KV run's; without them such
    a server is run here); adapter rows hold to a batch-1 oracle under
    their adapter;
    the launches are phase 4's formula (the LoRA delta launches no
    kernel).  Then a steady 8-slot window with adapters (graphed, step ms
    beside phase 4's base step, no capture after the fence); tenant-0
    unloaded, its pages demoted to the host tier, warm-loaded from there
    and its request served again to the same tokens; and ``adapter_load``
    / ``adapter_unload`` over the wire with packed factor bytes."""
    import importlib.util

    from aiko_services_tpu_torch import runtime
    from aiko_services_tpu_torch.kvstore import adapters as kvadapters
    from aiko_services_tpu_torch.kvstore import transfer
    from aiko_services_tpu_torch.orchestration.continuous import (
        ContinuousReplica)
    from aiko_services_tpu_torch.pipeline import codec
    from aiko_services_tpu_torch.utils import sexpr
    config = llama.CONFIGS["llama3_8b"]
    lc = tenant_config(lora)
    names = [f"tenant-{i}" for i in range(TENANTS)]
    factors = [tenant_factors(loadgen, config, lc, i) for i in range(TENANTS)]
    stack = lora.stack_adapters(config, lc, factors, device=device)
    server = adapter_server(server_cls, params, device,
                            host_tier_blocks=ADAPTER_HOST_BLOCKS)
    load_began = time.monotonic()
    for name, tree in zip(names, factors):
        server.load_adapter(name, tree, lc)
    torch.cuda.synchronize()
    load_ms = (time.monotonic() - load_began) * 1e3 / TENANTS
    pages = server._adapter_page_counts()["hbm"]
    if pages != TENANTS * len(lora_paged.split_pages(
            lora_paged.pack_adapter(config, lc, factors[0]),
            lora_paged.page_payload_nbytes(transfer._field_layout(server)))):
        fail(f"phase 13 (c): {pages} adapter pages in the pool")

    def adapter_of(index):
        tenant = index % (TENANTS + 1) - 1
        return names[tenant] if tenant >= 0 else None
    waves = paged_traffic(np, config.vocab_size)
    torch.cuda.synchronize()
    before = server.stats()
    with LaunchWindow(llama, kernels) as window:
        began = time.monotonic()
        requests = paged_waves(server, request_cls, waves, adapter_of)
        torch.cuda.synchronize()
        wall = time.monotonic() - began
    stats = server.stats()
    launches = window.hold("phase 13 (c)", weights, config,
                           delta(stats, before, "decode_steps"),
                           delta(stats, before, "prefill_dispatches"))
    for request in requests:
        if request.error is not None or len(request.tokens) != NEW_TOKENS:
            fail(f"phase 13 (c) {request.request_id}: {request.error}, "
                 f"{len(request.tokens)} tokens")
    if base_tokens is None:
        plain = adapter_server(server_cls, params, device)
        base_tokens = [r.tokens for r in paged_waves(
            plain, request_cls, waves, lambda index: None)]
        del plain
    base_rows = [i for i, r in enumerate(requests) if r.adapter is None]
    for index in base_rows:
        if requests[index].tokens != base_tokens[index]:
            fail(f"phase 13 (c): base row {index} differs from the "
                 "adapter-free server's tokens")
    held = hold_adapted(
        torch, np, llama, params, config, device, "phase 13 (c)", stack,
        [(r.prompt, r.tokens, names.index(r.adapter) + 1)
         for r in requests if r.adapter is not None])

    # A steady 8-slot window with adapters: every row on a tenant or the
    # base, graphed once captured, no capture after the fence.
    rng = np.random.default_rng(47)
    steady = [request_cls(f"s{i}", rng.integers(
        1, config.vocab_size, 128).astype(np.int32), 128,
        adapter=adapter_of(i)) for i in range(SLOTS)]
    for request in steady:
        server.submit(request)
    while any(r.first_token_ts is None for r in steady) \
            or (server._graphs_on
                and delta(server.stats(), stats, "graph_replays") == 0):
        server.step()
    server.graph_ledger.fence()
    turns = []
    for _ in range(2):
        start = server.counters["decode_steps"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while server.counters["decode_steps"] - start < TURN_STEPS:
            server.step()
        torch.cuda.synchronize()
        turns.append((time.perf_counter() - t0) * 1e3
                     / (server.counters["decode_steps"] - start))
    server.run_until_drained()
    steady_stats = server.stats()
    if steady_stats["graph_captures_steady_state"]:
        fail(f"phase 13 (c): {steady_stats['graph_captures_steady_state']} "
             "captures after the fence with adapters loaded")

    # Hot unload, demotion of the pages, warm load from the host tier.
    name, first = names[0], next(r for r in requests if r.adapter == names[0])
    n_pages = pages // TENANTS
    keys = kvadapters.adapter_chain_keys(name, n_pages)
    golden = server.fetch_adapter_bytes(name)
    server.unload_adapter(name)
    demoted = server.kv_demotions
    for _ in range(n_pages):
        server._evict_one()
    if any(key in server._index for key in keys) \
            or server.kv_demotions - demoted != n_pages \
            or server.adapter_residency(name) != 1:
        fail(f"phase 13 (c): {name}'s pages did not demote to the host tier "
             f"({server.kv_demotions - demoted} demotions)")
    server.load_adapter(name)
    if server.adapter_warm_loads != 1 \
            or not np.array_equal(server.fetch_adapter_bytes(name), golden):
        fail("phase 13 (c): the warm load did not restack the paged bytes")
    again = request_cls("again", first.prompt.copy(), NEW_TOKENS,
                        adapter=name)
    server.submit(again)
    server.run_until_drained()
    if again.tokens != first.tokens:
        fail(f"phase 13 (c): {name} after the warm load served other tokens")

    # adapter_load / adapter_unload over the wire, the factors as bytes.
    wire_factors = tenant_factors(loadgen, config, lc, TENANTS)
    packed = lora_paged.pack_adapter(config, lc, wire_factors)
    engine = runtime.EventEngine(clock=runtime.VirtualClock())
    process = runtime.Process(namespace="phase13", hostname="h", pid="1",
                              engine=engine, broker="phase13-adapters")
    replica = runtime.compose_instance(
        ContinuousReplica, runtime.actor_args("adapters"), process=process,
        server=server)
    events = {}

    def on_reply(_topic, payload):
        command, params_ = sexpr.parse(payload)
        events[str(params_[0])] = (command, codec.decode_swag(params_[1]))
    process.add_message_handler(on_reply, "phase13/replies")

    def call(command, rid, swag):
        process.message.publish(replica.topic_in, sexpr.generate(
            command, [rid, "phase13/replies", codec.encode_swag(swag)]))
        for _ in range(200_000):
            if rid in events:
                return events[rid][1]
            engine.advance(0.001)
        fail(f"phase 13 (c): no answer to {command} {rid}")
    wire_began = time.monotonic()
    loaded = call("adapter_load", "w1", {"name": "wire", "packed": packed})
    answer = call("infer", "w2", {"tokens": first.prompt,
                                  "max_new_tokens": 8, "adapter": "wire"})
    unloaded = call("adapter_unload", "w3", {"name": "wire"})
    wire_ms = (time.monotonic() - wire_began) * 1e3
    if loaded.get("ok") != "wire" or unloaded.get("ok") != "wire" \
            or "error" in answer or "wire" in server.adapters_loaded:
        fail(f"phase 13 (c) wire: {loaded}, {answer}, {unloaded}")
    wire_stack = lora.stack_adapters(config, lc, [wire_factors],
                                     device=device)
    held_wire = hold_adapted(
        torch, np, llama, params, config, device, "phase 13 (c) wire",
        wire_stack, [(first.prompt, [int(t) for t in np.asarray(
            answer["tokens_out"])], 1)])
    process.terminate()
    return dict(
        tenants=TENANTS, rank=TENANT_RANK, adapter_pages=pages,
        load_ms_per_adapter=load_ms, requests=len(requests),
        base_rows_bitwise=len(base_rows), launches=launches, wall_s=wall,
        served_tok_s=len(requests) * NEW_TOKENS / wall,
        held_adapter_rows=held, steady_step_ms=sum(turns) / len(turns),
        steady_step_ms_turns=turns, phase4_base_step_ms=base_step_ms,
        steady_graph_captures_after_fence=steady_stats[
            "graph_captures_steady_state"],
        graph_captures=steady_stats["graph_captures"],
        graph_replays=steady_stats["graph_replays"],
        warm_reload_tokens_equal=NEW_TOKENS, wire_packed_bytes=int(
            packed.nbytes), wire_ms=wire_ms, held_wire=held_wire,
        safetensors_importable=importlib.util.find_spec("safetensors")
        is not None)


def serve_multitenant(torch, np, llama, lora, loadgen, weights, kernels,
                      server_cls, request_cls, params, device):
    """(d) ``run_multitenant`` aware, then blind, each on two replicas
    handed in (paged, 8 slots, 256-row tables, prefix cache; each warmed
    under its home tenants and fenced): the aware arm takes no cold start,
    the blind one at least one; every final holds to the batch-1 oracle
    under its tenant; launches per :func:`fleet_part`.  The replicas
    advertise their adapter residency every ADVERTISE_S while idle
    (:func:`quick_fleet`), so the rig's wait for it is short."""
    config = llama.CONFIGS["llama3_8b"]
    lc = tenant_config(lora)
    factors = [tenant_factors(loadgen, config, lc, i) for i in range(TENANTS)]
    stack = lora.stack_adapters(config, lc, factors, device=device)
    payload_fn = loadgen.multitenant_payloads(n_adapters=TENANTS,
                                              vocab=config.vocab_size)
    arms = {}
    for aware in (True, False):
        servers = []
        for home in range(2):
            server = server_cls(config_name="llama3_8b", slots=SLOTS,
                                max_seq=256, chunk_steps=CHUNK_STEPS,
                                params=params, quantize=True,
                                block_size=BLOCK, enable_prefix_cache=True,
                                total_blocks=96, device=device)
            for tenant in range(home, TENANTS, 2):
                server.load_adapter(f"tenant-{tenant}", factors[tenant], lc)
            rng = np.random.default_rng(53)
            for index in range(2):
                server.submit(request_cls(
                    f"warm{index}", rng.integers(1, config.vocab_size, 12)
                    .astype(np.int32), 5, adapter=f"tenant-{home}"))
                server.run_until_drained()
            server.graph_ledger.fence()
            servers.append(server)
        with quick_fleet(ADVERTISE_S):
            report, counts = fleet_part(
                torch, llama, weights, kernels, config,
                f"phase 13 (d) {'aware' if aware else 'blind'}", servers,
                lambda make_server: loadgen.run_multitenant(
                    n_requests=MULTITENANT_REQUESTS, rate_hz=25.0,
                    n_adapters=TENANTS, adapter_aware=aware,
                    drain_timeout_s=240.0, make_server=make_server,
                    config_name="llama3_8b", lora_config=lc,
                    payload_kwargs=dict(vocab=config.vocab_size)))
        held = hold_adapted(
            torch, np, llama, params, config, device,
            f"phase 13 (d) {'aware' if aware else 'blind'}", stack,
            [(payload_fn(index)["tokens"], tokens,
              int(payload_fn(index)["adapter"].split("-")[1]) + 1)
             for index, tokens in sorted(finals_by_index(report).items())])
        arms["aware" if aware else "blind"] = dict(
            completed=report.completed, cold_starts=report.adapter_cold_starts,
            warm_routes=report.adapter_warm_routes,
            cold_routes=report.adapter_cold_routes, lost=report.lost,
            timeouts=report.timeouts, ttft_ms_p50=report.ttft_p50_ms,
            tok_s=report.throughput_tps, held=held, **counts,
            adapter_pages=report.server_stats.get("adapter_pages_hbm"))
        del servers
        gc.collect()
        torch.cuda.empty_cache()
    aware, blind = arms["aware"], arms["blind"]
    if aware["cold_starts"] or aware["lost"] or aware["timeouts"] \
            or aware["warm_routes"] < aware["completed"] \
            or aware["completed"] != MULTITENANT_REQUESTS:
        fail(f"phase 13 (d) aware arm: {aware}")
    if not blind["cold_starts"] or blind["lost"] or blind["timeouts"]:
        fail(f"phase 13 (d) blind arm: {blind}")
    return arms


def serve_grammar_lora_phase(torch, np, llama, kernels, server_cls,
                             request_cls, params, device, weights,
                             base_step_ms=None, parts=GRAMMAR_LORA_PARTS):
    """Phase 13, the parts named in ``parts``: (a) constrained_generate,
    (b) the structured rig, (c) the mixed-adapter server, (d) the
    multi-tenant rig.  Returns ``{part: result}`` with each part's
    seconds."""
    from aiko_services_tpu_torch.models import constrained, lora, lora_paged
    from aiko_services_tpu_torch.tools import loadgen
    out = {}
    for part in parts:
        began = time.monotonic()
        if part == "constrained":
            out[part] = grammar_generate(torch, np, llama, constrained,
                                         loadgen, weights, kernels, params,
                                         device)
        elif part == "structured":
            out[part] = serve_structured(torch, np, llama, loadgen, weights,
                                         kernels, server_cls, request_cls,
                                         params, device)
        elif part == "adapters":
            out[part] = serve_adapters(torch, np, llama, lora, lora_paged,
                                       loadgen, weights, kernels, server_cls,
                                       request_cls, params, device,
                                       base_step_ms,
                                       PAGED_TOKENS.get(("int8", False)))
        else:
            out[part] = serve_multitenant(torch, np, llama, lora, loadgen,
                                          weights, kernels, server_cls,
                                          request_cls, params, device)
        out[f"{part}_s"] = time.monotonic() - began
        gc.collect()
        torch.cuda.empty_cache()
    return out


def print_grammar_lora_phase(phase, smi):
    """One line a part of phase 13, each with the card's name and power
    limit."""
    if "constrained" in phase:
        run = phase["constrained"]
        log("--- phase 13 (a) constrained_generate, llama3_8b int8: "
            + json.dumps(run))
        log(f"phase 13 (a): {run['rows']} rows of {run['prompt']} tokens, "
            f"{run['steps']} masked steps in {run['wall_s']:.2f} s, "
            f"{run['tokens_equal']} of {run['tokens_checked']} tokens the "
            f"masked oracle's argmax; {smi}")
    if "structured" in phase:
        run = phase["structured"]
        log("--- phase 13 (b) run_structured, llama3_8b int8: "
            + json.dumps(run))
        log(f"phase 13 (b): {run['jump_forward_tokens']} jump-forward tokens "
            f"({run['jump_forward_per_request']:.2f} a request), "
            f"{run['tokens_per_target_pass']:.4f} tokens a target pass "
            f"constrained against {run['free_tokens_per_target_pass']} free;"
            f" constrained {run['constrained_tok_s']:.1f} tok/s against free"
            f" {run['free_tok_s']:.1f} (a figure, not a gate); {smi}")
    if "adapters" in phase:
        run = phase["adapters"]
        log("--- phase 13 (c) mixed-adapter paged server, llama3_8b int8: "
            + json.dumps(run))
        log(f"phase 13 (c): {run['tenants']} tenants of rank {run['rank']} "
            f"({run['adapter_pages']} pages), {run['base_rows_bitwise']} "
            f"base rows bitwise the adapter-free server's; steady 8-slot "
            f"graphed step with adapters {run['steady_step_ms']:.3f} ms "
            f"against phase 4's base {fmt_ms(run['phase4_base_step_ms'])} "
            f"ms, {run['steady_graph_captures_after_fence']} captures after "
            f"the fence; {smi}")
    if "multitenant" in phase:
        arms = phase["multitenant"]
        log("--- phase 13 (d) run_multitenant, llama3_8b int8: "
            + json.dumps(arms))
        log(f"phase 13 (d): aware {arms['aware']['cold_starts']} cold starts"
            f" ({arms['aware']['warm_routes']} warm routes), blind "
            f"{arms['blind']['cold_starts']} cold starts; TTFT p50 "
            f"{arms['aware']['ttft_ms_p50']:.1f} / "
            f"{arms['blind']['ttft_ms_p50']:.1f} ms; {smi}")
    log("phase 13 parts: " + ", ".join(
        f"{key[:-2]} {value:.1f} s" for key, value in phase.items()
        if key.endswith("_s") and key[:-2] in GRAMMAR_LORA_PARTS)
        + f"; {smi}")


# --------------------------------------------------------------------------- #
# Phase 14: mixture-of-experts at mixtral_8x7b's width

#: Phase 14's parts: (a) the contiguous server, (b) the paged server, (c)
#: speculation with a dense draft, (d) int4 weights on the same experts.
MOE_PARTS = ("contiguous", "paged", "spec", "int4")
#: mixtral_8x7b at its full width (d 4,096, 32 / 8 heads, d_ff 14,336, 8
#: experts, top-2, cf 4.0, vocab 32,000, rope theta 1e6), cut to 8 of its
#: 32 layers: its bf16 experts are 2.82 GB a layer (the JAX package's
#: quantize policy leaves 3-D expert weights dense), so 32 layers (90.2 GB)
#: do not fit one card.
MOE_BASE, MOE_NAME, MOE_LAYERS = "mixtral_8x7b", "mixtral_8x7b_8l", 8
#: (a)'s eight prompts in two waves of four, 32 new tokens each; (c) and
#: (d) serve the first MOE_SHORT of them.  The buckets of a wave differ,
#: so each prompt prefills alone, as its oracle does.
MOE_PROMPTS = (64, 512, 128, 256, 40, 448, 180, 97)
MOE_SHORT = 4
#: (b): four requests share a MOE_PREFIX-token prefix (the producer first,
#: three sharers once it has prefilled), with four distinct prompts.
MOE_PREFIX, MOE_TAILS, MOE_DISTINCT = 512, (40, 16, 100, 7), (64, 333, 180,
                                                              256)
MOE_PAGED_MAX_SEQ = 1024
#: (c)'s draft: the dense ``small`` config (vocabulary 32,000, as
#: mixtral's), int8 weights from seed 1.
MOE_DRAFT = "small"
#: Token counts of the router check: a decode step of 8 slots, (c)'s
#: verify of 8 x 5, and a 256-token slice.
MOE_ROUTER_TOKENS = (8, 40, 256)


def moe_config(llama):
    """Register MOE_NAME (mixtral_8x7b cut to MOE_LAYERS layers) in the
    port's config table and return it."""
    config = dataclasses.replace(llama.CONFIGS[MOE_BASE], n_layers=MOE_LAYERS)
    llama.CONFIGS[MOE_NAME] = config
    return config


def streamed_bytes(torch, params) -> int:
    """Bytes a decode step reads: every layer's weights (all experts: the
    reference's dispatch runs each expert over its capacity buffer) and
    the LM head; the embedding is a row gather."""
    total = 0
    for tree in (params["layers"], params["lm_head"], params["final_norm"]):
        stack = [tree]
        while stack:
            node = stack.pop()
            if torch.is_tensor(node):
                total += node.numel() * node.element_size()
            elif isinstance(node, dict):
                stack += list(node.values())
            else:
                stack += list(node)
    return total


def check_moe_router(torch, moe, quant, params8, params4, device):
    """The router's f32-activation products on the card against f32 plain
    versions computed on the CPU from the same leaves: int8 through
    ``int8_matmul`` (N = 8 takes no kernel shape: the f32 product) and
    int4 through ``int4_matmul`` (K 4,096 in 32 groups, N 8: the grouped
    f32 products), at MOE_ROUTER_TOKENS; TF32 must stay off after them.
    Returns the rows and the worst relative error."""
    gen = torch.Generator(device=device).manual_seed(14)
    rows, worst = [], 0.0
    for bits, params in ((8, params8), (4, params4)):
        router = params["layers"][0]["moe"]["router"]
        cpu = {key: value.cpu() for key, value in router.items()}
        for tokens in MOE_ROUTER_TOKENS:
            x = torch.randn((tokens, params8["layers"][0]["moe"]["w_gate"]
                             .shape[1]), generator=gen, device=device)
            got = moe._router_logits(router, x)
            x_cpu = x.cpu()
            if bits == 8:
                want = quant.int8_matmul_reference(x_cpu, cpu["q"], cpu["s"])
            else:
                want = quant.int4_matmul_reference(x_cpu, cpu["q4"],
                                                   cpu["s"])
            if got.dtype != torch.float32 or got.shape != want.shape:
                fail(f"router int{bits} at {tokens} tokens: {got.dtype} "
                     f"{tuple(got.shape)}")
            err = float((got.cpu() - want).abs().max())
            rel = err / float(want.abs().max())
            worst = max(worst, rel)
            if rel > 1e-5:
                fail(f"router int{bits} at {tokens} tokens: max abs err "
                     f"{err:.3g} ({rel:.3g} of the largest logit)")
            same = bool((got.cpu().topk(2).indices
                         == want.topk(2).indices).all())
            rows.append(dict(bits=bits, tokens=tokens, max_abs_err=err,
                             rel_err=rel, top2_equal=same))
    if torch.backends.cuda.matmul.allow_tf32:
        fail("a router product turned TF32 back on")
    return rows, worst


def moe_launches_want(weights, config, steps, dispatches=(), widths=(),
                      contiguous=True):
    """Expected launches of a MoE serving run: decode steps at SLOTS rows,
    contiguous prefill dispatches ``(rows, seq)`` (flash + logits) or paged
    slices of ``widths`` (append + chunk attention, no logits)."""
    layers = config.n_layers
    want = {name: matmul_launches(weights, config, SLOTS, 1, name) * steps
            + sum(matmul_launches(weights, config, rows, seq, name)
                  for rows, seq in dispatches)
            + sum(layer_launches(weights, config, w, name) for w in widths)
            for name in weights.rules}
    want.update(paged_decode_attention=layers * steps,
                write_kv_rows=layers * steps)
    if contiguous:
        want["flash_attention"] = layers * len(dispatches)
    else:
        want.update(append_kv=layers * len(widths),
                    chunk_attention=layers * len(widths))
    return want


def record_slots(server):
    """request id -> the slot the server activated it in (the oracles run
    the request in that slot: :func:`lockstep_contiguous`)."""
    slots, activate = {}, server._activate_slot

    def recorded(slot, request, *args, **kwargs):
        slots[request.request_id] = slot
        return activate(slot, request, *args, **kwargs)
    server._activate_slot = recorded
    return slots


def lockstep_results(torch, requests, first_logits, step):
    """Batch-1 oracles walked side by side: ``first_logits[r]`` are row
    r's logits for its first served token, ``step(tokens, positions,
    live)`` runs one decode step of every row (a served token and its
    position a row; rows not ``live`` idle) and returns each row's logits.
    The step computes each row as it computes it alone (its kernels' row
    results do not depend on the other rows: the card tests' batch
    invariance), so row r's walk is request r's batch-1 walk,
    teacher-forced on the served tokens; the rows share its launches.
    Returns :func:`check_request`'s (tokens equal, [(index, gap)]) a
    request."""
    logits = list(first_logits)
    equal = [0] * len(requests)
    ties = [[] for _ in requests]
    longest = max(len(request.tokens) for request in requests)
    for index in range(longest):
        for row, request in enumerate(requests):
            if index >= len(request.tokens):
                continue
            served, best = request.tokens[index], int(logits[row].argmax())
            if served == best:
                equal[row] += 1
                continue
            gap = float(logits[row][best] - logits[row][served])
            if gap > TIE_GAP:
                fail(f"request {request.request_id} (prompt "
                     f"{len(request.prompt)}): token {index} is {served}, "
                     f"oracle {best}, logit gap {gap:.4f} > {TIE_GAP}")
            ties[row].append((index, round(gap, 4)))
        live = [index + 1 < len(request.tokens) for request in requests]
        if not any(live):
            break
        tokens = [request.tokens[index] if on else 0
                  for request, on in zip(requests, live)]
        positions = [len(request.prompt) + index
                     for request in requests]
        out = step(tokens, positions, live)
        logits = [out[row] for row in range(len(requests))]
    return list(zip(equal, ties))


def check_in_slots(torch, requests, slots, oracle):
    """:func:`check_requests` side by side over groups of ``requests``
    whose served ``slots`` (request id -> slot) differ, in serving order
    (a slot a finished request left is reused by a later one, which then
    walks in a later group); ``oracle(group, group_slots)`` -> (first
    logits, step).  Sums the groups' counts."""
    groups = []
    for request in requests:
        slot = slots[request.request_id]
        group = next((g for g in groups
                      if all(slots[r.request_id] != slot for r in g)), None)
        if group is None:
            groups.append([request])
        else:
            group.append(request)
    totals = [0, 0, 0, []]
    for group in groups:
        result = check_requests(
            torch, group, lambda todo: oracle(
                todo, [slots[r.request_id] for r in todo]),
            side_by_side=True)
        for index, value in enumerate(result):
            totals[index] += value
    return tuple(totals)


def lockstep_contiguous(torch, llama, params, config, requests, device,
                        rows, slots=None, bucket=None, verify=False,
                        quantize_kv=False):
    """(first logits, step) of :func:`lockstep_results` on a contiguous
    cache of ``rows`` rows a slot.  Each request is prefilled alone at
    batch 1 (its prompt, or with ``bucket(len)`` its prompt right-padded
    to its bucket, as the contiguous server prefills it) and landed in
    row r of a cache of one row a request, or with ``slots`` in row
    ``slots[r]`` of a SLOTS-row cache (the server's shape); a step decodes
    every row at its own position, or with ``verify`` scores a verify
    window of SPEC_K + 1 tokens a row (the row's token then zeros) at its
    first position.  Idle rows write the scratch row ``rows - 1``.
    ``quantize_kv``: the caches hold int8 K/V, as :func:`contiguous_oracle`'s
    do with it."""
    batch = SLOTS if slots is not None else len(requests)
    slots = list(slots) if slots is not None else list(range(len(requests)))
    cache = llama.init_cache(config, batch, rows, quantize_kv=quantize_kv,
                             device=device)
    first = []
    for request, slot in zip(requests, slots):
        plen = len(request.prompt)
        width = bucket(plen) if bucket is not None else plen
        tokens = torch.zeros((1, width), dtype=torch.int32, device=device)
        tokens[0, :plen] = torch.as_tensor(request.prompt, device=device)
        filled = llama.init_cache(config, 1, rows if bucket is None
                                  else width, quantize_kv=quantize_kv,
                                  device=device)
        logits, filled = llama.prefill(params, tokens, filled, config)
        for layer, source in zip(cache, filled):
            for key, dst in layer.items():
                dst[slot, :source[key].shape[1]] = source[key][0]
        first.append(logits[0, -1])
    index = torch.as_tensor(slots, device=device)

    def rows_of(values, fill):
        out = torch.full((batch,), fill, dtype=torch.int32, device=device)
        out[index] = torch.as_tensor(values, dtype=torch.int32,
                                     device=device)
        return out

    def step(tokens, positions, live):
        nonlocal cache
        positions = [p if on else rows - 1 for p, on in zip(positions, live)]
        with torch.no_grad():
            if verify:
                window = torch.zeros((batch, SPEC_K + 1), dtype=torch.int32,
                                     device=device)
                window[:, 0] = rows_of(tokens, 0)
                active = torch.zeros((batch,), dtype=torch.bool,
                                     device=device)
                active[index] = torch.as_tensor(live, device=device)
                logits, cache = llama.verify_chunk_ragged(
                    params, window, cache, rows_of(positions, 0), active,
                    config)
                return logits[index, 0]
            logits, cache = llama._decode_core_ragged(
                params, rows_of(tokens, 0)[:, None], cache,
                rows_of(positions, rows - 1), config)
        return logits[index, -1]
    if bucket is not None:
        # The server seeds a slot with the last prompt token at prompt_len
        # - 1 and its first decode step (or verify round) emits the first
        # token: the prefill's own logits are not what it served.
        first = list(step([int(r.prompt[-1]) for r in requests],
                          [len(r.prompt) - 1 for r in requests],
                          [True] * len(requests)))
    return first, step


def lockstep_paged(torch, llama, server_cls, request_cls, params, config,
                   requests, slots, device):
    """(first logits, step) of :func:`lockstep_results` for (b): an 8-slot
    paged server of the served configuration admits the requests one at a
    time in serving order, each alone, on the served slice schedule (the
    prefix cache on, so a sharer finds the producer's prefix as it did
    when served), with no decode in between; then decode steps of SLOTS
    rows with each request's table in its served slot and the other
    lanes on scratch block 0, as the server's idle lanes."""
    oracle = server_cls(config_name=MOE_NAME, slots=SLOTS,
                        max_seq=MOE_PAGED_MAX_SEQ, chunk_steps=CHUNK_STEPS,
                        params=params, quantize=True, block_size=BLOCK,
                        enable_prefix_cache=True,
                        chunk_prefill_tokens=CHUNK, device=device)
    tables = torch.zeros((SLOTS, oracle.tables.shape[1]), dtype=torch.int32,
                         device=device)
    for request, slot in zip(requests, slots):
        twin = request_cls(request.request_id, request.prompt, NEW_TOKENS)
        oracle.submit(twin)
        oracle._admit()
        while oracle._prefilling:
            oracle._advance_prefills()
        own = oracle._requests.index(twin)
        # The oracle server never decodes: a live slot would hold the next
        # admission's slices for the mixed dispatch.
        oracle.active[own] = False
        tables[slot] = torch.as_tensor(oracle.tables[own], device=device)
    index = torch.as_tensor(list(slots), device=device)
    idle = torch.arange(SLOTS, dtype=torch.int32, device=device) % BLOCK

    def step(tokens, positions, live):
        batch_tokens = torch.zeros((SLOTS, 1), dtype=torch.int32,
                                   device=device)
        batch_tokens[index, 0] = torch.as_tensor(tokens, dtype=torch.int32,
                                                 device=device)
        batch_positions = idle.clone()
        batch_positions[index] = torch.as_tensor(positions,
                                                 dtype=torch.int32,
                                                 device=device)
        lanes = torch.zeros_like(tables)
        lanes[index] = tables[index]
        dead = index[~torch.as_tensor(live, device=device)]
        lanes[dead] = 0
        batch_positions[dead] = idle[dead]
        with torch.no_grad():
            logits, _ = llama._decode_core_paged(
                params, batch_tokens, oracle.pool, lanes, batch_positions,
                config)
        return logits[index, -1]
    first = step([int(r.prompt[-1]) for r in requests],
                 [len(r.prompt) - 1 for r in requests],
                 [True] * len(requests))
    return list(first), step


def hold_launches(where, launches, want):
    for name, expected in want.items():
        if launches[name] != expected or expected == 0:
            fail(f"{where}: {name} {launches[name]} launches, expected "
                 f"{expected}")
    for name, count in launches.items():
        if name not in want and count:
            fail(f"{where}: {name} launched {count} times")


def serve_moe_contiguous(torch, np, llama, weights, kernels, server_cls,
                         request_cls, params, config, device, count,
                         where, steady=False, draft=None):
    """(a), (c), (d): ContinuousBatchingServer of MOE_NAME, 8 slots,
    1,024-row cache, int8 (or int4) attention and LM head, bf16 experts:
    the first ``count`` of MOE_PROMPTS in waves of four, NEW_TOKENS each,
    every token held to its batch-1 oracle at the served shapes
    (:func:`lockstep_contiguous`), the launches to the decode steps and
    prefill
    dispatches (with ``draft``, spec_k = 4: chunk_attention and
    append_kv_ragged to the rounds); with ``steady``, the steady window."""
    kwargs = dict(config_name=MOE_NAME, slots=SLOTS, max_seq=MAX_SEQ,
                  chunk_steps=CHUNK_STEPS, params=params, quantize=True,
                  device=device)
    if draft is not None:
        kwargs.update(draft_config_name=MOE_DRAFT, draft_params=draft,
                      spec_k=SPEC_K)
    rng = np.random.default_rng(14)
    warm = server_cls(**kwargs)
    warm.submit(request_cls("warm", rng.integers(
        1, config.vocab_size, 100).astype(np.int32), 4))
    warm.run_until_drained()
    del warm
    server = server_cls(**kwargs)
    slots = record_slots(server)
    rng = np.random.default_rng(15)
    requests = [request_cls(f"m{i}", rng.integers(
        1, config.vocab_size, plen).astype(np.int32), NEW_TOKENS)
        for i, plen in enumerate(MOE_PROMPTS[:count])]
    dispatches, prefill = [], llama.prefill

    def recorded_prefill(params, tokens, cache, config, **kw):
        dispatches.append(tuple(tokens.shape))
        return prefill(params, tokens, cache, config, **kw)
    torch.cuda.synchronize()
    llama.prefill = recorded_prefill
    try:
        for kernel in kernels:
            kernel.launches = 0
        began = time.monotonic()
        for index in range(0, len(requests), 4):
            for request in requests[index:index + 4]:
                server.submit(request)
            for _ in range(3):
                server.step()
        server.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - began
        launches = {kernel.__name__: kernel.launches for kernel in kernels}
    finally:
        llama.prefill = prefill
    stats = server.stats()
    for request in requests:
        if request.error is not None or len(request.tokens) != NEW_TOKENS:
            fail(f"{where} request {request.request_id}: error "
                 f"{request.error}, {len(request.tokens)} tokens")
    steps = stats["decode_steps"]
    if draft is None:
        if len(dispatches) != stats["prefill_dispatches"]:
            fail(f"{where}: {len(dispatches)} prefill calls recorded, the "
                 f"server counted {stats['prefill_dispatches']}")
        hold_launches(where, launches, moe_launches_want(
            weights, config, steps, dispatches))
    else:
        rounds = stats["spec_rounds"]
        want = config.n_layers * rounds \
            + llama.CONFIGS[MOE_DRAFT].n_layers * rounds
        if rounds <= 0:
            fail(f"{where}: no speculation round")
        for name in ("chunk_attention", "append_kv_ragged"):
            if launches[name] != want:
                fail(f"{where}: {name} {launches[name]} launches, expected "
                     f"{want} ({rounds} rounds)")
        for name in ("int8_matmul", "flash_attention",
                     "paged_decode_attention", "write_kv_rows"):
            if not launches[name]:
                fail(f"{where}: {name} was never launched")
    from aiko_services_tpu_torch.orchestration import continuous
    exact, equal, checked, ties = check_in_slots(
        torch, requests, slots, lambda group, group_slots:
        lockstep_contiguous(
            torch, llama, params, config, group, device, MAX_SEQ,
            slots=group_slots,
            bucket=lambda n: min(continuous._bucket(n, 16), MAX_SEQ),
            verify=draft is not None))
    ttfts = sorted((r.first_token_ts - r.submitted_ts) * 1e3
                   for r in requests)
    result = dict(weights=weights.label, requests=len(requests),
                  requests_exact=exact, tokens_checked=checked,
                  tokens_equal=equal, accepted_near_ties=ties,
                  launches=launches, decode_steps=steps,
                  prefill_dispatches=dispatches, wall_s=wall,
                  served_tok_s=len(requests) * NEW_TOKENS / wall,
                  ttft_ms_p50=ttfts[len(ttfts) // 2], ttft_ms_max=ttfts[-1])
    if draft is not None:
        result.update({key: stats[key] for key in (
            "spec_rounds", "spec_proposed", "spec_accepted",
            "spec_tokens_per_target_pass")})
    else:
        result.update(graph_counts(stats, where))
    if steady:
        result.update(steady_decode(
            torch, np, weights, lambda: server_cls(**kwargs), request_cls,
            False, config))
    return result


def serve_moe_paged(torch, np, llama, weights, kernels, server_cls,
                    request_cls, params, config, device):
    """(b): PagedContinuousServer of MOE_NAME, 8 slots, 16-row blocks,
    prefix cache, 256-token chunked admission; four requests share a
    512-token prefix.  Mixed steps route a slice's tokens and the decode
    tokens in their own calls; every token held to its batch-1 oracle at
    the served shapes (:func:`lockstep_paged`), launches by phase 4's
    formula, prefix hits > 0, the pool balanced."""
    kwargs = dict(config_name=MOE_NAME, slots=SLOTS,
                  max_seq=MOE_PAGED_MAX_SEQ, chunk_steps=CHUNK_STEPS,
                  params=params, quantize=True, block_size=BLOCK,
                  enable_prefix_cache=True, chunk_prefill_tokens=CHUNK,
                  device=device)
    rng = np.random.default_rng(16)
    vocab = config.vocab_size
    prefix = rng.integers(1, vocab, MOE_PREFIX).astype(np.int32)
    shared = [np.concatenate([prefix, rng.integers(1, vocab, tail).astype(
        np.int32)]) for tail in MOE_TAILS]
    distinct = [rng.integers(1, vocab, n).astype(np.int32)
                for n in MOE_DISTINCT]
    waves = [[shared[0]] + distinct[:3], shared[1:] + distinct[3:]]
    server = server_cls(**kwargs)
    slots = record_slots(server)
    widths, core = [], llama._prefill_append_core

    def recorded_core(params, tokens, *args, **kw):
        widths.append(int(tokens.shape[1]))
        return core(params, tokens, *args, **kw)
    requests = []
    torch.cuda.synchronize()
    llama._prefill_append_core = recorded_core
    try:
        for kernel in kernels:
            kernel.launches = 0
        began = time.monotonic()
        for index, wave in enumerate(waves):
            batch = [request_cls(f"q{len(requests) + i}", prompt, NEW_TOKENS)
                     for i, prompt in enumerate(wave)]
            requests += batch
            for request in batch:
                server.submit(request)
            if index == 0:
                while batch[0].first_token_ts is None:
                    server.step()
        server.run_until_drained()
        torch.cuda.synchronize()
        wall = time.monotonic() - began
        launches = {kernel.__name__: kernel.launches for kernel in kernels}
    finally:
        llama._prefill_append_core = core
    stats = server.stats()
    where = "phase 14 (b) paged"
    for request in requests:
        if request.error is not None or len(request.tokens) != NEW_TOKENS:
            fail(f"{where} request {request.request_id}: error "
                 f"{request.error}, {len(request.tokens)} tokens")
    if len(widths) != stats["prefill_dispatches"]:
        fail(f"{where}: {len(widths)} slices recorded, the server counted "
             f"{stats['prefill_dispatches']}")
    hold_launches(where, launches, moe_launches_want(
        weights, config, stats["decode_steps"], widths=widths,
        contiguous=False))
    if stats["prefix_hits"] <= 0:
        fail(f"{where}: no prefix hit ({stats['prefix_misses']} misses)")
    if not stats["prefill_slices_mixed"]:
        fail(f"{where}: no mixed step")
    balance = server.pool_balance()
    if balance["free"] + balance["evictable"] + balance["producing"] \
            != balance["total"] or balance["producing"]:
        fail(f"{where}: pool out of balance after the drain: {balance}")
    exact, equal, checked, ties = check_in_slots(
        torch, requests, slots, lambda group, group_slots: lockstep_paged(
            torch, llama, server_cls, request_cls, params, config, group,
            group_slots, device))
    ttfts = sorted((r.first_token_ts - r.submitted_ts) * 1e3
                   for r in requests)
    return dict(requests=len(requests), requests_exact=exact,
                tokens_checked=checked, tokens_equal=equal,
                accepted_near_ties=ties, launches=launches,
                decode_steps=stats["decode_steps"],
                prefill_slices=len(widths), slice_widths=widths,
                slices_mixed=stats["prefill_slices_mixed"],
                prefix_hits=stats["prefix_hits"],
                prefix_blocks_reused=stats["prefix_blocks_reused"],
                pool_balance=balance, wall_s=wall,
                served_tok_s=len(requests) * NEW_TOKENS / wall,
                ttft_ms_p50=ttfts[len(ttfts) // 2], ttft_ms_max=ttfts[-1],
                **graph_counts(stats, where))


def serve_moe_phase(torch, np, llama, quant, kernels, kernels4, server_cls,
                    paged_cls, request_cls, device, parts=MOE_PARTS):
    """Phase 14: random mixtral_8x7b weights (MOE_LAYERS layers) from seed
    0 through ``init_params`` + ``quantize_params`` (int8 and int4 trees
    on the same bf16 expert tensors), the router check, then ``parts``.
    Returns each part's result, the weights' bytes, the step's bound and
    the phase's peak device memory."""
    from aiko_services_tpu_torch.models import moe
    config = moe_config(llama)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    dense = llama.init_params(config, seed=0, device=device)
    params8 = llama.quantize_params(dense)
    params4 = llama.quantize_params(dense, bits=4)
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    if params4["layers"][0]["moe"]["w_gate"] is not \
            params8["layers"][0]["moe"]["w_gate"]:
        fail("phase 14: the int8 and int4 trees do not share the experts")
    phase = dict(config=MOE_NAME, layers=MOE_LAYERS,
                 weights_s=time.monotonic() - t0,
                 step_bytes=streamed_bytes(torch, params8),
                 step_bytes_int4=streamed_bytes(torch, params4))
    phase["step_bound_ms"] = phase["step_bytes"] / HBM_BYTES_PER_S * 1e3
    phase["router"], phase["router_worst_rel"] = check_moe_router(
        torch, moe, quant, params8, params4, device)
    w8, w4 = Weights(quant, 8), Weights(quant, 4)
    part_s = {}
    if "contiguous" in parts:
        t0 = time.monotonic()
        phase["contiguous"] = serve_moe_contiguous(
            torch, np, llama, w8, kernels, server_cls, request_cls, params8,
            config, device, len(MOE_PROMPTS), "phase 14 (a) contiguous",
            steady=True)
        part_s["contiguous"] = time.monotonic() - t0
    if "paged" in parts:
        t0 = time.monotonic()
        phase["paged"] = serve_moe_paged(
            torch, np, llama, w8, kernels, paged_cls, request_cls, params8,
            config, device)
        part_s["paged"] = time.monotonic() - t0
    if "spec" in parts:
        t0 = time.monotonic()
        draft = llama.random_quantized_params(llama.CONFIGS[MOE_DRAFT],
                                              seed=1, device=device)
        phase["spec"] = serve_moe_contiguous(
            torch, np, llama, w8, kernels, server_cls, request_cls, params8,
            config, device, MOE_SHORT, "phase 14 (c) spec",
            draft=draft)
        del draft
        part_s["spec"] = time.monotonic() - t0
    if "int4" in parts:
        t0 = time.monotonic()
        phase["int4"] = serve_moe_contiguous(
            torch, np, llama, w4, kernels4, server_cls, request_cls, params4,
            config, device, MOE_SHORT, "phase 14 (d) int4")
        part_s["int4"] = time.monotonic() - t0
    phase["part_s"] = part_s
    phase["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if not phase["peak_gb"] < 80:
        fail(f"phase 14: peak device memory {phase['peak_gb']:.2f} GB")
    del params8, params4
    llama.CONFIGS.pop(MOE_NAME, None)
    gc.collect()
    torch.cuda.empty_cache()
    return phase


def print_moe_phase(phase, smi):
    log(f"--- phase 14, {phase['config']} ({phase['layers']} of 32 layers, "
        f"full width), random int8 / int4 weights from seed 0 in "
        f"{phase['weights_s']:.1f} s: " + json.dumps(phase))
    log(f"phase 14 router: f32 products on the card against the CPU's, "
        f"worst {phase['router_worst_rel']:.3g} of the largest logit; top-2 "
        f"experts equal in {sum(r['top2_equal'] for r in phase['router'])} "
        f"of {len(phase['router'])} cases; {smi}")
    for part, label in (("contiguous", "(a) contiguous int8"),
                        ("paged", "(b) paged int8"),
                        ("spec", "(c) speculation, small draft"),
                        ("int4", "(d) contiguous int4")):
        run = phase.get(part)
        if run is None:
            continue
        log(f"phase 14 {label}: {run['tokens_equal']} of "
            f"{run['tokens_checked']} tokens the oracle's argmax, near-ties "
            f"{run['accepted_near_ties']}; {run['served_tok_s']:.1f} tok/s "
            f"served, TTFT p50 {run['ttft_ms_p50']:.1f} ms, max "
            f"{run['ttft_ms_max']:.1f} ms; {phase['part_s'][part]:.1f} s; "
            f"{smi}")
    run = phase.get("contiguous")
    if run and "steady_step_ms" in run:
        log(f"phase 14 steady 8-slot step: graphed {run['steady_step_ms']:.3f}"
            f" ms ({run['steady_decode_tok_s']:.1f} tok/s, busy by events "
            f"{run['graphed_busy_by_events']:.3f}), eager "
            f"{run['eager_step_ms']:.3f} ms; captures after the fence "
            f"{run['graph_captures_steady_state']}; bound "
            f"{phase['step_bound_ms']:.3f} ms ({phase['step_bytes'] / 1e9:.2f}"
            f" GB of weights a step at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
            f"{smi}")
    run = phase.get("paged")
    if run:
        log(f"phase 14 (b): {run['prefill_slices']} slices "
            f"({run['slices_mixed']} mixed), prefix hits "
            f"{run['prefix_hits']}, blocks reused "
            f"{run['prefix_blocks_reused']}, pool {run['pool_balance']}")
    log(f"phase 14 peak device memory {phase['peak_gb']:.2f} GB; {smi}")


# --------------------------------------------------------------------------- #
# Phase 15: the pipeline engine and its compute plane

#: examples/vision_llm/pipeline_vision_llm.json's graph and element names,
#: at full width: clip_base and yolo_n fused into one graphed stage, the
#: prompt builder, llama3_8b int8 chat.
VISION_GRAPH = ("(ImageNormalize (VisionEncoderElement PromptBuilder) "
                "(DetectorElement PromptBuilder) "
                "(PromptBuilder LlamaChatElement))")
VISION_STAGE = "ImageNormalize+VisionEncoderElement+DetectorElement"
VISION_STAGE_KEYS = ("image", "embedding", "patch_features", "boxes",
                     "scores", "classes", "keep")
VISION_FRAMES, VISION_IMAGE, VISION_NEW_TOKENS = 8, 224, 32
VISION_VISUAL_TOKENS, VISION_METRICS_INTERVAL = 8, 2


def vision_llm_definition(vocab_size: int) -> dict:
    """The example's definition with the port's module paths (the prompt
    builder is this script's) and llama3_8b's vocabulary."""
    ml = "aiko_services_tpu_torch.elements"

    def spec(name, inputs, outputs, parameters=None, module=ml):
        return {"name": name,
                "input": [{"name": n, "type": "array"} for n in inputs],
                "output": [{"name": n, "type": t} for n, t in outputs],
                "parameters": parameters or {},
                "deploy": {"local": {"module": module, "class_name": name}}}

    arrays = [("boxes", "array"), ("scores", "array"), ("classes", "array"),
              ("keep", "array")]
    return {
        "version": 0, "name": "p_vision_llm", "runtime": "tpu",
        "graph": [VISION_GRAPH],
        "parameters": {"device_metrics_interval": VISION_METRICS_INTERVAL},
        "elements": [
            spec("ImageNormalize", ["image"], [("image", "array")]),
            spec("VisionEncoderElement", ["image"],
                 [("embedding", "array"), ("patch_features", "array")],
                 {"model_config": "clip_base"}),
            spec("DetectorElement", ["image"], arrays,
                 {"model_config": "yolo_n"}),
            spec("PromptBuilder", ["embedding", "scores", "classes"],
                 [("tokens", "array")],
                 {"vocab_size": vocab_size,
                  "n_visual_tokens": VISION_VISUAL_TOKENS},
                 module=__name__),
            spec("LlamaChatElement", ["tokens"],
                 [("tokens_out", "array"), ("tokens_per_second", "float")],
                 {"model_config": "llama3_8b", "param_init": "random_int8",
                  "max_new_tokens": VISION_NEW_TOKENS}),
        ]}


def install_prompt_builder(np, PipelineElement, StreamEvent, host_array):
    """Set ``PromptBuilder`` on this module, where the definition deploys
    it from: examples/vision_llm/elements_vision_llm.py's element on the
    port (the swag's tensors read back through ``host_array``).  Made here
    because the port is imported only once a card is found."""

    class PromptBuilder(PipelineElement):
        """The embedding vector-quantized into ``n_visual_tokens`` ids,
        then the four best-scoring detection classes."""

        def process_frame(self, stream, embedding, scores, classes):
            vocab, _ = self.get_parameter("vocab_size", 1024, stream=stream)
            n_visual, _ = self.get_parameter("n_visual_tokens", 8,
                                             stream=stream)
            vocab, n_visual = int(vocab), int(n_visual)
            embedding = host_array(embedding).astype(np.float32)
            if embedding.ndim > 1 and embedding.shape[0] != 1:
                self.logger.error("%s: PromptBuilder is batch-1 (got %s)",
                                  self.my_id(stream), embedding.shape)
                return StreamEvent.ERROR, {}
            embedding = embedding.reshape(-1)
            lo, hi = embedding.min(), embedding.max()
            span = max(float(hi - lo), 1e-6)
            visual = ((embedding[:n_visual] - lo) / span
                      * (vocab - 2)).astype(np.int32) + 1
            classes = host_array(classes).astype(np.int32).reshape(-1)
            scores = host_array(scores).astype(np.float32).reshape(-1)
            top = classes[np.argsort(-scores)[:4]] % (vocab - 1) + 1
            tokens = np.concatenate([visual, top]).astype(np.int32)[None, :]
            return StreamEvent.OKAY, {"tokens": tokens}

    setattr(sys.modules[__name__], "PromptBuilder", PromptBuilder)


def serve_vision_llm(torch, np, llama, quant, kernels, device):
    """Phase 15: examples/vision_llm's graph through the port's Pipeline
    (``compose_instance(Pipeline, pipeline_args(...))``, what the CLI
    wraps), no device given: every element takes the card.  One warm-up
    frame on its own stream (the stage's capture, cuBLAS / cuDNN set-up),
    then VISION_FRAMES seeded 224 x 224 images on one stream.  Holds: the
    three device elements fused into one stage that captured once and
    replayed every frame; each frame's stage outputs bitwise equal to the
    same elements run eagerly on the card; each frame's ``tokens_out``
    equal to a direct prefill + generate_tokens greedy oracle on the chat
    element's params and the frame's prompt; the launches of
    ``kernels`` (flash_attention, paged_decode_attention, int8_matmul,
    write_kv_rows) over the 8 frames exactly the prefills' and decode
    steps'; one DevicePrefetcher pass over the images handing back equal
    tensors on the card."""
    from aiko_services_tpu_torch import transport
    from aiko_services_tpu_torch.ops.paged_attention import contiguous_rows
    from aiko_services_tpu_torch.pipeline import (
        DevicePrefetcher, Pipeline, PipelineElement, StreamEvent,
        parse_pipeline_definition)
    from aiko_services_tpu_torch.pipeline.codec import host_array
    from aiko_services_tpu_torch.pipeline.tpu_stage import to_tensor
    from aiko_services_tpu_torch.runtime import (
        EventEngine, Process, VirtualClock, compose_instance, pipeline_args)

    install_prompt_builder(np, PipelineElement, StreamEvent, host_array)
    config = llama.CONFIGS["llama3_8b"]
    rng = np.random.default_rng(15)
    shape = (1, VISION_IMAGE, VISION_IMAGE, 3)
    warm_image = rng.integers(0, 256, shape, dtype=np.uint8)
    images = [rng.integers(0, 256, shape, dtype=np.uint8)
              for _ in range(VISION_FRAMES)]
    phase = {}

    # The prefetcher: pinned staging, side-stream copies, ordered use.
    with DevicePrefetcher(iter(images), depth=2) as prefetcher:
        staged = list(prefetcher)
    if prefetcher.copy_stream is None or len(staged) != len(images):
        fail(f"phase 15 prefetcher: {len(staged)} batches, copy stream "
             f"{prefetcher.copy_stream}")
    for host, got in zip(images, staged):
        if got.device != device or not torch.equal(
                got.cpu(), torch.from_numpy(host)):
            fail("phase 15 prefetcher: a staged batch differs from its "
                 "host array")
    phase["prefetched"] = len(staged)
    del staged

    t0 = time.monotonic()
    engine = EventEngine(clock=VirtualClock())
    process = Process(namespace="smoke", hostname="card", pid="15",
                      engine=engine, broker="vision_llm")
    definition = parse_pipeline_definition(
        vision_llm_definition(config.vocab_size))
    pipeline = compose_instance(
        Pipeline, pipeline_args(definition.name, definition=definition),
        process=process)
    torch.cuda.synchronize()
    phase["build_s"] = time.monotonic() - t0
    stages = list(pipeline._fused_stages.values())
    if [stage.name for stage in stages] != [VISION_STAGE] or \
            stages[0].device.type != "cuda":
        fail(f"phase 15: fused stages {[s.name for s in stages]} on "
             f"{[str(s.device) for s in stages]}")
    stage = stages[0]
    chat = pipeline.elements["LlamaChatElement"]
    if chat.device.type != "cuda" or \
            not quant.is_quantized(chat.params["layers"][0]["wq"]):
        fail("phase 15: the chat element's int8 weights are not on the card")

    out = queue.Queue()

    def drive(stream_id, frames):
        pipeline.create_stream(stream_id, queue_response=out)
        for image in frames:
            pipeline.post_frame(stream_id, {"image": image})
        engine.drain()
        torch.cuda.synchronize()
        if out.qsize() != len(frames):
            fail(f"phase 15 stream {stream_id}: {out.qsize()} of "
                 f"{len(frames)} frames completed")
        done = [out.get_nowait()[1] for _ in frames]
        pipeline.destroy_stream(stream_id)
        return done

    t0 = time.monotonic()
    warm = drive("warm", [warm_image])[0]
    phase["warm_frame_s"] = time.monotonic() - t0
    for kernel in kernels:
        kernel.launches = 0
    began = time.monotonic()
    frames = drive("s", images)
    wall = time.monotonic() - began
    launches = {kernel.__name__: kernel.launches for kernel in kernels}
    phase.update(frames=len(frames), wall_s=wall,
                 frames_per_s=len(frames) / wall,
                 captures=stage._compiled.captures,
                 replays=stage._compiled.replays)
    if stage._compiled.captures != 1 or \
            stage._compiled.replays != len(frames) + 1:
        fail(f"phase 15: the stage captured {stage._compiled.captures} "
             f"times and replayed {stage._compiled.replays} (want 1 and "
             f"{len(frames) + 1})")

    # Held: the stage's replays against the same elements run eagerly.
    for index, (image, frame) in enumerate(zip(images, frames)):
        with torch.no_grad():
            want = stage._trace(stage._params,
                                {"image": to_tensor(image, device)})
        for key in VISION_STAGE_KEYS:
            got = frame.swag[key]
            if got.dtype != want[key].dtype or not torch.equal(got,
                                                               want[key]):
                fail(f"phase 15 frame {index}: the graphed stage's {key} "
                     "is not bitwise the eager elements'")
        embedding = frame.swag["embedding"]
        if tuple(embedding.shape) != (1, 512) or \
                not bool(torch.isfinite(embedding).all()) or \
                tuple(frame.swag["boxes"].shape) != (1, 49, 4):
            fail(f"phase 15 frame {index}: embedding "
                 f"{tuple(embedding.shape)}, boxes "
                 f"{tuple(frame.swag['boxes'].shape)}")

    # Held: tokens_out against a direct greedy oracle, and the launches.
    prompt_lens = set()
    for index, frame in enumerate(frames):
        tokens = torch.as_tensor(frame.swag["tokens"], device=device)
        prompt_len = tokens.shape[1]
        prompt_lens.add(prompt_len)
        cache = llama.init_cache(config, 1, contiguous_rows(
            prompt_len + VISION_NEW_TOKENS), device=device)
        logits, cache = llama.prefill(chat.params, tokens, cache, config)
        first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        generated, _ = llama.generate_tokens(
            chat.params, first, cache, prompt_len, VISION_NEW_TOKENS - 1,
            config)
        want = torch.cat([tokens, first, generated], dim=1)
        got = frame.swag["tokens_out"]
        if tuple(got.shape) != tuple(want.shape) or \
                not torch.equal(got, want):
            fail(f"phase 15 frame {index}: tokens_out is not the greedy "
                 "oracle's")
    if prompt_lens != {VISION_VISUAL_TOKENS + 4}:
        fail(f"phase 15: prompt lengths {prompt_lens}")
    weights = Weights(quant, 8)
    steps = VISION_NEW_TOKENS - 1
    n = len(frames)
    want = dict(
        flash_attention=config.n_layers * n,
        paged_decode_attention=config.n_layers * steps * n,
        write_kv_rows=config.n_layers * steps * n,
        int8_matmul=n * (matmul_launches(weights, config, 1,
                                         VISION_VISUAL_TOKENS + 4)
                         + steps * matmul_launches(weights, config, 1, 1)))
    for name, expected in want.items():
        if launches[name] != expected or expected == 0:
            fail(f"phase 15 {name}: {launches[name]} launches, expected "
                 f"{expected}")
    phase["launches"] = launches

    metrics = {}
    for key in frames[0].metrics:
        values = [f.metrics[key] for f in frames if key in f.metrics]
        metrics[key] = dict(mean_ms=1e3 * sum(values) / len(values),
                            frames=len(values))
    phase["metrics"] = metrics
    phase["warm_metrics_ms"] = {k: 1e3 * v for k, v in warm.metrics.items()}
    rates = [float(f.swag["tokens_per_second"]) for f in frames]
    phase["chat_tokens_per_s_mean"] = sum(rates) / len(rates)
    phase["chat_tokens_per_s_min"] = min(rates)
    pipeline.stop()
    transport.reset_brokers()
    del pipeline, chat, stage, stages, frames, warm
    gc.collect()
    torch.cuda.empty_cache()
    return phase


def print_vision_llm(phase, smi):
    log("--- phase 15, the vision-LLM pipeline (clip_base + yolo_n fused and "
        "graphed, llama3_8b int8 chat, 32 new tokens): " + json.dumps(phase))
    log(f"phase 15: {phase['frames']} frames in {phase['wall_s']:.3f} s, "
        f"{phase['frames_per_s']:.3f} frames/s (the warm-up frame, with the "
        f"stage's capture, {phase['warm_frame_s']:.3f} s); the pipeline "
        f"built in {phase['build_s']:.1f} s; {smi}")
    for key, value in sorted(phase["metrics"].items()):
        log(f"phase 15 {key}: {value['mean_ms']:.3f} ms mean over "
            f"{value['frames']} frames; {smi}")
    log(f"phase 15 chat tokens_per_second: mean "
        f"{phase['chat_tokens_per_s_mean']:.1f}, min "
        f"{phase['chat_tokens_per_s_min']:.1f} (batch 1, eager decode); "
        f"launches {phase['launches']}; stage captures {phase['captures']}, "
        f"replays {phase['replays']}; {smi}")


# --------------------------------------------------------------------------- #
# Phase 7: the ring collective matmuls

#: Ranks of the ring on the one card, and llama3_8b's TP-4 MLP shapes:
#: (kind, label, ranks, m, K, N, dtype name).  The first two are the main
#: path; the rest the JAX tests' shapes (tests/test_rdma_collective.py) on
#: eight ranks, f32 and bf16, with ragged n_local of 3, 5 and 2.
RING_RANKS = 4
RING_CASES = [
    ("ag", "w_gate", RING_RANKS, 2048, 4096, 14336, "bfloat16"),
    ("rs", "w_down", RING_RANKS, 2048, 14336, 4096, "bfloat16"),
    ("ag", "w_gate", RING_RANKS, 64, 4096, 14336, "bfloat16"),
    ("rs", "w_down", RING_RANKS, 64, 14336, 4096, "bfloat16"),
    ("ag", "jax f32", 8, 16, 32, 24, "float32"),
    ("rs", "jax f32", 8, 8, 64, 40, "float32"),
    ("ag", "jax bf16", 8, 16, 32, 16, "bfloat16"),
    ("rs", "jax bf16", 8, 8, 64, 40, "bfloat16"),
]
#: f32 ring outputs against the f32 plain version: summation order only.
RING_F32_TOL = 1e-4
#: The path csrc/ring_matmul.cu's matmul() must take for the steps of the
#: main path's calls (RING_CASES[:4]): TMA + wgmma tiles at m = 2048, the
#: streamed weight with its K split at m = 64.
RING_STEP_PATHS = ("wgmma", "wgmma", "stream", "stream")
#: A whole call's window sleeps ~0.2 s: ten R = 8 calls take ~50 ms of
#: host enqueue, which outlasts the default sleep.
RING_SLEEP_CYCLES = 400_000_000


def ring_operands(torch, device, m, k, n, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=device) * k ** -0.5) \
        .to(dtype)
    return x, w


def ring_compare(torch, got, want):
    """(max abs error, err/tol) of a ring output against the f32 plain
    version: TOL_REL / TOL_ROW for bf16, RING_F32_TOL x max(1, max |want|)
    for f32."""
    if got.dtype == torch.bfloat16:
        return compare(got, want)
    err = float((got.float() - want).abs().max())
    return err, err / (RING_F32_TOL * max(1.0, float(want.abs().max())))


def check_ring(torch, parallel, device):
    """The main path first, with the kernels' counts set to 0 just before
    and read just after: ``rdma_allgather_matmul_sharded`` and
    ``rdma_matmul_reducescatter_sharded`` once each at m = 2048 on
    ``[device] * 4``.  Then every case of RING_CASES: the ring against its
    plain version (the same schedule with ``torch.mm`` in f32) on f32
    copies of the operands, R^2 step launches and R(R - 1) copies a call,
    a second call bit-equal to the first; a slowed rank (rank 1 sleeps on
    its compute stream before its step-1 kernel) still right; and the
    whole call's time (per-rank entry points on pre-cut shards, CUDA
    events on the caller's stream, which every rank's streams join, ten
    calls behind a ~0.2 s sleep after a window that warms the allocator;
    the host's enqueue ms a call beside it; a window whose sleep ended
    before the enqueue did is not measured, and fails the smoke on a main
    path shape), the plain version's, the
    bound (the work of all ranks: each global operand read once, 2 m K N
    operations), for the all-gather the floor its schedule sets (every
    rank reads its w shard at each of its R steps), and one ``torch.mm``
    of the global operands as the library yardstick.  Then each step
    kernel of the main path alone (:func:`check_ring_steps`)."""
    rc, cm = parallel.rdma_collective, parallel.collective_matmul
    fns = {"ag": (rc.rdma_allgather_matmul_sharded, rc.rdma_allgather_matmul,
                  cm.allgather_matmul_sharded, cm.allgather_matmul, 0, 1),
           "rs": (rc.rdma_matmul_reducescatter_sharded,
                  rc.rdma_matmul_reducescatter,
                  cm.matmul_reducescatter_sharded, cm.matmul_reducescatter,
                  1, 0)}
    counted = {"ag": rc.rdma_allgather_matmul,
               "rs": rc.rdma_matmul_reducescatter}
    mesh = parallel.make_mesh([device] * RING_RANKS, tp=RING_RANKS)
    main_inputs = {kind: ring_operands(torch, device, m, k, n,
                                       getattr(torch, dtype), 100 + i)
                   for i, (kind, _, _, m, k, n, dtype)
                   in enumerate(RING_CASES[:2])}
    torch.cuda.synchronize()
    for wrapper in counted.values():
        wrapper.launches = wrapper.copies = 0
    main_out = {kind: fns[kind][0](*main_inputs[kind], mesh)
                for kind in ("ag", "rs")}
    torch.cuda.synchronize()
    launches = {kind: counted[kind].launches for kind in counted}
    copies = {kind: counted[kind].copies for kind in counted}
    for kind in counted:
        if launches[kind] != RING_RANKS ** 2 \
                or copies[kind] != RING_RANKS * (RING_RANKS - 1):
            fail(f"ring {kind}: {launches[kind]} step launches and "
                 f"{copies[kind]} copies in one call on {RING_RANKS} ranks")
    rows = []
    for index, (kind, label, ranks, m, k, n, dtype) in enumerate(RING_CASES):
        sharded, per_rank, plain_sharded, plain, x_dim, w_dim = fns[kind]
        wrapper = counted[kind]
        ring_mesh = parallel.make_mesh([device] * ranks, tp=ranks)
        if index < 2:
            x, w = main_inputs[kind]
        else:
            x, w = ring_operands(torch, device, m, k, n,
                                 getattr(torch, dtype), 100 + index)
        before = (wrapper.launches, wrapper.copies)
        got = sharded(x, w, ring_mesh)
        torch.cuda.synchronize()
        if (wrapper.launches - before[0], wrapper.copies - before[1]) \
                != (ranks ** 2, ranks * (ranks - 1)):
            fail(f"ring {kind} {label} m={m}: "
                 f"{wrapper.launches - before[0]} step launches, "
                 f"{wrapper.copies - before[1]} copies on {ranks} ranks")
        want = plain_sharded(x.float(), w.float(), ring_mesh)
        err, ratio = ring_compare(torch, got, want)
        if not ratio <= 1.0:
            fail(f"ring {kind} {label} m={m} K={k} N={n} {dtype} R={ranks}: "
                 f"max abs err {err}, err/tol {ratio}")
        if index < 2 and not torch.equal(got, main_out[kind]):
            fail(f"ring {kind} {label}: the main path's call and a second "
                 "call differ")
        if not torch.equal(sharded(x, w, ring_mesh), got):
            fail(f"ring {kind} {label} m={m}: two calls differ")
        devices = ring_mesh.ring("tp")
        xs = cm.shard(x, x_dim, devices)
        ws = cm.shard(w, w_dim, devices)
        # The first window sizes the caching allocator for ten calls in
        # flight (fresh blocks are slow host work); the second is timed.
        timing = {}
        for _ in range(2):
            ms = device_ms(torch, lambda: per_rank(xs, ws), 10,
                           RING_SLEEP_CYCLES, timing)
        if timing["host_bound"]:
            # The sleep ended before the host had enqueued the window: it
            # timed the host, not the card.
            if index < 4:
                fail(f"ring {kind} {label} m={m}: the timed window was "
                     f"host-bound ({timing['host_ms']:.3f} ms of enqueue a "
                     "call)")
            ms = float("nan")
        plain_ms = device_ms(torch, lambda: plain(xs, ws), 3)
        library_ms = device_ms(torch, lambda: torch.mm(x, w), 10)
        elem = x.element_size()
        b_ms, b_by = bound(elem * (m * k + k * n + m * n), 2 * m * k * n)
        row = dict(shape=f"{kind} {label} R={ranks} m={m} K={k} N={n} "
                         f"{dtype}", kind=kind, err=err, ratio=ratio, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms, **timing)
        if kind == "ag":
            # The schedule reads every rank's w shard at each of its R
            # steps: R^2 shard reads a call, whatever the step kernel.
            row["floor_ms"] = max(b_ms, ranks * k * n * elem
                                  / HBM_BYTES_PER_S * 1e3)
        rows.append(row)
    # A slowed rank: the copies must wait for it (the capacity events).
    for kind in ("ag", "rs"):
        x, w = ring_operands(torch, device, 256, 512, 512, torch.bfloat16, 7)

        def slow(rank, step):
            if (rank, step) == (1, 1):
                torch.cuda._sleep(100_000_000)
        got = fns[kind][0](x, w, mesh, before_step=slow)
        err, ratio = ring_compare(torch, got, fns[kind][2](
            x.float(), w.float(), mesh))
        if not ratio <= 1.0:
            fail(f"ring {kind} with a slowed rank: max abs err {err}, "
                 f"err/tol {ratio}")
        rows.append(dict(shape=f"{kind} slowed rank 1, R={RING_RANKS} m=256 "
                               "K=512 N=512 bfloat16", kind=kind, err=err,
                         ratio=ratio, ms=float("nan"), plain_ms=float("nan"),
                         bound_ms=float("nan"), bound_by="-",
                         library_ms=None))
    return rows + check_ring_steps(torch, rc, device), launches, copies


def print_ring_rows(rows, launches, copies):
    print_rows(f"ring collective matmuls ([cuda:0] * R; kernel_ms: one whole "
               f"call, all ranks' streams joined, or for a step row one step "
               f"kernel alone; library_ms: torch.mm of the global operands, "
               f"or of the step's); the main path's call: step launches "
               f"{launches}, copies {copies}", rows)


def check_ring_steps(torch, rc, device):
    """The step kernel alone at each step shape of the main path's calls
    (RING_CASES[:4] on one rank of RING_RANKS, at step index 1, whose
    rows or columns start past 0), on the caller's stream with a rank's
    share of the SMs, as the ring gives it: the path and K split
    ``matmul()`` takes (the kernel's answer, held to RING_STEP_PATHS), the
    output against the step's plain version (``torch.mm`` in f32;
    ``ring_compare``, so the reduce-scatter's f32 output is held to
    RING_F32_TOL), its time, bound and one ``torch.mm`` of the same step
    operands as the yardstick.  Apart from the whole call's, these rows
    leave out the protocol (events, copies, the reduce-scatter's adds)."""
    rows = []
    ctas = rc._ctas(device, RING_RANKS)
    for (kind, label, _, m, k, n, dtype), want_path in zip(RING_CASES,
                                                           RING_STEP_PATHS):
        gen = torch.Generator(device=device).manual_seed(m + k)
        dt = getattr(torch, dtype)
        if kind == "ag":
            m_step, k_step, cols = m // RING_RANKS, k, n // RING_RANKS
            target = torch.empty((m, cols), dtype=dt, device=device)
        else:
            m_step, k_step, cols = m, k // RING_RANKS, n
            target = torch.empty((m, n // RING_RANKS), dtype=torch.float32,
                                 device=device)
        a = torch.randn((m_step, k_step), generator=gen, device=device).to(dt)
        w = (torch.randn((k_step, cols), generator=gen, device=device)
             * k_step ** -0.5).to(dt)
        index = 1
        n_step = target.shape[1]
        if kind == "ag":
            out = target[index * m_step:(index + 1) * m_step]
            w_step = w
        else:
            out = target
            w_step = w[:, index * n_step:(index + 1) * n_step]
        path, splits, slice_rows = rc.step_plan(kind, a, w, target,
                                                index, ctas)
        if path != want_path:
            fail(f"ring {kind} {label} m={m}: the step took {path}; the "
                 f"main path needs {want_path}")
        scratch = rc.step_scratch(device, ctas)

        def kernel():
            rc.launch_step(kind, a, w, target, index, scratch)

        def plain():
            return torch.mm(a.float(), w_step.float())

        kernel()
        err, ratio = ring_compare(torch, out, plain())
        if not ratio <= 1.0:
            fail(f"ring {kind} {label} m={m} step: max abs err {err}, "
                 f"err/tol {ratio}")
        elem = a.element_size()
        b_ms, b_by = bound(elem * (m_step * k_step + k_step * n_step)
                           + target.element_size() * m_step * n_step,
                           2 * m_step * k_step * n_step)
        rows.append(dict(
            shape=f"{kind} {label} m={m} step on one stream: {m_step} x "
                  f"{k_step} x {n_step}" + (f" of a {cols}-wide w"
                                           if kind == "rs" else "")
                  + f", path {path}"
                  + (f", K split {splits} x {slice_rows}" if splits > 1
                     else ""),
            kind=kind, path=path, err=err, ratio=ratio,
            ms=device_ms(torch, kernel, 20),
            plain_ms=device_ms(torch, plain, 5), bound_ms=b_ms,
            bound_by=b_by,
            library_ms=device_ms(torch, lambda: torch.mm(a, w_step), 20)))
    return rows


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(root, "aiko_services_tpu_torch",
                                       "__init__.py")):
        fail("aiko_services_tpu_torch is not beside this script")
    sys.path.insert(0, root)
    import numpy as np

    from aiko_services_tpu_torch import parallel
    from aiko_services_tpu_torch.models import llama, speculative
    from aiko_services_tpu_torch.ops import (_cuda, attention,
                                             paged_attention, quant)
    from aiko_services_tpu_torch.ops import paged_prefill as pp
    from aiko_services_tpu_torch.orchestration.continuous import (
        ContinuousBatchingServer, DecodeRequest)
    from aiko_services_tpu_torch.orchestration.paged import (
        PagedContinuousServer)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    began = time.monotonic()

    # ---- phase 1: device and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    library = _cuda.build()
    _cuda.library()
    log(f"kernels built in {time.monotonic() - t0:.1f} s: {library.name}")
    for source, output in _cuda.BUILD_LOG.items():
        for line in output.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {source}: {line.strip()}")

    # ---- phase 2: kernels against their plain versions ----
    t0 = time.monotonic()
    config = llama.CONFIGS["llama3_8b"]
    int8_rows, int8_worst, int8_step = check_int8_matmul(torch, quant,
                                                         device, config)
    int4_rows, int4_worst, int4_steps = check_int4_matmul(torch, quant,
                                                          device, config)
    print_rows("int8_matmul", int8_rows)
    if int8_step["library_error"] is None:
        log("  torch._weight_int8pack_mm (bf16 scales) max abs err vs the "
            "f32 plain version: " + ", ".join(
                f"{r['shape']} {r['library_err']:.3g}" for r in int8_rows))
    else:
        log("  torch._weight_int8pack_mm on the card raised "
            f"{int8_step['library_error']!r}: library_ms is null")
    log(f"  one 8-slot decode step ({int8_step['launches']} launches), sum "
        f"of the isolated times: kernel {int8_step['ms']:.4f} ms, plain "
        f"{int8_step['plain_ms']:.4f} ms, bound {int8_step['bound_ms']:.4f}"
        f" ms, library {int8_step['library_ms']}")
    print_rows("int4_matmul (after: scale after each group, the path's; "
               "first: bf16(q * s) operands); library_ms "
               "torch._weight_int4pack_mm", int4_rows)
    log("  dequantize + torch.mm (the large-m route) ms: " + ", ".join(
        f"{r['shape']} {r['dequant_mm_ms']:.4f}" for r in int4_rows
        if r["numerics"] == "after"))
    if int4_steps["after"]["library_error"] is None:
        log("  torch._weight_int4pack_mm (bf16 scales) max abs err vs the "
            "f32 plain version: " + ", ".join(
                f"{r['shape']} {r['library_err']:.3g}" for r in int4_rows
                if r["numerics"] == "after"))
    else:
        log("  torch._weight_int4pack_mm on the card raised "
            f"{int4_steps['after']['library_error']!r}: library_ms is null")
    for key, step in int4_steps.items():
        what = (f"one layer at m = {TILED_ROWS[-1]}" if key == "tiled"
                else "one 8-slot decode step")
        log(f"  int4 ({key}) {what} ({step['launches']} "
            f"launches), sum of the isolated times: kernel {step['ms']:.4f}"
            f" ms, plain {step['plain_ms']:.4f} ms, bound "
            f"{step['bound_ms']:.4f} ms, library {step['library_ms']}, "
            f"dequantize + mm {step['dequant_mm_ms']:.4f} ms")
    log("  the int4 kernel lab's shapes at m = 64 (scale after; "
        "tools/int4_kernel_lab.py SHAPES): " + ", ".join(
            f"K={r['k']} N={r['n']} {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f}, library {fmt_ms(r['library_ms'])})"
            for r in int4_rows if r["numerics"] == "after" and r["m"] == 64
            and (r["k"], r["n"]) in INT4_LAB_SHAPES))
    flash_rows, flash_worst, flash_main = check_flash(torch, attention,
                                                      device)
    print_rows("flash_attention", flash_rows)
    decode_rows, decode_worst, decode_main = check_decode(
        torch, paged_attention, llama, device)
    print_rows("paged_decode_attention, the contiguous server's block size "
               "128", decode_rows)
    paged_decode_rows, paged_decode_worst = check_decode_paged(
        torch, paged_attention, llama, device)
    print_rows("paged_decode_attention, the paged server's block size 16",
               paged_decode_rows)
    append_rows, append_main = check_append(torch, pp, llama, device)
    print_rows("append_kv (pool bytes equal to the plain version's)",
               append_rows)
    chunk_rows, chunk_worst, chunk_main = check_chunk(torch, pp, llama,
                                                      device)
    print_rows("chunk_attention", chunk_rows)
    ragged_rows, ragged_main = check_append_ragged(torch, pp, llama, device)
    print_rows("append_kv_ragged (pool bytes equal to the plain version's, "
               "rows outside the windows untouched)", ragged_rows)
    write_rows, write_main = check_write_kv_rows(torch, pp, llama, device)
    print_rows("write_kv_rows, the decode step's K/V write (pool bytes "
               "equal to the plain version's outside scratch block 0)",
               write_rows)
    verify_rows, verify_worst, verify_main = check_chunk_verify(
        torch, pp, llama, device)
    print_rows("chunk_attention at the verify shape", verify_rows)
    log(f"phase 2 took {time.monotonic() - t0:.1f} s")

    # ---- phase 3: serving ----
    t0 = time.monotonic()
    params = llama.random_quantized_params(config, seed=0, device=device)
    torch.cuda.synchronize()
    log(f"llama3_8b int8 params on the card in "
        f"{time.monotonic() - t0:.1f} s")
    w8 = Weights(quant, 8)
    kernels = (quant.int8_matmul, attention.flash_attention,
               paged_attention.paged_decode_attention, pp.write_kv_rows)
    runs = []
    for quantize_kv in (False, True):
        run = serve(torch, np, llama, w8, kernels,
                    ContinuousBatchingServer, DecodeRequest, params,
                    quantize_kv, device)
        log(f"--- serving llama3_8b int8, {run['kv']} KV: "
            + json.dumps(run))
        runs.append(run)
    # The 64-slot run of phase 6 on int8 weights, for the comparison.
    wide8 = serve_wide(torch, np, llama, w8, kernels,
                       ContinuousBatchingServer, DecodeRequest, params,
                       device)
    log("--- serving llama3_8b int8 at 64 slots, bf16 KV: "
        + json.dumps(wide8))
    log(f"phase 3 took {time.monotonic() - t0:.1f} s")

    # ---- phase 4: the paged server ----
    t0 = time.monotonic()
    paged_kernels = kernels + (pp.append_kv, pp.chunk_attention)
    paged_runs = []
    for quantize_kv in (False, True):
        run = serve_paged(torch, np, llama, w8, paged_kernels,
                          PagedContinuousServer, DecodeRequest, params,
                          quantize_kv, device)
        log(f"--- serving llama3_8b int8 through the paged server, "
            f"{run['kv']} KV: " + json.dumps(run))
        paged_runs.append(run)
    paged_main = paged_runs[0]["launches"]
    paged_wide8 = steady_paged_wide(torch, np, llama, w8,
                                    PagedContinuousServer, DecodeRequest,
                                    params, device)
    log("--- steady decode, llama3_8b int8 through the paged server at 64 "
        "slots, bf16 KV: " + json.dumps(paged_wide8))
    log(f"phase 4 took {time.monotonic() - t0:.1f} s")

    # ---- phase 5: speculative decoding on the paged server ----
    spec_kernels = paged_kernels + (pp.append_kv_ragged,)
    t0 = time.monotonic()
    draft_1b = llama.random_quantized_params(llama.CONFIGS["1b"], seed=1,
                                             device=device)
    log(f"1b int8 draft params on the card in {time.monotonic() - t0:.1f} s")
    spec_runs = []
    for mode, quantize_kv in SPEC_RUNS:
        draft = {"paired": params, "adaptive": draft_1b}[mode]
        run = serve_spec(torch, np, llama, quant, w8, spec_kernels,
                         PagedContinuousServer, DecodeRequest, params,
                         quantize_kv, device, mode, draft,
                         paged_runs[0]["steady_step_ms"])
        log(f"--- speculative serving ({mode}), llama3_8b int8, "
            f"{run['kv']} KV: " + json.dumps(run))
        spec_runs.append(run)
    spec_main = spec_runs[0]["launches"]
    log(f"phase 5 took {time.monotonic() - t0:.1f} s")

    # ---- phase 12: the contiguous layout's residue and the standalone
    # loops (phase 4's weights, phase 5's draft) ----
    t0 = time.monotonic()
    contig = serve_contiguous_phase(
        torch, np, llama, speculative, kernels + (
            pp.append_kv, pp.chunk_attention, pp.append_kv_ragged),
        ContinuousBatchingServer, DecodeRequest, params, draft_1b, device)
    print_contiguous_phase(contig, smi)
    log(f"phase 12 took {time.monotonic() - t0:.1f} s; {smi}")

    # ---- phase 8: the wire (phase 4's weights, run before phase 6 frees
    # them) ----
    t0 = time.monotonic()
    wire = serve_wire(torch, np, llama, w8, paged_kernels,
                      PagedContinuousServer, DecodeRequest, params, device)
    log("--- serving llama3_8b int8 through the wire (InferClient -> "
        "ContinuousReplica -> PagedContinuousServer), bf16 KV: "
        + json.dumps(wire))
    for label, run in (
            ("wire (phase 8, first wire turn)", wire),
            ("direct step(), warmed as the wire (phase 8, first direct "
             "turn)", wire["direct_twin"]),
            ("direct step() (phase 4)", paged_runs[0])):
        log(f"{label}, server side (the requests' own stamps, from the "
            f"server's submit): TTFT p50 {run['ttft_ms_p50']:.1f} ms, max "
            f"{run['ttft_ms_max']:.1f} ms, total p50 "
            f"{run['total_ms_p50']:.1f} ms; served "
            f"{run['served_tok_s']:.1f} tok/s (12 requests, paged bf16 KV, "
            f"8 slots); {smi}")
    for index, turn in enumerate(wire["turns"]):
        log(f"phase 8 turn {index} ({turn['kind']}), caller side: TTFT p50 "
            f"{turn['client_ttft_ms_p50']:.1f} ms, max "
            f"{turn['client_ttft_ms_max']:.1f} ms (the 4 requests that "
            f"stream), send-to-answer p50 "
            f"{turn['client_total_ms_p50']:.1f} ms, max "
            f"{turn['client_total_ms_max']:.1f} ms, served "
            f"{turn['served_tok_s']:.1f} tok/s"
            + (f", the wire's own time a request (send-to-answer less "
               f"total_ms) p50 {turn['wire_ms_per_request_p50']:.2f} ms"
               if turn["kind"] == "wire" else "") + f"; {smi}")
    obs = wire["observability"]
    log(f"phase 8 observability: (profile {WIRE_PROFILE_STEPS}) answered "
        f"{obs['profile_response']}, the bracket {obs['profile_steps']} "
        f"steps at {obs['profile_device_step_ms']:.3f} device ms a step "
        f"(CUDA events; chunks {obs['profile_chunks']}), trace "
        f"{obs['trace_bytes']} bytes; (census) bundle with tiers "
        f"{obs['census_tiers']}, {obs['audit_violations']} audit violations"
        f" in {obs['audit_sweeps']} sweeps; the doctor rendered "
        f"{obs['doctor_lines']} lines; {obs['seconds']} s; {smi}")
    spread = wire["spread"]
    log("phase 8 spread over turns (min-max), caller side: " + "; ".join(
        f"{key}: wire {spread[f'wire_{key}_min']:.1f}-"
        f"{spread[f'wire_{key}_max']:.1f}, direct "
        f"{spread[f'direct_{key}_min']:.1f}-"
        f"{spread[f'direct_{key}_max']:.1f}" for key in WIRE_TURN_KEYS)
        + f"; phase 8 took {time.monotonic() - t0:.1f} s; {smi}")

    # ---- phase 9: the KV tiers and the KV wire (phase 4's weights) ----
    t0 = time.monotonic()
    kv_runs = []
    for quantize_kv in (False, True):
        kv = "int8" if quantize_kv else "bf16"
        run = {}
        for part, fn in (("tier", serve_tier), ("spill", serve_spill),
                         ("wire", serve_kv_wire)):
            run[part] = fn(torch, np, llama, w8, paged_kernels,
                           PagedContinuousServer, DecodeRequest, params,
                           quantize_kv, device)
            gc.collect()
            torch.cuda.empty_cache()
        log(f"--- KV tiers and the KV wire (phase 9), llama3_8b int8, {kv} "
            "KV: " + json.dumps(run))
        tier, spill, wire9 = run["tier"], run["spill"], run["wire"]
        log(f"phase 9 (a) host tier, {kv} KV: {tier['demotions']} blocks "
            f"demoted, {tier['restores']} restored over "
            f"{tier['restore_steps']} steps "
            f"({tier['restore_steps_with_decode_tokens']} with decode "
            f"tokens); TTFT of the prefix cold {tier['prefix_ttft_ms']:.1f} "
            f"ms, restored {tier['restored_ttft_ms']:.1f} ms; pool auditor "
            f"{tier['audit_sweeps']} sweeps, {tier['audit_violations']} "
            f"violations, flow integral {tier['flow_integral_blocks']} "
            f"blocks = the census; {smi}")
        log(f"phase 9 (b) spill, {kv} KV: {spill['spills']} blocks spilled "
            f"({spill['spill_dir_bytes']} bytes in {spill['spill_files']} "
            f"files), {spill['adopted_blocks']} adopted in "
            f"{spill['adopt_ms']:.1f} ms, {spill['disk_restores']} restored "
            f"from disk; TTFT {spill['restored_ttft_ms']:.1f} ms; pool "
            f"auditor {spill['audit_spill']['audit_sweeps']} + "
            f"{spill['audit_adopt']['audit_sweeps']} sweeps, "
            f"{spill['audit_spill']['audit_violations']} + "
            f"{spill['audit_adopt']['audit_violations']} violations, flow "
            f"integrals {spill['audit_spill']['flow_integral_blocks']} and "
            f"{spill['audit_adopt']['flow_integral_blocks']} blocks = the "
            f"censuses; {smi}")
        for index, turn in enumerate(wire9["turns"]):
            log(f"phase 9 (c) turn {index} ({turn['kind']}), {kv} KV: TTFT "
                f"{turn['ttft_ms']:.1f} ms, send-to-answer "
                f"{turn['total_ms']:.1f} ms"
                + (f"; {turn['payload_bytes']} payload bytes "
                   f"({turn['blocks']:.0f} blocks): export "
                   f"{turn['export_ms']:.1f} ms, wire {turn['wire_ms']:.1f}"
                   f" ms, import {turn['import_ms']:.1f} ms, fetch "
                   f"{turn['fetch_ms']:.1f} ms ({turn['mb_per_s']:.1f} "
                   f"MB/s), landing {turn['landing_host_ms']:.1f} ms of "
                   "host" if turn["kind"] == "warm" else "")
                + f"; {smi}")
        mig = wire9["migration"]
        log(f"phase 9 (d) migrate, {kv} KV: migrate_ready after "
            f"{mig['committed_tokens']} tokens with {mig['blocks']} blocks, "
            f"{mig['imported_blocks']:.0f} imported, resumed on A's tail "
            f"rows {mig['tails_adopted']}, fetch {mig['fetch_ms']:.1f} ms; "
            f"{smi}")
        kv_runs.append(run)
    log(f"phase 9 took {time.monotonic() - t0:.1f} s; {smi}")

    # ---- phase 10: the fleet (phase 4's weights) ----
    t0 = time.monotonic()
    fleet = serve_fleet(torch, np, llama, w8, paged_kernels,
                        PagedContinuousServer, DecodeRequest, params, device)
    log("--- the fleet (phase 10: Registrar, ReplicaRouter, two "
        "ContinuousReplicas), llama3_8b int8, bf16 KV: " + json.dumps(fleet))
    print_fleet(fleet, smi)
    log(f"phase 10 took {time.monotonic() - t0:.1f} s; {smi}")

    # ---- phase 11: the elastic fleet (phase 4's weights) ----
    t0 = time.monotonic()
    elastic = serve_elastic(torch, np, llama, w8, paged_kernels,
                            PagedContinuousServer, DecodeRequest, params,
                            device)
    log("--- the elastic fleet (phase 11: FleetAutoscaler, Registrar, "
        "ReplicaRouter), llama3_8b int8, bf16 KV: " + json.dumps(elastic))
    print_elastic(elastic, smi)
    log(f"phase 11 took {time.monotonic() - t0:.1f} s; {smi}")

    # ---- phase 13: grammars and adapters (phase 4's weights) ----
    t0 = time.monotonic()
    grammar_lora = serve_grammar_lora_phase(
        torch, np, llama, paged_kernels + (pp.append_kv_ragged,),
        PagedContinuousServer, DecodeRequest, params, device, w8,
        base_step_ms=paged_runs[0]["steady_step_ms"])
    print_grammar_lora_phase(grammar_lora, smi)
    log(f"phase 13 took {time.monotonic() - t0:.1f} s; {smi}")

    # ---- phase 6: int4 weights through every server ----
    del params, draft_1b
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    params4 = llama.random_quantized_params(config, seed=0, bits=4,
                                            device=device)
    torch.cuda.synchronize()
    log(f"llama3_8b int4 params on the card in "
        f"{time.monotonic() - t0:.1f} s")
    w4 = Weights(quant, 4)
    kernels4 = (quant.int4_matmul, quant.int4_matmul_tiled,
                quant.int4_matmul_scale_first, quant.int8_matmul,
                attention.flash_attention,
                paged_attention.paged_decode_attention, pp.write_kv_rows)
    for k, n in projections(config) + [(config.d_model, config.vocab_size)]:
        if not quant.tiles_int4(k, n, max(1, k // 128)):
            fail(f"int4 {k}x{n}: the m-tiled instance does not take it, so "
                 "a prefill slice would leave the kernels")
    int4_run = serve(torch, np, llama, w4, kernels4,
                     ContinuousBatchingServer, DecodeRequest, params4, False,
                     device)
    log("--- serving llama3_8b int4, bf16 KV: " + json.dumps(int4_run))
    wide_run = serve_wide(torch, np, llama, w4, kernels4,
                          ContinuousBatchingServer, DecodeRequest, params4,
                          device)
    log("--- serving llama3_8b int4 at 64 slots, bf16 KV: "
        + json.dumps(wide_run))
    for label, run in (("int4", wide_run), ("int8", wide8)):
        log(f"64-slot {label} steady decode step, eager: weight matmul "
            f"{fmt_ms(run['matmul_device_ms_per_step'])} ms of "
            f"{fmt_ms(run['eager_device_ms_per_step'])} ms device time, "
            f"{run['eager_step_ms']:.4f} ms a step unprofiled; graphed: "
            f"{fmt_ms(run['graphed_matmul_device_ms_per_step'])} of "
            f"{fmt_ms(run['graphed_device_ms_per_step'])} ms, "
            f"{run['steady_step_ms']:.4f} ms a step")
    kernels4_paged = kernels4 + (pp.append_kv, pp.chunk_attention)
    paged4_runs = []
    for quantize_kv in (False, True):
        run = serve_paged(torch, np, llama, w4, kernels4_paged,
                          PagedContinuousServer, DecodeRequest, params4,
                          quantize_kv, device)
        log(f"--- serving llama3_8b int4 through the paged server, "
            f"{run['kv']} KV: " + json.dumps(run))
        paged4_runs.append(run)
    paged_wide4 = steady_paged_wide(torch, np, llama, w4,
                                    PagedContinuousServer, DecodeRequest,
                                    params4, device)
    log("--- steady decode, llama3_8b int4 through the paged server at 64 "
        "slots, bf16 KV: " + json.dumps(paged_wide4))
    log("TTFT p50, int4 against int8 (same traffic, this run): contiguous "
        f"{int4_run['ttft_ms_p50']:.1f} against {runs[0]['ttft_ms_p50']:.1f}"
        f" ms; 64 slots {wide_run['ttft_ms_p50']:.1f} against "
        f"{wide8['ttft_ms_p50']:.1f} ms; paged bf16 KV "
        f"{paged4_runs[0]['ttft_ms_p50']:.1f} against "
        f"{paged_runs[0]['ttft_ms_p50']:.1f} ms; paged int8 KV "
        f"{paged4_runs[1]['ttft_ms_p50']:.1f} against "
        f"{paged_runs[1]['ttft_ms_p50']:.1f} ms; int4_matmul_tiled launches "
        f"{int4_run['launches']['int4_matmul_tiled']} (contiguous), "
        f"{paged4_runs[0]['launches']['int4_matmul_tiled']} (paged)")
    run = serve_spec(torch, np, llama, quant, w4,
                     kernels4_paged + (pp.append_kv_ragged,),
                     PagedContinuousServer, DecodeRequest, params4, False,
                     device, "paired", params4, short=True)
    log("--- speculative serving (paired int4 draft), llama3_8b int4, bf16 "
        "KV: " + json.dumps(run))
    log(f"phase 6 took {time.monotonic() - t0:.1f} s")
    verify_m, resync_m = SLOTS * (SPEC_K + 1), SLOTS * SPEC_K
    if not {verify_m, resync_m} <= set(run["int4_kernel_rows"]):
        fail(f"spec int4: the verify (m={verify_m}) or the resync "
             f"(m={resync_m}) did not take the int4 kernel: "
             f"{run['int4_kernel_rows']}")
    int4_ms = int4_run["matmul_device_ms_per_step"]
    int4_after, int4_first = int4_steps["after"], int4_steps["first"]
    log(f"int4_matmul ms per decode step: "
        + (f"{int4_ms:.4f} (profiled steady decode)" if int4_ms is not None
           else f"{int4_after['ms']:.4f} (isolated sum; profiler empty)"))
    if int4_ms is None:
        int4_ms = int4_after["ms"]
    int4_tiled = int4_steps["tiled"]

    # ---- phase 14: mixture-of-experts at mixtral_8x7b's width ----
    del params4
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    moe_phase = serve_moe_phase(
        torch, np, llama, quant, paged_kernels + (pp.append_kv_ragged,),
        kernels4 + (pp.append_kv, pp.chunk_attention, pp.append_kv_ragged),
        ContinuousBatchingServer, PagedContinuousServer, DecodeRequest,
        device)
    print_moe_phase(moe_phase, smi)
    log(f"phase 14 took {time.monotonic() - t0:.1f} s; {smi}")

    # ---- phase 15: the vision-LLM pipeline (after phase 14 freed its
    # weights) ----
    t0 = time.monotonic()
    vision_llm = serve_vision_llm(torch, np, llama, quant, kernels, device)
    print_vision_llm(vision_llm, smi)
    log(f"phase 15 took {time.monotonic() - t0:.1f} s; {smi}")

    # ---- phase 7: the ring collective matmuls, 4 ranks on the card ----
    t0 = time.monotonic()
    ring_rows, ring_launches, ring_copies = check_ring(torch, parallel,
                                                       device)
    log(f"phase 7 took {time.monotonic() - t0:.1f} s")
    print_ring_rows(ring_rows, ring_launches, ring_copies)
    ring_main = {kind: next(r for r in ring_rows if r["kind"] == kind)
                 for kind in ("ag", "rs")}

    print_steady_cells([
        ("contiguous int8, 8 slots, bf16 KV", runs[0]),
        ("contiguous int8, 64 slots, bf16 KV", wide8),
        ("paged int8, 8 slots, bf16 KV", paged_runs[0]),
        ("paged int8, 64 slots, bf16 KV", paged_wide8),
        ("contiguous int4, 8 slots, bf16 KV", int4_run),
        ("contiguous int4, 64 slots, bf16 KV", wide_run),
        ("paged int4, 8 slots, bf16 KV", paged4_runs[0]),
        ("paged int4, 64 slots, bf16 KV", paged_wide4)])
    main_run = runs[0]["launches"]
    # int8_matmul's time is the path's: device time of its launches per
    # steady bf16-KV decode step, from the profiler (the sum of isolated
    # per-shape times stands in only if the profiler saw no device time).
    int8_ms = runs[0]["matmul_device_ms_per_step"]
    log(f"int8_matmul ms per decode step: "
        + (f"{int8_ms:.4f} (profiled steady decode)" if int8_ms is not None
           else f"{int8_step['ms']:.4f} (isolated sum; profiler empty)"))
    if int8_ms is None:
        int8_ms = int8_step["ms"]
    report = {"kernels": [
        dict(name="int8_matmul", route="cuda",
             source="aiko_services_tpu_torch/csrc/int8_matmul.cu",
             replaces="aiko_services_tpu/ops/quant.py:180",
             launches=main_run["int8_matmul"],
             max_abs_err=max(r["err"] for r in int8_rows),
             ms=int8_ms, plain_ms=int8_step["plain_ms"],
             bound_ms=int8_step["bound_ms"], bound_by="bytes",
             library_ms=int8_step["library_ms"]),
    ]}
    int4_after_row = dict(
        route="cuda", source="aiko_services_tpu_torch/csrc/int4_matmul.cu",
        launches=int4_run["launches"]["int4_matmul"],
        max_abs_err=max(r["err"] for r in int4_rows
                        if r["numerics"] == "after"),
        ms=int4_ms, plain_ms=int4_after["plain_ms"],
        bound_ms=int4_after["bound_ms"],
        bound_by=step_bound_by(int4_rows, "after"),
        library_ms=int4_after["library_ms"])
    int4_first_row = dict(
        route="cuda", source="aiko_services_tpu_torch/csrc/int4_matmul.cu",
        launches=int4_run["launches"]["int4_matmul_scale_first"],
        max_abs_err=max(r["err"] for r in int4_rows
                        if r["numerics"] == "first"),
        ms=int4_first["ms"], plain_ms=int4_first["plain_ms"],
        bound_ms=int4_first["bound_ms"],
        bound_by=step_bound_by(int4_rows, "first"),
        library_ms=int4_first["library_ms"])
    report["kernels"] += [
        # One kernel source, two TPU kernels and the lab's two variants: the
        # lab rows repeat the numbers of the instance they are.
        dict(name="int4_matmul",
             replaces="aiko_services_tpu/ops/quant.py:244", **int4_after_row),
        dict(name="int4_matmul_tiled", route="cuda",
             source="aiko_services_tpu_torch/csrc/int4_matmul.cu",
             replaces="aiko_services_tpu/ops/quant.py:244",
             launches=int4_run["launches"]["int4_matmul_tiled"],
             max_abs_err=max(r["err"] for r in int4_rows
                             if r["numerics"] == "tiled"),
             ms=int4_tiled["ms"], plain_ms=int4_tiled["plain_ms"],
             bound_ms=int4_tiled["bound_ms"],
             bound_by=step_bound_by(int4_rows, "tiled", TILED_ROWS[-1]),
             library_ms=int4_tiled["library_ms"]),
        dict(name="int4_matmul_scale_first",
             replaces="aiko_services_tpu/ops/quant.py:195", **int4_first_row),
        dict(name="int4_kernel_lab.matmul_repeat",
             replaces="scripts/int4_kernel_lab.py:51", **int4_first_row),
        dict(name="int4_kernel_lab.matmul_batched",
             replaces="scripts/int4_kernel_lab.py:97", **int4_after_row),
    ]
    for kind, name, line in (("ag", "rdma_allgather_matmul", 190),
                             ("rs", "rdma_matmul_reducescatter", 291)):
        row = ring_main[kind]
        report["kernels"].append(dict(
            name=name, route="cuda",
            source="aiko_services_tpu_torch/csrc/ring_matmul.cu",
            replaces=f"aiko_services_tpu/parallel/rdma_collective.py:{line}",
            launches=ring_launches[kind],
            max_abs_err=max(r["err"] for r in ring_rows if r["kind"] == kind),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    report["kernels"] += [
        dict(name="flash_attention", route="cuda",
             source="aiko_services_tpu_torch/csrc/flash_attention.cu",
             replaces="aiko_services_tpu/ops/attention.py:231",
             launches=main_run["flash_attention"],
             max_abs_err=max(r["err"] for r in flash_rows),
             ms=flash_main["ms"], plain_ms=flash_main["plain_ms"],
             bound_ms=flash_main["bound_ms"],
             bound_by=flash_main["bound_by"],
             library_ms=flash_main["library_ms"]),
        dict(name="paged_decode_attention", route="cuda",
             source="aiko_services_tpu_torch/csrc/paged_decode.cu",
             replaces="aiko_services_tpu/ops/paged_attention.py:430",
             launches=main_run["paged_decode_attention"],
             max_abs_err=max(r["err"] for r in decode_rows),
             ms=decode_main["ms"], plain_ms=decode_main["plain_ms"],
             bound_ms=decode_main["bound_ms"],
             bound_by=decode_main["bound_by"],
             library_ms=decode_main["library_ms"]),
        dict(name="append_kv", route="cuda",
             source="aiko_services_tpu_torch/csrc/kv_write.cu",
             replaces="aiko_services_tpu/ops/paged_prefill.py:264",
             launches=paged_main["append_kv"],
             max_abs_err=max(r["err"] for r in append_rows),
             ms=append_main["ms"], plain_ms=append_main["plain_ms"],
             bound_ms=append_main["bound_ms"],
             bound_by=append_main["bound_by"],
             library_ms=append_main["library_ms"]),
        dict(name="chunk_attention", route="cuda",
             source="aiko_services_tpu_torch/csrc/paged_prefill.cu",
             replaces="aiko_services_tpu/ops/paged_prefill.py:424",
             launches=paged_main["chunk_attention"],
             max_abs_err=max(r["err"] for r in chunk_rows),
             ms=chunk_main["ms"], plain_ms=chunk_main["plain_ms"],
             bound_ms=chunk_main["bound_ms"],
             bound_by=chunk_main["bound_by"],
             library_ms=chunk_main["library_ms"]),
        dict(name="append_kv_ragged", route="cuda",
             source="aiko_services_tpu_torch/csrc/kv_write.cu",
             replaces="aiko_services_tpu/ops/paged_prefill.py:619",
             launches=spec_main["append_kv_ragged"],
             max_abs_err=max(r["err"] for r in ragged_rows),
             ms=ragged_main["ms"], plain_ms=ragged_main["plain_ms"],
             bound_ms=ragged_main["bound_ms"],
             bound_by=ragged_main["bound_by"],
             library_ms=ragged_main["library_ms"]),
        # The ragged writer's row mode: the decode step's K/V write.
        dict(name="write_kv_rows", route="cuda",
             source="aiko_services_tpu_torch/csrc/kv_write.cu",
             replaces="aiko_services_tpu/ops/paged_prefill.py:619",
             launches=main_run["write_kv_rows"],
             max_abs_err=max(r["err"] for r in write_rows),
             ms=write_main["ms"], plain_ms=write_main["plain_ms"],
             bound_ms=write_main["bound_ms"],
             bound_by=write_main["bound_by"],
             library_ms=write_main["library_ms"]),
    ]
    log(f"chunk_attention at the verify shape (T=5, bf16, no window): "
        f"{verify_main['ms']:.4f} ms, SDPA {verify_main['library_ms']:.4f} "
        f"ms, bound {verify_main['bound_ms']:.4f} ms")
    log(f"kernel worst err/tol: int8 {int8_worst:.3f}, int4 (both "
        f"numerics) {int4_worst:.3f}, flash "
        f"{flash_worst:.3f}, decode {decode_worst:.3f} (bs 16: "
        f"{paged_decode_worst:.3f}), chunk_attention {chunk_worst:.3f} "
        f"(verify shape {verify_worst:.3f}), ring "
        f"{max(r['ratio'] for r in ring_rows):.3f}; append_kv, "
        f"append_kv_ragged and write_kv_rows pools byte-equal; total "
        f"{time.monotonic() - began:.1f} s")
    log(smi)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
