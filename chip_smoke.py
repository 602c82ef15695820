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
   prefill dispatches of the run, then a full-batch steady decode window
   timed bare, under cProfile (host functions) and under torch.profiler
   (device time by kernel; int8_matmul's time per step in the kernel
   line is read from it).

The line before the last is one JSON object with every kernel's
numbers; the last line is {"ok": true, "device": {...}}.  Without a CUDA
card, or without the repository beside it, the script exits non-zero
and prints no result.
"""

import json
import math
import os
import subprocess
import sys
import time

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

def device_ms(torch, fn, reps: int) -> float:
    """Card time of one call of ``fn``: CUDA events around ``reps`` calls
    queued behind a 50 ms device-side sleep, so the kernels run back to
    back and the host's launch path (slower than the smaller kernels)
    adds no gaps to the window."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)          # ~50 ms at the card's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want):
    """(max abs error, worst error over tolerance) of a kernel's ``got``
    against the f32 plain ``want``, per element (TOL_REL, TOL_ROW)."""
    got, want = got.float(), want.float()
    magnitude = want.abs()
    tol = TOL_REL * magnitude + TOL_ROW * magnitude.amax(-1, keepdim=True)
    err = (got - want).abs()
    return float(err.max()), float((err / tol.clamp_min(1e-30)).max())


def projections(config):
    """(K, N) of every int8 projection a layer runs, in order."""
    d, kvd = config.d_model, config.n_kv_heads * config.head_dim
    return [(d, config.n_heads * config.head_dim), (d, kvd), (d, kvd),
            (config.n_heads * config.head_dim, d), (d, config.d_ff),
            (d, config.d_ff), (config.d_ff, d)]


def int8_launches(quant, config, rows: int, seq: int) -> int:
    """int8_matmul kernel launches of one forward pass over ``rows``
    sequences of ``seq`` positions: the projections that take the kernel
    at m = rows * seq in every layer, and the LM head at each row's last
    position (m = rows)."""
    per_layer = sum(quant.kernel_shape(rows * seq, k, n)
                    for k, n in projections(config))
    return (config.n_layers * per_layer
            + quant.kernel_shape(rows, config.d_model, config.vocab_size))


# --------------------------------------------------------------------------- #
# Phase 2: kernels against their plain versions

def check_int8_matmul(torch, quant, device, config):
    """Every llama3_8b projection width and the LM head at m = 1, 8, 64
    (batch-1 decode, the 8-slot decode batch, the largest kernel
    prefill).  Weights rotate through enough copies to exceed the 50 MB
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
        for m in (1, 8, 64):
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
            rows.append(dict(shape=f"{name} m={m} K={k} N={n}", err=err,
                             ratio=ratio, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by,
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


def _visible_pairs(q_len, k_len, window):
    total = 0
    for i in range(q_len):
        qpos = i + k_len - q_len
        lo = 0 if window is None else max(0, qpos - window + 1)
        total += qpos + 1 - lo
    return total


def check_flash(torch, attention, device):
    """Admission prefill: llama3_8b heads (32 q, 8 kv, hd 128), batch 1,
    buckets 64..1024, window off and 256."""
    import torch.nn.functional as F
    gen = torch.Generator(device=device).manual_seed(1)
    h, kv, hd = 32, 8, 128
    rows, worst, main = [], 0.0, None
    for seq in (64, 256, 1024):
        q = torch.randn((1, h, seq, hd), generator=gen, device=device) \
            .to(torch.bfloat16)
        k = torch.randn((1, kv, seq, hd), generator=gen, device=device) \
            .to(torch.bfloat16)
        v = torch.randn((1, kv, seq, hd), generator=gen, device=device) \
            .to(torch.bfloat16)
        for window in (None, 256):
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
            pairs = _visible_pairs(seq, seq, window)
            b_ms, b_by = bound(2 * (2 * h * seq * hd + 2 * kv * seq * hd),
                               4 * hd * h * pairs)
            row = dict(shape=f"b=1 h=32 kv=8 S={seq} hd=128 "
                             f"window={window}", err=err, ratio=ratio, ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=library_ms)
            rows.append(row)
            if seq == 1024 and window is None:
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


def print_rows(title, rows):
    log(f"--- {title}")
    for row in rows:
        library = row.get("library_ms")
        log(f"  {row['shape']}: max_abs_err {row['err']:.3g} (err/tol "
            f"{row['ratio']:.3f})  kernel_ms {row['ms']:.4f}  plain_ms "
            f"{row['plain_ms']:.4f}  bound_ms {row['bound_ms']:.4f} "
            f"({row['bound_by']})  library_ms "
            f"{'n/a' if library is None else f'{library:.4f}'}")


# --------------------------------------------------------------------------- #
# Phase 3: serving

def oracle_tokens(torch, llama, params, config, prompt, new, quantize_kv,
                  device):
    tokens = torch.as_tensor(prompt, device=device)[None]
    cache = llama.init_cache(config, 1, MAX_SEQ, quantize_kv=quantize_kv,
                             device=device)
    logits, cache = llama.prefill(params, tokens, cache, config)
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    rest, _ = llama.generate_tokens(params, first, cache, tokens.shape[1],
                                    new - 1, config)
    return [int(first[0, 0])] + rest[0].tolist()


def check_request(torch, llama, params, config, request, quantize_kv,
                  device):
    """Hold every served token of ``request`` to the batch-1 oracle;
    returns (tokens equal to the oracle's argmax, [(index, gap)] of the
    accepted near-ties).  A request that differs from the oracle's own
    greedy run is walked again teacher-forced: the oracle reads the
    served tokens, so each later token is still compared with what the
    oracle would pick after the same prefix."""
    oracle = oracle_tokens(torch, llama, params, config, request.prompt,
                           len(request.tokens), quantize_kv, device)
    if request.tokens == oracle:
        return len(oracle), []
    prompt = torch.as_tensor(request.prompt, device=device)[None]
    cache = llama.init_cache(config, 1, MAX_SEQ, quantize_kv=quantize_kv,
                             device=device)
    logits, cache = llama.prefill(params, prompt, cache, config)
    equal, ties = 0, []
    for index, served in enumerate(request.tokens):
        row = logits[0, -1]
        best = int(row.argmax())
        if served == best:
            equal += 1
        else:
            gap = float(row[best] - row[served])
            if gap > TIE_GAP:
                fail(f"request {request.request_id} (prompt "
                     f"{prompt.shape[1]}): token {index} is {served}, "
                     f"oracle {best}, logit gap {gap:.4f} > {TIE_GAP}")
            ties.append((index, round(gap, 4)))
        if index + 1 < len(request.tokens):
            token = torch.tensor([[served]], dtype=torch.int32,
                                 device=device)
            logits, cache = llama.decode_step(params, token, cache,
                                              prompt.shape[1] + index,
                                              config)
    return equal, ties


def serve(torch, np, llama, quant, kernels, server_cls, request_cls,
          params, quantize_kv, device):
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

    def recorded_prefill(params, tokens, cache, config):
        dispatches.append(tuple(tokens.shape))
        return prefill(params, tokens, cache, config)

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
    kernel_prefills = sum(quant.kernel_shape(rows * seq, config.d_model,
                                             config.d_model)
                          for rows, seq in dispatches)
    want = {"int8_matmul": int8_launches(quant, config, SLOTS, 1) * steps
            + sum(int8_launches(quant, config, rows, seq)
                  for rows, seq in dispatches),
            "paged_decode_attention": layers * steps,
            "flash_attention": layers * len(dispatches)}
    for name, expected in want.items():
        if launches[name] != expected or expected == 0:
            fail(f"{name}: {launches[name]} launches, expected {expected} "
                 f"(decode_steps {steps}, prefill dispatches {dispatches})")
    if not kernel_prefills:
        fail(f"no prefill dispatch took the int8 kernel: {dispatches}")

    exact, equal, checked, ties = 0, 0, 0, []
    for request in requests:
        same, near = check_request(torch, llama, params, config, request,
                                   quantize_kv, device)
        exact += not near and same == len(request.tokens)
        equal += same
        checked += len(request.tokens)
        ties += [(request.request_id, index, gap) for index, gap in near]

    ttfts = sorted((r.first_token_ts - r.submitted_ts) * 1e3
                   for r in requests)
    generated = sum(len(r.tokens) for r in requests)
    steady = steady_decode(torch, np, quant, server_cls, request_cls,
                           params, quantize_kv, device, config)
    return dict(kv="int8" if quantize_kv else "bf16",
                requests=len(requests), requests_exact=exact,
                tokens_checked=checked, tokens_equal=equal,
                accepted_near_ties=ties, launches=launches,
                decode_steps=steps, prefill_dispatches=dispatches,
                int8_kernel_prefills=kernel_prefills,
                wall_s=wall, served_tok_s=generated / wall,
                ttft_ms_p50=ttfts[len(ttfts) // 2], ttft_ms_max=ttfts[-1],
                peak_gb=peak_gb, **steady)


def steady_decode(torch, np, quant, server_cls, request_cls, params,
                  quantize_kv, device, config):
    """Decode at a full batch: 8 requests of 128 prompt tokens admitted
    together; after every request has its first token, 32 decode steps
    are timed with nothing attached, 16 more under cProfile (the host's
    top functions by own time are printed) and 16 more under
    torch.profiler (the card's kernel time per step, by kernel; busy
    share = kernel time per step over the unprofiled step;
    ``int8_matmul``'s device time per step).

    The tracer may miss the kernels launched while it comes up, and a
    window of consumed steps need not hold whole dispatched steps (the
    ring keeps chunks in flight across its edges), so a step's device
    time is not the window's total over its step count: the steps the
    tracer saw are its ``int8_matmul_kernel`` records over the exact
    launches of one decode step (the kernel-shape rule, which the
    serving run's launch counts hold), and ``int8_matmul``'s time per
    step is its mean recorded launch times those launches."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile
    server = server_cls(config_name="llama3_8b", slots=SLOTS,
                        max_seq=MAX_SEQ, chunk_steps=CHUNK_STEPS,
                        params=params, quantize=True,
                        quantize_kv=quantize_kv, device=device)
    rng = np.random.default_rng(11)
    requests = [request_cls(f"s{i}", rng.integers(1, config.vocab_size,
                                                  128).astype(np.int32), 96)
                for i in range(SLOTS)]
    for request in requests:
        server.submit(request)
    while any(r.first_token_ts is None for r in requests):
        server.step()

    def window(steps):
        start = server.counters["decode_steps"]
        torch.cuda.synchronize()
        began = time.perf_counter()
        while server.counters["decode_steps"] - start < steps:
            server.step()
        torch.cuda.synchronize()
        return time.perf_counter() - began, \
            server.counters["decode_steps"] - start

    wall, steps = window(32)
    step_ms = wall * 1e3 / steps
    host = cProfile.Profile()
    host.enable()
    host_wall, host_steps = window(16)
    host.disable()
    text = io.StringIO()
    pstats.Stats(host, stream=text).sort_stats("tottime").print_stats(12)
    log(f"--- host, {'int8' if quantize_kv else 'bf16'} KV steady decode "
        f"(cProfile, {host_wall * 1e3 / host_steps:.3f} ms a step with it "
        "on):")
    for line in text.getvalue().splitlines():
        if line.strip() and not line.lstrip().startswith(("Ordered", "List")):
            log("  " + line.rstrip())
    per_step = int8_launches(quant, config, SLOTS, 1)
    launched = quant.int8_matmul.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        window(16)
    launched = quant.int8_matmul.launches - launched
    server.run_until_drained()
    averages = prof.key_averages()
    device_us = sum(event.self_device_time_total for event in averages)
    int8 = [event for event in averages if "int8_matmul_kernel" in event.key]
    recorded = sum(event.count for event in int8)
    result = dict(steady_decode_tok_s=SLOTS * 1e3 / step_ms,
                  steady_step_ms=step_ms, steady_device_ms_per_step=None,
                  steady_device_busy=None, int8_device_ms_per_step=None,
                  int8_launches_traced=recorded,
                  int8_launches_in_trace=launched)
    if not device_us or not recorded:
        log("--- device: the profiler recorded no int8_matmul launch "
            "(not measured)")
        return result
    steps = recorded / per_step
    device_ms = device_us / 1e3 / steps
    log(f"--- device ({device_ms:.3f} ms of kernels a step over {steps:g} "
        f"steps; int8_matmul: {recorded} launches recorded of {launched} "
        "made under the profiler):")
    for line in averages.table(sort_by="self_device_time_total",
                               row_limit=10,
                               max_name_column_width=50).splitlines():
        log("  " + line)
    result.update(
        steady_device_ms_per_step=device_ms,
        steady_device_busy=device_ms / step_ms,
        int8_device_ms_per_step=sum(e.self_device_time_total for e in int8)
        / 1e3 / steps)
    return result


# --------------------------------------------------------------------------- #

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

    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.ops import (_cuda, attention,
                                             paged_attention, quant)
    from aiko_services_tpu_torch.orchestration.continuous import (
        ContinuousBatchingServer, DecodeRequest)

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
    config = llama.CONFIGS["llama3_8b"]
    int8_rows, int8_worst, int8_step = check_int8_matmul(torch, quant,
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
    flash_rows, flash_worst, flash_main = check_flash(torch, attention,
                                                      device)
    print_rows("flash_attention", flash_rows)
    decode_rows, decode_worst, decode_main = check_decode(
        torch, paged_attention, llama, device)
    print_rows("paged_decode_attention", decode_rows)

    # ---- phase 3: serving ----
    t0 = time.monotonic()
    params = llama.random_quantized_params(config, seed=0, device=device)
    torch.cuda.synchronize()
    log(f"llama3_8b int8 params on the card in "
        f"{time.monotonic() - t0:.1f} s")
    kernels = (quant.int8_matmul, attention.flash_attention,
               paged_attention.paged_decode_attention)
    runs = []
    for quantize_kv in (False, True):
        run = serve(torch, np, llama, quant, kernels,
                    ContinuousBatchingServer, DecodeRequest, params,
                    quantize_kv, device)
        log(f"--- serving llama3_8b int8, {run['kv']} KV: "
            + json.dumps(run))
        runs.append(run)

    main_run = runs[0]["launches"]
    # int8_matmul's time is the path's: device time of its launches per
    # steady bf16-KV decode step, from the profiler (the sum of isolated
    # per-shape times stands in only if the profiler saw no device time).
    int8_ms = runs[0]["int8_device_ms_per_step"]
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
    ]}
    log(f"kernel worst err/tol: int8 {int8_worst:.3f}, flash "
        f"{flash_worst:.3f}, decode {decode_worst:.3f}; total "
        f"{time.monotonic() - began:.1f} s")
    log(smi)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
