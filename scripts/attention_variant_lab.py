#!/usr/bin/env python3
"""Time variants of the port's three attention kernels on one card, in turns.

Each variant is a copy of ``csrc/paged_decode.cu``,
``csrc/flash_attention.cu`` or ``csrc/paged_prefill.cu`` with one constant
edited (the ring depth, the split size, the warpgroups of a flash CTA,
the chunk kernel's bf16 products on mma.sync instead of wgmma).
Every copy is built with the port's own nvcc flags into a shared library
of its own, bound with ctypes, and called at the smoke's shapes: paged
decode at block size 16 (8 rows at positions 1,100-1,199, bf16 and int8
pools; 64 rows, int8) and at the contiguous server's block size 128,
flash attention at batch 1 (64, 256, 1,024 and 2,048 tokens, causal,
llama3_8b heads) and at 64 rows of 128 tokens, and paged chunk attention
at 16-row blocks (a 256-token slice after 1,024 cached tokens, bf16 and
int8 pools; a 16-token slice after 1,792; the verify's 5-token windows on
8 rows at 1,030-1,199).  Variants run in turns (the list given, then reversed), each
time the least of three CUDA-event windows (``chip_smoke.device_ms``),
after three warm-up calls, and each output is held to the f32 plain
version (err/tol in brackets, as the smoke's).  The pools hold more
blocks than the card's 50 MB L2.

    python3 scripts/attention_variant_lab.py [NAME ...]

Needs an NVIDIA card and nvcc; builds under ``_build/lab`` (git-ignored).
"""

import argparse
import ctypes
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "aiko_services_tpu_torch" / "csrc"
DECODE, FLASH, CHUNK = ("paged_decode.cu", "flash_attention.cu",
                        "paged_prefill.cu")
ENTRIES = {DECODE: "aiko_paged_decode", FLASH: "aiko_flash_attention",
           CHUNK: "aiko_chunk_attention"}
#: name -> (source, [(text, replacement), ...]); the first of each source
#: is the source as it is.
VARIANTS = {
    "decode": (DECODE, []),
    "decode_stages4": (DECODE, [("constexpr int kStages = 3;",
                                 "constexpr int kStages = 4;")]),
    "decode_split128": (DECODE, [("constexpr int kSplitKeys = 256;",
                                  "constexpr int kSplitKeys = 128;")]),
    "decode_split512": (DECODE, [("constexpr int kSplitKeys = 256;",
                                  "constexpr int kSplitKeys = 512;")]),
    "decode_two_blocks_at_128": (DECODE, [
        ("return block_size >= kSplitKeys / 2 ? block_size",
         "return block_size > kSplitKeys ? block_size")]),
    "flash": (FLASH, []),
    "flash_stages3": (FLASH, [("constexpr int kStages = 2;",
                               "constexpr int kStages = 3;")]),
    "flash_two_warpgroups": (FLASH, [("constexpr int kWarpgroups = 1;",
                                      "constexpr int kWarpgroups = 2;")]),
    "chunk": (CHUNK, []),
    "chunk_split128": (CHUNK, [("constexpr int kSplitKeys = 256;",
                                "constexpr int kSplitKeys = 128;")]),
    "chunk_split512": (CHUNK, [("constexpr int kSplitKeys = 256;",
                                "constexpr int kSplitKeys = 512;")]),
    "chunk_stages2": (CHUNK, [("constexpr int kStages = 3;",
                               "constexpr int kStages = 2;")]),
    "chunk_stages4": (CHUNK, [("constexpr int kStages = 3;",
                               "constexpr int kStages = 4;")]),
    "chunk_warps8": (CHUNK, [("constexpr int kWarps = 4;",
                              "constexpr int kWarps = 8;")]),
    # Where the time goes (wrong results): no product, no partials, no
    # merge.
    "chunk_loads_only": (CHUNK, [(
        "    // ---- S = Q K^T for 64 keys: 8 n-tiles of 8 keys ----",
        "    if (n_st > 0) continue;\n"
        "    // ---- S = Q K^T for 64 keys: 8 n-tiles of 8 keys ----")]),
    "chunk_no_publish": (CHUNK, [(
        "  // ---- several live splits: publish partials, the last CTA "
        "merges ----",
        "  return;\n  // ---- several live splits: publish partials, the "
        "last CTA merges ----")]),
    "chunk_no_merge": (CHUNK, [("  if (!last_flag) return;", "  return;")]),
    # bf16 at head_dim 128 on mma.sync, as int8 (the kernel runs wgmma).
    "chunk_mma_sync": (CHUNK, [(
        "static constexpr bool kWg = !kInt8 && HD == 128;",
        "static constexpr bool kWg = false;")]),
}


def build(names, workdir):
    sys.path.insert(0, str(ROOT))
    from aiko_services_tpu_torch.ops import _cuda
    jobs = {}
    for name in names:
        source, edits = VARIANTS[name]
        copy = workdir / name
        copy.mkdir(parents=True, exist_ok=True)
        shutil.copy(CSRC / "common.cuh", copy)
        text = (CSRC / source).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the edited line is not in {source}")
            text = text.replace(old, new)
        (copy / source).write_text(text)
        jobs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.COMPILE_FLAGS, "-shared", "-I", str(copy),
             str(copy / source), "-o", str(copy / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, job in jobs.items():
        output, _ = job.communicate()
        if job.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{output}")
        lib = ctypes.CDLL(str(workdir / name / "lib.so"))
        entry = ENTRIES[VARIANTS[name][0]]
        fn = getattr(lib, entry)
        fn.argtypes = _cuda.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def decode_cases(torch, llama, device):
    gen = torch.Generator(device=device).manual_seed(0)
    kv, group, hd = 8, 4, 128

    def paged(rows, int8, bs=16, live_keys=1280, width=4096):
        live = live_keys // bs
        n_blocks = max(rows * live, 4 * width // bs * 8) + 1
        k = torch.randn((n_blocks, bs, kv, hd), generator=gen, device=device)
        v = torch.randn((n_blocks, bs, kv, hd), generator=gen, device=device)
        scales = {}
        if int8:
            (k, ks), (v, vs) = llama._kv_quantize(k), llama._kv_quantize(v)
            scales = dict(ks=ks, vs=vs)
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        ids = torch.randperm(n_blocks - 1, generator=gen,
                             device=device)[:rows * live] + 1
        tables = torch.zeros((rows, width // bs), dtype=torch.int32,
                             device=device)
        tables[:, :live] = ids.to(torch.int32).reshape(rows, live)
        positions = torch.tensor([1100 + (37 * i) % 100 for i in range(rows)],
                                 dtype=torch.int32, device=device)
        q = torch.randn((rows, kv, group, hd), generator=gen,
                        device=device).to(torch.bfloat16)
        return q, k, v, tables, positions, scales

    bs, per_row = 128, 8
    k = torch.randn((8 * per_row, bs, kv, hd), generator=gen,
                    device=device).to(torch.bfloat16)
    v = torch.randn((8 * per_row, bs, kv, hd), generator=gen,
                    device=device).to(torch.bfloat16)
    tables = (torch.arange(8, dtype=torch.int32, device=device)[:, None]
              * per_row + torch.arange(per_row, dtype=torch.int32,
                                       device=device)[None, :])
    positions = torch.tensor([0, 127, 128, 300, 511, 640, 900, 1022],
                             dtype=torch.int32, device=device)
    q = torch.randn((8, kv, group, hd), generator=gen,
                    device=device).to(torch.bfloat16)
    return {"bs 16, 8 rows, bf16": paged(8, False),
            "bs 16, 8 rows, int8": paged(8, True),
            "bs 16, 64 rows, int8": paged(64, True),
            "bs 128, 8 rows, bf16": (q, k, v, tables, positions, {})}


def decode_call(torch, fn, case, device):
    q, k, v, tables, positions, scales = case
    out = torch.empty_like(q)
    partials = torch.empty(1 << 24, dtype=torch.float32, device=device)
    arrivals = torch.zeros(1 << 16, dtype=torch.int32, device=device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            scales["ks"].data_ptr() if scales else None,
            scales["vs"].data_ptr() if scales else None, tables.data_ptr(),
            positions.data_ptr(), out.data_ptr(), partials.data_ptr(),
            arrivals.data_ptr(), q.shape[0], q.shape[1], q.shape[2],
            q.shape[3], k.shape[1], tables.shape[1], 0, q.shape[3] ** -0.5,
            1, 2 if scales else 1,
            torch.cuda.current_stream().cuda_stream)

    def call():
        code = fn(*args)
        if code:
            raise RuntimeError(f"aiko_paged_decode: CUDA error {code}")
    call.scratch = (partials, arrivals)     # args hold only their addresses
    return call, out


def decode_want(paged_attention, case):
    q, k, v, tables, positions, scales = case
    pools = (k, v) if scales else (k.float(), v.float())
    return paged_attention.paged_decode_reference(q.float(), *pools, tables,
                                                  positions, **scales)


def flash_cases(torch, device):
    gen = torch.Generator(device=device).manual_seed(1)

    def qkv(batch, seq):
        return [torch.randn((batch, heads, seq, 128), generator=gen,
                            device=device).to(torch.bfloat16)
                for heads in (32, 8, 8)]
    return {f"b {b}, S {s}": qkv(b, s)
            for b, s in ((1, 64), (1, 256), (1, 1024), (1, 2048), (64, 128))}


def flash_call(torch, fn, case, device):
    q, k, v = case
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
            q.shape[3], ctypes.addressof(strides), 1, 0, q.shape[3] ** -0.5,
            torch.cuda.current_stream().cuda_stream)

    def call():
        code = fn(*args)
        if code:
            raise RuntimeError(f"aiko_flash_attention: CUDA error {code}")
    call.strides = strides      # args hold only its address
    return call, out


def flash_want(attention, case):
    q, k, v = case
    group = q.shape[1] // k.shape[1]
    return attention.attention_reference(
        q.float(), k.float().repeat_interleave(group, 1),
        v.float().repeat_interleave(group, 1))


def chunk_cases(torch, llama, device):
    """The smoke's chunk rows (chip_smoke.check_chunk and
    check_chunk_verify): (q, pool, tables, cached, chunk_lens, kv_limit)."""
    import chip_smoke
    gen = torch.Generator(device=device).manual_seed(2)
    cases = {}
    for quant_kv in (False, True):
        pool, tables = chip_smoke.paged_pool(torch, llama, device, gen,
                                             quant_kv)
        for cached, T in ((1024, 256), (1792, 16)):
            if quant_kv and T == 16:
                continue
            q = torch.randn((1, T, 8, 4, 128), generator=gen,
                            device=device).to(torch.bfloat16)
            meta = [torch.tensor([value], dtype=torch.int32, device=device)
                    for value in (cached, T)]
            cases[f"T {T} after {cached}, {'int8' if quant_kv else 'bf16'}"] \
                = (q, pool, tables, *meta, -(-(cached + T) // 16))
    pool, _ = chip_smoke.paged_pool(torch, llama, device, gen, False)
    starts = (1030, 1047, 1064, 1100, 1121, 1150, 1183, 1199, 0)
    tables = chip_smoke.ragged_tables(torch, pool, gen, len(starts),
                                      (max(starts) + 5) // 16 + 1)
    q = torch.randn((len(starts), 5, 8, 4, 128), generator=gen,
                    device=device).to(torch.bfloat16)
    cases["verify T 5, 8 rows + 1 idle, bf16"] = (
        q, pool, tables,
        torch.tensor(starts, dtype=torch.int32, device=device),
        torch.tensor((5,) * 8 + (0,), dtype=torch.int32, device=device),
        tables.shape[1])
    return cases


def chunk_call(torch, fn, case, device):
    q, pool, tables, cached, chunk, kv_blocks = case
    out = torch.empty_like(q)
    partials = torch.empty(1 << 25, dtype=torch.float32, device=device)
    arrivals = torch.zeros(1 << 16, dtype=torch.int32, device=device)
    quant_kv = "ks" in pool
    args = (q.data_ptr(), pool["k"].data_ptr(), pool["v"].data_ptr(),
            pool["ks"].data_ptr() if quant_kv else None,
            pool["vs"].data_ptr() if quant_kv else None, tables.data_ptr(),
            cached.data_ptr(), chunk.data_ptr(), out.data_ptr(),
            partials.data_ptr(), arrivals.data_ptr(), q.shape[0], q.shape[1],
            q.shape[2], q.shape[3], q.shape[4], pool["k"].shape[1],
            tables.shape[1], kv_blocks, 0,
            # partial slots a tile: every split at the smallest split size
            -(-kv_blocks * pool["k"].shape[1] // 128), q.shape[4] ** -0.5,
            2 if quant_kv else 1, torch.cuda.current_stream().cuda_stream)

    def call():
        code = fn(*args)
        if code:
            raise RuntimeError(f"aiko_chunk_attention: CUDA error {code}")
    call.scratch = (partials, arrivals)     # args hold only their addresses
    return call, out


def chunk_want(paged_prefill, case):
    import torch
    q, pool, tables, cached, chunk, _ = case
    plain = pool if "ks" in pool else {key: buf.float()
                                       for key, buf in pool.items()}
    want = paged_prefill.chunk_attention_reference(q.float(), plain, tables,
                                                   cached)
    live = chunk.bool()     # the idle row's output is zeros, not the plain
    return torch.where(live[:, None, None, None, None], want,
                       torch.zeros_like(want))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*", choices=[[], *VARIANTS],
                        metavar="NAME", help="variants (all by default)")
    names = parser.parse_args().names or list(VARIANTS)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.ops import (attention, paged_attention,
                                             paged_prefill)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build(names, ROOT / "_build" / "lab")
    device = torch.device("cuda", 0)
    for source, cases, call, want in (
            (DECODE, lambda: decode_cases(torch, llama, device),
             decode_call, lambda case: decode_want(paged_attention, case)),
            (FLASH, lambda: flash_cases(torch, device), flash_call,
             lambda case: flash_want(attention, case)),
            (CHUNK, lambda: chunk_cases(torch, llama, device), chunk_call,
             lambda case: chunk_want(paged_prefill, case))):
        order = [n for n in names if VARIANTS[n][0] == source]
        if not order:
            continue
        cases = cases()
        order += order[::-1]
        for title, case in cases.items():
            expected = want(case)
            results = []
            for name in order:
                run, out = call(torch, libs[name], case, device)
                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                _, ratio = chip_smoke.compare(out, expected)
                ms = min(chip_smoke.device_ms(torch, run, 20)
                         for _ in range(3))
                results.append(f"{name} {ms:.4f} ({ratio:.2f})")
            print(f"{source} {title}: " + " | ".join(results), flush=True)


if __name__ == "__main__":
    main()
