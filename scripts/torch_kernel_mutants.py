#!/usr/bin/env python3
"""Mutation check of the port's kernel tolerances, on the card.

Each mutant is a copy of ``aiko_services_tpu_torch`` with one deliberate
bug in a CUDA kernel: the flash kernel drops the last key tile of rows
that have more than one, gives that tile 0.9 of its weight, loads every K
tile one key late (an off-by-one TMA coordinate), or loads a group's Q
rows from the wrong query heads; the decode kernel's log-sum-exp merge
drops a row's last split, or gives it 0.9 of its weight; the paged
chunk-attention kernel stops zeroing masked probabilities, drops the last
live 16-row block of a tile's sweep, drops a tile's last split from its
merge, or gives that split 0.9 of its weight; the KV writer's ragged mode
writes at the block-aligned start (dropping ``cached % block_size``) or
skips each row's last live token, its int8 quantizer multiplies by the
scale's reciprocal instead of dividing by it, and its ragged and row modes
write an unaligned row one offset late; past the end of the table its row
mode keeps the offset on the slot's last block instead of dropping the
row, or drops a contiguous cache's row instead of clamping it; the int4
dequant-matmul swaps the two nibbles of a byte, reads nibbles as unsigned
(0..15), takes 128 for the magic number's bias (136), leaves x's B
fragment in its natural k order (not permuted to match the weights'), or
scales each group with its neighbour's scales, and its m-tiled instance
feeds bf16(q * s) to the product (scale first); the int8 dequant-matmul
drops the sign term of its integer-op conversion (bytes read as their low
seven bits), scales each column with its neighbour's scale, drops a tile's
last K slice from the split merge (weight_stream.cuh), or swaps k rows k
and k + 1 in its A fragments; the ring
all-gather step writes each block one row block too low, the ring
reduce-scatter drops the last step's partial, the ring's copies skip
the capacity wait, the ring step's TMA + wgmma path reads w (its B
operand) from the next stage of its ring, and its streamed-weight path's
last K slice never reaches the split merge; the contiguous cache's route
to the chunk kernels (``models/llama.py``) leaves an inactive slot's
``chunk_len`` at the window's width (it writes its rows), or hands the
kernels iota block tables shifted by one block; the LoRA delta gathers
each row's neighbour's adapter (``lora_ids_shifted``), and the speculative
round stops serializing on grammar-constrained rows, so a forced segment
is walked from an automaton state that in-flight rounds have moved past
(``forced_from_stale_state``).  Each copy is built and held to the same
checks the working tree passes: ``chip_smoke.py``'s phase 2 for that
kernel (at the llama3_8b shapes; phase 7 for the ring, phase 12's route
check for the contiguous route, phase 13's mixed-adapter server (c) and
structured rig (b) for the last two) and the matching tests in
``tests/test_torch_cuda.py``.
A mutant that passes either means a tolerance too loose to see the bug.

    python3 scripts/torch_kernel_mutants.py [--workdir DIR] [NAME ...]

With names, only those mutants are built and checked.

The copies go under ``--workdir`` (a new temporary directory by default),
never into the checkout.  Needs an NVIDIA card and ``nvcc``; exits
non-zero if any mutant survives.
"""

import argparse
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
FLASH = "aiko_services_tpu_torch/csrc/flash_attention.cu"
DECODE = "aiko_services_tpu_torch/csrc/paged_decode.cu"
CHUNK = "aiko_services_tpu_torch/csrc/paged_prefill.cu"
KV_WRITE = "aiko_services_tpu_torch/csrc/kv_write.cu"
INT4 = "aiko_services_tpu_torch/csrc/int4_matmul.cu"
INT8 = "aiko_services_tpu_torch/csrc/int8_matmul.cu"
WSTREAM = "aiko_services_tpu_torch/csrc/weight_stream.cuh"
RING = "aiko_services_tpu_torch/csrc/ring_matmul.cu"
RING_HOST = "aiko_services_tpu_torch/parallel/rdma_collective.py"
LLAMA = "aiko_services_tpu_torch/models/llama.py"
CONTINUOUS = "aiko_services_tpu_torch/orchestration/continuous.py"
#: name -> (source, text replaced, replacement)
MUTANTS = {
    "flash_drop_tile": (
        FLASH, "const int n_tiles = t_end - t_begin + 1;",
        "const int n_tiles = t_end - t_begin + (t_end > t_begin ? 0 : 1);"),
    "flash_weight_tile": (
        FLASH, "const float p = exp2_approx(s[i] - m_i[(i >> 1) & 1]);",
        "const float p = exp2_approx(s[i] - m_i[(i >> 1) & 1]) * "
        "(j == n_tiles - 1 && n_tiles > 1 ? 0.9f : 1.f);"),
    "flash_key_coordinate": (
        FLASH, "&k_map, &k_full[st],\n"
        "                      c * TK::kChunkCols, k0, kvh, b);",
        "&k_map, &k_full[st],\n"
        "                      c * TK::kChunkCols, k0 + 1, kvh, b);"),
    "flash_wrong_q_heads": (
        FLASH, "c * TQ::kChunkCols, kvh * group, q_first, b);",
        "c * TQ::kChunkCols, kvh * group + (group > 1), q_first, b);"),
    "decode_drop_split": (
        DECODE, "for (int sp = first_split; sp <= last_split; ++sp) {",
        "for (int sp = first_split; sp < last_split; ++sp) {"),
    "decode_weight_split": (
        DECODE,
        "const float w = __expf(__ldcg(part_m + sp * group + a) - big);",
        "const float w = __expf(__ldcg(part_m + sp * group + a) - big) * "
        "(sp == last_split ? 0.9f : 1.f);"),
    "chunk_no_zero": (
        CHUNK, "const float p = (visible >> (nt * 4 + e)) & 1u",
        "const float p = true"),
    "chunk_drop_block": (
        CHUNK, "  const int first_split = key_lo / split_keys;",
        "  if (key_hi / block_size > key_lo / block_size)\n"
        "    key_hi = key_hi / block_size * block_size - 1;\n"
        "  const int first_split = key_lo / split_keys;"),
    "chunk_drop_split": (
        CHUNK, "    fold(acc, total, v, m_sp, l_sp, big);",
        "    if (sp < n_live - 1) fold(acc, total, v, m_sp, l_sp, big);"),
    "chunk_weight_split": (
        CHUNK, "const float m_sp[2] = {part_ml(sp, 0, 0), part_ml(sp, 0, 1)};",
        "const float drift = sp == n_live - 1 ? 0.152f : 0.f;  // x0.9\n"
        "    const float m_sp[2] = {part_ml(sp, 0, 0) - drift,\n"
        "                           part_ml(sp, 0, 1) - drift};"),
    "ragged_aligned_start": (
        KV_WRITE, "    entry = (cached + token) / block_size;\n"
        "    offset = (cached + token) % block_size;",
        "    entry = cached / block_size + token / block_size;\n"
        "    offset = token % block_size;"),
    "ragged_skip_last": (
        KV_WRITE, "if (token >= chunk_lens[row]) return;",
        "if (token >= chunk_lens[row] - 1) return;"),
    "kvwrite_reciprocal_scale": (
        KV_WRITE, "__float2int_rn(__fdiv_rn(f[4 * w + b], scale))",
        "__float2int_rn(f[4 * w + b] * (1.f / scale))"),
    "kvwrite_late_row": (
        KV_WRITE, "    offset = (cached + token) % block_size;",
        "    offset = (cached + token) % block_size;\n"
        "    if (offset != 0 && offset < block_size - 1) ++offset;"),
    "kvwrite_rows_late_row": (
        KV_WRITE, "    offset = pos % block_size;",
        "    offset = pos % block_size;\n"
        "    if (offset != 0 && offset < block_size - 1) ++offset;"),
    "kvwrite_rows_wrap": (
        KV_WRITE, "    if (pos > last) return;                   "
        "// past the pool's table\n", ""),
    "kvwrite_rows_no_clamp": (
        KV_WRITE, "clamp_rows ? min(cached, last) : cached", "cached"),
    "int4_nibble_swap": (
        INT4, "lo0 = nibbles_to_bf16x2(p), hi0 = nibbles_to_bf16x2(p >> 4);",
        "lo0 = nibbles_to_bf16x2(p >> 4), hi0 = nibbles_to_bf16x2(p);"),
    "int4_unsigned": (
        INT4, "return bf16x2_fma((v & 0x000f000fu) ^ kMagic, kOne, kMinus136);",
        "return bf16x2_fma((v & 0x000f000fu) | 0x43004300u, kOne, "
        "0xC300C300u);"),
    "int4_magic_bias": (
        INT4, "constexpr unsigned kMinus136 = 0xC308C308u;",
        "constexpr unsigned kMinus136 = 0xC300C300u;"),
    "int4_k_unpermuted": (
        INT4, "const unsigned b0 = __byte_perm(xa, xb, 0x5410);\n"
        "        const unsigned b1 = __byte_perm(xa, xb, 0x7632);",
        "const unsigned b0 = xa;\n        const unsigned b1 = xb;"),
    "int4_neighbour_scale": (
        INT4, "s + (size_t)(k0 / group) * N + n0, cols * 4,",
        "s + (size_t)((k0 / group + 1) % (K / group)) * N + n0, cols * 4,"),
    "int4_tiled_scale_first": (
        INT4, "return launch<64, false>(x, q4, s, out, partials, arrivals, m, "
        "K, N, group,",
        "return launch<64, true>(x, q4, s, out, partials, arrivals, m, K, N, "
        "group,"),
    "int8_sign_dropped": (
        INT8, "    a[t][0] = aiko::int8x2_to_bf16x2(__byte_perm(w0, w1, even));\n"
        "    a[t][1] = aiko::int8x2_to_bf16x2(__byte_perm(w0, w1, odd));\n"
        "    a[t][2] = aiko::int8x2_to_bf16x2(__byte_perm(w8, w9, even));\n"
        "    a[t][3] = aiko::int8x2_to_bf16x2(__byte_perm(w8, w9, odd));",
        "    auto low7 = [](unsigned v) {\n"
        "      unsigned d;\n"
        "      asm(\"sub.rn.bf16x2 %0, %1, %2;\\n\" : \"=r\"(d)\n"
        "          : \"r\"((v & 0x007f007fu) | 0x43004300u), "
        "\"r\"(0x43004300u));\n"
        "      return d;\n"
        "    };\n"
        "    a[t][0] = low7(__byte_perm(w0, w1, even));\n"
        "    a[t][1] = low7(__byte_perm(w0, w1, odd));\n"
        "    a[t][2] = low7(__byte_perm(w8, w9, even));\n"
        "    a[t][3] = low7(__byte_perm(w8, w9, odd));"),
    "int8_neighbour_scale": (
        INT8, "*reinterpret_cast<const float4*>(s + n0 + c4)",
        "*reinterpret_cast<const float4*>(s + (n0 + c4 + 4) % N)"),
    "int8_drop_slice": (
        WSTREAM, "        if (sp0 + j < splits)\n#pragma unroll\n"
        "          for (int e = 0; e < kPass; ++e) {",
        "        if (sp0 + j < splits - 1)\n#pragma unroll\n"
        "          for (int e = 0; e < kPass; ++e) {"),
    "int8_k_order": (
        INT8, "const unsigned even = 0x0400u + 0x0101u * (2 * t);",
        "const unsigned even = 0x0004u + 0x0101u * (2 * t);"),
    "ag_wrong_row_offset": (
        RING, "const size_t out_offset = (size_t)out_row0 * n_local;",
        "const size_t out_offset =\n"
        "      (size_t)(out_row0 ? out_row0 - m_local : 0) * n_local;"),
    "ring_wgmma_b_stage": (
        RING, "aiko::make_desc(b_stage(st) + kk * 16 * 128, kBoxBytes,",
        "aiko::make_desc(b_stage((st + 1) % kStages) + kk * 16 * 128, "
        "kBoxBytes,"),
    "ring_merge_drops_slice": (
        RING, "  __syncthreads();\n  if (splits > 1 &&\n",
        "  __syncthreads();\n  if (split == splits - 1 && splits > 1) {\n"
        "    for (int i = tid; i < MR * kNT; i += kThreads) red[i] = 0.f;\n"
        "    __syncthreads();\n  }\n  if (splits > 1 &&\n"),
    "rs_drop_last_partial": (
        RING_HOST, "if len(op.reads) == 2:",
        "if len(op.reads) == 2 and op.writes[0][0] != \"out\":"),
    "ring_no_capacity_wait": (
        RING_HOST, "for event in op.waits + op.capacity:",
        "for event in op.waits:"),
    "contig_inactive_writes": (
        LLAMA, "append_kv_ragged(k.contiguous(), v.contiguous(), pool, "
        "tables, starts,\n                     chunk_lens)",
        "append_kv_ragged(k.contiguous(), v.contiguous(), pool, "
        "tables, starts,\n                     torch.full_like(chunk_lens, "
        "k.shape[1]))"),
    "contig_tables_shifted": (
        LLAMA, "tables = _iota(batch * blocks_per_row, device, torch.int32) "
        "\\\n        .reshape(batch, blocks_per_row)",
        "tables = ((_iota(batch * blocks_per_row, device, torch.int32) + 1)"
        "\n              % (batch * blocks_per_row)).reshape(batch, "
        "blocks_per_row)"),
    "lora_ids_shifted": (
        LLAMA, "    ids = ids.to(torch.int64)\n",
        "    ids = ids.to(torch.int64).roll(1)\n"),
    "forced_from_stale_state": (
        CONTINUOUS, "if (mode == \"ngram\" or cons_live is not None) and "
        "self._ring:",
        "if mode == \"ngram\" and cons_live is None and self._ring:"),
}
#: mutant prefix -> the kernel's tests in tests/test_torch_cuda.py (-k)
SELECTION = {"flash": "flash_attention", "decode": "paged_decode",
             "chunk": "chunk_attention", "ragged": "ragged",
             "kvwrite": "append or write_kv", "int4": "int4",
             "int8": "int8",
             "ag": "ring", "rs": "ring", "ring": "ring",
             "contig": "degenerate", "lora": "adapter",
             "forced": "constrained"}


def make_copy(name: str, workdir: pathlib.Path) -> pathlib.Path:
    copy = workdir / name
    shutil.copytree(ROOT / "aiko_services_tpu_torch",
                    copy / "aiko_services_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (copy / "tests").mkdir()
    for path in ("chip_smoke.py", "pyproject.toml", "tests/__init__.py",
                 "tests/test_torch_cuda.py"):
        shutil.copy2(ROOT / path, copy / path)
    source, old, new = MUTANTS[name]
    text = (copy / source).read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: the mutated line is not in {source}")
    (copy / source).write_text(text.replace(old, new))
    return copy


def phase2(name: str) -> bool:
    """Run in a mutant's copy: the smoke's phase 2 (the ring: phase 7)
    for the mutated kernel, every case; True if at least one case
    failed."""
    sys.path.insert(0, str(pathlib.Path.cwd()))
    import torch

    import chip_smoke
    from aiko_services_tpu_torch import parallel
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.ops import (_cuda, attention,
                                             paged_attention, paged_prefill,
                                             quant)
    failures = []
    chip_smoke.fail = failures.append       # record and go on to every case
    _cuda.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = name.split("_")[0]
    if kind == "flash":
        rows, worst, _ = chip_smoke.check_flash(torch, attention, device)
    elif kind == "decode":
        rows, worst, _ = chip_smoke.check_decode(torch, paged_attention,
                                                 llama, device)
        paged_rows, paged_worst = chip_smoke.check_decode_paged(
            torch, paged_attention, llama, device)
        rows, worst = rows + paged_rows, max(worst, paged_worst)
    elif kind == "int4":
        rows, worst, _ = chip_smoke.check_int4_matmul(
            torch, quant, device, llama.CONFIGS["llama3_8b"])
    elif kind == "int8":
        rows, worst, _ = chip_smoke.check_int8_matmul(
            torch, quant, device, llama.CONFIGS["llama3_8b"])
    elif kind in ("ag", "rs", "ring"):
        rows, _, _ = chip_smoke.check_ring(torch, parallel, device)
        worst = max(row["ratio"] for row in rows)
    elif kind == "contig":
        rows, worst = chip_smoke.check_contiguous_chunk(torch, llama, device)
    elif kind in ("lora", "forced"):
        import numpy as np

        from aiko_services_tpu_torch.orchestration.continuous import (
            DecodeRequest)
        from aiko_services_tpu_torch.orchestration.paged import (
            PagedContinuousServer)
        params = llama.random_quantized_params(llama.CONFIGS["llama3_8b"],
                                               seed=0, device=device)
        kernels = (quant.int8_matmul, attention.flash_attention,
                   paged_attention.paged_decode_attention,
                   paged_prefill.write_kv_rows, paged_prefill.append_kv,
                   paged_prefill.chunk_attention,
                   paged_prefill.append_kv_ragged)
        try:
            chip_smoke.serve_grammar_lora_phase(
                torch, np, llama, kernels, PagedContinuousServer,
                DecodeRequest, params, device, chip_smoke.Weights(quant, 8),
                parts=("adapters",) if kind == "lora" else ("structured",))
        except Exception as error:  # noqa: BLE001 - the bug broke the run
            failures.append(repr(error))
        rows, worst = [], 0.0
    elif kind in ("ragged", "kvwrite"):
        # Byte-equality checks: the rows' max abs error is the measure.
        rows, _ = chip_smoke.check_append_ragged(torch, paged_prefill, llama,
                                                 device)
        if kind == "kvwrite":
            rows += chip_smoke.check_append(torch, paged_prefill, llama,
                                            device)[0]
            rows += chip_smoke.check_write_kv_rows(torch, paged_prefill,
                                                   llama, device)[0]
        worst = max(row["err"] for row in rows)
    else:
        rows, worst, _ = chip_smoke.check_chunk(torch, paged_prefill, llama,
                                                device)
    measure = "max abs err" if kind in ("ragged", "kvwrite") else "err/tol"
    phase = {"ag": "7", "rs": "7", "ring": "7", "contig": "12",
             "lora": "13 (c)", "forced": "13 (b)"}.get(kind, "2")
    print(f"{name}: smoke phase {phase} reported {len(failures)} failures over "
          f"{len(rows)} cases, worst {measure} {worst:.3f}")
    for row in rows:
        print(f"  {row['shape']}: max_abs_err {row['err']:.4g} err/tol "
              f"{row['ratio']:.3f}")
    return bool(failures)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workdir", type=pathlib.Path)
    parser.add_argument("names", nargs="*", choices=[[], *sorted(MUTANTS)],
                        metavar="NAME", help="mutants to check (all by "
                        "default)")
    parser.add_argument("--phase2", choices=sorted(MUTANTS),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.phase2:
        sys.exit(0 if phase2(args.phase2) else 1)
    workdir = args.workdir or pathlib.Path(tempfile.mkdtemp(prefix="mutants"))
    workdir.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    survivors = []
    names = args.names or list(MUTANTS)
    for name in names:
        copy = make_copy(name, workdir)
        caught = subprocess.run([sys.executable, str(pathlib.Path(__file__)
                                                     .resolve()),
                                 "--phase2", name], cwd=copy).returncode == 0
        selected = SELECTION[name.split("_")[0]]
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
             "-q", "-p", "no:cacheprovider", "tests/test_torch_cuda.py",
             "-k", selected], cwd=copy, capture_output=True, text=True)
        summary = (tests.stdout.strip().splitlines() or ["no output"])[-1]
        print(f"{name}: tests/test_torch_cuda.py -k {selected}: {summary}",
              flush=True)
        if not caught or tests.returncode == 0:
            survivors.append(name)
        shutil.rmtree(copy)
    if survivors:
        raise SystemExit(f"mutants not caught: {survivors}")
    print(f"all {len(names)} mutants caught")


if __name__ == "__main__":
    main()
