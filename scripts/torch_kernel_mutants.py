#!/usr/bin/env python3
"""Mutation check of the port's attention-kernel tolerances, on the card.

Each mutant is a copy of ``aiko_services_tpu_torch`` with one deliberate
bug in a CUDA kernel: the flash kernel drops the last key tile of rows
that have more than one, or gives that tile 0.9 of its weight; the decode
kernel's log-sum-exp merge drops a row's last live block, or gives it 0.9
of its weight; the paged chunk-attention kernel stops zeroing masked
probabilities, or drops the last live 16-row block of a tile's sweep; the
ragged verify-window append writes at the block-aligned start (dropping
``cached % block_size``), or skips each row's last live token; the int4
dequant-matmul swaps the two nibbles of each byte, reads nibbles as
unsigned (0..15), or scales each group with its neighbour's scales.  Each copy
is built and held to the same checks the working tree passes:
``chip_smoke.py``'s phase 2 for that kernel (at the llama3_8b shapes) and
the kernel's tests in ``tests/test_torch_cuda.py``.
A mutant that passes either means a tolerance too loose to see the bug.

    python3 scripts/torch_kernel_mutants.py [--workdir DIR]

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
RAGGED = "aiko_services_tpu_torch/csrc/paged_append_ragged.cu"
INT4 = "aiko_services_tpu_torch/csrc/int4_matmul.cu"
#: name -> (source, text replaced, replacement)
MUTANTS = {
    "flash_drop_tile": (
        FLASH, "const int n_tiles = t_end - t_begin + 1;",
        "const int n_tiles = t_end - t_begin + (t_end > t_begin ? 0 : 1);"),
    "flash_weight_tile": (
        FLASH, "const float p = __expf(s[nt][e] - m_i[e >> 1]);",
        "const float p = __expf(s[nt][e] - m_i[e >> 1]) * "
        "(i == n_tiles - 1 && n_tiles > 1 ? 0.9f : 1.f);"),
    "decode_drop_block": (
        DECODE, "for (int sp = 0; sp < n_live; ++sp) {",
        "for (int sp = 0; sp < n_live - (n_live > 1); ++sp) {"),
    "decode_weight_block": (
        DECODE,
        "const float w = __expf(__ldcg(part_m + sp * group + g) - big);",
        "const float w = __expf(__ldcg(part_m + sp * group + g) - big) * "
        "(sp == n_live - 1 && n_live > 1 ? 0.9f : 1.f);"),
    "chunk_no_zero": (
        CHUNK, "const float p = (visible >> (nt * 4 + e)) & 1u",
        "const float p = true"),
    "chunk_drop_block": (
        CHUNK, "const int t_begin = key_lo / kBK;",
        "if (key_hi / block_size > key_lo / block_size)\n"
        "    key_hi = key_hi / block_size * block_size - 1;\n"
        "  const int t_begin = key_lo / kBK;"),
    "ragged_aligned_start": (
        RAGGED, "const int pos = cached_lens[row] + token;",
        "const int pos = cached_lens[row] / block_size * block_size + token;"),
    "ragged_skip_last": (
        RAGGED, "if (token >= chunk_lens[row]) return;",
        "if (token >= chunk_lens[row] - 1) return;"),
    "int4_nibble_swap": (
        INT4, "static_cast<unsigned>(word) << (28 - shift)) >> 28);",
        "static_cast<unsigned>(word) << (28 - (shift ^ 4))) >> 28);"),
    "int4_unsigned": (
        INT4, "static_cast<int>(static_cast<unsigned>(word) << (28 - shift)) "
        ">> 28);",
        "(static_cast<unsigned>(word) << (28 - shift)) >> 28);"),
    "int4_neighbour_scale": (
        INT4, "s + (size_t)(k0 / group) * N + n0 + chunk * 4, true);",
        "s + (size_t)((k0 / group + 1) % (K / group)) * N + n0 + chunk * 4, "
        "true);"),
}
#: mutant prefix -> the kernel's tests in tests/test_torch_cuda.py (-k)
SELECTION = {"flash": "flash_attention", "decode": "paged_decode",
             "chunk": "chunk_attention", "ragged": "ragged", "int4": "int4"}


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
    """Run in a mutant's copy: the smoke's phase 2 for the mutated
    kernel, every case; True if at least one case failed."""
    sys.path.insert(0, str(pathlib.Path.cwd()))
    import torch

    import chip_smoke
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
    elif kind == "int4":
        rows, worst, _ = chip_smoke.check_int4_matmul(
            torch, quant, device, llama.CONFIGS["llama3_8b"])
    elif kind == "ragged":
        # A byte-equality check: the rows' max abs error is the measure.
        rows, _ = chip_smoke.check_append_ragged(torch, paged_prefill, llama,
                                                 device)
        worst = max(row["err"] for row in rows)
    else:
        rows, worst, _ = chip_smoke.check_chunk(torch, paged_prefill, llama,
                                                device)
    measure = "max abs err" if kind == "ragged" else "err/tol"
    print(f"{name}: smoke phase 2 reported {len(failures)} failures over "
          f"{len(rows)} cases, worst {measure} {worst:.3f}")
    for row in rows:
        print(f"  {row['shape']}: max_abs_err {row['err']:.4g} err/tol "
              f"{row['ratio']:.3f}")
    return bool(failures)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workdir", type=pathlib.Path)
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
    for name in MUTANTS:
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
    print(f"all {len(MUTANTS)} mutants caught")


if __name__ == "__main__":
    main()
