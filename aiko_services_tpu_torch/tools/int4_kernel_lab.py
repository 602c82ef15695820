"""Kernel lab: race the int4 dequant-matmul's two numerics on the card.

Port of ``scripts/int4_kernel_lab.py``.  The TPU lab raced Pallas
structures; here both of its variants are instances of one CUDA kernel,
``csrc/int4_matmul.cu``: ``batched`` (scale after each group, the serving
path's ``int4_matmul``) and ``repeat`` (``bf16(q * s)`` operands,
``int4_matmul_scale_first``), with the int8 kernel as the yardstick.
Times are CUDA events around back-to-back launches queued behind a
device-side sleep; the weights rotate through copies that exceed the
50 MB L2, as a decode step finds them.

``--builds`` races copies of the scale-after instance built apart into
``_build/lab`` (nvcc, the port's flags), in turns (the list, then
reversed), at the lab's shapes and every ``--m``: ``kernel`` (the
source as it is), ``floor`` (the source edited so that every byte
streams as before but the raw packed words feed the product instead of
the dequantized nibbles: its time is the load floor of the kernel's
structure), ``wgmma`` (``scripts/lab_kernels/int4_matmul_wgmma.cu``:
the same kernel with its product on wgmma, the dequantized weight as A
from registers and x as B from shared memory), with ``--probes`` the
other edited copies of :data:`PROBES`, and with ``--compare DIR``,
``other`` (the kernel built from another ``csrc`` directory, e.g. the
parent commit's, split K as the 64-column kernels did
(:data:`COMPARE_RULE`) unless ``--compare-rule`` says otherwise; with
``--probes`` also its probes).  ``--int8``
races the int8 kernel (``csrc/int8_matmul.cu``) the same way at
:data:`INT8_SHAPES`, with ``wgmma`` and ``mma_sync`` (one product at every
instance: :data:`INT8_PRODUCTS`) in place of the int4 variant, and
``--bits`` checks that builds give the same bits; ``--sass`` prints each
build's conversion instructions, in all and in the main loop.

    python -m aiko_services_tpu_torch.tools.int4_kernel_lab
    python -m aiko_services_tpu_torch.tools.int4_kernel_lab --one repeat 8192 1024
    python -m aiko_services_tpu_torch.tools.int4_kernel_lab --builds --m 8 40 64
    python -m aiko_services_tpu_torch.tools.int4_kernel_lab --builds --int8 \
        --m 1 8 40 64 --probes --sass [--compare DIR]

``--device cpu`` only validates the numerics (the plain versions); there
is no timing off the card.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import pathlib
import re
import shutil
import subprocess
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _cuda, quant

#: The lab's shapes: (K, N) of w_gate/w_up, w_down and wq/wo at m = 64.
SHAPES = ((4096, 14336), (14336, 4096), (4096, 4096))
VARIANTS: Dict[str, Callable] = {"batched": quant.int4_matmul,
                                 "repeat": quant.int4_matmul_scale_first}
PLAIN: Dict[str, Callable] = {
    "batched": quant.int4_matmul_reference,
    "repeat": quant.int4_matmul_scale_first_reference}


def _operands(k: int, n: int, m: int, device: torch.device):
    """The lab's inputs: gaussian weights (0.02) quantized to int4 (groups
    of 128) and int8, bf16 activations; numpy's generator, seed 0."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.normal(size=(k, n)) * 0.02)
                         .astype(np.float32)).to(device)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)) \
        .to(device).to(torch.bfloat16)
    return x, quant.quantize_int4(w, 128), quant.quantize_int8(w)


def _device_seconds(fn: Callable[[int], object], reps: int) -> float:
    """Card time of one ``fn(i)``: CUDA events around ``reps`` calls
    queued behind a ~50 ms device-side sleep."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def _copies(tree: Dict[str, torch.Tensor], k: int, n: int):
    """Enough copies of a weight to exceed the 50 MB L2 (256 MB)."""
    count = max(1, math.ceil(256e6 / (k * n // 2)))
    return [{key: value.clone() for key, value in tree.items()}
            for _ in range(count)]


def race_one(variant: str, k: int, n: int, m: int = 64,
             device=None, reps: int = 50) -> Dict[str, Optional[float]]:
    """Validate and time ONE variant at (m, K, N): max error over the
    output's largest magnitude against its own plain version (must be
    < 0.05, the lab's rule), and microseconds a call on the card (None
    off the card)."""
    device = resolve_device(device)
    x, q4, _ = _operands(k, n, m, device)
    fn, plain = VARIANTS[variant], PLAIN[variant]
    want = plain(x.float(), q4["q4"], q4["s"]).float()
    got = fn(x, q4["q4"], q4["s"]).float()
    err = float((got - want).abs().max() / want.abs().max())
    if not err < 0.05:
        raise AssertionError(f"{variant} K={k} N={n}: wrong numerics, "
                             f"relative error {err}")
    result = dict(variant=variant, k=k, n=n, m=m, rel_err=err, us=None,
                  gbs=None)
    if device.type == "cuda":
        ring = _copies(q4, k, n)
        seconds = _device_seconds(
            lambda i: fn(x, ring[i % len(ring)]["q4"], ring[i % len(ring)]
                         ["s"]), reps)
        result.update(us=seconds * 1e6, gbs=k * n / 2 / seconds / 1e9)
    return result


def race(k: int, n: int, m: int = 64, device=None, reps: int = 50):
    """Every variant and the int8 kernel at (m, K, N); prints one line
    each (microseconds a call, GB/s of int4 weight bytes)."""
    device = resolve_device(device)
    print(f"shape K={k} N={n} m={m}")
    rows = []
    if device.type == "cuda":
        x, _, q8 = _operands(k, n, m, device)
        ring = _copies(q8, k, n)
        seconds = _device_seconds(
            lambda i: quant.int8_matmul(x, ring[i % len(ring)]["q"],
                                        ring[i % len(ring)]["s"]), reps)
        print(f"  {'int8 kernel (ref)':28s} {seconds * 1e6:7.1f} us  "
              f"{k * n / 2 / seconds / 1e9:6.0f} GB/s(int4)")
        rows.append(dict(variant="int8", k=k, n=n, m=m, rel_err=None,
                         us=seconds * 1e6, gbs=k * n / 2 / seconds / 1e9))
    for variant in VARIANTS:
        row = race_one(variant, k, n, m, device, reps)
        label = f"int4 {variant} ({'scale after' if variant == 'batched' else 'scale first'})"
        if row["us"] is None:
            print(f"  {label:28s} rel err {row['rel_err']:.2e} (not timed "
                  "off the card)")
        else:
            print(f"  {label:28s} {row['us']:7.1f} us  {row['gbs']:6.0f} "
                  f"GB/s(int4)  rel err {row['rel_err']:.2e}")
        rows.append(row)
    return rows


#: Edited copies of a kernel that show where its time goes (wrong
#: results, timed only): kind -> label -> alternatives, each a list of
#: (text, replacement); a copy takes the first alternative whose texts all
#: occur once in its source, so one probe serves the kernel and the
#: 64-column structure that preceded it (``--compare`` trees).  ``floor``
#: keeps every load and feeds the raw weight words to the product;
#: ``no_mma`` compiles the product out, and with it the fragment loads and
#: the conversion that only feed it (the ring's copies alone);
#: ``no_merge`` skips the split-K merge (each slice stores its own sums).
PROBES = {"int4": {
    "floor": [[("    const unsigned lo0 = nibbles_to_bf16x2(p), hi0 = "
                "nibbles_to_bf16x2(p >> 4);\n"
                "    const unsigned lo1 = nibbles_to_bf16x2(p >> 8);\n"
                "    const unsigned hi1 = nibbles_to_bf16x2(p >> 12);",
                "    const unsigned lo0 = p, hi0 = p >> 4;\n"
                "    const unsigned lo1 = p >> 8, hi1 = p >> 12;")]],
    "no_merge": [[("  if (splits > 1) {\n    if (!merge_slices<MR,",
                   "  if (false) {\n    if (!merge_slices<MR,")],
                 [("  if (splits > 1) {\n    // Publish",
                   "  if (false) {\n    // Publish")]],
    "no_mma": [[("          aiko::mma_bf16_16816(kScaleFirst ? acc[t][mt] "
                 ": part[t][mt],",
                 "          if (MR < 0) aiko::mma_bf16_16816(kScaleFirst ? "
                 "acc[t][mt] : part[t][mt],")]],
    "no_x": [[("    stage_x<MR>(smem + slot * kStageBytes + kWBytes + kSBytes, x, "
                "m, K, k0,\n                k_end);", "")],
             [("    for (int i = tid; i < MR * 8; i += kThreads) {",
               "    for (int i = tid; i < 0; i += kThreads) {")]],
}, "int8": {
    "floor": [
        [("    a[t][0] = aiko::int8x2_to_bf16x2(__byte_perm(w0, w1, even));\n"
          "    a[t][1] = aiko::int8x2_to_bf16x2(__byte_perm(w0, w1, odd));\n"
          "    a[t][2] = aiko::int8x2_to_bf16x2(__byte_perm(w8, w9, even));\n"
          "    a[t][3] = aiko::int8x2_to_bf16x2(__byte_perm(w8, w9, odd));",
          "    a[t][0] = t ? w1 : w0;\n    a[t][1] = t ? w0 : w1;\n"
          "    a[t][2] = t ? w9 : w8;\n    a[t][3] = t ? w8 : w9;")],
        [("  return aiko::pack_bf16x2(\n"
          "      static_cast<float>(static_cast<signed char>(word_lo >> "
          "(8 * byte))),\n"
          "      static_cast<float>(static_cast<signed char>(word_hi >> "
          "(8 * byte))));",
          "  return byte & 1 ? word_hi : word_lo;")]],
    "no_mma": [
        [("aiko::mma_bf16_16816(acc[t][mt], a[t][0],",
          "if (MR < 0) aiko::mma_bf16_16816(acc[t][mt], a[t][0],"),
         ("aiko::WgmmaRS<MR>::run(acc[t],",
          "if (MR < 0) aiko::WgmmaRS<MR>::run(acc[t],")],
        [("aiko::mma_bf16_16816(acc[t][mt], a[t][0],",
          "if (MR < 0) aiko::mma_bf16_16816(acc[t][mt], a[t][0],")]],
    "no_merge": [
        [("if (splits > 1 && !merge_slices<MR,",
          "if (false && !merge_slices<MR,")],
        [("  if (splits > 1) {\n    // Publish",
          "  if (false) {\n    // Publish")]],
}}

#: The split merge's arrival (weight_stream.cuh) and its fenced form.
ARRIVAL = """  __syncthreads();
  if (tid == 0) {
    int arrived;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\\n"
                 : "=r"(arrived)
                 : "l"(arrivals + tile)
                 : "memory");
    last_flag = arrived == splits - 1;
  }
  __syncthreads();
  if (!last_flag) return false;
"""
FENCED_ARRIVAL = """  __threadfence();
  __syncthreads();
  if (tid == 0) last_flag = atomicAdd(arrivals + tile, 1) == splits - 1;
  __syncthreads();
  if (!last_flag) return false;
  __threadfence();
"""

#: Edited copies that stay right (held to the lab's error rule), each a
#: design choice of the kernel taken the other way, raced with
#: ``--tunings``: kind -> label -> (alternatives as in :data:`PROBES`, the
#: K split ``(cols, CTAs an SM, one wave)`` or None for the tree's own).
TUNINGS = {"int4": {}, "int8": {
    # A 224 KB ring budget (three CTAs of the 8- and 16-row instances
    # then hold four stages, not three).
    "ring224": ([[("static constexpr int kBudget = 210 * 1024",
                   "static constexpr int kBudget = 224 * 1024")]], None),
    # 16 float4 merge loads in flight at every instance (8 below MR = 32).
    "merge16": ([[("constexpr int kMergeLoadsOf = MR >= 32 ? 16 : 8;",
                   "constexpr int kMergeLoadsOf = 16;")]], None),
    # Two CTAs an SM at every instance (deeper rings).
    "ctas2": ([[("  return mr <= 16 ? 3 : 2;", "  return 2;")]], None),
    # K split for three CTAs an SM (more, shorter slices).
    "split3": ([], (256, 3, True)),
    # 12 or 16 float4 merge loads in flight at MR = 8 (6 or 8 slices at
    # once).
    "merge12": ([[("constexpr int kMergeLoadsOf = MR >= 32 ? 16 : 8;",
                   "constexpr int kMergeLoadsOf = MR >= 32 ? 16 : MR == 8 ? "
                   "12 : 8;")]], None),
    "merge16_8": ([[("constexpr int kMergeLoadsOf = MR >= 32 ? 16 : 8;",
                     "constexpr int kMergeLoadsOf = MR >= 32 || MR == 8 ? 16 "
                     ": 8;")]], None),
    # The 8-row instance under three CTAs' register cap (80), not 64.
    "regs80": ([[("  return mr <= 8 ? 4 : ctas_per_sm(mr);",
                  "  return ctas_per_sm(mr);")]], None),
    # The merge's arrival as a fence in every thread and a relaxed atomic
    # (in place of one acquire-release atomic).
    "fences": ([[(ARRIVAL, FENCED_ARRIVAL)]], None),
}}


#: The lab's whole variants of the kernels (int4's ``wgmma``).
LAB_KERNELS = pathlib.Path(__file__).resolve().parents[2] / "scripts" \
    / "lab_kernels"
#: int8's products, one at every instance (the kernel runs wgmma at 64
#: rows and mma.sync below): label -> alternatives as in :data:`PROBES`.
INT8_PRODUCTS = {
    "wgmma": [[("  return mr == 64;\n}", "  return true;\n}")]],
    "mma_sync": [[("  return mr == 64;\n}", "  return false;\n}")]]}
#: kind -> (source in csrc, C entry, the other product: the lab's variant
#: source, or labelled edits of the kernel).
KINDS = {"int4": ("int4_matmul.cu", "aiko_int4_matmul",
                  LAB_KERNELS / "int4_matmul_wgmma.cu"),
         "int8": ("int8_matmul.cu", "aiko_int8_matmul", INT8_PRODUCTS)}
#: The int8 kernel's shapes: the lab's three, wk/wv and the LM head.
INT8_SHAPES = SHAPES + ((4096, 1024), (4096, 128256))
#: The K split of the 64-column kernels (the first int8 and int4 kernels,
#: before their 256-column redesigns): 64-column tiles, about two CTAs an
#: SM, rounded up (not one wave).
COMPARE_RULE = (64, 2, False)


def _apply(label: str, texts: Dict[str, str], alternatives):
    """Apply the first alternative whose every text occurs once in one of
    ``texts`` (file name -> source: the kernel and its headers), in
    place."""
    for edits in alternatives:
        homes = [[name for name, text in texts.items() if text.count(old) == 1
                  and all(other.count(old) == 0 for key, other in
                          texts.items() if key != name)]
                 for old, _ in edits]
        if all(len(home) == 1 for home in homes):
            for (old, new), (name,) in zip(edits, homes):
                texts[name] = texts[name].replace(old, new)
            return
    raise SystemExit(f"{label}: the edited text is not in the source")


def build_variant(label: str, csrc: pathlib.Path, edits=(),
                  source: Optional[pathlib.Path] = None,
                  kind: str = "int4") -> Callable:
    """The C entry of ``kind``'s kernel source in ``csrc`` (or of
    ``source``), with ``csrc``'s headers, built alone with the port's nvcc
    flags and the ``edits`` (alternatives, see :data:`PROBES`; each text is
    edited in the one file that holds it) into
    ``_build/lab/<kind>_<label>``; bound with ctypes.  The library's path
    is the function's ``library`` attribute."""
    name, entry, _ = KINDS[kind]
    work = _cuda.BUILD_DIR / "lab" / f"{kind}_{label}"
    work.mkdir(parents=True, exist_ok=True)
    texts = {header.name: header.read_text()
             for header in pathlib.Path(csrc).glob("*.cuh")}
    texts[name] = pathlib.Path(source or pathlib.Path(csrc) / name) \
        .read_text()
    if edits:
        _apply(f"{kind} {label}", texts, edits)
    for file, text in texts.items():
        (work / file).write_text(text)
    built = subprocess.run(
        [_cuda._nvcc(), *_cuda.COMPILE_FLAGS, "-shared", "-I", str(work),
         str(work / name), "-o", str(work / "lib.so")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if built.returncode:
        raise SystemExit(f"{kind} {label}: nvcc failed\n{built.stdout}")
    for line in built.stdout.splitlines():
        if "warning" in line or "spill" in line and " 0 bytes" not in line:
            print(f"{kind} {label}: {line.strip()}", flush=True)
    fn = getattr(ctypes.CDLL(str(work / "lib.so")), entry)
    fn.argtypes = _cuda.SIGNATURES[entry]
    fn.restype = ctypes.c_int
    fn.library = work / "lib.so"
    return fn


def _int8_operands(k: int, n: int, m: int, device: torch.device):
    """The int8 race's inputs: gaussian weights (0.02) quantized to int8,
    bf16 activations; numpy's generator, seed 0."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.normal(size=(k, n)) * 0.02)
                         .astype(np.float32)).to(device)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)) \
        .to(device).to(torch.bfloat16)
    return x, quant.quantize_int8(w)


def race_builds(builds: Dict[str, Callable], k: int, n: int, m: int,
                reps: int = 50, splits: Optional[Dict[str, tuple]] = None,
                kind: str = "int4"):
    """Each built variant of ``kind``'s kernel (int4: scale after each
    group) at (m, K, N), in turns (the order given, then reversed), the
    least of the two windows of each: microseconds a call and GB/s of
    weight bytes.  Each variant splits K as its wrapper does (``splits``,
    by label: ``(cols, CTAs an SM, one wave)`` of ``quant._split_k``, the
    tree's own rule unless told).  The variants other than the probes are
    held to the lab's error rule."""
    device = torch.device("cuda", torch.cuda.current_device())
    if kind == "int4":
        x, weight, _ = _operands(k, n, m, device)
        want = quant.int4_matmul_reference(x.float(), weight["q4"],
                                           weight["s"]).float()
        own = (quant.INT4_TILE_COLS, quant.INT4_CTAS_PER_SM, True)
        weight_bytes = k * n // 2
    else:
        x, weight = _int8_operands(k, n, m, device)
        want = quant.int8_matmul_reference(x.float(), weight["q"],
                                           weight["s"]).float()
        own = (quant.INT8_TILE_COLS, quant.INT8_CTAS_PER_SM, True)
        weight_bytes = k * n
    count = max(1, math.ceil(256e6 / weight_bytes))
    ring = [{key: value.clone() for key, value in weight.items()}
            for _ in range(count)]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rules = splits or {}

    def call(fn, w, label):
        n_slices, k_split, partials, arrivals = quant._split_k(
            device, m, k, n, *rules.get(label, own))
        head = (x.data_ptr(), next(iter(w.values())).data_ptr(),
                w["s"].data_ptr(), out.data_ptr(), _cuda.ptr(partials),
                _cuda.ptr(arrivals), m, k, n)
        if kind == "int4":
            code = fn(*head, k // w["s"].shape[0], n_slices, k_split, 0,
                      stream)
        else:
            code = fn(*head, n_slices, k_split, stream)
        if code:
            raise RuntimeError(f"{kind} {label}: CUDA error {code}")

    best = {}
    for label in list(builds) + list(builds)[::-1]:
        fn = builds[label]
        call(fn, weight, label)
        torch.cuda.synchronize()
        err = float((out.float() - want).abs().max() / want.abs().max())
        probe = label.removeprefix("other_") in PROBES[kind]
        if not probe and not err < 0.05:
            raise AssertionError(f"{kind} {label} K={k} N={n} m={m}: "
                                 f"relative error {err}")
        seconds = _device_seconds(
            lambda i: call(fn, ring[i % len(ring)], label), reps)
        best[label] = min(best.get(label, seconds), seconds)
    print(f"{kind} shape K={k} N={n} m={m}: " + " | ".join(
        f"{label} {s * 1e6:.1f} us {weight_bytes / s / 1e9:.0f} GB/s"
        for label, s in best.items()), flush=True)
    return {label: s * 1e6 for label, s in best.items()}


def same_bits(builds: Dict[str, Callable], labels, k: int, n: int,
              m: int) -> bool:
    """Whether the int8 builds ``labels`` give the same bits at (m, K, N)
    on the lab's int8 inputs (each split by the tree's own rule)."""
    device = torch.device("cuda", torch.cuda.current_device())
    x, weight = _int8_operands(k, n, m, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    outs = []
    for label in labels:
        out = torch.empty((m, n), dtype=torch.bfloat16, device=device)
        n_slices, k_split, partials, arrivals = quant._split_k(
            device, m, k, n, quant.INT8_TILE_COLS, quant.INT8_CTAS_PER_SM,
            True)
        code = builds[label](x.data_ptr(), weight["q"].data_ptr(),
                             weight["s"].data_ptr(), out.data_ptr(),
                             _cuda.ptr(partials), _cuda.ptr(arrivals), m, k,
                             n, n_slices, k_split, stream)
        if code:
            raise RuntimeError(f"int8 {label}: CUDA error {code}")
        torch.cuda.synchronize()
        outs.append(out)
    equal = all(torch.equal(outs[0], other) for other in outs[1:])
    print(f"bits K={k} N={n} m={m}: {' and '.join(labels)} "
          f"{'equal' if equal else 'differ'}", flush=True)
    return equal


#: SASS conversions (the conversion unit's instructions).
CONVERSIONS = ("I2F", "I2FP", "F2FP", "F2F")
#: One instruction of ``cuobjdump -sass``: ``/*0a30*/  @P0 HMMA... ;``.
_SASS_LINE = re.compile(r"\s*/\*[0-9a-f]+\*/\s*([^;]+);")


def sass_conversions(library: pathlib.Path) -> Dict[str, Dict[str, int]]:
    """Per kernel function of a built library (``cuobjdump -sass``): the
    count of each conversion opcode of :data:`CONVERSIONS` in the whole
    function and in its main loop, taken as the instructions from its
    first tensor-core product (HMMA/HGMMA) to its last; keys
    ``<opcode>`` and ``loop_<opcode>``."""
    tool = shutil.which("cuobjdump") or str(
        pathlib.Path(_cuda._nvcc()).parent / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    counts: Dict[str, Dict[str, int]] = {}
    for block in text.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        ops = []
        for line in body.splitlines():
            found = _SASS_LINE.match(line)
            if found:
                words = found.group(1).split()
                if words[0].startswith("@"):      # a predicate
                    words = words[1:]
                ops.append(words[0].split(".")[0])
        mma = [i for i, op in enumerate(ops) if op in ("HMMA", "HGMMA")]
        span = ops[mma[0]:mma[-1] + 1] if mma else []
        row = {}
        for op in CONVERSIONS:
            row[op] = ops.count(op)
            row[f"loop_{op}"] = span.count(op)
        counts[name.strip()] = row
    return counts


def run_builds(kind: str, ms, compare: Optional[pathlib.Path] = None,
               probes: bool = False, only=None, sass: bool = False,
               reps: int = 50, compare_rule: tuple = COMPARE_RULE,
               tunings: bool = False, shapes=None, bits=None):
    """``--builds``: build ``kind``'s kernel, its load floor, its variants
    with the other product (int8: each product at every instance), with
    ``probes`` the other probes, with
    ``compare`` the kernel of that ``csrc`` tree (``other``, with
    ``probes`` its probes ``other_<probe>``, split by ``compare_rule``),
    with ``tunings`` the variants of :data:`TUNINGS`, keep the labels of
    ``only``, and race them at ``shapes`` (default: the kind's) and every m
    of ``ms`` (with ``bits``, two or more int8 labels: first check at each
    shape and m whether they give the same bits)."""
    csrc = _cuda.CSRC_DIR
    plan = {"kernel": (csrc, (), None),
            "floor": (csrc, PROBES[kind]["floor"], None)}
    products = KINDS[kind][2]
    if isinstance(products, pathlib.Path):
        plan["wgmma"] = (csrc, (), products)
    else:
        plan.update({label: (csrc, edits, None)
                     for label, edits in products.items()})
    if probes:
        plan.update({label: (csrc, edits, None)
                     for label, edits in PROBES[kind].items()})
    if tunings:
        plan.update({label: (csrc, edits, None)
                     for label, (edits, _) in TUNINGS[kind].items()})
    if compare:
        plan["other"] = (compare, (), None)
        if probes:
            plan.update({f"other_{label}": (compare, edits, None)
                         for label, edits in PROBES[kind].items()})
    builds = {label: build_variant(label, tree, edits, source, kind)
              for label, (tree, edits, source) in plan.items()
              if not only or label in only}
    if sass:
        for label, fn in builds.items():
            for name, row in sass_conversions(fn.library).items():
                print(f"sass {kind} {label} {name}: " + " ".join(
                    f"{op} {count}" for op, count in row.items()),
                    flush=True)
    rules = {label: compare_rule for label in builds
             if label.startswith("other")}
    rules.update({label: rule for label, (_, rule) in TUNINGS[kind].items()
                  if rule and label in builds})
    results = []
    for m in ms:
        for k, n in shapes or (SHAPES if kind == "int4" else INT8_SHAPES):
            if bits:
                same_bits(builds, bits, k, n, m)
            results.append((m, k, n, race_builds(builds, k, n, m, reps,
                                                 rules, kind)))
    return results


#: The wrapper's host time, run in a fresh process from a repository
#: root (argv[1]): microseconds of host time a call of ``int8_matmul`` at
#: each (m, K, N), the least of five windows of 200 calls after a
#: warm-up, the card kept busy by a device-side sleep so that no call
#: waits on it.
HOST_PROBE = """
import sys, time
sys.path.insert(0, sys.argv[1])
import torch
from aiko_services_tpu_torch.ops import quant
device = torch.device("cuda", 0)
for m, k, n in ((8, 4096, 4096), (8, 4096, 1024), (8, 14336, 4096),
                (64, 4096, 14336)):
    x = torch.randn((m, k), device=device).to(torch.bfloat16)
    w = quant.quantize_int8(torch.randn((k, n), device=device))
    for _ in range(20):
        quant.int8_matmul(x, w["q"], w["s"])
    torch.cuda.synchronize()
    best = None
    for _ in range(5):
        torch.cuda._sleep(300_000_000)
        start = time.perf_counter()
        for _ in range(200):
            quant.int8_matmul(x, w["q"], w["s"])
        host = (time.perf_counter() - start) / 200 * 1e6
        torch.cuda.synchronize()
        best = host if best is None else min(best, host)
    print(f"host {sys.argv[1]} m={m} K={k} N={n}: {best:.2f} us a call",
          flush=True)
"""


def host_times(roots) -> None:
    """``--host``: the wrapper's host microseconds a call (HOST_PROBE) of
    each repository root, in turns (the list, then reversed, twice)."""
    for root in (list(roots) + list(roots)[::-1]) * 2:
        subprocess.run([sys.executable, "-c", HOST_PROBE, str(root)],
                       check=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--one", nargs=3, metavar=("VARIANT", "K", "N"),
                        help="validate and time one variant, e.g. --one "
                             "repeat 8192 1024")
    parser.add_argument("--m", type=int, nargs="+", default=[64])
    parser.add_argument("--device", default=None,
                        help="default: the current CUDA card")
    parser.add_argument("--builds", action="store_true",
                        help="race the kernel against its load floor (and "
                             "--compare) in turns")
    parser.add_argument("--int8", action="store_true",
                        help="with --builds: race the int8 kernel (at "
                             "INT8_SHAPES) instead of the int4 kernel")
    parser.add_argument("--compare", type=pathlib.Path, metavar="DIR",
                        help="with --builds: also the kernel built from "
                             "this csrc directory, split K as the "
                             "64-column kernels did (COMPARE_RULE)")
    parser.add_argument("--compare-rule", nargs=3, type=int,
                        default=list(COMPARE_RULE),
                        metavar=("COLS", "PER_SM", "ONE_WAVE"),
                        help="the --compare kernel's K split (default: the "
                             "64-column kernels' 64 2 0; 256 3 1 for a "
                             "256-column tree)")
    parser.add_argument("--probes", action="store_true",
                        help="with --builds: also the edited copies that "
                             "drop the merge, the product or x's loads "
                             "(of the --compare tree too)")
    parser.add_argument("--tunings", action="store_true",
                        help="with --builds: also the right variants of "
                             "TUNINGS (another ring, merge or split)")
    parser.add_argument("--only", nargs="+", metavar="LABEL",
                        help="with --builds: race only these labels")
    parser.add_argument("--sass", action="store_true",
                        help="with --builds: print each build's "
                             "conversion instructions (cuobjdump -sass)")
    parser.add_argument("--shapes", nargs="+", metavar="K,N",
                        type=lambda s: tuple(int(v) for v in s.split(",")),
                        help="with --builds: these (K, N) only")
    parser.add_argument("--bits", nargs="+", metavar="LABEL",
                        help="with --builds --int8: also check that these "
                             "builds give the same bits")
    parser.add_argument("--reps", type=int, default=50)
    parser.add_argument("--host", nargs="*", type=pathlib.Path,
                        metavar="ROOT",
                        help="time int8_matmul's host microseconds a call "
                             "in this repository and each ROOT")
    args = parser.parse_args(argv)
    if args.host is not None:
        host_times([pathlib.Path(__file__).resolve().parents[2],
                    *args.host])
        return
    if args.one:
        row = race_one(args.one[0], int(args.one[1]), int(args.one[2]),
                       args.m[0], args.device)
        print(f"OK {row}")
        return
    if args.builds:
        if not torch.cuda.is_available():
            raise SystemExit("--builds needs a CUDA card")
        run_builds("int8" if args.int8 else "int4", args.m, args.compare,
                   args.probes, args.only, args.sass, args.reps,
                   (args.compare_rule[0], args.compare_rule[1],
                    bool(args.compare_rule[2])), args.tunings,
                   args.shapes, args.bits)
        return
    for m in args.m:
        for k, n in SHAPES:
            race(k, n, m, args.device)


if __name__ == "__main__":
    main()
