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
other edited copies of
:data:`PROBES`, and with ``--compare DIR``, ``other`` (the kernel built
from another ``csrc`` directory, e.g. the parent commit's;
``--compare-cols`` is its CTA tile width, and it splits K by the int8
kernel's rule, as the wrapper of the 64-column kernel did).

    python -m aiko_services_tpu_torch.tools.int4_kernel_lab
    python -m aiko_services_tpu_torch.tools.int4_kernel_lab --one repeat 8192 1024
    python -m aiko_services_tpu_torch.tools.int4_kernel_lab --builds --m 8 40 64

``--device cpu`` only validates the numerics (the plain versions); there
is no timing off the card.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import pathlib
import shutil
import subprocess
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


#: Edited copies of the kernel that show where its time goes (wrong
#: results, timed only): label -> [(text, replacement), ...].  ``floor``
#: keeps every load and feeds the raw packed words to the product.
PROBES = {
    "floor": [("    const unsigned lo0 = nibbles_to_bf16x2(p), hi0 = "
               "nibbles_to_bf16x2(p >> 4);\n"
               "    const unsigned lo1 = nibbles_to_bf16x2(p >> 8);\n"
               "    const unsigned hi1 = nibbles_to_bf16x2(p >> 12);",
               "    const unsigned lo0 = p, hi0 = p >> 4;\n"
               "    const unsigned lo1 = p >> 8, hi1 = p >> 12;")],
    "no_merge": [("  if (splits > 1) {\n    // Publish",
                  "  if (false) {\n    // Publish")],
    "no_mma": [("          aiko::mma_bf16_16816(kScaleFirst ? acc[t][mt] "
                ": part[t][mt],",
                "          if (MR < 0) aiko::mma_bf16_16816(kScaleFirst ? "
                "acc[t][mt] : part[t][mt],")],
    "no_x": [("    for (int i = tid; i < MR * 8; i += kThreads) {",
              "    for (int i = tid; i < 0; i += kThreads) {")],
}


#: The lab's whole variants of the kernel (``wgmma``).
LAB_KERNELS = pathlib.Path(__file__).resolve().parents[2] / "scripts" \
    / "lab_kernels"


def build_variant(label: str, csrc: pathlib.Path, edits=(),
                  source: Optional[pathlib.Path] = None) -> Callable:
    """``aiko_int4_matmul`` of ``csrc/int4_matmul.cu`` (or of ``source``)
    and ``csrc/common.cuh`` built alone with the port's nvcc flags and
    text ``edits`` into ``_build/lab/int4_<label>``; bound with ctypes."""
    work = _cuda.BUILD_DIR / "lab" / f"int4_{label}"
    work.mkdir(parents=True, exist_ok=True)
    shutil.copy(pathlib.Path(csrc) / "common.cuh", work / "common.cuh")
    shutil.copy(source or pathlib.Path(csrc) / "int4_matmul.cu",
                work / "int4_matmul.cu")
    text = (work / "int4_matmul.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"int4 {label}: the edited text is not in the "
                             "source")
        text = text.replace(old, new)
    (work / "int4_matmul.cu").write_text(text)
    built = subprocess.run(
        [_cuda._nvcc(), *_cuda.COMPILE_FLAGS, "-shared", "-I", str(work), str(work / "int4_matmul.cu"), "-o",
         str(work / "lib.so")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if built.returncode:
        raise SystemExit(f"int4 {label}: nvcc failed\n{built.stdout}")
    fn = ctypes.CDLL(str(work / "lib.so")).aiko_int4_matmul
    fn.argtypes = _cuda.SIGNATURES["aiko_int4_matmul"]
    fn.restype = ctypes.c_int
    return fn


def race_builds(builds: Dict[str, Callable], k: int, n: int, m: int,
                reps: int = 50, splits: Optional[Dict[str, tuple]] = None):
    """Each built variant (scale after each group) at (m, K, N), in turns
    (the order given, then reversed), the least of the two windows of
    each: microseconds a call and GB/s of int4 weight bytes.  Each variant
    splits K as its wrapper does (``splits``, by label: ``(cols, CTAs an
    SM, one wave)`` of ``quant._split_k``, the tree's own int4 rule unless
    told).  The variants other than the probes are held to the lab's
    error rule."""
    device = torch.device("cuda", torch.cuda.current_device())
    x, q4, _ = _operands(k, n, m, device)
    ring = _copies(q4, k, n)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=device)
    want = quant.int4_matmul_reference(x.float(), q4["q4"], q4["s"]).float()
    stream = torch.cuda.current_stream(device).cuda_stream
    rules = splits or {}
    own = (quant.INT4_TILE_COLS, quant.INT4_CTAS_PER_SM, True)

    def call(fn, w, label):
        n_slices, k_split, partials, arrivals = quant._split_k(
            device, m, k, n, *rules.get(label, own))
        code = fn(x.data_ptr(), w["q4"].data_ptr(), w["s"].data_ptr(),
                  out.data_ptr(), _cuda.ptr(partials), _cuda.ptr(arrivals),
                  m, k, n, k // w["s"].shape[0], n_slices, k_split, 0,
                  stream)
        if code:
            raise RuntimeError(f"aiko_int4_matmul: CUDA error {code}")

    best = {}
    for label in list(builds) + list(builds)[::-1]:
        fn = builds[label]
        call(fn, q4, label)
        torch.cuda.synchronize()
        err = float((out.float() - want).abs().max() / want.abs().max())
        if label not in PROBES and not err < 0.05:
            raise AssertionError(f"int4 {label} K={k} N={n} m={m}: relative "
                                 f"error {err}")
        seconds = _device_seconds(
            lambda i: call(fn, ring[i % len(ring)], label), reps)
        best[label] = min(best.get(label, seconds), seconds)
    print(f"shape K={k} N={n} m={m}: " + " | ".join(
        f"{label} {s * 1e6:.1f} us {k * n / 2 / s / 1e9:.0f} GB/s"
        for label, s in best.items()), flush=True)
    return {label: s * 1e6 for label, s in best.items()}


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
    parser.add_argument("--compare", type=pathlib.Path, metavar="DIR",
                        help="with --builds: also the kernel built from "
                             "this csrc directory")
    parser.add_argument("--probes", action="store_true",
                        help="with --builds: also the edited copies that "
                             "drop the merge, the product or x's loads")
    parser.add_argument("--compare-cols", type=int, default=64,
                        help="the --compare kernel's CTA tile width in "
                             "columns, which sets its K split (default 64: "
                             "the kernel before 256-column tiles)")
    args = parser.parse_args(argv)
    if args.one:
        row = race_one(args.one[0], int(args.one[1]), int(args.one[2]),
                       args.m[0], args.device)
        print(f"OK {row}")
        return
    if args.builds:
        if not torch.cuda.is_available():
            raise SystemExit("--builds needs a CUDA card")
        csrc = _cuda.CSRC_DIR
        builds = {"kernel": build_variant("kernel", csrc),
                  "floor": build_variant("floor", csrc, PROBES["floor"]),
                  "wgmma": build_variant(
                      "wgmma", csrc,
                      source=LAB_KERNELS / "int4_matmul_wgmma.cu")}
        if args.compare:
            builds["other"] = build_variant("other", args.compare)
        if args.probes:
            for label, edits in PROBES.items():
                if label != "floor":
                    builds[label] = build_variant(label, csrc, edits)
        other = (args.compare_cols, quant.INT8_CTAS_PER_SM, False)
        for m in args.m:
            for k, n in SHAPES:
                race_builds(builds, k, n, m, splits={"other": other})
        return
    for m in args.m:
        for k, n in SHAPES:
            race(k, n, m, args.device)


if __name__ == "__main__":
    main()
