"""Kernel lab: race the int4 dequant-matmul's two numerics on the card.

Port of ``scripts/int4_kernel_lab.py``.  The TPU lab raced Pallas
structures; here both of its variants are instances of one CUDA kernel,
``csrc/int4_matmul.cu``: ``batched`` (scale after each group, the serving
path's ``int4_matmul``) and ``repeat`` (``bf16(q * s)`` operands,
``int4_matmul_scale_first``), with the int8 kernel as the yardstick.
Times are CUDA events around back-to-back launches queued behind a
device-side sleep; the weights rotate through copies that exceed the
50 MB L2, as a decode step finds them.

    python -m aiko_services_tpu_torch.tools.int4_kernel_lab
    python -m aiko_services_tpu_torch.tools.int4_kernel_lab --one repeat 8192 1024

``--device cpu`` only validates the numerics (the plain versions); there
is no timing off the card.
"""

from __future__ import annotations

import argparse
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import quant

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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--one", nargs=3, metavar=("VARIANT", "K", "N"),
                        help="validate and time one variant, e.g. --one "
                             "repeat 8192 1024")
    parser.add_argument("--m", type=int, default=64)
    parser.add_argument("--device", default=None,
                        help="default: the current CUDA card")
    args = parser.parse_args(argv)
    if args.one:
        row = race_one(args.one[0], int(args.one[1]), int(args.one[2]),
                       args.m, args.device)
        print(f"OK {row}")
        return
    for k, n in SHAPES:
        race(k, n, args.m, args.device)


if __name__ == "__main__":
    main()
