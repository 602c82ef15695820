#!/usr/bin/env python3
"""Run chip_smoke.py's phase-2 checks of some kernels alone, on one card.

Each named check is the smoke's own function (the same shapes, inputs,
tolerances and timings) and prints the smoke's rows; a failed case is
reported and the run goes on to every case.  Exits non-zero if any case
failed.

    python3 scripts/smoke_phase2.py [chunk] [verify] [int4] [int8] [kv]

Without names it runs all five: chunk attention at every admission
slice, chunk attention at the verify shape, int4_matmul at every
projection and m (with the m-tiled instance and the step sums),
int8_matmul at every projection and m (with the 8-slot step's sum), and
the KV writer's three modes (append_kv, append_kv_ragged and the decode
write write_kv_rows, each byte-equal to its plain version).
Needs an NVIDIA card and nvcc.
"""

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHECKS = ("chunk", "verify", "int4", "int8", "kv")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*", choices=[[], *CHECKS],
                        metavar="NAME", help="checks to run (all by default)")
    names = parser.parse_args().names or list(CHECKS)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.ops import _cuda, quant
    from aiko_services_tpu_torch.ops import paged_prefill as pp
    failures = []
    chip_smoke.fail = failures.append       # record and go on to every case
    _cuda.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    if "chunk" in names:
        rows, _, _ = chip_smoke.check_chunk(torch, pp, llama, device)
        chip_smoke.print_rows("chunk_attention", rows)
    if "verify" in names:
        rows, _, _ = chip_smoke.check_chunk_verify(torch, pp, llama, device)
        chip_smoke.print_rows("chunk_attention at the verify shape", rows)
    if "int4" in names:
        rows, _, steps = chip_smoke.check_int4_matmul(
            torch, quant, device, llama.CONFIGS["llama3_8b"])
        chip_smoke.print_rows("int4_matmul", rows)
        for key, step in steps.items():
            print(f"  int4 ({key}) sum of the isolated times: {step}")
    if "int8" in names:
        rows, _, step = chip_smoke.check_int8_matmul(
            torch, quant, device, llama.CONFIGS["llama3_8b"])
        chip_smoke.print_rows("int8_matmul", rows)
        print(f"  int8 one 8-slot decode step, sum of the isolated times: "
              f"{step}")
    if "kv" in names:
        for title, check in (
                ("append_kv", chip_smoke.check_append),
                ("append_kv_ragged", chip_smoke.check_append_ragged),
                ("write_kv_rows", chip_smoke.check_write_kv_rows)):
            rows, _ = check(torch, pp, llama, device)
            chip_smoke.print_rows(title, rows)
    for message in failures:
        print(f"FAIL: {message}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
