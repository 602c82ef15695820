#!/usr/bin/env python3
"""Run chip_smoke.py's phase 8 (the wire) alone, on one card.

llama3_8b with random int8 weights from the smoke's seed, then phase 8
as the smoke runs it (phase 4's traffic through InferClient ->
ContinuousReplica -> PagedContinuousServer, every check of the smoke's,
in turns with the same traffic by step() on a server warmed the same
way); prints each turn's caller-side numbers and their spread.
``--direct`` also runs phase 4's direct step() run of the same traffic
first (bf16 KV, with its steady window).  Exits non-zero on any
failure.

    python3 scripts/smoke_wire.py [--direct]

Needs an NVIDIA card and nvcc.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--direct", action="store_true",
                        help="run phase 4's direct bf16 run first")
    direct = parser.parse_args().direct
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke
    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.ops import (_cuda, attention,
                                             paged_attention, quant)
    from aiko_services_tpu_torch.ops import paged_prefill as pp
    from aiko_services_tpu_torch.orchestration.continuous import (
        DecodeRequest)
    from aiko_services_tpu_torch.orchestration.paged import (
        PagedContinuousServer)
    _cuda.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    params = llama.random_quantized_params(llama.CONFIGS["llama3_8b"],
                                           seed=0, device=device)
    weights = chip_smoke.Weights(quant, 8)
    kernels = (quant.int8_matmul, attention.flash_attention,
               paged_attention.paged_decode_attention, pp.write_kv_rows,
               pp.append_kv, pp.chunk_attention)
    runs = []
    if direct:
        runs.append(("direct step() (phase 4)", chip_smoke.serve_paged(
            torch, np, llama, weights, kernels, PagedContinuousServer,
            DecodeRequest, params, False, device)))
    wire = chip_smoke.serve_wire(torch, np, llama, weights, kernels,
                                 PagedContinuousServer, DecodeRequest,
                                 params, device)
    print("--- serving llama3_8b int8 through the wire, bf16 KV: "
          + json.dumps(wire), flush=True)
    for index, turn in enumerate(wire["turns"]):
        print(f"turn {index}: " + json.dumps(turn), flush=True)
    print("spread: " + json.dumps(wire["spread"]), flush=True)
    runs[:0] = [("wire (first wire turn)", wire),
                ("direct step(), warmed as the wire", wire["direct_twin"])]
    for label, run in runs:
        print(f"{label}, server side: TTFT p50 {run['ttft_ms_p50']:.1f} "
              f"ms, max {run['ttft_ms_max']:.1f} ms, total p50 "
              f"{run['total_ms_p50']:.1f} ms, served "
              f"{run['served_tok_s']:.1f} tok/s", flush=True)


if __name__ == "__main__":
    main()
