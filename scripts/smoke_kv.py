#!/usr/bin/env python3
"""Run chip_smoke.py's phase 9 (the KV tiers and the KV wire) alone, on
one card.

llama3_8b with random int8 weights from the smoke's seed, then phase 9
as the smoke runs it, bf16 KV then int8 KV: (a) the host tier, (b) the
spill tier and a warm restart, (c) the KV wire between two replicas,
warm and cold turns, (d) migrate_prepare and the resume on a peer; every
check of the smoke's.  Prints each part's JSON line and the card's name
and power limit.  Exits non-zero on any failure.

    python3 scripts/smoke_kv.py [tier] [spill] [wire]

Needs an NVIDIA card and nvcc.
"""

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
PARTS = ("tier", "spill", "wire")


def main() -> None:
    parts = sys.argv[1:] or list(PARTS)
    if not set(parts) <= set(PARTS):
        raise SystemExit(f"parts: {PARTS}")
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _cuda.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    params = llama.random_quantized_params(llama.CONFIGS["llama3_8b"],
                                           seed=0, device=device)
    weights = chip_smoke.Weights(quant, 8)
    kernels = (quant.int8_matmul, attention.flash_attention,
               paged_attention.paged_decode_attention, pp.write_kv_rows,
               pp.append_kv, pp.chunk_attention)
    functions = dict(tier=chip_smoke.serve_tier,
                     spill=chip_smoke.serve_spill,
                     wire=chip_smoke.serve_kv_wire)
    for quantize_kv in (False, True):
        for part in parts:
            began = time.monotonic()
            run = functions[part](torch, np, llama, weights, kernels,
                                  PagedContinuousServer, DecodeRequest,
                                  params, quantize_kv, device)
            print(f"--- phase 9 {part}, "
                  f"{'int8' if quantize_kv else 'bf16'} KV "
                  f"({time.monotonic() - began:.1f} s; {smi}): "
                  + json.dumps(run), flush=True)


if __name__ == "__main__":
    main()
