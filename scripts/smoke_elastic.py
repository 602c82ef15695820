#!/usr/bin/env python3
"""Run chip_smoke.py's phase 11 (the elastic fleet) alone, on one card.

llama3_8b with random int8 weights from the smoke's seed, then phase 11
as the smoke runs it: the FleetAutoscaler owning the replicas behind a
Registrar and a ReplicaRouter, each replica over a warmed phase-8 paged
server on one weight set, driven by the port's loadgen rigs — (a)
run_elastic_chaos (seed 0), (b) run_rolling_upgrade with two replicas,
migration-based and drain-based turns, (c) run_restart_ab in pairs —
with every check of the smoke's.  Prints the phase's JSON line, one line
a part or turn, the peak device memory and the card's name and power
limit.  Exits non-zero on any failure.  Name parts to run only those.

    python3 scripts/smoke_elastic.py [chaos] [upgrade] [restart]

Needs an NVIDIA card and nvcc.
"""

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> None:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    parts = sys.argv[1:] or list(chip_smoke.ELASTIC_PARTS)
    if not set(parts) <= set(chip_smoke.ELASTIC_PARTS):
        raise SystemExit(f"parts: {chip_smoke.ELASTIC_PARTS}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import numpy as np

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
    kernels = (quant.int8_matmul, attention.flash_attention,
               paged_attention.paged_decode_attention, pp.write_kv_rows,
               pp.append_kv, pp.chunk_attention)
    began = time.monotonic()
    elastic = chip_smoke.serve_elastic(
        torch, np, llama, chip_smoke.Weights(quant, 8), kernels,
        PagedContinuousServer, DecodeRequest, params, device, parts)
    print("--- phase 11, the elastic fleet, llama3_8b int8, bf16 KV "
          f"({time.monotonic() - began:.1f} s; {smi}): "
          + json.dumps(elastic), flush=True)
    chip_smoke.print_elastic(elastic, smi)


if __name__ == "__main__":
    main()
