#!/usr/bin/env python3
"""Run chip_smoke.py's phase 12 (the contiguous layout's residue and the
standalone speculation loops) alone, on one card.

llama3_8b with random int8 weights and the int8 1b draft from the smoke's
seeds, then phase 12 as the smoke runs it: the route check (the chunked
forwards' append_kv_ragged + chunk_attention on the degenerate pool
against the plain path), (a) ContinuousBatchingServer with speculation at
phase 3's shape and traffic, (b) speculative_generate,
speculative_generate_sampled and complete(), (c) mistral_7b on a rolling
cache against a plain one; every check of the smoke's.  Prints the
phase's lines, each part's seconds and the card's name and power limit.
Exits non-zero on any failure.  Name parts to run only those.

    python3 scripts/smoke_contig.py [route] [servers] [standalone] [rolling]

Needs an NVIDIA card and nvcc.
"""

import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
PARTS = ("route", "servers", "standalone", "rolling")


def main() -> None:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    parts = sys.argv[1:] or list(PARTS)
    if not set(parts) <= set(PARTS):
        raise SystemExit(f"parts: {PARTS}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import numpy as np

    from aiko_services_tpu_torch.models import llama, speculative
    from aiko_services_tpu_torch.ops import (_cuda, attention,
                                             paged_attention, quant)
    from aiko_services_tpu_torch.ops import paged_prefill as pp
    from aiko_services_tpu_torch.orchestration.continuous import (
        ContinuousBatchingServer, DecodeRequest)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _cuda.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    params = llama.random_quantized_params(llama.CONFIGS["llama3_8b"],
                                           seed=0, device=device)
    draft_1b = llama.random_quantized_params(llama.CONFIGS["1b"], seed=1,
                                             device=device)
    kernels = (quant.int8_matmul, attention.flash_attention,
               paged_attention.paged_decode_attention, pp.write_kv_rows,
               pp.append_kv, pp.chunk_attention, pp.append_kv_ragged)
    began = time.monotonic()
    phase = chip_smoke.serve_contiguous_phase(
        torch, np, llama, speculative, kernels, ContinuousBatchingServer,
        DecodeRequest, params, draft_1b, device, parts)
    chip_smoke.print_contiguous_phase(phase, smi)
    print(f"phase 12 took {time.monotonic() - began:.1f} s; {smi}",
          flush=True)


if __name__ == "__main__":
    main()
