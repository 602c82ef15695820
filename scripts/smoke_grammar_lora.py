#!/usr/bin/env python3
"""Run chip_smoke.py's phase 13 (grammars and adapters) alone, on one
card.

llama3_8b with random int8 weights from the smoke's seed, then phase 13 as
the smoke runs it: (a) constrained_generate at phase 3's contiguous shape,
held to the masked batch-1 oracle; (b) run_structured on two paged
replicas with n-gram speculation and the command automaton, constrained
then free; (c) a paged server with four rank-8 tenants beside base rows,
its steady graphed window, the hot unload, demotion and warm load, and
adapter_load / adapter_unload over the wire; (d) run_multitenant aware
then blind.  Every check of the smoke's.  Prints the phase's lines, each
part's seconds and the card's name and power limit; exits non-zero on any
failure.  Name parts to run only those.

    python3 scripts/smoke_grammar_lora.py [constrained] [structured] \
        [adapters] [multitenant]

Needs an NVIDIA card and nvcc.
"""

import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> None:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    parts = sys.argv[1:] or list(chip_smoke.GRAMMAR_LORA_PARTS)
    if not set(parts) <= set(chip_smoke.GRAMMAR_LORA_PARTS):
        raise SystemExit(f"parts: {chip_smoke.GRAMMAR_LORA_PARTS}")
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
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    params = llama.random_quantized_params(llama.CONFIGS["llama3_8b"],
                                           seed=0, device=device)
    kernels = (quant.int8_matmul, attention.flash_attention,
               paged_attention.paged_decode_attention, pp.write_kv_rows,
               pp.append_kv, pp.chunk_attention, pp.append_kv_ragged)
    began = time.monotonic()
    phase = chip_smoke.serve_grammar_lora_phase(
        torch, np, llama, kernels, PagedContinuousServer, DecodeRequest,
        params, device, chip_smoke.Weights(quant, 8), parts=parts)
    chip_smoke.print_grammar_lora_phase(phase, smi)
    print(f"phase 13 took {time.monotonic() - began:.1f} s; {smi}",
          flush=True)


if __name__ == "__main__":
    main()
