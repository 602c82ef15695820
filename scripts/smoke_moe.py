#!/usr/bin/env python3
"""Run chip_smoke.py's phase 14 (mixture-of-experts at mixtral_8x7b's
width) alone, on one card.

mixtral_8x7b cut to 8 of its 32 layers, random weights from the smoke's
seed through init_params + quantize_params (int8 and int4 attention and
LM head on the same bf16 experts), then phase 14 as the smoke runs it:
the router's f32 products against the CPU's; (a) the contiguous server
with every token held to the batch-1 oracle and the steady graphed
window; (b) the paged server with a shared prefix and mixed steps; (c)
speculation with the dense small draft; (d) the int4 tree.  Every check of
the smoke's.  Prints the phase's lines, each part's seconds and the
card's name and power limit; exits non-zero on any failure.  Name parts
to run only those.

    python3 scripts/smoke_moe.py [contiguous] [paged] [spec] [int4]

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
    parts = sys.argv[1:] or list(chip_smoke.MOE_PARTS)
    if not set(parts) <= set(chip_smoke.MOE_PARTS):
        raise SystemExit(f"parts: {chip_smoke.MOE_PARTS}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import numpy as np

    from aiko_services_tpu_torch.models import llama
    from aiko_services_tpu_torch.ops import (_cuda, attention,
                                             paged_attention, quant)
    from aiko_services_tpu_torch.ops import paged_prefill as pp
    from aiko_services_tpu_torch.orchestration.continuous import (
        ContinuousBatchingServer, DecodeRequest)
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
    common = (attention.flash_attention,
              paged_attention.paged_decode_attention, pp.write_kv_rows,
              pp.append_kv, pp.chunk_attention, pp.append_kv_ragged)
    kernels = (quant.int8_matmul,) + common
    kernels4 = (quant.int4_matmul, quant.int4_matmul_tiled,
                quant.int4_matmul_scale_first, quant.int8_matmul) + common
    began = time.monotonic()
    phase = chip_smoke.serve_moe_phase(
        torch, np, llama, quant, kernels, kernels4, ContinuousBatchingServer,
        PagedContinuousServer, DecodeRequest, device, parts=parts)
    chip_smoke.print_moe_phase(phase, smi)
    print(f"phase 14 took {time.monotonic() - began:.1f} s; {smi}",
          flush=True)


if __name__ == "__main__":
    main()
