"""Int8 weight-only quantization and the int8 dequant-matmul.

Port of ``aiko_services_tpu/ops/quant.py`` (int8 only; int4 is a later
slice).  Decode is bandwidth-bound: every step streams every weight
matrix once, so weights are stored as int8 with per-output-channel f32
scales and multiplied without ever materializing the dequantized matrix.

:func:`int8_matmul` dispatches by shape exactly as the JAX package does
(``_pick_block`` and the ``m > 64`` rule): decode shapes launch the
hand-written CUDA kernel ``csrc/int8_matmul.cu`` on a CUDA tensor; other
shapes take the plain ``(x @ q) * s`` product, which the JAX package also
computes outside Pallas.  On a CPU tensor every shape takes
:func:`int8_matmul_reference`.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from . import _cuda

__all__ = ["quantize_int8", "dequantize", "is_quantized", "int8_matmul",
           "int8_matmul_reference", "kernel_shape"]

#: int8 symmetric range (-127..127; -128 unused to keep scales symmetric).
QMAX = 127.0

#: The JAX kernel's per-program VMEM budget; kept so the port takes the
#: kernel for exactly the shapes the JAX package does.
_VMEM_BUDGET = 6 * 1024 * 1024


def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of a 2-D weight
    ``(in, out)`` -> ``{"q": int8 (in, out), "s": f32 (1, out)}``.
    Rounds half to even, as ``jnp.round`` does."""
    w32 = w.to(torch.float32)
    scale = w32.abs().amax(dim=0, keepdim=True) / QMAX
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w32 / scale), -QMAX, QMAX).to(torch.int8)
    return {"q": q, "s": scale}


def dequantize(qw: Dict[str, torch.Tensor],
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (qw["q"].to(torch.float32) * qw["s"]).to(dtype)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q" in w or "q4" in w) and "s" in w


def _pick_block(m: int, k: int, n: int) -> int:
    """The JAX kernel's output-column block (0 = no fit), kept only as
    the shape rule that decides between kernel and plain product."""
    for block in (1024, 512, 256, 128):
        if n % block:
            continue
        if 2 * m * k + k * block + 4 * m * block + 4 * block \
                <= _VMEM_BUDGET:
            return block
    return 0


@functools.lru_cache(maxsize=None)
def kernel_shape(m: int, k: int, n: int) -> bool:
    """True where the JAX package runs its Pallas kernel: decode shapes
    (m <= 64) that tile (K % 32, N % 128) within its VMEM budget."""
    return m <= 64 and k % 32 == 0 and _pick_block(m, k, n) > 0


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                          s: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x (..., K) @ q (K, N)`` accumulated in f32 (the
    int8 weights and bf16 activations are exact in f32), times ``s (1,
    N)``, cast to ``x.dtype``."""
    k, n = q.shape
    lead = x.shape[:-1]
    out = (x.reshape(-1, k).to(torch.float32) @ q.to(torch.float32)) * s
    return out.to(x.dtype).reshape(*lead, n)


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ dequant(q (K, N), s (1, N)) -> (..., N)`` in
    ``x.dtype``.  CPU tensors take the plain version; on CUDA, kernel
    shapes launch ``csrc/int8_matmul.cu`` and the rest take the plain
    large-m product (``torch.mm`` in ``x.dtype`` with an f32 result,
    then the scale)."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, s)
    k, n = q.shape
    lead = x.shape[:-1]
    # Activations may arrive as a strided view (the LM head reads the
    # last position of a prefill); the copy is m*K elements.
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    if not kernel_shape(m, k, n):
        # Prefill-sized m is compute-bound: the JAX package leaves it to
        # XLA's convert+dot (f32 result, then the scale), the port to the
        # card's matrix product with an f32 result.
        out = torch.mm(x2, q.to(x.dtype), out_dtype=torch.float32) * s
        return out.to(x.dtype).reshape(*lead, n)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int8_matmul: the kernel takes bf16 activations, "
                        f"got {x.dtype}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError("int8_matmul: q must be int8 and s float32")
    if tuple(s.shape) not in ((1, n), (n,)):
        raise ValueError(f"int8_matmul: scale shape {tuple(s.shape)} does "
                         f"not match N={n}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    splits, k_split = _k_split(k, n)
    partials = arrivals = None
    if splits > 1:
        rows = next(r for r in (8, 16, 32, 64) if m <= r)
        partials, arrivals = _cuda.scratch(x.device,
                                           n // 64 * splits * rows * 64,
                                           n // 64)
    device = _cuda.check_cuda("int8_matmul", x2, q, s, out)
    _cuda.launch("aiko_int8_matmul", device, x2.data_ptr(), q.data_ptr(),
                 s.data_ptr(), out.data_ptr(), _cuda.ptr(partials),
                 _cuda.ptr(arrivals), m, k, n, splits, k_split)
    int8_matmul.launches += 1
    return out.reshape(*lead, n)


#: SMs of an H100 SXM; the K split aims at two CTAs on each.
_SMS = 132


@functools.lru_cache(maxsize=None)
def _k_split(k: int, n: int):
    """(slices, rows per slice) of the K axis for an (., K, N) launch:
    enough 64-column x K-slice CTAs for ~2 per SM, each slice at least
    four 64-row pipeline stages."""
    tiles = n // 64
    splits = max(1, min(-(-2 * _SMS // tiles), k // 256))
    rows = -(-k // splits)
    rows = -(-rows // 64) * 64
    return -(-k // rows), rows


#: Kernel launches on the CUDA path (never counts the plain versions).
int8_matmul.launches = 0
