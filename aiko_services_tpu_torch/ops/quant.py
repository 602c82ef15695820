"""Weight-only quantization (int8 and int4) and the dequant-matmuls.

Port of ``aiko_services_tpu/ops/quant.py``.  Decode is bandwidth-bound:
every step streams every weight matrix once, so weights are stored as
int8 with per-output-channel f32 scales, or as nibble-packed int4 with
per-(128-row group, output column) f32 scales, and multiplied without ever
materializing the dequantized matrix.

:func:`int8_matmul` and :func:`int4_matmul` dispatch by shape exactly as
the JAX package does on hardware (its block pickers and the ``m > 64``
rule, kept here only as shape rules): decode shapes launch the
hand-written CUDA kernels ``csrc/int8_matmul.cu`` / ``csrc/int4_matmul.cu``
on a CUDA tensor.  Other int8 shapes take the plain large-m product, which
the JAX package also computes outside Pallas; other int4 shapes launch the
m-tiled instance of the int4 kernel, or, where it does not tile, a
group-wise product written out in PyTorch.  On a CPU tensor every shape
takes the plain version (:func:`int8_matmul_reference`,
:func:`int4_matmul_reference`).

Every quantizer divides by a TENSOR: PyTorch's CUDA division by a Python
scalar multiplies by its reciprocal, which is one ulp off a true division
in places, so a scale (and then a code) would differ from the CPU's and
the JAX package's.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from . import _cuda

__all__ = ["quantize_int8", "dequantize", "is_quantized", "int8_matmul",
           "int8_matmul_reference", "kernel_shape", "quantize_int4",
           "dequantize_int4", "is_quantized_int4", "int4_kernel_shape",
           "int4_matmul", "int4_matmul_reference", "int4_matmul_tiled",
           "int4_matmul_scale_first",
           "int4_matmul_scale_first_reference", "int4_matmul_grouped",
           "tiles_int4", "quantize_tree"]

#: int8 symmetric range (-127..127; -128 unused to keep scales symmetric).
QMAX = 127.0
#: int4 symmetric range (-7..7; -8 unused to keep scales symmetric).
QMAX4 = 7.0

#: The JAX kernel's per-program VMEM budget; kept so the port takes the
#: kernel for exactly the shapes the JAX package does.
_VMEM_BUDGET = 6 * 1024 * 1024


def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of a 2-D weight
    ``(in, out)`` -> ``{"q": int8 (in, out), "s": f32 (1, out)}``.
    Rounds half to even, as ``jnp.round`` does."""
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=0, keepdim=True)
    scale = amax / torch.full_like(amax, QMAX)
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
        # card's matrix product with an f32 result.  f32 activations (the
        # MoE router's) take the f32 product itself.
        if x2.dtype == torch.float32:
            out = torch.mm(x2, q.to(torch.float32)) * s
        else:
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
    splits, k_split, partials, arrivals = _split_k(
        x.device, m, k, n, INT8_TILE_COLS, INT8_CTAS_PER_SM, one_wave=True)
    device = _cuda.check_cuda("int8_matmul", x2, q, s, out)
    _cuda.launch("aiko_int8_matmul", device, x2.data_ptr(), q.data_ptr(),
                 s.data_ptr(), out.data_ptr(), _cuda.ptr(partials),
                 _cuda.ptr(arrivals), m, k, n, splits, k_split)
    int8_matmul.launches += 1
    return out.reshape(*lead, n)


#: SMs of an H100 SXM.
_SMS = 132
#: Output columns of one CTA of each weight matmul kernel, and the CTAs on
#: each SM its K split aims at (the same split for every m).  int4: three,
#: what its m <= 8 instance holds.  int8: two, though its m <= 16
#: instances hold three: fewer, longer slices halve the merge's partials,
#: which bound m >= 40 (lab, ``--tunings`` ``split2``), and cost m = 8
#: nothing.
INT8_TILE_COLS, INT8_CTAS_PER_SM = 256, 2
INT4_TILE_COLS, INT4_CTAS_PER_SM = 256, 3


@functools.lru_cache(maxsize=None)
def _k_split(k: int, tiles: int, per_sm: int, one_wave: bool = False):
    """(slices, rows per slice) of the K axis for a launch of ``tiles``
    output tiles: enough tile x K-slice CTAs for about ``per_sm`` on each
    SM (``one_wave``: never more, so no wave runs part full), each slice
    at least four 64-row pipeline stages."""
    ctas = per_sm * _SMS
    splits = ctas // tiles if one_wave else -(-ctas // tiles)
    splits = max(1, min(splits, k // 256))
    rows = -(-k // splits)
    rows = -(-rows // 64) * 64
    return -(-k // rows), rows


def _split_k(device: torch.device, m: int, k: int, n: int, cols: int,
             per_sm: int, one_wave: bool = False, tiled: bool = False):
    """(slices, rows per slice, partials, arrivals) of an (m, K, N) launch
    of a weight matmul kernel whose CTAs own ``cols`` columns, K split by
    :func:`_k_split` (``tiled``: the int4 kernel's m-tiled instance,
    64-row tiles of m): the f32 partial tiles and arrival counters of the
    split-K merge (None when K is not split).  The split depends on (K,
    N) and the tiles of m alone, so a row's sum is the same for every m
    of one instance."""
    tiles = -(-n // cols) * (-(-m // 64) if tiled else 1)
    splits, k_split = _k_split(k, tiles, per_sm, one_wave)
    if splits == 1:
        return splits, k_split, None, None
    rows = 64 if tiled else next(r for r in (8, 16, 32, 64) if m <= r)
    partials, arrivals = _cuda.scratch(device, tiles * splits * rows * cols,
                                       tiles)
    return splits, k_split, partials, arrivals


#: Kernel launches on the CUDA path (never counts the plain versions).
_cuda.counted(int8_matmul)


# --------------------------------------------------------------------------- #
# Int4 (nibble-packed, per-group scales)
#
# Packing layout, as the JAX package's: adjacent input rows share a byte,
# ``packed[k, n]`` holds ``w[2k, n]`` in its low nibble and ``w[2k+1, n]``
# in its high nibble, both two's complement.

def quantize_int4(w: torch.Tensor,
                  group_size: int = 128) -> Dict[str, torch.Tensor]:
    """Per-(input-group, output-channel) symmetric int4 quantization of a
    2-D weight ``(in, out)`` -> ``{"q4": int8 (in/2, out) nibble-packed,
    "s": f32 (in/group, out)}``.  An odd ``group_size`` or one that does
    not divide ``in`` makes the whole input axis one group, as in the JAX
    package.  Rounds half to even."""
    w32 = w.to(torch.float32)
    k, n = w32.shape
    if k % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {k}")
    if group_size % 2 or k % group_size:
        group_size = k
    groups = k // group_size
    grouped = w32.reshape(groups, group_size, n)
    amax = grouped.abs().amax(dim=1, keepdim=True)
    scale = amax / torch.full_like(amax, QMAX4)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(grouped / scale), -QMAX4, QMAX4)
    q = q.reshape(k, n).to(torch.int32)
    packed = (q[0::2] & 0xF) | ((q[1::2] & 0xF) << 4)
    packed = torch.where(packed >= 128, packed - 256, packed)
    return {"q4": packed.to(torch.int8), "s": scale.reshape(groups, n)}


def _unpack_int4(packed: torch.Tensor):
    """int8 (K/2, N) -> (low, high) int32 nibbles, sign-extended: low[k]
    is original row 2k, high[k] row 2k+1."""
    p = packed.to(torch.int32)
    return ((p & 0xF) ^ 8) - 8, p >> 4


def _unpacked_rows(packed: torch.Tensor) -> torch.Tensor:
    """int8 (K/2, N) -> int32 (K, N) codes in original row order."""
    low, high = _unpack_int4(packed)
    khalf, n = packed.shape
    return torch.stack([low, high], dim=1).reshape(2 * khalf, n)


def dequantize_int4(qw: Dict[str, torch.Tensor],
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``q * s[group]`` in f32, cast to ``dtype`` -> (K, N)."""
    packed, scale = qw["q4"], qw["s"]
    q = _unpacked_rows(packed).to(torch.float32)
    k, n = q.shape
    groups = scale.shape[0]
    w = q.reshape(groups, k // groups, n) * scale[:, None, :]
    return w.reshape(k, n).to(dtype)


def is_quantized_int4(w) -> bool:
    return isinstance(w, dict) and "q4" in w and "s" in w


def quantize_tree(tree, bits: int = 8, group_size: int = 128):
    """Quantize every 2-D float leaf of a parameter tree (nested dicts and
    lists; 1-D norm vectors stay as they are).  ``bits`` is 8 or 4."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")

    def visit(leaf):
        if isinstance(leaf, dict):
            return {key: visit(value) for key, value in leaf.items()}
        if isinstance(leaf, list):
            return [visit(value) for value in leaf]
        if torch.is_tensor(leaf) and leaf.ndim == 2 \
                and leaf.is_floating_point():
            if bits == 4:
                return quantize_int4(leaf, group_size)
            return quantize_int8(leaf)
        return leaf
    return visit(tree)


#: The JAX repeat kernel's hardware envelope (``_REPEAT_VALIDATED``):
#: packed rows -> output-column blocks; kept only as the shape rule.
_REPEAT_VALIDATED = {2048: (256, 128), 7168: (128,)}


def _pick_block_repeat(khalf: int, n: int) -> int:
    for block in _REPEAT_VALIDATED.get(khalf, ()):
        if n % block == 0:
            return block
    return 0


def _pick_block_int4(m: int, khalf: int, n: int, groups: int) -> int:
    """The JAX grouped kernel's output-column block (0 = no fit in its
    VMEM budget); kept only as the shape rule."""
    for block in (1024, 512, 256, 128):
        if n % block:
            continue
        gs_half = khalf // groups
        working_set = (2 * 2 * m * khalf + khalf * block + 4 * groups * block
                       + 4 * m * block + 12 * gs_half * block)
        if working_set <= _VMEM_BUDGET:
            return block
    return 0


@functools.lru_cache(maxsize=None)
def int4_kernel_shape(m: int, k: int, n: int, groups: int) -> bool:
    """True where the JAX package runs a Pallas int4 kernel on hardware:
    m <= 64, groups of a multiple of 64 rows (packed group rows >= 32 and
    % 32), and a block from either kernel's picker."""
    khalf = k // 2
    gs_half = khalf // groups
    if m > 64 or gs_half < 32 or gs_half % 32:
        return False
    return bool(_pick_block_repeat(khalf, n)
                or _pick_block_int4(m, khalf, n, groups))


def int4_matmul_reference(x: torch.Tensor, q4: torch.Tensor,
                          s: torch.Tensor) -> torch.Tensor:
    """Plain version, scale after the group (the path's numerics and the
    JAX package's CPU fallback): nibbles and x in f32, one f32 partial per
    group, times ``s[g]``, summed over the groups, cast to ``x.dtype``."""
    khalf, n = q4.shape
    k, groups = 2 * khalf, s.shape[0]
    lead = x.shape[:-1]
    x3 = x.reshape(-1, groups, k // groups).to(torch.float32)
    w3 = _unpacked_rows(q4).to(torch.float32).reshape(groups, k // groups, n)
    partials = torch.bmm(x3.transpose(0, 1), w3)          # (G, m, N)
    out = (partials * s.to(torch.float32)[:, None, :]).sum(dim=0)
    return out.to(x.dtype).reshape(*lead, n)


def int4_matmul_scale_first_reference(x: torch.Tensor, q4: torch.Tensor,
                                      s: torch.Tensor) -> torch.Tensor:
    """Plain version, scale first (the JAX repeat kernel's numerics): the
    operand is ``bf16(q * s)``, the product accumulates in f32, cast to
    ``x.dtype``."""
    khalf, n = q4.shape
    lead = x.shape[:-1]
    w = dequantize_int4({"q4": q4, "s": s}, torch.bfloat16)
    out = x.reshape(-1, 2 * khalf).to(torch.float32) @ w.to(torch.float32)
    return out.to(x.dtype).reshape(*lead, n)


def _int4_launch(name: str, x2: torch.Tensor, q4: torch.Tensor,
                 s: torch.Tensor, scale_first: bool = False,
                 tiled: bool = False) -> torch.Tensor:
    """Check the operands and launch ``csrc/int4_matmul.cu``: its m <= 64
    instance (either numerics), or with ``tiled`` its m-tiled instance
    (scale after each group, any m)."""
    khalf, n = q4.shape
    k, groups = 2 * khalf, s.shape[0]
    m = x2.shape[0]
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bf16 activations, got "
                        f"{x2.dtype}")
    if q4.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"{name}: q4 must be int8 and s float32")
    if s.ndim != 2 or s.shape[1] != n or groups * (k // groups) != k:
        raise ValueError(f"{name}: scale shape {tuple(s.shape)} does not "
                         f"split K={k} x N={n} into whole groups")
    group = k // groups
    if (m > 64 and not tiled) or not m or group % 64 or n % 64:
        raise ValueError(f"{name}: the kernel takes "
                         f"{'m >= 1' if tiled else 'm <= 64'}, groups of a "
                         f"multiple of 64 rows and N % 64; got m={m}, "
                         f"group {group}, N={n}")
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    splits, k_split, partials, arrivals = _split_k(
        x2.device, m, k, n, INT4_TILE_COLS, INT4_CTAS_PER_SM, one_wave=True,
        tiled=tiled)
    device = _cuda.check_cuda(name, x2, q4, s, out)
    pointers = (x2.data_ptr(), q4.data_ptr(), s.data_ptr(), out.data_ptr(),
                _cuda.ptr(partials), _cuda.ptr(arrivals), m, k, n, group,
                splits, k_split)
    if tiled:
        _cuda.launch("aiko_int4_matmul_tiled", device, *pointers)
    else:
        _cuda.launch("aiko_int4_matmul", device, *pointers, int(scale_first))
    return out


def tiles_int4(k: int, n: int, groups: int) -> bool:
    """True where the m-tiled int4 instance takes a (., K, N) weight of
    ``groups`` groups: groups of a multiple of 64 rows and N % 64 == 0
    (every projection of the full-size llama configs; not the tiny
    configs' d_ff of 352)."""
    return groups * (k // groups) == k and (k // groups) % 64 == 0 \
        and n % 64 == 0


def int4_matmul_grouped(x2: torch.Tensor, q4: torch.Tensor,
                        s: torch.Tensor) -> torch.Tensor:
    """The JAX package's large-m product (its f32 grouped einsum
    ``"mgk,gkn,gn->mn"``) written out for a CUDA tensor at a shape no
    kernel instance tiles: per group of x's columns and q's rows, one
    ``torch.mm`` with an f32 result (the nibbles are exact in bf16),
    scaled by ``s[g]`` in f32 and summed.  No weight is rounded.  f32
    activations (the MoE router's) take f32 products."""
    khalf, n = q4.shape
    k, groups = 2 * khalf, s.shape[0]
    group = k // groups
    codes = _unpacked_rows(q4).to(x2.dtype)
    out = torch.zeros((x2.shape[0], n), dtype=torch.float32,
                      device=x2.device)
    for g in range(groups):
        rows = slice(g * group, (g + 1) * group)
        if x2.dtype == torch.float32:
            part = torch.mm(x2[:, rows], codes[rows])
        else:
            part = torch.mm(x2[:, rows], codes[rows], out_dtype=torch.float32)
        out += part * s[g].to(torch.float32)
    return out.to(x2.dtype)


def int4_matmul(x: torch.Tensor, q4: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ dequant(q4 (K/2, N) packed, s (G, N)) -> (..., N)``
    in ``x.dtype``, scaled after each group at every shape (the JAX
    package's numerics: its grouped kernel at decode shapes, its f32
    grouped einsum at the rest).  CPU tensors take
    :func:`int4_matmul_reference`.  On CUDA, shapes of
    :func:`int4_kernel_shape` launch the m <= 64 instance of
    ``csrc/int4_matmul.cu``; the rest launch its m-tiled instance
    (:func:`int4_matmul_tiled`) where :func:`tiles_int4`, else take
    :func:`int4_matmul_grouped`.  The kernel instances take bf16
    activations and raise on another dtype."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, q4, s)
    khalf, n = q4.shape
    k, groups = 2 * khalf, s.shape[0]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    if int4_kernel_shape(x2.shape[0], k, n, groups):
        out = _int4_launch("int4_matmul", x2, q4, s)
        int4_matmul.launches += 1
    elif tiles_int4(k, n, groups):
        out = int4_matmul_tiled(x2, q4, s)
    else:
        out = int4_matmul_grouped(x2, q4, s)
    return out.reshape(*lead, n)


def int4_matmul_tiled(x: torch.Tensor, q4: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """The int4 kernel's m-tiled instance (scale after each group, any m;
    every int4 prefill slice of m > 64): ``x (..., K) @ dequant(q4, s)``.
    CPU tensors take :func:`int4_matmul_reference`; on CUDA it launches
    the kernel or raises."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, q4, s)
    khalf, n = q4.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, 2 * khalf).contiguous()
    out = _int4_launch("int4_matmul_tiled", x2, q4, s, tiled=True)
    int4_matmul_tiled.launches += 1
    return out.reshape(*lead, n)


def int4_matmul_scale_first(x: torch.Tensor, q4: torch.Tensor,
                            s: torch.Tensor) -> torch.Tensor:
    """The kernel's scale-first instance (the JAX repeat kernel's and the
    kernel lab's ``matmul_repeat`` numerics): ``x @ bf16(q * s)``.  The
    serving path never calls it; the lab and the card's checks do.  CPU
    tensors take :func:`int4_matmul_scale_first_reference`; on CUDA it
    launches the kernel or raises."""
    if x.device.type == "cpu":
        return int4_matmul_scale_first_reference(x, q4, s)
    khalf, n = q4.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, 2 * khalf).contiguous()
    out = _int4_launch("int4_matmul_scale_first", x2, q4, s,
                       scale_first=True)
    int4_matmul_scale_first.launches += 1
    return out.reshape(*lead, n)


#: Kernel launches on the CUDA path (never counts the plain versions).
_cuda.counted(int4_matmul)
_cuda.counted(int4_matmul_tiled)
_cuda.counted(int4_matmul_scale_first)
