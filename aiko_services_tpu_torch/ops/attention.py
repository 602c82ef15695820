"""Attention: the hand-written flash-attention kernel and its plain version.

Port of ``aiko_services_tpu/ops/attention.py``.  Layout ``(batch, heads,
seq, head_dim)``.  :func:`flash_attention` launches
``csrc/flash_attention.cu`` on CUDA tensors and runs
:func:`attention_reference` (with K/V repeated to the query heads, as the
JAX fallback does) on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda

__all__ = ["flash_attention", "attention_reference", "NEG_INF"]

NEG_INF = -1e30
# NEG_INF must stay FINITE (never -inf): with sliding-window masking a
# q-row can be fully masked inside the first LIVE k-block, making every
# score NEG_INF -> m_new == NEG_INF and p == exp(0) == 1 of bogus mass.
# That mass is cancelled later only because the row's diagonal block is
# guaranteed live and its rescale correction exp(NEG_INF - m_real)
# underflows to exactly 0.0.  With -inf the same update computes
# exp(-inf - (-inf)) = NaN.  The CUDA kernels share the value
# (AIKO_NEG_INF in csrc/common.cuh).
assert NEG_INF < 0 and NEG_INF > float("-inf")


def _visible(q_len: int, k_len: int, window: Optional[int],
             device) -> torch.Tensor:
    q_ids = torch.arange(q_len, device=device)[:, None] + (k_len - q_len)
    k_ids = torch.arange(k_len, device=device)[None, :]
    visible = k_ids <= q_ids
    if window is not None:
        visible &= k_ids > q_ids - window
    return visible


def attention_reference(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None):
    """Plain attention (the numerics oracle and CPU path).  ``window``
    (requires ``causal``): each query attends to at most the ``window``
    most recent positions including itself.  Scores and softmax in f32;
    the weights are cast to ``v.dtype`` before the weighted sum, as in
    the JAX package."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * sm_scale
    if causal:
        visible = _visible(logits.shape[-2], logits.shape[-1], window,
                           logits.device)
        logits = torch.where(visible, logits,
                             torch.full_like(logits, NEG_INF))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype),
                        v).to(q.dtype)


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None):
    """Causal (optionally sliding-window) attention with native GQA:
    ``k``/``v`` may carry fewer heads than ``q`` (``heads % kv_heads ==
    0``); query head ``h`` reads kv head ``h // group`` and the CUDA
    kernel never repeats K/V in memory.

    On CUDA tensors the kernel loads q, k and v by TMA through tensor maps
    built from their strides (cached by pointer, shape and strides), so
    each must be bf16 with a contiguous feature axis, strides in multiples
    of 8 elements and a 16-byte-aligned start, with at most 64 query heads
    a kv head; anything else raises (there is no other path)."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    batch, heads, q_len, head_dim = q.shape
    kv_heads, k_len = k.shape[1], k.shape[2]
    if heads % kv_heads:
        raise ValueError(f"heads {heads} not a multiple of kv heads "
                         f"{kv_heads}")
    group = heads // kv_heads
    if q.device.type == "cpu":
        k_full = k.repeat_interleave(group, dim=1) if group > 1 else k
        v_full = v.repeat_interleave(group, dim=1) if group > 1 else v
        return attention_reference(q, k_full, v_full, causal=causal,
                                   sm_scale=sm_scale, window=window)
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"flash_attention: the kernel takes bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if head_dim not in (16, 32, 64, 128):
        raise ValueError(f"flash_attention: head_dim {head_dim} outside "
                         "the kernel's envelope (16, 32, 64 or 128)")
    if group > 64:
        raise ValueError(f"flash_attention: {group} query heads a kv head; "
                         "the kernel packs at most 64 into its tile rows")
    if causal and q_len > k_len:
        raise ValueError("flash_attention: causal with q_len > k_len "
                         "leaves rows with no visible key")
    if k.shape[0] != batch or v.shape != k.shape \
            or k.shape[3] != head_dim:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    for name, tensor in (("q", q), ("k", k), ("v", v)):
        if tensor.stride(-1) != 1 or any(st % 8 for st in tensor.stride()[:3]) \
                or tensor.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             "feature axis, strides in multiples of 8 "
                             "elements and a 16-byte-aligned start")
    out = torch.empty((batch, heads, q_len, head_dim), dtype=q.dtype,
                      device=q.device)
    device = _cuda.check_cuda("flash_attention", out)
    for tensor in (q, k, v):
        if tensor.device != device:
            raise ValueError("flash_attention: tensors on different "
                             "devices")
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    _cuda.launch("aiko_flash_attention", device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), batch, heads, kv_heads,
                 q_len, k_len, head_dim, ctypes.addressof(strides),
                 int(causal), int(window or 0), float(sm_scale))
    flash_attention.launches += 1
    return out


#: Kernel launches on the CUDA path (never counts the plain version).
_cuda.counted(flash_attention)
