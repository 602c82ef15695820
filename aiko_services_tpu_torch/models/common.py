"""Shared model building blocks (LayerNorm-family encoders).

Port of ``aiko_services_tpu/models/common.py``: used by
:mod:`.classifier` and :mod:`.vision` (and by the ASR model once it is
ported, ``ROADMAP.md`` queue 1 item 9b).  :mod:`.llama` uses RMSNorm/GQA
and keeps its own blocks.  These are plain PyTorch, as the JAX package
computes them outside any Pallas kernel (its ``mha`` calls
``attention_reference``, not ``flash_attention``).  The casts sit where
the JAX code puts them: the population variance in f32, the normalized
value rounded to ``x.dtype`` before the weight, GELU exact (erf) in f32
then cast.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.attention import attention_reference

__all__ = ["layer_norm", "mha", "gelu_mlp"]

LN_EPS = 1e-6


def layer_norm(x, weight, eps: float = LN_EPS, bias=None):
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype) * weight
    return out if bias is None else out + bias


def _add(x, bias):
    return x if bias is None else x + bias


def mha(x_q, x_kv, w_in, wo, n_heads: int, causal: bool,
        cross: bool = False, wkv=None, b_in=None, b_o=None, b_kv=None):
    """Fused-projection multi-head attention.

    Self-attention: ``w_in`` is the (d, 3d) qkv projection and ``x_kv``
    is ignored.  Cross-attention (``cross=True``): ``w_in`` is the
    (d, d) q projection and ``wkv`` the (d_kv, 2d) kv projection over
    ``x_kv``.  Biases are optional (randomly-initialised models omit
    them; imported checkpoints carry them).
    """
    b, q_len, d = x_q.shape
    hd = d // n_heads
    if cross:
        q = _add(x_q @ w_in, b_in).reshape(b, q_len, n_heads, hd)
        kv = _add(x_kv @ wkv, b_kv).reshape(
            b, x_kv.shape[1], 2, n_heads, hd)
        k, v = kv[:, :, 0], kv[:, :, 1]
    else:
        qkv = _add(x_q @ w_in, b_in).reshape(b, q_len, 3, n_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = attention_reference(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal)
    out = out.transpose(1, 2).reshape(b, q_len, d)
    return _add(out @ wo, b_o).to(x_q.dtype)


def gelu_mlp(x, norm_weight, w1, w2, norm_bias=None, b1=None, b2=None,
             eps: float = LN_EPS):
    normed = layer_norm(x, norm_weight, eps=eps, bias=norm_bias)
    # Exact (erf) GELU, what torch nn.GELU() computes: BERT-family, ViT
    # and Whisper checkpoints are trained with it.
    hidden = F.gelu(_add(normed @ w1, b1).to(torch.float32),
                    approximate="none").to(x.dtype)
    return x + _add(hidden @ w2, b2)
