"""Llama-3-architecture decoder-only transformer in PyTorch.

Port of the serving subset of ``aiko_services_tpu/models/llama.py``:
parameters are a plain dict of tensors in the JAX package's layouts
(weights ``(in, out)``, KV ``(batch, max_seq, kv_heads, head_dim)``), so
the two packages run on the same weights through
:mod:`~aiko_services_tpu_torch.models.bridge`.

Architecture (Llama 3): RMSNorm pre-norm, rotary position embeddings,
grouped-query attention, SwiGLU MLP, untied LM head, bfloat16 params with
f32 norm/softmax accumulation.  The casts sit where the JAX code puts
them: bf16 agreement depends on them.

Hand-written CUDA kernels carry the serving paths: ``int8_matmul`` or
``int4_matmul`` (by the weights' layout) in every projection at decode
shapes, ``flash_attention`` in contiguous prefill, ``write_kv_rows`` (the
KV writer's row mode) and ``paged_decode_attention`` in every decode step
(contiguous caches feed both as a degenerate pool), ``append_kv`` +
``chunk_attention`` in paged admission (:func:`prefill_append_paged`,
:func:`serve_chunk_mixed`), and ``append_kv_ragged`` + ``chunk_attention``
in the speculative verify (:func:`verify_chunk_paged`) and in the chunked
forwards over a contiguous cache (:func:`prefill_chunk`,
:func:`verify_chunk_ragged`; the cache seen as a degenerate pool again).
Each takes its plain version only on CPU tensors; on the card a contiguous
cache whose row count has no block view (:func:`~..ops.paged_attention.
contiguous_block_size` 0) raises, and the entry points that size their
own caches round them up (:func:`~..ops.paged_attention.contiguous_rows`).
A rolling cache (a ring of ``sliding_window`` rows, each with its stored
position) is read by the plain masked attention on every device, as in
the JAX package: its rows are not in position order, so no block view of
it exists for attention.  Its decode write is ``write_kv_rows``'s all the
same, row ``pos % window`` of a pool of ``batch`` blocks of ``window``
rows.

JAX donates caches to its jitted programs; here caches are updated IN
PLACE (each write function mutates and returns the same per-layer dict),
which is what donation buys on the TPU.  ``lax.scan`` becomes a Python
loop over steps; EOS/budget retirement stays on the device as
``torch.where`` on the state tensors, with no host sync per step.  On the
card the steady greedy chunk is one program, as the jitted one is: a
:class:`ChunkGraph` captures it as a CUDA graph over static state buffers
and replays it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import _cuda
from ..ops.attention import flash_attention
from ..ops.paged_attention import (cached_gqa_attention,
                                   contiguous_block_size, contiguous_rows,
                                   paged_decode_attention)
from ..ops.paged_prefill import (DecodeRows, KVLayer, _gathered_view,
                                 _kv_quantize_rows, _pool_sources,
                                 _write_rows_reference, append_kv_ragged,
                                 chunk_attention, paged_prefill_attention,
                                 paged_verify_attention, write_decode_rows)
from ..ops.quant import (_unpack_int4, int4_matmul, int8_matmul,
                         is_quantized, is_quantized_int4, quantize_tree)

__all__ = ["LlamaConfig", "CONFIGS", "init_params", "quantize_params",
           "random_quantized_params", "forward", "init_cache", "prefill",
           "decode_step", "generate_tokens", "serve_chunk_ragged",
           "scatter_state_rows", "scatter_state_rows_", "ChunkGraph",
           "sample_logits", "rms_norm",
           "apply_rope", "init_paged_cache", "decode_chunk_paged",
           "serve_chunk_paged", "prefill_append_paged",
           "serve_chunk_mixed", "paged_insert_prefix", "paged_scatter_blocks",
           "paged_gather_blocks", "verify_chunk_paged", "sampling_probs",
           "prefill_chunk", "verify_chunk_ragged", "decode_chunk_ragged",
           "sample_tokens_with_logits", "complete"]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1376
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dtype: Any = torch.bfloat16
    #: > 0 switches the MLP to a mixture-of-experts (Mixtral-class,
    #: :mod:`.moe`).  Capacity-based dropping makes routing batch-dependent;
    #: ``moe_capacity_factor >= n_experts / moe_top_k`` drops nothing, which
    #: keeps decode exactly consistent with the full-sequence forward.
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    #: Mistral-style sliding-window attention (None = full causal).
    sliding_window: Optional[int] = None
    #: Llama-3.1 RoPE rescaling (factor, low_freq_factor,
    #: high_freq_factor, original_max_position_embeddings).
    rope_scaling: Optional[Tuple[float, float, float, int]] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def moe_config(self):
        from .moe import MoEConfig
        return MoEConfig(d_model=self.d_model, d_ff=self.d_ff,
                         n_experts=self.n_experts, top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor,
                         dtype=self.dtype)


#: The JAX package's named configs, same names and sizes.
CONFIGS: Dict[str, LlamaConfig] = {
    "tiny": LlamaConfig(vocab_size=1024, d_model=128, n_layers=2,
                        n_heads=4, n_kv_heads=2, d_ff=352,
                        max_seq_len=512),
    "tiny_tp": LlamaConfig(vocab_size=1024, d_model=128, n_layers=2,
                           n_heads=16, n_kv_heads=8, d_ff=352,
                           max_seq_len=512),
    "small": LlamaConfig(vocab_size=32_000, d_model=1024, n_layers=8,
                         n_heads=16, n_kv_heads=8, d_ff=2816,
                         max_seq_len=2048),
    "1b": LlamaConfig(vocab_size=128_256, d_model=2048, n_layers=16,
                      n_heads=32, n_kv_heads=8, d_ff=8192,
                      max_seq_len=8192),
    "llama3_8b": LlamaConfig(vocab_size=128_256, d_model=4096,
                             n_layers=32, n_heads=32, n_kv_heads=8,
                             d_ff=14_336, max_seq_len=8192),
    "llama3_70b": LlamaConfig(vocab_size=128_256, d_model=8192,
                              n_layers=80, n_heads=64, n_kv_heads=8,
                              d_ff=28_672, max_seq_len=8192),
    "moe_tiny": LlamaConfig(vocab_size=1024, d_model=128, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=352,
                            max_seq_len=512, n_experts=4),
    "moe_tiny8": LlamaConfig(vocab_size=1024, d_model=128, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=352,
                             max_seq_len=512, n_experts=8,
                             moe_capacity_factor=4.0),
    "moe_small": LlamaConfig(vocab_size=32_000, d_model=1024,
                             n_layers=8, n_heads=16, n_kv_heads=8,
                             d_ff=2816, max_seq_len=2048, n_experts=8,
                             moe_capacity_factor=4.0),
    "mixtral_8x7b": LlamaConfig(vocab_size=32_000, d_model=4096,
                                n_layers=32, n_heads=32, n_kv_heads=8,
                                d_ff=14_336, max_seq_len=32_768,
                                rope_theta=1e6, n_experts=8,
                                moe_capacity_factor=4.0),
    "mistral_7b": LlamaConfig(vocab_size=32_000, d_model=4096,
                              n_layers=32, n_heads=32, n_kv_heads=8,
                              d_ff=14_336, max_seq_len=32_768,
                              rope_theta=10_000.0, sliding_window=4096),
    "mistral_tiny": LlamaConfig(vocab_size=1024, d_model=128,
                                n_layers=2, n_heads=4, n_kv_heads=2,
                                d_ff=352, max_seq_len=512,
                                sliding_window=16),
}


# --------------------------------------------------------------------------- #
# Parameters

def _dense_init(generator, shape, dtype, device, scale=None):
    scale = scale if scale is not None else shape[0] ** -0.5
    values = torch.randn(shape, generator=generator, device=device,
                         dtype=torch.float32)
    return (values * scale).to(dtype)


def init_params(config: LlamaConfig, seed: int = 0,
                device=None) -> Dict:
    """Random dense parameters (fan-in-scaled gaussians, unit norms) in
    the JAX package's tree layout, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``.  MoE configs draw ``layer["moe"]``
    (:func:`~.moe.init_moe_params`) in place of the dense MLP."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    dt = config.dtype
    d, h, kv, hd, f = (config.d_model, config.n_heads, config.n_kv_heads,
                       config.head_dim, config.d_ff)

    def dense(shape, scale=None):
        return _dense_init(generator, shape, dt, device, scale)

    layers = []
    for _ in range(config.n_layers):
        layer = {
            "attn_norm": torch.ones((d,), dtype=dt, device=device),
            "wq": dense((d, h * hd)),
            "wk": dense((d, kv * hd)),
            "wv": dense((d, kv * hd)),
            "wo": dense((h * hd, d)),
            "mlp_norm": torch.ones((d,), dtype=dt, device=device),
        }
        if config.n_experts:
            from .moe import init_moe_params
            layer["moe"] = init_moe_params(config.moe_config, device=device,
                                           generator=generator)
        else:
            layer.update({"w_gate": dense((d, f)), "w_up": dense((d, f)),
                          "w_down": dense((f, d))})
        layers.append(layer)
    return {
        "embed": dense((config.vocab_size, d), 1.0),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dt, device=device),
        "lm_head": dense((d, config.vocab_size)),
    }


def quantize_params(params, bits: int = 8) -> Dict:
    """Weight-only quantization of every 2-D float leaf (norm vectors stay
    in the model dtype).  ``bits=8``: per-output-channel int8.  ``bits=4``:
    nibble-packed int4 with per-128-row-group scales; the embedding stays
    int8, because its read path is a row gather.  A MoE layer's 2-D router
    quantizes and its 3-D experts stay in the model dtype, the same
    tensors in the int8 and the int4 tree."""
    if bits == 4:
        quantized = quantize_tree(params, bits=4)
        quantized["embed"] = quantize_tree(params["embed"])
        return quantized
    return quantize_tree(params)


def random_quantized_params(config: LlamaConfig, seed: int = 0,
                            bits: int = 8, device=None) -> Dict:
    """Random quantized params built DIRECTLY in quantized form on
    ``device`` from a ``torch.Generator``: the bf16 tree, two (int8) or
    four (int4) times the bytes, is never made.  Same structure as
    ``quantize_params(init_params(...), bits)``: int8 leaves ``{"q": int8
    (in, out), "s": f32 (1, out)}``; int4 leaves ``{"q4": int8 (in/2, out)
    packed bytes drawn uniformly from [-128, 128), "s": f32 (max(1,
    in/128), out)}`` with the embedding int8.  Scales make the dequantized
    weights look like fan-in-scaled gaussians, so activations stay finite
    through all layers."""
    if config.n_experts:
        raise NotImplementedError(
            "random_quantized_params covers dense configs; MoE expert "
            "weights are 3-D and stay bf16 under quantize_params")
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    c = config
    d, h, kv, hd, f = (c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
                       c.d_ff)

    def q8weight(shape):
        q = torch.randint(-127, 128, shape, generator=generator,
                          device=device, dtype=torch.int8)
        s = torch.full((1, shape[1]), shape[0] ** -0.5 / 127.0,
                       dtype=torch.float32, device=device)
        return {"q": q, "s": s}

    def q4weight(shape):
        kin, n = shape
        packed = torch.randint(-128, 128, (kin // 2, n), generator=generator,
                               device=device, dtype=torch.int8)
        s = torch.full((max(1, kin // 128), n), kin ** -0.5 / 7.0,
                       dtype=torch.float32, device=device)
        return {"q4": packed, "s": s}

    qweight = q4weight if bits == 4 else q8weight

    def norm():
        return torch.ones((d,), dtype=c.dtype, device=device)

    layers = []
    for _ in range(c.n_layers):
        layers.append({
            "attn_norm": norm(),
            "wq": qweight((d, h * hd)),
            "wk": qweight((d, kv * hd)),
            "wv": qweight((d, kv * hd)),
            "wo": qweight((h * hd, d)),
            "mlp_norm": norm(),
            "w_gate": qweight((d, f)),
            "w_up": qweight((d, f)),
            "w_down": qweight((f, d)),
        })
    return {"embed": q8weight((c.vocab_size, d)), "layers": layers,
            "final_norm": norm(), "lm_head": qweight((d, c.vocab_size))}


def _matmul(x, w):
    """Dense or int8/int4-quantized matmul, transparently."""
    if is_quantized_int4(w):
        return int4_matmul(x, w["q4"], w["s"])
    if is_quantized(w):
        return int8_matmul(x, w["q"], w["s"])
    return x @ w


# --------------------------------------------------------------------------- #
# Batched multi-adapter LoRA (S-LoRA style serving)
#
# Every row of a serving batch may run a DIFFERENT adapter: per-layer factors
# are stacked over a leading adapter axis, ``a`` (n_adapters, d_in, r) and
# ``b`` (n_adapters, r, d_out), index 0 the all-zero identity (a base-model
# row), and each row gathers its own pair.  The base weight stream is paid
# once for the whole mixed batch through ``_matmul`` (the int8 / int4
# kernels unchanged); the rank-r delta is two small f32 einsums, as the JAX
# package computes it outside any kernel.  ``lora``: ``{"scale": alpha / r,
# "layers": [{target: {"a", "b"}}], "ids": (batch,) int}``, or None, and with
# None every call site below runs exactly the adapter-free program.

def _lora_delta(x, factors, ids, scale):
    """Per-row low-rank delta: ``x`` (batch, q, d_in) through row ``i``'s
    own (A, B) = (factors["a"][ids[i]], factors["b"][ids[i]]), in f32 and
    cast back: two einsums, ``x @ A`` then ``@ B``."""
    ids = ids.to(torch.int64)
    a = factors["a"][ids].to(torch.float32)        # (batch, d_in, r)
    b = factors["b"][ids].to(torch.float32)        # (batch, r, d_out)
    hidden = torch.einsum("bqd,bdr->bqr", x.to(torch.float32), a)
    delta = torch.einsum("bqr,bro->bqo", hidden, b)
    return (delta * scale).to(x.dtype)


def _lora_matmul(x, w, lora_layer, target: str, lora):
    """The base matmul plus the row-gathered adapter delta when ``target``
    is adapted; exactly :func:`_matmul` otherwise."""
    out = _matmul(x, w)
    factors = lora_layer.get(target) if lora_layer else None
    if factors is not None:
        out = out + _lora_delta(x, factors, lora["ids"], lora["scale"])
    return out


def _lora_layers(lora, n_layers: int) -> List:
    """Per-layer factor dicts of ``lora`` (None a layer without one)."""
    return lora["layers"] if lora else [None] * n_layers


def _with_ids(lora_shared, ids):
    """The stacked factors ``lora_shared`` (or None) with per-row ``ids``."""
    return dict(lora_shared, ids=ids) if lora_shared is not None else None


def _embed_lookup(params, tokens, dtype):
    embed = params["embed"]
    tokens = tokens.to(torch.int64)
    if is_quantized_int4(embed):
        # Packed rows hold vocab rows (2k, 2k+1) in (low, high) nibbles:
        # gather the byte row, then take the token's nibble.
        low, high = _unpack_int4(embed["q4"][tokens // 2])
        q = torch.where((tokens % 2 == 0)[..., None], low, high)
        group = 2 * embed["q4"].shape[0] // embed["s"].shape[0]
        scale = embed["s"][tokens // group]
        return (q.to(torch.float32) * scale).to(dtype)
    if is_quantized(embed):
        # Gather int8 rows, dequantize with the per-feature scales.
        return (embed["q"][tokens].to(torch.float32)
                * embed["s"]).to(dtype)
    return embed[tokens]


# --------------------------------------------------------------------------- #
# Building blocks

def rms_norm(x, weight, eps):
    """``x * rsqrt(mean(x^2) + eps)`` in f32, cast to the model dtype
    BEFORE the weight multiplies, as the JAX code does."""
    normed = F.rms_norm(x.to(torch.float32), (x.shape[-1],), eps=eps)
    return normed.to(x.dtype) * weight


@functools.lru_cache(maxsize=None)
def _iota(n: int, device: torch.device, dtype=torch.int64):
    """``arange(n)`` on ``device``, made once (the decode step needs the
    same small index vectors in every layer)."""
    return torch.arange(n, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _inv_freq(config: LlamaConfig, device: torch.device):
    """Rotary inverse frequencies (head_dim/2,) f32, made once per config
    and device."""
    dim = config.head_dim
    exponents = torch.arange(0, dim, 2, dtype=torch.float32,
                             device=device) / dim
    inv_freq = 1.0 / torch.pow(
        torch.tensor(config.rope_theta, dtype=torch.float32,
                     device=device), exponents)
    if config.rope_scaling is not None:
        factor, low_fac, high_fac, original_max = config.rope_scaling
        wavelen = 2.0 * math.pi / inv_freq
        low_wavelen = original_max / low_fac
        high_wavelen = original_max / high_fac
        smooth = (original_max / wavelen - low_fac) / (high_fac - low_fac)
        smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > low_wavelen, inv_freq / factor,
            torch.where(wavelen < high_wavelen, inv_freq, smoothed))
    return inv_freq


def _rope_freqs(config: LlamaConfig, positions):
    """positions (batch, seq) int -> cos/sin (batch, seq, head_dim/2)."""
    inv_freq = _inv_freq(config, positions.device)
    angles = positions[..., None].to(torch.float32) * inv_freq
    return torch.cos(angles), torch.sin(angles)


def _rope_tables(config: LlamaConfig, positions):
    """cos/sin of :func:`_rope_freqs` repeated over both halves and
    shaped (batch, seq, 1, head_dim) for :func:`_rotate`: made once per
    forward or decode step, used by every layer."""
    cos, sin = _rope_freqs(config, positions)
    return (torch.cat([cos, cos], dim=-1)[:, :, None],
            torch.cat([sin, sin], dim=-1)[:, :, None])


def _rotate(x, rope):
    """Rotate-half RoPE with full-width tables: first half x1*cos -
    x2*sin, second half x2*cos + x1*sin, in f32 (the same products and
    sums as the JAX code, in fewer ops)."""
    cos, sin = rope
    x32 = x.to(torch.float32)
    x1, x2 = torch.chunk(x32, 2, dim=-1)
    return (x32 * cos + torch.cat([-x2, x1], dim=-1) * sin).to(x.dtype)


def apply_rope(x, cos, sin):
    """x (batch, seq, heads, head_dim); rotate-half convention; cos/sin
    (batch, seq, head_dim/2) as :func:`_rope_freqs` gives them."""
    return _rotate(x, (torch.cat([cos, cos], dim=-1)[:, :, None],
                       torch.cat([sin, sin], dim=-1)[:, :, None]))


def _qkv(layer, config, x, rope, lora=None, lora_layer=None):
    """Pre-norm q/k/v projections with rotary embeddings applied: q
    (batch, seq, heads, hd), k/v (batch, seq, kv_heads, hd); adapted rows
    add their LoRA deltas (:func:`_lora_matmul`)."""
    batch, seq, _ = x.shape
    h, kv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    normed = rms_norm(x, layer["attn_norm"], config.norm_eps)
    q = _lora_matmul(normed, layer["wq"], lora_layer, "wq",
                     lora).reshape(batch, seq, h, hd)
    k = _lora_matmul(normed, layer["wk"], lora_layer, "wk",
                     lora).reshape(batch, seq, kv, hd)
    v = _lora_matmul(normed, layer["wv"], lora_layer, "wv",
                     lora).reshape(batch, seq, kv, hd)
    # One RoPE pass over q and k together: the same per-element
    # arithmetic in half the host dispatches.
    qk = _rotate(torch.cat([q, k], dim=2), rope)
    return qk[:, :, :h], qk[:, :, h:], v


def _attend_full(config, q, k, v):
    """Causal flash attention over the whole sequence; returns (batch,
    seq, heads*hd)."""
    batch, seq = q.shape[:2]
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True,
                          window=config.sliding_window)
    return out.transpose(1, 2).reshape(batch, seq,
                                       config.n_heads * config.head_dim)


def _wo(out, layer, lora=None, lora_layer=None):
    """The attention output projection (``wo``, adapted rows with their
    delta)."""
    return _lora_matmul(out, layer["wo"], lora_layer, "wo", lora)


def _attention_block(layer, config, x, rope):
    """Full-sequence (no-cache) attention block."""
    q, k, v = _qkv(layer, config, x, rope)
    out = _matmul(_attend_full(config, q, k, v), layer["wo"])
    return x + out.to(x.dtype)


def _mlp_block(layer, config, x):
    """The pre-norm MLP and its residual: SwiGLU, or on a MoE layer
    :func:`~.moe.moe_ffn` over every token of ``x`` in one call (the
    capacity follows the call's token count, as in the JAX package)."""
    normed = rms_norm(x, layer["mlp_norm"], config.norm_eps)
    if "moe" in layer:
        from .moe import moe_ffn
        return x + moe_ffn(layer["moe"], normed,
                           config.moe_config).to(x.dtype)
    gate = F.silu(_matmul(normed, layer["w_gate"]).to(torch.float32))
    up = _matmul(normed, layer["w_up"]).to(torch.float32)
    return x + _matmul((gate * up).to(x.dtype), layer["w_down"])


def _positions(batch: int, seq: int, device):
    return torch.arange(seq, device=device)[None, :].expand(batch, seq)


# --------------------------------------------------------------------------- #
# Entry points

@torch.no_grad()
def forward(params, tokens, config: LlamaConfig):
    """Full-sequence forward: tokens (batch, seq) int -> logits (batch,
    seq, vocab) f32."""
    batch, seq = tokens.shape
    rope = _rope_tables(config, _positions(batch, seq, tokens.device))
    x = _embed_lookup(params, tokens, config.dtype)
    for layer in params["layers"]:
        x = _attention_block(layer, config, x, rope)
        x = _mlp_block(layer, config, x)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return _matmul(x, params["lm_head"]).to(torch.float32)


def init_cache(config: LlamaConfig, batch: int,
               max_seq: Optional[int] = None, quantize_kv: bool = False,
               rolling: bool = False, device=None) -> List[Dict]:
    """KV cache: one dict per layer.  ``quantize_kv`` stores K/V as int8
    with per-(token, kv-head) f32 scales.  ``rolling`` (needs
    ``config.sliding_window``) keeps only the last ``window`` rows in a
    ring, row ``pos % window``, each row's absolute position stored in
    ``"pos"`` (-1 = never written) for the mask, so sliding-window decode
    memory is O(window).  The single-token decode paths take any layout;
    :func:`prefill_chunk` rejects a rolling cache for chunks longer than
    one token and :func:`verify_chunk_ragged` / :func:`decode_chunk_ragged`
    reject it, as the JAX package does."""
    if rolling:
        if not config.sliding_window:
            raise ValueError("rolling cache requires sliding_window")
        rows = config.sliding_window
    else:
        rows = max_seq or config.max_seq_len
    device = resolve_device(device)
    cache = _kv_layer_buffers(
        config, (batch, rows, config.n_kv_heads, config.head_dim),
        quantize_kv, device)
    if rolling:
        for layer in cache:
            layer["pos"] = torch.full((batch, rows), -1, dtype=torch.int32,
                                      device=device)
    return cache


def _kv_layer_buffers(config: LlamaConfig, shape, quantize_kv: bool,
                      device) -> List[Dict]:
    """Per-layer KV buffer dicts (:class:`KVLayer`, which keep what the
    decode write checked of them): the ONE place the cache layout (dtypes,
    scale keys) is defined."""
    if quantize_kv:
        sshape = shape[:-1]
        return [KVLayer(k=torch.zeros(shape, dtype=torch.int8,
                                      device=device),
                        v=torch.zeros(shape, dtype=torch.int8,
                                      device=device),
                        ks=torch.ones(sshape, dtype=torch.float32,
                                      device=device),
                        vs=torch.ones(sshape, dtype=torch.float32,
                                      device=device))
                for _ in range(config.n_layers)]
    return [KVLayer(k=torch.zeros(shape, dtype=config.dtype, device=device),
                    v=torch.zeros(shape, dtype=config.dtype, device=device))
            for _ in range(config.n_layers)]


#: (..., hd) -> (int8 rows, f32 scales (...,)): symmetric absmax per vector
#: (one scale per cached token per kv head).  The ONE quantizer of the
#: port's int8 KV: the paged append kernel reproduces it bit for bit.
_kv_quantize = _kv_quantize_rows


def _cache_write_slab(cache_layer, k, v, start_index: int):
    """Write a contiguous (batch, K, kv, hd) slab at ``start_index``, in
    place.  Rolling layout: only the last ``window`` slab rows can
    survive, so just those land at ``pos % window`` with their absolute
    positions."""
    seq = k.shape[1]
    if "pos" in cache_layer:
        window = cache_layer["pos"].shape[1]
        effective = min(seq, window)
        positions = int(start_index) + _iota(seq, k.device)[-effective:]
        rows = positions % window
        for key, src in _pool_sources(cache_layer, k[:, -effective:],
                                      v[:, -effective:]).items():
            buf = cache_layer[key]
            buf[:, rows] = src.to(buf.dtype)
        cache_layer["pos"][:, rows] = positions.to(torch.int32)
        return cache_layer
    for key, src in _pool_sources(cache_layer, k, v).items():
        buf = cache_layer[key]
        buf[:, start_index:start_index + seq] = src.to(buf.dtype)
    return cache_layer


def _cache_write_rows(cache_layer, k, v, rows: DecodeRows):
    """Write one (batch, 1, kv, hd) row per batch element at the step's
    positions, in place: :func:`write_kv_rows` on the cache viewed as a
    pool of ``batch`` blocks of ``max_seq`` rows (``rows`` from
    :func:`_cache_rows`: a position past the cache writes its last row).
    A rolling cache is a pool of ``batch`` blocks of ``window`` rows too:
    its K/V land by the same writer at row ``pos % window``, and the
    stored positions by a small index write."""
    if "pos" in cache_layer:
        window = cache_layer["pos"].shape[1]
        ring = DecodeRows(rows.tables, rows.positions % window)
        write_decode_rows(k, v, {key: buf for key, buf in cache_layer.items()
                                 if key != "pos"}, ring)
        cache_layer["pos"][_iota(k.shape[0], k.device),
                           ring.positions.to(torch.int64)] = rows.positions
        return cache_layer
    return write_decode_rows(k, v, cache_layer, rows)


def _cache_write_ragged_slab(cache_layer, k, v, starts):
    """Write a (batch, K, kv, hd) slab at PER-ROW ``starts`` (batch,), in
    place: the plain write of :func:`verify_chunk_ragged`.  A start whose
    slab would pass the cache's end is moved back to fit, as the JAX
    package's ``dynamic_update_slice`` does.  Contiguous layouts only."""
    batch, K = k.shape[:2]
    max_seq = cache_layer["k"].shape[1]
    starts = starts.to(torch.int64).clamp(0, max_seq - K)
    rows = starts[:, None] + _iota(K, k.device)[None, :]
    slots = _iota(batch, k.device)[:, None]
    for key, src in _pool_sources(cache_layer, k, v).items():
        buf = cache_layer[key]
        buf[slots, rows] = src.to(buf.dtype)
    return cache_layer


def _cache_rows(positions) -> DecodeRows:
    """A contiguous cache's decode-write targets at int32 ``positions``
    (batch,): tables :func:`_slot_tables`, a position past the cache
    clamped to its last row (the JAX package's ``dynamic_update_slice``)."""
    return DecodeRows(_slot_tables(positions.shape[0], positions.device),
                      positions, clamp=True)


@functools.lru_cache(maxsize=None)
def _slot_tables(batch: int, device: torch.device):
    """``arange(batch)[:, None]`` int32, made once: the block tables of a
    contiguous cache seen as a pool of one block a row."""
    return _iota(batch, device, torch.int32)[:, None]


@torch.no_grad()
def prefill(params, tokens, cache, config: LlamaConfig, lora=None):
    """Run the prompt through the model filling the KV cache (in place);
    returns (logits of the last position (batch, 1, vocab) f32, cache).
    ``lora``: optional batched per-row adapters (:func:`_lora_delta`)."""
    batch, seq = tokens.shape
    rope = _rope_tables(config, _positions(batch, seq, tokens.device))
    x = _embed_lookup(params, tokens, config.dtype)
    for layer, cache_layer, lora_layer in zip(
            params["layers"], cache, _lora_layers(lora, len(cache))):
        q, k, v = _qkv(layer, config, x, rope, lora, lora_layer)
        _cache_write_slab(cache_layer, k, v, 0)
        out = _attend_full(config, q, k, v)
        x = x + _wo(out, layer, lora, lora_layer).to(x.dtype)
        x = _mlp_block(layer, config, x)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = _matmul(x[:, -1:], params["lm_head"]).to(torch.float32)
    return logits, cache


def _decode_attention_contiguous(q_g, cache_layer, positions, hd, window):
    """Single-token ragged decode attention over a CONTIGUOUS cache: on a
    CUDA tensor, the paged decode kernel over the cache viewed as a
    degenerate block pool (a free reshape, iota block tables; ``q_g``
    contiguous); on the CPU the plain :func:`cached_gqa_attention` (the
    JAX package's dispatch rule).  Rolling caches always take the plain
    attention: ring rows need the stored-position mask."""
    pool, tables = _degenerate_pool(cache_layer, q_g.device)
    if pool is None:
        return cached_gqa_attention(q_g, cache_layer, positions[:, None],
                                    hd, window=window)
    out = paged_decode_attention(
        q_g[:, 0], pool["k"], pool["v"], tables,
        positions.to(torch.int32), ks=pool.get("ks"), vs=pool.get("vs"),
        window=window)
    return out[:, None]


def _degenerate_pool(cache_layer, device):
    """A contiguous ``(batch, max_seq, ...)`` cache layer as a block pool
    for the kernels: ``(pool, tables)``, the pool a free reshape to
    ``(batch * max_seq / bs, bs, ...)`` and the tables iota int32 ``(batch,
    max_seq / bs)`` (slot ``b`` owns blocks ``b * max_seq / bs`` on); or
    ``(None, None)`` where the kernels do not run: off the card, or on a
    rolling cache.  On the card a ``max_seq`` with no usable block size
    (:func:`contiguous_block_size`) raises: the kernels launch or the call
    fails, never the plain path in their place."""
    if device.type != "cuda" or "pos" in cache_layer:
        return None, None
    max_seq = cache_layer["k"].shape[1]
    block_size = contiguous_block_size(max_seq)
    if not block_size:
        raise ValueError(
            f"a contiguous cache of {max_seq} rows has no block view for "
            "the attention kernels (its row count needs a power-of-two "
            "factor of 16 or more): size it with contiguous_rows()")
    batch = cache_layer["k"].shape[0]
    blocks_per_row = max_seq // block_size
    tables = _iota(batch * blocks_per_row, device, torch.int32) \
        .reshape(batch, blocks_per_row)
    pool = {key: buf.reshape((batch * blocks_per_row, block_size)
                             + tuple(buf.shape[2:]))
            for key, buf in cache_layer.items()}
    return pool, tables


def _attention_decode_ragged(layer, config, x, rope, cache_layer,
                             rows: DecodeRows, lora=None, lora_layer=None):
    """Single-token decode where every batch row sits at its OWN cache
    position.  ``x`` (batch, 1, d), ``rows`` the step's
    :func:`_cache_rows`."""
    batch, seq, _ = x.shape
    h, kv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    q, k, v = _qkv(layer, config, x, rope, lora, lora_layer)
    # q's copy first, so that the attention kernel directly follows the
    # K/V write it depends on (a programmatic dependent launch).
    q_g = q.reshape(batch, seq, kv, h // kv, hd).contiguous()
    _cache_write_rows(cache_layer, k, v, rows)
    out = _decode_attention_contiguous(q_g, cache_layer, rows.positions, hd,
                                       config.sliding_window)
    out = out.reshape(batch, seq, h * hd)
    return x + _wo(out, layer, lora, lora_layer).to(x.dtype)


def _decode_core_ragged(params, token, cache, positions,
                        config: LlamaConfig, lora=None):
    """One autoregressive step with PER-ROW cache positions: token
    (batch, 1) + positions (batch,) -> (logits (batch, 1, vocab) f32,
    cache updated in place).  The positions become int32, and the K/V
    write's targets, once a step.  ``lora``: per-row adapters."""
    rows = _cache_rows(positions.to(torch.int32))
    rope = _rope_tables(config, rows.positions[:, None])
    x = _embed_lookup(params, token, config.dtype)
    for layer, cache_layer, lora_layer in zip(
            params["layers"], cache, _lora_layers(lora, len(cache))):
        x = _attention_decode_ragged(layer, config, x, rope, cache_layer,
                                     rows, lora, lora_layer)
        x = _mlp_block(layer, config, x)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return _matmul(x, params["lm_head"]).to(torch.float32), cache


@torch.no_grad()
def decode_step(params, token, cache, cache_index: int,
                config: LlamaConfig, lora=None):
    """One step at a shared cache position (the ragged core with a
    constant position vector, as in the JAX package)."""
    positions = torch.full((token.shape[0],), int(cache_index),
                           dtype=torch.int32, device=token.device)
    return _decode_core_ragged(params, token, cache, positions, config,
                               lora=lora)


# --------------------------------------------------------------------------- #
# Chunked forwards over an existing contiguous cache

def _chunk_attention_contiguous(q_g, k, v, cache_layer, starts, chunk_lens,
                                positions_b, write_plain, hd, window):
    """A chunk's K/V write and attention over a CONTIGUOUS cache: on a
    CUDA tensor, ``append_kv_ragged`` then ``chunk_attention`` over the
    cache viewed as a degenerate block pool (:func:`_degenerate_pool`),
    each row from its own start, a row with ``chunk_len`` 0 writing
    nothing (a ``max_seq`` with no block size raises there); on the CPU
    or a rolling cache ``write_plain(cache_layer, k, v)`` then the plain
    :func:`cached_gqa_attention`, as the JAX package computes it."""
    pool, tables = _degenerate_pool(cache_layer, q_g.device)
    if pool is None:
        write_plain(cache_layer, k, v)
        return cached_gqa_attention(q_g, cache_layer, positions_b, hd,
                                    window=window)
    append_kv_ragged(k.contiguous(), v.contiguous(), pool, tables, starts,
                     chunk_lens)
    return chunk_attention(q_g, pool, tables, starts, chunk_lens,
                           window=window)


def _chunk_forward(params, tokens, cache, starts, active, write_plain,
                   config: LlamaConfig, lora=None):
    """The ONE transformer stack for chunked forwards over an existing
    contiguous cache: :func:`prefill_chunk` (one start for every row) and
    :func:`verify_chunk_ragged` (per-row starts) differ only in their
    positions and their plain K/V write.  ``tokens`` (batch, K) sit at
    ``starts (batch,) + [0, K)``; rows not ``active`` get ``chunk_len`` 0
    on the kernels' route.  Returns (logits (batch, K, vocab) f32, cache
    updated in place)."""
    batch, K = tokens.shape
    h, kv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    device = tokens.device
    starts = starts.to(torch.int32)
    positions_b = starts.to(torch.int64)[:, None] + _iota(K, device)[None, :]
    chunk_lens = torch.where(active, K, 0).to(torch.int32)
    rope = _rope_tables(config, positions_b)
    x = _embed_lookup(params, tokens, config.dtype)
    for layer, cache_layer, lora_layer in zip(
            params["layers"], cache, _lora_layers(lora, len(cache))):
        q, k, v = _qkv(layer, config, x, rope, lora, lora_layer)
        out = _chunk_attention_contiguous(
            q.reshape(batch, K, kv, h // kv, hd).contiguous(), k, v,
            cache_layer, starts, chunk_lens, positions_b, write_plain, hd,
            config.sliding_window)
        x = x + _wo(out.reshape(batch, K, h * hd), layer, lora,
                    lora_layer).to(x.dtype)
        x = _mlp_block(layer, config, x)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return _matmul(x, params["lm_head"]).to(torch.float32), cache


@torch.no_grad()
def prefill_chunk(params, tokens, cache, start_index: int,
                  config: LlamaConfig, lora=None):
    """Chunked prefill: run ``tokens (batch, K)`` at absolute positions
    ``start_index + [0, K)``, extending an EXISTING cache prefix.  Returns
    (logits (batch, K, vocab) f32 at every position, cache).  Attention
    masks by absolute position, so stale rows past the chunk are never
    attended.  Uses: chunked admission into a contiguous server's bucket,
    and the speculative verify of :func:`~.speculative.
    speculative_generate`.

    Rolling caches are rejected for K > 1: the slab lands before the
    attention runs, so ring rows still inside earlier chunk queries'
    windows would be overwritten.  Feed them K = 1 chunks."""
    batch, K = tokens.shape
    if cache and "pos" in cache[0] and K > 1:
        raise ValueError(
            "prefill_chunk does not support rolling caches with chunk "
            "length > 1: the pre-attention slab write can evict ring "
            "rows still inside earlier chunk queries' sliding windows "
            "(silently wrong logits); feed K=1 chunks instead")
    start = int(start_index)
    starts = torch.full((batch,), start, dtype=torch.int32,
                        device=tokens.device)
    active = torch.ones((batch,), dtype=torch.bool, device=tokens.device)
    return _chunk_forward(
        params, tokens, cache, starts, active,
        lambda cache_layer, k, v: _cache_write_slab(cache_layer, k, v,
                                                    start),
        config, lora=lora)


@torch.no_grad()
def verify_chunk_ragged(params, tokens, cache, positions, active,
                        config: LlamaConfig, lora=None):
    """Teacher-forced scoring of K given tokens per slot, every row at its
    OWN absolute start position: the speculative verify of the contiguous
    serving layout, :func:`prefill_chunk`'s per-row twin.  ``tokens``
    (batch, K) int32, ``positions`` (batch,) the absolute position of
    ``tokens[:, 0]``.  Returns (logits (batch, K, vocab) f32, where
    ``logits[:, j]`` predicts position ``positions + j + 1``, and the cache
    with each active slot's K rows written).

    An inactive slot's rows are garbage-tolerant: the plain path writes
    its slab at row 0 of its own slot, as the JAX package does (admission
    rewrites ``[0, padded)`` before the slot decodes), and the kernels'
    route writes nothing for it (``chunk_len`` 0).  Its logits are garbage
    the acceptance mask discards.  Stale rows past a rejected proposal
    are unattendable until rewritten."""
    if cache and "pos" in cache[0]:
        raise ValueError(
            "verify_chunk_ragged does not support rolling caches")
    starts = torch.where(active, positions.to(torch.int32),
                         torch.zeros_like(positions, dtype=torch.int32))
    return _chunk_forward(
        params, tokens, cache, starts, active,
        lambda cache_layer, k, v: _cache_write_ragged_slab(cache_layer, k,
                                                           v, starts),
        config, lora=lora)


# --------------------------------------------------------------------------- #
# Sampling

def _mask_logits(logits, temperature=1.0, top_k: int = 0, top_p=None):
    """Temperature-scale + top-k/top-p mask ``logits (batch, vocab)``:
    THE truncation implementation the sampler draws from."""
    if torch.is_tensor(temperature):
        temperature = temperature.clamp_min(1e-6)
    else:
        temperature = max(float(temperature), 1e-6)
    logits = logits.to(torch.float32) / temperature
    if isinstance(top_p, (int, float)) and top_p >= 1.0:
        top_p = None
    if (top_k and top_k > 0) or top_p is not None:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        ranks = torch.arange(sorted_desc.shape[-1],
                             device=logits.device)[None, :]
        neg = torch.full_like(logits, -1e30)
        if top_k and top_k > 0:
            kth = sorted_desc[:, top_k - 1][:, None]
            logits = torch.where(logits < kth, neg, logits)
            sorted_desc = torch.where(ranks < top_k, sorted_desc,
                                      torch.full_like(sorted_desc, -1e30))
        if top_p is not None:
            probs = torch.softmax(sorted_desc, dim=-1)
            cumulative = torch.cumsum(probs, dim=-1)
            # Keep the minimal prefix with cumulative mass >= top_p; rank
            # 0 is always kept so top_p <= 0 degrades to argmax.
            cutoff_mask = ((cumulative - probs) >= top_p) & (ranks > 0)
            cutoff = torch.where(cutoff_mask,
                                 torch.full_like(sorted_desc, math.inf),
                                 sorted_desc).amin(dim=-1, keepdim=True)
            logits = torch.where(logits < cutoff, neg, logits)
    return logits


def sample_logits(logits, generator, temperature=1.0, top_k: int = 0,
                  top_p=None):
    """Sample token ids from ``logits (batch, vocab)`` (temperature,
    top-k, nucleus) by Gumbel-max on noise from ``generator``: the same
    distribution as ``jax.random.categorical`` (the two frameworks draw
    different bits from the same seed)."""
    masked = _mask_logits(logits, temperature, top_k, top_p)
    uniform = torch.rand(masked.shape, generator=generator,
                         device=masked.device, dtype=torch.float32)
    uniform = uniform.clamp_min(torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(uniform))
    return (masked + gumbel).argmax(dim=-1).to(torch.int32)


def _sample_logits_per_row(logits, generator, temperatures, top_ps):
    """Per-row temperature + nucleus (``top_p >= 1`` rows are a numeric
    no-op; the best token is always kept)."""
    return sample_logits(logits, generator,
                         temperature=temperatures[:, None],
                         top_p=top_ps[:, None])


def sampling_probs(logits, temperature=1.0, top_p=None):
    """The distribution :func:`sample_logits` draws from at these controls
    (batch-shaped temperature/top_p broadcast as in the per-row sampler):
    softmax of the same masked, scaled logits."""
    return torch.softmax(_mask_logits(logits, temperature, top_k=0,
                                      top_p=top_p), dim=-1)


@torch.no_grad()
def generate_tokens(params, first_token, cache, start_index: int,
                    num_steps: int, config: LlamaConfig,
                    temperature: float = 0.0, generator=None,
                    top_k: int = 0, top_p=None):
    """Greedy (or sampled) decode of ``num_steps`` tokens from
    ``first_token`` (batch, 1) at ``start_index``.  Returns (tokens
    (batch, num_steps) int32, cache)."""
    token = first_token.to(torch.int32)
    out = []
    for step in range(num_steps):
        logits, cache = decode_step(params, token, cache,
                                    start_index + step, config)
        logits = logits[:, -1]
        if temperature and temperature > 0:
            next_token = sample_logits(logits, generator, temperature,
                                       top_k=top_k, top_p=top_p)
        else:
            next_token = logits.argmax(dim=-1).to(torch.int32)
        token = next_token[:, None]
        out.append(next_token)
    if not out:
        return torch.zeros((token.shape[0], 0), dtype=torch.int32,
                           device=token.device), cache
    return torch.stack(out, dim=1), cache


@torch.no_grad()
def sample_tokens_with_logits(params, first_token, cache, start_index: int,
                              num_steps: int, config: LlamaConfig,
                              temperature, generator):
    """Sampled decode that ALSO returns each step's logits row: the
    standalone speculative draft's primitive (the acceptance math
    rebuilds the proposal distribution from the rows).  Each token is
    drawn at ``temperature`` from ``generator``.  Returns (tokens (batch,
    steps) int32, logits (batch, steps, vocab) f32, cache)."""
    token = first_token.to(torch.int32)
    tokens, rows = [], []
    for step in range(num_steps):
        logits, cache = decode_step(params, token, cache,
                                    start_index + step, config)
        row = logits[:, -1].to(torch.float32)
        next_token = sample_logits(row, generator, temperature)
        token = next_token[:, None]
        tokens.append(next_token)
        rows.append(row)
    return torch.stack(tokens, dim=1), torch.stack(rows, dim=1), cache


# --------------------------------------------------------------------------- #
# Serving loop

def _serve_scan(step_core, state, cache, num_steps: int, eos_id: int,
                sampled: bool, generator, step_logits: Optional[List] = None):
    """Device-resident serving loop: the per-slot state (token,
    positions, active, remaining) lives in the device ``state`` dict and
    EOS/budget retirement happens on the device, so the host never
    uploads decode state or downloads logits on the steady path.
    Emit-then-deactivate: the EOS token itself is emitted, then the lane
    goes inactive for the rest of the chunk (inactive lanes write the
    scratch row and freeze).  Returns ``(tokens_out (slots, steps),
    counts (slots,), new_state, cache)``; ``counts[s]`` leading entries
    of ``tokens_out[s]`` were emitted.  ``step_logits``, when given, gets
    each step's next-token logits (slots, vocab) appended."""
    temps, tops = state["temps"], state["tops"]
    token, positions = state["token"], state["positions"]
    active, remaining = state["active"], state["remaining"]
    tokens_out, emits = [], []
    for _ in range(num_steps):
        logits, cache = step_core(token, cache, positions, active)
        logits = logits[:, -1]
        if step_logits is not None:
            step_logits.append(logits)
        next_token = logits.argmax(dim=-1).to(torch.int32)
        if sampled:
            drawn = _sample_logits_per_row(logits, generator, temps, tops)
            next_token = torch.where(temps > 0, drawn, next_token)
        next_token = torch.where(active[:, None], next_token[:, None],
                                 token)
        emits.append(active)
        positions = torch.where(active, positions + 1, positions)
        remaining = torch.where(active, remaining - 1, remaining)
        if eos_id >= 0:
            active = active & (next_token[:, 0] != eos_id)
        active = active & (remaining > 0)
        token = next_token
        tokens_out.append(token[:, 0])
    counts = torch.stack(emits).to(torch.int32).sum(dim=0,
                                                    dtype=torch.int32)
    new_state = dict(state, token=token, positions=positions,
                     active=active, remaining=remaining)
    return torch.stack(tokens_out, dim=1), counts, new_state, cache


def scatter_state_rows(state: Dict, rows, packet: Dict) -> Dict:
    """Compact host->device merge for the serving loop's dirty slots:
    write ``packet`` (the gathered rows of ONLY the slots an admission,
    retirement or sampling edit touched) into ``state`` at ``rows``.
    Returns a NEW dict of new tensors (the state is a small immutable
    chain, as in the JAX package).  ``rows`` may repeat the last dirty
    row as padding: duplicates carry identical payloads."""
    merged = dict(state)
    for key, host in packet.items():
        dev = state[key]
        merged[key] = dev.index_put((rows,), host.to(dev.dtype))
    return merged


def scatter_state_rows_(state: Dict, rows, packet: Dict) -> Dict:
    """In-place twin of :func:`scatter_state_rows` for the static state
    buffers a :class:`ChunkGraph` reads: the same rows with the same
    values (padding rows repeat the last dirty row and its payload, so the
    duplicates agree), written by ``index_put_`` into the tensors of
    ``state``.  Returns ``state``."""
    for key, host in packet.items():
        dev = state[key]
        dev.index_put_((rows,), host.to(dev.dtype))
    return state


@torch.no_grad()
def serve_chunk_ragged(params, state, cache, num_steps: int,
                       config: LlamaConfig, eos_id: int = -1,
                       sampled: bool = False, generator=None,
                       lora_shared=None):
    """``num_steps`` device-resident decode steps for the serving loop:
    per-slot state in the device ``state`` dict, EOS/budget retirement
    on the device, cache updated in place.  Inactive slots write their
    K/V into the scratch row ``max_seq - 1`` so they cannot corrupt a
    live slot's prefix.  ``sampled`` selects the program with sampling
    math; greedy traffic pays none.  ``lora_shared``: the stacked adapter
    factors WITHOUT ids; the rows' ids ride the resident state
    (``state["adapter_ids"]``)."""
    max_seq = cache[0]["k"].shape[1]
    lora = _with_ids(lora_shared, state.get("adapter_ids"))

    def step_core(token, cache, positions, active):
        write_pos = torch.where(active, positions,
                                torch.full_like(positions, max_seq - 1))
        return _decode_core_ragged(params, token, cache, write_pos, config,
                                   lora=lora)

    return _serve_scan(step_core, state, cache, num_steps, eos_id,
                       sampled, generator)


# --------------------------------------------------------------------------- #
# The steady chunk as one program: captured CUDA graphs

class ChunkGraph:
    """The steady greedy decode chunk of one server as CUDA graphs: the
    port's counterpart of the JAX package's jitted
    :func:`serve_chunk_ragged` / :func:`serve_chunk_paged` with the cache
    donated.

    ``state`` is the server's STATIC state (token, positions, active,
    remaining, temps, tops, adapter ids; paged: tables): the program reads
    it and writes the new state back into the same tensors, so a replay
    finds its inputs where the capture read them.  ``cache`` (a contiguous
    cache, or with ``paged`` a block pool) is updated in place, as every
    decode step of the port updates it: that is the donation.  One graph is
    kept per key (layout, slots, ``num_steps``, KV dtype, ``eos_id``,
    weight kind, adapters).  A chunk with adapters passes the stacked
    factors (``lora_shared``) and a ``lora_key`` that names them: the
    factors are tensors at fixed addresses, which a server updates in place
    while their shape holds, so only a change of shape (a new key) costs a
    capture, and the graphs of the older key, which read the replaced
    tensors, are released; the rows' adapter ids are a column of the
    static state.
    The first chunk of a key runs eagerly and is its warm-up: it builds
    what the capture must find made (the lru-cached index tensors, the
    weights' TMA maps, the kernels' scratch, the cache layers' row plans),
    and a capture executes nothing, so no separate warm-up decodes a step
    of served state.  The second captures and replays; the rest replay.
    Every replay computes the same kernels on the same inputs as the eager
    chunk: tokens, counts, state and cache bytes are bitwise the same.

    The wrappers count their launches in Python, which a replay does not
    run and a capture runs without launching: the capture's counts are
    taken back and added again on every replay (``ops/_cuda.py``).  A
    capture that fails raises; nothing falls back to the eager chunk.
    ``ledger`` (:class:`~..obs.compiles.CaptureLedger`) counts captures
    (each with its host ms and key) and replays.  On the card only: CPU tensors never capture."""

    def __init__(self, params, config: LlamaConfig, cache, state: Dict,
                 paged: bool, ledger):
        self.params, self.config, self.cache = params, config, cache
        self.state, self.paged, self.ledger = state, paged, ledger
        wq = params["layers"][0]["wq"]
        self._fixed = ("paged" if paged else "contiguous",
                       state["token"].shape[0], str(cache[0]["k"].dtype),
                       "int4" if is_quantized_int4(wq) else
                       "int8" if is_quantized(wq) else str(wq.dtype))
        #: key -> (graph, outputs, launches a replay, scratch held), or
        #: None once the key's eager warm-up chunk ran.
        self._graphs: Dict[Tuple, Any] = {}
        #: The ``lora_key`` of the adapter graphs kept in ``_graphs``.
        self._lora_key = None

    def key(self, num_steps: int, eos_id: int, lora_key=None) -> Tuple:
        layout, slots, kv_dtype, weights = self._fixed
        key = (layout, slots, int(num_steps), kv_dtype, int(eos_id),
               weights)
        return key if lora_key is None else key + (lora_key,)

    def run(self, num_steps: int, eos_id: int = -1, lora_shared=None,
            lora_key=None):
        """One greedy chunk of ``num_steps`` steps from the static state:
        returns ``(tokens_out (slots, num_steps), counts (slots,))``, the
        graph's own output buffers once the key is captured (the next
        replay overwrites them: read them on the stream before it).
        ``lora_shared`` / ``lora_key``: the stacked adapter factors and
        what names their tensors (None: the adapter-free program)."""
        key = self.key(num_steps, eos_id, lora_key)
        if lora_key is not None and lora_key != self._lora_key:
            self._release_lora_graphs()
            self._lora_key = lora_key
        if key not in self._graphs:
            self._graphs[key] = None
            return self._program(num_steps, eos_id, lora_shared)
        captured = self._graphs[key]
        if captured is None:
            captured = self._graphs[key] = self._capture(num_steps, eos_id,
                                                         lora_shared)
        graph, outputs, launches, _ = captured
        graph.replay()
        _cuda.add_launches(launches)
        self.ledger.record_replay()
        return outputs

    def _release_lora_graphs(self):
        """Drop the graphs (and their outputs, scratch and memory pools)
        captured under an older adapter stack: a new ``lora_key`` names
        new factor tensors, and the old key never comes back."""
        for key in [key for key in self._graphs
                    if len(key) > len(self._fixed) + 2]:
            del self._graphs[key]

    def _program(self, num_steps: int, eos_id: int, lora_shared=None):
        """The chunk: the eager serve function (with ``lora_shared``, the
        stacked adapter factors, or None), its new state written back into
        the static buffers."""
        chunk = serve_chunk_paged if self.paged else serve_chunk_ragged
        tokens_out, counts, new_state, _ = chunk(
            self.params, self.state, self.cache, num_steps, self.config,
            eos_id=eos_id, lora_shared=lora_shared)
        for key, value in new_state.items():
            if value is not self.state[key]:
                self.state[key].copy_(value)
        return tokens_out, counts

    def _capture(self, num_steps: int, eos_id: int, lora_shared=None):
        device = self.state["token"].device
        if device.type != "cuda":
            raise ValueError("ChunkGraph: a CUDA graph needs the state on a "
                             f"card, not on {device}")
        began = time.perf_counter()
        captured = _cuda.capture_graph(
            lambda: self._program(num_steps, eos_id, lora_shared), device)
        self.ledger.record_capture(
            (time.perf_counter() - began) * 1e3,
            signature=str(self.key(num_steps, eos_id, None)))
        return captured


# --------------------------------------------------------------------------- #
# Paged KV cache (vLLM-style block pool)
#
# Layout per layer: pool (n_blocks, block_size, kv, hd), plus f32 (n_blocks,
# block_size, kv) scales when int8; each slot owns a block table
# (max_blocks,) of pool indices.  Block 0 is reserved scratch: unallocated
# table entries and inactive slots point there, and it is never attendable
# (masking is by absolute position, and live positions always map to
# allocated blocks).  Pools are updated IN PLACE, like the contiguous cache.

def init_paged_cache(config: LlamaConfig, n_blocks: int,
                     block_size: int = 16, quantize_kv: bool = False,
                     device=None) -> List[Dict]:
    """Block pool, one dict per layer.  ``n_blocks`` INCLUDES the reserved
    scratch block 0."""
    return _kv_layer_buffers(
        config, (n_blocks, block_size, config.n_kv_heads, config.head_dim),
        quantize_kv, resolve_device(device))


#: Scatter a (batch, K, kv, hd) chunk slab into the pool at per-row
#: absolute positions (batch, K), in place: the append path's plain write.
_paged_write_slab = _write_rows_reference

#: Per-slot cache view ``pool[tables]`` -> (slots, max_blocks*bs, ...): the
#: layout :func:`cached_gqa_attention` reads, so paged and contiguous
#: attention share one plain implementation.  A transient copy.
_paged_gather = _gathered_view


def _paged_write_rows(pool_layer, k, v, rows: DecodeRows):
    """Write one (batch, 1, kv, hd) row per slot into the pool at
    ``(tables[s, pos // bs], pos % bs)`` of the step's ``rows``, in place
    (:func:`write_kv_rows`); a row past the table is dropped."""
    return write_decode_rows(k, v, pool_layer, rows)


def _attention_decode_paged(layer, config, x, rope, pool_layer,
                            rows: DecodeRows, lora=None, lora_layer=None):
    """Single-token decode against the block pool (per-row positions).  On
    a CUDA tensor the paged decode kernel walks the REAL block tables; on
    the CPU the gathered view goes through the plain attention."""
    batch, seq, _ = x.shape
    h, kv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    tables, positions = rows.tables, rows.positions
    q, k, v = _qkv(layer, config, x, rope, lora, lora_layer)
    # q's copy first, so that the attention kernel directly follows the
    # K/V write it depends on (a programmatic dependent launch).
    q_g = q.reshape(batch, seq, kv, h // kv, hd).contiguous()
    _paged_write_rows(pool_layer, k, v, rows)
    if q_g.device.type == "cuda":
        out = paged_decode_attention(
            q_g[:, 0], pool_layer["k"], pool_layer["v"],
            tables, positions, ks=pool_layer.get("ks"),
            vs=pool_layer.get("vs"), window=config.sliding_window)[:, None]
    else:
        out = cached_gqa_attention(q_g, _paged_gather(pool_layer, tables),
                                   positions[:, None], hd,
                                   window=config.sliding_window)
    out = out.reshape(batch, seq, h * hd)
    return x + _wo(out, layer, lora, lora_layer).to(x.dtype)


def _decode_core_paged(params, token, pool, tables, positions,
                       config: LlamaConfig, lora=None):
    """One paged decode step: token (batch, 1) at per-row ``positions``
    -> (logits (batch, 1, vocab) f32, pool updated in place).  The tables
    and positions become int32, and the K/V write's targets, once a step
    (the one place of the paged decode step that converts them), for
    every layer's write and attention."""
    rows = DecodeRows(tables.to(torch.int32), positions.to(torch.int32))
    rope = _rope_tables(config, rows.positions[:, None])
    x = _embed_lookup(params, token, config.dtype)
    for layer, pool_layer, lora_layer in zip(
            params["layers"], pool, _lora_layers(lora, len(pool))):
        x = _attention_decode_paged(layer, config, x, rope, pool_layer,
                                    rows, lora, lora_layer)
        x = _mlp_block(layer, config, x)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return _matmul(x, params["lm_head"]).to(torch.float32), pool


def _paged_step_core(params, tables, pool, config: LlamaConfig, lora=None):
    """One paged decode step over the slots' ``tables``: inactive lanes
    write scratch block 0 at their slot offset and are never read."""
    block_size = pool[0]["k"].shape[1]
    scratch_tables = torch.zeros_like(tables)
    scratch_positions = _iota(tables.shape[0], tables.device,
                              torch.int32) % block_size

    def step_core(token, pool, positions, active):
        write_tables = torch.where(active[:, None], tables, scratch_tables)
        write_pos = torch.where(active, positions, scratch_positions)
        return _decode_core_paged(params, token, pool, write_tables,
                                  write_pos, config, lora=lora)
    return step_core


@torch.no_grad()
def serve_chunk_paged(params, state, pool, num_steps: int,
                      config: LlamaConfig, eos_id: int = -1,
                      sampled: bool = False, generator=None,
                      lora_shared=None):
    """Paged twin of :func:`serve_chunk_ragged`: the block tables ride the
    resident ``state`` (``state["tables"]``), so table updates merge in
    with the other dirty rows; so do the rows' adapter ids."""
    lora = _with_ids(lora_shared, state.get("adapter_ids"))
    return _serve_scan(_paged_step_core(params, state["tables"], pool,
                                        config, lora=lora),
                       state, pool, num_steps, eos_id, sampled, generator)


def _chunk_scan(step_core, tokens, cache, positions, active, num_steps: int,
                temperatures, top_ps, generator, return_logits: bool):
    """``num_steps`` decode steps for every slot with no EOS and no budget,
    over either layout's ``step_core`` (:func:`_serve_scan` with a budget
    that never runs out): per-slot greedy or sampled picks, inactive slots
    frozen.  Returns (tokens_out (slots, num_steps), last token (slots,
    1), positions, cache), with each step's next-token logits (slots,
    num_steps, vocab) after ``tokens_out`` when ``return_logits``."""
    slots, device = tokens.shape[0], tokens.device
    sampled = temperatures is not None
    state = dict(
        token=tokens.to(torch.int32), positions=positions.to(torch.int32),
        active=active,
        remaining=torch.full((slots,), num_steps, dtype=torch.int32,
                             device=device),
        temps=(temperatures if sampled else
               torch.zeros((slots,), dtype=torch.float32, device=device)),
        tops=(top_ps if top_ps is not None else
              torch.ones((slots,), dtype=torch.float32, device=device)))
    step_logits = [] if return_logits else None
    tokens_out, _, state, cache = _serve_scan(
        step_core, state, cache, num_steps, -1, sampled, generator,
        step_logits=step_logits)
    if return_logits:
        return (tokens_out, torch.stack(step_logits, dim=1), state["token"],
                state["positions"], cache)
    return tokens_out, state["token"], state["positions"], cache


@torch.no_grad()
def decode_chunk_ragged(params, tokens, cache, positions, active,
                        num_steps: int, config: LlamaConfig,
                        temperatures=None, top_ps=None, generator=None,
                        return_logits: bool = False, lora=None):
    """``num_steps`` decode steps for a slot batch on a contiguous cache,
    each row at its own position with an ``active`` flag (the contiguous
    speculative draft's proposer, and the continuous-batching oracle).
    Inactive rows write their K/V into the scratch row ``max_seq - 1``
    (the decode write's clamp rule past the end) and do not advance.
    ``temperatures`` / ``top_ps`` (slots,) sample per row from
    ``generator`` (a row at temperature 0 stays exactly greedy); None is
    the greedy program.  Returns (tokens_out (slots, num_steps), last
    token (slots, 1), positions, cache); ``return_logits=True`` inserts
    each step's next-token logits (slots, num_steps, vocab) after
    ``tokens_out``.  Not for rolling caches: the scratch row is a live
    ring row there."""
    if "pos" in cache[0]:
        raise ValueError(
            "decode_chunk_ragged does not support rolling caches: the "
            "inactive-slot scratch row would land on a live ring row")
    max_seq = cache[0]["k"].shape[1]

    def step_core(token, cache, positions, active_now):
        write_pos = torch.where(active, positions,
                                torch.full_like(positions, max_seq - 1))
        return _decode_core_ragged(params, token, cache, write_pos, config,
                                   lora=lora)

    return _chunk_scan(step_core, tokens, cache, positions, active,
                       num_steps, temperatures, top_ps, generator,
                       return_logits)


@torch.no_grad()
def decode_chunk_paged(params, tokens, pool, tables, positions, active,
                       num_steps: int, config: LlamaConfig,
                       temperatures=None, top_ps=None, generator=None,
                       return_logits: bool = False, lora=None):
    """``num_steps`` paged decode steps for every slot, no EOS and no
    budget (the JAX package's paged oracle, and the speculative draft's
    proposer).  Inactive slots write scratch block 0 and do not advance.
    Returns (tokens_out (slots, num_steps), last token (slots, 1),
    positions, pool); ``return_logits=True`` inserts each step's
    next-token logits (slots, num_steps, vocab) after ``tokens_out``, for
    the sampled acceptance of a draft's proposals."""
    return _chunk_scan(_paged_step_core(params, tables, pool, config,
                                        lora=lora),
                       tokens, pool, positions, active, num_steps,
                       temperatures, top_ps, generator, return_logits)


@torch.no_grad()
def paged_insert_prefix(pool, tables, prefix_cache, slot: int):
    """Copy a contiguous prefilled cache (per layer ``(1, padded, kv,
    hd)``, the pool's KV layout) into ``slot``'s first ``padded //
    block_size`` table blocks, in place.  ``tables`` (slots, max_blocks);
    ``padded`` must be a multiple of the pool's block size."""
    block_size = pool[0]["k"].shape[1]
    padded = prefix_cache[0]["k"].shape[1]
    block_ids = tables[int(slot), :padded // block_size]
    return paged_scatter_blocks(pool, block_ids, prefix_cache, 0)


def paged_scatter_blocks(pool, block_ids, prefix_cache, start_block: int):
    """Write contiguous prefilled rows into explicit pool blocks, in place
    (``index_copy_`` into the pool's own tensors, which the captured chunk
    graphs hold): prefix rows ``[start_block * bs, (start_block +
    len(block_ids)) * bs)`` land in ``pool[block_ids]``."""
    block_size = pool[0]["k"].shape[1]
    n_blocks = int(block_ids.shape[0])
    ids = block_ids.to(torch.int64)
    for pool_layer, prefix_layer in zip(pool, prefix_cache):
        for key, buf in pool_layer.items():
            src = prefix_layer[key][0]
            blocked = src.reshape((src.shape[0] // block_size, block_size)
                                  + tuple(src.shape[1:]))
            rows = blocked[int(start_block):int(start_block) + n_blocks]
            buf.index_copy_(0, ids, rows.to(buf.dtype))
    return pool


def paged_gather_blocks(pool, block_ids, bucket, start_block: int = 0):
    """Read ``pool[block_ids]`` into ``len(block_ids) * bs`` contiguous
    rows of a bucket cache (per layer ``(1, rows, ...)``) starting at
    block ``start_block``, in place; returns the bucket."""
    block_size = pool[0]["k"].shape[1]
    rows = int(block_ids.shape[0]) * block_size
    start_row = int(start_block) * block_size
    ids = block_ids.to(torch.int64)
    for pool_layer, bucket_layer in zip(pool, bucket):
        for key, buf in bucket_layer.items():
            src = pool_layer[key].index_select(0, ids)
            buf[0, start_row:start_row + rows] = src.reshape(
                (rows,) + tuple(src.shape[2:])).to(buf.dtype)
    return bucket


def _prefill_append_core(params, tokens, pool, tables, start_index: int,
                         config: LlamaConfig, kv_limit: Optional[int] = None,
                         compute_logits: bool = True, lora=None):
    """Append-attention prefill straight against the block pool: the
    chunk's K/V land in their pool blocks and its queries attend over the
    cached prefix blocks plus the causally visible chunk, with no bucket,
    gather or scatter-back.  All rows share one ``start_index`` (block-
    aligned); ``tables`` is the request's (1, max_blocks) row.
    ``compute_logits=False`` skips the final norm and LM head: the serving
    paths seed decode with the last prompt token and never read prefill
    logits."""
    batch, K = tokens.shape
    h, kv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    start = int(start_index)
    device = tokens.device
    positions_b = (start + _iota(K, device))[None, :].expand(batch, K)
    cached_lens = torch.full((batch,), start, dtype=torch.int32,
                             device=device)
    chunk_lens = torch.full((batch,), K, dtype=torch.int32, device=device)
    tables = tables.to(torch.int32).contiguous()
    rope = _rope_tables(config, positions_b)
    x = _embed_lookup(params, tokens, config.dtype)
    for layer, pool_layer, lora_layer in zip(
            params["layers"], pool, _lora_layers(lora, len(pool))):
        q, k, v = _qkv(layer, config, x, rope, lora, lora_layer)
        out, _ = paged_prefill_attention(
            q.reshape(batch, K, kv, h // kv, hd).contiguous(),
            k.contiguous(), v.contiguous(), pool_layer, tables, cached_lens,
            chunk_lens, window=config.sliding_window, kv_limit=kv_limit)
        x = x + _wo(out.reshape(batch, K, h * hd), layer, lora,
                    lora_layer).to(x.dtype)
        x = _mlp_block(layer, config, x)
    if not compute_logits:
        return None, pool
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return _matmul(x, params["lm_head"]).to(torch.float32), pool


@torch.no_grad()
def prefill_append_paged(params, tokens, pool, tables, start_index: int,
                         config: LlamaConfig, kv_limit: Optional[int] = None,
                         compute_logits: bool = True, lora=None):
    """Admit a (batch, K) prompt chunk into the block pool by append
    attention; a prefix-cache hit passes ``start_index = n_shared *
    block_size`` and the shared blocks are only read.  ``kv_limit`` bounds
    the kernel's block sweep to the request's own allocation.  Returns
    (logits (batch, K, vocab) f32 or None, pool)."""
    return _prefill_append_core(params, tokens, pool, tables, start_index,
                                config, kv_limit=kv_limit,
                                compute_logits=compute_logits, lora=lora)


@torch.no_grad()
def serve_chunk_mixed(params, state, pool, prefill_tokens, prefill_row: int,
                      prefill_start: int, num_steps: int,
                      config: LlamaConfig, eos_id: int = -1,
                      sampled: bool = False, generator=None,
                      prefill_kv_limit: Optional[int] = None,
                      lora_shared=None):
    """Sarathi-style mixed step: a chunked-prefill slice for the admitting
    slot ``prefill_row`` (its table row read from the resident state),
    then ``num_steps`` decode steps for the live slots, in one call.  The
    prefilling slot stays inactive in ``state`` until its last slice
    lands, so the decode steps treat it as a scratch lane.  With
    ``lora_shared`` the slice runs under the admitting row's adapter id
    (resident before the first mixed dispatch) and the decode steps under
    every row's."""
    row = slice(int(prefill_row), int(prefill_row) + 1)
    tables_row = state["tables"][row]
    prefill_lora = _with_ids(
        lora_shared, state["adapter_ids"][row] if lora_shared is not None
        else None)
    _prefill_append_core(params, prefill_tokens, pool, tables_row,
                         prefill_start, config, kv_limit=prefill_kv_limit,
                         compute_logits=False, lora=prefill_lora)
    return serve_chunk_paged(params, state, pool, num_steps, config,
                             eos_id=eos_id, sampled=sampled,
                             generator=generator, lora_shared=lora_shared)


def _verify_append_core(params, tokens, pool, tables, positions, active,
                        config: LlamaConfig, kv_limit: Optional[int] = None,
                        lora=None):
    """Teacher-forced scoring of a (batch, K) speculative window straight
    against the block pool: every row at its OWN absolute start position
    (mid-block starts included), the window's K/V appended into the
    row's table-resolved blocks by :func:`~..ops.paged_prefill.
    paged_verify_attention` (the ``append_kv_ragged`` and
    ``chunk_attention`` kernels on the card, their plain versions on the
    CPU).  Inactive rows get ``chunk_len`` 0 and write tables of scratch
    block 0, so they write nothing; their logits are garbage the
    acceptance mask discards."""
    batch, K = tokens.shape
    h, kv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    device = tokens.device
    starts = torch.where(active, positions.to(torch.int32),
                         torch.zeros_like(positions, dtype=torch.int32))
    positions_b = starts.to(torch.int64)[:, None] + _iota(K, device)[None, :]
    chunk_lens = torch.where(active, K, 0).to(torch.int32)
    write_tables = torch.where(active[:, None], tables,
                               torch.zeros_like(tables)).to(torch.int32)
    rope = _rope_tables(config, positions_b)
    x = _embed_lookup(params, tokens, config.dtype)
    for layer, pool_layer, lora_layer in zip(
            params["layers"], pool, _lora_layers(lora, len(pool))):
        q, k, v = _qkv(layer, config, x, rope, lora, lora_layer)
        out, _ = paged_verify_attention(
            q.reshape(batch, K, kv, h // kv, hd).contiguous(),
            k.contiguous(), v.contiguous(), pool_layer, write_tables,
            starts, chunk_lens, window=config.sliding_window,
            kv_limit=kv_limit)
        x = x + _wo(out.reshape(batch, K, h * hd), layer, lora,
                    lora_layer).to(x.dtype)
        x = _mlp_block(layer, config, x)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return _matmul(x, params["lm_head"]).to(torch.float32), pool


@torch.no_grad()
def verify_chunk_paged(params, tokens, pool, tables, positions, active,
                       config: LlamaConfig, kv_limit: Optional[int] = None,
                       lora=None):
    """Speculative verify on the paged layout: score K tokens per slot
    against the block pool, each row at its own absolute position.
    ``tokens`` (batch, K) int32 windows (seed token + proposals),
    ``tables`` the resident (slots, max_blocks) block tables,
    ``positions`` (batch,) the absolute position of ``tokens[:, 0]``.

    Returns ``(logits (batch, K, vocab) f32, pool)``: ``logits[:, j]``
    predicts position ``positions + j + 1``.  The window's K/V rows land
    in each slot's own blocks at ``[positions, positions + K)``;
    rejected-tail rows are left stale (unattendable by the
    absolute-position mask until a later round rewrites them).  Callers
    reserve ``K`` rows of block headroom past the last committed position
    (the paged server's worst-case reservation includes ``spec_k + 1``)."""
    return _verify_append_core(params, tokens, pool, tables, positions,
                               active, config, kv_limit=kv_limit, lora=lora)


# --------------------------------------------------------------------------- #
# End-to-end completion

@torch.no_grad()
def complete(params, prompt_tokens, config: LlamaConfig,
             max_new_tokens: int = 32, temperature: float = 0.0,
             generator=None, top_k: int = 0, top_p=None,
             eos_token: Optional[int] = None, quantize_kv: bool = False):
    """Convenience end-to-end completion: :func:`prefill` + one
    :func:`generate_tokens` loop on a contiguous cache of ``prompt_len +
    max_new_tokens`` rows rounded up by :func:`~..ops.paged_attention.
    contiguous_rows` (the rows past them are masked), on the device the
    params live on.

    ``prompt_tokens`` (batch, prompt_len) int -> (batch, <= max_new) numpy
    int32 array of generated ids (prompt excluded), truncated at the first
    ``eos_token`` per row and padded with it to the longest row when one
    is given.  A sampled completion (``temperature > 0``) draws from
    ``generator`` (seeded 0 on the params' device when None).  The API
    the chat elements and the golden-completion tests use; serving paths
    keep the explicit prefill / decode calls."""
    import numpy as np
    device = params["final_norm"].device
    tokens = torch.as_tensor(np.asarray(prompt_tokens, np.int32),
                             device=device)
    batch, prompt_len = tokens.shape
    cache = init_cache(config, batch,
                       contiguous_rows(prompt_len + max_new_tokens),
                       quantize_kv=quantize_kv, device=device)
    logits, cache = prefill(params, tokens, cache, config)
    last = logits[:, -1]
    if temperature and temperature > 0:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        first = sample_logits(last, generator, temperature, top_k=top_k,
                              top_p=top_p)[:, None]
    else:
        first = last.argmax(dim=-1).to(torch.int32)[:, None]
    generated, _ = generate_tokens(
        params, first, cache, prompt_len, max_new_tokens - 1, config,
        temperature=temperature, generator=generator, top_k=top_k,
        top_p=top_p)
    out = np.concatenate([first.cpu().numpy(), generated.cpu().numpy()],
                         axis=1).astype(np.int32)
    if eos_token is not None:
        rows = []
        for row in out:
            hits = np.nonzero(row == eos_token)[0]
            rows.append(row[:hits[0]] if hits.size else row)
        width = max((len(r) for r in rows), default=0)
        padded = np.full((len(rows), width), eos_token, out.dtype)
        for i, row in enumerate(rows):
            padded[i, :len(row)] = row
        return padded
    return out
