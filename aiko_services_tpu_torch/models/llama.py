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

Seven hand-written CUDA kernels carry the serving paths: ``int8_matmul``
or ``int4_matmul`` (by the weights' layout) in every projection at decode
shapes, ``flash_attention`` in contiguous
prefill, ``paged_decode_attention`` in every decode step (contiguous caches
feed it as a degenerate pool), ``append_kv`` + ``chunk_attention`` in
paged admission (:func:`prefill_append_paged`, :func:`serve_chunk_mixed`),
and ``append_kv_ragged`` + ``chunk_attention`` in the speculative verify
(:func:`verify_chunk_paged`).  Each takes its plain version only on CPU
tensors.

JAX donates caches to its jitted programs; here caches are updated IN
PLACE (each write function mutates and returns the same per-layer dict),
which is what donation buys on the TPU.  ``lax.scan`` becomes a Python
loop over steps; EOS/budget retirement stays on the device as
``torch.where`` on the state tensors, with no host sync per step.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.attention import flash_attention
from ..ops.paged_attention import (cached_gqa_attention,
                                   contiguous_block_size,
                                   paged_decode_attention)
from ..ops.paged_prefill import (_gathered_view, _kv_quantize_rows,
                                 _pool_sources, _write_rows_reference,
                                 paged_prefill_attention,
                                 paged_verify_attention)
from ..ops.quant import (_unpack_int4, int4_matmul, int8_matmul,
                         is_quantized, is_quantized_int4, quantize_tree)

__all__ = ["LlamaConfig", "CONFIGS", "init_params", "quantize_params",
           "random_quantized_params", "forward", "init_cache", "prefill",
           "decode_step", "generate_tokens", "serve_chunk_ragged",
           "scatter_state_rows", "sample_logits", "rms_norm",
           "apply_rope", "init_paged_cache", "decode_chunk_paged",
           "serve_chunk_paged", "prefill_append_paged",
           "serve_chunk_mixed", "paged_insert_prefix", "verify_chunk_paged",
           "sampling_probs"]


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
    #: > 0 = mixture-of-experts MLP (not ported yet: such configs raise).
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


def _dense_only(config: LlamaConfig) -> None:
    if config.n_experts:
        raise NotImplementedError(
            "mixture-of-experts configs are not ported yet")


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
    seeded with ``seed`` on ``device``."""
    _dense_only(config)
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    dt = config.dtype
    d, h, kv, hd, f = (config.d_model, config.n_heads, config.n_kv_heads,
                       config.head_dim, config.d_ff)

    def dense(shape, scale=None):
        return _dense_init(generator, shape, dt, device, scale)

    layers = []
    for _ in range(config.n_layers):
        layers.append({
            "attn_norm": torch.ones((d,), dtype=dt, device=device),
            "wq": dense((d, h * hd)),
            "wk": dense((d, kv * hd)),
            "wv": dense((d, kv * hd)),
            "wo": dense((h * hd, d)),
            "mlp_norm": torch.ones((d,), dtype=dt, device=device),
            "w_gate": dense((d, f)),
            "w_up": dense((d, f)),
            "w_down": dense((f, d)),
        })
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
    int8, because its read path is a row gather."""
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
    _dense_only(config)
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


def _qkv(layer, config, x, rope):
    """Pre-norm q/k/v projections with rotary embeddings applied: q
    (batch, seq, heads, hd), k/v (batch, seq, kv_heads, hd)."""
    batch, seq, _ = x.shape
    h, kv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    normed = rms_norm(x, layer["attn_norm"], config.norm_eps)
    q = _matmul(normed, layer["wq"]).reshape(batch, seq, h, hd)
    k = _matmul(normed, layer["wk"]).reshape(batch, seq, kv, hd)
    v = _matmul(normed, layer["wv"]).reshape(batch, seq, kv, hd)
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


def _attention_block(layer, config, x, rope):
    """Full-sequence (no-cache) attention block."""
    q, k, v = _qkv(layer, config, x, rope)
    out = _matmul(_attend_full(config, q, k, v), layer["wo"])
    return x + out.to(x.dtype)


def _mlp_block(layer, config, x):
    normed = rms_norm(x, layer["mlp_norm"], config.norm_eps)
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
    _dense_only(config)
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
    with per-(token, kv-head) f32 scales."""
    if rolling:
        raise NotImplementedError("rolling (ring-buffer) caches are not "
                                  "ported yet")
    rows = max_seq or config.max_seq_len
    return _kv_layer_buffers(
        config, (batch, rows, config.n_kv_heads, config.head_dim),
        quantize_kv, resolve_device(device))


def _kv_layer_buffers(config: LlamaConfig, shape, quantize_kv: bool,
                      device) -> List[Dict]:
    """Per-layer KV buffer dicts: the ONE place the cache layout (dtypes,
    scale keys) is defined."""
    if quantize_kv:
        sshape = shape[:-1]
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "ks": torch.ones(sshape, dtype=torch.float32,
                                  device=device),
                 "vs": torch.ones(sshape, dtype=torch.float32,
                                  device=device)}
                for _ in range(config.n_layers)]
    return [{"k": torch.zeros(shape, dtype=config.dtype, device=device),
             "v": torch.zeros(shape, dtype=config.dtype, device=device)}
            for _ in range(config.n_layers)]


#: (..., hd) -> (int8 rows, f32 scales (...,)): symmetric absmax per vector
#: (one scale per cached token per kv head).  The ONE quantizer of the
#: port's int8 KV: the paged append kernel reproduces it bit for bit.
_kv_quantize = _kv_quantize_rows


def _cache_write_slab(cache_layer, k, v, start_index: int):
    """Write a contiguous (batch, K, kv, hd) slab at ``start_index``, in
    place."""
    seq = k.shape[1]
    for key, src in _pool_sources(cache_layer, k, v).items():
        buf = cache_layer[key]
        buf[:, start_index:start_index + seq] = src.to(buf.dtype)
    return cache_layer


def _cache_write_rows(cache_layer, k, v, positions):
    """Write one (batch, 1, kv, hd) row per batch element at per-row
    ``positions``, in place."""
    rows = _iota(k.shape[0], k.device)
    positions = positions.to(torch.int64)
    for key, src in _pool_sources(cache_layer, k, v).items():
        buf = cache_layer[key]
        buf[rows, positions] = src[:, 0].to(buf.dtype)
    return cache_layer


@torch.no_grad()
def prefill(params, tokens, cache, config: LlamaConfig):
    """Run the prompt through the model filling the KV cache (in place);
    returns (logits of the last position (batch, 1, vocab) f32, cache)."""
    _dense_only(config)
    batch, seq = tokens.shape
    rope = _rope_tables(config, _positions(batch, seq, tokens.device))
    x = _embed_lookup(params, tokens, config.dtype)
    for layer, cache_layer in zip(params["layers"], cache):
        q, k, v = _qkv(layer, config, x, rope)
        _cache_write_slab(cache_layer, k, v, 0)
        out = _attend_full(config, q, k, v)
        x = x + _matmul(out, layer["wo"]).to(x.dtype)
        x = _mlp_block(layer, config, x)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = _matmul(x[:, -1:], params["lm_head"]).to(torch.float32)
    return logits, cache


def _decode_attention_contiguous(q_g, cache_layer, positions, hd, window):
    """Single-token ragged decode attention over a CONTIGUOUS cache: on a
    CUDA tensor, the paged decode kernel over the cache viewed as a
    degenerate block pool (a free reshape, iota block tables); elsewhere,
    or when ``max_seq`` has no usable block size, the plain
    :func:`cached_gqa_attention` (the JAX package's dispatch rule)."""
    max_seq = cache_layer["k"].shape[1]
    block_size = contiguous_block_size(max_seq)
    if q_g.device.type != "cuda" or not block_size:
        return cached_gqa_attention(q_g, cache_layer, positions[:, None],
                                    hd, window=window)
    batch = q_g.shape[0]
    blocks_per_row = max_seq // block_size
    tables = _iota(batch * blocks_per_row, q_g.device, torch.int32) \
        .reshape(batch, blocks_per_row)
    pool = {key: buf.reshape((batch * blocks_per_row, block_size)
                             + tuple(buf.shape[2:]))
            for key, buf in cache_layer.items()}
    out = paged_decode_attention(
        q_g[:, 0].contiguous(), pool["k"], pool["v"], tables,
        positions.to(torch.int32), ks=pool.get("ks"), vs=pool.get("vs"),
        window=window)
    return out[:, None]


def _attention_decode_ragged(layer, config, x, rope, cache_layer,
                             positions):
    """Single-token decode where every batch row sits at its OWN cache
    position.  ``x`` (batch, 1, d), ``positions`` (batch,)."""
    batch, seq, _ = x.shape
    h, kv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    q, k, v = _qkv(layer, config, x, rope)
    _cache_write_rows(cache_layer, k, v, positions)
    q_g = q.reshape(batch, seq, kv, h // kv, hd)
    out = _decode_attention_contiguous(q_g, cache_layer, positions, hd,
                                       config.sliding_window)
    out = out.reshape(batch, seq, h * hd)
    return x + _matmul(out, layer["wo"]).to(x.dtype)


def _decode_core_ragged(params, token, cache, positions,
                        config: LlamaConfig):
    """One autoregressive step with PER-ROW cache positions: token
    (batch, 1) + positions (batch,) -> (logits (batch, 1, vocab) f32,
    cache updated in place)."""
    rope = _rope_tables(config, positions[:, None])
    x = _embed_lookup(params, token, config.dtype)
    for layer, cache_layer in zip(params["layers"], cache):
        x = _attention_decode_ragged(layer, config, x, rope, cache_layer,
                                     positions)
        x = _mlp_block(layer, config, x)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return _matmul(x, params["lm_head"]).to(torch.float32), cache


@torch.no_grad()
def decode_step(params, token, cache, cache_index: int,
                config: LlamaConfig):
    """One step at a shared cache position (the ragged core with a
    constant position vector, as in the JAX package)."""
    positions = torch.full((token.shape[0],), int(cache_index),
                           dtype=torch.int32, device=token.device)
    return _decode_core_ragged(params, token, cache, positions, config)


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


@torch.no_grad()
def serve_chunk_ragged(params, state, cache, num_steps: int,
                       config: LlamaConfig, eos_id: int = -1,
                       sampled: bool = False, generator=None):
    """``num_steps`` device-resident decode steps for the serving loop:
    per-slot state in the device ``state`` dict, EOS/budget retirement
    on the device, cache updated in place.  Inactive slots write their
    K/V into the scratch row ``max_seq - 1`` so they cannot corrupt a
    live slot's prefix.  ``sampled`` selects the program with sampling
    math; greedy traffic pays none."""
    max_seq = cache[0]["k"].shape[1]

    def step_core(token, cache, positions, active):
        write_pos = torch.where(active, positions,
                                torch.full_like(positions, max_seq - 1))
        return _decode_core_ragged(params, token, cache, write_pos, config)

    return _serve_scan(step_core, state, cache, num_steps, eos_id,
                       sampled, generator)


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


def _paged_write_rows(pool_layer, k, v, tables, positions):
    """Scatter one (batch, 1, kv, hd) row per slot into the pool at
    ``(tables[s, pos // bs], pos % bs)``, in place."""
    return _paged_write_slab(pool_layer, k, v, tables, positions[:, None])


def _attention_decode_paged(layer, config, x, rope, pool_layer, tables,
                            positions):
    """Single-token decode against the block pool (per-row positions).  On
    a CUDA tensor the paged decode kernel walks the REAL block tables; on
    the CPU the gathered view goes through the plain attention."""
    batch, seq, _ = x.shape
    h, kv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    q, k, v = _qkv(layer, config, x, rope)
    _paged_write_rows(pool_layer, k, v, tables, positions)
    q_g = q.reshape(batch, seq, kv, h // kv, hd)
    if q_g.device.type == "cuda":
        out = paged_decode_attention(
            q_g[:, 0].contiguous(), pool_layer["k"], pool_layer["v"],
            tables, positions.to(torch.int32), ks=pool_layer.get("ks"),
            vs=pool_layer.get("vs"), window=config.sliding_window)[:, None]
    else:
        out = cached_gqa_attention(q_g, _paged_gather(pool_layer, tables),
                                   positions[:, None], hd,
                                   window=config.sliding_window)
    out = out.reshape(batch, seq, h * hd)
    return x + _matmul(out, layer["wo"]).to(x.dtype)


def _decode_core_paged(params, token, pool, tables, positions,
                       config: LlamaConfig):
    """One paged decode step: token (batch, 1) at per-row ``positions``
    -> (logits (batch, 1, vocab) f32, pool updated in place)."""
    rope = _rope_tables(config, positions[:, None])
    x = _embed_lookup(params, token, config.dtype)
    for layer, pool_layer in zip(params["layers"], pool):
        x = _attention_decode_paged(layer, config, x, rope, pool_layer,
                                    tables, positions)
        x = _mlp_block(layer, config, x)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return _matmul(x, params["lm_head"]).to(torch.float32), pool


def _paged_step_core(params, tables, pool, config: LlamaConfig):
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
                                  write_pos, config)
    return step_core


@torch.no_grad()
def serve_chunk_paged(params, state, pool, num_steps: int,
                      config: LlamaConfig, eos_id: int = -1,
                      sampled: bool = False, generator=None):
    """Paged twin of :func:`serve_chunk_ragged`: the block tables ride the
    resident ``state`` (``state["tables"]``), so table updates merge in
    with the other dirty rows."""
    return _serve_scan(_paged_step_core(params, state["tables"], pool,
                                        config),
                       state, pool, num_steps, eos_id, sampled, generator)


@torch.no_grad()
def decode_chunk_paged(params, tokens, pool, tables, positions, active,
                       num_steps: int, config: LlamaConfig,
                       temperatures=None, top_ps=None, generator=None,
                       return_logits: bool = False):
    """``num_steps`` paged decode steps for every slot, no EOS and no
    budget (the JAX package's paged oracle, and the speculative draft's
    proposer).  Inactive slots write scratch block 0 and do not advance.
    Returns (tokens_out (slots, num_steps), last token (slots, 1),
    positions, pool); ``return_logits=True`` inserts each step's
    next-token logits (slots, num_steps, vocab) after ``tokens_out``, for
    the sampled acceptance of a draft's proposals."""
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
    tokens_out, _, state, pool = _serve_scan(
        _paged_step_core(params, tables, pool, config), state, pool,
        num_steps, -1, sampled, generator, step_logits=step_logits)
    if return_logits:
        return (tokens_out, torch.stack(step_logits, dim=1), state["token"],
                state["positions"], pool)
    return tokens_out, state["token"], state["positions"], pool


@torch.no_grad()
def paged_insert_prefix(pool, tables, prefix_cache, slot: int):
    """Copy a contiguous prefilled cache (per layer ``(1, padded, kv,
    hd)``, the pool's KV layout) into ``slot``'s first ``padded //
    block_size`` table blocks, in place.  ``tables`` (slots, max_blocks);
    ``padded`` must be a multiple of the pool's block size."""
    block_size = pool[0]["k"].shape[1]
    padded = prefix_cache[0]["k"].shape[1]
    block_ids = tables[int(slot), :padded // block_size].to(torch.int64)
    for pool_layer, prefix_layer in zip(pool, prefix_cache):
        for key, buf in pool_layer.items():
            src = prefix_layer[key][0]
            buf[block_ids] = src.reshape((padded // block_size, block_size)
                                         + tuple(src.shape[1:])).to(buf.dtype)
    return pool


def _prefill_append_core(params, tokens, pool, tables, start_index: int,
                         config: LlamaConfig, kv_limit: Optional[int] = None,
                         compute_logits: bool = True):
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
    for layer, pool_layer in zip(params["layers"], pool):
        q, k, v = _qkv(layer, config, x, rope)
        out, _ = paged_prefill_attention(
            q.reshape(batch, K, kv, h // kv, hd).contiguous(),
            k.contiguous(), v.contiguous(), pool_layer, tables, cached_lens,
            chunk_lens, window=config.sliding_window, kv_limit=kv_limit)
        x = x + _matmul(out.reshape(batch, K, h * hd),
                        layer["wo"]).to(x.dtype)
        x = _mlp_block(layer, config, x)
    if not compute_logits:
        return None, pool
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return _matmul(x, params["lm_head"]).to(torch.float32), pool


@torch.no_grad()
def prefill_append_paged(params, tokens, pool, tables, start_index: int,
                         config: LlamaConfig, kv_limit: Optional[int] = None,
                         compute_logits: bool = True):
    """Admit a (batch, K) prompt chunk into the block pool by append
    attention; a prefix-cache hit passes ``start_index = n_shared *
    block_size`` and the shared blocks are only read.  ``kv_limit`` bounds
    the kernel's block sweep to the request's own allocation.  Returns
    (logits (batch, K, vocab) f32 or None, pool)."""
    _dense_only(config)
    return _prefill_append_core(params, tokens, pool, tables, start_index,
                                config, kv_limit=kv_limit,
                                compute_logits=compute_logits)


@torch.no_grad()
def serve_chunk_mixed(params, state, pool, prefill_tokens, prefill_row: int,
                      prefill_start: int, num_steps: int,
                      config: LlamaConfig, eos_id: int = -1,
                      sampled: bool = False, generator=None,
                      prefill_kv_limit: Optional[int] = None):
    """Sarathi-style mixed step: a chunked-prefill slice for the admitting
    slot ``prefill_row`` (its table row read from the resident state),
    then ``num_steps`` decode steps for the live slots, in one call.  The
    prefilling slot stays inactive in ``state`` until its last slice
    lands, so the decode steps treat it as a scratch lane."""
    tables_row = state["tables"][int(prefill_row):int(prefill_row) + 1]
    _prefill_append_core(params, prefill_tokens, pool, tables_row,
                         prefill_start, config, kv_limit=prefill_kv_limit,
                         compute_logits=False)
    return serve_chunk_paged(params, state, pool, num_steps, config,
                             eos_id=eos_id, sampled=sampled,
                             generator=generator)


def _verify_append_core(params, tokens, pool, tables, positions, active,
                        config: LlamaConfig, kv_limit: Optional[int] = None):
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
    for layer, pool_layer in zip(params["layers"], pool):
        q, k, v = _qkv(layer, config, x, rope)
        out, _ = paged_verify_attention(
            q.reshape(batch, K, kv, h // kv, hd).contiguous(),
            k.contiguous(), v.contiguous(), pool_layer, write_tables,
            starts, chunk_lens, window=config.sliding_window,
            kv_limit=kv_limit)
        x = x + _matmul(out.reshape(batch, K, h * hd),
                        layer["wo"]).to(x.dtype)
        x = _mlp_block(layer, config, x)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    return _matmul(x, params["lm_head"]).to(torch.float32), pool


@torch.no_grad()
def verify_chunk_paged(params, tokens, pool, tables, positions, active,
                       config: LlamaConfig, kv_limit: Optional[int] = None):
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
    _dense_only(config)
    return _verify_append_core(params, tokens, pool, tables, positions,
                               active, config, kv_limit=kv_limit)
