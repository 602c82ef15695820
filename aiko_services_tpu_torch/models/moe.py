"""Mixture-of-Experts SwiGLU layer: the port of
``aiko_services_tpu/models/moe.py``.

Top-k routing builds a ``(tokens, experts, capacity)`` dispatch one-hot
and combine weights, token -> expert transport is two einsums, and every
expert runs as one batched FFN (``torch.bmm`` over the expert axis), in
the JAX package's formulation (GShard / Switch) and with its casts.  All
shapes are static: the capacity is a Python int of the input's shape, and
nothing reads a value back to the host, so the MoE decode step captures
into a CUDA graph like the dense one.

Tokens overflowing an expert's capacity are dropped: their combine weight
is zero, so they pass through the residual unchanged.  Routing is per
token, and so batch-invariant, only while nothing drops
(``capacity_factor >= n_experts / top_k``).

The router's product is f32 (``int8_matmul`` / ``int4_matmul`` on an f32
activation where the router is quantized, a dense f32 product otherwise);
routing decisions hang on those logits.  The expert products have no
Pallas kernel in the JAX package (its einsums go to XLA), so they are
PyTorch products here.  Expert sharding over an ``ep`` mesh axis is
multi-device work (:func:`moe_param_specs` raises).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.quant import (int4_matmul, int8_matmul, is_quantized,
                         is_quantized_int4)

__all__ = ["MoEConfig", "init_moe_params", "moe_ffn", "moe_ffn_reference",
           "moe_param_specs", "top_k_gating", "capacity"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 128
    d_ff: int = 256
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: Any = torch.bfloat16


def capacity(config: MoEConfig, tokens: int) -> int:
    """Slots an expert holds for a call of ``tokens`` tokens: the JAX
    expression verbatim, in Python floats, so drop-prone capacities
    agree."""
    return max(1, int(config.capacity_factor * tokens * config.top_k
                      / config.n_experts))


def init_moe_params(config: MoEConfig, seed: int = 0, device=None,
                    generator=None) -> Dict:
    """Random expert parameters in the reference layout: ``router (d,
    E)``, ``w_gate`` / ``w_up (E, d, f)``, ``w_down (E, f, d)``; fan-in
    scaled gaussians drawn from ``generator`` (or a ``torch.Generator``
    seeded with ``seed`` on ``device``)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    d, f, e = config.d_model, config.d_ff, config.n_experts

    def init(shape, scale):
        values = torch.randn(shape, generator=generator, device=device,
                             dtype=torch.float32)
        return (values * scale).to(config.dtype)

    return {"router": init((d, e), d ** -0.5),
            "w_gate": init((e, d, f), d ** -0.5),
            "w_up": init((e, d, f), d ** -0.5),
            "w_down": init((e, f, d), f ** -0.5)}


def moe_param_specs(ep_axis: str = "ep", feature_axis=None) -> Dict:
    """Expert sharding over an ``ep`` mesh axis: multi-device work, not
    ported yet."""
    raise NotImplementedError(
        "moe_param_specs: sharding experts over an ep mesh axis is "
        "multi-device work (ROADMAP queue 1, item 11)")


def top_k_gating(logits, top_k: int, capacity: int):
    """Router logits ``(T, E)`` -> dispatch ``(T, E, C)`` one-hot and
    combine ``(T, E, C)`` weights, both f32.

    f32 softmax; the top-k experts a token, highest probability first; a
    (token, choice) pair's slot is its rank among all pairs bound for the
    expert, counted token-major then choice-major (a cumsum); ranks >=
    ``capacity`` are dropped; the gate is renormalised over the chosen k
    (``max(sum, 1e-9)``) and a dropped pair's gate is 0."""
    tokens, n_experts = logits.shape
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gate, expert_ids = torch.topk(probs, top_k, dim=-1)       # (T, k)
    one_hot = F.one_hot(expert_ids, n_experts).to(torch.float32)
    flat = one_hot.reshape(tokens * top_k, n_experts)
    position = torch.cumsum(flat, dim=0) - flat               # (T*k, E)
    position = (position * flat).sum(-1).reshape(tokens, top_k)
    keep = position < capacity
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    gate = torch.where(keep, gate, torch.zeros_like(gate))
    position = torch.where(keep, position,
                           torch.zeros_like(position)).to(torch.int64)
    slot_hot = F.one_hot(position, capacity).to(torch.float32)
    dispatch = torch.einsum("tke,tkc->tec", one_hot,
                            slot_hot * keep[..., None].to(torch.float32))
    combine = torch.einsum("tke,tkc->tec", one_hot, slot_hot * gate[..., None])
    return dispatch, combine


def _router_logits(router, xt):
    """f32 router logits ``(T, E)`` by the router leaf's type."""
    x32 = xt.to(torch.float32)
    if is_quantized_int4(router):
        return int4_matmul(x32, router["q4"], router["s"])
    if is_quantized(router):
        # quantize_tree quantizes every 2-D leaf, the router included; the
        # 3-D expert weights stay in the model dtype.
        return int8_matmul(x32, router["q"], router["s"])
    return x32 @ router.to(torch.float32)


def moe_ffn(params, x, config: MoEConfig):
    """``x (batch, seq, d)`` -> MoE SwiGLU output (same shape and dtype,
    residual NOT included: the caller adds).  The capacity comes from
    ``batch * seq``, so a call's granularity is part of its semantics."""
    batch, seq, d = x.shape
    tokens = batch * seq
    xt = x.reshape(tokens, d)
    slots = capacity(config, tokens)
    logits = _router_logits(params["router"], xt)
    dispatch, combine = top_k_gating(logits, config.top_k, slots)
    n_experts = config.n_experts
    # Token -> expert slot transport: (E*C, T) @ (T, d).
    expert_in = (dispatch.to(x.dtype).reshape(tokens, n_experts * slots)
                 .transpose(0, 1) @ xt).reshape(n_experts, slots, d)
    gate = F.silu(torch.bmm(expert_in, params["w_gate"]).to(torch.float32))
    up = torch.bmm(expert_in, params["w_up"]).to(torch.float32)
    expert_out = torch.bmm((gate * up).to(x.dtype),
                           params["w_down"])                  # (E, C, d)
    out = combine.to(x.dtype).reshape(tokens, n_experts * slots) \
        @ expert_out.reshape(n_experts * slots, d)
    return out.reshape(batch, seq, d)


def moe_ffn_reference(params, x, config: MoEConfig):
    """Per-token loop oracle (numpy; tests only): each token's top-k
    experts in probability order, first come first served against the
    capacity, in f32."""
    import numpy as np
    batch, seq, d = x.shape
    xt = np.asarray(x.detach().cpu().to(torch.float32)).reshape(-1, d)
    tokens = xt.shape[0]
    slots = capacity(config, tokens)

    def host(tensor):
        return np.asarray(tensor.detach().cpu().to(torch.float32))

    logits = xt @ host(params["router"])
    logits = logits - logits.max(-1, keepdims=True)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    w_gate, w_up, w_down = (host(params[name])
                            for name in ("w_gate", "w_up", "w_down"))
    counts = [0] * config.n_experts
    out = np.zeros_like(xt)
    for t in range(tokens):
        ids = np.argsort(-probs[t])[:config.top_k]
        gates = probs[t, ids]
        gates = gates / max(gates.sum(), 1e-9)
        for expert, g in zip(ids, gates):
            if counts[expert] >= slots:
                continue
            counts[expert] += 1
            h = xt[t] @ w_gate[expert]
            silu = h / (1.0 + np.exp(-h)) * (xt[t] @ w_up[expert])
            out[t] += g * (silu @ w_down[expert])
    return out.reshape(batch, seq, d)
