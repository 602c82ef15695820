"""LoRA: low-rank adapters on the port's llama.

Port of ``aiko_services_tpu/models/lora.py``.  An adapter is two rank-r
factors a target matrix: ``W_eff = W + (alpha / r) · A @ B``, with ``A``
``(d_in, r)`` and ``B`` ``(r, d_out)``.  :func:`merge_lora` bakes the
update into a plain parameter tree (:func:`lora_forward` is the same
computation, functionally); :func:`stack_adapters` stacks N adapters for
batched multi-adapter SERVING (S-LoRA style): each batch row gathers its
own factors (:func:`~.llama._lora_delta`), so a mixed-adapter batch pays
the base weight stream once.

Random factors come from an explicit ``torch.Generator`` where the JAX
package takes a key.  Left out, raising by name: the tensor-parallel
partition specs (:func:`lora_param_specs`, ``ROADMAP.md`` queue 1 item
11) and adapter training (:func:`make_lora_train_step`, item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from ..device import resolve_device
from . import llama

__all__ = ["LoRAConfig", "DEFAULT_TARGETS", "SERVING_TARGETS",
           "factor_dims", "init_lora_params", "merge_lora", "lora_forward",
           "make_lora_train_step", "lora_param_specs", "stack_adapters"]

#: Targets the batched multi-adapter SERVING path supports (the attention
#: projections: the hooks of :func:`~.llama._lora_matmul`).  MLP targets
#: merge fine but do not run per row.
SERVING_TARGETS = frozenset({"wq", "wk", "wv", "wo"})

#: Default adaptation targets (the standard LoRA recipe).
DEFAULT_TARGETS = ("wq", "wv")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def factor_dims(config: llama.LlamaConfig):
    """``(in_dims, out_dims)`` per target: factor ``a`` is ``(in_dims[t],
    rank)``, ``b`` is ``(rank, out_dims[t])`` (the one source of truth for
    factor shapes: init, stacking, page codec, checkpoint import)."""
    d = config.d_model
    h, kv, hd = config.n_heads, config.n_kv_heads, config.head_dim
    out_dims = {"wq": h * hd, "wk": kv * hd, "wv": kv * hd,
                "wo": d, "w_gate": config.d_ff, "w_up": config.d_ff,
                "w_down": d}
    in_dims = {"wq": d, "wk": d, "wv": d, "wo": h * hd,
               "w_gate": d, "w_up": d, "w_down": config.d_ff}
    return in_dims, out_dims


def init_lora_params(config: llama.LlamaConfig, lora: LoRAConfig,
                     seed: int = 0, device=None) -> Dict:
    """A ~ N(0, 1/d_in), B = 0, so a fresh adapter is an exact no-op.
    Drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    in_dims, out_dims = factor_dims(config)
    if config.n_experts:
        for target in lora.targets:
            if target in ("w_gate", "w_up", "w_down"):
                raise ValueError(
                    f"LoRA target {target!r} does not exist in MoE configs "
                    "(experts replace the dense MLP); adapt attention "
                    "projections instead")
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    layers = []
    for _ in range(config.n_layers):
        layer = {}
        for target in lora.targets:
            if target not in out_dims:
                raise ValueError(f"unknown LoRA target {target!r}")
            a = torch.randn((in_dims[target], lora.rank),
                            generator=generator, device=device,
                            dtype=torch.float32) * in_dims[target] ** -0.5
            layer[target] = {
                "a": a.to(config.dtype),
                "b": torch.zeros((lora.rank, out_dims[target]),
                                 dtype=config.dtype, device=device),
            }
        layers.append(layer)
    return {"layers": layers}


def lora_param_specs(config: llama.LlamaConfig, lora: LoRAConfig):
    """The JAX package's TP partition specs of the factors.  Tensor-
    parallel pools are ``ROADMAP.md`` queue 1 item 11, not ported yet."""
    raise NotImplementedError(
        "lora_param_specs (LoRA on tensor-parallel pools) is ROADMAP "
        "queue 1 item 11 (multi-device), not ported yet")


def _adapted_params(base, lora_params, lora: LoRAConfig):
    merged_layers = []
    for base_layer, lora_layer in zip(base["layers"], lora_params["layers"]):
        layer = dict(base_layer)
        for target, factors in lora_layer.items():
            weight = base_layer[target]
            if not torch.is_tensor(weight):
                raise ValueError(
                    f"merge_lora needs dense base weights; {target!r} is "
                    "quantized")
            delta = (factors["a"].to(torch.float32)
                     @ factors["b"].to(torch.float32)) * lora.scale
            layer[target] = (weight.to(torch.float32) + delta).to(weight.dtype)
        merged_layers.append(layer)
    return {**base, "layers": merged_layers}


def lora_forward(base, lora_params, tokens, config: llama.LlamaConfig,
                 lora: LoRAConfig):
    """Forward with the adapter applied functionally (the base frozen)."""
    return llama.forward(_adapted_params(base, lora_params, lora), tokens,
                         config)


def merge_lora(base, lora_params, lora: LoRAConfig) -> Dict:
    """Bake the adapter into a plain parameter tree (equal to
    :func:`lora_forward`'s weights exactly)."""
    return _adapted_params(base, lora_params, lora)


def stack_adapters(config: llama.LlamaConfig, lora: LoRAConfig,
                   adapters: Sequence[Dict], device=None) -> Dict:
    """Stack N adapters for batched multi-adapter serving: per layer and
    target, ``a: (N+1, d_in, r)``, ``b: (N+1, r, d_out)`` in the model
    dtype on ``device`` (the first factor's device when None), index 0 the
    ALL-ZERO identity adapter (a base-model row gathers an exact no-op).
    The result is the ``lora`` argument of the llama entry points minus
    the per-row ``ids``.  Factors may be numpy arrays (the bridge's
    layouts) or tensors.

    All adapters share ``lora`` (rank, scale, targets), and the targets
    must be within :data:`SERVING_TARGETS`.  Every adapter's factor shapes
    are checked against ``config`` / ``lora`` BEFORE stacking, so a
    wrong-rank, wrong-base or differently targeted adapter fails here by
    name."""
    unsupported = set(lora.targets) - SERVING_TARGETS
    if unsupported:
        raise ValueError(
            "multi-adapter serving supports attention targets only; got "
            f"{sorted(unsupported)}")
    in_dims, out_dims = factor_dims(config)
    for index, adapter in enumerate(adapters):
        try:
            adapter_layers = list(adapter["layers"])
        except (KeyError, TypeError):
            raise ValueError(
                f"adapter {index} params lack the per-layer target layout")
        if len(adapter_layers) != config.n_layers:
            raise ValueError(
                f"adapter {index} has {len(adapter_layers)} layers != "
                f"config.n_layers {config.n_layers}")
        for i, layer in enumerate(adapter_layers):
            if set(layer) != set(lora.targets):
                raise ValueError(
                    f"adapter {index} layer {i} targets {sorted(layer)} != "
                    f"expected targets {sorted(lora.targets)}")
            for target in lora.targets:
                want_a = (in_dims[target], lora.rank)
                want_b = (lora.rank, out_dims[target])
                try:
                    got_a = tuple(layer[target]["a"].shape)
                    got_b = tuple(layer[target]["b"].shape)
                except (KeyError, TypeError, AttributeError):
                    raise ValueError(
                        f"adapter {index} layer {i} target {target!r} "
                        "lacks array 'a'/'b' factors")
                if got_a != want_a or got_b != want_b:
                    raise ValueError(
                        f"adapter {index} layer {i} target {target!r} "
                        f"factor shapes a{got_a}/b{got_b} != expected "
                        f"a{want_a}/b{want_b} (rank {lora.rank})")
    if device is None:
        first = adapters[0]["layers"][0][lora.targets[0]]["a"] \
            if adapters else None
        device = first.device if torch.is_tensor(first) else "cpu"

    def tensor(value):
        if not torch.is_tensor(value):
            from .bridge import tensor_from_numpy
            value = tensor_from_numpy(value)
        return value.to(device=device, dtype=config.dtype)

    layers = []
    for i in range(config.n_layers):
        layer = {}
        for target in lora.targets:
            a_stack = [tensor(a["layers"][i][target]["a"]) for a in adapters]
            b_stack = [tensor(a["layers"][i][target]["b"]) for a in adapters]
            layer[target] = {
                "a": torch.stack([torch.zeros_like(a_stack[0])] + a_stack),
                "b": torch.stack([torch.zeros_like(b_stack[0])] + b_stack),
            }
        layers.append(layer)
    return {"scale": lora.scale, "layers": layers}


def make_lora_train_step(config: llama.LlamaConfig, lora: LoRAConfig,
                         optimizer):
    """The JAX package's adapter-only training step.  Training is
    ``ROADMAP.md`` queue 1 item 10, not ported yet."""
    raise NotImplementedError(
        "make_lora_train_step (LoRA training) is ROADMAP queue 1 item 10 "
        "(training and checkpoints), not ported yet")
