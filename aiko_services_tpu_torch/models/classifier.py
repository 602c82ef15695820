"""Text classifier: a compact transformer encoder (DistilBERT-class).

Port of ``aiko_services_tpu/models/classifier.py`` (the sentiment
workload, BASELINE.json config 1): parameters are a dict of tensors in
the JAX package's layouts, ``forward`` is plain PyTorch (the JAX package
computes it outside any Pallas kernel).  Mean-pooled encoder -> 2-layer
head in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..device import resolve_device
from .common import gelu_mlp, layer_norm as _norm, mha as _mha

__all__ = ["ClassifierConfig", "init_params", "forward", "CONFIGS"]


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    vocab_size: int = 30_522          # bert-style
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 1024
    n_classes: int = 2
    max_seq_len: int = 512
    dtype: Any = torch.bfloat16


#: The JAX package's named configs, same names and sizes.
CONFIGS: Dict[str, ClassifierConfig] = {
    "tiny": ClassifierConfig(vocab_size=1024, d_model=64, n_layers=2,
                             n_heads=2, d_ff=128, max_seq_len=128),
    "distilbert": ClassifierConfig(vocab_size=30_522, d_model=768,
                                   n_layers=6, n_heads=12, d_ff=3072),
}


def init_params(config: ClassifierConfig, seed: int = 0,
                device=None) -> Dict:
    """Random fan-in-scaled parameters in the JAX package's tree layout,
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    dt = config.dtype
    d, f = config.d_model, config.d_ff

    def dense(shape):
        values = torch.randn(shape, generator=generator, device=device,
                             dtype=torch.float32)
        return (values * shape[0] ** -0.5).to(dt)

    def ones():
        return torch.ones((d,), dtype=dt, device=device)

    layers = [{"norm1": ones(), "wqkv": dense((d, 3 * d)),
               "wo": dense((d, d)), "norm2": ones(),
               "w1": dense((d, f)), "w2": dense((f, d))}
              for _ in range(config.n_layers)]
    return {
        "embed": dense((config.vocab_size, d)),
        "pos_embed": dense((config.max_seq_len, d)),
        "layers": layers,
        "head_w1": dense((d, d)),
        "head_w2": dense((d, config.n_classes)),
    }


@torch.no_grad()
def forward(params, tokens, config: ClassifierConfig):
    """tokens (batch, seq) int -> logits (batch, n_classes) f32."""
    seq = tokens.shape[1]
    x = params["embed"][tokens.long()] + params["pos_embed"][:seq][None]
    for layer in params["layers"]:
        normed = _norm(x, layer["norm1"])
        x = x + _mha(normed, normed, layer["wqkv"], layer["wo"],
                     config.n_heads, causal=False)
        x = gelu_mlp(x, layer["norm2"], layer["w1"], layer["w2"])
    pooled = x.to(torch.float32).mean(dim=1)
    hidden = torch.tanh(pooled @ params["head_w1"].to(torch.float32))
    return hidden @ params["head_w2"].to(torch.float32)
