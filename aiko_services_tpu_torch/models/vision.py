"""Vision encoder: CLIP-architecture ViT producing image embeddings.

Port of ``aiko_services_tpu/models/vision.py``, the vision half of the
CLIP -> LLM fan-out workload (BASELINE.json config 5).  Patchify ->
transformer encoder -> pooled, L2-normalized embedding.  Plain PyTorch
(the JAX package computes it outside any Pallas kernel); parameters are a
dict of tensors in the JAX package's layouts (weights ``(in, out)``), so
the two packages run on the same weights through
:func:`~.bridge.params_from_numpy`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..device import resolve_device
from .common import gelu_mlp, layer_norm as _norm, mha as _mha

__all__ = ["VisionConfig", "init_params", "encode", "CONFIGS"]


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 16
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    embed_dim: int = 512          # output embedding dimensionality
    dtype: Any = torch.bfloat16

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


#: The JAX package's named configs, same names and sizes.
CONFIGS: Dict[str, VisionConfig] = {
    "tiny": VisionConfig(image_size=32, patch_size=8, d_model=64,
                         n_layers=2, n_heads=2, embed_dim=64),
    "clip_base": VisionConfig(image_size=224, patch_size=16, d_model=768,
                              n_layers=12, n_heads=12, embed_dim=512),
}


def init_params(config: VisionConfig, seed: int = 0, device=None) -> Dict:
    """Random parameters (fan-in-scaled gaussians, unit norms, zero class
    token) in the JAX package's tree layout, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    d, dt = config.d_model, config.dtype
    patch_dim = 3 * config.patch_size ** 2

    def dense(shape):
        values = torch.randn(shape, generator=generator, device=device,
                             dtype=torch.float32)
        return (values * shape[0] ** -0.5).to(dt)

    def ones():
        return torch.ones((d,), dtype=dt, device=device)

    layers = [{"norm1": ones(), "wqkv": dense((d, 3 * d)),
               "wo": dense((d, d)), "norm2": ones(),
               "w1": dense((d, 4 * d)), "w2": dense((4 * d, d))}
              for _ in range(config.n_layers)]
    return {
        "patch_proj": dense((patch_dim, d)),
        "cls_token": torch.zeros((1, 1, d), dtype=dt, device=device),
        "pos_embed": dense((config.n_patches + 1, d)),
        "layers": layers,
        "final_norm": ones(),
        "head": dense((d, config.embed_dim)),
    }


@torch.no_grad()
def encode(params, images, config: VisionConfig):
    """images (batch, H, W, 3) float [0,1] -> dict with ``embedding``
    (batch, embed_dim) f32 L2-normalized (norm floored at 1e-6) and
    ``patch_features`` (batch, n_patches+1, d_model).  Each patch is
    flattened in ``(p, p, 3)`` order, as in the JAX package."""
    b = images.shape[0]
    p = config.patch_size
    grid = config.image_size // p
    x = images.to(config.dtype)
    x = x.reshape(b, grid, p, grid, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, grid * grid, p * p * 3)
    x = x @ params["patch_proj"]
    cls = params["cls_token"].expand(b, 1, config.d_model).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    for layer in params["layers"]:
        normed = _norm(x, layer["norm1"])
        x = x + _mha(normed, normed, layer["wqkv"], layer["wo"],
                     config.n_heads, causal=False)
        x = gelu_mlp(x, layer["norm2"], layer["w1"], layer["w2"])
    x = _norm(x, params["final_norm"])
    embedding = (x[:, 0] @ params["head"]).to(torch.float32)
    norm = torch.linalg.vector_norm(embedding, dim=-1, keepdim=True)
    embedding = embedding / torch.clamp_min(norm, 1e-6)
    return {"embedding": embedding, "patch_features": x}
