"""Single-shot object detector: YOLO-class conv backbone + grid head.

Port of ``aiko_services_tpu/models/detector.py`` (the object-detection
workload, BASELINE.json config 2).  Anchor-free YOLO-style output: for
each grid cell, ``(x, y, w, h, objectness, class…)``.  Plain PyTorch: the
JAX package computes it outside any Pallas kernel.

Layouts stay the JAX package's, so the weight bridge carries a JAX tree
as it is (:func:`~.bridge.params_from_numpy`) and checkpoints are the same
``.npz`` files: images NHWC, conv weights HWIO ``(3, 3, c_in, c_out)``.
:func:`forward` turns them into ``conv2d``'s NCHW / OIHW inside, and its
result back to NHWC.  Each convolution pads as XLA's ``"SAME"`` does
(:func:`same_padding`: at stride 2 on an even size, 0 rows before and 1
after; ``padding=1`` would pad both sides and shift the grid), and takes
its products in f32 (the JAX ``preferred_element_type``), adding the bias
in f32 before the one rounding to the model dtype.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .bridge import tensor_from_numpy, tensor_to_numpy

__all__ = ["DetectorConfig", "init_params", "forward", "decode_boxes",
           "CONFIGS", "save_checkpoint", "load_checkpoint", "same_padding"]


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    image_size: int = 320
    n_classes: int = 80
    widths: Tuple[int, ...] = (16, 32, 64, 128, 256)
    dtype: Any = torch.bfloat16

    @property
    def grid_size(self) -> int:
        return self.image_size // (2 ** len(self.widths))

    @property
    def out_channels(self) -> int:
        return 5 + self.n_classes


#: The JAX package's named configs, same names and sizes.
CONFIGS: Dict[str, DetectorConfig] = {
    "tiny": DetectorConfig(image_size=64, n_classes=4,
                           widths=(8, 16, 32)),
    "yolo_n": DetectorConfig(image_size=320, n_classes=80,
                             widths=(16, 32, 64, 128, 256)),
}


def init_params(config: DetectorConfig, seed: int = 0, device=None) -> Dict:
    """Random He-scaled HWIO conv weights and zero biases in the JAX
    package's tree layout, from a ``torch.Generator`` seeded with
    ``seed`` on ``device``."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    dt = config.dtype

    def normal(shape, scale):
        values = torch.randn(shape, generator=generator, device=device,
                             dtype=torch.float32)
        return (values * scale).to(dt)

    layers = []
    c_in = 3
    for width in config.widths:
        layers.append({"w": normal((3, 3, c_in, width),
                                   (2.0 / (9 * c_in)) ** 0.5),
                       "b": torch.zeros((width,), dtype=dt, device=device)})
        c_in = width
    head = {"w": normal((1, 1, c_in, config.out_channels), c_in ** -0.5),
            "b": torch.zeros((config.out_channels,), dtype=dt,
                             device=device)}
    return {"layers": layers, "head": head}


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of XLA's ``"SAME"`` along one axis: the
    output has ``ceil(size / stride)`` positions and the odd pad goes
    after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, b, stride: int):
    """x NCHW in the model dtype, w HWIO, b (c_out,) -> NCHW in x's dtype."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = same_padding(x.shape[2], kh, stride)
    left, right = same_padding(x.shape[3], kw, stride)
    padded = F.pad(x, (left, right, top, bottom)).to(torch.float32)
    out = F.conv2d(padded, w.permute(3, 2, 0, 1).to(torch.float32),
                   stride=stride)
    return (out + b.to(torch.float32)[None, :, None, None]).to(x.dtype)


@torch.no_grad()
def forward(params, images, config: DetectorConfig):
    """images (batch, H, W, 3) -> raw grid (batch, gh, gw, 5+classes) f32."""
    x = images.to(config.dtype).permute(0, 3, 1, 2)
    for layer in params["layers"]:
        x = F.silu(_conv(x, layer["w"], layer["b"], stride=2))
    head = params["head"]
    out = _conv(x, head["w"], head["b"], stride=1).to(torch.float32)
    return out.permute(0, 2, 3, 1)


def decode_boxes(raw, config: DetectorConfig,
                 score_threshold: float = 0.5):
    """Raw grid -> (boxes xyxy [0,1], scores, classes int32, keep) with a
    static-shape mask (no data-dependent shapes: a CUDA graph captures
    it).  Column then row offsets from an iota, score = objectness x the
    largest class probability, class = the first index of the largest
    logit."""
    batch, gh, gw, _ = raw.shape
    xy_cell = torch.sigmoid(raw[..., 0:2])
    wh = torch.sigmoid(raw[..., 2:4])
    obj = torch.sigmoid(raw[..., 4])
    cls_logits = raw[..., 5:]
    col = torch.arange(gw, dtype=torch.float32,
                       device=raw.device)[None, :].expand(gh, gw)
    row = torch.arange(gh, dtype=torch.float32,
                       device=raw.device)[:, None].expand(gh, gw)
    cx = (xy_cell[..., 0] + col) / gw
    cy = (xy_cell[..., 1] + row) / gh
    half_w, half_h = wh[..., 0] / 2, wh[..., 1] / 2
    boxes = torch.stack([cx - half_w, cy - half_h,
                         cx + half_w, cy + half_h], dim=-1)
    scores = obj * torch.softmax(cls_logits, dim=-1).amax(dim=-1)
    classes = cls_logits.argmax(dim=-1).to(torch.int32)
    keep = scores >= score_threshold
    return (boxes.reshape(batch, -1, 4), scores.reshape(batch, -1),
            classes.reshape(batch, -1), keep.reshape(batch, -1))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def save_checkpoint(params, config: DetectorConfig, path: str) -> None:
    """Single-file ``.npz`` checkpoint, the JAX package's format: the
    flattened tree as f32 arrays (``head.w``, ``head.b``, ``layers.{i}.w``,
    ``layers.{i}.b``, in that order) and ``config_json``, the config's
    fields as UTF-8 JSON bytes.  Either package loads the other's."""
    arrays = {"head.w": tensor_to_numpy(params["head"]["w"])
              .astype(np.float32),
              "head.b": tensor_to_numpy(params["head"]["b"])
              .astype(np.float32)}
    for i, layer in enumerate(params["layers"]):
        arrays[f"layers.{i}.w"] = tensor_to_numpy(layer["w"]) \
            .astype(np.float32)
        arrays[f"layers.{i}.b"] = tensor_to_numpy(layer["b"]) \
            .astype(np.float32)
    arrays["config_json"] = np.frombuffer(json.dumps({
        "image_size": config.image_size,
        "n_classes": config.n_classes,
        "widths": list(config.widths),
        "dtype": _dtype_name(config.dtype),
    }).encode(), dtype=np.uint8)
    if not str(path).endswith(".npz"):
        path = f"{path}.npz"        # np.savez appends it silently;
    np.savez(path, **arrays)        # keep save/load paths agreeing


def load_checkpoint(path: str, device=None):
    """-> ``(params, DetectorConfig)`` from :func:`save_checkpoint` (or the
    JAX package's), the weights cast back to the config dtype on
    ``device``."""
    if not str(path).endswith(".npz"):
        path = f"{path}.npz"
    device = resolve_device(device)
    with np.load(path) as arrays:
        meta = json.loads(arrays["config_json"].tobytes().decode())
        config = DetectorConfig(
            image_size=int(meta["image_size"]),
            n_classes=int(meta["n_classes"]),
            widths=tuple(int(w) for w in meta["widths"]),
            dtype=getattr(torch, meta["dtype"]))

        def load(key):
            return tensor_from_numpy(arrays[key], device).to(config.dtype)

        params = {
            "layers": [{"w": load(f"layers.{i}.w"), "b": load(f"layers.{i}.b")}
                       for i in range(len(config.widths))],
            "head": {"w": load("head.w"), "b": load("head.b")},
        }
    return params, config
