"""Swag wire codec for remote pipeline-element crossings.

The port's copy of ``aiko_services_tpu/pipeline/codec.py`` (it has no
JAX in it); its imports point at the port's own modules.

The reference marshals tensors ad hoc: base64 numpy inside S-expressions
(``examples/pipeline/elements.py:298-324``) or zlib'd ``np.save`` bytes on
raw binary side-channel topics (``elements/media/audio_io.py:585-593``).
Here one typed codec covers the control-plane path: every swag value is
encoded as ``"<tag>:<text>"`` where the tag selects str/int/float/bool/
json/numpy(+zlib+base64).  Tensors are converted to numpy at the
process boundary — on-pod element hand-offs never hit this codec (device
buffers stay resident; see the TPU execution layer).

Large HIGH-ENTROPY tensors (KV-cache block transfers, quantized
activations) defeat zlib: near-random bf16/int8 bytes compress to ≥99%
of their size while burning a full CPU pass.  ``encode_value`` switches
to the uncompressed ``N`` tag (base64'd ``np.save`` bytes, no zlib) once
an array exceeds :data:`RAW_NBYTES` — decode accepts both tags
regardless of size, so the threshold can move without a wire break.
"""

from __future__ import annotations

import base64
import io
import json
import zlib
from typing import Any, Dict

import numpy as np

__all__ = ["encode_value", "decode_value", "encode_swag", "decode_swag",
           "host_array", "RAW_NBYTES"]

#: Arrays at or above this many bytes skip zlib (``N`` tag): token id
#: vectors stay tiny-and-compressible, KV block payloads are entropy.
RAW_NBYTES = 16384


def host_array(value: Any) -> np.ndarray:
    """``value`` as a numpy array on the host: a tensor (on any device) is
    copied back first, bfloat16 widened to float32 (exact), since numpy
    has no bfloat16 of its own.  Anything else goes through
    ``np.asarray``."""
    if hasattr(value, "detach") and hasattr(value, "cpu"):
        value = value.detach().cpu()
        if str(value.dtype) == "torch.bfloat16":
            value = value.float()
        return value.numpy()
    return np.asarray(value)


def encode_value(value: Any) -> str:
    if value is None:
        return "z:"
    if isinstance(value, str):
        return f"s:{value}"
    if isinstance(value, bool):
        return f"b:{int(value)}"
    if isinstance(value, int):
        return f"i:{value}"
    if isinstance(value, float):
        return f"f:{value!r}"
    if hasattr(value, "__array__") or isinstance(value, np.ndarray):
        array = host_array(value)
        buffer = io.BytesIO()
        np.save(buffer, array, allow_pickle=False)
        raw = buffer.getvalue()
        if array.nbytes >= RAW_NBYTES:
            return f"N:{base64.b64encode(raw).decode('ascii')}"
        packed = base64.b64encode(zlib.compress(raw))
        return f"n:{packed.decode('ascii')}"
    # Lists / dicts of JSON-compatible values.
    return f"j:{json.dumps(value)}"


def decode_value(text: str) -> Any:
    tag, _, body = text.partition(":")
    if tag == "z":
        return None
    if tag == "s":
        return body
    if tag == "b":
        return bool(int(body))
    if tag == "i":
        return int(body)
    if tag == "f":
        return float(body)
    if tag == "n":
        raw = zlib.decompress(base64.b64decode(body.encode("ascii")))
        return np.load(io.BytesIO(raw), allow_pickle=False)
    if tag == "N":
        raw = base64.b64decode(body.encode("ascii"))
        return np.load(io.BytesIO(raw), allow_pickle=False)
    if tag == "j":
        return json.loads(body)
    raise ValueError(f"Unknown codec tag: {tag!r}")


def encode_swag(swag: Dict[str, Any]) -> Dict[str, str]:
    return {key: encode_value(value) for key, value in swag.items()}


def decode_swag(encoded: Dict[str, str]) -> Dict[str, Any]:
    return {key: decode_value(value) for key, value in encoded.items()}
