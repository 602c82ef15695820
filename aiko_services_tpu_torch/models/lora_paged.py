"""Paged adapter storage: canonical LoRA factor bytes <-> pool pages.

The port's copy of ``aiko_services_tpu/models/lora_paged.py`` (it has no
JAX in it), byte for byte in what it writes: a packed adapter stream or a
pool page made here reads back in the JAX package and the other way
round, so adapter pages cross backends as KV blocks do.

S-LoRA's unified paging: adapter A/B factors live in the SAME block pool
as the KV cache, so warm adapters and the prefix cache compete for device
memory under one eviction clock.  This module is the byte layer, host-side
``numpy`` only:

* :func:`pack_adapter` serializes one adapter's ``{"layers": [...]}``
  factor tree into one self-describing byte stream: an ``AIKOLOR1``
  header (payload size and rank, alpha, targets, so a peer replica can
  rebuild the :class:`~.lora.LoRAConfig` from the bytes alone), then
  every factor's raw bytes in one canonical order (layer-major, targets
  sorted, ``a`` before ``b``, in the model dtype; bf16 rides as its uint16
  bit pattern, as in :mod:`~..kvstore.transfer`).  Factors may be numpy
  arrays or the port's tensors.
* :func:`unpack_adapter` is the bitwise inverse (shapes from
  :func:`~.lora.factor_dims`, never from the wire), returning CPU
  tensors in the model dtype.
* :func:`split_pages` / :func:`join_pages` chop the stream into pages of
  :func:`page_payload_nbytes`, and :func:`payload_to_row_dict` /
  :func:`row_dict_to_payload` encode one page across the pool's per-field
  staging layout, so the KV tier machinery moves adapter bytes.  Float
  fields carry ONE payload byte an element in the low mantissa bits of a
  fixed-exponent normal number (never NaN, Inf or denormal), integer
  fields carry raw bytes at full width: a scatter, demote, spill, restore
  and gather round trip is bit-exact on every device.

Decode never reads pages: serving runs from the stacked factors
(:func:`~.lora.stack_adapters`), so paging an adapter in or out never
touches a chunk program.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import lora as _lora

#: Wire magic for a packed adapter stream (version 1).
MAGIC = b"AIKOLOR1"

_HEADER = struct.Struct("<8sIQIdI")   # magic, header bytes, payload
#                                     # bytes, rank, alpha, targets len


def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a model dtype given as torch or numpy."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    return torch.bfloat16 if name == "bfloat16" else getattr(torch, name)


def _factor_bytes(array, dtype) -> np.ndarray:
    """One factor as its canonical flat byte view, cast to the model
    dtype first (the stacked serving copy is what must round-trip).
    Numpy factors go through the bridge (bf16 arrays as their bit
    patterns), so no numpy bf16 type is needed here."""
    if not torch.is_tensor(array):
        from .bridge import tensor_from_numpy
        array = tensor_from_numpy(np.asarray(array))
    tensor = array.detach().to("cpu", _torch_dtype(dtype)).contiguous()
    if tensor.element_size() == 2:
        tensor = tensor.view(torch.int16)
    return tensor.numpy().view(np.uint8).reshape(-1)


def pack_adapter(config, lora_config, adapter) -> np.ndarray:
    """``{"layers": [...]}`` → one contiguous uint8 stream (header +
    every factor's bytes in canonical order)."""
    targets = ",".join(sorted(lora_config.targets)).encode("ascii")
    parts = []
    layers = adapter["layers"]
    if len(layers) != config.n_layers:
        raise ValueError(f"adapter has {len(layers)} layers, "
                         f"config.n_layers={config.n_layers}")
    for layer in layers:
        for target in sorted(lora_config.targets):
            parts.append(_factor_bytes(layer[target]["a"],
                                       config.dtype))
            parts.append(_factor_bytes(layer[target]["b"],
                                       config.dtype))
    payload = np.concatenate(parts) if parts else \
        np.empty(0, np.uint8)
    header_nbytes = _HEADER.size + len(targets)
    header = _HEADER.pack(MAGIC, header_nbytes, payload.nbytes,
                          int(lora_config.rank),
                          float(lora_config.alpha),
                          len(targets)) + targets
    return np.concatenate([np.frombuffer(header, np.uint8), payload])


def parse_header(data) -> Tuple[int, int, "_lora.LoRAConfig"]:
    """``(header_nbytes, payload_nbytes, LoRAConfig)`` from a packed
    stream (or any prefix of it spanning at least the header)."""
    raw = np.ascontiguousarray(np.asarray(data, np.uint8)).tobytes()
    if len(raw) < _HEADER.size:
        raise ValueError("adapter stream shorter than its header")
    magic, header_nbytes, payload_nbytes, rank, alpha, targets_len \
        = _HEADER.unpack_from(raw)
    if magic != MAGIC:
        raise ValueError(f"bad adapter stream magic {magic!r}")
    if len(raw) < header_nbytes:
        raise ValueError("adapter stream truncated inside header")
    targets = raw[_HEADER.size:_HEADER.size + targets_len] \
        .decode("ascii")
    lora_config = _lora.LoRAConfig(
        rank=int(rank), alpha=float(alpha),
        targets=tuple(targets.split(",")) if targets else ())
    return int(header_nbytes), int(payload_nbytes), lora_config


def unpack_adapter(config, data):
    """Packed stream → ``({"layers": [...]}, LoRAConfig)`` — the
    bitwise inverse of :func:`pack_adapter`, factors as CPU tensors in
    the model dtype (trailing page padding is ignored; the header says
    where the payload ends)."""
    stream = np.ascontiguousarray(np.asarray(data, np.uint8)) \
        .reshape(-1)
    header_nbytes, payload_nbytes, lora_config = parse_header(stream)
    if stream.nbytes < header_nbytes + payload_nbytes:
        raise ValueError("adapter stream truncated inside payload")
    # Copy: the variable-length header can leave the payload at an
    # odd byte offset, and numpy dtype views need alignment.
    payload = stream[header_nbytes:header_nbytes + payload_nbytes] \
        .copy()
    in_dims, out_dims = _lora.factor_dims(config)
    dtype = _torch_dtype(config.dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    layers, offset = [], 0
    for _ in range(config.n_layers):
        layer = {}
        for target in sorted(lora_config.targets):
            factors = {}
            for name, shape in (
                    ("a", (in_dims[target], lora_config.rank)),
                    ("b", (lora_config.rank, out_dims[target]))):
                nbytes = int(np.prod(shape)) * itemsize
                factors[name] = torch.from_numpy(
                    payload[offset:offset + nbytes].copy()).view(dtype) \
                    .reshape(shape)
                offset += nbytes
            layer[target] = factors
        layers.append(layer)
    if offset != payload_nbytes:
        raise ValueError(f"adapter payload is {payload_nbytes} bytes"
                         f", factors claim {offset}")
    return {"layers": layers}, lora_config


def page_count(nbytes: int, page_bytes: int) -> int:
    return -(-int(nbytes) // int(page_bytes)) if nbytes else 0


def split_pages(data, page_bytes: int) -> List[np.ndarray]:
    """Packed stream → fixed-size uint8 pages (last page padded with
    zeros to exactly ``page_bytes``)."""
    stream = np.ascontiguousarray(np.asarray(data, np.uint8)) \
        .reshape(-1)
    pages = []
    for start in range(0, stream.nbytes, int(page_bytes)):
        page = stream[start:start + int(page_bytes)]
        if page.nbytes < page_bytes:
            page = np.concatenate(
                [page, np.zeros(int(page_bytes) - page.nbytes,
                                np.uint8)])
        pages.append(page)
    return pages


def join_pages(pages: List[np.ndarray]) -> np.ndarray:
    return np.concatenate(
        [np.ascontiguousarray(np.asarray(p, np.uint8)).reshape(-1)
         for p in pages]) if pages else np.empty(0, np.uint8)


#: Fixed safe bit patterns per float itemsize: exponent of 2.0, all
#: payload bits riding in low mantissa — every ``BASE | byte`` value
#: is a distinct, exactly-representable NORMAL number, so neither
#: NaN canonicalization nor denormal flushing can touch it.
_SAFE_BASE = {2: np.uint16(0x4000), 4: np.uint32(0x40000000),
              8: np.uint64(0x4000000000000000)}
_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _field_info(dtype) -> Tuple[int, bool]:
    """``(itemsize, integer?)`` of a layout field's dtype: a numpy dtype,
    or its name (the port's layouts name bf16 ``"bfloat16"``, which plain
    numpy does not know)."""
    if str(dtype) == "bfloat16":
        return 2, False
    dtype = np.dtype(dtype)
    return dtype.itemsize, dtype.kind in "iu"


def _field_capacity(dtype) -> int:
    """Payload bytes one pool ELEMENT of ``dtype`` can carry safely:
    integers are value-transparent (full width); floats carry one
    byte in the mantissa of a fixed-exponent normal."""
    itemsize, integer = _field_info(dtype)
    return itemsize if integer else 1


def page_payload_nbytes(layout) -> int:
    """Payload bytes ONE pool block can carry under the safe
    encoding (``kvstore.transfer._field_layout`` tuples) — the page
    size every split/join below uses."""
    return sum((row_bytes // _field_info(dtype)[0])
               * _field_capacity(dtype)
               for _field, _shape, dtype, row_bytes in layout)


def payload_to_row_dict(chunk, layout) -> Dict[str, np.ndarray]:
    """One page's payload bytes encoded across the pool's staging
    field layout: each field gets a flat array whose uint8 view is
    exactly its ``row_bytes`` — raw bytes for integer fields, safe
    mantissa-encoded elements for float fields — ready for the fused
    scatter's bitcast."""
    flat = np.ascontiguousarray(np.asarray(chunk, np.uint8)) \
        .reshape(-1)
    total = page_payload_nbytes(layout)
    if flat.nbytes != total:
        raise ValueError(f"page payload is {flat.nbytes} bytes, "
                         f"pool block carries {total}")
    rows, offset = {}, 0
    for field, _shape, dtype, row_bytes in layout:
        itemsize, integer = _field_info(dtype)
        elems = row_bytes // itemsize
        take = elems * _field_capacity(dtype)
        span = flat[offset:offset + take]
        if integer:
            rows[field] = span
        else:
            unit = _UINT[itemsize]
            rows[field] = _SAFE_BASE[itemsize] | span.astype(unit)
        offset += take
    return rows


def row_dict_to_payload(rows, layout) -> np.ndarray:
    """Inverse of :func:`payload_to_row_dict` for rows read back
    from ANY tier — gathered native-dtype pool rows, a host-tier
    entry's row dict, and the spill store's wire rows all decode to
    the same payload bytes."""
    parts = []
    for field, _shape, dtype, row_bytes in layout:
        itemsize, integer = _field_info(dtype)
        flat = np.ascontiguousarray(np.asarray(rows[field])) \
            .view(np.uint8).reshape(-1)
        if flat.nbytes != row_bytes:
            raise ValueError(f"{field}: {flat.nbytes} bytes != "
                             f"{row_bytes}")
        if integer:
            parts.append(flat)
        else:
            unit = _UINT[itemsize]
            parts.append((flat.view(unit)
                          & unit(0xFF)).astype(np.uint8))
    return np.concatenate(parts) if parts else np.empty(0, np.uint8)
