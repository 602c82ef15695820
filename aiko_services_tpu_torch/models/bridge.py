"""Weight bridge: the JAX package's parameter (or KV cache) tree, given as
numpy arrays, into the port's tensors.

The layouts are kept as they are: weights ``(in, out)``, int8 leaves
``{"q": int8 (in, out), "s": f32 (1, out)}``, KV ``(batch, max_seq,
kv_heads, head_dim)`` and int8 KV scales ``(batch, max_seq, kv_heads)``
f32.  bfloat16 arrays (numpy's ``ml_dtypes.bfloat16``, what ``np.asarray``
of a JAX bf16 array gives) travel as their raw 16-bit patterns, so the
port's tensors are bit-identical to the JAX leaves.  Nothing here imports
JAX: callers convert their arrays with ``np.asarray`` first.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["params_from_numpy", "tensor_from_numpy", "tensor_to_numpy"]


def tensor_from_numpy(array, device="cpu") -> torch.Tensor:
    """A tensor on ``device`` holding a copy of ``array`` (JAX hands out
    read-only buffers; the port writes its caches in place)."""
    array = np.array(array, copy=True, order="C")
    if array.dtype.name == "bfloat16":
        tensor = torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
    else:
        tensor = torch.from_numpy(array)
    return tensor.to(device)


def tensor_to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """The port's tensor as numpy; bfloat16 widens to float32 (exact)."""
    tensor = tensor.detach().cpu()
    if tensor.dtype == torch.bfloat16:
        tensor = tensor.to(torch.float32)
    return tensor.numpy()


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Map every array leaf of ``tree`` (nested dicts/lists/tuples) to a
    tensor on ``device``; structure and layouts are unchanged."""
    if isinstance(tree, dict):
        return {key: params_from_numpy(value, device)
                for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(value, device)
                          for value in tree)
    return tensor_from_numpy(tree, device)
