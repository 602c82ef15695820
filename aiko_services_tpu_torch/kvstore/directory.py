"""Content keys of the paged server's prefix cache.

The port's copy of what the paged server needs from the JAX package's
``kvstore/directory.py``: the rolling chain hash (one SHA-256 per FULL
prompt block, seeded with the adapter id, vLLM's scheme) and the
shareable-block bound.  The keys must stay byte-identical to the JAX
package's: the cluster-wide prefix directory and the KV transfer wire
match blocks across processes, and across the two backends, by these
keys alone (``tests/test_torch_paged.py`` compares them).
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np

__all__ = ["chain_keys", "chain_keys_hex", "shareable_blocks",
           "HEX_KEY_CHARS"]

#: Advertised key width: 16 hex chars = 8 bytes of the SHA-256 chain key.
HEX_KEY_CHARS = 16


def chain_keys(prompt, block_size: int,
               adapter_id: int = 0) -> List[bytes]:
    """Chained content keys, one per FULL prompt block: a block's key is
    the SHA-256 of (parent key ‖ block tokens as little-endian int32), so
    equal keys imply equal whole-prefix token histories.  The chain is
    seeded with the adapter id (4 bytes, little-endian)."""
    prompt = np.asarray(prompt)
    keys: List[bytes] = []
    parent = int(adapter_id).to_bytes(4, "little")
    for i in range(len(prompt) // block_size):
        block = np.ascontiguousarray(
            prompt[i * block_size:(i + 1) * block_size], dtype=np.int32)
        parent = hashlib.sha256(parent + block.tobytes()).digest()
        keys.append(parent)
    return keys


def chain_keys_hex(prompt, block_size: int,
                   adapter_id: int = 0) -> List[str]:
    """Directory-width hex keys for a prompt's SHAREABLE blocks."""
    n = shareable_blocks(len(np.asarray(prompt)), block_size)
    return [key.hex()[:HEX_KEY_CHARS]
            for key in chain_keys(prompt, block_size, adapter_id)[:n]]


def shareable_blocks(prompt_len: int, block_size: int) -> int:
    """Blocks safe to SHARE: full blocks strictly before position
    ``prompt_len - 1``.  Admission seeds decode with the last prompt
    token, whose first step rewrites that position's KV row; a rewrite
    must never land in a block other requests read."""
    return max(0, (prompt_len - 1) // block_size)
