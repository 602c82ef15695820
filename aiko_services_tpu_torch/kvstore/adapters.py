"""Name-derived chain keys for paged adapter storage.

The port's copy of ``aiko_services_tpu/kvstore/adapters.py`` (it has no
JAX in it).  The keys must stay byte-identical to the JAX package's: a
router matches a request's adapter against replicas' digests by
:func:`adapter_hex` alone.  The port's router uses that function for
adapter affinity, and the paged server keys its adapter pages with these
chains (:meth:`~..orchestration.paged.PagedContinuousServer.
store_adapter_bytes`).

Adapter pages ride the pool's existing chain-key machinery (index →
host → disk tiers, spill adoption, export/import), so every page
needs a key that behaves like a KV chain key: 32 raw bytes, rolled
from a parent so depth walks stay rooted.  Unlike KV keys they are
derived from the adapter NAME alone — no content, no tokens — so a
router, a replica that has never seen the weights, and the replica
that owns them all compute the SAME keys independently.  That is
what makes adapter residency advertisable in the prefix digest (the
8th wire field, kvstore/directory.py) and warm-anywhere routing
possible without shipping a manifest.

``ADAPTER_SEED`` is the ``_key_seed`` sentinel that marks a pool key
as an adapter WEIGHT page.  The seed space now reads:

* ``seed == 0`` — base-model KV: demotable, exportable, advertised.
* ``seed > 0`` — per-request adapter KV chains (the stacked-factor
  index): replica-local, purged on evict, never exported.
* ``seed == ADAPTER_SEED`` — adapter weight pages: demotable,
  exportable, advertised with the digest adapter flag.
"""

from __future__ import annotations

import hashlib
from typing import List

from .directory import HEX_KEY_CHARS

#: ``_key_seed`` sentinel for adapter weight pages.
ADAPTER_SEED = -1

_DOMAIN = b"aiko-adapter\x00"


def adapter_root(name: str) -> bytes:
    """Domain-separated root digest for ``name`` — the parent of the
    adapter's first page key (never itself a pool key, exactly like a
    KV chain's token-prefix root)."""
    return hashlib.sha256(_DOMAIN + name.encode("utf-8")).digest()


def adapter_chain_keys(name: str, n_pages: int) -> List[bytes]:
    """The first ``n_pages`` page keys of ``name``'s chain: a rolling
    SHA-256 seeded from :func:`adapter_root`, page index folded in —
    the same parent→child rolling shape as ``chain_keys`` so depth /
    rootedness invariants (auditor, spill adoption) hold verbatim."""
    state = adapter_root(name)
    keys = []
    for index in range(int(n_pages)):
        state = hashlib.sha256(
            state + index.to_bytes(4, "little")).digest()
        keys.append(state)
    return keys


def adapter_key_iter(name: str):
    """Infinite lazy walk of ``name``'s page keys — residency scans
    stop at the first key the pool does not know, so no caller needs
    the page count up front."""
    state = adapter_root(name)
    index = 0
    while True:
        state = hashlib.sha256(
            state + index.to_bytes(4, "little")).digest()
        yield state
        index += 1


def adapter_page_key(name: str, index: int) -> bytes:
    """Key of page ``index`` alone (fetch walks pages lazily — the
    page-1 header says how many exist)."""
    return adapter_chain_keys(name, index + 1)[index]


def adapter_hex(name: str) -> str:
    """Directory-width hex of the FIRST page key — the single token a
    digest advertises and a router matches to decide ``name`` is warm
    on a replica (holding page 1 ⇒ the header ⇒ the chain walk)."""
    return adapter_chain_keys(name, 1)[0].hex()[:HEX_KEY_CHARS]
