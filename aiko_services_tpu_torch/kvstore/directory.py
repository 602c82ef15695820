"""Cluster-wide prefix directory: digest wire format + merged view.

The port's copy of the JAX package's ``kvstore/directory.py`` (it has
no JAX in it).  The keys and the digest strings must stay byte-identical
to the JAX package's: the cluster-wide prefix directory and the KV
transfer wire match blocks across processes, and across the two
backends, by these alone (``tests/test_torch_kvstore.py`` compares
them).

The paged server's prefix cache is content-addressed by a rolling
chain hash (one SHA-256 per FULL prompt block, seeded with the adapter
id — vLLM's scheme; see
:meth:`~..orchestration.paged.PagedContinuousServer._chain_keys`).
That hashing is defined HERE so the router and every replica compute
byte-identical keys from tokens alone — a digest entry advertised by
one process must be matchable by any other.

Digest wire format (the value of the ``kv_prefixes`` EC-share key,
published on the replica's state topic):

    <block_size>;<role>;<entry>,<entry>,...
    entry = <hex16>/<depth>/<refs>/<hotness>[/<tier>[/<adopted>[/<migrating>]]]

``hex16`` is the first 8 bytes of the chain key (64 collision bits —
ample for directory routing; the replica re-verifies full keys at
export time).  ``depth`` is the entry's position in its chain (blocks
of whole-prefix history it represents); ``refs``/``hotness`` are
advisory load signals.  ``tier`` is where the block's bytes live —
0 = HBM (omitted on the wire: the pre-tier 4-field entry stays valid),
1 = host RAM (a hit needs a restore upload before decode can read it,
so the router prices it below an HBM hit but above a recompute),
2 = SSD spill (priced below a host hit, still above a recompute).
``adopted`` marks a tier-2 entry re-adopted from the spill directory
by a warm replica restart (0 omitted on the wire — the 5-field tier
format stays valid byte-for-byte, same back-compat move the ``tier``
field made on the 4-field format).  ``migrating`` marks the replica
as the SOURCE of an in-flight live migration: its cache is about to
move, so routers must stop scoring it for NEW prefix placement (the
blocks stay exportable — peers may still pull them).  A zero flag is
omitted, cascading like tier/adopted; when set, encode writes the
FULL entry (tier and adopted included even at 0 — the fields are
positional).  Decoders accept 4/5/6/7-field entries, so old routers
parse a migrating digest and simply ignore the flag.  The format is
S-expression-safe
by construction: hex, digits, ``;,/`` only — no spaces or parens.

Staleness is LEASE-based: each replica's advertisement expires
``lease_s`` after its last refresh (replicas re-advertise every pump
and on a slow periodic timer), so a wedged or partitioned replica's
prefixes silently drop out of routing instead of attracting traffic
to a cache that may no longer exist.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["chain_keys", "chain_keys_hex", "shareable_blocks",
           "digest_encode", "digest_decode", "PrefixDirectory",
           "HEX_KEY_CHARS"]

#: Advertised key width: 16 hex chars = 8 bytes of the SHA-256 chain
#: key.  Directory matching tolerates the (negligible) collision rate;
#: block EXPORT re-resolves through the owner's full-key index.
HEX_KEY_CHARS = 16


def chain_keys(prompt, block_size: int,
               adapter_id: int = 0) -> List[bytes]:
    """Chained content keys, one per FULL prompt block: a block's key
    is the SHA-256 of (parent key ‖ block tokens), so equal keys imply
    equal whole-prefix token histories at O(block) per key.  The chain
    is SEEDED with the adapter id: the same tokens prefilled under
    different LoRA adapters produce different KV, so cached blocks may
    only be shared within one adapter."""
    prompt = np.asarray(prompt)
    keys: List[bytes] = []
    parent = int(adapter_id).to_bytes(4, "little")
    for i in range(len(prompt) // block_size):
        block = np.ascontiguousarray(
            prompt[i * block_size:(i + 1) * block_size],
            dtype=np.int32)
        parent = hashlib.sha256(parent + block.tobytes()).digest()
        keys.append(parent)
    return keys


def chain_keys_hex(prompt, block_size: int,
                   adapter_id: int = 0) -> List[str]:
    """Directory-width hex keys for a prompt's SHAREABLE blocks (full
    blocks strictly before the last prompt position — see
    :func:`shareable_blocks`)."""
    n = shareable_blocks(len(np.asarray(prompt)), block_size)
    return [key.hex()[:HEX_KEY_CHARS]
            for key in chain_keys(prompt, block_size, adapter_id)[:n]]


def shareable_blocks(prompt_len: int, block_size: int) -> int:
    """Blocks safe to SHARE (and therefore to advertise/transfer):
    full blocks strictly before position ``prompt_len - 1`` — the
    admission seed rewrites the last prompt position's KV row, and a
    rewrite must never land in a block other requests read."""
    return max(0, (prompt_len - 1) // block_size)


# ----------------------------------------------------------------- #
# Digest wire format


def digest_encode(block_size: int, role: str,
                  entries: Sequence[Tuple],
                  migrating: int = 0) -> str:
    """``entries`` = [(hex16, depth, refs, hotness[, tier[, adopted[,
    migrating[, adapter]]]])] — already selected/ordered by the
    replica (hottest, deepest first).  A missing or zero tier (HBM)
    is omitted on the wire, so untiered replicas keep emitting the
    4-field format byte-for-byte; likewise a zero adopted flag keeps
    the 5-field tier format, a zero migrating flag the 6-field one,
    and a zero adapter flag the 7-field one.  A SET adapter flag
    (the entry is an adapter weight-page root, not a KV prefix)
    forces the full 8-field entry (fields are positional —
    tier/adopted/migrating are written even at 0).  The ``migrating``
    kwarg ORs into every entry: the flag is a property of the
    advertising replica, so the publisher passes it once instead of
    rewriting its entry tuples."""
    parts = []
    migrating = int(bool(migrating))
    for entry in entries:
        hex_key, depth, refs, hot = entry[:4]
        tier = entry[4] if len(entry) > 4 else 0
        adopted = entry[5] if len(entry) > 5 else 0
        moving = migrating or (entry[6] if len(entry) > 6 else 0)
        adapter = entry[7] if len(entry) > 7 else 0
        item = f"{hex_key}/{depth}/{refs}/{hot}"
        if tier or adopted or moving or adapter:
            item += f"/{int(tier)}"
        if adopted or moving or adapter:
            item += f"/{int(adopted)}"
        if moving or adapter:
            item += f"/{int(moving)}"
        if adapter:
            item += f"/{int(adapter)}"
        parts.append(item)
    return f"{block_size};{role};{','.join(parts)}"


def digest_decode(text: str):
    """Returns ``(block_size, role, entries)`` with 8-tuple entries
    ``(hex16, depth, refs, hotness, tier, adopted, migrating,
    adapter)`` — tier/adopted/migrating/adapter default to 0 for the
    shorter (pre-tier, pre-spill, pre-migration, pre-multitenant)
    formats — or ``None`` on any malformed input (directory updates
    are best-effort: a corrupt advertisement is dropped, never raises
    into the router)."""
    try:
        block_text, role, body = str(text).split(";", 2)
        block_size = int(block_text)
        entries = []
        if body:
            for item in body.split(","):
                fields = item.split("/")
                if len(fields) not in (4, 5, 6, 7, 8):
                    return None
                tier = int(fields[4]) if len(fields) > 4 else 0
                adopted = int(fields[5]) if len(fields) > 5 else 0
                migrating = int(fields[6]) if len(fields) > 6 else 0
                adapter = int(fields[7]) if len(fields) > 7 else 0
                entries.append((fields[0], int(fields[1]),
                                int(fields[2]), int(fields[3]),
                                tier, adopted, migrating, adapter))
        return block_size, role, entries
    except (TypeError, ValueError):
        return None


# ----------------------------------------------------------------- #


class PrefixDirectory:
    """Router-side merged view of every replica's advertised prefix
    blocks, with lease-based staleness eviction.

    One advertisement per replica at a time: each ``update`` REPLACES
    that replica's entry set and refreshes its lease.  Lookups skip
    expired advertisements lazily; :meth:`purge_expired` reclaims them
    (the router calls it opportunistically on update)."""

    def __init__(self, lease_s: float = 30.0):
        self.lease_s = lease_s
        #: replica -> {hex16 -> (depth, refs, hotness, tier, adopted,
        #: adapter)}
        self._by_replica: Dict[str, Dict[
            str, Tuple[int, int, int, int, int, int]]] = {}
        self._expiry: Dict[str, float] = {}
        self._block_size: Dict[str, int] = {}
        self._role: Dict[str, str] = {}
        # Replica-level migrating flag (any advertised entry carries
        # it): the source of an in-flight live migration keeps its
        # blocks exportable but must stop attracting NEW placements.
        self._migrating: Dict[str, bool] = {}

    # -- ingest ---------------------------------------------------- #

    def update(self, replica: str, digest_text: str,
               now: float) -> bool:
        """Ingest one ``kv_prefixes`` advertisement; returns True when
        it parsed (and the lease was refreshed)."""
        decoded = digest_decode(digest_text)
        if decoded is None:
            return False
        block_size, role, entries = decoded
        self._by_replica[replica] = {
            hex_key: (depth, refs, hot, tier, adopted, adapter)
            for hex_key, depth, refs, hot, tier, adopted, _migr,
            adapter in entries}
        self._migrating[replica] = any(
            entry[6] for entry in entries)
        self._block_size[replica] = block_size
        self._role[replica] = role
        self._expiry[replica] = now + self.lease_s
        return True

    def evict_replica(self, replica: str) -> None:
        self._by_replica.pop(replica, None)
        self._expiry.pop(replica, None)
        self._block_size.pop(replica, None)
        self._role.pop(replica, None)
        self._migrating.pop(replica, None)

    def purge_expired(self, now: float) -> None:
        for replica in [r for r, t in self._expiry.items()
                        if now >= t]:
            self.evict_replica(replica)

    # -- queries --------------------------------------------------- #

    def alive(self, replica: str, now: float) -> bool:
        return now < self._expiry.get(replica, float("-inf"))

    def block_size(self, replica: str) -> Optional[int]:
        return self._block_size.get(replica)

    def role(self, replica: str) -> Optional[str]:
        return self._role.get(replica)

    def migrating(self, replica: str) -> bool:
        """True while the replica's last advertisement carried the
        migrating flag: its cache is mid-flight, so prefix-affinity
        scoring for NEW placements should skip it (the router still
        routes the requests it already holds)."""
        return self._migrating.get(replica, False)

    def replicas(self) -> List[str]:
        return list(self._by_replica)

    def matched_blocks(self, replica: str, keys_hex: Sequence[str],
                       now: float) -> int:
        """Longest advertised prefix of ``keys_hex`` this replica
        holds: chain keys encode whole-prefix history and eviction is
        leaf-first, so the DEEPEST matching key alone implies every
        ancestor is cached — walk deepest-first, first hit wins."""
        if not self.alive(replica, now):
            return 0
        advertised = self._by_replica.get(replica)
        if not advertised:
            return 0
        for depth in range(len(keys_hex), 0, -1):
            if keys_hex[depth - 1] in advertised:
                return depth
        return 0

    def matched_detail(self, replica: str, keys_hex: Sequence[str],
                       now: float) -> Tuple[int, int]:
        """``(depth, host_blocks)``: the :meth:`matched_blocks` depth
        plus how many of the matched keys this replica advertises in
        the HOST tier (restore-priced).  Matched ancestors the digest
        cap dropped are assumed HBM — eviction is leaf-first, so a
        chain demotes from its leaves and an unadvertised ancestor of
        an HBM entry cannot sit in a colder tier than its child."""
        depth, host, _disk = self.matched_tiers(replica, keys_hex, now)
        return depth, host

    def matched_tiers(self, replica: str, keys_hex: Sequence[str],
                      now: float) -> Tuple[int, int, int]:
        """``(depth, host_blocks, disk_blocks)``: the matched depth
        split by where the bytes live, so the router can price each
        rung of the tower separately (HBM > host restore > disk
        restore > recompute)."""
        depth = self.matched_blocks(replica, keys_hex, now)
        if not depth:
            return 0, 0, 0
        advertised = self._by_replica.get(replica, {})
        host = disk = 0
        for key in keys_hex[:depth]:
            tier = advertised.get(key, (0, 0, 0, 0, 0))[3]
            if tier == 1:
                host += 1
            elif tier == 2:
                disk += 1
        return depth, host, disk

    def adapter_tier(self, replica: str, adapter_hex: str,
                     now: float) -> Optional[int]:
        """Tier at which ``replica`` advertises the adapter whose
        root-page hex is ``adapter_hex`` (0=HBM, 1=host, 2=disk), or
        None when it is not advertised warm there.  Adapter locality
        is scored exactly like prefix locality — the digest entry is
        just flagged so a KV prefix never masquerades as an
        adapter."""
        if not self.alive(replica, now):
            return None
        entry = self._by_replica.get(replica, {}).get(adapter_hex)
        if entry is None or len(entry) < 6 or not entry[5]:
            return None
        return int(entry[3])

    def adapter_owners(self, adapter_hex: str, now: float,
                       exclude=()) -> List[Tuple[str, int]]:
        """Every unexpired replica advertising the adapter warm, as
        ``(replica, tier)`` sorted warmest tier first (replica order
        breaks ties for determinism)."""
        owners = []
        for replica in sorted(self._by_replica):
            if replica in exclude:
                continue
            tier = self.adapter_tier(replica, adapter_hex, now)
            if tier is not None:
                owners.append((replica, tier))
        owners.sort(key=lambda pair: (pair[1], pair[0]))
        return owners

    def best_owner(self, keys_hex: Sequence[str], now: float,
                   exclude=()) -> Tuple[Optional[str], int]:
        """The unexpired replica holding the longest match (ties break
        by hotness of the matched entry, then replica order for
        determinism)."""
        best: Tuple[int, int, str] = (0, 0, "")
        owner = None
        for replica in sorted(self._by_replica):
            if replica in exclude:
                continue
            depth = self.matched_blocks(replica, keys_hex, now)
            if not depth:
                continue
            hot = self._by_replica[replica].get(
                keys_hex[depth - 1], (0, 0, 0, 0, 0))[2]
            # sorted() order makes the final tie deterministic.
            if (depth, hot) > best[:2]:
                best = (depth, hot, replica)
                owner = replica
        return owner, best[0]

    @property
    def size(self) -> int:
        """Total advertised keys (expired advertisements included
        until purged — the share counter the dashboard shows)."""
        return sum(len(entries)
                   for entries in self._by_replica.values())
