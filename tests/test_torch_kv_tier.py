"""Port parity: the paged server's KV tiers — the host-RAM demotion tier
with its asynchronous restore, and the SSD spill tier with its warm
restart — against the JAX package's, on the CPU.

* Exactness: greedy decode after a host restore, after a disk restore,
  after a spill adoption and after an import equals local prefill
  bitwise, port against port, bf16 and int8 KV (tests/test_kv_tier.py:63,
  tests/test_kv_spill.py:79-124, tests/test_kvstore.py:283); on an f32
  ``tiny`` with the JAX package's weights the tokens also equal the JAX
  server's after its own prefill, and the tier counters equal the JAX
  server's for the same scenario.
* Tier behaviour (tests/test_kv_tier.py:87-262): chain identity survives
  demotion, active slots produce while a multi-block restore lands, the
  ``RESTORING`` sentinel, a restore under pool pressure, exports served
  from the host tier and spliced across tiers, the digest's tiers.
* Spill faults (tests/test_kv_spill.py:201-386): a bit flip, a torn
  write, a foreign version, a foreign pool signature, a rootless chain,
  and the ``corrupt_disk_block``, ``disk_full`` and ``slow_disk`` fault
  points; a spilled source spliced into an export; ``prefetch_promote``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.kvstore import directory as jax_directory
from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.orchestration import continuous as jax_continuous
from aiko_services_tpu.orchestration import paged as jax_paged
from aiko_services_tpu_torch.kvstore import directory, spill, transfer
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.models.bridge import params_from_numpy
from aiko_services_tpu_torch.orchestration.continuous import DecodeRequest
from aiko_services_tpu_torch.orchestration.paged import (
    RESTORING, PagedContinuousServer)
from aiko_services_tpu_torch.pipeline import codec
from aiko_services_tpu_torch.runtime import faults

CONFIG = "tiny_f32"
BOTH_DTYPES = pytest.mark.parametrize("quantize_kv", [False, True],
                                      ids=["bf16", "int8"])
PROMPT = np.arange(1, 50, dtype=np.int32)           # 3 shareable blocks


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_cold():
    """Later test modules in the same worker count their own JAX
    compiles; drop what this module compiled once it is done."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _f32_tiny(monkeypatch):
    monkeypatch.setitem(
        jax_llama.CONFIGS, CONFIG,
        dataclasses.replace(jax_llama.CONFIGS["tiny"], dtype=jnp.float32))
    monkeypatch.setitem(
        llama.CONFIGS, CONFIG,
        dataclasses.replace(llama.CONFIGS["tiny"], dtype=torch.float32))


@pytest.fixture(autouse=True)
def _no_port_faults():
    yield
    faults.uninstall()


SERVER = dict(slots=2, max_seq=96, chunk_steps=4, block_size=16,
              enable_prefix_cache=True)


def make_server(config="tiny", **kwargs):
    return PagedContinuousServer(config_name=config, device="cpu",
                                 **dict(SERVER, seed=0, **kwargs))


def spill_server(tmp_path, **kwargs):
    """A server whose evictions land straight on disk: host tier off,
    spill tier on ``tmp_path/spill``."""
    return make_server(**dict(dict(host_tier_blocks=0,
                                   spill_dir=str(tmp_path / "spill")),
                              **kwargs))


def warm(server, prompt, max_new=4, request_cls=DecodeRequest):
    server.submit(request_cls(request_id="warm", prompt=prompt,
                              max_new_tokens=max_new))
    return server.run_until_drained()[0].tokens


def demote_all(server):
    before = server.kv_demotions
    while server._evict_one():
        pass
    return server.kv_demotions - before


def spill_all(server):
    before = server.kv_spills
    while server._evict_one():
        pass
    return server.kv_spills - before


def files(tmp_path):
    root = tmp_path / "spill"
    return sorted(p for p in root.iterdir()
                  if p.name.endswith(spill.SUFFIX)) if root.exists() else []


# --------------------------------------------------------------------------- #
# Exactness: restored, spilled, adopted and imported chains decode as the
# never-evicted chain


@BOTH_DTYPES
def test_restored_chain_greedy_bit_exact(quantize_kv):
    server = make_server(quantize_kv=quantize_kv, host_tier_blocks=16)
    want = warm(server, PROMPT)
    assert demote_all(server) == 3
    stats = server.stats()
    assert stats["kv_host_blocks"] == 3 and stats["kv_host_bytes"] > 0
    assert stats["prefix_evictions"] == 0
    assert stats["kv_host_bytes"] == 3 * server._block_nbytes()
    got = warm(server, PROMPT)
    stats = server.stats()
    assert got == want == warm(make_server(quantize_kv=quantize_kv), PROMPT)
    assert stats["kv_restores"] == 3 and stats["prefix_hits_host"] == 1
    assert stats["kv_host_blocks"] == 0 and stats["restore_queue_depth"] == 0


@BOTH_DTYPES
def test_spilled_chain_greedy_bit_exact(tmp_path, quantize_kv):
    server = spill_server(tmp_path, quantize_kv=quantize_kv)
    want = warm(server, PROMPT)
    assert spill_all(server) == 3
    stats = server.stats()
    assert stats["kv_disk_blocks"] == 3 and stats["kv_disk_bytes"] > 0
    assert stats["prefix_evictions"] == 0 and len(files(tmp_path)) == 3
    got = warm(server, PROMPT)
    stats = server.stats()
    assert got == want == warm(make_server(quantize_kv=quantize_kv), PROMPT)
    assert stats["kv_disk_restores"] == 3
    assert stats["kv_checksum_failures"] == 0
    assert stats["kv_disk_blocks"] == 0 and not files(tmp_path)


@BOTH_DTYPES
def test_warm_restart_adopts_and_serves_bit_exact(tmp_path, quantize_kv):
    first = spill_server(tmp_path, quantize_kv=quantize_kv)
    want = warm(first, PROMPT)
    assert spill_all(first) == 3
    del first
    second = spill_server(tmp_path, quantize_kv=quantize_kv)
    stats = second.stats()
    assert stats["kv_adopted_chains"] == 1 and stats["kv_disk_blocks"] == 3
    entries = directory.digest_decode(second.prefix_digest())[2]
    assert {entry[4] for entry in entries} == {2}
    assert {entry[5] for entry in entries} == {1}
    assert warm(second, PROMPT) == want
    assert second.stats()["kv_disk_restores"] == 3


def _jax_pair(**kwargs):
    reference = jax_paged.PagedContinuousServer(
        config_name=CONFIG, **dict(SERVER, seed=0, **kwargs))
    params = params_from_numpy(jax.tree.map(np.asarray, reference.params),
                               "cpu")
    return reference, make_server(CONFIG, params=params, **kwargs)


TIER_COUNTERS = ("kv_demotions", "kv_restores", "prefix_hits_host",
                 "kv_host_blocks", "kv_host_bytes", "kv_spills",
                 "kv_disk_blocks", "kv_disk_bytes", "kv_disk_restores",
                 "kv_adopted_chains", "kv_checksum_failures",
                 "prefix_evictions", "prefix_hits", "prefix_blocks_reused",
                 "restore_queue_depth", "free_blocks")


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_tier_round_trip_matches_the_jax_server(tmp_path, tier):
    """f32 ``tiny`` on the JAX server's weights: demote (and spill) every
    cached block and serve the prompt again: tokens, tier counters and
    digests equal the JAX server's."""
    kwargs = (dict(host_tier_blocks=16) if tier == "host"
              else dict(host_tier_blocks=0))
    runs = {}
    for side in ("jax", "torch"):
        root = tmp_path / side
        reference, server = _jax_pair(
            **kwargs, **({} if tier == "host" else
                         dict(spill_dir=str(root))))
        target = reference if side == "jax" else server
        request_cls = (jax_continuous.DecodeRequest if side == "jax"
                       else DecodeRequest)
        first = warm(target, PROMPT, 6, request_cls)
        while target._evict_one():
            pass
        evicted = {key: target.stats()[key] for key in TIER_COUNTERS}
        digest = target.prefix_digest()
        second = warm(target, PROMPT, 6, request_cls)
        runs[side] = (first, second, evicted,
                      {key: target.stats()[key] for key in TIER_COUNTERS},
                      digest)
    assert runs["torch"] == runs["jax"]
    first, second, evicted, after, digest = runs["torch"]
    assert first == second
    tiers = {entry[4] for entry in directory.digest_decode(digest)[2]}
    assert tiers == ({1} if tier == "host" else {2})
    assert after["kv_restores" if tier == "host" else "kv_disk_restores"] \
        == 3


def test_imported_prefix_matches_the_jax_servers_local_prefill():
    reference, owner = _jax_pair()
    want = warm(reference, PROMPT, 6, jax_continuous.DecodeRequest)
    assert warm(owner, PROMPT, 6) == want
    importer = make_server(CONFIG, params=owner.params)
    payload = owner.kv_export_payload(owner.prefix_keys_hex(PROMPT), 0)
    assert importer.kv_import_payload(
        codec.decode_swag(codec.encode_swag(payload))) == 3
    assert warm(importer, PROMPT, 6) == want
    assert importer.stats()["prefix_remote_hits"] == 1


@BOTH_DTYPES
def test_transferred_prefix_decode_bit_exact(quantize_kv):
    owner = make_server(quantize_kv=quantize_kv)
    want = warm(owner, PROMPT)
    payload = owner.kv_export_payload(owner.prefix_keys_hex(PROMPT), 0)
    importer = make_server(quantize_kv=quantize_kv)
    assert importer.kv_import_payload(
        codec.decode_swag(codec.encode_swag(payload))) == 3
    assert warm(importer, PROMPT) == want
    assert importer.stats()["prefix_remote_hits"] == 1
    assert importer.stats()["prefix_blocks_reused"] >= 3


# --------------------------------------------------------------------------- #
# Tier behaviour


def test_demote_restore_preserves_chain_identity():
    server = make_server(host_tier_blocks=16)
    warm(server, PROMPT)
    keys = list(server._index)
    depths = {key: server._depth[key] for key in keys}
    parents = {key: server._parent.get(key) for key in keys}
    demote_all(server)
    for key in keys:
        assert key in server._host and key not in server._index
        assert server._depth[key] == depths[key]
        assert server._parent.get(key) == parents[key]
    warm(server, PROMPT)
    for key in keys:
        assert key in server._index and key not in server._host
    # Host overflow is the true eviction: identity goes with it.
    tiny = make_server(host_tier_blocks=1)
    warm(tiny, PROMPT)
    demote_all(tiny)
    assert tiny.stats()["kv_host_blocks"] == 1
    assert tiny.stats()["prefix_evictions"] == 2


@BOTH_DTYPES
def test_host_tier_rows_live_in_the_tiers_arena(quantize_kv):
    """One demotion batch of three blocks into a two-block tier: each
    block's rows are copied out of the staging into an arena row of the
    tier's own, the block that finds every row taken gets memory of its
    own, and the overflow's purge, then the restore, give the rows
    back."""
    server = make_server(quantize_kv=quantize_kv, host_tier_blocks=2)
    want = warm(server, PROMPT)
    keys = list(server._index)                  # depth 1, 2, 3
    before = transfer.gather_block_rows(server,
                                        [server._index[k] for k in keys])
    server._evict_until(len(server._free) + len(keys))
    assert (server.kv_demotions, server.prefix_evictions) == (3, 1)
    assert keys[2] not in server._host and server._host_free == [1]
    arena = server._host_arena
    for depth, slot in ((1, None), (2, 0)):
        entry = server._host[keys[depth - 1]]
        assert entry["slot"] == slot
        for field, rows in entry["rows"].items():
            assert np.shares_memory(rows, arena) == (slot is not None)
            if slot is not None:
                assert np.shares_memory(rows, arena[slot])
            assert rows.tobytes() == before[field][depth - 1].tobytes()
    assert warm(server, PROMPT) == want
    assert not server._host and sorted(server._host_free) == [0, 1]


def test_restore_in_flight_keeps_its_arena_rows():
    """A chain's restore lands a block a step; demotions meanwhile must
    not take the arena rows its queued blocks still read."""
    server = make_server(host_tier_blocks=3, restore_blocks_per_step=1,
                         total_blocks=12)
    warm(server, PROMPT)
    chain = list(server._index)
    want = transfer.gather_block_rows(server,
                                      [server._index[k] for k in chain])
    server._evict_until(len(server._free) + len(chain))
    assert not server._host_free
    warm(server, np.arange(200, 249, dtype=np.int32))
    assert server._begin_restore(chain, [])
    server._advance_restores()
    others = [k for k in server._evictable if k not in chain]
    server._evict_until(len(server._free) + len(others))
    assert all(k in server._host for k in others)
    while server._restoring:
        server._advance_restores()
    got = transfer.gather_block_rows(server,
                                     [server._index[k] for k in chain])
    for field, value in want.items():
        assert got[field].tobytes() == value.tobytes(), field


@BOTH_DTYPES
def test_export_serves_host_tier_without_promotion(quantize_kv):
    owner = make_server(quantize_kv=quantize_kv, host_tier_blocks=16)
    want = warm(owner, PROMPT)
    assert demote_all(owner) == 3
    payload = owner.kv_export_payload(owner.prefix_keys_hex(PROMPT), 0)
    assert payload is not None and len(payload["kv_keys"]) == 3
    assert owner.stats()["kv_host_blocks"] == 3
    assert owner.stats()["kv_restores"] == 0
    importer = make_server(quantize_kv=quantize_kv)
    assert importer.kv_import_payload(
        codec.decode_swag(codec.encode_swag(payload))) == 3
    assert warm(importer, PROMPT) == want


def test_export_splices_mixed_hbm_and_host_sources():
    owner = make_server(host_tier_blocks=16)
    want = warm(owner, PROMPT)
    assert owner._evict_one()                       # the deepest leaf only
    assert owner.stats()["kv_host_blocks"] == 1
    payload = owner.kv_export_payload(owner.prefix_keys_hex(PROMPT), 0)
    assert payload is not None and len(payload["kv_keys"]) == 3
    importer = make_server()
    assert importer.kv_import_payload(payload) == 3
    assert warm(importer, PROMPT) == want


def test_active_slots_produce_during_multiblock_restore():
    server = make_server(host_tier_blocks=16, restore_blocks_per_step=1,
                         total_blocks=24)
    prompt = np.arange(1, 66, dtype=np.int32)       # 4 shareable blocks
    want = warm(server, prompt)
    assert demote_all(server) == 4
    active = DecodeRequest(request_id="active",
                           prompt=np.arange(200, 220, dtype=np.int32),
                           max_new_tokens=16)
    server.submit(active)
    for _ in range(8):
        server.step()
        if active.tokens:
            break
    assert active.tokens
    restored = DecodeRequest(request_id="restored", prompt=prompt,
                             max_new_tokens=4)
    server.submit(restored)
    produced_during_restore = False
    for _ in range(40):
        depth_before = server.stats()["restore_queue_depth"]
        emitted_before = len(active.tokens)
        server.step()
        if depth_before > 0 and len(active.tokens) > emitted_before:
            produced_during_restore = True
        if not server.busy:
            break
    assert produced_during_restore
    assert restored.tokens == want
    assert server.stats()["kv_restores"] == 4
    assert server.stats()["prefix_hits_host"] == 1


def test_restore_sentinel_never_collides_with_slot_owner():
    assert RESTORING == jax_paged.RESTORING == -1
    server = make_server(host_tier_blocks=16)
    assert all(slot >= 0 for slot in range(server.slots))
    warm(server, PROMPT)
    demote_all(server)
    server.submit(DecodeRequest("again", PROMPT, 4))
    server.step()              # the walk starts the restore and defers
    restoring = [block for block, owner in server._producing.items()
                 if owner == RESTORING]
    assert len(restoring) == 3
    assert all(server._producing[block] == RESTORING for block in restoring)
    server.run_until_drained()
    assert not server._producing


def test_restore_under_pool_pressure_converges():
    server = make_server(total_blocks=7, host_tier_blocks=16)
    want = warm(server, PROMPT)
    demote_all(server)
    server.submit(DecodeRequest("filler", np.arange(100, 140,
                                                    dtype=np.int32), 24))
    server.submit(DecodeRequest("again", PROMPT, 4))
    tokens = {r.request_id: r.tokens for r in server.run_until_drained()}
    assert tokens["again"] == want
    assert server.stats()["restore_queue_depth"] == 0


def test_import_evicts_or_demotes_under_pressure():
    owner = make_server()
    warm(owner, PROMPT)
    payload = owner.kv_export_payload(owner.prefix_keys_hex(PROMPT), 0)
    small = make_server(total_blocks=5)
    warm(small, np.arange(100, 149, dtype=np.int32))
    assert len(small._evictable) > 0
    assert small.kv_import_payload(dict(payload)) == 3
    assert small.stats()["prefix_evictions"] > 0
    assert small.stats()["kv_demotions"] == 0
    tiered = make_server(total_blocks=5, host_tier_blocks=8)
    warm(tiered, np.arange(100, 149, dtype=np.int32))
    assert tiered.kv_import_payload(dict(payload)) == 3
    stats = tiered.stats()
    assert stats["kv_demotions"] > 0
    assert stats["kv_host_blocks"] > 0 and stats["kv_host_bytes"] > 0


def test_digest_advertises_tiers():
    server = make_server(host_tier_blocks=16)
    warm(server, PROMPT)
    tiers = {e[4] for e in directory.digest_decode(server.prefix_digest())[2]}
    assert tiers == {0}
    assert server._evict_one()
    entries = directory.digest_decode(server.prefix_digest())[2]
    assert {entry[4] for entry in entries} == {0, 1}
    assert sum(1 for entry in entries if entry[4] == 1) == 1
    assert jax_directory.digest_decode(server.prefix_digest())[2] == entries


def test_tier_arguments_are_taken():
    server = make_server(host_tier_blocks=4, restore_blocks_per_step=0,
                         spill_blocks=9)
    assert (server.host_tier_blocks, server.restore_blocks_per_step,
            server.spill_blocks, server.spill) == (4, 1, 9, None)
    assert server._tier_enabled()
    assert not make_server()._tier_enabled()


# --------------------------------------------------------------------------- #
# The spill tier: identity, restarts and faults


def test_adoption_preserves_chain_identity_and_clock(tmp_path):
    first = spill_server(tmp_path)
    warm(first, PROMPT)
    depths, parents = dict(first._depth), dict(first._parent)
    spill_all(first)
    clock = first._evict_clock
    assert clock >= 3
    second = spill_server(tmp_path)
    for key, depth in depths.items():
        assert second._depth[key] == depth
        if key in parents:
            assert second._parent.get(key) == parents[key]
    assert second._evict_clock >= clock


def test_adoption_is_rerunnable_after_interrupted_start(tmp_path):
    first = spill_server(tmp_path)
    want = warm(first, PROMPT)
    assert spill_all(first) == 3
    del first
    interrupted = spill_server(tmp_path)
    assert interrupted.stats()["kv_adopted_chains"] == 1
    del interrupted
    assert len(files(tmp_path)) == 3
    third = spill_server(tmp_path)
    assert third.stats()["kv_adopted_chains"] == 1
    assert warm(third, PROMPT) == want


def test_bit_flip_degrades_to_recompute_and_counts(tmp_path):
    server = spill_server(tmp_path)
    want = warm(server, PROMPT)
    assert spill_all(server) == 3
    victim = files(tmp_path)[0]
    blob = victim.read_bytes()
    victim.write_bytes(blob[:-1] + bytes([blob[-1] ^ 0xFF]))
    assert warm(server, PROMPT) == want
    assert server.stats()["kv_checksum_failures"] >= 1
    assert not victim.exists()


def test_torn_write_skipped_at_adoption(tmp_path):
    first = spill_server(tmp_path)
    want = warm(first, PROMPT)
    assert spill_all(first) == 3
    del first
    victim = files(tmp_path)[-1]
    victim.write_bytes(victim.read_bytes()[:40])
    second = spill_server(tmp_path)
    stats = second.stats()
    assert stats["kv_checksum_failures"] == 1
    assert stats["kv_disk_blocks"] in (0, 1, 2)
    assert not victim.exists()
    assert warm(second, PROMPT) == want


def test_foreign_version_skipped_never_deleted(tmp_path):
    first = spill_server(tmp_path)
    warm(first, PROMPT)
    assert spill_all(first) == 3
    del first
    alien = files(tmp_path)[0]
    blob = bytearray(alien.read_bytes())
    blob[7] ^= 0x7F
    alien.write_bytes(bytes(blob))
    second = spill_server(tmp_path)
    assert second.stats()["kv_checksum_failures"] == 0
    assert alien.exists()


def test_foreign_pool_signature_not_adopted(tmp_path):
    first = spill_server(tmp_path, quantize_kv=False)
    warm(first, PROMPT)
    assert spill_all(first) == 3
    del first
    other = spill_server(tmp_path, quantize_kv=True)
    stats = other.stats()
    assert stats["kv_adopted_chains"] == 0
    assert stats["kv_checksum_failures"] == 0
    assert len(files(tmp_path)) == 3


def test_rootless_chain_discarded_at_adoption(tmp_path):
    first = spill_server(tmp_path)
    warm(first, PROMPT)
    assert spill_all(first) == 3
    metas, _ = first.spill.scan()
    del first
    by_depth = {}
    for name in os.listdir(tmp_path / "spill"):
        meta = next(m for m in metas if m["key"] == name[:-len(spill.SUFFIX)])
        by_depth[meta["depth"]] = name
    os.unlink(tmp_path / "spill" / by_depth[1])
    second = spill_server(tmp_path)
    stats = second.stats()
    assert stats["kv_adopted_chains"] == 0 and stats["kv_disk_blocks"] == 0
    assert not files(tmp_path)


def test_corrupt_disk_block_fault_never_wrong_tokens(tmp_path):
    server = spill_server(tmp_path)
    want = warm(server, PROMPT)
    faults.install(faults.FaultPlan(seed=0).add("corrupt_disk_block", nth=1))
    try:
        assert spill_all(server) == 3
        assert faults.PLAN.fires("corrupt_disk_block") == 1
        got = warm(server, PROMPT)
    finally:
        faults.uninstall()
    assert got == want
    assert server.stats()["kv_checksum_failures"] == 1


def test_disk_full_disables_tier_serving_continues(tmp_path):
    server = spill_server(tmp_path)
    want = warm(server, PROMPT)
    faults.install(faults.FaultPlan(seed=0).add("disk_full", nth=1))
    try:
        spill_all(server)
    finally:
        faults.uninstall()
    assert not server.spill.enabled
    assert "28" in server.spill.disabled_reason
    assert server.stats()["kv_disk_blocks"] == 0
    assert warm(server, PROMPT) == want
    spill_all(server)
    assert server.stats()["kv_disk_blocks"] == 0


def test_slow_disk_fault_stalls_write_not_serving(tmp_path):
    server = spill_server(tmp_path)
    want = warm(server, PROMPT)
    faults.install(faults.FaultPlan(seed=0).add("slow_disk", nth=1, ms=30))
    try:
        assert spill_all(server) == 3
        assert faults.PLAN.fires("slow_disk") == 1
    finally:
        faults.uninstall()
    assert warm(server, PROMPT) == want
    assert server.stats()["kv_checksum_failures"] == 0


@BOTH_DTYPES
def test_export_splices_spill_source(tmp_path, quantize_kv):
    owner = spill_server(tmp_path, quantize_kv=quantize_kv)
    want = warm(owner, PROMPT)
    assert spill_all(owner) == 3
    payload = owner.kv_export_payload(owner.prefix_keys_hex(PROMPT), 0)
    assert payload is not None and len(payload["kv_keys"]) == 3
    assert owner.stats()["kv_disk_blocks"] == 3
    assert owner.stats()["kv_disk_restores"] == 0
    importer = make_server(quantize_kv=quantize_kv)
    assert importer.kv_import_payload(
        codec.decode_swag(codec.encode_swag(payload))) == 3
    assert warm(importer, PROMPT) == want


def test_prefetch_promote_starts_restore_before_admission(tmp_path):
    server = spill_server(tmp_path)
    want = warm(server, PROMPT)
    assert spill_all(server) == 3
    assert server.prefetch_promote(PROMPT)
    assert server.stats()["kv_prefetch_promotions"] == 1
    assert not server.prefetch_promote(PROMPT)      # already in flight
    while server._restoring:
        server._advance_restores()
    assert not server.prefetch_promote(PROMPT)      # fully resident
    assert warm(server, PROMPT) == want
    assert server.stats()["kv_disk_restores"] == 3


# --------------------------------------------------------------------------- #
# models/llama.py: the block scatter and gather


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["f32", "int8"])
def test_paged_scatter_and_gather_blocks_match_jax(quantize_kv):
    """``paged_scatter_blocks`` (prefill rows into explicit pool blocks,
    from a start block) and ``paged_gather_blocks`` (pool blocks into a
    bucket cache at a start block) against the JAX functions, bytewise;
    the port writes its pool and bucket in place."""
    jax_config = jax_llama.CONFIGS[CONFIG]
    rng = np.random.default_rng(8)

    def random_layers(make):
        layers = make()
        values = []
        for layer in layers:
            values.append({
                name: (rng.integers(-127, 128, buf.shape).astype(np.int8)
                       if np.dtype(buf.dtype) == np.int8 else
                       rng.standard_normal(buf.shape).astype(np.float32))
                for name, buf in layer.items()})
        return values

    pool = random_layers(lambda: jax_llama.init_paged_cache(
        jax_config, 9, 16, quantize_kv=quantize_kv))
    prefix = random_layers(lambda: jax_llama.init_cache(
        jax_config, 1, 64, quantize_kv=quantize_kv))
    bucket = random_layers(lambda: jax_llama.init_cache(
        jax_config, 1, 96, quantize_kv=quantize_kv))
    ids = np.array([7, 2, 5], np.int32)

    def to_jax(layers):
        return [{n: jnp.asarray(v) for n, v in layer.items()}
                for layer in layers]

    def to_port(layers):
        return [{n: torch.from_numpy(v.copy()) for n, v in layer.items()}
                for layer in layers]

    want = jax_llama.paged_scatter_blocks(to_jax(pool), jnp.asarray(ids),
                                          to_jax(prefix), jnp.int32(1))
    port_pool = to_port(pool)
    assert llama.paged_scatter_blocks(port_pool, torch.from_numpy(ids),
                                      to_port(prefix), 1) is port_pool
    for got_layer, want_layer in zip(port_pool, want):
        for name, value in want_layer.items():
            assert got_layer[name].numpy().tobytes() == \
                np.asarray(value).tobytes(), name
    want = jax_llama.paged_gather_blocks(to_jax(pool), jnp.asarray(ids),
                                         to_jax(bucket), jnp.int32(2))
    port_bucket = to_port(bucket)
    llama.paged_gather_blocks(to_port(pool), torch.from_numpy(ids),
                              port_bucket, 2)
    for got_layer, want_layer in zip(port_bucket, want):
        for name, value in want_layer.items():
            assert got_layer[name].numpy().tobytes() == \
                np.asarray(value).tobytes(), name
