"""Port parity: the distributed KV cache's wire — digests, the prefix
directory, spill files, the transfer payloads and the replica's KV
commands — against the JAX package's, on the CPU.

* ``kvstore/directory.py``: ``digest_encode`` strings equal for the same
  entries (a corpus and hypothesis), each package decodes the other's,
  and ``PrefixDirectory`` answers as the JAX one on the scenarios of
  tests/test_kvstore.py.
* ``kvstore/transfer.py``: the same seeded pool bytes in a JAX paged
  server's pool and a port server's, the same chain seeded: the export
  payloads are equal field for field (names, dtypes, shapes, bytes,
  ``kv_sig``), their ``encode_swag`` strings are equal, a payload of
  either package imports into the other's pool byte for byte, and the
  port's fused and per-field paths are byte-identical
  (tests/test_kv_transfer_fast.py), bf16 and int8 KV.
* ``kvstore/spill.py``: the port's store writes the JAX store's files
  byte for byte, from a server's evictions too, and each package adopts
  and reads the other's directory.
* ``ContinuousReplica``: a warm start through ``kv_source`` between two
  port replicas on one loopback broker, the timeout fall-back, the async
  import and its lease, ``migrate_prepare``, and a JAX replica's
  ``(kv_export_response …)`` handed to a port replica's import (the
  packages have separate brokers), whose tokens equal the port's local
  prefill in f32.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from aiko_services_tpu import runtime as jax_runtime
from aiko_services_tpu.kvstore import directory as jax_directory
from aiko_services_tpu.kvstore import spill as jax_spill
from aiko_services_tpu.kvstore import transfer as jax_transfer
from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.orchestration import continuous as jax_continuous
from aiko_services_tpu.orchestration import paged as jax_paged
from aiko_services_tpu.pipeline import codec as jax_codec
from aiko_services_tpu.utils import sexpr as jax_sexpr
from aiko_services_tpu_torch import runtime, transport
from aiko_services_tpu_torch.kvstore import directory, spill, transfer
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.models.bridge import (params_from_numpy,
                                                   tensor_from_numpy)
from aiko_services_tpu_torch.orchestration import continuous
from aiko_services_tpu_torch.orchestration.continuous import DecodeRequest
from aiko_services_tpu_torch.orchestration.paged import (
    RESTORING, PagedContinuousServer)
from aiko_services_tpu_torch.pipeline import codec
from aiko_services_tpu_torch.runtime import faults
from aiko_services_tpu_torch.utils import sexpr

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
def _port_side_isolated():
    transport.reset_brokers()
    yield
    faults.uninstall()
    transport.reset_brokers()


SERVER = dict(slots=2, max_seq=96, chunk_steps=4, block_size=16,
              enable_prefix_cache=True)


def port_server(config="tiny", **kwargs):
    return PagedContinuousServer(config_name=config, device="cpu",
                                 **dict(SERVER, seed=0, **kwargs))


def jax_server(config="tiny", **kwargs):
    return jax_paged.PagedContinuousServer(config_name=config,
                                           **dict(SERVER, seed=0, **kwargs))


def bridged_pair(config=CONFIG, **kwargs):
    """A JAX paged server and a port one on the JAX server's weights."""
    reference = jax_server(config, **kwargs)
    params = params_from_numpy(jax.tree.map(np.asarray, reference.params),
                               "cpu")
    return reference, port_server(config, params=params, **kwargs)


def warm(server, prompt, max_new=4, request_cls=DecodeRequest):
    server.submit(request_cls(request_id="warm", prompt=prompt,
                              max_new_tokens=max_new))
    return server.run_until_drained()[0].tokens


# --------------------------------------------------------------------------- #
# Digests and the prefix directory

_hex16 = st.text(alphabet="0123456789abcdef", min_size=16, max_size=16)
_counts = st.integers(0, 10**6)
_entries = st.lists(st.one_of(
    st.tuples(_hex16, _counts, _counts, _counts),
    st.tuples(_hex16, _counts, _counts, _counts, st.integers(0, 2)),
    st.tuples(_hex16, _counts, _counts, _counts, st.integers(0, 2),
              st.integers(0, 1)),
    st.tuples(_hex16, _counts, _counts, _counts, st.integers(0, 2),
              st.integers(0, 1), st.integers(0, 1)),
    st.tuples(_hex16, _counts, _counts, _counts, st.integers(0, 2),
              st.integers(0, 1), st.integers(0, 1), st.integers(0, 1))),
    max_size=8)

DIGEST_CORPUS = [
    (16, "decode", [("ab12cd34ef567890", 3, 1, 7),
                    ("ffee001122334455", 2, 0, 1)], 0),
    (16, "decode", [("ab12cd34ef567890", 3, 1, 7, 0),
                    ("ffee001122334455", 2, 0, 1, 1)], 0),
    (16, "decode", [("ab12cd34ef567890", 3, 1, 7, 2, 0),
                    ("ffee001122334455", 2, 0, 1, 2, 1)], 0),
    (32, "prefill", [("aa" * 8, 1, 0, 3, 0, 0, 0, 1)], 0),
    (16, "decode", [("aa" * 8, 1, 0, 3)], 1),
    (16, "decode", [], 0),
]


def _digests_agree(block_size, role, entries, migrating):
    text = directory.digest_encode(block_size, role, entries,
                                   migrating=migrating)
    assert text == jax_directory.digest_encode(block_size, role, entries,
                                               migrating=migrating)
    decoded = directory.digest_decode(text)
    assert decoded == jax_directory.digest_decode(text)
    assert decoded[0] == block_size and len(decoded[2]) == len(entries)


@pytest.mark.parametrize("block_size,role,entries,migrating", DIGEST_CORPUS)
def test_digest_strings_equal_on_the_corpus(block_size, role, entries,
                                            migrating):
    _digests_agree(block_size, role, entries, migrating)


@settings(max_examples=150, deadline=None)
@given(block_size=st.integers(1, 4096),
       role=st.sampled_from(["decode", "prefill"]), entries=_entries,
       migrating=st.integers(0, 1))
def test_digest_strings_equal_under_hypothesis(block_size, role, entries,
                                               migrating):
    _digests_agree(block_size, role, entries, migrating)


@pytest.mark.parametrize("text", [
    "", "16;decode", "x;decode;a/1/2/3", "16;decode;nodepth", None,
    "16;d;a/b/c/d", "16;decode;ab/1/2/3/4/5/6/7/8", "16;decode;a/1/2/3,"])
def test_malformed_digests_decode_to_none_in_both(text):
    assert directory.digest_decode(text) is None
    assert jax_directory.digest_decode(text) is None


def _directory_script(module):
    """tests/test_kvstore.py's directory scenarios, recorded as the
    answers one package's ``PrefixDirectory`` gives."""
    encode = module.digest_encode
    out = []
    d = module.PrefixDirectory(lease_s=30.0)
    keys = [f"{i:016x}" for i in range(4)]
    entries = [(k, depth + 1, 0, depth) for depth, k in enumerate(keys)]
    out.append(d.update("ra", encode(16, "decode", entries), now=0.0))
    out.append(d.update("rb", "garbage", now=0.0))
    out.append(d.matched_blocks("ra", keys, now=1.0))
    out.append(d.matched_blocks("ra", keys[:2] + ["ffff" * 4], now=1.0))
    out.append(d.best_owner(keys, now=1.0))
    out.append(d.matched_blocks("ra", keys, now=31.0))
    d.purge_expired(now=31.0)
    out.append(d.size)
    d.update("ra", encode(16, "prefill", entries), now=40.0)
    out += [d.role("ra"), d.block_size("ra")]
    d.evict_replica("ra")
    out += [d.size, d.replicas()]
    # hotness breaks ties
    key = "aa" * 8
    d.update("cold", encode(16, "decode", [(key, 1, 0, 1)]), now=0.0)
    d.update("hot", encode(16, "decode", [(key, 1, 0, 9)]), now=0.0)
    out.append(d.best_owner([key], now=1.0))
    # migrating flag follows the last advertisement
    d.update("rm", encode(16, "decode", [(key, 1, 0, 3)], migrating=1),
             now=1.0)
    out += [d.migrating("rm"), d.matched_blocks("rm", [key], now=2.0)]
    d.update("rm", encode(16, "decode", [(key, 1, 0, 3)]), now=3.0)
    out.append(d.migrating("rm"))
    # tiers and adapter residency
    tiered = [("bb" * 8, 1, 0, 1, 0), ("cc" * 8, 2, 0, 1, 1),
              ("dd" * 8, 3, 0, 1, 2, 1)]
    d.update("rt", encode(16, "decode", tiered), now=0.0)
    out += [d.matched_tiers("rt", ["bb" * 8, "cc" * 8, "dd" * 8], now=1.0),
            d.matched_detail("rt", ["bb" * 8, "cc" * 8], now=1.0)]
    d.update("ad", encode(16, "decode", [(key, 1, 0, 3, 1, 0, 0, 1)]),
             now=0.0)
    out += [d.adapter_tier("ad", key, now=1.0),
            d.adapter_tier("hot", key, now=1.0),
            d.adapter_owners(key, now=1.0),
            d.adapter_owners(key, now=100.0)]
    return out


def test_prefix_directory_answers_as_the_jax_one():
    got = _directory_script(directory)
    assert got == _directory_script(jax_directory)
    assert got[:5] == [True, False, 4, 2, ("ra", 4)]
    assert got[-4:] == [1, None, [("ad", 1)], []]


@pytest.mark.parametrize("quantize_kv,config", [
    (False, "tiny"), (True, "tiny"), (False, CONFIG)])
def test_pool_signature_equal(quantize_kv, config):
    reference, server = bridged_pair(config, quantize_kv=quantize_kv)
    signature = transfer.pool_signature(server)
    assert signature == jax_transfer.pool_signature(reference)
    assert "torch" not in signature


# --------------------------------------------------------------------------- #
# Export payloads on the same pool bytes


def seed_pools(reference, server, seed=3):
    """The same random bytes into both servers' pools (bf16 values from
    normal draws, int8 codes, positive f32 scales); returns them."""
    rng = np.random.default_rng(seed)
    layers = []
    for buffers in reference.pool:
        layer = {}
        for name, buf in buffers.items():
            dtype = np.dtype(buf.dtype)
            if dtype == np.int8:
                value = rng.integers(-127, 128, buf.shape).astype(np.int8)
            elif name in ("ks", "vs"):
                value = (np.abs(rng.standard_normal(buf.shape))
                         + 1e-3).astype(np.float32)
            else:
                value = rng.standard_normal(buf.shape).astype(
                    np.float32).astype(dtype)
            layer[name] = value
        layers.append(layer)
    reference.pool = [{name: jnp.asarray(value)
                       for name, value in layer.items()} for layer in layers]
    for port_layer, layer in zip(server.pool, layers):
        for name, value in layer.items():
            port_layer[name].copy_(tensor_from_numpy(value))
    return layers


def assert_payloads_equal(got, want):
    assert list(got) == list(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            assert got[key].shape == value.shape, key
            assert got[key].tobytes() == value.tobytes(), key
        else:
            assert got[key] == value, key


def pool_rows_bytes(layers, blocks):
    return {f"l{layer}_{name}": np.ascontiguousarray(
        value[np.asarray(blocks)]).view(np.uint8)
        for layer, buffers in enumerate(layers)
        for name, value in buffers.items()}


@BOTH_DTYPES
def test_export_payloads_equal_on_the_same_pool_bytes(quantize_kv):
    reference, server = bridged_pair("tiny", quantize_kv=quantize_kv,
                                     host_tier_blocks=16)
    seed_pools(reference, server)
    tokens = np.arange(1, 66, dtype=np.int32)       # 4 shareable blocks
    assert transfer.seed_chain(server, tokens) == \
        jax_transfer.seed_chain(reference, tokens) == 4
    assert server._index == reference._index
    keys = directory.chain_keys_hex(tokens, 16)
    want = jax_transfer.export_payload(reference, keys, 0)
    got = transfer.export_payload(server, keys, 0)
    assert_payloads_equal(got, want)
    assert got["kv_dtype"] == ("int8" if quantize_kv else "bfloat16")
    assert codec.encode_swag(got) == jax_codec.encode_swag(want)
    # A chain straddling tiers: the leaf demoted to the host tier on both.
    assert server._evict_one() and reference._evict_one()
    assert_payloads_equal(transfer.export_payload(server, keys[1:], 1),
                          jax_transfer.export_payload(reference, keys[1:],
                                                      1))


@BOTH_DTYPES
def test_payloads_import_across_the_packages(quantize_kv):
    reference, server = bridged_pair("tiny", quantize_kv=quantize_kv)
    layers = seed_pools(reference, server)
    tokens = np.arange(1, 66, dtype=np.int32)
    transfer.seed_chain(server, tokens)
    jax_transfer.seed_chain(reference, tokens)
    source = [reference._index[k] for k in
              directory.chain_keys(tokens, 16)[:4]]
    want = pool_rows_bytes(layers, source)
    keys = directory.chain_keys_hex(tokens, 16)
    payloads = {"jax": jax_transfer.export_payload(reference, keys, 0),
                "torch": transfer.export_payload(server, keys, 0)}
    # A JAX payload, through the port's codec, into a port pool.
    port_importer = port_server("tiny", quantize_kv=quantize_kv)
    wire = codec.decode_swag(jax_codec.encode_swag(payloads["jax"]))
    assert port_importer.kv_import_payload(wire) == 4
    blocks = [port_importer._index[bytes.fromhex(k)]
              for k in wire["kv_keys"]]
    got = transfer.gather_block_rows(port_importer, blocks)
    for field, value in got.items():
        assert value.view(np.uint8).tobytes() == want[field].tobytes()
    # A port payload, through the JAX codec, into a JAX pool.
    jax_importer = jax_server("tiny", quantize_kv=quantize_kv)
    wire = jax_codec.decode_swag(codec.encode_swag(payloads["torch"]))
    assert jax_importer.kv_import_payload(wire) == 4
    blocks = [jax_importer._index[bytes.fromhex(k)]
              for k in wire["kv_keys"]]
    got = jax_transfer.gather_block_rows(jax_importer, blocks)
    for field, value in got.items():
        assert np.ascontiguousarray(value).view(np.uint8).tobytes() \
            == want[field].tobytes()


@BOTH_DTYPES
def test_fused_and_legacy_export_byte_identical(quantize_kv):
    owner = port_server(quantize_kv=quantize_kv)
    warm(owner, PROMPT)
    keys = owner.prefix_keys_hex(PROMPT)
    fused = transfer.export_payload(owner, keys, 0)
    legacy = transfer.export_payload(owner, keys, 0, fused=False)
    assert_payloads_equal(fused, legacy)
    assert codec.encode_swag(fused) == codec.encode_swag(legacy)


@BOTH_DTYPES
def test_fused_and_legacy_import_land_identical_rows(quantize_kv):
    owner = port_server(quantize_kv=quantize_kv)
    warm(owner, PROMPT)
    wire = codec.decode_swag(codec.encode_swag(
        owner.kv_export_payload(owner.prefix_keys_hex(PROMPT), 0)))
    fused = port_server(quantize_kv=quantize_kv)
    legacy = port_server(quantize_kv=quantize_kv)
    assert transfer.import_payload(fused, dict(wire)) == 3
    assert transfer.import_payload(legacy, dict(wire), fused=False) == 3
    rows_f = transfer.gather_block_rows(
        fused, [fused._index[bytes.fromhex(k)] for k in wire["kv_keys"]])
    rows_l = transfer.gather_block_rows_legacy(
        legacy, [legacy._index[bytes.fromhex(k)] for k in wire["kv_keys"]])
    assert sorted(rows_f) == sorted(rows_l)
    for field in rows_f:
        assert rows_f[field].dtype == rows_l[field].dtype
        assert rows_f[field].tobytes() == rows_l[field].tobytes(), field


def _root(array):
    while array.base is not None and isinstance(array.base, np.ndarray):
        array = array.base
    return array


def test_export_pays_one_sync_and_serves_views_of_one_buffer():
    owner = port_server()
    warm(owner, PROMPT)
    before = owner.kv_export_sync_count
    payload = owner.kv_export_payload(owner.prefix_keys_hex(PROMPT), 0)
    assert owner.kv_export_sync_count == before + 1
    fields = [v for k, v in payload.items() if k.startswith("kv_l")]
    assert len({id(_root(v)) for v in fields}) == 1
    # A second export gets its own buffer: the first payload's bytes stay.
    first = {k: v.copy() for k, v in payload.items()
             if k.startswith("kv_l")}
    again = owner.kv_export_payload(owner.prefix_keys_hex(PROMPT), 0)
    assert _root(next(v for k, v in again.items() if k.startswith("kv_l"))) \
        is not _root(fields[0])
    for key, value in first.items():
        assert payload[key].tobytes() == value.tobytes()


def test_import_rejects_layout_linkage_and_byte_mismatches():
    owner = port_server()
    warm(owner, PROMPT)
    payload = owner.kv_export_payload(owner.prefix_keys_hex(PROMPT), 0)
    other_dtype = port_server(quantize_kv=True)
    assert other_dtype.kv_import_payload(dict(payload)) == 0
    assert port_server().kv_import_payload(
        dict(payload, kv_block_size=32)) == 0
    assert port_server().kv_import_payload(
        dict(payload, kv_start_depth=2, kv_parent="cd" * 32)) == 0
    for bad in ({k: v for k, v in payload.items()
                 if not k.startswith("kv_l1_")},
                dict(payload, kv_l0_k=payload["kv_l0_k"][..., :-1])):
        fresh = port_server()
        free_before = len(fresh._free)
        assert fresh.kv_import_payload(bad) == 0
        assert len(fresh._free) == free_before
        assert fresh.stats()["kv_transfer_failures"] == 1
    assert transfer.export_payload(owner, ["ab" * 8], 0) is None


def test_seed_chain_and_drop_one_block():
    server = port_server()
    tokens = np.arange(1, 66, dtype=np.int32)
    assert transfer.seed_chain(server, tokens) == 4
    payload = transfer.export_payload(
        server, directory.chain_keys_hex(tokens, 16), 0)
    assert len(payload["kv_keys"]) == 4
    short = transfer.drop_one_block(payload)
    assert len(short["kv_keys"]) == 3 and short["kv_l0_k"].shape[0] == 3
    assert transfer.payload_bytes(short) * 4 == \
        transfer.payload_bytes(payload) * 3
    assert transfer.drop_one_block(dict(payload, kv_keys=["a"])) is None


# --------------------------------------------------------------------------- #
# Spill files


def _files(root):
    return sorted(name for name in os.listdir(root)
                  if name.endswith(spill.SUFFIX)) \
        if os.path.isdir(root) else []


def test_spill_store_writes_the_jax_stores_files(tmp_path):
    rng = np.random.default_rng(5)
    rows = {"l0_k": rng.integers(0, 2 ** 16, (16, 2, 32)).astype(np.uint16),
            "l0_ks": rng.standard_normal((16, 2)).astype(np.float32),
            "l1_k": rng.integers(-127, 128, (16, 2, 32)).astype(np.int8)}
    meta = dict(parent="ab" * 32, depth=2, key_seed=0, hits=3, clock=7)
    for sig in ("2:2:32:1:int8", "2:2:32:0:float32"):
        port_store = spill.SpillStore(tmp_path / f"t{sig}", sig, 16)
        jax_store = jax_spill.SpillStore(tmp_path / f"j{sig}", sig, 16)
        group = [("cd" * 32, meta, rows)]
        assert port_store.put_group(group) and jax_store.put_group(group)
        name = "cd" * 32 + spill.SUFFIX
        port_blob = (tmp_path / f"t{sig}" / name).read_bytes()
        assert port_blob == (tmp_path / f"j{sig}" / name).read_bytes()
        for reader in (spill.SpillStore(tmp_path / f"j{sig}", sig, 16),
                       jax_spill.SpillStore(tmp_path / f"t{sig}", sig, 16)):
            record = reader.read("cd" * 32)
            for field, value in rows.items():
                assert record["rows"][field].tobytes() == value.tobytes()
            assert reader.scan()[1] == 0 and len(reader.scan()[0]) == 1
    # A bf16 pool's rows: ml_dtypes on the JAX side, bit patterns on the
    # port's, one file.
    bf16 = rng.standard_normal((16, 2, 32)).astype(np.float32).astype(
        jnp.bfloat16)
    sig = "2:2:32:0:bfloat16"
    spill.SpillStore(tmp_path / "tb", sig, 16).put_group(
        [("ef" * 32, meta, {"l0_k": bf16.view(np.uint16)})])
    jax_spill.SpillStore(tmp_path / "jb", sig, 16).put_group(
        [("ef" * 32, meta, {"l0_k": bf16})])
    name = "ef" * 32 + spill.SUFFIX
    assert (tmp_path / "tb" / name).read_bytes() == \
        (tmp_path / "jb" / name).read_bytes()


@BOTH_DTYPES
def test_server_spill_directories_byte_equal_and_cross_adopted(
        tmp_path, quantize_kv):
    dirs = {"jax": str(tmp_path / "jax"), "torch": str(tmp_path / "torch")}
    reference = jax_server("tiny", quantize_kv=quantize_kv,
                           host_tier_blocks=0, spill_dir=dirs["jax"])
    server = port_server("tiny", quantize_kv=quantize_kv,
                         host_tier_blocks=0, spill_dir=dirs["torch"])
    seed_pools(reference, server)
    tokens = np.arange(1, 66, dtype=np.int32)
    transfer.seed_chain(server, tokens)
    jax_transfer.seed_chain(reference, tokens)
    keys = directory.chain_keys_hex(tokens, 16)
    want = jax_transfer.export_payload(reference, keys, 0)
    while server._evict_one():
        pass
    while reference._evict_one():
        pass
    assert server.kv_spills == reference.kv_spills == 4
    names = _files(dirs["torch"])
    assert names == _files(dirs["jax"]) and len(names) == 4
    for name in names:
        with open(os.path.join(dirs["torch"], name), "rb") as handle:
            port_blob = handle.read()
        with open(os.path.join(dirs["jax"], name), "rb") as handle:
            assert port_blob == handle.read(), name
    # Each package adopts the other's directory and exports its chain.
    port_adopter = port_server("tiny", quantize_kv=quantize_kv,
                               spill_dir=dirs["jax"])
    jax_adopter = jax_server("tiny", quantize_kv=quantize_kv,
                             spill_dir=dirs["torch"])
    for adopter, module in ((port_adopter, transfer),
                            (jax_adopter, jax_transfer)):
        assert adopter.stats()["kv_adopted_chains"] == 1
        assert adopter.stats()["kv_disk_blocks"] == 4
        assert adopter.prefix_digest() == jax_adopter.prefix_digest()
        assert_payloads_equal(module.export_payload(adopter, keys, 0), want)


# --------------------------------------------------------------------------- #
# The replica's KV wire


class Rig:
    """Port replicas on one loopback broker and one virtual-clock engine;
    every ``infer_response`` on ``test/resp`` is kept decoded."""

    def __init__(self, broker="kv"):
        self.engine = runtime.EventEngine(clock=runtime.VirtualClock())
        self.broker = broker
        self.responses = {}
        self.events = []
        self.probe = self.process("1")

        def handler(_topic, payload):
            command, params = sexpr.parse(payload)
            self.events.append((command, str(params[0]),
                                codec.decode_swag(params[1])))
            if command == "infer_response":
                self.responses[str(params[0])] = codec.decode_swag(params[1])
        self.probe.add_message_handler(handler, "test/resp")

    def process(self, pid):
        return runtime.Process(namespace="test", hostname="h", pid=pid,
                               engine=self.engine, broker=self.broker)

    def replica(self, pid, name, server, **kwargs):
        return runtime.compose_instance(
            continuous.ContinuousReplica, runtime.actor_args(name),
            process=self.process(pid), server=server, **kwargs)

    def infer(self, replica, request_id, prompt, **swag):
        self.probe.message.publish(replica.topic_in, sexpr.generate(
            "infer", [request_id, "test/resp", codec.encode_swag(dict(
                tokens=np.asarray(prompt, np.int32), **swag))]))

    def run(self, until, steps=6000, dt=0.001):
        for _ in range(steps):
            self.engine.advance(dt)
            if until():
                return
        raise AssertionError(f"wire rig did not converge: {self.events}")


def _tokens(outputs):
    return [int(t) for t in np.asarray(outputs["tokens_out"])]


@BOTH_DTYPES
def test_wire_warm_start_via_kv_source(quantize_kv):
    rig = Rig()
    server_a = port_server(quantize_kv=quantize_kv)
    server_b = port_server(quantize_kv=quantize_kv)
    replica_a = rig.replica("2", "ra", server_a)
    replica_b = rig.replica("3", "rb", server_b)
    rig.infer(replica_a, "w1", PROMPT, max_new_tokens=4)
    rig.run(lambda: "w1" in rig.responses)
    digest = replica_a.share["kv_prefixes"]
    assert directory.digest_decode(digest)[2][0][1] == 3
    rig.infer(replica_b, "w2", PROMPT, max_new_tokens=4,
              kv_source=replica_a.topic_path)
    rig.run(lambda: "w2" in rig.responses)
    assert _tokens(rig.responses["w2"]) == _tokens(rig.responses["w1"]) \
        == warm(port_server(quantize_kv=quantize_kv), PROMPT)
    stats = server_b.stats()
    assert stats["prefix_remote_hits"] == 1
    assert stats["kv_imports_async"] == 1
    assert stats["kv_transfer_failures"] == 0
    assert stats["kv_transfer_bytes"] == server_a.kv_transfer_bytes > 0
    assert int(replica_b.share["prefix_remote_hits"]) == 1
    assert float(np.asarray(rig.responses["w2"]["kv_restore_ms"])) >= 0
    assert "kv_prefixes" in replica_b.share


def test_wire_kv_fetch_timeout_falls_back_to_local():
    rig = Rig("dead")
    server = port_server()
    replica = rig.replica("3", "rb", server, kv_fetch_timeout_s=2.0)
    rig.infer(replica, "d1", PROMPT, max_new_tokens=4,
              kv_source="test/h/77/1/gone")
    rig.run(lambda: "d1" in rig.responses)
    assert "error" not in rig.responses["d1"]
    assert _tokens(rig.responses["d1"]) == warm(port_server(), PROMPT)
    assert server.kv_transfer_failures == 1
    assert server.prefix_remote_hits == 0
    assert rig.engine.now() >= 2.0


def test_kv_export_answers_gone_and_unsupported():
    rig = Rig()
    paged = rig.replica("2", "ra", port_server())
    plain = rig.replica("3", "rc", continuous.ContinuousBatchingServer(
        config_name="tiny", slots=1, max_seq=64, device="cpu"))
    for replica, token in ((paged, "k1"), (plain, "k2")):
        rig.probe.message.publish(replica.topic_in, sexpr.generate(
            "kv_export", [token, "test/resp",
                          codec.encode_swag({"kv_keys": ["00ff"]})]))
    rig.run(lambda: len(rig.events) == 2)
    answers = {rid: out for cmd, rid, out in rig.events
               if cmd == "kv_export_response"}
    assert answers == {"k1": {"error": "kv_prefix_gone"},
                       "k2": {"error": "kv_unsupported"}}
    assert "kv_prefixes" not in plain.share


def _async_rig(restore_blocks_per_step=1):
    prompt = np.arange(1, 66, dtype=np.int32)        # 4 shareable blocks
    owner = port_server(max_seq=128, total_blocks=24)
    want = warm(owner, prompt)
    wire = codec.decode_swag(codec.encode_swag(
        owner.kv_export_payload(owner.prefix_keys_hex(prompt), 0)))
    importer = port_server(max_seq=128, total_blocks=24,
                           restore_blocks_per_step=restore_blocks_per_step)
    return prompt, want, wire, importer


def test_async_import_lands_behind_sentinel_and_decode_produces():
    engine = runtime.EventEngine(clock=runtime.VirtualClock())
    prompt, want, wire, importer = _async_rig()
    active = DecodeRequest(request_id="active",
                           prompt=np.arange(200, 220, dtype=np.int32),
                           max_new_tokens=16)
    importer.submit(active)
    for _ in range(8):
        importer.step()
        if active.tokens:
            break
    assert active.tokens
    assert importer.kv_import_payload(dict(wire), engine=engine,
                                      async_import=True) == 4
    assert importer.stats()["restore_queue_depth"] == 4
    for key in (bytes.fromhex(k) for k in wire["kv_keys"]):
        block = importer._index[key]
        assert importer._producing[block] == RESTORING
        assert importer._refs[block] == 1 and key not in importer._evictable
    restored = DecodeRequest(request_id="restored", prompt=prompt,
                             max_new_tokens=4)
    importer.submit(restored)
    produced_during_import = False
    for _ in range(40):
        depth_before = importer.stats()["restore_queue_depth"]
        emitted_before = len(active.tokens)
        importer.step()
        if depth_before > 0 and len(active.tokens) > emitted_before:
            produced_during_import = True
        if not importer.busy:
            break
    assert produced_during_import
    assert restored.tokens == want
    stats = importer.stats()
    assert stats["kv_imports_async"] == 1
    assert stats["prefix_remote_hits"] == 1
    assert stats["restore_queue_depth"] == 0


def test_async_import_lease_arms_at_landing():
    engine = runtime.EventEngine(clock=runtime.VirtualClock())
    _prompt, _want, wire, importer = _async_rig(restore_blocks_per_step=2)
    evictable_before = len(importer._evictable)
    assert importer.kv_import_payload(dict(wire), engine=engine,
                                      lease_s=5.0, async_import=True) == 4
    engine.advance(6.0)
    engine.drain()
    assert importer.stats()["kv_imports_async"] == 0
    importer.step()
    importer.step()
    assert importer.stats()["kv_imports_async"] == 1
    assert len(importer._evictable) == evictable_before
    engine.advance(6.0)
    engine.drain()
    assert len(importer._evictable) == evictable_before + 4


def test_truncated_async_payload_rejects_with_zero_side_effects():
    engine = runtime.EventEngine(clock=runtime.VirtualClock())
    prompt, want, wire, importer = _async_rig()
    truncated = {k: v for k, v in wire.items() if not k.startswith("kv_l1_")}
    free_before = len(importer._free)
    index_before = dict(importer._index)
    assert importer.kv_import_payload(truncated, engine=engine,
                                      async_import=True) == 0
    assert len(importer._free) == free_before
    assert importer._index == index_before
    assert importer.stats()["restore_queue_depth"] == 0
    # Half landed, the chain is never served: a fresh server's local
    # prefill gives the tokens.
    assert importer.kv_import_payload(dict(wire), engine=engine,
                                      async_import=True) == 4
    importer.step()
    assert importer.prefix_local_depth(prompt) < 4
    assert warm(port_server(max_seq=128, total_blocks=24), prompt) == want


def test_migrate_prepare_then_resume_on_a_peer():
    """The source registers the live chain and answers migrate_ready with
    blocks and tokens; a peer takes prompt + committed tokens with
    kv_source and kv_migrate and continues to the oracle's tokens."""
    rig = Rig("mig")
    server_a = port_server(ring_max=2)
    server_b = port_server(ring_max=2)
    replica_a = rig.replica("2", "ra", server_a)
    replica_b = rig.replica("3", "rb", server_b)
    prompt = np.arange(3, 40, dtype=np.int32)
    want = warm(port_server(), prompt, 24)
    rig.infer(replica_a, "m", prompt, max_new_tokens=24, stream=1)
    rig.run(lambda: sum(len(out["tokens_out"]) for cmd, rid, out
                        in rig.events if cmd == "infer_partial") >= 12)
    rig.probe.message.publish(replica_a.topic_in, sexpr.generate(
        "migrate_prepare", ["mid", "test/resp",
                            codec.encode_swag({"request_id": "m"})]))
    rig.run(lambda: any(cmd == "migrate_ready" for cmd, *_ in rig.events))
    ready = next(out for cmd, rid, out in rig.events
                 if cmd == "migrate_ready")
    tokens, blocks = int(ready["tokens"]), int(ready["blocks"])
    assert "error" not in ready and tokens >= 12
    assert blocks == directory.shareable_blocks(len(prompt) + tokens, 16)
    assert directory.digest_decode(replica_a.share["kv_prefixes"])[2][0][6]
    resume = np.concatenate([prompt, np.asarray(want[:tokens], np.int32)])
    rig.infer(replica_b, "m2", resume, max_new_tokens=24 - tokens,
              kv_source=replica_a.topic_path, kv_migrate=1)
    rig.run(lambda: "m" in rig.responses and "m2" in rig.responses)
    assert _tokens(rig.responses["m"]) == want
    assert want[:tokens] + _tokens(rig.responses["m2"]) == want
    assert server_b.stats()["prefix_remote_hits"] == 1
    assert server_b.stats()["kv_imports_async"] == 1
    # An unknown id, and a server without the KV methods.
    rig.probe.message.publish(replica_a.topic_in, sexpr.generate(
        "migrate_prepare", ["m3", "test/resp",
                            codec.encode_swag({"request_id": "zz"})]))
    rig.run(lambda: sum(cmd == "migrate_ready" for cmd, *_ in rig.events)
            == 2)
    assert [out for cmd, rid, out in rig.events
            if cmd == "migrate_ready"][-1] == {
        "request_id": "zz", "error": "migrate_unknown_request"}


def test_advertised_digest_tracks_the_cache_and_skips_idle_pumps(
        monkeypatch):
    """The replica recomputes ``kv_prefixes`` only when the server's
    cache moved, yet after every pump the advertised digest is the one a
    fresh walk gives: through a kv_source import and its lease, host-tier
    demotions and restores, and a long decode that changes nothing."""
    walk = PagedContinuousServer.prefix_digest
    pumps = {"telemetry": 0, "digests": 0}

    def counted_digest(self, *args, **kwargs):
        pumps["digests"] += 1
        return walk(self, *args, **kwargs)

    share_telemetry = continuous.ContinuousReplica._share_telemetry

    def checked_telemetry(self):
        share_telemetry(self)
        pumps["telemetry"] += 1
        assert self.share["kv_prefixes"] == walk(
            self.server, role=self.kv_role,
            migrating=bool(self._migrating_ids))

    monkeypatch.setattr(PagedContinuousServer, "prefix_digest",
                        counted_digest)
    monkeypatch.setattr(continuous.ContinuousReplica, "_share_telemetry",
                        checked_telemetry)
    rig = Rig("digest")
    replica_a = rig.replica("2", "ra", port_server())
    server_b = port_server(host_tier_blocks=8)
    replica_b = rig.replica("3", "rb", server_b)
    rig.infer(replica_a, "d1", PROMPT, max_new_tokens=4)
    rig.run(lambda: "d1" in rig.responses)
    rig.infer(replica_b, "d2", PROMPT, max_new_tokens=4,
              kv_source=replica_a.topic_path)
    rig.run(lambda: "d2" in rig.responses)
    assert server_b.kv_imports_async == 1
    rig.engine.advance(40.0)                    # every import lease ends
    rig.engine.drain()
    before = dict(pumps)
    rig.infer(replica_b, "d3", np.arange(60, 80, dtype=np.int32),
              max_new_tokens=60)
    rig.run(lambda: "d3" in rig.responses)
    assert pumps["telemetry"] - before["telemetry"] >= 10
    assert pumps["digests"] - before["digests"] <= 3
    rig.infer(replica_b, "d4", np.arange(100, 180, dtype=np.int32),
              max_new_tokens=4)
    rig.run(lambda: "d4" in rig.responses)
    rig.infer(replica_b, "d5", PROMPT, max_new_tokens=4)
    rig.run(lambda: "d5" in rig.responses)
    assert server_b.kv_demotions > 0 and server_b.kv_restores > 0
    assert _tokens(rig.responses["d5"]) == _tokens(rig.responses["d1"])


def test_jax_kv_export_response_imports_into_the_port():
    """A JAX replica's (kv_export_response …) text, answering the very
    (kv_export …) a port replica sent for a kv_source warm start, handed
    to the port replica on its own broker: the import lands and the
    tokens equal the port's local prefill (f32)."""
    reference, server = bridged_pair(CONFIG)
    jax_engine = jax_runtime.EventEngine(clock=jax_runtime.VirtualClock())
    jax_process = jax_runtime.Process(namespace="test", hostname="j",
                                      pid="7", engine=jax_engine,
                                      broker="jaxkv")
    jax_replica = jax_runtime.compose_instance(
        jax_continuous.ContinuousReplica, jax_runtime.actor_args("ja"),
        process=jax_process, server=reference)
    caught = []
    jax_process.add_message_handler(
        lambda _t, payload: caught.append(payload), "test/jresp")
    jax_process.message.publish(jax_replica.topic_in, jax_sexpr.generate(
        "infer", ["j1", "test/jresp", jax_codec.encode_swag(
            {"tokens": PROMPT, "max_new_tokens": 4})]))
    for _ in range(4000):
        jax_engine.advance(0.001)
        if caught:
            break
    jax_tokens = [int(t) for t in np.asarray(jax_codec.decode_swag(
        jax_sexpr.parse(caught[0])[1][1])["tokens_out"])]

    rig = Rig("portkv")
    replica = rig.replica("3", "rb", server, kv_fetch_timeout_s=30.0)
    requests = []
    rig.probe.add_message_handler(lambda _t, payload: requests.append(
        payload), "test/h/99/1/ja/in")
    rig.infer(replica, "p1", PROMPT, max_new_tokens=4,
              kv_source="test/h/99/1/ja")
    rig.run(lambda: requests)
    command, params = sexpr.parse(requests[0])
    assert command == "kv_export" and params[1] == replica._kv_topic
    jax_process.message.publish(jax_replica.topic_in, jax_sexpr.generate(
        "kv_export", [params[0], "test/jresp", params[2]]))
    for _ in range(4000):
        jax_engine.advance(0.001)
        if len(caught) == 2:
            break
    assert jax_sexpr.parse(caught[1])[0] == "kv_export_response"
    rig.probe.message.publish(replica._kv_topic, caught[1])
    rig.run(lambda: "p1" in rig.responses)
    assert _tokens(rig.responses["p1"]) == jax_tokens == warm(
        port_server(CONFIG, params=server.params), PROMPT)
    stats = server.stats()
    assert stats["kv_imports_async"] == 1
    assert stats["prefix_remote_hits"] == 1
    assert stats["kv_transfer_failures"] == 0
