"""Port parity: LoRA and multi-tenant serving against the JAX package, on
the CPU.

* ``models/lora.py``: a fresh adapter is an exact no-op, ``merge_lora``
  equals ``lora_forward`` and the JAX merge on the same factors, the
  stacking checks, and the items left out (TP specs, training) raising
  by name.
* ``models/llama.py``: ``lora=`` through every forward the servers call
  (prefill, both decode cores, the chunked contiguous forwards, paged
  append, verify and serve) against the JAX package's on the same
  weights, factors and inputs (logits within 1e-4, f32); ``lora=None``
  bitwise the adapter-free call.
* ``models/lora_paged.py``: the page codec byte for byte the JAX one's.
* The servers: the JAX package's tests/test_multi_lora.py and
  tests/test_multitenant.py scenarios (base rows bitwise the plain
  server's, mixed batches isolated, the merged-weights oracle, paged
  equal to contiguous, adapter-scoped prefixes, hot load / unload /
  replace, the busy checks, adapter pages through the tiers and across
  replicas, the PEFT round trip), tokens equal to the JAX servers' on the
  same weights and adapters; the wire's ``adapter_load`` /
  ``adapter_unload`` (a PEFT path or packed factor bytes) and
  ``InferClient.load_adapter``; ``run_multitenant`` (aware 0 cold
  starts, blind > 0, its payloads and tenants the JAX rig's).
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.kvstore.adapters import ADAPTER_SEED
from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.models import lora as jax_lora
from aiko_services_tpu.models import lora_paged as jax_lora_paged
from aiko_services_tpu.orchestration import continuous as jax_continuous
from aiko_services_tpu.orchestration import paged as jax_paged
from aiko_services_tpu.tools import loadgen as jax_loadgen
from aiko_services_tpu.tools.import_weights import export_lora_checkpoint
from aiko_services_tpu_torch import runtime, transport
from aiko_services_tpu_torch.kvstore import adapters as kvadapters
from aiko_services_tpu_torch.kvstore import directory as kvdir
from aiko_services_tpu_torch.models import llama, lora, lora_paged
from aiko_services_tpu_torch.models.bridge import params_from_numpy
from aiko_services_tpu_torch.orchestration import client as port_client
from aiko_services_tpu_torch.orchestration.continuous import (
    ContinuousBatchingServer, ContinuousReplica, DecodeRequest)
from aiko_services_tpu_torch.orchestration.paged import PagedContinuousServer
from aiko_services_tpu_torch.pipeline import codec
from aiko_services_tpu_torch.tools import import_weights, loadgen
from aiko_services_tpu_torch.utils import sexpr

from .test_multi_lora import LORA as JAX_LORA
from .test_multi_lora import _noisy_adapter
from .test_torch_server import reference_greedy

CONFIG = "tiny_f32"
LORA = lora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv"))
#: tests/test_multitenant.py's composed paged settings.
COMPOSED = dict(slots=4, max_seq=128, chunk_steps=3, block_size=16,
                enable_prefix_cache=True, chunk_prefill_tokens=32,
                quantize_kv=True)


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bridge(tree):
    return params_from_numpy(_np(tree), "cpu")


def _adapter(seed):
    """The JAX tests' noisy adapter (non-zero B) on the f32 config, as
    numpy factors."""
    return _np(_noisy_adapter(jax_llama.CONFIGS[CONFIG],
                              jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def jax_params():
    return jax_llama.init_params(
        dataclasses.replace(jax_llama.CONFIGS["tiny"], dtype=jnp.float32),
        jax.random.PRNGKey(0))


def _prompts(specs, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 1024, plen).astype(np.int32)
            for plen, *_ in specs]


def _serve(server, specs, seed=0):
    """Submit (prompt_len, max_new, adapter) specs into either package's
    server; return the requests after the drain."""
    module = (jax_continuous if isinstance(server,
                                           jax_continuous.
                                           ContinuousBatchingServer)
              else sys.modules[ContinuousBatchingServer.__module__])
    requests = [module.DecodeRequest(f"r{i}", prompt, new, adapter=adapter)
                for i, (prompt, (_, new, adapter))
                in enumerate(zip(_prompts(specs, seed), specs))]
    for request in requests:
        server.submit(request)
    server.run_until_drained()
    return requests


def _pair(layout="contiguous", adapters=None, **kwargs):
    """A JAX server and the port's (CPU) on the JAX server's weights and
    the same adapters."""
    kwargs = dict(dict(slots=2, max_seq=96, chunk_steps=4, seed=5,
                       ring_max=2), **kwargs)
    jax_cls, port_cls = (
        (jax_paged.PagedContinuousServer, PagedContinuousServer)
        if layout == "paged" else
        (jax_continuous.ContinuousBatchingServer, ContinuousBatchingServer))
    extra = {}
    if adapters:
        extra = dict(adapters=adapters, lora_config=JAX_LORA)
    jax_server = jax_cls(config_name=CONFIG, **kwargs, **extra)
    if adapters:
        extra = dict(adapters={name: _np(tree)
                               for name, tree in adapters.items()},
                     lora_config=LORA)
    kwargs.pop("seed")
    port_server = port_cls(config_name=CONFIG,
                           params=_bridge(jax_server.params), device="cpu",
                           **kwargs, **extra)
    return jax_server, port_server


# --------------------------------------------------------------------------- #
# models/lora.py


def test_fresh_adapter_is_exact_noop(jax_params):
    config = llama.CONFIGS[CONFIG]
    params = _bridge(jax_params)
    fresh = lora.init_lora_params(config, LORA, seed=1, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(1, 1024, (2, 12)).astype(np.int32))
    base = llama.forward(params, tokens, config)
    assert torch.equal(lora.lora_forward(params, fresh, tokens, config, LORA),
                       base)
    assert all(not layer[t]["b"].any() for layer in fresh["layers"]
               for t in LORA.targets)


def test_merge_equals_functional(jax_params):
    """``merge_lora`` equals ``lora_forward`` exactly, and the merged
    model's logits the JAX merge's within 1e-4."""
    config = llama.CONFIGS[CONFIG]
    adapter = _adapter(11)
    params = _bridge(jax_params)
    factors = params_from_numpy(adapter)
    tokens = np.random.default_rng(3).integers(1, 1024, (2, 10)).astype(
        np.int32)
    merged = llama.forward(lora.merge_lora(params, factors, LORA),
                           torch.from_numpy(tokens), config)
    functional = lora.lora_forward(params, factors, torch.from_numpy(tokens),
                                   config, LORA)
    assert torch.equal(merged, functional)
    ref = jax_llama.forward(
        jax_lora.merge_lora(jax_params, _noisy_adapter(
            jax_llama.CONFIGS[CONFIG], jax.random.PRNGKey(11)), JAX_LORA),
        jnp.asarray(tokens), jax_llama.CONFIGS[CONFIG], use_flash=False)
    np.testing.assert_allclose(merged.numpy(), np.asarray(ref), atol=1e-4)


def test_lora_specs_targets_and_left_out_items():
    config = llama.CONFIGS[CONFIG]
    assert lora.factor_dims(config) == jax_lora.factor_dims(
        jax_llama.CONFIGS[CONFIG])
    assert lora.SERVING_TARGETS == jax_lora.SERVING_TARGETS
    assert lora.DEFAULT_TARGETS == jax_lora.DEFAULT_TARGETS
    with pytest.raises(NotImplementedError, match="item 11"):
        lora.lora_param_specs(config, LORA)
    with pytest.raises(NotImplementedError, match="item 10"):
        lora.make_lora_train_step(config, LORA, optimizer=None)
    with pytest.raises(ValueError, match="unknown LoRA target"):
        lora.init_lora_params(config, lora.LoRAConfig(targets=("wx",)),
                              device="cpu")
    moe = dataclasses.replace(config, n_experts=4)
    with pytest.raises(ValueError, match="MoE"):
        lora.init_lora_params(moe, lora.LoRAConfig(targets=("w_up",)),
                              device="cpu")
    bad = lora.LoRAConfig(rank=4, targets=("wq", "w_gate"))
    with pytest.raises(ValueError, match="attention targets"):
        lora.stack_adapters(config, bad, [lora.init_lora_params(
            config, bad, device="cpu")])
    wrong_rank = lora.init_lora_params(config, lora.LoRAConfig(rank=2),
                                       device="cpu")
    with pytest.raises(ValueError, match="factor shapes"):
        lora.stack_adapters(config, lora.LoRAConfig(rank=4), [wrong_rank])


# --------------------------------------------------------------------------- #
# models/llama.py: lora= through every forward


def _stacked(ids):
    """Both packages' stacked factors of two noisy adapters, with ``ids``."""
    adapters = [_adapter(21), _adapter(22)]
    jax_stack = jax_lora.stack_adapters(
        jax_llama.CONFIGS[CONFIG], JAX_LORA,
        [jax.tree.map(jnp.asarray, a) for a in adapters])
    port_stack = lora.stack_adapters(llama.CONFIGS[CONFIG], LORA, adapters,
                                     device="cpu")
    ids = np.asarray(ids, np.int32)
    return (dict(jax_stack, ids=jnp.asarray(ids)),
            dict(port_stack, ids=torch.from_numpy(ids)))


FORWARDS = ["prefill", "decode", "prefill_chunk", "verify_chunk_ragged",
            "decode_chunk_ragged", "prefill_append_paged",
            "verify_chunk_paged", "serve_chunk_paged"]


@pytest.mark.parametrize("entry", FORWARDS)
def test_lora_forwards_match_jax(jax_params, entry):
    """Each forward with a mixed batch (rows on the identity, adapter 1
    and adapter 2) gives the JAX package's logits within 1e-4 (tokens for
    the serve chunk), and with ``lora=None`` exactly the adapter-free
    call."""
    jcfg, cfg = jax_llama.CONFIGS[CONFIG], llama.CONFIGS[CONFIG]
    params = _bridge(jax_params)
    batch = 3
    jlora, plora = _stacked([0, 1, 2][:batch])
    rng = np.random.default_rng(7)
    prompts = rng.integers(1, 1024, (batch, 16)).astype(np.int32)
    window = rng.integers(1, 1024, (batch, 5)).astype(np.int32)
    positions = np.array([16, 9, 12], np.int32)
    active = np.array([True, True, True])

    def contiguous():
        jc = jax_llama.init_cache(jcfg, batch, 64)
        _, jc = jax_llama.prefill(jax_params, jnp.asarray(prompts), jc, jcfg,
                                  lora=jlora)
        pc = llama.init_cache(cfg, batch, 64, device="cpu")
        llama.prefill(params, torch.from_numpy(prompts), pc, cfg, lora=plora)
        return jc, pc

    def paged():
        bs, blocks = 16, 4
        tables = np.arange(1, batch * blocks + 1, dtype=np.int32).reshape(
            batch, blocks)
        jp = jax_llama.init_paged_cache(jcfg, batch * blocks + 1, bs)
        pp = llama.init_paged_cache(cfg, batch * blocks + 1, bs,
                                    device="cpu")
        for row in range(batch):
            one = {key: value[row:row + 1] for key, value in jlora.items()
                   if key == "ids"}
            _, jp = jax_llama.prefill_append_paged(
                jax_params, jnp.asarray(prompts[row:row + 1]), jp,
                jnp.asarray(tables[row:row + 1]), jnp.int32(0), jcfg,
                lora=dict(jlora, **one))
            llama.prefill_append_paged(
                params, torch.from_numpy(prompts[row:row + 1]), pp,
                torch.from_numpy(tables[row:row + 1]), 0, cfg,
                lora=dict(plora, ids=plora["ids"][row:row + 1]))
        return tables, jp, pp

    def run(use_lora):
        jl, pl = (jlora, plora) if use_lora else (None, None)
        if entry == "prefill":
            jc = jax_llama.init_cache(jcfg, batch, 64)
            want, _ = jax_llama.prefill(jax_params, jnp.asarray(prompts), jc,
                                        jcfg, lora=jl)
            got, _ = llama.prefill(params, torch.from_numpy(prompts),
                                   llama.init_cache(cfg, batch, 64,
                                                    device="cpu"), cfg,
                                   lora=pl)
            return want, got
        if entry in ("decode", "decode_chunk_ragged", "prefill_chunk",
                     "verify_chunk_ragged"):
            jc, pc = contiguous()
            tok = window[:, :1]
            if entry == "decode":
                want, _ = jax_llama._decode_core_ragged(
                    jax_params, jnp.asarray(tok), jc,
                    jnp.full((batch,), 16, jnp.int32), jcfg, lora=jl)
                got, _ = llama.decode_step(params, torch.from_numpy(tok), pc,
                                           16, cfg, lora=pl)
            elif entry == "decode_chunk_ragged":
                want = jax_llama.decode_chunk_ragged(
                    jax_params, jnp.asarray(tok), jc, jnp.asarray(positions),
                    jnp.asarray(active), 3, jcfg, lora=jl,
                    return_logits=True)[1]
                got = llama.decode_chunk_ragged(
                    params, torch.from_numpy(tok), pc,
                    torch.from_numpy(positions), torch.from_numpy(active), 3,
                    cfg, lora=pl, return_logits=True)[1]
            elif entry == "prefill_chunk":
                want, _ = jax_llama.prefill_chunk(
                    jax_params, jnp.asarray(window), jc, jnp.int32(16), jcfg,
                    lora=jl)
                got, _ = llama.prefill_chunk(params, torch.from_numpy(window),
                                             pc, 16, cfg, lora=pl)
            else:
                want, _ = jax_llama.verify_chunk_ragged(
                    jax_params, jnp.asarray(window), jc,
                    jnp.asarray(positions), jnp.asarray(active), jcfg,
                    lora=jl)
                got, _ = llama.verify_chunk_ragged(
                    params, torch.from_numpy(window), pc,
                    torch.from_numpy(positions), torch.from_numpy(active),
                    cfg, lora=pl)
            return want, got
        tables, jp, pp = paged()
        if entry == "prefill_append_paged":
            more = window[:1]
            want, _ = jax_llama.prefill_append_paged(
                jax_params, jnp.asarray(np.tile(more, (1, 3))[:, :16]), jp,
                jnp.asarray(tables[1:2]), jnp.int32(16), jcfg,
                lora=None if jl is None else dict(jl, ids=jl["ids"][1:2]))
            got, _ = llama.prefill_append_paged(
                params, torch.from_numpy(np.tile(more, (1, 3))[:, :16]), pp,
                torch.from_numpy(tables[1:2]), 16, cfg,
                lora=None if pl is None else dict(pl, ids=pl["ids"][1:2]))
            return want, got
        if entry == "verify_chunk_paged":
            want, _ = jax_llama.verify_chunk_paged(
                jax_params, jnp.asarray(window), jp, jnp.asarray(tables),
                jnp.asarray(positions), jnp.asarray(active), jcfg, lora=jl)
            got, _ = llama.verify_chunk_paged(
                params, torch.from_numpy(window), pp,
                torch.from_numpy(tables), torch.from_numpy(positions),
                torch.from_numpy(active), cfg, lora=pl)
            return want, got
        state = dict(token=window[:, :1], positions=positions,
                     active=active, remaining=np.full(batch, 8, np.int32),
                     temps=np.zeros(batch, np.float32),
                     tops=np.ones(batch, np.float32), tables=tables,
                     adapter_ids=np.asarray([0, 1, 2], np.int32))
        shared_j = None if jl is None else {k: v for k, v in jl.items()
                                            if k != "ids"}
        shared_p = None if pl is None else {k: v for k, v in pl.items()
                                            if k != "ids"}
        want = jax_llama.serve_chunk_paged(
            jax_params, {k: jnp.asarray(v) for k, v in state.items()}, jp, 4,
            jcfg, lora_shared=shared_j)[0]
        got = llama.serve_chunk_paged(
            params, {k: torch.from_numpy(v) for k, v in state.items()}, pp, 4,
            cfg, lora_shared=shared_p)[0]
        return want, got

    want, got = run(True)
    if entry == "serve_chunk_paged":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    base_want, base_got = run(False)
    assert not np.array_equal(np.asarray(base_want), np.asarray(want))
    # lora=None is the adapter-free program: bitwise the call without it.
    if entry == "prefill":
        plain, _ = llama.prefill(params, torch.from_numpy(prompts),
                                 llama.init_cache(cfg, batch, 64,
                                                  device="cpu"), cfg)
        assert torch.equal(plain, base_got)


# --------------------------------------------------------------------------- #
# models/lora_paged.py


def test_page_codec_is_byte_identical_to_jax():
    """Packed streams, pages and their row dicts equal the JAX codec's;
    a port-packed stream unpacks in the JAX package and the other way
    round."""
    config, jcfg = llama.CONFIGS[CONFIG], jax_llama.CONFIGS[CONFIG]
    adapter = _adapter(31)
    ours = lora_paged.pack_adapter(config, LORA, adapter)
    theirs = jax_lora_paged.pack_adapter(jcfg, JAX_LORA, adapter)
    np.testing.assert_array_equal(ours, theirs)
    back, back_config = jax_lora_paged.unpack_adapter(jcfg, ours)
    mine, my_config = lora_paged.unpack_adapter(config, theirs)
    assert back_config == JAX_LORA and my_config == LORA
    for layer, jlayer in zip(mine["layers"], back["layers"]):
        for target in LORA.targets:
            for key in ("a", "b"):
                np.testing.assert_array_equal(layer[target][key].numpy(),
                                              np.asarray(jlayer[target][key]))
    server = PagedContinuousServer(config_name="tiny", slots=1, max_seq=64,
                                   device="cpu", quantize_kv=True)
    jserver = jax_paged.PagedContinuousServer(config_name="tiny", slots=1,
                                              max_seq=64, quantize_kv=True)
    from aiko_services_tpu.kvstore import transfer as jax_transfer
    from aiko_services_tpu_torch.kvstore import transfer
    layout = transfer._field_layout(server)
    jlayout = jax_transfer._field_layout(jserver)
    size = lora_paged.page_payload_nbytes(layout)
    assert size == jax_lora_paged.page_payload_nbytes(jlayout)
    page = lora_paged.split_pages(ours, size)[0]
    rows = lora_paged.payload_to_row_dict(page, layout)
    jrows = jax_lora_paged.payload_to_row_dict(page, jlayout)
    for field in rows:
        np.testing.assert_array_equal(
            np.asarray(rows[field]).view(np.uint8),
            np.asarray(jrows[field]).view(np.uint8))
    np.testing.assert_array_equal(
        lora_paged.row_dict_to_payload(rows, layout), page)


# --------------------------------------------------------------------------- #
# The servers (tests/test_multi_lora.py)


def test_all_base_rows_match_plain_server_exactly():
    """Adapters loaded, every request on the base: bitwise the server
    without adapters (port against port), and the JAX server's tokens."""
    adapters = {"x": _noisy_adapter(jax_llama.CONFIGS[CONFIG],
                                    jax.random.PRNGKey(1))}
    specs = [(5, 6, None), (11, 4, None), (7, 8, None)]
    jax_server, with_lora = _pair(adapters=adapters)
    plain = ContinuousBatchingServer(config_name=CONFIG,
                                     params=with_lora.params, device="cpu",
                                     slots=2, max_seq=96, chunk_steps=4)
    got = [r.tokens for r in _serve(with_lora, specs)]
    assert got == [r.tokens for r in _serve(plain, specs)]
    assert got == [list(r.tokens) for r in _serve(jax_server, specs)]


def test_mixed_batch_isolation_and_adapter_effect():
    """A base row in a mixed batch is the plain oracle's; the adapter row
    differs from its base twin; both rows the JAX server's."""
    adapters = {"helper": _noisy_adapter(jax_llama.CONFIGS[CONFIG],
                                         jax.random.PRNGKey(2))}
    jax_server, server = _pair(adapters=adapters)
    specs = [(9, 8, None), (9, 8, "helper")]
    base_row, adapted_row = _serve(server, specs, seed=7)
    assert base_row.tokens == reference_greedy(server, base_row.prompt, 8)
    assert [base_row.tokens, adapted_row.tokens] == \
        [list(r.tokens) for r in _serve(jax_server, specs, seed=7)]
    twin = DecodeRequest("twin", adapted_row.prompt.copy(), 8)
    server.submit(twin)
    server.run_until_drained()
    assert twin.tokens != adapted_row.tokens


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_adapter_matches_merged_model_oracle_f32(layout):
    """In f32 the batched delta reproduces the merged model: each request
    equals per-request greedy on ``merge_lora(base, its adapter)``, and
    the JAX server's tokens."""
    adapters = {"ft": _noisy_adapter(jax_llama.CONFIGS[CONFIG],
                                     jax.random.PRNGKey(3))}
    specs = [(9, 6, None), (13, 5, "ft"), (5, 7, "ft"), (17, 4, None)]
    jax_server, server = _pair(layout, adapters=adapters)
    got = _serve(server, specs, seed=17)
    assert [r.tokens for r in got] == \
        [list(r.tokens) for r in _serve(jax_server, specs, seed=17)]
    factors = params_from_numpy(_np(adapters["ft"]))
    merged_params = lora.merge_lora(server.params, factors, LORA)
    oracle = ContinuousBatchingServer(config_name=CONFIG,
                                      params=merged_params, device="cpu",
                                      slots=1, max_seq=96)
    for request in got:
        if request.adapter:
            assert request.tokens == reference_greedy(oracle, request.prompt,
                                                      request.max_new_tokens)
        else:
            assert request.tokens == reference_greedy(
                server, request.prompt, request.max_new_tokens)


def test_paged_adapters_match_contiguous():
    adapters = {"ft": _adapter(3)}
    specs = [(9, 6, None), (13, 5, "ft"), (5, 7, "ft"), (17, 4, None)]
    outs = []
    for cls in (ContinuousBatchingServer, PagedContinuousServer):
        server = cls(config_name=CONFIG, slots=2, max_seq=96, chunk_steps=4,
                     seed=5, adapters=adapters, lora_config=LORA,
                     device="cpu")
        outs.append([r.tokens for r in _serve(server, specs, seed=17)])
    assert outs[0] == outs[1]


def test_prefix_cache_is_adapter_scoped():
    """Identical prompts under different adapters share no blocks (chain
    keys seeded with the adapter's index, the JAX package's keys); the
    same adapter re-submitting hits."""
    server = PagedContinuousServer(
        config_name=CONFIG, slots=1, max_seq=96, chunk_steps=4, seed=7,
        block_size=16, enable_prefix_cache=True, device="cpu",
        adapters={"ft": _adapter(5)}, lora_config=LORA)
    prompt = _prompts([(40,)], seed=23)[0]
    from aiko_services_tpu.kvstore import directory as jax_kvdir
    for adapter_id in (0, 1):
        assert server._chain_keys(prompt, adapter_id) == \
            jax_kvdir.chain_keys(prompt, 16, adapter_id)

    def run(rid, adapter):
        request = DecodeRequest(rid, prompt.copy(), 5, adapter=adapter)
        server.submit(request)
        server.run_until_drained()
        return request

    base_first = run("b1", None)
    adapted = run("f1", "ft")
    assert server.prefix_hits == 0
    base_again = run("b2", None)
    assert server.prefix_hits == 1
    adapted_again = run("f2", "ft")
    assert server.prefix_hits == 2
    assert base_again.tokens == base_first.tokens
    assert adapted_again.tokens == adapted.tokens != base_first.tokens
    # Adapter KV never leaves the replica: the digest holds base chains.
    entries = kvdir.digest_decode(server.prefix_digest())[2]
    base_keys = {key.hex()[:kvdir.HEX_KEY_CHARS]
                 for key in server._chain_keys(prompt, 0)}
    assert entries and {entry[0] for entry in entries} <= base_keys


def test_unknown_adapter_rejected_cleanly():
    server = ContinuousBatchingServer(
        config_name=CONFIG, slots=1, max_seq=64, chunk_steps=2, device="cpu",
        adapters={"a": _adapter(8)}, lora_config=LORA)
    request = DecodeRequest("u", np.arange(1, 6, dtype=np.int32), 4,
                            adapter="nope")
    server.submit(request)
    assert server.run_until_drained()[0].error == "unknown_adapter"
    bare = ContinuousBatchingServer(config_name=CONFIG, slots=1, max_seq=64,
                                    chunk_steps=2, device="cpu")
    request = DecodeRequest("u2", np.arange(1, 6, dtype=np.int32), 4,
                            adapter="a")
    bare.submit(request)
    assert bare.run_until_drained()[0].error == "unknown_adapter"
    with pytest.raises(ValueError, match="lora_config"):
        ContinuousBatchingServer(config_name=CONFIG, slots=1, max_seq=64,
                                 device="cpu", adapters={"a": _adapter(8)})


def test_peft_checkpoint_round_trip(tmp_path):
    """The JAX package's ``export_lora_checkpoint`` (PEFT layout) read by
    the port's ``import_lora``: the same factors and config."""
    jcfg = jax_llama.CONFIGS[CONFIG]
    adapter = _noisy_adapter(jcfg, jax.random.PRNGKey(12))
    out = str(tmp_path / "adapter")
    export_lora_checkpoint(adapter, JAX_LORA, jcfg, out)
    back, back_config = import_weights.import_lora(out,
                                                   llama.CONFIGS[CONFIG])
    assert back_config == LORA
    for layer, layer_back in zip(adapter["layers"], back["layers"]):
        for target in layer:
            for factor in ("a", "b"):
                np.testing.assert_array_equal(
                    np.asarray(layer[target][factor], np.float32),
                    layer_back[target][factor].numpy())


def test_hot_load_unload_adapter():
    """A run-time load serves as a construction-time adapter does; a busy
    replacement is refused; unload frees the name and recycles its index
    IN PLACE (the stacked tensors keep their addresses); the recycled
    index serves the new weights."""
    prompt = _prompts([(11,)], seed=43)[0]

    def serve(server, rid, name, new=6):
        request = DecodeRequest(rid, prompt.copy(), new, adapter=name)
        server.submit(request)
        server.run_until_drained()
        return request

    adapter, other = _adapter(14), _adapter(15)
    kwargs = dict(config_name=CONFIG, slots=2, max_seq=96, chunk_steps=4,
                  seed=8, device="cpu")
    static = ContinuousBatchingServer(adapters={"ft": adapter},
                                      lora_config=LORA, **kwargs)
    hot = ContinuousBatchingServer(**kwargs)
    hot.load_adapter("ft", adapter, LORA)
    assert hot.adapters_loaded == ["ft"] and hot.adapter_cold_loads == 1
    assert serve(hot, "g", "ft").tokens == serve(static, "w", "ft").tokens
    live = DecodeRequest("l", prompt.copy(), 12, adapter="ft")
    hot.submit(live)
    hot.step()
    with pytest.raises(ValueError, match="adapter_busy"):
        hot.load_adapter("ft", adapter)
    hot.run_until_drained()
    hot.load_adapter("ft2", other)
    assert hot.adapters_loaded == ["ft", "ft2"]
    stack = hot._lora_shared["layers"][0]["wq"]["a"]
    version = hot._lora_version
    hot.unload_adapter("ft")
    assert hot.adapters_loaded == ["ft2"]
    assert serve(hot, "r", "ft", 4).error == "unknown_adapter"
    hot.load_adapter("ft3", other)          # recycles index 1 in place
    assert hot._lora_shared["layers"][0]["wq"]["a"] is stack
    assert hot._lora_version == version
    reloaded = ContinuousBatchingServer(adapters={"ft2": other},
                                        lora_config=LORA, **kwargs)
    want = serve(reloaded, "w2", "ft2").tokens
    assert serve(hot, "g2", "ft2").tokens == want
    assert serve(hot, "g3", "ft3").tokens == want


def test_hot_replace_invalidates_prefix_cache():
    old, new = _adapter(18), _adapter(19)
    kwargs = dict(config_name=CONFIG, slots=1, max_seq=96, chunk_steps=4,
                  seed=10, block_size=16, enable_prefix_cache=True,
                  device="cpu", lora_config=LORA)
    server = PagedContinuousServer(adapters={"ft": old}, **kwargs)
    prompt = _prompts([(40,)], seed=57)[0]

    def run(target, rid):
        request = DecodeRequest(rid, prompt.copy(), 5, adapter="ft")
        target.submit(request)
        target.run_until_drained()
        return request

    run(server, "warm")
    server.load_adapter("ft", new)
    refreshed = run(server, "after")
    assert server.prefix_hits == 0
    oracle = PagedContinuousServer(adapters={"ft": new}, **kwargs)
    assert refreshed.tokens == run(oracle, "w").tokens


def test_failed_first_load_does_not_wedge_config():
    config = llama.CONFIGS[CONFIG]
    server = ContinuousBatchingServer(config_name=CONFIG, slots=1,
                                      max_seq=64, chunk_steps=2,
                                      device="cpu")
    bad_config = lora.LoRAConfig(rank=4, targets=("wq", "w_gate"))
    with pytest.raises(ValueError, match="attention targets"):
        server.load_adapter("bad", lora.init_lora_params(
            config, bad_config, device="cpu"), bad_config)
    server.load_adapter("good", _adapter(1), LORA)
    assert server.adapters_loaded == ["good"]


def test_load_adapter_no_config_shape_verified():
    """A load without a config asserts the server's; a wrong-shaped
    adapter still fails by name, and a mismatched config is refused."""
    server = ContinuousBatchingServer(config_name=CONFIG, slots=1,
                                      max_seq=64, device="cpu",
                                      adapters={"a": _adapter(2)},
                                      lora_config=LORA)
    server.load_adapter("b", _adapter(3))
    wrong = lora.init_lora_params(llama.CONFIGS[CONFIG],
                                  lora.LoRAConfig(rank=2), device="cpu")
    with pytest.raises(ValueError, match="factor shapes"):
        server.load_adapter("c", wrong)
    with pytest.raises(ValueError, match="does not match"):
        server.load_adapter("d", _adapter(4),
                            lora.LoRAConfig(rank=4, alpha=16.0,
                                            targets=("wq", "wv")))
    assert server.adapters_loaded == ["a", "b"]


def _peft_dir(tmp_path, name, config_json, tensors):
    import safetensors.numpy
    path = tmp_path / name
    path.mkdir()
    safetensors.numpy.save_file(tensors,
                                str(path / "adapter_model.safetensors"))
    (path / "adapter_config.json").write_text(json.dumps(config_json))
    return str(path)


def test_import_lora_partial_layers(tmp_path):
    config = llama.CONFIGS[CONFIG]
    rng = np.random.default_rng(3)
    base = "base_model.model.model.layers.0.self_attn.q_proj."
    tensors = {
        base + "lora_A.weight": rng.standard_normal(
            (4, config.d_model)).astype(np.float32),
        base + "lora_B.weight": rng.standard_normal(
            (config.n_heads * config.head_dim, 4)).astype(np.float32)}
    path = _peft_dir(tmp_path, "partial",
                     {"peft_type": "LORA", "r": 4, "lora_alpha": 8,
                      "target_modules": ["q_proj"]}, tensors)
    params, lora_config = import_weights.import_lora(path, config)
    assert lora_config == lora.LoRAConfig(rank=4, alpha=8.0,
                                          targets=("wq",))
    assert not params["layers"][1]["wq"]["a"].any()
    assert not params["layers"][1]["wq"]["b"].any()
    np.testing.assert_array_equal(params["layers"][0]["wq"]["a"].numpy(),
                                  tensors[base + "lora_A.weight"].T)


def test_import_lora_rejects_unsupported_peft_options(tmp_path):
    config = llama.CONFIGS[CONFIG]
    for index, option in enumerate(("use_rslora", "use_dora")):
        path = _peft_dir(tmp_path, f"opt{index}",
                         {"r": 4, "target_modules": ["q_proj"],
                          option: True}, {"x": np.zeros(1, np.float32)})
        with pytest.raises(ValueError, match=option):
            import_weights.import_lora(path, config)
    path = _peft_dir(tmp_path, "mod", {"r": 4, "target_modules": ["fc9"]},
                     {"x": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="fc9"):
        import_weights.import_lora(path, config)
    with pytest.raises(FileNotFoundError):
        import_weights.import_lora(str(tmp_path / "missing"), config)


def test_import_lora_raises_naming_safetensors_when_absent(tmp_path,
                                                           monkeypatch):
    """``safetensors`` is imported inside ``import_lora`` alone: with the
    package hidden the port still imports, and the call raises naming
    it."""
    path = _peft_dir(tmp_path, "a", {"r": 4, "target_modules": ["q_proj"]},
                     {"x": np.zeros(1, np.float32)})
    monkeypatch.setitem(sys.modules, "safetensors", None)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="safetensors"):
        import_weights.import_lora(path, llama.CONFIGS[CONFIG])


def test_unload_refused_while_prefilling_or_queued():
    server = ContinuousBatchingServer(
        config_name=CONFIG, slots=1, max_seq=128, chunk_steps=2, seed=9,
        chunk_prefill_tokens=16, device="cpu", adapters={"ft": _adapter(17)},
        lora_config=LORA)
    long_prompt = _prompts([(60,)], seed=53)[0]
    server.submit(DecodeRequest("p", long_prompt, 4, adapter="ft"))
    server.submit(DecodeRequest("q", long_prompt.copy(), 4, adapter="ft"))
    server.step()
    assert server._prefilling
    with pytest.raises(ValueError, match="adapter_busy"):
        server.unload_adapter("ft")
    server.run_until_drained()
    server.unload_adapter("ft")
    assert server.adapters_loaded == []


# --------------------------------------------------------------------------- #
# The wire


def _wire_rig(name, server):
    transport.reset_brokers()
    engine = runtime.EventEngine(clock=runtime.VirtualClock())
    process = runtime.Process(namespace="test", hostname="h", pid="2",
                              engine=engine, broker=name)
    replica = runtime.compose_instance(ContinuousReplica,
                                       runtime.actor_args(name),
                                       process=process, server=server)
    return engine, process, replica


def _pump(engine, predicate, limit=4000):
    for _ in range(limit):
        if predicate():
            return True
        engine.advance(0.001)
    return predicate()


def test_adapter_load_unload_over_wire(tmp_path):
    """``(adapter_load …)`` with a PEFT path and with packed factor bytes
    deploys to a running replica, requests use it at once and equal a
    construction-time server's, the share lists the names, and
    ``(adapter_unload …)`` removes one; a failed command answers with an
    error."""
    jcfg = jax_llama.CONFIGS[CONFIG]
    adapter = _noisy_adapter(jcfg, jax.random.PRNGKey(31))
    checkpoint = str(tmp_path / "peft")
    export_lora_checkpoint(adapter, JAX_LORA, jcfg, checkpoint)
    packed = lora_paged.pack_adapter(llama.CONFIGS[CONFIG], LORA,
                                     _np(adapter))
    server = ContinuousBatchingServer(config_name=CONFIG, slots=2,
                                      max_seq=64, chunk_steps=2,
                                      device="cpu")
    engine, process, replica = _wire_rig("adapters", server)
    events = []

    def handler(_topic, payload):
        command, params = sexpr.parse(payload)
        events.append((command, str(params[0]),
                       codec.decode_swag(params[1])))
    process.add_message_handler(handler, "test/responses")

    def send(command, rid, swag):
        process.message.publish(replica.topic_in, sexpr.generate(
            command, [rid, "test/responses", codec.encode_swag(swag)]))

    send("adapter_load", "a1", {"name": "peft", "path": checkpoint})
    send("adapter_load", "a2", {"name": "bytes", "packed": packed})
    prompt = _prompts([(9,)], seed=3)[0]
    send("infer", "i1", {"tokens": prompt, "max_new_tokens": 5,
                         "adapter": "peft"})
    send("infer", "i2", {"tokens": prompt, "max_new_tokens": 5,
                         "adapter": "bytes"})
    assert _pump(engine, lambda: len(events) >= 4)
    send("adapter_unload", "a3", {"name": "peft"})
    send("adapter_unload", "a4", {"name": "nope"})
    assert _pump(engine, lambda: len(events) >= 6)
    by_id = {rid: (command, out) for command, rid, out in events}
    assert by_id["a1"][1]["ok"] == "peft" and by_id["a2"][1]["ok"] == "bytes"
    assert "error" in by_id["a4"][1]
    static = ContinuousBatchingServer(
        config_name=CONFIG, params=server.params, slots=1, max_seq=64,
        device="cpu", adapters={"x": _np(adapter)}, lora_config=LORA)
    want = DecodeRequest("w", prompt.copy(), 5, adapter="x")
    static.submit(want)
    static.run_until_drained()
    for rid in ("i1", "i2"):
        assert list(np.asarray(by_id[rid][1]["tokens_out"])) == want.tokens
    assert server.adapters_loaded == ["bytes"]
    assert replica.share["adapters"] == "bytes"
    transport.reset_brokers()


def test_client_load_adapter(tmp_path):
    """tests/test_infer_client.py:75 on the port: ``client.load_adapter``
    / ``unload_adapter`` resolve as futures and the adapter serves."""
    jcfg = jax_llama.CONFIGS[CONFIG]
    checkpoint = str(tmp_path / "adapter")
    export_lora_checkpoint(_noisy_adapter(jcfg, jax.random.PRNGKey(31)),
                           JAX_LORA, jcfg, checkpoint)
    server = ContinuousBatchingServer(config_name=CONFIG, slots=2,
                                      max_seq=64, chunk_steps=2,
                                      device="cpu")
    engine, process, replica = _wire_rig("cli4", server)
    client = port_client.InferClient(process, replica.topic_in)
    loaded = client.load_adapter("ft", checkpoint)
    assert _pump(engine, lambda: loaded.done)
    assert loaded.error is None and server.adapters_loaded == ["ft"]
    tuned = client.submit(np.arange(1, 9, dtype=np.int32),
                          max_new_tokens=5, adapter="ft")
    assert _pump(engine, lambda: tuned.done) and tuned.error is None
    gone = client.unload_adapter("ft")
    assert _pump(engine, lambda: gone.done)
    assert gone.error is None and server.adapters_loaded == []
    missing = client.unload_adapter("nope")
    assert _pump(engine, lambda: missing.done)
    assert missing.error is not None
    transport.reset_brokers()


# --------------------------------------------------------------------------- #
# Adapter pages (tests/test_multitenant.py)


def _composed(**kwargs):
    return PagedContinuousServer(config_name=CONFIG, device="cpu",
                                 **dict(COMPOSED, **kwargs))


def test_heterogeneous_batch_matches_merged_oracle_composed_f32():
    """One mixed base + 3-tenant batch with int8 KV, chunked admission and
    the prefix cache equals per-request merged-weights serving and the JAX
    server's tokens; a second wave hits each tenant's own chains and
    repeats the first exactly."""
    tenants = {f"tenant-{i}": _noisy_adapter(jax_llama.CONFIGS[CONFIG],
                                             jax.random.PRNGKey(40 + i))
               for i in range(3)}
    jax_server, server = _pair("paged", adapters=tenants,
                               **dict(COMPOSED, seed=5))
    rng = np.random.default_rng(19)
    shared = rng.integers(1, 1024, 32).astype(np.int32)
    specs = []
    for i, adapter in enumerate([None] + sorted(tenants)):
        tail = rng.integers(1, 1024, 9 + i).astype(np.int32)
        specs.append((np.concatenate([shared, tail]), 5 + i, adapter))

    def drain(target, module):
        requests = [module.DecodeRequest(f"r{i}", prompt.copy(), new,
                                         adapter=adapter)
                    for i, (prompt, new, adapter) in enumerate(specs)]
        for request in requests:
            target.submit(request)
        target.run_until_drained()
        return [list(r.tokens) for r in requests]

    port_module = sys.modules[ContinuousBatchingServer.__module__]
    got = drain(server, port_module)
    assert drain(server, port_module) == got
    assert server.stats()["prefix_hits"] > 0
    assert got == drain(jax_server, jax_continuous)
    for (prompt, new, adapter), tokens in zip(specs, got):
        params = server.params
        if adapter is not None:
            params = lora.merge_lora(params,
                                     params_from_numpy(_np(tenants[adapter])),
                                     LORA)
        oracle = _composed(params=params)
        request = DecodeRequest("o", prompt.copy(), new)
        oracle.submit(request)
        oracle.run_until_drained()
        assert request.tokens == tokens


def test_adapter_pages_demote_restore_bitwise_under_shared_clock(tmp_path):
    """Adapter pages ride the shared eviction clock through host and disk:
    the packed bytes BIT-identical after full demotion, the stats' page
    counts exact, and the warm reload serves the pre-demotion tokens."""
    server = _composed(host_tier_blocks=1, spill_dir=str(tmp_path / "spill"))
    server.load_adapter("acme", _adapter(3), LORA)
    pages = server._adapter_page_counts()
    assert pages["hbm"] > 0 and pages["host"] == pages["disk"] == 0
    assert server.adapter_residency("acme") == 0
    stats = server.stats()
    assert (stats["adapter_pages_hbm"], stats["adapter_cold_loads"],
            stats["adapters_loaded_count"]) == (pages["hbm"], 1, 1)
    golden = server.fetch_adapter_bytes("acme")
    np.testing.assert_array_equal(
        golden, lora_paged.pack_adapter(server.config, LORA, _adapter(3)))
    prompt = _prompts([(21,)], seed=29)[0]
    request = DecodeRequest("warm", prompt, 6, adapter="acme")
    server.submit(request)
    server.run_until_drained()
    total = sum(server._adapter_page_counts().values())
    server.unload_adapter("acme")
    while server._evict_one():
        pass
    pages = server._adapter_page_counts()
    assert pages["hbm"] == 0 and pages["host"] + pages["disk"] == total
    assert pages["disk"] > 0 and server.adapter_residency("acme") in (1, 2)
    assert np.array_equal(server.fetch_adapter_bytes("acme"), golden)
    server.load_adapter("acme")
    assert server.adapter_warm_loads == 1
    replay = DecodeRequest("replay", prompt.copy(), 6, adapter="acme")
    server.submit(replay)
    server.run_until_drained()
    assert replay.tokens == request.tokens
    # Every page spilled, a fresh server over the directory adopts them
    # under their seed and warm-loads: a crash restart is a warm start
    # for adapters too.
    spiller = _composed(spill_dir=str(tmp_path / "spill2"))
    spiller.load_adapter("acme", _adapter(3), LORA)
    while spiller._evict_one():
        pass
    assert spiller._adapter_page_counts()["disk"] == total
    adopter = _composed(spill_dir=str(tmp_path / "spill2"))
    assert {adopter._key_seed.get(key) for key in
            kvadapters.adapter_chain_keys("acme", total)} == {ADAPTER_SEED}
    assert np.array_equal(adopter.fetch_adapter_bytes("acme"), golden)
    adopter.load_adapter("acme")
    assert adopter.adapter_warm_loads == 1


def test_warm_load_without_paged_copy_raises_adapter_cold():
    server = _composed()
    with pytest.raises(KeyError, match="adapter_cold"):
        server.load_adapter("ghost")
    server.load_adapter("real", _adapter(8), LORA)
    fresh = _adapter(9)
    server.load_adapter("real", fresh, LORA)
    restacked, _config = server._fetch_adapter_pages("real")
    np.testing.assert_array_equal(
        restacked["layers"][0]["wq"]["b"].numpy(),
        fresh["layers"][0]["wq"]["b"])


def test_adapter_pages_export_import_and_warm_load_cross_replica():
    """The owner's pages export flagged ``kv_adapter``, import under
    ``ADAPTER_SEED`` on a replica that never saw the factors (the JAX
    package's importer too), and that replica warm-loads and serves the
    owner's exact tokens; the digest advertises one flagged root."""
    owner = _composed()
    owner.load_adapter("acme", _adapter(6), LORA)
    n_pages = owner._adapter_page_counts()["hbm"]
    entries = kvdir.digest_decode(owner.prefix_digest())[2]
    assert [(e[0], e[1]) for e in entries if e[7]] == \
        [(kvadapters.adapter_hex("acme"), 1)]
    keys_hex = [key.hex()[:kvdir.HEX_KEY_CHARS]
                for key in kvadapters.adapter_chain_keys("acme", n_pages)]
    payload = owner.kv_export_payload(keys_hex, 0)
    assert payload is not None and payload["kv_adapter"] == 1
    importer = _composed()
    assert importer.kv_import_payload(payload) == n_pages
    assert {importer._key_seed[key] for key in kvadapters.adapter_chain_keys(
        "acme", n_pages)} == {ADAPTER_SEED}
    assert np.array_equal(importer.fetch_adapter_bytes("acme"),
                          owner.fetch_adapter_bytes("acme"))
    importer.load_adapter("acme")
    assert importer.adapter_warm_loads == 1
    prompt = _prompts([(17,)], seed=31)[0]
    tokens = []
    for server in (owner, importer):
        request = DecodeRequest("x", prompt.copy(), 7, adapter="acme")
        server.submit(request)
        server.run_until_drained()
        tokens.append(request.tokens)
    assert tokens[0] == tokens[1]
    # The pages cross backends: the JAX package's server takes the port's
    # export and restacks the same factors from it.
    jserver = jax_paged.PagedContinuousServer(config_name=CONFIG, seed=5,
                                              **COMPOSED)
    assert jserver.kv_import_payload(payload) == n_pages
    restacked, config = jserver._fetch_adapter_pages("acme")
    assert config == JAX_LORA
    np.testing.assert_array_equal(
        np.asarray(restacked["layers"][1]["wv"]["a"]),
        _adapter(6)["layers"][1]["wv"]["a"])


# --------------------------------------------------------------------------- #
# run_multitenant


def test_multitenant_payloads_and_tenants_match_jax():
    mine = loadgen.multitenant_payloads(seed=3)
    theirs = jax_loadgen.multitenant_payloads(seed=3)
    for index in range(9):
        a, b = mine(index), theirs(index)
        assert a["adapter"] == b["adapter"]
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    ours = loadgen._noisy_loadgen_adapter(llama.CONFIGS["tiny"], LORA, 100)
    ref = jax_loadgen._noisy_loadgen_adapter(jax_llama.CONFIGS["tiny"],
                                             JAX_LORA, 100)
    for layer, jlayer in zip(ours["layers"], ref["layers"]):
        for target in LORA.targets:
            for key in ("a", "b"):
                np.testing.assert_array_equal(layer[target][key],
                                              jlayer[target][key])


@pytest.fixture()
def _rig_ready(monkeypatch):
    """One intra-op thread (a shared CPU slows the tiny steps ~100-fold
    otherwise) and a short uncontested registrar election."""
    from aiko_services_tpu_torch.registry import registrar
    monkeypatch.setattr(registrar, "PRIMARY_SEARCH_TIMEOUT", 0.05)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    transport.reset_brokers()
    yield
    torch.set_num_threads(threads)
    transport.reset_brokers()


def test_run_multitenant_aware_against_blind(_rig_ready, jax_params):
    """The aware arm routes every tenant warm (0 cold starts, a warm route
    a completion); the blind arm pays cold starts.  Every aware final (f32
    ``tiny`` on the JAX weights) equals a batch-1 oracle under its
    tenant's merged weights."""
    serving = dict(n_requests=10, rate_hz=50.0, warmup_requests=4,
                   config_name=CONFIG, device="cpu")
    aware = loadgen.run_multitenant(params=_bridge(jax_params), **serving)
    blind = loadgen.run_multitenant(params=_bridge(jax_params),
                                    adapter_aware=False, **serving)
    assert aware.adapter_cold_starts == 0 and aware.lost == 0
    assert aware.adapter_warm_routes >= aware.completed == 10
    assert blind.adapter_cold_starts > 0
    assert aware.server_stats["adapter_pages_hbm"] > 0
    config = llama.CONFIGS[CONFIG]
    base = _bridge(jax_params)
    payload_fn = loadgen.multitenant_payloads()
    for request_id, tokens in aware.final_tokens.items():
        tenant = aware.final_adapters[request_id]
        merged = lora.merge_lora(base, params_from_numpy(
            loadgen._noisy_loadgen_adapter(
                config, LORA, 100 + int(tenant.split("-")[1]))), LORA)
        oracle = ContinuousBatchingServer(config_name=CONFIG, params=merged,
                                          slots=1, max_seq=64, device="cpu")
        prompt = payload_fn(int(request_id.rsplit("_", 1)[1]))["tokens"]
        assert tokens == reference_greedy(oracle, prompt, 4)
