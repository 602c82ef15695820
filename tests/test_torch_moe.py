"""Port parity: mixture-of-experts (``aiko_services_tpu_torch.models.moe``
and the MoE layers of every llama forward and both servers) against the
JAX package, on the CPU.

Configs: ``moe_tiny`` (4 experts, cf 2.0 = E/k, drop-free), ``moe_tiny8``
(8 experts, cf 4.0) and a drop-prone ``moe_tiny`` at cf 1.0, each as an
f32 copy registered in both config tables.  Weights are the JAX package's
``init_params`` tree (int8 / int4 through its ``quantize_params``),
bridged as numpy.  f32 logits within rtol = atol = 1e-4 (the dense parity
tests' bound: summation order), greedy tokens equal; bf16 logits within
0.05 absolute (about three bf16 ulps at magnitude ~3, as the dense bf16
test) with the argmax equal almost everywhere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.models import lora as jax_lora
from aiko_services_tpu.models import moe as jax_moe
from aiko_services_tpu.orchestration import continuous as jax_continuous
from aiko_services_tpu.orchestration import paged as jax_paged
from aiko_services_tpu_torch import runtime, transport
from aiko_services_tpu_torch.models import llama, lora, moe
from aiko_services_tpu_torch.models.bridge import (params_from_numpy,
                                                   tensor_from_numpy)
from aiko_services_tpu_torch.orchestration import serving
from aiko_services_tpu_torch.orchestration.continuous import (
    ContinuousBatchingServer, DecodeRequest)
from aiko_services_tpu_torch.orchestration.paged import PagedContinuousServer
from aiko_services_tpu_torch.pipeline import codec
from aiko_services_tpu_torch.utils import sexpr

#: name -> (base config, overrides): f32 copies registered in both tables.
MOE_CONFIGS = {
    "moe_tiny_f32": ("moe_tiny", {}),
    "moe_tiny8_f32": ("moe_tiny8", {}),
    "moe_drop_f32": ("moe_tiny", {"moe_capacity_factor": 1.0}),
}
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_cold():
    """Later test modules in the same worker count their own JAX
    compiles; drop what this module compiled once it is done."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _f32_moe(monkeypatch):
    for name, (base, extra) in MOE_CONFIGS.items():
        monkeypatch.setitem(jax_llama.CONFIGS, name, dataclasses.replace(
            jax_llama.CONFIGS[base], dtype=jnp.float32, **extra))
        monkeypatch.setitem(llama.CONFIGS, name, dataclasses.replace(
            llama.CONFIGS[base], dtype=torch.float32, **extra))
    monkeypatch.setitem(
        jax_llama.CONFIGS, "tiny_f32",
        dataclasses.replace(jax_llama.CONFIGS["tiny"], dtype=jnp.float32))
    monkeypatch.setitem(
        llama.CONFIGS, "tiny_f32",
        dataclasses.replace(llama.CONFIGS["tiny"], dtype=torch.float32))


@pytest.fixture(autouse=True)
def _port_side_isolated():
    transport.reset_brokers()
    yield
    transport.reset_brokers()


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


_WEIGHTS = {}


def _weights(name, bits=0, seed=0):
    """The JAX package's weights for ``name`` (int8 / int4 when ``bits``)
    and the port's bridged copy; cached a module."""
    key = (name, bits, seed)
    if key not in _WEIGHTS:
        params = jax_llama.init_params(jax_llama.CONFIGS[name],
                                       jax.random.PRNGKey(seed))
        if bits:
            params = jax_llama.quantize_params(params, bits=bits)
        _WEIGHTS[key] = (params, _bridge(params))
    return _WEIGHTS[key]


def _tokens(shape, seed, vocab=1024):
    return np.random.default_rng(seed).integers(1, vocab, shape) \
        .astype(np.int32)


# --------------------------------------------------------------------------- #
# models/moe.py

@pytest.mark.parametrize("capacity", [1, 3, 12])
def test_top_k_gating_matches_jax(capacity):
    """Dispatch one-hots equal and combine weights within 1e-6, from full
    capacity down to one slot an expert (ranks past it dropped)."""
    logits = np.random.default_rng(capacity).standard_normal((12, 4)) \
        .astype(np.float32) * 2
    want = jax_moe.top_k_gating(jnp.asarray(logits), 2, capacity)
    got = moe.top_k_gating(torch.from_numpy(logits), 2, capacity)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
    assert got[0].sum() == min(24, 4 * capacity)


@pytest.mark.parametrize("cf", [2.0, 1.0])
def test_moe_ffn_matches_jax_and_the_per_token_oracle(cf):
    """``moe_ffn`` on the JAX ``init_moe_params`` weights: within 1e-4 of
    JAX ``moe_ffn`` and of both packages' per-token oracles, drop-free
    (cf 2.0 = E/k) and drop-prone (cf 1.0)."""
    config = jax_moe.MoEConfig(d_model=32, d_ff=64, n_experts=4, top_k=2,
                               capacity_factor=cf, dtype=jnp.float32)
    port_config = moe.MoEConfig(d_model=32, d_ff=64, n_experts=4, top_k=2,
                                capacity_factor=cf, dtype=torch.float32)
    params = jax_moe.init_moe_params(config, jax.random.PRNGKey(0))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 16, 32),
                                     jnp.float32))
    want = np.asarray(jax_moe.moe_ffn(params, jnp.asarray(x), config))
    port_params = _bridge(params)
    got = moe.moe_ffn(port_params, torch.from_numpy(x), port_config)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), jax_moe.moe_ffn_reference(params, jnp.asarray(x),
                                               config), **TOL)
    np.testing.assert_allclose(
        got.numpy(), moe.moe_ffn_reference(port_params, torch.from_numpy(x),
                                           port_config), **TOL)
    assert moe.capacity(port_config, 32) == max(1, int(cf * 32 * 2 / 4))


def test_moe_capacity_drop_passthrough():
    """tests/test_models.py:782 on the port: at cf 0.25 most tokens drop
    (their rows exactly 0), and the output equals the JAX package's."""
    config = jax_moe.MoEConfig(d_model=16, d_ff=32, n_experts=2, top_k=1,
                               capacity_factor=0.25, dtype=jnp.float32)
    port_config = moe.MoEConfig(d_model=16, d_ff=32, n_experts=2, top_k=1,
                                capacity_factor=0.25, dtype=torch.float32)
    params = jax_moe.init_moe_params(config, jax.random.PRNGKey(4))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (1, 32, 16),
                                     jnp.float32))
    want = np.asarray(jax_moe.moe_ffn(params, jnp.asarray(x), config))
    got = moe.moe_ffn(_bridge(params), torch.from_numpy(x),
                      port_config).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got).all()
    zero_rows = (np.abs(got[0]).sum(-1) == 0).sum()
    assert zero_rows == (np.abs(want[0]).sum(-1) == 0).sum() > 0


def test_init_and_specs():
    """The port's own draw has the reference layout; expert sharding
    raises naming its item."""
    config = llama.CONFIGS["moe_tiny"]
    params = llama.init_params(config, seed=0, device="cpu")
    layer = params["layers"][0]
    assert "w_gate" not in layer
    shapes = {key: tuple(value.shape) for key, value in layer["moe"].items()}
    assert shapes == {"router": (128, 4), "w_gate": (4, 128, 352),
                      "w_up": (4, 128, 352), "w_down": (4, 352, 128)}
    with pytest.raises(NotImplementedError, match="item 11"):
        moe.moe_param_specs()
    with pytest.raises(NotImplementedError, match="MoE expert"):
        llama.random_quantized_params(config, device="cpu")


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_router_trees(bits):
    """The 2-D router quantizes ({"q"} / {"q4"}); the 3-D experts stay in
    the model dtype, the same tensors in the int8 and int4 trees; the
    tree equals the JAX package's, bit for bit."""
    name = "moe_tiny_f32"
    jax_params, _ = _weights(name, bits)
    _, dense = _weights(name)
    got = llama.quantize_params(dense, bits=bits)
    router = got["layers"][0]["moe"]["router"]
    assert ("q4" if bits == 4 else "q") in router
    assert got["layers"][0]["moe"]["w_gate"] is \
        dense["layers"][0]["moe"]["w_gate"]
    want = jax_params["layers"][0]["moe"]["router"]
    for key, value in router.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[key]))


# --------------------------------------------------------------------------- #
# models/llama.py: every forward

@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("name", sorted(MOE_CONFIGS))
def test_forward_logits_f32(name, bits):
    """Full-sequence logits within 1e-4, dense, int8 and int4 routers
    (tests/test_models.py:271, :820)."""
    jax_params, params = _weights(name, bits)
    tokens = _tokens((2, 12), 1)
    want = jax_llama.forward(jax_params, jnp.asarray(tokens),
                             jax_llama.CONFIGS[name], use_flash=False)
    got = llama.forward(params, torch.from_numpy(tokens), llama.CONFIGS[name])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_forward_within_bound():
    """bf16 moe_tiny: logits within 0.05 absolute and the argmax equal
    at >= 90 % of positions (the dense bf16 bound)."""
    jax_params = jax_llama.init_params(jax_llama.CONFIGS["moe_tiny"],
                                       jax.random.PRNGKey(4))
    tokens = _tokens((2, 16), 5)
    want = np.asarray(jax_llama.forward(jax_params, jnp.asarray(tokens),
                                        jax_llama.CONFIGS["moe_tiny"]))
    got = llama.forward(_bridge(jax_params), torch.from_numpy(tokens),
                        llama.CONFIGS["moe_tiny"]).numpy()
    assert np.abs(got - want).max() < 0.05
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("name", ["moe_tiny_f32", "moe_tiny8_f32"])
def test_prefill_decode_match_forward_and_jax(name):
    """tests/test_models.py:797, :935 on the port: prefill + cached decode
    agree with the full forward (drop-free routing is per token), and each
    step's logits with JAX's within 1e-4."""
    jax_config, config = jax_llama.CONFIGS[name], llama.CONFIGS[name]
    jax_params, params = _weights(name, seed=21)
    tokens = _tokens((2, 10), 22)
    full = llama.forward(params, torch.from_numpy(tokens), config).numpy()
    cache = llama.init_cache(config, 2, 16, device="cpu")
    jax_cache = jax_llama.init_cache(jax_config, 2, 16)
    logits, cache = llama.prefill(params, torch.from_numpy(tokens[:, :6]),
                                  cache, config)
    want, jax_cache = jax_llama.prefill(jax_params, jnp.asarray(tokens[:, :6]),
                                        jax_cache, jax_config)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, 5], **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    for step in range(6, 10):
        logits, cache = llama.decode_step(
            params, torch.from_numpy(tokens[:, step:step + 1]), cache, step,
            config)
        want, jax_cache = jax_llama.decode_step(
            jax_params, jnp.asarray(tokens[:, step:step + 1]), jax_cache,
            jnp.int32(step), jax_config)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, step],
                                   **TOL)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(MOE_CONFIGS))
def test_chunked_forwards_match_jax(name):
    """``prefill_chunk`` then ``verify_chunk_ragged`` (per-row starts, one
    row inactive) on a contiguous cache: logits within 1e-4 of JAX's."""
    jax_config, config = jax_llama.CONFIGS[name], llama.CONFIGS[name]
    jax_params, params = _weights(name, seed=3)
    prompt = _tokens((2, 16), 7)
    cache = llama.init_cache(config, 2, 32, device="cpu")
    jax_cache = jax_llama.init_cache(jax_config, 2, 32)
    got, cache = llama.prefill_chunk(params, torch.from_numpy(prompt), cache,
                                     0, config)
    want, jax_cache = jax_llama.prefill_chunk(
        jax_params, jnp.asarray(prompt), jax_cache, jnp.int32(0), jax_config)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    window = _tokens((2, 4), 8)
    positions = np.array([16, 12], np.int32)
    active = np.array([True, False])
    got, cache = llama.verify_chunk_ragged(
        params, torch.from_numpy(window), cache, torch.from_numpy(positions),
        torch.from_numpy(active), config)
    want, jax_cache = jax_llama.verify_chunk_ragged(
        jax_params, jnp.asarray(window), jax_cache, jnp.asarray(positions),
        jnp.asarray(active), jax_config)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], **TOL)


@pytest.mark.parametrize("name", ["moe_tiny_f32", "moe_drop_f32"])
def test_paged_forwards_match_jax(name):
    """``prefill_append_paged`` (two slices), ``serve_chunk_mixed`` (a
    slice for slot 1 while slot 0 decodes) and ``verify_chunk_paged``:
    logits within 1e-4 and tokens equal to JAX's."""
    jax_config, config = jax_llama.CONFIGS[name], llama.CONFIGS[name]
    jax_params, params = _weights(name, seed=1)
    jax_pool = jax_llama.init_paged_cache(jax_config, 9, 16)
    pool = llama.init_paged_cache(config, 9, 16, device="cpu")
    prompt = _tokens((2, 32), 2)
    tables = np.array([[3, 1, 4, 0], [5, 6, 0, 0]], np.int32)
    for start, width in ((0, 16), (16, 16)):
        chunk = prompt[:1, start:start + width]
        want, jax_pool = jax_llama.prefill_append_paged(
            jax_params, jnp.asarray(chunk), jax_pool, jnp.asarray(tables[:1]),
            jnp.int32(start), jax_config, kv_limit=4)
        got, pool = llama.prefill_append_paged(
            params, torch.from_numpy(chunk), pool,
            torch.from_numpy(tables[:1]), start, config, kv_limit=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    state = dict(token=np.array([[prompt[0, -1]], [0]], np.int32),
                 positions=np.array([31, 0], np.int32),
                 active=np.array([True, False]),
                 remaining=np.array([4, 0], np.int32),
                 temps=np.zeros(2, np.float32), tops=np.ones(2, np.float32),
                 tables=tables)
    jax_out = jax_llama.serve_chunk_mixed(
        jax_params, {key: jnp.asarray(val) for key, val in state.items()},
        jax_pool, jnp.asarray(prompt[1:, :16]), jnp.int32(1), jnp.int32(0),
        4, jax_config, prefill_kv_limit=2)
    out = llama.serve_chunk_mixed(
        params, {key: torch.from_numpy(val) for key, val in state.items()},
        pool, torch.from_numpy(prompt[1:, :16]), 1, 0, 4, config,
        prefill_kv_limit=2)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jax_out[0]))
    window = np.concatenate([out[0].numpy()[:, -1:], _tokens((2, 3), 9)],
                            axis=1)
    positions = np.array([35, 16], np.int32)
    active = np.array([True, True])
    want, _ = jax_llama.verify_chunk_paged(
        jax_params, jnp.asarray(window), jax_out[3], jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(active), jax_config)
    got, _ = llama.verify_chunk_paged(
        params, torch.from_numpy(window), out[3], torch.from_numpy(tables),
        torch.from_numpy(positions), torch.from_numpy(active), config)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------- #
# Both servers

def _jax_greedy(name, params, prompt, max_new):
    """JAX ``reference_greedy``: batch-1 prefill + generate_tokens."""
    config = jax_llama.CONFIGS[name]
    cache = jax_llama.init_cache(config, 1, 128)
    logits, cache = jax_llama.prefill(params, jnp.asarray(prompt)[None],
                                      cache, config)
    first = logits[:, -1].argmax(-1).astype(jnp.int32)[:, None]
    out = [int(first[0, 0])]
    if max_new > 1:
        generated, _ = jax_llama.generate_tokens(
            params, first, cache, jnp.int32(len(prompt)), max_new - 1,
            config)
        out += [int(t) for t in np.asarray(generated)[0]]
    return out


def _serve(server, module, specs, seed):
    rng = np.random.default_rng(seed)
    requests = [module(f"r{i}", rng.integers(1, 1024, plen).astype(np.int32),
                       new) for i, (plen, new) in enumerate(specs)]
    for request in requests:
        server.submit(request)
    server.run_until_drained()
    return requests


SERVER_SPECS = [(5, 6), (11, 3), (3, 9), (17, 5)]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("name", ["moe_tiny_f32", "moe_drop_f32"])
def test_servers_match_jax(name, layout):
    """Both servers on the JAX server's weights: tokens equal the JAX
    server's, and (drop-free) the JAX batch-1 oracle's.  Paged: prefix
    cache and 16-token chunked admission, equal block accounting."""
    kwargs = dict(slots=2, max_seq=96, chunk_steps=4, seed=3, ring_max=2)
    if layout == "paged":
        kwargs.update(block_size=16, total_blocks=16, enable_prefix_cache=True,
                      chunk_prefill_tokens=16)
        jax_cls, port_cls = (jax_paged.PagedContinuousServer,
                             PagedContinuousServer)
    else:
        jax_cls, port_cls = (jax_continuous.ContinuousBatchingServer,
                             ContinuousBatchingServer)
    jax_server = jax_cls(config_name=name, **kwargs)
    kwargs.pop("seed")
    port_server = port_cls(config_name=name, params=_bridge(jax_server.params),
                           device="cpu", **kwargs)
    want = _serve(jax_server, jax_continuous.DecodeRequest, SERVER_SPECS, 0)
    got = _serve(port_server, DecodeRequest, SERVER_SPECS, 0)
    for have, ref in zip(got, want):
        assert have.error is None and have.tokens == list(ref.tokens), \
            have.request_id
        if name == "moe_tiny_f32":
            assert have.tokens == _jax_greedy(name, jax_server.params,
                                              have.prompt,
                                              have.max_new_tokens)
    if layout == "paged":
        assert port_server.free_blocks == jax_server.free_blocks
        assert port_server.prefix_hits == jax_server.prefix_hits
        assert port_server.pool_balance()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_moe_target_under_speculation(layout):
    """tests/test_spec_continuous.py:181 on the port, both layouts: a MoE
    target with a dense tiny draft (k 3) gives exactly the plain MoE
    server's greedy tokens, which are the JAX plain server's."""
    name = "moe_tiny_f32"
    jax_params, params = _weights(name, seed=3)
    draft = _bridge(jax_llama.init_params(jax_llama.CONFIGS["tiny_f32"],
                                          jax.random.PRNGKey(5)))
    cls = PagedContinuousServer if layout == "paged" else \
        ContinuousBatchingServer
    extra = dict(block_size=16, total_blocks=24) if layout == "paged" else {}
    specs = [(5, 6), (9, 5), (4, 7)]
    outs = {}
    for tag, spec in (("plain", {}),
                      ("spec", dict(draft_config_name="tiny_f32",
                                    draft_params=draft, spec_k=3))):
        server = cls(config_name=name, params=params, slots=2, max_seq=64,
                     chunk_steps=4, device="cpu", ring_max=2, **extra,
                     **spec)
        outs[tag] = [r.tokens for r in _serve(server, DecodeRequest, specs,
                                              5)]
        if tag == "spec":
            assert server.stats()["spec_rounds"] > 0
    assert outs["plain"] == outs["spec"]
    rng = np.random.default_rng(5)
    for (plen, new), tokens in zip(specs, outs["plain"]):
        prompt = rng.integers(1, 1024, plen).astype(np.int32)
        assert tokens == _jax_greedy(name, jax_params, prompt, new)


# --------------------------------------------------------------------------- #
# LoRA on MoE configs, and the replica over the wire

def test_lora_attention_targets_on_moe():
    """tests/test_lora.py:92 on the port: MLP targets raise on MoE
    configs; an adapter on wq / wv runs through the MoE forward with the
    JAX package's logits (its factors bridged), within 1e-4."""
    name = "moe_tiny_f32"
    config, jax_config = llama.CONFIGS[name], jax_llama.CONFIGS[name]
    with pytest.raises(ValueError, match="MoE"):
        lora.init_lora_params(config, lora.LoRAConfig(targets=("wq",
                                                               "w_gate")),
                              device="cpu")
    jax_params, params = _weights(name)
    spec = jax_lora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv"))
    factors = jax_lora.init_lora_params(jax_config, spec,
                                        jax.random.PRNGKey(9))
    factors = jax.tree.map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.PRNGKey(2),
                                               a.shape, a.dtype), factors)
    tokens = _tokens((1, 10), 4)
    want = jax_llama.forward(jax_lora.merge_lora(jax_params, factors, spec),
                             jnp.asarray(tokens), jax_config, use_flash=False)
    port_spec = lora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv"))
    merged = lora.merge_lora(params, _bridge(factors), port_spec)
    got = llama.forward(merged, torch.from_numpy(tokens), config)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    stacked = {"scale": port_spec.alpha / port_spec.rank,
               "ids": torch.ones((1,), dtype=torch.int64),
               "layers": [{target: {
                   key: torch.stack([torch.zeros_like(value), value])
                   for key, value in layer[target].items()}
                   for target in layer}
                   for layer in _bridge(factors)["layers"]]}
    cache = llama.init_cache(config, 1, 16, device="cpu")
    logits, _ = llama.prefill(params, torch.from_numpy(tokens), cache,
                              config, lora=stacked)
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               np.asarray(want)[:, -1], **TOL)


def test_moe_int8_replica_over_the_wire():
    """tests/test_serving.py:134 on the port: ``make_llama_infer(
    "moe_tiny", quantize=True)`` builds a replica that answers a chat
    request through the router over the loopback wire; on the JAX
    factory's f32 weights (bridged) its tokens equal the JAX factory's."""
    from aiko_services_tpu.orchestration import serving as jax_serving
    from aiko_services_tpu_torch import registry

    engine = runtime.EventEngine(clock=runtime.VirtualClock())

    def process(pid):
        return runtime.Process(namespace="test", hostname="h", pid=str(pid),
                               engine=engine, broker="moellm")

    registry.Registrar(process=process(1))
    engine.advance(4.0)
    name = "moe_tiny_f32"
    jax_params = jax_llama.quantize_params(jax_llama.init_params(
        jax_llama.CONFIGS[name], jax.random.PRNGKey(0)))
    infer = serving.make_llama_infer(name, quantize=True, max_new_tokens=4,
                                     params=_bridge(jax_params), device="cpu")
    runtime.compose_instance(serving.ModelReplica,
                             runtime.actor_args("moe_replica"),
                             process=process(2), infer=infer)
    pr = process(3)
    router = runtime.compose_instance(serving.ReplicaRouter,
                                      runtime.actor_args("router"),
                                      process=pr)
    engine.drain()
    assert router.share["replicas"] == 1
    responses = []

    def on_response(_topic, payload):
        command, params = sexpr.parse(payload)
        if command == "infer_response":
            responses.append((params[0], codec.decode_swag(params[1])))
    pr.add_message_handler(on_response, "test/h/3/client/response")
    prompt = np.arange(1, 7, dtype=np.int32)[None, :]
    pr.message.publish(f"{router.topic_path}/in", sexpr.generate(
        "infer", ["moe1", "test/h/3/client/response",
                  codec.encode_swag({"tokens": prompt})]))
    engine.drain()
    (request_id, outputs), = responses
    assert request_id == "moe1"
    tokens_out = np.asarray(outputs["tokens_out"])
    assert tokens_out.shape == (1, 10) and (tokens_out[:, :6] == prompt).all()
    want = jax_serving.make_llama_infer(name, quantize=True,
                                        max_new_tokens=4)({"tokens": prompt})
    np.testing.assert_array_equal(tokens_out, np.asarray(want["tokens_out"]))


def test_own_random_moe_replica_builds():
    """``make_llama_infer("moe_tiny", quantize=True)`` on the port's own
    random weights (bf16, int8 router) serves finite in-vocabulary
    tokens."""
    infer = serving.make_llama_infer("moe_tiny", quantize=True,
                                     max_new_tokens=3, device="cpu")
    out = infer({"tokens": np.arange(1, 9, dtype=np.int32)[None, :]})
    tokens = np.asarray(out["tokens_out"])
    assert tokens.shape == (1, 11)
    assert ((tokens >= 0) & (tokens < 1024)).all()


def test_bridge_carries_expert_leaves():
    """Bridged 3-D expert leaves and the int8 / int4 router leaves keep
    their shapes, dtypes and bits."""
    for bits in (8, 4):
        jax_params, params = _weights("moe_tiny_f32", bits)
        for key, value in params["layers"][1]["moe"].items():
            want = jax_params["layers"][1]["moe"][key]
            if isinstance(value, dict):
                for leaf in value:
                    np.testing.assert_array_equal(value[leaf].numpy(),
                                                  np.asarray(want[leaf]))
            else:
                assert value.ndim == 3 and value.dtype == torch.float32
                np.testing.assert_array_equal(value.numpy(),
                                              np.asarray(want))
    bf16 = tensor_from_numpy(np.asarray(jax_llama.init_params(
        jax_llama.CONFIGS["moe_tiny"], jax.random.PRNGKey(0))["layers"][0]
        ["moe"]["w_up"]))
    assert bf16.dtype == torch.bfloat16 and bf16.shape == (4, 128, 352)
