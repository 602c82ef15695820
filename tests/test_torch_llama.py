"""Port parity: ``aiko_services_tpu_torch.models.llama`` against the JAX
package's ``models/llama.py`` on the same weights and tokens.

Weights are the JAX package's own ``init_params`` tree (optionally
``quantize_params`` int8), handed to the port as numpy through the weight
bridge; tokens come from ``np.random.default_rng``.  The JAX side runs on
the CPU through its jnp reference paths, as its own tests do; the port
runs on CPU tensors (the plain versions of its kernels).  f32 parity uses
f32 copies of the configs (``dataclasses.replace(..., dtype=f32)``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.models.bridge import (params_from_numpy,
                                                   tensor_to_numpy)

TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_cold():
    """Later test modules in the same worker count their own JAX
    compiles; drop what this module compiled once it is done."""
    yield
    jax.clear_caches()


def _configs(name, dtype=jnp.float32):
    jax_config = dataclasses.replace(jax_llama.CONFIGS[name], dtype=dtype)
    port_config = dataclasses.replace(llama.CONFIGS[name],
                                      dtype=TORCH_DTYPES[dtype])
    return jax_config, port_config


def _weights(jax_config, quantized, seed=0):
    params = jax_llama.init_params(jax_config, jax.random.PRNGKey(seed))
    if quantized:
        params = jax_llama.quantize_params(params)
    numpy_tree = jax.tree.map(np.asarray, params)
    return params, params_from_numpy(numpy_tree, "cpu")


def _tokens(shape, vocab, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("name", ["tiny", "mistral_tiny"])
@pytest.mark.parametrize("quantized", [False, True])
def test_forward_logits_f32(name, quantized):
    """Full-sequence logits within 1e-4 (f32 summation order).  24
    tokens exceed mistral_tiny's 16-token window."""
    jax_config, port_config = _configs(name)
    jax_params, port_params = _weights(jax_config, quantized)
    tokens = _tokens((2, 24), jax_config.vocab_size, 1)
    ref = jax_llama.forward(jax_params, jnp.asarray(tokens), jax_config)
    got = llama.forward(port_params, torch.from_numpy(tokens), port_config)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def _jax_greedy(params, config, prompt, max_new, max_seq, quantize_kv):
    cache = jax_llama.init_cache(config, prompt.shape[0], max_seq,
                                 quantize_kv=quantize_kv)
    logits, cache = jax_llama.prefill(params, jnp.asarray(prompt), cache,
                                      config)
    first = logits[:, -1].argmax(-1).astype(jnp.int32)[:, None]
    tokens, _ = jax_llama.generate_tokens(
        params, first, cache, jnp.int32(prompt.shape[1]), max_new - 1,
        config)
    return (np.asarray(logits),
            np.concatenate([np.asarray(first), np.asarray(tokens)], 1))


def _port_greedy(params, config, prompt, max_new, max_seq, quantize_kv):
    cache = llama.init_cache(config, prompt.shape[0], max_seq,
                             quantize_kv=quantize_kv, device="cpu")
    logits, cache = llama.prefill(params, torch.from_numpy(prompt), cache,
                                  config)
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    tokens, _ = llama.generate_tokens(params, first, cache,
                                      prompt.shape[1], max_new - 1, config)
    return logits.numpy(), torch.cat([first, tokens], 1).numpy()


@pytest.mark.parametrize("name", ["tiny", "mistral_tiny"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("quantize_kv", [False, True])
def test_prefill_generate_greedy_tokens_equal(name, quantized,
                                              quantize_kv):
    """prefill + generate_tokens: last-position logits within 1e-4 and
    the greedy tokens EQUAL, for dense / int8 weights, bf16-layout / int8
    KV and (mistral_tiny) the sliding window across 20 + 10 positions."""
    jax_config, port_config = _configs(name)
    jax_params, port_params = _weights(jax_config, quantized, seed=2)
    prompt = _tokens((2, 20), jax_config.vocab_size, 3)
    ref_logits, ref_tokens = _jax_greedy(jax_params, jax_config, prompt,
                                         10, 64, quantize_kv)
    got_logits, got_tokens = _port_greedy(port_params, port_config, prompt,
                                          10, 64, quantize_kv)
    np.testing.assert_allclose(got_logits, ref_logits, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got_tokens, ref_tokens)


def test_bf16_logits_within_bound():
    """The model dtype itself: bf16 tiny logits, same weights.  The two
    frameworks round bf16 products and sums at different points, so the
    bound is loose: 0.05 absolute on logits of magnitude ~3 (about 3
    bf16 ulps at that magnitude), and the same argmax almost
    everywhere."""
    jax_config, port_config = _configs("tiny", jnp.bfloat16)
    jax_params, port_params = _weights(jax_config, False, seed=4)
    tokens = _tokens((2, 16), jax_config.vocab_size, 5)
    ref = np.asarray(jax_llama.forward(jax_params, jnp.asarray(tokens),
                                       jax_config))
    got = llama.forward(port_params, torch.from_numpy(tokens),
                        port_config).numpy()
    assert np.abs(got - ref).max() < 0.05
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.9


def test_quantize_params_bitwise():
    """The port's quantize_params on bridged dense weights equals the
    JAX package's quantized tree, leaf for leaf, bit for bit."""
    jax_config, _ = _configs("tiny")
    dense, port_dense = _weights(jax_config, False, seed=6)
    ref = jax.tree.map(np.asarray, jax_llama.quantize_params(dense))
    got = llama.quantize_params(port_dense)
    ref_leaves, ref_tree = jax.tree_util.tree_flatten(ref)
    got_leaves, got_tree = jax.tree_util.tree_flatten(
        jax.tree.map(tensor_to_numpy, got,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert ref_tree == got_tree
    for want, have in zip(ref_leaves, got_leaves):
        assert want.dtype == have.dtype or want.dtype.name == "bfloat16"
        np.testing.assert_array_equal(have, np.asarray(want, have.dtype))


def test_random_quantized_params_structure():
    """Built in int8 directly: the same tree, shapes and dtypes as the
    JAX package's quantize_params(init_params(...)), and finite logits."""
    jax_config, port_config = _configs("tiny")
    ref = jax_llama.quantize_params(
        jax_llama.init_params(jax_config, jax.random.PRNGKey(0)))
    got = llama.random_quantized_params(port_config, seed=0, device="cpu")
    ref_shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                              ref)
    got_shapes = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert ref_shapes == got_shapes
    logits = llama.forward(got, torch.ones((1, 8), dtype=torch.int32),
                           port_config)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("rope_scaling", [None, (8.0, 1.0, 4.0, 64)])
def test_rope_matches_jax(rope_scaling):
    """Frequencies (incl. Llama-3.1 rescaling) and the rotate-half
    rotation, f32, 1e-5 (cos/sin of angles up to ~1000 rad)."""
    jax_config, port_config = _configs("tiny")
    jax_config = dataclasses.replace(jax_config, rope_scaling=rope_scaling)
    port_config = dataclasses.replace(port_config,
                                      rope_scaling=rope_scaling)
    rng = np.random.default_rng(8)
    positions = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    x = rng.standard_normal((2, 5, 3, port_config.head_dim)) \
        .astype(np.float32)
    cos, sin = jax_llama._rope_freqs(jax_config, jnp.asarray(positions))
    ref = jax_llama.apply_rope(jnp.asarray(x), cos, sin)
    got = llama.apply_rope(torch.from_numpy(x), *llama._rope_freqs(
        port_config, torch.from_numpy(positions)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("top_k,top_p", [(0, 0.9), (5, None), (8, 0.5),
                                         (0, 0.0)])
def test_mask_logits_matches_jax(top_k, top_p):
    """The sampler's truncation mask (temperature, top-k, nucleus) is the
    JAX package's, element for element."""
    rng = np.random.default_rng(top_k)
    logits = rng.standard_normal((3, 64)).astype(np.float32) * 3
    ref = jax_llama._mask_logits(jnp.asarray(logits), 0.7, top_k, top_p)
    got = llama._mask_logits(torch.from_numpy(logits), 0.7, top_k, top_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_sampling_stays_inside_the_nucleus():
    """Sampled tokens come from the kept set (the frameworks' random
    bits differ, so the draw itself is held to its support)."""
    logits = torch.tensor([[4.0, 3.9, -2.0, -3.0, -5.0]] * 64)
    generator = torch.Generator().manual_seed(0)
    drawn = llama.sample_logits(logits, generator, temperature=1.0,
                                top_p=0.6)
    assert set(drawn.tolist()) <= {0, 1} and len(set(drawn.tolist())) == 2
