"""Port parity for int4 weights: ``aiko_services_tpu_torch`` against the
JAX package on the same numpy inputs and bridged weights.

The JAX side runs as its own tests run it on the CPU: ``int4_matmul`` on
its XLA fallback, or with ``interpret=True`` (the repeat kernel); the
grouped kernel ``_int4_kernel``, which the JAX dispatcher never reaches on
the CPU, through a ``pl.pallas_call`` built here in interpret mode; the
kernel lab's ``matmul_repeat`` / ``matmul_batched`` with
``INT4LAB_INTERPRET=1``.  The port runs on CPU tensors: the plain versions
of ``csrc/int4_matmul.cu`` (the kernel itself is held against them on the
card, in tests/test_torch_cuda.py and chip_smoke.py).
"""

import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from aiko_services_tpu.models import llama as jax_llama
from aiko_services_tpu.ops import quant as jax_quant
from aiko_services_tpu.orchestration import continuous as jax_continuous
from aiko_services_tpu.orchestration import paged as jax_paged
from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.models.bridge import (params_from_numpy,
                                                   tensor_from_numpy,
                                                   tensor_to_numpy)
from aiko_services_tpu_torch.ops import quant
from aiko_services_tpu_torch.orchestration.continuous import (
    ContinuousBatchingServer, DecodeRequest)
from aiko_services_tpu_torch.orchestration.paged import (
    PagedContinuousServer)

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG = "tiny_f32"


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


def _t(array):
    return tensor_from_numpy(np.asarray(array))


def _np(tensor):
    return tensor_to_numpy(tensor).astype(np.float32)


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


# --------------------------------------------------------------------------- #
# quantize / unpack / dequantize

def _tie_weights(k, n, group_size, seed):
    """Gaussian weights with an all-zero column 0 and, in column 1, every
    group's max at 7 * 2^-6 (scale exactly 2^-6) and x.5 ratios in the
    first group (the half-to-even rule)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = np.clip(w[:, 1], -0.1, 0.1)
    group = group_size if group_size % 2 == 0 and k % group_size == 0 \
        else k
    w[::group, 1] = 7 * 2.0 ** -6
    w[1:7, 1] = np.array([2.5, -0.5, 0.5, -3.5, 1.5, -6.5]) * 2.0 ** -6
    return w


@pytest.mark.parametrize("k,n,group_size", [(256, 128, 64), (256, 64, 128),
                                            (352, 96, 128), (128, 32, 63)])
def test_quantize_int4_bitwise(k, n, group_size):
    """Same packed bytes and scales, bit for bit: groups of 64 and 128, the
    degenerate whole-K group (352 rows at group 128, and an odd group
    size), an all-zero column (scale 1) and half-ties (round half to
    even); the dequantized weights are equal too."""
    w = _tie_weights(k, n, group_size, k + n)
    ref = jax_quant.quantize_int4(jnp.asarray(w), group_size)
    got = quant.quantize_int4(torch.from_numpy(w), group_size)
    assert got["q4"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(ref["q4"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(ref["s"]))
    np.testing.assert_array_equal(
        _np(quant.dequantize_int4(got, torch.float32)),
        np.asarray(jax_quant.dequantize_int4(ref, jnp.float32)))
    assert quant.is_quantized_int4(got) and quant.is_quantized(got)
    assert not quant.is_quantized_int4(quant.quantize_int8(
        torch.from_numpy(w)))


def test_quantize_int4_rejects_an_odd_input_dim():
    with pytest.raises(ValueError):
        quant.quantize_int4(torch.ones((7, 4)))


def test_unpack_every_byte_value():
    """All 256 packed bytes: low nibble row 2k, high nibble row 2k+1, both
    sign-extended (-8 included), equal to the JAX unpack; dequantized
    (f32 and bf16) equal to the JAX dequantize."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    low, high = jax_quant._unpack_int4(jnp.asarray(packed))
    got_low, got_high = quant._unpack_int4(torch.from_numpy(packed))
    np.testing.assert_array_equal(got_low.numpy(), np.asarray(low))
    np.testing.assert_array_equal(got_high.numpy(), np.asarray(high))
    assert got_low.min() == -8 and got_high.min() == -8
    rng = np.random.default_rng(0)
    s = rng.random((2, 64)).astype(np.float32)
    ref = {"q4": jnp.asarray(packed), "s": jnp.asarray(s)}
    got = {"q4": torch.from_numpy(packed), "s": torch.from_numpy(s)}
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            _np(quant.dequantize_int4(got, tdt)),
            np.asarray(jax_quant.dequantize_int4(ref, jdt), np.float32))


def _jax_rule(m, k, n, groups):
    """The JAX dispatcher's hardware rule (interpret=False), spelled out."""
    khalf = k // 2
    gs_half = khalf // groups
    if m > 64 or gs_half < 32 or gs_half % 32:
        return False
    return bool(jax_quant._pick_block_repeat(khalf, n, False)
                or jax_quant._pick_block_int4(m, khalf, n, groups))


def test_int4_kernel_shape_matches_the_jax_rule():
    """Over a grid of (m, K, N, G): llama3_8b, 1b and tiny widths, the LM
    head, group counts of 128-, 64- and whole-K groups, and shapes the
    VMEM rule refuses."""
    widths = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
              (4096, 128256), (2048, 2048), (2048, 8192), (8192, 2048),
              (2048, 128256), (128, 128), (128, 64), (352, 128),
              (128, 1024), (28672, 8192), (8192, 28672), (256, 100)]
    checked = taken = 0
    for m in (1, 8, 40, 64, 65):
        for k, n in widths:
            for groups in sorted({max(1, k // 128), max(1, k // 64), 1, 2}):
                if k // 2 // groups == 0:
                    continue
                want = _jax_rule(m, k, n, groups)
                assert quant.int4_kernel_shape(m, k, n, groups) == want, \
                    (m, k, n, groups)
                checked += 1
                taken += want
    assert checked > 200 and 0 < taken < checked


# --------------------------------------------------------------------------- #
# int4_matmul's plain versions against the JAX package

def _case(m, k=512, n=256, group_size=128, seed=0):
    rng = np.random.default_rng(seed + m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    qw = jax_quant.quantize_int4(jnp.asarray(w), group_size)
    return x, qw


def _assert_f32(got, want):
    """f32 results of the same products summed in another order: within
    1e-5 of the output's largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("m", [1, 8, 40, 64, 65])
def test_reference_matches_jax_fallback(m):
    """The plain version (scale after each group) against JAX int4_matmul
    on its CPU fallback (the grouped einsum)."""
    x, qw = _case(m)
    ref = jax_quant.int4_matmul(jnp.asarray(x), qw["q4"], qw["s"])
    got = quant.int4_matmul(_t(x), _t(qw["q4"]), _t(qw["s"]))
    assert got.shape == (m, 256) and got.dtype == torch.float32
    _assert_f32(_np(got), ref)


@pytest.mark.parametrize("m", [1, 8, 40, 64, 65])
def test_reference_matches_pallas_repeat_interpret(m):
    """Against JAX int4_matmul with interpret=True: the repeat kernel for
    m <= 64 (in interpret mode it computes in f32, so the scale-first
    operand is not rounded and the two agree to f32 summation order),
    the fallback past 64."""
    x, qw = _case(m, seed=1)
    ref = jax_quant.int4_matmul(jnp.asarray(x), qw["q4"], qw["s"],
                                interpret=True)
    got = quant.int4_matmul_reference(_t(x), _t(qw["q4"]), _t(qw["s"]))
    _assert_f32(_np(got), ref)


def _grouped_kernel_interpret(x, q4, s):
    """JAX ``_int4_kernel`` through its pallas_call, interpret mode."""
    khalf, n = q4.shape
    groups = s.shape[0]
    m = x.shape[0]
    block_n = 128
    xe, xo = x[:, 0::2], x[:, 1::2]
    kernel = functools.partial(jax_quant._int4_kernel,
                               gs_half=khalf // groups, groups=groups)
    return pl.pallas_call(
        kernel, grid=(n // block_n,),
        in_specs=[pl.BlockSpec((m, khalf), lambda j: (0, 0)),
                  pl.BlockSpec((m, khalf), lambda j: (0, 0)),
                  pl.BlockSpec((khalf, block_n), lambda j: (0, j)),
                  pl.BlockSpec((groups, block_n), lambda j: (0, j))],
        out_specs=pl.BlockSpec((m, block_n), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((m, n), x.dtype),
        interpret=True)(xe, xo, q4, s)


@pytest.mark.parametrize("group_size", [64, 128, 512])
@pytest.mark.parametrize("m", [1, 8, 40, 64, 65])
def test_reference_matches_grouped_kernel_interpret(m, group_size):
    """Against the grouped Pallas kernel (the path's numerics: per-group
    f32 partials scaled into an f32 accumulator) in interpret mode, for
    groups of 64 and 128 rows and one group of all 512."""
    x, qw = _case(m, group_size=group_size, seed=2)
    ref = _grouped_kernel_interpret(jnp.asarray(x), qw["q4"], qw["s"])
    got = quant.int4_matmul_reference(_t(x), _t(qw["q4"]), _t(qw["s"]))
    _assert_f32(_np(got), ref)


@pytest.fixture(scope="module")
def lab():
    """scripts/int4_kernel_lab.py imported afresh with INT4LAB_INTERPRET=1
    set first (the lab reads it at import)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("INT4LAB_INTERPRET", "1")
    try:
        spec = importlib.util.spec_from_file_location(
            "int4_kernel_lab_interpret", REPO / "scripts" /
            "int4_kernel_lab.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        mp.undo()
    assert module._INTERPRET
    return module


def _bf16_case(m, seed):
    x, qw = _case(m, k=1024, n=256, seed=seed)
    return jnp.asarray(x, jnp.bfloat16), qw


@pytest.mark.parametrize("m", [1, 8, 40, 64])
def test_scale_first_reference_matches_lab_repeat(lab, m):
    """The scale-first plain version against the lab's ``matmul_repeat``
    (operand bf16(q * s), f32 accumulate, bf16 out): the same bf16
    operands, so the bf16 outputs differ only where f32 summation order
    moves a rounding, by at most one bf16 ulp (2^-7 relative)."""
    x, qw = _bf16_case(m, 3)
    ref = np.asarray(lab.matmul_repeat(x, qw["q4"], qw["s"], 128),
                     np.float32)
    got = quant.int4_matmul_scale_first_reference(_t(x), _t(qw["q4"]),
                                                  _t(qw["s"]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), ref, rtol=2 ** -7,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("m", [1, 8, 40, 64])
def test_reference_matches_lab_batched(lab, m):
    """The plain version (scale after each group) against the lab's
    ``matmul_batched`` (per-group bf16 dots, f32 partials times the
    scales, summed): at most one bf16 ulp (2^-7 relative) apart, where
    f32 summation order moves a rounding."""
    x, qw = _bf16_case(m, 4)
    ref = np.asarray(lab.matmul_batched(x, qw["q4"], qw["s"], 128),
                     np.float32)
    got = quant.int4_matmul_reference(_t(x), _t(qw["q4"]), _t(qw["s"]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), ref, rtol=2 ** -7,
                               atol=1e-6 * np.abs(ref).max())


def test_scale_first_differs_from_scale_after_by_operand_rounding():
    """The two numerics are different functions: scale-first rounds every
    weight to bf16 (2^-9 relative), scale-after does not; in f32 they
    differ by well under 1% of the output's range and more than f32
    summation order could."""
    x, qw = _case(8, k=1024, seed=5)
    args = (_t(x), _t(qw["q4"]), _t(qw["s"]))
    after = _np(quant.int4_matmul_reference(*args))
    first = _np(quant.int4_matmul_scale_first_reference(*args))
    gap = np.abs(after - first).max() / np.abs(after).max()
    assert 1e-5 < gap < 1e-2
    # On CPU tensors the wrappers are the plain versions.
    np.testing.assert_array_equal(_np(quant.int4_matmul(*args)), after)
    np.testing.assert_array_equal(_np(quant.int4_matmul_scale_first(*args)),
                                  first)


@pytest.mark.parametrize("m,group_size", [(65, 128), (200, 64), (130, 512)])
def test_tiled_wrapper_on_cpu_matches_jax_large_m(m, group_size):
    """``int4_matmul_tiled`` (the m-tiled instance that every int4 prefill
    slice of m > 64 launches on the card) on CPU tensors is the plain
    version: against the JAX package's large-m product, its f32 grouped
    einsum, on the same numpy inputs."""
    x, qw = _case(m, group_size=group_size)
    ref = jax_quant.int4_matmul(jnp.asarray(x), qw["q4"], qw["s"])
    got = quant.int4_matmul_tiled(_t(x), _t(qw["q4"]), _t(qw["s"]))
    assert got.shape == (m, 256) and got.dtype == torch.float32
    _assert_f32(_np(got), ref)


def test_every_llama_projection_tiles():
    """Every int4 projection of the port's full-size dense configs
    (128-row groups) is taken by the m-tiled instance, so no prefill slice
    leaves the kernels on the card.  The tiny configs' d_ff of 352 (N % 64
    = 32, and one 352-row group for w_down) takes the group-wise PyTorch
    route there, as do groups of 96 rows and N % 64 != 0."""
    for name in ("small", "1b", "llama3_8b", "llama3_70b", "mistral_7b"):
        config = llama.CONFIGS[name]
        d, hd = config.d_model, config.head_dim
        for k, n in ((d, config.n_heads * hd), (d, config.n_kv_heads * hd),
                     (config.n_heads * hd, d), (d, config.d_ff),
                     (config.d_ff, d), (d, config.vocab_size)):
            assert quant.tiles_int4(k, n, k // 128), (name, k, n)
    tiny = llama.CONFIGS["tiny"]
    assert not quant.tiles_int4(tiny.d_model, tiny.d_ff, 1)
    assert not quant.tiles_int4(tiny.d_ff, tiny.d_model, 1)
    assert not quant.tiles_int4(576, 256, 6)
    assert not quant.tiles_int4(512, 96, 4)


def test_int4_wrappers_count_launches():
    """Launch counters are plain ints, and CPU calls never count."""
    x, qw = _case(8)
    before = (quant.int4_matmul.launches,
              quant.int4_matmul_scale_first.launches,
              quant.int4_matmul_tiled.launches)
    quant.int4_matmul(_t(x), _t(qw["q4"]), _t(qw["s"]))
    quant.int4_matmul_scale_first(_t(x), _t(qw["q4"]), _t(qw["s"]))
    quant.int4_matmul_tiled(_t(x), _t(qw["q4"]), _t(qw["s"]))
    assert (quant.int4_matmul.launches,
            quant.int4_matmul_scale_first.launches,
            quant.int4_matmul_tiled.launches) == before
    assert all(isinstance(count, int) for count in before)


@pytest.mark.parametrize("variant", ["batched", "repeat"])
def test_port_kernel_lab_validates_on_the_cpu(variant):
    """The port's lab (aiko_services_tpu_torch.tools.int4_kernel_lab)
    checks a variant against its plain version; off the card it times
    nothing."""
    from aiko_services_tpu_torch.tools import int4_kernel_lab
    row = int4_kernel_lab.race_one(variant, 512, 256, m=8, device="cpu")
    assert row["us"] is None and row["rel_err"] < 0.01


# --------------------------------------------------------------------------- #
# models/llama.py with int4 weights

def _configs(**changes):
    jax_config = dataclasses.replace(jax_llama.CONFIGS["tiny"],
                                     dtype=jnp.float32, **changes)
    port_config = dataclasses.replace(llama.CONFIGS["tiny"],
                                      dtype=torch.float32, **changes)
    return jax_config, port_config


#: tiny widened so that every projection has several 128-row groups
#: (d 256: 2 groups, d_ff 512: 4 groups).
WIDE = dict(d_model=256, d_ff=512)


def _int4_weights(jax_config, seed, random=False):
    if random:
        params = jax_llama.random_quantized_params(
            jax_config, jax.random.PRNGKey(seed), bits=4)
    else:
        params = jax_llama.quantize_params(
            jax_llama.init_params(jax_config, jax.random.PRNGKey(seed)),
            bits=4)
    return params, _bridge(params)


def _leaves(tree):
    return jax.tree_util.tree_flatten(
        jax.tree.map(tensor_to_numpy, tree,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("changes", [{}, WIDE])
def test_quantize_params_int4_bitwise(changes):
    """quantize_params(bits=4) on bridged dense weights equals the JAX
    tree leaf for leaf, bit for bit; the embedding stays int8."""
    jax_config, _ = _configs(**changes)
    dense = jax_llama.init_params(jax_config, jax.random.PRNGKey(6))
    ref = jax.tree.map(np.asarray, jax_llama.quantize_params(dense, bits=4))
    got = llama.quantize_params(_bridge(dense), bits=4)
    assert set(got["embed"]) == {"q", "s"}
    assert set(got["lm_head"]) == {"q4", "s"}
    ref_leaves, ref_tree = jax.tree_util.tree_flatten(ref)
    got_leaves, got_tree = _leaves(got)
    assert ref_tree == got_tree
    for want, have in zip(ref_leaves, got_leaves):
        assert want.dtype == have.dtype
        np.testing.assert_array_equal(have, want)


@pytest.mark.parametrize("name", ["tiny", "small"])
def test_random_quantized_params_int4_structure(name):
    """Built in int4 directly: the same tree, shapes and dtypes as the JAX
    package's random_quantized_params(bits=4), packed bytes over the whole
    int8 range, and (tiny) finite logits."""
    jax_config = jax_llama.CONFIGS[name]
    port_config = llama.CONFIGS[name]
    ref = jax_llama.random_quantized_params(jax_config,
                                            jax.random.PRNGKey(0), bits=4)
    ref_shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), ref)
    got = llama.random_quantized_params(port_config, seed=0, bits=4,
                                        device="cpu")
    got_shapes = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert ref_shapes == got_shapes
    packed = got["layers"][0]["w_gate"]["q4"]
    assert int(packed.min()) == -128 and int(packed.max()) == 127
    d_ff = port_config.d_ff
    assert got["layers"][0]["w_down"]["s"].shape == \
        (max(1, d_ff // 128), port_config.d_model)
    if name == "tiny":
        logits = llama.forward(got, torch.ones((1, 8), dtype=torch.int32),
                               port_config)
        assert torch.isfinite(logits).all()


@pytest.mark.parametrize("random", [False, True])
@pytest.mark.parametrize("changes", [{}, WIDE])
def test_forward_logits_int4_f32(changes, random):
    """Full-sequence logits on int4 weights (quantized, or random packed
    bytes with -8 nibbles and two groups in w_down) within 1e-4 (f32
    summation order)."""
    jax_config, port_config = _configs(**changes)
    jax_params, port_params = _int4_weights(jax_config, 1, random)
    rng = np.random.default_rng(2)
    tokens = rng.integers(1, jax_config.vocab_size, (2, 24)).astype(np.int32)
    ref = jax_llama.forward(jax_params, jnp.asarray(tokens), jax_config)
    got = llama.forward(port_params, torch.from_numpy(tokens), port_config)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("quantize_kv", [False, True])
@pytest.mark.parametrize("changes", [{}, WIDE])
def test_prefill_generate_int4_greedy_tokens_equal(changes, quantize_kv):
    """prefill + generate_tokens on int4 weights: last-position logits
    within 1e-4 and the greedy tokens EQUAL over 20 + 10 positions."""
    jax_config, port_config = _configs(**changes)
    jax_params, port_params = _int4_weights(jax_config, 2, random=True)
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, jax_config.vocab_size, (2, 20)).astype(np.int32)
    cache = jax_llama.init_cache(jax_config, 2, 64, quantize_kv=quantize_kv)
    logits, cache = jax_llama.prefill(jax_params, jnp.asarray(prompt), cache,
                                      jax_config)
    first = logits[:, -1].argmax(-1).astype(jnp.int32)[:, None]
    tokens, _ = jax_llama.generate_tokens(jax_params, first, cache,
                                          jnp.int32(20), 9, jax_config)
    ref = np.concatenate([np.asarray(first), np.asarray(tokens)], 1)
    port_cache = llama.init_cache(port_config, 2, 64,
                                  quantize_kv=quantize_kv, device="cpu")
    got_logits, port_cache = llama.prefill(
        port_params, torch.from_numpy(prompt), port_cache, port_config)
    port_first = got_logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    got_tokens, _ = llama.generate_tokens(port_params, port_first,
                                          port_cache, 20, 9, port_config)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        torch.cat([port_first, got_tokens], 1).numpy(), ref)


@pytest.mark.parametrize("group_size", [128, 64])
def test_int4_embed_lookup_matches_jax(group_size):
    """An int4 embedding (quantized leaf by leaf; quantize_params keeps it
    int8): the port's row gather + nibble pick + group scale equals the
    JAX lookup, for even and odd token ids across groups."""
    rng = np.random.default_rng(7)
    table = rng.standard_normal((1024, 128)).astype(np.float32)
    ref_embed = jax_quant.quantize_int4(jnp.asarray(table), group_size)
    tokens = rng.integers(0, 1024, (3, 11)).astype(np.int32)
    tokens[0, :4] = [0, 1, 1022, 1023]
    ref = jax_llama._embed_lookup({"embed": ref_embed}, jnp.asarray(tokens),
                                  jnp.float32)
    got = llama._embed_lookup({"embed": _bridge(ref_embed)},
                              torch.from_numpy(tokens), torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --------------------------------------------------------------------------- #
# The servers on int4 weights: token- and block-equal to the JAX servers

def _int4_server_params(seed):
    jax_config = jax_llama.CONFIGS[CONFIG]
    return _int4_weights(jax_config, seed, random=True)


def _drive(server, module, waves):
    requests = []
    for wave in waves:
        for prompt, new in wave:
            request = module(f"r{len(requests)}", prompt, new)
            requests.append(request)
            server.submit(request)
        server.run_until_drained()
    return requests


def _waves(seed):
    """Two waves; the second shares a 33-token prefix with the first (a
    prefix hit on the paged server) and a 40-token prompt takes three
    16-token slices."""
    rng = np.random.default_rng(seed)
    first = [rng.integers(1, 1024, n).astype(np.int32) for n in (5, 40, 3)]
    second = [np.concatenate([first[1][:33],
                              rng.integers(1, 1024, 4).astype(np.int32)]),
              first[0].copy()]
    return [list(zip(first, (12, 9, 14))), list(zip(second, (8, 6)))]


def _accounting(server):
    return dict(free=server.free_blocks, evictable=list(server._evictable),
                producing=dict(server._producing), hits=server.prefix_hits,
                misses=server.prefix_misses,
                reused=server.prefix_blocks_reused,
                index=dict(server._index), tables=server.tables.tolist())


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_contiguous_server_int4_matches_jax(quantize_kv):
    jax_params, port_params = _int4_server_params(3)
    kwargs = dict(config_name=CONFIG, slots=2, max_seq=96, chunk_steps=4,
                  quantize=True, quantize_kv=quantize_kv)
    jax_server = jax_continuous.ContinuousBatchingServer(params=jax_params,
                                                         **kwargs)
    port_server = ContinuousBatchingServer(params=port_params, device="cpu",
                                           **kwargs)
    want = _drive(jax_server, jax_continuous.DecodeRequest, _waves(5))
    got = _drive(port_server, DecodeRequest, _waves(5))
    for have, ref in zip(got, want):
        assert have.error is None and have.tokens == ref.tokens, \
            have.request_id
    assert port_server.stats()["tokens_committed"] == \
        jax_server.stats()["tokens_committed"]


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_paged_server_int4_matches_jax(quantize_kv):
    jax_params, port_params = _int4_server_params(4)
    kwargs = dict(config_name=CONFIG, slots=2, max_seq=128, chunk_steps=3,
                  block_size=16, total_blocks=16, quantize=True,
                  quantize_kv=quantize_kv, enable_prefix_cache=True,
                  chunk_prefill_tokens=16)
    jax_server = jax_paged.PagedContinuousServer(params=jax_params, **kwargs)
    port_server = PagedContinuousServer(params=port_params, device="cpu",
                                        **kwargs)
    want = _drive(jax_server, jax_continuous.DecodeRequest, _waves(6))
    got = _drive(port_server, DecodeRequest, _waves(6))
    for have, ref in zip(got, want):
        assert have.error is None and have.tokens == ref.tokens, \
            have.request_id
    assert _accounting(port_server) == _accounting(jax_server)
    assert port_server.prefix_hits > 0
    balance = port_server.pool_balance()
    assert balance["free"] + balance["evictable"] + balance["producing"] \
        == balance["total"]


def test_paired_spec_server_int4_matches_jax():
    """Paired draft (the int4 target as its own draft), int8 KV, chunked
    admission, prefix cache; ``ring_max=2`` pins both in-flight rings."""
    jax_params, port_params = _int4_server_params(5)
    kwargs = dict(config_name=CONFIG, slots=2, max_seq=128, chunk_steps=4,
                  block_size=16, total_blocks=16, quantize=True,
                  quantize_kv=True, enable_prefix_cache=True,
                  chunk_prefill_tokens=16, spec_k=3, ring_max=2,
                  draft_config_name=CONFIG)
    jax_server = jax_paged.PagedContinuousServer(params=jax_params, **kwargs)
    jax_server._draft["params"] = jax_server.params
    port_server = PagedContinuousServer(params=port_params,
                                        draft_params=port_params,
                                        device="cpu", **kwargs)
    want = _drive(jax_server, jax_continuous.DecodeRequest, _waves(7))
    got = _drive(port_server, DecodeRequest, _waves(7))
    for have, ref in zip(got, want):
        assert have.error is None and have.tokens == ref.tokens, \
            have.request_id
        assert have.spec_accepted_rounds == [
            int(a) for a in ref.spec_accepted_rounds], have.request_id
    ours, theirs = port_server.stats(), jax_server.stats()
    for key in ("spec_rounds", "spec_proposed", "spec_accepted",
                "spec_rollback_blocks"):
        assert ours[key] == theirs[key], key
    assert ours["spec_rounds"] > 0 and ours["spec_tokens_per_target_pass"] > 1
    assert _accounting(port_server) == _accounting(jax_server)


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096), (4096, 128256),
                                 (4096, 67584), (256, 1024), (512, 384),
                                 (14336, 128)])
@pytest.mark.parametrize("m_tiles", [0, 1, 4, 32])
def test_int4_k_split_fills_one_wave(k, n, m_tiles):
    """The int4 kernel's K split for 256-column CTAs (``m_tiles`` 64-row
    tiles of m in the tiled instance, 0 for the m <= 64 instance): whole
    64-row stages, at least four a slice unless K is shorter, the slices
    covering K, and never more CTAs than three on each of the 132 SMs
    unless the grid is that wide unsplit.  It depends on (K, N) and the m
    tiles alone, so every m of the m <= 64 instance sums a row alike."""
    tiles = -(-n // quant.INT4_TILE_COLS) * max(m_tiles, 1)
    splits, rows = quant._k_split(k, tiles, quant.INT4_CTAS_PER_SM, True)
    assert rows % 64 == 0 and splits * rows >= k > (splits - 1) * rows
    assert rows >= min(k, 256)
    assert tiles * splits <= max(3 * 132, tiles)
    if m_tiles == 0:
        for m in (1, 8, 13, 40, 64):
            assert quant._split_k("cpu", m, k, n, quant.INT4_TILE_COLS,
                                  quant.INT4_CTAS_PER_SM, one_wave=True
                                  )[:2] == (splits, rows)
