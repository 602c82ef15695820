"""Port parity: the ops of ``aiko_services_tpu_torch`` against the JAX
package's ops on the same numpy inputs.

The JAX side runs as its own tests run it on the CPU: Pallas kernels in
``interpret=True`` mode.  The port side runs on CPU tensors, i.e. the
plain PyTorch version of each CUDA kernel (the kernels themselves are
held against these plain versions on the card, in tests/test_torch_cuda.py
and chip_smoke.py).  Also here: the import guard that keeps JAX and the
JAX package out of the port.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiko_services_tpu.ops import attention as jax_attention
from aiko_services_tpu.ops import paged_attention as jax_paged
from aiko_services_tpu.ops import quant as jax_quant
from aiko_services_tpu_torch.models.bridge import tensor_from_numpy
from aiko_services_tpu_torch.ops import (_cuda, attention, paged_attention,
                                         quant)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _leave_jax_caches_cold():
    """Later test modules in the same worker count their own JAX
    compiles; drop what this module compiled once it is done."""
    yield
    jax.clear_caches()


def _t(array):
    return tensor_from_numpy(np.asarray(array))


def _np(tensor):
    return tensor.detach().to(torch.float32).numpy()


# --------------------------------------------------------------------------- #
# quant


@pytest.mark.parametrize("shape", [(64, 256), (352, 128), (33, 7)])
def test_quantize_int8_bitwise(shape):
    """Same int8 codes and scales, bit for bit (both round half to even);
    the half-integer ratios exercise the tie rule."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal(shape).astype(np.float32)
    w[:, 0] = 0.0                              # an all-zero column: scale 1
    # Column 1 has scale exactly 2**-6, so w / scale hits x.5 ties.
    w[:, 1] = np.clip(w[:, 1], -1.0, 1.0)
    w[0, 1] = 127 * 2.0 ** -6
    w[1:5, 1] = np.array([2.5, -0.5, 0.5, -3.5]) * 2.0 ** -6
    ref = jax_quant.quantize_int8(jnp.asarray(w))
    got = quant.quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(ref["s"]))
    np.testing.assert_array_equal(
        _np(quant.dequantize(got, torch.float32)),
        np.asarray(jax_quant.dequantize(ref, jnp.float32)))
    assert quant.is_quantized(got) and not quant.is_quantized(w)


@pytest.mark.parametrize("m", [1, 8, 64, 96])
def test_int8_matmul_matches_pallas_interpret(m):
    """Plain int8 matmul vs the JAX Pallas kernel in interpret mode (its
    fallback for m > 64); f32, rtol = atol = 1e-5 (summation order)."""
    rng = np.random.default_rng(m)
    k, n = 64, 256
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    qw = jax_quant.quantize_int8(jnp.asarray(w))
    ref = jax_quant.int8_matmul(jnp.asarray(x), qw["q"], qw["s"],
                                interpret=True)
    got = quant.int8_matmul(_t(x), _t(qw["q"]), _t(qw["s"]))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert quant.kernel_shape(m, k, n) == (m <= 64)


def test_int8_matmul_shape_rule_matches_jax():
    """The port takes the kernel for exactly the shapes the JAX package
    does: m <= 64, K % 32, N % 128 and the VMEM budget."""
    for m, k, n in [(1, 4096, 4096), (64, 14336, 4096), (65, 4096, 4096),
                    (8, 4096, 100), (8, 48, 128), (64, 28672, 8192)]:
        expected = (m <= 64 and k % 32 == 0
                    and jax_quant._pick_block(m, k, n) > 0)
        assert quant.kernel_shape(m, k, n) == expected, (m, k, n)


def test_int8_matmul_bf16_leading_dims():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = rng.standard_normal((64, 128)).astype(np.float32)
    qw = jax_quant.quantize_int8(jnp.asarray(w))
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jax_quant.int8_matmul(xb, qw["q"], qw["s"], interpret=True)
    got = quant.int8_matmul(_t(xb), _t(qw["q"]), _t(qw["s"]))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 128)
    # bf16 output: one rounding of the same f32 value, at most 1 ulp.
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096), (4096, 128256), (352, 128),
                                 (352, 384), (4128, 384), (64, 128)])
def test_int8_k_split_fills_one_wave(k, n):
    """The int8 kernel's K split for 256-column CTAs: whole 64-row stages,
    at least four a slice unless K is shorter, the slices covering K, and
    never more CTAs than two on each of the 132 SMs unless the grid is
    that wide unsplit.  It depends on (K, N) alone, so every m (every
    instance of the kernel: 8, 16, 32 or 64 rows) sums a row alike, and
    the partials hold one (instance rows x 256) tile a slice."""
    assert quant.INT8_TILE_COLS == 256
    tiles = -(-n // quant.INT8_TILE_COLS)
    splits, rows = quant._k_split(k, tiles, quant.INT8_CTAS_PER_SM, True)
    assert rows % 64 == 0 and splits * rows >= k > (splits - 1) * rows
    assert rows >= min(k, 256)
    assert tiles * splits <= max(2 * 132, tiles)
    for m, instance in ((1, 8), (8, 8), (13, 16), (40, 64), (64, 64)):
        got = quant._split_k("cpu", m, k, n, quant.INT8_TILE_COLS,
                             quant.INT8_CTAS_PER_SM, one_wave=True)
        assert got[:2] == (splits, rows)
        if splits > 1:
            assert got[2].numel() >= tiles * splits * instance * 256
            assert got[3].numel() >= tiles
        else:
            assert got[2] is None and got[3] is None


# --------------------------------------------------------------------------- #
# flash attention


@pytest.mark.parametrize("kv_heads", [4, 1])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("q_len,k_len", [(64, 64), (32, 64)])
def test_flash_attention_matches_pallas_interpret(kv_heads, window, q_len,
                                                   k_len):
    """GQA 1 and 4, window on/off, q_len < k_len (keys offset by
    k_len - q_len); f32, atol = rtol = 2e-5 (online vs one-shot
    softmax)."""
    rng = np.random.default_rng(q_len + 7 * kv_heads)
    heads, d = 4, 32
    q = rng.standard_normal((2, heads, q_len, d)).astype(np.float32)
    k = rng.standard_normal((2, kv_heads, k_len, d)).astype(np.float32)
    v = rng.standard_normal((2, kv_heads, k_len, d)).astype(np.float32)
    ref = jax_attention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True, window=window, block_q=32, block_k=32)
    got = attention.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                    window=window)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_attention_reference_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 2, 24, 16)).astype(np.float32)
               for _ in range(3))
    for causal, window in [(True, None), (True, 5), (False, None)]:
        ref = jax_attention.attention_reference(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window)
        got = attention.attention_reference(_t(q), _t(k), _t(v),
                                            causal=causal, window=window)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    assert attention.NEG_INF == jax_attention.NEG_INF


# --------------------------------------------------------------------------- #
# paged decode attention


def _quantize_rows(rows):
    r32 = np.asarray(rows, np.float32)
    amax = np.abs(r32).max(-1)
    scale = np.where(amax == 0, 1.0, amax / 127.0).astype(np.float32)
    q = np.clip(np.round(r32 / scale[..., None]), -127, 127)
    return q.astype(np.int8), scale


def _pool_case(rng, batch=3, kv=2, group=4, hd=32, bs=16, max_blocks=4,
               quant_kv=False):
    """Random pool + shuffled (non-contiguous) block tables."""
    n_blocks = batch * max_blocks + 1
    q = rng.standard_normal((batch, kv, group, hd)).astype(np.float32)
    k = rng.standard_normal((n_blocks, bs, kv, hd)).astype(np.float32)
    v = rng.standard_normal((n_blocks, bs, kv, hd)).astype(np.float32)
    ids = list(range(1, n_blocks))
    rng.shuffle(ids)
    tables = np.array(ids[:batch * max_blocks], np.int32).reshape(
        batch, max_blocks)
    scales = {}
    if quant_kv:
        k, ks = _quantize_rows(k)
        v, vs = _quantize_rows(v)
        scales = dict(ks=ks, vs=vs)
    return q, k, v, tables, scales


def _paged_parity(case, positions, tol, window=None):
    q, k, v, tables, scales = case
    positions = np.asarray(positions, np.int32)
    ref = jax_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(positions), window=window, interpret=True,
        **{key: jnp.asarray(val) for key, val in scales.items()})
    got = paged_attention.paged_decode_attention(
        _t(q), _t(k), _t(v), _t(tables), _t(positions), window=window,
        **{key: _t(val) for key, val in scales.items()})
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kv,group", [(1, 1), (1, 4), (1, 8), (2, 4)])
def test_paged_decode_gqa_groups(kv, group):
    rng = np.random.default_rng(10 * kv + group)
    _paged_parity(_pool_case(rng, kv=kv, group=group), [5, 33, 63], 2e-5)


@pytest.mark.parametrize("positions", [[0, 17, 63], [15, 16, 31],
                                       [47, 48, 0]])
def test_paged_decode_ragged_and_block_edges(positions):
    """Ragged rows, a single-block row, positions exactly on block
    edges (bs = 16); f32, 2e-5."""
    rng = np.random.default_rng(sum(positions))
    _paged_parity(_pool_case(rng), positions, 2e-5)


@pytest.mark.parametrize("window", [3, 16, 40])
def test_paged_decode_window(window):
    rng = np.random.default_rng(window)
    _paged_parity(_pool_case(rng), [2, 31, 63], 2e-5, window=window)


@pytest.mark.parametrize("window", [None, 20])
def test_paged_decode_int8_pools(window):
    """int8 pools with per-(token, head) scales; 1e-4 (scale applied to
    the score vs to the key before the dot)."""
    rng = np.random.default_rng(99)
    _paged_parity(_pool_case(rng, quant_kv=True), [9, 40, 63], 1e-4,
                  window=window)


@pytest.mark.parametrize("quant_kv", [False, True])
@pytest.mark.parametrize("window", [None, 40, 300])
@pytest.mark.parametrize("bs", [16, 128])
def test_paged_decode_split_reference(bs, window, quant_kv):
    """The kernel's split-and-merge algorithm in plain PyTorch against the
    one-shot plain version and the JAX kernel (interpret mode): 640 keys
    of a table, splits of 256 keys (16 blocks of 16) or 128 (one block of
    128); rows with one key, ending on a split edge, starting the next
    split, and at the table's end, so later splits are empty; a window of
    40 leaves early splits wholly outside it, 300 cuts one.  f32, 2e-5
    (1e-4 int8)."""
    rng = np.random.default_rng(bs + (window or 0) + 7 * quant_kv)
    case = _pool_case(rng, batch=4, bs=bs, max_blocks=640 // bs,
                      quant_kv=quant_kv)
    q, k, v, tables, scales = case
    positions = np.array([0, 255, 256, 639], np.int32)
    assert paged_attention.decode_split_keys(bs) == (256 if bs == 16
                                                     else 128)
    args = [_t(x) for x in (q, k, v, tables, positions)]
    scales_t = {key: _t(val) for key, val in scales.items()}
    got = paged_attention.paged_decode_split_reference(
        *args, window=window, **scales_t)
    plain = paged_attention.paged_decode_reference(*args, window=window,
                                                   **scales_t)
    tol = 1e-4 if quant_kv else 2e-5
    np.testing.assert_allclose(_np(got), _np(plain), rtol=tol, atol=tol)
    _paged_parity(case, positions, tol, window=window)
    ref = jax_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(positions), window=window, interpret=True,
        **{key: jnp.asarray(val) for key, val in scales.items()})
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("block_size", [1, 16, 48, 100, 128, 256, 512])
def test_decode_split_keys_are_whole_blocks(block_size):
    """A split is whole blocks: at most 256 keys, one block from 128 rows
    up; it depends on the block size alone."""
    keys = paged_attention.decode_split_keys(block_size)
    assert keys % block_size == 0
    assert keys <= max(256, block_size)
    expect = {1: 256, 16: 256, 48: 240, 100: 200, 128: 128, 256: 256,
              512: 512}
    assert keys == expect[block_size]


@pytest.mark.parametrize("quant_kv", [False, True])
def test_cached_gqa_attention_matches_jax(quant_kv):
    """The contiguous-cache oracle (span-wise int8 dequant: 64 rows are
    two 32-row spans) with two queries per row and a window."""
    rng = np.random.default_rng(4)
    batch, seq, kv, group, hd = 2, 64, 2, 2, 16
    q = rng.standard_normal((batch, 2, kv, group, hd)).astype(np.float32)
    k = rng.standard_normal((batch, seq, kv, hd)).astype(np.float32)
    v = rng.standard_normal((batch, seq, kv, hd)).astype(np.float32)
    layer = {"k": k, "v": v}
    if quant_kv:
        layer["k"], layer["ks"] = _quantize_rows(k)
        layer["v"], layer["vs"] = _quantize_rows(v)
    positions = np.array([[20, 21], [50, 63]], np.int32)
    for window in (None, 24):
        ref = jax_paged.cached_gqa_attention(
            jnp.asarray(q), {key: jnp.asarray(val)
                             for key, val in layer.items()},
            jnp.asarray(positions), hd, window=window)
        got = paged_attention.cached_gqa_attention(
            _t(q), {key: _t(val) for key, val in layer.items()},
            _t(positions), hd, window=window)
        np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_contiguous_block_size_matches_jax():
    for max_seq in (0, 8, 16, 48, 96, 1024, 4096, 1000):
        assert paged_attention.contiguous_block_size(max_seq) \
            == jax_paged.contiguous_block_size(max_seq)
    for seq in (1, 7, 64, 1024, 4096):
        assert paged_attention._dequant_block(seq) \
            == jax_paged._dequant_block(seq)


def test_every_kernel_wrapper_counts_its_launches():
    """Each CUDA kernel's wrapper carries a plain int launch counter."""
    for wrapper in (quant.int8_matmul, attention.flash_attention,
                    paged_attention.paged_decode_attention):
        assert isinstance(wrapper.launches, int)


# --------------------------------------------------------------------------- #
# the C interface


def _c_declarations():
    """name -> argument types of every ``extern "C" int`` entry in
    ``csrc/*.cu``, each as the ctypes type :mod:`ops._cuda` binds it
    with: a pointer of any kind ``c_void_p``."""
    import ctypes
    import re
    types = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    found = {}
    csrc = REPO / "aiko_services_tpu_torch" / "csrc"
    for path in sorted(csrc.glob("*.cu")):
        text = path.read_text()
        for match in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            args = []
            for arg in match.group(2).split(","):
                kind = " ".join(arg.split()[:-1]).replace("const ", "")
                args.append(ctypes.c_void_p if "*" in arg
                            else types[kind])
            found[match.group(1)] = args
    return found


@pytest.mark.parametrize("name", sorted(_cuda.SIGNATURES))
def test_bound_signature_is_the_c_declaration(name):
    """The ctypes signature each C entry is bound with has the argument
    types of its declaration in csrc/, in order (a mismatch shows only as
    a wrong launch on the card)."""
    assert _cuda.SIGNATURES[name] == _c_declarations()[name]


def test_every_c_entry_is_bound():
    assert set(_c_declarations()) == set(_cuda.SIGNATURES)


# --------------------------------------------------------------------------- #
# import guard


def _port_sources():
    sources = sorted((REPO / "aiko_services_tpu_torch").rglob("*.py"))
    return sources + [REPO / "chip_smoke.py",
                      REPO / "scripts" / "torch_kernel_mutants.py",
                      REPO / "scripts" / "attention_variant_lab.py",
                      REPO / "scripts" / "smoke_phase2.py",
                      REPO / "scripts" / "smoke_wire.py",
                      REPO / "scripts" / "smoke_kv.py",
                      REPO / "scripts" / "smoke_fleet.py",
                      REPO / "scripts" / "smoke_elastic.py",
                      REPO / "scripts" / "smoke_contig.py",
                      REPO / "scripts" / "smoke_grammar_lora.py",
                      REPO / "scripts" / "codec_scan.py",
                      REPO / "scripts" / "ring_step_lab.py"]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Every module of the port and chip_smoke.py: no import whose top
    name is jax, jaxlib or exactly aiko_services_tpu (the port's own
    name shares that prefix, so names are compared whole)."""
    banned = {"jax", "jaxlib", "aiko_services_tpu"}
    offenders = []
    sources = _port_sources()
    assert len(sources) > 10
    for name in ("spill.py", "transfer.py", "directory.py"):
        assert REPO / "aiko_services_tpu_torch" / "kvstore" / name in sources
    for name in ("registry/registrar.py", "registry/services_cache.py",
                 "orchestration/migration.py", "tools/loadgen.py",
                 "orchestration/autoscaler.py", "orchestration/lifecycle.py",
                 "orchestration/process_manager.py", "runtime/proxy.py",
                 "runtime/category.py", "models/constrained.py",
                 "models/lora.py", "models/lora_paged.py",
                 "tools/import_weights.py", "elements/ml.py",
                 "elements/common_io.py", "elements/text_io.py",
                 "elements/image_io.py", "pipeline/pipeline.py",
                 "pipeline/tpu_stage.py", "pipeline/prefetch.py",
                 "pipeline/cli.py", "utils/graph.py", "utils/importer.py",
                 "models/vision.py", "models/detector.py",
                 "models/classifier.py", "models/common.py"):
        assert REPO / "aiko_services_tpu_torch" / name in sources
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders
