"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes and their edge cases.

Needs an NVIDIA card with the CUDA toolkit (the kernels are built from
``aiko_services_tpu_torch/csrc`` at first use); every test skips without
one.  These tests import no JAX, so on the card they run without the
JAX-side conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the plain version is computed in f32 on the same inputs.
bf16 outputs are held per element to 2^-7 * |want| + 2^-7 * max |want|
over the element's row (last axis): the kernels round their f32 result to
bf16 once, and flash_attention rounds its softmax weights to bf16 for the
P.V product, an error of about 2^-9 times the spread of the row's
outputs.  f32 outputs to 1e-4 (summation order).
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.ops import (_cuda, attention, paged_attention,
                                         paged_prefill, quant)
from aiko_services_tpu_torch.orchestration.continuous import (
    ContinuousBatchingServer, DecodeRequest)
from aiko_services_tpu_torch.orchestration.paged import (
    PagedContinuousServer)
from aiko_services_tpu_torch.parallel import (collective_matmul, make_mesh,
                                              rdma_collective)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    """``got`` from a kernel of output type ``dtype`` against the f32
    plain ``want``."""
    got = got.float()
    assert want.dtype == torch.float32
    err = (got - want).abs()
    if dtype == torch.bfloat16:
        magnitude = want.abs()
        tol = 2 ** -7 * (magnitude + magnitude.amax(-1, keepdim=True))
        worst = float((err / tol.clamp_min(1e-30)).max())
        assert worst <= 1.0, (float(err.max()), worst)
    else:
        tol = 1e-4 * max(1.0, float(want.abs().max()))
        assert float(err.max()) <= tol, (float(err.max()), tol)


@pytest.mark.parametrize("m", [1, 2, 3, 8, 13, 16, 33, 64])
@pytest.mark.parametrize("k,n", [(64, 128), (352, 256), (4096, 1024),
                                 (14336, 128), (4096, 2048)])
def test_int8_matmul_kernel(cuda, m, k, n):
    """bf16 activations (the kernel's type), with and without split K."""
    dtype = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(m * k + n)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    qw = quant.quantize_int8(torch.randn((k, n), generator=gen,
                                         device=cuda))
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(x, qw["q"], qw["s"])
    assert quant.int8_matmul.launches == before + 1
    want = quant.int8_matmul_reference(x.float(), qw["q"], qw["s"])
    assert got.dtype == dtype and got.shape == (m, n)
    _close(got, want, dtype)


@pytest.mark.parametrize("k,n", [(4096, 1024), (14336, 4096)])
def test_int8_matmul_is_batch_invariant(cuda, k, n):
    """Row r's result does not depend on the other rows of x, bit for bit:
    m = 1, 8, 13 and 40 (the 8- and 16-row instances on mma.sync, the
    64-row instance on wgmma) against the rows of m = 64, with K split by
    (K, N) alone (16 slices at both)."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn((64, k), generator=gen, device=cuda).to(torch.bfloat16)
    qw = quant.quantize_int8(torch.randn((k, n), generator=gen,
                                         device=cuda))
    assert quant._k_split(k, -(-n // quant.INT8_TILE_COLS),
                          quant.INT8_CTAS_PER_SM, True)[0] > 1
    full = quant.int8_matmul(x, qw["q"], qw["s"])
    for m in (1, 8, 13, 40):
        part = quant.int8_matmul(x[:m], qw["q"], qw["s"])
        assert torch.equal(part, full[:m]), m


def _int8_weight(gen, device, k, n):
    """Codes drawn uniformly from all 256 byte values (-128 too, which the
    quantizer never makes but the kernel must take) and positive scales."""
    q = torch.randint(-128, 128, (k, n), generator=gen, device=device,
                      dtype=torch.int8)
    s = torch.rand((1, n), generator=gen, device=device) * (k ** -0.5 / 64)
    return q, s


#: (K, N) of llama3_8b's int8 projections: wq/wo, wk/wv, w_gate/w_up,
#: w_down and the LM head.
LLAMA3_8B_INT8 = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                  (4096, 128256)]


@pytest.mark.parametrize("m", [1, 8, 40, 64])
@pytest.mark.parametrize("k,n", LLAMA3_8B_INT8)
def test_int8_matmul_llama3_8b_shapes(cuda, k, n, m):
    """The main path's shapes at batch-1 decode, the 8-slot step, the
    verify of 8 slots x 5 and 64 slots, against the f32 plain version."""
    gen = torch.Generator(device=cuda).manual_seed(k * 7 + n + m)
    q, s = _int8_weight(gen, cuda, k, n)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(x, q, s)
    assert quant.int8_matmul.launches == before + 1
    _close(got, quant.int8_matmul_reference(x.float(), q, s), torch.bfloat16)


@pytest.mark.parametrize("m", [1, 8, 40, 64])
@pytest.mark.parametrize("k,n", [(352, 128), (352, 384), (4128, 384),
                                 (4128, 128)])
def test_int8_matmul_tails(cuda, k, n, m):
    """N not a multiple of 256 (a last tile of 128 columns: one TMA box,
    four idle warps) and K not a multiple of 64 (the last stage's rows
    past K land as zeros), with and without split K (4128 at N = 384: 13
    slices, the last one 288 rows)."""
    gen = torch.Generator(device=cuda).manual_seed(k + n * 3 + m)
    q, s = _int8_weight(gen, cuda, k, n)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(x, q, s)
    assert quant.int8_matmul.launches == before + 1
    assert got.shape == (m, n)
    _close(got, quant.int8_matmul_reference(x.float(), q, s), torch.bfloat16)


def test_int8_matmul_recovers_every_byte(cuda):
    """One-hot rows of x, 64 at a time: row k of the product is
    bf16(q[k] * s), bit for bit, for every k of a 1,024-row weight split
    four ways (every k position of a stage, both TMA boxes, the merge),
    with all 256 byte values in every row."""
    k, n = 1024, 256
    q = ((torch.arange(k, device=cuda)[:, None]
          + torch.arange(n, device=cuda)[None, :]) % 256 - 128)
    q = q.to(torch.int8)
    gen = torch.Generator(device=cuda).manual_seed(16)
    s = torch.rand((1, n), generator=gen, device=cuda) * 0.05 + 1e-3
    assert quant._k_split(k, 1, quant.INT8_CTAS_PER_SM, True)[0] == 4
    want = quant.dequantize({"q": q, "s": s}, torch.bfloat16)
    eye = torch.eye(k, device=cuda, dtype=torch.bfloat16)
    before = quant.int8_matmul.launches
    for row0 in range(0, k, 64):
        got = quant.int8_matmul(eye[row0:row0 + 64], q, s)
        assert torch.equal(got, want[row0:row0 + 64]), row0
    assert quant.int8_matmul.launches == before + k // 64


def test_int8_matmul_large_m_takes_the_matrix_product(cuda):
    x = torch.randn((65, 64), device=cuda, dtype=torch.bfloat16)
    qw = quant.quantize_int8(torch.randn((64, 128), device=cuda))
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(x, qw["q"], qw["s"])
    assert quant.int8_matmul.launches == before
    _close(got, quant.int8_matmul_reference(x.float(), qw["q"], qw["s"]),
           torch.bfloat16)


def _int4_weight(gen, device, k, n, group):
    """Packed bytes over all 256 values (nibbles -8..7) and positive group
    scales of a fan-in-scaled size."""
    q4 = torch.randint(-128, 128, (k // 2, n), generator=gen, device=device,
                       dtype=torch.int8)
    s = torch.rand((k // group, n), generator=gen, device=device) \
        * (k ** -0.5 / 4) + 1e-4
    return q4, s


#: (K, N, group rows) of the int4 kernel cases: groups of 64, 128, 256 and
#: one group of all K; K split over CTAs (4096 x 1024: 16 slices of 256,
#: which end inside its one 4096-row group; 14336 x 128: 56 slices;
#: 14336 x 4096: 23 slices of 640 rows); N of 128 and 384, which end inside
#: a 256-column CTA tile; the llama3_8b widths.
INT4_SHAPES = [(512, 256, 64), (512, 256, 128), (512, 256, 512),
               (768, 384, 256), (4096, 1024, 128), (4096, 1024, 4096),
               (14336, 128, 128), (4096, 4096, 128), (4096, 14336, 128),
               (14336, 4096, 128)]


@pytest.mark.parametrize("numerics", ["after", "first"])
@pytest.mark.parametrize("m", [1, 3, 8, 13, 32, 40, 64])
@pytest.mark.parametrize("k,n,group", INT4_SHAPES)
def test_int4_matmul_kernel(cuda, k, n, group, m, numerics):
    """Both numerics against their own f32 plain versions: scale after
    each group (the path's, through int4_matmul's dispatch rule) and
    scale first (bf16(q * s) operands)."""
    gen = torch.Generator(device=cuda).manual_seed(m * k + n + group)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    q4, s = _int4_weight(gen, cuda, k, n, group)
    if numerics == "after":
        wrapper, plain = quant.int4_matmul, quant.int4_matmul_reference
        assert quant.int4_kernel_shape(m, k, n, k // group)
    else:
        wrapper = quant.int4_matmul_scale_first
        plain = quant.int4_matmul_scale_first_reference
    before = wrapper.launches
    got = wrapper(x, q4, s)
    assert wrapper.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _close(got, plain(x.float(), q4, s), torch.bfloat16)


def test_int4_matmul_lm_head_width(cuda):
    """The LM head's 128,256 columns at the 8-slot decode batch."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((8, 4096), generator=gen, device=cuda).to(torch.bfloat16)
    q4, s = _int4_weight(gen, cuda, 4096, 128256, 128)
    got = quant.int4_matmul(x, q4, s)
    _close(got, quant.int4_matmul_reference(x.float(), q4, s),
           torch.bfloat16)


@pytest.mark.parametrize("numerics", ["after", "first"])
def test_int4_matmul_is_batch_invariant(cuda, numerics):
    """Row r's result does not depend on the other rows of x (the K split
    and its merge order depend on K and N only)."""
    wrapper = quant.int4_matmul if numerics == "after" \
        else quant.int4_matmul_scale_first
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((64, 4096), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    q4, s = _int4_weight(gen, cuda, 4096, 1024, 128)
    full = wrapper(x, q4, s)
    for m in (1, 8, 13, 40):
        assert torch.equal(wrapper(x[:m], q4, s), full[:m])


def test_int4_matmul_large_m_takes_the_matrix_product(cuda):
    """Shapes outside the m <= 64 rule scale after each group too: m > 64
    and off-rule N (a multiple of 64) launch the m-tiled instance once,
    K split or not; groups of 96 rows and N = 96 take the group-wise
    PyTorch product, with no launch.  Both within the kernels' bf16
    tolerance of the f32 plain version."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    for m, k, n, group, tiled in (
            (65, 512, 256, 128, True), (300, 4096, 1024, 128, True),
            (8, 512, 192, 128, True), (2048, 4096, 4096, 128, True),
            (129, 14336, 128, 128, True), (100, 576, 256, 96, False),
            (70, 512, 96, 128, False), (8, 576, 128, 96, False)):
        x = torch.randn((m, k), generator=gen, device=cuda) \
            .to(torch.bfloat16)
        q4, s = _int4_weight(gen, cuda, k, n, group)
        assert not quant.int4_kernel_shape(m, k, n, k // group)
        assert quant.tiles_int4(k, n, k // group) == tiled
        before = (quant.int4_matmul.launches, quant.int4_matmul_tiled.launches)
        got = quant.int4_matmul(x, q4, s)
        assert (quant.int4_matmul.launches,
                quant.int4_matmul_tiled.launches) == (before[0],
                                                      before[1] + tiled)
        assert got.dtype == torch.bfloat16 and got.shape == (m, n)
        _close(got, quant.int4_matmul_reference(x.float(), q4, s),
               torch.bfloat16)


def _close_scale_after(got, want):
    """The path's numerics, held tighter than the kernel tolerance: the
    f32 result of a scale-after product differs from the f32 plain
    version by summation order only, so the bf16 output is within its own
    rounding (2^-8 * |want|) plus 2^-14 of the row's largest output.
    bf16(q * s) weights (scale first, each rounded by up to 2^-8) miss
    that several times over near zero."""
    err = (got.float() - want).abs()
    magnitude = want.abs()
    tol = 2 ** -8 * magnitude + 2 ** -14 * magnitude.amax(-1, keepdim=True)
    worst = float((err / tol.clamp_min(1e-30)).max())
    assert worst <= 1.0, (float(err.max()), worst)


@pytest.mark.parametrize("m,k,n", [(65, 512, 256), (256, 4096, 1024),
                                   (2048, 4096, 4096), (256, 14336, 4096)])
def test_int4_matmul_tiled_scales_after_each_group(cuda, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    q4, s = _int4_weight(gen, cuda, k, n, 128)
    before = quant.int4_matmul_tiled.launches
    got = quant.int4_matmul_tiled(x, q4, s)
    assert quant.int4_matmul_tiled.launches == before + 1
    _close_scale_after(got, quant.int4_matmul_reference(x.float(), q4, s))


@pytest.mark.parametrize("k,n", [(256, 1024), (4096, 67584)])
def test_int4_matmul_tiled_tiles_equal_the_decode_instance(cuda, k, n):
    """Where neither instance splits K (K = 256, or N wide enough to fill
    the card with m <= 64: 264 tiles of 256 columns), each 64-row tile of
    the tiled instance is bit for bit what the m <= 64 instance gives on
    those rows (a row's sum does not depend on the instance's row count,
    as the batch-invariance test holds)."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn((200, k), generator=gen, device=cuda).to(torch.bfloat16)
    q4, s = _int4_weight(gen, cuda, k, n, 128)
    assert quant._k_split(k, -(-n // quant.INT4_TILE_COLS),
                          quant.INT4_CTAS_PER_SM, True)[0] == 1
    full = quant.int4_matmul_tiled(x, q4, s)
    for row0 in range(0, 200, 64):     # three full tiles and 8 rows
        part = quant._int4_launch("int4_matmul", x[row0:row0 + 64], q4, s)
        assert torch.equal(part, full[row0:row0 + 64]), row0


def test_int4_matmul_recovers_every_byte(cuda):
    """m = 1 with one-hot rows of x: row k of the product is row k of
    dequantize_int4, bit for bit, for every k of two 128-row groups
    (both nibble positions of every packed row, and the group edge), with
    all 256 byte values in every packed row."""
    k, n = 256, 256
    codes = (torch.arange(k // 2, device=cuda)[:, None]
             + torch.arange(n, device=cuda)[None, :]) % 256 - 128
    q4 = codes.to(torch.int8)
    gen = torch.Generator(device=cuda).manual_seed(15)
    s = torch.rand((2, n), generator=gen, device=cuda) * 0.05 + 1e-3
    want = quant.dequantize_int4({"q4": q4, "s": s}, torch.bfloat16)
    before = quant.int4_matmul.launches
    for row in range(k):
        x = torch.zeros((1, k), device=cuda, dtype=torch.bfloat16)
        x[0, row] = 1.0
        got = quant.int4_matmul(x, q4, s)
        assert torch.equal(got[0], want[row]), row
    assert quant.int4_matmul.launches == before + k


def test_int4_matmul_raises_on_what_the_kernel_does_not_take(cuda):
    """At a kernel shape a wrong dtype or shape raises; it never takes
    the plain version on the card."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn((8, 512), generator=gen, device=cuda)
    q4, s = _int4_weight(gen, cuda, 512, 256, 128)
    with pytest.raises(TypeError):
        quant.int4_matmul(x, q4, s)                      # f32 activations
    xb = x.to(torch.bfloat16)
    with pytest.raises(TypeError):
        quant.int4_matmul(xb, q4, s.double())
    with pytest.raises(TypeError):
        quant.int4_matmul_scale_first(xb, q4.to(torch.int16), s)
    with pytest.raises(ValueError):
        quant.int4_matmul_scale_first(xb, q4, s[:, :128])   # wrong N
    with pytest.raises(ValueError):                          # 96-row groups
        quant.int4_matmul_scale_first(
            torch.randn((8, 576), device=cuda, dtype=torch.bfloat16),
            *_int4_weight(gen, cuda, 576, 256, 96))
    with pytest.raises(ValueError):                          # m > 64
        quant.int4_matmul_scale_first(xb.repeat(9, 1), q4, s)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k,n", [(4096, 1024), (352, 96), (14336, 256)])
def test_quantizers_on_the_card_equal_the_cpu(cuda, bits, k, n):
    """quantize_int8 / quantize_int4 on a CUDA tensor: codes and scales
    bit-equal to the same call on the CPU (which the CPU tests hold
    bit-equal to the JAX package); a division by a Python scalar would be
    a reciprocal multiply on the card, one ulp off in places."""
    rng = np.random.default_rng(k + n + bits)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    w[:, 0] = 0.0
    fn = quant.quantize_int8 if bits == 8 else quant.quantize_int4
    want = fn(w)
    got = fn(w.to(cuda))
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key].cpu(), want[key]), key


@pytest.mark.parametrize("kv_heads", [4, 1])
@pytest.mark.parametrize("window", [None, 16, 40])
@pytest.mark.parametrize("q_len,k_len,hd", [(64, 64, 32), (32, 96, 64),
                                            (100, 100, 128), (1, 70, 16),
                                            (256, 256, 128), (200, 330, 64)])
def test_flash_attention_kernel(cuda, kv_heads, window, q_len, k_len, hd):
    """bf16 (the kernel's type): GQA, window, q_len < k_len, ragged
    tiles on both axes."""
    dtype = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(q_len + k_len)
    q = torch.randn((2, 4, q_len, hd), generator=gen, device=cuda)
    k = torch.randn((2, kv_heads, k_len, hd), generator=gen, device=cuda)
    v = torch.randn((2, kv_heads, k_len, hd), generator=gen, device=cuda)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = attention.flash_attention.launches
    got = attention.flash_attention(q, k, v, window=window)
    assert attention.flash_attention.launches == before + 1
    group = 4 // kv_heads
    want = attention.attention_reference(
        q.float(), k.float().repeat_interleave(group, 1),
        v.float().repeat_interleave(group, 1), window=window)
    _close(got, want, dtype)


def test_flash_attention_strided_inputs(cuda):
    """The llama path hands (batch, seq, heads, hd) tensors transposed."""
    x = torch.randn((2, 48, 4, 32), device=cuda, dtype=torch.bfloat16)
    kv = torch.randn((2, 48, 2, 32), device=cuda, dtype=torch.bfloat16)
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    got = attention.flash_attention(q, k, k)
    k32 = k.float().repeat_interleave(2, 1)
    want = attention.attention_reference(q.float(), k32, k32)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("q_len,k_len", [(1, 1), (1, 300), (65, 65),
                                         (129, 200), (1000, 1000),
                                         (2048, 2048)])
def test_flash_attention_long_and_ragged(cuda, q_len, k_len, window):
    """head_dim 128, group 4: one query, ragged 64-row tiles (65, 129),
    k_len > q_len, and long rows whose causal tiles run longest first."""
    gen = torch.Generator(device=cuda).manual_seed(q_len * 7 + k_len)
    q = torch.randn((1, 8, q_len, 128), generator=gen, device=cuda)
    k = torch.randn((1, 2, k_len, 128), generator=gen, device=cuda)
    v = torch.randn((1, 2, k_len, 128), generator=gen, device=cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    got = attention.flash_attention(q, k, v, window=window)
    want = attention.attention_reference(
        q.float(), k.float().repeat_interleave(4, 1),
        v.float().repeat_interleave(4, 1), window=window)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (6, 2), (8, 1),
                                            (64, 1)])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_attention_every_head_dim_and_group(cuda, hd, heads, kv_heads,
                                                  causal):
    """Every head_dim of the envelope (32-, 64- and 128-byte swizzles),
    groups that fill 64 tile rows (1, 8, 64 heads) and one that does not
    (3 heads: 21 queries, 63 rows), causal and not."""
    gen = torch.Generator(device=cuda).manual_seed(hd + heads)
    q = torch.randn((2, heads, 100, hd), generator=gen, device=cuda)
    k = torch.randn((2, kv_heads, 160, hd), generator=gen, device=cuda)
    v = torch.randn((2, kv_heads, 160, hd), generator=gen, device=cuda)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    got = attention.flash_attention(q, k, v, causal=causal)
    group = heads // kv_heads
    want = attention.attention_reference(
        q.float(), k.float().repeat_interleave(group, 1),
        v.float().repeat_interleave(group, 1), causal=causal)
    _close(got, want, torch.bfloat16)


def test_flash_attention_llama_layout(cuda):
    """llama's prefill: q and k are slices of one (batch, seq, heads +
    kv_heads, hd) RoPE output, v its own tensor, all transposed to
    (batch, heads, seq, hd): the tensor maps take the strides as given."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    qk = torch.randn((2, 300, 8 + 2, 128), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    v = torch.randn((2, 300, 2, 128), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    q, k = qk[:, :, :8].transpose(1, 2), qk[:, :, 8:].transpose(1, 2)
    got = attention.flash_attention(q, k, v.transpose(1, 2))
    want = attention.attention_reference(
        q.float(), k.float().repeat_interleave(4, 1),
        v.transpose(1, 2).float().repeat_interleave(4, 1))
    _close(got, want, torch.bfloat16)


def test_flash_attention_raises_on_what_tma_does_not_take(cuda):
    """The wrapper raises, never falls back: types other than bf16, a
    feature axis that is not contiguous, a stride that is not a multiple
    of 8 elements (16 bytes), a start that is not 16-byte aligned, and a
    group wider than the kernel's 64 tile rows."""
    def qkv(heads=4, kv_heads=2, hd=32, dtype=torch.bfloat16):
        return (torch.randn((1, heads, 64, hd), device=cuda).to(dtype),
                torch.randn((1, kv_heads, 64, hd), device=cuda).to(dtype),
                torch.randn((1, kv_heads, 64, hd), device=cuda).to(dtype))

    before = attention.flash_attention.launches
    for dtype in (torch.float16, torch.float32):
        with pytest.raises(TypeError):
            attention.flash_attention(*qkv(dtype=dtype))
    q, k, v = qkv()
    wide = torch.randn((1, 4, 64, 64), device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError):      # feature axis of stride 2
        attention.flash_attention(wide[..., ::2], k, v)
    odd = torch.randn((1, 4, 64, 36), device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError):      # rows 36 elements (72 bytes) apart
        attention.flash_attention(odd[..., :32], k, v)
    flat = torch.randn(4 * 64 * 32 + 1, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError):      # start 2 bytes past alignment
        attention.flash_attention(flat[1:].reshape(1, 4, 64, 32), k, v)
    with pytest.raises(ValueError):      # 65 query heads on one kv head
        attention.flash_attention(*qkv(heads=65, kv_heads=1))
    assert attention.flash_attention.launches == before


def _pool(cuda, gen, batch, kv, group, hd, bs, max_blocks, dtype, quant_kv):
    n_blocks = batch * max_blocks + 1
    q = torch.randn((batch, kv, group, hd), generator=gen, device=cuda)
    k = torch.randn((n_blocks, bs, kv, hd), generator=gen, device=cuda)
    v = torch.randn((n_blocks, bs, kv, hd), generator=gen, device=cuda)
    ids = torch.randperm(n_blocks - 1, generator=gen, device=cuda) + 1
    tables = ids[:batch * max_blocks].reshape(batch, max_blocks) \
        .to(torch.int32)
    scales = {}
    if quant_kv:
        k, ks = llama._kv_quantize(k)
        v, vs = llama._kv_quantize(v)
        scales = dict(ks=ks, vs=vs)
    else:
        k, v = k.to(dtype), v.to(dtype)
    return q.to(dtype), k, v, tables, scales


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("quant_kv", [False, True])
@pytest.mark.parametrize("kv,group", [(1, 1), (1, 4), (1, 8), (2, 4)])
@pytest.mark.parametrize("window", [None, 3, 40])
@pytest.mark.parametrize("bs", [16, 128])
def test_paged_decode_kernel(cuda, dtype, quant_kv, kv, group, window, bs):
    gen = torch.Generator(device=cuda).manual_seed(kv * 10 + group + bs)
    max_blocks = 4
    q, k, v, tables, scales = _pool(cuda, gen, 4, kv, group, 32, bs,
                                    max_blocks, dtype, quant_kv)
    last = bs * max_blocks - 1
    positions = torch.tensor([0, bs - 1, bs, last], dtype=torch.int32,
                             device=cuda)
    before = paged_attention.paged_decode_attention.launches
    got = paged_attention.paged_decode_attention(
        q, k, v, tables, positions, window=window, **scales)
    assert paged_attention.paged_decode_attention.launches == before + 1
    again = paged_attention.paged_decode_attention(
        q, k, v, tables, positions, window=window, **scales)
    assert torch.equal(got, again)      # the block merge is ordered
    pools = (k, v) if quant_kv else (k.float(), v.float())
    want = paged_attention.paged_decode_reference(
        q.float(), *pools, tables, positions, window=window, **scales)
    _close(got, want, dtype)


#: Row positions of the split tests: one key, a block edge, a split's
#: last key, the next split's first, a row of more than 80 16-row blocks,
#: and the table's last key (positions are clipped to the table).
SPLIT_POSITIONS = (0, 15, 255, 256, 1300, 1535)
#: pool dtype -> q dtype of the split tests.
SPLIT_POOLS = {"bf16": torch.bfloat16, "f32": torch.float32,
               "int8": torch.bfloat16}


def _split_case(cuda, seed, bs, pool, rows, window, wide=200):
    """Rows at SPLIT_POSITIONS (cycled) over 1,536 keys of bs-row blocks
    in a table `wide` entries wide (much wider than any row's live blocks):
    every entry past a row's last live block, or below its window, holds -1,
    which the kernel must never read (the plain versions mask those keys)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    kv, group, hd = 2, 4, 64
    live_blocks = 1536 // bs
    q, k, v, _, scales = _pool(cuda, gen, rows, kv, group, hd, bs,
                               live_blocks, SPLIT_POOLS[pool],
                               pool == "int8")
    if pool == "f32":
        q = q.float()
    ids = torch.randperm(k.shape[0] - 1, generator=gen, device=cuda)
    ids = (ids[:rows * live_blocks] + 1).reshape(rows, live_blocks)
    positions = torch.tensor([SPLIT_POSITIONS[i % len(SPLIT_POSITIONS)]
                              for i in range(rows)], dtype=torch.int32,
                             device=cuda)
    tables = torch.full((rows, wide), -1, dtype=torch.int32, device=cuda)
    for r, pos in enumerate(positions.tolist()):
        first = max(pos - window + 1, 0) // bs if window else 0
        last = pos // bs
        tables[r, first:last + 1] = ids[r, first:last + 1].to(torch.int32)
    return q, k, v, tables, positions, scales


@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("pool", sorted(SPLIT_POOLS))
@pytest.mark.parametrize("bs", [16, 128])
def test_paged_decode_splits(cuda, bs, pool, window):
    """Rows spanning several 256-key splits, positions on split and block
    edges, a one-key row, a window that cuts a split, a table far wider
    than its live blocks (its dead entries are -1): the kernel against the
    plain split-and-merge version (f32) and the one-shot plain version,
    and bitwise equal across two calls."""
    q, k, v, tables, positions, scales = _split_case(
        cuda, bs + len(pool), bs, pool, 6, window)
    got = paged_attention.paged_decode_attention(
        q, k, v, tables, positions, window=window, **scales)
    again = paged_attention.paged_decode_attention(
        q, k, v, tables, positions, window=window, **scales)
    assert torch.equal(got, again)
    pools = (k, v) if pool == "int8" else (k.float(), v.float())
    safe = tables.clamp_min(0)      # the plain versions gather every entry
    want = paged_attention.paged_decode_split_reference(
        q.float(), *pools, safe, positions, window=window, **scales)
    _close(got, want, q.dtype)
    plain = paged_attention.paged_decode_reference(
        q.float(), *pools, safe, positions, window=window, **scales)
    _close(got, plain, q.dtype)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("bs", [16, 128])
def test_paged_decode_is_batch_invariant(cuda, bs, pool):
    """A row's output is bitwise the same alone and among 8 and 64 rows
    of other lengths: the splits depend on the block size alone."""
    q, k, v, tables, positions, scales = _split_case(
        cuda, 40 + bs, bs, pool, 64, None)
    alone = paged_attention.paged_decode_attention(
        q[4:5], k, v, tables[4:5], positions[4:5], **scales)
    for rows in (8, 64):
        among = paged_attention.paged_decode_attention(
            q[:rows], k, v, tables[:rows], positions[:rows], **scales)
        assert torch.equal(among[4:5], alone), rows


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_server_on_the_card_matches_batch1_oracle(cuda, quantize_kv):
    """tiny with int8 weights on the card: the served greedy tokens equal
    the batch-1 prefill + generate_tokens oracle on the same kernels."""
    config = llama.CONFIGS["tiny"]
    server = ContinuousBatchingServer(config_name="tiny", slots=3,
                                      max_seq=128, chunk_steps=4,
                                      quantize=True,
                                      quantize_kv=quantize_kv, seed=1)
    assert server.device.type == "cuda"
    assert server.decode_attention_path == "kernel"
    rng = np.random.default_rng(2)
    requests = [DecodeRequest(f"r{i}", rng.integers(1, 1024, plen)
                              .astype(np.int32), new)
                for i, (plen, new) in enumerate(
                    [(5, 6), (30, 9), (17, 4), (40, 7)])]
    counts = (quant.int8_matmul.launches,
              attention.flash_attention.launches,
              paged_attention.paged_decode_attention.launches)
    for request in requests:
        server.submit(request)
    server.run_until_drained()
    assert quant.int8_matmul.launches > counts[0]
    assert attention.flash_attention.launches > counts[1]
    assert paged_attention.paged_decode_attention.launches > counts[2]
    for request in requests:
        prompt = torch.as_tensor(request.prompt, device=cuda)[None]
        cache = llama.init_cache(config, 1, server.max_seq,
                                 quantize_kv=quantize_kv)
        logits, cache = llama.prefill(server.params, prompt, cache, config)
        first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        rest, _ = llama.generate_tokens(server.params, first, cache,
                                        prompt.shape[1],
                                        request.max_new_tokens - 1, config)
        want = [int(first[0, 0])] + rest[0].tolist()
        assert request.tokens == want, request.request_id


def _chunk_case(cuda, seed, batch, kv, group, hd, cached_blocks, chunk_lens,
                T, quant_kv, bs=16, max_blocks=None):
    """A shuffled-table pool holding ``cached_blocks`` resident blocks per
    row and a ragged ``T``-wide chunk (``chunk_lens`` real tokens)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    max_blocks = max_blocks or max(cached_blocks) + T // bs + 1
    n_blocks = batch * max_blocks + 1
    ids = torch.randperm(n_blocks - 1, generator=gen, device=cuda) + 1
    tables = ids.reshape(batch, max_blocks).to(torch.int32)
    k = torch.randn((n_blocks, bs, kv, hd), generator=gen, device=cuda)
    v = torch.randn((n_blocks, bs, kv, hd), generator=gen, device=cuda)
    if quant_kv:
        k, ks = llama._kv_quantize(k)
        v, vs = llama._kv_quantize(v)
        pool = dict(k=k, v=v, ks=ks, vs=vs)
    else:
        pool = dict(k=k.to(torch.bfloat16), v=v.to(torch.bfloat16))
    q = torch.randn((batch, T, kv, group, hd), generator=gen,
                    device=cuda).to(torch.bfloat16)
    k_new = torch.randn((batch, T, kv, hd), generator=gen,
                        device=cuda).to(torch.bfloat16)
    v_new = torch.randn((batch, T, kv, hd), generator=gen,
                        device=cuda).to(torch.bfloat16)
    cached = torch.tensor([c * bs for c in cached_blocks], dtype=torch.int32,
                          device=cuda)
    chunk = torch.tensor(chunk_lens, dtype=torch.int32, device=cuda)
    return q, k_new, v_new, pool, tables, cached, chunk


CHUNK_SHAPES = {
    # (batch, kv, group, hd, cached_blocks, chunk_lens, T)
    "tiny": (3, 2, 2, 32, (0, 1, 2), (32, 17, 5), 32),
    "tiny_gqa8": (2, 1, 8, 32, (2, 0), (16, 9), 16),
    "llama3_8b": (2, 8, 4, 128, (4, 0), (64, 40), 64),
    "llama3_8b_long": (1, 8, 4, 128, (64,), (256,), 256),
}


@pytest.mark.parametrize("quant_kv", [False, True])
@pytest.mark.parametrize("shape", sorted(CHUNK_SHAPES))
def test_append_kv_kernel(cuda, shape, quant_kv):
    """The pool after the kernel is bitwise the pool after the plain
    version (int8: the same codes and scales) everywhere but scratch block
    0, where the plain version flushes the dead blocks of short rows."""
    q, k_new, v_new, pool, tables, cached, chunk = _chunk_case(
        cuda, len(shape), *CHUNK_SHAPES[shape], quant_kv)
    plain = {key: buf.clone() for key, buf in pool.items()}
    before = paged_prefill.append_kv.launches
    paged_prefill.append_kv(k_new, v_new, pool, tables, cached, chunk)
    assert paged_prefill.append_kv.launches == before + 1
    paged_prefill.append_kv_reference(k_new, v_new, plain, tables, cached,
                                      chunk)
    for key in pool:
        assert torch.equal(pool[key][1:], plain[key][1:]), key


@pytest.mark.parametrize("quant_kv", [False, True])
@pytest.mark.parametrize("window", [None, 3, 40])
@pytest.mark.parametrize("shape", sorted(CHUNK_SHAPES))
def test_chunk_attention_kernel(cuda, shape, window, quant_kv):
    """bf16 queries over bf16 or int8 pools, shuffled tables, ragged
    chunks, windows: the real rows against the f32 plain version."""
    q, k_new, v_new, pool, tables, cached, chunk = _chunk_case(
        cuda, 7 + len(shape), *CHUNK_SHAPES[shape], quant_kv)
    paged_prefill.append_kv(k_new, v_new, pool, tables, cached, chunk)
    before = paged_prefill.chunk_attention.launches
    got = paged_prefill.chunk_attention(q, pool, tables, cached, chunk,
                                        window=window)
    assert paged_prefill.chunk_attention.launches == before + 1
    plain = pool if quant_kv else {key: buf.float()
                                   for key, buf in pool.items()}
    want = paged_prefill.chunk_attention_reference(q.float(), plain, tables,
                                                   cached, window=window)
    for row, length in enumerate(chunk.tolist()):
        _close(got[row, :length], want[row, :length], torch.bfloat16)


@pytest.mark.parametrize("quant_kv", [False, True])
def test_chunk_attention_rows_without_a_visible_key(cuda, quant_kv):
    """Window 8 over 64 cached tokens: the first live key tile (keys
    0..63) holds the window of the tile's first queries only; later rows
    of the same tile see none of its keys, and must carry no mass from
    it."""
    q, k_new, v_new, pool, tables, cached, chunk = _chunk_case(
        cuda, 3, 1, 2, 4, 64, (4,), (64,), 64, quant_kv)
    paged_prefill.append_kv(k_new, v_new, pool, tables, cached, chunk)
    got = paged_prefill.chunk_attention(q, pool, tables, cached, chunk,
                                        window=8)
    plain = pool if quant_kv else {key: buf.float()
                                   for key, buf in pool.items()}
    want = paged_prefill.chunk_attention_reference(q.float(), plain, tables,
                                                   cached, window=8)
    _close(got[0], want[0], torch.bfloat16)


def test_paged_prefill_outside_the_envelope_raises_on_the_card(cuda):
    """A chunk that is not block-aligned has no kernel: on CUDA tensors
    the entry point raises and leaves the pool as it was (the plain
    reference is the CPU path only)."""
    q, k_new, v_new, pool, tables, cached, chunk = _chunk_case(
        cuda, 5, 1, 2, 2, 32, (1,), (24,), 24, False, max_blocks=4)
    before = {key: buf.clone() for key, buf in pool.items()}
    with pytest.raises(ValueError, match="envelope"):
        paged_prefill.paged_prefill_attention(q, k_new, v_new, pool, tables,
                                              cached, chunk)
    for key in pool:
        assert torch.equal(pool[key], before[key]), key


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_paged_server_on_the_card_matches_batch1_oracle(cuda, quantize_kv):
    """tiny with int8 weights through the paged server on the card, prefix
    cache on, 16-token chunked admission (mixed and standalone slices):
    every request's tokens equal a batch-1 paged run of the same request
    with the prefix cache off (the same kernels, the same slices)."""
    rng = np.random.default_rng(3)
    system = rng.integers(1, 1024, 48).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(1, 1024, tail)
                               .astype(np.int32)]) for tail in (5, 20, 9)]
    prompts += [rng.integers(1, 1024, n).astype(np.int32) for n in (7, 70)]
    kwargs = dict(config_name="tiny", max_seq=256, chunk_steps=4,
                  quantize=True, quantize_kv=quantize_kv, seed=1,
                  block_size=16, chunk_prefill_tokens=16)
    server = PagedContinuousServer(slots=3, enable_prefix_cache=True,
                                   **kwargs)
    assert server.decode_attention_path == "kernel"
    counts = (paged_prefill.append_kv.launches,
              paged_prefill.chunk_attention.launches)
    requests = [DecodeRequest(f"r{i}", p, 6) for i, p in enumerate(prompts)]
    for request in requests[:2]:
        server.submit(request)
    server.run_until_drained()
    for request in requests[2:]:
        server.submit(request)
    server.run_until_drained()
    slices = server.counters["prefill_dispatches"]
    layers = server.config.n_layers
    assert paged_prefill.append_kv.launches - counts[0] == layers * slices
    assert paged_prefill.chunk_attention.launches - counts[1] \
        == layers * slices
    assert server.prefix_hits > 0
    balance = server.pool_balance()
    assert balance["free"] + balance["evictable"] + balance["producing"] \
        == balance["total"]
    oracle = PagedContinuousServer(slots=1, params=server.params, **kwargs)
    for request in requests:
        alone = DecodeRequest("o", request.prompt, 6)
        oracle.submit(alone)
        oracle.run_until_drained()
        assert request.tokens == alone.tokens, request.request_id


#: chip_smoke.py phase 2's ragged grid: per-row verify starts (some spans
#: inside one block, some across a block edge) and chunk lengths (the last
#: row idle).
RAGGED_STARTS = (0, 15, 16, 17, 1023, 1030, 40, 5)


def _ragged_case(cuda, seed, T, kv, hd, quant_kv, in_dtype=torch.bfloat16,
                 starts=RAGGED_STARTS, chunk_lens=None, bs=16):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    rows = len(starts)
    chunk_lens = chunk_lens or (T, T, max(T - 1, 1), T, T, 1, T, 0)
    max_blocks = (max(starts) + T) // bs + 2
    n_blocks = rows * max_blocks + 1
    ids = torch.randperm(n_blocks - 1, generator=gen, device=cuda) + 1
    tables = ids.reshape(rows, max_blocks).to(torch.int32)
    k = torch.randn((n_blocks, bs, kv, hd), generator=gen, device=cuda)
    v = torch.randn((n_blocks, bs, kv, hd), generator=gen, device=cuda)
    if quant_kv:
        k, ks = llama._kv_quantize(k)
        v, vs = llama._kv_quantize(v)
        pool = dict(k=k, v=v, ks=ks, vs=vs)
    else:
        pool = dict(k=k.to(torch.bfloat16), v=v.to(torch.bfloat16))
    k_new = torch.randn((rows, T, kv, hd), generator=gen, device=cuda)
    v_new = torch.randn((rows, T, kv, hd), generator=gen, device=cuda)
    k_new[0, 0, 0] = 0.0                  # an all-zero vector: scale 1
    cached = torch.tensor(starts, dtype=torch.int32, device=cuda)
    chunk = torch.tensor(chunk_lens, dtype=torch.int32, device=cuda)
    return k_new.to(in_dtype), v_new.to(in_dtype), pool, tables, cached, chunk


@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("quant_kv", [False, True])
@pytest.mark.parametrize("T", [2, 5, 9, 17])
@pytest.mark.parametrize("kv,hd", [(2, 32), (8, 128), (8, 64)])
def test_append_kv_ragged_kernel(cuda, kv, hd, T, quant_kv, in_dtype):
    """Every pool byte after the kernel equals the plain version's (block 0
    included: neither writes anything past a row's chunk_len), so rows
    outside the live windows stay as they were."""
    k_new, v_new, pool, tables, cached, chunk = _ragged_case(
        cuda, T * kv + hd, T, kv, hd, quant_kv, in_dtype)
    plain = {key: buf.clone() for key, buf in pool.items()}
    before = paged_prefill.append_kv_ragged.launches
    paged_prefill.append_kv_ragged(k_new, v_new, pool, tables, cached, chunk)
    assert paged_prefill.append_kv_ragged.launches == before + 1
    paged_prefill.append_kv_ragged_reference(k_new, v_new, plain, tables,
                                             cached, chunk)
    for key in pool:
        assert torch.equal(pool[key], plain[key]), key


def test_append_kv_ragged_rejects_non_int32_tables(cuda):
    k_new, v_new, pool, tables, cached, chunk = _ragged_case(
        cuda, 1, 5, 2, 32, False)
    before = {key: buf.clone() for key, buf in pool.items()}
    with pytest.raises(TypeError, match="int32"):
        paged_prefill.append_kv_ragged(k_new, v_new, pool,
                                       tables.to(torch.int64), cached, chunk)
    for key in pool:
        assert torch.equal(pool[key], before[key]), key


# --------------------------------------------------------------------------- #
# The KV writer (csrc/kv_write.cu): its aligned, ragged and row modes
# against their plain versions, byte for byte.

WRITER_IN = {"bf16": torch.bfloat16, "f32": torch.float32}
WRITER_POOLS = ("bf16", "f32", "int8")


def _writer_pool(cuda, gen, n_blocks, bs, kv, hd, pool_dtype):
    """A random pool: bf16 or f32 values, or int8 codes and scales from
    the plain quantizer."""
    k = torch.randn((n_blocks, bs, kv, hd), generator=gen, device=cuda)
    v = torch.randn((n_blocks, bs, kv, hd), generator=gen, device=cuda)
    if pool_dtype == "int8":
        (k, ks), (v, vs) = llama._kv_quantize(k), llama._kv_quantize(v)
        return dict(k=k, v=v, ks=ks, vs=vs)
    dtype = WRITER_IN[pool_dtype]
    return dict(k=k.to(dtype), v=v.to(dtype))


def _writer_tables(cuda, gen, n_blocks, rows, entries):
    """Distinct shuffled pool blocks (never scratch block 0)."""
    ids = torch.randperm(n_blocks - 1, generator=gen,
                         device=cuda)[:rows * entries] + 1
    return ids.to(torch.int32).reshape(rows, entries).contiguous()


def _writer_rows(cuda, gen, rows, T, kv, hd, in_dtype):
    k_new = torch.randn((rows, T, kv, hd), generator=gen, device=cuda)
    v_new = torch.randn((rows, T, kv, hd), generator=gen, device=cuda)
    k_new[0, 0, 0] = 0.0                  # an all-zero vector: scale 1
    return k_new.to(WRITER_IN[in_dtype]), v_new.to(WRITER_IN[in_dtype])


def _assert_pools_equal(got, want, skip_scratch):
    for key in got:
        first = 1 if skip_scratch else 0
        assert torch.equal(got[key][first:], want[key][first:]), key


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("pool_dtype", WRITER_POOLS)
@pytest.mark.parametrize("in_dtype", sorted(WRITER_IN))
@pytest.mark.parametrize("T,bs", [(16, 16), (256, 16), (256, 128)])
def test_append_kv_writer_aligned(cuda, T, bs, in_dtype, pool_dtype, hd):
    """append_kv: three rows after 0, 2 and 5 cached blocks with chunks of
    T, T / 2 + 3 (a part-live last block) and 0 tokens; every block but
    scratch 0 (where the plain version flushes the dead blocks) byte-equal
    to the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(T + bs + hd)
    kv, rows = 8, 3
    cached_blocks = (0, 2, 5)
    entries = max(cached_blocks) + T // bs + 1
    n_blocks = rows * entries + 1
    pool = _writer_pool(cuda, gen, n_blocks, bs, kv, hd, pool_dtype)
    tables = _writer_tables(cuda, gen, n_blocks, rows, entries)
    k_new, v_new = _writer_rows(cuda, gen, rows, T, kv, hd, in_dtype)
    cached = torch.tensor([c * bs for c in cached_blocks], dtype=torch.int32,
                          device=cuda)
    chunk = torch.tensor([T, T // 2 + 3, 0], dtype=torch.int32, device=cuda)
    plain = {key: buf.clone() for key, buf in pool.items()}
    before = paged_prefill.append_kv.launches
    paged_prefill.append_kv(k_new, v_new, pool, tables, cached, chunk)
    assert paged_prefill.append_kv.launches == before + 1
    paged_prefill.append_kv_reference(k_new, v_new, plain, tables, cached,
                                      chunk)
    _assert_pools_equal(pool, plain, skip_scratch=True)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("pool_dtype", WRITER_POOLS)
@pytest.mark.parametrize("in_dtype", sorted(WRITER_IN))
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("T", [1, 5, 17])
def test_append_kv_writer_ragged(cuda, T, bs, in_dtype, pool_dtype, hd):
    """append_kv_ragged: eight rows at unaligned starts (one a row short of
    a block's end, one at a block's start, two deep in a long row), chunks
    of T, T - 1 and 1 tokens and an idle row; every pool byte equal to the
    plain version's (neither writes past a row's chunk_len)."""
    gen = torch.Generator(device=cuda).manual_seed(T * bs + hd)
    kv = 8
    starts = (0, bs - 1, bs, bs + 1, 1023, 1030, 40, 5)
    lens = (T, T, max(T - 1, 1), T, T, 1, T, 0)
    rows = len(starts)
    entries = (max(starts) + T) // bs + 2
    n_blocks = rows * entries + 1
    pool = _writer_pool(cuda, gen, n_blocks, bs, kv, hd, pool_dtype)
    tables = _writer_tables(cuda, gen, n_blocks, rows, entries)
    k_new, v_new = _writer_rows(cuda, gen, rows, T, kv, hd, in_dtype)
    cached = torch.tensor(starts, dtype=torch.int32, device=cuda)
    chunk = torch.tensor(lens, dtype=torch.int32, device=cuda)
    plain = {key: buf.clone() for key, buf in pool.items()}
    before = paged_prefill.append_kv_ragged.launches
    paged_prefill.append_kv_ragged(k_new, v_new, pool, tables, cached, chunk)
    assert paged_prefill.append_kv_ragged.launches == before + 1
    paged_prefill.append_kv_ragged_reference(k_new, v_new, plain, tables,
                                             cached, chunk)
    _assert_pools_equal(pool, plain, skip_scratch=False)


def _plant_division_ties(rows):
    """``chip_smoke.plant_division_ties`` (the smoke's generator of
    vectors [m, m / 2, ...] whose codes a reciprocal multiply rounds
    otherwise than a true division) on the (n, hd) ``rows``."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    chip_smoke.plant_division_ties(torch, rows)


@pytest.mark.parametrize("in_dtype", sorted(WRITER_IN))
@pytest.mark.parametrize("mode", ["aligned", "ragged", "rows"])
def test_write_kv_int8_divides_by_the_scale(cuda, mode, in_dtype):
    """Vectors whose codes a reciprocal multiply would round otherwise than
    the plain quantizer's true division: every mode writes the plain
    version's codes and scales."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    rows = 16
    T = 16 if mode == "aligned" else 1
    batch = rows // T
    pool = _writer_pool(cuda, gen, 33, 16, 2, 128, "int8")
    k = torch.empty((rows * 2, 128), device=cuda)
    _plant_division_ties(k)
    m = k[:, 0].clone()
    k = k.reshape(batch, T, 2, 128).to(WRITER_IN[in_dtype])
    scale = m / torch.full_like(m, 127.0)
    assert bool(((m / 2 / scale).round()
                 != (m / 2 * (1 / scale)).round()).any())
    tables = _writer_tables(cuda, gen, 33, batch, 2)
    positions = torch.arange(batch, dtype=torch.int32, device=cuda) * 3 % 32
    plain = {key: buf.clone() for key, buf in pool.items()}
    if mode == "rows":
        paged_prefill.write_kv_rows(k, k, pool, tables, positions)
        paged_prefill.write_kv_rows_reference(k, k, plain, tables, positions)
    else:
        append = {"aligned": paged_prefill.append_kv,
                  "ragged": paged_prefill.append_kv_ragged}[mode]
        reference = {"aligned": paged_prefill.append_kv_reference,
                     "ragged": paged_prefill.append_kv_ragged_reference}[mode]
        meta = (positions * (16 if mode == "aligned" else 1),
                torch.full((batch,), T, dtype=torch.int32, device=cuda))
        append(k, k, pool, tables, *meta)
        reference(k, k, plain, tables, *meta)
    _assert_pools_equal(pool, plain, skip_scratch=True)


def _decode_write_case(cuda, gen, slots, bs, kv, hd, in_dtype, pool_dtype):
    """One decode step's write as ``llama._paged_step_core`` issues it:
    ``k`` a slice of the fused q/k tensor, a quarter of the slots inactive
    and redirected to scratch block 0 at offset ``slot % bs``."""
    entries = 1024 // bs + 1
    n_blocks = slots * entries + 1
    pool = _writer_pool(cuda, gen, n_blocks, bs, kv, hd, pool_dtype)
    tables = _writer_tables(cuda, gen, n_blocks, slots, entries)
    fused = torch.randn((slots, 1, 5 * kv, hd), generator=gen, device=cuda)
    k = fused.to(WRITER_IN[in_dtype])[:, :, 4 * kv:]
    v = torch.randn((slots, 1, kv, hd), generator=gen,
                    device=cuda).to(WRITER_IN[in_dtype])
    positions = torch.randint(0, 1024, (slots,), generator=gen, device=cuda,
                              dtype=torch.int32)
    positions[:4] = torch.tensor([0, bs - 1, bs, 1023], dtype=torch.int32)
    active = torch.arange(slots, device=cuda) % 4 != 3
    slot_offsets = torch.arange(slots, device=cuda, dtype=torch.int32) % bs
    tables = torch.where(active[:, None], tables, torch.zeros_like(tables))
    positions = torch.where(active, positions, slot_offsets)
    return k, v, pool, tables, positions


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("pool_dtype", WRITER_POOLS)
@pytest.mark.parametrize("in_dtype", sorted(WRITER_IN))
@pytest.mark.parametrize("bs", [16, 128])
@pytest.mark.parametrize("slots", [8, 64])
def test_write_kv_rows_kernel(cuda, slots, bs, in_dtype, pool_dtype, hd):
    """The decode write: every block but scratch 0 (where inactive lanes
    s and s + bs may land on one row, in either order) byte-equal to the
    plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(slots + bs + hd)
    k, v, pool, tables, positions = _decode_write_case(
        cuda, gen, slots, bs, 8, hd, in_dtype, pool_dtype)
    assert not k.is_contiguous()
    plain = {key: buf.clone() for key, buf in pool.items()}
    before = paged_prefill.write_kv_rows.launches
    paged_prefill.write_kv_rows(k, v, pool, tables, positions)
    assert paged_prefill.write_kv_rows.launches == before + 1
    paged_prefill.write_kv_rows_reference(k, v, plain, tables, positions)
    _assert_pools_equal(pool, plain, skip_scratch=True)


@pytest.mark.parametrize("quantize_kv", [False, True])
@pytest.mark.parametrize("slots", [8, 64])
def test_write_kv_rows_contiguous_cache(cuda, slots, quantize_kv):
    """llama's ``_cache_write_rows`` on the card: the row writer over a
    (slots, 1024, 8, 128) cache as a pool of one block a row, inactive
    slots at the scratch row 1023; every byte equal to the plain write."""
    gen = torch.Generator(device=cuda).manual_seed(slots)
    config = dataclasses.replace(llama.CONFIGS["llama3_8b"], n_layers=1)
    cache = llama.init_cache(config, slots, 1024, quantize_kv=quantize_kv,
                             device=cuda)[0]
    fused = torch.randn((slots, 1, 40, 128), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    k, v = fused[:, :, 32:], fused[:, :, :8].contiguous()
    positions = torch.randint(0, 1023, (slots,), generator=gen, device=cuda,
                              dtype=torch.int32)
    positions[::5] = 1023
    plain = {key: buf.clone() for key, buf in cache.items()}
    before = paged_prefill.write_kv_rows.launches
    llama._cache_write_rows(cache, k, v, llama._cache_rows(positions))
    assert paged_prefill.write_kv_rows.launches == before + 1
    paged_prefill.write_kv_rows_reference(
        k, v, plain, torch.arange(slots, device=cuda,
                                  dtype=torch.int32)[:, None], positions)
    _assert_pools_equal(cache, plain, skip_scratch=False)


def test_write_kv_rows_layer_plan_follows_replaced_buffers(cuda):
    """A cache layer keeps its buffers as the row writer checked them on
    its first write; a buffer replaced afterwards is checked and written,
    never the one it replaced, and a plain dict of the same buffers
    writes the same bytes."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    config = dataclasses.replace(llama.CONFIGS["llama3_8b"], n_layers=1)
    cache = llama.init_cache(config, 8, 256, device=cuda)[0]
    assert isinstance(cache, paged_prefill.KVLayer) \
        and cache.row_plan is None
    k = torch.randn((8, 1, 8, 128), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    v = torch.randn((8, 1, 8, 128), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    positions = torch.arange(8, dtype=torch.int32, device=cuda) * 31
    rows = llama._cache_rows(positions)
    llama._cache_write_rows(cache, k, v, rows)
    plan = cache.row_plan
    assert plan is not None and plan.holds(cache)
    old_k = cache["k"]
    cache["k"] = torch.zeros_like(old_k)
    kept = old_k.clone()
    llama._cache_write_rows(cache, -k, v, rows)
    assert cache.row_plan is not plan and cache.row_plan.holds(cache)
    assert torch.equal(old_k, kept)
    plain = {key: torch.zeros_like(buf) for key, buf in cache.items()}
    paged_prefill.write_kv_rows(-k, v, plain, rows.tables, positions)
    want = {key: torch.zeros_like(buf) for key, buf in cache.items()}
    paged_prefill.write_kv_rows_reference(-k, v, want, rows.tables,
                                          positions)
    assert torch.equal(cache["k"], want["k"])
    assert torch.equal(plain["k"], want["k"])


def test_write_kv_rows_raises_on_what_the_kernel_does_not_take(cuda):
    """int64 positions, a head_dim of three 16-byte chunks, and rows whose
    features are not contiguous raise before anything is written."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    k, v, pool, tables, positions = _decode_write_case(
        cuda, gen, 8, 16, 8, 128, "bf16", "bf16")
    before = {key: buf.clone() for key, buf in pool.items()}
    with pytest.raises(TypeError, match="int32"):
        paged_prefill.write_kv_rows(k, v, pool, tables, positions.long())
    with pytest.raises(ValueError, match="contiguous"):
        paged_prefill.write_kv_rows(k.transpose(2, 3).contiguous()
                                    .transpose(2, 3), v, pool, tables,
                                    positions)
    odd = _writer_pool(cuda, gen, 9, 16, 8, 24, "bf16")
    with pytest.raises(ValueError, match="16-byte chunks"):
        paged_prefill.write_kv_rows(k[..., :24].contiguous(),
                                    v[..., :24].contiguous(), odd, tables,
                                    positions)
    for key in pool:
        assert torch.equal(pool[key], before[key]), key


#: Positions of the write past the end: max_seq - 1, max_seq, max_seq + 3.
PAST_END = (-1, 0, 3)


@pytest.mark.parametrize("past", PAST_END)
@pytest.mark.parametrize("quantize_kv", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_write_kv_rows_past_the_end(cuda, layout, quantize_kv, past):
    """The decode write at ``max_seq + past`` for slot 0 (the others
    inside) byte-equal to the plain version's: on a contiguous cache (8 x
    1,024, the caller's clamp) the row lands on the last row, never row 0;
    on a pool (64-entry tables of 16-row blocks) a row past the table is
    dropped, never written into the slot's last block."""
    gen = torch.Generator(device=cuda).manual_seed(40 + past)
    slots, max_seq, bs = 8, 1024, 16
    fused = torch.randn((slots, 1, 40, 128), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    k, v = fused[:, :, 32:], fused[:, :, :8].contiguous()
    positions = torch.randint(0, max_seq - 1, (slots,), generator=gen,
                              device=cuda, dtype=torch.int32)
    positions[0] = max_seq + past
    if layout == "contiguous":
        config = dataclasses.replace(llama.CONFIGS["llama3_8b"], n_layers=1)
        pool = llama.init_cache(config, slots, max_seq,
                                quantize_kv=quantize_kv, device=cuda)[0]
        rows = llama._cache_rows(positions)
        last = (0, max_seq - 1)
    else:
        entries = max_seq // bs
        n_blocks = slots * entries + 1
        pool = _writer_pool(cuda, gen, n_blocks, bs, 8, 128,
                            "int8" if quantize_kv else "bf16")
        rows = paged_prefill.DecodeRows(
            _writer_tables(cuda, gen, n_blocks, slots, entries), positions)
        last = (int(rows.tables[0, -1]), bs - 1)
    plain = {key: buf.clone() for key, buf in pool.items()}
    before = paged_prefill.write_kv_rows.launches
    paged_prefill.write_decode_rows(k, v, pool, rows)
    assert paged_prefill.write_kv_rows.launches == before + 1
    paged_prefill.write_kv_rows_reference(k, v, plain, rows.tables,
                                          positions, clamp=rows.clamp)
    _assert_pools_equal(pool, plain, skip_scratch=False)
    if layout == "contiguous":
        assert bool(pool["k"][last].any()) and not bool(pool["k"][0, 0].any())


def _graph_server(cuda, layout, quantize_kv, bits, width, params=None):
    """A server of ``width`` ("narrow": tiny; "8b": llama3_8b's widths
    with two layers, registered as ``llama3_8b_2l``) on int8 or int4
    weights: 3 slots, 2-step chunks, a fixed ring depth (so that the
    dispatches, and with them the chunks' keys, do not follow the host's
    timing)."""
    name = "tiny" if width == "narrow" else "llama3_8b_2l"
    config = llama.CONFIGS[name]
    if params is None:
        params = llama.random_quantized_params(config, seed=2, bits=bits,
                                               device=cuda)
    kwargs = dict(config_name=name, slots=3, max_seq=128, chunk_steps=2,
                  params=params, quantize=True, quantize_kv=quantize_kv,
                  ring_max=2, device=cuda)
    if layout == "contiguous":
        return ContinuousBatchingServer(**kwargs)
    kwargs.update(block_size=16, chunk_prefill_tokens=16)
    if layout == "paged_spec":
        kwargs.update(draft_mode="ngram", spec_k=2, spec_adaptive=True)
    else:
        kwargs.update(enable_prefix_cache=True)
    return PagedContinuousServer(**kwargs)


def _graph_traffic(server, seed):
    """Staggered admissions: three waves of two requests, two steps apart
    (dirty-row merges, retirements, paged mixed steps)."""
    rng = np.random.default_rng(seed)
    vocab = server.config.vocab_size
    requests = [DecodeRequest(f"r{i}", rng.integers(1, vocab, plen)
                              .astype(np.int32), new)
                for i, (plen, new) in enumerate(
                    [(5, 9), (40, 4), (3, 12), (33, 7), (12, 3), (21, 8)])]
    for start in range(0, len(requests), 2):
        for request in requests[start:start + 2]:
            server.submit(request)
        for _ in range(2):
            server.step()
    server.run_until_drained()
    torch.cuda.synchronize()
    return requests


@pytest.fixture
def llama3_8b_2l(monkeypatch):
    monkeypatch.setitem(llama.CONFIGS, "llama3_8b_2l", dataclasses.replace(
        llama.CONFIGS["llama3_8b"], n_layers=2))


@pytest.mark.parametrize("width", ["narrow", "8b"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("quantize_kv", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "paged", "paged_spec"])
def test_graphed_chunks_equal_eager_chunks(cuda, llama3_8b_2l, layout,
                                           quantize_kv, bits, width):
    """Greedy steady chunks replayed from captured CUDA graphs against the
    same server with graphs off: tokens, emitted counts (decode steps),
    resident state, every cache or pool byte and every kernel's launches
    bitwise equal, across dirty-row merges, retirements, mixed steps and
    speculation rounds followed by graphed chunks."""
    eager = _graph_server(cuda, layout, quantize_kv, bits, width)
    eager._graphs_on = False
    graphed = _graph_server(cuda, layout, quantize_kv, bits, width,
                            params=eager.params)
    assert graphed._graphs_on
    runs = []
    for server in (eager, graphed):
        before = {fn.__name__: fn.launches for fn in _cuda.COUNTED}
        requests = _graph_traffic(server, 9)
        launches = {fn.__name__: fn.launches - before[fn.__name__]
                    for fn in _cuda.COUNTED}
        runs.append((requests, server.stats(), launches))
    (want, want_stats, want_launches), (got, stats, launches) = runs
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert all(len(r.tokens) == r.max_new_tokens for r in got)
    assert stats["decode_steps"] == want_stats["decode_steps"]
    assert launches == want_launches
    assert stats["graph_captures"] > 0 and stats["graph_replays"] > 0
    assert want_stats["graph_captures"] == 0
    for key, value in eager._state.items():
        assert torch.equal(graphed._state[key], value), key
    layers = (eager.cache, graphed.cache) if layout == "contiguous" \
        else (eager.pool, graphed.pool)
    for want_layer, got_layer in zip(*layers):
        for key in want_layer:
            assert torch.equal(got_layer[key], want_layer[key]), key
    if layout == "paged_spec":
        assert stats["spec_rounds"] > 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_no_capture_after_warm_up(cuda, layout):
    """Two staggered runs (a key met once is warmed up by its eager chunk
    and captured at its second), the fence, then the same traffic again:
    every chunk of the last run replays a graph captured before it."""
    server = _graph_server(cuda, layout, False, 8, "narrow")
    for _ in range(2):
        _graph_traffic(server, 5)
    warm = server.stats()
    assert warm["graph_captures"] > 0
    server.graph_ledger.fence()
    requests = _graph_traffic(server, 5)
    stats = server.stats()
    assert all(len(r.tokens) == r.max_new_tokens for r in requests)
    assert stats["graph_captures_steady_state"] == 0
    assert stats["graph_captures"] == warm["graph_captures"]
    assert stats["graph_replays"] > warm["graph_replays"]


def test_wire_replica_equals_direct_steps(cuda, llama3_8b_2l):
    """The (infer ...) wire on the card: a ContinuousReplica on a loopback
    broker, its engine in its own thread, in front of a 2-layer
    llama3_8b-width paged int8 server, against the same server driven by
    step() directly on the same submissions: every token bitwise equal,
    graphed chunks replayed, and no command failure (a capture error
    would be logged and swallowed by the actor runtime)."""
    import logging
    import threading

    from aiko_services_tpu_torch.orchestration.client import InferClient
    from aiko_services_tpu_torch.orchestration.continuous import (
        ContinuousReplica)
    from aiko_services_tpu_torch.runtime import (EventEngine, Process,
                                                 actor_args,
                                                 compose_instance)
    from aiko_services_tpu_torch.transport import reset_brokers

    direct = _graph_server(cuda, "paged", False, 8, "8b")
    served = _graph_server(cuda, "paged", False, 8, "8b",
                           params=direct.params)
    rng = np.random.default_rng(13)
    specs = [(5, 9), (40, 4), (3, 12), (33, 7), (12, 3), (21, 8)]
    prompts = [rng.integers(1, direct.config.vocab_size, plen)
               .astype(np.int32) for plen, _ in specs]
    requests = [DecodeRequest(f"r{i}", prompt, new) for i, (prompt, (_, new))
                in enumerate(zip(prompts, specs))]
    for request in requests:
        direct.submit(request)
    direct.run_until_drained()

    errors = []

    class Errors(logging.Handler):
        def emit(self, record):
            errors.append(record.getMessage())
    handler = Errors(logging.ERROR)
    logging.getLogger().addHandler(handler)
    reset_brokers()
    engine = EventEngine()
    process = Process(namespace="card", hostname="h", pid="1",
                      engine=engine, broker="card_wire")
    replica = compose_instance(ContinuousReplica, actor_args("cw"),
                               process=process, server=served)
    client = InferClient(process, replica.topic_in)
    # Every submission is queued before the engine starts, so the replica
    # admits them as the direct run did.
    futures = [client.submit(prompt, max_new_tokens=new, stream=i % 2 == 0)
               for i, (prompt, (_, new)) in enumerate(zip(prompts, specs))]
    thread = engine.run_in_thread()
    try:
        for future in futures:
            client.wait(future, timeout=300)
        for _ in range(1000):
            if not replica._pumping:
                break
            threading.Event().wait(0.01)
    finally:
        engine.terminate()
        thread.join(60)
        logging.getLogger().removeHandler(handler)
        reset_brokers()
    assert errors == []
    assert [f.error for f in futures] == [None] * len(futures)
    assert [f.tokens for f in futures] == [r.tokens for r in requests]
    for index, future in enumerate(futures):
        if index % 2 == 0:
            assert future.partial_tokens == future.tokens
    stats = served.stats()
    assert stats["graph_replays"] > 0
    assert stats["decode_steps"] == direct.stats()["decode_steps"]
    assert not replica._pumping


def test_watchdog_alarm_fires_during_the_event_wait(cuda):
    """A ring sync stuck behind a long device sleep: the watchdog's alarm
    thread trips while the serving thread still waits on the chunk's CUDA
    event (the event wait releases the GIL), long before the wait ends;
    the outstanding request then fails with watchdog_stalled."""
    import threading
    import time

    server = ContinuousBatchingServer(config_name="tiny", slots=1,
                                      max_seq=128, chunk_steps=2,
                                      quantize=True, seed=1, watchdog_s=0.05,
                                      device=cuda)
    request = DecodeRequest("w", np.arange(1, 9, dtype=np.int32), 60)
    server.submit(request)
    for _ in range(3):
        server.step()
    assert request.tokens and request.error is None
    trips = []
    trip = server._trip_watchdog

    def recorded():
        trips.append((threading.current_thread().name, time.monotonic()))
        trip()
    server._trip_watchdog = recorded
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)        # ~0.5 s of device time
    began = time.monotonic()
    done = []
    while not trips and not done and time.monotonic() - began < 30:
        done = server.step()
        returned = time.monotonic()
    assert trips, "the watchdog never tripped"
    name, tripped_at = trips[0]
    assert name != threading.current_thread().name
    assert returned - tripped_at > 0.2
    while not done:
        done = server.step()
    assert request.error == "watchdog_stalled" and not server.healthy


def test_capture_never_grows_the_scratch(cuda):
    """Kernel scratch that would grow inside a capture raises, rather
    than free a buffer a graph holds."""
    _cuda.scratch(cuda, 1 << 20, 4096)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="captured"):
        with torch.cuda.graph(graph):
            _cuda.scratch(cuda, 1 << 30, 4096)


@pytest.mark.parametrize("quantize_kv", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_write_launches_once_a_layer_a_step(cuda, layout,
                                                   quantize_kv):
    """tiny with int8 weights on the card: the decode steps write K/V only
    through the row writer, one launch a layer a decode step (and one
    decode attention launch beside each)."""
    kwargs = dict(config_name="tiny", slots=3, max_seq=128, chunk_steps=4,
                  quantize=True, quantize_kv=quantize_kv, seed=1)
    if layout == "paged":
        server = PagedContinuousServer(block_size=16, chunk_prefill_tokens=16,
                                       enable_prefix_cache=True, **kwargs)
    else:
        server = ContinuousBatchingServer(**kwargs)
    rng = np.random.default_rng(5)
    requests = [DecodeRequest(f"r{i}", rng.integers(1, 1024, plen)
                              .astype(np.int32), new)
                for i, (plen, new) in enumerate(
                    [(5, 6), (30, 9), (17, 4), (40, 7)])]
    before = (paged_prefill.write_kv_rows.launches,
              paged_attention.paged_decode_attention.launches)
    for request in requests:
        server.submit(request)
    server.run_until_drained()
    launches = paged_prefill.write_kv_rows.launches - before[0]
    steps = server.stats()["decode_steps"]
    assert steps > 0
    assert launches == server.config.n_layers * steps
    assert paged_attention.paged_decode_attention.launches - before[1] \
        == launches
    for request in requests:
        assert len(request.tokens) == request.max_new_tokens


@pytest.mark.parametrize("quant_kv", [False, True])
@pytest.mark.parametrize("window", [None, 256])
def test_chunk_attention_verify_shape(cuda, quant_kv, window):
    """The verify's attention: T = 5 windows of 32 query heads over 8 kv
    heads at unaligned positions ~1,030-1,200, one row idle (chunk_len
    0, its output finite: zero), after the ragged append."""
    starts = (1030, 1047, 1064, 1100, 1121, 1150, 1183, 1199, 0)
    chunk_lens = (5, 5, 5, 5, 5, 5, 5, 5, 0)
    k_new, v_new, pool, tables, cached, chunk = _ragged_case(
        cuda, 13, 5, 8, 128, quant_kv, starts=starts, chunk_lens=chunk_lens)
    q = torch.randn((len(starts), 5, 8, 4, 128), device=cuda) \
        .to(torch.bfloat16)
    before = paged_prefill.chunk_attention.launches
    got, _ = paged_prefill.paged_verify_attention(q, k_new, v_new, pool,
                                                  tables, cached, chunk,
                                                  window=window)
    assert paged_prefill.chunk_attention.launches == before + 1
    plain = pool if quant_kv else {key: buf.float()
                                   for key, buf in pool.items()}
    want = paged_prefill.chunk_attention_reference(q.float(), plain, tables,
                                                   cached, window=window)
    _close(got[:-1], want[:-1], torch.bfloat16)
    assert bool(torch.isfinite(got[-1]).all())


def _chunk_pool(cuda, seed, rows, entries, quant_kv, kv=8, hd=128, bs=16):
    """llama3_8b widths: a pool of random K/V (bf16, or int8 from the
    plain quantizer) and ``rows`` shuffled tables of ``entries`` blocks."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n_blocks = rows * entries + 1
    k = torch.randn((n_blocks, bs, kv, hd), generator=gen, device=cuda)
    v = torch.randn((n_blocks, bs, kv, hd), generator=gen, device=cuda)
    if quant_kv:
        (k, ks), (v, vs) = llama._kv_quantize(k), llama._kv_quantize(v)
        pool = dict(k=k, v=v, ks=ks, vs=vs)
    else:
        pool = dict(k=k.to(torch.bfloat16), v=v.to(torch.bfloat16))
    ids = torch.randperm(n_blocks - 1, generator=gen, device=cuda) + 1
    tables = ids.reshape(rows, entries).to(torch.int32)
    return pool, tables, gen


def _meta(cuda, values):
    return torch.tensor(values, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("quant_kv", [False, True])
def test_chunk_attention_is_batch_and_call_invariant(cuda, quant_kv):
    """llama3_8b widths: a row's output is bitwise the same alone and
    among 8 rows of other lengths, and across two calls (the splits
    depend on the block size alone and merge in split order)."""
    pool, tables, gen = _chunk_pool(cuda, 21, 8, 80, quant_kv)
    T = 64
    cached = _meta(cuda, [1024, 0, 256, 512, 1100 // 16 * 16, 64, 960, 16])
    chunk = _meta(cuda, [64, 40, 64, 17, 64, 64, 1, 64])
    q = torch.randn((8, T, 8, 4, 128), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    among = paged_prefill.chunk_attention(q, pool, tables, cached, chunk)
    again = paged_prefill.chunk_attention(q, pool, tables, cached, chunk)
    assert torch.equal(among, again)
    for row in (0, 3, 4):
        alone = paged_prefill.chunk_attention(
            q[row:row + 1].contiguous(), pool,
            tables[row:row + 1].contiguous(), cached[row:row + 1].clone(),
            chunk[row:row + 1].clone())
        n = int(chunk[row])
        assert torch.equal(alone[0, :n], among[row, :n]), row


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("quant_kv", [False, True])
def test_chunk_attention_is_chunk_size_invariant(cuda, quant_kv, window):
    """A query at position p over the same pool gives the same bits in a
    256-token chunk after 1,024 cached tokens and in a 16-token chunk
    that starts at p's slice (1,024 + 64, 1,024 + 240)."""
    pool, tables, gen = _chunk_pool(cuda, 22, 1, 80, quant_kv)
    q = torch.randn((1, 256, 8, 4, 128), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    whole = paged_prefill.chunk_attention(
        q, pool, tables, _meta(cuda, [1024]), _meta(cuda, [256]),
        window=window)
    for offset in (64, 240):
        part = paged_prefill.chunk_attention(
            q[:, offset:offset + 16].contiguous(), pool, tables,
            _meta(cuda, [1024 + offset]), _meta(cuda, [16]), window=window)
        assert torch.equal(part[0], whole[0, offset:offset + 16]), offset


#: (cached, T, chunk_len, window) of the split checks at block size 16:
#: a chunk starting on a split edge, one ending on one, one crossing two
#: edges, and windows that leave early splits wholly outside them.
CHUNK_SPLIT_CASES = [(256, 16, 16, None), (240, 16, 16, None),
                     (496, 64, 64, None), (1024, 256, 256, None),
                     (1024, 256, 256, 40), (768, 64, 50, 300),
                     (0, 64, 64, None), (1792, 16, 9, 256)]


@pytest.mark.parametrize("quant_kv", [False, True])
@pytest.mark.parametrize("cached,T,chunk_len,window", CHUNK_SPLIT_CASES)
def test_chunk_attention_equals_the_split_reference(cuda, cached, T,
                                                    chunk_len, window,
                                                    quant_kv):
    """The kernel against the plain split-and-merge version (f32) and the
    one-shot plain version, on the real rows, at llama3_8b widths."""
    pool, tables, gen = _chunk_pool(cuda, cached + T, 1, 128, quant_kv)
    q = torch.randn((1, T, 8, 4, 128), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    meta = (_meta(cuda, [cached]), _meta(cuda, [chunk_len]))
    got = paged_prefill.chunk_attention(q, pool, tables, *meta,
                                        window=window)
    plain = pool if quant_kv else {key: buf.float()
                                   for key, buf in pool.items()}
    want = paged_prefill.chunk_attention_split_reference(
        q.float(), plain, tables, *meta, window=window)
    _close(got[0, :chunk_len], want[0, :chunk_len], torch.bfloat16)
    one_shot = paged_prefill.chunk_attention_reference(
        q.float(), plain, tables, meta[0], window=window)
    _close(got[0, :chunk_len], one_shot[0, :chunk_len], torch.bfloat16)


@pytest.mark.parametrize("window", [4096, None])
@pytest.mark.parametrize("quant_kv", [False, True])
def test_chunk_attention_long_table(cuda, quant_kv, window):
    """A 256-token chunk at the end of a 32,768-key table (mistral_7b's
    and mixtral_8x7b's max_seq_len) at llama3_8b widths, against the plain
    split version: with a 4,096-key window the tile keeps one partial slot
    for each split the window can reach; with none the partials would
    pass the scratch budget, so one CTA a tile walks its 128 splits."""
    pool, tables, gen = _chunk_pool(cuda, 23, 1, 2048, quant_kv)
    T = 256
    q = torch.randn((1, T, 8, 4, 128), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    meta = (_meta(cuda, [32_768 - T]), _meta(cuda, [T]))
    tiles = 8 * T * 4 // paged_prefill.CHUNK_TILE_ROWS
    slots = paged_prefill.chunk_live_splits(T, 4, 16, 2048, window)
    over_budget = 4 * tiles * slots * 64 * 130 \
        > paged_prefill.CHUNK_SCRATCH_BYTES
    assert over_budget == (window is None)
    got = paged_prefill.chunk_attention(q, pool, tables, *meta,
                                        window=window)
    plain = pool if quant_kv else {key: buf.float()
                                   for key, buf in pool.items()}
    want = paged_prefill.chunk_attention_split_reference(
        q.float(), plain, tables, *meta, window=window)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("quant_kv", [False, True])
def test_chunk_attention_one_cta_a_tile_gives_the_same_bits(
        cuda, quant_kv, window, monkeypatch):
    """With no scratch budget every launch takes one CTA a query tile,
    which walks the tile's splits itself: the same bits as the launch of
    one CTA a split, for a 256-token chunk after 1,024 cached tokens and
    8 rows of other lengths."""
    pool, tables, gen = _chunk_pool(cuda, 24, 8, 80, quant_kv)
    cached = _meta(cuda, [1024, 0, 256, 512, 1100 // 16 * 16, 64, 960, 16])
    chunk = _meta(cuda, [256, 40, 256, 17, 200, 256, 1, 256])
    q = torch.randn((8, 256, 8, 4, 128), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    split = paged_prefill.chunk_attention(q, pool, tables, cached, chunk,
                                          window=window)
    monkeypatch.setattr(paged_prefill, "CHUNK_SCRATCH_BYTES", 0)
    walked = paged_prefill.chunk_attention(q, pool, tables, cached, chunk,
                                           window=window)
    for row, n in enumerate(chunk.tolist()):
        assert torch.equal(walked[row, :n], split[row, :n]), row


@pytest.mark.parametrize("hd,T", [(256, 5), (128, 129)])
def test_paged_verify_outside_the_envelope_raises_on_the_card(cuda, hd, T):
    k_new, v_new, pool, tables, cached, chunk = _ragged_case(
        cuda, 2, T, 1, hd, False, starts=(3, 20), chunk_lens=(T, 2))
    q = torch.randn((2, T, 1, 2, hd), device=cuda).to(torch.bfloat16)
    before = {key: buf.clone() for key, buf in pool.items()}
    with pytest.raises(ValueError, match="envelope"):
        paged_prefill.paged_verify_attention(q, k_new, v_new, pool, tables,
                                             cached, chunk)
    for key in pool:
        assert torch.equal(pool[key], before[key]), key


def _worst_oracle_gap(server, request):
    """The served tokens against a batch-1 contiguous prefill + decode_step
    oracle on the card, teacher-forced: the largest gap between the
    oracle's top logit and its logit of a served token."""
    config, device = server.config, server.device
    prompt = torch.as_tensor(request.prompt, device=device)[None]
    cache = llama.init_cache(config, 1, server.max_seq,
                             quantize_kv=server.quantize_kv, device=device)
    logits, cache = llama.prefill(server.params, prompt, cache, config)
    logits, worst = logits[0, -1], 0.0
    for index, token in enumerate(request.tokens):
        worst = max(worst, float(logits.max() - logits[token]))
        step = torch.tensor([[token]], dtype=torch.int32, device=device)
        logits, cache = llama.decode_step(server.params, step, cache,
                                          prompt.shape[1] + index, config)
        logits = logits[0, -1]
    return worst


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_spec_server_on_the_card_holds_the_oracle(cuda, quantize_kv):
    """tiny with int8 weights, a paired draft, 16-token chunked admission
    and the prefix cache on the card: every served token is the batch-1
    oracle's argmax or within 0.1 of its top logit (the verify's attention
    kernel rounds otherwise than the decode kernel, so a near-tie may go
    either way), each round launches the ragged append once per target
    layer and once per draft layer (the resync), and a paired draft
    commits more than one token a round."""
    rng = np.random.default_rng(4)
    system = rng.integers(1, 1024, 40).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(1, 1024, tail)
                               .astype(np.int32)]) for tail in (5, 12)]
    prompts += [rng.integers(1, 1024, n).astype(np.int32) for n in (9, 70)]
    kwargs = dict(config_name="tiny", slots=3, max_seq=256, chunk_steps=4,
                  quantize=True, quantize_kv=quantize_kv, seed=1,
                  block_size=16, chunk_prefill_tokens=16,
                  enable_prefix_cache=True)
    server = PagedContinuousServer(spec_k=4, draft_config_name="tiny",
                                   **kwargs)
    server._draft["params"] = server.params
    requests = [DecodeRequest(f"r{i}", p, 10) for i, p in enumerate(prompts)]
    before = paged_prefill.append_kv_ragged.launches
    for request in requests:
        server.submit(request)
    server.run_until_drained()
    launches = paged_prefill.append_kv_ragged.launches - before
    stats = server.stats()
    assert launches == 2 * server.config.n_layers * stats["spec_rounds"]
    assert stats["spec_tokens_per_target_pass"] > 1.0
    for request in requests:
        assert len(request.tokens) == 10, request.request_id
        assert _worst_oracle_gap(server, request) <= 0.1, request.request_id
    balance = server.pool_balance()
    assert balance["free"] + balance["evictable"] + balance["producing"] \
        == balance["total"]


# --------------------------------------------------------------------------- #
# Ring collective matmuls (csrc/ring_matmul.cu), R ranks on one card

#: (kind, ranks, m, k, n, dtype): the JAX tests' shapes (ragged: n_local 3,
#: 5, 2), llama3_8b's TP-4 MLP shapes at m = 2048 and 64 (w_gate all-gather,
#: w_down reduce-scatter), and odd sizes that leave every tile edge ragged.
RING_CASES = [
    ("ag", 8, 16, 32, 24, torch.float32),
    ("rs", 8, 8, 64, 40, torch.float32),
    ("ag", 8, 16, 32, 16, torch.bfloat16),
    ("rs", 8, 8, 64, 40, torch.bfloat16),
    ("ag", 4, 2048, 4096, 14336, torch.bfloat16),
    ("ag", 4, 64, 4096, 14336, torch.bfloat16),
    ("rs", 4, 2048, 14336, 4096, torch.bfloat16),
    ("rs", 4, 64, 14336, 4096, torch.bfloat16),
    ("ag", 3, 195, 200, 390, torch.bfloat16),
    ("rs", 3, 130, 264, 390, torch.bfloat16),
    ("ag", 2, 130, 96, 66, torch.float32),
    ("rs", 1, 40, 48, 24, torch.bfloat16),
]

RINGS = {"ag": (rdma_collective.rdma_allgather_matmul_sharded,
                collective_matmul.allgather_matmul_sharded,
                rdma_collective.rdma_allgather_matmul),
         "rs": (rdma_collective.rdma_matmul_reducescatter_sharded,
                collective_matmul.matmul_reducescatter_sharded,
                rdma_collective.rdma_matmul_reducescatter)}


def _ring_operands(cuda, kind, m, k, n, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=cuda).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=cuda) * k ** -0.5) \
        .to(dtype)
    return x, w


@pytest.mark.parametrize("kind,ranks,m,k,n,dtype", RING_CASES)
def test_ring_kernels_against_their_plain_version(cuda, kind, ranks, m, k, n,
                                                  dtype):
    """The ring on ``["cuda:0"] * R`` against the plain version (the same
    schedule with torch.mm in f32) on f32 copies of the operands; R^2 step
    launches and R(R - 1) copies a call; a second call gives the same
    result bit for bit."""
    ring_fn, plain_fn, counted = RINGS[kind]
    mesh = make_mesh([cuda] * ranks, tp=ranks)
    x, w = _ring_operands(cuda, kind, m, k, n, dtype, m + k + n + ranks)
    before = (counted.launches, counted.copies)
    got = ring_fn(x, w, mesh)
    assert (counted.launches - before[0], counted.copies - before[1]) \
        == (ranks ** 2, ranks * (ranks - 1))
    assert got.dtype == dtype and got.shape == (m, n)
    _close(got, plain_fn(x.float(), w.float(), mesh), dtype)
    assert torch.equal(ring_fn(x, w, mesh), got)


@pytest.mark.parametrize("kind", ["ag", "rs"])
def test_ring_holds_against_a_slowed_rank(cuda, kind, monkeypatch):
    """Rank 1 sleeps ~50 ms on its compute stream before its step-1
    kernel.  The ring waits for it (the capacity events): right.  A ring
    whose copies skip the capacity wait lets rank 0 overwrite the slot
    rank 1 has yet to read: wrong."""
    ranks, m, k, n = 4, 256, 512, 512
    ring_fn, plain_fn, _ = RINGS[kind]
    mesh = make_mesh([cuda] * ranks, tp=ranks)
    x, w = _ring_operands(cuda, kind, m, k, n, torch.bfloat16, 21)
    want = plain_fn(x.float(), w.float(), mesh)

    def slow(rank, step):
        if (rank, step) == (1, 1):
            torch.cuda._sleep(100_000_000)

    _close(ring_fn(x, w, mesh, before_step=slow), want, torch.bfloat16)
    ring = rdma_collective.ring
    for name in ("allgather_schedule", "reducescatter_schedule"):
        schedule = getattr(ring, name)
        monkeypatch.setattr(ring, name, lambda ranks, schedule=schedule: [
            dataclasses.replace(op, capacity=()) for op in schedule(ranks)])
    raced = ring_fn(x, w, mesh, before_step=slow)
    assert not torch.allclose(raced.float(), want, rtol=2e-2, atol=2e-2)


def test_ring_raises_on_what_the_kernels_do_not_take(cuda):
    mesh = make_mesh([cuda] * 2, tp=2)
    x = torch.zeros((8, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        rdma_collective.rdma_allgather_matmul_sharded(x, x.t(), mesh)
    x = torch.zeros((8, 16), device=cuda)
    with pytest.raises(ValueError):                 # 15 columns over 2 ranks
        rdma_collective.rdma_matmul_reducescatter_sharded(
            x, torch.zeros((16, 15), device=cuda), mesh)
    with pytest.raises(ValueError):                 # mixed CPU and CUDA
        rdma_collective.rdma_allgather_matmul([x, x.cpu()], [x.t(), x.t()])


@pytest.mark.parametrize("kind", ["ag", "rs"])
def test_ring_across_distinct_cards(cuda, kind):
    """One rank a card, the copies peer to peer; needs two cards."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more CUDA cards")
    ring_fn, plain_fn, _ = RINGS[kind]
    devices = [torch.device("cuda", i) for i in range(cards)]
    mesh = make_mesh(devices, tp=cards)
    x, w = _ring_operands(cuda, kind, 64 * cards, 256, 128 * cards,
                          torch.bfloat16, 5)
    _close(ring_fn(x, w, mesh), plain_fn(x.float(), w.float(), mesh),
           torch.bfloat16)


# --------------------------------------------------------------------------- #
# The KV tiers and the KV wire on the card


def _kv_tier_server(device, quantize_kv, params=None, **kwargs):
    """A tiny prefix-cached paged server on int8 weights (3 slots, 2-step
    chunks, a fixed ring depth), a host tier of 32 blocks."""
    config = llama.CONFIGS["tiny"]
    if params is None:
        params = llama.random_quantized_params(config, seed=4, device=device)
    return PagedContinuousServer(
        config_name="tiny", slots=3, max_seq=128, chunk_steps=2,
        params=params, quantize=True, quantize_kv=quantize_kv,
        block_size=16, chunk_prefill_tokens=16, enable_prefix_cache=True,
        ring_max=2, host_tier_blocks=32, device=device,
        **kwargs)


def _random_pool_bytes(server, seed):
    """Random bytes of every pool field (valid bf16 values, int8 codes,
    positive f32 scales), made on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for layer in server.pool:
        fields = {}
        for name, buf in layer.items():
            if buf.dtype == torch.int8:
                value = torch.randint(-127, 128, buf.shape, generator=gen,
                                      dtype=torch.int8)
            elif name in ("ks", "vs"):
                value = torch.rand(buf.shape, generator=gen) + 1e-3
            else:
                value = torch.randn(buf.shape, generator=gen).to(buf.dtype)
            fields[name] = value
        out.append(fields)
    return out


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_kv_export_on_the_card_equals_the_cpu_export(cuda, quantize_kv):
    """The same pool bytes and chain on the card and on the CPU: the fused
    export (one gather a field on the card, one copy into pinned memory,
    one sync) gives the CPU export's payload byte for byte, and the card's
    import lands the rows the CPU import lands."""
    from aiko_services_tpu_torch.kvstore import directory, transfer

    card = _kv_tier_server(cuda, quantize_kv)
    host = _kv_tier_server("cpu", quantize_kv, params=_cpu_tree(card.params))
    pool = _random_pool_bytes(card, 11)
    for server in (card, host):
        for layer, fields in zip(server.pool, pool):
            for name, value in fields.items():
                layer[name].copy_(value)
    tokens = np.arange(1, 98, dtype=np.int32)        # 6 shareable blocks
    assert transfer.seed_chain(card, tokens) == \
        transfer.seed_chain(host, tokens) == 6
    keys = directory.chain_keys_hex(tokens, 16)
    syncs = card.kv_export_sync_count
    got = transfer.export_payload(card, keys, 0)
    want = transfer.export_payload(host, keys, 0)
    assert card.kv_export_sync_count == syncs + 1
    assert list(got) == list(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype
            assert got[key].tobytes() == value.tobytes(), key
        else:
            assert got[key] == value
    fresh = [_kv_tier_server(device, quantize_kv, params=server.params)
             for device, server in ((cuda, card), ("cpu", host))]
    for server in fresh:
        assert server.kv_import_payload(dict(want)) == 6
    blocks = [fresh[0]._index[bytes.fromhex(k)] for k in want["kv_keys"]]
    rows = [transfer.gather_block_rows(server, blocks) for server in fresh]
    for field, value in rows[1].items():
        assert rows[0][field].tobytes() == value.tobytes(), field


def _cpu_tree(tree):
    if isinstance(tree, dict):
        return {key: _cpu_tree(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_tree(value) for value in tree)
    return tree.cpu()


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_demote_restore_round_trip_leaves_every_pool_byte(cuda, quantize_kv):
    """Every cached block demoted to the host tier and restored through
    the landing queue: each chain key's rows come back byte for byte, and
    no other pool block changes."""
    from aiko_services_tpu_torch.kvstore import transfer

    server = _kv_tier_server(cuda, quantize_kv, restore_blocks_per_step=3)
    for layer, fields in zip(server.pool, _random_pool_bytes(server, 12)):
        for name, value in fields.items():
            layer[name].copy_(value)
    tokens = np.arange(1, 114, dtype=np.int32)       # 7 shareable blocks
    assert transfer.seed_chain(server, tokens) == 7
    keys = list(server._index)
    before = {key: transfer.gather_block_rows(server, [server._index[key]])
              for key in keys}
    snapshot = [{name: buf.clone() for name, buf in layer.items()}
                for layer in server.pool]
    while server._evict_one():
        pass
    assert server.kv_demotions == 7 and not server._index
    shared = []
    assert server._begin_restore(keys, shared)
    while server._restoring:
        server._advance_restores()
    torch.cuda.synchronize()
    assert server.kv_restores == 7
    touched = set()
    for key in keys:
        block = server._index[key]
        touched.add(block)
        after = transfer.gather_block_rows(server, [block])
        for field, value in before[key].items():
            assert after[field].tobytes() == value.tobytes(), field
    untouched = torch.tensor(sorted(set(range(server.total_blocks + 1))
                                    - touched), device=cuda)
    for layer, saved in zip(server.pool, snapshot):
        for name, buf in layer.items():
            assert torch.equal(buf[untouched], saved[name][untouched]), name


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_upload_frees_its_pinned_buffer_before_the_copy_lands(
        cuda, quantize_kv):
    """The fused upload frees its pinned staging as soon as the copy is
    queued.  Behind a long wait on the stream, pinned buffers of the same
    size are allocated and overwritten before the copy runs: the caching
    host allocator must hand out other blocks until the copy's event has
    passed, so the pool gets the rows and not the overwrite."""
    from aiko_services_tpu_torch.kvstore import transfer

    server = _kv_tier_server(cuda, quantize_kv)
    for layer, fields in zip(server.pool, _random_pool_bytes(server, 13)):
        for name, value in fields.items():
            layer[name].copy_(value)
    blocks = [1, 2, 3, 4, 5, 6]
    want = {field: rows.copy() for field, rows
            in transfer.gather_block_rows(server, blocks).items()}
    ids = torch.tensor(blocks, device=cuda)
    for layer in server.pool:
        for buf in layer.values():
            buf[ids] = 0
    total = sum(rows.nbytes for rows in want.values())
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)        # ~1 s of device time
    transfer.scatter_block_rows(server, blocks, want)
    junk = []
    for _ in range(8):
        buffer = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        buffer.fill_(0x7F)
        junk.append(buffer)
    assert not torch.cuda.current_stream().query()   # copy still queued
    torch.cuda.synchronize()
    got = transfer.gather_block_rows(server, blocks)
    for field, value in want.items():
        assert got[field].tobytes() == value.tobytes(), field


@pytest.mark.parametrize("quantize_kv", [False, True])
def test_graphed_decode_on_restored_and_imported_blocks_equals_eager(
        cuda, quantize_kv):
    """A restore and an async import write the pool in place (the chunk
    graphs hold its tensors): after the warm-up fence, a prefix restored
    from the host tier and one imported from a peer decode through graph
    replays to the eager server's tokens, bitwise, with the same pool
    bytes and no capture after the fence; the restored chain decodes as
    it did before it was demoted."""
    from aiko_services_tpu_torch import runtime

    owner = _kv_tier_server(cuda, quantize_kv)
    rng = np.random.default_rng(21)
    vocab = owner.config.vocab_size
    restored_prompt = rng.integers(1, vocab, 70).astype(np.int32)
    imported_prompt = rng.integers(1, vocab, 90).astype(np.int32)
    other_prompt = rng.integers(1, vocab, 20).astype(np.int32)
    owner.submit(DecodeRequest("own", imported_prompt, 3))
    owner.run_until_drained()
    payload = owner.kv_export_payload(
        owner.prefix_keys_hex(imported_prompt), 0)
    eager = _kv_tier_server(cuda, quantize_kv, params=owner.params,
                            restore_blocks_per_step=2, total_blocks=24)
    eager._graphs_on = False
    graphed = _kv_tier_server(cuda, quantize_kv, params=owner.params,
                              restore_blocks_per_step=2, total_blocks=24)
    runs = []
    for server in (eager, graphed):
        engine = runtime.EventEngine(clock=runtime.VirtualClock())
        for _ in range(2):
            _graph_traffic(server, 5)
        server.graph_ledger.fence()
        fenced = server.stats()["graph_replays"]
        first = DecodeRequest("first", restored_prompt, 9)
        server.submit(first)
        server.run_until_drained()
        while server._evict_one():
            pass
        assert server.kv_import_payload(dict(payload), engine=engine,
                                        async_import=True) == 5
        again = DecodeRequest("again", restored_prompt, 9)
        imported = DecodeRequest("imported", imported_prompt, 8)
        other = DecodeRequest("other", other_prompt, 12)
        for request in (other, again, imported):
            server.submit(request)
        server.run_until_drained()
        torch.cuda.synchronize()
        assert again.tokens == first.tokens
        runs.append(([r.tokens for r in (first, again, imported, other)],
                     dict(server.stats(), replays_after_fence=server.stats()[
                         "graph_replays"] - fenced)))
    (want, want_stats), (got, stats) = runs
    assert got == want
    assert stats["kv_restores"] == want_stats["kv_restores"] > 0
    assert stats["kv_imports_async"] == 1 and stats["prefix_remote_hits"] == 1
    assert stats["prefix_hits_host"] == 1
    assert stats["replays_after_fence"] > 0
    assert stats["graph_captures_steady_state"] == 0
    for want_layer, got_layer in zip(eager.pool, graphed.pool):
        for key in want_layer:
            assert torch.equal(got_layer[key], want_layer[key]), key
