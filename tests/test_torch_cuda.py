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

import numpy as np
import pytest
import torch

from aiko_services_tpu_torch.models import llama
from aiko_services_tpu_torch.ops import (attention, paged_attention,
                                         paged_prefill, quant)
from aiko_services_tpu_torch.orchestration.continuous import (
    ContinuousBatchingServer, DecodeRequest)
from aiko_services_tpu_torch.orchestration.paged import (
    PagedContinuousServer)

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


def test_int8_matmul_is_batch_invariant(cuda):
    """Row r's result does not depend on the other rows of x."""
    x = torch.randn((64, 4096), device=cuda, dtype=torch.bfloat16)
    qw = quant.quantize_int8(torch.randn((4096, 1024), device=cuda))
    full = quant.int8_matmul(x, qw["q"], qw["s"])
    for m in (1, 8, 13):
        part = quant.int8_matmul(x[:m], qw["q"], qw["s"])
        assert torch.equal(part, full[:m])


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
#: 14336 x 128: 56 slices; 4096 x 4096: slices of 832 rows, which end
#: inside a group); the llama3_8b widths.
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
    """m > 64 (and a shape outside the rule) take the dequantize + mm
    route: no launch, and within the kernels' bf16 tolerance of the f32
    plain version."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    for m, k, n in ((65, 512, 256), (300, 4096, 1024), (8, 512, 192)):
        x = torch.randn((m, k), generator=gen, device=cuda) \
            .to(torch.bfloat16)
        q4, s = _int4_weight(gen, cuda, k, n, 128)
        assert not quant.int4_kernel_shape(m, k, n, k // 128)
        before = quant.int4_matmul.launches
        got = quant.int4_matmul(x, q4, s)
        assert quant.int4_matmul.launches == before
        _close(got, quant.int4_matmul_reference(x.float(), q4, s),
               torch.bfloat16)


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
