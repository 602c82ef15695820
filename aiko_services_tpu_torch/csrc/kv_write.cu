// The paged KV writer: one vectorised kernel template behind the three
// K/V writes of the serving paths, in place, quantized on int8 pools.
//
// Replaces: aiko_services_tpu/ops/paged_prefill.py::_append_kv (the Pallas
// kernel `_append_kv_kernel`, paged_prefill.py:183, pallas_call at
// paged_prefill.py:264) and ::_append_kv_ragged (`_append_kv_ragged_kernel`,
// paged_prefill.py:514, pallas_call at paged_prefill.py:619); and the
// decode step's K/V write, which the JAX package leaves to one XLA scatter
// (models/llama.py `_paged_write_rows`, `_cache_write_rows`).
//
// Three modes of one template, each its own kernel (and profiler name):
//   * kAligned (`aiko_append_kv`, a prefill chunk): row b's chunk token t
//     lands in block tables[b, cached / bs + t / bs] at offset t % bs.  Whole
//     live blocks are written, padding rows of a live block included;
//     blocks that start at or past chunk_len write nothing (the TPU kernel
//     flushed them into scratch block 0, never attended);
//   * kRagged (`aiko_append_kv_ragged`, a verify window): token t < chunk_len
//     lands at position cached + t, any start, nothing past chunk_len (the
//     TPU kernel merged the rows into whole pool blocks and flushed them);
//   * kRows (`aiko_write_kv_rows`, a decode step): kRagged with T = 1 and
//     every row live, at position positions[b].  A contiguous cache (batch,
//     max_seq, kv, hd) is a pool of `batch` blocks of max_seq rows with
//     tables arange(batch)[:, None], so both decode layouts take it.
// The two append modes clamp table entries to max_blocks - 1, as the JAX
// index maps do.  The row mode does what the JAX package's decode writes do
// past the end: on a contiguous cache (clamp_rows) the position is clamped
// to the last row (`dynamic_update_slice`), and on a pool a row whose table
// entry is past the table is dropped (an out-of-range scatter).  The two
// look alike here (a one-entry table), so the caller says which it is.
//
// Bound on the H100: bytes (2 * rows * kv * hd activations read once, as
// many pool elements written, one f32 scale a vector on int8 pools), and
// at the serving shapes far less than a launch: a decode step writes
// 8-64 rows of 8 kv heads a layer.  What the design does about that:
//   * 16-byte accesses: a thread moves 16 bytes of one (token, kv head)
//     vector with one vector load (8 bf16 or 4 f32 activations) and one
//     16-, 8- or 4-byte store (the bf16/f32 pool row or the int8 codes);
//     L = head_dim * sizeof(in) / 16 lanes carry a vector (16 at head_dim
//     128 in bf16);
//   * one CTA owns one (row, token) with all its kv heads (8 x 16 = 128
//     threads at llama3_8b's shapes; heads spread over grid.y only past
//     1,024 threads), so the row's metadata is one chain a CTA;
//   * the activation loads are issued first (volatile, so they are not
//     sunk below the metadata's branch); the metadata chain (chunk_len and
//     cached, then tables[row, entry]) follows while they are in flight,
//     and only the stores wait on the table entry;
//   * int8 pools: the vector's absmax by __shfl_xor_sync over its L lanes
//     (four steps at L = 16), scale = amax / 127 (1 when amax is 0), then a
//     true IEEE division by the scale (__fdiv_rn), round half to even and a
//     clip to +-127: bit for bit ops/paged_prefill._kv_quantize_rows.  The
//     build never uses -use_fast_math.
//   * Hopper's programmatic dependent launch: every CTA triggers its
//     dependents on entry, so the attention kernel that reads the pool next
//     (paged_decode.cu, paged_prefill.cu, launched by
//     aiko::launch_dependent) begins its launch while the writer drains and
//     waits for its writes before its first read (raced against plain
//     launches by tools/kv_write_lab.py --pdl: 1-2 us faster a writer +
//     attention pair on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
#include "common.cuh"

namespace {

enum Mode { kAligned = 0, kRagged = 1, kRows = 2 };

constexpr int kMaxThreads = 1024;

// 16 bytes of activations, read through the non-coherent path.  volatile:
// the load stays ahead of the metadata chain in program order.
__device__ __forceinline__ uint4 load16(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// The 16 loaded bytes as floats: 8 bf16 (exact) or 4 f32.
template <typename InT>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void unpack(const uint4& r,
                                                float (&f)[kVec]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Chunk<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void unpack(const uint4& r,
                                                float (&f)[kVec]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

// One thread's store of its chunk into the pool row (`dst` is the chunk's
// first element).  int8 pools: the codes, and the vector's scale (the
// absmax of its `lanes` lanes, reduced over `group_mask`) from its first
// lane.
template <typename InT, typename PoolT>
struct Store {
  static __device__ __forceinline__ void run(PoolT* dst, float* scale_dst,
                                             const uint4& raw, unsigned,
                                             int) {
    if constexpr (sizeof(InT) == sizeof(PoolT)) {
      *reinterpret_cast<uint4*>(dst) = raw;       // same type: the bytes
    } else {
      float f[Chunk<InT>::kVec];
      Chunk<InT>::unpack(raw, f);
      if constexpr (sizeof(PoolT) == 4) {         // bf16 -> f32: 32 bytes
        float4* out = reinterpret_cast<float4*>(dst);
        out[0] = make_float4(f[0], f[1], f[2], f[3]);
        out[1] = make_float4(f[4], f[5], f[6], f[7]);
      } else {                                    // f32 -> bf16: 8 bytes
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(aiko::pack_bf16x2(f[0], f[1]),
                       aiko::pack_bf16x2(f[2], f[3]));
      }
    }
  }
};

template <typename InT>
struct Store<InT, int8_t> {
  static constexpr int kVec = Chunk<InT>::kVec;
  static __device__ __forceinline__ void run(int8_t* dst, float* scale_dst,
                                             const uint4& raw,
                                             unsigned group_mask,
                                             int lanes) {
    float f[kVec];
    Chunk<InT>::unpack(raw, f);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) amax = fmaxf(amax, fabsf(f[i]));
    for (int offset = lanes / 2; offset > 0; offset >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(group_mask, amax, offset));
    const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);
    unsigned packed[kVec / 4];
#pragma unroll
    for (int w = 0; w < kVec / 4; ++w) {
      unsigned word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int q = __float2int_rn(__fdiv_rn(f[4 * w + b], scale));
        word |= (unsigned)(min(max(q, -127), 127) & 0xff) << (8 * b);
      }
      packed[w] = word;
    }
    if constexpr (kVec == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
    else
      *reinterpret_cast<unsigned*>(dst) = packed[0];
    if (scale_dst != nullptr) *scale_dst = scale;
  }
};

// Grid (batch * T, head groups); block = heads a CTA x lanes.  k_stride /
// v_stride: the elements between consecutive (row, token) vector sets of
// k_new / v_new (their kv heads and features contiguous).
template <int M, typename InT, typename PoolT>
__device__ __forceinline__ void write_kv(
    const InT* __restrict__ k_new, const InT* __restrict__ v_new,
    PoolT* __restrict__ k_pool, PoolT* __restrict__ v_pool,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const int* __restrict__ tables, const int* __restrict__ cached_lens,
    const int* __restrict__ chunk_lens, int T, int kv_heads, int head_dim,
    int block_size, int max_blocks, long long k_stride, long long v_stride,
    int lanes, int clamp_rows) {
  constexpr int kVec = Chunk<InT>::kVec;
  aiko::trigger_dependents();   // the next kernel may begin its launch
  const int bt = blockIdx.x;                  // row * T + token
  const int head = blockIdx.y * (blockDim.x / lanes) + threadIdx.x / lanes;
  const int c = threadIdx.x % lanes;          // chunk of the vector
  if (head >= kv_heads) return;               // whole lane groups leave
  const size_t feature = (size_t)head * head_dim + (size_t)c * kVec;
  const uint4 k_raw = load16(k_new + bt * k_stride + feature);
  const uint4 v_raw = load16(v_new + bt * v_stride + feature);

  const int row = bt / T, token = bt % T;
  const int cached = cached_lens[row];
  int offset, entry;
  if constexpr (M == kAligned) {
    const int cb = token / block_size;
    if (cb * block_size >= chunk_lens[row]) return;
    entry = cached / block_size + cb;
    offset = token % block_size;
  } else if constexpr (M == kRagged) {
    if (token >= chunk_lens[row]) return;
    entry = (cached + token) / block_size;
    offset = (cached + token) % block_size;
  } else {  // kRows: kRagged at T = 1 with every row live
    const int last = max_blocks * block_size - 1;
    const int pos = clamp_rows ? min(cached, last) : cached;
    if (pos > last) return;                   // past the pool's table
    entry = pos / block_size;
    offset = pos % block_size;
  }
  const int blk = tables[(size_t)row * max_blocks + min(entry, max_blocks - 1)];
  const size_t slot =
      ((size_t)blk * block_size + offset) * kv_heads + head;

  const int lane = threadIdx.x & 31;
  const unsigned group_mask =
      lanes == 32 ? 0xffffffffu
                  : ((1u << lanes) - 1u) << (lane & ~(lanes - 1));
  const bool first = c == 0;
  Store<InT, PoolT>::run(k_pool + slot * head_dim + c * kVec,
                         first && k_scale ? k_scale + slot : nullptr, k_raw,
                         group_mask, lanes);
  Store<InT, PoolT>::run(v_pool + slot * head_dim + c * kVec,
                         first && v_scale ? v_scale + slot : nullptr, v_raw,
                         group_mask, lanes);
}

#define AIKO_KV_WRITE_KERNEL(NAME, MODE)                                    \
  template <typename InT, typename PoolT>                                   \
  __global__ void __launch_bounds__(kMaxThreads) NAME(                      \
      const InT* __restrict__ k_new, const InT* __restrict__ v_new,         \
      PoolT* __restrict__ k_pool, PoolT* __restrict__ v_pool,               \
      float* __restrict__ k_scale, float* __restrict__ v_scale,             \
      const int* __restrict__ tables, const int* __restrict__ cached_lens,  \
      const int* __restrict__ chunk_lens, int T, int kv_heads, int head_dim, \
      int block_size, int max_blocks, long long k_stride,                   \
      long long v_stride, int lanes, int clamp_rows) {                      \
    write_kv<MODE, InT, PoolT>(k_new, v_new, k_pool, v_pool, k_scale,       \
                               v_scale, tables, cached_lens, chunk_lens, T, \
                               kv_heads, head_dim, block_size, max_blocks,  \
                               k_stride, v_stride, lanes, clamp_rows);      \
  }

AIKO_KV_WRITE_KERNEL(append_kv_kernel, kAligned)
AIKO_KV_WRITE_KERNEL(append_kv_ragged_kernel, kRagged)
AIKO_KV_WRITE_KERNEL(write_kv_rows_kernel, kRows)

struct Args {
  const void *k_new, *v_new;
  void *k_pool, *v_pool, *k_scale, *v_scale;
  const void *tables, *cached_lens, *chunk_lens;
  int batch, T, kv_heads, head_dim, block_size, max_blocks;
  long long k_stride, v_stride;
  cudaStream_t stream;
  int clamp_rows;  // kRows: clamp to the last row (else drop past the table)
};

template <int M>
struct Launch {
  template <typename InT, typename PoolT>
  static cudaError_t run(const Args& a) {
    const int bytes = a.head_dim * (int)sizeof(InT);
    const int lanes = bytes / 16;
    if (bytes % 16 != 0 || lanes > 32 || (lanes & (lanes - 1)) != 0)
      return cudaErrorInvalidValue;
    if (a.batch * a.T <= 0 || a.kv_heads <= 0) return cudaSuccess;
    const int heads_per_cta = min(a.kv_heads, kMaxThreads / lanes);
    const dim3 grid(a.batch * a.T,
                    (a.kv_heads + heads_per_cta - 1) / heads_per_cta);
    const auto kernel = M == kAligned  ? &append_kv_kernel<InT, PoolT>
                        : M == kRagged ? &append_kv_ragged_kernel<InT, PoolT>
                                       : &write_kv_rows_kernel<InT, PoolT>;
    kernel<<<grid, heads_per_cta * lanes, 0, a.stream>>>(
        static_cast<const InT*>(a.k_new), static_cast<const InT*>(a.v_new),
        static_cast<PoolT*>(a.k_pool), static_cast<PoolT*>(a.v_pool),
        static_cast<float*>(a.k_scale), static_cast<float*>(a.v_scale),
        static_cast<const int*>(a.tables),
        static_cast<const int*>(a.cached_lens),
        static_cast<const int*>(a.chunk_lens), a.T, a.kv_heads, a.head_dim,
        a.block_size, a.max_blocks, a.k_stride, a.v_stride, lanes,
        a.clamp_rows);
    return cudaGetLastError();
  }
};

// Route (activation dtype, pool dtype) to Launch<M>::run<InT, PoolT>: bf16
// or f32 activations; bf16, f32 or int8 pools (int8 with f32 scales).
template <int M>
cudaError_t dispatch(int in_dtype, int pool_dtype, const Args& a) {
  if (a.block_size < 1 || a.head_dim < 1 || a.max_blocks < 1 ||
      (pool_dtype == AIKO_I8) != (a.k_scale != nullptr && a.v_scale != nullptr))
    return cudaErrorInvalidValue;
  using L = Launch<M>;
  if (in_dtype == AIKO_BF16) {
    if (pool_dtype == AIKO_BF16)
      return L::template run<__nv_bfloat16, __nv_bfloat16>(a);
    if (pool_dtype == AIKO_F32) return L::template run<__nv_bfloat16, float>(a);
    if (pool_dtype == AIKO_I8) return L::template run<__nv_bfloat16, int8_t>(a);
  } else if (in_dtype == AIKO_F32) {
    if (pool_dtype == AIKO_BF16)
      return L::template run<float, __nv_bfloat16>(a);
    if (pool_dtype == AIKO_F32) return L::template run<float, float>(a);
    if (pool_dtype == AIKO_I8) return L::template run<float, int8_t>(a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// k_new/v_new (batch, T, kv_heads, head_dim) contiguous in `in_dtype` (bf16
// or f32); pools (n_blocks, block_size, kv_heads, head_dim) in `pool_dtype`
// (bf16, f32, or int8 with f32 scales (n_blocks, block_size, kv_heads));
// tables (batch, max_blocks), cached_lens and chunk_lens (batch,) int32.
// head_dim * sizeof(in) a multiple of 16 bytes, at most 512, with a power of
// two of 16-byte chunks; 16-byte-aligned operands.  aiko_append_kv: cached
// lens are multiples of block_size, T is one too.  aiko_append_kv_ragged:
// any cached_lens, any T.
extern "C" int aiko_append_kv(const void* k_new, const void* v_new,
                              void* k_pool, void* v_pool, void* k_scale,
                              void* v_scale, const void* tables,
                              const void* cached_lens,
                              const void* chunk_lens, int batch, int T,
                              int kv_heads, int head_dim, int block_size,
                              int max_blocks, int in_dtype, int pool_dtype,
                              void* stream) {
  if (block_size < 1 || T % block_size != 0) return cudaErrorInvalidValue;
  const long long stride = (long long)kv_heads * head_dim;
  return dispatch<kAligned>(
      in_dtype, pool_dtype,
      Args{k_new, v_new, k_pool, v_pool, k_scale, v_scale, tables,
           cached_lens, chunk_lens, batch, T, kv_heads, head_dim, block_size,
           max_blocks, stride, stride, static_cast<cudaStream_t>(stream),
           0});
}

extern "C" int aiko_append_kv_ragged(const void* k_new, const void* v_new,
                                     void* k_pool, void* v_pool,
                                     void* k_scale, void* v_scale,
                                     const void* tables,
                                     const void* cached_lens,
                                     const void* chunk_lens, int batch,
                                     int T, int kv_heads, int head_dim,
                                     int block_size, int max_blocks,
                                     int in_dtype, int pool_dtype,
                                     void* stream) {
  const long long stride = (long long)kv_heads * head_dim;
  return dispatch<kRagged>(
      in_dtype, pool_dtype,
      Args{k_new, v_new, k_pool, v_pool, k_scale, v_scale, tables,
           cached_lens, chunk_lens, batch, T, kv_heads, head_dim, block_size,
           max_blocks, stride, stride, static_cast<cudaStream_t>(stream),
           0});
}

// One row a slot: k/v (batch, 1, kv_heads, head_dim) whose kv heads and
// features are contiguous, row b at k + b * k_stride (v likewise), lands at
// position positions[b] (int32, non-negative) through tables (batch,
// max_blocks).  A position at or past max_blocks * block_size is clamped to
// the last row when clamp_rows is set (a contiguous cache), else dropped.
extern "C" int aiko_write_kv_rows(const void* k, const void* v, void* k_pool,
                                  void* v_pool, void* k_scale, void* v_scale,
                                  const void* tables, const void* positions,
                                  int batch, int kv_heads, int head_dim,
                                  int block_size, int max_blocks,
                                  long long k_stride, long long v_stride,
                                  int in_dtype, int pool_dtype,
                                  int clamp_rows, void* stream) {
  return dispatch<kRows>(
      in_dtype, pool_dtype,
      Args{k, v, k_pool, v_pool, k_scale, v_scale, tables, positions,
           nullptr, batch, 1, kv_heads, head_dim, block_size, max_blocks,
           k_stride, v_stride, static_cast<cudaStream_t>(stream),
           clamp_rows});
}
