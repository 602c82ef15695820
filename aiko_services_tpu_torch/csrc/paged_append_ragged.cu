// Ragged paged KV append: a speculative verify window's K/V rows land in
// their pool blocks at UNALIGNED per-row start positions, in place,
// quantized on int8 pools.
//
// Replaces: aiko_services_tpu/ops/paged_prefill.py::_append_kv_ragged, the
// Pallas kernel `_append_kv_ragged_kernel` (paged_prefill.py:514,
// pallas_call at paged_prefill.py:619).
//
// Bound on the H100: bytes.  It reads the window's live 2*chunk_len*kv*hd
// activations once and writes as many pool elements (plus one f32 scale
// per token and head on int8 pools).  A verify window is a few tokens per
// row (k + 1), so at the serving shapes the launch itself dominates.
//
// Design against that bound:
//   * the TPU kernel read each touched pool block, merged the window's rows
//     into it and flushed the whole block back, and identity-flushed scratch
//     block 0 for idle rows: artefacts of its BlockSpec, which moves whole
//     blocks.  Here one warp owns one (row, token, kv head) vector and
//     writes only that pool row: tables[row, (cached + token) / bs], offset
//     (cached + token) % bs.  Nothing is read back and rows at or past the
//     row's chunk_len (every row of a chunk_len == 0 row) write nothing;
//   * the vector write and the int8 quantizer are kv_write.cuh's, shared
//     with the aligned chunk writer (paged_append.cu), so verify-written
//     rows are byte-identical to what the plain quantizer writes.
#include "kv_write.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps, one (row, token, head) each

template <typename InT, typename PoolT>
__global__ void __launch_bounds__(kThreads) append_kv_ragged_kernel(
    const InT* __restrict__ k_new, const InT* __restrict__ v_new,
    PoolT* __restrict__ k_pool, PoolT* __restrict__ v_pool,
    float* __restrict__ k_scale, float* __restrict__ v_scale,
    const int* __restrict__ tables, const int* __restrict__ cached_lens,
    const int* __restrict__ chunk_lens, int vectors, int T, int kv_heads,
    int head_dim, int block_size, int max_blocks) {
  const int vector = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (vector >= vectors) return;
  // vector = (row * T + token) * kv_heads + head: the k_new/v_new row.
  const int head = vector % kv_heads;
  const int token = (vector / kv_heads) % T;
  const int row = vector / (kv_heads * T);
  if (token >= chunk_lens[row]) return;
  const int pos = cached_lens[row] + token;
  const int entry = min(pos / block_size, max_blocks - 1);
  const int blk = tables[(size_t)row * max_blocks + entry];
  const size_t slot =
      ((size_t)blk * block_size + pos % block_size) * kv_heads + head;
  aiko::write_kv_pair(k_new, v_new, k_pool, v_pool, k_scale, v_scale,
                      (size_t)vector * head_dim, slot, head_dim, lane);
}

template <typename InT, typename PoolT>
struct Launch {
  static cudaError_t run(const void* k_new, const void* v_new, void* k_pool,
                         void* v_pool, void* k_scale, void* v_scale,
                         const void* tables, const void* cached_lens,
                         const void* chunk_lens, int batch, int T,
                         int kv_heads, int head_dim, int block_size,
                         int max_blocks, cudaStream_t stream) {
    const int vectors = batch * T * kv_heads;
    const int per_cta = kThreads / 32;
    const int grid = (vectors + per_cta - 1) / per_cta;
    if (grid == 0) return cudaSuccess;
    append_kv_ragged_kernel<InT, PoolT><<<grid, kThreads, 0, stream>>>(
        static_cast<const InT*>(k_new), static_cast<const InT*>(v_new),
        static_cast<PoolT*>(k_pool), static_cast<PoolT*>(v_pool),
        static_cast<float*>(k_scale), static_cast<float*>(v_scale),
        static_cast<const int*>(tables),
        static_cast<const int*>(cached_lens),
        static_cast<const int*>(chunk_lens), vectors, T, kv_heads, head_dim,
        block_size, max_blocks);
    return cudaGetLastError();
  }
};

}  // namespace

// k_new/v_new (batch, T, kv_heads, head_dim) contiguous in `in_dtype` (bf16
// or f32); pools (n_blocks, block_size, kv_heads, head_dim) in `pool_dtype`
// (bf16, f32, or int8 with f32 scales (n_blocks, block_size, kv_heads));
// tables (batch, max_blocks), cached_lens and chunk_lens (batch,) int32.
// Row t < chunk_lens[b] of row b lands at position cached_lens[b] + t; any
// cached_lens, any T.
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
  if (block_size < 1 || head_dim < 1 || max_blocks < 1 ||
      (pool_dtype == AIKO_I8 && k_scale == nullptr))
    return cudaErrorInvalidValue;
  return aiko::dispatch_kv_dtypes<Launch>(
      in_dtype, pool_dtype, k_new, v_new, k_pool, v_pool, k_scale, v_scale,
      tables, cached_lens, chunk_lens, batch, T, kv_heads, head_dim,
      block_size, max_blocks, static_cast<cudaStream_t>(stream));
}
