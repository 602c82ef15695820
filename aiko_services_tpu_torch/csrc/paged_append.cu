// Paged KV append: a prefill chunk's K/V rows land in their pool blocks, in
// place, quantized on int8 pools.
//
// Replaces: aiko_services_tpu/ops/paged_prefill.py::_append_kv, the Pallas
// kernel `_append_kv_kernel` (paged_prefill.py:183, pallas_call at
// paged_prefill.py:264).
//
// Bound on the H100: bytes.  It reads the chunk's 2*T*kv*hd activations once
// and writes as many pool elements (plus one f32 scale per token and head on
// int8 pools); there is no arithmetic to speak of.
//
// Design against that bound:
//   * the TPU grid (row, kv head, chunk block) resolved its target block in
//     the output index map; here one warp owns one (row, token, kv head)
//     vector and reads its pool block id from the table itself
//     (tables[row, cached / bs + token / bs]), so every row of every block
//     is written by exactly one warp and nothing is read back;
//   * blocks that start at or past the row's chunk_len write nothing (the
//     TPU kernel flushed them into scratch block 0, never attended);
//   * int8 pools: the warp reduces the vector's absmax with shuffles, then
//     every lane divides its elements by scale = amax / 127 (1 when amax is
//     0) with a true IEEE division, rounds half to even (rintf) and clips to
//     +-127: bit for bit the plain _kv_quantize_rows, which is why the build
//     must never use -use_fast_math;
//   * lanes walk the feature axis with a stride of 32 elements, so each
//     warp-wide access is one contiguous run of the vector.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, one (row, token, head) each

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

template <typename InT, typename PoolT>
__device__ __forceinline__ void write_vector(const InT* __restrict__ src,
                                             PoolT* __restrict__ dst,
                                             float* __restrict__ scale_out,
                                             int head_dim, int lane) {
  for (int e = lane; e < head_dim; e += 32) store(dst + e, aiko::to_float(src[e]));
}

template <typename InT>
__device__ __forceinline__ void write_vector(const InT* __restrict__ src,
                                             int8_t* __restrict__ dst,
                                             float* __restrict__ scale_out,
                                             int head_dim, int lane) {
  float amax = 0.f;
  for (int e = lane; e < head_dim; e += 32)
    amax = fmaxf(amax, fabsf(aiko::to_float(src[e])));
  amax = aiko::warp_max(amax);
  const float scale = amax == 0.f ? 1.f : amax / 127.0f;
  for (int e = lane; e < head_dim; e += 32) {
    const float r = rintf(aiko::to_float(src[e]) / scale);
    dst[e] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  if (lane == 0) *scale_out = scale;
}

template <typename InT, typename PoolT>
__global__ void __launch_bounds__(kThreads) append_kv_kernel(
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
  const int cb = token / block_size;
  if (cb * block_size >= chunk_lens[row]) return;
  const int entry = min(cached_lens[row] / block_size + cb, max_blocks - 1);
  const int blk = tables[(size_t)row * max_blocks + entry];
  const size_t slot =
      ((size_t)blk * block_size + token % block_size) * kv_heads + head;
  const size_t src = (size_t)vector * head_dim;
  write_vector(k_new + src, k_pool + slot * head_dim,
               k_scale == nullptr ? nullptr : k_scale + slot, head_dim, lane);
  write_vector(v_new + src, v_pool + slot * head_dim,
               v_scale == nullptr ? nullptr : v_scale + slot, head_dim, lane);
}

template <typename InT, typename PoolT>
cudaError_t launch(const void* k_new, const void* v_new, void* k_pool,
                   void* v_pool, void* k_scale, void* v_scale,
                   const void* tables, const void* cached_lens,
                   const void* chunk_lens, int batch, int T, int kv_heads,
                   int head_dim, int block_size, int max_blocks,
                   cudaStream_t stream) {
  const int vectors = batch * T * kv_heads;
  const int per_cta = kThreads / 32;
  const int grid = (vectors + per_cta - 1) / per_cta;
  if (grid == 0) return cudaSuccess;
  append_kv_kernel<InT, PoolT><<<grid, kThreads, 0, stream>>>(
      static_cast<const InT*>(k_new), static_cast<const InT*>(v_new),
      static_cast<PoolT*>(k_pool), static_cast<PoolT*>(v_pool),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const int*>(tables), static_cast<const int*>(cached_lens),
      static_cast<const int*>(chunk_lens), vectors, T, kv_heads, head_dim,
      block_size, max_blocks);
  return cudaGetLastError();
}

template <typename InT>
cudaError_t dispatch_pool(int pool_dtype, const void* k_new,
                          const void* v_new, void* k_pool, void* v_pool,
                          void* k_scale, void* v_scale, const void* tables,
                          const void* cached_lens, const void* chunk_lens,
                          int batch, int T, int kv_heads, int head_dim,
                          int block_size, int max_blocks,
                          cudaStream_t stream) {
  if (pool_dtype == AIKO_I8)
    return launch<InT, int8_t>(k_new, v_new, k_pool, v_pool, k_scale,
                               v_scale, tables, cached_lens, chunk_lens,
                               batch, T, kv_heads, head_dim, block_size,
                               max_blocks, stream);
  if (pool_dtype == AIKO_BF16)
    return launch<InT, __nv_bfloat16>(k_new, v_new, k_pool, v_pool, nullptr,
                                      nullptr, tables, cached_lens,
                                      chunk_lens, batch, T, kv_heads,
                                      head_dim, block_size, max_blocks,
                                      stream);
  if (pool_dtype == AIKO_F32)
    return launch<InT, float>(k_new, v_new, k_pool, v_pool, nullptr, nullptr,
                              tables, cached_lens, chunk_lens, batch, T,
                              kv_heads, head_dim, block_size, max_blocks,
                              stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// k_new/v_new (batch, T, kv_heads, head_dim) contiguous in `in_dtype` (bf16
// or f32); pools (n_blocks, block_size, kv_heads, head_dim) in `pool_dtype`
// (bf16, f32, or int8 with f32 scales (n_blocks, block_size, kv_heads));
// tables (batch, max_blocks), cached_lens and chunk_lens (batch,) int32.
// cached_lens are multiples of block_size and T is one too.
extern "C" int aiko_append_kv(const void* k_new, const void* v_new,
                              void* k_pool, void* v_pool, void* k_scale,
                              void* v_scale, const void* tables,
                              const void* cached_lens,
                              const void* chunk_lens, int batch, int T,
                              int kv_heads, int head_dim, int block_size,
                              int max_blocks, int in_dtype, int pool_dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_size < 1 || T % block_size != 0 || head_dim < 1 ||
      max_blocks < 1 || (pool_dtype == AIKO_I8 && k_scale == nullptr))
    return cudaErrorInvalidValue;
  if (in_dtype == AIKO_BF16)
    return dispatch_pool<__nv_bfloat16>(
        pool_dtype, k_new, v_new, k_pool, v_pool, k_scale, v_scale, tables,
        cached_lens, chunk_lens, batch, T, kv_heads, head_dim, block_size,
        max_blocks, st);
  if (in_dtype == AIKO_F32)
    return dispatch_pool<float>(pool_dtype, k_new, v_new, k_pool, v_pool,
                                k_scale, v_scale, tables, cached_lens,
                                chunk_lens, batch, T, kv_heads, head_dim,
                                block_size, max_blocks, st);
  return cudaErrorInvalidValue;
}
