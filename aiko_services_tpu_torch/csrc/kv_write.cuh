// The per-vector KV writer of the paged append kernels (paged_append.cu,
// paged_append_ragged.cu): one warp moves one (token, kv head) vector of
// head_dim elements into its pool row, quantizing it on int8 pools exactly
// as the plain ops/paged_prefill._kv_quantize_rows does.
//
// int8: the warp reduces the vector's absmax with shuffles, then every lane
// divides its elements by scale = amax / 127 (1 when amax is 0) with a true
// IEEE division, rounds half to even (rintf) and clips to +-127.  That is bit
// for bit the plain quantizer, which is why the build must never use
// -use_fast_math.  Lanes walk the feature axis with a stride of 32 elements,
// so each warp-wide access is one contiguous run of the vector.
#pragma once

#include "common.cuh"

#include <math.h>

namespace aiko {

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

template <typename InT, typename PoolT>
__device__ __forceinline__ void write_kv_vector(const InT* __restrict__ src,
                                                PoolT* __restrict__ dst,
                                                float* __restrict__ scale_out,
                                                int head_dim, int lane) {
  for (int e = lane; e < head_dim; e += 32) store(dst + e, to_float(src[e]));
}

template <typename InT>
__device__ __forceinline__ void write_kv_vector(const InT* __restrict__ src,
                                                int8_t* __restrict__ dst,
                                                float* __restrict__ scale_out,
                                                int head_dim, int lane) {
  float amax = 0.f;
  for (int e = lane; e < head_dim; e += 32)
    amax = fmaxf(amax, fabsf(to_float(src[e])));
  amax = warp_max(amax);
  const float scale = amax == 0.f ? 1.f : amax / 127.0f;
  for (int e = lane; e < head_dim; e += 32) {
    const float r = rintf(to_float(src[e]) / scale);
    dst[e] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
  if (lane == 0) *scale_out = scale;
}

// K and V of one vector: `src` is the vector's offset in k_new/v_new, `slot`
// its (pool block row, kv head) index in the pool.
template <typename InT, typename PoolT>
__device__ __forceinline__ void write_kv_pair(
    const InT* __restrict__ k_new, const InT* __restrict__ v_new,
    PoolT* __restrict__ k_pool, PoolT* __restrict__ v_pool,
    float* __restrict__ k_scale, float* __restrict__ v_scale, size_t src,
    size_t slot, int head_dim, int lane) {
  write_kv_vector(k_new + src, k_pool + slot * head_dim,
                  k_scale == nullptr ? nullptr : k_scale + slot, head_dim,
                  lane);
  write_kv_vector(v_new + src, v_pool + slot * head_dim,
                  v_scale == nullptr ? nullptr : v_scale + slot, head_dim,
                  lane);
}

// Host side: route (k/v dtype, pool dtype) to Launcher<InT, PoolT>::run(
// args...); bf16 or f32 k/v, bf16, f32 or int8 pools.
template <template <typename, typename> class Launcher, typename InT,
          typename... Args>
cudaError_t dispatch_pool_dtype(int pool_dtype, Args... args) {
  if (pool_dtype == AIKO_I8) return Launcher<InT, int8_t>::run(args...);
  if (pool_dtype == AIKO_BF16)
    return Launcher<InT, __nv_bfloat16>::run(args...);
  if (pool_dtype == AIKO_F32) return Launcher<InT, float>::run(args...);
  return cudaErrorInvalidValue;
}

template <template <typename, typename> class Launcher, typename... Args>
cudaError_t dispatch_kv_dtypes(int in_dtype, int pool_dtype, Args... args) {
  if (in_dtype == AIKO_BF16)
    return dispatch_pool_dtype<Launcher, __nv_bfloat16>(pool_dtype, args...);
  if (in_dtype == AIKO_F32)
    return dispatch_pool_dtype<Launcher, float>(pool_dtype, args...);
  return cudaErrorInvalidValue;
}

}  // namespace aiko
