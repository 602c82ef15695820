// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel source exposes a plain C entry point (no PyTorch headers, so
// nvcc builds each file in seconds) that launches on the caller's stream and
// returns the cudaGetLastError() code of its launch; ops/_cuda.py binds the
// entries with ctypes and raises on a non-zero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with ops/_cuda.py (DTYPE_CODES).
enum AikoDtype { AIKO_F32 = 0, AIKO_BF16 = 1, AIKO_I8 = 2 };

// The JAX package's finite masking value (ops/attention.py NEG_INF): a row
// fully masked inside one live block must give exp(0) mass that a later
// correction exp(NEG_INF - m) cancels, never exp(-inf - -inf) = NaN.
#define AIKO_NEG_INF (-1e30f)

namespace aiko {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// 16-byte asynchronous global->shared copy; with pred false the 16 shared
// bytes are zero-filled and nothing is read from global memory.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two floats as one bf16x2 register (round to nearest even), low half
// first: the operand packing of the bf16 tensor-core instructions.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&pair);
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32
// accumulate: one warp-wide mma.sync (fragment layouts as in the PTX ISA,
// "Matrix Fragments for mma.m16n8k16").
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], unsigned a0,
                                               unsigned a1, unsigned a2,
                                               unsigned a3, unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

}  // namespace aiko
