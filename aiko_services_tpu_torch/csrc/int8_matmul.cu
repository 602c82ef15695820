// Weight-only int8 matmul for decode shapes: out = bf16((x @ q) * s).
//
// Replaces: aiko_services_tpu/ops/quant.py::int8_matmul, the Pallas kernel
// `_kernel` (quant.py:135, pallas_call at quant.py:180), taken for m <= 64,
// K % 32 == 0, N % 128 == 0 and the VMEM-budget rule of `_pick_block`.
//
// Bound on the H100: at m <= 64 the call must stream the whole K x N int8
// weight once (K*N bytes at the card's memory rate); its 2*m*K*N
// operations stay below the tensor-core line for m <= 64, so the bound is
// bytes.
//
// Design against that bound (the streaming structure is the int4 kernel's,
// weight_stream.cuh):
//   * one CTA owns a 256-column tile of N and a slice of K: every weight
//     byte is read from device memory once, 256 contiguous bytes of each
//     row at a time, as two 2-d TMA boxes of 128 columns x 64 K rows a
//     stage (128-byte swizzled, counted on the stage's mbarrier; rows past
//     K land as zeros), x's rows by cp.async.  K is split by (K, N) alone
//     so that the tile x slice CTAs fill the card in one wave at two CTAs
//     an SM (ops/quant.py _k_split), and the last CTA of a tile sums the
//     slices' f32 partials in slice order with the loads of several slices
//     in flight;
//   * the ring lives in dynamic shared memory, as deep as each instance's
//     residency allows (3 stages at MR <= 16 with three CTAs an SM, 4 at
//     MR = 32 and 64 with two), all but one stage in flight; the 64-column
//     kernel it replaces copied 64-byte pieces of each row with 16-byte
//     cp.async copies from every thread into 48 KB of static memory;
//   * int8 becomes bf16 with integer ops only, clear of the conversion
//     unit: a byte permute puts one column's bytes of k rows k and k + 1
//     in the low bytes of the two 16-bit lanes, and aiko::int8x2_to_bf16x2
//     (two LOP3 and one bf16x2 subtraction) makes them exact bf16.  The k
//     rows stay in their natural order, so x needs no permute;
//   * the product runs on the tensor cores, the weight tile as operand A
//     and x as operand B; each warp owns 32 columns (two m tiles of 16)
//     and every K row of the slice.  Below 64 rows of x it is mma.sync
//     m16n8k16; the 64-row instance runs wgmma m64n64k16 (swap-AB: each
//     warpgroup's four warps give the converted A tile from registers, x is
//     B from a 128-byte-swizzled stage, read once a warpgroup where eight
//     mma.sync warps each load it), with the A registers double-buffered so
//     that k step s + 1 converts while step s's products are in flight.
//     The two give the same bits for every row (lab --bits), and each wins
//     its instances (lab: wgmma 2-14% faster at m = 40 and 64, 2-27%
//     slower at m <= 8);
//   * f32 accumulation; the per-column scales are read once (loaded before
//     the main loop, applied in the epilogue) with the one rounding to bf16
//     (the TPU kernel's order).
//
// A row's sum does not depend on m or on the instance: every instance
// splits K alike, runs products that give the same bits and merges in
// slice order.
#include "weight_stream.cuh"

namespace {

using namespace aiko::wstream;
using aiko::mbar_expect_tx;
using aiko::smem_u32;

constexpr int kBoxBytes = kKC * kBoxCols;          // 64 rows of 128 bytes
constexpr int kWBytes = kNT / kBoxCols * kBoxBytes;  // a stage's weight

// CTAs an SM of an MR-row instance (what its registers allow) and its ring.
__host__ __device__ constexpr int ctas_per_sm(int mr) {
  return mr <= 16 ? 3 : 2;
}
// The instance's register cap, as CTAs an SM: the 8-row instance is held to
// 64 registers (four CTAs' worth; its ring keeps three resident).  At the
// 70 that ptxas picks under three's cap of 80, its main loop streamed the
// LM head (64 stages a CTA) at 2.3 TB/s against 2.9 (lab, tuning regs80).
__host__ __device__ constexpr int reg_blocks(int mr) {
  return mr <= 8 ? 4 : ctas_per_sm(mr);
}
// The product of an MR-row instance: wgmma at 64 rows, mma.sync below.
__host__ __device__ constexpr bool uses_wgmma(int mr) {
  return mr == 64;
}
// x's row in a stage: padded for mma.sync, swizzled for wgmma.
__host__ __device__ constexpr int x_row_bytes(int mr) {
  return uses_wgmma(mr) ? kKC * 2 : kXLd;
}
template <int MR>
using RingOf =
    Ring<kWBytes + MR * x_row_bytes(MR), ctas_per_sm(MR), MR * kNT * 4>;
// The split merge's float4 loads in flight a thread: 64 registers, which
// with a pass's sums fit the 128 of two CTAs an SM (MR >= 32), 32 under
// the 80 of three.
template <int MR>
constexpr int kMergeLoadsOf = MR >= 32 ? 16 : 8;

// This thread's weights of one k step as the A fragments of its two m
// tiles: w0, w1, w8, w9 are k rows k, k + 1, k + 8, k + 9 (k = 16 step +
// 2c), columns 4g..4g+3 of the warp's 32, one byte each.  m tile t holds
// columns 4g + 2t (A row g) and 4g + 2t + 1 (row g + 8).
__device__ __forceinline__ void convert(unsigned w0, unsigned w1,
                                        unsigned w8, unsigned w9,
                                        unsigned (&a)[2][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    // Byte j of the first word to bits 0-7, of the second to bits 16-23.
    const unsigned even = 0x0400u + 0x0101u * (2 * t);
    const unsigned odd = 0x0400u + 0x0101u * (2 * t + 1);
    a[t][0] = aiko::int8x2_to_bf16x2(__byte_perm(w0, w1, even));
    a[t][1] = aiko::int8x2_to_bf16x2(__byte_perm(w0, w1, odd));
    a[t][2] = aiko::int8x2_to_bf16x2(__byte_perm(w8, w9, even));
    a[t][3] = aiko::int8x2_to_bf16x2(__byte_perm(w8, w9, odd));
  }
}

// MR: rows of x per CTA (8, 16, 32 or 64).
template <int MR>
__global__ void __launch_bounds__(kThreads, reg_blocks(MR))
    int8_matmul_kernel(const __grid_constant__ CUtensorMap w_map,
                       const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ s,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ partials,
                       int* __restrict__ arrivals, int m, int K, int N,
                       int k_split) {
  using R = RingOf<MR>;
  constexpr bool kWgmma = uses_wgmma(MR);
  constexpr int kMT = MR / 8;                  // mma n-tiles over x rows
  constexpr int kStages = R::kStages;
  constexpr int kStageBytes = R::kStageBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  unsigned char* smem = ring_base(smem_raw);
  const uint32_t base = smem_u32(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int n0 = blockIdx.x * kNT;
  // This warp's columns n0 + 32 * warp ..; past N in the last tile of an
  // N that is not a multiple of 256.
  const bool warp_live = n0 + 32 * warp < N;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int k_begin = split * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int nk = (k_end - k_begin + kKC - 1) / kKC;
  // The scales of the four columns this thread stores, read once, their
  // latency hidden under the main loop.
  const int c4 = 4 * (tid % 64);
  const float4 sc = n0 + c4 < N
                        ? *reinterpret_cast<const float4*>(s + n0 + c4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);

  // A stage: the weight's 64 rows as two boxes (a box wholly past N is
  // not issued), issued by thread 0 and counted on the stage's mbarrier,
  // and x's rows by cp.async.
  const int cols = min(kNT, N - n0);
  const int boxes = (cols + kBoxCols - 1) / kBoxCols;
  auto load = [&](int slot, int i) {
    const int k0 = k_begin + i * kKC;
    if (tid == 0) {
      mbar_expect_tx(&full[slot], boxes * kBoxBytes);
      for (int bx = 0; bx < boxes; ++bx)
        tma_load_2d(base + slot * kStageBytes + bx * kBoxBytes, &w_map,
                    &full[slot], n0 + bx * kBoxCols, k0);
    }
    stage_x<MR, kWgmma>(smem + slot * kStageBytes + kWBytes, x, m, K, k0,
                        k_end);
  };

  float acc[2][kMT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][mt][i] = 0.f;

  // This thread's weight bytes: columns 32 * warp + 4g .. + 3 of the tile,
  // in box warp / 4, 16-byte chunk 2 (warp % 4) + g / 4 of a row (stored
  // at chunk ^ (row % 8): the 128-byte swizzle), bytes 4 (g % 4)..
  const int chunk = (32 * (warp % 4) + 4 * g) / 16;
  const int in_chunk = (4 * g) % 16;
  // This thread's k rows r, r + 1, r + 8, r + 9 of k step `step` of a
  // stage (r + 8 shares r's swizzle), converted to its A fragments.
  auto fragments = [&](const unsigned char* wbox, int step,
                       unsigned (&a)[2][4]) {
    const int r = 16 * step + 2 * c;
    const int sw0 = (chunk ^ (r & 7)) << 4;
    const int sw1 = (chunk ^ ((r + 1) & 7)) << 4;
    convert(
        *reinterpret_cast<const unsigned*>(wbox + r * kBoxCols + sw0),
        *reinterpret_cast<const unsigned*>(wbox + (r + 1) * kBoxCols + sw1),
        *reinterpret_cast<const unsigned*>(wbox + (r + 8) * kBoxCols + sw0),
        *reinterpret_cast<const unsigned*>(wbox + (r + 9) * kBoxCols + sw1),
        a);
  };
  auto compute = [&](int slot, int) {
    const unsigned char* ws = smem + slot * kStageBytes;
    const unsigned char* wbox = ws + (warp / 4) * kBoxBytes + in_chunk;
    if constexpr (kWgmma) {
      // Every warp computes (a warp past N only on bytes never stored): a
      // wait in a branch would serialise every wgmma.  A stage's last
      // products are waited for before the ring frees its slot.
      const uint32_t xs = base + slot * kStageBytes + kWBytes;
      unsigned a[2][2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) aiko::fence_operands(acc[t]);
#pragma unroll
      for (int step = 0; step < kKC / 16; ++step) {
        fragments(wbox, step, a[step & 1]);
        aiko::wgmma_fence();
        // x's k rows 16 step.. of every row: 32 bytes into the row.
        const uint64_t desc = aiko::make_desc(xs + 32 * step, 16, 1024, 1);
#pragma unroll
        for (int t = 0; t < 2; ++t)
          aiko::WgmmaRS<MR>::run(acc[t], a[step & 1][t], desc, 1);
        aiko::wgmma_commit();
        aiko::wgmma_wait<1>();
      }
      aiko::wgmma_wait<0>();
#pragma unroll
      for (int t = 0; t < 2; ++t) aiko::fence_operands(acc[t]);
    } else {
      if (!warp_live) return;
      const unsigned char* xs = ws + kWBytes;
#pragma unroll
      for (int step = 0; step < kKC / 16; ++step) {
        unsigned a[2][4];
        fragments(wbox, step, a);
        const int r = 16 * step + 2 * c;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const unsigned char* xrow = xs + (mt * 8 + g) * kXLd + r * 2;
          const unsigned b0 = *reinterpret_cast<const unsigned*>(xrow);
          const unsigned b1 = *reinterpret_cast<const unsigned*>(xrow + 16);
#pragma unroll
          for (int t = 0; t < 2; ++t)
            aiko::mma_bf16_16816(acc[t][mt], a[t][0], a[t][1], a[t][2],
                                 a[t][3], b0, b1);
        }
      }
    }
  };
  init_ring(full, kStages);
  run_ring<kStages, kWgmma>(full, nk, load, compute);

  // The tile's f32 sums red[MR][kNT] in the drained ring, each warp its
  // own columns.
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 32 * warp + 4 * g + 2 * t + (i >> 1);
        const int r = mt * 8 + 2 * c + (i & 1);
        red[r * kNT + col] = acc[t][mt][i];
      }
  __syncthreads();
  if (splits > 1 && !merge_slices<MR, kMergeLoadsOf<MR>>(
                        red, partials, arrivals, blockIdx.x, split, splits))
    return;

  // Epilogue: float4 e of thread tid is row 4e + tid / 64, columns
  // c4..c4 + 3 (the merge's layout), times the columns' scales, one
  // rounding to bf16, four columns a store.
  if (n0 + c4 >= N) return;
#pragma unroll
  for (int e = 0; e < MR / 4; ++e) {
    const int r = 4 * e + tid / 64;
    if (r >= m) break;
    const float4 v = reinterpret_cast<const float4*>(red)[e * kThreads + tid];
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x * sc.x, v.y * sc.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z * sc.z, v.w * sc.w);
    uint2 pair;
    pair.x = *reinterpret_cast<const unsigned*>(&lo);
    pair.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(out + (size_t)r * N + n0 + c4) = pair;
  }
}

template <int MR>
cudaError_t launch(const void* x, const void* q, const void* s, void* out,
                   void* partials, void* arrivals, int m, int K, int N,
                   int splits, int k_split, cudaStream_t stream) {
  constexpr int smem = RingOf<MR>::kSmem;
  CUtensorMap w_map;
  if (!weight_map(&w_map, q, K, N, kKC)) return cudaErrorInvalidValue;
  static std::atomic<unsigned> configured{0};
  const cudaError_t err = set_smem_once(
      configured, reinterpret_cast<const void*>(int8_matmul_kernel<MR>),
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kNT - 1) / kNT, splits);
  int8_matmul_kernel<MR><<<grid, kThreads, smem, stream>>>(
      w_map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partials), static_cast<int*>(arrivals), m, K, N,
      k_split);
  return cudaGetLastError();
}

}  // namespace

// x (m, K) bf16 row-major, q (K, N) int8, s (N,) f32, out (m, N) bf16.
// K is cut into `splits` slices of `k_split` rows (a multiple of 64); with
// splits > 1, `partials` holds ceil(N / 256) * splits * MR * 256 floats
// (MR = m rounded up to 8, 16, 32 or 64) and `arrivals` ceil(N / 256)
// int32 zeros, which the kernel leaves zero.  Needs m <= 64, N % 64 == 0,
// K % 8 == 0 and 16-byte-aligned x, q and s.
extern "C" int aiko_int8_matmul(const void* x, const void* q, const void* s,
                                void* out, void* partials, void* arrivals,
                                int m, int K, int N, int splits, int k_split,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || m > 64 || N % 64 != 0 || K % 8 != 0 || splits < 1 ||
      k_split % kKC != 0)
    return cudaErrorInvalidValue;
  if (m <= 8)
    return launch<8>(x, q, s, out, partials, arrivals, m, K, N, splits,
                     k_split, st);
  if (m <= 16)
    return launch<16>(x, q, s, out, partials, arrivals, m, K, N, splits,
                      k_split, st);
  if (m <= 32)
    return launch<32>(x, q, s, out, partials, arrivals, m, K, N, splits,
                      k_split, st);
  return launch<64>(x, q, s, out, partials, arrivals, m, K, N, splits,
                    k_split, st);
}

extern "C" const char* aiko_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
