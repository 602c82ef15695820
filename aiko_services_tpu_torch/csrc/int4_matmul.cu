// Weight-only int4 matmul for decode shapes:
//   out[m, n] = sum_g (sum_{k in g} x[m, k] * q[k, n]) * s[g, n], cast to bf16.
//
// Replaces: aiko_services_tpu/ops/quant.py::int4_matmul (pallas_call at
// quant.py:330), both of its Pallas kernels: `_int4_kernel` (quant.py:244,
// per-group f32 dots scaled into an f32 accumulator: this kernel's default
// numerics) and `_int4_kernel_repeat` (quant.py:195, the operand is
// bf16(q * s): the `kScaleFirst` instance), and the kernel lab's variants
// scripts/int4_kernel_lab.py `matmul_repeat` (:51, scale first) and
// `matmul_batched` (:97, scale after the group).  Taken for m <= 64, groups
// of a multiple of 64 rows and N % 64 == 0 (ops/quant.py int4_kernel_shape
// keeps the JAX dispatch rule on top of that).
//
// Bound on the H100: at m <= 64 the call must stream the packed K/2 x N
// weight once plus the G x N f32 scales (4 bytes per 128 weights); its
// 2*m*K*N operations stay below the tensor-core line for m <= 64 (at
// m = 64 only just), so the bound is bytes.
//
// Design against that bound (the streaming structure, shared with
// int8_matmul.cu, is weight_stream.cuh):
//   * one CTA owns a 256-column tile of N and a slice of K: every packed
//     byte is read from device memory once, 256 contiguous bytes of each
//     packed row at a time.  K is split so that the tile x slice CTAs fill
//     the card in one wave at three CTAs an SM (ops/quant.py
//     _k_split), and the last CTA of a tile sums the slices' f32
//     partials in slice order (deterministic, and the same for every m),
//     each thread's elements in registers with several slices' loads in
//     flight at once: a sum that waits on each load in turn made the
//     merge most of an m = 64 call;
//   * bytes in flight: packed weights, the stage's group scales and x
//     stream through a ring of 64-row stages (8 KB of packed weight a
//     stage) in dynamic shared memory, as many stages as leave room for
//     three CTAs an SM at MR <= 8 (6 stages), two at MR <= 32 and one at
//     MR = 64 (8 stages), all but one in flight.  The weight of a stage is
//     two 2-d TMA boxes (the SM's copy engine, one request each, counted
//     on the stage's mbarrier), the scales one bulk copy, x cp.async
//     copies; 16-byte cp.async copies of the weight held the earlier
//     64-column kernel near 1 TB/s even with the conversion taken out (the
//     kernel lab's `floor` variant).  One CTA barrier a stage frees its slot.
//     Each of the 8 warps owns 32 columns and every K row of the slice, so
//     no warp waits on another's sums and every x row staged is read by
//     all 8 warps;
//   * the product runs on the tensor cores, mma.sync m16n8k16, the weight
//     tile as operand A and x as operand B.  The nibbles become bf16 with
//     integer ops only, clear of the conversion unit: a byte permute pairs
//     the same column's bytes of packed rows r and r + 4, a shift and a
//     LOP3 put one nibble in each 16-bit lane as 0x4300 | (nibble ^ 8),
//     which is the bf16 of 136 + nibble, and one bf16x2 fma of -136 leaves
//     the nibble (exact).  An A register so holds k rows (2r, 2r + 8) or
//     (2r + 1, 2r + 9) of one column; x's B fragment takes the same k
//     order by one byte permute of its two natural words;
//   * scale after the group: the mma accumulates a group's f32 partial,
//     which folds into the f32 accumulator times s[g, n] when the group (or
//     the K slice) ends, so the result equals the plain version's up to
//     the order of summation.  kScaleFirst instead feeds bf16(q * s) to the
//     mma, as the TPU repeat kernel does (that rounding goes through the
//     conversion unit, as its numerics require);
//   * the weight boxes land 128-byte swizzled (a packed row's 16-byte
//     chunk c at c ^ (row % 8)) and x rows are padded by 16 bytes, so a
//     warp's fragment loads spread over the banks.
//
// The m-tiled instance (`aiko_int4_matmul_tiled`, every m > 64 slice of a
// prefill) is the MR = 64 scale-after kernel on a third grid axis: CTA
// (x, y, z) owns columns 256x.., K slice y and rows 64z..64z+63, and runs
// for its rows exactly what the m <= 64 instance runs, so no weight is
// ever rounded (the JAX package's f32 grouped einsum, quant.py:319-327).
// Its bound is operations from m ~ 300 on (2*m*K*N against K*N/2 bytes);
// at prefill sizes m/64 x N/256 CTAs fill the 132 SMs, so K is split only
// where that grid is small.  Each m tile re-reads the packed weight,
// mostly from the 50 MB L2.
#include "weight_stream.cuh"

namespace {

using namespace aiko::wstream;
using aiko::mbar_expect_tx;
using aiko::smem_u32;

constexpr int kPR = kKC / 2;         // packed rows per stage
constexpr int kBoxBytes = kPR * kBoxCols;  // a box: kPR packed rows
constexpr int kWBytes = kNT / kBoxCols * kBoxBytes;
constexpr int kSBytes = kNT * 4;     // the stage's group scales, f32

// CTAs an SM of an MR-row instance (what its registers allow), and its
// ring (weight_stream.cuh).
__host__ __device__ constexpr int ctas_per_sm(int mr) {
  return mr <= 8 ? 3 : mr <= 32 ? 2 : 1;
}
template <int MR>
using RingOf =
    Ring<kWBytes + kSBytes + MR * kXLd, ctas_per_sm(MR), MR * kNT * 4>;

constexpr unsigned kMagic = 0x43084308u;    // bf16 136 in both lanes
constexpr unsigned kOne = 0x3F803F80u;      // bf16 1
constexpr unsigned kMinus136 = 0xC308C308u; // bf16 -136

__device__ __forceinline__ unsigned bf16x2_fma(unsigned a, unsigned b,
                                               unsigned c) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The signed nibbles at bits 0-3 and 16-19 of v as an exact bf16x2 (low
// lane first): 0x4300 | (nibble ^ 8) is the bf16 of 136 + nibble.
__device__ __forceinline__ unsigned nibbles_to_bf16x2(unsigned v) {
  return bf16x2_fma((v & 0x000f000fu) ^ kMagic, kOne, kMinus136);
}

// This thread's 16 weights of one k step as the A fragments of its two m
// tiles: w0 and w4 are packed rows r and r + 4 (k rows 2r, 2r + 1 and
// 2r + 8, 2r + 9), columns 4g..4g+3 of the warp's 32, one byte each.
// m tile t holds columns 4g + 2t (A row g) and 4g + 2t + 1 (row g + 8);
// k position 2c <- k row 2r, 2c + 1 <- 2r + 8, 2c + 8 <- 2r + 1,
// 2c + 9 <- 2r + 9.
template <bool kScaleFirst>
__device__ __forceinline__ void dequant(unsigned w0, unsigned w4,
                                        const float (&sc)[4],
                                        unsigned (&a)[2][4]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    // [w0 byte 2t, w0 byte 2t+1, w4 byte 2t, w4 byte 2t+1]
    const unsigned p = __byte_perm(w0, w4, t == 0 ? 0x5410 : 0x7632);
    const unsigned lo0 = nibbles_to_bf16x2(p), hi0 = nibbles_to_bf16x2(p >> 4);
    const unsigned lo1 = nibbles_to_bf16x2(p >> 8);
    const unsigned hi1 = nibbles_to_bf16x2(p >> 12);
    if constexpr (kScaleFirst) {
      // bf16(q * s): the column's scale, rounded once (conversion unit).
      auto scaled = [](unsigned r, float f) {
        return aiko::pack_bf16x2(__uint_as_float(r << 16) * f,
                                 __uint_as_float(r & 0xffff0000u) * f);
      };
      a[t][0] = scaled(lo0, sc[2 * t]);
      a[t][1] = scaled(lo1, sc[2 * t + 1]);
      a[t][2] = scaled(hi0, sc[2 * t]);
      a[t][3] = scaled(hi1, sc[2 * t + 1]);
    } else {
      a[t][0] = lo0;
      a[t][1] = lo1;
      a[t][2] = hi0;
      a[t][3] = hi1;
    }
  }
}

// MR: rows of x per CTA (a multiple of 8, <= 64).
template <int MR, bool kScaleFirst>
__global__ void __launch_bounds__(kThreads, ctas_per_sm(MR))
    int4_matmul_kernel(const __grid_constant__ CUtensorMap w_map,
                       const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ s,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ partials,
                       int* __restrict__ arrivals, int m, int K, int N,
                       int group, int k_split) {
  using R = RingOf<MR>;
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
  // This warp's columns n0 + 32 * warp ..; past N (a multiple of 64) in
  // the last tile of an N that is not a multiple of 256.
  const bool warp_live = n0 + 32 * warp < N;
  // The m tile (blockIdx.z > 0 only in the tiled instance): this CTA's
  // rows of x and out, and its split-K tile index.
  const int row0 = blockIdx.z * MR;
  x += (size_t)row0 * K;
  out += (size_t)row0 * N;
  m = min(MR, m - row0);
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int k_begin = split * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int nk = (k_end - k_begin + kKC - 1) / kKC;

  // One stage: the packed weight as two TMA boxes of 32 rows x 128
  // columns (a box wholly past N is not issued) and the group's scales as
  // one bulk copy, issued by thread 0 and counted on the stage's
  // mbarrier, and x's rows by cp.async.  A stage lies in one group and in
  // the slice (k_split and K are multiples of 64).
  const int cols = min(kNT, N - n0);
  const int boxes = (cols + kBoxCols - 1) / kBoxCols;
  const unsigned stage_tx = boxes * kBoxBytes + cols * 4;
  auto load = [&](int slot, int i) {
    const int k0 = k_begin + i * kKC;
    const uint32_t ws = base + slot * kStageBytes;
    if (tid == 0) {
      mbar_expect_tx(&full[slot], stage_tx);
      for (int bx = 0; bx < boxes; ++bx)
        tma_load_2d(ws + bx * kBoxBytes, &w_map, &full[slot],
                    n0 + bx * kBoxCols, k0 / 2);
      bulk_copy(ws + kWBytes, s + (size_t)(k0 / group) * N + n0, cols * 4,
                &full[slot]);
    }
    stage_x<MR>(smem + slot * kStageBytes + kWBytes + kSBytes, x, m, K, k0,
                k_end);
  };

  float acc[2][kMT][4];    // f32 result (scaled)
  float part[2][kMT][4];   // the current group's unscaled partial
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][mt][i] = part[t][mt][i] = 0.f;

  // This thread's weight bytes: columns 32 * warp + 4g .. + 3 of the tile,
  // in box warp / 4, 16-byte chunk 2 (warp % 4) + g / 4 of a packed row
  // (stored at chunk ^ (row % 8): the 128-byte swizzle), bytes 4 (g % 4)..
  const int chunk = (32 * (warp % 4) + 4 * g) / 16;
  const int in_chunk = (4 * g) % 16;
  auto compute = [&](int slot, int it) {
    if (!warp_live) return;
    const unsigned char* ws = smem + slot * kStageBytes;
    const float* ss = reinterpret_cast<const float*>(ws + kWBytes);
    const unsigned char* xs = ws + kWBytes + kSBytes;
    // This thread's 4 columns' scales of the stage's group.
    const float4 sc4 =
        *reinterpret_cast<const float4*>(ss + 32 * warp + 4 * g);
    const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
    const unsigned char* wbox = ws + (warp / 4) * kBoxBytes + in_chunk;
#pragma unroll
    for (int step = 0; step < kKC / 16; ++step) {
      // Packed rows r = 8 * step + c and r + 4 of the stage.
      const int pr = 8 * step + c;
      const unsigned w0 = *reinterpret_cast<const unsigned*>(
          wbox + pr * kBoxCols + ((chunk ^ (pr & 7)) << 4));
      const unsigned w4 = *reinterpret_cast<const unsigned*>(
          wbox + (pr + 4) * kBoxCols + ((chunk ^ ((pr + 4) & 7)) << 4));
      unsigned a[2][4];
      dequant<kScaleFirst>(w0, w4, sc, a);
      const int kx = 16 * step + 2 * c;   // k in the stage
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const unsigned char* xrow = xs + (mt * 8 + g) * kXLd + kx * 2;
        const unsigned xa = *reinterpret_cast<const unsigned*>(xrow);
        const unsigned xb = *reinterpret_cast<const unsigned*>(xrow + 16);
        // B in the A fragments' k order: (2c, 2c + 8) and (2c + 1, 2c + 9).
        const unsigned b0 = __byte_perm(xa, xb, 0x5410);
        const unsigned b1 = __byte_perm(xa, xb, 0x7632);
#pragma unroll
        for (int t = 0; t < 2; ++t)
          aiko::mma_bf16_16816(kScaleFirst ? acc[t][mt] : part[t][mt],
                               a[t][0], a[t][1], a[t][2], a[t][3], b0, b1);
      }
    }
    if (!kScaleFirst) {
      // Fold the group's partial when the group or the slice ends (the
      // condition is the same for every thread of the CTA).
      const int next = k_begin + (it + 1) * kKC;
      if (it == nk - 1 || next % group == 0) {
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[t][mt][i] += part[t][mt][i] * sc[2 * t + (i >> 1)];
              part[t][mt][i] = 0.f;
            }
      }
    }
  };
  init_ring(full, kStages);
  run_ring<kStages>(full, nk, load, compute);

  // The tile's result red[MR][kNT] (f32), each warp its own columns.
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

  // The merge's loads in flight: 32 registers below MR = 64 (their
  // register caps), 128 at MR = 64 (one CTA an SM).
  if (splits > 1) {
    if (!merge_slices<MR, MR == 64 ? 32 : 8>(red, partials, arrivals, tile,
                                             split, splits))
      return;
    __syncthreads();
  }

  for (int i = tid; i < MR * kNT; i += kThreads) {
    const int r = i / kNT, col = i % kNT;
    if (r < m && n0 + col < N)
      out[(size_t)r * N + n0 + col] = __float2bfloat16(red[i]);
  }
}

template <int MR, bool kScaleFirst>
cudaError_t launch(const void* x, const void* q4, const void* s, void* out,
                   void* partials, void* arrivals, int m, int K, int N,
                   int group, int splits, int k_split, cudaStream_t stream) {
  constexpr int smem = RingOf<MR>::kSmem;
  CUtensorMap w_map;
  if (!weight_map(&w_map, q4, K / 2, N, kPR)) return cudaErrorInvalidValue;
  static std::atomic<unsigned> configured{0};
  const cudaError_t err = set_smem_once(
      configured,
      reinterpret_cast<const void*>(int4_matmul_kernel<MR, kScaleFirst>),
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kNT - 1) / kNT, splits, (m + MR - 1) / MR);
  int4_matmul_kernel<MR, kScaleFirst><<<grid, kThreads, smem, stream>>>(
      w_map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partials), static_cast<int*>(arrivals), m, K, N,
      group, k_split);
  return cudaGetLastError();
}

template <bool kScaleFirst>
cudaError_t launch_rows(const void* x, const void* q4, const void* s,
                        void* out, void* partials, void* arrivals, int m,
                        int K, int N, int group, int splits, int k_split,
                        cudaStream_t stream) {
  if (m <= 8)
    return launch<8, kScaleFirst>(x, q4, s, out, partials, arrivals, m, K, N,
                                  group, splits, k_split, stream);
  if (m <= 16)
    return launch<16, kScaleFirst>(x, q4, s, out, partials, arrivals, m, K,
                                   N, group, splits, k_split, stream);
  if (m <= 32)
    return launch<32, kScaleFirst>(x, q4, s, out, partials, arrivals, m, K,
                                   N, group, splits, k_split, stream);
  return launch<64, kScaleFirst>(x, q4, s, out, partials, arrivals, m, K, N,
                                 group, splits, k_split, stream);
}

}  // namespace

// x (m, K) bf16 row-major, q4 (K/2, N) int8 nibble-packed (low nibble row
// 2k, high nibble row 2k+1), s (K / group, N) f32, out (m, N) bf16.  K is
// cut into `splits` slices of `k_split` rows (a multiple of 64); with
// splits > 1, `partials` holds ceil(N / 256) * splits * MR * 256 floats
// (MR = m rounded up to 8, 16, 32 or 64) and `arrivals` ceil(N / 256)
// int32 zeros, which the kernel leaves zero.  scale_first != 0 feeds bf16(q * s) to the
// product instead of scaling each group's partial.  Needs m <= 64,
// N % 64 == 0, group % 64 == 0, K % group == 0 and 16-byte-aligned x, q4
// and s.
extern "C" int aiko_int4_matmul(const void* x, const void* q4, const void* s,
                                void* out, void* partials, void* arrivals,
                                int m, int K, int N, int group, int splits,
                                int k_split, int scale_first, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || m > 64 || N % 64 != 0 || group <= 0 || group % kKC != 0 ||
      K % group != 0 || splits < 1 || k_split % kKC != 0)
    return cudaErrorInvalidValue;
  if (scale_first)
    return launch_rows<true>(x, q4, s, out, partials, arrivals, m, K, N,
                             group, splits, k_split, st);
  return launch_rows<false>(x, q4, s, out, partials, arrivals, m, K, N,
                            group, splits, k_split, st);
}

// The m-tiled instance: any m >= 1, scale after each group, 64-row tiles
// of m on the grid's z axis (see the head of this file).  With splits > 1,
// `partials` holds ceil(N / 256) * ceil(m / 64) * splits * 64 * 256 floats
// and `arrivals` ceil(N / 256) * ceil(m / 64) int32 zeros.  Otherwise as
// aiko_int4_matmul.
extern "C" int aiko_int4_matmul_tiled(const void* x, const void* q4,
                                      const void* s, void* out,
                                      void* partials, void* arrivals, int m,
                                      int K, int N, int group, int splits,
                                      int k_split, void* stream) {
  if (m <= 0 || (m + 63) / 64 > 65535 || N % 64 != 0 || group <= 0 ||
      group % kKC != 0 || K % group != 0 || splits < 1 ||
      k_split % kKC != 0)
    return cudaErrorInvalidValue;
  return launch<64, false>(x, q4, s, out, partials, arrivals, m, K, N, group,
                           splits, k_split, static_cast<cudaStream_t>(stream));
}
