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
// Design against that bound (the int8 kernel's, csrc/int8_matmul.cu, with
// nibbles):
//   * one CTA owns a 64-column tile of N and a slice of K: every packed
//     byte is read from device memory once; K is split over CTAs so the
//     narrow projections still fill the card, and the last CTA of a tile
//     sums the slices' f32 partials in slice order (deterministic, and the
//     same for every m);
//   * packed weights, the stage's 64 group scales and x stream through a
//     shared-memory ring of 16-byte cp.async copies (64 K rows a stage;
//     group sizes are multiples of 64, so a stage lies in one group);
//   * the product runs on the tensor cores, mma.sync m16n8k16, the weight
//     tile as operand A and x as operand B.  No even/odd split of x (the
//     TPU kernel's two dots are Mosaic's layout, not the function's): an A
//     register holds k rows (2k', 2k'+1) of one column, which are exactly
//     the low and high nibble of packed byte q4[k', n], so one byte
//     becomes one bf16x2 register (nibbles -8..7 are exact in bf16) and x
//     is read in its own row-major order;
//   * scale after the group: the mma accumulates a group's f32 partial,
//     which folds into the f32 accumulator times s[g, n] when the group
//     (or the K slice) ends, so the result equals the plain version's up
//     to the order of summation.  kScaleFirst instead feeds bf16(q * s)
//     to the mma, as the TPU repeat kernel does;
//   * packed rows are padded to 96 bytes and x rows to 144, so every
//     fragment load of a warp hits 32 distinct banks.
//
// The m-tiled instance (`aiko_int4_matmul_tiled`, every m > 64 slice of a
// prefill) is the MR = 64 scale-after kernel on a third grid axis: CTA
// (x, y, z) owns columns 64x.., K slice y and rows 64z..64z+63, and runs
// for its rows exactly what the m <= 64 instance runs, so no weight is
// ever rounded (the JAX package's f32 grouped einsum, quant.py:319-327).
// Its bound is operations from m ~ 300 on (2*m*K*N against K*N/2 bytes);
// at prefill sizes m/64 x N/64 CTAs fill the 132 SMs, so K is split only
// where that grid is small (ops/quant.py _k_split).  Each m tile re-reads
// the packed weight, mostly from the 50 MB L2: a simple kernel first.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // 8 warps: 2 column halves x 4 k steps
constexpr int kNT = 64;              // output columns per CTA
constexpr int kKC = 64;              // K rows per stage (4 mma k-steps)
constexpr int kPR = kKC / 2;         // packed rows per stage
constexpr int kWLd = 96;             // padded packed row, bytes (64 + 32)
constexpr int kXLd = kKC * 2 + 16;   // padded x row, bytes
constexpr int kWBytes = kPR * kWLd;
constexpr int kSBytes = kNT * 4;     // the stage's group scales, f32

// The signed nibble at bit `shift` of `word` (two's complement, -8..7).
__device__ __forceinline__ float nibble(int word, int shift) {
  return static_cast<float>(
      static_cast<int>(static_cast<unsigned>(word) << (28 - shift)) >> 28);
}

// Stages of the ring: as many as fit in 48 KB of static shared memory, at
// most 8.
__host__ __device__ constexpr int ring_stages(int stage_bytes) {
  return 48000 / stage_bytes > 8 ? 8 : 48000 / stage_bytes;
}

// MR: rows of x per CTA (a multiple of 8, <= 64).
template <int MR, bool kScaleFirst>
__global__ void __launch_bounds__(kThreads)
    int4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ q4,
                       const float* __restrict__ s,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ partials,
                       int* __restrict__ arrivals, int m, int K, int N,
                       int group, int k_split) {
  constexpr int kMT = MR / 8;                  // mma n-tiles over x rows
  constexpr int kStageBytes = kWBytes + kSBytes + MR * kXLd;
  constexpr int kStages = ring_stages(kStageBytes);
  constexpr int kPipe = kStages * kStageBytes;
  constexpr int kRed = MR * kNT * 4;
  __shared__ __align__(16) unsigned char smem[kPipe > kRed ? kPipe : kRed];
  __shared__ int last_flag;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int half = warp & 1;                  // columns 32*half .. +31
  const int kstep = warp >> 1;                // k rows 16*kstep .. +15
  const int n0 = blockIdx.x * kNT;
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
  // Stages of a group, and this slice's first stage's place in its group
  // (counted from here on: no division in the loop).
  const int group_stages = group / kKC;
  int group_stage = (k_begin % group) / kKC;

  auto load_stage = [&](int stage, int k0) {
    unsigned char* ws = smem + stage * kStageBytes;
    unsigned char* ss = ws + kWBytes;
    unsigned char* xs = ss + kSBytes;
    if (tid < kPR * 4) {  // packed weights: 32 rows x 64 bytes, 128 chunks
      const int row = tid / 4, chunk = tid % 4;
      const int k = k0 + 2 * row;
      const bool ok = k < k_end;
      aiko::cp_async16(ws + row * kWLd + chunk * 16,
                       q4 + (size_t)(ok ? k / 2 : 0) * N + n0 + chunk * 16,
                       ok);
    } else if (tid < kPR * 4 + kNT / 4) {  // scales of the stage's group
      const int chunk = tid - kPR * 4;
      aiko::cp_async16(ss + chunk * 16,
                       s + (size_t)(k0 / group) * N + n0 + chunk * 4, true);
    }
    // x: MR rows x 64 bf16 = 8 chunks a row; rows past m repeat row m-1
    // (never stored), columns past the slice are zeros.
    for (int i = tid; i < MR * 8; i += kThreads) {
      const int r = i / 8, chunk = i % 8;
      const int kk = k0 + chunk * 8;
      const bool ok = kk < k_end;
      aiko::cp_async16(xs + r * kXLd + chunk * 16,
                       x + (size_t)min(r, m - 1) * K + (ok ? kk : 0), ok);
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load_stage(st, k_begin + st * kKC);
    aiko::cp_async_commit();
  }

  float acc[2][kMT][4];    // f32 result (scaled)
  float part[2][kMT][4];   // the current group's unscaled partial
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][mt][i] = part[t][mt][i] = 0.f;

  for (int it = 0; it < nk; ++it) {
    aiko::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pre = it + kStages - 1;
    if (pre < nk) load_stage(pre % kStages, k_begin + pre * kKC);
    aiko::cp_async_commit();

    const unsigned char* ws = smem + (it % kStages) * kStageBytes;
    const float* ss = reinterpret_cast<const float*>(ws + kWBytes);
    const unsigned char* xs = ws + kWBytes + kSBytes;
    // This thread's k rows are kr, kr+1 (packed row kr/2) and kr+8, kr+9
    // (packed row kr/2 + 4), kr = 16*kstep + 2c; its columns 4g..4g+3 of
    // the warp's half, one byte each.
    const int pr = kstep * 8 + c;
    const unsigned char* wcol = ws + half * 32 + 4 * g;
    const int w0 = *reinterpret_cast<const int*>(wcol + pr * kWLd);
    const int w4 = *reinterpret_cast<const int*>(wcol + (pr + 4) * kWLd);
    // This thread's 4 columns' scales of the stage's group.
    const float4 sc4 =
        *reinterpret_cast<const float4*>(ss + half * 32 + 4 * g);
    const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
    unsigned a[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 2 * t + j;   // column 4g+col, byte col of the word
        const float f = kScaleFirst ? sc[col] : 1.f;
        a[t][j] = aiko::pack_bf16x2(nibble(w0, 8 * col) * f,
                                    nibble(w0, 8 * col + 4) * f);
        a[t][j + 2] = aiko::pack_bf16x2(nibble(w4, 8 * col) * f,
                                        nibble(w4, 8 * col + 4) * f);
      }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const unsigned char* xrow =
          xs + (mt * 8 + g) * kXLd + (kstep * 16 + 2 * c) * 2;
      const unsigned b0 = *reinterpret_cast<const unsigned*>(xrow);
      const unsigned b1 = *reinterpret_cast<const unsigned*>(xrow + 16);
#pragma unroll
      for (int t = 0; t < 2; ++t)
        aiko::mma_bf16_16816(kScaleFirst ? acc[t][mt] : part[t][mt],
                             a[t][0], a[t][1], a[t][2], a[t][3], b0, b1);
    }
    if (!kScaleFirst) {
      // Fold the group's partial when the group or the slice ends (the
      // condition is the same for every thread of the CTA).
      if (++group_stage == group_stages || it == nk - 1) {
        group_stage = 0;
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
  }
  aiko::cp_async_wait<0>();
  __syncthreads();  // the ring is drained; reuse it for the reduction

  // Sum the 4 k-step warps of each column half in a fixed order into
  // red[MR][kNT] (f32), one k step after the other.
  float* red = reinterpret_cast<float*>(smem);
  for (int ks = 0; ks < 4; ++ks) {
    if (kstep == ks) {
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = half * 32 + 4 * g + 2 * t + (i >> 1);
            const int r = mt * 8 + 2 * c + (i & 1);
            float* cell = red + r * kNT + col;
            *cell = ks == 0 ? acc[t][mt][i] : *cell + acc[t][mt][i];
          }
    }
    __syncthreads();
  }

  if (splits > 1) {
    // Publish this slice's partial tile; the last CTA of the tile to
    // arrive sums all slices in slice order.
    float* mine = partials + ((size_t)tile * splits + split) * MR * kNT;
    for (int i = tid; i < MR * kNT; i += kThreads) mine[i] = red[i];
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int arrived = atomicAdd(arrivals + tile, 1);
      last_flag = arrived == splits - 1;
    }
    __syncthreads();
    if (!last_flag) return;
    __threadfence();
    const float* slices = partials + (size_t)tile * splits * MR * kNT;
    for (int i = tid; i < MR * kNT; i += kThreads) {
      float sum = 0.f;
      for (int sp = 0; sp < splits; ++sp)
        sum += __ldcg(slices + (size_t)sp * MR * kNT + i);
      red[i] = sum;
    }
    if (tid == 0) arrivals[tile] = 0;  // ready for the next launch
    __syncthreads();
  }

  for (int i = tid; i < MR * kNT; i += kThreads) {
    const int r = i / kNT, col = i % kNT;
    if (r < m) out[(size_t)r * N + n0 + col] = __float2bfloat16(red[i]);
  }
}

template <int MR, bool kScaleFirst>
cudaError_t launch(const void* x, const void* q4, const void* s, void* out,
                   void* partials, void* arrivals, int m, int K, int N,
                   int group, int splits, int k_split, cudaStream_t stream) {
  dim3 grid(N / kNT, splits, (m + MR - 1) / MR);
  int4_matmul_kernel<MR, kScaleFirst><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q4),
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
// splits > 1, `partials` holds (N / 64) * splits * MR * 64 floats (MR = m
// rounded up to 8, 16, 32 or 64) and `arrivals` (N / 64) int32 zeros, which
// the kernel leaves zero.  scale_first != 0 feeds bf16(q * s) to the
// product instead of scaling each group's partial.  Needs m <= 64,
// N % 64 == 0, group % 64 == 0, K % group == 0 and 16-byte-aligned x, q4
// and s.
extern "C" int aiko_int4_matmul(const void* x, const void* q4, const void* s,
                                void* out, void* partials, void* arrivals,
                                int m, int K, int N, int group, int splits,
                                int k_split, int scale_first, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || m > 64 || N % kNT != 0 || group <= 0 || group % kKC != 0 ||
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
// `partials` holds (N / 64) * ceil(m / 64) * splits * 64 * 64 floats and
// `arrivals` (N / 64) * ceil(m / 64) int32 zeros.  Otherwise as
// aiko_int4_matmul.
extern "C" int aiko_int4_matmul_tiled(const void* x, const void* q4,
                                      const void* s, void* out,
                                      void* partials, void* arrivals, int m,
                                      int K, int N, int group, int splits,
                                      int k_split, void* stream) {
  if (m <= 0 || (m + 63) / 64 > 65535 || N % kNT != 0 || group <= 0 ||
      group % kKC != 0 || K % group != 0 || splits < 1 ||
      k_split % kKC != 0)
    return cudaErrorInvalidValue;
  return launch<64, false>(x, q4, s, out, partials, arrivals, m, K, N, group,
                           splits, k_split, static_cast<cudaStream_t>(stream));
}
