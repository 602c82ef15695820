// Weight-only int8 matmul for decode shapes: out = (x @ q) * s, cast to bf16.
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
// Design against that bound:
//   * one CTA owns a 64-column tile of N and a slice of K: every int8 weight
//     byte is read from device memory exactly once, and splitting K over
//     CTAs keeps ~2 CTAs per SM busy even for the 1024-column K/V
//     projections (the last CTA of a tile sums the slices' f32 partials in
//     a fixed order, so results do not depend on timing or on m);
//   * weight and x tiles stream through a shared-memory ring with 16-byte
//     cp.async copies, several stages in flight;
//   * the product runs on the tensor cores: mma.sync m16n8k16 with the
//     weight tile as operand A (64 columns x 16 k per step) and x as
//     operand B (8 rows of x per mma); int8 -> bf16 is exact, so each weight
//     byte costs one convert and the MMA accumulates in f32, as the TPU
//     kernel does (f32 accumulate, scale per column in the epilogue, one
//     rounding to bf16);
//   * rows of both tiles are padded so the fragment loads are
//     bank-conflict free.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps: 2 column halves x 4 k steps
constexpr int kNT = 64;         // output columns per CTA
constexpr int kKC = 64;         // K rows per stage (4 mma k-steps)
constexpr int kWLd = 80;        // padded weight row, bytes (64 + 16)
constexpr int kXLd = kKC * 2 + 16;  // padded x row, bytes

// Byte `byte` of two weight words (k rows k and k+1) as a bf16x2 pair;
// int8 values are exact in bf16.
__device__ __forceinline__ unsigned pack_bf16(int word_lo, int word_hi,
                                              int byte) {
  return aiko::pack_bf16x2(
      static_cast<float>(static_cast<signed char>(word_lo >> (8 * byte))),
      static_cast<float>(static_cast<signed char>(word_hi >> (8 * byte))));
}

// MR: rows of x per CTA (a multiple of 8, <= 64).
template <int MR>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ s,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ partials,
                       int* __restrict__ arrivals, int m, int K, int N,
                       int k_split) {
  constexpr int kMT = MR / 8;                  // mma n-tiles over x rows
  constexpr int kStages = MR == 64 ? 3 : 4;   // within 48 KiB static
  constexpr int kWBytes = kKC * kWLd;
  constexpr int kStageBytes = kWBytes + MR * kXLd;
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
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int k_begin = split * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int nk = (k_end - k_begin + kKC - 1) / kKC;

  auto load_stage = [&](int stage, int k0) {
    unsigned char* ws = smem + stage * kStageBytes;
    unsigned char* xs = ws + kWBytes;
    {  // weights: 64 rows x 64 bytes = 256 chunks, one a thread
      const int row = tid / 4, chunk = tid % 4;
      const int k = k0 + row;
      const bool ok = k < k_end;
      aiko::cp_async16(ws + row * kWLd + chunk * 16,
                       q + (size_t)(ok ? k : 0) * N + n0 + chunk * 16, ok);
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

  float acc[2][kMT][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][mt][i] = 0.f;

  for (int it = 0; it < nk; ++it) {
    aiko::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pre = it + kStages - 1;
    if (pre < nk) load_stage(pre % kStages, k_begin + pre * kKC);
    aiko::cp_async_commit();

    const unsigned char* ws = smem + (it % kStages) * kStageBytes;
    const unsigned char* xs = ws + kWBytes;
    const int kr = kstep * 16 + 2 * c;       // this thread's k rows
    const unsigned char* wcol = ws + half * 32 + 4 * g;
    const int w0 = *reinterpret_cast<const int*>(wcol + kr * kWLd);
    const int w1 = *reinterpret_cast<const int*>(wcol + (kr + 1) * kWLd);
    const int w8 = *reinterpret_cast<const int*>(wcol + (kr + 8) * kWLd);
    const int w9 = *reinterpret_cast<const int*>(wcol + (kr + 9) * kWLd);
    unsigned a[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      a[t][0] = pack_bf16(w0, w1, 2 * t);      // column 4g+2t,   k, k+1
      a[t][1] = pack_bf16(w0, w1, 2 * t + 1);  // column 4g+2t+1, k, k+1
      a[t][2] = pack_bf16(w8, w9, 2 * t);      // column 4g+2t,   k+8, k+9
      a[t][3] = pack_bf16(w8, w9, 2 * t + 1);  // column 4g+2t+1, k+8, k+9
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const unsigned char* xrow = xs + (mt * 8 + g) * kXLd + kr * 2;
      const unsigned b0 = *reinterpret_cast<const unsigned*>(xrow);
      const unsigned b1 = *reinterpret_cast<const unsigned*>(xrow + 16);
#pragma unroll
      for (int t = 0; t < 2; ++t)
        aiko::mma_bf16_16816(acc[t][mt], a[t][0], a[t][1], a[t][2], a[t][3],
                             b0, b1);
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
    float* mine = partials + ((size_t)blockIdx.x * splits + split) * MR * kNT;
    for (int i = tid; i < MR * kNT; i += kThreads) mine[i] = red[i];
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int arrived = atomicAdd(arrivals + blockIdx.x, 1);
      last_flag = arrived == splits - 1;
    }
    __syncthreads();
    if (!last_flag) return;
    __threadfence();
    const float* tile = partials + (size_t)blockIdx.x * splits * MR * kNT;
    for (int i = tid; i < MR * kNT; i += kThreads) {
      float sum = 0.f;
      for (int sp = 0; sp < splits; ++sp)
        sum += __ldcg(tile + (size_t)sp * MR * kNT + i);
      red[i] = sum;
    }
    if (tid == 0) arrivals[blockIdx.x] = 0;  // ready for the next launch
    __syncthreads();
  }

  for (int i = tid; i < MR * kNT; i += kThreads) {
    const int r = i / kNT, col = i % kNT;
    if (r < m)
      out[(size_t)r * N + n0 + col] = __float2bfloat16(red[i] * s[n0 + col]);
  }
}

template <int MR>
cudaError_t launch(const void* x, const void* q, const void* s, void* out,
                   void* partials, void* arrivals, int m, int K, int N,
                   int splits, int k_split, cudaStream_t stream) {
  dim3 grid(N / kNT, splits);
  int8_matmul_kernel<MR><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partials), static_cast<int*>(arrivals), m, K, N,
      k_split);
  return cudaGetLastError();
}

}  // namespace

// x (m, K) bf16 row-major, q (K, N) int8, s (N,) f32, out (m, N) bf16.
// K is cut into `splits` slices of `k_split` rows (a multiple of 64); with
// splits > 1, `partials` holds (N / 64) * splits * MR * 64 floats (MR = m
// rounded up to 8, 16, 32 or 64) and `arrivals` (N / 64) int32 zeros, which
// the kernel leaves zero.  Needs m <= 64, N % 64 == 0, K % 8 == 0 and
// 16-byte-aligned x and q.
extern "C" int aiko_int8_matmul(const void* x, const void* q, const void* s,
                                void* out, void* partials, void* arrivals,
                                int m, int K, int N, int splits, int k_split,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || m > 64 || N % kNT != 0 || K % 8 != 0 || splits < 1)
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
