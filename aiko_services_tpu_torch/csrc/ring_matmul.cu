// The step kernels of the ring collective matmuls:
//   all-gather step:      out[row0 + i, j] = sum_k block[i, k] * w[k, j]
//   reduce-scatter step:  acc[i, j] = sum_k x[i, k] * w[k, col0 + j]  (f32)
//
// Replaces: aiko_services_tpu/parallel/rdma_collective.py
// `rdma_allgather_matmul` (pallas_call at :190, `_ag_kernel` :93-165) and
// `rdma_matmul_reducescatter` (pallas_call at :291, `_rs_kernel`
// :202-264).  The TPU kernels own the whole ring: DMA engines move the
// blocks between chips while the MXU multiplies, fenced by semaphores.
// On the card the ring's protocol lives on the host
// (parallel/rdma_collective.py): each rank has a compute and a copy
// stream, the copy engines move the slots (`copy_`, cudaMemcpyPeerAsync
// between cards) and CUDA events stand for the semaphores.  What is left
// in here is the product of one ring step on one rank; the reduce-scatter's
// running sum (acc += the step's partial, after the accumulator arrives)
// is a separate f32 add on the compute stream, so the product of the next
// owner's partial runs while the accumulator is in flight, as the TPU
// kernel computes `partial_ref` during the RDMA (:244-253).
//
// Bound on the H100: at llama3_8b's TP-4 MLP shapes (m = 2048) a call is
// 2 * m * K * N ~ 240 GFLOP over R^2 = 16 step launches: operations,
// 0.243 ms at 989 TFLOP/s.  At m = 64 the weight's bytes bound it.
//
// Design (a simple kernel first; making it fast is later work):
//   * bf16 inputs: 128 x 128 output tiles (32 x 64 for m <= 32), 8 warps
//     of mma.sync m16n8k16 with f32 accumulation, a two-stage cp.async
//     ring of 32-deep K tiles; A fragments are 32-bit shared loads of
//     row-major x, B fragments pairs of 16-bit loads down w's columns;
//   * f32 inputs: a 64 x 64 FMA tile in full f32 (TF32 would break the
//     f32 tolerances of the JAX package's tests);
//   * ragged edges are masked: rows past m and columns past n are never
//     stored, K past its end reads zeros.  Where a row, K or a column slice
//     is not a whole 16-byte chunk, or a pointer is not 16-byte aligned
//     (the JAX tests' n_local = 2, 3 or 5), the tiles are loaded element by
//     element instead of by cp.async.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;             // bf16 K tile
constexpr int kALd = kBK + 8;       // padded A row (bf16): conflict-free
constexpr int kFT = 64, kFK = 16;   // f32 tile and K tile

template <int BM, int BN>
struct Tiles {
  __nv_bfloat16 a[2][BM][kALd];     // x rows, K-major
  __nv_bfloat16 b[2][kBK][BN + 8];  // w rows, N-major
};

template <typename TOut>
__device__ __forceinline__ void store(TOut* c, int ldc, int row, int col,
                                      int M, int N, float v) {
  if (row < M && col < N)
    c[(size_t)row * ldc + col] = aiko::from_float<TOut>(v);
}

// C (M x N, ldc) = A (M x K, lda) @ B (K x N, ldb), bf16 in, f32
// accumulate, TOut out.  kVec: every A and B row chunk of 8 is 16-byte
// aligned and whole (K % 8 == 0, N % 8 == 0, lda % 8 == 0, ldb % 8 == 0).
template <int BM, int BN, bool kVec, typename TOut>
__global__ void __launch_bounds__(kThreads)
    ring_mm_bf16(const __nv_bfloat16* __restrict__ A,
                 const __nv_bfloat16* __restrict__ B, TOut* __restrict__ C,
                 int M, int N, int K, int lda, int ldb, int ldc) {
  constexpr int kWM = BM / 2, kWN = BN / 4;   // warp tile (2 x 4 warps)
  constexpr int kMT = kWM / 16, kNT = kWN / 8;
  __shared__ __align__(16) Tiles<BM, BN> sm;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int wm = (warp / 4) * kWM, wn = (warp % 4) * kWN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + kBK - 1) / kBK;

  auto load = [&](int stage, int k0) {
    if (kVec) {
      for (int i = tid; i < BM * kBK / 8; i += kThreads) {
        const int r = i / (kBK / 8), kc = (i % (kBK / 8)) * 8;
        const bool ok = m0 + r < M && k0 + kc < K;
        aiko::cp_async16(&sm.a[stage][r][kc],
                         A + (ok ? (size_t)(m0 + r) * lda + k0 + kc : 0), ok);
      }
      for (int i = tid; i < kBK * BN / 8; i += kThreads) {
        const int r = i / (BN / 8), nc = (i % (BN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + nc < N;
        aiko::cp_async16(&sm.b[stage][r][nc],
                         B + (ok ? (size_t)(k0 + r) * ldb + n0 + nc : 0), ok);
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < BM * kBK; i += kThreads) {
        const int r = i / kBK, kk = i % kBK;
        sm.a[stage][r][kk] = m0 + r < M && k0 + kk < K
                                 ? A[(size_t)(m0 + r) * lda + k0 + kk]
                                 : zero;
      }
      for (int i = tid; i < kBK * BN; i += kThreads) {
        const int r = i / BN, nn = i % BN;
        sm.b[stage][r][nn] = k0 + r < K && n0 + nn < N
                                 ? B[(size_t)(k0 + r) * ldb + n0 + nn]
                                 : zero;
      }
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load(0, 0);
  aiko::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    // The other stage was last read before the trailing barrier of the
    // previous iteration: free to refill.
    if (kt + 1 < nk) load((kt + 1) & 1, (kt + 1) * kBK);
    aiko::cp_async_commit();
    aiko::cp_async_wait<1>();
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      unsigned a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = *reinterpret_cast<const unsigned*>(&sm.a[st][r][ks + 2 * c]);
        a[i][1] =
            *reinterpret_cast<const unsigned*>(&sm.a[st][r + 8][ks + 2 * c]);
        a[i][2] =
            *reinterpret_cast<const unsigned*>(&sm.a[st][r][ks + 2 * c + 8]);
        a[i][3] = *reinterpret_cast<const unsigned*>(
            &sm.a[st][r + 8][ks + 2 * c + 8]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = wn + j * 8 + g;
        const int k = ks + 2 * c;
        b[j][0] = aiko::pack_bf16x2(__bfloat162float(sm.b[st][k][n]),
                                    __bfloat162float(sm.b[st][k + 1][n]));
        b[j][1] = aiko::pack_bf16x2(__bfloat162float(sm.b[st][k + 8][n]),
                                    __bfloat162float(sm.b[st][k + 9][n]));
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          aiko::mma_bf16_16816(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3],
                               b[j][0], b[j][1]);
    }
    __syncthreads();
  }
  aiko::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int row = m0 + wm + i * 16 + g;
      const int col = n0 + wn + j * 8 + 2 * c;
      store(C, ldc, row, col, M, N, acc[i][j][0]);
      store(C, ldc, row, col + 1, M, N, acc[i][j][1]);
      store(C, ldc, row + 8, col, M, N, acc[i][j][2]);
      store(C, ldc, row + 8, col + 1, M, N, acc[i][j][3]);
    }
}

// The f32 path: C = A @ B in full f32 FMAs, 64 x 64 tiles, each thread
// 4 x 4 outputs strided by 16 (coalesced loads and stores).
__global__ void __launch_bounds__(kThreads)
    ring_mm_f32(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ C, int M, int N, int K, int lda, int ldb,
                int ldc) {
  __shared__ float as[kFK][kFT + 4];   // A tile, K-major: as[k][m]
  __shared__ float bs[kFK][kFT + 4];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * kFT, n0 = blockIdx.x * kFT;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int i = tid; i < kFT * kFK; i += kThreads) {
      const int r = i / kFK, kk = i % kFK;
      as[kk][r] = m0 + r < M && k0 + kk < K
                      ? A[(size_t)(m0 + r) * lda + k0 + kk]
                      : 0.f;
      const int br = i / kFT, bn = i % kFT;
      bs[br][bn] = k0 + br < K && n0 + bn < N
                       ? B[(size_t)(k0 + br) * ldb + n0 + bn]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store(C, ldc, m0 + ty + 16 * i, n0 + tx + 16 * j, M, N, acc[i][j]);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int BM, int BN, typename TOut>
cudaError_t launch_bf16(const __nv_bfloat16* A, const __nv_bfloat16* B,
                        TOut* C, int M, int N, int K, int lda, int ldb,
                        int ldc, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool vec = aligned16(A) && aligned16(B) && K % 8 == 0 &&
                   N % 8 == 0 && lda % 8 == 0 && ldb % 8 == 0;
  if (vec)
    ring_mm_bf16<BM, BN, true, TOut>
        <<<grid, kThreads, 0, stream>>>(A, B, C, M, N, K, lda, ldb, ldc);
  else
    ring_mm_bf16<BM, BN, false, TOut>
        <<<grid, kThreads, 0, stream>>>(A, B, C, M, N, K, lda, ldb, ldc);
  return cudaGetLastError();
}

// C = A @ B: inputs of type `dtype` (AIKO_F32 or AIKO_BF16), C f32 when
// out_f32, else of the inputs' type.
cudaError_t matmul(const void* A, const void* B, void* C, int M, int N,
                   int K, int lda, int ldb, int ldc, int dtype, bool out_f32,
                   cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M > 65535 * 64)  // grid.y limit
    return cudaErrorInvalidValue;
  if (dtype == AIKO_F32) {
    const dim3 grid((N + kFT - 1) / kFT, (M + kFT - 1) / kFT);
    ring_mm_f32<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<float*>(C), M, N, K, lda, ldb, ldc);
    return cudaGetLastError();
  }
  if (dtype != AIKO_BF16) return cudaErrorInvalidValue;
  const auto* a = static_cast<const __nv_bfloat16*>(A);
  const auto* b = static_cast<const __nv_bfloat16*>(B);
  if (out_f32) {
    if (M <= 32)
      return launch_bf16<32, 64>(a, b, static_cast<float*>(C), M, N, K, lda,
                                 ldb, ldc, stream);
    return launch_bf16<128, 128>(a, b, static_cast<float*>(C), M, N, K, lda,
                                 ldb, ldc, stream);
  }
  auto* out = static_cast<__nv_bfloat16*>(C);
  if (M <= 32)
    return launch_bf16<32, 64>(a, b, out, M, N, K, lda, ldb, ldc, stream);
  return launch_bf16<128, 128>(a, b, out, M, N, K, lda, ldb, ldc, stream);
}

}  // namespace

// One all-gather ring step on one rank: block (m_local, k) @ w (k, n_local)
// into rows out_row0 .. out_row0 + m_local - 1 of out (., n_local), f32
// accumulation, stored in the inputs' type (`dtype`: AIKO_F32 or
// AIKO_BF16).  All row-major and contiguous.
extern "C" int aiko_ring_ag_step(const void* block, const void* w, void* out,
                                 int m_local, int k, int n_local,
                                 int out_row0, int dtype, void* stream) {
  const size_t elem = dtype == AIKO_F32 ? 4 : 2;
  const size_t out_offset = (size_t)out_row0 * n_local;
  return matmul(block, w, static_cast<char*>(out) + out_offset * elem,
                m_local, n_local, k, k, n_local, n_local, dtype, false,
                static_cast<cudaStream_t>(stream));
}

// One reduce-scatter ring step on one rank: the partial of the owner whose
// columns start at col0, acc (m, n_local) f32 = x (m, k_local) @
// w[:, col0 : col0 + n_local] of w (k_local, n).  All row-major and
// contiguous.
extern "C" int aiko_ring_rs_step(const void* x, const void* w, void* acc,
                                 int m, int k_local, int n, int n_local,
                                 int col0, int dtype, void* stream) {
  if (col0 < 0 || col0 + n_local > n) return cudaErrorInvalidValue;
  const size_t elem = dtype == AIKO_F32 ? 4 : 2;
  return matmul(x, static_cast<const char*>(w) + (size_t)col0 * elem, acc, m,
                n_local, k_local, k_local, n, n_local, dtype, true,
                static_cast<cudaStream_t>(stream));
}
