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
// kernel computes `partial_ref` during the RDMA (:244-253).  Every path
// accumulates in f32, as the JAX kernels' `jnp.dot(...,
// preferred_element_type=jnp.float32)`.
//
// Bound on the H100: at llama3_8b's TP-4 MLP shapes (m = 2048) a call is
// 2 * m * K * N ~ 240 GFLOP over R^2 = 16 step launches: operations,
// 0.243 ms at 989 TFLOP/s.  At m = 64 the weight's bytes bound it, and the
// all-gather's schedule reads each rank's weight shard at each of its R
// steps: R^2 shard reads a call (0.140 ms at 3.35 TB/s on four ranks of
// one card at w_gate), which no kernel of a step can remove.
//
// Design: `matmul()` takes one of four paths by dtype, alignment and m.
//   * prefill (bf16, m > 64, aligned): 128 x 256 output tiles, one CTA
//     each, sized so that four ranks' grids run on one card at once (at
//     m = 2048 an all-gather step is 56 tiles a rank, 224 for four on 132
//     SMs).  One producer warp issues TMA loads (2-d boxes, 128-byte
//     swizzle) into a ring of four 48 KB stages on mbarriers: x's 128 rows
//     x 64 K (K-major) and w's 64 K rows x 256 columns as four boxes of 64
//     columns (w is row-major K x N: an N-major B operand, the transpose
//     bit of wgmma's descriptor).  The reduce-scatter's column slice of a
//     wider w is the whole w's tensor map with col0 in the box coordinates.
//     Two consumer warpgroups of 64 rows run wgmma m64n256k16 from shared
//     memory with f32 accumulators in registers, one k tile in flight, and
//     free a stage through its `empty` mbarrier once the products that read
//     it are done.  The epilogue trades accumulators between a quad's
//     lanes by shuffles so that each lane stores 16 bytes of one row: 8
//     bf16 (all-gather) or 4 f32 (reduce-scatter).  No CTA waits on another
//     (ranks on one card are not co-resident by guarantee);
//   * decode (bf16, m <= 64, aligned): the weight's bytes bound it, so w
//     streams through weight_stream.cuh's structure: a CTA owns 256
//     columns and one slice of K, w's 64-row stages arrive as four 2-d TMA
//     boxes of 64 columns (128-byte swizzled) on an mbarrier ring five
//     stages deep, x's rows by cp.async into padded rows; each warp owns 32
//     columns and takes its B fragments with ldmatrix.trans (the swizzle
//     undone in the address) and x's A fragments with ldmatrix, onto
//     mma.sync m16n8k16; at 64 rows the products run on wgmma m64n128k16
//     instead (x, 128-byte swizzled, is a warpgroup's A, w's stage its
//     N-major B; mma.sync's 64 products a warp a stage made the CTA, not
//     the memory, the limit).  K is split so that a rank's tile x slice CTAs
//     fill its share of the card (`ctas`, from the host) in one wave
//     (decode::k_split), and the last CTA of a tile sums the slices' f32 partials
//     in slice order (`merge_slices`): the same bits every call.  The
//     partials and arrival counters are the rank's own (allocated beside
//     its slots), never a scratch shared by the ranks' streams;
//   * unaligned bf16 (K, N or a row stride not a multiple of 8, or a
//     pointer not 16-byte aligned: the JAX tests' n_local of 2, 3 or 5):
//     128 x 128 tiles (32 x 64 for m <= 32) of mma.sync with tiles loaded
//     element by element, ragged edges masked;
//   * f32: a 64 x 64 FMA tile in full f32 (TF32 would break the f32
//     tolerances of the JAX package's tests).
// A shape that a TMA path takes never falls back: a tensor map that does
// not encode returns cudaErrorInvalidValue, which the wrapper raises.
#include <algorithm>
#include <type_traits>

#include "weight_stream.cuh"

namespace {

using aiko::mbar_arrive;
using aiko::mbar_expect_tx;
using aiko::mbar_init;
using aiko::mbar_wait;
using aiko::smem_u32;
using aiko::wstream::tma_load_2d;
using aiko::wstream::weight_map;

// matmul()'s paths, as aiko_ring_*_plan report them (rdma_collective.py
// STEP_PATHS).
enum Path { kPathF32 = 0, kPathMmaSync = 1, kPathStream = 2, kPathWgmma = 3 };

template <typename TOut>
__device__ __forceinline__ void store(TOut* c, int ldc, int row, int col,
                                      int M, int N, float v) {
  if (row < M && col < N)
    c[(size_t)row * ldc + col] = aiko::from_float<TOut>(v);
}

// ---- the prefill path: TMA + wgmma ----
namespace prefill {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kConsumers = 256;               // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr int kABytes = kBM * kBK * 2;        // x: one box of 128 rows
constexpr int kBoxBytes = kBK * 128;          // w: 64 k rows x 64 columns
constexpr int kBBytes = kBN / 64 * kBoxBytes;
constexpr int kStageBytes = kABytes + kBBytes;   // 48 KB
constexpr int kSmem = kStages * kStageBytes + 1024;  // + swizzle alignment

// d (64 x 256, f32) += A (64 x 16 bf16, K-major in shared memory) * B
// (16 x 256 bf16, N-major in shared memory: the descriptor's transpose).
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
        "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
        "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
    ring_wgmma(const __grid_constant__ CUtensorMap a_map,
               const __grid_constant__ CUtensorMap b_map,
               TOut* __restrict__ C, int M, int N, int K, int ldc,
               int col0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t base = smem_u32(aiko::wstream::ring_base(smem_raw));
  auto a_stage = [&](int st) { return base + st * kStageBytes; };
  auto b_stage = [&](int st) { return base + st * kStageBytes + kABytes; };
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers / 32);   // a warp's lane 0 each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    if (tid == kConsumers) {
      // w's boxes that hold a stored column (rows past K and columns past
      // the map land as zeros and count in full).
      const int boxes = (min(kBN, N - n0) + 63) / 64;
      for (int it = 0; it < nk; ++it) {
        const int st = it % kStages;
        const int k0 = it * kBK;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], kABytes + boxes * kBoxBytes);
        tma_load_2d(a_stage(st), &a_map, &full[st], 2 * k0, m0);
        for (int j = 0; j < boxes; ++j)
          tma_load_2d(b_stage(st) + j * kBoxBytes, &b_map, &full[st],
                      2 * (col0 + n0 + 64 * j), k0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63 ----
  const int wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int st = it % kStages;
    mbar_wait(&full[st], (it / kStages) & 1);
    aiko::fence_operands(acc);
    aiko::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      // x: 32 bytes a k step into the warpgroup's swizzled rows; w: 16 k
      // rows a k step, its 64-column boxes kBoxBytes apart along N.
      wgmma_n256(acc,
                 aiko::make_desc(a_stage(st) + wg * 64 * 128 + 32 * kk, 16,
                                 1024, 1),
                 aiko::make_desc(b_stage(st) + kk * 16 * 128, kBoxBytes,
                                 1024, 1));
    aiko::wgmma_commit();
    aiko::wgmma_wait<1>();   // the previous stage's products are done
    aiko::fence_operands(acc);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
  }
  aiko::wgmma_wait<0>();
  aiko::fence_operands(acc);

  // Epilogue.  acc[4j + e] is row 16 warp + g + 8 (e >> 1), column 8j + 2c
  // + (e & 1) of the warpgroup's 64 x 256 (g = lane / 4, c = lane % 4).
  const int g = lane / 4, c = lane % 4;
  const int row_a = m0 + 64 * wg + 16 * warp + g, row_b = row_a + 8;
  if constexpr (std::is_same<TOut, float>::value) {
    // Lanes c and c ^ 1 trade one row's pair: even c stores row_a's
    // columns 8j + 2c .. + 3, odd c row_b's 8j + 2c - 2 .. + 3.
    const bool odd = c & 1;
    const int row = odd ? row_b : row_a;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float r0 =
          __shfl_xor_sync(0xffffffffu, odd ? acc[4 * j] : acc[4 * j + 2], 1);
      const float r1 = __shfl_xor_sync(
          0xffffffffu, odd ? acc[4 * j + 1] : acc[4 * j + 3], 1);
      const float4 v =
          odd ? make_float4(r0, r1, acc[4 * j + 2], acc[4 * j + 3])
              : make_float4(acc[4 * j], acc[4 * j + 1], r0, r1);
      const int col = n0 + 8 * j + 2 * (c & 2);
      if (row < M && col < N)
        *reinterpret_cast<float4*>(C + (size_t)row * ldc + col) = v;
    }
  } else {
    // Two column groups j, j + 1 at a time: slab s (0: row_a, j; 1: row_b,
    // j; 2: row_a, j + 1; 3: row_b, j + 1) is 8 bf16, four words, and
    // lane c holds word c of every slab.  A 4 x 4 transpose over the quad
    // (shuffles at distance 1, then 2) gives lane c all of slab c.
    const int b = c & 1, h = c >> 1;
    const int row = b ? row_b : row_a;
#pragma unroll
    for (int j = 0; j < kBN / 8; j += 2) {
      const unsigned x0 = aiko::pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
      const unsigned x1 = aiko::pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
      const unsigned x2 = aiko::pack_bf16x2(acc[4 * j + 4], acc[4 * j + 5]);
      const unsigned x3 = aiko::pack_bf16x2(acc[4 * j + 6], acc[4 * j + 7]);
      // Keep slabs b and b | 2, trade the other two with lane c ^ 1.
      const unsigned r0 = __shfl_xor_sync(0xffffffffu, b ? x0 : x1, 1);
      const unsigned r1 = __shfl_xor_sync(0xffffffffu, b ? x2 : x3, 1);
      const unsigned k0 = b ? x1 : x0, k1 = b ? x3 : x2;
      // Words c & 2 and (c & 2) + 1 of slab b (lo, hi) and of slab b | 2.
      const unsigned lo0 = b ? r0 : k0, hi0 = b ? k0 : r0;
      const unsigned lo2 = b ? r1 : k1, hi2 = b ? k1 : r1;
      // Keep slab c = b + 2h, trade the other with lane c ^ 2.
      const unsigned q0 = __shfl_xor_sync(0xffffffffu, h ? lo0 : lo2, 2);
      const unsigned q1 = __shfl_xor_sync(0xffffffffu, h ? hi0 : hi2, 2);
      const uint4 v = h ? make_uint4(q0, q1, lo2, hi2)
                        : make_uint4(lo0, hi0, q0, q1);
      const int col = n0 + 8 * (j + h);
      if (row < M && col < N)
        *reinterpret_cast<uint4*>(C + (size_t)row * ldc + col) = v;
    }
  }
}

template <typename TOut>
cudaError_t launch(const void* A, const void* B, TOut* C, int M, int N,
                   int K, int ldb, int ldc, int col0, cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  if (!weight_map(&a_map, A, M, 2LL * K, kBM) ||
      !weight_map(&b_map, B, K, 2LL * ldb, kBK))
    return cudaErrorInvalidValue;
  static std::atomic<unsigned> configured{0};
  const cudaError_t err = aiko::wstream::set_smem_once(
      configured, reinterpret_cast<const void*>(ring_wgmma<TOut>), kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  ring_wgmma<TOut><<<grid, kThreads, kSmem, stream>>>(a_map, b_map, C, M, N,
                                                      K, ldc, col0);
  return cudaGetLastError();
}

}  // namespace prefill

// ---- the decode path: the weight streamed, K split ----
namespace decode {

using aiko::wstream::kKC;         // K rows a stage
using aiko::wstream::kNT;         // output columns a CTA
using aiko::wstream::kThreads;    // 8 warps of 32 columns
using aiko::wstream::kXLd;        // x's padded row, bytes
constexpr int kBoxBytes = kKC * 128;           // 64 k rows x 64 columns
constexpr int kWBytes = kNT / 64 * kBoxBytes;  // a stage's w: 32 KB
// The product of an MR-row instance: wgmma at 64 rows (x is one
// warpgroup's A operand), mma.sync below.
__host__ __device__ constexpr bool uses_wgmma(int mr) { return mr == 64; }
// x's row in a stage: padded for ldmatrix, 128-byte swizzled for wgmma.
__host__ __device__ constexpr int x_row_bytes(int mr) {
  return uses_wgmma(mr) ? kKC * 2 : kXLd;
}
// One CTA an SM: a ring five stages deep.
template <int MR>
using RingOf =
    aiko::wstream::Ring<kWBytes + MR * x_row_bytes(MR), 1, MR * kNT * 4>;
constexpr int kMergeLoads = 16;

// d (64 x 128, f32) += A (64 x 16 bf16, K-major in shared memory) * B
// (16 x 128 bf16, N-major in shared memory: the descriptor's transpose).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// MR: rows of x a CTA (16, 32 or 64).
template <int MR, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
    ring_stream(const __grid_constant__ CUtensorMap w_map,
                const __nv_bfloat16* __restrict__ x, TOut* __restrict__ C,
                float* __restrict__ partials, int* __restrict__ arrivals,
                int m, int K, int N, int ldc, int col0, int k_split) {
  using R = RingOf<MR>;
  constexpr bool kWgmma = uses_wgmma(MR);
  constexpr int kMT = MR / 16;
  constexpr int kStages = R::kStages;
  constexpr int kStageBytes = R::kStageBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  unsigned char* smem = aiko::wstream::ring_base(smem_raw);
  const uint32_t base = smem_u32(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int n0 = blockIdx.x * kNT;
  const bool warp_live = n0 + 32 * warp < N;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int k_begin = split * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int nk = (k_end - k_begin + kKC - 1) / kKC;

  // A stage: w's 64 rows as the boxes that hold a stored column, issued
  // by thread 0 and counted on the stage's mbarrier, and x's rows (zeros
  // past m and past the slice's k_end) by cp.async.
  const int boxes = (min(kNT, N - n0) + 63) / 64;
  auto load = [&](int slot, int i) {
    const int k0 = k_begin + i * kKC;
    if (tid == 0) {
      mbar_expect_tx(&full[slot], boxes * kBoxBytes);
      for (int bx = 0; bx < boxes; ++bx)
        tma_load_2d(base + slot * kStageBytes + bx * kBoxBytes, &w_map,
                    &full[slot], 2 * (col0 + n0 + 64 * bx), k0);
    }
    aiko::wstream::stage_x<MR, kWgmma>(smem + slot * kStageBytes + kWBytes,
                                       x, m, K, k0, k_end);
  };

  float acc[kMT][4][4];   // mma.sync
  float wacc[64];         // wgmma
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) wacc[i] = 0.f;

  // This lane's ldmatrix rows: matrix mat = lane / 8, its row lane % 8.
  // B (x4.trans, two a k step): k rows 8 (mat & 1).. of the step, the
  // warp's 16-byte chunk 4 (warp % 2) + (mat >> 1) (+ 2 for the second),
  // at chunk ^ (row % 8) (the 128-byte swizzle; row % 8 = lane % 8).
  // A (x4, one an m tile): rows 8 (mat & 1).., k 8 (mat >> 1)...
  const int mat = lane / 8, r8 = lane % 8;
  const int b_row = 8 * (mat & 1) + r8;
  const int b_chunk = 4 * (warp % 2) + (mat >> 1);
  const int a_row = 8 * (mat & 1) + r8, a_col = 8 * (mat >> 1);
  auto compute = [&](int slot, int) {
    if constexpr (kWgmma) {
      // Every warp computes (a wait in a branch would serialise every
      // wgmma): warpgroup wg owns columns 128 wg.. (boxes 2 wg, 2 wg + 1);
      // x's rows are its A.  A stage's products are done before the ring
      // frees its slot.
      const uint32_t stage = base + slot * kStageBytes;
      aiko::fence_operands(wacc);
      aiko::wgmma_fence();
#pragma unroll
      for (int step = 0; step < kKC / 16; ++step)
        wgmma_n128(wacc,
                   aiko::make_desc(stage + kWBytes + 32 * step, 16, 1024, 1),
                   aiko::make_desc(stage + 2 * (warp / 4) * kBoxBytes +
                                       step * 16 * 128,
                                   kBoxBytes, 1024, 1));
      aiko::wgmma_commit();
      aiko::wgmma_wait<0>();
      aiko::fence_operands(wacc);
      return;
    }
    if (!warp_live) return;
    const unsigned char* ws = smem + slot * kStageBytes;
    const unsigned char* wbox = ws + (warp / 2) * kBoxBytes;
    const unsigned char* xs = ws + kWBytes;
#pragma unroll
    for (int step = 0; step < kKC / 16; ++step) {
      // b[p]: b0, b1 of n tile 2p, then of n tile 2p + 1.
      unsigned b[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p)
        aiko::ldmatrix_x4(b[p],
                          wbox + (16 * step + b_row) * 128 +
                              (((b_chunk + 2 * p) ^ r8) << 4),
                          true);
      unsigned a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        aiko::ldmatrix_x4(
            a[mt], xs + (16 * mt + a_row) * kXLd + (16 * step + a_col) * 2,
            false);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          aiko::mma_bf16_16816(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2],
                               a[mt][3], b[nt >> 1][2 * (nt & 1)],
                               b[nt >> 1][2 * (nt & 1) + 1]);
    }
  };
  aiko::wstream::init_ring(full, kStages);
  aiko::wstream::run_ring<kStages, kWgmma>(full, nk, load, compute);

  // The slice's f32 sums red[MR][kNT] in the drained ring.  mma.sync:
  // acc[mt][nt][e] is row 16 mt + g + 8 (e >> 1), column 32 warp + 8 nt +
  // 2c + (e & 1); wgmma: wacc[4j + e] is row 16 (warp % 4) + g + 8 (e >> 1),
  // column 128 (warp / 4) + 8j + 2c + (e & 1).
  float* red = reinterpret_cast<float*>(smem);
  if constexpr (kWgmma) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(16 * (warp % 4) + g + 8 * (e >> 1)) * kNT + 128 * (warp / 4) +
            8 * j + 2 * c + (e & 1)] = wacc[4 * j + e];
  } else {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(16 * mt + g + 8 * (e >> 1)) * kNT + 32 * warp + 8 * nt +
              2 * c + (e & 1)] = acc[mt][nt][e];
  }
  __syncthreads();
  if (splits > 1 &&
      !aiko::wstream::merge_slices<MR, kMergeLoads>(
          red, partials, arrivals, blockIdx.x, split, splits))
    return;

  // Epilogue: float4 e of thread tid is row 4e + tid / 64, columns c4 ..
  // c4 + 3 (the merge's layout): one 16-byte f32 or 8-byte bf16 store.
  const int c4 = 4 * (tid % 64);
  if (n0 + c4 >= N) return;
#pragma unroll
  for (int e = 0; e < MR / 4; ++e) {
    const int r = 4 * e + tid / 64;
    if (r >= m) break;
    const float4 v = reinterpret_cast<const float4*>(red)[e * kThreads + tid];
    TOut* dst = C + (size_t)r * ldc + n0 + c4;
    if constexpr (std::is_same<TOut, float>::value) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      uint2 pair;
      pair.x = aiko::pack_bf16x2(v.x, v.y);
      pair.y = aiko::pack_bf16x2(v.z, v.w);
      *reinterpret_cast<uint2*>(dst) = pair;
    }
  }
}

template <int MR, typename TOut>
cudaError_t launch(const void* x, const void* w, TOut* C, void* partials,
                   void* arrivals, int m, int N, int K, int ldb, int ldc,
                   int col0, int splits, int k_split, cudaStream_t stream) {
  constexpr int smem = RingOf<MR>::kSmem;
  CUtensorMap w_map;
  if (!weight_map(&w_map, w, K, 2LL * ldb, kKC)) return cudaErrorInvalidValue;
  static std::atomic<unsigned> configured{0};
  const cudaError_t err = aiko::wstream::set_smem_once(
      configured, reinterpret_cast<const void*>(ring_stream<MR, TOut>),
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kNT - 1) / kNT, splits);
  ring_stream<MR, TOut><<<grid, kThreads, smem, stream>>>(
      w_map, static_cast<const __nv_bfloat16*>(x), C,
      static_cast<float*>(partials), static_cast<int*>(arrivals), m, K, N,
      ldc, col0, k_split);
  return cudaGetLastError();
}

// K cut into slices so that a rank's tile x slice CTAs fill its share of
// the card (`ctas` SMs) in one wave and never more, each slice at least
// four stages and a whole number of them.  tiles x splits <= ctas where
// splits > 1, so a rank's scratch of kScratchFloatsPerCta x ctas floats and
// ctas arrival counters holds any step's split.
struct Split {
  int splits, rows;
};

Split k_split(int K, int N, int ctas) {
  const int tiles = (N + kNT - 1) / kNT;
  const int splits = std::max(1, std::min(ctas / tiles, K / (4 * kKC)));
  int rows = (K + splits - 1) / splits;
  rows = (rows + kKC - 1) / kKC * kKC;
  return {(K + rows - 1) / rows, rows};
}

constexpr int kScratchFloatsPerCta = 64 * kNT;   // a tile's partial, MR 64

template <typename TOut>
cudaError_t dispatch(const void* x, const void* w, TOut* C, void* partials,
                     void* arrivals, int m, int N, int K, int ldb, int ldc,
                     int col0, int ctas, cudaStream_t stream) {
  // A split launch needs its scratch.
  const Split s = k_split(K, N, ctas);
  if (s.splits > 1 && (partials == nullptr || arrivals == nullptr))
    return cudaErrorInvalidValue;
  if (m <= 16)
    return launch<16>(x, w, C, partials, arrivals, m, N, K, ldb, ldc, col0,
                      s.splits, s.rows, stream);
  if (m <= 32)
    return launch<32>(x, w, C, partials, arrivals, m, N, K, ldb, ldc, col0,
                      s.splits, s.rows, stream);
  return launch<64>(x, w, C, partials, arrivals, m, N, K, ldb, ldc, col0,
                    s.splits, s.rows, stream);
}

}  // namespace decode

// ---- the unaligned bf16 path: mma.sync, tiles loaded element by element
constexpr int kThreads = 256;
constexpr int kBK = 32;             // bf16 K tile
constexpr int kALd = kBK + 8;       // padded A row (bf16): conflict-free
constexpr int kFT = 64, kFK = 16;   // f32 tile and K tile

template <int BM, int BN>
struct Tiles {
  __nv_bfloat16 a[2][BM][kALd];     // x rows, K-major
  __nv_bfloat16 b[2][kBK][BN + 8];  // w rows, N-major
};

// C (M x N, ldc) = A (M x K, lda) @ B (K x N, ldb), bf16 in, f32
// accumulate, TOut out; rows past M and columns past N are never stored,
// K past its end reads zeros.
template <int BM, int BN, typename TOut>
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
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    // The other stage was last read before the trailing barrier of the
    // previous iteration: free to refill.
    if (kt + 1 < nk) load((kt + 1) & 1, (kt + 1) * kBK);
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

// The path of C (M x N, ldc) = A (M x K, rows contiguous) @ columns col0
// .. col0 + N - 1 of B (K x ldb): the TMA paths need every pointer 16-byte
// aligned and K, N and both row strides multiples of 8 elements.
Path choose_path(const void* A, const void* B, const void* C, int M, int N,
                 int K, int ldb, int ldc, int dtype) {
  if (dtype == AIKO_F32) return kPathF32;
  const bool aligned = aligned16(A) && aligned16(B) && aligned16(C) &&
                       K % 8 == 0 && N % 8 == 0 && ldb % 8 == 0 &&
                       ldc % 8 == 0;
  if (!aligned) return kPathMmaSync;
  return M <= 64 ? kPathStream : kPathWgmma;
}

template <int BM, int BN, typename TOut>
cudaError_t launch_bf16(const __nv_bfloat16* A, const __nv_bfloat16* B,
                        TOut* C, int M, int N, int K, int ldb, int ldc,
                        cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ring_mm_bf16<BM, BN, TOut>
      <<<grid, kThreads, 0, stream>>>(A, B, C, M, N, K, K, ldb, ldc);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t matmul_bf16(Path path, const void* A, const void* B, TOut* C,
                        void* partials, void* arrivals, int M, int N, int K,
                        int ldb, int ldc, int col0, int ctas,
                        cudaStream_t stream) {
  if (path == kPathWgmma)
    return prefill::launch<TOut>(A, B, C, M, N, K, ldb, ldc, col0, stream);
  if (path == kPathStream)
    return decode::dispatch<TOut>(A, B, C, partials, arrivals, M, N, K, ldb,
                                  ldc, col0, ctas, stream);
  const auto* a = static_cast<const __nv_bfloat16*>(A);
  const auto* b = static_cast<const __nv_bfloat16*>(B) + col0;
  if (M <= 32)
    return launch_bf16<32, 64>(a, b, C, M, N, K, ldb, ldc, stream);
  return launch_bf16<128, 128>(a, b, C, M, N, K, ldb, ldc, stream);
}

// One step's product: C (M x N, ldc) = A (M x K, rows contiguous) @ B[:,
// col0 : col0 + N] (B K x ldb), C f32 when out_f32, else of the inputs'
// type.
struct Step {
  const void* A;
  const void* B;
  void* C;
  int M, N, K, ldb, ldc, col0;
  bool out_f32;
};

Step ag_step(const void* block, const void* w, void* out, int m_local, int k,
             int n_local, int out_row0, int dtype) {
  const size_t elem = dtype == AIKO_F32 ? 4 : 2;
  const size_t out_offset = (size_t)out_row0 * n_local;
  return {block, w, static_cast<char*>(out) + out_offset * elem, m_local,
          n_local, k, n_local, n_local, 0, false};
}

Step rs_step(const void* x, const void* w, void* acc, int m, int k_local,
             int n, int n_local, int col0) {
  return {x, w, acc, m, n_local, k_local, n, n_local, col0, true};
}

Path step_path(const Step& s, int dtype) {
  return choose_path(s.A, s.B, s.C, s.M, s.N, s.K, s.ldb, s.ldc, dtype);
}

// Inputs of type `dtype` (AIKO_F32 or AIKO_BF16).  The decode path splits
// K over the rank's `ctas` (decode::k_split) with the rank's scratch
// `partials` and `arrivals` (null only where no step of it splits).
cudaError_t matmul(const Step& s, void* partials, void* arrivals, int ctas,
                   int dtype, cudaStream_t stream) {
  if (s.M <= 0 || s.N <= 0 || s.K <= 0 || s.M > 65535 * 64 ||  // grid.y
      ctas < 1)
    return cudaErrorInvalidValue;
  if (dtype != AIKO_F32 && dtype != AIKO_BF16) return cudaErrorInvalidValue;
  const Path path = step_path(s, dtype);
  if (path == kPathF32) {
    const dim3 grid((s.N + kFT - 1) / kFT, (s.M + kFT - 1) / kFT);
    ring_mm_f32<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(s.A),
        static_cast<const float*>(s.B) + s.col0, static_cast<float*>(s.C),
        s.M, s.N, s.K, s.K, s.ldb, s.ldc);
    return cudaGetLastError();
  }
  if (s.out_f32)
    return matmul_bf16(path, s.A, s.B, static_cast<float*>(s.C), partials,
                       arrivals, s.M, s.N, s.K, s.ldb, s.ldc, s.col0, ctas,
                       stream);
  return matmul_bf16(path, s.A, s.B, static_cast<__nv_bfloat16*>(s.C),
                     partials, arrivals, s.M, s.N, s.K, s.ldb, s.ldc, s.col0,
                     ctas, stream);
}

// What a step takes: {path (enum Path), K slices, rows a slice}; one slice
// of K off the decode path.
void plan(const Step& s, int ctas, int dtype, int* out) {
  const Path path = step_path(s, dtype);
  const decode::Split split = path == kPathStream
      ? decode::k_split(s.K, s.N, std::max(ctas, 1))
      : decode::Split{1, s.K};
  out[0] = path;
  out[1] = split.splits;
  out[2] = split.rows;
}

}  // namespace

// One all-gather ring step on one rank: block (m_local, k) @ w (k, n_local)
// into rows out_row0 .. out_row0 + m_local - 1 of out (., n_local), f32
// accumulation, stored in the inputs' type (`dtype`: AIKO_F32 or
// AIKO_BF16).  All row-major and contiguous.  `ctas`: the rank's share of
// the card's SMs; `partials` and `arrivals`: the rank's own split scratch
// (aiko_ring_scratch_floats(ctas) floats, ctas int32 counters at zero,
// which each launch leaves at zero).
extern "C" int aiko_ring_ag_step(const void* block, const void* w, void* out,
                                 void* partials, void* arrivals, int m_local,
                                 int k, int n_local, int out_row0, int ctas,
                                 int dtype, void* stream) {
  return matmul(ag_step(block, w, out, m_local, k, n_local, out_row0, dtype),
                partials, arrivals, ctas, dtype,
                static_cast<cudaStream_t>(stream));
}

// One reduce-scatter ring step on one rank: the partial of the owner whose
// columns start at col0, acc (m, n_local) f32 = x (m, k_local) @
// w[:, col0 : col0 + n_local] of w (k_local, n).  All row-major and
// contiguous; `ctas` and the scratch as for the all-gather step.
extern "C" int aiko_ring_rs_step(const void* x, const void* w, void* acc,
                                 void* partials, void* arrivals, int m,
                                 int k_local, int n, int n_local, int col0,
                                 int ctas, int dtype, void* stream) {
  if (col0 < 0 || col0 + n_local > n) return cudaErrorInvalidValue;
  return matmul(rs_step(x, w, acc, m, k_local, n, n_local, col0), partials,
                arrivals, ctas, dtype, static_cast<cudaStream_t>(stream));
}

// The floats of a rank's split scratch for a share of `ctas` SMs.
extern "C" int aiko_ring_scratch_floats(int ctas) {
  return ctas * decode::kScratchFloatsPerCta;
}

// What aiko_ring_ag_step / aiko_ring_rs_step take for these arguments,
// into plan[3]: the path (enum Path), the K slices and the rows a slice.
extern "C" int aiko_ring_ag_plan(const void* block, const void* w,
                                 void* out, int m_local, int k, int n_local,
                                 int out_row0, int ctas, int dtype,
                                 int* plan_out) {
  plan(ag_step(block, w, out, m_local, k, n_local, out_row0, dtype), ctas,
       dtype, plan_out);
  return 0;
}

extern "C" int aiko_ring_rs_plan(const void* x, const void* w, void* acc,
                                 int m, int k_local, int n, int n_local,
                                 int col0, int ctas, int dtype,
                                 int* plan_out) {
  plan(rs_step(x, w, acc, m, k_local, n, n_local, col0), ctas, dtype,
       plan_out);
  return 0;
}
