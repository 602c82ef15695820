// Kernel-lab variant of csrc/int4_matmul.cu (tools/int4_kernel_lab.py
// `--builds`, label `wgmma`): the same kernel, whose product runs on wgmma
// instead of mma.sync, Hopper's mixed-input pattern: the dequantized weight
// tile is the A operand from registers (each warpgroup's four warps give the
// 64 rows of an m64 tile: two tiles a warpgroup, the columns of its warps),
// x is the B operand from shared memory (m64n{MR}k16, K-major, x's rows
// landing 128-byte swizzled by cp.async).  Since B is read in its natural
// k order, the nibbles are dequantized in natural order too: a byte's low
// and high nibble become one bf16x2 (k rows 2r, 2r + 1), by a byte permute
// of the word and the word shifted by 4, then the same LOP3 and bf16x2 fma
// of -136.  A stage's 8 products are issued back to back, then waited for
// before the group fold reads them.  Everything else (ring, TMA, K split,
// merge) is the production source's.
#include "common.cuh"

#include <unordered_map>

namespace {

constexpr int kThreads = 256;        // 8 warps of 32 columns
constexpr int kNT = 256;             // output columns per CTA
constexpr int kKC = 64;              // K rows per stage (4 mma k steps)
constexpr int kPR = kKC / 2;         // packed rows per stage
constexpr int kBoxCols = 128;        // a TMA box: 128 columns (bytes) of
constexpr int kBoxBytes = kPR * kBoxCols;  // kPR packed rows, 128B-swizzled
constexpr int kWBytes = kNT / kBoxCols * kBoxBytes;
constexpr int kXLd = kKC * 2;        // x row, bytes (128-byte swizzled)
constexpr int kSBytes = kNT * 4;     // the stage's group scales, f32

// CTAs an SM of an MR-row instance (what its registers allow), and its
// ring: as many stages as fit the shared-memory budget of that many CTAs,
// at most 8; each stage starts on 1 KB (the 128-byte swizzle's period).
__host__ __device__ constexpr int ctas_per_sm(int mr) {
  return mr <= 8 ? 3 : mr <= 32 ? 2 : 1;
}
template <int MR>
struct Ring {
  static constexpr int kStageBytes =
      (kWBytes + kSBytes + MR * kXLd + 1023) / 1024 * 1024;
  static constexpr int kBudget = 210 * 1024 / ctas_per_sm(MR) - 2048;
  static constexpr int kStages =
      kBudget / kStageBytes > 8 ? 8 : kBudget / kStageBytes;
  static constexpr int kRed = MR * kNT * 4;
  static constexpr int kSmem = (kStages * kStageBytes > kRed
                                    ? kStages * kStageBytes
                                    : kRed) + 1024;   // alignment slack
  static_assert(kStages >= 3, "a ring of at least three stages");
};

constexpr unsigned kMagic = 0x43084308u;    // bf16 136 in both lanes
constexpr unsigned kOne = 0x3F803F80u;      // bf16 1
constexpr unsigned kMinus136 = 0xC308C308u; // bf16 -136

__device__ __forceinline__ unsigned bf16x2_fma(unsigned a, unsigned b,
                                               unsigned c) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// ---- the ring: one mbarrier a stage ----
using aiko::mbar_expect_tx;
using aiko::mbar_init;
using aiko::mbar_wait;
using aiko::smem_u32;

// `bytes` (a multiple of 16) from global to shared memory by the copy
// engine of the SM (TMA), counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// A 2-d box of `map` at (c0, c1) into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// ---- wgmma ----
using aiko::fence_operands;
using aiko::make_desc;
using aiko::wgmma_commit;
using aiko::wgmma_fence;
using aiko::wgmma_wait;

template <int N>
using WgmmaX = aiko::WgmmaRS<N>;

// The signed nibbles at bits 0-3 and 16-19 of v as an exact bf16x2 (low
// lane first): 0x4300 | (nibble ^ 8) is the bf16 of 136 + nibble.
__device__ __forceinline__ unsigned nibbles_to_bf16x2(unsigned v) {
  return bf16x2_fma((v & 0x000f000fu) ^ kMagic, kOne, kMinus136);
}

// This thread's 16 weights of one k step as the A fragments of its two m
// tiles, in natural k order: w0 and w4 are packed rows r and r + 4 (k rows
// 2r, 2r + 1 and 2r + 8, 2r + 9), columns 4g..4g+3 of the warp's 32, one
// byte each.  m tile t holds columns 4g + 2t (A row g) and 4g + 2t + 1 (row
// g + 8); a register is one byte: its low nibble in the low lane.
template <bool kScaleFirst>
__device__ __forceinline__ void dequant(unsigned w0, unsigned w4,
                                        const float (&sc)[4],
                                        unsigned (&a)[2][4]) {
  const unsigned h0 = w0 >> 4, h4 = w4 >> 4;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    // Byte j of w to bits 0-7, byte j of w >> 4 to bits 16-23.
    const unsigned s0 = 0x0400u + 0x0101u * (2 * t);
    const unsigned s1 = 0x0400u + 0x0101u * (2 * t + 1);
    const unsigned r0 = nibbles_to_bf16x2(__byte_perm(w0, h0, s0));
    const unsigned r1 = nibbles_to_bf16x2(__byte_perm(w0, h0, s1));
    const unsigned r2 = nibbles_to_bf16x2(__byte_perm(w4, h4, s0));
    const unsigned r3 = nibbles_to_bf16x2(__byte_perm(w4, h4, s1));
    if constexpr (kScaleFirst) {
      // bf16(q * s): the column's scale, rounded once (conversion unit).
      auto scaled = [](unsigned r, float f) {
        return aiko::pack_bf16x2(__uint_as_float(r << 16) * f,
                                 __uint_as_float(r & 0xffff0000u) * f);
      };
      a[t][0] = scaled(r0, sc[2 * t]);
      a[t][1] = scaled(r1, sc[2 * t + 1]);
      a[t][2] = scaled(r2, sc[2 * t]);
      a[t][3] = scaled(r3, sc[2 * t + 1]);
    } else {
      a[t][0] = r0;
      a[t][1] = r1;
      a[t][2] = r2;
      a[t][3] = r3;
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
  using R = Ring<MR>;
  constexpr int kMT = MR / 8;                  // mma n-tiles over x rows
  constexpr int kStages = R::kStages;
  constexpr int kStageBytes = R::kStageBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int last_flag;
  // The ring starts on 1 KB: the swizzle's XOR is the row's low 3 bits.
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_u32(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int n0 = blockIdx.x * kNT;
  // This warp's columns n0 + 32 * warp ..; past N (a multiple of 64) in
  // the last tile of an N that is not a multiple of 256.
  // wgmma runs a warpgroup's four warps together: a warpgroup with a live
  // warp computes (its dead warps' columns are never stored).
  const bool wg_live = n0 + 128 * (warp / 4) < N;
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
  // columns (128-byte swizzle; a box wholly past N is not issued) and the
  // group's scales as one bulk copy, issued by thread 0 and counted on the
  // stage's mbarrier, and x's rows by cp.async (rows past m are zeros).  A
  // stage lies in one group and in the slice (k_split and K are multiples
  // of 64).  The mbarrier expects exactly the bytes issued: a copy left
  // out would hang its waiters.
  const int cols = min(kNT, N - n0);
  const int boxes = (cols + kBoxCols - 1) / kBoxCols;
  const unsigned stage_tx = boxes * kBoxBytes + cols * 4;
  auto load_stage = [&](int stage, int k0) {
    const uint32_t ws = base + stage * kStageBytes;
    unsigned char* xs = smem + stage * kStageBytes + kWBytes + kSBytes;
    if (tid == 0) {
      mbar_expect_tx(&full[stage], stage_tx);
      for (int bx = 0; bx < boxes; ++bx)
        tma_load_2d(ws + bx * kBoxBytes, &w_map, &full[stage],
                    n0 + bx * kBoxCols, k0 / 2);
      bulk_copy(ws + kWBytes, s + (size_t)(k0 / group) * N + n0, cols * 4,
                &full[stage]);
    }
    // x: MR rows x 64 bf16 = 8 chunks a row.
    for (int i = tid; i < MR * 8; i += kThreads) {
      const int r = i / 8, chunk = i % 8;
      const bool ok = r < m;
      aiko::cp_async16(xs + r * kXLd + ((chunk ^ (r & 7)) << 4),
                       x + (ok ? (size_t)r * K + k0 + chunk * 8 : 0), ok);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
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

  // This thread's weight bytes: columns 32 * warp + 4g .. + 3 of the tile,
  // in box warp / 4, 16-byte chunk 2 (warp % 4) + g / 4 of a packed row
  // (stored at chunk ^ (row % 8): the 128-byte swizzle), bytes 4 (g % 4)..
  const int chunk = (32 * (warp % 4) + 4 * g) / 16;
  const int in_chunk = (4 * g) % 16;
  for (int it = 0; it < nk; ++it) {
    aiko::cp_async_wait<kStages - 2>();
    // x's copies, seen by wgmma's reads (the async proxy).
    aiko::fence_proxy_async();
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    __syncthreads();
    const int pre = it + kStages - 1;
    if (pre < nk) load_stage(pre % kStages, k_begin + pre * kKC);
    aiko::cp_async_commit();
    if (!wg_live) continue;
    const unsigned char* ws = smem + (it % kStages) * kStageBytes;
    const float* ss = reinterpret_cast<const float*>(ws + kWBytes);
    const unsigned char* xs = ws + kWBytes + kSBytes;
    // This thread's 4 columns' scales of the stage's group.
    const float4 sc4 =
        *reinterpret_cast<const float4*>(ss + 32 * warp + 4 * g);
    const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
    const unsigned char* wbox = ws + (warp / 4) * kBoxBytes + in_chunk;
    const uint32_t xs_u = smem_u32(xs);
    unsigned a[kKC / 16][2][4];
    if constexpr (kScaleFirst) {
#pragma unroll
      for (int t = 0; t < 2; ++t) fence_operands(acc[t]);
    } else {
#pragma unroll
      for (int t = 0; t < 2; ++t) fence_operands(part[t]);
    }
#pragma unroll
    for (int step = 0; step < kKC / 16; ++step) {
      // Packed rows r = 8 * step + c and r + 4 of the stage.
      const int pr = 8 * step + c;
      const unsigned w0 = *reinterpret_cast<const unsigned*>(
          wbox + pr * kBoxCols + ((chunk ^ (pr & 7)) << 4));
      const unsigned w4 = *reinterpret_cast<const unsigned*>(
          wbox + (pr + 4) * kBoxCols + ((chunk ^ ((pr + 4) & 7)) << 4));
      dequant<kScaleFirst>(w0, w4, sc, a[step]);
      wgmma_fence();
      // x's k rows 16 step.. of every row: 32 bytes into the swizzled row.
      const uint64_t desc = make_desc(xs_u + 32 * step, 16, 1024, 1);
#pragma unroll
      for (int t = 0; t < 2; ++t)
        WgmmaX<MR>::run(kScaleFirst ? acc[t] : part[t], a[step][t], desc, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (kScaleFirst) {
#pragma unroll
      for (int t = 0; t < 2; ++t) fence_operands(acc[t]);
    } else {
#pragma unroll
      for (int t = 0; t < 2; ++t) fence_operands(part[t]);
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
  }
  aiko::cp_async_wait<0>();
  __syncthreads();  // the ring is drained; reuse it for the tile

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

  if (splits > 1) {
    // Publish this slice's partial tile; the last CTA of the tile to
    // arrive sums all slices in slice order.  Each thread keeps its
    // elements' sums in registers and loads kBatch slices of all of them
    // at once: a sum that waits on each load in turn is latency-bound
    // (and at MR = 64 a tile has 64 KB a slice).
    constexpr int kTile4 = MR * kNT / 4;       // float4s of a partial tile
    constexpr int kPer = kTile4 / kThreads;    // float4s a thread
    // Slices loaded at once: 32 registers of loads below MR = 64 (their
    // register caps), 128 at MR = 64.
    constexpr int kBatch = kPer >= 16 ? 2 : kPer >= 8 ? 1 : 8 / kPer;
    float4* red4 = reinterpret_cast<float4*>(red);
    float4* mine = reinterpret_cast<float4*>(partials) +
                   ((size_t)tile * splits + split) * kTile4;
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      __stcg(mine + e * kThreads + tid, red4[e * kThreads + tid]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int arrived = atomicAdd(arrivals + tile, 1);
      last_flag = arrived == splits - 1;
    }
    __syncthreads();
    if (!last_flag) return;
    __threadfence();
    const float4* slices =
        reinterpret_cast<const float4*>(partials) + (size_t)tile * splits * kTile4;
    float4 sum[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) sum[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < splits; sp0 += kBatch) {
      float4 v[kBatch][kPer];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (sp0 + j < splits)
#pragma unroll
          for (int e = 0; e < kPer; ++e)
            v[j][e] = __ldcg(slices + (size_t)(sp0 + j) * kTile4 +
                             e * kThreads + tid);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (sp0 + j < splits)
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            sum[e].x += v[j][e].x;
            sum[e].y += v[j][e].y;
            sum[e].z += v[j][e].z;
            sum[e].w += v[j][e].w;
          }
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) red4[e * kThreads + tid] = sum[e];
    if (tid == 0) arrivals[tile] = 0;  // ready for the next launch
    __syncthreads();
  }

  for (int i = tid; i < MR * kNT; i += kThreads) {
    const int r = i / kNT, col = i % kNT;
    if (r < m && n0 + col < N)
      out[(size_t)r * N + n0 + col] = __float2bfloat16(red[i]);
  }
}

// ---- host: the weight's tensor map ----
using aiko::EncodeTiled;
using aiko::encoder;

// The packed weight (K/2 rows of N bytes) as a 2-d uint8 map, a box 128
// columns x 32 rows, 128-byte swizzle.  Weights stay where they are, so
// the maps are cached by pointer and shape (cleared past 4,096 entries).
struct WeightKey {
  const void* ptr;
  long long rows, cols;
  bool operator==(const WeightKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols;
  }
};
struct WeightKeyHash {
  size_t operator()(const WeightKey& k) const {
    return std::hash<const void*>()(k.ptr) ^
           (std::hash<long long>()(k.rows) * 31 + (size_t)k.cols);
  }
};
std::mutex g_map_mutex;
std::unordered_map<WeightKey, CUtensorMap, WeightKeyHash> g_maps;

bool weight_map(CUtensorMap* map, const void* q4, int K, int N) {
  const WeightKey key{q4, K / 2, N};
  std::lock_guard<std::mutex> lock(g_map_mutex);
  const auto found = g_maps.find(key);
  if (found != g_maps.end()) {
    *map = found->second;
    return true;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)(K / 2)};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {kBoxCols, kPR};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q4),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (g_maps.size() >= 4096) g_maps.clear();
  g_maps.emplace(key, *map);
  return true;
}

template <int MR, bool kScaleFirst>
cudaError_t launch(const void* x, const void* q4, const void* s, void* out,
                   void* partials, void* arrivals, int m, int K, int N,
                   int group, int splits, int k_split, cudaStream_t stream) {
  constexpr int smem = Ring<MR>::kSmem;
  CUtensorMap w_map;
  if (!weight_map(&w_map, q4, K, N)) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      int4_matmul_kernel<MR, kScaleFirst>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
