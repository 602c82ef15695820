// The streaming structure shared by the weight-only dequant-matmuls
// (int8_matmul.cu, int4_matmul.cu) at decode shapes, m <= 64 rows of x:
//
//   * one CTA of 8 warps owns a 256-column tile of N and a slice of K;
//     each warp owns 32 columns and every K row of the slice;
//   * the weight streams through a ring of 64-row stages in dynamic shared
//     memory, each stage two 2-d TMA boxes of 128 columns (bytes),
//     128-byte swizzled, counted on the stage's mbarrier (plus whatever
//     bulk copies the kernel adds to the stage), x's rows by cp.async into
//     16-byte-padded rows; all but one stage in flight, one CTA barrier a
//     stage frees its slot;
//   * K is split by (K, N) alone (ops/quant.py _k_split), and the last CTA
//     of a tile sums the slices' f32 partials in slice order, each thread's
//     elements in registers with several slices' loads in flight: the same
//     sums for every m of every instance.
#pragma once

#include <atomic>
#include <unordered_map>

#include "common.cuh"

namespace aiko {
namespace wstream {

constexpr int kThreads = 256;        // 8 warps of 32 columns
constexpr int kNT = 256;             // output columns per CTA
constexpr int kKC = 64;              // K rows per stage (4 mma k steps)
constexpr int kBoxCols = 128;        // a TMA box: 128 columns (bytes)
constexpr int kXLd = kKC * 2 + 16;   // padded x row, bytes

// A ring of stages of kPayload bytes for kCtas CTAs an SM: as many stages
// as fit the shared-memory budget of that many CTAs, at most 8; each stage
// starts on 1 KB (the 128-byte swizzle's period), and the drained ring
// holds the tile's f32 result (kRedBytes).
template <int kPayload, int kCtas, int kRedBytes>
struct Ring {
  static constexpr int kStageBytes = (kPayload + 1023) / 1024 * 1024;
  static constexpr int kBudget = 210 * 1024 / kCtas - 2048;
  static constexpr int kStages =
      kBudget / kStageBytes > 8 ? 8 : kBudget / kStageBytes;
  static constexpr int kSmem = (kStages * kStageBytes > kRedBytes
                                    ? kStages * kStageBytes
                                    : kRedBytes) + 1024;   // alignment slack
  static_assert(kStages >= 3, "a ring of at least three stages");
};

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
// Rows past the map's extent land as zeros and count in full.
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

// The 1 KB-aligned start of the dynamic shared memory (the swizzle's XOR
// is then the row's low 3 bits).
__device__ __forceinline__ unsigned char* ring_base(unsigned char* raw) {
  const uint32_t addr = smem_u32(raw);
  return raw + (((addr + 1023) & ~1023u) - addr);
}

// One mbarrier a stage, one arrival (thread 0's expect_tx) a phase.
__device__ __forceinline__ void init_ring(uint64_t* full, int stages) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&full[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// MR rows of x (row stride K) by 16-byte cp.async copies, k0..k0+63 into
// rows at `xs`: of kXLd bytes (padded: mma.sync fragment loads), or with
// kSwizzled of 128 bytes, row r's 16-byte chunk q at q ^ (r % 8) (the
// 128-byte swizzle of a wgmma operand); rows past m and columns past k_end
// are zeros.
template <int MR, bool kSwizzled = false>
__device__ __forceinline__ void stage_x(unsigned char* xs,
                                        const __nv_bfloat16* x, int m, int K,
                                        int k0, int k_end) {
  constexpr int kLd = kSwizzled ? kKC * 2 : kXLd;
  for (int i = threadIdx.x; i < MR * 8; i += kThreads) {
    const int r = i / 8, chunk = i % 8;
    const bool ok = r < m && k0 + chunk * 8 < k_end;
    cp_async16(xs + r * kLd + ((kSwizzled ? chunk ^ (r & 7) : chunk) << 4),
               x + (ok ? (size_t)r * K + k0 + chunk * 8 : 0), ok);
  }
}

// The ring: `load(slot, i)` fills slot `slot` with stage i (thread 0
// arms the slot's mbarrier for exactly the bytes it issues; a copy left
// out would hang its waiters), `compute(slot, i)` consumes it.  Stages
// 0..kStages-2 are issued first; each turn waits for its stage (cp.async
// group and mbarrier phase), frees the slot read a turn ago with one CTA
// barrier and refills it kStages - 1 stages ahead.  kAsyncReads: the
// stage's cp.async data is read by wgmma (the async proxy), so each
// thread fences its copies before the barrier.  Returns with the ring
// drained.
template <int kStages, bool kAsyncReads = false, typename Load,
          typename Compute>
__device__ __forceinline__ void run_ring(uint64_t* full, int nk, Load load,
                                         Compute compute) {
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kStages - 2>();
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    if (kAsyncReads) fence_proxy_async();
    __syncthreads();
    const int pre = it + kStages - 1;
    if (pre < nk) load(pre % kStages, pre);
    cp_async_commit();
    compute(it % kStages, it);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The split-K merge of a tile: publish this CTA's partial tile
// red[MR][kNT] (f32, in shared memory) as slice `split` of tile `tile`;
// the last CTA of the tile to arrive sums all `splits` slices in slice
// order into red and returns true (the others return false and are done).
// Thread t sums and writes float4s t, t + kThreads, ... of the tile (float4
// e is row 4e + t / 64), so a caller that reads red back in that layout
// needs no barrier.  The arrival is one acquire-release atomic by thread 0
// between two CTA barriers (a fence in every thread cost 0.5 us a call).
// Each thread keeps its elements' sums in registers and keeps kInFlight
// float4 loads in flight (kBatch slices of a pass's elements at once, in
// passes over its elements where they do not all fit): a sum that waits on
// each load in turn is latency-bound (at MR = 64 a slice is 64 KB).
// kInFlight is the instance's register budget for loads.  `partials` holds
// splits * MR * kNT floats a tile; `arrivals[tile]` starts at zero and is
// left zero.
template <int MR, int kInFlight>
__device__ __forceinline__ bool merge_slices(float* red, float* partials,
                                             int* arrivals, int tile,
                                             int split, int splits) {
  constexpr int kTile4 = MR * kNT / 4;       // float4s of a partial tile
  constexpr int kPer = kTile4 / kThreads;    // float4s a thread
  constexpr int kPass = kPer < kInFlight ? kPer : kInFlight;
  constexpr int kBatch = kInFlight / kPass;  // slices loaded at once
  static_assert(kPer % kPass == 0, "whole passes");
  __shared__ int last_flag;
  const int tid = threadIdx.x;
  float4* red4 = reinterpret_cast<float4*>(red);
  float4* mine = reinterpret_cast<float4*>(partials) +
                 ((size_t)tile * splits + split) * kTile4;
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    __stcg(mine + e * kThreads + tid, red4[e * kThreads + tid]);
  __syncthreads();
  if (tid == 0) {
    int arrived;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(arrived)
                 : "l"(arrivals + tile)
                 : "memory");
    last_flag = arrived == splits - 1;
  }
  __syncthreads();
  if (!last_flag) return false;
  const float4* slices = reinterpret_cast<const float4*>(partials) +
                         (size_t)tile * splits * kTile4 + tid;
#pragma unroll
  for (int e0 = 0; e0 < kPer; e0 += kPass) {
    float4 sum[kPass];
#pragma unroll
    for (int e = 0; e < kPass; ++e) sum[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < splits; sp0 += kBatch) {
      float4 v[kBatch][kPass];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
#pragma unroll
        for (int e = 0; e < kPass; ++e)
          if (sp0 + j < splits)
            v[j][e] = __ldcg(slices + (size_t)(sp0 + j) * kTile4 +
                             (e0 + e) * kThreads);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (sp0 + j < splits)
#pragma unroll
          for (int e = 0; e < kPass; ++e) {
            sum[e].x += v[j][e].x;
            sum[e].y += v[j][e].y;
            sum[e].z += v[j][e].z;
            sum[e].w += v[j][e].w;
          }
    }
#pragma unroll
    for (int e = 0; e < kPass; ++e) red4[(e0 + e) * kThreads + tid] = sum[e];
  }
  if (tid == 0) arrivals[tile] = 0;  // ready for the next launch
  return true;
}

// ---- host ----

// The dynamic shared memory of a kernel instance, set once a device (a
// host call less a launch): `configured` is the instance's own mask of
// devices done.  The carveout is left to the driver: the whole L1 as
// shared memory cost int4's one-CTA-an-SM instance 7-9% at w_down and
// wk/wv (smoke phase 2).
inline cudaError_t set_smem_once(std::atomic<unsigned>& configured,
                                 const void* kernel, int bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (bit && (configured.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured.fetch_or(bit);
  return err;
}

// The weight's tensor map.

// A (rows, cols) byte matrix (row stride cols) as a 2-d uint8 map, a box
// kBoxCols columns x box_rows rows, 128-byte swizzle, rows past the end
// zero-filled.  Weights stay where they are, so the maps are cached by
// pointer, shape and box (cleared past 4,096 entries).  False if the
// driver has no encoder or refuses the map.
inline bool weight_map(CUtensorMap* map, const void* ptr, long long rows,
                       long long cols, int box_rows) {
  struct Key {
    const void* ptr;
    long long rows, cols;
    int box_rows;
    bool operator==(const Key& o) const {
      return ptr == o.ptr && rows == o.rows && cols == o.cols &&
             box_rows == o.box_rows;
    }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      return std::hash<const void*>()(k.ptr) ^
             (std::hash<long long>()(k.rows) * 31 + (size_t)k.cols) ^
             ((size_t)k.box_rows << 48);
    }
  };
  static std::mutex mutex;
  static std::unordered_map<Key, CUtensorMap, KeyHash> maps;
  const Key key{ptr, rows, cols, box_rows};
  std::lock_guard<std::mutex> lock(mutex);
  const auto found = maps.find(key);
  if (found != maps.end()) {
    *map = found->second;
    return true;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {kBoxCols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (maps.size() >= 4096) maps.clear();
  maps.emplace(key, *map);
  return true;
}

}  // namespace wstream
}  // namespace aiko
