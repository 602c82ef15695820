// Ragged paged GQA decode attention: one query token per row over that row's
// block-table blocks, softmax, optional sliding window, optional int8 K/V
// with per-(token, head) f32 scales.
//
// Replaces: aiko_services_tpu/ops/paged_attention.py::paged_decode_attention,
// the Pallas kernel `_paged_decode_kernel` (paged_attention.py:267,
// pallas_call at paged_attention.py:430).
//
// Bound on the H100: bytes.  A row must read the K and V rows of its live
// keys once (2 bytes an element, or 1 plus a 4-byte scale per token and head
// for int8); the 4*heads*head_dim operations per key are far below the
// compute line.
//
// Design against that bound:
//   * the TPU kernel walks a row's blocks in order on one core, carrying the
//     online softmax in VMEM.  Here the key axis is cut into splits of a
//     fixed key count (whole blocks, at most kSplitKeys: 16 blocks at block
//     size 16, one at 128) and one CTA owns (row, kv head, split).  The
//     grid is (batch * kv_heads, splits of the table width); a split with no
//     live key (past the position, or below the window) exits at once.  The
//     split size depends on the block size alone, never on the batch or on
//     data, so a row's result is bitwise the same in any batch and the
//     launch needs no host sync;
//   * all `group` query heads of the kv head share the CTA, so each K/V row
//     is read once for the whole group (GQA-native); the CTA reads its own
//     block ids from the table (there is no scalar prefetch on the GPU) and
//     never reads a table entry outside the row's live keys;
//   * bytes stay in flight: the split's K rows and then its V rows stream
//     through a ring of kStages shared-memory stages of 64 keys, filled by
//     16-byte cp.async copies two stages ahead of the stage being read
//     (rows padded: conflict-free ldmatrix and 16-byte reads);
//   * every thread works on every stage.  bf16 q over bf16 or int8 pools
//     runs both products on the tensor cores (mma.sync m16n8k16, f32
//     accumulate), with the keys as the 16 rows and the group's query heads
//     padded to the 8 columns: warp w owns 16 keys of each 64-key stage;
//     S^T = K q^T takes K through ldmatrix and q^T from registers loaded
//     once; O^T += V^T P^T takes V through ldmatrix.trans and P (the f32
//     weights rounded to bf16) as B.  int8 stages feed the same products
//     from their bytes (int8 -> bf16 is exact in registers), each thread
//     reading 4 bytes of a K row and 2 of a V row, with the contracted
//     features and V's feature rows permuted to match (q follows K's order,
//     the sums undo V's).  f32 q or f32 pools keep f32 operands on
//     the CUDA cores: two threads a key for the scores (q broadcast from
//     shared memory), each value thread 8 features of one key lane.  int8
//     K's scale multiplies the score; V's scale is folded into each key's
//     weight.  The split's scores stay in shared memory, so its softmax runs
//     once, between the K and the V stages (no online rescale); the warps'
//     (key lanes') value sums are added in a fixed order at the end;
//   * each CTA keeps its split's max, sum and weighted values in f32; a row
//     with one live split writes its output directly, otherwise every CTA
//     publishes its partials and the last one of the row to arrive merges
//     them in split order (log-sum-exp), reading one partial per split, so
//     the result does not depend on timing.  NEG_INF is the JAX package's
//     finite value; a zero sum divides by 1.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;
constexpr int kMaxHeadDim = 128;
constexpr int kSplitKeys = 256;    // most keys a split covers
constexpr int kStageKeys = 64;     // keys a ring stage holds: 16 a warp
constexpr int kStages = 3;
static_assert(kStageKeys == 16 * kWarps && kStageKeys == kThreads / 2,
              "a stage is 16 keys a warp, or 2 threads a key");
constexpr int kUnit = 8;           // features a value thread owns (f32 path)

// Whole blocks, kSplitKeys at most (16 blocks at block size 16); one block
// from kSplitKeys / 2 up (the contiguous path's 128-row blocks), where rows
// are short and more, smaller splits keep more of the card busy.
__host__ __device__ constexpr int split_keys_for(int block_size) {
  return block_size >= kSplitKeys / 2 ? block_size
                                      : kSplitKeys / block_size * block_size;
}

// bf16 q over bf16 or int8 pools runs on the tensor cores; f32 q or f32
// pools keep f32 operands on the CUDA cores.
template <typename QT, typename KVT>
struct Path {
  static constexpr bool kMma = sizeof(QT) == 2 && sizeof(KVT) <= 2;
  [[maybe_unused]] static constexpr bool kInt8 = sizeof(KVT) == 1;
};

// Padded bytes of one staged row: +16 keeps 8 ldmatrix rows on distinct
// banks; +32 keeps the f32 path's two-threads-a-key reads distinct.
__host__ __device__ constexpr int row_bytes(int head_dim, int elem,
                                            bool mma) {
  return head_dim * elem + (mma ? 16 : 32);
}

template <typename QT, typename KVT>
size_t smem_bytes(int head_dim, int group) {
  using P = Path<QT, KVT>;
  const int elem = (int)sizeof(KVT);
  size_t ring = (size_t)kStages * kStageKeys *
                row_bytes(head_dim, elem, P::kMma);
  const size_t lanes = P::kMma ? kWarps : kThreads / (head_dim / kUnit);
  const size_t sums = lanes * group * head_dim * sizeof(float);
  return ring > sums ? ring : sums;
}

using aiko::ldmatrix_x4;

// Two int8 values of `word` (at bit offsets lo and hi) as a bf16x2 operand
// register, low half first; exact, through the conversion unit (unlike
// aiko::int8x2_to_bf16x2).
__device__ __forceinline__ unsigned int8x2_to_bf16x2_cvt(unsigned word,
                                                         int lo, int hi) {
  return aiko::pack_bf16x2(
      static_cast<float>(static_cast<int8_t>(word >> lo)),
      static_cast<float>(static_cast<int8_t>(word >> hi)));
}
__device__ __forceinline__ unsigned int8x2_to_bf16x2_cvt(unsigned word,
                                                         int lo) {
  return int8x2_to_bf16x2_cvt(word, lo, lo + 8);
}

// Eight consecutive elements of a staged row as floats (f32 path).
template <typename KVT>
__device__ __forceinline__ void load8(const unsigned char* p, float (&v)[8]);
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const unsigned char* p,
                                                     float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load8<float>(const unsigned char* p,
                                             float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 16);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<int8_t>(const unsigned char* p,
                                              float (&v)[8]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = static_cast<float>(b[i]);
}

template <typename QT, typename KVT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ positions, QT* __restrict__ out,
    float* __restrict__ partials, int* __restrict__ arrivals, int kv_heads,
    int group, int head_dim, int block_size, int max_blocks, int window,
    float sm_scale) {
  using P = Path<QT, KVT>;
  // Launched as a dependent of the kernel before it (the KV writer): every
  // global read, of q, the tables and positions and the pool, comes after
  // this wait.
  aiko::wait_for_producer();
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(16) float q_s[kMaxGroup][kMaxHeadDim];  // f32 path
  // Scores, then softmax weights (x V scale), of the split: [key][head].
  __shared__ __align__(16) float p_s[kSplitKeys][kMaxGroup];
  __shared__ int token_s[kSplitKeys];  // pool token index of each live key
  __shared__ float ks_s[kSplitKeys], vs_s[kSplitKeys];  // int8 scales
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup];
  __shared__ int last_flag;

  constexpr int kElem = (int)sizeof(KVT);
  constexpr int kVec = 16 / kElem;      // elements of a 16-byte chunk
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;  // mma fragment coordinates
  const int pair = blockIdx.x;           // row * kv_heads + head
  const int row = pair / kv_heads, head = pair % kv_heads;
  const int split = blockIdx.y;
  const int split_keys = split_keys_for(block_size);
  const int max_keys = max_blocks * block_size;
  const int pos = positions[row];
  const int row_lo = window > 0 ? max(pos - window + 1, 0) : 0;
  const int row_hi = min(pos, max_keys - 1);
  const int start = split * split_keys;
  const int lo = max(row_lo, start);
  const int hi = min(row_hi, start + split_keys - 1);
  if (lo > hi) return;
  const int first_split = row_lo / split_keys;
  const int n_live = row_hi / split_keys - first_split + 1;

  const int ld = row_bytes(head_dim, kElem, P::kMma);
  const int chunks = head_dim / kVec;   // 16-byte chunks of a row
  const size_t token_stride = (size_t)kv_heads * head_dim;
  const int stage_lo = (lo - start) / kStageKeys;
  const int n_stages = (hi - start) / kStageKeys - stage_lo + 1;

  for (int i = tid; i < split_keys; i += kThreads) {
    const int key = start + i;
    const bool live = key >= lo && key <= hi;
    const int token =
        live ? tables[(size_t)row * max_blocks + key / block_size] *
                       block_size + key % block_size
             : 0;
    token_s[i] = token;
    if (k_scale != nullptr && live) {
      ks_s[i] = k_scale[(size_t)token * kv_heads + head];
      vs_s[i] = v_scale[(size_t)token * kv_heads + head];
    }
  }
  const QT* q_row = q + (size_t)pair * group * head_dim;
  // Tensor-core path: q^T as the B fragments of S^T = K q^T, one pair of
  // registers a 16-feature k-step (query head g of this lane; 0 past group).
  // The k-step's 16 positions are the features 16kk..16kk+15 in the order
  // the K fragments take them: ldmatrix's for bf16 (position 2c + e is
  // feature 2c + e), and for int8, where each thread reads K's 4 bytes
  // 16kk + 4c..4c+3, positions 2c, 2c+1, 2c+8, 2c+9 are features 4c..4c+3.
  unsigned qb[kMaxHeadDim / 16][2];
  if constexpr (P::kMma) {
#pragma unroll
    for (int kk = 0; kk < kMaxHeadDim / 16; ++kk) {
      qb[kk][0] = qb[kk][1] = 0u;
      if (g < group && kk * 16 < head_dim) {
        const unsigned* qw = reinterpret_cast<const unsigned*>(
            q_row + (size_t)g * head_dim + kk * 16);
        qb[kk][0] = P::kInt8 ? qw[2 * c] : qw[c];
        qb[kk][1] = P::kInt8 ? qw[2 * c + 1] : qw[4 + c];
      }
    }
  } else {
    for (int i = tid; i < group * head_dim; i += kThreads)
      q_s[i / head_dim][i % head_dim] = aiko::to_float(q_row[i]);
  }
  __syncthreads();

  // Load i of the split: its K stages, then its V stages.  Each thread
  // copies one 16-byte column chunk of every `step`-th key.
  const int step = kThreads / chunks;
  const int my_part = tid % chunks, my_key = tid / chunks;
  auto issue = [&](int index) {
    const bool is_v = index >= n_stages;
    const int stage = stage_lo + (is_v ? index - n_stages : index);
    const KVT* pool = (is_v ? v_pool : k_pool) + (size_t)head * head_dim +
                      my_part * kVec;
    unsigned char* dst = ring + (index % kStages) * kStageKeys * ld +
                         my_part * 16;
    if (my_key >= step) return;
    for (int t = my_key; t < kStageKeys; t += step) {
      const int i = stage * kStageKeys + t;   // key offset in the split
      const int key = start + i;
      const bool live = key >= lo && key <= hi;
      aiko::cp_async16(dst + t * ld,
                       pool + (live ? token_s[i] * token_stride : 0), live);
    }
  };
  const int n_loads = 2 * n_stages;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_loads) issue(i);
    aiko::cp_async_commit();
  }

  // Accumulators: the tensor-core path's O^T fragments (features x query
  // heads, 16 features a tile) or the f32 path's 8 features x heads.
  float acc[kMaxGroup][kUnit];
#pragma unroll
  for (int a = 0; a < kMaxGroup; ++a)
#pragma unroll
    for (int e = 0; e < kUnit; ++e) acc[a][e] = 0.f;
  const int units = head_dim / kUnit;
  const int lanes = P::kMma ? kWarps : kThreads / units;
  const int unit = tid % units, key_lane = tid / units;

  for (int index = 0; index < n_loads; ++index) {
    if (index + kStages - 1 < n_loads) issue(index + kStages - 1);
    aiko::cp_async_commit();
    aiko::cp_async_wait<kStages - 1>();
    __syncthreads();
    const bool scores = index < n_stages;
    const int stage = stage_lo + (scores ? index : index - n_stages);
    const unsigned char* tile = ring + (index % kStages) * kStageKeys * ld;
    if (scores) {
      if constexpr (P::kMma) {
        // ---- S^T = K q^T: warp w <-> keys 16w..16w+15 of the stage ----
        const int kb = 16 * warp;
        float s4[4] = {0.f, 0.f, 0.f, 0.f};
        const unsigned char* a_row =
            P::kInt8 ? tile + (kb + g) * ld + 4 * c
                     : tile + (kb + (lane & 15)) * ld + (lane >> 4) * 16;
#pragma unroll
        for (int kk = 0; kk < kMaxHeadDim / 16; ++kk) {
          if (kk * 16 >= head_dim) break;
          unsigned a[4];
          if constexpr (P::kInt8) {
            // Keys g and g + 8: bytes 0, 1 at positions 2c, 2c+1; 2, 3
            // at 2c+8, 2c+9 (int8 -> bf16 is exact).
            const unsigned lo =
                *reinterpret_cast<const unsigned*>(a_row + kk * 16);
            const unsigned hi = *reinterpret_cast<const unsigned*>(
                a_row + 8 * ld + kk * 16);
            a[0] = int8x2_to_bf16x2_cvt(lo, 0);
            a[1] = int8x2_to_bf16x2_cvt(hi, 0);
            a[2] = int8x2_to_bf16x2_cvt(lo, 16);
            a[3] = int8x2_to_bf16x2_cvt(hi, 16);
          } else {
            ldmatrix_x4(a, a_row + kk * 32, false);
          }
          aiko::mma_bf16_16816(s4, a[0], a[1], a[2], a[3], qb[kk][0],
                               qb[kk][1]);
        }
        // s4: (key g, heads 2c, 2c+1), (key g + 8, heads 2c, 2c+1).
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = stage * kStageKeys + kb + g + 8 * half;
          const int key = start + i;
          const bool live = key >= lo && key <= hi;
          const float scale =
              live && k_scale != nullptr ? sm_scale * ks_s[i] : sm_scale;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (2 * c + e < group)
              p_s[i][2 * c + e] =
                  live ? s4[2 * half + e] * scale : AIKO_NEG_INF;
        }
      } else {
        // ---- scores on the CUDA cores: threads 2t, 2t + 1 <-> key t ----
        const int t = tid / 2, half = tid % 2;
        const int i = stage * kStageKeys + t;
        const int key = start + i;
        float s[kMaxGroup];
#pragma unroll
        for (int a = 0; a < kMaxGroup; ++a) s[a] = 0.f;
        const unsigned char* k_row = tile + t * ld;
#pragma unroll 4
        for (int part = half; part < chunks; part += 2) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(k_row + part * 16);
          const KVT* vals = reinterpret_cast<const KVT*>(&raw);
#pragma unroll
          for (int e4 = 0; e4 < kVec; e4 += 4) {
            float kv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) kv[e] = aiko::to_float(vals[e4 + e]);
            const int d = part * kVec + e4;
#pragma unroll
            for (int a = 0; a < kMaxGroup; ++a) {
              if (a < group) {
                const float4 qv =
                    *reinterpret_cast<const float4*>(&q_s[a][d]);
                s[a] = fmaf(qv.x, kv[0], s[a]);
                s[a] = fmaf(qv.y, kv[1], s[a]);
                s[a] = fmaf(qv.z, kv[2], s[a]);
                s[a] = fmaf(qv.w, kv[3], s[a]);
              }
            }
          }
        }
        const bool live = key >= lo && key <= hi;
        const float scale =
            live && k_scale != nullptr ? sm_scale * ks_s[i] : sm_scale;
#pragma unroll
        for (int a = 0; a < kMaxGroup; ++a) {
          s[a] += __shfl_xor_sync(0xffffffffu, s[a], 1);
          if (half == 0 && a < group)
            p_s[i][a] = live ? s[a] * scale : AIKO_NEG_INF;
        }
      }
      if (index == n_stages - 1) {
        __syncthreads();
        // ---- the split's softmax: warp w <-> heads w, w + 4 ----
        const int i_lo = lo - start, i_hi = hi - start;
        for (int a = warp; a < group; a += kWarps) {
          float big = AIKO_NEG_INF;
          for (int j = i_lo + lane; j <= i_hi; j += 32)
            big = fmaxf(big, p_s[j][a]);
          big = aiko::warp_max(big);
          float total = 0.f;
          for (int j = i_lo + lane; j <= i_hi; j += 32) {
            const float p = __expf(p_s[j][a] - big);
            total += p;
            p_s[j][a] = k_scale != nullptr ? p * vs_s[j] : p;
          }
          total = aiko::warp_sum(total);
          if (lane == 0) {
            m_s[a] = big;
            l_s[a] = total;
          }
        }
      }
    } else if constexpr (P::kMma) {
      // ---- O^T += V^T P^T: warp w <-> its 16 keys of the stage ----
      const int kb = 16 * warp;
      const int i0 = stage * kStageKeys + kb;
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 2 * c + (e & 1) + 8 * (e >> 1);
        const int key = start + i;
        w[e] = key >= lo && key <= hi && g < group ? p_s[i][g] : 0.f;
      }
      const unsigned b0 = aiko::pack_bf16x2(w[0], w[1]);
      const unsigned b1 = aiko::pack_bf16x2(w[2], w[3]);
      const int mi = lane >> 3;
      const unsigned char* v_row =
          P::kInt8 ? tile + (kb + 2 * c) * ld + 2 * g
                   : tile + (kb + (lane & 7) + 8 * (mi >> 1)) * ld +
                         (mi & 1) * 16;
#pragma unroll
      for (int mt = 0; mt < kMaxHeadDim / 16; ++mt) {
        if (mt * 16 >= head_dim) break;
        unsigned a[4];
        if constexpr (P::kInt8) {
          // Rows g and g + 8 of the tile are features 16mt + 2g and + 1:
          // each thread reads those two bytes of keys 2c, 2c+1, 2c+8, 2c+9.
          const unsigned char* at = v_row + mt * 16;
          const unsigned k0 = *reinterpret_cast<const unsigned short*>(at);
          const unsigned k1 =
              *reinterpret_cast<const unsigned short*>(at + ld);
          const unsigned k8 =
              *reinterpret_cast<const unsigned short*>(at + 8 * ld);
          const unsigned k9 =
              *reinterpret_cast<const unsigned short*>(at + 9 * ld);
          a[0] = int8x2_to_bf16x2_cvt(k0 | k1 << 16, 0, 16);
          a[1] = int8x2_to_bf16x2_cvt(k0 | k1 << 16, 8, 24);
          a[2] = int8x2_to_bf16x2_cvt(k8 | k9 << 16, 0, 16);
          a[3] = int8x2_to_bf16x2_cvt(k8 | k9 << 16, 8, 24);
        } else {
          ldmatrix_x4(a, v_row + mt * 32, true);
        }
        float d4[4] = {acc[mt][0], acc[mt][1], acc[mt][2], acc[mt][3]};
        aiko::mma_bf16_16816(d4, a[0], a[1], a[2], a[3], b0, b1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][e] = d4[e];
      }
    } else if (key_lane < lanes) {
      // ---- values on the CUDA cores: thread <-> 8 features, a key lane ----
      for (int t = key_lane; t < kStageKeys; t += lanes) {
        const int i = stage * kStageKeys + t;
        const int key = start + i;
        if (key < lo || key > hi) continue;
        float v[kUnit];
        load8<KVT>(tile + t * ld + unit * kUnit * kElem, v);
        const float4 p0 = *reinterpret_cast<const float4*>(&p_s[i][0]);
        const float4 p1 = *reinterpret_cast<const float4*>(&p_s[i][4]);
        const float p[kMaxGroup] = {p0.x, p0.y, p0.z, p0.w,
                                    p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int a = 0; a < kMaxGroup; ++a)
          if (a < group)
#pragma unroll
            for (int e = 0; e < kUnit; ++e)
              acc[a][e] = fmaf(p[a], v[e], acc[a][e]);
      }
    }
    __syncthreads();  // this stage is refilled kStages - 1 loads from now
  }
  aiko::cp_async_wait<0>();
  __syncthreads();

  // ---- the lanes' (warps') sums, in lane order ----
  float* sums = reinterpret_cast<float*>(ring);   // [lane][group][head_dim]
  if constexpr (P::kMma) {
    // acc[mt][0..3]: (row g, heads 2c, 2c+1), (row g + 8, same heads);
    // rows g, g + 8 are features 16mt + g, + 8 (bf16) or 16mt + 2g, + 1
    // (int8).
#pragma unroll
    for (int mt = 0; mt < kMaxHeadDim / 16; ++mt) {
      if (mt * 16 >= head_dim) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int a = 2 * c + (e & 1);
        const int feature = P::kInt8 ? 16 * mt + 2 * g + (e >> 1)
                                     : 16 * mt + g + 8 * (e >> 1);
        if (a < group)
          sums[((size_t)warp * group + a) * head_dim + feature] = acc[mt][e];
      }
    }
  } else if (key_lane < lanes) {
#pragma unroll
    for (int a = 0; a < kMaxGroup; ++a)
      if (a < group)
#pragma unroll
        for (int e = 0; e < kUnit; ++e)
          sums[((size_t)key_lane * group + a) * head_dim + unit * kUnit + e] =
              acc[a][e];
  }
  __syncthreads();
  QT* o_row = out + (size_t)pair * group * head_dim;
  const int n_splits = gridDim.y;
  const size_t stride = (size_t)n_splits * group * (head_dim + 2);
  float* part = partials + (size_t)pair * stride;
  float* part_m = part;
  float* part_l = part + n_splits * group;
  float* part_acc = part + 2 * n_splits * group;
  for (int i = tid; i < group * head_dim; i += kThreads) {
    float value = 0.f;
    for (int kl = 0; kl < lanes; ++kl)
      value += sums[(size_t)kl * group * head_dim + i];
    const int a = i / head_dim;
    if (n_live == 1) {
      const float denom = l_s[a] == 0.f ? 1.f : l_s[a];
      o_row[i] = aiko::from_float<QT>(value / denom);
    } else {
      part_acc[(size_t)split * group * head_dim + i] = value;
    }
  }
  if (n_live == 1) return;

  // ---- several live splits: publish partials, the last CTA merges ----
  if (tid < group) {
    part_m[split * group + tid] = m_s[tid];
    part_l[split * group + tid] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_flag = atomicAdd(arrivals + pair, 1) == n_live - 1;
  __syncthreads();
  if (!last_flag) return;
  __threadfence();
  const int last_split = first_split + n_live - 1;
  for (int i = tid; i < group * head_dim; i += kThreads) {
    const int a = i / head_dim;
    float big = AIKO_NEG_INF;
    for (int sp = first_split; sp <= last_split; ++sp)
      big = fmaxf(big, __ldcg(part_m + sp * group + a));
    float total = 0.f, value = 0.f;
    for (int sp = first_split; sp <= last_split; ++sp) {
      const float w = __expf(__ldcg(part_m + sp * group + a) - big);
      total += w * __ldcg(part_l + sp * group + a);
      value += w * __ldcg(part_acc + (size_t)sp * group * head_dim + i);
    }
    const float denom = total == 0.f ? 1.f : total;
    o_row[i] = aiko::from_float<QT>(value / denom);
  }
  if (tid == 0) arrivals[pair] = 0;  // ready for the next launch
}

template <typename QT, typename KVT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* positions, void* out,
                   void* partials, void* arrivals, int batch, int kv_heads,
                   int group, int head_dim, int block_size, int max_blocks,
                   int window, float sm_scale, cudaStream_t stream) {
  const int smem = (int)smem_bytes<QT, KVT>(head_dim, group);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<QT, KVT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int split_keys = split_keys_for(block_size);
  const int n_splits = (max_blocks * block_size + split_keys - 1) / split_keys;
  dim3 grid(batch * kv_heads, n_splits);
  err = aiko::launch_dependent(
      paged_decode_kernel<QT, KVT>, grid, dim3(kThreads), smem, stream,
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<QT*>(out),
      static_cast<float*>(partials), static_cast<int*>(arrivals), kv_heads,
      group, head_dim, block_size, max_blocks, window, sm_scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k_pool,
                        const void* v_pool, const void* k_scale,
                        const void* v_scale, const void* tables,
                        const void* positions, void* out, void* partials,
                        void* arrivals, int batch, int kv_heads, int group,
                        int head_dim, int block_size, int max_blocks,
                        int window, float sm_scale, cudaStream_t stream) {
  if (kv_dtype == AIKO_I8)
    return launch<QT, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables,
                              positions, out, partials, arrivals, batch,
                              kv_heads, group, head_dim, block_size,
                              max_blocks, window, sm_scale, stream);
  if (kv_dtype == AIKO_BF16)
    return launch<QT, __nv_bfloat16>(
        q, k_pool, v_pool, nullptr, nullptr, tables, positions, out,
        partials, arrivals, batch, kv_heads, group, head_dim, block_size,
        max_blocks, window, sm_scale, stream);
  if (kv_dtype == AIKO_F32)
    return launch<QT, float>(q, k_pool, v_pool, nullptr, nullptr, tables,
                             positions, out, partials, arrivals, batch,
                             kv_heads, group, head_dim, block_size,
                             max_blocks, window, sm_scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (batch, kv_heads, group, head_dim) and out in `q_dtype`; pools
// (n_blocks, block_size, kv_heads, head_dim) in `kv_dtype`; scales
// (n_blocks, block_size, kv_heads) f32 (int8 pools only); tables
// (batch, max_blocks) and positions (batch,) int32; partials f32 scratch of
// batch * kv_heads * splits * group * (head_dim + 2) floats, splits =
// ceil(max_blocks * block_size / split_keys_for(block_size)) (mirrored by
// ops/paged_attention.py::decode_split_keys), and arrivals (batch *
// kv_heads) int32 zeros, which the kernel leaves zero.
// window <= 0 = none.  Needs group <= 8, block_size <= 128, head_dim <= 128
// with head_dim % 16 == 0, and contiguous 16-byte-aligned pools.
extern "C" int aiko_paged_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* tables,
                                 const void* positions, void* out,
                                 void* partials, void* arrivals, int batch,
                                 int kv_heads, int group, int head_dim,
                                 int block_size, int max_blocks, int window,
                                 float sm_scale, int q_dtype, int kv_dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group < 1 || group > kMaxGroup || block_size < 1 || block_size > 128 ||
      head_dim > kMaxHeadDim || head_dim < 16 || head_dim % 16 != 0)
    return cudaErrorInvalidValue;
  if (q_dtype == AIKO_BF16)
    return dispatch_kv<__nv_bfloat16>(
        kv_dtype, q, k_pool, v_pool, k_scale, v_scale, tables, positions, out,
        partials, arrivals, batch, kv_heads, group, head_dim, block_size,
        max_blocks, window, sm_scale, st);
  if (q_dtype == AIKO_F32)
    return dispatch_kv<float>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale,
                              tables, positions, out, partials, arrivals,
                              batch, kv_heads, group, head_dim, block_size,
                              max_blocks, window, sm_scale, st);
  return cudaErrorInvalidValue;
}
