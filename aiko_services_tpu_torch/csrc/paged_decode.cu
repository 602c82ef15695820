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
//     online softmax in VMEM; on 132 SMs that would leave 64 CTAs for 8
//     slots x 8 kv heads.  Here one CTA owns (row, kv head, live block):
//     CTAs of blocks outside [first_live, last_live] (past the position or
//     below the window) exit at once, so traffic stays O(row length);
//   * all `group` query heads of the kv head share the CTA, so each K/V row
//     is read once for the whole group (GQA-native); the CTA reads its own
//     block id from the table (there is no scalar prefetch on the GPU);
//   * the block's K and V rows land in shared memory with coalesced 16-byte
//     cp.async copies (rows padded by 16 bytes: conflict-free reads);
//     scores: thread t owns key t, q is read from shared memory as float4
//     broadcasts, int8 K is scaled after the dot; values: thread d owns
//     feature d, with int8 V's scale folded into each key's weight;
//   * each CTA keeps its block's max, sum and weighted values in f32; a row
//     with one live block writes its output directly, otherwise every CTA
//     publishes its partials and the last one of the row to arrive merges
//     them in block order (log-sum-exp), so the result does not depend on
//     timing.  NEG_INF is the JAX package's finite value; a zero sum
//     divides by 1.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // >= block_size and >= head_dim (<= 128)
constexpr int kMaxGroup = 8;
constexpr int kWarps = kThreads / 32;

int tile_bytes(int block_size, int head_dim, int elem) {
  return block_size * (head_dim * elem + 16);
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
  extern __shared__ __align__(16) unsigned char tiles[];
  __shared__ __align__(16) float q_s[kMaxGroup][128];
  __shared__ float p_s[kMaxGroup][128];   // softmax weights (x V scale)
  __shared__ float red_s[kWarps][kMaxGroup];
  __shared__ float m_s[kMaxGroup];
  __shared__ int last_flag;

  constexpr int kElem = (int)sizeof(KVT);
  constexpr int kVec = 16 / kElem;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int pair = blockIdx.x;              // row * kv_heads + head
  const int row = pair / kv_heads, head = pair % kv_heads;
  const int j = blockIdx.y;                 // logical block of the row
  const int pos = positions[row];
  int first_live = 0;
  if (window > 0) first_live = max(pos - window + 1, 0) / block_size;
  const int last_live = min(pos / block_size, max_blocks - 1);
  if (j < first_live || j > last_live) return;
  const int n_live = last_live - first_live + 1;
  const int split = j - first_live;

  const int ld = head_dim * kElem + 16;     // padded row, bytes
  const size_t token_stride = (size_t)kv_heads * head_dim;
  const int blk = tables[(size_t)row * max_blocks + j];
  {
    unsigned char* k_dst = tiles;
    unsigned char* v_dst = tiles + block_size * ld;
    const size_t base = (size_t)blk * block_size * token_stride +
                        (size_t)head * head_dim;
    const int chunks = head_dim / kVec;
    for (int c = tid; c < block_size * chunks; c += kThreads) {
      const int t = c / chunks, part = c % chunks;
      const size_t src = base + (size_t)t * token_stride + part * kVec;
      aiko::cp_async16(k_dst + t * ld + part * 16, k_pool + src, true);
      aiko::cp_async16(v_dst + t * ld + part * 16, v_pool + src, true);
    }
    aiko::cp_async_commit();
  }
  const QT* q_row = q + (size_t)pair * group * head_dim;
  for (int i = tid; i < group * head_dim; i += kThreads)
    q_s[i / head_dim][i % head_dim] = aiko::to_float(q_row[i]);
  aiko::cp_async_wait<0>();
  __syncthreads();

  // ---- scores: thread t <-> key t of the block ----
  float s[kMaxGroup];
  const int key = j * block_size + tid;
  const bool in_block = tid < block_size;
  bool visible = in_block && key <= pos;
  if (window > 0) visible = visible && key > pos - window;
  float v_scale_t = 1.f;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) s[g] = AIKO_NEG_INF;
  if (in_block) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) s[g] = 0.f;
    const unsigned char* k_row = tiles + tid * ld;
    for (int d0 = 0; d0 < head_dim; d0 += kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(k_row + d0 * kElem);
      const KVT* vals = reinterpret_cast<const KVT*>(&raw);
#pragma unroll
      for (int e4 = 0; e4 < kVec; e4 += 4) {
        float kv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) kv[e] = aiko::to_float(vals[e4 + e]);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < group) {
            const float4 qv =
                *reinterpret_cast<const float4*>(&q_s[g][d0 + e4]);
            s[g] = fmaf(qv.x, kv[0], s[g]);
            s[g] = fmaf(qv.y, kv[1], s[g]);
            s[g] = fmaf(qv.z, kv[2], s[g]);
            s[g] = fmaf(qv.w, kv[3], s[g]);
          }
        }
      }
    }
    float scale = sm_scale;
    if (k_scale != nullptr) {
      const size_t at = ((size_t)blk * block_size + tid) * kv_heads + head;
      scale *= k_scale[at];
      v_scale_t = v_scale[at];
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      s[g] = visible ? s[g] * scale : AIKO_NEG_INF;
  }

  // ---- softmax over the block: max, weights, sum ----
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g >= group) break;
    const float bmax = aiko::warp_max(s[g]);
    if (lane == 0) red_s[warp][g] = bmax;
  }
  __syncthreads();
  if (tid < group) {
    float bmax = red_s[0][tid];
    for (int w = 1; w < kWarps; ++w) bmax = fmaxf(bmax, red_s[w][tid]);
    m_s[tid] = bmax;
  }
  __syncthreads();
  float l_local[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    l_local[g] = 0.f;
    if (g >= group) continue;
    const float p = in_block ? __expf(s[g] - m_s[g]) : 0.f;
    if (in_block) p_s[g][tid] = p * v_scale_t;
    l_local[g] = aiko::warp_sum(p);
  }
  __syncthreads();  // p_s complete; red_s free again
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
    if (g < group && lane == 0) red_s[warp][g] = l_local[g];

  // ---- values: thread d <-> feature d ----
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
  if (tid < head_dim) {
    const unsigned char* v_col = tiles + block_size * ld + tid * kElem;
#pragma unroll 4
    for (int t = 0; t < block_size; ++t) {
      const float v =
          aiko::to_float(*reinterpret_cast<const KVT*>(v_col + t * ld));
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) acc[g] = fmaf(p_s[g][t], v, acc[g]);
    }
  }
  __syncthreads();  // red_s holds the per-warp sums
  float l[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    l[g] = 0.f;
    if (g < group)
      for (int w = 0; w < kWarps; ++w) l[g] += red_s[w][g];
  }

  QT* o_row = out + (size_t)pair * group * head_dim;
  if (n_live == 1) {
    if (tid < head_dim) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g >= group) break;
        const float denom = l[g] == 0.f ? 1.f : l[g];
        o_row[g * head_dim + tid] = aiko::from_float<QT>(acc[g] / denom);
      }
    }
    return;
  }

  // ---- several live blocks: publish partials, the last CTA merges ----
  // Per (row, head): [max_blocks][group] maxima, [max_blocks][group] sums,
  // then [max_blocks][group][head_dim] weighted values.
  const size_t stride = (size_t)max_blocks * group * (head_dim + 2);
  float* part = partials + (size_t)pair * stride;
  float* part_m = part;
  float* part_l = part + max_blocks * group;
  float* part_acc = part + 2 * max_blocks * group;
  if (tid < head_dim) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group)
        part_acc[((size_t)split * group + g) * head_dim + tid] = acc[g];
  }
  if (tid < group) {
    part_m[split * group + tid] = m_s[tid];
    part_l[split * group + tid] = l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_flag = atomicAdd(arrivals + pair, 1) == n_live - 1;
  __syncthreads();
  if (!last_flag) return;
  __threadfence();
  if (tid < head_dim) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= group) break;
      float big = AIKO_NEG_INF;
      for (int sp = 0; sp < n_live; ++sp)
        big = fmaxf(big, __ldcg(part_m + sp * group + g));
      float total = 0.f, value = 0.f;
      for (int sp = 0; sp < n_live; ++sp) {
        const float w = __expf(__ldcg(part_m + sp * group + g) - big);
        total += w * __ldcg(part_l + sp * group + g);
        value += w * __ldcg(part_acc + ((size_t)sp * group + g) * head_dim +
                            tid);
      }
      const float denom = total == 0.f ? 1.f : total;
      o_row[g * head_dim + tid] = aiko::from_float<QT>(value / denom);
    }
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
  const int smem = 2 * tile_bytes(block_size, head_dim, (int)sizeof(KVT));
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<QT, KVT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * kv_heads, max_blocks);
  paged_decode_kernel<QT, KVT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<QT*>(out),
      static_cast<float*>(partials), static_cast<int*>(arrivals), kv_heads,
      group, head_dim, block_size, max_blocks, window, sm_scale);
  return cudaGetLastError();
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
// batch * kv_heads * max_blocks * group * (head_dim + 2) floats and
// arrivals (batch * kv_heads) int32 zeros, which the kernel leaves zero.
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
  if (group < 1 || group > kMaxGroup || block_size < 1 ||
      block_size > kThreads || head_dim > kThreads || head_dim % 16 != 0)
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
