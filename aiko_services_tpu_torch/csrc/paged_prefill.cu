// Paged chunk attention: a prefill chunk's queries over the row's cached
// prefix blocks plus the causally visible part of the chunk, K/V read
// straight from the block pool (bf16, or int8 with per-(token, head) scales).
//
// Replaces: aiko_services_tpu/ops/paged_prefill.py::_chunk_attention, the
// Pallas kernel `_prefill_attention_kernel` (paged_prefill.py:281,
// pallas_call at paged_prefill.py:424).
//
// Bound on the H100: bytes for short chunks over a long prefix, operations
// for long chunks.  The live K/V rows must be read once per kv head (plus q
// and out); the work is 4*head_dim operations per visible (query head, key)
// pair.  At T = 256 over 1,024 cached tokens the two terms are of one order.
//
// Design against that bound:
//   * GQA-native, as the TPU kernel's `token*group + head` row layout: one
//     CTA owns (row, kv head, 64 tile rows), the tile rows being the
//     (token, query head) pairs of that kv head, so each K/V tile is loaded
//     once for all `group` heads.  The TPU grid's sequential kv axis becomes
//     the CTA's own loop over 64-key tiles;
//   * the loop walks only the live keys: from the first key inside the
//     window of the tile's first query to the tile's last query (trimmed to
//     the chunk's real length and to kv_limit), so dead blocks are never
//     read.  Each of a tile's 64 key rows is fetched from its own pool block
//     (tables[row, key / block_size]) by 16-byte cp.async copies, double
//     buffered: four 16-row pool blocks land in one tile, no gather;
//   * both products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate), FA2-style as csrc/flash_attention.cu: Q fragments in
//     registers, P reused as the A operand, V through ldmatrix.trans.  int8
//     K/V are converted to bf16 in shared memory (exact); K's scale
//     multiplies the score, V's scale folds into P before it is rounded;
//   * masking by absolute ids: key <= query position, and inside the
//     window.  A multi-query tile CAN hold rows with no visible key in a
//     live tile (a later chunk row's first block, or a window that slid
//     past), so the mask is applied as an explicit zero of the probability
//     (the running max reads visible scores only); a row whose sum stays 0
//     divides by 1.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 128;  // 4 warps x 16 tile rows
constexpr int kRows = 64;      // tile rows: (token, query head) pairs
constexpr int kBK = 64;        // keys per tile

template <int HD, typename KVT>
struct Layout {
  static constexpr int kLd = HD * 2 + 16;  // bf16 row, bytes, padded
  static constexpr int kLdRaw = HD * (int)sizeof(KVT) + 16;  // staged row
  static constexpr bool kConvert = sizeof(KVT) == 1;
  static constexpr int kStage = 2 * kBK * kLdRaw;  // K and V of one tile
  static constexpr size_t kSmem =
      (size_t)kRows * kLd + 2 * kStage + (kConvert ? 2 * kBK * kLd : 0);
};

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int HD, typename KVT>
__global__ void __launch_bounds__(kThreads) chunk_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ cached_lens, const int* __restrict__ chunk_lens,
    __nv_bfloat16* __restrict__ out, int T, int kv_heads, int group,
    int block_size, int max_blocks, int kv_blocks, int window,
    float sm_scale) {
  using L = Layout<HD, KVT>;
  constexpr int kLd = L::kLd;
  constexpr int kLdRaw = L::kLdRaw;
  constexpr int kChunks = HD / 8;                         // q row, 16 B each
  constexpr int kRawChunks = HD * (int)sizeof(KVT) / 16;  // pool row
  constexpr int kDT = HD / 8;   // output n-tiles (8 features each)
  constexpr int kKT = HD / 16;  // k-steps over the head dim
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* stage = smem + kRows * kLd;
  unsigned char* conv = stage + 2 * L::kStage;  // int8 pools only
  __shared__ float ks_s[kBK];
  __shared__ float vs_s[kBK];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * kRows;  // first tile row: token * group + head
  const int rows_total = T * group;
  const int cached = cached_lens[b];
  const int chunk = chunk_lens[b];
  const size_t token_stride = (size_t)kv_heads * HD;  // pool row of a key
  const int* table = tables + (size_t)b * max_blocks;

  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    const int row = r0 + r;
    const bool ok = row < rows_total;
    const int token = ok ? row / group : 0, head = ok ? row % group : 0;
    const __nv_bfloat16* src =
        q + ((((size_t)b * T + token) * kv_heads + h) * group + head) * HD +
        ch * 8;
    aiko::cp_async16(q_s + r * kLd + ch * 16, src, ok);
  }

  // Live keys of the tile: [key_lo, key_hi].
  const int tok_first = r0 / group;
  const int tok_last = min((r0 + kRows - 1) / group, T - 1);
  int key_hi = cached + tok_last;
  key_hi = min(key_hi, cached + chunk - 1);
  key_hi = min(key_hi, kv_blocks * block_size - 1);
  int key_lo = 0;
  if (window > 0) key_lo = max(cached + tok_first - window + 1, 0);
  const int t_begin = key_lo / kBK;
  const int n_tiles = key_hi >= key_lo ? key_hi / kBK - t_begin + 1 : 0;

  auto issue = [&](int index) {
    const int k0 = (t_begin + index) * kBK;
    unsigned char* ks = stage + (index & 1) * L::kStage;
    unsigned char* vs = ks + kBK * kLdRaw;
    for (int i = tid; i < kBK * kRawChunks; i += kThreads) {
      const int r = i / kRawChunks, ch = i % kRawChunks;
      const int key = k0 + r;
      const bool ok = key <= key_hi;
      const int blk = ok ? table[key / block_size] : 0;
      const size_t src = ((size_t)blk * block_size + (ok ? key % block_size
                                                         : 0)) *
                             token_stride +
                         (size_t)h * HD + ch * (16 / (int)sizeof(KVT));
      aiko::cp_async16(ks + r * kLdRaw + ch * 16, k_pool + src, ok);
      aiko::cp_async16(vs + r * kLdRaw + ch * 16, v_pool + src, ok);
    }
    aiko::cp_async_commit();  // the first group also carries Q
  };

  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_i[2] = {AIKO_NEG_INF, AIKO_NEG_INF};
  float l_i[2] = {0.f, 0.f};
  unsigned qf[kKT][4];
  const int row0 = 16 * warp + g;  // this thread's tile rows: row0, row0 + 8
  int qpos[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) qpos[rr] = cached + (r0 + row0 + 8 * rr) / group;

  if (n_tiles > 0) {
    issue(0);
  } else {  // no live key (padding rows only): retire Q's copies
    aiko::cp_async_commit();
    aiko::cp_async_wait<0>();
  }
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      issue(i + 1);
      aiko::cp_async_wait<1>();
    } else {
      aiko::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = (t_begin + i) * kBK;
    const unsigned char* kt = stage + (i & 1) * L::kStage;
    const unsigned char* vt = kt + kBK * kLdRaw;
    if constexpr (L::kConvert) {
      // int8 rows -> bf16 rows (exact), and this tile's scales.
      unsigned char* kc = conv;
      unsigned char* vc = conv + kBK * kLd;
      for (int e = tid; e < kBK * HD / 4; e += kThreads) {
        const int r = e / (HD / 4), c4 = (e % (HD / 4)) * 4;
        const char4 kq = *reinterpret_cast<const char4*>(kt + r * kLdRaw + c4);
        const char4 vq = *reinterpret_cast<const char4*>(vt + r * kLdRaw + c4);
        unsigned* kd = reinterpret_cast<unsigned*>(kc + r * kLd + c4 * 2);
        unsigned* vd = reinterpret_cast<unsigned*>(vc + r * kLd + c4 * 2);
        kd[0] = aiko::pack_bf16x2((float)kq.x, (float)kq.y);
        kd[1] = aiko::pack_bf16x2((float)kq.z, (float)kq.w);
        vd[0] = aiko::pack_bf16x2((float)vq.x, (float)vq.y);
        vd[1] = aiko::pack_bf16x2((float)vq.z, (float)vq.w);
      }
      if (tid < kBK) {
        const int key = k0 + tid;
        float ksc = 1.f, vsc = 0.f;
        if (key <= key_hi) {
          const size_t at =
              ((size_t)table[key / block_size] * block_size +
               key % block_size) * kv_heads + h;
          ksc = k_scale[at];
          vsc = v_scale[at];
        }
        ks_s[tid] = ksc;
        vs_s[tid] = vsc;
      }
      __syncthreads();
      kt = kc;
      vt = vc;
    }
    if (i == 0) {
      const unsigned char* q0 = q_s + row0 * kLd;
      const unsigned char* q1 = q0 + 8 * kLd;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        const int col = (16 * kk + 2 * c) * 2;
        qf[kk][0] = *reinterpret_cast<const unsigned*>(q0 + col);
        qf[kk][1] = *reinterpret_cast<const unsigned*>(q1 + col);
        qf[kk][2] = *reinterpret_cast<const unsigned*>(q0 + col + 16);
        qf[kk][3] = *reinterpret_cast<const unsigned*>(q1 + col + 16);
      }
    }

    // S = Q K^T for 64 keys: 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const unsigned char* krow = kt + (nt * 8 + g) * kLd;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        const int col = (16 * kk + 2 * c) * 2;
        aiko::mma_bf16_16816(
            s[nt], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
            *reinterpret_cast<const unsigned*>(krow + col),
            *reinterpret_cast<const unsigned*>(krow + col + 16));
      }
    }

    // Scale; element e of n-tile nt is (tile row row0 + 8*(e>>1), key
    // k0 + 8*nt + 2c + (e&1)).  Bit nt*4+e of `visible` marks a visible
    // pair; the running max reads only those.
    unsigned visible = 0u;
    float tile_max[2] = {AIKO_NEG_INF, AIKO_NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = 8 * nt + 2 * c + (e & 1);
        const int key = k0 + kr;
        const int pos = qpos[e >> 1];
        float val = s[nt][e] * sm_scale;
        if constexpr (L::kConvert) val *= ks_s[kr];
        bool vis = key <= key_hi && key <= pos;
        if (window > 0) vis = vis && key > pos - window;
        s[nt][e] = val;
        if (vis) {
          visible |= 1u << (nt * 4 + e);
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], val);
        }
      }
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = tile_max[rr];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[rr], mx);
      corr[rr] = __expf(m_i[rr] - m_new);
      m_i[rr] = m_new;
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // The explicit zero: a masked pair carries no mass, whether or not
        // its row has seen a visible key yet.
        const float p = (visible >> (nt * 4 + e)) & 1u
                            ? __expf(s[nt][e] - m_i[e >> 1])
                            : 0.f;
        row_sum[e >> 1] += p;
        if constexpr (L::kConvert) {
          s[nt][e] = p * vs_s[8 * nt + 2 * c + (e & 1)];
        } else {
          s[nt][e] = p;
        }
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l_i[rr] = l_i[rr] * corr[rr] + row_sum[rr];
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P V: 4 k-steps of 16 keys; P's C fragments become A fragments.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned a0 = aiko::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      const unsigned a1 = aiko::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      const unsigned a2 =
          aiko::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const unsigned a3 =
          aiko::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const unsigned char* vrow = vt + (16 * kk + (lane & 15)) * kLd +
                                  (lane >> 4) * 16;
#pragma unroll
      for (int dt2 = 0; dt2 < kDT / 2; ++dt2) {
        unsigned bfrag[4];
        ldmatrix_x4_trans(bfrag, vrow + dt2 * 32);
        aiko::mma_bf16_16816(o[2 * dt2], a0, a1, a2, a3, bfrag[0],
                             bfrag[1]);
        aiko::mma_bf16_16816(o[2 * dt2 + 1], a0, a1, a2, a3, bfrag[2],
                             bfrag[3]);
      }
    }
    __syncthreads();  // this stage (and the int8 buffer) is refilled next
  }

  float denom[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_i[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    denom[rr] = l == 0.f ? 1.f : l;
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + row0 + 8 * rr;
    if (row >= rows_total) continue;
    __nv_bfloat16* o_row =
        out + ((((size_t)b * T + row / group) * kv_heads + h) * group +
               row % group) * HD;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const unsigned pair = aiko::pack_bf16x2(o[dt][2 * rr] / denom[rr],
                                              o[dt][2 * rr + 1] / denom[rr]);
      *reinterpret_cast<unsigned*>(o_row + 8 * dt + 2 * c) = pair;
    }
  }
}

template <int HD, typename KVT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* cached_lens,
                   const void* chunk_lens, void* out, int batch, int T,
                   int kv_heads, int group, int block_size, int max_blocks,
                   int kv_blocks, int window, float sm_scale,
                   cudaStream_t stream) {
  const size_t smem = Layout<HD, KVT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      chunk_attention_kernel<HD, KVT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T * group + kRows - 1) / kRows, kv_heads, batch);
  if (grid.x == 0 || batch == 0) return cudaSuccess;
  chunk_attention_kernel<HD, KVT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(cached_lens),
      static_cast<const int*>(chunk_lens),
      static_cast<__nv_bfloat16*>(out), T, kv_heads, group, block_size,
      max_blocks, kv_blocks, window, sm_scale);
  return cudaGetLastError();
}

template <typename KVT>
cudaError_t dispatch_hd(int head_dim, const void* q, const void* k_pool,
                        const void* v_pool, const void* k_scale,
                        const void* v_scale, const void* tables,
                        const void* cached_lens, const void* chunk_lens,
                        void* out, int batch, int T, int kv_heads, int group,
                        int block_size, int max_blocks, int kv_blocks,
                        int window, float sm_scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<16, KVT>(q, k_pool, v_pool, k_scale, v_scale, tables,
                             cached_lens, chunk_lens, out, batch, T,
                             kv_heads, group, block_size, max_blocks,
                             kv_blocks, window, sm_scale, stream);
    case 32:
      return launch<32, KVT>(q, k_pool, v_pool, k_scale, v_scale, tables,
                             cached_lens, chunk_lens, out, batch, T,
                             kv_heads, group, block_size, max_blocks,
                             kv_blocks, window, sm_scale, stream);
    case 64:
      return launch<64, KVT>(q, k_pool, v_pool, k_scale, v_scale, tables,
                             cached_lens, chunk_lens, out, batch, T,
                             kv_heads, group, block_size, max_blocks,
                             kv_blocks, window, sm_scale, stream);
    case 128:
      return launch<128, KVT>(q, k_pool, v_pool, k_scale, v_scale, tables,
                              cached_lens, chunk_lens, out, batch, T,
                              kv_heads, group, block_size, max_blocks,
                              kv_blocks, window, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (batch, T, kv_heads, group, head_dim) bf16 contiguous and out likewise;
// pools (n_blocks, block_size, kv_heads, head_dim) bf16, or int8 with f32
// scales (n_blocks, block_size, kv_heads); tables (batch, max_blocks),
// cached_lens and chunk_lens (batch,) int32.  The pool already holds the
// chunk.  kv_blocks <= max_blocks bounds the sweep; window <= 0 = none.
// head_dim is 16, 32, 64 or 128.
extern "C" int aiko_chunk_attention(const void* q, const void* k_pool,
                                    const void* v_pool, const void* k_scale,
                                    const void* v_scale, const void* tables,
                                    const void* cached_lens,
                                    const void* chunk_lens, void* out,
                                    int batch, int T, int kv_heads, int group,
                                    int head_dim, int block_size,
                                    int max_blocks, int kv_blocks, int window,
                                    float sm_scale, int kv_dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group < 1 || block_size < 1 || kv_blocks < 1 ||
      kv_blocks > max_blocks)
    return cudaErrorInvalidValue;
  if (kv_dtype == AIKO_I8) {
    if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
    return dispatch_hd<int8_t>(head_dim, q, k_pool, v_pool, k_scale, v_scale,
                               tables, cached_lens, chunk_lens, out, batch, T,
                               kv_heads, group, block_size, max_blocks,
                               kv_blocks, window, sm_scale, st);
  }
  if (kv_dtype == AIKO_BF16)
    return dispatch_hd<__nv_bfloat16>(
        head_dim, q, k_pool, v_pool, nullptr, nullptr, tables, cached_lens,
        chunk_lens, out, batch, T, kv_heads, group, block_size, max_blocks,
        kv_blocks, window, sm_scale, st);
  return cudaErrorInvalidValue;
}
