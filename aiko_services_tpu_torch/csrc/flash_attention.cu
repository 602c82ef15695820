// Causal (optionally sliding-window) flash attention with native GQA, bf16.
//
// Replaces: aiko_services_tpu/ops/attention.py::flash_attention, the Pallas
// kernel `_flash_kernel` (attention.py:76, pallas_call at attention.py:231).
//
// Bound on the H100: operations.  Causal prefill at the main path's buckets
// (64..1024 tokens, head_dim 128) does ~4*head_dim operations per visible
// (query, key) pair on inputs it reads once, far above the bytes line.
//
// Design against that bound:
//   * the TPU grid (b*h, q_blocks, k_blocks) carried m/l/acc across its
//     sequential k axis; here one CTA owns (b*h, 64-query tile) and loops
//     over 64-key tiles itself, from the first live tile (window) to the last
//     live one (diagonal), so tiles above the diagonal or below the window
//     are never loaded;
//   * query head h reads kv head h / group directly: K/V are never repeated;
//   * both products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulate): each of 4 warps owns 16 query rows, keeps its Q fragments
//     in registers, computes S = Q K^T for the tile, and multiplies its P
//     (the f32 softmax weights rounded to bf16) with V loaded by
//     ldmatrix.trans;
//   * K/V tiles are double-buffered in shared memory with 16-byte cp.async
//     copies (rows padded by 16 bytes: conflict-free fragment loads);
//   * the online softmax (running max, sum, rescale) stays in f32 registers,
//     with the finite NEG_INF of the JAX kernel; keys past k_len get -inf so
//     they carry no mass; rows with a zero sum divide by 1.  Keys are offset
//     by k_len - q_len.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kBQ = 64;
constexpr int kBK = 64;

// Q tile plus two stages of K and V tiles, rows padded by 16 bytes.
size_t smem_bytes(int head_dim) {
  return (size_t)(kBQ + 4 * kBK) * (head_dim * 2 + 16);
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int heads, int kv_heads, int q_len, int k_len, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, int causal,
    int window, float sm_scale) {
  constexpr int kLd = HD * 2 + 16;     // padded row, bytes
  constexpr int kTile = kBK * kLd;
  constexpr int kChunks = HD / 8;      // 16-byte chunks a row
  constexpr int kDT = HD / 8;          // output n-tiles (8 features each)
  constexpr int kKT = HD / 16;         // k-steps over the head dim
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* kv_s = smem + kBQ * kLd;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = blockIdx.x * kBQ;
  const int offset = k_len - q_len;  // query i sits at key position i+offset

  const __nv_bfloat16* q_base = q + b * qsb + h * qsh;
  const __nv_bfloat16* k_base = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* v_base = v + b * vsb + kvh * vsh;

  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    const int qi = q0 + r;
    const bool ok = qi < q_len;
    aiko::cp_async16(q_s + r * kLd + ch * 16,
                     q_base + (ok ? qi : 0) * qss + ch * 8, ok);
  }

  const int n_tiles_all = (k_len + kBK - 1) / kBK;
  int t_begin = 0, t_end = n_tiles_all - 1;
  if (causal) {
    const int q_first = q0 + offset;
    t_end = min(t_end, (q_first + kBQ - 1) / kBK);
    if (window > 0) t_begin = max(q_first - window + 1, 0) / kBK;
  }
  const int n_tiles = t_end - t_begin + 1;

  auto issue = [&](int index) {
    const int k0 = (t_begin + index) * kBK;
    unsigned char* ks = kv_s + (index & 1) * 2 * kTile;
    unsigned char* vs = ks + kTile;
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks, ch = i % kChunks;
      const int kj = k0 + r;
      const bool ok = kj < k_len;
      aiko::cp_async16(ks + r * kLd + ch * 16,
                       k_base + (ok ? kj : 0) * kss + ch * 8, ok);
      aiko::cp_async16(vs + r * kLd + ch * 16,
                       v_base + (ok ? kj : 0) * vss + ch * 8, ok);
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
  const int row0 = 16 * warp + g;  // this thread's rows: row0, row0 + 8

  if (n_tiles > 0) issue(0);
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      issue(i + 1);
      aiko::cp_async_wait<1>();
    } else {
      aiko::cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0) {
      const unsigned char* r0 = q_s + row0 * kLd;
      const unsigned char* r1 = r0 + 8 * kLd;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        const int col = (16 * kk + 2 * c) * 2;
        qf[kk][0] = *reinterpret_cast<const unsigned*>(r0 + col);
        qf[kk][1] = *reinterpret_cast<const unsigned*>(r1 + col);
        qf[kk][2] = *reinterpret_cast<const unsigned*>(r0 + col + 16);
        qf[kk][3] = *reinterpret_cast<const unsigned*>(r1 + col + 16);
      }
    }
    const unsigned char* ks = kv_s + (i & 1) * 2 * kTile;
    const unsigned char* vs = ks + kTile;
    const int k0 = (t_begin + i) * kBK;

    // S = Q K^T for 64 keys: 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const unsigned char* krow = ks + (nt * 8 + g) * kLd;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        const int col = (16 * kk + 2 * c) * 2;
        aiko::mma_bf16_16816(
            s[nt], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
            *reinterpret_cast<const unsigned*>(krow + col),
            *reinterpret_cast<const unsigned*>(krow + col + 16));
      }
    }

    // Scale and mask; element e of n-tile nt is (row row0 + 8*(e>>1),
    // key k0 + 8*nt + 2c + (e&1)).
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * nt + 2 * c + (e & 1);
        const int qpos = q0 + row0 + 8 * (e >> 1) + offset;
        float val = s[nt][e] * sm_scale;
        if (key >= k_len) {
          val = -INFINITY;
        } else if (causal) {
          bool visible = key <= qpos;
          if (window > 0) visible = visible && key > qpos - window;
          if (!visible) val = AIKO_NEG_INF;
        }
        s[nt][e] = val;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], val);
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
        const float p = __expf(s[nt][e] - m_i[e >> 1]);
        s[nt][e] = p;
        row_sum[e >> 1] += p;
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
      const unsigned char* vrow = vs + (16 * kk + (lane & 15)) * kLd +
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
    __syncthreads();  // this stage is refilled two tiles from now
  }

  float denom[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_i[rr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    denom[rr] = l == 0.f ? 1.f : l;
  }
  __nv_bfloat16* o_base = out + (size_t)bh * q_len * HD;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qi = q0 + row0 + 8 * rr;
    if (qi >= q_len) continue;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const unsigned pair = aiko::pack_bf16x2(o[dt][2 * rr] / denom[rr],
                                              o[dt][2 * rr + 1] / denom[rr]);
      *reinterpret_cast<unsigned*>(o_base + (size_t)qi * HD + 8 * dt +
                                   2 * c) = pair;
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int heads, int kv_heads, int q_len, int k_len,
                   const long long* st, int causal, int window,
                   float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((q_len + kBQ - 1) / kBQ, batch * heads);
  flash_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      heads, kv_heads, q_len, k_len, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], causal, window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q (batch, heads, q_len, head_dim), k/v (batch, kv_heads, k_len, head_dim),
// bf16, with element strides {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s}
// (the feature axis contiguous, every stride a multiple of 8, 16-byte
// aligned bases); out contiguous (batch, heads, q_len, head_dim) bf16.
// window <= 0 = none.  head_dim is 16, 32, 64 or 128; heads % kv_heads ==
// 0; causal callers have q_len <= k_len.
extern "C" int aiko_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int heads, int kv_heads, int q_len,
                                    int k_len, int head_dim,
                                    const long long* strides, int causal,
                                    int window, float sm_scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads % kv_heads != 0 || (causal && q_len > k_len))
    return cudaErrorInvalidValue;
  switch (head_dim) {
    case 16:
      return launch<16>(q, k, v, out, batch, heads, kv_heads, q_len, k_len,
                        strides, causal, window, sm_scale, st);
    case 32:
      return launch<32>(q, k, v, out, batch, heads, kv_heads, q_len, k_len,
                        strides, causal, window, sm_scale, st);
    case 64:
      return launch<64>(q, k, v, out, batch, heads, kv_heads, q_len, k_len,
                        strides, causal, window, sm_scale, st);
    case 128:
      return launch<128>(q, k, v, out, batch, heads, kv_heads, q_len, k_len,
                         strides, causal, window, sm_scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
