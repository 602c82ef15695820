// Causal (optionally sliding-window) flash attention with native GQA, bf16.
//
// Replaces: aiko_services_tpu/ops/attention.py::flash_attention, the Pallas
// kernel `_flash_kernel` (attention.py:76, pallas_call at attention.py:231).
//
// Bound on the H100: operations.  Causal prefill at the main path's buckets
// (64..1024 tokens, head_dim 128) does ~4*head_dim operations per visible
// (query, key) pair on inputs it reads once, far above the bytes line; at
// short sequences and large batches (64 rows of 128 tokens) the bytes of
// q, k, v and out come close.
//
// Design against that bound:
//   * the TPU grid (b*h, q_blocks, k_blocks) carried m/l/acc across its
//     sequential k axis; here one CTA owns (batch, kv head, kRows tile rows)
//     and loops over kBK-key tiles itself, from the first live tile (window)
//     to the last live one (diagonal), so tiles above the diagonal or below
//     the window are never loaded;
//   * GQA-packed rows, as the TPU kernel's `token*group + head` layout (and
//     csrc/paged_prefill.cu): the tile rows are the (query, head) pairs of
//     kRows / group queries and the `group` query heads of one kv head, so
//     each K/V tile lands in shared memory once for the whole group;
//   * a dedicated producer warp issues TMA loads (one 4-d tensor map each for
//     Q, K and V, built from the caller's strides with 32/64/128-byte
//     swizzle, cached host-side by pointer, shape and strides): Q once, then
//     K and V tiles into a ring of kStages stages, each K and each V with its
//     own `full` mbarrier, so S can start while V is still in flight; the
//     consumers free a K slot once its S is done and a V slot once its P V
//     is, through `empty` mbarriers;
//   * each consumer warpgroup (64 tile rows) runs both products on `wgmma`:
//     S = Q K^T as m64n64k16 with Q and K read from shared memory
//     (K-major), then O += P V as m64n{head_dim}k16 with P (the f32 softmax
//     weights rounded to bf16) from registers as A and V from shared memory
//     through the descriptor's transpose (V is key-major).  The two are
//     software-pipelined: P V of tile j - 1 runs on the tensor cores while
//     the softmax of tile j runs on the CUDA cores;
//   * the online softmax stays in f32 registers, in the log2 domain (one
//     FFMA-able subtraction and one ex2 a weight), with the masking of the
//     JAX kernel applied only to tiles that reach the diagonal, the window
//     or k_len: keys past k_len get -inf (TMA fills them with zeros),
//     invisible keys the finite NEG_INF; rows with a zero sum divide by 1.
//     Keys are offset by k_len - q_len;
//   * causal grids walk q tiles longest first (the tile index runs backwards
//     along the grid's slow axis), so the last wave holds the shortest tiles.
//     Two CTAs share an SM (about 81 KB of shared memory each at head_dim
//     128), which overlaps one's softmax with the other's wgmma.
#include "common.cuh"

#include <cuda.h>
#include <math.h>
#include <string.h>

#include <mutex>

namespace {

constexpr int kWarpgroups = 1;    // consumer warpgroups, 64 tile rows each
constexpr int kRows = 64 * kWarpgroups;  // tile rows: (query, head) pairs
constexpr int kBK = 64;           // keys a K/V tile
constexpr int kStages = 2;
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 32;   // and the producer warp

// A tile of ROWS rows of head_dim bf16 columns in shared memory: kChunks
// column chunks, each ROWS rows of kSwizzle bytes laid out as TMA's swizzle
// writes them (the canonical K-major layout of wgmma).
template <int HD, int ROWS>
struct Tile {
  static constexpr int kSwizzle = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int kChunkCols = kSwizzle / 2;
  static constexpr int kChunks = HD / kChunkCols;
  static constexpr int kChunkBytes = ROWS * kSwizzle;
  static constexpr int kBytes = kChunks * kChunkBytes;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64, 3 = 32 swizzle.
  static constexpr int kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
};

// Q, then K and V of each stage; 1 KB to align the swizzle atoms.
template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)Tile<HD, kRows>::kBytes +
         2 * kStages * (size_t)Tile<HD, kBK>::kBytes + 1024;
}

using aiko::mbar_arrive;
using aiko::mbar_expect_tx;
using aiko::mbar_init;
using aiko::mbar_wait;
using aiko::smem_u32;

// ---- TMA: a 4-d box of `map` at (c0, c1, c2, c3) into shared memory ----
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ----
using aiko::exp2_approx;
using aiko::fence_operands;
using aiko::make_desc;
using aiko::wgmma_commit;
using aiko::wgmma_fence;
using aiko::wgmma_wait;

// d (64 x N, f32) (+)= A (64 x 16, K-major in shared memory) * B (16 x N,
// K-major in shared memory), N keys; scale_d 0 overwrites d.
template <int N>
struct WgmmaSs;

template <>
struct WgmmaSs<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

// d (64 x N, f32) += A (64 x 16 bf16, registers) * B (16 x N, N-major in
// shared memory: the descriptor's transpose), scale_d 0 overwrites d.
template <int N>
struct WgmmaRs;

template <>
struct WgmmaRs<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const unsigned (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaRs<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const unsigned (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaRs<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const unsigned (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaRs<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const unsigned (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};


template <int HD>
__global__ void __launch_bounds__(kThreads, kWarpgroups == 1 ? 2 : 1)
    flash_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    __nv_bfloat16* __restrict__ out, int heads, int kv_heads, int q_len,
    int k_len, int causal, int window, float sm_scale) {
  using TQ = Tile<HD, kRows>;
  using TK = Tile<HD, kBK>;
  constexpr int kS = kBK / 2;        // score accumulators a thread
  constexpr int kKSteps = kBK / 16;  // 16-key slices of P V
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[kStages], v_full[kStages],
      k_empty[kStages], v_empty[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  auto k_tile = [&](int st) { return base + TQ::kBytes + 2 * st * TK::kBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + TK::kBytes; };

  const int group = heads / kv_heads;
  const int qpt = kRows / group;          // queries a tile
  const int rows_used = qpt * group;
  const int pair = blockIdx.x;            // batch * kv_heads + kv head
  const int b = pair / kv_heads, kvh = pair % kv_heads;
  // Causal tiles grow with their index: run the longest first.
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q_first = tile * qpt;
  const int q_last = min(q_first + qpt, q_len) - 1;
  const int offset = k_len - q_len;  // query i sits at key position i+offset
  int t_begin = 0, t_end = (k_len + kBK - 1) / kBK - 1;
  if (causal) {
    t_end = min(t_end, (q_last + offset) / kBK);
    if (window > 0) t_begin = max(q_first + offset - window + 1, 0) / kBK;
  }
  const int n_tiles = t_end - t_begin + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumers);
      mbar_init(&v_empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    if (tid == kConsumers) {
      mbar_expect_tx(&q_full, TQ::kChunks * rows_used * TQ::kSwizzle);
#pragma unroll
      for (int c = 0; c < TQ::kChunks; ++c)
        tma_load_4d(q_s + c * TQ::kChunkBytes, &q_map, &q_full,
                    c * TQ::kChunkCols, kvh * group, q_first, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const unsigned free_parity = ((j / kStages) & 1) ^ 1;
        const int k0 = (t_begin + j) * kBK;
        mbar_wait(&k_empty[st], free_parity);
        mbar_expect_tx(&k_full[st], TK::kBytes);
#pragma unroll
        for (int c = 0; c < TK::kChunks; ++c)
          tma_load_4d(k_tile(st) + c * TK::kChunkBytes, &k_map, &k_full[st],
                      c * TK::kChunkCols, k0, kvh, b);
        mbar_wait(&v_empty[st], free_parity);
        mbar_expect_tx(&v_full[st], TK::kBytes);
#pragma unroll
        for (int c = 0; c < TK::kChunks; ++c)
          tma_load_4d(v_tile(st) + c * TK::kChunkBytes, &v_map, &v_full[st],
                      c * TK::kChunkCols, k0, kvh, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns tile rows 64w..64w+63, 16 a warp ----
  const int wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int row0 = 64 * wg + 16 * warp + g;  // rows row0, row0 + 8
  const uint32_t q_wg = q_s + 64 * wg * TQ::kSwizzle;  // its Q rows
  int qpos[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    qpos[rr] = q_first + (row0 + 8 * rr) / group + offset;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_i[2] = {AIKO_NEG_INF, AIKO_NEG_INF};
  float l_i[2] = {0.f, 0.f};
  mbar_wait(&q_full, 0);

  // Issue S = Q K^T of tile j into `acc` (head_dim / 16 k-steps, each 32
  // bytes into a swizzled row; the first overwrites `acc`), uncommitted.
  auto issue_scores = [&](float (&acc)[kS], int j) {
    const uint32_t k_s = k_tile(j % kStages);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int chunk = kk * 16 / TK::kChunkCols;
      const int col = (kk * 16 % TK::kChunkCols) * 2;
      WgmmaSs<kBK>::run(
          acc,
          make_desc(q_wg + chunk * TQ::kChunkBytes + col, 16,
                    8 * TQ::kSwizzle, TQ::kLayout),
          make_desc(k_s + chunk * TK::kChunkBytes + col, 16,
                    8 * TK::kSwizzle, TK::kLayout),
          kk > 0);
    }
  };
  // Issue O += P V of tile j (16-key slices of V; N = head_dim over the
  // column chunks), uncommitted.
  unsigned pa[kKSteps][4];
  auto issue_values = [&](int j) {
    const uint32_t v_s = v_tile(j % kStages);
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      WgmmaRs<HD>::run(o, pa[kk],
                       make_desc(v_s + kk * 16 * TK::kSwizzle,
                                 TK::kChunkBytes, 8 * TK::kSwizzle,
                                 TK::kLayout),
                       1);
  };

  // Online softmax of tile j's scores, in the log2 domain: s becomes the
  // weights, m_i and l_i move to the tile, corr is the factor that rescales
  // the older O.  Only tiles that reach past k_len, the diagonal or the
  // window test each key; the rest of a row's tiles are wholly visible.
  const float scale2 = sm_scale * 1.4426950408889634f;
  const int qpos_lo = q_first + offset;
  const int qpos_hi = q_last + offset;
  float corr[2];
  auto softmax = [&](float (&s)[kS], int j) {
    const int k0 = (t_begin + j) * kBK;
    const bool masked =
        k0 + kBK > k_len ||
        (causal && (k0 + kBK - 1 > qpos_lo ||
                    (window > 0 && k0 <= qpos_hi - window)));
    float tile_max[2] = {-INFINITY, -INFINITY};
    if (masked) {
      // Element e of n-tile nt is (row row0 + 8*(e>>1), key k0 + 8*nt +
      // 2c + (e&1)).
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * nt + 2 * c + (e & 1);
          const int qp = qpos[e >> 1];
          float val = s[4 * nt + e] * scale2;
          if (key >= k_len) {
            val = -INFINITY;
          } else if (causal) {
            bool visible = key <= qp;
            if (window > 0) visible = visible && key > qp - window;
            if (!visible) val = AIKO_NEG_INF;
          }
          s[4 * nt + e] = val;
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], val);
        }
    } else {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        s[i] *= scale2;
        tile_max[(i >> 1) & 1] = fmaxf(tile_max[(i >> 1) & 1], s[i]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = tile_max[rr];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[rr], mx);
      corr[rr] = exp2_approx(m_i[rr] - m_new);
      m_i[rr] = m_new;
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const float p = exp2_approx(s[i] - m_i[(i >> 1) & 1]);
      s[i] = p;
      row_sum[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l_i[rr] = l_i[rr] * corr[rr] + row_sum[rr];
  };
  // P as the A operand: the accumulator layout of keys 16kk..16kk+15 is the
  // register fragment of a 64x16 A.  Written only once the P V reading the
  // previous P is done.
  auto pack = [&](const float (&s)[kS]) {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] =
            aiko::pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };

  // Software pipeline, straight-line within a step so that ptxas can see
  // which wgmma group each wait retires: step j rescales O, issues S of
  // tile j and then P V of tile j - 1, waits for S only, and runs the
  // softmax of tile j on the CUDA cores while that P V is on the tensor
  // cores.  A K slot is freed once its S is done, a V slot once its P V is.
  float s[kS];
  mbar_wait(&k_full[0], 0);
  fence_operands(s);
  wgmma_fence();
  issue_scores(s, 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(s);
  mbar_arrive(&k_empty[0]);
  softmax(s, 0);
  pack(s);
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % kStages, pst = (j - 1) % kStages;
    mbar_wait(&k_full[st], (j / kStages) & 1);
    mbar_wait(&v_full[pst], ((j - 1) / kStages) & 1);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    fence_operands(s);
    fence_operands(o);
    wgmma_fence();
    issue_scores(s, j);
    wgmma_commit();
    issue_values(j - 1);
    wgmma_commit();
    wgmma_wait<1>();  // S of tile j; P V of tile j - 1 may still fly
    fence_operands(s);
    mbar_arrive(&k_empty[st]);
    softmax(s, j);
    wgmma_wait<0>();
    fence_operands(o);
    mbar_arrive(&v_empty[pst]);
    pack(s);
  }
  {
    const int pst = (n_tiles - 1) % kStages;
    mbar_wait(&v_full[pst], ((n_tiles - 1) / kStages) & 1);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    fence_operands(o);
    wgmma_fence();
    issue_values(n_tiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(o);
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
    const int r = row0 + 8 * rr;
    const int qi = q_first + r / group;
    if (r >= rows_used || qi >= q_len) continue;
    __nv_bfloat16* o_row =
        out + (((size_t)b * heads + kvh * group + r % group) * q_len + qi) *
                  HD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<unsigned*>(o_row + 8 * dt + 2 * c) =
          aiko::pack_bf16x2(o[4 * dt + 2 * rr] / denom[rr],
                            o[4 * dt + 2 * rr + 1] / denom[rr]);
  }
}

// ---- host: tensor maps, cached ----
using aiko::EncodeTiled;
using aiko::encoder;

struct MapKey {
  const void* ptr;
  cuuint64_t dims[4];
  cuuint64_t strides[3];
  cuuint32_t box[4];
  int swizzle;
};

// The llama path hands the same layouts (and, through PyTorch's caching
// allocator, mostly the same pointers) every call: a host-side cache keeps
// cuTensorMapEncodeTiled off the launch path.
constexpr int kCacheEntries = 64;
struct MapCache {
  MapKey keys[kCacheEntries];
  CUtensorMap maps[kCacheEntries];
  int used = 0, next = 0;
  std::mutex mutex;
};
MapCache g_maps;

// A bf16 tensor map of a 4-d view: dims innermost first, strides of dims
// 1..3 in elements.  False if TMA cannot take the view.
bool tensor_map(CUtensorMap* map, const void* ptr, const long long (&dims)[4],
                const long long (&strides)[3], const int (&box)[4],
                int swizzle_bytes) {
  MapKey key;
  memset(&key, 0, sizeof key);
  key.ptr = ptr;
  for (int i = 0; i < 4; ++i) {
    key.dims[i] = (cuuint64_t)dims[i];
    key.box[i] = (cuuint32_t)box[i];
  }
  for (int i = 0; i < 3; ++i) {
    // A dim of extent 1 is never stepped: give it a stride TMA takes.
    const long long st = dims[i + 1] == 1 && strides[i] < 8 ? 8 : strides[i];
    key.strides[i] = (cuuint64_t)st * 2;
  }
  key.swizzle = swizzle_bytes;
  std::lock_guard<std::mutex> lock(g_maps.mutex);
  for (int i = 0; i < g_maps.used; ++i)
    if (memcmp(&g_maps.keys[i], &key, sizeof key) == 0) {
      *map = g_maps.maps[i];
      return true;
    }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B;
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             key.dims, key.strides, key.box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  const int slot = g_maps.next;
  memcpy(&g_maps.keys[slot], &key, sizeof key);
  g_maps.maps[slot] = *map;
  g_maps.next = (slot + 1) % kCacheEntries;
  if (g_maps.used < kCacheEntries) ++g_maps.used;
  return true;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int heads, int kv_heads, int q_len, int k_len,
                   const long long* st, int causal, int window,
                   float sm_scale, cudaStream_t stream) {
  using TK = Tile<HD, kBK>;
  const int group = heads / kv_heads;
  if (group > 64 || q_len < 1 || k_len < 1) return cudaErrorInvalidValue;
  const int qpt = kRows / group;
  // Q as (head_dim, heads, q_len, batch): a box is `group` heads of qpt
  // queries, rows in (query, head) order; K and V as (head_dim, k_len,
  // kv_heads, batch), a box kBK keys of one kv head.
  CUtensorMap q_map, k_map, v_map;
  if (!tensor_map(&q_map, q, {HD, heads, q_len, batch}, {st[1], st[2], st[0]},
                  {TK::kChunkCols, group, qpt, 1}, TK::kSwizzle) ||
      !tensor_map(&k_map, k, {HD, k_len, kv_heads, batch},
                  {st[5], st[4], st[3]}, {TK::kChunkCols, kBK, 1, 1},
                  TK::kSwizzle) ||
      !tensor_map(&v_map, v, {HD, k_len, kv_heads, batch},
                  {st[8], st[7], st[6]}, {TK::kChunkCols, kBK, 1, 1},
                  TK::kSwizzle))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(batch * kv_heads, (q_len + qpt - 1) / qpt);
  flash_kernel<HD><<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), heads, kv_heads,
      q_len, k_len, causal, window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q (batch, heads, q_len, head_dim), k/v (batch, kv_heads, k_len, head_dim),
// bf16, with element strides {q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s}
// (the feature axis contiguous, every stride a multiple of 8, 16-byte
// aligned bases: what TMA takes); out contiguous (batch, heads, q_len,
// head_dim) bf16.  window <= 0 = none.  head_dim is 16, 32, 64 or 128;
// heads % kv_heads == 0 with a group of at most 64 heads; causal callers
// have q_len <= k_len.  Returns cudaErrorInvalidValue when TMA cannot take
// a view (its tensor map does not encode).
extern "C" int aiko_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int heads, int kv_heads, int q_len,
                                    int k_len, int head_dim,
                                    const long long* strides, int causal,
                                    int window, float sm_scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_heads < 1 || heads % kv_heads != 0 || (causal && q_len > k_len))
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
