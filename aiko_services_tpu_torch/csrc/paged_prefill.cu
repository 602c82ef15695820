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
//   * GQA-native, as the TPU kernel's `token*group + head` row layout: a
//     tile is 64 rows, the (token, query head) pairs of one kv head, so
//     each K/V row is loaded once for all `group` heads of the tile;
//   * the TPU grid walks a row's kv blocks in order on one core, carrying
//     the online softmax in VMEM.  Here the key axis is cut into splits of
//     a fixed key count on absolute key positions (256 keys: 16 blocks at
//     block size 16), and one CTA owns (row, kv head, query tile, split).
//     The split size depends on the block size alone, never on T, the
//     batch or the data, so a query's output over a given pool is bitwise
//     the same in any chunk and any batch, and the launch needs no host
//     sync.  A CTA walks only its split's live keys: from the first key
//     inside the window of the tile's first query to the tile's last query
//     (trimmed to the chunk's real length and to kv_limit); a split with no
//     live key exits at once;
//   * a tile whose live keys lie in one split writes its output directly.
//     Otherwise every CTA of the tile publishes its rows' (max, sum,
//     weighted values) in f32 into the tile's slot for that live split,
//     and the last CTA of the tile to arrive merges them in split order
//     (log-sum-exp, read straight from the slots), so the result does not
//     depend on timing.  Where those slots would outgrow the wrapper's
//     scratch budget (a long table with no window and a long chunk), the
//     launch is one CTA a tile instead: it sweeps the tile's live splits
//     once for the rows' maxima, then again folding each split's partial
//     in as the merge does, which gives the same bits with no scratch;
//   * bytes in flight: each key row is fetched from its own pool block
//     (tables[row, key / block_size]) by 16-byte cp.async copies into a ring
//     of three 64-key stages (K and V, and the int8 scales), one CTA
//     barrier a stage; Q goes straight from device memory into registers;
//   * both products on the tensor cores, bf16 in, f32 accumulate.  bf16
//     pools at head_dim 128 (`kWg`) run wgmma, the CTA being one
//     warpgroup: K and V land in wgmma's canonical 128-byte-swizzled
//     K-major layout (two 64-feature column blocks of 64 key rows), S =
//     Q K^T is m64n64k16 with Q's A fragments from registers and K from
//     shared memory by descriptor, O += P V is m64n128k16 with P from
//     registers and V through the descriptor's transpose, as
//     csrc/flash_attention.cu does.  Each product is waited for before the
//     CUDA cores read it, so a slot is refilled only once the products
//     that read it are done.  (wgmma beat mma.sync on this ring at every
//     bf16 shape the kernel lab races, scripts/attention_variant_lab.py
//     `chunk` against `chunk_mma_sync`.)  int8 pools and the other head
//     dims run mma.sync m16n8k16: K through ldmatrix as the B operand of
//     S = Q K^T, P reused from the S accumulators as the A operand of O +=
//     P V, V through ldmatrix.trans.  int8 K/V are fed from their bytes: each
//     byte pair becomes an exact bf16x2 with integer ops only
//     (0x4300 | low 7 bits is 128 + them, 0x4300 | the sign bit 128 or
//     256, and one bf16x2 subtraction), K's four bytes 4c..4c+3 of a
//     16-feature step fill k positions 2c, 2c+1, 2c+8, 2c+9 (Q is loaded
//     in that order), and V's two bytes 2g, 2g+1 of two keys feed the
//     n-tiles of features 16j + 2g and 16j + 2g + 1 (undone at the store).
//     K's scale multiplies the score, V's scale folds into P before it is
//     rounded;
//   * the softmax runs in the log2 domain (scores scaled by sm_scale *
//     log2(e) once); stages wholly visible to every row of the tile skip
//     the masks;
//   * masking by absolute ids: key <= query position, and inside the
//     window.  A multi-query tile CAN hold rows with no visible key in a
//     live stage (a later chunk row's first block, or a window that slid
//     past), so the mask is applied as an explicit zero of the probability
//     (the running max reads visible scores only).  A row with no visible
//     key in a live split carries no mass from it; a row whose sum stays 0
//     divides by 1.  NEG_INF is the JAX package's finite value.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // tile rows: (token, query head) pairs
constexpr int kBK = 64;             // keys per stage
constexpr int kStages = 3;
constexpr int kSplitKeys = 256;     // keys a split covers (whole blocks)
constexpr float kLog2e = 1.4426950408889634f;

// Whole blocks, kSplitKeys keys where the block size divides it, else one
// block (mirrored by ops/paged_prefill.py::chunk_split_keys).
__host__ __device__ constexpr int split_keys_for(int block_size) {
  return block_size >= kSplitKeys ? block_size
                                  : kSplitKeys / block_size * block_size;
}

template <int HD, typename KVT>
struct Layout {
  static constexpr bool kInt8 = sizeof(KVT) == 1;
  // wgmma: bf16 at head_dim 128, tiles of two 64 x 128-byte swizzled
  // column blocks.
  static constexpr bool kWg = !kInt8 && HD == 128;
  // A staged key row: bf16 rows padded to 16 bytes past the row
  // (conflict-free ldmatrix), int8 rows likewise.
  static constexpr int kLd = HD * (int)sizeof(KVT) + 16;
  static constexpr int kTile = kWg ? kBK * HD * 2 : kBK * kLd;  // K or V
  static constexpr int kScales = kInt8 ? 2 * kBK * 4 : 0;
  static constexpr int kStage = 2 * kTile + kScales;
  // The ring on 1 KB (the swizzle's period), and its slack.
  static constexpr size_t kSmem = (size_t)kStages * kStage + 1024;
};

using aiko::exp2_approx;
using aiko::ldmatrix_x4;
using aiko::smem_u32;

// ---- wgmma ----
using aiko::fence_operands;
using aiko::make_desc;
using aiko::wgmma_commit;
using aiko::wgmma_fence;
using aiko::wgmma_wait;

// d (64 x N keys, f32) (+)= A (64 x 16 bf16, registers) * B (16 x N,
// K-major in shared memory).
template <int N>
struct WgmmaKeys;
// d (64 x N features, f32) += A (64 x 16 bf16, registers) * B (16 x N,
// N-major in shared memory: the descriptor's transpose).
template <int N>
struct WgmmaValues;

template <>
struct WgmmaKeys<64> {
  static __device__ __forceinline__ void run(float (&d)[8][4],
                                             const unsigned (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};

template <>
struct WgmmaValues<128> {
  static __device__ __forceinline__ void run(float (&d)[16][4],
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
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d));
  }
};


// 4-byte asynchronous global->shared copy (zero-filled when !pred).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(pred ? 4 : 0));
}

using aiko::int8x2_to_bf16x2;

template <int HD, typename KVT, bool kSeq>
__global__ void __launch_bounds__(kThreads) chunk_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ k_pool,
    const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ cached_lens, const int* __restrict__ chunk_lens,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partials,
    int* __restrict__ arrivals, int T, int kv_heads, int group,
    int block_size, int max_blocks, int kv_blocks, int window,
    int live_cap, float sm_scale) {
  using L = Layout<HD, KVT>;
  // Launched as a dependent of the kernel before it (the KV writer): every
  // global read, of q, the metadata and the pool, comes after this wait.
  aiko::wait_for_producer();
  constexpr int kLd = L::kLd;
  constexpr int kRawChunks = HD * (int)sizeof(KVT) / 16;  // pool row
  constexpr int kDT = HD / 8;   // output n-tiles (8 features each)
  constexpr int kKT = HD / 16;  // k-steps over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_flag;
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int split = kSeq ? 0 : blockIdx.x;
  const int qt = blockIdx.y, n_qtiles = gridDim.y;
  const int pair = blockIdx.z;               // row * kv_heads + kv head
  const int b = pair / kv_heads, h = pair % kv_heads;
  const int tile_id = pair * n_qtiles + qt;
  const int r0 = qt * kRows;  // first tile row: token * group + head
  const int rows_total = T * group;
  const int cached = cached_lens[b];
  const int chunk = chunk_lens[b];
  const int split_keys = split_keys_for(block_size);

  // Live keys of the tile: [key_lo, key_hi], and its live splits.
  const int tok_first = r0 / group;
  const int tok_last = min((r0 + kRows - 1) / group, T - 1);
  int key_hi = cached + tok_last;
  key_hi = min(key_hi, cached + chunk - 1);
  key_hi = min(key_hi, kv_blocks * block_size - 1);
  int key_lo = 0;
  if (window > 0) key_lo = max(cached + tok_first - window + 1, 0);
  const int first_split = key_lo / split_keys;
  const int n_live = key_hi >= key_lo ? key_hi / split_keys - first_split + 1
                                      : 0;
  __nv_bfloat16* o_base =
      out + (((size_t)b * T) * kv_heads + h) * group * HD;
  auto o_row = [&](int row) {  // tile row -> its output row
    return o_base + ((size_t)(row / group) * kv_heads * group + row % group) *
                        HD;
  };
  if (n_live == 0) {  // no live key (padding rows only): zeros, once
    if (split == 0)
      for (int i = tid; i < kRows * HD; i += kThreads) {
        const int row = r0 + i / HD;
        if (row < rows_total) o_row(row)[i % HD] = __float2bfloat16(0.f);
      }
    return;
  }
  // This split holds no live key of the tile.
  if (!kSeq && (split < first_split || split >= first_split + n_live)) return;
  // The partial slots of a tile hold live splits only (the launch sizes
  // them by the window's bound).
  if (!kSeq && n_live > live_cap) __trap();

  const size_t token_stride = (size_t)kv_heads * HD;  // pool row of a key
  const int* table = tables + (size_t)b * max_blocks;
  int* token_s = reinterpret_cast<int*>(smem_raw + L::kSmem);

  // Q straight into registers as the A fragments of S = Q K^T: this
  // thread's tile rows row0 and row0 + 8.  bf16 pools take k positions
  // 2c, 2c+1 | 2c+8, 2c+9 as features 16kk + 2c.. | + 8..; int8 pools as
  // features 16kk + 4c, +1 | +2, +3 (the order of K's bytes).
  const int row0 = 16 * warp + g;
  unsigned qf[kKT][4];
  int qpos[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = r0 + row0 + 8 * rr;
    qpos[rr] = cached + row / group;
    const bool ok = row < rows_total;
    const __nv_bfloat16* q_row =
        q + ((((size_t)b * T + (ok ? row / group : 0)) * kv_heads + h) *
                 group +
             (ok ? row % group : 0)) * HD;
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      unsigned lo_pair = 0u, hi_pair = 0u;
      if (ok) {
        const unsigned* qw = reinterpret_cast<const unsigned*>(q_row + 16 * kk);
        if constexpr (L::kInt8) {
          lo_pair = __ldg(qw + 2 * c);
          hi_pair = __ldg(qw + 2 * c + 1);
        } else {
          lo_pair = __ldg(qw + c);
          hi_pair = __ldg(qw + 4 + c);
        }
      }
      qf[kk][rr] = lo_pair;
      qf[kk][2 + rr] = hi_pair;
    }
  }

  const float scale2 = sm_scale * kLog2e;
  // Every tile row's position is at least qpos_lo and at most qpos_hi.
  const int qpos_lo = cached + tok_first;
  const int qpos_hi = cached + (r0 + kRows - 1) / group;
  // One split's sweep: o, m_i, l_i become its partial (or, with max_only,
  // m_i its rows' maxima, which the full sweep reaches with the same ops).
  float o[kDT][4];
  float m_i[2], l_i[2];
  auto sweep = [&](int sp, bool max_only) {
    const int start = sp * split_keys;
    const int lo = max(key_lo, start);
    const int hi = min(key_hi, start + split_keys - 1);
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    m_i[0] = m_i[1] = AIKO_NEG_INF;
    l_i[0] = l_i[1] = 0.f;
    const int st_lo = (lo - start) / kBK;
    const int n_st = (hi - start) / kBK - st_lo + 1;
    // The pool token of each live key of the split, looked up once (no
    // table read or division in the copy loops).
    for (int key = lo + tid; key <= hi; key += kThreads)
      token_s[key - start] =
          table[key / block_size] * block_size + key % block_size;
    __syncthreads();

    auto issue = [&](int index) {
      const int i0 = (st_lo + index) * kBK;  // the stage's first key - start
      unsigned char* ks = smem + (index % kStages) * L::kStage;
      unsigned char* vs = ks + L::kTile;
      for (int i = tid; i < kBK * kRawChunks; i += kThreads) {
        const int r = i / kRawChunks, ch = i % kRawChunks;
        const int key = start + i0 + r;
        const bool ok = key >= lo && key <= hi;
        const size_t src = (ok ? token_s[i0 + r] * token_stride : 0) +
                           (size_t)h * HD + ch * (16 / (int)sizeof(KVT));
        // wgmma: 16-byte chunk ch of key r in column block ch / 8, at
        // (ch % 8) ^ (r % 8) of the row's 128 bytes.
        const int at = L::kWg ? (ch / 8) * (kBK * 128) + r * 128 +
                                    (((ch % 8) ^ (r % 8)) << 4)
                              : r * kLd + ch * 16;
        aiko::cp_async16(ks + at, k_pool + src, ok);
        if (!max_only) aiko::cp_async16(vs + at, v_pool + src, ok);
      }
      if constexpr (L::kInt8) {
        float* sc = reinterpret_cast<float*>(vs + L::kTile);
        for (int r = tid; r < kBK; r += kThreads) {
          const int key = start + i0 + r;
          const bool ok = key >= lo && key <= hi;
          const size_t at =
              ok ? (size_t)token_s[i0 + r] * kv_heads + h : 0;
          cp_async4(sc + r, k_scale + at, ok);
          if (!max_only) cp_async4(sc + kBK + r, v_scale + at, ok);
        }
      }
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_st) issue(i);
      aiko::cp_async_commit();
    }

    for (int i = 0; i < n_st; ++i) {
      aiko::cp_async_wait<kStages - 2>();
      // The copies' writes, seen by wgmma's reads (the async proxy).
      if constexpr (L::kWg) aiko::fence_proxy_async();
      __syncthreads();
      if (i + kStages - 1 < n_st) issue(i + kStages - 1);
      aiko::cp_async_commit();
      const int k0 = start + (st_lo + i) * kBK;
      const unsigned char* kt = smem + (i % kStages) * L::kStage;
      const unsigned char* vt = kt + L::kTile;
      const float* ks_s = reinterpret_cast<const float*>(vt + L::kTile);
      const float* vs_s = ks_s + kBK;

      // ---- S = Q K^T for 64 keys: 8 n-tiles of 8 keys ----
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      if constexpr (L::kWg) {
        fence_operands(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKT; ++kk)
          WgmmaKeys<64>::run(s, qf[kk],
                             make_desc(smem_u32(kt) + (kk / 4) * (kBK * 128) +
                                           (kk % 4) * 32,
                                       16, 1024, 1),
                             kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(s);
      } else {
#pragma unroll
        for (int kk = 0; kk < kKT; ++kk) {
          if constexpr (L::kInt8) {
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              // Key 8nt + g, bytes 16kk + 4c..4c+3.
              const unsigned w = *reinterpret_cast<const unsigned*>(
                  kt + (8 * nt + g) * kLd + 16 * kk + 4 * c);
              aiko::mma_bf16_16816(
                  s[nt], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                  int8x2_to_bf16x2(__byte_perm(w, 0, 0x4140)),
                  int8x2_to_bf16x2(__byte_perm(w, 0, 0x4342)));
            }
          } else {
#pragma unroll
            for (int nt = 0; nt < 8; nt += 2) {
              // Matrices: keys of n-tiles nt, nt + 1 x features 16kk..+7,
              // +8..+15.
              const int mi = lane >> 3;
              unsigned bf[4];
              ldmatrix_x4(bf,
                          kt + (8 * (nt + (mi >> 1)) + (lane & 7)) * kLd +
                              32 * kk + 16 * (mi & 1),
                          false);
              aiko::mma_bf16_16816(s[nt], qf[kk][0], qf[kk][1], qf[kk][2],
                                   qf[kk][3], bf[0], bf[1]);
              aiko::mma_bf16_16816(s[nt + 1], qf[kk][0], qf[kk][1], qf[kk][2],
                                   qf[kk][3], bf[2], bf[3]);
            }
          }
        }
      }

      // ---- online softmax, log2 domain.  Element e of n-tile nt is (tile
      // row row0 + 8*(e>>1), key k0 + 8*nt + 2c + (e&1)). ----
      const bool interior =
          k0 >= lo && k0 + kBK - 1 <= hi && k0 + kBK - 1 <= qpos_lo &&
          (window <= 0 || k0 > qpos_hi - window);
      unsigned visible = 0xffffffffu;
      float tile_max[2] = {AIKO_NEG_INF, AIKO_NEG_INF};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = 8 * nt + 2 * c + (e & 1);
          float val = s[nt][e] * scale2;
          if constexpr (L::kInt8) val *= ks_s[kr];
          s[nt][e] = val;
          if (!interior) {
            const int key = k0 + kr;
            const int pos = qpos[e >> 1];
            bool vis = key <= hi && key <= pos;
            if (window > 0) vis = vis && key > pos - window;
            if (!vis) visible &= ~(1u << (nt * 4 + e));
          }
          if ((visible >> (nt * 4 + e)) & 1u)
            tile_max[e >> 1] = fmaxf(tile_max[e >> 1], val);
        }
      float corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = tile_max[rr];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[rr], mx);
        corr[rr] = exp2_approx(m_i[rr] - m_new);
        m_i[rr] = m_new;
      }
      if (max_only) continue;
      float row_sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // The explicit zero: a masked pair carries no mass, whether or
          // not its row has seen a visible key yet.
          const float p = (visible >> (nt * 4 + e)) & 1u
                              ? exp2_approx(s[nt][e] - m_i[e >> 1])
                              : 0.f;
          row_sum[e >> 1] += p;
          if constexpr (L::kInt8) {
            s[nt][e] = p * vs_s[8 * nt + 2 * c + (e & 1)];
          } else {
            s[nt][e] = p;
          }
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        l_i[rr] = l_i[rr] * corr[rr] + row_sum[rr];
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        o[dt][0] *= corr[0];
        o[dt][1] *= corr[0];
        o[dt][2] *= corr[1];
        o[dt][3] *= corr[1];
      }

      // ---- O += P V: 4 k-steps of 16 keys; P's C fragments become A ----
      if constexpr (L::kWg) {
        unsigned pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = aiko::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
          pa[kk][1] = aiko::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
          pa[kk][2] = aiko::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[kk][3] = aiko::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
        fence_operands(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaValues<HD>::run(o, pa[kk],
                               make_desc(smem_u32(vt) + kk * 16 * 128,
                                         kBK * 128, 1024, 1),
                               1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(o);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const unsigned a0 = aiko::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
          const unsigned a1 = aiko::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
          const unsigned a2 =
              aiko::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          const unsigned a3 =
              aiko::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          if constexpr (L::kInt8) {
            // Keys 16kk + 2c, +1, +8, +9; bytes 16j + 2g, +1 of each: n-tile
            // 2j takes feature 16j + 2g, n-tile 2j + 1 feature 16j + 2g + 1.
            const unsigned char* vrow = vt + (16 * kk + 2 * c) * kLd + 2 * g;
#pragma unroll
            for (int j = 0; j < kDT / 2; ++j) {
              const unsigned char* at = vrow + 16 * j;
              const unsigned k01 =
                  *reinterpret_cast<const unsigned short*>(at) |
                  (unsigned)*reinterpret_cast<const unsigned short*>(at + kLd)
                      << 16;
              const unsigned k89 =
                  *reinterpret_cast<const unsigned short*>(at + 8 * kLd) |
                  (unsigned)*reinterpret_cast<const unsigned short*>(
                      at + 9 * kLd)
                      << 16;
              aiko::mma_bf16_16816(o[2 * j], a0, a1, a2, a3,
                                   int8x2_to_bf16x2(k01),
                                   int8x2_to_bf16x2(k89));
              aiko::mma_bf16_16816(o[2 * j + 1], a0, a1, a2, a3,
                                   int8x2_to_bf16x2(k01 >> 8),
                                   int8x2_to_bf16x2(k89 >> 8));
            }
          } else {
            const unsigned char* vrow =
                vt + (16 * kk + (lane & 15)) * kLd + (lane >> 4) * 16;
#pragma unroll
            for (int dt2 = 0; dt2 < kDT / 2; ++dt2) {
              unsigned bfrag[4];
              ldmatrix_x4(bfrag, vrow + dt2 * 32, true);
              aiko::mma_bf16_16816(o[2 * dt2], a0, a1, a2, a3, bfrag[0],
                                   bfrag[1]);
              aiko::mma_bf16_16816(o[2 * dt2 + 1], a0, a1, a2, a3, bfrag[2],
                                   bfrag[3]);
            }
          }
        }
      }
    }
    aiko::cp_async_wait<0>();
    __syncthreads();  // the ring and the token table are free again
  };
  // The quad's sums of this thread's two rows of the split just swept.
  auto row_sums = [&](float (&l_row)[2]) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_i[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_row[rr] = l;
    }
  };
  // The merge's step, in split order from zeros: a split's (max, sum,
  // values) of this thread's rows weighted by 2^(max - the rows' maxima).
  auto fold = [&](float (&acc)[kDT][4], float (&total)[2],
                  const float (&vals)[kDT][4], const float (&m)[2],
                  const float (&l)[2], const float (&big)[2]) {
    float w[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      w[rr] = exp2_approx(m[rr] - big[rr]);
      total[rr] = __fmaf_rn(w[rr], l[rr], total[rr]);
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[dt][e] = __fmaf_rn(w[e >> 1], vals[dt][e], acc[dt][e]);
  };
  // This thread's rows of the output: values over the sums (a zero sum
  // divides by 1).
  auto store_rows = [&](const float (&vals)[kDT][4], const float (&sums)[2]) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = r0 + row0 + 8 * rr;
      if (row >= rows_total) continue;
      const float denom = sums[rr] == 0.f ? 1.f : sums[rr];
      __nv_bfloat16* dst = o_row(row);
      if constexpr (!L::kInt8) {
        // Features 8dt + 2c, + 1.
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt)
          *reinterpret_cast<unsigned*>(dst + 8 * dt + 2 * c) =
              aiko::pack_bf16x2(vals[dt][2 * rr] / denom,
                                vals[dt][2 * rr + 1] / denom);
      } else {
        // Features 16j + 4c .. + 3: n-tiles 2j, 2j + 1, elements 0, 1.
#pragma unroll
        for (int j = 0; j < kDT / 2; ++j) {
          uint2 quad;
          quad.x = aiko::pack_bf16x2(vals[2 * j][2 * rr] / denom,
                                     vals[2 * j + 1][2 * rr] / denom);
          quad.y = aiko::pack_bf16x2(vals[2 * j][2 * rr + 1] / denom,
                                     vals[2 * j + 1][2 * rr + 1] / denom);
          *reinterpret_cast<uint2*>(dst + 16 * j + 4 * c) = quad;
        }
      }
    }
  };

  float l_row[2];
  if (n_live == 1) {
    // One split: the merge's one step (weight 2^0) from zeros, so a row
    // whose keys lie in one split gets the same bits from either path.
    sweep(first_split, false);
    row_sums(l_row);
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] = __fadd_rn(0.f, o[dt][e]);
    const float sums[2] = {__fadd_rn(0.f, l_row[0]), __fadd_rn(0.f, l_row[1])};
    store_rows(o, sums);
    return;
  }
  if constexpr (kSeq) {
    // One CTA walks every live split of the tile, twice: the rows' maxima
    // first, then each split's partial folded in as the merge folds it
    // (the same bits as the split launch, with no partials to keep).
    float big[2] = {AIKO_NEG_INF, AIKO_NEG_INF};
    for (int sp = first_split; sp < first_split + n_live; ++sp) {
      sweep(sp, true);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) big[rr] = fmaxf(big[rr], m_i[rr]);
    }
    float acc[kDT][4];
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
    float total[2] = {0.f, 0.f};
    for (int sp = first_split; sp < first_split + n_live; ++sp) {
      sweep(sp, false);
      row_sums(l_row);
      fold(acc, total, o, m_i, l_row, big);
    }
    store_rows(acc, total);
    return;
  }
  sweep(split, false);
  row_sums(l_row);

  // ---- several live splits: publish partials, the last CTA merges ----
  // A CTA's partial: its threads' accumulators in register order, float4
  // dt of thread t at [dt][t] (coalesced both ways: every CTA of the tile
  // holds the same (row, feature) in the same register), then each row's
  // (max, sum).  A tile's slots hold its live splits in order.
  constexpr int kPart = kRows * (HD + 2);    // floats of one CTA's partial
  const float* tile_parts = partials + (size_t)tile_id * live_cap * kPart;
  float* part = partials + ((size_t)tile_id * live_cap + split - first_split) *
                               kPart;
  float4* part4 = reinterpret_cast<float4*>(part);
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    __stcg(part4 + dt * kThreads + tid,
           make_float4(o[dt][0], o[dt][1], o[dt][2], o[dt][3]));
  if (c == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      part[kRows * HD + row0 + 8 * rr] = m_i[rr];
      part[kRows * HD + kRows + row0 + 8 * rr] = l_row[rr];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_flag = atomicAdd(arrivals + tile_id, 1) == n_live - 1;
  __syncthreads();
  if (!last_flag) return;
  __threadfence();
  // The merge, in split order, straight from the partials: this thread's
  // two rows' maxima over the splits, then each split's values (kDT float4
  // loads in flight together) folded in.
  auto part_ml = [&](int sp, int which, int rr) {  // which: 0 max, 1 sum
    return __ldcg(tile_parts + (size_t)sp * kPart + kRows * HD +
                  which * kRows + row0 + 8 * rr);
  };
  float big[2] = {AIKO_NEG_INF, AIKO_NEG_INF};
  for (int sp = 0; sp < n_live; ++sp)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) big[rr] = fmaxf(big[rr], part_ml(sp, 0, rr));
  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float total[2] = {0.f, 0.f};
  for (int sp = 0; sp < n_live; ++sp) {
    const float4* acc4 =
        reinterpret_cast<const float4*>(tile_parts + (size_t)sp * kPart);
    float v[kDT][4];
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const float4 f = __ldcg(acc4 + dt * kThreads + tid);
      v[dt][0] = f.x;
      v[dt][1] = f.y;
      v[dt][2] = f.z;
      v[dt][3] = f.w;
    }
    const float m_sp[2] = {part_ml(sp, 0, 0), part_ml(sp, 0, 1)};
    const float l_sp[2] = {part_ml(sp, 1, 0), part_ml(sp, 1, 1)};
    fold(acc, total, v, m_sp, l_sp, big);
  }
  store_rows(acc, total);
  if (tid == 0) arrivals[tile_id] = 0;  // ready for the next launch
}

template <int HD, typename KVT, bool kSeq>
cudaError_t launch_mode(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale,
                        const void* tables, const void* cached_lens,
                        const void* chunk_lens, void* out, void* partials,
                        void* arrivals, int batch, int T, int kv_heads,
                        int group, int block_size, int max_blocks,
                        int kv_blocks, int window, int live_cap,
                        float sm_scale, cudaStream_t stream) {
  const int split_keys = split_keys_for(block_size);
  // The ring, then the split's token table.
  const size_t smem = Layout<HD, KVT>::kSmem + (size_t)split_keys * 4;
  cudaError_t err = cudaFuncSetAttribute(
      chunk_attention_kernel<HD, KVT, kSeq>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_splits = (kv_blocks * block_size + split_keys - 1) / split_keys;
  dim3 grid(kSeq ? 1 : n_splits, (T * group + kRows - 1) / kRows,
            batch * kv_heads);
  if (grid.y == 0 || batch == 0) return cudaSuccess;
  err = aiko::launch_dependent(
      chunk_attention_kernel<HD, KVT, kSeq>, grid, dim3(kThreads), smem,
      stream,
      static_cast<const __nv_bfloat16*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(cached_lens),
      static_cast<const int*>(chunk_lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partials),
      static_cast<int*>(arrivals), T, kv_heads, group, block_size,
      max_blocks, kv_blocks, window, live_cap, sm_scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// live_cap > 0: one CTA a (tile, split), live_cap partial slots a tile;
// live_cap == 0: one CTA a tile walks its live splits itself.
template <int HD, typename KVT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* cached_lens,
                   const void* chunk_lens, void* out, void* partials,
                   void* arrivals, int batch, int T, int kv_heads, int group,
                   int block_size, int max_blocks, int kv_blocks, int window,
                   int live_cap, float sm_scale, cudaStream_t stream) {
  if (live_cap > 0)
    return launch_mode<HD, KVT, false>(
        q, k_pool, v_pool, k_scale, v_scale, tables, cached_lens, chunk_lens,
        out, partials, arrivals, batch, T, kv_heads, group, block_size,
        max_blocks, kv_blocks, window, live_cap, sm_scale, stream);
  return launch_mode<HD, KVT, true>(
      q, k_pool, v_pool, k_scale, v_scale, tables, cached_lens, chunk_lens,
      out, partials, arrivals, batch, T, kv_heads, group, block_size,
      max_blocks, kv_blocks, window, 0, sm_scale, stream);
}

template <typename KVT>
cudaError_t dispatch_hd(int head_dim, const void* q, const void* k_pool,
                        const void* v_pool, const void* k_scale,
                        const void* v_scale, const void* tables,
                        const void* cached_lens, const void* chunk_lens,
                        void* out, void* partials, void* arrivals, int batch,
                        int T, int kv_heads, int group, int block_size,
                        int max_blocks, int kv_blocks, int window,
                        int live_cap, float sm_scale, cudaStream_t stream) {
#define AIKO_CHUNK_LAUNCH(HD)                                                 \
  launch<HD, KVT>(q, k_pool, v_pool, k_scale, v_scale, tables, cached_lens,  \
                  chunk_lens, out, partials, arrivals, batch, T, kv_heads,   \
                  group, block_size, max_blocks, kv_blocks, window, live_cap, \
                  sm_scale, stream)
  switch (head_dim) {
    case 16: return AIKO_CHUNK_LAUNCH(16);
    case 32: return AIKO_CHUNK_LAUNCH(32);
    case 64: return AIKO_CHUNK_LAUNCH(64);
    case 128: return AIKO_CHUNK_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef AIKO_CHUNK_LAUNCH
}

}  // namespace

// q (batch, T, kv_heads, group, head_dim) bf16 contiguous and out likewise;
// pools (n_blocks, block_size, kv_heads, head_dim) bf16, or int8 with f32
// scales (n_blocks, block_size, kv_heads); tables (batch, max_blocks),
// cached_lens and chunk_lens (batch,) int32.  The pool already holds the
// chunk.  kv_blocks <= max_blocks bounds the sweep; window <= 0 = none.
// head_dim is 16, 32, 64 or 128.  live_cap > 0: one CTA a (query tile,
// split), and partials is f32 scratch of batch * kv_heads * ceil(T * group
// / 64) * live_cap * 64 * (head_dim + 2) floats, live_cap at least the
// live splits of any tile (splits of split_keys_for(block_size) keys,
// mirrored by ops/paged_prefill.py::chunk_split_keys; the wrapper bounds
// them by the window); arrivals: batch * kv_heads * ceil(T * group / 64)
// int32 zeros, which the kernel leaves zero.  live_cap == 0: one CTA a
// query tile walks its splits twice and merges them in registers, to the
// same bits, with no scratch.
extern "C" int aiko_chunk_attention(const void* q, const void* k_pool,
                                    const void* v_pool, const void* k_scale,
                                    const void* v_scale, const void* tables,
                                    const void* cached_lens,
                                    const void* chunk_lens, void* out,
                                    void* partials, void* arrivals,
                                    int batch, int T, int kv_heads, int group,
                                    int head_dim, int block_size,
                                    int max_blocks, int kv_blocks, int window,
                                    int live_cap, float sm_scale,
                                    int kv_dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group < 1 || block_size < 1 || kv_blocks < 1 ||
      kv_blocks > max_blocks || batch * kv_heads > 65535 || live_cap < 0)
    return cudaErrorInvalidValue;
  if (kv_dtype == AIKO_I8) {
    if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
    return dispatch_hd<int8_t>(head_dim, q, k_pool, v_pool, k_scale, v_scale,
                               tables, cached_lens, chunk_lens, out, partials,
                               arrivals, batch, T, kv_heads, group,
                               block_size, max_blocks, kv_blocks, window,
                               live_cap, sm_scale, st);
  }
  if (kv_dtype == AIKO_BF16)
    return dispatch_hd<__nv_bfloat16>(
        head_dim, q, k_pool, v_pool, nullptr, nullptr, tables, cached_lens,
        chunk_lens, out, partials, arrivals, batch, T, kv_heads, group,
        block_size, max_blocks, kv_blocks, window, live_cap, sm_scale, st);
  return cudaErrorInvalidValue;
}
