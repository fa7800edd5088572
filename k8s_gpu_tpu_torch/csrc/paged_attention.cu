// Paged decode/window attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces: k8s_gpu_tpu/ops/paged_attention.py:_decode_kernel, the Pallas
// TPU kernel that paged_attention launches (same file, pl.pallas_call).
// Same function: query rows q [B, Sq, H, Dh] attend, through per-row page
// tables pages [B, MP], to the physical pool [NB, KH, page, Dh]; row b's
// query j sees logical positions kv_start[b] <= t <= start[b] + j inside
// the first t_hi slots.  Scores and softmax are f32, masked scores are
// -1e30 (never -inf, so a row that sees nothing gets the uniform mean of V
// over all t_hi slots, as in the reference), an int8 pool comes with f32
// scales [NB, KH, page], the G = H / KH query heads sharing a KV head fold
// into the row axis (r = sq * G + g: row r is query r / G, head
// kh * G + r % G), and the output is in q's type.  Dead table entries name
// trash block 0, which is read only as masked positions.
//
// Two routes in one launch each, chosen by the wrapper (ops/
// paged_attention.py: plan) from the folded row count R = Sq * G.
//
// Decode, R <= 16 (paged_attention_splitk_kernel): bytes-bound.  Each
// (batch row, KV head) streams its visible K/V once and does 4 Dh flops a
// position and row, far below the ~295 flops a byte at which bf16 compute
// binds.  At B 8, KH 8 one block per (b, kh) would give 64 blocks for 132
// SMs, each walking 2048 positions alone.  So:
// - The tile's visible range, [kv_start, min(t_hi, start + last row / G
//   + 1)) rounded out to whole pages, is cut into splits of whole pages,
//   one block each: grid (splits, KH, B * row tiles), the split count
//   planned on the host for about 2 blocks an SM; a tile whose range is
//   short uses fewer of them (min_pages pages each at least).  Pages
//   outside the range are never loaded.  A tile whose first row sees
//   nothing reads all of [0, t_hi), as the reference averages over it.
// - Pages arrive by cp.async (16-byte copies) in a ring of 32-position
//   stages in the pool's own type (bf16, or int8 with its scales), three
//   in flight while one is used (one with an f32 pool).  Each
//   16-position group's table entry is read before its copies are issued.
//   An int8 element is dequantized where it is used.
// - Every warp has score work at R = 1: the lanes split Dh (4 columns a
//   lane at Dh 128), the warps take 8 positions each of a stage, and a
//   score is a shuffle reduction over the warp.  Each warp keeps its own
//   online softmax (m, l, acc); the four merge in warp order at the end.
// - A split writes f32 partials (m, l, acc) to a workspace the wrapper
//   allocates; the last split of a tile to finish (an atomic ticket after
//   __threadfence) merges them in split order, so the result does not
//   depend on which block finished last, writes the output and resets its
//   ticket: one launch, deterministic.  One split writes the output
//   directly.  float32 q with R > 16 runs this code on tiles of 16 rows
//   (design cuda-fma).
//
// Window, R > 16 with bf16 q (paged_attention_mma_kernel): an admission
// window is a matrix product, bound by operations (4 Dh flops a visible
// (row, position) pair over 989 TFLOP/s) and before that by the reads
// of K and V.  So:
// - A block of 4 warps owns 64 folded rows, 16 a warp; S = Q K^T and
//   O += P V are mma.sync m16n8k16 bf16 products with f32 accumulators,
//   with flash_mma.cuh's primitives (padded tiles, cp.async, ldmatrix
//   offsets, the online softmax on fragments, p packed to bf16 in
//   registers).  A 64-position key tile spans 64 / page pages, each found
//   through the row's table.
// - The same visible range and splits as the decode route, so a cold
//   admission reads the window's pages and not max_seq; key tiles past
//   the warp's last visible position are skipped, and only tiles that
//   touch the diagonal, kv_start or the split's end test each score.  At
//   B 1, R 512, KH 8 the 64 row tiles alone would leave half the SMs
//   idle; the splits fill them.
// - An int8 pool is staged as int8 and widened to bf16 in shared memory
//   (exact for |x| <= 127); K's scale multiplies the score column after
//   the product and V's scale multiplies p before p is rounded to bf16,
//   so the only new rounding is p's, as in the flash forward.
//
// Not yet done (later work): wgmma and TMA loads for the window route, a
// persistent grid, and 16-row decode tiles that cost fewer shuffles (at
// R = 16 each lane holds 16 rows of q and acc, and each score costs 5).

#include "flash_mma.cuh"

namespace {

constexpr int kI8 = 2;                 // dtype code of an int8 pool
constexpr int kPaThreads = 128;        // four warps, both routes
constexpr int kPaWarps = kPaThreads / 32;
constexpr int kSplitRows = 16;         // folded rows of a decode-route tile
constexpr int kChunk = 32;             // positions of a decode-route stage
constexpr int kWarpPos = kChunk / kPaWarps;  // positions a warp takes
constexpr int kMaxSplits = 64;         // splits a tile at most (MAX_SPLITS)

__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Pages [p_lo, p_hi) the tile of folded rows r0..r_last of one batch row
// reads, and split s of its runs (at most S, each of at least min_pages
// pages) as positions [t_lo, t_end).  Returns the tile's number of runs.
// This is the mirror of ops/paged_attention.py's tile_pages and
// split_ranges: a change to one is a change to both.  Each kernel writes
// the runs it took to `used` when asked, and the gpu test
// test_cuda_splits_used_match_the_planner holds them against the Python.
__device__ __forceinline__ int split_positions(int start, int kv, int r0, int r_last, int G,
                                               int page, int t_hi, int s, int S,
                                               int min_pages, int& t_lo, int& t_end) {
  int p_lo, p_hi;
  const int lo = max(kv, 0);
  if (lo > min(start + r0 / G, t_hi - 1)) {
    p_lo = 0;
    p_hi = t_hi / page;
  } else {
    const int hi = min(t_hi, start + r_last / G + 1);
    p_lo = lo / page;
    p_hi = (hi + page - 1) / page;
  }
  const int n = p_hi - p_lo;
  const int used = min(S, max(1, n / min_pages));
  t_lo = (p_lo + s * n / used) * page;
  t_end = (p_lo + (s + 1) * n / used) * page;
  return used;
}

// Element offset of folded row rr's output (and q) row.
__device__ __forceinline__ size_t row_offset(int b, int rr, int Sq, int H, int G, int kh,
                                             int D) {
  return ((static_cast<size_t>(b) * Sq + rr / G) * H + kh * G + rr % G) * D;
}

// Offset, in positions, of position t of KV head kh in the pool.
__device__ __forceinline__ size_t pool_pos(const int* __restrict__ tbl, int t, int kh,
                                           int KH, int page) {
  const int blk = tbl[t / page];
  return (static_cast<size_t>(blk) * KH + kh) * page + t % page;
}

// Positions [t0, t0 + 16 kGroups) -> stage rows through the table, 16 at a
// time (a group never straddles a page: pages and t0 are multiples of
// 16): K rows at k_dst, V rows at v_dst, kRow bytes apart, and with
// scales (ksc not null) K's and V's at sc_dst and sc_dst + 16 kGroups.
// Zero-filled at and past t_end (a multiple of 16).  The groups' table
// entries are read before any copy is issued.
template <typename KVT, int D, int kGroups, int kRow>
__device__ __forceinline__ void stage_rows(uint32_t k_dst, uint32_t v_dst, uint32_t sc_dst,
                                           const KVT* __restrict__ kp,
                                           const KVT* __restrict__ vp,
                                           const float* __restrict__ ksc,
                                           const float* __restrict__ vsc,
                                           const int* __restrict__ tbl, int kh, int KH,
                                           int page, int t0, int t_end, int tid) {
  constexpr int kVec = 16 / sizeof(KVT);
  constexpr int kPerRow = D / kVec;
  size_t pos[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
    pos[g] = t0 + 16 * g < t_end ? pool_pos(tbl, t0 + 16 * g, kh, KH, page) : 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const bool live = t0 + 16 * g < t_end;
    for (int i = tid; i < 16 * kPerRow; i += kPaThreads) {
      const int tl = 16 * g + i / kPerRow, c = i % kPerRow;
      const size_t off = (pos[g] + i / kPerRow) * D + c * kVec;
      cp_async16(k_dst + tl * kRow + c * 16, kp + off, live);
      cp_async16(v_dst + tl * kRow + c * 16, vp + off, live);
    }
    if (ksc != nullptr) {
      // Four positions a copy: 4 K and 4 V copies a group.
      const int j = tid - 8 * g;
      if (j >= 0 && j < 8) {
        const int which = j / 4, tl = 16 * g + j % 4 * 4;
        cp_async16(sc_dst + (which * 16 * kGroups + tl) * 4,
                   (which ? vsc : ksc) + pos[g] + j % 4 * 4, live);
      }
    }
  }
}

// The split partials of one tile: per split, m [TR], l [TR], acc [TR][D]
// (m in log2 units).  The last of the tile's S splits to arrive merges
// them in split order, writes rows [0, nr) of the output and zeroes the
// tile's ticket.  Every thread of the block calls it after writing its
// share of the partials; `wsm` is shared memory for (S + 1) TR floats that
// nothing else reads any more.
template <typename QT, int D, int TR>
__device__ __forceinline__ void merge_splits(const float* __restrict__ part, int S,
                                             int* __restrict__ ticket, float* wsm,
                                             QT* __restrict__ out, int b, int r0, int nr,
                                             int Sq, int H, int G, int kh) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int kStride = TR * (D + 2);
  // Each row's weights 2^(m_s - M) and 1 / l.
  for (int r = threadIdx.x; r < nr; r += kPaThreads) {
    float m = kMaskFill;
    for (int s = 0; s < S; ++s) m = fmaxf(m, __ldcg(part + s * kStride + r));
    float l = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = exp2f(__ldcg(part + s * kStride + r) - m);
      wsm[s * TR + r] = w;
      l += __ldcg(part + s * kStride + TR + r) * w;
    }
    wsm[S * TR + r] = 1.f / l;
  }
  __syncthreads();
  // Four columns a thread; the splits' loads are independent.
  for (int i = threadIdx.x; i < nr * (D / 4); i += kPaThreads) {
    const int r = i / (D / 4), d = i % (D / 4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(part + s * kStride + 2 * TR + r * D + d));
      const float w = wsm[s * TR + r];
      a.x += x.x * w;
      a.y += x.y * w;
      a.z += x.z * w;
      a.w += x.w * w;
    }
    const float inv = wsm[S * TR + r];
    QT* dst = out + row_offset(b, r0 + r, Sq, H, G, kh, D) + d;
    dst[0] = from_f32<QT>(a.x * inv);
    dst[1] = from_f32<QT>(a.y * inv);
    dst[2] = from_f32<QT>(a.z * inv);
    dst[3] = from_f32<QT>(a.w * inv);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// ---------------------------------------------------------------------------
// Decode route.

template <typename KVT, int D>
struct SplitGeom {
  static constexpr int kRowBytes = D * sizeof(KVT);
  static constexpr bool kQuant = sizeof(KVT) == 1;
  // One stage: K [kChunk][D], V [kChunk][D], then (int8) the K and V scales.
  static constexpr int kStageBytes = 2 * kChunk * kRowBytes + (kQuant ? 2 * kChunk * 4 : 0);
  static constexpr int kStages = sizeof(KVT) == 4 ? 2 : 4;
  static constexpr int kPer = D / 32;  // columns a lane owns
  static constexpr int kMergeBytes = kPaWarps * kSplitRows * (D + 2) * 4;
  static constexpr int kSmem =
      kStages * kStageBytes > kMergeBytes ? kStages * kStageBytes : kMergeBytes;
};

// One stage: positions [t0, t0 + kChunk) of KV head kh through the table,
// zero-filled at and past t_end.
template <typename KVT, int D>
__device__ __forceinline__ void stage_split(char* st, const KVT* __restrict__ kp,
                                            const KVT* __restrict__ vp,
                                            const float* __restrict__ ksc,
                                            const float* __restrict__ vsc,
                                            const int* __restrict__ tbl, int kh, int KH,
                                            int page, int t0, int t_end, int tid) {
  using Gm = SplitGeom<KVT, D>;
  const uint32_t base = smem_u32(st);
  stage_rows<KVT, D, kChunk / 16, Gm::kRowBytes>(
      base, base + kChunk * Gm::kRowBytes, base + 2 * kChunk * Gm::kRowBytes, kp, vp,
      Gm::kQuant ? ksc : nullptr, vsc, tbl, kh, KH, page, t0, t_end, tid);
}

template <typename QT, typename KVT, int D, int KR>
__global__ void __launch_bounds__(kPaThreads)
paged_attention_splitk_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pool,
                              const KVT* __restrict__ v_pool,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ pages, const int* __restrict__ start,
                              const int* __restrict__ kv_start, QT* __restrict__ out,
                              float* __restrict__ work, int* __restrict__ tickets,
                              int* __restrict__ used, int Sq, int H, int KH, int page,
                              int max_pages, int t_hi, int min_pages, float scale) {
  using Gm = SplitGeom<KVT, D>;
  constexpr int kPer = Gm::kPer;
  constexpr int kStages = Gm::kStages;
  // Positions a softmax step takes: registers hold kBatch x KR scores.
  constexpr int kBatch = KR <= 4 ? kWarpPos : 2;
  extern __shared__ float4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);

  const int G = H / KH, R = Sq * G;
  const int n_tiles = (R + kSplitRows - 1) / kSplitRows;
  const int b = blockIdx.z / n_tiles, tile = blockIdx.z % n_tiles;
  const int kh = blockIdx.y, split = blockIdx.x;
  const int r0 = tile * kSplitRows, nr = min(kSplitRows, R - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q_start = start[b], kv_lo = kv_start[b];
  const int* __restrict__ tbl = pages + static_cast<size_t>(b) * max_pages;
  int t_lo, t_end;
  const int S = split_positions(q_start, kv_lo, r0, r0 + nr - 1, G, page, t_hi, split,
                                gridDim.x, min_pages, t_lo, t_end);
  if (used != nullptr && split == 0 && tid == 0) used[(b * KH + kh) * n_tiles + tile] = S;
  if (split >= S) return;  // the tile's range takes fewer splits
  const int n_chunks = (t_end - t_lo + kChunk - 1) / kChunk;

  // Stages 0 .. kStages - 2 in flight; one commit group per stage.
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks)
      stage_split<KVT, D>(smem + c * Gm::kStageBytes, k_pool, v_pool, k_scale, v_scale, tbl,
                          kh, KH, page, t_lo + c * kChunk, t_end, tid);
    cp_async_commit();
  }

  // This lane's columns of the tile's rows, pre-scaled to log2 units.
  const float qmul = scale * kLog2e;
  float qr[KR][kPer];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    if (r < nr) {
      const Vec<QT, kPer> x = *reinterpret_cast<const Vec<QT, kPer>*>(
          q + row_offset(b, r0 + r, Sq, H, G, kh, D) + lane * kPer);
#pragma unroll
      for (int e = 0; e < kPer; ++e) qr[r][e] = to_f32(x.v[e]) * qmul;
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) qr[r][e] = 0.f;
    }
  }
  int q_pos[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) q_pos[r] = q_start + (r0 + r) / G;

  float m[KR], l[KR], acc[KR][kPer];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    m[r] = kMaskFill;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[r][e] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_n<kStages - 2>();
    __syncthreads();  // stage c landed; stage c - 1 is free for chunk c + kStages - 1
    if (c + kStages - 1 < n_chunks)
      stage_split<KVT, D>(smem + (c + kStages - 1) % kStages * Gm::kStageBytes, k_pool,
                          v_pool, k_scale, v_scale, tbl, kh, KH, page,
                          t_lo + (c + kStages - 1) * kChunk, t_end, tid);
    cp_async_commit();
    const char* st = smem + c % kStages * Gm::kStageBytes;
    const float* scl = reinterpret_cast<const float*>(st + 2 * kChunk * Gm::kRowBytes);
    const int t0 = t_lo + c * kChunk;

#pragma unroll
    for (int j0 = 0; j0 < kWarpPos; j0 += kBatch) {
      float s[kBatch][KR];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int tl = warp * kWarpPos + j0 + j;
        const Vec<KVT, kPer> kx = *reinterpret_cast<const Vec<KVT, kPer>*>(
            st + tl * Gm::kRowBytes + lane * kPer * sizeof(KVT));
        float kf[kPer];
#pragma unroll
        for (int e = 0; e < kPer; ++e) kf[e] = to_f32(kx.v[e]);
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < kPer; ++e) a = fmaf(qr[r][e], kf[e], a);
          s[j][r] = warp_sum(a);
        }
      }
      // s becomes p in place: registers hold one kBatch x KR block.
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        float mx = kMaskFill;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int tl = warp * kWarpPos + j0 + j;
          const int t = t0 + tl;
          float x = s[j][r];
          if constexpr (Gm::kQuant) x *= scl[tl];
          if (!(t >= kv_lo && t <= q_pos[r])) x = kMaskFill;
          if (t >= t_end) x = -INFINITY;  // past the split: no position at all
          s[j][r] = x;
          mx = fmaxf(mx, x);
        }
        const float m_new = fmaxf(m[r], mx);
        const float alpha = exp2f(m[r] - m_new);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          s[j][r] = exp2f(s[j][r] - m_new);
          sum += s[j][r];
        }
        l[r] = l[r] * alpha + sum;
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[r][e] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int tl = warp * kWarpPos + j0 + j;
        const Vec<KVT, kPer> vx = *reinterpret_cast<const Vec<KVT, kPer>*>(
            st + (kChunk + tl) * Gm::kRowBytes + lane * kPer * sizeof(KVT));
        float vmul = 1.f;
        if constexpr (Gm::kQuant) vmul = scl[kChunk + tl];
        float vf[kPer];
#pragma unroll
        for (int e = 0; e < kPer; ++e) vf[e] = to_f32(vx.v[e]) * vmul;
#pragma unroll
        for (int r = 0; r < KR; ++r)
#pragma unroll
          for (int e = 0; e < kPer; ++e) acc[r][e] = fmaf(s[j][r], vf[e], acc[r][e]);
      }
    }
  }

  // The four warps' partials through shared memory, merged in warp order.
  cp_async_wait_n<0>();
  __syncthreads();
  float* const wm = reinterpret_cast<float*>(smem);      // [warp][kSplitRows]
  float* const wl = wm + kPaWarps * kSplitRows;          // [warp][kSplitRows]
  float* const wacc = wl + kPaWarps * kSplitRows;        // [warp][kSplitRows][D]
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    if (lane == 0) {
      wm[warp * kSplitRows + r] = m[r];
      wl[warp * kSplitRows + r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      wacc[(warp * kSplitRows + r) * D + lane * kPer + e] = acc[r][e];
  }
  __syncthreads();
  const int ti = (b * KH + kh) * n_tiles + tile;
  float* const part = work + static_cast<size_t>(ti) * gridDim.x * (kSplitRows * (D + 2));
  float* const mine = part + split * (kSplitRows * (D + 2));
  for (int i = tid; i < nr * D; i += kPaThreads) {
    const int r = i / D, d = i % D;
    float mm = kMaskFill;
#pragma unroll
    for (int w = 0; w < kPaWarps; ++w) mm = fmaxf(mm, wm[w * kSplitRows + r]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kPaWarps; ++w) {
      const float wt = exp2f(wm[w * kSplitRows + r] - mm);
      ll += wl[w * kSplitRows + r] * wt;
      aa += wacc[(w * kSplitRows + r) * D + d] * wt;
    }
    if (S == 1) {
      out[row_offset(b, r0 + r, Sq, H, G, kh, D) + d] = from_f32<QT>(aa / ll);
    } else {
      if (d == 0) {
        mine[r] = mm;
        mine[kSplitRows + r] = ll;
      }
      mine[2 * kSplitRows + r * D + d] = aa;
    }
  }
  if (S > 1)
    merge_splits<QT, D, kSplitRows>(part, S, tickets + ti, reinterpret_cast<float*>(smem),
                                    out, b, r0, nr, Sq, H, G, kh);
}

// ---------------------------------------------------------------------------
// Window route (bf16 q, pool bf16 or int8).

template <typename KVT, int D>
struct MmaGeom {
  using M = MmaTile<D>;
  static constexpr bool kQuant = sizeof(KVT) == 1;
  // bf16: Q, then K and V stages 0 and 1, all padded bf16 tiles.  int8:
  // Q, the bf16 K and V tiles the products read, then per stage the raw
  // int8 K [64][D] and V [64][D] and the K and V scales [64].
  static constexpr int kRawBytes = 2 * kTile * D + 2 * kTile * 4;
  static constexpr int kSmem = kQuant ? 3 * M::kBytes + 2 * kRawBytes : 5 * M::kBytes;
};

// Key positions [t0, t0 + 64) of KV head kh -> stage `st` (padded bf16
// tiles K then V, or raw int8 K, V and scales), zero past t_end.
template <typename KVT, int D>
__device__ __forceinline__ void stage_window(char* st, const KVT* __restrict__ kp,
                                             const KVT* __restrict__ vp,
                                             const float* __restrict__ ksc,
                                             const float* __restrict__ vsc,
                                             const int* __restrict__ tbl, int kh, int KH,
                                             int page, int t0, int t_end, int tid) {
  using M = MmaTile<D>;
  constexpr bool kQuant = MmaGeom<KVT, D>::kQuant;
  constexpr int kRow = kQuant ? D : M::kRowBytes;        // bytes a staged row
  constexpr int kVOff = kQuant ? kTile * D : M::kBytes;  // V after K
  const uint32_t base = smem_u32(st);
  stage_rows<KVT, D, kTile / 16, kRow>(base, base + kVOff, base + 2 * kTile * D, kp, vp,
                                       kQuant ? ksc : nullptr, vsc, tbl, kh, KH, page, t0,
                                       t_end, tid);
}

// Raw int8 [64][D] -> a padded bf16 tile, exact.
template <int D>
__device__ __forceinline__ void widen_int8(char* dst, const char* src, int tid) {
  using M = MmaTile<D>;
  for (int i = tid; i < kTile * M::kChunks; i += kPaThreads) {
    const int r = i / M::kChunks, c = i % M::kChunks;
    const uint2 x = *reinterpret_cast<const uint2*>(src + r * D + c * 8);
    const int8_t* e = reinterpret_cast<const int8_t*>(&x);
    *reinterpret_cast<uint4*>(dst + r * M::kRowBytes + c * 16) = make_uint4(
        pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3]), pack_bf16(e[4], e[5]),
        pack_bf16(e[6], e[7]));
  }
}

template <typename KVT, int D>
__global__ void __launch_bounds__(kPaThreads)
paged_attention_mma_kernel(const bf16* __restrict__ q, const KVT* __restrict__ k_pool,
                           const KVT* __restrict__ v_pool, const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale, const int* __restrict__ pages,
                           const int* __restrict__ start, const int* __restrict__ kv_start,
                           bf16* __restrict__ out, float* __restrict__ work,
                           int* __restrict__ tickets, int* __restrict__ used, int Sq,
                           int H, int KH, int page, int max_pages, int t_hi, int min_pages,
                           float scale) {
  using M = MmaTile<D>;
  using Gm = MmaGeom<KVT, D>;
  constexpr bool kQuant = Gm::kQuant;
  extern __shared__ float4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);
  char* const qs = smem;
  // The tiles the products read: K, V of stage s (bf16), or the one
  // widened pair (int8); raw int8 stages after them.
  char* const kv0 = smem + M::kBytes;
  char* const raw = smem + 3 * M::kBytes;

  const int G = H / KH, R = Sq * G;
  const int n_tiles = (R + kTile - 1) / kTile;
  const int b = blockIdx.z / n_tiles, tile = blockIdx.z % n_tiles;
  const int kh = blockIdx.y, split = blockIdx.x;
  const int r0 = tile * kTile, nr = min(kTile, R - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q_start = start[b], kv_lo = kv_start[b];
  const int* __restrict__ tbl = pages + static_cast<size_t>(b) * max_pages;
  int t_lo, t_end;
  const int S = split_positions(q_start, kv_lo, r0, r0 + nr - 1, G, page, t_hi, split,
                                gridDim.x, min_pages, t_lo, t_end);
  if (used != nullptr && split == 0 && tid == 0) used[(b * KH + kh) * n_tiles + tile] = S;
  if (split >= S) return;  // the tile's range takes fewer splits
  const int n_kt = (t_end - t_lo + kTile - 1) / kTile;

  auto stage_of = [&](int s) -> char* {
    return kQuant ? raw + s * Gm::kRawBytes : kv0 + s * 2 * M::kBytes;
  };

  // The Q tile (folded rows through their heads; rows past R zero) and
  // key tile 0.
  {
    const uint32_t qb = smem_u32(qs);
    for (int i = tid; i < kTile * M::kChunks; i += kPaThreads) {
      const int r = i / M::kChunks, c = i % M::kChunks;
      const bool live = r < nr;
      const bf16* src = q + (live ? row_offset(b, r0 + r, Sq, H, G, kh, D) : 0) + c * 8;
      cp_async16(qb + r * M::kRowBytes + c * 16, src, live);
    }
  }
  if (n_kt > 0)
    stage_window<KVT, D>(stage_of(0), k_pool, v_pool, k_scale, v_scale, tbl, kh, KH, page,
                         t_lo, t_end, tid);
  cp_async_commit();

  const int row_lo = warp * 16;                       // the warp's first tile row
  const int rows[2] = {r0 + row_lo + lane / 4, r0 + row_lo + lane / 4 + 8};
  const int qp[2] = {q_start + rows[0] / G, q_start + rows[1] / G};
  const int q_first = q_start + (r0 + row_lo) / G;     // the warp's first row's position
  const int q_last = q_start + (r0 + min(row_lo + 15, nr - 1)) / G;
  // A warp whose first row sees nothing must add every slot of its range.
  const bool warp_dead = max(kv_lo, 0) > min(q_first, t_hi - 1);
  const bool warp_live = row_lo < nr;

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kMaskFill, kMaskFill}, l_r[2] = {0.f, 0.f};
  const float scale2 = scale * kLog2e;
  uint32_t qf[D / 16][4];
  const uint32_t q_addr = smem_u32(qs) + row_lo * M::kRowBytes + a_lane_off<D>(lane);
  const uint32_t k_off = b_lane_off<D>(lane);
  const uint32_t v_off = a_lane_off<D>(lane);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int cur = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt has landed; tile kt - 1 is consumed
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(q_addr + kk * 32, qf[kk]);
    }
    if (kt + 1 < n_kt) {
      stage_window<KVT, D>(stage_of(cur ^ 1), k_pool, v_pool, k_scale, v_scale, tbl, kh, KH,
                           page, t_lo + (kt + 1) * kTile, t_end, tid);
      cp_async_commit();
    }
    char* kt_tile;
    char* vt_tile;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (kQuant) {
      const char* rs = stage_of(cur);
      widen_int8<D>(kv0, rs, tid);
      widen_int8<D>(kv0 + M::kBytes, rs + kTile * D, tid);
      ksc = reinterpret_cast<const float*>(rs + 2 * kTile * D);
      vsc = ksc + kTile;
      kt_tile = kv0;
      vt_tile = kv0 + M::kBytes;
      __syncthreads();  // the widened tiles are whole
    } else {
      kt_tile = stage_of(cur);
      vt_tile = kt_tile + M::kBytes;
    }
    const int k0 = t_lo + kt * kTile;
    if (!warp_live || (!warp_dead && (k0 > q_last || k0 + kTile - 1 < kv_lo))) continue;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const uint32_t kb = smem_u32(kt_tile) + k_off;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        ldsm_x4(kb + np * 16 * M::kRowBytes + kk * 32, bq);
        mma_bf16(s[2 * np], qf[kk], bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bq[2], bq[3]);
      }
    }

    const bool edge = k0 < kv_lo || k0 + kTile - 1 > q_first || k0 + kTile > t_end;
    float mx[2] = {kMaskFill, kMaskFill};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + lane % 4 * 2 + (e & 1);
        float x = s[n][e] * scale2;
        if constexpr (kQuant) x *= ksc[col];
        if (edge) {
          const int key = k0 + col;
          if (!(key >= kv_lo && key <= qp[e / 2])) x = kMaskFill;
          if (key >= t_end) x = -INFINITY;  // past the split: no position
        }
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_r[h], quad_max(mx[h]));
      alpha[h] = exp2_ftz(m_r[h] - m_new);
      m_r[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_ftz(s[n][e] - m_r[e / 2]);
        rs[e / 2] += s[n][e];
        // V's scale goes into p before p is rounded to bf16.
        if constexpr (kQuant) s[n][e] *= vsc[n * 8 + lane % 4 * 2 + (e & 1)];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + rs[h];
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }
    }
    const uint32_t vb = smem_u32(vt_tile) + v_off;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      pack_a(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(vb + kk * 16 * M::kRowBytes + dp * 32, bv);
        mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) l_r[h] = quad_sum(l_r[h]);
  const int ti = (b * KH + kh) * n_tiles + tile;
  float* const part = work + static_cast<size_t>(ti) * gridDim.x * (kTile * (D + 2));
  float* const mine = part + split * (kTile * (D + 2));
  const int cl = lane % 4 * 2;
  if (S == 1) {
    if (!warp_live) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tr = row_lo + lane / 4 + 8 * h;
      if (tr >= nr) continue;
      const float inv = 1.f / l_r[h];
      bf16* dst = out + row_offset(b, r0 + tr, Sq, H, G, kh, D);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8 + cl) =
            pack_bf16(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
    }
    return;
  }
  if (warp_live) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tr = row_lo + lane / 4 + 8 * h;
      if (tr >= nr) continue;
      if (lane % 4 == 0) {
        mine[tr] = m_r[h];
        mine[kTile + tr] = l_r[h];
      }
      float* dst = mine + 2 * kTile + tr * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(dst + n * 8 + cl) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
    }
  }
  merge_splits<bf16, D, kTile>(part, S, tickets + ti, reinterpret_cast<float*>(smem), out,
                               b, r0, nr, Sq, H, G, kh);
}

// ---------------------------------------------------------------------------
// Launch.

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *pages, *start, *kv_start;
  void *out, *work, *tickets, *used;
  int B, Sq, H, KH, page, max_pages, t_hi, splits, min_pages;
  float scale;
  cudaStream_t stream;
};

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device, once per device: the call costs host time, and serving is
// host-bound.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1ull)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

dim3 grid_of(const Args& a, int rows) {
  const int R = a.Sq * (a.H / a.KH);
  return dim3(a.splits, a.KH, a.B * ((R + rows - 1) / rows));
}

template <typename QT, typename KVT, int D, int KR>
int launch_splitk(const Args& a) {
  constexpr int kSmem = SplitGeom<KVT, D>::kSmem;
  const auto kernel = paged_attention_splitk_kernel<QT, KVT, D, KR>;
  static unsigned long long done = 0;
  const cudaError_t err = allow_smem(kernel, kSmem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid_of(a, kSplitRows), kPaThreads, kSmem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KVT*>(a.k_pool),
      static_cast<const KVT*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.pages),
      static_cast<const int*>(a.start), static_cast<const int*>(a.kv_start),
      static_cast<QT*>(a.out), static_cast<float*>(a.work), static_cast<int*>(a.tickets),
      static_cast<int*>(a.used), a.Sq, a.H, a.KH, a.page, a.max_pages, a.t_hi, a.min_pages,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename KVT, int D>
int launch_mma(const Args& a) {
  constexpr int kSmem = MmaGeom<KVT, D>::kSmem;
  const auto kernel = paged_attention_mma_kernel<KVT, D>;
  static unsigned long long done = 0;
  const cudaError_t err = allow_smem(kernel, kSmem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid_of(a, kTile), kPaThreads, kSmem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const KVT*>(a.k_pool),
      static_cast<const KVT*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.pages),
      static_cast<const int*>(a.start), static_cast<const int*>(a.kv_start),
      static_cast<bf16*>(a.out), static_cast<float*>(a.work), static_cast<int*>(a.tickets),
      static_cast<int*>(a.used), a.Sq, a.H, a.KH, a.page, a.max_pages, a.t_hi, a.min_pages,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

// The decode route's instance: head width, and the rows a block holds in
// registers (1, 4 or 16: R rounded up).
template <typename QT, typename KVT>
int splitk_dh(int Dh, const Args& a) {
  const int R = a.Sq * (a.H / a.KH);
  if (Dh == 64) {
    if (R <= 1) return launch_splitk<QT, KVT, 64, 1>(a);
    if (R <= 4) return launch_splitk<QT, KVT, 64, 4>(a);
    return launch_splitk<QT, KVT, 64, 16>(a);
  }
  if (Dh == 128) {
    if (R <= 1) return launch_splitk<QT, KVT, 128, 1>(a);
    if (R <= 4) return launch_splitk<QT, KVT, 128, 4>(a);
    return launch_splitk<QT, KVT, 128, 16>(a);
  }
  return -1;
}

template <typename KVT>
int mma_dh(int Dh, const Args& a) {
  if (Dh == 64) return launch_mma<KVT, 64>(a);
  if (Dh == 128) return launch_mma<KVT, 128>(a);
  return -1;
}

}  // namespace

// A launch's sizes and options, one a geometry (ops/paged_attention.py:
// _Dims, the same fields in the same order): the wrapper passes the
// address of the one it keeps, which costs less host time than 14
// arguments, and serving is host-bound.
struct Dims {
  int B, Sq, H, KH, Dh, page, max_pages, t_hi, route, splits, min_pages, q_dtype, kv_dtype;
  float scale;
};

// Route 0: the split-K decode route (any R; tiles of 16 rows); route 1:
// the tensor-core window route (bf16 q).  Up to `splits` blocks (at most
// kMaxSplits) share each row tile's key range, each at least `min_pages`
// pages; with more than one, `work` holds their f32 partials
// (splits x B x KH x row tiles x rows x (Dh + 2) floats, rows 16 or 64)
// and `tickets` one zeroed int a tile, which the kernel leaves zeroed.
// `used`, when not null, gets the number of splits each tile took (int, a
// tile at (b * KH + kh) * row tiles + tile).
// Returns 0, a cudaError_t from the launch, or -1 for a type, width or
// route this file has no instance of.  Dtype codes: 0 float32, 1
// bfloat16, 2 int8.
extern "C" int paged_attention_forward(const void* q, const void* k_pool, const void* v_pool,
                                       const void* k_scale, const void* v_scale,
                                       const void* pages, const void* start,
                                       const void* kv_start, void* out, void* work,
                                       void* tickets, void* used, const Dims* d,
                                       void* stream) {
  const Args a{q,       k_pool,   v_pool,     k_scale, v_scale,  pages,
               start,   kv_start, out,        work,    tickets,  used,
               d->B,    d->Sq,    d->H,       d->KH,   d->page,  d->max_pages,
               d->t_hi, d->splits, d->min_pages, d->scale, static_cast<cudaStream_t>(stream)};
  if (d->splits < 1 || d->splits > kMaxSplits || d->min_pages < 1) return -1;
  const int Dh = d->Dh, qt = d->q_dtype, kt = d->kv_dtype;
  if (d->route == 1) {
    if (qt != kBF16) return -1;
    if (kt == kBF16) return mma_dh<bf16>(Dh, a);
    if (kt == kI8) return mma_dh<int8_t>(Dh, a);
    return -1;
  }
  if (d->route != 0) return -1;
  if (qt == kF32 && kt == kF32) return splitk_dh<float, float>(Dh, a);
  if (qt == kBF16 && kt == kBF16) return splitk_dh<bf16, bf16>(Dh, a);
  if (qt == kF32 && kt == kI8) return splitk_dh<float, int8_t>(Dh, a);
  if (qt == kBF16 && kt == kI8) return splitk_dh<bf16, int8_t>(Dh, a);
  return -1;
}

// Dynamic shared memory of the instances for a route (0 split-K, 1 tensor
// cores), a pool dtype code and a head width; -1 where there is none.
extern "C" int paged_attention_smem(int route, int kv_dtype, int Dh) {
  if (Dh != 64 && Dh != 128) return -1;
  const bool wide = Dh == 128;
  if (route == 1) {
    if (kv_dtype == kBF16) return wide ? MmaGeom<bf16, 128>::kSmem : MmaGeom<bf16, 64>::kSmem;
    if (kv_dtype == kI8) return wide ? MmaGeom<int8_t, 128>::kSmem : MmaGeom<int8_t, 64>::kSmem;
    return -1;
  }
  if (route != 0) return -1;
  if (kv_dtype == kF32) return wide ? SplitGeom<float, 128>::kSmem : SplitGeom<float, 64>::kSmem;
  if (kv_dtype == kBF16) return wide ? SplitGeom<bf16, 128>::kSmem : SplitGeom<bf16, 64>::kSmem;
  if (kv_dtype == kI8) return wide ? SplitGeom<int8_t, 128>::kSmem : SplitGeom<int8_t, 64>::kSmem;
  return -1;
}

extern "C" const char* paged_attention_error_string(int code) {
  if (code < 0) return "no kernel instance for this dtype, head width or route";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
