// Flash attention v2 for Hopper (sm_90a): forward, dq and dk/dv with the
// rotary embedding applied in the kernel, K/V read at their own KV heads and
// P query tiles per block, bound with ctypes.
//
// Replaces the three Pallas TPU kernels of the reference's v2 path in
// k8s_gpu_tpu/ops/attention.py: _fwd_kernel_v2 (launched by
// _flash_v2_forward), _bwd_dq_kernel_v2 and _bwd_dkv_kernel_v2 (launched by
// _flash_v2_backward).  Same functions: q [B, H, S, D] with H = KH * G
// (query head h = kh * G + g, so q is [B * KH, G * S, D] with member g's
// rows at g * S), k, v [B * KH, S, D].  With rope, q and k are widened to
// f32 and rotated at each row's own sequence position s (half-split, angle
// s * exp(i * c) for i < D / 2, c = -ln(theta) / (D / 2) given by the caller
// in f32), and never rounded back to the input type (the bf16 forward keeps
// them exact as two bf16 halves).  Scores s = q.k * D^-0.5 in f32, masked with -1e30; the forward emits out in the input type and
// lse in f32 [B * H, S]; the backward recomputes p from lse, takes delta =
// rowsum(dO * O) - g_lse from the caller, accumulates dq and dk in the
// rotated basis and writes them through the transpose rotation (the angle
// negated), and sums dk and dv over the G query heads of a KV head inside
// one block.
//
// What bounds it on the H100: operations, as v1 (flash_attention.cu): 4 D
// (forward), 6 D (dq) and 8 D (dk/dv) flops per visible (query, key) pair of
// the H query heads; K/V and dK/dV move at KH heads.
//
// The bf16 kernels run on the tensor cores: the forward
// (flash_v2_fwd_mma_kernel, flash_mma.cuh) and dq
// (flash_v2_bwd_dq_mma_kernel, flash_mma_bwd.cuh) with P groups of 4 warps
// a block over the same (tile, member) items sharing a cp.async K/V ring,
// dk/dv (flash_v2_bwd_dkv_mma_kernel, flash_mma_bwd.cuh) with one stream of
// the G members' query tiles through its ring.  With rope all three take q
// and k rotated and split into bf16 hi and lo planes by one pre-pass
// (flash_v2_rope_split_kernel, its own entry): the caller runs it once per
// forward and once per backward, for both backward kernels.  The float32
// kernels are v1's first design on the CUDA cores in f32:
// - K/V are read at [B, KH, S, D]; nothing repeats them.  A forward or dq
//   block owns P (query tile, member) items of one KV head, ordered member
//   first (item i = tile * G + g).  With G >= P its P query tiles are P
//   query heads at the same sequence tile: their causal bounds agree and
//   each K/V tile the block stages serves P of the G query heads.  With
//   G = 1 they are neighbouring tiles and the block runs to the later one's
//   diagonal.  The block has P groups of 256 threads, each owning one 64-row
//   query tile as v1's block does, all reading each staged K/V tile.  Items
//   past G * ceil(S / 64), at the ragged end of the last block, are masked.
//   P is 1 or 2: a 512-thread block may hold 128 registers a thread.
// - A query tile never straddles two members: each member's ragged last
//   tile is masked on its own, so any S runs.
// - The rotation is done while a tile is staged: a thread loads the 16-byte
//   chunks at columns c and c + D/2 together and rotates them in registers
//   (accurate sincosf; the table exp(i c) is built once per block in shared
//   memory).  dq and dk leave through shared memory, where the transpose
//   rotation pairs columns that other threads accumulated.
// - dq stages V and then K in one buffer (V for dO v^T, K for q k^T and
//   ds k), so two pipelined tiles' q, dO and ds fit in the 227 KB a block
//   may use at D = 128 in f32.
// - dk/dv: one 256-thread block per (key tile, b kh) loops over the G
//   members and, for each, over the query tiles from the diagonal on.  No
//   atomics: the gradients are deterministic.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "flash_mma_bwd.cuh"

namespace {

constexpr int kMaxHalf = 64;         // D / 2 of the widest instance
constexpr int kNoPipelineInstance = -2;
constexpr int kNoPlanes = -3;
// Key tiles a block of the bf16 dk/dv: two 64-row tiles (8 warps) share
// one Q/dO ring, as two 4-warp blocks of v1 share an SM; one tile a block
// (4 warps, one block an SM by its 158 KB at D 128) ran 1.6x slower at
// the flagship training shape on an H100.
constexpr int kDkvKeyTiles = 2;

// load_tile (rows [row0, row0 + 64) of an [S, D] slab -> f32 smem), each row
// r rotated at sequence position row0 + r when rope.
template <typename T, int D, int kN>
__device__ __forceinline__ void load_tile_rope(float* dst, const T* __restrict__ src,
                                               int row0, int S, int tid, int rope,
                                               const float* freqs) {
  if (!rope) {
    load_tile<T, D, kN>(dst, src, row0, S, tid);
    return;
  }
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kHalf = D / 2;
  constexpr int kPerRow = kHalf / kElems;
  static_assert(kHalf % kElems == 0, "D / 2 must fill whole 16-byte loads");
  for (int i = tid; i < kTile * kPerRow; i += kN) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kElems;
    float4* o1 = reinterpret_cast<float4*>(dst + r * Geom<D>::kStride + c);
    float4* o2 = reinterpret_cast<float4*>(dst + r * Geom<D>::kStride + c + kHalf);
    if (row0 + r < S) {
      const T* row = src + static_cast<size_t>(row0 + r) * D;
      const uint4 raw1 = *reinterpret_cast<const uint4*>(row + c);
      const uint4 raw2 = *reinterpret_cast<const uint4*>(row + c + kHalf);
      const T* e1 = reinterpret_cast<const T*>(&raw1);
      const T* e2 = reinterpret_cast<const T*>(&raw2);
      const float pos = static_cast<float>(row0 + r);
      float a[kElems], b[kElems];
#pragma unroll
      for (int u = 0; u < kElems; ++u) {
        float sn, cs;
        sincosf(pos * freqs[c + u], &sn, &cs);
        const float x1 = to_f32(e1[u]), x2 = to_f32(e2[u]);
        a[u] = x1 * cs - x2 * sn;
        b[u] = x1 * sn + x2 * cs;
      }
#pragma unroll
      for (int u = 0; u < kElems; u += 4) {
        o1[u / 4] = make_float4(a[u], a[u + 1], a[u + 2], a[u + 3]);
        o2[u / 4] = make_float4(b[u], b[u + 1], b[u + 2], b[u + 3]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kElems; u += 4) {
        o1[u / 4] = make_float4(0.f, 0.f, 0.f, 0.f);
        o2[u / 4] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// A group's [64, D] accumulator (rows 4 tr + i, columns col(tc, c)) -> f32
// smem [64][D + 4].
template <int D>
__device__ __forceinline__ void spill_tile(float* dst, const float (&acc)[4][Geom<D>::kCols],
                                           int tr, int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < Geom<D>::kCols; ++c)
      dst[(tr * 4 + i) * Geom<D>::kStride + Geom<D>::col(tc, c)] = acc[i][c];
}

// Rows r of an f32 smem tile [64][D + 4] -> rows row0 + r < S of dst in T,
// 16-byte stores; with rope each row goes through the transpose rotation at
// position row0 + r (the angle negated).
template <typename T, int D, int kN>
__device__ __forceinline__ void store_tile_rope_t(T* __restrict__ dst, const float* src,
                                                  int row0, int S, int tid, int rope,
                                                  const float* freqs) {
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kHalf = D / 2;
  constexpr int kPerRow = kHalf / kElems;
  for (int i = tid; i < kTile * kPerRow; i += kN) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kElems;
    if (row0 + r >= S) continue;
    const float* x = src + r * Geom<D>::kStride + c;
    const float pos = static_cast<float>(row0 + r);
    alignas(16) T a[kElems];
    alignas(16) T b[kElems];
#pragma unroll
    for (int u = 0; u < kElems; ++u) {
      float x1 = x[u], x2 = x[u + kHalf];
      if (rope) {
        float sn, cs;
        sincosf(pos * freqs[c + u], &sn, &cs);
        sn = -sn;
        const float y1 = x1 * cs - x2 * sn;
        x2 = x1 * sn + x2 * cs;
        x1 = y1;
      }
      a[u] = from_f32<T>(x1);
      b[u] = from_f32<T>(x2);
    }
    T* row = dst + static_cast<size_t>(row0 + r) * D;
    *reinterpret_cast<uint4*>(row + c) = *reinterpret_cast<const uint4*>(a);
    *reinterpret_cast<uint4*>(row + c + kHalf) = *reinterpret_cast<const uint4*>(b);
  }
}

// The (query tile, member) item that thread group `grp` of a forward or dq
// block owns.  Blocks are numbered from the longest down, so the longest
// causal blocks start first.  An item past the end keeps the last live
// item's tile and member (valid pointers) with q_lim 0: every row masked.
struct Item {
  int qt, g, q_lim, kt_end;
  __device__ Item(int G, int S, int causal, int P, int grp) {
    const int n_tiles = (S + kTile - 1) / kTile;
    const int n_items = G * n_tiles;
    const int first = (gridDim.y - 1 - blockIdx.y) * P;
    const int last = min(first + P, n_items) - 1;
    const int mine = min(first + grp, last);
    qt = mine / G;
    g = mine % G;
    q_lim = first + grp < n_items ? S : 0;
    kt_end = causal ? last / G + 1 : n_tiles;  // the last item holds the latest diagonal
  }
};

template <typename T, int D, int P>
__global__ void __launch_bounds__(P * kThreads)
flash_v2_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out,
                    float* __restrict__ lse, int G, int S, int causal,
                    float scale, int rope, float rope_c) {
  using Gm = Geom<D>;
  constexpr int kN = P * kThreads;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int grp = tid / kThreads, ltid = tid % kThreads;
  const int tr = ltid / kTC, tc = ltid % kTC;
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + Gm::kTileFloats;
  float* freqs = vs + Gm::kTileFloats;
  float* qs = freqs + kMaxHalf + grp * (Gm::kTileFloats + kTile * kPStride);
  float* ps = qs + Gm::kTileFloats;  // [64][68] probabilities

  const Item it(G, S, causal, P, grp);
  const int q0 = it.qt * kTile;
  const size_t bkh = blockIdx.x;
  const size_t kv_base = bkh * S * D;
  const size_t row_base = (bkh * G + it.g) * S;  // member's rows in [B * H, S]

  if (rope) {
    rope_freqs<D, kN>(freqs, rope_c, tid);
    __syncthreads();
  }
  load_tile_rope<T, D, kThreads>(qs, q + row_base * D, q0, it.q_lim, ltid, rope, freqs);

  float m[4], l[4], acc[4][Gm::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskFill;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < Gm::kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < it.kt_end; ++kt) {
    __syncthreads();  // the previous tile's ks/vs/ps are consumed
    load_tile_rope<T, D, kN>(ks, k + kv_base, kt * kTile, S, tid, rope, freqs);
    load_tile<T, D, kN>(vs, v + kv_base, kt * kTile, S, tid);
    __syncthreads();

    float s[4][4];
    mm_abt<D>(qs, ks, tr, tc, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr * 4 + i;
      float mx = kMaskFill;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt * kTile + tc + kTC * j;
        s[i][j] = qi < it.q_lim && visible(qi, kj, S, causal) ? s[i][j] * scale : kMaskFill;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(tr * 4 + i) * kPStride + tc + kTC * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < Gm::kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    mm_nn<D, false>(ps, vs, tr, tc, acc);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / l[i];
  store_tile<T, D>(out + row_base * D, acc, inv, q0, it.q_lim, tr, tc);
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr * 4 + i;
      if (row < it.q_lim) lse[row_base + row] = m[i] + logf(l[i]);
    }
  }
}

// The rotation of the bf16 kernels, once per forward or backward: the rows
// of q [q_rows, D] and then of k [k_rows, D], row r of each rotated at
// position r % S as load_tile_rope rotates them and each value split into
// bf16 halves hi + lo (split8): q's halves at out and out + q_rows * D,
// k's after them.  One thread per pair of 16-byte chunks (c, c + D/2).
template <int D>
__global__ void __launch_bounds__(256)
flash_v2_rope_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           bf16* __restrict__ out, size_t q_rows, size_t k_rows,
                           int S, float rope_c) {
  constexpr int kPerRow = D / 16;
  size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bf16* x = q;
  bf16* hi = out;
  bf16* lo = out + q_rows * D;
  if (i >= q_rows * kPerRow) {
    i -= q_rows * kPerRow;
    if (i >= k_rows * kPerRow) return;
    x = k;
    hi = out + 2 * q_rows * D;
    lo = hi + k_rows * D;
  }
  const size_t row = i / kPerRow;
  const int c = static_cast<int>(i % kPerRow) * 8;
  const float pos = static_cast<float>(row % S);
  const size_t off = row * D + c;
  const uint4 a = *reinterpret_cast<const uint4*>(x + off);
  const uint4 b = *reinterpret_cast<const uint4*>(x + off + D / 2);
  float x1[8], x2[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float sn, cs;
    sincosf(pos * expf(static_cast<float>(c + u) * rope_c), &sn, &cs);
    const float e1 = bf16_at(a, u), e2 = bf16_at(b, u);
    x1[u] = e1 * cs - e2 * sn;
    x2[u] = e1 * sn + e2 * cs;
  }
  uint4 h1, l1, h2, l2;
  split8(x1, h1, l1);
  split8(x2, h2, l2);
  *reinterpret_cast<uint4*>(hi + off) = h1;
  *reinterpret_cast<uint4*>(hi + off + D / 2) = h2;
  *reinterpret_cast<uint4*>(lo + off) = l1;
  *reinterpret_cast<uint4*>(lo + off + D / 2) = l2;
}

// The bf16 forward: P groups of 4 warps a block, one (tile, member) item
// each, as flash_v2_fwd_kernel's P groups of 256 threads.  With rope, q
// and k are the hi halves of the rotated values and q_lo, k_lo the lo
// halves; without, q_lo and k_lo are null.
template <int D, int P>
__global__ void __launch_bounds__(P * kMmaThreads)
flash_v2_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ q_lo,
                        const bf16* __restrict__ k, const bf16* __restrict__ k_lo,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
                        float* __restrict__ lse, int G, int S, int causal,
                        float scale) {
  const Item it(G, S, causal, P, threadIdx.x / kMmaThreads);
  const size_t bkh = blockIdx.x;
  const size_t kv_base = bkh * S * D;
  const size_t row_base = (bkh * G + it.g) * S;
  mma_fwd_tile<D, P, true>(q + row_base * D, q_lo ? q_lo + row_base * D : nullptr,
                           k + kv_base, k_lo ? k_lo + kv_base : nullptr,
                           v + kv_base, out + row_base * D, lse + row_base,
                           it.qt * kTile, it.q_lim, it.kt_end, S, causal, scale);
}

// The bf16 dq: P groups of 4 warps a block, one (tile, member) item each,
// sharing one K/V ring.  With rope, q and k are the hi planes of the
// rotated values and q_lo, k_lo the lo planes; without, q_lo and k_lo are
// null.
template <int D, int P>
__global__ void __launch_bounds__(P * kMmaThreads)
flash_v2_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ q_lo,
                           const bf16* __restrict__ k, const bf16* __restrict__ k_lo,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dq, int G, int S, int causal, float scale,
                           float rope_c) {
  const Item it(G, S, causal, P, threadIdx.x / kMmaThreads);
  const size_t bkh = blockIdx.x;
  const size_t kv_base = bkh * S * D;
  const size_t row_base = (bkh * G + it.g) * S;
  mma_bwd_dq_tile<D, P, true>(q + row_base * D, q_lo ? q_lo + row_base * D : nullptr,
                              k + kv_base, k_lo ? k_lo + kv_base : nullptr, v + kv_base,
                              dout + row_base * D, lse + row_base, delta + row_base,
                              dq + row_base * D, it.qt * kTile, it.q_lim, it.kt_end, S,
                              causal, scale, rope_c);
}

// The bf16 dk/dv: one block of KT x 4 warps per (KT key tiles, b kh)
// (KT = kDkvKeyTiles), summing over the G members; causal: the longest
// blocks (key tile 0) first.  q_lo, k_lo as for dq.
template <int D, int KT>
__global__ void __launch_bounds__(KT * kMmaThreads)
flash_v2_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ q_lo,
                            const bf16* __restrict__ k, const bf16* __restrict__ k_lo,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int G, int S,
                            int causal, float scale, float rope_c) {
  const int kt = blockIdx.y * KT;
  const size_t bkh = blockIdx.x;
  const size_t kv_base = bkh * S * D;
  const size_t row_base = bkh * G * S;  // member 0's rows
  mma_bwd_dkv_tile<D, KT, true>(q + row_base * D, q_lo ? q_lo + row_base * D : nullptr,
                                k + kv_base, k_lo ? k_lo + kv_base : nullptr, v + kv_base,
                                dout + row_base * D, lse + row_base, delta + row_base,
                                dk + kv_base, dv + kv_base, kt * kTile, causal ? kt : 0, G,
                                S, causal, scale, rope_c);
}

template <typename T, int D, int P>
__global__ void __launch_bounds__(P * kThreads)
flash_v2_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dq, int G, int S, int causal, float scale,
                       int rope, float rope_c) {
  using Gm = Geom<D>;
  constexpr int kN = P * kThreads;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int grp = tid / kThreads, ltid = tid % kThreads;
  const int tr = ltid / kTC, tc = ltid % kTC;
  float* kvs = reinterpret_cast<float*>(smem4);  // V, then K, of one key tile
  float* freqs = kvs + Gm::kTileFloats;
  float* qs = freqs + kMaxHalf +
              grp * (2 * Gm::kTileFloats + kTile * kPStride + 2 * kTile);
  float* dos = qs + Gm::kTileFloats;
  float* dss = dos + Gm::kTileFloats;    // [64][68] ds
  float* rows = dss + kTile * kPStride;  // lse [64], delta [64]

  const Item it(G, S, causal, P, grp);
  const int q0 = it.qt * kTile;
  const size_t bkh = blockIdx.x;
  const size_t kv_base = bkh * S * D;
  const size_t row_base = (bkh * G + it.g) * S;

  if (rope) {
    rope_freqs<D, kN>(freqs, rope_c, tid);
    __syncthreads();
  }
  load_tile_rope<T, D, kThreads>(qs, q + row_base * D, q0, it.q_lim, ltid, rope, freqs);
  load_tile<T, D, kThreads>(dos, dout + row_base * D, q0, it.q_lim, ltid);
  load_rows(rows, lse + row_base, q0, it.q_lim, ltid);
  load_rows(rows + kTile, delta + row_base, q0, it.q_lim, ltid);
  __syncthreads();
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = rows[tr * 4 + i];
    delta_r[i] = rows[kTile + tr * 4 + i];
  }

  float acc[4][Gm::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < Gm::kCols; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt < it.kt_end; ++kt) {
    __syncthreads();  // the previous tile's ds k product is done with kvs, dss
    load_tile<T, D, kN>(kvs, v + kv_base, kt * kTile, S, tid);
    __syncthreads();
    float dp[4][4];
    mm_abt<D>(dos, kvs, tr, tc, dp);
    __syncthreads();  // every group has read V
    load_tile_rope<T, D, kN>(kvs, k + kv_base, kt * kTile, S, tid, rope, freqs);
    __syncthreads();

    float s[4][4];
    mm_abt<D>(qs, kvs, tr, tc, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt * kTile + tc + kTC * j;
        const float p = qi < it.q_lim && visible(qi, kj, S, causal)
                            ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[(tr * 4 + i) * kPStride + tc + kTC * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    mm_nn<D, false>(dss, kvs, tr, tc, acc);
  }

  // The group's q tile was last read before the loop's last barrier: it
  // takes dq, which leaves through the transpose rotation.
  spill_tile<D>(qs, acc, tr, tc);
  __syncthreads();
  store_tile_rope_t<T, D, kThreads>(dq + row_base * D, qs, q0, it.q_lim, ltid, rope, freqs);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_v2_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv, int G, int S,
                        int causal, float scale, int rope, float rope_c) {
  using Gm = Geom<D>;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + Gm::kTileFloats;
  float* qs = vs + Gm::kTileFloats;
  float* dos = qs + Gm::kTileFloats;
  float* ps = dos + Gm::kTileFloats;     // [64][68] p, rows = queries
  float* dss = ps + kTile * kPStride;    // [64][68] ds
  float* rows = dss + kTile * kPStride;  // lse [64], delta [64]
  float* freqs = rows + 2 * kTile;

  const int n_tiles = (S + kTile - 1) / kTile;
  const size_t bkh = blockIdx.x;
  const int kt = blockIdx.y;  // causal: the longest blocks (kt = 0) first
  const int k0 = kt * kTile;
  const size_t kv_base = bkh * S * D;
  const int tid = threadIdx.x;
  const int tr = tid / kTC, tc = tid % kTC;

  if (rope) {
    rope_freqs<D, kThreads>(freqs, rope_c, tid);
    __syncthreads();
  }
  load_tile_rope<T, D, kThreads>(ks, k + kv_base, k0, S, tid, rope, freqs);
  load_tile<T, D>(vs, v + kv_base, k0, S, tid);

  float dk_acc[4][Gm::kCols], dv_acc[4][Gm::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < Gm::kCols; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  // The G query heads of this KV head stream through one carry; in each,
  // query tiles above this key tile's diagonal see none of its keys.
  for (int g = 0; g < G; ++g) {
    const size_t row_base = (bkh * G + g) * S;
    for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's qs/dos/ps/dss/rows are consumed
      load_tile_rope<T, D, kThreads>(qs, q + row_base * D, q0, S, tid, rope, freqs);
      load_tile<T, D>(dos, dout + row_base * D, q0, S, tid);
      load_rows(rows, lse + row_base, q0, S, tid);
      load_rows(rows + kTile, delta + row_base, q0, S, tid);
      __syncthreads();

      // Scores with rows = queries (4 tr + i), columns = keys (tc + 16 j).
      float s[4][4], dp[4][4];
      mm_abt<D>(qs, ks, tr, tc, s);
      mm_abt<D>(dos, vs, tr, tc, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k0 + tc + kTC * j;
          const float p = visible(q0 + r, kj, S, causal) ? expf(s[i][j] * scale - rows[r]) : 0.f;
          ps[r * kPStride + tc + kTC * j] = p;
          dss[r * kPStride + tc + kTC * j] = p * (dp[i][j] - rows[kTile + r]) * scale;
        }
      }
      __syncthreads();
      // Rows of the accumulators = keys: dv += p^T dO, dk += ds^T q.
      mm_nn<D, true>(ps, dos, tr, tc, dv_acc);
      mm_nn<D, true>(dss, qs, tr, tc, dk_acc);
    }
  }

  // ks was last read before the loop's last barrier: it takes dk, which
  // leaves through the transpose rotation.
  spill_tile<D>(ks, dk_acc, tr, tc);
  __syncthreads();
  store_tile_rope_t<T, D, kThreads>(dk + kv_base, ks, k0, S, tid, rope, freqs);
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_tile<T, D>(dv + kv_base, dv_acc, one, k0, S, tr, tc);
}

// Dynamic shared memory of each kernel, in bytes.
template <int D, int P>
constexpr int fwd_v2_smem() {
  return (2 * Geom<D>::kTileFloats + kMaxHalf +
          P * (Geom<D>::kTileFloats + kTile * kPStride)) * 4;
}
template <int D, int P>
constexpr int dq_v2_smem() {
  return (Geom<D>::kTileFloats + kMaxHalf +
          P * (2 * Geom<D>::kTileFloats + kTile * kPStride + 2 * kTile)) * 4;
}
template <int D>
constexpr int dkv_v2_smem() {
  return (4 * Geom<D>::kTileFloats + 2 * kTile * kPStride + 2 * kTile + kMaxHalf) * 4;
}

// One block per P items of a KV head (forward, dq).
dim3 items_grid(int BKH, int G, int S, int P) {
  const int items = G * ((S + kTile - 1) / kTile);
  return dim3(BKH, (items + P - 1) / P);
}

// The bf16 kernels with rope read q and k from the pre-pass's planes (see
// flash_v2_rope_split_kernel: q's hi and lo planes, then k's): q, k become
// the hi planes and q_lo, k_lo the lo planes.  Otherwise q and k stay and
// q_lo, k_lo are null.  0, or kNoPlanes.
template <typename T>
int use_planes(const void* planes, int rope, int BKH, int G, int S, int D,
               const void*& q, const void*& q_lo, const void*& k, const void*& k_lo) {
  q_lo = k_lo = nullptr;
  if (!std::is_same_v<T, bf16> || !rope) return 0;
  if (planes == nullptr) return kNoPlanes;
  const size_t q_rows = static_cast<size_t>(BKH) * G * S;
  const size_t k_rows = static_cast<size_t>(BKH) * S;
  const bf16* base = static_cast<const bf16*>(planes);
  q = base;
  q_lo = base + q_rows * D;
  k = base + 2 * q_rows * D;
  k_lo = base + (2 * q_rows + k_rows) * D;
  return 0;
}

template <typename T, int D>
struct RopeSplitV2 {
  static int run(const void* q, const void* k, void* planes, int BKH, int G, int S,
                 float rope_c, cudaStream_t st) {
    if constexpr (!std::is_same_v<T, bf16>) {
      return -1;
    } else {
      const size_t q_rows = static_cast<size_t>(BKH) * G * S;
      const size_t k_rows = static_cast<size_t>(BKH) * S;
      const size_t n_pairs = (q_rows + k_rows) * (D / 16);
      flash_v2_rope_split_kernel<D><<<static_cast<unsigned>((n_pairs + 255) / 256), 256, 0, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<bf16*>(planes),
          q_rows, k_rows, S, rope_c);
      return static_cast<int>(cudaGetLastError());
    }
  }
};

template <typename T, int D>
struct FwdV2 {
  template <int P>
  static int launch(const void* q, const void* q_lo, const void* k,
                    const void* k_lo, const void* v, void* out, void* lse,
                    int BKH, int G, int S, int causal, float scale, int rope,
                    float rope_c, cudaStream_t st) {
    if constexpr (std::is_same_v<T, bf16>) {
      constexpr int smem = mma_fwd_smem<D, P, true>();
      static_assert(smem <= 232448, "forward exceeds a block's shared memory");
      if (int rc = prepare(flash_v2_fwd_mma_kernel<D, P>, smem)) return rc;
      flash_v2_fwd_mma_kernel<D, P><<<items_grid(BKH, G, S, P), P * kMmaThreads, smem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(q_lo),
          static_cast<const bf16*>(k), static_cast<const bf16*>(k_lo),
          static_cast<const bf16*>(v), static_cast<bf16*>(out),
          static_cast<float*>(lse), G, S, causal, scale);
    } else {
      constexpr int smem = fwd_v2_smem<D, P>();
      static_assert(smem <= 232448, "forward exceeds a block's shared memory");
      if (int rc = prepare(flash_v2_fwd_kernel<T, D, P>, smem)) return rc;
      flash_v2_fwd_kernel<T, D, P><<<items_grid(BKH, G, S, P), P * kThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out),
          static_cast<float*>(lse), G, S, causal, scale, rope, rope_c);
    }
    return static_cast<int>(cudaGetLastError());
  }
  // bf16 with rope: q and k come as the pre-pass's planes.
  static int run(const void* q, const void* k, const void* v, void* out,
                 void* lse, const void* planes, int BKH, int G, int S, int causal,
                 float scale, int rope, float rope_c, int pipeline,
                 cudaStream_t st) {
    if (pipeline != 1 && pipeline != 2) return kNoPipelineInstance;
    const void *q_lo, *k_lo;
    if (int rc = use_planes<T>(planes, rope, BKH, G, S, D, q, q_lo, k, k_lo)) return rc;
    return pipeline == 1
        ? launch<1>(q, q_lo, k, k_lo, v, out, lse, BKH, G, S, causal, scale, rope, rope_c, st)
        : launch<2>(q, q_lo, k, k_lo, v, out, lse, BKH, G, S, causal, scale, rope, rope_c, st);
  }
};

template <typename T, int D>
struct BwdDqV2 {
  template <int P>
  static int launch(const void* q, const void* q_lo, const void* k, const void* k_lo,
                    const void* v, const void* dout, const void* lse, const void* delta,
                    void* dq, int BKH, int G, int S, int causal, float scale, int rope,
                    float rope_c, cudaStream_t st) {
    if constexpr (std::is_same_v<T, bf16>) {
      constexpr int smem = mma_bwd_dq_smem<D, P, true>();
      static_assert(smem <= 232448, "dq exceeds a block's shared memory");
      if (int rc = prepare(flash_v2_bwd_dq_mma_kernel<D, P>, smem)) return rc;
      flash_v2_bwd_dq_mma_kernel<D, P><<<items_grid(BKH, G, S, P), P * kMmaThreads, smem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(q_lo),
          static_cast<const bf16*>(k), static_cast<const bf16*>(k_lo),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dq), G, S, causal, scale, rope_c);
    } else {
      constexpr int smem = dq_v2_smem<D, P>();
      static_assert(smem <= 232448, "dq exceeds a block's shared memory");
      if (int rc = prepare(flash_v2_bwd_dq_kernel<T, D, P>, smem)) return rc;
      flash_v2_bwd_dq_kernel<T, D, P><<<items_grid(BKH, G, S, P), P * kThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dq), G, S, causal, scale, rope, rope_c);
    }
    return static_cast<int>(cudaGetLastError());
  }
  static int run(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, const void* planes,
                 int BKH, int G, int S, int causal, float scale, int rope, float rope_c,
                 int pipeline, cudaStream_t st) {
    if (pipeline != 1 && pipeline != 2) return kNoPipelineInstance;
    const void *q_lo, *k_lo;
    if (int rc = use_planes<T>(planes, rope, BKH, G, S, D, q, q_lo, k, k_lo)) return rc;
    return pipeline == 1
        ? launch<1>(q, q_lo, k, k_lo, v, dout, lse, delta, dq, BKH, G, S, causal, scale,
                    rope, rope_c, st)
        : launch<2>(q, q_lo, k, k_lo, v, dout, lse, delta, dq, BKH, G, S, causal, scale,
                    rope, rope_c, st);
  }
};

template <typename T, int D>
struct BwdDkvV2 {
  static int run(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dk, void* dv,
                 const void* planes, int BKH, int G, int S, int causal, float scale,
                 int rope, float rope_c, cudaStream_t st) {
    if constexpr (std::is_same_v<T, bf16>) {
      constexpr int kKT = kDkvKeyTiles;
      constexpr int smem = mma_bwd_dkv_smem<D, kKT, true>();
      static_assert(smem <= 232448, "dk/dv exceeds a block's shared memory");
      const void *q_lo, *k_lo;
      if (int rc = use_planes<T>(planes, rope, BKH, G, S, D, q, q_lo, k, k_lo)) return rc;
      if (int rc = prepare(flash_v2_bwd_dkv_mma_kernel<D, kKT>, smem)) return rc;
      const int n_tiles = (S + kTile - 1) / kTile;
      const dim3 grid(BKH, (n_tiles + kKT - 1) / kKT);
      flash_v2_bwd_dkv_mma_kernel<D, kKT><<<grid, kKT * kMmaThreads, smem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(q_lo),
          static_cast<const bf16*>(k), static_cast<const bf16*>(k_lo),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), G, S, causal, scale, rope_c);
      return static_cast<int>(cudaGetLastError());
    } else {
      constexpr int smem = dkv_v2_smem<D>();
      static_assert(smem <= 232448, "dk/dv exceeds a block's shared memory");
      if (int rc = prepare(flash_v2_bwd_dkv_kernel<T, D>, smem)) return rc;
      const dim3 grid(BKH, (S + kTile - 1) / kTile);
      flash_v2_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dk), static_cast<T*>(dv), G, S, causal, scale, rope,
          rope_c);
      return static_cast<int>(cudaGetLastError());
    }
  }
};

// The forward's dynamic shared memory, in bytes.
template <typename T, int D>
struct FwdSmemV2 {
  static int run(int pipeline) {
    if (pipeline != 1 && pipeline != 2) return kNoPipelineInstance;
    if constexpr (std::is_same_v<T, bf16>)
      return pipeline == 1 ? mma_fwd_smem<D, 1, true>() : mma_fwd_smem<D, 2, true>();
    else
      return pipeline == 1 ? fwd_v2_smem<D, 1>() : fwd_v2_smem<D, 2>();
  }
};

// A backward instance's dynamic shared memory: dq (dkv = 0) at a pipeline
// factor, or dk/dv (dkv = 1).
template <typename T, int D>
struct BwdSmemV2 {
  static int run(int dkv, int pipeline) {
    if constexpr (std::is_same_v<T, bf16>) {
      if (dkv) return mma_bwd_dkv_smem<D, kDkvKeyTiles, true>();
      if (pipeline != 1 && pipeline != 2) return kNoPipelineInstance;
      return pipeline == 1 ? mma_bwd_dq_smem<D, 1, true>() : mma_bwd_dq_smem<D, 2, true>();
    } else {
      if (dkv) return dkv_v2_smem<D>();
      if (pipeline != 1 && pipeline != 2) return kNoPipelineInstance;
      return pipeline == 1 ? dq_v2_smem<D, 1>() : dq_v2_smem<D, 2>();
    }
  }
};

}  // namespace

// Each returns 0, a cudaError_t from preparing or launching, -1 for a
// type/head width without an instance, -2 for a pipeline without one or
// -3 for a bf16 rope kernel without the pre-pass's planes.  Type codes: 0
// float32, 1 bfloat16.  q, dout, out, dq: [BKH * G, S, D] contiguous; k, v, dk, dv:
// [BKH, S, D]; lse, delta: [BKH * G, S] float32; planes (the bf16 rope
// kernels', else null): 2 * (BKH * G + BKH) * S * D bf16 values written by
// flash_attention_v2_rope_split.  rope 0/1 and rope_c = -ln(theta) /
// (D / 2).  Nothing is synchronised or allocated here.
extern "C" int flash_attention_v2_rope_split(const void* q, const void* k, void* planes,
                                             int BKH, int G, int S, int D, float rope_c,
                                             void* stream) {
  return dispatch<RopeSplitV2>(kBF16, D, q, k, planes, BKH, G, S, rope_c,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_v2_fwd(const void* q, const void* k, const void* v,
                                      void* out, void* lse, const void* planes,
                                      int BKH, int G, int S, int D, int causal,
                                      float scale, int rope, float rope_c,
                                      int pipeline, int dtype, void* stream) {
  return dispatch<FwdV2>(dtype, D, q, k, v, out, lse, planes, BKH, G, S, causal,
                         scale, rope, rope_c, pipeline,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_v2_bwd_dq(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, const void* planes, int BKH, int G,
                                         int S, int D, int causal, float scale, int rope,
                                         float rope_c, int pipeline, int dtype,
                                         void* stream) {
  return dispatch<BwdDqV2>(dtype, D, q, k, v, dout, lse, delta, dq, planes, BKH, G,
                           S, causal, scale, rope, rope_c, pipeline,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_v2_bwd_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv, const void* planes,
                                          int BKH, int G, int S, int D, int causal,
                                          float scale, int rope, float rope_c,
                                          int dtype, void* stream) {
  return dispatch<BwdDkvV2>(dtype, D, q, k, v, dout, lse, delta, dk, dv, planes,
                            BKH, G, S, causal, scale, rope, rope_c,
                            static_cast<cudaStream_t>(stream));
}

// The forward instance's dynamic shared memory in bytes, -1 or -2.
extern "C" int flash_attention_v2_fwd_smem(int D, int pipeline, int dtype) {
  return dispatch<FwdSmemV2>(dtype, D, pipeline);
}

// A backward instance's dynamic shared memory in bytes (dq: dkv = 0 at a
// pipeline factor; dk/dv: dkv = 1), -1 or -2.
extern "C" int flash_attention_v2_bwd_smem(int D, int dtype, int dkv, int pipeline) {
  return dispatch<BwdSmemV2>(dtype, D, dkv, pipeline);
}

extern "C" const char* flash_attention_v2_error_string(int code) {
  if (code == -1) return "no kernel instance for this dtype/head width";
  if (code == kNoPipelineInstance) return "no kernel instance for this q_pipeline";
  if (code == kNoPlanes) return "the bf16 rope kernels need the pre-pass's planes";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
