// The bf16 flash-attention backward on Hopper's tensor cores: the device
// code of the v1 dq and dk/dv kernels (flash_attention.cu,
// flash_bwd_dq_mma_kernel and flash_bwd_dkv_mma_kernel) and of the v2 ones
// (flash_attention_v2.cu, flash_v2_bwd_dq_mma_kernel and
// flash_v2_bwd_dkv_mma_kernel).  The float32 instances stay on the CUDA
// cores (flash_common.cuh, flash_attention_v2.cu).
//
// The functions are those of the kernels they replace (_bwd_dq_kernel,
// _bwd_dkv_kernel, _bwd_dq_kernel_v2 and _bwd_dkv_kernel_v2 of
// k8s_gpu_tpu/ops/attention.py): from q, k, v, dO in bf16 and lse, delta =
// rowsum(dO * O) - g_lse in f32, p = exp(s - lse) is recomputed per tile
// and ds = p (dp - delta) scale with dp = dO v^T; then dq = ds k, dk =
// ds^T q and dv = p^T dO, accumulated in f32 and rounded once to bf16.
// Causal or not, masked p exactly 0, any S.  v2 adds K/V at their own KV
// heads (dk and dv summed over the G query heads of a KV head in one
// block) and rope: q and k rotated in f32 at their sequence positions, and
// dq and dk leaving through the transpose rotation (the angle negated).
//
// Two roundings are new (as in SDPA and FlashAttention): p is rounded to
// bf16 before dv += p^T dO, and ds (from the f32 p and dp, after the
// subtraction) before dq += ds k and dk += ds^T q.  bf16 keeps 8
// significant bits, so each rounded factor is x (1 + e) with |e| <= 2^-8
// (the unit roundoff), and the products and sums that follow are exact
// products in f32 with f32 sums.  An output element therefore moves by at
// most 2^-8 times the same sum taken over absolute values:
//   |d dv_j| = |sum_i e_ij p_ij dO_i|  <= 2^-8 sum_i p_ij |dO_i|  = 2^-8 (P^T |dO|)_j
//   |d dk_j| = |sum_i e_ij ds_ij q_i|  <= 2^-8 sum_i |ds_ij| |q_i| = 2^-8 (|dS|^T |Q|)_j
//   |d dq_i| = |sum_j e_ij ds_ij k_j|  <= 2^-8 sum_j |ds_ij| |k_j| = 2^-8 (|dS| |K|)_i
// (element-wise, p >= 0).  ops/attention.py's reference_bwd_rounding
// computes these terms; the tests and chip_smoke.py hold the kernels to
// them on top of the output's own rounding and summation order.
//
// With rope the rotated q and k are not bf16 values.  As the v2 forward
// does (flash_mma.cuh), the scores take them as bf16 halves hi + lo made
// once per backward by flash_v2_rope_split_kernel: S = Qhi Khi^T + Qhi
// Klo^T + Qlo Khi^T, off by at most 3 2^-16 scale sum_i |q_i k_i|, which
// moves each p and ds by a factor of up to e^delta - 1.  dS K and dS^T Q
// take the hi planes only: one more rounding of an operand (2^-8), so the
// factor of those two products is 2^-7 + 2^-16.  The accumulators are
// rotated back in f32 before the one rounding of the output.
// reference_bwd_rounding_v2 computes that bound.
//
// What bounds it on the H100: operations (dq 6 D and dk/dv 8 D flops per
// visible (query, key) pair of the query heads, 0.31 and 0.42 ms at the
// flagship training shape against 989 TFLOP/s bf16; the split adds 4 D to
// each), and before that the shared-memory reads of the streamed tiles,
// which each of a block's warps reads whole.
//
// The design (flash_mma.cuh's primitives: padded tiles, cp.async,
// ldmatrix, mma.sync m16n8k16 with f32 accumulators):
// - dq: a group of 4 warps owns a 64-row query tile, 16 rows a warp; a
//   block holds P groups that share one K/V ring (v2's q pipeline, as the
//   forward's), longest causal tiles first.  Q and dO are staged once (Q's
//   hi fragments then held in registers, dO's and Q lo's read per tile),
//   lse and delta of the thread's two rows held in registers; K (hi and
//   lo) and V stream through a two-stage cp.async ring.  Per key tile: S =
//   Q K^T and dP = dO V^T (16x64 a warp, K and V read by ldmatrix as they
//   are), p and ds on the accumulator fragments, ds packed to bf16 in
//   registers (the accumulator layout is the A-operand layout) and dQ +=
//   dS K with K read by ldmatrix.trans.  No score tile goes through shared
//   memory.
// - dk/dv: a block of 4 KT warps owns KT 64-row key tiles, 16 keys a
//   warp (v1 one tile, two blocks an SM; v2 two tiles, whose 8 warps share
//   one ring, as the split's planes leave room for one block an SM).  K
//   (hi and lo) and V are staged once; Q (hi and lo), dO and the tile's
//   lse and delta rows stream through the two-stage ring from the first
//   key tile's diagonal on (reference :226), over the query tiles of each
//   of the G query heads in turn, the next head's first tile in flight
//   while the last one is multiplied.  The transposed products are taken
//   directly so a warp owns its keys' rows: S^T = K Q^T and dP^T = V dO^T,
//   then dV += P^T dO and dK += dS^T Q with dO and Q read by
//   ldmatrix.trans.  lse and delta are per column here, read from shared
//   memory.  Two 16xD accumulators (128 floats a thread at D 128) leave no
//   room for 16x64 score tiles and K/V fragments, so the 64 queries of a
//   tile are taken in two halves of 32, and the K and V fragments are read
//   from shared memory for each half.
// - The transpose rotation of dq and dk is done on the f32 accumulators in
//   registers: a thread's columns n 8 + 2 (lane % 4) + {0, 1} pair column
//   c with c + D/2 in the same thread at n + D/16, so each pair rotates at
//   its row's position (accurate sincosf, the frequencies exp(i c) in f32
//   as the pre-pass computes them) before the one rounding to bf16.
// - Masking as in mma_fwd_tile: only tiles that touch the diagonal, the
//   ragged tail or dead rows test each score (every invisible p is 0); a
//   warp whose rows see none of a tile's (or half's) columns skips its
//   products.  Outputs leave through the warp's own rows of a staged tile
//   in 16-byte stores of the live rows.
// - One block a tile (or KT tiles), two kernels, no atomics: dq, dk and dv
//   are deterministic.

#pragma once

#include "flash_mma.cuh"

namespace {

// dq: two stages of K (hi, and lo with kSplit) and V, and P groups' Q (hi,
// lo) and dO.  dk/dv: KT tiles of K (hi, lo) and V, two stages of Q (hi,
// lo) and dO, and two stages of the tile's lse and delta rows (64 f32
// each).
template <int D, int P = 1, bool kSplit = false>
constexpr int mma_bwd_dq_smem() {
  return (2 * (2 + kSplit) + P * (2 + kSplit)) * MmaTile<D>::kBytes;
}
template <int D, int KT = 1, bool kSplit = false>
constexpr int mma_bwd_dkv_smem() {
  return (KT * (2 + kSplit) + 2 * (2 + kSplit)) * MmaTile<D>::kBytes + 2 * 2 * kTile * 4;
}

// 4 bytes global -> shared (an f32 row value; its row need not be 16-byte
// aligned), or 4 zero bytes when !full.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 4 : 0) : "memory");
}

// c0 += a b[0..1], c1 += a b[2..3] for one ldmatrix of B, read as it is
// or (kTrans) transposed.
template <bool kTrans>
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4],
                                         const uint32_t (&a)[4], uint32_t b_addr) {
  uint32_t b[4];
  if constexpr (kTrans) ldsm_x4_t(b_addr, b);
  else ldsm_x4(b_addr, b);
  mma_bf16(c0, a, b[0], b[1]);
  mma_bf16(c1, a, b[2], b[3]);
}

// The split's three products of one ldmatrix pair of B: c0, c1 += a_hi
// b_hi + a_lo b_hi + a_hi b_lo, B's hi plane at b_addr and its lo plane
// at b_addr + lo_off.
__device__ __forceinline__ void mma_pair_split(float (&c0)[4], float (&c1)[4],
                                               const uint32_t (&a_hi)[4],
                                               const uint32_t (&a_lo)[4],
                                               uint32_t b_addr, uint32_t lo_off) {
  uint32_t b[4];
  ldsm_x4(b_addr, b);
  mma_bf16(c0, a_hi, b[0], b[1]);
  mma_bf16(c1, a_hi, b[2], b[3]);
  mma_bf16(c0, a_lo, b[0], b[1]);
  mma_bf16(c1, a_lo, b[2], b[3]);
  ldsm_x4(b_addr + lo_off, b);
  mma_bf16(c0, a_hi, b[0], b[1]);
  mma_bf16(c1, a_hi, b[2], b[3]);
}

// The transpose rotation of a warp's 16xD f32 accumulator tile in
// registers: element 2 h + j of accumulator n is row h of the thread's pair
// (at sequence position pos[h]) and column c = n 8 + 2 (lane % 4) + j,
// whose partner column c + D/2 is the same element of accumulator n +
// D/16.  Each pair turns by the angle -pos exp(c rope_c), computed as the
// pre-pass computes the forward angle.
template <int D>
__device__ __forceinline__ void rotate_rows_t(float (&acc)[D / 8][4], const int (&pos)[2],
                                              float rope_c, int lane) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float freq = expf(static_cast<float>(n * 8 + lane % 4 * 2 + j) * rope_c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sn, cs;
        sincosf(static_cast<float>(pos[h]) * freq, &sn, &cs);
        const float x1 = acc[n][2 * h + j], x2 = acc[n + D / 16][2 * h + j];
        acc[n][2 * h + j] = x1 * cs + x2 * sn;
        acc[n + D / 16][2 * h + j] = x2 * cs - x1 * sn;
      }
    }
}

// One group's dq over its query tile [q0, q0 + 64): q (and q_lo), dout,
// dq are the group's [.., D] member slab (row 0 = sequence position 0),
// lse and delta its rows, k (and k_lo), v its KV head's [S, D].  Rows q0 +
// r < q_lim are live; key tiles [0, kt_end) are walked, and every group of
// the block passes the same barriers, so kt_end is the block's.  With
// kSplit and lo planes given (not null: the rope case), q and k are the
// hi halves of the rotated values, S takes the three products and dq
// leaves through the transpose rotation (rope_c = -ln(theta) / (D / 2)).
// Launched with P * kMmaThreads threads and mma_bwd_dq_smem<D, P,
// kSplit>() bytes of dynamic shared memory.
template <int D, int P, bool kSplit>
__device__ __forceinline__ void mma_bwd_dq_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ q_lo,
    const bf16* __restrict__ k, const bf16* __restrict__ k_lo,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int q0, int q_lim, int kt_end, int S, int causal,
    float scale, float rope_c) {
  using M = MmaTile<D>;
  constexpr int kN = P * kMmaThreads;
  constexpr int kPlanes = kSplit ? 2 : 1;  // hi (and lo) planes of q and k
  extern __shared__ float4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);
  const int tid = threadIdx.x;
  const int grp = P == 1 ? 0 : tid / kMmaThreads;
  const int gtid = P == 1 ? tid : tid % kMmaThreads;
  const int warp = gtid / 32, lane = tid % 32;
  char* const qs = smem + grp * (kPlanes + 1) * M::kBytes;  // Q planes, then dO
  char* const dos = qs + kPlanes * M::kBytes;
  // K stage s plane p at ks + (s * kPlanes + p) tiles; V stage s at vs + s.
  char* const ks = smem + P * (kPlanes + 1) * M::kBytes;
  char* const vs = ks + 2 * kPlanes * M::kBytes;
  const bool split = kSplit && k_lo != nullptr;

  stage_async<D, kMmaThreads>(qs, q, q0, q_lim, gtid);
  if (split) stage_async<D, kMmaThreads>(qs + M::kBytes, q_lo, q0, q_lim, gtid);
  stage_async<D, kMmaThreads>(dos, dout, q0, q_lim, gtid);
  stage_async<D, kN>(ks, k, 0, S, tid);
  if (split) stage_async<D, kN>(ks + M::kBytes, k_lo, 0, S, tid);
  stage_async<D, kN>(vs, v, 0, S, tid);
  cp_async_commit();

  // The thread's rows lane/4 and lane/4 + 8 of its warp's 16; lse in
  // log2 units, as the exponentials are exp2.
  const int row_lo = q0 + warp * 16;
  const int rows[2] = {row_lo + lane / 4, row_lo + lane / 4 + 8};
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = rows[h] < q_lim;
    lse2[h] = live ? lse[rows[h]] * kLog2e : 0.f;
    dlt[h] = live ? delta[rows[h]] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const uint32_t a_lane = a_lane_off<D>(lane), b_lane = b_lane_off<D>(lane);
  const uint32_t q_addr = smem_u32(qs) + warp * 16 * M::kRowBytes + a_lane;
  const uint32_t do_addr = smem_u32(dos) + warp * 16 * M::kRowBytes + a_lane;
  uint32_t qf[D / 16][4];  // the warp's 16 Q rows (hi plane), per 16 columns
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(q_addr + kk * 32, qf[kk]);

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float scale2 = scale * kLog2e;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int cur = kt & 1;
    if (kt > 0) {
      cp_async_wait_all();
      __syncthreads();  // tile kt has landed; tile kt - 1's stage is free
    }
    if (kt + 1 < kt_end) {
      const int next0 = (kt + 1) * kTile;
      char* const knext = ks + (cur ^ 1) * kPlanes * M::kBytes;
      stage_async<D, kN>(knext, k, next0, S, tid);
      if (split) stage_async<D, kN>(knext + M::kBytes, k_lo, next0, S, tid);
      stage_async<D, kN>(vs + (cur ^ 1) * M::kBytes, v, next0, S, tid);
      cp_async_commit();
    }
    const int k0 = kt * kTile;
    if (row_lo >= q_lim || (causal && k0 > row_lo + 15)) continue;

    // S = Q K^T and dP = dO V^T, 16x64 each.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    const uint32_t kb = smem_u32(ks + cur * kPlanes * M::kBytes);
    const uint32_t vb = smem_u32(vs + cur * M::kBytes);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t df[4], ql[4];
      ldsm_x4(do_addr + kk * 32, df);
      if (split) ldsm_x4(q_addr + M::kBytes + kk * 32, ql);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const uint32_t off = b_lane + np * 16 * M::kRowBytes + kk * 32;
        if (split) mma_pair_split(s[2 * np], s[2 * np + 1], qf[kk], ql, kb + off, M::kBytes);
        else mma_pair<false>(s[2 * np], s[2 * np + 1], qf[kk], kb + off);
        mma_pair<false>(dp[2 * np], dp[2 * np + 1], df, vb + off);
      }
    }

    // ds = p (dp - delta) scale, p = exp2(s scale log2e - lse log2e); 0
    // where the score is invisible.
    const bool edge = (causal && k0 + kTile - 1 > row_lo) || k0 + kTile > S ||
                      row_lo + 16 > q_lim;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_ftz(fmaf(s[n][e], scale2, -lse2[e / 2]));
        if (edge) {
          const int key = k0 + n * 8 + lane % 4 * 2 + (e & 1);
          const int row = rows[e / 2];
          if (!(row < q_lim && key < S && (!causal || key <= row))) p = 0.f;
        }
        s[n][e] = p * (dp[n][e] - dlt[e / 2]) * scale;
      }

    // dQ += dS K: dS in bf16 from the accumulators, K (hi plane)
    // transposed.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      pack_a(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd)
        mma_pair<true>(acc[2 * dd], acc[2 * dd + 1], a,
                       kb + a_lane + kk * 16 * M::kRowBytes + dd * 32);
    }
  }

  // Back to the unrotated basis in f32; then out through the warp's Q rows
  // of the hi plane, which were read only into qf.
  if (split) rotate_rows_t<D>(acc, rows, rope_c, lane);
  const float one[2] = {1.f, 1.f};
  store_warp_rows<D>(qs + warp * 16 * M::kRowBytes, acc, one, dq, row_lo, q_lim, lane);
}

// Rows [row0, row0 + 64) of lse and delta -> a row stage (lse, then
// delta), by cp.async over threads [0, 2 x 64) of the block; 0 at or past
// lim.
__device__ __forceinline__ void stage_rows_async(float* dst, const float* __restrict__ lse,
                                                 const float* __restrict__ delta, int row0,
                                                 int lim, int tid) {
  static_assert(kMmaThreads == 2 * kTile, "one row value a thread");
  const int r = tid % kTile;
  const bool live = row0 + r < lim;
  cp_async4(smem_u32(dst + tid), (tid < kTile ? lse : delta) + (live ? row0 + r : 0), live);
}

// One block's dk and dv over its KT key tiles [k0, k0 + 64 KT): k (and
// k_lo), v, dk, dv are the KV head's [S, D] slabs; q (and q_lo), dout are
// the first of its G query heads' [S, D] slabs and lse, delta its [S]
// rows, head g's at g * S rows further.  Query tiles [qt0, n_tiles) of
// each head are walked, qt0 < n_tiles, and dk, dv are summed over the G
// heads.  With kSplit and lo planes given (the rope case), q and k are the
// hi halves, S^T takes the three products and dk leaves through the
// transpose rotation.  Launched with KT * kMmaThreads threads and
// mma_bwd_dkv_smem<D, KT, kSplit>() bytes of dynamic shared memory.
template <int D, int KT, bool kSplit>
__device__ __forceinline__ void mma_bwd_dkv_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ q_lo,
    const bf16* __restrict__ k, const bf16* __restrict__ k_lo,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int k0, int qt0, int G, int S,
    int causal, float scale, float rope_c) {
  using M = MmaTile<D>;
  constexpr int kN = KT * kMmaThreads;
  constexpr int kPlanes = kSplit ? 2 : 1;
  extern __shared__ float4 smem4[];
  char* const ks = reinterpret_cast<char*>(smem4);  // KT tiles a plane
  char* const vs = ks + kPlanes * KT * M::kBytes;
  char* const qs = vs + KT * M::kBytes;            // Q stage s plane p at qs + (s kPlanes + p) tiles
  char* const dos = qs + 2 * kPlanes * M::kBytes;  // dO stage s at dos + s tiles
  float* const rws = reinterpret_cast<float*>(dos + 2 * M::kBytes);  // stage s at + 2 s kTile
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = (S + kTile - 1) / kTile;
  const bool split = kSplit && k_lo != nullptr;
  const bool rows_thread = KT == 1 || tid < 2 * kTile;  // copies one lse or delta value

#pragma unroll
  for (int t = 0; t < KT; ++t) {
    stage_async<D, kN>(ks + t * M::kBytes, k, k0 + t * kTile, S, tid);
    if (split) stage_async<D, kN>(ks + (KT + t) * M::kBytes, k_lo, k0 + t * kTile, S, tid);
    stage_async<D, kN>(vs + t * M::kBytes, v, k0 + t * kTile, S, tid);
  }
  stage_async<D, kN>(qs, q, qt0 * kTile, S, tid);
  if (split) stage_async<D, kN>(qs + M::kBytes, q_lo, qt0 * kTile, S, tid);
  stage_async<D, kN>(dos, dout, qt0 * kTile, S, tid);
  if (rows_thread) stage_rows_async(rws, lse, delta, qt0 * kTile, S, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int key_lo = k0 + warp * 16;
  const int keys[2] = {key_lo + lane / 4, key_lo + lane / 4 + 8};
  const uint32_t a_lane = a_lane_off<D>(lane), b_lane = b_lane_off<D>(lane);
  const uint32_t k_addr = smem_u32(ks) + warp * 16 * M::kRowBytes + a_lane;
  const uint32_t v_addr = smem_u32(vs) + warp * 16 * M::kRowBytes + a_lane;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float scale2 = scale * kLog2e;
  const int n_q = n_tiles - qt0;

  // One stream of G x n_q query tiles: head g's tiles, then head g + 1's.
  for (int g = 0; g < G; ++g) {
    for (int qt = qt0; qt < n_tiles; ++qt) {
      const int cur = (g * n_q + qt - qt0) & 1;
      if (g > 0 || qt > qt0) {
        cp_async_wait_all();
        __syncthreads();  // this tile has landed; the previous one's stage is free
      }
      const bool here = qt + 1 < n_tiles;  // the next tile is this head's
      if (here || g + 1 < G) {
        const size_t rows0 = static_cast<size_t>(here ? g : g + 1) * S;
        const int next0 = (here ? qt + 1 : qt0) * kTile;
        char* const qn = qs + (cur ^ 1) * kPlanes * M::kBytes;
        stage_async<D, kN>(qn, q + rows0 * D, next0, S, tid);
        if (split) stage_async<D, kN>(qn + M::kBytes, q_lo + rows0 * D, next0, S, tid);
        stage_async<D, kN>(dos + (cur ^ 1) * M::kBytes, dout + rows0 * D, next0, S, tid);
        if (rows_thread)
          stage_rows_async(rws + (cur ^ 1) * 2 * kTile, lse + rows0, delta + rows0, next0, S,
                           tid);
        cp_async_commit();
      }
      if (key_lo >= S) continue;
      const int q0 = qt * kTile;
      const uint32_t qb = smem_u32(qs + cur * kPlanes * M::kBytes);
      const uint32_t db = smem_u32(dos + cur * M::kBytes);
      const float* const lse_s = rws + cur * 2 * kTile;
      const float* const delta_s = lse_s + kTile;

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = h * 32;  // the half's first query in the tile
        const int qh = q0 + c0;
        if (qh >= S || (causal && key_lo > qh + 31)) continue;

        // S^T = K Q^T and dP^T = V dO^T over the half: 16 keys x 32 queries.
        float st[4][4], dpt[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
        // K's planes, then V, each fragment read again for each half
        // (held beside the two accumulators they spill at D 128): at most
        // two fragments are live at once.
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ka[4], kl[4];
          ldsm_x4(k_addr + kk * 32, ka);
          if (split) ldsm_x4(k_addr + KT * M::kBytes + kk * 32, kl);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const uint32_t off = b_lane + (c0 + np * 16) * M::kRowBytes + kk * 32;
            if (split) mma_pair_split(st[2 * np], st[2 * np + 1], ka, kl, qb + off, M::kBytes);
            else mma_pair<false>(st[2 * np], st[2 * np + 1], ka, qb + off);
          }
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t va[4];
          ldsm_x4(v_addr + kk * 32, va);
#pragma unroll
          for (int np = 0; np < 2; ++np)
            mma_pair<false>(dpt[2 * np], dpt[2 * np + 1], va,
                            db + b_lane + (c0 + np * 16) * M::kRowBytes + kk * 32);
        }

        // p^T and ds^T with the columns' lse and delta.
        const bool edge = (causal && key_lo + 15 > qh) || qh + 32 > S || key_lo + 16 > S;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = c0 + n * 8 + lane % 4 * 2;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
          const float2 d2 = *reinterpret_cast<const float2*>(delta_s + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2_ftz(fmaf(st[n][e], scale2, -(e & 1 ? l2.y : l2.x) * kLog2e));
            if (edge) {
              const int query = q0 + c + (e & 1);
              const int key = keys[e / 2];
              if (!(query < S && key < S && (!causal || key <= query))) p = 0.f;
            }
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - (e & 1 ? d2.y : d2.x)) * scale;
          }
        }

        // dV += P^T dO and dK += dS^T Q (hi plane) over the half's 32
        // queries, P^T and dS^T in bf16 from the accumulators, dO and Q
        // transposed.
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t ap[4], as[4];
          pack_a(st[2 * kk], st[2 * kk + 1], ap);
          pack_a(dpt[2 * kk], dpt[2 * kk + 1], as);
          const uint32_t off = a_lane + (c0 + kk * 16) * M::kRowBytes;
#pragma unroll
          for (int dd = 0; dd < D / 16; ++dd) {
            mma_pair<true>(dva[2 * dd], dva[2 * dd + 1], ap, db + off + dd * 32);
            mma_pair<true>(dka[2 * dd], dka[2 * dd + 1], as, qb + off + dd * 32);
          }
        }
      }
    }
  }

  // dk back to the unrotated basis in f32; the warp's K (hi plane) and V
  // rows are read by no other warp and take the outputs.
  if (split) rotate_rows_t<D>(dka, keys, rope_c, lane);
  const float one[2] = {1.f, 1.f};
  store_warp_rows<D>(ks + warp * 16 * M::kRowBytes, dka, one, dk, key_lo, S, lane);
  store_warp_rows<D>(vs + warp * 16 * M::kRowBytes, dva, one, dv, key_lo, S, lane);
}

}  // namespace
