// The bf16 flash-attention forward on Hopper's tensor cores, shared by the
// v1 forward (flash_attention.cu, flash_fwd_mma_kernel) and the v2 forward
// (flash_attention_v2.cu, flash_v2_fwd_mma_kernel).  The float32 instances
// of both forwards stay on the CUDA cores (flash_common.cuh).  Its
// primitives (padded tiles, cp.async staging, ldmatrix offsets, mma.sync,
// the 16-byte epilogue) also serve the v1 bf16 backward (flash_mma_bwd.cuh).
//
// The function is the one of the kernels it replaces (_fwd_kernel and
// _fwd_kernel_v2 of k8s_gpu_tpu/ops/attention.py): out in bf16 and lse =
// m + log(l) in f32 from q, k, v, causal or not, masked scores -1e30, any S
// (a ragged last tile masked); for v2 with q and k rotated in f32 at their
// sequence positions and K/V read at their own heads.  One rounding is
// new: p is rounded to bf16 before the P.V product (as in SDPA and
// FlashAttention), which moves an output by at most 2^-8 sum_j p_j |v_j| / l.
//
// What bounds it on the H100: operations (4 D flops per visible (query,
// key) pair, 0.21 ms at the flagship training shape against 989 TFLOP/s
// bf16), and before that the shared-memory reads of K and V, which each of
// the 4 warps of a query tile reads whole.
//
// The design:
// - A group of 4 warps (128 threads) owns one 64-row query tile, 16 rows a
//   warp; a block holds P groups that read each staged K/V tile together.
// - S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products with f32
//   accumulators in registers: S 16x64 (32 floats a thread), O 16xD (64 at
//   D 128).  Q's fragments are loaded once; K's and V's come through
//   ldmatrix (V with .trans, so V stays row-major as it arrives).
// - The online softmax works on the accumulator fragments: a thread owns
//   rows lane/4 and lane/4 + 8 of its warp's 16, row maxima reduce over a
//   quad of lanes, and the per-thread partial row sums reduce once at the
//   end.  p is packed to bf16 pairs in registers: the S accumulator layout
//   is the A-operand layout of the P V product, so P never goes through
//   shared memory.  Exponentials are exp2 of scores pre-scaled by log2(e).
// - K and V come through a two-stage cp.async ring (16-byte copies): tile
//   j + 1 is in flight while tile j is multiplied, with one barrier a tile.
//   Rows are padded by 16 bytes, so the 8 row addresses of an ldmatrix
//   fall on distinct banks at every head width.
// - v2 with rope (kSplit, lo planes given): the rotated q and k are not
//   bf16 values, and v2's backward and plain versions keep them in f32, so
//   the forward keeps them exact enough as two bf16 halves, x = hi + lo
//   with hi = bf16(x) and lo = bf16(x - hi) (to 2^-16 of x), and takes
//   S = Qhi Khi^T + Qhi Klo^T + Qlo Khi^T: three products.  The halves are
//   made once per call by flash_v2_rope_split_kernel (flash_attention_v2.cu)
//   and staged by cp.async like any tile: rotating each K tile in every
//   block that stages it cost 0.92 ms of 2.37 at the training shape (H100).
//   Qhi's fragments stay in registers, Qlo's are read per tile.
// - Only tiles that touch the diagonal, the ragged key tail or dead rows
//   test each score; a warp whose rows see none of a tile's keys skips its
//   products.  The output leaves through the group's Q buffer in 16-byte
//   stores.

#pragma once

#include "flash_common.cuh"

namespace {

constexpr int kMmaWarps = 4;                 // warps of one 64-row query tile
constexpr int kMmaThreads = 32 * kMmaWarps;  // threads of one group
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// A bf16 tile [64][D] in shared memory with rows padded by 16 bytes.
template <int D>
struct MmaTile {
  static constexpr int kRowBytes = D * 2 + 16;
  static constexpr int kBytes = kTile * kRowBytes;
  static constexpr int kChunks = D / 8;        // 16-byte chunks of a row
  static constexpr int kHalfChunks = kChunks / 2;
};

// Shared memory of a forward block with P groups: two K and two V stages
// and P query tiles, K and Q in hi and lo planes with kSplit.
template <int D, int P, bool kSplit>
constexpr int mma_fwd_smem() {
  return (2 * (1 + kSplit) + 2 + P * (1 + kSplit)) * MmaTile<D>::kBytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !full.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one special-function instruction; results below 2^-126 (p of a
// masked or far-below-max score) flush to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A operand of 16 columns (n-tiles n, n + 1) of a 16-row accumulator
// tile, rounded to bf16: the accumulator layout is the A-operand layout.
__device__ __forceinline__ void pack_a(const float (&c0)[4], const float (&c1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A lane's ldmatrix offset in a 16-row block of a padded tile: for an A
// operand (16 rows x 16 columns) or a B operand read transposed (16
// k-rows x 16 n-columns: b[0], b[1] the first 8 columns, b[2], b[3] the
// next); and for a B operand read as it is (16 n-rows x 16 k-columns:
// b[0], b[1] the first 8 rows, b[2], b[3] the next).
template <int D>
__device__ __forceinline__ uint32_t a_lane_off(int lane) {
  return (lane % 8 + (lane / 8) % 2 * 8) * MmaTile<D>::kRowBytes + lane / 16 * 16;
}
template <int D>
__device__ __forceinline__ uint32_t b_lane_off(int lane) {
  return (lane % 8 + lane / 16 * 8) * MmaTile<D>::kRowBytes + (lane / 8) % 2 * 16;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Element u of eight bf16 values packed in a uint4, widened to f32.
__device__ __forceinline__ float bf16_at(const uint4& v, int u) {
  const uint32_t w = u < 2 ? v.x : u < 4 ? v.y : u < 6 ? v.z : v.w;
  return __uint_as_float(u % 2 ? w & 0xffff0000u : w << 16);
}

// x = hi + lo for eight values: hi = bf16(x), lo = bf16(x - hi), packed.
__device__ __forceinline__ void split8(const float (&x)[8], uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    h[u] = pack_bf16(x[2 * u], x[2 * u + 1]);
    l[u] = pack_bf16(x[2 * u] - __uint_as_float(h[u] << 16),
                     x[2 * u + 1] - __uint_as_float(h[u] & 0xffff0000u));
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// A warp's 16xD f32 accumulator tile, row h of each thread's pair times
// mul[h] -> bf16 rows [row_lo, row_lo + 16) of out that are below lim,
// through the warp's own 16 rows of a padded tile (rows no other warp
// reads), in 16-byte stores.
template <int D>
__device__ __forceinline__ void store_warp_rows(char* rows, const float (&acc)[D / 8][4],
                                                const float (&mul)[2],
                                                bf16* __restrict__ out, int row_lo,
                                                int lim, int lane) {
  using M = MmaTile<D>;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    char* p = rows + (lane / 4) * M::kRowBytes + (n * 8 + lane % 4 * 2) * 2;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[n][0] * mul[0], acc[n][1] * mul[0]);
    *reinterpret_cast<uint32_t*>(p + 8 * M::kRowBytes) =
        pack_bf16(acc[n][2] * mul[1], acc[n][3] * mul[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * M::kChunks; i += 32) {
    const int r = i / M::kChunks, c = i % M::kChunks;
    if (row_lo + r < lim)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(row_lo + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(rows + r * M::kRowBytes + c * 16);
  }
}

// Rows [row0, row0 + 64) of an [S, D] slab -> a padded tile by cp.async over
// kN threads (tid in [0, kN)); rows at or past lim are zero-filled.
template <int D, int kN>
__device__ __forceinline__ void stage_async(char* dst, const bf16* __restrict__ src,
                                            int row0, int lim, int tid) {
  using M = MmaTile<D>;
  const uint32_t base = smem_u32(dst);
  for (int i = tid; i < kTile * M::kChunks; i += kN) {
    const int r = i / M::kChunks, c = i % M::kChunks;
    const bool live = row0 + r < lim;
    const bf16* g = src + static_cast<size_t>(live ? row0 + r : 0) * D + c * 8;
    cp_async16(base + r * M::kRowBytes + c * 16, g, live);
  }
}

// One group's forward over its query tile: q (and q_lo), out [.., D] and
// lse are the group's member slab (row 0 = sequence position 0), k (and
// k_lo), v its KV head's [S, D].  Rows q0 + r < q_lim are live; key tiles
// [0, kt_end) are walked.  Every group of the block passes the same
// barriers, so kt_end is the block's.  With kSplit and lo planes given
// (not null), q and k are the hi halves.  Launched with P * kMmaThreads
// threads and mma_fwd_smem<D, P, kSplit>() bytes of dynamic shared memory.
template <int D, int P, bool kSplit>
__device__ __forceinline__ void mma_fwd_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ q_lo,
    const bf16* __restrict__ k, const bf16* __restrict__ k_lo,
    const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
    int q0, int q_lim, int kt_end, int S, int causal, float scale) {
  using M = MmaTile<D>;
  constexpr int kN = P * kMmaThreads;
  constexpr int kPlanes = kSplit ? 2 : 1;  // hi (and lo) planes of q and k
  extern __shared__ float4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);
  const int tid = threadIdx.x;
  const int grp = tid / kMmaThreads, gtid = tid % kMmaThreads;
  const int warp = gtid / 32, lane = tid % 32;
  // K stage s plane p at ks + (s * kPlanes + p) tiles; V stage s at vs + s.
  char* const ks = smem;
  char* const vs = smem + 2 * kPlanes * M::kBytes;
  char* const qs = vs + (2 + grp * kPlanes) * M::kBytes;  // lo plane next
  const bool split = kSplit && k_lo != nullptr;

  // Tile 0 of K and V, and the group's Q tile.
  stage_async<D, kMmaThreads>(qs, q, q0, q_lim, gtid);
  stage_async<D, kN>(ks, k, 0, S, tid);
  if (split) {
    stage_async<D, kMmaThreads>(qs + M::kBytes, q_lo, q0, q_lim, gtid);
    stage_async<D, kN>(ks + M::kBytes, k_lo, 0, S, tid);
  }
  stage_async<D, kN>(vs, v, 0, S, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // Per-lane ldmatrix offsets: a Q tile (A fragments, 16 rows x 16
  // columns a load), a K tile (S = Q K^T: 16 keys x 16 columns) and a V
  // tile (P V: 16 keys x 16 columns, transposed).
  const uint32_t q_addr = smem_u32(qs) + warp * 16 * M::kRowBytes + a_lane_off<D>(lane);
  const uint32_t k_off = b_lane_off<D>(lane);
  const uint32_t v_off = a_lane_off<D>(lane);
  uint32_t qf[D / 16][4];  // the warp's 16 Q rows (hi plane), per 16 columns
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(q_addr + kk * 32, qf[kk]);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kMaskFill, kMaskFill}, l_r[2] = {0.f, 0.f};
  const float scale2 = scale * kLog2e;
  const int row_lo = q0 + warp * 16;           // the warp's first row
  const int rows[2] = {row_lo + lane / 4, row_lo + lane / 4 + 8};

  for (int kt = 0; kt < kt_end; ++kt) {
    const int cur = kt & 1;
    char* const kcur = ks + cur * kPlanes * M::kBytes;
    char* const knext = ks + (cur ^ 1) * kPlanes * M::kBytes;
    if (kt > 0) {
      cp_async_wait_all();
      __syncthreads();  // tile kt has landed; tile kt - 1's stage is free
    }
    const bool more = kt + 1 < kt_end;
    if (more) {
      const int next0 = (kt + 1) * kTile;
      stage_async<D, kN>(knext, k, next0, S, tid);
      if (split) stage_async<D, kN>(knext + M::kBytes, k_lo, next0, S, tid);
      stage_async<D, kN>(vs + (cur ^ 1) * M::kBytes, v, next0, S, tid);
      cp_async_commit();
    }
    const int k0 = kt * kTile;
    if (row_lo < q_lim && !(causal && k0 > row_lo + 15)) {
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const uint32_t kb = smem_u32(kcur) + k_off;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ql[4];
        if (split) ldsm_x4(q_addr + M::kBytes + kk * 32, ql);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4(kb + np * 16 * M::kRowBytes + kk * 32, b);
          mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
          if (split) {
            mma_bf16(s[2 * np], ql, b[0], b[1]);
            mma_bf16(s[2 * np + 1], ql, b[2], b[3]);
            ldsm_x4(kb + M::kBytes + np * 16 * M::kRowBytes + kk * 32, b);
            mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
            mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
          }
        }
      }

      const bool edge = (causal && k0 + kTile - 1 > row_lo) || k0 + kTile > S ||
                        row_lo + 16 > q_lim;
      float mx[2] = {kMaskFill, kMaskFill};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale2;
          if (edge) {
            const int key = k0 + n * 8 + lane % 4 * 2 + (e & 1);
            const int row = rows[e / 2];
            if (!(row < q_lim && key < S && (!causal || key <= row))) x = kMaskFill;
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
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + rs[h];
      // Once the row maxima settle, alpha is 1 for every row of the warp.
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
          o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
        }
      }

      const uint32_t vb = smem_u32(vs + cur * M::kBytes) + v_off;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        pack_a(s[2 * kk], s[2 * kk + 1], a);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_t(vb + kk * 16 * M::kRowBytes + dp * 32, b);
          mma_bf16(o[2 * dp], a, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // The epilogue: O / l through the warp's own rows of the Q tile's hi
  // plane (read only into qf above), then 16-byte stores of the live rows.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] = quad_sum(l_r[h]);
    inv[h] = 1.f / l_r[h];
  }
  store_warp_rows<D>(qs + warp * 16 * M::kRowBytes, o, inv, out, row_lo, q_lim, lane);
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (rows[h] < q_lim) lse[rows[h]] = (m_r[h] + log2f(l_r[h])) * kLn2;
  }
}

}  // namespace
