// Flash attention v1 for Hopper (sm_90a): forward, dq and dk/dv, bound
// with ctypes.
//
// Replaces the three Pallas TPU kernels of the reference's v1 path in
// k8s_gpu_tpu/ops/attention.py: _fwd_kernel (launched by _flash_forward),
// _bwd_dq_kernel and _bwd_dkv_kernel (launched by _flash_backward).  Same
// functions: q, k, v [BH, S, D] (row-major, one (batch, head) pair per BH
// index), scores s = q.k * D^-0.5 in f32, causal or not, masked scores
// -1e30 (never -inf, as in the reference), the forward emits out in the
// input type and lse = m + log(l) in f32 [BH, S]; the backward recomputes
// p = exp(s - lse) per tile, ds = p (dp - delta) scale with delta =
// rowsum(dO * O) - g_lse given by the caller, and accumulates dq, dk, dv in
// f32 before one rounding to the input type.
//
// What bounds it on the H100: operations.  At the flagship training shape
// (BH 192, S 2048, D 128, causal, bf16) the forward does 4 D flops per
// visible (query, key) pair (2.06e11), dq 6 D (3.09e11) and dk/dv 8 D
// (4.13e11), against 404-607 MB of bytes: 0.21-0.42 ms at the 989 TFLOP/s
// bf16 tensor-core peak, twice the memory bound.
//
// What this first version does about it (right and simple first; the
// tensor cores, TMA and warp specialisation are later work):
// - One block of 256 threads per (query tile of 64 rows, bh) for the
//   forward and dq, per (key tile of 64 rows, bh) for dk/dv.  The TPU's
//   sequential grid axis becomes a loop inside the block; blocks run in no
//   order, so nothing is carried between them and no atomics are used: dq
//   and dk/dv come from separate kernels and are deterministic.
// - Tiles are staged once per block step in f32 shared memory (padded rows
//   of D + 4, so 16-byte loads of neighbouring rows fall on distinct banks)
//   and every operand is read from there, never per score from device
//   memory.  Each thread owns a 4x4 register tile of scores (rows 4 tr + i,
//   columns tc + 16 j) and 4 rows x D/16 columns of the output, so a pair of
//   16-byte shared loads feeds 16 FMAs on the CUDA cores in f32.
// - The online-softmax carry (m, l) of a row lives in registers of the 16
//   lanes that own it (reductions by warp shuffles inside a half-warp), the
//   accumulators in registers of the thread that owns their columns.
// - Causal tiles wholly above the diagonal are skipped (reference :124-128),
//   dk/dv streams query tiles from the diagonal on (reference :226), and the
//   forward and dq walk query tiles from the longest down, so the longest
//   blocks start first.  A ragged last tile is masked, so any S runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // query rows = key rows of a tile
constexpr int kThreads = 256;        // 16 x 16 threads
constexpr int kTC = 16;              // thread columns of a score tile
constexpr int kPStride = kTile + 4;  // padded row of a score tile in smem
constexpr float kMaskFill = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

template <int D>
struct Geom {
  static constexpr int kStride = D + 4;         // padded f32 row
  static constexpr int kTileFloats = kTile * kStride;
  static constexpr int kCols = D / kTC;         // output columns a thread owns
  static constexpr int kVec = kCols < 4 ? kCols : 4;
  static constexpr int kGroups = kCols / kVec;
  // Output column of a thread's c-th accumulator: groups of kVec
  // neighbouring columns, the 16 thread columns side by side.
  static __device__ __forceinline__ int col(int tc, int c) {
    return (c / kVec) * (kTC * kVec) + tc * kVec + (c % kVec);
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Reductions over the 16 lanes of a half-warp (the lanes owning one row).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + 64) of one bh's [S, D] slab -> f32 smem [64][D + 4],
// 16-byte loads, rows past S zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int S, int tid) {
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kPerRow = D / kElems;
  static_assert(D % kElems == 0, "D must fill whole 16-byte loads");
  for (int i = tid; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kElems;
    float4* o = reinterpret_cast<float4*>(dst + r * Geom<D>::kStride + c);
    if (row0 + r < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < kElems; u += 4)
        o[u / 4] = make_float4(to_f32(e[u]), to_f32(e[u + 1]),
                               to_f32(e[u + 2]), to_f32(e[u + 3]));
    } else {
#pragma unroll
      for (int u = 0; u < kElems; u += 4) o[u / 4] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// Per-row values (lse, delta) of rows [row0, row0 + 64) -> smem, 0 past S.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int row0, int S, int tid) {
  if (tid < kTile) dst[tid] = row0 + tid < S ? src[row0 + tid] : 0.f;
}

// c[i][j] = sum_d A[4 tr + i][d] * B[tc + 16 j][d]: a 64x64 tile of A B^T,
// contracted over D, both operands [64][D + 4] in smem.
template <int D>
__device__ __forceinline__ void mm_abt(const float* A, const float* B, int tr,
                                       int tc, float (&c)[4][4]) {
  constexpr int S = Geom<D>::kStride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (tr * 4 + i) * S + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tc + kTC * j) * S + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = c[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        c[i][j] = x;
      }
  }
}

// acc[i][c] += sum_t A(4 tr + i, t) * B[t][col(tc, c)], contracted over the
// 64 rows of a tile.  A is a score tile [64][68] in smem, read as is
// (A(i, t) = P[i][t]) or transposed (A(i, t) = P[t][i]); B is [64][D + 4].
template <int D, bool kTrans>
__device__ __forceinline__ void mm_nn(const float* P, const float* B, int tr,
                                      int tc, float (&acc)[4][Geom<D>::kCols]) {
  using G = Geom<D>;
#pragma unroll 2
  for (int t = 0; t < kTile; t += 4) {
    float a[4][4];  // a[i][u] = A(4 tr + i, t + u)
    if (kTrans) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 x = *reinterpret_cast<const float4*>(P + (t + u) * kPStride + tr * 4);
        a[0][u] = x.x; a[1][u] = x.y; a[2][u] = x.z; a[3][u] = x.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(P + (tr * 4 + i) * kPStride + t);
        a[i][0] = x.x; a[i][1] = x.y; a[i][2] = x.z; a[i][3] = x.w;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* brow = B + (t + u) * G::kStride;
#pragma unroll
      for (int g = 0; g < G::kGroups; ++g) {
        float b[G::kVec];
        const float* src = brow + g * (kTC * G::kVec) + tc * G::kVec;
        if constexpr (G::kVec == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          b[0] = x.x; b[1] = x.y; b[2] = x.z; b[3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < G::kVec; ++e) b[e] = src[e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < G::kVec; ++e)
            acc[i][g * G::kVec + e] = fmaf(a[i][u], b[e], acc[i][g * G::kVec + e]);
      }
    }
  }
}

// Rows 4 tr + i of a [64][D] accumulator tile -> rows row0 + ... of dst.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, const float (&acc)[4][Geom<D>::kCols],
                                           const float (&mul)[4], int row0, int S,
                                           int tr, int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + tr * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < Geom<D>::kCols; ++c)
      dst[static_cast<size_t>(row) * D + Geom<D>::col(tc, c)] = from_f32<T>(acc[i][c] * mul[i]);
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int S, bool causal) {
  return qi < S && kj < S && (!causal || kj <= qi);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int causal, float scale) {
  using G = Geom<D>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + G::kTileFloats;
  float* vs = ks + G::kTileFloats;
  float* ps = vs + G::kTileFloats;  // [64][68] probabilities

  const int n_tiles = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x;
  const int qt = n_tiles - 1 - blockIdx.y;  // longest causal tiles first
  const int q0 = qt * kTile;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x;
  const int tr = tid / kTC, tc = tid % kTC;

  load_tile<T, D>(qs, q + base, q0, S, tid);

  float m[4], l[4], acc[4][G::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskFill;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) acc[i][c] = 0.f;
  }

  const int kt_end = causal ? qt + 1 : n_tiles;  // tile qt holds the diagonal
  for (int kt = 0; kt < kt_end; ++kt) {
    __syncthreads();  // the previous tile's ks/vs/ps are consumed
    load_tile<T, D>(ks, k + base, kt * kTile, S, tid);
    load_tile<T, D>(vs, v + base, kt * kTile, S, tid);
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
        s[i][j] = visible(qi, kj, S, causal) ? s[i][j] * scale : kMaskFill;
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
      for (int c = 0; c < G::kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    mm_nn<D, false>(ps, vs, tr, tc, acc);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) inv[i] = 1.f / l[i];
  store_tile<T, D>(out + base, acc, inv, q0, S, tr, tc);
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr * 4 + i;
      if (row < S) lse[static_cast<size_t>(bh) * S + row] = m[i] + logf(l[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int S, int causal, float scale) {
  using G = Geom<D>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + G::kTileFloats;
  float* ks = dos + G::kTileFloats;
  float* vs = ks + G::kTileFloats;
  float* dss = vs + G::kTileFloats;  // [64][68] ds
  float* rows = dss + kTile * kPStride;  // lse [64], delta [64]

  const int n_tiles = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x;
  const int qt = n_tiles - 1 - blockIdx.y;
  const int q0 = qt * kTile;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x;
  const int tr = tid / kTC, tc = tid % kTC;

  load_tile<T, D>(qs, q + base, q0, S, tid);
  load_tile<T, D>(dos, dout + base, q0, S, tid);
  load_rows(rows, lse + static_cast<size_t>(bh) * S, q0, S, tid);
  load_rows(rows + kTile, delta + static_cast<size_t>(bh) * S, q0, S, tid);
  __syncthreads();
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = rows[tr * 4 + i];
    delta_r[i] = rows[kTile + tr * 4 + i];
  }

  float acc[4][G::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) acc[i][c] = 0.f;

  const int kt_end = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < kt_end; ++kt) {
    __syncthreads();
    load_tile<T, D>(ks, k + base, kt * kTile, S, tid);
    load_tile<T, D>(vs, v + base, kt * kTile, S, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    mm_abt<D>(qs, ks, tr, tc, s);
    mm_abt<D>(dos, vs, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt * kTile + tc + kTC * j;
        const float p = visible(qi, kj, S, causal) ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[(tr * 4 + i) * kPStride + tc + kTC * j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    mm_nn<D, false>(dss, ks, tr, tc, acc);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_tile<T, D>(dq + base, acc, one, q0, S, tr, tc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int S, int causal,
                     float scale) {
  using G = Geom<D>;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + G::kTileFloats;
  float* qs = vs + G::kTileFloats;
  float* dos = qs + G::kTileFloats;
  float* ps = dos + G::kTileFloats;   // [64][68] p, rows = queries
  float* dss = ps + kTile * kPStride;  // [64][68] ds
  float* rows = dss + kTile * kPStride;  // lse [64], delta [64]

  const int n_tiles = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;
  const int k0 = kt * kTile;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x;
  const int tr = tid / kTC, tc = tid % kTC;

  load_tile<T, D>(ks, k + base, k0, S, tid);
  load_tile<T, D>(vs, v + base, k0, S, tid);

  float dk_acc[4][G::kCols], dv_acc[4][G::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < G::kCols; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  // Query tiles above this key tile's diagonal see none of its keys.
  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's qs/dos/ps/dss/rows are consumed
    load_tile<T, D>(qs, q + base, q0, S, tid);
    load_tile<T, D>(dos, dout + base, q0, S, tid);
    load_rows(rows, lse + static_cast<size_t>(bh) * S, q0, S, tid);
    load_rows(rows + kTile, delta + static_cast<size_t>(bh) * S, q0, S, tid);
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

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_tile<T, D>(dk + base, dk_acc, one, k0, S, tr, tc);
  store_tile<T, D>(dv + base, dv_acc, one, k0, S, tr, tc);
}

// Dynamic shared memory of each kernel, in bytes.
template <int D>
constexpr int fwd_smem() { return (3 * Geom<D>::kTileFloats + kTile * kPStride) * 4; }
template <int D>
constexpr int dq_smem() { return (4 * Geom<D>::kTileFloats + kTile * kPStride + 2 * kTile) * 4; }
template <int D>
constexpr int dkv_smem() { return (4 * Geom<D>::kTileFloats + 2 * kTile * kPStride + 2 * kTile) * 4; }

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

dim3 grid(int BH, int S) { return dim3(BH, (S + kTile - 1) / kTile); }

template <typename T, int D>
struct Fwd {
  static int run(const void* q, const void* k, const void* v, void* out,
                 void* lse, int BH, int S, int causal, float scale,
                 cudaStream_t st) {
    constexpr int smem = fwd_smem<D>();
    if (int rc = prepare(flash_fwd_kernel<T, D>, smem)) return rc;
    flash_fwd_kernel<T, D><<<grid(BH, S), kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out),
        static_cast<float*>(lse), S, causal, scale);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int D>
struct BwdDq {
  static int run(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, int BH, int S,
                 int causal, float scale, cudaStream_t st) {
    constexpr int smem = dq_smem<D>();
    if (int rc = prepare(flash_bwd_dq_kernel<T, D>, smem)) return rc;
    flash_bwd_dq_kernel<T, D><<<grid(BH, S), kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), S, causal, scale);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int D>
struct BwdDkv {
  static int run(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dk, void* dv, int BH,
                 int S, int causal, float scale, cudaStream_t st) {
    constexpr int smem = dkv_smem<D>();
    if (int rc = prepare(flash_bwd_dkv_kernel<T, D>, smem)) return rc;
    flash_bwd_dkv_kernel<T, D><<<grid(BH, S), kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), S, causal, scale);
    return static_cast<int>(cudaGetLastError());
  }
};

// One instance per (input type, head width); -1 for a pair without one.
template <template <typename, int> class Launch, typename... Args>
int dispatch(int dtype, int D, Args... args) {
  if (dtype == kF32) {
    switch (D) {
      case 16: return Launch<float, 16>::run(args...);
      case 32: return Launch<float, 32>::run(args...);
      case 64: return Launch<float, 64>::run(args...);
      case 128: return Launch<float, 128>::run(args...);
    }
  } else if (dtype == kBF16) {
    switch (D) {
      case 16: return Launch<__nv_bfloat16, 16>::run(args...);
      case 32: return Launch<__nv_bfloat16, 32>::run(args...);
      case 64: return Launch<__nv_bfloat16, 64>::run(args...);
      case 128: return Launch<__nv_bfloat16, 128>::run(args...);
    }
  }
  return -1;
}

}  // namespace

// Each returns 0, a cudaError_t from preparing or launching, or -1 for a
// type/head width without an instance.  Type codes: 0 float32, 1 bfloat16.
// q, k, v, dout, out, dq, dk, dv: [BH, S, D] contiguous; lse, delta:
// [BH, S] float32.  Nothing is synchronised or allocated here.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int BH, int S, int D,
                                   int causal, float scale, int dtype,
                                   void* stream) {
  return dispatch<Fwd>(dtype, D, q, k, v, out, lse, BH, S, causal, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int BH, int S, int D,
                                      int causal, float scale, int dtype,
                                      void* stream) {
  return dispatch<BwdDq>(dtype, D, q, k, v, dout, lse, delta, dq, BH, S,
                         causal, scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int BH, int S,
                                       int D, int causal, float scale,
                                       int dtype, void* stream) {
  return dispatch<BwdDkv>(dtype, D, q, k, v, dout, lse, delta, dk, dv, BH, S,
                          causal, scale, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code < 0) return "no kernel instance for this dtype/head width";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
