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
// The bf16 instances run on the tensor cores: the forward
// (flash_fwd_mma_kernel, device code in flash_mma.cuh: mma.sync bf16
// products, a cp.async K/V ring, the online softmax on the accumulator
// fragments) and the two backward kernels (flash_bwd_dq_mma_kernel and
// flash_bwd_dkv_mma_kernel, device code in flash_mma_bwd.cuh: the same
// primitives, p and ds rounded to bf16 before the products that take
// them).  The float32 instances are the first version on the CUDA cores in
// f32 (TMA, wgmma and warp specialisation are later work):
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
//
// The staging, product and dispatch helpers are in flash_common.cuh,
// shared with the v2 kernels (flash_attention_v2.cu).

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"
#include "flash_mma_bwd.cuh"

namespace {

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

// The bf16 forward: one group of 4 warps per (query tile, bh), longest
// causal tiles first, as flash_fwd_kernel.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int S, int causal, float scale) {
  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  mma_fwd_tile<D, 1, false>(q + base, nullptr, k + base, nullptr, v + base,
                            out + base, lse + static_cast<size_t>(blockIdx.x) * S,
                            qt * kTile, S, causal ? qt + 1 : n_tiles, S, causal,
                            scale);
}

// The bf16 backward: one group of 4 warps per (query tile, bh), longest
// causal tiles first, for dq; per (key tile, bh) for dk/dv.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int S, int causal, float scale) {
  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const size_t rows = static_cast<size_t>(blockIdx.x) * S;
  mma_bwd_dq_tile<D, 1, false>(q + base, nullptr, k + base, nullptr, v + base,
                               dout + base, lse + rows, delta + rows, dq + base,
                               qt * kTile, S, causal ? qt + 1 : n_tiles, S, causal,
                               scale, 0.f);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                         int causal, float scale) {
  const int kt = blockIdx.y;
  const size_t base = static_cast<size_t>(blockIdx.x) * S * D;
  const size_t rows = static_cast<size_t>(blockIdx.x) * S;
  mma_bwd_dkv_tile<D, 1, false>(q + base, nullptr, k + base, nullptr, v + base,
                                dout + base, lse + rows, delta + rows, dk + base,
                                dv + base, kt * kTile, causal ? kt : 0, 1, S, causal,
                                scale, 0.f);
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

dim3 grid(int BH, int S) { return dim3(BH, (S + kTile - 1) / kTile); }

template <typename T, int D>
struct Fwd {
  static int run(const void* q, const void* k, const void* v, void* out,
                 void* lse, int BH, int S, int causal, float scale,
                 cudaStream_t st) {
    if constexpr (std::is_same_v<T, bf16>) {
      constexpr int smem = mma_fwd_smem<D, 1, false>();
      if (int rc = prepare(flash_fwd_mma_kernel<D>, smem)) return rc;
      flash_fwd_mma_kernel<D><<<grid(BH, S), kMmaThreads, smem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(out),
          static_cast<float*>(lse), S, causal, scale);
    } else {
      constexpr int smem = fwd_smem<D>();
      if (int rc = prepare(flash_fwd_kernel<T, D>, smem)) return rc;
      flash_fwd_kernel<T, D><<<grid(BH, S), kThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out),
          static_cast<float*>(lse), S, causal, scale);
    }
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int D>
struct BwdDq {
  static int run(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, int BH, int S,
                 int causal, float scale, cudaStream_t st) {
    if constexpr (std::is_same_v<T, bf16>) {
      constexpr int smem = mma_bwd_dq_smem<D>();
      if (int rc = prepare(flash_bwd_dq_mma_kernel<D>, smem)) return rc;
      flash_bwd_dq_mma_kernel<D><<<grid(BH, S), kMmaThreads, smem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dq), S, causal, scale);
    } else {
      constexpr int smem = dq_smem<D>();
      if (int rc = prepare(flash_bwd_dq_kernel<T, D>, smem)) return rc;
      flash_bwd_dq_kernel<T, D><<<grid(BH, S), kThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dq), S, causal, scale);
    }
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int D>
struct BwdDkv {
  static int run(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dk, void* dv, int BH,
                 int S, int causal, float scale, cudaStream_t st) {
    if constexpr (std::is_same_v<T, bf16>) {
      constexpr int smem = mma_bwd_dkv_smem<D>();
      if (int rc = prepare(flash_bwd_dkv_mma_kernel<D>, smem)) return rc;
      flash_bwd_dkv_mma_kernel<D><<<grid(BH, S), kMmaThreads, smem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, causal, scale);
    } else {
      constexpr int smem = dkv_smem<D>();
      if (int rc = prepare(flash_bwd_dkv_kernel<T, D>, smem)) return rc;
      flash_bwd_dkv_kernel<T, D><<<grid(BH, S), kThreads, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dk), static_cast<T*>(dv), S, causal, scale);
    }
    return static_cast<int>(cudaGetLastError());
  }
};

// The forward's dynamic shared memory, in bytes.
template <typename T, int D>
struct FwdSmem {
  static int run() {
    if constexpr (std::is_same_v<T, bf16>) return mma_fwd_smem<D, 1, false>();
    else return fwd_smem<D>();
  }
};

// The dq (dkv = 0) or dk/dv (dkv = 1) kernel's dynamic shared memory.
template <typename T, int D>
struct BwdSmem {
  static int run(int dkv) {
    if constexpr (std::is_same_v<T, bf16>)
      return dkv ? mma_bwd_dkv_smem<D>() : mma_bwd_dq_smem<D>();
    else return dkv ? dkv_smem<D>() : dq_smem<D>();
  }
};

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

// The forward instance's dynamic shared memory in bytes, or -1.
extern "C" int flash_attention_fwd_smem(int D, int dtype) {
  return dispatch<FwdSmem>(dtype, D);
}

// A backward instance's dynamic shared memory in bytes (dq: dkv = 0,
// dk/dv: dkv = 1), or -1.
extern "C" int flash_attention_bwd_smem(int D, int dtype, int dkv) {
  return dispatch<BwdSmem>(dtype, D, dkv);
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code < 0) return "no kernel instance for this dtype/head width";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
