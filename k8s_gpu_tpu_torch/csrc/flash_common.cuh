// Device code shared by the flash-attention kernels (flash_attention.cu,
// flash_attention_v2.cu): the tile geometry, type conversions, half-warp
// reductions, tile staging in padded f32 shared memory, the two 64-row
// tile products on the CUDA cores, the rotary helpers and the per-(type,
// head width) dispatch.  The CUDA-core products serve every backward kernel
// and the float32 forwards; the bf16 forwards run on the tensor cores
// (flash_mma.cuh).
//
// A block's threads are counted in groups of kThreads = 256, 16 x 16: a
// thread (tr, tc) of a group owns rows 4 tr + i and columns tc + 16 j of a
// 64x64 score tile, and 4 rows x D/16 columns of a [64, D] accumulator.

#pragma once

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
// 16-byte loads spread over kN threads (tid in [0, kN)), rows past S zero.
template <typename T, int D, int kN = kThreads>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int S, int tid) {
  constexpr int kElems = 16 / sizeof(T);
  constexpr int kPerRow = D / kElems;
  static_assert(D % kElems == 0, "D must fill whole 16-byte loads");
  for (int i = tid; i < kTile * kPerRow; i += kN) {
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

// freqs[i] = exp(i * c) for the D / 2 rotary frequencies.
template <int D, int kN>
__device__ __forceinline__ void rope_freqs(float* freqs, float c, int tid) {
  for (int i = tid; i < D / 2; i += kN) freqs[i] = expf(static_cast<float>(i) * c);
}


template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

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
