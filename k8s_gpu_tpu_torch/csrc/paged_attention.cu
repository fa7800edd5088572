// Paged decode/window attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces: k8s_gpu_tpu/ops/paged_attention.py:_decode_kernel, the Pallas
// TPU kernel that paged_attention launches (same file, pl.pallas_call).
// Same function: query rows q [B, Sq, H, Dh] attend, through per-row page
// tables pages [B, MP], to the physical pool [NB, KH, page, Dh]; row b's
// query j sees logical positions kv_start[b] <= t <= start[b] + j inside
// the first t_hi slots.  Scores and softmax are f32, masked scores are
// -1e30 (never -inf, so a fully masked pad row stays finite, as in the
// reference), an int8 pool is dequantized right after its load with the
// f32 scales [NB, KH, page], the G = H / KH query heads sharing a KV head
// fold into the row axis (r = sq * G + g), and the output is in q's type.
//
// What bounds it on the H100: bytes.  Each (row, KV head) pair streams
// t_hi positions of K and V and does 4 * Dh flops per query row per
// position, far below the ~295 flops per byte at which bf16 compute
// would bind.
//
// What the design does about it (the simple first version):
// - One thread block per (row tile of 16 folded rows, KV head, batch row).
//   The block walks the row's page table in chunks of 32 positions, which
//   stands in for the TPU's sequential grid axis; the online-softmax carry
//   (m, l) lives in registers of the warp that owns the row, and the
//   accumulator in registers of the thread that owns its column.
// - Each K/V chunk is read from device memory once per block with
//   16-byte loads, dequantized to f32 into shared memory, and used by all
//   16 rows of the tile: with GQA the G heads of a group share each load,
//   so a page is read once per KV head (per row tile).
// - The block reads its own page ids (there is no scalar prefetch); table
//   entries past a row's allocation point at trash block 0 and are masked
//   by position, so no other tenant's block is ever named.
// - The TPU kernel held all R = Sq * G rows of a KV head in VMEM; here the
//   row axis is tiled across blocks (an admission window of hundreds of
//   rows would not fit 227 KB of shared memory).
// Not yet done (later work): split-K over pages for small batches,
// TMA/cp.async double buffering, tensor-core (wgmma) score products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;      // folded query rows per block
constexpr int kChunk = 32;     // KV positions per step: one per lane
constexpr float kMaskFill = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename QT, typename KVT, int DH>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q,
                       const KVT* __restrict__ k_pool,
                       const KVT* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ pages,
                       const int* __restrict__ start,
                       const int* __restrict__ kv_start,
                       QT* __restrict__ out,
                       int Sq, int H, int KH, int page, int max_pages,
                       int t_hi, float scale) {
  constexpr int kColGroups = kThreads / DH;      // threads per column
  constexpr int kAccRows = kRows / kColGroups;   // rows per thread
  constexpr int kRowsPerWarp = kRows / kWarps;
  constexpr int kVec = 16 / sizeof(KVT);         // elements per 16-byte load
  constexpr int kVecPerRow = DH / kVec;
  static_assert(kThreads % DH == 0, "Dh must divide the block");
  static_assert(DH % kVec == 0, "Dh must fill whole 16-byte loads");

  __shared__ float qs[kRows][DH];
  __shared__ float ks[kChunk][DH + 1];  // +1: lanes read one column each
  __shared__ float vs[kChunk][DH];
  __shared__ float ps[kRows][kChunk];
  __shared__ float alpha_s[kRows];
  __shared__ float l_s[kRows];
  __shared__ int blk_s[kChunk];

  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int G = H / KH;
  const int R = Sq * G;
  const int n_rows = min(kRows, R - r0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q_start = start[b];
  const int kv_lo = kv_start[b];

  // Stage the tile's query rows in f32; rows past R stay zero.
  for (int i = tid; i < kRows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    float x = 0.f;
    if (r < n_rows) {
      const int rr = r0 + r;
      const int h = kh * G + rr % G;
      x = to_f32(q[((static_cast<size_t>(b) * Sq + rr / G) * H + h) * DH + d]);
    }
    qs[r][d] = x;
  }

  // Softmax carry of this warp's rows (warp + kWarps * i), equal in all
  // lanes; accumulator of this thread's column for rows rg + kColGroups * i.
  float m_row[kRowsPerWarp], l_row[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_row[i] = kMaskFill;
    l_row[i] = 0.f;
  }
  const int d_own = tid % DH;
  const int rg = tid / DH;
  float acc[kAccRows];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) acc[i] = 0.f;

  const size_t head_stride = static_cast<size_t>(page) * DH;
  for (int t0 = 0; t0 < t_hi; t0 += kChunk) {
    __syncthreads();  // the previous chunk's ks/vs/ps are consumed
    if (tid < kChunk) {
      const int t = t0 + tid;
      blk_s[tid] = t < t_hi ? pages[static_cast<size_t>(b) * max_pages + t / page] : -1;
    }
    __syncthreads();

    // K/V chunk -> f32 shared memory, dequantized right after the load.
    for (int i = tid; i < kChunk * kVecPerRow; i += kThreads) {
      const int tl = i / kVecPerRow;
      const int d0 = (i % kVecPerRow) * kVec;
      const int blk = blk_s[tl];
      if (blk >= 0) {
        const int off = (t0 + tl) % page;
        const size_t head = static_cast<size_t>(blk) * KH + kh;
        const size_t base = head * head_stride + static_cast<size_t>(off) * DH + d0;
        const uint4 kr = *reinterpret_cast<const uint4*>(k_pool + base);
        const uint4 vr = *reinterpret_cast<const uint4*>(v_pool + base);
        const KVT* ke = reinterpret_cast<const KVT*>(&kr);
        const KVT* ve = reinterpret_cast<const KVT*>(&vr);
        float k_mul = 1.f, v_mul = 1.f;
        if (k_scale != nullptr) {
          const size_t si = head * page + off;
          k_mul = k_scale[si];
          v_mul = v_scale[si];
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          ks[tl][d0 + e] = to_f32(ke[e]) * k_mul;
          vs[tl][d0 + e] = to_f32(ve[e]) * v_mul;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          ks[tl][d0 + e] = 0.f;
          vs[tl][d0 + e] = 0.f;
        }
      }
    }
    __syncthreads();

    // Scores: lane = position, warp = row group; then the online softmax.
    const int t = t0 + lane;
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    if (warp < n_rows) {
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float kd = ks[lane][d];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) s[i] += qs[warp + kWarps * i][d] * kd;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r >= n_rows) continue;  // uniform across the warp
      const int q_pos = q_start + (r0 + r) / G;
      float x = (t <= q_pos && t >= kv_lo) ? s[i] * scale : kMaskFill;
      if (t >= t_hi) x = -INFINITY;  // past the bound: no position at all
      const float m_new = fmaxf(m_row[i], warp_max(x));
      const float alpha = expf(m_row[i] - m_new);
      const float p = expf(x - m_new);
      l_row[i] = l_row[i] * alpha + warp_sum(p);
      m_row[i] = m_new;
      ps[r][lane] = p;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + P V for this thread's column.
#pragma unroll
    for (int i = 0; i < kAccRows; ++i) {
      const int r = rg + kColGroups * i;
      if (r >= n_rows) continue;
      float a = acc[i] * alpha_s[r];
#pragma unroll 8
      for (int tl = 0; tl < kChunk; ++tl) a += ps[r][tl] * vs[tl][d_own];
      acc[i] = a;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      if (r < n_rows) l_s[r] = l_row[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) {
    const int r = rg + kColGroups * i;
    if (r >= n_rows) continue;
    const int rr = r0 + r;
    const int h = kh * G + rr % G;
    out[((static_cast<size_t>(b) * Sq + rr / G) * H + h) * DH + d_own] =
        from_f32<QT>(acc[i] / l_s[r]);
  }
}

template <typename QT, typename KVT, int DH>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* pages,
           const void* start, const void* kv_start, void* out, int B, int Sq,
           int H, int KH, int page, int max_pages, int t_hi, float scale,
           cudaStream_t stream) {
  const int R = Sq * (H / KH);
  const dim3 grid((R + kRows - 1) / kRows, KH, B);
  paged_attention_kernel<QT, KVT, DH><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k_pool),
      static_cast<const KVT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(pages),
      static_cast<const int*>(start), static_cast<const int*>(kv_start),
      static_cast<QT*>(out), Sq, H, KH, page, max_pages, t_hi, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KVT>
int launch_dh(int Dh, const void* q, const void* k_pool, const void* v_pool,
              const void* k_scale, const void* v_scale, const void* pages,
              const void* start, const void* kv_start, void* out, int B,
              int Sq, int H, int KH, int page, int max_pages, int t_hi,
              float scale, cudaStream_t stream) {
  if (Dh == 64)
    return launch<QT, KVT, 64>(q, k_pool, v_pool, k_scale, v_scale, pages,
                               start, kv_start, out, B, Sq, H, KH, page,
                               max_pages, t_hi, scale, stream);
  if (Dh == 128)
    return launch<QT, KVT, 128>(q, k_pool, v_pool, k_scale, v_scale, pages,
                                start, kv_start, out, B, Sq, H, KH, page,
                                max_pages, t_hi, scale, stream);
  return -1;
}

}  // namespace

// Returns 0, a cudaError_t from the launch, or -1 for a type/width this
// file has no instance of.  Dtype codes: 0 float32, 1 bfloat16, 2 int8.
extern "C" int paged_attention_forward(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* pages, const void* start,
    const void* kv_start, void* out, int B, int Sq, int H, int KH, int Dh,
    int page, int max_pages, int t_hi, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch_dh<float, float>(Dh, q, k_pool, v_pool, k_scale, v_scale, pages,
                                   start, kv_start, out, B, Sq, H, KH, page,
                                   max_pages, t_hi, scale, st);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch_dh<__nv_bfloat16, __nv_bfloat16>(
        Dh, q, k_pool, v_pool, k_scale, v_scale, pages, start, kv_start, out, B,
        Sq, H, KH, page, max_pages, t_hi, scale, st);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return launch_dh<float, int8_t>(Dh, q, k_pool, v_pool, k_scale, v_scale,
                                    pages, start, kv_start, out, B, Sq, H, KH,
                                    page, max_pages, t_hi, scale, st);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch_dh<__nv_bfloat16, int8_t>(
        Dh, q, k_pool, v_pool, k_scale, v_scale, pages, start, kv_start, out, B,
        Sq, H, KH, page, max_pages, t_hi, scale, st);
  return -1;
}

extern "C" const char* paged_attention_error_string(int code) {
  if (code < 0) return "no kernel instance for this dtype/head width";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
