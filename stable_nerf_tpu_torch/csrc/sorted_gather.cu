// Row gather with bf16 rounding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the reference package:
//   K3 stable_nerf_tpu/ops/pallas/gather.py  sorted_window_gather
// which computes out[M, F] (f32) = f32(bf16(table))[clip(sidx, 0, T-1)]
// for indices sorted ascending.  The TPU kernel streams 4096-entry table
// chunks per 1024-item window and extracts rows with one-hot products on
// the matrix unit only because Mosaic has no per-lane dynamic loads.  The
// card has them: one thread per item reads its index, clamps it, loads the
// row, rounds each value to bf16 (round to nearest even) and stores it
// widened to f32.
//
// Bound: bytes.  Each index (4 B) is read once, each output row (4·F B)
// written once and each distinct table row read once; there is no
// arithmetic to speak of.  Design: adjacent threads take adjacent items,
// so index loads and output stores coalesce; both are streaming
// (evict-first) so they do not push the table out of L2.  Sorted indices
// make neighbouring threads read the same or neighbouring rows, so table
// reads coalesce and repeat in L1/L2; that is the only use made of the
// order, and the result is the same for unsorted indices (slower, one
// 32-byte sector per row).  For F = 2, the hash grid's width, a row is one
// 8-byte load (f32 table) or one 4-byte load (bf16 table) and one 8-byte
// store.  Offsets into ``out`` are 64-bit: M·F may pass 2^31.
//
// Plain C interface for ctypes: the wrapper (ops/hopper/gather.py)
// allocates the output, passes PyTorch's current stream, and raises on a
// non-zero return (the cudaGetLastError() of the launch).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int32_t clamp_row(int32_t row, int32_t rows) {
  return row < 0 ? 0 : (row >= rows ? rows - 1 : row);
}

// F = 2, f32 table: one float2 load and one float2 store per item
__global__ void gather_f2_f32_kernel(const float2* __restrict__ table,
                                     const int32_t* __restrict__ sidx,
                                     float2* __restrict__ out, int64_t m,
                                     int32_t rows) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    float2 v = __ldg(table + clamp_row(__ldcs(sidx + i), rows));
    v.x = round_bf16(v.x);
    v.y = round_bf16(v.y);
    __stcs(out + i, v);
  }
}

// F = 2, bf16 table: one 4-byte load per item, widened exactly
__global__ void gather_f2_bf16_kernel(const __nv_bfloat162* __restrict__ table,
                                      const int32_t* __restrict__ sidx,
                                      float2* __restrict__ out, int64_t m,
                                      int32_t rows) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    const __nv_bfloat162 v = table[clamp_row(__ldcs(sidx + i), rows)];
    __stcs(out + i, __bfloat1622float2(v));
  }
}

// any F: one thread per output element, so stores stay coalesced
template <typename T>
__device__ __forceinline__ float load_rounded(const T* p);
template <>
__device__ __forceinline__ float load_rounded<float>(const float* p) {
  return round_bf16(__ldg(p));
}
template <>
__device__ __forceinline__ float load_rounded<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void gather_any_kernel(const T* __restrict__ table,
                                  const int32_t* __restrict__ sidx,
                                  float* __restrict__ out, int64_t m,
                                  int32_t rows, int32_t feat) {
  const int64_t n = m * feat;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += stride) {
    const int64_t i = e / feat;
    const int32_t f = static_cast<int32_t>(e - i * feat);
    const int64_t row = clamp_row(__ldg(sidx + i), rows);
    __stcs(out + e, load_rounded<T>(table + row * feat + f));
  }
}

unsigned int blocks_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(want < (1LL << 30) ? want : (1LL << 30));
}

}  // namespace

// table: [rows, feat] f32 (table_bf16 = 0) or bf16 (table_bf16 = 1),
// contiguous; sidx: [m] int32; out: [m, feat] f32.
extern "C" int sorted_window_gather(const void* table, const void* sidx,
                                    void* out, long long m, int rows, int feat,
                                    int table_bf16, void* stream) {
  if (m <= 0) return 0;
  if (rows <= 0 || feat <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* idx = static_cast<const int32_t*>(sidx);
  if (feat == 2) {
    float2* o = static_cast<float2*>(out);
    if (table_bf16) {
      gather_f2_bf16_kernel<<<blocks_for(m), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat162*>(table), idx, o, m, rows);
    } else {
      gather_f2_f32_kernel<<<blocks_for(m), kThreads, 0, s>>>(
          static_cast<const float2*>(table), idx, o, m, rows);
    }
  } else {
    float* o = static_cast<float*>(out);
    const unsigned int blocks = blocks_for(m * feat);
    if (table_bf16) {
      gather_any_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(table), idx, o, m, rows, feat);
    } else {
      gather_any_kernel<float><<<blocks, kThreads, 0, s>>>(
          static_cast<const float*>(table), idx, o, m, rows, feat);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
