// Hash-table gradient scatter-add for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the reference package:
//   K1 stable_nerf_tpu/ops/pallas/scatter_v2.py  sorted_block_scatter_add_v2
//   K2 stable_nerf_tpu/ops/pallas/scatter.py     sorted_block_scatter_add
// Both compute out[total, F] (f32) = zeros.at[idx].add(upd), dropping
// indices outside [0, total).  The TPU kernels sort the updates and
// contract one-hot blocks on the matrix unit only because Mosaic has no
// per-element dynamic stores and no atomics; this kernel takes the
// updates unsorted and adds them with f32 atomics.
//
// Bound: each update reads 4 + 4·F bytes and the [total, F] output is
// written once, so at the main-path shape (16.7 M updates, F = 2, a 64 MiB
// table) the byte bound is ~0.08 ms on an H100; what limits the kernel in
// practice is atomic throughput, worst on the hot rows: the coarse dense
// levels (level 0 has 4,096 rows for ~1 M updates) and the box corners
// where samples past a ray's exit are clamped.  Design: one thread per
// update, adjacent threads on adjacent updates (coalesced loads, marked
// evict-first so the streamed inputs do not push the table out of L2,
// where the atomics resolve).  For F = 2, the hash grid's width, each
// update is one 8-byte load and one vector atomic (sm_90's float2
// atomicAdd), half the atomic operations of two scalar adds.
// payload_bf16 rounds each feature to bf16 (round to nearest even) before
// the add, the contract of the reference's pack_bf16_pair /
// unpack_bf16_pair; the sum stays f32.
//
// Plain C interface for ctypes: the wrapper (ops/hopper/scatter.py)
// allocates and zeroes the output, passes PyTorch's current stream, and
// raises on a non-zero return (the cudaGetLastError() of the launch).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kRoundBf16>
__device__ __forceinline__ float payload(float v) {
  return kRoundBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// F = 2: one float2 load and one float2 atomic per update
template <bool kRoundBf16>
__global__ void hash_scatter_add_f2_kernel(const int32_t* __restrict__ idx,
                                           const float2* __restrict__ upd,
                                           float2* __restrict__ out, int64_t n,
                                           int32_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t row = __ldcs(idx + i);
    if (row < 0 || row >= total) continue;
    float2 v = __ldcs(upd + i);
    v.x = payload<kRoundBf16>(v.x);
    v.y = payload<kRoundBf16>(v.y);
    atomicAdd(out + row, v);
  }
}

// any F: one scalar atomic per feature
__global__ void hash_scatter_add_kernel(const int32_t* __restrict__ idx,
                                        const float* __restrict__ upd,
                                        float* __restrict__ out, int64_t n,
                                        int32_t total, int32_t feat) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t row = __ldcs(idx + i);
    if (row < 0 || row >= total) continue;
    const float* u = upd + i * feat;
    float* o = out + static_cast<int64_t>(row) * feat;
    for (int32_t f = 0; f < feat; ++f) atomicAdd(o + f, __ldcs(u + f));
  }
}

}  // namespace

// round_bf16 is taken only with feat == 2 (the wrapper's contract).
extern "C" int hash_scatter_add(const void* idx, const void* upd, void* out,
                                long long n, int total, int feat,
                                int round_bf16, void* stream) {
  if (n <= 0) return 0;
  if (round_bf16 && feat != 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (n + kThreads - 1) / kThreads;
  const unsigned int blocks =
      static_cast<unsigned int>(want < (1LL << 30) ? want : (1LL << 30));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* i = static_cast<const int32_t*>(idx);
  if (feat == 2) {
    const float2* u = static_cast<const float2*>(upd);
    float2* o = static_cast<float2*>(out);
    if (round_bf16) {
      hash_scatter_add_f2_kernel<true><<<blocks, kThreads, 0, s>>>(i, u, o, n, total);
    } else {
      hash_scatter_add_f2_kernel<false><<<blocks, kThreads, 0, s>>>(i, u, o, n, total);
    }
  } else {
    hash_scatter_add_kernel<<<blocks, kThreads, 0, s>>>(
        i, static_cast<const float*>(upd), static_cast<float*>(out), n, total, feat);
  }
  return static_cast<int>(cudaGetLastError());
}
