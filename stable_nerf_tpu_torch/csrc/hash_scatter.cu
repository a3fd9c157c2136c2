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
// written once, so at the main-path shape (idx [2^17, 16, 8]: 16.7 M
// updates, F = 2, a 64 MiB table) the byte bound is ~0.08 ms on an H100.
// What limits one float2 atomic per update on this card, as measured on
// an NVIDIA H100 80GB HBM3 at 700 W (the per-level tables and every
// variant's time are in PERF.md, section 6):
//   - the rate of atomic transactions.  At uniform positions a level alone
//     (1 M updates) takes about as long hashed as dense, and all 16 levels
//     at once take 1.4x the sum of the single levels: with every slab live
//     the 64 MiB table misses L2, but only where the positions spread over
//     all rows;
//   - same-address atomics.  At the main path's positions a chunk touches
//     few rows (under a thousand of level 0, 3.1 M of all levels for 16.7 M
//     updates): consecutive samples of a ray fall in one cell of the coarse
//     levels and samples past a ray's exit are clamped to one point, and
//     atomics on one address queue.  There every level alone is slower than
//     at uniform positions, the dense ones most, and the single levels add
//     up to twice the whole call: misses are not what costs.
// So the design removes atomic transactions rather than bytes:
//   1. Level-major traversal with runs merged in registers (C = 8).  The
//      grid's slow index is the level; four lanes share a run of 16
//      consecutive samples at one level, and each lane keeps one pair of
//      corners as a running sum while the next sample gives the same two
//      rows.  With 2. this leaves less than half of the main path's updates
//      as atomics (a tenth to three tenths on levels 0-4).
//   2. Two rows in one atomic.  Corners c and c + 4 differ in x by one; with
//      the dense index and with the hash (its first prime is 1) their rows
//      differ only in bit 0 whenever x is even, so half of all pairs are
//      one aligned 16-byte slot and take one float4 atomic.
//   3. Levels that fit are summed in shared memory.  Where a level's whole
//      slab (table_size rows) fits a block's 227 KB, the block accumulates
//      the level there with shared-memory atomics and adds its non-zero
//      rows to the table once; rows outside the level's slab still go to
//      the table directly.  This pays on small tables (many updates a row);
//      the main path's 4 MiB slabs do not fit and take 1. and 2. alone.
//      Summing only the addressed rows of its coarse dense levels there (a
//      caller's hint) was measured and lost at the main path: the runs have
//      taken most of those levels' atomics already, and f32 shared-memory
//      atomics are no cheaper than the table's.
//   4. A table that fits shared memory whole (the K2-sized tables, any C)
//      is walked flat with coalesced loads; equal rows of a warp are first
//      summed by shuffles (__match_any_sync), so a hot row costs one
//      shared-memory atomic a warp.
// Everything else (C != 8 on a large table, F != 2) keeps the flat order,
// one thread and one atomic per update: the stochastic encode's sections
// (C = 1) are a sixteenth of the work and their slabs fit L2, and a
// level-major read of them would waste 7/8 of each sector.
// Reading [M, L', 8] at a fixed level touches whole 32-byte sectors only
// (a (sample, level) is 32 bytes of rows and 64 of updates), loaded as
// 8 + 16 bytes a lane and marked evict-first so the inputs stream past the
// table in L2; alone this strided read takes less than the atomics.
// payload_bf16 rounds each feature to bf16 (round to nearest even) before
// any sum, the contract of the reference's pack_bf16_pair /
// unpack_bf16_pair; sums stay f32.
//
// Plain C interface for ctypes: the wrapper (ops/hopper/scatter.py)
// allocates and zeroes the output, passes PyTorch's current stream, and
// raises on a non-zero return (a refused cudaFuncSetAttribute or the
// cudaGetLastError() of a launch; nothing is retried another way).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFlatSharedThreads = 1024;
constexpr int kCornerThreads = 512;
constexpr int kRun = 16;                 // consecutive samples a thread walks
constexpr int kChunk = 4;                // of them, loaded before any is used
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the most a block can get
constexpr int kSmallTableBytes = 48 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;

template <bool kRoundBf16>
__device__ __forceinline__ float payload(float v) {
  return kRoundBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ bool nonzero(float2 v) {
  return v.x != 0.0f || v.y != 0.0f;   // true for NaN
}

// ---------------------------------------------------------------------------
// Flat order, F = 2, global atomics: one thread per update.
template <bool kRoundBf16>
__global__ void flat_f2_kernel(const int32_t* __restrict__ idx,
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

// Flat order, F = 2, the whole table in the block's shared memory.  Equal
// rows of a warp are summed by shuffles first and added by one lane, so a
// hot row costs one shared-memory atomic a warp.
template <bool kRoundBf16>
__global__ void __launch_bounds__(kFlatSharedThreads)
flat_shared_f2_kernel(const int32_t* __restrict__ idx,
                      const float2* __restrict__ upd, float2* __restrict__ out,
                      int64_t n, int32_t total) {
  extern __shared__ float2 acc[];
  for (int r = threadIdx.x; r < total; r += blockDim.x) acc[r] = make_float2(0.f, 0.f);
  __syncthreads();
  const unsigned lane = threadIdx.x & 31u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x + (threadIdx.x - lane);
       base < n; base += stride) {               // warp-uniform bounds
    const int64_t i = base + lane;
    int32_t row = -1;
    float2 v = make_float2(0.f, 0.f);
    if (i < n) {
      row = __ldcs(idx + i);
      if (row < 0 || row >= total) {
        row = -1;
      } else {
        v = __ldcs(upd + i);
        v.x = payload<kRoundBf16>(v.x);
        v.y = payload<kRoundBf16>(v.y);
      }
    }
    const unsigned peers = __match_any_sync(kFullMask, row);
    if (peers == kFullMask) {                    // one row in the whole warp
      for (int o = 16; o > 0; o >>= 1) {
        v.x += __shfl_xor_sync(kFullMask, v.x, o);
        v.y += __shfl_xor_sync(kFullMask, v.y, o);
      }
      if (lane != 0) row = -1;
    } else {
      const unsigned dup = __ballot_sync(kFullMask, row >= 0 && peers != (1u << lane));
      if (dup) {
        float2 sum = v;
        for (unsigned rest = dup; rest; rest &= rest - 1) {
          const int src = __ffs(rest) - 1;
          const float x = __shfl_sync(kFullMask, v.x, src);
          const float y = __shfl_sync(kFullMask, v.y, src);
          if (((peers >> src) & 1u) && src != static_cast<int>(lane)) {
            sum.x += x;
            sum.y += y;
          }
        }
        v = sum;
        if (static_cast<int>(lane) != __ffs(peers) - 1) row = -1;
      }
    }
    if (row >= 0) {
      atomicAdd(&acc[row].x, v.x);
      atomicAdd(&acc[row].y, v.y);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < total; r += blockDim.x) {
    const float2 v = acc[r];
    if (nonzero(v)) atomicAdd(out + r, v);
  }
}

// Flat order, any F: one scalar atomic per feature.
__global__ void flat_kernel(const int32_t* __restrict__ idx,
                            const float* __restrict__ upd,
                            float* __restrict__ out, int64_t n, int32_t total,
                            int32_t feat) {
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

// ---------------------------------------------------------------------------
// C = 8, F = 2: a thread walks kRun consecutive samples at one level.
//
// The 8 corners of a (sample, level) are 4 pairs (c, c + 4) that differ in
// x by one.  A pair is kept as a run: while the next sample gives the same
// two rows, its updates are added in registers; when the rows change the
// run is emitted.
struct PairRun {
  int32_t lo, hi;      // rows of corners c and c + 4; -1: nothing held
  float2 vlo, vhi;
};

template <bool kShared>
__device__ __forceinline__ void emit_row(int32_t row, float2 v, float2* out,
                                         int32_t total, float2* acc,
                                         int32_t slab, int32_t rows) {
  if (row < 0 || row >= total) return;
  if (kShared) {
    const int32_t local = row - slab;
    if (local >= 0 && local < rows) {
      atomicAdd(&acc[local].x, v.x);
      atomicAdd(&acc[local].y, v.y);
      return;
    }
  }
  atomicAdd(out + row, v);
}

template <bool kShared>
__device__ __forceinline__ void emit_pair(const PairRun& r, float2* out,
                                          int32_t total, float2* acc,
                                          int32_t slab, int32_t rows) {
  // two valid rows of one aligned 16-byte pair, not summed in shared
  // memory: one float4 atomic
  if (rows == 0 && (r.lo ^ r.hi) == 1 && r.lo >= 0 && (r.lo | 1) < total) {
    const bool lo_first = r.lo < r.hi;
    const float2 a = lo_first ? r.vlo : r.vhi;
    const float2 b = lo_first ? r.vhi : r.vlo;
    atomicAdd(reinterpret_cast<float4*>(out + (r.lo & ~1)),
              make_float4(a.x, a.y, b.x, b.y));
    return;
  }
  emit_row<kShared>(r.lo, r.vlo, out, total, acc, slab, rows);
  emit_row<kShared>(r.hi, r.vhi, out, total, acc, slab, rows);
}

template <bool kRoundBf16, bool kShared>
__device__ __forceinline__ void step_pair(PairRun& r, int32_t lo, int32_t hi,
                                          float lx, float ly, float hx, float hy,
                                          float2* out, int32_t total, float2* acc,
                                          int32_t slab, int32_t rows) {
  lx = payload<kRoundBf16>(lx);
  ly = payload<kRoundBf16>(ly);
  hx = payload<kRoundBf16>(hx);
  hy = payload<kRoundBf16>(hy);
  if (lo == r.lo && hi == r.hi) {
    r.vlo.x += lx;
    r.vlo.y += ly;
    r.vhi.x += hx;
    r.vhi.y += hy;
  } else {
    emit_pair<kShared>(r, out, total, acc, slab, rows);
    r.lo = lo;
    r.hi = hi;
    r.vlo = make_float2(lx, ly);
    r.vhi = make_float2(hx, hy);
  }
}

// A block takes one level blockIdx.x / blocks_per_level and tiles_per_block
// tiles of kCornerThreads / 4 · kRun samples.  kShared: the level's slab of
// table_size rows (where the table holds it) is summed in the block's shared
// memory and its non-zero rows added to the table once.
template <bool kRoundBf16, bool kShared>
__global__ void __launch_bounds__(kCornerThreads, 2)
corner8_f2_kernel(const int2* __restrict__ idx, const float4* __restrict__ upd,
                  float2* __restrict__ out, int64_t m, int32_t lp,
                  int32_t tiles, int32_t blocks_per_level,
                  int32_t tiles_per_block, int32_t table_size, int32_t total) {
  extern __shared__ float2 acc[];
  const int32_t p = blockIdx.x / blocks_per_level; // level-major: the level is
  const int32_t b = blockIdx.x % blocks_per_level; // the slow index of the grid
  const int64_t slab64 = static_cast<int64_t>(p) * table_size;
  const int32_t rows = kShared && slab64 + table_size <= total ? table_size : 0;
  const int32_t slab = rows > 0 ? static_cast<int32_t>(slab64) : 0;
  if (kShared && rows > 0) {
    for (int r = threadIdx.x; r < rows; r += kCornerThreads) acc[r] = make_float2(0.f, 0.f);
    __syncthreads();
  }
  // four lanes a run of samples: lane j loads corners 2j and 2j + 1 (8 bytes
  // of rows, 16 of updates), then lanes j and j ^ 2 swap one corner each, so
  // that lane j < 2 holds the pair (j, j + 4) and lane j >= 2 (2j - 3, 2j + 1)
  const int j = threadIdx.x & 3;
  const bool low = j < 2;
  const int32_t tile_end = min(tiles, (b + 1) * tiles_per_block);
  for (int32_t tile = b * tiles_per_block; tile < tile_end; ++tile) {
    const int64_t s0 =
        (static_cast<int64_t>(tile) * (kCornerThreads / 4) + (threadIdx.x >> 2)) * kRun;
    PairRun run;
    run.lo = -1;
    run.hi = -1;
    run.vlo = make_float2(0.f, 0.f);
    run.vhi = make_float2(0.f, 0.f);
#pragma unroll
    for (int k0 = 0; k0 < kRun; k0 += kChunk) {
      int2 r[kChunk];
      float4 u[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (s0 + k0 + k < m) {
          const int64_t off = ((s0 + k0 + k) * lp + p) * 4 + j;
          r[k] = __ldcs(idx + off);
          u[k] = __ldcs(upd + off);
        } else {
          r[k] = make_int2(-1, -1);
          u[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int32_t got_row = __shfl_xor_sync(kFullMask, low ? r[k].y : r[k].x, 2);
        const float got_x = __shfl_xor_sync(kFullMask, low ? u[k].z : u[k].x, 2);
        const float got_y = __shfl_xor_sync(kFullMask, low ? u[k].w : u[k].y, 2);
        if (low) {
          step_pair<kRoundBf16, kShared>(run, r[k].x, got_row, u[k].x, u[k].y, got_x,
                                         got_y, out, total, acc, slab, rows);
        } else {
          step_pair<kRoundBf16, kShared>(run, got_row, r[k].y, got_x, got_y, u[k].z,
                                         u[k].w, out, total, acc, slab, rows);
        }
      }
    }
    emit_pair<kShared>(run, out, total, acc, slab, rows);
  }
  if (kShared && rows > 0) {
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += kCornerThreads) {
      const float2 v = acc[r];
      if (nonzero(v)) atomicAdd(out + slab + r, v);
    }
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kSmallTableBytes)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <bool kRoundBf16>
cudaError_t launch_f2(const void* idx, const void* upd, void* out, int64_t m,
                      int lp, int c, int table_size, int total, int sms,
                      cudaStream_t s) {
  const int64_t n = m * lp * c;
  const size_t table_bytes = static_cast<size_t>(total) * sizeof(float2);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const float2* u = static_cast<const float2*>(upd);
  float2* o = static_cast<float2*>(out);
  const bool corner8 = c == 8 && aligned16(idx) && aligned16(upd) && aligned16(out);

  if (table_bytes <= static_cast<size_t>(kSmallTableBytes) ||
      (!corner8 && table_bytes <= static_cast<size_t>(kMaxSharedBytes))) {
    cudaError_t rc = allow_shared(flat_shared_f2_kernel<kRoundBf16>, table_bytes);
    if (rc != cudaSuccess) return rc;
    const int64_t want = (n + kFlatSharedThreads - 1) / kFlatSharedThreads;
    const unsigned blocks = static_cast<unsigned>(want < sms ? want : sms);
    flat_shared_f2_kernel<kRoundBf16>
        <<<blocks, kFlatSharedThreads, table_bytes, s>>>(i, u, o, n, total);
    return cudaGetLastError();
  }
  if (!corner8) {
    const int64_t want = (n + kThreads - 1) / kThreads;
    const unsigned blocks =
        static_cast<unsigned>(want < (1LL << 30) ? want : (1LL << 30));
    flat_f2_kernel<kRoundBf16><<<blocks, kThreads, 0, s>>>(i, u, o, n, total);
    return cudaGetLastError();
  }

  const int64_t per_tile = kCornerThreads / 4 * kRun;
  const int64_t tiles = (m + per_tile - 1) / per_tile;
  const int2* i2 = static_cast<const int2*>(idx);
  const float4* u4 = static_cast<const float4*>(upd);
  const size_t slab_bytes = static_cast<size_t>(table_size) * sizeof(float2);
  const bool shared = slab_bytes <= static_cast<size_t>(kMaxSharedBytes);
  // a block that sums in shared memory takes enough tiles to pay for its
  // one pass over the level's rows: about two blocks an SM and level
  const int64_t per_block = shared ? (tiles + 2 * sms - 1) / (2 * sms) : 1;
  const int64_t per_level = (tiles + per_block - 1) / per_block;
  const int64_t blocks = per_level * lp;
  if (tiles > 0x7fffffffLL || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (shared) {
    cudaError_t rc = allow_shared(corner8_f2_kernel<kRoundBf16, true>, slab_bytes);
    if (rc != cudaSuccess) return rc;
    corner8_f2_kernel<kRoundBf16, true>
        <<<static_cast<unsigned>(blocks), kCornerThreads, slab_bytes, s>>>(
            i2, u4, o, m, lp, static_cast<int>(tiles), static_cast<int>(per_level),
            static_cast<int>(per_block), table_size, total);
  } else {
    corner8_f2_kernel<kRoundBf16, false>
        <<<static_cast<unsigned>(blocks), kCornerThreads, 0, s>>>(
            i2, u4, o, m, lp, static_cast<int>(tiles), static_cast<int>(per_level),
            static_cast<int>(per_block), table_size, total);
  }
  return cudaGetLastError();
}

}  // namespace

// idx [m, lp, c] int32, upd [m, lp, c, feat] f32, out [n_levels·table_size,
// feat] f32 zeroed by the caller.  round_bf16 is taken only with feat == 2.
// Returns a cudaError_t (0 = launched).
extern "C" int hash_scatter_add(const void* idx, const void* upd, void* out,
                                long long m, int lp, int c, int n_levels,
                                int table_size, int feat, int round_bf16,
                                void* stream) {
  const long long total64 = static_cast<long long>(n_levels) * table_size;
  if (m < 0 || lp < 0 || c < 0 || feat <= 0 || total64 > 0x7fffffffLL ||
      (round_bf16 && feat != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = m * lp * c;
  if (n == 0 || total64 == 0) return 0;
  const int total = static_cast<int>(total64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feat != 2) {
    const long long want = (n + kThreads - 1) / kThreads;
    const unsigned blocks =
        static_cast<unsigned>(want < (1LL << 30) ? want : (1LL << 30));
    flat_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(idx), static_cast<const float*>(upd),
        static_cast<float*>(out), n, total, feat);
    return static_cast<int>(cudaGetLastError());
  }
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = round_bf16 ? launch_f2<true>(idx, upd, out, m, lp, c, table_size, total, sms, s)
                  : launch_f2<false>(idx, upd, out, m, lp, c, table_size, total, sms, s);
  return static_cast<int>(rc);
}
