// Multiresolution hash encode for Hopper (sm_90a): the forward, positions
// to features, and the backward's rows and updates for the scatter kernel.
//
// The reference package has no Pallas kernel here: its encode
// (stable_nerf_tpu/ops/encoding.py, hash_grid_encode) is XLA's fused index
// arithmetic and gather.  The port's plain version of the same function
// (ops/encoding.py: _hash_sections, _encode_sections) emulates the uint32
// hash in int64 tensors and writes every [M, L', 8] intermediate to device
// memory; this kernel computes the rows, the weights and the one-corner
// draw in registers in native uint32 arithmetic, and the backward's rows
// and updates then go to the scatter kernel (csrc/hash_scatter.cu) as
// before.
//
// Bound, for one 2^17-sample chunk of the 16-level grid at F = 2 on an
// H100 (3.35 TB/s):
//   forward   the positions read (1.5 MB), the features written (16.8 MB)
//             and 16 levels x 8 corners x 8 bytes gathered a sample with no
//             reuse (134 MB): ~152 MB, ~0.045 ms;
//   backward  the positions and the output gradient read (1.5 + 16.8 MB),
//             the int32 rows (67 MB) and f32 updates (134 MB) written:
//             ~220 MB, ~0.066 ms.
// Design:
//   - Forward: one thread a sample.  It reads its position once and walks
//     every level, so the 32 lanes of a warp gather the same level of 32
//     consecutive samples: consecutive samples of a ray fall in one cell
//     of the coarse levels, and equal addresses of a warp are one
//     transaction.  The 8 corner loads of a level are issued together.
//   - Backward: one thread a (sample, level), so a warp writes its rows
//     and updates as one contiguous run.  It gathers nothing and writes
//     96 bytes a thread; a thread a sample would write them 1.5 KB apart
//     a lane (measured at six times the byte bound).
//   - The level table (scale as f32, resolution, dense flag, row offset,
//     draw salt, one corner or eight) is a kernel argument built once per
//     grid configuration on the host; nothing is copied to the device.
//   - Rows and weights equal the plain version's bit for bit:
//     pos = x * scale + 0.5 with __fmul_rn and __fadd_rn (a contracted FMA
//     would move floor(pos)), w = pos - floor(pos) with __fsub_rn, the
//     corner weights as the plain version's left-to-right products, the
//     uint32 wrap of the dense index and of the tcnn hash, % T.  The
//     one-corner draw hashes the position's float bits with the level's
//     salt through the same three murmur mixes, (u >> 8) * 2^-24 < w.
//   - Corners are summed in order 0..7 without contraction (features
//     within rounding of the plain version's sum).
//   - F in {1, 2, 4, 8}: rows are gathered as one float, float2 or float4
//     (two for F = 8).
//
// Plain C interface for ctypes: the wrapper (ops/hopper/encode.py) checks
// and allocates, passes PyTorch's current stream, and raises on a non-zero
// return (the cudaGetLastError() of the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;
constexpr uint32_t kPrime1 = 2654435761u;   // tcnn grid.h; the first prime is 1
constexpr uint32_t kPrime2 = 805459861u;

// One level, as ops/hopper/encode.py's LevelParams lays it out.
struct LevelParams {
  float scale;
  uint32_t resolution;
  uint32_t dense;
  uint32_t offset;       // level · table_size: the level's first row
  uint32_t salt;         // level · 0x9E3779B9, the one-corner draw's
  uint32_t one_corner;
};

struct LevelTable {
  LevelParams lv[kMaxLevels];
};

struct Grid {
  uint32_t table_size;
  uint32_t mask;         // table_size - 1 where it is a power of two, else 0
};

__device__ __forceinline__ uint32_t wrap_mod(uint32_t v, Grid grid) {
  return grid.mask ? (v & grid.mask) : (v % grid.table_size);
}

// Row of corner (cx, cy, cz) within its level (before the level offset).
__device__ __forceinline__ uint32_t cell_row(uint32_t cx, uint32_t cy, uint32_t cz,
                                             const LevelParams& p, Grid grid) {
  const uint32_t r = p.resolution;
  const uint32_t v = p.dense ? cx + cy * r + cz * (r * r)
                             : cx ^ (cy * kPrime1) ^ (cz * kPrime2);
  return wrap_mod(v, grid);
}

__device__ __forceinline__ uint32_t mix(uint32_t v, uint32_t c) {
  v = (v ^ (v >> 16)) * c;
  v = (v ^ (v >> 13)) * 0x5BD1E995u;
  return v ^ (v >> 16);
}

// (u >> 8) · 2^-24 < w: the draw's bit for one axis
__device__ __forceinline__ uint32_t draw_bit(uint32_t hh, uint32_t c, float w) {
  const float u = __fmul_rn(__uint2float_rn(mix(hh, c) >> 8), 5.9604644775390625e-8f);
  return u < w ? 1u : 0u;
}

// A sample's cell at one level: the lower corner and the fractional
// position of each axis.
struct Cell {
  uint32_t c[3];
  float w[3];
};

__device__ __forceinline__ Cell cell_of(const float (&x)[3], float scale) {
  Cell cell;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __fadd_rn(__fmul_rn(x[a], scale), 0.5f);
    const float fl = floorf(pos);
    cell.w[a] = __fsub_rn(pos, fl);
    cell.c[a] = static_cast<uint32_t>(static_cast<long long>(fl));
  }
  return cell;
}

// The 8 corners' rows and trilinear weights; corner k = 4i + 2j + l
// offsets (x, y, z) by (i, j, l), weights as the plain version multiplies
// them: (wx' · wy') · wz'.
__device__ __forceinline__ void corners8(const Cell& cell, const LevelParams& p, Grid grid,
                                         uint32_t (&row)[8], float (&cw)[8]) {
  const float one_x = __fsub_rn(1.0f, cell.w[0]);
  const float one_y = __fsub_rn(1.0f, cell.w[1]);
  const float one_z = __fsub_rn(1.0f, cell.w[2]);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t i = (k >> 2) & 1, j = (k >> 1) & 1, l = k & 1;
    row[k] = cell_row(cell.c[0] + i, cell.c[1] + j, cell.c[2] + l, p, grid) + p.offset;
    cw[k] = __fmul_rn(__fmul_rn(i ? cell.w[0] : one_x, j ? cell.w[1] : one_y),
                      l ? cell.w[2] : one_z);
  }
}

// The one corner drawn ∝ its trilinear weight: each axis steps up with
// probability w.
__device__ __forceinline__ uint32_t corner1(const Cell& cell, uint32_t h,
                                            const LevelParams& p, Grid grid) {
  const uint32_t hh = h ^ p.salt;
  const uint32_t bx = draw_bit(hh, 0x85EBCA6Bu, cell.w[0]);
  const uint32_t by = draw_bit(hh, 0xC2B2AE35u, cell.w[1]);
  const uint32_t bz = draw_bit(hh, 0x27D4EB2Fu, cell.w[2]);
  return cell_row(cell.c[0] + bx, cell.c[1] + by, cell.c[2] + bz, p, grid) + p.offset;
}

// the position's float bits, hashed as the draw's seed
__device__ __forceinline__ uint32_t position_hash(const float (&x)[3]) {
  return __float_as_uint(x[0]) ^ (__float_as_uint(x[1]) * kPrime1) ^
         (__float_as_uint(x[2]) * kPrime2);
}

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ table, uint32_t row,
                                         float (&v)[F]) {
  if constexpr (F == 1) {
    v[0] = __ldg(table + row);
  } else if constexpr (F == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(table) + row);
    v[0] = a.x;
    v[1] = a.y;
  } else {
    const float4* p = reinterpret_cast<const float4*>(table) + static_cast<size_t>(row) * (F / 4);
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 a = __ldg(p + q);
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  }
}

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(int32_t v) { return static_cast<uint32_t>(v); }

// Stores N consecutive 32-bit values (16-byte aligned where N % 4 == 0,
// 8-byte where N % 2 == 0: the callers' offsets are multiples of N).
template <int N, typename T>
__device__ __forceinline__ void store(T* __restrict__ dst, const T (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      reinterpret_cast<uint4*>(dst)[q] =
          make_uint4(bits(v[4 * q]), bits(v[4 * q + 1]), bits(v[4 * q + 2]), bits(v[4 * q + 3]));
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      reinterpret_cast<uint2*>(dst)[q] = make_uint2(bits(v[2 * q]), bits(v[2 * q + 1]));
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) dst[q] = v[q];
  }
}

// ---------------------------------------------------------------------------
// Forward: x [m, 3] f32, table [n_levels · T, F] f32 → out [m, n_levels · F].
template <int F>
__global__ void __launch_bounds__(kThreads)
hash_encode_fwd_kernel(const float* __restrict__ x, const float* __restrict__ table,
                       float* __restrict__ out, int64_t m, int n_levels, Grid grid,
                       LevelTable levels) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float pos[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
  const uint32_t h = position_hash(pos);
  float* dst = out + i * n_levels * F;
#pragma unroll 1
  for (int l = 0; l < n_levels; ++l) {
    const LevelParams p = levels.lv[l];
    const Cell cell = cell_of(pos, p.scale);
    float acc[F];
    if (p.one_corner) {
      load_row<F>(table, corner1(cell, h, p, grid), acc);
    } else {
      uint32_t row[8];
      float cw[8];
      corners8(cell, p, grid, row, cw);
      float v[8][F];
#pragma unroll
      for (int k = 0; k < 8; ++k) load_row<F>(table, row[k], v[k]);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float s = __fmul_rn(v[0][f], cw[0]);
#pragma unroll
        for (int k = 1; k < 8; ++k) s = __fadd_rn(s, __fmul_rn(v[k][f], cw[k]));
        acc[f] = s;
      }
    }
    store<F>(dst + l * F, acc);
  }
}

// Backward of one level section [lv0, lv0 + lp), all of it exact (C = 8)
// or all one corner (C = 1): rows [m, lp, C] int32, local to the section
// (level lv0 + s in [s · T, (s + 1) · T)), and updates [m, lp, C, F]
// = corner weight · g[m, level, :], g [m, n_levels · F].  One thread a
// (sample, level): neighbouring threads write neighbouring rows and
// updates, so a warp's stores are contiguous.
template <int F, int C>
__global__ void __launch_bounds__(kThreads)
hash_encode_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       int32_t* __restrict__ rows, float* __restrict__ upd, int64_t n,
                       int lv0, int lp, int n_levels, Grid grid, LevelTable levels) {
  const int64_t at = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (at >= n) return;
  const int64_t i = at / lp;
  const int l = lv0 + static_cast<int>(at - i * lp);
  const float pos[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
  const LevelParams p = levels.lv[l];
  const uint32_t base = levels.lv[lv0].offset;
  const Cell cell = cell_of(pos, p.scale);
  float gl[F];
#pragma unroll
  for (int f = 0; f < F; ++f) gl[f] = g[(i * n_levels + l) * F + f];
  int32_t r[C];
  float u[C * F];
  if constexpr (C == 8) {
    uint32_t row[8];
    float cw[8];
    corners8(cell, p, grid, row, cw);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      r[k] = static_cast<int32_t>(row[k] - base);
#pragma unroll
      for (int f = 0; f < F; ++f) u[k * F + f] = __fmul_rn(cw[k], gl[f]);
    }
  } else {
    r[0] = static_cast<int32_t>(corner1(cell, position_hash(pos), p, grid) - base);
#pragma unroll
    for (int f = 0; f < F; ++f) u[f] = __fmul_rn(1.0f, gl[f]);
  }
  store<C>(rows + at * C, r);
  store<C * F>(upd + at * C * F, u);
}

bool make_table(const void* host_levels, int n_levels, int table_size, LevelTable* lt,
                Grid* grid) {
  if (n_levels < 1 || n_levels > kMaxLevels || table_size < 1) return false;
  if (static_cast<long long>(n_levels) * table_size > 0x7fffffffLL) return false;
  const LevelParams* src = static_cast<const LevelParams*>(host_levels);
  for (int l = 0; l < kMaxLevels; ++l) lt->lv[l] = l < n_levels ? src[l] : LevelParams{};
  grid->table_size = static_cast<uint32_t>(table_size);
  grid->mask = (table_size & (table_size - 1)) == 0 ? grid->table_size - 1u : 0u;
  return true;
}

unsigned blocks_for(long long m) {
  return static_cast<unsigned>((m + kThreads - 1) / kThreads);
}

template <int F>
int launch_fwd(const void* x, const void* table, void* out, long long m, int n_levels,
               Grid grid, const LevelTable& lt, cudaStream_t s) {
  hash_encode_fwd_kernel<F><<<blocks_for(m), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(table),
      static_cast<float*>(out), m, n_levels, grid, lt);
  return static_cast<int>(cudaGetLastError());
}

template <int F, int C>
int launch_bwd(const void* x, const void* g, void* rows, void* upd, long long m, int lv0,
               int lp, int n_levels, Grid grid, const LevelTable& lt, cudaStream_t s) {
  const long long n = m * lp;
  hash_encode_bwd_kernel<F, C><<<blocks_for(n), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<int32_t*>(rows), static_cast<float*>(upd), n, lv0, lp, n_levels, grid, lt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [m, 3] f32, table [n_levels · table_size, feat] f32, out [m, n_levels ·
// feat] f32; levels: n_levels LevelParams in host memory.  feat in {1, 2,
// 4, 8}.  Returns a cudaError_t (0 = launched).
extern "C" int hash_encode_forward(const void* x, const void* table, void* out, long long m,
                                   int n_levels, int table_size, int feat,
                                   const void* levels, void* stream) {
  LevelTable lt;
  Grid grid;
  if (m < 0 || m > (0x7fffffffLL - kThreads) * kThreads ||
      !make_table(levels, n_levels, table_size, &lt, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat) {
    case 1: return launch_fwd<1>(x, table, out, m, n_levels, grid, lt, s);
    case 2: return launch_fwd<2>(x, table, out, m, n_levels, grid, lt, s);
    case 4: return launch_fwd<4>(x, table, out, m, n_levels, grid, lt, s);
    case 8: return launch_fwd<8>(x, table, out, m, n_levels, grid, lt, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward of levels [lv0, lv0 + lp): g [m, n_levels · feat] f32 →
// rows [m, lp, C] int32 and upd [m, lp, C, feat] f32, C = 1 where
// one_corner, else 8.  Returns a cudaError_t (0 = launched).
extern "C" int hash_encode_backward(const void* x, const void* g, void* rows, void* upd,
                                    long long m, int lv0, int lp, int n_levels,
                                    int table_size, int feat, int one_corner,
                                    const void* levels, void* stream) {
  LevelTable lt;
  Grid grid;
  if (m < 0 || lv0 < 0 || lp < 1 || lv0 + lp > n_levels ||
      m * lp > (0x7fffffffLL - kThreads) * kThreads ||
      !make_table(levels, n_levels, table_size, &lt, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = lv0; l < lv0 + lp; ++l) {
    if ((lt.lv[l].one_corner != 0) != (one_corner != 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat * 2 + (one_corner ? 1 : 0)) {
    case 2: return launch_bwd<1, 8>(x, g, rows, upd, m, lv0, lp, n_levels, grid, lt, s);
    case 3: return launch_bwd<1, 1>(x, g, rows, upd, m, lv0, lp, n_levels, grid, lt, s);
    case 4: return launch_bwd<2, 8>(x, g, rows, upd, m, lv0, lp, n_levels, grid, lt, s);
    case 5: return launch_bwd<2, 1>(x, g, rows, upd, m, lv0, lp, n_levels, grid, lt, s);
    case 8: return launch_bwd<4, 8>(x, g, rows, upd, m, lv0, lp, n_levels, grid, lt, s);
    case 9: return launch_bwd<4, 1>(x, g, rows, upd, m, lv0, lp, n_levels, grid, lt, s);
    case 16: return launch_bwd<8, 8>(x, g, rows, upd, m, lv0, lp, n_levels, grid, lt, s);
    case 17: return launch_bwd<8, 1>(x, g, rows, upd, m, lv0, lp, n_levels, grid, lt, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
