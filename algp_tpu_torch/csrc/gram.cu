// Gram matrix K(X1, X2) = s² · k_sp(r²_sp) · k_ft(r²_ft), f32, straight to
// device memory.
//
// Replaces: algp_tpu/ops/gram.py `_gram_kernel_spatial` and
// `_gram_kernel_composite` (the Pallas bodies behind `gram_pallas`, whose
// `pl.pallas_call` is at gram.py:158), one template for both.
//
// Bound, on an H100: the bytes, with the issued instructions close
// behind.  The output is n1·n2·4 bytes (512 × 2²⁰ → 2.1 GB, 0.64 ms at
// 3.35 TB/s) and the inputs a few coordinates a row.  But each output
// also costs its IEEE arithmetic (the differences, the `_rn` products and
// sums, and for Matérn a correctly rounded sqrtf and expf): the hot loop
// issues 33 SASS instructions a Matérn 3/2 output and 17 an RBF one
// (`tools/gram_profile.py` counts them from cuobjdump; the earlier
// shared-tile design issued 66 a Matérn output).  At 33 the arithmetic alone takes ≈ 90 % of
// the time the stores alone take, so any instruction that is not the
// math (shared-memory reads, address arithmetic, narrow stores, a block's
// prologue and barrier) pushes the kernel off the bytes bound.
//
// Design: a thread owns 4 adjacent columns, holds their coordinates in
// registers (the spatial width DS ∈ {1, 2, 3} is a template parameter,
// read with 16-byte loads once), and walks the rows of its tile: per row
// one warp-uniform load of the row's coordinates, 4 outputs, and one
// 16-byte streaming store (`st.global.cs.v4`: the output is never re-read
// from L2).  A warp writes 512 contiguous bytes of a row per store.  A
// block of 256 threads owns a 1 024-column strip and 8 rows of it, one
// block a tile, with no shared memory and no barrier: on the H100 that
// beat taller tiles, a persistent grid and TMA bulk stores drained from
// shared memory (`tools/gram_variants.cu`).  A width outside {1, 2, 3},
// and the feature segment (df ≤ 64), read their coordinates per output
// from global memory (L1-resident) in a runtime loop.  n2 % 4 ≠ 0 (rows
// not 16-byte aligned) takes the same loop with 4-byte stores.  Offsets
// into the output are 64-bit (512 × 2²² = 2³¹ outputs).
//
// Numerics mirror the plain PyTorch version (ops/kernels.gram) bit for
// bit: the inputs arrive already scaled by exp(-log_ls), r² is the direct
// difference sum Σ_k (a_k − b_k)² in coordinate order, the closed forms
// are those of `stationary_form` (Matérn takes √max(r², 1e-20)), and the
// composite is s · (k_sp · k_ft).  The `_rn` intrinsics keep nvcc from
// contracting these into FMAs; expf/sqrtf are IEEE (no fast math).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;                // threads in a block
constexpr int kVec = 4;                      // adjacent columns a thread owns
constexpr int kStrip = kThreads * kVec;      // columns a block owns
constexpr int kRows = 8;                     // rows of a tile

constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.23606797749979f;

enum Kind { kNone = -1, kRbf = 0, kMatern32 = 1, kMatern52 = 2 };

template <int KIND>
__device__ __forceinline__ float stationary(float r2) {
  if constexpr (KIND == kRbf) {
    return expf(__fmul_rn(-0.5f, r2));
  } else {
    const float r = sqrtf(fmaxf(r2, 1e-20f));
    if constexpr (KIND == kMatern32) {
      const float a = __fmul_rn(kSqrt3, r);
      return __fmul_rn(__fadd_rn(1.0f, a), expf(-a));
    } else {
      static_assert(KIND == kMatern52, "unknown kernel kind");
      const float a = __fmul_rn(kSqrt5, r);
      const float poly = __fadd_rn(__fadd_rn(1.0f, a), __fdiv_rn(__fmul_rn(a, a), 3.0f));
      return __fmul_rn(poly, expf(-a));
    }
  }
}

// Σ_k (a[k] − b[k])² over a width known at compile time, in coordinate
// order, no FMA contraction.  The sum starts at the first square: the
// plain version's 0 + t is t for every t ≥ +0.
template <int D>
__device__ __forceinline__ float sqdist_reg(const float (&a)[D], const float (&b)[D]) {
  float diff = __fsub_rn(a[0], b[0]);
  float acc = __fmul_rn(diff, diff);
#pragma unroll
  for (int k = 1; k < D; ++k) {
    diff = __fsub_rn(a[k], b[k]);
    acc = __fadd_rn(acc, __fmul_rn(diff, diff));
  }
  return acc;
}

// The same over a runtime width, read from global memory.
__device__ __forceinline__ float sqdist_mem(const float* __restrict__ a,
                                            const float* __restrict__ b, int d) {
  float acc = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float diff = __fsub_rn(__ldg(a + k), __ldg(b + k));
    acc = __fadd_rn(acc, __fmul_rn(diff, diff));
  }
  return acc;
}

// The row's spatial coordinates: one warp-uniform load.
template <int DS>
__device__ __forceinline__ void load_row(const float* __restrict__ x1s, int row, float (&a)[DS]) {
  if constexpr (DS == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(x1s) + row);
    a[0] = v.x;
    a[1] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < DS; ++k) a[k] = __ldg(x1s + (size_t)row * DS + k);
  }
}

// A thread's kVec columns' spatial coordinates, into registers: with VEC
// (all kVec columns present, 16-byte aligned) as DS 16-byte loads.
template <int DS, bool VEC>
__device__ __forceinline__ void load_cols(const float* __restrict__ x2s, int col, int ncols,
                                          float (&b)[kVec][DS]) {
  if constexpr (VEC) {
    float flat[kVec * DS];
    const float4* src = reinterpret_cast<const float4*>(x2s + (size_t)col * DS);
#pragma unroll
    for (int q = 0; q < DS; ++q) {
      const float4 v = __ldg(src + q);
      flat[4 * q] = v.x;
      flat[4 * q + 1] = v.y;
      flat[4 * q + 2] = v.z;
      flat[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j)
#pragma unroll
      for (int k = 0; k < DS; ++k) b[j][k] = flat[j * DS + k];
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
#pragma unroll
      for (int k = 0; k < DS; ++k)
        b[j][k] = j < ncols ? __ldg(x2s + (size_t)(col + j) * DS + k) : 0.0f;
  }
}

// One tile: kStrip columns × `rows` rows; tile t is strip t / row_tiles,
// row chunk t % row_tiles.  DS = 0: the spatial width `ds` is read at run
// time.  FK = kNone: no feature segment.  VEC: n2 % 4 == 0, so every row
// starts 16-byte aligned and a thread's 4 columns are all present or all
// absent.
template <int SK, int FK, int DS, bool VEC>
__device__ __forceinline__ void gram_tile(
    const float* __restrict__ x1s, const float* __restrict__ x2s,
    const float* __restrict__ x1f, const float* __restrict__ x2f, float s,
    float* __restrict__ out, int n1, int n2, int ds, int df, int rows, int row_tiles,
    int tile) {
  constexpr int D = DS > 0 ? DS : 1;  // register width (unused when DS = 0)
  const int strip = tile / row_tiles;
  const int row0 = (tile - strip * row_tiles) * rows;
  const long long first = (long long)strip * kStrip + threadIdx.x * kVec;
  if (first >= n2) return;
  const int col = static_cast<int>(first);
  const int ncols = min(kVec, n2 - col);
  const int row1 = min(n1, row0 + rows);

  float b[kVec][D];
  if constexpr (DS > 0) load_cols<DS, VEC>(x2s, col, ncols, b);

  float* o = out + (size_t)row0 * n2 + col;
  for (int row = row0; row < row1; ++row, o += n2) {
    float a[D];
    if constexpr (DS > 0) load_row<DS>(x1s, row, a);
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      // a column past n2 (only without VEC) computes column `col` again
      const size_t c = VEC || j < ncols ? col + j : col;
      float k;
      if constexpr (DS > 0) {
        k = stationary<SK>(sqdist_reg<DS>(a, b[j]));
      } else {
        k = stationary<SK>(sqdist_mem(x1s + (size_t)row * ds, x2s + c * ds, ds));
      }
      if constexpr (FK != kNone) {
        k = __fmul_rn(k, stationary<FK>(sqdist_mem(x1f + (size_t)row * df, x2f + c * df, df)));
      }
      v[j] = __fmul_rn(s, k);
    }
    if constexpr (VEC) {
      __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (j < ncols) __stcs(o + j, v[j]);
    }
  }
}

// Block b writes tile b.
template <int SK, int FK, int DS, bool VEC>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ x1s, const float* __restrict__ x2s,
            const float* __restrict__ x1f, const float* __restrict__ x2f,
            const float* __restrict__ scale, float* __restrict__ out,
            int n1, int n2, int ds, int df, int rows, int row_tiles) {
  gram_tile<SK, FK, DS, VEC>(x1s, x2s, x1f, x2f, __ldg(scale), out, n1, n2, ds, df, rows,
                             row_tiles, blockIdx.x);
}

template <int SK, int FK, int DS, bool VEC>
int launch(const float* x1s, const float* x2s, const float* x1f, const float* x2f,
           const float* scale, float* out, int n1, int n2, int ds, int df,
           cudaStream_t stream) {
  const int row_tiles = (n1 + kRows - 1) / kRows;
  const long long tiles = (long long)((n2 + kStrip - 1) / kStrip) * row_tiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  gram_kernel<SK, FK, DS, VEC><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, kRows, row_tiles);
  return algp_last_error();
}

// The spatial width as a template parameter where the kernel has one
// (spatial-only, every path's kernel); the composite reads it at run time.
template <int SK, int FK, bool VEC>
int launch_ds(const float* x1s, const float* x2s, const float* x1f, const float* x2f,
              const float* scale, float* out, int n1, int n2, int ds, int df,
              cudaStream_t st) {
  if constexpr (FK == kNone) {
    switch (ds) {
      case 1: return launch<SK, FK, 1, VEC>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st);
      case 2: return launch<SK, FK, 2, VEC>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st);
      case 3: return launch<SK, FK, 3, VEC>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st);
      default: break;
    }
  }
  return launch<SK, FK, 0, VEC>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st);
}

template <int SK, int FK>
int launch_vec(const float* x1s, const float* x2s, const float* x1f, const float* x2f,
               const float* scale, float* out, int n1, int n2, int ds, int df,
               cudaStream_t st) {
  // 16-byte rows need n2 % 4 == 0 and aligned bases (always so for
  // fresh PyTorch allocations)
  const bool vec = n2 % kVec == 0 && reinterpret_cast<size_t>(out) % 16 == 0 &&
                   reinterpret_cast<size_t>(x2s) % 16 == 0;
  return vec ? launch_ds<SK, FK, true>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st)
             : launch_ds<SK, FK, false>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st);
}

template <int SK>
int launch_fk(int fk, const float* x1s, const float* x2s, const float* x1f,
              const float* x2f, const float* scale, float* out, int n1, int n2,
              int ds, int df, cudaStream_t st) {
  switch (fk) {
    case kRbf: return launch_vec<SK, kRbf>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st);
    case kMatern32: return launch_vec<SK, kMatern32>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st);
    case kMatern52: return launch_vec<SK, kMatern52>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st);
    case kNone: return launch_vec<SK, kNone>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// sk, fk: 0 rbf, 1 matern32, 2 matern52; fk = -1 for a spatial-only kernel
// (x1f, x2f may then be null and df is ignored).  Returns cudaGetLastError.
ALGP_EXPORT int algp_gram(const float* x1s, const float* x2s, const float* x1f,
                          const float* x2f, const float* scale, float* out,
                          int n1, int n2, int ds, int df, int sk, int fk,
                          void* stream) {
  if (n1 < 1 || n2 < 1 || ds < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sk) {
    case kRbf: return launch_fk<kRbf>(fk, x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st);
    case kMatern32: return launch_fk<kMatern32>(fk, x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st);
    case kMatern52: return launch_fk<kMatern52>(fk, x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

ALGP_EXPORT const char* algp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
