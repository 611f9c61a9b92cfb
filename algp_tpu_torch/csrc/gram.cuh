// Device templates of the Gram kernel (csrc/gram.cu): the spatial-only
// kernel `gram_kernel` and the composite `composite_kernel`, with their
// launch templates.  Nothing is instantiated here: gram.cu and the
// gram_composite_*.cu sources instantiate what the library exports,
// tools/gram_variants.cu what it times.

#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;                // threads in a block
constexpr int kVec = 4;                      // adjacent columns a thread owns
constexpr int kStrip = kThreads * kVec;      // columns a block owns
constexpr int kRows = 8;                     // rows of a tile
constexpr int kCompositeRows = 16;           // rows of a composite tile
constexpr int kMaxRows = 32;                 // tallest composite tile (its staging buffer)
constexpr int kFeatBucket = 8;               // the feature width that serves df = 5..8

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

// Σ_{K0 ≤ k < K1} (a[k] − b[k])² over registers, in coordinate order, no
// FMA contraction.  The sum starts at the first square: the plain
// version's 0 + t is t for every t ≥ +0.
template <int K0, int K1, int NA, int NB>
__device__ __forceinline__ float sqdist_reg(const float (&a)[NA], const float (&b)[NB]) {
  static_assert(0 <= K0 && K0 < K1 && K1 <= NA && K1 <= NB, "coordinate range");
  float diff = __fsub_rn(a[K0], b[K0]);
  float acc = __fmul_rn(diff, diff);
#pragma unroll
  for (int k = K0 + 1; k < K1; ++k) {
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

// ---- the spatial-only kernel ------------------------------------------------

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

// kVec · D contiguous floats from a 16-byte aligned address: D 16-byte loads.
template <int D>
__device__ __forceinline__ void load_flat(const float* __restrict__ src,
                                          float (&flat)[kVec * D]) {
#pragma unroll
  for (int q = 0; q < D; ++q) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src) + q);
    flat[4 * q] = v.x;
    flat[4 * q + 1] = v.y;
    flat[4 * q + 2] = v.z;
    flat[4 * q + 3] = v.w;
  }
}

// A thread's kVec columns' spatial coordinates, into registers: with VEC
// (all kVec columns present, 16-byte aligned) as DS 16-byte loads.
template <int DS, bool VEC>
__device__ __forceinline__ void load_cols(const float* __restrict__ x2s, int col, int ncols,
                                          float (&b)[kVec][DS]) {
  if constexpr (VEC) {
    float flat[kVec * DS];
    load_flat<DS>(x2s + (size_t)col * DS, flat);
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

// A thread's kVec outputs of one row: one 16-byte streaming store with
// VEC, else one 4-byte store per present column.
template <bool VEC>
__device__ __forceinline__ void store_row(float* __restrict__ o, const float (&v)[kVec],
                                          int ncols) {
  if constexpr (VEC) {
    __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (j < ncols) __stcs(o + j, v[j]);
  }
}

// One tile: kStrip columns × `rows` rows; tile t is strip t / row_tiles,
// row chunk t % row_tiles.  Inputs scaled by the wrapper.  DS = 0: the
// spatial width `ds` is read at run time.  VEC: n2 % 4 == 0, so every row
// starts 16-byte aligned and a thread's 4 columns are all present or all
// absent.
template <int SK, int DS, bool VEC>
__device__ __forceinline__ void gram_tile(
    const float* __restrict__ x1s, const float* __restrict__ x2s, float s,
    float* __restrict__ out, int n1, int n2, int ds, int rows, int row_tiles, int tile) {
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
        k = stationary<SK>(sqdist_reg<0, DS>(a, b[j]));
      } else {
        k = stationary<SK>(sqdist_mem(x1s + (size_t)row * ds, x2s + c * ds, ds));
      }
      v[j] = __fmul_rn(s, k);
    }
    store_row<VEC>(o, v, ncols);
  }
}

// Block b writes tile b.
template <int SK, int DS, bool VEC>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ x1s, const float* __restrict__ x2s,
            const float* __restrict__ scale, float* __restrict__ out,
            int n1, int n2, int ds, int rows, int row_tiles) {
  gram_tile<SK, DS, VEC>(x1s, x2s, __ldg(scale), out, n1, n2, ds, rows, row_tiles, blockIdx.x);
}

// ---- the composite kernel ---------------------------------------------------

// A thread's kVec points, scaled, into registers: D coordinates each
// (zero past the point's own d).  With VEC (all kVec points present,
// exactly D coordinates each, 16-byte aligned) as D 16-byte loads.
template <int D, bool VEC>
__device__ __forceinline__ void load_points(const float* __restrict__ x2,
                                            const float* __restrict__ inv, int col, int ncols,
                                            int d, float (&b)[kVec][D]) {
  float w[D];
#pragma unroll
  for (int k = 0; k < D; ++k) w[k] = k < d ? __ldg(inv + k) : 0.0f;
  if constexpr (VEC) {
    float flat[kVec * D];
    load_flat<D>(x2 + (size_t)col * D, flat);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
#pragma unroll
      for (int k = 0; k < D; ++k) b[j][k] = __fmul_rn(flat[j * D + k], w[k]);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      // a point past n2 takes point `col` again
      const size_t c = j < ncols ? col + j : col;
#pragma unroll
      for (int k = 0; k < D; ++k) b[j][k] = k < d ? __fmul_rn(__ldg(x2 + c * d + k), w[k]) : 0.0f;
    }
  }
}

// One composite tile, both widths compile-time: DS spatial coordinates,
// then DF feature ones (DF = kFeatBucket serves df = 5..8, its tail zero
// on both sides, which adds exact zeros to r²).  x1, x2 are unscaled rows
// of d = ds + df; the block first stages its rows, scaled, in shared
// memory, padded to whole float4s, and the row loop reads a row from there
// with P / 4 loads that every lane shares: no global load per output.
template <int SK, int FK, int DS, int DF, bool VEC>
__device__ __forceinline__ void composite_tile(
    const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ inv,
    float s, float* __restrict__ out, int n1, int n2, int df, int rows, int row_tiles,
    int tile) {
  constexpr int D = DS + DF;          // register width of a point
  constexpr int P = (D + 3) / 4 * 4;  // staged width of a row
  __shared__ __align__(16) float staged[kMaxRows * P];
  const int d = DF == kFeatBucket ? DS + df : D;  // coordinates a point has
  const int strip = tile / row_tiles;
  const int row0 = (tile - strip * row_tiles) * rows;
  const int nrows = min(n1 - row0, rows);
  for (int t = threadIdx.x; t < nrows * P; t += kThreads) {
    const int r = t / P, k = t - r * P;
    staged[t] = k < d ? __fmul_rn(__ldg(x1 + (size_t)(row0 + r) * d + k), __ldg(inv + k)) : 0.0f;
  }
  __syncthreads();
  const long long first = (long long)strip * kStrip + threadIdx.x * kVec;
  if (first >= n2) return;
  const int col = static_cast<int>(first);
  const int ncols = min(kVec, n2 - col);

  float b[kVec][D];
  load_points<D, VEC && DF != kFeatBucket>(x2, inv, col, ncols, d, b);

  const float4* srow = reinterpret_cast<const float4*>(staged);
  float* o = out + (size_t)row0 * n2 + col;
  for (int r = 0; r < nrows; ++r, o += n2) {
    float a[P];
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const float4 v = srow[r * (P / 4) + q];
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float ks = stationary<SK>(sqdist_reg<0, DS>(a, b[j]));
      const float kf = stationary<FK>(sqdist_reg<DS, D>(a, b[j]));
      v[j] = __fmul_rn(s, __fmul_rn(ks, kf));
    }
    store_row<VEC>(o, v, ncols);
  }
}

// Σ_{k0 ≤ k < k1} (a[k]·w[k] − b[k]·w[k])², read from global memory.
__device__ __forceinline__ float sqdist_scaled_mem(const float* __restrict__ a,
                                                   const float* __restrict__ b,
                                                   const float* __restrict__ w, int k0,
                                                   int k1) {
  float acc = 0.0f;
  for (int k = k0; k < k1; ++k) {
    const float wk = __ldg(w + k);
    const float diff = __fsub_rn(__fmul_rn(__ldg(a + k), wk), __fmul_rn(__ldg(b + k), wk));
    acc = __fadd_rn(acc, __fmul_rn(diff, diff));
  }
  return acc;
}

// One composite tile at widths only known at run time (ds > 3 or
// df > 8): every output reads and scales its coordinates from global
// memory, with 4-byte stores.  Correct, not fast: no path runs it.
template <int SK, int FK>
__device__ __forceinline__ void composite_tile_any(
    const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ inv,
    float s, float* __restrict__ out, int n1, int n2, int ds, int df, int rows, int row_tiles,
    int tile) {
  const int d = ds + df;
  const int strip = tile / row_tiles;
  const int row0 = (tile - strip * row_tiles) * rows;
  const long long first = (long long)strip * kStrip + threadIdx.x * kVec;
  if (first >= n2) return;
  const int col = static_cast<int>(first);
  const int ncols = min(kVec, n2 - col);
  const int row1 = min(n1, row0 + rows);
  float* o = out + (size_t)row0 * n2 + col;
  for (int row = row0; row < row1; ++row, o += n2) {
    const float* a = x1 + (size_t)row * d;
    for (int j = 0; j < ncols; ++j) {
      const float* b = x2 + (size_t)(col + j) * d;
      const float ks = stationary<SK>(sqdist_scaled_mem(a, b, inv, 0, ds));
      const float kf = stationary<FK>(sqdist_scaled_mem(a, b, inv, ds, d));
      __stcs(o + j, __fmul_rn(s, __fmul_rn(ks, kf)));
    }
  }
}

// Block b writes tile b.  DS = 0 (with DF = 0): the runtime widths.
template <int SK, int FK, int DS, int DF, bool VEC>
__global__ void __launch_bounds__(kThreads)
composite_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                 const float* __restrict__ inv, const float* __restrict__ scale,
                 float* __restrict__ out, int n1, int n2, int ds, int df, int rows,
                 int row_tiles) {
  if constexpr (DS == 0) {
    composite_tile_any<SK, FK>(x1, x2, inv, __ldg(scale), out, n1, n2, ds, df, rows,
                               row_tiles, blockIdx.x);
  } else {
    composite_tile<SK, FK, DS, DF, VEC>(x1, x2, inv, __ldg(scale), out, n1, n2, df, rows,
                                        row_tiles, blockIdx.x);
  }
}

// ---- launches ----------------------------------------------------------------

// Tiles of `rows` rows over n1 × n2, or -1 when the grid is too large.
inline long long tile_count(int n1, int n2, int rows, int* row_tiles) {
  *row_tiles = (n1 + rows - 1) / rows;
  const long long tiles = (long long)((n2 + kStrip - 1) / kStrip) * *row_tiles;
  return tiles > 0x7fffffffLL ? -1 : tiles;
}

template <int SK, int DS, bool VEC>
int launch_spatial(const float* x1s, const float* x2s, const float* scale, float* out, int n1,
                   int n2, int ds, int rows, cudaStream_t st) {
  int row_tiles;
  const long long tiles = tile_count(n1, n2, rows, &row_tiles);
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  gram_kernel<SK, DS, VEC><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      x1s, x2s, scale, out, n1, n2, ds, rows, row_tiles);
  return algp_last_error();
}

template <int SK, int FK, int DS, int DF, bool VEC>
int launch_composite(const float* x1, const float* x2, const float* inv, const float* scale,
                     float* out, int n1, int n2, int ds, int df, int rows, cudaStream_t st) {
  if (DS > 0 && (rows < 1 || rows > kMaxRows))
    return static_cast<int>(cudaErrorInvalidValue);
  int row_tiles;
  const long long tiles = tile_count(n1, n2, rows, &row_tiles);
  if (tiles < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  composite_kernel<SK, FK, DS, DF, VEC><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      x1, x2, inv, scale, out, n1, n2, ds, df, rows, row_tiles);
  return algp_last_error();
}

// 16-byte rows need n2 % 4 == 0 and aligned bases (always so for fresh
// PyTorch allocations).
inline bool rows_vectorisable(int n2, const float* out, const float* x2) {
  return n2 % kVec == 0 && reinterpret_cast<size_t>(out) % 16 == 0 &&
         reinterpret_cast<size_t>(x2) % 16 == 0;
}

// The composite's widths as template parameters: the feature width exact
// up to 4, the 8-wide bucket up to 8; past those, or past a spatial width
// of 3, the runtime widths.
template <int SK, int FK, int DS, bool VEC>
int launch_df(const float* x1, const float* x2, const float* inv, const float* scale,
              float* out, int n1, int n2, int ds, int df, cudaStream_t st) {
#define ALGP_COMPOSITE(DF_)                                                     \
  launch_composite<SK, FK, DS, DF_, VEC>(x1, x2, inv, scale, out, n1, n2, ds, df, \
                                         kCompositeRows, st)
  switch (df) {
    case 1: return ALGP_COMPOSITE(1);
    case 2: return ALGP_COMPOSITE(2);
    case 3: return ALGP_COMPOSITE(3);
    case 4: return ALGP_COMPOSITE(4);
    case 5: case 6: case 7: case 8: return ALGP_COMPOSITE(kFeatBucket);
    default: break;
  }
#undef ALGP_COMPOSITE
  return launch_composite<SK, FK, 0, 0, false>(x1, x2, inv, scale, out, n1, n2, ds, df,
                                               kCompositeRows, st);
}

template <int SK, int FK, bool VEC>
int launch_ds(const float* x1, const float* x2, const float* inv, const float* scale,
              float* out, int n1, int n2, int ds, int df, cudaStream_t st) {
  switch (ds) {
    case 1: return launch_df<SK, FK, 1, VEC>(x1, x2, inv, scale, out, n1, n2, ds, df, st);
    case 2: return launch_df<SK, FK, 2, VEC>(x1, x2, inv, scale, out, n1, n2, ds, df, st);
    case 3: return launch_df<SK, FK, 3, VEC>(x1, x2, inv, scale, out, n1, n2, ds, df, st);
    default:
      return launch_composite<SK, FK, 0, 0, false>(x1, x2, inv, scale, out, n1, n2, ds, df,
                                                   kCompositeRows, st);
  }
}

template <int SK, int FK>
int launch_vec(const float* x1, const float* x2, const float* inv, const float* scale,
               float* out, int n1, int n2, int ds, int df, cudaStream_t st) {
  return rows_vectorisable(n2, out, x2)
             ? launch_ds<SK, FK, true>(x1, x2, inv, scale, out, n1, n2, ds, df, st)
             : launch_ds<SK, FK, false>(x1, x2, inv, scale, out, n1, n2, ds, df, st);
}

// Every composite instance of one spatial kind SK, by feature kind.
template <int SK>
int launch_composite_fk(int fk, const float* x1, const float* x2, const float* inv,
                        const float* scale, float* out, int n1, int n2, int ds, int df,
                        cudaStream_t st) {
  switch (fk) {
    case kRbf: return launch_vec<SK, kRbf>(x1, x2, inv, scale, out, n1, n2, ds, df, st);
    case kMatern32: return launch_vec<SK, kMatern32>(x1, x2, inv, scale, out, n1, n2, ds, df, st);
    case kMatern52: return launch_vec<SK, kMatern52>(x1, x2, inv, scale, out, n1, n2, ds, df, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The composite launch of one spatial kind, from its own source
// (gram_composite_<kind>.cu), so that nvcc builds the kinds' instances in
// parallel; gram.cu dispatches to them.
#define ALGP_COMPOSITE_LAUNCH(NAME)                                                        \
  extern "C" __attribute__((visibility("hidden"))) int NAME(                              \
      int fk, const float* x1, const float* x2, const float* inv, const float* scale,     \
      float* out, int n1, int n2, int ds, int df, cudaStream_t st)

ALGP_COMPOSITE_LAUNCH(algp_gram_composite_rbf);
ALGP_COMPOSITE_LAUNCH(algp_gram_composite_matern32);
ALGP_COMPOSITE_LAUNCH(algp_gram_composite_matern52);
