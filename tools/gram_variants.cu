// Design variants of the Gram kernel (algp_tpu_torch/csrc/gram.cu), for
// tools/gram_profile.py and chip_smoke.py only: the library never runs
// them.  `gram_variant` computes the spatial-only Gram of the kernel with
// the same arithmetic, so its output is compared with the kernel's bit for
// bit:
//
//   0  the kernel itself (`gram_kernel`) at a chosen tile height
//   1  the earlier shared-tile design: 64 × 32 tiles staged in shared
//      memory behind a barrier, 8 rows a thread, 4-byte stores, a
//      runtime width
//   2  the kernel's tiles drained by TMA bulk stores
//      (cp.async.bulk.global.shared::cta), double-buffered in shared memory
//   3  the kernel's arithmetic with no store (instruction issue alone)
//   4  the kernel's stores of a row coordinate (the write stream alone)
//   5  the kernel's tiles on a persistent grid of `grid` blocks, each
//      walking tiles b, b + grid, ...
//
// `gram_composite_variant` computes the composite Gram (Matérn 5/2 × RBF,
// the feature paths' kernel):
//
//   0  the kernel itself (`composite_kernel`) at a chosen tile height, on
//      unscaled rows and the inverse lengthscales (ds = 2, df ∈ {1, 3, 4})
//   1  the earlier composite design: the spatial kernel's tiles with both
//      widths read at run time and every coordinate of both points read
//      from global memory per output, on segments the caller has scaled

#include "../algp_tpu_torch/csrc/gram.cuh"

namespace {

// ---- 1: the shared-tile design ------------------------------------------
constexpr int kSharedCols = 32, kSharedRowThreads = 8, kSharedRowsPerThread = 8;
constexpr int kSharedRows = kSharedRowThreads * kSharedRowsPerThread;

__device__ __forceinline__ float shared_tile_sqdist(const float* a, const float* b, int d, int stride) {
  float acc = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float diff = __fsub_rn(a[k], b[k * stride]);
    acc = __fadd_rn(acc, __fmul_rn(diff, diff));
  }
  return acc;
}

template <int SK>
__global__ void __launch_bounds__(kSharedCols * kSharedRowThreads)
shared_tile_kernel(const float* __restrict__ x1s, const float* __restrict__ x2s,
           const float* __restrict__ scale, float* __restrict__ out, int n1, int n2, int ds) {
  extern __shared__ float smem[];
  float* s1s = smem;
  float* s2s = s1s + kSharedRows * ds;
  const int row0 = blockIdx.y * kSharedRows;
  const int col0 = blockIdx.x * kSharedCols;
  const int tid = threadIdx.y * kSharedCols + threadIdx.x;
  const int nthreads = kSharedCols * kSharedRowThreads;
  for (int t = tid; t < kSharedRows * ds; t += nthreads) {
    const int r = t / ds, k = t % ds;
    s1s[t] = (row0 + r < n1) ? x1s[(size_t)(row0 + r) * ds + k] : 0.0f;
  }
  for (int t = tid; t < kSharedCols * ds; t += nthreads) {
    const int c = t / ds, k = t % ds;
    s2s[k * kSharedCols + c] = (col0 + c < n2) ? x2s[(size_t)(col0 + c) * ds + k] : 0.0f;
  }
  __syncthreads();
  const int c = threadIdx.x;
  const int col = col0 + c;
  if (col >= n2) return;
  const float s = scale[0];
#pragma unroll
  for (int q = 0; q < kSharedRowsPerThread; ++q) {
    const int r = threadIdx.y + q * kSharedRowThreads;
    const int row = row0 + r;
    if (row >= n1) break;
    const float k = stationary<SK>(shared_tile_sqdist(s1s + r * ds, s2s + c, ds, kSharedCols));
    out[(size_t)row * n2 + col] = __fmul_rn(s, k);
  }
}

// ---- 2: TMA bulk stores -----------------------------------------------------
constexpr int kStage = 4;  // rows a shared-memory stage holds (16 KB)

template <int SK, int DS>
__global__ void __launch_bounds__(kThreads)
tma_kernel(const float* __restrict__ x1s, const float* __restrict__ x2s,
           const float* __restrict__ scale, float* __restrict__ out, int n1, int n2,
           int rows, int row_tiles) {
  __shared__ __align__(128) float buf[2][kStage][kStrip];
  const int strip = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x - strip * row_tiles) * rows;
  const int row1 = min(n1, row0 + rows);
  const int col0 = strip * kStrip;
  const int col = col0 + threadIdx.x * kVec;
  const bool active = col < n2;
  const unsigned bytes = static_cast<unsigned>(min(kStrip, n2 - col0)) * 4u;
  const float s = __ldg(scale);
  float b[kVec][DS];
  if (active) load_cols<DS, true>(x2s, col, kVec, b);
  int stage = 0;
  for (int r = row0; r < row1; r += kStage, ++stage) {
    const int nb = stage & 1;
    // the bulk group that read this buffer two stages ago is done reading
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    __syncthreads();
    if (active) {
      for (int q = 0; q < kStage && r + q < row1; ++q) {
        float a[DS];
        load_row<DS>(x1s, r + q, a);
        float v[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[j] = __fmul_rn(s, stationary<SK>(sqdist_reg<0, DS>(a, b[j])));
        *reinterpret_cast<float4*>(&buf[nb][q][threadIdx.x * kVec]) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int q = 0; q < kStage && r + q < row1; ++q) {
        float* dst = out + (size_t)(r + q) * n2 + col0;
        const unsigned src = static_cast<unsigned>(__cvta_generic_to_shared(&buf[nb][q][0]));
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                     :: "l"(dst), "r"(src), "r"(bytes) : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---- 3 and 4: the arithmetic alone, the stores alone -------------------------
template <int SK, int DS, bool STORE_ONLY>
__global__ void __launch_bounds__(kThreads)
half_kernel(const float* __restrict__ x1s, const float* __restrict__ x2s,
            const float* __restrict__ scale, float* __restrict__ out, int n1, int n2,
            int rows, int row_tiles) {
  const int strip = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x - strip * row_tiles) * rows;
  const int col = strip * kStrip + threadIdx.x * kVec;
  if (col >= n2) return;
  const int row1 = min(n1, row0 + rows);
  const float s = __ldg(scale);
  float b[kVec][DS];
  load_cols<DS, true>(x2s, col, kVec, b);
  float* o = out + (size_t)row0 * n2 + col;
  for (int row = row0; row < row1; ++row, o += n2) {
    float a[DS];
    load_row<DS>(x1s, row, a);
    if constexpr (STORE_ONLY) {
      __stcs(reinterpret_cast<float4*>(o), make_float4(a[0], a[0], a[0], a[0]));
    } else {
      float v[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = __fmul_rn(s, stationary<SK>(sqdist_reg<0, DS>(a, b[j])));
      // every value feeds the test, which never holds (outputs are >= 0)
      if ((__float_as_uint(v[0]) & __float_as_uint(v[1]) & __float_as_uint(v[2]) &
           __float_as_uint(v[3])) == 0xffffffffu)
        out[0] = v[0];
    }
  }
}

// ---- 5: a persistent grid ----------------------------------------------------
template <int SK>
__global__ void __launch_bounds__(kThreads)
persistent_kernel(const float* __restrict__ x1s, const float* __restrict__ x2s,
                  const float* __restrict__ scale, float* __restrict__ out, int n1, int n2,
                  int rows, int row_tiles, int tiles) {
  const float s = __ldg(scale);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    gram_tile<SK, 2, true>(x1s, x2s, s, out, n1, n2, 2, rows, row_tiles, t);
}

template <int SK>
int launch_variant(int variant, const float* x1s, const float* x2s, const float* scale,
                   float* out, int n1, int n2, int ds, int rows, int grid, cudaStream_t st) {
  if (variant == 1) {
    const dim3 block(kSharedCols, kSharedRowThreads);
    const dim3 g((n2 + kSharedCols - 1) / kSharedCols, (n1 + kSharedRows - 1) / kSharedRows);
    shared_tile_kernel<SK><<<g, block, sizeof(float) * (kSharedRows + kSharedCols) * ds, st>>>(
        x1s, x2s, scale, out, n1, n2, ds);
    return algp_last_error();
  }
  // the rest take ds = 2 and n2 % 4 == 0 (the paths' shapes)
  if (ds != 2 || n2 % kVec || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (n1 + rows - 1) / rows;
  const int tiles = ((n2 + kStrip - 1) / kStrip) * row_tiles;
  if (variant == 0)
    return launch_spatial<SK, 2, true>(x1s, x2s, scale, out, n1, n2, 2, rows, st);
  if (variant == 2)
    tma_kernel<SK, 2><<<tiles, kThreads, 0, st>>>(x1s, x2s, scale, out, n1, n2, rows, row_tiles);
  else if (variant == 3)
    half_kernel<SK, 2, false><<<tiles, kThreads, 0, st>>>(x1s, x2s, scale, out, n1, n2, rows,
                                                          row_tiles);
  else if (variant == 4)
    half_kernel<SK, 2, true><<<tiles, kThreads, 0, st>>>(x1s, x2s, scale, out, n1, n2, rows,
                                                         row_tiles);
  else if (variant == 5)
    persistent_kernel<SK><<<min(grid, tiles), kThreads, 0, st>>>(x1s, x2s, scale, out, n1, n2,
                                                                 rows, row_tiles, tiles);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return algp_last_error();
}

// ---- the earlier composite design --------------------------------------------

// gram_tile's tiles and stores with both widths read at run time: every
// output reads all ds + df coordinates of its row and its column from
// global memory (L1-resident) in two runtime loops, on segments scaled by
// the caller (x1s, x2s: (n, ds); x1f, x2f: (n, df)).
template <int SK, int FK, bool VEC>
__global__ void __launch_bounds__(kThreads)
old_composite_kernel(const float* __restrict__ x1s, const float* __restrict__ x2s,
                     const float* __restrict__ x1f, const float* __restrict__ x2f,
                     const float* __restrict__ scale, float* __restrict__ out, int n1, int n2,
                     int ds, int df, int rows, int row_tiles) {
  const float s = __ldg(scale);
  const int strip = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x - strip * row_tiles) * rows;
  const long long first = (long long)strip * kStrip + threadIdx.x * kVec;
  if (first >= n2) return;
  const int col = static_cast<int>(first);
  const int ncols = min(kVec, n2 - col);
  const int row1 = min(n1, row0 + rows);
  float* o = out + (size_t)row0 * n2 + col;
  for (int row = row0; row < row1; ++row, o += n2) {
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const size_t c = VEC || j < ncols ? col + j : col;
      const float k = stationary<SK>(sqdist_mem(x1s + (size_t)row * ds, x2s + c * ds, ds));
      v[j] = __fmul_rn(s, __fmul_rn(k, stationary<FK>(sqdist_mem(x1f + (size_t)row * df,
                                                                  x2f + c * df, df))));
    }
    store_row<VEC>(o, v, ncols);
  }
}

}  // namespace

// The composite Gram, Matérn 5/2 × RBF, by design variant (see the top of
// this file).  Variant 0: x1, x2 unscaled (n, 2 + df) rows, `inv` their
// 2 + df inverse lengthscales, df ∈ {1, 3, 4}, n2 % 4 == 0, 1 ≤ rows ≤ 32.
// Variant 1: x1, x2 the scaled spatial segments (n, ds) and x1f, x2f the
// scaled feature ones (n, df), the kernel's 8 rows.  Returns
// cudaGetLastError.
ALGP_EXPORT int gram_composite_variant(int variant, const float* x1, const float* x2,
                                       const float* x1f, const float* x2f, const float* inv,
                                       const float* scale, float* out, int n1, int n2, int ds,
                                       int df, int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n1 < 1 || n2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 1) {
    int row_tiles;
    const long long tiles = tile_count(n1, n2, kRows, &row_tiles);
    if (tiles < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (rows_vectorisable(n2, out, x2))
      old_composite_kernel<kMatern52, kRbf, true><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
          x1, x2, x1f, x2f, scale, out, n1, n2, ds, df, kRows, row_tiles);
    else
      old_composite_kernel<kMatern52, kRbf, false><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
          x1, x2, x1f, x2f, scale, out, n1, n2, ds, df, kRows, row_tiles);
    return algp_last_error();
  }
  if (variant != 0 || ds != 2 || !rows_vectorisable(n2, out, x2))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (df) {
    case 1: return launch_composite<kMatern52, kRbf, 2, 1, true>(x1, x2, inv, scale, out, n1, n2, ds, df, rows, st);
    case 3: return launch_composite<kMatern52, kRbf, 2, 3, true>(x1, x2, inv, scale, out, n1, n2, ds, df, rows, st);
    case 4: return launch_composite<kMatern52, kRbf, 2, 4, true>(x1, x2, inv, scale, out, n1, n2, ds, df, rows, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The spatial-only Gram by design variant (see the top of this file);
// sk 0 rbf, 1 matern32, 2 matern52.  Returns cudaGetLastError.
ALGP_EXPORT int gram_variant(int variant, const float* x1s, const float* x2s,
                             const float* scale, float* out, int n1, int n2, int ds, int sk,
                             int rows, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sk) {
    case kRbf: return launch_variant<kRbf>(variant, x1s, x2s, scale, out, n1, n2, ds, rows, grid, st);
    case kMatern32: return launch_variant<kMatern32>(variant, x1s, x2s, scale, out, n1, n2, ds, rows, grid, st);
    case kMatern52: return launch_variant<kMatern52>(variant, x1s, x2s, scale, out, n1, n2, ds, rows, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
