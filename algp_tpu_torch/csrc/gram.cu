// Gram matrix K(X1, X2) = s² · k_sp(r²_sp) · k_ft(r²_ft), f32, straight to
// device memory.
//
// Replaces: algp_tpu/ops/gram.py `_gram_kernel_spatial` and
// `_gram_kernel_composite` (the Pallas bodies behind `gram_pallas`), one
// template for both.
//
// Bound: writes.  The output is n1·n2·4 bytes (10 240² → 419 MB) and the
// inputs are a few coordinates per row, so the kernel is a write-bound
// pass; the arithmetic (a handful of flops and one expf per element) is
// far below the card's rate.
//
// Design: a block writes a 64-row × 32-column tile.  Thread x owns one
// column (so a warp stores 128 contiguous bytes of a row) and walks 8
// rows.  The tile's coordinates are staged in shared memory once: the
// X1 rows row-major (one row is read by the whole warp: a broadcast), the
// X2 columns coordinate-major (conflict-free).  Any n1, n2: the edges are
// masked, nothing is padded.
//
// Numerics mirror the plain PyTorch version (ops/kernels.gram): the
// inputs arrive already scaled by exp(-log_ls), r² is the direct
// difference sum Σ_k (a_k − b_k)² in coordinate order, the closed forms
// are those of `stationary_form` (Matérn takes √max(r², 1e-20)), and the
// composite is s · (k_sp · k_ft).  The `_rn` intrinsics keep nvcc from
// contracting these into FMAs; expf/sqrtf are IEEE (no fast math).

#include "common.cuh"

namespace {

constexpr int kCols = 32;          // columns per tile (= threads in x)
constexpr int kRowThreads = 8;     // threads in y
constexpr int kRowsPerThread = 8;  // rows each thread computes
constexpr int kRows = kRowThreads * kRowsPerThread;

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

// Σ_k (a[k] − b[k·stride])², in coordinate order, no FMA contraction.
__device__ __forceinline__ float sqdist(const float* a, const float* b, int d, int stride) {
  float acc = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float diff = __fsub_rn(a[k], b[k * stride]);
    acc = __fadd_rn(acc, __fmul_rn(diff, diff));
  }
  return acc;
}

template <int SK, int FK>
__global__ void __launch_bounds__(kCols * kRowThreads)
gram_kernel(const float* __restrict__ x1s, const float* __restrict__ x2s,
            const float* __restrict__ x1f, const float* __restrict__ x2f,
            const float* __restrict__ scale, float* __restrict__ out,
            int n1, int n2, int ds, int df) {
  extern __shared__ float smem[];
  float* s1s = smem;                  // [kRows][ds]  X1 spatial, row-major
  float* s2s = s1s + kRows * ds;      // [ds][kCols]  X2 spatial, coord-major
  float* s1f = s2s + kCols * ds;      // [kRows][df]
  float* s2f = s1f + kRows * df;      // [df][kCols]

  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols;
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int nthreads = kCols * kRowThreads;

  for (int t = tid; t < kRows * ds; t += nthreads) {
    const int r = t / ds, k = t % ds;
    s1s[t] = (row0 + r < n1) ? x1s[(size_t)(row0 + r) * ds + k] : 0.0f;
  }
  for (int t = tid; t < kCols * ds; t += nthreads) {
    const int c = t / ds, k = t % ds;
    s2s[k * kCols + c] = (col0 + c < n2) ? x2s[(size_t)(col0 + c) * ds + k] : 0.0f;
  }
  if constexpr (FK != kNone) {
    for (int t = tid; t < kRows * df; t += nthreads) {
      const int r = t / df, k = t % df;
      s1f[t] = (row0 + r < n1) ? x1f[(size_t)(row0 + r) * df + k] : 0.0f;
    }
    for (int t = tid; t < kCols * df; t += nthreads) {
      const int c = t / df, k = t % df;
      s2f[k * kCols + c] = (col0 + c < n2) ? x2f[(size_t)(col0 + c) * df + k] : 0.0f;
    }
  }
  __syncthreads();

  const int c = threadIdx.x;
  const int col = col0 + c;
  if (col >= n2) return;
  const float s = scale[0];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int r = threadIdx.y + q * kRowThreads;
    const int row = row0 + r;
    if (row >= n1) break;
    float k = stationary<SK>(sqdist(s1s + r * ds, s2s + c, ds, kCols));
    if constexpr (FK != kNone) {
      k = __fmul_rn(k, stationary<FK>(sqdist(s1f + r * df, s2f + c, df, kCols)));
    }
    out[(size_t)row * n2 + col] = __fmul_rn(s, k);
  }
}

template <int SK, int FK>
void launch(const float* x1s, const float* x2s, const float* x1f, const float* x2f,
            const float* scale, float* out, int n1, int n2, int ds, int df,
            cudaStream_t stream) {
  const dim3 block(kCols, kRowThreads);
  const dim3 grid((n2 + kCols - 1) / kCols, (n1 + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * (kRows + kCols) * (ds + (FK != kNone ? df : 0));
  gram_kernel<SK, FK><<<grid, block, smem, stream>>>(x1s, x2s, x1f, x2f, scale, out,
                                                     n1, n2, ds, df);
}

template <int SK>
void launch_fk(int fk, const float* x1s, const float* x2s, const float* x1f,
               const float* x2f, const float* scale, float* out, int n1, int n2,
               int ds, int df, cudaStream_t stream) {
  switch (fk) {
    case kRbf: launch<SK, kRbf>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, stream); break;
    case kMatern32: launch<SK, kMatern32>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, stream); break;
    case kMatern52: launch<SK, kMatern52>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, stream); break;
    default: launch<SK, kNone>(x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, stream); break;
  }
}

}  // namespace

// sk, fk: 0 rbf, 1 matern32, 2 matern52; fk = -1 for a spatial-only kernel
// (x1f, x2f may then be null and df is ignored).  Returns cudaGetLastError.
ALGP_EXPORT int algp_gram(const float* x1s, const float* x2s, const float* x1f,
                          const float* x2f, const float* scale, float* out,
                          int n1, int n2, int ds, int df, int sk, int fk,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sk) {
    case kRbf: launch_fk<kRbf>(fk, x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st); break;
    case kMatern32: launch_fk<kMatern32>(fk, x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st); break;
    case kMatern52: launch_fk<kMatern52>(fk, x1s, x2s, x1f, x2f, scale, out, n1, n2, ds, df, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return algp_last_error();
}

ALGP_EXPORT const char* algp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
