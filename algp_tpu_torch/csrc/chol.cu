// Blocked right-looking Cholesky factorization, in place: tril(L) with
// L Lᵀ = K for a symmetric positive-definite K (n × n, row-major f32).
//
// Replaces: algp_tpu/ops/pallas_chol.py `_chol_kernel` (`cholesky_pallas`)
// and `_chol_kernel_la` (`cholesky_pallas_la`).  The two compute the same
// factor; the lookahead variant only works around Mosaic's in-order issue
// on the TPU, so one kernel covers both.
//
// Bound: arithmetic.  n³/3 flops against 2 · 4 · n² bytes (each entry read
// and written once): at n = 10 000, 3.3e11 flops ≈ 5 ms at the card's
// 67 TFLOP/s of FP32 outside the tensor cores, against 0.24 ms of memory
// traffic.  FP32 FMA throughout: no TF32 and no tensor cores, because the
// selection-fidelity contract forbids reduced-precision products.
//
// Design, per 64-wide panel k (three launches, as the TPU kernel's three
// phases; the host loop over panels replaces its sequential grid):
//   1. chol_diag  — one block factors the diagonal block A_kk in shared
//      memory (column by column, right-looking) and forms W = L_kk⁻¹ by
//      forward substitution, so the panel solve is a product, as the TPU
//      kernel does; W goes to a 64 × 64 scratch buffer.
//   2. chol_panel — one block per row tile i > k: L_ik = A_ik · Wᵀ, and the
//      mirror tile (k, i) of the upper triangle is zeroed.
//   3. chol_trail — one block per lower tile (i, j), k < j ≤ i:
//      A_ij −= L_ik L_jkᵀ from two transposed 64 × 64 shared-memory tiles,
//      a 4 × 4 register tile of outputs per thread.
// Any n: ragged edge tiles are masked (the last diagonal block is padded
// with the identity in shared memory and never written beyond n).  A
// non-positive (or NaN) pivot gives a NaN pivot, and NaN then spreads
// through every later column of L, as the port's NaN-on-failure factor
// contract asks.  Launches: 3 · ⌈n/64⌉ − 2 per factorization.

#include "common.cuh"

namespace {

constexpr int kT = 64;         // panel / tile width
constexpr int kThreads = 256;  // threads per block

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

__global__ void __launch_bounds__(kThreads)
chol_diag(float* __restrict__ A, float* __restrict__ winv, int n, int k0) {
  __shared__ float s[kT][kT + 1];
  __shared__ float w[kT][kT + 1];
  const int nb = min(kT, n - k0);
  const int tid = threadIdx.x;
  for (int e = tid; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    s[r][c] = (r < nb && c < nb) ? A[(size_t)(k0 + r) * n + k0 + c]
                                 : (r == c ? 1.0f : 0.0f);
  }
  __syncthreads();

  // right-looking column sweep over the lower triangle
  for (int c = 0; c < kT; ++c) {
    const float p = s[c][c];
    const float d = p > 0.0f ? sqrtf(p) : quiet_nan();  // NaN stays NaN
    __syncthreads();  // every thread has read the pivot
    for (int r = c + 1 + tid; r < kT; r += kThreads) s[r][c] = s[r][c] / d;
    if (tid == 0) s[c][c] = d;
    __syncthreads();
    const int m = kT - 1 - c;
    for (int e = tid; e < m * m; e += kThreads) {
      const int i = c + 1 + e / m, j = c + 1 + e % m;
      if (j <= i) s[i][j] = fmaf(-s[i][c], s[j][c], s[i][j]);
    }
    __syncthreads();
  }

  // W = L⁻¹ by forward substitution, one column per thread
  if (tid < kT) {
    const int j = tid;
    for (int i = 0; i < j; ++i) w[i][j] = 0.0f;
    w[j][j] = 1.0f / s[j][j];
    for (int i = j + 1; i < kT; ++i) {
      float acc = 0.0f;
      for (int q = j; q < i; ++q) acc = fmaf(s[i][q], w[q][j], acc);
      w[i][j] = -acc / s[i][i];
    }
  }
  __syncthreads();

  for (int e = tid; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    winv[e] = w[r][c];
    if (r < nb && c < nb) A[(size_t)(k0 + r) * n + k0 + c] = c <= r ? s[r][c] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
chol_panel(float* __restrict__ A, const float* __restrict__ winv, int n, int k0) {
  __shared__ float a[kT][kT + 1];
  __shared__ float w[kT][kT + 1];
  const int i0 = k0 + kT * (1 + blockIdx.x);
  const int rows = min(kT, n - i0);  // the panel itself is full: k0 + kT < n
  const int tid = threadIdx.x;
  for (int e = tid; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    a[r][c] = r < rows ? A[(size_t)(i0 + r) * n + k0 + c] : 0.0f;
    w[r][c] = winv[e];
  }
  __syncthreads();

  // L_ik[r][col] = Σ_{q ≤ col} A_ik[r][q] · W[col][q]; a warp spans 32
  // columns of one row (conflict-free reads of w, broadcast of a)
  const int col = tid % kT;
  for (int r = tid / kT; r < rows; r += kThreads / kT) {
    float acc = 0.0f;
    for (int q = 0; q <= col; ++q) acc = fmaf(a[r][q], w[col][q], acc);
    A[(size_t)(i0 + r) * n + k0 + col] = acc;
  }
  // the mirror tile (k, i) belongs to the upper triangle: zero it
  for (int e = tid; e < kT * rows; e += kThreads) {
    A[(size_t)(k0 + e / rows) * n + i0 + e % rows] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
chol_trail(float* __restrict__ A, int n, int k0) {
  // li[q][r] = L_ik[r][q], lj[q][c] = L_jk[c][q]: a thread's four rows
  // (columns) at depth q are one aligned float4
  __shared__ __align__(16) float li[kT][kT + 4];
  __shared__ __align__(16) float lj[kT][kT + 4];
  // flat lower-triangle tile index t → (ir, jr), jr ≤ ir
  const long long t = blockIdx.x;
  int ir = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while ((long long)(ir + 1) * (ir + 2) / 2 <= t) ++ir;
  while ((long long)ir * (ir + 1) / 2 > t) --ir;
  const int jr = (int)(t - (long long)ir * (ir + 1) / 2);
  const int i0 = k0 + kT * (1 + ir), j0 = k0 + kT * (1 + jr);
  const int rows_i = min(kT, n - i0), rows_j = min(kT, n - j0);
  const int tid = threadIdx.x;
  for (int e = tid; e < kT * kT; e += kThreads) {
    const int r = e / kT, q = e % kT;
    li[q][r] = r < rows_i ? A[(size_t)(i0 + r) * n + k0 + q] : 0.0f;
    lj[q][r] = r < rows_j ? A[(size_t)(j0 + r) * n + k0 + q] : 0.0f;
  }
  __syncthreads();

  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
#pragma unroll 8
  for (int q = 0; q < kT; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(&li[q][ty * 4]);
    const float4 y = *reinterpret_cast<const float4*>(&lj[q][tx * 4]);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xs[u], ys[v], acc[u][v]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ty * 4 + u;
    if (r >= rows_i) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = tx * 4 + v;
      if (c < rows_j) {
        float* p = &A[(size_t)(i0 + r) * n + j0 + c];
        *p = *p - acc[u][v];
      }
    }
  }
}

}  // namespace

// Scratch floats algp_cholesky needs for the diagonal block's inverse.
ALGP_EXPORT int algp_chol_scratch() { return kT * kT; }

// A: (n, n) row-major f32, overwritten by tril(L); winv: algp_chol_scratch()
// floats.  Returns cudaGetLastError after the first refused launch, else
// after the last.
ALGP_EXPORT int algp_cholesky(float* A, float* winv, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = (n + kT - 1) / kT;
  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * kT;
    chol_diag<<<1, kThreads, 0, st>>>(A, winv, n, k0);
    int err = algp_last_error();
    if (err != 0) return err;
    const long long m = nt - kt - 1;  // row tiles below the panel
    if (m == 0) break;
    chol_panel<<<(unsigned)m, kThreads, 0, st>>>(A, winv, n, k0);
    err = algp_last_error();
    if (err != 0) return err;
    chol_trail<<<(unsigned)(m * (m + 1) / 2), kThreads, 0, st>>>(A, n, k0);
    err = algp_last_error();
    if (err != 0) return err;
  }
  return 0;
}
