// Precision column u = (WᵀW)[:, j] = Σ_{k ≥ max(c, j)} W[k, j] · W[k, c] for a
// lower-triangular W (N × N, row-major f32), with j read from device memory,
// or its part over a row strip: for W_loc = W[row0 : row0 + rows, :]
// (rows × N, row-major) the same sum over k ∈ [row0, row0 + rows).  The mesh
// paths (algp_tpu_torch/parallel) hold a strip per rank and add the ranks'
// partial columns; the square call is row0 = 0, rows = N.
//
// Replaces: algp_tpu/ops/updates.py `_wtw_col_dma_kernel`
// (`wtw_column_streamed`) and `_wtw_pipe_kernel` (`wtw_column_pipelined`),
// which are bitwise-identical to each other; one kernel covers both.  The
// reference's mesh loop computes the strip form as a plain product
// (algp_tpu/parallel/sharded_mi.py, `W_loc.T @ w`).
//
// Bound: device-memory bandwidth.  Only the contributing lower-triangle
// entries are read, about N²/2 · 4 bytes (210 MB at N = 10 240) per square
// call, against N² multiply-adds: far below the card's arithmetic rate.  A
// strip reads its rows' entries at columns ≤ the row: rows·N minus the
// zero triangle.  The Krause-MI loop calls it once per round.
//
// Design: thread c of a block owns column c, so a warp reads 128
// contiguous bytes of a row of W; W[k, j] is the same for the whole block
// and is staged once in shared memory.  The strip's k range is split into
// 128-row slices over blockIdx.y, so the triangle's work spreads over all
// SMs instead of one long loop per column block; slices entirely above
// max(column block, j) exit at once.  Each block writes its partial sums
// to a scratch buffer, and a second kernel adds a column's partials in
// slice order.  No float atomics: the sum order is fixed, so the result
// (which feeds an argmax) repeats bit for bit from run to run.  Any N.

#include "common.cuh"

namespace {

constexpr int kCols = 256;  // columns per block (= threads)
constexpr int kRows = 128;  // k rows per slice

__global__ void __launch_bounds__(kCols)
wtw_partial(const float* __restrict__ W, const int* __restrict__ jp,
            float* __restrict__ partial, int n, int row0, int rows) {
  __shared__ float wj[kRows];
  const int j = *jp;
  const int c0 = blockIdx.x * kCols;
  // global rows of this slice; W holds rows [row0, row0 + rows)
  const int k_lo = row0 + blockIdx.y * kRows;
  const int k_hi = min(k_lo + kRows, row0 + rows);
  // rows below max(c0, j) hold W[k, c] = 0 or W[k, j] = 0 for the whole
  // block; the reduction skips exactly the slices that end there
  const int start = max(k_lo, max(c0, j));
  if (start >= k_hi || j < 0 || j >= n) return;

  for (int t = threadIdx.x; t < k_hi - start; t += kCols) {
    wj[t] = W[(size_t)(start + t - row0) * n + j];
  }
  __syncthreads();

  const int c = c0 + threadIdx.x;
  if (c >= n) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = max(start, c); k < k_hi; ++k) {
    acc = fmaf(wj[k - start], W[(size_t)(k - row0) * n + c], acc);
  }
  partial[(size_t)blockIdx.y * n + c] = acc;
}

__global__ void wtw_reduce(const float* __restrict__ partial, const int* __restrict__ jp,
                           float* __restrict__ out, int n, int row0, int rows, int splits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int j = *jp;
  if (j < 0 || j >= n) {  // an out-of-range index poisons the column
    out[c] = __int_as_float(0x7fc00000);
    return;
  }
  // slices ending at or before max(c, j) contribute exactly zero and were
  // not written; every later slice was (none when max(c, j) lies past the
  // strip)
  const int m = max(c, j);
  float acc = 0.0f;
  if (m < row0 + rows) {
    for (int s = max(m - row0, 0) / kRows; s < splits; ++s) {
      acc += partial[(size_t)s * n + c];
    }
  }
  out[c] = acc;
}

}  // namespace

// Number of k slices of a strip of `rows` rows, i.e. the rows of the
// (splits, n) scratch buffer.
ALGP_EXPORT int algp_wtw_splits(int rows) { return (rows + kRows - 1) / kRows; }

// W: rows [row0, row0 + rows) of an (n, n) lower-triangular matrix,
// (rows, n) row-major (the square call: row0 = 0, rows = n); j: one int32
// on the device; partial: scratch of algp_wtw_splits(rows) · n floats;
// out: (n,).  Returns cudaGetLastError.
ALGP_EXPORT int algp_wtw_column(const float* W, const int* j, float* partial,
                                float* out, int n, int row0, int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = algp_wtw_splits(rows);
  if (splits > 0) {
    const dim3 grid((n + kCols - 1) / kCols, splits);
    wtw_partial<<<grid, kCols, 0, st>>>(W, j, partial, n, row0, rows);
    const int err = algp_last_error();
    if (err != 0) return err;
  }
  wtw_reduce<<<(n + 255) / 256, 256, 0, st>>>(partial, j, out, n, row0, rows, splits);
  return algp_last_error();
}
