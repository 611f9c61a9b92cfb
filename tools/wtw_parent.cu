// The square precision-column kernel as it was before it took a row strip
// (algp_tpu_torch/csrc/wtw_column.cu up to the strip form), for
// chip_smoke.py and tests/test_torch_cuda.py only: the library never runs
// it.  The kernel's square call (row0 = 0, rows = N) must give its bits.

#include "../algp_tpu_torch/csrc/common.cuh"

namespace {

constexpr int kCols = 256;  // columns per block (= threads)
constexpr int kRows = 128;  // k rows per slice

__global__ void __launch_bounds__(kCols)
wtw_partial(const float* __restrict__ W, const int* __restrict__ jp,
            float* __restrict__ partial, int n) {
  __shared__ float wj[kRows];
  const int j = *jp;
  const int c0 = blockIdx.x * kCols;
  const int k_lo = blockIdx.y * kRows;
  const int k_hi = min(k_lo + kRows, n);
  // rows below max(c0, j) hold W[k, c] = 0 or W[k, j] = 0 for the whole
  // block; the reduction skips exactly the slices that end there
  const int start = max(k_lo, max(c0, j));
  if (start >= k_hi || j < 0 || j >= n) return;

  for (int t = threadIdx.x; t < k_hi - start; t += kCols) {
    wj[t] = W[(size_t)(start + t) * n + j];
  }
  __syncthreads();

  const int c = c0 + threadIdx.x;
  if (c >= n) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int k = max(start, c); k < k_hi; ++k) {
    acc = fmaf(wj[k - start], W[(size_t)k * n + c], acc);
  }
  partial[(size_t)blockIdx.y * n + c] = acc;
}

__global__ void wtw_reduce(const float* __restrict__ partial, const int* __restrict__ jp,
                           float* __restrict__ out, int n, int splits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int j = *jp;
  if (j < 0 || j >= n) {  // an out-of-range index poisons the column
    out[c] = __int_as_float(0x7fc00000);
    return;
  }
  // slices ending at or before max(c, j) contribute exactly zero and were
  // not written; every later slice was
  float acc = 0.0f;
  for (int s = max(c, j) / kRows; s < splits; ++s) {
    acc += partial[(size_t)s * n + c];
  }
  out[c] = acc;
}

}  // namespace

// W: (n, n) lower-triangular, j: one int32 on the device, partial: scratch
// of ⌈n / 128⌉ · n floats, out: (n,).  Returns cudaGetLastError.
ALGP_EXPORT int wtw_column_parent(const float* W, const int* j, float* partial,
                                float* out, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int splits = (n + kRows - 1) / kRows;
  const dim3 grid((n + kCols - 1) / kCols, splits);
  wtw_partial<<<grid, kCols, 0, st>>>(W, j, partial, n);
  const int err = algp_last_error();
  if (err != 0) return err;
  wtw_reduce<<<(n + 255) / 256, 256, 0, st>>>(partial, j, out, n, splits);
  return algp_last_error();
}
