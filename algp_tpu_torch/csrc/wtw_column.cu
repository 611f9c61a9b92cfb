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
// zero triangle.  The Krause-MI loop calls it once per round, so a small
// strip's call is as much launch and host work as bytes.
//
// Design: one launch a call, no scratch, no float atomics.  A thread
// block cluster of 8 blocks (256 threads each) owns a tile of 128 columns
// (32 for N % 4 ≠ 0); a lane owns 4 adjacent columns and reads them with
// one 16-byte load a row, so a warp reads 512 contiguous bytes of a row.
// The grid holds only the tiles left of the strip's end (c < row0 + rows);
// the columns past it are exact zeros, stored by all blocks in a
// grid-stride loop.  j is known only on the device, so each cluster
// splits the rows that can reach its tile, k ∈ [max(row0, j, c0),
// row0 + rows), into 64 equal contiguous chunks, one a warp: the work of a
// tile spreads over its cluster whatever j is.  A warp reads W[k, j] for
// 32 rows at once (a lane a row) and passes each to the others with a
// shuffle; rows on the tile's diagonal band load only their entries at
// columns ≤ the row.  The sums are fixed in order: a lane's rows in
// increasing k, the block's warps in order through shared memory, then
// the cluster's 8 blocks in rank order through distributed shared memory
// (each block finishes 16 of the tile's columns).  So the result, which
// feeds an argmax, repeats bit for bit from run to run.  An out-of-range
// j yields a NaN column.  Any N.

#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;  // blocks a tile (the portable cluster size)
constexpr int kUnroll = 8;   // rows a lane has in flight

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// Up to 32 rows of one warp: `row` points at W_loc's entry (first row, c),
// c the lane's first column; `d0` = (first row's global index) − c, so
// column c + i of row r lies in the lower triangle iff i ≤ d0 + r; `wl`
// holds W[row r, j] in lane r.  BAND: some rows cross the tile's diagonal.
template <int VEC, bool BAND>
__device__ __forceinline__ void rows_group(const float* __restrict__ row, size_t n,
                                           int cnt, int d0, float wl, float (&acc)[VEC]) {
  for (int r = 0; r < cnt; r += kUnroll) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float* p = row + (size_t)(r + u) * n;
      const int d = d0 + r + u;
      if (r + u < cnt && (!BAND || d >= VEC - 1)) {
        load_row<VEC>(p, v[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          v[u][i] = (BAND && r + u < cnt && i <= d) ? __ldg(p + i) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // r + u ≤ 31: r steps by 8 below cnt ≤ 32
      const float w = __shfl_sync(0xffffffffu, wl, r + u);
      if (r + u < cnt) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w, v[u][i], acc[i]);
      }
    }
  }
}

template <int VEC>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
wtw_column_kernel(const float* __restrict__ W, const long long* __restrict__ jp,
                  float* __restrict__ out, int n, int row0, int rows) {
  constexpr int kTile = 32 * VEC;         // columns a cluster
  constexpr int kPer = kTile / kCluster;  // columns a block finishes
  __shared__ __align__(16) float red[kWarps][kTile];
  __shared__ float part[kTile];
  cg::cluster_group cluster = cg::this_cluster();
  const int member = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kend = row0 + rows;  // one past the strip's last row, = columns that can contribute
  const long long j64 = *jp;
  const bool valid = j64 >= 0 && j64 < n;
  const int j = valid ? static_cast<int>(j64) : 0;
  const int c0 = (blockIdx.x / kCluster) * kTile;
  const int c = c0 + lane * VEC;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  // rows that reach the tile: W[k, j] = 0 for k < j, W[k, c] = 0 for k < c0
  const int kstart = max(max(row0, j), c0);
  const int R = valid ? kend - kstart : 0;
  if (R > 0) {
    const int chunk = (R + kCluster * kWarps - 1) / (kCluster * kWarps);
    const int a = kstart + (member * kWarps + warp) * chunk;
    const int b = min(a + chunk, kend);
    for (int k0 = a; k0 < b; k0 += 32) {
      const int cnt = min(32, b - k0);
      const float wl = lane < cnt ? __ldg(W + (size_t)(k0 + lane - row0) * n + j) : 0.0f;
      const float* row = W + (size_t)(k0 - row0) * n + c;
      if (k0 >= c0 + kTile - 1) {  // below the band: every column of the tile ≤ the row
        rows_group<VEC, false>(row, n, cnt, k0 - c, wl, acc);
      } else {
        rows_group<VEC, true>(row, n, cnt, k0 - c, wl, acc);
      }
    }
  }

  // the block's sum over its warps, in warp order
#pragma unroll
  for (int i = 0; i < VEC; ++i) red[warp][lane * VEC + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < kTile) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][threadIdx.x];
    part[threadIdx.x] = s;
  }
  cluster.sync();
  // the cluster's sum in rank order; this block finishes kPer columns
  if (threadIdx.x < kPer) {
    const int t = member * kPer + threadIdx.x;
    float s = *cluster.map_shared_rank(&part[t], 0);
#pragma unroll
    for (int m = 1; m < kCluster; ++m) s += *cluster.map_shared_rank(&part[t], m);
    if (c0 + t < kend) out[c0 + t] = valid ? s : __int_as_float(0x7fc00000);
  }
  // the columns past the strip: exact zeros (NaN for an out-of-range j)
  const int tail = n - kend;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < tail; i += gridDim.x * kThreads) {
    out[kend + i] = valid ? 0.0f : __int_as_float(0x7fc00000);
  }
  cluster.sync();  // no block leaves while the others read its `part`
}

// The launch's shape with no work: the floor below which no call can go.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
wtw_empty_kernel() {}

int vec_width(const float* W, int n) {
  return (n % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0) ? 4 : 1;
}

// Blocks of a call: a cluster for each tile left of row0 + rows (one at
// least, which then only stores the zero columns).
unsigned blocks(int vec, int row0, int rows) {
  const int tile = 32 * vec;
  return static_cast<unsigned>(std::max(1, (row0 + rows + tile - 1) / tile) * kCluster);
}

}  // namespace

// W: rows [row0, row0 + rows) of an (n, n) lower-triangular matrix,
// (rows, n) row-major (the square call: row0 = 0, rows = n); j: one int64
// on the device; out: (n,).  One kernel launch.  Returns cudaGetLastError.
ALGP_EXPORT int algp_wtw_column(const float* W, const long long* j, float* out, int n,
                                int row0, int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = vec_width(W, n);
  if (vec == 4) {
    wtw_column_kernel<4><<<blocks(4, row0, rows), kThreads, 0, st>>>(W, j, out, n, row0, rows);
  } else {
    wtw_column_kernel<1><<<blocks(1, row0, rows), kThreads, 0, st>>>(W, j, out, n, row0, rows);
  }
  return algp_last_error();
}

// An empty kernel on the grid and cluster shape `algp_wtw_column` would
// launch for these arguments (a measurement of the launch alone; no
// wrapper calls it).
ALGP_EXPORT int algp_wtw_empty(const float* W, int n, int row0, int rows, void* stream) {
  wtw_empty_kernel<<<blocks(vec_width(W, n), row0, rows), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>();
  return algp_last_error();
}
