// Blocked right-looking Cholesky factorization, in place: tril(L) with
// L Lᵀ = K for a symmetric positive-definite K (N × N, row-major f32,
// N a multiple of 128; the wrapper pads any n to that with the identity).
//
// Replaces: algp_tpu/ops/pallas_chol.py `_chol_kernel` (`cholesky_pallas`)
// and `_chol_kernel_la` (`cholesky_pallas_la`).  The two compute the same
// factor; the lookahead variant only works around Mosaic's in-order issue
// on the TPU, so one design covers both, with a lookahead that Hopper can
// really run concurrently.
//
// Bound: arithmetic.  n³/3 flops against 2 · 4 · n² bytes (each entry read
// and written once): at n = 10 240, 3.6e11 flops ≈ 5.3 ms at the card's
// 67 TFLOP/s of FP32 outside the tensor cores, against 0.25 ms of memory
// traffic.  FP32 FMA throughout: no TF32 and no tensor cores, because the
// selection-fidelity contract forbids reduced-precision products.  Almost
// all flops are in the trailing update, so the design is an FP32 SYRK fed
// as fast as the FMA pipes run, with the serial chain of diagonal factors
// kept short and off the trailing update's way.
//
// Design, per 256-wide outer strip k (the TPU kernel's _PANEL; the
// trailing triangle passes through HBM N/256 times):
//   chol_diag  — one block factors the strip's 256 × 256 diagonal block in
//                64-wide sub-steps: a column sweep of the 64 × 64 diagonal
//                tile and a row sweep forming its inverse W_ss = L_ss⁻¹,
//                4 × 4 entries a thread in registers, one barrier a step
//                and no division or square root on that serial chain; then
//                the tiles below it as products with W_ssᵀ, and the update
//                of the rest of the block.  The four W_ss go to scratch.
//   chol_panel — one block per 64-row tile below the block: the strip's
//                rows in shared memory, solved by blocked forward
//                substitution (products with the diagonal block's L and
//                with each W_ss); writes L_ik, a transposed copy Lᵀ of the
//                strip (256 × N scratch, so the update's tiles are rows of
//                it) and zeros in the mirror tile of the upper triangle.
//   chol_syrk  — A_ij −= L_ik L_jkᵀ over 128 × 128 lower tiles, depth 256:
//                256 threads with 8 × 8 accumulators (4 FMAs per float read
//                from shared memory), depth chunks of 16 through a 4-stage
//                ring filled by 16-byte cp.async, so the next chunks' loads
//                overlap this chunk's FMAs; a diagonal tile writes its lower
//                half only.
//   chol_diag_update — the lookahead's first step: the next strip's
//                256 × 256 diagonal block in 64 × 64 tiles (10 blocks), so
//                that its factor can start before the rest of the update.
// Lookahead, after strip k's panel: the caller's stream updates the next
// strip's diagonal block (chol_diag_update), and a second, high-priority
// stream factors it (chol_diag) while the caller's stream updates the rows
// below it (chol_syrk over one or two tile columns); the second stream then
// solves the next panel (chol_panel) while the caller's stream runs the rest
// of strip k's update.  chol_diag publishes the SM it runs on, and update
// blocks on that SM pause between depth chunks until it is done, so the
// serial chain runs at the speed it has alone (137 µs instead of ≈ 205 µs
// per strip at n = 10 240).  The call enters and leaves on the caller's
// stream through events; the stream and events are created once; nothing
// here allocates or synchronises the host.  Launches per factorization:
// 5 · ⌈N/256⌉ − 6 for N > 256 (194 at N = 10 240 and at N = 10 112).
//
// Measured on an H100 SXM (700 W), n = 10 240: 12.7 ms, 28 TFLOP/s, 42 % of
// the bound; the serial chain (diagonal update, factor and panel, ≈ 230 µs
// per strip) is what keeps it there (PERF.md §6, tools/chol_profile.py).
//
// A non-positive (or NaN) pivot gives a NaN pivot, and NaN then spreads
// through every later column of L, while the columns before it stay
// finite, as the port's NaN-on-failure factor contract asks.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kPanel = 256;    // outer strip width
constexpr int kSub = 64;       // sub-step of the diagonal factor and panel solve
constexpr int kTile = 128;     // trailing-update output tile; N is a multiple
constexpr int kLd = kSub + 4;  // q-major 64-wide tiles: 16-byte rows
constexpr int kDs = kSub + 4;  // the row-major diagonal tile: 16-byte rows
constexpr int kThreads = 256;  // threads per block of the panel and the update
constexpr int kBK = 16;        // trailing-update depth chunk
constexpr int kStages = 4;     // cp.async ring depth

// dynamic shared memory of each kernel, bytes
constexpr int kDiagSmem = (4 * kSub * kLd + kSub * kDs + 3 * kSub) * 4;
constexpr int kPanelSmem = (kPanel + kSub) * kLd * 4;
constexpr int kSyrkSmem = kStages * 2 * kBK * kTile * 4;
constexpr int kUpdateSmem = 2 * 2 * kSub * kLd * 4;

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// The SM that chol_diag runs on, −1 when none: update blocks on that SM
// pause between depth chunks, so the serial chain does not share its SM's
// issue slots with them.
__device__ int g_diag_sm = -1;

__device__ __forceinline__ int sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return static_cast<int>(id);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// acc[u][v] += Σ_q X[q][4ty + u] · Y[q][4tx + v] over q < 64, for X and Y
// q-major (kLd-strided) 64 × 64 tiles in shared memory.
__device__ __forceinline__ void mm64(float (&acc)[4][4], const float* X,
                                     const float* Y, int ty, int tx) {
#pragma unroll 8
  for (int q = 0; q < kSub; ++q) {
    const float4 x = *reinterpret_cast<const float4*>(X + q * kLd + 4 * ty);
    const float4 y = *reinterpret_cast<const float4*>(Y + q * kLd + 4 * tx);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(xs[u], ys[v], acc[u][v]);
  }
}

// S[c][r] = G[r][c] for the 64 × 64 block at G (row stride ld): a
// row-major block stored q-major.
__device__ __forceinline__ void load_t(float* S, const float* G, int ld) {
#pragma unroll 8
  for (int e = threadIdx.x; e < kSub * kSub; e += kThreads) {
    const int r = e / kSub, c = e % kSub;
    S[c * kLd + r] = G[(size_t)r * ld + c];
  }
}


// The block factors the 64 × 64 tile D (row-major, stride kDs) in place,
// thread (ty, tx) holding rows 4ty + u, columns 4tx + v in registers.
// Step c: the owners of column c publish it unscaled through `pub` (two
// buffers, by parity), one barrier, every thread with rows below c updates
// its entries right of and below c (a_ij −= a_ic a_jc / p).  No division
// or square root sits on this chain: the columns are scaled by their
// pivots' square roots after the sweep.  The upper half becomes zero; a
// non-positive or NaN pivot makes its column and everything right of it NaN.
__device__ __forceinline__ void factor64(float* D, float* pub, float* piv, int ty, int tx) {
  float a[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 t = *reinterpret_cast<const float4*>(D + (4 * ty + u) * kDs + 4 * tx);
    a[u][0] = t.x, a[u][1] = t.y, a[u][2] = t.z, a[u][3] = t.w;
  }
  for (int c0 = 0; c0 < kSub; c0 += 4) {
#pragma unroll
    for (int cv = 0; cv < 4; ++cv) {
      const int c = c0 + cv;
      float* col = pub + (c % 2) * kSub;
      if (4 * tx == c0)
        *reinterpret_cast<float4*>(col + 4 * ty) = make_float4(a[0][cv], a[1][cv], a[2][cv], a[3][cv]);
      __syncthreads();
      if (tx == 0 && ty == 0) piv[c] = col[c];
      if (4 * ty + 3 <= c) continue;  // no row of this thread lies below c
      const float p = col[c];
      const float4 ci = *reinterpret_cast<const float4*>(col + 4 * ty);
      const float4 cj = *reinterpret_cast<const float4*>(col + 4 * tx);
      const float rp = p > 0.0f ? __frcp_rn(p) : quiet_nan();  // false for NaN too
      const float li[4] = {ci.x * rp, ci.y * rp, ci.z * rp, ci.w * rp};
      const float lj[4] = {cj.x, cj.y, cj.z, cj.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (4 * ty + u > c && 4 * tx + v > c) a[u][v] = fmaf(-li[u], lj[v], a[u][v]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int c = 4 * tx + v;
    const float p = piv[c];
    const float d = p > 0.0f ? sqrtf(p) : quiet_nan();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = 4 * ty + u;
      a[u][v] = c < r ? a[u][v] / d : (c == r ? d : 0.0f);
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    *reinterpret_cast<float4*>(D + (4 * ty + u) * kDs + 4 * tx) =
        make_float4(a[u][0], a[u][1], a[u][2], a[u][3]);
}

// The block forms W = L⁻¹ of the lower 64 × 64 tile L (row-major, stride
// kDs) by a row sweep, thread (ty, tx) holding W's rows 4ty + u, columns
// 4tx + v: step i, the owners of row i (final but for its scale) scale and
// publish it, one barrier, every thread with rows below i eliminates it
// from them.  The reciprocals of the diagonal come first, off the chain.
// Stored q-major: Wt[q][c] = W[c][q].
__device__ __forceinline__ void invert64(const float* L, float* Wt, float* pub, float* rinv,
                                         int ty, int tx) {
  const int tid = 16 * ty + tx;
  if (tid < kSub) rinv[tid] = 1.0f / L[tid * kDs + tid];
  __syncthreads();
  float w[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) w[u][v] = 4 * ty + u == 4 * tx + v ? 1.0f : 0.0f;
  for (int i0 = 0; i0 < kSub; i0 += 4) {
#pragma unroll
    for (int iu = 0; iu < 4; ++iu) {
      const int i = i0 + iu;
      float* row = pub + (i % 2) * kSub;
      if (4 * ty == i0) {
        const float r = rinv[i];
#pragma unroll
        for (int v = 0; v < 4; ++v) w[iu][v] *= r;
        *reinterpret_cast<float4*>(row + 4 * tx) = make_float4(w[iu][0], w[iu][1], w[iu][2], w[iu][3]);
      }
      __syncthreads();
      if (4 * ty + 3 <= i) continue;  // no row of this thread lies below i
      const float4 wr = *reinterpret_cast<const float4*>(row + 4 * tx);
      const float wi[4] = {wr.x, wr.y, wr.z, wr.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (4 * ty + u <= i) continue;
        const float l = L[(4 * ty + u) * kDs + i];
#pragma unroll
        for (int v = 0; v < 4; ++v) w[u][v] = fmaf(-l, wi[v], w[u][v]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) Wt[(4 * tx + v) * kLd + 4 * ty + u] = w[u][v];
}

__global__ void __launch_bounds__(kThreads)
chol_diag(float* __restrict__ A, float* __restrict__ wbuf, int N, int k0, int nb) {
  extern __shared__ __align__(16) float smem[];
  float* below = smem;                // [3][64][kLd]: tiles under the diagonal, q-major
  float* Wt = below + 3 * kSub * kLd; // [64][kLd]: Wt[q][c] = W_ss[c][q]
  float* D = Wt + kSub * kLd;         // [64][kDs]: the diagonal tile, row-major
  float* pub = D + kSub * kDs;        // [2][64]: a published column or row
  float* piv = pub + 2 * kSub;        // [64]: the pivots, then their reciprocals
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int ns = nb / kSub;
  float* Akk = A + (size_t)k0 * N + k0;
  if (tid == 0) atomicExch(&g_diag_sm, sm_id());

  for (int s = 0; s < ns; ++s) {
    float* Ass = Akk + (size_t)(s * kSub) * N + s * kSub;
#pragma unroll 4
    for (int e = tid; e < kSub * kSub; e += kThreads) {
      const int r = e / kSub, c = e % kSub;
      D[r * kDs + c] = Ass[(size_t)r * N + c];
    }
    for (int r = s + 1; r < ns; ++r)
      load_t(below + (r - s - 1) * kSub * kLd, Ass + (size_t)((r - s) * kSub) * N, N);
    __syncthreads();
    factor64(D, pub, piv, ty, tx);
    __syncthreads();
    invert64(D, Wt, pub, piv, ty, tx);
    __syncthreads();

    // L_ss and W_ss out; the rest of the tile row s of the block lies in
    // the upper triangle: zero it
#pragma unroll 4
    for (int e = tid; e < kSub * kSub; e += kThreads) {
      const int r = e / kSub, c = e % kSub;
      Ass[(size_t)r * N + c] = D[r * kDs + c];
      wbuf[s * kSub * kSub + e] = Wt[r * kLd + c];
      for (int t = s + 1; t < ns; ++t) Ass[(size_t)r * N + (t - s) * kSub + c] = 0.0f;
    }

    // the tiles below: L_rs = A_rs · W_ssᵀ, kept q-major for the update
    for (int r = s + 1; r < ns; ++r) {
      float* X = below + (r - s - 1) * kSub * kLd;
      float acc[4][4] = {};
      mm64(acc, X, Wt, ty, tx);
      __syncthreads();
      float* Ars = Ass + (size_t)((r - s) * kSub) * N;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          X[(4 * tx + v) * kLd + 4 * ty + u] = acc[u][v];
          Ars[(size_t)(4 * ty + u) * N + 4 * tx + v] = acc[u][v];
        }
    }
    __syncthreads();

    // the rest of the block: A_rt −= L_rs L_tsᵀ, s < t ≤ r
    for (int r = s + 1; r < ns; ++r)
      for (int t = s + 1; t <= r; ++t) {
        float acc[4][4] = {};
        mm64(acc, below + (r - s - 1) * kSub * kLd, below + (t - s - 1) * kSub * kLd, ty, tx);
        float* Art = Akk + (size_t)(r * kSub) * N + t * kSub;
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) Art[(size_t)(4 * ty + u) * N + 4 * tx + v] -= acc[u][v];
      }
    __syncthreads();
  }
  if (tid == 0) atomicExch(&g_diag_sm, -1);
}

__global__ void __launch_bounds__(kThreads)
chol_panel(float* __restrict__ A, float* __restrict__ lt, const float* __restrict__ wbuf,
           int N, int k0) {
  constexpr int nb = kPanel;  // a strip with rows below it is a full one
  extern __shared__ __align__(16) float smem[];
  float* X = smem;             // [nb][kLd]: X[q][r] = A[i0 + r][k0 + q]
  float* Y = X + nb * kLd;     // [64][kLd]: one q-major operand tile
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int i0 = k0 + nb + kSub * blockIdx.x;
#pragma unroll 8
  for (int e = tid; e < kSub * nb; e += kThreads) {
    const int r = e / nb, q = e % nb;
    X[q * kLd + r] = A[(size_t)(i0 + r) * N + k0 + q];
  }
  // the mirror tile lies in the upper triangle: zero it
#pragma unroll 8
  for (int e = tid; e < nb * kSub; e += kThreads) {
    const int q = e / kSub, r = e % kSub;
    A[(size_t)(k0 + q) * N + i0 + r] = 0.0f;
  }
  __syncthreads();

  // blocked forward substitution: X_s −= Σ_{t<s} L_t L_stᵀ, L_s = X_s W_ssᵀ
  for (int s = 0; s < nb / kSub; ++s) {
    float acc[4][4] = {};
    for (int t = 0; t < s; ++t) {
      load_t(Y, A + (size_t)(k0 + s * kSub) * N + k0 + t * kSub, N);
      __syncthreads();
      mm64(acc, X + t * kSub * kLd, Y, ty, tx);
      __syncthreads();
    }
    float* Xs = X + s * kSub * kLd;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) Xs[(4 * tx + v) * kLd + 4 * ty + u] -= acc[u][v];
#pragma unroll 8
    for (int e = tid; e < kSub * kSub; e += kThreads)
      Y[(e / kSub) * kLd + e % kSub] = wbuf[s * kSub * kSub + e];
    __syncthreads();
    float lw[4][4] = {};
    mm64(lw, Xs, Y, ty, tx);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) Xs[(4 * tx + v) * kLd + 4 * ty + u] = lw[u][v];
    __syncthreads();
  }

#pragma unroll 8
  for (int e = tid; e < kSub * nb; e += kThreads) {
    const int r = e / nb, q = e % nb;
    A[(size_t)(i0 + r) * N + k0 + q] = X[q * kLd + r];
  }
#pragma unroll 8
  for (int e = tid; e < nb * kSub; e += kThreads) {
    const int q = e / kSub, r = e % kSub;
    lt[(size_t)q * N + i0 + r] = X[q * kLd + r];
  }
}

// The lookahead's first step: A_rt −= Σ_q lt[q][k1 + 64r + i] lt[q][k1 + 64t + j]
// over the lower 64 × 64 tiles (r, t), t ≤ r, of the next strip's diagonal
// block at k1, depth `depth` — one block per tile, depth chunks of 64
// through a 2-stage cp.async ring (the rows of lt are q-major already), so
// that the next diagonal factor can start before the rest of the update.
__global__ void __launch_bounds__(kThreads)
chol_diag_update(float* __restrict__ A, const float* __restrict__ lt, int N, int depth, int k1) {
  extern __shared__ __align__(16) float smem[];  // [2 stages][2][64][kLd]
  int r = 0;
  while ((r + 1) * (r + 2) / 2 <= (int)blockIdx.x) ++r;
  const int t = blockIdx.x - r * (r + 1) / 2;
  const int i0 = k1 + kSub * r, j0 = k1 + kSub * t;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  auto load = [&](int stage, int k) {
    float* X = smem + stage * 2 * kSub * kLd;
    float* Y = X + kSub * kLd;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int idx = tid + h * kThreads, q = idx / 16, c = (idx % 16) * 4;
      const float* src = lt + (size_t)(k + q) * N;
      cp_async16(X + q * kLd + c, src + i0 + c);
      cp_async16(Y + q * kLd + c, src + j0 + c);
    }
  };
  const int nk = depth / kSub;
  load(0, 0);
  cp_async_commit();
  float acc[4][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) % 2, (kt + 1) * kSub);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* X = smem + (kt % 2) * 2 * kSub * kLd;
    mm64(acc, X, X + kSub * kLd, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float4* p = reinterpret_cast<float4*>(A + (size_t)(i0 + 4 * ty + u) * N + j0 + 4 * tx);
    float4 x = *p;
    x.x -= acc[u][0];
    x.y -= acc[u][1];
    x.z -= acc[u][2];
    x.w -= acc[u][3];
    *p = x;
  }
}

// A_ij −= Σ_q lt[q][i] lt[q][j] over the lower 128 × 128 tiles (i, j) of
// tile columns ta … ta + w − 1 (rows from the diagonal down), depth
// `depth`, from the tile t0 + blockIdx.x on.  Flat tile index → tile: the
// first w tile rows form a triangle, each later row has w tiles.
__global__ void __launch_bounds__(kThreads, 2)
chol_syrk(float* __restrict__ A, const float* __restrict__ lt, int N, int depth,
          int ta, int w, int t0) {
  extern __shared__ __align__(16) float smem[];  // [kStages][2][kBK][kTile]
  const long long tri = (long long)w * (w + 1) / 2;
  long long t = t0 + blockIdx.x;
  int ir, jr;
  if (t < tri) {
    ir = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
    while ((long long)(ir + 1) * (ir + 2) / 2 <= t) ++ir;
    while ((long long)ir * (ir + 1) / 2 > t) --ir;
    jr = (int)(t - (long long)ir * (ir + 1) / 2);
  } else {
    t -= tri;
    ir = w + (int)(t / w);
    jr = (int)(t % w);
  }
  const int i0 = (ta + ir) * kTile, j0 = (ta + jr) * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // a warp covers 4 × 8 threads: 4 distinct A and 8 distinct B float4s
  // per depth step, one shared-memory wavefront each
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;

  auto load = [&](int stage, int k) {
    float* As = smem + stage * 2 * kBK * kTile;
    float* Bs = As + kBK * kTile;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int idx = tid + h * kThreads, q = idx / 32, c = (idx % 32) * 4;
      const float* src = lt + (size_t)(k + q) * N;
      cp_async16(As + q * kTile + c, src + i0 + c);
      cp_async16(Bs + q * kTile + c, src + j0 + c);
    }
  };

  const int nk = depth / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st * kBK);
    cp_async_commit();
  }
  float acc[8][8] = {};
  const int sm = sm_id();
  int diag_sm = -1;  // read one chunk ahead, so its latency hides under the FMAs
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    if (tid == 0)  // chol_diag on this SM: let it have the SM's issue slots
      while (diag_sm == sm) {
        __nanosleep(1000);
        diag_sm = *reinterpret_cast<volatile int*>(&g_diag_sm);
      }
    __syncthreads();  // chunk kt landed; every thread is done with chunk kt − 1
    if (kt + kStages - 1 < nk) load((kt + kStages - 1) % kStages, (kt + kStages - 1) * kBK);
    cp_async_commit();
    if (tid == 0) diag_sm = *reinterpret_cast<volatile int*>(&g_diag_sm);
    const float* As = smem + (kt % kStages) * 2 * kBK * kTile;
    const float* Bs = As + kBK * kTile;
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * kTile + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(As + k * kTile + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kTile + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * kTile + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int r = (u < 4 ? 0 : 64) + 4 * ty + u % 4;
    float* row = A + (size_t)(i0 + r) * N + j0;
    if (i0 != j0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4* p = reinterpret_cast<float4*>(row + h * 64 + 4 * tx);
        float4 x = *p;
        x.x -= acc[u][4 * h];
        x.y -= acc[u][4 * h + 1];
        x.z -= acc[u][4 * h + 2];
        x.w -= acc[u][4 * h + 3];
        *p = x;
      }
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int c = (v < 4 ? 0 : 64) + 4 * tx + v % 4;
        if (c <= r) row[c] -= acc[u][v];
      }
    }
  }
}

struct Side {
  cudaStream_t stream;
  cudaEvent_t entry, diag, next, panel;
  int err;
};

// The second stream (highest priority, not synchronising with the legacy
// default stream), its events and the kernels' shared-memory limits, made
// on the first call.
const Side& side() {
  static const Side s = [] {
    Side x{};
    int lo = 0, hi = 0;
    cudaError_t e = cudaDeviceGetStreamPriorityRange(&lo, &hi);
    if (e == cudaSuccess) e = cudaStreamCreateWithPriority(&x.stream, cudaStreamNonBlocking, hi);
    for (cudaEvent_t* ev : {&x.entry, &x.diag, &x.next, &x.panel})
      if (e == cudaSuccess) e = cudaEventCreateWithFlags(ev, cudaEventDisableTiming);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(chol_diag, cudaFuncAttributeMaxDynamicSharedMemorySize, kDiagSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(chol_panel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPanelSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(chol_syrk, cudaFuncAttributeMaxDynamicSharedMemorySize, kSyrkSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(chol_diag_update, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kUpdateSmem);
    x.err = static_cast<int>(e);
    return x;
  }();
  return s;
}

int wait(cudaStream_t st, cudaEvent_t ev) { return static_cast<int>(cudaStreamWaitEvent(st, ev, 0)); }
int record(cudaEvent_t ev, cudaStream_t st) { return static_cast<int>(cudaEventRecord(ev, st)); }

int diag(const Side& s, float* A, float* wbuf, int N, int k0) {
  chol_diag<<<1, kThreads, kDiagSmem, s.stream>>>(A, wbuf, N, k0, std::min(kPanel, N - k0));
  return algp_last_error();
}

// The panel below the strip at k0, if any, into lt; then `panel` is
// recorded on the side stream.
int panel(const Side& s, float* A, float* lt, const float* wbuf, int N, int k0) {
  const int rows = N - k0 - kPanel;
  if (rows > 0) {
    chol_panel<<<rows / kSub, kThreads, kPanelSmem, s.stream>>>(A, lt, wbuf, N, k0);
    const int err = algp_last_error();
    if (err != 0) return err;
  }
  return record(s.panel, s.stream);
}

// chol_syrk over the tiles [t0, t1) of tile columns ta … ta + w − 1.
int syrk(cudaStream_t st, float* A, const float* lt, int N, int depth, int ta, int w,
         long long t0, long long t1) {
  chol_syrk<<<(unsigned)(t1 - t0), kThreads, kSyrkSmem, st>>>(A, lt, N, depth, ta, w, (int)t0);
  return algp_last_error();
}

}  // namespace

// Scratch the caller provides: the strip's transposed panel, twice (one
// per stream), and the diagonal block's four 64 × 64 inverses.
ALGP_EXPORT int algp_chol_tile() { return kTile; }
ALGP_EXPORT long long algp_chol_lt_floats(int N) { return 2LL * kPanel * N; }
ALGP_EXPORT int algp_chol_w_floats() { return kPanel * kSub; }

// A: (N, N) row-major f32, N a multiple of algp_chol_tile(), overwritten
// by tril(L); lt: algp_chol_lt_floats(N) floats; wbuf: algp_chol_w_floats().
// Enqueued on `stream` (PyTorch's current stream): the side stream waits on
// an event recorded there at entry, and `stream` waits on the side
// stream's last panel before the call returns.  Returns the first CUDA
// error (a refused launch, an event call), else 0.
ALGP_EXPORT int algp_cholesky(float* A, float* lt, float* wbuf, int N, void* stream) {
  if (N <= 0 || N % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Side& s = side();
  if (s.err != 0) return s.err;
  cudaStream_t main = static_cast<cudaStream_t>(stream);
  const int T = N / kTile;
  float* lts[2] = {lt, lt + (size_t)kPanel * N};
  int err = record(s.entry, main);
  if (err == 0) err = wait(s.stream, s.entry);
  if (err == 0) err = diag(s, A, wbuf, N, 0);
  if (err == 0) err = panel(s, A, lts[0], wbuf, N, 0);
  for (int k0 = 0, p = 0; err == 0; k0 += kPanel, ++p) {
    err = wait(main, s.panel);
    const int k1 = k0 + std::min(kPanel, N - k0);
    if (err != 0 || k1 >= N) break;
    // lookahead: the next strip's columns first — its diagonal block, whose
    // factor then starts on the side stream, and the rows below it, which
    // its panel waits for — then the rest of the update on this stream
    const int depth = k1 - k0, ta = k1 / kTile, w = std::min(kPanel, N - k1) / kTile;
    const long long tri = (long long)w * (w + 1) / 2, next = tri + (long long)(T - ta - w) * w;
    const float* ltk = lts[p % 2];
    const int d64 = std::min(kPanel, N - k1) / kSub;  // the next block's 64-wide tiles
    chol_diag_update<<<d64 * (d64 + 1) / 2, kThreads, kUpdateSmem, main>>>(A, ltk, N, depth, k1);
    err = algp_last_error();
    if (err == 0) err = record(s.diag, main);
    if (err == 0) err = wait(s.stream, s.diag);
    if (err == 0) err = diag(s, A, wbuf, N, k1);
    if (err == 0 && next > tri) err = syrk(main, A, ltk, N, depth, ta, w, tri, next);
    if (err == 0) err = record(s.next, main);
    if (err == 0) err = wait(s.stream, s.next);
    if (err == 0) err = panel(s, A, lts[(p + 1) % 2], wbuf, N, k1);
    const int tb = ta + w, wr = T - tb;
    if (err == 0 && wr > 0) err = syrk(main, A, ltk, N, depth, tb, wr, 0, (long long)wr * (wr + 1) / 2);
  }
  return err;
}
