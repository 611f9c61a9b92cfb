// Gram matrix K(X1, X2) = s² · k_sp(r²_sp) · k_ft(r²_ft), f32, straight to
// device memory.  The templates are in gram.cuh; this file instantiates
// the spatial-only ones and exports the launch, and gram_composite_rbf.cu,
// gram_composite_matern32.cu and gram_composite_matern52.cu instantiate
// the composite ones of each spatial kind (≈ 90 instances each, built in
// parallel).
//
// Replaces: algp_tpu/ops/gram.py `_gram_kernel_spatial` (by `gram_kernel`)
// and `_gram_kernel_composite` (by `composite_kernel`), the Pallas bodies
// behind `gram_pallas`, whose `pl.pallas_call` is at gram.py:158.
//
// Spatial-only, bound on an H100: the bytes, with the issued instructions
// close behind.  The output is n1·n2·4 bytes (512 × 2²⁰ → 2.1 GB, 0.64 ms
// at 3.35 TB/s) and the inputs a few coordinates a row.  But each output
// also costs its IEEE arithmetic (the differences, the `_rn` products and
// sums, and for Matérn a correctly rounded sqrtf and expf): the hot loop
// issues 33 SASS instructions a Matérn 3/2 output and 17 an RBF one
// (`tools/gram_profile.py` counts them from cuobjdump; the earlier
// shared-tile design issued 66 a Matérn output).  At 33 the arithmetic
// alone takes ≈ 90 % of the time the stores alone take, so any
// instruction that is not the math (shared-memory reads, address
// arithmetic, narrow stores, a block's prologue and barrier) pushes the
// kernel off the bytes bound.
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
// shared memory (`tools/gram_variants.cu`).  A width outside {1, 2, 3}
// reads its coordinates per output from global memory (L1-resident) in a
// runtime loop.  n2 % 4 ≠ 0 (rows not 16-byte aligned) takes the same
// loop with 4-byte stores.  Offsets into the output are 64-bit (512 × 2²²
// = 2³¹ outputs).
//
// Composite, bound on an H100: the issued instructions.  An output costs
// two closed forms (Matérn 5/2 × RBF on the feature paths: two expf, a
// sqrtf and a correctly rounded ÷3) and ds + df differences, ≈ 60 SASS
// instructions, against the ≈ 17 at which the spatial kernel meets the
// bytes bound.  So the design keeps every instruction that is not the math
// out of the hot loop.  The stores are the spatial kernel's, the tiles 16
// rows tall (8 rows measured ≈ 2 % slower on the H100); both segments'
// widths are template parameters (DS ∈ {1, 2, 3}; DF ∈
// {1, 2, 3, 4}, and 8 for df = 5..8 with a zero tail), so a point's
// ds + df coordinates live in registers.  The inputs arrive unscaled, with
// the inverse lengthscales: a block stages its rows' coordinates, scaled,
// in shared memory (one barrier), a thread scales its 4 columns' once, and
// the row loop reads a row with one or two 16-byte shared loads that every
// lane shares.  No global load per output (the earlier design, kept in
// tools/gram_variants.cu, read every coordinate of both points per
// output).  ds > 3 or df > 8 take a runtime loop that reads and scales
// the coordinates per output.
//
// Numerics mirror the plain PyTorch version (ops/kernels.gram): the inputs
// are scaled by exp(-log_ls) with one IEEE product a coordinate (by the
// wrapper for the spatial kernel, by `__fmul_rn` here for the composite:
// the same bits), r² is the direct difference sum Σ_k (a_k − b_k)² in
// coordinate order, the closed forms are those of `stationary_form`
// (Matérn takes √max(r², 1e-20)), and the composite is s · (k_sp · k_ft).
// The `_rn` intrinsics keep nvcc from contracting these into FMAs;
// expf/sqrtf are IEEE (no fast math).  The spatial kernel is bitwise the
// plain version for RBF and Matérn 3/2; Matérn 5/2's ÷3 and the plain
// version's summation order keep the composite within 2e-6·s².

#include "gram.cuh"

namespace {

template <int SK>
int launch_spatial_ds(const float* x1s, const float* x2s, const float* scale, float* out,
                      int n1, int n2, int ds, cudaStream_t st) {
  // the spatial width as a template parameter where one fits
  if (rows_vectorisable(n2, out, x2s)) {
    switch (ds) {
      case 1: return launch_spatial<SK, 1, true>(x1s, x2s, scale, out, n1, n2, ds, kRows, st);
      case 2: return launch_spatial<SK, 2, true>(x1s, x2s, scale, out, n1, n2, ds, kRows, st);
      case 3: return launch_spatial<SK, 3, true>(x1s, x2s, scale, out, n1, n2, ds, kRows, st);
      default: return launch_spatial<SK, 0, true>(x1s, x2s, scale, out, n1, n2, ds, kRows, st);
    }
  }
  switch (ds) {
    case 1: return launch_spatial<SK, 1, false>(x1s, x2s, scale, out, n1, n2, ds, kRows, st);
    case 2: return launch_spatial<SK, 2, false>(x1s, x2s, scale, out, n1, n2, ds, kRows, st);
    case 3: return launch_spatial<SK, 3, false>(x1s, x2s, scale, out, n1, n2, ds, kRows, st);
    default: return launch_spatial<SK, 0, false>(x1s, x2s, scale, out, n1, n2, ds, kRows, st);
  }
}

}  // namespace

// x1 (n1, ds + df), x2 (n2, ds + df): f32 rows, contiguous.  sk, fk: 0
// rbf, 1 matern32, 2 matern52.  fk = -1: a spatial-only kernel; x1, x2
// come scaled by the inverse lengthscales, inv is ignored (may be null),
// and so is df.  fk ≥ 0: a composite; x1, x2 are unscaled and inv holds
// the ds + df inverse lengthscales (spatial, then feature) by which the
// kernel scales them.  Returns cudaGetLastError.
ALGP_EXPORT int algp_gram(const float* x1, const float* x2, const float* inv,
                          const float* scale, float* out, int n1, int n2, int ds, int df,
                          int sk, int fk, void* stream) {
  if (n1 < 1 || n2 < 1 || ds < 1 || (fk != kNone && (df < 1 || inv == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fk == kNone) {
    switch (sk) {
      case kRbf: return launch_spatial_ds<kRbf>(x1, x2, scale, out, n1, n2, ds, st);
      case kMatern32: return launch_spatial_ds<kMatern32>(x1, x2, scale, out, n1, n2, ds, st);
      case kMatern52: return launch_spatial_ds<kMatern52>(x1, x2, scale, out, n1, n2, ds, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (sk) {
    case kRbf: return algp_gram_composite_rbf(fk, x1, x2, inv, scale, out, n1, n2, ds, df, st);
    case kMatern32:
      return algp_gram_composite_matern32(fk, x1, x2, inv, scale, out, n1, n2, ds, df, st);
    case kMatern52:
      return algp_gram_composite_matern52(fk, x1, x2, inv, scale, out, n1, n2, ds, df, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

ALGP_EXPORT const char* algp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
