"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes that a piece of the work needs, counted from its shapes.

Counts follow the plain algorithm (`portbench/reference`), not whatever
the program happens to launch: each input byte is read once, each output
byte written once, and a triangular factor or inverse costs its
triangular count.  Terms under 1 % of a call's total are left out where a
metric's own file says so.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12  # FP32 outside the tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12
F32 = 4  # bytes


def cholesky_flops(n: int) -> float:
    """n³/3: the multiply-adds of a dense Cholesky, counted as flops."""
    return n ** 3 / 3.0


def tri_inv_flops(n: int) -> float:
    """n³/3: the inverse of a lower-triangular n × n factor."""
    return n ** 3 / 3.0


def gemm_flops(m: int, k: int, n: int) -> float:
    """2mkn: a dense (m, k) @ (k, n) product."""
    return 2.0 * m * k * n


def gram_entry_flops(dim: int) -> int:
    """Flops of one stationary kernel entry over `dim` coordinates: a
    scaled difference, its square and the sum (3 a coordinate), then the
    form and the outputscale (4, the exponential counted as one)."""
    return 3 * dim + 4


def gram_flops(n1: int, n2: int, dim: int) -> float:
    return float(n1) * n2 * gram_entry_flops(dim)


def gram_bytes(n1: int, n2: int, dim: int, noise: bool = False) -> float:
    """f32 bytes a Gram block needs: both coordinate sets read once, the
    (n1, n2) output written once, and a noise vector of n1 where the
    diagonal takes one."""
    return F32 * (float(n1) * dim + float(n2) * dim + float(n1) * n2
                  + (n1 if noise else 0))


def roofline_bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound at the data sheet's peaks."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def greedy_mi_flops(n: int, num_pilot: int, rounds: int) -> dict:
    """The greedy Krause-MI selection over n candidates after `num_pilot`
    pilots: the exact seed (the factor of K + Σ and its triangular
    inverse), the Gram entries it needs, the pilots' removal from the
    precision (P[:, A] = Wᵀ W[:, A]) and one precision column a round
    (Wᵀ W[:, j], triangular: n² flops).  Left out, each under 1 % at the
    main path's sizes: the pilots' cross-Gram and conditioning
    (O(m·n·m)), the rounds' posterior columns and Schur terms (O(n·T) a
    round) and diag(WᵀW) (n²)."""
    return {
        "cholesky": cholesky_flops(n),
        "tri_inv": tri_inv_flops(n),
        "gram": gram_flops(n, n, 2),
        "pilot_delete": gemm_flops(n, n, num_pilot),
        "precision_columns": float(rounds) * n * n,
    }


def adam_fit_flops(n: int, restarts: int, iters: int) -> float:
    """An Adam fit of an exact GP on n points: per restart and step the
    factor (n³/3), two triangular solves (2n²) and a backward pass of
    about twice that."""
    return 3.0 * restarts * (iters + 1) * (n ** 3 / 3.0 + 2.0 * n * n)


def episode_flops(n: int, m_inducing: int, n_design: int, samples: list,
                  seeds: int = 1, fits: list = ()) -> float:
    """One informative-path episode over n candidates with the low-rank
    planner: its k-center design over n_design points (4 flops a point a
    round), each low-rank seed (one a fit: the (M, n) Gram entries,
    L_zz⁻¹ K_zx: M²n, the M × M accumulation of B: 2M²n), each fit
    (`fits`: (points, restarts, steps)) and for each posterior pass with
    m samples (`samples`) the conditioning (the (m, n) Gram, the
    triangular solve m²n, the mean and variance 4mn)."""
    M = m_inducing
    seed = gram_flops(M, n, 2) + 3.0 * M * M * n
    plans = sum(gram_flops(m, n, 2) + float(m) * m * n + 4.0 * m * n for m in samples)
    return (4.0 * M * n_design + seeds * seed + plans
            + sum(adam_fit_flops(k, r, t) for k, r, t in fits))
