"""Field environment — row-structured grid with noisy sensing (the
counterpart of the synthetic, single-trait part of algp_tpu.field).

The latent truth is a GP draw made on the device: the Gram of the whole
grid from the CUDA kernel of `ops.gram`, an adaptive-jitter Cholesky, and
standard-normal draws.  With `synth_inducing` = M < n the draw is the
FITC one instead (`_synthesize_lowrank`): an exact sample of
N(0, Q + diag(k − q)) over M k-center inducing points, O(n·M²), which
makes the 100k-point grids possible.  The draws come from one
`torch.Generator` seeded with `cfg.seed`: the dense truth takes (n,) from
it; the FITC truth takes (M,) then (n,), in that order.  They cannot
equal the reference's `jax.random` draws, so the two packages' truths
differ; `draws` passes given draws instead (a test feeds the reference's).
Past `_SYNTH_CHUNK_BYTES` of (M, n) buffer the FITC draw streams the grid
in `_SYNTH_CHUNK`-point chunks, one Gram launch each, as the reference
does.  Everything else is host code, and the numpy generator
`default_rng(cfg.seed)` is called in the reference's order, so the
held-out split and the `collect` noise equal the reference's.

The env runs on the card unless the caller passes `device="cpu"`.  A
given `truth` (n,) replaces the draw, so a test can run both packages on
the reference's field (`convert.field_env_like`).

Not ported yet: phenotype tables, per-point features and feature warps,
and multiple traits; see ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from algp_tpu_torch.config import FieldConfig
from algp_tpu_torch.device import resolve_device
from algp_tpu_torch.ops import linalg as la
from algp_tpu_torch.ops.gram import gram_kernel
from algp_tpu_torch.ops.kernels import KernelSpec, gram, gram_diag

MODALITIES = ("precise", "cheap")

#: the FITC truth streams its grid in _SYNTH_CHUNK points once the (M, n)
#: K_zx buffer would pass _SYNTH_CHUNK_BYTES, as the reference does (a
#: solve's bits depend on its right-hand side's width, so the port draws
#: the reference's field only where it chunks alike)
_SYNTH_CHUNK_BYTES = 5 * 2**30
_SYNTH_CHUNK = 1 << 20


def _not_ported(what: str):
    return NotImplementedError(
        f"FieldEnv: {what} is not ported to algp_tpu_torch yet; see ROADMAP.md"
    )


@dataclasses.dataclass
class Sample:
    """A batch of collected measurements."""

    indices: np.ndarray  # (k,) grid indices
    y: np.ndarray  # (k,) noisy measurements
    noise_scale: np.ndarray  # (k,) variance multipliers vs base noise


class FieldEnv:
    """Row-structured field grid with a synthetic GP ground truth.

    Geometry: `num_rows` crop rows (y axis), each with `num_cols` ranges
    (x axis).  Grid index i ↔ (row, col) = divmod(i, num_cols); the map
    pose of a point is (col·col_spacing, row·row_spacing).  `X` (n, 2)
    f32 lives on `device` (the card when None); the truth `f` is a f64
    host array and `f_dev` its f32 device copy.
    """

    def __init__(self, cfg: FieldConfig, spec: Optional[KernelSpec] = None,
                 device=None, truth: Optional[np.ndarray] = None,
                 draws: Optional[tuple] = None):
        if not 0.0 <= cfg.trait_corr < 1.0:
            raise ValueError(
                f"trait_corr must be in [0, 1) (got {cfg.trait_corr})"
            )
        if not 0.0 < cfg.trait_obs_frac <= 1.0:
            raise ValueError(
                f"trait_obs_frac must be in (0, 1] (got {cfg.trait_obs_frac})"
            )
        if cfg.data_path is not None:
            raise _not_ported("a phenotype table (data_path)")
        if cfg.num_features:
            raise _not_ported("a field with features (num_features)")
        if cfg.feature_warp != "none":
            raise _not_ported("a feature warp")
        if cfg.num_traits > 1:
            raise _not_ported("a multi-trait field (num_traits)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_rows = cfg.num_rows
        self.num_cols = cfg.num_cols
        self.n = cfg.num_rows * cfg.num_cols
        self._rng = np.random.default_rng(cfg.seed)

        rows, cols = np.divmod(np.arange(self.n), cfg.num_cols)
        xy = np.stack(
            [cols * cfg.col_spacing, rows * cfg.row_spacing], axis=1
        ).astype(np.float32)
        self.X = torch.as_tensor(xy, device=self.device)
        if truth is None:
            self.f_dev = self._synthesize(spec, draws)
        else:
            truth = np.asarray(truth, np.float32)
            if truth.shape != (self.n,):
                raise ValueError(f"truth must be ({self.n},), got {truth.shape}")
            self.f_dev = torch.as_tensor(truth, device=self.device)
        self.f = self.f_dev.double().cpu().numpy()
        if not np.isfinite(self.f).all():
            # safe_cholesky exhausts its jitter ladder silently; a NaN
            # ground truth would poison every downstream metric
            raise ValueError(
                "synthetic field covariance failed to factor — kernel "
                f"config is pathological (ls_spatial={cfg.true_ls_spatial}, "
                f"outputscale={cfg.true_outputscale}, n={self.n})"
            )
        self.observed_mask = np.ones(self.n, bool)
        # held-out split for RMSE evaluation
        observed = np.flatnonzero(self.observed_mask)
        test = self._rng.permutation(observed)[: max(1, len(observed) // 5)]
        self.test_mask = np.zeros(self.n, bool)
        self.test_mask[test] = True

    def _synthesize(self, spec: Optional[KernelSpec], draws=None) -> torch.Tensor:
        """Draw the latent field (n,) f32 on the device from a GP with the
        config's true kernel (FITC with `synth_inducing` < n).  `draws`:
        the standard-normal draws to use, (z,) for the dense truth and
        (zm, zn) for the FITC one."""
        cfg = self.cfg
        if spec is None:
            spec = KernelSpec("rbf", "rbf", ds=2, df=0)
        if spec.df:
            raise _not_ported("a truth kernel with features")
        params = spec.init_params(
            ls_spatial=cfg.true_ls_spatial,
            ls_feature=cfg.true_ls_feature,
            outputscale=cfg.true_outputscale,
            noise=1.0,  # unused for sampling
            device=self.device,
        )
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)

        def normal(i, n):
            if draws is not None:
                return torch.tensor(np.asarray(draws[i], np.float32),
                                    device=self.device).reshape(n, 1)
            return torch.randn((n, 1), generator=gen, device=self.device)

        if cfg.synth_inducing and cfg.synth_inducing < self.n:
            return self._synthesize_lowrank(spec, params, normal)
        K = gram_kernel(spec, params, self.X, self.X)
        L, _ = la.safe_cholesky(K, initial_jitter=1e-5)
        del K
        return (L @ normal(0, self.n))[:, 0]

    def _synthesize_lowrank(self, spec, params, normal) -> torch.Tensor:
        """The FITC draw f = U·ε_M + √(k_diag − rowsum U²)·ε_n, U = K_xz L_zz⁻ᵀ
        over M k-center inducing points: an exact sample of
        N(0, Q + diag(k − q)), the family the low-rank planner conditions
        on.  K_zx (M, n) from the Gram kernel; L_zz by the host-reading
        adaptive-jitter factor (once per field).  Streamed in chunks of
        `_SYNTH_CHUNK` points past `_SYNTH_CHUNK_BYTES` of K_zx: the tail
        is padded with row 0 and zero draws, and the padding truncated."""
        from algp_tpu_torch.acquisition_lowrank import kcenter_indices

        m, n = min(self.cfg.synth_inducing, self.n), self.n
        z = self.X.index_select(0, kcenter_indices(self.X, m))
        eye = torch.eye(m, dtype=torch.float32, device=self.device)
        Kzz = gram(spec, params, z, z) + 1e-6 * float(self.cfg.true_outputscale) * eye
        Lzz, _ = la.safe_cholesky(Kzz, initial_jitter=1e-5)
        zm, zn = normal(0, m), normal(1, n)

        def draw(x, zn_x):
            Ut = la.solve_triangular(Lzz, gram_kernel(spec, params, z, x))  # (m, |x|)
            resid = torch.clamp_min(
                gram_diag(spec, params, x) - torch.sum(Ut * Ut, dim=0), 0.0)
            return (Ut.T @ zm + torch.sqrt(resid)[:, None] * zn_x)[:, 0]

        c = n if 4 * m * n <= _SYNTH_CHUNK_BYTES else min(_SYNTH_CHUNK, n)
        n_pad = (n + c - 1) // c * c
        x_pad = torch.cat([self.X, self.X[:1].expand(n_pad - n, self.X.shape[1])])
        zn_pad = torch.cat([zn, zn.new_zeros((n_pad - n, 1))])
        return torch.cat([draw(x_pad[i:i + c], zn_pad[i:i + c])
                          for i in range(0, n_pad, c)])[:n]

    # ------------------------------------------------------- index geometry

    def index_to_rowcol(self, i: int) -> tuple[int, int]:
        return divmod(int(i), self.num_cols)

    def rowcol_to_index(self, row: int, col: int) -> int:
        return int(row) * self.num_cols + int(col)

    def pose_of(self, i: int) -> tuple[float, float]:
        r, c = self.index_to_rowcol(i)
        return c * self.cfg.col_spacing, r * self.cfg.row_spacing

    # ------------------------------------------------------------- sensing

    def noise_std(self, modality: str = "precise") -> float:
        if modality not in MODALITIES:
            raise ValueError(f"unknown modality {modality!r}; use {MODALITIES}")
        mult = 1.0 if modality == "precise" else self.cfg.cheap_noise_mult
        return self.cfg.noise_std * mult

    def collect(self, indices, modality: str = "precise") -> Sample:
        """Simulate noisy measurements at grid indices.  `noise_scale` is
        the variance multiplier vs the precise modality."""
        idx = np.asarray(indices, np.int64).ravel()
        std = self.noise_std(modality)
        y = self.f[idx] + std * self._rng.standard_normal(idx.shape)
        scale = np.full(
            idx.shape,
            1.0 if modality == "precise" else self.cfg.cheap_noise_mult**2,
            np.float64,
        )
        return Sample(indices=idx, y=y, noise_scale=scale)

    @property
    def num_traits(self) -> int:
        return 1

    # ------------------------------------------------------------- metrics

    def rmse(self, mean, test_only: bool = False) -> float:
        """RMSE of a posterior mean field vs the latent truth (all cells,
        or only the held-out split with `test_only`)."""
        if isinstance(mean, torch.Tensor):
            mean = mean.detach().cpu().numpy()
        m = np.asarray(mean, np.float64)
        mask = self.test_mask if test_only else self.observed_mask
        return float(np.sqrt(np.mean((m[mask] - self.f[mask]) ** 2)))

    def calibration(self, mean, var, test_only: bool = False) -> dict:
        """Predictive calibration of a posterior (μ, σ²) field against the
        truth, masked as `rmse`, host f64: `nlpd` (mean negative log
        predictive density) and `cov90`/`cov95` (share of truth cells
        inside the central 90 % / 95 % interval).  σ² is floored at 1e-12."""
        m = np.asarray(mean, np.float64)
        v = np.maximum(np.asarray(var, np.float64), 1e-12)
        mask = self.test_mask if test_only else self.observed_mask
        d = m[mask] - self.f[mask]
        vm = v[mask]
        nlpd = 0.5 * np.mean(np.log(2.0 * np.pi * vm) + d * d / vm)
        z = np.abs(d) / np.sqrt(vm)
        return {
            "nlpd": float(nlpd),
            # central-interval half-widths: Φ⁻¹(0.95), Φ⁻¹(0.975)
            "cov90": float(np.mean(z <= 1.6448536269514722)),
            "cov95": float(np.mean(z <= 1.959963984540054)),
        }
