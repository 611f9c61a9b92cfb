"""Field environment — row-structured grid with noisy sensing (the
counterpart of algp_tpu.field).

A field is synthetic or a phenotype table.  The synthetic latent truth is
a GP draw made on the device: the Gram of the whole grid from the CUDA
kernel of `ops.gram` (the composite template when the field has
features), an adaptive-jitter Cholesky, and standard-normal draws.  With
`synth_inducing` = M < n the draw is the FITC one instead
(`_synthesize_lowrank`): an exact sample of N(0, Q + diag(k − q)) over M
k-center inducing points, O(n·M²), which makes the 100k-point grids
possible.  T = `num_traits` traits are T independent draws, mixed through
the Cholesky factor of the `trait_corr` equicorrelation matrix (trait 0
unchanged).  The draws come from one `torch.Generator` seeded with
`cfg.seed`: the dense truth takes (n, T) from it; the FITC truth takes
(M, T) then (n, T), in that order.  They cannot equal the reference's
`jax.random` draws, so the two packages' truths differ; `draws` passes
given draws instead (a test feeds the reference's).  Past
`_SYNTH_CHUNK_BYTES` of (M, n) buffer the FITC draw streams the grid in
`_SYNTH_CHUNK`-point chunks, one Gram launch each, as the reference does.

Everything else is host code.  The numpy generator `default_rng(cfg.seed)`
is called in the reference's order (the features, then the held-out
permutation, then the sensing noise), so features, split and `collect`
noise equal the reference's; the feature warp's projection comes from
`default_rng(seed + 7919)` and is computed on the host in numpy, as there.  A
table (`_load_table`) is read with the standard library's `csv` module.

The exception is `evaluate`, which scores a posterior field where it lies:
the truth and its masks go up to the device once per env
(`device_truth`), and the numbers are reduced there in f64.

The env runs on the card unless the caller passes `device="cpu"`.  A
given `truth` (n,) or (n, T) replaces the synthetic draw, so a test can
run both packages on the reference's field (`convert.field_env_like`).
"""

from __future__ import annotations

import csv
import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from algp_tpu_torch.config import FieldConfig
from algp_tpu_torch.device import resolve_device
from algp_tpu_torch.ops import linalg as la
from algp_tpu_torch.ops.gram import gram_kernel
from algp_tpu_torch.ops.kernels import KernelSpec, gram, gram_diag

MODALITIES = ("precise", "cheap")
FEATURE_WARPS = ("none", "tanh", "sin")

#: the numbers of `FieldEnv.evaluate`, in its order: `rmse` over the
#: ground-truth cells and the held-out split, the mean posterior variance
#: over the grid, then `calibration`'s and its held-out twins
EVALUATION = ("rmse", "rmse_test", "mean_var", "nlpd", "cov90", "cov95",
              "nlpd_test", "cov90_test", "cov95_test")


@dataclasses.dataclass(frozen=True)
class DeviceTruth:
    """The truth and its masks on the env's device: `f` the f64 truth of
    trait 0 (exact, as `FieldEnv.f`), `observed` / `test` the f32 0/1
    weights of `observed_mask` / `test_mask`, and their counts on the host."""

    f: torch.Tensor
    observed: torch.Tensor
    test: torch.Tensor
    n_observed: int
    n_test: int


#: the FITC truth streams its grid in _SYNTH_CHUNK points once the (M, n)
#: K_zx buffer would pass _SYNTH_CHUNK_BYTES, as the reference does (a
#: solve's bits depend on its right-hand side's width, so the port draws
#: the reference's field only where it chunks alike)
_SYNTH_CHUNK_BYTES = 5 * 2**30
_SYNTH_CHUNK = 1 << 20


@dataclasses.dataclass
class Sample:
    """A batch of collected measurements."""

    indices: np.ndarray  # (k,) grid indices
    y: np.ndarray  # (k,) noisy measurements
    noise_scale: np.ndarray  # (k,) variance multipliers vs base noise


class FieldEnv:
    """Row-structured field grid with a synthetic or table ground truth.

    Geometry: `num_rows` crop rows (y axis), each with `num_cols` ranges
    (x axis).  Grid index i ↔ (row, col) = divmod(i, num_cols); the map
    pose of a point is (col·col_spacing, row·row_spacing).  `X` = [pose |
    features] (n, 2 + df) f32 lives on `device` (the card when None);
    `traits` (n, T) is a f64 host array, `f` its column 0 (the planning
    trait) and `f_dev` that column's f32 device copy.  `observed_traits`
    (n, T) marks the cells with ground truth (all, but for a table's
    gaps); `observed_mask` is its column 0.  `device_truth()` holds the
    device copies that `evaluate` scores against.
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
        if cfg.data_path is not None:
            if truth is not None or draws is not None:
                raise ValueError("a table env reads its traits from the table")
            feats, traits = self._load_table(cfg.data_path)
            self.f_dev = torch.as_tensor(traits[:, 0].astype(np.float32),
                                         device=self.device)
        else:
            feats, truth_x = self._features(xy)
            if truth is None:
                traits_dev = self._synthesize(truth_x, spec, draws)
            else:
                truth = np.asarray(truth, np.float32)
                if truth.ndim not in (1, 2) or truth.shape[0] != self.n:
                    raise ValueError(f"truth must be ({self.n},) or ({self.n}, T), "
                                     f"got {truth.shape}")
                traits_dev = torch.as_tensor(truth.reshape(self.n, -1),
                                             device=self.device)
            traits = traits_dev.double().cpu().numpy()
            self.f_dev = traits_dev[:, 0].contiguous()
            if not np.isfinite(traits).all():
                # safe_cholesky exhausts its jitter ladder silently; a NaN
                # ground truth would poison every downstream metric
                raise ValueError(
                    "synthetic field covariance failed to factor — kernel "
                    f"config is pathological (ls_spatial={cfg.true_ls_spatial}, "
                    f"outputscale={cfg.true_outputscale}, n={self.n}, "
                    f"synth_inducing={cfg.synth_inducing})"
                )
            self.observed_traits = np.ones(traits.shape, bool)
            self.observed_mask = self.observed_traits[:, 0]
        self.features = feats  # (n, num_features) or (n, 0)
        self.X = torch.as_tensor(
            np.concatenate([xy, feats], axis=1) if feats.shape[1] else xy,
            device=self.device,
        )
        self.traits = traits
        self.f = traits[:, 0]
        # held-out split for RMSE evaluation (drawn from observed cells only)
        observed = np.flatnonzero(self.observed_mask)
        test = self._rng.permutation(observed)[: max(1, len(observed) // 5)]
        self.test_mask = np.zeros(self.n, bool)
        self.test_mask[test] = True
        self._device_truth = None

    # ------------------------------------------------------------------ init

    def _features(self, xy: np.ndarray):
        """The synthetic features (n, df) f32, drawn from the env rng before
        the held-out split, and the truth's inputs [xy | ψ(features)]: with
        a `feature_warp` the truth sees dz = max(1, df // 4) nonlinear
        factors of a random projection (host numpy, in the reference's
        order of operations) while the env exposes the raw features."""
        cfg, df = self.cfg, self.cfg.num_features
        if not df:
            return np.zeros((self.n, 0), np.float32), xy
        feats = self._rng.standard_normal((self.n, df)).astype(np.float32)
        truth_feats = feats
        if cfg.feature_warp != "none":
            if cfg.feature_warp not in FEATURE_WARPS:
                raise ValueError(
                    f"unknown feature_warp {cfg.feature_warp!r}; "
                    "use 'none', 'tanh' or 'sin'"
                )
            wrng = np.random.default_rng(cfg.seed + 7919)
            scale = 2.0 / np.sqrt(df)
            dz = max(1, df // 4)
            W1 = wrng.standard_normal((df, dz)).astype(np.float32) * scale
            b1 = wrng.standard_normal((dz,)).astype(np.float32)
            warp = np.tanh if cfg.feature_warp == "tanh" else np.sin
            truth_feats = warp(2.0 * (feats @ W1) + b1)
        # numpy promotes through `scale` (an f64 scalar): the warp is taken
        # in f64 and rounded to f32 here, as the reference rounds it
        return feats, np.concatenate([xy, truth_feats], axis=1).astype(np.float32)

    def _synthesize(self, x_np: np.ndarray, spec: Optional[KernelSpec],
                    draws=None) -> torch.Tensor:
        """Draw the latent traits (n, T) f32 on the device from a GP with the
        config's true kernel over the truth's inputs `x_np` (FITC with
        `synth_inducing` < n), mixed by `trait_corr`.  `draws`: the
        standard-normal draws to use, (z,) for the dense truth and (zm, zn)
        for the FITC one, each (·,) or (·, T)."""
        cfg = self.cfg
        if spec is None:
            spec = KernelSpec("rbf", "rbf", ds=2, df=cfg.num_features)
        dz = x_np.shape[1] - 2
        if dz != cfg.num_features:
            # the warp projects to dz latent factors: the truth kernel
            # samples over (xy, ψ) at feature width dz
            spec = KernelSpec(spatial_kind=spec.spatial_kind,
                              feature_kind=spec.feature_kind or "rbf",
                              ds=spec.ds, df=dz)
        params = spec.init_params(
            ls_spatial=cfg.true_ls_spatial,
            ls_feature=cfg.true_ls_feature,
            outputscale=cfg.true_outputscale,
            noise=1.0,  # unused for sampling
            device=self.device,
        )
        T = max(1, cfg.num_traits)
        x = torch.as_tensor(x_np, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)

        def normal(i, n):
            if draws is not None:
                return torch.tensor(np.asarray(draws[i], np.float32),
                                    device=self.device).reshape(n, T)
            return torch.randn((n, T), generator=gen, device=self.device)

        if cfg.synth_inducing and cfg.synth_inducing < self.n:
            td = self._synthesize_lowrank(spec, params, x, normal)
        else:
            K = gram_kernel(spec, params, x, x)
            L, _ = la.safe_cholesky(K, initial_jitter=1e-5)
            del K
            td = L @ normal(0, self.n)
        if T > 1 and cfg.trait_corr:
            # cross-trait correlation: mix the T independent draws through
            # the Cholesky factor of the equicorrelation matrix (the ICM's
            # generative family, B = R Rᵀ); its first row is e₀, so trait 0
            # is unchanged
            rho = np.full((T, T), cfg.trait_corr, np.float64)
            np.fill_diagonal(rho, 1.0)
            rt = np.linalg.cholesky(rho).T.astype(np.float32)
            td = td @ torch.as_tensor(rt, device=self.device)
        return td

    def _synthesize_lowrank(self, spec, params, x, normal) -> torch.Tensor:
        """The FITC draw f = U·ε_M + √(k_diag − rowsum U²)·ε_n, U = K_xz L_zz⁻ᵀ
        over M k-center inducing points of the truth's inputs `x`: an exact
        sample of N(0, Q + diag(k − q)), the family the low-rank planner
        conditions on.  K_zx (M, n) from the Gram kernel; L_zz by the
        host-reading adaptive-jitter factor (once per field).  Streamed in
        chunks of `_SYNTH_CHUNK` points past `_SYNTH_CHUNK_BYTES` of K_zx:
        the tail is padded with row 0 and zero draws, and the padding
        truncated."""
        from algp_tpu_torch.acquisition_lowrank import kcenter_indices

        m, n = min(self.cfg.synth_inducing, self.n), self.n
        z = x.index_select(0, kcenter_indices(x, m))
        eye = torch.eye(m, dtype=torch.float32, device=self.device)
        Kzz = gram(spec, params, z, z) + 1e-6 * float(self.cfg.true_outputscale) * eye
        Lzz, _ = la.safe_cholesky(Kzz, initial_jitter=1e-5)
        zm, zn = normal(0, m), normal(1, n)

        def draw(xc, zn_x):
            Ut = la.solve_triangular(Lzz, gram_kernel(spec, params, z, xc))  # (m, |x|)
            resid = torch.clamp_min(
                gram_diag(spec, params, xc) - torch.sum(Ut * Ut, dim=0), 0.0)
            return Ut.T @ zm + torch.sqrt(resid)[:, None] * zn_x

        c = n if 4 * m * n <= _SYNTH_CHUNK_BYTES else min(_SYNTH_CHUNK, n)
        n_pad = (n + c - 1) // c * c
        x_pad = torch.cat([x, x[:1].expand(n_pad - n, x.shape[1])])
        zn_pad = torch.cat([zn, zn.new_zeros((n_pad - n, zn.shape[1]))])
        return torch.cat([draw(x_pad[i:i + c], zn_pad[i:i + c])
                          for i in range(0, n_pad, c)])[:n]

    def _load_table(self, path: str):
        """Load a phenotype table: CSV with `row`, `range`, value columns
        (`value_cols`, default `height`, else the one non-feature column),
        and optional feature columns (`feat_*`).  Rows outside the grid are
        dropped with a warning; a missing value is a gap of its trait.
        Gaps are mean-imputed per trait (they condition the GP but are no
        truth: `observed_traits` excludes them), then every trait is
        standardised (std at ddof 0, plus 1e-12).  Returns (features,
        traits); sets `observed_traits`, `observed_mask`, `_y_mean` and
        `_y_std`."""
        with open(path, newline="") as fh:
            reader = csv.reader(fh)
            columns = next(reader)
            body = list(reader)
        cells = {c: [r[i] for r in body] for i, c in enumerate(columns)}
        need = {"row", "range"}
        if not need.issubset(columns):
            raise ValueError(f"table must have columns {need}, got {columns}")
        if self.cfg.value_cols:
            value_cols = list(self.cfg.value_cols)
            missing = [c for c in value_cols if c not in columns]
            if missing:
                raise ValueError(f"value_cols {missing} not in table columns "
                                 f"{columns}")
        elif "height" in columns:
            value_cols = ["height"]
        else:
            # never guess: a feat_* column taken as the truth would serve as
            # both the field and a GP input feature
            candidates = [c for c in columns if c not in ("row", "range")
                          and not c.startswith("feat_")]
            if len(candidates) != 1:
                raise ValueError(
                    "table has no 'height' column and the value column is "
                    "ambiguous — pass FieldConfig.value_cols (non-feature "
                    f"candidates: {candidates})"
                )
            value_cols = candidates

        def floats(col):
            return np.array([float(v) if v.strip() else np.nan
                             for v in cells[col]], np.float64)

        feat_cols = [c for c in columns if c.startswith("feat_")]
        feats = np.zeros((self.n, len(feat_cols)), np.float32)
        rows_v = np.array([int(v) for v in cells["row"]], np.int64)
        cols_v = np.array([int(v) for v in cells["range"]], np.int64)
        # per axis: a range ≥ num_cols would otherwise wrap into the next
        # row's cells
        valid = ((rows_v >= 0) & (rows_v < self.num_rows)
                 & (cols_v >= 0) & (cols_v < self.num_cols))
        dropped = int((~valid).sum())
        if dropped:
            warnings.warn(
                f"{dropped} table rows fall outside the "
                f"{self.num_rows}x{self.num_cols} grid and were dropped"
            )
        idx = rows_v * self.num_cols + cols_v
        traits = np.full((self.n, len(value_cols)), np.nan)
        for t, col in enumerate(value_cols):
            traits[idx[valid], t] = floats(col)[valid]
        if feat_cols:
            table_feats = np.stack([floats(c) for c in feat_cols], axis=1)
            feats[idx[valid]] = table_feats.astype(np.float32)[valid]
        # per-trait observation masks: a plot may have height but no width
        self.observed_traits = ~np.isnan(traits)
        self.observed_mask = self.observed_traits[:, 0]
        mu = np.nanmean(traits, axis=0)
        traits = np.where(np.isnan(traits), mu, traits)
        self._y_mean = traits.mean(axis=0)
        self._y_std = traits.std(axis=0) + 1e-12
        return feats, (traits - self._y_mean) / self._y_std

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
        return self.traits.shape[1]

    def collect_traits(self, indices, modality: str = "precise"):
        """Noisy measurements of all traits at `indices`: (idx, Y, scale,
        obs), Y (k, T).  With `trait_obs_frac` < 1 each secondary trait
        (t ≥ 1) is measured only with that probability (trait 0 always):
        `obs` (k, T) marks the measured cells and the others are NaN in Y.
        The Bernoulli draw rides the env rng after the noise, and is
        skipped at 1.0, as in the reference."""
        idx = np.asarray(indices, np.int64).ravel()
        std = self.noise_std(modality)
        Y = self.traits[idx] + std * self._rng.standard_normal(
            (len(idx), self.num_traits)
        )
        scale = np.full(
            idx.shape,
            1.0 if modality == "precise" else self.cfg.cheap_noise_mult**2,
            np.float64,
        )
        frac = self.cfg.trait_obs_frac
        obs = np.ones((len(idx), self.num_traits), bool)
        if self.num_traits > 1 and frac < 1.0:
            obs[:, 1:] = (
                self._rng.uniform(size=(len(idx), self.num_traits - 1)) < frac
            )
            Y = np.where(obs, Y, np.nan)
        return idx, Y, scale, obs

    # ------------------------------------------------------------- metrics

    def rmse(self, mean, test_only: bool = False) -> float:
        """RMSE of a posterior mean field vs the latent truth over the cells
        with ground truth (a table's imputed cells excluded), or only the
        held-out split with `test_only`."""
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

    def device_truth(self) -> DeviceTruth:
        """The truth and its masks on the env's device, built on first use
        without waiting for the device (the masks go up as bytes and are
        widened there)."""
        if self._device_truth is None:
            def up(a, dtype):
                # a pageable upload is staged before the call returns
                return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                    self.device, non_blocking=True)

            def weights(mask):
                return up(mask, bool).to(torch.float32)

            self._device_truth = DeviceTruth(
                f=up(self.f, np.float64),
                observed=weights(self.observed_mask), test=weights(self.test_mask),
                n_observed=int(self.observed_mask.sum()),
                n_test=int(self.test_mask.sum()),
            )
        return self._device_truth

    def evaluate(self, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
        """`rmse` and `calibration` of a posterior (μ, σ²) field, both
        masks, and its mean variance, reduced where the (n,) tensors lie
        (the env's device) in f64 without a host read: a (9,) f64 tensor
        in `EVALUATION`'s order.  The same formulas as the host methods,
        the masks applied as 0/1 weights over their host-known counts."""
        t = self.device_truth()
        v = var.double()
        vf = torch.clamp_min(v, 1e-12)
        d = mean.double() - t.f
        d2 = d * d
        z = torch.abs(d) / torch.sqrt(vf)
        terms = torch.stack([
            d2, torch.log(2.0 * np.pi * vf) + d2 / vf,
            # central-interval half-widths: Φ⁻¹(0.95), Φ⁻¹(0.975)
            (z <= 1.6448536269514722).double(), (z <= 1.959963984540054).double(),
        ])
        obs = torch.sum(terms * t.observed, dim=1) / t.n_observed
        test = torch.sum(terms * t.test, dim=1) / t.n_test
        return torch.cat([
            torch.sqrt(obs[:1]), torch.sqrt(test[:1]), torch.mean(v).reshape(1),
            0.5 * obs[1:2], obs[2:], 0.5 * test[1:2], test[2:],
        ])

    def rmse_traits(self, means, test_only: bool = False) -> list[float]:
        """Per-trait RMSE of posterior mean fields `means` (n, T), each
        trait over its own observation mask."""
        M = np.asarray(means, np.float64)
        out = []
        for t in range(self.traits.shape[1]):
            mask = self.observed_traits[:, t]
            if test_only:
                mask = mask & self.test_mask
            d = M[mask, t] - self.traits[mask, t]
            out.append(float(np.sqrt(np.mean(d * d))))
        return out
