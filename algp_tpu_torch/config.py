"""Typed configuration (the counterpart of algp_tpu.config).

Copied as frozen dataclasses because algp_tpu.config imports JAX.  Only
the two configs the main path reads are here; the presets, the other
configs and the `resolve_*` functions are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Hyperparameter fitting: optimizer on the negative MLL."""

    optimizer: str = "adam"  # "adam" ("lbfgs" is not ported yet)
    learning_rate: float = 0.05
    iters: int = 150
    restarts: int = 4
    perturb: float = 0.5  # log-space init spread across restarts
    init_ls_spatial: float = 1.0
    init_ls_feature: float = 1.0
    init_outputscale: float = 1.0
    init_noise: float = 0.1
    learn_noise: bool = True
    min_noise: float = 1e-3  # floor on noise std for f32 conditioning
    jitter: float = 1e-6
    # The fields below are read only by paths that are not ported yet
    # (sparse refits, warm refits, multi-trait fits); they are kept so a
    # config built for the reference builds here too.
    sparse_threshold: int = 0
    sparse_inducing: int = 256
    refit_iters: int = 0
    refit_restarts: int = 0
    multi_fit: str = "independent"
    icm_rank: int = 1


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Row-structured field environment.  Only the synthetic,
    single-trait field without features is ported (field.py)."""

    num_rows: int = 25
    num_cols: int = 40
    num_features: int = 0
    row_spacing: float = 1.0
    col_spacing: float = 1.0
    true_ls_spatial: float = 4.0
    true_ls_feature: float = 1.0
    true_outputscale: float = 1.0
    noise_std: float = 0.1  # precise-sensor noise std
    cheap_noise_mult: float = 5.0  # cheap/noisy modality multiplier
    data_path: Optional[str] = None
    synth_inducing: int = 0
    num_traits: int = 1
    value_cols: Optional[tuple] = None
    trait_obs_frac: float = 1.0
    trait_corr: float = 0.0
    feature_warp: str = "none"
    seed: int = 0

    @property
    def num_points(self) -> int:
        return self.num_rows * self.num_cols
