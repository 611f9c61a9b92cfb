"""Typed configuration (the counterpart of algp_tpu.config).

Copied as frozen dataclasses because algp_tpu.config imports JAX.  The
field names and defaults equal the reference's, so a config built for
one builds for the other.  The presets are the reference's for the
configurations the port runs: c1-c4, the config-5 episode at reference
scale (`c5_episode`), at the 10 000-point north-star grid (`c5_10k`),
past the exact planner's range with the low-rank planner and the FITC
truth (`c5_20k`, `c5_100k`), as a long campaign with SGPR refits
(`c5_long`), and the million-point regime (`c5_1m`, the 2048 × 2048
`c5_4m`, `c5_1m_long`), whose solves go through an explicit inverse past
2²⁰ candidates, and the real-table experiment (`c10_table`, the
phenotype CSV in `data/`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from algp_tpu_torch.ops.kernels import KernelSpec

_SAMPLE_TABLE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "sample_field.csv",
)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Hyperparameter fitting: optimizer on the negative MLL."""

    optimizer: str = "adam"  # "adam" | "lbfgs"
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
    # Episode-scale SGPR refits (models/sparse_gp): once the sampled set
    # exceeds sparse_threshold, refits use the collapsed −ELBO over
    # sparse_inducing k-center points.  0 disables; needs
    # sparse_threshold ≥ sparse_inducing.
    sparse_threshold: int = 0
    sparse_inducing: int = 256
    # Warm refits: after the pilot fit, restart 0 starts from the
    # incumbent params and the refit runs refit_iters steps over
    # refit_restarts inits (0 keeps the full-fit value; models.gp.refit_cfg).
    refit_iters: int = 0
    refit_restarts: int = 0
    # Multi-trait model family (MULTI_FITS): "independent" per-trait exact
    # GPs, or "icm", the coregionalized joint GP (models/coregional) with
    # a trait covariance B = A Aᵀ + diag κ, A of rank icm_rank.
    multi_fit: str = "independent"
    icm_rank: int = 1


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Architecture of the deep-kernel feature embedding φ: df → hidden* →
    out (models/networks.py)."""

    hidden: tuple = (16,)
    out: int = 4
    # tanh keeps the embedding bounded, so the feature lengthscales stay in
    # a sane range
    activation: str = "tanh"
    # L2 penalty on the weight matrices added to the −MLL (without it the
    # embedding can game the marginal likelihood); 0 = off
    weight_decay: float = 0.0

    def dims(self, df: int) -> list:
        return [df, *self.hidden, self.out]


#: planner auto-selection thresholds (resolve_num_inducing /
#: resolve_strategy), the reference's values, measured on its TPU and not
#: re-measured on the H100 yet (ROADMAP.md)
_EXACT_MAX_N = 16384
_LOWRANK_M_SMALL, _LOWRANK_M_LARGE = 1024, 512
_LOWRANK_M_CAP_N = 1 << 19
_MI_SMALL_MAX_N = 2500

#: canonical path-utility names (acquisition.path_set_argmax's cost models)
PATH_UTILITIES = ("per_cost", "per_sample")

#: canonical multi-trait model-family names (FitConfig.multi_fit)
MULTI_FITS = ("independent", "icm")


def resolve_strategy(
    strategy: str, n: int, path_utility: str = "per_cost"
) -> tuple:
    """Resolve `AcquisitionConfig.strategy` against the candidate count:
    "auto" picks MI at grids ≤ 2 500 points, entropy through the exact
    planner's range (≤ 16 384) and yield-aware mi:per_sample above it;
    an explicit strategy and the configured utility are kept.  Returns
    (strategy, path_utility)."""
    if path_utility not in PATH_UTILITIES:
        raise ValueError(
            f"unknown path_utility {path_utility!r}; use {PATH_UTILITIES}"
        )
    if strategy != "auto":
        return strategy, path_utility
    if n <= _MI_SMALL_MAX_N:
        return "mi", path_utility
    if n <= _EXACT_MAX_N:
        return "entropy", path_utility
    return "mi", "per_sample"


def resolve_num_inducing(num_inducing: Optional[int], n: int) -> int:
    """Resolve `AcquisitionConfig.num_inducing` against the candidate
    count: None picks the exact implicit precision (0) up to 16 384
    candidates and the low-rank planner above (M = 1 024, or 512 past
    2¹⁹); an explicit value is kept."""
    if num_inducing is not None:
        return num_inducing
    if n <= _EXACT_MAX_N:
        return 0
    if n <= _LOWRANK_M_CAP_N:
        return _LOWRANK_M_SMALL
    return _LOWRANK_M_LARGE


@dataclasses.dataclass(frozen=True)
class AcquisitionConfig:
    """Greedy active sampling and the episode's planner."""

    # "mi" | "entropy" | "uniform" | "naive" | "auto" (resolve_strategy)
    strategy: str = "mi"
    rounds: int = 50  # greedy rounds (greedy mode)
    # None = auto (resolve_num_inducing); 0 = the exact N×N implicit
    # precision; M > 0 = the low-rank planner (acquisition_lowrank)
    num_inducing: Optional[int] = None
    # "per_cost" | "per_sample" (acquisition.path_set_argmax)
    path_utility: str = "per_cost"
    # z-ensemble MI of the low-rank planner: K > 1 averages the MI scores
    # of K k-center design variants (distinct start points); 1 = off
    mi_ensemble: int = 1


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Row-structured field environment (field.py): a synthetic GP truth
    (FITC with synth_inducing > 0) or a phenotype table (data_path), with
    per-point features and one or more traits."""

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


@dataclasses.dataclass(frozen=True)
class EpisodeConfig:
    """Informative-path episode orchestration (episode.Agent)."""

    num_pilot: int = 32  # pilot-survey samples
    budget: float = 200.0  # total path budget
    num_waypoints: int = 8  # paths per replan: the budget slice is budget/this
    samples_per_step: int = 10
    # minimum path cost as a fraction of the budget slice
    # (planning.enumerate_paths)
    min_cost_frac: float = 0.5
    # ordered grid indices the robot must visit (goal-conditioned
    # enumeration); None = free enumeration
    waypoint_goals: Optional[tuple] = None
    refit_every: int = 1  # refit the hyperparameters every k steps
    # "precise" | "cheap" | "mixed" (one precise sample at the path's
    # highest-variance site, cheap elsewhere)
    modality: str = "precise"
    # per-step metrics reduced on the device (None = auto, on from
    # 16 384 points)
    device_metrics: Optional[bool] = None
    # static sample capacity; None = derived from the budget (episode.Agent)
    max_samples: Optional[int] = None
    # consume each refit one plan later (its fit overlaps the next step)
    lagged_refit: bool = False
    # stop instead of growing the capacity
    hard_cap: bool = False
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    kernel: KernelSpec = KernelSpec()
    fit: FitConfig = FitConfig()
    acquisition: AcquisitionConfig = AcquisitionConfig()
    field: FieldConfig = FieldConfig()
    episode: EpisodeConfig = EpisodeConfig()
    # deep feature kernel: a learned MLP embedding of the feature columns
    deep: Optional[MLPSpec] = None


PRESETS: dict[str, ExperimentConfig] = {
    # 1. Exact GP, RBF, synthetic 2-D field (~1k pts): MLL fit + posterior.
    "c1_rbf_fit": ExperimentConfig(
        kernel=KernelSpec(spatial_kind="rbf", ds=2, df=0),
        field=FieldConfig(num_rows=25, num_cols=40),
        fit=FitConfig(restarts=1),
    ),
    # 2. Matérn + composite spatial×feature, multi-restart fit.
    "c2_composite_restarts": ExperimentConfig(
        kernel=KernelSpec(spatial_kind="matern52", feature_kind="rbf", ds=2, df=3),
        field=FieldConfig(num_rows=25, num_cols=40, num_features=3),
        fit=FitConfig(restarts=4, optimizer="adam"),
    ),
    # 3. Greedy entropy-based active sampling, 50 rounds.
    "c3_entropy": ExperimentConfig(
        kernel=KernelSpec(spatial_kind="rbf", ds=2, df=0),
        field=FieldConfig(num_rows=25, num_cols=40),
        acquisition=AcquisitionConfig(strategy="entropy", rounds=50),
    ),
    # 4. Krause-MI acquisition.
    "c4_mi": ExperimentConfig(
        kernel=KernelSpec(spatial_kind="rbf", ds=2, df=0),
        field=FieldConfig(num_rows=25, num_cols=40),
        acquisition=AcquisitionConfig(strategy="mi", rounds=50),
    ),
    # 5. Full informative-path episode with heteroscedastic noise.
    "c5_episode": ExperimentConfig(
        kernel=KernelSpec(spatial_kind="matern32", ds=2, df=0),
        field=FieldConfig(num_rows=25, num_cols=40),
        acquisition=AcquisitionConfig(strategy="mi"),
        episode=EpisodeConfig(num_pilot=32, budget=200.0),
    ),
    # 5 at north-star scale: the 100×100 = 10k-point grid through the full
    # path episode, exact MI planner, warm refits every 4 steps.
    "c5_10k": ExperimentConfig(
        kernel=KernelSpec(spatial_kind="matern32", ds=2, df=0),
        field=FieldConfig(num_rows=100, num_cols=100, true_ls_spatial=8.0),
        acquisition=AcquisitionConfig(strategy="mi"),
        fit=FitConfig(refit_iters=60, refit_restarts=2),
        episode=EpisodeConfig(num_pilot=64, budget=400.0, num_waypoints=8,
                              samples_per_step=10, refit_every=4),
    ),
    # 5 at 2× north-star scale (140×140 = 19.6k points): past the exact
    # range, so num_inducing=None resolves to the low-rank planner, M = 1024
    # (--num-inducing 0 forces the exact one).
    "c5_20k": ExperimentConfig(
        kernel=KernelSpec(spatial_kind="matern32", ds=2, df=0),
        field=FieldConfig(num_rows=140, num_cols=140, true_ls_spatial=11.0),
        acquisition=AcquisitionConfig(strategy="mi"),
        fit=FitConfig(refit_iters=60, refit_restarts=2),
        episode=EpisodeConfig(num_pilot=64, budget=560.0, num_waypoints=8,
                              samples_per_step=10, refit_every=4),
    ),
    # 5 at 10× north-star scale (320×320 = 102 400 points): FITC truth over
    # 2 048 k-center points, the low-rank MI planner with M = 1 024, warm
    # refits 100 × 3.
    "c5_100k": ExperimentConfig(
        kernel=KernelSpec(spatial_kind="matern32", ds=2, df=0),
        field=FieldConfig(num_rows=320, num_cols=320, true_ls_spatial=25.0,
                          synth_inducing=2048),
        acquisition=AcquisitionConfig(strategy="mi", num_inducing=1024),
        fit=FitConfig(refit_iters=100, refit_restarts=3),
        episode=EpisodeConfig(num_pilot=128, budget=1280.0, num_waypoints=8,
                              samples_per_step=10, refit_every=4),
    ),
    # 5 as a long campaign on the 10k grid (~160 planning steps, ~1.7k
    # samples): past 512 sampled points every refit is the collapsed SGPR
    # bound over 256 k-center inducing points.
    "c5_long": ExperimentConfig(
        kernel=KernelSpec(spatial_kind="matern32", ds=2, df=0),
        field=FieldConfig(num_rows=100, num_cols=100, true_ls_spatial=8.0),
        acquisition=AcquisitionConfig(strategy="mi"),
        fit=FitConfig(restarts=4, sparse_threshold=512, sparse_inducing=256,
                      refit_iters=60, refit_restarts=2),
        episode=EpisodeConfig(num_pilot=64, budget=4800.0, num_waypoints=80,
                              samples_per_step=10, refit_every=4),
    ),
    # 5 at 100× north-star scale (1024×1024 ≈ 1.05M points): FITC truth over
    # 1 024 k-center points, the low-rank planner with M = 512.
    "c5_1m": ExperimentConfig(
        kernel=KernelSpec(spatial_kind="matern32", ds=2, df=0),
        field=FieldConfig(num_rows=1024, num_cols=1024,
                          true_ls_spatial=80.0, synth_inducing=1024),
        acquisition=AcquisitionConfig(strategy="mi", num_inducing=512),
        fit=FitConfig(refit_iters=60, refit_restarts=2),
        episode=EpisodeConfig(num_pilot=128, budget=4096.0, num_waypoints=8,
                              samples_per_step=10, refit_every=4),
    ),
    # 5 at 400× north-star scale (2048×2048 ≈ 4.19M points): the yield-aware
    # path utility, and a hard capacity of 224 samples (the step's two
    # (cap, N) panels); the truth and the seed stream their grid, the
    # k-center design runs over the 1024×1024 sub-grid.
    "c5_4m": ExperimentConfig(
        kernel=KernelSpec(spatial_kind="matern32", ds=2, df=0),
        field=FieldConfig(num_rows=2048, num_cols=2048,
                          true_ls_spatial=160.0, synth_inducing=512),
        acquisition=AcquisitionConfig(strategy="mi", num_inducing=512,
                                      path_utility="per_sample"),
        fit=FitConfig(refit_iters=60, refit_restarts=2),
        episode=EpisodeConfig(num_pilot=96, budget=8192.0, num_waypoints=8,
                              samples_per_step=8, refit_every=4,
                              max_samples=224, hard_cap=True),
    ),
    # the c5_1m field as a long campaign (~42 steps): low-rank planning over
    # 1.05M candidates and SGPR refits past 512 samples, capacity 640.
    "c5_1m_long": ExperimentConfig(
        kernel=KernelSpec(spatial_kind="matern32", ds=2, df=0),
        field=FieldConfig(num_rows=1024, num_cols=1024,
                          true_ls_spatial=80.0, synth_inducing=1024),
        acquisition=AcquisitionConfig(strategy="mi", num_inducing=512),
        fit=FitConfig(sparse_threshold=512, sparse_inducing=256,
                      refit_iters=60, refit_restarts=2),
        episode=EpisodeConfig(num_pilot=128, budget=20480.0, num_waypoints=40,
                              samples_per_step=10, refit_every=4,
                              max_samples=640),
    ),
    # Real-table experiment: phenotype CSV with genotype features,
    # composite spatial×feature kernel, mixed sensing modalities.
    "c10_table": ExperimentConfig(
        kernel=KernelSpec(spatial_kind="matern52", feature_kind="rbf",
                          ds=2, df=3),
        field=FieldConfig(num_rows=25, num_cols=40, num_features=3,
                          data_path=_SAMPLE_TABLE),
        acquisition=AcquisitionConfig(strategy="mi"),
        episode=EpisodeConfig(num_pilot=32, budget=120.0, modality="mixed"),
    ),
}
