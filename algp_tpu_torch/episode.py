"""The active-learning episode (the counterpart of algp_tpu.episode).

Pilot survey → MLL fit → repeat { enumerate budgeted paths from the pose,
score each path's sample set by joint information per unit cost, travel
the winner, collect (heteroscedastically) noisy samples, refit every
`refit_every` steps } until the travel budget is spent, with posterior
RMSE / variance metrics every step.  Strategies: "mi" and "entropy"
(informative), "uniform" (random sites), "naive" (boustrophedon sweep).

Host / device split: this module is host Python on numpy state; the
device work of an informative step is one `acquisition.plan_episode_step`
(the plan and the current posterior metrics together), and its outputs
come back in ONE device→host copy.  Uploads are non-blocking, refits and
the per-refit MI seed are queued without waiting, so the host enumerates
the next paths while the card works.  The Agent runs on its env's device.
A posterior that comes to the host whole (the final one, and every step's
of uniform / naive and of a step without device metrics) is scored where
it lies by `FieldEnv.evaluate`, in f64, and its RMSEs, mean variance and
calibration ride in the same copy as the field.

Planners: the exact implicit precision (W = L⁻¹ of the N × N seed) up to
16 384 candidates, the low-rank FITC precision above
(`resolve_num_inducing`, or `num_inducing` > 0): a k-center design of M
points computed once per episode (over a uniform sub-grid of about 2²⁰
points past 2²¹ candidates), the small-factor seed
(`acquisition_lowrank.lowrank_factors_seed`) per refit, and
`plan_episode_step_lowrank_factors` per step, with the same one read.
`mi_ensemble` = K > 1 (the z-ensemble) keeps K designs from K start
points, K seeds per refit, and averages their MI scores in the step.
Refits: the exact MLL fit, or, once the sampled set exceeds
`FitConfig.sparse_threshold`, the collapsed SGPR bound over
`sparse_inducing` k-center points of the sampled set
(`models.sparse_gp`).  The record of a step that fitted (the `pilot` or
`resume` record, or a `plan` record) names the fit's objective,
`fit_kind` "exact", "sgpr" or "deep", and an SGPR refit's record adds
`sgpr_design_s`, the host seconds of its k-center design (an enqueue,
as `fit_s` is).  The exact planner's step is the profiler region
`exact.plan_step`, its seed `exact.seed`.

Multi-trait fields (`env.num_traits` > 1): the episode plans on trait 0
while every visit measures all traits (`env.collect_traits`, kept row by
row in `EpisodeState.y_traits`, NaN where a visit skipped a trait); at
the end `models.multifit` fits every trait on the sampled plots, under the
independent or the ICM family (`FitConfig.multi_fit`), and
`EpisodeResult.trait_rmse` / `trait_rmse_test` score each against its own
observation mask.

The mesh (`Agent(..., mesh=parallel.make_mesh())`, every rank of a
`torch.distributed` world running the same episode from the same seeds):
the mi / entropy steps go through `parallel.sharded_episode` with the
candidate axis split over the mesh's grid ranks.  The per-refit seed (W's
rows, or the low-rank VT / dinv rows) is built on the ranks and kept there
across the steps, the conditioning strip and the posterior fields are
O(N/S) a rank, and each step is still one device→host read (a step
without device metrics all-gathers its mean and variance first).  The
fits and the host loop run whole on every rank; uniform / naive plan on
the host as on one card.

The deep feature kernel (`ExperimentConfig.deep`): every refit trains the
MLP embedding with the kernel (`models.networks`) on the raw inputs, then
re-embeds the candidate matrix (`_set_mlp`) before any seed or posterior
cache is refilled for the new params, so every device consumer sees
[spatial | φ(features)] under `networks.deep_spec`.  Its refits are full
ones, from a fresh MLP each.

Random streams: the fit inits of step t come from `gp.step_inits(seed,
t)` (the deep fit's from `networks.step_inits(seed, t)`) and the
end-of-episode trait fits' from `multifit.trait_inits(seed)` or
`icm_trait_inits(seed)` (the reference's PRNGKey(seed) streams cannot be reproduced in torch); the
agent and env numpy generators are the reference's, so a uniform episode
draws the same sites.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from algp_tpu_torch import acquisition as acq
from algp_tpu_torch import acquisition_lowrank as acq_lr
from algp_tpu_torch import planning
from algp_tpu_torch.config import (
    PATH_UTILITIES, ExperimentConfig, resolve_num_inducing, resolve_strategy,
)
from algp_tpu_torch.field import EVALUATION, FieldEnv, Sample
from algp_tpu_torch.models import gp as gp_mod
from algp_tpu_torch.models import multifit, networks, sparse_gp
from algp_tpu_torch.parallel import sharded_episode as sep
from algp_tpu_torch.parallel.sharded import all_gather
from algp_tpu_torch.utils.checkpoint import EpisodeState
from algp_tpu_torch.utils.metrics import MetricsLogger
from algp_tpu_torch.utils.profiling import annotate

STRATEGIES = ("mi", "entropy", "uniform", "naive")

#: past _KCENTER_SUBSAMPLE candidates the low-rank planner's k-center
#: design runs over a uniform sub-grid of about _KCENTER_TARGET points
#: (`Agent._lowrank_z`), as the reference's does
_KCENTER_SUBSAMPLE = 1 << 21
_KCENTER_TARGET = 1 << 20


def _kcenter_subgrid_indices(nr: int, nc: int, target: int) -> np.ndarray:
    """Flat indices of a uniform sub-grid of a row-major nr × nc grid with
    about `target` points: the stride s = ceil(nr·nc / target) is split
    over both axes, s_c = ceil(√s) and s_r = ceil(s / s_c), so both axes
    coarsen evenly (2048 × 2048 at 2²⁰ → strides 2 × 2, a 1024 × 1024
    grid)."""
    s = -(-(nr * nc) // target)
    sc = 1
    while sc * sc < s:
        sc += 1
    sr = -(-s // sc)
    return (np.arange(0, nr, sr, dtype=np.int64)[:, None] * nc
            + np.arange(0, nc, sc, dtype=np.int64)).ravel()


def _upload(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Host array → device tensor without waiting for the device (a
    pageable upload is staged before the call returns, so `a` may change
    afterwards)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(
        device, non_blocking=True)


@dataclasses.dataclass
class _PlanBundle:
    """One step's plan + the posterior metrics of the state it was
    planned from.  With device metrics `mean`/`var` are None and
    `var_sites` holds the posterior variances at the path's sites; else
    `calibration` holds the rest of the field's evaluation, `eval_s` the
    seconds from its posterior's enqueue to the numbers on the host and
    `eval_device` the device they were reduced on."""

    nodes: list
    cost: float
    sites: list
    mean: Optional[np.ndarray]
    var: Optional[np.ndarray]
    rmse: float
    rmse_test: float
    mean_var: float
    var_sites: Optional[np.ndarray] = None
    calibration: Optional[dict] = None
    eval_s: Optional[float] = None
    eval_device: Optional[str] = None

    @property
    def empty(self) -> bool:
        return len(self.nodes) == 0 or self.cost <= 0 or not self.sites


@dataclasses.dataclass
class EpisodeResult:
    state: EpisodeState
    history: list[dict]
    mean: np.ndarray  # final posterior mean over the grid
    var: np.ndarray  # final posterior variance over the grid
    rmse: float  # over all ground-truth cells
    rmse_test: float  # over the held-out split only
    calibration: dict = dataclasses.field(default_factory=dict)
    # multi-trait envs: per-trait RMSE of the end-of-episode trait fits
    # (trait 0 = the planning trait), all cells / held-out; else None
    trait_rmse: Optional[list] = None
    trait_rmse_test: Optional[list] = None


class Agent:
    """Episode orchestrator on `env.device`; `mesh` (`parallel.make_mesh`)
    plans the informative steps sharded over its grid ranks."""

    def __init__(self, env: FieldEnv, cfg: ExperimentConfig,
                 logger: Optional[MetricsLogger] = None, mesh=None):
        self._multi_trait = env.num_traits > 1
        if self._multi_trait:
            multifit.check_multi_fit(cfg.fit.multi_fit)
        if cfg.fit.sparse_threshold and (
                cfg.fit.sparse_threshold < cfg.fit.sparse_inducing):
            raise ValueError(
                f"sparse_threshold ({cfg.fit.sparse_threshold}) must be "
                f"≥ sparse_inducing ({cfg.fit.sparse_inducing}) — the "
                f"k-center design needs that many distinct sampled "
                f"points when the sparse refit kicks in"
            )
        if cfg.deep is not None:
            if cfg.kernel.df == 0:
                raise ValueError("deep kernel needs feature dims (df > 0)")
            if cfg.episode.lagged_refit:
                raise ValueError(
                    "lagged_refit and the deep feature kernel are not combined "
                    "(the refit re-embeds the candidate matrix — lagging would "
                    "desync the embedding from the params consuming it)"
                )
            if cfg.fit.sparse_threshold:
                raise ValueError(
                    "episode-scale SGPR and the deep feature kernel are not "
                    "combined (the joint embedding fit is exact-only)"
                )
        self.env = env
        self.cfg = cfg
        self.mesh = mesh
        # a deep kernel: every device consumer sees the embedded candidates
        # under the effective spec; only the joint fit reads the raw ones
        self.spec = (cfg.kernel if cfg.deep is None
                     else networks.deep_spec(cfg.kernel, cfg.deep))
        self.device = env.device
        self._Xdev = env.X  # embedded by each deep refit (`_set_mlp`)
        self.logger = logger or MetricsLogger()
        self.rng = np.random.default_rng(cfg.episode.seed)
        self._pad_paths = 256  # static path-batch size, as the reference's
        self._k_max = cfg.episode.samples_per_step
        self._num_inducing = resolve_num_inducing(
            cfg.acquisition.num_inducing, env.n
        )
        self._strategy, self._path_utility = resolve_strategy(
            cfg.acquisition.strategy, env.n, cfg.acquisition.path_utility
        )
        if self._strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {cfg.acquisition.strategy!r}; use "
                f"{STRATEGIES + ('auto',)}"
            )
        if self._path_utility not in PATH_UTILITIES:
            raise ValueError(
                f"unknown path_utility {cfg.acquisition.path_utility!r}; "
                f"use {PATH_UTILITIES}"
            )
        self._mi_ensemble = max(1, int(cfg.acquisition.mi_ensemble))
        if (self._mi_ensemble > 1 and self._strategy == "mi"
                and not self._num_inducing):
            raise ValueError(
                "mi_ensemble > 1 needs the low-rank planner "
                "(num_inducing > 0 or auto above the crossover) — "
                "the exact W seed has no design to vary"
            )
        if cfg.episode.waypoint_goals is not None:
            bad = [g for g in cfg.episode.waypoint_goals
                   if not 0 <= int(g) < env.n]
            if bad:
                raise ValueError(
                    f"waypoint_goals outside the grid (n={env.n}): {bad}"
                )
        # static sample capacity: the planner prefers paths costing at
        # least min_cost_frac of the budget slice, so a budget funds at
        # most ceil(num_waypoints / min_cost_frac) full steps, + 6 steps of
        # slack for short fallback paths, each of samples_per_step samples
        if cfg.episode.max_samples is not None:
            cap = cfg.episode.max_samples
        else:
            frac = max(cfg.episode.min_cost_frac, 1e-6)
            cap = cfg.episode.num_pilot + (
                int(np.ceil(cfg.episode.num_waypoints / frac)) + 6
            ) * self._k_max
        self._max_samples = (cap + 7) // 8 * 8
        self._P_cache = None  # (params, W, WT) — exact implicit-precision seed
        self._lr_cache = None  # (params, LowRankFactors or K of them) — low-rank seed
        self._z_cache = None  # the low-rank planner's inducing design
        self._z_src = None  # the candidate matrix it was built over
        self._post_cache = None  # (params, n_samples, Posterior)
        self._base_noise_cache = None
        self._noise_vec_cache = None
        self._mesh_x_cache = None  # (the candidates, them mesh-padded)
        self._mesh_truth_cache = None
        self._step_post_var = None
        self._step_site_var = None
        self._plan_profile: dict = {}
        self._fit_log: dict = {}  # the record fields of the latest fit

    def _grow_capacity(self, needed: int) -> None:
        """Grow the static sample capacity, with a warning: every padded
        buffer changes shape (pre-size with EpisodeConfig.max_samples)."""
        if needed <= self._max_samples:
            return
        new_cap = (needed + 63) // 64 * 64
        warnings.warn(
            f"episode outgrew its static sample capacity ({needed} > "
            f"{self._max_samples}); growing to {new_cap} — pre-size the "
            f"campaign with EpisodeConfig.max_samples",
            RuntimeWarning, stacklevel=3,
        )
        self._max_samples = new_cap

    def _pad_sampled_host(self, st: EpisodeState):
        """Host padded sampled-set buffers (idx 0-fill, scale 1-fill,
        y 0-fill) — the one padding convention every consumer uses."""
        m = len(st.sampled_idx)
        self._grow_capacity(m)
        cap = self._max_samples
        idx = np.zeros(cap, np.int64)
        idx[:m] = st.sampled_idx
        ns = np.ones(cap, np.float32)
        ns[:m] = st.noise_scale
        y = np.zeros(cap, np.float32)
        y[:m] = st.y
        return idx, ns, y, m

    def _padded_obs(self, st: EpisodeState):
        """(idx, count, noise_scale, y) on the device, padded to capacity."""
        idx, ns, y, m = self._pad_sampled_host(st)
        dev = self.device
        return (_upload(idx, torch.int64, dev), m,
                _upload(ns, torch.float32, dev), _upload(y, torch.float32, dev))

    def _padded_train(self, st: EpisodeState, raw: bool = False):
        """(x, y, noise_scale, num_valid) padded to capacity, on the device;
        x from the raw candidates when `raw` (the deep fit trains the
        embedding itself), else from the embedded ones."""
        idx, m, ns, y = self._padded_obs(st)
        x_src = self.env.X if raw else self._Xdev
        return x_src.index_select(0, idx), y, ns, m

    # ------------------------------------------------------------ pilot

    def _collect(self, idx, modality: str):
        """The env's measurement at `idx`: (Sample, trait rows), the trait
        rows (k, T) on multi-trait envs (column 0 is the Sample's y), else
        None."""
        if self._multi_trait:
            i, Y, scale, _ = self.env.collect_traits(idx, modality)
            return Sample(indices=i, y=Y[:, 0], noise_scale=scale), Y
        return self.env.collect(idx, modality), None

    def pilot_survey(self) -> EpisodeState:
        """Uniformly spread pilot samples (precise modality)."""
        n_pilot = self.cfg.episode.num_pilot
        idx = np.unique(
            np.linspace(0, self.env.n - 1, n_pilot).round().astype(np.int64)
        )
        s, Y = self._collect(idx, "precise")
        return EpisodeState(
            sampled_idx=s.indices, y=s.y, noise_scale=s.noise_scale,
            pose=int(s.indices[-1]), budget_left=self.cfg.episode.budget, step=0,
            y_traits=Y,
        )

    # ------------------------------------------------------------ model

    def fit_model(self, st: EpisodeState, lagged: bool = False):
        """Refit on the padded training buffers, queued on the device.
        After the pilot fit, warm refits (FitConfig.refit_iters /
        refit_restarts) start restart 0 from the incumbent.  `lagged`
        stores the result as `st.pending_params`, adopted a plan later.  A
        deep refit is a full joint fit from a fresh MLP; it re-embeds the
        candidates before returning.  The fit's record fields (`fit_kind`,
        and an SGPR refit's `sgpr_design_s`) wait in `_fit_log` for the
        step's record."""
        x, y, ns, m = self._padded_train(st, raw=True)
        fit = self.cfg.fit
        seed = self.cfg.episode.seed
        deep = self.cfg.deep
        warm = (st.params is not None and (fit.refit_iters or fit.refit_restarts)
                and deep is None)
        kind = "exact"
        if deep is not None:
            kind = "deep"
            res = networks.fit_step(self.cfg.kernel, deep, fit, x, y, ns, seed,
                                    st.step, num_valid=m)
            self._set_mlp(res.mlp)
            st.mlp = res.mlp
        elif fit.sparse_threshold and len(st.sampled_idx) > fit.sparse_threshold:
            kind = "sgpr"
            # long campaign: the collapsed SGPR bound, O(n·M²) per step
            if warm:
                res = sparse_gp.fit_step_sparse_warm(
                    self.spec, fit, x, y, ns, seed, st.step, m, st.params,
                    num_inducing=fit.sparse_inducing,
                )
            else:
                res = sparse_gp.fit_step_sparse(
                    self.spec, fit, x, y, ns, seed, st.step, m,
                    num_inducing=fit.sparse_inducing,
                )
        elif warm:
            res = gp_mod.fit_step_warm(
                self.spec, fit, x, y, ns, seed, st.step,
                incumbent=st.params, num_valid=m,
            )
        else:
            res = gp_mod.fit_step(self.spec, fit, x, y, ns, seed, st.step,
                                  num_valid=m)
        self._fit_log = {"fit_kind": kind}
        if kind == "sgpr":
            self._fit_log["sgpr_design_s"] = round(res.design_s, 4)
        if lagged:
            st.pending_params = res.params
        else:
            st.params = res.params
        return res

    def _fit_fields(self) -> dict:
        """The record fields of the fit since the last record (none if no
        fit ran), handed over once."""
        out, self._fit_log = self._fit_log, {}
        return out

    def _set_mlp(self, mlp) -> None:
        """Adopt embedding weights: re-embed the candidate matrix (one
        (N, df) → (N, dz) pass, queued) for every device consumer."""
        self._Xdev = networks.embed_inputs(self.cfg.deep, mlp, self.env.X,
                                           self.cfg.kernel.ds)

    def _base_noise(self, st: EpisodeState) -> float:
        """Fitted base noise variance with the f32 floor, read on the host
        once per fitted params (uniform / naive / the mixed fallback)."""
        c = self._base_noise_cache
        if c is not None and c[0] is st.params:
            return c[1]
        base = float(np.maximum(
            np.exp(2.0 * st.params.log_noise.detach().cpu().numpy()),
            self.cfg.fit.min_noise**2,
        ))
        self._base_noise_cache = (st.params, base)
        return base

    def _noise_vec(self, st: EpisodeState) -> torch.Tensor:
        """Per-candidate noise variance of future measurements under the
        modality policy, cached per fitted params."""
        c = self._noise_vec_cache
        if c is not None and c[0] is st.params:
            return c[1]
        nv = torch.full((self.env.n,), self._base_noise(st) * self._nv_mult,
                        dtype=torch.float32, device=self.device)
        self._noise_vec_cache = (st.params, nv)
        return nv

    def predict_field(self, st: EpisodeState):
        """Posterior mean / variance over the grid, read in one copy."""
        both = torch.cat(self._posterior_field(st)).cpu().numpy()
        n = self.env.n
        return both[:n], both[n:]

    def _posterior_field(self, st: EpisodeState):
        """Posterior mean / variance (n,) over the grid on the device,
        queued.  Between refits the cached factor grows by the step's
        samples (`gp.extend_and_predict`); a refit refactorizes once."""
        x, y, ns, m = self._padded_train(st)
        n_samp = len(st.sampled_idx)
        c = self._post_cache
        k_new = None if c is None else n_samp - c[1]
        jitter = self.cfg.fit.jitter
        if (c is not None and c[0] is st.params
                and 0 < k_new <= self._k_max + 1
                and c[2].L.shape[0] == x.shape[0]):  # capacity unchanged
            new_nv = np.full(self._k_max + 1, 1.0, np.float32)
            new_nv[:k_new] = self._base_noise(st) * st.noise_scale[c[1]:]
            post, mean, var = gp_mod.extend_and_predict(
                self.spec, st.params, c[2], x, y,
                _upload(new_nv, torch.float32, self.device), c[1], k_new,
                self._Xdev, jitter=jitter,
            )
        elif c is not None and c[0] is st.params and k_new == 0:
            post = c[2]
            mean, var = gp_mod.predict(self.spec, st.params, post, self._Xdev)
        else:
            post, mean, var = gp_mod.posterior_and_predict(
                self.spec, st.params, x, y, ns, self._Xdev,
                min_noise=self.cfg.fit.min_noise, jitter=jitter, num_valid=m,
            )
        self._post_cache = (st.params, n_samp, post)
        return mean, var

    def _read_evaluated(self, mean, var, head=()):
        """A posterior (n,) on the device and its `env.evaluate`, with any
        (1,) `head` tensors of its dtype, in one device→host copy (the 9
        f64 numbers ride first, as 18 f32 words): (head, mean, var,
        numbers, the device they were reduced on), on the host."""
        ev = self.env.evaluate(mean, var)
        words = ev.view(mean.dtype)
        h = torch.cat([words, *head, mean, var]).cpu().numpy()
        e = words.shape[0]
        k, n = e + len(head), self.env.n
        return h[e:k], h[k:k + n], h[k + n:], h[:e].view(np.float64), ev.device.type

    def _evaluated_field(self, st: EpisodeState):
        """`predict_field` with the field's evaluation in its one read:
        (mean, var, numbers, device)."""
        return self._read_evaluated(*self._posterior_field(st))[1:]

    # ------------------------------------------------------- planning step

    def _conditioning_state(self, st: EpisodeState, nv):
        """Basis / posterior variance over all candidates given everything
        sampled (a rounds=0 greedy pass over the padded sampled set)."""
        idx, ns, _, m = self._pad_sampled_host(st)
        pnv = np.full(self._max_samples, 1.0, np.float32)
        pnv[:m] = self._base_noise(st) * st.noise_scale
        res = acq.greedy_select(
            self.spec, st.params, self._Xdev, nv,
            _upload(idx, torch.int64, self.device),
            rounds=0, num_pilot=self._max_samples, strategy="entropy",
            pilot_count=m, pilot_nv=_upload(pnv, torch.float32, self.device),
        )
        return res.basis, res.post_var

    @property
    def _nv_mult(self) -> float:
        """Future-measurement noise-variance scale of the modality policy:
        "cheap" / "mixed" score candidates at the cheap sensor's variance."""
        if self.cfg.episode.modality in ("cheap", "mixed"):
            return float(self.env.cfg.cheap_noise_mult**2)
        return 1.0

    @property
    def _use_device_metrics(self) -> bool:
        """Reduce the per-step metrics on the device (EpisodeConfig.
        device_metrics; auto from 16 384 points, as the reference)."""
        dm = self.cfg.episode.device_metrics
        if dm is not None:
            return bool(dm)
        return self.env.n >= 16384

    def _truth(self):
        """(f_true, obs_mask, test_mask), f32 on the device: the env's
        (`FieldEnv.device_truth`), built once a field."""
        t = self.env.device_truth()
        return self.env.f_dev, t.observed, t.test

    def _mesh_x(self) -> torch.Tensor:
        """The candidates padded for the mesh (`sharded_episode.mesh_pad`),
        padded again only when `_set_mlp` re-embeds them."""
        c = self._mesh_x_cache
        if c is None or c[0] is not self._Xdev:
            self._mesh_x_cache = (self._Xdev, sep.mesh_pad(self._Xdev, self.mesh.grid)[0])
        return self._mesh_x_cache[1]

    def _mesh_truth(self):
        """`_truth` zero-padded to the mesh-padded length, on the device from
        `_truth`'s tensors (nothing uploaded again): the padding lies
        outside every mask."""
        if self._mesh_truth_cache is None:
            pad = self._mesh_x().shape[0] - self.env.n
            self._mesh_truth_cache = tuple(torch.cat([a, a.new_zeros(pad)])
                                           for a in self._truth())
        return self._mesh_truth_cache

    def _host_bundle(self, nodes, cost, sites, t0, mean, var, numbers,
                     device) -> _PlanBundle:
        """A plan with its state's posterior on the host and the posterior's
        evaluation (`_read_evaluated`), whose enqueue began at `t0`."""
        e = dict(zip(EVALUATION, map(float, numbers)))
        return _PlanBundle(
            nodes, cost, sites, mean, var, rmse=e.pop("rmse"),
            rmse_test=e.pop("rmse_test"), mean_var=e.pop("mean_var"),
            calibration=e, eval_s=time.perf_counter() - t0, eval_device=device,
        )

    def _plan_and_metrics(self, st: EpisodeState) -> _PlanBundle:
        """Plan the next path and produce the posterior metrics of the
        current state.  mi / entropy: one `plan_episode_step` and one
        device→host copy; uniform / naive plan on the host and read the
        metrics with the posterior (`_evaluated_field`)."""
        strat = self._strategy
        self._step_post_var = None  # for _sense('mixed')
        self._step_site_var = None
        prof = self._plan_profile = {}
        t_start = time.perf_counter()
        slice_budget = min(
            st.budget_left,
            self.cfg.episode.budget / max(1, self.cfg.episode.num_waypoints),
        )
        if strat == "naive":
            order = planning.boustrophedon_order(self.env)
            unsampled = order[~np.isin(order, st.sampled_idx)]
            # the sweep pays col_spacing per cell: never take more cells
            # than the remaining budget affords
            afford = int(st.budget_left / max(self.env.cfg.col_spacing, 1e-9))
            take = list(unsampled[: min(self._k_max, afford)])
            t0 = time.perf_counter()
            return self._host_bundle(
                take, float(len(take) * self.env.cfg.col_spacing), take, t0,
                *self._evaluated_field(st),
            )
        if strat == "uniform":
            unsampled = np.setdiff1d(np.arange(self.env.n), st.sampled_idx)
            take = list(np.sort(self.rng.choice(
                unsampled, min(self._k_max, len(unsampled)), replace=False
            )))
            t0 = time.perf_counter()
            return self._host_bundle(take, float(slice_budget), take, t0,
                                     *self._evaluated_field(st))

        goal = self._current_goal(st)
        batch = planning.enumerate_batch(
            self.env, st.pose, slice_budget, goal=goal,
            max_paths=self._pad_paths, k_max=self._k_max,
            min_cost_frac=self.cfg.episode.min_cost_frac,
        )
        if goal is not None and not len(batch):
            # the waypoint is out of reach within this slice: a free step
            # toward it instead of stalling
            self.logger.log(step=st.step, phase="goal_fallback", goal=int(goal))
            batch = planning.enumerate_batch(
                self.env, st.pose, slice_budget,
                max_paths=self._pad_paths, k_max=self._k_max,
                min_cost_frac=self.cfg.episode.min_cost_frac,
            )
        if not len(batch):
            # terminal plan (slice spent / pose cornered): this fetch is
            # the episode's final one
            t0 = time.perf_counter()
            read = self._evaluated_field(st)
            self.logger.log(step=st.step, phase="final",
                            final_fetch_s=round(time.perf_counter() - t0, 4))
            return self._host_bundle([], 0.0, [], t0, *read)
        # pad the batch to the static shape: zero-size paths never win
        P = self._pad_paths
        sets = np.zeros((P, self._k_max), np.int64)
        sizes = np.zeros((P,), np.int64)
        costs = np.ones((P,), np.float32)
        sets[: len(batch)] = batch.sets
        sizes[: len(batch)] = batch.sizes
        costs[: len(batch)] = batch.costs
        prof["enum_s"] = time.perf_counter() - t_start

        t0 = time.perf_counter()
        idx_pad, m, ns_pad, y_pad = self._padded_obs(st)
        lowrank = strat == "mi" and bool(self._num_inducing)
        W = WT = fac = None
        if lowrank:
            fac = self._lowrank_seed(st)
        elif strat == "mi":
            W, WT = self._precision_seed(st)
        prof["seed_s"] = time.perf_counter() - t0  # queued, not waited for

        t0 = time.perf_counter()
        dev = self.device
        sets_d = _upload(sets, torch.int64, dev)
        sizes_d = _upload(sizes, torch.int64, dev)
        costs_d = _upload(costs, torch.float32, dev)
        common = dict(min_noise=self.cfg.fit.min_noise, nv_mult=self._nv_mult,
                      path_utility=self._path_utility)
        step_args = (self.spec, st.params, self._Xdev, idx_pad, m, ns_pad,
                     y_pad, sets_d, sizes_d, costs_d)
        if self.mesh is not None:
            step_args = (self.mesh, self.spec, st.params, self._mesh_x(), *step_args[3:])
            common.update(strategy=strat, n_valid=self.env.n)
        if self._use_device_metrics:
            if self.mesh is not None:
                out = sep.sharded_plan_episode_step_metrics(
                    *step_args, *self._mesh_truth(), lr=fac, W=W, **common)
            elif lowrank:
                f_true, obs_m, test_m = self._truth()
                out = acq_lr.plan_episode_step_lowrank_factors_metrics(
                    *step_args, fac, f_true, obs_m, test_m, **common)
            else:
                f_true, obs_m, test_m = self._truth()
                with annotate("exact.plan_step"):
                    out = acq.plan_episode_step_metrics(
                        *step_args, f_true, obs_m, test_m, W, WT, strategy=strat,
                        **common)
            best, rmse, rmse_test, mean_var, var_sites = out
            # the step's one device→host copy, a few dozen bytes
            h = torch.cat([best.to(torch.float32).reshape(1), rmse.reshape(1),
                           rmse_test.reshape(1), mean_var.reshape(1),
                           var_sites]).cpu().numpy()
            prof["step_s"] = time.perf_counter() - t0
            best = int(h[0])
            sites = list(batch.sets[best][: batch.sizes[best]])
            self._step_site_var = h[4:]
            return _PlanBundle(
                batch.node_seqs[best], float(batch.costs[best]), sites,
                None, None, rmse=float(h[1]), rmse_test=float(h[2]),
                mean_var=float(h[3]), var_sites=h[4:],
            )

        n = self.env.n
        if self.mesh is not None:
            best, mean, var, _ = sep.sharded_plan_episode_step(
                *step_args, lr=fac, W=W, **common)
            # the grid's blocks, in index order, trimmed to the field
            both = all_gather(torch.stack([mean, var]).reshape(-1), self.mesh.grid_group)
            mean, var = both.reshape(self.mesh.grid, 2, -1).permute(1, 0, 2).reshape(2, -1)[:, :n]
        elif lowrank:
            best, mean, var, _ = acq_lr.plan_episode_step_lowrank_factors(
                *step_args, fac, **common)
        else:
            with annotate("exact.plan_step"):
                best, mean, var, _ = acq.plan_episode_step(
                    *step_args, W, WT, strategy=strat, **common)
        # the step's one device→host copy
        (best,), *read = self._read_evaluated(
            mean, var, head=(best.to(torch.float32).reshape(1),))
        prof["step_s"] = time.perf_counter() - t0
        best = int(best)
        self._step_post_var = read[1]  # for _sense('mixed')
        sites = list(batch.sets[best][: batch.sizes[best]])
        return self._host_bundle(
            batch.node_seqs[best], float(batch.costs[best]), sites, t0, *read,
        )

    def _current_goal(self, st: EpisodeState) -> Optional[int]:
        """Next unvisited EpisodeConfig.waypoint_goals entry, advancing past
        goals the pose has reached; None when there is none."""
        goals = self.cfg.episode.waypoint_goals
        if not goals:
            return None
        while st.goal_i < len(goals) and int(goals[st.goal_i]) == st.pose:
            st.goal_i += 1
        if st.goal_i >= len(goals):
            return None
        return int(goals[st.goal_i])

    def _sense(self, st: EpisodeState, sample_nodes: list):
        """Collect along a path under the modality policy: (samples, trait
        rows), the rows as `_collect`'s.  "mixed" spends the precise sensor
        on the path's highest-posterior-variance site and the cheap one on
        the rest."""
        policy = self.cfg.episode.modality
        if policy in ("precise", "cheap"):
            s, Y = self._collect(sample_nodes, policy)
            return [s], Y
        if policy != "mixed":
            raise ValueError(f"unknown modality policy {policy!r}")
        if self._step_site_var is not None:  # device metrics: site order
            pv = self._step_site_var[: len(sample_nodes)]
        elif self._step_post_var is not None:
            pv = np.asarray(self._step_post_var)[np.asarray(sample_nodes)]
        else:
            _, pvar = self._conditioning_state(st, self._noise_vec(st))
            pv = pvar.cpu().numpy()[np.asarray(sample_nodes)]
        best = int(np.argmax(pv))
        cheap_nodes = [n for i, n in enumerate(sample_nodes) if i != best]
        got = [self._collect([sample_nodes[best]], "precise")]
        if cheap_nodes:
            got.append(self._collect(cheap_nodes, "cheap"))
        samples, Ys = zip(*got)
        return list(samples), np.concatenate(Ys) if self._multi_trait else None

    def _precision_seed(self, st: EpisodeState, params=None):
        """(W, WT) implicit-precision seed, cached per fitted params (one
        Gram kernel launch, Cholesky and tri_inv per refit, queued on the
        device).  The Schur corrections for the current sampled set are
        rebuilt inside every step from W.  `params` overrides st.params
        (the lagged refit seeds its pending params)."""
        params = st.params if params is None else params
        cached = self._P_cache
        if cached is None or cached[0] is not params:
            noise = dict(min_noise=self.cfg.fit.min_noise, nv_mult=self._nv_mult)
            if self.mesh is not None:
                # this rank's rows of W, by the distributed strip
                # factorization; no WT (the step reads its own strip)
                W, WT = sep.sharded_precision_seed(
                    self.mesh, self.spec, params, self._mesh_x(), **noise), None
            else:
                W, WT = acq.implicit_precision_seed(self.spec, params, self._Xdev, **noise)
            self._P_cache = (params, W, WT)
        return self._P_cache[1], self._P_cache[2]

    def _lowrank_z(self) -> torch.Tensor:
        """The low-rank planner's inducing design: a k-center chain of
        min(M, n) points over the candidates, which depends only on the
        candidate matrix, so it is computed once per episode (again after
        a deep refit re-embeds the candidates; queued, no host read).  Past _KCENTER_SUBSAMPLE candidates the chain (M
        sequential rounds over an (n,) vector) runs over a uniform
        sub-grid instead.  With mi_ensemble = K > 1: a (K, M, d) stack of
        K designs, the j-th starting at index (j · n_sub) // K."""
        if self._z_cache is None or self._z_src is not self._Xdev:
            xs = self._Xdev
            if self.env.n > _KCENTER_SUBSAMPLE:
                sub = _kcenter_subgrid_indices(
                    self.env.num_rows, self.env.num_cols, _KCENTER_TARGET)
                xs = xs.index_select(0, _upload(sub, torch.int64, self.device))
            m = min(self._num_inducing, xs.shape[0])
            K = self._mi_ensemble
            if K > 1:
                self._z_cache = torch.stack([
                    xs.index_select(0, acq_lr.kcenter_indices(
                        xs, m, start=(j * xs.shape[0]) // K))
                    for j in range(K)])
            else:
                self._z_cache = xs.index_select(0, acq_lr.kcenter_indices(xs, m))
            self._z_src = self._Xdev
        return self._z_cache

    def _lowrank_seed(self, st: EpisodeState, params=None):
        """The small-factor low-rank seed (`acquisition_lowrank.
        lowrank_factors_seed`: the Gram kernel for K_zx, an O(N·M²) pass,
        M × M factors kept), cached per fitted params and queued without
        waiting; the noise model is derived on the device.  `params`
        overrides st.params (the lagged refit seeds its pending params).
        The z-ensemble seeds each of its K designs: a list of K factors.
        On a mesh: this rank's rows of the full seed
        (`sharded_episode.sharded_lowrank_seed`; the ensemble's K stacked)."""
        params = st.params if params is None else params
        cached = self._lr_cache
        if cached is None or cached[0] is not params:
            z = self._lowrank_z()
            if self.mesh is not None:
                self._lr_cache = (params, sep.sharded_lowrank_seed(
                    self.mesh, self.spec, params, self._mesh_x(), z,
                    min_noise=self.cfg.fit.min_noise, nv_mult=self._nv_mult,
                    n_valid=self.env.n))
                return self._lr_cache[1]

            def seed(zk):
                return acq_lr.lowrank_factors_seed(
                    self.spec, params, self._Xdev, zk,
                    min_noise=self.cfg.fit.min_noise, nv_mult=self._nv_mult,
                )

            fac = [seed(zk) for zk in z.unbind(0)] if z.dim() == 3 else seed(z)
            self._lr_cache = (params, fac)
        return self._lr_cache[1]

    def _dispatch_refit_seed(self, st: EpisodeState, params=None):
        """Queue the per-refit MI seed for the given params, exact or low
        rank as the planner is (no-op unless the strategy is mi)."""
        if self._strategy != "mi":
            return
        if self._num_inducing:
            self._lowrank_seed(st, params)
        else:
            self._precision_seed(st, params)

    # ------------------------------------------------------------ episode

    def run(self, max_steps: int = 1000,
            resume_from: Optional[EpisodeState] = None) -> EpisodeResult:
        """Run (or resume) an episode.  `resume_from` restarts from a
        checkpointed EpisodeState (utils.checkpoint); selection is a pure
        function of that state, so the continuation is exact."""
        ep = self.cfg.episode
        if resume_from is not None:
            st = resume_from
            # a multi-trait env needs the checkpoint's (n, T) trait rows (the
            # pilot's cannot be measured again): fail here, not mid-step
            ckpt_traits = st.y_traits.shape[1] if st.y_traits is not None else 1
            if (self._multi_trait or ckpt_traits > 1) and (
                    ckpt_traits != self.env.num_traits):
                raise ValueError(
                    f"checkpoint/config trait mismatch: checkpoint has "
                    f"{ckpt_traits} trait column(s), env has "
                    f"{self.env.num_traits} (resume with the same "
                    f"num_traits/value_cols the checkpoint was written with)"
                )
            if st.rng_state is not None:
                if "agent" in st.rng_state:
                    self.rng.bit_generator.state = st.rng_state["agent"]
                if "env" in st.rng_state:
                    self.env._rng.bit_generator.state = st.rng_state["env"]
        else:
            st = self.pilot_survey()
        self._fit_log = {}
        t0 = time.perf_counter()
        if st.params is None or (self.cfg.deep is not None and st.mlp is None):
            self.fit_model(st)
        elif self.cfg.deep is not None:
            # resume: the checkpointed embedding goes with its params
            self._set_mlp(st.mlp)
        t_fit0 = time.perf_counter() - t0
        pilot_fit = self._fit_fields()
        # the bundle carries the next step's plan with the current state's
        # metrics; plan wall time is attributed to the step it plans for
        t0 = time.perf_counter()
        bundle = self._plan_and_metrics(st)
        carry_plan = time.perf_counter() - t0
        carry_prof = self._plan_profile
        self.logger.log(
            step=st.step, phase="pilot" if resume_from is None else "resume",
            n_sampled=len(st.sampled_idx), rmse=bundle.rmse,
            rmse_test=bundle.rmse_test, mean_var=bundle.mean_var,
            budget_left=st.budget_left, fit_s=round(t_fit0, 4), **pilot_fit,
        )

        capped = False
        while st.budget_left > 0 and st.step < max_steps:
            if bundle.empty:
                break
            if (ep.hard_cap
                    and len(st.sampled_idx) + len(bundle.sites) > self._max_samples):
                # capacity as a stop condition: end cleanly instead of growing
                self.logger.log(step=st.step, phase="hard_cap",
                                n_sampled=len(st.sampled_idx),
                                budget_left=round(st.budget_left, 3))
                capped = True
                break
            st.step += 1
            nodes, cost, sample_nodes = bundle.nodes, bundle.cost, bundle.sites
            t0 = time.perf_counter()
            samples, trait_rows = self._sense(st, sample_nodes)
            st.sampled_idx = np.concatenate(
                [st.sampled_idx] + [s.indices for s in samples])
            st.y = np.concatenate([st.y] + [s.y for s in samples])
            st.noise_scale = np.concatenate(
                [st.noise_scale] + [s.noise_scale for s in samples])
            if trait_rows is not None:
                st.y_traits = np.concatenate([st.y_traits, trait_rows])
            st.pose = int(nodes[-1])
            st.budget_left -= cost
            t_sense = time.perf_counter() - t0

            refit_due = st.step % ep.refit_every == 0
            t0 = time.perf_counter()
            if ep.lagged_refit:
                # adopt the refit queued at the previous refit step
                if st.pending_params is not None:
                    st.params = st.pending_params
                    st.pending_params = None
            elif refit_due:
                self.fit_model(st)
                self._P_cache = self._lr_cache = None  # params changed → re-seed
                # queue the seed now: the host's path enumeration below
                # overlaps the fit and seed device time
                self._dispatch_refit_seed(st)
            t_fit = time.perf_counter() - t0
            # rng states saved before the next plan draws from them, so a
            # checkpoint written after this step resumes exactly
            st.rng_state = {
                "agent": self.rng.bit_generator.state,
                "env": self.env._rng.bit_generator.state,
            }
            t0 = time.perf_counter()
            bundle = self._plan_and_metrics(st)
            t_plan, carry_plan = carry_plan, time.perf_counter() - t0
            prof, carry_prof = carry_prof, self._plan_profile
            if ep.lagged_refit and refit_due:
                # queue the refit after the plan read its outputs: it runs
                # while the host senses / enumerates the next step
                t0 = time.perf_counter()
                self.fit_model(st, lagged=True)
                self._dispatch_refit_seed(st, st.pending_params)
                t_fit += time.perf_counter() - t0
            self.logger.log(
                step=st.step, phase="plan", n_sampled=len(st.sampled_idx),
                n_new=len(sample_nodes), path_cost=round(cost, 3),
                rmse=bundle.rmse, rmse_test=bundle.rmse_test,
                mean_var=bundle.mean_var, budget_left=round(st.budget_left, 3),
                plan_s=round(t_plan, 4), fit_s=round(t_fit, 4),
                sense_s=round(t_sense, 4), **self._fit_fields(),
                **{k: round(v, 4) for k, v in prof.items()},
            )

        if (ep.lagged_refit and st.pending_params is not None
                and (st.budget_left <= 0 or bundle.empty or capped)):
            # the episode ended with a queued refit: adopt it for the final
            # posterior (an interrupted run keeps it pending for resume)
            st.params = st.pending_params
            st.pending_params = None
            bundle.mean = bundle.var = None  # force a fresh final fetch
        if bundle.mean is None:
            t0 = time.perf_counter()
            read = self._evaluated_field(st)
            self.logger.log(step=st.step, phase="final",
                            final_fetch_s=round(time.perf_counter() - t0, 4))
            bundle = self._host_bundle([], 0.0, [], t0, *read)
        # the final posterior's evaluation came with its one read
        calib = bundle.calibration
        self.logger.log(step=st.step, phase="calibration",
                        **{k: round(v, 6) for k, v in calib.items()},
                        eval_s=round(bundle.eval_s, 4), eval_device=bundle.eval_device)
        trait_rmse = trait_rmse_test = None
        if self._multi_trait:
            trait_rmse, trait_rmse_test = self._trait_posteriors(st)
            self.logger.log(step=st.step, phase="traits",
                            trait_rmse=[round(v, 6) for v in trait_rmse],
                            trait_rmse_test=[round(v, 6) for v in trait_rmse_test])
        return EpisodeResult(
            state=st, history=self.logger.history, mean=bundle.mean,
            var=bundle.var, rmse=bundle.rmse, rmse_test=bundle.rmse_test,
            calibration=calib,
            trait_rmse=trait_rmse, trait_rmse_test=trait_rmse_test,
        )

    def _trait_posteriors(self, st: EpisodeState):
        """End-of-episode multi-trait evaluation: every trait fitted on the
        campaign's plots (`multifit.multitrait_mean_fields`: one batched
        `gp.fit_multi`, per-trait fits where visits skipped traits, or the
        ICM over the observed cells), over the candidates and spec the
        episode planned with, then each trait's posterior mean field scored
        against its own observation mask.  Returns (trait_rmse,
        trait_rmse_test)."""
        fit, seed = self.cfg.fit, self.cfg.episode.seed
        inits = (multifit.icm_trait_inits(self.spec, fit, self.env.num_traits, seed,
                                          self.device) if fit.multi_fit == "icm"
                 else multifit.trait_inits(self.spec, fit, seed, self.device))
        M = multifit.multitrait_mean_fields(
            self.spec, fit, self._Xdev, np.asarray(st.sampled_idx), st.y_traits,
            st.noise_scale, self.env.observed_traits, inits, mesh=self.mesh)
        return self.env.rmse_traits(M), self.env.rmse_traits(M, test_only=True)
