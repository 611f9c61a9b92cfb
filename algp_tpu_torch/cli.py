"""Command-line experiment driver (the counterpart of algp_tpu.cli).

    python -m algp_tpu_torch.cli --preset c5_10k              # on the card
    python -m algp_tpu_torch.cli --preset c5_100k             # low-rank planner
    python -m algp_tpu_torch.cli --preset c5_long             # SGPR refits
    python -m algp_tpu_torch.cli --preset c5_1m               # 1024 × 1024
    python -m algp_tpu_torch.cli --preset c5_4m --mi-ensemble 4   # 2048 × 2048
    python -m algp_tpu_torch.cli --preset c5_1m_long          # long, 1M
    python -m algp_tpu_torch.cli --preset c5_100k --mode greedy \\
        --num-inducing 1024 --num-pilot 64 --acq-rounds 50    # greedy low-rank MI
    python -m algp_tpu_torch.cli --preset c2_composite_restarts \\
        --optimizer lbfgs                                     # features, L-BFGS
    python -m algp_tpu_torch.cli --preset c10_table \\
        --value-cols height,width,stand_count                 # 3-trait table
    python -m algp_tpu_torch.cli --preset c5_10k --num-traits 3 \\
        --trait-corr 0.5 --trait-obs-frac 0.5                 # 3 traits
    python -m algp_tpu_torch.cli --preset c5_10k --num-traits 3 \\
        --trait-obs-frac 0.25 --multi-fit icm                 # ICM traits
    python -m algp_tpu_torch.cli --preset c2_composite_restarts \\
        --deep-hidden 16 --deep-out 4                         # deep kernel
    python -m algp_tpu_torch.cli --preset c5_episode --rows 8 --cols 12 \\
        --budget 24 --iters 10 --device cpu                   # on the CPU
    python -m algp_tpu_torch.cli --preset c5_10k --budget 60 \\
        --profile-dir /tmp/trace --plots /tmp/figs            # trace, figures

Flags fill the typed configs (config.py), starting from `--preset`.  The
run goes to the card unless `--device cpu` asks for the CPU.  Modes:
"episode" (the informative-path episode, episode.Agent) and "greedy"
(pure greedy selection over every grid candidate, configs 3-4; MI past
the exact range, or with --num-inducing M > 0, goes through the low-rank
`acquisition_lowrank.greedy_select_lowrank` over a k-center design;
`--mi-ensemble K` averages K design variants in both modes).  On a
multi-trait field (`--num-traits T`, or a table's `--value-cols`) both
modes end with per-trait fits (`--multi-fit independent | icm`) and
report `trait_rmse_test`.  `--deep-hidden` (with features) fits a learned
MLP embedding of the features jointly with the kernel; both modes then
plan and select over the embedded candidates.
A grid of 320 × 320 needs the FITC truth (`--preset c5_100k`): the dense
truth's 102 400² factor does not fit on the card.
In episode mode, `--profile-dir DIR` writes a `torch.profiler` trace of run
0 into DIR (`utils.profiling.trace`), and `--plots DIR` writes each run's
field maps (`maps_run{run}.png`) and, at the end, the learning curves
(`curves.png`) with matplotlib (`utils.plotting`, which raises if
matplotlib is missing).  Greedy mode writes neither.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from algp_tpu_torch.config import (
    PRESETS, ExperimentConfig, MLPSpec, resolve_num_inducing, resolve_strategy,
)
from algp_tpu_torch.device import resolve_device
from algp_tpu_torch.episode import Agent
from algp_tpu_torch.field import FEATURE_WARPS, FieldEnv
from algp_tpu_torch.models import multifit
from algp_tpu_torch.ops.kernels import KernelSpec
from algp_tpu_torch.utils import plotting
from algp_tpu_torch.utils.metrics import MetricsLogger
from algp_tpu_torch.utils.profiling import trace


def _round4(v):
    """4-digit rounding for summary JSON (None passes through)."""
    return None if v is None else round(float(v), 4)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="algp_tpu_torch",
        description="active-learning GP experiments, PyTorch / CUDA port",
    )
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="start from one of the ported acceptance configs")
    p.add_argument("--mode", choices=("episode", "greedy"), default="episode",
                   help="'episode': informative-path loop (config 5); "
                   "'greedy': greedy selection over ALL grid candidates for "
                   "--acq-rounds rounds (configs 3-4)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on "
                   "the CPU)")
    p.add_argument("--strategy",
                   choices=("mi", "entropy", "uniform", "naive", "auto"))
    p.add_argument("--kernel", choices=("rbf", "matern32", "matern52"))
    p.add_argument("--feature-kernel", choices=("rbf", "matern32", "matern52"))
    p.add_argument("--rows", type=int, help="field rows")
    p.add_argument("--cols", type=int, help="ranges per row")
    p.add_argument("--features", type=int, help="feature dims (composite kernel)")
    p.add_argument("--feature-warp", choices=FEATURE_WARPS,
                   help="synthetic truth's nonlinear feature structure "
                   "(FieldConfig.feature_warp)")
    p.add_argument("--budget", type=float, help="episode travel budget")
    p.add_argument("--num-pilot", type=int)
    p.add_argument("--samples-per-step", type=int)
    p.add_argument("--min-cost-frac", type=float,
                   help="minimum path cost as a fraction of the budget slice")
    p.add_argument("--noise-std", type=float)
    p.add_argument("--modality", choices=("precise", "cheap", "mixed"),
                   help="sensing-modality policy for collected samples")
    p.add_argument("--waypoint-goals",
                   help="comma-separated grid indices the episode must visit "
                   "in order (informative strategies only)")
    p.add_argument("--cheap-noise-mult", type=float)
    p.add_argument("--data-path", help="phenotype CSV (row,range,height,feat_*)")
    p.add_argument("--num-traits", type=int,
                   help="synthetic traits to phenotype (fit_multi batch)")
    p.add_argument("--value-cols",
                   help="comma-separated table value columns (multi-trait)")
    p.add_argument("--trait-obs-frac", type=float,
                   help="probability a secondary trait is measured at a "
                   "visited plot (trait 0 always is)")
    p.add_argument("--trait-corr", type=float,
                   help="cross-trait correlation of synthetic multi-trait "
                   "fields (equicorrelation mix; trait 0 unchanged)")
    p.add_argument("--multi-fit", choices=("independent", "icm"),
                   help="multi-trait model family: 'independent' = per-trait "
                   "exact GPs (fit_multi); 'icm' = coregionalized joint GP "
                   "over the observed (plot, trait) cells")
    p.add_argument("--icm-rank", type=int,
                   help="rank of the ICM trait-covariance factor")
    p.add_argument("--deep-hidden",
                   help="deep feature kernel: comma-separated MLP hidden "
                   "widths (e.g. '16' or '32,16'); needs --features > 0")
    p.add_argument("--deep-out", type=int, default=4,
                   help="deep feature kernel: embedding width (default 4)")
    p.add_argument("--optimizer", choices=("adam", "lbfgs"))
    p.add_argument("--lr", type=float)
    p.add_argument("--iters", type=int)
    p.add_argument("--restarts", type=int)
    p.add_argument("--acq-rounds", type=int, help="greedy rounds (configs 3-4)")
    p.add_argument("--mi-ensemble", type=int,
                   help="z-ensemble MI: average the scores of K k-center "
                   "design variants (low-rank planner); 1 = off")
    p.add_argument("--path-utility", choices=("per_cost", "per_sample"))
    p.add_argument("--num-inducing", type=int,
                   help="0 = exact MI planner; unset = preset value or auto")
    p.add_argument("--lagged-refit", action="store_true", default=None,
                   help="consume each refit one plan later")
    p.add_argument("--refit-iters", type=int,
                   help="warm refits: optimizer steps per post-pilot refit")
    p.add_argument("--refit-restarts", type=int,
                   help="warm refits: restarts per post-pilot refit")
    p.add_argument("--runs", type=int, default=1, help="independent episodes")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics-jsonl", help="stream per-round metrics to file")
    p.add_argument("--checkpoint", help="save final episode state to .npz")
    p.add_argument("--resume", help="resume an episode from a checkpoint .npz")
    p.add_argument("--plots", help="write field-map / curve figures here (matplotlib)")
    p.add_argument("--profile-dir", help="capture a torch.profiler trace of run 0 here")
    return p


def config_from_args(args) -> ExperimentConfig:
    cfg = PRESETS[args.preset] if args.preset else ExperimentConfig()
    kernel, fit, acqc, field, ep = (
        cfg.kernel, cfg.fit, cfg.acquisition, cfg.field, cfg.episode
    )

    def rep(obj, **kv):
        kv = {k: v for k, v in kv.items() if v is not None}
        return dataclasses.replace(obj, **kv) if kv else obj

    df = args.features if args.features is not None else kernel.df
    kernel = KernelSpec(
        spatial_kind=args.kernel or kernel.spatial_kind,
        feature_kind=args.feature_kernel or kernel.feature_kind,
        ds=kernel.ds, df=df,
    )
    fit = rep(fit, optimizer=args.optimizer, learning_rate=args.lr,
              iters=args.iters, restarts=args.restarts,
              refit_iters=args.refit_iters, refit_restarts=args.refit_restarts,
              multi_fit=args.multi_fit, icm_rank=args.icm_rank)
    acqc = rep(acqc, strategy=args.strategy, rounds=args.acq_rounds,
               num_inducing=args.num_inducing, path_utility=args.path_utility,
               mi_ensemble=args.mi_ensemble)
    field = rep(field, num_rows=args.rows, num_cols=args.cols,
                num_features=args.features, noise_std=args.noise_std,
                feature_warp=args.feature_warp,
                cheap_noise_mult=args.cheap_noise_mult,
                data_path=args.data_path, seed=args.seed,
                num_traits=args.num_traits, trait_corr=args.trait_corr,
                trait_obs_frac=args.trait_obs_frac,
                value_cols=(tuple(args.value_cols.split(","))
                            if args.value_cols else None))
    ep = rep(ep, budget=args.budget, num_pilot=args.num_pilot,
             samples_per_step=args.samples_per_step, seed=args.seed,
             modality=args.modality, min_cost_frac=args.min_cost_frac,
             lagged_refit=args.lagged_refit,
             waypoint_goals=(tuple(int(g) for g in args.waypoint_goals.split(","))
                             if args.waypoint_goals else None))
    deep = cfg.deep
    if args.deep_hidden:
        if kernel.df == 0:
            raise SystemExit(
                "--deep-hidden needs feature dims: pass --features > 0 "
                "(a deep kernel over zero feature columns would learn a "
                "constant embedding)"
            )
        deep = MLPSpec(hidden=tuple(int(h) for h in args.deep_hidden.split(",")),
                       out=args.deep_out)
    return ExperimentConfig(kernel=kernel, fit=fit, acquisition=acqc,
                            field=field, episode=ep, deep=deep)


def run_greedy(cfg: ExperimentConfig, runs: int, device, stream=None) -> list[dict]:
    """Configs 3-4: pilot → fit → `cfg.acquisition.rounds` greedy
    entropy / MI selections over every grid candidate → collect → refit →
    RMSE.  The fits draw their inits from generators seeded (seed + run,
    0) and (seed + run, 1).  With a deep kernel each fit trains the
    embedding too, and selection, posterior and trait fits run over the
    candidates embedded by the latest fit.  `mi_ensemble` = K > 1 stacks K
    k-center designs, the j-th starting at (j · n) // K, as the episode
    does.  On a multi-trait field every trait is measured again at the
    sampled plots and fitted, under `cfg.fit.multi_fit`, from the (seed +
    run, 1) inits (`models.multifit`), and the record gains `trait_rmse` /
    `trait_rmse_test`."""
    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch import acquisition_lowrank as acq_lr
    from algp_tpu_torch.models import coregional as icm_mod
    from algp_tpu_torch.models import gp as gp_mod
    from algp_tpu_torch.models import networks as nets

    strategy = None
    summaries = []
    for run in range(runs):
        fieldc = dataclasses.replace(cfg.field, seed=cfg.field.seed + run)
        env = FieldEnv(fieldc, cfg.kernel, device=device)
        if strategy is None:
            strategy, _ = resolve_strategy(cfg.acquisition.strategy, env.n)
        m_ind = resolve_num_inducing(cfg.acquisition.num_inducing, env.n)
        k_ens = max(1, int(cfg.acquisition.mi_ensemble))
        if k_ens > 1 and (strategy != "mi" or not m_ind):
            raise ValueError(
                "mi_ensemble > 1 needs the low-rank planner "
                "(num_inducing > 0 or auto above the crossover) — "
                "the exact W seed has no design to vary"
            )
        log = MetricsLogger(stream)
        pilot = np.unique(np.linspace(0, env.n - 1, cfg.episode.num_pilot)
                          .round().astype(np.int64))
        s = env.collect(pilot, "precise")
        seed = cfg.episode.seed + run

        def fit_on(idx, y, step):
            """(result, effective spec, effective candidates, training x, y)."""
            idx_d = torch.as_tensor(idx, device=env.device)
            x = env.X.index_select(0, idx_d)
            y = torch.as_tensor(np.asarray(y, np.float32), device=env.device)
            if cfg.deep is None:
                res = gp_mod.fit(cfg.kernel, cfg.fit, x, y, inits=gp_mod.step_inits(
                    cfg.kernel, cfg.fit, seed, step, env.device))
                return res, cfg.kernel, env.X, x, y
            # the joint MLP + kernel fit, then every consumer sees
            # [spatial | φ(features)]
            res = nets.fit_step(cfg.kernel, cfg.deep, cfg.fit, x, y, None, seed, step)
            X_eff = nets.embed_inputs(cfg.deep, res.mlp, env.X, cfg.kernel.ds)
            return (res, nets.deep_spec(cfg.kernel, cfg.deep), X_eff,
                    X_eff.index_select(0, idx_d), y)

        res, spec_eff, X_eff, _, _ = fit_on(s.indices, s.y, 0)
        nv_base = float(np.maximum(
            np.exp(2 * res.params.log_noise.cpu().numpy()), cfg.fit.min_noise**2))
        nv = torch.full((env.n,), nv_base, device=env.device)
        pilot_d = torch.as_tensor(s.indices, device=env.device)
        if strategy == "mi" and m_ind:
            # large-grid MI: low-rank complement precision over a k-center
            # design of the candidates (K variants for the z-ensemble)
            m = min(m_ind, env.n)
            zs = [X_eff.index_select(0, acq_lr.kcenter_indices(
                X_eff, m, start=(j * env.n) // k_ens)) for j in range(k_ens)]
            z = torch.stack(zs) if k_ens > 1 else zs[0]
            sel = acq_lr.greedy_select_lowrank(
                spec_eff, res.params, X_eff, nv, pilot_d, z,
                rounds=cfg.acquisition.rounds, num_pilot=len(s.indices),
            )
        else:
            sel = acq.greedy_select(
                spec_eff, res.params, X_eff, nv, pilot_d,
                rounds=cfg.acquisition.rounds, num_pilot=len(s.indices),
                strategy=strategy,
            )
        s2 = env.collect(sel.selected.cpu().numpy(), "precise")
        all_idx = np.concatenate([s.indices, s2.indices])
        all_y = np.concatenate([s.y, s2.y])
        res2, spec_eff, X_eff, x_all, y_all = fit_on(all_idx, all_y, 1)
        post = gp_mod.posterior(spec_eff, res2.params, x_all, y_all)
        mean, var = gp_mod.predict(spec_eff, res2.params, post, X_eff)
        mean, var = mean.cpu().numpy(), var.cpu().numpy()
        rec = {
            "run": run, "mode": "greedy", "strategy": strategy,
            "rounds": cfg.acquisition.rounds, "n_sampled": int(len(all_idx)),
            "final_rmse": env.rmse(mean),
            "final_rmse_test": env.rmse(mean, test_only=True),
            "mean_var": float(var.mean()),
        }
        if env.num_traits > 1:
            _, Y, _, _ = env.collect_traits(all_idx, "precise")
            inits = (icm_mod.step_inits(spec_eff, cfg.fit, env.num_traits, seed, 1,
                                        env.device) if cfg.fit.multi_fit == "icm"
                     else gp_mod.step_inits(spec_eff, cfg.fit, seed, 1, env.device))
            M = multifit.multitrait_mean_fields(
                spec_eff, cfg.fit, X_eff, all_idx, Y, None, env.observed_traits, inits)
            rec["multi_fit"] = cfg.fit.multi_fit
            rec["trait_rmse"] = env.rmse_traits(M)
            rec["trait_rmse_test"] = env.rmse_traits(M, test_only=True)
        log.log(**rec)
        summaries.append(rec)
        print(json.dumps(rec))
    return summaries


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    multifit.check_multi_fit(cfg.fit.multi_fit)
    device = resolve_device(args.device)

    if args.mode == "greedy":
        if cfg.acquisition.strategy not in ("mi", "entropy", "auto"):
            raise SystemExit(
                f"--mode greedy supports --strategy mi/entropy/auto (got "
                f"{cfg.acquisition.strategy!r}); 'uniform'/'naive' are "
                f"traversal baselines of --mode episode"
            )
        stream = open(args.metrics_jsonl, "w") if args.metrics_jsonl else None
        try:
            run_greedy(cfg, args.runs, device, stream)
        finally:
            if stream is not None:
                stream.close()
        return 0

    resume_state = None
    if args.resume:
        from algp_tpu_torch.utils import checkpoint as ckpt

        resume_state = ckpt.load(args.resume, device)

    stream = open(args.metrics_jsonl, "w") if args.metrics_jsonl else None
    summaries = []
    histories = {}
    try:
        for run in range(args.runs):
            fieldc = dataclasses.replace(cfg.field, seed=cfg.field.seed + run)
            epc = dataclasses.replace(cfg.episode, seed=cfg.episode.seed + run)
            run_cfg = dataclasses.replace(cfg, field=fieldc, episode=epc)
            env = FieldEnv(fieldc, run_cfg.kernel, device=device)
            agent = Agent(env, run_cfg, MetricsLogger(stream))
            with trace(args.profile_dir if run == 0 else None):
                result = agent.run(resume_from=resume_state if run == 0 else None)
            histories[f"run{run}"] = result.history
            if args.plots:
                os.makedirs(args.plots, exist_ok=True)
                plotting.field_maps(
                    env, result.mean, result.var,
                    sampled_idx=result.state.sampled_idx,
                    path=os.path.join(args.plots, f"maps_run{run}.png"),
                )
            summaries.append({
                "run": run,
                "final_rmse": result.rmse,
                "final_rmse_test": result.rmse_test,
                "n_sampled": len(result.state.sampled_idx),
                "steps": result.state.step,
                "mean_var": float(np.mean(result.var)),
                "nlpd_test": _round4(result.calibration.get("nlpd_test")),
                "cov95_test": _round4(result.calibration.get("cov95_test")),
                **({"trait_rmse_test": [_round4(v) for v in result.trait_rmse_test]}
                   if result.trait_rmse_test is not None else {}),
            })
            print(json.dumps(summaries[-1]))
            if args.checkpoint:
                from algp_tpu_torch.utils import checkpoint as ckpt

                # normalise to .npz so per-run names never collide
                root, ext = os.path.splitext(args.checkpoint)
                if ext != ".npz":
                    root += ext
                path = f"{root}_run{run}.npz" if args.runs > 1 else root + ".npz"
                ckpt.save(path, result.state)
    finally:
        if stream is not None:
            stream.close()

    if args.plots and histories:
        plotting.learning_curves(histories, path=os.path.join(args.plots, "curves.png"))

    if len(summaries) > 1:
        rmses = [s["final_rmse"] for s in summaries]
        print(json.dumps({
            "runs": len(summaries),
            "rmse_mean": float(np.mean(rmses)),
            "rmse_std": float(np.std(rmses)),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
