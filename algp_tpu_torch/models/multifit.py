"""Multi-trait model-family dispatch (the counterpart of
algp_tpu.models.multifit; FitConfig.multi_fit).

Given the sampled plots' (n, T) trait matrix — NaN marks the cells a
visit did not measure (FieldConfig.trait_obs_frac) — produce per-trait
posterior mean fields over the whole candidate matrix:

  "independent"  per-trait exact GPs.  A fully observed buffer goes
                 through the batched `gp.fit_multi` (T·R restarts in one
                 batch); an under-observed one falls back to a fit per
                 trait on that trait's own observed plots (host loop,
                 end of episode only).
  "icm"          the coregionalized joint GP (models.coregional), fitted
                 on the genuinely observed (plot, trait) cells only: the
                 per-visit NaN mask and the env's ground-truth observation
                 mask (a table's imputed cells are masked out, not
                 conditioned on).

Every fit starts from `inits` of the configured family, restart axis
leading: `KernelParams` for "independent" (the same for every trait, as
the reference's fits share one key), `ICMParams` for "icm"; an episode
draws them with `trait_inits` / `icm_trait_inits`.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from algp_tpu_torch.config import MULTI_FITS, FitConfig
from algp_tpu_torch.device import resolve_device
from algp_tpu_torch.models import coregional as icm_mod
from algp_tpu_torch.models import gp as gp_mod
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec


def check_multi_fit(name: str) -> None:
    """ValueError for an unknown family name."""
    if name not in MULTI_FITS:
        raise ValueError(f"unknown multi_fit {name!r}; use {MULTI_FITS}")


def trait_inits(spec: KernelSpec, cfg: FitConfig, seed: int,
                device=None) -> KernelParams:
    """The restart inits of an episode's end-of-episode trait fits: drawn
    from a generator seeded by the episode seed (the reference's
    PRNGKey(seed) cannot be reproduced in torch)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(int(seed))
    return gp_mod.make_restart_inits(spec, cfg, gen)


def icm_trait_inits(spec: KernelSpec, cfg: FitConfig, num_traits: int, seed: int,
                    device=None) -> icm_mod.ICMParams:
    """The ICM family's counterpart of `trait_inits` (rank `cfg.icm_rank`)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(int(seed))
    return icm_mod.make_icm_inits(spec, cfg, num_traits, cfg.icm_rank, gen)


def multitrait_mean_fields(
    spec: KernelSpec,
    fitcfg: FitConfig,
    X_all: torch.Tensor,
    idx: np.ndarray,
    Y_raw: np.ndarray,
    noise_scale: Optional[np.ndarray],
    observed_traits: np.ndarray,
    inits,
    mesh=None,
) -> np.ndarray:
    """Per-trait posterior mean fields, (N, T) host array.

    X_all          : (N, d) candidate matrix (device)
    idx            : (n,) sampled grid indices
    Y_raw          : (n, T) measured traits; NaN = not measured that visit
    noise_scale    : (n,) heteroscedastic variance multipliers or None
    observed_traits: (N, T) ground-truth observation mask (the ICM's; the
                     independent family fits every measured cell)
    inits          : restart inits of the family, restart axis leading:
                     KernelParams ("independent") or ICMParams ("icm")
    mesh           : `parallel.make_mesh()` of a mesh episode: the ICM
                     splits its restarts over the mesh's 'restarts' axis
                     (`coregional.fit_icm(mesh=)`); the independent
                     families run whole on every rank
    """
    check_multi_fit(fitcfg.multi_fit)
    want = icm_mod.ICMParams if fitcfg.multi_fit == "icm" else KernelParams
    if not isinstance(inits, want):
        raise TypeError(f"multi_fit={fitcfg.multi_fit!r} starts from {want.__name__} "
                        f"inits, got {type(inits).__name__}")
    dev = X_all.device
    obs_visit = ~np.isnan(Y_raw)
    Y_np = np.nan_to_num(Y_raw, nan=0.0)
    T = Y_raw.shape[1]

    def on_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    if fitcfg.multi_fit == "icm":
        obs = torch.as_tensor(obs_visit & observed_traits[idx], device=dev)
        x = X_all.index_select(0, torch.as_tensor(idx, device=dev))
        ns = None if noise_scale is None else on_dev(noise_scale)
        # means only: the variance pass would add T (nT, N) solves for nothing
        mean, _, _ = icm_mod.fit_predict_icm(
            spec, fitcfg, x, on_dev(Y_np), X_all, obs, ns, rank=fitcfg.icm_rank,
            compute_var=False, inits=inits, mesh=mesh)
        return mean.cpu().numpy()

    def mean_field(params, x, y, ns):
        post = gp_mod.posterior(spec, params, x, y, ns, min_noise=fitcfg.min_noise,
                                jitter=fitcfg.jitter)
        return gp_mod.predict(spec, params, post, X_all)[0]

    if not obs_visit.all():
        means = []
        for t in range(T):
            sub = np.flatnonzero(obs_visit[:, t])
            if len(sub) < 2:
                # a rarely measured trait ends with a (near-)prior posterior,
                # which would score as a fitted model
                warnings.warn(
                    f"trait {t} has only {len(sub)} observed cell(s); its "
                    "independent posterior is (near-)prior — consider "
                    "multi_fit='icm', which transfers correlated traits",
                    RuntimeWarning,
                )
            xs = X_all.index_select(0, torch.as_tensor(idx[sub], device=dev))
            ys = on_dev(Y_np[sub, t])
            nss = None if noise_scale is None else on_dev(noise_scale[sub])
            res = gp_mod.fit(spec, fitcfg, xs, ys, nss, inits=inits)
            means.append(mean_field(res.params, xs, ys, nss))
        return torch.stack(means, dim=1).cpu().numpy()

    x = X_all.index_select(0, torch.as_tensor(idx, device=dev))
    Y = on_dev(Y_np)
    ns = None if noise_scale is None else on_dev(noise_scale)
    res = gp_mod.fit_multi(spec, fitcfg, x, Y, ns, inits=inits)
    means = [mean_field(gp_mod.trait_result(res, t).params, x, Y[:, t], ns)
             for t in range(T)]
    return torch.stack(means, dim=1).cpu().numpy()
