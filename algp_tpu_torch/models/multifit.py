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
  "icm"          the coregionalized joint GP: not ported yet (ROADMAP.md
                 item 15); it raises.

Every fit starts from `inits` (restart axis leading), the same for every
trait, as the reference's fits share one key.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from algp_tpu_torch.config import MULTI_FITS, FitConfig
from algp_tpu_torch.device import resolve_device
from algp_tpu_torch.models import gp as gp_mod
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec


def check_multi_fit(name: str) -> None:
    """Raise for a family the port cannot fit: ValueError for an unknown
    name, NotImplementedError for the ICM."""
    if name not in MULTI_FITS:
        raise ValueError(f"unknown multi_fit {name!r}; use {MULTI_FITS}")
    if name == "icm":
        raise NotImplementedError(
            "multi_fit='icm' (the coregionalized model, models/coregional) is "
            "not ported to algp_tpu_torch yet; see ROADMAP.md item 15"
        )


def trait_inits(spec: KernelSpec, cfg: FitConfig, seed: int,
                device=None) -> KernelParams:
    """The restart inits of an episode's end-of-episode trait fits: drawn
    from a generator seeded by the episode seed (the reference's
    PRNGKey(seed) cannot be reproduced in torch)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(int(seed))
    return gp_mod.make_restart_inits(spec, cfg, gen)


def multitrait_mean_fields(
    spec: KernelSpec,
    fitcfg: FitConfig,
    X_all: torch.Tensor,
    idx: np.ndarray,
    Y_raw: np.ndarray,
    noise_scale: Optional[np.ndarray],
    observed_traits: np.ndarray,
    inits: KernelParams,
) -> np.ndarray:
    """Per-trait posterior mean fields, (N, T) host array.

    X_all          : (N, d) candidate matrix (device)
    idx            : (n,) sampled grid indices
    Y_raw          : (n, T) measured traits; NaN = not measured that visit
    noise_scale    : (n,) heteroscedastic variance multipliers or None
    observed_traits: (N, T) ground-truth observation mask (the ICM's; the
                     independent family fits every measured cell)
    inits          : restart inits, restart axis leading
    """
    check_multi_fit(fitcfg.multi_fit)
    dev = X_all.device
    obs_visit = ~np.isnan(Y_raw)
    Y_np = np.nan_to_num(Y_raw, nan=0.0)
    T = Y_raw.shape[1]

    def on_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

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
