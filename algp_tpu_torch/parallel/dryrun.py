"""The mesh dry run: the reference's `__graft_entry__.dryrun_multichip` on
an n-rank `torch.distributed` world, at the reference's tiny shapes.

    python -m algp_tpu_torch.parallel.dryrun --world 4 --backend gloo --device cuda

Each rank runs, on the default mesh of the world (`sharded.make_mesh`):
  * `sharded_training_step` for greedy entropy and Krause MI, whose
    selections must equal the single-rank `acquisition.greedy_select` on
    the fitted parameters, index for index;
  * MI with the distributed seed, equal to the single-rank MI;
  * sharded low-rank MI, equal to `greedy_select_lowrank`;
  * `sharded_fit_icm`, whose restarts' and winning NLLs must match the
    single-rank `fit_icm` from the same inits within 1e-4;
  * the config-5 episode blocks (`episode_checks`): five episodes on a
    6 × 10 field, 3 steps each, through `episode.Agent(mesh=)` (exact W,
    low-rank M = 16, per-sample utility with a z-ensemble of 2, then the
    3-trait lagged-refit episode and its ICM twin with half the secondary
    traits observed), each sampling the single-rank Agent's sites index
    for index, the trait episodes' per-trait RMSE within 1e-5.
A failed check raises in the rank, and the launcher raises in the parent,
which also holds every rank's selections and sites equal.  On a world of
1 with NCCL on a CUDA card, the greedy loops also count their
device→host syncs (`torch.cuda.set_sync_debug_mode`): none may happen;
and each plan call of the mesh episodes makes exactly one.  Ranks sharing
one card need gloo.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import warnings

import numpy as np
import torch

from algp_tpu_torch.device import resolve_device
from algp_tpu_torch.parallel import launch

#: s a dry-run world may take, its ranks' start-up and kernel loads included
DEADLINE = 300.0


def _count_syncs(fn):
    """fn wrapped to record the device→host syncs of each call (their
    file:line) into `sites`."""
    sites = []

    def wrapped(*a, **k):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                sites.append([f"{w.filename}:{w.lineno}" for w in caught
                              if "synchroniz" in str(w.message)])

    return wrapped, sites


def _equal(name: str, got, want) -> None:
    got, want = np.asarray(got.cpu()), np.asarray(want.cpu())
    if not np.array_equal(got, want):
        raise AssertionError(f"{name}: mesh selections {got} != single-rank {want}")


def _loop_syncs(mesh, spec, params, x, nv, pilot, z, kw) -> list:
    """The device→host syncs (their file:line) of each sharded greedy loop
    (entropy, MI on the replicated and on the distributed seed, low-rank
    MI), each run on a state its seed builds.  The first call under the
    sync-debug mode reads the host once (a one-off inside torch.cuda): a
    warm-up run takes it."""
    from algp_tpu_torch.parallel import sharded_mi as smi
    from algp_tpu_torch.parallel.sharded_lowrank import lowrank_seed_strip

    strip, pilot, pilot_nv = smi.candidate_strip(mesh, x, nv, pilot)
    m = kw["num_pilot"]
    seed_args = (spec, params, strip, pilot, m, pilot_nv, m + kw["rounds"])

    def lowrank(*args):
        st = smi.strip_state(*args)
        st.precision = lowrank_seed_strip(spec, params, strip, z, pilot, m, args[-1])
        return st

    loop, sites = _count_syncs(smi.greedy_loop)
    loop(spec, params, strip, smi.strip_state(*seed_args), **kw)
    sites.clear()
    for seed in (smi.strip_state, smi.seed_replicated, smi.seed_distributed, lowrank):
        loop(spec, params, strip, seed(*seed_args), **kw)
    return sites


def _episode_configs() -> list:
    """The reference dry run's episode blocks (`__graft_entry__.py:159-279`):
    (name, config) pairs on the 6 × 10 `c5_episode` field."""
    from algp_tpu_torch.config import PRESETS, FitConfig

    base = PRESETS["c5_episode"]
    field = dataclasses.replace(base.field, num_rows=6, num_cols=10, seed=3)
    ep = dataclasses.replace(base.episode, num_pilot=8, budget=18.0, samples_per_step=4,
                             refit_every=2, device_metrics=True, seed=1)
    fit = FitConfig(iters=10, restarts=2)
    out = []
    for name, m, utility, k in (("exact", 0, "per_cost", 1), ("lowrank", 16, "per_cost", 1),
                                ("ensemble", 16, "per_sample", 2)):
        acq = dataclasses.replace(base.acquisition, strategy="mi", num_inducing=m,
                                  path_utility=utility, mi_ensemble=k)
        out.append((name, dataclasses.replace(base, field=field, acquisition=acq, episode=ep,
                                              fit=fit)))
    traits = dataclasses.replace(
        base, field=dataclasses.replace(field, num_traits=3),
        acquisition=dataclasses.replace(base.acquisition, num_inducing=0),
        episode=dataclasses.replace(ep, lagged_refit=True), fit=fit)
    out.append(("traits_lagged", traits))
    out.append(("traits_icm", dataclasses.replace(
        traits, field=dataclasses.replace(traits.field, trait_corr=0.8, trait_obs_frac=0.5),
        fit=FitConfig(iters=10, restarts=2, multi_fit="icm"))))
    return out


def episode_checks(mesh, device: str, count_reads: bool = False) -> dict:
    """The episode blocks on this rank: each mesh episode against the
    single-rank Agent on a copy of the same env.  `count_reads`: record
    each mesh plan call's device→host reads (`plan_reads`), exactly one
    each."""
    from algp_tpu_torch.convert import field_env_like
    from algp_tpu_torch.episode import Agent
    from algp_tpu_torch.field import FieldEnv

    out, reads = {}, []
    for name, cfg in _episode_configs():
        env = FieldEnv(cfg.field, cfg.kernel, device=device)
        r1 = Agent(field_env_like(env, device), cfg).run(max_steps=3)
        agent = Agent(field_env_like(env, device), cfg, mesh=mesh)
        if count_reads:
            agent._plan_and_metrics, sites = _count_syncs(agent._plan_and_metrics)
        r2 = agent.run(max_steps=3)
        if not np.array_equal(r1.state.sampled_idx, r2.state.sampled_idx):
            raise AssertionError(f"mesh episode {name} sampled {r2.state.sampled_idx}, "
                                 f"the single rank {r1.state.sampled_idx}")
        if r1.trait_rmse is not None and not np.allclose(r1.trait_rmse, r2.trait_rmse,
                                                         atol=1e-5):
            raise AssertionError(f"mesh episode {name}: trait RMSE {r2.trait_rmse}, the "
                                 f"single rank {r1.trait_rmse}")
        out[f"episode_{name}_sites"] = r2.state.sampled_idx
        if r2.trait_rmse is not None:
            out[f"episode_{name}_trait_rmse"] = np.asarray(r2.trait_rmse)
        if count_reads:
            reads += [len(x) for x in sites]
            if any(len(x) != 1 for x in sites):
                raise AssertionError(f"mesh episode {name}: device->host reads per plan "
                                     f"call {sites}, not one each")
    if count_reads:
        out["plan_reads"] = np.asarray(reads)
    return out


def dryrun_rank(device: str) -> dict:
    """The dry run on this rank (every rank of the world calls it)."""
    import torch.distributed as dist

    from algp_tpu_torch import acquisition as acq
    from algp_tpu_torch import acquisition_lowrank as lr
    from algp_tpu_torch.config import FitConfig
    from algp_tpu_torch.models import coregional as icm
    from algp_tpu_torch.ops.kernels import KernelSpec
    from algp_tpu_torch.parallel.sharded import (
        make_mesh,
        sharded_fit_icm,
        sharded_training_step,
    )
    from algp_tpu_torch.parallel.sharded_lowrank import sharded_greedy_select_mi_lowrank
    from algp_tpu_torch.parallel.sharded_mi import sharded_greedy_select_mi

    dev = torch.device(device)
    mesh = make_mesh()
    spec = KernelSpec("rbf", ds=2)
    cfg = FitConfig(iters=10, restarts=max(2, mesh.restarts))
    rng = np.random.default_rng(0)
    n_train, n_grid = 24, 64 * max(1, mesh.grid)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    x_train = f32(rng.uniform(0, 10, (n_train, 2)))
    y_train = f32(rng.standard_normal(n_train))
    x_grid = f32(rng.uniform(0, 10, (n_grid, 2)))
    nv = torch.full((n_grid,), 0.01, device=dev)
    pilot = torch.tensor([0, 7, 13], device=dev)
    kw = dict(rounds=4, num_pilot=3)
    out = {}
    for strategy in ("entropy", "mi"):
        params, nlls, sel, post_var = sharded_training_step(
            mesh, spec, cfg, x_train, y_train, x_grid, nv, pilot, rounds=4,
            strategy=strategy, generator=torch.Generator(device=dev).manual_seed(0))
        if not torch.isfinite(nlls).all() or post_var.shape != (n_grid,):
            raise AssertionError(f"{strategy}: NLLs {nlls}, post_var {post_var.shape}")
        ref = acq.greedy_select(spec, params, x_grid, nv, pilot, strategy=strategy, **kw)
        _equal(strategy, sel, ref.selected)
        out[f"{strategy}_selected"] = sel.cpu().numpy()
    ref_mi = ref.selected
    res = sharded_greedy_select_mi(
        mesh, spec, params, x_grid, nv, pilot, distributed_seed=True, **kw)
    _equal("distributed seed", res.selected, ref_mi)
    out["dist_seed_strip"] = np.asarray(res.strips["W"])

    z = x_grid.index_select(0, lr.kcenter_indices(x_grid, 16))
    res = sharded_greedy_select_mi_lowrank(mesh, spec, params, x_grid, nv, pilot, z, **kw)
    _equal("low-rank", res.selected,
           lr.greedy_select_lowrank(spec, params, x_grid, nv, pilot, z, **kw).selected)
    out["lowrank_selected"] = res.selected.cpu().numpy()
    nccl_1 = (device == "cuda" and dist.get_backend() == "nccl"
              and dist.get_world_size() == 1)
    if nccl_1:
        sites = _loop_syncs(mesh, spec, params, x_grid, nv, pilot, z, kw)
        out["loop_syncs"] = np.asarray([len(x) for x in sites])
        if any(sites):
            raise AssertionError(f"device->host syncs in the greedy loops: {sites}")

    # the ICM fit over the restarts axis, from the single-rank fit's inits
    icm_cfg = FitConfig(iters=10, restarts=2)
    Y3 = f32(rng.standard_normal((n_train, 3)))
    obs3 = torch.tensor(rng.uniform(size=(n_train, 3)) < 0.7, device=dev)
    inits = icm.make_icm_inits(spec, icm_cfg, 3, 1, torch.Generator(device=dev).manual_seed(2))
    f_1 = icm.fit_icm(spec, icm_cfg, x_train, Y3, obs3, inits=inits)
    f_s = sharded_fit_icm(mesh, spec, icm_cfg, x_train, Y3, obs3, inits=inits)
    a, b = f_s.all_nlls.cpu().numpy(), f_1.all_nlls.cpu().numpy()
    if not (np.allclose(a, b, rtol=1e-4, atol=1e-4)
            and abs(float(f_s.nll) - float(f_1.nll)) <= 1e-4 * abs(float(f_1.nll)) + 1e-4):
        raise AssertionError(f"sharded ICM NLLs {a} (best {float(f_s.nll)}) vs "
                             f"single-rank {b} (best {float(f_1.nll)})")
    out.update(icm_nlls=a, icm_nlls_single=b)
    out.update(episode_checks(mesh, device, count_reads=nccl_1))
    return out


def dryrun_multichip(n: int, *, backend: str = "gloo", device=None) -> dict:
    """The dry run on an n-rank world (on the card unless `device="cpu"`);
    returns rank 0's record.  Raises when a rank's check fails, or when
    the world outlives DEADLINE."""
    dev = resolve_device(device).type
    outs = launch.run("algp_tpu_torch.parallel.dryrun:dryrun_rank", n, backend=backend,
                      device=dev, kwargs={"device": dev}, timeout=DEADLINE)
    for key in outs[0]:
        if key.endswith(("_selected", "_sites")):
            for r, o in enumerate(outs[1:], 1):
                if not np.array_equal(o[key], outs[0][key]):
                    raise AssertionError(f"rank {r}'s {key} {o[key]}, rank 0's {outs[0][key]}")
    return outs[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the mesh dry run on an n-rank world")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    rec = dryrun_multichip(a.world, backend=a.backend, device=a.device)
    print(json.dumps({"dryrun_multichip": a.world, "backend": a.backend,
                      **{k: v.tolist() for k, v in rec.items()}}))


if __name__ == "__main__":
    main()
