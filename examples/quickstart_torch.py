"""algp-tpu quickstart on the PyTorch / CUDA port (algp_tpu_torch): the core
workloads, one screenful each, as examples/quickstart.py runs them on JAX.

    python examples/quickstart_torch.py                # on the CUDA card
    python examples/quickstart_torch.py --device cpu   # on the CPU

Section 9 shards the episode over a world of 2 ranks (`parallel.launch`,
gloo), each running `mesh_episode` below; the other sections run in this
process on the chosen device.
"""

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from algp_tpu_torch import acquisition as acq  # noqa: E402
from algp_tpu_torch import acquisition_lowrank as acq_lr  # noqa: E402
from algp_tpu_torch.config import (  # noqa: E402
    AcquisitionConfig, EpisodeConfig, ExperimentConfig, FieldConfig, FitConfig,
    MLPSpec,
)
from algp_tpu_torch.device import resolve_device  # noqa: E402
from algp_tpu_torch.episode import Agent  # noqa: E402
from algp_tpu_torch.field import FieldEnv  # noqa: E402
from algp_tpu_torch.models import coregional as icm  # noqa: E402
from algp_tpu_torch.models import gp as gp_mod  # noqa: E402
from algp_tpu_torch.models import networks as nets  # noqa: E402
from algp_tpu_torch.models.gp import ExactGP  # noqa: E402
from algp_tpu_torch.models.sparse_gp import SparseGP  # noqa: E402
from algp_tpu_torch.ops.kernels import KernelSpec  # noqa: E402
from algp_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

MESH_WORLD = 2


def episode_config() -> ExperimentConfig:
    """The episode of sections 5, 9, 10, 11, 13, 14 and 15."""
    return ExperimentConfig(
        kernel=KernelSpec("matern32", ds=2),
        fit=FitConfig(iters=50, restarts=1),
        acquisition=AcquisitionConfig(strategy="mi"),
        field=FieldConfig(num_rows=10, num_cols=16, seed=2),
        episode=EpisodeConfig(num_pilot=12, budget=80.0, num_waypoints=6,
                              samples_per_step=5, modality="mixed"),
    )


def mesh_episode(device: str) -> dict:
    """One rank of section 9: the same env, config and seeds on every rank,
    the plan steps sharded over the world's grid ranks."""
    from algp_tpu_torch.parallel import make_mesh

    cfg = episode_config()
    env = FieldEnv(cfg.field, cfg.kernel, device=device)
    res = Agent(env, cfg, mesh=make_mesh()).run()
    return {"sites": res.state.sampled_idx, "rmse": np.float64(res.rmse)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    dev = resolve_device(ap.parse_args(argv).device)

    def rows(x, idx):
        return x.index_select(0, torch.as_tensor(np.asarray(idx), device=dev))

    # 1. Exact GP regression on a synthetic field ---------------------------
    env = FieldEnv(FieldConfig(num_rows=20, num_cols=30, seed=0), device=dev)
    rng = np.random.default_rng(0)
    train = rng.choice(env.n, 100, replace=False)
    s = env.collect(train, "precise")
    gp = ExactGP(KernelSpec("rbf", ds=2), FitConfig(iters=120, restarts=2), device=dev)
    gp.fit(rows(env.X, s.indices), s.y)
    mean, var = gp.predict(env.X)
    print(f"1. RBF GP:        RMSE {env.rmse(mean.cpu().numpy()):.3f} "
          f"(prior {env.rmse(np.zeros(env.n)):.3f})")

    # 2. Composite spatial×feature Matérn kernel, multi-restart -------------
    spec_c = KernelSpec("matern52", "rbf", ds=2, df=3)
    env_c = FieldEnv(FieldConfig(num_rows=15, num_cols=20, num_features=3, seed=1),
                     spec_c, device=dev)
    s2 = env_c.collect(rng.choice(env_c.n, 80, replace=False))
    gp2 = ExactGP(spec_c, FitConfig(iters=80, restarts=3, optimizer="adam"), device=dev)
    res2 = gp2.fit(rows(env_c.X, s2.indices), s2.y)
    print(f"2. composite GP:  best NLL {float(res2.nll):.1f} "
          f"across {res2.all_nlls.numel()} restarts")

    # 3 & 4. Greedy entropy / Krause-MI active sampling ---------------------
    params = gp.params
    nv = torch.full((env.n,), float(torch.exp(2 * params.log_noise)), device=dev)
    pilot = torch.as_tensor(s.indices[:20], device=dev)
    for strategy in ("entropy", "mi"):
        sel = acq.greedy_select(gp.spec, params, env.X, nv, pilot,
                                rounds=25, num_pilot=20, strategy=strategy)
        print(f"3/4. {strategy:8s}: picked {len(set(sel.selected.tolist()))} "
              f"distinct sites, mean posterior var {float(sel.post_var.mean()):.3f}")

    # 5. Full informative-path episode --------------------------------------
    cfg = episode_config()
    result = Agent(FieldEnv(cfg.field, cfg.kernel, device=dev), cfg).run()
    print(f"5. episode:       RMSE {result.history[0]['rmse']:.3f} → "
          f"{result.rmse:.3f} in {result.state.step} steps, "
          f"{len(result.state.sampled_idx)} samples")

    # 6. Multi-trait phenotyping: every trait's restarts in one batch -------
    env6 = FieldEnv(FieldConfig(num_rows=8, num_cols=10, num_traits=3, seed=6),
                    device=dev)
    idx6, Y6, _, _ = env6.collect_traits(np.arange(0, env6.n, 2), "precise")
    res6 = gp_mod.fit_multi(
        KernelSpec("rbf", ds=2), FitConfig(iters=60, restarts=2),
        rows(env6.X, idx6), torch.as_tensor(Y6, dtype=torch.float32, device=dev),
    )
    print(f"6. multi-trait:   {Y6.shape[1]} traits fit in one batched fit, "
          f"NLLs {np.round(res6.nll.double().cpu().numpy(), 1).tolist()}")

    # 7. Deep feature kernel (a learned embedding) --------------------------
    rng7 = np.random.default_rng(7)
    xy7 = rng7.uniform(0, 10, (150, 2))
    u7 = rng7.uniform(-2, 2, (150, 1))
    y7 = (2.0 * (u7[:, 0] > 0) - 1 + 0.05 * rng7.standard_normal(150)).astype(np.float32)
    x7 = np.concatenate([xy7, u7], 1).astype(np.float32)
    res7 = nets.fit_deep(
        KernelSpec("rbf", "rbf", ds=2, df=1), MLPSpec(hidden=(16,), out=3),
        FitConfig(iters=100, restarts=2), torch.as_tensor(x7, device=dev),
        torch.as_tensor(y7, device=dev),
    )
    print(f"7. deep kernel:   MLP embedding + hypers jointly fit, "
          f"NLL {float(res7.nll):.1f}")

    # 8. Large-N regime: low-rank MI + sparse GP ----------------------------
    zidx = acq_lr.kcenter_indices(env.X, 60)  # inducing design
    sel8 = acq_lr.greedy_select_lowrank(
        gp.spec, params, env.X, nv, pilot, env.X.index_select(0, zidx),
        rounds=25, num_pilot=20,
    )  # the same MI, O(N·M) state: scales to 100k+ candidates
    sgp = SparseGP(KernelSpec("rbf", ds=2), num_inducing=60,
                   fit_config=FitConfig(iters=80, restarts=2), device=dev)
    sgp.fit(rows(env.X, s.indices), s.y)
    mean8, _ = sgp.predict(env.X)
    print(f"8. large-N:       low-rank MI picked "
          f"{len(set(sel8.selected.tolist()))} distinct sites; "
          f"SGPR RMSE {env.rmse(mean8.cpu().numpy()):.3f}")

    # 9. The episode sharded over a world of ranks --------------------------
    # (gloo ranks: on the CPU, or sharing the one card; NCCL needs a card a rank)
    from algp_tpu_torch.parallel import launch

    outs = launch.run(f"{os.path.abspath(__file__)}:mesh_episode", MESH_WORLD,
                      backend="gloo", device=dev.type, kwargs={"device": dev.type},
                      timeout=300)
    same9 = all(np.array_equal(o["sites"], result.state.sampled_idx) for o in outs)
    print(f"9. mesh episode:  RMSE {float(outs[0]['rmse']):.3f} on a world of "
          f"{MESH_WORLD} ranks (paths ≡ single-device: {same9})")

    # 10. Long campaigns: SGPR refits past a sampled-set threshold ----------
    cfg10 = dataclasses.replace(
        cfg,
        fit=dataclasses.replace(cfg.fit, sparse_threshold=40, sparse_inducing=32),
        episode=dataclasses.replace(cfg.episode, budget=160.0, num_waypoints=12),
    )
    r10 = Agent(FieldEnv(cfg10.field, cfg10.kernel, device=dev), cfg10).run()
    print(f"10. long campaign: {len(r10.state.sampled_idx)} samples — refits "
          f"switch to the collapsed SGPR bound past 40")

    # 11. Warm refits: restart 0 from the incumbent, a shrunk schedule -------
    cfg11 = dataclasses.replace(
        cfg, fit=dataclasses.replace(cfg.fit, refit_iters=60, refit_restarts=2))
    r11 = Agent(FieldEnv(cfg11.field, cfg11.kernel, device=dev), cfg11).run()
    print(f"11. warm refits:  RMSE {r11.rmse:.3f} (60 steps × 2 restarts a refit)")

    # 12. Deep feature kernel on a warped-feature field ---------------------
    cfg12 = dataclasses.replace(
        cfg,
        kernel=KernelSpec("matern52", "rbf", ds=2, df=8),
        field=FieldConfig(num_rows=20, num_cols=30, num_features=8,
                          feature_warp="tanh", true_ls_feature=0.8, seed=0),
        deep=MLPSpec(hidden=(16,), out=8, weight_decay=0.1),
    )
    r12 = Agent(FieldEnv(cfg12.field, cfg12.kernel, device=dev), cfg12).run(max_steps=6)
    print(f"12. deep kernel:  RMSE {r12.rmse:.3f} on a warped-feature field "
          f"(embedding trained jointly with the MLL inside the episode)")

    # 13. Low-rank planner, yield-aware utility, z-ensemble -----------------
    cfg13 = dataclasses.replace(
        cfg,
        acquisition=AcquisitionConfig(strategy="mi", num_inducing=48,
                                      path_utility="per_sample", mi_ensemble=3),
    )
    r13 = Agent(FieldEnv(cfg13.field, cfg13.kernel, device=dev), cfg13).run()
    print(f"13. r4 planner:   RMSE {r13.rmse:.3f} (low-rank MI, yield-aware "
          f"utility, 3-design z-ensemble)")

    # 14. Goal-conditioned (waypoint) campaigns -----------------------------
    env14 = FieldEnv(cfg.field, cfg.kernel, device=dev)
    goals = (env14.rowcol_to_index(2, 15), env14.rowcol_to_index(5, 0))
    cfg14 = dataclasses.replace(
        cfg, episode=dataclasses.replace(cfg.episode, waypoint_goals=goals))
    r14 = Agent(env14, cfg14).run()
    print(f"14. waypoints:    visited {r14.state.goal_i}/{len(goals)} goals, "
          f"RMSE {r14.rmse:.3f} (goal-conditioned enumeration)")

    # 15. Exact mid-episode checkpoint / resume -----------------------------
    half = Agent(FieldEnv(cfg.field, cfg.kernel, device=dev), cfg).run(max_steps=3)
    with tempfile.TemporaryDirectory() as tmp:
        path15 = os.path.join(tmp, "episode.npz")
        ckpt.save(path15, half.state)
        r15 = Agent(FieldEnv(cfg.field, cfg.kernel, device=dev), cfg).run(
            resume_from=ckpt.load(path15, dev))
    full15 = Agent(FieldEnv(cfg.field, cfg.kernel, device=dev), cfg).run()
    same = np.array_equal(r15.state.sampled_idx, full15.state.sampled_idx)
    print(f"15. resume:       interrupted@3 + resume ≡ uninterrupted: {same} "
          f"({len(r15.state.sampled_idx)} samples, RMSE {r15.rmse:.3f})")

    # 16. Coregionalized multi-trait GP (ICM) -------------------------------
    env16 = FieldEnv(FieldConfig(num_rows=8, num_cols=10, num_traits=2,
                                 trait_corr=0.9, seed=16), device=dev)
    idx16, Y16, _, _ = env16.collect_traits(np.arange(0, env16.n, 2), "precise")
    mask16 = np.ones_like(Y16, bool)
    mask16[::3, 1] = False  # trait 1 under-observed
    mean16, _, res16 = icm.fit_predict_icm(
        KernelSpec("rbf", ds=2), FitConfig(iters=60, restarts=2),
        rows(env16.X, idx16), torch.as_tensor(Y16, dtype=torch.float32, device=dev),
        env16.X, torch.as_tensor(mask16, device=dev), rank=1,
    )
    B16 = icm.trait_cov(res16.params).cpu().numpy()
    corr16 = B16[0, 1] / np.sqrt(B16[0, 0] * B16[1, 1])
    print(f"16. ICM:          fitted cross-trait corr {corr16:.2f} "
          f"(true 0.9), per-trait RMSE "
          f"{[round(v, 3) for v in env16.rmse_traits(mean16.cpu().numpy())]}")


if __name__ == "__main__":
    main()
