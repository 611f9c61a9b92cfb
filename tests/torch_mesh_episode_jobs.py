"""Rank programs of tests/test_torch_sharded_episode.py.  `run_cases` runs on
every rank of a world started by `algp_tpu_torch.parallel.launch`; it
imports torch and the port, never JAX.  Inputs arrive as numpy arrays and
port configs; each case writes its outputs under "<case>/<field>"."""

from __future__ import annotations

import numpy as np
import torch

from algp_tpu_torch import acquisition as acq
from algp_tpu_torch.convert import (
    field_env_from_attrs,
    kernel_params_from_numpy,
    kernel_params_to_numpy,
)
from algp_tpu_torch.episode import Agent
from algp_tpu_torch.models import gp
from algp_tpu_torch.ops import gram as G
from algp_tpu_torch.ops.kernels import KernelSpec
from algp_tpu_torch.parallel import dryrun, sharded
from algp_tpu_torch.parallel import sharded_episode as sep

SPEC = KernelSpec("rbf", ds=2)


def episode(mesh, c: dict, device: str) -> dict:
    """A mesh episode: `c["cfg"]` (a port ExperimentConfig) on the env of
    `c["env"]` (`convert.field_env_attrs`) for `c["max_steps"]` steps, its
    fits from `c["inits"]` ({(step, restarts): numpy inits}) where given,
    `acquisition.COND_MATMUL_N` set to `c["cond_matmul_n"]` where given.
    Returns the sites, the plan records' metrics, the final fields, each
    fit's parameters, the seed builds seen by each plan call, the cached
    seed's shape and the Gram kernel's launches (0 on the CPU)."""
    saved = {"step_inits": gp.step_inits, "gate": acq.COND_MATMUL_N,
             "lr": sep.sharded_lowrank_seed, "w": sep.sharded_precision_seed}
    builds, fits, seen = [0], [], []

    def counted(fn):
        def seed(*a, **k):
            builds[0] += 1
            return fn(*a, **k)
        return seed

    if "inits" in c:
        table = c["inits"]
        gp.step_inits = lambda spec, cfg, seed, step, dev: kernel_params_from_numpy(
            table[(step, cfg.restarts)], dev)
    acq.COND_MATMUL_N = c.get("cond_matmul_n", acq.COND_MATMUL_N)
    sep.sharded_lowrank_seed = counted(saved["lr"])
    sep.sharded_precision_seed = counted(saved["w"])
    try:
        agent = Agent(field_env_from_attrs(c["env"], device), c["cfg"], mesh=mesh)
        fit_model, plan = agent.fit_model, agent._plan_and_metrics

        def fit(st, lagged=False):
            res = fit_model(st, lagged)
            fits.append(np.concatenate([np.ravel(v) for v in
                                        kernel_params_to_numpy(res.params).values()]))
            return res

        def planned(st):
            out = plan(st)
            seen.append(builds[0])
            return out

        agent.fit_model, agent._plan_and_metrics = fit, planned
        launches = G.LAUNCHES
        res = agent.run(max_steps=c["max_steps"])
        launches = G.LAUNCHES - launches
    finally:
        gp.step_inits, acq.COND_MATMUL_N = saved["step_inits"], saved["gate"]
        sep.sharded_lowrank_seed, sep.sharded_precision_seed = saved["lr"], saved["w"]
    plans = [h for h in res.history if "rmse" in h]
    out = {"sites": res.state.sampled_idx, "noise_scale": res.state.noise_scale,
           "steps": np.asarray([h["step"] for h in plans]),
           **{k: np.asarray([h[k] for h in plans]) for k in ("rmse", "rmse_test", "mean_var")},
           "final_rmse": np.asarray(res.rmse), "mean": res.mean, "fit_params": np.stack(fits),
           "seed_builds": np.asarray(seen), "n_pad": np.asarray(agent._mesh_x().shape[0]),
           "gram_launches": np.asarray(launches)}
    if res.trait_rmse is not None:
        out["trait_rmse"] = np.asarray(res.trait_rmse)
    if agent._lr_cache is not None:
        out["seed_VT"] = np.asarray(agent._lr_cache[1].VT.shape)
        out["seed_dinv"] = np.asarray(agent._lr_cache[1].dinv.shape)
    if agent._P_cache is not None:
        out["seed_W"] = np.asarray(agent._P_cache[1].shape)
    return out


def _case(mesh, kind: str, c: dict, device: str) -> dict:
    def t(a, dt=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dt, device=device)

    if kind == "episode":
        return episode(mesh, c, device)
    if kind == "dryrun_episodes":
        return dryrun.episode_checks(mesh, device)
    params = kernel_params_from_numpy(c["params"], device)
    x, n_valid = sep.mesh_pad(t(c["x"]), mesh.grid)
    if kind == "w_seed":
        return {"W": np.asarray(sep.sharded_precision_seed(mesh, SPEC, params, x).shape)}
    lr = sep.sharded_lowrank_seed(mesh, SPEC, params, x, t(c["z"]), n_valid=n_valid)
    if kind == "lr_seed":
        return {"VT": np.asarray(lr.VT.shape), "dinv": np.asarray(lr.dinv.shape),
                "pdiag": np.asarray(lr.pdiag.shape)}
    if kind == "step":
        best, mean, var, scores = sep.sharded_plan_episode_step(
            mesh, SPEC, params, x, t(c["idx_pad"], torch.int64), int(c["count"]),
            t(c["ns_pad"]), t(c["y_pad"]), t(c["sets"], torch.int64),
            t(c["sizes"], torch.int64), t(c["costs"]), lr=lr, strategy="mi",
            n_valid=n_valid)
        both = sharded.all_gather(torch.stack([mean, var]).reshape(-1), mesh.grid_group)
        mean_all, var_all = both.reshape(mesh.grid, 2, -1).permute(1, 0, 2).reshape(2, -1)
        return {"best": best.cpu().numpy(), "scores": scores.cpu().numpy(),
                "mean": mean_all.cpu().numpy(), "var": var_all.cpu().numpy(),
                "mean_local": np.asarray(mean.shape), "var_local": np.asarray(var.shape)}
    raise ValueError(kind)


def run_cases(cases: dict, device: str = "cpu") -> dict:
    """Every case on its mesh of this world, in order: `cases` maps a name to
    (kind, restarts_axis, inputs); one mesh is made for each restarts_axis,
    in order of first use, by every rank alike."""
    meshes, out = {}, {}
    for name, (kind, restarts_axis, c) in cases.items():
        if restarts_axis not in meshes:
            meshes[restarts_axis] = sharded.make_mesh(restarts_axis=restarts_axis)
        mesh = meshes[restarts_axis]
        out[f"{name}/mesh"] = np.asarray([mesh.restarts, mesh.grid, mesh.r, mesh.g])
        out.update({f"{name}/{k}": v for k, v in _case(mesh, kind, c, device).items()})
    return out
