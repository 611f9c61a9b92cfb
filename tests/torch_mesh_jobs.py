"""Rank programs of tests/test_torch_sharded.py.  `run_cases` runs on every
rank of a world started by `algp_tpu_torch.parallel.launch`; it imports
torch and the port, never JAX.  Inputs arrive as numpy arrays; each case
writes its outputs under "<case>/<field>"."""

from __future__ import annotations

import time

import numpy as np
import torch

from algp_tpu_torch.config import FitConfig
from algp_tpu_torch.convert import icm_params_from_numpy, kernel_params_from_numpy
from algp_tpu_torch.ops.kernels import KernelSpec
from algp_tpu_torch.parallel import dist_linalg, dryrun, sharded
from algp_tpu_torch.parallel.sharded_lowrank import sharded_greedy_select_mi_lowrank
from algp_tpu_torch.parallel.sharded_mi import sharded_greedy_select_mi

SPEC = KernelSpec("rbf", ds=2)


def _sel(res, mesh) -> dict:
    """A selection's replicated outputs: indices, gathered variances, and
    this rank's precision strips."""
    out = {"selected": res.selected.cpu().numpy(),
           "post_var": res.gather_post_var(mesh).cpu().numpy()}
    out.update({f"strip_{k}": np.asarray(v) for k, v in res.strips.items()})
    return out


def _case(mesh, kind: str, c: dict, device: str) -> dict:
    def _f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

    def _i64(a):
        return torch.tensor(np.asarray(a), dtype=torch.int64, device=device)

    if kind == "fit":
        fit = sharded.sharded_fit(mesh, SPEC, FitConfig(**c["cfg"]), _f32(c["x"]), _f32(c["y"]),
                                  inits=kernel_params_from_numpy(c["inits"], device))
        return {"all_nlls": fit.all_nlls.cpu().numpy(), "nll": fit.nll.cpu().numpy()}
    if kind == "fit_icm":
        fit = sharded.sharded_fit_icm(mesh, SPEC, FitConfig(**c["cfg"]), _f32(c["x"]),
                                      _f32(c["Y"]), torch.tensor(c["obs"], device=device),
                                      inits=icm_params_from_numpy(c["inits"], device))
        return {"all_nlls": fit.all_nlls.cpu().numpy(), "nll": fit.nll.cpu().numpy()}
    params = kernel_params_from_numpy(c["params"], device) if "params" in c else None
    if kind == "greedy":
        res = sharded.sharded_greedy_select(
            mesh, SPEC, params, _f32(c["x"]), _f32(c["nv"]), _i64(c["pilot"]),
            rounds=c["rounds"], num_pilot=len(c["pilot"]), strategy=c["strategy"])
        return _sel(res, mesh)
    if kind == "step":
        p, nlls, sel, post_var = sharded.sharded_training_step(
            mesh, SPEC, FitConfig(**c["cfg"]), _f32(c["x_train"]), _f32(c["y_train"]),
            _f32(c["x_grid"]), _f32(c["nv"]), _i64(c["pilot"]), rounds=c["rounds"],
            strategy=c["strategy"], inits=kernel_params_from_numpy(c["inits"], device))
        return {"all_nlls": nlls.cpu().numpy(), "selected": sel.cpu().numpy(),
                "post_var": post_var.cpu().numpy()}
    if kind == "dist_linalg":
        K = _f32(c["K"])
        nl = K.shape[0] // mesh.grid
        L_loc = dist_linalg.dist_cholesky(mesh, K[mesh.g * nl:(mesh.g + 1) * nl])
        W_loc = dist_linalg.dist_tri_inv(mesh, L_loc)
        return {"L": sharded.all_gather(L_loc, mesh.grid_group).cpu().numpy(),
                "W": sharded.all_gather(W_loc, mesh.grid_group).cpu().numpy(),
                "strip": np.asarray(L_loc.shape)}
    if kind == "mi":
        res = sharded_greedy_select_mi(
            mesh, SPEC, params, _f32(c["x"]), _f32(c["nv"]), _i64(c["pilot"]),
            rounds=c["rounds"], num_pilot=len(c["pilot"]),
            distributed_seed=c["distributed_seed"])
        return _sel(res, mesh)
    if kind == "lowrank":
        res = sharded_greedy_select_mi_lowrank(
            mesh, SPEC, params, _f32(c["x"]), _f32(c["nv"]), _i64(c["pilot"]), _f32(c["z"]),
            rounds=c["rounds"], num_pilot=len(c["pilot"]))
        return _sel(res, mesh)
    if kind == "dryrun":
        return dryrun.dryrun_rank(device)
    raise ValueError(kind)


def run_cases(restarts_axis: int, cases: dict, device: str = "cpu") -> dict:
    """Every case on this world's (restarts_axis × rest) mesh, in order, on
    `device`."""
    mesh = sharded.make_mesh(restarts_axis=restarts_axis)
    out = {"mesh": np.asarray([mesh.restarts, mesh.grid, mesh.r, mesh.g])}
    for name, (kind, c) in cases.items():
        out.update({f"{name}/{k}": v for k, v in _case(mesh, kind, c, device).items()})
    return out


def fail(rank_to_fail: int) -> dict:
    """A rank that raises (the launcher must report it)."""
    if torch.distributed.get_rank() == rank_to_fail:
        raise RuntimeError("this rank fails on purpose")
    return {}


def hang() -> dict:
    """Rank 1 waits on a collective that rank 0, alive, never joins (the
    launcher's deadline must end the world)."""
    if torch.distributed.get_rank() == 0:
        time.sleep(600)
    torch.distributed.all_reduce(torch.zeros(1))
    return {}
