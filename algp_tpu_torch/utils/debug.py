"""Numerical-health checks (the counterpart of algp_tpu.utils.debug).

The failure modes of this workload are numerical: NaN / Inf from a
non-SPD factorization, exploding hyperparameters, collapsed noise.

  * `checked(fn)`: runs fn under a dispatch mode that notes, on the
    device, the first op to produce a NaN or Inf from finite inputs, and
    reads that note once when the call ends (a debug tool: every op pays
    a finiteness check, so keep it off hot paths);
  * `assert_finite_tree`: every leaf of a tree of tensors is finite;
  * `fit_health_report`: a FitResult at a glance (diverged restarts, best
    vs first NLL, hyperparameter ranges).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

_NONE = 1 << 62  # "no bad op yet", above any op count


def tree_flatten_with_path(tree: Any, path: tuple = ()) -> list:
    """[(path, leaf)] of a tree of tensors, arrays and numbers: a
    dataclass's fields in order, a list's or tuple's items in order (the
    leaf order of `models.gp.tree_leaves`), a dict's items by sorted key;
    None holds no leaf.  Path entries print as the reference's do:
    `.field`, `[i]`, `['key']`."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree)
                for kv in tree_flatten_with_path(getattr(tree, f.name),
                                                 path + (f".{f.name}",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, item in enumerate(tree)
                for kv in tree_flatten_with_path(item, path + (f"[{i}]",))]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_flatten_with_path(tree[k], path + (f"[{k!r}]",))]
    return [(path, tree)]


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    """Every leaf of the tree must be finite; raises FloatingPointError
    naming the first leaf that is not.  The non-finite counts of a
    device's tensors come to the host in one copy."""
    leaves = tree_flatten_with_path(tree)
    bad = [None] * len(leaves)
    by_dev: dict = {}
    for i, (_, leaf) in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            cnt = torch.sum(~torch.isfinite(leaf.detach()))
            by_dev.setdefault(leaf.device, []).append((i, cnt))
        else:
            bad[i] = int((~np.isfinite(np.asarray(leaf))).sum())
    for pairs in by_dev.values():
        counts = torch.stack([c for _, c in pairs]).tolist()
        for (i, _), c in zip(pairs, counts):
            bad[i] = c
    for (path, leaf), k in zip(leaves, bad):
        if k:
            keys = "/".join(path)
            size = leaf.numel() if isinstance(leaf, torch.Tensor) else np.asarray(leaf).size
            raise FloatingPointError(
                f"{name}{'/' + keys if keys else ''}: {k} non-finite "
                f"of {size} entries"
            )


def fit_health_report(fit_result) -> dict:
    """Summarize a models.gp.FitResult for debugging / monitoring, with
    the reference's keys and f32 arithmetic; the result's tensors come to
    the host in one copy."""
    p = fit_result.params
    parts = [fit_result.all_nlls, fit_result.nll_trace, fit_result.nll,
             fit_result.best_restart, p.log_ls_spatial, p.log_ls_feature,
             p.log_outputscale, p.log_noise]
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in parts])
    host = np.split(flat.cpu().numpy(), np.cumsum([t.numel() for t in parts])[:-1])
    nlls, trace, nll, best, ls_sp, ls_ft, log_os, log_noise = host
    trace = trace.reshape(fit_result.nll_trace.shape)
    best = int(best[0])
    report = {
        "restarts": int(nlls.shape[0]),
        "diverged_restarts": int((~np.isfinite(nlls)).sum()),
        "best_restart": best,
        "best_nll": float(nll[0]),
        "nll_spread": float(np.nanmax(nlls) - np.nanmin(nlls))
        if np.isfinite(nlls).any()
        else float("nan"),
        "ls_spatial": np.exp(ls_sp).tolist(),
        "ls_feature": np.exp(ls_ft).tolist(),
        "outputscale": float(np.exp(log_os[0])),
        "noise_std": float(np.exp(log_noise[0])),
    }
    if trace.size:
        report["nll_improvement"] = float(trace[best, 0] - nll[0])
    return report


class CheckError:
    """What `checked` found: the first op that made a NaN or Inf from
    finite inputs (None if none did)."""

    def __init__(self, op: Optional[str], index: Optional[int]):
        self.op, self.index = op, index

    def get(self) -> Optional[str]:
        """The error's message, or None."""
        if self.op is None:
            return None
        return (f"non-finite value produced by op #{self.index} ({self.op}) "
                f"from finite inputs")

    def throw(self) -> None:
        """Raise FloatingPointError if an op went non-finite."""
        msg = self.get()
        if msg is not None:
            raise FloatingPointError(msg)


class _FloatChecks(TorchDispatchMode):
    """Numbers the ops with float outputs; keeps, on each device, the index
    of the first whose inputs were finite and whose outputs are not.
    Nothing is read on the host while the mode is on."""

    def __init__(self):
        super().__init__()
        self.ops: list[str] = []
        self.first: dict = {}  # device → int64 tensor, _NONE when clean

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # the allocators' garbage is no op's result
        if "empty" in func.__name__:
            return func(*args, **kwargs)
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor) and t.is_floating_point()]
        # read the inputs before an in-place op overwrites them
        ok_in = [torch.isfinite(t).all() for t in ins]
        out = func(*args, **kwargs)
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.is_floating_point()]
        if not outs:
            return out
        k = len(self.ops)
        self.ops.append(str(func))
        dev = outs[0].device
        bad = torch.stack([~torch.isfinite(t).all() for t in outs]).any()
        if ok_in:
            bad = bad & torch.stack([o.to(dev) for o in ok_in]).all()
        first = self.first.get(dev)
        if first is None:
            first = torch.full((), _NONE, dtype=torch.int64, device=dev)
        self.first[dev] = torch.minimum(first, torch.where(bad, k, _NONE))
        return out


def checked(fn: Callable) -> Callable:
    """Wrap fn so a call returns (err, out); `err.throw()` raises
    FloatingPointError naming the first op that produced a NaN or Inf
    from finite inputs (the counterpart of `checkify.float_checks`).

    Usage:
        err, out = debug.checked(my_fn)(*args)
        err.throw()
    """

    def run(*args, **kwargs):
        mode = _FloatChecks()
        with mode:
            out = fn(*args, **kwargs)
        # one read a device, when the call has ended
        hits = [int(t) for t in mode.first.values()]
        k = min(hits, default=_NONE)
        if k == _NONE:
            return CheckError(None, None), out
        return CheckError(mode.ops[k], k), out

    return run
