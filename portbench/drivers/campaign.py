"""Driver of the long SGPR campaign (preset `c5_long`): `episode.Agent.run`
episodes back to back as the preset runs them, each a fresh Agent with
its own episode seed drawn from the run's seed, on a field made from the
run's seed (the `episode` driver's field, inits, probes and records).

What differs from the `episode` driver:
- set-up hands the configuration's `sparse_threshold` and
  `sparse_inducing` to the program's `FitConfig`, so a refit past the
  threshold fits Titsias' collapsed bound over a k-center design;
- the warm-up runs one campaign through `Agent.run(max_steps=…)` to a few
  steps past its first SGPR refit: the sample capacity is fixed from the
  start and the SGPR buffer is padded to it, so that reaches every shape
  an episode uses without a whole episode in set-up;
- a call made under the profiler (the harness's traced sub-window) runs
  a segment of a campaign instead of a whole one: `TRACE_SEGMENT` steps
  resumed (`Agent.run(resume_from=…)`) from the state where the warm-up
  stopped, past its first SGPR refit, so two SGPR refits, their exact
  re-seeds and the plan calls between them.  A whole campaign's 40 fits
  make millions of profiler events, and on an H100 such a traced
  campaign ran past ten minutes;
- an answer is valid within the capacity the program derives from the
  budget;
- the check follows each plan call with the plain reference of the exact
  planner (`portbench/reference/campaign.py`, float64: the exact
  posterior, the MI score of every candidate path under the exact
  complement precision, the `per_cost` utility) at the program's fitted
  hyperparameters, and holds each fit by itself: an exact fit to the
  exact −MLL (`reference/gp.py`, as the `episode` driver does), an SGPR
  fit to the collapsed −ELBO on the reference's own k-center design over
  the same samples.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time

import numpy as np
import torch

from portbench.drivers import episode as base
from portbench.reference import campaign as ref
from portbench.reference import paths as ref_paths

#: the warm-up's steps past the first SGPR refit
WARM_PAST_SGPR = 4
#: the steps of the campaign segment that a traced call runs
TRACE_SEGMENT = 8


def capacity(c: dict) -> int:
    """The static sample capacity the program derives from the budget
    (`episode.Agent`): the pilots, then ceil(num_waypoints /
    min_cost_frac) + 6 full steps, rounded up to a multiple of 8."""
    if c["max_samples"] is not None:
        cap = int(c["max_samples"])
    else:
        frac = max(c["min_cost_frac"], 1e-6)
        cap = c["num_pilot"] + (int(np.ceil(c["num_waypoints"] / frac)) + 6) * c["samples_per_step"]
    return (cap + 7) // 8 * 8


class Driver(base.Driver):
    """One run's field, program, campaigns and answers."""

    def setup(self) -> None:
        super().setup()
        c = self.cfg
        self.exp = dataclasses.replace(self.exp, fit=dataclasses.replace(
            self.exp.fit, sparse_threshold=int(c["sparse_threshold"]),
            sparse_inducing=int(c["sparse_inducing"])))
        self.capacity = capacity(c)
        self.segment_start = None  # the warm-up's last state (`warm`)

    def _sgpr(self, n_sampled: int) -> bool:
        """Whether the program fits the SGPR bound at this many samples."""
        return n_sampled > self.cfg["sparse_threshold"]

    def warm_steps(self) -> int:
        """The step of the first refit past the threshold at full paths,
        plus WARM_PAST_SGPR."""
        c = self.cfg
        t = c["refit_every"]
        while c["num_pilot"] + c["samples_per_step"] * t <= c["sparse_threshold"]:
            t += c["refit_every"]
        return t + WARM_PAST_SGPR

    def warm(self, seconds: float) -> None:
        """Campaigns cut at `warm_steps` (one more refit interval while
        a cut campaign reached no SGPR refit), at least one and for at
        least `seconds`."""
        from algp_tpu_torch import episode as ep_mod
        from portbench.harness import log

        orig = ep_mod.Agent.run
        steps, t0, runs = self.warm_steps(), time.perf_counter(), []

        def cut(agent, *a, **k):
            res = orig(agent, *a, max_steps=steps, **k)
            self.segment_start = res.state
            return res

        try:
            ep_mod.Agent.run = cut
            while True:
                a = self._episode(-1)
                runs.append({"steps": len(a["latencies"]), "fits": len(a["fits"]),
                             "sgpr_fits": sum(self._sgpr(f["n_sampled"]) for f in a["fits"]),
                             "wall_s": round(sum(a["latencies"]), 4)})
                if not runs[-1]["sgpr_fits"] and runs[-1]["steps"] > steps:
                    steps += self.cfg["refit_every"]  # cut before its first SGPR refit
                elif time.perf_counter() - t0 >= seconds:
                    break
        finally:
            ep_mod.Agent.run = orig
        log(f"warm-up campaigns {runs}")
        self.answers.clear()

    def call(self, i: int) -> int:
        """Campaign i, or under the profiler its segment (the module's
        docstring); returns its plan steps."""
        from algp_tpu_torch import episode as ep_mod

        if self.segment_start is None or not torch._C._autograd._profiler_enabled():
            return super().call(i)
        # run() rebinds the state's arrays and parameters, never writes into them
        st = dataclasses.replace(self.segment_start)
        orig = ep_mod.Agent.run
        ep_mod.Agent.run = functools.partialmethod(
            orig, max_steps=st.step + TRACE_SEGMENT, resume_from=st)
        try:
            units = super().call(i)
        finally:
            ep_mod.Agent.run = orig
        # its first plans ran at the parameters the warm-up fitted last
        self.answers[i]["start"] = (self.segment_start.step,
                                    base._vec(self.segment_start.params))
        return units

    # ------------------------------------------------------------ checks

    def validity(self, a: dict) -> bool:
        s = a["sampled_idx"]
        return (len(a["plans"]) >= 1 and len(s) <= self.capacity
                and bool(((s >= 0) & (s < self.n)).all())
                and all(math.isfinite(p["rmse"]) for p in a["plans"]))

    def check(self, i: int, a: dict) -> dict:
        """path_gap, rmse_gap and var_gap as the `episode` driver reads
        them, each plan followed by the exact reference at the parameters
        of the program's latest fit (a segment's first plans at those its
        start state carried); fit_trace_gap and fit_nll_gap, the worst of
        each fit held by itself (`_fit_gaps`)."""
        field = self._ref_field(torch.float64)
        out = {"path_gap": 0.0, "rmse_gap": 0.0, "var_gap": 0.0,
               "fit_trace_gap": 0.0, "fit_nll_gap": 0.0}
        fitted = [a["start"]] if "start" in a else []
        a["fit_step_gaps"] = []
        for f in a["fits"]:
            steps, nll_gap = self._fit_gaps(i, a, f)
            a["fit_step_gaps"].append(steps)
            out["fit_trace_gap"] = max(out["fit_trace_gap"], max(steps, default=0.0))
            out["fit_nll_gap"] = max(out["fit_nll_gap"], nll_gap)
            fitted.append((f["step"], base._vec(f["params"])))
        model = (None, None)
        S, y, sc = a["sampled_idx"], a["y"], a["noise_scale"]
        for p in a["plans"]:
            key, q = max(((s, v) for s, v in fitted if s <= p["step"]), key=lambda v: v[0])
            if model[0] != key:
                model = (None, None)  # one N × N precision at a time
                model = (key, self._ref_model(field, q))
            m = p["n_sampled"]
            metrics, cand, util = self._plan_ref(field, model[1], p["pose"], p["budget_left"],
                                                 S[:m], y[:m], sc[:m])
            out["rmse_gap"] = max(out["rmse_gap"],
                                  abs(p["rmse"] - metrics["rmse"]) / metrics["rmse"],
                                  abs(p["rmse_test"] - metrics["rmse_test"]) / metrics["rmse_test"])
            out["var_gap"] = max(out["var_gap"],
                                 abs(p["mean_var"] - metrics["mean_var"]) / metrics["mean_var"])
            out["path_gap"] = max(out["path_gap"], self._gap(p, cand, util))
        return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}

    def _ref_field(self, dtype):
        """Coordinates, truth and held-out split in `dtype`; no design."""
        x = self.env.X.to(dtype)
        f = torch.as_tensor(self.env.f, device=self.dev).to(dtype)
        return x, f, torch.as_tensor(self.env.test_mask, device=self.dev), None

    def _ref_model(self, field, p: torch.Tensor):
        """(log_ls, log_s2, the noise variance, the prior precision of the
        noisy field over every cell) for p = (ls, ls, s², noise std)."""
        x = field[0]
        nv = max(math.exp(2.0 * float(p[3])), self.cfg["min_noise"] ** 2)
        return p[:2], p[2], nv, ref.prior_precision(self.cfg["kernel"], x, nv, p[:2], p[2])

    def _plan_ref(self, field, model, pose, budget_left, A, yA, scaleA):
        """The reference's plan call at a state: the metrics of the exact
        posterior given A, the candidate sets and their `per_cost`
        utilities under the exact complement precision."""
        x, f, test, _ = field
        log_ls, log_s2, nv, P = model
        c, dev = self.cfg, self.dev
        A_t = torch.as_tensor(A, device=dev)
        nvA = torch.as_tensor(scaleA, device=dev).to(x.dtype) * nv
        yA_t = torch.as_tensor(yA, device=dev).to(x.dtype)
        mean, var = ref.posterior(c["kernel"], x, x[A_t], yA_t, nvA, log_ls, log_s2)
        err = mean - f
        metrics = {"rmse": float(torch.sqrt((err * err).mean())),
                   "rmse_test": float(torch.sqrt((err[test] ** 2).mean())),
                   "mean_var": float(var.mean())}
        budget = min(budget_left, c["budget"] / max(1, c["num_waypoints"]))
        paths = ref_paths.enumerate_paths(
            c["num_rows"], c["num_cols"], 1.0, 1.0, pose, budget,
            max_paths=256, max_turns=2, min_cost_frac=c["min_cost_frac"])
        if not paths:
            return metrics, None, None
        sets, sizes, costs = ref_paths.thin(paths, c["samples_per_step"])
        sets_t = torch.as_tensor(sets, device=dev)
        sizes_t = torch.as_tensor(sizes, device=dev)
        scores = ref.set_scores(c["kernel"], x, sets_t, sizes_t, A_t, nvA, nv, P,
                                log_ls, log_s2)
        util = ref.per_cost_utility(scores, sizes_t, torch.as_tensor(costs, device=dev))
        return metrics, (sets, sizes, costs), util.cpu().numpy()

    def _fit_gaps(self, i: int, a: dict, f: dict):
        """An exact fit as the `episode` driver holds it; an SGPR fit (past
        the threshold) against the reference's collapsed −ELBO on its own
        k-center design over the same samples: the gap of each of its
        first Adam steps from the same inits (the worst restart) and of
        its reported −ELBO at its returned parameters."""
        if not self._sgpr(f["n_sampled"]):
            return super()._fit_gaps(i, a, f)
        c, dev, f64 = self.cfg, self.dev, torch.float64
        m = f["n_sampled"]
        idx = torch.as_tensor(a["sampled_idx"][:m], device=dev)
        x = self.env.X.to(f64)[idx]
        y = torch.as_tensor(a["y"][:m], device=dev).to(f64)
        sc = torch.as_tensor(a["noise_scale"][:m], device=dev).to(f64)
        z = x[ref.kcenter(x, min(c["sparse_inducing"], m), m)]
        warm = f["incumbent"] is not None
        R = (c["refit_restarts"] or c["fit_restarts"]) if warm else c["fit_restarts"]
        t = self.init_table(i, f["step"], R, f64)
        if warm:
            t[0] = base._vec(f["incumbent"])

        def loss(q):
            return ref.neg_elbo(c["kernel"], x, y, z, q[0], q[1], q[2],
                                min_noise=c["min_noise"], count=m, noise_scale=sc)

        got = f["trace"].to(f64)
        steps = []
        if got.shape[-1]:
            want = ref.adam(loss, [t[:, :2], t[:, 2], t[:, 3]], iters=got.shape[-1],
                            lr=c["learning_rate"])["trace"]
            gap = (got - want).abs() / torch.clamp_min(want.abs(), 1.0)
            steps = [float(v) if math.isfinite(v) else math.inf
                     for v in torch.nan_to_num(gap, nan=math.inf).amax(0).tolist()]
        p = base._vec(f["params"])
        with torch.no_grad():
            nll = float(loss([p[None, :2], p[2:3], p[3:4]])[0])
        nll_gap = abs(float(f["nll"]) - nll) / max(1.0, abs(nll))
        return steps, (nll_gap if math.isfinite(nll_gap) else math.inf)

    def summary(self, a: dict) -> dict:
        """The `episode` driver's line, with the fits past the threshold
        and the fit kinds the program's records name (where it names
        them)."""
        kinds: dict = {}
        for r in a["records"]:
            if "fit_kind" in r:
                kinds[r["fit_kind"]] = kinds.get(r["fit_kind"], 0) + 1
        return {**super().summary(a),
                "sgpr_fits": sum(self._sgpr(f["n_sampled"]) for f in a["fits"]),
                "fit_kinds": kinds, "samples": int(len(a["sampled_idx"]))}

    def describe(self, a: dict) -> dict:
        return {**super().describe(a),
                "sgpr_fits": sum(self._sgpr(f["n_sampled"]) for f in a["fits"])}


def faults(traffic: dict) -> dict:
    """The faults that a run of this traffic can have, each a function
    that plants it in the program through a pytest-style `monkeypatch`:
    the `episode` driver's altered answer and unchanged fit, and the
    campaign's own four."""
    return {"state_unchanged": _stale_plans, "half_batch": _half_plans,
            "altered_answer": base._altered_path, "fit_unchanged": base._fit_unchanged,
            "sgpr_design_altered": _design_altered, "sgpr_fit_altered": _sgpr_fit_altered}


def _stale_plans(mp) -> None:
    """Every exact plan conditions on the first 16 samples alone."""
    from algp_tpu_torch import acquisition as acq

    orig = acq.plan_episode_step

    def stale(spec, params, x, idx_pad, count, *a, **k):
        return orig(spec, params, x, idx_pad, min(int(count), 16), *a, **k)
    mp.setattr(acq, "plan_episode_step", stale)


def _half_plans(mp) -> None:
    """An exact plan sees half of its samples."""
    from algp_tpu_torch import acquisition as acq

    orig = acq.plan_episode_step

    def half(spec, params, x, idx_pad, count, *a, **k):
        return orig(spec, params, x, idx_pad, int(count) // 2, *a, **k)
    mp.setattr(acq, "plan_episode_step", half)


def _design_altered(mp) -> None:
    """The SGPR design is the first valid rows instead of the k-center
    design."""
    from algp_tpu_torch.models import sparse_gp

    def first_rows(x, num_valid, num_inducing, caller):
        return x[:min(num_inducing, x.shape[0])]
    mp.setattr(sparse_gp, "_valid_design", first_rows)


def _sgpr_fit_altered(mp) -> None:
    """An SGPR fit returns parameters 0.05 (the learning rate) off, in
    every log-parameter, from those whose −ELBO it reports."""
    from algp_tpu_torch.models import sparse_gp

    orig = sparse_gp._fit_sparse_batched

    def altered(*a, **k):
        res = orig(*a, **k)
        res.params = res.params.map(lambda t: t + 0.05)
        return res
    mp.setattr(sparse_gp, "_fit_sparse_batched", altered)


def make(config: dict, traffic: dict, seed: int, device) -> Driver:
    return Driver(config, traffic, seed, device)
