"""Driver of informative-path episodes: `episode.Agent.run` one episode
after another on the run's field, each a fresh Agent with its own
episode seed drawn from the run's seed.

With traffic `fit: false` each episode resumes from its pilot survey
(`Agent.pilot_survey`) through `Agent.run(resume_from=…)` with the
field's true hyperparameters in `EpisodeState.params` and no refit
(`refit_every` past any episode's length): a campaign over a field whose
kernel is known from an earlier survey.  With `fit: true` it runs as the
configuration states: the pilot fit, then warm refits every
`refit_every` steps, each fit from restart inits that the driver draws
from the run's seed and hands the program in place of its own draws.

The field is made on the device from the run's seed: a random-Fourier-
feature draw of the configuration's Matérn 3/2 prior, handed to the
program's `FieldEnv` as its truth; the environment senses with its own
seeded generator, and its sensed values and held-out split are inputs
both sides read.

A unit of work is a plan step: the resume or pilot plan and every `plan`
record.  Each plan call (`Agent._plan_and_metrics`: the path enumeration,
the plan step on the card and its one read) is timed on its own: the
robot's wait for its next path once it has sensed and refitted.  A
step's latency runs from the previous plan record, or from
the start of the episode, to its own record; the episode's tail after
its last record (the final posterior fetch) is added to its last step,
so an episode's latencies add up to its wall time.  The check follows
each checked episode plan call by plan call with the plain reference
(`portbench/reference/fitc_plan.py`, float64) at the hyperparameters the
program planned with, and holds each fit by itself
(`portbench/reference/gp.py`): its first `fit_check_steps` Adam steps
from the same inits, and the NLL it reports at the parameters it
returned.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from portbench.reference import fitc_plan as ref
from portbench.reference import paths as ref_paths
from portbench.reference import gp as ref_gp

#: random Fourier features of the field's draw
FIELD_FEATURES = 2048
#: rows of the field made at once
FIELD_BLOCK = 1 << 18


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mix(*parts) -> int:
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1, np.uint64)[0]
               >> np.uint64(2))


class Driver:
    """One run's field, program, episodes and answers."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.seed = config, int(seed)
        self.dev = torch.device(device)
        self.fit = bool(traffic["fit"])
        self.fit_check_steps = int(traffic.get("fit_check_steps", 0))
        self.answers: dict = {}

    # ------------------------------------------------------------ set-up

    def setup(self) -> None:
        from algp_tpu_torch.config import (AcquisitionConfig, EpisodeConfig,
                                           ExperimentConfig, FieldConfig, FitConfig)
        from algp_tpu_torch.field import FieldEnv
        from algp_tpu_torch.ops.kernels import KernelSpec

        c, dev = self.cfg, self.dev
        self.spec = KernelSpec(c["kernel"], ds=2)
        rows, cols = c["num_rows"], c["num_cols"]
        self.n = rows * cols
        g = torch.Generator(device=dev).manual_seed(self.seed)
        truth = self._field(g, rows, cols)
        fcfg = FieldConfig(num_rows=rows, num_cols=cols, true_ls_spatial=c["true_ls"],
                           true_outputscale=c["true_outputscale"], noise_std=c["noise_std"],
                           seed=_mix(self.seed, 1))
        self.env = FieldEnv(fcfg, self.spec, device=dev, truth=truth.cpu().numpy())
        ep = EpisodeConfig(
            num_pilot=c["num_pilot"], budget=c["budget"], num_waypoints=c["num_waypoints"],
            samples_per_step=c["samples_per_step"], min_cost_frac=c["min_cost_frac"],
            refit_every=c["refit_every"] if self.fit else 1 << 30,
            max_samples=c["max_samples"], hard_cap=c["hard_cap"])
        self.exp = ExperimentConfig(
            kernel=self.spec,
            fit=FitConfig(iters=c["fit_iters"], restarts=c["fit_restarts"],
                          refit_iters=c["refit_iters"], refit_restarts=c["refit_restarts"],
                          learning_rate=c["learning_rate"], perturb=c["init_perturb"],
                          init_ls_spatial=c["init_ls"], init_outputscale=c["init_outputscale"],
                          init_noise=c["init_noise"], min_noise=c["min_noise"],
                          jitter=c["jitter"]),
            acquisition=AcquisitionConfig(strategy=c["strategy"],
                                          num_inducing=c["num_inducing"],
                                          path_utility=c["path_utility"]),
            field=fcfg, episode=ep)
        self.log_ls = math.log(c["true_ls"])
        self.log_s2 = math.log(c["true_outputscale"])
        self.noise_var = float(c["noise_std"]) ** 2
        _sync(dev)

    def _field(self, g, rows, cols):
        """f(x) = √(2s²/D) Σ cos(ωᵢ·x + bᵢ) with ω drawn from the Matérn 3/2
        spectral law (a bivariate t with 3 degrees of freedom over ℓ):
        ω = z·√(3/u)/ℓ, z ~ N(0, I), u ~ χ²₃; b ~ U(0, 2π)."""
        c, D, dev = self.cfg, FIELD_FEATURES, self.dev
        if c["kernel"] != "matern32":
            raise ValueError(f"no spectral draw for kernel {c['kernel']!r}")
        z = torch.randn((2, D), generator=g, device=dev)
        u = (torch.randn((3, D), generator=g, device=dev) ** 2).sum(0)
        w = z * torch.sqrt(3.0 / u) / float(c["true_ls"])
        b = 2.0 * math.pi * torch.rand((D,), generator=g, device=dev)
        amp = math.sqrt(2.0 * float(c["true_outputscale"]) / D)
        n = rows * cols
        out = torch.empty((n,), device=dev)
        for lo in range(0, n, FIELD_BLOCK):
            i = torch.arange(lo, min(n, lo + FIELD_BLOCK), device=dev)
            x = torch.stack([i % cols, i // cols], 1).to(torch.float32)
            out[lo:lo + FIELD_BLOCK] = amp * torch.cos(x @ w + b).sum(1)
        return out

    def true_params(self):
        from algp_tpu_torch.ops.kernels import KernelParams

        dev = self.dev
        return KernelParams(
            log_ls_spatial=torch.full((2,), self.log_ls, device=dev),
            log_ls_feature=torch.zeros((0,), device=dev),
            log_outputscale=torch.tensor(self.log_s2, device=dev),
            log_noise=torch.tensor(0.5 * math.log(self.noise_var), device=dev))

    def inits(self, i: int, step: int, restarts: int):
        """The restart inits of episode i's fit at `step`, drawn from the
        run's seed in place of the program's own draws, so both sides fit
        from the same: restart 0 at the configured init, the others
        perturbed in log space (a warm refit puts its incumbent at 0)."""
        from algp_tpu_torch.ops.kernels import KernelParams

        t = self.init_table(i, step, restarts, torch.float32)
        return KernelParams(log_ls_spatial=t[:, :2], log_ls_feature=t[:, 2:2],
                            log_outputscale=t[:, 2], log_noise=t[:, 3])

    def init_table(self, i: int, step: int, restarts: int, dtype) -> torch.Tensor:
        c = self.cfg
        g = torch.Generator(device=self.dev).manual_seed(_mix(self.seed, 4, i + 1, step))
        base = torch.log(torch.tensor([c["init_ls"], c["init_ls"], c["init_outputscale"],
                                       c["init_noise"]], dtype=torch.float32, device=self.dev))
        eps = torch.randn((restarts, 4), generator=g, device=self.dev)
        eps[0] = 0.0
        return (base + c["init_perturb"] * eps).to(dtype)

    # ------------------------------------------------------------- calls

    def warm(self, seconds: float) -> None:
        """Whole warm-up episodes (every shape an episode uses), at least
        one and for at least `seconds`."""
        t0 = time.perf_counter()
        self._episode(-1)
        while time.perf_counter() - t0 < seconds:
            self._episode(-1)
        self.answers.clear()

    def call(self, i: int) -> int:
        """Episode i; returns its plan steps."""
        a = self._episode(i)
        self.answers[i] = a
        return len(a["latencies"])

    def _episode(self, i: int) -> dict:
        from algp_tpu_torch import episode as ep_mod
        from algp_tpu_torch.models import gp as gp_mod
        from algp_tpu_torch.utils.metrics import MetricsLogger

        cfg = dataclasses.replace(self.exp, episode=dataclasses.replace(
            self.exp.episode, seed=_mix(self.seed, 2, i + 1)))
        stamps: list = []

        class StepClock(MetricsLogger):
            def log(self, **kv):
                rec = super().log(**kv)
                if kv.get("phase") in ("pilot", "resume", "plan"):
                    stamps.append(time.perf_counter())
                return rec

        plans: list = []
        orig = ep_mod.Agent._plan_and_metrics

        def plan_probe(agent, st):
            before = dict(pose=int(st.pose), budget_left=float(st.budget_left),
                          n_sampled=len(st.sampled_idx), step=int(st.step))
            t = time.perf_counter()
            b = orig(agent, st)
            before["wall"] = time.perf_counter() - t
            plans.append({**before, "sites": [int(s) for s in b.sites], "cost": float(b.cost),
                          "rmse": b.rmse, "rmse_test": b.rmse_test, "mean_var": b.mean_var})
            return b

        fits: list = []
        orig_fit, orig_inits = ep_mod.Agent.fit_model, gp_mod.step_inits

        def fit_probe(agent, st, lagged=False):
            # kept as the program made them (no copy, no read): restart 0
            # of a warm refit starts from the incumbent
            before = dict(step=int(st.step), n_sampled=len(st.sampled_idx),
                          incumbent=st.params)
            res = orig_fit(agent, st, lagged)
            fits.append({**before, "nll": res.nll, "params": res.params,
                         "trace": res.nll_trace[:, :self.fit_check_steps]})
            return res

        def step_inits(spec, fit_cfg, seed, step, device):
            return self.inits(i, step, fit_cfg.restarts)

        t0 = time.perf_counter()
        logger = StepClock()
        agent = ep_mod.Agent(self.env, cfg, logger=logger)
        ep_mod.Agent._plan_and_metrics = plan_probe
        ep_mod.Agent.fit_model, gp_mod.step_inits = fit_probe, step_inits
        try:
            if self.fit:
                res = agent.run()
            else:
                st = agent.pilot_survey()
                st.params = self.true_params()
                res = agent.run(resume_from=st)
        finally:
            ep_mod.Agent._plan_and_metrics = orig
            ep_mod.Agent.fit_model, gp_mod.step_inits = orig_fit, orig_inits
        t1 = time.perf_counter()
        edges = [t0] + stamps
        lat = [b - a for a, b in zip(edges, edges[1:])]
        lat[-1] += t1 - stamps[-1]
        st = res.state
        return {"latencies": lat, "plans": plans, "fits": fits,
                "records": [h for h in res.history if h.get("phase") in ("pilot", "resume", "plan")],
                "sampled_idx": np.asarray(st.sampled_idx), "y": np.asarray(st.y, np.float64),
                "noise_scale": np.asarray(st.noise_scale, np.float64)}

    def free(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ checks

    def validity(self, a: dict) -> bool:
        s = a["sampled_idx"]
        return (len(a["plans"]) >= 1 and len(s) <= self.cfg["max_samples"]
                and bool(((s >= 0) & (s < self.n)).all())
                and all(math.isfinite(p["rmse"]) for p in a["plans"]))

    def _ref_field(self, dtype):
        """The reference's view of the field in `dtype`: coordinates, truth,
        held-out split and the inducing design."""
        dev, c = self.dev, self.cfg
        x = self.env.X.to(dtype)
        xs = x
        if self.n > c["kcenter_subsample"]:
            xs = x[torch.as_tensor(ref.subgrid(c["num_rows"], c["num_cols"],
                                               c["kcenter_target"]), device=dev)]
        z = xs[ref.kcenter(xs, min(c["num_inducing"], xs.shape[0]))]
        f = torch.as_tensor(self.env.f, device=dev).to(dtype)
        return x, f, torch.as_tensor(self.env.test_mask, device=dev), z

    def _ref_model(self, field, p: torch.Tensor):
        """(log_ls, log_s2, the noise variance, the FITC precision) for the
        log-hyperparameters p = (ls, ls, s², noise std)."""
        x, _, _, z = field
        nv = max(math.exp(2.0 * float(p[3])), self.cfg["min_noise"] ** 2)
        return p[:2], p[2], nv, ref.Fitc(self.cfg["kernel"], x, z, p[:2], p[2], nv)

    def _plan_ref(self, field, model, pose, budget_left, A, yA, scaleA):
        """The reference's plan call at a state: the metrics of the
        posterior given A, the candidate sets and their utilities."""
        x, f, test, _ = field
        log_ls, log_s2, nv, fitc = model
        c, dt, dev = self.cfg, x.dtype, self.dev
        A_t = torch.as_tensor(A, device=dev)
        nvA = torch.as_tensor(scaleA, device=dev).to(dt) * nv
        yA_t = torch.as_tensor(yA, device=dev).to(dt)
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
        scores = ref.set_scores(c["kernel"], x, sets_t, sizes_t, A_t, nvA, nv,
                                fitc, log_ls, log_s2)
        util = ref.per_sample_utility(scores, sizes_t, torch.as_tensor(costs, device=dev))
        return metrics, (sets, sizes, costs), util.cpu().numpy()

    def check(self, i: int, a: dict) -> dict:
        """path_gap: the widest gap by which a plan's chosen path lies below
        the reference's best utility (infinite where the reference has no
        such candidate); rmse_gap and var_gap: the largest relative gap of
        a plan's posterior RMSE (all cells and held out) and mean variance.
        The reference plans at the hyperparameters the program planned
        with: the field's true ones, or with fits those of the program's
        latest fit, each fit held by itself: fit_trace_gap, the largest
        |Δ NLL| / max(1, |NLL|) over every restart's first
        `fit_check_steps` Adam steps against the reference's Adam from
        the same inits, and fit_nll_gap, the same gap of the NLL the fit
        reports against the reference's NLL at the parameters it
        returned."""
        field = self._ref_field(torch.float64)
        dev = self.dev
        out = {"path_gap": 0.0, "rmse_gap": 0.0, "var_gap": 0.0}
        fitted = [(-1, torch.tensor([self.log_ls, self.log_ls, self.log_s2,
                                     0.5 * math.log(self.noise_var)],
                                    dtype=torch.float64, device=dev))]
        if self.fit:
            out["fit_trace_gap"] = out["fit_nll_gap"] = 0.0
            a["fit_step_gaps"] = []
            fitted = []
            for f in a["fits"]:
                steps, nll_gap = self._fit_gaps(i, a, f)
                a["fit_step_gaps"].append(steps)
                out["fit_trace_gap"] = max(out["fit_trace_gap"], max(steps, default=0.0))
                out["fit_nll_gap"] = max(out["fit_nll_gap"], nll_gap)
                fitted.append((f["step"], _vec(f["params"])))
        models: dict = {}

        def model_at(step):
            key, p = max(((s, q) for s, q in fitted if s <= step), key=lambda v: v[0])
            if key not in models:
                models.clear()
                models[key] = self._ref_model(field, p)
            return models[key]

        S, y, sc = a["sampled_idx"], a["y"], a["noise_scale"]
        for p in a["plans"]:
            m = p["n_sampled"]
            metrics, cand, util = self._plan_ref(field, model_at(p["step"]), p["pose"],
                                                 p["budget_left"], S[:m], y[:m], sc[:m])
            out["rmse_gap"] = max(out["rmse_gap"],
                                  abs(p["rmse"] - metrics["rmse"]) / metrics["rmse"],
                                  abs(p["rmse_test"] - metrics["rmse_test"]) / metrics["rmse_test"])
            out["var_gap"] = max(out["var_gap"],
                                 abs(p["mean_var"] - metrics["mean_var"]) / metrics["mean_var"])
            out["path_gap"] = max(out["path_gap"], self._gap(p, cand, util))
        return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}

    def _fit_gaps(self, i: int, a: dict, f: dict):
        """One fit of episode i against the reference in float64: the gap
        of each of its first Adam steps (the worst restart) and the gap of
        its reported NLL at its returned parameters.  Restart 0 of a warm
        refit starts from the program's incumbent, as the program's does;
        the other restarts from the run's draws, which both sides take."""
        c, dev, f64 = self.cfg, self.dev, torch.float64
        m = f["n_sampled"]
        idx = torch.as_tensor(a["sampled_idx"][:m], device=dev)
        x = self.env.X.to(f64)[idx]
        y = torch.as_tensor(a["y"][:m], device=dev).to(f64)
        sc = torch.as_tensor(a["noise_scale"][:m], device=dev).to(f64)
        warm = f["incumbent"] is not None
        R = (c["refit_restarts"] or c["fit_restarts"]) if warm else c["fit_restarts"]
        t = self.init_table(i, f["step"], R, f64)
        if warm:
            t[0] = _vec(f["incumbent"])
        got = f["trace"].to(f64)
        steps = []
        if got.shape[-1]:
            r = ref_gp.fit_adam(c["kernel"], x, y,
                                {"log_ls": t[:, :2], "log_s2": t[:, 2], "log_noise": t[:, 3]},
                                iters=got.shape[-1], lr=c["learning_rate"],
                                min_noise=c["min_noise"], jitter=c["jitter"], noise_scale=sc)
            want = r["trace"]
            gap = (got - want).abs() / torch.clamp_min(want.abs(), 1.0)
            steps = [float(v) if math.isfinite(v) else math.inf
                     for v in torch.nan_to_num(gap, nan=math.inf).amax(0).tolist()]
        p = _vec(f["params"])
        nll = float(ref_gp.neg_mll(c["kernel"], x, y, p[:2], p[2], p[3], min_noise=c["min_noise"],
                                   jitter=c["jitter"], noise_scale=sc))
        nll_gap = abs(float(f["nll"]) - nll) / max(1.0, abs(nll))
        return steps, (nll_gap if math.isfinite(nll_gap) else math.inf)

    @staticmethod
    def _gap(p: dict, cand, util) -> float:
        if cand is None:
            return 0.0 if not p["sites"] else math.inf
        sets, sizes, costs = cand
        k = len(p["sites"])
        hit = [j for j in range(len(sizes)) if sizes[j] == k
               and list(sets[j, :k]) == p["sites"] and abs(costs[j] - p["cost"]) < 1e-3]
        if not hit:
            return math.inf
        best = float(util.max())
        got = max(float(util[j]) for j in hit)
        if not math.isfinite(got) or best <= 0:
            return 0.0 if got == best else math.inf
        return (best - got) / best

    def control_answer(self, i: int) -> dict:
        """The control: the program's own episode i with torch's TF32
        matmuls switched on (the port switches them off at import).  The
        reference in float32 with TF32 cannot stand in here: its Gram's
        matrix product at these coordinates leaves K_AA indefinite and its
        factor fails, which gives no number."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return self._episode(i)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def summary(self, a: dict) -> dict:
        """One episode for the run's log: its plan steps, fits and wall
        time, the program's own times summed (fits, plan calls, sensing)
        and the last step's latency, which carries the host's tail."""
        recs = a["records"]
        return {"steps": len(a["latencies"]), "fits": len(a["fits"]),
                "wall_s": round(sum(a["latencies"]), 4),
                "plan_wall_s": round(sum(p["wall"] for p in a["plans"]), 4),
                **{k: round(sum(r.get(k, 0.0) for r in recs), 4)
                   for k in ("fit_s", "plan_s", "sense_s")},
                "last_s": round(a["latencies"][-1], 4)}

    def describe(self, a: dict) -> dict:
        out = {"plan_calls": len(a["plans"]), "samples": int(len(a["sampled_idx"]))}
        if a["fits"]:
            p = [_vec(f["params"]).tolist() for f in a["fits"]]
            out["noise_var"] = [math.exp(2.0 * q[3]) for q in p]
            out["ls"] = [math.exp(q[0]) for q in p]
        if "fit_step_gaps" in a:
            out["fit_step_gaps"] = a["fit_step_gaps"]
        return out


def faults(traffic: dict) -> dict:
    """The faults that a run of this traffic can have, each a function
    that plants it in the program through a pytest-style `monkeypatch`."""
    out = {"state_unchanged": _stale_plans, "half_batch": _half_plans,
           "altered_answer": _altered_path}
    if traffic["fit"]:
        out.update(fit_unchanged=_fit_unchanged, fit_altered=_fit_altered)
    return out


def _vec(p) -> torch.Tensor:
    """(ls, ls, s², noise std) in log space, float64, from KernelParams."""
    return torch.cat([p.log_ls_spatial.reshape(-1), p.log_outputscale.reshape(1),
                      p.log_noise.reshape(1)]).to(torch.float64)


def _stale_plans(mp) -> None:
    """Every plan conditions on the first 16 samples alone, as if the
    state had not moved since the pilot survey."""
    from algp_tpu_torch import acquisition_lowrank as acq_lr

    orig = acq_lr._condition_and_mean

    def stale(spec, params, x, idx_pad, count, *a, **k):
        return orig(spec, params, x, idx_pad, 16, *a, **k)
    mp.setattr(acq_lr, "_condition_and_mean", stale)


def _half_plans(mp) -> None:
    """A plan conditions on half of its samples."""
    from algp_tpu_torch import acquisition_lowrank as acq_lr

    orig = acq_lr._condition_and_mean

    def half(spec, params, x, idx_pad, count, *a, **k):
        return orig(spec, params, x, idx_pad, count // 2, *a, **k)
    mp.setattr(acq_lr, "_condition_and_mean", half)


def _altered_path(mp) -> None:
    """A plan returns the next path instead of its best."""
    from algp_tpu_torch import acquisition as acq

    orig = acq.path_set_argmax

    def altered(scores, set_sizes, *a, **k):
        best = orig(scores, set_sizes, *a, **k)
        return (best + 1) % int((set_sizes > 0).sum())
    mp.setattr(acq, "path_set_argmax", altered)


def _fit_unchanged(mp) -> None:
    """Every Adam step of a fit returns its parameters unchanged."""
    from algp_tpu_torch.models import gp as gp_mod

    orig = gp_mod._adam_step

    def still(g, mu, nu, count):
        upd, mu, nu = orig(g, mu, nu, count)
        return [torch.zeros_like(u) for u in upd], mu, nu
    mp.setattr(gp_mod, "_adam_step", still)


def _fit_altered(mp) -> None:
    """A fit returns parameters one Adam step (the learning rate, 0.05, in
    every log-parameter) away from those whose NLL it reports."""
    from algp_tpu_torch.models import gp as gp_mod

    orig = gp_mod.best_of

    def altered(*a, **k):
        res = orig(*a, **k)
        res.params = res.params.map(lambda t: t + 0.05)
        return res
    mp.setattr(gp_mod, "best_of", altered)


def make(config: dict, traffic: dict, seed: int, device) -> Driver:
    return Driver(config, traffic, seed, device)
