"""The long SGPR campaign (preset `c5_long`) of algp_tpu_torch against the
plain float64 reference `reference_campaign.py`, on the CPU, with seeded
random data and parameters: the collapsed bound and its gradient, the
k-center design, a warm SGPR refit's first Adam steps, an exact plan
step's set scores, and a small campaign that crosses into SGPR refits,
with its records and profiler regions.

Tolerances (float32 against float64, each about 5× the widest gap seen):
the −ELBO within rtol 5e-6 and its gradient within rtol 2e-5 / atol 1e-4
(an f32 sum over the samples with cancellation); the refit's first 20 Adam values within rtol 1e-4; set
scores within 2e-3 absolute (log-determinants of f32 blocks); a plan's
chosen path within 1e-4 of the reference's best utility.  In float64 the
bound agrees to 1e-10 and its gradient to 1e-8.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import reference_campaign as ref
from algp_tpu_torch import acquisition as acq
from algp_tpu_torch import acquisition_lowrank as acq_lr
from algp_tpu_torch import planning
from algp_tpu_torch import config as tc
from algp_tpu_torch.episode import Agent
from algp_tpu_torch.field import FieldEnv
from algp_tpu_torch.models import gp as tgp
from algp_tpu_torch.models import sparse_gp as tsgp
from algp_tpu_torch.ops.kernels import KernelParams, KernelSpec

KIND = "matern32"
SPEC = KernelSpec(KIND, ds=2)
F64 = torch.float64
REGIONS = ("sgpr.design", "sgpr.fit", "exact.seed", "exact.plan_step")


def _params(g, R, dtype):
    """R random log-hyperparameters around a lengthscale of 3."""
    t = torch.randn((R, 4), generator=g, dtype=F64) * 0.3
    t[:, :2] += math.log(3.0)
    t[:, 3] += math.log(0.1)
    return KernelParams(log_ls_spatial=t[:, :2].to(dtype), log_ls_feature=torch.zeros((R, 0), dtype=dtype),
                        log_outputscale=t[:, 2].to(dtype), log_noise=t[:, 3].to(dtype))


def _padded_samples(g, n, pad, side=12):
    """Grid cells (with repeats) padded with zeros, their values and a
    heteroscedastic noise scale (1 or 25, padding 1)."""
    cells = torch.randint(0, side * side, (n,), generator=g)
    x = torch.zeros((n + pad, 2), dtype=F64)
    x[:n] = torch.stack([cells % side, cells // side], 1).to(F64)
    y = torch.zeros(n + pad, dtype=F64)
    y[:n] = torch.sin(x[:n, 0] / 3) + torch.cos(x[:n, 1] / 4) + 0.1 * torch.randn(n, generator=g, dtype=F64)
    ns = torch.ones(n + pad, dtype=F64)
    ns[:n] = torch.where(torch.rand(n, generator=g) < 0.3, 25.0, 1.0).to(F64)
    return x, y, ns


def _ref_elbo(p: KernelParams, x, y, z, ns, count):
    return ref.neg_elbo(KIND, x, y, z, p.log_ls_spatial, p.log_outputscale, p.log_noise,
                        min_noise=1e-3, count=count, noise_scale=ns)


@pytest.mark.parametrize("dtype,rtol,grad_tol", [(F64, 1e-10, 1e-8), (torch.float32, 5e-6, 2e-5)])
def test_neg_elbo_and_gradient(dtype, rtol, grad_tol):
    g = torch.Generator().manual_seed(11)
    x, y, ns = _padded_samples(g, 40, 8)
    z = x[torch.randperm(40, generator=g)[:8]]
    p64 = _params(g, 3, F64)
    leaves = [p64.log_ls_spatial, p64.log_outputscale, p64.log_noise]
    want = [t.clone().requires_grad_(True) for t in leaves]
    w = _ref_elbo(KernelParams(want[0], p64.log_ls_feature, want[1], want[2]), x, y, z, ns, 40)
    gw = torch.autograd.grad(w.sum(), want)
    got = [t.to(dtype).requires_grad_(True) for t in leaves]
    p = KernelParams(got[0], p64.log_ls_feature.to(dtype), got[1], got[2])
    v = tsgp.neg_elbo(SPEC, p, x.to(dtype), y.to(dtype), z.to(dtype), ns.to(dtype),
                      min_noise=1e-3, num_valid=40)
    gv = torch.autograd.grad(v.sum(), got)
    torch.testing.assert_close(v.detach().to(F64), w.detach(), rtol=rtol, atol=0.0)
    for a, b in zip(gv, gw):
        torch.testing.assert_close(a.to(F64), b, rtol=grad_tol, atol=5 * grad_tol)


def test_sgpr_design_index_for_index():
    g = torch.Generator().manual_seed(3)
    x, _, _ = _padded_samples(g, 60, 12)  # integer cells: many tied distances
    want = ref.kcenter(x, 16, 60)
    x32 = x.to(torch.float32)
    got = acq_lr.kcenter_indices(x32, 16, 60)
    assert got.tolist() == want.tolist()
    assert torch.equal(tsgp._valid_design(x32, 60, 16, "test"), x32[want])
    assert int(want.max()) < 60  # never a padding row


def test_warm_sgpr_refit_first_adam_steps():
    g = torch.Generator().manual_seed(5)
    x, y, ns = _padded_samples(g, 60, 12)
    cfg = tc.FitConfig(iters=150, restarts=4, refit_iters=20, refit_restarts=2)
    incumbent = tgp._take(_params(g, 1, torch.float32), torch.tensor(0))
    res = tsgp.fit_step_sparse_warm(SPEC, cfg, x.float(), y.float(), ns.float(), 9, 12, 60,
                                    incumbent, num_inducing=16)
    assert res.design_s is not None and res.design_s >= 0.0
    inits = tgp.warm_inits(SPEC, tgp.refit_cfg(cfg), 9, 12, incumbent, "cpu")
    z = x[ref.kcenter(x, 16, 60)]

    def loss(q):
        return ref.neg_elbo(KIND, x, y, z, q[0], q[1], q[2], min_noise=1e-3, count=60,
                            noise_scale=ns)

    want = ref.adam(loss, [inits.log_ls_spatial.to(F64), inits.log_outputscale.to(F64),
                           inits.log_noise.to(F64)], iters=20, lr=cfg.learning_rate)
    torch.testing.assert_close(res.nll_trace.to(F64), want["trace"], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(res.nll.to(F64), want["value"], rtol=1e-4, atol=0.0)


def _field(rows=20, cols=20, seed=4):
    return FieldEnv(tc.FieldConfig(num_rows=rows, num_cols=cols, true_ls_spatial=4.0,
                                   seed=seed), SPEC, device="cpu")


def _ref_plan(env, params, A, y, scale, batch, min_noise=1e-3):
    """The reference's utilities of the batch's paths, and the posterior."""
    x = env.X.to(F64)
    p = [t.to(F64).reshape(-1) if t.dim() else t.to(F64) for t in
         (params.log_ls_spatial, params.log_outputscale, params.log_noise)]
    nv = max(math.exp(2.0 * float(p[2])), min_noise ** 2)
    A_t = torch.as_tensor(np.asarray(A), dtype=torch.int64)
    nvA = torch.as_tensor(np.asarray(scale), dtype=F64) * nv
    P = ref.prior_precision(KIND, x, nv, p[0], p[1])
    sets = torch.as_tensor(batch.sets, dtype=torch.int64)
    sizes = torch.as_tensor(batch.sizes, dtype=torch.int64)
    scores = ref.set_scores(KIND, x, sets, sizes, A_t, nvA, nv, P, p[0], p[1])
    util = ref.per_cost_utility(scores, sizes, torch.as_tensor(batch.costs, dtype=F64))
    mean, var = ref.posterior(KIND, x, x[A_t], torch.as_tensor(np.asarray(y), dtype=F64),
                              nvA, p[0], p[1])
    return scores, util, mean, var


def test_exact_plan_step_scores_and_path():
    env = _field()
    g = torch.Generator().manual_seed(8)
    m, cap = 48, 64  # past a threshold of 32
    A = np.concatenate([np.linspace(0, env.n - 1, 16).round().astype(np.int64),
                        torch.randint(0, env.n, (m - 16,), generator=g).numpy()])
    s = env.collect(A, "precise")
    params = tgp._take(_params(g, 1, torch.float32), torch.tensor(0))
    batch = planning.enumerate_batch(env, int(A[-1]), 10.0, max_paths=256, k_max=4)
    P = len(batch)
    assert P > 10

    def pad(a, n, fill, dtype):
        out = np.full(n, fill, dtype)
        out[:len(a)] = a
        return torch.as_tensor(out)

    sets = torch.zeros((256, 4), dtype=torch.int64)
    sets[:P] = torch.as_tensor(batch.sets)
    W, WT = acq.implicit_precision_seed(SPEC, params, env.X)
    best, mean, var, scores = acq.plan_episode_step(
        SPEC, params, env.X, pad(s.indices, cap, 0, np.int64), m,
        pad(s.noise_scale, cap, 1.0, np.float32), pad(s.y, cap, 0.0, np.float32), sets,
        pad(batch.sizes, 256, 0, np.int64), pad(batch.costs, 256, 1.0, np.float32), W, WT,
        strategy="mi", path_utility="per_cost")
    rscores, util, rmean, rvar = _ref_plan(env, params, s.indices, s.y, s.noise_scale, batch)
    torch.testing.assert_close(scores[:P].to(F64), rscores, rtol=0.0, atol=2e-3)
    assert float(util.max() - util[int(best)]) <= 1e-4 * float(util.max())
    torch.testing.assert_close(mean.to(F64), rmean, rtol=0.0, atol=1e-4)
    torch.testing.assert_close(var.to(F64), rvar, rtol=0.0, atol=1e-4)


def _campaign_config():
    """A small c5_long-shaped campaign: the exact planner with `per_cost`,
    warm refits every 4 steps, SGPR refits past 32 samples over 16
    k-center points."""
    return tc.ExperimentConfig(
        kernel=SPEC,
        field=tc.FieldConfig(num_rows=20, num_cols=20, true_ls_spatial=4.0, seed=6),
        fit=tc.FitConfig(iters=20, restarts=2, sparse_threshold=32, sparse_inducing=16,
                         refit_iters=10, refit_restarts=2),
        acquisition=tc.AcquisitionConfig(strategy="mi", num_inducing=0,
                                         path_utility="per_cost"),
        episode=tc.EpisodeConfig(num_pilot=16, budget=120.0, num_waypoints=12,
                                 samples_per_step=4, refit_every=4, seed=3),
    )


@pytest.fixture(scope="module")
def campaign():
    """12 steps of the small campaign under the CPU profiler, with every
    plan call's state, path batch and choice."""
    cfg = _campaign_config()
    env = FieldEnv(cfg.field, cfg.kernel, device="cpu")
    plans, batches = [], []
    orig_plan, orig_enum = Agent._plan_and_metrics, planning.enumerate_batch

    def enum(*a, **k):
        batches.append(orig_enum(*a, **k))
        return batches[-1]

    def plan(agent, st):
        before = dict(m=len(st.sampled_idx), params=st.params)
        n_batches = len(batches)
        b = orig_plan(agent, st)
        plans.append({**before, "sites": [int(v) for v in b.sites], "cost": b.cost,
                      "batch": batches[-1] if len(batches) > n_batches else None})
        return b

    fits0 = tsgp.FITS
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Agent, "_plan_and_metrics", plan)
        mp.setattr(planning, "enumerate_batch", enum)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            res = Agent(env, cfg).run(max_steps=12)
    names = {e.name for e in prof.events()}
    return {"env": env, "res": res, "plans": plans, "names": names,
            "sgpr_fits": tsgp.FITS - fits0}


def test_small_campaign_plans_pick_the_reference_best(campaign):
    env, res, plans = campaign["env"], campaign["res"], campaign["plans"]
    st = res.state
    checked = past = 0
    for p in plans:
        if p["batch"] is None or not p["sites"]:
            continue
        m, batch = p["m"], p["batch"]
        _, util, _, _ = _ref_plan(env, p["params"], st.sampled_idx[:m], st.y[:m],
                                  st.noise_scale[:m], batch)
        hit = [j for j in range(len(batch)) if batch.sizes[j] == len(p["sites"])
               and list(batch.sets[j][:batch.sizes[j]]) == p["sites"]
               and abs(float(batch.costs[j]) - p["cost"]) < 1e-4]
        assert hit, p["sites"]
        best = float(util.max())
        assert best - max(float(util[j]) for j in hit) <= 1e-4 * best, (m, best)
        checked += 1
        past += m > 32
    assert checked >= 10 and past >= 4


def test_records_regions_and_counter(campaign):
    hist = campaign["res"].history
    pilot = [h for h in hist if h["phase"] == "pilot"]
    assert pilot[0]["fit_kind"] == "exact" and "sgpr_design_s" not in pilot[0]
    fitted = [h for h in hist if h["phase"] == "plan" and "fit_kind" in h]
    assert [h["step"] for h in fitted] == [4, 8, 12]
    kinds = [h["fit_kind"] for h in fitted]
    assert kinds == ["exact" if h["n_sampled"] <= 32 else "sgpr" for h in fitted]
    assert "sgpr" in kinds and "exact" in kinds
    for h in fitted:
        assert ("sgpr_design_s" in h) == (h["fit_kind"] == "sgpr")
        if "sgpr_design_s" in h:
            assert 0.0 <= h["sgpr_design_s"] <= h["fit_s"]
    assert not [h for h in hist if h["phase"] == "plan" and "fit_kind" in h
                and h["step"] % 4]
    assert campaign["sgpr_fits"] == kinds.count("sgpr")
    assert set(REGIONS) <= campaign["names"], set(REGIONS) - campaign["names"]


def test_fit_fields_handed_once_and_none_on_resume():
    """A fit's record fields are handed over once, and a resumed episode
    with its params runs no fit: its record names none."""
    cfg = dataclasses.replace(_campaign_config(), fit=tc.FitConfig(iters=5, restarts=1))
    env = FieldEnv(cfg.field, cfg.kernel, device="cpu")
    agent = Agent(env, cfg)
    st = agent.pilot_survey()
    agent.fit_model(st)
    assert agent._fit_fields() == {"fit_kind": "exact"} and agent._fit_fields() == {}
    res = agent.run(max_steps=1, resume_from=st)
    assert "fit_kind" not in res.history[0] and res.history[0]["phase"] == "resume"
