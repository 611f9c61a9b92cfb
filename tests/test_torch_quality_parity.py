"""The final posterior and its calibration, algp_tpu_torch against algp_tpu
on the CPU, at the presets' full widths: the deep-kernel c2 episode and
the c5_long campaign across its SGPR threshold.  Both Agents run on the
reference's field (`convert.field_env_like`, made before the reference
draws its sensing noise) and its fit inits; only depth is cut.

Equal sites at every step (held-out RMSE within 1e-3 relative), then
`posterior_parity.same_posterior`: the final mean and variance within
atol 5e-3, the log variance within 0.05 (up to 16 units in the last place
of s²) wherever either variance is below 1e-3, the coverages within one
cell's share, NLPD within 2e-2 relative.  Each case prints both
packages' held-out calibration and diagnostics (smallest variance, cells
below 1e-6, largest NLPD term).

deep_c2: c2_composite_restarts with the tanh warp and a 16-wide MLP
embedding to 4 (4 restarts × 150 Adam steps, a refit every step).  This
joint fit is chaotic in f32: from the same inits the two packages' NLL
traces agree to < 1e-6 relative for 25 steps, then part, and the
reference against itself with y scaled by (1 + 1e-7) parts the same way
and ends at another optimum.  So the port replays the reference's fitted
weights and hyperparameters (after checking that it hands the fit the
same inputs), and its own fit is held to the reference's trace over the
first 25 steps at the pilot's data.

long_sgpr: c5_long (100 × 100 Matérn 3/2, the exact MI planner, SGPR
refits over 256 k-center inducing points past sparse_threshold), the
port fitting from the reference's inits.  Two substitutions in the
reference, for this file's runs only: its seed's Pallas Gram runs through
its plain `ops.kernels.gram_with_noise` (interpret mode takes minutes at
10 000²), and its `ops.linalg.tri_inv` through a triangular solve.  At
this field's hyperparameters the Neumann-doubling leaf inverse of
`tri_inv` overflows in f32: its MI seed is NaN, every set scores NaN and
the plan takes set 0 at every step (`test_reference_seed_overflows`).
Both packages refuse sparse_threshold < sparse_inducing (256), so the
tier-1 form sets the threshold to 256 and raises the pilot to 264: the
pilot fit is the SGPR bound, then 3 steps on one MI seed (the slow form
crosses the preset's threshold mid-campaign, with warm SGPR refits).
Each run's sample capacity (`max_samples`) is sized to its cut depth,
the same in both packages.

The full forms, the fit's parting under rounding and a 9-seed NLPD sweep
are marked `slow` (tier-1 runs `-m 'not slow'`):
`python -m pytest -m slow tests/test_torch_quality_parity.py -s`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from algp_tpu import acquisition as jacq
from algp_tpu import config as jc
from algp_tpu.episode import Agent as JAgent
from algp_tpu.field import FieldEnv as JFieldEnv
from algp_tpu.models import networks as jnets
from algp_tpu.ops import kernels as jkern
from algp_tpu.ops import linalg as jla
from algp_tpu_torch import config as tc
from algp_tpu_torch.convert import field_env_like, kernel_params_from_numpy
from algp_tpu_torch.episode import Agent
from algp_tpu_torch.models import gp as tgp
from algp_tpu_torch.models import networks as tnets
from algp_tpu_torch.models import sparse_gp as tsgp
from algp_tpu_torch.ops.kernels import KernelSpec
from test_torch_episode import _reference_step_inits, _same_posterior
from test_torch_episode_deep import _reference_deep_step_inits
from test_torch_episode_fields import _same_sites


def _deep_configs():
    """14c's command, `--preset c2_composite_restarts --feature-warp tanh
    --deep-hidden 16 --deep-out 4`, in both packages."""
    out = []
    for mod in (jc, tc):
        base = mod.PRESETS["c2_composite_restarts"]
        out.append(dataclasses.replace(
            base, field=dataclasses.replace(base.field, feature_warp="tanh"),
            deep=mod.MLPSpec(hidden=(16,), out=4)))
    return out


def _long_configs(num_pilot, sparse_threshold, steps):
    """c5_long with its pilot and SGPR threshold set, and a sample
    capacity for `steps` steps (the preset sizes it for its whole
    campaign, ~1 700 samples), in both packages."""
    out = []
    for mod in (jc, tc):
        base = mod.PRESETS["c5_long"]
        ep = base.episode
        out.append(dataclasses.replace(
            base, fit=dataclasses.replace(base.fit, sparse_threshold=sparse_threshold),
            episode=dataclasses.replace(
                ep, num_pilot=num_pilot,
                max_samples=num_pilot + (steps + 6) * ep.samples_per_step)))
    return out


def _record_reference_deep_fits(monkeypatch):
    """Wrap the reference's fit_deep: each call's inputs and result, in
    call order."""
    fits = []
    orig = jnets.fit_deep

    def record(kspec, mspec, cfg, x, y, noise_scale=None, key=None, num_valid=None):
        res = orig(kspec, mspec, cfg, x, y, noise_scale, key, num_valid)
        fits.append(dict(x=np.asarray(x), y=np.asarray(y), ns=np.asarray(noise_scale),
                         m=int(num_valid), res=res))
        return res

    monkeypatch.setattr(jnets, "fit_deep", record)
    return fits


def _replay_deep_fits(monkeypatch, fits):
    """The port's deep refits return the reference's, in order, after
    checking that the port hands each fit the reference's inputs."""
    calls = iter(fits)

    def fit_step(kspec, mspec, cfg, x, y, noise_scale, seed, step, num_valid=None):
        f = next(calls)
        assert int(num_valid) == f["m"]
        np.testing.assert_array_equal(x.numpy(), f["x"])
        np.testing.assert_allclose(y.numpy(), f["y"], rtol=1e-6)
        np.testing.assert_array_equal(noise_scale.numpy(), f["ns"])
        r = f["res"]
        params = kernel_params_from_numpy(
            {k.name: np.asarray(getattr(r.params, k.name))
             for k in dataclasses.fields(r.params)})
        mlp = [(torch.tensor(np.asarray(W)), torch.tensor(np.asarray(b))) for W, b in r.mlp]
        return tnets.DeepFitResult(
            params=params, mlp=mlp, nll=torch.tensor(np.asarray(r.nll)),
            all_nlls=None, nll_trace=torch.tensor(np.asarray(r.nll_trace)),
            best_restart=None)

    monkeypatch.setattr(tnets, "fit_step", fit_step)


def _deep_case(monkeypatch, steps):
    jcfg, tcfg = _deep_configs()
    fits = _record_reference_deep_fits(monkeypatch)
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    tenv = field_env_like(jenv, "cpu")
    want = JAgent(jenv, jcfg).run(max_steps=steps)
    _replay_deep_fits(monkeypatch, fits)
    got = Agent(tenv, tcfg).run(max_steps=steps)
    assert len(fits) == got.state.step + 1  # a refit every step
    _same_sites(want, got)
    _same_posterior(want, got, tenv, f"deep_c2 steps={got.state.step}")

    # the port's own joint fit from the reference's inits, at the pilot's
    # data: the reference's NLL trace over the steps before f32 rounding
    # parts the two trajectories
    kspec = KernelSpec(**dataclasses.asdict(jcfg.kernel))
    f = fits[0]
    inits = _reference_deep_step_inits(kspec, tcfg.deep, tcfg.fit, tcfg.episode.seed, 0, "cpu")
    own = tnets.fit_deep(kspec, tcfg.deep, dataclasses.replace(tcfg.fit, iters=25),
                         torch.tensor(f["x"]), torch.tensor(f["y"]), torch.tensor(f["ns"]),
                         num_valid=f["m"], inits=inits)
    np.testing.assert_allclose(own.nll_trace.numpy(),
                               np.asarray(f["res"].nll_trace)[:, :25], rtol=1e-5)
    return want, got


def _exact_tri_inv(L, **_):
    return jax.scipy.linalg.solve_triangular(
        L, jnp.eye(L.shape[-1], dtype=L.dtype), lower=True)


@pytest.fixture
def reference_seed_substitutes(monkeypatch):
    """The reference's MI seed with its plain Gram and an exact triangular
    inverse; jit caches cleared on both sides so that no program traced
    with the other functions is reused."""
    jax.clear_caches()
    monkeypatch.setattr(jacq, "gram_pallas_with_noise",
                        lambda spec, params, x, noise_scale=None, **_:
                        jkern.gram_with_noise(spec, params, x, noise_scale))
    monkeypatch.setattr(jla, "tri_inv", _exact_tri_inv)
    yield
    jax.clear_caches()


def _long_case(monkeypatch, num_pilot, sparse_threshold, steps):
    monkeypatch.setattr(tgp, "step_inits", _reference_step_inits)
    sparse = []
    for name in ("fit_step_sparse", "fit_step_sparse_warm"):
        orig = getattr(tsgp, name)
        monkeypatch.setattr(tsgp, name, lambda *a, _o=orig, _n=name, **k:
                            (sparse.append(_n), _o(*a, **k))[1])
    jcfg, tcfg = _long_configs(num_pilot, sparse_threshold, steps)
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    tenv = field_env_like(jenv, "cpu")
    want = JAgent(jenv, jcfg).run(max_steps=steps)
    got = Agent(tenv, tcfg).run(max_steps=steps)
    assert got.state.step == steps and sparse  # crossed into SGPR refits
    _same_sites(want, got)
    _same_posterior(want, got, tenv, f"long_sgpr steps={steps} sgpr_refits={len(sparse)}")
    return want, got


def test_deep_c2_final_posterior_matches_reference(monkeypatch):
    """deep_c2 at full width, its first 2 steps (3 deep fits; 4 steps take
    ≈ 2 min on one CPU core, most of it the reference's fits)."""
    _deep_case(monkeypatch, steps=2)


def test_long_sgpr_final_posterior_matches_reference(monkeypatch, reference_seed_substitutes):
    """long_sgpr at full width: 264 pilots past a threshold of 256 (the
    pilot fit by the SGPR bound), 3 steps."""
    _long_case(monkeypatch, num_pilot=264, sparse_threshold=256, steps=3)


@pytest.mark.slow
def test_deep_c2_whole_episode_matches_reference(monkeypatch):
    """deep_c2's whole episode (15 steps at seed 0)."""
    _deep_case(monkeypatch, steps=1000)


@pytest.mark.slow
def test_long_sgpr_through_step_60_matches_reference(monkeypatch, reference_seed_substitutes):
    """long_sgpr at the preset's pilot (64) and threshold (512) through
    step 60: the threshold falls near step 45, so the last refits are
    SGPR."""
    _long_case(monkeypatch, num_pilot=64, sparse_threshold=512, steps=60)


@pytest.mark.slow
def test_deep_fit_parts_under_rounding():
    """Why deep_c2 replays the reference's fits: at the pilot's data and
    from the reference's inits, the reference's joint fit on y and on
    y × (1 + 1e-7), and the port's on y, agree for the first 25 Adam
    steps (1e-5 relative) and then part by more than 1 in NLL."""
    jcfg, tcfg = _deep_configs()
    agent = JAgent(JFieldEnv(jcfg.field, jcfg.kernel), jcfg)
    x, y, ns, m, _ = agent._padded_train(agent.pilot_survey(), raw=True)
    key = jax.random.fold_in(jax.random.PRNGKey(jcfg.episode.seed), jnp.asarray(0, jnp.uint32))
    ref, ref2 = (jnets.fit_deep(jcfg.kernel, jcfg.deep, jcfg.fit, x, yy, ns, key, m)
                 for yy in (y, y * (1 + 1e-7)))
    kspec = KernelSpec(**dataclasses.asdict(jcfg.kernel))
    own = tnets.fit_deep(
        kspec, tcfg.deep, tcfg.fit, torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y)),
        torch.tensor(np.asarray(ns)), num_valid=int(m),
        inits=_reference_deep_step_inits(kspec, tcfg.deep, tcfg.fit, tcfg.episode.seed, 0, "cpu"))
    want = np.asarray(ref.nll_trace)
    for name, trace, best in (("reference, y(1+1e-7)", np.asarray(ref2.nll_trace), ref2.nll),
                              ("port", own.nll_trace.numpy(), own.nll)):
        gap = np.abs(trace - want).max(axis=0)
        print(name, {"gap_at_step": {k: float(gap[k]) for k in (24, 39, 49, 149)},
                     "best_nll": float(best), "reference_best_nll": float(ref.nll)})
        np.testing.assert_allclose(trace[:, :25], want[:, :25], rtol=1e-5)
        assert gap.max() > 1.0


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(9))
def test_deep_c2_calibration_over_seeds(monkeypatch, seed):
    """deep_c2's whole episode on the reference's field at `seed`, the port
    fitting from its own inits and from the reference's: both finish with
    finite calibration; their held-out NLPD is printed (how far the
    optimum a chaotic fit reaches moves the result)."""
    jcfg, tcfg = [dataclasses.replace(
        c, field=dataclasses.replace(c.field, seed=seed),
        episode=dataclasses.replace(c.episode, seed=seed)) for c in _deep_configs()]
    jenv = JFieldEnv(jcfg.field, jcfg.kernel)
    envs = [field_env_like(jenv, "cpu") for _ in range(2)]
    own = Agent(envs[0], tcfg).run().calibration
    monkeypatch.setattr(tnets, "step_inits", _reference_deep_step_inits)
    ref_inits = Agent(envs[1], tcfg).run().calibration
    print(f"seed {seed}", {"own_inits": own["nlpd_test"], "reference_inits": ref_inits["nlpd_test"]})
    for cal in (own, ref_inits):
        assert np.isfinite(list(cal.values())).all()


def test_reference_seed_overflows():
    """Why long_sgpr substitutes the reference's `tri_inv`: on the factor
    of c5_long's first 256 cells (Matérn 3/2 on the 100-wide grid at the
    pilot fit's hyperparameters: length scales 9.16 × 6.84, outputscale
    0.80, noise 5.4e-4) the reference's Neumann-doubling leaf inverse is
    not finite; the triangular solve is, and the port's `tri_inv` equals
    it."""
    from algp_tpu_torch.ops import linalg as tla
    r, c = np.divmod(np.arange(256), 100)
    x = np.stack([c, r], 1) / np.array([9.16, 6.84])
    d = np.sqrt(3.0 * ((x[:, None] - x[None]) ** 2).sum(-1))
    K = 0.80 * (1 + d) * np.exp(-d) + 5.4e-4 * np.eye(256)
    L = np.linalg.cholesky(K).astype(np.float32)
    assert not np.isfinite(np.asarray(jla.tri_inv(jnp.asarray(L)))).all()
    W = np.asarray(_exact_tri_inv(jnp.asarray(L)))
    assert np.isfinite(W).all()
    mine = tla.tri_inv(torch.tensor(L)).numpy()
    np.testing.assert_allclose(mine, W, rtol=0, atol=1e-4 * np.abs(W).max())
