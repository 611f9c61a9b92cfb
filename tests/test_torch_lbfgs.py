"""L-BFGS in algp_tpu_torch.models.gp (optax 0.2.6's `lbfgs()` written
out) against algp_tpu.models.gp's optax.lbfgs(), fed the reference's
restart inits: step for step, the fit's result, and the zoom line
search's per-restart (vmap) semantics."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from algp_tpu.config import FitConfig
from algp_tpu.models import gp as jgp
from algp_tpu.ops import kernels as jk
from algp_tpu_torch.config import FitConfig as TFitConfig
from algp_tpu_torch.convert import kernel_params_from_numpy
from algp_tpu_torch.models import gp as tgp
from algp_tpu_torch.ops import kernels as tk


def _np_params(p):
    return {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}


def _c2_case():
    """test_episode_golden.py's config-2 data: 60 plots of the 8 × 12
    field with 3 features (seed 5), the composite Matérn 5/2 × RBF."""
    from algp_tpu.field import FieldEnv
    from algp_tpu.config import FieldConfig

    spec = jk.KernelSpec("matern52", "rbf", ds=2, df=3)
    env = FieldEnv(FieldConfig(num_rows=8, num_cols=12, num_features=3, seed=5), spec)
    train = np.random.default_rng(1).choice(env.n, 60, replace=False)
    s = env.collect(train, "precise")
    return spec, np.asarray(env.X)[s.indices], s.y.astype(np.float32)


def _np_inits(spec, cfg, key):
    return kernel_params_from_numpy(_np_params(jgp.make_restart_inits(spec, cfg, key)))


LBFGS_C2 = dict(optimizer="lbfgs", iters=80, restarts=3, perturb=0.7)


@pytest.fixture(scope="module")
def c2_lbfgs_reference():
    """The reference's L-BFGS fit on the config-2 data (one compile for the
    two L-BFGS tests): its FitResult and inits."""
    spec, x, y = _c2_case()
    cfg = FitConfig(**LBFGS_C2)
    return x, y, jgp.fit(spec, cfg, jnp.asarray(x), jnp.asarray(y)), _np_inits(spec, cfg, None)


def test_lbfgs_opt_loop_follows_optax_step_for_step(c2_lbfgs_reference):
    """`_opt_loop` under L-BFGS against the reference's (optax.lbfgs() with
    value_and_grad_from_state, vmapped over restarts: its fit's NLL trace)
    on the same neg_mll and inits: every restart's NLL within 5e-5
    relative over the first 8 steps (f32 sums in another order move the
    line search's trial points by ulps)."""
    x, y, want, inits = c2_lbfgs_reference
    tspec = tk.KernelSpec("matern52", "rbf", 2, 3)
    tloss = lambda p: tgp.neg_mll(tspec, p, torch.tensor(x), torch.tensor(y))
    _, _, ttrace = tgp._opt_loop(TFitConfig(**dict(LBFGS_C2, iters=8)), tloss, inits)
    np.testing.assert_allclose(ttrace.numpy(), np.asarray(want.nll_trace)[:, :8], rtol=5e-5)
    assert (np.diff(ttrace.numpy(), axis=1) <= 0).all()  # a descent method


def test_c2_composite_multirestart_lbfgs_fit_matches_reference(c2_lbfgs_reference):
    """test_c2_composite_multirestart's L-BFGS fit (80 steps, 3 restarts,
    perturb 0.7) from the reference's inits: the same best restart, the
    best NLL and every restart's within 1e-4 relative."""
    x, y, want, inits = c2_lbfgs_reference
    got = tgp.fit(tk.KernelSpec("matern52", "rbf", 2, 3), TFitConfig(**LBFGS_C2),
                  torch.tensor(x), torch.tensor(y), inits=inits)
    assert int(got.best_restart) == int(want.best_restart)
    np.testing.assert_allclose(float(got.nll), float(want.nll), rtol=1e-4)
    np.testing.assert_allclose(got.all_nlls.numpy(), np.asarray(want.all_nlls), rtol=1e-4)
    assert float(got.nll) == float(got.all_nlls.min())
    assert got.params.log_ls_feature.shape == (3,)


def test_zoom_line_search_restarts_finish_on_different_trips():
    """Per-restart (vmap) semantics: on f(x) = ½ c_r‖x‖² along −∇f the
    guess 1 is accepted where c_r is near 1 and needs further trips
    elsewhere; each restart ends with optax's stepsize, value and
    gradient (within 1e-6 relative; values and gradients at an exact
    minimum are f32 rounding, held within 1e-10 and 1e-5, a millionth
    of the largest starting gradient), and finished
    restarts stay frozen while the others search."""
    from optax._src import linesearch as ls

    c = np.array([1.0, 0.3, 9.0, 60.0], np.float32)
    x0 = np.random.default_rng(2).standard_normal((4, 5)).astype(np.float32)

    def f(x, ci):
        return 0.5 * ci * jnp.sum(x * x)

    opt = ls.scale_by_zoom_linesearch(max_linesearch_steps=20, initial_guess_strategy="one")

    def one(x, ci):
        v, g = jax.value_and_grad(f)(x, ci)
        u = -g
        upd, st = opt.update(u, opt.init(x), x, value=v, grad=g,
                             value_fn=lambda p: f(p, ci))
        return st.learning_rate, st.value, st.grad, st.info.num_linesearch_steps

    lr, val, grad, steps = jax.vmap(one)(jnp.asarray(x0), jnp.asarray(c))
    assert len(set(np.asarray(steps).tolist())) > 1  # different trip counts

    trips = []
    ct = torch.tensor(c)

    def vg(x):
        trips.append(x.clone())
        return 0.5 * ct * torch.sum(x * x, dim=1), ct[:, None] * x

    xt = torch.tensor(x0)
    v0, g0 = vg(xt)
    trips.clear()
    step, value, g = tgp._zoom_linesearch(vg, xt, -g0, v0, g0)
    assert len(trips) == int(np.asarray(steps).max())
    np.testing.assert_allclose(step.numpy(), np.asarray(lr), rtol=1e-6)
    np.testing.assert_allclose(value.numpy(), np.asarray(val), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(grad), rtol=1e-6, atol=1e-5)
