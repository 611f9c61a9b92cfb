"""algp_tpu_torch on the card: each CUDA kernel against its plain version,
and the CUDA twins of the main-path cases of tests/test_hw_fidelity.py
(greedy selections equal the f64 oracle index for index).

These need an NVIDIA GPU and nvcc and skip without one.  They import no
JAX (the machine with the card has none), so run them there without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import oracle
from algp_tpu_torch import acquisition as acq
from algp_tpu_torch.ops import gram as G
from algp_tpu_torch.ops import updates as U
from algp_tpu_torch.ops.kernels import KernelSpec

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(rng, n, spec, dev):
    x = np.concatenate([rng.uniform(0, 15, (n, spec.ds)),
                        rng.standard_normal((n, spec.df))], 1)
    return torch.tensor(x, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("spec", [
    KernelSpec("rbf", ds=2), KernelSpec("matern32", ds=2),
    KernelSpec("matern52", ds=2), KernelSpec("matern52", "rbf", ds=2, df=3),
    KernelSpec("rbf", "matern32", ds=1, df=4),
], ids=lambda s: f"{s.spatial_kind}-{s.feature_kind}-{s.ds}-{s.df}")
@pytest.mark.parametrize("n1,n2", [(1, 1), (63, 33), (997, 1283)])
def test_gram_kernel_matches_plain(dev, spec, n1, n2):
    rng = np.random.default_rng(n1 + n2)
    p = spec.init_params(ls_spatial=2.5, ls_feature=1.3, outputscale=1.7, device=dev)
    x1, x2 = _rand(rng, n1, spec, dev), _rand(rng, n2, spec, dev)
    before = G.LAUNCHES
    got = G.gram_kernel(spec, p, x1, x2)
    assert G.LAUNCHES == before + 1
    torch.cuda.synchronize()
    want = G.gram_reference(spec, p, x1, x2)
    assert (got - want).abs().max().item() <= 2e-6 * 1.7


def test_gram_kernel_raises_instead_of_falling_back(dev):
    spec = KernelSpec("rbf", ds=2)
    p = spec.init_params(device=dev)
    x = torch.zeros((4, 2), device=dev)
    with pytest.raises(ValueError):
        G.gram_kernel(spec, p, x.double(), x.double())
    with pytest.raises(ValueError):
        G.gram_kernel(spec, p, x, x.cpu())


@pytest.mark.parametrize("n", [1, 300, 1000, 2048])
def test_wtw_kernel_matches_plain_and_repeats(dev, n):
    gen = torch.Generator(device=dev).manual_seed(n)
    W = torch.tril(torch.randn((n, n), generator=gen, device=dev))
    for j in sorted({0, n // 3, n // 2, n - 1}):
        jt = torch.tensor(j, device=dev)
        before = U.LAUNCHES
        u1, u2 = U.wtw_column(W, jt), U.wtw_column(W, jt)
        assert U.LAUNCHES == before + 2
        ref = U.wtw_column_reference(W, jt)
        assert torch.equal(u1, u2)  # fixed reduction order, no atomics
        assert (u1 - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_wtw_kernel_out_of_range_index_is_nan(dev):
    W = torch.tril(torch.ones((64, 64), device=dev))
    assert torch.isnan(U.wtw_column(W, torch.tensor(64, device=dev))).all()
    with pytest.raises(ValueError):
        U.wtw_column(W.T, 3)  # not row-major


def _jittered_grid(rows, cols, seed):
    rng = np.random.default_rng(seed)
    r, c = np.divmod(np.arange(rows * cols), cols)
    return np.stack([c + 0.1 * rng.standard_normal(rows * cols),
                     r + 0.1 * rng.standard_normal(rows * cols)], 1)


def _select(dev, spec, params, x, nv, pilot, rounds, strategy, pilot_nv=None):
    res = acq.greedy_select(
        spec, params, torch.tensor(x, dtype=torch.float32, device=dev),
        torch.tensor(nv, dtype=torch.float32, device=dev),
        torch.tensor(pilot, device=dev), rounds=rounds, num_pilot=len(pilot),
        strategy=strategy,
        pilot_nv=None if pilot_nv is None else torch.tensor(
            pilot_nv, dtype=torch.float32, device=dev),
    )
    return res.selected.cpu().numpy()


@pytest.mark.parametrize("strategy", ["entropy", "mi"])
def test_50_round_selection_equals_f64_oracle(dev, strategy):
    x = _jittered_grid(10, 15, seed=17)
    spec = KernelSpec("rbf", ds=2)
    params = spec.init_params(ls_spatial=3.0, outputscale=1.0, noise=0.15, device=dev)
    pilot = np.linspace(0, len(x) - 1, 8).round().astype(np.int64)
    nv = np.full(len(x), 0.15**2)
    K = oracle.gram(x, x, ls_spatial=3.0, outputscale=1.0)
    if strategy == "entropy":
        ref, _ = oracle.greedy_variance_selection(K, 0.15**2, 50, pilot)
    else:
        ref, _ = oracle.greedy_mi_selection(K, 0.15**2, 50, pilot)
    np.testing.assert_array_equal(
        _select(dev, spec, params, x, nv, pilot, 50, strategy), ref)


def test_composite_kernel_selection_equals_f64_oracle(dev):
    rng = np.random.default_rng(23)
    n = 180
    x = np.concatenate([rng.uniform(0, 12, (n, 2)), rng.standard_normal((n, 3))], 1)
    spec = KernelSpec("matern52", "rbf", ds=2, df=3)
    params = spec.init_params(ls_spatial=3.0, ls_feature=1.5, outputscale=1.2,
                              noise=0.15, device=dev)
    pilot = np.linspace(0, n - 1, 6).round().astype(np.int64)
    K = oracle.gram(x, x, spatial_kind="matern52", feature_kind="rbf", ds=2,
                    ls_spatial=3.0, ls_feature=1.5, outputscale=1.2)
    ref, _ = oracle.greedy_mi_selection(K, 0.15**2, 30, pilot)
    np.testing.assert_array_equal(
        _select(dev, spec, params, x, np.full(n, 0.15**2), pilot, 30, "mi"), ref)


@pytest.mark.parametrize("strategy", ["entropy", "mi"])
def test_heteroscedastic_selection_equals_f64_oracle(dev, strategy):
    x = _jittered_grid(10, 15, seed=23)
    spec = KernelSpec("rbf", ds=2)
    params = spec.init_params(ls_spatial=3.0, outputscale=1.0, noise=0.15, device=dev)
    pilot = np.linspace(0, len(x) - 1, 8).round().astype(np.int64)
    nv = np.where(x[:, 0] >= 7.0, 9 * 0.15**2, 0.15**2).astype(np.float32)
    K = oracle.gram(x, x, ls_spatial=3.0, outputscale=1.0)
    fn = (oracle.greedy_variance_selection if strategy == "entropy"
          else oracle.greedy_mi_selection)
    ref, _ = fn(K, nv.astype(np.float64), 40, pilot)
    np.testing.assert_array_equal(
        _select(dev, spec, params, x, nv, pilot, 40, strategy, nv[pilot]), ref)


def test_fit_and_select_on_card_equals_cpu(dev):
    """The whole slice at N = 700 (ragged, 512-aligned to 1024): the card
    and the CPU pick the same candidates from the same inits."""
    from algp_tpu_torch.config import FitConfig
    from algp_tpu_torch.models import gp

    rng = np.random.default_rng(5)
    spec = KernelSpec("rbf", ds=2)
    cfg = FitConfig(iters=40, restarts=3)
    x = rng.uniform(0, 20, (700, 2)).astype(np.float32)
    pilot = np.linspace(0, 699, 16).round().astype(np.int64)
    y = (np.sin(x[pilot, 0] / 3) + 0.05 * rng.standard_normal(16)).astype(np.float32)
    inits = gp.make_restart_inits(spec, cfg, torch.Generator().manual_seed(2))
    out = {}
    for d in ("cpu", dev):
        fit, sel = acq.fit_and_select(
            spec, cfg, torch.tensor(x[pilot], device=d), torch.tensor(y, device=d),
            torch.tensor(x, device=d), torch.tensor(pilot, device=d), rounds=25,
            num_pilot=16, strategy="mi", inits=inits.map(lambda a: a.to(d)),
        )
        out[str(d)] = (float(fit.nll), sel.selected.cpu().numpy())
    (nll_c, sel_c), (nll_g, sel_g) = out["cpu"], out[str(dev)]
    assert nll_g == pytest.approx(nll_c, rel=1e-4)
    np.testing.assert_array_equal(sel_g, sel_c)
