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
@pytest.mark.parametrize("n1,n2", [(1, 1), (63, 33), (997, 1283)] + [
    (n1, n2) for n1 in (1, 7, 64, 513) for n2 in (4000, 4001, 4002, 4003)])
def test_gram_kernel_matches_plain(dev, spec, n1, n2):
    """Spatial-only RBF and Matérn 3/2 repeat the plain arithmetic in its
    order: equal bit for bit, with 16-byte rows (n2 % 4 == 0) and without
    (the 4-byte store path), over one tile row and many.  Matérn 5/2 and
    the composites within 2e-6 · s²."""
    rng = np.random.default_rng(n1 + n2)
    p = spec.init_params(ls_spatial=2.5, ls_feature=1.3, outputscale=1.7, device=dev)
    x1, x2 = _rand(rng, n1, spec, dev), _rand(rng, n2, spec, dev)
    before = G.LAUNCHES
    got = G.gram_kernel(spec, p, x1, x2)
    assert G.LAUNCHES == before + 1
    torch.cuda.synchronize()
    want = G.gram_reference(spec, p, x1, x2)
    if spec.spatial_kind in ("rbf", "matern32") and not spec.df:
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= 2e-6 * 1.7


def test_batch_pilot_condition_kernel_route_equals_plain(dev, monkeypatch):
    """The conditioning pass's (cap, N) cross-Gram through the Gram kernel
    gives the plain route's C, d and factor bit for bit (cap 96 with 80
    live slots, N = 40 000, Matérn 3/2), with one kernel launch."""
    spec = KernelSpec("matern32", ds=2)
    rng = np.random.default_rng(96)
    p = spec.init_params(ls_spatial=10.0, outputscale=1.3, noise=0.1, device=dev)
    x = torch.tensor(rng.uniform(0, 200, (40000, 2)), dtype=torch.float32, device=dev)
    idx = torch.tensor(rng.choice(40000, 96, replace=False), device=dev)
    pnv = torch.full((96,), 0.01, device=dev)
    d0 = torch.full((40000,), 1.3, device=dev)
    before = G.LAUNCHES
    got = acq._batch_pilot_condition(spec, p, x, pnv, idx, 80, d0)
    assert G.LAUNCHES == before + 1
    monkeypatch.setattr(acq, "gram_kernel", G.gram_reference)
    want = acq._batch_pilot_condition(spec, p, x, pnv, idx, 80, d0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[0][80:] == 0).all()


def test_gram_kernel_raises_instead_of_falling_back(dev):
    spec = KernelSpec("rbf", ds=2)
    p = spec.init_params(device=dev)
    x = torch.zeros((4, 2), device=dev)
    with pytest.raises(ValueError):
        G.gram_kernel(spec, p, x.double(), x.double())
    with pytest.raises(ValueError):
        G.gram_kernel(spec, p, x, x.cpu())


@pytest.mark.parametrize("n", [1, 300, 301, 1000, 2048, 10240])
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
    assert torch.isnan(U.wtw_column(W, torch.tensor([-1], device=dev))).all()
    assert torch.isnan(U.wtw_column_strip(W[16:40].contiguous(), torch.tensor(2 ** 40, device=dev),
                                          16)).all()
    with pytest.raises(ValueError):
        U.wtw_column(W.T, 3)  # not row-major


def _strips(n, S):
    bounds = np.linspace(0, n, S + 1).round().astype(int)
    return list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))


@pytest.mark.parametrize("n,S", [(n, S) for n in (301, 1000, 2048, 10240) for S in (1, 2, 3, 4)])
def test_wtw_strip_kernel_matches_plain(dev, n, S):
    """Each rank's strip of W (ragged when S does not divide n, 4-byte
    loads when n % 4 ≠ 0): the kernel against W_loc[:, j] @ W_loc, exact
    zeros in the columns past the strip's last row, and the strips' sum
    against the square column."""
    gen = torch.Generator(device=dev).manual_seed(n + S)
    W = torch.tril(torch.randn((n, n), generator=gen, device=dev))
    for j in sorted({0, n // 3, n - 1}):
        jt = torch.tensor(j, device=dev)
        full = U.wtw_column_reference(W, jt)
        total = torch.zeros_like(full)
        for r0, r1 in _strips(n, S):
            W_loc = W[r0:r1].contiguous()
            before = U.LAUNCHES
            got = U.wtw_column_strip(W_loc, jt, r0)
            assert U.LAUNCHES == before + 1
            ref = U.wtw_column_reference(W_loc, jt)
            assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item() + 1e-30
            assert (got[r1:] == 0).all() and not torch.signbit(got[r1:]).any()
            total += got
        assert (total - full).abs().max().item() <= 1e-4 * full.abs().max().item()


def test_wtw_reused_output_repeats_bitwise(dev):
    """One `out` buffer over rounds of different j, as the loops use it:
    each round bit for bit a fresh call's column, and the same j twice the
    same bits; the int32 index takes the conversion and the same bits."""
    n = 2048
    gen = torch.Generator(device=dev).manual_seed(5)
    W = torch.tril(torch.randn((n, n), generator=gen, device=dev))
    W_loc = W[512:1536].contiguous()
    out, out_s = torch.empty(n, device=dev), torch.empty(n, device=dev)
    for j in (7, 1500, 7, 2047, 0, 1024):
        jt = torch.tensor([j], device=dev)
        assert U.wtw_column(W, jt, out=out) is out
        assert torch.equal(out, U.wtw_column(W, jt))
        assert torch.equal(out, U.wtw_column(W, jt.to(torch.int32)))
        assert U.wtw_column_strip(W_loc, jt, 512, out=out_s) is out_s
        assert torch.equal(out_s, U.wtw_column_strip(W_loc, jt, 512))
    with pytest.raises(ValueError, match="out must be"):
        U.wtw_column(W, jt, out=torch.empty(n - 1, device=dev))


def test_wtw_call_is_one_launch_and_no_allocation(dev):
    """A call with `out` launches exactly one kernel (the profiler's device
    events) and allocates nothing over 100 calls (the caching allocator's
    count), for the square call and a strip."""
    n = 4096
    gen = torch.Generator(device=dev).manual_seed(6)
    W = torch.tril(torch.randn((n, n), generator=gen, device=dev))
    W_loc = W[1024:2048].contiguous()
    jt = torch.tensor([100], device=dev)
    out = torch.empty(n, device=dev)
    calls = (lambda: U.wtw_column(W, jt, out=out),
             lambda: U.wtw_column_strip(W_loc, jt, 1024, out=out))
    for call in calls:
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and "wtw_column_kernel" in kernels[0], kernels
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        for _ in range(100):
            call()
        torch.cuda.synchronize()
        assert torch.cuda.memory_stats()["allocation.all.allocated"] == before


def test_sharded_mi_on_two_gloo_ranks_sharing_the_card(dev):
    """The mesh loop on the card: two gloo ranks on card 0, both seeds,
    the selections equal to the single-card loop's and the f64 oracle's."""
    from pathlib import Path

    from algp_tpu_torch.convert import kernel_params_to_numpy
    from algp_tpu_torch.parallel import launch

    jobs = str(Path(__file__).resolve().parent / "torch_mesh_jobs.py") + ":run_cases"
    x = _jittered_grid(16, 20, seed=5)
    spec = KernelSpec("rbf", ds=2)
    params = spec.init_params(ls_spatial=3.0, outputscale=1.0, noise=0.15, device=dev)
    nv = np.full(len(x), 0.15 ** 2)
    pilot = np.array([3, 100, 100, 250])
    case = dict(params=kernel_params_to_numpy(params), x=x, nv=nv, pilot=pilot, rounds=30)
    cases = {"rep": ("mi", dict(case, distributed_seed=False)),
             "dist": ("mi", dict(case, distributed_seed=True)),
             "entropy": ("greedy", dict(case, strategy="entropy"))}
    outs = launch.run(jobs, 2, backend="gloo", device="cuda", timeout=600,
                      kwargs={"restarts_axis": 1, "cases": cases, "device": "cuda"})
    K = oracle.gram(x, x, ls_spatial=3.0, outputscale=1.0)
    ref_mi, _ = oracle.greedy_mi_selection(K, 0.15 ** 2, 30, pilot)
    ref_var, _ = oracle.greedy_variance_selection(K, 0.15 ** 2, 30, pilot)
    for o in outs:
        np.testing.assert_array_equal(o["rep/selected"], _select(
            dev, spec, params, x, nv, pilot, 30, "mi"))
        np.testing.assert_array_equal(o["rep/selected"], ref_mi)
        np.testing.assert_array_equal(o["dist/selected"], ref_mi)
        np.testing.assert_array_equal(o["entropy/selected"], ref_var)
        assert tuple(o["rep/strip_W"]) == (256, 512)


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


def test_posterior_matches_f64_oracle(dev):
    """Posterior mean / variance on the card (the Gram kernel's
    cross-covariance + the triangular solve) vs the f64 oracle."""
    from algp_tpu_torch.models import gp

    rng = np.random.default_rng(3)
    x = rng.uniform(0, 12, (200, 2))
    xs = x[:60]
    y = rng.standard_normal(60)
    spec = KernelSpec("rbf", ds=2)
    params = spec.init_params(ls_spatial=2.0, outputscale=1.5, noise=0.2, device=dev)
    post = gp.posterior(spec, params, torch.tensor(xs, dtype=torch.float32, device=dev),
                        torch.tensor(y, dtype=torch.float32, device=dev),
                        min_noise=1e-3, jitter=1e-6)
    before = G.LAUNCHES
    mean, var = gp.predict(spec, params, post,
                           torch.tensor(x, dtype=torch.float32, device=dev))
    assert G.LAUNCHES == before + 1
    nv = 0.2**2 + 1e-6
    K = oracle.gram(xs, xs, ls_spatial=2.0, outputscale=1.5) + nv * np.eye(60)
    Kc = oracle.gram(xs, x, ls_spatial=2.0, outputscale=1.5)
    m_ref, v_ref = oracle.posterior(K, Kc, 1.5 * np.ones(200), y)
    np.testing.assert_allclose(mean.cpu().numpy(), m_ref, atol=5e-3)
    np.testing.assert_allclose(var.cpu().numpy(), v_ref, atol=5e-3)


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


def test_fit_multi_on_card_matches_individual_fits(dev):
    """The CUDA twin of test_hw_fidelity.py's fit_multi case: the T·R
    restart batch on the card against T separate fits from the same inits,
    NLL within 5e-4 and lengthscales within 2e-3."""
    from algp_tpu_torch.config import FitConfig
    from algp_tpu_torch.models import gp

    rng = np.random.default_rng(17)
    n, T = 90, 3
    spec = KernelSpec("rbf", ds=2)
    x = torch.tensor(rng.uniform(0, 10, (n, 2)), dtype=torch.float32, device=dev)
    Y = torch.tensor(rng.standard_normal((n, T)), dtype=torch.float32, device=dev)
    cfg = FitConfig(iters=40, restarts=2)
    inits = gp.make_restart_inits(spec, cfg, torch.Generator(device=dev).manual_seed(5))
    multi = gp.fit_multi(spec, cfg, x, Y, inits=inits)
    assert torch.isfinite(multi.nll).all()
    for t in range(T):
        single = gp.fit(spec, cfg, x, Y[:, t], inits=inits)
        rt = gp.trait_result(multi, t)
        np.testing.assert_allclose(float(rt.nll), float(single.nll), rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(rt.params.log_ls_spatial.cpu().numpy(),
                                   single.params.log_ls_spatial.cpu().numpy(),
                                   rtol=2e-3, atol=2e-3)


class _InProcess:
    """`chip_smoke.greedy_vs_oracle`'s worker pool, run in this process:
    `apply_async(fn, args).get()` is fn(*args)."""

    def apply_async(self, fn, args):
        result = fn(*args)
        return type("Done", (), {"get": staticmethod(lambda: result)})()


def test_composite_greedy_selections_equal_f64_oracle(dev):
    """chip_smoke.py phase 12d at a small size: c2_composite_restarts'
    greedy MI (Matérn 5/2 × RBF over [pose | 3 features], fitted params)
    on a 12 × 15 field; the card's 30 selections equal the oracle's."""
    import chip_smoke

    out = chip_smoke.greedy_vs_oracle(dev, oracle, [
        "--preset", "c2_composite_restarts", "--rows", "12", "--cols", "15",
        "--mode", "greedy", "--acq-rounds", "30", "--num-pilot", "10", "--iters", "60"],
        _InProcess())
    assert np.isfinite(out["rec"]["final_rmse"])
    assert out["launches"]["wtw_column"] >= 30
    np.testing.assert_array_equal(out["selected"], out["oracle_future"].get()[0])


# ------------------------------------------------ the Cholesky kernel


def _chol_seed(n, dev):
    rng = np.random.default_rng(n)
    spec = KernelSpec("matern32", ds=2)
    p = spec.init_params(ls_spatial=3.0, outputscale=1.3, noise=0.1, device=dev)
    x = torch.tensor(rng.uniform(0, 15, (n, 2)), dtype=torch.float32, device=dev)
    return G.gram_kernel_with_noise(spec, p, x)


# the edges of the 64-wide sub-steps, the 128 padding, the 256-wide strips
# and the lookahead's second and third strips
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 200, 255, 256, 257,
                               511, 513, 997, 2051])
def test_cholesky_kernel_matches_plain(dev, n):
    from algp_tpu_torch.ops import chol as C

    K = _chol_seed(n, dev)
    K0 = K.clone()
    before = C.LAUNCHES
    L = C.cholesky(K)
    assert C.LAUNCHES == before + 1
    torch.cuda.synchronize()
    assert torch.equal(K, K0)  # the input is not modified
    ref = C.cholesky_reference(K)
    assert (torch.triu(L, 1) == 0).all()
    # f32 factors of a system with noise variance 1e-2: agree to 1e-4
    assert (L - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    res = (L.double() @ L.double().T - K.double()).abs().max().item()
    assert res <= 1e-5 * K.abs().max().item()


@pytest.mark.parametrize("n,bad", [(300, 130), (700, 256), (700, 650)],
                         ids=["inside-a-strip", "strip-boundary", "last-strip"])
def test_cholesky_kernel_non_spd_is_nan_from_the_failing_column(dev, n, bad):
    from algp_tpu_torch.ops import chol as C

    A = torch.randn((n, n), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    K = A @ A.T / n + torch.eye(n, device=dev)
    K[bad, bad] = -1.0
    L = C.cholesky(K)
    low = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dev))
    assert torch.isfinite(L[:, :bad]).all()
    assert torch.isnan(L[:, bad:])[low[:, bad:]].all()
    assert (torch.triu(L, 1) == 0).all()
    assert torch.isnan(C.cholesky_reference(K))[low].all()  # NaN throughout
    assert torch.isnan(C.nan_if_failed(L)).all()
    with pytest.raises(ValueError):
        C.cholesky(K.double())


def test_cholesky_kernel_repeats_bitwise(dev):
    from algp_tpu_torch.ops import chol as C

    K = _chol_seed(2051, dev)
    assert torch.equal(C.cholesky(K), C.cholesky(K))  # no atomics, fixed order


# ------------------------------------------- the blocked triangular inverse


def test_blocked_tri_inv_at_the_seed_size(dev):
    """`tri_inv` at n = 10 240 (main10k's padded seed: RBF, ls 8, noise
    variance 0.01 on a 128 × 80 grid) takes the blocked path without a
    host sync and agrees with the f64 solve within 1e-5 · max|W|."""
    from algp_tpu_torch.ops import linalg as la

    r, c = np.divmod(np.arange(10240), 128)
    x = torch.tensor(np.stack([c, r], 1), dtype=torch.float32, device=dev)
    spec = KernelSpec("rbf", ds=2)
    p = spec.init_params(ls_spatial=8.0, outputscale=1.0, noise=0.1, device=dev)
    L = la.cholesky(G.gram_kernel_with_noise(spec, p, x))
    la.tri_inv(L)  # warm
    before = la.TRI_INV_BLOCKED
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        W = la.tri_inv(L)
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    end.synchronize()
    print(f"tri_inv n=10240: {start.elapsed_time(end):.2f} ms "
          f"({torch.cuda.get_device_name(0)})")
    assert la.TRI_INV_BLOCKED == before + 1
    assert W.is_contiguous() and (torch.triu(W, 1) == 0).all()
    L64 = L.double()
    want = torch.linalg.solve_triangular(L64.mT, torch.eye(10240, dtype=torch.float64,
                                                           device=dev), upper=True).mT
    assert (W.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# ------------------------------------------------------- the episode


def _episode_cfg(strategy, **ep):
    from algp_tpu_torch import config as tc

    return tc.ExperimentConfig(
        kernel=KernelSpec("matern32", ds=2),
        field=tc.FieldConfig(num_rows=8, num_cols=12, seed=3),
        fit=tc.FitConfig(iters=10, restarts=2, refit_iters=5, refit_restarts=2),
        acquisition=tc.AcquisitionConfig(strategy=strategy),
        episode=tc.EpisodeConfig(**{**dict(num_pilot=8, budget=24.0,
                                           refit_every=2, seed=3), **ep}),
    )


@pytest.fixture
def cpu_inits(monkeypatch):
    """Both devices fit from the same inits: the CPU generator's draws,
    moved to the episode's device."""
    from algp_tpu_torch.models import gp

    orig = gp.step_inits
    monkeypatch.setattr(gp, "step_inits", lambda spec, cfg, seed, step, device: orig(
        spec, cfg, seed, step, "cpu").map(lambda a: a.to(device)))


@pytest.mark.parametrize("strategy", ["mi", "entropy", "uniform", "naive"])
def test_small_episode_on_card_equals_cpu(dev, cpu_inits, strategy):
    from algp_tpu_torch.convert import field_env_like
    from algp_tpu_torch.episode import Agent
    from algp_tpu_torch.field import FieldEnv

    cfg = _episode_cfg(strategy)
    env_c = FieldEnv(cfg.field, cfg.kernel, device="cpu")
    env_g = field_env_like(env_c, dev)
    res_c = Agent(env_c, cfg).run()
    res_g = Agent(env_g, cfg).run()
    np.testing.assert_array_equal(res_g.state.sampled_idx, res_c.state.sampled_idx)
    for hc, hg in zip(res_c.history, res_g.history):
        if "rmse" in hc:
            assert hg["rmse"] == pytest.approx(hc["rmse"], rel=1e-3)


@pytest.mark.parametrize("strategy", ["entropy", "mi"])
def test_c5_fused_plan_metrics_match_posterior(dev, strategy):
    """The fused step's posterior mean / variance equal the standalone
    gp.posterior_and_predict on the card at every step of a real episode,
    and its path choice equals the CPU plan's from the same state."""
    import dataclasses

    from algp_tpu_torch.convert import field_env_like
    from algp_tpu_torch.episode import Agent
    from algp_tpu_torch.field import FieldEnv
    from algp_tpu_torch.models import gp

    cfg = _episode_cfg(strategy, num_pilot=6, num_waypoints=4, samples_per_step=4,
                       seed=5, modality="mixed")
    env = FieldEnv(dataclasses.replace(cfg.field, num_rows=6, num_cols=10, seed=37),
                   cfg.kernel, device=dev)
    agent = Agent(env, cfg)
    twin = Agent(field_env_like(env, "cpu"), cfg)
    checked = {"n": 0}
    orig = agent._plan_and_metrics

    def checking(st):
        bundle = orig(st)
        if len(bundle.nodes) == 0:
            return bundle
        x, y, ns, m = agent._padded_train(st)
        _, mean_ref, var_ref = gp.posterior_and_predict(
            agent.spec, st.params, x, y, ns, agent._Xdev,
            min_noise=cfg.fit.min_noise, jitter=cfg.fit.jitter, num_valid=m,
        )
        np.testing.assert_allclose(bundle.mean, mean_ref.cpu().numpy(), atol=2e-3)
        np.testing.assert_allclose(bundle.var, var_ref.cpu().numpy(), atol=2e-3)
        st_cpu = dataclasses.replace(st, params=st.params.map(lambda a: a.cpu()))
        assert twin._plan_and_metrics(st_cpu).sites == bundle.sites
        checked["n"] += 1
        return bundle

    agent._plan_and_metrics = checking
    result = agent.run(max_steps=5)
    assert checked["n"] >= 3
    assert np.isfinite(result.rmse)


def test_episode_resume_on_card_continues_exactly(dev, tmp_path):
    from algp_tpu_torch.convert import field_env_like
    from algp_tpu_torch.episode import Agent
    from algp_tpu_torch.field import FieldEnv
    from algp_tpu_torch.utils import checkpoint as ckpt

    cfg = _episode_cfg("mi", num_pilot=6, budget=30.0, num_waypoints=5,
                       samples_per_step=4, seed=2)
    env_a = FieldEnv(cfg.field, cfg.kernel, device=dev)
    full = Agent(field_env_like(env_a, dev), cfg).run(max_steps=10)
    half = Agent(field_env_like(env_a, dev), cfg).run(max_steps=3)
    path = str(tmp_path / "mid.npz")
    ckpt.save(path, half.state)
    resumed = Agent(field_env_like(env_a, dev), cfg).run(
        max_steps=10, resume_from=ckpt.load(path, dev))
    np.testing.assert_array_equal(resumed.state.sampled_idx, full.state.sampled_idx)
    assert resumed.rmse == pytest.approx(full.rmse, abs=1e-5)


# ------------------------------------------------ the low-rank scale paths


@pytest.mark.parametrize("case", ["int_grid_ties", "jittered"])
def test_kcenter_on_card_equals_cpu(dev, case):
    from algp_tpu_torch.acquisition_lowrank import kcenter_indices

    if case == "int_grid_ties":  # exact integer grid: distances tie massively
        r, c = np.divmod(np.arange(60 * 60), 60)
        x = np.stack([c, r], 1).astype(np.float32)
    else:
        x = _jittered_grid(60, 60, seed=4).astype(np.float32)
    cpu = kcenter_indices(torch.tensor(x), 256).numpy()
    card = kcenter_indices(torch.tensor(x, device=dev), 256).cpu().numpy()
    np.testing.assert_array_equal(card, cpu)
    assert len(np.unique(card)) == 256


def test_v_rows_at_equal_the_kernel_built_seed_rows(dev):
    """The step rebuilds precision rows with the plain Gram (`v_rows_at`);
    the full seed's K_zx comes from the Gram kernel.  Same rows within the
    CPU test's f32 tolerance (a solve's bits depend on its RHS width)."""
    from algp_tpu_torch import acquisition_lowrank as lr

    spec = KernelSpec("matern32", ds=2)
    p = spec.init_params(ls_spatial=6.0, outputscale=1.2, noise=0.1, device=dev)
    x = torch.tensor(_jittered_grid(64, 64, seed=9), dtype=torch.float32, device=dev)
    z = x.index_select(0, lr.kcenter_indices(x, 256))
    before = G.LAUNCHES
    full = lr.lowrank_seed_with_z(spec, p, x, z)
    fac = lr.lowrank_factors_seed(spec, p, x, z)
    assert G.LAUNCHES == before + 2  # K_zx of both seeds from the kernel
    rows = torch.tensor(np.random.default_rng(0).choice(len(x), 300, replace=False),
                        device=dev)
    nv = torch.clamp_min(p.noise_var, 1e-6) * torch.ones(300, device=dev)
    VT_r, dinv_r = lr.v_rows_at(spec, p, fac, x[rows], nv, len(x))
    np.testing.assert_allclose(VT_r.cpu().numpy(), full.VT[rows].cpu().numpy(),
                               rtol=5e-3, atol=2e-4)
    np.testing.assert_allclose(dinv_r.cpu().numpy(), full.dinv[rows].cpu().numpy(),
                               rtol=5e-3)


@pytest.mark.parametrize("num_pilot", [0, 6])
def test_greedy_lowrank_equals_f64_oracle(dev, num_pilot):
    from algp_tpu_torch import acquisition_lowrank as lr

    x = _jittered_grid(30, 30, seed=11)
    spec = KernelSpec("rbf", ds=2)
    params = spec.init_params(ls_spatial=3.0, outputscale=1.0, noise=0.15, device=dev)
    xt = torch.tensor(x, dtype=torch.float32, device=dev)
    zidx = lr.kcenter_indices(xt, 150)
    pilot = np.linspace(0, len(x) - 1, num_pilot).round().astype(np.int64)
    before = G.LAUNCHES
    res = lr.greedy_select_lowrank(
        spec, params, xt, torch.full((len(x),), 0.15**2, device=dev),
        torch.tensor(pilot, device=dev), xt.index_select(0, zidx),
        rounds=30, num_pilot=num_pilot)
    # the seed's K_zx and, with pilots, their cross-Gram
    assert G.LAUNCHES == before + 1 + (num_pilot > 0)
    K = oracle.gram(x, x, ls_spatial=3.0, outputscale=1.0)
    ref, _ = oracle.greedy_mi_selection_lowrank(K, zidx.cpu().numpy(), 0.15**2, 30,
                                                pilot)
    np.testing.assert_array_equal(res.selected.cpu().numpy(), ref)


def test_jitter_ladder_on_card(dev):
    """Healthy K_zz: the plain factor bitwise, no jitter.  A duplicated
    dense design (not PD in f32): finite, with the jitter the host-reading
    `safe_cholesky` picks and a residual within 4× of its factor's (the
    batched factorization of the ladder rounds otherwise than the single
    one on the card)."""
    from algp_tpu_torch.ops import linalg as la

    spec = KernelSpec("matern32", ds=2)
    p = spec.init_params(ls_spatial=3.0, outputscale=1.0, device=dev)
    x = torch.tensor(_jittered_grid(20, 20, seed=2), dtype=torch.float32, device=dev)
    K = G.gram_reference(spec, p, x, x) + 1e-3 * torch.eye(400, device=dev)
    L, jit = la.jitter_ladder_cholesky(K, initial_jitter=1e-5)
    assert torch.equal(L, la.cholesky(K)) and float(jit) == 0.0
    xd = torch.cat([x, x[:50]])
    pd = spec.init_params(ls_spatial=12.0, outputscale=1.0, device=dev)
    Kd = G.gram_reference(spec, pd, xd, xd)
    assert not torch.isfinite(la.cholesky(Kd)).all()
    L, jit = la.jitter_ladder_cholesky(Kd, initial_jitter=1e-5)
    Lh, jit_h = la.safe_cholesky(Kd, initial_jitter=1e-5)
    assert torch.isfinite(L).all() and float(jit) > 0
    assert float(jit) == float(jit_h)
    Kj = (Kd + jit * torch.eye(len(xd), device=dev)).double()
    res = (L.double() @ L.double().T - Kj).abs().max().item()
    res_h = (Lh.double() @ Lh.double().T - Kj).abs().max().item()
    assert res <= 4 * res_h + 1e-7


def test_sparse_fit_on_card_equals_cpu(dev):
    """SGPR from the same inits on the card and the CPU: the same best
    −ELBO within 1e-4, the same predictive mean within 2e-3."""
    from algp_tpu_torch.config import FitConfig
    from algp_tpu_torch.models import gp, sparse_gp

    rng = np.random.default_rng(8)
    spec = KernelSpec("matern32", ds=2)
    cfg = FitConfig(iters=40, restarts=3)
    x = rng.uniform(0, 20, (600, 2)).astype(np.float32)
    y = (np.sin(x[:, 0] / 3) + 0.1 * rng.standard_normal(600)).astype(np.float32)
    inits = gp.make_restart_inits(spec, cfg, torch.Generator().manual_seed(4))
    out = {}
    for d in ("cpu", dev):
        model = sparse_gp.SparseGP(spec, num_inducing=64, fit_config=cfg, device=d)
        res = model.fit(x, y, inits=inits.map(lambda a: a.to(d)))
        mean, var = model.predict(x)
        out[str(d)] = (float(res.nll), mean.cpu().numpy())
    assert out[str(dev)][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    np.testing.assert_allclose(out[str(dev)][1], out["cpu"][1], atol=2e-3)


# ------------------------------------------------ the million-point regime


@pytest.mark.parametrize("path_utility", ["per_cost", "per_sample"])
def test_z_ensemble_step_on_card_equals_cpu(dev, path_utility):
    """Twin of test_hw_fidelity's z-ensemble case: K = 3 small-factor
    seeds, scores averaged before the argmax; the same path
    on the card and the CPU, scores within 1e-3, metrics within 5e-3."""
    from algp_tpu_torch import acquisition_lowrank as lr

    K_ens, n, cap, S_sets, k, M = 3, 156, 16, 12, 5, 36
    rng = np.random.default_rng(41)
    x_np = _jittered_grid(12, 13, seed=41).astype(np.float32)
    spec = KernelSpec("rbf", ds=2)
    idx = np.pad(rng.choice(n, 10, replace=False), (0, cap - 10))
    y = np.pad(rng.standard_normal(10).astype(np.float32), (0, cap - 10))
    sets = np.stack([rng.choice(n, k, replace=False) for _ in range(S_sets)])
    sizes = rng.integers(2, k + 1, S_sets)
    costs = rng.uniform(2.0, 6.0, S_sets).astype(np.float32)
    zidx = [lr.kcenter_indices(torch.tensor(x_np), M, start=(j * n) // K_ens)
            for j in range(K_ens)]

    def run(d):
        params = spec.init_params(ls_spatial=2.5, outputscale=1.2, noise=0.12, device=d)
        x = torch.tensor(x_np, device=d)
        facs = [lr.lowrank_factors_seed(spec, params, x, x[zi.to(d)]) for zi in zidx]
        best, mean, var, scores = lr.plan_episode_step_lowrank_factors(
            spec, params, x, torch.tensor(idx, device=d), 10,
            torch.ones(cap, device=d), torch.tensor(y, device=d),
            torch.tensor(sets, device=d), torch.tensor(sizes, device=d),
            torch.tensor(costs, device=d), facs, path_utility=path_utility)
        return int(best), mean.cpu().numpy(), var.cpu().numpy(), scores.cpu().numpy()

    b_g, m_g, d_g, s_g = run(dev)
    assert np.isfinite(s_g).all() and np.isfinite(m_g).all()
    b_c, m_c, d_c, s_c = run("cpu")
    assert b_g == b_c
    np.testing.assert_allclose(s_g, s_c, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(m_g, m_c, atol=5e-3)
    np.testing.assert_allclose(d_g, d_c, atol=5e-3)


def test_chunked_and_monolithic_matmul_seeds_pick_the_same_sites(dev, cpu_inits,
                                                                 monkeypatch):
    """With the explicit-inverse gate forced on, a low-rank episode on the
    card seeded by the streamed small-factor pass (chunks of 64 columns)
    samples the sites of the one seeded by the monolithic pass; their
    factors agree within 1e-5 of max|LB| (only the order of B's sums
    differs)."""
    import dataclasses

    from algp_tpu_torch import acquisition as acq_mod
    from algp_tpu_torch import acquisition_lowrank as lr
    from algp_tpu_torch import config as tc
    from algp_tpu_torch.convert import field_env_like
    from algp_tpu_torch.episode import Agent
    from algp_tpu_torch.field import FieldEnv

    monkeypatch.setattr(acq_mod, "COND_MATMUL_N", 1)
    cfg = _episode_cfg("mi", num_pilot=12, budget=40.0, samples_per_step=6, seed=5,
                       device_metrics=True)
    cfg = dataclasses.replace(
        cfg, field=tc.FieldConfig(num_rows=12, num_cols=16, true_ls_spatial=3.0,
                                  synth_inducing=48, seed=5),
        acquisition=tc.AcquisitionConfig(strategy="mi", num_inducing=40))
    env = FieldEnv(cfg.field, cfg.kernel, device=dev)
    mono = Agent(field_env_like(env, dev), cfg)
    res_m = mono.run(max_steps=6)
    monkeypatch.setattr(lr, "_SEED_CHUNK_BYTES", 0)
    monkeypatch.setattr(lr, "_SEED_CHUNK", 64)  # 64 ∤ 192: a padded tail
    before = G.LAUNCHES
    fac_c = lr.lowrank_factors_seed(cfg.kernel, res_m.state.params, env.X,
                                    mono._lowrank_z())
    assert G.LAUNCHES == before + 3  # one Gram launch per chunk
    monkeypatch.setattr(lr, "_SEED_CHUNK_BYTES", 5 * 2**30)
    fac_m = lr.lowrank_factors_seed(cfg.kernel, res_m.state.params, env.X,
                                    mono._lowrank_z())
    lb = fac_m.LB.abs().max().item()
    assert (fac_c.LB - fac_m.LB).abs().max().item() <= 1e-5 * lb
    monkeypatch.setattr(lr, "_SEED_CHUNK_BYTES", 0)
    res_c = Agent(field_env_like(env, dev), cfg).run(max_steps=6)
    np.testing.assert_array_equal(res_c.state.sampled_idx, res_m.state.sampled_idx)


def test_gram_kernel_at_2_31_outputs(dev):
    """512 inducing points against the 2048 × 2048 grid (c5_4m's K_zx,
    2³¹ entries, 8.6 GB): sampled columns, the last ones included, equal
    the plain version within 2e-6 · s²."""
    spec = KernelSpec("matern32", ds=2)
    p = spec.init_params(ls_spatial=160.0, outputscale=1.0, device=dev)
    r, c = np.divmod(np.arange(2048 * 2048), 2048)
    x = torch.tensor(np.stack([c, r], 1), dtype=torch.float32, device=dev)
    z = x[:: x.shape[0] // 512][:512].contiguous()
    K = G.gram_kernel(spec, p, z, x)
    torch.cuda.synchronize()
    cols = torch.cat([torch.randint(0, x.shape[0], (4096,),
                                    generator=torch.Generator().manual_seed(0)),
                      torch.arange(x.shape[0] - 64, x.shape[0])]).to(dev)
    want = G.gram_reference(spec, p, z, x.index_select(0, cols))
    assert (K.index_select(1, cols) - want).abs().max().item() <= 2e-6


# ------------------------------------------------ slice 4's models and twins


def test_icm_on_card_matches_f64_oracle(dev):
    """Twin of test_hw_fidelity's ICM case: the joint nT × nT system's f32
    factor on the card (48 plots × 3 traits, a third of the secondary
    cells masked) and the per-trait posterior against the f64 oracle."""
    from algp_tpu_torch.models import coregional as icm

    rng = np.random.default_rng(41)
    n, T = 48, 3
    x = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    xs = rng.uniform(0, 10, (30, 2)).astype(np.float32)
    A = rng.standard_normal((T, 2)) * 0.6
    B = A @ A.T + np.diag(rng.uniform(0.3, 0.8, T))
    nv_t = rng.uniform(0.01, 0.05, T)
    Kx = oracle.gram(x.astype(np.float64), x.astype(np.float64), ls_spatial=2.0)
    C = np.kron(Kx, B) + np.diag(np.tile(nv_t, n))
    Y = (np.linalg.cholesky(C + 1e-10 * np.eye(n * T))
         @ rng.standard_normal(n * T)).reshape(n, T)
    mask = rng.uniform(size=(n, T)) > 0.3
    mask[:, 0] = True
    mask[0] = True
    spec = KernelSpec("rbf", ds=2)
    kappa = np.full(T, -12.0)
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    params = icm.ICMParams(
        kernel=spec.init_params(ls_spatial=2.0, outputscale=1.0, noise=0.1, device=dev),
        coreg_a=f32(np.linalg.cholesky(B - np.diag(np.exp(kappa)))),
        log_coreg_kappa=f32(kappa), log_noise_t=f32(0.5 * np.log(nv_t)))
    Bdev = icm.trait_cov(params).double().cpu().numpy()
    m_t = torch.tensor(mask, device=dev)
    got = float(icm.neg_mll_icm(spec, params, f32(x), f32(Y), m_t, min_noise=1e-4, jitter=0.0))
    assert got == pytest.approx(oracle.icm_nll(Kx, Bdev, Y, nv_t, mask), rel=5e-4, abs=5e-3)
    post = icm.posterior_icm(spec, params, f32(x), f32(Y), m_t, min_noise=1e-4, jitter=0.0)
    before = G.LAUNCHES
    mean, var = icm.predict_icm(spec, params, post, f32(xs))
    assert G.LAUNCHES == before + 1  # the (n, N) cross-Gram on the kernel
    Kc = oracle.gram(x.astype(np.float64), xs.astype(np.float64), ls_spatial=2.0)
    want_m, want_v = oracle.icm_posterior(Kx, Kc, np.ones(len(xs)), Bdev, Y, nv_t, mask)
    np.testing.assert_allclose(mean.cpu().numpy(), want_m, atol=2e-3)
    np.testing.assert_allclose(var.cpu().numpy(), want_v, atol=2e-3)


def test_deep_kernel_greedy_selections_equal_f64_oracle(dev):
    """chip_smoke.py phase 14d at a small size: greedy MI of the deep
    kernel (c2_composite_restarts with a 16-wide hidden layer embedding the
    3 features to 4) on a 12 × 15 field; the card's 30 selections over the
    embedded candidates, at the fitted params, equal the oracle's."""
    import chip_smoke

    out = chip_smoke.greedy_vs_oracle(dev, oracle, [
        "--preset", "c2_composite_restarts", "--rows", "12", "--cols", "15",
        "--mode", "greedy", "--acq-rounds", "30", "--num-pilot", "10", "--iters", "60",
        "--deep-hidden", "16", "--deep-out", "4"], _InProcess())
    assert out["X_dim"] == 2 + 4 and np.isfinite(out["rec"]["final_rmse"])
    assert out["launches"]["wtw_column"] >= 30
    np.testing.assert_array_equal(out["selected"], out["oracle_future"].get()[0])


def test_sgpr_on_card_matches_f64_oracle(dev):
    """Twin of test_hw_fidelity's SGPR case: the −ELBO and the predictive
    marginals on the card against the dense f64 Titsias reference (200
    points, every third inducing), at the reference test's tolerances."""
    from algp_tpu_torch.models import sparse_gp as sgp

    rng = np.random.default_rng(31)
    x = rng.uniform(0, 12, (200, 2))
    y = rng.standard_normal(200)
    spec = KernelSpec("rbf", ds=2)
    params = spec.init_params(ls_spatial=2.0, outputscale=1.5, noise=0.2, device=dev)
    zidx = np.arange(0, 200, 3)
    K = oracle.gram(x, x, ls_spatial=2.0, outputscale=1.5)
    ref_nelbo, m_ref, v_ref = oracle.sgpr_reference(K, zidx, y, max(0.2**2, 1e-6))
    xd = torch.tensor(x, dtype=torch.float32, device=dev)
    yd = torch.tensor(y, dtype=torch.float32, device=dev)
    got = float(sgp.neg_elbo(spec, params, xd, yd, xd[zidx]))
    np.testing.assert_allclose(got, ref_nelbo, rtol=2e-3)
    post = sgp.posterior_sparse(spec, params, xd, yd, xd[zidx])
    mean, var = sgp.predict_sparse(spec, params, post, xd)
    np.testing.assert_allclose(mean.cpu().numpy(), m_ref, atol=2.5e-2)
    np.testing.assert_allclose(var.cpu().numpy(), v_ref, atol=2.5e-2)


def test_dense_inducing_design_seed_is_finite(dev):
    """Twin of test_hw_fidelity's dense-design case: 220 k-center points
    of a 40 × 40 grid at lengthscale 6 (cond K_zz ≈ 2.5e7) through both
    low-rank seeds and the FITC truth; every output finite on the card."""
    from algp_tpu_torch import acquisition_lowrank as lr
    from algp_tpu_torch.config import FieldConfig
    from algp_tpu_torch.field import FieldEnv

    r, c = np.divmod(np.arange(1600), 40)
    x = torch.tensor(np.stack([c, r], 1), dtype=torch.float32, device=dev)
    spec = KernelSpec("rbf", ds=2)
    params = spec.init_params(ls_spatial=6.0, outputscale=1.0, noise=0.1, device=dev)
    z = x[lr.kcenter_indices(x, 220)]
    seed = lr.lowrank_seed_with_z(spec, params, x, z)
    assert torch.isfinite(seed.VT).all() and torch.isfinite(seed.pdiag).all()
    fac = lr.lowrank_factors_seed(spec, params, x, z)
    assert torch.isfinite(fac.Lzz).all() and torch.isfinite(fac.LB).all()
    env = FieldEnv(FieldConfig(num_rows=40, num_cols=40, true_ls_spatial=6.0,
                               synth_inducing=220, seed=3), spec, device=dev)
    assert np.isfinite(env.f).all()
