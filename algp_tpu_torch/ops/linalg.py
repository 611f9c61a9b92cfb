"""Dense linear algebra for the GP stack (the counterpart of the parts of
algp_tpu.ops.linalg that the main path uses).

Every factorization goes through `torch.linalg.cholesky_ex`: a failed
factor comes back as NaN, as `jnp.linalg.cholesky` returns it, instead of
raising — so no loop reads `info` on the host.  Leading batch dimensions
are supported throughout (the fit's restarts).

Not ported: the panel-blocked solve (`blocked_solve_triangular`, the
reference's workaround for the TPU's memory): the card's memory holds the
episode's whole (cap, N) right-hand side; see ROADMAP.md.

Tracing: a triangular inverse past `TRI_INV_SOLVE_MAX` (the exact MI
seed's) is the profiler region `linalg.tri_inv`, and `TRI_INV_BLOCKED`
counts them, as `sparse_gp.FITS` counts the SGPR fits.
"""

from __future__ import annotations

import torch

from algp_tpu_torch.utils.profiling import annotate

#: Largest n that `tri_inv` inverts by one solve against the identity;
#: past it, the blocked inversion with leaves of `TRI_INV_LEAF` (512 took
#: the least time of 256-512 on an H100 at n = 10 000 and 10 240, PERF.md).
TRI_INV_SOLVE_MAX = 1024
TRI_INV_LEAF = 512

#: Inversions that took the blocked path so far
TRI_INV_BLOCKED = 0


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def cholesky(K: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor of SPD `K` (+ optional fixed jitter·I); NaN
    wherever the factorization failed (per batch element)."""
    if jitter:
        K = K + jitter * _eye_like(K)
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def safe_cholesky(
    K: torch.Tensor,
    initial_jitter: float = 1e-6,
    max_tries: int = 5,
    growth: float = 10.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cholesky with adaptive diagonal jitter.

    Tries the plain factor first; while it is not finite, adds
    `initial_jitter`·mean(diag K), then ×`growth` each further try, up to
    `max_tries` times.  Returns (L, jitter_used).  Each try reads one
    boolean on the host: this is for one-off factors (the field's truth),
    not for loops; `jitter_ladder_cholesky` is the sync-free variant.
    """
    scale = torch.mean(torch.diagonal(K, dim1=-2, dim2=-1))
    eye = _eye_like(K)
    jit = torch.zeros((), dtype=K.dtype, device=K.device)
    L = cholesky(K)
    for i in range(max_tries):
        if bool(torch.isfinite(L).all()):
            break
        jit = scale * initial_jitter if i == 0 else jit * growth
        L = cholesky(K + jit * eye)
    return L, jit


def jitter_ladder_cholesky(
    K: torch.Tensor,
    initial_jitter: float = 1e-6,
    max_tries: int = 5,
    growth: float = 10.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`safe_cholesky` without a host read, for one (n, n) matrix: the
    plain factor, and the whole jitter ladder K + jitterᵢ·I in one batched
    factorization; the first finite try is picked on the device.  Try 0
    is the plain factor bitwise; when every try fails, the last one (NaN)
    is returned, as `safe_cholesky` does.  Returns (L, jitter_used).  It
    costs max_tries extra factorizations on every call, so it is for the
    small per-refit factors (K_zz of the low-rank seeds), not the large
    ones."""
    scale = torch.mean(torch.diagonal(K))
    jits = [scale * initial_jitter]  # f32, grown as safe_cholesky grows it
    for _ in range(max_tries - 1):
        jits.append(jits[-1] * growth)
    jits = torch.stack(jits)
    ladder = cholesky(K + jits[:, None, None] * _eye_like(K))
    tries = torch.cat([cholesky(K)[None], ladder])
    ok = torch.isfinite(tries).flatten(1).all(dim=1)
    pick = torch.where(ok.any(), torch.argmax(ok.to(torch.int32)), max_tries)
    jit = torch.cat([torch.zeros_like(jits[:1]), jits]).index_select(
        0, pick.reshape(1))[0]
    return tries.index_select(0, pick.reshape(1))[0], jit


def solve_triangular(
    L: torch.Tensor, b: torch.Tensor, *, lower: bool = True, trans: bool = False
) -> torch.Tensor:
    """Solve op(L) x = b, op the identity or the transpose.  `b` is a
    vector (one dim fewer than L, batch dims included) or a matrix."""
    vec = b.dim() == L.dim() - 1
    if vec:
        b = b[..., None]
    A = L.mT if trans else L
    x = torch.linalg.solve_triangular(A, b, upper=(lower == trans), left=True)
    return x[..., 0] if vec else x


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve K x = b given the lower Cholesky factor L of K."""
    y = solve_triangular(L, b, lower=True, trans=False)
    return solve_triangular(L, y, lower=True, trans=True)


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log|K| from its lower Cholesky factor."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)


def tri_inv(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular matrix, W = L⁻¹ (exactly zero above
    the diagonal), row-major; only L's lower triangle is read.

    Up to `TRI_INV_SOLVE_MAX` it is one triangular solve against the
    identity.  The solver returns column-major results, so it solves for
    Wᵀ = (Lᵀ)⁻¹ and W is that result's transpose view, row-major with no
    copy (the precision-column kernel reads W by rows).  Past it, that
    solve would spend n³ flops on the identity's zero triangle: the
    blocked inversion (`_tri_inv_blocked`) needs n³/3."""
    n = L.shape[-1]
    if n <= TRI_INV_SOLVE_MAX:
        return torch.linalg.solve_triangular(L.mT, _eye_like(L), upper=True).mT
    global TRI_INV_BLOCKED
    with annotate("linalg.tri_inv"):
        W = torch.empty(L.shape, dtype=L.dtype, device=L.device)
        for Lb, Wb in zip(L.reshape(-1, n, n), W.view(-1, n, n)):
            _tri_inv_blocked(Lb, TRI_INV_LEAF, out=Wb)
            TRI_INV_BLOCKED += 1
    return W


def _tri_inv_blocked(L: torch.Tensor, leaf: int, out: torch.Tensor = None) -> torch.Tensor:
    """W = L⁻¹ for one (n, n) lower-triangular L by bisection, the
    reference's recursion run bottom up: for L = [[A, 0], [B, C]],
    W = [[A⁻¹, 0], [−C⁻¹·(B·A⁻¹), C⁻¹]].

    The diagonal `leaf` blocks are inverted first, by one batched solve
    against the identity (a ragged last leaf identity-padded, which is
    exact; never the reference's Neumann doubling, which overflows in f32
    on c5_long's factors, tests/test_torch_quality_parity.py).  Then each level merges neighbouring
    blocks of size s = leaf·2ˡ into blocks of 2s (`_merge`): the merges
    of a level whose two halves are whole are one batch of strided views
    into L and W, and a ragged last merge is its own.  Both products of a
    merge run over the tiles of their triangular operand (`_tiles`), so
    no product reads a block known to be zero: n³/3 + O(n²·leaf) flops in
    all.  Every product writes through a view of W (zeroed first) or of
    one scratch of at most n²/4 entries, and nothing is read on the host.
    """
    n = L.shape[-1]
    W = L.new_zeros((n, n)) if out is None else out.zero_()
    full, rag = divmod(n, leaf)
    # the leaves: D holds L's diagonal blocks, the ragged one in an identity
    D = torch.eye(leaf, dtype=L.dtype, device=L.device).repeat(full + (rag > 0), 1, 1)
    if full:
        D[:full] = _blocks(L, 0, 0, leaf, full, leaf, leaf)
    if rag:
        D[full, :rag, :rag] = L[full * leaf:, full * leaf:]
    Dinv = torch.linalg.solve_triangular(D.mT, _eye_like(D), upper=True).mT
    if full:
        _blocks(W, 0, 0, leaf, full, leaf, leaf).copy_(Dinv[:full])
    if rag:
        W[full * leaf:, full * leaf:] = Dinv[full, :rag, :rag]
    scratch = L.new_empty((n * n // 4,))
    s = leaf
    while s < n:
        pairs, rest = divmod(n, 2 * s)
        if pairs:
            _merge(L, W, scratch, 0, pairs, s, s, leaf)
        if rest > s:
            _merge(L, W, scratch, n - rest, 1, s, rest - s, leaf)
        s *= 2
    return W


def _blocks(M, r0, c0, step, cnt, rows, cols):
    """The `cnt` (rows, cols) blocks of the 2-D `M` at (r0 + i·step,
    c0 + i·step), as one strided (cnt, rows, cols) view."""
    s0, s1 = M.stride()
    return M.as_strided((cnt, rows, cols), (step * (s0 + s1), s0, s1),
                        M.storage_offset() + r0 * s0 + c0 * s1)


def _merge(L, W, scratch, o, cnt, a, c, leaf):
    """The merges of `cnt` blocks of 2a at o, o + 2a, …: each inverse's
    lower-left block Wb = Wc·X with X = −B·Wa, from its halves' inverses
    Wa (a × a) and Wc (c × c, c ≤ a) already in W.  Each product adds
    one batched GEMM a tile of its triangular operand."""
    def at(M, r, k, rows, cols):
        return _blocks(M, o + r, o + k, 2 * a, cnt, rows, cols)

    X = scratch[:cnt * c * a].view(cnt, c, a).zero_()
    for r0, r1, c0, c1 in _tiles(a, leaf):
        X[..., c0:c1].baddbmm_(at(L, a, r0, c, r1 - r0), at(W, r0, c0, r1 - r0, c1 - c0),
                               alpha=-1.0)
    Wb = at(W, a, 0, c, a)
    for r0, r1, c0, c1 in _tiles(c, leaf):
        Wb[..., r0:r1, :].baddbmm_(at(W, a + r0, a + c0, r1 - r0, c1 - c0), X[..., c0:c1, :])


def _tiles(t: int, leaf: int, o: int = 0) -> tuple:
    """The tiles (r0, r1, c0, c1) of a t × t lower triangle at offset o
    that bisection at `leaf` multiples leaves: the off-diagonal block of
    each split, then those of its halves, down to the diagonal leaves."""
    if t <= leaf:
        return ((o, o + t, o, o + t),)
    h = leaf * (-(-t // leaf) // 2)
    return ((o + h, o + t, o, o + h),) + _tiles(h, leaf, o) + _tiles(t - h, leaf, o + h)


def spd_inverse_from_chol(L: torch.Tensor) -> torch.Tensor:
    """K⁻¹ = L⁻ᵀ L⁻¹ = WᵀW from the lower Cholesky factor, W = `tri_inv(L)`."""
    W = tri_inv(L)
    return W.mT @ W


def spd_inverse(K: torch.Tensor) -> torch.Tensor:
    """Dense SPD inverse via Cholesky and the triangular inverse."""
    return spd_inverse_from_chol(cholesky(K))


def solve_triangular_matmul(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L⁻¹ B for a small lower factor and a huge right-hand side, as one
    matrix product against the explicit inverse (`tri_inv`): the
    reference's conditioning and seed solves past 2²⁰ candidates.  Every
    column of the product is independent of the others, so a chunk of B
    gives the same columns as the whole (up to the library's choice of
    algorithm per shape)."""
    return tri_inv(L) @ B


def chol_append_row(
    L_pad: torch.Tensor, m: int, k_vec: torch.Tensor, k_ss: torch.Tensor
) -> torch.Tensor:
    """Grow an identity-padded Cholesky factor by one point, O(n_max²),
    writing row m of `L_pad` in place (and returning it).

    The leading m×m block of `L_pad` factors K_AA; `k_vec` holds the new
    point's cross-covariances (entries ≥ m must be 0) and `k_ss` its
    self-covariance:  c = L⁻¹ k_vec,  d = sqrt(max(k_ss − cᵀc, 1e-12)).
    Rows/cols ≥ m are identity, so the full-size solve acts as the
    leading-block solve."""
    n_max = L_pad.shape[-1]
    c = solve_triangular(L_pad, k_vec, lower=True)
    idx = torch.arange(n_max, device=L_pad.device)
    c = torch.where(idx < m, c, 0.0)
    d = torch.sqrt(torch.clamp_min(k_ss - torch.dot(c, c), 1e-12))
    L_pad[m] = torch.where(idx == m, d, c)
    return L_pad


def identity_padded_factor(n_max: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """A fresh padded factor: the identity, ready for `chol_append_row`."""
    return torch.eye(n_max, dtype=dtype, device=device)


def pad_factor(L: torch.Tensor, n_max: int) -> torch.Tensor:
    """An m×m factor embedded into the identity-padded n_max×n_max layout."""
    m = L.shape[-1]
    out = torch.eye(n_max, dtype=L.dtype, device=L.device)
    out[:m, :m] = L
    return out
