"""The port's linear-algebra kernels against the JAX package.

Kernel 4 (``chol_inv_tile``, the panel Cholesky's diagonal tile) and
kernels 5/6 (``mvn_quad_logdet``) on the CPU take their plain PyTorch
versions; they are held against the Pallas kernels in interpret mode at
small sizes (P = 8, N = 16), against numpy float64 at the panel width
P = 64, and the panel path against the JAX package's ``chol_panels`` and
numpy.  A numpy mirror of the CUDA kernel of kernels 5/6 (left-looking
panels of 32 columns over ``[K; diffᵀ]``) is held against the plain
version and the Pallas kernel.  The ``cuda``-marked tests hold each CUDA
kernel against its plain version on the card and skip without one.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pyprob_tpu_torch
from pyprob_tpu.ops import blocked_linalg as JB
from pyprob_tpu.ops import mvn_logpdf as JM
from pyprob_tpu.ops import tile_chol as JT
from pyprob_tpu_torch.ops import blocked_linalg as TB
from pyprob_tpu_torch.ops import mvn_logpdf as TM
from pyprob_tpu_torch.ops import tile_chol as TT

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyprob_tpu_torch.set_device("cpu")
    yield


def _spd(B, n, seed, dtype=np.float32):
    """B well-conditioned SPD matrices [B, n, n]."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, n, n))
    return (X @ X.transpose(0, 2, 1) / n + np.eye(n)).astype(dtype)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")


def test_tile_plain_matches_pallas_kernel_at_p8():
    # the Pallas kernel in interpret mode; same column loop, rsqrt on both
    # sides: 1e-6 absolute on entries of magnitude <= 2
    tiles = _spd(5, 8, seed=1)
    # jit: one compile is cheaper than op-by-op interpretation
    jL, jM = jax.jit(lambda t: JT.chol_inv_tile(t, interpret=True))(jnp.asarray(tiles))
    L, M = TT.chol_inv_tile(torch.from_numpy(tiles))
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), atol=1e-6, rtol=0)
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), atol=1e-6, rtol=0)


def test_tile_plain_matches_float64_at_p64():
    # float32 column loop against LAPACK float64: 1e-5 on entries <= ~1.5
    tiles = _spd(3, 64, seed=2, dtype=np.float64)
    L, M = TT.chol_inv_tile(torch.from_numpy(tiles.astype(np.float32)))
    refL = np.linalg.cholesky(tiles)
    np.testing.assert_allclose(L.numpy(), refL, atol=1e-5, rtol=0)
    np.testing.assert_allclose(M.numpy(), np.linalg.inv(refL), atol=1e-5, rtol=0)
    assert (np.triu(L.numpy(), 1) == 0).all() and (np.triu(M.numpy(), 1) == 0).all()
    assert L.shape == M.shape == (3, 64, 64)


def test_tile_plain_nan_from_first_failing_column():
    tiles = _spd(2, 8, seed=3)
    tiles[1, 5, 5] = -4.0  # tile 1 fails at column 5
    L, M = (t.numpy() for t in TT.chol_inv_tile(torch.from_numpy(tiles)))
    assert np.isfinite(L[0]).all() and np.isfinite(M[0]).all()
    lower = np.tril(np.ones((8, 8), bool))
    assert np.isfinite(L[1][:, :5][lower[:, :5]]).all()
    assert np.isnan(L[1][5:, 5:][lower[5:, 5:]]).all()
    assert np.isfinite(M[1][:5][lower[:5]]).all() and np.isnan(M[1][5:][lower[5:]]).all()
    assert (L[1][~lower] == 0).all() and (M[1][~lower] == 0).all()


@pytest.mark.parametrize("n, panel", [(24, 8), (18, 8)])
def test_chol_panels_match_jax_panel_path(n, panel):
    # the JAX package's chol_panels at panel 8, N = 24 and N = 18 (a last
    # panel 2 wide, as at N = 130 with panel 64, whose JAX compile alone
    # takes seconds): strips and tile inverses, 1e-5 on entries <= ~1.5
    # (f32 round-off of two GEMM orders), and L against numpy float64; the
    # tiles are read as views of the trailing matrix and each diagonal
    # block is written into L in place
    a = _spd(2, n, seed=4)
    jstrips, jminvs = jax.jit(lambda a: JB.chol_panels(a, panel=panel))(jnp.asarray(a))
    L, minvs = TB.chol_panels(torch.from_numpy(a), panel=panel)
    assert L.shape == (2, n, n) and (np.triu(L.numpy(), 1) == 0).all()
    strips = [L[..., k0:, k0 : k0 + panel] for k0 in range(0, n, panel)]
    assert [tuple(s.shape) for s in strips] == [s.shape for s in jstrips]
    assert [tuple(m.shape) for m in minvs] == [m.shape for m in jminvs]
    for mine, ref in zip(strips + minvs, list(jstrips) + list(jminvs)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    ref = np.linalg.cholesky(a.astype(np.float64))
    np.testing.assert_allclose(L.numpy(), ref, atol=2e-5, rtol=0)


def test_tile_on_strided_view_equals_contiguous_copy():
    # a tile read in place from a larger matrix (row stride 130, batch
    # stride 130^2, and the 2-D case) gives bit for bit what its copy gives
    a = torch.from_numpy(_spd(3, 130, seed=12))
    view = a[:, 66:130, 66:130]
    assert not view.is_contiguous() and view.stride(-1) == 1
    for tile in (view, view[1]):
        L, M = TT.chol_inv_tile(tile)
        cL, cM = TT.chol_inv_tile(tile.contiguous())
        assert torch.equal(L, cL) and torch.equal(M, cM) and L.shape == tile.shape


def test_tile_into_writes_the_panel_rows_in_place():
    # L into the first P columns of a view of wider rows, zeros in the
    # rest; nothing outside the view is touched; M returned contiguous
    a = torch.from_numpy(_spd(2, 24, seed=13))
    out = torch.full((2, 24, 24), 7.0)
    M = TT.chol_inv_tile_into(a[:, 8:16, 8:16], out[:, 8:16, 8:])
    L, refM = TT.chol_inv_tile(a[:, 8:16, 8:16])
    assert torch.equal(M, refM) and M.is_contiguous()
    assert torch.equal(out[:, 8:16, 8:16], L) and (out[:, 8:16, 16:] == 0).all()
    assert (out[:, :8] == 7).all() and (out[:, 16:] == 7).all() and (out[:, 8:16, :8] == 7).all()


def test_tile_wrappers_reject_bad_views():
    a = torch.from_numpy(_spd(2, 16, seed=14))
    with pytest.raises(ValueError, match="unit stride"):
        TT.chol_inv_tile(a.mT[:, :8, :8])  # rows of stride 16
    with pytest.raises(ValueError, match="unit stride"):
        TT.chol_inv_tile_into(a.mT[:, :8, :8], torch.empty(2, 8, 8))
    with pytest.raises(ValueError, match="unit stride"):
        TT.chol_inv_tile_into(a[:, :8, :8], torch.empty(2, 8, 8).mT)
    for bad in (torch.empty(2, 8, 7), torch.empty(3, 8, 8), torch.empty(2, 7, 8),
                torch.empty(2, 8, 8, dtype=torch.float64), torch.empty(16, 8)):
        with pytest.raises(ValueError, match="l_out"):
            TT.chol_inv_tile_into(a[:, :8, :8], bad)
    with pytest.raises(ValueError, match=r"\[B, P, P\]"):
        TT.chol_inv_tile_into(a[0, :8, :8], torch.empty(8, 8))


@pytest.mark.parametrize("n", [130, 200])
def test_panel_cholesky_matches_float64(n):
    # ragged last panels (130: 64, 64, 2; 200: 64, 64, 64, 8); f32 against
    # float64, 2e-5 on entries <= ~1.5
    a = _spd(2, n, seed=n, dtype=np.float64)
    L = TB.panel_cholesky(torch.from_numpy(a.astype(np.float32)))
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(a), atol=2e-5, rtol=0)
    _, minvs = TB.chol_panels(torch.from_numpy(a.astype(np.float32)))
    assert [m.shape[-1] for m in minvs] == [64, 64] + ([2] if n == 130 else [64, 8])


def test_panel_cholesky_on_transposed_view():
    # a covariance whose rows are strided (a transposed view, as a
    # Fortran-ordered array gives it) factors as its contiguous copy does
    a = torch.from_numpy(_spd(2, 130, seed=15))
    view = a.mT
    assert view.stride(-1) != 1
    assert torch.equal(TB.panel_cholesky(view), TB.panel_cholesky(view.contiguous()))


def test_cholesky_dispatch_on_cpu():
    # on the CPU: the library factor, NaN where not positive definite (as
    # jnp.linalg.cholesky gives it); the solve is solve_triangular
    a = _spd(3, 130, seed=5)
    a[2, 0, 0] = -1.0
    L = TB.cholesky(torch.from_numpy(a))
    jL = np.asarray(jnp.linalg.cholesky(jnp.asarray(a)))
    lower = np.tril(np.ones((130, 130), bool))
    for m in (L[2].numpy(), jL[2]):
        assert np.isnan(m[lower]).all() and (m[~lower] == 0).all()
    np.testing.assert_allclose(L[:2].numpy(), jL[:2], atol=1e-5, rtol=0)
    b = np.random.default_rng(6).normal(size=(2, 130)).astype(np.float32)
    z = TB.tri_solve_lower(L[:2], torch.from_numpy(b))
    ref = np.stack([np.linalg.solve(jL[i].astype(np.float64), b[i]) for i in range(2)])
    np.testing.assert_allclose(z.numpy(), ref, atol=1e-4, rtol=1e-5)


def test_mvn_quad_logdet_plain_matches_pallas_kernels():
    # both Pallas kernels in interpret mode at N = 16 (padded to 128 there):
    # the stacked one for a batch of 2, the single one for one matrix;
    # rtol 1e-5 (quad ~2-16, half_logdet ~4)
    cov = _spd(2, 16, seed=7)
    diff = np.random.default_rng(8).normal(size=(2, 16)).astype(np.float32)
    quad_logdet = jax.jit(lambda c, d: JM.mvn_quad_logdet(c, d, True))
    jq, jld = quad_logdet(jnp.asarray(cov), jnp.asarray(diff))
    q, ld = TM.mvn_quad_logdet(torch.from_numpy(cov), torch.from_numpy(diff))
    assert q.shape == ld.shape == (2,)
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(jq), rtol=1e-5)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld), rtol=1e-5)
    jq1, jld1 = quad_logdet(jnp.asarray(cov[1]), jnp.asarray(diff[1]))
    q1, ld1 = TM.mvn_quad_logdet(torch.from_numpy(cov[1]), torch.from_numpy(diff[1]))
    assert q1.shape == ld1.shape == ()
    np.testing.assert_allclose([float(q1), float(ld1)], [float(jq1), float(jld1)], rtol=1e-5)


def test_mvn_quad_logdet_gradient_matches_jax_vjp():
    # the autograd Function's backward against the JAX custom VJP's _bwd on
    # the same cotangents; float32 solves, 1e-5 + 1e-4 |ref|
    cov = _spd(3, 12, seed=9)
    rng = np.random.default_rng(10)
    diff = rng.normal(size=(3, 12)).astype(np.float32)
    gq, gld = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    jd_cov, jd_diff = jax.jit(JM._bwd, static_argnums=0)(
        False, (jnp.asarray(cov), jnp.asarray(diff)), (jnp.asarray(gq), jnp.asarray(gld))
    )
    c = torch.from_numpy(cov).requires_grad_(True)
    d = torch.from_numpy(diff).requires_grad_(True)
    q, ld = TM.mvn_quad_logdet(c, d)
    torch.autograd.backward((q, ld), (torch.from_numpy(gq), torch.from_numpy(gld)))
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jd_cov), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jd_diff), atol=1e-5, rtol=1e-4)
    # and against autograd through the plain version's Cholesky
    c2 = torch.from_numpy(cov).requires_grad_(True)
    d2 = torch.from_numpy(diff).requires_grad_(True)
    q2, ld2 = TM.mvn_quad_logdet_plain(c2, d2)
    torch.autograd.backward((q2, ld2), (torch.from_numpy(gq), torch.from_numpy(gld)))
    sym = 0.5 * (c2.grad + c2.grad.mT)  # autograd of cholesky gives the symmetric part
    np.testing.assert_allclose(c.grad.numpy(), sym.numpy(), atol=1e-5, rtol=1e-4)


def test_mvn_quad_logdet_nan_where_not_positive_definite():
    cov = _spd(3, 10, seed=11)
    cov[1, 4, 4] = -1.0
    q, ld = TM.mvn_quad_logdet(torch.from_numpy(cov), torch.ones(3, 10))
    assert np.isnan([float(q[1]), float(ld[1])]).all()
    assert torch.isfinite(q[[0, 2]]).all() and torch.isfinite(ld[[0, 2]]).all()


_NB = 32  # the CUDA kernel's panel width (ops/csrc/mvn_quad_logdet.cu)


def _blocked_quad_logdet(cov, diff, nb=_NB):
    """numpy float32 mirror of the CUDA kernel of kernels 5/6: left-looking
    panels of nb columns over the augmented [K; diffᵀ] (only K's lower
    triangle read), the diagonal tile by a column loop with d = 1/√pivot,
    the rows below it, diff's row among them, by forward substitution
    against the tile.  Row N of L ends as z = L⁻¹ diff."""
    B, n, _ = cov.shape
    A = np.concatenate([np.tril(cov), diff[:, None, :]], axis=1).astype(np.float32)
    L = np.zeros_like(A)  # [B, n + 1, n]
    half_logdet = np.zeros(B, np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        for j0 in range(0, n, nb):
            w = min(nb, n - j0)
            P = A[:, j0:, j0 : j0 + w] - L[:, j0:, :j0] @ L[:, j0 : j0 + w, :j0].transpose(0, 2, 1)
            S, T = P[:, :w].copy(), np.zeros((B, w, w), np.float32)
            dinv = np.zeros((B, w), np.float32)
            for j in range(w):
                dinv[:, j] = d = np.float32(1) / np.sqrt(S[:, j, j])
                T[:, j, j] = S[:, j, j] * d
                T[:, j + 1 :, j] = S[:, j + 1 :, j] * d[:, None]
                S[:, j + 1 :, j + 1 :] -= T[:, j + 1 :, j, None] * T[:, None, j + 1 :, j]
            X = P[:, w:].copy()
            for c in range(w):
                X[:, :, c] = (X[:, :, c] - np.einsum("brk,bk->br", X[:, :, :c], T[:, c, :c])) * dinv[:, c, None]
            L[:, j0 : j0 + w, j0 : j0 + w] = T
            L[:, j0 + w :, j0 : j0 + w] = X
            half_logdet += np.log(np.diagonal(T, axis1=1, axis2=2)).sum(-1)
    z = L[:, n]
    return (z * z).sum(-1), half_logdet


_pallas_stacked = jax.jit(
    lambda c, d: JM._quad_logdet_stacked(*JM._pad_cov_diff(c, d), interpret=True, particles_per_cell=2)
)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 200])
def test_blocked_quad_logdet_matches_plain_and_pallas(n):
    # ragged panels (31, 33, 200 = 6 x 32 + 8) and N = 1; f32 against the
    # library route, and for N <= 64 against the Pallas kernel in interpret
    # mode (padded to 128 there): rtol 1e-5, atol 1e-5
    cov = _spd(2, n, seed=20 + n)
    diff = np.random.default_rng(n).normal(size=(2, n)).astype(np.float32)
    q, ld = _blocked_quad_logdet(cov, diff)
    pq, pld = TM.mvn_quad_logdet_plain(torch.from_numpy(cov), torch.from_numpy(diff))
    np.testing.assert_allclose(q, pq.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld, pld.numpy(), rtol=1e-5, atol=1e-5)
    if n <= 64:
        jq, jld = _pallas_stacked(jnp.asarray(cov), jnp.asarray(diff))
        np.testing.assert_allclose(q, np.asarray(jq), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ld, np.asarray(jld), rtol=1e-5, atol=1e-5)


def _indefinite_at(cov, b, col):
    """Make matrix b of ``cov`` (in place) fail first at column ``col``:
    that column's pivot becomes −1, the columns before keep theirs."""
    L = np.linalg.cholesky(cov[b].astype(np.float64))
    cov[b, col, col] -= L[col, col] ** 2 + 1.0


@pytest.mark.parametrize("col", [0, _NB - 1, _NB, 197])
def test_blocked_quad_logdet_nan_from_failing_column(col):
    # N = 200: the first column, the last and first of a panel, and a
    # column of the ragged last panel (192-199); NaN in both outputs of
    # matrix 1 only, as in the plain version
    cov = _spd(3, 200, seed=30)
    _indefinite_at(cov, 1, col)
    diff = np.random.default_rng(31).normal(size=(3, 200)).astype(np.float32)
    q, ld = _blocked_quad_logdet(cov, diff)
    pq, pld = TM.mvn_quad_logdet(torch.from_numpy(cov), torch.from_numpy(diff))
    for out in (q, ld, pq.numpy(), pld.numpy()):
        assert np.isnan(out[1]) and np.isfinite(out[[0, 2]]).all()
    np.testing.assert_allclose(q[[0, 2]], pq.numpy()[[0, 2]], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld[[0, 2]], pld.numpy()[[0, 2]], rtol=1e-5, atol=1e-5)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        TT.chol_inv_tile(torch.eye(65))
    with pytest.raises(TypeError):
        TT.chol_inv_tile(torch.eye(8, dtype=torch.float64))
    with pytest.raises(ValueError):
        TT.chol_inv_tile(torch.eye(8).t()[:, :4])
    with pytest.raises(ValueError):
        TM.mvn_quad_logdet(torch.eye(4).expand(2, 4, 4).contiguous(), torch.zeros(3, 4))
    with pytest.raises(ValueError):
        TM.mvn_quad_logdet(torch.zeros(2, 4, 3), torch.zeros(2, 4))


@pytest.mark.cuda
def test_tile_kernel_matches_plain_on_card():
    _need_card()
    for B, P in ((8192 + 3, 64), (37, 8), (5, 1)):
        tiles = torch.from_numpy(_spd(B, P, seed=P)).cuda()
        tiles[3, P // 2, P // 2] = -1.0  # one tile that is not SPD
        before = TT.chol_inv_tile.launches
        L, M = TT.chol_inv_tile(tiles)
        torch.cuda.synchronize()
        assert TT.chol_inv_tile.launches == before + 1
        pL, pM = TT.chol_inv_tile_plain(tiles)
        for mine, ref in ((L, pL), (M, pM)):
            assert torch.equal(torch.isnan(mine), torch.isnan(ref))
            torch.testing.assert_close(mine, ref, atol=1e-5, rtol=1e-5, equal_nan=True)
    # the panel loop's entry: tiles read in place from matrices of odd row
    # width (N = 130: row strides 130 and 66, a last panel of 2; N = 200: a
    # last panel of 8; N = 161: one of 33, a 64-wide tile's kernel only part
    # filled), L written into the rows of a wider matrix with zeros past the
    # diagonal block, one tile indefinite
    for n, k0, P in ((130, 0, 64), (130, 64, 64), (130, 128, 2), (200, 192, 8), (161, 128, 33)):
        a = torch.from_numpy(_spd(257, n, seed=n + k0)).cuda()
        tiles = a[:, k0 : k0 + P, k0 : k0 + P]
        tiles[3, P // 2, P // 2] = -1.0
        out = torch.full_like(a, 7.0)
        before = TT.chol_inv_tile.launches
        M = TT.chol_inv_tile_into(tiles, out[:, k0 : k0 + P, k0:])
        torch.cuda.synchronize()
        assert TT.chol_inv_tile.launches == before + 1
        pL, pM = TT.chol_inv_tile_plain(tiles)
        for mine, ref in ((out[:, k0 : k0 + P, k0 : k0 + P], pL), (M, pM)):
            assert torch.equal(torch.isnan(mine), torch.isnan(ref))
            torch.testing.assert_close(mine, ref, atol=1e-5, rtol=1e-5, equal_nan=True)
        assert (out[:, k0 : k0 + P, k0 + P :] == 0).all()
        assert (out[:, k0 : k0 + P, :k0] == 7).all() and (out[:, k0 + P :] == 7).all()
        assert (out[:, :k0] == 7).all()
    # the panel path on a covariance whose rows are strided (a transposed
    # view): as on its contiguous copy
    a = torch.from_numpy(_spd(9, 130, seed=16)).cuda()
    assert torch.equal(TB.panel_cholesky(a.mT), TB.panel_cholesky(a.mT.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 64, 65, 200, 256, 512])
def test_mvn_kernel_matches_plain_on_card(n):
    # unbatched, B = 3 (the 512-thread launch) and B = 257 (the 256-thread
    # one: more matrices than blocks at N = 512); in the batches matrices
    # fail first at column 0, 31, 32 and in the last panel (B = 3: the last
    # column), each must give NaN in both outputs, equal to the plain version
    _need_card()
    rng = np.random.default_rng(n)
    pool = _spd(4, n, seed=n)  # a few SPD matrices, scaled and shifted per particle
    for B in (None, 3, 257):
        count = B or 1
        scale = rng.uniform(0.5, 2.0, size=(count, 1, 1))
        cov = (pool[np.arange(count) % 4] * scale + rng.uniform(0, 1, (count, 1, 1)) * np.eye(n)).astype(np.float32)
        diff = rng.normal(size=(count, n)).astype(np.float32)
        cols = [] if B is None else [n - 1] if B == 3 else sorted({c for c in (0, _NB - 1, _NB, n - 3) if 0 <= c < n})
        for b, col in enumerate(cols, start=1):
            _indefinite_at(cov, b, col)
        cov, diff = torch.from_numpy(cov).cuda(), torch.from_numpy(diff).cuda()
        if B is None:
            cov, diff = cov[0], diff[0]
        counter = TM._quad_logdet_stacked if B else TM._quad_logdet_single
        before = counter.launches
        q, ld = TM.mvn_quad_logdet(cov, diff)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        pq, pld = TM.mvn_quad_logdet_plain(cov, diff)
        for mine, ref in ((q, pq), (ld, pld)):
            nan = torch.isnan(ref).cpu().numpy().reshape(-1)
            assert list(np.flatnonzero(nan)) == list(range(1, 1 + len(cols)))
            assert torch.equal(torch.isnan(mine), torch.isnan(ref))
            torch.testing.assert_close(mine, ref, atol=1e-3, rtol=1e-4, equal_nan=True)
