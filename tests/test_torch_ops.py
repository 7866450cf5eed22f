"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; they are
held against the Pallas kernels run in interpret mode (as
tests/test_ops.py runs them) and against the JAX references.  The
``cuda``-marked tests hold each CUDA kernel against its plain version on
the card and skip without one.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
import pyprob_tpu  # noqa: F401
import pyprob_tpu_torch
from pyprob_tpu.ops import kernels as JK
from pyprob_tpu_torch.ops import kernels as TK

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyprob_tpu_torch.set_device("cpu")
    pyprob_tpu_torch.seed(0)
    yield


@pytest.fixture
def pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    JK.set_use_pallas(True)
    with pltpu.force_tpu_interpret_mode():
        yield
    JK.set_use_pallas(None)


def _mixture_inputs(B, K, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, (B,)).astype(np.float32)
    means = rng.uniform(-2, 2, (B, K)).astype(np.float32)
    stddevs = rng.uniform(0.5, 2, (B, K)).astype(np.float32)
    raw = rng.uniform(-1, 1, (B, K))
    logits = (raw - np.log(np.exp(raw).sum(1, keepdims=True))).astype(np.float32)
    return x, means, stddevs, logits


@pytest.mark.parametrize("B,K", [(200, 10), (37, 10), (64, 1)])
def test_mixture_plain_matches_pallas_kernel(pallas_interpret, B, K):
    inputs = _mixture_inputs(B, K, seed=B + K)
    jax_in = [jnp.asarray(a) for a in inputs]
    # jit: one compile per shape is cheaper than op-by-op interpretation
    jax_out = np.asarray(jax.jit(JK.mixture_normal_log_prob)(*jax_in))
    jax_ref = np.asarray(jax.jit(JK._mixture_normal_ref)(*jax_in))
    out = TK.mixture_normal_log_prob(*[torch.from_numpy(a) for a in inputs])
    assert out.shape == (B,)
    np.testing.assert_allclose(out.numpy(), jax_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), jax_ref, atol=1e-5, rtol=0)


def test_mixture_wrapper_rejects_bad_inputs():
    x, means, stddevs, logits = [torch.from_numpy(a) for a in _mixture_inputs(8, 3)]
    with pytest.raises(TypeError):
        TK.mixture_normal_log_prob(x.double(), means, stddevs, logits)
    with pytest.raises(ValueError):
        TK.mixture_normal_log_prob(x[:7], means, stddevs, logits)
    with pytest.raises(ValueError):
        TK.mixture_normal_log_prob(x, means.t().contiguous().t(), stddevs, logits)


def _backward_inputs(B, K, seed):
    """Mixture inputs with one -inf logit in rows 1-3, every logit -inf in
    row 5 (a degenerate row), and a cotangent per row."""
    x, means, stddevs, logits = _mixture_inputs(B, K, seed=seed)
    logits[1:4, 0] = -np.inf
    logits[5, :] = -np.inf
    g = np.random.default_rng(seed + 1).normal(size=B).astype(np.float32)
    return x, means, stddevs, logits, g


def test_mixture_backward_plain_matches_autograd_and_jax_vjp():
    x, means, stddevs, logits, g = _backward_inputs(64, 5, seed=11)
    t_in = [torch.from_numpy(a).requires_grad_(True) for a in (x, means, stddevs, logits)]
    out = TK.mixture_normal_log_prob(*t_in)  # CPU: the plain version, under autograd
    out.backward(torch.from_numpy(g))
    autograd = [t.grad.numpy() for t in t_in]
    closed = TK.mixture_normal_log_prob_backward(
        *[t.detach() for t in t_in], out.detach(), torch.from_numpy(g)
    )
    jout, vjp = jax.vjp(JK._mixture_normal_ref, *[jnp.asarray(a) for a in (x, means, stddevs, logits)])
    jax_grads = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    for mine, ref, jref in zip(closed, autograd, jax_grads):
        np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mine.numpy(), np.asarray(jref), rtol=1e-5, atol=1e-6)
    dx, dmeans, dstddevs, dlogits = (c.numpy() for c in closed)
    # a -inf logit in a finite row takes no gradient; the degenerate row is
    # NaN throughout, as PyTorch's and JAX's logsumexp backward give
    assert (dlogits[1:4, 0] == 0).all() and (dmeans[1:4, 0] == 0).all()
    assert np.isnan(dlogits[5]).all() and np.isnan(dx[5])
    assert np.isfinite(np.delete(dx, 5)).all()
    # dx only when asked for
    assert TK.mixture_normal_log_prob_backward(
        *[t.detach() for t in t_in], out.detach(), torch.from_numpy(g), need_x=False
    )[0] is None


# the rows a training step launches the backwards at, a ragged block, a
# serving chunk plus a ragged tail; K from one lane a row to two
# components a lane
CARD_ROWS, CARD_COMPONENTS = (256, 512, 1000, 262_144 + 37), (1, 10, 17, 40)


def _assert_grads_close(got, ref):
    """Each gradient within 1e-5 + 1e-4 |ref|, NaN exactly where the
    reference is NaN."""
    for mine, r in zip(got, ref):
        torch.testing.assert_close(mine, r, atol=1e-5, rtol=1e-4, equal_nan=True)


@pytest.mark.cuda
def test_mixture_backward_kernel_matches_plain_on_card():
    _need_card()
    for B in CARD_ROWS:
        for K in CARD_COMPONENTS:
            x, means, stddevs, logits, g = _backward_inputs(B, K, seed=3)
            g_card = torch.from_numpy(g).cuda()
            t_in = [torch.from_numpy(a).cuda().requires_grad_(True) for a in (x, means, stddevs, logits)]
            before = TK.mixture_normal_log_prob_backward.launches
            out = TK.mixture_normal_log_prob(*t_in)
            out.backward(g_card)
            torch.cuda.synchronize()
            assert TK.mixture_normal_log_prob_backward.launches == before + 1
            detached = [t.detach() for t in t_in] + [out.detach(), g_card]
            ref = TK.mixture_normal_log_prob_backward_plain(*detached)
            _assert_grads_close([t.grad for t in t_in], ref)
            # the degenerate row is NaN; a -inf logit in a finite row takes 0
            assert torch.isnan(t_in[0].grad[5])
            if K > 1:
                assert not t_in[3].grad[1:4, 0].any() and not t_in[1].grad[1:4, 0].any()
            for need_x in (True, False):
                got = TK.mixture_normal_log_prob_backward(*detached, need_x=need_x)
                assert (got[0] is None) == (not need_x)
                _assert_grads_close(got[int(not need_x):], ref[int(not need_x):])


def _log_weights(n, seed, frac_neg_inf):
    rng = np.random.default_rng(seed)
    lw = rng.uniform(-10, 2, (n,)).astype(np.float32)
    lw[rng.random(n) < frac_neg_inf] = -np.inf
    return lw


@pytest.mark.parametrize("n,frac", [(5000, 0.1), (1, 0.0), (3000, 1.0)])
def test_log_weight_stats_plain_matches_pallas_kernel(pallas_interpret, n, frac):
    lw = _log_weights(n, seed=n, frac_neg_inf=frac)
    jm, js1, js2 = (float(v) for v in jax.jit(JK.log_weight_stats)(jnp.asarray(lw)))
    m, s1, s2 = (float(v) for v in TK.log_weight_stats(torch.from_numpy(lw)))
    assert m == jm
    if frac == 1.0:
        # every weight -inf: (-inf, NaN, NaN), the Pallas kernel's
        # exp(-inf - -inf), NaN for NaN; ESS 0 on both sides
        assert m == -np.inf and np.isnan([s1, s2, js1, js2]).all()
        assert pyprob_tpu_torch.util.effective_sample_size(lw) == 0.0
        assert pyprob_tpu.util.effective_sample_size(lw) == 0.0
    else:
        np.testing.assert_allclose(s1, js1, rtol=1e-5)
        np.testing.assert_allclose(s2, js2, rtol=1e-5)
        np.testing.assert_allclose(
            s1 * s1 / s2, pyprob_tpu.util.effective_sample_size(lw), rtol=1e-5
        )


def test_log_weight_stats_rejects_bad_inputs():
    with pytest.raises(TypeError):
        TK.log_weight_stats(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        TK.log_weight_stats(torch.zeros(2, 2))
    with pytest.raises(ValueError):
        TK.log_weight_stats(torch.zeros(0))


# log_weight_stats.cu's launch: threads a block (the one block of a small
# N), float4 loads a thread a tile, triples a lane in the last block's
# merge, and the scratch's blocks on an H100 (2 an SM of 132)
STATS_THREADS, STATS_SMALL_THREADS, STATS_VEC = 512, 128, 4
STATS_MERGE_PER_LANE, STATS_CAPACITY = 9, 2 * 132


def _special_stats_vectors():
    """The special inputs of the statistics, by name, from ``chip_smoke``'s
    table: a NaN among finite weights, alone and among 20,000 -inf ones
    (three blocks on the card); +inf alone and among 20,000 finite ones;
    every weight -inf."""
    return {name: lw for name, (lw, _) in chip_smoke.special_stats_vectors().items()}


def _tree_sum32(a):
    """__shfl_down_sync sum tree over a last axis of 32 lanes: lane 0's sum
    (at offset o, lane l < o adds lane l + o)."""
    a = a.copy()
    for off in (16, 8, 4, 2, 1):
        a[..., :off] = a[..., :off] + a[..., off : 2 * off]
    return a[..., 0]


def _stats_result(m, s1, s2):
    """The kernel's ``write_result``: the sums NaN where m is not finite
    (NaN, +inf, or -inf where every weight is -inf)."""
    if not np.isfinite(m):
        s1 = s2 = np.float32(np.nan)
    return m, s1, s2


def _warp_merge_mirror(m, s1, s2):
    """The kernel's ``warp_merge``: [P, 32] triples, P a lane, into the
    warp's (M, a1, a2): M the max of every m (NaN propagated); where it is
    finite, lane l folds its triples k = 0, 1, ... in order, r = exp(m − M),
    a1 = fma(s1, r, a1), a2 = fma(s2, r·r, a2); then the lanes' trees."""
    M = m.max()
    a1 = np.zeros(32, np.float32)
    a2 = np.zeros(32, np.float32)
    if np.isfinite(M):
        for k in range(m.shape[0]):
            r = np.exp(m[k] - M)
            a1, a2 = _fma32(s1[k], r, a1), _fma32(s2[k], r * r, a2)
    return M, _tree_sum32(a1), _tree_sum32(a2)


def _lanes(values, fill, per_lane=1):
    """``values`` on lanes: [per_lane, 32], value i on lane i mod 32 of row
    i // 32, ``fill`` past them."""
    out = np.full(32 * per_lane, fill, np.float32)
    out[: len(values)] = values
    return out.reshape(per_lane, 32)


def _stats_mirror(lw, align=0, capacity=STATS_CAPACITY):
    """``log_weight_stats.cu`` in numpy, in float32, for [N] weights whose
    first lies ``align`` floats past a 16-byte boundary.  The float4 body
    starts at the first boundary; the head before it and the tail past it
    go to threads 0, 1, ... of block 0 with its first tile.  A body of at
    most STATS_SMALL_THREADS x STATS_VEC float4 is one block of
    STATS_SMALL_THREADS threads; else the grid is one block of
    STATS_THREADS a tile of STATS_THREADS x STATS_VEC float4, at most
    ``capacity``, a block striding over the tiles past that.  A block's
    tile of T threads: thread t loads float4 i = tile·4T + k·T + t; each
    warp's max of its weights (NaN propagated) joins the warp's running
    max m; where that is finite, each thread rescales its sums by
    r = exp(m_old − m) (s2 by r·r), then adds its weights in order (its
    head or tail weight, then float4 by float4): e = exp(w − m), s1 + e,
    fma(e, e, s2).  Each warp's sums are a shuffle-down tree, and warp 0
    merges the warps' triples (``_warp_merge_mirror``, one a lane).  A
    grid of one block writes its result; else the last block's warp 0
    merges the blocks' triples, lane l taking blocks l, l + 32, ...
    (STATS_MERGE_PER_LANE at most).  Returns (m, s1, s2) as float32
    scalars."""
    lw = np.asarray(lw, np.float32)
    n = lw.size
    head = min((4 - align) % 4, n)
    nv = (n - head) // 4
    body = lw[head : head + 4 * nv].reshape(nv, 4)
    extras = n - 4 * nv
    threads = STATS_SMALL_THREADS if nv <= STATS_SMALL_THREADS * STATS_VEC else STATS_THREADS
    tile_len = threads * STATS_VEC
    tiles = -(-nv // tile_len)
    grid = max(1, min(tiles, capacity, 32 * STATS_MERGE_PER_LANE))
    t = np.arange(threads)
    warp = t // 32
    triples = []
    for block in range(grid):
        m = np.full(threads // 32, -np.inf, np.float32)  # a warp's running max
        s1 = np.zeros(threads, np.float32)
        s2 = np.zeros(threads, np.float32)
        tile = block
        while True:
            vals = np.full((threads, 1 + 4 * STATS_VEC), -np.inf, np.float32)
            if tile == 0:
                mine = t < extras
                vals[mine, 0] = lw[np.where(t < head, t, 4 * nv + t)[mine]]
            for k in range(STATS_VEC):
                i = tile * tile_len + k * threads + t
                vals[i < nv, 1 + 4 * k : 5 + 4 * k] = body[i[i < nv]]
            mt = np.maximum(m, vals.reshape(m.size, -1).max(axis=1))
            live = np.isfinite(mt)[warp]
            with np.errstate(invalid="ignore"):
                r = np.exp(m - mt)[warp]
                s1, s2 = np.where(live, s1 * r, s1), np.where(live, s2 * (r * r), s2)
                for j in range(vals.shape[1]):
                    e = np.exp(vals[:, j] - mt[warp])
                    s1, s2 = np.where(live, s1 + e, s1), np.where(live, _fma32(e, e, s2), s2)
            m = mt
            tile += grid
            if tile >= tiles:
                break
        w1, w2 = _tree_sum32(s1.reshape(-1, 32)), _tree_sum32(s2.reshape(-1, 32))
        triples.append(_warp_merge_mirror(_lanes(m, -np.inf), _lanes(w1, 0.0), _lanes(w2, 0.0)))
    if grid == 1:
        return _stats_result(*triples[0])
    bm, b1, b2 = zip(*triples)
    P = STATS_MERGE_PER_LANE
    return _stats_result(*_warp_merge_mirror(_lanes(bm, -np.inf, P), _lanes(b1, 0.0, P), _lanes(b2, 0.0, P)))


def _parent_stats_mirror(lw):
    """The parent's two-launch kernel for a few weights (N <= 2,048, one
    block of 256 threads, thread i taking weight i): an online step a
    weight (where w > m rescale, else add exp(w − m) unless w is -inf) and
    a merge that returns the other triple where one's max is -inf and
    takes fmaxf of the maxes, in its shuffle-down trees; the second launch
    merges the one triple with the same trees."""
    f = np.float32
    empty = (f(-np.inf), f(0), f(0))

    def merge(a, b):
        if a[0] == -np.inf:
            return b
        if b[0] == -np.inf:
            return a
        m = np.fmax(a[0], b[0])
        ra, rb = np.exp(a[0] - m), np.exp(b[0] - m)
        return m, a[1] * ra + b[1] * rb, a[2] * ra * ra + b[2] * rb * rb

    def warp_tree(v):
        for off in (16, 8, 4, 2, 1):  # lanes past 31 - off read their own
            v = [merge(v[i], v[i + off] if i + off < 32 else v[i]) for i in range(32)]
        return v[0]

    def block_merge(v):
        warps = [warp_tree(v[w : w + 32]) for w in range(0, 256, 32)]
        return warp_tree(warps + [empty] * 24)

    threads = []
    for i in range(256):
        m, s1, s2 = empty
        if i < len(lw):
            w = f(lw[i])
            if w > m:
                r = np.exp(m - w)
                m, s1, s2 = w, s1 * r + f(1), s2 * r * r + f(1)
            elif w != -np.inf:
                e = np.exp(w - m)
                s1, s2 = s1 + e, s2 + e * e
        threads.append((m, s1, s2))
    return block_merge([block_merge(threads)] + [empty] * 255)


def _same_stats(got, want):
    """Equal max (NaN for NaN); sums NaN where want's are, else within
    rtol 1e-5."""
    (m, s1, s2), (wm, ws1, ws2) = got, want
    if not (m == wm or (np.isnan(m) and np.isnan(wm))):
        return False
    for a, b in ((s1, ws1), (s2, ws2)):
        if np.isnan(b) != np.isnan(a) or (not np.isnan(b) and abs(a - b) > 1e-5 * abs(b)):
            return False
    return True


_JAX_STATS_REF = jax.jit(JK._log_weight_stats_ref)


@pytest.mark.parametrize("name", list(_special_stats_vectors()))
def test_log_weight_stats_mirror_special_values(pallas_interpret, name):
    """The CUDA kernel's reduction, mirrored in numpy, on the special
    inputs against ``_log_weight_stats_ref``, the Pallas kernel in
    interpret mode and the plain version: NaN max and sums for any NaN,
    (+inf, NaN, NaN) for any +inf, and (-inf, NaN, NaN) for every weight
    -inf (the reference's exp(-inf - -inf))."""
    lw = _special_stats_vectors()[name]
    with np.errstate(invalid="ignore", over="ignore"):
        got = _stats_mirror(lw)
        unaligned = _stats_mirror(lw, align=1, capacity=2)
    plain = tuple(float(v) for v in TK.log_weight_stats(torch.from_numpy(lw)))
    ref = tuple(float(v) for v in _JAX_STATS_REF(jnp.asarray(lw)))
    pallas = tuple(float(v) for v in jax.jit(JK.log_weight_stats)(jnp.asarray(lw)))
    for want in (ref, pallas, plain):
        assert _same_stats(got, want) and _same_stats(unaligned, want)
    if name == "all_neg_inf":
        assert got[0] == -np.inf and np.isnan(got[1]) and np.isnan(got[2])
    elif "nan" in name:
        assert np.isnan(got).all()
    else:
        assert got[0] == np.inf and np.isnan(got[1]) and np.isnan(got[2])


@pytest.mark.parametrize(
    "n,align,capacity",
    [(1, 0, STATS_CAPACITY), (31, 0, STATS_CAPACITY), (31, 1, STATS_CAPACITY),
     (256, 0, STATS_CAPACITY), (512, 1, STATS_CAPACITY), (2048, 0, STATS_CAPACITY),
     (2048, 1, STATS_CAPACITY), (2054, 0, STATS_CAPACITY), (2054, 1, STATS_CAPACITY),
     (4097, 0, STATS_CAPACITY), (4097, 3, STATS_CAPACITY), (65_539, 0, STATS_CAPACITY),
     (65_539, 1, 3)],
)
def test_log_weight_stats_mirror_finite(pallas_interpret, n, align, capacity):
    """The mirror on random finite weights, at a pointer ``align`` floats
    past a 16-byte boundary and with ``capacity`` blocks (3: blocks fold
    several tiles): m exact and s1, s2 within rtol 1e-5 of float64, of
    ``_log_weight_stats_ref``, of the Pallas kernel in interpret mode and
    of the plain version."""
    lw = _log_weights(n, seed=n + align, frac_neg_inf=0.0)
    m, s1, s2 = _stats_mirror(lw, align, capacity)
    w = lw.astype(np.float64)
    e = np.exp(w - w.max())
    refs = [
        (w.max(), e.sum(), (e * e).sum()),
        tuple(float(v) for v in _JAX_STATS_REF(jnp.asarray(lw))),
        tuple(float(v) for v in jax.jit(JK.log_weight_stats)(jnp.asarray(lw))),
        tuple(float(v) for v in TK.log_weight_stats(torch.from_numpy(lw))),
    ]
    for rm, rs1, rs2 in refs:
        assert m == rm
        np.testing.assert_allclose([s1, s2], [rs1, rs2], rtol=1e-5)


@pytest.mark.parametrize("name", ["zero_nan", "nan", "posinf", "nan_among_neg_inf"])
def test_log_weight_stats_parent_merge_differs(name):
    """A mirror of the parent kernel's merge (an early return where a max
    is -inf, fmaxf of the maxes) differs from ``_log_weight_stats_ref`` on
    these inputs, which the new reduction's mirror matches: [0, NaN] gave
    (0, 1, 1), [NaN] (-inf, 0, 0), [+inf] (+inf, 1, 1) and a NaN among
    -inf weights (-inf, 0, 0)."""
    lw = _special_stats_vectors()[name]
    ref = tuple(float(v) for v in _JAX_STATS_REF(jnp.asarray(lw)))
    with np.errstate(invalid="ignore", over="ignore"):
        if lw.size <= 2048:
            parent = _parent_stats_mirror(lw)
        else:  # the weights in one thread's reach: only the NaN and a -inf
            parent = _parent_stats_mirror(lw[17_776:17_778])
        new = _stats_mirror(lw)
    assert not _same_stats(parent, ref)
    assert _same_stats(new, ref)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")


@pytest.mark.cuda
def test_mixture_kernel_matches_plain_on_card():
    """Both forwards against their plain versions at every card shape, with
    the special rows of ``_forward_inputs``: NaN, +inf and -inf where the
    plain version has them (two +inf logits give +inf), finite values
    within 1e-5 (kernel 1) and 1e-5 + 1e-5 |ref| (kernel 2)."""
    _need_card()
    for kind, (wrapper, plain, rtol) in FORWARDS.items():
        for B in CARD_ROWS:
            for K in CARD_COMPONENTS:
                inputs = [torch.from_numpy(a).cuda() for a in _forward_inputs(kind, B, K, seed=B + K)]
                before = wrapper.launches
                out = wrapper(*inputs)
                torch.cuda.synchronize()
                assert wrapper.launches == before + 1
                ref = plain(*inputs)
                torch.testing.assert_close(out, ref, atol=1e-5, rtol=rtol, equal_nan=True)
                assert out[0] == np.inf and torch.isnan(out[1]) and torch.isnan(out[7])


def test_log_weight_stats_smoke_check_on_cpu():
    """``chip_smoke.check_stats``, the card's check of kernel 3, run on the
    CPU (the plain version): the special inputs' values against the
    reference's in its table, and every size of ``STATS_SIZES``, aligned
    and as a [1:] view, against float64."""
    assert chip_smoke.check_stats("cpu") <= 1e-5


@pytest.mark.cuda
def test_log_weight_stats_kernel_matches_plain_on_card():
    """Kernel 3 on the card, by ``chip_smoke.check_stats``: on the special
    inputs, the reference's values and the plain version's (NaN for NaN;
    every weight -inf gives (-inf, NaN, NaN)); at every N of
    ``chip_smoke.STATS_SIZES`` (the one 128-thread block at 1-5 and at the
    training phases' 256, 512 and 2,048, the switch to the 512-thread grid
    at 2,054, grids up to 123 blocks and, at 2^22 + 3, blocks striding over
    the tiles), aligned and as a [1:] view, with 1 % of the weights -inf,
    m exact and s1, s2 within rtol 1e-5 of the plain version and of
    float64; two calls bit for bit equal, one launch each, counted by N.
    The same ``check_stats_values`` on uniform weights: 10^6 + 3 with 1 %
    -inf, N = 1, and every weight of 4,096 -inf ((-inf, NaN, NaN))."""
    _need_card()
    assert chip_smoke.check_stats("cuda") <= 1e-5
    for n, frac in ((1_000_003, 0.01), (1, 0.0), (4096, 1.0)):
        lw = _log_weights(n + 1, seed=n, frac_neg_inf=frac)
        lw_card = torch.from_numpy(lw).cuda()
        for what, w, w_card in (("aligned", lw[:n], lw_card[:n]), ("[1:]", lw[1:], lw_card[1:])):
            chip_smoke.check_stats_values(w, w_card, f"N={n}, {frac} -inf ({what})")


def _tnorm_inputs(B, K, seed=0):
    """Truncated-mixture inputs away from the 1e-12 clip: per-row bounds,
    means inside them, stddevs wide enough that Φ(β) − Φ(α) stays large;
    x inside the bounds except in rows 2 and 7."""
    rng = np.random.default_rng(seed)
    low = rng.uniform(-2.0, -0.5, (B,)).astype(np.float32)
    high = (low + rng.uniform(1.0, 3.0, (B,))).astype(np.float32)
    width = (high - low)[:, None]
    means = (low[:, None] + rng.uniform(0, 1, (B, K)) * width).astype(np.float32)
    stddevs = (rng.uniform(0.2, 2.0, (B, K)) * width).astype(np.float32)
    raw = rng.uniform(-1, 1, (B, K))
    logits = (raw - np.log(np.exp(raw).sum(1, keepdims=True))).astype(np.float32)
    x = (low + rng.uniform(0, 1, (B,)) * (high - low)).astype(np.float32)
    x[2], x[min(7, B - 1)] = low[2] - 0.1, high[min(7, B - 1)] + 0.1
    return x, means, stddevs, logits, low, high


@pytest.mark.parametrize("B,K", [(200, 10), (37, 3)])
def test_tnorm_plain_matches_pallas_kernel(pallas_interpret, B, K):
    inputs = _tnorm_inputs(B, K, seed=B + K)
    jax_in = [jnp.asarray(a) for a in inputs]
    jax_out = np.asarray(jax.jit(JK.mixture_truncated_normal_log_prob)(*jax_in))
    jax_ref = np.asarray(jax.jit(JK._mixture_tnorm_ref)(*jax_in))
    out = TK.mixture_truncated_normal_log_prob(*[torch.from_numpy(a) for a in inputs])
    assert out.shape == (B,)
    outside = np.isneginf(jax_ref)
    assert outside[2] and outside[min(7, B - 1)] and outside.sum() == 2
    np.testing.assert_array_equal(np.isneginf(out.detach().numpy()), outside)
    # the Pallas kernel's rational erf is within 1.5e-7 of erf
    np.testing.assert_allclose(out.detach().numpy()[~outside], jax_out[~outside], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.detach().numpy()[~outside], jax_ref[~outside], atol=1e-5, rtol=0)


def _tnorm_backward_inputs(B, K, seed):
    """Truncated-mixture inputs with a -inf logit in rows 1 and 3, every
    logit -inf in row 5, the 1e-12 clip active in rows 4 and 6 (bounds
    far in one tail of every component), and a cotangent that is NaN in
    row 8 and +inf in row 9."""
    x, means, stddevs, logits, low, high = _tnorm_inputs(B, K, seed=seed)
    logits[[1, 3], 0] = -np.inf
    logits[5, :] = -np.inf
    for row in (4, 6):
        means[row] = high[row] + 40.0
        stddevs[row] = 1.0
    g = np.random.default_rng(seed + 1).normal(size=B).astype(np.float32)
    g[8], g[9] = np.nan, np.inf
    return x, means, stddevs, logits, low, high, g


def test_tnorm_backward_plain_matches_jax_vjp_and_autograd():
    x, means, stddevs, logits, low, high, g = _tnorm_backward_inputs(64, 5, seed=13)
    arrays = (x, means, stddevs, logits, low, high)
    t_in = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = TK.mixture_truncated_normal_log_prob(*t_in)
    out.backward(torch.from_numpy(g))
    function_grads = [t.grad.numpy() for t in t_in]
    closed = TK.mixture_truncated_normal_log_prob_backward(
        *[t.detach() for t in t_in], out.detach(), torch.from_numpy(g)
    )

    def jax_forward_backward(*args):
        out, vjp = jax.vjp(JK.mixture_truncated_normal_log_prob_fused, *args[:6])
        return out, vjp(args[6])

    # jit: one compile is cheaper than op-by-op dispatch
    jout, jgrads = jax.jit(jax_forward_backward)(*[jnp.asarray(a) for a in arrays + (g,)])
    jax_grads = [np.asarray(v) for v in jgrads]
    ref_out = np.asarray(jout)
    np.testing.assert_array_equal(np.isneginf(out.detach().numpy()), np.isneginf(ref_out))
    finite = np.isfinite(ref_out)
    assert not finite[5] and finite[4] and finite[6]  # the clip rows stay finite
    np.testing.assert_allclose(out.detach().numpy()[finite], ref_out[finite], rtol=1e-5, atol=1e-5)
    for mine, via_function, ref in zip(closed, function_grads, jax_grads):
        assert np.isfinite(mine.numpy()).all()
        np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(mine.numpy(), via_function)
    dx, dmeans, dstddevs, dlogits, dlow, dhigh = (c.numpy() for c in closed)
    # zeroed: rows outside the bounds, the degenerate row, non-finite g
    for row in (2, 7, 5, 8, 9):
        assert dx[row] == dlow[row] == dhigh[row] == 0 and not dmeans[row].any()
    assert (dlogits[[1, 3], 0] == 0).all() and dmeans[4].any()
    # where the terms are finite and the cotangent is too, the closed form is
    # autograd of the plain forward
    rows = np.isfinite(g) & finite
    plain_in = [torch.from_numpy(a[rows]).requires_grad_(True) for a in arrays]
    logits_ok = np.isfinite(logits[rows]).all(axis=1)
    TK.mixture_truncated_normal_log_prob_plain(*plain_in).backward(torch.from_numpy(g[rows]))
    for mine, t in zip(closed, plain_in):
        got, want = mine.numpy()[rows][logits_ok], t.grad.numpy()[logits_ok]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # dx, dlow and dhigh only when asked for
    lean = TK.mixture_truncated_normal_log_prob_backward(
        *[t.detach() for t in t_in], out.detach(), torch.from_numpy(g), need_x=False, need_bounds=False
    )
    assert lean[0] is None and lean[4] is None and lean[5] is None


def test_tnorm_wrapper_rejects_bad_inputs():
    x, means, stddevs, logits, low, high = [torch.from_numpy(a) for a in _tnorm_inputs(8, 3)]
    with pytest.raises(TypeError):
        TK.mixture_truncated_normal_log_prob(x, means, stddevs, logits, low.double(), high)
    with pytest.raises(ValueError):
        TK.mixture_truncated_normal_log_prob(x, means, stddevs, logits, low[:7], high)
    with pytest.raises(ValueError):
        TK.mixture_truncated_normal_log_prob(x, means, stddevs.t().contiguous().t(), logits, low, high)


def _lane_plan(B, K):
    """The backward kernels' launch on an H100: S = min(K, 32) lanes a
    row, 32 // S rows a warp, threads a block (256 halved while the grid
    covers fewer than the 132 SMs, down to one warp) and blocks."""
    S = min(K, 32)
    lanes = -(-B // (32 // S)) * 32
    threads = 256
    while threads > 32 and -(-lanes // threads) < 132:
        threads //= 2
    return S, threads, -(-lanes // threads)


def _lanes_mirror(B, K, component, n_sums):
    """The backward kernels' index arithmetic in numpy: lane l of warp w
    takes row w·(32 // S) + l // S and, as the row's lane j = l mod S,
    components j, j + S, ...; ``component(rows, ks)`` gives the
    per-component gradients and the lane's terms of the ``n_sums`` per-row
    sums, which each lane adds in its order of components; the row's lanes
    then sum down a tree of shuffles (offsets 16, 8, ..., 1 below S, lane j
    adding lane j + offset while that lane is the row's), and the row's
    lane 0 writes the sum.  Returns the [B, K] gradients and the
    [n_sums, B] sums."""
    S, threads, blocks = _lane_plan(B, K)
    assert threads % 32 == 0
    t = np.arange(blocks * threads)
    warp, lane = t // 32, t % 32  # a block is whole warps
    seg = lane // S
    j = lane - seg * S
    row = warp * (32 // S) + seg
    live = (seg < 32 // S) & (row < B)
    assert np.array_equal(np.unique(row[live]), np.arange(B))
    grads, written = None, np.zeros((B, K), np.int64)
    partial = np.zeros((n_sums, t.size), np.float32)
    for m in range(-(-K // S)):
        k = j + m * S
        act = live & (k < K)
        r, kk = row[act], k[act]
        values, terms = component(r, kk)
        if grads is None:
            grads = [np.zeros((B, K), np.float32) for _ in values]
        for out, v in zip(grads, values):
            out[r, kk] = v
        written[r, kk] += 1
        partial[:, act] = partial[:, act] + np.stack(terms).astype(np.float32)
    assert (written == 1).all()  # every component by exactly one lane
    for offset in (16, 8, 4, 2, 1):
        if offset < S:
            # __shfl_down_sync: lane l reads lane l + offset, or its own
            # value past the warp's end
            source = np.where(lane + offset < 32, t + offset, t)
            other = partial[:, source]
            take = j + offset < S
            assert (row[source][take] == row[take]).all()  # the row's own lanes
            partial = np.where(take, partial + other, partial)
    sums = np.zeros((n_sums, B), np.float32)
    writer = live & (j == 0)
    sums[:, row[writer]] = partial[:, writer]
    return grads, sums


def _mirror_inputs(kind, B, K, seed):
    """Inputs of either backward with the special rows that fit in B rows:
    a -inf logit (row 0 when K > 1), a degenerate row 3 (every logit
    -inf); for the truncated mixture also x outside [low, high] (row 1),
    a NaN and an inf cotangent (rows 2 and 4) and the 1e-12 clip (row 5)."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x, means, stddevs, logits = _mixture_inputs(B, K, seed=seed)
        bounds = ()
    else:
        x, means, stddevs, logits, low, high = _tnorm_inputs(max(B, 8), K, seed=seed)
        x, means, stddevs, logits, low, high = (a[:B].copy() for a in (x, means, stddevs, logits, low, high))
        x[1:2] = high[1:2] + 0.5
        means[5:6], stddevs[5:6] = high[5:6, None] + 40.0, 1.0
        bounds = (low, high)
    if K > 1:
        logits[0, -1] = -np.inf
    logits[3:4] = -np.inf
    g = rng.normal(size=B).astype(np.float32)
    if kind == "tnorm":
        g[2:3], g[4:5] = np.nan, np.inf
    return [torch.from_numpy(a) for a in (x, means, stddevs, logits) + bounds], torch.from_numpy(g)


@pytest.mark.parametrize("kind", ["normal", "tnorm"])
@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("K", [1, 3, 10, 16, 17, 40])
def test_backward_lane_mirror_matches_plain(kind, B, K):
    """The CUDA backwards' lane mapping and shuffle order, mirrored in
    numpy, against the plain closed forms: every gradient within 1e-5 +
    1e-4 |ref|, NaN where the plain version is NaN (the degenerate row of
    the Normal mixture), finite throughout for the truncated one."""
    inputs, g = _mirror_inputs(kind, B, K, seed=B * 100 + K)
    if kind == "normal":
        out = TK.mixture_normal_log_prob_plain(*inputs)
        plain = TK.mixture_normal_log_prob_backward_plain(*inputs, out, g)
        (dmeans, dstddevs, dlogits) = plain[1], plain[2], plain[3]

        def component(r, k):
            # the per-component values as the kernel takes them, from the
            # plain version's own [B, K] arithmetic
            dm = dmeans.numpy()[r, k]
            return (dm, dstddevs.numpy()[r, k], dlogits.numpy()[r, k]), (dm,)

        grads, sums = _lanes_mirror(B, K, component, 1)
        mirror = (-sums[0],) + tuple(grads)
    else:
        out = TK.mixture_truncated_normal_log_prob_plain(*inputs)
        plain = TK.mixture_truncated_normal_log_prob_backward_plain(*inputs, out, g)
        x, means, stddevs, logits, low, high = inputs
        t, xi, alpha, beta, zraw, inside = TK._tnorm_terms(*inputs)
        gz = torch.where(torch.isfinite(g) & inside, g, torch.zeros_like(g))
        r_all = gz[:, None] * torch.exp(t - out[:, None])
        pa = torch.exp(-0.5 * alpha * alpha) * TK._INV_SQRT_2PI
        pb = torch.exp(-0.5 * beta * beta) * TK._INV_SQRT_2PI
        sz = torch.where(zraw >= 1e-12, stddevs * zraw, torch.full_like(zraw, np.inf))
        rs = r_all / stddevs
        dm_all = rs * xi - r_all * (pa - pb) / sz
        ds_all = rs * (xi * xi - 1.0) - r_all * (alpha * pa - beta * pb) / sz
        terms = [a.numpy() for a in (rs * xi, r_all * pa / sz, r_all * pb / sz)]
        elems = [np.where(np.isfinite(a), a, 0).astype(np.float32) for a in (dm_all.numpy(), ds_all.numpy(), r_all.numpy())]

        def component(r, k):
            return tuple(a[r, k] for a in elems), tuple(a[r, k] for a in terms)

        grads, sums = _lanes_mirror(B, K, component, 3)
        finite = [np.where(np.isfinite(a), a, 0).astype(np.float32) for a in (-sums[0], sums[1], -sums[2])]
        mirror = (finite[0],) + tuple(grads) + tuple(finite[1:])
        assert all(np.isfinite(a).all() for a in mirror)
    for mine, ref in zip(mirror, plain):
        ref = ref.numpy()
        np.testing.assert_array_equal(np.isnan(mine), np.isnan(ref))
        ok = ~np.isnan(ref)
        assert (np.abs(mine[ok] - ref[ok]) <= 1e-5 + 1e-4 * np.abs(ref[ok])).all()
    if kind == "normal" and B > 3:
        assert np.isnan(mirror[0][3])  # the degenerate row's dx


@pytest.mark.cuda
def test_tnorm_kernels_match_plain_on_card():
    _need_card()
    for B in CARD_ROWS:
        for K in CARD_COMPONENTS:
            arrays = _tnorm_backward_inputs(B, K, seed=5)
            g = torch.from_numpy(arrays[-1]).cuda()
            t_in = [torch.from_numpy(a).cuda().requires_grad_(True) for a in arrays[:-1]]
            before = (TK.mixture_truncated_normal_log_prob.launches,
                      TK.mixture_truncated_normal_log_prob_backward.launches)
            out = TK.mixture_truncated_normal_log_prob(*t_in)
            out.backward(g)
            torch.cuda.synchronize()
            assert (TK.mixture_truncated_normal_log_prob.launches,
                    TK.mixture_truncated_normal_log_prob_backward.launches) == (before[0] + 1, before[1] + 1)
            plain_in = [t.detach() for t in t_in]
            ref = TK.mixture_truncated_normal_log_prob_plain(*plain_in)
            torch.testing.assert_close(out.detach(), ref, atol=1e-5, rtol=1e-5)
            grads = TK.mixture_truncated_normal_log_prob_backward_plain(*plain_in, ref, g)
            for t, r in zip(t_in, grads):
                torch.testing.assert_close(t.grad, r, atol=1e-5, rtol=1e-4)
            # rows outside the bounds, the degenerate row, non-finite g: 0
            assert not any(t_in[i].grad[[2, 5, 7, 8, 9]].any() for i in (0, 1, 4, 5))
            for need_x in (True, False):
                for need_bounds in (True, False):
                    got = TK.mixture_truncated_normal_log_prob_backward(
                        *plain_in, ref, g, need_x=need_x, need_bounds=need_bounds
                    )
                    asked = (need_x, True, True, True, need_bounds, need_bounds)
                    for mine, r, wanted in zip(got, grads, asked):
                        assert (mine is None) == (not wanted)
                        if wanted:
                            torch.testing.assert_close(mine, r, atol=1e-5, rtol=1e-4)


FORWARDS = {
    "normal": (TK.mixture_normal_log_prob, TK.mixture_normal_log_prob_plain, 0.0),
    "tnorm": (TK.mixture_truncated_normal_log_prob, TK.mixture_truncated_normal_log_prob_plain, 1e-5),
}


def _forward_inputs(kind, B, K, seed):
    """Inputs of either forward (numpy) with the special rows that fit in B
    rows: two +inf logits in row 0 (one at K = 1), a NaN logit in row 1,
    every logit -inf in row 2, a -inf logit in row 3, a NaN logit among
    -inf ones in row 7; for the truncated mixture x inside [low, high] in
    those rows, above high in row 4, NaN in row 5, and the 1e-12 clip in
    row 6."""
    if kind == "normal":
        arrays = list(_mixture_inputs(B, K, seed=seed))
    else:
        arrays = [a[:B].copy() for a in _tnorm_inputs(max(B, 8), K, seed=seed)]
        x, means, stddevs, _, low, high = arrays
        x[:4] = (low[:4] + high[:4]) / 2
        x[7:8] = (low[7:8] + high[7:8]) / 2
        x[4:5] = high[4:5] + 0.5
        x[5:6] = np.nan
        means[6:7], stddevs[6:7] = high[6:7, None] + 40.0, 1.0
    logits = arrays[3]
    logits[:1, :2] = np.inf
    logits[1:2, -1] = np.nan
    logits[2:3] = -np.inf
    logits[3:4, 0] = -np.inf
    logits[7:8] = -np.inf
    logits[7:8, -1] = np.nan
    return arrays


def _fma32(a, b, c):
    """fmaf in numpy: a·b + c for float32 arrays, rounded once to float32
    (the product is exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(np.float32)


def _forward_lanes_mirror(terms, inside=None):
    """The CUDA forwards' lane mapping (``mixture_lanes.cuh``) in numpy, in
    float32: lane l of warp w takes row w·(32 // S) + l // S and, as the
    row's lane j = l mod S, the [B, K] ``terms`` j, j + S, ..., one chunk
    of S components at a time.  For each chunk: the max up to each lane's
    term, a scan up the row's lanes (offsets 1, 2, ..., 16 below S, lane j
    taking lane j − offset while j >= offset, NaN propagated) that starts
    from the row's running max m; the max before the lane's term (lane j −
    1's, or m on lane 0); the lane's exp, exp(q − t) where t > q (sent
    negated), else exp(t − q), 0 for a −inf term; the row's lanes read the
    chunk's exps from its lanes 0, 1, ... in order and fold them into s
    (an fma s·e + 1 where the sign says t > q, else s + e); m becomes the
    last lane's max.  The row's lane 0 writes m + log s, m where m is ±inf
    or NaN, or −inf where ``inside`` is False.  Returns the [B] outputs and
    each row's m."""
    B, K = terms.shape
    S, threads, blocks = _lane_plan(B, K)
    t_ = np.arange(blocks * threads)
    warp, lane = t_ // 32, t_ % 32  # a block is whole warps
    seg = lane // S
    j = lane - seg * S
    row = warp * (32 // S) + seg
    live = (seg < 32 // S) & (row < B)
    assert np.array_equal(np.unique(row[live]), np.arange(B))
    m = np.full(t_.size, -np.inf, np.float32)
    s = np.zeros(t_.size, np.float32)
    for c in range(0, K, S):
        n = min(S, K - c)
        have = live & (c + j < K)
        t = np.where(have, terms[np.where(have, row, 0), np.where(have, c + j, 0)], -np.inf)
        t = t.astype(np.float32)
        v = np.where(j == 0, np.maximum(m, t), t)
        for offset in (1, 2, 4, 8, 16):
            if offset < S:
                # __shfl_up_sync: lane l reads lane l - offset, or its own
                # value below the warp's lane 0
                source = np.where(lane >= offset, t_ - offset, t_)
                take = j >= offset
                assert (row[source][take & live] == row[take & live]).all()
                v = np.where(take, np.maximum(v, v[source]), v)
        q = np.where(j == 0, m, v[np.where(lane >= 1, t_ - 1, t_)])
        up = t > q
        e = np.exp(np.where(up, q - t, t - q))
        e = np.where(t == -np.inf, np.float32(0), e)
        sent = np.where(up, -e, e)
        for i in range(n):
            u = sent[warp * 32 + (lane - j + i) % 32]  # __shfl_sync wraps in the warp
            s = np.where(np.signbit(u), _fma32(s, -u, 1.0), s + u)
        m = v[warp * 32 + (lane - j + n - 1) % 32]
    writer = live & (j == 0)
    value = np.where(np.isfinite(m), m + np.log(s), m)
    if inside is not None:
        value = np.where(inside[np.where(live, row, 0)], value, -np.inf)
    out, row_max = np.zeros(B, np.float32), np.zeros(B, np.float32)
    out[row[writer]], row_max[row[writer]] = value[writer], m[writer]
    return out, row_max


def _forward_rows_mirror(terms, inside=None):
    """The forwards' one-thread-a-row kernels (from ``kThreadRowsFrom``
    rows on) in numpy, in float32: each row folds its terms in order into
    a running max m and s = sum exp(term - m): where t > m, s·exp(m − t) +
    1 (one fma) and m = t; else, unless t is -inf, s + exp(0) where t == m
    (two +inf terms) and s + exp(t − m) otherwise; it writes (m, or 0 where
    m is -inf) + log s, or -inf where ``inside`` is False."""
    B, K = terms.shape
    m = np.full(B, -np.inf, np.float32)
    s = np.zeros(B, np.float32)
    for k in range(K):
        t = terms[:, k]
        up = t > m
        added = s + np.exp(np.where(t == m, np.float32(0), t - m))
        s = np.where(up, _fma32(s, np.exp(m - t), 1.0), np.where(t != -np.inf, added, s))
        m = np.where(up, t, m)
    out = np.where(m == -np.inf, np.float32(0), m) + np.log(s)
    return out if inside is None else np.where(inside, out, -np.inf).astype(np.float32)


_JAX_FORWARDS = {"normal": jax.jit(JK._mixture_normal_ref), "tnorm": jax.jit(JK._mixture_tnorm_ref)}


def _jax_forward(kind, arrays, rows=37, components=40):
    """The JAX reference on ``arrays`` padded to [rows, components], so that
    one compile serves every case: the added components have logit -inf,
    so they add exp(-inf) = 0 to a row's sum and never set its max (their
    terms are NaN only in a row whose x is NaN, which is NaN or outside
    already); the added rows are dropped."""
    B, K = arrays[1].shape
    padded = []
    for a in arrays:
        p = np.full((rows, components) if a.ndim == 2 else (rows,), 1.0, np.float32)
        p[(slice(B), slice(K))[: a.ndim]] = a
        padded.append(p)
    padded[3][:, K:] = -np.inf
    return np.asarray(_JAX_FORWARDS[kind](*[jnp.asarray(a) for a in padded]))[:B]


@pytest.mark.parametrize("mapping", ["lanes", "rows"])
@pytest.mark.parametrize("kind", ["normal", "tnorm"])
@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("K", [1, 3, 10, 16, 17, 40])
def test_forward_lane_mirror_matches_plain(kind, B, K, mapping):
    """The CUDA forwards' two mappings, mirrored in numpy on the plain
    version's own terms (the lanes with their scan and shuffle order; one
    thread a row with its online fold), against the plain version and the
    JAX reference: NaN, +inf and -inf exactly where they have them (two
    +inf logits give +inf; a NaN logit NaN, also among -inf ones), finite
    values within 1e-5 (kernel 1) and 1e-5 + 1e-5 |ref| (kernel 2); the
    max the row's lanes end with is the row's max with NaN propagated; and
    a finite row's output on the lanes is bit for bit that of one thread a
    row."""
    arrays = _forward_inputs(kind, B, K, seed=B * 100 + K)
    inputs = [torch.from_numpy(a) for a in arrays]
    _, plain, rtol = FORWARDS[kind]
    if kind == "normal":
        terms, inside = TK._normal_terms(*inputs), None
    else:
        terms, _, _, _, _, inside = TK._tnorm_terms(*inputs)
        inside = inside.numpy()
    terms = terms.numpy()
    assert terms.dtype == np.float32
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        rows = _forward_rows_mirror(terms, inside)
        if mapping == "lanes":
            out, row_max = _forward_lanes_mirror(terms, inside)
            np.testing.assert_array_equal(row_max, terms.max(axis=1))
            # a finite row comes out of the lanes bit for bit as one thread
            # a row folds it
            finite = np.isfinite(out)
            np.testing.assert_array_equal(out[finite], rows[finite])
        else:
            out = rows
    assert out.dtype == np.float32
    refs = (plain(*inputs).numpy(), _jax_forward(kind, arrays))
    for ref in refs:
        for pattern in (np.isnan, np.isposinf, np.isneginf):
            np.testing.assert_array_equal(pattern(out), pattern(ref))
        finite = np.isfinite(ref)
        assert (np.abs(out[finite] - ref[finite]) <= 1e-5 + rtol * np.abs(ref[finite])).all()
    assert out[0] == np.inf  # two +inf terms: +inf, not exp(inf - inf) = NaN
    if B > 7:
        # a NaN term gives NaN, also among -inf ones
        assert np.isnan(out[1]) and out[2] == -np.inf and np.isnan(out[7])
