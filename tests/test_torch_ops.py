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


@pytest.mark.cuda
def test_mixture_backward_kernel_matches_plain_on_card():
    _need_card()
    x, means, stddevs, logits, g = _backward_inputs(262_144 + 37, 10, seed=3)
    t_in = [torch.from_numpy(a).cuda().requires_grad_(True) for a in (x, means, stddevs, logits)]
    before = TK.mixture_normal_log_prob_backward.launches
    out = TK.mixture_normal_log_prob(*t_in)
    out.backward(torch.from_numpy(g).cuda())
    torch.cuda.synchronize()
    assert TK.mixture_normal_log_prob_backward.launches == before + 1
    ref = TK.mixture_normal_log_prob_backward_plain(
        *[t.detach() for t in t_in], out.detach(), torch.from_numpy(g).cuda()
    )
    for t, r in zip(t_in, ref):
        torch.testing.assert_close(t.grad, r, atol=1e-5, rtol=1e-4, equal_nan=True)


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
        # every weight -inf: the port gives (-inf, 0, 0) and ESS 0 where the
        # Pallas kernel's exp(-inf - -inf) is NaN
        assert m == -np.inf and s1 == 0.0 and s2 == 0.0
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


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no interpret mode)")


@pytest.mark.cuda
def test_mixture_kernel_matches_plain_on_card():
    _need_card()
    inputs = [torch.from_numpy(a).cuda() for a in _mixture_inputs(262_144 + 37, 10)]
    before = TK.mixture_normal_log_prob.launches
    out = TK.mixture_normal_log_prob(*inputs)
    torch.cuda.synchronize()
    assert TK.mixture_normal_log_prob.launches == before + 1
    ref = TK.mixture_normal_log_prob_plain(*inputs)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_log_weight_stats_kernel_matches_plain_on_card():
    _need_card()
    for n, frac in ((1_000_003, 0.01), (1, 0.0), (4096, 1.0)):
        lw = _log_weights(n, seed=n, frac_neg_inf=frac)
        lw_card = torch.from_numpy(lw).cuda()
        m, s1, s2 = (float(v) for v in TK.log_weight_stats(lw_card))
        pm, ps1, ps2 = (float(v) for v in TK.log_weight_stats_plain(lw_card))
        assert m == pm
        np.testing.assert_allclose([s1, s2], [ps1, ps2], rtol=1e-5)
        w = lw.astype(np.float64)
        rm = w.max()
        assert m == rm
        if rm == -np.inf:
            assert (s1, s2) == (0.0, 0.0)
            continue
        e = np.exp(w - rm)
        np.testing.assert_allclose(s1, e.sum(), rtol=1e-5)
        np.testing.assert_allclose(s2, (e * e).sum(), rtol=1e-5)


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


@pytest.mark.cuda
def test_tnorm_kernels_match_plain_on_card():
    _need_card()
    arrays = _tnorm_backward_inputs(262_144 + 37, 10, seed=5)
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
