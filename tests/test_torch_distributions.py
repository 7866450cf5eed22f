"""The port's distributions against the JAX package's on shared inputs."""

import numpy as np
import pytest
import torch
import jax  # noqa: F401
import jax.numpy as jnp

import pyprob_tpu
import pyprob_tpu_torch
from pyprob_tpu import distributions as JD
from pyprob_tpu_torch import distributions as TD

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyprob_tpu_torch.set_device("cpu")
    pyprob_tpu_torch.seed(0)
    yield


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=tol, rtol=tol)


def test_normal_matches():
    rng = np.random.default_rng(1)
    loc = rng.normal(size=50).astype(np.float32)
    scale = rng.uniform(0.3, 3, 50).astype(np.float32)
    x = rng.normal(size=50).astype(np.float32)
    j = JD.Normal(jnp.asarray(loc), jnp.asarray(scale))
    t = TD.Normal(torch.from_numpy(loc), torch.from_numpy(scale))
    _close(t.log_prob(torch.from_numpy(x)), j.log_prob(jnp.asarray(x)))
    _close(t.log_prob(torch.from_numpy(x), sum=True), j.log_prob(jnp.asarray(x), sum=True), 1e-4)
    _close(t.mean, j.mean)
    _close(t.variance, j.variance)
    _close(t.stddev, j.stddev)
    assert t.address_suffix == j.address_suffix == "Normal"
    assert t.batch_shape == j.batch_shape == (50,)


def test_categorical_matches():
    rng = np.random.default_rng(2)
    probs = rng.uniform(0, 1, (20, 5)).astype(np.float32)
    probs[3, 2] = 0.0
    idx = rng.integers(0, 5, 20)
    j = JD.Categorical(probs=jnp.asarray(probs))
    t = TD.Categorical(probs=torch.from_numpy(probs))
    # a zero probability is clipped at 1e-38 before the log on both sides;
    # 1e-38 is subnormal in float32 and XLA flushes it to zero, so the
    # logit is -inf; the port flushes every probability below float32's
    # smallest normal the same way
    jl, tl = np.asarray(j.logits), t.logits.numpy()
    assert jl[3, 2] == tl[3, 2] == -np.inf
    keep = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(tl), keep)
    _close(tl[keep], jl[keep])
    _close(t.log_prob(torch.from_numpy(idx)), j.log_prob(jnp.asarray(idx)))
    _close(t.mean, j.mean)
    _close(t.variance, j.variance)
    assert t.address_suffix == j.address_suffix == "Categorical(len_probs:5)"
    jl = JD.Categorical(logits=jnp.asarray(probs))
    tl = TD.Categorical(logits=torch.from_numpy(probs))
    _close(tl.logits, jl.logits)


def _mixtures(B, K, seed):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(B, K)).astype(np.float32)
    stds = rng.uniform(0.5, 2, (B, K)).astype(np.float32)
    probs = rng.uniform(0.1, 1, (B, K)).astype(np.float32)
    x = rng.normal(size=B).astype(np.float32)
    j = JD.Mixture(
        [JD.Normal(jnp.asarray(means[:, k]), jnp.asarray(stds[:, k])) for k in range(K)],
        probs=jnp.asarray(probs),
    )
    t = TD.Mixture(
        [TD.Normal(torch.from_numpy(means[:, k]), torch.from_numpy(stds[:, k])) for k in range(K)],
        probs=torch.from_numpy(probs),
    )
    packed = TD.Mixture._from_normal_params(
        torch.from_numpy(means), torch.from_numpy(stds), torch.from_numpy(probs)
    )
    return j, t, packed, x


def test_mixture_matches():
    j, t, packed, x = _mixtures(40, 4, seed=3)
    jlp = j.log_prob(jnp.asarray(x))
    for d in (t, packed):
        _close(d.log_prob(torch.from_numpy(x)), jlp)
        _close(d.mean, j.mean)
        _close(d.variance, j.variance)
        assert d.address_suffix == j.address_suffix
    # a scalar value broadcast over the batch takes the generic path
    _close(t.log_prob(0.5), j.log_prob(jnp.float32(0.5)))


def test_mixture_sampling_matches_its_density():
    # gathered per-row draws: the sample mean and variance of a K-Normal
    # mixture match its moments (draws differ from the JAX package's)
    means = torch.tensor([[-2.0, 1.0, 4.0]]).expand(200_000, 3).contiguous()
    stds = torch.tensor([[0.5, 1.0, 0.3]]).expand(200_000, 3).contiguous()
    probs = torch.tensor([[0.2, 0.5, 0.3]]).expand(200_000, 3).contiguous()
    d = TD.Mixture._from_normal_params(means, stds, probs)
    x = d.sample()
    assert x.shape == (200_000,)
    np.testing.assert_allclose(float(x.mean()), float(d.mean[0]), atol=0.03)
    np.testing.assert_allclose(float(x.var()), float(d.variance[0]), rtol=0.02)


def test_empirical_matches():
    rng = np.random.default_rng(4)
    values = rng.normal(7.0, 1.0, 20_000).astype(np.float32)
    lw = rng.normal(0.0, 2.0, 20_000)
    lw[:7] = -np.inf
    j = JD.Empirical.from_arrays(values, lw)
    t = TD.Empirical.from_arrays(values, lw)
    for name in ("effective_sample_size", "mean", "variance", "stddev"):
        np.testing.assert_allclose(
            float(getattr(t, name)), float(getattr(j, name)), rtol=1e-9
        )
    np.testing.assert_allclose(t.weights, j.weights, rtol=1e-9, atol=0)
    assert t.length == j.length
    given = TD.Empirical.from_arrays(values, lw, effective_sample_size=123.0)
    assert given.effective_sample_size == 123.0
    t.rename("x").add_metadata(op="posterior")
    assert t.name == "x" and t.metadata == [{"op": "posterior"}]
    np.testing.assert_allclose(
        pyprob_tpu_torch.util.effective_sample_size(lw),
        pyprob_tpu.util.effective_sample_size(lw),
        rtol=1e-12,
    )


def test_empirical_list_values_match():
    vals = [1.0, 2.0, 4.0, 8.0]
    lw = [0.1, -0.3, 0.7, -2.0]
    j = JD.Empirical(values=vals, log_weights=lw)
    t = TD.Empirical(values=vals, log_weights=lw)
    for name in ("effective_sample_size", "mean", "stddev"):
        np.testing.assert_allclose(float(getattr(t, name)), float(getattr(j, name)), rtol=1e-9)


def test_uniform_matches():
    rng = np.random.default_rng(5)
    low = rng.uniform(-3, 0, 30).astype(np.float32)
    high = (low + rng.uniform(0.5, 4, 30)).astype(np.float32)
    x = rng.uniform(-4, 5, 30).astype(np.float32)
    j = JD.Uniform(jnp.asarray(low), jnp.asarray(high))
    t = TD.Uniform(torch.from_numpy(low), torch.from_numpy(high))
    jlp, tlp = np.asarray(j.log_prob(jnp.asarray(x))), t.log_prob(torch.from_numpy(x)).numpy()
    assert np.isneginf(jlp).any() and np.isfinite(jlp).any()
    np.testing.assert_array_equal(np.isneginf(tlp), np.isneginf(jlp))
    _close(tlp[np.isfinite(jlp)], jlp[np.isfinite(jlp)])
    u = rng.uniform(0, 1, 30).astype(np.float32)
    _close(t.cdf(torch.from_numpy(x)), j.cdf(jnp.asarray(x)))
    _close(t.icdf(torch.from_numpy(u)), j.icdf(jnp.asarray(u)))
    _close(t.mean, j.mean)
    _close(t.variance, j.variance)
    assert t.address_suffix == j.address_suffix == "Uniform"
    assert t.batch_shape == j.batch_shape == (30,)
    draws = TD.Uniform(-1.0, 3.0).sample(sample_shape=(100_000,))
    assert float(draws.min()) >= -1.0 and float(draws.max()) <= 3.0
    np.testing.assert_allclose(float(draws.mean()), 1.0, atol=0.02)
    np.testing.assert_allclose(float(draws.var()), 16.0 / 12.0, rtol=0.02)


def _truncated(B, seed):
    rng = np.random.default_rng(seed)
    low = rng.uniform(-2, 0, B).astype(np.float32)
    high = (low + rng.uniform(0.5, 3, B)).astype(np.float32)
    # means near the bounds: Φ(β) − Φ(α) far from cancellation, where two
    # erf implementations agree to f32
    loc = (low + rng.uniform(-0.2, 1.2, B) * (high - low)).astype(np.float32)
    scale = rng.uniform(0.3, 3, B).astype(np.float32)
    return loc, scale, low, high


def test_truncated_normal_matches():
    loc, scale, low, high = _truncated(40, seed=6)
    x = np.random.default_rng(7).uniform(-2.5, 3.5, 40).astype(np.float32)
    j = JD.TruncatedNormal(*[jnp.asarray(a) for a in (loc, scale, low, high)])
    t = TD.TruncatedNormal(*[torch.from_numpy(a) for a in (loc, scale, low, high)])
    jlp, tlp = np.asarray(j.log_prob(jnp.asarray(x))), t.log_prob(torch.from_numpy(x)).numpy()
    inside = np.isfinite(jlp)
    assert 0 < inside.sum() < 40
    np.testing.assert_array_equal(np.isfinite(tlp), inside)
    _close(tlp[inside], jlp[inside])
    _close(t.mean, j.mean)
    _close(t.variance, j.variance)
    assert t.address_suffix == j.address_suffix == "TruncatedNormal"
    # inverse-CDF draws stay inside the bounds and match the analytic moments
    d = TD.TruncatedNormal(0.3, 0.8, -0.5, 2.0)
    draws = d.sample(sample_shape=(200_000,))
    assert float(draws.min()) >= -0.5 and float(draws.max()) <= 2.0
    np.testing.assert_allclose(float(draws.mean()), float(d.mean), atol=0.01)
    np.testing.assert_allclose(float(draws.var()), float(d.variance), rtol=0.02)


def test_truncated_mixture_matches():
    B, K = 30, 4
    rng = np.random.default_rng(8)
    low = rng.uniform(-2, 0, B).astype(np.float32)
    high = (low + rng.uniform(0.5, 3, B)).astype(np.float32)
    means = (low[:, None] + rng.uniform(0, 1, (B, K)) * (high - low)[:, None]).astype(np.float32)
    stds = rng.uniform(0.2, 2, (B, K)).astype(np.float32)
    probs = rng.uniform(0.1, 1, (B, K)).astype(np.float32)
    x = (low + rng.uniform(0, 1, B) * (high - low)).astype(np.float32)

    @jax.jit  # one compile is cheaper than op-by-op dispatch
    def jax_moments(means, stds, probs, low, high, x):
        j = JD.Mixture(
            [JD.TruncatedNormal(means[:, k], stds[:, k], low, high) for k in range(K)], probs=probs
        )
        return j.log_prob(x), j.mean, j.variance

    jlp, jmean, jvar = jax_moments(*[jnp.asarray(a) for a in (means, stds, probs, low, high, x)])
    tlow, thigh = torch.from_numpy(low), torch.from_numpy(high)
    generic = TD.Mixture(
        [TD.TruncatedNormal(torch.from_numpy(means[:, k]), torch.from_numpy(stds[:, k]), tlow, thigh)
         for k in range(K)],
        probs=torch.from_numpy(probs),
    )
    packed = TD.Mixture._from_truncated_normal_params(
        torch.from_numpy(means), torch.from_numpy(stds), torch.from_numpy(probs), tlow, thigh
    )
    for d in (generic, packed):
        assert d._stacked_tnorm_params() is not None  # the kernel path
        _close(d.log_prob(torch.from_numpy(x)), jlp)
        _close(d.mean, jmean, 1e-4)
        _close(d.variance, jvar, 1e-4)
        assert d.address_suffix == "Mixture(" + ", ".join(["TruncatedNormal"] * K) + ")"
    # one draw per row, from the row's chosen component, inside its bounds
    rows = 100_000
    wide = TD.Mixture._from_truncated_normal_params(
        torch.tensor([[-0.5, 0.4, 0.9]]).expand(rows, 3).contiguous(),
        torch.tensor([[0.3, 1.0, 0.2]]).expand(rows, 3).contiguous(),
        torch.tensor([[0.2, 0.5, 0.3]]).expand(rows, 3).contiguous(),
        torch.full((rows,), -1.0), torch.full((rows,), 1.0),
    )
    draws = wide.sample()
    assert draws.shape == (rows,) and float(draws.abs().max()) <= 1.0
    np.testing.assert_allclose(float(draws.mean()), float(wide.mean[0]), atol=0.01)
    np.testing.assert_allclose(float(draws.var()), float(wide.variance[0]), rtol=0.03)
