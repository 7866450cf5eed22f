"""The port's scalar distributions of the positive-support family, Bernoulli,
Binomial, Poisson, Beta and VonMises, and Factor, against the JAX
package's on the same numpy inputs.

``log_prob`` at points inside the support, on its boundary and outside
it, and the moments, within rtol 1e-5 (atol 1e-5 beside it, for values
near 0) in float32; −inf where the JAX package gives −inf.  Samples: the
mean and the variance of 10^5 seeded draws each within 5 standard errors
of the distribution's own (the median for HalfCauchy, whose moments are
infinite; E[cos(x − loc)] for VonMises, an angle).
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pyprob_tpu_torch
from pyprob_tpu import distributions as JD
from pyprob_tpu_torch import distributions as TD

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyprob_tpu_torch.set_device("cpu")
    pyprob_tpu_torch.seed(0)
    yield


# name: (batched parameters, points: in the support, on its boundary, outside)
CASES = {
    "Bernoulli": (dict(probs=[0.2, 0.7, 1e-13, 1.0]), [0.0, 1.0, 0.5, 1.0]),
    "Binomial": (dict(total_count=[10.0, 10.0, 4.0, 4.0], probs=[0.3, 0.6, 0.5, 0.9]), [3.0, 10.0, 0.0, 2.5]),
    "Poisson": (dict(rate=[4.0, 0.5, 2.0, 3.0]), [3.0, 0.0, 2.5, -1.0]),
    "Exponential": (dict(rate=[1.5, 0.5, 2.0, 3.0]), [0.7, 0.0, 4.0, -0.1]),
    "Gamma": (dict(concentration=[2.0, 0.7, 5.0, 1.0], rate=[1.0, 2.0, 0.5, 1.0]), [1.3, 0.4, 9.0, 0.0]),
    "Beta": (
        dict(concentration1=[2.0, 0.5, 3.0, 2.0], concentration0=[3.0, 0.5, 1.0, 2.0],
             low=[0.0, 0.0, -1.0, 0.0], high=[1.0, 1.0, 3.0, 1.0]),
        [0.4, 1.0, 2.0, 1.2],
    ),
    "VonMises": (dict(loc=[0.0, 1.0, -2.0, 3.0], concentration=[2.0, 0.5, 10.0, 1e-3]), [0.3, -math.pi, -2.1, 7.0]),
    "LogNormal": (dict(loc=[0.0, 1.0, -0.5, 0.3], scale=[1.0, 0.5, 2.0, 1.0]), [1.2, 3.0, 0.01, -1.0]),
    "Weibull": (dict(scale=[1.0, 2.0, 0.5, 1.0], concentration=[1.5, 0.8, 3.0, 2.0]), [0.6, 0.0, 0.4, -0.5]),
    "Chi2": (dict(df=[3.0, 1.0, 8.0, 2.0]), [2.0, 0.3, 9.0, 0.0]),
    "HalfNormal": (dict(scale=[1.0, 2.0, 0.5, 1.0]), [0.5, 0.0, 1.3, -0.2]),
    "HalfCauchy": (dict(scale=[1.0, 2.0, 0.5, 1.0]), [0.5, 0.0, 30.0, -0.2]),
    "InverseGamma": (dict(concentration=[3.0, 2.5, 5.0, 1.0], rate=[2.0, 1.0, 4.0, 1.0]), [0.8, 0.3, 1.0, 0.0]),
    "Pareto": (dict(scale=[1.0, 2.0, 0.5, 1.0], alpha=[3.0, 2.5, 5.0, 1.0]), [1.7, 2.0, 0.6, 0.9]),
}
# one scalar parameter set per distribution for the moments of draws
# (finite variance; Pareto alpha > 4 so the variance's error is finite)
DRAWS = {
    "Bernoulli": dict(probs=0.3),
    "Binomial": dict(total_count=12.0, probs=0.35),
    "Poisson": dict(rate=4.0),
    "Exponential": dict(rate=1.5),
    "Gamma": dict(concentration=2.0, rate=1.5),
    "Beta": dict(concentration1=2.0, concentration0=3.0, low=-1.0, high=3.0),
    "VonMises": dict(loc=1.0, concentration=2.0),
    "LogNormal": dict(loc=0.2, scale=0.5),
    "Weibull": dict(scale=2.0, concentration=1.5),
    "Chi2": dict(df=3.0),
    "HalfNormal": dict(scale=2.0),
    "HalfCauchy": dict(scale=2.0),
    "InverseGamma": dict(concentration=6.0, rate=2.0),
    "Pareto": dict(scale=1.0, alpha=5.0),
}


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    np.testing.assert_array_equal(np.isposinf(a), np.isposinf(b))
    keep = np.isfinite(b)
    np.testing.assert_allclose(a[keep], b[keep], atol=tol, rtol=tol)


def _both(name, params):
    j = getattr(JD, name)(**{k: jnp.asarray(np.asarray(v, np.float32)) for k, v in params.items()})
    t = getattr(TD, name)(**{k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()})
    return j, t


@pytest.mark.parametrize("name", sorted(CASES))
def test_log_prob_matches(name):
    params, points = CASES[name]
    j, t = _both(name, params)
    x = np.asarray(points, np.float32)
    jl = np.asarray(j.log_prob(jnp.asarray(x)))
    tl = t.log_prob(torch.from_numpy(x)).numpy()
    _close(tl, jl)
    _close(t.log_prob(torch.from_numpy(x), sum=True), j.log_prob(jnp.asarray(x), sum=True), 1e-4)
    assert t.batch_shape == tuple(j.batch_shape) == (4,)
    assert t.address_suffix == j.address_suffix == name
    # one value scored under every row's parameters, and a scalar distribution
    _close(t.log_prob(float(x[0])).numpy(), np.asarray(j.log_prob(float(x[0]))))
    js, ts = _both(name, {k: v[0] for k, v in params.items()})
    _close(ts.log_prob(torch.from_numpy(x)).numpy(), np.asarray(js.log_prob(jnp.asarray(x))))


@pytest.mark.parametrize("name", sorted(CASES))
def test_moments_match(name):
    params, _ = CASES[name]
    j, t = _both(name, params)
    for what in ("mean", "variance", "stddev"):
        _close(getattr(t, what).numpy(), np.asarray(getattr(j, what)))
    for attr in ("low", "high", "probs", "rate", "scale", "concentration", "df", "alpha", "loc"):
        if hasattr(j, attr) and hasattr(t, attr):
            _close(getattr(t, attr).numpy(), np.asarray(getattr(j, attr)))


def _within(samples, expected, what):
    n = samples.shape[0]
    se = samples.std() / math.sqrt(n)
    assert abs(samples.mean() - expected) <= 5 * se, (what, samples.mean(), expected, se)


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draw_moments(name):
    j, t = _both(name, DRAWS[name])
    g = torch.Generator().manual_seed(1)
    x = t.sample(g, (100_000,)).double().numpy()
    assert x.shape == (100_000,) and np.isfinite(x).all()
    if name == "HalfCauchy":
        # the median is the scale
        _within((x <= float(t.scale)).astype(np.float64), 0.5, "median")
        return
    if name == "VonMises":
        c = np.cos(x - float(t.loc))
        _within(c, 1.0 - float(j.variance), "E cos")
        assert (x >= -math.pi).all() and (x < math.pi).all()
        return
    mean, var = float(np.asarray(j.mean)), float(np.asarray(j.variance))
    _within(x, mean, "mean")
    _within((x - x.mean()) ** 2, var, "variance")
    assert float(t.log_prob(torch.from_numpy(x.astype(np.float32))).min()) > -math.inf


def test_draw_shapes_and_generators():
    """A batched distribution draws [*shape, N]; one generator seed gives
    the same draws twice."""
    for name in sorted(DRAWS):
        t = _both(name, CASES[name][0])[1]
        a = t.sample(torch.Generator().manual_seed(3), (5,))
        b = t.sample(torch.Generator().manual_seed(3), (5,))
        assert a.shape == (5, 4), name
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert t.sample(torch.Generator().manual_seed(3)).shape == (4,), name


def test_constructor_alternatives():
    """logits= for Bernoulli and Binomial, and their logits accessors."""
    logits = np.asarray([-2.0, 0.0, 3.0], np.float32)
    for name, kw in (("Bernoulli", {}), ("Binomial", {"total_count": 7.0})):
        j = getattr(JD, name)(logits=jnp.asarray(logits), **kw)
        t = getattr(TD, name)(logits=torch.from_numpy(logits), **kw)
        _close(t.probs.numpy(), np.asarray(j.probs))
        _close(t.logits.numpy(), np.asarray(j.logits), 1e-4)
        with pytest.raises(ValueError):
            getattr(TD, name)(**kw)


@pytest.mark.parametrize("name,x", [
    ("Exponential", [0.3, 2.0]), ("Gamma", [0.5, 3.0]), ("Chi2", [0.5, 3.0]),
    ("HalfNormal", [0.5, 3.0]), ("HalfCauchy", [0.5, 3.0]), ("InverseGamma", [0.5, 3.0]),
    ("Pareto", [0.5, 3.0]),
])
def test_cdf_matches(name, x):
    j, t = _both(name, DRAWS[name])
    x = np.asarray(x, np.float32)
    _close(t.cdf(torch.from_numpy(x)).numpy(), np.asarray(j.cdf(jnp.asarray(x))))
    if hasattr(JD, name) and name in ("Exponential", "HalfNormal", "HalfCauchy", "Pareto"):
        u = np.asarray([0.1, 0.9], np.float32)
        _close(t.icdf(torch.from_numpy(u)).numpy(), np.asarray(j.icdf(jnp.asarray(u))))


def test_factor_distribution():
    jf, tf = JD.Factor(log_prob=-2.5), TD.Factor(log_prob=-2.5)
    assert float(tf.log_prob()) == float(jf.log_prob()) == -2.5
    assert float(tf.sample()) == float(jf.sample()) == 0.0
    assert tf.address_suffix == jf.address_suffix == "Factor"
    tf = TD.Factor(log_prob_func=lambda v: -(v**2))
    assert float(tf.log_prob(torch.tensor(3.0))) == -9.0
    with pytest.raises(ValueError):
        TD.Factor()
    with pytest.raises(NotImplementedError):
        tf.mean


def test_normal_cdf_icdf_match():
    """Normal's cdf 0.5 (1 + erf(z/√2)) and icdf through erfinv, batched and
    scalar, at interior, tail and ±inf points: rtol/atol 1e-6."""
    params = dict(loc=[0.0, 1.5, -2.0], scale=[1.0, 0.5, 3.0])
    j, t = _both("Normal", params)
    x = np.asarray([-np.inf, -9.0, -3.0, -0.5, 0.0, 0.5, 3.0, 9.0, np.inf], np.float32)[:, None]
    _close(t.cdf(torch.from_numpy(x)).numpy(), np.asarray(j.cdf(jnp.asarray(x))), 1e-6)
    u = np.asarray([0.0, 1e-6, 0.1, 0.5, 0.9, 0.999999, 1.0], np.float32)[:, None]
    _close(t.icdf(torch.from_numpy(u)).numpy(), np.asarray(j.icdf(jnp.asarray(u))), 1e-6)
    js, ts = _both("Normal", dict(loc=0.0, scale=1.0))
    assert abs(float(ts.cdf(0.5)) - 0.691462) < 1e-6
    _close(ts.cdf(0.5).numpy(), np.asarray(js.cdf(0.5)), 1e-6)
    _close(ts.icdf(0.3).numpy(), np.asarray(js.icdf(0.3)), 1e-6)


def test_cdf_not_implemented_names_the_class():
    """The base class raises NotImplementedError naming the distribution,
    as the JAX package's does, for a class without cdf or icdf."""
    for lib in (JD, TD):
        d = lib.Bernoulli(probs=0.3)
        with pytest.raises(NotImplementedError, match="cdf not implemented for Bernoulli"):
            d.cdf(0.5)
        with pytest.raises(NotImplementedError, match="icdf not implemented for Bernoulli"):
            d.icdf(0.5)
