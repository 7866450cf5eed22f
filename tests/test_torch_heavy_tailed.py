"""The port's heavy-tailed family (StudentT, Laplace, Cauchy, Logistic,
Gumbel), Geometric, NegativeBinomial and the Censored and ZeroInflated
observation wrappers against the JAX package's on the same numpy inputs.

``log_prob`` at points inside the support, on its boundary and outside it,
batched and scalar, ``cdf``/``icdf`` and the moments within rtol/atol 1e-5
in float32, with equal −inf, +inf and NaN patterns.  Draws: 10^5 seeded
draws each, their mean and variance within 5 standard errors of the
distribution's own (the median, the interquartile range and the share
beyond 6 for Cauchy; the tail masses at the bounds for Censored; P(0) for
ZeroInflated), and no draw ±inf.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm, poisson

import pyprob_tpu_torch
from pyprob_tpu import distributions as JD
from pyprob_tpu_torch import distributions as TD

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyprob_tpu_torch.set_device("cpu")
    pyprob_tpu_torch.seed(0)
    yield


# name: (batched parameters, points: in the support, on its boundary, outside,
# and far out in a tail)
CASES = {
    "StudentT": (dict(df=[3.0, 0.5, 1.5, 30.0], loc=[0.0, 1.0, -2.0, 0.5], scale=[1.0, 2.0, 0.5, 1.0]),
                 [0.3, 1e6, -2.0, -50.0]),
    "Laplace": (dict(loc=[0.0, 1.0, -2.0, 3.0], scale=[1.0, 0.5, 2.0, 1.0]), [0.3, 1.0, 1e6, -40.0]),
    "Cauchy": (dict(loc=[0.0, 1.0, -2.0, 3.0], scale=[1.0, 0.5, 2.0, 1.0]), [0.3, 1e6, -1e7, 3.0]),
    "Logistic": (dict(loc=[0.0, 1.0, -2.0, 3.0], scale=[1.0, 0.5, 2.0, 1.0]), [0.3, 100.0, -100.0, 1e6]),
    "Gumbel": (dict(loc=[0.0, 1.0, -2.0, 3.0], scale=[1.0, 0.5, 2.0, 1.0]), [0.3, -5.0, 50.0, -100.0]),
    "Geometric": (dict(probs=[0.4, 0.1, 1e-13, 1.0]), [2.0, 0.0, 2.5, -1.0]),
    "NegativeBinomial": (dict(total_count=[5.0, 2.5, 1.0, 10.0], probs=[0.4, 0.7, 0.5, 0.2]),
                         [7.0, 0.0, 2.5, -1.0]),
    # the tail atoms at |z| <= 2: further out 1 + erf(z/√2) cancels in float32
    # in both packages, and their erf differs by an ulp (1e-4 relative at z = −4)
    "Censored": (dict(loc=[0.0, 1.0, -2.0, 0.5], scale=[1.0, 1.0, 2.0, 1.0], lower=[-1.0, -1.0, -3.0, -np.inf],
                      upper=[1.5, 2.0, np.inf, 1.0]), [-1.0, 0.3, 1.5, 2.0]),
    "ZeroInflated": (dict(rate=[3.0, 0.5, 2.0, 4.0], gate=[0.4, 0.1, 1e-13, 1.0]), [0.0, 2.0, 0.0, -1.0]),
}
# one scalar parameter set per distribution for the moments of draws (finite
# fourth moments, so the variance's standard error is finite)
DRAWS = {
    "StudentT": dict(df=9.0, loc=1.0, scale=2.0),
    "Laplace": dict(loc=1.0, scale=2.0),
    "Cauchy": dict(loc=1.0, scale=2.0),
    "Logistic": dict(loc=1.0, scale=2.0),
    "Gumbel": dict(loc=1.0, scale=2.0),
    "Geometric": dict(probs=0.3),
    "NegativeBinomial": dict(total_count=5.0, probs=0.4),
    "Censored": dict(loc=0.0, scale=1.0, lower=-1.0, upper=1.5),
    "ZeroInflated": dict(rate=3.0, gate=0.4),
}


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    np.testing.assert_array_equal(np.isposinf(a), np.isposinf(b))
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    keep = np.isfinite(b)
    np.testing.assert_allclose(a[keep], b[keep], atol=tol, rtol=tol)


def _make(lib, name, params, array):
    p = {k: array(np.asarray(v, np.float32)) for k, v in params.items()}
    if name == "Censored":
        return lib.Censored(lib.Normal(p["loc"], p["scale"]), lower=p["lower"], upper=p["upper"])
    if name == "ZeroInflated":
        return lib.ZeroInflated(lib.Poisson(p["rate"]), gate=p["gate"])
    return getattr(lib, name)(**p)


def _both(name, params):
    return _make(JD, name, params, jnp.asarray), _make(TD, name, params, torch.tensor)


@pytest.mark.parametrize("name", sorted(CASES))
def test_log_prob_matches(name):
    params, points = CASES[name]
    j, t = _both(name, params)
    x = np.asarray(points, np.float32)
    _close(t.log_prob(torch.from_numpy(x)).numpy(), np.asarray(j.log_prob(jnp.asarray(x))))
    _close(t.log_prob(torch.from_numpy(x), sum=True), j.log_prob(jnp.asarray(x), sum=True), 1e-4)
    assert t.batch_shape == tuple(j.batch_shape) == (4,)
    assert t.name == j.name and t.address_suffix == j.address_suffix
    # one value scored under every row's parameters, and a scalar distribution
    _close(t.log_prob(float(x[0])).numpy(), np.asarray(j.log_prob(float(x[0]))))
    js, ts = _both(name, {k: v[0] for k, v in params.items()})
    assert ts.batch_shape == () and ts.address_suffix == js.address_suffix
    _close(ts.log_prob(torch.from_numpy(x)).numpy(), np.asarray(js.log_prob(jnp.asarray(x))))


def test_wrapper_names_and_addresses():
    j, t = _both("Censored", DRAWS["Censored"])
    assert t.name == j.name == "Censored(Normal)" == t.address_suffix
    j, t = _both("ZeroInflated", DRAWS["ZeroInflated"])
    assert t.name == j.name == "ZeroInflated(Poisson)" == t.address_suffix
    nested = TD.Censored(TD.ZeroInflated(TD.Poisson(2.0), 0.3), upper=4.0)
    jnested = JD.Censored(JD.ZeroInflated(JD.Poisson(2.0), 0.3), upper=4.0)
    assert nested.address_suffix == jnested.address_suffix == "Censored(ZeroInflated(Poisson))"
    with pytest.raises(ValueError, match="at least one"):
        TD.Censored(TD.Normal(0.0, 1.0))
    with pytest.raises(TypeError):
        TD.ZeroInflated(0.5, 0.1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moments_match(name):
    params, _ = CASES[name]
    j, t = _both(name, params)
    for what in ("mean", "variance"):
        if name == "Censored":
            with pytest.raises(NotImplementedError):
                getattr(t, what)
            continue
        _close(getattr(t, what).numpy(), np.asarray(getattr(j, what)))
    for attr in ("probs", "total_count", "df", "loc", "scale", "gate", "lower", "upper"):
        if hasattr(j, attr) and hasattr(t, attr):
            _close(getattr(t, attr).numpy(), np.asarray(getattr(j, attr)))


def test_undefined_moments():
    """StudentT's mean is NaN for df <= 1; its variance NaN for df <= 1 and
    +inf for 1 < df <= 2 (the JAX package's bands); Cauchy's are NaN."""
    df = [0.5, 1.0, 1.5, 2.0, 3.0]
    j, t = JD.StudentT(jnp.asarray(df), 1.0, 2.0), TD.StudentT(torch.tensor(df), 1.0, 2.0)
    _close(t.mean.numpy(), np.asarray(j.mean))
    _close(t.variance.numpy(), np.asarray(j.variance))
    assert np.isnan(t.mean.numpy()[:2]).all() and np.isfinite(t.mean.numpy()[2:]).all()
    assert np.isnan(t.variance.numpy()[:2]).all() and np.isposinf(t.variance.numpy()[2:4]).all()
    assert np.isnan(float(TD.Cauchy(0.0, 1.0).mean)) and np.isnan(float(TD.Cauchy(0.0, 1.0).variance))
    # a mixture passes its components' NaN and +inf through, as the JAX package's
    comps = [(2.0, 0.0, 1.0), (1.5, 1.0, 1.0), (0.5, 0.0, 1.0)]
    for sel in (comps[:2], comps):
        jm = JD.Mixture([JD.StudentT(*c) for c in sel])
        tm = TD.Mixture([TD.StudentT(*c) for c in sel])
        _close(tm.mean.numpy(), np.asarray(jm.mean))
        _close(tm.variance.numpy(), np.asarray(jm.variance))


@pytest.mark.parametrize("name,x", [
    ("Laplace", [-30.0, -1.0, 1.0, 1.7, 30.0]), ("Cauchy", [-1e6, -1.0, 1.0, 4.0, 1e6]),
    ("Logistic", [-100.0, -1.0, 1.0, 4.0, 100.0]), ("Gumbel", [-10.0, -1.0, 1.0, 4.0, 60.0]),
    ("Geometric", [-1.0, 0.0, 1.5, 2.0, 30.0]), ("Censored", [-1.01, -1.0, 0.3, 1.5, 2.0]),
])
def test_cdf_icdf_match(name, x):
    j, t = _both(name, DRAWS[name])
    x = np.asarray(x, np.float32)
    _close(t.cdf(torch.from_numpy(x)).numpy(), np.asarray(j.cdf(jnp.asarray(x))))
    if name in ("Laplace", "Cauchy", "Logistic", "Gumbel"):
        u = np.asarray([1e-6, 0.01, 0.3, 0.5, 0.9, 0.999], np.float32)
        _close(t.icdf(torch.from_numpy(u)).numpy(), np.asarray(j.icdf(jnp.asarray(u))))
        _close(t.cdf(t.icdf(torch.from_numpy(u[1:]))).numpy(), u[1:], 1e-5)
    if name == "Geometric":
        g = TD.Geometric(0.5)
        assert float(g.cdf(0.0)) == 0.5 and float(g.cdf(1.0)) == 0.75 and float(g.cdf(-1.0)) == 0.0
    if name == "Censored":
        assert float(t.cdf(-1.01)) == 0.0 and float(t.cdf(1.5)) == 1.0


def test_no_cdf_where_the_jax_package_has_none():
    for lib in (JD, TD):
        with pytest.raises(NotImplementedError, match="StudentT"):
            lib.StudentT(3.0).cdf(0.5)
        with pytest.raises(NotImplementedError, match="NegativeBinomial"):
            lib.NegativeBinomial(5.0, 0.4).icdf(0.5)


def test_constructor_alternatives():
    """logits= for Geometric and NegativeBinomial, one of probs/logits."""
    logits = np.asarray([-2.0, 0.0, 3.0], np.float32)
    for name, kw in (("Geometric", {}), ("NegativeBinomial", {"total_count": 4.0})):
        j = getattr(JD, name)(logits=jnp.asarray(logits), **kw)
        t = getattr(TD, name)(logits=torch.from_numpy(logits), **kw)
        _close(t.probs.numpy(), np.asarray(j.probs))
        k = np.asarray([0.0, 1.0, 5.0], np.float32)
        _close(t.log_prob(torch.from_numpy(k)).numpy(), np.asarray(j.log_prob(jnp.asarray(k))))
        with pytest.raises(ValueError):
            getattr(TD, name)(**kw)
    d = TD.Geometric(logits=0.0)
    total = torch.exp(d.log_prob(torch.arange(60.0)).double()).sum()
    assert abs(float(total) - 1.0) < 1e-6 and abs(float(d.mean) - 1.0) < 1e-6


def _within(samples, expected, what):
    se = samples.std() / math.sqrt(samples.shape[0])
    assert abs(samples.mean() - expected) <= 5 * se, (what, samples.mean(), expected, se)


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draw_moments(name):
    j, t = _both(name, DRAWS[name])
    x = t.sample(torch.Generator().manual_seed(1), (100_000,)).double().numpy()
    assert x.shape == (100_000,) and np.isfinite(x).all()
    assert float(t.log_prob(torch.from_numpy(x.astype(np.float32))).min()) > -math.inf
    if name == "Cauchy":
        # median loc, quartiles loc ± scale, P(|x − loc| > 6 scale) = 1 − 2/π atan 6
        _within((x <= 1.0).astype(np.float64), 0.5, "median")
        _within((x <= -1.0).astype(np.float64), 0.25, "lower quartile")
        _within((x <= 3.0).astype(np.float64), 0.75, "upper quartile")
        _within((np.abs(x - 1.0) > 12.0).astype(np.float64), 1.0 - 2.0 / math.pi * math.atan(6.0), "tail")
        return
    if name == "Censored":
        assert x.min() >= -1.0 and x.max() <= 1.5
        _within((x <= -1.0).astype(np.float64), norm.cdf(-1.0), "lower tail mass")
        _within((x >= 1.5).astype(np.float64), norm.sf(1.5), "upper tail mass")
        return
    mean, var = float(np.asarray(j.mean)), float(np.asarray(j.variance))
    _within(x, mean, "mean")
    _within((x - x.mean()) ** 2, var, "variance")
    if name == "ZeroInflated":
        _within((x == 0).astype(np.float64), 0.4 + 0.6 * math.exp(-3.0), "P(0)")
    if name in ("Geometric", "NegativeBinomial"):
        assert (x == np.round(x)).all() and x.min() >= 0


def test_heavy_draws_are_finite():
    """StudentT at the heads' df floor 0.5 and at df 0.1, and every draw of
    the family, batched over 10^5 rows: no ±inf, no NaN."""
    g = torch.Generator().manual_seed(5)
    n = 100_000
    for d in (TD.StudentT(torch.full((n,), 0.5), 0.0, 1.0), TD.StudentT(0.1, 0.0, 1.0), TD.Cauchy(0.0, 1.0),
              TD.Laplace(0.0, 1.0), TD.Logistic(0.0, 1.0), TD.Gumbel(0.0, 1.0), TD.Geometric(1e-6)):
        x = d.sample(g, () if d.batch_shape else (n,))
        assert x.shape == (n,) and bool(torch.isfinite(x).all()), d


def test_zero_inflated_poisson_pmf():
    """ZeroInflated(Poisson(3), 0.4): the pmf sums to 1, P(0) and P(2) as
    tests/test_censored_zi.py:62-76 hold the JAX package's."""
    z = TD.ZeroInflated(TD.Poisson(3.0), gate=0.4)
    lp = z.log_prob(torch.arange(40.0)).double()
    assert abs(float(torch.exp(lp).sum()) - 1.0) < 1e-6
    assert abs(float(lp[0]) - math.log(0.4 + 0.6 * math.exp(-3))) < 1e-6
    assert abs(float(lp[2]) - (math.log(0.6) + poisson.logpmf(2, 3))) < 1e-5


def test_censored_accounting_and_positive_base():
    """tests/test_censored_zi.py:20-50 on the port: the tails' atoms, the
    interior density, one-sided bounds on a positive base."""
    c = TD.Censored(TD.Normal(0.0, 1.0), lower=-1.0, upper=1.5)
    assert abs(float(c.log_prob(-1.0)) - math.log(norm.cdf(-1))) < 1e-5
    assert abs(float(c.log_prob(1.5)) - math.log(norm.sf(1.5))) < 1e-4
    assert abs(float(c.log_prob(0.3)) - norm.logpdf(0.3)) < 1e-5
    e = TD.Censored(TD.Exponential(2.0), upper=1.0)
    assert abs(float(e.log_prob(1.0)) - (-2.0)) < 1e-4
    s = e.sample(torch.Generator().manual_seed(2), (100_000,)).double().numpy()
    assert s.max() <= 1.0
    _within((s >= 1.0).astype(np.float64), math.exp(-2.0), "Exponential tail mass")


def test_censored_gradients_at_the_bounds():
    """The gradient of a Censored Normal's log-density with respect to the
    base's location and scale, at values on both bounds, beyond them and
    inside, equals the JAX package's and is finite: the unselected branch
    of the where does not leak NaN.  Points at |z| <= 2.5 (beyond it the
    float32 cdf cancels in both packages: at z = −4 they differ by 1e-3
    relative, each as far from the float64 truth)."""
    for x in (-1.0, -1.8, 0.3, 1.5, 2.0, 1.4999, -0.9999):

        def jax_lp(mu, sd):
            return JD.Censored(JD.Normal(mu, sd), lower=-1.0, upper=1.5).log_prob(jnp.float32(x))

        jg = jax.grad(jax_lp, argnums=(0, 1))(jnp.float32(0.2), jnp.float32(0.8))
        mu = torch.tensor(0.2, requires_grad=True)
        sd = torch.tensor(0.8, requires_grad=True)
        TD.Censored(TD.Normal(mu, sd), lower=-1.0, upper=1.5).log_prob(torch.tensor(x)).backward()
        for got, want in ((mu.grad, jg[0]), (sd.grad, jg[1])):
            assert math.isfinite(float(got)), x
            _close(got.numpy(), np.asarray(want), 1e-5)


def test_wrapper_leaves_round_trip():
    """A wrapper's leaves are its base's, then its own; rebuilding from them
    (the batched tier's per-trace distributions) gives the same scores."""
    t = _both("Censored", CASES["Censored"][0])[1]
    assert len(t._leaves()) == 4
    r = t._with_leaves([leaf.clone() for leaf in t._leaves()])
    x = torch.tensor(CASES["Censored"][1])
    assert type(r.base) is TD.Normal and torch.equal(r.log_prob(x), t.log_prob(x))
    z = TD.ZeroInflated(TD.Censored(TD.Normal(torch.tensor([2.0, 3.0]), 1.0), lower=0.0), 0.3)
    r = z._with_leaves([leaf.clone() for leaf in z._leaves()])
    k = torch.tensor([0.0, 5.0])
    assert r.address_suffix == z.address_suffix == "ZeroInflated(Censored(Normal))"
    assert torch.equal(r.log_prob(k), z.log_prob(k))
    assert "base=Normal" in repr(z) and "gate=" in repr(z)


def _truths():
    import chip_smoke

    return {
        "tobit": (chip_smoke.tobit_model, chip_smoke.TOBIT["observe"], chip_smoke.tobit_grid_truth()),
        "zip": (chip_smoke.zip_model, chip_smoke.ZIP["observe"], chip_smoke.zip_grid_truth()),
        "beta_nb": (chip_smoke.beta_nb_model, chip_smoke.BETA_NB["observe"],
                    (chip_smoke.BETA_NB["mean"], chip_smoke.BETA_NB["stddev"])),
        "geometric": (chip_smoke.geometric_model, chip_smoke.GEOMETRIC["observe"], chip_smoke.geometric_truth()),
    }


@pytest.mark.parametrize("tier,traces", [("batched", 20_000), ("interpreter", 2000)])
@pytest.mark.parametrize("case", ["tobit", "zip", "beta_nb", "geometric"])
def test_prior_is_holds_to_the_truth(case, tier, traces):
    """Prior IS of the Tobit (Censored observes), zero-inflated Poisson,
    Beta–NegativeBinomial and Geometric-latent models on both tiers: the
    mean and the stddev within 5 standard errors of the grid, analytic or
    enumerated truth, the standard error truth stddev / √ESS of the run."""
    pyprob_tpu_torch.set_verbosity(0)
    make, observe, (mean, std) = _truths()[case]
    pyprob_tpu_torch.seed(4)
    post = make().posterior_results(traces, observe=observe, vectorized=tier == "batched")
    ess = post.effective_sample_size
    assert ess > 0.1 * traces
    limit = 5.0 * std / math.sqrt(ess)
    assert abs(float(post.mean) - mean) <= limit, (float(post.mean), mean, limit)
    assert abs(float(post.stddev) - std) <= limit, (float(post.stddev), std, limit)


def test_port_trace_carries_the_new_classes():
    """``_torch_parity.port_trace`` rebuilds a JAX package trace holding the
    nine classes, a wrapper around a wrapper among them: the same
    addresses, and each site's log-density at its value equal."""
    import pyprob_tpu
    from _torch_parity import port_trace

    def body(lib):
        D = lib.distributions
        x = lib.sample(D.StudentT(3.0, 0.5, 2.0))
        for d in (D.Laplace(0.0, 1.0), D.Cauchy(1.0, 2.0), D.Logistic(0.0, 1.5), D.Gumbel(1.0, 0.5),
                  # a batch of one: the JAX package's host draw of a scalar
                  # NegativeBinomial raises (rng.poisson returns an int)
                  D.Geometric(0.3), D.NegativeBinomial([4.0], 0.6)):
            lib.sample(d)
        lib.observe(D.Censored(D.Normal(x, 1.0), upper=1.0), name="y")
        lib.observe(D.ZeroInflated(D.Poisson(2.0), 0.3), name="k")
        lib.observe(D.ZeroInflated(D.Censored(D.Normal(x, 1.0), lower=0.0), 0.2), name="z")
        return x

    class J(pyprob_tpu.Model):
        def forward(self):
            return body(pyprob_tpu)

    pyprob_tpu.seed(3)
    (jtrace,) = J().prior(1, observe={"y": 1.0, "k": 0.0, "z": 0.0}, vectorized=False).get_values()
    trace = port_trace(jtrace)
    assert [v.address for v in trace.variables] == [v.address for v in jtrace.variables]
    assert "ZeroInflated(Censored(Normal))" in trace.variables[-1].address
    for t, j in zip(trace.variables, jtrace.variables):
        assert type(t.distribution).__name__ == type(j.distribution).__name__
        _close(t.distribution.log_prob(torch.as_tensor(t.value)).numpy(),
               np.asarray(j.distribution.log_prob(np.asarray(j.value, np.float32))))
