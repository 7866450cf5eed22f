"""LAPLACE and ``Model.map_estimate`` (``pyprob_tpu_torch.inference.laplace``)
on the CPU.

(i) Against the JAX package (``pyprob_tpu.inference.laplace``): the
multi-start fit (one Adam over ``[S, D]`` on the summed potential) step
for step against S optax Adams from the same starts, within 1e-4 (1 +
|ref|) after 40 steps, with and without the Jacobian; the Hessian at a
point against ``jax.hessian`` of the JAX potential, within 1e-4 (1 +
|ref|).  (ii) The JAX tests' criteria (tests/test_laplace.py): exact on
GUM (constant weights, both evidence estimates within 0.02 of the
analytic log Z), ``map_estimate`` on GUM, the Gamma–Poisson posterior
recovered by reweighting and its constrained-space MAP, an enumerated
Bernoulli against a grid-integrated posterior, the conjugate linear
regression (tests/test_models_builtin.py:178-200), the errors.  ESS and
log Z come from kernel 3's plain version here.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu.inference import hmc as jhmc, laplace as jlaplace
from pyprob_tpu_torch.inference import hmc, laplace
from pyprob_tpu_torch.vectorized import _TraceabilityCache

from _torch_parity import OBSERVE, POSTERIOR_MEAN, POSTERIOR_STDDEV, JaxGammaPoisson, TorchGammaPoisson, TorchGUM

torch.set_num_threads(2)

LAPLACE = pp.InferenceEngine.LAPLACE
TD = pp.distributions
# log N(7.25; 1, sqrt 5) + log N(8; 7.25, sqrt 2) + log N(9; 7.25, sqrt 2)
TRUE_LOG_JOINT_AT_MODE = -9.0672
# log N(8; 1, sqrt 7) + log N(9; 6, sqrt(24/7))
TRUE_LOG_EVIDENCE = -8.2395


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    pp.set_verbosity(1)
    _TraceabilityCache._cache.clear()
    yield


def _close(mine, ref, tol):
    mine, ref = np.asarray(mine, np.float64), np.asarray(ref, np.float64)
    excess = np.abs(mine - ref) - tol * (1 + np.abs(ref))
    assert np.all(excess <= 0), (float(excess.max()), mine, ref)


def _gamma_poisson_observe():
    return {"obs0": 6.0, "obs1": 4.0}


def test_adam_fit_and_hessian_match_jax():
    jm, tm = JaxGammaPoisson(), TorchGammaPoisson()
    observe = _gamma_poisson_observe()
    jobs = {k: jnp.asarray(v, jnp.float32) for k, v in observe.items()}
    tobs = {k: pp.util.to_tensor(v, "cpu") for k, v in observe.items()}
    fit_fn, hessian_fn, _, jfm = jlaplace._build_laplace(jm, jobs, 1.0, False, (), None)
    tfm = hmc._functionalize(tm, tobs, 1.0, "LAPLACE", (), None)
    z0 = np.array([[-1.0], [0.5], [3.0]], np.float32)
    for jac in (True, False):
        jz, jpots = fit_fn(jnp.asarray(z0), jobs, 40, 0.05, jac=jac)
        tz, tpots = laplace.adam_fit(tfm, torch.as_tensor(z0), tobs, 40, 0.05, jac=jac)
        _close(tz.numpy(), jz, 1e-4)
        _close(tpots.numpy(), jpots, 1e-4)
    for z in (np.array([1.2], np.float32), np.array([0.3], np.float32)):
        _close(laplace.hessian(tfm, torch.as_tensor(z), tobs), hessian_fn(jnp.asarray(z), jobs), 1e-4)


def test_hessian_of_a_mixture_matches_jax():
    """The 3 x 3 Hessian of GaussianMixture with learn_weights (the mixture
    observe on kernel 1's plain version, the weights through
    stick-breaking)."""
    from pyprob_tpu.models import GaussianMixture as JGM
    from pyprob_tpu_torch.models import GaussianMixture as TGM

    kw = {"num_components": 2, "obs_stddev": 0.6, "num_data": 40, "learn_weights": True}
    jm, tm = JGM(**kw), TGM(**kw)
    y = jm.synthesize([-2.0, 2.0], rng=0)
    jobs, tobs = {"y": jnp.asarray(y, jnp.float32)}, {"y": torch.as_tensor(y, dtype=torch.float32)}
    jfm = jhmc._functionalize(jm, jobs, 1.0, False, "LAPLACE", (), None)
    tfm = hmc._functionalize(tm, tobs, 1.0, "LAPLACE", (), None)
    z = np.array([-1.9, 2.1, 0.2], np.float32)
    ref = jax.jit(jax.hessian(jfm.potential))(jnp.asarray(z), jobs)
    _close(laplace.hessian(tfm, torch.as_tensor(z), tobs), ref, 1e-4)


def test_laplace_exact_on_gaussian_posterior():
    """tests/test_laplace.py:34-47."""
    post = TorchGUM().posterior_results(4000, observe=OBSERVE, inference_engine=LAPLACE)
    assert post.effective_sample_size > 0.99 * 4000
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.05
    assert abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.05
    assert abs(post.log_evidence - TRUE_LOG_EVIDENCE) < 0.02
    assert abs(post.log_evidence_laplace - TRUE_LOG_EVIDENCE) < 0.02
    md = post.metadata[-1]
    assert md["inference_engine"] == "InferenceEngine.LAPLACE" and md["latent_dim"] == 1
    assert md["effective_sample_size"] == post.effective_sample_size


def test_map_estimate_gum():
    """tests/test_laplace.py:50-56."""
    res = TorchGUM().map_estimate(observe=OBSERVE)
    assert len(res.values) == 1
    (mode,) = res.values.values()
    assert abs(float(mode) - POSTERIOR_MEAN) < 0.01
    assert abs(float(res.result) - POSTERIOR_MEAN) < 0.01
    assert abs(res.log_joint - TRUE_LOG_JOINT_AT_MODE) < 0.01
    assert res.num_starts == 8 and res.map_steps == 400 and res.z.shape == (1,)
    assert "log_joint" in repr(res)


class _GammaPoisson(pp.Model):
    def forward(self):
        lam = pp.sample(TD.Gamma(3.0, 1.0), name="lam")
        pp.observe(TD.Poisson(lam), name="c0")
        pp.observe(TD.Poisson(lam), name="c1")
        return lam


def test_laplace_positive_support_reweighting():
    """tests/test_laplace.py:72-101: Gamma(13, 3) recovered from the log-space
    Gaussian by reweighting; the constrained-space MAP (13 - 1) / 3."""
    m = _GammaPoisson()
    obs = {"c0": 4.0, "c1": 6.0}
    post = m.posterior_results(20000, observe=obs, inference_engine=LAPLACE)
    assert post.effective_sample_size > 0.5 * 20000
    assert abs(float(post.mean) - 13.0 / 3.0) < 0.05
    assert abs(float(post.stddev) - math.sqrt(13.0) / 3.0) < 0.05
    res = m.map_estimate(observe=obs)
    assert abs(float(res.values["lam"]) - 4.0) < 0.03


class _MixedDiscrete(pp.Model):
    def forward(self):
        z = pp.sample(TD.Normal(0.0, 2.0), name="z")
        d = pp.sample(TD.Bernoulli(0.3), name="d")
        pp.observe(TD.Normal(z + 0.5 * d, 0.5), name="y")
        return z


def test_laplace_enumerates_discrete():
    """tests/test_laplace.py:104-113 against the grid-integrated posterior
    (the JAX test's reference is 400,000-trace IS)."""
    zs = np.linspace(-6, 6, 24001)
    normal = lambda x, m, s: np.exp(-0.5 * ((x - m) / s) ** 2) / s  # noqa: E731
    p = normal(zs, 0, 2) * (0.7 * normal(0.8, zs, 0.5) + 0.3 * normal(0.8, zs + 0.5, 0.5))
    p /= p.sum()
    mean = float((zs * p).sum())
    std = float(np.sqrt(((zs - mean) ** 2 * p).sum()))
    post = _MixedDiscrete().posterior(4000, observe={"y": 0.8}, inference_engine=LAPLACE)
    got = post.map(lambda t: float(t.result))
    assert abs(float(got.mean) - mean) < 0.1 and abs(float(got.stddev) - std) < 0.1
    # the decoded Bernoulli is drawn from its exact conditional: both values occur
    ds = {int(v.value) for t in post.get_values()[:400] for v in t.variables if v.name == "d"}
    assert ds == {0, 1}


def test_linear_regression_laplace_is_exact():
    """tests/test_models_builtin.py:178-200: the conjugate Gaussian
    posterior's mean within 0.05 and its variances within 0.4 of the
    largest plus 0.003."""
    from pyprob_tpu_torch.models import BayesianLinearRegression

    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 2))
    m = BayesianLinearRegression(X)
    y = m.synthesize([1.5, -0.7], rng=1)
    mean, cov = m.true_posterior(y)
    lap = m.posterior(1500, observe={"y": y}, inference_engine=LAPLACE)
    draws = np.stack([np.asarray(t.result, np.float64) for t in lap.get_values()])
    assert np.abs(draws.mean(axis=0) - mean).max() < 0.05
    assert np.abs(draws.var(axis=0) - np.diag(cov)).max() < 0.4 * np.diag(cov).max() + 0.003


def test_laplace_errors():
    with pytest.raises(RuntimeError, match="observe"):
        TorchGUM().posterior_results(10, inference_engine=LAPLACE)

    class Host(pp.Model):
        _never_vectorize = True

        def forward(self):
            mu = pp.sample(TD.Normal(0.0, 1.0))
            pp.observe(TD.Normal(mu, 1.0), name="y")
            return mu

    with pytest.raises(RuntimeError, match="no interpreter tier"):
        Host().posterior_results(10, observe={"y": 1.0}, inference_engine=LAPLACE)
    with pytest.raises(RuntimeError, match="no interpreter tier"):
        Host().map_estimate(observe={"y": 1.0})
    with pytest.raises(NotImplementedError, match="distributed slice"):
        laplace.vectorized_laplace_posterior(TorchGUM(), 10, observe=OBSERVE, mesh=object())
    with pytest.raises(RuntimeError, match="requires observe"):
        TorchGUM().map_estimate()


def test_vector_observe_traces_hold_the_data_vector():
    """A data vector observed under a per-particle [N, D] batch (the
    regressions' ``y``) is recorded as the whole vector in every trace, as
    the JAX package records it (the batched tier kept the [D] value and
    indexed it by particle: an IndexError past D particles)."""
    from pyprob_tpu_torch.models import BayesianLinearRegression

    m = BayesianLinearRegression(np.random.default_rng(0).normal(size=(40, 2)))
    y = m.synthesize([1.5, -0.7], rng=1)
    traces = m.posterior(100, observe={"y": y}).get_values()
    for t in traces[::17]:
        (site,) = [v for v in t.variables if v.name == "y"]
        np.testing.assert_array_equal(np.asarray(site.value), np.asarray(y, np.float32))
