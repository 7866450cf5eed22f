"""The port's GP slice against the JAX package: MultivariateNormal,
GaussianProcessRegression, and the batched tier's OOM back-off.

Deterministic parts take the same numpy inputs in both packages; prior IS
is held against the grid-integrated posterior, as
tests/test_models_builtin.py holds the JAX package's.
"""

import math
import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu.distributions import MultivariateNormal as JaxMVN
from pyprob_tpu.models import GaussianProcessRegression as JaxGP
from pyprob_tpu_torch import vectorized
from pyprob_tpu_torch.distributions import MultivariateNormal
from pyprob_tpu_torch.models import GaussianProcessRegression

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    pp.set_device("cpu")
    pp.seed(0)
    monkeypatch.setattr(vectorized, "_oom_batch_limit", {})
    yield


def _gp(n, learn=("lengthscale",)):
    m = GaussianProcessRegression(np.linspace(0, 4, n), learn=learn, noise=0.2)
    return m, m.synthesize(rng=3, lengthscale=1.0)


def _mvn_inputs(B=4, k=5, seed=0):
    rng = np.random.default_rng(seed)
    loc = rng.normal(size=(B, k)).astype(np.float32)
    X = rng.normal(size=(B, k, k))
    cov = (X @ X.transpose(0, 2, 1) / k + np.eye(k)).astype(np.float32)
    value = rng.normal(size=(B, k)).astype(np.float32)
    return loc, cov, value


def test_mvn_matches_jax():
    # shared batched inputs: log_prob, moments, shapes and the address
    # suffix; float32 Cholesky on both sides, 1e-5 + 1e-5 |ref|
    loc, cov, value = _mvn_inputs()
    mine = MultivariateNormal(torch.from_numpy(loc), covariance_matrix=torch.from_numpy(cov))
    ref = JaxMVN(jnp.asarray(loc), covariance_matrix=jnp.asarray(cov))
    assert mine.address_suffix == ref.address_suffix == "MultivariateNormal(len:5)"
    assert tuple(mine.batch_shape) == tuple(ref.batch_shape) == (4,)
    assert tuple(mine.event_shape) == tuple(ref.event_shape) == (5,)

    @jax.jit  # one compile is cheaper than op-by-op dispatch
    def jax_side(loc, cov, value):
        d = JaxMVN(loc, covariance_matrix=cov)
        return (d.log_prob(value), d.log_prob(value[0]), d.mean, d.variance,
                d.covariance_matrix, d.scale_tril, d.log_prob(value, sum=True))

    refs = jax_side(jnp.asarray(loc), jnp.asarray(cov), jnp.asarray(value))
    v = torch.from_numpy(value)
    mines = (mine.log_prob(v), mine.log_prob(v[0]), mine.mean, mine.variance,
             mine.covariance_matrix, mine.scale_tril, mine.log_prob(v, sum=True))
    for got, want in zip(mines, refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    tril = MultivariateNormal(torch.from_numpy(loc[0]), scale_tril=mine.scale_tril[0])
    np.testing.assert_allclose(tril.log_prob(v[0]).numpy(), np.asarray(refs[0][0]), rtol=1e-5)
    with pytest.raises(ValueError):
        MultivariateNormal(torch.zeros(3))


def test_mvn_samples_have_its_moments():
    # 40,000 draws of one 3-d MVN: mean within 0.03, covariance within 0.05
    # (about 5 standard errors)
    loc, cov, _ = _mvn_inputs(B=1, k=3, seed=1)
    d = MultivariateNormal(torch.from_numpy(loc[0]), covariance_matrix=torch.from_numpy(cov[0]))
    x = d.sample(sample_shape=(40_000,)).numpy().astype(np.float64)
    assert x.shape == (40_000, 3)
    np.testing.assert_allclose(x.mean(0), loc[0], atol=0.03)
    np.testing.assert_allclose(np.cov(x.T), cov[0], atol=0.05)


def test_gp_addresses_and_shapes_match_jax():
    learn = ("lengthscale", "noise")
    m, y = _gp(8, learn)
    jm = JaxGP(np.linspace(0, 4, 8), learn=learn, noise=0.2)
    pyprob_tpu.set_verbosity(0)
    jtrace = jm.prior(num_traces=1, vectorized=False).get_values()[0]
    trace = m.prior(num_traces=3).get_values()[0]
    mine = [(v.address, v.name, v.observed) for v in trace.variables]
    ref = [(v.address, v.name, v.observed) for v in jtrace.variables]
    # the sampled sites carry explicit addresses; the observe's embeds its
    # own source line, so it is compared without it
    assert mine[:2] == ref[:2] == [
        ("log_lengthscale__Normal__1", None, False),
        ("log_noise__Normal__1", None, False),
    ]
    assert mine[2][0].split("__", 1)[1] == ref[2][0].split("__", 1)[1] == "forward__?__MultivariateNormal(len:8)__1"
    assert mine[2][1] == ref[2][1] == "y"
    assert np.asarray(trace.result).shape == (2,)


def _forced_step(values):
    """A proposal step that proposes the given [n] values with log q = 0."""

    def step(site, distribution, generator, observed, **kwargs):
        return values[site.address_base], torch.zeros(len(values[site.address_base]))

    step.reset = lambda n: None
    return step


def test_gp_log_likelihood_matches_jax_and_float64():
    # numpy-chosen hyperparameters through the port's forward (the observe's
    # log-density per particle), the JAX package's kernel build and
    # MultivariateNormal, and the float64 marginal likelihood; N = 25, log
    # likelihoods of magnitude <= 100, float32: 2e-3 absolute
    learn = ("lengthscale", "amplitude", "noise")
    m, y = _gp(25, learn)
    jm = JaxGP(np.linspace(0, 4, 25), learn=learn, noise=0.2)
    rng = np.random.default_rng(5)
    logs = {name: rng.uniform(-1.0, 1.0, 16).astype(np.float32) for name in learn}
    logs["noise"] = rng.uniform(-2.0, -1.0, 16).astype(np.float32)
    forced = {f"log_{k}__Normal": torch.from_numpy(v) for k, v in logs.items()}
    outputs, _ = vectorized.run_traced(
        m, 16, {"y": y}, pp.TraceMode.POSTERIOR,
        pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
        proposal_step=_forced_step(forced),
    )
    mine = outputs["log_prob_observed"].numpy()

    @jax.jit
    def jax_log_lik(ell, amp, noise, y):
        cov = jm._cov(jnp, jm._sq_dists_j, ell, amp, noise)
        return JaxMVN(jnp.zeros(25), covariance_matrix=cov).log_prob(y)

    hyper = (jnp.asarray(np.exp(logs[k])[:, None, None]) for k in learn)
    jax_ll = np.asarray(jax_log_lik(*hyper, jnp.asarray(y, jnp.float32)))
    exact = np.array([
        m._log_marglik(y, *(math.exp(float(logs[k][i])) for k in learn)) for i in range(16)
    ])
    assert np.abs(exact).max() < 100
    np.testing.assert_allclose(mine, jax_ll, atol=2e-3, rtol=0)
    np.testing.assert_allclose(mine, exact, atol=2e-3, rtol=0)
    np.testing.assert_allclose(
        outputs["result"].numpy(), np.stack([logs[k] for k in learn], axis=-1), rtol=1e-6, atol=1e-6
    )


def test_gp_kernel_matrix_matches_jax_build():
    # the port's in-place build against the JAX package's expression on the
    # same float32 hyperparameters: equal to 1 ulp of exp
    m, _ = _gp(16, ("lengthscale", "amplitude", "noise"))
    jm = JaxGP(np.linspace(0, 4, 16), learn=("lengthscale",), noise=0.2)
    rng = np.random.default_rng(6)
    h = [rng.uniform(0.3, 2.0, 4).astype(np.float32) for _ in range(3)]
    K = m._cov_batched(m._sq_dists_tensor(torch.device("cpu")), (4,), *map(torch.from_numpy, h))
    build = jax.jit(lambda *h: jm._cov(jnp, jm._sq_dists_j, *h))
    ref = build(*(jnp.asarray(v[:, None, None]) for v in h))
    assert K.shape == (4, 16, 16) and K.is_contiguous()
    np.testing.assert_allclose(K.numpy(), np.asarray(ref), rtol=3e-7, atol=0)
    # fixed lengthscale, learned amplitude: still one matrix per particle
    K2 = m._cov_batched(m._sq_dists_tensor(torch.device("cpu")), (4,), 1.0, torch.from_numpy(h[1]), 0.2)
    assert K2.shape == (4, 16, 16)
    np.testing.assert_allclose(K2[:, 0, 0].numpy(), h[1] ** 2 + np.float32(0.040001), rtol=1e-6)


def test_gp_prior_is_matches_grid_posterior():
    # the JAX package's test (tests/test_models_builtin.py): N = 25, 4,000
    # traces, posterior mean within 0.6 grid stddevs
    m, y = _gp(25)
    gmean, gstd = m.true_posterior_moments(y)
    post = m.posterior_results(4000, observe={"y": y})
    mean = float(np.asarray(post.mean).reshape(-1)[0])
    assert abs(mean - gmean) < 0.6 * gstd
    assert post.length == 4000 and 0.1 < post.effective_sample_size / 4000 < 0.5


def test_traces_keep_shared_mvn_loc_when_n_equals_chunk():
    # 25 traces of an N = 25 GP: the MVN's shared loc [25] is as long as the
    # chunk; it must stay one [25] vector per trace, not one entry each
    m, y = _gp(25)
    post = m.posterior(25, observe={"y": y})
    for t in post.get_values()[:3]:
        site = t.variables[1]
        d = site.distribution
        assert d.loc.shape == (25,) and d.scale_tril.shape == (25, 25)
        np.testing.assert_array_equal(np.asarray(site.value), y.astype(np.float32))
        assert float(d.log_prob(torch.as_tensor(site.value))) == pytest.approx(float(site.log_prob), rel=1e-5)


class _ObserveLatent(pp.Model):
    """Observes a value computed from the latent: one value per particle."""

    def forward(self):
        mu = pp.sample(pp.distributions.Normal(0.0, 1.0))
        pp.observe(pp.distributions.Normal(0.0, 1.0), value=2.0 * mu, name="twice")
        pp.observe(pp.distributions.Normal(mu, 1.0), value=0.5, name="half")
        return mu


def test_traces_keep_per_particle_observe_value():
    # a value= observe computed from latents keeps one entry per trace; a
    # shared scalar observe is the same in every trace
    post = _ObserveLatent().posterior(6)
    for t in post.get_values():
        mu, twice, half = (v.value for v in t.variables)
        assert np.asarray(twice).shape == () and float(twice) == pytest.approx(2.0 * float(mu))
        assert float(half) == 0.5
        assert float(t.variables[1].log_prob) == pytest.approx(-2.0 * float(mu) ** 2 - 0.5 * math.log(2 * math.pi), rel=1e-5)


def _flaky_run_traced(monkeypatch, fail_above):
    real = vectorized.run_traced
    calls = []

    def run_traced(model, num_particles, *args, **kwargs):
        calls.append(num_particles)
        if num_particles > fail_above:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real(model, num_particles, *args, **kwargs)

    monkeypatch.setattr(vectorized, "run_traced", run_traced)
    return calls


def test_oom_backoff_halves_chunks_and_remembers(monkeypatch):
    m, y = _gp(6)
    calls = _flaky_run_traced(monkeypatch, fail_above=64)
    pp.seed(1)
    with pytest.warns(UserWarning, match="device OOM at") as record:
        post = m.posterior(200, observe={"y": y})
    assert [str(w.message) for w in record] == [
        "device OOM at 200 particles/dispatch; retrying with chunks of 100",
        "device OOM at 100 particles/dispatch; retrying with chunks of 50",
    ]
    assert calls == [200, 100, 50, 50, 50, 50]
    assert vectorized._oom_batch_limit[id(m)] == 50
    # the chunk sizes reach the traces: each trace's site parameters are its own
    assert post.length == 200
    for t in post.get_values()[::37]:
        lg = float(t.variables[0].value)
        assert float(np.asarray(t.result)[0]) == pytest.approx(lg, rel=1e-6)
        np.testing.assert_array_equal(np.asarray(t.variables[1].value), y.astype(np.float32))
    # a second call starts at the learned cap, without a warning, and with
    # the same seed gives the same weights and ESS
    del calls[:]
    pp.seed(1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = m.posterior(200, observe={"y": y})
    assert calls == [50, 50, 50, 50]
    np.testing.assert_array_equal(again.log_weights, post.log_weights)
    assert again.effective_sample_size == post.effective_sample_size


def test_oom_at_one_particle_is_raised(monkeypatch):
    m, y = _gp(6)
    calls = _flaky_run_traced(monkeypatch, fail_above=0)
    with pytest.warns(UserWarning), pytest.raises(torch.cuda.OutOfMemoryError):
        m.posterior_results(4, observe={"y": y})
    assert calls == [4, 2, 1]
