"""Stein variational gradient descent (``pyprob_tpu_torch.inference.svgd``)
on the CPU, against the JAX package.

(i) ``stein_phi`` at fixed ensembles from a numpy seed against the JAX
package's formula (pyprob_tpu/inference/svgd.py:211-226: the Gram-trick
distances, jnp.median's bandwidth, attraction and repulsion) on the scores
``jax.grad`` of the JAX ``fm.potential``, within 1e-5 (1 + |ref|); five
Adam steps of the ensemble against the JAX ``fit_fn`` from the same start,
within 1e-4 (1 + |ref|).  (ii) The JAX tests' criteria (tests/test_svgd.py,
512 particles and 600-800 steps) at 128 particles and the same steps
(fewer for the two-mode and enumerated models), the posterior moments
within the JAX tests' limits: the ensemble is deterministic given its
start, and at 128 particles its moments' error from the finite ensemble
is a few hundredths on these posteriors; the program
cache and the errors.  The JAX tests' own counts run on the card
(``chip_smoke.py``'s ``svgd``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyprob_tpu_torch as pp
from pyprob_tpu.inference import hmc as jhmc
from pyprob_tpu.inference import svgd as jsvgd
from pyprob_tpu_torch.inference import hmc, svgd
from pyprob_tpu_torch.vectorized import _TraceabilityCache

from _torch_parity import (
    OBSERVE,
    POSTERIOR_MEAN,
    POSTERIOR_STDDEV,
    JaxGUM,
    TorchGUM,
    bimodal_body,
    body_pair,
    hierarchy_body,
    mix_pair,
    mixture_posterior,
    positive_body,
    uniform_gum_body,
)

torch.set_num_threads(2)

SVGD = pp.InferenceEngine.STEIN_VARIATIONAL_GRADIENT_DESCENT
SMALL = {"svgd_particles": 128, "svgd_steps": 600}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    pp.set_verbosity(1)
    _TraceabilityCache._cache.clear()
    yield


def _close(mine, ref, tol=1e-5):
    mine, ref = np.asarray(mine, np.float64), np.asarray(ref, np.float64)
    assert mine.shape == ref.shape, (mine.shape, ref.shape)
    excess = np.abs(mine - ref) - tol * (1 + np.abs(ref))
    assert np.all(excess <= 0), (float(excess.max()), mine, ref)


def _jax_stein_phi(fm, z, obs):
    """pyprob_tpu/inference/svgd.py's stein_phi, as written there."""
    n = z.shape[0]
    g = jax.vmap(jax.grad(lambda v: -fm.potential(v, obs)))(z)
    sq = jnp.sum(z * z, axis=-1)
    d2 = jnp.maximum(sq[:, None] + sq[None, :] - 2.0 * (z @ z.T), 0.0)
    h = jnp.maximum(jnp.median(d2) / np.log(n + 1.0), 1e-6)
    k = jnp.exp(-d2 / h)
    return (k @ g + (2.0 / h) * (jnp.sum(k, axis=1)[:, None] * z - k @ z)) / n


@pytest.mark.parametrize("name,n", [("gum", 64), ("hierarchy", 48), ("hierarchy", 33)])
def test_stein_phi_and_steps_match_jax(name, n):
    if name == "gum":
        (jm, tm), observe = (JaxGUM(), TorchGUM()), OBSERVE
    else:
        (jm, tm), observe = body_pair(hierarchy_body), {"y": 2.0}
    jobs = {k: jnp.asarray(v, jnp.float32) for k, v in observe.items()}
    tobs = {k: pp.util.to_tensor(v, "cpu") for k, v in observe.items()}
    jfm = jhmc._functionalize(jm, jobs, 1.0, False, "STEIN_VARIATIONAL_GRADIENT_DESCENT", (), None)
    tfm = hmc._functionalize(tm, tobs, 1.0, "STEIN_VARIATIONAL_GRADIENT_DESCENT", (), None)
    rng = np.random.default_rng(n)
    z = (2.0 * rng.normal(size=(n, jfm.dim)) + 3.0).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: _jax_stein_phi(jfm, v, jobs))(jnp.asarray(z)))
    _, g = tfm.value_and_grad(torch.as_tensor(z), tobs)
    _close(svgd.stein_phi(torch.as_tensor(z), -g).numpy(), ref)
    fit_fn = jsvgd._build_svgd(jm, jobs, 1.0, n, False, (), None)[0]
    ref_z, ref_hist = fit_fn(5, 0.05, jnp.asarray(z), jobs)
    got_z, got_hist, graphed = svgd.fit(tfm, torch.as_tensor(z), tobs, 5, 0.05)
    assert not graphed
    _close(got_z.numpy(), np.asarray(ref_z), 1e-4)
    _close(got_hist.numpy(), np.asarray(ref_hist), 1e-4)


# ---------------------------------------------------------------------------
# (ii) the JAX tests' criteria at 128 particles
# ---------------------------------------------------------------------------


def test_svgd_gum_posterior():
    post = TorchGUM().posterior_results(500, observe=OBSERVE, inference_engine=SVGD, **SMALL)
    assert post.length == 500
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.1
    assert abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.15
    md = post.metadata[-1]
    assert md["latent_dim"] == 1 and md["svgd_particles"] == 128 and np.isfinite(md["final_mean_update_norm"])
    assert float(post.effective_sample_size) > 0.99 * 500
    # the default ensemble: min(max(n, 64), 1024) particles
    post = TorchGUM().posterior_results(100, observe=OBSERVE, inference_engine=SVGD, svgd_steps=5)
    assert post.metadata[-1]["svgd_particles"] == 100 and post.length == 100


def test_svgd_captures_correlation_without_guide():
    _, model = body_pair(hierarchy_body, both=True)
    post = model.posterior_results(128, observe={"y": 2.0}, inference_engine=SVGD, **SMALL)
    xs = np.asarray([np.asarray(v, np.float64) for v in post.get_values()])
    assert abs(xs[:, 0].mean() - 2.0 / 3.0) < 0.1 and abs(xs[:, 1].mean() - 4.0 / 3.0) < 0.1
    assert abs(np.corrcoef(xs[:, 0], xs[:, 1])[0, 1] - 0.5) < 0.15
    assert abs(xs[:, 0].std() - math.sqrt(2.0 / 3.0)) < 0.12


@pytest.mark.parametrize("support", ["bounded", "positive"])
def test_svgd_supports(support):
    if support == "bounded":
        _, model = body_pair(uniform_gum_body)
        post = model.posterior_results(256, observe=OBSERVE, inference_engine=SVGD, **SMALL)
        vals = np.asarray(post.values_numpy(), np.float64)
        assert vals.min() > 0.0 and vals.max() < 20.0
        assert abs(float(post.mean) - 8.5) < 0.15 and abs(float(post.stddev) - 1.0) < 0.15
    else:
        _, model = body_pair(positive_body)
        post = model.posterior_results(128, observe={"y": 2.0}, inference_engine=SVGD, **SMALL)
        assert np.asarray(post.values_numpy()).min() > 0.0 and abs(float(post.mean) - 1.76) < 0.12


def test_svgd_populates_both_modes():
    _, model = body_pair(bimodal_body, stddev=0.5)
    post = model.posterior_results(128, observe={"y": 4.0}, inference_engine=SVGD, svgd_particles=128,
                                   svgd_steps=400)
    vals = np.asarray(post.values_numpy(), np.float64)
    assert 0.2 < float(np.mean(vals > 0)) < 0.8 and abs(np.abs(vals).mean() - 2.0) < 0.2


def test_svgd_enumerates_discrete_sites():
    # the JAX test holds the moments against 400,000-draw prior IS; here
    # against the closed form, with 512 decoded draws of the 128 particles
    _, model = mix_pair()
    mean, std, _ = mixture_posterior("mix")
    post = model.posterior_results(512, observe={"y": 1.0}, inference_engine=SVGD, svgd_particles=128,
                                   svgd_steps=400)
    assert abs(float(post.mean) - mean) < 0.2 and abs(float(post.stddev) - std) < 0.2


def test_svgd_program_cache_reused_for_new_observation():
    # the JAX test's second run takes 100 steps, which leave the ensemble in
    # transit toward the new posterior (-2.75): its mean is below -2.0 in 4
    # of 8 seeds in the JAX package; 300 steps here
    model = TorchGUM()
    model.posterior_results(128, observe=OBSERVE, inference_engine=SVGD, svgd_particles=128, svgd_steps=50)
    n_cached = len(svgd._svgd_cache)
    post = model.posterior_results(128, observe={"obs0": -3.0, "obs1": -4.0}, inference_engine=SVGD,
                                   svgd_particles=128, svgd_steps=300)
    assert len(svgd._svgd_cache) == n_cached
    assert float(post.mean) < -2.0


class _Discrete(pp.Model):
    def forward(self):
        k = pp.sample(pp.distributions.Categorical(probs=[0.3, 0.7]))
        pp.observe(pp.distributions.Normal(1.0 * k, 1.0), name="y")
        return k


class _Untraceable(pp.Model):
    def forward(self):
        mu = pp.sample(pp.distributions.Normal(0.0, 1.0))
        if float(mu) > 0:
            mu = mu + 0.0
        pp.observe(pp.distributions.Normal(mu, 1.0), name="y")
        return mu


def test_svgd_errors():
    with pytest.raises(RuntimeError, match="no continuous latent"):
        _Discrete().posterior(num_traces=100, observe={"y": 1.0}, inference_engine=SVGD)
    with pytest.raises(RuntimeError, match="no interpreter tier"):
        _Untraceable().posterior(num_traces=100, observe={"y": 1.0}, inference_engine=SVGD)
    with pytest.raises(RuntimeError, match="observe"):
        TorchGUM().posterior(num_traces=100, inference_engine=SVGD)
