"""Tempered SMC (``pyprob_tpu_torch.inference.tempered_smc``) on the CPU,
against the JAX package.

(i) A stage's decisions on given parts lp, ll [N, G]: the incremental
log-weights, their log ESS from kernel 3's three sums (its plain version
here), the next temperature (the check at 1 and 26 bisection steps) and
the log Z increment, against the JAX stage's own expressions
(pyprob_tpu/inference/tempered_smc.py:259-296) in ``jnp``: weights and log
ESS within 1e-5 (1 + |ref|), the temperature within 1e-6 (the two
packages' sums round apart in the last bits, and no step's comparison is
that close on these draws).  (ii) The JAX tests' criteria
(tests/test_tempered_smc.py) at the JAX tests' own particle counts, which
run in about a second each on the CPU, and the errors.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyprob_tpu_torch as pp
from pyprob_tpu_torch.inference import tempered_smc as tsmc
from pyprob_tpu_torch.vectorized import _TraceabilityCache

from _torch_parity import (
    OBSERVE,
    POSTERIOR_MEAN,
    POSTERIOR_STDDEV,
    TorchGUM,
    bimodal_body,
    body_pair,
    depmix_pair,
    hierarchy_body,
    mix_pair,
    mixture_posterior,
)

torch.set_num_threads(2)

TSMC = pp.InferenceEngine.TEMPERED_SMC
GUM_LOG_Z = -8.2395


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


@jax.jit
def _jax_stage(LP, LL, beta, log_target_ess):
    """The JAX stage's temperature and evidence arithmetic, as written in
    pyprob_tpu/inference/tempered_smc.py:265-296."""
    lse = jax.scipy.special.logsumexp
    cur = lse(LP + beta * LL, axis=-1)

    def weights_at(b):
        return lse(LP + b * LL, axis=-1) - cur

    def ess_at(b):
        w = weights_at(b)
        return 2.0 * lse(w) - lse(2.0 * w)

    full_ok = ess_at(jnp.ones((), jnp.float32)) >= log_target_ess

    def bis(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= log_target_ess
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

    lo, hi = jax.lax.fori_loop(0, 26, bis, (beta, jnp.ones((), jnp.float32)))
    new_beta = jnp.where(full_ok, 1.0, 0.5 * (lo + hi))
    new_beta = jnp.minimum(jnp.maximum(new_beta, beta + 1e-5), 1.0)
    w = weights_at(new_beta)
    n = LP.shape[0]
    return new_beta, w, ess_at(jnp.float32(0.5) * (beta + 1.0)), lse(w) - jnp.log(jnp.asarray(n, jnp.float32))


# (N, G, β, scale of ll, threshold): a bisected step, an enumerated model's
# parts, a step that reaches 1 at once, a late step near 1
STAGES = [
    (4096, 1, 0.0, 30.0, 0.5),
    (2048, 3, 0.1, 10.0, 0.5),
    (1024, 1, 0.3, 0.05, 0.5),
    (8192, 2, 0.97, 200.0, 0.7),
]


@pytest.mark.parametrize("n,g,beta,scale,threshold", STAGES)
def test_stage_decisions_match_jax(n, g, beta, scale, threshold):
    rng = np.random.default_rng(n + g)
    lp = rng.normal(size=(n, g)).astype(np.float32)
    ll = (-scale * np.abs(rng.normal(size=(n, g)))).astype(np.float32)
    target = float(np.log(np.float32(threshold * n)))
    ref_beta, ref_w, ref_ess_mid, ref_inc = (
        np.asarray(a) for a in _jax_stage(jnp.asarray(lp), jnp.asarray(ll), jnp.float32(beta), jnp.float32(target))
    )
    tlp, tll, tb = torch.as_tensor(lp), torch.as_tensor(ll), torch.tensor(beta, dtype=torch.float32)
    got_beta = tsmc.next_temperature(tlp, tll, tb, torch.log(torch.tensor(threshold * n, dtype=torch.float32)))
    assert abs(float(got_beta) - float(ref_beta)) <= 1e-6, (float(got_beta), float(ref_beta))
    w = tsmc.incremental_weights(tlp, tll, tb, torch.tensor(float(ref_beta)))
    _close(w.numpy(), ref_w)
    _close(tsmc.log_mean_weight(w).numpy(), ref_inc)
    mid = torch.tensor(0.5 * (beta + 1.0), dtype=torch.float32)
    _close(tsmc.log_ess(tsmc.incremental_weights(tlp, tll, tb, mid)).numpy(), ref_ess_mid)
    if scale < 1.0:
        assert float(got_beta) == 1.0
    else:
        # the chosen step holds the incremental weights' ESS at the target
        ess = float(torch.exp(tsmc.log_ess(w)))
        assert float(got_beta) < 1.0 and abs(ess / (threshold * n) - 1.0) < 1e-3


def test_log_mean_weight_of_no_weight():
    w = torch.full((16,), -math.inf)
    assert float(tsmc.log_mean_weight(w)) == -math.inf
    assert not bool(tsmc.log_ess(w) >= 0.0)


# ---------------------------------------------------------------------------
# (ii) the JAX tests' criteria at their own counts
# ---------------------------------------------------------------------------


def test_tempered_smc_gum_posterior_and_evidence():
    post = TorchGUM().posterior_results(8000, observe=OBSERVE, inference_engine=TSMC)
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.1
    assert abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.1
    assert abs(post.log_evidence - GUM_LOG_Z) < 0.15
    md = post.metadata[-1]
    assert md["final_beta"] == 1.0 and md["stages"] >= 2 and 0.2 < md["acceptance_rate"] <= 1.0
    assert md["host_syncs"] == md["stages"] and md["log_evidence"] == post.log_evidence
    assert {"final_step_size", "rejuvenation_steps", "leapfrog_steps", "resampling"} <= set(md)


def test_tempered_smc_hierarchy_evidence():
    _, model = body_pair(hierarchy_body)
    post = model.posterior_results(8000, observe={"y": 2.0}, inference_engine=TSMC)
    assert abs(float(post.mean) - 2.0 / 3.0) < 0.08
    assert abs(post.log_evidence - (-2.135)) < 0.1


def test_tempered_smc_multimodal_transport():
    _, model = body_pair(bimodal_body)
    post = model.posterior_results(8000, observe={"y": 16.0}, inference_engine=TSMC)
    vals = np.asarray(post.values_numpy(), np.float64)
    assert abs(float(np.mean(np.abs(vals))) - 4.0) < 0.15
    assert 0.3 < float(np.mean(vals > 0)) < 0.7


@pytest.mark.parametrize("name,n", [("mix", 8000), ("depmix", 12000)])
def test_tempered_smc_enumerates_discrete_sites(name, n):
    # the JAX tests hold the moments against 400,000-draw prior IS; here
    # against the closed form, at the JAX tests' counts and tolerances
    _, model = mix_pair() if name == "mix" else depmix_pair()
    mean, std, log_z = mixture_posterior(name)
    post = model.posterior_results(n, observe={"y": 1.0}, inference_engine=TSMC)
    tol = 0.12 if name == "mix" else 0.1
    assert abs(float(post.mean) - mean) < tol and abs(float(post.stddev) - std) < tol
    if name == "depmix":
        assert abs(post.log_evidence - (-2.984)) < 0.12 and abs(log_z - (-2.984)) < 1e-3


@pytest.mark.parametrize("resampling", ["systematic", "stratified", "residual", "multinomial"])
def test_tempered_smc_knobs(resampling):
    # tests/test_tempered_smc.py:110-128's knobs at its 4,000 particles,
    # under each resampling scheme
    post = TorchGUM().posterior_results(4000, observe=OBSERVE, inference_engine=TSMC, resample_threshold=0.7,
                                        rejuvenation_steps=3, leapfrog_steps=5, resampling=resampling)
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.15
    md = post.metadata[-1]
    assert md["rejuvenation_steps"] == 3 and md["leapfrog_steps"] == 5 and md["resampling"] == resampling
    capped = TorchGUM().posterior_results(400, observe=OBSERVE, inference_engine=TSMC, max_stages=1,
                                          resampling=resampling)
    assert capped.metadata[-1]["stages"] == 1 and capped.metadata[-1]["final_beta"] < 1.0


class _NotTraceable(pp.Model):
    def forward(self):
        while True:
            x = pp.sample(pp.distributions.Uniform(0.0, 1.0))
            if float(x) < 0.5:
                break
        pp.observe(pp.distributions.Normal(float(x), 1.0), name="y")
        return x


def test_tempered_smc_errors():
    with pytest.raises(RuntimeError, match="no interpreter tier"):
        _NotTraceable().posterior(num_traces=100, observe={"y": 0.1}, inference_engine=TSMC)
    with pytest.raises(RuntimeError, match="observe"):
        TorchGUM().posterior(num_traces=100, inference_engine=TSMC)
    with pytest.raises(ValueError, match="Unknown resampling scheme"):
        TorchGUM().posterior(num_traces=100, observe=OBSERVE, inference_engine=TSMC, resampling="bogus")
    with pytest.raises(RuntimeError, match="no interpreter tier"):
        TorchGUM().posterior(num_traces=100, observe=OBSERVE, inference_engine=TSMC, vectorized=False)
