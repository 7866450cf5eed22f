"""The port's guided-IS serving slice as a whole, against the JAX package.

(i) Deterministic: a JAX LSTM network for GUM (untrained: constructor plus
layer pre-generation) is carried into the port; both packages score the
same 64 forced values of ``mu`` through their proposal steps and batched
handlers, and their log q and log importance weights agree.
(ii) Statistical: the port's prior IS and guided IS match the analytic
posterior.  (iii) The two packages give GUM's sites equal addresses.
(iv) Nothing in the port or in its card scripts imports JAX or the JAX
package.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pyprob_tpu  # noqa: F401
import pyprob_tpu_torch
from pyprob_tpu import vectorized as jax_vectorized
from pyprob_tpu.util import InferenceEngine as JEngine, TraceMode as JMode
from pyprob_tpu_torch import vectorized as torch_vectorized
from pyprob_tpu_torch.models import GaussianUnknownMean
from pyprob_tpu_torch.util import InferenceEngine as TEngine, TraceMode as TMode

from _torch_parity import (
    OBSERVE,
    POSTERIOR_MEAN,
    POSTERIOR_STDDEV,
    JaxGUM,
    TorchGUM,
    carry,
    jax_network,
)

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyprob_tpu_torch.set_device("cpu")
    pyprob_tpu_torch.seed(0)
    yield


@pytest.fixture(scope="module")
def models():
    pyprob_tpu_torch.set_device("cpu")
    jm, tm = JaxGUM(), TorchGUM()
    jnet = jax_network(jm)
    jm._inference_network = jnet
    carry(jnet, tm)
    return jm, tm


def _forced(step, forced_value, captured):
    """A proposal step that scores ``forced_value`` instead of sampling."""

    def forced_step(site, distribution, rng, observed, **kwargs):
        value, log_q = step(site, distribution, rng, observed, forced_value=forced_value)
        captured["log_q"] = log_q
        return value, log_q

    forced_step.reset = step.reset
    return forced_step


def test_forced_values_score_alike(models):
    jm, tm = models
    mus = np.random.default_rng(5).normal(7.0, 2.5, 64).astype(np.float32)
    obs_j = {k: jnp.float32(v) for k, v in OBSERVE.items()}
    jstep = jm._inference_network.make_vectorized_proposal_step(OBSERVE)

    def one(key, mu):
        captured = {}
        out, _ = jax_vectorized.run_traced(
            jm, key, obs_j, JMode.POSTERIOR,
            JEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
            proposal_step=_forced(jstep, mu, captured),
        )
        return captured["log_q"], out["log_importance_weight"]

    keys = jax.random.split(jax.random.PRNGKey(0), 64)
    jlog_q, jlw = jax.jit(jax.vmap(one))(keys, jnp.asarray(mus))

    captured = {}
    tstep = tm._inference_network.make_vectorized_proposal_step(OBSERVE)
    out, handler = torch_vectorized.run_traced(
        tm, 64, {k: torch.tensor(v) for k, v in OBSERVE.items()}, TMode.POSTERIOR,
        TEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
        proposal_step=_forced(tstep, torch.from_numpy(mus), captured),
    )
    np.testing.assert_allclose(captured["log_q"].numpy(), np.asarray(jlog_q), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        out["log_importance_weight"].numpy(), np.asarray(jlw), atol=1e-4, rtol=0
    )
    np.testing.assert_array_equal(out["result"].numpy(), mus)
    assert [s.address for s in handler.sites] == [
        a for a in out["log_probs"]
    ]


def test_prior_and_guided_is_match_the_posterior(models):
    _, tm = models
    for engine in (TEngine.IMPORTANCE_SAMPLING, TEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK):
        post = tm.posterior_results(20_000, inference_engine=engine, observe=OBSERVE)
        assert abs(post.mean - POSTERIOR_MEAN) < 0.3, (engine, post.mean)
        assert abs(post.stddev - POSTERIOR_STDDEV) < 0.3, (engine, post.stddev)
        # the result's ESS is the log-weight statistics kernel's
        np.testing.assert_allclose(
            post.effective_sample_size,
            pyprob_tpu_torch.util.effective_sample_size(post.log_weights),
            rtol=1e-4,
        )
        assert post.effective_sample_size > 50


def test_builtin_gum_runs_on_the_batched_tier():
    model = GaussianUnknownMean()
    post = model.posterior_results(20_000, observe=OBSERVE)
    assert abs(post.mean - POSTERIOR_MEAN) < 0.3
    prior = model.prior_results(5_000)
    assert abs(prior.mean - 1.0) < 0.2 and prior.effective_sample_size == 5_000
    # prior weights stay uniform under inflation (the JAX package's prior
    # semantics): the draws are the inflated prior, 3x the stddev
    inflated = model.prior_results(20_000, prior_inflation=pyprob_tpu_torch.PriorInflation.ENABLED)
    assert abs(inflated.stddev - 3 * 5**0.5) < 0.3
    # likelihood_importance 0 removes the observations' weight: the prior
    flat = model.posterior_results(20_000, observe=OBSERVE, likelihood_importance=0.0)
    assert abs(flat.mean - 1.0) < 0.1 and flat.effective_sample_size == 20_000


def test_sites_get_equal_addresses(models):
    jm, tm = models
    (jtrace,) = jm.prior(num_traces=1).get_values()
    (ttrace,) = tm.prior(num_traces=1).get_values()
    jaddr = [v.address for v in jtrace.variables]
    assert [v.address for v in ttrace.variables] == jaddr
    assert jaddr[0].endswith("__forward__gum_body__mu__Normal__1")
    assert set(tm._inference_network._params["proposal"]) == {jaddr[0]}


def test_unsupported_paths_raise():
    model = GaussianUnknownMean()
    # VI runs on the batched tier only: a short run there, and the gradient
    # engines' error on the interpreter tier
    post = model.posterior_results(
        10, observe=OBSERVE, inference_engine=TEngine.VARIATIONAL_INFERENCE, vectorized=None, vi_steps=5,
    )
    assert post.length == 10 and post.metadata[-1]["guide"] == "meanfield"
    with pytest.raises(RuntimeError, match="no interpreter tier"):
        model.posterior_results(
            10, observe=OBSERVE, inference_engine=TEngine.VARIATIONAL_INFERENCE, vectorized=False,
        )
    with pytest.raises(RuntimeError, match="No inference network"):
        model.posterior_results(
            10, observe=OBSERVE,
            inference_engine=TEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
        )

    class Branching(pyprob_tpu_torch.Model):
        def forward(self):
            x = pyprob_tpu_torch.sample(pyprob_tpu_torch.distributions.Normal(0.0, 1.0))
            return x if x > 0 else -x

    # vectorized=None runs such a model on the interpreter tier instead
    with pytest.raises(NotImplementedError, match="branches on sampled values"):
        Branching().prior_results(10, vectorized=True)


def test_cuda_is_the_default_device():
    pyprob_tpu_torch.set_device("cuda")
    if torch.cuda.is_available():
        assert pyprob_tpu_torch.util.device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="set_device"):
            GaussianUnknownMean().posterior_results(10, observe=OBSERVE)


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_never_imports_jax():
    files = sorted((REPO / "pyprob_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py",
        REPO / "profile_guided_is.py",
        REPO / "profile_train.py",
    ]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "pyprob_tpu"), (path, name)
