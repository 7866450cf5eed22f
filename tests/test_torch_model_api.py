"""The rest of the port's Model API on the CPU, with the JAX package's tests'
criteria: ``posterior_predictive`` (tests/test_model.py:179-200) on
posteriors from batched IS, the LMH interpreter chain and lockstep IC;
``condition`` / ``filter`` and ``ConditionalModel`` with its timeout
(tests/test_model.py:147-166); and ``ParallelModel`` over 2 spawned
workers (tests/test_model_parallel.py): prior, IS, file mode with its
chunk files, guided IC by lockstep inside each worker, and the refusal of
MCMC.  The signatures are held to the JAX package's."""

import glob
import inspect
import math

import numpy as np
import pytest
import torch

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu_torch.distributions import Normal, Uniform
from pyprob_tpu_torch.models import GaussianUnknownMean

from _torch_parity import OBSERVE, POSTERIOR_MEAN, POSTERIOR_STDDEV

torch.set_num_threads(2)

LMH = pp.InferenceEngine.LIGHTWEIGHT_METROPOLIS_HASTINGS
IC = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    pp.set_verbosity(1)
    yield


def test_signatures_match_the_jax_package():
    def params(fn):  # names and kinds (the defaults are each package's own enums and functions)
        return [(p.name, p.kind) for p in inspect.signature(fn).parameters.values()]

    for name in ("posterior_predictive", "posterior_predictive_results", "condition", "filter", "parallel",
                 "posterior_results"):
        assert params(getattr(pp.Model, name)) == params(getattr(pyprob_tpu.Model, name)), name
    for cls in ("ConditionalModel", "ParallelModel"):
        assert params(getattr(pp, cls).__init__) == params(getattr(pyprob_tpu, cls).__init__)
    # the engines' arguments of later slices (vi_steps on) are not taken yet
    assert params(pp.Model.posterior)[:16] == params(pyprob_tpu.Model.posterior)[:16]
    assert {"ChainState", "ConditionalModel", "ParallelModel"} <= set(pp.__all__)


def _predictive_obs0(pred):
    vals = [float(v.value) for t in pred.get_values() for v in t.variables if v.name == "obs0"]
    return np.asarray(vals)


def test_posterior_predictive_batched_is():
    # tests/test_model.py:179-200: the predictive of obs0 is N(7.25, 1/1.2 + 2)
    m = GaussianUnknownMean()
    post = m.posterior(num_traces=20000, observe={"obs0": 8.0, "obs1": 9.0}, vectorized=True)
    pred = m.posterior_predictive(post, num_traces=3000)
    obs = _predictive_obs0(pred)
    assert len(obs) == 3000
    assert abs(obs.mean() - 7.25) < 0.2
    assert abs(obs.std() - math.sqrt(1 / 1.2 + 2.0)) < 0.2
    # the latents are pinned to posterior draws: every predictive mu is one
    # of the posterior's values
    mus = set(np.asarray(post.map(lambda t: float(t.result)).values_numpy()).tolist())
    assert all(float(t.result) in mus for t in pred.get_values()[:200])


def test_posterior_predictive_mcmc_and_lockstep_ic():
    m = GaussianUnknownMean()
    lmh = m.posterior(num_traces=4000, inference_engine=LMH, observe=OBSERVE, vectorized=False)[1500:]
    pred = m.posterior_predictive_results(lmh, num_traces=2000)
    # results are the pinned latents; their mean is the chain's
    assert abs(float(pred.mean) - float(lmh.map(lambda t: float(t.result)).mean)) < 0.15
    obs = _predictive_obs0(m.posterior_predictive(lmh, num_traces=2000))
    assert abs(obs.mean() - 7.25) < 0.3

    m.learn_inference_network(
        num_traces=2048, observe_embeddings={"obs0": {"dim": 8}, "obs1": {"dim": 8}},
        inference_network=pp.InferenceNetwork.LSTM, lstm_dim=32, batch_size=128, learning_rate_init=0.01,
    )
    guided = m.posterior(num_traces=2000, inference_engine=IC, observe=OBSERVE, vectorized=False)
    assert guided.metadata[0].get("lockstep_workers")
    obs = _predictive_obs0(m.posterior_predictive(guided, num_traces=2000))
    assert abs(obs.mean() - 7.25) < 0.3
    with pytest.raises(RuntimeError, match="trace-valued posterior"):
        m.posterior_predictive(m.posterior_results(100, observe=OBSERVE), num_traces=3)


class _Uniform01(pp.Model):
    def forward(self):
        return float(pp.sample(Uniform(0.0, 1.0)))


def test_conditional_model():
    # tests/test_model.py:147-158
    cond = _Uniform01().condition(lambda trace: trace.result > 0.8)
    assert isinstance(cond, pp.ConditionalModel)
    prior = cond.prior_results(num_traces=200)
    vals = np.asarray(prior.get_values())
    assert (vals > 0.8).all()
    assert 0.05 < cond.acceptance_ratio < 0.45
    # filter is the deprecated name of condition
    with pytest.warns(UserWarning, match="deprecated"):
        filtered = _Uniform01().filter(lambda trace: trace.result < 0.5)
    assert (np.asarray(filtered.prior_results(num_traces=50, vectorized=True).get_values()) < 0.5).all()


def test_conditional_model_timeout():
    # tests/test_model.py:161-166
    cond = _Uniform01().condition(lambda trace: False, criterion_timeout=50)
    with pytest.raises(RuntimeError, match="Timeout"):
        cond.prior_results(num_traces=1)


class _HalfObserved(pp.Model):
    def forward(self):
        x = pp.sample(Normal(0.0, 1.0))
        pp.observe(Normal(x, 1.0), name="y")
        return x


def test_conditional_model_posterior_is_interpreter_only():
    # the criterion x > 0 cuts the posterior N(0, sqrt(1/2)) of y = 0 to its
    # half-normal, with mean sqrt(1/2) sqrt(2/pi); IS from the prior, the
    # conditional model on the interpreter tier whatever vectorized asks
    cond = _HalfObserved().condition(lambda trace: float(trace.result) > 0.0)
    post = cond.posterior_results(num_traces=4000, observe={"y": 0.0}, vectorized=True)
    assert "batched" not in post.name and (post.values_numpy() > 0.0).all()
    assert abs(float(post.mean) - math.sqrt(0.5) * math.sqrt(2 / math.pi)) < 0.05
    assert 0.4 < cond.acceptance_ratio < 0.6


def test_parallel_prior_and_is():
    # tests/test_model_parallel.py:16-27
    model = GaussianUnknownMean().parallel(num_workers=2)
    assert isinstance(model, pp.ParallelModel)
    prior = model.prior_results(num_traces=200)
    assert prior.length == 200
    assert abs(float(prior.mean) - 1.0) < 0.6
    post = model.posterior_results(num_traces=400, observe={"obs0": 8, "obs1": 9})
    assert post.length == 400
    assert abs(float(post.mean) - 7.25) < 1.2


def test_parallel_rejects_mcmc():
    # tests/test_model_parallel.py:30-37
    model = GaussianUnknownMean().parallel(num_workers=2)
    with pytest.raises(ValueError):
        model.posterior(num_traces=10, inference_engine=LMH, observe={"obs0": 8, "obs1": 9})


def test_parallel_file_mode_and_guided_ic(tmp_path):
    # tests/test_model_parallel.py:40-48: the chunk files stay in file mode
    model = GaussianUnknownMean().parallel(num_workers=2)
    fn = str(tmp_path / "parallel_traces")
    post = model.posterior_results(num_traces=200, observe={"obs0": 8, "obs1": 9}, file_name=fn)
    assert post.length == 200
    assert len(glob.glob(fn + "_chunk_*")) == 2
    values = post.values_numpy()
    post.close()
    reopened = pp.distributions.Empirical(file_name=fn)
    assert reopened.length == 200 and np.array_equal(reopened.values_numpy(), values)
    reopened.close()
    # guided IC: the base model's network, served by lockstep inside each
    # worker; the same count served in this process
    base = GaussianUnknownMean()
    base.learn_inference_network(
        num_traces=2048, observe_embeddings={"obs0": {"dim": 8}, "obs1": {"dim": 8}},
        inference_network=pp.InferenceNetwork.LSTM, lstm_dim=32, batch_size=128, learning_rate_init=0.01,
    )
    parallel = base.parallel(num_workers=2)
    guided = parallel.posterior_results(num_traces=1000, inference_engine=IC, observe=OBSERVE)
    local = base.posterior_results(num_traces=1000, inference_engine=IC, observe=OBSERVE, vectorized=False)
    assert guided.length == 1000
    assert abs(float(guided.mean) - POSTERIOR_MEAN) < 0.5
    assert abs(float(guided.stddev) - POSTERIOR_STDDEV) < 0.5
    ess, local_ess = guided.effective_sample_size, local.effective_sample_size
    assert abs(ess - local_ess) <= 0.1 * local_ess + 3 * math.sqrt(local_ess), (ess, local_ess)
