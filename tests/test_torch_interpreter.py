"""The port's interpreter tier (``state.py``, ``model.py``) against the JAX
package and analytic answers, on the CPU.

(i) Deterministic: the while-loop Marsaglia model (a body shared by both
packages, ``_torch_parity.marsaglia_while_body``) gives traces of 1, 2 and
3 attempts whose addresses and instances equal the JAX package's, and the
stepwise network (``_infer_step``) proposes what the JAX package's does
from the same carried parameters, within 1e-5.  (ii) Statistical: prior
moments, IS posterior mean and log Z of GUM and of the while-loop model;
``rejection_sample``'s replacement semantics, and IC retries drawn from
the defensive mixture under a biased proposal, still exact.  (iii) The
``vectorized=None`` fallback and its per-class mark, ``vectorized=True``'s
error, ``tag``, and the errors of what is not ported.
"""

import math
import warnings

import numpy as np
import pytest
import torch

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu.nn.dataset import Batch as JBatch, prune_trace as jprune
from pyprob_tpu_torch import state
from pyprob_tpu_torch.distributions import TruncatedNormal, Uniform
from pyprob_tpu_torch.util import InferenceEngine as TEngine
from pyprob_tpu_torch.vectorized import _TraceabilityCache

from _torch_parity import (
    OBSERVE,
    POSTERIOR_MEAN,
    POSTERIOR_STDDEV,
    JaxMarsagliaWhile,
    TorchGUM,
    TorchMarsaglia,
    TorchMarsagliaWhile,
    carry,
    jax_network,
    port_trace,
)

torch.set_num_threads(2)

# analytic GUM evidence for observes {8, 9}: log N(8; 1, √7) + log N(9; 6, √(24/7))
LOG_EVIDENCE = -8.2395
IC = TEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    pp.set_verbosity(1)
    yield


def _log_evidence(post):
    lw = np.asarray(post.log_weights, np.float64)
    m = lw.max()
    return m + math.log(np.exp(lw - m).sum() / len(lw))


@pytest.fixture(scope="module")
def while_traces():
    """Interpreter prior traces of the while-loop model from both packages,
    by number of attempts."""
    pp.set_device("cpu")
    pyprob_tpu.seed(1)
    pp.seed(1)
    out = {}
    for pkg, model in (("jax", JaxMarsagliaWhile()), ("torch", TorchMarsagliaWhile())):
        traces = model.prior(num_traces=300, vectorized=False).get_values()
        by = {}
        for t in traces:
            by.setdefault(t.length_controlled // 2, t)
        out[pkg] = by
    return out


def _sites(trace):
    return [(v.address, v.instance, v.control, v.observed) for v in trace.variables]


@pytest.mark.parametrize("attempts", [1, 2, 3])
def test_while_loop_addresses_match_the_jax_package(while_traces, attempts):
    jt, tt = while_traces["jax"][attempts], while_traces["torch"][attempts]
    assert jt.length_controlled == tt.length_controlled == 2 * attempts
    assert _sites(tt) == _sites(jt)
    instances = [v.instance for v in tt.variables_controlled]
    assert instances == [i for i in range(1, attempts + 1) for _ in range(2)]
    assert tt.variables_controlled[0].address.endswith("__forward__marsaglia_while_body__x__Uniform__1")
    # the interpreter's values are CPU tensors, their distributions' too
    x = tt.variables_controlled[0]
    assert isinstance(x.value, torch.Tensor) and x.value.device.type == "cpu" and x.value.dim() == 0
    assert x.distribution.low.device.type == "cpu"


def test_infer_step_matches_the_jax_package(while_traces):
    jm, tm = JaxMarsagliaWhile(), TorchMarsagliaWhile()
    jtrace = while_traces["jax"][3]
    jnet = jax_network(jm, vectorized=False)
    jnet._polymorph(JBatch([jprune(jtrace)]))
    tnet = carry(jnet, tm)
    ttrace = port_trace(jtrace)
    jnet._infer_init(OBSERVE)
    tnet._infer_init({k: torch.tensor(v) for k, v in OBSERVE.items()})
    jprev = tprev = None
    for jv, tv in zip(jtrace.variables_controlled, ttrace.variables_controlled):
        jd = jnet._infer_step(jv, prev_variable=jprev)
        td = tnet._infer_step(tv, prev_variable=tprev)
        means, stddevs, low, high = td._tnorm_params
        assert means.device.type == "cpu" and tuple(means.shape) == (1, 3)
        np.testing.assert_allclose(td.probs.numpy(), np.asarray(jd.probs), atol=1e-5)
        jmeans = np.stack([np.asarray(c.mean_non_truncated) for c in jd.distributions], -1)
        jstd = np.stack([np.asarray(c.stddev_non_truncated) for c in jd.distributions], -1)
        np.testing.assert_allclose(means.numpy(), jmeans, atol=1e-5)
        np.testing.assert_allclose(stddevs.numpy(), jstd, atol=1e-5)
        np.testing.assert_allclose(low.numpy(), -1.0)
        np.testing.assert_allclose(high.numpy(), 1.0)
        jprev, tprev = jv, tv
    # an address the network has never seen: the prior itself, as in the
    # JAX package
    stranger = state.Variable(
        distribution=Uniform(-1.0, 1.0), address="0__stranger__Uniform__1", control=True
    )
    with pytest.warns(UserWarning, match="No proposal"):
        assert tnet._infer_step(stranger, prev_variable=tprev) is stranger.distribution


def test_vectorized_none_falls_back_and_marks_the_class():
    class WhileModel(TorchMarsagliaWhile):
        pass

    model = WhileModel()
    assert type(model) not in _TraceabilityCache._cache
    with pytest.raises(NotImplementedError, match="branches on sampled values"):
        model.prior_results(20, vectorized=True)
    prior = model.prior_results(50)
    assert _TraceabilityCache._cache[type(model)] is False
    assert prior.length == 50 and np.all(np.isfinite(np.asarray(prior.get_values(), float)))
    # the mark sends the next call straight to the interpreter
    post = model.posterior_results(40, observe=OBSERVE)
    assert post.length == 40 and "IS" in post.name
    # a fixed-structure model stays on the batched tier
    gum = TorchGUM()
    gum.posterior_results(40, observe=OBSERVE)
    assert _TraceabilityCache._cache[type(gum)] is True


def test_interpreter_prior_moments():
    prior = TorchMarsagliaWhile().prior_results(2000, vectorized=False)
    # Marsaglia's polar method gives N(1, √5): standard errors 0.05 and 0.035
    assert abs(float(prior.mean) - 1.0) < 0.15
    assert abs(float(prior.stddev) - math.sqrt(5.0)) < 0.15


@pytest.mark.parametrize("model_class", [TorchGUM, TorchMarsagliaWhile])
def test_interpreter_is_posterior_and_evidence(model_class):
    n = 5000
    post = model_class().posterior_results(n, observe=OBSERVE, vectorized=False)
    # prior IS: ESS about 0.9 % of the traces; at this size the standard
    # errors are about 0.14 (mean) and 0.15 (log Z, √((1/0.009)/n)): 3σ
    assert post.effective_sample_size > 0.002 * n
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.45
    assert abs(_log_evidence(post) - LOG_EVIDENCE) < 0.45


def test_rejection_sample_replacement_semantics_on_the_interpreter():
    traces = TorchMarsaglia().prior(num_traces=60, vectorized=False).get_values()
    assert {t.length_controlled for t in traces} == {2}
    for t in traces:
        assert all(v.instance == 1 and v.address.endswith("__1") for v in t.variables_controlled)
        s = float(t.variables_controlled[0].value) ** 2 + float(t.variables_controlled[1].value) ** 2
        assert s < 1.0  # the accepted attempt's values were kept


class _BiasedNet:
    """A stand-in network whose proposal for every block site is a biased
    full-support TruncatedNormal(0.5, 1.0) on [-1, 1]: only the weighting of
    every executed attempt keeps the posterior exact.  σ = 1.0 bounds a
    first attempt's p/q at 2.4 a site; at the JAX package's test's σ = 0.6
    it reaches 13.5 a site, and one trace in about 10^4 carries most of
    the weight (log Z over 40,000 such traces: −8.2297, exact; 4,000 are
    too few)."""

    def __init__(self):
        self._infer_lstm_state = None
        self.calls = []
        self.proposal = TruncatedNormal(0.5, 1.0, -1.0, 1.0)

    def _infer_init(self, observed):
        pass

    def _infer_begin_trace(self):
        self._infer_lstm_state = None

    def _infer_step(self, variable, prev_variable=None, proposal_min_train_iterations=None):
        self.calls.append(state._ctx_local.value.rejection_retry)
        self._infer_lstm_state = len(self.calls)
        return self.proposal


def test_interpreter_ic_retries_draw_from_the_defensive_mixture():
    model = TorchMarsaglia()
    model._inference_network = net = _BiasedNet()
    n = 2000
    post = model.posterior_results(
        n, observe=OBSERVE, vectorized=False, inference_engine=IC, lockstep=False
    )
    first, retries = net.calls.count(False), net.calls.count(True)
    assert first == 2 * n  # two block sites a first attempt
    assert retries > 2 * 0.15 * n  # the biased proposal is rejected often
    assert post.effective_sample_size > 0.004 * n
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.4
    assert abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.35
    assert abs(_log_evidence(post) - LOG_EVIDENCE) < 0.5


def test_max_attempts_marks_the_trace_invalid():
    class Tight(pp.Model):
        def forward(self):
            def attempt():
                x = pp.sample(Uniform(0.0, 1.0))
                return x, x > 0.999

            return pp.rejection_sample(attempt, max_attempts=2)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        post = Tight().posterior_results(200, vectorized=False)
    assert post.length < 20  # the traces that never accepted are discarded


def test_tag_records_and_what_is_not_ported_raises():
    class Tagged(pp.Model):
        def forward(self):
            x = pp.sample(pp.distributions.Normal(0.0, 1.0))
            pp.tag(float(x) * 2.0, name="twice")
            return x

    (trace,) = Tagged().prior(1, vectorized=False).get_values()
    tagged = trace.variables_tagged
    assert len(tagged) == 1 and tagged[0].name == "twice"
    assert float(tagged[0].value) == pytest.approx(2.0 * float(trace.result))
    assert trace.length_controlled == 1

    class Factored(pp.Model):
        def forward(self):
            pp.factor(log_prob=-1.5)
            return 0.0

    (trace,) = Factored().prior(1, vectorized=False).get_values()
    (site,) = trace.variables_observed
    assert site.value is None and site.log_prob == -1.5 and trace.log_importance_weight == -1.5
    with pytest.raises(NotImplementedError, match="Markov/SMC slice"):
        pp.factor(log_prob=0.0, mask=True)
    with pytest.raises(RuntimeError, match="no interpreter tier"):
        TorchGUM().posterior_results(
            5, observe=OBSERVE, vectorized=False,
            inference_engine=TEngine.PARALLEL_TEMPERING,
        )
    with pytest.raises(RuntimeError, match="no interpreter tier"):
        TorchGUM().posterior_results(
            5, observe=OBSERVE, vectorized=False,
            inference_engine=TEngine.HAMILTONIAN_MONTE_CARLO,
        )
    with pytest.raises(RuntimeError, match="No inference network"):
        TorchGUM().posterior_results(5, observe=OBSERVE, vectorized=False, inference_engine=IC)


def test_interpreter_raises_without_a_card_unless_the_cpu_was_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    pp.set_device("cuda")
    with pytest.raises(RuntimeError, match="set_device"):
        TorchMarsagliaWhile().prior(3, vectorized=False)


@pytest.mark.parametrize(
    "kind,params,value",
    [
        ("Normal", (1.0, math.sqrt(5.0)), 8.0),
        ("Normal", (-3.0, 0.25), -3.5),
        ("Uniform", (-1.0, 1.0), 0.3),
        ("Uniform", (-1.0, 1.0), 1.5),
        ("Uniform", (2.0, 2.5), 2.0),
    ],
)
def test_host_scores_equal_the_distributions_log_prob(kind, params, value):
    # the interpreter scores 0-d Normals and Uniforms in float64 on the
    # host (no torch call a site); the distribution's own log_prob is the
    # reference
    dist = getattr(pp.distributions, kind)(*params)
    value = torch.tensor(value)
    want = float(dist.log_prob(value, sum=True))
    got = state._score(dist, value)
    assert got == want == -math.inf or got == pytest.approx(want, rel=1e-6)
    # batched parameters take the distribution's own log_prob
    batched = dist._with_leaves([leaf.expand(3) for leaf in dist._leaves()])
    got = state._score(batched, value.expand(3))
    assert got == 3 * want == -math.inf or got == pytest.approx(3 * want, rel=1e-6)
