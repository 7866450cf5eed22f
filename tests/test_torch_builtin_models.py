"""The port's built-in model families EightSchools, BayesianLinearRegression,
BayesianLogisticRegression, GaussianMixture (fixed and Dirichlet weights)
and LinearGaussianStateSpace against the JAX package's, on the CPU; kernel
1 (and kernel 2) on the ``[N, D]`` mixtures of a data vector observed per
particle; ``observe(mask=)``; ``Model.sample`` and ``Model.get_trace``.

Each family: a JAX package trace's sampled values are forced through the
port's model on both tiers (a proposal step on the batched tier, a
proposal network on the interpreter tier, both proposing those values
with log q = 0), and every site's address (without its source line),
name and log-probability equal the JAX package's within 1e-5 (1 + |ref|).
The ground-truth helpers equal the JAX package's to 1e-12 (numpy float64
on both sides).  The JAX tests' small cases: BayesianLinearRegression's
prior IS at 20,000 traces within 0.12 of the conjugate mean
(tests/test_models_builtin.py:184-197) and the structural test over the
port's model zoo (:326-345, MiniCaptcha among them).

The mixtures: an all-Normal Mixture whose components are ``[N, D]`` and
whose value is a data vector ``[D]`` is scored by the kernel on ``N·D``
rows (its plain version here) and equals the logsumexp path and the JAX
package's ``Mixture.log_prob`` per particle within 1e-5 (1 + |ref|), for N
= 5, D in {1, 7}, K in {1, 2, 10}, with shared and per-particle logits;
its gradients with respect to the means and the logits within 1e-5 +
1e-4 |ref|.
"""

import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu import distributions as JD
from pyprob_tpu import models as JM
from pyprob_tpu_torch import distributions as TD
from pyprob_tpu_torch import models as TM
from pyprob_tpu_torch import vectorized
from pyprob_tpu_torch.ops import kernels

torch.set_num_threads(2)
IC = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    pp.set_verbosity(0)
    pyprob_tpu.set_verbosity(0)
    yield


def _base(address):
    """An address without its leading source line number."""
    return re.sub(r"^\d+__", "", address)


def _cases():
    """name: (JAX model, port model, observe)."""
    X2 = np.random.default_rng(0).normal(size=(10, 2))
    X1 = np.random.default_rng(4).normal(size=(12, 1))
    lgss = JM.LinearGaussianStateSpace(num_steps=4, a=0.9)
    gm = JM.GaussianMixture(num_data=7, weights=[0.3, 0.7])
    return {
        "eight_schools": (JM.EightSchools(), TM.EightSchools(), JM.EightSchools().observes()),
        "linear_regression": (JM.BayesianLinearRegression(X2), TM.BayesianLinearRegression(X2),
                              {"y": JM.BayesianLinearRegression(X2).synthesize([1.5, -0.7], rng=1)}),
        "logistic_regression": (JM.BayesianLogisticRegression(X1), TM.BayesianLogisticRegression(X1),
                                {"y": JM.BayesianLogisticRegression(X1).synthesize([1.2], rng=2)}),
        "gaussian_mixture": (gm, TM.GaussianMixture(num_data=7, weights=[0.3, 0.7]),
                             {"y": gm.synthesize([-2.0, 2.0], rng=0)}),
        "gaussian_mixture_weights": (JM.GaussianMixture(num_components=3, num_data=7, learn_weights=True),
                                     TM.GaussianMixture(num_components=3, num_data=7, learn_weights=True),
                                     {"y": gm.synthesize([-2.0, 2.0], rng=0)}),
        "state_space": (lgss, TM.LinearGaussianStateSpace(num_steps=4, a=0.9),
                        lgss.observes(lgss.synthesize(rng=0)[1])),
    }


def _forced_step(values):
    """A batched proposal step proposing ``values[_base(address_base)]``
    with log q = 0."""

    def step(site, distribution, generator, observed, **kwargs):
        v = values[_base(site.address_base)]
        return v, torch.zeros(v.shape[0])

    step.reset = lambda n: None
    return step


class _Point:
    def __init__(self, value):
        self.value = value

    def sample(self, rng=None):
        return self.value

    def log_prob(self, value, sum=False):
        return torch.zeros(())


class _ForcedNetwork:
    """An interpreter-tier proposal network proposing the given values."""

    def __init__(self, values):
        self.values = values

    def _infer_init(self, observed):
        pass

    def _infer_begin_trace(self):
        pass

    def _infer_step(self, variable, prev_variable=None):
        return _Point(self.values[_base(variable.address_base)])


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * (1 + np.abs(want).max()))


@pytest.mark.parametrize("name", list(_cases()))
def test_model_sites_and_log_probs_match_on_both_tiers(name):
    jm, tm, observe = _cases()[name]
    jtraces = jm.posterior(num_traces=3, observe=observe, vectorized=False).get_values()
    ref = [[(_base(v.address), v.name, bool(v.observed)) for v in t.variables] for t in jtraces]
    ref_lp = np.array([[float(np.sum(v.log_prob)) for v in t.variables] for t in jtraces])
    latent = [v for v in jtraces[0].variables if not v.observed]
    assert latent and all(v.control for v in latent)
    # the interpreter tier, one trace at a time
    for jt, sites, lps in zip(jtraces, ref, ref_lp):
        values = {_base(v.address_base): torch.as_tensor(np.asarray(v.value, np.float32))
                  for v in jt.variables if not v.observed}
        trace = next(tm._trace_generator(trace_mode=pp.TraceMode.POSTERIOR, inference_engine=IC,
                                         inference_network=_ForcedNetwork(values), observe=observe))
        assert [(_base(v.address), v.name, bool(v.observed)) for v in trace.variables] == sites
        _close([v.log_prob for v in trace.variables], lps)
        _close(trace.log_prob, jt.log_prob)
        _close(np.asarray(trace.result), np.asarray(jt.result))
    # the batched tier, the three traces as three particles
    values = {_base(v.address_base): torch.as_tensor(np.stack([
        np.asarray(t.variables[i].value, np.float32) for t in jtraces]))
        for i, v in enumerate(jtraces[0].variables) if not v.observed}
    outputs, handler = vectorized.run_traced(tm, 3, observe, pp.TraceMode.POSTERIOR, IC,
                                             proposal_step=_forced_step(values))
    assert [(_base(s.address), s.name, bool(s.observed)) for s in handler.sites] == ref[0]
    mine = np.stack([outputs["log_probs"][s.address].numpy() for s in handler.sites], axis=1)
    _close(mine, ref_lp)
    _close(outputs["result"].numpy(), np.stack([np.asarray(t.result) for t in jtraces]))


def test_observe_mask_raises_not_implemented_on_both_tiers():
    # the JAX package takes observe(mask=) (pyprob_tpu/state.py:190); the
    # port raises NotImplementedError naming its slice, not TypeError
    class Masked(pp.Model):
        def __init__(self, mask):
            super().__init__()
            self.mask = mask

        def forward(self):
            x = pp.sample(TD.Normal(0.0, 1.0))
            pp.observe(TD.Normal(x, 1.0), name="y", mask=self.mask)
            return x

    for vectorized_tier in (True, False):
        with pytest.raises(NotImplementedError, match="Markov/SMC slice"):
            Masked(True).posterior_results(4, observe={"y": 0.5}, vectorized=vectorized_tier)
        pp.seed(1)
        with_none = Masked(None).posterior_results(4, observe={"y": 0.5}, vectorized=vectorized_tier)
        pp.seed(1)
        plain = P_GUM_LIKE().posterior_results(4, observe={"y": 0.5}, vectorized=vectorized_tier)
        np.testing.assert_array_equal(with_none.log_weights, plain.log_weights)
        np.testing.assert_array_equal(with_none.values_numpy(), plain.values_numpy())

    class Blocked(pp.Model):
        def forward(self):
            return pp.rejection_sample(lambda: (pp.observe(TD.Normal(0.0, 1.0), 0.0, mask=True), True))

    with pytest.raises(NotImplementedError, match="Markov/SMC slice"):
        Blocked().prior_results(4, vectorized=True)


class P_GUM_LIKE(pp.Model):
    def forward(self):
        x = pp.sample(TD.Normal(0.0, 1.0))
        pp.observe(TD.Normal(x, 1.0), name="y")
        return x


def test_model_sample_and_get_trace():
    m = TM.LinearGaussianStateSpace(num_steps=3)
    trace = m.sample()
    assert trace.length == 7 and np.asarray(trace.result).shape == (4,)
    with pytest.warns(UserWarning, match="deprecated"):
        assert m.get_trace().length_controlled == 4


def _mixture_inputs(N, D, K, per_particle, seed):
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, 2.0, (N, D, K)).astype(np.float32)
    sds = rng.uniform(0.3, 2.0, (N, D, K)).astype(np.float32)
    logits = rng.normal(size=(N, K) if per_particle else (K,)).astype(np.float32)
    value = rng.normal(0.0, 2.0, D).astype(np.float32)
    g = rng.normal(size=(N, D)).astype(np.float32)  # a cotangent
    return means, sds, logits, value, g


def _count_rows(monkeypatch, name):
    rows = []
    fn = getattr(kernels, name)

    def counted(*args):
        rows.append(args[1].shape)
        return fn(*args)

    monkeypatch.setattr(kernels, name, counted)
    return rows


@jax.jit
def _jax_mixture(means, sds, logits, value, g):
    """The JAX package's Mixture.log_prob per particle (vmap) and the
    gradients of Σ g·log p with respect to the means and the logits."""

    def per_particle(means, sds, logits):
        comps = [JD.Normal(means[:, k], sds[:, k]) for k in range(means.shape[-1])]
        return JD.Mixture(comps, logits=logits).log_prob(value)

    in_axes = (0, 0, 0 if logits.ndim == 2 else None)

    def loss(means, logits):
        return jnp.sum(g * jax.vmap(per_particle, in_axes=in_axes)(means, sds, logits))

    lp = jax.vmap(per_particle, in_axes=in_axes)(means, sds, logits)
    return lp, jax.grad(loss, argnums=(0, 1))(means, logits)


@pytest.mark.parametrize("per_particle", [False, True])
@pytest.mark.parametrize("K", [1, 2, 10])
@pytest.mark.parametrize("D", [1, 7])
def test_mixture_of_a_data_vector_takes_kernel_1_on_n_d_rows(monkeypatch, D, K, per_particle):
    N = 5
    means, sds, logits, value, g = _mixture_inputs(N, D, K, per_particle, seed=10 * D + K)
    rows = _count_rows(monkeypatch, "mixture_normal_log_prob")
    m = torch.tensor(means, requires_grad=True)
    lg = torch.tensor(logits, requires_grad=True)
    comps = [TD.Normal(m[..., k], torch.from_numpy(sds[..., k])) for k in range(K)]
    mix = TD.Mixture(comps, logits=lg.unsqueeze(-2) if per_particle else lg)
    lp = mix.log_prob(torch.from_numpy(value))
    assert lp.shape == (N, D) and rows == [(N * D, K)]
    plain = torch.logsumexp(
        torch.stack([c.log_prob(torch.from_numpy(value)) for c in comps], -1) + mix.mixing_distribution.logits, -1)
    ref, (gm, gl) = _jax_mixture(jnp.asarray(means), jnp.asarray(sds), jnp.asarray(logits), jnp.asarray(value),
                                 jnp.asarray(g))
    _close(lp.detach().numpy(), plain.detach().numpy())
    _close(lp.detach().numpy(), np.asarray(ref))
    dm, dl = torch.autograd.grad((lp * torch.from_numpy(g)).sum(), (m, lg))
    for got, want in ((dm, gm), (dl, gl)):
        want = np.asarray(want, np.float64)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_truncated_mixture_of_a_data_vector_takes_kernel_2(monkeypatch):
    N, D, K = 4, 6, 3
    means, sds, logits, value, _ = _mixture_inputs(N, D, K, True, seed=3)
    rows = _count_rows(monkeypatch, "mixture_truncated_normal_log_prob")
    low, high = torch.full((N, D), -3.0), torch.full((N, D), 4.0)
    comps = [TD.TruncatedNormal(torch.from_numpy(means[..., k]), torch.from_numpy(sds[..., k]), low, high)
             for k in range(K)]
    mix = TD.Mixture(comps, logits=torch.from_numpy(logits).unsqueeze(-2))
    v = torch.from_numpy(value)
    lp = mix.log_prob(v)
    assert lp.shape == (N, D) and rows == [(N * D, K)]
    plain = torch.logsumexp(torch.stack([c.log_prob(v) for c in comps], -1) + mix.mixing_distribution.logits, -1)
    _close(lp.numpy(), plain.numpy())


def test_one_dimensional_mixtures_keep_their_paths(monkeypatch):
    # the interpreter's [D] observe (mixing batch (), one value a datum)
    # stays on the logsumexp path; a head's [B] batch takes B rows
    rows = _count_rows(monkeypatch, "mixture_normal_log_prob")
    comps = [TD.Normal(torch.full((7,), float(k)), 1.0) for k in range(2)]
    TD.Mixture(comps, probs=torch.tensor([0.3, 0.7])).log_prob(torch.zeros(7))
    assert rows == []
    head = TD.Mixture._from_normal_params(torch.zeros(9, 3), torch.ones(9, 3), torch.full((9, 3), 1 / 3))
    head.log_prob(torch.zeros(9))
    assert rows == [(9, 3)]


def test_gaussian_mixture_observe_runs_kernel_1_per_particle(monkeypatch):
    rows = _count_rows(monkeypatch, "mixture_normal_log_prob")
    m = TM.GaussianMixture(num_data=40, learn_weights=True)
    y = m.synthesize([-2.0, 2.0], rng=0)
    post = m.posterior_results(3000, observe={"y": y}, vectorized=True)
    assert rows == [(3000 * 40, 2)] and np.asarray(post.mean).shape == (2,)


def test_linear_regression_prior_is_matches_the_conjugate_posterior():
    # tests/test_models_builtin.py:184-197's IS check
    X = np.random.default_rng(0).normal(size=(40, 2))
    m = TM.BayesianLinearRegression(X)
    y = m.synthesize([1.5, -0.7], rng=1)
    mean, _ = m.true_posterior(y)
    post = m.posterior_results(num_traces=20000, observe={"y": y}, vectorized=True)
    assert np.abs(np.asarray(post.mean, np.float64) - mean).max() < 0.12


def test_model_zoo_structural():
    # tests/test_models_builtin.py:326-345: every family of the port's zoo
    # constructs, samples a trace and runs a small prior batch
    rng = np.random.default_rng(0)
    for name in TM.__all__:
        cls = getattr(TM, name)
        if name == "HiddenMarkovModel":
            m = cls(init_probs=[0.5, 0.5], transition_probs=[[0.9, 0.1], [0.2, 0.8]],
                    emission_means=[-1.0, 1.0], obs_length=3)
        elif name in ("BayesianLinearRegression", "BayesianLogisticRegression"):
            m = cls(rng.normal(size=(10, 2)))
        elif name == "GaussianProcessRegression":
            m = cls(np.linspace(0, 2, 8))
        else:
            m = cls()
        trace = m.sample()
        assert np.isfinite(np.asarray(trace.result, np.float64)).all(), name
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            prior = m.prior_results(num_traces=20)
        assert prior.length == 20, name


def test_ground_truth_helpers_match():
    def same(a, b):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=1e-12, atol=1e-12)

    X = np.random.default_rng(1).normal(size=(15, 2))
    jb, tb = JM.BayesianLinearRegression(X, 0.7, 0.4), TM.BayesianLinearRegression(X, 0.7, 0.4)
    y = jb.synthesize([0.5, 1.0], rng=3)
    same(tb.synthesize([0.5, 1.0], rng=3), y)
    for a, b in zip(tb.true_posterior(y), jb.true_posterior(y)):
        same(a, b)
    for D in (1, 2):
        jl, tl = JM.BayesianLogisticRegression(X[:, :D]), TM.BayesianLogisticRegression(X[:, :D])
        yl = jl.synthesize(np.ones(D), rng=4)
        same(tl.synthesize(np.ones(D), rng=4), yl)
        for a, b in zip(tl.true_posterior_moments(yl, n=31), jl.true_posterior_moments(yl, n=31)):
            same(a, b)
    jg, tg = JM.GaussianMixture(num_data=12), TM.GaussianMixture(num_data=12)
    yg = jg.synthesize([-1.0, 1.5], rng=5)
    same(tg.synthesize([-1.0, 1.5], rng=5), yg)
    for a, b in zip(tg.true_posterior_moments(yg, n=21), jg.true_posterior_moments(yg, n=21)):
        same(a, b)
    js, ts = JM.LinearGaussianStateSpace(num_steps=6, a=0.8), TM.LinearGaussianStateSpace(num_steps=6, a=0.8)
    xs, ys = js.synthesize(rng=6)
    for a, b in zip(ts.synthesize(rng=6), (xs, ys)):
        same(a, b)
    assert ts.observes(ys) == js.observes(ys)
    for fn in ("kalman_filter", "kalman_smoother"):
        for a, b in zip(getattr(ts, fn)(ys), getattr(js, fn)(ys)):
            same(a, b)
    same(ts.kalman_log_evidence(ys), js.kalman_log_evidence(ys))
    assert TM.EightSchools().observes() == JM.EightSchools().observes()
