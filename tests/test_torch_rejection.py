"""The port's Marsaglia slice: ``rejection_sample`` on the batched tier, the
Uniform prior's proposal head and its training, against the JAX package.

(i) Deterministic, on a JAX LSTM network carried into the port (lstm_dim
16, 3 mixture components, 4-d observe embeddings) for a Marsaglia body
shared by both packages: equal site addresses with instance 1, the head,
the loss and every gradient of a packed batch, and the log q of forced
values through both proposal steps.  (ii) Statistical, against analytic
answers: prior moments, IS posterior and log Z, exact weights under a
biased proposal that retries, the ``max_attempts`` cap, a block whose
second site depends on its first, and a short train-then-serve run.
(iii) The errors a block raises.
"""

import math
import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pyprob_tpu  # noqa: F401
import pyprob_tpu_torch as pp
from pyprob_tpu.distributions import Uniform as JUniform
from pyprob_tpu.nn import proposals as JP
from pyprob_tpu.vectorized import SiteRecord as JSite
from pyprob_tpu_torch import vectorized as V
from pyprob_tpu_torch.distributions import Normal, TruncatedNormal, Uniform
from pyprob_tpu_torch.models import GaussianUnknownMeanMarsagliaRejection
from pyprob_tpu_torch.nn import proposals as TP
from pyprob_tpu_torch.nn.layers import map_tensors, tensor_leaves
from pyprob_tpu_torch.util import InferenceEngine as TEngine, TraceMode as TMode

from _torch_parity import (
    OBSERVE,
    POSTERIOR_MEAN,
    POSTERIOR_STDDEV,
    JaxMarsaglia,
    TorchMarsaglia,
    carry,
    jax_network,
    unwrap_static,
)

torch.set_num_threads(2)

# analytic GUM evidence for observes {8, 9}: log N(8; 1, √7) + log N(9; 6, √(24/7))
LOG_EVIDENCE = -8.2395


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    yield


@pytest.fixture(scope="module")
def nets():
    pp.set_device("cpu")
    jm, tm = JaxMarsaglia(), TorchMarsaglia()
    jnet = jax_network(jm, vectorized=False)
    return jnet, carry(jnet, tm)


def _log_evidence(post):
    lw = np.asarray(post.log_weights, np.float64)
    m = lw.max()
    return m + math.log(np.exp(lw - m).sum() / len(lw))


def _observed():
    return {k: torch.tensor(v) for k, v in OBSERVE.items()}


def test_sites_get_equal_addresses_with_instance_one(nets):
    jnet, tnet = nets
    (jtrace,) = JaxMarsaglia().prior(num_traces=1, vectorized=False).get_values()
    (ttrace,) = tnet._model.prior(num_traces=1).get_values()
    jaddr = [v.address for v in jtrace.variables]
    assert [v.address for v in ttrace.variables] == jaddr
    controlled = [v for v in ttrace.variables if v.control]
    assert [v.address for v in controlled] == [v.address for v in jtrace.variables_controlled]
    assert controlled[0].address.endswith("__forward__marsaglia_body__attempt__x__Uniform__1")
    assert all(v.instance == 1 for v in controlled)
    assert set(tnet._params["proposal"]) == {v.address for v in controlled}
    _, handler = V.run_traced(tnet._model, 500, {}, TMode.PRIOR, TEngine.IMPORTANCE_SAMPLING)
    assert [s.rejection for s in handler.sites] == [True, True, None, None]
    assert handler.rejection_rounds[0] > 1  # some lane retried


def test_head_apply_matches(nets):
    jnet, tnet = nets
    addr = next(iter(jnet._params["proposal"]))
    assert tnet._head_meta[addr]["kind"] == "uniform_truncated_normal_mixture"
    rng = np.random.default_rng(1)
    n = 9
    feats = rng.normal(size=(n, jnet._lstm_dim)).astype(np.float32)
    low = rng.uniform(-2, -0.5, n).astype(np.float32)
    high = (low + rng.uniform(0.5, 3, n)).astype(np.float32)
    value = (low + rng.uniform(0, 1, n) * (high - low)).astype(np.float32)
    value[4] = high[4] + 0.5  # outside: -inf on both sides

    @jax.jit  # one compile is cheaper than op-by-op dispatch
    def jax_head(feats, low, high, value):
        d = JP.head_apply(jnet._params["proposal"][addr], feats, {"low": low, "high": high})
        return d.log_prob(value), d.mean, d.variance, d.mixing_distribution.logits

    jlp, jmean, jvar, jlogits = (
        np.asarray(a) for a in jax_head(*[jnp.asarray(a) for a in (feats, low, high, value)])
    )
    td = TP.head_apply(
        tnet._params["proposal"][addr], torch.from_numpy(feats),
        TP.prior_param_arrays(Uniform(torch.from_numpy(low), torch.from_numpy(high))),
    )
    tlp = td.log_prob(torch.from_numpy(value)).numpy()
    assert np.isneginf(jlp[4]) and np.isneginf(tlp[4])
    np.testing.assert_allclose(np.delete(tlp, 4), np.delete(jlp, 4), atol=1e-5, rtol=0)
    np.testing.assert_allclose(td.mean.numpy(), jmean, atol=1e-5, rtol=1e-5)
    # the truncated variance 1 + t1 − t2² cancels for the head's wide
    # components, where two erf implementations part at 1e-4 relative
    np.testing.assert_allclose(td.variance.numpy(), jvar, atol=1e-5, rtol=1e-3)
    np.testing.assert_allclose(td.mixing_distribution.logits.numpy(), jlogits, atol=1e-6)
    assert TP.head_kind_for(Uniform(0.0, 1.0)) == JP.head_kind_for(JUniform(0.0, 1.0))


def _arrays(tree, path=()):
    if isinstance(tree, np.ndarray):
        return {path: tree}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree) if isinstance(tree, (list, tuple)) else ()
    for k, v in items:
        out.update(_arrays(v, path + (k,)))
    return out


def _packed(B, seed):
    """A Marsaglia training batch as numpy arrays: accepted (x, y) pairs,
    observes drawn from the resulting mu, the Uniform prior per row."""
    rng = np.random.default_rng(seed)
    x, y = (rng.uniform(-1, 1, 4 * B).reshape(2, -1)).astype(np.float32)
    keep = (x * x + y * y < 1.0)
    x, y = x[keep][:B], y[keep][:B]
    s = x * x + y * y
    mu = 1.0 + math.sqrt(5.0) * x * np.sqrt(-2.0 * np.log(s) / s)
    obs = {k: (mu + rng.normal(0, math.sqrt(2.0), B)).astype(np.float32)[:, None] for k in OBSERVE}
    prior = {"low": np.full((B, 1), -1.0, np.float32), "high": np.full((B, 1), 1.0, np.float32)}
    return {"obs": obs, "steps": [{"values": x, "prior": prior}, {"values": y, "prior": dict(prior)}]}


def test_loss_and_gradients_match(nets):
    jnet, tnet = nets
    addrs = tuple(jnet._params["proposal"])
    dist_names = ("Uniform", "Uniform")
    packed = _packed(64, seed=3)
    _, jloss_fn = jnet._make_loss_for(addrs, dist_names)
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(
        jnet._loss_params_subset(addrs, dist_names), jax.tree_util.tree_map(jnp.asarray, packed)
    )
    for p in tensor_leaves(tnet._params):
        p.requires_grad_(True)
    try:
        _, tloss_fn = tnet._make_loss_for(addrs, dist_names)
        subset = tnet._loss_params_subset(addrs, dist_names)
        tloss = tloss_fn(subset, jax.tree_util.tree_map(torch.from_numpy, packed))
        tloss.backward()
        np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
        # the sample embedding of the last site is not read: no gradient
        # here, a zero one in JAX
        grads = _arrays(tnet.to_numpy(
            map_tensors(subset, lambda t: torch.zeros_like(t) if t.grad is None else t.grad)
        ))
        ref = _arrays(unwrap_static(jgrads))
        assert grads.keys() == ref.keys()
        for path in ref:
            np.testing.assert_allclose(grads[path], ref[path], atol=1e-5, rtol=1e-4, err_msg=str(path))
        head = ("proposal", addrs[1], "ff", "layers", 1, "w")
        assert np.abs(grads[head]).max() > 1e-3
    finally:
        for p in tensor_leaves(tnet._params):
            p.requires_grad_(False)
            p.grad = None


def test_forced_values_score_alike(nets):
    jnet, tnet = nets
    ax, ay = jnet._params["proposal"]
    rng = np.random.default_rng(5)
    xs, ys = rng.uniform(-0.7, 0.7, (2, 32)).astype(np.float32)
    jstep = jnet.make_vectorized_proposal_step(OBSERVE)
    obs_j = {k: jnp.float32(v) for k, v in OBSERVE.items()}

    def one(key, x, y):
        jstep.reset()
        _, lqx = jstep(JSite(address=ax), JUniform(-1.0, 1.0), key, obs_j, forced_value=x)
        _, lqy = jstep(JSite(address=ay), JUniform(-1.0, 1.0), key, obs_j, forced_value=y)
        return lqx, lqy

    keys = jax.random.split(jax.random.PRNGKey(0), 32)
    jlqx, jlqy = jax.jit(jax.vmap(one))(keys, jnp.asarray(xs), jnp.asarray(ys))

    step = tnet.make_vectorized_proposal_step(OBSERVE)
    prior, gen, obs = Uniform(-1.0, 1.0), pp.util.generator("cpu"), _observed()
    step.reset(32)
    s0 = step.get_state()
    _, lqx = step(V.SiteRecord(address=ax), prior, gen, obs, forced_value=torch.from_numpy(xs))
    s1 = step.get_state()
    _, lqy = step(V.SiteRecord(address=ay), prior, gen, obs, forced_value=torch.from_numpy(ys))
    np.testing.assert_allclose(lqx.numpy(), np.asarray(jlqx), atol=1e-4, rtol=0)
    np.testing.assert_allclose(lqy.numpy(), np.asarray(jlqy), atol=1e-4, rtol=0)

    # the recurrent state: snapshot, per-lane selection, restore
    assert s0[1] is None and s1[1][0] == ax and torch.equal(s1[1][1], torch.from_numpy(xs))
    step.set_state(s0)
    value, plp = step(V.SiteRecord(address=ax), prior, gen, obs, defensive=0.5)
    assert torch.equal(step.get_state()[0][0], s1[0][0])  # the same LSTM step from s0
    mask = torch.arange(32) < 16
    (h, _), prev = step.select_state(mask, step.get_state(), s1)
    assert torch.equal(prev[1][:16], value[:16]) and torch.equal(prev[1][16:], s1[1][1][16:])
    # defensive scoring: log(π q + (1 − π) p) of the drawn values
    step.set_state(s0)
    _, lq = step(V.SiteRecord(address=ax), prior, gen, obs, forced_value=value)
    want = torch.logaddexp(math.log(0.5) + lq, math.log(0.5) + prior.log_prob(value))
    torch.testing.assert_close(plp, want)


def test_prior_moments_is_posterior_and_evidence():
    model = GaussianUnknownMeanMarsagliaRejection()
    prior = model.prior_results(20_000)
    assert abs(prior.mean - 1.0) < 0.1 and abs(prior.stddev - math.sqrt(5.0)) < 0.1
    n = 100_000
    post = model.posterior_results(n, observe=OBSERVE)
    assert abs(post.mean - POSTERIOR_MEAN) < 0.15 and abs(post.stddev - POSTERIOR_STDDEV) < 0.15
    assert abs(_log_evidence(post) - LOG_EVIDENCE) < 0.15
    assert post.effective_sample_size > 0.002 * n
    (rounds,) = [m["rejection_rounds"] for m in post.metadata if "rejection_rounds" in m]
    assert len(rounds) == 1 and 5 <= rounds[0] <= 20  # P(reject) = 1 − π/4 per round


def _biased_proposal():
    """A deliberately biased proposal for the Uniform(−1, 1) block sites:
    only counting every executed attempt's log p − log q keeps IS exact."""
    return TruncatedNormal(0.5, 0.6, low=-1.0, high=1.0)


def test_biased_proposal_retries_stay_exact():
    # port of the JAX package's compiled-tier retry test: the proposal step
    # drives every attempt, pure q first and the defensive mixture after
    model = GaussianUnknownMeanMarsagliaRejection()
    calls, seen_defensive = {}, []

    def fake_step(site, distribution, generator, observed, forced_value=None, defensive=None):
        calls[site.address] = calls.get(site.address, 0) + 1
        seen_defensive.append(defensive)
        q = _biased_proposal()
        n = fake_step.n
        v = q.sample(generator, (n,))
        if defensive is None:
            return v, q.log_prob(v)
        xp = distribution.sample(generator, (n,))
        v = torch.where(torch.rand(n, generator=generator) < defensive, v, xp)
        plp = torch.logaddexp(
            math.log(defensive) + q.log_prob(v), math.log1p(-defensive) + distribution.log_prob(v)
        )
        return v, plp

    fake_step.reset = lambda n: setattr(fake_step, "n", n)
    fake_step.get_state = lambda: None
    fake_step.set_state = lambda s: None
    fake_step.select_state = lambda mask, new, old: new
    fake_step.supports_defensive = True
    n = 100_000
    post = V.vectorized_traces(
        model, n, TMode.POSTERIOR,
        inference_engine=TEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
        observe=dict(OBSERVE), proposal_step=fake_step,
        map_func=pp.model.trace_result,
    )
    (rounds,) = [m["rejection_rounds"] for m in post.metadata if "rejection_rounds" in m]
    assert sorted(calls.values()) == [rounds[0]] * 2
    assert seen_defensive == [None, None] + [0.5] * (2 * rounds[0] - 2)
    assert post.effective_sample_size > 300
    assert abs(post.mean - POSTERIOR_MEAN) < 0.15 and abs(post.stddev - POSTERIOR_STDDEV) < 0.15
    # missing or double-counted attempt corrections shift the mean weight
    assert abs(_log_evidence(post) - LOG_EVIDENCE) < 0.15


class _Tight(pp.Model):
    def forward(self):
        def attempt():
            x = pp.sample(Uniform(0.0, 1.0))
            return x, x > 0.95  # ~5 % acceptance

        x = pp.rejection_sample(attempt, max_attempts=2)
        pp.observe(Normal(x, 0.5), name="obs0")
        return x


def test_max_attempts_overflow_discards():
    n = 4000
    with pytest.warns(UserWarning, match="Discarding"):
        post = _Tight().posterior_results(num_traces=n, observe={"obs0": 1.0})
    # unaccepted after the cap: weight -inf, discarded; survivors are exact
    # draws from the truncated prior
    assert 0 < post.effective_sample_size and 0.95 < post.mean < 1.0
    assert abs(post.length / n - (1 - 0.95**2)) < 0.02


class _DependentBlock(pp.Model):
    """The second block site's distribution depends on the first."""

    def __init__(self, bound=100.0):
        super().__init__()
        self.bound = bound

    def forward(self):
        def attempt():
            a = pp.sample(Normal(0.0, 1.0))
            b = pp.sample(Normal(a, 0.5))
            return (a, b), a * a < self.bound

        a, b = pp.rejection_sample(attempt)
        pp.observe(Normal(b, 0.5), name="obs0")
        return a


def test_dependent_block_posterior_and_per_lane_parameters():
    post = _DependentBlock().posterior_results(num_traces=100_000, observe={"obs0": 2.0})
    # a ~ N(0, 1), obs | a ~ N(a, √0.5): a | obs ~ N(4/3, 1/√3)
    assert abs(post.mean - 4.0 / 3.0) < 0.05 and abs(post.stddev - 1.0 / math.sqrt(3.0)) < 0.05
    # with retries, each lane's recorded Normal(a, 0.5) carries its own
    # accepted a
    out, handler = V.run_traced(_DependentBlock(0.25), 2000, {}, TMode.PRIOR, TEngine.IMPORTANCE_SAMPLING)
    a_site, b_site = handler.sites[:2]
    a = out["values"][a_site.address]
    assert handler.rejection_rounds[0] > 1 and bool((a * a < 0.25).all())
    assert torch.equal(b_site.distribution.loc, a)
    assert b_site.distribution.scale.shape == (2000,)


def _block_model(body):
    class Block(pp.Model):
        def forward(self):
            def attempt():
                x = pp.sample(Uniform(0.0, 1.0))
                body(x)
                return x, x > 0.5

            return pp.rejection_sample(attempt)

    return Block()


@pytest.mark.parametrize("what,body", [
    ("observe", lambda x: pp.observe(Normal(x, 1.0), name="bad")),
    ("factor", lambda x: pp.factor(x)),
    ("tag", lambda x: pp.tag(x, name="t")),
    ("mask", lambda x: pp.sample(Normal(0.0, 1.0), mask=x > 0)),
    ("nested", lambda x: pp.rejection_sample(lambda: (x, x > 0))),
])
def test_unsupported_statements_inside_a_block_raise(what, body):
    with pytest.raises(RuntimeError, match="not supported"):
        _block_model(body).prior_results(5)


def test_rejection_sample_without_a_handler_and_empty_blocks():
    def attempt():
        x = pp.sample(Uniform(0.0, 1.0))
        return x, x > 0.5

    for _ in range(5):
        assert float(pp.rejection_sample(attempt)) > 0.5
    with pytest.raises(RuntimeError, match="exceeded"):
        pp.rejection_sample(lambda: (0.0, False), max_attempts=3)

    class Empty(pp.Model):
        def forward(self):
            return pp.rejection_sample(lambda: (torch.zeros(()), True))

    with pytest.raises(RuntimeError, match="no sample sites"):
        Empty().prior_results(5)


def test_train_then_serve_beats_prior_is():
    model = GaussianUnknownMeanMarsagliaRejection()
    model.learn_inference_network(
        num_traces=8192,
        observe_embeddings={"obs0": {"dim": 16}, "obs1": {"dim": 16}},
        inference_network=pp.InferenceNetwork.LSTM,
        batch_size=256,
        learning_rate_init=0.02,
        lstm_dim=32,
        ema_decay=0.9,
    )
    net = model._inference_network
    assert {m["kind"] for m in net._head_meta.values()} == {"uniform_truncated_normal_mixture"}
    assert net._total_train_iterations == 32 and math.isfinite(net._history_train_loss[-1])
    guided_engine = TEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        guided = [
            model.posterior_results(10_000, observe=OBSERVE, inference_engine=guided_engine)
            for _ in range(5)
        ]
        prior = [model.posterior_results(10_000, observe=OBSERVE) for _ in range(5)]
    assert abs(np.median([p.mean for p in guided]) - POSTERIOR_MEAN) < 0.3
    # first attempts propose from q alone, as in the JAX package, so a run
    # that meets a lane where q is far below the prior collapses to a few
    # weights: compare medians over runs
    ess = [np.median([p.effective_sample_size for p in runs]) for runs in (guided, prior)]
    assert ess[0] > ess[1], ess
