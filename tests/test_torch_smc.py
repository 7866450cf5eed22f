"""The port's SMC engines (``pyprob_tpu_torch.inference.smc``) and its
resampling collectives (``pyprob_tpu_torch.parallel``) on the CPU, against
the JAX package.

(a) Each scheme's indices from the uniforms the JAX function draws from
its key, against ``pyprob_tpu.parallel.resample_indices``: equal, but for
at most two positions whose point lies within 2e-6 of a CDF boundary in
float64 (the two packages' float32 ``exp`` and ``cumsum`` round apart
there).  (b) The interpreter's host resampler against the JAX package's,
bit for bit from one numpy seed, the residual scheme's pad included.  (c)
ESS and log Z from kernel 3's plain version against the JAX package's
collectives.  (d) The slice as a whole: the JAX tests' criteria
(tests/test_smc.py, tests/test_resampling.py, tests/test_rejection.py:137-
144) on GUM by both packages and on the Kalman state-space model, the
integer-site HMM, the rejection GUM, the while-loop Marsaglia on the
interpreter, a program whose observe count depends on a draw, and guided
SMC from LSTM and feedforward networks; the replay handlers site by site.
(e) The errors and the metadata.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu import parallel as jparallel
from pyprob_tpu.inference.smc import _host_resample_indices as jax_host_resample_indices
from pyprob_tpu_torch import parallel, state
from pyprob_tpu_torch.distributions import Categorical, Normal
from pyprob_tpu_torch.inference.smc import _host_resample_indices
from pyprob_tpu_torch.models import GaussianUnknownMeanMarsagliaRejection
from pyprob_tpu_torch.vectorized import VectorizedHandler, _TraceabilityCache, handler_outputs, run_forward

from _torch_parity import OBSERVE, POSTERIOR_MEAN, POSTERIOR_STDDEV, JaxGUM, TorchGUM, TorchMarsagliaWhile

torch.set_num_threads(2)

SMC = pp.InferenceEngine.SEQUENTIAL_MONTE_CARLO
GUIDED = pp.InferenceEngine.SEQUENTIAL_MONTE_CARLO_WITH_INFERENCE_NETWORK
SCHEMES = sorted(parallel.RESAMPLING_SCHEMES)
# tests/test_smc.py:28-35
GUM_LOGZ = float(
    -np.log(2 * np.pi)
    - 0.5 * np.log(np.linalg.det([[7.0, 5.0], [5.0, 7.0]]))
    - 0.5 * np.array([7.0, 8.0]) @ np.linalg.inv([[7.0, 5.0], [5.0, 7.0]]) @ np.array([7.0, 8.0])
)
W = np.array([0.05, 0.35, 0.1, 0.4, 0.1])  # tests/test_resampling.py:23-25
LOG_W = np.log(W) + 3.0


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    pp.set_verbosity(1)
    _TraceabilityCache._cache.clear()
    yield


# ---------------------------------------------------------------------------
# (a) indices from the JAX package's uniforms
# ---------------------------------------------------------------------------


def _cdf64(lw, scheme, num_samples):
    """The float64 CDF a scheme searches (for residual: of the residuals)."""
    w = np.exp(lw.astype(np.float64) - lw.max())
    w /= w.sum()
    if scheme == "residual":
        w = num_samples * w - np.floor(num_samples * w)
        w /= w.sum()
    return np.cumsum(w)


def _points64(u, scheme, num_samples):
    u = np.asarray(u, np.float64)
    if scheme in ("systematic", "stratified"):
        return (u + np.arange(num_samples)) / num_samples
    return u


def _assert_same_indices(got, want, lw, u, scheme, num_samples):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape == (num_samples,)
    assert got.min() >= 0 and got.max() < lw.size
    differ = np.flatnonzero(got != want)
    assert differ.size <= 2, (scheme, differ.size)
    cdf, points = _cdf64(lw, scheme, num_samples), _points64(u, scheme, num_samples)
    for j in differ:
        lo, hi = sorted((int(got[j]), int(want[j])))
        # every boundary between the two choices sits at the point
        assert np.all(np.abs(cdf[lo:hi] - points[j]) < 2e-6), (scheme, j, lo, hi)


def _weights_cases():
    rng = np.random.default_rng(5)
    lw = rng.normal(0.0, 2.0, 1000).astype(np.float32)
    lw[rng.random(1000) < 0.05] = -np.inf
    return [("w5", LOG_W.astype(np.float32), 4096), ("w1000", lw, 1000), ("w1000_n777", lw, 777),
            ("w1000_n4096", lw, 4096)]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_indices_from_the_jax_uniforms(scheme):
    for k, (_, lw, n) in enumerate(_weights_cases()):
        key = jax.random.PRNGKey(7 + k)
        u = np.asarray(jax.random.uniform(key, () if scheme == "systematic" else (n,)))
        want = np.asarray(jparallel.resample_indices(key, jnp.asarray(lw), n, scheme))
        got = parallel.indices_from_uniforms(torch.tensor(lw), torch.tensor(u), n, scheme)
        assert got.dtype == torch.int64
        _assert_same_indices(got.numpy(), want, lw, u, scheme, n)
    # the W / N = 4,096 case of tests/test_resampling.py lies far from every boundary
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, () if scheme == "systematic" else (4096,)))
    want = np.asarray(jparallel.resample_indices(key, jnp.asarray(LOG_W.astype(np.float32)), 4096, scheme))
    got = parallel.indices_from_uniforms(torch.tensor(LOG_W, dtype=torch.float32), torch.tensor(u), 4096, scheme)
    assert np.array_equal(got.numpy(), want)


def test_resample_indices_draws_and_clamps():
    g = torch.Generator().manual_seed(3)
    lw = torch.tensor(LOG_W, dtype=torch.float32)
    for scheme in SCHEMES:
        u = parallel.draw_uniforms(g, 4096, scheme)
        assert u.shape == (() if scheme == "systematic" else (4096,))
        idx = parallel.resample_indices(g, lw, 4096, scheme)
        counts = np.bincount(idx.numpy(), minlength=W.size)
        if scheme == "multinomial":  # tests/test_resampling.py:28-55's bounds
            assert (np.abs(counts - 4096 * W) < 5 * np.sqrt(4096 * W * (1 - W)) + 1).all()
        else:
            assert (counts >= np.floor(4096 * W) - (1 if scheme == "stratified" else 0)).all()
    # a float32 CDF ending below the largest uniform: the clamp to size - 1
    lw = torch.log(torch.full((3,), 1.0 / 3.0))
    top = torch.tensor([np.nextafter(np.float32(1), np.float32(0))])
    for scheme in ("multinomial", "residual"):
        assert int(parallel.indices_from_uniforms(lw, top, 1, scheme)[0]) <= 2
    with pytest.raises(ValueError, match="Unknown resampling scheme"):
        parallel.resample_indices(g, lw, 8, "bogus")


def test_residual_exact_weights_all_deterministic():
    lw = torch.log(torch.tensor([0.25, 0.5, 0.25]))  # tests/test_resampling.py:69-79
    idx = parallel.resample_indices(torch.Generator().manual_seed(0), lw, 8, "residual")
    assert np.bincount(idx.numpy(), minlength=3).tolist() == [2, 4, 2]


# ---------------------------------------------------------------------------
# (b) the interpreter's host resampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
def test_host_resample_indices_equal_the_jax_package(scheme):
    rng = np.random.default_rng(9)
    lw = rng.normal(0.0, 3.0, 500)
    lw[rng.random(500) < 0.1] = -np.inf
    cases = [(LOG_W, 4096), (lw, 500), (lw, 333)]
    if scheme == "residual":
        # float16 weights at N past 2,048: N w rounds to integers short of N,
        # every residual is 0 and the pad fills the last positions
        cases += [(np.zeros(1, np.float16), 2049), (np.log(np.array([0.5, 0.25, 0.25], np.float16)), 4097)]
    for seed, (weights, n) in enumerate(cases):
        got = _host_resample_indices(np.random.default_rng(seed), weights, n, scheme)
        want = jax_host_resample_indices(np.random.default_rng(seed), weights, n, scheme)
        assert got.shape == (n,) and np.array_equal(got, want)
    with pytest.raises(ValueError, match="Unknown resampling scheme"):
        _host_resample_indices(np.random.default_rng(0), LOG_W, 8, "bogus")


# ---------------------------------------------------------------------------
# (c) ESS and log Z through kernel 3's plain version
# ---------------------------------------------------------------------------


def test_weight_stats_equal_the_jax_collectives():
    rng = np.random.default_rng(11)
    for n in (1, 37, 4096, 100_003):
        lw = rng.normal(-20.0, 6.0, n).astype(np.float32)
        lw[rng.random(n) < 0.02] = -np.inf
        lw[0] = -5.0
        ess_ref = float(jparallel.sharded_effective_sample_size(jnp.asarray(lw)))
        log_z_ref = float(jparallel.pooled_log_weight_stats(jnp.asarray(lw))[0])
        t = torch.tensor(lw)
        ess, log_sum = parallel.collectives.log_weight_stats_host(t)
        log_z, log_z2, count = parallel.pooled_log_weight_stats(t)
        for value in (ess, float(parallel.sharded_effective_sample_size(t))):
            assert abs(value - ess_ref) <= 1e-5 * ess_ref
        for value in (log_sum, float(log_z)):
            assert abs(value - log_z_ref) <= 1e-5 * abs(log_z_ref)
        assert float(count) == n
    # every weight -inf: ESS 0 and log Z -inf (the JAX package gives NaN)
    t = torch.full((9,), -math.inf)
    assert parallel.collectives.log_weight_stats_host(t) == (0.0, -math.inf)
    assert float(parallel.sharded_effective_sample_size(t)) == 0.0
    assert float(parallel.pooled_log_weight_stats(t)[0]) == -math.inf
    t = torch.tensor([0.0, math.nan])
    assert all(math.isnan(v) for v in parallel.collectives.log_weight_stats_host(t))


# ---------------------------------------------------------------------------
# (d) the replay handlers site by site
# ---------------------------------------------------------------------------


class _Recorder:
    """A proposal step that proposes from the prior and records its calls."""

    def __init__(self):
        self.calls = []

    def reset(self, n):
        self.n = n

    def __call__(self, site, distribution, generator, observed, forced_value=None, defensive=None):
        value = forced_value if forced_value is not None else distribution._sample(generator, (self.n,))
        self.calls.append((site.address, forced_value is not None))
        return value, distribution.log_prob(value) - 0.25


class _Mixed(pp.Model):
    """A Normal, an int64 Categorical and an [N, 2] event site before the
    observe, a rejection block after it."""

    def forward(self):
        mu = pp.sample(Normal(0.0, 1.0))
        k = pp.sample(Categorical(probs=torch.tensor([0.2, 0.3, 0.5], device=pp.util.param_device())))
        z = pp.sample(pp.distributions.MultivariateNormal(torch.zeros(2), torch.eye(2)))
        pp.observe(Normal(mu + k + z[..., 0], 1.0), name="y")

        def attempt():
            u = pp.sample(pp.distributions.Uniform(-1.0, 1.0))
            return u, u * u < 0.5

        return pp.rejection_sample(attempt) + mu


def _handler(n, replay=None, step=None):
    return VectorizedHandler(
        n, torch.Generator().manual_seed(1), pp.TraceMode.POSTERIOR,
        pp.InferenceEngine.IMPORTANCE_SAMPLING if step is None else pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
        {"y": torch.tensor(1.0)}, "forward", proposal_step=step, replay_values=replay,
        record_site_log_iws=step is not None,
    )


def test_batched_replay_keeps_values_dtypes_and_advances_the_proposal():
    model, n = _Mixed(), 64
    first = _handler(n)
    out0 = handler_outputs(first, run_forward(model, first))
    replay = {a: v.flip(0) for a, v in out0["values"].items()}  # every controlled site
    step = _Recorder()
    h = _handler(n, replay, step)
    out = handler_outputs(h, run_forward(model, h))
    for a, v in replay.items():
        assert out["values"][a].dtype == v.dtype and torch.equal(out["values"][a], v)
        assert torch.allclose(out["log_probs"][a], out0["log_probs"][a].flip(0))
    assert out["values"][next(a for a in replay if "Categorical" in a)].dtype == torch.int64
    # every site advanced the proposal with its forced value; nothing proposed
    assert [forced for _, forced in step.calls] == [True] * 4
    # the block was replayed whole: no retry round, no host sync, no weight
    assert h.rejection_rounds == [1] and h.host_syncs == 0 and out["site_log_iws"] == {}
    assert torch.equal(h.log_importance_weight, h.log_prob_observed)
    # a fresh run under guided SMC records each proposed site's prior - proposal
    step = _Recorder()
    h = _handler(n, {a: v for a, v in replay.items() if "Normal" in a}, step)
    out = handler_outputs(h, run_forward(model, h))
    assert set(out["site_log_iws"]) == {a for a in replay if "Normal" not in a}
    for iw in out["site_log_iws"].values():
        assert torch.allclose(iw, torch.full((n,), 0.25))


def test_interpreter_replay_under_is():
    model = TorchMarsagliaWhile()
    gen = model._trace_generator(trace_mode=pp.TraceMode.POSTERIOR, observe=OBSERVE)
    first = next(gen)
    replay = {v.address: v.value for v in first.variables_controlled}
    state._set_smc_replay(replay)
    try:
        again = next(gen)
    finally:
        state._set_smc_replay(None)
    assert [v.address for v in again.variables] == [v.address for v in first.variables]
    for v in again.variables_controlled:
        assert v.reused and v.log_importance_weight is None and torch.equal(v.value, replay[v.address])
    assert again.result == first.result
    assert float(again.log_importance_weight) == pytest.approx(float(first.log_importance_weight), abs=1e-9)


# ---------------------------------------------------------------------------
# (d) the slice as a whole: the JAX tests' criteria
# ---------------------------------------------------------------------------


def _check_gum(post, tol=(0.2, 0.1, 0.25)):
    """tests/test_smc.py:38-51."""
    assert abs(float(post.mean) - POSTERIOR_MEAN) < tol[0]
    assert abs(float(post.stddev) - POSTERIOR_STDDEV) < tol[1]
    assert abs(post.log_evidence - GUM_LOGZ) < tol[2]
    assert post.metadata[-1]["log_evidence"] == post.log_evidence


def test_gum_smc_in_the_jax_package():
    post = JaxGUM().posterior_results(
        num_traces=50_000, observe=OBSERVE, inference_engine=pyprob_tpu.InferenceEngine.SEQUENTIAL_MONTE_CARLO,
        resample_threshold=1.0,
    )
    _check_gum(post)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_gum_smc_each_scheme(scheme):
    post = TorchGUM().posterior_results(
        50_000, observe=OBSERVE, inference_engine=SMC, resample_threshold=1.0, resampling=scheme
    )
    _check_gum(post)
    md = post.metadata[-1]
    assert md["resampling"] == scheme and md["vectorized"] is True and md["resampled_stages"] == [True]
    assert md["stages"] == 2 and md["host_syncs"] == 2


def test_smc_beats_is_ess():
    # tests/test_smc.py:54-65
    is_post = TorchGUM().posterior_results(20_000, observe=OBSERVE, vectorized=True)
    smc = TorchGUM().posterior_results(20_000, observe=OBSERVE, inference_engine=SMC, resample_threshold=1.0)
    assert smc.effective_sample_size > 5 * is_post.effective_sample_size


T, Q, R = 8, 0.5, 0.3  # tests/test_smc.py:68-104


class SSM(pp.Model):
    def forward(self):
        x = pp.sample(Normal(0.0, 1.0), address="x0")
        for t in range(T):
            x = pp.sample(Normal(x, math.sqrt(Q)), address=f"x{t + 1}")
            pp.observe(Normal(x, math.sqrt(R)), name=f"y{t}")
        return x


def test_state_space_matches_kalman():
    ys = [0.3, 0.8, 1.5, 1.1, 2.0, 2.4, 2.2, 3.0]
    post = SSM().posterior_results(30_000, observe={f"y{t}": ys[t] for t in range(T)}, inference_engine=SMC)
    mean, var = 0.0, 1.0
    for y in ys:
        k = (var + Q) / (var + Q + R)
        mean, var = mean + k * (y - mean), (1 - k) * (var + Q)
    assert abs(float(post.mean) - mean) < 0.05
    assert abs(float(post.variance) - var) < 0.05
    assert post.effective_sample_size > 0.2 * 30_000
    md = post.metadata[-1]
    assert md["stages"] == T and md["resample_threshold"] == 0.5 and len(md["stage_ess"]) == T
    assert len(md["resampled_stages"]) == T - 1


TRANS = np.array([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6]])  # tests/test_smc.py:124-167
INIT = np.array([0.5, 0.3, 0.2])
EMIT_LOC, EMIT_SCALE = np.array([-1.0, 0.0, 1.5]), 0.6


class HMM(pp.Model):
    def forward(self):
        device = pp.util.param_device()
        trans = torch.tensor(TRANS, dtype=torch.float32, device=device)
        locs = torch.tensor(EMIT_LOC, dtype=torch.float32, device=device)
        z = pp.sample(Categorical(probs=torch.tensor(INIT, dtype=torch.float32, device=device)), address="z0")
        for t in range(6):
            pp.observe(Normal(locs[z], EMIT_SCALE), name=f"y{t}")
            if t < 5:
                z = pp.sample(Categorical(probs=trans[z]), address=f"z{t + 1}")
        return z


def test_hmm_integer_sites():
    ys = [-0.8, -1.2, 0.1, 0.3, 1.4, 1.6]
    post = HMM().posterior_results(30_000, observe={f"y{t}": ys[t] for t in range(6)}, inference_engine=SMC)
    alpha = INIT.copy()
    for t, y in enumerate(ys):
        alpha = alpha * np.exp(-0.5 * ((y - EMIT_LOC) / EMIT_SCALE) ** 2)
        if t < 5:
            alpha = alpha @ TRANS
    values = np.asarray(post.get_values())
    assert values.dtype == np.int64
    w = np.asarray(post.weights, np.float64)
    est = np.array([w[values == k].sum() for k in range(3)])
    assert np.allclose(est, alpha / alpha.sum(), atol=0.03)


def test_rejection_blocks_under_replay():
    # tests/test_rejection.py:137-144
    post = GaussianUnknownMeanMarsagliaRejection().posterior_results(
        20_000, observe=OBSERVE, inference_engine=SMC
    )
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.2
    assert abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.2
    assert post.metadata[-1]["vectorized"] is True


@pytest.mark.parametrize("scheme", ["systematic", "stratified"])
def test_interpreter_filter_falls_back(scheme):
    # tests/test_smc.py:192-203 and tests/test_resampling.py:146-156
    post = TorchMarsagliaWhile().posterior_results(
        2000, observe=OBSERVE, inference_engine=SMC, resample_threshold=1.0, resampling=scheme
    )
    md = post.metadata[-1]
    assert md["vectorized"] is False and md["resampling"] == scheme and md["stages"] == 2
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.6
    assert abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.35
    assert abs(post.log_evidence - GUM_LOGZ) < 1.0
    assert md["log_evidence"] == post.log_evidence


class _OneOrTwoObserves(pp.Model):
    """The second observe is met only when k = 1: a particle with k = 0 is
    past its last observe at stage 2."""

    def forward(self):
        mu = pp.sample(Normal(1.0, math.sqrt(5.0)))
        k = pp.sample(Categorical(probs=torch.tensor([0.5, 0.5], device=pp.util.param_device())))
        likelihood = Normal(mu, math.sqrt(2.0))
        pp.observe(likelihood, name="obs0")
        if int(k) == 1:
            pp.observe(likelihood, name="obs1")
        return k


def test_interpreter_filter_with_a_drawn_observe_count():
    post = _OneOrTwoObserves().posterior_results(2000, observe=OBSERVE, inference_engine=SMC, resample_threshold=1.0)
    assert post.metadata[-1]["stages"] == 2 and post.metadata[-1]["vectorized"] is False
    # p(k = 1 | obs) = 0.5 p(8, 9) / (0.5 p(8) + 0.5 p(8, 9))
    p8 = math.exp(-0.5 * 49.0 / 7.0) / math.sqrt(2 * math.pi * 7.0)
    share = math.exp(GUM_LOGZ) / (p8 + math.exp(GUM_LOGZ))
    assert abs(float(post.mean) - share) < 0.03
    assert abs(post.log_evidence - math.log(0.5 * p8 + 0.5 * math.exp(GUM_LOGZ))) < 0.2


def test_conditional_model_runs_the_interpreter_filter():
    conditional = TorchGUM().condition(lambda trace: float(trace.result) > 0.0)
    post = conditional.posterior_results(500, observe=OBSERVE, inference_engine=SMC, resampling="residual")
    assert post.metadata[-1]["vectorized"] is False and abs(float(post.mean) - POSTERIOR_MEAN) < 0.6


def _trained(network, seed):
    pp.seed(seed)
    model = TorchGUM()
    kwargs = {"lstm_dim": 32} if network == "LSTM" else {}
    model.learn_inference_network(
        num_traces=4000, observe_embeddings={"obs0": {"dim": 8}, "obs1": {"dim": 8}},
        inference_network=getattr(pp.InferenceNetwork, network), batch_size=256, learning_rate_init=0.01,
        **kwargs,
    )
    return model


@pytest.mark.parametrize("network", ["LSTM", "FEEDFORWARD"])
def test_guided_smc(network):
    # tests/test_smc.py:226-274's recipe and criteria over four training
    # seeds: the mean, log Z and ESS on each, the stddev on three of them
    # (a network trained for 16 steps is a draw: with the LSTM the JAX
    # package meets the stddev criterion on 6 of 8 CPU seeds, the port on
    # 7, tests/smc_reference.py)
    stddev_met = 0
    for seed in range(4):
        model = _trained(network, seed)
        post = model.posterior_results(20_000, observe=OBSERVE, inference_engine=GUIDED, resample_threshold=1.0)
        assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.2
        assert abs(post.log_evidence - GUM_LOGZ) < 0.3
        assert post.effective_sample_size > 0.2 * 20_000
        assert "WITH_INFERENCE_NETWORK" in post.metadata[-1]["inference_engine"]
        stddev_met += abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.1
        # the cached step holds no batch after the filter
        step = model._inference_network.cached_vectorized_proposal_step(OBSERVE)
        if network == "LSTM":
            assert step.get_state()[0][0].shape[1] == 0
    assert stddev_met >= 3


def test_guided_smc_through_rejection_blocks():
    # tests/test_rejection.py:147-180's recipe, its guided-SMC criterion
    pp.seed(0)
    model = GaussianUnknownMeanMarsagliaRejection()
    model.learn_inference_network(
        num_traces=16000, observe_embeddings={"obs0": {"dim": 16}, "obs1": {"dim": 16}},
        inference_network=pp.InferenceNetwork.LSTM, lstm_dim=64, batch_size=512, learning_rate_init=0.005,
    )
    post = model.posterior_results(5000, observe=OBSERVE, inference_engine=GUIDED)
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.25


# ---------------------------------------------------------------------------
# (e) errors and metadata
# ---------------------------------------------------------------------------


def test_errors():
    with pytest.raises(RuntimeError, match="observe"):
        TorchGUM().posterior(num_traces=100, inference_engine=SMC)
    with pytest.raises(RuntimeError, match="observe"):
        TorchMarsagliaWhile().posterior(num_traces=10, inference_engine=SMC, vectorized=False)
    for vectorized in (None, False):
        with pytest.raises(ValueError, match="Unknown resampling scheme"):
            TorchGUM().posterior_results(
                100, observe=OBSERVE, inference_engine=SMC, resampling="bogus", vectorized=vectorized
            )
    with pytest.raises(RuntimeError, match="inference network"):
        TorchGUM().posterior(num_traces=100, observe=OBSERVE, inference_engine=GUIDED)
    # an untraceable model: guided SMC raises, with or without a network
    with pytest.raises(RuntimeError):
        TorchMarsagliaWhile().posterior(num_traces=100, observe=OBSERVE, inference_engine=GUIDED)
    with pytest.raises(RuntimeError, match="batched tier"):
        TorchGUM().posterior(num_traces=100, observe=OBSERVE, inference_engine=GUIDED, vectorized=False)
    with pytest.raises(NotImplementedError, match="distributed slice"):
        pp.inference.vectorized_smc_posterior(TorchGUM(), 10, observe=OBSERVE, mesh=object())
    with pytest.raises(NotImplementedError, match="distributed slice"):
        TorchGUM().posterior(num_traces=10, observe=OBSERVE, inference_engine=SMC, mesh=object())
    # PT and tempered SMC run on the batched tier only: a short run there,
    # and the gradient engines' error on the interpreter tier
    for engine, knobs in ((pp.InferenceEngine.PARALLEL_TEMPERING, {"num_chains": 2, "burn_in": 4}),
                          (pp.InferenceEngine.TEMPERED_SMC, {"max_stages": 3})):
        post = TorchGUM().posterior_results(10, observe=OBSERVE, inference_engine=engine, vectorized=None, **knobs)
        assert post.length == 10 and post.metadata[-1]["inference_engine"] == f"InferenceEngine.{engine.name}"
        with pytest.raises(RuntimeError, match="no interpreter tier"):
            TorchGUM().posterior_results(10, observe=OBSERVE, inference_engine=engine, vectorized=False)


@pytest.mark.parametrize("vectorized", [None, False], ids=["batched", "interpreter"])
def test_metadata_and_traces(vectorized, tmp_path):
    post = TorchGUM().posterior(
        400, observe=OBSERVE, inference_engine=SMC, vectorized=vectorized, file_name=str(tmp_path / "smc")
    )
    md = post.metadata[-1]
    for key in ("stages", "stage_ess", "resampled_stages", "resample_threshold", "resampling", "log_evidence"):
        assert key in md
    assert md["vectorized"] is (vectorized is None) and md["inference_engine"] == "InferenceEngine.SEQUENTIAL_MONTE_CARLO"
    assert post.log_evidence == md["log_evidence"] and post.length == 400
    trace = post.sample()
    assert [v.name for v in trace.variables_observed] == ["obs0", "obs1"] and trace.length_controlled == 1
