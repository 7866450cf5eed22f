"""Lockstep guided inference on the interpreter tier
(``pyprob_tpu_torch/interpreter_lockstep.py``), on the CPU, after
``tests/test_interpreter_lockstep.py``: K worker threads run ``forward``
one trace each, and every proposal site of a round is answered by one
batched network step.

Row by row: one round of parked sites of the while-loop Marsaglia model
(trace starts and steady sites at 1-3 attempts, rows out of worker order,
random carried states) answers each row as the port's sequential
``_infer_step`` does from the same carried state and previous variable
(log q and log p of the drawn value, the head's proposal elsewhere, the
carry written back: 1e-5), and that step is the JAX package's (1e-5).
Statistically, against the sequential loop (the same network,
``lockstep=False``) and the analytic GUM posterior N(7.25, √(1/1.2)):
GUM's statistics agree and its ESS fractions (near 0.57 with this
network) within 15 % of each other; the while-loop Marsaglia model,
trained on the interpreter tier, stays above the JAX package's floor
0.004; one seed gives the same posterior twice; and a ``rejection_sample``
block retries inside the workers (the recurrent state restored per
retry, retries scored against the defensive mixture).  The networks are
small (lstm_dim 16).
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pyprob_tpu_torch as pp
from pyprob_tpu_torch import interpreter_lockstep as L, state
from pyprob_tpu_torch.models import GaussianUnknownMean, GaussianUnknownMeanMarsaglia
from pyprob_tpu_torch.util import InferenceEngine as TEngine, InferenceNetwork as TNet

import chip_smoke
import pyprob_tpu
from pyprob_tpu.nn.dataset import Batch as JBatch, prune_trace as jprune
from _torch_parity import (
    OBSERVE,
    POSTERIOR_MEAN,
    POSTERIOR_STDDEV,
    JaxMarsagliaWhile,
    TorchMarsaglia,
    TorchMarsagliaWhile,
    carry,
    jax_network,
    port_trace,
)

torch.set_num_threads(2)
IC = TEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.set_verbosity(1)
    yield


def _train(model, num_traces, seed):
    pp.set_device("cpu")
    pp.seed(seed)
    model.learn_inference_network(
        num_traces=num_traces,
        observe_embeddings={"obs0": {"dim": 16}, "obs1": {"dim": 16}},
        inference_network=TNet.LSTM,
        batch_size=256,
        learning_rate_init=0.005,
        lstm_dim=16,
    )
    return model


@pytest.fixture(scope="module")
def round_setup():
    """A JAX network (untrained, polymorphed on the chosen traces) carried
    into the port, and while-loop Marsaglia traces of the JAX package's
    interpreter that fill one round of 32 workers: every number of
    attempts met, so trace starts and steady sites of each depth; each
    port variable mapped to its JAX one."""
    pyprob_tpu.seed(3)
    jtraces = JaxMarsagliaWhile().prior(num_traces=200, vectorized=False).get_values()
    ttraces = [port_trace(t) for t in jtraces]
    chosen = chip_smoke.round_traces(ttraces, workers=32)
    jchosen = [jtraces[ttraces.index(t)] for t in chosen]
    jnet = jax_network(JaxMarsagliaWhile(), vectorized=False)
    jnet._polymorph(JBatch([jprune(t) for t in jchosen]))
    tnet = carry(jnet, TorchMarsagliaWhile())
    jvar = {}
    for jt, tt in zip(jchosen, chosen):
        jvar.update(zip(map(id, tt.variables_controlled), jt.variables_controlled))
    return jnet, tnet, chosen, jvar


def test_lockstep_round_answers_each_row_as_the_sequential_step(round_setup):
    jnet, tnet, traces, jvar = round_setup
    assert len({t.length_controlled for t in traces}) >= 3  # 1, 2, 3+ attempts
    errs = chip_smoke.lockstep_round_vs_sequential(tnet, OBSERVE, traces, workers=32, seed=5)
    rows = errs["rows"]
    assert sum(t.length_controlled for t in traces) == len(rows) <= 32
    # two buckets: the trace starts and the steady sites (every Uniform
    # head in one group), each answered at its own workers' columns
    starts = [cols for start, cols in errs["buckets"] if start]
    steady = [cols for start, cols in errs["buckets"] if not start]
    assert len(starts) == len(steady) == 1
    assert len(starts[0]) == len(traces) and len(steady[0]) == len(rows) - len(traces)
    assert any(a > b for a, b in zip(steady[0], steady[0][1:]))  # not in worker order
    for key in ("log_q", "head", "log_p", "carry"):
        assert errs[key] <= 1e-5, (key, errs[key])
        assert errs[key + "_ref"] > 0.1, key  # the references are not all zero
    assert errs["untouched"] == 0.0
    # the sequential step from each row's carried state is the JAX package's
    jnet._infer_init(OBSERVE)
    tnet._infer_init({k: torch.tensor(v) for k, v in OBSERVE.items()})
    for v, prev, carried in rows:
        jnet._infer_lstm_state = None if carried is None else tuple(jnp.asarray(x.numpy()) for x in carried)
        tnet._infer_lstm_state = carried
        jd = jnet._infer_step(jvar[id(v)], prev_variable=None if prev is None else jvar[id(prev)])
        td = tnet._infer_step(v, prev_variable=prev)
        means, stddevs, _, _ = td._tnorm_params
        np.testing.assert_allclose(td.probs.numpy(), np.asarray(jd.probs), atol=1e-5)
        jmeans = np.stack([np.asarray(c.mean_non_truncated) for c in jd.distributions], -1)
        jstd = np.stack([np.asarray(c.stddev_non_truncated) for c in jd.distributions], -1)
        np.testing.assert_allclose(means.numpy(), jmeans, atol=1e-5)
        np.testing.assert_allclose(stddevs.numpy(), jstd, atol=1e-5)
        for j, t in zip(jnet._infer_lstm_state, tnet._infer_lstm_state):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def _check_gum(post, tol=0.75):
    mean, stddev = float(post.mean), float(post.stddev)
    assert abs(mean - POSTERIOR_MEAN) < tol, mean
    assert abs(stddev - POSTERIOR_STDDEV) < tol, stddev
    # KL(N(mean, stddev) || posterior) < 0.25, as the JAX package's test
    s2, t2 = max(stddev, 1e-3) ** 2, POSTERIOR_STDDEV**2
    kl = 0.5 * (s2 / t2 + (mean - POSTERIOR_MEAN) ** 2 / t2 - 1.0 + math.log(t2 / s2))
    assert kl < 0.25, kl


@pytest.fixture(scope="module")
def gum():
    # trained far enough that the ESS fraction (about 0.57) is estimated to
    # a few per cent by a few hundred traces
    return _train(GaussianUnknownMean(), 32_768, seed=7)


def test_lockstep_matches_the_sequential_loop_on_gum(gum):
    pp.seed(1)
    n = 512
    post = gum.posterior_results(n, observe=OBSERVE, vectorized=False, inference_engine=IC)
    _check_gum(post)
    meta = post.metadata[0]
    assert meta["lockstep_workers"] == 64
    # one site a trace: each round answers up to 64 parked sites
    assert sum(meta["lockstep_round_rows"]) == n and max(meta["lockstep_round_rows"]) <= 64
    assert meta["lockstep_rounds"] >= n // 64
    seq = gum.posterior_results(
        256, observe=OBSERVE, vectorized=False, inference_engine=IC, lockstep=False
    )
    assert "lockstep_workers" not in seq.metadata[0]
    _check_gum(seq)
    f_lock, f_seq = post.effective_sample_size / n, seq.effective_sample_size / 256
    assert f_seq > 0.3 and abs(f_lock / f_seq - 1) < 0.15, (f_lock, f_seq)


def test_lockstep_gives_the_same_posterior_for_the_same_seed(gum):
    runs = []
    for _ in range(2):
        pp.seed(42)
        post = gum.posterior_results(
            192, observe=OBSERVE, vectorized=False, inference_engine=IC, lockstep=16
        )
        runs.append(np.sort(np.asarray(post.get_values(), np.float64)))
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-6)
    pp.seed(43)
    other = gum.posterior_results(
        192, observe=OBSERVE, vectorized=False, inference_engine=IC, lockstep=16
    )
    assert not np.allclose(np.sort(np.asarray(other.get_values(), np.float64)), runs[0])


def test_lockstep_marsaglia_while_loop_above_the_floor():
    model = _train(GaussianUnknownMeanMarsaglia(), 1536, seed=11)
    net = model._inference_network
    assert net._gather_used  # trained on the interpreter tier's mixed batches
    pp.seed(2)
    n = 800
    post = model.posterior_results(n, observe=OBSERVE, vectorized=False, inference_engine=IC)
    _check_gum(post)
    assert post.effective_sample_size > 0.004 * n  # the JAX package's floor
    # the rounds meet several trace structures (1, 2, ... attempts)
    rows = post.metadata[0]["lockstep_round_rows"]
    assert sum(rows) > 2 * n


def test_lockstep_rejection_block_retries_inside_the_workers(monkeypatch):
    # trained on the batched tier: the block's sites keep instance 1, so
    # the network serves them on either tier
    model = _train(TorchMarsaglia(), 768, seed=5)
    retries = []
    infer_step = L.LockstepCoordinator.infer_step

    def counted(self, idx, proxy, variable, prev_variable):
        # a retry restarts the block from the pre-block (trace-start) state
        if state._ctx_local.value.rejection_retry:
            retries.append(proxy._infer_lstm_state is None)
        return infer_step(self, idx, proxy, variable, prev_variable)

    monkeypatch.setattr(L.LockstepCoordinator, "infer_step", counted)
    pp.seed(3)
    n = 384
    post = model.posterior_results(n, observe=OBSERVE, vectorized=False, inference_engine=IC)
    assert len(retries) > 0.1 * n and retries.count(True) == len(retries) // 2
    assert np.isfinite(float(post.mean)) and post.effective_sample_size > 1
