"""The HMM, Beta–Bernoulli, Gamma–Poisson, Laplace-prior and
Beta–NegativeBinomial inference-compilation paths of the port against the
JAX package's, on the CPU, at small widths.

Networks carried from the JAX package (untrained, lstm_dim 16, 3 mixture
components, 4-d observe embeddings): the training loss and every gradient
on a batch packed from the port's batched tier, for pyprob's HMM (17
categorical sites: categorical heads, one-hot sample embeddings) with the
LSTM and the feedforward network, and for the Beta–Bernoulli (the
truncated-Normal head on Beta's bounds, kernel 2's path) and Gamma–Poisson
(the LogNormal-mixture head) feedforward networks, for the Laplace-prior
model (the StudentT-mixture head) with both networks, its batch holding
draws of 10^6 and beyond, and for the Beta–NegativeBinomial feedforward
network (the Beta head again): the loss to 1e-5 relative, the gradients
to 1e-5 relative in the 2-norm over every element (each element within
1e-5 + 1e-4 |ref| for the Beta and StudentT-mixture heads).  The gather
loss on HMM traces and on the interpreter-only Laplace model's traces
equals the per-type loss.  One lockstep round of HMM sites, and one of
Laplace sites, answers each row as the sequential step does (1e-5 (1 +
|ref|)).  Saving and loading the networks keeps everything and serves
the same seeded posterior.  ``factor`` on both tiers gives the JAX
package's weights; the Branching models and the HMM's prior IS hold to
their enumerated posteriors.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu_torch import vectorized as V
from pyprob_tpu_torch.nn import Batch, InferenceNetwork
from pyprob_tpu_torch.nn.layers import map_tensors, tensor_leaves
from pyprob_tpu_torch.util import InferenceEngine as TEngine, InferenceNetwork as TNet

import chip_smoke
from _torch_parity import (
    BETA_BERNOULLI_OBSERVE,
    HMM_OBSERVE,
    LAPLACE_OBSERVE,
    NB_OBSERVE,
    JaxBetaBernoulli,
    JaxGammaPoisson,
    JaxHMM,
    JaxLaplace,
    JaxNB,
    TorchBetaBernoulli,
    TorchGammaPoisson,
    TorchHMM,
    TorchLaplace,
    TorchLaplaceInterpreter,
    TorchNB,
    carry,
    carry_ff,
    jax_ff_network,
    jax_network,
    unwrap_static,
)

torch.set_num_threads(2)
IC = TEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
GAMMA_POISSON_OBSERVE = {"obs0": 3.0, "obs1": 5.0}
ROWS = 32


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.set_verbosity(0)
    pp.seed(0)
    yield


def _arrays(tree, path=()):
    if isinstance(tree, np.ndarray):
        return {path: tree}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_arrays(v, path + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_arrays(v, path + (i,)))
    return out


# case: (JAX model, port model, observe names, network, per-element
# gradient tolerance? (the truncated-Normal and StudentT-mixture heads))
CASES = {
    "hmm_lstm": (JaxHMM, TorchHMM, tuple(HMM_OBSERVE), "lstm", False),
    "hmm_ff": (JaxHMM, TorchHMM, tuple(HMM_OBSERVE), "ff", False),
    "beta_bernoulli_ff": (JaxBetaBernoulli, TorchBetaBernoulli, tuple(BETA_BERNOULLI_OBSERVE), "ff", True),
    "gamma_poisson_ff": (JaxGammaPoisson, TorchGammaPoisson, tuple(GAMMA_POISSON_OBSERVE), "ff", False),
    "laplace_lstm": (JaxLaplace, TorchLaplace, tuple(LAPLACE_OBSERVE), "lstm", True),
    "laplace_ff": (JaxLaplace, TorchLaplace, tuple(LAPLACE_OBSERVE), "ff", True),
    "beta_nb_ff": (JaxNB, TorchNB, tuple(NB_OBSERVE), "ff", True),
}
OBSERVES = {
    "hmm": HMM_OBSERVE, "beta_bernoulli": BETA_BERNOULLI_OBSERVE, "gamma_poisson": GAMMA_POISSON_OBSERVE,
    "laplace": LAPLACE_OBSERVE, "beta_nb": NB_OBSERVE,
}


def _carried(case):
    jcls, tcls, names, kind, _ = CASES[case]
    if kind == "lstm":
        jnet = jax_network(jcls(), observe_names=names)
        return jnet, carry(jnet, tcls())
    jnet = jax_ff_network(jcls(), observe_names=names)
    return jnet, carry_ff(jnet, tcls())


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match(case):
    jnet, tnet = _carried(case)
    pp.seed(3)
    outputs, sites = V.run_training_batch(CASES[case][1](), ROWS)
    packed, addrs, dist_names = tnet._pack_arrays_from_outputs(outputs, sites, ROWS)
    if case.startswith("laplace"):
        # heavy-tailed prior draws: the loss stays finite and equal at 10^6
        packed["steps"][0]["values"][:4] = torch.tensor([1e6, -1e6, 3e7, -2.5e4])
    batch = pp.nn.PackedBatch(packed, ROWS, addrs, dist_names)
    for p in tensor_leaves(tnet._params):
        p.requires_grad_(True)
    loss = float(tnet._loss_and_grad(batch))
    _, loss_fn = jnet._make_loss_for(addrs, dist_names)
    jpacked = jax.tree_util.tree_map(lambda t: jnp.asarray(t.contiguous().numpy()), packed)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jnet._loss_params_subset(addrs, dist_names), jpacked)
    # the Beta–NegativeBinomial batch's loss is a sum of log q of both signs
    # that cancels to near 0 (about −7e-4 a row): 1e-6 a row beside 1e-5 relative
    loss_abs = 1e-6 if case == "beta_nb_ff" else 0.0
    assert math.isfinite(loss) and loss == pytest.approx(float(jloss) / ROWS, rel=1e-5, abs=loss_abs)
    port = _arrays(tnet.to_numpy(map_tensors(tnet._params, lambda t: t.grad)))
    ref = {k: v / ROWS for k, v in _arrays(unwrap_static(jgrads)).items()}
    assert port.keys() == ref.keys()
    if CASES[case][4]:
        for path in ref:
            np.testing.assert_allclose(ROWS * port[path], ROWS * ref[path], atol=1e-5, rtol=1e-4, err_msg=str(path))
    else:
        diff = math.sqrt(sum(float(np.sum((port[p].astype(np.float64) - ref[p]) ** 2)) for p in ref))
        norm = math.sqrt(sum(float(np.sum(ref[p].astype(np.float64) ** 2)) for p in ref))
        assert diff <= 1e-5 * norm, (diff, norm)
    assert max(np.abs(a).max() for a in port.values()) > 1e-4


def _trained(model, network, names, traces=512, **kw):
    pp.seed(5)
    model.learn_inference_network(
        num_traces=traces, observe_embeddings={n: {"dim": 4} for n in names}, inference_network=network,
        batch_size=128, learning_rate_init=0.005, lstm_dim=16, proposal_mixture_components=3,
        ema_decay=0.9, **kw,
    )
    return model


@pytest.fixture(scope="module")
def hmm_networks():
    pp.set_device("cpu")
    return {net: _trained(TorchHMM(), net, HMM_OBSERVE) for net in (TNet.LSTM, TNet.FEEDFORWARD)}


def test_gather_loss_equals_the_per_type_loss_on_hmm_traces(hmm_networks):
    from pyprob_tpu_torch.nn.dataset import OnlineDataset

    net = hmm_networks[TNet.LSTM]._inference_network
    batch = Batch(OnlineDataset(TorchHMM()).next_batch(24))  # training traces, observes drawn
    per_type = net._per_type_loss(batch)
    grads = torch.autograd.grad(per_type, tensor_leaves(net._params), allow_unused=True)
    net._gather_used = True  # serve a one-type batch with the gather loss too
    try:
        gathered = net._try_gather_loss(batch)
    finally:
        net._gather_used = False
    assert gathered is not None
    assert float(gathered.detach()) == pytest.approx(float(per_type.detach()), rel=1e-5)
    ggrads = torch.autograd.grad(gathered, tensor_leaves(net._params), allow_unused=True)
    for a, b in zip(grads, ggrads):
        if a is None:
            assert b is None or float(b.abs().max()) == 0.0
        else:
            torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("network", [TNet.LSTM, TNet.FEEDFORWARD], ids=["lstm", "ff"])
def test_hmm_lockstep_round_matches_the_sequential_step(hmm_networks, network):
    model = hmm_networks[network]
    traces = model.posterior(8, observe=HMM_OBSERVE, vectorized=False, inference_engine=IC).get_values()
    assert all(t.length_controlled == 17 for t in traces)
    errs = chip_smoke.lockstep_round_vs_sequential(
        model._inference_network, HMM_OBSERVE, chip_smoke.round_traces(traces)
    )
    assert len(errs["rows"]) == 51  # three traces of 17 sites fill a round of 64 workers
    for key in ("log_q", "head", "log_p", "carry"):
        assert errs[key] <= 1e-5 * (1 + errs[key + "_ref"]), (key, errs[key])
    assert errs["untouched"] == 0.0
    # served values are category indices, as the sequential step draws them
    assert all(v.value.dtype == torch.int64 for t in traces for v in t.variables_controlled)


@pytest.fixture(scope="module")
def laplace_networks():
    """The Laplace-prior model's LSTM trained on the interpreter tier (its
    _never_vectorize copy, with two trace types) and its feedforward network
    trained batched."""
    pp.set_device("cpu")
    return {TNet.LSTM: _trained(TorchLaplaceInterpreter(), TNet.LSTM, LAPLACE_OBSERVE),
            TNet.FEEDFORWARD: _trained(TorchLaplace(), TNet.FEEDFORWARD, LAPLACE_OBSERVE)}


def test_gather_loss_equals_the_per_type_loss_on_laplace_traces(laplace_networks):
    """The StudentT-mixture head through the gather loss, on interpreter
    traces of both trace types holding draws of 10^6 and beyond: value and
    gradients equal the per-type loss's."""
    from pyprob_tpu_torch.nn.dataset import OnlineDataset

    model = laplace_networks[TNet.LSTM]
    net = model._inference_network
    assert net._gather_used  # training took it by itself
    traces = OnlineDataset(model).next_batch(24)
    for t, v in zip(traces, (1e6, -3e7, 2.5e4)):
        t.variables_controlled[0].value = torch.tensor(v)
    batch = Batch(traces)
    assert len(batch.sub_batches) == 2
    per_type = net._per_type_loss(batch)
    grads = torch.autograd.grad(per_type, tensor_leaves(net._params), allow_unused=True)
    gathered = net._try_gather_loss(batch)
    assert gathered is not None and math.isfinite(float(gathered.detach()))
    assert float(gathered.detach()) == pytest.approx(float(per_type.detach()), rel=1e-5)
    ggrads = torch.autograd.grad(gathered, tensor_leaves(net._params), allow_unused=True)
    for a, b in zip(grads, ggrads):
        if a is None:
            assert b is None or float(b.abs().max()) == 0.0
        else:
            torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("network", [TNet.LSTM, TNet.FEEDFORWARD], ids=["lstm", "ff"])
def test_laplace_lockstep_round_matches_the_sequential_step(laplace_networks, network):
    model = laplace_networks[network]
    traces = model.posterior(80, observe=LAPLACE_OBSERVE, vectorized=False, inference_engine=IC).get_values()
    errs = chip_smoke.lockstep_round_vs_sequential(
        model._inference_network, LAPLACE_OBSERVE, chip_smoke.round_traces(traces)
    )
    assert len(errs["rows"]) == 64
    for key in ("log_q", "head", "log_p", "carry"):
        assert errs[key] <= 1e-5 * (1 + errs[key + "_ref"]), (key, errs[key])
    assert errs["untouched"] == 0.0


@pytest.mark.parametrize(
    "case", ["hmm_lstm", "hmm_ff", "beta_bernoulli_ff", "gamma_poisson_ff", "laplace_lstm", "laplace_ff"]
)
def test_save_and_load_round_trip(case, hmm_networks, laplace_networks, tmp_path):
    _, tcls, names, kind, _ = CASES[case]
    network = TNet.LSTM if kind == "lstm" else TNet.FEEDFORWARD
    if tcls is TorchHMM:
        model = hmm_networks[network]
    elif tcls is TorchLaplace:
        model = laplace_networks[network]
        tcls = type(model)
    else:
        model = _trained(tcls(), network, names)
    observe = OBSERVES[case.rpartition("_")[0]]
    path = str(tmp_path / "net.network")
    model.save_inference_network(path)
    loaded = tcls()
    loaded.load_inference_network(path)
    chip_smoke.check_networks_equal(model._inference_network, loaded._inference_network, case)
    served = []
    for m in (model, loaded):
        pp.seed(11)
        post = m.posterior_results(2000, observe=observe, vectorized=True, inference_engine=IC)
        served.append((np.asarray(post.mean).tolist(), post.effective_sample_size))
    assert served[0] == served[1]
    data = InferenceNetwork._load(path)
    assert data._head_meta == model._inference_network._head_meta


def test_factor_on_both_tiers_gives_the_jax_packages_weights():
    def body(lib):
        x = lib.sample(lib.distributions.Normal(0.0, 1.0), name="x")
        lib.factor(log_prob_func=lambda v: -2.0 * x * x)
        lib.factor(log_prob=-0.75)
        return x

    class J(pyprob_tpu.Model):
        def forward(self):
            return body(pyprob_tpu)

    class T(pp.Model):
        def forward(self):
            return body(pp)

    for vectorized in (True, False):
        ref = J().posterior(4, observe={"x": 0.6}, vectorized=vectorized).get_values()
        got = T().posterior(4, observe={"x": 0.6}, vectorized=vectorized).get_values()
        for r, g in zip(ref, got):
            assert g.log_importance_weight == pytest.approx(float(r.log_importance_weight), rel=1e-6)
            factors = [v for v in g.variables_observed if v.name is None]
            assert len(factors) == 2 and [float(v.log_prob) for v in factors] == pytest.approx([-0.72, -0.75])


def test_branching_models_hold_to_the_enumerated_posterior():
    from pyprob_tpu.models import Branching as JBranching
    from pyprob_tpu_torch.models import Branching, BranchingCompiled

    tp, jtp = Branching().true_posterior(6), JBranching().true_posterior(6)
    np.testing.assert_allclose(tp.log_weights, np.asarray(jtp.log_weights), rtol=1e-5, atol=1e-4)
    assert float(tp.mean) == pytest.approx(float(jtp.mean), abs=1e-4)
    pp.seed(1)
    post = BranchingCompiled().posterior_results(100_000, observe={"obs": 6.0}, vectorized=True)
    assert V._TraceabilityCache._cache.get(BranchingCompiled) is True
    assert abs(float(post.mean) - float(tp.mean)) < 0.15 and abs(float(post.stddev) - float(tp.stddev)) < 0.15
    post = Branching().posterior_results(2000, observe={"obs": 6.0})
    assert V._TraceabilityCache._cache.get(Branching) is False
    assert abs(float(post.mean) - float(tp.mean)) < 0.3


def test_hmm_prior_is_holds_to_the_posterior_table():
    from pyprob_tpu_torch.models import HiddenMarkovModel
    from _torch_parity import HMM_INIT, HMM_MEANS, HMM_T

    pp.seed(2)
    m = HiddenMarkovModel(HMM_INIT, HMM_T, HMM_MEANS, 1.0, 16)
    post = m.posterior_results(5000, observe=HMM_OBSERVE, vectorized=True)
    l2, kl = chip_smoke.hmm_l2_kl(np.asarray(post.mean))
    assert post.effective_sample_size > 0.001 * 5000 and l2 < 3 and kl < 1
    (trace,) = m.prior(1, vectorized=False).get_values()
    assert np.asarray(trace.result).shape == (17, 3) and np.asarray(trace.result).sum() == 17
