"""The port's feedforward inference network
(``pyprob_tpu_torch/nn/inference_network_feedforward.py``) against the
JAX package's, on the CPU.

(i) Deterministic, on a JAX feedforward network carried into the port (3
mixture components, 4-d observe embeddings, untrained): the training loss
and every gradient on a GUM batch packed from the port's batched tier
(Normal head, kernel 1's path) and on a batch of while-loop Marsaglia
traces of two trace types drawn by the JAX package's interpreter
(Uniform heads, kernel 2's path, one per-type loss each): the loss to
1e-5 relative, the GUM gradients to 1e-5 relative in the 2-norm over
every element, the Uniform heads' as the LSTM's are held (1e-5 + 1e-4
|ref|, float32 cancellation); one
Adam step's parameters to 1e-5; the batched tier's proposal step, forced
and defensive, and the interpreter's ``_infer_step``, to 1e-5.  (ii) The
serving paths of a network trained by ``learn_inference_network`` with
its default network (GUM, ``tests/test_train.py``'s recipe for its 0.15
floor: 16,000 traces, batch 512, lr 0.005, 16-d observe embeddings):
batched guided IS (mean within 0.6, ESS above 0.15 N) and lockstep (ESS
above 0.05 N, the JAX package's lockstep floor; one seed gives the same
posterior twice).  (iii) Rejection retries on the batched tier propose
from the network, and one lockstep round answers each row as the
sequential step does.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu.distributions import Normal as JNormal
from pyprob_tpu.nn.dataset import Batch as JBatch, OnlineDataset as JOnline, prune_trace as jprune
from pyprob_tpu.util import Optimizer as JOpt
from pyprob_tpu.vectorized import SiteRecord as JSite
from pyprob_tpu_torch import vectorized as V
from pyprob_tpu_torch.distributions import Normal
from pyprob_tpu_torch.models import GaussianUnknownMean
from pyprob_tpu_torch.nn import Batch, InferenceNetworkFeedForward
from pyprob_tpu_torch.nn.layers import map_tensors, tensor_leaves
from pyprob_tpu_torch.util import InferenceEngine as TEngine, Optimizer as TOpt

import chip_smoke
from _torch_parity import (
    OBSERVE,
    POSTERIOR_MEAN,
    JaxGUM,
    JaxMarsagliaWhile,
    TorchGUM,
    TorchMarsaglia,
    TorchMarsagliaWhile,
    carry_ff,
    jax_ff_network,
    port_trace,
    unwrap_static,
)

torch.set_num_threads(2)
IC = TEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
LR = 1e-3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.set_verbosity(1)
    pp.seed(0)
    yield


def _arrays(tree, path=()):
    """{key path: array} of the numpy leaves of a nested dict/list."""
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


def _assert_relative(port, ref, rtol=1e-5):
    """The gradient trees' relative error in the 2-norm over every
    element: |port − ref| <= rtol |ref|."""
    port, ref = _arrays(port), _arrays(unwrap_static(ref))
    assert port.keys() == ref.keys()
    diff = math.sqrt(sum(float(np.sum((port[p].astype(np.float64) - ref[p]) ** 2)) for p in ref))
    norm = math.sqrt(sum(float(np.sum(ref[p].astype(np.float64) ** 2)) for p in ref))
    assert diff <= rtol * norm, (diff, norm)


def _grads(tnet):
    return tnet.to_numpy(map_tensors(tnet._params, lambda t: t.grad))


@pytest.fixture(scope="module")
def gum():
    """A carried GUM network and one batch of 64 packed from the port's
    batched tier, as numpy."""
    pp.set_device("cpu")
    pp.seed(4)
    jnet = jax_ff_network(JaxGUM())
    tnet = carry_ff(jnet, TorchGUM())
    outputs, sites = V.run_training_batch(TorchGUM(), 64)
    packed, addrs, dist_names = tnet._pack_arrays_from_outputs(outputs, sites, 64)
    return jnet, addrs, dist_names, map_tensors(packed, lambda t: t.contiguous().numpy())


def _gum_port(gum):
    jnet, addrs, dist_names, packed = gum
    tnet = carry_ff(jnet, TorchGUM())
    batch = pp.nn.PackedBatch(jax.tree_util.tree_map(torch.from_numpy, packed), 64, addrs, dist_names)
    for p in tensor_leaves(tnet._params):
        p.requires_grad_(True)
    return tnet, batch


def _jax_gum_loss_and_grads(gum):
    jnet, addrs, dist_names, packed = gum
    _, loss_fn = jnet._make_loss_for(addrs, dist_names)
    jpacked = jax.tree_util.tree_map(jnp.asarray, packed)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jnet._loss_params_subset(addrs, dist_names), jpacked)
    return float(loss) / 64, jax.tree_util.tree_map(lambda g: g / 64, grads)


def test_loss_and_gradients_match_on_a_gum_batch(gum):
    tnet, batch = _gum_port(gum)
    loss = float(tnet._loss_and_grad(batch))
    jloss, jgrads = _jax_gum_loss_and_grads(gum)
    assert loss == pytest.approx(jloss, rel=1e-5)
    _assert_relative(_grads(tnet), jgrads)
    assert max(np.abs(a).max() for a in _arrays(_grads(tnet)).values()) > 1e-3


def test_one_adam_step_matches_the_jax_package(gum):
    jnet = gum[0]
    jnet._optimizer_type, jnet._weight_decay, jnet._learning_rate_init = JOpt.ADAM, 0.0, LR
    jnet._create_optimizer()
    _, jgrads = _jax_gum_loss_and_grads(gum)  # every leaf: GUM's loss reads them all
    after, _ = jnet._update_fn(jnet._params, jgrads, jnet._opt_state, LR)
    tnet, batch = _gum_port(gum)
    tnet._optimizer_type, tnet._weight_decay, tnet._learning_rate_init = TOpt.ADAM, 0.0, LR
    tnet._create_optimizer()
    before = _arrays(tnet.to_numpy())
    tnet._loss_and_grad(batch)
    tnet._optimizer_step(LR)
    port, ref = _arrays(tnet.to_numpy()), _arrays(unwrap_static(after))
    assert port.keys() == ref.keys()
    for path in ref:
        np.testing.assert_allclose(port[path], ref[path], rtol=0, atol=1e-5, err_msg=str(path))
    assert max(np.abs(port[p] - before[p]).max() for p in ref) > LR / 2  # the step moved them


@pytest.fixture(scope="module")
def marsaglia():
    """A JAX network polymorphed on the JAX interpreter's training traces
    of the while-loop Marsaglia model with one or two attempts (two trace
    types: the JAX package compiles its loss once a type, about a second a
    site), and those traces."""
    pp.set_device("cpu")
    jm = JaxMarsagliaWhile()
    jnet = jax_ff_network(jm, vectorized=False, observe_dim=8)
    pyprob_tpu.seed(2)
    jtraces = [t for t in JOnline(jm).next_batch(64) if t.length_controlled <= 4]
    jnet._polymorph(JBatch(jtraces))
    return jnet, jtraces


def test_loss_and_gradients_match_on_a_mixed_type_marsaglia_batch(marsaglia):
    jnet, jtraces = marsaglia
    jnet._optimizer_type = JOpt.ADAM
    ok, jloss, jgrads = jnet._loss_and_grad(JBatch(jtraces))
    assert ok
    tnet = carry_ff(jnet, TorchMarsagliaWhile())
    for p in tensor_leaves(tnet._params):
        p.requires_grad_(True)
    batch = Batch([port_trace(t) for t in jtraces])
    assert len(batch.sub_batches) == 2  # mixed trace types
    loss = float(tnet._loss_and_grad(batch))
    assert not hasattr(tnet, "_gather_used")  # the per-type loss
    assert loss == pytest.approx(jloss, rel=1e-5)
    # the Uniform heads' gradients are small differences of the truncated
    # mixture's terms, exact in float32 to about 1e-4 of themselves: held
    # as the LSTM's Uniform-head gradients are (tests/test_torch_rejection.py),
    # those of the summed loss within 1e-5 + 1e-4 |ref|
    B = len(jtraces)
    port, ref = _arrays(_grads(tnet)), _arrays(unwrap_static(jgrads))
    assert port.keys() == ref.keys()
    for path in ref:
        np.testing.assert_allclose(B * port[path], B * ref[path], atol=1e-5, rtol=1e-4, err_msg=str(path))
    present = {v.address for t in batch.traces for v in t.variables_controlled}
    for addr in present:
        assert float(tnet._params["proposal"][addr]["ff"]["layers"][0]["w"].grad.abs().max()) > 0


def test_vectorized_proposal_step_matches_forced_and_defensive(gum):
    jnet = gum[0]
    (addr,) = jnet._params["proposal"]
    tnet = carry_ff(jnet, TorchGUM())
    rng = np.random.default_rng(5)
    xs = rng.normal(6.0, 2.5, 32).astype(np.float32)
    jstep = jnet.make_vectorized_proposal_step(OBSERVE)
    obs_j = {k: jnp.float32(v) for k, v in OBSERVE.items()}
    jprior = JNormal(1.0, math.sqrt(5.0))

    def forced(key, x):
        jstep.reset()
        return jstep(JSite(address=addr), jprior, key, obs_j, forced_value=x)[1]

    keys = jax.random.split(jax.random.PRNGKey(0), 32)
    jlq = np.asarray(jax.jit(jax.vmap(forced))(keys, jnp.asarray(xs)))

    step = tnet.make_vectorized_proposal_step(OBSERVE)
    prior, gen = Normal(1.0, math.sqrt(5.0)), pp.util.generator("cpu")
    obs = {k: torch.tensor(v) for k, v in OBSERVE.items()}
    step.reset(32)
    _, lq = step(V.SiteRecord(address=addr), prior, gen, obs, forced_value=torch.from_numpy(xs))
    np.testing.assert_allclose(lq.numpy(), jlq, rtol=1e-5, atol=1e-5)
    # defensive: the draw scored against 0.5 q + 0.5 prior, the JAX
    # package's density of that mixture at the same values
    value, plp = step(V.SiteRecord(address=addr), prior, gen, obs, defensive=0.5)
    jlq_v = np.asarray(jax.jit(jax.vmap(forced))(keys, jnp.asarray(value.numpy())))
    want = np.logaddexp(math.log(0.5) + jlq_v, math.log(0.5) + np.asarray(jprior.log_prob(jnp.asarray(value.numpy()))))
    np.testing.assert_allclose(plp.numpy(), want, rtol=1e-5, atol=1e-5)
    # the state hooks are trivial
    assert step.get_state() is None and step.select_state(None, "new", "old") == "new"


def test_infer_step_matches_the_jax_package(marsaglia):
    jnet, jtraces = marsaglia
    tnet = carry_ff(jnet, TorchMarsagliaWhile())
    jnet._infer_init(OBSERVE)
    tnet._infer_init({k: torch.tensor(v) for k, v in OBSERVE.items()})
    jtrace = max(jtraces, key=lambda t: t.length_controlled)
    for jv, tv in zip(jtrace.variables_controlled, port_trace(jtrace).variables_controlled):
        jd = jnet._infer_step(jv)
        td = tnet._infer_step(tv)
        means, stddevs, _, _ = td._tnorm_params
        assert means.device.type == "cpu" and tuple(means.shape) == (1, 3)
        np.testing.assert_allclose(td.probs.numpy(), np.asarray(jd.probs), rtol=1e-5, atol=1e-6)
        jmeans = np.stack([np.asarray(c.mean_non_truncated) for c in jd.distributions], -1)
        jstd = np.stack([np.asarray(c.stddev_non_truncated) for c in jd.distributions], -1)
        np.testing.assert_allclose(means.numpy(), jmeans, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(stddevs.numpy(), jstd, rtol=1e-5, atol=1e-6)


def test_learn_inference_network_defaults_to_the_feedforward_network():
    model = GaussianUnknownMean()
    model.learn_inference_network(num_traces=64, observe_embeddings={"obs0": {}, "obs1": {}}, batch_size=32)
    net = model._inference_network
    assert type(net) is InferenceNetworkFeedForward and net._total_train_iterations == 2
    assert net._infer_lstm_state is None


@pytest.fixture(scope="module")
def trained():
    pp.set_device("cpu")
    # 16,000 traces, as the JAX package's test of the 0.15 floor trains
    # (tests/test_train.py:39): at 8,000 (16 steps) the ESS fraction of
    # either package is a lottery over training seeds
    pp.seed(3)
    model = GaussianUnknownMean()
    model.learn_inference_network(
        num_traces=16_000,
        observe_embeddings={"obs0": {"dim": 16}, "obs1": {"dim": 16}},
        batch_size=512,
        learning_rate_init=0.005,
    )
    assert type(model._inference_network) is InferenceNetworkFeedForward
    return model


def test_trained_network_serves_batched_guided_is(trained):
    pp.seed(1)
    n = 4000
    post = trained.posterior_results(n, observe=OBSERVE, vectorized=True, inference_engine=IC)
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.6
    assert post.effective_sample_size > 0.15 * n


def test_trained_network_serves_lockstep(trained):
    pp.seed(2)
    n = 4000
    post = trained.posterior_results(n, observe=OBSERVE, vectorized=False, inference_engine=IC)
    assert post.metadata[0]["lockstep_workers"] == 64
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.75
    assert post.effective_sample_size > 0.05 * n  # the JAX package's floor
    # one seed, one posterior, however the 16 workers are scheduled
    runs = []
    for _ in range(2):
        pp.seed(42)
        again = trained.posterior_results(192, observe=OBSERVE, vectorized=False, inference_engine=IC, lockstep=16)
        runs.append(np.sort(np.asarray(again.get_values(), np.float64)))
    np.testing.assert_array_equal(runs[0], runs[1])


def test_rejection_retries_on_the_batched_tier_propose_from_the_network():
    model = TorchMarsaglia()
    net = InferenceNetworkFeedForward(
        model=model, observe_embeddings={"obs0": {"dim": 4}, "obs1": {"dim": 4}},
        proposal_mixture_components=3,
    )
    net._pre_generate_layers(model.prior(num_traces=2))
    model._inference_network = net
    step = net.make_vectorized_proposal_step(OBSERVE)
    seen = []

    def spy(*args, **kwargs):
        seen.append(kwargs.get("defensive"))
        return step(*args, **kwargs)

    spy.__dict__.update(step.__dict__)  # reset and the state hooks
    net._vps_cache = (net._total_train_iterations, spy)
    post = model.posterior_results(2000, observe=OBSERVE, vectorized=True, inference_engine=IC)
    assert seen.count(None) == 2  # the first attempt's two sites, from q
    assert seen.count(0.5) >= 2  # every retry round's, from the defensive mixture
    assert np.isfinite(float(post.mean)) and post.effective_sample_size > 1


def test_lockstep_round_answers_each_row_as_the_sequential_step():
    pyprob_tpu.seed(3)
    jtraces = JaxMarsagliaWhile().prior(num_traces=200, vectorized=False).get_values()
    ttraces = [port_trace(t) for t in jtraces]
    chosen = chip_smoke.round_traces(ttraces, workers=32)
    assert len({t.length_controlled for t in chosen}) >= 3  # 1, 2, 3+ attempts
    jchosen = [jtraces[ttraces.index(t)] for t in chosen]
    jnet = jax_ff_network(JaxMarsagliaWhile(), vectorized=False)
    jnet._polymorph(JBatch([jprune(t) for t in jchosen]))
    tnet = carry_ff(jnet, TorchMarsagliaWhile())
    errs = chip_smoke.lockstep_round_vs_sequential(tnet, OBSERVE, chosen, workers=32, seed=5)
    rows = errs["rows"]
    assert sum(t.length_controlled for t in chosen) == len(rows) <= 32
    # one bucket: every Uniform head in one group, no previous site
    assert [start for start, _ in errs["buckets"]] == [True]
    assert len(errs["buckets"][0][1]) == len(rows)
    for key in ("log_q", "head", "log_p"):
        assert errs[key] <= 1e-5, (key, errs[key])
        assert errs[key + "_ref"] > 0.1, key  # the references are not all zero
    assert errs["carry"] == errs["untouched"] == 0.0
    # rows of different addresses met different heads
    assert len({v.address for v, _, _ in rows}) >= 3
