"""The port's training slice against the JAX package.

(i) Deterministic: with a JAX LSTM network carried into the port
(lstm_dim 16, 3 mixture components, 4-d observe embeddings), the training
loss and every gradient leaf agree on one packed batch made from numpy
arrays; the optimizer, its learning-rate schedule and the EMA average
agree step for step when both sides are handed the same numpy gradients;
``to_numpy`` inverts ``from_numpy``.  (ii) The training batch drawn on the
batched tier has the prior's statistics and packs the site's prior
parameters.  (iii) Statistical: a network trained by
``learn_inference_network`` serves guided IS near the analytic posterior.
The training batches come from the port's own ``torch.Generator``, so the
trained networks match the JAX package's only in distribution.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pyprob_tpu  # noqa: F401
import pyprob_tpu_torch
from pyprob_tpu.util import LearningRateScheduler as JSched, Optimizer as JOpt
from pyprob_tpu_torch import vectorized as torch_vectorized
from pyprob_tpu_torch.models import GaussianUnknownMean
from pyprob_tpu_torch.nn.layers import map_tensors, tensor_leaves
from pyprob_tpu_torch.util import (
    InferenceEngine as TEngine,
    InferenceNetwork as TNet,
    LearningRateScheduler as TSched,
    Optimizer as TOpt,
)

from _torch_parity import OBSERVE, POSTERIOR_MEAN, JaxGUM, TorchGUM, carry, jax_network, unwrap_static

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyprob_tpu_torch.set_device("cpu")
    pyprob_tpu_torch.seed(0)
    yield


def _nets():
    pyprob_tpu_torch.set_device("cpu")
    jnet = jax_network(JaxGUM())
    return jnet, carry(jnet, TorchGUM())


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


def _assert_trees_close(port, ref, atol):
    port, ref = _arrays(port), _arrays(unwrap_static(ref))
    assert port.keys() == ref.keys()
    for path in ref:
        np.testing.assert_allclose(port[path], ref[path], atol=atol, rtol=0, err_msg=str(path))


def test_to_numpy_inverts_from_numpy():
    jnet, tnet = _nets()
    ref = unwrap_static(jnet.snapshot_params()["params"])
    out = tnet.to_numpy()
    port, want = _arrays(out), _arrays(ref)
    assert port.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(port[path], want[path], err_msg=str(path))
    (addr,) = ref["proposal"]
    assert out["proposal"][addr]["meta"]["mixture_components"] == 3
    assert out["lstm"]["meta"] == ref["lstm"]["meta"]


def _packed(B, seed):
    """One GUM training batch as numpy arrays: obs [B, 1], values [B], the
    prior's parameters per row [B, 1]."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(1.0, math.sqrt(5.0), B).astype(np.float32)
    obs = {k: (mu + rng.normal(0, math.sqrt(2.0), B)).astype(np.float32)[:, None] for k in OBSERVE}
    prior = {
        "mean": np.full((B, 1), 1.0, np.float32),
        "stddev": np.full((B, 1), math.sqrt(5.0), np.float32),
    }
    return {"obs": obs, "steps": [{"values": mu, "prior": prior}]}


def test_loss_and_gradients_match():
    jnet, tnet = _nets()
    addrs = tuple(jnet._params["proposal"])
    dist_names = ("Normal",)
    packed = _packed(64, seed=3)

    _, jloss_fn = jnet._make_loss_for(addrs, dist_names)
    jpacked = jax.tree_util.tree_map(jnp.asarray, packed)
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(
        jnet._loss_params_subset(addrs, dist_names), jpacked
    )

    for p in tensor_leaves(tnet._params):
        p.requires_grad_(True)
    _, tloss_fn = tnet._make_loss_for(addrs, dist_names)
    tpacked = jax.tree_util.tree_map(torch.from_numpy, packed)
    subset = tnet._loss_params_subset(addrs, dist_names)
    tloss = tloss_fn(subset, tpacked)
    tloss.backward()

    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    # a leaf the loss does not read (the sample embedding of a one-site
    # trace) has no gradient here and a zero one in JAX
    grads = tnet.to_numpy(
        map_tensors(subset, lambda t: torch.zeros_like(t) if t.grad is None else t.grad)
    )
    _assert_trees_close(grads, jgrads, atol=1e-5)
    assert any(np.abs(a).max() > 1e-3 for a in _arrays(grads).values())


def _seeded_grads(jnet, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (0.1 * rng.normal(size=np.shape(x))).astype(np.float32), jnet._params
    )


def _configure(net, opt, sched):
    net._optimizer_type = opt
    net._weight_decay = 1e-5
    net._momentum = 0.9
    net._learning_rate_init = 0.01
    net._learning_rate_end = 1e-4
    net._learning_rate_scheduler_type = sched
    net._total_train_traces_end = 1000
    net._ema_decay = 0.9


@pytest.mark.parametrize("opt,steps", [("ADAM", 3), ("SGD", 2)])
def test_optimizer_schedule_and_ema_match(opt, steps):
    jnet, tnet = _nets()
    _configure(jnet, JOpt[opt], JSched.POLY1)
    _configure(tnet, TOpt[opt], TSched.POLY1)
    jnet._create_optimizer()
    tnet._create_optimizer()
    for step in range(steps):
        grads = _seeded_grads(jnet, seed=step)
        lr = jnet._current_learning_rate()
        assert tnet._current_learning_rate() == lr
        jnet._params, jnet._opt_state = jnet._update_fn(jnet._params, grads, jnet._opt_state, lr)
        jnet._ema_update_host()
        tgrads = tnet._params_from_numpy(unwrap_static(grads))
        for p, g in zip(tensor_leaves(tnet._params), tensor_leaves(tgrads)):
            p.grad = g
        tnet._optimizer_step(lr)
        tnet._ema_update_host()
        for net in (jnet, tnet):
            net._total_train_traces += 300
    assert tnet._ema_steps == jnet._ema_steps == steps
    _assert_trees_close(tnet.to_numpy(), jnet._params, atol=1e-6)
    _assert_trees_close(tnet.to_numpy(tnet._serving_params()), jnet._serving_params(), atol=1e-6)


def test_ema_grafts_new_leaves_and_snapshots_restore():
    jnet, tnet = _nets()
    for net in (jnet, tnet):
        net._ema_decay = 0.9
        net._ema_update_host()
        net._ema_update_host()
    # a leaf grown after two EMA steps (a polymorphed address) adopts
    # p * (1 - d^2), so its debiased serving value starts at p
    new = np.random.default_rng(9).normal(size=jnet._address_embedding_dim).astype(np.float32)
    jnet._params["address_embedding"]["new"] = jnp.asarray(new)
    tnet._params["address_embedding"]["new"] = torch.from_numpy(new.copy())
    for net in (jnet, tnet):
        net._ema_sync_structure()
    np.testing.assert_allclose(
        tnet._ema_params["address_embedding"]["new"].numpy(),
        np.asarray(jnet._ema_params["address_embedding"]["new"]), atol=1e-7,
    )
    np.testing.assert_allclose(
        tnet._serving_params()["address_embedding"]["new"].numpy(), new, atol=1e-6
    )
    _assert_trees_close(tnet.to_numpy(tnet._serving_params()), jnet._serving_params(), atol=1e-6)
    # snapshot / restore: host copies, unaffected by later in-place updates
    snap = tnet.snapshot_params()
    before = tnet.to_numpy()
    with torch.no_grad():
        for p in tensor_leaves(tnet._params):
            p.add_(1.0)
    tnet._ema_update_host()
    tnet.restore_params(snap)
    assert tnet._ema_steps == 2
    _assert_trees_close(tnet.to_numpy(), before, atol=0)
    _assert_trees_close(tnet.to_numpy(tnet._serving_params()), jnet._serving_params(), atol=1e-6)


def test_learning_rate_schedules_are_equal():
    jnet, tnet = _nets()
    for jsched, tsched in zip(JSched, TSched):
        _configure(jnet, JOpt.ADAM, jsched)
        _configure(tnet, TOpt.ADAM, tsched)
        for traces in (0, 1, 333, 999, 1000, 5000):
            jnet._total_train_traces = tnet._total_train_traces = traces
            assert tnet._current_learning_rate() == jnet._current_learning_rate(), (tsched, traces)


def test_training_batch_has_the_prior_statistics():
    _, tnet = _nets()
    model = tnet._model
    outputs, sites = torch_vectorized.run_training_batch(model, 20_000)
    packed, addrs, dist_names = tnet._pack_arrays_from_outputs(outputs, sites, 20_000)
    obs0 = packed["obs"]["obs0"]
    assert obs0.shape == (20_000, 1) and obs0.grad_fn is None
    assert abs(float(obs0.mean()) - 1.0) < 0.1
    assert abs(float(obs0.var()) - 7.0) < 0.05 * 7.0
    (site,) = [s for s in sites if s.control]
    assert addrs == (site.address,) and dist_names == ("Normal",)
    step = packed["steps"][0]
    assert torch.equal(step["values"], outputs["values"][site.address])
    assert (step["prior"]["mean"] == site.distribution.mean).all()
    assert (step["prior"]["stddev"] == site.distribution.stddev).all()
    assert step["prior"]["mean"].shape == (20_000, 1)


def test_learn_inference_network_serves_the_posterior(tmp_path):
    model = GaussianUnknownMean()
    log = tmp_path / "train.csv"
    model.learn_inference_network(
        log_file_name=str(log),
        num_traces=16_000,
        observe_embeddings={"obs0": {"dim": 16}, "obs1": {"dim": 16}},
        inference_network=TNet.LSTM,
        batch_size=512,
        learning_rate_init=0.005,
        lstm_dim=64,
        ema_decay=0.9,
    )
    net = model._inference_network
    assert net._total_train_iterations == 32 and net._total_train_traces == 16_384
    assert net._ema_steps == 32 and len(net._history_train_loss) == 31
    assert len(log.read_text().splitlines()) == 1 + 31  # header, one row per loop step
    assert all(p.requires_grad for p in tensor_leaves(net._params))
    assert not any(p.requires_grad for p in tensor_leaves(net._serving_params()))
    # moving a trained network keeps its leaves trainable and its Adam state
    net.to("cpu")
    assert all(p.is_leaf and p.requires_grad for p in tensor_leaves(net._params))
    assert len(net._optimizer.state) == len(tensor_leaves(net._params))
    post = model.posterior_results(
        num_traces=5_000,
        observe=OBSERVE,
        inference_engine=TEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
    )
    assert abs(float(post.mean) - POSTERIOR_MEAN) < 0.6
    assert post.effective_sample_size > 0.15 * 5_000


def test_unported_training_branches_raise(tmp_path):
    """What is not ported raises naming its slice; the branches ported
    since (offline datasets, keep_best, LARC) raise only for a missing
    directory or metric, as the JAX package does, and ADAM_LARC trains."""
    model = GaussianUnknownMean()
    kw = dict(num_traces=64, observe_embeddings={"obs0": {}, "obs1": {}}, batch_size=32)
    for extra, error, match in (
        ({"dataset_dir": str(tmp_path / "missing")}, FileNotFoundError, "No dataset directory"),
        ({"tie_address_instances": True}, NotImplementedError, "Markov/SMC slice"),
        ({"keep_best": True}, ValueError, "keep_best needs keep_best_metric"),
        ({"distributed_backend": "nccl"}, NotImplementedError, "distributed slice"),
    ):
        with pytest.raises(error, match=match):
            model.learn_inference_network(inference_network=TNet.LSTM, **kw, **extra)
    model.reset_inference_network()
    model.learn_inference_network(inference_network=TNet.LSTM, optimizer_type=TOpt.ADAM_LARC, lstm_dim=8, **kw)
    assert model._inference_network._total_train_traces == 64
