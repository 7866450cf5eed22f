"""The port's gather-table loss (``nn/gather_loss.py``) against its per-type
loss and against the JAX package's gather loss, on the CPU.

A JAX LSTM network (lstm_dim 16, 3 mixture components, 16-d observe
embeddings, untrained) is carried into the port, and 64 training traces of
the while-loop Marsaglia model drawn by the JAX package (several trace
types: 1, 2, 3 ... attempts) are rebuilt in the port's records, so both
packages see the same traces and the same parameters.  The gather loss
equals the per-type loss in value (rtol 1e-4) and in every gradient (rtol
2e-3, atol 2e-5: the tolerances of ``tests/test_gather_loss.py``), and the
JAX package's gather loss (rel 1e-4); its optimizer step lands on the JAX
package's separate step; its observation rows follow the sub-batch
columns, and one trace's perturbed observation moves it as it moves the
per-type loss.  Then the training loop itself on materialized batches of
16: each batch that grows new heads after the first step recreates the
optimizer (fresh state, every leaf), the heads first met mid-run train,
the registry is rebuilt and the EMA grafts the new leaves.
"""

import numpy as np
import pytest
import torch

import pyprob_tpu
import pyprob_tpu_torch as pp
from pyprob_tpu.nn.dataset import Batch as JBatch, OnlineDataset as JOnline
from pyprob_tpu.util import Optimizer as JOpt
from pyprob_tpu_torch.models import GaussianUnknownMeanMarsaglia
from pyprob_tpu_torch.nn import Batch, OnlineDataset
from pyprob_tpu_torch.nn import gather_loss as gl
from pyprob_tpu_torch.nn.layers import tensor_leaves
from pyprob_tpu_torch.util import Optimizer as TOpt

from _torch_parity import (
    JaxMarsagliaWhile,
    TorchMarsagliaWhile,
    carry,
    jax_network,
    port_trace,
    unwrap_static,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pp.set_device("cpu")
    pp.seed(0)
    pp.set_verbosity(1)
    yield


@pytest.fixture(scope="module")
def setup():
    pp.set_device("cpu")
    jm = JaxMarsagliaWhile()
    jnet = jax_network(jm, vectorized=False, observe_dim=16)
    pyprob_tpu.seed(2)
    jtraces = JOnline(jm).next_batch(64)
    jbatch = JBatch(jtraces)
    jnet._polymorph(jbatch)
    return jnet, jbatch, jtraces


@pytest.fixture(scope="module")
def jax_step(setup):
    """The JAX package's gather loss and its separate optimizer step (Adam,
    lr 1e-3) on the batch: (loss, parameters before, parameters after)."""
    jnet, jbatch, _ = setup
    _configure(jnet, JOpt.ADAM)
    jnet._create_optimizer()
    jnet._gather_fused_update = False  # grads back, then the separate step
    ok, loss, grads = jnet._try_gather_loss_and_grad(jbatch)
    assert ok and grads is not None
    params, _ = jnet._update_fn(jnet._params, grads, jnet._opt_state, LR)
    return loss, unwrap_static(jnet._params), unwrap_static(params)


LR = 1e-3


def _configure(net, opt):
    net._optimizer_type = opt
    net._weight_decay = 0.0
    net._learning_rate_init = LR


def _port(setup):
    """A fresh port network with the JAX network's weights, and the batch."""
    jnet, _, jtraces = setup
    tnet = carry(jnet, TorchMarsagliaWhile())
    for p in tensor_leaves(tnet._params):
        p.requires_grad_(True)
    return tnet, Batch([port_trace(t) for t in jtraces])


def _loss_and_grads(net, batch, gather):
    """Loss/B and every leaf's gradient: the training step's loss (the
    gather loss, for a batch of mixed trace types) or the per-type loss."""
    leaves = tensor_leaves(net._params)
    if gather:
        loss = float(net._loss_and_grad(batch))
        assert net._gather_used
        return loss, [p.grad.clone() for p in leaves]
    for p in leaves:
        p.grad = None
    loss = net._per_type_loss(batch)
    loss.backward()
    return float(loss.detach()), [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in leaves]


def test_gather_matches_the_per_type_loss_and_every_gradient(setup):
    tnet, batch = _port(setup)
    assert len(batch.sub_batches) > 2  # genuinely mixed trace types
    loss_ref, grads_ref = _loss_and_grads(tnet, batch, gather=False)
    assert not tnet._gather_used
    loss_g, grads_g = _loss_and_grads(tnet, batch, gather=True)
    assert tnet._gather_used
    assert loss_g == pytest.approx(loss_ref, rel=1e-4)
    assert len(grads_g) == len(grads_ref) > 20
    for a, b in zip(grads_ref, grads_g):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-3, atol=2e-5)
    # every head the batch meets has a gradient
    present = {v.address for t in batch.traces for v in t.variables_controlled}
    for addr in present:
        w = tnet._params["proposal"][addr]["ff"]["layers"][0]["w"]
        assert float(w.grad.abs().max()) > 0


def test_gather_loss_equals_the_jax_packages(setup, jax_step):
    tnet, batch = _port(setup)
    loss, _ = _loss_and_grads(tnet, batch, gather=True)
    assert loss == pytest.approx(jax_step[0], rel=1e-4)


def test_gather_step_lands_on_the_jax_packages_separate_step(setup, jax_step):
    _, before, after = jax_step
    tnet, batch = _port(setup)
    _configure(tnet, TOpt.ADAM)
    tnet._create_optimizer()
    tnet._loss_and_grad(batch)
    tnet._optimizer_step(LR)
    port, ref, before = _arrays(tnet.to_numpy()), _arrays(after), _arrays(before)
    assert port.keys() == ref.keys()
    # Adam's first step moves an element by lr·g/(|g| + 1e-8): where |g| is
    # near 1e-8 the gradients' float32 round-off shows at the scale of lr,
    # so a few elements get lr/10, every other one 2e-5
    close = 0
    for path in ref:
        np.testing.assert_allclose(port[path], ref[path], rtol=0, atol=LR / 10, err_msg=str(path))
        close += int(np.sum(np.abs(port[path] - ref[path]) <= 2e-5))
    total = sum(a.size for a in ref.values())
    assert close >= total - max(3, total // 2000)
    # the step moved the parameters (Adam's first step: about lr a leaf)
    assert max(np.abs(port[p] - before[p]).max() for p in ref) > LR / 2


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


def test_gather_obs_rows_follow_sub_batch_columns(setup):
    tnet, batch = _port(setup)
    ordered = [tr for sub in batch.sub_batches for tr in sub]
    assert ordered != list(batch.traces)  # the permutation bites
    _, packed, _, _, _ = tnet._prepare_gather(batch)
    for name, rows in packed["obs"].items():
        for b, tr in enumerate(ordered):
            np.testing.assert_array_equal(
                rows[b].numpy(), np.asarray(tr.named_value(name), np.float32).reshape(-1),
                err_msg=f"obs {name!r} row {b}",
            )
    # the values' columns follow the same order
    for b, tr in enumerate(ordered):
        assert float(packed["values"][0, b, 0]) == float(tr.variables_controlled[0].value)


def test_gather_loss_tracks_one_observation_perturbation(setup):
    tnet, batch = _port(setup)
    # an untrained network barely sees one observation: a few steps first,
    # as the JAX package's test trains first
    _configure(tnet, TOpt.ADAM)
    tnet._create_optimizer()
    for _ in range(10):
        tnet._loss_and_grad(batch)
        tnet._optimizer_step(1e-2)
    victim = batch.sub_batches[-1][0]  # packed away from its generation position
    assert batch.traces.index(victim) != len(batch.traces) - len(batch.sub_batches[-1])

    def both():
        return (
            _loss_and_grads(tnet, batch, gather=True)[0],
            _loss_and_grads(tnet, batch, gather=False)[0],
        )

    g0, r0 = both()
    named = [v for v in victim.variables if v.name == "obs0"]
    old = [v.value for v in named]
    for v in named:
        v.value = np.asarray(v.value) + 10.0
    g1, r1 = both()
    for v, o in zip(named, old):
        v.value = o
    assert abs(r1 - r0) > 1e-6  # the perturbation is visible
    assert (g1 - g0) == pytest.approx(r1 - r0, rel=1e-3, abs=1e-6)


def test_training_polymorphs_recreates_the_optimizer_and_grafts_the_ema(monkeypatch):
    # the online loop itself: batches of 16 keep meeting new attempts (new
    # heads) after the first step, and each such batch recreates the
    # optimizer (fresh state) over every leaf before its step
    cls = pp.nn.InferenceNetworkLSTM
    polymorph, create = cls._polymorph, cls._create_optimizer
    grown, created = [], []  # (step, new head addresses, their leaves at birth); (step, optimizer, fresh)

    def recorded_polymorph(self, batch):
        before = set(self._params["proposal"])
        changed = polymorph(self, batch)
        new = sorted(set(self._params["proposal"]) - before)
        if changed and new:
            born = {a: [p.detach().clone() for p in tensor_leaves(self._params["proposal"][a])] for a in new}
            grown.append((self._total_train_iterations, born))
        return changed

    def recorded_create(self, state_dict=None):
        create(self, state_dict)
        fresh = all(len(s) == 0 for s in self._optimizer.state.values())
        created.append((self._total_train_iterations, self._optimizer, fresh))

    monkeypatch.setattr(cls, "_polymorph", recorded_polymorph)
    monkeypatch.setattr(cls, "_create_optimizer", recorded_create)
    pp.seed(4)
    model = GaussianUnknownMeanMarsaglia()
    model.learn_inference_network(
        num_traces=480, observe_embeddings={"obs0": {"dim": 4}, "obs1": {"dim": 4}},
        inference_network=pp.InferenceNetwork.LSTM, batch_size=16, lstm_dim=8,
        proposal_mixture_components=2, ema_decay=0.9,
    )
    net = model._inference_network
    # the first batch does not count toward num_traces for an
    # interpreter-tier model, as in the JAX package's generic loop
    assert net._gather_used and net._total_train_iterations == 31
    mid_run = [(step, born) for step, born in grown if step >= 1]
    assert mid_run, "no batch after the first grew the network"
    steps_created = {step for step, _, _ in created}
    assert all(step in steps_created for step, _ in mid_run)
    assert all(fresh for _, _, fresh in created)
    assert len({id(opt) for _, opt, _ in created}) == len(created) >= 2
    assert net._optimizer is created[-1][1]
    # the last optimizer updates every leaf, and each head first met mid-run
    # has moved from its initial value
    covered = {id(p) for group in net._optimizer.param_groups for p in group["params"]}
    assert covered == {id(p) for p in tensor_leaves(net._params)}
    for _, born in mid_run:
        for addr, leaves in born.items():
            now = tensor_leaves(net._params["proposal"][addr])
            assert max(float((a.detach() - b).abs().max()) for a, b in zip(now, leaves)) > 0, addr
    # the EMA adopted the new leaves; the registry was rebuilt and groups
    # every Uniform head together
    assert len(tensor_leaves(net._ema_params)) == len(tensor_leaves(net._params))
    reg = net._gather_registry()
    assert len(reg.head_groups) == 1 and len(reg.a_addrs) == len(net._params["proposal"])
    batch = Batch(OnlineDataset(model).next_batch(64))
    net._polymorph(batch)
    packed, *_ = gl.pack_batch(net, net._gather_registry(), batch)
    assert packed["active_idx"].numel() == sum(t.length_controlled for t in batch.traces)
