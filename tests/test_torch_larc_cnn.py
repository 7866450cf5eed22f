"""LARC and the CNN observe embeddings against the JAX package, on the CPU.

``larc_scale`` on numpy leaves (random, all-zero parameters, all-zero
gradients) in clip and scale modes, with and without weight decay, within
1e-6 (1 + |ref|); two ADAM_LARC / SGD_LARC steps of a carried GUM
feedforward network from the same numpy gradients within 1e-5 (1 + |p|), the weight decay
applied once (inside ``larc_scale``, the base optimizer without it).
pyprob's ``LARC`` wrapper: trust coefficient 0.002 by default (pyprob's;
the JAX package's wrapper has 0.02, ``tests/test_migration_surface.py``
does not read it) and a ValueError for an optimizer without parameters
(the JAX package's crashes at ``params=None``).

CNN2D5C at (1, 20, 20) -> 8 and CNN3D5C at (1, 20, 20, 20) -> 8, the
smallest inputs the five convolutions and two pools leave a pixel of (the
JAX package returns zero features below, the port raises): forward and
input and weight gradients from the JAX package's weights within 1e-5
(1 + |ref|).  A feedforward and an LSTM network with a CNN2D5C embedding of
MiniCaptcha's 28 x 28 glyphs carried from the JAX package: the per-type
loss on the same traces within 1e-5 relative, a save/load round trip, and
guided IS on the batched tier, in lockstep and sequentially.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pyprob_tpu
import pyprob_tpu_torch
from pyprob_tpu.nn import layers as JL
from pyprob_tpu.nn.optimizer_larc import larc_scale as jax_larc_scale
from pyprob_tpu.util import LearningRateScheduler as JSched, Optimizer as JOpt
from pyprob_tpu_torch.nn import LARC, larc_scale
from pyprob_tpu_torch.nn import layers as TL
from pyprob_tpu_torch.nn.layers import tensor_leaves
from pyprob_tpu_torch.util import LearningRateScheduler as TSched, Optimizer as TOpt

from _torch_parity import (
    JaxGUM, TorchGUM, carry, carry_ff, jax_ff_network, jax_network, port_trace, unwrap_static,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyprob_tpu_torch.set_device("cpu")
    pyprob_tpu_torch.seed(0)
    yield


def _leaves(seed):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=(4, 3)).astype(np.float32), np.zeros(5, np.float32),
              rng.normal(size=(7,)).astype(np.float32), rng.normal(size=(2, 2)).astype(np.float32)]
    grads = [0.1 * rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=5).astype(np.float32),
             np.zeros(7, np.float32), 50 * rng.normal(size=(2, 2)).astype(np.float32)]
    return params, grads


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_larc_scale_matches(clip, weight_decay):
    params, grads = _leaves(1)
    ref = jax_larc_scale([jnp.asarray(g) for g in grads], [jnp.asarray(p) for p in params], 0.01,
                         clip=clip, weight_decay=weight_decay)
    got = larc_scale([torch.from_numpy(g) for g in grads], [torch.from_numpy(p) for p in params], 0.01,
                     clip=clip, weight_decay=weight_decay)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6 * (1 + np.abs(b).max()))
    # zero-norm leaves keep the scale 1: the gradient plus the decay term
    np.testing.assert_array_equal(got[1].numpy(), grads[1])
    np.testing.assert_allclose(got[2].numpy(), weight_decay * params[2], atol=1e-12)
    assert larc_scale([None], [torch.ones(2)], 0.01) == [None]


def _configure(net, opt, sched):
    net._optimizer_type = opt
    net._weight_decay = 1e-3
    net._momentum = 0.9
    net._learning_rate_init = 0.01
    net._learning_rate_end = 1e-4
    net._learning_rate_scheduler_type = sched
    net._total_train_traces_end = 1000


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


@pytest.mark.parametrize("opt", ["ADAM_LARC", "SGD_LARC"])
def test_larc_training_steps_match(opt):
    jnet = jax_ff_network(JaxGUM())
    tnet = carry_ff(jnet, TorchGUM())
    _configure(jnet, JOpt[opt], JSched.POLY2)
    _configure(tnet, TOpt[opt], TSched.POLY2)
    jnet._create_optimizer()
    tnet._create_optimizer()
    assert isinstance(tnet._optimizer, LARC)
    assert all(g["weight_decay"] == 0.0 for g in tnet._optimizer.param_groups)  # counted once
    for step in range(2):
        rng = np.random.default_rng(step)
        grads = jax.tree_util.tree_map(lambda x: (0.1 * rng.normal(size=np.shape(x))).astype(np.float32),
                                       jnet._params)
        lr = jnet._current_learning_rate()
        jnet._params, jnet._opt_state = jnet._update_fn(jnet._params, grads, jnet._opt_state, lr)
        for p, g in zip(tensor_leaves(tnet._params), tensor_leaves(tnet._params_from_numpy(unwrap_static(grads)))):
            p.grad = g
        tnet._optimizer_step(lr)
        for net in (jnet, tnet):
            net._total_train_traces += 300
    port, ref = _arrays(tnet.to_numpy()), _arrays(unwrap_static(jnet._params))
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=0, atol=1e-5 * (1 + np.abs(ref[k]).max()), err_msg=str(k))


def test_larc_wrapper_follows_pyprob():
    w = torch.nn.Parameter(torch.ones(4, 4))
    opt = LARC(torch.optim.SGD([w], lr=0.1))
    assert opt.trust_coefficient == 0.002  # pyprob's default (the JAX wrapper: 0.02)
    w.grad = torch.full((4, 4), 0.5)
    before = w.detach().clone()
    opt.step()
    # clip mode: scale min(0.002 * 4 / 2 / 0.1, 1) = 0.04
    np.testing.assert_allclose((before - w.detach()).numpy(), np.full((4, 4), 0.1 * 0.5 * 0.04), rtol=0, atol=1e-7)
    sd = opt.state_dict()
    opt.load_state_dict(sd)
    opt.zero_grad()
    assert w.grad is None


def test_larc_wrapper_refuses_an_optimizer_without_parameters():
    class Empty:
        param_groups = []

    with pytest.raises(ValueError, match="parameters"):
        LARC(Empty())


@pytest.mark.parametrize("ndim,shape", [(2, (1, 20, 20)), (3, (1, 20, 20, 20))])
def test_cnn_forward_and_gradients_match(ndim, shape):
    init, apply = {2: (JL.cnn2d5c_init, JL.cnn2d5c_apply), 3: (JL.cnn3d5c_init, JL.cnn3d5c_apply)}[ndim]
    jp = init(jax.random.PRNGKey(3), shape, 8)
    tp = TL.cnn_from_numpy(unwrap_static(jp), "cpu")
    x = np.random.default_rng(4).normal(size=(2, int(np.prod(shape)))).astype(np.float32)
    ct = np.random.default_rng(5).normal(size=(2, 8)).astype(np.float32)

    def forward_and_vjp(p, x, ct):  # one compiled program: op by op takes several times longer
        y, vjp = jax.vjp(apply, p, x)
        return y, vjp(ct)

    jy, (jgp, jgx) = jax.jit(forward_and_vjp)(jp, jnp.asarray(x), jnp.asarray(ct))
    for leaf in tensor_leaves(tp):
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = (TL.cnn2d5c_apply if ndim == 2 else TL.cnn3d5c_apply)(tp, tx)
    ty.backward(torch.from_numpy(ct))

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * (1 + np.abs(b).max()))

    close(ty.detach().numpy(), jy)
    close(tx.grad.numpy(), jgx)
    grads = TL.cnn_to_numpy(TL.map_tensors(tp, lambda t: t.grad))
    ref = unwrap_static(jgp)
    for i in range(5):
        close(grads["convs"][i]["w"], ref["convs"][i]["w"])
        close(grads["convs"][i]["b"], ref["convs"][i]["b"])
    for k in ("lin1", "lin2"):
        close(grads[k]["w"], ref[k]["w"])
        close(grads[k]["b"], ref[k]["b"])
    assert TL.cnn_to_numpy(tp)["meta"]["input_shape"] == tuple(shape)


def test_cnn_too_small_input_raises():
    with pytest.raises(ValueError, match=">= 20"):
        TL.cnn2d5c_init(torch.Generator().manual_seed(0), (1, 16, 16), 8, "cpu")


CNN_EMBEDDING = {"query_image": {"dim": 8, "reshape": [1, 28, 28], "embedding": None}}


def _captcha_networks(network):
    from pyprob_tpu.models import MiniCaptcha as JM

    spec = {"query_image": dict(CNN_EMBEDDING["query_image"], embedding=pyprob_tpu.ObserveEmbedding.CNN2D5C)}
    jm, tm = JM(alphabet=("A", "B", "C")), pyprob_tpu_torch.models.MiniCaptcha(alphabet=("A", "B", "C"))
    if network == "ff":
        jnet = jax_ff_network(jm, observe_embeddings=spec, vectorized=True)
        tnet = carry_ff(jnet, tm)
    else:
        jnet = jax_network(jm, observe_embeddings=spec, vectorized=True, lstm_dim=8)
        tnet = carry(jnet, tm)
    return jm, tm, jnet, tnet


@pytest.mark.parametrize("network", ["ff", "lstm"])
def test_cnn_network_loss_and_save_load(network, tmp_path):
    from pyprob_tpu.nn.dataset import Batch as JBatch
    from pyprob_tpu_torch.nn import Batch as TBatch, InferenceNetwork

    jm, tm, jnet, tnet = _captcha_networks(network)
    assert tnet._params["observe"]["query_image"]["kind"] == "cnn2d5c"
    pyprob_tpu.seed(9)
    jtraces = jm.prior(num_traces=6, vectorized=True).get_values()
    rng = np.random.default_rng(0)
    for t in jtraces:  # prior traces keep no observed value: give each its glyph plus noise
        v = t.named_variables["query_image"]
        v.value = np.asarray(jm.render(jm.alphabet[int(t.variables_controlled[0].value)]) +
                             0.1 * rng.normal(size=784).astype(np.float32))
    _, jloss = jnet._loss(JBatch(jtraces))
    tloss = tnet._loss(TBatch([port_trace(t) for t in jtraces]))
    assert math.isfinite(tloss)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    path = str(tmp_path / "cnn.network")
    tnet._save(path)
    back = InferenceNetwork._load(path, device="cpu")
    for a, b in zip(tensor_leaves(tnet._params), tensor_leaves(back._params)):
        assert torch.equal(a, b)
    assert back._observe_meta["query_image"]["embedding"] == pyprob_tpu_torch.ObserveEmbedding.CNN2D5C
    assert back._loss(TBatch([port_trace(t) for t in jtraces])) == tloss
    # the CNN embedding serves on both tiers, lockstep and the sequential loop
    ic = pyprob_tpu_torch.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    for kw in (dict(vectorized=True), dict(vectorized=False), dict(vectorized=False, lockstep=False)):
        post = tm.posterior_results(16, observe={"query_image": tm.render("B")}, inference_engine=ic, **kw)
        assert len(post) == 16 and np.isfinite(post.log_weights).all(), kw
