"""The port's network layers against the JAX package's, with the JAX
network's weights carried over by ``InferenceNetworkLSTM.from_numpy``
(lstm_dim 16, 3 mixture components, 4-d observe embeddings)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pyprob_tpu  # noqa: F401
import pyprob_tpu_torch
from pyprob_tpu.distributions import Normal as JNormal
from pyprob_tpu.nn import layers as JL
from pyprob_tpu.nn import proposals as JP
from pyprob_tpu_torch.distributions import Normal as TNormal
from pyprob_tpu_torch.nn import layers as TL
from pyprob_tpu_torch.nn import proposals as TP

from _torch_parity import JaxGUM, TorchGUM, carry, jax_network

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    pyprob_tpu_torch.set_device("cpu")
    pyprob_tpu_torch.seed(0)
    yield


@pytest.fixture(scope="module")
def nets():
    pyprob_tpu_torch.set_device("cpu")
    jnet = jax_network(JaxGUM())
    return jnet, carry(jnet, TorchGUM())


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=0)


def _rows(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_mlp_apply_matches(nets):
    jnet, tnet = nets
    (addr,) = jnet._params["sample_embedding"].keys()
    x = _rows((9, 1), 1)
    _close(
        TL.mlp_apply(tnet._params["sample_embedding"][addr], torch.from_numpy(x)),
        JL.mlp_apply(jnet._params["sample_embedding"][addr], jnp.asarray(x)),
    )
    x = _rows((9, 8), 2)
    _close(
        TL.mlp_apply(tnet._params["observe_final"], torch.from_numpy(x)),
        JL.mlp_apply(jnet._params["observe_final"], jnp.asarray(x)),
    )


def test_lstm_step_matches(nets):
    jnet, tnet = nets
    n, H = 9, jnet._lstm_dim
    x = _rows((n, jnet._lstm_input_dim), 3)
    h, c = _rows((1, n, H), 4), _rows((1, n, H), 5)
    jout, (jh, jc) = JL.lstm_step(
        jnet._params["lstm"], jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c))
    )
    tout, (th, tc) = TL.lstm_step(
        tnet._params["lstm"], torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c))
    )
    _close(tout, jout)
    _close(th, jh)
    _close(tc, jc)
    zh, zc = TL.lstm_zero_state(tnet._params["lstm"], (n,), "cpu")
    jzh, jzc = JL.lstm_zero_state(jnet._params["lstm"], (n,))
    assert zh.shape == jzh.shape and zc.shape == jzc.shape


def test_head_apply_matches(nets):
    jnet, tnet = nets
    (addr,) = jnet._params["proposal"].keys()
    n = 9
    feats = _rows((n, jnet._lstm_dim), 6)
    prior_mean, prior_std = _rows((n,), 7), np.abs(_rows((n,), 8)) + 0.5
    value = _rows((n,), 9) * 3
    jd = JP.head_apply(
        jnet._params["proposal"][addr],
        jnp.asarray(feats),
        {"mean": jnp.asarray(prior_mean), "stddev": jnp.asarray(prior_std)},
    )
    td = TP.head_apply(
        tnet._params["proposal"][addr],
        torch.from_numpy(feats),
        TP.prior_param_arrays(TNormal(torch.from_numpy(prior_mean), torch.from_numpy(prior_std))),
    )
    _close(td.log_prob(torch.from_numpy(value)), jd.log_prob(jnp.asarray(value)))
    _close(td.mean, jd.mean)
    _close(td.variance, jd.variance)
    _close(td.mixing_distribution.logits, jd.mixing_distribution.logits)
    assert TP.head_kind_for(TNormal(0.0, 1.0)) == JP.head_kind_for(JNormal(0.0, 1.0))


def test_observe_embedding_matches(nets):
    jnet, tnet = nets
    obs = {"obs0": _rows((5, 1), 10), "obs1": _rows((5, 1), 11)}
    _close(
        tnet._embed_observe_pure(tnet._params, {k: torch.from_numpy(v) for k, v in obs.items()}),
        jnet._embed_observe_pure(jnet._params, {k: jnp.asarray(v) for k, v in obs.items()}),
    )
    assert tnet._observe_embedding_dim == jnet._observe_embedding_dim == 8


def test_serving_params_debias_the_ema(nets):
    jnet, tnet = nets
    jnet._ema_params = jax.tree_util.tree_map(lambda x: x * 0.5, jnet._params)
    tnet._ema_params = TL.map_tensors(tnet._params, lambda t: t * 0.5)
    for net in (jnet, tnet):
        net._ema_decay, net._ema_steps = 0.9, 3
    try:
        jw = jnet._serving_params()["lstm"]["layers"][0]["w_ih"]
        tw = tnet._serving_params()["lstm"]["layers"][0]["w_ih"]
        _close(tw.T, jw, tol=1e-6)
        _close(tw, tnet._params["lstm"]["layers"][0]["w_ih"] * 0.5 / (1 - 0.9**3), tol=1e-6)
    finally:
        for net in (jnet, tnet):
            net._ema_params, net._ema_decay, net._ema_steps = None, None, 0
        jnet._ema_serving_cache = None


def test_fresh_network_uses_default_init():
    # route (b): a network built by the port itself, on prior traces drawn
    # by the port's batched prior
    model = TorchGUM()
    net = pyprob_tpu_torch.nn.InferenceNetworkLSTM(
        model=model, observe_embeddings={"obs0": {"dim": 4}, "obs1": {"dim": 4}},
        lstm_dim=16, proposal_mixture_components=3,
    )
    net._pre_generate_layers(model.prior(num_traces=3))
    assert net._lstm_input_dim == 8 + 4 + 2 * (64 + 8)
    w = net._params["lstm"]["layers"][0]["w_ih"]
    assert w.shape == (64, net._lstm_input_dim)
    assert float(w.abs().max()) <= 1.0 / 4.0  # U(-1/sqrt(H), 1/sqrt(H))
    (addr,) = net._params["proposal"].keys()
    assert addr.endswith("__forward__gum_body__mu__Normal__1")
